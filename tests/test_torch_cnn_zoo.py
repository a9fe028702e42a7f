"""The port's CNN zoo against the JAX package's, model for model, on the CPU:
parameters drawn from one seed are bit-identical once converted, each app
matches the reference's ``jax.jit(apply)`` within the f32 tolerance of
``tests/test_kernels.py`` (2e-4, abs and rel) at a reduced width, the SAME
padding helper matches ``lax.padtype_to_pads``, and every convolution's
``node_flops`` equals the reference's ``eqn_flops``.

Argmax and top-k outputs are discontinuous, so they are held by a near-tie
rule: the tensor just before the argmax or top-k is compared within 2e-4;
the downloaded class map (or the rows gathered at the top-k indices) is
compared exactly (within 2e-4 for gathered floats), except at positions
where the reference's two candidates lie within that tolerance of each
other.  Each case reports how many such positions it skipped."""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core.costmodel import eqn_flops  # noqa: E402
from repro.core.flatten import FlatLit, flatten_closed_jaxpr  # noqa: E402
from repro.models import cnn_zoo as jzoo  # noqa: E402
from repro_torch.convert import cnn_params_from_numpy  # noqa: E402
from repro_torch.core.costmodel import node_flops  # noqa: E402
from repro_torch.core.offload import trace_model  # noqa: E402
from repro_torch.models import cnn_zoo  # noqa: E402

TOL = 2e-4
# (scale, input size) per model: narrow widths, small frames.  KAPAO takes
# 256: its top-k of 64 needs 8x8 rows at stride 32 (the reference refuses
# smaller frames too); RetinaNet's needs 3x3x9 anchors at stride 32.
SIZES = {
    "vgg16": (0.125, 64),
    "resnet50": (0.125, 64),
    "sensor_encoder": (0.25, 64),
    "recurrent_sensor_decoder": (0.25, 64),
    "convnext_tiny": (0.125, 64),
    "fcn_resnet50": (0.125, 64),
    "deeplabv3_resnet50": (0.125, 64),
    "fasterrcnn_resnet50": (0.125, 96),
    "retinanet_resnet50": (0.125, 96),
    "kapao": (0.125, 256),
}
ARGMAX, TOPK = torch.ops.aten.argmax.default, torch.ops.aten.topk.default


def test_zoo_keys_match():
    assert list(cnn_zoo.ZOO) == list(jzoo.ZOO) == list(SIZES)


@functools.cache
def _pair(key):
    """(reference model, port model) at the reduced size, built once."""
    scale, size = SIZES[key]
    return jzoo.ZOO[key](scale, size, 0), cnn_zoo.ZOO[key](scale, size, 0, device="cpu")


def _whole(model):
    """The app as one function of (params, *inputs), setup included."""
    if model.setup is None:
        return model.apply
    return lambda p, *ins: model.apply(p, model.setup(p, *ins), *ins)


@functools.cache
def _jaxpr(key):
    """The reference app's flattened jaxpr, traced once."""
    ref = _pair(key)[0]
    inputs = tuple(np.asarray(x) for x in ref.example_inputs)
    return flatten_closed_jaxpr(jax.make_jaxpr(_whole(ref))(ref.params, *inputs))


def _jax_run(key):
    """``jax.jit`` of the reference app, evaluated equation by equation over
    its flattened jaxpr so the operands and results of every argmax and
    top_k come back beside the outputs."""
    model, flat = _pair(key)[0], _jaxpr(key)
    params = model.params
    inputs = tuple(np.asarray(x) for x in model.example_inputs)

    def interp(consts, args):
        env = dict(zip(flat.constvars, consts))
        env.update(zip(flat.invars, args))

        def read(a):
            return a.val if isinstance(a, FlatLit) else env[a]

        captured = []
        for e in flat.eqns:
            ins = [read(a) for a in e.invars]
            outs = e.primitive.bind(*ins, **e.params)
            outs = outs if e.primitive.multiple_results else [outs]
            env.update(zip(e.outvars, outs))
            if e.primitive.name in ("argmax", "top_k"):
                captured.append((ins[0], outs))
        return [read(v) for v in flat.outvars], captured

    outs, captured = jax.jit(interp)(flat.consts, jax.tree.leaves((params, *inputs)))
    return (
        [np.asarray(o) for o in outs],
        [(np.asarray(a), [np.asarray(o) for o in os]) for a, os in captured],
    )


class _Capture(TorchDispatchMode):
    """Records the operand and results of every argmax and topk."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (ARGMAX, TOPK):
            self.seen.append((func, args, out))
        return out


def _port_run(model):
    inputs = [torch.from_numpy(np.asarray(x).copy()) for x in model.example_inputs]
    with torch.no_grad(), _Capture() as cap:
        outs = _whole(model)(model.params, *inputs)
    return [o.numpy() for o in outs], cap.seen


def _near(a, b):
    return np.abs(a - b) <= TOL + TOL * np.abs(a)


@pytest.mark.parametrize("key", list(SIZES))
def test_params_match_reference(key):
    ref, port = _pair(key)
    conv = cnn_params_from_numpy(ref.params, "cpu")
    assert list(conv) == list(port.params)
    for name, t in port.params.items():
        assert t.dtype == conv[name].dtype and torch.equal(t, conv[name]), name
    for a, b in zip(ref.example_inputs, port.example_inputs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("key", list(SIZES))
def test_apply_matches_reference(key):
    ref, port = _pair(key)
    j_outs, j_cap = _jax_run(key)
    p_outs, p_cap = _port_run(port)
    assert [o.shape for o in p_outs] == [o.shape for o in j_outs]
    assert [o.dtype for o in p_outs] == [o.dtype for o in j_outs]
    assert len(p_cap) == len(j_cap)
    skipped = 0
    if not p_cap:
        for a, b in zip(p_outs, j_outs):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    elif p_cap[0][0] is ARGMAX:
        # FCN / DeepLab: the logits in NHWC, then the downloaded class map
        (_, args, _), (j_logits, _) = p_cap[0], j_cap[0]
        logits = torch.movedim(args[0], args[1], -1).numpy()
        np.testing.assert_allclose(logits, j_logits, rtol=TOL, atol=TOL)
        top2 = np.sort(j_logits, axis=-1)[..., -2:]
        tie = _near(top2[..., 1], top2[..., 0])
        differ = p_outs[0] != j_outs[0]
        assert not (differ & ~tie).any()
        skipped = int(differ.sum())
    else:
        # KAPAO / RetinaNet / Faster-RCNN: top-k call i picks the rows of
        # outputs 2i and 2i+1
        for i, ((_, args, (_, p_idx)), (j_scores, (_, j_idx))) in enumerate(zip(p_cap, j_cap)):
            np.testing.assert_allclose(args[0].numpy(), j_scores, rtol=TOL, atol=TOL)
            p_idx = p_idx.numpy()
            differ = p_idx != j_idx
            picked = np.take_along_axis(j_scores, p_idx, axis=-1)
            wanted = np.take_along_axis(j_scores, j_idx, axis=-1)
            assert not (differ & ~_near(wanted, picked)).any()
            skipped += int(differ.sum())
            for o in (2 * i, 2 * i + 1):
                keep = ~differ
                np.testing.assert_allclose(p_outs[o][keep], j_outs[o][keep], rtol=TOL, atol=TOL)
    # at these sizes every model skips 0 positions (CPU, torch 2.13, jax 0.9)
    print(f"{key}: {skipped} near-tie positions skipped")


def test_convnext_block_body_matches_reference():
    """ConvNeXt's layer scale ``gamma`` is 1e-6, so in the case above each
    block adds about 1e-6 to its residual, far below the tolerance.  Here
    every ``*_gamma`` is 1 and every ``*_norm`` a seeded draw, in both the
    reference's params and the port's, so the depthwise conv and its SAME
    padding, the layer norm over channels, both products and the tanh GELU
    each reach the logits."""
    ref, port = _pair("convnext_tiny")
    rng = np.random.default_rng(1)
    params = {
        name: np.ones_like(w) if name.endswith("_gamma")
        else rng.uniform(0.5, 1.5, w.shape).astype(np.float32) if name.endswith("_norm")
        else w
        for name, w in ref.params.items()
    }
    x = np.asarray(ref.example_inputs[0])
    (want,) = jax.jit(ref.apply)(params, x)
    with torch.no_grad():
        (got,) = port.apply(cnn_params_from_numpy(params, "cpu"), torch.from_numpy(x.copy()))
    want = np.asarray(want)
    # the blocks now move the logits by far more than the tolerance
    (base,) = jax.jit(ref.apply)(ref.params, x)
    assert np.abs(want - np.asarray(base)).max() > 100 * TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_kapao_takes_every_output_through_top_k():
    """KAPAO's 8 downloads are 4 top-k gathers of (det, kp) rows: the case
    above holds every one of them."""
    _, port = _pair("kapao")
    _, cap = _port_run(port)
    assert [f for f, _, _ in cap] == [TOPK] * 4


@pytest.mark.parametrize("s", [1, 2, 4])
def test_same_pads_match_lax(s):
    """The asymmetric SAME split, against ``lax.padtype_to_pads`` over input
    sizes, kernels and dilations (a dilated kernel spans (k-1)d+1)."""
    for size in range(1, 40):
        for k in (1, 2, 3, 5, 6, 7):
            for d in (1, 2, 12):
                want = jax.lax.padtype_to_pads((size,), ((k - 1) * d + 1,), (s,), "SAME")[0]
                assert cnn_zoo.same_pads(size, k, s, d) == tuple(want), (size, k, s, d)


@pytest.mark.parametrize("key", list(SIZES))
def test_conv_flops_match_reference(key):
    """Every convolution of the traced app, in program order, against the
    reference's ``conv_general_dilated`` equations: depthwise (ConvNeXt),
    dilated (DeepLab's ASPP), strided and asymmetrically padded alike."""
    graph = trace_model(_pair(key)[1], torch.device("cpu")).graph
    ours = [
        node_flops(n.name, [v.aval for v in n.invars], [v.aval for v in n.outvars], n.is_view)
        for n in graph.nodes if n.op is torch.ops.aten.convolution.default
    ]
    theirs = [eqn_flops(e) for e in _jaxpr(key).eqns if e.primitive.name == "conv_general_dilated"]
    assert ours and ours == theirs
