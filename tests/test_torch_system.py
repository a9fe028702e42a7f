"""The paper's headline on the port: full-width KAPAO at 640 through the five
systems in account-only sessions (the port of
``tests/test_system.py::TestPaperHeadline``), the Tab. III loop composition
of ``benchmarks/tab3_rpc_composition.py``, and the tiny CNN of
``tests/test_record_replay.py`` (with and without a setup graph) run for
real on the CPU against the JAX package's sessions (the quickstart's check:
identical outputs across the five systems)."""
from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import cnn_params_from_numpy  # noqa: E402
from repro_torch.core.intercept import NO_NOISE  # noqa: E402
from repro_torch.core.offload import SYSTEMS, OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.core.records import (  # noqa: E402
    FUNC_D2D,
    FUNC_D2H,
    FUNC_GET_DEVICE,
    FUNC_GET_LAST_ERROR,
    FUNC_H2D,
    FUNC_MALLOC,
    FUNC_SYNC,
)
from repro_torch.models.cnn_zoo import conv, make_kapao_calibrated  # noqa: E402

# Tab. III, loop column (benchmarks/tab3_rpc_composition.py::PAPER_LOOP)
PAPER_LOOP = {
    FUNC_GET_DEVICE: 4735,
    FUNC_GET_LAST_ERROR: 607,
    "cudaLaunchKernel": 522,
    FUNC_MALLOC: 0,
    FUNC_SYNC: 11,
    FUNC_H2D: 3,
    FUNC_D2H: 8,
    FUNC_D2D: 9,
}


@pytest.fixture(scope="module")
def kapao():
    model = make_kapao_calibrated(scale=1.0, input_size=640, device="cpu")
    out = {}
    for system in ("device_only", "nnto", "cricket", "rrto"):
        sess = OffloadSession(model, system, environment="indoor", execute=False, device="cpu")
        sess.load()
        out[system] = (sess, [sess.infer(*model.example_inputs) for _ in range(7)])
    return out


def _last(kapao, system):
    return kapao[system][1][-1]


def test_kapao_rpc_counts(kapao):
    assert _last(kapao, "cricket").rpcs == 5895     # Tab. III/IV
    assert _last(kapao, "rrto").rpcs == 11          # Tab. IV
    modes = [r.mode for r in kapao["rrto"][1]]
    assert modes == ["recording"] * 3 + ["replaying"] * 4


def test_kapao_rrto_vs_cricket_latency(kapao):
    red = 1 - _last(kapao, "rrto").wall_seconds / _last(kapao, "cricket").wall_seconds
    assert 0.90 <= red <= 0.99, f"latency reduction {red:.3f} vs paper 0.95"


def test_kapao_rrto_vs_device_latency(kapao):
    red = 1 - _last(kapao, "rrto").wall_seconds / _last(kapao, "device_only").wall_seconds
    assert 0.55 <= red <= 0.85, f"latency reduction {red:.3f} vs paper 0.72"


def test_kapao_rrto_matches_nnto(kapao):
    assert _last(kapao, "rrto").wall_seconds / _last(kapao, "nnto").wall_seconds < 1.5


def test_kapao_energy_reduction(kapao):
    assert 1 - _last(kapao, "rrto").joules / _last(kapao, "cricket").joules > 0.90


def test_kapao_tab3_loop_composition(kapao):
    """The second (steady) inference of the Cricket session, record by
    record: the calibrated 522 kernels with their framework noise, 3 HtoD
    (image, imsz, ratio; the mesh grids stay resident), 8 DtoH, 9 DtoD
    staging copies, and no cudaMalloc."""
    sess, results = kapao["cricket"]
    start = sess.stage_marks["after_first_inference"]
    assert 0 < sess.stage_marks["after_load"] < start
    loop = sess.client.logs[start:start + results[1].rpcs]
    comp = Counter(
        "cudaLaunchKernel" if r.func.startswith("kernel:") else r.func for r in loop
    )
    assert {k: comp.get(k, 0) for k in PAPER_LOOP} == PAPER_LOOP
    assert sum(comp.values()) == sum(PAPER_LOOP.values()) == 5895


def test_kapao_account_only_outputs_are_zeros(kapao):
    """Nothing is computed: every system hands back zeros of the 8 outputs'
    shapes (det rows of 183, keypoint rows of 102)."""
    for system, (_, results) in kapao.items():
        outs = results[-1].outputs
        assert [tuple(o.shape) for o in outs] == [(1, 64, 183), (1, 64, 102)] * 4, system
        assert all(not o.any() for o in outs), system


# ---------------------------------------------------------------------------
# the tiny CNN of tests/test_record_replay.py, for real on the CPU
# ---------------------------------------------------------------------------

def _tiny_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w1": rng.normal(0, 0.1, (3, 3, 4, 8)).astype(np.float32),
        "w2": rng.normal(0, 0.1, (3, 3, 8, 8)).astype(np.float32),
        "wout": rng.normal(0, 0.1, (8, 10)).astype(np.float32),
    }


def _tiny_x():
    return np.random.default_rng(1).normal(0, 1, (1, 16, 16, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def jref():
    """The JAX package, imported here so the card case collects where JAX
    is not installed."""
    pytest.importorskip("jax")
    from repro.core import offload

    return offload


def make_tiny_cnn_jax(jref, with_setup):
    """The reference's ``make_tiny_cnn``."""
    import jax
    import jax.numpy as jnp

    dn = ("NHWC", "HWIO", "NHWC")

    def setup(params, x):
        h, w = x.shape[1], x.shape[2]
        gy = jnp.arange(h, dtype=jnp.float32)[:, None] * jnp.ones((1, w), jnp.float32)
        return {"grid": gy / h}

    def apply(params, aux, x):
        y = jax.lax.conv_general_dilated(x, params["w1"], (1, 1), "SAME", dimension_numbers=dn)
        y = jax.nn.relu(y + aux["grid"][None, :, :, None])
        y = jax.lax.conv_general_dilated(y, params["w2"], (2, 2), "SAME", dimension_numbers=dn)
        y = jax.nn.relu(y)
        return [jnp.mean(y, axis=(1, 2)) @ params["wout"]]

    def apply_nosetup(params, x):
        return apply(params, setup(params, x), x)

    params, x = _tiny_params(), _tiny_x()
    if with_setup:
        return jref.OffloadableModel("tiny_cnn", apply, params, (x,), setup=setup)
    return jref.OffloadableModel("tiny_cnn_ns", apply_nosetup, params, (x,))


def make_tiny_cnn(with_setup, device="cpu"):
    """The same app on the port: NCHW inside, the stride-2 SAME convolution
    on 16 pixels pads (0, 1)."""

    def setup(params, x):
        h, w = x.shape[1], x.shape[2]
        gy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None] * torch.ones(
            (1, w), dtype=torch.float32, device=x.device)
        return {"grid": gy / h}

    def apply(params, aux, x):
        y = conv(x.permute(0, 3, 1, 2).contiguous(), params["w1"])
        y = torch.relu(y + aux["grid"])
        y = torch.relu(conv(y, params["w2"], 2))
        return [y.mean(dim=(2, 3)) @ params["wout"]]

    def apply_nosetup(params, x):
        return apply(params, setup(params, x), x)

    params = cnn_params_from_numpy(_tiny_params(), device)
    if with_setup:
        return OffloadableModel("tiny_cnn", apply, params, (_tiny_x(),), setup=setup)
    return OffloadableModel("tiny_cnn_ns", apply_nosetup, params, (_tiny_x(),))


def _run(model, session_cls, system, n=8, **kw):
    sess = session_cls(model, system, environment="indoor", min_repeats=3, **kw)
    sess.load()
    return sess, [sess.infer(_tiny_x()) for _ in range(n)]


@pytest.fixture(scope="module", params=[True, False], ids=["setup", "nosetup"])
def tiny(request, jref):
    with_setup = request.param
    port = {s: _run(make_tiny_cnn(with_setup), OffloadSession, s, device="cpu") for s in SYSTEMS}
    ref = {s: _run(make_tiny_cnn_jax(jref, with_setup), jref.OffloadSession, s)
           for s in ("rrto", "cricket")}
    return with_setup, port, ref


def test_tiny_cnn_outputs_identical_across_systems(tiny):
    _, port, _ = tiny
    ref = port["device_only"][1][-1].outputs[0]
    for system, (_, results) in port.items():
        for r in results:
            assert torch.equal(r.outputs[0], ref), system


def test_tiny_cnn_matches_jax(tiny):
    _, port, ref = tiny
    np.testing.assert_allclose(
        port["rrto"][1][-1].outputs[0].numpy(), np.asarray(ref["rrto"][1][-1].outputs[0]),
        rtol=2e-4, atol=2e-4,
    )


def test_tiny_cnn_modes_and_replay_rpcs_match_jax(tiny):
    _, port, ref = tiny
    ours, theirs = port["rrto"][1], ref["rrto"][1]
    assert [r.mode for r in ours] == [r.mode for r in theirs]
    assert [r.rpcs for r in ours if r.mode == "replaying"] == [
        r.rpcs for r in theirs if r.mode == "replaying"
    ]
    sess = port["rrto"][0]
    ios = sess.client.ios
    assert ours[-1].rpcs == len(ios.h2d_positions) + len(ios.d2h_positions) == 2


def test_tiny_cnn_setup_runs_once(tiny):
    """With a setup graph the grid is built on the first inference only and
    stays resident: the first inference uploads the frame twice (setup and
    steady graph), every later one once, as in the reference's sessions."""
    with_setup, port, ref = tiny
    for sess, results in (port["cricket"], ref["cricket"]):
        marks = sess.stage_marks
        first = sess.client.logs[marks["after_load"]:marks["after_first_inference"]]
        loop = sess.client.logs[marks["after_first_inference"]:][:results[1].rpcs]
        assert sum(r.func == FUNC_H2D for r in first) == (2 if with_setup else 1)
        assert sum(r.func == FUNC_H2D for r in loop) == 1


def test_tiny_cnn_orderings(tiny):
    """rrto replays at NNTO-class latency, semi_rrto sits between it and
    Cricket, in time and energy (tests/test_record_replay.py)."""
    _, port, _ = tiny
    last = {s: r[1][-1] for s, r in port.items()}
    assert last["rrto"].wall_seconds < last["cricket"].wall_seconds / 10
    assert last["rrto"].wall_seconds < last["nnto"].wall_seconds * 3.0
    assert last["rrto"].wall_seconds < last["semi_rrto"].wall_seconds < last["cricket"].wall_seconds
    assert last["rrto"].joules < last["semi_rrto"].joules < last["cricket"].joules


def test_noise_free_session_records_the_graph_alone():
    """``noise=NO_NOISE``: a Cricket inference is the steady graph's nodes
    plus one HtoD and one DtoH, each with its sync."""
    sess = OffloadSession(make_tiny_cnn(True), "cricket", noise=NO_NOISE, device="cpu")
    sess.load()
    results = [sess.infer(_tiny_x()) for _ in range(2)]
    assert results[1].rpcs == len(sess._graph.nodes) + 4


@pytest.fixture
def exact_cudnn():
    """cuDNN and matmuls in full f32, deterministic, no autotuning: the
    settings under which rrto's replay and device_only issue the same
    kernels.  The old settings come back afterwards, so later tests in the
    process do not depend on the order they run in."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@pytest.mark.requires_cuda
def test_tiny_cnn_on_card(exact_cudnn):
    """On the card: rrto equals device_only bitwise at every inference, and
    both agree with the CPU within the f32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    model = make_tiny_cnn(True, device="cuda")
    _, rrto = _run(model, OffloadSession, "rrto", device="cuda")
    _, only = _run(model, OffloadSession, "device_only", device="cuda")
    _, cpu = _run(make_tiny_cnn(True), OffloadSession, "device_only", device="cpu")
    assert rrto[-1].mode == "replaying"
    for a, b in zip(rrto, only):
        assert torch.equal(a.outputs[0], b.outputs[0])
    torch.testing.assert_close(rrto[-1].outputs[0], cpu[-1].outputs[0], rtol=2e-4, atol=2e-4)
