"""The port's MoE family (``repro_torch.layers.moe`` and the super-blocks of
``repro_torch.models.lm``) against the JAX package's ``repro.layers.moe``
and ``repro.models.lm``, on the same (converted) parameters and numpy
inputs from a seed, at the reduced mixtral-8x7b (4 experts, top-2, window
32) and llama4-maverick (a dense layer then a MoE layer with a shared
expert, top-1) configs.  f32 at the kernel tests' 2e-4; bf16 at 2e-2 of the
outputs' scale.  Also: the same assignments dropped over capacity in both
packages, a deterministic combine with no float scatter-add, one aten
sequence for every token, and the four configs ported beside the MoE ones
equal field by field to the reference's."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.configs.registry import get_config as j_config  # noqa: E402
from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py
MOE_ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
PORTED = ("mixtral-8x7b", "llama4-maverick-400b-a17b", "qwen3-1.7b", "deepseek-67b")
# ops that sum floats into an index (atomics on the card): none may appear
ACCUMULATING = ("aten.index_add", "aten.scatter_add", "aten.scatter_reduce", "aten.index_reduce")
# ops whose output shape or value the host must read
DATA_DEPENDENT = ("aten.nonzero", "aten.masked_select", "aten.item", "aten._local_scalar_dense",
                  "aten.bincount")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, dtype=np.float32)


def assert_close(out, ref, dtype: str) -> None:
    """f32: 2e-4.  bf16: 2e-2, and 2e-2 of the largest magnitude: the two
    frameworks sum their bf16 products in different orders, so an
    activation may round one ulp apart (tests/test_torch_lm.py)."""
    out, ref = _np(out), _np(ref)
    tol = TOL[dtype]
    atol = tol * float(np.abs(ref).max()) if dtype == "bfloat16" else tol
    np.testing.assert_allclose(out, ref, rtol=tol, atol=atol)


def _layer(name: str, dtype: str, **overrides):
    """Both packages' configs and one MoE layer's parameters from the
    reference's ``moe_init``, converted."""
    cfg_j = j_reduced(name, dtype=dtype, **overrides)
    cfg = get_reduced_config(name, dtype=dtype, **overrides)
    pj = jmoe.moe_init(jax.random.PRNGKey(1), cfg_j, jnp.dtype(dtype))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    return cfg_j, cfg, pj, pt


def _x(cfg, b: int, s: int, dtype: str, seed: int = 0):
    x = np.random.default_rng(seed).normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    return xj, tensor_from_numpy(np.asarray(xj))


def _ref_counts(pj, xj, cfg_j) -> np.ndarray:
    """The reference dispatch's ``counts`` (``repro/layers/moe.py:80-87``):
    pairs routed to each expert, drops included."""
    xf = xj.reshape(-1, xj.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ pj["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, cfg_j.moe_top_k)
    se = jnp.sort(top_i.reshape(-1))
    return np.asarray(jnp.zeros((cfg_j.moe_experts,), jnp.int32).at[se].add(1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_apply(name, dtype):
    cfg_j, cfg, pj, pt = _layer(name, dtype)
    xj, xt = _x(cfg, 2, 12, dtype)
    assert_close(moe.moe_apply(pt, xt, cfg), jmoe.moe_apply(pj, xj, cfg_j), dtype)


def test_capacity_drops_the_same_assignments():
    """capacity_factor 1.0 over 64 tokens: cap 32 pairs per expert, and the
    random router sends more than that to one expert.  Both packages count
    the same pairs per expert, drop the same ones and agree on the output."""
    cfg_j, cfg, pj, pt = _layer("mixtral-8x7b", "float32", capacity_factor=1.0)
    xj, xt = _x(cfg, 1, 64, "float32", seed=2)
    cap = moe.moe_capacity(64, cfg)
    assert cap == jmoe.moe_capacity(64, cfg_j) == 32
    counts = _ref_counts(pj, xj, cfg_j)
    assert counts.max() > cap, counts
    _, slot, _, got = moe.route(pt, xt.reshape(64, -1), cfg, cap)
    np.testing.assert_array_equal(got.numpy(), counts)
    dropped = int((slot == cfg.moe_experts * cap).sum())
    assert dropped == int(np.maximum(counts - cap, 0).sum()) > 0
    assert_close(moe.moe_apply(pt, xt, cfg), jmoe.moe_apply(pj, xj, cfg_j), "float32")


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_combine_is_deterministic(name):
    """Two runs of the dispatch are bitwise equal, and its aten graph sums
    nothing into an index (the combine gathers by the inverse permutation)."""
    _, cfg, _, pt = _layer(name, "bfloat16")
    _, xt = _x(cfg, 1, 24, "bfloat16", seed=3)
    a, b = moe.moe_apply(pt, xt, cfg), moe.moe_apply(pt, xt, cfg)
    assert torch.equal(a, b)
    gm = make_fx(lambda p, x: moe.moe_apply(p, x, cfg), tracing_mode="fake")(pt, xt)
    ops = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert not [o for o in ops if o.startswith(ACCUMULATING)], ops
    assert not [n for n in gm.graph.nodes if "index_put" in str(n.target)
                and n.args[3:4] == (True,)]
    assert not [o for o in ops if o.startswith(DATA_DEPENDENT)], ops


def _decode_ops(cfg, params, token: int):
    """make_fx (real tensors) of one decode step at position 5: the aten
    ops in order and each one's output shapes."""
    cache = lm.init_cache(cfg, 1, 16, "cpu")

    def step(p, tok, c, pos):
        logits, new = lm.decode_step(p, tok, c, pos, cfg)
        return logits, new

    gm = make_fx(step, tracing_mode="real")(
        params, torch.tensor([[token]], dtype=torch.int32), cache, torch.tensor(5, dtype=torch.int32))

    def shapes(v):
        vs = v if isinstance(v, (list, tuple)) else [v]
        return tuple(tuple(t.shape) for t in vs if isinstance(t, torch.Tensor))

    return [(str(n.target), shapes(n.meta.get("val")))
            for n in gm.graph.nodes if n.op == "call_function"]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_step_aten_sequence_is_input_invariant(name):
    cfg = get_reduced_config(name)
    params = lm.init_params(cfg, seed=0, device="cpu")
    a, b = _decode_ops(cfg, params, 7), _decode_ops(cfg, params, 201)
    assert a == b
    assert any("topk" in op for op, _ in a) and any("sort" in op for op, _ in a)


@pytest.fixture(scope="module", params=[(n, d) for n in MOE_ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    name, dtype = request.param
    cfg_j = j_reduced(name, dtype=dtype)
    cfg = get_reduced_config(name, dtype=dtype)
    pj = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    return dict(dtype=dtype, cfg_j=cfg_j, cfg=cfg, pj=pj, pt=pt, tokens=tokens)


def test_params_layout(model):
    """Converted parameters keep the reference's tree: ``blocks/sub{j}``
    with a leading super-block axis, expert stacks (n_sb, E, d_in, d_out),
    the router in f32; the port's own init draws the same shapes/dtypes."""
    cfg = model["cfg"]
    n_sb = cfg.n_layers // cfg.moe_every
    mine = lm.init_params(cfg, seed=0, device="cpu")
    flat = dict(torch.utils._pytree.tree_flatten_with_path(model["pt"])[0])
    flat_mine = dict(torch.utils._pytree.tree_flatten_with_path(mine)[0])
    assert flat.keys() == flat_mine.keys()
    for k, t in flat.items():
        assert t.shape == flat_mine[k].shape and t.dtype == flat_mine[k].dtype, k
    sub = f"sub{cfg.moe_every - 1}"
    ffn = model["pt"]["blocks"][sub]["ffn"]
    assert ffn["w_gate"].shape == (n_sb, cfg.moe_experts, cfg.d_model, cfg.d_ff)
    assert ffn["router"].dtype == torch.float32
    assert ("shared" in ffn) == cfg.moe_shared_expert


def test_prefill_decode_roundtrip(model):
    """tests/test_arch_smoke.py::test_prefill_decode_roundtrip for the MoE
    archs, port against reference: ``forward``, ``prefill`` (logits and
    cache) and ``decode_step``; then the port's own decode against its
    extended forward at the reference's tolerance."""
    m = model
    cfg, cfg_j, pt, pj, tokens = m["cfg"], m["cfg_j"], m["pt"], m["pj"], m["tokens"]
    s = tokens.shape[1]
    tt = torch.from_numpy(tokens)
    full = lm.forward(pt, {"tokens": tt}, cfg)
    assert_close(full, jlm.forward(pj, {"tokens": tokens}, cfg_j), m["dtype"])
    pl, cache = lm.prefill(pt, {"tokens": tt}, cfg, 32)
    plj, cache_j = jlm.prefill(pj, {"tokens": tokens}, cfg_j, 32)
    assert_close(pl, plj, m["dtype"])
    assert sorted(cache) == sorted(cache_j) == [f"sub{j}" for j in range(cfg.moe_every)]
    for sub in cache:
        for leaf in ("k", "v"):
            assert_close(cache[sub][leaf], cache_j[sub][leaf], m["dtype"])
    np.testing.assert_allclose(_np(pl[:, 0]), _np(full[:, -1]), rtol=5e-3, atol=5e-3)
    nxt = torch.argmax(pl[:, 0, : cfg.vocab], -1).to(torch.int32)[:, None]
    d, _ = lm.decode_step(pt, nxt, cache, torch.tensor(s, dtype=torch.int32), cfg)
    dj, _ = jlm.decode_step(pj, jnp.asarray(nxt.numpy()), cache_j, jnp.int32(s), cfg_j)
    assert_close(d, dj, m["dtype"])
    full2 = lm.forward(pt, {"tokens": torch.cat([tt, nxt], dim=1)}, cfg)
    np.testing.assert_allclose(_np(d[:, 0]), _np(full2[:, -1]), rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", PORTED)
def test_configs_agree(name, reduce):
    cfg = get_reduced_config(name) if reduce else get_config(name)
    cfg_j = j_reduced(name) if reduce else j_config(name)
    for f in [f.name for f in dataclasses.fields(ArchConfig)] + ["padded_vocab"]:
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    for j in range(4):
        assert cfg.moe_layer(j) == cfg_j.moe_layer(j)


def test_registry_routes_moe_and_keeps_the_rest_unported():
    """The MoE configs route to the decoder LM; the audio and VLM families
    are ported too (whisper to ``encdec``, llava and a bare family label to
    the LM), so no family raises."""
    from repro_torch.models import encdec

    assert get_model(get_reduced_config("mixtral-8x7b")) is lm
    assert get_model(get_reduced_config("deepseek-67b")) is lm
    assert get_model(get_reduced_config("whisper-base")) is encdec
    assert get_model(get_reduced_config("llava-next-34b")) is lm
    for family in ("audio", "vlm"):
        assert get_model(dataclasses.replace(get_reduced_config("qwen3-1.7b"),
                                             family=family)) is lm
