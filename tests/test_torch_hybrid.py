"""The port's Mamba2 layer and zamba2-style hybrid against the JAX package's,
on the same (converted) parameters and inputs, at
``get_reduced_config("zamba2-1.2b", n_layers=5, attn_every=2)``: two full
groups with the shared attention block after each, and a one-layer tail.
f32 at the kernel tests' 2e-4, one bf16 case at 2e-2 of the outputs' scale.
The JAX side runs as its own tests run it on the CPU (the scan through its
plain reference).  ``F.softplus`` (identity above 20) and ``jax.nn.softplus``
differ by under an f32 ulp; the 2e-4 tolerance covers it."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_config  # noqa: E402
from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.layers import mamba2 as jm  # noqa: E402
from repro.models import hybrid as jh  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.layers import mamba2  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py
SHAPE = dict(n_layers=5, attn_every=2)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, dtype=np.float32)


def assert_close(out, ref, dtype: str) -> None:
    """f32: 2e-4.  bf16: 2e-2 of the largest magnitude (the two frameworks
    sum bf16 products in different orders, so an activation may round one
    ulp apart, and through the layers such a flip moves an output by a few
    ulps of the outputs' scale)."""
    out, ref = _np(out), _np(ref)
    tol = TOL[dtype]
    atol = tol * float(np.abs(ref).max()) if dtype == "bfloat16" else tol
    np.testing.assert_allclose(out, ref, rtol=tol, atol=atol)


def _build(dtype: str) -> dict:
    cfg_j = j_reduced("zamba2-1.2b", dtype=dtype, **SHAPE)
    cfg = get_reduced_config("zamba2-1.2b", dtype=dtype, **SHAPE)
    pj = jh.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    return dict(dtype=dtype, cfg_j=cfg_j, cfg=cfg, pj=pj, pt=pt, tokens=tokens)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def model_f32():
    return _build("float32")


@pytest.mark.parametrize("reduce", [True, False])
def test_configs_agree(reduce):
    if reduce:
        cfg_j, cfg = j_reduced("zamba2-1.2b", **SHAPE), get_reduced_config("zamba2-1.2b", **SHAPE)
    else:
        cfg_j, cfg = j_config("zamba2-1.2b"), get_config("zamba2-1.2b")
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
              "vocab", "qk_norm", "window", "rope_theta", "dtype", "norm_eps",
              "tie_embeddings", "padded_vocab", "ssm_state", "ssm_head_dim", "ssm_groups",
              "ssm_expand", "ssm_chunk", "attn_every"):
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    assert get_model(cfg) is hybrid


def test_hybrid_reaches_every_branch():
    cfg = get_reduced_config("zamba2-1.2b", **SHAPE)
    assert hybrid._groups(cfg) == (2, 1)
    full = get_config("zamba2-1.2b")
    assert hybrid._groups(full) == (6, 2)


def _layer(tree, *idx):
    for i in idx:
        tree = jax.tree.map(lambda a, i=i: a[i], tree)
    return tree


@pytest.mark.parametrize("seq", [16, 21])
def test_mamba2_forward_and_state(model, seq):
    """One Mamba2 block: outputs and the (conv, ssm) state it hands to
    decode; 21 steps pad to two chunks of 16."""
    m = model
    lpj = _layer(m["pj"]["mamba_groups"]["mamba"], 1, 0)
    lpt = {k: v[1, 0] for k, v in m["pt"]["mamba_groups"]["mamba"].items()}
    x = np.random.default_rng(seq).normal(0, 1, (2, seq, m["cfg"].d_model)).astype(np.float32)
    xj = jnp.asarray(x, m["dtype"])
    xt = tensor_from_numpy(np.asarray(xj))
    oj, sj = jm.mamba2_forward(lpj, xj, m["cfg_j"], return_state=True)
    ot, st = mamba2.mamba2_forward(lpt, xt, m["cfg"], return_state=True)
    assert_close(ot, oj, m["dtype"])
    assert_close(st["conv"], sj["conv"], m["dtype"])
    assert_close(st["ssm"], sj["ssm"], m["dtype"])
    assert st["ssm"].dtype == torch.float32 and st["conv"].is_contiguous()


def test_mamba2_decode_step(model_f32):
    m = model_f32
    cfg, cfg_j = m["cfg"], m["cfg_j"]
    lpj = _layer(m["pj"]["mamba_tail"]["mamba"], 0)
    lpt = {k: v[0] for k, v in m["pt"]["mamba_tail"]["mamba"].items()}
    rng = np.random.default_rng(1)
    st0 = jm.init_mamba2_state(cfg_j, 2, jnp.float32)
    state_np = {k: rng.normal(0, 1, np.shape(v)).astype(np.float32) for k, v in st0.items()}
    x = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    oj, sj = jm.mamba2_decode_step(lpj, x, state_np, cfg_j)
    ot, st = mamba2.mamba2_decode_step(
        lpt, _t(x), {k: _t(v) for k, v in state_np.items()}, cfg
    )
    assert_close(ot, oj, "float32")
    for k in ("conv", "ssm"):
        assert_close(st[k], sj[k], "float32")
        assert st[k].is_contiguous()


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def test_forward(model):
    m = model
    ref = jh.forward(m["pj"], {"tokens": m["tokens"]}, m["cfg_j"])
    out = hybrid.forward(m["pt"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"])
    assert_close(out, ref, m["dtype"])


def test_prefill_and_decode_step(model):
    m = model
    lj, cj = jh.prefill(m["pj"], {"tokens": m["tokens"]}, m["cfg_j"], 32)
    lt, ct = hybrid.prefill(m["pt"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"], 32)
    assert_close(lt, lj, m["dtype"])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(cj)[0])
    for path, leaf in torch.utils._pytree.tree_flatten_with_path(ct)[0]:
        ref = flat_j[tuple(jax.tree_util.DictKey(k.key) for k in path)]
        assert tuple(leaf.shape) == ref.shape and str(leaf.dtype) == f"torch.{ref.dtype}"
        assert_close(leaf, ref, m["dtype"])
    # one step at position 24, both sides from the same (the reference's)
    # prefilled cache, so the step is compared on equal inputs
    nxt = np.array([[3], [5]], np.int32)
    cj_t = params_from_numpy(jax.tree.map(np.asarray, cj), m["cfg"], "cpu")
    lj2, cj2 = jh.decode_step(m["pj"], nxt, cj, jnp.int32(24), m["cfg_j"])
    lt2, ct2 = hybrid.decode_step(m["pt"], torch.from_numpy(nxt), cj_t,
                                  torch.tensor(24, dtype=torch.int32), m["cfg"])
    assert_close(lt2, lj2, m["dtype"])
    assert list(ct2) == list(ct) == list(hybrid.init_cache(m["cfg"], 2, 32, "cpu"))
    for grp in ("mamba_groups", "mamba_tail"):
        for k in ("conv", "ssm"):
            assert_close(ct2[grp][k], cj2[grp][k], m["dtype"])
    assert_close(ct2["shared_kv"]["k"], cj2["shared_kv"]["k"], m["dtype"])


def test_prefill_then_decode_matches_forward(model_f32):
    """Prefill 12 tokens, then decode the rest one at a time: each step's
    logits equal the full-sequence forward at that position (the port
    against itself: scan state and conv state hand over to the step)."""
    m = model_f32
    cfg, tokens = m["cfg"], torch.from_numpy(m["tokens"])
    full = hybrid.forward(m["pt"], {"tokens": tokens}, cfg)
    logits, cache = hybrid.prefill(m["pt"], {"tokens": tokens[:, :12]}, cfg, 24)
    assert_close(logits[:, 0], full[:, 11], "float32")
    for i in range(12, 24):
        logits, cache = hybrid.decode_step(
            m["pt"], tokens[:, i:i + 1], cache, torch.tensor(i, dtype=torch.int32), cfg
        )
        assert_close(logits[:, 0], full[:, i], "float32")


def test_decode_from_empty_cache_matches_forward(model_f32):
    m = model_f32
    cfg, tokens = m["cfg"], torch.from_numpy(m["tokens"][:, :8])
    full = hybrid.forward(m["pt"], {"tokens": tokens}, cfg)
    cache = hybrid.init_cache(cfg, 2, 8, "cpu")
    for i in range(8):
        logits, cache = hybrid.decode_step(
            m["pt"], tokens[:, i:i + 1], cache, torch.tensor(i, dtype=torch.int32), cfg
        )
        assert_close(logits[:, 0], full[:, i], "float32")


def _last_logits_both_paths(params, cfg, tokens):
    """Last-position logits of ``tokens`` from prefill and from a decode loop
    started on an empty cache: the port's on torch params, the reference's
    (jitted, as its serving runs it) on JAX params."""
    n = tokens.shape[1]
    if isinstance(cfg, ArchConfig):
        tok = torch.from_numpy(tokens)
        with torch.no_grad():
            pre, _ = hybrid.prefill(params, {"tokens": tok}, cfg, n)
            cache = hybrid.init_cache(cfg, 1, n, "cpu")
            for i in range(n):
                dec, cache = hybrid.decode_step(params, tok[:, i:i + 1], cache,
                                                torch.tensor(i, dtype=torch.int32), cfg)
    else:
        pre, _ = jax.jit(jh.prefill, static_argnums=(2, 3))(params, {"tokens": tokens}, cfg, n)
        step = jax.jit(jh.decode_step, static_argnums=4)
        cache = jh.init_cache(cfg, 1, n)
        for i in range(n):
            dec, cache = step(params, tokens[:, i:i + 1], cache, jnp.int32(i), cfg)
    return _np(pre)[0, -1, :cfg.vocab], _np(dec)[0, -1, :cfg.vocab]


def test_bf16_drift_matches_the_reference():
    """At zamba2's full depth (38 layers, 6 shared-attention sites), bf16
    logits stray from the f32 logits of the same weights by a few percent in
    the reference itself: its prefill rounds the conv output to bf16 where its
    decode step keeps it in f32, and 44 residual blocks add their roundings.
    The port's f32 logits match the reference's at 2e-4, and its bf16 drift
    on each path stays within twice the reference's largest."""
    shape = dict(n_layers=38, attn_every=6)
    cfg_j = j_reduced("zamba2-1.2b", dtype="bfloat16", **shape)
    cfg = get_reduced_config("zamba2-1.2b", dtype="bfloat16", **shape)
    pj = jh.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    cfg32_j = dataclasses.replace(cfg_j, dtype="float32")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pj32 = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    pt32 = torch.utils._pytree.tree_map(lambda t: t.float(), pt)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (1, 16)).astype(np.int32)
    ours, ours32, ref, ref32 = (_last_logits_both_paths(p, c, tokens) for p, c in (
        (pt, cfg), (pt32, cfg32), (pj, cfg_j), (pj32, cfg32_j)))
    scale = float(np.abs(ref32[0]).max())
    for o, r in zip(ours32, ref32):
        np.testing.assert_allclose(o, r, rtol=TOL["float32"], atol=TOL["float32"] * scale)
    ref_drift = max(np.abs(b - f).max() for b, f in zip(ref, ref32)) / scale
    for b, f in zip(ours, ours32):
        assert np.abs(b - f).max() / scale <= 2 * ref_drift


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_shapes(dtype):
    """The port draws its own weights with the reference's shapes and
    dtypes (A_log, D and dt_bias stay f32 in a bf16 model), and its cache has
    the reference's layout."""
    cfg_j = j_reduced("zamba2-1.2b", dtype=dtype, **SHAPE)
    cfg = get_reduced_config("zamba2-1.2b", dtype=dtype, **SHAPE)
    ref = jax.eval_shape(lambda: jh.init_params(jax.random.PRNGKey(0), cfg_j))
    out = hybrid.init_params(cfg, seed=0, device="cpu")
    for tree_j, tree_t in ((ref, out),
                           (jax.eval_shape(lambda: jh.init_cache(cfg_j, 2, 16)),
                            hybrid.init_cache(cfg, 2, 16, "cpu"))):
        flat_j = jax.tree_util.tree_flatten_with_path(tree_j)[0]
        flat_t = dict(torch.utils._pytree.tree_flatten_with_path(tree_t)[0])
        assert len(flat_j) == len(flat_t)
        for path, leaf in flat_j:
            t = flat_t[tuple(torch.utils._pytree.MappingKey(k.key) for k in path)]
            assert tuple(t.shape) == leaf.shape, path
            assert str(t.dtype) == f"torch.{leaf.dtype}", path
    assert torch.equal(out["mamba_tail"]["mamba"]["A_log"][0],
                       torch.log(torch.linspace(1.0, 16.0, 8)))


class TestConvert:
    def test_f32_leaves_of_a_bf16_model_convert(self):
        cfg_j = j_reduced("zamba2-1.2b", dtype="bfloat16", **SHAPE)
        cfg = get_reduced_config("zamba2-1.2b", dtype="bfloat16", **SHAPE)
        pj = jax.tree.map(np.asarray, jh.init_params(jax.random.PRNGKey(0), cfg_j))
        pt = params_from_numpy(pj, cfg, "cpu")
        mp = pt["mamba_groups"]["mamba"]
        assert mp["A_log"].dtype == mp["D"].dtype == mp["dt_bias"].dtype == torch.float32
        assert mp["in_proj"].dtype == torch.bfloat16
        assert np.array_equal(mp["A_log"].numpy(), pj["mamba_groups"]["mamba"]["A_log"])

    def test_other_dtypes_raise(self):
        cfg = get_reduced_config("zamba2-1.2b", dtype="bfloat16", **SHAPE)
        with pytest.raises(TypeError, match="neither"):
            params_from_numpy({"w": np.zeros(4, np.float16)}, cfg, "cpu")
        cfg32 = get_reduced_config("zamba2-1.2b", **SHAPE)
        with pytest.raises(TypeError, match="neither"):
            params_from_numpy({"w": np.zeros(4, np.float64)}, cfg32, "cpu")


def test_unported_family_raises():
    """Every family is ported: the registry routes by the config's fields in
    the reference's order, as ``repro.models.registry.get_model`` does, and
    raises for none (a family label with no shared block or sLSTM period is
    the decoder LM)."""
    from repro.models.registry import get_model as j_get_model
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_reduced_config("qwen3-0.6b"), family="ssm")
    assert get_model(cfg) is lm
    cfg_j = dataclasses.replace(j_reduced("qwen3-0.6b"), family="ssm")
    assert j_get_model(cfg_j).__name__ == "repro.models.lm"
