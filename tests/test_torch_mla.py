"""The port's MLA attention (minicpm3-4b's family) against the JAX package's
``repro.layers.mla`` and ``repro.models.lm``, on the same (converted)
parameters and inputs, at ``get_reduced_config("minicpm3-4b")`` (q_lora 32,
kv_lora 16, nope 8 + rope 8, v 16) and at the full config's head dims
(nope 64 + rope 32 = 96, v 64) where the flash call's width matters.  f32 at
the kernel tests' 2e-4; bf16 at 2e-2 of the outputs' scale.  A whole bf16
model is held against the reference run op by op (``jax.disable_jit``): its
compiled ``lax.scan`` body fuses away some bf16 roundings its layers make
op by op, and op by op the port rounds where the reference's layers do.  Also the plain flash at head dim 96
against the Pallas kernel in interpret mode, and the d = 96 tile plan; the
kernel itself is held against its plain version on the card in
tests/test_torch_kernels.py (``requires_cuda``)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_config  # noqa: E402
from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.layers import mla as jmla  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_chunked,
    attention_dense,
    flash_attention,
    tile_plan,
)
from repro_torch.layers import mla  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py
# the full config's qk head dim (nope 64 + rope 32) and v 64, on the reduced
# model otherwise
WIDE_HEADS = dict(nope_head_dim=64, rope_head_dim=32, v_head_dim=64, d_head=96)
CONFIG_FIELDS = (
    "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
    "attn_kind", "qk_norm", "window", "rope_theta", "q_lora", "kv_lora", "rope_head_dim",
    "nope_head_dim", "v_head_dim", "dtype", "norm_eps", "tie_embeddings", "padded_vocab",
)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, dtype=np.float32)


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a))


def assert_close(out, ref, dtype: str) -> None:
    """f32: 2e-4.  bf16: 2e-2 of the largest magnitude."""
    out, ref = _np(out), _np(ref)
    tol = TOL[dtype]
    atol = tol * float(np.abs(ref).max()) if dtype == "bfloat16" else tol
    np.testing.assert_allclose(out, ref, rtol=tol, atol=atol)


def _build(dtype: str, **overrides) -> dict:
    cfg_j = j_reduced("minicpm3-4b", dtype=dtype, **overrides)
    cfg = get_reduced_config("minicpm3-4b", dtype=dtype, **overrides)
    pj = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 20)).astype(np.int32)
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
        cfg_j, cfg = j_reduced("minicpm3-4b"), get_reduced_config("minicpm3-4b")
    else:
        cfg_j, cfg = j_config("minicpm3-4b"), get_config("minicpm3-4b")
    for f in CONFIG_FIELDS:
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    assert get_model(cfg) is lm


def _attn(m, i):
    """Layer ``i``'s attention parameters: (JAX's, the port's)."""
    return (jax.tree.map(lambda a: a[i], m["pj"]["blocks"]["sub0"]["attn"]),
            {k: v[i] for k, v in m["pt"]["blocks"]["sub0"]["attn"].items()})


@pytest.mark.parametrize("heads", ["reduced", "wide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward(dtype, heads):
    """One MLA block's prefill (latents expanded to per-head K/V, one flash
    call at the qk head dim, V zero-padded) and the (c_kv, k_rope) it hands
    to the cache; ``wide`` runs the flash call at head dim 96."""
    m = _build(dtype, **(WIDE_HEADS if heads == "wide" else {}))
    pj, pt = _attn(m, 1)
    x = np.random.default_rng(1).normal(0, 1, (2, 20, m["cfg"].d_model)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    oj, (cj, rj) = jmla.mla_forward(pj, xj, m["cfg_j"], return_kv=True)
    ot, (ct, rt) = mla.mla_forward(pt, _t(xj), m["cfg"], return_kv=True)
    assert_close(ot, oj, dtype)
    assert_close(ct, cj, dtype)
    assert_close(rt, rj, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_step(dtype):
    """The absorbed decode step (scores and softmax in f32) on a random
    latent cache at position 9 of 16: output and the updated cache."""
    m = _build(dtype)
    pj, pt = _attn(m, 0)
    cfg = m["cfg"]
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    cache = {"c_kv": rng.normal(0, 1, (2, 16, cfg.kv_lora)).astype(np.float32),
             "k_rope": rng.normal(0, 1, (2, 16, cfg.rope_head_dim)).astype(np.float32)}
    cache_j = {k: jnp.asarray(v, dtype) for k, v in cache.items()}
    oj, nj = jmla.mla_decode_step(pj, jnp.asarray(x, dtype), cache_j, jnp.int32(9), m["cfg_j"])
    ot, nt = mla.mla_decode_step(pt, _t(jnp.asarray(x, dtype)),
                                 {k: _t(v) for k, v in cache_j.items()},
                                 torch.tensor(9, dtype=torch.int32), cfg)
    assert_close(ot, oj, dtype)
    for k in ("c_kv", "k_rope"):
        assert_close(nt[k], nj[k], dtype)
        assert nt[k].is_contiguous()


def test_forward(model):
    """The whole reduced model: f32 against the jitted reference, bf16
    against the reference op by op (see the module docstring)."""
    m = model
    tok = jnp.asarray(m["tokens"])
    if m["dtype"] == "bfloat16":
        with jax.disable_jit():
            ref = jlm.forward(m["pj"], {"tokens": tok}, m["cfg_j"])
    else:
        ref = jlm.forward(m["pj"], {"tokens": tok}, m["cfg_j"])
    out = lm.forward(m["pt"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"])
    assert_close(out, ref, m["dtype"])


def test_prefill_and_decode_step(model_f32):
    """Prefill's logits and latent cache (the reference's tree layout), then
    one absorbed decode step from the reference's prefilled cache."""
    m = model_f32
    lj, cj = jlm.prefill(m["pj"], {"tokens": m["tokens"]}, m["cfg_j"], 32)
    lt, ct = lm.prefill(m["pt"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"], 32)
    assert_close(lt, lj, "float32")
    assert list(ct["sub0"]) == ["c_kv", "k_rope"]
    for k in ("c_kv", "k_rope"):
        assert tuple(ct["sub0"][k].shape) == cj["sub0"][k].shape
        assert_close(ct["sub0"][k], cj["sub0"][k], "float32")
    nxt = np.array([[3], [5]], np.int32)
    cj_t = params_from_numpy(jax.tree.map(np.asarray, cj), m["cfg"], "cpu")
    lj2, cj2 = jlm.decode_step(m["pj"], nxt, cj, jnp.int32(20), m["cfg_j"])
    lt2, ct2 = lm.decode_step(m["pt"], torch.from_numpy(nxt), cj_t,
                              torch.tensor(20, dtype=torch.int32), m["cfg"])
    assert_close(lt2, lj2, "float32")
    for k in ("c_kv", "k_rope"):
        assert_close(ct2["sub0"][k], cj2["sub0"][k], "float32")


def test_prefill_then_decode_matches_forward(model_f32):
    """Prefill 12 tokens, then the absorbed decode for the rest: each step's
    logits equal the full-sequence forward (expanded K/V, flash) at that
    position."""
    m = model_f32
    cfg, tokens = m["cfg"], torch.from_numpy(m["tokens"])
    full = lm.forward(m["pt"], {"tokens": tokens}, cfg)
    logits, cache = lm.prefill(m["pt"], {"tokens": tokens[:, :12]}, cfg, 20)
    assert_close(logits[:, 0], full[:, 11], "float32")
    for i in range(12, 20):
        logits, cache = lm.decode_step(m["pt"], tokens[:, i:i + 1], cache,
                                       torch.tensor(i, dtype=torch.int32), cfg)
        assert_close(logits[:, 0], full[:, i], "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_shapes(dtype):
    """The port draws its own weights with the reference's shapes and
    dtypes, and its latent cache has the reference's layout."""
    cfg_j = j_reduced("minicpm3-4b", dtype=dtype)
    cfg = get_reduced_config("minicpm3-4b", dtype=dtype)
    ref = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    out = lm.init_params(cfg, seed=0, device="cpu")
    for tree_j, tree_t in ((ref, out), (jax.eval_shape(lambda: jlm.init_cache(cfg_j, 2, 16)),
                                        lm.init_cache(cfg, 2, 16, "cpu"))):
        flat_j = jax.tree_util.tree_flatten_with_path(tree_j)[0]
        flat_t = dict(torch.utils._pytree.tree_flatten_with_path(tree_t)[0])
        assert len(flat_j) == len(flat_t)
        for path, leaf in flat_j:
            t = flat_t[tuple(torch.utils._pytree.MappingKey(k.key) for k in path)]
            assert tuple(t.shape) == leaf.shape, path
            assert str(t.dtype) == f"torch.{leaf.dtype}", path


class TestFlashHeadDim96:
    """MLA's flash call: q/k/v at nope 64 + rope 32 = 96."""

    @pytest.mark.parametrize("sq,causal", [(32, True), (16, False)])
    def test_plain_vs_pallas(self, rng, sq, causal):
        q, k, v = (rng.normal(0, 1, (1, sq, 4, 96)).astype(np.float32) for _ in range(3))
        ref = np.asarray(j_flash(q, k, v, causal=causal, interpret=True))
        for fn in (attention_chunked, attention_dense):
            out = fn(_t(q), _t(k), _t(v), causal=causal)
            np.testing.assert_allclose(out.numpy(), ref, rtol=TOL["float32"],
                                       atol=TOL["float32"])

    def test_bf16(self, rng):
        q, k, v = (jnp.asarray(rng.normal(0, 1, (1, 32, 4, 96)), jnp.bfloat16)
                   for _ in range(3))
        ref = j_flash(q, k, v, interpret=True)
        out = flash_attention(_t(q), _t(k), _t(v))
        np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"])

    def test_tile_plan(self):
        """The wgmma route pads a row of 96 to two 64-column atoms (the second
        half-filled): Q, two stages of K and V and P in 11 atoms; the grid is
        the 64-row tiles of each (KV head, batch row) as at any head dim."""
        plan = tile_plan(1, 64, 40, 40, torch.bfloat16, 96)
        assert plan == dict(route="wgmma", rows=64, grid=(1, 40, 1), width=128,
                            smem=11 * 8192 + 1024)
        assert tile_plan(1, 64, 40, 40, torch.bfloat16) == dict(
            route="wgmma", rows=64, grid=(1, 40, 1))
        assert tile_plan(2, 77, 8, 8, torch.float32, 96) == dict(
            route="cuda_cores", rows=77, grid=(5, 16), width=96, smem=2 * 32 * 96 * 4)
        with pytest.raises(ValueError, match="head dim 80"):
            tile_plan(1, 64, 40, 40, torch.bfloat16, 80)
