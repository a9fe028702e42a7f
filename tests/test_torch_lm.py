"""The port's dense LM against the JAX package's, on the same (converted)
parameters and inputs: attention prefill/decode layers and the lm
``forward``/``prefill``/``decode_step`` at ``get_reduced_config("qwen3-0.6b")``
(f32, plus one bf16 case).  The JAX side runs as its tests run it on the CPU
(its kernels through their plain references)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.layers.attention import attn_decode_step as j_attn_decode  # noqa: E402
from repro.layers.attention import attn_forward as j_attn_forward  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.layers.attention import attn_decode_step, attn_forward  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, dtype=np.float32)


def assert_close(out, ref, dtype: str) -> None:
    """f32: the kernel tests' 2e-4.  bf16: 2e-2 of the largest magnitude.
    The two frameworks sum their bf16 products in different orders, so an
    intermediate activation may round one ulp apart; through two layers such
    a flip moves an output by a few ulps of the outputs' scale, not of its
    own (possibly near-zero) value."""
    out, ref = _np(out), _np(ref)
    tol = TOL[dtype]
    atol = tol * float(np.abs(ref).max()) if dtype == "bfloat16" else tol
    np.testing.assert_allclose(out, ref, rtol=tol, atol=atol)


def _build(dtype: str) -> dict:
    cfg_j = j_reduced("qwen3-0.6b", dtype=dtype)
    cfg = get_reduced_config("qwen3-0.6b", dtype=dtype)
    pj = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    return dict(dtype=dtype, cfg_j=cfg_j, cfg=cfg, pj=pj, pt=pt, tokens=tokens)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def model_f32():
    return _build("float32")


def test_configs_agree():
    cfg_j, cfg = j_reduced("qwen3-0.6b"), get_reduced_config("qwen3-0.6b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
              "qk_norm", "window", "rope_theta", "dtype", "norm_eps", "tie_embeddings",
              "padded_vocab"):
        assert getattr(cfg, f) == getattr(cfg_j, f), f


def test_forward(model):
    m = model
    ref = jlm.forward(m["pj"], {"tokens": m["tokens"]}, m["cfg_j"])
    out = lm.forward(m["pt"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"])
    assert_close(out, ref, m["dtype"])


def test_prefill_and_decode_step(model):
    m = model
    lj, cj = jlm.prefill(m["pj"], {"tokens": m["tokens"]}, m["cfg_j"], 16)
    lt, ct = lm.prefill(m["pt"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"], 16)
    assert_close(lt, lj, m["dtype"])
    for name in ("k", "v"):
        assert_close(ct["sub0"][name], cj["sub0"][name], m["dtype"])
    # one step at position 8 from each side's own prefilled cache
    nxt = np.array([[3], [5]], np.int32)
    lj2, cj2 = jlm.decode_step(m["pj"], nxt, cj, jnp.int32(8), m["cfg_j"])
    lt2, ct2 = lm.decode_step(m["pt"], torch.from_numpy(nxt), ct,
                              torch.tensor(8, dtype=torch.int32), m["cfg"])
    assert_close(lt2, lj2, m["dtype"])
    assert_close(ct2["sub0"]["k"], cj2["sub0"]["k"], m["dtype"])


def test_decode_matches_forward(model_f32):
    """Token-by-token decode from an empty cache reproduces the full-sequence
    forward at every position (the port against itself)."""
    m = model_f32
    cfg, tokens = m["cfg"], torch.from_numpy(m["tokens"])
    full = lm.forward(m["pt"], {"tokens": tokens}, cfg)
    cache = lm.init_cache(cfg, 2, 8, "cpu")
    for i in range(8):
        logits, cache = lm.decode_step(
            m["pt"], tokens[:, i:i + 1], cache, torch.tensor(i, dtype=torch.int32), cfg
        )
        assert_close(logits[:, 0], full[:, i], "float32")


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_attention_layers(model_f32, pos):
    m = model_f32
    cfg, cfg_j = m["cfg"], m["cfg_j"]
    lpj = jax.tree.map(lambda a: a[0], m["pj"]["blocks"]["sub0"]["attn"])
    lpt = {k: v[0] for k, v in m["pt"]["blocks"]["sub0"]["attn"].items()}
    rng = np.random.default_rng(pos)
    x = rng.normal(0, 1, (2, 12, cfg.d_model)).astype(np.float32)
    ref = j_attn_forward(lpj, x, cfg_j)
    out = attn_forward(lpt, tensor_from_numpy(x), cfg)
    assert_close(out, ref, "float32")

    cache = rng.normal(0, 1, (2, 2, 16, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    x1 = x[:, :1]
    oj, cj = j_attn_decode(lpj, x1, {"k": cache[0], "v": cache[1]}, jnp.int32(pos), cfg_j)
    ot, ct = attn_decode_step(
        lpt, tensor_from_numpy(x1),
        {"k": tensor_from_numpy(cache[0]), "v": tensor_from_numpy(cache[1])},
        torch.tensor(pos, dtype=torch.int32), cfg,
    )
    assert_close(ot, oj, "float32")
    assert_close(ct["k"], cj["k"], "float32")
    assert_close(ct["v"], cj["v"], "float32")


def test_init_params_shapes_and_scale():
    """The port draws its own weights (torch generator) with the reference's
    shapes, dtypes and fan-in scale."""
    cfg_j, cfg = j_reduced("qwen3-0.6b"), get_reduced_config("qwen3-0.6b")
    ref = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    out = lm.init_params(cfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_t = dict(torch.utils._pytree.tree_flatten_with_path(out)[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        key = tuple(torch.utils._pytree.MappingKey(k.key) for k in path)
        t = flat_t[key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}"
    wq = out["blocks"]["sub0"]["attn"]["wq"]
    # a N(0, 1) cut at +-2 has std 0.88
    assert abs(wq.std().item() - cfg.d_model ** -0.5 * 0.88) < 0.02


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.serving.engine import LocalServing

    cfg = get_reduced_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalServing(cfg)
