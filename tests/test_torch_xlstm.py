"""The port's xLSTM blocks and LM (xlstm-1.3b's family) against the JAX
package's ``repro.layers.xlstm`` and ``repro.models.xlstm_lm``, on the same
(converted) parameters and inputs, at
``get_reduced_config("xlstm-1.3b", n_layers=5, slstm_every=2)``: two groups
of one mLSTM and one sLSTM block and a one-block tail (the default reduced
config has no full group, so its sLSTM never runs).  f32 at the kernel
tests' 2e-4; bf16 at 2e-2 of the outputs' scale, a whole bf16 model against
the reference run op by op (``jax.disable_jit``: its compiled ``lax.scan``
bodies fuse away some bf16 roundings its layers make op by op, which moves
the logits by more than the tolerance at this size).  Also the plain scan in the mLSTM form at a state of 160 x 161 over
three chunks against the Pallas kernel in interpret mode, and the wide
routes' plan at xlstm-1.3b's own shape; the wide kernels are held against
the plain version on the card in tests/test_torch_ssm_scan.py
(``requires_cuda``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_config  # noqa: E402
from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.kernels import ssm_scan as jscan  # noqa: E402
from repro.layers import xlstm as jxl  # noqa: E402
from repro.models import xlstm_lm as jx  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    gated_scan,
    gated_scan_mma_ref,
    scan_plan,
)
from repro_torch.layers import xlstm  # noqa: E402
from repro_torch.models import xlstm_lm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py
SMEM_MAX = 232448                           # dynamic shared memory a block may take on the H100
SHAPE = dict(n_layers=5, slstm_every=2)
CONFIG_FIELDS = (
    "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
    "dtype", "norm_eps", "tie_embeddings", "padded_vocab", "ssm_chunk", "slstm_every",
    "slstm_ff", "attn_every",
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


def _build(dtype: str) -> dict:
    cfg_j = j_reduced("xlstm-1.3b", dtype=dtype, **SHAPE)
    cfg = get_reduced_config("xlstm-1.3b", dtype=dtype, **SHAPE)
    pj = jx.init_params(jax.random.PRNGKey(0), cfg_j)
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
        cfg_j, cfg = j_reduced("xlstm-1.3b", **SHAPE), get_reduced_config("xlstm-1.3b", **SHAPE)
    else:
        cfg_j, cfg = j_config("xlstm-1.3b"), get_config("xlstm-1.3b")
    for f in CONFIG_FIELDS:
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    assert get_model(cfg) is xlstm_lm
    assert xlstm_lm._groups(cfg) == jx._groups(cfg_j)


def test_mlstm_dims_at_full_width():
    """xlstm-1.3b's mLSTM heads are 2 * 2048 / 4 = 1024 wide (not the
    config's d_head 512, the sLSTM's head width): a scan state of 1024 x
    1025 per head, 42 mLSTM and 6 sLSTM blocks."""
    cfg = get_config("xlstm-1.3b")
    assert xlstm._mdims(cfg) == jxl._mdims(j_config("xlstm-1.3b")) == (4096, 4, 1024)
    assert xlstm_lm._groups(cfg) == (6, 7, 0)


def _m_layer(m, gi):
    """mLSTM params of group ``gi``'s first block: (JAX's, the port's)."""
    return (jax.tree.map(lambda a: a[gi, 0], m["pj"]["m_groups"]["mlstm"]),
            {k: v[gi, 0] for k, v in m["pt"]["m_groups"]["mlstm"].items()})


def _s_layer(m, gi):
    return (jax.tree.map(lambda a: a[gi], m["pj"]["s_blocks"]["slstm"]),
            {k: v[gi] for k, v in m["pt"]["s_blocks"]["slstm"].items()})


def _x(m, seq, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, (2, seq, m["cfg"].d_model)).astype(np.float32)
    xj = jnp.asarray(x, m["dtype"])
    return xj, _t(xj)


@pytest.mark.parametrize("seq", [20, 150])
def test_mlstm_forward_and_state(model, seq):
    """One mLSTM block through the scan (150 steps: two chunks of 128, the
    last ragged): the output and the final state (B, NH, N, N + 1) in f32."""
    m = model
    pj, pt = _m_layer(m, 1)
    xj, xt = _x(m, seq)
    oj, hj = jxl.mlstm_forward(pj, xj, m["cfg_j"], return_state=True)
    ot, ht = xlstm.mlstm_forward(pt, xt, m["cfg"], return_state=True)
    assert_close(ot, oj, m["dtype"])
    assert_close(ht, hj, m["dtype"])
    assert ht.dtype == torch.float32 and tuple(ht.shape) == hj.shape


def test_mlstm_decode_step(model):
    m = model
    pj, pt = _m_layer(m, 0)
    rng = np.random.default_rng(3)
    state = rng.normal(0, 0.5, np.shape(jxl.init_mlstm_state(m["cfg_j"], 2))).astype(np.float32)
    xj, xt = _x(m, 1)
    oj, sj = jxl.mlstm_decode_step(pj, xj, jnp.asarray(state), m["cfg_j"])
    ot, st = xlstm.mlstm_decode_step(pt, xt, _t(state), m["cfg"])
    assert_close(ot, oj, m["dtype"])
    assert_close(st, sj, m["dtype"])


def test_slstm_forward_and_state(model):
    """One sLSTM block over 20 steps (the port's time loop against the
    reference's ``lax.scan``): output and (h, c, n, m)."""
    m = model
    pj, pt = _s_layer(m, 1)
    xj, xt = _x(m, 20)
    oj, sj = jxl.slstm_forward(pj, xj, m["cfg_j"], return_state=True)
    ot, st = xlstm.slstm_forward(pt, xt, m["cfg"], return_state=True)
    assert_close(ot, oj, m["dtype"])
    assert len(st) == len(sj) == 4
    for a, b in zip(st, sj):
        assert_close(a, b, m["dtype"])


def test_slstm_decode_step(model):
    """From a random state (m finite) and from the initial one (m at
    -1e30, the first step)."""
    m = model
    pj, pt = _s_layer(m, 0)
    init = jxl.init_slstm_state(m["cfg_j"], 2)
    rng = np.random.default_rng(4)
    random = tuple(rng.normal(0, 1, np.shape(init[0])).astype(np.float32) for _ in range(4))
    for state in (tuple(np.asarray(a) for a in init), random):
        xj, xt = _x(m, 1, seed=5)
        oj, sj = jxl.slstm_decode_step(pj, xj, tuple(jnp.asarray(a) for a in state), m["cfg_j"])
        ot, st = xlstm.slstm_decode_step(pt, xt, tuple(_t(a) for a in state), m["cfg"])
        assert_close(ot, oj, m["dtype"])
        for a, b in zip(st, sj):
            assert_close(a, b, m["dtype"])


def test_forward(model):
    """The whole reduced model: f32 against the jitted reference, bf16
    against the reference op by op (see the module docstring)."""
    m = model
    tok = jnp.asarray(m["tokens"])
    if m["dtype"] == "bfloat16":
        with jax.disable_jit():
            ref = jx.forward(m["pj"], {"tokens": tok}, m["cfg_j"])
    else:
        ref = jx.forward(m["pj"], {"tokens": tok}, m["cfg_j"])
    out = xlstm_lm.forward(m["pt"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"])
    assert_close(out, ref, m["dtype"])


def _cache_leaves(cache) -> dict:
    """{path: leaf} with the reference's leaf names: s_blocks' tuple entries
    by index."""
    flat = {}
    for key in ("m_groups", "m_tail"):
        if key in cache:
            flat[key] = cache[key]
    for i, leaf in enumerate(cache["s_blocks"]):
        flat[f"s_blocks/{i}"] = leaf
    return flat


def test_prefill_and_decode_step(model_f32):
    """Prefill's logits and recurrent states (the reference's tree layout),
    then one decode step from the reference's prefilled cache."""
    m = model_f32
    lj, cj = jx.prefill(m["pj"], {"tokens": m["tokens"]}, m["cfg_j"], 32)
    lt, ct = xlstm_lm.prefill(m["pt"], {"tokens": torch.from_numpy(m["tokens"])}, m["cfg"], 32)
    assert_close(lt, lj, "float32")
    assert list(ct) == list(xlstm_lm.init_cache(m["cfg"], 2, 32, "cpu"))
    flat_j, flat_t = _cache_leaves(cj), _cache_leaves(ct)
    assert list(flat_j) == list(flat_t)
    for k in flat_j:
        assert tuple(flat_t[k].shape) == flat_j[k].shape, k
        assert_close(flat_t[k], flat_j[k], "float32")
    nxt = np.array([[3], [5]], np.int32)
    ct_j = {k: (tuple(_t(a) for a in v) if isinstance(v, tuple) else _t(v))
            for k, v in cj.items()}
    lj2, cj2 = jx.decode_step(m["pj"], nxt, cj, jnp.int32(20), m["cfg_j"])
    lt2, ct2 = xlstm_lm.decode_step(m["pt"], torch.from_numpy(nxt), ct_j,
                                    torch.tensor(20, dtype=torch.int32), m["cfg"])
    assert_close(lt2, lj2, "float32")
    flat_j2, flat_t2 = _cache_leaves(cj2), _cache_leaves(ct2)
    for k in flat_j2:
        assert_close(flat_t2[k], flat_j2[k], "float32")
        assert flat_t2[k].is_contiguous()


def test_prefill_then_decode_matches_forward(model_f32):
    """Prefill 12 tokens (chunked scan, sLSTM loop), then decode the rest
    one at a time (``gated_step``, the sLSTM cell): each step's logits equal
    the full-sequence forward at that position."""
    m = model_f32
    cfg, tokens = m["cfg"], torch.from_numpy(m["tokens"])
    full = xlstm_lm.forward(m["pt"], {"tokens": tokens}, cfg)
    logits, cache = xlstm_lm.prefill(m["pt"], {"tokens": tokens[:, :12]}, cfg)
    assert_close(logits[:, 0], full[:, 11], "float32")
    for i in range(12, 20):
        logits, cache = xlstm_lm.decode_step(m["pt"], tokens[:, i:i + 1], cache,
                                             torch.tensor(i, dtype=torch.int32), cfg)
        assert_close(logits[:, 0], full[:, i], "float32")


def test_decode_from_empty_cache_matches_forward(model_f32):
    m = model_f32
    cfg, tokens = m["cfg"], torch.from_numpy(m["tokens"][:, :8])
    full = xlstm_lm.forward(m["pt"], {"tokens": tokens}, cfg)
    cache = xlstm_lm.init_cache(cfg, 2, 0, "cpu")
    for i in range(8):
        logits, cache = xlstm_lm.decode_step(m["pt"], tokens[:, i:i + 1], cache,
                                             torch.tensor(i, dtype=torch.int32), cfg)
        assert_close(logits[:, 0], full[:, i], "float32")


def test_default_reduced_config_has_no_group():
    """``get_reduced_config("xlstm-1.3b")`` keeps slstm_every 8 at 2 layers:
    no group, a tail of two mLSTMs, as in the reference; prefill hands back
    the empty group leaves of a fresh cache."""
    cfg_j, cfg = j_reduced("xlstm-1.3b"), get_reduced_config("xlstm-1.3b")
    assert xlstm_lm._groups(cfg) == (0, 7, 2)
    pj = jx.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (1, 6)).astype(np.int32)
    lj, cj = jx.prefill(pj, {"tokens": tok}, cfg_j, 8)
    lt, ct = xlstm_lm.prefill(pt, {"tokens": torch.from_numpy(tok)}, cfg, 8)
    assert_close(lt, lj, "float32")
    assert tuple(ct["m_groups"].shape) == cj["m_groups"].shape
    assert_close(ct["m_tail"], cj["m_tail"], "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_shapes(dtype):
    """The port draws its own weights with the reference's shapes and dtypes
    (``w_gates`` stays f32 in a bf16 model), and its cache has the
    reference's layout, each leaf its own contiguous tensor."""
    cfg_j = j_reduced("xlstm-1.3b", dtype=dtype, **SHAPE)
    cfg = get_reduced_config("xlstm-1.3b", dtype=dtype, **SHAPE)
    ref = jax.eval_shape(lambda: jx.init_params(jax.random.PRNGKey(0), cfg_j))
    out = xlstm_lm.init_params(cfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_t = dict(torch.utils._pytree.tree_flatten_with_path(out)[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        t = flat_t[tuple(torch.utils._pytree.MappingKey(k.key) for k in path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype) == f"torch.{leaf.dtype}", path
    cache_j = _cache_leaves(jax.eval_shape(lambda: jx.init_cache(cfg_j, 2, 16)))
    cache_t = _cache_leaves(xlstm_lm.init_cache(cfg, 2, 16, "cpu"))
    assert list(cache_j) == list(cache_t)
    for k, leaf in cache_j.items():
        assert tuple(cache_t[k].shape) == leaf.shape and cache_t[k].dtype == torch.float32
        assert cache_t[k].is_contiguous()
    assert bool((cache_t["s_blocks/3"] == -1e30).all())
    ptrs = [t.data_ptr() for t in cache_t.values()]
    assert len(set(ptrs)) == len(ptrs)


class TestWideScan:
    """The scan in the mLSTM form at a state wider than the narrow routes'
    128 rows."""

    def _inputs(self, rng, b, s, h, n):
        x = rng.normal(0, 1, (b, s, h, n + 1)).astype(np.float32)
        x[..., -1] = 1.0                                 # the normalizer column
        ld = np.log(1 / (1 + np.exp(-rng.normal(3, 1, (b, s, h))))).astype(np.float32)
        gi = np.exp(np.minimum(rng.normal(0, 1, (b, s, h)), 8.0)).astype(np.float32)
        k = (rng.normal(0, 1, (b, s, h, n)) / np.sqrt(n)).astype(np.float32)
        q = rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
        return x, ld, gi, k, q

    def test_plain_vs_pallas(self, rng):
        """N = 160, P = 161, three chunks of 16 (the last ragged, 44 steps):
        the port's plain version and its bf16 route's mirror against the
        Pallas kernel in interpret mode."""
        args = self._inputs(rng, 1, 44, 2, 160)
        y_pl, h_pl = jscan.gated_scan(*args, None, chunk=16, interpret=True)
        y, h = gated_scan(*(_t(a) for a in args), None, chunk=16)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), rtol=TOL["float32"],
                                   atol=TOL["float32"])
        np.testing.assert_allclose(h.numpy(), np.asarray(h_pl), rtol=TOL["float32"],
                                   atol=TOL["float32"])
        padded = [torch.nn.functional.pad(_t(a), [0, 0] * (a.ndim - 2) + [0, 4]) for a in args]
        y_m, h_m = gated_scan_mma_ref(*padded, None, chunk=16)
        np.testing.assert_allclose(y_m[:, :44].numpy(), np.asarray(y_pl), rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"])
        np.testing.assert_allclose(h_m.numpy(), np.asarray(h_pl), rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"])

    @pytest.mark.parametrize("s,chunk,slab", [(64, 64, 128), (16, 16, 128), (300, 128, 64)])
    def test_plan_at_xlstm_shape(self, s, chunk, slab):
        """xlstm-1.3b's stateless bucket, its prefill and chunks of 128:
        P = 1025 over 33 tiles of 32 columns (the last holds the normalizer
        column alone), one block of 8 warps per (tile, head, batch row), the
        state slice resident and B/C in two stages of slabs (128 columns up
        to a chunk of 64, 64 beyond), x and y beside them, under the 227 KB a
        block may take."""
        plan = scan_plan(1, s, 4, 1025, 4, 1024, chunk, torch.bfloat16)
        qp = -(-chunk // 16) * 16
        assert plan == dict(route="mma_wide", warps=8, slab=slab, grid=(33, 4, 1),
                            smem=qp * 40 * 2 + 2 * 2 * qp * (slab + 8) * 2 + 1024 * 36 * 4
                            + 2 * qp * 4)
        assert plan["smem"] <= 232448
        assert plan["smem"] <= SMEM_MAX
        f32 = scan_plan(1, s, 4, 1025, 4, 1024, chunk, torch.float32)
        assert (f32["route"], f32["grid"]) == ("cuda_cores_wide", (33, 4, 1))
        assert f32["smem"] <= SMEM_MAX

    def test_narrow_routes_keep_their_plans(self):
        assert scan_plan(1, 64, 4, 129, 4, 128, 64, torch.bfloat16)["route"] == "mma"
        assert scan_plan(1, 64, 4, 130, 4, 129, 64, torch.bfloat16)["route"] == "mma_wide"
        assert scan_plan(1, 64, 4, 129, 4, 128, 64, torch.float32)["route"] == "cuda_cores"
        with pytest.raises(ValueError, match="N=1025"):
            scan_plan(1, 64, 4, 1026, 4, 1025, 64, torch.bfloat16)


def _last_logits_both_paths(params, cfg, tokens):
    """Last-position logits of ``tokens`` from prefill and from a decode loop
    started on an empty cache: the port's on torch params, the reference's
    (jitted, as its serving runs it) on JAX params."""
    n = tokens.shape[1]
    if isinstance(params["embed"], torch.Tensor):
        tok = torch.from_numpy(tokens)
        with torch.no_grad():
            pre, _ = xlstm_lm.prefill(params, {"tokens": tok}, cfg)
            cache = xlstm_lm.init_cache(cfg, 1, n, "cpu")
            for i in range(n):
                dec, cache = xlstm_lm.decode_step(params, tok[:, i:i + 1], cache,
                                                  torch.tensor(i, dtype=torch.int32), cfg)
    else:
        pre, _ = jax.jit(jx.prefill, static_argnums=(2, 3))(params, {"tokens": tokens}, cfg, n)
        step = jax.jit(jx.decode_step, static_argnums=4)
        cache = jx.init_cache(cfg, 1, n)
        for i in range(n):
            dec, cache = step(params, tokens[:, i:i + 1], cache, jnp.int32(i), cfg)
    return _np(pre)[0, -1, :cfg.vocab], _np(dec)[0, -1, :cfg.vocab]


def test_bf16_drift_matches_the_reference():
    """At xlstm-1.3b's full depth (6 groups of 7 mLSTM and 1 sLSTM block),
    the random-weight model amplifies rounding: the reference's own bf16
    logits stray from the f32 logits of the same weights by more than half
    of the largest (its prefill and its decode loop alike).  The port's f32
    logits match the reference's at 2e-4 of the largest on both paths, and
    its bf16 drift on each path stays within twice the reference's largest."""
    shape = dict(n_layers=48, slstm_every=8)
    cfg_j = j_reduced("xlstm-1.3b", dtype="bfloat16", **shape)
    cfg = get_reduced_config("xlstm-1.3b", dtype="bfloat16", **shape)
    pj = jx.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    cfg32_j = dataclasses.replace(cfg_j, dtype="float32")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pj32 = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    pt32 = torch.utils._pytree.tree_map(lambda t: t.float(), pt)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (1, 8)).astype(np.int32)
    ours, ours32, ref, ref32 = (_last_logits_both_paths(p, c, tokens) for p, c in (
        (pt, cfg), (pt32, cfg32), (pj, cfg_j), (pj32, cfg32_j)))
    scale = float(np.abs(ref32[0]).max())
    for o, r in zip(ours32, ref32):
        np.testing.assert_allclose(o, r, rtol=TOL["float32"], atol=TOL["float32"] * scale)
    ref_drift = max(np.abs(b - f).max() for b, f in zip(ref, ref32)) / scale
    assert ref_drift > 0.5
    for b, f in zip(ours, ours32):
        assert np.abs(b - f).max() / scale <= 2 * ref_drift
