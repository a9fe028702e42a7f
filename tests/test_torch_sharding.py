"""The port's sharding layer against the JAX package's: every family's
partition specs leaf for leaf, the shape helpers of the registry, ZeRO-1
optimizer specs, the int8 compressed all-reduce (1 and 4 gloo ranks against
a 4-device ``shard_map``) and the sequence-parallel decode attention (2 and
4 ranks against the reference's ``_sp_decode_attention``).  The multi-rank
runs are CPU processes over gloo (``tests/gloo_ranks.py``); the JAX side
runs once in one process with 4 placeholder host devices."""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from gloo_ranks import run_jax4, run_ranks
from repro.configs import get_config as j_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsh
from repro.distributed.straggler import SkipAndRescale as JSkipAndRescale
from repro.models import registry as jreg
from repro.training.optimizer import opt_state_specs as j_opt_state_specs
from repro_torch.configs import CONFIGS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.straggler import SkipAndRescale
from repro_torch.launch.mesh import make_production_mesh, mesh_dp_size
from repro_torch.models import registry
from repro_torch.training.optimizer import opt_state_specs

ARCHS = sorted(CONFIGS)


def flat(tree, path=""):
    """(path, leaf) pairs of a spec or shape tree, dict keys sorted."""
    if isinstance(tree, (P, JP)) or not isinstance(tree, (dict, tuple, list)):
        return [(path, tree)]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    return [pair for k, v in items for pair in flat(v, f"{path}/{k}")]


def spec_leaves(tree):
    return [(p, tuple(s)) for p, s in flat(tree)]


def shape_leaves(tree):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in flat(tree)]


# ---------------------------------------------------------------------------
# specs and shapes, in process
# ---------------------------------------------------------------------------

SPEC_CASES = [
    (("dp", None), ("data", "model")),
    (("dp", "tp"), ("pod", "data", "model")),
    ((None, ("dp", "tp")), ("pod", "data", "model")),
    (("tp", None, "dp"), ("data",)),
    (("model", "data"), ("data", "model")),
    ((("dp",), None), ("pod", "data")),
    ((), ("data", "model")),
    (("tp",), ("pod",)),
]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("parts,names", SPEC_CASES)
def test_translate_spec_matches_reference(parts, names):
    ours = sh.translate_spec(P(*parts), names)
    ref = jsh.translate_spec(JP(*parts), names)
    assert tuple(ours) == tuple(ref)
    assert tuple(sh.translate_tree({"a": [P(*parts)]}, names)["a"][0]) == tuple(ref)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("parts,shape,dp", [
    ((None, "tp"), (32, 64), 16), (("tp", None), (8, 64), 16), ((None,), (7,), 4),
    ((), (16, 16), 16), ((None, None, "tp"), (2, 3, 32), 2), (("dp",), (64,), 16),
])
def test_zero1_spec_matches_reference(parts, shape, dp):
    assert tuple(sh.zero1_spec(P(*parts), shape, dp)) == tuple(jsh.zero1_spec(JP(*parts), shape, dp))


@pytest.mark.timeout(60)
def test_logical_axes():
    assert sh.translate_spec(P("dp", None, "tp"), ("data", "model")) == P("data", None, "model")
    assert sh.translate_spec(P("dp", "tp"), ("pod", "data", "model")) == P(
        ("pod", "data"), "model")


@pytest.mark.timeout(60)
def test_unknown_axis_dropped():
    assert sh.translate_spec(P("tp"), ("data",)) == P(None)


@pytest.mark.timeout(60)
def test_zero1_adds_dp_on_first_divisible():
    assert sh.zero1_spec(P(None, "tp"), (64, 128), 16) == P("dp", "tp")
    # first dim not divisible -> second
    assert sh.zero1_spec(P(None, None), (7, 32), 16) == P(None, "dp")
    # nothing divisible -> unchanged
    assert sh.zero1_spec(P(None,), (7,), 16) == P(None)


@pytest.mark.timeout(60)
def test_partition_spec_equality_is_the_references():
    pairs = [((("a",),), ("a",)), ((None,), ()), (("a", None), ("a",)), ((("a", "b"),), (("a", "b"),))]
    for x, y in pairs:
        assert (P(*x) == P(*y)) == (JP(*x) == JP(*y)), (x, y)
        assert tuple(P(*x)) == tuple(JP(*x))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_and_the_param_tree(arch):
    cfg = get_config(arch)
    model = registry.get_model(cfg)
    ours = model.param_specs(cfg)
    ref = jreg.get_model(j_config(arch)).param_specs(j_config(arch))
    assert spec_leaves(ours) == spec_leaves(ref)
    shapes = registry.params_shape(cfg)
    assert [p for p, _ in flat(ours)] == [p for p, _ in flat(shapes)]
    for (_, spec), (_, leaf) in zip(flat(ours), flat(shapes)):
        assert len(spec) == leaf.ndim


@pytest.mark.timeout(120)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference_and_the_cache_tree(arch, shape):
    cfg, jcfg = get_config(arch), j_config(arch)
    b = SHAPES[shape].global_batch
    ours = registry.get_model(cfg).cache_specs(cfg, b)
    ref = jreg.get_model(jcfg).cache_specs(jcfg, b)
    assert spec_leaves(ours) == spec_leaves(ref)
    token, cache, pos = registry.decode_specs(cfg, SHAPES[shape])
    jtoken, jcache, jpos = jreg.decode_specs(jcfg, J_SHAPES[shape])
    assert shape_leaves(cache) == shape_leaves(jcache)
    assert shape_leaves([token, pos]) == shape_leaves([jtoken, jpos])
    assert all(t.device.type == "meta" for _, t in flat(cache))
    # the cache's own leaf order (dict insertion) is what the specs follow
    assert [p for p, _ in flat(ours)] == [p for p, _ in flat(cache)]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for name in SHAPES:
        assert registry.shape_applies(cfg, SHAPES[name]) == jreg.shape_applies(jcfg, J_SHAPES[name])
        assert registry.effective_lengths(cfg, SHAPES[name]) == jreg.effective_lengths(
            jcfg, J_SHAPES[name])
        ours = registry.batch_specs(cfg, SHAPES[name])
        assert shape_leaves(ours) == shape_leaves(jreg.batch_specs(jcfg, J_SHAPES[name]))
    assert registry.param_count(cfg) == jreg.param_count(jcfg)
    assert registry.active_param_count(cfg) == jreg.active_param_count(jcfg)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    model, jmodel = registry.get_model(cfg), jreg.get_model(jcfg)
    for dp in (16, 2):
        ours = opt_state_specs(model.param_specs(cfg), registry.params_shape(cfg), dp)
        ref = j_opt_state_specs(jmodel.param_specs(jcfg), jreg.params_shape(jcfg), dp)
        assert spec_leaves(ours) == spec_leaves(ref)


@pytest.mark.timeout(60)
def test_params_shape_allocates_nothing():
    shapes = registry.params_shape(get_config("llama4-maverick-400b-a17b"))
    assert all(t.device.type == "meta" for _, t in flat(shapes))
    assert registry.param_count(get_config("llama4-maverick-400b-a17b")) > 3.9e11


@pytest.mark.timeout(60)
def test_use_mesh_sets_the_current_mesh_and_a_description_is_not_live():
    assert sh.current_mesh() is None and sh.live_mesh() is None
    with sh.use_mesh(make_production_mesh()) as mesh:
        assert sh.current_mesh() is mesh
        assert sh.live_mesh() is None
        with pytest.raises(RuntimeError, match="no process group"):
            mesh.coordinate("data")
    assert sh.current_mesh() is None


@pytest.mark.timeout(60)
def test_production_mesh_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and not one.live
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert (mesh_dp_size(one), mesh_dp_size(two)) == (16, 32)
    assert sh.named_sharding(one, P("dp", "tp")).placements == (Shard(0), Shard(1))
    assert sh.named_sharding(two, P(None, "dp")).placements == (Shard(1), Shard(1), Replicate())
    assert sh.named_sharding(one, P()).placements == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# the compressed all-reduce on one rank (the ports of TestCompression)
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.timeout(60)
def test_quantize_roundtrip_error_bound(rng):
    x = torch.as_tensor(rng.normal(0, 1, (128,)).astype(np.float32))
    q, scale = comp.quantize_int8(x)
    assert float((comp.dequantize_int8(q, scale) - x).abs().max()) <= float(scale) * 0.5 + 1e-6
    jq, js = jcomp.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(js)


@pytest.mark.timeout(60)
def test_compressed_psum_one_rank(one_rank, rng):
    x = torch.as_tensor(rng.normal(0, 1, (64,)).astype(np.float32))
    out, err = comp.compressed_psum(x)
    q, s = comp.quantize_int8(x)
    np.testing.assert_allclose(out.numpy(), comp.dequantize_int8(q, s).numpy(), rtol=1e-6)
    np.testing.assert_array_equal(err.numpy(), (x - comp.dequantize_int8(q, s)).numpy())


@pytest.mark.timeout(60)
def test_error_feedback_converges(one_rank, rng):
    """Repeated compressed reductions of the same gradient with error
    feedback: the accumulated applied update converges to the true sum."""
    x = torch.as_tensor(rng.normal(0, 1, (256,)).astype(np.float32))
    err, applied, n = torch.zeros_like(x), torch.zeros_like(x), 50
    for _ in range(n):
        out, err = comp.compressed_psum(x, None, err)
        applied = applied + out
    np.testing.assert_allclose((applied / n).numpy(), x.numpy(), rtol=0, atol=2e-2)


@pytest.mark.timeout(60)
def test_wire_bytes_reduction():
    x = torch.zeros((1024,), dtype=torch.float32)
    q, _ = comp.quantize_int8(x)
    assert q.dtype == torch.int8 and q.nbytes * 4 == x.nbytes


@pytest.mark.timeout(60)
def test_init_error_state():
    state = comp.init_error_state({"a": torch.ones(3, 2, dtype=torch.bfloat16),
                                   "b": {"c": torch.ones(4)}})
    assert state["a"].dtype == torch.float32 and state["a"].shape == (3, 2)
    assert not state["b"]["c"].any()


@pytest.mark.timeout(60)
def test_restore_with_shardings(one_rank, tmp_path):
    """Elastic path on one rank: every leaf restored as a DTensor on a
    (1,) "data" mesh, the values and the checkpoint's dtypes kept."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import store
    from repro_torch.launch.mesh import make_live_mesh

    tree = {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "step": torch.tensor(2, dtype=torch.int32)}
    store.save(str(tmp_path / "ckpt"), 2, tree)
    mesh = make_live_mesh((1,), ("data",))
    shardings = {"params": {"w": sh.named_sharding(mesh, P()), "b": sh.named_sharding(mesh, P())},
                 "step": sh.named_sharding(mesh, P())}
    restored = store.restore(str(tmp_path / "ckpt"), 2, tree, shardings=shardings)
    w = restored["params"]["w"]
    assert isinstance(w, DTensor)
    np.testing.assert_array_equal(w.full_tensor().numpy(), tree["params"]["w"].numpy())
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert int(restored["step"].full_tensor()) == 2


@pytest.mark.timeout(60)
def test_skip_and_rescale():
    for cls in (SkipAndRescale, JSkipAndRescale):
        pol = cls(world=10, quorum_fraction=0.8)
        ok, scale = pol.step([True] * 9 + [False])
        assert ok and scale == pytest.approx(10 / 9)
        ok, _ = pol.step([True] * 7 + [False] * 3)
        assert not ok
    assert SkipAndRescale(7).step([True] * 7) == JSkipAndRescale(7).step([True] * 7)


# ---------------------------------------------------------------------------
# multi-rank: sequence-parallel decode attention and the compressed psum
# ---------------------------------------------------------------------------

# name: (dp, tp, batch, window); S = 32 keys, Hq 4, Hkv 2, D 16, f32
SP_CASES = {
    "tp2": (1, 2, 3, -1),
    "tp2_window": (1, 2, 3, 7),
    "tp4": (1, 4, 3, -1),
    "tp4_window": (1, 4, 3, 9),
    "dp2_tp2_b16": (2, 2, 16, 5),
}
CP_N, CP_SCALES = 96, (1.0, 3.0, 0.25, 10.0)


def _sp_inputs():
    rng = np.random.default_rng(7)
    out = {}
    for name, (dp, tp, b, window) in SP_CASES.items():
        out[f"{name}/q"] = rng.normal(0, 1, (b, 4, 16)).astype(np.float32)
        out[f"{name}/k"] = rng.normal(0, 1, (b, 32, 2, 16)).astype(np.float32)
        out[f"{name}/v"] = rng.normal(0, 1, (b, 32, 2, 16)).astype(np.float32)
        kv = rng.integers(1, 33, (b,)).astype(np.int32)
        kv[0], kv[-1] = 32, 1   # ragged, both ends
        out[f"{name}/kv_len"] = kv
        out[f"{name}/meta"] = np.array([dp, tp, b, window], np.int64)
    x = rng.normal(0, 1, (4, CP_N)).astype(np.float32) * np.asarray(CP_SCALES, np.float32)[:, None]
    out["cp_x"] = x
    out["cp_e"] = rng.normal(0, 1e-3, (4, CP_N)).astype(np.float32)
    out["qwen_prompt"] = rng.integers(0, 256, (1, 5)).astype(np.int32)
    return out


JAX_BODY = """
from types import SimpleNamespace
from jax.sharding import PartitionSpec as P
from repro.distributed.sharding import compat_make_mesh, get_shard_map
from repro.distributed.compression import compressed_psum
from repro.layers.attention import _sp_decode_attention
names = sorted({k.split("/")[0] for k in inputs if "/" in k})
for name in names:
    dp, tp, b, window = (int(v) for v in inputs[name + "/meta"])
    mesh = compat_make_mesh((dp, tp), ("data", "model"), devices=jax.devices()[: dp * tp])
    cfg = SimpleNamespace(window=None if window < 0 else window)
    results[name] = np.asarray(_sp_decode_attention(
        jnp.asarray(inputs[name + "/q"]), jnp.asarray(inputs[name + "/k"]),
        jnp.asarray(inputs[name + "/v"]), jnp.asarray(inputs[name + "/kv_len"]), cfg, mesh))
shard_map = get_shard_map()
for n in (4, 1):
    mesh = compat_make_mesh((n,), ("data",), devices=jax.devices()[:n])
    f = shard_map(lambda v, e: compressed_psum(v, "data", e), mesh=mesh,
                  in_specs=(P("data", None), P("data", None)),
                  out_specs=(P("data", None), P("data", None)))
    mean, err = f(jnp.asarray(inputs["cp_x"][:n]), jnp.asarray(inputs["cp_e"][:n]))
    results[f"cp{n}_mean"], results[f"cp{n}_err"] = np.asarray(mean), np.asarray(err)
"""

RANK_BODY = """
import dataclasses
from types import SimpleNamespace
from repro_torch.distributed.compression import compressed_psum, make_compressed_grad_psum
from repro_torch.distributed.sharding import PartitionSpec as P, block_of, use_mesh
from repro_torch.launch.mesh import make_live_mesh
from repro_torch.layers.attention import _sp_decode_attention, sp_decode_specs
names = sorted({k.split("/")[0] for k in inputs if "/" in k})
for name in names:
    dp, tp, b, window = (int(v) for v in inputs[name + "/meta"])
    if dp * tp != world:
        continue
    mesh = make_live_mesh((dp, tp), ("data", "model"))
    q_spec, kv_spec, len_spec = sp_decode_specs(b, mesh)
    q = block_of(torch.as_tensor(inputs[name + "/q"]), mesh, q_spec)
    k, v = (block_of(torch.as_tensor(inputs[name + "/" + t]), mesh, kv_spec) for t in "kv")
    kv_len = block_of(torch.as_tensor(inputs[name + "/kv_len"]), mesh, len_spec)
    cfg = SimpleNamespace(window=None if window < 0 else window)
    results[name] = _sp_decode_attention(q, k, v, kv_len, cfg, mesh).numpy()
    results[name + "/coords"] = np.array([mesh.coordinate("data"), mesh.coordinate("model")])
if world == 4:
    x, e = torch.as_tensor(inputs["cp_x"][rank]), torch.as_tensor(inputs["cp_e"][rank])
    mean, err = compressed_psum(x, None, e)
    results["cp4_mean"], results["cp4_err"] = mean.numpy(), err.numpy()
    singles = [dist.new_group([r]) for r in range(world)]
    if rank == 0:
        mean1, err1 = compressed_psum(x, singles[0], e)
        results["cp1_mean"], results["cp1_err"] = mean1.numpy(), err1.numpy()
    mesh = make_live_mesh((2, 2), ("data", "model"))
    grads = {"b": {"c": x[:8].reshape(2, 4)}, "a": x}
    errs = {"b": {"c": e[:8].reshape(2, 4)}, "a": e}
    means, new = make_compressed_grad_psum(mesh, "data")(grads, errs)
    direct = compressed_psum(x[:8].reshape(2, 4), mesh.group("data"), e[:8].reshape(2, 4))
    results["tree_equal"] = np.array([
        bool(torch.equal(means["b"]["c"], direct[0])), bool(torch.equal(new["b"]["c"], direct[1])),
        list(means) == ["b", "a"]])
if world == 2:
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_reduced_config("qwen3-0.6b"), sp_decode=True)
    params = lm.init_params(cfg, 0, "cpu")
    prompt = torch.as_tensor(inputs["qwen_prompt"])
    s, steps, max_seq = prompt.shape[1], 6, 16
    logits, cache = lm.prefill(params, {"tokens": prompt}, cfg, max_seq)
    mesh = make_live_mesh((1, 2), ("data", "model"))
    spec = P(None, None, "model", None, None)
    local = {sub: {n: block_of(t, mesh, spec).clone() for n, t in c.items()}
             for sub, c in cache.items()}
    nxt = nxt_ref = torch.argmax(logits[:, -1, : cfg.vocab], -1).to(torch.int32)[:, None]
    out, out_ref = [], []
    for i in range(steps):
        pos = torch.tensor(s + i, dtype=torch.int32)
        with use_mesh(mesh):
            lg, local = lm.decode_step(params, nxt, local, pos, cfg)
        lg_ref, cache = lm.decode_step(params, nxt_ref, cache, pos, cfg)
        out.append(lg[:, -1, : cfg.vocab])
        out_ref.append(lg_ref[:, -1, : cfg.vocab])
        nxt = torch.argmax(out[-1], -1).to(torch.int32)[:, None]
        nxt_ref = torch.argmax(out_ref[-1], -1).to(torch.int32)[:, None]
    results["qwen_logits"] = torch.stack(out).numpy()
    results["qwen_logits_ref"] = torch.stack(out_ref).numpy()
    results["qwen_cache_k"] = local["sub0"]["k"].numpy()
    results["qwen_cache_k_ref"] = block_of(cache["sub0"]["k"], mesh, spec).numpy()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("sharding")
    inputs = _sp_inputs()
    return {
        "jax": run_jax4(base / "jax", JAX_BODY, inputs),
        2: run_ranks(base / "w2", 2, RANK_BODY, inputs),
        4: run_ranks(base / "w4", 4, RANK_BODY, inputs),
    }


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_sp_decode_attention_matches_reference(runs, name):
    dp, tp, b, _ = SP_CASES[name]
    ref = runs["jax"][name]
    ranks = runs[dp * tp]
    assert len(ranks) == dp * tp
    rows = b // dp if b >= 16 else b
    for res in ranks:
        i_dp, i_tp = res[name + "/coords"]
        lo = i_dp * rows if b >= 16 else 0
        np.testing.assert_allclose(res[name], ref[lo: lo + rows], rtol=2e-4, atol=2e-4)
    # every model rank holds the combined output
    for a in ranks[1:tp]:
        np.testing.assert_array_equal(a[name], ranks[0][name])


@pytest.mark.timeout(600)
def test_sp_decode_reduced_qwen3_two_ranks_matches_unmeshed(runs):
    r0, r1 = runs[2]
    np.testing.assert_allclose(r0["qwen_logits"], r0["qwen_logits_ref"], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(r0["qwen_logits"], r1["qwen_logits"])
    assert (r0["qwen_logits"].argmax(-1) == r0["qwen_logits_ref"].argmax(-1)).all()
    # each rank wrote the new rows into its own slice only
    for r in (r0, r1):
        np.testing.assert_allclose(r["qwen_cache_k"], r["qwen_cache_k_ref"], rtol=2e-4, atol=2e-4)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("n", [1, 4])
def test_compressed_psum_ranks_match_reference_shard_map(runs, n):
    ref_mean, ref_err = runs["jax"][f"cp{n}_mean"], runs["jax"][f"cp{n}_err"]
    for r in range(n):
        res = runs[4][r]
        np.testing.assert_allclose(res[f"cp{n}_mean"], ref_mean[r], rtol=0, atol=1e-6)
        np.testing.assert_allclose(res[f"cp{n}_err"], ref_err[r], rtol=0, atol=1e-6)


@pytest.mark.timeout(600)
def test_compressed_grad_psum_is_compressed_psum_leaf_by_leaf(runs):
    for res in runs[4]:
        assert res["tree_equal"].all()


# measured max |mean - exact mean of the dequantized values| at 4 ranks with
# scales 1, 3, 0.25 and 10 (both packages; ROADMAP queue C)
MEAN_SCALE_DELTA = 5.372187


@pytest.mark.timeout(600)
def test_compressed_psum_uses_the_mean_scale_in_both_packages(runs):
    """repro.distributed.compression and repro_torch.distributed.compression
    both multiply every rank's int8 payload by the *mean* of the ranks'
    scales, not the sender's own: with unequal scales the result is not the
    mean of the dequantized values their comment names."""
    inputs = _sp_inputs()
    xs = torch.as_tensor(inputs["cp_x"] + inputs["cp_e"])
    exact = torch.stack([comp.dequantize_int8(*comp.quantize_int8(r)) for r in xs]).mean(0)
    ours = torch.as_tensor(runs[4][0]["cp4_mean"])
    ref = torch.as_tensor(runs["jax"]["cp4_mean"][0])
    delta_ours = float((ours - exact).abs().max())
    delta_ref = float((ref - exact).abs().max())
    assert delta_ours == pytest.approx(delta_ref, abs=1e-5)
    assert delta_ours == pytest.approx(MEAN_SCALE_DELTA, abs=1e-4), delta_ours


@pytest.mark.timeout(150)
def test_isolation_of_the_sharding_modules():
    """The new modules load no JAX and nothing of the JAX package."""
    import subprocess
    import sys

    from gloo_ranks import ROOT

    code = (
        "import sys\n"
        "import repro_torch.distributed.sharding, repro_torch.distributed.compression\n"
        "import repro_torch.launch.mesh, repro_torch.launch.serve, repro_torch.models.registry\n"
        "import repro_torch.checkpoint.store, repro_torch.layers.moe, repro_torch.layers.attention\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " or m == 'repro')\n"
        "print('LOADED', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
