"""The port's sharded paths against the JAX package's: the shard-local MoE
dispatch on a (2, 2) mesh (the config of ``tests/test_moe_shardmap.py``),
forward and backward,
the elastic restore of a checkpoint saved from 4 ranks onto 2,
``restore(shardings=)`` on one rank, and the serve launcher against
``repro.launch.serve``.  Multi-rank runs are CPU processes over gloo; the
JAX side runs once with 4 placeholder host devices."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloo_ranks import run_jax4, run_ranks
from repro.configs import get_reduced_config as j_reduced
from repro.configs.base import ArchConfig as JArchConfig
from repro.launch import serve as jserve
from repro.layers import moe as jmoe
from repro.models.registry import get_model as j_model
from repro_torch.configs import get_reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve

# the reference's tests/test_moe_shardmap.py config; "tp" has 3 experts, which
# "model" = 2 does not divide: TP inside each expert
MOE_CFG = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
               d_head=8, d_ff=64, vocab=128, dtype="float32", moe_top_k=2,
               capacity_factor=8.0)
MOE_CASES = {"ep": (4, (4, 8, 32)), "tp": (3, (4, 8, 32)), "few_tokens": (4, (2, 3, 32))}


def _moe_inputs():
    out = {}
    rng = np.random.default_rng(0)
    for name, (experts, shape) in MOE_CASES.items():
        cfg = JArchConfig(**MOE_CFG, moe_experts=experts)
        p = jmoe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
        for leaf in ("router", "w_gate", "w_up", "w_down"):
            out[f"{name}/{leaf}"] = np.asarray(p[leaf])
        out[f"{name}/x"] = rng.normal(0, 1, shape).astype(np.float32)
        out[f"{name}/c"] = rng.normal(0, 1, shape).astype(np.float32)
        out[f"{name}/experts"] = np.array(experts)
    return out


JAX_BODY = """
import dataclasses
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ArchConfig
from repro.distributed.sharding import compat_make_mesh, use_mesh
from repro.layers import moe as moe_mod
base = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
            d_head=8, d_ff=64, vocab=128, dtype="float32", moe_top_k=2, capacity_factor=8.0)
mesh = compat_make_mesh((2, 2), ("data", "model"))
for name in sorted({k.split("/")[0] for k in inputs}):
    cfg = ArchConfig(**base, moe_experts=int(inputs[name + "/experts"]))
    cfg_sm = dataclasses.replace(cfg, moe_groups=2)
    p = {leaf: jnp.asarray(inputs[name + "/" + leaf]) for leaf in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(inputs[name + "/x"])
    results[name + "/global"] = np.asarray(moe_mod.moe_apply(p, x, cfg))
    with use_mesh(mesh):
        f = jax.jit(lambda p_, x_: moe_mod.moe_apply(p_, x_, cfg_sm),
                    in_shardings=(None, NamedSharding(mesh, P(("data",), None, None))),
                    out_shardings=NamedSharding(mesh, P(("data",), None, None)))
        results[name + "/sharded"] = np.asarray(f(p, x))
    # gradients of sum(y * c): global, and through the shard_map dispatch
    c = jnp.asarray(inputs[name + "/c"])
    loss = lambda cfg_: lambda p_, x_: jnp.sum(moe_mod.moe_apply(p_, x_, cfg_) * c)
    grads = {"global": jax.grad(loss(cfg), argnums=(0, 1))(p, x)}
    with use_mesh(mesh):
        grads["sharded"] = jax.jit(
            jax.grad(loss(cfg_sm), argnums=(0, 1)),
            in_shardings=(None, NamedSharding(mesh, P(("data",), None, None))))(p, x)
    for kind, (gp, gx) in grads.items():
        results[f"{name}/{kind}_grad/x"] = np.asarray(gx)
        for leaf, g in gp.items():
            results[f"{name}/{kind}_grad/{leaf}"] = np.asarray(g)
"""

MOE_BODY = """
import dataclasses
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import PartitionSpec as P, block_of, use_mesh
from repro_torch.launch.mesh import make_live_mesh
from repro_torch.layers import moe
base = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
            d_head=8, d_ff=64, vocab=128, dtype="float32", moe_top_k=2, capacity_factor=8.0)
mesh = make_live_mesh((2, 2), ("data", "model"))
for name in sorted({k.split("/")[0] for k in inputs}):
    cfg = ArchConfig(**base, moe_experts=int(inputs[name + "/experts"]))
    cfg_sm = dataclasses.replace(cfg, moe_groups=2)
    p = {leaf: torch.as_tensor(inputs[name + "/" + leaf]) for leaf in ("router", "w_gate", "w_up", "w_down")}
    x = torch.as_tensor(inputs[name + "/x"])
    x_local = block_of(x, mesh, P("data", None, None)).clone().requires_grad_()
    c_local = block_of(torch.as_tensor(inputs[name + "/c"]), mesh, P("data", None, None))
    for t in p.values():
        t.requires_grad_()
    with use_mesh(mesh):
        y1 = moe.moe_apply(p, x_local, cfg_sm)
        with torch.no_grad():
            y2 = moe.moe_apply(p, x_local, cfg_sm)
    (y1 * c_local).sum().backward()
    results[name + "/local"] = y1.detach().numpy()
    results[name + "/bitwise"] = np.array(bool(torch.equal(y1, y2)))
    results[name + "/grad/x"] = x_local.grad.numpy()
    for leaf, t in p.items():
        results[name + "/grad/" + leaf] = t.grad.numpy()
    with torch.no_grad():
        y_global = moe.moe_apply(p, x, cfg)
    results[name + "/global"] = block_of(y_global, mesh, P("data", None, None)).numpy()
    results[name + "/dp"] = np.array(mesh.coordinate("data"))
    results[name + "/tp"] = np.array(mesh.coordinate("model"))
"""


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("moe")
    inputs = _moe_inputs()
    return {"jax": run_jax4(base / "jax", JAX_BODY, inputs),
            "ranks": run_ranks(base / "w4", 4, MOE_BODY, inputs)}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_shard_local_moe_dispatch_matches_global_and_reference(moe_runs, name):
    ref_sharded = moe_runs["jax"][name + "/sharded"]
    ref_global = moe_runs["jax"][name + "/global"]
    np.testing.assert_allclose(ref_sharded, ref_global, rtol=0, atol=1e-4)
    rows = MOE_CASES[name][1][0] // 2
    for res in moe_runs["ranks"]:
        lo = int(res[name + "/dp"]) * rows
        np.testing.assert_allclose(res[name + "/local"], res[name + "/global"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(res[name + "/local"], ref_sharded[lo: lo + rows],
                                   rtol=2e-4, atol=2e-4)
        assert bool(res[name + "/bitwise"])


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_shard_local_moe_dispatch_gradients_match_reference(moe_runs, name):
    """Backward through the shard-local dispatch (or, at few tokens, the
    gather over dp) against ``jax.grad`` through the reference's
    ``shard_map`` dispatch, for the loss sum(y * c) over all tokens.  Each
    rank holds x's gradient for its tokens, and every MoE parameter's
    gradient complete over "model" for its tokens: the two "model" ranks
    agree, and the sum over the dp ranks is the whole gradient."""
    jax_res = moe_runs["jax"]
    leaves = ("router", "w_gate", "w_up", "w_down")
    for leaf in ("x",) + leaves:
        np.testing.assert_allclose(jax_res[f"{name}/sharded_grad/{leaf}"],
                                   jax_res[f"{name}/global_grad/{leaf}"], rtol=0, atol=1e-4)
    ranks = moe_runs["ranks"]
    rows = MOE_CASES[name][1][0] // 2
    by_coord = {(int(r[name + "/dp"]), int(r[name + "/tp"])): r for r in ranks}
    for (dp, tp), res in by_coord.items():
        np.testing.assert_allclose(res[name + "/grad/x"],
                                   jax_res[f"{name}/sharded_grad/x"][dp * rows:][:rows],
                                   rtol=2e-4, atol=2e-4)
        for leaf in ("x",) + leaves:
            np.testing.assert_array_equal(res[f"{name}/grad/{leaf}"],
                                          by_coord[(dp, 1 - tp)][f"{name}/grad/{leaf}"])
    for leaf in leaves:
        total = by_coord[(0, 0)][f"{name}/grad/{leaf}"] + by_coord[(1, 0)][f"{name}/grad/{leaf}"]
        np.testing.assert_allclose(total, jax_res[f"{name}/sharded_grad/{leaf}"],
                                   rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# elastic restore: 4 ranks (2 x 2) -> 2 ranks (2 x 1)
# ---------------------------------------------------------------------------

SAVE_BODY = """
from repro_torch.checkpoint import store
from repro_torch.distributed.sharding import PartitionSpec as P, distribute, named_sharding
from repro_torch.launch.mesh import make_live_mesh
mesh = make_live_mesh((2, 2), ("data", "model"))
w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
b = torch.as_tensor(inputs["bf16_bits"]).view(torch.bfloat16)
tree = {"params": {"w": distribute(w, named_sharding(mesh, P("data", "model"))),
                   "b": distribute(b, named_sharding(mesh, P(None, "dp")))},
        "step": torch.tensor(9, dtype=torch.int32)}
results["local_shape"] = np.array(tree["params"]["w"].to_local().shape)
store.save(str(inputs["ckpt"]), 9, tree)
"""

RESTORE_BODY = """
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import store
from repro_torch.distributed.sharding import PartitionSpec as P, named_sharding
from repro_torch.launch.mesh import make_live_mesh
mesh = make_live_mesh((2, 1), ("data", "model"))
meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
target = {"params": {"w": meta((64, 32), torch.float32), "b": meta((8, 6), torch.float32)},
          "step": meta((), torch.int32)}
shardings = {"params": {"w": named_sharding(mesh, P("data", "model")),
                        "b": named_sharding(mesh, P("dp", None))},
             "step": named_sharding(mesh, P())}
step = store.latest_step(str(inputs["ckpt"]))
restored = store.restore(str(inputs["ckpt"]), step, target, shardings=shardings)
w, b = restored["params"]["w"], restored["params"]["b"]
assert isinstance(w, DTensor) and w.device_mesh.size() == 2
results["step"] = np.array([step, int(restored["step"].full_tensor())])
results["w_local_shape"] = np.array(w.to_local().shape)
results["w"] = w.full_tensor().numpy()
results["b_bits"] = b.full_tensor().view(torch.int16).numpy()
results["b_dtype_kept"] = np.array(b.dtype == torch.bfloat16)
"""


@pytest.mark.timeout(600)
def test_elastic_restore_from_four_ranks_onto_two(tmp_path):
    bits = np.random.default_rng(3).integers(0, 2**15, (8, 6)).astype(np.int16)
    inputs = {"ckpt": np.array(str(tmp_path / "ckpt")), "bf16_bits": bits}
    saved = run_ranks(tmp_path / "save", 4, SAVE_BODY, inputs)
    assert all(tuple(r["local_shape"]) == (32, 16) for r in saved)
    restored = run_ranks(tmp_path / "restore", 2, RESTORE_BODY, inputs)
    expected = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    for r in restored:
        assert tuple(r["step"]) == (9, 9)
        assert tuple(r["w_local_shape"]) == (32, 32)
        np.testing.assert_array_equal(r["w"], expected)
        np.testing.assert_array_equal(r["b_bits"], bits)
        assert bool(r["b_dtype_kept"])


ONE_RANK_BODY = """
import dataclasses
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import store
from repro_torch.configs import get_reduced_config
from repro_torch.distributed.sharding import named_sharding_tree
from repro_torch.launch.mesh import make_live_mesh
from repro_torch.models import lm
from repro_torch.training.optimizer import leaf_paths, tree_map
cfg = dataclasses.replace(get_reduced_config("qwen3-0.6b"), dtype="bfloat16")
params = lm.init_params(cfg, 0, "cpu")
store.save(str(inputs["ckpt"]), 3, {"params": params})
mesh = make_live_mesh((1, 1), ("data", "model"))
template = {"params": tree_map(lambda t: torch.empty(t.shape, device="meta"), params)}
shardings = {"params": named_sharding_tree(lm.param_specs(cfg), mesh)}
restored = store.restore(str(inputs["ckpt"]), 3, template, shardings=shardings)["params"]
ok = []
for (path, a), (path_b, b) in zip(leaf_paths(params), leaf_paths(restored)):
    ok.append(path == path_b and isinstance(b, DTensor) and b.dtype == a.dtype
              and torch.equal(b.to_local().view(torch.int16), a.view(torch.int16)))
results["ok"] = np.array(ok)
plain = store.restore(str(inputs["ckpt"]), 3, {"params": params})["params"]
results["plain_ok"] = np.array(all(torch.equal(x, y) for (_, x), (_, y) in
                                   zip(leaf_paths(params), leaf_paths(plain))))
"""


@pytest.mark.timeout(300)
def test_restore_with_shardings_on_one_rank_is_bitwise(tmp_path):
    res = run_ranks(tmp_path / "one", 1, ONE_RANK_BODY,
                    {"ckpt": np.array(str(tmp_path / "ckpt"))})[0]
    assert res["ok"].size > 5 and res["ok"].all()
    assert bool(res["plain_ok"])


# ---------------------------------------------------------------------------
# the serve launcher against repro.launch.serve
# ---------------------------------------------------------------------------

@pytest.mark.timeout(300)
@pytest.mark.parametrize("system", ["local", "rrto", "cricket", "semi_rrto"])
def test_serve_launcher_matches_reference(system):
    """Tokens and modes equal, and every replayed token's RPCs.  Recording
    RPCs differ by design (the reference records its layer ``lax.scan`` as
    one equation, the port every aten call of the unrolled layers), so a
    recording token is held to the reference's structure: cricket's first
    and last token cost the same, semi_rrto's last saves the same RPCs."""
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--system", system,
            "--tokens", "6", "--prompt-len", "5"]
    ref = jserve.main(argv)
    jcfg = j_reduced("qwen3-0.6b")
    numpy_params = jax.tree.map(np.asarray, j_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(numpy_params, get_reduced_config("qwen3-0.6b"), "cpu")
    ours = serve.main(argv + ["--device", "cpu"], params=params)
    assert ours["tokens"] == ref["tokens"]
    assert set(ours) == set(ref)
    if system == "local":
        return
    assert ours["mode"] == ref["mode"]
    assert ours["rpcs_first"] > ref["rpcs_first"]
    if system == "rrto":
        assert ours["mode"] == "replaying" and ours["rpcs_last"] == ref["rpcs_last"] == 3
    else:
        assert ours["rpcs_first"] - ours["rpcs_last"] == ref["rpcs_first"] - ref["rpcs_last"]


@pytest.mark.timeout(120)
def test_serve_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced", "--tokens", "2"])


@pytest.mark.timeout(300)
def test_serve_launcher_random_weights_match_local_and_rrto():
    """Seeded weights of the port's own: the launcher's local and rrto runs
    give the same tokens, with the stack replaying at 3 RPCs a token."""
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--tokens", "5", "--prompt-len", "4",
            "--device", "cpu", "--seed", "2"]
    local = serve.main(argv)
    rrto = serve.main(argv + ["--system", "rrto", "--environment", "outdoor"])
    assert local["tokens"] == rrto["tokens"]
    assert rrto["mode"] == "replaying" and rrto["rpcs_last"] == 3


@pytest.mark.timeout(60)
def test_moe_config_fields_match():
    cfg = dataclasses.replace(get_reduced_config("mixtral-8x7b"), moe_groups=2, sp_decode=True)
    jcfg = dataclasses.replace(j_reduced("mixtral-8x7b"), moe_groups=2, sp_decode=True)
    for f in ("moe_groups", "disable_tp", "encoder_sp", "sp_decode", "skip_shapes"):
        assert getattr(cfg, f) == getattr(jcfg, f)
