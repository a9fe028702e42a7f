"""Training the MoE family in the port against the JAX package on the CPU:
the reduced mixtral-8x7b (4 experts, top-2, window 32) and
llama4-maverick (a dense layer, then top-1 of 4 experts beside a shared
expert) in f32, on the same (converted) parameters and numpy batches.

* every gradient leaf of ``make_loss_fn`` against ``jax.grad`` of the
  reference's loss (rtol 2e-4, atol 2e-5: tests/test_training.py's rule,
  as tests/test_torch_training.py holds the other families).  The reduced
  configs' ``capacity_factor`` of 8 drops nothing, so a last-bit
  difference of the router cannot move a pair across the capacity.  Top-1
  routing renormalises the gate to p / p = 1, so llama4's router takes
  only that quotient's rounding in both packages (under 2e-5);
* at a capacity that drops pairs, ``moe_apply``'s gradients (the tokens,
  the router and the expert stacks) against ``jax.grad`` of the
  reference's ``moe_apply`` (``mode="drop"``), and a token all of whose
  pairs dropped takes a zero gradient in both;
* ``remat`` bitwise the plain forward, three train steps at the
  reference's losses and gradient norms, and a two-step run bitwise its
  twin that stops after the first step and resumes from the checkpoint
  store."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models.registry import get_model as j_get_model  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training.optimizer import init_opt_state as j_init_opt  # noqa: E402
from repro.training.step import make_loss_fn as j_make_loss_fn  # noqa: E402
from repro.training.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.training.data import DataConfig, synth_batch  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    init_opt_state,
    leaf_paths,
    tree_map,
)
from repro_torch.training.step import (  # noqa: E402
    batch_to_device,
    init_train_state,
    make_loss_fn,
    make_train_step,
)

MOE_ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5   # tests/test_training.py::test_gradients_match
SHAPE = ShapeConfig("t", 32, 4, "train")
DROP_TOKENS = 64                    # capacity_factor 1.0: 32 pairs an expert


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _pair(arch, seed=0, **overrides):
    """Both packages' reduced configs, the reference's params and the same
    numbers as the port's."""
    cfg_j, cfg = j_reduced(arch, **overrides), get_reduced_config(arch, **overrides)
    pj = j_get_model(cfg_j).init_params(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")


def _grads(loss_fn, params, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(live, batch)
    paths = [path for path, _ in leaf_paths(live)]
    grads = torch.autograd.grad(loss, [p for _, p in leaf_paths(live)])
    return loss, dict(zip(paths, grads))


def _j_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def _assert_grads_close(grads, j_grads) -> None:
    ref = _j_leaves(j_grads)
    assert set(ref) == set(grads)
    for k, g in grads.items():
        assert tuple(g.shape) == tuple(ref[k].shape), k
        np.testing.assert_allclose(_np(g), _np(ref[k]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(k))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_every_gradient_leaf_matches_jax_grad(arch):
    cfg_j, cfg, pj, pt = _pair(arch)
    nb = synth_batch(cfg, SHAPE, 0, DataConfig())
    j_loss, j_grads = jax.value_and_grad(j_make_loss_fn(cfg_j, remat=False))(pj, nb)
    loss, grads = _grads(make_loss_fn(cfg, remat=False), pt, batch_to_device(nb, "cpu"))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    _assert_grads_close(grads, j_grads)
    if cfg.moe_top_k == 1:
        # the renormalised top-1 gate is p / p = 1: only the rounding of
        # that quotient reaches the router, in both packages
        router = [k for k in grads if k[-1] == "router"]
        assert router
        for k in router:
            assert np.abs(_np(grads[k])).max() < GRAD_ATOL
            assert np.abs(_np(_j_leaves(j_grads)[k])).max() < GRAD_ATOL


def _drop_layer():
    """The reduced mixtral's MoE layer at capacity_factor 1.0 over 64
    unit-normal tokens that share a unit-normal common part, so that two
    experts take most pairs: 30 of the 128 drop, and 5 tokens lose both."""
    cfg_j = j_reduced("mixtral-8x7b", capacity_factor=1.0)
    cfg = get_reduced_config("mixtral-8x7b", capacity_factor=1.0)
    pj = jmoe.moe_init(jax.random.PRNGKey(1), cfg_j, jnp.float32)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 1, (1, 1, cfg.d_model))
         + rng.normal(0, 1, (1, DROP_TOKENS, cfg.d_model))).astype(np.float32)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    return cfg_j, cfg, pj, pt, x, cot


def test_dropped_pairs_take_no_gradient():
    cfg_j, cfg, pj, pt, x, cot = _drop_layer()
    cap = moe.moe_capacity(DROP_TOKENS, cfg)
    assert cap == jmoe.moe_capacity(DROP_TOKENS, cfg_j) == 32
    xt = tensor_from_numpy(x)
    order, slot, _, counts = moe.route(pt, xt.reshape(DROP_TOKENS, -1), cfg, cap)
    k = cfg.moe_top_k
    dropped = torch.zeros(DROP_TOKENS * k, dtype=torch.bool)
    dropped[order] = slot == cfg.moe_experts * cap            # in pair order
    all_dropped = dropped.reshape(DROP_TOKENS, k).all(dim=1).numpy()
    assert int(dropped.sum()) == int(torch.clamp(counts - cap, min=0).sum()) > 0
    assert 0 < all_dropped.sum() < DROP_TOKENS

    def j_loss(p, xx):
        return jnp.sum(jmoe.moe_apply(p, xx, cfg_j) * cot)

    j_gp, j_gx = jax.grad(j_loss, argnums=(0, 1))(pj, jnp.asarray(x))
    live = tree_map(lambda p: p.detach().requires_grad_(True), pt)
    xl = xt.clone().requires_grad_(True)
    loss = (moe.moe_apply(live, xl, cfg) * torch.from_numpy(cot)).sum()
    paths = leaf_paths(live)
    grads = torch.autograd.grad(loss, [p for _, p in paths] + [xl])
    _assert_grads_close({path: g for (path, _), g in zip(paths, grads)}, j_gp)
    gx = grads[-1].numpy()[0]
    np.testing.assert_allclose(gx, np.asarray(j_gx)[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # a token whose every pair dropped: no expert output, no gate gradient
    assert not gx[all_dropped].any()
    assert not np.asarray(j_gx)[0][all_dropped].any()
    assert np.abs(gx[~all_dropped]).sum(axis=-1).min() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_is_bitwise_the_plain_forward(arch):
    cfg = get_reduced_config(arch)
    params, _ = init_train_state(cfg, seed=1, device="cpu")
    batch = batch_to_device(synth_batch(cfg, SHAPE, 0, DataConfig()), "cpu")
    loss_a, ga = _grads(make_loss_fn(cfg, remat=True), params, batch)
    loss_b, gb = _grads(make_loss_fn(cfg, remat=False), params, batch)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_three_train_steps_match_the_references(arch):
    cfg_j, cfg, pj, pt = _pair(arch)
    j_step = jax.jit(j_make_train_step(cfg_j, JAdamWConfig(lr=3e-3, warmup_steps=2)))
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2))
    j_opt, opt = j_init_opt(pj), init_opt_state(pt)
    for i in range(3):
        nb = synth_batch(cfg, SHAPE, i, DataConfig())
        pj, j_opt, jm = j_step(pj, j_opt, nb)
        pt, opt, m = step(pt, opt, nb)
        assert int(m["step"]) == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_resumed_run_is_bitwise_the_straight_run(arch, tmp_path):
    """Two steps straight, against one step, the state written to the store,
    a fresh process's state restored from it and the second step: the
    parameters, the optimizer state and the loss bitwise equal."""
    cfg = get_reduced_config(arch)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    batches = [synth_batch(cfg, SHAPE, i, DataConfig()) for i in range(2)]
    params, opt = init_train_state(cfg, seed=0, device="cpu")
    params, opt, _ = step(params, opt, batches[0])
    store.save(str(tmp_path), 1, {"params": params, "opt": opt})
    params, opt, straight = step(params, opt, batches[1])

    fresh, fresh_opt = init_train_state(cfg, seed=0, device="cpu")
    state = store.restore(str(tmp_path), 1, {"params": fresh, "opt": fresh_opt})
    resumed_p, resumed_opt, resumed = step(state["params"], state["opt"], batches[1])
    assert torch.equal(straight["loss"], resumed["loss"])
    for (path, a), (_, b) in zip(leaf_paths({"params": params, "opt": opt}),
                                 leaf_paths({"params": resumed_p, "opt": resumed_opt})):
        assert torch.equal(a, b), path
