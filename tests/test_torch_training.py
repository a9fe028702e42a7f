"""The port's training (``repro_torch.training``, ``models/lm.py``'s
``forward(remat=, return_hidden=)`` and ``loss_fn``, ``launch/train.py``,
the nested checkpoint store) against the JAX package's on the CPU, on the
same numpy inputs and (converted) parameters:

* tests/test_training.py's ``TestChunkedLoss``, ``TestOptimizer`` and
  ``TestData`` on the port; ``synth_batch`` bitwise the reference's;
* the chunked loss of one hidden state against JAX's; every gradient leaf
  of ``make_loss_fn`` against ``jax.grad`` (rtol 2e-4, atol 2e-5, the
  reference's own gradient check) for the reference's test config and f32
  reduced minicpm3-4b (MLA), zamba2-1.2b (the hybrid, through the gated
  scan's backward) and xlstm-1.3b (mLSTM and sLSTM), the last two reduced
  so that every block runs (``EVERY_BLOCK``); a bf16 loss at 2e-2, op by
  op (``jax.disable_jit``); ``remat`` bitwise; three train steps at 1e-4;
  ``adamw_update`` at 1e-6;
* the plain backwards of the two kernels on the training path (rmsnorm,
  flash attention) against ``jax.vjp`` of the reference's refs, f32 2e-4
  and bf16 2e-2 of the largest magnitude;
* tests/test_checkpoint.py's ``TestTrainRestart`` and
  tests/test_arch_smoke.py's ``test_forward_and_train_step`` on the port
  (all four families), a restart across the packages (the dense LM and
  the hybrid), and the store's nested names.
The backward kernels themselves are held against these plain versions on
the card in tests/test_torch_backward_kernels.py and
tests/test_torch_scan_backward.py (``requires_cuda``); the scan's plain
backward against ``jax.vjp`` in the latter."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.kernels.flash_attention.ref import attention_chunked as j_attention  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm  # noqa: E402
from repro.models.registry import get_model as j_get_model  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training.losses import chunked_lm_loss as j_chunked  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training.optimizer import adamw_update as j_adamw  # noqa: E402
from repro.training.optimizer import init_opt_state as j_init_opt  # noqa: E402
from repro.training.step import make_loss_fn as j_make_loss_fn  # noqa: E402
from repro.training.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import attention_chunked_backward  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_backward_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.training.data import DataConfig, data_stream, synth_batch  # noqa: E402
from repro_torch.training.losses import chunked_lm_loss  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    adamw_update,
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

FIELDS = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_head=16, d_ff=128, vocab=256, dtype="float32", rope_theta=1e4)
CFG = ArchConfig(**FIELDS)          # tests/test_training.py's config
J_CFG = JArchConfig(**FIELDS)
SHAPE = ShapeConfig("t", 32, 4, "train")
J_SHAPE = JShapeConfig("t", 32, 4, "train")
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5   # tests/test_training.py::test_gradients_match
# reductions of the hybrid and the xLSTM in which every block runs: the
# default ones have no full group (no shared attention block, no sLSTM)
EVERY_BLOCK = {"zamba2-1.2b": dict(n_layers=5, attn_every=2),
               "xlstm-1.3b": dict(n_layers=5, slstm_every=2)}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _batch(cfg=CFG, shape=SHAPE, step=0, dc=None):
    return batch_to_device(synth_batch(cfg, shape, step, dc or DataConfig()), "cpu")


def _pair(j_cfg, cfg, seed=0):
    """The reference's params and the same numbers as the port's."""
    pj = j_get_model(j_cfg).init_params(jax.random.PRNGKey(seed), j_cfg)
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")


def _reduced(arch, dtype="float32"):
    """The reduced config of ``arch`` in both packages (every block runs)."""
    kw = dict(EVERY_BLOCK.get(arch, {}), dtype=dtype)
    return j_reduced(arch, **kw), get_reduced_config(arch, **kw)


def _grads(loss_fn, params, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(live, batch)
    paths = [path for path, _ in leaf_paths(live)]
    grads = torch.autograd.grad(loss, [p for _, p in leaf_paths(live)])
    return loss, dict(zip(paths, grads))


def _j_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def _clone(params):
    return tree_map(lambda p: p.clone(), params)


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("seed,step,index,count", [(0, 0, 0, 1), (3, 7, 0, 1), (1, 2, 1, 2),
                                                   (5, 123, 3, 4)])
def test_synth_batch_is_the_references_bitwise(seed, step, index, count):
    dc = dict(seed=seed, process_index=index, process_count=count)
    ours = synth_batch(CFG, SHAPE, step, DataConfig(**dc))
    ref = jdata.synth_batch(J_CFG, J_SHAPE, step, jdata.DataConfig(**dc))
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


def test_data_stream_is_the_references():
    ours = data_stream(CFG, SHAPE, DataConfig(seed=2), start_step=5)
    ref = jdata.data_stream(J_CFG, J_SHAPE, jdata.DataConfig(seed=2), start_step=5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert np.array_equal(a["tokens"], b["tokens"])


class TestData:
    def test_stream_deterministic(self):
        a = synth_batch(CFG, SHAPE, 7, DataConfig(seed=3))
        b = synth_batch(CFG, SHAPE, 7, DataConfig(seed=3))
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_steps_differ(self):
        a = synth_batch(CFG, SHAPE, 1, DataConfig())
        b = synth_batch(CFG, SHAPE, 2, DataConfig())
        assert not np.array_equal(a["tokens"], b["tokens"])

    def test_process_sharding(self):
        full = synth_batch(CFG, SHAPE, 0, DataConfig(process_count=1))
        half = synth_batch(CFG, SHAPE, 0, DataConfig(process_count=2))
        assert half["tokens"].shape[0] == full["tokens"].shape[0] // 2


# ---------------------------------------------------------------- loss

class TestChunkedLoss:
    @pytest.mark.parametrize("chunk_len", [7, 16, 32, 256])
    def test_matches_dense(self, chunk_len):
        params, _ = init_train_state(CFG, seed=0, device="cpu")
        batch = _batch()
        dense_loss = lm.loss_fn(params, batch, CFG, remat=False)
        h = lm.forward(params, batch, CFG, return_hidden=True)
        chunked = chunked_lm_loss(h, params["final_norm"], lm.head_weights(params, CFG),
                                  batch["labels"], CFG, chunk_len=chunk_len)
        np.testing.assert_allclose(float(chunked), float(dense_loss), rtol=1e-5, atol=1e-6)

    def test_gradients_match(self):
        params, _ = init_train_state(CFG, seed=0, device="cpu")
        batch = _batch()
        _, g_dense = _grads(lambda p, b: lm.loss_fn(p, b, CFG, remat=False), params, batch)
        _, g_chunk = _grads(make_loss_fn(CFG, remat=False), params, batch)
        assert g_dense.keys() == g_chunk.keys()
        for k in g_dense:
            np.testing.assert_allclose(_np(g_dense[k]), _np(g_chunk[k]), rtol=2e-4, atol=2e-5,
                                       err_msg=str(k))


@pytest.mark.parametrize("chunk_len", [7, 32, 256])
def test_chunked_loss_matches_the_references_on_one_hidden_state(chunk_len):
    rng = np.random.default_rng(0)
    h = rng.normal(0, 1, (2, 45, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, (64,)).astype(np.float32)
    head = (rng.normal(0, 1, (64, 512)) * 0.125).astype(np.float32)
    labels = rng.integers(-1, 300, (2, 45)).astype(np.int32)   # some masked, some >= vocab
    cfg = ArchConfig(**dict(FIELDS, vocab=256))
    ours = chunked_lm_loss(*(torch.from_numpy(a) for a in (h, scale, head, labels)), cfg,
                           chunk_len=chunk_len)
    ref = j_chunked(jnp.asarray(h), jnp.asarray(scale), jnp.asarray(head), jnp.asarray(labels),
                    J_CFG, chunk_len=chunk_len)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["test_config", "minicpm3-4b", "zamba2-1.2b", "xlstm-1.3b"])
def test_every_gradient_leaf_matches_jax_grad(which):
    j_cfg, cfg = (J_CFG, CFG) if which == "test_config" else _reduced(which)
    pj, pt = _pair(j_cfg, cfg)
    nb = synth_batch(cfg, SHAPE, 0, DataConfig())
    j_loss, j_grads = jax.value_and_grad(j_make_loss_fn(j_cfg, remat=False))(pj, nb)
    loss, grads = _grads(make_loss_fn(cfg, remat=False), pt, batch_to_device(nb, "cpu"))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    ref = _j_leaves(j_grads)
    assert set(ref) == set(grads)
    for k, g in grads.items():
        assert tuple(g.shape) == tuple(ref[k].shape), k
        np.testing.assert_allclose(_np(g), _np(ref[k]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(k))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "minicpm3-4b", "zamba2-1.2b", "xlstm-1.3b"])
def test_bf16_loss_matches_the_reference_op_by_op(arch):
    j_cfg, cfg = _reduced(arch, "bfloat16")
    pj, pt = _pair(j_cfg, cfg)
    nb = synth_batch(cfg, SHAPE, 0, DataConfig())
    with jax.disable_jit():
        ref = float(j_make_loss_fn(j_cfg, remat=False)(pj, nb))
    ours = float(make_loss_fn(cfg, remat=False)(pt, batch_to_device(nb, "cpu")))
    np.testing.assert_allclose(ours, ref, rtol=TOL["bfloat16"])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "minicpm3-4b", "zamba2-1.2b", "xlstm-1.3b"])
def test_remat_is_bitwise_the_plain_forward(arch):
    cfg = _reduced(arch)[1]
    params, _ = init_train_state(cfg, seed=1, device="cpu")
    batch = _batch(cfg)
    loss_a, ga = _grads(make_loss_fn(cfg, remat=True), params, batch)
    loss_b, gb = _grads(make_loss_fn(cfg, remat=False), params, batch)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


def test_three_train_steps_match_the_references():
    pj, pt = _pair(J_CFG, CFG)
    j_step = jax.jit(j_make_train_step(J_CFG, JAdamWConfig(lr=3e-3, warmup_steps=2)))
    step = make_train_step(CFG, AdamWConfig(lr=3e-3, warmup_steps=2))
    j_opt, opt = j_init_opt(pj), init_opt_state(pt)
    for i in range(3):
        nb = synth_batch(CFG, SHAPE, i, DataConfig())
        pj, j_opt, jm = j_step(pj, j_opt, nb)
        pt, opt, m = step(pt, opt, nb)
        assert int(m["step"]) == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_full_logits_loss_fn_matches_the_references(arch):
    """The hybrid's and the xLSTM's ``loss_fn`` (the full logits' NLL, with
    ``remat``) against the reference's on the same params and batch, f32."""
    j_cfg, cfg = _reduced(arch)
    pj, pt = _pair(j_cfg, cfg)
    nb = synth_batch(cfg, SHAPE, 0, DataConfig())
    ref = float(j_get_model(j_cfg).loss_fn(pj, nb, j_cfg, remat=True))
    ours = get_model(cfg).loss_fn(pt, batch_to_device(nb, "cpu"), cfg, remat=True)
    np.testing.assert_allclose(float(ours), ref, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_three_train_steps_of_the_scan_families_match_the_references(arch):
    """The hybrid and the xLSTM, reduced so that every block runs: three
    steps of the reference's jitted train step and the port's on the same
    params and batches, loss and grad norm at 1e-4."""
    j_cfg, cfg = _reduced(arch)
    pj, pt = _pair(j_cfg, cfg)
    j_step = jax.jit(j_make_train_step(j_cfg, JAdamWConfig(lr=3e-3, warmup_steps=2)))
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2))
    j_opt, opt = j_init_opt(pj), init_opt_state(pt)
    for i in range(3):
        nb = synth_batch(cfg, SHAPE, i, DataConfig())
        pj, j_opt, jm = j_step(pj, j_opt, nb)
        pt, opt, m = step(pt, opt, nb)
        assert int(m["step"]) == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def test_adamw_update_matches_the_references():
    rng = np.random.default_rng(0)
    shapes = {"b": {"w": (3, 5), "a": (4,)}, "e": (2, 2, 3)}
    params_np = tree_map(lambda s: rng.normal(0, 1, s).astype(np.float32), shapes)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2)
    j_cfg = JAdamWConfig(lr=1e-2, warmup_steps=2)
    pj = jax.tree.map(jnp.asarray, params_np)
    pt = tree_map(torch.from_numpy, tree_map(np.copy, params_np))
    j_opt, opt = j_init_opt(pj), init_opt_state(pt)
    for _ in range(3):
        grads_np = tree_map(lambda s: rng.normal(0, 3, s).astype(np.float32), shapes)
        pj, j_opt, j_gnorm = j_adamw(jax.tree.map(jnp.asarray, grads_np), j_opt, pj, j_cfg)
        pt, opt, gnorm = adamw_update(tree_map(torch.from_numpy, grads_np), opt, pt, cfg)
        np.testing.assert_allclose(float(gnorm), float(j_gnorm), rtol=1e-6)
        for tree, ref in ((pt, pj), (opt["m"], j_opt["m"]), (opt["v"], j_opt["v"])):
            j_flat = _j_leaves(ref)
            for path, leaf in leaf_paths(tree):
                np.testing.assert_allclose(_np(leaf), _np(j_flat[path]), rtol=1e-6, atol=1e-7,
                                           err_msg=str(path))
        assert int(opt["step"]) == int(j_opt["step"]) and opt["step"].dtype == torch.int32


class TestOptimizer:
    def test_adamw_moves_toward_minimum(self):
        params = {"w": torch.tensor([3.0, -2.0])}
        opt = init_opt_state(params)
        cfg = AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.0)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, opt, _ = adamw_update(grads, opt, params, cfg)
        assert float(params["w"].abs().max()) < 1e-2

    def test_grad_clip(self):
        params = {"w": torch.zeros(4)}
        opt = init_opt_state(params)
        cfg = AdamWConfig(lr=1.0, warmup_steps=1, grad_clip=1.0, weight_decay=0.0)
        _, _, gnorm = adamw_update({"w": torch.full((4,), 100.0)}, opt, params, cfg)
        assert float(gnorm) == pytest.approx(200.0)

    def test_memorizes_fixed_batch(self):
        params, opt = init_train_state(CFG, device="cpu")
        step = make_train_step(CFG, AdamWConfig(lr=3e-3, warmup_steps=1))
        batch = synth_batch(CFG, SHAPE, 0, DataConfig())
        losses = []
        for _ in range(25):
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 1.0, losses[::6]


# ------------------------------------------------ the kernels' plain backwards

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [((2, 7, 64), 0.0), ((5, 13, 130), 0.0),
                                          ((3, 4, 128), 1.0), ((1, 6, 256), 0.0),
                                          ((2, 768), 0.0)])
def test_rmsnorm_plain_backward_matches_jax_vjp(dtype, shape, offset):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(1, 0.1, shape[-1:]).astype(np.float32)
    dy = rng.normal(0, 1, shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, s: j_rmsnorm(a, s, 1e-6, offset),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    rdx, rdw = vjp(jnp.asarray(dy, jdt))
    dx, dw = rmsnorm_backward_ref(*(torch.from_numpy(a).to(tdt) for a in (dy, x, w)),
                                  1e-6, offset)
    assert dx.dtype == dw.dtype == tdt
    for out, ref in ((dx, rdx), (dw, rdw)):
        ref = _np(ref)
        tol = TOL[dtype]
        atol = tol * float(np.abs(ref).max()) if dtype == "bfloat16" else tol
        np.testing.assert_allclose(_np(out), ref, rtol=tol, atol=atol)


FLASH_CASES = {
    "causal": ((2, 40, 40, 4, 4, 64), dict(causal=True)),
    "full": ((1, 33, 50, 4, 4, 64), dict(causal=False)),
    "gqa2": ((1, 37, 37, 4, 2, 128), dict(causal=True)),
    "gqa4": ((2, 29, 29, 8, 2, 64), dict(causal=True)),
    "window": ((1, 45, 45, 4, 2, 64), dict(causal=True, window=16)),
    "cap": ((1, 30, 30, 4, 4, 64), dict(causal=True, logit_cap=5.0)),
    "offset": ((1, 21, 53, 4, 1, 64), dict(causal=True, q_offset=32)),
    "mla_d96": ((1, 24, 24, 6, 6, 96), dict(causal=True)),
    "ragged_all": ((2, 19, 70, 8, 2, 128), dict(causal=True, q_offset=40, window=24,
                                                logit_cap=20.0)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_backward_matches_jax_vjp(dtype, case):
    (b, sq, sk, hq, hkv, d), kw = FLASH_CASES[case]
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (b, sq, hq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, sk, hkv, d)).astype(np.float32)
    do = rng.normal(0, 1, (b, sq, hq, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, bb, c: j_attention(a, bb, c, **kw),
                     *(jnp.asarray(t, jdt) for t in (q, k, v)))
    refs = vjp(jnp.asarray(do, jdt))
    outs = attention_chunked_backward(*(torch.from_numpy(t).to(tdt) for t in (do, q, k, v)), **kw)
    for name, out, ref in zip("qkv", outs, refs):
        assert out.dtype == tdt and tuple(out.shape) == tuple(ref.shape), name
        ref = _np(ref)
        tol = TOL[dtype]
        atol = tol * float(np.abs(ref).max()) if dtype == "bfloat16" else tol
        np.testing.assert_allclose(_np(out), ref, rtol=tol, atol=atol, err_msg=f"d{name}")


# ------------------------------------------------ the trainer and checkpoints

class TestTrainRestart:
    def test_crash_and_resume_reproduces_stream(self, tmp_path):
        """Train 30 steps with a crash at 20: resumed losses must continue
        from the checkpoint (deterministic data stream + state restore)."""
        from repro_torch.launch import train

        ckpt = str(tmp_path / "ckpt")
        base = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "30", "--batch", "2",
                "--seq", "32", "--log-every", "5", "--device", "cpu"]
        args = base + ["--ckpt-dir", ckpt, "--ckpt-every", "10"]
        crashed = train.main(args + ["--kill-at", "20"])
        assert crashed["crashed_at"] == 20
        assert store.latest_step(ckpt) == 20

        resumed = train.main(args)
        assert resumed["final_loss"] is not None
        straight = train.main(base)
        np.testing.assert_allclose(resumed["final_loss"], straight["final_loss"], rtol=1e-4)


def test_the_port_resumes_the_jax_trainers_checkpoint(tmp_path):
    """The JAX trainer writes step 10 and crashes; the port resumes it to
    20; its losses follow the JAX trainer's straight run.  The dense LM,
    then the hybrid (reduced zamba2: its train state under the nested
    store's names, the tail's Mamba2 layers and the empty group leaves)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    for arch in ("qwen3-0.6b", "zamba2-1.2b"):
        ckpt = str(tmp_path / arch)
        base = ["--arch", arch, "--reduced", "--steps", "20", "--batch", "2", "--seq", "32",
                "--log-every", "5"]
        args = base + ["--ckpt-dir", ckpt, "--ckpt-every", "10"]
        assert jtrain.main(args + ["--kill-at", "10"])["crashed_at"] == 10
        resumed = train.main(args + ["--device", "cpu"])
        straight = dict(jtrain.main(base)["losses"])
        assert [s for s, _ in resumed["losses"]] == [10, 15, 19]
        for s, loss in resumed["losses"]:
            np.testing.assert_allclose(loss, straight[s], rtol=1e-4, err_msg=f"{arch} step {s}")
        # and the reference reads the port's final checkpoint
        pj, _ = jtrain.init_train_state(j_reduced(arch), seed=0)
        state = jstore.restore(ckpt, 20, {"params": pj, "opt": j_init_opt(pj)})
        assert int(state["opt"]["step"]) == 20


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "minicpm3-4b", "zamba2-1.2b", "xlstm-1.3b"])
def test_forward_and_train_step(arch):
    cfg = _reduced(arch)[1]
    model = get_model(cfg)
    shape = ShapeConfig("smoke", 32, 2, "train")
    batch = synth_batch(cfg, shape, 0, DataConfig())
    params, opt_state = init_train_state(cfg, seed=0, device="cpu")

    logits = model.forward(params, batch_to_device(batch, "cpu"), cfg)
    assert tuple(logits.shape) == (2, 32, cfg.padded_vocab)
    assert not bool(torch.isnan(logits).any()), f"{arch}: NaN in forward"

    before = _clone(params)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
    params2, _, metrics = step(params, opt_state, batch)
    assert np.isfinite(float(metrics["loss"])), f"{arch}: non-finite loss"
    assert int(metrics["step"]) == 1
    delta = sum(float((a - b).abs().sum())
                for (_, a), (_, b) in zip(leaf_paths(before), leaf_paths(params2)))
    assert delta > 0, f"{arch}: train step did not update params"


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_a_block_the_config_never_runs_takes_a_zero_gradient(arch):
    """The default reductions run no full group: the hybrid's shared block
    is never read and the xLSTM's group stacks are empty.  The step takes a
    zero gradient for those leaves (AdamW's first moment stays 0 there)
    and a nonzero one for the rest."""
    cfg = get_reduced_config(arch, dtype="float32")
    params, opt_state = init_train_state(cfg, seed=0, device="cpu")
    _, opt_state, metrics = make_train_step(cfg, AdamWConfig(warmup_steps=1))(
        params, opt_state, _batch(cfg, ShapeConfig("t", 32, 2, "train")))
    assert np.isfinite(float(metrics["loss"]))
    idle = getattr(get_model(cfg), "idle_params", lambda cfg: ())(cfg)
    for path, m in leaf_paths(opt_state["m"]):
        if m.numel():
            assert bool(m.any()) != (path[0] in idle), "/".join(path)


def test_a_parameter_the_loss_never_reads_raises():
    params, _ = init_train_state(CFG, seed=0, device="cpu")
    params["stray"] = torch.zeros((3,))
    with pytest.raises(RuntimeError, match="stray"):
        make_train_step(CFG)(params, init_opt_state(params), _batch())


def test_nested_store_names_are_the_references(tmp_path):
    """A nested dict's leaves are named as ``jax.tree_util.keystr`` names
    them, a flat dict's stay ``['key']``; each package restores the other's
    nested checkpoint."""
    import json
    import os

    rng = np.random.default_rng(3)
    tree = {"params": {"blocks": {"sub0": {"wq": rng.normal(0, 1, (2, 3)).astype(np.float32)}},
                       "embed": rng.normal(0, 1, (4, 2)).astype(np.float32)},
            "opt": {"step": np.asarray(5, np.int32)}}
    ours = tree_map(torch.from_numpy, tree)
    store.save(str(tmp_path / "p"), 1, ours)
    jstore.save(str(tmp_path / "j"), 1, jax.tree.map(jnp.asarray, tree))
    names = {}
    for who in ("p", "j"):
        with open(os.path.join(tmp_path, who, "step_00000001", "manifest.json")) as f:
            names[who] = set(json.load(f)["leaves"])
    assert names["p"] == names["j"] == {
        "['params']['blocks']['sub0']['wq']", "['params']['embed']", "['opt']['step']"}
    back = store.restore(str(tmp_path / "j"), 1, ours)
    j_back = jstore.restore(str(tmp_path / "p"), 1, jax.tree.map(jnp.asarray, tree))
    for (path, leaf), (_, ref) in zip(leaf_paths(back), leaf_paths(ours)):
        assert leaf.dtype == ref.dtype and torch.equal(leaf, ref), path
    for path, leaf in _j_leaves(j_back).items():
        ref = tree
        for k in path:
            ref = ref[k]
        assert np.array_equal(np.asarray(leaf), ref), path
    flat = {"a": torch.zeros(2), "b.c": torch.ones(3)}
    store.save(str(tmp_path / "f"), 2, flat)
    with open(os.path.join(tmp_path, "f", "step_00000002", "manifest.json")) as f:
        assert set(json.load(f)["leaves"]) == {"['a']", "['b.c']"}
    assert set(store.load_flat(str(tmp_path / "f"), 2)) == {"a", "b.c"}


def test_nested_restore_checks_shapes_and_names(tmp_path):
    tree = {"p": {"w": torch.zeros(2, 3)}, "s": torch.tensor(1, dtype=torch.int32)}
    store.save(str(tmp_path), 1, tree)
    out = store.restore(str(tmp_path), 1, tree)
    assert out.keys() == tree.keys() and torch.equal(out["p"]["w"], tree["p"]["w"])
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(str(tmp_path), 1, {"p": {"w": torch.zeros(3, 2)}})
    with pytest.raises(KeyError, match="missing leaf"):
        store.restore(str(tmp_path), 1, {"p": {"x": torch.zeros(2, 3)}})


def test_train_state_round_trips_through_the_store(tmp_path):
    cfg = get_reduced_config("minicpm3-4b")
    params, opt = init_train_state(cfg, seed=2, device="cpu")
    params, opt, _ = make_train_step(cfg)(params, opt, synth_batch(cfg, SHAPE, 0, DataConfig()))
    store.save(str(tmp_path), 1, {"params": params, "opt": opt})
    blank_p, blank_o = init_train_state(cfg, seed=3, device="cpu")
    back = store.restore(str(tmp_path), 1, {"params": blank_p, "opt": blank_o})
    for (path, a), (_, b) in zip(leaf_paths({"params": params, "opt": opt}), leaf_paths(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
