"""tests/test_arch_smoke.py on the port, over all of its archs (the
reference's ten): each reduced config runs one forward and one train step
on the CPU (output shapes, no NaN, the parameters move) and round-trips
prefill -> decode against the full forward, with the reference's batch
shapes and tolerances (an encoder-decoder's batch holds frames, a VLM's
patches; the VLM decodes at ``s + num_patches``).  Also ``synth_batch``
bitwise the reference's for the encoder-decoder and the VLM families."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import CONFIGS as J_CONFIGS  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro_torch.configs import CONFIGS, get_reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.training.data import DataConfig, synth_batch  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.step import batch_to_device, init_train_state, make_train_step  # noqa: E402

ARCHS = sorted(CONFIGS)


def test_the_port_has_every_arch_of_the_reference():
    assert ARCHS == sorted(J_CONFIGS) and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    cfg = get_reduced_config(arch)
    model = get_model(cfg)
    shape = ShapeConfig("smoke", 32, 2, "train")
    batch = synth_batch(cfg, shape, 0, DataConfig())
    params, opt_state = init_train_state(cfg, seed=0, device="cpu")

    with torch.no_grad():
        logits = model.forward(params, batch_to_device(batch, "cpu"), cfg)
    b, s_expect = batch["tokens"].shape
    assert tuple(logits.shape) == (b, s_expect, cfg.padded_vocab)
    assert not bool(torch.isnan(logits).any()), f"{arch}: NaN in forward"

    before = [t.clone() for t in torch.utils._pytree.tree_leaves(params)]
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
    params2, _, metrics = step(params, opt_state, batch)
    assert np.isfinite(float(metrics["loss"])), f"{arch}: non-finite loss"
    assert int(metrics["step"]) == 1
    delta = sum(float((a - b).abs().sum())
                for a, b in zip(before, torch.utils._pytree.tree_leaves(params2)))
    assert delta > 0, f"{arch}: train step did not update params"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_roundtrip(arch):
    cfg = get_reduced_config(arch)
    model = get_model(cfg)
    rng = np.random.default_rng(0)
    b, s = 2, 12
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(
            rng.normal(0, 1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.num_patches:
        batch["patches"] = torch.from_numpy(
            rng.normal(0, 1, (b, cfg.num_patches, cfg.d_model)).astype(np.float32))
    params = model.init_params(cfg, seed=0, device="cpu")
    with torch.no_grad():
        full = model.forward(params, batch, cfg)
        pl, cache = model.prefill(params, batch, cfg, 32)
        np.testing.assert_allclose(pl[:, 0].numpy(), full[:, -1].numpy(), rtol=5e-3, atol=5e-3,
                                   err_msg=f"{arch}: prefill != forward")
        nxt = torch.argmax(pl[:, 0, : cfg.vocab], -1).to(torch.int32)[:, None]
        pos = s + cfg.num_patches if cfg.num_patches else s
        d, _ = model.decode_step(params, nxt, cache, torch.tensor(pos, dtype=torch.int32), cfg)
        ext = {**batch, "tokens": torch.cat([batch["tokens"], nxt], dim=1)}
        full2 = model.forward(params, ext, cfg)
    np.testing.assert_allclose(d[:, 0].numpy(), full2[:, -1].numpy(), rtol=8e-3, atol=8e-3,
                               err_msg=f"{arch}: decode != extended forward")


@pytest.mark.parametrize("seq", [32, 100])
@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_synth_batch_is_the_references_bitwise(arch, seq):
    """Frames or patches drawn before the tokens with the same generator
    calls; the decoder capped at ``max_target_positions`` (64 reduced), the
    VLM's text ``max(1, S - num_patches)`` long."""
    cfg, cfg_j = get_reduced_config(arch), j_reduced(arch)
    for step, dc in ((0, {}), (5, dict(seed=3, process_index=1, process_count=2))):
        ours = synth_batch(cfg, ShapeConfig("t", seq, 4, "train"), step, DataConfig(**dc))
        ref = jdata.synth_batch(cfg_j, JShapeConfig("t", seq, 4, "train"), step,
                                jdata.DataConfig(**dc))
        assert list(ours) == list(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
