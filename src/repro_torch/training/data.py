"""Synthetic deterministic data pipeline (``repro.training.data``, numpy
only, so its batches are the reference's bit for bit).

Each batch is a pure function of (seed, step, process), so a restarted run
regenerates the exact stream without coordination.  A batch is tokens and
their next-token labels; an encoder-decoder's also holds its encoder frames
(the decoder length capped at ``max_target_positions``), a VLM's its patch
embeddings (the text shortened by the patch count), drawn as the reference
draws them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    process_index: int = 0
    process_count: int = 1


def synth_batch(cfg: ArchConfig, shape: ShapeConfig, step: int, dc: DataConfig) -> Dict[str, np.ndarray]:
    """Batch for one step (the full global batch, or this process's shard):
    int32 tokens (B, S) and labels, the tokens rolled by one with the last
    set to -1 (masked by the loss); f32 ``frames`` (B, enc_seq, D) for an
    encoder-decoder, f32 ``patches`` (B, num_patches, D) for a VLM, whose
    text is then ``max(1, S - num_patches)`` long."""
    b = shape.global_batch // dc.process_count
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, dc.process_index])
    )
    s = shape.seq_len
    out: Dict[str, np.ndarray] = {}
    if cfg.is_encoder_decoder:
        s = min(s, cfg.max_target_positions)
        out["frames"] = rng.normal(0, 1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        out["patches"] = rng.normal(0, 1, (b, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
        s = max(1, s - cfg.num_patches)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    out["tokens"] = tokens
    out["labels"] = labels
    return out


def data_stream(
    cfg: ArchConfig, shape: ShapeConfig, dc: Optional[DataConfig] = None,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    dc = dc or DataConfig()
    step = start_step
    while True:
        yield synth_batch(cfg, shape, step, dc)
        step += 1
