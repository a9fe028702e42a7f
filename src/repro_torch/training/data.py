"""Synthetic deterministic data pipeline (``repro.training.data``, numpy
only, so its batches are the reference's bit for bit).

Each batch is a pure function of (seed, step, process), so a restarted run
regenerates the exact stream without coordination.  The port's configs are
decoder-only LMs: the reference's encoder frames and vision patches belong
to families not ported yet (ROADMAP A9), so a batch is tokens and their
next-token labels.
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
    set to -1 (masked by the loss)."""
    b = shape.global_batch // dc.process_count
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, dc.process_index])
    )
    tokens = rng.integers(0, cfg.vocab, (b, shape.seq_len)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def data_stream(
    cfg: ArchConfig, shape: ShapeConfig, dc: Optional[DataConfig] = None,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    dc = dc or DataConfig()
    step = start_step
    while True:
        yield synth_batch(cfg, shape, step, dc)
        step += 1
