"""Model registry: maps an ArchConfig to its family module."""
from __future__ import annotations

import types

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid, lm


def get_model(cfg: ArchConfig) -> types.ModuleType:
    if cfg.attn_every:
        return hybrid
    if cfg.family == "dense":
        return lm
    raise NotImplementedError(f"family {cfg.family!r} is not ported")
