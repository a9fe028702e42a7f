"""Model registry: maps an ArchConfig to its family module."""
from __future__ import annotations

import types

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def get_model(cfg: ArchConfig) -> types.ModuleType:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    return lm
