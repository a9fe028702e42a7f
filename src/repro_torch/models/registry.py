"""Model registry: maps an ArchConfig to its family module, in the
reference's order (a shared attention block -> the hybrid, an sLSTM period
-> the xLSTM LM, dense or MoE -> the decoder LM, GQA or MLA).  The audio and
VLM families are not ported."""
from __future__ import annotations

import types

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid, lm, xlstm_lm


def get_model(cfg: ArchConfig) -> types.ModuleType:
    if cfg.attn_every:
        return hybrid
    if cfg.slstm_every:
        return xlstm_lm
    if cfg.family in ("dense", "moe"):
        return lm
    raise NotImplementedError(f"family {cfg.family!r} is not ported")
