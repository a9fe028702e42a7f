"""Model registry: maps an ArchConfig to its family module, in the
reference's order (an encoder-decoder -> ``encdec``, a shared attention
block -> the hybrid, an sLSTM period -> the xLSTM LM, anything else -> the
decoder LM: dense or MoE, GQA or MLA, with or without a patch prefix)."""
from __future__ import annotations

import types

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, hybrid, lm, xlstm_lm


def get_model(cfg: ArchConfig) -> types.ModuleType:
    if cfg.is_encoder_decoder:
        return encdec
    if cfg.attn_every:
        return hybrid
    if cfg.slstm_every:
        return xlstm_lm
    return lm
