"""Model registry: maps an ArchConfig to its family module, in the
reference's order (an encoder-decoder -> ``encdec``, a shared attention
block -> the hybrid, an sLSTM period -> the xLSTM LM, anything else -> the
decoder LM: dense or MoE, GQA or MLA, with or without a patch prefix), and
the shape stand-ins of every (arch x assigned shape) cell.

The stand-ins are meta tensors: shape and dtype, no storage.  The
parameters' come from the family's ``init_params`` run under a
``FakeTensorMode``, so llama4-maverick's 400 B parameters allocate nothing.
"""
from __future__ import annotations

import math
import types
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, lm, xlstm_lm
from repro_torch.training.optimizer import leaf_paths, tree_map


def get_model(cfg: ArchConfig) -> types.ModuleType:
    if cfg.is_encoder_decoder:
        return encdec
    if cfg.attn_every:
        return hybrid
    if cfg.slstm_every:
        return xlstm_lm
    return lm


def shape_applies(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    return shape.name not in cfg.skip_shapes


def effective_lengths(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, int]:
    """Per-arch effective sequence lengths for a nominal shape (whisper's
    decoder is capped at max_target_positions; its encoder is fixed 1500)."""
    seq = shape.seq_len
    if cfg.is_encoder_decoder:
        dec = min(seq, cfg.max_target_positions)
        return {"seq": dec, "enc_seq": cfg.enc_seq, "nominal": seq}
    return {"seq": seq, "nominal": seq}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for a *training / prefill* batch."""
    b = shape.global_batch
    s = effective_lengths(cfg, shape)["seq"]
    act = getattr(torch, cfg.dtype)
    specs: Dict[str, torch.Tensor] = {}
    if cfg.is_encoder_decoder:
        specs["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), act)
        specs["tokens"] = _meta((b, s), torch.int32)
    elif cfg.num_patches:
        specs["patches"] = _meta((b, cfg.num_patches, cfg.d_model), act)
        specs["tokens"] = _meta((b, max(1, s - cfg.num_patches)), torch.int32)
    else:
        specs["tokens"] = _meta((b, s), torch.int32)
    if shape.kind == "train":
        # labels align with the text positions the LM predicts
        specs["labels"] = _meta(specs["tokens"].shape, torch.int32)
    return specs


def decode_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(token, cache, pos) meta stand-ins of a serve step."""
    b = shape.global_batch
    max_seq = effective_lengths(cfg, shape)["seq"]
    token = _meta((b, 1), torch.int32)
    cache = get_model(cfg).init_cache(cfg, b, max_seq, "meta")
    return token, cache, _meta((), torch.int32)


def params_shape(cfg: ArchConfig) -> Dict[str, Any]:
    """Meta tensors of every parameter, in the family's tree."""
    with FakeTensorMode():
        fake = get_model(cfg).init_params(cfg, 0, "cpu")
    return tree_map(lambda t: _meta(t.shape, t.dtype), fake)


def _leaves(tree):
    return [leaf for _, leaf in leaf_paths(tree)]


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(leaf.shape) for leaf in _leaves(params_shape(cfg)))


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top_k of the expert stack + the rest)."""
    total = param_count(cfg)
    if not cfg.moe_experts:
        return total
    expert_leaves = 0
    for leaf in _leaves(params_shape(cfg)):
        # stacked expert weights: (n_superblocks, E, d_in, d_out)
        if leaf.ndim == 4 and leaf.shape[1] == cfg.moe_experts:
            expert_leaves += math.prod(leaf.shape)
    inactive = expert_leaves * (1 - cfg.moe_top_k / cfg.moe_experts)
    return int(total - inactive)
