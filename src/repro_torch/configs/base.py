"""Architecture config schema of the ported families, and the reduced variant
the CPU tests run.  An own copy of ``repro.configs.base``: the fields the
dense GQA decoder and the Mamba2 hybrid read, with the same names and
defaults, so a config built here describes the same model as its JAX
counterpart."""
from __future__ import annotations

import dataclasses
from typing import Optional

VOCAB_PAD = 512  # vocab padded to a multiple of this (same rule as the reference)


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | hybrid (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int = 128
    d_ff: int = 0
    vocab: int = 32000

    # attention
    qk_norm: bool = False
    window: Optional[int] = None    # sliding-window attention
    rope_theta: float = 1e6

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0             # zamba2: shared attn after every k blocks

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab, VOCAB_PAD)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Small same-family variant for CPU tests (the reference's rule for the
    dense and SSM families)."""
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads // max(1, cfg.n_heads // 4))),
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        dtype="float32",
    )
    if cfg.ssm_state:
        base.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.window:
        base.update(window=32)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
