"""Architecture config schema of the ported families, and the reduced variant
the CPU tests run.  An own copy of ``repro.configs.base``: the fields the
dense and MoE decoder (GQA or MLA attention), the Mamba2 hybrid, the xLSTM
LM, the whisper encoder-decoder and the llava patch-prefix LM read, and the
int8 KV cache's ``kv_cache_bits``, the sharding knobs (``moe_groups``,
``disable_tp``, ``encoder_sp``, ``sp_decode``) and ``skip_shapes``, with the
same names and defaults, so a config built here describes the same model as
its JAX counterpart; and the four assigned input ``SHAPES``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOCAB_PAD = 512  # vocab padded to a multiple of this (same rule as the reference)


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int = 128
    d_ff: int = 0
    vocab: int = 32000

    # attention
    attn_kind: str = "gqa"          # gqa | mla
    qk_norm: bool = False
    window: Optional[int] = None    # sliding-window attention
    rope_theta: float = 1e6

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1              # every k-th layer is MoE (k=1: all)
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25

    # MLA
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid / xLSTM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0             # zamba2: shared attn after every k blocks
    slstm_every: int = 0            # xlstm: sLSTM every k blocks
    slstm_ff: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    enc_seq: int = 0
    max_target_positions: int = 0

    # VLM
    num_patches: int = 0

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # performance knobs (the reference's hillclimb variants; defaults are the
    # baseline).  The sharded paths they select run only under a live mesh.
    # ``disable_tp`` and ``encoder_sp`` are kept for parity with the
    # reference's configs and read by nothing in the port: the reference reads
    # them only in its dry-run layouts (``disable_tp``) and in a GSPMD layout
    # constraint on encoder activations (``encoder_sp``), and a rank-local
    # activation needs no such constraint
    moe_groups: int = 0             # >0: shard-local MoE dispatch (layers/moe.py)
    disable_tp: bool = False        # replicate params (drop "tp"): small models
    kv_cache_bits: int = 16         # 8: int8 K/V cache with per-(position, head) f32 scales
    encoder_sp: bool = False        # shard encoder activations over tp on seq
    sp_decode: bool = False         # sequence-parallel decode over the tp-sharded KV seq

    # which of the four assigned shapes apply
    skip_shapes: Tuple[str, ...] = ()

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab, VOCAB_PAD)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.enc_layers > 0

    def moe_layer(self, layer_idx: int) -> bool:
        if self.moe_experts == 0:
            return False
        return (layer_idx + 1) % self.moe_every == 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Small same-family variant for CPU tests (the reference's rule for
    every family)."""
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
    if cfg.moe_experts:
        # random-init routers are unbalanced; a high capacity factor keeps the
        # reduced configs drop-free so decode == forward exactly
        base.update(
            moe_experts=4, moe_top_k=min(2, cfg.moe_top_k), capacity_factor=8.0
        )
    if cfg.q_lora:
        base.update(q_lora=32, kv_lora=16, rope_head_dim=8, nope_head_dim=8,
                    v_head_dim=16, d_head=16)
    if cfg.ssm_state:
        base.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.slstm_ff:
        base.update(slstm_ff=128)
    if cfg.enc_layers:
        base.update(enc_layers=2, dec_layers=2, enc_seq=32,
                    max_target_positions=64, n_layers=2)
    if cfg.num_patches:
        base.update(num_patches=16)
    if cfg.window:
        base.update(window=32)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
