"""Whisper-style encoder-decoder (arXiv:2212.04356), transformer backbone
only (``repro.models.encdec``, its partition specs too): the conv audio
frontend is a stub, so the caller feeds precomputed frame embeddings
(B, enc_seq, D).

Encoder: bidirectional self-attention over the frames (learned positions
added to the input, and RoPE inside the attention, as the reference applies
both).  Decoder: causal self-attention, then cross-attention to the
encoder's output, then the MLP.  Norms are RMSNorm, as in the reference.

Parameters keep the reference's layout: ``encoder`` and ``decoder`` stacks
with a leading layer axis, dense weights (in, out).  The cache is
``{"cross": {"k", "v"}, "self": {"k", "v"}}`` with (dec_layers, B, S, H, D)
leaves, in the reference's leaf order; the self cache is capped at
``max_target_positions`` and the cross cache holds the encoder's K and V
(zeros from ``init_cache``).  The reference's ``lax.scan``s are Python
loops here, so a traced step holds every layer's operators.

API (as ``models/lm.py``):
    init_params(cfg, seed, device)             -> params dict
    param_specs(cfg)                           -> same-structure PartitionSpec dict
    encode(params, frames, cfg)                -> (B, enc_seq, D)
    forward(params, batch, cfg, remat=, return_hidden=) -> logits or hidden
    head_weights(params, cfg)                  -> the LM head
    loss_fn(params, batch, cfg, remat=)        -> mean next-token NLL
    init_cache(cfg, batch, max_seq, device)    -> decode cache dict
    cache_specs(cfg, batch, dp_size)           -> PartitionSpec dict of the cache
    prefill(params, batch, cfg, max_seq)       -> (last logits, cache)
    decode_step(params, token, cache, pos, cfg) -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import tree_map_specs
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.layers.attention import (
    attn_decode_step,
    attn_forward,
    attn_init,
    attn_specs,
    init_kv_cache,
    prefill_kv_cache,
)
from repro_torch.layers.common import (
    dense,
    dense_init,
    layer_params,
    layer_slice,
    stack_layers,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init, mlp_specs
from repro_torch.models.lm import kv_spec, next_token_nll

# the self cache holds a row per position of the bucket
CACHE_PER_POSITION = True


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# -- cross attention ---------------------------------------------------------

def cross_attn_init(gen: torch.Generator, cfg: ArchConfig, dtype, layers: int):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    return {
        "wq": dense_init(gen, d, h * dh, dtype, layers=layers),
        "wk": dense_init(gen, d, h * dh, dtype, layers=layers),
        "wv": dense_init(gen, d, h * dh, dtype, layers=layers),
        "wo": dense_init(gen, h * dh, d, dtype, layers=layers),
    }


def cross_attn_apply(p, x: torch.Tensor, enc_kv, cfg: ArchConfig) -> torch.Tensor:
    """x (B, Sd, D) queries against the encoder's K/V (B, Se, H, dh), no mask."""
    b, s, _ = x.shape
    q = dense(x, p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    out = flash_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return dense(out.reshape(b, s, -1), p["wo"])


def cross_kv(p, enc_out: torch.Tensor, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    b, se, _ = enc_out.shape
    h, dh = cfg.n_heads, cfg.d_head
    return {
        "k": dense(enc_out, p["wk"]).reshape(b, se, h, dh),
        "v": dense(enc_out, p["wv"]).reshape(b, se, h, dh),
    }


# -- layers ------------------------------------------------------------------

def _ones(cfg: ArchConfig, layers: int, dtype, dev) -> torch.Tensor:
    return torch.ones((layers, cfg.d_model), dtype=dtype, device=dev)


def _enc_layers_init(gen, cfg: ArchConfig, dtype):
    n, dev = cfg.enc_layers, gen.device
    return {
        "attn_norm": _ones(cfg, n, dtype, dev),
        "attn": attn_init(gen, cfg, dtype, n),
        "mlp_norm": _ones(cfg, n, dtype, dev),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, n),
    }


def _dec_layers_init(gen, cfg: ArchConfig, dtype):
    n, dev = cfg.dec_layers, gen.device
    return {
        "self_norm": _ones(cfg, n, dtype, dev),
        "self_attn": attn_init(gen, cfg, dtype, n),
        "cross_norm": _ones(cfg, n, dtype, dev),
        "cross_attn": cross_attn_init(gen, cfg, dtype, n),
        "mlp_norm": _ones(cfg, n, dtype, dev),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, n),
    }


def _enc_layer(lp, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    hn = rmsnorm(x, lp["attn_norm"], eps=cfg.norm_eps)
    x = x + attn_forward(lp["attn"], hn, cfg, causal=False)
    hn = rmsnorm(x, lp["mlp_norm"], eps=cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], hn)


def _dec_layer(lp, x: torch.Tensor, enc_out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    hn = rmsnorm(x, lp["self_norm"], eps=cfg.norm_eps)
    x = x + attn_forward(lp["self_attn"], hn, cfg, causal=True)
    hn = rmsnorm(x, lp["cross_norm"], eps=cfg.norm_eps)
    kv = cross_kv(lp["cross_attn"], enc_out, cfg)
    x = x + cross_attn_apply(lp["cross_attn"], hn, kv, cfg)
    hn = rmsnorm(x, lp["mlp_norm"], eps=cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], hn)


def _run(fn, remat: bool, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# -- model -------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: int = 0, device: Any = "cuda") -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = _dtype(cfg)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    return {
        "embed": normal((cfg.padded_vocab, cfg.d_model), cfg.d_model ** -0.5),
        "enc_pos": normal((cfg.enc_seq, cfg.d_model), 0.02),
        "dec_pos": normal((cfg.max_target_positions, cfg.d_model), 0.02),
        "encoder": _enc_layers_init(gen, cfg, dtype),
        "decoder": _dec_layers_init(gen, cfg, dtype),
        "enc_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
    }


def head_weights(params, cfg: ArchConfig) -> torch.Tensor:
    return params["lm_head"]


def encode(params, frames: torch.Tensor, cfg: ArchConfig, *, remat: bool = False):
    """frames (B, enc_seq, D): precomputed embeddings (the frontend stub)."""
    h = frames.to(_dtype(cfg)) + params["enc_pos"][None]
    layer = layer_params(params["encoder"])
    for i in range(cfg.enc_layers):
        h = _run(_enc_layer, remat, layer(i), h, cfg)
    return rmsnorm(h, params["enc_norm"], eps=cfg.norm_eps)


def cross_attn_specs() -> Dict[str, P]:
    return {"wq": P(None, "tp"), "wk": P(None, "tp"), "wv": P(None, "tp"), "wo": P("tp", None)}


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    enc = {"attn_norm": P(None), "attn": attn_specs(cfg), "mlp_norm": P(None),
           "mlp": mlp_specs()}
    dec = {"self_norm": P(None), "self_attn": attn_specs(cfg), "cross_norm": P(None),
           "cross_attn": cross_attn_specs(), "mlp_norm": P(None), "mlp": mlp_specs()}
    return {
        "embed": P("tp", None),
        "enc_pos": P(None, None),
        "dec_pos": P(None, None),
        "encoder": tree_map_specs(lambda s: P(None, *s), enc),
        "decoder": tree_map_specs(lambda s: P(None, *s), dec),
        "enc_norm": P(None),
        "final_norm": P(None),
        "lm_head": P(None, "tp"),
    }


def _logits(params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], eps=cfg.norm_eps)
    return dense(h, params["lm_head"]).float()


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens] + params["dec_pos"][None, : tokens.shape[1]]


def decode_train(params, enc_out: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig, *,
                 remat: bool = False, return_hidden: bool = False) -> torch.Tensor:
    h = _embed(params, tokens)
    layer = layer_params(params["decoder"])
    for i in range(cfg.dec_layers):
        h = _run(_dec_layer, remat, layer(i), h, enc_out, cfg)
    if return_hidden:
        return h
    return _logits(params, h, cfg)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = False, return_hidden: bool = False) -> torch.Tensor:
    """batch: {"frames": (B, enc_seq, D), "tokens": (B, S) int}.  ``remat``
    checkpoints each encoder and decoder layer (the reference runs its scans
    without ``jax.checkpoint``; the values are the same either way);
    ``return_hidden`` returns the decoder's (B, S, D) output before the
    final norm."""
    enc_out = encode(params, batch["frames"], cfg, remat=remat)
    return decode_train(params, enc_out, batch["tokens"], cfg, remat=remat,
                        return_hidden=return_hidden)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *, remat: bool = True):
    return next_token_nll(forward(params, batch, cfg, remat=remat), batch["labels"], cfg)


# -- serving -----------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device: Any = "cuda"):
    max_seq = min(max_seq, cfg.max_target_positions)
    dtype, dev, n = _dtype(cfg), resolve_device(device), cfg.dec_layers
    self_kv = init_kv_cache(cfg, batch, max_seq, dtype, dev)
    cross = (n, batch, cfg.enc_seq, cfg.n_heads, cfg.d_head)
    return {
        "cross": {"k": torch.zeros(cross, dtype=dtype, device=dev),
                  "v": torch.zeros(cross, dtype=dtype, device=dev)},
        "self": {k: t[None].expand(n, *t.shape).contiguous() for k, t in self_kv.items()},
    }


def cache_specs(cfg: ArchConfig, batch: int, dp_size: int = 16) -> Dict[str, Any]:
    spec = kv_spec(cfg, batch, dp_size)
    return {"cross": {"k": spec, "v": spec}, "self": {"k": spec, "v": spec}}


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, max_seq: int):
    """Encode the frames, fill each decoder layer's cross K/V, and run the
    decoder prompt to fill the self cache; returns (last logits, cache)."""
    max_seq = min(max_seq, cfg.max_target_positions)
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    x = _embed(params, tokens)
    pad = max_seq - tokens.shape[1]
    selfs, crosses = [], []
    for i in range(cfg.dec_layers):
        lp = layer_slice(params["decoder"], i)
        hn = rmsnorm(x, lp["self_norm"], eps=cfg.norm_eps)
        a, (k, v) = attn_forward(lp["self_attn"], hn, cfg, causal=True, return_kv=True)
        x = x + a
        selfs.append(prefill_kv_cache(cfg, k, v, pad))
        hn = rmsnorm(x, lp["cross_norm"], eps=cfg.norm_eps)
        ckv = cross_kv(lp["cross_attn"], enc_out, cfg)
        crosses.append(ckv)
        x = x + cross_attn_apply(lp["cross_attn"], hn, ckv, cfg)
        hn = rmsnorm(x, lp["mlp_norm"], eps=cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], hn)
    logits = _logits(params, x[:, -1:].contiguous(), cfg)
    return logits, {"cross": stack_layers(crosses), "self": stack_layers(selfs)}


def decode_step(params, token: torch.Tensor, cache, pos: torch.Tensor, cfg: ArchConfig):
    """One decode step.  token (B, 1) int32; pos 0-d int32 (current length).
    The learned position is read at ``pos`` clamped to the table (the
    reference's ``dynamic_slice_in_dim``) with a tensor index, so a traced
    step holds at every position.  The cross cache is read, never written,
    and returned as it came."""
    b = token.shape[0]
    row = pos.reshape(1).long().clamp(0, cfg.max_target_positions - 1)
    x = params["embed"][token] + params["dec_pos"].index_select(0, row)[None]
    enc_len = torch.full((b,), cfg.enc_seq, dtype=torch.int32, device=x.device)
    selfs = []
    for i in range(cfg.dec_layers):
        lp = layer_slice(params["decoder"], i)
        lc = layer_slice(cache, i)
        hn = rmsnorm(x, lp["self_norm"], eps=cfg.norm_eps)
        a, self_new = attn_decode_step(lp["self_attn"], hn, lc["self"], pos, cfg)
        selfs.append(self_new)
        x = x + a
        hn = rmsnorm(x, lp["cross_norm"], eps=cfg.norm_eps)
        q = dense(hn, lp["cross_attn"]["wq"]).reshape(b, cfg.n_heads, cfg.d_head)
        c = decode_attention(q, lc["cross"]["k"], lc["cross"]["v"], enc_len)
        x = x + dense(c.reshape(b, 1, -1), lp["cross_attn"]["wo"])
        hn = rmsnorm(x, lp["mlp_norm"], eps=cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], hn)
    return _logits(params, x, cfg), {"cross": cache["cross"], "self": stack_layers(selfs)}
