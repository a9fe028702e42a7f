"""Decoder-only LM (the qwen3 family, minicpm3's MLA attention, the MoE
family: mixtral-8x7b, llama4-maverick, and the llava VLM, whose stubbed
vision tower's ``num_patches`` patch embeddings are prepended to the text):
``repro.models.lm``, with its partition specs.

Layers are grouped into super-blocks of ``moe_every`` layers (dense layers,
then one MoE layer; one layer when ``moe_every == 1``), so an interleaved
dense/MoE stack keeps one parameter structure per position in the block.
Parameters keep the reference's layout so conversion is a dtype move: dense
weights are (in, out); layer j of a super-block lives at ``blocks/sub{j}/...``
with a leading super-block axis (a MoE layer's expert stacks are
(n_sb, E, d_in, d_out), its router f32); the KV cache is
``{"sub{j}": {"k": (n_sb,B,S,Hkv,D), "v": ...}}`` (with ``kv_cache_bits ==
8``: int8 ``k``, ``v`` and their f32 scales ``ks``, ``vs`` of
(n_sb,B,S,Hkv), in the order k, ks, v, vs), and with
``attn_kind == "mla"`` the latent cache
``{"sub0": {"c_kv": (L,B,S,kv_lora), "k_rope": (L,B,S,rope)}}``.
The reference runs the stack as one ``lax.scan`` over super-blocks; here it
is a Python loop, so a traced step holds every layer's operators.

API:
    init_params(cfg, seed, device)             -> params dict
    param_specs(cfg)                           -> same-structure PartitionSpec dict
    forward(params, batch, cfg, remat=, return_hidden=) -> logits or hidden
    loss_fn(params, batch, cfg, remat=)        -> mean next-token NLL
    init_cache(cfg, batch, max_seq, device)    -> decode cache dict
    cache_specs(cfg, batch, dp_size)           -> PartitionSpec dict of the cache
    prefill(params, batch, cfg, max_seq)       -> (last logits, cache)
    decode_step(params, token, cache, pos, cfg) -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import tree_map_specs
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
from repro_torch.layers.mla import (
    init_mla_cache,
    mla_decode_step,
    mla_forward,
    mla_init,
    mla_specs,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init, mlp_specs
from repro_torch.layers.moe import moe_apply, moe_init, moe_specs

# the decode cache holds a row per position of the bucket (the serving engine
# checks a generation against it)
CACHE_PER_POSITION = True


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _mla(cfg: ArchConfig) -> bool:
    return cfg.attn_kind == "mla"


def _subs(cfg: ArchConfig):
    """The super-block's layer names, with whether each is a MoE layer."""
    return [(f"sub{j}", cfg.moe_layer(j)) for j in range(cfg.moe_every)]


def _n_superblocks(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.moe_every:
        raise ValueError(f"{cfg.n_layers} layers are not whole super-blocks of "
                         f"{cfg.moe_every}")
    return cfg.n_layers // cfg.moe_every


def _ffn(lp, h, cfg: ArchConfig, moe: bool) -> torch.Tensor:
    return moe_apply(lp["ffn"], h, cfg) if moe else mlp_apply(lp["ffn"], h)


def _layer_forward(lp, x, cfg: ArchConfig, moe: bool, positions):
    h = rmsnorm(x, lp["attn_norm"], eps=cfg.norm_eps)
    attend = mla_forward if _mla(cfg) else attn_forward
    x = x + attend(lp["attn"], h, cfg, positions=positions)
    h = rmsnorm(x, lp["mlp_norm"], eps=cfg.norm_eps)
    return x + _ffn(lp, h, cfg, moe)


def init_params(cfg: ArchConfig, seed: int = 0, device: Any = "cuda") -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = _dtype(cfg)
    n = _n_superblocks(cfg)
    embed = torch.randn(
        (cfg.padded_vocab, cfg.d_model), generator=gen, device=dev
    ) * cfg.d_model ** -0.5
    blocks = {}
    for sub, moe in _subs(cfg):
        blocks[sub] = {
            "attn_norm": torch.ones((n, cfg.d_model), dtype=dtype, device=dev),
            "mlp_norm": torch.ones((n, cfg.d_model), dtype=dtype, device=dev),
            "attn": (mla_init if _mla(cfg) else attn_init)(gen, cfg, dtype, n),
            "ffn": (moe_init(gen, cfg, dtype, n) if moe
                    else mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, n)),
        }
    p = {
        "embed": embed.to(dtype),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype)
    return p


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's layout of every parameter, with the super-block
    axis (unsharded) in front of every block leaf."""
    blocks = {}
    for sub, moe in _subs(cfg):
        blocks[sub] = tree_map_specs(lambda s: P(None, *s), {
            "attn_norm": P(None),
            "mlp_norm": P(None),
            "attn": mla_specs(cfg) if _mla(cfg) else attn_specs(cfg),
            "ffn": moe_specs(cfg) if moe else mlp_specs(),
        })
    specs = {"embed": P("tp", None), "blocks": blocks, "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "tp")
    return specs


def head_weights(params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _logits(params, h, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], eps=cfg.norm_eps)
    return dense(h, head_weights(params, cfg)).float()


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig) -> torch.Tensor:
    """The tokens' embeddings, after the (B, num_patches, D) patch
    embeddings where the config has a patch prefix."""
    h = params["embed"][batch["tokens"]]
    if cfg.num_patches:
        h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
    return h


def forward(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    *,
    remat: bool = False,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Full-sequence forward.  batch: {"tokens": (B, S) int[, "patches":
    (B, P, D)]}.  ``remat`` checkpoints each layer (``torch.utils.checkpoint``:
    the backward reruns the layer's forward), the reference's
    ``jax.checkpoint`` of its layer scan; ``return_hidden`` returns the last
    layer's (B, S, D) output before the final norm.  The patch rows are
    dropped before either: logits and hidden states are the text's."""
    h = _embed(params, batch, cfg)
    b, s = h.shape[:2]
    positions = _positions(b, s, h.device)
    layers = [(layer_params(params["blocks"][sub]), moe) for sub, moe in _subs(cfg)]
    for i in range(_n_superblocks(cfg)):
        for layer, moe in layers:
            if remat:
                h = checkpoint(_layer_forward, layer(i), h, cfg, moe, positions,
                               use_reentrant=False)
            else:
                h = _layer_forward(layer(i), h, cfg, moe, positions)
    if cfg.num_patches:
        h = h[:, cfg.num_patches:].contiguous()
    if return_hidden:
        return h
    return _logits(params, h, cfg)


def next_token_nll(logits: torch.Tensor, labels: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token NLL over the full logits (labels -1 or >= vocab are
    masked; a negative label indexes from the end, as the reference's
    ``take_along_axis`` does, before its mask drops it): every family's
    ``loss_fn``."""
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    idx = torch.where(labels < 0, labels + logp.shape[-1], labels)
    nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0) & (labels < cfg.vocab)
    return (nll * mask).sum() / torch.clamp(mask.sum(dtype=torch.int32), min=1)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *, remat: bool = True):
    return next_token_nll(forward(params, batch, cfg, remat=remat), batch["labels"], cfg)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device: Any = "cuda"):
    init = init_mla_cache if _mla(cfg) else init_kv_cache
    n = _n_superblocks(cfg)
    cache = {}
    for sub, _ in _subs(cfg):
        one = init(cfg, batch, max_seq, _dtype(cfg), resolve_device(device))
        cache[sub] = {name: leaf[None].expand(n, *leaf.shape).contiguous()
                      for name, leaf in one.items()}
    return cache


def kv_spec(cfg: ArchConfig, batch: int, dp_size: int, tp_size: int = 16) -> P:
    """KV cache (L, B, S, Hkv, Dh): batch over dp when it fills the axis,
    else sequence over dp (SP); heads over tp when divisible, else sequence
    over tp (sequence-parallel decode with partial-softmax combine)."""
    b_ax = "dp" if batch >= dp_size else None
    s_axes = [] if batch >= dp_size else ["dp"]
    h_ax = "tp" if cfg.n_kv_heads % tp_size == 0 else None
    if h_ax is None:
        s_axes.append("tp")
    s_ax = tuple(s_axes) if len(s_axes) > 1 else (s_axes[0] if s_axes else None)
    return P(None, b_ax, s_ax, h_ax, None)


def cache_specs(cfg: ArchConfig, batch: int, dp_size: int = 16) -> Dict[str, Any]:
    """Shard batch over dp when it fills the axis, else sequence (SP); the
    leaves in the cache's own order."""
    if _mla(cfg):
        # latent cache (L, B, S, C): latent dim over tp, batch/seq over dp
        b_ax = "dp" if batch >= dp_size else None
        s_ax = None if batch >= dp_size else "dp"
        one = {"c_kv": P(None, b_ax, s_ax, "tp"), "k_rope": P(None, b_ax, s_ax, "tp")}
    else:
        spec = kv_spec(cfg, batch, dp_size)
        one = {"k": spec, "v": spec}
        if cfg.kv_cache_bits == 8:
            scale_spec = P(*spec[:-1])
            one = {"k": spec, "ks": scale_spec, "v": spec, "vs": scale_spec}
    return {sub: dict(one) for sub, _ in _subs(cfg)}


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, max_seq: int):
    """Run the full prompt (the patch prefix first, where the config has
    one), return (last-position logits, filled cache)."""
    x = _embed(params, batch, cfg)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    pad = max_seq - s
    caches = {sub: [] for sub, _ in _subs(cfg)}
    for i in range(_n_superblocks(cfg)):
        for sub, moe in _subs(cfg):
            lp = layer_slice(params["blocks"][sub], i)
            hn = rmsnorm(x, lp["attn_norm"], eps=cfg.norm_eps)
            if _mla(cfg):
                a, (c_kv, k_rope) = mla_forward(lp["attn"], hn, cfg, positions=positions,
                                                return_kv=True)
                caches[sub].append({"c_kv": F.pad(c_kv, (0, 0, 0, pad)),
                                    "k_rope": F.pad(k_rope, (0, 0, 0, pad))})
            else:
                a, (k, v) = attn_forward(lp["attn"], hn, cfg, positions=positions,
                                         return_kv=True)
                caches[sub].append(prefill_kv_cache(cfg, k, v, pad))
            x = x + a
            hn = rmsnorm(x, lp["mlp_norm"], eps=cfg.norm_eps)
            x = x + _ffn(lp, hn, cfg, moe)
    logits = _logits(params, x[:, -1:].contiguous(), cfg)
    return logits, {sub: stack_layers(c) for sub, c in caches.items()}


def decode_step(params, token: torch.Tensor, cache, pos: torch.Tensor, cfg: ArchConfig):
    """One decode step.  token (B, 1) int32; pos 0-d int32 (current length).
    Each layer writes its own cache slice; the stacked cache is
    built once at the end, not rewritten inside every layer."""
    x = params["embed"][token]
    step = mla_decode_step if _mla(cfg) else attn_decode_step
    caches = {sub: [] for sub, _ in _subs(cfg)}
    for i in range(_n_superblocks(cfg)):
        for sub, moe in _subs(cfg):
            lp = layer_slice(params["blocks"][sub], i)
            lc = layer_slice(cache[sub], i)
            hn = rmsnorm(x, lp["attn_norm"], eps=cfg.norm_eps)
            a, c_new = step(lp["attn"], hn, lc, pos, cfg)
            caches[sub].append(c_new)
            x = x + a
            hn = rmsnorm(x, lp["mlp_norm"], eps=cfg.norm_eps)
            x = x + _ffn(lp, hn, cfg, moe)
    logits = _logits(params, x, cfg)
    return logits, {sub: stack_layers(c) for sub, c in caches.items()}
