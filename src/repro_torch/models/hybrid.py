"""Zamba2-style hybrid LM: a Mamba2 backbone with ONE shared attention+MLP
block applied every ``attn_every`` Mamba blocks (the Zamba2 weight-sharing
pattern, arXiv:2411.15242), ``repro.models.hybrid`` with its partition
specs.

The Mamba layers come in ``n_layers // attn_every`` full groups, each
followed by the shared block (one parameter set, reused at every site);
the ``n_layers % attn_every`` leftover layers form a tail with no shared
block after it.  Layouts are the reference's: ``mamba_groups`` leaves carry
(n_groups, attn_every, ...) leading axes, ``mamba_tail`` leaves (n_tail,
...); the cache is ``mamba_groups`` {conv (G,K,B,3,C), ssm (G,K,B,H,N,P)
f32}, ``shared_kv`` {k, v (G,B,S,Hkv,D)} and ``mamba_tail``.  The
reference's ``lax.scan``s are Python loops here, so a traced step holds
every layer's operators.

API (as ``models/lm.py``):
    init_params(cfg, seed, device)             -> params dict
    param_specs(cfg)                           -> same-structure PartitionSpec dict
    forward(params, batch, cfg, remat=, return_hidden=) -> logits (or hidden)
    head_weights(params, cfg)                  -> the LM head
    loss_fn(params, batch, cfg)                -> mean next-token NLL
    init_cache(cfg, batch, max_seq, device)    -> decode cache dict
    cache_specs(cfg, batch, dp_size)           -> PartitionSpec dict of the cache
    prefill(params, batch, cfg, max_seq)       -> (last logits, cache)
    decode_step(params, token, cache, pos, cfg) -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
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
from repro_torch.layers.mamba2 import (
    init_mamba2_state,
    mamba2_decode_step,
    mamba2_forward,
    mamba2_init,
    mamba2_specs,
    mamba2_state_specs,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init, mlp_specs
from repro_torch.models.lm import kv_spec, next_token_nll

# the shared block's KV caches hold a row per position of the bucket
CACHE_PER_POSITION = True


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _groups(cfg: ArchConfig) -> Tuple[int, int]:
    k = cfg.attn_every
    return cfg.n_layers // k, cfg.n_layers % k


def _mamba_layers(gen, cfg: ArchConfig, dtype, lead) -> Dict[str, Any]:
    return {
        "norm": torch.ones((*lead, cfg.d_model), dtype=dtype, device=gen.device),
        "mamba": mamba2_init(gen, cfg, dtype, lead),
    }


def init_params(cfg: ArchConfig, seed: int = 0, device: Any = "cuda") -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = _dtype(cfg)
    n_full, n_rest = _groups(cfg)
    embed = torch.randn(
        (cfg.padded_vocab, cfg.d_model), generator=gen, device=dev
    ) * cfg.d_model ** -0.5
    p = {
        "embed": embed.to(dtype),
        "mamba_groups": _mamba_layers(gen, cfg, dtype, (n_full, cfg.attn_every)),
        "shared_attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "shared_attn": attn_init(gen, cfg, dtype, 0),
        "shared_mlp_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "shared_mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, 0),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
    }
    if n_rest:
        p["mamba_tail"] = _mamba_layers(gen, cfg, dtype, (n_rest,))
    return p


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    n_full, n_rest = _groups(cfg)
    layer = {"norm": P(None), "mamba": mamba2_specs(cfg)}
    specs = {
        "embed": P("tp", None),
        "mamba_groups": tree_map_specs(lambda s: P(None, None, *s), layer),
        "shared_attn_norm": P(None),
        "shared_attn": attn_specs(cfg),
        "shared_mlp_norm": P(None),
        "shared_mlp": mlp_specs(),
        "final_norm": P(None),
        "lm_head": P(None, "tp"),
    }
    if n_rest:
        specs["mamba_tail"] = tree_map_specs(lambda s: P(None, *s), layer)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, dp_size: int = 16) -> Dict[str, Any]:
    n_full, n_rest = _groups(cfg)
    st = mamba2_state_specs(cfg)
    spec = kv_spec(cfg, batch, dp_size)
    specs = {
        "mamba_groups": tree_map_specs(lambda s: P(None, None, *s), st),
        "shared_kv": {"k": spec, "v": spec},
    }
    if n_rest:
        specs["mamba_tail"] = tree_map_specs(lambda s: P(None, *s), st)
    return specs


def head_weights(params, cfg: ArchConfig) -> torch.Tensor:
    return params["lm_head"]


def idle_params(cfg: ArchConfig) -> Tuple[str, ...]:
    """The top-level parameters that the forward never reads under ``cfg``:
    the shared block's when there is no full group."""
    if _groups(cfg)[0]:
        return ()
    return ("shared_attn", "shared_attn_norm", "shared_mlp", "shared_mlp_norm")


def _logits(params, h, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], eps=cfg.norm_eps)
    return dense(h, head_weights(params, cfg)).float()


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _mamba_layer(lp, x, cfg: ArchConfig, *, return_state: bool = False):
    hn = rmsnorm(x, lp["norm"], eps=cfg.norm_eps)
    if not return_state:
        return x + mamba2_forward(lp["mamba"], hn, cfg)
    out, state = mamba2_forward(lp["mamba"], hn, cfg, return_state=True)
    return x + out, state


def _shared_mlp(params, x, cfg: ArchConfig) -> torch.Tensor:
    hn = rmsnorm(x, params["shared_mlp_norm"], eps=cfg.norm_eps)
    return x + mlp_apply(params["shared_mlp"], hn)


def _stack_states(states: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([st[k] for st in states]) for k in ("conv", "ssm")}


def _mamba_run(lp, h, cfg: ArchConfig, remat: bool) -> torch.Tensor:
    if remat:
        return checkpoint(_mamba_layer, lp, h, cfg, use_reentrant=False)
    return _mamba_layer(lp, h, cfg)


def forward(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    *,
    remat: bool = False,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Full-sequence forward.  batch: {"tokens": (B, S) int}.  ``remat``
    checkpoints each Mamba2 layer (``torch.utils.checkpoint``), the
    reference's ``jax.checkpoint`` of its Mamba layer scan; the shared block
    is not rematerialized, as in the reference.  ``return_hidden`` returns
    the last layer's (B, S, D) output before the final norm."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = params["embed"][tokens]
    positions = _positions(b, s, h.device)
    n_full, n_rest = _groups(cfg)
    group = layer_params(params["mamba_groups"])
    for gi in range(n_full):
        layer = layer_params(group(gi))
        for li in range(cfg.attn_every):
            h = _mamba_run(layer(li), h, cfg, remat)
        hn = rmsnorm(h, params["shared_attn_norm"], eps=cfg.norm_eps)
        h = h + attn_forward(params["shared_attn"], hn, cfg, positions=positions)
        h = _shared_mlp(params, h, cfg)
    if n_rest:
        tail = layer_params(params["mamba_tail"])
        for li in range(n_rest):
            h = _mamba_run(tail(li), h, cfg, remat)
    if return_hidden:
        return h
    return _logits(params, h, cfg)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *, remat: bool = True):
    """Mean next-token NLL over the full logits (``lm.next_token_nll``)."""
    return next_token_nll(forward(params, batch, cfg, remat=remat), batch["labels"], cfg)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device: Any = "cuda"):
    """Decode state: per-Mamba-layer (conv, ssm) + a KV cache for every
    shared-attention site."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    n_full, n_rest = _groups(cfg)
    one = init_mamba2_state(cfg, batch, dtype, dev)
    kv = init_kv_cache(cfg, batch, max_seq, dtype, dev)
    cache = {
        "mamba_groups": {
            k: v.expand(n_full, cfg.attn_every, *v.shape).contiguous() for k, v in one.items()
        },
        "shared_kv": {k: v.expand(n_full, *v.shape).contiguous() for k, v in kv.items()},
    }
    if n_rest:
        cache["mamba_tail"] = {
            k: v.expand(n_rest, *v.shape).contiguous() for k, v in one.items()
        }
    return cache


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, max_seq: int):
    """Prompt processing producing decode state: Mamba states come from the
    chunked scan's final recurrent state, attention KV from each shared-block
    site (padded to max_seq)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = _positions(b, s, x.device)
    n_full, n_rest = _groups(cfg)
    pad = max_seq - s
    groups, kvs = [], []
    for gi in range(n_full):
        gp = layer_slice(params["mamba_groups"], gi)
        states = []
        for li in range(cfg.attn_every):
            x, st = _mamba_layer(layer_slice(gp, li), x, cfg, return_state=True)
            states.append(st)
        groups.append(_stack_states(states))
        hn = rmsnorm(x, params["shared_attn_norm"], eps=cfg.norm_eps)
        a, (k, v) = attn_forward(
            params["shared_attn"], hn, cfg, positions=positions, return_kv=True
        )
        kvs.append(prefill_kv_cache(cfg, k, v, pad))
        x = _shared_mlp(params, x + a, cfg)
    if n_full:
        cache = {
            "mamba_groups": _stack_states(groups),
            "shared_kv": stack_layers(kvs),
        }
    else:   # no full group: the empty group and site leaves of a fresh cache
        cache = init_cache(cfg, b, max_seq, x.device)
    if n_rest:
        tail = []
        for li in range(n_rest):
            x, st = _mamba_layer(
                layer_slice(params["mamba_tail"], li), x, cfg, return_state=True
            )
            tail.append(st)
        cache["mamba_tail"] = _stack_states(tail)
    return _logits(params, x[:, -1:].contiguous(), cfg), cache


def _mamba_decode(lp, x, lstate, cfg: ArchConfig):
    hn = rmsnorm(x, lp["norm"], eps=cfg.norm_eps)
    out, new_state = mamba2_decode_step(lp["mamba"], hn, lstate, cfg)
    return x + out, new_state


def decode_step(params, token: torch.Tensor, cache, pos: torch.Tensor, cfg: ArchConfig):
    """One decode step.  token (B, 1) int32; pos 0-d int32 (current length).
    The new cache is built once at the end, with the input cache's key order
    (the served app flattens both the same way)."""
    x = params["embed"][token]
    n_full, n_rest = _groups(cfg)
    groups, kvs = [], []
    for gi in range(n_full):
        gp = layer_slice(params["mamba_groups"], gi)
        gstate = layer_slice(cache["mamba_groups"], gi)
        states = []
        for li in range(cfg.attn_every):
            x, st = _mamba_decode(layer_slice(gp, li), x, layer_slice(gstate, li), cfg)
            states.append(st)
        groups.append(_stack_states(states))
        hn = rmsnorm(x, params["shared_attn_norm"], eps=cfg.norm_eps)
        a, kv = attn_decode_step(
            params["shared_attn"], hn, layer_slice(cache["shared_kv"], gi), pos, cfg
        )
        kvs.append(kv)
        x = _shared_mlp(params, x + a, cfg)
    if n_full:
        new_cache = {
            "mamba_groups": _stack_states(groups),
            "shared_kv": stack_layers(kvs),
        }
    else:
        new_cache = {k: cache[k] for k in ("mamba_groups", "shared_kv")}
    if n_rest:
        tail = []
        for li in range(n_rest):
            x, st = _mamba_decode(
                layer_slice(params["mamba_tail"], li), x,
                layer_slice(cache["mamba_tail"], li), cfg,
            )
            tail.append(st)
        new_cache["mamba_tail"] = _stack_states(tail)
    return _logits(params, x, cfg), new_cache
