"""xLSTM LM (arXiv:2405.04517), ``repro.models.xlstm_lm`` with its
partition specs: mLSTM blocks with an sLSTM block every
``slstm_every`` positions (the paper's [7:1] ratio at 1.3B).  The mLSTM runs
through the chunkwise gated-scan kernel; sLSTM loops over time.

Layers come in ``n_layers // slstm_every`` groups of (slstm_every - 1)
mLSTM blocks and one sLSTM block; leftover mLSTM blocks form a tail group.
Layouts are the reference's: ``m_groups`` leaves carry (n_groups, m_per,
...) leading axes, ``s_blocks`` leaves (n_groups, ...), ``m_tail`` leaves
(n_tail, ...); the cache is ``m_groups`` (G, m_per, B, NH, N, P) f32,
``s_blocks`` a tuple (h, c, n, m) of (G, B, NH, DH) f32 and ``m_tail``.  The
cache has no sequence axis: the recurrent state is the whole history
(705 MB of mLSTM state per sequence at xlstm-1.3b).  The reference builds
its empty cache with ``broadcast_to``; here every leaf is its own
contiguous tensor, since the served app carries it.

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
from repro_torch.layers.common import dense, dense_init, layer_params
from repro_torch.layers.xlstm import (
    init_mlstm_state,
    init_slstm_state,
    mlstm_decode_step,
    mlstm_forward,
    mlstm_init,
    mlstm_specs,
    mlstm_state_specs,
    slstm_decode_step,
    slstm_forward,
    slstm_init,
    slstm_specs,
    slstm_state_specs,
)
from repro_torch.models.lm import next_token_nll

# the decode cache is the recurrent state, with no row per position: a
# generation is not bounded by the serving bucket
CACHE_PER_POSITION = False


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _groups(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(n_groups, mlstm_per_group, n_tail_mlstm)."""
    k = cfg.slstm_every
    return cfg.n_layers // k, k - 1, cfg.n_layers % k


def init_params(cfg: ArchConfig, seed: int = 0, device: Any = "cuda") -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = _dtype(cfg)
    ng, m_per, tail = _groups(cfg)

    def m_layers(lead):
        return {"norm": torch.ones((*lead, cfg.d_model), dtype=dtype, device=dev),
                "mlstm": mlstm_init(gen, cfg, dtype, lead)}

    embed = torch.randn(
        (cfg.padded_vocab, cfg.d_model), generator=gen, device=dev
    ) * cfg.d_model ** -0.5
    p = {
        "embed": embed.to(dtype),
        "m_groups": m_layers((ng, m_per)),
        "s_blocks": {"norm": torch.ones((ng, cfg.d_model), dtype=dtype, device=dev),
                     "slstm": slstm_init(gen, cfg, dtype, (ng,))},
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
    }
    if tail:
        p["m_tail"] = m_layers((tail,))
    return p


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    ng, m_per, tail = _groups(cfg)
    m_layer = {"norm": P(None), "mlstm": mlstm_specs(cfg)}
    specs = {
        "embed": P("tp", None),
        "m_groups": tree_map_specs(lambda s: P(None, None, *s), m_layer),
        "s_blocks": tree_map_specs(lambda s: P(None, *s),
                                   {"norm": P(None), "slstm": slstm_specs(cfg)}),
        "final_norm": P(None),
        "lm_head": P(None, "tp"),
    }
    if tail:
        specs["m_tail"] = tree_map_specs(lambda s: P(None, *s), m_layer)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, dp_size: int = 16) -> Dict[str, Any]:
    ng, m_per, tail = _groups(cfg)
    m = mlstm_state_specs(cfg, batch, dp_size)
    s = slstm_state_specs(cfg, batch, dp_size)
    specs = {"m_groups": P(None, None, *m), "s_blocks": tree_map_specs(lambda x: P(None, *x), s)}
    if tail:
        specs["m_tail"] = P(None, *m)
    return specs


def head_weights(params, cfg: ArchConfig) -> torch.Tensor:
    return params["lm_head"]


def _logits(params, h, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"], eps=cfg.norm_eps)
    return dense(h, head_weights(params, cfg)).float()


def _m_layer(lp, x, cfg: ArchConfig, *, return_state: bool = False):
    hn = rmsnorm(x, lp["norm"], eps=cfg.norm_eps)
    if not return_state:
        return x + mlstm_forward(lp["mlstm"], hn, cfg)
    out, state = mlstm_forward(lp["mlstm"], hn, cfg, return_state=True)
    return x + out, state


def _s_layer(sp, x, cfg: ArchConfig, *, return_state: bool = False):
    hn = rmsnorm(x, sp["norm"], eps=cfg.norm_eps)
    if not return_state:
        return x + slstm_forward(sp["slstm"], hn, cfg)
    out, state = slstm_forward(sp["slstm"], hn, cfg, return_state=True)
    return x + out, state


def _layers(params, cfg: ArchConfig):
    """The blocks in order as ("m", mLSTM layer params) and ("s", sLSTM
    block params): each group's mLSTMs then its sLSTM, the tail's mLSTMs
    last (select views, or per-layer ``unbind``s of leaves that require
    grad: ``layers.common.layer_params``)."""
    ng, m_per, tail = _groups(cfg)
    group, s_block = layer_params(params["m_groups"]), layer_params(params["s_blocks"])
    for gi in range(ng):
        layer = layer_params(group(gi))
        for li in range(m_per):
            yield "m", layer(li)
        yield "s", s_block(gi)
    if tail:
        m_tail = layer_params(params["m_tail"])
        for li in range(tail):
            yield "m", m_tail(li)


def forward(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    *,
    remat: bool = False,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Full-sequence forward.  batch: {"tokens": (B, S) int}.  ``remat``
    checkpoints each mLSTM layer (``torch.utils.checkpoint``), the
    reference's ``jax.checkpoint`` of its mLSTM layer scan; the sLSTM blocks
    are not rematerialized, as in the reference.  ``return_hidden`` returns
    the last block's (B, S, D) output before the final norm."""
    h = params["embed"][batch["tokens"]]
    for kind, lp in _layers(params, cfg):
        if kind == "s":
            h = _s_layer(lp, h, cfg)
        elif remat:
            h = checkpoint(_m_layer, lp, h, cfg, use_reentrant=False)
        else:
            h = _m_layer(lp, h, cfg)
    if return_hidden:
        return h
    return _logits(params, h, cfg)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *, remat: bool = True):
    """Mean next-token NLL over the full logits (``lm.next_token_nll``)."""
    return next_token_nll(forward(params, batch, cfg, remat=remat), batch["labels"], cfg)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device: Any = "cuda"):
    """Zero recurrent states (m at -1e30); ``max_seq`` is not used."""
    dev = resolve_device(device)
    ng, m_per, tail = _groups(cfg)
    m_state = init_mlstm_state(cfg, batch, dev)
    cache = {
        "m_groups": m_state.expand(ng, m_per, *m_state.shape).contiguous(),
        "s_blocks": tuple(x.expand(ng, *x.shape).contiguous()
                          for x in init_slstm_state(cfg, batch, dev)),
    }
    if tail:
        cache["m_tail"] = m_state.expand(tail, *m_state.shape).contiguous()
    return cache


def _pack(cfg: ArchConfig, m_states: List[torch.Tensor], s_states: List[tuple],
          batch: int, device) -> Dict[str, Any]:
    """Per-layer states in layer order -> the cache tree, each leaf built
    with one ``torch.stack`` (the groups' mLSTM states stacked together and
    viewed as (G, m_per, ...), not stacked twice)."""
    ng, m_per, tail = _groups(cfg)
    if ng:
        grouped = torch.stack(m_states[:ng * m_per])
        cache = {"m_groups": grouped.reshape(ng, m_per, *grouped.shape[1:]),
                 "s_blocks": tuple(torch.stack(leaves) for leaves in zip(*s_states))}
    else:   # no full group: the empty group leaves of a fresh cache
        cache = init_cache(cfg, batch, 0, device)
    if tail:
        cache["m_tail"] = torch.stack(m_states[ng * m_per:])
    return cache


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, max_seq: int = 0):
    """Chunked-parallel prompt pass; the recurrent states come out of the
    scans (mLSTM) and the time loops (sLSTM)."""
    tokens = batch["tokens"]
    h = params["embed"][tokens]
    m_states, s_states = [], []
    for kind, lp in _layers(params, cfg):
        if kind == "m":
            h, st = _m_layer(lp, h, cfg, return_state=True)
            m_states.append(st)
        else:
            h, st = _s_layer(lp, h, cfg, return_state=True)
            s_states.append(st)
    cache = _pack(cfg, m_states, s_states, tokens.shape[0], h.device)
    return _logits(params, h[:, -1:].contiguous(), cfg), cache


def decode_step(params, token: torch.Tensor, cache, pos: torch.Tensor, cfg: ArchConfig):
    """One decode step.  token (B, 1) int32; ``pos`` is not read (the state
    is the position).  The new cache is built once at the end, with the
    input cache's key order (the served app flattens both the same way)."""
    x = params["embed"][token]
    ng, m_per, tail = _groups(cfg)
    m_in = [cache["m_groups"][gi, li] for gi in range(ng) for li in range(m_per)]
    m_in += [cache["m_tail"][li] for li in range(tail)]
    m_states, s_states = [], []
    for kind, lp in _layers(params, cfg):
        if kind == "m":
            hn = rmsnorm(x, lp["norm"], eps=cfg.norm_eps)
            out, st = mlstm_decode_step(lp["mlstm"], hn, m_in[len(m_states)], cfg)
            m_states.append(st)
        else:
            gi = len(s_states)
            hn = rmsnorm(x, lp["norm"], eps=cfg.norm_eps)
            out, st = slstm_decode_step(lp["slstm"], hn,
                                        tuple(leaf[gi] for leaf in cache["s_blocks"]), cfg)
            s_states.append(st)
        x = x + out
    return _logits(params, x, cfg), _pack(cfg, m_states, s_states, token.shape[0], x.device)
