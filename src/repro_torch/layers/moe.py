"""Mixture-of-Experts FFN with *static-shape* capacity dispatch
(``repro.layers.moe``, its single-device global dispatch).

Top-k routing on the f32 router probabilities, a stable sort of the
(token, choice) pairs by expert, a per-expert capacity
C = ceil(T*k/E * capacity_factor) with drop-on-overflow, a copy into an
(E, C, D) buffer (every index written once, so the copy is deterministic),
batched per-expert SwiGLU, and a weighted combine back.
Every shape depends only on T, so the traced operator sequence is the same
for every input and record/replay applies to MoE steps as to dense ones.
Nothing reads a value on the host: no ``nonzero``, no boolean-mask
indexing, no ``.item()``.

The combine is deterministic.  The sorted slots are a permutation of the
T*k pairs, so each slot's weighted output is gathered back to its pair by
the inverse permutation and the k choices of a token are added in order:
no float ``index_add_``/``scatter_add_`` (on the card those use atomics,
whose order varies between runs).  For k <= 2 this is the reference's
scatter-add up to the commutativity of one add.

The reference's shard_map dispatch (``moe_groups``) is not ported.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.layers.common import dense, dense_init
from repro_torch.layers.mlp import mlp_apply, mlp_init


def moe_capacity(n_tokens: int, cfg) -> int:
    cap = math.ceil(n_tokens * cfg.moe_top_k / cfg.moe_experts * cfg.capacity_factor)
    return max(8, (cap + 7) // 8 * 8)


def moe_init(gen: torch.Generator, cfg, dtype, layers: int) -> Dict[str, torch.Tensor]:
    """Router (layers, D, E) in f32 and expert stacks (layers, E, d_in,
    d_out) in ``dtype``, plus the shared expert's MLP where the config has
    one.  The expert stacks are drawn one layer at a time, so the f32 draw
    never holds more than one layer's experts."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts

    def experts(d_in, d_out):
        w = torch.empty((layers, e, d_in, d_out), dtype=dtype, device=gen.device)
        for i in range(layers):
            w[i] = dense_init(gen, d_in, d_out, dtype, layers=e)
        return w

    p = {
        "router": dense_init(gen, d, e, torch.float32, layers=layers),
        "w_gate": experts(d, f),
        "w_up": experts(d, f),
        "w_down": experts(f, d),
    }
    if cfg.moe_shared_expert:
        p["shared"] = mlp_init(gen, d, f, dtype, layers)
    return p


def route(p: Dict[str, torch.Tensor], xf: torch.Tensor, cfg, cap: int):
    """The dispatch plan of one token group (T, D): ``order`` (T*k,) sorts
    the (token, choice) pairs by expert, stably; ``slot`` (T*k,) is each
    sorted pair's row in the flattened (E*cap,) buffer, or E*cap (the spare
    row) where its position in its expert is at least ``cap``; ``weight``
    (T*k,) is each pair's renormalised gate in x's dtype, in pair order;
    ``counts`` (E,) the pairs routed to each expert (drops included)."""
    t = xf.shape[0]
    k, e = cfg.moe_top_k, cfg.moe_experts
    logits = dense(xf.float(), p["router"])                      # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)                  # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_i.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e.index_select(0, order)
    expert_ids = torch.arange(e, device=xf.device)
    counts = (se[:, None] == expert_ids).sum(0)                  # integer counts
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=xf.device) - starts.index_select(0, se)
    slot = torch.where(pos < cap, se * cap + pos, torch.full_like(pos, e * cap))
    weight = top_w.reshape(t * k).to(xf.dtype)
    return order, slot, weight, counts


def _dispatch_one(p: Dict[str, torch.Tensor], xf: torch.Tensor, cfg, cap: int) -> torch.Tensor:
    """Capacity dispatch + per-expert SwiGLU for one token group (T, D)."""
    t, d = xf.shape
    k, e = cfg.moe_top_k, cfg.moe_experts
    order, slot, weight, _ = route(p, xf, cfg, cap)
    st = torch.div(order, k, rounding_mode="floor")              # sorted pair -> token
    # mode="drop": sorted pair i, if it overflows, writes a spare row
    # E*cap + i of its own, and the spare rows are cut off.  One spare row
    # for every drop would take duplicate writes, whose winner the card
    # leaves open (a batched launch and a lane's launch keep different ones)
    spare = torch.arange(e * cap, e * cap + t * k, device=xf.device)
    dst = torch.where(slot < e * cap, slot, spare)
    buf = xf.new_zeros((e * cap + t * k, d)).index_copy(0, dst, xf.index_select(0, st))
    buf = buf[: e * cap].reshape(e, cap, d)

    # batched per-expert SwiGLU
    g = F.silu(torch.bmm(buf, p["w_gate"]).float()).to(xf.dtype)
    u = torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(g * u, p["w_down"])                      # (E, C, D)

    # mode="fill": the spare row reads zeros
    out_rows = torch.cat([out_buf.reshape(e * cap, d), out_buf.new_zeros((1, d))])
    inv = torch.argsort(order)                                   # pair -> sorted slot
    vals = out_rows.index_select(0, slot.index_select(0, inv))   # (T*k, D), pair order
    vals = (vals * weight[:, None]).reshape(t, k, d)
    y = vals[:, 0]
    for j in range(1, k):
        y = y + vals[:, j]
    return y


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    """One global dispatch over all B*S tokens of x (B, S, D), then the
    shared expert where the config has one."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    y = _dispatch_one(p, xf, cfg, moe_capacity(t, cfg))
    if cfg.moe_shared_expert:
        y = y + mlp_apply(p["shared"], xf)
    return y.reshape(b, s, d)
