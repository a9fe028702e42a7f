"""Mixture-of-Experts FFN with *static-shape* capacity dispatch
(``repro.layers.moe``).

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

With ``cfg.moe_groups`` under a live mesh with a "model" axis the dispatch
is shard-local (the reference's ``shard_map`` dispatch): each rank routes
its own tokens at the local capacity, runs its block of the experts (its
experts over "model" when they divide the axis (EP), else its slice of every
expert's FFN dim), and one all-reduce over "model" completes the output.
Its backward is the transpose of the reference's ``psum``: the output's
gradient passes through unchanged, and the gradients of x and of the
(whole) MoE parameters are summed over "model" where they enter, so each
rank holds them complete over "model" for its own tokens, as it does
outside the MoE.

Sharding: experts over "tp" when E divides the axis (EP), else the
per-expert FFN dim over "tp" (TP-in-expert), chosen in ``moe_specs``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import live_mesh, local_block
from repro_torch.layers.common import dense, dense_init
from repro_torch.layers.mlp import mlp_apply, mlp_init, mlp_specs


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


def moe_specs(cfg, tp_size: int = 16) -> Dict[str, object]:
    if cfg.moe_experts % tp_size == 0:
        # expert parallelism: experts sharded over tp
        s = {
            "router": P(None, None),
            "w_gate": P("tp", None, None),
            "w_up": P("tp", None, None),
            "w_down": P("tp", None, None),
        }
    else:
        # TP within each expert
        s = {
            "router": P(None, None),
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
        }
    if cfg.moe_shared_expert:
        s["shared"] = mlp_specs()
    return s


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


def _experts(xf: torch.Tensor, order, slot, weight, w_gate, w_up, w_down,
             cap: int, k: int) -> torch.Tensor:
    """Fill the (E, cap, D) buffer of the E = ``w_gate.shape[0]`` experts
    given, run them, and combine each token's k choices.  ``slot`` is each
    sorted pair's buffer row, or E*cap (the spare row) for a pair that is
    dropped or belongs to no expert given."""
    t, d = xf.shape
    e = w_gate.shape[0]
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
    g = F.silu(torch.bmm(buf, w_gate).float()).to(xf.dtype)
    u = torch.bmm(buf, w_up)
    out_buf = torch.bmm(g * u, w_down)                           # (E, C, D)

    # mode="fill": the spare row reads zeros
    out_rows = torch.cat([out_buf.reshape(e * cap, d), out_buf.new_zeros((1, d))])
    inv = torch.argsort(order)                                   # pair -> sorted slot
    vals = out_rows.index_select(0, slot.index_select(0, inv))   # (T*k, D), pair order
    vals = (vals * weight[:, None]).reshape(t, k, d)
    y = vals[:, 0]
    for j in range(1, k):
        y = y + vals[:, j]
    return y


def _dispatch_one(p: Dict[str, torch.Tensor], xf: torch.Tensor, cfg, cap: int) -> torch.Tensor:
    """Capacity dispatch + per-expert SwiGLU for one token group (T, D)."""
    order, slot, weight, _ = route(p, xf, cfg, cap)
    return _experts(xf, order, slot, weight, p["w_gate"], p["w_up"], p["w_down"],
                    cap, cfg.moe_top_k)


class _SumOver(torch.autograd.Function):
    """Forward: the sum of ``x`` over ``group``; backward: the gradient as
    it is (every rank computes the same loss from the summed output)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _EnterSum(torch.autograd.Function):
    """Forward: ``x`` as it is; backward: the gradient summed over
    ``group`` (each rank's part of the sum computed from x)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _enter(x: torch.Tensor, group) -> torch.Tensor:
    return _EnterSum.apply(x, group) if torch.is_grad_enabled() and x.requires_grad else x


def _local_dispatch(p: Dict[str, torch.Tensor], xf: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The reference's ``_local_dispatch_shardmap`` on this rank: ``xf``
    (T, D) is this rank's tokens, routed against the whole router at the
    local capacity.  EP (E divides "model"): the pairs of other ranks'
    experts go to the spare row, as the reference's out-of-range index is
    dropped; TP-in-expert: every expert on this rank's slice of the FFN
    dim.  Either way each rank holds a partial sum of every token's
    output, and one differentiable all-reduce over "model" (the
    reference's ``psum``) completes it; backward, the gradients of ``xf``
    and of the whole parameters are summed over "model" (``_EnterSum``)."""
    group = mesh.group("model")
    tp = mesh.shape["model"]
    specs = moe_specs(cfg, tp)
    w = {name: local_block(_enter(p[name], group), mesh, specs[name])
         for name in ("router", "w_gate", "w_up", "w_down")}
    xf = _enter(xf, group)
    cap = moe_capacity(xf.shape[0], cfg)
    order, slot, weight, _ = route(w, xf, cfg, cap)
    if cfg.moe_experts % tp == 0:
        rows = w["w_gate"].shape[0] * cap
        lo = mesh.coordinate("model") * rows
        mine = (slot >= lo) & (slot < lo + rows)
        slot = torch.where(mine, slot - lo, torch.full_like(slot, rows))
    y = _experts(xf, order, slot, weight, w["w_gate"], w["w_up"], w["w_down"],
                 cap, cfg.moe_top_k)
    return _SumOver.apply(y, group)


class _GatherOver(torch.autograd.Function):
    """Forward: every rank's ``x`` of ``group``, concatenated in rank order;
    backward: this rank's rows of the gradient summed over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        n = grad.shape[0] // dist.get_world_size(ctx.group)
        return grad[dist.get_rank(ctx.group) * n:][:n], None


def _gather_dp(xf: torch.Tensor, mesh) -> torch.Tensor:
    """Every dp rank's tokens, in the order of the flattened dp axes."""
    for axis in reversed(mesh.dp_axes()):
        xf = _GatherOver.apply(xf, mesh.group(axis))
    return xf


def _dp_index(mesh) -> int:
    i = 0
    for axis in mesh.dp_axes():
        i = i * mesh.shape[axis] + mesh.coordinate(axis)
    return i


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    """``cfg.moe_groups == 0`` or no live mesh: one global dispatch over all
    B*S tokens of x (B, S, D).  ``cfg.moe_groups > 0`` under a live mesh
    with a "model" axis: x holds this rank's tokens, dispatched shard-local
    when there are at least 8 of them (the reference's ``t // dp >= 8``);
    else every dp rank's tokens are gathered and dispatched globally, as
    the reference does, and this rank keeps its own.  Then the shared
    expert, where the config has one."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    mesh = live_mesh()
    if cfg.moe_groups and mesh is not None and "model" in mesh.axis_names:
        if t >= 8:
            y = _local_dispatch(p, xf, cfg, mesh)
        else:
            xs = _gather_dp(xf, mesh)
            y = _dispatch_one(p, xs, cfg, moe_capacity(xs.shape[0], cfg))
            y = y[_dp_index(mesh) * t:][:t]
    else:
        y = _dispatch_one(p, xf, cfg, moe_capacity(t, cfg))
    if cfg.moe_shared_expert:
        y = y + mlp_apply(p["shared"], xf)
    return y.reshape(b, s, d)
