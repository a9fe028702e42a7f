"""xLSTM blocks and their partition specs (``repro.layers.xlstm``): mLSTM
(matrix memory, chunkwise-parallel through the gated-scan kernel) and sLSTM
(scalar memory, recurrent over time).

mLSTM maps exactly onto the gated linear recurrence:
    C_t = f_t C_{t-1} + i_t v_t k_t^T          (matrix state)
    n_t = f_t n_{t-1} + i_t k_t                (normalizer state)
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)
with log-decay = log sigmoid(f~) and input scale i_t = exp(min(i~, cap)).
The normalizer rides along as an extra value column (v' = [v | 1]), so one
scan produces both C_t q_t and n_t . q_t: at xlstm-1.3b's width the scan's
state is N = 1024 key rows by P = 1025 value columns per head, in f32.  The
input-gate exponent is capped instead of carrying the xLSTM running-max
stabilizer across chunks (the reference's simplification).

sLSTM keeps per-head scalar state (c, n, m) with the exponential-gating
stabilizer m_t = max(f~ + m_{t-1}, i~) and head-wise recurrent gate
weights.  The reference scans it over time with ``lax.scan`` and no kernel;
here it is a Python loop over the steps, so a traced forward holds one cell
per step.  Decode steps of both run plain torch, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssm_scan import gated_scan, gated_step
from repro_torch.layers.common import dense, dense_init

I_GATE_CAP = 8.0
UP_FACTOR = 2
M_INIT = -1e30      # the stabilizer m before the first step


def _mdims(cfg):
    di = UP_FACTOR * cfg.d_model
    nh = cfg.n_heads
    dh = di // nh
    return di, nh, dh


def _stacked(gen, in_dim, out_dims, dtype, lead: Tuple[int, ...]) -> torch.Tensor:
    """``dense_init`` of shape (*lead, in_dim, *out_dims); empty where a
    leading axis is 0 (a reduced config with no full group)."""
    n = math.prod(lead)
    if n == 0:
        outs = (out_dims,) if isinstance(out_dims, int) else tuple(out_dims)
        return torch.empty((*lead, in_dim, *outs), dtype=dtype, device=gen.device)
    w = dense_init(gen, in_dim, out_dims, dtype, layers=n)
    return w.reshape(*lead, *w.shape[1:])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg, dtype, lead: Sequence[int] = ()) -> Dict[str, Any]:
    """One block's parameters stacked over the leading axes ``lead`` (the
    reference's layout): block-diagonal per-head projections (NH, DH, DH),
    the gate projection ``w_gates`` in f32 whatever the model's dtype."""
    lead = tuple(lead)
    d = cfg.d_model
    di, nh, dh = _mdims(cfg)
    return {
        "up_proj": _stacked(gen, d, 2 * di, dtype, lead),        # x_in | z gate
        "wq": _stacked(gen, dh, dh, dtype, (*lead, nh)),
        "wk": _stacked(gen, dh, dh, dtype, (*lead, nh)),
        "wv": _stacked(gen, dh, dh, dtype, (*lead, nh)),
        "w_gates": _stacked(gen, di, 2 * nh, torch.float32, lead),   # i~ | f~ per head
        "norm": torch.ones((*lead, di), dtype=dtype, device=gen.device),
        "down_proj": _stacked(gen, di, d, dtype, lead),
    }


def mlstm_specs(cfg) -> Dict[str, P]:
    return {
        "up_proj": P(None, "tp"),
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "w_gates": P(None, None),
        "norm": P("tp"),
        "down_proj": P("tp", None),
    }


def _mlstm_qkvg(p, x: torch.Tensor, cfg):
    b, s, _ = x.shape
    di, nh, dh = _mdims(cfg)
    up = dense(x, p["up_proj"])
    x_in, z = torch.split(up, di, dim=-1)
    xh = x_in.reshape(b, s, nh, dh)
    q = torch.einsum("bshd,hde->bshe", xh, p["wq"]).to(x.dtype)
    # sqrt(dh) is rounded through x's dtype, as the reference's weakly typed
    # scalar is (a host scalar: nothing launches for it)
    root = torch.tensor(float(dh) ** 0.5, dtype=x.dtype).item()
    k = (torch.einsum("bshd,hde->bshe", xh, p["wk"]) / root).to(x.dtype)
    v = torch.einsum("bshd,hde->bshe", xh, p["wv"]).to(x.dtype)
    gates = dense(x_in.float(), p["w_gates"])
    i_t, f_t = torch.split(gates, nh, dim=-1)              # (B,S,NH)
    log_decay = F.logsigmoid(f_t)
    in_scale = torch.exp(torch.clamp(i_t, max=I_GATE_CAP))
    return q, k, v, log_decay, in_scale, z, (di, nh, dh)


def _mlstm_out(p, y_aug: torch.Tensor, z: torch.Tensor, x_dtype, cfg, shape) -> torch.Tensor:
    """Normalize by max(|n . q|, 1), gated RMSNorm, down projection."""
    dh = y_aug.shape[-1] - 1
    y = y_aug[..., :dh] / torch.clamp(y_aug[..., dh:].abs(), min=1.0)
    y = rmsnorm(y.reshape(shape), p["norm"], eps=cfg.norm_eps)
    y = y * F.silu(z.float()).to(x_dtype)
    return dense(y, p["down_proj"])


def mlstm_forward(p: Dict[str, Any], x: torch.Tensor, cfg, *, return_state: bool = False):
    b, s, _ = x.shape
    q, k, v, ld, gi, z, (di, nh, dh) = _mlstm_qkvg(p, x, cfg)
    ones = torch.ones((b, s, nh, 1), dtype=v.dtype, device=v.device)
    v_aug = torch.cat([v, ones], dim=-1)                   # (B,S,NH,DH+1)
    y_aug, h_final = gated_scan(v_aug, ld, gi, k, q, None, chunk=cfg.ssm_chunk)
    out = _mlstm_out(p, y_aug, z, x.dtype, cfg, (b, s, di))
    if return_state:
        return out, h_final
    return out


def init_mlstm_state(cfg, batch: int, device) -> torch.Tensor:
    """(B, NH, N=DH, P=DH+1) f32: matrix memory + normalizer column."""
    di, nh, dh = _mdims(cfg)
    return torch.zeros((batch, nh, dh, dh + 1), dtype=torch.float32, device=device)


def mlstm_state_specs(cfg, batch: int = 0, dp_size: int = 16) -> P:
    # matrix memory (B, NH, DH, DH+1): shard batch when it fills dp, else the
    # key dim; head counts are small (4) so never sharded over tp=16
    if batch >= dp_size:
        return P("dp", None, "tp", None)
    return P(None, None, "tp", None)


def mlstm_decode_step(
    p: Dict[str, Any], x: torch.Tensor, state: torch.Tensor, cfg
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token through the plain ``gated_step``; the new state is a fresh
    tensor (the loop-carried detection compares its raw bytes)."""
    b = x.shape[0]
    q, k, v, ld, gi, z, (di, nh, dh) = _mlstm_qkvg(p, x, cfg)
    v_aug = torch.cat([v, torch.ones((b, 1, nh, 1), dtype=v.dtype, device=v.device)], dim=-1)
    y_aug, state_new = gated_step(
        v_aug[:, 0], ld[:, 0], gi[:, 0], k[:, 0], q[:, 0], None, state
    )
    return _mlstm_out(p, y_aug, z, x.dtype, cfg, (b, 1, di)), state_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg, dtype, lead: Sequence[int] = ()) -> Dict[str, Any]:
    lead = tuple(lead)
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    r = torch.randn((*lead, nh, dh, 4 * dh), generator=gen, device=gen.device) * dh ** -0.5
    return {
        "w_in": _stacked(gen, d, 4 * d, dtype, lead),            # z, i, f, o gates
        "r": r.to(dtype),                                         # head-wise recurrent weights
        "norm": torch.ones((*lead, d), dtype=dtype, device=gen.device),
        "up_proj": _stacked(gen, d, 2 * cfg.slstm_ff, dtype, lead),
        "down_proj": _stacked(gen, cfg.slstm_ff, d, dtype, lead),
    }


def slstm_specs(cfg) -> Dict[str, P]:
    return {
        "w_in": P(None, "tp"),
        "r": P("tp", None, None),
        "norm": P(None),
        "up_proj": P(None, "tp"),
        "down_proj": P("tp", None),
    }


def _slstm_cell(gates_x, h_prev, state, r):
    """One sLSTM time step.  gates_x (B,NH,DH,4), h_prev (B,NH,DH),
    state = (c, n, m) each (B,NH,DH), all f32."""
    c, n, m = state
    rec = torch.einsum("bhd,hde->bhe", h_prev.float(), r.float())
    g = gates_x + rec.reshape(*h_prev.shape[:2], -1, 4)
    z_t = torch.tanh(g[..., 0])
    i_t = g[..., 1]
    f_t = g[..., 2]
    o_t = torch.sigmoid(g[..., 3])
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    h_new = o_t * c_new / torch.clamp(n_new, min=1.0)
    return h_new, (c_new, n_new, m_new)


def _slstm_out(p, hs: torch.Tensor, x_dtype, cfg) -> torch.Tensor:
    y = rmsnorm(hs.to(x_dtype), p["norm"], eps=cfg.norm_eps)
    u, g = torch.split(dense(y, p["up_proj"]), cfg.slstm_ff, dim=-1)
    return dense(u * torch.sigmoid(g.float()).to(x_dtype), p["down_proj"])


def slstm_forward(p: Dict[str, Any], x: torch.Tensor, cfg, *, return_state: bool = False):
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    gates_x = dense(x.float(), p["w_in"].float()).reshape(b, s, nh, dh, 4)
    r = p["r"].float()                  # cast once, not once a step
    h = torch.zeros((b, nh, dh), dtype=torch.float32, device=x.device)
    state = (h, h, torch.full((b, nh, dh), M_INIT, dtype=torch.float32, device=x.device))
    hs = []
    # one unbind, not an index a step: the backward of gates_x[:, t] is a
    # whole (B, S, NH, DH, 4) tensor a step (S^2 traffic), unbind's one stack
    for g_t in gates_x.unbind(1):
        h, state = _slstm_cell(g_t, h, state, r)
        hs.append(h)
    out = _slstm_out(p, torch.stack(hs, dim=1).reshape(b, s, d), x.dtype, cfg)
    if return_state:
        return out, (h, *state)
    return out


def init_slstm_state(cfg, batch: int, device) -> Tuple[torch.Tensor, ...]:
    """(h, c, n, m), each (B, NH, DH) f32 and its own tensor; m starts at
    -1e30."""
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    z = [torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3)]
    return (*z, torch.full(shape, M_INIT, dtype=torch.float32, device=device))


def slstm_state_specs(cfg, batch: int = 0, dp_size: int = 16) -> Tuple[P, ...]:
    z = P("dp" if batch >= dp_size else None, None, None)
    return (z, z, z, z)


def slstm_decode_step(
    p: Dict[str, Any], x: torch.Tensor, state, cfg
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    b, _, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    h_prev, c, n, m = state
    gates_x = dense(x[:, 0].float(), p["w_in"].float()).reshape(b, nh, dh, 4)
    h_new, (c2, n2, m2) = _slstm_cell(gates_x, h_prev, (c, n, m), p["r"])
    return _slstm_out(p, h_new.reshape(b, 1, d), x.dtype, cfg), (h_new, c2, n2, m2)
