"""Mamba2 block (selective state-space duality) built on the SSD scan kernel,
with its partition specs (``repro.layers.mamba2``).

Block: in_proj -> (z | xBC | dt), short causal depthwise conv over xBC,
SiLU, SSD scan over (x, dt, A, B, C), gated RMSNorm, out_proj.
Decode keeps a (conv_state, ssm_state) pair per layer; the SSM state is f32
whatever the model's dtype, as are ``A_log``, ``D`` and ``dt_bias``.

``F.softplus`` turns into the identity above 20 where the reference's
``jax.nn.softplus`` does not; at f32 the two differ by under an ulp there,
which the tests' 2e-4 tolerance covers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_step
from repro_torch.layers.common import dense, dense_init

D_CONV = 4


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    n_groups = cfg.ssm_groups
    conv_dim = d_inner + 2 * n_groups * cfg.ssm_state
    return d_inner, n_heads, n_groups, conv_dim


def mamba2_init(
    gen: torch.Generator, cfg, dtype: torch.dtype, lead: Sequence[int] = ()
) -> Dict[str, torch.Tensor]:
    """One block's parameters, stacked over the leading axes ``lead`` (the
    reference's ``stacked_init`` layout): random projections and conv, the
    reference's constant ``A_log``/``D``/``dt_bias``/``norm``."""
    lead = tuple(lead)
    dev = gen.device
    d = cfg.d_model
    di, nh, ng, cdim = _dims(cfg)
    in_dim = 2 * di + 2 * ng * cfg.ssm_state + nh
    n = math.prod(lead)

    def proj(in_dim: int, out_dim: int) -> torch.Tensor:
        if n == 0:   # an empty stack (a reduced config with no full group)
            return torch.empty((*lead, in_dim, out_dim), dtype=dtype, device=dev)
        w = dense_init(gen, in_dim, out_dim, dtype, layers=n)
        return w.reshape(*lead, *w.shape[1:])

    def const(v: torch.Tensor) -> torch.Tensor:
        return v.expand(*lead, *v.shape).contiguous()

    conv_w = torch.randn((n, D_CONV, cdim), generator=gen, device=dev) * 0.2
    return {
        "in_proj": proj(d, in_dim),
        "conv_w": conv_w.to(dtype).reshape(*lead, *conv_w.shape[1:]),
        "conv_b": const(torch.zeros((cdim,), dtype=dtype, device=dev)),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh, device=dev))),
        "D": const(torch.ones((nh,), device=dev)),
        "dt_bias": const(torch.full((nh,), -2.0, device=dev)),
        "norm": const(torch.ones((di,), dtype=dtype, device=dev)),
        "out_proj": proj(di, d),
    }


def mamba2_specs(cfg) -> Dict[str, P]:
    return {
        "in_proj": P(None, "tp"),
        "conv_w": P(None, "tp"),
        "conv_b": P("tp"),
        "A_log": P(None),
        "D": P(None),
        "dt_bias": P(None),
        "norm": P("tp"),
        "out_proj": P("tp", None),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: xbc (B,S,C), w (K,C), b (C,) -> (B,S,C).
    Neither ``lax.conv_general_dilated`` nor ``F.conv1d`` flips the kernel."""
    c = xbc.shape[-1]
    pad = F.pad(xbc.transpose(1, 2), (D_CONV - 1, 0))        # (B, C, K-1+S)
    out = F.conv1d(pad, w.t()[:, None, :].to(xbc.dtype), groups=c)
    return out.transpose(1, 2) + b.to(xbc.dtype)


def _split_proj(p, x, cfg):
    di, nh, ng, cdim = _dims(cfg)
    zxbcdt = dense(x, p["in_proj"])
    z, xbc, dt = torch.tensor_split(zxbcdt, [di, di + cdim], dim=-1)
    return z, xbc, dt, (di, nh, ng, cdim)


def _gated_out(p, y, z, x_dtype, cfg) -> torch.Tensor:
    y = rmsnorm(
        y * F.silu(z.float()).to(x_dtype), p["norm"], eps=cfg.norm_eps
    )
    return dense(y, p["out_proj"])


def mamba2_forward(
    p: Dict[str, Any], x: torch.Tensor, cfg, *, return_state: bool = False
):
    b, s, _ = x.shape
    z, xbc_pre, dt, (di, nh, ng, cdim) = _split_proj(p, x, cfg)
    xbc = F.silu(_causal_conv(xbc_pre, p["conv_w"], p["conv_b"]).float()).to(x.dtype)
    xs, Bm, Cm = torch.tensor_split(xbc, [di, di + ng * cfg.ssm_state], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_final = ssm_scan(
        xs.reshape(b, s, nh, cfg.ssm_head_dim),
        dt,
        A,
        Bm.reshape(b, s, ng, cfg.ssm_state),
        Cm.reshape(b, s, ng, cfg.ssm_state),
        p["D"],
        chunk=cfg.ssm_chunk,
    )
    out = _gated_out(p, y.reshape(b, s, di), z, x.dtype, cfg)
    if return_state:
        state = {
            "conv": xbc_pre[:, -(D_CONV - 1):, :].contiguous(),
            "ssm": h_final,  # (B, H, N, P)
        }
        return out, state
    return out


def init_mamba2_state(cfg, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    di, nh, ng, cdim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, D_CONV - 1, cdim), dtype=dtype, device=device),
        "ssm": torch.zeros(
            (batch, nh, cfg.ssm_state, cfg.ssm_head_dim), dtype=torch.float32, device=device
        ),
    }


def mamba2_state_specs(cfg) -> Dict[str, P]:
    return {"conv": P("dp", None, "tp"), "ssm": P("dp", "tp", None, None)}


def mamba2_decode_step(
    p: Dict[str, Any],
    x: torch.Tensor,                     # (B, 1, D)
    state: Dict[str, torch.Tensor],
    cfg,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token.  The new state's leaves are fresh contiguous tensors (the
    loop-carried detection compares their raw bytes)."""
    b = x.shape[0]
    z, xbc, dt, (di, nh, ng, cdim) = _split_proj(p, x, cfg)
    # conv state update: shift in the new column
    window = torch.cat([state["conv"], xbc], dim=1)            # (B, K, C)
    conv_out = (
        torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
        + p["conv_b"].float()
    )
    xbc_t = F.silu(conv_out).to(x.dtype)                       # (B, C)
    xs, Bm, Cm = torch.tensor_split(xbc_t, [di, di + ng * cfg.ssm_state], dim=-1)
    dt_t = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, ssm_new = ssm_step(
        xs.reshape(b, nh, cfg.ssm_head_dim),
        dt_t,
        A,
        Bm.reshape(b, ng, cfg.ssm_state),
        Cm.reshape(b, ng, cfg.ssm_state),
        p["D"],
        state["ssm"],
    )
    out = _gated_out(p, y.reshape(b, 1, di), z, x.dtype, cfg)
    return out, {"conv": window[:, 1:].contiguous(), "ssm": ssm_new}
