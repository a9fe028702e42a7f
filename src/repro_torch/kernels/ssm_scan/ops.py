"""The gated SSD scan as one custom op: the Hopper kernel on a CUDA tensor,
the plain chunked version on a CPU tensor.  Registered as
``repro_torch::gated_scan`` (returning ``(y, h)``) so a traced graph keeps it
as one node with two outputs, as one ``pallas_call`` is one jaxpr equation.

The wrappers follow ``repro.kernels.ssm_scan.ops``: the chunk is
``min(chunk, S)`` and the plain version pads S to a chunk multiple with
identity steps (log-decay 0 keeps the state, input scale 0 injects nothing);
the kernel masks a ragged last chunk instead, which computes the same thing.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import library
from repro_torch.kernels.ssm_scan.ref import (
    gated_scan_mma_ref,
    gated_scan_ref,
    gated_step_ref,
    ssm_scan_ref,
    ssm_step_ref,
)

MAX_CHUNK = 128     # the kernel stages one chunk of up to 128 steps
NARROW_STATE = 128  # up to 128 state rows (N), a whole chunk of B and C fits beside the state
MAX_STATE = 1024    # the wide routes stream B and C in slabs along N up to 1024 rows
WIDE_SLAB = {"mma_wide": 64, "cuda_cores_wide": 16}   # columns of B and C per slab
ROUTE_CODES = {"cuda_cores": 0, "mma": 1, "mma_wide": 2, "cuda_cores_wide": 3}


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def scan_plan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
              dtype: torch.dtype) -> Dict[str, object]:
    """The launch the kernel makes for these shapes (``chunk`` is the
    wrapper's ``min(chunk, S)``): its route, warps per block, grid and
    dynamic shared memory in bytes, as the C entry point checks them.  bf16
    takes the tensor cores (``mma``): one block per (32 columns of P, head,
    batch row), 4 warps for a chunk of up to 64 steps and 8 up to 128, each
    owning 16 rows of the chunk; shared memory holds x and y (chunk rows
    padded to 16, rows of 32 + 8 bf16), B and C (rows of N padded to 16,
    + 8 bf16), the f32 state (N padded to 16, rows of 32 + 4 floats) and the
    chunk's cumulative log-decay and input scales.  f32 takes the CUDA cores:
    8 warps per (32 columns of P, head, batch row).

    A state of more than ``NARROW_STATE`` rows (mLSTM's N = 1024) takes the
    wide routes, same grid and warps: the state slice stays resident, and B
    and C stream through shared memory in slabs of ``WIDE_SLAB`` columns
    (bf16: two slabs of (chunk rows padded to 16, 64 + 8) bf16 in place of
    whole rows of B and C; f32: a (chunk, 16 + 1) and a (chunk, 16) slab
    beside the chunk's (chunk, chunk) scores)."""
    if n > MAX_STATE:
        raise ValueError(f"state size N={n} > {MAX_STATE}")
    grid = (-(-p // 32), h, b)
    if dtype == torch.bfloat16:
        qp, np_ = _round16(chunk), _round16(n)
        warps = 4 if chunk <= 64 else 8
        xy = 2 * qp * (32 + 8) * 2
        state = np_ * (32 + 4) * 4 + 2 * qp * 4
        if n <= NARROW_STATE:
            return dict(route="mma", warps=warps, grid=grid,
                        smem=xy + 2 * qp * (np_ + 8) * 2 + state)
        slab = WIDE_SLAB["mma_wide"]
        return dict(route="mma_wide", warps=warps, grid=grid,
                    smem=xy + 2 * qp * (slab + 8) * 2 + state)
    if dtype == torch.float32:
        if n <= NARROW_STATE:
            floats = n * 32 + chunk * 32 + chunk * (n + 1) + chunk * n + 4 * chunk + 8 * chunk
            return dict(route="cuda_cores", warps=8, grid=grid, smem=4 * floats)
        slab = WIDE_SLAB["cuda_cores_wide"]
        floats = (n * 32 + chunk * chunk + chunk * 32 + chunk * (slab + 1) + chunk * slab
                  + 4 * chunk)
        return dict(route="cuda_cores_wide", warps=8, grid=grid, smem=4 * floats)
    raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")


def vector_flags(route: str, p: int, n: int, x, bm, cm, y) -> int:
    """Which operands the kernel moves 16 bytes at a time.  The narrow mma
    route takes one flag for all of x, B, C and y (P and N multiples of 8,
    every pointer 16-byte aligned); the wide mma route a bit mask, bit 0 for
    x, y and the state's rows (P a multiple of 8: mLSTM's P = 1025 is not)
    and bit 1 for B and C (N a multiple of 8), each with its pointers
    aligned.  The CUDA-core routes take none."""
    def aligned(*ts):
        return all(t.data_ptr() % 16 == 0 for t in ts)

    if route == "mma":
        return int(p % 8 == 0 and n % 8 == 0 and aligned(x, bm, cm, y))
    if route == "mma_wide":
        return int(p % 8 == 0 and aligned(x, y)) | 2 * int(n % 8 == 0 and aligned(bm, cm))
    return 0


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` zero steps on axis 1."""
    widths = [0, 0] * (t.dim() - 2) + [0, pad]
    return F.pad(t, widths)


def gated_scan_padded(x, ld, gi, Bm, Cm, D, h0, chunk: int):
    """The plain version with the reference's padding rule.  Its outputs are
    contiguous, as the op's fake outputs say: a traced graph reshapes them
    with views."""
    s = x.shape[1]
    eff = min(chunk, s)
    pad = (-s) % eff
    if pad:
        x, ld, gi, Bm, Cm = (_pad_seq(t, pad) for t in (x, ld, gi, Bm, Cm))
    y, h = gated_scan_ref(x, ld, gi, Bm, Cm, D, chunk=eff, h0=h0)
    return y[:, :s].contiguous(), h.contiguous()


def gated_scan_cuda(
    x: torch.Tensor,
    ld: torch.Tensor,
    gi: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor],
    h0: Optional[torch.Tensor],
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on anything it does not take."""
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"x {tuple(x.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    b, s, h, p = x.shape
    _, _, g, n = Bm.shape
    if tuple(Bm.shape[:2]) != (b, s) or g == 0 or h % g:
        raise ValueError(f"x {tuple(x.shape)} vs B/C {tuple(Bm.shape)}: need G | H")
    if tuple(ld.shape) != (b, s, h) or ld.shape != gi.shape:
        raise ValueError(f"log_decay {tuple(ld.shape)}, in_scale {tuple(gi.shape)} != {(b, s, h)}")
    if n > MAX_STATE:
        raise ValueError(f"state size N={n} > {MAX_STATE}: the kernel keeps its block's slice "
                         "of the state in shared memory")
    chunk = min(int(chunk), s)
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{MAX_CHUNK}")
    if not (Bm.dtype == Cm.dtype == x.dtype):
        raise TypeError(f"x {x.dtype}, B {Bm.dtype}, C {Cm.dtype}")
    f32 = [t for t in (ld, gi, D, h0) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("log_decay, in_scale, D and h0 must be float32")
    if D is not None and tuple(D.shape) != (h,):
        raise ValueError(f"D shape {tuple(D.shape)} != ({h},)")
    if h0 is not None and tuple(h0.shape) != (b, h, n, p):
        raise ValueError(f"h0 shape {tuple(h0.shape)} != {(b, h, n, p)}")
    ts = [x, ld, gi, Bm, Cm, *(t for t in (D, h0) if t is not None)]
    if not all(t.is_contiguous() and t.device == x.device for t in ts):
        raise ValueError("the scan kernel takes contiguous tensors on one device")
    dtype = library.dtype_code(x.dtype)
    plan = scan_plan(b, s, h, p, g, n, chunk, x.dtype)
    if max(plan["grid"][1:]) > 65535:
        raise ValueError(f"grid {plan['grid']} over the launch limit")
    y = torch.empty_like(x)
    hout = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, hout.zero_()
    vec = vector_flags(plan["route"], p, n, x, Bm, Cm, y)
    fn = library.entry("ssm_scan")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    library.LAUNCHES["ssm_scan"] += 1
    library.check("ssm_scan", fn(
        x.data_ptr(), ld.data_ptr(), gi.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if D is None else D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), hout.data_ptr(), b, s, h, p, g, n, chunk, dtype,
        ROUTE_CODES[plan["route"]], plan["warps"], plan["smem"], vec, stream,
    ))
    return y, hout


@torch.library.custom_op("repro_torch::gated_scan", mutates_args=())
def gated_scan_op(
    x: torch.Tensor,
    log_decay: torch.Tensor,
    in_scale: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor],
    h0: Optional[torch.Tensor],
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return gated_scan_padded(x, log_decay, in_scale, Bm, Cm, D, h0, chunk)
    if x.device.type == "cuda":
        return gated_scan_cuda(x, log_decay, in_scale, Bm, Cm, D, h0, chunk)
    raise ValueError(f"gated_scan runs on cpu or cuda tensors, not {x.device}")


@gated_scan_op.register_fake
def _(x, log_decay, in_scale, Bm, Cm, D, h0, chunk):
    b, _, h, p = x.shape
    return torch.empty_like(x), x.new_empty((b, h, Bm.shape[-1], p), dtype=torch.float32)


def _gated_scan_vmap(info, in_dims, x, log_decay, in_scale, Bm, Cm, D, h0, chunk):
    """Batching rule: one block per (columns of P, head, batch row), so the
    lanes fold into the batch axis of one launch, and both outputs, y and h,
    come back batched.  An unbatched operand is expanded and then written
    out once per lane (``library.fold_lanes``); a batched D
    (per-lane head skips, which co-tenants sharing one model never have)
    takes one launch per lane."""
    lanes = info.batch_size
    ops = [library.lanes_first(t, d, lanes)
           for t, d in zip((x, log_decay, in_scale, Bm, Cm, D, h0), in_dims)]
    if in_dims[5] is not None:
        ys, hs = zip(*(
            gated_scan_op(*(None if t is None else t[i].contiguous() for t in ops), chunk)
            for i in range(lanes)
        ))
        return (torch.stack(ys), torch.stack(hs)), (0, 0)
    b = ops[0].shape[1]
    folded = [D if i == 5 else library.fold_lanes(t) for i, t in enumerate(ops)]
    y, h = gated_scan_op(*folded, chunk)
    return (y.reshape(lanes, b, *y.shape[1:]), h.reshape(lanes, b, *h.shape[1:])), (0, 0)


torch.library.register_vmap(gated_scan_op, _gated_scan_vmap)


def gated_scan(
    x: torch.Tensor,
    log_decay: torch.Tensor,
    in_scale: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B,S,H,P) in x's dtype and the final state (B,H,N,P) f32.  Views
    (the split projections of a Mamba2 block) are made contiguous here, so the
    kernel never reads a view as if it were dense; the f32 operands are cast."""
    f32 = torch.float32
    return gated_scan_op(
        x.contiguous(), log_decay.to(f32).contiguous(), in_scale.to(f32).contiguous(),
        Bm.contiguous(), Cm.contiguous(),
        None if D is None else D.to(f32).contiguous(),
        None if h0 is None else h0.to(f32).contiguous(),
        int(chunk),
    )


def ssm_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128, h0=None):
    """Mamba2 wrapper: log-decay = dt*A, input scale = dt."""
    ld = dt.to(torch.float32) * A.to(torch.float32)[None, None, :]
    return gated_scan(x, ld, dt, Bm, Cm, D, chunk=chunk, h0=h0)


gated_step = gated_step_ref
ssm_step = ssm_step_ref

__all__ = [
    "gated_scan", "gated_scan_cuda", "gated_scan_padded", "gated_step", "scan_plan",
    "ssm_scan", "ssm_step", "gated_scan_mma_ref", "gated_scan_ref", "gated_step_ref",
    "ssm_scan_ref", "ssm_step_ref",
]
