"""Fused RMSNorm as one custom op: the Hopper kernel on a CUDA tensor, the
plain version on a CPU tensor.

Registered as ``repro_torch::rmsnorm`` so a traced graph keeps it as one
node, just as one ``pallas_call`` is one jaxpr equation in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import library
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref, rmsnorm_ref

VEC_BYTES = 16          # one vector load or store per lane
WARP_ROW_MAX = 1024     # the warp route's longest row
ROWS_PER_BLOCK = 4      # warps (rows) per block on the warp route
BLOCK_THREADS_MAX = 512
VECTORS_MAX = 4         # 16-byte vectors a thread of the block route holds
ROUTE_CODES = {"scalar": 0, "warp": 1, "block": 2}


def rmsnorm_plan(
    rows: int, d: int, dtype: torch.dtype, *, aligned: bool = True
) -> Dict[str, object]:
    """The launch the kernel makes for ``rows`` rows of ``d``: its route,
    threads per block, rows per block and grid.  Rows whose length is a
    multiple of the 16-byte vector, on 16-byte aligned pointers
    (``aligned``), are held in registers: one warp per row (up to
    ``ROWS_PER_BLOCK`` rows a block) for d <= 1024, else one block per row
    with one to ``VECTORS_MAX`` vectors a thread, threads for two each (more
    would spill registers at 512 threads).
    Anything else takes the scalar route, one block per row."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    per_vec = VEC_BYTES // (4 if dtype == torch.float32 else 2)
    nvec = d // per_vec
    vectorised = aligned and d > 0 and d % per_vec == 0
    if vectorised and d <= WARP_ROW_MAX:
        rpb = max(1, min(ROWS_PER_BLOCK, rows))
        return dict(route="warp", threads=32 * rpb, rows_per_block=rpb, grid=-(-rows // rpb))
    if vectorised and nvec <= VECTORS_MAX * BLOCK_THREADS_MAX:
        threads = min(BLOCK_THREADS_MAX, 32 * -(-nvec // 64))
        return dict(route="block", threads=threads, rows_per_block=1, grid=rows)
    threads = 256 if d >= 256 else 32 * -(-d // 32)
    return dict(route="scalar", threads=threads, rows_per_block=1, grid=rows)


def rmsnorm_cuda(
    x: torch.Tensor, scale: torch.Tensor, eps: float, offset: float
) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    d = x.shape[-1]
    if x.dtype != scale.dtype:
        raise TypeError(f"x is {x.dtype} but scale is {scale.dtype}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    if scale.device != x.device:
        raise ValueError("x and scale on different devices")
    dtype = library.dtype_code(x.dtype)
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, scale, y))
    plan = rmsnorm_plan(rows, d, x.dtype, aligned=aligned)
    fn = library.entry("rmsnorm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    library.LAUNCHES["rmsnorm"] += 1
    library.check("rmsnorm", fn(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
        float(eps), float(offset), dtype, ROUTE_CODES[plan["route"]], plan["threads"],
        plan["rows_per_block"], plan["grid"], stream,
    ))
    return y


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm_op(
    x: torch.Tensor, scale: torch.Tensor, eps: float, offset: float
) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps, offset)
    if x.device.type == "cuda":
        return rmsnorm_cuda(x, scale, eps, offset)
    raise ValueError(f"rmsnorm runs on cpu or cuda tensors, not {x.device}")


@rmsnorm_op.register_fake
def _(x, scale, eps, offset):
    return torch.empty_like(x)


def _rmsnorm_vmap(info, in_dims, x, scale, eps, offset):
    """Batching rule: rows are independent, so the lanes fold into the rows
    of one launch.  A batched scale (per-lane weights, which co-tenants
    sharing one model never have) takes one launch per lane, each on the
    one x when x is unbatched."""
    lanes = info.batch_size
    if in_dims[1] is None:      # then x is the batched one
        return rmsnorm_op(x.movedim(in_dims[0], 0).contiguous(), scale, eps, offset), 0
    scale = scale.movedim(in_dims[1], 0)
    xs = [x] * lanes if in_dims[0] is None else x.movedim(in_dims[0], 0).contiguous()
    return torch.stack([rmsnorm_op(xs[i], scale[i].contiguous(), eps, offset)
                        for i in range(lanes)]), 0


torch.library.register_vmap(rmsnorm_op, _rmsnorm_vmap)

BWD_ROUTE_CODES = {"scalar": 0, "vector": 1}
BWD_WARPS = 8                 # warps per block of the vector route where a warp holds whole rows
BWD_ROWS_IN_FLIGHT = 2        # rows a row group of the vector route loads at once
BWD_SMS = 132                 # the H100's streaming multiprocessors
BWD_BLOCK_BYTES = 32 * 1024   # x and dy bytes a block should have in flight
BWD_SCALAR_BLOCKS_MAX = 1056  # the scalar route's grid: 8 blocks on each SM
BWD_D_MAX = 8192
BWD_BLOCK_WARPS_MAX = 16      # warps per block where the block shares a row, at most
BWD_BLOCK_VECS = 2            # vectors a thread of such a block holds below that
BWD_BLOCK_SM_BYTES = 64 * 1024  # x and dy bytes such blocks keep in flight on each SM
BWD_BLOCK_PER_SM_MAX = 4      # their grid: one to four blocks on each SM


def rmsnorm_backward_plan(rows: int, d: int, dtype: torch.dtype, *,
                          aligned: bool = True) -> Dict[str, object]:
    """The backward's launch for ``rows`` rows of ``d``, from the shape, the
    dtype and whether every pointer is 16-byte aligned (``aligned``).

    Rows that split into 16-byte vectors take the ``vector`` route and are
    read once into registers: ``lanes`` threads share a row, each holding
    ``vecs`` vectors, packed, at fixed columns for every row, two rows at
    once.  Up to d 1024 blocks have 8 warps and a row's lanes are in one
    warp (32, or the largest power of two up to the row's vectors: two
    bf16 rows a warp at d = 128); blocks take ``rows_per_block``
    consecutive rows, whole passes of the block's row groups, and there are
    about as many blocks as keep 32 KB of x and dy in flight on each of the
    132 SMs.  Beyond, up to 8192, the whole block shares a row:
    ``lanes`` = ``threads`` (4 to 16 warps, for two vectors a thread up to
    16 warps), and the grid is one to four blocks an SM, as many as keep
    64 KB of x and dy in flight on each (four at d 2048 bf16, two at
    4096), each taking an even number of consecutive rows.  Anything else
    (rows that do not split into vectors, unaligned pointers) takes the
    ``scalar`` route (4 warps a block, scalar loads, each row read twice).

    Each block writes one f32 partial row of dscale (``smem`` bytes of
    shared memory hold the warps' rows, or where the block shares a row the
    warps' row sums), and a second launch sums the ``grid`` partial rows of
    each column in a fixed order (a grid of one writes dscale itself).  The
    plan depends on nothing but its arguments, so two launches sum in the
    same order."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    elem = 4 if dtype == torch.float32 else 2
    per_vec = VEC_BYTES // elem
    nvec = d // per_vec
    vectorised = aligned and d > 0 and d % per_vec == 0
    if vectorised and d <= WARP_ROW_MAX:
        lanes = min(32, 1 << (nvec.bit_length() - 1))
        vecs = -(-nvec // lanes)
        step = BWD_WARPS * (32 // lanes) * BWD_ROWS_IN_FLIGHT   # rows of one pass of the block
        per_block = BWD_WARPS * 32 * vecs * BWD_ROWS_IN_FLIGHT * 2 * VEC_BYTES
        blocks_max = BWD_SMS * max(1, -(-BWD_BLOCK_BYTES // per_block))
        rpb = step * -(-rows // (step * blocks_max))
        plan = dict(route="vector", threads=BWD_WARPS * 32, lanes=lanes, vecs=vecs,
                    rows_per_block=rpb, smem=4 * BWD_WARPS * d)
    elif vectorised and d <= BWD_D_MAX:
        warps = min(BWD_BLOCK_WARPS_MAX, -(-nvec // (32 * BWD_BLOCK_VECS)))
        vecs = -(-nvec // (32 * warps))
        per_block = BWD_ROWS_IN_FLIGHT * 2 * d * elem
        blocks_max = BWD_SMS * min(BWD_BLOCK_PER_SM_MAX, -(-BWD_BLOCK_SM_BYTES // per_block))
        rpb = 2 * -(-rows // (2 * blocks_max))
        plan = dict(route="vector", threads=32 * warps, lanes=32 * warps, vecs=vecs,
                    rows_per_block=rpb, smem=4 * 2 * BWD_BLOCK_WARPS_MAX * 2 * BWD_ROWS_IN_FLIGHT)
    else:
        rpb = 4 * -(-max(4, -(-rows // BWD_SCALAR_BLOCKS_MAX)) // 4)
        plan = dict(route="scalar", threads=128, lanes=32, vecs=1, rows_per_block=rpb,
                    smem=4 * 4 * d)
    return dict(plan, grid=-(-rows // plan["rows_per_block"]))


def rmsnorm_backward_cuda(
    dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, eps: float, offset: float
):
    """Launch the backward kernel; raises on anything it does not take."""
    d = x.shape[-1]
    if not (dy.dtype == x.dtype == scale.dtype):
        raise TypeError(f"dy {dy.dtype}, x {x.dtype}, scale {scale.dtype}")
    if dy.shape != x.shape or tuple(scale.shape) != (d,):
        raise ValueError(f"dy {tuple(dy.shape)}, x {tuple(x.shape)}, scale {tuple(scale.shape)}")
    if not all(t.is_contiguous() and t.device == x.device for t in (dy, x, scale)):
        raise ValueError("rmsnorm backward takes contiguous tensors on one device")
    if d > BWD_D_MAX:
        raise ValueError(f"rmsnorm backward takes rows of at most {BWD_D_MAX}, not {d}")
    dtype = library.dtype_code(x.dtype)
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(scale)
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (dy, x, scale, dx))
    plan = rmsnorm_backward_plan(rows, d, x.dtype, aligned=aligned)
    dscale = torch.empty_like(scale)
    partial = torch.empty((plan["grid"], d), dtype=torch.float32, device=x.device)
    fn = library.entry("rmsnorm_backward")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    library.LAUNCHES["rmsnorm_backward"] += 1
    library.check("rmsnorm_backward", fn(
        dy.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        partial.data_ptr(), rows, d, float(eps), float(offset), dtype,
        BWD_ROUTE_CODES[plan["route"]], plan["threads"], plan["lanes"], plan["vecs"],
        plan["rows_per_block"], plan["grid"], stream,
    ))
    return dx, dscale


@torch.library.custom_op("repro_torch::rmsnorm_backward", mutates_args=())
def rmsnorm_backward_op(
    dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, eps: float, offset: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return rmsnorm_backward_ref(dy, x, scale, eps, offset)
    if x.device.type == "cuda":
        return rmsnorm_backward_cuda(dy, x, scale, eps, offset)
    raise ValueError(f"rmsnorm_backward runs on cpu or cuda tensors, not {x.device}")


@rmsnorm_backward_op.register_fake
def _(dy, x, scale, eps, offset):
    return torch.empty_like(x), torch.empty_like(scale)


def _rmsnorm_setup(ctx, inputs, output):
    x, scale, eps, offset = inputs
    ctx.save_for_backward(x, scale)
    ctx.eps, ctx.offset = eps, offset


def _rmsnorm_grad(ctx, dy):
    x, scale = ctx.saved_tensors
    dx, dscale = rmsnorm_backward_op(dy.contiguous(), x, scale, ctx.eps, ctx.offset)
    return dx, dscale, None, None


torch.library.register_autograd(rmsnorm_op, _rmsnorm_grad, setup_context=_rmsnorm_setup)


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6, offset: float = 0.0
) -> torch.Tensor:
    return rmsnorm_op(x, scale, float(eps), float(offset))


__all__ = [
    "rmsnorm", "rmsnorm_ref", "rmsnorm_cuda", "rmsnorm_plan", "rmsnorm_backward_op",
    "rmsnorm_backward_ref", "rmsnorm_backward_cuda", "rmsnorm_backward_plan",
]
