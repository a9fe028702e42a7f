"""The gated SSD scan as one custom op: the Hopper kernel on a CUDA tensor,
the plain chunked version on a CPU tensor.  Registered as
``repro_torch::gated_scan`` (returning ``(y, h)``) so a traced graph keeps it
as one node with two outputs, as one ``pallas_call`` is one jaxpr equation.

The wrappers follow ``repro.kernels.ssm_scan.ops``: the chunk is
``min(chunk, S)`` and the plain version pads S to a chunk multiple with
identity steps (log-decay 0 keeps the state, input scale 0 injects nothing);
the kernel masks a ragged last chunk instead, which computes the same thing.

Its gradient is ``repro_torch::gated_scan_backward`` (the hand-written
``csrc/ssm_scan_backward.cu`` on a CUDA tensor, ``gated_scan_backward_ref``
on a CPU one), registered as the forward op's autograd; the served op keeps
its schema and its one node.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import library
from repro_torch.kernels.ssm_scan.ref import (
    gated_scan_backward_mma_ref,
    gated_scan_backward_ref,
    gated_scan_mma_ref,
    gated_scan_ref,
    gated_step_ref,
    ssm_scan_ref,
    ssm_step_ref,
)

MAX_CHUNK = 128     # the kernel stages one chunk of up to 128 steps
NARROW_STATE = 128  # up to 128 state rows (N), a whole chunk of B and C fits beside the state
MAX_STATE = 1024    # the wide routes stream B and C in slabs along N up to 1024 rows
WIDE_SLAB = {"cuda_cores_wide": 16}   # columns of B and C per slab of the f32 wide route
# the bf16 wide route's slab by the longest chunk it takes: 128 columns up
# to a chunk of 64, 64 up to 128 (where 128 would not fit beside the state)
MMA_WIDE_SLABS = ((64, 128), (MAX_CHUNK, 64))
MMA_WIDE_WARPS = 8  # the wide mma route's warps a block, at every chunk
WIDE_STAGES = 2     # slabs of B and C in flight on the wide mma route
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
    wide routes: the state slice stays resident, and B and C stream through
    shared memory in slabs along N.  bf16 (``mma_wide``): 32 columns of P
    a block, ``MMA_WIDE_WARPS`` warps, a ring of
    ``WIDE_STAGES`` stages of a B and a C slab of (chunk rows padded to 16,
    ``slab`` + 8) bf16 (``MMA_WIDE_SLABS``: 128 columns up to a chunk of
    64, 64 beyond; y staged at the ring's end after the slabs), x in rows
    of 32 + 8 bf16 and the state in rows of 32 + 4 floats: at a chunk of
    128 exactly a block's 227 KB.  f32: the narrow grid and warps, a
    (chunk, 16 + 1) and a (chunk, 16) slab (``WIDE_SLAB``) beside the
    chunk's (chunk, chunk) scores.  Only the wide mma route's plan has a
    ``slab``: the C entry point reads it on that route alone."""
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
        slab = next(k for q, k in MMA_WIDE_SLABS if chunk <= q)
        smem = xy // 2 + WIDE_STAGES * 2 * qp * (slab + 8) * 2 + state
        return dict(route="mma_wide", warps=MMA_WIDE_WARPS, slab=slab, grid=grid, smem=smem)
    if dtype == torch.float32:
        if n <= NARROW_STATE:
            floats = n * 32 + chunk * 32 + chunk * (n + 1) + chunk * n + 4 * chunk + 8 * chunk
            return dict(route="cuda_cores", warps=8, grid=grid, smem=4 * floats)
        slab = WIDE_SLAB["cuda_cores_wide"]
        floats = (n * 32 + chunk * chunk + chunk * 32 + chunk * (slab + 1) + chunk * slab
                  + 4 * chunk)
        return dict(route="cuda_cores_wide", warps=8, grid=grid, smem=4 * floats)
    raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")


BWD_TILE = 32        # columns of P (state pass, dx) or of N (dB/dC) per f32 backward block
BWD_WIDE_ROWS = 64   # state rows per f32 state-pass block on the wide backward route
BWD_MMA_TILE = 64    # the bf16 kernels' tile of P or N and their slabs' width


def scan_backward_plan(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
                       dtype: torch.dtype) -> Dict[str, object]:
    """The backward kernel's launches for these shapes (``chunk`` is the
    wrapper's ``min(chunk, S)``), as its C entry point makes them: the
    route, each launch's kernel, grid and shared memory in bytes (those in
    ``dynamic`` dynamic, the rest static), the threads, and the f32
    workspace in floats with its parts.  Each chunk's cumulative log-decay
    (in step order), the state pass (the states entering and the state
    gradients leaving each chunk, both directions in one grid, each block
    walking the chunks), the scores (C B^T and dy x^T of each chunk and the
    per-step sums they give), dx, dB/dC per head, the finish (dlog_decay,
    din_scale), and the fixed-order sums of dB/dC over a group's heads and
    of dD.

    ``narrow`` (N <= 128) and ``wide`` (N up to 1024).  The wide route
    splits each chunk's score sums over N and P into ``splits`` ranges over
    as many blocks (the mLSTM has only 16 chunk-heads at 1 x 512 tokens),
    added in range order by the scores kernel, which writes S and G to the
    workspace.

    bf16 runs the state pass, scores, dx and dB/dC on the tensor cores
    (``*_mma``, mma.sync): a state-pass block owns a 64 x 64 tile of the
    state (two stages of slabs); dx and dB/dC blocks own 64 columns of P or
    N of a chunk-head and stream N or P in slabs of 64.  On the narrow route
    S and G never reach device memory: dx forms C B^T and dB/dC forms dy x^T
    themselves, and dB/dC's first N tile also forms C B^T and takes the
    per-step sums, so the route has no scores launch and its workspace no
    (B, NC, H, 2, Q, Q) part.  Where P % 8 != 0 a first launch pads x and
    dy's rows to a multiple of 8 in the workspace, so every slab is copied
    16 bytes at a time.  f32 runs on the CUDA cores: a narrow state-pass
    block holds its whole N x 32 state tile in registers (rows rounded to 64
    or 128), the wide one 64 rows; blocks own 32 columns.

    The workspace holds the padded x and dy where made, the states and their
    gradients (B, NC, H, N, P; bf16: P padded to 4 floats so their slices
    copy 16 bytes at a time), each head's dB and dC (B, S, H, N), S and G
    where kept, the split sums, per-step sums, per-tile parts, dD's parts
    and the cumulative log-decays."""
    if n > MAX_STATE:
        raise ValueError(f"state size N={n} > {MAX_STATE}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    mma = dtype == torch.bfloat16
    narrow = n <= NARROW_STATE
    tile = BWD_MMA_TILE if mma else BWD_TILE
    nc, pt, nt = -(-s // chunk), -(-p // tile), -(-n // tile)
    q = MAX_CHUNK
    bch = b * nc * h
    xp = -(-p // 8) * 8 if mma else p
    # the wide route's ranges: on the CUDA cores enough blocks for two on
    # each of the 132 SMs, on the tensor cores about 64 blocks (at least
    # two ranges); at most 16
    if narrow:
        ks = 1
    elif mma:
        ks = max(2, min(16, -(-64 // bch)))
    else:
        ks = max(1, min(16, -(-264 // bch)))
    f32_scores = 4 * (2 * q + 2 * q * 17 + q * (q + 1))
    grids = dict(cumsum=(-(-bch // 8),), dx=(pt, nc, h * b), dbc=(nt, nc, h * b),
                 finish=(nc, h, b))
    if mma:
        slab, state_slab, terms = q * (tile + 8) * 2, tile * (tile + 8) * 2, 2 * q * (q + 8) * 2
        f32_slab = tile * (tile + 4) * 4   # a state slice as it is copied, before its split
        per_chunk = 4 * 2 * q + 4 * 2 * 8   # cs, gi and the warps' two block sums
        sums = 2 * 4 * 8 * q   # the warps' step-sum columns
        kernels = dict(state="state_pass_mma", dx="dx_mma", dbc="dbc_mma")
        grids["state"] = (pt, nt, 2 * h * b)
        smem = dict(state=2 * (2 * slab + 4 * 2 * q), scores=f32_scores, scores_part=2 * slab,
                    dx=terms + 2 * slab + per_chunk,
                    dbc=terms + 4 * slab + 4 * state_slab + 2 * f32_slab + sums + per_chunk)
        dynamic = {"state", "scores", "scores_part", "dx", "dbc"}
        if xp != p:
            kernels["pad"] = "pad_rows"
            grids["pad"] = (min(4096, -(-(b * s * h * xp) // 256)),)
        if not narrow:
            kernels.update(scores_part="scores_part_mma", scores="scores")
    else:
        rows = (64 if n <= 64 else 128) if narrow else BWD_WIDE_ROWS
        kernels = dict(state="state_pass", scores="scores", dx="dx", dbc="dbc")
        grids["state"] = (pt, 1 if narrow else -(-n // BWD_WIDE_ROWS), 2 * h * b)
        smem = dict(state=4 * (3 * q + 32 * rows + 32 * BWD_TILE), scores=f32_scores,
                    scores_part=4 * 2 * q * 17,
                    dx=4 * (2 * q + 32 * (q + 4) + 32 * BWD_TILE + 256),
                    dbc=4 * (2 * q + 2 * 32 * (q + 4) + 2 * 32 * (BWD_TILE + 2) + 256))
        dynamic = {"scores"}
        if not narrow:
            kernels["scores_part"] = "scores_part"
    kernels.update(cumsum="cumsum", finish="finish", reduce_bc="reduce_bc", reduce_d="reduce_d")
    if "scores" in kernels:
        grids["scores"] = (nc, h, b)
    if ks > 1:
        grids["scores_part"] = (nc * ks, h, b)
    smem = {k: v for k, v in smem.items() if k in grids}
    smem.update(cumsum=4 * 8 * q, finish=4 * (4 * q + 1))
    sp = -(-p // 4) * 4 if mma else p   # the states' rows (bf16: padded for 16-byte copies)
    parts = dict(states=2 * bch * n * sp, head_dbc=2 * b * s * h * n, step_sums=bch * 2 * chunk,
                 tile_parts=bch * nt * 2 * chunk, tile_hdh=bch * nt,
                 dd_parts=bch * (1 if mma else pt),
                 cumsum=bch * chunk)
    if xp != p:
        parts["padded_x_dy"] = b * s * h * xp   # two bf16 arrays
    if not (mma and narrow):
        parts["s_and_g"] = bch * 2 * chunk * chunk
    if ks > 1:
        parts["split_sums"] = bch * ks * 2 * q * q
    return dict(route="narrow" if narrow else "wide", mma=mma, threads=256, finish_threads=q,
                kernels=kernels, grids=grids, smem=smem, dynamic=dynamic & set(smem),
                workspace=sum(parts.values()), workspace_parts=parts, splits=ks)


def vector_flags(route: str, p: int, n: int, x, bm, cm, y) -> int:
    """Which operands the kernel moves 16 bytes at a time.  The narrow mma
    route takes one flag for all of x, B, C and y (P and N multiples of 8,
    every pointer 16-byte aligned); the wide mma route a bit mask, bit 0 for
    x, y and the state's rows (P a multiple of 8: mLSTM's P = 1025 is not)
    and bit 1 for B and C (N a multiple of 8), each with its pointers
    aligned; the bf16 backward (``backward``, y standing for dy) the same
    mask.  The CUDA-core routes take none."""
    def aligned(*ts):
        return all(t.data_ptr() % 16 == 0 for t in ts)

    if route == "mma":
        return int(p % 8 == 0 and n % 8 == 0 and aligned(x, bm, cm, y))
    if route in ("mma_wide", "backward"):
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
        ROUTE_CODES[plan["route"]], plan["warps"], plan.get("slab", 0), plan["smem"], vec,
        stream,
    ))
    return y, hout


def gated_scan_backward_padded(dy, dh_final, x, ld, gi, Bm, Cm, D, h0, chunk: int, *,
                               acc: torch.dtype = torch.float32, mma: bool = False):
    """The plain backward with the forward's padding rule (identity steps,
    and a zero cotangent on them); contiguous outputs.  ``mma``: the mirror
    of the bf16 kernel's roundings (``gated_scan_backward_mma_ref``, f32)."""
    s = x.shape[1]
    eff = min(chunk, s)
    pad = (-s) % eff
    if pad:
        dy, x, ld, gi, Bm, Cm = (_pad_seq(t, pad) for t in (dy, x, ld, gi, Bm, Cm))
    if mma:
        grads = gated_scan_backward_mma_ref(dy, dh_final, x, ld, gi, Bm, Cm, D, h0, chunk=eff)
    else:
        grads = gated_scan_backward_ref(dy, dh_final, x, ld, gi, Bm, Cm, D, h0, chunk=eff,
                                        acc=acc)
    return tuple(None if t is None else (t[:, :s] if i < 5 else t).contiguous()
                 for i, t in enumerate(grads))


def gated_scan_backward_witness(dy, dh_final, x, ld, gi, Bm, Cm, D, h0, chunk: int):
    """The plain backward on f32 copies of the inputs and on f64 copies, each
    computed in its copies' dtype: (f32 grads, f64 grads), neither rounded
    to its input's dtype.  The f64 grads stand for the exact gradient, and
    their distance to the f32 grads is what f32 rounding alone moves the
    plain version by (most where terms of ~10^3 cancel to small values)."""
    args = (dy, dh_final, x, ld, gi, Bm, Cm, D, h0)
    return tuple(gated_scan_backward_padded(*(None if t is None else t.to(dt) for t in args),
                                            chunk, acc=dt)
                 for dt in (torch.float32, torch.float64))


def gated_scan_backward_cuda(
    dy: torch.Tensor,
    dh_final: Optional[torch.Tensor],
    x: torch.Tensor,
    ld: torch.Tensor,
    gi: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor],
    h0: Optional[torch.Tensor],
    chunk: int,
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel; raises on anything it does not take.
    Returns (dx, dld, dgi, dB, dC, dD, dh0) with dD and dh0 None when D and
    h0 are."""
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape or dy.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}")
    b, s, h, p = x.shape
    _, _, g, n = Bm.shape
    if tuple(Bm.shape[:2]) != (b, s) or g == 0 or h % g:
        raise ValueError(f"x {tuple(x.shape)} vs B/C {tuple(Bm.shape)}: need G | H")
    if tuple(ld.shape) != (b, s, h) or ld.shape != gi.shape:
        raise ValueError(f"log_decay {tuple(ld.shape)}, in_scale {tuple(gi.shape)} != {(b, s, h)}")
    if n > MAX_STATE:
        raise ValueError(f"state size N={n} > {MAX_STATE}")
    chunk = min(int(chunk), s)
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{MAX_CHUNK}")
    if not (Bm.dtype == Cm.dtype == dy.dtype == x.dtype):
        raise TypeError(f"x {x.dtype}, dy {dy.dtype}, B {Bm.dtype}, C {Cm.dtype}")
    f32 = [t for t in (ld, gi, D, h0, dh_final) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("log_decay, in_scale, D, h0 and dh_final must be float32")
    if D is not None and tuple(D.shape) != (h,):
        raise ValueError(f"D shape {tuple(D.shape)} != ({h},)")
    for name, t in (("h0", h0), ("dh_final", dh_final)):
        if t is not None and tuple(t.shape) != (b, h, n, p):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(b, h, n, p)}")
    ts = [dy, x, ld, gi, Bm, Cm, *(t for t in (D, h0, dh_final) if t is not None)]
    if not all(t.is_contiguous() and t.device == x.device for t in ts):
        raise ValueError("the scan backward kernel takes contiguous tensors on one device")
    plan = scan_backward_plan(b, s, h, p, g, n, chunk, x.dtype)
    if max(max(grid[1:], default=0) for grid in plan["grids"].values()) > 65535:
        raise ValueError(f"grids {plan['grids']} over the launch limit")
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    dld = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    dgi = torch.empty_like(dld)
    dD = None if D is None else torch.empty_like(D)
    dh0 = None if h0 is None else torch.empty_like(h0)
    ws = torch.empty((plan["workspace"],), dtype=torch.float32, device=x.device)
    fn = library.entry("ssm_scan_backward")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    library.LAUNCHES["ssm_scan_backward"] += 1

    def ptr(t):
        return None if t is None else t.data_ptr()

    vec = vector_flags("backward", p, n, x, Bm, Cm, dy) if plan["mma"] else 0
    library.check("ssm_scan_backward", fn(
        dy.data_ptr(), ptr(dh_final), x.data_ptr(), ld.data_ptr(), gi.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), ptr(D), ptr(h0), dx.data_ptr(), dld.data_ptr(),
        dgi.data_ptr(), dB.data_ptr(), dC.data_ptr(), ptr(dD), ptr(dh0), ws.data_ptr(),
        plan["workspace"], b, s, h, p, g, n, chunk, library.dtype_code(x.dtype),
        0 if plan["route"] == "narrow" else 1, max(plan["smem"][k] for k in plan["dynamic"]),
        vec, stream,
    ))
    return dx, dld, dgi, dB, dC, dD, dh0


@torch.library.custom_op("repro_torch::gated_scan_backward", mutates_args=())
def gated_scan_backward_op(
    dy: torch.Tensor,
    dh_final: Optional[torch.Tensor],
    x: torch.Tensor,
    log_decay: torch.Tensor,
    in_scale: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor],
    h0: Optional[torch.Tensor],
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """(dx, dlog_decay, din_scale, dB, dC, dD, dh0).  A custom op returns no
    optional tensor, so dD and dh0 come back empty, shape (0,), when D and
    h0 are None."""
    if x.device.type == "cpu":
        grads = gated_scan_backward_padded(dy, dh_final, x, log_decay, in_scale, Bm, Cm, D, h0,
                                           chunk)
    elif x.device.type == "cuda":
        grads = gated_scan_backward_cuda(dy, dh_final, x, log_decay, in_scale, Bm, Cm, D, h0,
                                         chunk)
    else:
        raise ValueError(f"gated_scan_backward runs on cpu or cuda tensors, not {x.device}")
    return tuple(x.new_empty((0,), dtype=torch.float32) if t is None else t for t in grads)


@gated_scan_backward_op.register_fake
def _(dy, dh_final, x, log_decay, in_scale, Bm, Cm, D, h0, chunk):
    def opt(t):
        return x.new_empty((0,), dtype=torch.float32) if t is None else torch.empty_like(t)

    return (torch.empty_like(x), torch.empty_like(log_decay), torch.empty_like(in_scale),
            torch.empty_like(Bm), torch.empty_like(Cm), opt(D), opt(h0))


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


def _scan_setup(ctx, inputs, output):
    x, log_decay, in_scale, Bm, Cm, D, h0, chunk = inputs
    ctx.save_for_backward(x, log_decay, in_scale, Bm, Cm, D, h0)
    ctx.chunk = chunk
    # an unused output's cotangent stays None: training never reads the
    # final state, and the kernel then adds no dh_final
    ctx.set_materialize_grads(False)


def _scan_grad(ctx, dy, dh_final):
    x, log_decay, in_scale, Bm, Cm, D, h0 = ctx.saved_tensors
    if dy is None:
        dy = torch.zeros_like(x)
    dx, dld, dgi, dB, dC, dD, dh0 = gated_scan_backward_op(
        dy.contiguous(), None if dh_final is None else dh_final.contiguous(), x, log_decay,
        in_scale, Bm, Cm, D, h0, ctx.chunk)
    return (dx, dld, dgi, dB, dC, None if D is None else dD, None if h0 is None else dh0, None)


torch.library.register_autograd(gated_scan_op, _scan_grad, setup_context=_scan_setup)


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
    "scan_backward_plan", "gated_scan_backward_cuda", "gated_scan_backward_op",
    "gated_scan_backward_mma_ref", "gated_scan_backward_padded", "gated_scan_backward_ref",
    "gated_scan_backward_witness",
    "ssm_scan", "ssm_step", "gated_scan_mma_ref", "gated_scan_ref", "gated_step_ref",
    "ssm_scan_ref", "ssm_step_ref",
]
