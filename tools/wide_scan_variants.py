"""Time the wide gated scan's bf16 kernel at each (warps, P tile, slab) on one NVIDIA GPU.

    python3 tools/wide_scan_variants.py [--parent DIR] [--phases]

The kernel in ``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu`` has 8
warps and 32 columns of P a block, and slabs of 128 or 64 columns of B and
C.  For each other combination of 4 or 8 warps and P tiles of 16 or 32
columns this tool writes a copy of the source with those constants changed
(``kWideWarps``, ``kMmaTileP``) and slabs of 32, 64 and 128 instantiated,
and builds every copy at once.  Each combination that fits (16 rows of the
chunk a warp, a block's shared memory; no 16-column tile at slabs of 128)
is launched through the C entry point at xlstm-1.3b's two shapes of the
mLSTM scan: the stateless bucket (x (1,64,4,1025), B/C (1,64,4,1024), chunk
64) and the training forward (x (1,512,4,1025), chunk 128).  Each is held
against ``gated_scan_mma_ref`` (relative L2 of y and of the final state,
within 1e-3; at 16 columns the kernel keeps the same sums, so the same
mirror), two launches bitwise equal, and timed as a CUDA graph of 20
launches, in turns: the list forward, then backward.  ``--parent DIR``: a
checkout of an earlier tree (unpack it under ``build/``), whose wide kernel
is built from its own source and timed in the same turns at its own plan
(its entry point has no slab argument).  ``--phases``: also builds the
kernel with each phase compiled out (the scores, the state update, the
slabs' copies, the staging of x, the y rows and their store; and an empty
kernel of the same grid) and times those at the combinations named in
``PHASE_AT``: a phase compiled out gives wrong outputs, and its time says
what that phase costs.  Prints one line per combination and shape, with the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SMEM_MAX = 232448
# (start, end) of each phase of the wide kernel's source, compiled out by a macro
PHASES = {
    "NO_SCORES": ("      if (rows_live) {\n        mma_scores<kWarpsT>(",
                  "      // C.h has read the slab's rows"),
    "NO_UPDATE": ("      mma_update_state<kWarpsT>(hs + n0 * kLdh",
                  "    }\n\n    __syncthreads();  // every slab is consumed"),
    "NO_COPIES": ("  if (vec) {\n    const int nv = kw / 8;",
                  "  cp_async_commit();  // one group a slab"),
    "NO_X": ("    mma_stage_x(xs, x + (row0 * nh + head) * p + p0",
             "#pragma unroll\n    for (int k = 0; k < kWideStages - 1"),
    "NO_Y": ("    if (rows_live && half == 0) {\n      mma_y_rows<kWarpsT>(",
             "    has_h = true;\n  }\n  // the last chunk"),
}
PHASE_AT = ((8, 32, 64), (8, 32, 128))   # the kernel's own (warps, tile): the source as it is
SHAPES = ((64, 64), (512, 128))   # (S, chunk) at B 1, H = G 4, P 1025, N 1024
SLABS = (32, 64, 128)
REL_TOL = 1e-3
# the constants a variant's copy of the source changes, as the source has them
WARPS_LINE = "constexpr int kWideWarps = 8;"
TILE_LINE = "constexpr int kMmaTileP = 32;"
SLABS_LINE = "#define REPRO_WIDE_SLABS(X) X(128) X(64)"


def build(src: str, out: str, defines=()) -> ctypes.CDLL:
    from repro_torch.kernels import library

    proc = subprocess.run([library._nvcc(), *library.NVCC_FLAGS, *defines, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{src} did not build:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(out)


def variant_source(src: str, warps: int, tile: int) -> str:
    """The source with ``warps`` warps and ``tile`` columns of P a wide
    block, and every slab of ``SLABS`` instantiated."""
    for line in (WARPS_LINE, TILE_LINE, SLABS_LINE):
        assert src.count(line) == 1, line
    slabs = " ".join(f"X({k})" for k in SLABS)
    return (src.replace(WARPS_LINE, f"constexpr int kWideWarps = {warps};")
            .replace(TILE_LINE, f"constexpr int kMmaTileP = {tile};")
            .replace(SLABS_LINE, f"#define REPRO_WIDE_SLABS(X) {slabs}"))


def phase_source(src: str) -> str:
    """The source with each phase of the wide kernel inside ``#ifndef`` of
    its macro, and ``EMPTY`` returning at the kernel's start."""
    for macro, (start, end) in PHASES.items():
        i = src.index(start)
        j = src.index(end, i)
        src = src[:i] + f"#ifndef {macro}\n" + src[i:j] + "#endif\n" + src[j:]
    head = "  const WideSmem m = wide_smem(q, n, kSlabW);\n"
    assert src.count(head) == 1
    return src.replace(head, "#ifdef EMPTY\n  return;\n#endif\n" + head)


def graph_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def wide_smem(q: int, n: int, tile: int, slab: int) -> int:
    """The C source's wide_smem at a tile and slab (two stages, y in the
    free one)."""
    qp, np_ = -(-q // 16) * 16, -(-n // 16) * 16
    return qp * (tile + 8) * 2 + 2 * 2 * qp * (slab + 8) * 2 + np_ * (tile + 4) * 4 + 2 * qp * 4


def parent_smem(q: int, n: int) -> int:
    """The earlier wide kernel's shared memory: 32 columns, one B and one C
    slab of 64."""
    qp, np_ = -(-q // 16) * 16, -(-n // 16) * 16
    return 2 * qp * 40 * 2 + 2 * qp * 72 * 2 + np_ * 36 * 4 + 2 * qp * 4


def rel_l2(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.kernels import library
    from repro_torch.kernels.ssm_scan.ops import scan_plan, vector_flags
    from repro_torch.kernels.ssm_scan.ref import gated_scan_mma_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    argtypes = library._ARGTYPES["repro_ssm_scan"]
    with open(library.source_path("ssm_scan")) as f:
        source = f.read()
    csrc = os.path.dirname(library.source_path("ssm_scan"))
    # every copy beside the source (it includes mma_bf16.cuh), built at once
    jobs = {(w, t): (variant_source(source, w, t), ()) for w in (4, 8) for t in (16, 32)}
    if args.phases:
        for macro in (*PHASES, "EMPTY"):
            jobs[macro.lower()] = (phase_source(source), (f"-D{macro}",))
    if args.parent:
        jobs["parent"] = (None, ())
    with tempfile.TemporaryDirectory() as workdir:
        srcs = []
        try:
            def build_job(key):
                text, defines = jobs[key]
                tag = key if isinstance(key, str) else f"w{key[0]}t{key[1]}"
                if text is None:
                    src = os.path.join(args.parent,
                                       "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu")
                else:
                    src = os.path.join(csrc, f".variant_{tag}.cu")
                    srcs.append(src)
                    with open(src, "w") as f:
                        f.write(text)
                fn = build(src, os.path.join(workdir, f"lib{tag}.so"), defines).repro_ssm_scan
                # the parent's entry point has no slab argument
                fn.argtypes = argtypes[:19] + argtypes[20:] if text is None else argtypes
                fn.restype = ctypes.c_int
                return key, fn

            with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
                built = dict(pool.map(build_job, jobs))
        finally:
            for src in srcs:
                if os.path.exists(src):
                    os.remove(src)
        old = built.pop("parent", None)
        phased = {k: v for k, v in built.items() if isinstance(k, str)}
        gen = torch.Generator(device="cuda").manual_seed(0)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        b, h, p, g, n = 1, 4, 1025, 4, 1024
        bf = torch.bfloat16
        for s, chunk in SHAPES:
            x = randn(b, s, h, p).to(bf)
            bm = (randn(b, s, g, n) * n ** -0.5).to(bf)
            cm = randn(b, s, g, n).to(bf)
            ld = F.logsigmoid(randn(b, s, h) + 3.0).contiguous()
            gi = torch.exp(0.3 * randn(b, s, h) - 1.0).contiguous()
            y_m, h_m = gated_scan_mma_ref(x, ld, gi, bm, cm, None, chunk=chunk)
            plan = scan_plan(b, s, h, p, g, n, chunk, bf)
            calls = {}
            for warps in (4, 8):
                for tile in (16, 32):
                    for slab in SLABS:
                        smem = wide_smem(chunk, n, tile, slab)
                        if slab == 128 and tile == 16:
                            continue
                        if warps * 16 < -(-chunk // 16) * 16 or smem > SMEM_MAX:
                            continue
                        y, hout = torch.empty_like(x), torch.empty(b, h, n, p, device="cuda")
                        vec = vector_flags("mma_wide", p, n, x, bm, cm, y)
                        cargs = (x.data_ptr(), ld.data_ptr(), gi.data_ptr(), bm.data_ptr(),
                                 cm.data_ptr(), None, None, y.data_ptr(), hout.data_ptr(),
                                 b, s, h, p, g, n, chunk, 1, 2, warps, slab, smem, vec)
                        mine = (warps, tile, slab) == (plan["warps"], 32, plan["slab"])
                        name = f"{warps} warps, {tile} columns, slabs of {slab}" + \
                            (" (plan)" if mine else "")
                        calls[name] = (built[(warps, tile)], cargs, y, hout, smem, tile)
                        if (warps, tile, slab) in PHASE_AT:
                            for pname, pf in phased.items():
                                calls[f"{warps} warps, {tile} columns, slabs of {slab}, "
                                      f"{pname}"] = (pf, cargs, y, hout, smem, tile)
            if old is not None:
                y, hout = torch.empty_like(x), torch.empty(b, h, n, p, device="cuda")
                vec = vector_flags("mma_wide", p, n, x, bm, cm, y)
                smem = parent_smem(chunk, n)
                cargs = (x.data_ptr(), ld.data_ptr(), gi.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                         None, None, y.data_ptr(), hout.data_ptr(), b, s, h, p, g, n, chunk, 1, 2,
                         4 if chunk <= 64 else 8, smem, vec)
                calls["parent (32 columns, slabs of 64, no ring)"] = (old, cargs, y, hout, smem, 32)

            def launcher(f, cargs):
                def call():
                    # the stream of the moment: a graph captures on its own stream
                    library.check("ssm_scan", f(*cargs, torch.cuda.current_stream().cuda_stream))
                return call

            times = {name: [] for name in calls}
            for order in (list(calls), list(reversed(calls))):
                for name in order:
                    times[name].append(graph_ms(launcher(*calls[name][:2])) * 1e3)
            for name, (f, cargs, y, hout, smem, tile) in calls.items():
                launcher(f, cargs)()
                y1, h1 = y.clone(), hout.clone()
                launcher(f, cargs)()
                torch.cuda.synchronize()
                same = torch.equal(y, y1) and torch.equal(hout, h1)
                ey, eh = rel_l2(y, y_m), rel_l2(hout, h_m)
                ok = same and ey <= REL_TOL and eh <= REL_TOL or f in phased.values()
                per_sm = 233472 // (smem + 1024)
                print(f"wide scan S={s} chunk {chunk} {name}: {times[name][0]:.2f} / "
                      f"{times[name][1]:.2f} us; grid {-(-p // tile)} x {h}, {smem} B shared "
                      f"({per_sm} an SM); rel L2 to the mirror y {ey:.3g}, h {eh:.3g}; two "
                      f"launches bitwise {same}{'' if ok else '  <-- FAILS'}", flush=True)
            del x, bm, cm, ld, gi, y_m, h_m, calls


if __name__ == "__main__":
    main()
