"""Time variants of the gated scan's bf16 tensor-core kernel on one NVIDIA GPU.

    python3 tools/scan_variants.py

Builds ``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu`` from this
checkout several times, each a text edit of the source: the kernel as it is
(P tiles of 32 columns), P tiles of 64 and 16, the accurate ``expf`` in place
of ``exp_ftz``, each of its phases compiled out (the y rows, the state
update, the staging of x, B and C, the final state's store) and an empty
kernel of the same grid.  Each variant is launched through the library's C
entry point at zamba2-1.2b's shapes (64 heads, P = N = 64, one group; S = 16,
64 and 300), checked against the plain version (the whole variants; the
ratio of max |d| to the bf16 tolerance is printed), and timed as 50 launches
in a CUDA graph, twice, in turns.  A phase compiled out gives wrong outputs:
its time says what that phase costs.  Prints one line per shape.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

TILE = "constexpr int kMmaTileP = 32;"
# (start, end) of each phase in the kernel's source, compiled out by a macro
PHASES = {
    "NO_Y": ("    // ---- y: warp w owns rows", "    // C.h has read the entering state"),
    "NO_STATE": ("    mma_update_state<kWarpsT>(hs, bs, ldn,", "    __syncthreads();  // y is staged"),
    "NO_STAGE": ("    mma_stage_x(xs, x + (row0 * nh + head) * p + p0, xstep, qp, valid, pw, vec, tid",
                 "    if (warp == 0) chunk_scan("),
    "NO_HOUT": ("  mma_store_state(hout, hs, hbase, n, p, pw, vec, tid", "\n}\n\n// ----"),
}


def variants(src: str) -> dict:
    """name -> (source, P tile) of every variant."""
    head_at = src.index("template <int kWarpsT>")
    head, body = src[:head_at], src[head_at:]
    guarded = body
    for macro, (start, end) in PHASES.items():
        i = guarded.index(start)
        j = guarded.index(end, i)
        sep = "" if guarded[j - 1] == "\n" else "\n"
        guarded = guarded[:i] + f"#ifndef {macro}\n" + guarded[i:j] + sep + "#endif\n" + guarded[j:]
    guarded = guarded.replace(
        "  extern __shared__ __align__(16) unsigned char smem_raw[];\n",
        "  extern __shared__ __align__(16) unsigned char smem_raw[];\n#ifdef EMPTY\n  return;\n#endif\n",
        1)
    guarded = head + guarded
    out = {"kernel (32 columns)": (src, 32),
           "64 columns": (src.replace(TILE, "constexpr int kMmaTileP = 64;"), 64),
           "16 columns": (src.replace(TILE, "constexpr int kMmaTileP = 16;"), 16),
           "accurate expf": (head + body.replace("exp_ftz(", "expf("), 32)}
    for macro in (*PHASES, "EMPTY"):
        out[macro.lower()] = (f"#define {macro}\n" + guarded, 32)
    assert all(TILE in s or t != 32 for s, t in out.values())
    return out


def build(variant_srcs: dict, workdir: str) -> dict:
    from repro_torch.kernels import library

    procs = {}
    for k, (name, (text, _)) in enumerate(variant_srcs.items()):
        cu = os.path.join(workdir, f"v{k}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(workdir, f"libv{k}.so")
        procs[name] = (so, subprocess.Popen(
            [library._nvcc(), *library.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        fn = getattr(ctypes.CDLL(so), "repro_ssm_scan")
        fn.argtypes = library._ARGTYPES["repro_ssm_scan"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def graph_ms(fn, reps: int = 50) -> float:
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


def smem_bytes(tile: int, q: int, n: int) -> int:
    """ops.py:scan_plan's shared memory at another P tile."""
    qp, np_ = -(-q // 16) * 16, -(-n // 16) * 16
    return 2 * qp * (tile + 8) * 2 + 2 * qp * (np_ + 8) * 2 + np_ * (tile + 4) * 4 + 2 * qp * 4


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.kernels import library
    from repro_torch.kernels.ssm_scan import gated_scan_padded, scan_plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    with open(library.source_path("ssm_scan")) as f:
        src = f.read()
    vs = variants(src)
    with tempfile.TemporaryDirectory() as workdir:
        fns = build(vs, workdir)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        b, h, p, g, n = 1, 64, 64, 1, 64
        for s in (16, 64, 300):
            chunk = min(128, s)
            x = randn(b, s, h, p).to(torch.bfloat16)
            bm, cm = randn(b, s, g, n).to(torch.bfloat16), randn(b, s, g, n).to(torch.bfloat16)
            dt = F.softplus(randn(b, s, h) - 2.0)
            ld = (dt * -torch.linspace(1.0, 16.0, h, device="cuda")).contiguous()
            d = torch.ones(h, device="cuda")
            y_r, h_r = gated_scan_padded(x, ld, dt, bm, cm, d, None, chunk)
            warps = scan_plan(b, s, h, p, g, n, chunk, torch.bfloat16)["warps"]
            calls = {}
            for name, fn in fns.items():
                y, hout = torch.empty_like(x), torch.empty(b, h, n, p, device="cuda")
                args = (x.data_ptr(), ld.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                        d.data_ptr(), None, y.data_ptr(), hout.data_ptr(), b, s, h, p, g, n,
                        chunk, 1, 1, warps, 0, smem_bytes(vs[name][1], chunk, n), 1)

                def call(fn=fn, args=args):
                    # the stream of the moment: a graph captures on its own stream
                    stream = torch.cuda.current_stream().cuda_stream
                    library.check("ssm_scan", fn(*args, stream))
                calls[name] = (call, y, hout)
            times = {name: [] for name in calls}
            for order in (list(calls), list(reversed(calls))):
                for name in order:
                    times[name].append(graph_ms(calls[name][0]) * 1e3)
            parts = []
            for name, (call, y, hout) in calls.items():
                call()
                torch.cuda.synchronize()
                err = max(((y.float() - y_r.float()).abs() / (2e-2 + 2e-2 * y_r.float().abs()))
                          .max().item(),
                          ((hout - h_r).abs() / (2e-2 + 2e-2 * h_r.abs())).max().item())
                parts.append(f"{name} {times[name][0]:.2f}/{times[name][1]:.2f} us "
                             f"(max|d|/tol {err:.3g})")
            print(f"scan variants S={s} chunk {chunk}: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
