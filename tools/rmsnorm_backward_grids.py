"""Time the rmsnorm backward's long rows at other launches of its vector route on one NVIDIA GPU.

    python3 tools/rmsnorm_backward_grids.py

At the training path's rows longer than 1024 (bf16: zamba2-1.2b's d_model
2048 and d_inner 4096, minicpm3's 2560 and mixtral-8x7b's 4096 at 4 x 512
tokens, and 512 rows of 4096) the library's C entry point is launched with
``rmsnorm_backward_plan``'s plan and with other launches of the same
kernel: the vector route with the whole block on a row at 4, 8 and 16
warps (the vectors a thread to match) and one, two and four blocks an SM,
and the scalar route (which every row longer than 1024 took before).  Each launch is
held against ``rmsnorm_backward_ref`` within 2e-2 and against a second
launch, bitwise, and timed as a CUDA graph of 20 launches, in turns with
``F.rms_norm``'s autograd backward (library first and last).  Prints one
line per shape and launch, with the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SHAPES = ((2048, 2048), (2048, 2560), (2048, 4096), (512, 4096))
TOL = 2e-2
SMS = 132
HBM_BYTES_PER_S = 3.35e12


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


def plans(rows: int, d: int) -> dict:
    """name -> plan: the planned launch, the block route's others, the scalar route."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_backward_plan

    out = {"plan": rmsnorm_backward_plan(rows, d, torch.bfloat16)}
    nvec = d // 8
    for warps in (4, 8, 16):
        vecs = -(-nvec // (32 * warps))
        if vecs > 4 or (vecs - 1) * 32 * warps >= nvec:
            continue
        for per_sm in (1, 2, 4):
            rpb = 2 * -(-rows // (2 * SMS * per_sm))
            out[f"{warps} warps x {vecs} vectors, {per_sm} an SM"] = dict(
                route="vector", threads=32 * warps, lanes=32 * warps, vecs=vecs,
                rows_per_block=rpb, grid=-(-rows // rpb))
    out["scalar route"] = rmsnorm_backward_plan(rows, d, torch.bfloat16, aligned=False)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.kernels import library
    from repro_torch.kernels.rmsnorm.ops import BWD_ROUTE_CODES
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    fn = library.entry("rmsnorm_backward")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    for rows, d in SHAPES:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(bf)
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(bf)
        w = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1.0).to(bf)
        rx, rw = rmsnorm_backward_ref(dy, x, w, 1e-6, 0.0)
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)

        def lib_ms():
            fwd = lambda: F.rms_norm(xg, (d,), wg, 1e-6)  # noqa: E731
            return (graph_ms(lambda: torch.autograd.grad(fwd(), (xg, wg), dy))
                    - graph_ms(fwd))

        bound = (3 * rows * d * 2 + 2 * d * 2) / HBM_BYTES_PER_S * 1e6
        first = lib_ms()
        for name, plan in plans(rows, d).items():
            dx, dw = torch.empty_like(x), torch.empty_like(w)
            partial = torch.empty(plan["grid"], d, device="cuda")

            def call(plan=plan, dx=dx, dw=dw, partial=partial):
                library.check("rmsnorm_backward", fn(
                    dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                    partial.data_ptr(), rows, d, 1e-6, 0.0, 1, BWD_ROUTE_CODES[plan["route"]],
                    plan["threads"], plan["lanes"], plan["vecs"], plan["rows_per_block"],
                    plan["grid"], torch.cuda.current_stream().cuda_stream))

            call()
            torch.cuda.synchronize()
            d1, w1 = dx.clone(), dw.clone()
            err = max(float((dx.float() - rx.float()).abs().max() / rx.float().abs().max()),
                      float((dw.float() - rw.float()).abs().max() / rw.float().abs().max()))
            call()
            torch.cuda.synchronize()
            same = torch.equal(d1, dx) and torch.equal(w1, dw)
            us = graph_ms(call) * 1e3
            ok = same and err <= TOL
            print(f"rmsnorm_backward ({rows},{d}) bf16 {name} ({plan['route']}, "
                  f"{plan['threads']} threads x {plan['vecs']} vectors, grid {plan['grid']}): "
                  f"{us:.2f} us ({bound / us:.0%} of the {bound:.2f} us byte bound); max|d| / "
                  f"max|ref| {err:.3g}; two launches bitwise {same}{'' if ok else '  <-- FAILS'}",
                  flush=True)
        last = lib_ms()
        print(f"rmsnorm_backward ({rows},{d}) bf16 F.rms_norm autograd backward: "
              f"{first * 1e3:.2f} / {last * 1e3:.2f} us", flush=True)


if __name__ == "__main__":
    main()
