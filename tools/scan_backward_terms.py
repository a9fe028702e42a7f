"""Hold the gated scan's bf16 backward kernel, and a variant of it that keeps
one bf16 term of each split operand, against the plain mirror of the
kernel's roundings, on one NVIDIA GPU.

    python3 tools/scan_backward_terms.py

Builds ``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_backward.cu`` from
this checkout as it is and as a variant: a copy of its ``csrc/`` with
``mma_bf16.cuh``'s ``split2`` giving a zero low term, so S, G, diag(w) B,
diag(e) C, H and dH enter their products rounded to bf16 once.  Runs both on
every bf16 case of ``chip_smoke.py``'s ``SCAN_BWD_CASES`` (its inputs, from
seed 0) and prints each gradient's distance to the mirror
(``gated_scan_backward_mma_ref``) in the measure phase 2 holds
(``chip_smoke.mirror_distances``) beside ``chip_smoke.MIRROR_TOL``, and the
same for the plain backward in f32 (no bf16 products at all).  Then runs
phase 15a's bf16 scan families (``chip_smoke.phase_scan_backward_in_model``),
each model trained with the kernel, the plain backward and the mirror.
Exits non-zero if the kernel is over ``MIRROR_TOL`` on any gradient, or the
variant within it on every gradient of a case.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

ONE_TERM = ("  lo = pack_bf16(__floats2bfloat162_rn(a - hf.x, b - hf.y));", "  lo = 0u;")


def build_one_term(workdir: str):
    """The backward kernel's C entry point built with one bf16 term per split
    operand."""
    from repro_torch.kernels import library

    src = library.source_path("ssm_scan_backward")
    csrc = os.path.join(workdir, "csrc")
    shutil.copytree(src.parent, csrc)
    header = os.path.join(csrc, "mma_bf16.cuh")
    with open(header) as f:
        text = f.read()
    if ONE_TERM[0] not in text:
        sys.exit(f"{header}: split2's low term not found")
    with open(header, "w") as f:
        f.write(text.replace(ONE_TERM[0], ONE_TERM[1]))
    so = os.path.join(workdir, "libone_term.so")
    out = subprocess.run([library._nvcc(), *library.NVCC_FLAGS, "-o", so,
                          os.path.join(csrc, src.name)], capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"the one-term variant did not build:\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(so).repro_ssm_scan_backward
    fn.argtypes = library._ARGTYPES["repro_ssm_scan_backward"]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    library, dev = cs.setup()
    from repro_torch.kernels.ssm_scan import gated_scan_backward_op, gated_scan_backward_padded

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    library.build_all()
    kernel = library.entry("ssm_scan_backward")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    ok = True
    with tempfile.TemporaryDirectory() as workdir:
        one_term = build_one_term(workdir)
        for shape, dtype, with_d, with_h0, with_dh, mlstm in cs.SCAN_BWD_CASES:
            if dtype != torch.bfloat16:
                continue
            b, s, h, p, g, n, chunk = shape
            x, ld, gi, bm, cm, d = cs.scan_inputs(randn, b, s, h, p, g, n, dtype, mlstm=mlstm,
                                                  key_scale=n ** -0.5 if mlstm else 1.0)
            dy = randn(b, s, h, p, dtype=dtype)
            h0 = randn(b, h, n, p, dtype=torch.float32) if with_h0 else None
            dh = randn(b, h, n, p, dtype=torch.float32) if with_dh else None
            args = (dy, dh, x, ld, gi, bm, cm, d, h0, chunk)
            mirror = gated_scan_backward_padded(
                *(a.float() if isinstance(a, torch.Tensor) else a for a in args), mma=True)
            runs = {}
            for name, fn in (("kernel", kernel), ("one-term variant", one_term)):
                library._entries["ssm_scan_backward"] = fn
                runs[name] = cs.mirror_distances(gated_scan_backward_op(*args), mirror)
            library._entries["ssm_scan_backward"] = kernel
            plain = gated_scan_backward_padded(
                *(a.float() if isinstance(a, torch.Tensor) else a for a in args))
            runs["plain backward, f32"] = cs.mirror_distances(
                tuple(t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(plain)), mirror)
            tol = cs.MIRROR_TOL
            over = {name: [k for k, v in r.items()
                           if not v <= tol[torch.float32 if k in ("dld", "dgi", "dD", "dh0")
                                           else torch.bfloat16]]
                    for name, r in runs.items()}
            ok &= not over["kernel"] and bool(over["one-term variant"])
            print(f"scan backward bf16 x/dy ({b},{s},{h},{p}), B/C ({b},{s},{g},{n}), chunk "
                  f"{chunk}: distance to the mirror (f32 outputs max |d| / (rms + |mirror|), "
                  f"bf16 outputs relative L2; MIRROR_TOL {tol[torch.float32]:g} / "
                  f"{tol[torch.bfloat16]:g}):")
            for name, r in runs.items():
                print(f"  {name}: " + ", ".join(f"{k} {v:.3g}" for k, v in r.items())
                      + f"; over: {over[name] or 'none'}")
    cs.phase_scan_backward_in_model(dev)
    print(f"kernel within MIRROR_TOL on every gradient and the one-term variant over it on "
          f"every case: {ok}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
