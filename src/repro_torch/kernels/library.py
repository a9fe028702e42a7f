"""Build and load the hand-written Hopper kernels.

Each kernel's CUDA C++ source (``kernels/<op>/csrc/<name>.cu``, where a
backward kernel lives beside its forward op's) compiles
with one ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``: a build of seconds, where a
source that includes PyTorch's headers takes minutes.  The first use builds
every kernel, one ``nvcc`` per source, all started together, into
``build/kernels/`` at the root of the checkout (a library is named by the
hash of its ``csrc/`` files and the nvcc flags, so an edited source or
header rebuilds and an unchanged one is reused).  Nothing here runs on import: the CPU tests import this module on
machines that have no ``nvcc``.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: each wrapper
adds one where it calls its C entry point, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

KERNELS = ("rmsnorm", "decode_attention", "flash_attention", "ssm_scan",
           "rmsnorm_backward", "flash_attention_backward", "ssm_scan_backward")
# the op package each kernel's source lives in, where it is not its own name
_OP_DIR = {"rmsnorm_backward": "rmsnorm", "flash_attention_backward": "flash_attention",
           "ssm_scan_backward": "ssm_scan"}

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# C signatures: every entry point returns cudaGetLastError() as an int
_C = ctypes
_ARGTYPES = {
    # x, scale, y, rows, d, eps, offset, dtype, route, threads,
    # rows_per_block, grid, stream (the launch of rmsnorm_plan)
    "repro_rmsnorm": [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_longlong, _C.c_int,
        _C.c_float, _C.c_float, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
        _C.c_longlong, _C.c_void_p,
    ],
    # q, k, v, kv_len, out, part (f32 split scratch, or null), b, hq, hkv, s,
    # d, window, split_len, dtype, stream
    "repro_decode_attention": [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_void_p, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
        _C.c_int, _C.c_int, _C.c_int, _C.c_void_p,
    ],
    # q, k, v, out, b, sq, sk, hq, hkv, d, causal, window, logit_cap,
    # q_offset, dtype, stream
    "repro_flash_attention": [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
        _C.c_int, _C.c_int, _C.c_float, _C.c_int, _C.c_int, _C.c_void_p,
    ],
    # x, ld, gi, B, C, D (or null), h0 (or null), y, h_out, b, s, h, p, g, n,
    # chunk, dtype, route, warps, slab, smem bytes, vec, stream: x, B, C and
    # y in the working dtype, the rest f32; route, warps, slab and smem from
    # scan_plan
    # dy, x, scale, dx, dscale, partial (f32 (grid, d) scratch), rows, d, eps,
    # offset, dtype, route, threads, lanes, vecs, rows_per_block, grid,
    # stream (rmsnorm_backward_plan)
    "repro_rmsnorm_backward": [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_longlong, _C.c_int, _C.c_float, _C.c_float, _C.c_int, _C.c_int, _C.c_int,
        _C.c_int, _C.c_int, _C.c_int, _C.c_longlong, _C.c_void_p,
    ],
    # dout, q, k, v, out, dq, dk, dv, stats (f32 (2, b, hq, sq) scratch), b,
    # sq, sk, hq, hkv, d, causal, window, logit_cap, q_offset, dtype, stream
    "repro_flash_attention_backward": [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
        _C.c_int, _C.c_int, _C.c_float, _C.c_int, _C.c_int, _C.c_void_p,
    ],
    # dy, dh_final (or null), x, ld, gi, B, C, D (or null), h0 (or null), dx,
    # dld, dgi, dB, dC, dD (or null), dh0 (or null), workspace, its floats,
    # b, s, h, p, g, n, chunk, dtype, route, scores smem bytes, vec, stream
    # (scan_backward_plan, vector_flags)
    "repro_ssm_scan_backward": [
        *[_C.c_void_p] * 17, _C.c_longlong,
        _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
        _C.c_int, _C.c_int, _C.c_int, _C.c_void_p,
    ],
    "repro_ssm_scan": [
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
        _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int,
        _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_int, _C.c_void_p,
    ],
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# each library's ``-Xptxas -v`` summary from the last verbose build
PTXAS: Dict[str, List[str]] = {}
_entries: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def source_path(name: str) -> Path:
    return _PKG / _OP_DIR.get(name, name) / "csrc" / f"{name}.cu"


def build_digest(name: str) -> str:
    """Hash of what a kernel's library is built from: its ``.cu``, every
    header under its ``csrc/`` and the nvcc flags, so an edited source,
    header or flag rebuilds it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    src = source_path(name)
    for f in sorted(p for p in src.parent.rglob("*")
                    if p.is_file() and (p == src or p.suffix != ".cu")):
        h.update(f.relative_to(src.parent).as_posix().encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:12]


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{build_digest(name)}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return found


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all running at once.  Returns the library path of each kernel.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report, one
    line per kernel function (also kept in ``PTXAS``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in KERNELS}
    procs = {}
    for name, out in paths.items():
        if out.exists() and not verbose:
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            PTXAS[name] = ptxas_summary(log)
            print(f"[nvcc {name}]\n" + "\n".join(PTXAS[name]))
        os.replace(tmp, paths[name])   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return paths


def ptxas_summary(log: str) -> List[str]:
    """One line per kernel function of an ``-Xptxas -v`` report: its name
    (demangled where ``c++filt`` is installed), then its registers, barriers
    and shared memory, then its stack frame and spills."""
    funcs, used, spills = [], {}, {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            funcs.append(current)
        elif current and "spill stores" in line:
            spills[current] = line.strip()
        elif current and "Used" in line and "registers" in line:
            used[current] = line.split(":", 1)[1].strip()
    names = funcs
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and funcs:
        out = subprocess.run([cxxfilt], input="\n".join(funcs), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(funcs):
            names = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                     for n in out.stdout.splitlines()]
    return [f"  {n}: {used.get(f, '?')}; {spills.get(f, '?')}" for n, f in zip(names, funcs)]


def entry(name: str):
    """The C entry point ``repro_<name>`` of kernel ``name``, building and
    loading its library on first use."""
    fn = _entries.get(name)
    if fn is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        fn = getattr(ctypes.CDLL(str(path)), f"repro_{name}")
        fn.argtypes = _ARGTYPES[f"repro_{name}"]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def check(name: str, rc: int) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never runs,
    and ``torch.cuda.synchronize()`` would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def lanes_first(t, dim, lanes: int):
    """A batching rule's view of operand ``t`` with its vmapped axis first:
    moved there when batched at ``dim``, expanded (no copy) when unbatched;
    None stays None."""
    if t is None:
        return None
    return t.movedim(dim, 0) if dim is not None else t.expand(lanes, *t.shape)


def fold_lanes(t):
    """(lanes, B, ...) -> contiguous (lanes·B, ...): the lanes folded into a
    kernel's batch axis (None stays None).  The kernels read contiguous
    operands with no batch stride of their own, so an operand that
    :func:`lanes_first` expanded is written out here once per lane: lanes
    times its size (a cache shared by every lane, say).  The served batched
    replays batch every operand a kernel reads, so none of them pays it."""
    if t is None:
        return None
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]).contiguous()


def dtype_code(dtype) -> int:
    """The C entry points' dtype argument: 0 = float32, 1 = bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]
