"""Run a piece of Python in N CPU processes joined in one gloo group, for the
port's multi-rank tests (the reference runs its multi-device paths in a
subprocess with placeholder host devices; the port's counterpart is ranks
over gloo).  Each run rendezvouses through a ``FileStore`` in its own
directory, so no port is bound and parallel test workers never meet."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

PROLOGUE = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, run_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(run_dir, "store"), world),
                        rank=rank, world_size=world)
inputs = dict(np.load(os.path.join(run_dir, "inputs.npz"), allow_pickle=False))
results = {}
try:
"""

EPILOGUE = """
finally:
    dist.destroy_process_group()
np.savez(os.path.join(run_dir, f"rank{rank}.npz"), **results)
"""


def run_ranks(run_dir: Path, world: int, body: str, inputs: Dict[str, np.ndarray], *,
              timeout: float = 240.0) -> List[Dict[str, np.ndarray]]:
    """Run ``body`` on ``world`` ranks.  It sees ``rank``, ``world``,
    ``inputs`` (the arrays given) and fills ``results`` with numpy arrays;
    returns each rank's results.  A rank that fails fails the call with
    its stderr."""
    run_dir.mkdir(parents=True, exist_ok=False)
    np.savez(run_dir / "inputs.npz", **inputs)
    script = PROLOGUE + textwrap.indent(textwrap.dedent(body), "    ") + EPILOGUE
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(r), str(world), str(run_dir)],
                         env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for r in range(world)
    ]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise AssertionError("\n".join(errors))
    return [dict(np.load(run_dir / f"rank{r}.npz")) for r in range(world)]


JAX_PROLOGUE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
run_dir = sys.argv[1]
inputs = dict(np.load(os.path.join(run_dir, "inputs.npz"), allow_pickle=False))
results = {}
"""


def run_jax4(run_dir: Path, body: str, inputs: Dict[str, np.ndarray], *,
             timeout: float = 240.0) -> Dict[str, np.ndarray]:
    """Run ``body`` in one JAX process with 4 placeholder host devices;
    it sees ``inputs`` and fills ``results``."""
    run_dir.mkdir(parents=True, exist_ok=False)
    np.savez(run_dir / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    script = JAX_PROLOGUE + textwrap.dedent(body) + (
        "\nnp.savez(os.path.join(run_dir, 'jax.npz'), **results)\n")
    out = subprocess.run([sys.executable, "-c", script, str(run_dir)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(run_dir / "jax.npz"))
