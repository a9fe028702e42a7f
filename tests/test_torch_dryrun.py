"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``) on reduced configs, one per family:
qwen3 (dense), minicpm3 (MLA), mixtral (MoE) and llava (the patch prefix)
here, zamba2, xlstm and whisper in ``test_torch_dryrun_b.py``.

* Per-rank bytes: on a (2, 2) ("data", "model") mesh, the port's
  ``argument_size_in_bytes`` and ``output_size_in_bytes`` by the specs equal
  the reference's ``memory_analysis`` of its compiled program, for the
  train, prefill and decode steps of every family.
* Dot flops: on one device, the whole program's ``dot_flops`` equals the
  reference's trip-count-weighted ``hlo_weighted.dot_flops``; the gaps that
  remain are named and sized below.
The collectives and the CLI's records are in ``test_torch_dryrun_cli.py``.
The reference runs in two subprocesses (one a mesh; each imports JAX once
and lowers every cell), started before the port's traces so they overlap.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from gloo_ranks import JAX_PROLOGUE, ROOT
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import dryrun

# one reduced config a family, with the overrides both packages take: zamba2
# with a full group (the default reduction has none, so its shared block
# never runs and the reference's zero-trip group loop still takes the
# block's weights as arguments), xlstm with an sLSTM block and 4 scan
# chunks a sequence (every real cell has many; the single-chunk cells are
# pinned by ONE_CHUNK_XLSTM)
CASES = {
    "qwen3": ("qwen3-0.6b", {}),
    "minicpm3": ("minicpm3-4b", {}),
    "mixtral": ("mixtral-8x7b", {}),
    "zamba2": ("zamba2-1.2b", {"n_layers": 5, "attn_every": 2}),
    "xlstm": ("xlstm-1.3b", {"n_layers": 3, "slstm_every": 3, "ssm_chunk": 16}),
    "whisper": ("whisper-base", {}),
    "llava": ("llava-next-34b", {}),
}
HERE = ("qwen3", "minicpm3", "mixtral", "llava")
KINDS = {"train": (64, 4), "prefill": (64, 4), "decode": (64, 4)}   # (seq, batch)


def _cfg(name):
    arch, kw = CASES[name]
    return get_reduced_config(arch, **kw)


def _shape(kind):
    seq, batch = KINDS[kind]
    return ShapeConfig(kind, seq, batch, kind)


REF_BODY = """
jax.devices()      # 4 host devices, before the dry run's module asks for 512
from repro.launch.dryrun import lower_cell
from repro.configs import get_reduced_config
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import compat_make_mesh
n = int(sys.argv[2])
mesh = compat_make_mesh((2, 2) if n == 4 else (1, 1), ("data", "model"), devices=jax.devices()[:n])
for name, (arch, kw) in CASES.items():
    cfg = get_reduced_config(arch, **kw)
    for kind, (seq, batch) in KINDS.items():
        rec = lower_cell(cfg, ShapeConfig(kind, seq, batch, kind), mesh)
        m = rec["memory_analysis"]
        results[f"{name}/{kind}/args"] = np.array(m["argument_size_in_bytes"])
        results[f"{name}/{kind}/out"] = np.array(m["output_size_in_bytes"])
        results[f"{name}/{kind}/dots"] = np.array(rec["hlo_weighted"]["dot_flops"])
np.savez(os.path.join(run_dir, f"ref{n}.npz"), **results)
"""


def _start_reference(run_dir, n, names):
    cases = {name: CASES[name] for name in names}
    script = (JAX_PROLOGUE + f"CASES = {json.dumps(cases)}\nKINDS = {json.dumps(KINDS)}\n"
              + textwrap.dedent(REF_BODY))
    np.savez(run_dir / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", script, str(run_dir), str(n)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def reference_cells(run_dir, names) -> tuple:
    """The port's records of ``names``' cells on a (2, 2) mesh, the
    reference's numbers from its two subprocesses (started first, so they
    run beside the port's traces), and whisper's dot flops without remat
    where whisper is among them."""
    procs = {n: _start_reference(run_dir, n, names) for n in (4, 1)}
    try:
        mesh = Mesh(("data", "model"), (2, 2))
        port = {}
        for name in names:
            cfg = _cfg(name)
            for kind in KINDS:
                # one direct trace: these cells are short
                tr = dryrun.trace_step(cfg, _shape(kind), "cpu")
                traced = (dryrun.whole_program(tr), tr)
                port[name, kind] = dryrun.lower_cell(cfg, _shape(kind), mesh, "cpu",
                                                     traced=traced)
        whisper_no_remat = None
        if "whisper" in names:
            # the reference's encdec ignores remat: whisper's step without it
            w_tr = dryrun.trace_step(_cfg("whisper"), _shape("train"), "cpu", remat=False)
            whisper_no_remat = w_tr.metered["cost"]["dot_flops"]
        ref = {}
        for n, p in procs.items():
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
            ref[n] = dict(np.load(run_dir / f"ref{n}.npz"))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return port, ref, whisper_no_remat


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return reference_cells(tmp_path_factory.mktemp("dryrun"), HERE)


def check_bytes(cells, name, kind) -> None:
    port, ref, _ = cells
    mem = port[name, kind]["per_rank"]["memory"]
    assert mem["argument_size_in_bytes"] == int(ref[4][f"{name}/{kind}/args"])
    assert mem["output_size_in_bytes"] == int(ref[4][f"{name}/{kind}/out"])
    assert mem["temp_size_in_bytes"] is None


def _conv_weight_grad_overcount(cfg, shape) -> int:
    """The reference's ``hlo_analysis._conv_flops`` ignores the group count
    of the Mamba2 depthwise conv's weight gradient (a convolution over the
    batch x sequence window with C groups), so it counts its products C
    times: (C - 1) x 2 B S C K a Mamba2 layer.  Its other products agree."""
    d_inner = cfg.ssm_expand * cfg.d_model
    c = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    k = 4                                    # layers/mamba2.py D_CONV
    return cfg.n_layers * (c - 1) * 2 * shape.global_batch * shape.seq_len * c * k


def _slstm_first_step_product(cfg, shape) -> int:
    """The sLSTM's recurrent product's gradient for the initial state: the
    reference's time loop takes it at every step, t = 0 included, where the
    state is a constant; the port's autograd does not.  2 B NH (4 DH) DH a
    sLSTM layer."""
    dh = cfg.d_model // cfg.n_heads
    n_slstm = cfg.n_layers // cfg.slstm_every
    return n_slstm * 2 * shape.global_batch * cfg.n_heads * 4 * dh * dh


# (name, kind) -> the reference's dot flops less the port's, and why
NAMED_GAPS = {
    ("zamba2", "train"): _conv_weight_grad_overcount,
    ("xlstm", "train"): _slstm_first_step_product,
}


def check_dot_flops(cells, name, kind) -> None:
    port, ref, whisper_no_remat = cells
    got = port[name, kind]["whole_program"]["cost"]["dot_flops"]
    if (name, kind) == ("whisper", "train"):
        # the port's encdec recomputes each layer under remat (the
        # reference's ignores remat): its step without remat is the
        # reference's program
        assert got > whisper_no_remat
        got = whisper_no_remat
    want = float(ref[1][f"{name}/{kind}/dots"])
    gap = NAMED_GAPS.get((name, kind), lambda cfg, shape: 0)(_cfg(name), _shape(kind))
    assert want - got == gap, (want, got, gap)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", HERE)
def test_per_rank_bytes_match_reference_memory_analysis(cells, name, kind):
    check_bytes(cells, name, kind)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", HERE)
def test_dot_flops_match_reference_hlo(cells, name, kind):
    check_dot_flops(cells, name, kind)


# the reference's hlo_weighted.dot_flops of the default reduced xlstm (2
# mLSTM layers) at seq 64, batch 4, where its scan chunk of 128 is one chunk
# a sequence: XLA drops the unread final state's product B^T x from the
# train step's forward but not from its rematerialized forward (behind
# jax.checkpoint's optimization barrier), and keeps C h on the zero state
ONE_CHUNK_XLSTM = {"train": 303_693_824, "prefill": 64_749_568, "decode": 935_936}


@pytest.mark.parametrize("kind", sorted(ONE_CHUNK_XLSTM))
def test_one_chunk_scan_dot_flops_match_reference(kind):
    cfg = get_reduced_config("xlstm-1.3b")
    assert cfg.ssm_chunk >= 64
    tr = dryrun.trace_step(cfg, ShapeConfig(kind, 64, 4, kind), "cpu")
    assert tr.metered["cost"]["dot_flops"] == ONE_CHUNK_XLSTM[kind]


def test_named_gaps_are_real_gaps():
    # each named gap is nonzero at the tested shapes (else it names nothing)
    for (name, kind), fn in NAMED_GAPS.items():
        assert fn(_cfg(name), _shape(kind)) > 0
