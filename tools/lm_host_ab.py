"""Time a served, replayed qwen3-0.6b token in two or more checkouts of the
repo on one NVIDIA GPU, one process per checkout, in the order given.

    python3 tools/lm_host_ab.py PARENT . . PARENT
    python3 tools/lm_host_ab.py --xlstm-stateless PARENT . . PARENT

Each ROOT is a checkout with its own ``chip_smoke.py``: the script builds
that checkout's kernels and runs its qwen3-0.6b stateful path, or with
``--xlstm-stateless`` phase 9's xlstm-1.3b stateless path (the bucket's
whole forward a token: 42 wide scans)
(``phase_main_path``, ``check_main_path``, ``measure_replay_step``), so a
token's wall time splits into the replay program dispatched eagerly and the
host's interception of its records, beside the step as one CUDA graph.
Host times move between calls to the card, so two versions are compared
only within one call, in turns (A B B A).  Prints one line per run and a
table, then the card's name and power limit."""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

TAG = "LM_HOST_AB "


def one(root: str, xlstm: bool) -> None:
    """Run the qwen3-0.6b path (or xlstm-1.3b's stateless one) of the
    checkout at ``root`` and print its numbers as one JSON line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    from repro_torch.kernels import library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    library.build_all()
    if xlstm:
        m = cs.phase_main_path(dev, "xlstm-1.3b", cs.X_STATELESS_PROMPT, cs.X_NEW, cs.X_BUCKET,
                               stateful=False)
    else:
        m = cs.phase_main_path(dev, "qwen3-0.6b", cs.PROMPT_LEN, cs.NEW_TOKENS, cs.BUCKET)
    cs.check_main_path(m)
    r = cs.measure_replay_step(m, dev)
    replayed = [1e3 * t for mode, t, _ in m["timer"].steps if mode == "replaying"][1:]
    print(TAG + json.dumps(dict(
        root=root, wall_ms=r["wall_ms"], median_wall_ms=statistics.median(replayed),
        eager_ms=r["eager_ms"], interception_ms=r["wall_ms"] - r["eager_ms"],
        graph_ms=r["device_ms"], n_replayed=len(replayed),
    )), flush=True)


def main(roots, xlstm: bool) -> None:
    if not roots:
        sys.exit("usage: tools/lm_host_ab.py [--xlstm-stateless] ROOT [ROOT ...]")
    rows = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]
                              + ["--xlstm-stateless"] * xlstm, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:])
            sys.exit(f"{root}: exit {proc.returncode}")
        rows.append(json.loads(lines[-1][len(TAG):]))
        print(lines[-1], flush=True)
    print("| run | root | wall (mean) | wall (median) | eager replay | interception | graph step |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for i, r in enumerate(rows):
        print(f"| {i + 1} | {r['root']} | {r['wall_ms']} ms | {r['median_wall_ms']} ms | "
              f"{r['eager_ms']} ms | {r['interception_ms']} ms | {r['graph_ms']} ms |")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")


if __name__ == "__main__":
    args = sys.argv[1:]
    xlstm = "--xlstm-stateless" in args
    args = [a for a in args if a != "--xlstm-stateless"]
    if args[:1] == ["--one"]:
        one(args[1], xlstm)
    else:
        main(args, xlstm)
