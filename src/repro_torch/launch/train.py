"""Training driver: data pipeline -> train_step -> checkpoint/restart
(``repro.launch.train``), on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
        --device cpu --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Fault tolerance: the driver resumes from the newest complete checkpoint in
--ckpt-dir (atomic manifest store), and the synthetic data stream is a pure
function of (seed, step), so a restarted run reproduces the exact batch
sequence.  ``--kill-at`` injects a crash for the restart test.  A
checkpoint holds ``{"params", "opt"}`` under the reference's leaf names, so
each package resumes the other's.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import store
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.training.data import DataConfig, synth_batch
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.step import init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-at", type=int, default=-1,
                    help="simulate a crash after this step (restart test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup)
    step_fn = make_train_step(cfg, opt_cfg, remat=True)

    params, opt_state = init_train_state(cfg, seed=args.seed, device=device)
    start = 0
    if args.ckpt_dir:
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            state = store.restore(
                args.ckpt_dir, latest, {"params": params, "opt": opt_state}
            )
            params, opt_state = state["params"], state["opt"]
            start = latest
            print(f"[train] resumed from step {latest}", flush=True)

    dc = DataConfig(seed=args.seed)
    losses = []
    t0 = time.time()
    writer = None
    for step in range(start, args.steps):
        batch = synth_batch(cfg, shape, step, dc)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {loss:.4f} ({dt:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = store.save_async(
                args.ckpt_dir, step + 1, {"params": params, "opt": opt_state}
            )
        if args.kill_at >= 0 and step + 1 >= args.kill_at:
            if writer is not None:
                writer.join()
            print(f"[train] simulated crash at step {step + 1}", flush=True)
            return {"crashed_at": step + 1, "losses": losses}
    if writer is not None:
        writer.join()
    if args.ckpt_dir:
        store.save(args.ckpt_dir, args.steps, {"params": params, "opt": opt_state})
    return {"final_loss": losses[-1][1] if losses else None, "losses": losses}


if __name__ == "__main__":
    main()
