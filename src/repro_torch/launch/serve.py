"""Serving driver (``repro.launch.serve``): generate with an arch locally
or through the RRTO transparent-offloading stack, on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --system rrto --tokens 24 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.serving.engine import LocalServing, RRTOServedLM


def main(argv=None, *, params=None) -> dict:
    """Parse ``argv``, generate, print and return the tokens (and, through
    the stack, the first and last token's RPCs and the client's mode).
    ``params`` replaces the seeded random weights (the family's tree)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--system", default="local",
                    choices=["local", "rrto", "cricket", "semi_rrto"])
    ap.add_argument("--environment", default="indoor", choices=["indoor", "outdoor"])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)

    if args.system == "local":
        engine = LocalServing(cfg, params=params, seed=args.seed, device=device)
        res = engine.generate({"tokens": prompt}, args.tokens)
        print(f"[serve] local generation: {res.tokens.tolist()}")
        return {"tokens": res.tokens.tolist()}

    served = RRTOServedLM(
        cfg,
        system=args.system,
        environment=args.environment,
        bucket_len=args.prompt_len + args.tokens,
        batch=args.batch,
        seed=args.seed,
        params=params,
        device=device,
    )
    res = served.generate(prompt, args.tokens)
    hist = served.session.history
    print(f"[serve] {args.system} generation: {res.tokens.tolist()}")
    print(f"[serve] RPCs/token: first={hist[0].rpcs} last={hist[-1].rpcs}; "
          f"mode={served.session.client.mode}; "
          f"latency/token last={hist[-1].wall_seconds*1e3:.2f} ms")
    return {
        "tokens": res.tokens.tolist(),
        "rpcs_first": hist[0].rpcs,
        "rpcs_last": hist[-1].rpcs,
        "mode": served.session.client.mode,
    }


if __name__ == "__main__":
    main()
