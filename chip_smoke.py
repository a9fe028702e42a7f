"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from the sources in this checkout, holds each
against its plain PyTorch version at the shapes the served qwen3-0.6b path
gives it (and at ragged shapes), times kernel / plain version / one PyTorch
library call beside the card's bound, then drives the port's main path at the
full qwen3-0.6b width (28 layers, d_model 1024, bf16, random weights from a
seed): ``LocalServing`` (prefill + KV-cached decode) and ``RRTOServedLM``
(record, Operator Sequence Search, stateful replay) against a
``device_only`` session.  Any failed check exits non-zero.  The last two
lines of standard output are the kernel table and the device, as JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # tests/test_kernels.py
RMSNORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# prefill (flash attention, M=32 products) vs token-by-token decode (decode
# attention, M=1 products) round differently in bf16 through 28 layers; the
# last-position logits must agree to within 5% of their largest magnitude
LOGIT_REL_TOL = 0.05
PROMPT_LEN, NEW_TOKENS, BUCKET = 32, 32, 512


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed and timed with CUDA events (launch overhead of the host is not
    in the number; L2 is warm, as it is for the main path's operands)."""
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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(out, ref, tol) -> float:
    err = (out.float() - ref.float()).abs()
    bad = err > tol + tol * ref.float().abs()
    check(not bool(bad.any()), f"max |d| {err.max().item():.3g} over tolerance {tol}")
    return err.max().item()


def phase_kernels(dev):
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_dense, flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    rows = {}
    # ---- rmsnorm: decode (d_model, qk-norm heads), prefill, ragged, offset
    for shape, offset in [((1, 1, 1024), 0.0), ((1, 1, 16, 128), 0.0),
                          ((1, 1, 8, 128), 0.0), ((1, 32, 1024), 0.0),
                          ((3, 7, 96), 0.0), ((2, 64, 512), 1.0)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(*shape, dtype=dtype)
            w = (randn(shape[-1], dtype=torch.float32) * 0.1 + 1.0).to(dtype)
            out = rmsnorm(x, w, eps=1e-6, offset=offset)
            torch.cuda.synchronize()
            err = close(out, rmsnorm_ref(x, w, 1e-6, offset), RMSNORM_TOL[dtype])
            print(f"rmsnorm {shape} {dtype} offset={offset}: max|d| {err:.3g}"
                  f" (tol {RMSNORM_TOL[dtype]})")
    x = randn(1, 1, 1024, dtype=torch.bfloat16)
    w = torch.ones(1024, dtype=torch.bfloat16, device=dev)
    err = close(rmsnorm(x, w), rmsnorm_ref(x, w), RMSNORM_TOL[torch.bfloat16])
    nbytes = 2 * x.numel() * 2 + w.numel() * 2
    b_ms, b_by = bound_ms(nbytes, 4 * x.numel(), torch.bfloat16)
    rows["rmsnorm"] = dict(
        shape="x (1,1,1024) bf16", max_abs_err=err,
        ms=graph_ms(lambda: rmsnorm(x, w)),
        plain_ms=graph_ms(lambda: rmsnorm_ref(x, w)),
        library_ms=graph_ms(lambda: F.rms_norm(x, (1024,), w, 1e-6)),
        bound_ms=b_ms, bound_by=b_by,
    )

    # ---- decode attention: the served step (S=512 bucket), ragged, window
    def dec_case(b, s, hq, hkv, d, lens, window, dtype):
        q = randn(b, hq, d, dtype=dtype)
        k = randn(b, s, hkv, d, dtype=dtype)
        v = randn(b, s, hkv, d, dtype=dtype)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        return q, k, v, kv_len, window

    for args in [(1, 512, 16, 8, 128, [63], None), (1, 512, 16, 8, 128, [1], None),
                 (2, 1000, 8, 2, 64, [700, 37], 256), (3, 333, 40, 40, 64, [333, 5, 200], None),
                 (1, 100, 8, 1, 256, [99], None), (1, 77, 4, 4, 32, [77], 8)]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kv_len, window = dec_case(*args, dtype)
            out = decode_attention(q, k, v, kv_len, window=window)
            torch.cuda.synchronize()
            err = close(out, decode_attention_ref(q, k, v, kv_len, window=window), TOL[dtype])
            print(f"decode_attention {args} {dtype}: max|d| {err:.3g} (tol {TOL[dtype]})")
    q, k, v, kv_len, _ = dec_case(1, 512, 16, 8, 128, [63], None, torch.bfloat16)
    err = close(decode_attention(q, k, v, kv_len), decode_attention_ref(q, k, v, kv_len),
                TOL[torch.bfloat16])
    n = 63
    nbytes = 2 * q.numel() * 2 + 2 * n * 8 * 128 * 2 + 4
    b_ms, b_by = bound_ms(nbytes, 4 * 16 * n * 128, torch.bfloat16)
    kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
    rows["decode_attention"] = dict(
        shape="q (1,16,128), K/V (1,512,8,128) bf16, kv_len 63", max_abs_err=err,
        ms=graph_ms(lambda: decode_attention(q, k, v, kv_len)),
        plain_ms=graph_ms(lambda: decode_attention_ref(q, k, v, kv_len)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    )

    # ---- flash attention: the served prefill, ragged/offset/window/cap, D=256
    def fl_case(b, sq, sk, hq, hkv, d, dtype):
        return (randn(b, sq, hq, d, dtype=dtype), randn(b, sk, hkv, d, dtype=dtype),
                randn(b, sk, hkv, d, dtype=dtype))

    for shape, kw in [((1, 32, 32, 16, 8, 128), dict(causal=True)),
                      ((1, 512, 512, 16, 8, 128), dict(causal=True)),
                      ((2, 45, 77, 4, 2, 64), dict(causal=True, q_offset=32, window=16,
                                                   logit_cap=30.0)),
                      ((1, 100, 100, 4, 4, 256), dict(causal=False)),
                      ((1, 128, 384, 4, 1, 64), dict(causal=True, q_offset=256))]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = fl_case(*shape, dtype)
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = close(out, attention_dense(q, k, v, **kw), TOL[dtype])
            print(f"flash_attention {shape} {kw} {dtype}: max|d| {err:.3g} (tol {TOL[dtype]})")
    q, k, v = fl_case(1, 32, 32, 16, 8, 128, torch.bfloat16)
    err = close(flash_attention(q, k, v), attention_dense(q, k, v), TOL[torch.bfloat16])
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    pairs = 32 * 33 / 2
    b_ms, b_by = bound_ms(nbytes, 4 * 16 * pairs * 128, torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows["flash_attention"] = dict(
        shape="q (1,32,16,128), K/V (1,32,8,128) bf16, causal", max_abs_err=err,
        ms=graph_ms(lambda: flash_attention(q, k, v)),
        plain_ms=graph_ms(lambda: attention_dense(q, k, v)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    )
    for name, r in rows.items():
        print(f"time {name} [{r['shape']}]: kernel {r['ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library {r['library_ms'] * 1e3:.2f} us, "
              f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    return rows


def phase_small_reference(dev):
    """The reduced qwen3-0.6b in f32 (head dim 32: the kernels take 32, 64,
    128 and 256): the card (kernels) against the CPU (plain versions) on the
    same weights and tokens."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import lm

    cfg = get_reduced_config("qwen3-0.6b", d_head=32)
    p_cpu = lm.init_params(cfg, 1, "cpu")
    p_dev = torch.utils._pytree.tree_map(lambda t: t.to(dev), p_cpu)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
                           .astype(np.int32))
    with torch.no_grad():
        l_cpu, c_cpu = lm.prefill(p_cpu, {"tokens": tok}, cfg, 16)
        l_dev, c_dev = lm.prefill(p_dev, {"tokens": tok.to(dev)}, cfg, 16)
        e1 = close(l_dev.cpu(), l_cpu, TOL[torch.float32])
        pos = torch.tensor(12, dtype=torch.int32)
        nxt = tok[:, -1:]
        d_cpu, _ = lm.decode_step(p_cpu, nxt, c_cpu, pos, cfg)
        d_dev, _ = lm.decode_step(p_dev, nxt.to(dev), c_dev, pos.to(dev), cfg)
        e2 = close(d_dev.cpu(), d_cpu, TOL[torch.float32])
    print(f"reduced f32 card vs cpu: prefill logits max|d| {e1:.3g}, "
          f"decode logits max|d| {e2:.3g} (tol {TOL[torch.float32]})")


class StepTimer:
    """Wall time of each ``session.infer`` (the outputs are host copies, so
    the call has waited for the card when it returns)."""

    def __init__(self, session):
        self.steps = []
        inner = session.infer

        def infer(*args):
            t0 = time.perf_counter()
            res = inner(*args)
            self.steps.append((res.mode, time.perf_counter() - t0))
            return res

        session.infer = infer

    def mean_ms(self, mode: str, skip: int = 0) -> float:
        ts = [t for m, t in self.steps if m == mode][skip:]
        return 1e3 * sum(ts) / max(1, len(ts))


def phase_main_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import LocalServing, RRTOServedLM

    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    print(f"qwen3-0.6b params: {n_params} ({n_params * 2 / 1e9:.3f} GB bf16), "
          f"init {time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (1, PROMPT_LEN)).astype(np.int32)

    t0 = time.perf_counter()
    local = LocalServing(cfg, params=params, device=dev).generate(
        {"tokens": prompt}, NEW_TOKENS, max_seq=BUCKET)
    print(f"LocalServing: {NEW_TOKENS} tokens in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    served = RRTOServedLM(cfg, system="rrto", bucket_len=BUCKET, params=params, device=dev)
    print(f"RRTOServedLM session (trace of {served.session._n_kernels} aten calls): "
          f"{time.perf_counter() - t0:.1f} s")
    timer = StepTimer(served.session)
    t0 = time.perf_counter()
    r_srv = served.generate(prompt, NEW_TOKENS)
    print(f"RRTOServedLM: {PROMPT_LEN + NEW_TOKENS - 1} steps in {time.perf_counter() - t0:.1f} s")

    only = RRTOServedLM(cfg, system="device_only", bucket_len=BUCKET, params=params, device=dev)
    r_dev = only.generate(prompt, NEW_TOKENS)

    sess = served.session
    hist = sess.history
    modes = [h.mode for h in hist]
    n_rec = modes.index("replaying") if "replaying" in modes else len(modes)
    steady = [h for h in hist if h.mode == "replaying"][1:]
    cache_bytes = sum(t.numel() * t.element_size() for t in served._cache_leaves)
    return dict(
        cfg=cfg, params=params, prompt=prompt, local=local, r_srv=r_srv, r_dev=r_dev,
        sess=sess, modes=modes, n_rec=n_rec, steady=steady, cache_bytes=cache_bytes,
        timer=timer,
    )


def check_main_path(m) -> None:
    sess, steady = m["sess"], m["steady"]
    check(np.array_equal(m["r_srv"].tokens, m["r_dev"].tokens),
          f"rrto tokens {m['r_srv'].tokens} != device_only {m['r_dev'].tokens}")
    print("rrto tokens == device_only tokens: True")
    check(sess.client.mode == "replaying", "session never reached replaying")
    check(m["modes"] == ["recording"] * m["n_rec"] + ["replaying"] * (len(m["modes"]) - m["n_rec"]),
          f"modes switch more than once: {m['modes']}")
    check(m["n_rec"] <= sess.client.min_repeats + 2,
          f"locked only after {m['n_rec']} recorded steps")
    check(steady and all(h.rpcs <= 3 for h in steady),
          f"steady replay rpcs {[h.rpcs for h in steady]}")
    check(all(h.network_bytes < m["cache_bytes"] for h in steady), "KV cache on the wire")
    pairs = sess.client.ios.carried_pairs
    check(len(pairs) >= 1, "no loop-carried pair detected")
    print(f"modes: {m['n_rec']} recording then replaying; steady rpcs/token "
          f"{max(h.rpcs for h in steady)}; steady wire bytes/token "
          f"{max(h.network_bytes for h in steady):.0f} < cache {m['cache_bytes']}; "
          f"carried pairs {pairs}; IOS {len(sess.client.ios)} records")
    match = int((m["local"].tokens == m["r_srv"].tokens).sum())
    print(f"LocalServing vs served tokens matching: {match}/{NEW_TOKENS}")
    t = m["timer"]
    print(f"wall per recorded step {t.mean_ms('recording'):.1f} ms, per replayed step "
          f"{t.mean_ms('replaying', skip=1):.1f} ms (steady, first replay excluded)")


def measure_replay_step(m, dev) -> dict:
    """Split a replayed step: the replay program alone, dispatched eagerly
    (host + device), and captured once in a CUDA graph (device only); the
    rest of a replayed step's wall time is the host's interception."""
    sess = m["sess"]
    bound = sess.server.ctx.replay
    env = sess.server.ctx.env
    params_flat = [env[a] for a in bound.param_addrs]
    wire = [torch.zeros((1, 1), dtype=torch.int32, device=dev),
            torch.tensor(PROMPT_LEN + NEW_TOKENS - 1, dtype=torch.int32, device=dev)]
    state = list(bound.carried_state)

    def step():
        bound.program.step_fn(params_flat, wire, state)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 5 * 1e3
    device_ms = graph_ms(step, reps=5)
    wall_ms = m["timer"].mean_ms("replaying", skip=1)
    print(f"replayed step: wall {wall_ms:.1f} ms = replay program {eager_ms:.1f} ms "
          f"(eager dispatch; {device_ms:.2f} ms of it as one CUDA graph) + "
          f"interception {wall_ms - eager_ms:.1f} ms; weight-read bound "
          f"{2 * sum(t.numel() for t in params_flat) / HBM_BYTES_PER_S * 1e3:.3f} ms")
    return dict(wall_ms=wall_ms, eager_ms=eager_ms, device_ms=device_ms)


def check_prefill_vs_decode(m, dev) -> None:
    from repro_torch.models import lm

    cfg, params = m["cfg"], m["params"]
    tok = torch.from_numpy(m["prompt"]).to(dev)
    with torch.no_grad():
        l_pre, _ = lm.prefill(params, {"tokens": tok}, cfg, BUCKET)
        cache = lm.init_cache(cfg, 1, BUCKET, dev)
        for i in range(PROMPT_LEN):
            pos = torch.tensor(i, dtype=torch.int32, device=dev)
            l_dec, cache = lm.decode_step(params, tok[:, i:i + 1], cache, pos, cfg)
    a, b = l_pre[0, 0, :cfg.vocab].float(), l_dec[0, 0, :cfg.vocab].float()
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), "non-finite logits")
    d = (a - b).abs().max().item()
    scale = a.abs().max().item()
    print(f"prefill vs decode-loop last logits: max|d| {d:.4g}, max|logit| {scale:.4g}, "
          f"rel {d / scale:.4g} (tol {LOGIT_REL_TOL}); argmax equal: "
          f"{int(a.argmax()) == int(b.argmax())}")
    check(d <= LOGIT_REL_TOL * scale, "prefill and decode-loop logits disagree")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    from repro_torch.kernels import library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    library.build_all(verbose=True)
    print(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = phase_kernels(dev)
    phase_small_reference(dev)
    print(f"[phase 2] kernels vs plain versions: ok ({time.perf_counter() - t0:.1f} s)")

    library.reset_launches()
    t0 = time.perf_counter()
    m = phase_main_path(dev)
    launches = dict(library.LAUNCHES)
    print(f"[phase 3-4] main path ({time.perf_counter() - t0:.1f} s); launches {launches}")
    check_main_path(m)
    measure_replay_step(m, dev)
    check_prefill_vs_decode(m, dev)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")

    replaces = {
        "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:26",
        "decode_attention": "src/repro/kernels/decode_attention/kernel.py:94",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:111",
    }
    kernels = []
    for name in library.KERNELS:
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=os.path.relpath(library.source_path(name), ROOT),
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"],
        ))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
