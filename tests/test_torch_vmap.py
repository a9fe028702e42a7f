"""The batching rules of the port's four custom ops: under ``torch.func.vmap``
each folds the vmapped lanes into its op's batch (or row) axis and makes one
call, and the result equals the lane loop of the same op bit for bit — on
the CPU through the plain versions, on the card through the kernels
(``requires_cuda``).  Every call runs under ``no_vmap_fallback``, so an op
without a rule raises instead of quietly running once per lane."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import (  # noqa: E402
    LANE_PROBED_OPS,
    BatchedReplayProgram,
    batches_bitwise,
    no_vmap_fallback,
)
from repro_torch.core.flatten import template_vars  # noqa: E402
from repro_torch.kernels import library  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.ssm_scan import gated_scan, ssm_scan  # noqa: E402

DTYPES = ["float32", "bfloat16"]
LANES = 3


def _r(rng, *shape, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype).to(device)


def vmapped(fn, *args, in_dims=0):
    with no_vmap_fallback():
        return torch.func.vmap(fn, in_dims=in_dims)(*args)


def loop(fn, *args, in_dims=0):
    dims = in_dims if isinstance(in_dims, tuple) else (in_dims,) * len(args)
    lanes = next(a.shape[d] for a, d in zip(args, dims) if d is not None)
    outs = [fn(*(a if d is None else a.select(d, i) for a, d in zip(args, dims)))
            for i in range(lanes)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def assert_bitwise(a, b):
    for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y), (x.float() - y.float()).abs().max()


def test_fallback_is_an_error_under_the_guard():
    """The guard the batched replay runs under: an op with no batching rule
    raises instead of warning and looping."""

    @torch.library.custom_op("repro_torch_test::no_rule", mutates_args=())
    def no_rule(x: torch.Tensor) -> torch.Tensor:
        return x * 2

    x = torch.ones(2, 3)
    with pytest.raises(RuntimeError, match="fallback"):
        vmapped(no_rule, x)
    # outside the guard the fallback still runs, one call per lane
    assert torch.equal(torch.func.vmap(no_rule)(x), x * 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 64), (2, 5, 48), (4, 130)])
def test_rmsnorm_rule_equals_lane_loop(rng, dtype, shape):
    dt = getattr(torch, dtype)
    x, w = _r(rng, LANES, *shape, dtype=dt), _r(rng, shape[-1], dtype=dt)

    def f(a):
        return rmsnorm(a, w, eps=1e-6, offset=1.0)

    assert_bitwise(vmapped(f, x), loop(f, x))
    # lanes at another axis, and a batched scale (one call per lane)
    assert_bitwise(vmapped(f, x.movedim(0, 1).contiguous(), in_dims=1), loop(f, x))
    ws = _r(rng, LANES, shape[-1], dtype=dt)
    assert_bitwise(vmapped(rmsnorm, x, ws), loop(rmsnorm, x, ws))
    dims = (None, 0)        # one x under per-lane scales
    assert_bitwise(vmapped(rmsnorm, x[0], ws, in_dims=dims),
                   loop(rmsnorm, x[0], ws, in_dims=dims))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention_rule_equals_lane_loop(rng, dtype, window):
    """A different ``kv_len`` per lane and row (batched), an unbatched
    ``kv_len`` (expanded), and an unbatched cache."""
    dt = getattr(torch, dtype)
    q = _r(rng, LANES, 2, 4, 16, dtype=dt)
    k, v = _r(rng, LANES, 2, 10, 2, 16, dtype=dt), _r(rng, LANES, 2, 10, 2, 16, dtype=dt)
    kv_len = torch.tensor([[3, 7], [10, 1], [5, 9]], dtype=torch.int32)

    def f(q, k, v, n):
        return decode_attention(q, k, v, n, window=window)

    assert_bitwise(vmapped(f, q, k, v, kv_len), loop(f, q, k, v, kv_len))
    one = torch.tensor([4, 9], dtype=torch.int32)
    dims = (0, 0, 0, None)
    assert_bitwise(vmapped(f, q, k, v, one, in_dims=dims), loop(f, q, k, v, one, in_dims=dims))
    dims = (0, None, None, 0)
    assert_bitwise(vmapped(f, q, k[0], v[0], kv_len, in_dims=dims),
                   loop(f, q, k[0], v[0], kv_len, in_dims=dims))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_rule_equals_lane_loop(rng, dtype):
    dt = getattr(torch, dtype)
    q = _r(rng, LANES, 2, 9, 4, 16, dtype=dt)
    k, v = _r(rng, LANES, 2, 9, 2, 16, dtype=dt), _r(rng, LANES, 2, 9, 2, 16, dtype=dt)

    def f(q, k, v):
        return flash_attention(q, k, v, causal=True, window=5)

    assert_bitwise(vmapped(f, q, k, v), loop(f, q, k, v))
    dims = (0, None, 0)      # one K shared by every lane: expanded
    assert_bitwise(vmapped(f, q, k[0], v, in_dims=dims), loop(f, q, k[0], v, in_dims=dims))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_scan_rule_equals_lane_loop(rng, dtype):
    """Both outputs (y and the final state h) come back batched; a ragged
    chunk, an initial state, an unbatched D and a batched one."""
    dt = getattr(torch, dtype)
    x = _r(rng, LANES, 2, 12, 4, 8, dtype=dt)
    dt_ = torch.nn.functional.softplus(_r(rng, LANES, 2, 12, 4))
    a = -torch.linspace(1.0, 4.0, 4)
    bm, cm = _r(rng, LANES, 2, 12, 1, 6, dtype=dt), _r(rng, LANES, 2, 12, 1, 6, dtype=dt)
    d, h0 = _r(rng, 4), _r(rng, LANES, 2, 4, 6, 8)

    def f(x, ld, gi, bm, cm, h0):
        return gated_scan(x, ld, gi, bm, cm, d, chunk=5, h0=h0)

    args = (x, dt_ * a, dt_, bm, cm, h0)
    assert_bitwise(vmapped(f, *args), loop(f, *args))
    ds = _r(rng, LANES, 4)

    def g(x, dt, bm, cm, d):
        return ssm_scan(x, dt, a, bm, cm, d, chunk=8)

    args = (x, dt_, bm, cm, ds)
    assert_bitwise(vmapped(g, *args), loop(g, *args))


@torch.library.custom_op("repro_torch_test::skewed", mutates_args=())
def skewed(x: torch.Tensor) -> torch.Tensor:
    """Doubles x; its batched form is off by one ulp-sized step, as a GEMM
    that picks another kernel at another M is."""
    return x * 2


torch.library.register_vmap(
    skewed, lambda info, in_dims, x: (skewed(x.movedim(in_dims[0], 0)) + 1e-3, 0)
)


class _Call:
    def __init__(self, op, args):
        from repro_torch.core.flatten import FlatVar

        self.args = tuple(FlatVar(((), torch.float32), True) if a is None else a for a in args)
        self.op, self.kwargs = op, {}


def test_probe_tells_batch_variant_calls():
    """The probe runs a call vmapped and as a lane loop on random operands
    of the real ones' shapes: an op whose batched form changes its bits is
    caught, an elementwise one is not."""
    x = torch.ones(3, 4)
    assert not batches_bitwise(_Call(skewed, (None,)), [x], [0], 3)
    assert batches_bitwise(_Call(torch.ops.aten.add.Tensor, (None, None)), [x, x], [0, None], 3)


@pytest.mark.parametrize("rows", [1, 2])
def test_batched_program_lane_orders_what_the_probe_finds(rows):
    """A traced f32 MLP whose products batch or not depending on the
    hardware's GEMM at M = lanes·rows: the batched program probes both
    products once, runs per lane exactly those the probe finds
    batch-variant, and equals the lane loop bit for bit either way."""
    from repro_torch.core.offload import OffloadableModel, OffloadSession

    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(16, 32, generator=g), "w2": torch.randn(32, 8, generator=g)}
    x = torch.randn(rows, 16, generator=g)
    model = OffloadableModel("mlp", lambda p, x: [torch.tanh(x @ p["w1"]) @ p["w2"]],
                             params, (x,))
    sess = OffloadSession(model, "rrto", device="cpu")
    for _ in range(4):
        sess.infer(x)
    bound = sess.server.context().replay
    program = bound.program
    params_flat = [sess.server.context().env[a] for a in bound.param_addrs]
    xs = torch.randn(4, rows, 16, generator=g)
    batched = BatchedReplayProgram(program, 4)
    assert batched.n_probed == 0
    with no_vmap_fallback():
        out = batched.fn(params_flat, [xs])[0]
    assert batched.n_probed == 2
    loop = torch.stack([program.fn(params_flat, [xs[i]])[0] for i in range(4)])
    assert torch.equal(out, loop)
    # the program's decisions are the probe's, call by call
    ordered = {id(c) for c in batched.lane_ordered}
    for c in program.kernel_calls:
        if c.op not in LANE_PROBED_OPS:
            continue
        avals = [v.aval for v in template_vars((c.args, c.kwargs))]
        dims = [None if a in bound.param_addrs else 0 for _, a in c.in_operands]
        operands = [torch.zeros(shape if d is None else (4, *shape), dtype=dtype)
                    for (shape, dtype), d in zip(avals, dims)]
        assert (id(c) in ordered) == (not batches_bitwise(c, operands, dims, 4))
    with pytest.raises(ValueError):
        BatchedReplayProgram(program, 1)


# ---------------------------------------------------------------------------
# on the card: each kernel's rule against the loop of the same kernel
# ---------------------------------------------------------------------------

@pytest.mark.requires_cuda
def test_rules_equal_kernel_lane_loops_on_card(rng):
    """At the served shapes with 4 lanes: rmsnorm (qwen3's d_model and
    zamba2's bucket rows), decode attention (qwen3's step, kv_len different
    per lane), flash attention and the gated scan (zamba2's stateless
    bucket), bitwise against the loop of the same kernel, which must launch
    once per lane while the rule launches once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    bf = torch.bfloat16

    def r(*shape, dtype=bf):
        return _r(rng, *shape, dtype=dtype, device="cuda")

    def check(name, fn, *args, in_dims=0):
        library.reset_launches()
        out = vmapped(fn, *args, in_dims=in_dims)
        assert library.LAUNCHES[name] == 1, library.LAUNCHES
        assert_bitwise(out, loop(fn, *args, in_dims=in_dims))
        assert library.LAUNCHES[name] == 1 + 4

    w = r(1024)
    check("rmsnorm", lambda a: rmsnorm(a, w), r(4, 1, 1, 1024))
    w = r(4096)
    check("rmsnorm", lambda a: rmsnorm(a, w), r(4, 1, 64, 4096))
    kv_len = torch.tensor([[63], [8], [9], [500]], dtype=torch.int32, device="cuda")
    check("decode_attention", decode_attention, r(4, 1, 16, 128), r(4, 1, 512, 8, 128),
          r(4, 1, 512, 8, 128), kv_len)
    check("flash_attention", lambda q, k, v: flash_attention(q, k, v), r(4, 1, 64, 32, 64),
          r(4, 1, 64, 32, 64), r(4, 1, 64, 32, 64))
    dt_ = torch.nn.functional.softplus(r(4, 1, 64, 64, dtype=torch.float32) - 2.0)
    a = -torch.linspace(1.0, 16.0, 64, device="cuda")
    d = torch.ones(64, device="cuda")
    check("ssm_scan", lambda x, ld, gi, bm, cm: gated_scan(x, ld, gi, bm, cm, d),
          r(4, 1, 64, 64, 64), dt_ * a, dt_, r(4, 1, 64, 1, 64), r(4, 1, 64, 1, 64))
