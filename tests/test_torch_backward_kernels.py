"""The gradients of the two kernels on the training path, rmsnorm and flash
attention: ``repro_torch::rmsnorm_backward`` and
``repro_torch::flash_attention_backward``, registered as the forward ops'
autograd.  On the CPU: autograd through each forward op gives its plain
backward (held against ``jax.vjp`` of the reference's refs in
tests/test_torch_training.py); ``torch.library.opcheck`` of all four ops;
the launch plans; the wrappers refuse what the kernels do not take.  On
the card (``requires_cuda``): each backward kernel against its plain
version at the training shapes and ragged ones, f32 and bf16, and two
launches bitwise equal."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import library  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_chunked_backward,
    backward_plan,
    flash_attention,
    flash_attention_backward_cuda,
    flash_attention_backward_op,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_backward_bf16_products,
)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm,
    rmsnorm_backward_cuda,
    rmsnorm_backward_op,
    rmsnorm_backward_plan,
    rmsnorm_backward_ref,
)
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op  # noqa: E402

SMEM_MAX = 232448   # bytes of shared memory an H100 block may take
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# the sums of the kernels run in another order than the plain versions'
# (dscale over every row; the flash gradients over key and query tiles),
# and bf16 rounds the outputs once: f32 within 2e-4, bf16 within 2e-2 of
# the largest magnitude
FLASH_CASES = [
    ((2, 40, 40, 4, 4, 64), dict(causal=True)),
    ((1, 33, 50, 4, 4, 64), dict(causal=False)),
    ((1, 130, 130, 8, 4, 128), dict(causal=True)),
    ((2, 29, 29, 8, 2, 64), dict(causal=True, window=16)),
    ((1, 70, 70, 4, 4, 32), dict(causal=True, logit_cap=5.0)),
    ((1, 21, 85, 4, 1, 128), dict(causal=True, q_offset=64)),
    ((1, 64, 64, 8, 8, 96), dict(causal=True)),
    ((2, 19, 150, 8, 2, 128), dict(causal=True, q_offset=131, window=40, logit_cap=20.0)),
]


def _t(rng, shape, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device, dtype)


def _close(out, ref, dtype):
    tol = TOL[dtype]
    atol = tol * float(ref.float().abs().max()) if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_autograd_is_the_plain_backward(rng, dtype):
    x = _t(rng, (3, 5, 96), dtype).requires_grad_(True)
    w = _t(rng, (96,), dtype).requires_grad_(True)
    dy = _t(rng, (3, 5, 96), dtype)
    dx, dw = torch.autograd.grad(rmsnorm(x, w, eps=1e-5, offset=1.0), (x, w), dy)
    rx, rw = rmsnorm_backward_ref(dy, x.detach(), w.detach(), 1e-5, 1.0)
    assert torch.equal(dx, rx) and torch.equal(dw, rw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_is_the_plain_backward(rng, dtype):
    q = _t(rng, (1, 20, 4, 32), dtype).requires_grad_(True)
    k = _t(rng, (1, 26, 2, 32), dtype).requires_grad_(True)
    v = _t(rng, (1, 26, 2, 32), dtype).requires_grad_(True)
    do = _t(rng, (1, 20, 4, 32), dtype)
    kw = dict(causal=True, window=9, logit_cap=7.0, q_offset=6)
    grads = torch.autograd.grad(flash_attention(q, k, v, **kw), (q, k, v), do)
    refs = attention_chunked_backward(do, q.detach(), k.detach(), v.detach(), **kw)
    for g, r in zip(grads, refs):
        assert g.is_contiguous() and torch.equal(g, r)


def test_opcheck_of_the_forward_and_backward_ops(rng):
    """Schemas, fake kernels and the autograd registrations agree with the
    ops' CPU bodies."""
    x, w = _t(rng, (2, 3, 16)).requires_grad_(True), _t(rng, (16,)).requires_grad_(True)
    torch.library.opcheck(rmsnorm_op, (x, w, 1e-6, 0.0))
    torch.library.opcheck(rmsnorm_backward_op, (_t(rng, (2, 3, 16)), x.detach(), w.detach(),
                                                1e-6, 0.0))
    q = _t(rng, (1, 6, 4, 16)).requires_grad_(True)
    k = _t(rng, (1, 6, 2, 16)).requires_grad_(True)
    v = _t(rng, (1, 6, 2, 16)).requires_grad_(True)
    torch.library.opcheck(flash_attention_op, (q, k, v, True, None, None, 0))
    out = flash_attention(q, k, v).detach()
    torch.library.opcheck(flash_attention_backward_op,
                          (_t(rng, (1, 6, 4, 16)), q.detach(), k.detach(), v.detach(), out,
                           True, None, None, 0))


def test_served_trace_keeps_one_node_per_kernel(rng):
    """Autograd on the ops leaves a trace without grad as it was: one node
    each, no backward op."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def fn(x, w, q, k, v):
        return rmsnorm(x, w), flash_attention(q, k, v)

    g = make_fx(fn, tracing_mode="fake")(_t(rng, (1, 4, 32)), _t(rng, (32,)),
                                          _t(rng, (1, 4, 4, 32)), _t(rng, (1, 4, 2, 32)),
                                          _t(rng, (1, 4, 2, 32)))
    targets = [str(n.target) for n in g.graph.nodes if n.op == "call_function"]
    assert targets == ["repro_torch.rmsnorm.default", "repro_torch.flash_attention.default"]


@pytest.mark.parametrize("rows,d", [(2048, 1024), (32768, 128), (16384, 128), (65, 130),
                                    (64, 2560), (3, 8192), (2048, 2048), (2048, 4096),
                                    (512, 4096), (2048, 2560)])
def test_rmsnorm_backward_plan(rows, d):
    """The route by dtype, shape and alignment: aligned rows that split into
    16-byte vectors take the vector route up to d 8192 (a row's lanes in
    one warp up to d 1024, the whole block beyond), the rest the scalar
    one; the grid covers the rows with no empty block, within its cap; the
    lanes and vectors cover the row; shared memory fits."""
    for dtype in (torch.float32, torch.bfloat16):
        per_vec = 4 if dtype == torch.float32 else 8
        for aligned in (True, False):
            plan = rmsnorm_backward_plan(rows, d, dtype, aligned=aligned)
            assert plan["grid"] == -(-rows // plan["rows_per_block"])
            assert (plan["grid"] - 1) * plan["rows_per_block"] < rows
            assert plan["smem"] <= SMEM_MAX
            if not aligned or d % per_vec:
                assert plan["route"] == "scalar"
                assert plan["rows_per_block"] % 4 == 0 and plan["grid"] <= 1056
                assert plan["smem"] == 16 * d
                continue
            nvec = d // per_vec
            if d > 1024:
                # the whole block on a row: 4 to 16 warps, 1 to 4 vectors a
                # thread, two rows at a time, 1 to 4 blocks an SM
                threads, vecs = plan["threads"], plan["vecs"]
                assert plan["route"] == "vector" and plan["lanes"] == threads
                assert threads % 32 == 0 and 96 <= threads <= 512 and 1 <= vecs <= 4
                assert (vecs - 1) * threads < nvec <= vecs * threads
                assert plan["rows_per_block"] % 2 == 0 and plan["grid"] <= 4 * 132
                continue
            assert plan["route"] == "vector" and plan["threads"] == 256
            lanes = plan["lanes"]
            assert lanes & (lanes - 1) == 0 and lanes <= min(32, nvec) < 2 * lanes
            assert (plan["vecs"] - 1) * lanes < nvec <= plan["vecs"] * lanes
            step = 8 * (32 // lanes) * 2     # 8 warps, two rows in flight a row group
            assert plan["rows_per_block"] % step == 0 and plan["smem"] == 32 * d
    assert rmsnorm_backward_plan(32768, 128, torch.bfloat16)["lanes"] == 16   # two rows a warp
    assert rmsnorm_backward_plan(2048, 1024, torch.bfloat16)["vecs"] == 4     # 32 values a lane
    # the training shapes above d 1024, as timed (tools/rmsnorm_backward_grids.py): two
    # vectors a thread, 64 KB of x and dy in flight on each SM
    bf = torch.bfloat16
    assert {k: rmsnorm_backward_plan(2048, 4096, bf)[k] for k in ("threads", "vecs", "grid")} \
        == dict(threads=256, vecs=2, grid=256)
    assert {k: rmsnorm_backward_plan(2048, 2048, bf)[k] for k in ("threads", "vecs", "grid")} \
        == dict(threads=128, vecs=2, grid=512)


@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_flash_backward_plan_fits_shared_memory(d):
    """bf16 takes the tensor cores, packed GQA rows and the tile index as
    the slowest grid dimension; f32 the CUDA cores; both fit a block's
    shared memory beside their static arrays."""
    mma = backward_plan(4, 512, 512, 16, 8, d, torch.bfloat16)
    assert mma["route"] == "mma" and (mma["threads_dq"], mma["threads_dkv"]) == (128, 256)
    assert mma["grid_dq"] == (8, 4, 16) and mma["grid_dkv"] == (8, 4, 8)
    assert mma["smem_dq"] == 6 * 64 * (d + 8) * 2 < mma["smem_dkv"] <= SMEM_MAX
    assert 2 * (mma["smem_dq"] + 256) <= SMEM_MAX      # two dq blocks share an SM
    # the dk/dv pass's second group's f32 sums of dK and dV fit in its rings
    assert 2 * 64 * d * 4 <= 8 * 64 * (d + 8) * 2
    cores = backward_plan(4, 512, 512, 16, 8, d, torch.float32)
    assert cores["route"] == "cuda_cores" and cores["threads_dkv"] == 256
    assert cores["grid_dq"] == (8, 16, 4) and cores["grid_dkv"] == (8, 8, 4)
    assert cores["smem_dq"] < cores["smem_dkv"] <= SMEM_MAX - 512   # + the static row stats
    with pytest.raises(TypeError):
        backward_plan(4, 512, 512, 16, 8, d, torch.float16)


@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_bf16_rounding_of_p_and_ds_fits(rng, case):
    """The mma route's numerics on the CPU: P and dS rounded to bf16 before
    their products (and delta from the bf16 output) stay within TOL[bf16]
    of the plain backward, over every case the card holds the kernel to."""
    (b, sq, sk, hq, hkv, d), kw = FLASH_CASES[case]
    bf = torch.bfloat16
    q, do = _t(rng, (b, sq, hq, d), bf), _t(rng, (b, sq, hq, d), bf)
    k, v = _t(rng, (b, sk, hkv, d), bf), _t(rng, (b, sk, hkv, d), bf)
    out = flash_attention(q, k, v, **kw)
    rounded = attention_backward_bf16_products(do, q, k, v, out, **kw)
    for g, r in zip(rounded, attention_chunked_backward(do, q, k, v, **kw)):
        _close(g, r, bf)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(rng):
    q = _t(rng, (1, 8, 2, 256))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_backward_cuda(q, q, q, q, q, True, None, None, 0)
    q = _t(rng, (1, 8, 2, 64))
    k = _t(rng, (1, 8, 2, 64), torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention_backward_cuda(q, q, k, k, q, True, None, None, 0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_backward_cuda(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                                      q, q, q, True, None, None, 0)
    qm = torch.zeros(8 * 2 * 64 + 1)[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_backward_cuda(qm, q, q, q, q, True, None, None, 0)
    x = _t(rng, (4, 16))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_backward_cuda(x.t(), x.t(), _t(rng, (4,)), 1e-6, 0.0)
    with pytest.raises(ValueError, match="at most"):
        y = _t(rng, (1, 8200))
        rmsnorm_backward_cuda(y, y, _t(rng, (8200,)), 1e-6, 0.0)
    with pytest.raises(TypeError):
        rmsnorm_backward_cuda(x, x.bfloat16(), _t(rng, (16,)), 1e-6, 0.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2048, 1024), (32768, 128), (16384, 128), (65, 130),
                                   (64, 2560), (4, 768), (4, 256)])
def test_rmsnorm_backward_kernel_matches_plain_on_card(rng, dtype, shape):
    _card()
    x, dy = _t(rng, shape, dtype, "cuda"), _t(rng, shape, dtype, "cuda")
    w = (_t(rng, shape[-1:], torch.float32, "cuda") * 0.1 + 1.0).to(dtype)
    before = library.LAUNCHES["rmsnorm_backward"]
    dx, dw = rmsnorm_backward_op(dy, x, w, 1e-6, 0.0)
    rx, rw = rmsnorm_backward_ref(dy, x, w, 1e-6, 0.0)
    assert library.LAUNCHES["rmsnorm_backward"] == before + 1
    _close(dx, rx, dtype)
    _close(dw, rw, dtype)
    dx2, dw2 = rmsnorm_backward_op(dy, x, w, 1e-6, 0.0)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_backward_kernel_matches_plain_on_card(rng, dtype, case):
    _card()
    (b, sq, sk, hq, hkv, d), kw = FLASH_CASES[case]
    q, do = _t(rng, (b, sq, hq, d), dtype, "cuda"), _t(rng, (b, sq, hq, d), dtype, "cuda")
    k, v = _t(rng, (b, sk, hkv, d), dtype, "cuda"), _t(rng, (b, sk, hkv, d), dtype, "cuda")
    out = flash_attention(q, k, v, **kw)
    args = (kw.get("causal", True), kw.get("window"), kw.get("logit_cap"), kw.get("q_offset", 0))
    before = library.LAUNCHES["flash_attention_backward"]
    grads = flash_attention_backward_op(do, q, k, v, out, *args)
    assert library.LAUNCHES["flash_attention_backward"] == before + 1
    refs = attention_chunked_backward(do, q, k, v, **kw)
    for g, r in zip(grads, refs):
        _close(g, r, dtype)
    again = flash_attention_backward_op(do, q, k, v, out, *args)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
