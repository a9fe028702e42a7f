"""The port's gated SSD scan: its plain PyTorch version against the JAX
package's Pallas kernel in interpret mode and its ref.py, at the shapes of
tests/test_kernels.py::TestSSMScan (2e-4; 3e-4 against the naive recurrence;
2e-3 for the decode step against the scan), plus the mLSTM gated form,
padding of a sequence that is no chunk multiple, and an initial state.  The
CPU op is the plain version and traces as one node with two outputs; the CUDA
wrapper raises on what the kernel does not take; holding the kernel against
its plain version needs the card (``requires_cuda``)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro_torch.kernels.ssm_scan import (  # noqa: E402
    gated_scan,
    gated_scan_cuda,
    gated_scan_mma_ref,
    gated_scan_padded,
    gated_scan_ref,
    scan_plan,
    ssm_scan,
    ssm_scan_ref,
    ssm_step,
)
from repro_torch.kernels.ssm_scan import ref as scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import MAX_CHUNK, MAX_STATE, _pad_seq  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_kernels.py, f32
NAIVE_TOL = dict(rtol=3e-4, atol=3e-4)  # against the step-by-step recurrence
STEP_TOL = dict(rtol=2e-3, atol=2e-3)   # decode steps against the chunked scan
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # tests/test_kernels.py, bf16
SMEM_MAX = 232448                       # dynamic shared memory a block may take on the H100
SHAPES = [(2, 64, 4, 8, 2, 16, 16), (1, 96, 8, 16, 1, 32, 32), (1, 48, 2, 8, 2, 8, 16)]
# zamba2-1.2b's head shapes (P 64, N 64, one group) with few heads: the
# stateless bucket (one chunk of 64), the prefill (one chunk of 16) and a
# padded multi-chunk sequence
ZAMBA_HEADS = [(1, 64, 4, 64, 1, 64, 64), (1, 16, 4, 64, 1, 64, 16), (1, 300, 2, 64, 1, 64, 128)]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    from repro.kernels import ssm_scan as j

    return j


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _mamba_inputs(rng, b, s, h, p, g, n):
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(0.5, 0.2, (b, s, h))) + 0.01).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.3, (h,))).astype(np.float32)
    Bm = rng.normal(0, 1, (b, s, g, n)).astype(np.float32)
    Cm = rng.normal(0, 1, (b, s, g, n)).astype(np.float32)
    D = rng.normal(0, 1, (h,)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _naive(x, dt, A, Bm, Cm, D):
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    hst = np.zeros((b, h, n, p), np.float64)
    ys = np.zeros_like(x, dtype=np.float64)
    for t in range(s):
        for bb in range(b):
            for hh in range(h):
                gg = hh // rep
                hst[bb, hh] = np.exp(dt[bb, t, hh] * A[hh]) * hst[bb, hh] + dt[
                    bb, t, hh
                ] * np.outer(Bm[bb, t, gg], x[bb, t, hh])
                ys[bb, t, hh] = Cm[bb, t, gg] @ hst[bb, hh] + D[hh] * x[bb, t, hh]
    return ys, hst


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_plain_vs_pallas_and_naive(jref, rng, b, s, h, p, g, n, chunk):
    args = _mamba_inputs(rng, b, s, h, p, g, n)
    y_pl, h_pl = jref.ssm_scan(*args, chunk=chunk, interpret=True)
    y_jr, h_jr = jref.ssm_scan_ref(*args, chunk=chunk)
    y, hf = ssm_scan(*(_t(a) for a in args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_pl), **TOL)
    y_r, h_r = ssm_scan_ref(*(_t(a) for a in args), chunk=chunk)
    np.testing.assert_allclose(y_r.numpy(), np.asarray(y_jr), **TOL)
    np.testing.assert_allclose(h_r.numpy(), np.asarray(h_jr), **TOL)
    y_naive, h_naive = _naive(*args)
    np.testing.assert_allclose(y.numpy(), y_naive, **NAIVE_TOL)
    np.testing.assert_allclose(hf.numpy(), h_naive, **NAIVE_TOL)


def test_gated_form_mlstm(jref, rng):
    """mLSTM: ld = log sigmoid(f), gi = exp(i), one group per head, no D."""
    b, s, h, p, g, n, chunk = 2, 48, 4, 8, 4, 8, 16
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    ld = -np.abs(rng.normal(0.3, 0.2, (b, s, h))).astype(np.float32)
    gi = np.abs(rng.normal(0.8, 0.3, (b, s, h))).astype(np.float32)
    Bm = rng.normal(0, 1, (b, s, g, n)).astype(np.float32)
    Cm = rng.normal(0, 1, (b, s, g, n)).astype(np.float32)
    y_pl, h_pl = jref.gated_scan(x, ld, gi, Bm, Cm, None, chunk=chunk, interpret=True)
    y, hf = gated_scan(_t(x), _t(ld), _t(gi), _t(Bm), _t(Cm), None, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_pl), **TOL)


def test_nondivisible_seq_padding(jref, rng):
    """S = 17 with chunk 8: padded with identity steps to 24, as the
    reference's wrapper pads."""
    args = _mamba_inputs(rng, 1, 17, 2, 4, 1, 8)
    y, hf = ssm_scan(*(_t(a) for a in args), chunk=8)
    y_naive, h_naive = _naive(*args)
    np.testing.assert_allclose(y.numpy(), y_naive, **NAIVE_TOL)
    np.testing.assert_allclose(hf.numpy(), h_naive, **NAIVE_TOL)
    y_j, h_j = jref.ssm_scan(*args, chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_j), **TOL)


def test_initial_state(jref, rng):
    """A scan from h0 against the reference's ``gated_scan_ref(h0=)``, and
    against two halves chained through the first half's final state."""
    b, s, h, p, g, n = 2, 32, 4, 8, 2, 16
    x, dt, A, Bm, Cm, D = _mamba_inputs(rng, b, s, h, p, g, n)
    h0 = rng.normal(0, 1, (b, h, n, p)).astype(np.float32)
    ld = (dt * A[None, None]).astype(np.float32)
    y_j, h_j = jref.gated_scan_ref(x, ld, dt, Bm, Cm, D, chunk=8, h0=h0)
    y, hf = gated_scan(_t(x), _t(ld), _t(dt), _t(Bm), _t(Cm), _t(D), chunk=8, h0=_t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_j), **TOL)
    half = s // 2
    y1, h1 = gated_scan(*(_t(a[:, :half]) for a in (x, ld, dt, Bm, Cm)), _t(D), chunk=8)
    y2, h2 = gated_scan(*(_t(a[:, half:]) for a in (x, ld, dt, Bm, Cm)), _t(D), chunk=8,
                        h0=h1)
    y_full, h_full = gated_scan(_t(x), _t(ld), _t(dt), _t(Bm), _t(Cm), _t(D), chunk=8)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), **TOL)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), **TOL)


def test_step_matches_scan(jref, rng):
    b, s, h, p, g, n = 2, 32, 4, 8, 2, 16
    x, dt, A, Bm, Cm, D = _mamba_inputs(rng, b, s, h, p, g, n)
    y_scan, h_scan = ssm_scan(*(_t(a) for a in (x, dt, A, Bm, Cm, D)), chunk=8)
    hst = torch.zeros((b, h, n, p))
    hst_j = np.zeros((b, h, n, p), np.float32)
    for t in range(s):
        y_t, hst = ssm_step(_t(x[:, t]), _t(dt[:, t]), _t(A), _t(Bm[:, t]), _t(Cm[:, t]),
                            _t(D), hst)
        yj_t, hst_j = jref.ssm_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D, hst_j)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(yj_t), **TOL)
    np.testing.assert_allclose(y_t.numpy(), y_scan[:, -1].numpy(), **STEP_TOL)
    np.testing.assert_allclose(hst.numpy(), h_scan.numpy(), **STEP_TOL)
    np.testing.assert_allclose(hst.numpy(), np.asarray(hst_j), **TOL)


def test_cpu_op_is_the_plain_version(rng):
    x, dt, A, Bm, Cm, D = (_t(a) for a in _mamba_inputs(rng, 1, 20, 4, 8, 2, 16))
    ld = dt * A
    y, hf = gated_scan(x, ld, dt, Bm, Cm, D, chunk=8)
    y_r, h_r = gated_scan_padded(x, ld, dt, Bm, Cm, D, None, 8)
    assert torch.equal(y, y_r) and torch.equal(hf, h_r)
    assert y.is_contiguous() and hf.dtype == torch.float32


def test_traces_as_one_node_with_two_outputs(rng):
    """make_fx keeps the scan as one node (the wrapper's casts and copies of
    views are their own aten nodes) whose fake outputs are y in x's dtype and
    the f32 state."""
    x = _t(rng.normal(0, 1, (1, 16, 4, 8)).astype(np.float32)).to(torch.bfloat16)
    bc = _t(rng.normal(0, 1, (1, 16, 1, 16)).astype(np.float32)).to(torch.bfloat16)
    ld = torch.full((1, 16, 4), -0.1)

    def app(x, ld, bc):
        y, h = gated_scan(x, ld, ld.exp(), bc, bc, None, chunk=8)
        return y, h

    gm = make_fx(app, tracing_mode="fake")(x, ld, bc)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    scans = [n for n in nodes if str(n.target) == "repro_torch.gated_scan.default"]
    assert len(scans) == 1
    y_meta, h_meta = scans[0].meta["val"]
    assert y_meta.dtype == torch.bfloat16 and tuple(y_meta.shape) == (1, 16, 4, 8)
    assert h_meta.dtype == torch.float32 and tuple(h_meta.shape) == (1, 4, 16, 8)


def _mma_ref_padded(x, ld, gi, Bm, Cm, D, chunk, h0=None):
    """``gated_scan_mma_ref`` with the wrapper's padding rule."""
    s = x.shape[1]
    eff = min(chunk, s)
    pad = (-s) % eff
    if pad:
        x, ld, gi, Bm, Cm = (_pad_seq(t, pad) for t in (x, ld, gi, Bm, Cm))
    y, h = gated_scan_mma_ref(x, ld, gi, Bm, Cm, D, chunk=eff, h0=h0)
    return y[:, :s], h


def _bf16_mamba(rng, b, s, h, p, g, n):
    """Mamba2 inputs with x, B and C rounded to bf16: numpy f32 arrays of
    the bf16 values (for JAX) and the torch tensors (x, B, C in bf16)."""
    x, dt, A, Bm, Cm, D = _mamba_inputs(rng, b, s, h, p, g, n)
    x, Bm, Cm = (_t(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    ld = (dt * A[None, None]).astype(np.float32)
    arrays = [x.float().numpy(), ld, dt, Bm.float().numpy(), Cm.float().numpy(), D]
    return arrays, [x, _t(ld), _t(dt), Bm, Cm, _t(D)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", ZAMBA_HEADS)
def test_mma_roundings_vs_jax(jref, rng, b, s, h, p, g, n, chunk):
    """The plain mirror of the bf16 tensor-core route's roundings (S, B*w and
    h each as two bf16 terms) against the JAX scan on the same bf16 inputs,
    within the bf16 tolerance, before any card run."""
    arrays, tensors = _bf16_mamba(rng, b, s, h, p, g, n)
    y_j, h_j = jref.gated_scan(*arrays, chunk=chunk)
    y, hf = _mma_ref_padded(*tensors, chunk)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j), **BF16_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_j), **BF16_TOL)
    # with an initial state: the first chunk's C.h takes the split h0 too
    h0 = rng.normal(0, 1, (b, h, n, p)).astype(np.float32)
    y_j, h_j = jref.gated_scan_ref(*(_pad_seq_np(a, s, chunk) for a in arrays[:5]), arrays[5],
                                   chunk=min(chunk, s), h0=h0)
    y, hf = _mma_ref_padded(*tensors, chunk, h0=_t(h0))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j)[:, :s], **BF16_TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_j), **BF16_TOL)


def _pad_seq_np(a: np.ndarray, s: int, chunk: int) -> np.ndarray:
    pad = (-s) % min(chunk, s)
    return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))


def test_one_bf16_rounding_misses_the_tolerance(rng, monkeypatch):
    """Why the tensor-core route carries S, B*w and h as two bf16 terms:
    rounded once, y strays past the bf16 tolerance from the plain version at
    zamba2's head shape; as two terms it is off by little more than the
    final rounding of y."""
    _, (x, ld, dt, Bm, Cm, D) = _bf16_mamba(rng, 1, 64, 4, 64, 1, 64)
    y_r, h_r = gated_scan_padded(x, ld, dt, Bm, Cm, D, None, 64)

    def worst(out, ref):
        err = (out.float() - ref.float()).abs()
        return float((err / (2e-2 + 2e-2 * ref.float().abs())).max())

    y2, h2 = _mma_ref_padded(x, ld, dt, Bm, Cm, D, 64)
    assert worst(y2, y_r) <= 0.5
    torch.testing.assert_close(h2, h_r, rtol=1e-4, atol=1e-4)
    monkeypatch.setattr(scan_ref, "bf16_terms", lambda t: t.to(torch.bfloat16).float())
    y1, _ = _mma_ref_padded(x, ld, dt, Bm, Cm, D, 64)
    assert worst(y1, y_r) > 1.0


class TestScanPlan:
    """The route by dtype, the grid at the served shapes, and the shared
    memory of every chunk and state size the kernel takes."""

    @pytest.mark.parametrize(
        "b,s,h,p,g,n,chunk,warps,grid",
        [
            (1, 64, 64, 64, 1, 64, 64, 4, (2, 64, 1)),     # zamba2's stateless bucket
            (1, 16, 64, 64, 1, 64, 16, 4, (2, 64, 1)),     # zamba2's prefill
            (1, 300, 64, 64, 1, 64, 128, 8, (2, 64, 1)),   # chunks of 128
            (2, 77, 4, 33, 4, 16, 32, 4, (2, 4, 2)),       # mLSTM at a ragged P
            (1, 40, 8, 130, 2, 32, 80, 8, (5, 8, 1)),      # P over five 32-column tiles
        ],
    )
    def test_bf16_takes_the_tensor_cores(self, b, s, h, p, g, n, chunk, warps, grid):
        plan = scan_plan(b, s, h, p, g, n, chunk, torch.bfloat16)
        assert (plan["route"], plan["warps"], plan["grid"]) == ("mma", warps, grid)

    def test_f32_keeps_the_cuda_cores(self):
        plan = scan_plan(1, 64, 64, 64, 1, 64, 64, torch.float32)
        assert plan == dict(route="cuda_cores", warps=8, grid=(2, 64, 1),
                            smem=4 * (64 * 32 + 64 * 32 + 64 * 65 + 64 * 64 + 12 * 64))
        with pytest.raises(TypeError):
            scan_plan(1, 64, 64, 64, 1, 64, 64, torch.float16)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_shared_memory_fits_every_chunk_and_state(self, dtype):
        sizes = [scan_plan(1, MAX_CHUNK, 1, 64, 1, n, q, dtype)["smem"]
                 for n in range(1, MAX_STATE + 1) for q in range(1, MAX_CHUNK + 1)]
        assert max(sizes) == sizes[-1] <= SMEM_MAX
        # the stateless bucket's chunk: x and y 2 x (64 x 40) bf16, B and C
        # 2 x (64 x 72) bf16, the f32 state 64 x 36, and 2 x 64 f32
        assert scan_plan(1, 64, 64, 64, 1, 64, 64, torch.bfloat16)["smem"] == 38400


    def test_wide_mma_route(self):
        """N from 129 to 1024 at every chunk: 8 warps, blocks of 32 columns
        of P, two stages of B and C slabs (128 columns up to a chunk of 64,
        64 beyond), within a block's shared memory; xlstm-1.3b's stateless
        bucket and training forward pinned (the training chunk takes
        exactly the 227 KB)."""
        for n in range(129, MAX_STATE + 1):
            np_ = -(-n // 16) * 16
            for q in range(1, MAX_CHUNK + 1):
                plan = scan_plan(2, MAX_CHUNK, 4, 1025, 4, n, q, torch.bfloat16)
                qp, slab = -(-q // 16) * 16, 128 if q <= 64 else 64
                assert (plan["route"], plan["warps"], plan["slab"]) == ("mma_wide", 8, slab)
                assert plan["grid"] == (33, 4, 2) and plan["warps"] * 16 >= qp
                assert plan["smem"] == (qp * 40 * 2 + 2 * 2 * qp * (slab + 8) * 2
                                        + np_ * 36 * 4 + 2 * qp * 4) <= SMEM_MAX
        bucket = scan_plan(1, 64, 4, 1025, 4, 1024, 64, torch.bfloat16)
        train = scan_plan(1, 512, 4, 1025, 4, 1024, 128, torch.bfloat16)
        assert bucket == dict(route="mma_wide", warps=8, slab=128, grid=(33, 4, 1),
                              smem=222720)
        assert train == dict(route="mma_wide", warps=8, slab=64, grid=(33, 4, 1),
                             smem=SMEM_MAX)


class TestCudaWrapperRaises:
    """The checks run before any device call, so they are exercised here on
    CPU tensors."""

    def _args(self, n=16, dtype=torch.float32, chunk=16):
        x = torch.zeros(1, 32, 4, 8, dtype=dtype)
        ld = torch.zeros(1, 32, 4)
        bc = torch.zeros(1, 32, 2, n, dtype=dtype)
        return [x, ld, ld, bc, bc, None, None, chunk]

    def test_state_too_large(self):
        with pytest.raises(ValueError, match="N=2048"):
            gated_scan_cuda(*self._args(n=2048))

    def test_dtype(self):
        with pytest.raises(TypeError):
            gated_scan_cuda(*self._args(dtype=torch.float16))
        args = self._args()
        args[1] = args[1].double()
        with pytest.raises(TypeError, match="float32"):
            gated_scan_cuda(*args)

    def test_chunk_and_views(self):
        with pytest.raises(ValueError, match="chunk"):
            gated_scan_cuda(*self._args(chunk=0))
        args = self._args()
        args[0] = torch.zeros(1, 32, 8, 4).transpose(2, 3)
        with pytest.raises(ValueError, match="contiguous"):
            gated_scan_cuda(*args)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,p,g,n,chunk,use_d",
    [(1, 16, 64, 64, 1, 64, 16, True), (1, 300, 64, 64, 1, 64, 128, True),
     (2, 77, 4, 33, 4, 16, 32, False), (1, 64, 64, 64, 1, 64, 64, True),
     (1, 77, 4, 64, 1, 64, 32, True), (2, 40, 8, 33, 8, 20, 40, False)],
)
def test_kernel_matches_plain_on_card(rng, dtype, b, s, h, p, g, n, chunk, use_d):
    """The CUDA kernel against its plain version on the card: zamba2's
    prefill shape, a padded multi-chunk sequence, the mLSTM form at a ragged
    P (G = H, no D), one chunk of 64 (the stateless bucket), a ragged last
    chunk (S = 77, chunk 32), and N and P that are no multiple of 8 (the
    tensor-core route's scalar staging)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    dt_ = getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    x, dt, A, Bm, Cm, D = _mamba_inputs(rng, b, s, h, p, g, n)
    x, Bm, Cm = (_t(a).to(dt_).cuda() for a in (x, Bm, Cm))
    dt, A = _t(dt).cuda(), _t(A).cuda()
    D = _t(D).cuda() if use_d else None
    ld = dt * A
    y, hf = gated_scan(x, ld, dt, Bm, Cm, D, chunk=chunk)
    y_r, h_r = gated_scan_padded(x, ld, dt, Bm, Cm, D, None, chunk)
    torch.testing.assert_close(y.float(), y_r.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(hf, h_r, rtol=tol, atol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_with_initial_state_on_card(rng, dtype):
    """A given h0, over three chunks with a ragged last one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    dt_ = getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    b, s, h, p, g, n = 1, 70, 8, 64, 2, 64
    x, dt, A, Bm, Cm, D = _mamba_inputs(rng, b, s, h, p, g, n)
    x, Bm, Cm = (_t(a).to(dt_).cuda() for a in (x, Bm, Cm))
    ld, dt, D = _t(dt * A[None, None]).cuda(), _t(dt).cuda(), _t(D).cuda()
    h0 = _t(rng.normal(0, 1, (b, h, n, p)).astype(np.float32)).cuda()
    y, hf = gated_scan(x, ld, dt, Bm, Cm, D, chunk=32, h0=h0)
    y_r, h_r = gated_scan_padded(x, ld, dt, Bm, Cm, D, h0, 32)
    torch.testing.assert_close(y.float(), y_r.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(hf, h_r, rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_kernel_refuses_large_state_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    x = torch.zeros(1, 8, 2, 8, device="cuda")
    ld = torch.zeros(1, 8, 2, device="cuda")
    bc = torch.zeros(1, 8, 1, 2048, device="cuda")
    with pytest.raises(ValueError, match="N=2048"):
        gated_scan(x, ld, ld, bc, bc)


def _mlstm_inputs(rng, b, s, h, n):
    """The mLSTM's scan operands: x = [v, 1] (P = N + 1), ld = log sigmoid(f),
    gi = exp(min(i, 8)), keys at the mLSTM's scale (W_k x / sqrt(N))."""
    x = rng.normal(0, 1, (b, s, h, n + 1)).astype(np.float32)
    x[..., -1] = 1.0
    ld = np.log(1 / (1 + np.exp(-rng.normal(3, 1, (b, s, h))))).astype(np.float32)
    gi = np.exp(np.minimum(rng.normal(0, 1, (b, s, h)), 8.0)).astype(np.float32)
    k = (rng.normal(0, 1, (b, s, h, n)) / np.sqrt(n)).astype(np.float32)
    q = rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
    return x, ld, gi, k, q


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,n,chunk,with_h0",
                         [(1, 64, 1024, 64, False), (1, 16, 1024, 128, False),
                          (1, 150, 160, 64, True), (2, 40, 200, 32, True)])
def test_wide_scan_matches_plain_on_card(rng, dtype, b, s, n, chunk, with_h0):
    """The wide routes (N > 128) against the plain version: xlstm-1.3b's
    bucket and prefill (N = 1024, P = 1025), a ragged N with an initial state
    over three chunks, and N no multiple of 8 (scalar B/C staging); two runs
    of the kernel give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    dt_ = getattr(torch, dtype)
    x, ld, gi, k, q = _mlstm_inputs(rng, b, s, 4, n)
    x, k, q = (_t(a).to(dt_).cuda() for a in (x, k, q))
    ld, gi = _t(ld).cuda(), _t(gi).cuda()
    h0 = _t(rng.normal(0, 1, (b, 4, n, n + 1)).astype(np.float32)).cuda() if with_h0 else None
    y, h = gated_scan(x, ld, gi, k, q, None, chunk=chunk, h0=h0)
    y_r, h_r = gated_scan_padded(x, ld, gi, k, q, None, h0, chunk)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(y.float(), y_r.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_r, rtol=tol, atol=tol)
    y2, h2 = gated_scan(x, ld, gi, k, q, None, chunk=chunk, h0=h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)
