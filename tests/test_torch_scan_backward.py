"""The gradient of the gated SSD scan: ``repro_torch::gated_scan_backward``,
registered as ``repro_torch::gated_scan``'s autograd.

On the CPU its body is the plain backward (``ref.gated_scan_backward_ref``,
written out over the chunked intermediates), held against ``jax.vjp`` of the
reference's ``gated_scan`` / ``ssm_scan`` (which run ``gated_scan_ref`` on
the CPU) and of ``gated_scan_ref`` itself where an initial state is given,
on the same seeded inputs and cotangents on both y and the final state:
tests/test_torch_ssm_scan.py's shapes, G < H, P != N, the mLSTM form (P =
N + 1, no D), a sequence that is no chunk multiple, with and without h0 and
D, and the Mamba2 wrapper with gradients into dt and A; f32 within 2e-4,
bf16 inputs within 2e-2 of the largest magnitude.  The mirror of the bf16
kernel's roundings (``gated_scan_backward_mma_ref``) is held against the
same ``jax.vjp`` at 2e-2 and against the plain backward's f64 witness
within 2^-16 of each gradient's largest magnitude; the plain backward in
f32 stays within 1e-4 (relative L2) of the mirror, where the same backward
with the split's low terms dropped lies over 1e-3 from it.  Autograd through the op is
the plain backward bitwise; ``torch.library.opcheck`` passes on both ops; a
trace without grad keeps one scan node; the launch plan fits the card's
shared memory, and the bf16 narrow route's workspace holds no S or G; the
plain backward's f64 witness is its f32 arithmetic in f64.  On the card (``requires_cuda``): the kernel against its plain version
on both routes and both dtypes, each gradient element within 2e-4 (f32) or
2e-2 (bf16) plus 4 x the plain version's own f32 rounding (its distance to
the f64 witness), two launches bitwise equal."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import library  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    gated_scan,
    gated_scan_backward_cuda,
    gated_scan_backward_op,
    gated_scan_backward_padded,
    gated_scan_backward_witness,
    scan_backward_plan,
    ssm_scan,
)
from repro_torch.kernels.ssm_scan.ops import gated_scan_op  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import bf16_terms  # noqa: E402

SMEM_MAX = 232448        # bytes of shared memory an H100 block may take
STATIC_SMEM_MAX = 49152  # a block's static shared memory
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# (b, s, h, p, g, n, chunk, with D, with h0): tests/test_torch_ssm_scan.py's
# SHAPES (G < H in the first, P != N in all), a ragged S, zamba2's head
# shape, the mLSTM form (P = N + 1, G = H, no D) whole and ragged, and an
# initial state with and without D
CASES = {
    "shapes0": (2, 64, 4, 8, 2, 16, 16, True, False),
    "shapes1": (1, 96, 8, 16, 1, 32, 32, True, False),
    "shapes2": (1, 48, 2, 8, 2, 8, 16, True, False),
    "ragged": (2, 77, 4, 8, 2, 16, 32, True, False),
    "zamba2_head": (1, 64, 2, 64, 1, 64, 32, True, False),
    "mlstm": (2, 40, 4, 17, 4, 16, 16, False, False),
    "mlstm_ragged": (1, 50, 2, 9, 2, 8, 16, False, False),
    "h0_d": (2, 64, 4, 8, 2, 16, 16, True, True),
    "h0_mlstm": (1, 48, 4, 17, 4, 16, 16, False, True),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jax_scan():
    jax = pytest.importorskip("jax")
    from repro.kernels.ssm_scan import ops as jops
    from repro.kernels.ssm_scan.ref import gated_scan_ref as j_ref

    return jax, jops, j_ref


def _inputs(rng, b, s, h, p, g, n, with_d, with_h0, mlstm=False):
    """Seeded numpy operands and cotangents: ld <= 0, gi >= 0 (the mLSTM's
    exp(i) when ``mlstm``), B at the mLSTM's key scale when ``mlstm``."""
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    if mlstm:
        ld = np.log(1 / (1 + np.exp(-rng.normal(3, 1, (b, s, h))))).astype(np.float32)
        gi = np.exp(np.minimum(rng.normal(0, 1, (b, s, h)), 8.0)).astype(np.float32)
        bm = (rng.normal(0, 1, (b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    else:
        ld = -np.abs(rng.normal(0.5, 0.3, (b, s, h))).astype(np.float32)
        gi = (np.abs(rng.normal(0.5, 0.2, (b, s, h))) + 0.01).astype(np.float32)
        bm = rng.normal(0, 1, (b, s, g, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, s, g, n)).astype(np.float32)
    d = rng.normal(0, 1, (h,)).astype(np.float32) if with_d else None
    h0 = rng.normal(0, 1, (b, h, n, p)).astype(np.float32) if with_h0 else None
    dy = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dh = rng.normal(0, 1, (b, h, n, p)).astype(np.float32)
    return x, ld, gi, bm, cm, d, h0, dy, dh


def _t(a, dtype=torch.float32, device="cpu"):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


def _np(t):
    return np.asarray(t.astype(np.float32)) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


def _close(out, ref, dtype, what=""):
    tol = TOL[dtype]
    ref = np.asarray(ref, np.float32)
    atol = tol * float(np.abs(ref).max()) if dtype == torch.bfloat16 else tol
    np.testing.assert_allclose(_np(out), ref, rtol=tol, atol=atol, err_msg=what)


def _port_grads(x, ld, gi, bm, cm, d, h0, dy, dh, chunk):
    """Autograd through the port's op: the gradients of <y, dy> + <h, dh>."""
    leaves = [t.requires_grad_(True) for t in (x, ld, gi, bm, cm, d, h0) if t is not None]
    y, h = gated_scan(x, ld, gi, bm, cm, d, chunk=chunk, h0=h0)
    grads = iter(torch.autograd.grad((y.float() * dy.float()).sum() + (h * dh).sum(), leaves))
    return [next(grads) if t is not None else None for t in (x, ld, gi, bm, cm, d, h0)]


def _jax_grads(jax_scan, case, arrays, dtype):
    """``jax.vjp`` of the reference's ``gated_scan`` (``gated_scan_ref``
    where an initial state is given) on a case's numpy operands, inputs in
    ``dtype``; the gradients of x, ld, gi, B, C (D) (h0)."""
    jax, jops, j_ref = jax_scan
    jnp = jax.numpy
    b, s, h, p, g, n, chunk, with_d, with_h0 = CASES[case]
    x, ld, gi, bm, cm, d, h0, dy, dh = arrays
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jb, jc, jdy = (jnp.asarray(a).astype(jdt) for a in (x, bm, cm, dy))
    primals = [jx, jnp.asarray(ld), jnp.asarray(gi), jb, jc] + ([jnp.asarray(d)] if with_d else [])
    if with_h0:
        def fn(*a):
            dd = a[5] if with_d else None
            return j_ref(*a[:5], dd, chunk=chunk, h0=a[-1])
        primals.append(jnp.asarray(h0))
    else:
        def fn(*a):
            return jops.gated_scan(*a[:5], a[5] if with_d else None, chunk=chunk)
    _, vjp = jax.vjp(fn, *primals)
    return vjp((jdy, jnp.asarray(dh)))


def _case_inputs(rng, case):
    b, s, h, p, g, n, chunk, with_d, with_h0 = CASES[case]
    mlstm = case.startswith("mlstm") or case == "h0_mlstm"
    return _inputs(rng, b, s, h, p, g, n, with_d, with_h0, mlstm)


def _grad_names(case):
    with_d, with_h0 = CASES[case][7:]
    return ["dx", "dld", "dgi", "dB", "dC"] + ["dD"] * with_d + ["dh0"] * with_h0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(jax_scan, rng, case, dtype):
    arrays = _case_inputs(rng, case)
    x, ld, gi, bm, cm, d, h0, dy, dh = arrays
    tdt = DTYPES[dtype]
    ref = _jax_grads(jax_scan, case, arrays, tdt)
    chunk = CASES[case][6]
    ours = _port_grads(_t(x, tdt), _t(ld), _t(gi), _t(bm, tdt), _t(cm, tdt), _t(d), _t(h0),
                       _t(dy, tdt), _t(dh), chunk)
    ours = [t for t in ours if t is not None]
    assert len(ours) == len(ref)
    for name, o, r in zip(_grad_names(case), ours, ref):
        _close(o, _np(r), tdt, f"{case} {dtype} {name}")
        assert o.dtype == (tdt if name in ("dx", "dB", "dC") else torch.float32), name


def _mirror_args(arrays, chunk):
    """The backward op's arguments on bf16 x, dy, B and C (f32 the rest)."""
    x, ld, gi, bm, cm, d, h0, dy, dh = arrays
    bf = torch.bfloat16
    return (_t(dy, bf), _t(dh), _t(x, bf), _t(ld), _t(gi), _t(bm, bf), _t(cm, bf), _t(d), _t(h0),
            chunk)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mma_mirror_matches_jax_vjp(jax_scan, rng, case):
    """``gated_scan_backward_mma_ref`` (through the padding wrapper, on the
    bf16 inputs' f32 values) against ``jax.vjp`` of the reference with bf16
    inputs, within the bf16 tolerance of 2e-2."""
    arrays = _case_inputs(rng, case)
    ref = _jax_grads(jax_scan, case, arrays, torch.bfloat16)
    args = _mirror_args(arrays, CASES[case][6])
    mirror = [t for t in gated_scan_backward_padded(
        *(a.float() if isinstance(a, torch.Tensor) else a for a in args), mma=True)
        if t is not None]
    assert len(mirror) == len(ref)
    for name, o, r in zip(_grad_names(case), mirror, ref):
        _close(o, _np(r), torch.bfloat16, f"{case} mirror {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mma_mirror_within_the_split_of_the_f64_witness(rng, case):
    """The mirror against the plain backward in f64 on the same inputs: each
    two-term operand keeps 16 significant bits (its residual is below 2^-17
    of it), so every gradient stays within 2^-16 of its largest magnitude;
    the witness's own f32 run is closer still.  The split runs where the mirror says: ``bf16_terms`` of an
    f32 tensor is within 2^-17 of it."""
    args = _mirror_args(_case_inputs(rng, case), CASES[case][6])
    mirror = gated_scan_backward_padded(
        *(a.float() if isinstance(a, torch.Tensor) else a for a in args), mma=True)
    f32, f64 = gated_scan_backward_witness(*args)
    for name, m, lo, w in zip(("dx", "dld", "dgi", "dB", "dC", "dD", "dh0"), mirror, f32, f64):
        if w is None:
            assert m is None, name
            continue
        bound = 2.0 ** -16 * float(w.abs().max())
        err = float((m.double() - w).abs().max())
        assert err <= bound, (case, name, err, bound)
        assert float((lo.double() - w).abs().max()) <= err or err < 1e-5, (case, name)
    t = torch.from_numpy(rng.normal(0, 30, (257,)).astype(np.float32))
    assert float(((bf16_terms(t) - t).abs() / t.abs()).max()) <= 2.0 ** -17


@pytest.mark.parametrize("case", sorted(CASES))
def test_mma_mirror_tells_two_terms_from_one(rng, case):
    """What the card holds the bf16 kernel to: its distance to the mirror
    (relative L2, gradient by gradient).  The plain backward in f32, whose
    products take every f32 operand whole, stays within 1e-4 of the mirror
    on every gradient; the same backward with each split operand rounded to
    bf16 once (the second term dropped) lies over 1e-3 from it on some
    gradient.  So a kernel that lost its low terms would not pass for the
    mirror."""
    from repro_torch.kernels.ssm_scan.ops import _pad_seq
    from repro_torch.kernels.ssm_scan.ref import gated_scan_backward_ref

    args = [a.float() if isinstance(a, torch.Tensor) else a
            for a in _mirror_args(_case_inputs(rng, case), CASES[case][6])]
    mirror = gated_scan_backward_padded(*args, mma=True)
    plain = gated_scan_backward_padded(*args)
    dy, dh, x, ld, gi, bm, cm, d, h0, chunk = args
    s = x.shape[1]
    eff = min(chunk, s)
    padded = [_pad_seq(t, (-s) % eff) for t in (dy, x, ld, gi, bm, cm)]
    one = gated_scan_backward_ref(padded[0], dh, *padded[1:], d, h0, chunk=eff,
                                  terms=lambda t: t.to(torch.bfloat16).float())
    one = [None if t is None else (t[:, :s] if i < 5 else t) for i, t in enumerate(one)]

    def rel(got, ref):
        return float((got - ref).norm() / ref.norm())

    pairs = [(m, p, o) for m, p, o in zip(mirror, plain, one) if m is not None]
    assert max(rel(p, m) for m, p, _ in pairs) <= 1e-4, case
    assert max(rel(o, m) for m, _, o in pairs) > 1e-3, case


@pytest.mark.parametrize("case", ["ragged", "h0_d", "mlstm_ragged"])
def test_witness_is_the_plain_backward_in_f32_and_in_f64(rng, case):
    """``gated_scan_backward_witness``: its f32 gradients are the plain
    backward's on f32 inputs bitwise, its f64 ones the same arithmetic in
    f64 (their distance: f32's rounding, within the f32 tolerance)."""
    b, s, h, p, g, n, chunk, with_d, with_h0 = CASES[case]
    x, ld, gi, bm, cm, d, h0, dy, dh = _inputs(rng, b, s, h, p, g, n, with_d, with_h0,
                                               case.startswith("mlstm"))
    args = (_t(dy, torch.bfloat16), _t(dh), _t(x, torch.bfloat16), _t(ld), _t(gi),
            _t(bm, torch.bfloat16), _t(cm, torch.bfloat16), _t(d), _t(h0), chunk)
    lo, hi = gated_scan_backward_witness(*args)
    f32 = gated_scan_backward_padded(*(a.float() if isinstance(a, torch.Tensor) else a
                                       for a in args))
    for name, a, w, r in zip(("dx", "dld", "dgi", "dB", "dC", "dD", "dh0"), lo, hi, f32):
        if r is None:
            assert a is None and w is None, name
            continue
        assert a.dtype == torch.float32 and w.dtype == torch.float64, name
        assert torch.equal(a, r), name
        _close(a, w.numpy(), torch.float32, f"{case} {name}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(2, 64, 4, 8, 2, 16, 16), (1, 45, 4, 16, 1, 32, 16)])
def test_mamba2_wrapper_gradients_into_dt_and_a(jax_scan, rng, dtype, b, s, h, p, g, n, chunk):
    """``ssm_scan`` (ld = dt A, gi = dt): the gradients of x, dt, A, B, C and D
    through the wrapper against ``jax.vjp`` of the reference's ``ssm_scan``."""
    jax, jops, _ = jax_scan
    jnp = jax.numpy
    x, _, gi, bm, cm, d, _, dy, dh = _inputs(rng, b, s, h, p, g, n, True, False)
    a = -np.abs(rng.normal(1, 0.3, (h,))).astype(np.float32)
    tdt = DTYPES[dtype]
    jdt = jnp.bfloat16 if tdt == torch.bfloat16 else jnp.float32
    jx, jb, jc, jdy = (jnp.asarray(v).astype(jdt) for v in (x, bm, cm, dy))
    _, vjp = jax.vjp(lambda *v: jops.ssm_scan(*v, chunk=chunk), jx, jnp.asarray(gi),
                     jnp.asarray(a), jb, jc, jnp.asarray(d))
    ref = vjp((jdy, jnp.asarray(dh)))
    leaves = [_t(x, tdt), _t(gi), _t(a), _t(bm, tdt), _t(cm, tdt), _t(d)]
    for t in leaves:
        t.requires_grad_(True)
    y, hf = ssm_scan(*leaves, chunk=chunk)
    ours = torch.autograd.grad((y.float() * _t(dy, tdt).float()).sum() + (hf * _t(dh)).sum(),
                               leaves)
    for name, o, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), ours, ref):
        _close(o, _np(r), tdt, f"ssm_scan {dtype} {name}")


@pytest.mark.parametrize("with_state", [False, True])
def test_autograd_is_the_plain_backward(rng, with_state):
    """Autograd through the op on the CPU is ``gated_scan_backward_padded``
    bit for bit; with the final state unused its cotangent stays None (no
    dh_final), and dD / dh0 exist only with D / h0."""
    x, ld, gi, bm, cm, d, h0, dy, dh = _inputs(rng, 2, 37, 4, 8, 2, 16, True, with_state)
    x, ld, gi, bm, cm, d, h0, dy, dh = (_t(a) for a in (x, ld, gi, bm, cm, d, h0, dy, dh))
    if not with_state:
        leaves = [t.requires_grad_(True) for t in (x, ld, gi, bm, cm, d)]
        y, _ = gated_scan(*leaves, chunk=16)
        got = torch.autograd.grad((y * dy).sum(), leaves)
        ref = gated_scan_backward_padded(dy, None, x.detach(), ld.detach(), gi.detach(),
                                         bm.detach(), cm.detach(), d.detach(), None, 16)
        assert ref[6] is None
    else:
        got = _port_grads(x, ld, gi, bm, cm, d, h0, dy, dh, 16)
        ref = gated_scan_backward_padded(dy, dh, *(t.detach() for t in (x, ld, gi, bm, cm, d,
                                                                           h0)), 16)
    for g_, r in zip(got, ref):
        assert g_.is_contiguous() and torch.equal(g_, r)


def test_opcheck_of_the_forward_and_backward_ops(rng):
    x, ld, gi, bm, cm, d, h0, dy, dh = (_t(a) for a in _inputs(rng, 1, 20, 4, 8, 2, 16, True,
                                                                 True))
    torch.library.opcheck(gated_scan_op, (x.requires_grad_(True), ld.requires_grad_(True), gi,
                                          bm, cm, d, h0, 8))
    torch.library.opcheck(gated_scan_op, (x, ld, gi, bm.requires_grad_(True), cm, None, None, 16))
    x, ld, bm = x.detach(), ld.detach(), bm.detach()
    torch.library.opcheck(gated_scan_backward_op, (dy, dh, x, ld, gi, bm, cm, d, h0, 8))
    torch.library.opcheck(gated_scan_backward_op, (dy, None, x, ld, gi, bm, cm, None, None, 16))


def test_served_trace_keeps_one_scan_node(rng):
    """Without grad the traced scan is one ``gated_scan`` node with its two
    outputs and no backward op."""
    from torch.fx.experimental.proxy_tensor import make_fx

    x, ld, gi, bm, cm, d, _, _, _ = (_t(a) for a in _inputs(rng, 1, 16, 4, 8, 1, 16, True,
                                                              False))
    gm = make_fx(lambda *a: gated_scan(*a, chunk=8), tracing_mode="fake")(x, ld, gi, bm, cm, d)
    targets = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"
               and "repro_torch" in str(n.target)]
    assert targets == ["repro_torch.gated_scan.default"]
    y_meta, h_meta = next(n for n in gm.graph.nodes
                          if str(n.target) == "repro_torch.gated_scan.default").meta["val"]
    assert tuple(y_meta.shape) == (1, 16, 4, 8) and tuple(h_meta.shape) == (1, 4, 16, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 512, 64, 64, 1, 64, 128),      # zamba2-1.2b, training
                                   (1, 512, 4, 1025, 4, 1024, 128),   # xlstm-1.3b's mLSTM
                                   (2, 77, 8, 33, 8, 200, 32),
                                   (1, 16, 4, 8, 2, 100, 16)])
def test_scan_backward_plan_fits_shared_memory(shape, dtype):
    """Route by N (narrow up to 128, wide beyond), the grids within the
    launch limits and covering P and N (tiles of 64 on the bf16 tensor-core
    kernels, 32 on the f32 ones), every launch's shared memory within a
    block's (dynamic up to 227 KB, static up to 48 KB); the workspace is the
    sum of its parts and holds the states and their gradients, and on the
    bf16 narrow route no S or G (nor a scores launch: dB/dC takes the
    per-step sums); bf16 x and dy are padded where P % 8 != 0."""
    b, s, h, p, g, n, chunk = shape
    plan = scan_backward_plan(b, s, h, p, g, n, chunk, dtype)
    mma = dtype == torch.bfloat16
    assert plan["route"] == ("narrow" if n <= 128 else "wide") and plan["mma"] == mma
    nc = -(-s // chunk)
    tile = 64 if mma else 32
    grids = plan["grids"]
    assert grids["state"][0] * tile >= p and grids["dx"] == (grids["state"][0], nc, h * b)
    assert grids["dbc"][0] * tile >= n and grids["finish"] == (nc, h, b)
    bf16_narrow = mma and plan["route"] == "narrow"
    assert grids.get("scores") == (None if bf16_narrow else (nc, h, b))
    rows = 64 if mma or n <= 64 or n > 128 else 128
    assert grids["state"][1] * rows >= n and grids["state"][2] == 2 * h * b
    assert grids["cumsum"][0] * 8 >= nc * h * b
    assert all(max(gr[1:], default=0) <= 65535 for gr in grids.values())
    assert set(plan["kernels"]) >= set(grids)
    assert ("scores_part" in grids) == (plan["splits"] > 1) == (plan["route"] == "wide")
    for k, v in plan["smem"].items():
        assert v <= (SMEM_MAX if k in plan["dynamic"] else STATIC_SMEM_MAX), (k, v)
    parts = plan["workspace_parts"]
    assert plan["workspace"] == sum(parts.values())
    assert parts["states"] == 2 * b * nc * h * n * (-(-p // 4) * 4 if mma else p)
    assert ("s_and_g" in parts) == (not bf16_narrow)
    assert ("padded_x_dy" in parts) == ("pad" in grids) == (mma and p % 8 != 0)
    if shape[:2] == (1, 512):
        assert plan["route"] == "wide" and grids["state"][1] == 16


def test_backward_wrapper_refuses_what_the_kernel_does_not_take(rng):
    x, ld, gi, bm, cm, d, h0, dy, dh = (_t(a) for a in _inputs(rng, 1, 20, 4, 8, 2, 16, True,
                                                                 True))
    with pytest.raises(TypeError):
        gated_scan_backward_cuda(dy.bfloat16(), None, x, ld, gi, bm, cm, d, None, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gated_scan_backward_cuda(dy, None, x.transpose(1, 2).contiguous().transpose(1, 2), ld,
                                 gi, bm, cm, d, None, 8)
    with pytest.raises(ValueError, match="dh_final"):
        gated_scan_backward_cuda(dy, dh[:, :2], x, ld, gi, bm, cm, d, h0, 8)
    with pytest.raises(ValueError, match="chunk"):
        gated_scan_backward_cuda(dy, None, x, ld, gi, bm, cm, d, None, 0)
    big = _t(rng.normal(0, 1, (1, 20, 1, 1030)).astype(np.float32))
    with pytest.raises(ValueError, match="N=1030"):
        gated_scan_backward_cuda(dy, None, x, ld, gi, big, big, d, None, 8)


# ------------------------------------------------------------ on the card

CARD_CASES = [
    # (b, s, h, p, g, n, chunk, with D, with h0, with dh_final, mlstm)
    (2, 128, 8, 64, 1, 64, 64, True, False, False, False),    # zamba2's head shape
    (2, 77, 4, 33, 2, 20, 32, True, True, True, False),       # ragged S, P, N; G < H
    (1, 200, 8, 130, 2, 128, 100, False, False, True, False),  # N = 128, rows of 128
    (1, 150, 4, 161, 4, 160, 64, False, True, True, True),    # wide, ragged last tiles
    (1, 256, 4, 1025, 4, 1024, 128, False, False, False, True),  # the mLSTM's state
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_scan_backward_kernel_matches_plain_on_card(rng, dtype, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    b, s, h, p, g, n, chunk, with_d, with_h0, with_dh, mlstm = CARD_CASES[case]
    x, ld, gi, bm, cm, d, h0, dy, dh = _inputs(rng, b, s, h, p, g, n, with_d, with_h0, mlstm)
    x, bm, cm, dy = (_t(a, dtype, "cuda") for a in (x, bm, cm, dy))
    ld, gi, d, h0 = (_t(a, torch.float32, "cuda") for a in (ld, gi, d, h0))
    dh = _t(dh, torch.float32, "cuda") if with_dh else None
    before = library.LAUNCHES["ssm_scan_backward"]
    grads = gated_scan_backward_op(dy, dh, x, ld, gi, bm, cm, d, h0, chunk)
    assert library.LAUNCHES["ssm_scan_backward"] == before + 1
    refs = gated_scan_backward_padded(dy, dh, x, ld, gi, bm, cm, d, h0, chunk)
    lo, hi = gated_scan_backward_witness(dy, dh, x, ld, gi, bm, cm, d, h0, chunk)
    for name, got, ref, f32, f64 in zip(("dx", "dld", "dgi", "dB", "dC", "dD", "dh0"), grads,
                                        refs, lo, hi):
        if ref is None:
            assert got.numel() == 0, name
            continue
        # element by element within TOL plus 4 x the distance that f32
        # rounding alone moves the plain version by (its f32 run against
        # its f64 run): terms of ~10^3 cancel to small values in these sums
        floor = 4 * float((f32.double() - f64).abs().max())
        err = (got.float() - ref.float()).abs()
        over = err > TOL[dtype] + floor + TOL[dtype] * ref.float().abs()
        assert not bool(over.any()), (CARD_CASES[case], name, float(err.max()), floor)
    again = gated_scan_backward_op(dy, dh, x, ld, gi, bm, cm, d, h0, chunk)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
