"""Plain PyTorch versions of the chunked gated linear recurrence (SSD form),
a copy of ``repro.kernels.ssm_scan.ref``.

The recurrence per head (state h in R^{N x P}):
    h_t = exp(ld_t) * h_{t-1} + gi_t * B_t x_t^T
    y_t = C_t @ h_t + D * x_t

with ld_t <= 0 the log-decay and gi_t >= 0 the input scale.  Mamba2 takes
ld = dt * A, gi = dt; mLSTM takes ld = log sigmoid(f), gi = exp(i), B = k,
C = q, x = v.

Chunked evaluation: within a chunk of length Q the outputs are an
intra-chunk causal part (a (Q,Q) decay-masked score matrix) plus the carried
state's contribution; chunk states combine through an inter-chunk scan.

Shapes: x (B,S,H,P), ld/gi (B,S,H), Bm/Cm (B,S,G,N) with G | H, D (H,)|None.
Returns y (B,S,H,P) in x's dtype and the final state (B,H,N,P) in f32.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _expand_groups(m: torch.Tensor, rep: int) -> torch.Tensor:
    """(B,NC,Q,G,N) -> (B,NC,Q,G*rep,N), group g serving heads g*rep.."""
    if rep == 1:
        return m
    b, nc, q, g, n = m.shape
    return m[:, :, :, :, None, :].expand(b, nc, q, g, rep, n).reshape(b, nc, q, g * rep, n)


def gated_scan_ref(
    x: torch.Tensor,
    log_decay: torch.Tensor,
    in_scale: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """S must be a multiple of ``min(chunk, S)`` (``ops.gated_scan`` pads)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    rep = h // g
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32

    xf = x.to(f32).reshape(b, nc, chunk, h, p)
    ldf = log_decay.to(f32).reshape(b, nc, chunk, h)
    gif = in_scale.to(f32).reshape(b, nc, chunk, h)
    Bf = _expand_groups(Bm.to(f32).reshape(b, nc, chunk, g, n), rep)
    Cf = _expand_groups(Cm.to(f32).reshape(b, nc, chunk, g, n), rep)

    cs = torch.cumsum(ldf, dim=2)                           # inclusive
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (B,NC,Q,Q,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # exp only where j <= i: above the diagonal the difference is positive
    # and may overflow before the mask would zero it
    decay = torch.exp(diff.masked_fill(~causal[None, None, :, :, None], float("-inf")))

    scores = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf) * decay
    scores = scores * gif[:, :, None, :, :]                 # gi_j on the j axis
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)

    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)         # (B,NC,Q,H)
    chunk_states = torch.einsum(
        "bcjhn,bcjhp->bchnp", Bf * (decay_to_end * gif)[..., None], xf
    )                                                       # (B,NC,H,N,P)
    chunk_decay = torch.exp(cs[:, :, -1, :])                # (B,NC,H)

    h_prev = (
        h0.to(f32) if h0 is not None
        else torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    )
    h_prevs = []                                            # state entering each chunk
    for c in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    h_in = torch.stack(h_prevs, dim=1)                      # (B,NC,H,N,P)

    y_off = torch.einsum("bcihn,bchnp->bcihp", Cf * torch.exp(cs)[..., None], h_in)
    y = y_diag + y_off
    if D is not None:
        y = y + xf * D.to(f32)[None, None, None, :, None]
    return y.reshape(b, s, h, p).to(x.dtype), h_prev


def gated_scan_backward_ref(
    dy: torch.Tensor,
    dh_final: Optional[torch.Tensor],
    x: torch.Tensor,
    log_decay: torch.Tensor,
    in_scale: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    h0: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    acc: torch.dtype = torch.float32,
    terms: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`gated_scan_ref`, written out in f32 over its
    chunked intermediates (a custom op's body runs below autograd, so the
    plain backward cannot be autograd of the plain forward; ``acc``
    float64 computes the same in f64, a witness of f32's rounding;
    ``terms``, applied to each f32 operand of a product where the bf16
    kernel rounds it, gives :func:`gated_scan_backward_mma_ref`).  ``dy``
    is the cotangent of y, ``dh_final`` that of the final state (None:
    unused).
    Returns (dx, dlog_decay, din_scale, dB, dC, dD, dh0), each in its
    input's dtype; dD and dh0 are None without D and h0.  With e_i =
    exp(cs_i), w_j = exp(cs_last - cs_j) gi_j, L = the decay mask with gi on
    its columns, H the state entering a chunk and dH the gradient of the
    state leaving it:

        dS = dy x^T, G = dS o L,    dx = S^T dy + diag(w) B dH + D dy
        dB = G^T C + diag(w) x dH^T, dC = G B + diag(e) dy H^T
        dH_in = exp(cs_last) dH + C^T diag(e) dy       (reverse over chunks)

    and dlog_decay is the reverse cumulative sum, inside each chunk, of the
    gradient of cs (whose last step also takes the chunk decay's and the
    chunk state's terms), taken in a form whose terms do not cancel: at a
    step the whole chunk's row and column sums of dS o S would, leaving
    f32 noise of their size where the gradient is 0.  S must be a multiple
    of ``min(chunk, S)``."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    if h % g or s % chunk:
        raise ValueError(f"heads {h} / groups {g}, seq {s} / chunk {chunk}")
    nc = s // chunk
    if terms is None:
        def terms(t):
            return t

    xf = x.to(acc).reshape(b, nc, chunk, h, p)
    dyf = dy.to(acc).reshape(b, nc, chunk, h, p)
    gif = in_scale.to(acc).reshape(b, nc, chunk, h)
    Bf = _expand_groups(Bm.to(acc).reshape(b, nc, chunk, g, n), rep)
    Cf = _expand_groups(Cm.to(acc).reshape(b, nc, chunk, g, n), rep)

    cs = torch.cumsum(log_decay.to(acc).reshape(b, nc, chunk, h), dim=2)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (B,NC,Qi,Qj,H)
    decay = torch.exp(diff.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    weights = decay * gif[:, :, None, :, :]                 # L
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    scores = cb * weights                                   # S
    ds = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)        # dS
    gmat = ds * weights                                     # G
    e = torch.exp(cs)                                       # (B,NC,Q,H)
    el = torch.exp(cs[:, :, -1:, :] - cs)
    w = el * gif
    chunk_decay = torch.exp(cs[:, :, -1, :])                # (B,NC,H)

    chunk_states = torch.einsum("bcjhn,bcjhp->bchnp", terms(Bf * w[..., None]), xf)
    h_prev = h0.to(acc) if h0 is not None else torch.zeros((b, h, n, p), dtype=acc,
                                                           device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    hin = torch.stack(h_in, dim=1)                          # (B,NC,H,N,P)

    dh = dh_final.to(acc) if dh_final is not None else torch.zeros((b, h, n, p), dtype=acc,
                                                                   device=x.device)
    into = torch.einsum("bcihn,bcihp->bchnp", terms(Cf * e[..., None]), dyf)
    dh_out = [None] * nc
    for c in reversed(range(nc)):
        dh_out[c] = dh
        dh = dh * chunk_decay[:, c, :, None, None] + into[:, c]
    dhout = torch.stack(dh_out, dim=1)                      # (B,NC,H,N,P)

    dx = (torch.einsum("bcijh,bcihp->bcjhp", terms(scores), dyf)
          + w[..., None] * torch.einsum("bcjhn,bchnp->bcjhp", Bf, terms(dhout)))
    if D is not None:
        dx = dx + dyf * D.to(acc)[None, None, None, :, None]
    v = torch.einsum("bchnp,bcjhp->bcjhn", terms(dhout), xf)       # dH x_j
    wy = torch.einsum("bchnp,bcihp->bcihn", terms(hin), dyf)       # H dy_i
    dbh = torch.einsum("bcijh,bcihn->bcjhn", terms(gmat), Cf) + w[..., None] * v
    dch = torch.einsum("bcijh,bcjhn->bcihn", terms(gmat), Bf) + e[..., None] * wy

    # dlog_decay_t = sum_{k >= t} dcs_k, summed in a form without the
    # cancelling whole-chunk terms: the (dS o S) pairs that straddle t (i >=
    # t > j), the y_off terms from t on, the chunk-state terms before t,
    # and the chunk decay's term
    m = ds * scores
    u = (Bf * v).sum(-1)                                    # B_j . dH x_j
    t = w * u
    col_suffix = torch.flip(torch.cumsum(torch.flip(m, [2]), dim=2), [2])
    before = torch.tril(torch.ones((chunk, chunk), dtype=acc, device=x.device), diagonal=-1)
    straddle = (col_suffix * before[None, None, :, :, None]).sum(3)
    y_off = (Cf * e[..., None] * wy).sum(-1)
    t_before = torch.cat([torch.zeros_like(t[:, :, :1]), torch.cumsum(t, dim=2)[:, :, :-1]], 2)
    dld = (straddle + torch.flip(torch.cumsum(torch.flip(y_off, [2]), dim=2), [2]) + t_before
           + (chunk_decay * (hin * dhout).sum((-1, -2)))[:, :, None, :])
    dgi = (ds * cb * decay).sum(2) + el * u

    def group_sum(t):
        return t.reshape(b, nc, chunk, g, rep, n).sum(4).reshape(b, s, g, n)

    return (
        dx.reshape(b, s, h, p).to(x.dtype),
        dld.reshape(b, s, h).to(log_decay.dtype),
        dgi.reshape(b, s, h).to(in_scale.dtype),
        group_sum(dbh).to(Bm.dtype),
        group_sum(dch).to(Cm.dtype),
        None if D is None else (xf * dyf).sum((0, 1, 2, 4)).to(D.dtype),
        None if h0 is None else dh.to(h0.dtype),
    )


def bf16_terms(t: torch.Tensor) -> torch.Tensor:
    """An f32 tensor as the bf16 route's two bf16 terms carry it: hi + lo,
    with hi = bf16(t) and lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16).to(torch.float32)
    return hi + (t - hi).to(torch.bfloat16).to(torch.float32)


def gated_scan_mma_ref(
    x: torch.Tensor,
    log_decay: torch.Tensor,
    in_scale: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gated_scan_ref`` with the bf16 tensor-core route's roundings: the
    three f32 intermediates that enter a bf16 product (the decay-masked
    scores S before S.X, B*w before the state update, the entering state h
    before C.h) pass through ``bf16_terms``, as the kernel carries them in
    two bf16 terms and runs each product on both.  Every product accumulates
    in f32 and the state is carried in f32.  The kernel's mirror up to the
    order of its f32 sums and its fast exponent.  S must be a multiple of
    ``min(chunk, S)``."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    if h % g or s % chunk:
        raise ValueError(f"heads {h} / groups {g}, seq {s} / chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32

    xf = x.to(f32).reshape(b, nc, chunk, h, p)
    cs = torch.cumsum(log_decay.to(f32).reshape(b, nc, chunk, h), dim=2)
    gif = in_scale.to(f32).reshape(b, nc, chunk, h)
    Bf = _expand_groups(Bm.to(f32).reshape(b, nc, chunk, g, n), rep)
    Cf = _expand_groups(Cm.to(f32).reshape(b, nc, chunk, g, n), rep)

    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    decay = torch.exp(diff.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf) * decay * gif[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", bf16_terms(scores), xf)
    bw = bf16_terms(Bf * (torch.exp(cs[:, :, -1:, :] - cs) * gif)[..., None])
    chunk_states = torch.einsum("bcjhn,bcjhp->bchnp", bw, xf)
    chunk_decay = torch.exp(cs[:, :, -1, :])

    h_prev = (
        h0.to(f32) if h0 is not None
        else torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    )
    ys = []
    for c in range(nc):
        y_off = torch.exp(cs[:, c])[..., None] * torch.einsum(
            "bihn,bhnp->bihp", Cf[:, c], bf16_terms(h_prev))
        ys.append(y_off + y_diag[:, c])
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + xf * D.to(f32)[None, None, None, :, None]
    return y.reshape(b, s, h, p).to(x.dtype), h_prev


def gated_scan_backward_mma_ref(
    dy: torch.Tensor,
    dh_final: Optional[torch.Tensor],
    x: torch.Tensor,
    log_decay: torch.Tensor,
    in_scale: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    h0: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, ...]:
    """``gated_scan_backward_ref`` with the bf16 tensor-core kernel's
    roundings: every f32 intermediate that enters a bf16 product passes
    through ``bf16_terms``, as the kernel carries it in two bf16 terms and
    runs each product on both: diag(w) B and diag(e) C in the state pass, S
    before S^T dy, G before G^T C and G B, dH before B dH and x dH^T, and H
    before dy H^T.  C B^T and dy x^T are products of the bf16 inputs; every
    product accumulates in f32 and the states are carried in f32.  The
    kernel's mirror up to the order of its f32 sums.  S must be a multiple
    of ``min(chunk, S)``."""
    return gated_scan_backward_ref(dy, dh_final, x, log_decay, in_scale, Bm, Cm, D, h0,
                                   chunk=chunk, terms=bf16_terms)


def ssm_scan_ref(x, dt, A, Bm, Cm, D, *, chunk: int = 128, h0=None):
    """Mamba2 wrapper: log-decay = dt*A, input scale = dt."""
    ld = dt.to(torch.float32) * A.to(torch.float32)[None, None, :]
    return gated_scan_ref(x, ld, dt, Bm, Cm, D, chunk=chunk, h0=h0)


def gated_step_ref(
    x: torch.Tensor,           # (B, H, P)
    log_decay: torch.Tensor,   # (B, H)
    in_scale: torch.Tensor,    # (B, H)
    Bm: torch.Tensor,          # (B, G, N)
    Cm: torch.Tensor,          # (B, G, N)
    D: Optional[torch.Tensor],
    h: torch.Tensor,           # (B, H, N, P) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the recurrence (plain torch here as in the
    reference: one token is an outer product and a matrix-vector product)."""
    nh = x.shape[1]
    rep = nh // Bm.shape[1]
    f32 = torch.float32
    Bf = Bm.to(f32).repeat_interleave(rep, dim=1)
    Cf = Cm.to(f32).repeat_interleave(rep, dim=1)
    dec = torch.exp(log_decay.to(f32))
    h_new = h * dec[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bf * in_scale.to(f32)[..., None], x.to(f32)
    )
    y = torch.einsum("bhn,bhnp->bhp", Cf, h_new)
    if D is not None:
        y = y + x.to(f32) * D.to(f32)[None, :, None]
    return y.to(x.dtype), h_new


def ssm_step_ref(x, dt, A, Bm, Cm, D, h):
    """Mamba2 decode-step wrapper."""
    ld = dt.to(torch.float32) * A.to(torch.float32)[None, :]
    return gated_step_ref(x, ld, dt, Bm, Cm, D, h)
