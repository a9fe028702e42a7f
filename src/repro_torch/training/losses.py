"""LM losses (``repro.training.losses``).  The chunked cross-entropy never
materializes the full (B, S, V) logits: it walks the sequence in chunks of
``CHUNK_LEN`` positions, each computing the final norm, the head product,
log-softmax and the NLL, and each under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body), so the backward
recomputes one chunk's logits at a time."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rmsnorm import rmsnorm

CHUNK_LEN = 256


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, K) @ b (K, M) with f32 accumulation and an f32 result, not
    rounded to the inputs' dtype.  On the card a bf16 product runs on the
    tensor cores with cuBLAS's f32 output (``mm.dtype``, where the build has
    it); elsewhere the inputs are widened, which gives the same sums."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.device.type == "cuda" and hasattr(torch.ops.aten.mm, "dtype"):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _HeadLogits(torch.autograd.Function):
    """f32 logits of a bf16 hidden state and head: the reference's
    ``dot_general(..., preferred_element_type=f32)``.  The backward's two
    products take the f32 cotangent rounded to the inputs' dtype and
    accumulate in f32 (the reference multiplies the f32 cotangent: a
    deliberate difference, ROADMAP queue C, that keeps the vocabulary-wide
    products on the tensor cores)."""

    @staticmethod
    def forward(ctx, hn, w):
        ctx.save_for_backward(hn, w)
        return _mm_f32(hn, w)

    @staticmethod
    def backward(ctx, g):
        hn, w = ctx.saved_tensors
        g = g.to(hn.dtype)
        return torch.mm(g, w.t()), torch.mm(hn.t(), g)


def head_logits(hn: torch.Tensor, head_w: torch.Tensor) -> torch.Tensor:
    """(..., D) x (D, V) -> (..., V) f32 logits."""
    flat = hn.reshape(-1, hn.shape[-1])
    if hn.dtype == torch.float32:
        logits = torch.mm(flat, head_w)
    else:
        logits = _HeadLogits.apply(flat, head_w)
    return logits.reshape(*hn.shape[:-1], head_w.shape[-1])


def _one_chunk(hc, lc, final_norm_scale, head_w, eps: float, vocab: int):
    """(sum of the chunk's masked NLL, count of its unmasked labels)."""
    hn = rmsnorm(hc, final_norm_scale, eps=eps)
    logp = torch.log_softmax(head_logits(hn, head_w), dim=-1)
    safe = lc.clamp(0, logp.shape[-1] - 1)
    # the label's log-probability picked by a mask: its backward is
    # elementwise, where a gather's scatters (nondeterministically on CUDA)
    pick = torch.arange(logp.shape[-1], device=lc.device) == safe[..., None].long()
    nll = -torch.where(pick, logp, 0.0).sum(dim=-1)
    mask = (lc >= 0) & (lc < vocab)
    return (nll * mask).sum(), mask.sum(dtype=torch.int32)


def chunked_lm_loss(h, final_norm_scale, head_w, labels, cfg, chunk_len: int = CHUNK_LEN):
    """h: (B, S, D) final hidden; head_w: (D, Vpad); labels: (B, S) int
    (-1 or >= vocab entries are masked).  The mean NLL over the unmasked
    labels, an f32 scalar."""
    b, s, d = h.shape
    chunk_len = min(chunk_len, s)
    pad = (-s) % chunk_len
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int32, device=h.device)
    # one split, not a slice a chunk: the backward of h[:, sl] is a whole
    # (B, S, D) tensor a chunk (S^2 / chunk_len traffic), split's one cat
    for hc, lc in zip(h.split(chunk_len, 1), labels.split(chunk_len, 1)):
        # a chunk of the sequence is a strided view: the norm's kernel
        # takes contiguous rows.  A chunk that is the whole sequence is
        # copied too, so that each chunk is the same program and a step's
        # counts are affine in its length (the dry run extrapolates them)
        hc = hc.clone(memory_format=torch.contiguous_format)
        t, n = checkpoint(_one_chunk, hc, lc, final_norm_scale, head_w,
                          cfg.norm_eps, cfg.vocab, use_reentrant=False)
        total = total + t
        count = count + n
    return total / torch.clamp(count, min=1)
