"""Shared layer utilities: initializers and dense application."""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Union

import torch
from torch._subclasses.fake_tensor import is_fake


def dense_init(
    gen: torch.Generator,
    in_dim: int,
    out_dims: Union[int, Sequence[int]],
    dtype: torch.dtype,
    *,
    layers: int = 0,
) -> torch.Tensor:
    """Truncated-normal fan-in init of shape ([layers,] in_dim, *out_dims):
    N(0, 1) cut at ±2, times in_dim**-0.5 (the reference's rule; the draws
    differ, since torch and jax generators differ)."""
    if isinstance(out_dims, int):
        out_dims = (out_dims,)
    shape = (*((layers,) if layers else ()), in_dim, *out_dims)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if not is_fake(w):  # a shape-only init (models/registry.py) draws nothing
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * in_dim ** -0.5).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w (in, *out) -> (..., *out) in x's dtype.  The product
    accumulates in f32 (bf16 matmuls accumulate in f32 on both the CPU and
    the card) and rounds once to x's dtype, as the reference's
    ``preferred_element_type=f32`` product followed by a cast does."""
    out_shape = x.shape[:-1] + w.shape[1:]
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    return y.reshape(out_shape)


def layer_slice(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter (or cache) tree: views, no copies."""
    return {
        k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()
    }


def stack_layers(caches: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-layer cache dicts -> one dict of (L, ...) leaves, in the first
    dict's key order (the order the served app flattens them in)."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def layer_params(stacked: Dict[str, Any]) -> Callable[[int], Dict[str, Any]]:
    """Layer i of a stacked parameter tree.  Select views, as the served
    paths trace them; when a leaf requires grad (training), one ``unbind``
    per leaf instead, so the leaf's gradient is one stack of the layers' and
    not a zero-filled copy of the whole stack per layer."""
    def leaves(t):
        return [x for v in t.values() for x in (leaves(v) if isinstance(v, dict) else [v])]

    if not any(t.requires_grad for t in leaves(stacked)):
        return lambda i: layer_slice(stacked, i)

    def unbind(t):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in t.items()}

    def pick(t, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i] for k, v in t.items()}

    per_layer = unbind(stacked)
    return lambda i: pick(per_layer, i)
