"""AdamW over a nested dict of parameters (``repro.training.optimizer``), with
the reference's arithmetic in f32: the global-norm clip over the leaves in
the reference's leaf order (sorted keys at every level), bias correction at
the f32 step, decoupled weight decay, the update cast back to the param
dtype.  The moments and the parameters are updated in place (one f32
moment pair beside a model's weights is already 8 bytes a parameter), and
the leaves are returned, so a caller reads the new values either way.
``opt_state_specs`` gives the state's ZeRO-1 layout: the moments take the
param spec plus a "dp" shard on their first divisible unsharded dim."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import zero1_spec


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def leaf_paths(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of every leaf, keys sorted at every level: the
    order of ``jax.tree.leaves`` on a dict."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaf_paths(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_map(fn, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def init_opt_state(params: Dict[str, Any]) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step_dev = leaf_paths(params)[0][1].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=step_dev),
    }


def opt_state_specs(param_specs_tree, params_shape, dp_axis_size: int = 16) -> Dict[str, Any]:
    """m/v inherit the param spec plus a ZeRO-1 dp shard; step is replicated.
    ``params_shape`` has the specs' structure, with anything that has a
    ``shape`` at its leaves (``models.registry.params_shape``' meta tensors)."""
    def one(spec, shape):
        if isinstance(spec, dict):
            return {k: one(spec[k], shape[k]) for k in spec}
        return zero1_spec(spec, tuple(shape.shape), dp_axis_size)

    mv = one(param_specs_tree, params_shape)
    return {"m": mv, "v": mv, "step": P()}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig):
    """One AdamW step.  ``grads`` has the params' structure.  Returns
    (params, opt_state, gnorm): the same leaf tensors, updated in place,
    and the f32 global norm of the grads before clipping."""
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    lr = _schedule(cfg, stepf)

    flat_g = [g for _, g in leaf_paths(grads)]
    flat_m = [m for _, m in leaf_paths(opt_state["m"])]
    flat_v = [v for _, v in leaf_paths(opt_state["v"])]
    flat_p = [p for _, p in leaf_paths(params)]

    # global-norm clip, leaf sums added in leaf order
    total = 0
    for g in flat_g:
        total = total + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(total)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        gf = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    opt_state["step"] = step
    return params, opt_state, gnorm
