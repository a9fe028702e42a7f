"""The train step (``repro.training.step``): the loss of the final hidden
state through the chunked cross-entropy, its gradient over every parameter
leaf, and AdamW.  The forward runs each layer under ``remat``; on the card
the step runs with PyTorch's deterministic algorithms, so a step's result
is a function of its inputs alone and a resumed run repeats the straight
one (the embedding's gather has a nondeterministic backward otherwise)."""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import get_model
from repro_torch.training.losses import chunked_lm_loss
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    leaf_paths,
    tree_map,
)


def make_loss_fn(cfg: ArchConfig, *, remat: bool = True):
    model = get_model(cfg)

    def loss_fn(params, batch):
        h = model.forward(params, batch, cfg, remat=remat, return_hidden=True)
        head = model.head_weights(params, cfg)
        return chunked_lm_loss(h, params["final_norm"], head, batch["labels"], cfg)

    return loss_fn


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``synth_batch``'s) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) if not isinstance(v, torch.Tensor)
            else v.to(device) for k, v in batch.items()}


@contextlib.contextmanager
def deterministic(device: torch.device):
    """PyTorch's deterministic algorithms for the step on a CUDA device
    (cuBLAS's fixed workspace, which PyTorch asks for then, is set when the
    caller has not set one); nothing changes on the CPU.  Uninitialized
    outputs are not filled: every kernel writes all of its outputs."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    import torch.utils.deterministic as det

    was_fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det.fill_uninitialized_memory = was_fill
        torch.use_deterministic_algorithms(was, warn_only=was_warn)


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    *,
    remat: bool = True,
):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    the gradient of the loss over every parameter leaf (the tied embedding
    takes both its gather's and the head's), then AdamW in place.  metrics:
    ``loss``, ``grad_norm`` and ``step``, as tensors on the params' device."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = make_loss_fn(cfg, remat=remat)
    idle = getattr(get_model(cfg), "idle_params", lambda cfg: ())(cfg)

    def train_step(params, opt_state, batch):
        device = leaf_paths(params)[0][1].device
        batch = batch_to_device(batch, device)
        with deterministic(device):
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss = loss_fn(live, batch)
            paths = leaf_paths(live)
            grads = torch.autograd.grad(loss, [p for _, p in paths], allow_unused=True)
            # an empty leaf, or one of a block the config never runs (the
            # shared block of a hybrid with no full group), takes a zero
            # gradient, as under jax.grad; any other leaf must be reached
            for (path, p), g in zip(paths, grads):
                if g is None and p.numel() and path[0] not in idle:
                    raise RuntimeError(f"{cfg.name}: the loss does not reach the parameter "
                                       f"{'/'.join(path)}")
            by_leaf = {id(p): torch.zeros_like(p) if g is None else g
                       for (_, p), g in zip(paths, grads)}
        grads = tree_map(lambda p: by_leaf[id(p)], live)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "step": opt_state["step"]}
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ArchConfig, seed: int = 0, device: Any = "cuda"):
    params = get_model(cfg).init_params(cfg, seed, device)
    return params, init_opt_state(params)
