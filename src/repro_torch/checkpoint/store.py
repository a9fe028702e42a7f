"""Checkpoint store: manifest-driven, atomic, async-capable
(``repro.checkpoint.store``, for a dict of tensors, flat or nested).

Layout, the reference's file for file:
    <dir>/step_000123/
        manifest.json          # step, leaf index: name -> (file, shape, dtype)
        leaf_00000.npy ...     # one file per leaf
    <dir>/LATEST               # atomically-renamed pointer file

* atomic publish: data is written into ``step_x.tmp.<writer>/`` and then
  renamed, so a crashed writer never corrupts LATEST;
* restartability: ``latest_step`` + ``restore`` recover the newest complete
  checkpoint, ignoring partial ``.tmp`` dirs;
* async: ``save_async`` copies every leaf to the host first, then writes on
  a background thread, overlapping the I/O with the next step;
* elasticity: a tree with DTensor leaves is gathered whole (every rank
  takes part: ``full_tensor`` is a collective) and rank 0 writes it;
  ``restore(shardings=)`` lays each leaf out on the current mesh, so a
  checkpoint saved from four ranks restores onto two.

Leaves are named as the reference's ``jax.tree_util.keystr`` names a dict's
leaves: ``['key']`` in a flat dict, ``['params']['blocks']['sub0']['wq']``
in a nested one; so each package reads the other's checkpoints of float
and integer leaves (a train state among them: the LM params have the
reference's layout).
numpy has no bfloat16: a bf16 leaf is stored as its raw 16 bits (uint16) and
the manifest names it ``bfloat16``; loading gives back the same bits.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import distribute, is_dtensor

BFLOAT16 = "bfloat16"

# distinguishes concurrent writers' staging dirs within one process; the pid
# distinguishes processes
_writer_ids = itertools.count()


def _leaves(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr name, leaf) of every leaf of a nested dict, in its order."""
    out = []
    for key, value in tree.items():
        name = f"{prefix}['{key}']"
        out += _leaves(value, name) if isinstance(value, dict) else [(name, value)]
    return out


def _leaf_key(name: str) -> str:
    return name[2:-2] if name.startswith("['") and name.endswith("']") else name


def _host_array(value: Any) -> Tuple[np.ndarray, str]:
    """A host snapshot of one leaf and its manifest dtype: a fresh copy,
    whatever device the leaf is on (the caller's tensor may change after
    ``save`` returns)."""
    t = torch.as_tensor(value).detach().contiguous().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BFLOAT16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_array(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BFLOAT16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Dict[str, Any], *, blocking: bool = True) -> threading.Thread:
    """Write a checkpoint of ``tree`` (a dict of tensors, flat or nested);
    returns the writer thread (joined when blocking).  With DTensor leaves
    every rank must call it: each leaf is gathered whole on every rank,
    rank 0 writes, and a blocking save returns on every rank once the
    checkpoint is published."""
    named = _leaves(tree)
    sharded = any(is_dtensor(v) for _, v in named)
    if sharded:
        named = [(name, v.full_tensor() if is_dtensor(v) else v) for name, v in named]
        if dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            t = threading.Thread(target=lambda: None, daemon=True)
            t.start()
            return t
    os.makedirs(ckpt_dir, exist_ok=True)
    # snapshot to host memory synchronously, before the writer starts
    leaves = [(name, *_host_array(v)) for name, v in named]
    # unique per writer: two non-blocking saves of the same step must never
    # share a staging dir
    token = f"{os.getpid()}.{next(_writer_ids)}"

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = f"{final}.tmp.{token}"
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for i, (name, arr, dtype) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][name] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            # a concurrent same-step writer may be removing the stale dir at
            # the same time; losing that race is harmless
            shutil.rmtree(final, ignore_errors=True)
        try:
            os.rename(tmp, final)                  # atomic publish
        except OSError:
            # a concurrent writer published this step first; both staging
            # dirs hold the same step, so keep theirs
            shutil.rmtree(tmp, ignore_errors=True)
        latest_tmp = os.path.join(ckpt_dir, f"LATEST.tmp.{token}")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if blocking:
        t.join()
        if sharded:
            dist.barrier()
    return t


def save_async(ckpt_dir: str, step: int, tree: Dict[str, Any]) -> threading.Thread:
    return save(ckpt_dir, step, tree, blocking=False)


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        step = int(f.read().strip())
    if os.path.isdir(os.path.join(ckpt_dir, f"step_{step:08d}")):
        return step
    # LATEST points at an incomplete dir (crash window): fall back to a scan
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and ".tmp" not in d
    )
    return steps[-1] if steps else None


def _manifest(ckpt_dir: str, step: int) -> tuple:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return d, json.load(f)


def load_flat(ckpt_dir: str, step: int) -> Dict[str, torch.Tensor]:
    """Load a checkpoint without a template, as CPU tensors keyed by the
    saved dict's keys: the session-recovery path, where the reader (a
    surviving replica) has no template of the crashed session's state."""
    d, manifest = _manifest(ckpt_dir, step)
    return {
        _leaf_key(name): _from_array(np.load(os.path.join(d, meta["file"])), meta["dtype"])
        for name, meta in manifest["leaves"].items()
    }


def restore(ckpt_dir: str, step: int, template: Dict[str, Any], *,
            device: Any = None, shardings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore into the structure of ``template`` (flat or nested): each
    leaf it names, checked against the template leaf's shape and given its
    dtype, on ``device`` (the template leaf's device when None).
    ``shardings`` (the template's structure, ``NamedSharding`` leaves on a
    live mesh) lays every leaf out on that mesh as a DTensor, on the mesh's
    device, in the checkpoint's own dtype (as the reference's
    ``jax.device_put`` keeps it): the elastic-rescale path."""
    d, manifest = _manifest(ckpt_dir, step)

    def load(name: str, leaf, sharding) -> torch.Tensor:
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        t = _from_array(np.load(os.path.join(d, meta["file"])), meta["dtype"])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: ckpt {tuple(t.shape)} vs "
                             f"target {tuple(leaf.shape)}")
        if sharding is not None:
            mesh = sharding.mesh
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if mesh.device_type == "cuda" else torch.device("cpu"))
            return distribute(t.to(dev), sharding)
        return t.to(device=leaf.device if device is None else device, dtype=leaf.dtype)

    def walk(node: Dict[str, Any], shard: Optional[Dict[str, Any]], prefix: str) -> Dict[str, Any]:
        out = {}
        for key, leaf in node.items():
            name = f"{prefix}['{key}']"
            sub = None if shard is None else shard[key]
            out[key] = (walk(leaf, sub, name) if isinstance(leaf, dict)
                        else load(name, leaf, sub))
        return out

    return walk(template, shardings, "")
