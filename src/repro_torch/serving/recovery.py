"""Crash-recoverable carried state: periodic checkpoints and bounded replay
(``repro.serving.recovery``).

A migration reads the source replica's memory directly, which is no help
after a *crash*: the server-resident state is gone the instant the box dies.
This module closes that hole with the primary/backup recipe:

* every ``every``-th stateful step, the session's carried state (and its
  device-memory namespace: parameters and staged buffers, without which a
  rebuilt binding cannot run) is published to a shared checkpoint tier
  through :mod:`repro_torch.checkpoint.store`'s atomic-rename store, so a
  crashed writer never corrupts the last good checkpoint;
* the client keeps a short :class:`~repro_torch.core.engine.StepLogEntry`
  log of its recent steps' wire inputs (it sent them once already);
* on a crash, a surviving replica restores the newest checkpoint and the
  client re-drives the logged steps that post-date it through the restored
  binding.  Replay is deterministic (the same program, inputs and carried
  state), so the recovered session is token for token the stream a
  crash-free run would have produced.

The cadence is the knob: ``every=1`` logs synchronously (no replay, the most
write traffic); a large ``every`` writes less but replays more.  The fleet
counters (``checkpoints``, ``checkpoint_bytes``, ``steps_replayed``) show both.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.core.engine import OffloadServer, RRTOClient


@dataclasses.dataclass
class CarriedCheckpoint:
    """One restored checkpoint, host tensors: everything a peer needs to
    rebuild the session's server half."""

    seq: int                            # steps 0..seq-1 are in the state
    carried: List[torch.Tensor]         # carried tensors, program pair order
    env: Dict[int, torch.Tensor]        # device-memory namespace (addr -> tensor)

    @property
    def nbytes(self) -> float:
        return float(sum(t.numel() * t.element_size()
                         for t in [*self.carried, *self.env.values()]))


class SessionCheckpointer:
    """Periodic carried-state checkpoints for stateful fleet sessions.

    One per fleet; each client's checkpoints land in
    ``<root>/<client_id>/step_<seq>/`` through the atomic store, so the
    newest *complete* checkpoint is always recoverable."""

    def __init__(self, root: str, *, every: int = 4):
        if every < 1:
            raise ValueError(f"checkpoint cadence must be >= 1, got {every}")
        self.root = root
        self.every = every
        self._last_saved: Dict[str, int] = {}

    def _dir(self, client_id: str) -> str:
        return os.path.join(self.root, client_id)

    def attach(self, client: RRTOClient) -> None:
        """Arm a client's step log.  The window is ``2 * every + 1``: the
        steps since the last publish plus a full cadence of slack for a
        checkpoint that was due but raced the crash."""
        if client.step_log is None:
            client.step_log = collections.deque(maxlen=2 * self.every + 1)

    def maybe_checkpoint(self, client_id: str, server: OffloadServer, client: RRTOClient) -> float:
        """Publish a checkpoint if the cadence says one is due; returns the
        bytes written (0.0 when none is due or there is nothing to save)."""
        seq = client.step_seq
        if seq - self._last_saved.get(client_id, 0) < self.every:
            return 0.0
        carried = server.export_carried_state(client_id)
        if carried is None:
            return 0.0
        flat: Dict[str, torch.Tensor] = {"meta_seq": torch.tensor(seq, dtype=torch.int64)}
        for i, t in enumerate(carried):
            flat[f"carried_{i:03d}"] = t
        ctx = server.contexts.get(client_id)
        if ctx is not None:
            for addr, val in ctx.env.items():
                flat[f"env_{addr}"] = val
        store.save(self._dir(client_id), seq, flat)
        self._last_saved[client_id] = seq
        return float(sum(t.numel() * t.element_size() for t in flat.values()))

    def load_latest(self, client_id: str) -> Optional[CarriedCheckpoint]:
        """The newest complete checkpoint (host tensors), or None if this
        client never reached a checkpoint boundary."""
        d = self._dir(client_id)
        if not os.path.isdir(d):
            return None
        step = store.latest_step(d)
        if step is None:
            return None
        flat = store.load_flat(d, step)
        seq = int(flat.pop("meta_seq"))
        carried = [flat[k] for k in sorted(k for k in flat if k.startswith("carried_"))]
        env = {int(k[len("env_"):]): v for k, v in flat.items() if k.startswith("env_")}
        return CarriedCheckpoint(seq=seq, carried=carried, env=env)
