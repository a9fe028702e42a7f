"""Serving engine: prefill + decode, plus RRTO record/replay serving at the
edge (``repro.serving.engine``).

* ``LocalServing`` — the plain engine: prefill (flash attention) then a
  KV-cached greedy decode loop.

* ``RRTOServedLM`` — the paper's scenario mapped to LLM generation: a mobile
  client drives the KV-cached ``decode_step(token, pos, cache)`` app through
  the transparent offloading stack.  Every call executes the identical
  operator sequence, the Operator Sequence Search locks it after a few
  recorded calls, and the loop-carried state (the KV cache; a hybrid's
  conv and SSM states too; MLA's latent cache; an xLSTM's recurrent state)
  is detected across repeats and kept on the server: each replayed token costs the model's O(1) step compute plus 3
  RPCs (token and position up, next token down).  ``stateful=False`` is the
  seed formulation: the app is ``next_token(padded_tokens, cur_len)``, a
  full forward over a fixed bucket per token (the prefix-recompute
  baseline), with nothing carried.  With ``edge=`` the client is one tenant
  of a shared :class:`~repro_torch.serving.multitenant.RRTOEdgeServer`.

* ``MultiClientServedLM`` — N clients generating with the same LM over one
  edge server: one IOS fingerprint, one replay program, same-round replays
  batched into one ``vmap`` call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.offload import OffloadableModel, OffloadSession
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serving.multitenant import RRTOEdgeServer


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, steps)
    steps: int


def _greedy(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, 1, Vp) logits -> (B,) int32 argmax over the real vocabulary."""
    return torch.argmax(logits[:, 0, : cfg.vocab], dim=-1).to(torch.int32)


class LocalServing:
    """Greedy batched generation against the family model API."""

    def __init__(self, cfg: ArchConfig, params=None, seed: int = 0, device: Any = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = get_model(cfg)
        self.params = (
            params if params is not None
            else self.model.init_params(cfg, seed, self.device)
        )

    @torch.no_grad()
    def generate(
        self,
        batch: Dict[str, Any],
        max_new_tokens: int,
        max_seq: Optional[int] = None,
    ) -> GenerationResult:
        """Prefill the whole batch (an encoder-decoder's ``frames``, a VLM's
        ``patches`` beside the tokens), then decode greedily.  A VLM's patch
        prefix counts in the default ``max_seq`` and in every decode
        position: the first generated token sits at ``s + num_patches``
        (the reference decodes at ``s`` and overwrites a prefilled row,
        ROADMAP queue C)."""
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in batch.items()}
        b, s = batch["tokens"].shape
        s += self.cfg.num_patches
        max_seq = max_seq or (s + max_new_tokens)
        logits, cache = self.model.prefill(self.params, batch, self.cfg, max_seq)
        nxt = _greedy(logits, self.cfg)[:, None]
        out: List[np.ndarray] = []
        for i in range(max_new_tokens):
            out.append(nxt.cpu().numpy())
            pos = torch.tensor(s + i, dtype=torch.int32, device=self.device)
            logits, cache = self.model.decode_step(self.params, nxt, cache, pos, self.cfg)
            nxt = _greedy(logits, self.cfg)[:, None]
        return GenerationResult(tokens=np.concatenate(out, axis=1), steps=max_new_tokens)


class RRTOServedLM:
    """LLM generation through the RRTO transparent-offloading stack.  With
    ``stateful`` (the default) the cached decode step is the offloaded app;
    once the IOS locks, the engine detects the cache as loop-carried and
    each token replays as an O(1) step with the cache server-resident.
    Without it the app recomputes the whole bucket per token
    (``next_token``) and every replayed token uploads the bucket.  With
    ``edge`` the session is client ``client_id`` of that edge server (the
    rrto system only), on the edge server's device.  ``partition`` (a
    :class:`~repro_torch.partition.PartitionConfig`) splits the replayed
    step between the device and the server; the carried state stays in the
    server suffix.

    The app sends tokens alone, as the reference's does: a stateful
    encoder-decoder decodes from the zero cross cache of ``init_cache`` (no
    frames reach it), a stateful VLM decodes its text with no patch prefix,
    and a stateless app of either, whose forward needs the frames or the
    patches, raises ``ValueError`` before any trace (the reference raises
    ``KeyError`` inside its trace)."""

    def __init__(
        self,
        cfg: ArchConfig,
        *,
        system: str = "rrto",
        environment: str = "indoor",
        bucket_len: int = 64,
        batch: int = 1,
        seed: int = 0,
        min_repeats: int = 3,
        stateful: bool = True,
        params=None,
        device: Any = "cuda",
        edge: Optional[RRTOEdgeServer] = None,
        client_id: Optional[str] = None,
        partition: Optional[Any] = None,
    ):
        if not stateful and (cfg.is_encoder_decoder or cfg.num_patches):
            missing = "frames" if cfg.is_encoder_decoder else "patches"
            raise ValueError(f"{cfg.name}: the stateless app's forward needs {missing!r}, "
                             f"which the served app does not send")
        self.cfg = cfg
        self.bucket_len = bucket_len
        self.stateful = stateful
        dev = edge.server.device if edge is not None else resolve_device(device)
        model = get_model(cfg)
        # a stateful generation overflows the bucket only where the cache
        # holds a row per position (not an xLSTM's recurrent state)
        self._bounded = not stateful or model.CACHE_PER_POSITION
        params = params if params is not None else model.init_params(cfg, seed, dev)
        if stateful:
            cache0 = model.init_cache(cfg, batch, bucket_len, "cpu")
            self._cache_leaves, treedef = torch.utils._pytree.tree_flatten(cache0)

            def decode_step(p, token, pos, *cache_leaves):
                cache = torch.utils._pytree.tree_unflatten(list(cache_leaves), treedef)
                logits, new_cache = model.decode_step(p, token, cache, pos, cfg)
                return [_greedy(logits, cfg), *torch.utils._pytree.tree_leaves(new_cache)]

            offloadable = OffloadableModel(
                name=f"{cfg.name}-decodestep",
                apply=decode_step,
                params=params,
                example_inputs=(
                    torch.zeros((batch, 1), dtype=torch.int32),
                    torch.zeros((), dtype=torch.int32),
                    *self._cache_leaves,
                ),
            )
        else:
            self._cache_leaves = []

            def next_token(p, padded_tokens, cur_len):
                """Greedy token after the first ``cur_len`` positions.  The
                length stays a tensor: the last position is picked with a
                tensor index, so one trace serves every length."""
                logits = model.forward(p, {"tokens": padded_tokens}, cfg)
                idx = torch.clamp(cur_len.reshape(1) - 1, 0, padded_tokens.shape[1] - 1)
                last = logits.index_select(1, idx.long())
                return [_greedy(last, cfg)]

            offloadable = OffloadableModel(
                name=f"{cfg.name}-nexttoken",
                apply=next_token,
                params=params,
                example_inputs=(
                    torch.zeros((batch, bucket_len), dtype=torch.int32),
                    torch.zeros((), dtype=torch.int32),
                ),
            )
        if edge is not None:
            if system != "rrto":
                raise ValueError("multi-tenant mode serves the rrto system only")
            self.session = edge.connect(
                offloadable, client_id=client_id, min_repeats=min_repeats, partition=partition
            )
        else:
            self.session = OffloadSession(
                offloadable, system, environment=environment, min_repeats=min_repeats,
                device=dev, partition=partition,
            )

    # -- generation ---------------------------------------------------------
    def start_generation(self, prompt: np.ndarray, max_new_tokens: int) -> Dict[str, Any]:
        """Per-generation state of the stateful app; returns the cursor.

        The prompt is fed token by token through the offloaded decode step
        (prefill-via-decode: the cache warms up through the IOS every later
        token replays), then each sampled token is fed back.  The cache
        tensors the app threads are opaque handles once replay turns
        stateful — the server advances the real state."""
        b, s = prompt.shape
        if self._bounded:
            self._check_bucket(s, max_new_tokens)
        prompt = torch.as_tensor(np.asarray(prompt, dtype=np.int32))
        return dict(
            prompt=prompt, s=s, state=list(self._cache_leaves),
            tok=prompt[:, 0:1].clone(), pos=0, out=[], max_new=max_new_tokens,
        )

    def step_inputs(self, g: Dict[str, Any]) -> tuple:
        """The session inputs of the next decode call."""
        return (g["tok"], torch.tensor(g["pos"], dtype=torch.int32), *g["state"])

    def absorb_step(self, g: Dict[str, Any], outputs: List[torch.Tensor]) -> None:
        """Take one decode call's outputs and advance the cursor."""
        nxt, g["state"] = outputs[0], list(outputs[1:])
        pos = g["pos"]
        if pos + 1 < g["s"]:
            g["tok"] = g["prompt"][:, pos + 1 : pos + 2].clone()
        else:
            g["out"].append(nxt[:, None].numpy())
            g["tok"] = nxt[:, None].clone()
        g["pos"] = pos + 1

    def steps_total(self, g: Dict[str, Any]) -> int:
        return g["s"] + g["max_new"] - 1

    def _check_bucket(self, s: int, max_new_tokens: int) -> None:
        if s + max_new_tokens > self.bucket_len:
            raise ValueError(
                f"prompt {s} + {max_new_tokens} new tokens overflow the "
                f"bucket of {self.bucket_len}"
            )

    def generate(self, prompt: np.ndarray, max_new_tokens: int) -> GenerationResult:
        """Greedy generation; every call goes through the offloading stack.
        Stateful: see :meth:`start_generation`.  Stateless: each call sends
        the whole bucket (prompt and tokens so far, zero-padded) and its
        length."""
        if not self.stateful:
            return self._generate_stateless(prompt, max_new_tokens)
        g = self.start_generation(prompt, max_new_tokens)
        for _ in range(self.steps_total(g)):
            self.absorb_step(g, self.session.infer(*self.step_inputs(g)).outputs)
        return GenerationResult(tokens=np.concatenate(g["out"], axis=1), steps=max_new_tokens)

    def _generate_stateless(self, prompt: np.ndarray, max_new_tokens: int) -> GenerationResult:
        b, s = prompt.shape
        self._check_bucket(s, max_new_tokens)
        buf = np.zeros((b, self.bucket_len), np.int32)
        buf[:, :s] = prompt
        out: List[np.ndarray] = []
        for cur in range(s, s + max_new_tokens):
            # a fresh host tensor per call: the recording client keeps payloads
            res = self.session.infer(
                torch.from_numpy(buf.copy()), torch.tensor(cur, dtype=torch.int32)
            )
            nxt = res.outputs[0].numpy()
            out.append(nxt[:, None])
            buf[:, cur] = nxt
        return GenerationResult(tokens=np.concatenate(out, axis=1), steps=max_new_tokens)


class MultiClientServedLM:
    """N mobile clients generating with the same LM over one edge server.

    Every client runs the identical app (same model, same parameters, its
    own prompt), so all of them produce the same IOS fingerprint: the first
    client to finish the Operator Sequence Search populates the shared
    replay cache, every later client binds the cached program, and same-step
    replay submissions run as one ``vmap``-batched call on the edge server's
    device.  ``params`` (on the edge's device) default to the model's
    initialization from ``seed``."""

    def __init__(
        self,
        cfg: ArchConfig,
        num_clients: int,
        *,
        bucket_len: int = 64,
        seed: int = 0,
        min_repeats: int = 3,
        execute: bool = True,
        environment: str = "indoor",
        cache_capacity: int = 8,
        batch_window_s: float = 2e-3,
        edge: Optional[RRTOEdgeServer] = None,
        stateful: bool = True,
        params=None,
        device: Any = "cuda",
    ):
        if num_clients < 1:
            raise ValueError(f"need at least one client, got {num_clients}")
        self.cfg = cfg
        self.bucket_len = bucket_len
        self.stateful = stateful
        self.edge = edge or RRTOEdgeServer(
            execute=execute, cache_capacity=cache_capacity,
            batch_window_s=batch_window_s, environment=environment, device=device,
        )
        # one app binary on every device: identical parameters, so the replay
        # program (not just the IOS) is shareable verbatim, and same-round
        # submissions run as one vmap-batched call over the stacked states
        if params is None:
            params = get_model(cfg).init_params(cfg, seed, self.edge.server.device)
        self.clients = [
            RRTOServedLM(
                cfg, bucket_len=bucket_len, batch=1, min_repeats=min_repeats,
                params=params, edge=self.edge, client_id=f"c{i}", stateful=stateful,
            )
            for i in range(num_clients)
        ]

    def generate(
        self, prompts: Sequence[np.ndarray], max_new_tokens: int
    ) -> List[GenerationResult]:
        """Lockstep greedy generation: one token per client per round, with
        replay-phase clients batched on the shared GPU."""
        if len(prompts) != len(self.clients):
            raise ValueError(f"{len(prompts)} prompts for {len(self.clients)} clients")
        if self.stateful:
            return self._generate_stateful(prompts, max_new_tokens)
        bufs: List[np.ndarray] = []
        curs: List[int] = []
        for client, prompt in zip(self.clients, prompts):
            b, s = prompt.shape
            client._check_bucket(s, max_new_tokens)
            buf = np.zeros((b, self.bucket_len), np.int32)
            buf[:, :s] = prompt
            bufs.append(buf)
            curs.append(s)
        outs: List[List[np.ndarray]] = [[] for _ in self.clients]
        for _ in range(max_new_tokens):
            results = self.edge.run_round({
                client.session.client_id: (
                    torch.from_numpy(bufs[i].copy()), torch.tensor(curs[i], dtype=torch.int32)
                )
                for i, client in enumerate(self.clients)
            })
            for i, client in enumerate(self.clients):
                nxt = results[client.session.client_id].outputs[0].numpy()
                outs[i].append(nxt[:, None])
                bufs[i][:, curs[i]] = nxt
                curs[i] += 1
        return [
            GenerationResult(tokens=np.concatenate(o, axis=1), steps=max_new_tokens)
            for o in outs
        ]

    def _generate_stateful(
        self, prompts: Sequence[np.ndarray], max_new_tokens: int
    ) -> List[GenerationResult]:
        """Stateful lockstep: every client advances its decode step once per
        round (prompts may differ in length, so positions diverge — the
        batched step maps over per-client positions and cache slices);
        clients whose generation completed drop out of the round."""
        gens = [
            client.start_generation(np.asarray(prompt), max_new_tokens)
            for client, prompt in zip(self.clients, prompts)
        ]
        remaining = {
            client.session.client_id: (client, g) for client, g in zip(self.clients, gens)
        }
        while remaining:
            results = self.edge.run_round(
                {cid: client.step_inputs(g) for cid, (client, g) in remaining.items()}
            )
            for cid, (client, g) in list(remaining.items()):
                client.absorb_step(g, results[cid].outputs)
                if g["pos"] >= client.steps_total(g):
                    del remaining[cid]
        return [
            GenerationResult(tokens=np.concatenate(g["out"], axis=1), steps=max_new_tokens)
            for g in gens
        ]
