"""Serving engine: prefill + decode, plus RRTO record/replay serving at the
edge (the single-client part of ``repro.serving.engine``).

* ``LocalServing`` — the plain engine: prefill (flash attention) then a
  KV-cached greedy decode loop.

* ``RRTOServedLM`` — the paper's scenario mapped to LLM generation: a mobile
  client drives the KV-cached ``decode_step(token, pos, cache)`` app through
  the transparent offloading stack.  Every call executes the identical
  operator sequence, the Operator Sequence Search locks it after a few
  recorded calls, and the loop-carried state (the KV cache; a hybrid's
  conv and SSM states too) is detected across repeats and kept on the
  server: each replayed token costs the model's O(1) step compute plus 3
  RPCs (token and position up, next token down).  ``stateful=False`` is the
  seed formulation: the app is ``next_token(padded_tokens, cur_len)``, a
  full forward over a fixed bucket per token (the prefix-recompute
  baseline), with nothing carried.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.offload import OffloadableModel, OffloadSession
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model


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
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=self.device)
        b, s = tokens.shape
        max_seq = max_seq or (s + max_new_tokens)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens}, self.cfg, max_seq)
        nxt = _greedy(logits, self.cfg)[:, None]
        out: List[np.ndarray] = []
        for i in range(max_new_tokens):
            out.append(nxt.cpu().numpy())
            pos = torch.tensor(s + i, dtype=torch.int32, device=self.device)
            logits, cache = self.model.decode_step(self.params, nxt, cache, pos, self.cfg)
            nxt = _greedy(logits, self.cfg)[:, None]
        return GenerationResult(tokens=np.concatenate(out, axis=1), steps=max_new_tokens)


class RRTOServedLM:
    """LLM generation through the RRTO transparent-offloading stack (single
    client).  With ``stateful`` (the default) the cached decode step is the
    offloaded app; once the IOS locks, the engine detects the cache as
    loop-carried and each token replays as an O(1) step with the cache
    server-resident.  Without it the app recomputes the whole bucket per
    token (``next_token``) and every replayed token uploads the bucket."""

    def __init__(
        self,
        cfg: ArchConfig,
        *,
        system: str = "rrto",
        bucket_len: int = 64,
        batch: int = 1,
        seed: int = 0,
        min_repeats: int = 3,
        stateful: bool = True,
        params=None,
        device: Any = "cuda",
    ):
        self.cfg = cfg
        self.bucket_len = bucket_len
        self.stateful = stateful
        dev = resolve_device(device)
        model = get_model(cfg)
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
        self.session = OffloadSession(
            offloadable, system, min_repeats=min_repeats, device=dev
        )

    def generate(self, prompt: np.ndarray, max_new_tokens: int) -> GenerationResult:
        """Greedy generation; every call goes through the offloading stack.
        Stateful: the prompt is fed token by token through the same decode
        step (prefill-via-decode: the cache warms up through the IOS every
        later token replays), then each sampled token is fed back.  The cache
        tensors the app threads are opaque handles once replay turns
        stateful — the server advances the real state.  Stateless: each call
        sends the whole bucket (prompt and tokens so far, zero-padded) and
        its length."""
        b, s = prompt.shape
        if s + max_new_tokens > self.bucket_len:
            raise ValueError(
                f"prompt {s} + {max_new_tokens} new tokens overflow the "
                f"bucket of {self.bucket_len}"
            )
        if not self.stateful:
            return self._generate_stateless(prompt, max_new_tokens)
        prompt = torch.as_tensor(np.asarray(prompt, dtype=np.int32))
        state = list(self._cache_leaves)
        tok = prompt[:, 0:1].clone()
        out: List[np.ndarray] = []
        for pos in range(s + max_new_tokens - 1):
            res = self.session.infer(tok, torch.tensor(pos, dtype=torch.int32), *state)
            nxt, state = res.outputs[0], list(res.outputs[1:])
            if pos + 1 < s:
                tok = prompt[:, pos + 1 : pos + 2].clone()
            else:
                out.append(nxt[:, None].numpy())
                tok = nxt[:, None].clone()
        return GenerationResult(tokens=np.concatenate(out, axis=1), steps=max_new_tokens)

    def _generate_stateless(self, prompt: np.ndarray, max_new_tokens: int) -> GenerationResult:
        b, s = prompt.shape
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
