"""The int8 KV cache (``kv_cache_bits=8``) of the port against the JAX
package's on the CPU, on seeded numpy inputs and (converted) parameters:

* ``quantize_kv`` bitwise, from f32 and from bf16;
* ``decode_attention_q8_ref`` at 2e-4 (f32) and 2e-2 (bf16) over many
  chunks (a small ``chunk``), a ragged S, ``kv_len`` < S, a window, and
  n_rep 1, 2 and 4;
* the leaves of ``init_kv_cache`` and of each family's ``init_cache``:
  names, dtypes, shapes and the flatten order (the reference's sorted
  order k, ks, v, vs: the carried pairs are matched by value, and the zero
  leaves of one dtype are byte-identical);
* reduced qwen3-0.6b and mixtral-8x7b served with 8 bits: ``LocalServing``,
  and ``RRTOServedLM`` stateful and stateless, against the reference's:
  tokens, modes, replay RPCs, and the carried pairs pair for pair; each
  steady token takes 3 RPCs;
* reduced zamba2-1.2b (every block: ``n_layers=5, attn_every=2``) and
  whisper-base: the reference's ``LocalServing`` prefill raises
  ``TypeError`` (only its ``models/lm.py`` quantizes a prompt's K/V; ROADMAP
  queue C), the port's quantizes it as ``lm.py`` does.  Its prefill cache
  equals the cache its decode steps build from the same prompt to within
  one int8 step at the first attention site (later sites read attention
  over the float K/V in the prefill and over the int8 cache in the decode
  steps, as the reference's ``lm.py`` does: within 4 steps; the LM's
  prefill cache is within one step of the reference's at every layer),
  and its ``LocalServing`` tokens equal those of the same
  prompt decoded token by token (zamba2: its own stateful rrto, which also
  equals the reference's; whisper: a decode-only loop from the prefill's
  cross cache, since the served app decodes from the zero cross cache)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_q8_ref as j_q8  # noqa: E402
from repro.kernels.decode_attention.ref import quantize_kv as j_quantize  # noqa: E402
from repro.layers.attention import init_kv_cache as j_init_kv_cache  # noqa: E402
from repro.models.registry import get_model as j_get_model  # noqa: E402
from repro.serving.engine import LocalServing as JLocalServing  # noqa: E402
from repro.serving.engine import RRTOServedLM as JRRTOServedLM  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_q8_ref, quantize_kv  # noqa: E402
from repro_torch.layers.attention import init_kv_cache  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving.engine import LocalServing, RRTOServedLM  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py
Q8 = dict(kv_cache_bits=8)
EVERY_BLOCK = dict(n_layers=5, attn_every=2)   # zamba2: both groups and the tail run


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _leaves(tree) -> list:
    """[(path, leaf)] of a nested dict of either package, in its flatten
    order (``torch.utils._pytree``'s or JAX's)."""
    if isinstance(next(iter(jax.tree.leaves(tree)), None), torch.Tensor):
        flat, _ = torch.utils._pytree.tree_flatten_with_path(tree)
    else:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


def _pair(arch, **overrides):
    cfg_j, cfg = j_reduced(arch, **overrides), get_reduced_config(arch, **overrides)
    pj = j_get_model(cfg_j).init_params(jax.random.PRNGKey(3), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")


# ------------------------------------------------------ the plain functions

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_the_references_bitwise(dtype):
    x = (np.random.default_rng(0).normal(0, 1, (2, 37, 4, 16)) * 3).astype(np.float32)
    x[0, 3] = 0.0                                   # a zero row: scale 1e-8
    xj = jnp.asarray(x).astype(dtype)
    q, s = quantize_kv(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
    qj, sj = j_quantize(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


# (b, s, hq, hkv, d, kv_len, window, chunk)
Q8_CASES = [
    (2, 37, 8, 2, 16, (30, 12), 9, 8),       # n_rep 4, ragged S over 5 chunks, a window
    (1, 64, 4, 4, 32, (63,), None, 16),      # n_rep 1
    (2, 50, 8, 4, 16, (50, 7), None, 1024),  # n_rep 2, one chunk (the served case)
    (3, 40, 4, 1, 16, (1, 40, 17), 5, 6),    # n_rep 4 on one KV head, ragged chunks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", Q8_CASES, ids=[f"case{i}" for i in range(len(Q8_CASES))])
def test_decode_attention_q8_ref_matches_the_reference(case, dtype):
    b, s, hq, hkv, d, lens, window, chunk = case
    rng = np.random.default_rng(1)
    kq, ks = j_quantize(jnp.asarray(rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)))
    vq, vs = j_quantize(jnp.asarray(rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)))
    qj = jnp.asarray(rng.normal(0, 1, (b, hq, d)).astype(np.float32)).astype(dtype)
    kv_len = np.asarray(lens, np.int32)
    ref = j_q8(qj, kq, vq, ks, vs, jnp.asarray(kv_len), window=window, chunk=chunk)
    q = torch.from_numpy(np.asarray(qj.astype(jnp.float32))).to(getattr(torch, dtype))
    out = decode_attention_q8_ref(
        q, *(torch.from_numpy(np.array(t)) for t in (kq, vq, ks, vs)),
        torch.from_numpy(kv_len), window=window, chunk=chunk)
    assert out.dtype == q.dtype and out.shape == (b, hq, d)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("bits", [16, 8])
def test_init_kv_cache_leaves_are_the_references(bits):
    cfg_j, cfg = j_reduced("qwen3-0.6b", kv_cache_bits=bits), get_reduced_config(
        "qwen3-0.6b", kv_cache_bits=bits)
    ours = _leaves(init_kv_cache(cfg, 2, 16, torch.float32, "cpu"))
    ref = _leaves(j_init_kv_cache(cfg_j, 2, 16, jnp.float32))
    assert [p for p, _ in ours] == [p for p, _ in ref]
    assert [p for p, _ in ours] == ([("k",), ("ks",), ("v",), ("vs",)] if bits == 8
                                    else [("k",), ("v",)])
    for (path, a), (_, b) in zip(ours, ref):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] == str(b.dtype), path


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b", "whisper-base", "zamba2-1.2b"])
def test_model_caches_carry_the_references_leaves(arch):
    """Every family's ``init_cache`` with 8 bits: the reference's leaves by
    path, shape and dtype; in the reference's order wherever the port's
    dicts follow it (the LM and whisper; the hybrid's top level keeps its
    own order, and inside each KV site the order is k, ks, v, vs)."""
    kw = dict(Q8, **(EVERY_BLOCK if arch == "zamba2-1.2b" else {}))
    cfg_j, cfg = j_reduced(arch, **kw), get_reduced_config(arch, **kw)
    ours = _leaves(get_model(cfg).init_cache(cfg, 1, 16, "cpu"))
    ref = _leaves(j_get_model(cfg_j).init_cache(cfg_j, 1, 16))
    if arch == "zamba2-1.2b":
        assert sorted(p for p, _ in ours) == [p for p, _ in ref]
        assert [p[-1] for p, _ in ours if p[0] == "shared_kv"] == ["k", "ks", "v", "vs"]
    else:
        assert [p for p, _ in ours] == [p for p, _ in ref]
    want = dict(ref)
    for path, leaf in ours:
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path


# ---------------------------------------------------------------- served

PROMPT = {"qwen3-0.6b": 12, "mixtral-8x7b": 30}   # mixtral: its window of 32 active
NEW = 6
BUCKET = {"qwen3-0.6b": 32, "mixtral-8x7b": 64}
SERVED = [(a, st) for a in PROMPT for st in (True, False)]


@pytest.fixture(scope="module", params=SERVED,
                ids=[f"{a}-{'stateful' if st else 'stateless'}" for a, st in SERVED])
def served(request):
    arch, stateful = request.param
    cfg_j, cfg, pj, params = _pair(arch, **Q8)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (1, PROMPT[arch])).astype(np.int32)
    j_srv = JRRTOServedLM(cfg_j, bucket_len=BUCKET[arch], params=pj, min_repeats=3,
                          stateful=stateful)
    runs = {system: RRTOServedLM(cfg, system=system, bucket_len=BUCKET[arch], params=params,
                                 device="cpu", stateful=stateful)
            for system in ("rrto", "device_only")}
    out = dict(cfg=cfg, stateful=stateful, j_srv=j_srv,
               j_tokens=j_srv.generate(prompt, NEW).tokens, runs=runs,
               tokens={s: r.generate(prompt, NEW).tokens for s, r in runs.items()})
    if stateful:
        out["local"] = LocalServing(cfg, params=params, device="cpu").generate(
            {"tokens": prompt}, NEW).tokens
        out["j_local"] = JLocalServing(cfg_j, params=pj).generate({"tokens": prompt}, NEW).tokens
    return out


def test_served_tokens_match_the_references(served):
    s = served
    np.testing.assert_array_equal(s["tokens"]["rrto"], s["j_tokens"])
    np.testing.assert_array_equal(s["tokens"]["device_only"], s["tokens"]["rrto"])
    if s["stateful"]:
        np.testing.assert_array_equal(s["local"], s["j_local"])
        np.testing.assert_array_equal(s["local"], s["tokens"]["rrto"])


def test_served_modes_rpcs_and_carried_pairs_match_the_references(served):
    s = served
    ours, ref = s["runs"]["rrto"].session, s["j_srv"].session
    assert ours.client.mode == "replaying"
    assert [h.mode for h in ours.history] == [h.mode for h in ref.history]
    assert [h.rpcs for h in ours.history if h.mode == "replaying"] == [
        h.rpcs for h in ref.history if h.mode == "replaying"]
    pairs = ours.client.ios.carried_pairs
    assert pairs == ref.client.ios.carried_pairs
    if not s["stateful"]:
        assert not pairs
        return
    leaves = s["runs"]["rrto"]._cache_leaves
    # one stacked (L, ...) leaf each of k, ks, v and vs
    assert len(pairs) == len(leaves) == 4
    assert [t.dtype for t in leaves] == [torch.int8, torch.float32] * 2
    assert all(t.shape[0] == s["cfg"].n_layers for t in leaves)
    smallest = min(t.numel() * t.element_size() for t in leaves)
    steady = [h for h in ours.history if h.mode == "replaying"][1:]
    assert steady and all(h.rpcs == 3 and h.network_bytes < smallest for h in steady)


# ------------------------------------- the hybrid and the encoder-decoder

def _prompt(cfg, n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (1, n)).astype(np.int32)


def _frames(cfg) -> np.ndarray:
    return np.random.default_rng(2).normal(0, 1, (1, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _decode_prompt(model, params, cfg, prompt, cache):
    """Feed ``prompt`` through ``decode_step`` one token at a time; return
    the cache and the logits of the last position."""
    for i in range(prompt.shape[1]):
        tok = torch.from_numpy(prompt[:, i:i + 1].copy())
        logits, cache = model.decode_step(params, tok, cache, torch.tensor(i, dtype=torch.int32),
                                          cfg)
    return cache, logits


def _assert_within_steps(a: dict, b: dict, steps: int, scale_rtol: float) -> None:
    """Two int8 caches of (L, ...) leaves: every value within ``steps``
    quantization steps, the scales within ``scale_rtol`` of each other."""
    for name in ("k", "v"):
        assert a[name].dtype == b[name].dtype == torch.int8
        diff = (a[name].to(torch.int16) - b[name].to(torch.int16)).abs()
        assert int(diff.max()) <= steps, (name, int(diff.max()))
    for name in ("ks", "vs"):
        np.testing.assert_allclose(_np(a[name]), _np(b[name]), rtol=scale_rtol, atol=1e-9)


def _first(cache: dict) -> dict:
    return {name: leaf[:1] for name, leaf in cache.items()}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b"])
def test_lm_prefill_cache_matches_the_references(arch):
    """``models/lm.py``'s prefill quantizes the prompt's K/V as the
    reference's does: every layer within one int8 step, the scales within
    1e-5, the logits at 2e-4."""
    cfg_j, cfg, pj, params = _pair(arch, **Q8)
    prompt = _prompt(cfg, 7)
    with torch.no_grad():
        logits, cache = get_model(cfg).prefill(params, {"tokens": torch.from_numpy(prompt)},
                                               cfg, 16)
    j_logits, j_cache = j_get_model(cfg_j).prefill(pj, {"tokens": jnp.asarray(prompt)}, cfg_j, 16)
    ref = {name: torch.from_numpy(np.array(leaf)) for name, leaf in j_cache["sub0"].items()}
    _assert_within_steps(cache["sub0"], ref, 1, 1e-5)
    np.testing.assert_allclose(_np(logits), _np(j_logits), rtol=TOL["float32"],
                               atol=TOL["float32"])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-base"])
def test_reference_local_prefill_fault_is_pinned(arch):
    """Only the reference's ``models/lm.py`` quantizes a prompt's K/V: its
    hybrid and encoder-decoder prefills return a float cache, and the first
    decode step's int8 write raises."""
    kw = dict(Q8, **(EVERY_BLOCK if arch == "zamba2-1.2b" else {}))
    cfg_j, _, pj, _ = _pair(arch, **kw)
    batch = {"tokens": _prompt(cfg_j, 5)}
    if cfg_j.is_encoder_decoder:
        batch["frames"] = _frames(cfg_j)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        JLocalServing(cfg_j, params=pj).generate(batch, 3)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-base", "qwen3-0.6b"])
def test_prefill_quantizes_the_prompt_as_the_decode_steps_do(arch):
    """The prefill's int8 cache against the one the decode steps build
    from the same prompt.  The first attention site reads the same hidden
    states both ways: within one int8 step, the scales within 1e-5.  A
    later site's input has passed through attention, which the prefill
    runs over the float K/V and each decode step over the int8 cache (as
    in the reference's ``lm.py``): within 4 steps, the scales within 2%,
    and the last position's logits within 2% of the largest."""
    kw = dict(Q8, **(EVERY_BLOCK if arch == "zamba2-1.2b" else {}))
    _, cfg, _, params = _pair(arch, **kw)
    model = get_model(cfg)
    prompt, max_seq = _prompt(cfg, 7), 16
    batch = {"tokens": torch.from_numpy(prompt)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(_frames(cfg))
    with torch.no_grad():
        logits, filled = model.prefill(params, batch, cfg, max_seq)
        cache = model.init_cache(cfg, 1, max_seq, "cpu")
        if cfg.is_encoder_decoder:
            cache["cross"] = filled["cross"]
        built, last = _decode_prompt(model, params, cfg, prompt, cache)
    site = {"zamba2-1.2b": "shared_kv", "whisper-base": "self"}.get(arch, "sub0")
    assert list(filled[site]) == ["k", "ks", "v", "vs"]
    _assert_within_steps(_first(filled[site]), _first(built[site]), 1, 1e-5)
    _assert_within_steps(filled[site], built[site], 4, 2e-2)
    assert not filled[site]["k"][:, :, prompt.shape[1]:].any()
    big = float(np.abs(_np(last)).max())
    np.testing.assert_allclose(_np(logits), _np(last), rtol=0, atol=2e-2 * big)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-base"])
def test_local_serving_equals_the_decoded_prompt(arch):
    kw = dict(Q8, **(EVERY_BLOCK if arch == "zamba2-1.2b" else {}))
    cfg_j, cfg, pj, params = _pair(arch, **kw)
    prompt = _prompt(cfg, 6)
    if not cfg.is_encoder_decoder:
        local = LocalServing(cfg, params=params, device="cpu").generate({"tokens": prompt}, NEW)
        rrto = RRTOServedLM(cfg, bucket_len=16, params=params, device="cpu").generate(prompt, NEW)
        j_rrto = JRRTOServedLM(cfg_j, bucket_len=16, params=pj, min_repeats=3).generate(prompt, NEW)
        np.testing.assert_array_equal(local.tokens, rrto.tokens)
        np.testing.assert_array_equal(rrto.tokens, j_rrto.tokens)
        return
    frames = _frames(cfg)
    model = get_model(cfg)
    local = LocalServing(cfg, params=params, device="cpu").generate(
        {"tokens": prompt, "frames": frames}, NEW)
    with torch.no_grad():
        _, filled = model.prefill(params, {"tokens": torch.from_numpy(prompt),
                                           "frames": torch.from_numpy(frames)}, cfg, 12)
        cache = model.init_cache(cfg, 1, 12, "cpu")
        cache["cross"] = filled["cross"]
        cache, logits = _decode_prompt(model, params, cfg, prompt, cache)
        toks = []
        for i in range(NEW):
            nxt = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1).to(torch.int32)[:, None]
            toks.append(nxt.numpy())
            logits, cache = model.decode_step(params, nxt, cache,
                                              torch.tensor(prompt.shape[1] + i, dtype=torch.int32),
                                              cfg)
    np.testing.assert_array_equal(local.tokens, np.concatenate(toks, axis=1))
