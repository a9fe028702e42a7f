"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-base)
against the JAX package's ``repro.models.encdec`` on the CPU, at the reduced
whisper-base config (2 + 2 layers, 32 frames, 64 decoder positions, f32),
on the same (converted) parameters and numpy inputs from a seed, at the
kernel tests' 2e-4: ``encode``, ``forward`` (logits and hidden states),
``prefill`` (logits, the self cache and the cross cache), ``decode_step``,
``loss_fn``, and the gradient of every leaf through the chunked loss
against ``jax.grad`` (the reference's own gradient tolerance).  Then
served: ``LocalServing``'s tokens (with frames) and the stateful
``RRTOServedLM``'s tokens, carried pairs, replay RPCs and wire bytes equal
the reference's; the cross cache stays off the wire (the app decodes from
the zero cross cache of ``init_cache``, as the reference's does); both
packages refuse the stateless app, whose forward needs frames."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.serving.engine import LocalServing as JLocalServing  # noqa: E402
from repro.serving.engine import RRTOServedLM as JRRTOServedLM  # noqa: E402
from repro.training.step import make_loss_fn as j_make_loss_fn  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving.engine import LocalServing, RRTOServedLM  # noqa: E402
from repro_torch.training.optimizer import leaf_paths, tree_map  # noqa: E402
from repro_torch.training.step import make_loss_fn  # noqa: E402

ARCH = "whisper-base"
TOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5   # tests/test_training.py::test_gradients_match
B, S = 2, 12
MAX_SEQ = 32
NEW = 6
BUCKET = 32


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(ours, ref, tol=TOL) -> None:
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=tol, atol=tol)


def _leaves(tree) -> dict:
    """{path: leaf} of a nested dict (either package's)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[path] = node

    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def pair():
    cfg_j, cfg = j_reduced(ARCH), get_reduced_config(ARCH)
    pj = jenc.init_params(jax.random.PRNGKey(0), cfg_j)
    params = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "frames": frames, "labels": labels}
    return dict(cfg_j=cfg_j, cfg=cfg, pj=pj, params=params,
                jb={k: jnp.asarray(v) for k, v in batch.items()},
                tb={k: torch.from_numpy(v) for k, v in batch.items()})


def test_registry_and_params_tree(pair):
    cfg = pair["cfg"]
    assert get_model(cfg) is encdec and cfg.is_encoder_decoder
    ours = _leaves(encdec.init_params(cfg, 0, "cpu"))
    ref = _leaves(jax.tree.map(np.asarray, pair["pj"]))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape and ours[k].dtype == torch.float32, k


def test_encode(pair):
    p = pair
    ours = encdec.encode(p["params"], p["tb"]["frames"], p["cfg"])
    _close(ours, jenc.encode(p["pj"], p["jb"]["frames"], p["cfg_j"]))


@pytest.mark.parametrize("hidden", [False, True], ids=["logits", "hidden"])
def test_forward(pair, hidden):
    p = pair
    ours = encdec.forward(p["params"], p["tb"], p["cfg"], return_hidden=hidden)
    ref = jenc.forward(p["pj"], p["jb"], p["cfg_j"], return_hidden=hidden)
    assert tuple(ours.shape) == ref.shape
    _close(ours, ref)


@pytest.fixture(scope="module")
def prefilled(pair):
    p = pair
    with torch.no_grad():
        ours = encdec.prefill(p["params"], p["tb"], p["cfg"], MAX_SEQ)
    return ours, jenc.prefill(p["pj"], p["jb"], p["cfg_j"], MAX_SEQ)


def test_prefill_logits_and_caches(prefilled):
    (logits, cache), (j_logits, j_cache) = prefilled
    _close(logits, j_logits)
    ours, ref = _leaves(cache), _leaves(j_cache)
    # the reference's leaf order: cross before self
    assert list(ours) == [tuple(k.key for k in path) for path, _ in
                          jax.tree_util.tree_flatten_with_path(j_cache)[0]]
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        _close(ours[k], ref[k])


def test_decode_step(pair, prefilled):
    p = pair
    (logits, cache), (j_logits, j_cache) = prefilled
    nxt = np.argmax(np.asarray(j_logits)[:, 0, : p["cfg"].vocab], -1).astype(np.int32)[:, None]
    with torch.no_grad():
        d, new = encdec.decode_step(p["params"], torch.from_numpy(nxt), cache,
                                    torch.tensor(S, dtype=torch.int32), p["cfg"])
    jd, j_new = jenc.decode_step(p["pj"], jnp.asarray(nxt), j_cache, jnp.int32(S), p["cfg_j"])
    _close(d, jd)
    ours, ref = _leaves(new), _leaves(j_new)
    for k in ref:
        _close(ours[k], ref[k])
    # the cross cache is read, not written: the same tensors come back
    assert new["cross"]["k"] is cache["cross"]["k"] and new["cross"]["v"] is cache["cross"]["v"]


def test_decode_step_traces_once_for_every_position(pair):
    """The learned position is read at a tensor index (clamped, as the
    reference's ``dynamic_slice_in_dim`` clamps): two positions, one of
    them past the table, trace to the same operators, and no value is read
    on the host."""
    p = pair
    cfg = p["cfg"]
    cache = encdec.init_cache(cfg, 1, BUCKET, "cpu")

    def ops(pos):
        gm = make_fx(lambda params, c, t, q: encdec.decode_step(params, t, c, q, cfg)[0],
                     tracing_mode="fake")(p["params"], cache,
                                          torch.zeros((1, 1), dtype=torch.int32),
                                          torch.tensor(pos, dtype=torch.int32))
        return [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]

    a, b = ops(3), ops(cfg.max_target_positions + 5)
    assert a == b
    assert not any("_local_scalar_dense" in o or "item" in o for o in a)


def test_init_cache(pair):
    cfg, cfg_j = pair["cfg"], pair["cfg_j"]
    for max_seq in (BUCKET, 4 * cfg.max_target_positions):
        ours = _leaves(encdec.init_cache(cfg, 2, max_seq, "cpu"))
        ref = _leaves(jenc.init_cache(cfg_j, 2, max_seq))
        assert ours.keys() == ref.keys()
        for k in ref:
            assert tuple(ours[k].shape) == ref[k].shape and not ours[k].any(), k


def test_loss_fn(pair):
    p = pair
    ours = encdec.loss_fn(p["params"], p["tb"], p["cfg"])
    np.testing.assert_allclose(float(ours), float(jenc.loss_fn(p["pj"], p["jb"], p["cfg_j"])),
                               rtol=TOL)


def _grads(loss_fn, params, batch):
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(live, batch)
    paths = leaf_paths(live)
    grads = torch.autograd.grad(loss, [t for _, t in paths])
    return loss, {path: g for (path, _), g in zip(paths, grads)}


def test_train_step_gradients_match_jax_grad(pair):
    """Every leaf's gradient of the chunked loss (``make_loss_fn``: the
    decoder's hidden state, the final norm and ``head_weights``)."""
    p = pair
    loss, grads = _grads(make_loss_fn(p["cfg"], remat=False), p["params"], p["tb"])
    j_loss, j_grads = jax.value_and_grad(j_make_loss_fn(p["cfg_j"]))(p["pj"], p["jb"])
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=TOL)
    ref = _leaves(j_grads)
    assert set(grads) == set(ref)
    for k in ref:
        np.testing.assert_allclose(_np(grads[k]), _np(ref[k]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(k))


def test_remat_is_bitwise_the_plain_forward(pair):
    p = pair
    loss_a, ga = _grads(make_loss_fn(p["cfg"], remat=True), p["params"], p["tb"])
    loss_b, gb = _grads(make_loss_fn(p["cfg"], remat=False), p["params"], p["tb"])
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


# ---------------------------------------------------------------- served

@pytest.fixture(scope="module")
def served(pair):
    p = pair
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, p["cfg"].vocab, (1, 4)).astype(np.int32)
    frames = rng.normal(0, 1, (1, p["cfg"].enc_seq, p["cfg"].d_model)).astype(np.float32)
    local = LocalServing(p["cfg"], params=p["params"], device="cpu").generate(
        {"tokens": prompt, "frames": frames}, NEW)
    j_local = JLocalServing(p["cfg_j"], params=p["pj"]).generate(
        {"tokens": prompt, "frames": frames}, NEW)
    rrto = RRTOServedLM(p["cfg"], system="rrto", bucket_len=BUCKET, params=p["params"],
                        device="cpu")
    only = RRTOServedLM(p["cfg"], system="device_only", bucket_len=BUCKET,
                        params=p["params"], device="cpu")
    j_srv = JRRTOServedLM(p["cfg_j"], bucket_len=BUCKET, params=p["pj"], min_repeats=3)
    return dict(local=local, j_local=j_local, rrto=rrto, tokens=rrto.generate(prompt, NEW),
                only=only.generate(prompt, NEW), j_srv=j_srv, j_tokens=j_srv.generate(prompt, NEW))


def test_local_serving_tokens_match_the_references(served):
    np.testing.assert_array_equal(served["local"].tokens, served["j_local"].tokens)


def test_served_stateful_matches_the_references(served):
    s = served
    np.testing.assert_array_equal(s["tokens"].tokens, s["j_tokens"].tokens)
    np.testing.assert_array_equal(s["only"].tokens, s["tokens"].tokens)
    ours, ref = s["rrto"].session, s["j_srv"].session
    assert ours.client.mode == "replaying"
    assert ours.client.ios.carried_pairs == ref.client.ios.carried_pairs
    assert [h.mode for h in ours.history] == [h.mode for h in ref.history]
    replay = [(h.rpcs, h.network_bytes) for h in ours.history if h.mode == "replaying"]
    assert replay == [(h.rpcs, h.network_bytes) for h in ref.history if h.mode == "replaying"]


def test_cross_cache_stays_off_the_wire(served):
    s = served
    leaves = s["rrto"]._cache_leaves
    assert len(s["rrto"].session.client.ios.carried_pairs) == len(leaves) == 4
    cross = sum(t.numel() * t.element_size() for t in leaves[:2])
    steady = [h for h in s["rrto"].session.history if h.mode == "replaying"][1:]
    assert steady and all(h.rpcs == 3 and h.network_bytes < cross for h in steady)


def test_stateless_app_raises_in_both_packages(pair):
    with pytest.raises(ValueError, match="frames"):
        RRTOServedLM(pair["cfg"], bucket_len=BUCKET, params=pair["params"], device="cpu",
                     stateful=False)
    with pytest.raises(KeyError, match="frames"):
        JRRTOServedLM(pair["cfg_j"], bucket_len=BUCKET, params=pair["pj"], stateful=False)
