"""The port's patch-prefix LM (llava-next-34b: ``repro_torch.models.lm`` with
``num_patches``) against the JAX package's ``repro.models.lm`` on the CPU,
at the reduced llava-next-34b config (16 patches, f32), on the same
(converted) parameters and numpy inputs from a seed, at the kernel tests'
2e-4: ``forward`` (the patch rows dropped before the head and before
``return_hidden``), ``prefill`` (the patches first) and ``decode_step`` at
``s + num_patches``, and the gradient of every leaf through the chunked
loss against ``jax.grad`` (labels on the text positions).

``LocalServing`` counts the patch prefix in its default ``max_seq`` and in
every decode position, so its tokens equal the greedy tokens of the full
forward.  The reference's does neither (ROADMAP queue C): with its default
``max_seq`` its prefill pads by a negative amount and raises, and with
``max_seq`` set it decodes at ``s`` over a prefilled row, so its tokens part
from the greedy ones.  The served app sends text alone in both packages
(stateful: the same tokens, carried pairs, replay RPCs and wire bytes as
the reference's); both refuse the stateless app, whose forward needs the
patches."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import LocalServing as JLocalServing  # noqa: E402
from repro.serving.engine import RRTOServedLM as JRRTOServedLM  # noqa: E402
from repro.training.step import make_loss_fn as j_make_loss_fn  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving.engine import LocalServing, RRTOServedLM  # noqa: E402
from repro_torch.training.optimizer import leaf_paths, tree_map  # noqa: E402
from repro_torch.training.step import make_loss_fn  # noqa: E402

ARCH = "llava-next-34b"
TOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5   # tests/test_training.py::test_gradients_match
B, S = 2, 12
MAX_SEQ = 32
NEW = 4
BUCKET = 32


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(ours, ref, tol=TOL) -> None:
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pair():
    cfg_j, cfg = j_reduced(ARCH), get_reduced_config(ARCH)
    pj = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    patches = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "patches": patches, "labels": labels}
    return dict(cfg_j=cfg_j, cfg=cfg, pj=pj, params=params, batch=batch,
                jb={k: jnp.asarray(v) for k, v in batch.items()},
                tb={k: torch.from_numpy(v) for k, v in batch.items()})


def test_registry_routes_the_vlm_to_the_lm(pair):
    assert get_model(pair["cfg"]) is lm and pair["cfg"].num_patches == 16


@pytest.mark.parametrize("hidden", [False, True], ids=["logits", "hidden"])
def test_forward_drops_the_patch_rows(pair, hidden):
    p = pair
    ours = lm.forward(p["params"], p["tb"], p["cfg"], return_hidden=hidden)
    ref = jlm.forward(p["pj"], p["jb"], p["cfg_j"], return_hidden=hidden)
    assert ours.shape[1] == S and tuple(ours.shape) == ref.shape
    _close(ours, ref)


def test_prefill_and_decode_step(pair):
    p = pair
    with torch.no_grad():
        logits, cache = lm.prefill(p["params"], p["tb"], p["cfg"], MAX_SEQ)
    j_logits, j_cache = jlm.prefill(p["pj"], p["jb"], p["cfg_j"], MAX_SEQ)
    _close(logits, j_logits)
    for k in ("k", "v"):
        _close(cache["sub0"][k], j_cache["sub0"][k])
    nxt = np.argmax(np.asarray(j_logits)[:, 0, : p["cfg"].vocab], -1).astype(np.int32)[:, None]
    pos = S + p["cfg"].num_patches
    with torch.no_grad():
        d, new = lm.decode_step(p["params"], torch.from_numpy(nxt), cache,
                                torch.tensor(pos, dtype=torch.int32), p["cfg"])
    jd, j_new = jlm.decode_step(p["pj"], jnp.asarray(nxt), j_cache, jnp.int32(pos), p["cfg_j"])
    _close(d, jd)
    for k in ("k", "v"):
        _close(new["sub0"][k], j_new["sub0"][k])


def test_train_step_gradients_match_jax_grad(pair):
    p = pair
    live = tree_map(lambda t: t.detach().requires_grad_(True), p["params"])
    loss = make_loss_fn(p["cfg"], remat=False)(live, p["tb"])
    paths = leaf_paths(live)
    grads = torch.autograd.grad(loss, [t for _, t in paths])
    j_loss, j_grads = jax.value_and_grad(j_make_loss_fn(p["cfg_j"]))(p["pj"], p["jb"])
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=TOL)
    flat, _ = jax.tree_util.tree_flatten_with_path(j_grads)
    ref = {tuple(k.key for k in path): g for path, g in flat}
    assert [path for path, _ in paths] == list(ref)
    for (path, _), g in zip(paths, grads):
        np.testing.assert_allclose(_np(g), _np(ref[path]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(path))


def _greedy_by_forward(params, cfg, prompt, patches, n):
    """The greedy tokens of the full forward over the growing sequence."""
    toks = prompt.copy()
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits = lm.forward(params, {"tokens": torch.from_numpy(toks),
                                         "patches": torch.from_numpy(patches)}, cfg)
            nxt = np.argmax(logits[:, -1, : cfg.vocab].numpy(), -1).astype(np.int32)[:, None]
            out.append(nxt)
            toks = np.concatenate([toks, nxt], axis=1)
    return np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def generation(pair):
    p = pair
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, p["cfg"].vocab, (1, 5)).astype(np.int32)
    patches = rng.normal(0, 1, (1, p["cfg"].num_patches, p["cfg"].d_model)).astype(np.float32)
    batch = {"tokens": prompt, "patches": patches}
    greedy = _greedy_by_forward(p["params"], p["cfg"], prompt, patches, NEW)
    return dict(batch=batch, greedy=greedy)


def test_local_serving_counts_the_patch_prefix(pair, generation):
    p, g = pair, generation
    ours = LocalServing(p["cfg"], params=p["params"], device="cpu")
    np.testing.assert_array_equal(ours.generate(g["batch"], NEW).tokens, g["greedy"])
    np.testing.assert_array_equal(ours.generate(g["batch"], NEW, max_seq=64).tokens, g["greedy"])


def test_reference_local_serving_fault_is_pinned(pair, generation):
    """The reference's ``LocalServing`` on a VLM: its default ``max_seq``
    leaves out the patches and its prefill raises; with ``max_seq`` set it
    decodes at ``s``, over a row its prefill filled, and its tokens part
    from the greedy ones after the first (which the prefill gives)."""
    p, g = pair, generation
    ref = JLocalServing(p["cfg_j"], params=p["pj"])
    with pytest.raises(ValueError):
        ref.generate(g["batch"], NEW)
    tokens = ref.generate(g["batch"], NEW, max_seq=64).tokens
    assert tokens[0, 0] == g["greedy"][0, 0]
    assert not np.array_equal(tokens, g["greedy"])


def test_served_stateful_sends_text_alone_as_the_reference(pair):
    p = pair
    prompt = np.random.default_rng(2).integers(0, p["cfg"].vocab, (1, 6)).astype(np.int32)
    rrto = RRTOServedLM(p["cfg"], system="rrto", bucket_len=BUCKET, params=p["params"],
                        device="cpu")
    only = RRTOServedLM(p["cfg"], system="device_only", bucket_len=BUCKET, params=p["params"],
                        device="cpu")
    j_srv = JRRTOServedLM(p["cfg_j"], bucket_len=BUCKET, params=p["pj"], min_repeats=3)
    ours, ref = rrto.generate(prompt, NEW), j_srv.generate(prompt, NEW)
    np.testing.assert_array_equal(ours.tokens, ref.tokens)
    np.testing.assert_array_equal(only.generate(prompt, NEW).tokens, ours.tokens)
    assert rrto.session.client.ios.carried_pairs == j_srv.session.client.ios.carried_pairs
    replay = [(h.rpcs, h.network_bytes) for h in rrto.session.history if h.mode == "replaying"]
    assert replay == [(h.rpcs, h.network_bytes) for h in j_srv.session.history
                      if h.mode == "replaying"]
    assert all(r == 3 for r, _ in replay[1:])


def test_stateless_app_raises_in_both_packages(pair):
    with pytest.raises(ValueError, match="patches"):
        RRTOServedLM(pair["cfg"], bucket_len=BUCKET, params=pair["params"], device="cpu",
                     stateful=False)
    with pytest.raises(KeyError, match="patches"):
        JRRTOServedLM(pair["cfg_j"], bucket_len=BUCKET, params=pair["pj"], stateful=False)
