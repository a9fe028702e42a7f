"""The slices end to end on the CPU: the port's RRTO-served decode against
the JAX package's ``LocalServing`` and ``RRTOServedLM`` on the
tests/test_serving.py configuration (seed 3, prompt seed 0, bucket 32, 12
new tokens) and on the reduced zamba2 hybrid (two groups with the shared
attention block, a one-layer tail), stateful and stateless (``next_token``),
with the JAX parameters converted to the port."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import LocalServing as JLocalServing  # noqa: E402
from repro.serving.engine import RRTOServedLM as JRRTOServedLM  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.offload import SYSTEMS  # noqa: E402
from repro_torch.kernels import library  # noqa: E402
from repro_torch.serving.engine import LocalServing, RRTOServedLM  # noqa: E402

FIELDS = dict(
    name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=256, dtype="float32", rope_theta=1e4,
)
NEW = 12


@pytest.fixture(scope="module")
def runs():
    cfg_j, cfg = JArchConfig(**FIELDS), ArchConfig(**FIELDS)
    prompt = np.random.default_rng(0).integers(0, 256, (1, 8)).astype(np.int32)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), cfg_j)), cfg, "cpu"
    )
    j_local = JLocalServing(cfg_j, seed=3).generate({"tokens": prompt}, NEW)
    j_served = JRRTOServedLM(cfg_j, bucket_len=32, batch=1, seed=3, min_repeats=3)
    j_tokens = j_served.generate(prompt, NEW)
    served = {}
    for system in SYSTEMS:
        s = RRTOServedLM(cfg, system=system, bucket_len=32, params=params, device="cpu")
        served[system] = (s, s.generate(prompt, NEW))
    local = LocalServing(cfg, params=params, device="cpu").generate({"tokens": prompt}, NEW)
    return dict(
        cfg=cfg, prompt=prompt, params=params, j_local=j_local, j_served=j_served,
        j_tokens=j_tokens, served=served, local=local,
    )


def test_tokens_match_jax(runs):
    """Greedy tokens in f32: the port's served decode equals the JAX
    package's LocalServing and its RRTO-served decode, token for token."""
    _, r = runs["served"]["rrto"]
    np.testing.assert_array_equal(r.tokens, runs["j_local"].tokens)
    np.testing.assert_array_equal(r.tokens, runs["j_tokens"].tokens)
    np.testing.assert_array_equal(runs["local"].tokens, runs["j_local"].tokens)


def test_modes_and_replay_rpcs_match_jax(runs):
    """Recording RPC counts differ (the port unrolls the layers the reference
    scans as one equation), but the mode switches and every replay-phase RPC
    count are the reference's."""
    s, _ = runs["served"]["rrto"]
    ours, ref = s.session.history, runs["j_served"].session.history
    assert [h.mode for h in ours] == [h.mode for h in ref]
    assert [h.rpcs for h in ours if h.mode == "replaying"] == [
        h.rpcs for h in ref if h.mode == "replaying"
    ]
    assert ours[-1].rpcs <= 3 and ours[0].rpcs > 100


def test_kv_cache_is_carried(runs):
    s, _ = runs["served"]["rrto"]
    client = s.session.client
    assert client.stateful_replay and len(client.ios.carried_pairs) >= 1
    program = s.session.server.context().replay.program
    assert program.is_stateful and program.step_fn is not None
    cache_bytes = sum(t.numel() * t.element_size() for t in s._cache_leaves)
    steady = [h for h in s.session.history if h.mode == "replaying"][1:]
    assert steady and all(h.network_bytes < cache_bytes for h in steady)


def test_rrto_bitwise_equals_device_only(runs):
    """The replay re-executes exactly the aten calls the eager device run
    makes: same tokens, and the same cache bits while recording."""
    s_rrto, r_rrto = runs["served"]["rrto"]
    s_dev, r_dev = runs["served"]["device_only"]
    np.testing.assert_array_equal(r_rrto.tokens, r_dev.tokens)
    for a, b in zip(s_rrto.session.history, s_dev.session.history):
        assert torch.equal(a.outputs[0], b.outputs[0])
        if a.mode == "recording":
            assert all(torch.equal(x, y) for x, y in zip(a.outputs[1:], b.outputs[1:]))


def test_all_systems_identical(runs):
    ref = runs["served"]["device_only"][1].tokens
    for system, (_, r) in runs["served"].items():
        np.testing.assert_array_equal(r.tokens, ref, err_msg=system)


def test_cricket_stays_per_operator(runs):
    s, _ = runs["served"]["cricket"]
    assert all(h.rpcs > 100 for h in s.session.history)
    assert s.session.client.mode == "recording"


def test_bucket_overflow_raises(runs):
    s, _ = runs["served"]["rrto"]
    with pytest.raises(ValueError, match="overflow"):
        s.generate(runs["prompt"], 32)


# ---------------------------------------------------------------------------
# the zamba2 hybrid, and the stateless next_token formulation
# ---------------------------------------------------------------------------

HYBRID = dict(n_layers=5, attn_every=2)
HYBRID_NEW = 8


@pytest.fixture(scope="module")
def hybrid_runs():
    cfg_j = j_reduced("zamba2-1.2b", **HYBRID)
    cfg = get_reduced_config("zamba2-1.2b", **HYBRID)
    prompt = np.random.default_rng(0).integers(0, 256, (1, 8)).astype(np.int32)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jhybrid.init_params(jax.random.PRNGKey(3), cfg_j)), cfg,
        "cpu",
    )
    j_local = JLocalServing(cfg_j, seed=3).generate({"tokens": prompt}, HYBRID_NEW)
    j_served = JRRTOServedLM(cfg_j, bucket_len=32, batch=1, seed=3, min_repeats=3)
    j_tokens = j_served.generate(prompt, HYBRID_NEW)
    served = {
        system: RRTOServedLM(cfg, system=system, bucket_len=32, params=params, device="cpu")
        for system in ("rrto", "device_only")
    }
    tokens = {system: s.generate(prompt, HYBRID_NEW) for system, s in served.items()}
    local = LocalServing(cfg, params=params, device="cpu").generate(
        {"tokens": prompt}, HYBRID_NEW
    )
    return dict(cfg=cfg, prompt=prompt, j_local=j_local, j_served=j_served,
                j_tokens=j_tokens, served=served, tokens=tokens, local=local)


def test_hybrid_tokens_match_jax(hybrid_runs):
    r = hybrid_runs
    np.testing.assert_array_equal(r["tokens"]["rrto"].tokens, r["j_local"].tokens)
    np.testing.assert_array_equal(r["tokens"]["rrto"].tokens, r["j_tokens"].tokens)
    np.testing.assert_array_equal(r["local"].tokens, r["j_local"].tokens)
    np.testing.assert_array_equal(r["tokens"]["device_only"].tokens,
                                  r["tokens"]["rrto"].tokens)


def test_hybrid_modes_and_replay_rpcs_match_jax(hybrid_runs):
    ours = hybrid_runs["served"]["rrto"].session.history
    ref = hybrid_runs["j_served"].session.history
    assert [h.mode for h in ours] == [h.mode for h in ref]
    assert [h.rpcs for h in ours if h.mode == "replaying"] == [
        h.rpcs for h in ref if h.mode == "replaying"
    ]
    assert ours[-1].rpcs <= 3


def test_hybrid_state_is_carried_off_the_wire(hybrid_runs):
    """Every cache leaf (group and tail conv and SSM states, the shared
    block's K and V sites) is a carried pair, as in the reference, and the
    steady replay sends none of them."""
    s = hybrid_runs["served"]["rrto"]
    client = s.session.client
    pairs = client.ios.carried_pairs
    assert pairs == hybrid_runs["j_served"].session.client.ios.carried_pairs
    assert len(pairs) == len(s._cache_leaves) == 6
    assert s.session.server.context().replay.program.is_stateful
    state = s.session.server.context().replay.carried_state
    # tail conv, tail ssm + group conv + K + V, group ssm
    assert sorted(t.dim() for t in state) == [4, 5, 5, 5, 5, 6]
    smallest = min(t.numel() * t.element_size() for t in state)
    steady = [h for h in s.session.history if h.mode == "replaying"][1:]
    assert steady and all(h.network_bytes < smallest for h in steady)


def _stateless_pair(cfg_j, cfg, params_j, prompt, new):
    j_local = JLocalServing(cfg_j, seed=3).generate({"tokens": prompt}, new)
    j_served = JRRTOServedLM(cfg_j, bucket_len=32, batch=1, seed=3, min_repeats=3,
                             stateful=False)
    j_tokens = j_served.generate(prompt, new)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    served = RRTOServedLM(cfg, bucket_len=32, params=params, device="cpu", stateful=False)
    library.reset_launches()
    tokens = served.generate(prompt, new)
    only = RRTOServedLM(cfg, system="device_only", bucket_len=32, params=params,
                        device="cpu", stateful=False).generate(prompt, new)
    return j_local, j_served, j_tokens, served, tokens, only


@pytest.mark.parametrize("arch", ["dense", "zamba2"])
def test_legacy_stateless_mode_matches(arch):
    """The seed prefix-recompute formulation (``next_token`` over a fixed
    bucket): tokens equal the JAX package's LocalServing and served tokens
    and the port's device-only run; modes and replay RPCs are the
    reference's; nothing is carried.  The CPU op runs no kernel launch."""
    prompt = np.random.default_rng(0).integers(0, 256, (1, 8)).astype(np.int32)
    if arch == "dense":
        cfg_j, cfg = JArchConfig(**FIELDS), ArchConfig(**FIELDS)
        params_j = jlm.init_params(jax.random.PRNGKey(3), cfg_j)
    else:
        cfg_j = j_reduced("zamba2-1.2b", **HYBRID)
        cfg = get_reduced_config("zamba2-1.2b", **HYBRID)
        params_j = jhybrid.init_params(jax.random.PRNGKey(3), cfg_j)
    j_local, j_served, j_tokens, served, tokens, only = _stateless_pair(
        cfg_j, cfg, params_j, prompt, 6
    )
    np.testing.assert_array_equal(tokens.tokens, j_local.tokens)
    np.testing.assert_array_equal(tokens.tokens, j_tokens.tokens)
    np.testing.assert_array_equal(tokens.tokens, only.tokens)
    ours, ref = served.session.history, j_served.session.history
    assert [h.mode for h in ours] == [h.mode for h in ref]
    assert [h.rpcs for h in ours if h.mode == "replaying"] == [
        h.rpcs for h in ref if h.mode == "replaying"
    ]
    assert served.session.client.mode == "replaying"
    assert not served.session.client.stateful_replay
    assert not served.session.client.ios.carried_pairs
    assert sum(library.LAUNCHES.values()) == 0
