"""The MLA (minicpm3-4b) and xLSTM (xlstm-1.3b) families served end to end
on the CPU: the port's ``RRTOServedLM``, stateful and stateless, against the
JAX package's on the same (converted) weights, at the reduced configs
(minicpm3-4b's default reduction; xlstm-1.3b with ``n_layers=5,
slstm_every=2``, so its sLSTM blocks run).  Tokens, the mode sequence and the
replay-phase RPC counts equal the reference's; the stateful app's cache is
detected as carried, pair for pair as in the reference, and stays off the
wire (3 RPCs per steady token).  An xLSTM's cache is its recurrent state
with no position axis, so a stateful generation is not bounded by the
bucket."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.models.registry import get_model as j_get_model  # noqa: E402
from repro.serving.engine import LocalServing as JLocalServing  # noqa: E402
from repro.serving.engine import RRTOServedLM as JRRTOServedLM  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import LocalServing, RRTOServedLM  # noqa: E402

FAMILIES = {"minicpm3-4b": {}, "xlstm-1.3b": dict(n_layers=5, slstm_every=2)}
NEW = 6
BUCKET = 32


@pytest.fixture(scope="module", params=[(name, stateful) for name in FAMILIES
                                        for stateful in (True, False)],
                ids=lambda p: f"{p[0]}-{'stateful' if p[1] else 'stateless'}")
def runs(request):
    name, stateful = request.param
    cfg_j = j_reduced(name, **FAMILIES[name])
    cfg = get_reduced_config(name, **FAMILIES[name])
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (1, 8)).astype(np.int32)
    params_j = j_get_model(cfg_j).init_params(jax.random.PRNGKey(3), cfg_j)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    j_served = JRRTOServedLM(cfg_j, bucket_len=BUCKET, batch=1, seed=3, min_repeats=3,
                             stateful=stateful)
    j_tokens = j_served.generate(prompt, NEW)
    served = {
        system: RRTOServedLM(cfg, system=system, bucket_len=BUCKET, params=params,
                             device="cpu", stateful=stateful)
        for system in ("rrto", "device_only")
    }
    tokens = {system: s.generate(prompt, NEW) for system, s in served.items()}
    out = dict(name=name, stateful=stateful, cfg=cfg, prompt=prompt, j_served=j_served,
               j_tokens=j_tokens, served=served, tokens=tokens)
    if stateful:
        out["j_local"] = JLocalServing(cfg_j, seed=3).generate({"tokens": prompt}, NEW)
        out["local"] = LocalServing(cfg, params=params, device="cpu").generate(
            {"tokens": prompt}, NEW)
    return out


def test_tokens_match_jax(runs):
    r = runs
    np.testing.assert_array_equal(r["tokens"]["rrto"].tokens, r["j_tokens"].tokens)
    np.testing.assert_array_equal(r["tokens"]["device_only"].tokens, r["tokens"]["rrto"].tokens)
    if r["stateful"]:
        np.testing.assert_array_equal(r["local"].tokens, r["j_local"].tokens)
        np.testing.assert_array_equal(r["tokens"]["rrto"].tokens, r["j_local"].tokens)


def test_modes_and_replay_rpcs_match_jax(runs):
    ours = runs["served"]["rrto"].session.history
    ref = runs["j_served"].session.history
    assert [h.mode for h in ours] == [h.mode for h in ref]
    assert [h.rpcs for h in ours if h.mode == "replaying"] == [
        h.rpcs for h in ref if h.mode == "replaying"
    ]
    assert runs["served"]["rrto"].session.client.mode == "replaying"


def test_state_is_carried_off_the_wire(runs):
    """Stateful: every cache leaf is a carried pair (the latent cache's
    c_kv and k_rope; the mLSTM state and the sLSTM's h, c, n, m), the same
    pairs as the reference's, and each steady token takes 3 RPCs and sends
    fewer bytes than the smallest carried leaf.  Stateless: nothing is
    carried."""
    s = runs["served"]["rrto"]
    pairs = s.session.client.ios.carried_pairs
    if not runs["stateful"]:
        assert not pairs and not runs["j_served"].session.client.ios.carried_pairs
        return
    assert len(pairs) == len(runs["j_served"].session.client.ios.carried_pairs)
    assert len(pairs) == len(s._cache_leaves) == (2 if runs["name"] == "minicpm3-4b" else 6)
    assert s.session.server.context().replay.program.is_stateful
    state = s.session.server.context().replay.carried_state
    smallest = min(t.numel() * t.element_size() for t in state)
    steady = [h for h in s.session.history if h.mode == "replaying"][1:]
    assert steady and all(h.rpcs == 3 and h.network_bytes < smallest for h in steady)


def test_bucket_bounds_only_a_per_position_cache(runs):
    """A stateful xLSTM generation runs past the bucket (its state has no
    position axis); the latent KV cache and every stateless buffer raise."""
    s = runs["served"]["rrto"]
    if runs["stateful"] and runs["name"] == "xlstm-1.3b":
        g = s.start_generation(runs["prompt"], BUCKET)
        assert s.steps_total(g) == 8 + BUCKET - 1
    else:
        with pytest.raises(ValueError, match="overflow"):
            s.generate(runs["prompt"], BUCKET)
