"""The MoE family served end to end on the CPU: the port's ``RRTOServedLM``,
stateful and stateless, against the JAX package's on the same (converted)
weights, at the reduced mixtral-8x7b (4 experts, top-2) with a 30-token
prompt and 6 new tokens in a bucket of 64, so its sliding window of 32 is
active in both apps.  Tokens, the mode sequence and the replay-phase RPC
counts equal the reference's; ``device_only`` and ``LocalServing`` give the
same tokens; the stateful app's KV cache is carried, pair for pair as in the
reference, and stays off the wire (3 RPCs per steady token)."""
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

NAME = "mixtral-8x7b"
PROMPT = 30
NEW = 6
BUCKET = 64


@pytest.fixture(scope="module", params=[True, False], ids=["stateful", "stateless"])
def runs(request):
    stateful = request.param
    cfg_j, cfg = j_reduced(NAME), get_reduced_config(NAME)
    assert cfg.window == 32 < PROMPT + NEW <= BUCKET
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (1, PROMPT)).astype(np.int32)
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
    out = dict(stateful=stateful, prompt=prompt, j_served=j_served, j_tokens=j_tokens,
               served=served, tokens=tokens)
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
    """Stateful: the KV cache's k and v are carried pairs, as many as the
    reference's, and each steady token takes 3 RPCs and sends fewer bytes
    than the smallest carried leaf.  Stateless: nothing is carried."""
    s = runs["served"]["rrto"]
    pairs = s.session.client.ios.carried_pairs
    if not runs["stateful"]:
        assert not pairs and not runs["j_served"].session.client.ios.carried_pairs
        return
    assert len(pairs) == len(runs["j_served"].session.client.ios.carried_pairs)
    assert len(pairs) == len(s._cache_leaves) == 2
    assert s.session.server.context().replay.program.is_stateful
    state = s.session.server.context().replay.carried_state
    smallest = min(t.numel() * t.element_size() for t in state)
    steady = [h for h in s.session.history if h.mode == "replaying"][1:]
    assert steady and all(h.rpcs == 3 and h.network_bytes < smallest for h in steady)
