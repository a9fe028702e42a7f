"""The guards of ``benchmarks/chaos_serving.py`` and
``benchmarks/fleet_scaling.py``, pinned on the port at the benchmarks'
``--smoke`` sizes, with the same scenarios, constants and seeds.

Chaos: a stateless client through a declared outage (falls back to the
device and heals), a stateful decode on a lossy link (at-most-once retries),
a replica crash mid-decode (checkpoint restore on a peer), and an injector
that injects nothing.  Fleet: hedged dispatch against a straight fleet with
one spiky replica, and a stateful decode migrated between replicas.  Each
guard is one test case, named as the benchmark names it."""
from __future__ import annotations

import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.netsim import FaultInjector  # noqa: E402
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.serving import EdgeFleet, FleetClient, RRTOEdgeServer, RRTOServedLM  # noqa: E402

# benchmarks/chaos_serving.py
LOSS_PROB = 0.08
LOSS_SEED = 22
OUTAGE_S = 0.005
TAIL_BUDGET = 60.0       # p99_fault <= TAIL_BUDGET * p99_clean + 1 s absolute
CHAOS_REQUESTS, CHAOS_NEW = 24, 8           # --smoke
# benchmarks/fleet_scaling.py
SPIKE_S, SPIKE_EVERY = 0.5, 10
FLEET_SIZES = dict(n_replicas=3, n_clients=3, rounds=15)   # --smoke
MIGRATION_NEW = 4                           # --smoke

DECODE_CFG = ArchConfig(
    name="chaos-decode", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32", rope_theta=1e4,
)
PROMPT = np.array([[3, 7, 11, 13]], np.int32)


def make_app(seed=0, d_in=32, d_hidden=64, d_out=8, name="chaos-app"):
    rng = np.random.default_rng(seed)
    params = {
        "w1": torch.from_numpy(rng.normal(0, 0.1, (d_in, d_hidden)).astype(np.float32)),
        "w2": torch.from_numpy(rng.normal(0, 0.1, (d_hidden, d_out)).astype(np.float32)),
    }

    def apply(p, x):
        return [torch.tanh(x @ p["w1"]) @ p["w2"]]

    x = torch.from_numpy(rng.normal(0, 1, (1, d_in)).astype(np.float32))
    return OffloadableModel(f"{name}{seed}", apply, params, (x,)), x


def _p99_ms(lat):
    return float(np.percentile(np.asarray(lat), 99) * 1e3)


def _bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# chaos_serving
# ---------------------------------------------------------------------------
def outage_fallback(n_requests):
    model, x = make_app(0)

    def drive(fault):
        sess = OffloadSession(model, "rrto", seed=0, min_repeats=2, fault=fault, device="cpu")
        outs, lats, modes, ts = [], [], [], []
        for _ in range(n_requests):
            r = sess.infer(x)
            outs.append(r.outputs[0])
            lats.append(r.wall_seconds)
            modes.append(r.mode)
            ts.append(sess.clock.t)
        return sess, outs, lats, modes, ts

    _, clean_outs, clean_lat, clean_modes, clean_ts = drive(None)
    # the window opens mid replay phase, between two request boundaries of
    # the (identically timed) fault-free run
    k = min(clean_modes.index("replaying") + 3, n_requests - 8)
    t0 = (clean_ts[k - 1] + clean_ts[k]) / 2.0
    sess, outs, lat, modes, _ = drive(FaultInjector(seed=11, outages=((t0, t0 + OUTAGE_S),)))
    return {
        "outage_bitwise_equal": _bitwise(outs, clean_outs),
        "outage_fell_back_and_healed": (
            sess.client.stats.outage_fallbacks >= 1
            and "outage_fallback" in modes and modes[-1] == "replaying"
        ),
        "outage_bounded_tail": _p99_ms(lat) <= TAIL_BUDGET * _p99_ms(clean_lat) + 1e3,
    }


def lossy_decode(max_new):
    def stream(fault):
        edge = RRTOEdgeServer(fault=fault, device="cpu")
        lm = RRTOServedLM(DECODE_CFG, edge=edge, client_id="u0", seed=0, min_repeats=2)
        g = lm.start_generation(PROMPT, max_new_tokens=max_new)
        lats = []
        for _ in range(lm.steps_total(g)):
            res = lm.session.infer(*lm.step_inputs(g))
            lm.absorb_step(g, res.outputs)
            lats.append(res.wall_seconds)
        return lm, np.concatenate(g["out"], axis=1), lats

    _, clean_toks, clean_lat = stream(None)
    lm, toks, lat = stream(FaultInjector(seed=LOSS_SEED, rpc_loss_prob=LOSS_PROB))
    st = lm.session.client.stats
    return {
        "loss_bitwise_equal": bool(np.array_equal(toks, clean_toks)),
        # >= 1 stateful step lost its *response* and the retry was answered
        # from the dedup table; client and server counts agree
        "loss_retried_at_most_once": (
            st.retries >= 1 and st.dedup_replies >= 1
            and lm.session.server.dedup_hits == st.dedup_replies
        ),
        "loss_bounded_tail": _p99_ms(lat) <= TAIL_BUDGET * _p99_ms(clean_lat) + 1e3,
    }


def crash_recovery(max_new):
    def stream(fault, ckpt_dir):
        fleet = EdgeFleet(2, hedging=False, min_observations=4, fault=fault,
                          checkpoint_dir=ckpt_dir, checkpoint_every=3, device="cpu")
        lm = RRTOServedLM(DECODE_CFG, edge=fleet.replicas[0].edge, client_id="u0", seed=0,
                          min_repeats=2)
        fc = fleet.clients["u0"] = FleetClient(fleet, lm.session.model, "u0", lm.session, "r0",
                                               stateful=True)
        fleet.checkpointer.attach(lm.session.client)
        g = lm.start_generation(PROMPT, max_new_tokens=max_new)
        ts = []
        for _ in range(lm.steps_total(g)):
            res, _, _ = fc.dispatch(*lm.step_inputs(g))
            lm.absorb_step(g, res.outputs)
            ts.append(fleet.clock.t)
        state = fleet.locate("u0").edge.server.export_carried_state("u0")
        return fleet, np.concatenate(g["out"], axis=1), state, ts

    with tempfile.TemporaryDirectory() as d0, tempfile.TemporaryDirectory() as d1:
        _, clean_toks, clean_state, clean_ts = stream(None, d0)
        k = len(clean_ts) - 3
        t_crash = (clean_ts[k - 1] + clean_ts[k]) / 2.0
        fleet, toks, state, _ = stream(FaultInjector(seed=5, crashes={"r0": t_crash}), d1)
    return {
        "crash_bitwise_equal": bool(np.array_equal(toks, clean_toks))
        and clean_state is not None and _bitwise(state or [], clean_state),
        "crash_restored_from_checkpoint": (
            fleet.stats.crashes == 1 and fleet.stats.crash_restores == 1
            and fleet.stats.checkpoints >= 1 and fleet.stats.steps_replayed >= 1
            and fleet.clients["u0"].primary == "r1"
        ),
    }


def noop_injector(n_requests=12):
    model, x = make_app(1)

    def drive(fault):
        sess = OffloadSession(model, "rrto", seed=0, min_repeats=2, fault=fault, device="cpu")
        return sess, [sess.infer(x).outputs[0] for _ in range(n_requests)]

    s_none, outs_none = drive(None)
    s_noop, outs_noop = drive(FaultInjector(seed=99))
    return {"noop_injector_identical": (
        _bitwise(outs_none, outs_noop) and s_none.clock.t == s_noop.clock.t
        and s_none.client.stats.retries == 0 and s_noop.client.stats.retries == 0
    )}


CHAOS_GUARDS = [
    "outage_bitwise_equal", "outage_fell_back_and_healed", "outage_bounded_tail",
    "loss_bitwise_equal", "loss_retried_at_most_once", "loss_bounded_tail",
    "crash_bitwise_equal", "crash_restored_from_checkpoint", "noop_injector_identical",
]


@pytest.fixture(scope="module")
def chaos():
    checks = {}
    checks.update(outage_fallback(CHAOS_REQUESTS))
    checks.update(lossy_decode(CHAOS_NEW))
    checks.update(crash_recovery(CHAOS_NEW))
    checks.update(noop_injector())
    assert sorted(checks) == sorted(CHAOS_GUARDS)
    return checks


@pytest.mark.parametrize("guard", CHAOS_GUARDS)
def test_chaos_guard(chaos, guard):
    assert chaos[guard], f"{guard} tripped: {chaos}"


# ---------------------------------------------------------------------------
# fleet_scaling
# ---------------------------------------------------------------------------
def run_fleet(*, hedging, n_replicas, n_clients, rounds, min_repeats=3):
    fleet = EdgeFleet(n_replicas, hedging=hedging, min_observations=8, device="cpu")
    clients = []
    for i in range(n_clients):
        model, x = make_app(i, name="app")
        clients.append((fleet.connect(model, client_id=f"u{i}", min_repeats=min_repeats), x))
    # warm every client past the search into replay, and the router past its
    # deadline-estimation minimum (unmeasured)
    for _ in range(min_repeats + 8):
        for c, x in clients:
            c.infer(x)
    assert all(c.session.client.mode == "replaying" for c, _ in clients)
    n_warm = len(fleet.router.stats.latencies)
    fleet.replicas[0].slowdown = lambda i: SPIKE_S if i % SPIKE_EVERY == 0 else 0.0
    for _ in range(rounds):
        for c, x in clients:
            c.infer(x)
    lat = np.asarray(fleet.router.stats.latencies[n_warm:])
    backups = [s for c, _ in clients for name, s in c.sessions.items() if name != c.primary]
    return dict(
        hedged=fleet.router.stats.hedged,
        backup_sessions=fleet.stats.backup_sessions,
        backups_adopted=sum(1 for s in backups if s.client.cache_adopted),
        mean_ms=float(lat.mean() * 1e3),
        p99_ms=float(np.percentile(lat, 99) * 1e3),
    )


def migration_equivalence(max_new):
    def stream(migrate_at):
        fleet = EdgeFleet(2, min_observations=4, device="cpu")
        lm = RRTOServedLM(DECODE_CFG, edge=fleet.replicas[0].edge, client_id="u0", seed=0,
                          min_repeats=2)
        g = lm.start_generation(PROMPT, max_new_tokens=max_new)
        for step in range(lm.steps_total(g)):
            if step == migrate_at:
                fleet.migrate("u0", "r1")
            lm.absorb_step(g, lm.session.infer(*lm.step_inputs(g)).outputs)
        state = fleet.locate("u0").edge.server.export_carried_state("u0")
        return np.concatenate(g["out"], axis=1), state, fleet

    base_toks, base_state, _ = stream(None)
    toks, state, fleet = stream(PROMPT.shape[1] + max_new // 2)   # deep in stateful replay
    return (fleet.stats.migrations == 1 and bool(np.array_equal(toks, base_toks))
            and base_state is not None and _bitwise(state or [], base_state))


FLEET_GUARDS = [
    "hedged_p99_le_0.7x", "hedged_mean_le_1.1x", "hedges_fired",
    "backup_adopted_from_replicated_cache", "migration_bitwise_equal",
]


@pytest.fixture(scope="module")
def fleet_checks():
    hedged = run_fleet(hedging=True, **FLEET_SIZES)
    plain = run_fleet(hedging=False, **FLEET_SIZES)
    return {
        "hedged_p99_le_0.7x": hedged["p99_ms"] <= 0.7 * plain["p99_ms"],
        "hedged_mean_le_1.1x": hedged["mean_ms"] <= 1.1 * plain["mean_ms"],
        "hedges_fired": hedged["hedged"] > 0 and plain["hedged"] == 0,
        "backup_adopted_from_replicated_cache": (
            hedged["backup_sessions"] > 0
            and hedged["backups_adopted"] == hedged["backup_sessions"]
        ),
        "migration_bitwise_equal": migration_equivalence(MIGRATION_NEW),
        "points": (hedged, plain),
    }


@pytest.mark.parametrize("guard", FLEET_GUARDS)
def test_fleet_guard(fleet_checks, guard):
    assert fleet_checks[guard], f"{guard} tripped: {fleet_checks}"
