"""Fleet-scale replicated serving in the port (tests/test_fleet.py): hedged
dispatch, cache replication and carried-state migration, with the fault
layer that hardens them (stateful dispatch failures, crash recovery).

The load-bearing property comes first: a stateful decode migrated between
replicas mid-stream is bitwise (tokens AND carried state) the same stream
never migrating, for the dense test config and a reduced xLSTM, at random
migration points.  Against the JAX package, on the same numpy parameters:
the migrated and crashed streams' tokens equal the reference
``RRTOServedLM``'s clean tokens; with the crash placed by step index the
fleet counts (``checkpoints``, ``steps_replayed``, ``crash_restores``) equal
the reference's; and ``HedgedRouter`` picks the reference's winners.  A crash
must lose what it loses: the restored state shares no storage with the
crashed box."""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.core.netsim import FaultInjector as JFaultInjector  # noqa: E402
from repro.distributed import straggler as jstraggler  # noqa: E402
from repro.models.registry import get_model as j_get_model  # noqa: E402
from repro.serving import EdgeFleet as JEdgeFleet  # noqa: E402
from repro.serving import FleetClient as JFleetClient  # noqa: E402
from repro.serving import RRTOServedLM as JRRTOServedLM  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.netsim import FaultInjector, multi_node_ingress  # noqa: E402
from repro_torch.core.offload import OffloadableModel  # noqa: E402
from repro_torch.distributed import straggler  # noqa: E402
from repro_torch.distributed.straggler import (  # noqa: E402
    OBSERVATION_WINDOW,
    AllReplicasFailedError,
    HedgedRouter,
    NoHealthyReplicaError,
    ReplicaModel,
)
from repro_torch.serving import EdgeFleet, FleetClient, ReplayCache, RRTOServedLM  # noqa: E402

DENSE_FIELDS = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
                    rope_theta=1e4)
# a second family: sLSTM/mLSTM blocks, a recurrent carried state (no KV ring)
XLSTM_FIELDS = dict(name="x", family="ssm", n_layers=2, d_model=32, n_heads=2,
                    n_kv_heads=2, d_head=16, d_ff=0, vocab=128, dtype="float32",
                    ssm_chunk=16, slstm_every=2, slstm_ff=48)
FAMILIES = {"dense": DENSE_FIELDS, "ssm": XLSTM_FIELDS}
PROMPT = np.array([[3, 7, 11, 13]], np.int32)
MAX_NEW = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_mlp(seed=0, d_in=16, d_hidden=32, d_out=8):
    rng = np.random.default_rng(seed)
    params = {
        "w1": _t(rng.normal(size=(d_in, d_hidden)).astype(np.float32)),
        "w2": _t(rng.normal(size=(d_hidden, d_out)).astype(np.float32)),
    }

    def apply(p, x):
        return [torch.tanh(x @ p["w1"]) @ p["w2"]]

    x = _t(rng.normal(size=(1, d_in)).astype(np.float32))
    return OffloadableModel(f"mlp{seed}", apply, params, (x,)), x


def fleet(n=2, **kw):
    return EdgeFleet(n, device="cpu", **kw)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """One family's configs and parameters in both packages (the JAX
    package's, converted), and the reference's clean tokens."""
    fields = FAMILIES[request.param]
    cfg_j, cfg = JArchConfig(**fields), ArchConfig(**fields)
    params_j = j_get_model(cfg_j).init_params(jax.random.PRNGKey(0), cfg_j)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    j_lm = JRRTOServedLM(cfg_j, params=params_j, min_repeats=2)
    j_tokens = j_lm.generate(PROMPT, MAX_NEW).tokens
    return dict(name=request.param, cfg=cfg, cfg_j=cfg_j, params=params, params_j=params_j,
                j_tokens=np.asarray(j_tokens))


@pytest.fixture(scope="module")
def dense():
    cfg_j, cfg = JArchConfig(**DENSE_FIELDS), ArchConfig(**DENSE_FIELDS)
    params_j = j_get_model(cfg_j).init_params(jax.random.PRNGKey(0), cfg_j)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    return dict(cfg=cfg, cfg_j=cfg_j, params=params, params_j=params_j)


def lm_on(fl, cfg, params, replica=0):
    return RRTOServedLM(cfg, edge=fl.replicas[replica].edge, client_id="u0", params=params,
                        min_repeats=2)


def decode_stream(cfg, params, migrate_at=None, max_new=MAX_NEW):
    """One stateful decode on a 2-replica fleet, migrated r0 -> r1 before
    step ``migrate_at`` if given; returns (tokens, final carried state, fleet)."""
    fl = fleet(min_observations=4)
    lm = lm_on(fl, cfg, params)
    g = lm.start_generation(PROMPT, max_new_tokens=max_new)
    for step in range(lm.steps_total(g)):
        if migrate_at is not None and step == migrate_at:
            assert fl.migrate("u0", "r1") == "r1"
        lm.absorb_step(g, lm.session.infer(*lm.step_inputs(g)).outputs)
    tokens = np.concatenate(g["out"], axis=1)
    return tokens, fl.locate("u0").edge.server.export_carried_state("u0"), fl


def _equal(a, b):
    return a is not None and b is not None and len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip(a, b))


class TestMigrationEquivalence:
    """Property: mid-stream migration is invisible to the decode."""

    def test_migrated_stream_bitwise_identical(self, family, rng):
        cfg, params = family["cfg"], family["params"]
        base_tokens, base_state, _ = decode_stream(cfg, params)
        assert base_state is not None, "stream never turned stateful"
        np.testing.assert_array_equal(base_tokens, family["j_tokens"])
        n_steps = PROMPT.shape[1] + MAX_NEW - 1
        # random points over the recording phase, the lock and deep replay
        points = sorted(set(rng.integers(0, n_steps, size=3).tolist()) | {n_steps - 1})
        for at in points:
            tokens, state, fl = decode_stream(cfg, params, migrate_at=at)
            np.testing.assert_array_equal(tokens, family["j_tokens"], err_msg=f"step {at}")
            assert _equal(state, base_state), f"carried state @ step {at}"
            assert fl.stats.migrations == 1
            assert fl.locate("u0").name == "r1"
            assert fl.replicas[1].edge.sessions_adopted == 1
            assert fl.replicas[0].edge.sessions_migrated_out == 1

    def test_migration_transfers_env_over_backhaul(self, dense):
        _, _, fl = decode_stream(dense["cfg"], dense["params"], migrate_at=6)
        assert fl.stats.migration_bytes > 0
        assert fl.backhaul.bytes_total >= fl.stats.migration_bytes
        # the source box no longer holds the client's device memory
        assert "u0" not in fl.replicas[0].edge.server.contexts

    def test_migration_to_self_is_noop(self):
        fl = fleet()
        model, x = make_mlp()
        c = fl.connect(model, client_id="u0", min_repeats=2)
        c.infer(x)
        assert fl.migrate("u0", "r0") == "r0"
        assert fl.stats.migrations == 0


class TestFaultInjection:
    def _warm_fleet(self, n=2, min_observations=4, **kw):
        fl = fleet(n, min_observations=min_observations, **kw)
        model, x = make_mlp()
        client = fl.connect(model, client_id="u0", min_repeats=3)
        for _ in range(6):   # past min_repeats AND min_observations
            client.infer(x)
        assert client.session.client.mode == "replaying"
        return fl, client, x

    def test_failed_replica_recovered_by_hedge(self):
        fl, client, x = self._warm_fleet()
        fl.replica("r0").failed = True
        assert client.infer(x) is not None
        assert fl.router.stats.failures_recovered == 1
        assert client.primary == "r1", "re-homed off the dead box"
        fl.replica("r0").failed = False
        client.infer(x)
        assert client.primary == "r1", "no flap back after recovery"

    def test_all_replicas_failed_is_typed(self):
        fl, client, x = self._warm_fleet()
        for rep in fl.replicas:
            rep.failed = True
        with pytest.raises(AllReplicasFailedError):
            client.infer(x)
        assert issubclass(AllReplicasFailedError, NoHealthyReplicaError)
        assert issubclass(AllReplicasFailedError, RuntimeError)
        with pytest.raises(NoHealthyReplicaError):
            fl.connect(make_mlp(seed=1)[0], client_id="u1")

    def test_cold_replica_adopts_replicated_fingerprint(self):
        """A hedge landing on a cold replica adopts the fingerprint that
        cache replication brought there after one recorded inference."""
        fl, client, x = self._warm_fleet()
        fl.replica("r0").slowdown = lambda i: 10.0   # force the hedge
        res, _, winner = client.dispatch(x)
        assert winner == "r1"
        backup = client.sessions["r1"]
        assert backup.client.cache_adopted is True
        assert backup.client.mode == "replaying"
        assert [h.mode for h in backup.history] == ["recording"]
        m = client.model
        with torch.no_grad():
            want = m.apply(m.params, x)[0]
        assert torch.equal(res.outputs[0], want)

    def test_stateful_sessions_never_fork(self, dense):
        """A slow stateful primary is not hedged (the step is not
        idempotent); an outright failure moves the session by migration."""
        fl = fleet(min_observations=2)
        lm = lm_on(fl, dense["cfg"], dense["params"])
        client = fl.clients["u0"] = FleetClient(fl, lm.session.model, "u0", lm.session, "r0",
                                                stateful=True)
        g = lm.start_generation(PROMPT, max_new_tokens=6)
        for _ in range(4):   # lock replay, warm the deadline estimator
            client.infer(*lm.step_inputs(g))
            lm.absorb_step(g, client.session.history[-1].outputs)
        assert lm.session.client.stateful_replay
        fl.replica("r0").slowdown = lambda i: 100.0
        _, _, winner = client.dispatch(*lm.step_inputs(g))
        assert winner == "r0", "a slow stateful primary must not be hedged"
        assert len(client.sessions) == 1
        fl.replica("r0").failed = True
        _, _, winner = client.dispatch(*lm.step_inputs(g))
        assert winner == "r1"
        assert fl.stats.migrations == 1
        assert len(client.sessions) == 1
        assert fl.router.stats.failures_recovered == 1


class TestHedgedRouterFailureWalk:
    """When the primary AND the first hedge pick both fail, the router walks
    every remaining healthy replica before raising."""

    def _router(self, fail_names, n=4):
        replicas = [ReplicaModel(name, 0.01, lambda i: 0.0) for name in "abcd"[:n]]
        calls = []

        def complete(rep, idx):
            calls.append(rep.name)
            return None if rep.name in fail_names else 0.01

        return HedgedRouter(replicas, completion_source=complete), calls

    def test_third_replica_serves_after_double_failure(self):
        router, calls = self._router(fail_names={"a", "b"})
        t, winner = router.dispatch(0, primary=0)
        assert winner == "c" and t > 0
        assert calls == ["a", "b", "c"], "walk in order, no extra duplicates"
        assert router.stats.failures_recovered == 1
        assert router.stats.hedged == 1

    def test_walk_reaches_the_last_healthy_replica(self):
        router, calls = self._router(fail_names={"a", "b", "c"})
        assert router.dispatch(0, primary=0)[1] == "d"
        assert calls == ["a", "b", "c", "d"]

    def test_exhausted_walk_raises_typed_error(self):
        router, calls = self._router(fail_names={"a", "b", "c", "d"})
        with pytest.raises(AllReplicasFailedError):
            router.dispatch(0, primary=0)
        assert sorted(calls) == ["a", "b", "c", "d"], "every box was tried"

    def test_success_path_pays_no_extra_dispatches(self):
        router, calls = self._router(fail_names=set())
        assert router.dispatch(0, primary=0)[1] == "a"
        assert calls == ["a"], "healthy primary: no hedge, no walk"


class TestHedgedRouterAgainstReference:
    """Winners, hedges and recoveries equal the reference router's on the
    same replica latencies."""

    @staticmethod
    def _jitter(k, spike_every, spike):
        return lambda i: (spike if i % spike_every == k else 0.0) + 0.001 * ((i * 7 + k) % 5)

    @pytest.mark.parametrize("fail_at", [None, 300])
    def test_same_winners_and_counters(self, fail_at):
        specs = [("a", 0.010, 0, 10, 0.5), ("b", 0.012, 3, 7, 0.2), ("c", 0.011, 1, 13, 0.9)]

        def build(pkg):
            reps = [pkg.ReplicaModel(n, base, self._jitter(k, every, spike))
                    for n, base, k, every, spike in specs]
            return reps, pkg.HedgedRouter(reps, hedge_multiplier=2.0, min_observations=8,
                                          window=64)

        (ours_r, ours), (ref_r, ref) = build(straggler), build(jstraggler)
        got, want = [], []
        for i in range(1000):
            if i == fail_at:
                ours_r[1].failed = ref_r[1].failed = True
            primary = i % 3 if i % 4 else None
            got.append(ours.dispatch(i, primary=primary))
            want.append(ref.dispatch(i, primary=primary))
        assert got == want
        for key in ("requests", "hedged", "primary_wins", "hedge_wins", "failures_recovered"):
            assert getattr(ours.stats, key) == getattr(ref.stats, key), key
        assert ours.stats.hedged > 0
        assert ours.stats.latencies == ref.stats.latencies


class TestStatefulDispatchFailures:
    """Typed dispatch errors mid-stream leave the carried state uncorrupted."""

    def _stream(self, fl, dense, max_new=MAX_NEW):
        lm = lm_on(fl, dense["cfg"], dense["params"])
        client = fl.clients["u0"] = FleetClient(fl, lm.session.model, "u0", lm.session, "r0",
                                                stateful=True)
        return lm, client, lm.start_generation(PROMPT, max_new_tokens=max_new)

    def test_all_replicas_failed_mid_stream_then_stream_resumes_bitwise(self, dense):
        fl0 = fleet(min_observations=4)
        lm0, c0, g0 = self._stream(fl0, dense)
        for _ in range(lm0.steps_total(g0)):
            c0.infer(*lm0.step_inputs(g0))
            lm0.absorb_step(g0, c0.session.history[-1].outputs)
        want_tokens = np.concatenate(g0["out"], axis=1)
        want_state = fl0.locate("u0").edge.server.export_carried_state("u0")

        fl = fleet(min_observations=4)
        lm, client, g = self._stream(fl, dense)
        n_steps = lm.steps_total(g)
        for step in range(n_steps):
            if step == n_steps - 3:
                for rep in fl.replicas:
                    rep.failed = True
                seq_before = client.session.client.step_seq
                with pytest.raises(AllReplicasFailedError):
                    client.dispatch(*lm.step_inputs(g))
                with pytest.raises(NoHealthyReplicaError):
                    client.dispatch(*lm.step_inputs(g))
                # the failed attempts never reached a server
                assert client.session.client.step_seq == seq_before
                assert client.primary == "r0"
                for rep in fl.replicas:
                    rep.failed = False
            client.infer(*lm.step_inputs(g))
            lm.absorb_step(g, client.session.history[-1].outputs)
        np.testing.assert_array_equal(np.concatenate(g["out"], axis=1), want_tokens)
        assert _equal(fl.locate("u0").edge.server.export_carried_state("u0"), want_state)
        assert fl.stats.migrations == 0, "no spurious moves on failure"

    def test_failed_primary_migrates_not_forks_under_walk(self, dense):
        fl = fleet(3, min_observations=4)
        lm, client, g = self._stream(fl, dense)
        for _ in range(4):
            client.infer(*lm.step_inputs(g))
            lm.absorb_step(g, client.session.history[-1].outputs)
        assert lm.session.client.stateful_replay
        fl.replica("r0").failed = True
        _, _, winner = client.dispatch(*lm.step_inputs(g))
        assert winner in ("r1", "r2") and client.primary == winner
        assert len(client.sessions) == 1, "single home: migrated, not forked"
        assert fl.stats.migrations == 1


def _crash_stream(pkg_fleet, pkg_lm, pkg_client, cfg, params, fault, ckpt_dir, *, port,
                  on_crash=None):
    """A stateful decode behind a FleetClient with checkpoints every 3
    steps; returns (fleet, lm, tokens, final state, clock after each step)."""
    kw = dict(device="cpu") if port else {}
    fl = pkg_fleet(2, hedging=False, min_observations=4, fault=fault,
                   checkpoint_dir=str(ckpt_dir), checkpoint_every=3, **kw)
    lm = pkg_lm(cfg, edge=fl.replicas[0].edge, client_id="u0", params=params, min_repeats=2)
    fc = fl.clients["u0"] = pkg_client(fl, lm.session.model, "u0", lm.session, "r0",
                                       stateful=True)
    fl.checkpointer.attach(lm.session.client)
    g = lm.start_generation(PROMPT, max_new_tokens=MAX_NEW)
    ts = []
    for _ in range(lm.steps_total(g)):
        if on_crash is not None and fl.fault is not None and not fl.stats.crashes:
            due = [n for n, t in fl.fault.crashes.items() if t <= fl.clock.t]
            if due:
                on_crash(fl)
        res, _, _ = fc.dispatch(*lm.step_inputs(g))
        lm.absorb_step(g, res.outputs)
        ts.append(fl.clock.t)
    tokens = np.concatenate(g["out"], axis=1)
    return fl, lm, tokens, fl.locate("u0").edge.server.export_carried_state("u0"), ts


class TestCrashRecovery:
    """A crashed replica lost its memory: the session restores on a peer
    from the last checkpoint and replays the logged steps."""

    def test_mid_decode_crash_restores_bitwise(self, dense, tmp_path):
        port = dict(port=True)
        _, _, want_tokens, want_state, ts = _crash_stream(
            EdgeFleet, RRTOServedLM, FleetClient, dense["cfg"], dense["params"], None,
            tmp_path / "clean", **port)
        _, _, _, _, j_ts = _crash_stream(
            JEdgeFleet, JRRTOServedLM, JFleetClient, dense["cfg_j"], dense["params_j"], None,
            tmp_path / "jclean", port=False)
        # the crash lands between two step boundaries, by step index: late
        # enough that a checkpoint exists and >= 1 logged step postdates it
        k = len(ts) - 3
        crashed = {}

        def keep_crashed_tensors(fl):
            ctx = fl.replica("r0").edge.server.contexts["u0"]
            crashed["tensors"] = [*ctx.env.values(), *ctx.replay.carried_state]

        fl, lm, tokens, state, _ = _crash_stream(
            EdgeFleet, RRTOServedLM, FleetClient, dense["cfg"], dense["params"],
            FaultInjector(seed=5, crashes={"r0": 0.5 * (ts[k - 1] + ts[k])}),
            tmp_path / "faulted", on_crash=keep_crashed_tensors, **port)
        jfl, _, j_tokens, _, _ = _crash_stream(
            JEdgeFleet, JRRTOServedLM, JFleetClient, dense["cfg_j"], dense["params_j"],
            JFaultInjector(seed=5, crashes={"r0": 0.5 * (j_ts[k - 1] + j_ts[k])}),
            tmp_path / "jfaulted", port=False)
        assert fl.stats.crashes == 1 and fl.stats.crash_restores == 1
        assert fl.stats.checkpoints >= 1 and fl.stats.steps_replayed >= 1
        for key in ("crashes", "crash_restores", "checkpoints", "steps_replayed"):
            assert getattr(fl.stats, key) == getattr(jfl.stats, key), key
        assert lm.session.client.stats.crash_restores == 1
        assert fl.clients["u0"].primary == "r1" and fl.is_crashed("r0")
        np.testing.assert_array_equal(tokens, want_tokens)
        np.testing.assert_array_equal(tokens, np.asarray(j_tokens))
        assert _equal(state, want_state)
        assert fl.stats.checkpoint_bytes > 0
        assert fl.backhaul.bytes_total >= fl.stats.checkpoint_bytes
        # nothing of the crashed box survives into the restored session
        dead = {t.untyped_storage().data_ptr() for t in crashed["tensors"]}
        ctx = fl.replica("r1").edge.server.contexts["u0"]
        restored = [*ctx.env.values(), *ctx.replay.carried_state]
        assert restored and all(t.untyped_storage().data_ptr() not in dead for t in restored)

    def test_recover_without_checkpoint_is_typed(self, tmp_path):
        fl = fleet(min_observations=4, checkpoint_dir=str(tmp_path))
        model, x = make_mlp()
        fl.connect(model, client_id="u0", min_repeats=2)
        with pytest.raises(RuntimeError, match="checkpoint"):
            fl.recover("u0")


class TestHedgedRouterWindow:
    def test_observation_window_bounded_over_10k_dispatches(self):
        replicas = [ReplicaModel("a", 0.010, lambda i: 0.0), ReplicaModel("b", 0.012, lambda i: 0.0)]
        router = HedgedRouter(replicas, window=64)
        for i in range(10_000):
            router.dispatch(i)
        assert router.stats.requests == 10_000
        assert router.observed_count == 64
        default = HedgedRouter(replicas)
        for i in range(OBSERVATION_WINDOW + 50):
            default.dispatch(i)
        assert default.observed_count == OBSERVATION_WINDOW

    def test_deadline_tracks_recent_distribution(self):
        shift = 3_000
        router = HedgedRouter([ReplicaModel("a", 0.0, lambda i: 0.01 if i < shift else 0.1)],
                              window=64)
        for i in range(shift + 200):
            router.dispatch(i)
        assert router._deadline() == pytest.approx(2.0 * 0.1)

    def test_window_validation(self):
        with pytest.raises(ValueError):
            HedgedRouter([ReplicaModel("a", 0.01, lambda i: 0.0)], window=0)


class _FakeProgram:
    """Stands in for a built ReplayProgram in cache-persistence tests."""

    def __init__(self, nbytes=100, carried_pairs=None, plan_sig=None):
        self.nbytes_estimate = nbytes
        self.n_kernels = 3
        self.total_flops = 1.0e6
        self.total_bytes = 2048.0
        self.d2h_avals = [((1, 8), "float32")]
        if carried_pairs is not None:
            self.carried_pairs = carried_pairs
        if plan_sig is not None:
            class _Plan:
                @staticmethod
                def signature():
                    return plan_sig
            self.plan = _Plan()


class TestCacheReplication:
    """ReplayCache.save/load as the fleet's replication primitive."""

    def test_roundtrip_preserves_carried_pairs_and_plan_keys(self, tmp_path):
        src = ReplayCache(capacity=8)
        src.put("fpA", _FakeProgram(carried_pairs=[(2, 0), (3, 1)]))
        src.put("fpA|cut=3", _FakeProgram(carried_pairs=[(2, 0)], plan_sig="cut=3"))
        src.put("fpA#vmap4", _FakeProgram())   # derived batched program
        path = os.path.join(tmp_path, "cache.json")
        assert src.save(path) == 2             # '#' keys never persist
        dst = ReplayCache(capacity=8)
        assert dst.load(path) == 2
        assert "fpA" in dst and "fpA|cut=3" in dst and "fpA#vmap4" not in dst
        assert len(dst) == 2
        assert dst.known_metadata("fpA")["carried_pairs"] == [[2, 0], [3, 1]]
        assert dst.known_metadata("fpA|cut=3")["plan"] == "cut=3"
        assert dst.get("fpA") is None
        assert dst.stats.misses == 1
        assert dst.save(os.path.join(tmp_path, "cache2.json")) == 2

    def test_loaded_cache_honors_claims_under_eviction(self, tmp_path):
        src = ReplayCache(capacity=8)
        src.put("fpA", _FakeProgram(carried_pairs=[(0, 0)]))
        path = os.path.join(tmp_path, "cache.json")
        src.save(path)
        dst = ReplayCache(capacity=1)
        dst.load(path)
        dst.put("fpA", _FakeProgram(carried_pairs=[(0, 0)]))
        dst.claim("fpA|cut=3")
        dst.claim("fpA|cut=3")                  # claims nest
        dst.put("fpB", _FakeProgram())
        assert "fpA" in dst.fingerprints and "fpB" not in dst.fingerprints
        dst.release("fpA|cut=3")
        dst.put("fpB", _FakeProgram())
        assert "fpA" in dst.fingerprints, "still one claim outstanding"
        dst.release("fpA|cut=3")
        dst.put("fpB", _FakeProgram())
        assert dst.fingerprints == ["fpB"]
        assert "fpA" in dst

    def test_fleet_replicates_fingerprints_everywhere(self):
        fl = fleet(3, min_observations=4)
        model, x = make_mlp()
        client = fl.connect(model, client_id="u0", min_repeats=2)
        for _ in range(3):
            client.infer(x)
        fp = client.session.client.ios_fp
        assert fp is not None
        for rep in fl.replicas:
            assert fp in rep.edge.cache
        assert fl.stats.replicated_fingerprints >= 1 and fl.stats.cache_syncs >= 1


class TestFleetPlumbing:
    def test_multi_node_ingress_shares_backhaul(self):
        pipes = multi_node_ingress(3, node_capacity_bytes_per_s=100.0, backhaul_bytes_per_s=240.0)
        assert len(pipes) == 3 and all(p.backhaul is pipes[0].backhaul for p in pipes)
        # the per-node NIC would give 100, but the site uplink caps at 240/3
        assert pipes[0].share() == pytest.approx(80.0)
        pipes[0].account(50.0)
        pipes[1].account(25.0)
        assert (pipes[0].bytes_total, pipes[1].bytes_total) == (50.0, 25.0)
        assert pipes[0].backhaul.bytes_total == 75.0
        with pytest.raises(ValueError):
            multi_node_ingress(0)

    def test_affinity_placement(self):
        fl = fleet()
        m0, _ = make_mlp(0)
        c0 = fl.connect(m0, client_id="a")
        c1 = fl.connect(m0, client_id="b")     # the same model co-locates
        assert c0.primary == c1.primary and fl.stats.affinity_hits == 1
        c2 = fl.connect(make_mlp(1)[0], client_id="c")
        assert c2.primary != c0.primary

    def test_serve_open_loop_on_timeline(self):
        fl = fleet(min_observations=4)
        model, x = make_mlp()
        client = fl.connect(model, client_id="u0", min_repeats=2)
        for _ in range(3):
            client.infer(x)
        results = fl.serve([(0.001 * (k + 1), "u0", (x,)) for k in range(5)])
        assert len(results) == 5
        assert fl.timeline.fired == 10         # an arrival and a completion each
        for r in results:
            assert r.latency_seconds > 0 and r.winner in ("r0", "r1")
            assert r.done_at == pytest.approx(r.arrival_t + r.latency_seconds)
        assert fl.summary()["router"]["requests"] == 8

    def test_fleet_needs_a_card_unless_asked_for_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            EdgeFleet(2)
