"""Overload protection in the port (tests/test_admission.py): SLO classes,
token-bucket admission, the three-tier degradation ladder, DRR batch-slot
fairness, the per-replica circuit breaker, and the disabled-bitwise-identity
pin (``admission=None`` and an inert controller both leave the stack
byte-identical).

Against the JAX package: a seeded stream of controller calls gives the
reference's decisions, retry-afters, queue depths, shares and counters;
``drr_select`` makes its picks and leaves its deficits; ``CircuitBreaker``
walks its states; and a reduced zamba2 served stateless under a
zero-capacity controller returns the reference's ``degraded_device``
tokens."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_reduced_config as j_reduced  # noqa: E402
from repro.core.netsim import ServerIngress as JServerIngress  # noqa: E402
from repro.core.netsim import client_stream_seed as j_client_stream_seed  # noqa: E402
from repro.core.netsim import poisson_arrivals as j_poisson_arrivals  # noqa: E402
from repro.distributed.straggler import HedgedRouter as JHedgedRouter  # noqa: E402
from repro.distributed.straggler import ReplicaModel as JReplicaModel  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.serving import admission as jadm  # noqa: E402
from repro.serving.engine import RRTOServedLM as JRRTOServedLM  # noqa: E402
from repro.serving.fleet import CircuitBreaker as JCircuitBreaker  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.netsim import ServerIngress, client_stream_seed, poisson_arrivals  # noqa: E402
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.distributed.straggler import HedgedRouter, ReplicaModel  # noqa: E402
from repro_torch.models.cnn_zoo import make_sensor_encoder  # noqa: E402
from repro_torch.partition import AdaptiveReplanner, PartitionConfig, SegmentGraph  # noqa: E402
from repro_torch.serving import EdgeFleet, RRTOEdgeServer, RRTOServedLM  # noqa: E402
from repro_torch.serving.admission import (  # noqa: E402
    BRONZE,
    GOLD,
    SILVER,
    AdmissionController,
    AdmissionRejectedError,
    SLOClass,
    TokenBucket,
    drr_select,
)
from repro_torch.serving.fleet import CircuitBreaker  # noqa: E402

MBPS = 1e6 / 8


def make_mlp(seed=0, d_in=16, d_hidden=32, d_out=8):
    rng = np.random.default_rng(seed)
    params = {
        "w1": torch.from_numpy(rng.normal(0, 0.1, (d_in, d_hidden)).astype(np.float32)),
        "w2": torch.from_numpy(rng.normal(0, 0.1, (d_hidden, d_out)).astype(np.float32)),
    }

    def apply(p, x):
        return [torch.tanh(x @ p["w1"]) @ p["w2"]]

    x = torch.from_numpy(rng.normal(0, 1, (2, d_in)).astype(np.float32))
    return OffloadableModel(f"mlp{seed}", apply, params, (x,)), x


def zero_capacity_controller(**kwargs) -> AdmissionController:
    """A controller that denies every request: near-zero refill, no burst.
    What happens next is the degradation ladder's choice, not admission's."""
    kwargs.setdefault("rate_hz", 1e-6)
    kwargs.setdefault("burst", 0.0)
    return AdmissionController(**kwargs)


def inert_controller() -> AdmissionController:
    return AdmissionController(rate_hz=1e12, queue_limit=10**9, burst=1e12,
                               default_class=SLOClass(deadline_s=1e9))


def attach(edge: RRTOEdgeServer, adm: AdmissionController) -> None:
    """Attach a controller to an already-warm edge (the benchmark idiom:
    recording never competes with the measured load for tokens)."""
    adm.bind(server=edge.server, ingress=edge.ingress)
    edge.admission = adm
    edge.batcher.admission = adm
    for cid, sess in edge.sessions.items():
        adm.register(cid, sess.tenant)
        sess.admission = adm


def warm(edge: RRTOEdgeServer, x, spins=4):
    for cid, sess in edge.sessions.items():
        for _ in range(spins):
            if sess.client.mode == "replaying":
                break
            edge.run_round({cid: (x,)})
        assert sess.client.mode == "replaying", cid


class TestTokenBucket:
    def test_refill_is_pure_function_of_time(self):
        tb = TokenBucket(rate_hz=10.0, burst=2.0)
        tb.consume(0.0)
        tb.consume(0.0)
        assert not tb.available(0.0)
        assert not tb.available(0.05)       # only half a token back
        assert tb.available(0.1)            # one full token refilled
        tb.consume(0.1)
        assert not tb.available(0.1)

    def test_burst_caps_the_level(self):
        tb = TokenBucket(rate_hz=100.0, burst=3.0)
        assert tb.available(1e9, n=3.0)
        assert not tb.available(1e9, n=3.5)

    def test_rejects_nonpositive_rate(self):
        with pytest.raises(ValueError):
            TokenBucket(rate_hz=0.0, burst=1.0)


class TestAdmissionController:
    def test_admits_under_capacity(self):
        adm = AdmissionController(rate_hz=100.0, queue_limit=8)
        adm.register("c0", "default")
        d = adm.decide("c0", 0.0)
        assert d.action == "admit"
        assert adm.stats.admitted == 1 and adm.stats.requests == 1

    def test_queue_full_sheds_with_retry_after(self):
        adm = AdmissionController(rate_hz=100.0, queue_limit=2)
        adm.register("c0", "default")
        for _ in range(2):                   # two admitted, never completing
            adm.decide("c0", 0.0)
            adm.note_admitted(0.0, done_at=1e9)
        d = adm.decide("c0", 0.0)
        assert d.action == "shed" and d.reason == "queue full"
        assert d.retry_after_s > 0
        assert adm.stats.queue_rejects == 1
        err = adm.shed_error("c0", d)
        assert isinstance(err, AdmissionRejectedError)
        assert err.retry_after_s == d.retry_after_s and err.queue_depth == 2

    def test_queue_drains_lazily(self):
        adm = AdmissionController(rate_hz=100.0, queue_limit=2)
        adm.register("c0", "default")
        adm.decide("c0", 0.0)
        adm.note_admitted(0.0, done_at=0.5)
        assert adm.queue_depth(0.0) == 1
        assert adm.queue_depth(0.6) == 0     # completion passed

    def test_retry_after_includes_server_backlog(self):
        adm = AdmissionController(rate_hz=10.0, queue_limit=1)
        adm.bind(server=SimpleNamespace(busy_until=5.0))
        assert adm.retry_after(t=1.0, depth=3) >= 4.0

    def test_tenant_share_vs_global_capacity(self):
        """With the global bucket drained, a tenant with its own tokens is
        still denied ('capacity exhausted'); with its own bucket dry and the
        queue too deep to borrow, the reason is the tenant share."""
        classes = {"a": SLOClass("a", weight=1.0), "b": SLOClass("b", weight=1.0)}
        adm = AdmissionController(rate_hz=1e-6, burst=2.0, queue_limit=4, borrow_depth=0,
                                  classes=classes)
        adm.register("ca", "a")
        adm.register("cb", "b")
        # tenant buckets hold >= 1 token each (burst*share floor), the
        # global bucket holds 2: both first requests admit
        assert adm.decide("ca", 0.0).action == "admit"
        assert adm.decide("cb", 0.0).action == "admit"
        # global bucket empty, tenant a's bucket empty too -> tenant share;
        # keep the queue deep so the borrow path stays closed
        adm.note_admitted(0.0, done_at=1e9)
        da = adm.decide("ca", 0.0)
        assert da.action == "shed" and da.reason == "tenant share exhausted"
        assert adm.stats.bucket_rejects >= 1

    def test_work_conserving_borrow(self):
        """A tenant whose own bucket ran dry borrows global spare capacity
        while the queue is shallow: light load admits everything."""
        classes = {"a": SLOClass("a", weight=1.0), "b": SLOClass("b", weight=1.0)}
        adm = AdmissionController(rate_hz=1e-6, burst=4.0, queue_limit=8, borrow_depth=4,
                                  classes=classes)
        adm.register("ca", "a")
        for _ in range(3):                   # > tenant a's ~2-token share
            assert adm.decide("ca", 0.0).action == "admit"
        assert adm.stats.borrowed >= 1

    def test_deadline_scoring(self):
        adm = AdmissionController(rate_hz=100.0)
        adm.note_completion(arrival_t=0.0, done_t=0.1, deadline_t=0.2)
        adm.note_completion(arrival_t=0.0, done_t=0.3, deadline_t=0.2)
        adm.note_completion(arrival_t=0.0, done_t=9.9, deadline_t=None)
        assert adm.stats.deadline_hits == 1
        assert adm.stats.deadline_misses == 1

    def test_admitted_shares_and_weights(self):
        classes = {"a": SLOClass("a", weight=3.0), "b": SLOClass("b", weight=1.0)}
        adm = AdmissionController(rate_hz=1000.0, classes=classes)
        adm.register("ca", "a")
        adm.register("cb", "b")
        for _ in range(3):
            adm.decide("ca", 0.0)
        adm.decide("cb", 0.0)
        assert adm.admitted_shares() == {"a": 0.75, "b": 0.25}
        assert adm.weight_share("a") == 0.75

    def test_register_new_slo_rebuilds_buckets(self):
        adm = AdmissionController(rate_hz=100.0)
        adm.register("c0", "a", slo=SLOClass("a", weight=1.0))
        first = adm._tenant_bucket("a")
        adm.register("c1", "a", slo=SLOClass("a", weight=2.0))
        assert adm._tenant_bucket("a") is not first

    def test_bind_mirrors_the_queue_onto_the_ingress(self):
        ingress = ServerIngress()
        assert ingress.queue_depth == 0
        adm = AdmissionController(rate_hz=100.0, queue_limit=2)
        adm.bind(ingress=ingress)
        assert adm.ingress is ingress
        adm.register("c0")
        for _ in range(2):
            adm.decide("c0", 0.0)
            adm.note_admitted(0.0, done_at=1.0)
        assert ingress.queue_depth == 2
        adm.queue_depth(1.5)
        assert ingress.queue_depth == 0


class TestDegradationLadder:
    """Every rung of the ladder, end to end through ``OffloadSession.infer``,
    with the property the ladder promises: a response served under overload
    is bitwise the idle server's response."""

    def _twin_edges(self, partition=None):
        outs, edges = {}, {}
        for name in ("idle", "loaded"):
            model, x = make_mlp()
            edge = RRTOEdgeServer(execute=True, name=name, device="cpu")
            kwargs = {"min_repeats": 2}
            if partition is not None:
                kwargs["partition"] = partition
            edge.connect(model, client_id="c0", **kwargs)
            warm(edge, x, spins=5)
            outs[name] = edge.run_round({"c0": (x,)})["c0"].outputs[0]
            edges[name] = (edge, x)
        assert torch.equal(outs["idle"], outs["loaded"])
        return edges

    def test_tier2_device_fallback_bitwise(self):
        """A denied stateless session with deadline headroom degrades to the
        eager device path; outputs stay bitwise the offloaded replay's."""
        edges = self._twin_edges()
        idle_edge, x = edges["idle"]
        loaded_edge, _ = edges["loaded"]
        attach(loaded_edge, zero_capacity_controller(default_class=SLOClass(deadline_s=1e9)))
        want = idle_edge.run_round({"c0": (x,)})["c0"]
        got = loaded_edge.sessions["c0"].infer(x)
        assert got.mode == "degraded_device"
        assert torch.equal(got.outputs[0], want.outputs[0])
        assert loaded_edge.admission.stats.degraded_device == 1
        # server never touched: the fallback runs on the client device
        assert got.server_busy_seconds == 0.0

    def test_tier3_shed_when_deadline_cannot_cover_fallback(self):
        """A denied request whose budget cannot even cover the device
        fallback is shed with a typed, actionable rejection."""
        edges = self._twin_edges()
        loaded_edge, x = edges["loaded"]
        attach(loaded_edge, zero_capacity_controller(
            default_class=SLOClass("gold", deadline_s=1e-12)))
        sess = loaded_edge.sessions["c0"]
        with pytest.raises(AdmissionRejectedError) as ei:
            sess.infer(x)
        assert ei.value.retry_after_s > 0
        assert ei.value.client_id == "c0"
        assert loaded_edge.admission.stats.shed == 1
        # the shed is not sticky: detaching the controller restores service
        sess.admission = None
        idle_edge, _ = edges["idle"]
        want = idle_edge.run_round({"c0": (x,)})["c0"]
        got = sess.infer(x)
        assert torch.equal(got.outputs[0], want.outputs[0])

    def test_tier1_split_session_degrades_plan(self):
        """A denied *split* session degrades its cut device-heavy instead of
        shedding; outputs stay bitwise the idle twin's."""
        edges = self._twin_edges(partition=PartitionConfig())
        idle_edge, x = edges["idle"]
        loaded_edge, _ = edges["loaded"]
        sess = loaded_edge.sessions["c0"]
        assert sess.client.replanner is not None
        attach(loaded_edge, zero_capacity_controller(
            default_class=SLOClass(deadline_s=1e-12)))   # tier 2 unaffordable
        want = idle_edge.run_round({"c0": (x,)})["c0"]
        got = sess.infer(x)
        assert got.mode == "degraded_split"
        assert torch.equal(got.outputs[0], want.outputs[0])
        assert loaded_edge.admission.stats.degraded_split == 1
        # the degraded plan pushes every movable segment device-side
        assert sess.client.replanner.current.plan.n_device_ops >= 0

    def test_stateful_session_is_shed_never_degraded(self):
        """A stateful replay cannot take tier 2 (its state lives on the
        server): even an unbounded budget sheds it, and the shed runs no
        step."""
        lm = RRTOServedLM(get_reduced_config("qwen3-0.6b"), bucket_len=12, seed=1,
                          min_repeats=2, edge=RRTOEdgeServer(device="cpu"), client_id="u0")
        g = lm.start_generation(np.arange(4, dtype=np.int32)[None], 5)
        for _ in range(6):
            lm.absorb_step(g, lm.session.infer(*lm.step_inputs(g)).outputs)
        sess = lm.session
        assert sess.client.stateful_replay
        adm = zero_capacity_controller(default_class=SLOClass(deadline_s=1e9))
        sess.admission = adm
        adm.register("u0")
        seq = sess.client.step_seq
        with pytest.raises(AdmissionRejectedError):
            sess.infer(*lm.step_inputs(g))
        assert adm.stats.shed == 1 and adm.stats.degraded_device == 0
        assert sess.client.step_seq == seq


class TestReplannerDegrade:
    @pytest.fixture(scope="class")
    def sweep_graph(self):
        """benchmarks/partition_sweep.py's workload, recorded in an
        account-only session of the port."""
        model = make_sensor_encoder(scale=1.0, input_size=96, device="cpu")
        sess = OffloadSession(model, "rrto", environment="indoor", execute=False, device="cpu")
        sess.load()
        for _ in range(5):
            sess.infer(*model.example_inputs)
        assert sess.client.ios is not None
        return SegmentGraph(sess.client._ios_calls), sess.client_device, sess.server_device, model

    def test_degrade_moves_work_device_side_and_recovers(self, sweep_graph):
        graph, device, server, model = sweep_graph
        rp = AdaptiveReplanner(
            graph, device, server, config=PartitionConfig(min_replan_interval_s=0.0),
            input_wire_divisor=model.input_wire_divisor,
        )
        rich = rp.initial_plan(128 * MBPS, now=0.0)
        assert not rich.is_full_device
        degraded = rp.degrade(now=1.0)
        assert degraded is not None
        assert degraded.n_device_ops > rich.n_device_ops
        assert rp.stats.overload_degrades == 1
        # unlike declare_outage, the EMA still reflects the healthy link...
        assert rp.ema_bandwidth == 128 * MBPS
        # ...so the next real sample re-plans straight back to offloading
        restored = rp.observe(128 * MBPS, now=2.0)
        assert restored is not None
        assert restored.n_device_ops < degraded.n_device_ops
        # degrading onto the plan already installed is a no-op
        rp.degrade(now=3.0)
        assert rp.degrade(now=3.0) is None
        assert rp.stats.overload_degrades == 2


class TestDRRSelect:
    def test_capacity_covers_all_passthrough(self):
        members = ["a1", "b1", "a2"]
        got = drr_select(members, 3, lambda m: m[0], lambda t: 1.0, {})
        assert got == members

    def test_weighted_split(self):
        members = [f"a{i}" for i in range(4)] + [f"b{i}" for i in range(4)]
        got = drr_select(members, 3, lambda m: m[0], lambda t: {"a": 2.0, "b": 1.0}[t], {})
        assert sum(1 for m in got if m[0] == "a") == 2
        assert sum(1 for m in got if m[0] == "b") == 1
        # EDF order within a tenant is preserved
        assert [m for m in got if m[0] == "a"] == ["a0", "a1"]

    def test_deficit_alternates_equal_weights(self):
        """Capacity 1, equal weights: the carried deficit alternates the
        winner across rounds, so no fixed visiting order starves tenant b."""
        deficits = {}
        winners = []
        for _ in range(4):
            got = drr_select(["a0", "b0"], 1, lambda m: m[0], lambda t: 1.0, deficits)
            winners.append(got[0][0])
        assert winners == ["a", "b", "a", "b"]

    def test_emptied_queue_forfeits_deficit(self):
        deficits = {}
        drr_select(["a0", "b0", "b1"], 2, lambda m: m[0], lambda t: 1.0, deficits)
        assert deficits["a"] == 0.0          # a emptied: credit forfeited


class TestCircuitBreaker:
    def test_opens_after_consecutive_failures(self):
        br = CircuitBreaker(failure_threshold=2, cooldown_s=1.0)
        br.record(0.0, failed=True)
        assert br.state == CircuitBreaker.CLOSED
        br.record(0.1, failed=True)
        assert br.state == CircuitBreaker.OPEN and br.opens == 1
        assert not br.allow(0.5)

    def test_success_resets_the_count(self):
        br = CircuitBreaker(failure_threshold=2)
        br.record(0.0, failed=True)
        br.record(0.1, failed=False)
        br.record(0.2, failed=True)
        assert br.state == CircuitBreaker.CLOSED

    def test_halfopen_probe_decides(self):
        br = CircuitBreaker(failure_threshold=1, cooldown_s=1.0)
        br.record(0.0, failed=True)
        assert not br.allow(0.5)
        assert br.allow(1.1)                 # cooldown elapsed: probe admitted
        assert br.state == CircuitBreaker.HALF_OPEN
        br.record(1.2, failed=True)          # bad probe: straight back open
        assert br.state == CircuitBreaker.OPEN and br.opens == 2
        assert br.allow(2.3)
        br.record(2.4, failed=False)         # good probe closes
        assert br.state == CircuitBreaker.CLOSED and br.consecutive_bad == 0

    def test_latency_outlier_counts_as_bad(self):
        br = CircuitBreaker(failure_threshold=1, latency_multiplier=4.0)
        br.record(0.0, failed=False, latency_s=0.5, baseline_s=0.1)
        assert br.state == CircuitBreaker.OPEN
        # no baseline yet -> latency can't be judged -> good
        br2 = CircuitBreaker(failure_threshold=1)
        br2.record(0.0, failed=False, latency_s=9.0, baseline_s=None)
        assert br2.state == CircuitBreaker.CLOSED


class TestRouterHealth:
    def _replicas(self, n=3, cls=ReplicaModel):
        return [cls(f"r{i}", 0.01, jitter=lambda _: 0.0) for i in range(n)]

    def test_health_none_is_prebreaker_behaviour(self):
        a = HedgedRouter(self._replicas(), min_observations=1)
        b = HedgedRouter(self._replicas(), min_observations=1, health=None)
        picks_a = [a._pick(exclude=-1) for _ in range(6)]
        picks_b = [b._pick(exclude=-1) for _ in range(6)]
        assert picks_a == picks_b

    def test_routes_around_unhealthy_replica(self):
        router = HedgedRouter(self._replicas(), min_observations=1, health=lambda i: i != 1)
        picks = [router._pick(exclude=-1) for _ in range(6)]
        assert 1 not in picks
        assert set(picks) == {0, 2}

    def test_all_unhealthy_is_soft_not_fatal(self):
        """Saturation everywhere must not escalate to NoHealthyReplicaError:
        the second pass ignores the health signal."""
        router = HedgedRouter(self._replicas(), min_observations=1, health=lambda i: False)
        assert router._pick(exclude=-1) in (0, 1, 2)

    def test_observed_median(self):
        router = HedgedRouter(self._replicas(), min_observations=1)
        assert router.observed_median is None
        router._observed.extend([0.1, 0.3, 0.2])
        assert router.observed_median == 0.2

    def test_failure_walk_tries_healthy_replicas_first(self):
        """A failed primary and a failed first backup: the walk goes to a
        healthy replica before an unhealthy one, as the reference's does."""
        def run(router_cls, replica_cls):
            reps = self._replicas(4, replica_cls)
            reps[1].failed = True
            healthy = {0: True, 1: True, 2: False, 3: True}
            router = router_cls(reps, min_observations=1, health=lambda i: healthy[i])
            calls = []

            def complete(rep, idx):
                calls.append(rep.name)
                return None if rep.name in ("r0", "r3") and len(calls) < 3 else 0.01

            return router.dispatch(0, primary=0, completion=complete), calls

        assert run(HedgedRouter, ReplicaModel) == run(JHedgedRouter, JReplicaModel)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_picks_equal_the_reference(self, seed):
        rng = np.random.default_rng(seed)
        sick = rng.random((24, 4)) < 0.5
        step = {"k": 0}

        def health(i):
            return not sick[step["k"], i]

        ours = HedgedRouter(self._replicas(4), min_observations=1, health=health)
        ref = JHedgedRouter(self._replicas(4, JReplicaModel), min_observations=1, health=health)
        for k in range(24):
            step["k"] = k
            ex = int(rng.integers(-1, 4))
            assert ours._pick(exclude=ex) == ref._pick(exclude=ex)


class TestDisabledBitwiseIdentity:
    """The FaultInjector discipline: no controller, and an inert controller,
    must both leave outputs, simulated time and energy byte-identical."""

    def _drive(self, adm_factory):
        model, x = make_mlp()
        edge = RRTOEdgeServer(execute=True, device="cpu")
        for i in range(3):
            edge.connect(model, client_id=f"c{i}", min_repeats=2)
        if adm_factory is not None:
            attach(edge, adm_factory())
        outs, joules = [], []
        for _ in range(6):
            res = edge.run_round({f"c{i}": (x,) for i in range(3)})
            outs.append([res[f"c{i}"].outputs[0] for i in range(3)])
            joules.append([res[f"c{i}"].joules for i in range(3)])
        return edge, outs, joules

    def test_none_vs_inert_controller(self):
        edge_none, outs_none, joules_none = self._drive(None)
        edge_inert, outs_inert, joules_inert = self._drive(inert_controller)
        assert edge_none.clock.t == edge_inert.clock.t
        assert joules_none == joules_inert
        for round_a, round_b in zip(outs_none, outs_inert):
            for a, b in zip(round_a, round_b):
                assert torch.equal(a, b)
        # the inert controller really was on the hot path
        assert edge_inert.admission.stats.admitted > 0
        assert edge_inert.admission.stats.shed == 0
        assert edge_none.summary()["admission"] is None

    def test_queue_depth_gauges_observable(self):
        """The ingress wait-queue depth and the batcher's pending-round depth
        surface as registry gauges and in ``summary()`` once a controller is
        attached."""
        model, x = make_mlp()
        edge = RRTOEdgeServer(execute=True, device="cpu")
        edge.connect(model, client_id="c0", min_repeats=2)
        attach(edge, AdmissionController(rate_hz=1e6, metrics=edge.metrics))
        for _ in range(4):
            edge.run_round({"c0": (x,)})
        snap = edge.metrics.snapshot()
        assert "queue_depth" in snap and "batcher.pending_depth" in snap
        summary = edge.summary()
        assert summary["queue_depth"] == edge.ingress.queue_depth
        assert summary["pending_depth"] == edge.batcher.pending_depth
        assert summary["admission"]["admitted"] >= 4

    def test_constructor_binds_the_controller(self):
        """``RRTOEdgeServer(admission=)`` binds the controller to the box and
        ``connect(tenant=)`` hands it to the session with its tenant."""
        model, x = make_mlp()
        adm = AdmissionController(rate_hz=1e6, queue_limit=7,
                                  classes={"gold": GOLD, "silver": SILVER, "bronze": BRONZE})
        edge = RRTOEdgeServer(execute=True, admission=adm, device="cpu")
        assert adm.server is edge.server and adm.ingress is edge.ingress
        assert edge.batcher.admission is adm
        sess = edge.connect(model, client_id="c0", tenant="gold", min_repeats=2)
        assert sess.admission is adm and sess.client.tenant == "gold"
        assert adm.tenant_of("c0") == "gold"
        for _ in range(3):
            edge.run_round({"c0": (x,)})
        assert adm.admitted_by_tenant == {"gold": 3}
        assert sess.client.deadline_t is None   # cleared after each request

    def test_health_none_and_breaker_off_dispatch_bitwise(self):
        """``EdgeFleet(circuit_breaker=False)`` (its router's ``health`` None)
        serves bitwise what a fleet with healthy breakers serves: same
        winners, latencies, clock and outputs."""
        def drive(breaker):
            model, x = make_mlp()
            fleet = EdgeFleet(2, circuit_breaker=breaker, min_observations=2, device="cpu")
            c = fleet.connect(model, client_id="u0", min_repeats=2)
            out = [c.dispatch(x) for _ in range(6)]
            return fleet, out

        f_off, off = drive(False)
        f_on, on = drive(True)
        assert f_off.router.health is None and f_on.router.health is not None
        assert f_off.clock.t == f_on.clock.t
        assert [(lat, w) for _, lat, w in off] == [(lat, w) for _, lat, w in on]
        assert all(torch.equal(a.outputs[0], b.outputs[0]) for (a, _, _), (b, _, _) in zip(off, on))
        assert f_on.summary()["breakers"] == {"r0": dict(state="closed", opens=0),
                                              "r1": dict(state="closed", opens=0)}
        assert f_off.summary()["breakers"] is None


class TestDeadlineRoundFormation:
    def _member(self, deadline, tenant="default"):
        cl = SimpleNamespace(deadline_t=deadline, tenant=tenant)
        return (cl, [torch.zeros(1)])

    def test_edf_orders_by_deadline(self):
        edge = RRTOEdgeServer(execute=False, device="cpu")
        members = [self._member(3.0), self._member(1.0), self._member(2.0)]
        got = edge.batcher._order_members(list(members))
        assert [m[0].deadline_t for m in got] == [1.0, 2.0, 3.0]

    def test_priority_breaks_deadline_ties(self):
        edge = RRTOEdgeServer(execute=False, device="cpu")
        edge.batcher.admission = AdmissionController(classes={
            "gold": SLOClass("gold", priority=2), "bronze": SLOClass("bronze", priority=0),
        })
        members = [
            self._member(1.0, "bronze"),
            self._member(1.0, "gold"),
            self._member(None, "bronze"),    # no deadline sorts last
        ]
        got = edge.batcher._order_members(list(members))
        assert [m[0].tenant for m in got] == ["gold", "bronze", "bronze"]
        assert got[-1][0].deadline_t is None

    def test_passthrough_without_controller_or_deadlines(self):
        edge = RRTOEdgeServer(execute=False, device="cpu")
        members = [self._member(None), self._member(None)]
        got = edge.batcher._order_members(members)
        assert got is members                # the very same list, untouched

    def test_round_capacity_drops_to_solo_replay(self):
        """DRR-dropped members lose their preload and replay solo: every
        member still completes, bitwise the uncapped control."""
        def drive(capped):
            model, x = make_mlp()
            edge = RRTOEdgeServer(execute=True, device="cpu")
            for i in range(3):
                edge.connect(model, client_id=f"c{i}", min_repeats=2)
            warm(edge, x)
            if capped:
                attach(edge, inert_controller())
                edge.batcher.round_capacity = 2
            res = edge.run_round({f"c{i}": (x,) for i in range(3)})
            return edge, [res[f"c{i}"].outputs[0] for i in range(3)]

        edge_capped, outs_capped = drive(capped=True)
        _, outs_free = drive(capped=False)
        for a, b in zip(outs_capped, outs_free):
            assert torch.equal(a, b)
        assert edge_capped.batcher.solo_replays >= 1


class TestDeterministicArrivalStreams:
    def test_per_client_seed_is_stable_and_distinct(self):
        assert client_stream_seed(0, "c0") == client_stream_seed(0, "c0")
        assert client_stream_seed(0, "c0") != client_stream_seed(0, "c1")
        assert client_stream_seed(0, "c0") != client_stream_seed(1, "c0")

    def test_population_edits_do_not_perturb_streams(self):
        """One client's arrival schedule is a pure function of (seed,
        client_id), independent of the roster."""
        def schedule(cid):
            return poisson_arrivals(50.0, 8, seed=client_stream_seed(7, cid))

        alone = schedule("c3")
        with_roster = [schedule(c) for c in ("c0", "c1", "c2", "c3")][-1]
        assert alone == with_roster
        assert schedule("c2") != schedule("c3")

    def test_streams_equal_the_reference(self):
        for cid in ("c0", "c0007", "z3"):
            seed = client_stream_seed(1000, cid)
            assert seed == j_client_stream_seed(1000, cid)
            assert poisson_arrivals(37.5, 16, seed=seed) == j_poisson_arrivals(37.5, 16, seed=seed)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
TENANTS = {"gold": (GOLD, jadm.GOLD), "silver": (SILVER, jadm.SILVER),
           "bronze": (BRONZE, jadm.BRONZE)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controller_decisions_equal_the_reference(seed):
    """About 200 seeded ``decide`` / ``note_admitted`` / ``note_completion``
    calls through both packages' controllers (a server backlog and an
    ingress bound to each): equal actions, retry-afters, queue depths,
    shares and counters, call for call."""
    rng = np.random.default_rng(seed)
    kw = dict(queue_limit=int(rng.integers(2, 9)), rate_hz=float(rng.uniform(20, 200)),
              borrow_depth=int(rng.integers(0, 5)))
    ours = AdmissionController(**kw, classes={n: p for n, (p, _) in TENANTS.items()})
    ref = jadm.AdmissionController(**kw, classes={n: j for n, (_, j) in TENANTS.items()})
    server = SimpleNamespace(busy_until=0.0)
    ingresses = (ServerIngress(), JServerIngress())
    ours.bind(server=server, ingress=ingresses[0])
    ref.bind(server=server, ingress=ingresses[1])
    clients = {f"c{i}": name for i, name in enumerate(["gold", "silver", "bronze", "bronze",
                                                      "bronze", "silver"])}
    for cid, tenant in clients.items():
        ours.register(cid, tenant)
        ref.register(cid, tenant)
    t = 0.0
    for _ in range(200):
        t += float(rng.exponential(1.0 / (2.5 * kw["rate_hz"])))
        server.busy_until = max(server.busy_until, t) + float(rng.uniform(0, 0.004))
        cid = f"c{int(rng.integers(0, len(clients)))}"
        flags = dict(can_degrade_split=bool(rng.random() < 0.2),
                     can_degrade_device=bool(rng.random() < 0.6),
                     degraded_latency_s=float(rng.uniform(0.0, 0.3)))
        a, b = ours.decide(cid, t, **flags), ref.decide(cid, t, **flags)
        assert (a.action, a.retry_after_s, a.queue_depth, a.reason) == (
            b.action, b.retry_after_s, b.queue_depth, b.reason)
        done = t + float(rng.uniform(0.001, 0.05))
        if a.action == "admit":
            ours.note_admitted(t, done)
            ref.note_admitted(t, done)
        deadline = ours.deadline_for(cid, t)
        assert deadline == ref.deadline_for(cid, t)
        ours.note_completion(t, done, deadline)
        ref.note_completion(t, done, deadline)
        assert ours.queue_depth(t) == ref.queue_depth(t)
        assert ingresses[0].queue_depth == ingresses[1].queue_depth
    assert ours.stats.as_dict() == ref.stats.as_dict()
    assert ours.admitted_shares() == ref.admitted_shares()
    assert ours.admitted_by_tenant == ref.admitted_by_tenant
    assert {n: ours.weight_share(n) for n in TENANTS} == {n: ref.weight_share(n) for n in TENANTS}
    shed = [ours.stats.shed, ours.stats.degraded_device, ours.stats.degraded_split]
    assert ours.stats.admitted > 0 and sum(shed) > 0, ours.stats.as_dict()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drr_select_equals_the_reference(seed):
    """Seeded backlogs over rounds: equal picks, equal deficits carried."""
    rng = np.random.default_rng(seed)
    weights = {"gold": 4.0, "silver": 2.0, "bronze": 1.0, "free": 0.5}
    d_ours, d_ref = {}, {}
    for _ in range(12):
        n = int(rng.integers(1, 12))
        members = [(str(rng.choice(list(weights))), k) for k in range(n)]
        cap = int(rng.integers(1, n + 2))
        a = drr_select(members, cap, lambda m: m[0], weights.__getitem__, d_ours)
        b = jadm.drr_select(members, cap, lambda m: m[0], weights.__getitem__, d_ref)
        assert a == b
        assert d_ours == d_ref


@pytest.mark.parametrize("seed", [0, 1])
def test_circuit_breaker_states_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(failure_threshold=int(rng.integers(1, 4)), cooldown_s=0.05,
              latency_multiplier=3.0)
    ours, ref = CircuitBreaker(**kw), JCircuitBreaker(**kw)
    t = 0.0
    for _ in range(150):
        t += float(rng.uniform(0, 0.02))
        if rng.random() < 0.4:
            assert ours.allow(t) == ref.allow(t)
        else:
            rec = dict(failed=bool(rng.random() < 0.3), latency_s=float(rng.uniform(0, 0.5)),
                       baseline_s=None if rng.random() < 0.2 else 0.05)
            ours.record(t, **rec)
            ref.record(t, **rec)
        assert (ours.state, ours.opens, ours.consecutive_bad, ours.open_until) == (
            ref.state, ref.opens, ref.consecutive_bad, ref.open_until)
    assert ours.opens > 0


def test_degraded_device_tokens_equal_the_reference():
    """Reduced zamba2 served stateless (``next_token``, bucket 32): warmed
    into replay, then under a zero-capacity controller whose budget covers
    the device fallback.  Every later token comes back ``degraded_device``,
    in both packages, and the tokens equal the JAX package's."""
    hybrid = dict(n_layers=5, attn_every=2)
    cfg_j, cfg = j_reduced("zamba2-1.2b", **hybrid), get_reduced_config("zamba2-1.2b", **hybrid)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jhybrid.init_params(jax.random.PRNGKey(3), cfg_j)), cfg, "cpu")
    prompt = np.random.default_rng(0).integers(0, 256, (1, 8)).astype(np.int32)
    new, attach_at = 7, 4
    j_lm = JRRTOServedLM(cfg_j, bucket_len=32, batch=1, seed=3, min_repeats=3, stateful=False)
    lm = RRTOServedLM(cfg, bucket_len=32, params=params, device="cpu", stateful=False,
                      min_repeats=3)
    runs = []
    for sess, adm_mod, as_input in (
        (j_lm.session, jadm, lambda buf, cur: (buf.copy(), np.int32(cur))),
        (lm.session, None, lambda buf, cur: (torch.from_numpy(buf.copy()),
                                              torch.tensor(cur, dtype=torch.int32))),
    ):
        ctl = (adm_mod.AdmissionController if adm_mod is not None else AdmissionController)(
            rate_hz=1e-6, burst=0.0,
            default_class=(adm_mod.SLOClass if adm_mod is not None else SLOClass)(deadline_s=1e9))
        buf = np.zeros((1, 32), np.int32)
        buf[:, :8] = prompt
        toks, modes = [], []
        for k, cur in enumerate(range(8, 8 + new)):
            if k == attach_at:
                sess.admission = ctl
                ctl.register(sess.client_id, "default")
            res = sess.infer(*as_input(buf, cur))
            nxt = np.asarray(res.outputs[0])
            toks.append(int(nxt.reshape(-1)[0]))
            modes.append(res.mode)
            buf[:, cur] = nxt
        runs.append((toks, modes, ctl.stats.degraded_device))
    (j_toks, j_modes, j_deg), (toks, modes, deg) = runs
    assert toks == j_toks
    assert modes == j_modes
    assert modes[attach_at - 1] == "replaying"
    assert modes[attach_at:] == ["degraded_device"] * (new - attach_at)
    assert deg == j_deg == new - attach_at


# ---------------------------------------------------------------------------
# the fleet's options
# ---------------------------------------------------------------------------
def _warm_fleet(fleet, n=1):
    model, x = make_mlp()
    clients = [fleet.connect(model, client_id=f"u{i}", min_repeats=2) for i in range(n)]
    for _ in range(4):
        for c in clients:
            c.infer(x)
    return clients, x


def test_fleet_routes_around_an_open_breaker():
    """``EdgeFleet(circuit_breaker=True)``: a latency outlier on r0 opens
    its breaker, the next request starts on r1 (a backup session there),
    and after the cooldown a good probe closes it again.  Without breakers,
    or with a latency multiplier the outlier stays under, the same request
    stays on r0."""
    def run(breaker, multiplier=4.0):
        fleet = EdgeFleet(2, hedging=False, min_observations=1, circuit_breaker=breaker,
                          device="cpu")
        for br in (fleet.breakers or {}).values():
            br.failure_threshold, br.cooldown_s, br.latency_multiplier = 1, 0.5, multiplier
        (c,), x = _warm_fleet(fleet)
        assert c.primary == "r0"
        fleet.replicas[0].slowdown = lambda i: 10.0
        _, _, w0 = c.dispatch(x)
        fleet.replicas[0].slowdown = lambda i: 0.0
        _, _, w1 = c.dispatch(x)
        return fleet, c, w0, w1, x

    fleet, c, w0, w1, x = run(True)
    assert (w0, w1) == ("r0", "r1")
    assert fleet.summary()["breakers"]["r0"] == dict(state="open", opens=1)
    assert fleet.stats.backup_sessions == 1 and c.primary == "r0"
    fleet.clock.advance(1.0)
    _, _, w2 = c.dispatch(x)                 # the half-open probe on r0
    assert w2 == "r0" and fleet.breakers["r0"].state == CircuitBreaker.CLOSED
    _, _, _, w1_off, _ = run(False)
    assert w1_off == "r0"
    tolerant, _, _, w1_tolerant, _ = run(True, multiplier=1e9)
    assert w1_tolerant == "r0" and tolerant.breakers["r0"].opens == 0


def test_fleet_admission_factory_builds_one_controller_per_replica():
    """``EdgeFleet(admission_factory=)``: each replica gets its own
    controller, bound to its own server and ingress, and each client's
    session bills its replica's controller under its tenant."""
    names = []

    def factory(name):
        names.append(name)
        return AdmissionController(rate_hz=1e6, queue_limit=5 + len(names),
                                   classes={"gold": GOLD, "bronze": BRONZE})

    fleet = EdgeFleet(2, admission_factory=factory, device="cpu")
    assert names == ["r0", "r1"]
    ctls = [rep.edge.admission for rep in fleet.replicas]
    assert ctls[0] is not ctls[1]
    for rep, ctl in zip(fleet.replicas, ctls):
        assert ctl.server is rep.edge.server and ctl.ingress is rep.edge.ingress
    model, x = make_mlp()
    a = fleet.connect(model, client_id="ua", tenant="gold", min_repeats=2)
    other, _ = make_mlp(seed=1)
    b = fleet.connect(other, client_id="ub", tenant="bronze", min_repeats=2)
    assert a.primary != b.primary
    for _ in range(3):
        a.infer(x)
        b.infer(other.example_inputs[0])
    ca, cb = fleet.replica(a.primary).edge.admission, fleet.replica(b.primary).edge.admission
    assert ca.admitted_by_tenant == {"gold": 3} and cb.admitted_by_tenant == {"bronze": 3}
    per = fleet.summary()["per_replica"]
    assert per[a.primary]["admission"]["admitted"] == 3


def test_fleet_client_deadline_and_shed():
    """``FleetClient.infer(deadline_s=)`` reaches the replica's controller:
    a degraded request scores its own budget (miss, then hit), and a tenant
    whose budget cannot cover the fallback is shed through the fleet."""
    classes = {"bronze": SLOClass("bronze", deadline_s=1e9),
               "gold": SLOClass("gold", deadline_s=1e-12)}
    fleet = EdgeFleet(1, hedging=False, device="cpu",
                      admission_factory=lambda name: zero_capacity_controller(classes=classes))
    model, x = make_mlp()
    warm_ctl = fleet.replicas[0].edge.admission
    for sess_tenant, cid in (("bronze", "ub"), ("gold", "ug")):
        fleet.connect(model, client_id=cid, tenant=sess_tenant, min_repeats=2)
    ub, ug = fleet.clients["ub"], fleet.clients["ug"]
    r = ub.infer(x, deadline_s=1e-12)
    assert r.mode == "degraded_device" and warm_ctl.stats.deadline_misses == 1
    r = ub.infer(x, deadline_s=10.0)
    assert r.mode == "degraded_device" and warm_ctl.stats.deadline_hits == 1
    with pytest.raises(AdmissionRejectedError) as ei:
        ug.infer(x, deadline_s=10.0)
    assert ei.value.tenant == "gold" and ei.value.retry_after_s > 0
    assert warm_ctl.stats.shed == 1
