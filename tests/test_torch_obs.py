"""Observability in the port (tests/test_obs.py): the simulated-clock
tracer, one metrics registry behind every stats surface, and the Chrome
trace export, threaded through the serving stack.

Load-bearing properties, in order:

* a *disabled* tracer is free: the same fleet workload with and without
  tracing gives bitwise-identical outputs and identical counters, and a
  tracer never attached records no event;
* spans nest (begin/end parent links) and per-track timestamps are monotone
  on the shared ``SimClock``;
* hedged dispatch emits a primary *and* a backup ``hedge_dispatch`` span and
  the race loser is annotated ``cancelled=True`` once the race resolves;
* the Chrome trace-event export is schema-valid and carries the record,
  replay, hedge and migration spans across two or more replica tracks;
* one root ``MetricsRegistry.snapshot()`` agrees with every stats surface
  (client RPCs, cache hits, hedge counts, migrations).

Against the JAX package (``repro.obs``): the same tracer calls give the same
Chrome trace JSON, the same registry calls the same snapshot, ``percentile``
the same value on seeded random lists; the traced MLP fleet emits the same
span and instant names on every track, and its root snapshot has the same
keys, with equal values for the fleet, router and cache counters.  The
recording phase's RPC counts differ by design (the port unrolls its layers),
so the RPC and byte values are held against the port's own stats surfaces,
not the reference's.  Every comparison here is exact.
"""
from __future__ import annotations

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.netsim import CapacityResource as JCapacityResource  # noqa: E402
from repro.core.netsim import ServerIngress as JServerIngress  # noqa: E402
from repro.partition.pipeline import Stage as JStage  # noqa: E402
from repro.partition.pipeline import simulate_pipeline as j_simulate_pipeline  # noqa: E402
from repro.partition.segments import ConstantLink as JConstantLink  # noqa: E402
from repro.core.offload import OffloadableModel as JOffloadableModel  # noqa: E402
from repro.obs import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import percentile as j_percentile  # noqa: E402
from repro.obs import to_chrome_trace as j_to_chrome_trace  # noqa: E402
from repro.obs import write_chrome_trace as j_write_chrome_trace  # noqa: E402
from repro.serving import EdgeFleet as JEdgeFleet  # noqa: E402
from repro.serving.admission import AdmissionController as JAdmissionController  # noqa: E402
from repro_torch.core.netsim import CapacityResource, FaultInjector, ServerIngress  # noqa: E402
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    MetricsRegistry,
    RegistryBackedStats,
    Tracer,
    percentile,
    to_chrome_trace,
    write_chrome_trace,
)
from repro_torch.models.cnn_zoo import make_sensor_encoder  # noqa: E402
from repro_torch.partition import PartitionConfig  # noqa: E402
from repro_torch.partition.pipeline import Stage, simulate_pipeline  # noqa: E402
from repro_torch.partition.planner import plan_cost, plan_partition  # noqa: E402
from repro_torch.partition.segments import ConstantLink, SegmentGraph  # noqa: E402
from repro_torch.serving import EdgeFleet  # noqa: E402
from repro_torch.serving.admission import AdmissionController  # noqa: E402

MBPS = 1e6 / 8.0


def _mlp_arrays(seed=0, d_in=16, d_hidden=32, d_out=8):
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(d_in, d_hidden)).astype(np.float32)
    w2 = rng.normal(size=(d_hidden, d_out)).astype(np.float32)
    x = rng.normal(size=(1, d_in)).astype(np.float32)
    return w1, w2, x


def make_mlp(seed=0):
    """tests/test_obs.py's MLP, from the same numpy draws."""
    w1, w2, x = _mlp_arrays(seed)
    params = {"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2)}

    def apply(p, x):
        return [torch.tanh(x @ p["w1"]) @ p["w2"]]

    xt = torch.from_numpy(x)
    return OffloadableModel(f"mlp{seed}", apply, params, (xt,)), xt


def make_jmlp(seed=0):
    w1, w2, x = _mlp_arrays(seed)
    params = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}

    def apply(p, x):
        return [jnp.tanh(x @ p["w1"]) @ p["w2"]]

    xj = jnp.asarray(x)
    return JOffloadableModel(f"mlp{seed}", apply, params, (xj,)), x


# ---------------------------------------------------------------------------
# metrics primitives
# ---------------------------------------------------------------------------
class TestMetrics:
    def test_counter_gauge_histogram(self):
        reg = MetricsRegistry()
        reg.counter("n").value += 3
        assert reg.counter("n").value == 3
        reg.gauge("depth").set(2.5)
        h = reg.histogram("lat")
        for v in (1.0, 2.0, 3.0, 4.0):
            h.observe(v)
        assert h.count == 4 and h.mean == pytest.approx(2.5)
        assert h.p50 <= h.p95 <= h.p99 <= 4.0
        s = h.summary()
        assert set(s) == {"count", "mean", "p50", "p95", "p99"}

    def test_percentile_nearest_rank(self):
        xs = list(range(1, 101))
        assert percentile(xs, 0) == 1
        assert percentile(xs, 100) == 100
        assert percentile(xs, 99) == 99
        assert percentile([], 50) == 0.0

    def test_scope_shares_one_store(self):
        root = MetricsRegistry()
        root.scope("r0").scope("cache").counter("hits").value += 2
        root.scope("r1").scope("cache").counter("hits").value += 5
        snap = root.snapshot()
        assert snap["r0.cache.hits"] == 2
        assert snap["r1.cache.hits"] == 5
        # a scoped snapshot sees only its subtree, unprefixed
        assert root.scope("r1").snapshot() == {"cache.hits": 5}

    def test_registry_backed_stats_proxy(self):
        class S(RegistryBackedStats):
            _fields = (("n", 0), ("bytes", 0.0))

        s = S()
        s.n += 2
        s.bytes += 0.5
        assert s.n == 2 and s.bytes == 0.5
        assert s.as_dict() == {"n": 2, "bytes": 0.5}
        # the numbers live in the handed-in registry scope, not the instance
        root = MetricsRegistry()
        s2 = S(registry=root.scope("x"))
        s2.n += 7
        assert root.snapshot()["x.n"] == 7
        with pytest.raises(AttributeError):
            s2.nonexistent_field


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------
class TestTracer:
    def test_spans_nest(self):
        t = Tracer()
        outer = t.begin("x", "outer", 0.0)
        inner = t.begin("x", "inner", 1.0)
        t.end(inner, 2.0)
        t.end(outer, 3.0)
        assert t.spans[outer].parent is None
        assert t.spans[inner].parent == outer
        assert t.spans[inner].dur == pytest.approx(1.0)
        # tracks nest independently
        other = t.begin("y", "solo", 0.5)
        assert t.spans[other].parent is None

    def test_end_pops_unclosed_children(self):
        t = Tracer()
        outer = t.begin("x", "outer", 0.0)
        t.begin("x", "dangling", 1.0)
        t.end(outer, 2.0)   # pops the dangling child too
        fresh = t.begin("x", "fresh", 3.0)
        assert t.spans[fresh].parent is None

    def test_complete_span_parents_without_pushing(self):
        t = Tracer()
        outer = t.begin("x", "outer", 0.0)
        leaf = t.span("x", "leaf", 0.5, 1.0)
        assert t.spans[leaf].parent == outer
        # the complete span is not on the stack: the next leaf still parents
        # under `outer`, not under `leaf`
        leaf2 = t.span("x", "leaf2", 1.0, 1.5)
        assert t.spans[leaf2].parent == outer

    def test_annotate_patches_args(self):
        t = Tracer()
        sid = t.span("x", "race", 0.0, 1.0, role="primary")
        t.annotate(sid, winner=False, cancelled=True)
        assert t.spans[sid].args == {"role": "primary", "winner": False, "cancelled": True}


# ---------------------------------------------------------------------------
# a fully traced fleet run: straggler -> hedge, plus one live migration
# ---------------------------------------------------------------------------
def drive_traced_fleet(fleet, mlp):
    """tests/test_obs.py's schedule: u0 locks into replay, its primary
    stalls (the router hedges to r1), then un-stalls; u1 records, migrates
    live r0 -> r1 and infers once more."""
    model, x = mlp(0)
    c = fleet.connect(model, client_id="u0", min_repeats=2)
    for _ in range(8):
        c.infer(x)
    assert c.session.client.mode == "replaying"
    # stall the primary hard on every request: the adaptive deadline trips
    # and the router hedges to the second replica
    prim = fleet.replica(c.primary)
    prim.slowdown = lambda i: 1.0
    for _ in range(6):
        c.infer(x)
    prim.slowdown = lambda i: 0.0
    assert fleet.router.stats.hedged > 0
    # speculation is suspended for the migration phase, so u1's recording
    # rounds (slow against the replay-built deadline) fork no backup onto
    # the migration target
    fleet.router.hedge_multiplier = float("inf")
    model2, x2 = mlp(1)
    c2 = fleet.connect(model2, client_id="u1", min_repeats=2)
    for _ in range(4):
        c2.infer(x2)
    fleet.migrate("u1")
    c2.infer(x2)
    return c


@pytest.fixture(scope="module")
def traced_fleet():
    tracer = Tracer()
    fleet = EdgeFleet(2, hedging=True, min_observations=4, tracer=tracer, device="cpu")
    c = drive_traced_fleet(fleet, make_mlp)
    return tracer, fleet, c


@pytest.fixture(scope="module")
def ref_traced_fleet():
    tracer = JTracer()
    fleet = JEdgeFleet(2, hedging=True, min_observations=4, tracer=tracer)
    c = drive_traced_fleet(fleet, make_jmlp)
    return tracer, fleet, c


class TestTracedFleet:
    def test_hedge_primary_and_backup_spans_loser_cancelled(self, traced_fleet):
        tracer, _fleet, _c = traced_fleet
        by_req = {}
        for sp in tracer.find("hedge_dispatch"):
            by_req.setdefault((sp.args["client"], sp.args["req"]), []).append(sp)
        raced = [sps for sps in by_req.values() if len(sps) >= 2]
        assert raced, "no request ever raced primary vs backup"
        for sps in raced:
            assert {sp.args["role"] for sp in sps} == {"primary", "backup"}
            winners = [sp for sp in sps if sp.args["winner"]]
            assert len(winners) == 1
            for sp in sps:
                assert sp.args["cancelled"] == (not sp.args["winner"])

    def test_timestamps_monotone_per_track(self, traced_fleet):
        tracer, _fleet, _c = traced_fleet
        assert all(sp.t1 is None or sp.t1 >= sp.t0 for sp in tracer.spans)
        last = {}
        for sp in tracer.spans:
            assert sp.t0 >= last.get(sp.track, 0.0), f"track {sp.track} went backwards at {sp.name}"
            last[sp.track] = sp.t0
        for ins in tracer.instants:
            assert ins.t >= 0.0

    def test_chrome_trace_schema(self, traced_fleet, tmp_path):
        tracer, _fleet, _c = traced_fleet
        doc = json.loads(json.dumps(to_chrome_trace(tracer), default=str))
        assert doc["displayTimeUnit"] == "ms"
        events = doc["traceEvents"]
        assert events
        names = set()
        tracks = set()
        for e in events:
            assert e["ph"] in {"X", "i", "C", "M"}
            if e["ph"] == "M":
                assert e["name"] in {"process_name", "thread_name"}
                continue
            assert isinstance(e["ts"], (int, float))
            assert e["pid"] == e["tid"].split("/", 1)[0]
            names.add(e["name"])
            tracks.add(e["tid"])
            if e["ph"] == "X":
                assert e["dur"] >= 0.0
            if e["ph"] == "i":
                assert e["s"] == "t"
        assert {"record_rpc", "replay_call", "hedge_dispatch", "migrate"} <= names
        replica_tracks = {t for t in tracks if re.match(r"^r\d+/", t)}
        assert len({t.split("/", 1)[0] for t in replica_tracks}) >= 2
        # file round trip
        path = tmp_path / "trace.json"
        write_chrome_trace(tracer, str(path))
        assert json.loads(path.read_text())["traceEvents"]

    def test_span_args_are_plain_values(self, traced_fleet):
        """Every arg is a plain Python value: JSON writes it as itself, not
        through ``default=str`` (no tensor, array scalar or device)."""
        tracer, _fleet, _c = traced_fleet

        def plain(v):
            if isinstance(v, (list, tuple)):
                return all(plain(x) for x in v)
            if isinstance(v, dict):
                return all(isinstance(k, str) and plain(x) for k, x in v.items())
            return isinstance(v, (bool, int, float, str, type(None))) and not isinstance(
                v, np.integer)

        assert all(plain(ev.args) for ev in (*tracer.spans, *tracer.instants))

    def test_root_snapshot_agrees_with_legacy_counters(self, traced_fleet):
        _tracer, fleet, c = traced_fleet
        snap = fleet.metrics.snapshot()
        assert snap["fleet.migrations"] == fleet.stats.migrations == 1
        assert snap["fleet.placements"] == fleet.stats.placements
        assert snap["hedge.requests"] == fleet.router.stats.requests
        assert snap["hedge.hedged"] == fleet.router.stats.hedged > 0
        assert snap["hedge.latency_s"]["count"] == len(fleet.router.stats.latencies)
        for i, rep in enumerate(fleet.replicas):
            assert snap[f"r{i}.cache.hits"] == rep.edge.cache.stats.hits
            assert (snap[f"r{i}.batcher.batches_executed"]
                    == rep.edge.batcher.stats.batches_executed)
        # u0 never migrated: each of its sessions reports under the scope of
        # the replica that owns it, and the RPC and byte counts agree
        for name, sess in c.sessions.items():
            assert snap[f"{name}.client.u0.rpcs"] == sess.client.stats.rpcs > 0
            assert (snap[f"{name}.client.u0.network_bytes"]
                    == sess.client.stats.network_bytes)


# ---------------------------------------------------------------------------
# disabled tracing is free
# ---------------------------------------------------------------------------
class TestDisabledTracer:
    @staticmethod
    def _run(tracer):
        fleet = EdgeFleet(2, min_observations=4, tracer=tracer, device="cpu")
        model, x = make_mlp(7)
        c = fleet.connect(model, client_id="u0", min_repeats=2)
        outs = [c.infer(x).outputs[0].clone() for _ in range(6)]
        return outs, c.session.client.stats.as_dict(), fleet.summary()

    def test_disabled_is_bitwise_identical_and_silent(self):
        idle = Tracer()               # constructed but never attached
        base_outs, base_stats, base_sum = self._run(None)
        assert idle.n_events == 0     # tracing off => zero events
        tr = Tracer()
        t_outs, t_stats, t_sum = self._run(tr)
        assert tr.n_events > 0
        for a, b in zip(base_outs, t_outs):
            assert torch.equal(a, b)
        assert base_stats == t_stats
        assert base_sum["fleet"] == t_sum["fleet"]
        assert base_sum["router"] == t_sum["router"]
        assert base_sum["backhaul_bytes"] == t_sum["backhaul_bytes"]


# ---------------------------------------------------------------------------
# planner explain report
# ---------------------------------------------------------------------------
class TestPlanExplain:
    def test_plan_explain_event_matches_choice(self):
        model, x = make_mlp(3)
        sess = OffloadSession(model, "rrto", min_repeats=2, device="cpu")
        sess.load()
        for _ in range(4):
            sess.infer(x)
        graph = SegmentGraph(sess.client._ios_calls)
        tracer = Tracer()
        best = plan_partition(
            graph, sess.client_device, sess.server_device, 16 * MBPS,
            tracer=tracer, trace_track="planner", now=1.5,
        )
        explains = [i for i in tracer.instants if i.name == "plan_explain"]
        assert len(explains) == 1
        ev = explains[0]
        assert ev.track == "planner" and ev.t == 1.5
        rows = ev.args["candidates"]
        assert len(rows) >= 2          # at least both binary endpoints
        assert ev.args["chosen"] == best.plan.signature()
        by_cost = min(rows, key=lambda r: r["cost"])
        assert by_cost["plan"] == best.plan.signature()
        assert by_cost["cost"] == pytest.approx(plan_cost(best, "latency"))


# ---------------------------------------------------------------------------
# the session's hooks: retries, outages, split and pipelined replay
# ---------------------------------------------------------------------------
def make_rnn(seed=0, d=8, batch=2):
    """A recurrent app threading explicit state (stateful replay)."""
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(rng.normal(0, 0.1, (d, d)).astype(np.float32))}

    def apply(p, x, state):
        new_state = torch.tanh(state @ p["w"] + x)
        return [new_state.sum(dim=1), new_state]

    x = torch.from_numpy(rng.normal(0, 1, (batch, d)).astype(np.float32))
    return OffloadableModel(f"rnn{seed}", apply, params, (x, torch.zeros((batch, d)))), x


def _names(tracer):
    out = {}
    for ev in (*tracer.spans, *tracer.instants):
        out.setdefault(ev.track, set()).add(ev.name)
    return out


class TestTracedSessionHooks:
    """Each hook a session has, traced against the same run untraced: the
    outputs, the clock and every counter stay bitwise, and the events land
    on the session's tracks."""

    @staticmethod
    def _rnn(tracer, fault, steps=12):
        model, x = make_rnn()
        sess = OffloadSession(model, "rrto", min_repeats=2, device="cpu", fault=fault,
                              tracer=tracer)
        state, ys, ts = model.example_inputs[1], [], []
        for _ in range(steps):
            res = sess.infer(x, state)
            state = res.outputs[1]
            ys.append(res.outputs[0].clone())
            ts.append(sess.clock.t)
        return sess, ys, ts

    def test_lossy_stateful_outage_is_bitwise_and_traced(self):
        # the outage window straddles step 8's entry on the lossy run's own
        # clock (the run is the same up to the window)
        _, _, ts = self._rnn(None, FaultInjector(seed=1, rpc_loss_prob=0.25))
        window = (0.5 * (ts[7] + ts[8]), 0.5 * (ts[8] + ts[9]))
        runs = {}
        for key, tracer in (("off", None), ("on", Tracer())):
            fault = FaultInjector(seed=1, rpc_loss_prob=0.25, outages=(window,))
            runs[key] = (*self._rnn(tracer, fault), tracer)
        (off, ys_off, ts_off, _), (on, ys_on, ts_on, tracer) = runs["off"], runs["on"]
        assert all(torch.equal(a, b) for a, b in zip(ys_off, ys_on)) and ts_off == ts_on
        assert off.client.stats.as_dict() == on.client.stats.as_dict()
        assert on.client.stats.retries > 0 and on.client.stats.outage_waits == 1
        assert torch.equal(off.server.export_carried_state("c0")[0],
                           on.server.export_carried_state("c0")[0])
        names = _names(tracer)
        assert {"record_rpc", "rpc", "replay_call", "replay_d2h", "ios_locked", "retry",
                "outage_declared", "outage_wait", "link_healed"} <= names["client/c0"]

    def test_split_pipelined_outage_is_bitwise_and_traced(self):
        enc = make_sensor_encoder(0.25, 32, n_blocks=2, device="cpu")
        x = enc.example_inputs
        runs = {}
        for key, tracer in (("off", None), ("on", Tracer())):
            sess = OffloadSession(enc, "rrto", min_repeats=2, device="cpu", tracer=tracer,
                                  partition=PartitionConfig(pipelined=True,
                                                            min_replan_interval_s=0.0))
            outs = [sess.infer(*x).outputs[0] for _ in range(4)]
            assert sess.client.mode == "replaying" and sess.client.split_plan is not None
            outs += [r.outputs[0] for r in sess.infer_stream([x] * 3, arrivals=[0.0, 1e-4, 2e-4])]
            t = sess.clock.t
            fault = FaultInjector(seed=0, outages=((t, t + 1e-3),))
            sess.client.fault = fault
            sess.network.fault = fault
            outs += [sess.infer(*x).outputs[0] for _ in range(5)]
            runs[key] = (sess, outs, tracer)
        (off, outs_off, _), (on, outs_on, tracer) = runs["off"], runs["on"]
        assert all(torch.equal(a, b) for a, b in zip(outs_off, outs_on))
        assert off.clock.t == on.clock.t
        assert off.client.stats.as_dict() == on.client.stats.as_dict()
        assert off.client.replanner.stats.as_dict() == on.client.replanner.stats.as_dict()
        assert on.client.replanner.stats.outage_replans == 1
        names = _names(tracer)
        assert {"plan_explain", "cut_uplink", "device_exec", "outage_declared", "outage_fallback",
                "outage_replan", "link_healed"} <= names["client/c0"]
        assert "segment_exec" in names["server/gpu"]
        assert names["client/c0/device"] == names["client/c0/radio"] == {"occupy"}
        explains = [i for i in tracer.instants if i.name == "plan_explain"]
        assert on.client.replanner.stats.plans_considered == len(explains)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _emit(tracer):
    """One fixed sequence of every emission kind, nested spans included."""
    outer = tracer.begin("r0/client/u0", "outer", 0.0, fp="abc")
    tracer.span("r0/client/u0", "record_rpc", 0.25, 0.5, payload=64.0, response=32)
    inner = tracer.begin("r0/client/u0", "inner", 0.5)
    tracer.instant("fleet", "place", 0.5, model="m", replica="r0", affinity=False)
    tracer.end(inner, 0.75)
    tracer.counter("r0/ingress", "ingress_bytes", 0.6, 128)
    race = tracer.span("r1/hedge", "hedge_dispatch", 0.7, 1.9, role="backup")
    tracer.annotate(race, winner=False, cancelled=True)
    tracer.end(outer, 2.0)
    tracer.begin("r1/gpu", "left_open", 2.5)
    tracer.instant("planner", "plan_explain", 3.0,
                   candidates=[{"plan": "S0:4", "cost": 1.5}], chosen="S0:4")


def _registry_calls(reg):
    reg.counter("n").value += 3
    reg.scope("r0").scope("cache").counter("hits").value += 2
    reg.scope("r1").scope("cache").counter("bytes", 0.0).value += 0.5
    reg.scope("r1").gauge("queue_depth").set(4)
    h = reg.scope("hedge").histogram("latency_s")
    for v in (0.3, 0.1, 0.4, 0.1, 0.5, 0.9, 0.2):
        h.observe(v)
    reg.scope("empty").histogram("batch_width")


class TestAgainstReference:
    def test_chrome_trace_json_equal(self, tmp_path):
        ours, ref = Tracer(), JTracer()
        _emit(ours)
        _emit(ref)
        assert ours.n_events == ref.n_events and ours.tracks() == ref.tracks()
        assert (json.dumps(to_chrome_trace(ours), default=str)
                == json.dumps(j_to_chrome_trace(ref), default=str))
        # the written files too, byte for byte
        write_chrome_trace(ours, str(tmp_path / "ours.json"))
        j_write_chrome_trace(ref, str(tmp_path / "ref.json"))
        assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()

    def test_snapshots_equal(self):
        ours, ref = MetricsRegistry(), JMetricsRegistry()
        _registry_calls(ours)
        _registry_calls(ref)
        assert ours.snapshot() == ref.snapshot()
        assert ours.scope("r1").snapshot() == ref.scope("r1").snapshot()

    @pytest.mark.parametrize("seed", range(4))
    def test_percentile_equal(self, seed):
        rng = np.random.default_rng(seed)
        for n in (1, 2, 7, 100):
            xs = rng.normal(size=n).tolist()
            for q in (0, 1, 25, 50, 95, 99, 100, float(rng.uniform(0, 100))):
                assert percentile(xs, q) == j_percentile(xs, q)

    def test_ingress_queue_depth_equal(self):
        """``bind`` with metrics makes the ingress's wait-queue depth a gauge;
        the gauge and the traced ``queue_depth`` and ``ingress_bytes``
        samples follow the reference's at every depth."""
        got = {}
        for key, ingress, adm, reg, tracer in (
            ("ours", ServerIngress(), AdmissionController, MetricsRegistry(), Tracer()),
            ("ref", JServerIngress(), JAdmissionController, JMetricsRegistry(), JTracer()),
        ):
            ctl = adm(queue_limit=3, metrics=reg)
            ctl.bind(ingress=ingress)
            ingress.tracer = tracer
            seen = []
            for t, depth in enumerate((0, 2, 3, 5, 1)):
                ingress.set_queue_depth(depth, float(t))
                seen.append(reg.snapshot()["queue_depth"])
            ingress.set_queue_depth(7)      # no time: the gauge only
            ingress.account(10.0, 9.0)
            got[key] = (seen, reg.snapshot(),
                        [(c.track, c.name, c.t, c.value) for c in tracer.counters])
        assert got["ours"] == got["ref"]
        assert got["ours"][0] == [0, 2, 3, 5, 1] and len(got["ours"][2]) == 6

    def test_capacity_resource_spans_equal(self):
        """The analytic pipeline on traced resources: each reservation is an
        ``occupy`` span on its resource's track, stage by stage as the
        reference's."""
        got = {}
        for key, tracer, stage, link, simulate, resource in (
            ("ours", Tracer(), Stage, ConstantLink, simulate_pipeline, CapacityResource),
            ("ref", JTracer(), JStage, JConstantLink, j_simulate_pipeline, JCapacityResource),
        ):
            chain = [stage("device", seconds=1e-3, label="D0:3"),
                     stage("link", nbytes=4000.0, label="up@3"),
                     stage("server", seconds=2e-3, label="S3:9"),
                     stage("link", nbytes=400.0, label="down@out")]
            res = {name: resource(name, tracer=tracer, track=f"pipe/{name}")
                   for name in ("device", "link", "server")}
            sim = simulate(chain, link(8e6), [0.0, 5e-4, 1e-3, 6e-3], device=res["device"],
                           server=res["server"], link_resource=res["link"])
            got[key] = ([s.done for s in sim.inferences],
                        [(sp.track, sp.name, sp.t0, sp.t1, sp.args) for sp in tracer.spans])
        assert got["ours"] == got["ref"] and len(got["ours"][1]) == 16

    def test_traced_fleet_names_per_track_equal(self, traced_fleet, ref_traced_fleet):
        def names(tracer):
            out = {}
            for ev in (*tracer.spans, *tracer.instants):
                out.setdefault(ev.track, set()).add(ev.name)
            return out

        assert names(traced_fleet[0]) == names(ref_traced_fleet[0])

    def test_traced_fleet_root_snapshot_keys_equal(self, traced_fleet, ref_traced_fleet):
        _, ours, c = traced_fleet
        _, ref, _ = ref_traced_fleet
        snap, rsnap = ours.metrics.snapshot(), ref.metrics.snapshot()
        assert set(snap) == set(rsnap)
        # the fleet's, router's, batchers' and caches' counters agree; the
        # clients' RPC and byte counts differ with the recording phase
        shared = [k for k in snap if k.startswith(("fleet.", "hedge.", "r0.cache.", "r1.cache.",
                                                   "r0.batcher.", "r1.batcher."))
                  and k != "hedge.latency_s" and k != "hedge.total_latency_s"]
        assert shared and {k: snap[k] for k in shared} == {k: rsnap[k] for k in shared}
        for name, sess in c.sessions.items():
            assert snap[f"{name}.client.u0.cache_adoptions"] == sess.client.stats.cache_adoptions
