"""Pipelined split replay in the port (tests/test_pipeline.py): the
event-driven timeline (capacity resources, the event scheduler, client clock
skew, open-loop arrivals, queue growth under overload), the pipeline-aware
throughput objective, and pipelined streaming outputs bitwise equal to the
sequential split path with in-order delivery.  The timeline pieces are held
against the JAX package's on the same arrivals and chains (equal numbers),
and the zoo models' replays within 2e-4 of the JAX package's."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import (  # noqa: E402
    BoundSegmentedReplay,
    PipelinedSegmentedReplay,
    SegmentedReplayProgram,
)
from repro_torch.core.netsim import (  # noqa: E402
    CapacityResource,
    ClientClock,
    EventTimeline,
    periodic_arrivals,
    poisson_arrivals,
)
from repro_torch.core.offload import OffloadSession  # noqa: E402
from repro_torch.models.cnn_zoo import ZOO  # noqa: E402
from repro_torch.partition import (  # noqa: E402
    PLACE_DEVICE,
    PLACE_SERVER,
    PartitionConfig,
    SegmentGraph,
    SplitPlan,
    evaluate_plan,
    pipeline_schedule,
    plan_partition,
    simulate_pipeline,
    stage_chain,
)
from repro_torch.partition.pipeline import Stage  # noqa: E402
from repro_torch.partition.segments import ConstantLink  # noqa: E402

MBPS = 1e6 / 8.0
TOL = 2e-4

REGISTRY_CASES = {
    "vgg16": dict(scale=0.1, input_size=32),
    "sensor_encoder": dict(scale=0.25, input_size=32, n_blocks=2),
}


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _sensor(**kw):
    return ZOO["sensor_encoder"](**REGISTRY_CASES["sensor_encoder"], device="cpu", **kw)


class TestCapacityResource:
    def test_reservations_serialize(self):
        r = CapacityResource("gpu")
        assert r.reserve(1.0, 2.0) == (1.0, 3.0)
        # a request in the past queues behind the frontier
        assert r.reserve(0.0, 1.0) == (3.0, 4.0)
        assert r.busy == [(1.0, 3.0), (3.0, 4.0)]

    def test_busy_seconds_and_utilization(self):
        r = CapacityResource("link")
        r.reserve(0.0, 1.0)
        r.reserve(2.0, 1.0)
        assert r.busy_seconds(0.0, 3.0) == pytest.approx(2.0)
        assert r.busy_seconds(0.5, 2.5) == pytest.approx(1.0)
        assert r.utilization(0.0, 4.0) == pytest.approx(0.5)

    def test_zero_duration_records_nothing(self):
        r = CapacityResource("x")
        r.reserve(5.0, 0.0)
        assert r.busy == [] and r.free_at == 5.0
        with pytest.raises(ValueError):
            r.reserve(0.0, -1.0)
        totals = CapacityResource("y", record_intervals=False)
        totals.reserve(0.0, 2.0)
        assert totals.busy == [] and totals.busy_seconds() == 2.0
        with pytest.raises(ValueError):
            totals.busy_seconds(1.0, 2.0)


class TestEventTimeline:
    def test_fires_in_time_order_fifo_ties(self):
        tl = EventTimeline()
        order = []
        tl.at(2.0, lambda: order.append("late"))
        tl.at(1.0, lambda: order.append("a"))
        tl.at(1.0, lambda: order.append("b"))       # tie: FIFO
        tl.run()
        assert order == ["a", "b", "late"]
        assert tl.now == 2.0 and tl.fired == 3

    def test_handlers_schedule_further_events(self):
        tl = EventTimeline()
        seen = []

        def chain(k):
            seen.append(k)
            if k < 3:
                tl.at(tl.now + 1.0, lambda: chain(k + 1))

        tl.at(0.5, lambda: chain(0))
        tl.run()
        assert seen == [0, 1, 2, 3] and tl.now == pytest.approx(3.5)

    def test_run_until_stops_early(self):
        tl = EventTimeline()
        seen = []
        for t in (1.0, 2.0, 3.0):
            tl.at(t, lambda t=t: seen.append(t))
        tl.run(until=2.0)
        assert seen == [1.0, 2.0] and len(tl) == 1


class TestClockSkewAndArrivals:
    def test_clock_roundtrip(self):
        cc = ClientClock(offset_s=0.050, drift=50e-6)
        for t in (0.0, 1.0, 123.456):
            assert cc.to_local(cc.to_global(t)) == pytest.approx(t)
        # a fast-drifting clock's local second is more than a global second
        assert cc.to_global(1000.0) - cc.to_global(0.0) > 1000.0

    def test_skewed_clients_interleave_on_global_timeline(self):
        """Two clients emit periodic arrivals in their own skewed local time;
        mapped to global time, the timeline interleaves them in true order."""
        a = ClientClock(offset_s=0.000, drift=0.0)
        b = ClientClock(offset_s=0.004, drift=100e-6)  # 4 ms ahead
        merged = []
        tl = EventTimeline()
        for name, clock in (("a", a), ("b", b)):
            for t_local in periodic_arrivals(0.010, 5):
                tl.at(clock.to_global(t_local), lambda name=name: merged.append((tl.now, name)))
        tl.run()
        times = [t for t, _ in merged]
        assert times == sorted(times)
        assert [n for _, n in merged[:6]] == ["a", "b", "a", "b", "a", "b"]

    def test_poisson_arrivals_deterministic_and_open_loop(self):
        from repro.core.netsim import poisson_arrivals as j_poisson

        xs = poisson_arrivals(100.0, 200, seed=7)
        assert xs == poisson_arrivals(100.0, 200, seed=7)
        assert xs == j_poisson(100.0, 200, seed=7)
        assert all(b > a for a, b in zip(xs, xs[1:]))
        mean_gap = (xs[-1] - xs[0]) / (len(xs) - 1)
        assert 0.005 < mean_gap < 0.02          # ~1/100 Hz, loose bounds
        with pytest.raises(ValueError):
            poisson_arrivals(0.0, 5)

    def test_periodic_jitter_never_reorders(self):
        from repro.core.netsim import periodic_arrivals as j_periodic

        xs = periodic_arrivals(0.01, 50, jitter_s=0.02, seed=3)
        assert all(b >= a for a, b in zip(xs, xs[1:]))
        assert xs == j_periodic(0.01, 50, jitter_s=0.02, seed=3)


class TestOverload:
    """Open-loop arrivals above the bottleneck service rate grow the queue
    without bound — an observable, not a modeling error."""

    CHAIN = [Stage("server", seconds=0.010)]
    LINK = ConstantLink(1e9)

    def test_queue_grows_under_overload(self):
        arrivals = periodic_arrivals(0.005, 40)   # 2x overload
        sim = simulate_pipeline(self.CHAIN, self.LINK, arrivals)
        depths = [s.queue_depth for s in sim.inferences]
        waits = [s.queue_wait for s in sim.inferences]
        assert sim.max_queue_depth >= 10
        assert depths[-1] > depths[len(depths) // 2] > depths[2]
        assert waits[-1] > waits[len(waits) // 2] > 0.0
        assert sim.inferences[-1].latency > 5 * sim.inferences[5].latency

    def test_queue_bounded_below_capacity(self):
        sim = simulate_pipeline(self.CHAIN, self.LINK, periodic_arrivals(0.012, 40))
        assert sim.max_queue_depth <= 1
        assert max(s.latency for s in sim.inferences) <= 0.011

    def test_poisson_overload_matches_reference(self):
        """The same chain and arrivals through both packages' simulators:
        the same completions and queue depths."""
        from repro.partition import simulate_pipeline as j_simulate
        from repro.partition.pipeline import Stage as JStage
        from repro.partition.segments import ConstantLink as JLink

        chain = [Stage("device", 0.002), Stage("link", nbytes=2e5), Stage("server", 0.010),
                 Stage("link", nbytes=1e4)]
        jchain = [JStage(s.resource, s.seconds, s.nbytes) for s in chain]
        arrivals = poisson_arrivals(200.0, 60, seed=1)
        sim = simulate_pipeline(chain, ConstantLink(50 * MBPS), arrivals)
        jsim = j_simulate(jchain, JLink(50 * MBPS), arrivals)
        assert sim.max_queue_depth >= 10
        assert [s.done for s in sim.inferences] == [s.done for s in jsim.inferences]
        assert [s.queue_depth for s in sim.inferences] == [s.queue_depth for s in jsim.inferences]


@pytest.fixture(scope="module")
def recorded():
    """One replay-locked rrto session per zoo model (real execution on the
    CPU), with the JAX package's rrto outputs on the same model."""
    from repro.core.offload import OffloadSession as JSession
    from repro.models.cnn_zoo import ZOO as JZOO

    out = {}
    for name, kwargs in REGISTRY_CASES.items():
        model = ZOO[name](**kwargs, device="cpu")
        sess = OffloadSession(model, "rrto", min_repeats=2, device="cpu")
        sess.load()
        jmodel = JZOO[name](**kwargs)
        jsess = JSession(jmodel, "rrto", min_repeats=2)
        jsess.load()
        for _ in range(5):
            res = sess.infer(*model.example_inputs)
            jres = jsess.infer(*jmodel.example_inputs)
        assert res.mode == "replaying", f"{name} never locked its IOS"
        for got, want in zip(res.outputs, jres.outputs):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        out[name] = (sess, res.outputs)
    return out


class TestPipelinedEquivalence:
    @pytest.mark.parametrize("name", sorted(REGISTRY_CASES))
    def test_bitwise_identical_to_sequential_split(self, recorded, name):
        """Pipelined streaming is bitwise the sequential split path (and the
        full replay), for any plan, with in-order completion."""
        sess, ref_outputs = recorded[name]
        calls = sess.client._ios_calls
        env = sess.server.context(sess.client_id).env
        n_ops = SegmentGraph(calls).n_ops
        plans = [
            SplitPlan.from_placements([PLACE_DEVICE] * 2 + [PLACE_SERVER] * (n_ops - 2)),
            SplitPlan.from_placements(
                [PLACE_SERVER] * (n_ops // 2) + [PLACE_DEVICE] * (n_ops - n_ops // 2)),
            SplitPlan.full_device(n_ops),
        ]
        inputs = sess.replay_wire_inputs(sess.model.example_inputs)
        for plan in plans:
            bound = BoundSegmentedReplay.from_own(SegmentedReplayProgram(calls, plan))
            seq_outs = bound.execute(inputs, env)
            pipe = PipelinedSegmentedReplay(
                bound, sess.client_device, sess.server, sess.network,
                input_wire_divisor=sess.model.input_wire_divisor,
            )
            stream_outs = [pipe.submit(inputs, env, 0.001 * k) for k in range(3)]
            dones = pipe.flush()
            assert len(dones) == 3 and dones == sorted(dones)
            for outs in stream_outs:
                assert _equal(outs, seq_outs), f"{name}: {plan.signature()} pipelined != seq"
                assert _equal(outs, ref_outputs), f"{name}: {plan.signature()} != full"

    def test_arrivals_must_be_monotone(self, recorded):
        sess, _ = recorded["sensor_encoder"]
        calls = sess.client._ios_calls
        n_ops = SegmentGraph(calls).n_ops
        plan = SplitPlan.from_placements([PLACE_DEVICE] + [PLACE_SERVER] * (n_ops - 1))
        bound = BoundSegmentedReplay.from_own(SegmentedReplayProgram(calls, plan))
        pipe = PipelinedSegmentedReplay(bound, sess.client_device, sess.server, sess.network)
        env = sess.server.context(sess.client_id).env
        inputs = sess.replay_wire_inputs(sess.model.example_inputs)
        pipe.submit(inputs, env, 1.0)
        with pytest.raises(ValueError):
            pipe.submit(inputs, env, 0.5)


class TestPipelinedStreamSession:
    def test_stream_outputs_match_sequential_session(self):
        """An open-loop stream through a pipelined split session gives bitwise
        the outputs of a plain sequential rrto session."""
        model = _sensor()
        plain = OffloadSession(model, "rrto", min_repeats=2, seed=0, device="cpu")
        piped = OffloadSession(
            model, "rrto", min_repeats=2, seed=0, device="cpu",
            partition=PartitionConfig(objective="throughput", pipelined=True),
        )
        for _ in range(5):
            plain.infer(*model.example_inputs)
            piped.infer(*model.example_inputs)
        assert piped.client.mode == "replaying"
        assert piped.client.pipelined_exec is not None

        rng = np.random.default_rng(11)
        xs = [
            tuple(torch.as_tensor(np.asarray(x) + rng.normal(0, 0.01, np.shape(x)).astype(np.float32))
                  for x in model.example_inputs)
            for _ in range(6)
        ]
        t0 = piped.clock.t
        results = piped.infer_stream(xs)
        assert len(results) == len(xs)
        assert all(a.done_at <= b.done_at for a, b in zip(results, results[1:]))
        assert piped.clock.t == pytest.approx(results[-1].done_at)
        assert piped.clock.t > t0
        for r, ins in zip(results, xs):
            assert _equal(r.outputs, plain.infer(*ins).outputs)

    def test_stream_falls_back_closed_loop_without_pipeline(self):
        """A cold (recording) session streams through sequential infer()
        and warms itself into the replay phase."""
        model = _sensor()
        sess = OffloadSession(model, "rrto", min_repeats=2, seed=0, device="cpu")
        sess.load()
        results = sess.infer_stream([tuple(model.example_inputs)] * 5,
                                    arrivals=[0.01 * k for k in range(5)])
        assert len(results) == 5
        assert sess.client.mode == "replaying"
        assert all(a.done_at <= b.done_at for a, b in zip(results, results[1:]))

    def test_dam_fallback_drops_pipelined_exec(self):
        """A mid-replay op-stream deviation drops the stream executor with
        the plan: a deviated session streams closed-loop instead of
        replaying the stale IOS."""
        from repro_torch.core.costmodel import GTX_2080TI
        from repro_torch.core.energy import EnergyMeter
        from repro_torch.core.engine import OffloadServer, RRTOClient, SimClock
        from repro_torch.core.flatten import trace_app
        from repro_torch.core.intercept import NO_NOISE, GraphInterceptor
        from repro_torch.core.netsim import indoor_network

        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.normal(0, 0.1, (8, 8)).astype(np.float32))
        x = torch.from_numpy(rng.normal(0, 1, (2, 8)).astype(np.float32))
        ga = trace_app(lambda ls, xx: [torch.tanh(xx @ ls[0]) @ ls[0]], [w], [x])
        gb = trace_app(lambda ls, xx: [torch.relu(xx @ ls[0])], [w], [x])
        client = RRTOClient(
            OffloadServer(GTX_2080TI, device=torch.device("cpu")), indoor_network(),
            SimClock(), EnergyMeter(), min_repeats=2,
            partition=PartitionConfig(pipelined=True),
        )
        icp = GraphInterceptor(client, NO_NOISE)
        addrs = icp.upload_params([w])
        for _ in range(4):
            icp.run(ga, addrs, [x])
        assert client.mode == "replaying"
        assert client.pipelined_exec is not None  # tiny graph: device plan
        icp.run(gb, addrs, [x])                   # deviate
        assert client.fallbacks >= 1 and client.mode == "recording"
        assert client.pipelined_exec is None

    def test_stream_validates_inputs(self):
        model = _sensor()
        sess = OffloadSession(model, "rrto", min_repeats=2, device="cpu")
        with pytest.raises(ValueError, match="arrival"):
            sess.infer_stream([tuple(model.example_inputs)] * 2, arrivals=[0.2, 0.1])
        nn = OffloadSession(model, "nnto", device="cpu")
        with pytest.raises(ValueError, match="rrto"):
            nn.infer_stream([tuple(model.example_inputs)])

    def test_stream_accepts_generator_arrivals(self):
        """Open-loop drivers hand ``poisson_arrivals`` output straight to
        ``infer_stream``; any iterable of offsets is materialized."""
        from repro_torch.core.netsim import client_stream_seed

        model = _sensor()
        sess = OffloadSession(model, "rrto", min_repeats=2, seed=0, device="cpu")
        sess.load()
        offsets = poisson_arrivals(100.0, 4, seed=client_stream_seed(3, "c0"))
        results = sess.infer_stream([tuple(model.example_inputs)] * 4, arrivals=iter(offsets))
        assert len(results) == 4
        assert sess.client.mode == "replaying"

    def test_stream_errors_name_the_offending_index(self):
        model = _sensor()
        sess = OffloadSession(model, "rrto", min_repeats=2, device="cpu")
        xs = [tuple(model.example_inputs)] * 3
        with pytest.raises(ValueError, match="index 1"):
            sess.infer_stream(xs, arrivals=iter([0.0, -0.2, 0.3]))
        with pytest.raises(ValueError, match="index 2.*precedes.*index 1"):
            sess.infer_stream(xs, arrivals=(t for t in [0.0, 0.5, 0.3]))


class TestThroughputObjective:
    def test_config_accepts_throughput(self):
        cfg = PartitionConfig(objective="throughput", pipelined=True)
        assert cfg.objective == "throughput"
        with pytest.raises(ValueError):
            PartitionConfig(objective="bandwidth")

    def test_throughput_planner_never_worse_on_period(self, recorded):
        """The pipeline-aware planner's period is <= the one-shot planner's
        plan under the same objective, and <= both binary endpoints."""
        for name, (sess, _) in recorded.items():
            graph = SegmentGraph(sess.client._ios_calls)
            div = sess.model.input_wire_divisor
            n = graph.n_ops
            for mbps in (2.0, 16.0, 64.0, 256.0):
                bw = mbps * MBPS
                tp = plan_partition(graph, sess.client_device, sess.server_device, bw,
                                    input_wire_divisor=div,
                                    config=PartitionConfig(objective="throughput"))
                lat = plan_partition(graph, sess.client_device, sess.server_device, bw,
                                     input_wire_divisor=div)
                assert tp.period_seconds <= lat.period_seconds + 1e-12
                for endpoint in (SplitPlan.full_server(n), SplitPlan.full_device(n)):
                    ev = evaluate_plan(graph, endpoint, sess.client_device, sess.server_device,
                                       bw, input_wire_divisor=div)
                    assert tp.period_seconds <= ev.period_seconds + 1e-12, (
                        f"{name}@{mbps}Mbps: worse than {endpoint.signature()}")

    def test_period_never_exceeds_latency(self, recorded):
        """max(stage) <= sum(stages): a plan's period never exceeds its own
        fill latency."""
        sess, _ = recorded["vgg16"]
        graph = SegmentGraph(sess.client._ios_calls)
        n = graph.n_ops
        link = ConstantLink(16 * MBPS)
        for plan in (SplitPlan.full_server(n), SplitPlan.full_device(n),
                     SplitPlan.from_placements([PLACE_DEVICE] * (n // 2)
                                               + [PLACE_SERVER] * (n - n // 2))):
            pipe = pipeline_schedule(graph, plan, sess.client_device, sess.server_device, link)
            assert pipe.period_seconds <= pipe.latency_seconds + 1e-15
            assert pipe.overlap_ratio <= 1.0 + 1e-12

    def test_event_driven_overlap_beats_closed_loop(self, recorded):
        """For a true split, the saturated event-driven stream sustains a
        shorter interval than the closed-loop walk of the same chain, and
        matches the analytic period."""
        sess, _ = recorded["sensor_encoder"]
        graph = SegmentGraph(sess.client._ios_calls)
        n = graph.n_ops
        # cut after the stem convolution (the reference's graph has it at op
        # 1; the port's aten graph first permutes, copies and pads the frame)
        kernels = [c.op for c in sess.client._ios_calls if c.op is not None]
        b = kernels.index(torch.ops.aten.convolution.default) + 1
        plan = SplitPlan.from_placements([PLACE_DEVICE] * b + [PLACE_SERVER] * (n - b))
        link = ConstantLink(64 * MBPS)
        chain = stage_chain(graph, plan, sess.client_device, sess.server_device)
        pipe = pipeline_schedule(graph, plan, sess.client_device, sess.server_device, link)
        open_sim = simulate_pipeline(chain, link, [k * pipe.period_seconds for k in range(24)])
        closed_sim = simulate_pipeline(chain, link, [0.0] * 24, closed_loop=True)
        assert open_sim.steady_period() < 0.95 * closed_sim.steady_period()
        assert open_sim.steady_period() == pytest.approx(pipe.period_seconds, rel=0.15)
