"""Split replay in the port (tests/test_partition.py): segment-graph
extraction, split execution bitwise equal to the full-server replay for
random plans on three zoo models, the planner never worse than the
binary-offloading endpoints (and strictly better inside the bandwidth
sweep of ``benchmarks/partition_sweep.py``, whose operating points are
copied here), adaptive re-planning with hysteresis and a rate limit,
``fp|plan``-keyed caching, and the partitioned session.  The zoo models are
built from the same seed in both packages (equal parameters and inputs), and
the port's split sessions are held within 2e-4 of the JAX package's rrto
sessions on them."""
from __future__ import annotations

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import BoundSegmentedReplay, SegmentedReplayProgram  # noqa: E402
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.models.cnn_zoo import ZOO, make_sensor_encoder  # noqa: E402
from repro_torch.partition import (  # noqa: E402
    PLACE_DEVICE,
    PLACE_SERVER,
    AdaptiveReplanner,
    PartitionConfig,
    SegmentGraph,
    SplitPlan,
    evaluate_plan,
    plan_partition,
)
from repro_torch.partition.segments import Segment  # noqa: E402

REGISTRY_CASES = {
    "vgg16": dict(scale=0.1, input_size=32),
    "resnet50": dict(scale=0.1, input_size=32),
    "sensor_encoder": dict(scale=0.25, input_size=32, n_blocks=2),
}
# the operating points of benchmarks/partition_sweep.py (SWEEP_MBPS, and its
# workload make_sensor_encoder(scale=1.0, input_size=96))
SWEEP_MBPS = (0.5, 2.0, 8.0, 32.0, 128.0)
SWEEP_MODEL = dict(scale=1.0, input_size=96)
MBPS = 1e6 / 8.0
TOL = 2e-4


def random_plans(n_ops: int, rng: np.random.Generator, k: int = 6):
    """Sample k random contiguous segmentations with alternating placements."""
    plans = []
    for _ in range(k):
        n_cuts = int(rng.integers(1, min(6, n_ops)))
        cuts = sorted(rng.choice(np.arange(1, n_ops), size=n_cuts, replace=False))
        bounds = [0] + [int(c) for c in cuts] + [n_ops]
        place = PLACE_DEVICE if rng.random() < 0.5 else PLACE_SERVER
        placements: list = []
        for lo, hi in zip(bounds, bounds[1:]):
            placements += [place] * (hi - lo)
            place = PLACE_SERVER if place == PLACE_DEVICE else PLACE_DEVICE
        plans.append(SplitPlan.from_placements(placements))
    return plans


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def _near_reference(port_outs, ref_outs) -> None:
    assert len(port_outs) == len(ref_outs)
    for got, want in zip(port_outs, ref_outs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def lock(model, **kw):
    sess = OffloadSession(model, "rrto", min_repeats=2, device="cpu", **kw)
    sess.load()
    res = None
    for _ in range(5):
        res = sess.infer(*model.example_inputs)
    assert res.mode == "replaying", f"{model.name} never locked its IOS"
    return sess, res.outputs


@pytest.fixture(scope="module")
def recorded():
    """One replay-locked rrto session per zoo model, in the port (real
    execution on the CPU) and in the JAX package (its last outputs)."""
    from repro.core.offload import OffloadSession as JSession
    from repro.models.cnn_zoo import ZOO as JZOO

    out = {}
    for name, kwargs in REGISTRY_CASES.items():
        jmodel = JZOO[name](**kwargs)
        model = ZOO[name](**kwargs, device="cpu")
        for a, b in zip(model.example_inputs, jmodel.example_inputs):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        jsess = JSession(jmodel, "rrto", min_repeats=2)
        jsess.load()
        for _ in range(5):
            jres = jsess.infer(*jmodel.example_inputs)
        sess, outs = lock(model)
        out[name] = (sess, outs, [np.asarray(o) for o in jres.outputs])
    return out


class TestSplitEquivalence:
    @pytest.mark.parametrize("name", sorted(REGISTRY_CASES))
    def test_random_plans_bitwise_identical(self, recorded, name):
        """For any plan, segmented device/server execution is bitwise the
        full-server replay (which is within 2e-4 of the JAX package's)."""
        sess, ref_outputs, jax_outputs = recorded[name]
        _near_reference(ref_outputs, jax_outputs)
        calls = sess.client._ios_calls
        env = sess.server.context(sess.client_id).env
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        n_ops = SegmentGraph(calls).n_ops
        plans = random_plans(n_ops, rng) + [
            SplitPlan.full_device(n_ops),
            SplitPlan.from_placements([PLACE_DEVICE] + [PLACE_SERVER] * (n_ops - 1)),
            SplitPlan.from_placements([PLACE_SERVER] * (n_ops - 1) + [PLACE_DEVICE]),
        ]
        inputs = sess.replay_wire_inputs(sess.model.example_inputs)
        for plan in plans:
            outs = BoundSegmentedReplay.from_own(SegmentedReplayProgram(calls, plan)).execute(
                inputs, env)
            assert _equal(outs, ref_outputs), f"{name}: plan {plan.signature()} diverged"

    def test_rebinding_across_clients(self, recorded):
        """A segmented program built from one client's calls runs correctly
        bound to a second client's address space."""
        name = "sensor_encoder"
        model = ZOO[name](**REGISTRY_CASES[name], device="cpu")
        sess_b, outs_b = lock(model, seed=3)
        sess_a = recorded[name][0]
        n_ops = SegmentGraph(sess_a.client._ios_calls).n_ops
        plan = SplitPlan.from_placements([PLACE_DEVICE] * 3 + [PLACE_SERVER] * (n_ops - 3))
        prog = SegmentedReplayProgram(sess_a.client._ios_calls, plan)
        bound = BoundSegmentedReplay.bind(prog, sess_b.client._ios_calls)
        outs = bound.execute(
            sess_b.replay_wire_inputs(model.example_inputs),
            sess_b.server.context(sess_b.client_id).env,
        )
        assert _equal(outs, outs_b)


class TestSegmentGraph:
    def test_cut_tensor_flow(self, recorded):
        """Whatever a suffix needs that is not an input is exported by the
        prefix: the dependency closure seals every cut."""
        graph = SegmentGraph(recorded["resnet50"][0].client._ios_calls)
        n = graph.n_ops
        for b in (1, n // 3, n // 2, n - 1):
            exported = set(graph.segment_outputs(Segment(0, b, PLACE_DEVICE)))
            inputs = set(graph.input_tids)
            for tid in graph.segment_inputs(Segment(b, n, PLACE_SERVER)):
                assert tid in exported or tid in inputs

    def test_live_bytes_boundaries(self, recorded):
        graph = SegmentGraph(recorded["vgg16"][0].client._ios_calls)
        live = graph.live_bytes()
        assert len(live) == graph.n_ops + 1
        in_bytes = sum(graph.tensors[t].nbytes for t in graph.input_tids)
        out_bytes = sum(graph.tensors[t].nbytes for t in graph.output_tids)
        assert live[0] == pytest.approx(in_bytes)
        assert live[-1] >= out_bytes
        assert all(b >= 0 for b in live)

    def test_params_never_cross(self, recorded):
        """Neither a parameter nor a tensor computed only from parameters is
        ever read across a cut."""
        graph = SegmentGraph(recorded["vgg16"][0].client._ios_calls)
        for reads in graph.reads:
            for tid in reads:
                assert not graph.tensors[tid].resident
        for b in range(1, graph.n_ops):
            for tid in graph.segment_inputs(Segment(b, graph.n_ops, PLACE_SERVER)):
                assert not graph.tensors[tid].resident


class TestPlanner:
    def test_never_worse_than_binary_offloading(self, recorded):
        for name, (sess, _, _) in recorded.items():
            graph = SegmentGraph(sess.client._ios_calls)
            n = graph.n_ops
            div = sess.model.input_wire_divisor
            for mbps in (0.5, 4.0, 16.0, 64.0, 256.0):
                best = plan_partition(graph, sess.client_device, sess.server_device,
                                      mbps * MBPS, input_wire_divisor=div)
                for endpoint in (SplitPlan.full_server(n), SplitPlan.full_device(n)):
                    ev = evaluate_plan(graph, endpoint, sess.client_device, sess.server_device,
                                       mbps * MBPS, input_wire_divisor=div)
                    assert best.seconds <= ev.seconds + 1e-12, (
                        f"{name}@{mbps}Mbps: planner worse than {endpoint.signature()}")

    def test_interior_split_beats_both_endpoints(self, sweep_graph, reference_sweep):
        """The bandwidth-bottleneck workload of the partition sweep has a
        regime where a true split strictly beats full offload and device
        only, in the port as in the JAX package."""
        graph, device, server, model = sweep_graph
        n, div = graph.n_ops, model.input_wire_divisor
        rows = []
        for mbps in SWEEP_MBPS:
            best = plan_partition(graph, device, server, mbps * MBPS, input_wire_divisor=div)
            ends = [evaluate_plan(graph, p, device, server, mbps * MBPS, input_wire_divisor=div)
                    for p in (SplitPlan.full_server(n), SplitPlan.full_device(n))]
            rows.append((best, min(e.seconds for e in ends)))
        assert all(best.seconds <= end + 1e-12 for best, end in rows)
        assert any(best.seconds < end * (1 - 1e-6) for best, end in rows[1:-1])
        assert any(0 < best.plan.n_device_ops < n for best, _ in rows)
        assert reference_sweep["interior_strictly_better"]

    def test_energy_objective(self, recorded):
        sess = recorded["sensor_encoder"][0]
        graph = SegmentGraph(sess.client._ios_calls)
        best = plan_partition(graph, sess.client_device, sess.server_device, 16 * MBPS,
                              config=PartitionConfig(objective="energy"))
        assert best.plan.objective == "energy"
        for endpoint in (SplitPlan.full_server(graph.n_ops), SplitPlan.full_device(graph.n_ops)):
            ev = evaluate_plan(graph, endpoint, sess.client_device, sess.server_device, 16 * MBPS)
            assert best.joules <= ev.joules + 1e-12

    def test_plan_validation(self):
        with pytest.raises(ValueError):
            SplitPlan.from_placements([])
        with pytest.raises(ValueError):
            PartitionConfig(objective="carbon")
        plan = SplitPlan.from_placements([PLACE_DEVICE, PLACE_DEVICE, PLACE_SERVER])
        assert plan.signature() == "D0:2|S2:3"
        assert plan.n_device_ops == 2 and not plan.is_full_server
        assert SplitPlan.full_server(4).is_full_server
        assert SplitPlan.parse_signature(plan.signature()) == plan
        for bad in ("D0:2|D2:3", "S1:3", "X0:3", "D0:x"):
            with pytest.raises(ValueError):
                SplitPlan.parse_signature(bad)


@pytest.fixture(scope="module")
def sweep_graph():
    """The sweep's workload recorded in an account-only session."""
    model = make_sensor_encoder(**SWEEP_MODEL, device="cpu")
    sess = OffloadSession(model, "rrto", environment="indoor", execute=False, device="cpu")
    sess.load()
    for _ in range(5):
        sess.infer(*model.example_inputs)
    assert sess.client.ios is not None
    return SegmentGraph(sess.client._ios_calls), sess.client_device, sess.server_device, model


@pytest.fixture(scope="module")
def reference_sweep():
    """The JAX package's planner over the same sweep (the checks of
    ``benchmarks/partition_sweep.py::run``)."""
    from repro.core.offload import OffloadSession as JSession
    from repro.models.cnn_zoo import make_sensor_encoder as j_sensor_encoder
    from repro.partition import SegmentGraph as JGraph
    from repro.partition import SplitPlan as JPlan
    from repro.partition import evaluate_plan as j_evaluate
    from repro.partition import plan_partition as j_plan

    model = j_sensor_encoder(**SWEEP_MODEL)
    sess = JSession(model, "rrto", environment="indoor", execute=False)
    sess.load()
    for _ in range(5):
        sess.infer(*model.example_inputs)
    graph = JGraph(sess.client._ios_calls)
    n, div = graph.n_ops, model.input_wire_divisor
    better = []
    for mbps in SWEEP_MBPS[1:-1]:
        best = j_plan(graph, sess.client_device, sess.server_device, mbps * MBPS,
                      input_wire_divisor=div)
        end = min(j_evaluate(graph, p, sess.client_device, sess.server_device, mbps * MBPS,
                             input_wire_divisor=div).seconds
                  for p in (JPlan.full_server(n), JPlan.full_device(n)))
        better.append(best.seconds < end * (1 - 1e-6))
    return {"interior_strictly_better": any(better)}


class TestAdaptive:
    def _replanner(self, sweep_graph, **cfg_kwargs):
        graph, device, server, model = sweep_graph
        cfg = PartitionConfig(min_replan_interval_s=0.0, **cfg_kwargs)
        return AdaptiveReplanner(graph, device, server, config=cfg,
                                 input_wire_divisor=model.input_wire_divisor)

    def test_bandwidth_collapse_triggers_replan(self, sweep_graph):
        rp = self._replanner(sweep_graph, bandwidth_ema=1.0)
        rich = rp.initial_plan(128 * MBPS)
        assert not rich.is_full_device  # a fat link offloads the trunk
        swapped = rp.observe(0.2 * MBPS, now=1.0)
        assert swapped is not None and swapped.n_device_ops > rich.n_device_ops
        assert rp.stats.replans == 1

    def test_hysteresis_prevents_thrash(self, sweep_graph):
        # hysteresis=1.0 demands an infinite relative gain: any candidate,
        # even at a collapsed link, is rejected
        rp = self._replanner(sweep_graph, bandwidth_ema=1.0, hysteresis=1.0)
        rp.initial_plan(128 * MBPS)
        assert rp.observe(0.2 * MBPS, now=1.0) is None
        assert rp.stats.replans == 0
        assert rp.stats.rejected_by_hysteresis >= 1

    def test_mild_wobble_does_not_swap(self, sweep_graph):
        """Near-noise bandwidth variation re-plans to the same cut."""
        rp = self._replanner(sweep_graph, bandwidth_ema=1.0)
        first = rp.initial_plan(64 * MBPS)
        for i, mbps in enumerate((60.0, 68.0, 63.0, 66.0)):
            assert rp.observe(mbps * MBPS, now=1.0 + i) is None
        assert rp.stats.replans == 0
        assert rp.current.plan.signature() == first.signature()

    def test_replan_rate_limit(self, sweep_graph):
        graph, device, server, _ = sweep_graph
        rp = AdaptiveReplanner(graph, device, server,
                               config=PartitionConfig(min_replan_interval_s=10.0))
        rp.initial_plan(128 * MBPS, now=0.0)
        considered = rp.stats.plans_considered
        assert rp.observe(0.2 * MBPS, now=0.5) is None   # inside the window
        assert rp.stats.plans_considered == considered
        rp.observe(0.2 * MBPS, now=11.0)                 # window elapsed
        assert rp.stats.plans_considered > considered


class TestPlanKeyedCache:
    def test_cache_keys_on_fingerprint_and_plan(self, recorded):
        from repro_torch.serving.replay_cache import ReplayCache, base_fingerprint

        sess = recorded["sensor_encoder"][0]
        calls = sess.client._ios_calls
        server = sess.server
        server.replay_cache = cache = ReplayCache(capacity=8)
        try:
            fp = "f" * 8
            n = SegmentGraph(calls).n_ops
            plan_a = SplitPlan.from_placements([PLACE_DEVICE] * 2 + [PLACE_SERVER] * (n - 2))
            plan_b = SplitPlan.from_placements([PLACE_DEVICE] * 4 + [PLACE_SERVER] * (n - 4))
            compiles0 = server.compile_count
            server.prepare_split(calls, plan_a, "c0", fp)
            server.prepare_split(calls, plan_b, "c0", fp)
            assert server.compile_count == compiles0 + 2
            assert f"{fp}|{plan_a.signature()}" in cache
            assert f"{fp}|{plan_b.signature()}" in cache
            assert base_fingerprint(f"{fp}|{plan_a.signature()}") == fp
            # a co-tenant adopting plan_a binds the cached program
            assert server.prepare_split(calls, plan_a, "c1", fp) is True
            assert server.compile_count == compiles0 + 2
        finally:
            server.replay_cache = None


class TestPartitionedSession:
    def test_outputs_match_plain_rrto(self):
        """A split session's outputs are bitwise the plain rrto session's
        in the port, and within 2e-4 of the JAX package's split session."""
        from repro.core.offload import OffloadSession as JSession
        from repro.models.cnn_zoo import ZOO as JZOO
        from repro.partition import PartitionConfig as JConfig

        name = "sensor_encoder"
        model = ZOO[name](**REGISTRY_CASES[name], device="cpu")
        jmodel = JZOO[name](**REGISTRY_CASES[name])
        plain = OffloadSession(model, "rrto", min_repeats=2, seed=0, device="cpu")
        split = OffloadSession(model, "rrto", min_repeats=2, seed=0, device="cpu",
                               partition=PartitionConfig())
        jsplit = JSession(jmodel, "rrto", min_repeats=2, seed=0, partition=JConfig())
        for _ in range(6):
            want = plain.infer(*model.example_inputs)
            got = split.infer(*model.example_inputs)
            assert _equal(got.outputs, want.outputs)
            _near_reference(got.outputs, jsplit.infer(*jmodel.example_inputs).outputs)
        assert split.client.mode == "replaying"
        assert split.client.replanner is not None
        assert split.client.split_plan is not None

    def test_full_device_plan_needs_no_network(self):
        """When the planner keeps everything on the device (tiny model), the
        replay phase issues no RPC and moves no byte."""
        from repro_torch.core.energy import STATE_INFERENCE

        rng = np.random.default_rng(0)
        params = {"w": torch.from_numpy(rng.normal(0, 0.1, (16, 4)).astype(np.float32))}
        x = torch.from_numpy(rng.normal(0, 1, (2, 16)).astype(np.float32))
        model = OffloadableModel("tiny", lambda p, x: [torch.tanh(x @ p["w"])], params, (x,))
        sess = OffloadSession(model, "rrto", min_repeats=2, device="cpu",
                              partition=PartitionConfig())
        sess.load()
        for _ in range(6):
            res = sess.infer(x)
        assert res.mode == "replaying"
        assert sess.client.split_plan is not None and sess.client.split_plan.is_full_device
        assert res.rpcs == 0 and res.network_bytes == 0
        assert torch.equal(res.outputs[0], torch.tanh(x @ params["w"]))
        assert sess.meter.seconds_by_state.get(STATE_INFERENCE, 0.0) > 0

    def test_split_session_fallback_recovers(self):
        """A DAM-style op-stream change mid-replay falls back cleanly though
        split mode never uploaded the inputs, then re-locks."""
        from repro_torch.core.costmodel import GTX_2080TI
        from repro_torch.core.energy import EnergyMeter
        from repro_torch.core.engine import OffloadServer, RRTOClient, SimClock
        from repro_torch.core.flatten import trace_app
        from repro_torch.core.intercept import NO_NOISE, GraphInterceptor
        from repro_torch.core.netsim import indoor_network

        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.normal(0, 0.1, (8, 8)).astype(np.float32))
        x = torch.from_numpy(rng.normal(0, 1, (2, 8)).astype(np.float32))

        def graph_a(ls, xx):
            return [torch.tanh(xx @ ls[0]) @ ls[0]]

        def graph_b(ls, xx):
            return [torch.relu(xx @ ls[0]) + xx.sum(dim=-1, keepdim=True)]

        ga, gb = trace_app(graph_a, [w], [x]), trace_app(graph_b, [w], [x])
        client = RRTOClient(
            OffloadServer(GTX_2080TI, device=torch.device("cpu")), indoor_network(),
            SimClock(), EnergyMeter(), min_repeats=2, partition=PartitionConfig(),
        )
        icp = GraphInterceptor(client, NO_NOISE)
        addrs = icp.upload_params([w])
        for _ in range(4):
            (out_a,) = icp.run(ga, addrs, [x])
        assert client.mode == "replaying"
        assert client.split_plan is not None  # tiny graph -> device plan
        assert torch.equal(out_a, graph_a([w], x)[0])
        icp.run(gb, addrs, [x])  # deviate
        assert client.fallbacks >= 1 and client.mode == "recording"
        for _ in range(4):
            (out_b,) = icp.run(gb, addrs, [x])
        assert client.mode == "replaying"
        assert torch.equal(out_b, graph_b([w], x)[0])


class TestMultiTenantPlans:
    def test_cotenants_on_different_networks_get_different_cuts(self):
        """Two clients share one IOS but plan at different bandwidths: the
        edge cache keys segment programs on (fingerprint, plan), and each
        client runs its own cut."""
        from repro_torch.serving.multitenant import RRTOEdgeServer

        model = make_sensor_encoder(**SWEEP_MODEL, device="cpu")
        edge = RRTOEdgeServer(execute=False, device="cpu")
        rich = edge.connect(model, partition=PartitionConfig())
        poor = edge.connect(model, partition=PartitionConfig())
        # starve the second client's radio: ~0.4 Mbps flat
        poor.network.trace_bytes_per_s = np.full(16, 0.4 * MBPS)
        x = model.example_inputs
        for _ in range(6):
            edge.run_round({"c0": x, "c1": x})
        assert all(s.client.mode == "replaying" for s in edge.sessions.values())
        assert rich.client.ios_fp == poor.client.ios_fp
        rich_plan, poor_plan = rich.client.split_plan, poor.client.split_plan
        assert poor_plan is not None
        assert rich_plan is None or rich_plan.signature() != poor_plan.signature()
        # the poor client keeps the trunk on the device, the rich one offloads
        assert poor_plan.n_device_ops > (rich_plan.n_device_ops if rich_plan else 0)
        # the shared cache holds the full program and the per-plan programs
        assert len(edge.cache) >= 2
        assert f"{poor.client.ios_fp}|{poor_plan.signature()}" in edge.cache
