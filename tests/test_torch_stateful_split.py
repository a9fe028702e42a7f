"""Stateful split replay in the port (tests/test_stateful_split.py, and
``tests/test_multitenant.py::TestServerSegmentBatching``): for any
carried-feasible plan, the segment walk with the stateful server suffix is
bitwise the stateful full-server replay, step for step, on an RNN, the
recurrent sensor decoder and the KV-cached decode of the reference's
``DECODE_CFG`` (the custom ops' plain versions on the CPU); feasibility
edge cases; parameter views never on the wire; persistence of ``fp|plan``
entries with their carried pairs; plan swaps that keep the state; the
split-aware DAM fallback (exact where the JAX package's catch-up is not);
pipelined stateful streaming; and co-tenant server-segment batching.  The
port runs on the JAX package's numpy parameters and inputs, and its split
sessions are held within 2e-4 of the JAX package's rrto sessions (the
decode's tokens equal)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import BoundSegmentedReplay, SegmentedReplayProgram  # noqa: E402
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.models.cnn_zoo import make_recurrent_sensor_decoder  # noqa: E402
from repro_torch.partition import (  # noqa: E402
    PLACE_DEVICE,
    PLACE_SERVER,
    PartitionConfig,
    SegmentGraph,
    SplitPlan,
    plan_partition,
)
from repro_torch.partition.segments import Segment  # noqa: E402
from repro_torch.serving.multitenant import RRTOEdgeServer  # noqa: E402

MBPS = 1e6 / 8.0
TOL = 2e-4
DECODE_FIELDS = dict(
    name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=256, dtype="float32", rope_theta=1e4,
)
DECODER = dict(scale=0.25, input_size=32, n_blocks=2, d_state=32)


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _rnn_params(seed=0, d=8, batch=2):
    rng = np.random.default_rng(seed)
    w_in = rng.normal(0, 0.1, (d, d)).astype(np.float32)
    w = rng.normal(0, 0.1, (d, d)).astype(np.float32)
    x = rng.normal(0, 1, (batch, d)).astype(np.float32)
    return w_in, w, x, np.zeros((batch, d), np.float32)


def make_rnn(seed=0, d=8, batch=2):
    """An RNN with a stateless input encoder (the prologue a split can keep
    on the device) ahead of the carried-state cell."""
    w_in, w, x, state0 = _rnn_params(seed, d, batch)
    params = {"w_in": torch.from_numpy(w_in), "w": torch.from_numpy(w)}

    def apply(p, x, state):
        z = torch.tanh(x @ p["w_in"])             # stateless prologue
        new_state = torch.tanh(state @ p["w"] + z)
        return [new_state.sum(dim=1), new_state]

    return OffloadableModel(f"rnn{seed}", apply, params, (x, state0)), x, state0


def lock_stateful_session(model, inputs, state_in=1, state_out=1, steps=5, min_repeats=3,
                          **kw):
    """Drive a stateful app to replay lock, threading the carried state
    (input ``state_in`` <- output ``state_out``)."""
    sess = OffloadSession(model, "rrto", min_repeats=min_repeats, device="cpu", **kw)
    sess.load()
    args = list(inputs)
    for _ in range(steps):
        res = sess.infer(*args)
        args[state_in] = res.outputs[state_out]
    assert sess.client.mode == "replaying", "IOS never locked"
    assert sess.client.stateful_replay, "carried state not detected"
    return sess


def decoder(**kw):
    return make_recurrent_sensor_decoder(**DECODER, device="cpu", **kw)


def lock_decoder(**kw):
    model = decoder()
    return model, lock_stateful_session(model, model.example_inputs, min_repeats=2, **kw)


@pytest.fixture(scope="module")
def decode():
    """The KV-cached decode on the reference's DECODE_CFG, with the JAX
    package's parameters: the port's locked session and both packages'
    tokens."""
    import jax

    from repro.configs.base import ArchConfig as JArchConfig
    from repro.models import lm as jlm
    from repro.serving.engine import RRTOServedLM as JRRTOServedLM
    from repro_torch.configs.base import ArchConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.engine import RRTOServedLM

    cfg_j, cfg = JArchConfig(**DECODE_FIELDS), ArchConfig(**DECODE_FIELDS)
    prompt = np.random.default_rng(0).integers(0, 256, (1, 4)).astype(np.int32)
    j_tokens = JRRTOServedLM(cfg_j, bucket_len=16, batch=1, seed=3, min_repeats=3).generate(
        prompt, 8).tokens
    params = params_from_numpy(
        jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3), cfg_j)), cfg, "cpu")
    served = RRTOServedLM(cfg, bucket_len=16, batch=1, params=params, min_repeats=3,
                          device="cpu")
    tokens = served.generate(prompt, 8).tokens
    sess = served.session
    assert sess.client.mode == "replaying" and sess.client.stateful_replay
    return dict(cfg=cfg, params=params, prompt=prompt, j_tokens=j_tokens, tokens=tokens,
                sess=sess)


def feasible_plans(graph, max_plans=4):
    """A spread of carried-feasible device-prefix / server-suffix plans."""
    n = graph.n_ops
    bmax = min(graph.carried_cut_limit(), n - 1)
    if bmax < 1:
        return []
    bounds = sorted({1, max(1, bmax // 2), bmax})[:max_plans]
    return [SplitPlan.from_placements([PLACE_DEVICE] * b + [PLACE_SERVER] * (n - b))
            for b in bounds]


class TestStatefulSplitEquivalence:
    """Stateful split replay is bitwise the stateful full-server replay,
    step for step, outputs and carried state."""

    def _assert_bitwise(self, sess, steps=4):
        client = sess.client
        calls, pairs = client._ios_calls, client.ios.carried_pairs
        ctx = sess.server.context(sess.client_id)
        env, ref_bound = ctx.env, ctx.replay
        params_flat = [env[a] for a in ref_bound.param_addrs]
        state0 = [s.clone() for s in ref_bound.carried_state]
        wire = sess.replay_wire_inputs(sess.model.example_inputs)
        plans = feasible_plans(SegmentGraph(calls, carried_pairs=pairs))
        assert plans, "no feasible device prefix in this workload"
        for plan in plans:
            bound = BoundSegmentedReplay.from_own(
                SegmentedReplayProgram(calls, plan, carried_pairs=pairs))
            bound.carried_state = [s.clone() for s in state0]
            ref_state = [s.clone() for s in state0]
            split_env = dict(env)
            for step in range(steps):
                ref_outs, ref_state = ref_bound.program.step_fn(params_flat, wire, ref_state)
                outs = bound.execute(wire, split_env)
                assert _equal(outs, ref_outs), f"plan {plan.signature()} diverged at {step}"
                assert _equal(bound.carried_state, ref_state), (
                    f"plan {plan.signature()} state diverged at {step}")

    def test_rnn_bitwise(self):
        model, x, state0 = make_rnn()
        self._assert_bitwise(lock_stateful_session(model, (x, state0)))

    def test_recurrent_sensor_decoder_bitwise(self):
        self._assert_bitwise(lock_decoder()[1])

    def test_kv_cached_decode_bitwise(self, decode):
        """Every KV-cache leaf is loop-carried; the split suffix advances
        the whole cache, and the port's tokens are the JAX package's."""
        assert np.array_equal(decode["tokens"], decode["j_tokens"])
        sess = decode["sess"]
        assert len(sess.client.ios.carried_pairs) >= 2
        self._assert_bitwise(sess, steps=3)

    def test_rebinding_across_clients(self):
        """A stateful segmented program built from one client's calls runs
        bound to a second client's address space, with its own state."""
        model, x, state0 = make_rnn()
        sess_a = lock_stateful_session(model, (x, state0))
        sess_b = lock_stateful_session(model, (x, state0), seed=5)
        pairs = sess_a.client.ios.carried_pairs
        plan = feasible_plans(SegmentGraph(sess_a.client._ios_calls, carried_pairs=pairs))[-1]
        prog = SegmentedReplayProgram(sess_a.client._ios_calls, plan, carried_pairs=pairs)
        bound = BoundSegmentedReplay.bind(prog, sess_b.client._ios_calls)
        env_b = sess_b.server.context(sess_b.client_id).env
        bound.seed_carried(env_b)
        assert bound.carried_state is not None
        ref_bound = sess_b.server.context(sess_b.client_id).replay
        state0_b = [s.clone() for s in ref_bound.carried_state]
        bound.carried_state = [s.clone() for s in state0_b]
        wire = sess_b.replay_wire_inputs(model.example_inputs)
        params_flat = [env_b[a] for a in ref_bound.param_addrs]
        ref_outs, _ = ref_bound.program.step_fn(params_flat, wire, state0_b)
        assert _equal(bound.execute(wire, env_b), ref_outs)


class TestCarriedFeasibility:
    def test_first_op_carried_returns_full_server(self):
        """An IOS whose first op consumes carried state has no feasible
        device prefix: the planner returns the full-server endpoint."""
        rng = np.random.default_rng(0)
        w = rng.normal(0, 0.1, (8, 8)).astype(np.float32)

        def apply(p, state, x):
            new_state = torch.tanh(state @ p["w"] + x)   # op 0 reads the state
            return [new_state.sum(dim=1), new_state]

        x = rng.normal(0, 1, (2, 8)).astype(np.float32)
        state0 = np.zeros((2, 8), np.float32)
        model = OffloadableModel("first_carried", apply, {"w": torch.from_numpy(w)}, (state0, x))
        sess = lock_stateful_session(model, (state0, x), state_in=0, state_out=1,
                                     partition=PartitionConfig())
        client = sess.client
        graph = client.replanner.graph
        assert graph.carried_cut_limit() == 0
        ev = plan_partition(graph, sess.client_device, sess.server_device, 16 * MBPS)
        assert ev.plan.is_full_server
        assert client.split_plan is None      # the live session holds full-server
        state_ref = torch.zeros(2, 8)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        for _ in range(len(sess.history)):
            _, state_ref = apply({"w": wt}, state_ref, xt)
        state_arg = sess.history[-1].outputs[1]
        for _ in range(2):
            res = sess.infer(state_arg, x)
            state_arg = res.outputs[1]
            y_ref, state_ref = apply({"w": wt}, state_ref, xt)
            assert torch.equal(res.outputs[0], y_ref)

    def test_infeasible_plan_rejected_at_compile(self):
        model, x, state0 = make_rnn()
        sess = lock_stateful_session(model, (x, state0))
        pairs, calls = sess.client.ios.carried_pairs, sess.client._ios_calls
        graph = SegmentGraph(calls, carried_pairs=pairs)
        # a device suffix strands the carried region on the device side
        bad = SplitPlan.from_placements([PLACE_SERVER] * (graph.n_ops - 1) + [PLACE_DEVICE])
        assert not graph.plan_carried_feasible(bad)
        with pytest.raises(ValueError, match="carried-feasible"):
            SegmentedReplayProgram(calls, bad, carried_pairs=pairs)

    def test_planner_only_feasible_plans_across_bandwidths(self):
        _, sess = lock_decoder()
        graph = SegmentGraph(sess.client._ios_calls, carried_pairs=sess.client.ios.carried_pairs)
        for mbps in (0.5, 8.0, 64.0, 512.0):
            ev = plan_partition(graph, sess.client_device, sess.server_device, mbps * MBPS)
            assert graph.plan_carried_feasible(ev.plan)
            assert not ev.plan.is_full_device


class TestWeightViews:
    def test_layer_weight_views_never_cross(self, decode):
        """The decode slices each layer's weights out of the stacked
        parameters (one ``select`` per leaf): those views are computed from
        parameters alone, so the longest feasible prefix ships exactly the
        embedding row and the position — not a layer's weights."""
        sess, cfg = decode["sess"], decode["cfg"]
        graph = SegmentGraph(sess.client._ios_calls, carried_pairs=sess.client.ios.carried_pairs)
        limit = graph.carried_cut_limit()
        kernels = [c.op for c in sess.client._ios_calls if c.op is not None]
        assert kernels[0] == torch.ops.aten.index.Tensor           # the embedding gather
        assert all(graph.tensors[t].derived for k in range(1, limit)
                   for t in graph.ops[k].out_tids)                 # weight views only
        suffix = Segment(limit, graph.n_ops, PLACE_SERVER)
        boundary = [t for t in graph.segment_inputs(suffix) if not graph.tensors[t].is_carried]
        embedding_row = cfg.d_model * 4                                  # (1, 1, d) f32
        position = 4                                                     # int32 scalar
        assert sorted(graph.tensors[t].nbytes for t in boundary) == [position, embedding_row]
        assert graph.live_bytes()[limit] == embedding_row + position
        # without the rule the prefix would ship every sliced weight
        sliced = sum(graph.tensors[t].nbytes for k in range(1, limit)
                     for t in graph.ops[k].out_tids)
        assert sliced > 100 * (embedding_row + position)


class TestStatefulSplitSession:
    """A stateful session on an installed split plan keeps the state
    server-resident and tracks the plain stateful session bitwise."""

    def _locked_pair(self):
        model, plain = lock_decoder(seed=0)
        _, split = lock_decoder(seed=0, partition=PartitionConfig(adaptive=False))
        graph = SegmentGraph(split.client._ios_calls, carried_pairs=split.client.ios.carried_pairs)
        plan = feasible_plans(graph)[-1]
        split.client._install_plan(plan)
        return model, plain, split, plan

    def test_outputs_match_plain_stateful(self):
        """Bitwise the plain stateful session, and within 2e-4 of the JAX
        package's split session on the same parameters and frames."""
        from repro.models.cnn_zoo import make_recurrent_sensor_decoder as j_decoder
        from repro.partition import PartitionConfig as JConfig
        from repro.partition import SegmentGraph as JGraph
        from repro.core.offload import OffloadSession as JSession

        model, plain, split, plan = self._locked_pair()
        jmodel = j_decoder(**DECODER)
        jsess = JSession(jmodel, "rrto", min_repeats=2, seed=0,
                         partition=JConfig(adaptive=False))
        jargs = list(jmodel.example_inputs)
        for _ in range(5):
            jargs[1] = jsess.infer(*jargs).outputs[1]
        jgraph = JGraph(jsess.client._ios_calls, carried_pairs=jsess.client.ios.carried_pairs)
        jsess.client._install_plan(feasible_plans(jgraph)[-1])
        assert split.client.split_plan is not None
        frame = model.example_inputs[0]
        h_plain = plain.history[-1].outputs[1]
        h_split = split.history[-1].outputs[1]
        for _ in range(4):
            want = plain.infer(frame, h_plain)
            got = split.infer(frame, h_split)
            jgot = jsess.infer(jargs[0], jargs[1])
            h_plain, h_split, jargs[1] = want.outputs[1], got.outputs[1], jgot.outputs[1]
            assert torch.equal(got.outputs[0], want.outputs[0])
            np.testing.assert_allclose(got.outputs[0].numpy(), np.asarray(jgot.outputs[0]),
                                       rtol=TOL, atol=TOL)

    def test_state_never_crosses_on_split(self):
        """Steady split replay bills only the boundary tensors and the wire
        output: neither the carried state nor the raw frame (held back by
        the device prefix)."""
        model, plain, split, plan = self._locked_pair()
        frame = model.example_inputs[0]
        res1 = split.infer(frame, split.history[-1].outputs[1])
        res2 = split.infer(frame, res1.outputs[1])
        assert res2.network_bytes == res1.network_bytes
        assert res2.network_bytes < frame.nbytes
        full = plain.infer(frame, plain.history[-1].outputs[1])
        assert res2.network_bytes < full.network_bytes

    def test_plan_swap_preserves_state(self):
        """Swapping split -> full-server -> split mid-session moves the live
        state between the bindings: outputs keep tracking the plain run."""
        model, plain, split, plan = self._locked_pair()
        frame = model.example_inputs[0]
        h_plain = plain.history[-1].outputs[1]
        h_split = split.history[-1].outputs[1]
        n = SegmentGraph(split.client._ios_calls).n_ops
        for swap_to in (SplitPlan.full_server(n), plan, SplitPlan.full_server(n), plan):
            want = plain.infer(frame, h_plain)
            got = split.infer(frame, h_split)
            h_plain, h_split = want.outputs[1], got.outputs[1]
            assert torch.equal(got.outputs[0], want.outputs[0])
            split.client._install_plan(swap_to)
        want = plain.infer(frame, h_plain)
        got = split.infer(frame, h_split)
        assert torch.equal(got.outputs[0], want.outputs[0])

    def test_fresh_state_reships_once_on_split(self):
        """New state mid-split-session overrides the resident suffix state
        with exactly one extra RPC, as on the full-server path."""
        model, plain, split, plan = self._locked_pair()
        frame = model.example_inputs[0]
        steady = split.infer(frame, split.history[-1].outputs[1])
        fresh = np.full_like(model.example_inputs[1], 0.125)
        res = split.infer(frame, fresh)
        assert res.rpcs == steady.rpcs + 1
        with torch.no_grad():
            want_y, _ = model.apply(model.params, torch.from_numpy(frame), torch.from_numpy(fresh))
        torch.testing.assert_close(res.outputs[0], want_y, rtol=1e-5, atol=1e-6)


def _raw_client(partition):
    from repro_torch.core.costmodel import GTX_2080TI
    from repro_torch.core.energy import EnergyMeter
    from repro_torch.core.engine import OffloadServer, RRTOClient, SimClock
    from repro_torch.core.netsim import indoor_network

    return RRTOClient(OffloadServer(GTX_2080TI, device=torch.device("cpu")), indoor_network(),
                      SimClock(), EnergyMeter(), min_repeats=2, partition=partition)


class TestStatefulSplitFallback:
    def test_materializer_reads_split_suffix_state(self):
        """After split steps the live state is the split binding's: the DAM
        materializer downloads that, not the whole program's lock-time
        state."""
        from repro_torch.core.records import FUNC_H2D

        _, sess = lock_decoder(partition=PartitionConfig(adaptive=False, pipelined=True))
        client = sess.client
        graph = SegmentGraph(client._ios_calls, carried_pairs=client.ios.carried_pairs)
        client._install_plan(feasible_plans(graph)[-1])
        assert client.pipelined_exec is not None
        frame = sess.model.example_inputs[0]
        h = sess.history[-1].outputs[1]
        for _ in range(3):
            h = sess.infer(frame, h).outputs[1]
        ctx = sess.server.context(client.client_id)
        live = ctx.split.carried_state[0].clone()
        assert not torch.equal(live, ctx.replay.carried_state[0])  # split advanced

        ph = client._carried_placeholders[0]
        h2d_calls = [c for c in client._ios_calls if c.record.func == FUNC_H2D]
        carried_ordinal = next(iter(client._carried_in_map))
        client._replay_prefix = list(h2d_calls)
        client._replay_prefix[carried_ordinal].h2d_value = ph
        rpcs0 = client.stats.rpcs
        client._materialize_carried_prefix()
        assert client.stats.rpcs == rpcs0 + 1
        assert torch.equal(ph, live)

    def test_dam_fallback_refreshes_handle_and_recovers(self):
        """A deviation on a pipelined stateful split session: the app-held
        handle is refreshed with the live state before the stream executor
        drops, and the recording continues from the true state (exactly:
        the port's catch-up re-runs the round from its input state)."""
        from repro_torch.core.flatten import trace_app
        from repro_torch.core.intercept import NO_NOISE, GraphInterceptor

        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.normal(0, 0.1, (8, 8)).astype(np.float32))
        x = torch.from_numpy(rng.normal(0, 1, (2, 8)).astype(np.float32))

        def graph_a(ls, xx, state):
            new = torch.tanh(torch.tanh(xx @ ls[0]) + state @ ls[0])
            return [new.sum(dim=1), new]

        def graph_b(ls, xx, state):
            new = torch.tanh(torch.relu(xx @ ls[0]) + state)
            return [new.sum(dim=1), new]

        state0 = torch.zeros(2, 8)
        ga, gb = (trace_app(g, [w], [x, state0]) for g in (graph_a, graph_b))
        client = _raw_client(PartitionConfig(adaptive=False, pipelined=True))
        icp = GraphInterceptor(client, NO_NOISE)
        addrs = icp.upload_params([w])
        state = state0
        for _ in range(5):
            state = icp.run(ga, addrs, [x, state])[1]
        assert client.mode == "replaying" and client.stateful_replay
        plans = feasible_plans(SegmentGraph(client._ios_calls,
                                            carried_pairs=client.ios.carried_pairs))
        assert plans
        client._install_plan(plans[-1])
        for _ in range(3):
            state = icp.run(ga, addrs, [x, state])[1]
        ref_state = state0
        for _ in range(8):
            _, ref_state = graph_a([w], x, ref_state)
        outs_b = icp.run(gb, addrs, [x, state])      # deviate
        assert client.fallbacks >= 1 and client.mode == "recording"
        assert client.pipelined_exec is None
        assert torch.equal(state, ref_state)          # the handle holds the truth
        assert torch.equal(outs_b[0], graph_b([w], x, ref_state)[0])

    def test_reference_fallback_fault_under_split(self):
        """The queue-C stateful fault on a split plan: a deviation after the
        round's step.  The JAX package's catch-up re-runs the round from the
        advanced state; the port's from the round's input state (exact)."""
        import jax
        import jax.numpy as jnp

        from repro.core.costmodel import GTX_2080TI as J_GTX
        from repro.core.energy import EnergyMeter as JMeter
        from repro.core.engine import OffloadServer as JServer
        from repro.core.engine import RRTOClient as JClient
        from repro.core.engine import SimClock as JClock
        from repro.core.flatten import flatten_closed_jaxpr
        from repro.core.intercept import NO_NOISE as J_NO_NOISE
        from repro.core.intercept import JaxprInterceptor
        from repro.core.netsim import indoor_network as j_indoor
        from repro.partition import PartitionConfig as JConfig
        from repro.partition import SegmentGraph as JGraph
        from repro_torch.core.flatten import trace_app
        from repro_torch.core.intercept import NO_NOISE, GraphInterceptor

        ws = np.eye(4, dtype=np.float32) * 0.5

        def ja(x, s):
            z = jnp.tanh(x @ ws)
            return [(z * s).sum().reshape(1), s + z]

        def jb(x, s):
            z = jnp.tanh(x @ ws)
            return [(z * s).sum().reshape(1) * 2.0, s + z]

        def ta(ls, x, s):
            z = torch.tanh(x @ ls[0])
            return [(z * s).sum().reshape(1), s + z]

        def tb(ls, x, s):
            z = torch.tanh(x @ ls[0])
            return [(z * s).sum().reshape(1) * 2.0, s + z]

        ex = [np.zeros((1, 4), np.float32)] * 2
        jgraphs = [flatten_closed_jaxpr(jax.make_jaxpr(f)(*ex)) for f in (ja, jb)]
        w = torch.from_numpy(ws)
        tgraphs = [trace_app(f, [w], [torch.from_numpy(e) for e in ex]) for f in (ta, tb)]
        jclient = JClient(JServer(J_GTX, execute=True), j_indoor(), JClock(), JMeter(),
                          variant="rrto", min_repeats=2, partition=JConfig(adaptive=False))
        jicp = JaxprInterceptor(jclient, J_NO_NOISE)
        jaddrs = [jicp.upload_params(list(g.consts)) for g in jgraphs]
        tclient = _raw_client(PartitionConfig(adaptive=False))
        ticp = GraphInterceptor(tclient, NO_NOISE)
        taddrs = ticp.upload_params([w])
        steps = [np.full((1, 4), float(i + 1), np.float32) for i in range(8)]
        jstate = truth = ex[1]
        tstate = torch.from_numpy(ex[1])
        for i, x in enumerate(steps):
            k = int(i == len(steps) - 1)
            if i == 5:   # locked: install the longest feasible prefix on both
                assert jclient.stateful_replay and tclient.stateful_replay
                jclient._install_plan(feasible_plans(JGraph(
                    jclient._ios_calls, carried_pairs=jclient.ios.carried_pairs))[-1])
                tclient._install_plan(feasible_plans(SegmentGraph(
                    tclient._ios_calls, carried_pairs=tclient.ios.carried_pairs))[-1])
            jout = jicp.run(jgraphs[k], jaddrs[k], [x, jstate])
            tout = ticp.run(tgraphs[k], taddrs, [torch.from_numpy(x), tstate])
            want = [np.asarray(v) for v in (ja, jb)[k](x, truth)]
            jstate, tstate, truth = jout[1], tout[1], want[1]
        assert jclient.fallbacks == tclient.fallbacks == 1
        assert tclient.split_plan is not None or tclient.mode == "recording"
        j_err = float(np.abs(np.asarray(jout[0]) - want[0]).max())
        t_err = float(np.abs(tout[0].numpy() - want[0]).max())
        print(f"split: reference max|d| {j_err:.4g}, port max|d| {t_err:.4g}")
        assert j_err > 1.0 and t_err < 1e-5


class TestStatefulPipelinedStream:
    def test_stream_bitwise_equals_sequential_split(self):
        """infer_stream over a stateful split plan advances the suffix state
        per submission, in order: bitwise the sequential split session."""
        model, seq = lock_decoder(seed=0, partition=PartitionConfig(adaptive=False))
        _, piped = lock_decoder(seed=0, partition=PartitionConfig(adaptive=False, pipelined=True))
        graph = SegmentGraph(piped.client._ios_calls, carried_pairs=piped.client.ios.carried_pairs)
        plan = feasible_plans(graph)[-1]
        seq.client._install_plan(plan)
        piped.client._install_plan(plan)
        assert piped.client.pipelined_exec is not None
        rng = np.random.default_rng(3)
        frame0 = model.example_inputs[0]
        frames = [frame0 + rng.normal(0, 0.01, frame0.shape).astype(np.float32) for _ in range(4)]
        h_seq = seq.history[-1].outputs[1]
        # the app threads the stable handle through the stream, as through
        # sequential infer() calls
        h_piped = piped.history[-1].outputs[1]
        results = piped.infer_stream([(f, h_piped) for f in frames])
        assert len(results) == len(frames)
        assert all(a.done_at <= b.done_at for a, b in zip(results, results[1:]))
        for r, f in zip(results, frames):
            want = seq.infer(f, h_seq)
            h_seq = want.outputs[1]
            assert len(r.outputs) == len(want.outputs)
            assert r.outputs[1] is h_piped
            assert torch.equal(r.outputs[0], want.outputs[0])

    def test_stream_fresh_state_override(self):
        """A non-handle state value in a stream arrival overwrites the
        resident suffix state (one extra billed RPC), as on the sequential
        path; the new handle then threads into the next window."""
        model, sess = lock_decoder(seed=0, partition=PartitionConfig(adaptive=False,
                                                                      pipelined=True))
        graph = SegmentGraph(sess.client._ios_calls, carried_pairs=sess.client.ios.carried_pairs)
        sess.client._install_plan(feasible_plans(graph)[-1])
        frame = model.example_inputs[0]
        fresh = np.full_like(model.example_inputs[1], 0.25)
        rpcs0 = sess.client.stats.rpcs
        results = sess.infer_stream([(frame, fresh)])
        assert sess.client.stats.rpcs > rpcs0  # override + boundary traffic
        results2 = sess.infer_stream([(frame, results[0].outputs[1])])
        with torch.no_grad():
            y1, h1 = model.apply(model.params, torch.from_numpy(frame), torch.from_numpy(fresh))
            y2, _ = model.apply(model.params, torch.from_numpy(frame), h1)
        torch.testing.assert_close(results[0].outputs[0], y1, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(results2[0].outputs[0], y2, rtol=1e-5, atol=1e-6)


class TestStreamExecutorClaims:
    def test_installed_stream_executor_pins_its_base(self):
        """While a pipelined stream executor is installed its fp|plan key
        holds a cache claim pinning the base program; reverting to
        full-server releases it."""
        model = decoder()
        edge = RRTOEdgeServer(device="cpu")
        sess = edge.connect(model, min_repeats=2,
                            partition=PartitionConfig(adaptive=False, pipelined=True))
        frame, state = model.example_inputs
        for _ in range(4):
            state = edge.run_round({"c0": (frame, state)})["c0"].outputs[1]
        client = sess.client
        assert client.mode == "replaying"
        edge.batcher.begin_round({})  # expire the last round's claims
        graph = SegmentGraph(client._ios_calls, carried_pairs=client.ios.carried_pairs)
        plan = feasible_plans(graph)[-1]
        client._install_plan(plan)
        assert client.pipelined_exec is not None
        fp = client.ios_fp
        assert client._stream_claim == f"{fp}|{plan.signature()}"
        assert edge.cache.is_pinned(fp)
        client._install_plan(SplitPlan.full_server(graph.n_ops))
        assert client.pipelined_exec is None and client._stream_claim is None
        assert not edge.cache.is_pinned(fp)


class TestStatefulSplitPersistence:
    def test_split_plan_roundtrip_rebuilds_state_and_signature(self, tmp_path):
        """ReplayCache.save/load of a stateful split entry: the fp|plan key
        persists the plan signature and the carried pairs, and a restarted
        server's prepare_split rebuilds a stateful segmented program from
        the metadata alone."""
        from repro_torch.core.costmodel import GTX_2080TI
        from repro_torch.core.engine import OffloadServer
        from repro_torch.serving.replay_cache import ReplayCache

        model, x, state0 = make_rnn()
        sess = lock_stateful_session(model, (x, state0))
        pairs, calls = sess.client.ios.carried_pairs, sess.client._ios_calls
        plan = feasible_plans(SegmentGraph(calls, carried_pairs=pairs))[-1]
        server = sess.server
        server.replay_cache = cache = ReplayCache(capacity=8)
        try:
            fp = "f" * 8
            server.prepare_split(calls, plan, "c0", fp, carried_pairs=pairs)
            key = f"{fp}|{plan.signature()}"
            assert key in cache
            path = str(tmp_path / "cache.json")
            cache.save(path)
            fresh = ReplayCache()
            fresh.load(path)
            meta = fresh.known_metadata(key)
            assert meta["plan"] == plan.signature()
            assert meta["carried_pairs"] == [[int(i), int(j)] for i, j in pairs]
            # a restarted server rebuilds it stateful from the metadata (the
            # adopting client recorded one round: it passes no pairs)
            cold = OffloadServer(GTX_2080TI, device=torch.device("cpu"), replay_cache=fresh)
            cold.context("c0").env.update(sess.server.context(sess.client_id).env)
            cold.prepare_split(calls, plan, "c0", fp, carried_pairs=())
            bound = cold.context("c0").split
            assert bound.program.is_stateful and bound.program.carried_pairs == pairs
            assert bound.program.plan.signature() == plan.signature()
            assert bound.carried_state is not None  # seeded from the env
        finally:
            server.replay_cache = None


class TestStatefulSegmentBatching:
    def test_cotenant_stateful_split_batches_and_isolates_state(self):
        """Two stateful split co-tenants on one shared IOS batch their server
        suffix on the GPU (seg_batches grows) while their carried states
        evolve independently and correctly."""
        model = decoder()
        edge = RRTOEdgeServer(device="cpu")
        cfg = PartitionConfig(adaptive=False)
        sessions = [edge.connect(model, min_repeats=2, partition=cfg) for _ in range(2)]
        rng = np.random.default_rng(9)
        frame0, h0 = model.example_inputs
        frames = {s.client_id: frame0 + rng.normal(0, 0.02, frame0.shape).astype(np.float32)
                  for s in sessions}
        states = {s.client_id: h0 for s in sessions}
        for _ in range(5):
            results = edge.run_round({c: (frames[c], states[c]) for c in states})
            states = {c: results[c].outputs[1] for c in states}
        assert all(s.client.mode == "replaying" and s.client.stateful_replay for s in sessions)
        graph = SegmentGraph(sessions[0].client._ios_calls,
                             carried_pairs=sessions[0].client.ios.carried_pairs)
        plan = feasible_plans(graph)[-1]
        for s in sessions:
            s.client._install_plan(plan)
        batches0 = edge.batcher.seg_batches
        vmap0 = edge.batcher.vmap_batches
        for _ in range(3):
            results = edge.run_round({c: (frames[c], states[c]) for c in states})
            states = {c: results[c].outputs[1] for c in states}
        assert edge.batcher.seg_batches >= batches0 + 1
        assert edge.batcher.vmap_batches == vmap0      # never through the vmap
        for s in sessions:
            state = torch.from_numpy(h0)
            with torch.no_grad():
                for _ in range(8):
                    y, state = model.apply(model.params, torch.from_numpy(frames[s.client_id]),
                                           state)
            torch.testing.assert_close(results[s.client_id].outputs[0], y, rtol=1e-5,
                                       atol=1e-5)


class TestServerSegmentBatching:
    """tests/test_multitenant.py::TestServerSegmentBatching."""

    def _locked_split_edge(self, n_clients=2, execute=True):
        """Co-tenant split sessions on one shared IOS, all replay-locked,
        with adaptive re-planning off so forced plans stay installed."""
        from repro_torch.models.cnn_zoo import make_sensor_encoder

        model = make_sensor_encoder(scale=0.25, input_size=32, n_blocks=2, device="cpu")
        edge = RRTOEdgeServer(execute=execute, device="cpu")
        sessions = []
        for _ in range(n_clients):
            s = edge.connect(model, min_repeats=2, partition=PartitionConfig(adaptive=False))
            s.network.trace_bytes_per_s = np.full(16, 8.0 * MBPS)
            sessions.append(s)
        for _ in range(6):
            edge.run_round({s.client_id: model.example_inputs for s in sessions})
        assert all(s.client.mode == "replaying" for s in sessions)
        return edge, sessions, model

    def test_same_server_segments_batch(self):
        """Split co-tenants whose plans share a server segment run it as one
        batched GPU occupancy, and the outputs stay exact."""
        edge, sessions, model = self._locked_split_edge()
        n = SegmentGraph(sessions[0].client._ios_calls).n_ops
        plan = SplitPlan.from_placements([PLACE_DEVICE] * 3 + [PLACE_SERVER] * (n - 3))
        for s in sessions:
            s.client._install_plan(plan)
        batches0 = edge.batcher.seg_batches
        results = edge.run_round({s.client_id: model.example_inputs for s in sessions})
        assert edge.batcher.seg_batches >= batches0 + 1
        assert edge.batcher.seg_batched >= 2
        outs = [results[s.client_id].outputs[0] for s in sessions]
        assert torch.equal(outs[0], outs[1])
        with torch.no_grad():
            want = model.apply(model.params, torch.from_numpy(model.example_inputs[0]))[0]
        assert torch.equal(outs[0], want)

    def test_different_device_cuts_still_share_server_segment(self):
        """The group key is (fingerprint, server-segment bounds): clients on
        different split plans of one IOS batch the segment they share."""
        edge, sessions, model = self._locked_split_edge()
        n = SegmentGraph(sessions[0].client._ios_calls).n_ops
        mid = max(5, n // 2)
        plan_a = SplitPlan.from_placements(
            [PLACE_DEVICE] * 3 + [PLACE_SERVER] * (mid - 3) + [PLACE_DEVICE] * 2
            + [PLACE_SERVER] * (n - mid - 2))
        plan_b = SplitPlan.from_placements(
            [PLACE_DEVICE] * 3 + [PLACE_SERVER] * (mid - 3) + [PLACE_DEVICE] * (n - mid))
        assert plan_a.signature() != plan_b.signature()
        sessions[0].client._install_plan(plan_a)
        sessions[1].client._install_plan(plan_b)
        batches0 = edge.batcher.seg_batches
        results = edge.run_round({s.client_id: model.example_inputs for s in sessions})
        # the shared (3, mid) segment batched; plan A's tail segment ran solo
        assert edge.batcher.seg_batches >= batches0 + 1
        assert edge.batcher.seg_solo >= 1
        a, b = (results[s.client_id].outputs[0] for s in sessions)
        assert torch.equal(a, b)

    def test_full_server_clients_keep_whole_program_batching(self):
        """Segment batching does not take full-server replays out of the
        whole-program batch groups."""
        rng = np.random.default_rng(0)
        params = {k: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
                  for k, s in (("w1", (16, 32)), ("w2", (32, 8)))}
        x = rng.normal(0, 1, (2, 16)).astype(np.float32)
        model = OffloadableModel("mlp", lambda p, x: [torch.tanh(x @ p["w1"]) @ p["w2"]],
                                 params, (x,))
        edge = RRTOEdgeServer(device="cpu")
        for _ in range(2):
            edge.connect(model)
        ids = list(edge.sessions)
        for _ in range(4):
            edge.run_round({c: (x,) for c in ids})
        batches0 = edge.batcher.batches_executed
        edge.run_round({c: (x,) for c in ids})
        assert edge.batcher.batches_executed == batches0 + 1
        assert edge.batcher.seg_batches == 0

    def test_pending_depth_counts_segment_members(self):
        """A formed round's preloaded segment members count as pending until
        they submit, and the round's claims pin the base."""
        edge, sessions, model = self._locked_split_edge()
        n = SegmentGraph(sessions[0].client._ios_calls).n_ops
        plan = SplitPlan.from_placements([PLACE_DEVICE] * 3 + [PLACE_SERVER] * (n - 3))
        for s in sessions:
            s.client._install_plan(plan)
        fp = sessions[0].client.ios_fp
        edge.batcher.begin_round({}, {(fp, 3, n): [s.client_id for s in sessions]})
        assert edge.batcher.pending_depth == 2
        assert edge.cache.is_pinned(fp)
        edge.batcher.end_round()
        assert not edge.cache.is_pinned(fp)

    def test_account_only_split_round(self):
        """An account-only edge (execute=False) runs split co-tenants through
        the same segment batching, with zeros for outputs."""
        edge, sessions, model = self._locked_split_edge(execute=False)
        n = SegmentGraph(sessions[0].client._ios_calls).n_ops
        plan = SplitPlan.from_placements([PLACE_DEVICE] * 3 + [PLACE_SERVER] * (n - 3))
        for s in sessions:
            s.client._install_plan(plan)
        results = edge.run_round({s.client_id: model.example_inputs for s in sessions})
        assert edge.batcher.seg_batched >= 2
        assert all(not r.outputs[0].any() for r in results.values())
        assert edge.summary()["seg_batches"] >= 1


class TestSplitServedLM:
    def test_split_decode_tokens_equal_reference(self, decode):
        """``RRTOServedLM(partition=...)`` with the longest feasible prefix
        installed once the IOS locks: the tokens equal the JAX package's
        served decode, each steady token costs 2 RPCs (the boundary and the
        next token), and the KV cache is never billed in steady state."""
        from repro_torch.serving.engine import RRTOServedLM

        served = RRTOServedLM(decode["cfg"], bucket_len=16, batch=1, params=decode["params"],
                              min_repeats=3, device="cpu",
                              partition=PartitionConfig(adaptive=False))
        g = served.start_generation(decode["prompt"], 8)
        cache_bytes = sum(t.numel() * t.element_size() for t in served._cache_leaves)
        steady = []
        for _ in range(served.steps_total(g)):
            res = served.session.infer(*served.step_inputs(g))
            served.absorb_step(g, res.outputs)
            cl = served.session.client
            if cl.mode == "replaying" and cl.split_plan is None:
                # the planner's own pick for a 4-byte token is full-server
                graph = SegmentGraph(cl._ios_calls, carried_pairs=cl.ios.carried_pairs)
                cl._install_plan(feasible_plans(graph)[-1])
            elif res.mode == "replaying":
                steady.append(res)
        tokens = np.concatenate(g["out"], axis=1)
        assert np.array_equal(tokens, decode["j_tokens"])
        # the first split round still hands the recorded state over (one
        # extra RPC, as on the full-server path); steady rounds never bill it
        assert len(steady) > 2 and all(r.rpcs == 2 for r in steady[1:])
        assert all(r.network_bytes == steady[1].network_bytes < cache_bytes for r in steady[1:])
