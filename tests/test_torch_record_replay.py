"""Record/replay in the port: the traced aten stream, byte-identical steady
records, the Operator Sequence Search locking after ``min_repeats``, replay
correctness at positions the trace never saw, constants created inside the
app, and loop-carried detection on raw bits."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.flatten import trace_app  # noqa: E402
from repro_torch.core.intercept import GraphInterceptor, InterceptedCall  # noqa: E402
from repro_torch.core.offload import SYSTEMS, OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.core.opseq import bits_equal  # noqa: E402
from repro_torch.core.records import FUNC_D2H, FUNC_H2D  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.layers.rope import apply_rope  # noqa: E402


def _params():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn(16, 16, generator=g) * 0.25,
        "scale": torch.ones(16),
    }


def rope_app(p, x, pos):
    """A position-dependent app: x (1,1,16) float, pos 0-d int32."""
    h = rmsnorm(x @ p["w"], p["scale"])
    h = apply_rope(h.reshape(1, 1, 2, 8), pos.reshape(1, 1), 1e4).reshape(1, 1, 16)
    # a tensor built from Python data inside the app: traced as a constant
    bias = torch.tensor([0.5, -0.5] * 8)
    return [h + bias, pos * 3]


def _x(seed):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(0, 1, (1, 1, 16)).astype(np.float32)
    )


def _pos(i):
    return torch.tensor(i, dtype=torch.int32)


def _session(system="rrto", **kw):
    model = OffloadableModel("rope", rope_app, _params(), (_x(0), _pos(0)))
    return OffloadSession(model, system, device="cpu", **kw)


def test_trace_is_flat_aten_with_constants():
    leaves = list(_params().values())

    def flat(leaves, x, pos):
        return rope_app({"w": leaves[0], "scale": leaves[1]}, x, pos)

    g = trace_app(flat, leaves, [_x(0), _pos(3)])
    names = [n.name for n in g.nodes]
    assert names.count("repro_torch.rmsnorm.default") == 1
    assert all(n.startswith(("aten.", "repro_torch.")) for n in names)
    # two parameters + one constant made inside the app
    assert len(g.constvars) == 3 and g.consts[0] is leaves[0]
    assert torch.equal(g.consts[2], torch.tensor([0.5, -0.5] * 8))


def test_trace_refuses_python_reads_of_values():
    """A traced app that reads a tensor's value in Python would bake it into
    the graph; the fake-tensor trace refuses instead."""
    def baking(leaves, x, pos):
        return [x * int(pos)]

    with pytest.raises(Exception):
        trace_app(baking, [], [_x(0), _pos(3)])


def test_steady_iterations_emit_identical_records():
    leaves = list(_params().values())
    g = trace_app(
        lambda ls, x, pos: rope_app({"w": ls[0], "scale": ls[1]}, x, pos),
        leaves, [_x(0), _pos(0)],
    )
    rounds = []

    def sink(call: InterceptedCall):
        rounds[-1].append(call.record)
        if call.record.func == FUNC_D2H:
            shape, dtype = call.out_avals[0]
            return torch.zeros(shape, dtype=dtype)
        return "cudaSuccess"

    icpt = GraphInterceptor(sink)
    rounds.append([])
    addrs = icpt.upload_params(g.consts)
    for i in range(4):
        rounds.append([])
        icpt.run(g, addrs, [_x(i), _pos(i)])
    steady = rounds[2:]
    assert all(r == steady[0] for r in steady[1:])
    assert all(
        a.identity() == b.identity() for a, b in zip(steady[0], steady[-1])
    )
    kernels = [r for r in steady[0] if r.func.startswith("kernel:")]
    assert len(kernels) == len(g.nodes)
    assert "kernel:repro_torch.rmsnorm.default" in {r.func for r in kernels}


def test_search_locks_and_replays_new_positions():
    """Replay re-executes the recorded aten calls with this inference's
    inputs: positions never seen while recording give the right, different
    outputs (nothing was baked in)."""
    sess = _session(min_repeats=3)
    ref = _session("device_only")
    modes = []
    for i in range(4):
        r = sess.infer(_x(i), _pos(i))
        modes.append(r.mode)
    assert modes[:3] == ["recording"] * 3
    assert sess.client.mode == "replaying"
    outs = {}
    for pos in (5, 9, 40):
        r = sess.infer(_x(7), _pos(pos))
        assert r.mode == "replaying" and r.rpcs <= 4
        want = ref.infer(_x(7), _pos(pos)).outputs
        for a, b in zip(r.outputs, want):
            assert torch.equal(a, b)
        outs[pos] = r.outputs[0]
    assert not torch.equal(outs[5], outs[9])
    assert int(r.outputs[1]) == 120


@pytest.mark.parametrize("b_input_rows", [2, 3])
def test_deviation_falls_back_and_recovers(b_input_rows):
    """A Dynamic Activation Model changes its op stream mid-service: the
    replayer detects the first mismatching record (mid-inference when only
    the ops change, at the first upload when the input changes too), ships
    the catch-up prefix, falls back to recording with correct values, and
    re-identifies the new sequence."""
    from repro_torch.core.costmodel import GTX_2080TI
    from repro_torch.core.energy import EnergyMeter
    from repro_torch.core.engine import OffloadServer, RRTOClient, SimClock
    from repro_torch.core.intercept import NO_NOISE
    from repro_torch.core.netsim import indoor_network

    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))

    def graph_a(ls, x):
        return [torch.relu(x @ ls[0])]

    def graph_b(ls, x):  # different op stream (DAM path change)
        return [torch.relu(x @ ls[0]) + x.sum(dim=-1, keepdim=True)]

    xa = torch.randn(2, 8, generator=torch.Generator().manual_seed(2))
    xb = torch.randn(b_input_rows, 8, generator=torch.Generator().manual_seed(3))
    ga = trace_app(graph_a, [w], [xa])
    gb = trace_app(graph_b, [w], [xb])
    client = RRTOClient(
        OffloadServer(GTX_2080TI, device=torch.device("cpu")), indoor_network(),
        SimClock(), EnergyMeter(), min_repeats=2,
    )
    icp = GraphInterceptor(client, NO_NOISE)
    addrs = icp.upload_params([w])
    for _ in range(4):
        (out,) = icp.run(ga, addrs, [xa])
    assert client.mode == "replaying"
    seq_a = client.ios
    for _ in range(5):
        (out,) = icp.run(gb, addrs, [xb])
        assert torch.equal(out, graph_b([w], xb)[0])
    assert client.fallbacks == 1
    assert client.mode == "replaying" and client.ios is not seq_a


@pytest.mark.parametrize("system", SYSTEMS)
def test_systems_compute_the_same(system):
    sess = _session(system)
    ref = _session("device_only")
    for i in range(5):
        got = sess.infer(_x(i), _pos(i)).outputs
        want = ref.infer(_x(i), _pos(i)).outputs
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    if system == "cricket":
        assert sess.history[-1].rpcs > 100
    if system == "rrto":
        assert sess.history[-1].rpcs < 10


def test_bits_equal():
    a = torch.tensor([0.0, 1.5], dtype=torch.bfloat16)
    assert bits_equal(a, a.clone())
    assert not bits_equal(a, torch.tensor([-0.0, 1.5], dtype=torch.bfloat16))
    nan = torch.tensor([float("nan")])
    assert bits_equal(nan, nan.clone())
    assert not bits_equal(a, a.float())
    assert bits_equal(torch.tensor(3, dtype=torch.int32), torch.tensor(3, dtype=torch.int32))


def test_loop_carried_state_is_detected_and_stays_resident():
    """An app threading state through the boundary (state out of round k is
    state in of round k+1) gets a carried pair; replay keeps it on the
    server and answers with the handle."""
    def acc_app(p, x, state):
        return [(x * state).sum().reshape(1), state + x @ p["w"]]

    params = {"w": torch.eye(4) * 0.5}
    model = OffloadableModel("acc", acc_app, params, (torch.ones(1, 4), torch.zeros(1, 4)))
    sess = OffloadSession(model, "rrto", device="cpu", min_repeats=3)
    ref = OffloadSession(model, "device_only", device="cpu")
    state = ref_state = torch.zeros(1, 4)
    for i in range(8):
        x = torch.full((1, 4), float(i))
        r = sess.infer(x, state)
        w = ref.infer(x, ref_state)
        state, ref_state = r.outputs[1], w.outputs[1]
        assert torch.equal(r.outputs[0], w.outputs[0])
    assert sess.client.ios.carried_pairs == ((1, 1),)
    assert sess.client.stateful_replay
    h2d = [c for c in sess.client._ios_calls if c.record.func == FUNC_H2D]
    assert len(h2d) == 2
    assert sess.history[-1].rpcs == 2
    resident = sess.server.context().replay.carried_state[0]
    assert torch.equal(resident, ref_state)


def test_stateful_deviation_refreshes_the_state_handle():
    """A stateful app deviating mid-inference: the client downloads the
    server-resident state, refreshes the handle the app threads, and the
    recorded catch-up and every later step compute from the true state."""
    from repro_torch.core.costmodel import GTX_2080TI
    from repro_torch.core.energy import EnergyMeter
    from repro_torch.core.engine import OffloadServer, RRTOClient, SimClock
    from repro_torch.core.intercept import NO_NOISE
    from repro_torch.core.netsim import indoor_network

    w = torch.eye(4) * 0.5

    def graph_a(ls, x, state):
        return [(x * state).sum().reshape(1), state + x @ ls[0]]

    def graph_b(ls, x, state):   # a changed op stream after a shared prefix
        return [(x * state).sum().reshape(1) * 2.0, state + x @ ls[0]]

    ex = [torch.ones(1, 4), torch.zeros(1, 4)]
    ga, gb = trace_app(graph_a, [w], ex), trace_app(graph_b, [w], ex)
    client = RRTOClient(
        OffloadServer(GTX_2080TI, device=torch.device("cpu")), indoor_network(),
        SimClock(), EnergyMeter(), min_repeats=2,
    )
    icp = GraphInterceptor(client, NO_NOISE)
    addrs = icp.upload_params([w])
    state = ref = torch.zeros(1, 4)
    for i in range(10):
        g, fn = (ga, graph_a) if i < 6 else (gb, graph_b)
        x = torch.full((1, 4), float(i + 1))
        out, state = icp.run(g, addrs, [x, state])
        want, ref = fn([w], x, ref)
        assert torch.equal(out, want), i
        if i == 5:
            assert client.stateful_replay and client.mode == "replaying"
    assert client.fallbacks == 1 and client.mode == "replaying"


def _dam_scenarios():
    """Two DAM deviations, as (graphs in JAX, graphs in torch, params,
    inputs per step): a stateless op-stream change whose first replayed
    output reuses the input's buffer, and a stateful one deviating after the
    round's replay step."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (8, 8)).astype(np.float32)
    x, xb = (rng.normal(0, 1, (2, 8)).astype(np.float32) for _ in range(2))
    stateless = dict(
        jax=(lambda jnp, jax: (lambda x: [jax.nn.relu(x @ w)],
                               lambda x: [jax.nn.relu(x @ w) + x.sum(axis=-1, keepdims=True)])),
        torch=(lambda ls, x: [torch.relu(x @ ls[0])],
               lambda ls, x: [torch.relu(x @ ls[0]) + x.sum(dim=-1, keepdim=True)]),
        w=w, steps=[(x,)] * 4 + [(xb,)], state=False,
    )
    ws = np.eye(4, dtype=np.float32) * 0.5
    stateful = dict(
        jax=(lambda jnp, jax: (lambda x, s: [(x * s).sum().reshape(1), s + x @ ws],
                               lambda x, s: [(x * s).sum().reshape(1) * 2.0, s + x @ ws])),
        torch=(lambda ls, x, s: [(x * s).sum().reshape(1), s + x @ ls[0]],
               lambda ls, x, s: [(x * s).sum().reshape(1) * 2.0, s + x @ ls[0]]),
        w=ws, steps=[(np.full((1, 4), float(i + 1), np.float32),) for i in range(7)],
        state=True,
    )
    return {"stateless": stateless, "stateful": stateful}


@pytest.mark.parametrize("name", ["stateless", "stateful"])
def test_reference_fallback_faults(name):
    """The queue-C faults: after a DAM deviation the JAX package's catch-up
    computes wrong values (run with ``execute=True``), the port's exact ones.
    The last step is the first of the deviating op stream."""
    jax = pytest.importorskip("jax")
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
    from repro_torch.core.costmodel import GTX_2080TI
    from repro_torch.core.energy import EnergyMeter
    from repro_torch.core.engine import OffloadServer, RRTOClient, SimClock
    from repro_torch.core.intercept import NO_NOISE
    from repro_torch.core.netsim import indoor_network

    sc = _dam_scenarios()[name]
    ja_fn, jb_fn = sc["jax"](jnp, jax)
    ta_fn, tb_fn = sc["torch"]
    n_args = 2 if sc["state"] else 1
    ex = [np.zeros_like(sc["steps"][0][0])] * n_args
    jgraphs = [flatten_closed_jaxpr(jax.make_jaxpr(f)(*ex)) for f in (ja_fn, jb_fn)]
    w = torch.from_numpy(sc["w"])
    tex = [torch.from_numpy(e) for e in ex]
    tgraphs = [trace_app(f, [w], tex) for f in (ta_fn, tb_fn)]
    jclient = JClient(JServer(J_GTX, execute=True), j_indoor(), JClock(), JMeter(),
                      variant="rrto", min_repeats=2)
    jicp = JaxprInterceptor(jclient, J_NO_NOISE)
    jaddrs = [jicp.upload_params(list(g.consts)) for g in jgraphs]
    tclient = RRTOClient(OffloadServer(GTX_2080TI, device=torch.device("cpu")),
                         indoor_network(), SimClock(), EnergyMeter(), min_repeats=2)
    ticp = GraphInterceptor(tclient, NO_NOISE)
    taddrs = ticp.upload_params([w])
    jstate = tstate = truth = np.zeros_like(ex[-1])
    tstate = torch.from_numpy(tstate)
    last = len(sc["steps"]) - 1
    for i, (x,) in enumerate(sc["steps"]):
        k = int(i == last)
        fn = (ja_fn, jb_fn)[k]
        if sc["state"]:
            jout = jicp.run(jgraphs[k], jaddrs[k], [x, jstate])
            tout = ticp.run(tgraphs[k], taddrs, [torch.from_numpy(x), tstate])
            want = [np.asarray(v) for v in fn(x, truth)]
            jstate, tstate, truth = jout[1], tout[1], want[1]
        else:
            jout = jicp.run(jgraphs[k], jaddrs[k], [x])
            tout = ticp.run(tgraphs[k], taddrs, [torch.from_numpy(x)])
            want = [np.asarray(v) for v in fn(x)]
    assert jclient.fallbacks == tclient.fallbacks == 1
    j_err = float(np.abs(np.asarray(jout[0]) - want[0]).max())
    t_err = float(np.abs(tout[0].numpy() - want[0]).max())
    print(f"{name}: reference max|d| {j_err:.4g}, port max|d| {t_err:.4g}")
    assert j_err > 1.0 and t_err < 1e-5
