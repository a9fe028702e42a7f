"""The fault-tolerance layer in the port (tests/test_chaos.py): deterministic
fault injection, at-most-once RPC retries, the outage fallback to the device,
and the invariant the layer hangs on: a faulted run is bitwise the fault-free
run, and an injector that injects nothing changes nothing.

Against the JAX package: ``FaultInjector.rpc_fate``, ``jitter_unit`` and
``chaos_schedule`` give the same fates, units and windows, draw for draw, and
``RetryPolicy.timeout_s`` the same timeouts.  Then the port's own engine: the
snapshot that ``export_carried_state`` returns is a copy (a later step leaves
it as it was), and a dedup reply stays bitwise what it was when cached."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import netsim as jnetsim  # noqa: E402
from repro_torch.core.netsim import (  # noqa: E402
    OUTAGE_FLOOR_BYTES_PER_S,
    FaultInjector,
    NetworkModel,
    RetryPolicy,
    RpcTimeoutError,
    synth_bandwidth_trace,
)
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_rnn(seed=0, d=8, batch=2):
    """Recurrent app threading explicit state — the minimal carried shape."""
    rng = np.random.default_rng(seed)
    params = {"w": _t(rng.normal(0, 0.1, (d, d)).astype(np.float32))}

    def apply(p, x, state):
        new_state = torch.tanh(state @ p["w"] + x)
        return [new_state.sum(dim=1), new_state]

    x = _t(rng.normal(0, 1, (batch, d)).astype(np.float32))
    state0 = torch.zeros((batch, d))
    return OffloadableModel(f"rnn{seed}", apply, params, (x, state0)), x, state0


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


def session(model, **kw):
    return OffloadSession(model, "rrto", device="cpu", **kw)


class TestAgainstReference:
    """The draws are pure Python integer arithmetic in both packages, so
    they agree exactly."""

    @pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
    def test_fates_and_units_draw_for_draw(self, seed):
        ours = FaultInjector(seed=seed, rpc_loss_prob=0.3)
        ref = jnetsim.FaultInjector(seed=seed, rpc_loss_prob=0.3)
        rng = np.random.default_rng(seed % 2**32)
        kinds = rng.integers(0, 2, 10_000)
        for k in kinds:
            if k:
                assert ours.rpc_fate() == ref.rpc_fate()
            else:
                assert ours.jitter_unit() == ref.jitter_unit()
        assert (ours.draws, ours.dropped) == (ref.draws, ref.dropped) == (10_000, ref.dropped)
        assert ours.dropped > 0

    @pytest.mark.parametrize("seed", [0, 11, 123456789])
    def test_chaos_schedule_windows(self, seed):
        kw = dict(duration_s=30.0, n_outages=3, mean_outage_s=0.4, rpc_loss_prob=0.05,
                  n_collapses=2, collapse_factor=0.1, crashes={"r1": 2.5})
        ours = FaultInjector.chaos_schedule(seed, **kw)
        ref = jnetsim.FaultInjector.chaos_schedule(seed, **kw)
        assert ours.outages == ref.outages and ours.collapses == ref.collapses
        assert ours.crashes == ref.crashes and ours.rpc_loss_prob == ref.rpc_loss_prob
        for t in np.linspace(0.0, 31.0, 500):
            assert ours.bandwidth_factor(t) == ref.bandwidth_factor(t)
            assert ours.outage_until(t) == ref.outage_until(t)

    def test_retry_timeouts_equal(self):
        for kw in ({}, dict(base_timeout_s=0.01, backoff=3.0, max_backoff_s=0.2, jitter=0.5)):
            ours, ref = RetryPolicy(**kw), jnetsim.RetryPolicy(**kw)
            for attempt in range(10):
                for unit in (0.0, 0.3, 0.999999):
                    assert ours.timeout_s(attempt, unit) == ref.timeout_s(attempt, unit)


class TestFaultInjectorDeterminism:
    def test_fate_stream_is_a_pure_function_of_seed(self):
        a = FaultInjector(seed=7, rpc_loss_prob=0.2)
        b = FaultInjector(seed=7, rpc_loss_prob=0.2)
        fates_a = [a.rpc_fate() for _ in range(300)]
        assert fates_a == [b.rpc_fate() for _ in range(300)]
        assert a.dropped == b.dropped > 0
        assert {"lost_request", "lost_response"} <= set(fates_a)
        c = FaultInjector(seed=8, rpc_loss_prob=0.2)
        assert [c.rpc_fate() for _ in range(300)] != fates_a

    def test_jitter_units_deterministic_and_bounded(self):
        a, b = FaultInjector(seed=3), FaultInjector(seed=3)
        ua = [a.jitter_unit() for _ in range(100)]
        assert ua == [b.jitter_unit() for _ in range(100)]
        assert all(0.0 <= u < 1.0 for u in ua)
        assert len(set(ua)) > 90, "units must not degenerate"

    def test_outage_and_collapse_windows(self):
        f = FaultInjector(seed=0, outages=((1.0, 2.0),), collapses=((3.0, 4.0, 0.1),))
        assert not f.in_outage(0.5) and f.in_outage(1.5)
        assert f.outage_until(1.5) == 2.0
        assert f.outage_until(0.5) == 0.5, "link up: no wait"
        assert f.bandwidth_factor(1.5) == 0.0
        assert f.bandwidth_factor(3.5) == pytest.approx(0.1)
        assert f.bandwidth_factor(5.0) == 1.0

    def test_due_crashes_fire_exactly_once(self):
        f = FaultInjector(seed=0, crashes={"r0": 1.0, "r1": 2.0})
        assert f.due_crashes(0.5) == []
        assert f.due_crashes(1.5) == ["r0"]
        assert f.due_crashes(2.5) == ["r1"]
        assert f.due_crashes(9.9) == [], "each crash fires once"

    def test_validation(self):
        with pytest.raises(ValueError):
            FaultInjector(rpc_loss_prob=1.5)
        with pytest.raises(ValueError):
            FaultInjector(outages=((2.0, 1.0),))
        with pytest.raises(ValueError):
            FaultInjector(collapses=((1.0, 2.0, 0.0),))

    def test_chaos_schedule_places_windows_inside_duration(self):
        kw = dict(duration_s=10.0, n_outages=2, mean_outage_s=0.5, rpc_loss_prob=0.05,
                  n_collapses=1)
        f = FaultInjector.chaos_schedule(seed=11, **kw)
        assert len(f.outages) == 2 and len(f.collapses) == 1
        for a, b in f.outages:
            assert 0.0 <= a < b <= 11.0
        g = FaultInjector.chaos_schedule(seed=11, **kw)
        assert f.outages == g.outages and f.collapses == g.collapses

    def test_network_bandwidth_floored_during_outage(self):
        net = NetworkModel("t", synth_bandwidth_trace(100.0, 0.0, 0.0, seed=0))
        net.fault = FaultInjector(seed=0, outages=((0.0, 1.0),))
        # floored, not zero: an in-flight transfer stalls finitely
        assert net.bandwidth_at(0.5) == OUTAGE_FLOOR_BYTES_PER_S
        assert net.bandwidth_at(2.0) > OUTAGE_FLOOR_BYTES_PER_S


class TestRetryPolicy:
    def test_backoff_grows_exponentially_then_caps(self):
        p = RetryPolicy(base_timeout_s=0.01, backoff=2.0, max_backoff_s=0.05, jitter=0.0)
        ts = [p.timeout_s(a, unit=0.0) for a in range(6)]
        assert ts[:3] == pytest.approx([0.01, 0.02, 0.04])
        assert ts[3:] == pytest.approx([0.05, 0.05, 0.05]), "capped"

    def test_jitter_bounded_fraction_of_timeout(self):
        p = RetryPolicy(base_timeout_s=0.01, jitter=0.25)
        lo, hi = p.timeout_s(0, unit=0.0), p.timeout_s(0, unit=0.999999)
        assert lo == pytest.approx(0.01)
        assert lo < hi < 0.01 * 1.25


def _drive_rnn(fault, steps=16, retry_policy=None, client_id="c0"):
    """One stateful session threading carried state; returns the session,
    per-step outputs, and the final server-resident carried state."""
    model, x, state0 = make_rnn()
    sess = session(model, min_repeats=2, fault=fault, retry_policy=retry_policy,
                   client_id=client_id)
    sess.load()
    state, ys = state0, []
    for _ in range(steps):
        res = sess.infer(x, state)
        state = res.outputs[1]
        ys.append(res.outputs[0].clone())
    return sess, ys, sess.server.export_carried_state(client_id)


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


class TestAtMostOnce:
    """N injected retries leave outputs AND carried state identical to the
    no-retry run — the acceptance property of the reliability protocol."""

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_lossy_stream_bitwise_equal_to_clean(self, seed):
        _, ys_clean, state_clean = _drive_rnn(None)
        sess, ys, state = _drive_rnn(FaultInjector(seed=seed, rpc_loss_prob=0.25))
        st = sess.client.stats
        assert st.retries >= 1, "schedule must actually inject losses"
        # a lost *response* means the server already ran the step: the retry
        # is answered from the dedup table, never re-advancing the state
        assert st.dedup_replies >= 1
        assert sess.server.dedup_hits == st.dedup_replies
        assert _equal(ys, ys_clean)
        assert state is not None and _equal(state, state_clean)

    def test_retries_cost_time_but_not_correctness(self):
        clean, _, _ = _drive_rnn(None)
        fault = FaultInjector(seed=2, rpc_loss_prob=0.25)
        lossy, _, _ = _drive_rnn(fault)
        assert lossy.clock.t > clean.clock.t
        assert lossy.client.stats.retries == fault.dropped

    def test_retry_budget_exhaustion_is_typed(self):
        # every attempt dies: the bounded retry loop raises a typed error
        with pytest.raises(RpcTimeoutError):
            _drive_rnn(FaultInjector(seed=0, rpc_loss_prob=1.0),
                       retry_policy=RetryPolicy(max_attempts=3))


class TestSnapshotsAreCopies:
    """The port's server tensors are mutable (the reference's are immutable
    JAX arrays), so what the fault layer keeps must be copies."""

    def test_export_is_unchanged_by_later_steps(self):
        model, x, state0 = make_rnn()
        sess = session(model, min_repeats=2)
        state = state0
        for _ in range(6):
            state = sess.infer(x, state).outputs[1]
        assert sess.client.stateful_replay
        snap = sess.server.export_carried_state("c0")
        kept = [t.clone() for t in snap]
        live = sess.server.context("c0").replay.carried_state
        assert all(s.untyped_storage().data_ptr() != v.untyped_storage().data_ptr()
                   for s, v in zip(snap, live))
        for _ in range(2):
            state = sess.infer(x, state).outputs[1]
        assert _equal(snap, kept)
        assert not _equal(sess.server.export_carried_state("c0"), kept), "state advanced"

    def test_import_places_a_copy(self):
        model, x, state0 = make_rnn()
        sess = session(model, min_repeats=2)
        state = state0
        for _ in range(5):
            state = sess.infer(x, state).outputs[1]
        snap = sess.server.export_carried_state("c0")
        sess.server.import_carried_state("c0", snap)
        live = sess.server.context("c0").replay.carried_state
        assert _equal(live, snap)
        assert all(s.untyped_storage().data_ptr() != v.untyped_storage().data_ptr()
                   for s, v in zip(snap, live))
        with pytest.raises(ValueError, match="arity"):
            sess.server.import_carried_state("c0", snap + snap)

    def test_dedup_reply_stays_bitwise_after_later_steps(self):
        sess, _, _ = _drive_rnn(FaultInjector(seed=1, rpc_loss_prob=0.25), steps=4)
        table = sess.server.dedup["c0"]
        assert table, "stateful steps ran under the protocol"
        kept = {seq: ([o.clone() for o in outs], done) for seq, (outs, done) in table.items()}
        model, x, _ = make_rnn()
        state = sess.client._carried_placeholders[0]
        for _ in range(6):
            state = sess.infer(x, state).outputs[1]
        for seq, (outs, done) in kept.items():
            got_outs, got_done = table[seq]
            assert got_done == done and _equal(got_outs, outs)

    def test_step_log_holds_copies(self):
        from collections import deque

        model, x, state0 = make_rnn()
        sess = session(model, min_repeats=2)
        sess.client.step_log = deque(maxlen=8)
        xs = x.clone()
        state = state0
        for _ in range(6):
            state = sess.infer(xs, state).outputs[1]
            xs += 1.0          # the app reuses its input buffer
        log = list(sess.client.step_log)
        assert log and [e.seq for e in log] == list(range(len(log)))
        assert len({e.wire_inputs[0][0, 0].item() for e in log}) == len(log)
        assert all(e.wire_inputs[0] is not xs for e in log)


class TestOutageFallback:
    def _clean_boundaries(self, n=10):
        model, x = make_mlp()
        sess = session(model, min_repeats=2)
        sess.load()
        outs, ts = [], []
        for _ in range(n):
            outs.append(sess.infer(x).outputs[0])
            ts.append(sess.clock.t)
        return outs, ts

    def test_stateless_outage_falls_back_then_heals_bitwise(self):
        n = 10
        clean_outs, ts = self._clean_boundaries(n)
        # a window straddling the entry of request k+1 (the fault-free prefix
        # has the same timing, so the faulted run reaches ts[k] then too)
        k = 6
        window = (0.5 * (ts[k - 1] + ts[k]), 0.5 * (ts[k] + ts[k + 1]))
        model, x = make_mlp()
        sess = session(model, min_repeats=2, fault=FaultInjector(seed=0, outages=(window,)))
        sess.load()
        modes, outs = [], []
        for _ in range(n):
            res = sess.infer(x)
            modes.append(res.mode)
            outs.append(res.outputs[0])
        assert sess.client.stats.outage_fallbacks >= 1
        assert "outage_fallback" in modes
        assert modes[-1] == "replaying", "a healed link resumes offloading"
        assert _equal(outs, clean_outs)

    def test_stateful_session_waits_out_outage(self):
        """A stateful-replay session cannot fall back (its carried state
        lives on the server): it waits for the link, then continues
        bitwise."""
        model, x, state0 = make_rnn()
        clean = session(model, min_repeats=2)
        clean.load()
        st_c, ys_clean, ts = state0, [], []
        for _ in range(12):
            res = clean.infer(x, st_c)
            st_c = res.outputs[1]
            ys_clean.append(res.outputs[0])
            ts.append(clean.clock.t)
        state_clean = clean.server.export_carried_state("c0")
        k = 8
        window = (0.5 * (ts[k - 1] + ts[k]), 0.5 * (ts[k] + ts[k + 1]))
        sess, ys, state = _drive_rnn(FaultInjector(seed=0, outages=(window,)), steps=12)
        st = sess.client.stats
        assert st.outage_waits >= 1
        assert st.outage_fallbacks == 0
        assert sess.clock.t > clean.clock.t, "the wait is billed"
        assert _equal(ys, ys_clean) and _equal(state, state_clean)

    def test_split_session_adopts_the_outage_plan(self):
        """A split session with a re-planner adopts the all-device plan for
        the outage, stays bitwise, and re-offloads after the heal."""
        from repro_torch.models.cnn_zoo import make_sensor_encoder
        from repro_torch.partition import PartitionConfig

        enc = make_sensor_encoder(0.25, 32, n_blocks=2, device="cpu")
        plain = session(enc, min_repeats=2)
        ts, want = [], []
        for _ in range(12):
            want.append(plain.infer(*enc.example_inputs).outputs[0])
            ts.append(plain.clock.t)
        split = session(enc, min_repeats=2, partition=PartitionConfig(min_replan_interval_s=0.0))
        for _ in range(4):
            split.infer(*enc.example_inputs)
        assert split.client.mode == "replaying"
        # the window covers the next request's entry (after its client-side
        # control time) and ends before the one after it
        t = split.clock.t
        fault = FaultInjector(seed=0, outages=((t, t + 1e-3),))
        split.client.fault = fault
        split.network.fault = fault
        got = [split.infer(*enc.example_inputs) for _ in range(8)]
        rp = split.client.replanner
        assert rp.stats.outage_replans == 1
        assert split.client.stats.outage_fallbacks == 1
        assert got[0].mode == "replaying"
        assert all(torch.equal(r.outputs[0], want[0]) for r in got)
        plan = split.client.split_plan
        assert plan is None or plan.n_device_ops < rp.graph.n_ops, (
            "the session re-offloads once the link heals")


class TestDisabledInjectorIsInvisible:
    def test_noop_injector_leaves_run_byte_identical(self):
        base, ys_base, state_base = _drive_rnn(None)
        noop, ys, state = _drive_rnn(FaultInjector(seed=99))
        assert noop.clock.t == base.clock.t
        st = noop.client.stats
        assert st.retries == st.dedup_replies == 0
        assert st.outage_fallbacks == st.outage_waits == 0
        assert _equal(ys, ys_base) and _equal(state, state_base)
        assert st.rpcs == base.client.stats.rpcs
        assert st.network_bytes == base.client.stats.network_bytes
