"""Multi-tenant serving in the port (tests/test_multitenant.py, the
multi-tenant cases of tests/test_stateful_replay.py): fingerprints stable
across clients, cache adoption after one recorded inference, one program
built per fingerprint, cross-client batched replay (one ``torch.func.vmap``
call, bitwise the per-client loop), padded widths, the digest cache, LRU
and byte-aware eviction, pins and claims, persistence, single-client
equivalence, ingress contention, a DAM deviation inside a formed round, and
``MultiClientServedLM`` against the JAX package's on reduced qwen3 (stateful),
zamba2 (stateless) and mixtral (both: the MoE dispatch's ``topk``, stable
sort and ``index_copy`` batched) from the same numpy parameters.  Every multi-client
round runs under ``no_vmap_fallback``: an op without a batching rule fails
the test instead of looping quietly."""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import no_vmap_fallback  # noqa: E402
from repro_torch.core.flatten import trace_app  # noqa: E402
from repro_torch.core.netsim import ServerIngress, indoor_network  # noqa: E402
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.core.opseq import candidate_sequences, ios_fingerprint  # noqa: E402
from repro_torch.serving import multitenant as mt  # noqa: E402
from repro_torch.serving.multitenant import RRTOEdgeServer  # noqa: E402
from repro_torch.serving.replay_cache import ReplayCache  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_mlp(seed=0, d_in=16, d_hidden=32, d_out=8):
    rng = np.random.default_rng(seed)
    params = {
        "w1": _t(rng.normal(0, 0.1, (d_in, d_hidden)).astype(np.float32)),
        "w2": _t(rng.normal(0, 0.1, (d_hidden, d_out)).astype(np.float32)),
    }

    def apply(p, x):
        return [torch.tanh(x @ p["w1"]) @ p["w2"]]

    x = _t(rng.normal(0, 1, (2, d_in)).astype(np.float32))
    return OffloadableModel(f"mlp{seed}", apply, params, (x,)), x


def make_deep_mlp(seed=0, d=16):
    rng = np.random.default_rng(seed)
    params = {k: _t(rng.normal(0, 0.1, (d, d)).astype(np.float32)) for k in ("w1", "w2", "w3")}

    def apply(p, x):
        h = torch.tanh(x @ p["w1"])
        h = torch.relu(h @ p["w2"])
        return [h @ p["w3"]]

    x = _t(rng.normal(0, 1, (2, d)).astype(np.float32))
    return OffloadableModel(f"deep{seed}", apply, params, (x,)), x


def make_rnn(seed=0, d=8, batch=2):
    """A recurrent app threading explicit state: apply(p, x, state) ->
    [y, new_state]."""
    rng = np.random.default_rng(seed)
    params = {"w": _t(rng.normal(0, 0.1, (d, d)).astype(np.float32))}

    def apply(p, x, state):
        new_state = torch.tanh(state @ p["w"] + x)
        return [new_state.sum(dim=1), new_state]

    x = _t(rng.normal(0, 1, (batch, d)).astype(np.float32))
    state0 = torch.zeros((batch, d))
    return OffloadableModel(f"rnn{seed}", apply, params, (x, state0)), x, state0


def edge_server(**kw):
    return RRTOEdgeServer(device="cpu", **kw)


def run_round(edge, inputs):
    with no_vmap_fallback():
        return edge.run_round(inputs)


def eager(model, *inputs):
    with torch.no_grad():
        return model.apply(model.params, *inputs)


class TestFingerprint:
    def _ios(self, model, x, **kw):
        sess = OffloadSession(model, "rrto", min_repeats=3, execute=False, device="cpu", **kw)
        sess.load()
        for _ in range(5):
            sess.infer(x)
        assert sess.client.ios is not None
        return ios_fingerprint(sess.client.ios.records)

    def test_stable_across_clients(self):
        """Two independent sessions (own interceptor, own allocator) running
        the same model produce the same IOS fingerprint."""
        model, x = make_mlp()
        assert self._ios(model, x, seed=0) == self._ios(model, x, seed=1)

    def test_differs_across_models(self):
        (a, xa), (b, xb) = make_mlp(), make_deep_mlp()
        assert self._ios(a, xa) != self._ios(b, xb)

    def test_param_values_do_not_matter(self):
        """Same architecture, other weights -> same fingerprint."""
        (a, x), (b, _) = make_mlp(seed=0), make_mlp(seed=7)
        assert self._ios(a, x) == self._ios(b, x)

    def test_candidates_filtered_by_length(self):
        """The adoption probe's length filter skips every window whose
        length no cached IOS has, before any check."""
        model, x = make_mlp()
        sess = OffloadSession(model, "rrto", min_repeats=9, execute=False, device="cpu")
        for _ in range(2):
            sess.infer(x)
        logs = sess.client.logs
        cands = list(candidate_sequences(logs))
        assert cands
        n = len(cands[0])
        assert [len(c) for c in candidate_sequences(logs, lengths={n})] == [n]
        assert list(candidate_sequences(logs, lengths={n + 1})) == []


class TestCacheAdoption:
    def test_late_client_skips_recording(self):
        """A client joining after the cache is warm adopts the IOS after a
        single recorded inference instead of min_repeats of them."""
        model, x = make_mlp()
        edge = edge_server()
        first = edge.connect(model, min_repeats=3)
        for _ in range(3):
            run_round(edge, {"c0": (x,)})
        assert first.client.mode == "replaying"
        assert not first.client.cache_adopted

        late = edge.connect(model, min_repeats=3)
        run_round(edge, {"c0": (x,), "c1": (x,)})
        assert late.client.mode == "replaying"
        assert late.client.cache_adopted
        assert late.client.stats.cache_adoptions == 1
        assert [r.mode for r in late.history] == ["recording"]  # one, not three

    def test_compile_exactly_once(self):
        model, x = make_mlp()
        edge = edge_server()
        edge.connect(model)
        for _ in range(3):
            run_round(edge, {"c0": (x,)})
        for i in range(3):
            edge.connect(model)
            run_round(edge, {f"c{j}": (x,) for j in range(i + 2)})
        assert edge.compile_count == 1
        assert edge.cache.stats.hits == 3  # one bind per adopting client

    def test_batched_replay_outputs_correct(self):
        model, x = make_mlp()
        ref = eager(model, x)[0]
        edge = edge_server()
        for _ in range(3):
            edge.connect(model)
        ids = list(edge.sessions)
        for _ in range(4):
            results = run_round(edge, {c: (x,) for c in ids})
        assert all(s.client.mode == "replaying" for s in edge.sessions.values())
        for r in results.values():
            torch.testing.assert_close(r.outputs[0], ref, rtol=1e-5, atol=1e-5)
        assert edge.batcher.batches_executed >= 1
        assert max(edge.batcher.batch_sizes) == 3

    def test_vmap_batch_bitwise_equals_loop(self):
        """Shared-param co-tenants execute as one vmap-batched call; the
        outputs are bitwise the per-client loop's."""
        model, _ = make_mlp()
        rng = np.random.default_rng(5)
        per_client = {f"c{i}": _t(rng.normal(0, 1, (2, 16)).astype(np.float32))
                      for i in range(3)}

        def run(enable_vmap):
            edge = edge_server()
            edge.batcher.enable_vmap = enable_vmap
            for _ in range(3):
                edge.connect(model)
            for _ in range(5):
                results = run_round(edge, {c: (x,) for c, x in per_client.items()})
            return results, edge

        vmapped, edge_v = run(True)
        looped, edge_l = run(False)
        assert edge_v.batcher.vmap_batches >= 1
        assert edge_l.batcher.vmap_batches == 0
        for c in per_client:
            assert torch.equal(vmapped[c].outputs[0], looped[c].outputs[0])

    def test_vmap_disabled_falls_back_to_loop(self):
        model, x = make_mlp()
        edge = edge_server()
        edge.batcher.enable_vmap = False
        for _ in range(3):
            edge.connect(model)
        ids = list(edge.sessions)
        for _ in range(5):
            results = run_round(edge, {c: (x,) for c in ids})
        assert edge.batcher.vmap_batches == 0
        assert edge.batcher.batches_executed >= 1
        for r in results.values():
            torch.testing.assert_close(r.outputs[0], eager(model, x)[0], rtol=1e-5, atol=1e-5)

    def test_per_client_params_isolated(self):
        """Same architecture, other weights: one shared program, each client
        its own parameter memory (the group runs the per-client loop)."""
        (m0, x), (m1, _) = make_mlp(seed=0), make_mlp(seed=7)
        edge = edge_server()
        edge.connect(m0)
        edge.connect(m1)
        for _ in range(4):
            results = run_round(edge, {"c0": (x,), "c1": (x,)})
        assert edge.compile_count == 1
        assert edge.batcher.vmap_batches == 0
        for model, cid in ((m0, "c0"), (m1, "c1")):
            torch.testing.assert_close(results[cid].outputs[0], eager(model, x)[0],
                                       rtol=1e-5, atol=1e-5)


class TestPaddedVmapWidths:
    def test_padded_widths_reuse_programs(self):
        """A width-3 round reuses the width-4 batched program a width-4 round
        built (O(log N) builds per fingerprint), with correct outputs."""
        model, x = make_mlp()
        edge = edge_server()
        for _ in range(4):
            edge.connect(model)
        ids = list(edge.sessions)
        for _ in range(4):
            run_round(edge, {c: (x,) for c in ids})
        assert all(s.client.mode == "replaying" for s in edge.sessions.values())
        run_round(edge, {c: (x,) for c in ids})          # width 4 -> #vmap4
        assert any("#vmap4" in k for k in edge.cache.fingerprints)
        builds, avoided = edge.batcher.vmap_compiles, edge.batcher.vmap_compiles_avoided
        results = run_round(edge, {c: (x,) for c in ids[:3]})   # width 3 -> 4
        assert edge.batcher.vmap_compiles == builds
        assert edge.batcher.vmap_compiles_avoided == avoided + 1
        assert edge.batcher.vmap_padded_lanes >= 1
        assert not any("#vmap3" in k for k in edge.cache.fingerprints)
        for r in results.values():
            torch.testing.assert_close(r.outputs[0], eager(model, x)[0], rtol=1e-5, atol=1e-5)

    def test_padded_width_helper(self):
        assert [mt._padded_width(n) for n in (1, 2, 3, 4, 5, 8, 9)] == [2, 2, 4, 4, 8, 8, 16]

    def test_padded_lanes_never_inflate_energy_or_occupancy(self):
        """A width-3 group runs a padded width-4 program, but billing is by
        real lanes: per-client energy and the group's GPU occupancy equal
        the unpadded per-client loop's."""
        model, x = make_mlp()

        def run(enable_vmap):
            edge = edge_server()
            edge.batcher.enable_vmap = enable_vmap
            for _ in range(3):
                edge.connect(model)
            ids = list(edge.sessions)
            for _ in range(4):
                run_round(edge, {c: (x,) for c in ids})
            busy0 = edge.server.busy_seconds
            results = run_round(edge, {c: (x,) for c in ids})
            return edge, results, edge.server.busy_seconds - busy0

        vmap_edge, vmap_res, vmap_busy = run(True)
        loop_edge, loop_res, loop_busy = run(False)
        assert vmap_edge.batcher.vmap_padded_lanes >= 1
        assert loop_edge.batcher.vmap_padded_lanes == 0
        assert vmap_busy == pytest.approx(loop_busy, rel=1e-12)
        program = vmap_edge.server.context("c0").replay.program
        assert vmap_busy == pytest.approx(
            program.batched_compute_seconds(vmap_edge.server.device_spec, 3), rel=1e-12
        )
        for cid in vmap_res:
            assert vmap_res[cid].joules == pytest.approx(loop_res[cid].joules, rel=1e-12)

    def test_aborted_vmap_batch_leaves_padding_stats_clean(self):
        """A group that bails out of the vmap path (a stateful member whose
        carried state is not seeded) runs the per-client loop: no padded
        lane or avoided build is counted for it."""
        model, x, state0 = make_rnn()
        edge = edge_server()
        for _ in range(3):
            edge.connect(model)
        ids = list(edge.sessions)
        states = {c: state0 for c in ids}
        for _ in range(5):
            results = run_round(edge, {c: (x, states[c]) for c in ids})
            for c in ids:
                states[c] = results[c].outputs[1]
        assert all(s.client.mode == "replaying" for s in edge.sessions.values())
        padded0 = edge.batcher.vmap_padded_lanes
        avoided0 = edge.batcher.vmap_compiles_avoided
        batches0 = edge.batcher.vmap_batches
        bound = edge.server.context(ids[-1]).replay
        saved, bound.carried_state = bound.carried_state, None
        try:
            key = edge.sessions[ids[0]].client.ios_fp
            edge.batcher.begin_round({key: [
                (edge.sessions[c].client, edge.sessions[c].replay_wire_inputs((x, states[c])))
                for c in ids
            ]})
            group = edge.batcher._execute_group(key, edge.clock.t)
        finally:
            bound.carried_state = saved
        assert group is not None and group.outs is None   # loop fallback
        assert edge.batcher.vmap_batches == batches0
        assert edge.batcher.vmap_padded_lanes == padded0
        assert edge.batcher.vmap_compiles_avoided == avoided0


class TestDigestCache:
    def test_digest_cached_per_bound_replay(self):
        """The wire-input shape/dtype digest is computed once per binding
        and reused across rounds."""
        model, x = make_mlp()
        edge = edge_server()
        for _ in range(2):
            edge.connect(model)
        ids = list(edge.sessions)
        for _ in range(5):
            run_round(edge, {c: (x,) for c in ids})
        assert all(s.client.mode == "replaying" for s in edge.sessions.values())
        hits0 = edge.batcher.digest_cache_hits
        for _ in range(3):
            run_round(edge, {c: (x,) for c in ids})
        assert edge.batcher.digest_cache_hits >= hits0 + 3

    def test_mismatched_submission_still_rejected(self):
        """A submission whose values differ from the preload replays solo,
        with its own inputs."""
        model, x = make_mlp()
        edge = edge_server()
        sess = edge.connect(model)
        for _ in range(4):
            run_round(edge, {"c0": (x,)})
        assert sess.client.mode == "replaying"
        cl = sess.client
        wire = sess.replay_wire_inputs((x,))
        edge.batcher.begin_round({cl.ios_fp: [(cl, wire)]})
        wrong = [w + 1.0 for w in wire]
        solo0 = edge.batcher.solo_replays
        outs, _ = edge.batcher.submit(cl, wrong, edge.clock.t)
        assert edge.batcher.solo_replays == solo0 + 1
        torch.testing.assert_close(outs[0], eager(model, wrong[0])[0], rtol=1e-5, atol=1e-5)


class TestLRUEviction:
    def test_evicts_least_recently_used(self):
        class P:
            pass

        cache = ReplayCache(capacity=2)
        pa, pb, pc = P(), P(), P()
        cache.put("a", pa)
        cache.put("b", pb)
        assert cache.get("a") is pa  # touch a -> b becomes LRU
        cache.put("c", pc)
        assert "b" not in cache and "a" in cache and "c" in cache
        assert cache.stats.evictions == 1

    def test_refetch_after_eviction_rebuilds(self):
        """Evicting a fingerprint forces a rebuild on the next miss."""
        (model_a, xa), (model_b, xb) = make_mlp(), make_deep_mlp()
        edge = edge_server()
        edge.cache.capacity = 1
        edge.connect(model_a)
        for _ in range(3):
            run_round(edge, {"c0": (xa,)})
        edge.connect(model_b)           # c1 locks model B -> evicts A
        for _ in range(3):
            run_round(edge, {"c0": (xa,), "c1": (xb,)})
        assert edge.compile_count == 2
        assert edge.cache.stats.evictions == 1
        edge.connect(model_a)           # misses the evicted entry: rebuilds
        for _ in range(3):
            run_round(edge, {"c0": (xa,), "c1": (xb,), "c2": (xa,)})
        assert edge.sessions["c2"].client.mode == "replaying"
        assert edge.compile_count == 3


class TestSizeAwareCache:
    class _P:
        def __init__(self, nbytes):
            self.nbytes_estimate = nbytes

    def test_evicts_by_bytes(self):
        cache = ReplayCache(capacity=8, capacity_bytes=1000)
        cache.put("a", self._P(400))
        cache.put("b", self._P(400))
        assert cache.bytes_total == 800
        cache.put("c", self._P(400))     # 1200 > 1000 -> evict LRU (a)
        assert "a" not in cache and "b" in cache and "c" in cache
        assert cache.stats.evictions == 1
        assert cache.stats.bytes_evicted == 400

    def test_pinned_entries_survive(self):
        cache = ReplayCache(capacity=8, capacity_bytes=1000)
        cache.put("a", self._P(400))
        cache.pin("a")
        cache.put("b", self._P(400))
        cache.put("c", self._P(400))     # evicts b, not pinned a
        assert "a" in cache and "b" not in cache and "c" in cache

    def test_pin_covers_derived_entries(self):
        cache = ReplayCache(capacity=8, capacity_bytes=1000)
        cache.pin("fp")
        cache.put("fp", self._P(300))
        cache.put("fp#vmap2", self._P(300))
        cache.put("fp#vmap4", self._P(300))
        cache.put("other", self._P(300))   # over budget: the only victim
        assert "other" not in cache
        assert all(k in cache for k in ("fp", "fp#vmap2", "fp#vmap4"))

    def test_unpin_reenables_eviction(self):
        cache = ReplayCache(capacity=8, capacity_bytes=500)
        cache.pin("a")
        cache.put("a", self._P(400))
        cache.put("b", self._P(400))     # denied: everything else is pinned
        assert "a" in cache and "b" not in cache
        cache.unpin("a")
        cache.put("b", self._P(400))
        assert "b" in cache and "a" not in cache

    def test_oversized_entry_stays_alone(self):
        cache = ReplayCache(capacity=8, capacity_bytes=100)
        cache.put("big", self._P(5000))
        assert "big" in cache

    def test_entry_count_capacity_still_applies(self):
        cache = ReplayCache(capacity=2)
        for k in "abc":
            cache.put(k, self._P(10))
        assert "a" not in cache and len(cache) == 2

    def test_derived_vmap_entries_never_evict_base_programs(self):
        cache = ReplayCache(capacity=4)
        cache.put("fpA", self._P(10))
        cache.put("fpB", self._P(10))
        for w in (2, 3, 4):
            cache.put(f"fpA#vmap{w}", self._P(10))   # over entry capacity
        assert "fpA" in cache and "fpB" in cache
        assert sum(1 for k in cache.fingerprints if "#" in k) == 2

    def test_evicting_base_purges_its_derived_entries(self):
        cache = ReplayCache(capacity=8, capacity_bytes=100)
        cache.put("fpA", self._P(40))
        cache.put("fpA#vmap2", self._P(10))
        cache.put("fpB", self._P(80))   # evicts the vmap entry, then fpA
        assert "fpA" not in cache and "fpA#vmap2" not in cache
        assert "fpB" in cache

    def test_claimed_derived_entry_pins_base(self):
        cache = ReplayCache(capacity=8, capacity_bytes=1000)
        cache.put("fp", self._P(400))
        cache.claim("fp#vmap4")
        cache.put("fp#vmap4", self._P(300))
        cache.put("other", self._P(400))     # over budget
        assert "fp" in cache and "fp#vmap4" in cache
        cache.release("fp#vmap4")
        cache.put("other2", self._P(400))    # derived entries evict first
        assert "fp#vmap4" not in cache and "fp" in cache
        cache.put("other3", self._P(400))    # now the base is the LRU victim
        assert "fp" not in cache

    def test_claims_nest(self):
        cache = ReplayCache(capacity=8, capacity_bytes=800)
        cache.put("fp", self._P(400))
        cache.claim("fp#vmap2")
        cache.claim("fp#vmap4")
        cache.put("big", self._P(700))
        assert "fp" in cache
        cache.release("fp#vmap2")
        cache.put("big", self._P(700))
        assert "fp" in cache                 # one claim still held
        cache.release("fp#vmap4")
        cache.put("big", self._P(700))
        assert "fp" not in cache

    def test_batcher_round_claims_protect_in_flight_bases(self):
        """While a round's vmap batch is in flight, cache pressure cannot
        evict its base; ending the round releases the claim."""
        model, x = make_mlp()
        edge = edge_server()
        for _ in range(2):
            edge.connect(model)
        ids = list(edge.sessions)
        for _ in range(4):
            run_round(edge, {c: (x,) for c in ids})
        fp = edge.sessions["c0"].client.ios_fp
        edge.cache.capacity_bytes = edge.cache.bytes_total
        edge.batcher.begin_round({fp: [
            (edge.sessions[c].client, edge.sessions[c].replay_wire_inputs((x,))) for c in ids
        ]})
        with no_vmap_fallback():
            edge.batcher._execute_group(fp, edge.clock.t)
        budget = edge.cache.capacity_bytes
        edge.cache.put("other", self._P(budget))   # refused: the rest is claimed
        assert fp in edge.cache and f"{fp}#vmap2" in edge.cache and "other" not in edge.cache
        edge.batcher.end_round()
        assert not edge.cache.is_pinned(fp)
        edge.cache.put("other2", self._P(budget))
        assert fp not in edge.cache and "other2" in edge.cache

    def test_program_nbytes_counts_output_staging(self):
        """A real program's size: its output staging buffers (it holds no
        tensor of its own); a batched one holds its base's constants once
        and the staging buffers once per lane."""
        model, x = make_mlp()
        sess = OffloadSession(model, "rrto", device="cpu")
        for _ in range(4):
            sess.infer(x)
        program = sess.server.context().replay.program
        assert program.consts_nbytes == 0
        assert program.nbytes_estimate == program.staging_nbytes == 2 * 8 * 4
        assert program.build_batched(4).nbytes_estimate == 4 * program.staging_nbytes
        program.consts_nbytes = 1000
        assert program.build_batched(4).nbytes_estimate == 1000 + 4 * 2 * 8 * 4


class TestBatcherInputDigest:
    def test_mixed_shape_cotenants_fall_to_solo(self):
        a = [torch.zeros((2, 8))]
        b = [torch.zeros((4, 8))]
        assert not mt._inputs_equal(a, b)
        assert mt._inputs_equal(a, [torch.zeros((2, 8))])
        assert not mt._inputs_equal(a, [torch.zeros((2, 8), dtype=torch.float64)])
        group = mt._BatchGroup(done_at=0.0, pending={"c0": a})
        assert not group.claim("c0", b)
        assert not group.claim("c0", b)  # popped: a second claim misses

    def test_digest_short_circuits_value_compare(self, monkeypatch):
        calls = {"n": 0}
        real = mt.bits_equal

        def counting(x, y):
            calls["n"] += 1
            return real(x, y)

        monkeypatch.setattr(mt, "bits_equal", counting)
        assert not mt._inputs_equal([torch.zeros((2, 8))], [torch.zeros((4, 8))])
        assert calls["n"] == 0
        assert mt._inputs_equal([torch.zeros((2, 8))], [torch.zeros((2, 8))])
        assert calls["n"] == 1


class TestCachePersistence:
    def test_save_load_roundtrip_metadata(self, tmp_path):
        model, x = make_mlp()
        edge = edge_server()
        edge.connect(model)
        for _ in range(3):
            run_round(edge, {"c0": (x,)})
        path = str(tmp_path / "replay_cache.json")
        assert edge.save_cache(path) == 1
        fp = edge.cache.fingerprints[0]
        fresh = ReplayCache()
        assert fresh.load(path) == 1
        assert fp in fresh                      # the IOS is validated
        assert fresh.get(fp) is None            # but no program yet
        meta = fresh.known_metadata(fp)
        assert meta["n_kernels"] > 0 and meta["total_flops"] > 0
        assert fresh.ios_lengths() == {meta["n_records"]}

    def test_restarted_server_skips_revalidation(self, tmp_path):
        """A client joining the restarted server adopts the persisted IOS
        after ONE recorded inference; the program is built once."""
        model, x = make_mlp()
        warm = edge_server()
        warm.connect(model)
        for _ in range(3):
            run_round(warm, {"c0": (x,)})
        path = str(tmp_path / "cache.json")
        warm.save_cache(path)
        cold = edge_server()
        cold.load_cache(path)
        sess = cold.connect(model)
        run_round(cold, {"c0": (x,)})
        assert sess.client.mode == "replaying" and sess.client.cache_adopted
        assert [r.mode for r in sess.history] == ["recording"]
        res = run_round(cold, {"c0": (x,)})["c0"]
        torch.testing.assert_close(res.outputs[0], eager(model, x)[0], rtol=1e-5, atol=1e-5)
        assert cold.compile_count == 1

    def test_restart_rebuilds_stateful(self, tmp_path):
        """The persisted carried pairs make the rebuilt program stateful
        again, although the adopting client recorded a single round."""
        model, x, state0 = make_rnn()
        warm = edge_server()
        warm.connect(model)
        state = state0
        for _ in range(4):
            state = run_round(warm, {"c0": (x, state)})["c0"].outputs[1]
        path = str(tmp_path / "cache.json")
        warm.save_cache(path)
        pairs = json.load(open(path))["fingerprints"].popitem()[1]["carried_pairs"]
        assert pairs == [[1, 1]]
        cold = edge_server()
        cold.load_cache(path)
        sess = cold.connect(model)
        state, ys = state0, []
        for _ in range(4):
            res = run_round(cold, {"c0": (x, state)})["c0"]
            state = res.outputs[1]
            ys.append(res.outputs[0])
        assert sess.client.cache_adopted and sess.client.stateful_replay
        ref = state0
        for y in ys:
            want, ref = eager(model, x, ref)
            torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)

    def test_stale_persisted_pairs_are_dropped(self, tmp_path):
        """Metadata whose carried pairs do not fit the calls builds a
        stateless program and forgets the entry."""
        model, x = make_mlp()
        warm = edge_server()
        warm.connect(model)
        for _ in range(3):
            run_round(warm, {"c0": (x,)})
        path = tmp_path / "cache.json"
        warm.save_cache(str(path))
        data = json.loads(path.read_text())
        fp = next(iter(data["fingerprints"]))
        data["fingerprints"][fp]["carried_pairs"] = [[5, 0]]
        path.write_text(json.dumps(data))
        cold = edge_server()
        cold.load_cache(str(path))
        sess = cold.connect(model)
        for _ in range(2):
            res = run_round(cold, {"c0": (x,)})["c0"]
        assert not cold.server.context("c0").replay.program.is_stateful
        assert cold.cache.known_metadata(fp) is None
        assert sess.client.mode == "replaying"
        torch.testing.assert_close(res.outputs[0], eager(model, x)[0], rtol=1e-5, atol=1e-5)

    def test_version_mismatch_rejected(self, tmp_path):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps({"version": 99, "fingerprints": {}}))
        with pytest.raises(ValueError, match="version"):
            ReplayCache().load(str(path))


class TestSingleClientEquivalence:
    def test_edge_single_client_matches_plain_session(self):
        """One client through the multi-tenant stack behaves like the plain
        single-tenant session: same outputs, modes and RPC counts."""
        model, x = make_mlp()
        plain = OffloadSession(model, "rrto", network=indoor_network(0), min_repeats=3,
                               device="cpu")
        plain_hist = [plain.infer(x) for _ in range(6)]
        edge = edge_server()
        edge.connect(model, seed=0)
        edge_hist = [run_round(edge, {"c0": (x,)})["c0"] for _ in range(6)]
        for p, e in zip(plain_hist, edge_hist):
            assert p.mode == e.mode
            assert p.rpcs == e.rpcs
            assert torch.equal(p.outputs[0], e.outputs[0])

    def test_ingress_contention_slows_transfers(self):
        ing = ServerIngress(capacity_bytes_per_s=10e6)
        net = indoor_network(0)
        net.ingress = ing
        t1 = net.transfer_time(1e6, 0.0)
        ing.active_clients = 10
        t10 = net.transfer_time(1e6, 0.0)
        assert t10 > t1 * 5  # fair share: 10 MB/s -> 1 MB/s per client
        assert ing.bytes_total == 2e6

    def test_execute_conflict_with_shared_server_raises(self):
        model, _ = make_mlp()
        edge = edge_server(execute=False)
        with pytest.raises(ValueError, match="execute"):
            edge.connect(model, execute=True)


class TestSessionMoves:
    def test_disconnect_and_adopt_session(self):
        """A session moved to another edge keeps its client state; the
        server-side context is the mover's to transfer (here the same
        server object stands in for it)."""
        model, x = make_mlp()
        a = edge_server()
        sess = a.connect(model)
        for _ in range(4):
            run_round(a, {"c0": (x,)})
        b = RRTOEdgeServer(device="cpu", clock=a.clock)
        b.server = a.server
        b.batcher.server = a.server
        moved = a.disconnect("c0")
        b.adopt_session(moved)
        assert a.sessions_migrated_out == 1 and b.sessions_adopted == 1
        res = run_round(b, {"c0": (x,)})["c0"]
        assert res.mode == "replaying" and res.rpcs == 2
        with pytest.raises(ValueError, match="already connected"):
            b.adopt_session(moved)
        with pytest.raises(ValueError, match="SimClock"):
            edge_server().adopt_session(a.connect(model))


class TestStatefulBatched:
    def test_multitenant_stateful_batched(self):
        """Co-tenant recurrent apps replay as one vmap-batched stateful step;
        per-client state trajectories stay isolated and correct, and equal
        the per-client loop's bit for bit."""
        model, x, state0 = make_rnn()
        rng = np.random.default_rng(7)
        xs = {f"c{i}": _t(rng.normal(0, 1, x.shape).astype(np.float32)) for i in range(3)}
        rounds = 8

        def run(enable_vmap):
            edge = edge_server()
            edge.batcher.enable_vmap = enable_vmap
            for _ in xs:
                edge.connect(model)
            states = {c: state0 for c in xs}
            for _ in range(rounds):
                results = run_round(edge, {c: (xs[c], states[c]) for c in xs})
                for c in xs:
                    states[c] = results[c].outputs[1]
            return edge, results

        edge, results = run(True)
        loop_edge, loop_results = run(False)
        for c in xs:
            state = state0
            for _ in range(rounds):
                y, state = eager(model, xs[c], state)
            torch.testing.assert_close(results[c].outputs[0], y, rtol=1e-6, atol=1e-6)
            assert torch.equal(results[c].outputs[0], loop_results[c].outputs[0])
            mine = edge.server.context(c).replay.carried_state
            theirs = loop_edge.server.context(c).replay.carried_state
            assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
        assert edge.batcher.vmap_batches >= 1 and loop_edge.batcher.vmap_batches == 0
        assert edge.compile_count == 1


class TestDeviationDuringFormedRound:
    """A DAM deviation while the batcher holds the client's preload in a
    formed round: the deviant exits the round cleanly (reverts to
    recording, correct result) and its co-tenants' batched replays stay
    bitwise those of an edge that never saw the deviation."""

    CIDS = ("c0", "c1", "c2")

    def _build(self):
        edge = edge_server()
        model, x = make_mlp()
        for cid in self.CIDS:
            edge.connect(model, client_id=cid, min_repeats=2)
        for _ in range(4):
            run_round(edge, {cid: (x,) for cid in self.CIDS})
        assert all(edge.sessions[c].client.mode == "replaying" for c in self.CIDS)
        assert len({edge.sessions[c].client.ios_fp for c in self.CIDS}) == 1
        return edge, x

    def test_deviant_exits_round_cleanly_cotenants_bitwise(self):
        edge, x = self._build()
        control, x_ctl = self._build()
        want = run_round(control, {cid: (x_ctl,) for cid in self.CIDS})

        entries = {}
        for cid in self.CIDS:
            sess = edge.sessions[cid]
            entries.setdefault(sess.client.ios_fp, []).append(
                (sess.client, sess.replay_wire_inputs((x,)))
            )
        edge.batcher.begin_round(entries)
        with no_vmap_fallback():
            res = {cid: edge.sessions[cid].infer(x) for cid in ("c0", "c1")}

        # c2 — still preloaded in the formed round — runs another op stream
        # through its own interceptor: relu where the IOS recorded tanh @ w2
        sess2 = edge.sessions["c2"]
        w1 = _t(np.random.default_rng(0).normal(0, 0.1, (16, 32)).astype(np.float32))
        graph = trace_app(lambda ls, xx: [torch.relu(xx @ ls[0])], [w1], [x])
        addrs = sess2.interceptor.upload_params(graph.consts)
        with no_vmap_fallback():
            out2 = sess2.interceptor.run(graph, addrs, [x])
        edge.batcher.end_round()

        deviant = sess2.client
        assert deviant.fallbacks >= 1 and deviant.mode == "recording"
        torch.testing.assert_close(out2[0], torch.relu(x @ w1), rtol=1e-6, atol=1e-6)
        for cid in ("c0", "c1"):
            assert torch.equal(res[cid].outputs[0], want[cid].outputs[0])
        # the deviant's abandoned preload is the one unclaimed lane; the next
        # round's formation sweeps it
        assert edge.batcher.pending_depth == 1
        for _ in range(4):
            run_round(edge, {cid: (x,) for cid in self.CIDS})
        assert edge.batcher.pending_depth == 0
        assert edge.sessions["c2"].client.mode == "replaying"
        final = run_round(edge, {cid: (x,) for cid in self.CIDS})
        ctl_final = run_round(control, {cid: (x_ctl,) for cid in self.CIDS})
        for cid in self.CIDS:
            assert torch.equal(final[cid].outputs[0], ctl_final[cid].outputs[0])


class TestRecordingScaling:
    """``benchmarks/multiclient_scaling.py``'s claim in the port: clients
    join one by one, every client after the first adopts the cached IOS
    (the one joining while the first is still recording needs two
    inferences, every later one a single inference), one program is built,
    and the recording RPCs grow sublinearly in the client count — with the
    reference's recording-inference and adoption counts."""

    @staticmethod
    def run_point(model, x, n):
        edge = edge_server(execute=False)
        joined = []
        while len(joined) < n or not all(
            edge.sessions[c].client.mode == "replaying" for c in joined
        ):
            if len(joined) < n:
                joined.append(edge.connect(model).client_id)
            run_round(edge, {c: (x,) for c in joined})
        solo = sum(r.rpcs for r in edge.sessions["c0"].history if r.mode == "recording")
        rec_inferences = sum(
            sum(1 for r in s.history if r.mode == "recording") for s in edge.sessions.values()
        )
        adopted = sum(1 for s in edge.sessions.values() if s.client.cache_adopted)
        return edge.recording_rpc_total(), solo, rec_inferences, adopted, edge.compile_count

    def test_sublinear_recording_like_the_reference(self):
        jnp = pytest.importorskip("jax.numpy")
        from repro.core.offload import OffloadableModel as JModel
        from repro.serving.multitenant import RRTOEdgeServer as JEdge

        rng = np.random.default_rng(0)
        w = {k: rng.normal(0, 0.1, s).astype(np.float32)
             for k, s in (("w1", (16, 32)), ("w2", (32, 8)))}
        x = rng.normal(0, 1, (2, 16)).astype(np.float32)
        model = OffloadableModel("mlp", lambda p, x: [torch.tanh(x @ p["w1"]) @ p["w2"]],
                                 {k: _t(v) for k, v in w.items()}, (_t(x),))
        jmodel = JModel("mlp", lambda p, x: [jnp.tanh(x @ p["w1"]) @ p["w2"]], w, (x,))
        for n in (1, 4, 8):
            total, solo, rec, adopted, builds = self.run_point(model, _t(x), n)
            assert builds == 1
            assert adopted == n - 1 and rec <= 3 + 2 * (n - 1)
            assert total < n * solo if n > 1 else total == solo
            jedge = JEdge(execute=False)
            for _ in range(n):
                jedge.connect(jmodel)
                jedge.run_round({c: (x,) for c in jedge.sessions})
            while not all(s.client.mode == "replaying" for s in jedge.sessions.values()):
                jedge.run_round({c: (x,) for c in jedge.sessions})
            j_rec = sum(sum(1 for r in s.history if r.mode == "recording")
                        for s in jedge.sessions.values())
            j_adopted = sum(1 for s in jedge.sessions.values() if s.client.cache_adopted)
            assert (rec, adopted, builds) == (j_rec, j_adopted, jedge.compile_count)


# ---------------------------------------------------------------------------
# MultiClientServedLM against the reference's, on the same numpy params
# ---------------------------------------------------------------------------

LM_CASES = {
    "qwen3-stateful": ("qwen3-0.6b", {}, True),
    "zamba2-stateless": ("zamba2-1.2b", dict(n_layers=5, attn_every=2), False),
    "mixtral-stateful": ("mixtral-8x7b", {}, True),
    "mixtral-stateless": ("mixtral-8x7b", {}, False),
}


@pytest.fixture(scope="module", params=list(LM_CASES))
def lm_runs(request):
    jax = pytest.importorskip("jax")
    from repro.configs.registry import get_reduced_config as j_reduced
    from repro.models.registry import get_model as j_get_model
    from repro.serving.engine import MultiClientServedLM as JMulti
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.engine import MultiClientServedLM

    name, kw, stateful = LM_CASES[request.param]
    cfg_j, cfg = j_reduced(name, **kw), get_reduced_config(name, **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (1, n)).astype(np.int32) for n in (5, 6, 7)]
    ref = JMulti(cfg_j, 3, bucket_len=24, seed=3, stateful=stateful)
    ref_tokens = ref.generate(prompts, 6)
    params = params_from_numpy(
        jax.tree.map(np.asarray, j_get_model(cfg_j).init_params(jax.random.PRNGKey(3), cfg_j)),
        cfg, "cpu",
    )
    runs = {}
    for enable_vmap in (True, False):
        port = MultiClientServedLM(cfg, 3, bucket_len=24, params=params, device="cpu",
                                   stateful=stateful)
        port.edge.batcher.enable_vmap = enable_vmap
        with no_vmap_fallback():
            runs[enable_vmap] = (port, port.generate(prompts, 6))
    return dict(ref=ref, ref_tokens=ref_tokens, runs=runs, stateful=stateful)


def test_lm_tokens_and_counts_match_reference(lm_runs):
    """Tokens per client equal the reference's; one program built, the same
    number of vmap batches, cache hits and adoptions, the same mode
    trajectory and 3 RPCs per replayed token."""
    ref = lm_runs["ref"]
    port, tokens = lm_runs["runs"][True]
    for ours, theirs in zip(tokens, lm_runs["ref_tokens"]):
        np.testing.assert_array_equal(ours.tokens, theirs.tokens)
    assert port.edge.compile_count == ref.edge.compile_count == 1
    assert port.edge.batcher.vmap_batches == ref.edge.batcher.vmap_batches >= 1
    assert port.edge.cache.stats.hits == ref.edge.cache.stats.hits
    for mine, theirs in zip(port.clients, ref.clients):
        assert mine.session.client.cache_adopted == theirs.session.client.cache_adopted
        assert [h.mode for h in mine.session.history] == [h.mode for h in theirs.session.history]
        assert [h.rpcs for h in mine.session.history if h.mode == "replaying"] == [
            h.rpcs for h in theirs.session.history if h.mode == "replaying"
        ]
        assert mine.session.history[-1].rpcs == 3
    assert all(c.session.client.stateful_replay == lm_runs["stateful"] for c in port.clients)


def test_lm_vmap_bitwise_equals_loop(lm_runs):
    """The vmap-batched rounds against the per-client loop: the same tokens,
    and for the stateful app the same server-resident caches, bit for bit."""
    (vport, vtokens), (lport, ltokens) = lm_runs["runs"][True], lm_runs["runs"][False]
    assert lport.edge.batcher.vmap_batches == 0
    for a, b in zip(vtokens, ltokens):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for c in vport.edge.sessions:
        mine = vport.edge.server.context(c).replay
        theirs = lport.edge.server.context(c).replay
        if lm_runs["stateful"]:
            assert all(torch.equal(a, b) for a, b in zip(mine.carried_state, theirs.carried_state))
        env_a, env_b = vport.edge.server.context(c).env, lport.edge.server.context(c).env
        for addr in mine.d2h_addrs:
            assert torch.equal(env_a[addr], env_b[addr])
