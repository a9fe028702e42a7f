"""The replay soundness verifier in the port (tests/test_analysis.py): the
four static passes (dataflow, donation, plan/cache-key, protocol), the seeded
mutation corpus, the clean-on-real-IOS property, the engine/cache fail-fast
hooks and the CLI sweep, on the port's IR.  Then the same inputs through
both packages: the diagnostic codes, each fixture's and each hand-built IOS's
``(code, severity, where)``, the protocol checker's findings, the registry
models' censuses and carried pairs, a reduced qwen3 served verified on an
edge, and the aten counterpart of the reference's nondeterministic
primitives."""
from __future__ import annotations

import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (  # noqa: E402
    CODES,
    NONDETERMINISTIC_PRIMS,
    AnalysisReport,
    Diagnostic,
    ProtocolSpec,
    ReplaySoundnessError,
    check_engine_protocol,
    check_protocol,
    check_sequencing,
    lint_ios,
    op_census,
    raise_on_errors,
    sanitize_donation,
    split_cache_key,
    verify_cache_key,
    verify_calls,
    verify_ios,
    verify_metadata_against_calls,
    verify_persisted_entry,
    verify_plan,
    verify_split_calls,
)
from repro_torch.core.costmodel import GTX_2080TI, JETSON_XAVIER_NX  # noqa: E402
from repro_torch.core.engine import ReplayProgram, SegmentedReplayProgram  # noqa: E402
from repro_torch.core.intercept import InterceptedCall  # noqa: E402
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.core.records import (  # noqa: E402
    CAT_D2D,
    FUNC_D2H,
    FUNC_H2D,
    OperatorRecord,
    kernel_primitive,
)
from repro_torch.models.cnn_zoo import ZOO  # noqa: E402
from repro_torch.partition.planner import PartitionConfig, plan_partition  # noqa: E402
from repro_torch.partition.segments import SegmentGraph, SplitPlan  # noqa: E402

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "broken_ios")
MBPS = 1e6 / 8.0

REGISTRY_CASES = {
    "sensor_encoder": dict(scale=0.25, input_size=32, n_blocks=2),
    "recurrent_sensor_decoder": dict(
        scale=0.25, input_size=32, n_blocks=2, d_state=32
    ),
}
# carried-state threading of the stateful registry entry: (output, input)
THREAD = {"recurrent_sensor_decoder": (1, 1)}


# ---------------------------------------------------------------------------
# fixture loader: JSON call specs -> the port's InterceptedCall IR
# ---------------------------------------------------------------------------

class _Op:
    """Stand-in aten op: the verifier only tests ``op is not None``."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"_Op({self.name!r})"


def _nbytes(shape, dtype):
    return int(np.dtype(dtype).itemsize * int(np.prod(shape or (1,))))


def build_calls(specs):
    """Materialize fixture call specs as the IR the engine hands the
    verifier (a real :class:`OperatorRecord` inside each call, torch avals)."""
    calls = []
    for s in specs:
        shape = tuple(s.get("shape", ()))
        dtype = s.get("dtype", "float32")
        tdtype = getattr(torch, dtype)
        nb = _nbytes(shape, dtype)
        if s["kind"] == "h2d":
            rec = OperatorRecord(FUNC_H2D, (s["addr"], nb), out_buffers=(s["addr"],))
            calls.append(InterceptedCall(
                record=rec, out_addrs=(s["addr"],), out_avals=((shape, tdtype),),
                h2d_value=torch.zeros(shape, dtype=tdtype),
            ))
        elif s["kind"] == "d2h":
            rec = OperatorRecord(FUNC_D2H, (s["addr"], nb), in_buffers=(s["addr"],))
            calls.append(InterceptedCall(
                record=rec, in_operands=(("a", s["addr"]),), out_avals=((shape, tdtype),),
            ))
        elif s["kind"] == "kernel":
            reads, writes = tuple(s["reads"]), tuple(s["writes"])
            rec = OperatorRecord(
                f"kernel:{s['prim']}", (s["prim"], reads, writes),
                in_buffers=reads, out_buffers=writes, flops=1.0, mem_bytes=float(nb),
            )
            calls.append(InterceptedCall(
                record=rec, op=_Op(s["prim"]), in_operands=tuple(("a", a) for a in reads),
                out_addrs=writes, out_avals=tuple((shape, tdtype) for _ in writes),
            ))
        else:  # pragma: no cover - corrupt fixture
            raise ValueError(f"unknown call kind {s['kind']!r}")
    return calls


def load_fixture(name):
    with open(os.path.join(FIXTURE_DIR, f"{name}.json")) as f:
        return json.load(f)


def run_fixture(fx):
    """Run a fixture through the pass its ``check`` field selects."""
    if fx["check"] == "protocol":
        spec = ProtocolSpec(
            steps=fx["protocol"]["steps"],
            seq_of_step=tuple(fx["protocol"]["seq_of_step"]),
        )
        return check_protocol(spec)
    calls = build_calls(fx["calls"])
    pairs = tuple(tuple(p) for p in fx.get("carried_pairs", ()))
    if fx["check"] == "split":
        return verify_split_calls(calls, SplitPlan.parse_signature(fx["plan"]), pairs)
    return verify_calls(calls, pairs)


# ---------------------------------------------------------------------------
# every mutation fixture trips exactly its diagnostic code
# ---------------------------------------------------------------------------

MUTATIONS = [
    ("shuffled_transfer", "RRTO101"),
    ("forged_donation_read", "RRTO201"),
    ("infeasible_cut", "RRTO302"),
    ("dropped_seqno", "RRTO404"),
]


class TestMutationCorpus:
    @pytest.mark.parametrize("name,code", MUTATIONS)
    def test_fixture_trips_exactly_its_code(self, name, code):
        fx = load_fixture(name)
        assert fx["expect"] == code  # fixture self-describes its defect
        errors = {d.code for d in run_fixture(fx) if d.severity == "error"}
        assert errors == {code}, f"{name}: expected exactly {{{code}}}, got {sorted(errors)}"

    @pytest.mark.parametrize("name,code", MUTATIONS)
    def test_fixture_errors_raise(self, name, code):
        with pytest.raises(ReplaySoundnessError) as ei:
            raise_on_errors(run_fixture(load_fixture(name)))
        assert any(d.code == code for d in ei.value.diagnostics)

    def test_corpus_is_complete(self):
        on_disk = {f[:-5] for f in os.listdir(FIXTURE_DIR) if f.endswith(".json")}
        assert on_disk == {name for name, _ in MUTATIONS}


# ---------------------------------------------------------------------------
# diagnostics plumbing
# ---------------------------------------------------------------------------

class TestDiagnostics:
    def test_unknown_code_rejected(self):
        with pytest.raises(ValueError):
            Diagnostic("RRTO999", "error", "nope")

    def test_every_code_documented(self):
        assert all(CODES[c] for c in CODES)
        assert {c[:5] for c in CODES} == {"RRTO1", "RRTO2", "RRTO3", "RRTO4"}

    def test_report_roundtrip(self):
        d = Diagnostic("RRTO101", "error", "m", where={"index": 3})
        r = AnalysisReport("subject", [d])
        assert not r.ok and r.codes() == ["RRTO101"]
        blob = json.loads(r.to_json())
        assert blob["subject"] == "subject"
        assert blob["diagnostics"][0]["code"] == "RRTO101"
        with pytest.raises(ReplaySoundnessError):
            r.raise_if_errors()


# ---------------------------------------------------------------------------
# pass 1: dataflow linter
# ---------------------------------------------------------------------------

CHAIN = [
    {"kind": "h2d", "addr": 1, "shape": [4], "dtype": "float32"},
    {"kind": "kernel", "prim": "add", "reads": [1], "writes": [2],
     "shape": [4], "dtype": "float32"},
    {"kind": "kernel", "prim": "mul", "reads": [2], "writes": [3],
     "shape": [4], "dtype": "float32"},
    {"kind": "d2h", "addr": 3, "shape": [4], "dtype": "float32"},
]
STATEFUL = [
    {"kind": "h2d", "addr": 1, "shape": [4], "dtype": "float32"},
    {"kind": "h2d", "addr": 2, "shape": [4], "dtype": "float32"},
    {"kind": "kernel", "prim": "add", "reads": [1, 2], "writes": [3],
     "shape": [4], "dtype": "float32"},
    {"kind": "d2h", "addr": 3, "shape": [4], "dtype": "float32"},
]
STRAY_D2H = {"kind": "d2h", "addr": 99, "shape": [4], "dtype": "float32"}
RANDOM_PRIM = "aten.rand.default"


def _chain_calls():
    """h2d -> k0 -> k1 -> d2h, dependency-closed."""
    return build_calls(CHAIN)


def _stateful_calls():
    """h2d state, h2d input, kernel advances state, d2h new state."""
    return build_calls(STATEFUL)


def _records(calls):
    return [c.record for c in calls]


class TestDataflowLinter:
    def test_clean_chain(self):
        assert lint_ios(_records(_chain_calls())) == []

    def test_rotated_window_flags_use_before_def(self):
        recs = _records(_chain_calls())
        rotated = recs[1:] + recs[:1]     # h2d now *after* its reader
        assert "RRTO101" in {d.code for d in lint_ios(rotated)}

    def test_premature_download(self):
        recs = _records(_chain_calls())
        recs.insert(1, recs[-1])          # download addr 3 before its writer
        assert "RRTO103" in {d.code for d in lint_ios(recs)}

    def test_dead_upload_is_warning_only(self):
        recs = _records(_chain_calls())
        recs.append(OperatorRecord(FUNC_H2D, (9, 16), out_buffers=(9,)))
        diags = lint_ios(recs)
        assert {d.code for d in diags} == {"RRTO102"}
        assert all(d.severity == "warning" for d in diags)

    def test_nondeterministic_primitive_flagged(self):
        recs = _records(_chain_calls())
        recs.append(OperatorRecord(f"kernel:{RANDOM_PRIM}", (RANDOM_PRIM,),
                                   in_buffers=(2,), out_buffers=(7,)))
        diags = lint_ios(recs)
        assert any(d.code == "RRTO105" and d.severity == "warning" for d in diags)


# ---------------------------------------------------------------------------
# pass 2: donation sanitizer
# ---------------------------------------------------------------------------

class TestDonationSanitizer:
    def test_clean_pair(self):
        assert sanitize_donation(_stateful_calls(), [(0, 0)]) == []

    def test_empty_pairs_trivially_clean(self):
        assert sanitize_donation(_stateful_calls(), []) == []

    def test_out_of_range_ordinal(self):
        diags = sanitize_donation(_stateful_calls(), [(5, 0)])
        assert {d.code for d in diags} == {"RRTO202"}

    def test_duplicate_ordinal(self):
        diags = sanitize_donation(_stateful_calls(), [(0, 0), (0, 0)])
        assert {d.code for d in diags} == {"RRTO202"}

    def test_aval_mismatch(self):
        calls = _stateful_calls()
        calls[0].h2d_value = torch.zeros((8,), dtype=torch.float32)   # wrong shape
        diags = sanitize_donation(calls, [(0, 0)])
        assert {d.code for d in diags} == {"RRTO203"}

    def test_never_produced_state(self):
        # pair the carried input with a download of an address no kernel
        # wrote: the "advanced" state is a resident parameter
        calls = _stateful_calls() + build_calls([STRAY_D2H])
        diags = sanitize_donation(calls, [(0, 1)])
        assert {d.code for d in diags} == {"RRTO204"}


# ---------------------------------------------------------------------------
# pass 3: plan & cache-key verifier
# ---------------------------------------------------------------------------

class TestPlanVerifier:
    def test_full_server_always_sound(self):
        graph = SegmentGraph(_chain_calls())
        assert verify_plan(graph, SplitPlan.full_server(graph.n_ops)) == []

    def test_op_count_mismatch_gates_everything(self):
        graph = SegmentGraph(_chain_calls())
        diags = verify_plan(graph, SplitPlan.full_server(graph.n_ops + 3))
        assert [d.code for d in diags] == ["RRTO301"]

    def test_stateful_trailing_device_infeasible(self):
        graph = SegmentGraph(_stateful_calls(), carried_pairs=((0, 0),))
        diags = verify_plan(graph, SplitPlan.parse_signature("D0:1"))
        assert {d.code for d in diags} == {"RRTO302"}

    def test_cache_key_accepts_engine_derivations(self):
        fp = "a" * 64
        assert verify_cache_key(fp) == []
        assert verify_cache_key(f"{fp}|S0:3", n_ops=3) == []
        assert verify_cache_key(f"{fp}#vmap4") == []

    def test_cache_key_rejections(self):
        fp = "a" * 64
        for key, n_ops in [
            ("not hex!", None),               # malformed base
            (f"{fp}|garbage", None),          # unparseable plan
            (f"{fp}|S0:3", 7),                # plan op-count mismatch
            (f"{fp}#vmap1", None),            # width-1 batch
            (f"{fp}#vmapX", None),            # non-numeric width
        ]:
            diags = verify_cache_key(key, n_ops=n_ops)
            assert {d.code for d in diags} == {"RRTO305"}, key

    def test_split_cache_key(self):
        assert split_cache_key("fp") == ("fp", None, None)
        assert split_cache_key("fp|S0:3") == ("fp", "S0:3", None)
        assert split_cache_key("fp#vmap4") == ("fp", None, "vmap4")

    def test_persisted_entry_relaxed_about_fingerprint_format(self):
        # restart persistence keys by opaque strings in tests and replicas:
        # the loader must not impose the engine's hex-fp derivation rules
        assert verify_persisted_entry("fpA", {"n_kernels": 3}) == []
        assert verify_persisted_entry("fpA|cut=3", {"plan": "cut=3"}) == []

    def test_persisted_entry_rejections(self):
        for key, meta, code in PERSISTED_REJECTIONS:
            diags = verify_persisted_entry(key, meta)
            assert code in {d.code for d in diags}, (key, meta)

    def test_metadata_against_calls(self):
        calls = _stateful_calls()      # 2 uploads, 1 download
        assert verify_metadata_against_calls("fp", {"carried_pairs": [[0, 0]]}, calls) == []
        diags = verify_metadata_against_calls("fp", {"carried_pairs": [[7, 0]]}, calls)
        assert {d.code for d in diags} == {"RRTO306"}


PERSISTED_REJECTIONS = [
    ("fp#vmap4", {}, "RRTO305"),          # derived, never persisted
    ("fp", "not-a-dict", "RRTO306"),
    ("fp|S0:3", {"plan": "S0:9"}, "RRTO306"),   # key/meta conflict
    ("fp", {"carried_pairs": [[0, 0], [0, 1]]}, "RRTO306"),
    ("fp", {"carried_pairs": [[-1, 0]]}, "RRTO306"),
    ("fp", {"carried_pairs": "junk"}, "RRTO306"),
]


# ---------------------------------------------------------------------------
# pass 4: protocol model checker
# ---------------------------------------------------------------------------

PROTOCOL_MUTANTS = {
    "zero_window": dict(steps=2, dedup_window=0),
    "unsequenced": dict(steps=1, seq_of_step=(None,)),
    "preseeded_junk": dict(steps=1, preseed=((0, ("junk", -1)),)),
}
SEQUENCINGS = ([0, 1, 2], [0, 1, 1], [0, None], [1, 0])


class TestProtocolChecker:
    def test_shipped_engine_config_is_sound(self):
        assert check_engine_protocol() == []

    def test_zero_width_window_reexecutes(self):
        diags = check_protocol(ProtocolSpec(**PROTOCOL_MUTANTS["zero_window"]))
        assert "RRTO403" in {d.code for d in diags}

    def test_unsequenced_bypass_reexecutes(self):
        diags = check_protocol(ProtocolSpec(**PROTOCOL_MUTANTS["unsequenced"]))
        assert {d.code for d in diags} == {"RRTO401"}

    def test_preseeded_junk_reply_detected(self):
        diags = check_protocol(ProtocolSpec(**PROTOCOL_MUTANTS["preseeded_junk"]))
        assert "RRTO402" in {d.code for d in diags}

    def test_static_sequencing_screen(self):
        assert check_sequencing([0, 1, 2]) == []
        assert {d.code for d in check_sequencing([0, 1, 1])} == {"RRTO404"}
        assert {d.code for d in check_sequencing([0, None])} == {"RRTO401"}
        assert {d.code for d in check_sequencing([1, 0])} == {"RRTO403"}


# ---------------------------------------------------------------------------
# property: every real locked IOS + every planner output verifies clean
# ---------------------------------------------------------------------------

def _lock(model, min_repeats=2, steps=6, thread_state=None, **kw):
    sess = OffloadSession(model, "rrto", min_repeats=min_repeats, device="cpu", **kw)
    sess.load()
    args = list(model.example_inputs)
    res = None
    for _ in range(steps):
        res = sess.infer(*args)
        if thread_state is not None:
            out_i, in_i = thread_state
            args[in_i] = res.outputs[out_i]
    assert res is not None and res.mode == "replaying"
    return sess


def _registry_plans(graph):
    plans = [SplitPlan.full_server(graph.n_ops)]
    if not graph.is_stateful:
        plans.append(SplitPlan.full_device(graph.n_ops))
    return plans


class TestRealModelsVerifyClean:
    @pytest.mark.parametrize("name", sorted(REGISTRY_CASES))
    def test_registry_ios_and_plans_clean(self, name):
        model = ZOO[name](**REGISTRY_CASES[name], device="cpu")
        sess = _lock(model, thread_state=THREAD.get(name))
        calls = sess.client._ios_calls
        pairs = sess.server.context(sess.client_id).replay.program.carried_pairs
        graph = SegmentGraph(calls, carried_pairs=pairs)
        plans = _registry_plans(graph)
        for bw in (1 * MBPS, 128 * MBPS):
            best = plan_partition(
                graph, JETSON_XAVIER_NX, GTX_2080TI, bw,
                config=PartitionConfig(objective="latency"),
                verify=True,          # the planner's own fail-fast hook
            )
            plans.append(best.plan)
        report = verify_ios(name, calls, pairs, plans=plans, min_repeats=2)
        assert report.errors == [], report.codes()
        # the graph counts a DtoD record (a contiguous clone) as an op, the
        # census counts kernels only
        n_d2d = sum(1 for c in calls if c.record.category == CAT_D2D)
        assert report.census["n_kernels"] + n_d2d == graph.n_ops

    def test_census_totals(self):
        census = op_census(_records(_chain_calls()))
        assert census["n_kernels"] == 2
        assert census["n_h2d"] == 1 and census["n_d2h"] == 1
        assert census["h2d_bytes"] == 16 and census["d2h_bytes"] == 16
        assert dict(census["op_histogram"])["add"] == 1


# ---------------------------------------------------------------------------
# engine hooks: fail-fast when enabled, bitwise when off (the default)
# ---------------------------------------------------------------------------

def make_mlp(seed=0, d=8):
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(rng.normal(0, 0.1, (d, d)).astype(np.float32))}

    def apply(p, x):
        return [torch.tanh(x @ p["w"]).sum(dim=1)]

    x = torch.from_numpy(rng.normal(0, 1, (2, d)).astype(np.float32))
    return OffloadableModel(f"mlp{seed}", apply, params, (x,)), x


def make_rnn(seed=0, d=8):
    """A stateful app: the hidden state comes back as output 1."""
    rng = np.random.default_rng(seed)
    params = {
        "wx": torch.from_numpy(rng.normal(0, 0.3, (d, d)).astype(np.float32)),
        "wh": torch.from_numpy(rng.normal(0, 0.3, (d, d)).astype(np.float32)),
    }

    def apply(p, x, h):
        h2 = torch.tanh(x @ p["wx"] + h @ p["wh"])
        return [h2.sum(dim=1), h2]

    x = torch.from_numpy(rng.normal(0, 1, (2, d)).astype(np.float32))
    return OffloadableModel(f"rnn{seed}", apply, params, (x, torch.zeros(2, d)))


class TestEngineHooks:
    def test_verified_session_locks_and_replays(self):
        model, _ = make_mlp()
        sess = _lock(model, verify=True)
        assert sess.client.ios is not None

    def test_default_is_unverified_and_byte_identical(self):
        model, _ = make_mlp(1)
        plain = _lock(model)
        assert plain.client.verify is False
        assert plain.server.verify is False
        model2, _ = make_mlp(1)
        checked = _lock(model2, verify=True)
        a = plain.infer(*model.example_inputs)
        b = checked.infer(*model2.example_inputs)
        assert a.outputs[0].numpy().tobytes() == b.outputs[0].numpy().tobytes()

    def test_install_plan_verifies_against_ios(self):
        model, _ = make_mlp(2)
        sess = _lock(model, verify=True)
        n = SegmentGraph(sess.client._ios_calls).n_ops
        # a sound segmented plan passes the hook and builds
        sess.client._install_plan(SplitPlan.parse_signature(f"D0:1|S1:{n}"))
        # a plan for a different op stream is rejected before it is built
        # (full-server plans bypass the hook: they revert to classic replay)
        built = sess.server.compile_count
        with pytest.raises(ReplaySoundnessError) as ei:
            sess.client._install_plan(SplitPlan.parse_signature(f"D0:1|S1:{n + 5}"))
        assert any(d.code == "RRTO301" for d in ei.value.diagnostics)
        assert sess.server.compile_count == built


# ---------------------------------------------------------------------------
# ReplayCache.load validates persisted entries
# ---------------------------------------------------------------------------

class TestCacheLoadValidation:
    def test_load_evicts_unsound_entries(self, tmp_path):
        from repro_torch.serving.replay_cache import PERSIST_VERSION, ReplayCache

        path = tmp_path / "cache.json"
        payload = {
            "version": PERSIST_VERSION,
            "fingerprints": {
                "fpA": {"n_kernels": 3},
                "fpA|S0:3": {"plan": "S0:3"},
                "fpB#vmap4": {},                       # RRTO305
                "fpC": "not-a-dict",                   # RRTO306
                "fpD": {"carried_pairs": [[0, 0], [0, 1]]},  # RRTO306
            },
        }
        path.write_text(json.dumps(payload))
        cache = ReplayCache()
        with pytest.warns(UserWarning) as rec:
            assert cache.load(str(path)) == 2
        assert len(rec) == 3
        assert set(cache.persisted_fingerprints) == {"fpA", "fpA|S0:3"}

    def test_clean_roundtrip_warns_nothing(self, tmp_path):
        from repro_torch.serving.replay_cache import ReplayCache

        src, dst = ReplayCache(), ReplayCache()
        src._known["fpA"] = {"n_kernels": 3, "carried_pairs": [[0, 0]]}
        path = tmp_path / "cache.json"
        src.save(str(path))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert dst.load(str(path)) == 1
        assert dst.known_metadata("fpA")["carried_pairs"] == [[0, 0]]

    def test_forget_known(self):
        from repro_torch.serving.replay_cache import ReplayCache

        cache = ReplayCache()
        cache._known["fp"] = {}
        cache.forget_known("fp")
        assert cache.persisted_fingerprints == []
        cache.forget_known("absent")    # idempotent


class TestStaleMetadataGuard:
    def test_server_evicts_contradictory_metadata(self):
        from repro_torch.core.engine import OffloadServer
        from repro_torch.serving.replay_cache import ReplayCache

        cache = ReplayCache()
        cache._known["fp"] = {"carried_pairs": [[7, 0]]}
        server = OffloadServer(GTX_2080TI, device=torch.device("cpu"), replay_cache=cache)
        calls = _stateful_calls()      # only 2 uploads: pair (7, 0) is stale
        with pytest.warns(UserWarning, match="stale replay-cache metadata"):
            assert server._stale_metadata("fp", {"carried_pairs": [[7, 0]]}, calls)
        assert cache.persisted_fingerprints == []

    def test_sound_metadata_kept(self):
        from repro_torch.core.engine import OffloadServer
        from repro_torch.serving.replay_cache import ReplayCache

        cache = ReplayCache()
        cache._known["fp"] = {"carried_pairs": [[0, 0]]}
        server = OffloadServer(GTX_2080TI, device=torch.device("cpu"), replay_cache=cache)
        assert not server._stale_metadata("fp", {"carried_pairs": [[0, 0]]}, _stateful_calls())
        assert cache.persisted_fingerprints == ["fp"]


# ---------------------------------------------------------------------------
# CLI sweep (in-process)
# ---------------------------------------------------------------------------

class TestCli:
    def test_single_model_sweep(self, tmp_path, capsys):
        from repro_torch.analysis.__main__ import main

        out = tmp_path / "report.json"
        rc = main(["--models", "sensor_encoder", "--json", str(out),
                   "--min-repeats", "2", "--device", "cpu"])
        assert rc == 0
        blob = json.loads(out.read_text())
        assert blob["ok"] and blob["n_errors"] == 0
        subjects = {r["subject"] for r in blob["reports"]}
        assert subjects == {"sensor_encoder", "at-most-once protocol"}
        sweep = next(r for r in blob["reports"] if r["subject"] == "sensor_encoder")
        assert sweep["census"]["n_plans_verified"] >= 2
        assert sweep["census"]["n_kernels"] > 0
        assert "hlo" not in sweep["census"]
        capsys.readouterr()     # swallow the human-readable summary

    def test_unknown_model_rejected(self):
        from repro_torch.analysis.__main__ import main

        with pytest.raises(SystemExit):
            main(["--models", "no_such_model", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the port's own additions: the fail-fast programs, verify off is bitwise,
# the aten random ops
# ---------------------------------------------------------------------------

def test_programs_refuse_unsound_calls_before_building():
    fx = load_fixture("shuffled_transfer")
    with pytest.raises(ReplaySoundnessError) as ei:
        ReplayProgram(build_calls(fx["calls"]), verify=True)
    assert {d.code for d in ei.value.diagnostics} == {"RRTO101"}
    fx = load_fixture("infeasible_cut")
    with pytest.raises(ReplaySoundnessError) as ei:
        SegmentedReplayProgram(build_calls(fx["calls"]), SplitPlan.parse_signature(fx["plan"]),
                               carried_pairs=((0, 0),), verify=True)
    assert {d.code for d in ei.value.diagnostics} == {"RRTO302"}


def _stream(sess, model, steps):
    args = list(model.example_inputs)
    out = []
    for _ in range(steps):
        res = sess.infer(*args)
        args[1] = res.outputs[1]
        out.append(res)
    return out


def test_verify_on_is_bitwise_verify_off():
    """A verified stateful session and an unverified one: every output,
    mode, RPC count and clock tick equal, the server's counters too."""
    runs = []
    for verify in (False, True):
        model = make_rnn(3)
        sess = OffloadSession(model, "rrto", min_repeats=2, device="cpu", verify=verify)
        sess.load()
        runs.append((sess, _stream(sess, model, 7)))
    (plain, a), (checked, b) = runs
    assert checked.client.verify and checked.server.verify
    assert checked.client.stateful_replay and a[-1].mode == "replaying"
    for x, y in zip(a, b):
        assert (x.mode, x.rpcs, x.wall_seconds, x.joules, x.network_bytes,
                x.server_busy_seconds) == (y.mode, y.rpcs, y.wall_seconds, y.joules,
                                           y.network_bytes, y.server_busy_seconds)
        for u, v in zip(x.outputs, y.outputs):
            assert u.numpy().tobytes() == v.numpy().tobytes()
    assert plain.clock.t == checked.clock.t
    assert plain.server.compile_count == checked.server.compile_count
    assert plain.client.stats.as_dict() == checked.client.stats.as_dict()


def test_nondeterministic_prims_carry_the_tag():
    assert {"aten.rand.default", "aten.randn.default", "aten.randint.low",
            "aten.bernoulli.p", "aten.native_dropout.default",
            "aten.randperm.default"} <= NONDETERMINISTIC_PRIMS
    for name in NONDETERMINISTIC_PRIMS:
        _, packet, overload = name.split(".")
        op = getattr(getattr(torch.ops.aten, packet), overload)
        assert torch.Tag.nondeterministic_seeded in op.tags, name


def test_random_draw_in_the_app_warns_rrto105():
    """An app that draws ``torch.rand`` inside its apply: the trace keeps
    the draw as an ``aten.rand`` node, and the locked IOS lints with an
    RRTO105 warning at that record (and no error)."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(0, 0.1, (8, 8)).astype(np.float32))}

    def apply(p, x):
        return [(x @ p["w"]) * torch.rand(2, 8)]

    x = torch.from_numpy(rng.normal(0, 1, (2, 8)).astype(np.float32))
    sess = _lock(OffloadableModel("noisy", apply, params, (x,)), verify=True)
    diags = verify_calls(sess.client._ios_calls)
    hits = [d for d in diags if d.code == "RRTO105"]
    assert hits and all(d.severity == "warning" for d in diags)
    assert {d.where["primitive"] for d in hits} == {"aten.rand.default"}
    assert kernel_primitive(sess.client._ios_calls[hits[0].where["index"]].record.func) == \
        "aten.rand.default"


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _triples(diags):
    return [(d.code, d.severity, json.loads(json.dumps(d.where))) for d in diags]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's verifier and its IR builders."""
    pytest.importorskip("jax")
    from repro import analysis as jan
    from repro.core.intercept import InterceptedCall as JCall
    from repro.core.records import OperatorRecord as JRecord
    from repro.partition.segments import SegmentGraph as JGraph
    from repro.partition.segments import SplitPlan as JPlan

    class Prim:
        def __init__(self, name):
            self.name = name

    def build(specs):
        calls = []
        for s in specs:
            shape, dtype = tuple(s.get("shape", ())), s.get("dtype", "float32")
            nb = _nbytes(shape, dtype)
            if s["kind"] == "h2d":
                calls.append(JCall(
                    record=JRecord(FUNC_H2D, (s["addr"], nb), out_buffers=(s["addr"],)),
                    out_addrs=(s["addr"],), out_avals=((shape, dtype),),
                    h2d_value=np.zeros(shape, dtype)))
            elif s["kind"] == "d2h":
                calls.append(JCall(
                    record=JRecord(FUNC_D2H, (s["addr"], nb), in_buffers=(s["addr"],)),
                    in_operands=(("a", s["addr"]),), out_avals=((shape, dtype),)))
            else:
                reads, writes = tuple(s["reads"]), tuple(s["writes"])
                calls.append(JCall(
                    record=JRecord(f"kernel:{s['prim']}", (s["prim"], reads, writes),
                                   in_buffers=reads, out_buffers=writes, flops=1.0,
                                   mem_bytes=float(nb)),
                    prim=Prim(s["prim"]), in_operands=tuple(("a", a) for a in reads),
                    out_addrs=writes, out_avals=tuple((shape, dtype) for _ in writes)))
        return calls

    return dict(an=jan, build=build, Graph=JGraph, Plan=JPlan)


def test_codes_equal_the_reference(ref):
    assert CODES == ref["an"].CODES
    assert list(CODES) == list(ref["an"].CODES)


@pytest.mark.parametrize("name,code", MUTATIONS)
def test_fixture_diagnostics_equal_the_reference(ref, name, code):
    fx = load_fixture(name)
    an = ref["an"]
    if fx["check"] == "protocol":
        want = an.check_protocol(an.ProtocolSpec(
            steps=fx["protocol"]["steps"], seq_of_step=tuple(fx["protocol"]["seq_of_step"])))
    else:
        calls = ref["build"](fx["calls"])
        pairs = tuple(tuple(p) for p in fx.get("carried_pairs", ()))
        if fx["check"] == "split":
            want = an.verify_split_calls(calls, ref["Plan"].parse_signature(fx["plan"]), pairs)
        else:
            want = an.verify_calls(calls, pairs)
    got = run_fixture(fx)
    assert _triples(got) == _triples(want)
    assert {d.code for d in got if d.severity == "error"} == {code}


def _rotated(specs):
    return specs[1:] + specs[:1]


def _premature(specs):
    return specs[:1] + [specs[-1]] + specs[1:]


HAND_CASES = {
    # name: (specs, pass, argument)
    "chain": (CHAIN, "lint", None),
    "chain_rotated": (_rotated(CHAIN), "lint", None),
    "chain_premature_d2h": (_premature(CHAIN), "lint", None),
    "chain_dead_upload": (CHAIN + [{"kind": "h2d", "addr": 9, "shape": [4]}], "lint", None),
    "chain_random_draw": (CHAIN[:3] + [{"kind": "kernel", "prim": "rand", "reads": [2],
                                        "writes": [7], "shape": [4]}] + CHAIN[3:],
                          "lint", None),
    "stateful_pair": (STATEFUL, "donation", [(0, 0)]),
    "stateful_no_pairs": (STATEFUL, "donation", []),
    "stateful_out_of_range": (STATEFUL, "donation", [(5, 0)]),
    "stateful_duplicate": (STATEFUL, "donation", [(0, 0), (0, 0)]),
    "stateful_aval_mismatch": ([dict(STATEFUL[0], shape=[8])] + STATEFUL[1:], "donation",
                               [(0, 0)]),
    "stateful_never_produced": (STATEFUL + [STRAY_D2H], "donation", [(0, 1)]),
    "chain_full_server": (CHAIN, "plan", ("S0:2", ())),
    "chain_mismatched_plan": (CHAIN, "plan", ("S0:5", ())),
    "chain_device_server": (CHAIN, "plan", ("D0:1|S1:2", ())),
    "stateful_trailing_device": (STATEFUL, "plan", ("D0:1", ((0, 0),))),
    "stateful_full_server": (STATEFUL, "plan", ("S0:1", ((0, 0),))),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_hand_built_calls_equal_the_reference(ref, case):
    """The hand-built chain and stateful calls, clean and mutated, give equal
    ``(code, severity, where)`` through each pass in both packages."""
    specs, kind, arg = HAND_CASES[case]
    an = ref["an"]
    mine, theirs = build_calls(specs), ref["build"](specs)
    if kind == "lint":
        got, want = lint_ios(_records(mine)), an.lint_ios(_records(theirs))
        if case == "chain_random_draw":
            # the reference screens JAX's PRNG primitives, the port aten's
            # random ops: the same draw, each package's name for it
            mine[3].record = OperatorRecord(f"kernel:{RANDOM_PRIM}", (RANDOM_PRIM,),
                                            in_buffers=(2,), out_buffers=(7,))
            theirs[3].record = type(theirs[3].record)(
                "kernel:threefry2x32", ("threefry2x32",), in_buffers=(2,), out_buffers=(7,))
            got, want = lint_ios(_records(mine)), an.lint_ios(_records(theirs))
            assert [d.where["primitive"] for d in got if d.code == "RRTO105"] == [RANDOM_PRIM]
            for d in (*got, *want):
                d.where.pop("primitive", None)
    elif kind == "donation":
        got, want = sanitize_donation(mine, arg), an.sanitize_donation(theirs, arg)
    else:
        sig, pairs = arg
        got = verify_plan(SegmentGraph(mine, carried_pairs=pairs),
                          SplitPlan.parse_signature(sig))
        want = an.verify_plan(ref["Graph"](theirs, carried_pairs=pairs),
                              ref["Plan"].parse_signature(sig))
    assert _triples(got) == _triples(want)
    assert [d.code for d in got] or case in ("chain", "stateful_pair", "stateful_no_pairs",
                                             "chain_full_server", "chain_device_server",
                                             "stateful_full_server")


def test_keys_and_metadata_equal_the_reference(ref):
    an = ref["an"]
    fp = "a" * 64
    for key, n_ops in [(fp, None), (f"{fp}|S0:3", 3), (f"{fp}#vmap4", None),
                       ("not hex!", None), (f"{fp}|garbage", None), (f"{fp}|S0:3", 7),
                       (f"{fp}#vmap1", None), (f"{fp}#vmapX", None)]:
        assert _triples(verify_cache_key(key, n_ops=n_ops)) == \
            _triples(an.verify_cache_key(key, n_ops=n_ops)), key
        assert split_cache_key(key) == an.split_cache_key(key)
    for key, meta, _ in PERSISTED_REJECTIONS + [("fpA", {"n_kernels": 3}, None)]:
        assert _triples(verify_persisted_entry(key, meta)) == \
            _triples(an.verify_persisted_entry(key, meta)), (key, meta)
    for meta in ({"carried_pairs": [[0, 0]]}, {"carried_pairs": [[7, 0]]}):
        assert _triples(verify_metadata_against_calls("fp", meta, _stateful_calls())) == \
            _triples(an.verify_metadata_against_calls("fp", meta, ref["build"](STATEFUL)))


def test_protocol_equal_the_reference(ref):
    an = ref["an"]
    assert check_engine_protocol() == an.check_engine_protocol() == []
    for name, kw in PROTOCOL_MUTANTS.items():
        got, want = check_protocol(ProtocolSpec(**kw)), an.check_protocol(an.ProtocolSpec(**kw))
        assert got and _triples(got) == _triples(want), name
        assert [d.message for d in got] == [d.message for d in want], name
    for seqs in SEQUENCINGS:
        assert _triples(check_sequencing(seqs)) == _triples(an.check_sequencing(seqs)), seqs


CENSUS_KEYS = ("n_h2d", "n_d2h", "h2d_bytes", "d2h_bytes")


@pytest.mark.parametrize("name", sorted(REGISTRY_CASES))
def test_registry_models_equal_the_reference(ref, name):
    """The registry cases at the reference's sizes and seed verify clean in
    both packages, with the same carried pairs and wire transfers."""
    from repro.core.offload import OffloadSession as JSession
    from repro.models.cnn_zoo import ZOO as JZOO

    an = ref["an"]
    thread = THREAD.get(name)
    reports = []
    for zoo, make_session, verifier, graph_cls, plan_cls in (
        (ZOO, lambda m: OffloadSession(m, "rrto", min_repeats=2, device="cpu"),
         verify_ios, SegmentGraph, SplitPlan),
        (JZOO, lambda m: JSession(m, "rrto", min_repeats=2), an.verify_ios, ref["Graph"],
         ref["Plan"]),
    ):
        kw = dict(REGISTRY_CASES[name], **({"device": "cpu"} if zoo is ZOO else {}))
        model = zoo[name](**kw)
        sess = make_session(model)
        sess.load()
        args = list(model.example_inputs)
        for _ in range(6):
            res = sess.infer(*args)
            if thread is not None:
                args[thread[1]] = res.outputs[thread[0]]
        assert res.mode == "replaying"
        calls = sess.client._ios_calls
        pairs = sess.server.context(sess.client_id).replay.program.carried_pairs
        graph = graph_cls(calls, carried_pairs=pairs)
        plans = [plan_cls.parse_signature(p.signature()) for p in _registry_plans(graph)]
        report = verifier(name, calls, pairs, plans=plans, min_repeats=2)
        reports.append((report, tuple(tuple(int(v) for v in p) for p in pairs)))
    (mine, my_pairs), (theirs, their_pairs) = reports
    assert mine.errors == [] and theirs.errors == []
    assert mine.codes() == theirs.codes()
    assert my_pairs == their_pairs == (((1, 1),) if thread else ())
    assert {k: mine.census[k] for k in CENSUS_KEYS} == {k: theirs.census[k] for k in CENSUS_KEYS}


def test_reduced_qwen3_verified_edge_equals_the_reference():
    """A reduced qwen3 decoded stateful on a verified edge in both packages
    (the same numpy parameters): the same tokens, carried pairs and wire
    transfers.  The port's IOS unrolls the layers (~11x the reference's
    records), so it alone warns RRTO104, the payload horizon; its
    loop-carried detection still found the pairs."""
    jax = pytest.importorskip("jax")
    from repro.configs.registry import get_reduced_config as j_reduced
    from repro.models.registry import get_model as j_get_model
    from repro.serving import RRTOEdgeServer as JEdge
    from repro.serving.engine import RRTOServedLM as JServedLM
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving import RRTOEdgeServer, RRTOServedLM

    cfg_j, cfg = j_reduced("qwen3-0.6b"), get_reduced_config("qwen3-0.6b")
    params_j = j_get_model(cfg_j).init_params(jax.random.PRNGKey(1), cfg_j)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), cfg, "cpu")
    prompt = np.arange(4, dtype=np.int32)[None]
    j_edge = JEdge(verify=True)
    j_tokens = JServedLM(cfg_j, bucket_len=12, params=params_j, edge=j_edge,
                         min_repeats=2).generate(prompt, 6).tokens
    edge = RRTOEdgeServer(verify=True, device="cpu")
    lm = RRTOServedLM(cfg, bucket_len=12, params=params, edge=edge, min_repeats=2)
    tokens = lm.generate(prompt, 6).tokens
    assert edge.server.verify and lm.session.client.verify
    assert lm.session.client.stateful_replay
    assert np.array_equal(np.asarray(tokens), np.asarray(j_tokens)), (tokens, j_tokens)
    from repro import analysis as jan

    mine, theirs = lm.session.client, next(iter(j_edge.sessions.values())).client
    assert mine.ios.carried_pairs == theirs.ios.carried_pairs != ()
    got = verify_ios("qwen3", mine._ios_calls, mine.ios.carried_pairs, min_repeats=2)
    want = jan.verify_ios("qwen3", theirs._ios_calls, theirs.ios.carried_pairs, min_repeats=2,
                          census=True)
    assert got.codes() == ["RRTO104"] and want.codes() == []
    assert got.diagnostics[0].where == {"ios_len": len(mine._ios_calls), "rounds": 3}
    assert len(mine._ios_calls) > 4096 // 3 > len(theirs._ios_calls)
    assert {k: got.census[k] for k in CENSUS_KEYS} == {k: want.census[k] for k in CENSUS_KEYS}
