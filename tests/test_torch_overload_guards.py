"""The guards of ``benchmarks/load_knee.py``, pinned on the port at the
benchmark's ``--smoke`` sizes, with the same constants, tenants, seeds and
account-only sessions: 48 Poisson clients in three SLO classes (gold /
silver / bronze, weights 4 / 2 / 1) offer 0.25x, 1x and 4x the measured
capacity, 420 requests a phase, to two edge boxes fed the same arrival
schedule, one with queue-limit and token-bucket admission and the ladder,
one without (``admission=None``).  Each guard is one test case, named as the
benchmark names it.  Also the open-loop ``infer_stream`` with a bare
iterator of arrivals and a generator of deadlines (tests/test_pipeline.py),
and the deadlines scored after the fact on the pipelined path."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import MODE_REPLAYING  # noqa: E402
from repro_torch.core.netsim import client_stream_seed, poisson_arrivals  # noqa: E402
from repro_torch.core.offload import OffloadableModel, OffloadSession  # noqa: E402
from repro_torch.models.cnn_zoo import ZOO  # noqa: E402
from repro_torch.partition import PartitionConfig  # noqa: E402
from repro_torch.serving import RRTOEdgeServer  # noqa: E402
from repro_torch.serving.admission import (  # noqa: E402
    AdmissionController,
    AdmissionRejectedError,
    SLOClass,
)

# benchmarks/load_knee.py
TENANTS: Tuple[Tuple[str, float, float], ...] = (
    ("gold", 4.0, 0.15),
    ("silver", 2.0, 0.30),
    ("bronze", 1.0, 0.55),
)
KNEE_MULTIPLIER = 2.0
P99_RATIO_BOUND = 0.5
SHARE_SLACK = 0.10
ADMIT_FRACTION = 0.8
DRAIN_GAP_S = 0.05
ACTIVE_ON_AIR = 8
# its --smoke sizes
N_CLIENTS, N_REQUESTS, MULTIPLIERS, SEED = 48, 420, (0.25, 1.0, 4.0), 0


def make_app(seed: int = 0, d_in: int = 16, d_hidden: int = 32, n_layers: int = 8):
    """The benchmark's deep narrow MLP: enough kernels that per-request
    compute (not the wire) sets the capacity knee."""
    rng = np.random.default_rng(seed)
    params = {
        "w_in": torch.from_numpy(rng.normal(0, 0.1, (d_in, d_hidden)).astype(np.float32)),
        "w_out": torch.from_numpy(rng.normal(0, 0.1, (d_hidden, 4)).astype(np.float32)),
    }
    for k in range(n_layers):
        params[f"w{k}"] = torch.from_numpy(
            rng.normal(0, 0.1, (d_hidden, d_hidden)).astype(np.float32))

    def apply(p, x):
        h = torch.tanh(x @ p["w_in"])
        for k in range(n_layers):
            h = torch.tanh(h @ p[f"w{k}"])
        return [h @ p["w_out"]]

    x = torch.from_numpy(rng.normal(0, 1, (1, d_in)).astype(np.float32))
    return OffloadableModel(f"knee-app{seed}", apply, params, (x,)), x


@dataclasses.dataclass
class KneePoint:
    multiplier: float
    offered: int
    admitted: int
    degraded: int
    shed: int
    admitted_p99_ms: float
    twin_p99_ms: float
    admitted_share: Dict[str, float]
    offered_share: Dict[str, float]


def _tenant_of(i: int, n: int) -> str:
    u = (i + 0.5) / n
    acc = 0.0
    for name, _, frac in TENANTS:
        acc += frac
        if u < acc:
            return name
    return TENANTS[-1][0]


def _client_rates(clients, offered_hz: float) -> Dict[str, float]:
    """Zipf-skewed per-client rates inside each tenant's population share."""
    by_tenant: Dict[str, List[str]] = {}
    for cid, tenant in clients:
        by_tenant.setdefault(tenant, []).append(cid)
    pop = {name: frac for name, _, frac in TENANTS}
    rates: Dict[str, float] = {}
    for tenant, cids in by_tenant.items():
        zipf = [1.0 / (1 + rank) for rank in range(len(cids))]
        total = sum(zipf)
        for cid, z in zip(cids, zipf):
            rates[cid] = offered_hz * pop[tenant] * z / total
    return rates


def _phase_schedule(clients, offered_hz: float, n_requests: int, seed: int):
    rates = _client_rates(clients, offered_hz)
    duration = n_requests / offered_hz
    events = []
    for cid, tenant in clients:
        n = max(1, round(rates[cid] * duration))
        offs = poisson_arrivals(rates[cid], n, seed=client_stream_seed(seed, cid))
        events.extend((off, cid, tenant) for off in offs)
    events.sort()
    return events


def _build_edge(model, x, clients, *, name: str) -> RRTOEdgeServer:
    """Every client connected and warmed into replay (admission attaches
    after, so recording never competes with the load for tokens)."""
    edge = RRTOEdgeServer(execute=False, name=name, device="cpu")
    for cid, tenant in clients:
        edge.connect(model, client_id=cid, tenant=tenant, min_repeats=2)
    for cid, _ in clients:
        sess = edge.sessions[cid]
        spins = 0
        while sess.client.mode != MODE_REPLAYING and spins < 4:
            sess.infer(x)
            spins += 1
        assert sess.client.mode == MODE_REPLAYING, cid
    edge.ingress.active_clients = ACTIVE_ON_AIR
    return edge


def _attach_admission(edge, clients, **kw) -> AdmissionController:
    adm = AdmissionController(**kw)
    adm.bind(server=edge.server, ingress=edge.ingress)
    edge.admission = adm
    edge.batcher.admission = adm
    for cid, tenant in clients:
        adm.register(cid, tenant)
        edge.sessions[cid].admission = adm
    return adm


def _calibrate(model, x):
    edge = RRTOEdgeServer(execute=False, name="calib", device="cpu")
    sess = edge.connect(model, client_id="calib", min_repeats=2)
    for _ in range(3):
        sess.infer(x)
    assert sess.client.mode == MODE_REPLAYING
    edge.ingress.active_clients = ACTIVE_ON_AIR
    r = sess.infer(x)
    return r.server_busy_seconds, r.wall_seconds, sess.device_fallback_seconds()


def _drive_phase(edge, x, events):
    """Open-loop: the clock is set to each arrival instant."""
    t0 = max(edge.clock.t, edge.server.busy_until) + DRAIN_GAP_S
    counts: Dict[str, Dict[str, int]] = {}
    lat_admitted: List[float] = []
    sheds: List[AdmissionRejectedError] = []
    for off, cid, tenant in events:
        c = counts.setdefault(tenant, {"offered": 0, "admitted": 0, "degraded": 0, "shed": 0})
        c["offered"] += 1
        edge.clock.t = t0 + off
        try:
            r = edge.sessions[cid].infer(x)
        except AdmissionRejectedError as e:
            c["shed"] += 1
            sheds.append(e)
            continue
        if r.mode in ("degraded_device", "degraded_split"):
            c["degraded"] += 1
        else:
            c["admitted"] += 1
            lat_admitted.append(r.wall_seconds)
    return counts, lat_admitted, sheds


def _p99_ms(lats) -> float:
    return float(np.percentile(np.asarray(lats), 99) * 1e3) if lats else 0.0


def run():
    model, x = make_app(SEED)
    compute_s, wall_s, device_s = _calibrate(model, x)
    capacity_hz = 1.0 / compute_s
    in_flight = int(np.ceil(wall_s / compute_s))
    classes = {
        "gold": SLOClass("gold", deadline_s=0.5 * device_s, priority=2, weight=4.0),
        "silver": SLOClass("silver", deadline_s=max(10 * device_s, 0.05), priority=1, weight=2.0),
        "bronze": SLOClass("bronze", deadline_s=max(20 * device_s, 0.2), priority=0, weight=1.0),
    }
    clients = [(f"c{i:04d}", _tenant_of(i, N_CLIENTS)) for i in range(N_CLIENTS)]
    schedules = [(m, _phase_schedule(clients, m * capacity_hz, N_REQUESTS, seed=1000 + k))
                 for k, m in enumerate(MULTIPLIERS)]
    guarded = _build_edge(model, x, clients, name="edge")
    adm = _attach_admission(guarded, clients, queue_limit=in_flight + 16,
                            rate_hz=ADMIT_FRACTION * capacity_hz,
                            borrow_depth=in_flight + 8, classes=classes)
    twin = _build_edge(model, x, clients, name="twin")
    points, all_sheds, twin_shed = [], [], 0
    for m, events in schedules:
        counts, lat_admitted, sheds = _drive_phase(guarded, x, events)
        _, twin_lats, twin_sheds = _drive_phase(twin, x, events)
        twin_shed += len(twin_sheds)
        all_sheds.extend(sheds)
        offered = sum(c["offered"] for c in counts.values())
        admitted = sum(c["admitted"] for c in counts.values())
        points.append(KneePoint(
            multiplier=m, offered=offered, admitted=admitted,
            degraded=sum(c["degraded"] for c in counts.values()),
            shed=sum(c["shed"] for c in counts.values()),
            admitted_p99_ms=_p99_ms(lat_admitted), twin_p99_ms=_p99_ms(twin_lats),
            admitted_share={t: c["admitted"] / max(admitted, 1) for t, c in counts.items()},
            offered_share={t: c["offered"] / max(offered, 1) for t, c in counts.items()},
        ))
    beyond = [p for p in points if p.multiplier >= KNEE_MULTIPLIER]
    light = [p for p in points if p.multiplier <= 0.25]
    weight_share = {name: w / sum(w for _, w, _ in TENANTS) for name, w, _ in TENANTS}
    checks = {
        "knee_p99_bounded": bool(beyond) and all(
            p.admitted > 0 and p.admitted_p99_ms <= P99_RATIO_BOUND * p.twin_p99_ms
            for p in beyond
        ),
        "sheds_typed_with_retry": len(all_sheds) >= 1 and all(
            isinstance(e, AdmissionRejectedError) and e.retry_after_s > 0 for e in all_sheds
        ),
        "tenant_share_fair": all(
            p.admitted_share.get(t, 0.0)
            >= min(weight_share[t], p.offered_share.get(t, 0.0)) - SHARE_SLACK
            for p in beyond for t in weight_share
        ),
        "below_knee_admits_all": bool(light) and all(
            p.shed == 0 and p.degraded == 0 and p.admitted == p.offered for p in light
        ),
    }
    return points, checks, twin_shed, adm


GUARDS = ["knee_p99_bounded", "sheds_typed_with_retry", "tenant_share_fair",
          "below_knee_admits_all"]


@pytest.fixture(scope="module")
def knee():
    return run()


@pytest.mark.parametrize("guard", GUARDS)
def test_load_knee_guard(knee, guard):
    points, checks, _, _ = knee
    assert sorted(checks) == sorted(GUARDS)
    assert checks[guard], f"{guard} tripped: {points}"


def test_twin_never_sheds_and_the_sweep_crosses_the_knee(knee):
    """The benchmark's own assertion (the admission-off twin never sheds),
    and that the overload phase really walked the ladder: degraded silver
    and bronze requests, shed gold ones."""
    points, _, twin_shed, adm = knee
    assert twin_shed == 0
    over = points[-1]
    assert over.degraded > 0 and over.shed > 0 and over.admitted < over.offered
    assert adm.stats.degraded_device == sum(p.degraded for p in points)
    assert adm.stats.shed == sum(p.shed for p in points)


def _sensor(**kw):
    return ZOO["sensor_encoder"](scale=0.25, input_size=32, n_blocks=2, device="cpu", **kw)


def test_stream_accepts_generator_arrivals():
    """Open-loop load generators hand ``poisson_arrivals`` output straight to
    ``infer_stream``: a bare iterator of arrivals and a generator of
    deadline budgets are both materialized."""
    model = _sensor()
    sess = OffloadSession(model, "rrto", min_repeats=2, seed=0, device="cpu")
    sess.load()
    offsets = poisson_arrivals(100.0, 4, seed=client_stream_seed(3, "c0"))
    results = sess.infer_stream(
        [tuple(model.example_inputs)] * 4,
        arrivals=iter(offsets),                 # a bare iterator
        deadlines=(0.5 for _ in range(4)),      # a generator
    )
    assert len(results) == 4
    assert sess.client.mode == "replaying"
    with pytest.raises(ValueError, match="deadline budgets"):
        sess.infer_stream([tuple(model.example_inputs)] * 2, deadlines=[0.5])


def test_pipelined_stream_scores_deadlines_after_the_fact():
    """On a pipelined split session the stream bypasses ``infer()``: each
    deadline is scored against its in-order completion, and the outputs
    stay bitwise those of a stream without an admission controller."""
    outs, stats = [], []
    for with_adm in (False, True):
        model = _sensor()
        sess = OffloadSession(model, "rrto", min_repeats=2, seed=0, device="cpu",
                              partition=PartitionConfig(pipelined=True))
        for _ in range(4):
            sess.infer(*model.example_inputs)
        assert sess.client.pipelined_exec is not None
        adm = AdmissionController(rate_hz=1e6) if with_adm else None
        sess.admission = adm
        res = sess.infer_stream([tuple(model.example_inputs)] * 4,
                                deadlines=[1e-12, 1e-12, 10.0, 10.0])
        outs.append([r.outputs for r in res])
        stats.append(adm.stats.as_dict() if adm is not None else None)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(*outs))
    assert stats[1]["deadline_misses"] == 2 and stats[1]["deadline_hits"] == 2
    assert stats[1]["requests"] == 0     # the pipelined path decides nothing


def test_sweep_equals_the_reference(knee):
    """The same sweep through the JAX package (``benchmarks/load_knee.py
    --smoke``): every phase's offered, admitted, degraded and shed counts,
    the simulated p99s and the tenants' shares are equal."""
    from benchmarks.load_knee import run

    ref_points, ref_checks = run(smoke=True)
    points, checks, _, _ = knee
    assert checks == ref_checks
    for p, r in zip(points, ref_points):
        assert (p.multiplier, p.offered, p.admitted, p.degraded, p.shed) == (
            r.multiplier, r.offered, r.admitted, r.degraded, r.shed)
        assert p.admitted_p99_ms == pytest.approx(r.admitted_p99_ms, rel=1e-9)
        assert p.twin_p99_ms == pytest.approx(r.twin_p99_ms, rel=1e-9)
        assert p.admitted_share == pytest.approx(r.admitted_share, rel=1e-12)
