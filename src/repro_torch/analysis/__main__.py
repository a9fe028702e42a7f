"""Verification sweep CLI: ``python -m repro_torch.analysis --all-registry``.

For every selected registry model this drives a real record→replay session
to its locked IOS (threading carried state for stateful models) on
``--device`` (the card by default; ``--device cpu`` off it), then runs the
full static-analysis suite over the recording: the dataflow linter, the
donation sanitizer, a planner sweep (``plan_partition`` at several
bandwidths × objectives, plus the binary-offloading endpoints, each plan
verified against the segment graph), the aten op census, and — once per
sweep — the at-most-once model check of the shipped protocol constants.
The reference's HLO-weighted census has no counterpart: the port's aten
graph has no loops to weight.

Exit status 1 iff any ERROR diagnostic was reported, which is what lets CI
gate on ``--all-registry --json report.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

# small-but-real configurations (the reference's): every model records,
# locks and replays in seconds on the CPU while keeping its full
# kernel-stream structure
SWEEP_CASES: Dict[str, Dict[str, Any]] = {
    "vgg16": dict(scale=0.1, input_size=32),
    "resnet50": dict(scale=0.1, input_size=32),
    "sensor_encoder": dict(scale=0.25, input_size=32, n_blocks=2),
    "recurrent_sensor_decoder": dict(
        scale=0.25, input_size=32, n_blocks=2, d_state=32
    ),
    "convnext_tiny": dict(scale=0.1, input_size=32),
    "fcn_resnet50": dict(scale=0.1, input_size=64),
    "deeplabv3_resnet50": dict(scale=0.1, input_size=64),
    "fasterrcnn_resnet50": dict(scale=0.1, input_size=64),
    # retinanet's top-64 box decode needs >= 64 anchors: input_size >= 128
    "retinanet_resnet50": dict(scale=0.1, input_size=128),
    # kapao's top-k decode needs >= 64 grid cells: input_size >= 256
    "kapao": dict(scale=0.1, input_size=256),
}

MBPS = 1e6 / 8.0
SWEEP_BANDWIDTHS = (1 * MBPS, 16 * MBPS, 128 * MBPS)
SWEEP_OBJECTIVES = ("latency", "energy")
# carried-state threading for the stateful registry entries:
# model -> (output ordinal, input ordinal)
STATE_THREADING = {"recurrent_sensor_decoder": (1, 1)}


def _lock_session(name: str, kwargs: Dict[str, Any], min_repeats: int,
                  device: Any):
    from repro_torch.core.offload import OffloadSession
    from repro_torch.models.cnn_zoo import ZOO

    model = ZOO[name](**kwargs, device=device)
    sess = OffloadSession(model, "rrto", min_repeats=min_repeats,
                          device=device)
    sess.load()
    args = list(model.example_inputs)
    thread = STATE_THREADING.get(name)
    res = None
    for _ in range(2 * min_repeats + 2):
        res = sess.infer(*args)
        if thread is not None:
            out_ord, in_ord = thread
            args[in_ord] = res.outputs[out_ord]
        if res.mode == "replaying":
            break
    if res is None or res.mode != "replaying":
        raise RuntimeError(f"{name}: session never locked its IOS")
    return sess


def sweep_plans(graph, client_device, server_device) -> List[Any]:
    """The planner sweep over one segment graph: the binary-offloading
    endpoints every session can fall back to, then the emitted plan at
    every operating point (bandwidth × objective), each signature once."""
    from repro_torch.partition.planner import PartitionConfig, plan_partition
    from repro_torch.partition.segments import SplitPlan

    plans: List[Any] = [
        SplitPlan.full_server(graph.n_ops),
    ]
    if not graph.is_stateful:   # a stateful IOS pins its suffix server-side
        plans.append(SplitPlan.full_device(graph.n_ops))
    seen = {p.signature() for p in plans}
    for objective in SWEEP_OBJECTIVES:
        for bw in SWEEP_BANDWIDTHS:
            best = plan_partition(
                graph, client_device, server_device, bw,
                config=PartitionConfig(objective=objective),
            )
            if best.plan.signature() not in seen:
                seen.add(best.plan.signature())
                plans.append(best.plan)
    return plans


def sweep_model(
    name: str,
    *,
    min_repeats: int = 2,
    case_kwargs: Optional[Dict[str, Any]] = None,
    device: Any = "cuda",
):
    """Record, lock and fully verify one registry model on ``device``;
    returns its :class:`~repro_torch.analysis.diagnostics.AnalysisReport`."""
    from repro_torch.analysis.verify import verify_ios
    from repro_torch.partition.segments import SegmentGraph

    kwargs = dict(SWEEP_CASES.get(name, {}), **(case_kwargs or {}))
    sess = _lock_session(name, kwargs, min_repeats, device)
    calls = sess.client._ios_calls
    program = sess.server.context(sess.client_id).replay.program
    pairs = program.carried_pairs

    graph = SegmentGraph(calls, carried_pairs=pairs)
    plans = sweep_plans(graph, sess.client_device, sess.server_device)
    report = verify_ios(
        name,
        calls,
        pairs,
        plans=plans,
        min_repeats=min_repeats,
    )
    report.census["n_plans_verified"] = len(plans)
    report.census["carried_pairs"] = [list(p) for p in pairs]
    return report


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="replay soundness verification sweep",
    )
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument(
        "--all-registry", action="store_true",
        help="sweep every model in the registry zoo",
    )
    group.add_argument(
        "--models", nargs="+", metavar="NAME",
        help="sweep a subset of registry models",
    )
    parser.add_argument(
        "--json", metavar="PATH",
        help="write the machine-readable report (\"-\" for stdout)",
    )
    parser.add_argument(
        "--min-repeats", type=int, default=2,
        help="recording repeats before the IOS locks (default 2)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the sessions record and replay (default cuda)",
    )
    args = parser.parse_args(argv)

    from repro_torch.analysis.diagnostics import AnalysisReport
    from repro_torch.analysis.protocol import check_engine_protocol
    from repro_torch.models.cnn_zoo import ZOO

    names = sorted(ZOO) if args.all_registry else args.models
    unknown = [n for n in names if n not in ZOO]
    if unknown:
        parser.error(f"unknown models: {', '.join(unknown)}")

    reports: List[AnalysisReport] = []
    for name in names:
        print(f"[analysis] {name}: recording + verifying ...", flush=True)
        report = sweep_model(
            name, min_repeats=args.min_repeats, device=args.device,
        )
        reports.append(report)
        _print_report(report)

    protocol_report = AnalysisReport(subject="at-most-once protocol")
    protocol_report.extend(check_engine_protocol())
    reports.append(protocol_report)
    _print_report(protocol_report)

    n_errors = sum(len(r.errors) for r in reports)
    n_warnings = sum(len(r.warnings) for r in reports)
    payload = {
        "ok": n_errors == 0,
        "n_errors": n_errors,
        "n_warnings": n_warnings,
        "reports": [r.as_dict() for r in reports],
    }
    if args.json == "-":
        json.dump(payload, sys.stdout, sort_keys=True, indent=2)
        print()
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, sort_keys=True, indent=2)
        print(f"[analysis] wrote {args.json}")
    print(
        f"[analysis] {len(reports)} subjects, {n_errors} errors, "
        f"{n_warnings} warnings"
    )
    return 1 if n_errors else 0


def _print_report(report) -> None:
    mark = "ok" if report.ok else "FAIL"
    extra = ""
    if report.census:
        extra = (
            f" ({report.census['n_kernels']} kernels, "
            f"{report.census['flops']:.3g} flops, "
            f"{report.census.get('n_plans_verified', 0)} plans)"
        )
    print(f"[analysis] {report.subject}: {mark}{extra}")
    for d in report.diagnostics:
        print(f"    {d.severity.upper()} {d.code}: {d.message}")


if __name__ == "__main__":
    sys.exit(main())
