"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
and record what it costs each device (``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # the card's program

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
(never ``results/dryrun/``, the reference's).  Nothing is allocated: the
stand-ins are fake tensors (``FakeTensorMode``), so llama4-maverick's 400 B
parameters cost only a trace.  ``--device cuda`` (the default, as for every
entry point of the port) traces the card's program and needs PyTorch with
CUDA but no free memory; ``--device cpu`` traces the CPU's, which differs
where the port branches on the device (bf16 products with an f32 result on
the card, widened operands on the CPU).

The reference lowers and compiles each cell for its mesh, so its figures
are per device.  The port has no partitioner, so a record splits in two:

* ``per_rank``: what follows from the specs alone, by the reference's rules
  (:func:`_fit`: an axis that does not divide its dimension is dropped;
  :func:`batch_shardings`; :func:`_strip_tp` under ``disable_tp``).
  ``memory.argument_size_in_bytes`` (train: params, opt state, batch;
  prefill: params, batch; decode: params, token, cache, pos) and
  ``output_size_in_bytes`` (by the reference's ``out_shardings``).
  ``temp_size_in_bytes`` is null: the reference's comes from XLA's
  partitioned program, which the port does not have, and a whole-program
  figure divided by the device count would not be it.  ``collectives``
  counts only the calls the port issues itself, at the rank's block: the
  sequence-parallel decode's 3 all-reduces an attention layer
  (``cfg.sp_decode``) and the shard-local MoE dispatch's (``cfg.moe_groups``);
  GSPMD's implied collectives have no counterpart and are not estimated.
* ``whole_program``: the traced step, never a rank's share, metered in
  the trace's own pass (``graph_analysis.metered``).  ``cost`` holds
  ``graph_analysis.analyze_graph``'s keys (flops, dot flops, HBM bytes,
  launches a step by kernel), ``liveness`` the peak of the bytes alive with
  the arguments live throughout, the temp bytes above the arguments and the
  largest buffers at the peak (each buffer freed with its last tensor
  object, as the card's caching allocator frees it, AdamW's Python-held
  temporaries included), and ``alias_size_in_bytes`` the argument bytes the
  step updates in place (AdamW's params, m and v).

One trace serves both meshes of an (arch, shape): a mesh changes only the
per-rank numbers.  The steps are the reference's: the train step of
``training/step.py::make_train_step(cfg, remat=True)``, ``prefill`` at the
effective length and ``decode_step``.

The sLSTM's time loop unrolls one step a token (~702 nodes a token for
xlstm-1.3b's train step), so where a direct trace would exceed
:data:`NODE_BUDGET` nodes the step is run at two short lengths on fake
tensors under the meter, with no trace (``graph_analysis.measure_step``),
and every count is extrapolated affinely in the sequence length; the
lengths are multiples of the scan's chunk and, for a train step longer
than one loss chunk, of the loss's ``CHUNK_LEN`` (``extrapolation_lengths``),
so every count is affine in between.  The graph, for the arguments the
step reads and updates and its outputs, none of which depends on the
length, is traced at the scan's chunk.  Such a record carries
``whole_program.extrapolated_from``; its liveness peak, a maximum over the
step's ops and so convex in the length, is the affine continuation's lower
bound (``peak_is_lower_bound``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.configs import CONFIGS
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh, PartitionSpec as P, translate_tree
from repro_torch.launch.graph_analysis import (
    alias_bytes,
    measure_step,
    metered,
    needed_nodes,
)
from repro_torch.launch.mesh import make_production_mesh, mesh_dp_size
from repro_torch.models.registry import (
    batch_specs,
    decode_specs,
    effective_lengths,
    get_model,
    params_shape,
    shape_applies,
)
from repro_torch.training.losses import CHUNK_LEN
from repro_torch.training.optimizer import init_opt_state, opt_state_specs
from repro_torch.training.step import make_train_step

RESULTS_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"))

# a direct trace costs ~1 ms a node on a host core; beyond this many nodes
# an sLSTM step is extrapolated from two short traces instead
NODE_BUDGET = 150_000

def _is_leaf(x) -> bool:
    return isinstance(x, (P, torch.Tensor))


def _map(fn, *trees):
    """``fn`` over the leaves (specs or tensors) of trees of one structure."""
    t0 = trees[0]
    if _is_leaf(t0):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_map(fn, *parts) for parts in zip(*trees))
    raise TypeError(f"not a tree leaf: {t0!r}")


# ---------------------------------------------------------------------------
# per-rank layouts by the reference's rules
# ---------------------------------------------------------------------------

def _fit(spec: P, shape, mesh: Mesh) -> P:
    """Drop sharding axes whose size does not divide the dimension (the
    reference's rule: jit shardings need exact divisibility, replication is
    the fallback)."""
    sizes = mesh.shape
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, parts):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        total = math.prod(sizes[a] for a in axes)
        out.append(ax if (dim > 0 and dim % total == 0) else None)
    return P(*out)


def _sharding_tree(spec_tree, mesh: Mesh, struct_tree):
    translated = translate_tree(spec_tree, mesh.axis_names)
    return _map(lambda s, st: _fit(s, tuple(st.shape), mesh), translated, struct_tree)


def batch_shardings(batch_struct, mesh: Mesh):
    dp = mesh.dp_axes()
    return _map(lambda leaf: _fit(P(dp, *([None] * (leaf.ndim - 1))), tuple(leaf.shape), mesh),
                batch_struct)


def _strip_tp(tree):
    return _map(lambda spec: P(*(None if a == "tp" else a for a in spec)), tree)


def block_bytes(t, spec: P, mesh: Mesh) -> int:
    """Bytes of one device's block of ``t`` under a fitted physical spec."""
    sizes = mesh.shape
    n = 1
    for d, ax in enumerate(tuple(t.shape)):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            n *= ax
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n *= ax // math.prod(sizes[a] for a in axes)
    return n * t.element_size()


def tree_block_bytes(struct_tree, spec_tree, mesh: Mesh) -> int:
    sizes = []
    _map(lambda t, s: sizes.append(block_bytes(t, s, mesh)), struct_tree, spec_tree)
    return sum(sizes)


def _replicated(tree):
    return _map(lambda t: P(), tree)


# ---------------------------------------------------------------------------
# the traced step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    gm: torch.fx.GraphModule
    inputs: tuple            # the stand-ins, in the step's argument structure
    outputs: Any             # the step's outputs, in its return structure
    metered: Dict[str, Any]  # graph_analysis.metered: the step's cost and liveness
    seconds: float


def _step_and_stand_ins(cfg: ArchConfig, shape: ShapeConfig, device: torch.device, *,
                        remat: bool = True):
    model = get_model(cfg)
    metas: Dict[str, Any] = {"params": params_shape(cfg)}
    if shape.kind == "decode":
        metas["token"], metas["cache"], metas["pos"] = decode_specs(cfg, shape)
    else:
        metas["batch"] = batch_specs(cfg, shape)
    mode = FakeTensorMode()
    with mode:
        fakes = _map(lambda m: torch.empty(m.shape, dtype=m.dtype, device=device), metas)
        if shape.kind == "train":
            opt = init_opt_state(fakes["params"])
    if shape.kind == "train":
        step = make_train_step(cfg, remat=remat)
        return step, (fakes["params"], opt, fakes["batch"])
    if shape.kind == "prefill":
        eff = effective_lengths(cfg, shape)["seq"]
        return (lambda p, b: model.prefill(p, b, cfg, eff)), (fakes["params"], fakes["batch"])
    return ((lambda p, tok, cache, pos: model.decode_step(p, tok, cache, pos, cfg)),
            (fakes["params"], fakes["token"], fakes["cache"], fakes["pos"]))


def trace_step(cfg: ArchConfig, shape: ShapeConfig, device: Any = "cuda", *,
               remat: bool = True) -> Trace:
    """The whole step of ``shape`` traced in fake mode on ``device`` (the
    train step with ``remat``, as the reference's dry run takes it, unless
    told otherwise), metered in the same pass."""
    step, args = _step_and_stand_ins(cfg, shape, resolve_device(device), remat=remat)
    captured = {}

    def fn(*a):
        with metered(a) as rec:
            out = step(*a)
        captured.update(out=out, metered=rec)
        return out

    t0 = time.perf_counter()
    gm = make_fx(fn, tracing_mode="fake")(*args)
    return Trace(gm, args, captured["out"], captured["metered"], time.perf_counter() - t0)


def measure(cfg: ArchConfig, shape: ShapeConfig, device: Any = "cuda", *,
            remat: bool = True) -> Dict[str, Any]:
    """The step of ``shape`` run once on fake tensors under the meter, with
    no trace: ``cost``, ``liveness`` and ``seconds``."""
    step, args = _step_and_stand_ins(cfg, shape, resolve_device(device), remat=remat)
    t0 = time.perf_counter()
    rec = measure_step(step, args)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def whole_program(tr: Trace) -> Dict[str, Any]:
    """The traced step's cost and its liveness with eager lifetimes (what
    the card's caching allocator holds), and its in-place updates."""
    t0 = time.perf_counter()
    return {
        "cost": tr.metered["cost"],
        "liveness": tr.metered["liveness"],
        "alias_size_in_bytes": alias_bytes(tr.gm),
        "trace_seconds": tr.seconds,
        "analysis_seconds": time.perf_counter() - t0,
        "extrapolated_from": None,
    }


def _extrapolate(a, b, s_a: int, s_b: int, s: int):
    """Every number of ``a`` and ``b`` (two records of one structure)
    continued affinely in the sequence length to ``s``; integers stay
    integers."""
    if isinstance(a, dict):
        return {k: _extrapolate(a[k], b[k], s_a, s_b, s) for k in a if k in b}
    if isinstance(a, bool) or not isinstance(a, (int, float)):
        return b
    v = a + (b - a) * (s - s_a) / (s_b - s_a)
    return int(round(v)) if isinstance(a, int) and isinstance(b, int) else v


def extrapolation_lengths(cfg: ArchConfig, shape: ShapeConfig) -> Optional[Tuple[int, int]]:
    """The two short lengths an sLSTM step may be measured at, or None where
    the step has no time loop or the cell is too short to need them.  Each
    is a multiple of the scan's chunk (the scan pads to it) and, for a
    train step longer than one loss chunk, of ``CHUNK_LEN`` (the loss pads
    to it): every count is then affine in the length.  A train step's
    first length holds two scan chunks or more: at one chunk the product
    that only makes the unread final state leaves the count
    (``graph_analysis.final_state_dots``), which is then not affine."""
    if not cfg.slstm_every or shape.kind not in ("train", "prefill"):
        return None
    unit = cfg.ssm_chunk
    if shape.kind == "train" and shape.seq_len > CHUNK_LEN:
        unit = math.lcm(unit, CHUNK_LEN)
    first = 2 * unit if shape.kind == "train" and unit == cfg.ssm_chunk else unit
    if shape.seq_len <= first + unit or shape.seq_len % unit:
        return None
    return first, first + unit


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, device: Any = "cuda", *,
               remat: bool = True) -> Tuple[Dict[str, Any], Trace]:
    """The whole-program record of one (arch, shape) and the trace it came
    from (where it was extrapolated, the trace at the scan's chunk)."""
    lengths = extrapolation_lengths(cfg, shape)
    if lengths is not None:
        s_a, s_b = lengths
        runs = [measure(cfg, dataclasses.replace(shape, seq_len=s), device, remat=remat)
                for s in lengths]
        n_a, n_b = (r["cost"]["n_nodes"] for r in runs)
        if n_a + (n_b - n_a) * (shape.seq_len - s_a) / (s_b - s_a) > NODE_BUDGET:
            tr = trace_step(cfg, dataclasses.replace(shape, seq_len=cfg.ssm_chunk), device,
                            remat=remat)
            rec = whole_program(tr)
            for key in ("cost", "liveness"):
                rec[key] = _extrapolate(runs[0][key], runs[1][key], s_a, s_b, shape.seq_len)
            # the peak is a maximum over the step's ops, convex in s: its
            # affine continuation beyond s_b is a lower bound
            rec["liveness"]["peak_is_lower_bound"] = True
            rec["liveness"]["top_buffers_at_seq"] = s_b
            rec["trace_seconds"] += runs[0]["seconds"] + runs[1]["seconds"]
            rec["extrapolated_from"] = [s_a, s_b]
            return rec, tr
    tr = trace_step(cfg, shape, device, remat=remat)
    return whole_program(tr), tr


# ---------------------------------------------------------------------------
# per-rank bytes and collectives
# ---------------------------------------------------------------------------

def _param_specs(cfg: ArchConfig):
    specs = get_model(cfg).param_specs(cfg)
    return _strip_tp(specs) if cfg.disable_tp else specs


# XLA's output is one tuple of every leaf, whose table of 8-byte pointers
# its memory analysis counts with the output buffers
TUPLE_ENTRY_BYTES = 8


def _used_inputs(tr: Trace) -> Dict[int, bool]:
    """id of each stand-in -> whether the step reads it.  ``jax.jit`` drops
    an argument its function never reads from the compiled program, so the
    reference's argument bytes leave it out (whisper's encoder weights in a
    decode step, say); a placeholder with no users is such an argument."""
    leaves = pytree.tree_leaves(tr.inputs)
    holders = [n for n in tr.gm.graph.nodes if n.op == "placeholder"]
    assert len(leaves) == len(holders), (len(leaves), len(holders))
    needed = needed_nodes(tr.gm)
    return {id(t): any(u in needed for u in n.users) for t, n in zip(leaves, holders)}


def per_rank_memory(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, tr: Trace) -> Dict[str, Any]:
    model = get_model(cfg)
    dp = mesh_dp_size(mesh)
    used = _used_inputs(tr)

    def arg_bytes(struct, stand_in, spec_tree) -> int:
        sizes = []
        _map(lambda t, f, s: sizes.append(block_bytes(t, s, mesh) if used[id(f)] else 0),
             struct, stand_in, spec_tree)
        return sum(sizes)

    p_specs = _param_specs(cfg)
    p_struct = params_shape(cfg)
    p_shard = _sharding_tree(p_specs, mesh, p_struct)
    args = arg_bytes(p_struct, tr.inputs[0], p_shard)
    if shape.kind == "train":
        _, opt, batch = tr.inputs
        opt_shard = _sharding_tree(opt_state_specs(p_specs, p_struct, dp), mesh, opt)
        full_batch = batch_specs(cfg, shape)
        args += (arg_bytes(opt, opt, opt_shard)
                 + arg_bytes(full_batch, batch, batch_shardings(full_batch, mesh)))
        new_p, new_opt, metrics = tr.outputs
        out = (tree_block_bytes(new_p, p_shard, mesh) + tree_block_bytes(new_opt, opt_shard, mesh)
               + tree_block_bytes(metrics, _replicated(metrics), mesh))
    elif shape.kind == "prefill":
        full_batch = batch_specs(cfg, shape)
        args += arg_bytes(full_batch, tr.inputs[1], batch_shardings(full_batch, mesh))
        logits, cache = tr.outputs
        eff = effective_lengths(cfg, shape)["seq"]
        cache_struct = model.init_cache(cfg, shape.global_batch, eff, "meta")
        cache_shard = _sharding_tree(model.cache_specs(cfg, shape.global_batch, dp), mesh,
                                     cache_struct)
        out = block_bytes(logits, P(), mesh) + tree_block_bytes(cache, cache_shard, mesh)
    else:
        token, cache, pos = decode_specs(cfg, shape)
        tok_spec = P(mesh.dp_axes() if shape.global_batch % dp == 0 else None, None)
        cache_shard = _sharding_tree(model.cache_specs(cfg, shape.global_batch, dp), mesh, cache)
        _, f_tok, f_cache, f_pos = tr.inputs
        args += (arg_bytes(token, f_tok, tok_spec) + arg_bytes(cache, f_cache, cache_shard)
                 + arg_bytes(pos, f_pos, P()))
        logits, new_cache = tr.outputs
        out = block_bytes(logits, tok_spec, mesh) + tree_block_bytes(new_cache, cache_shard, mesh)
    out += TUPLE_ENTRY_BYTES * len(pytree.tree_leaves(tr.outputs))
    return {
        "argument_size_in_bytes": args,
        "output_size_in_bytes": out,
        "temp_size_in_bytes": None,
    }


def _rows_per_rank(batch: int, mesh: Mesh) -> int:
    """A batch's rows on one rank under ``batch_shardings``' rule."""
    dp = mesh_dp_size(mesh)
    return batch // dp if batch % dp == 0 else batch


def decode_attention_sites(cfg: ArchConfig) -> int:
    """Attention layers of a decode step that go through
    ``layers/attention.py::attn_decode_step`` (GQA with a float cache)."""
    if cfg.kv_cache_bits == 8 or cfg.attn_kind == "mla" or cfg.slstm_every:
        return 0
    if cfg.is_encoder_decoder:
        return cfg.dec_layers
    if cfg.attn_every:
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def moe_param_bytes(cfg: ArchConfig) -> Tuple[int, ...]:
    """One MoE layer's router, w_gate, w_up and w_down bytes (the leaves
    whose gradient the shard-local dispatch sums over "model")."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    item = getattr(torch, cfg.dtype).itemsize
    return (d * e * item, e * d * f * item, e * d * f * item, e * f * d * item)


def per_rank_collectives(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> Dict[str, Any]:
    """The collectives the port issues on one rank in one step (a train
    step with remat, as the dry run takes it), with the bytes of each
    call's tensor at the rank's block (an all-gather's, the gathered
    output, as the reference's parser counts it).

    This is a second description of the schedule that
    ``layers/attention.py::_sp_decode_attention`` and
    ``layers/moe.py::_local_dispatch`` issue: a change to their collectives
    must be made here too.  Its one guard is the gloo run of
    ``tests/test_torch_dryrun_cli.py``, which counts the calls those
    functions make on a (2, 2) mesh against these counts."""
    calls = []    # (kind, bytes)
    tp = "model" in mesh.axis_names
    act = getattr(torch, cfg.dtype).itemsize
    if shape.kind == "decode" and cfg.sp_decode and tp:
        b = shape.global_batch
        rows = b // mesh_dp_size(mesh) if b >= 16 and b % mesh_dp_size(mesh) == 0 else b
        for _ in range(decode_attention_sites(cfg)):
            calls += [("all-reduce", 4 * rows * cfg.n_heads),           # m
                      ("all-reduce", 4 * rows * cfg.n_heads),           # l
                      ("all-reduce", 4 * rows * cfg.n_heads * cfg.d_head)]   # o
    n_moe = sum(cfg.moe_layer(i) for i in range(cfg.n_layers))
    if cfg.moe_groups and cfg.moe_experts and tp and n_moe:
        seq = 1 if shape.kind == "decode" else effective_lengths(cfg, shape)["seq"]
        t = _rows_per_rank(shape.global_batch, mesh) * seq
        train = shape.kind == "train"
        layer = []
        # the remat recomputation stops at the layer's last tensor saved
        # for the backward: it issues the forward's collective again only
        # where the shared expert's MLP runs (and saves) after the dispatch
        again = 2 if train and cfg.moe_shared_expert else 1
        if t >= 8:
            # forward: the output's sum over "model"; backward: x's
            # gradient, then each parameter's
            layer += [("all-reduce", t * cfg.d_model * act)] * again
            if train:
                layer += [("all-reduce", t * cfg.d_model * act)]
                layer += [("all-reduce", nb) for nb in moe_param_bytes(cfg)]
        else:
            rows = t
            gathers = []
            for axis in reversed(mesh.dp_axes()):
                rows *= mesh.shape[axis]
                gathers.append(("all-gather", rows * cfg.d_model * act))
            layer += gathers * again
            if train:
                layer += [("all-reduce", nb) for _, nb in gathers]
        calls += layer * n_moe
    by_kind: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for kind, nb in calls:
        by_kind[kind] = by_kind.get(kind, 0) + nb
        counts[kind] = counts.get(kind, 0) + 1
    return {"bytes_by_kind": by_kind, "counts": counts, "total_bytes": sum(by_kind.values())}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, device: Any = "cuda", *,
               traced: Optional[Tuple[Dict[str, Any], Trace]] = None) -> Dict[str, Any]:
    """The record of one cell: ``traced`` (``trace_cell``'s result for this
    (arch, shape)) is reused where given, else the step is traced."""
    whole, tr = traced if traced is not None else trace_cell(cfg, shape, device)
    return {
        "trace_seconds": whole["trace_seconds"],
        "per_rank": {
            "memory": per_rank_memory(cfg, shape, mesh, tr),
            "collectives": per_rank_collectives(cfg, shape, mesh),
        },
        "whole_program": whole,
    }


def parse_overrides(pairs) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for kv in pairs:
        key, val = kv.split("=", 1)
        try:
            overrides[key] = int(val)
        except ValueError:
            overrides[key] = val == "true" if val in ("true", "false") else val
    return overrides


def run_cell(
    arch: str, shape_name: str, mesh_kind: str, out_dir: str = RESULTS_DIR,
    force: bool = False, overrides: Optional[Dict[str, Any]] = None, tag: str = "",
    device: Any = "cuda", traces: Optional[Dict[Any, Any]] = None,
) -> str:
    """Trace (or reuse from ``traces``) and record one cell; a failure is
    recorded with its traceback and the sweep moves on."""
    cfg = CONFIGS[arch]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            prev = json.load(f)
        if prev.get("status") == "ok":
            return f"SKIP (cached ok) {out_path}"

    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "n_devices": 512 if mesh_kind == "multi" else 256,
        "device": str(device),
    }
    if not shape_applies(cfg, shape):
        record["status"] = "skipped"
        record["reason"] = f"{shape_name} not applicable to {arch} (skip_shapes)"
    else:
        try:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
            key = (arch, shape_name, tuple(sorted((overrides or {}).items())), str(device))
            traced = None if traces is None else traces.get(key)
            record["trace_reused"] = traced is not None
            if traced is None:
                traced = trace_cell(cfg, shape, device)
                if traces is not None:
                    traces.clear()          # one (arch, shape) held at a time
                    traces[key] = traced
            record.update(lower_cell(cfg, shape, mesh, device, traced=traced))
            record["status"] = "ok"
        except Exception as e:  # noqa: BLE001 - record and continue
            record["status"] = "failed"
            record["error"] = f"{type(e).__name__}: {e}"
            record["traceback"] = traceback.format_exc()[-4000:]
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return f"{record['status'].upper():7s} {arch} {shape_name} {mesh_kind}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--device", default="cuda",
                    help="the device whose program is traced (cuda, or cpu)")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    device = resolve_device(args.device)
    out_dir = args.out or RESULTS_DIR
    archs = [args.arch] if args.arch else list(CONFIGS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")

    traces: Dict[Any, Any] = {}
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                t0 = time.time()
                msg = run_cell(arch, shape, mesh_kind, out_dir, force=args.force,
                               overrides=overrides, tag=args.tag, device=device, traces=traces)
                print(f"[{time.time()-t0:7.1f}s] {msg}", flush=True)
            traces.clear()


if __name__ == "__main__":
    main()
