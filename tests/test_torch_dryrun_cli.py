"""The dry run's collectives and records (``repro_torch.launch.dryrun``).

* Collectives: the counts and bytes a rank is predicted to issue under
  ``sp_decode`` and ``moe_groups`` equal the calls a (2, 2) gloo run of the
  same steps makes (``tests/gloo_ranks.py``; each rank wraps
  ``torch.distributed``'s calls to count them).
* The CLI: both meshes from one trace, a skipped and a failed cell
  recorded, its own output directory, and no fallback to the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gloo_ranks import ROOT, run_ranks
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

KINDS = {"train": (64, 4), "prefill": (64, 4), "decode": (64, 4)}   # (seq, batch)


# ---------------------------------------------------------------------------
# collectives: predicted per rank against a (2, 2) gloo run
# ---------------------------------------------------------------------------

COLL_CASES = {
    # name: (arch, overrides, kind, seq, batch)
    "sp_decode": ("qwen3-0.6b", {"sp_decode": True}, "decode", 32, 2),
    "moe_train": ("mixtral-8x7b", {"moe_groups": 2}, "train", 64, 4),
    "moe_train_shared_expert": ("llama4-maverick-400b-a17b", {"moe_groups": 2}, "train", 64, 4),
    "moe_decode_few_tokens": ("mixtral-8x7b", {"moe_groups": 2}, "decode", 32, 4),
}

RANK_BODY = """
import dataclasses, json
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import PartitionSpec as P, block_of, use_mesh
from repro_torch.launch.mesh import make_live_mesh
from repro_torch.models import lm
from repro_torch.training.data import DataConfig, synth_batch
from repro_torch.training.step import init_train_state, make_train_step

calls = []
_all_reduce, _all_gather = dist.all_reduce, dist.all_gather


def all_reduce(t, *a, **k):
    calls.append(("all-reduce", t.numel() * t.element_size()))
    return _all_reduce(t, *a, **k)


def all_gather(parts, t, *a, **k):
    calls.append(("all-gather", sum(p.numel() * p.element_size() for p in parts)))
    return _all_gather(parts, t, *a, **k)


dist.all_reduce, dist.all_gather = all_reduce, all_gather
mesh = make_live_mesh((2, 2), ("data", "model"))
cases = json.loads(str(inputs["cases"]))
for name, (arch, kw, kind, seq, batch) in cases.items():
    cfg = dataclasses.replace(get_reduced_config(arch), **kw)
    dp = mesh.coordinate("data")
    rows = batch // 2 if batch % 2 == 0 else batch      # the batch's block over "data"
    if kind == "train":
        params, opt = init_train_state(cfg, 0, "cpu")
        nb = synth_batch(cfg, ShapeConfig(kind, seq, batch, kind), 0, DataConfig())
        local = {k: torch.as_tensor(np.asarray(v))[dp * rows:(dp + 1) * rows] for k, v in nb.items()}
        step = make_train_step(cfg, remat=True)
        run = lambda: step(params, opt, local)
    else:
        params = lm.init_params(cfg, 0, "cpu")
        b = batch if cfg.sp_decode else rows
        cache = lm.init_cache(cfg, b, seq, "cpu")
        if cfg.sp_decode:     # the cache's sequence over "model"
            cache = {s: {n: block_of(t, mesh, P(None, None, "model", None, None)).clone()
                         for n, t in c.items()} for s, c in cache.items()}
        tok = torch.zeros((b, 1), dtype=torch.int32)
        run = lambda: lm.decode_step(params, tok, cache, torch.tensor(5, dtype=torch.int32), cfg)
    calls.clear()
    with use_mesh(mesh):
        run()
    for kind_ in ("all-reduce", "all-gather"):
        sel = [nb_ for k, nb_ in calls if k == kind_]
        results[f"{name}/{kind_}/count"] = np.array(len(sel))
        results[f"{name}/{kind_}/bytes"] = np.array(sum(sel))
"""


@pytest.fixture(scope="module")
def gloo_calls(tmp_path_factory):
    base = tmp_path_factory.mktemp("dryrun_coll")
    return run_ranks(base / "w4", 4, RANK_BODY, {"cases": np.array(json.dumps(COLL_CASES))})


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", sorted(COLL_CASES))
def test_collectives_match_a_gloo_run(gloo_calls, name):
    arch, kw, kind, seq, batch = COLL_CASES[name]
    cfg = dataclasses.replace(get_reduced_config(arch), **kw)
    pred = dryrun.per_rank_collectives(cfg, ShapeConfig(kind, seq, batch, kind),
                                       Mesh(("data", "model"), (2, 2)))
    assert pred["counts"], "the case predicts no collective"
    for rank in gloo_calls:
        for k in ("all-reduce", "all-gather"):
            assert int(rank[f"{name}/{k}/count"]) == pred["counts"].get(k, 0), (name, k)
            assert int(rank[f"{name}/{k}/bytes"]) == pred["bytes_by_kind"].get(k, 0), (name, k)


def test_no_collectives_without_the_knobs():
    cfg = get_reduced_config("mixtral-8x7b")
    for kind, (seq, batch) in KINDS.items():
        pred = dryrun.per_rank_collectives(cfg, ShapeConfig(kind, seq, batch, kind),
                                           make_production_mesh())
        assert pred == {"bytes_by_kind": {}, "counts": {}, "total_bytes": 0}


# ---------------------------------------------------------------------------
# the CLI and its records
# ---------------------------------------------------------------------------

def test_cli_writes_both_meshes_from_one_trace(tmp_path):
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--device", "cpu",
                 "--out", str(tmp_path), "--set", "n_layers=1", "--tag", "one"])
    recs = {m: json.loads((tmp_path / f"qwen3-0.6b__decode_32k__{m}__one.json").read_text())
            for m in ("single", "multi")}
    assert [recs[m]["status"] for m in recs] == ["ok", "ok"]
    assert (recs["single"]["trace_reused"], recs["multi"]["trace_reused"]) == (False, True)
    assert recs["single"]["whole_program"] == recs["multi"]["whole_program"]
    assert (recs["single"]["n_devices"], recs["multi"]["n_devices"]) == (256, 512)
    w = recs["single"]["whole_program"]
    assert w["cost"]["launches"] == {"decode_attention": 1, "rmsnorm": 5}
    assert w["cost"]["flops"] > 0 and w["cost"]["hbm_bytes"] > 0
    assert w["liveness"]["peak_bytes"] >= w["liveness"]["argument_bytes"] > 0
    # the batch of 128 splits 8 ways more on the multi-pod mesh's 32 dp ranks
    assert (recs["multi"]["per_rank"]["memory"]["argument_size_in_bytes"]
            < recs["single"]["per_rank"]["memory"]["argument_size_in_bytes"])


def test_skipped_cell_and_failed_cell_are_recorded(tmp_path, monkeypatch):
    # whisper-base skips long_500k; a cell whose trace raises is recorded
    # as failed, with its error and traceback, and the sweep moves on
    msg = dryrun.run_cell("whisper-base", "long_500k", "single", str(tmp_path), device="cpu")
    assert msg.startswith("SKIPPED")
    rec = json.loads((tmp_path / "whisper-base__long_500k__single.json").read_text())
    assert rec["status"] == "skipped" and "reason" in rec

    def broken(*a, **k):
        raise ValueError("no trace")

    monkeypatch.setattr(dryrun, "trace_cell", broken)
    msg = dryrun.run_cell("qwen3-0.6b", "decode_32k", "single", str(tmp_path), device="cpu")
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__single.json").read_text())
    assert msg.startswith("FAILED") and rec["status"] == "failed"
    assert rec["error"] == "ValueError: no trace" and "Traceback" in rec["traceback"]


def test_default_out_dir_is_its_own():
    assert dryrun.RESULTS_DIR.endswith(os.path.join("results", "dryrun_torch"))
    assert os.path.dirname(dryrun.RESULTS_DIR) == os.path.join(str(ROOT), "results")


def test_cuda_without_a_card_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
