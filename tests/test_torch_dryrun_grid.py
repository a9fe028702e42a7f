"""The dry run's whole grid: ``run_cell`` over every (arch x shape x mesh)
cell, 10 archs x 4 shapes x 2 meshes = 80, each arch cut to its first
layer group (full width, full shapes) so the sweep runs on one host core.
The 40 cells of the five decoder LMs with a single kind of layer are
here; minicpm3-4b's, llava-next-34b's, zamba2-1.2b's and whisper-base's
32 and 6 of xlstm-1.3b's are in ``test_torch_dryrun_grid_b.py``; its
train_4k cells, whose sLSTM step is extrapolated from two traces of 128
and 256 tokens, in ``test_torch_dryrun_grid_xlstm.py``.
Together: 68 ``ok``, 12 ``skipped`` (``shape_applies``), 0 ``failed``, and
each ``ok`` record has flops and HBM bytes > 0, as the reference's
``TestDryRunArtifacts`` asks of its records."""
from __future__ import annotations

import json

import pytest

from repro_torch.configs import CONFIGS
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b", "deepseek-67b", "qwen3-1.7b", "qwen3-0.6b"]


def first_group(cfg) -> dict:
    """Overrides that cut an arch to its first layer group: one layer of
    each stack of an encoder-decoder, else one period of the arch's
    interleaving (MoE every k, the shared attention block after every k,
    an sLSTM every k), else one layer."""
    if cfg.is_encoder_decoder:
        return {"n_layers": 1, "enc_layers": 1, "dec_layers": 1}
    return {"n_layers": max(cfg.moe_every, cfg.attn_every, cfg.slstm_every, 1)}


def run_grid(archs, out_dir, shapes=tuple(SHAPES)) -> dict:
    """(arch, shape, mesh) -> its record, each arch's traces reused across
    its meshes as the CLI reuses them."""
    records = {}
    for arch in archs:
        traces = {}
        for shape in shapes:
            for mesh in ("single", "multi"):
                dryrun.run_cell(arch, shape, mesh, str(out_dir), force=True,
                                overrides=first_group(CONFIGS[arch]), device="cpu",
                                traces=traces)
                path = out_dir / f"{arch}__{shape}__{mesh}.json"
                records[arch, shape, mesh] = json.loads(path.read_text())
    return records


def check_ok_record(rec) -> None:
    assert rec["status"] == "ok", rec.get("traceback")
    cost = rec["whole_program"]["cost"]
    assert cost["flops"] > 0 and cost["hbm_bytes"] > 0 and cost["dot_flops"] > 0
    mem = rec["per_rank"]["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert rec["whole_program"]["liveness"]["peak_bytes"] > 0
    assert rec["per_rank"]["collectives"]["counts"] == {}     # no knob is set


def check_arch(grid, arch) -> None:
    """An arch's 8 records: a skipped shape skipped on both meshes, every
    other cell ok from one trace serving both meshes."""
    for shape in SHAPES:
        cfg = CONFIGS[arch]
        recs = [grid[arch, shape, mesh] for mesh in ("single", "multi")]
        if shape in cfg.skip_shapes:
            assert [r["status"] for r in recs] == ["skipped", "skipped"]
            continue
        for rec in recs:
            check_ok_record(rec)
            assert rec["whole_program"]["extrapolated_from"] is None
        # one trace serves both meshes
        assert [r["trace_reused"] for r in recs] == [False, True]
        assert recs[0]["whole_program"] == recs[1]["whole_program"]


def statuses(grid) -> tuple:
    st = [rec["status"] for rec in grid.values()]
    return len(st), st.count("ok"), st.count("skipped"), st.count("failed")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return run_grid(ARCHS, tmp_path_factory.mktemp("grid"))


@pytest.mark.timeout(600)
def test_grid_counts(grid):
    # 40 cells: 34 ok, 6 skipped (long_500k of deepseek-67b and both qwen3s)
    assert statuses(grid) == (40, 34, 6, 0)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_arch_records(grid, arch):
    check_arch(grid, arch)
