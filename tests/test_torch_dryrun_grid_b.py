"""38 cells of the dry run's grid (``test_torch_dryrun_grid.py`` says how
the 80 are split): minicpm3-4b (MLA), llava-next-34b (the patch prefix),
zamba2-1.2b (its first group of 6 Mamba2 layers and the shared block),
whisper-base (one encoder and one decoder layer), and xlstm-1.3b (its
first group of 7 mLSTM blocks and an sLSTM block) but for train_4k, at
full width.  xlstm-1.3b's prefill_32k exceeds the node budget (one sLSTM
step a token) and is extrapolated; its decode steps are traced."""
from __future__ import annotations

import pytest

from test_torch_dryrun_grid import check_arch, check_ok_record, run_grid, statuses
from repro_torch.launch.dryrun import NODE_BUDGET

ARCHS = ["minicpm3-4b", "llava-next-34b", "zamba2-1.2b", "whisper-base"]
XLSTM_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_b")
    return {**run_grid(ARCHS, out), **run_grid(["xlstm-1.3b"], out, XLSTM_SHAPES)}


@pytest.mark.timeout(600)
def test_grid_counts(grid):
    # 38 cells: 32 ok, 6 skipped (long_500k of minicpm3, llava and whisper);
    # with the other two files' 34 + 2 ok and 6 skipped: 68 ok, 12 skipped
    assert statuses(grid) == (38, 32, 6, 0)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_arch_records(grid, arch):
    check_arch(grid, arch)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("shape", XLSTM_SHAPES)
def test_xlstm_cells(grid, shape):
    recs = [grid["xlstm-1.3b", shape, mesh] for mesh in ("single", "multi")]
    for rec in recs:
        check_ok_record(rec)
    whole = recs[0]["whole_program"]
    if shape == "prefill_32k":
        # 128 is the scan's chunk
        assert whole["extrapolated_from"] == [128, 256]
        assert whole["liveness"]["peak_is_lower_bound"]
        assert whole["cost"]["n_nodes"] > NODE_BUDGET
    else:
        assert whole["extrapolated_from"] is None
    assert recs[0]["whole_program"] == recs[1]["whole_program"]
