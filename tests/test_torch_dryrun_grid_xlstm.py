"""xlstm-1.3b's train_4k cells of the dry run's grid
(``test_torch_dryrun_grid.py`` says how the 80 are split), cut to its
first layer group of 7 mLSTM blocks and an sLSTM block at full width: the
step exceeds the node budget (one sLSTM step a token) and is
extrapolated from two short traces at multiples of the loss's chunk."""
from __future__ import annotations

import pytest

from test_torch_dryrun_grid import check_ok_record, run_grid
from repro_torch.launch.dryrun import NODE_BUDGET


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return run_grid(["xlstm-1.3b"], tmp_path_factory.mktemp("grid_xlstm"), ("train_4k",))


@pytest.mark.timeout(600)
def test_xlstm_train_cells(grid):
    recs = [grid["xlstm-1.3b", "train_4k", mesh] for mesh in ("single", "multi")]
    for rec in recs:
        check_ok_record(rec)
    whole = recs[0]["whole_program"]
    # 256 is the loss's chunk, a multiple of the scan's 128
    assert whole["extrapolated_from"] == [256, 512]
    assert whole["liveness"]["peak_is_lower_bound"]
    assert whole["cost"]["n_nodes"] > NODE_BUDGET
    assert whole["cost"]["launches"]["ssm_scan_backward"] == 7
    assert [r["trace_reused"] for r in recs] == [False, True]
    assert recs[0]["whole_program"] == recs[1]["whole_program"]
