"""The port's dry run against the JAX package's (``test_torch_dryrun.py``
says how) for zamba2 (the hybrid, with a full group), xlstm (an sLSTM
block, 4 scan chunks a sequence) and whisper (the encoder-decoder), whose
dot flops carry the named gaps of ``NAMED_GAPS``."""
from __future__ import annotations

import pytest

from test_torch_dryrun import KINDS, check_bytes, check_dot_flops, reference_cells

HERE = ("zamba2", "xlstm", "whisper")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return reference_cells(tmp_path_factory.mktemp("dryrun_b"), HERE)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", HERE)
def test_per_rank_bytes_match_reference_memory_analysis(cells, name, kind):
    check_bytes(cells, name, kind)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", HERE)
def test_dot_flops_match_reference_hlo(cells, name, kind):
    check_dot_flops(cells, name, kind)
