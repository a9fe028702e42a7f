"""The dry run's extrapolation of the sLSTM's time loop
(``repro_torch.launch.dryrun.trace_cell``): the counts extrapolated from
two short traces equal a direct trace at a third length, node and launch
counts exactly, flops and bytes within 1e-6 relative; the liveness peak,
a maximum over the step's ops, is a lower bound."""
from __future__ import annotations

import pytest

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun


def _flat_numbers(rec, prefix=""):
    out = {}
    for k, v in rec.items():
        if isinstance(v, dict):
            out.update(_flat_numbers(v, f"{prefix}{k}/"))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[prefix + k] = v
    return out


EXACT = ("cost/n_nodes", "cost/launches/")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind,cfg_kw,lengths", [
    # the sLSTM's loop, one step a token: a prefill at the scan's chunk
    ("prefill", {"n_layers": 3, "slstm_every": 3, "ssm_chunk": 16}, (16, 32, 80)),
    # a train step past one loss chunk: lengths at multiples of CHUNK_LEN,
    # the loss walked in 1, 2 and 3 chunks (its gradient into the hidden
    # state one (B, S, D) tensor, not one a chunk: affine in S)
    ("train", {"n_layers": 2, "ssm_chunk": 64}, (256, 512, 768)),
    # an sLSTM train step within one loss chunk, from two and three scan
    # chunks (at one, the unread final state's product leaves the count)
    ("train", {"n_layers": 3, "slstm_every": 3, "ssm_chunk": 16}, (32, 48, 64)),
])
def test_extrapolated_counts_equal_a_direct_trace(kind, cfg_kw, lengths, monkeypatch):
    cfg = get_reduced_config("xlstm-1.3b", **cfg_kw)
    s_a, s_b, s = lengths
    shape = ShapeConfig(kind, s, 2, kind)
    assert dryrun.extrapolation_lengths(cfg, shape) == (s_a, s_b)
    monkeypatch.setattr(dryrun, "NODE_BUDGET", 0)     # extrapolate whatever the length
    extra, _ = dryrun.trace_cell(cfg, shape, "cpu")
    direct = dryrun.whole_program(dryrun.trace_step(cfg, shape, "cpu"))
    assert extra["extrapolated_from"] == [s_a, s_b]
    assert direct["extrapolated_from"] is None
    want, got = _flat_numbers(direct), _flat_numbers(extra)
    checked = 0
    for key, v in want.items():
        if key in ("trace_seconds", "analysis_seconds") or key.startswith("liveness/top_"):
            continue
        if key in ("liveness/peak_bytes", "liveness/temp_bytes"):
            # a maximum over the ops: its continuation is a lower bound
            assert got[key] <= v, key
            continue
        if key.startswith(EXACT):
            assert got[key] == v, key
        else:
            assert got[key] == pytest.approx(v, rel=1e-6), key
        checked += 1
    assert got["cost/launches/rmsnorm"] > 0 and checked >= 10
    assert extra["liveness"]["peak_is_lower_bound"]
