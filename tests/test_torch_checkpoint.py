"""The port's checkpoint store (tests/test_checkpoint.py's ``TestStore``):
the save/restore round trip, atomic publish, the restart pointer, async and
concurrent writes, template-free loading, shape checks; and, beyond the
reference, a bf16 round trip that must be bitwise and each package reading
the other's checkpoints of f32 and int32 leaves."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import store as jstore  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402


def make_flat(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params.w": torch.randn(8, 16, generator=g),
        "params.b": torch.zeros(16),
        "opt.m": torch.ones(8, 16),
        "opt.step": torch.tensor(7, dtype=torch.int32),
    }


def _equal(a, b):
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


class TestStore:
    def test_roundtrip(self, tmp_path):
        flat = make_flat()
        store.save(str(tmp_path), 10, flat)
        assert _equal(store.restore(str(tmp_path), 10, flat), flat)

    def test_latest_step(self, tmp_path):
        flat = make_flat()
        store.save(str(tmp_path), 5, flat)
        store.save(str(tmp_path), 15, flat)
        assert store.latest_step(str(tmp_path)) == 15

    def test_latest_ignores_partial_tmp(self, tmp_path):
        store.save(str(tmp_path), 5, make_flat())
        os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed writer's remnant
        assert store.latest_step(str(tmp_path)) == 5

    def test_latest_falls_back_to_a_scan(self, tmp_path):
        store.save(str(tmp_path), 5, make_flat())
        (tmp_path / "LATEST").write_text("9")       # points at a missing dir
        assert store.latest_step(str(tmp_path)) == 5

    def test_latest_none_when_empty(self, tmp_path):
        assert store.latest_step(str(tmp_path)) is None

    def test_async_save(self, tmp_path):
        flat = make_flat()
        t = store.save_async(str(tmp_path), 3, flat)
        t.join()
        assert store.latest_step(str(tmp_path)) == 3

    def test_async_save_snapshots_before_returning(self, tmp_path):
        """The host copy is taken before the writer starts: changing the
        tensor afterwards does not reach the file."""
        flat = make_flat()
        want = {k: v.clone() for k, v in flat.items()}
        t = store.save_async(str(tmp_path), 4, flat)
        flat["params.w"].add_(1.0)
        t.join()
        assert _equal(store.load_flat(str(tmp_path), 4), want)

    def test_concurrent_nonblocking_saves_never_corrupt(self, tmp_path):
        """Six writers publishing the same step: one rename wins, the losers
        withdraw, and the published checkpoint is one writer's whole dict."""
        flats = [make_flat(seed=s) for s in range(6)]
        for t in [store.save(str(tmp_path), 7, f, blocking=False) for f in flats]:
            t.join()
        assert store.latest_step(str(tmp_path)) == 7
        restored = store.restore(str(tmp_path), 7, flats[0])
        assert sum(_equal(restored, f) for f in flats) == 1
        assert [d for d in os.listdir(tmp_path) if ".tmp" in d] == []

    def test_load_flat_roundtrip(self, tmp_path):
        flat = {
            "meta_seq": torch.tensor(12, dtype=torch.int64),
            "carried_000": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "env_140001234": torch.ones(4),
        }
        store.save(str(tmp_path), 12, flat)
        assert _equal(store.load_flat(str(tmp_path), 12), flat)

    def test_shape_mismatch_rejected(self, tmp_path):
        store.save(str(tmp_path), 1, make_flat())
        bad = make_flat()
        bad["params.w"] = torch.zeros(4, 4)
        with pytest.raises(ValueError, match="shape mismatch"):
            store.restore(str(tmp_path), 1, bad)

    def test_missing_leaf_rejected(self, tmp_path):
        store.save(str(tmp_path), 1, make_flat())
        with pytest.raises(KeyError, match="missing leaf"):
            store.restore(str(tmp_path), 1, {"nope": torch.zeros(1)})

    def test_restore_places_on_the_given_device_and_dtype(self, tmp_path):
        flat = make_flat()
        store.save(str(tmp_path), 2, flat)
        template = {"params.w": torch.zeros(8, 16, dtype=torch.float64)}
        out = store.restore(str(tmp_path), 2, template, device="cpu")
        assert out["params.w"].dtype == torch.float64
        assert torch.equal(out["params.w"], flat["params.w"].double())


class TestBfloat16:
    def test_bf16_roundtrip_is_bitwise(self, tmp_path):
        g = torch.Generator().manual_seed(3)
        x = (torch.randn(33, 17, generator=g) * 1e3).to(torch.bfloat16)
        x[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0])
        flat = {"w": x, "v": x[:, ::2]}           # a strided view too
        store.save(str(tmp_path), 1, flat)
        meta = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
        assert {m["dtype"] for m in meta["leaves"].values()} == {"bfloat16"}
        for back in (store.load_flat(str(tmp_path), 1), store.restore(str(tmp_path), 1, flat)):
            for k, v in flat.items():
                assert back[k].dtype == torch.bfloat16
                assert torch.equal(back[k].view(torch.int16), v.contiguous().view(torch.int16))


class TestCrossPackage:
    """The same layout and leaf names: each package reads the other's."""

    def test_reference_reads_a_port_checkpoint(self, tmp_path):
        flat = {"a": torch.randn(3, 5), "b": torch.arange(7, dtype=torch.int32)}
        store.save(str(tmp_path), 3, flat)
        assert jstore.latest_step(str(tmp_path)) == 3
        back = jstore.load_flat(str(tmp_path), 3)
        assert set(back) == set(flat)
        for k, v in flat.items():
            assert back[k].dtype == v.numpy().dtype
            np.testing.assert_array_equal(back[k], v.numpy())
        tree = jstore.restore(str(tmp_path), 3, {k: v.numpy() for k, v in flat.items()})
        for k, v in flat.items():
            np.testing.assert_array_equal(np.asarray(tree[k]), v.numpy())

    def test_port_reads_a_reference_checkpoint(self, tmp_path):
        rng = np.random.default_rng(0)
        flat = {"a": rng.normal(size=(4, 2)).astype(np.float32),
                "b": np.arange(5, dtype=np.int32)}
        jstore.save(str(tmp_path), 8, flat)
        assert store.latest_step(str(tmp_path)) == 8
        back = store.load_flat(str(tmp_path), 8)
        template = {k: torch.from_numpy(v) for k, v in flat.items()}
        assert _equal(back, template)
        assert _equal(store.restore(str(tmp_path), 8, template), template)
