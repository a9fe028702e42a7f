"""The port's kernels: each plain PyTorch version against the JAX package's
Pallas kernel in interpret mode (and its ref.py), at the shapes of
tests/test_kernels.py plus ragged ones; the CPU custom ops go to the plain
versions and trace as one operator; the CUDA wrappers raise on what they do
not take.  Holding each CUDA kernel against its plain version needs the card
(``requires_cuda``)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro_torch.kernels import library  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    SPLIT_LEN,
    decode_attention,
    decode_attention_cuda,
    decode_attention_ref,
    decode_attention_split_ref,
    split_plan,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_chunked,
    attention_dense,
    flash_attention,
    flash_attention_cuda,
    packed_row,
    tile_plan,
)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm,
    rmsnorm_cuda,
    rmsnorm_plan,
    rmsnorm_ref,
)

TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_kernels.py, f32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py, bf16


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernels (imported here, not at module level, so the
    card-only test below also runs where JAX is not installed)."""
    pytest.importorskip("jax")
    from repro.kernels import decode_attention, flash_attention, rmsnorm

    return dict(
        rmsnorm=rmsnorm.rmsnorm, decode=decode_attention.decode_attention,
        decode_ref=decode_attention.decode_attention_ref,
        flash=flash_attention.flash_attention, dense=flash_attention.attention_dense,
    )


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


class TestRMSNorm:
    @pytest.mark.parametrize(
        "shape,offset",
        [((4, 128, 256), 0.0), ((2, 64, 512), 1.0), ((3, 7, 96), 0.0), ((5, 13, 130), 0.0)],
    )
    def test_plain_vs_pallas(self, jref, rng, shape, offset):
        x = rng.normal(0, 1, shape).astype(np.float32)
        s = rng.normal(0, 0.1, shape[-1:]).astype(np.float32)
        ref = np.asarray(jref["rmsnorm"](x, s, offset=offset, interpret=True))
        out = rmsnorm_ref(_t(x), _t(s), 1e-6, offset).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

    def test_bf16(self, jref, rng):
        import jax.numpy as jnp

        x = rng.normal(0, 1, (4, 96)).astype(np.float32)
        s = rng.normal(0, 0.1, (96,)).astype(np.float32)
        ref = jref["rmsnorm"](
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16), interpret=True
        )
        out = rmsnorm_ref(_t(x, torch.bfloat16), _t(s, torch.bfloat16))
        np.testing.assert_allclose(
            out.float().numpy(), np.asarray(ref, np.float32), **BF16_TOL
        )

    def test_cpu_op_is_the_plain_version(self, rng):
        x = _t(rng.normal(0, 1, (3, 5, 64)))
        s = _t(rng.normal(0, 0.1, (64,)))
        assert torch.equal(rmsnorm(x, s, offset=1.0), rmsnorm_ref(x, s, 1e-6, 1.0))


class TestRMSNormPlan:
    """The launch of each served shape (qwen3: d_model 1024 and the qk-norm
    rows of 128; zamba2: d_model 2048 and the gated norm's d_inner 4096; one
    decode row, the 32-token prefill and the stateless bucket's 64 rows) and
    of the odd ones."""

    @pytest.mark.parametrize(
        "rows,d,plan",
        [
            (1, 1024, ("warp", 32, 1, 1)),      # qwen3's norms at decode
            (16, 128, ("warp", 128, 4, 4)),     # q-norm: 16 heads
            (8, 128, ("warp", 128, 4, 2)),      # k-norm: 8 KV heads
            (32, 1024, ("warp", 128, 4, 8)),    # qwen3's prefill
            (1, 2048, ("block", 128, 1, 1)),    # zamba2's norms at decode: 2 vectors a thread
            (1, 4096, ("block", 256, 1, 1)),    # zamba2's gated norm
            (64, 2048, ("block", 128, 1, 64)),  # the stateless bucket
            (64, 4096, ("block", 256, 1, 64)),
            (21, 96, ("warp", 128, 4, 6)),      # (3, 7, 96): 12 vectors on 32 lanes
            (65, 130, ("scalar", 160, 1, 65)),  # no multiple of the vector
        ],
    )
    def test_bf16(self, rows, d, plan):
        got = rmsnorm_plan(rows, d, torch.bfloat16)
        assert (got["route"], got["threads"], got["rows_per_block"], got["grid"]) == plan

    def test_f32_takes_four_per_vector(self):
        # a 16-byte vector holds 4 f32 against 8 bf16: twice the threads per row
        assert rmsnorm_plan(1, 2048, torch.float32)["threads"] == 256
        assert rmsnorm_plan(1, 4096, torch.float32)["threads"] == 512
        assert rmsnorm_plan(1, 1024, torch.float32)["route"] == "warp"
        # 130 and 98 are no multiple of 4 (f32) or 8 (bf16); 100 is one of 4 only
        assert rmsnorm_plan(3, 100, torch.float32)["route"] == "warp"
        assert rmsnorm_plan(3, 100, torch.bfloat16)["route"] == "scalar"
        with pytest.raises(TypeError):
            rmsnorm_plan(1, 1024, torch.float16)

    def test_unaligned_and_long_rows_take_the_scalar_route(self):
        assert rmsnorm_plan(1, 1024, torch.bfloat16, aligned=False)["route"] == "scalar"
        # more than 4 vectors a thread at 512 threads
        assert rmsnorm_plan(1, 4 * 512 * 8, torch.bfloat16)["route"] == "block"
        assert rmsnorm_plan(1, 4 * 512 * 8 + 8, torch.bfloat16)["route"] == "scalar"


class TestDecodeAttention:
    @pytest.mark.parametrize(
        "b,s,hq,hkv,d,window",
        [
            (2, 1024, 8, 2, 64, None),
            (1, 2048, 16, 8, 128, None),
            (2, 1024, 4, 4, 64, 256),
            (1, 512, 8, 1, 64, None),
            (3, 512, 40, 40, 64, None),     # MHA-style
            (2, 333, 16, 8, 128, 50),       # ragged cache, window
        ],
    )
    def test_plain_vs_pallas(self, jref, rng, b, s, hq, hkv, d, window):
        q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
        kc = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
        vc = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
        kv_len = (np.arange(b) * 97 % (s - 8) + 8).astype(np.int32)
        ref = np.asarray(jref["decode"](q, kc, vc, kv_len, window=window, interpret=True))
        np.testing.assert_allclose(
            np.asarray(jref["decode_ref"](q, kc, vc, kv_len, window=window)), ref, **TOL
        )
        out = decode_attention_ref(_t(q), _t(kc), _t(vc), _t(kv_len, torch.int32),
                                   window=window)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    @pytest.mark.parametrize(
        "b,s,hq,hkv,d,lens,window,split",
        [
            (2, 256, 8, 8, 32, [256, 1], None, 64),      # kv_len S and 1, rep 1
            (1, 512, 16, 8, 64, [63], None, 64),         # the served cache in 64s: 7 empty splits
            (1, 1024, 16, 8, 64, [1000], None, SPLIT_LEN),   # the kernel's split length
            (2, 320, 8, 2, 32, [300, 100], 70, 32),      # rep 4, window edge inside a split
            (1, 256, 16, 2, 32, [200], 40, 16),          # rep 8, splits empty before the window
            (2, 512, 12, 4, 64, [512, 77], None, 128),   # rep 3
            (1, 100, 4, 2, 32, [100], None, 48),         # S not a multiple of the split
        ],
    )
    def test_split_ref_vs_pallas(self, jref, rng, b, s, hq, hkv, d, lens, window, split):
        """The split-KV kernel's arithmetic (per-split m, l, acc, merged in
        split order) against the Pallas kernel in interpret mode."""
        q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
        kc = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
        vc = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
        kv_len = np.asarray(lens, np.int32)
        ref = np.asarray(jref["decode"](q, kc, vc, kv_len, window=window, interpret=True))
        out = decode_attention_split_ref(_t(q), _t(kc), _t(vc), _t(kv_len, torch.int32),
                                         window, split)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    @pytest.mark.parametrize(
        "s,split_len,n_split",
        [(512, SPLIT_LEN, 1), (128, SPLIT_LEN, 1), (16384, SPLIT_LEN, 32), (1, SPLIT_LEN, 1),
         (513, SPLIT_LEN, 2), (64, 64, 1), (65, 64, 2), (100, 32, 4), (16384, 64, 256)],
    )
    def test_split_plan(self, s, split_len, n_split):
        """The grid's split count comes from the cache length S alone: the
        served caches (512 and 128 positions) are one split, so the step is
        one launch with no merge."""
        assert SPLIT_LEN == 512
        assert split_plan(s, split_len) == (split_len, n_split)

    def test_cpu_op_is_the_plain_version(self, rng):
        q = _t(rng.normal(0, 1, (2, 4, 32)))
        kc = _t(rng.normal(0, 1, (2, 20, 2, 32)))
        kv_len = torch.tensor([3, 20], dtype=torch.int32)
        assert torch.equal(
            decode_attention(q, kc, kc, kv_len, window=5),
            decode_attention_ref(q, kc, kc, kv_len, window=5),
        )


class TestFlashAttention:
    @pytest.mark.parametrize(
        "b,sq,sk,hq,hkv,d,causal,window",
        [
            (2, 128, 128, 4, 2, 64, True, None),
            (1, 256, 256, 8, 8, 128, True, 128),
            (1, 128, 384, 4, 1, 64, True, None),
            (2, 128, 128, 4, 4, 64, False, None),
            (1, 256, 256, 2, 2, 128, True, None),
        ],
    )
    def test_plain_vs_pallas(self, jref, rng, b, sq, sk, hq, hkv, d, causal, window):
        q = rng.normal(0, 1, (b, sq, hq, d)).astype(np.float32)
        k = rng.normal(0, 1, (b, sk, hkv, d)).astype(np.float32)
        v = rng.normal(0, 1, (b, sk, hkv, d)).astype(np.float32)
        kw = dict(causal=causal, window=window, q_offset=sk - sq)
        ref = np.asarray(jref["flash"](q, k, v, interpret=True, **kw))
        for fn in (attention_chunked, attention_dense):
            out = fn(_t(q), _t(k), _t(v), **kw)
            np.testing.assert_allclose(out.numpy(), ref, **TOL)

    @pytest.mark.parametrize(
        "sq,sk,q_offset,window,cap",
        [(45, 77, 32, 16, 30.0), (7, 1100, 1093, None, None), (33, 33, 0, None, 5.0)],
    )
    def test_ragged_plain_vs_reference(self, jref, rng, sq, sk, q_offset, window, cap):
        """Lengths the Pallas kernel's 128 tiling refuses: the port's plain
        versions against the JAX package's dense reference."""
        q = rng.normal(0, 1, (2, sq, 4, 32)).astype(np.float32)
        k = rng.normal(0, 1, (2, sk, 2, 32)).astype(np.float32)
        v = rng.normal(0, 1, (2, sk, 2, 32)).astype(np.float32)
        kw = dict(causal=True, window=window, logit_cap=cap, q_offset=q_offset)
        ref = np.asarray(jref["dense"](q, k, v, **kw))
        for fn in (attention_chunked, attention_dense):
            np.testing.assert_allclose(fn(_t(q), _t(k), _t(v), **kw).numpy(), ref, **TOL)

    def test_bf16(self, jref, rng):
        import jax.numpy as jnp

        q = rng.normal(0, 1, (1, 128, 4, 64)).astype(np.float32)
        k = rng.normal(0, 1, (1, 128, 2, 64)).astype(np.float32)
        v = rng.normal(0, 1, (1, 128, 2, 64)).astype(np.float32)
        ref = jref["flash"](
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), interpret=True
        )
        out = flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)))
        np.testing.assert_allclose(
            out.float().numpy(), np.asarray(ref, np.float32), **BF16_TOL
        )


class TestFlashTilePlan:
    """The wgmma route's packed rows and grid, and the route by dtype."""

    @pytest.mark.parametrize(
        "b,sq,hq,hkv,rows,grid",
        [
            (1, 32, 16, 8, 64, (1, 8, 1)),      # qwen3's prefill: one tile per KV head
            (1, 64, 32, 32, 64, (1, 32, 1)),    # zamba2's stateless bucket: one per head
            (1, 16, 32, 32, 16, (1, 32, 1)),    # zamba2's prefill: 48 masked rows
            (1, 512, 16, 8, 1024, (16, 8, 1)),  # the long prefill
            (2, 45, 16, 4, 180, (3, 4, 2)),     # rep 4, a ragged last tile of 52 rows
            (1, 30, 16, 2, 240, (4, 2, 1)),     # rep 8
        ],
    )
    def test_bf16_takes_wgmma(self, b, sq, hq, hkv, rows, grid):
        assert tile_plan(b, sq, hq, hkv, torch.bfloat16) == dict(
            route="wgmma", rows=rows, grid=grid)

    def test_f32_takes_the_cuda_cores(self):
        assert tile_plan(2, 45, 16, 4, torch.float32) == dict(
            route="cuda_cores", rows=45, grid=(3, 32))
        with pytest.raises(TypeError):
            tile_plan(1, 32, 16, 8, torch.float16)

    @pytest.mark.parametrize("sq,n_rep", [(32, 2), (45, 4), (30, 8), (16, 1)])
    def test_packed_rows_cover_each_query_head_once(self, sq, n_rep):
        pairs = [packed_row(p, n_rep) for p in range(sq * n_rep)]
        assert sorted(pairs) == [(i, r) for i in range(sq) for r in range(n_rep)]
        # the heads of one query are neighbouring rows, so a row's query is p // n_rep
        assert all(i == p // n_rep for p, (i, _) in enumerate(pairs))


def test_custom_ops_trace_as_one_node(rng):
    """make_fx keeps each kernel as a single graph node, as one pallas_call
    is one jaxpr equation."""
    x = _t(rng.normal(0, 1, (1, 4, 2, 32)))
    kv_len = torch.tensor([4], dtype=torch.int32)

    def app(x, kv_len):
        h = rmsnorm(x, x[0, 0, 0])
        a = flash_attention(h, h, h)
        return decode_attention(a[:, 0], h, h, kv_len)

    gm = make_fx(app, tracing_mode="fake")(x, kv_len)
    targets = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    for name in ("rmsnorm", "flash_attention", "decode_attention"):
        assert targets.count(f"repro_torch.{name}.default") == 1


def test_cpu_ops_return_the_strides_of_their_fakes(rng):
    """A traced graph reshapes a kernel's output with ``aten.view`` when the
    fake output is contiguous, so the CPU op must return a contiguous tensor
    too (the plain chunked attention computes in (B,H,S,D) order; replaying a
    prefill failed on its transposed output before)."""
    q = _t(rng.normal(0, 1, (1, 32, 4, 16)))
    kv_len = torch.tensor([4], dtype=torch.int32)
    outs = [
        flash_attention(q, q, q),
        flash_attention(q, q[:, :20], q[:, :20], causal=False),
        decode_attention(q[:, 0], q, q, kv_len),
        rmsnorm(q, q[0, 0, 0]),
    ]
    assert all(o.is_contiguous() for o in outs)

    def app(q):
        return flash_attention(q, q, q).reshape(1, 32, -1)

    gm = make_fx(app, tracing_mode="fake")(q)
    assert "aten.view.default" in [str(n.target) for n in gm.graph.nodes]
    torch.testing.assert_close(gm(q), app(q))


class TestCudaWrappersRaise:
    """On a CUDA tensor a wrapper launches its kernel or raises; the checks
    run before any device call, so they are exercised here on CPU tensors."""

    def test_rmsnorm(self):
        with pytest.raises(TypeError):
            rmsnorm_cuda(torch.zeros(2, 8), torch.zeros(8, dtype=torch.bfloat16), 1e-6, 0.0)
        with pytest.raises(ValueError):
            rmsnorm_cuda(torch.zeros(8, 2).t(), torch.zeros(8), 1e-6, 0.0)

    def test_decode_attention(self):
        q = torch.zeros(1, 16, 64)
        kv = torch.zeros(1, 8, 1, 64)
        with pytest.raises(ValueError):   # 16 query heads on 1 KV head > 8
            decode_attention_cuda(q, kv, kv, torch.ones(1, dtype=torch.int32), None)
        with pytest.raises(TypeError):
            decode_attention_cuda(q, torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 64),
                                  torch.ones(1, dtype=torch.int64), None)

        with pytest.raises(ValueError):   # 16-byte vector loads need 16-byte alignment
            qm = torch.zeros(16 * 64 + 1)[1:].view(1, 16, 64)
            kv = torch.zeros(1, 8, 8, 64)
            decode_attention_cuda(qm, kv, kv, torch.ones(1, dtype=torch.int32), None)
        with pytest.raises(ValueError):   # no split length of 0
            decode_attention_cuda(q, kv, kv, torch.ones(1, dtype=torch.int32), None, 0)

    def test_flash_attention(self):
        q = torch.zeros(1, 4, 2, 16)       # head dim 16 is not taken
        with pytest.raises(ValueError):
            flash_attention_cuda(q, q, q, True, None, None, 0)
        with pytest.raises(TypeError):
            library.dtype_code(torch.float16)
        # the wgmma route copies 16-byte vectors: a misaligned bf16 view raises
        qm = torch.zeros(4 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 4, 2, 64)
        with pytest.raises(ValueError):
            flash_attention_cuda(qm, qm, qm, True, None, None, 0)


def test_library_name_hashes_every_csrc_file_and_the_flags(tmp_path, monkeypatch):
    """A built library is named by the hash of all of its kernel's csrc/
    files and the nvcc flags: an edited header, or another flag, rebuilds."""
    csrc = tmp_path / "k" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("constexpr int kTile = 64;\n")
    monkeypatch.setattr(library, "source_path", lambda name: csrc / f"{name}.cu")
    first = library._library_path("k")
    assert first == library._library_path("k")       # unchanged sources are reused
    (csrc / "k.cuh").write_text("constexpr int kTile = 32;\n")
    edited = library._library_path("k")
    assert edited != first
    monkeypatch.setattr(library, "NVCC_FLAGS", library.NVCC_FLAGS + ("-lineinfo",))
    assert library._library_path("k") != edited
    assert edited.parent == library.BUILD_DIR and edited.name.startswith("libk-")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(rng, dtype):
    """Each CUDA kernel against its plain version on the card, at a served
    decode shape and a ragged one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    dt = getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4

    def r(*shape):
        return _t(rng.normal(0, 1, shape), dt).cuda()

    x, w = r(3, 7, 96), r(96)
    torch.testing.assert_close(rmsnorm(x, w), rmsnorm_ref(x, w), rtol=tol, atol=tol)
    # each route: warp (served 1024 and 128), block (2048, 4096, many rows),
    # scalar (130; an unaligned view of a row of 1024)
    for shape in [(1, 1024), (16, 128), (1, 2048), (64, 4096), (5, 130)]:
        x, w = r(*shape), r(shape[-1])
        torch.testing.assert_close(rmsnorm(x, w, offset=1.0), rmsnorm_ref(x, w, 1e-6, 1.0),
                                   rtol=tol, atol=tol)
    x, w = r(2 * 1024 + 1)[1:].view(2, 1024), r(1024)
    torch.testing.assert_close(rmsnorm(x, w), rmsnorm_ref(x, w), rtol=tol, atol=tol)
    q, kc, vc = r(1, 16, 128), r(1, 512, 8, 128), r(1, 512, 8, 128)
    kv_len = torch.tensor([63], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(decode_attention(q, kc, vc, kv_len),
                               decode_attention_ref(q, kc, vc, kv_len), rtol=tol, atol=tol)
    # many splits, some wholly masked, a window edge inside a split, rep 4
    q, kc, vc = r(2, 32, 64), r(2, 1000, 8, 64), r(2, 1000, 8, 64)
    kv_len = torch.tensor([900, 1], dtype=torch.int32, device="cuda")
    for window in (None, 100):
        torch.testing.assert_close(decode_attention(q, kc, vc, kv_len, window=window),
                                   decode_attention_ref(q, kc, vc, kv_len, window=window),
                                   rtol=tol, atol=tol)
    q, k, v = r(2, 45, 4, 64), r(2, 77, 2, 64), r(2, 77, 2, 64)
    kw = dict(q_offset=32, window=16, logit_cap=30.0)
    torch.testing.assert_close(flash_attention(q, k, v, **kw), attention_dense(q, k, v, **kw),
                               rtol=tol, atol=tol)
    # packed GQA rows (rep 4) over two tiles, the last one ragged
    q, k, v = r(1, 45, 16, 128), r(1, 45, 4, 128), r(1, 45, 4, 128)
    torch.testing.assert_close(flash_attention(q, k, v), attention_dense(q, k, v),
                               rtol=tol, atol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,hkv,causal",
                         [(1, 64, 64, 40, 40, True), (1, 16, 16, 40, 40, True),
                          (2, 77, 77, 8, 8, True), (1, 50, 70, 8, 4, False)])
def test_flash_d96_matches_plain_on_card(rng, dtype, b, sq, sk, h, hkv, causal):
    """MLA's head dim 96 (wgmma with rows padded to two 64-column atoms, the
    CUDA cores) against the plain version: minicpm3-4b's bucket and prefill,
    a ragged sequence, a non-causal one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m requires_cuda tests/")
    dt = getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    q = _t(rng.normal(0, 1, (b, sq, h, 96)), dt).cuda()
    k, v = (_t(rng.normal(0, 1, (b, sk, hkv, 96)), dt).cuda() for _ in range(2))
    out = flash_attention(q, k, v, causal=causal)
    ref = attention_dense(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
