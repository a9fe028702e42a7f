"""``repro_torch.launch.graph_analysis`` (the counterpart of
``repro.launch.hlo_analysis``).

The first four cases are the counterparts of ``tests/test_hlo_analysis.py``'s:
flops that scale with the number of layers, a looped model equal to the
same layers written out, a traced collective that is counted, and the
graph's structure.  Then the custom ops' flop rules, the launches a traced
step predicts against the custom-op calls of the same step run eagerly, the
eager-lifetime liveness on programs whose peak is known, and its peak on
fake tensors against a real CPU step.  The dry run's extrapolation of
the sLSTM's time loop is in ``test_torch_dryrun_extrapolation.py``.
"""
from __future__ import annotations

import collections

import pytest
import torch
import torch.distributed as dist
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.graph_analysis import (
    KERNEL_FLOPS,
    alias_bytes,
    analyze_graph,
    final_state_dots,
    measure_step,
    needed_nodes,
    op_nodes,
    scan_dot_flops,
)
from repro_torch.training.data import DataConfig, synth_batch
from repro_torch.training.step import batch_to_device, init_train_state, make_train_step


def _trace(fn, *args):
    return make_fx(fn, tracing_mode="fake")(*args)


# ---------------------------------------------------------------------------
# the counterparts of tests/test_hlo_analysis.py
# ---------------------------------------------------------------------------

def test_flops_scale_with_the_number_of_layers():
    d = 64
    x = torch.ones(8, d)
    for layers in (3, 12):
        w = torch.ones(layers, d, d) * 0.01

        def stack(x, w):
            for i in range(w.shape[0]):
                x = torch.tanh(x @ w[i])
            return x

        a = analyze_graph(_trace(stack, x, w))
        assert a["dot_flops"] == 2 * 8 * d * d * layers
        assert a["transcendentals"] == 8 * d * layers


def test_looped_model_equals_the_same_layers_written_out():
    d, layers = 32, 6
    w = torch.ones(layers, d, d) * 0.01
    x = torch.ones(4, d)

    def looped(x, w):
        for i in range(layers):
            x = x @ w[i]
        return x

    def written_out(x, w):
        x = x @ w[0]
        x = x @ w[1]
        x = x @ w[2]
        x = x @ w[3]
        x = x @ w[4]
        return x @ w[5]

    a, b = analyze_graph(_trace(looped, x, w)), analyze_graph(_trace(written_out, x, w))
    assert a == b
    assert a["dot_flops"] == 2 * 4 * d * d * layers


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_traced_collective_is_counted(one_rank):
    import torch.distributed._functional_collectives as funcol

    def functional(v):
        return funcol.all_reduce(v, "sum", dist.group.WORLD)

    def in_place(v):
        v = v.clone()
        dist.all_reduce(v)
        return v

    for fn in (functional, in_place):
        a = analyze_graph(_trace(fn, torch.ones(128)))
        assert a["collective_counts"] == {"all-reduce": 1}
        assert a["collective_bytes"] == a["collective_bytes_by_kind"]["all-reduce"] >= 128 * 4


def test_graph_structure():
    gm = _trace(lambda x: torch.tanh(x) @ x.T, torch.ones(8, 8))
    nodes = op_nodes(gm)
    assert [str(n.target) for n in nodes] == ["aten.tanh.default", "aten.permute.default",
                                              "aten.mm.default"]
    a = analyze_graph(gm)
    assert a["n_nodes"] == 3
    assert a["dot_flops"] == 2 * 8 * 8 * 8
    # tanh writes 64 elements; the transpose is a view and moves nothing
    assert a["flops"] == 4 * 64 + 2 * 8 * 8 * 8
    assert a["hbm_bytes"] == 4 * (64 + 64) + 4 * (3 * 64)


# ---------------------------------------------------------------------------
# the custom ops' rules
# ---------------------------------------------------------------------------

def test_kernel_flop_rules():
    f32 = torch.float32
    q, k = ((2, 48, 8, 16), f32), ((2, 80, 2, 16), f32)
    flops, dots = KERNEL_FLOPS["flash_attention_backward"]([q, q, k, k, q, True, None, None, 0],
                                                           [q, k, k])
    assert dots == 8 * 2 * 8 * 48 * 80 * 16 and flops > dots
    flops, dots = KERNEL_FLOPS["rmsnorm_backward"]([((6, 32), f32), ((6, 32), f32),
                                                    ((32,), f32), 1e-6, 0.0], [])
    assert (flops, dots) == (11 * 6 * 32, 0.0)
    # the chunked scan: ref.py's four einsums over each chunk
    b, s, h, p, n, chunk = 2, 96, 4, 8, 16, 32
    x, bm = ((b, s, h, p), f32), ((b, s, 1, n), f32)
    fwd = KERNEL_FLOPS["gated_scan"]([x, x[:1], x[:1], bm, bm, None, None, chunk], [])[1]
    nc = s // chunk
    assert fwd == scan_dot_flops(x[0], bm[0], chunk) == (
        2 * b * nc * chunk * chunk * h * n + 2 * b * nc * chunk * chunk * h * p
        + 2 * 2 * b * nc * chunk * h * n * p)
    bwd = KERNEL_FLOPS["gated_scan_backward"]([x, None, x, x[:1], x[:1], bm, bm, None, None,
                                               chunk], [])[1]
    assert bwd == 2 * fwd
    # a depthwise conv's two gradients: C_out / groups x K products an
    # input element, batch x output positions a weight element
    g, xin, w = ((3, 10, 20), f32), ((3, 10, 23), f32), ((10, 1, 4), f32)
    dots = KERNEL_FLOPS["convolution_backward"](
        [g, xin, w, [0], [1], [0], [1], False, [0], 10, [True, True, False]], [])[1]
    assert dots == 2 * 3 * 10 * 23 * 4 + 2 * 10 * 4 * (3 * 20)


@pytest.mark.parametrize("s", [16, 96])
def test_single_chunk_scan_counts_its_final_state_when_read(s):
    """At a single chunk B^T x only makes the final state: it counts when an
    op reads the final state or the step returns it, as the reference's XLA
    keeps it then; the backward counts none of its two products without a
    cotangent on the final state.  Beyond one chunk every product counts.
    The trace's metered pass and the graph walk agree."""
    from repro_torch.kernels.ssm_scan import gated_scan

    b, h, p, n, chunk = 2, 4, 8, 16, 32 if s > 32 else 128
    x, bm = torch.ones(b, s, h, p), torch.ones(b, s, 1, n)
    ld, gi = torch.zeros(b, s, h), torch.ones(b, s, h)
    late = final_state_dots(tuple(x.shape), tuple(bm.shape), chunk)
    assert (late > 0) == (s <= chunk)
    full = scan_dot_flops(tuple(x.shape), tuple(bm.shape), chunk)

    def y_only(x, ld, gi, bm):
        return gated_scan(x, ld, gi, bm, bm, chunk=chunk)[0]

    def h_read(x, ld, gi, bm):
        y, hf = gated_scan(x, ld, gi, bm, bm, chunk=chunk)
        return y.sum() + hf.sum()

    def h_returned(x, ld, gi, bm):
        return gated_scan(x, ld, gi, bm, bm, chunk=chunk)

    args = (x, ld, gi, bm)
    for fn, dots in ((y_only, full - late), (h_read, full), (h_returned, full)):
        assert analyze_graph(_trace(fn, *args))["dot_flops"] == dots
        assert measure_step(fn, args)["cost"]["dot_flops"] == dots
    f32 = torch.float32
    xa, ba = (tuple(x.shape), f32), (tuple(bm.shape), f32)
    bwd = KERNEL_FLOPS["gated_scan_backward"]([xa, None, xa, xa, xa, ba, ba, None, None,
                                               chunk], [])[1]
    with_dh = KERNEL_FLOPS["gated_scan_backward"]([xa, xa, xa, xa, xa, ba, ba, None, None,
                                                   chunk], [])[1]
    assert (bwd, with_dh) == (2 * (full - late), 2 * full)


class OpCalls(TorchDispatchMode):
    """Counts each repro_torch custom op called, as a wrapper call."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.calls[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


LAUNCH_CASES = {
    "qwen3-0.6b": {},
    "zamba2-1.2b": {"n_layers": 5, "attn_every": 2},
    "xlstm-1.3b": {"n_layers": 2, "ssm_chunk": 16},
}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", sorted(LAUNCH_CASES))
def test_traced_launches_equal_an_eager_steps_op_calls(arch, remat):
    cfg = get_reduced_config(arch, **LAUNCH_CASES[arch])
    shape = ShapeConfig("t", 48, 2, "train")
    tr = dryrun.trace_step(cfg, shape, "cpu", remat=remat)
    predicted = analyze_graph(tr.gm)["launches"]
    params, opt = init_train_state(cfg, 0, "cpu")
    nb = synth_batch(cfg, shape, 0, DataConfig())
    with OpCalls() as mode:
        make_train_step(cfg, remat=remat)(params, opt, nb)
    names = {"gated_scan": "ssm_scan", "gated_scan_backward": "ssm_scan_backward"}
    assert predicted == {names.get(k, k): v for k, v in sorted(mode.calls.items())}
    assert predicted


METER_CASES = {
    "qwen3 train": ("qwen3-0.6b", {}, "train"),
    "xlstm train": ("xlstm-1.3b", {"n_layers": 3, "slstm_every": 3, "ssm_chunk": 16}, "train"),
    # one scan chunk a sequence (48 steps, chunk 64), its forward recomputed
    # in the backward: only there does B^T x of the unread final state count
    "xlstm train one chunk": ("xlstm-1.3b", {"n_layers": 3, "slstm_every": 3, "ssm_chunk": 64},
                              "train"),
    "mixtral prefill": ("mixtral-8x7b", {}, "prefill"),
    "zamba2 decode": ("zamba2-1.2b", {"n_layers": 5, "attn_every": 2}, "decode"),
}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", sorted(METER_CASES))
def test_the_meter_counts_what_the_trace_records(name):
    """The meter run inside the trace counts exactly what
    ``analyze_graph`` counts on the graph, and run with no trace (as the
    dry run's extrapolation runs it) the same, with the same liveness."""
    arch, kw, kind = METER_CASES[name]
    cfg = get_reduced_config(arch, **kw)
    shape = ShapeConfig(kind, 48, 2, kind)
    tr = dryrun.trace_step(cfg, shape, "cpu")
    assert tr.metered["cost"] == analyze_graph(tr.gm)
    assert tr.metered["cost"]["n_nodes"] == len(op_nodes(tr.gm))
    untraced = dryrun.measure(cfg, shape, "cpu")
    assert untraced["cost"] == tr.metered["cost"]
    assert untraced["liveness"] == tr.metered["liveness"]


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

def test_liveness_frees_after_the_last_use_and_keeps_arguments():
    x = torch.ones(1024)          # 4 KiB an f32 buffer of this size

    def chain(x):
        # no name holds a temporary: each dies with its last reader
        return torch.tanh((x * 2 + 1).view(32, 32)).sum()

    live = measure_step(chain, (x,))["liveness"]
    kib = 4096
    assert live["argument_bytes"] == kib
    # at the add: x, x * 2 and the sum (the view keeps the sum's buffer,
    # the tanh comes after x * 2 is freed)
    assert live["peak_bytes"] == 3 * kib
    assert live["temp_bytes"] == 2 * kib
    assert live["peak_op"] == "aten.add.Tensor"
    assert sorted(t["name"] for t in live["top_buffers"]) == [
        "argument", "aten.add.Tensor", "aten.mul.Tensor"]
    assert all(t["bytes"] == kib for t in live["top_buffers"])


def test_liveness_holds_a_buffer_read_late():
    x = torch.ones(256)

    def late(x):
        a = x * 3
        c = torch.sin(torch.exp(x))
        return c + a              # a lives until here

    live = measure_step(late, (x,))["liveness"]
    # x, a, exp(x) and its sine: 1 KiB each; exp(x) is freed before the add
    assert live["peak_bytes"] == 4 * 1024
    assert live["peak_op"] == "aten.sin.default"


def test_a_python_variable_holds_its_buffer_past_its_last_use():
    x = torch.ones(256)

    def held(x):
        a = x * 3                 # held by its name to the return
        b = torch.exp(a)
        c = torch.sin(b)          # the last use of b, which stays alive
        return torch.cos(c)

    # x, a, b, c and the cosine: 1 KiB each
    assert measure_step(held, (x,))["liveness"]["peak_bytes"] == 5 * 1024


def test_in_place_updates_are_aliases_and_dead_views_are_not_needed():
    m, g = torch.zeros(64), torch.ones(64)

    def update(m, g, unused):
        m.mul_(0.9).add_(g)
        unused[0]                 # a dead read
        return m.sum()

    gm = _trace(update, m, g, torch.ones(64))
    assert alias_bytes(gm) == 64 * 4
    live = measure_step(update, (m.clone(), g, torch.ones(64)))["liveness"]
    # m, g and unused alive throughout; the in-place ops make no buffer
    assert live["argument_bytes"] == 3 * 64 * 4
    assert live["peak_bytes"] == 3 * 64 * 4 + 4
    needed = needed_nodes(gm)
    holders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    assert [any(u in needed for u in h.users) for h in holders] == [True, True, False]


def test_train_step_aliases_params_and_moments():
    cfg = get_reduced_config("qwen3-0.6b")
    tr = dryrun.trace_step(cfg, ShapeConfig("t", 32, 2, "train"), "cpu")
    params, opt, _ = tr.inputs
    leaves = [t for t in _tree_leaves(params) + _tree_leaves(opt["m"]) + _tree_leaves(opt["v"])]
    assert alias_bytes(tr.gm) == sum(t.numel() * t.element_size() for t in leaves)
    live = tr.metered["liveness"]
    assert live["peak_bytes"] > live["argument_bytes"] > alias_bytes(tr.gm)
    assert len(live["top_buffers"]) == 10
    sizes = [t["bytes"] for t in live["top_buffers"]]
    assert sizes == sorted(sizes, reverse=True)


EAGER_CASES = {
    # activations dominate
    "qwen3": ("qwen3-0.6b", {}, (128, 4)),
    "zamba2": ("zamba2-1.2b", {"n_layers": 5, "attn_every": 2}, (128, 4)),
    # the MoE backward: autograd holds a node's saved tensors to its end
    "mixtral": ("mixtral-8x7b", {}, (128, 4)),
    # the weights dominate: the peak is in AdamW, where Python holds every
    # gradient and the last leaf's f32 temporaries
    "qwen3_wide": ("qwen3-0.6b", {"d_model": 256, "d_ff": 512, "vocab": 32000}, (32, 2)),
}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", sorted(EAGER_CASES))
def test_eager_liveness_on_fake_tensors_equals_a_real_cpu_step(name):
    """The liveness a trace takes of its step equals ``measure_step``'s of
    the same step run on real CPU tensors."""
    arch, kw, (seq, batch) = EAGER_CASES[name]
    cfg = get_reduced_config(arch, **kw)
    shape = ShapeConfig("t", seq, batch, "train")
    # taken in the trace's own pass, on fake tensors
    tr = dryrun.trace_step(cfg, shape, "cpu")
    fake = tr.metered["liveness"]
    params, opt = init_train_state(cfg, 0, "cpu")
    nb = batch_to_device(synth_batch(cfg, shape, 0, DataConfig()), "cpu")
    real = measure_step(make_train_step(cfg), (params, opt, nb))["liveness"]
    assert fake == real
    assert fake["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in _tree_leaves(list(tr.inputs)))
    if name == "qwen3_wide":
        assert fake["peak_op"] == "aten.sqrt.default"
    else:
        assert fake["peak_bytes"] > fake["argument_bytes"]


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]
