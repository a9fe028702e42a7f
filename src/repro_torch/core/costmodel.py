"""Analytic per-operator cost model: FLOPs + memory bytes per aten graph node,
and the throughput specs of the simulated MEC endpoints.

``GTX_2080TI`` (the GPU server) and ``JETSON_XAVIER_NX`` (the mobile client)
are simulation constants of the paper's testbed, the same as in the JAX
package: they drive the simulated clock and energy meter, and are no
measurement of the card this port runs on.  ``node_flops``/``node_bytes``
take the place of the reference's ``eqn_flops``/``eqn_bytes`` (which read
jaxpr equations).
"""
from __future__ import annotations

import dataclasses
from functools import reduce
from operator import mul
from typing import Sequence, Tuple

Aval = Tuple[Tuple[int, ...], object]   # (shape, torch.dtype)

_TRANSCENDENTAL = {
    "exp", "log", "tanh", "sigmoid", "silu", "rsqrt", "sqrt", "sin", "cos",
    "pow", "reciprocal", "erf",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "max_pool2d_with_indices",   # a windowed max, like the reference's reduce_window_max
}


def _size(shape) -> int:
    return int(reduce(mul, shape, 1))


def aval_nbytes(aval: Aval) -> int:
    shape, dtype = aval
    return _size(shape) * dtype.itemsize


def node_flops(
    op_name: str, in_avals: Sequence[Aval], out_avals: Sequence[Aval], is_view: bool
) -> float:
    """FLOPs estimate for one aten node (products, convolutions and the
    attention kernels get exact counts, everything else ~1 flop per output
    element)."""
    if is_view:
        return 0.0
    base = op_name.split(".")[-2] if "." in op_name else op_name
    out_elems = sum(_size(s) for s, _ in out_avals)
    if base in ("mm", "bmm"):
        (a_shape, _), (b_shape, _) = in_avals[0], in_avals[1]
        return 2.0 * out_elems * a_shape[-1]
    if base == "addmm":
        return 2.0 * out_elems * in_avals[1][0][-1]
    if base == "convolution":
        # OIHW weight: kh*kw*(cin/groups) MACs per output element, which
        # covers grouped (depthwise) and dilated convolutions alike; the
        # output is the first tensor (a bias add is not counted, as in the
        # reference's conv_general_dilated)
        (w_shape, _), (o_shape, _) = in_avals[1], out_avals[0]
        return 2.0 * _size(o_shape) * _size(w_shape[1:])
    if base == "decode_attention":
        (b, hq, d), s = in_avals[0][0], in_avals[1][0][1]
        return 4.0 * b * hq * s * d
    if base == "flash_attention":
        (b, sq, hq, d), sk = in_avals[0][0], in_avals[1][0][1]
        return 4.0 * b * hq * sq * sk * d
    if base == "rmsnorm":
        return 4.0 * out_elems
    if base in _REDUCTIONS:
        return float(sum(_size(s) for s, _ in in_avals))
    if base in _TRANSCENDENTAL:
        return 4.0 * out_elems  # transcendental cost factor
    return float(out_elems)


def node_bytes(
    in_avals: Sequence[Aval], out_avals: Sequence[Aval], is_view: bool
) -> float:
    """Memory traffic estimate: read all inputs + write all outputs once (a
    view moves nothing)."""
    if is_view:
        return 0.0
    return float(sum(aval_nbytes(a) for a in (*in_avals, *out_avals)))


# ---------------------------------------------------------------------------
# device specs (simulated endpoints of the MEC link)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float              # achievable peak (already derated)
    mem_bw: float                  # bytes/s
    kernel_launch_s: float         # per-kernel dispatch overhead
    efficiency: float = 1.0        # additional utilization derate

    def op_time(self, flops: float, mem_bytes: float) -> float:
        """Roofline max of compute and memory time for one kernel."""
        eff = self.peak_flops * self.efficiency
        return max(flops / eff, mem_bytes / self.mem_bw)

    def sequence_time(
        self, total_flops: float, total_bytes: float, num_kernels: int,
        fusion_factor: float = 1.0,
    ) -> float:
        """Time for a kernel sequence. ``fusion_factor`` < 1 models the
        replayed graph's fewer memory round-trips than per-op dispatch."""
        eff = self.peak_flops * self.efficiency
        compute = total_flops / eff
        memory = (total_bytes * fusion_factor) / self.mem_bw
        return max(compute, memory) + num_kernels * self.kernel_launch_s


# Simulation constants of the paper's testbed (not measurements of this card).
# Jetson Xavier NX: ~1.1 fp16 TFLOP/s usable on the Volta iGPU, derated for the
# 10 W envelope used on the robot.
JETSON_XAVIER_NX = DeviceSpec(
    name="jetson_xavier_nx",
    peak_flops=0.9e12,
    mem_bw=51.2e9,          # LPDDR4x 59.7 GB/s peak, derated
    kernel_launch_s=9e-6,
    efficiency=0.45,
)

# GTX 2080 Ti class server: 13.4 fp32 TFLOP/s, 616 GB/s GDDR6.
GTX_2080TI = DeviceSpec(
    name="gtx_2080ti",
    peak_flops=13.4e12,
    mem_bw=616e9,
    kernel_launch_s=4e-6,
    efficiency=0.45,
)
