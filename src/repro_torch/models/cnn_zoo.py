"""CNN zoo: KAPAO and the torchvision set of Fig. 12 (ResNet50, ConvNeXt-T,
FCN-R50, DeepLabv3-R50, Faster-RCNN-R50, RetinaNet-R50), VGG16 (Fig. 1), and
the two sensor models of the partitioning experiments.

The port of ``repro.models.cnn_zoo``, model for model.  Each ``make_*`` draws
its numpy parameters with the reference's generator calls in the reference's
order, so one seed gives bit-identical weights, and converts them with
:func:`repro_torch.convert.cnn_params_from_numpy` (convolution kernels HWIO ->
OIHW).  The apps keep the reference's boundary: NHWC ``uint8`` camera frames
(f32 sensor planes) in, outputs of the reference's shape, dtype and element
order out.  Inside, activations are NCHW and every convolution is
``F.conv2d`` (cuDNN on the card: no hand kernel lies on this path).

JAX's ``"SAME"`` padding is asymmetric where the total is odd (a stride-2
3x3 convolution on an even input pads (0, 1)); :func:`same_pads` computes it
and :func:`conv` / :func:`max_pool` pad explicitly when the two sides differ.
Tensors the reference flattens in NHWC order are permuted to NHWC before
their reshape.

KAPAO is calibrated so the steady inference records the paper's Tab. III
loop composition: 522 kernel launches, 3 HtoD, 8 DtoH, 9 DtoD, with the
YOLO-style mesh-grid initialization as a setup graph on the first inference.
``scale`` shrinks channel widths for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.offload import OffloadableModel, trace_model
from repro_torch.device import resolve_device


def _c(ch: int, scale: float) -> int:
    return max(4, int(round(ch * scale / 4)) * 4)


def _conv_params(rng, k, cin, cout, name, params):
    params[f"{name}_w"] = (
        rng.normal(0, (2.0 / (k * k * cin)) ** 0.5, (k, k, cin, cout))
    ).astype(np.float32)
    params[f"{name}_scale"] = np.ones((cout,), np.float32)
    params[f"{name}_shift"] = np.zeros((cout,), np.float32)


def _model(name, apply, params, inputs, device, **kw) -> OffloadableModel:
    return OffloadableModel(
        name, apply, cnn_params_from_numpy(params, device), inputs, **kw
    )


# ---------------------------------------------------------------------------
# padding, convolution, pooling
# ---------------------------------------------------------------------------

def same_pads(size: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of JAX's ``"SAME"`` along one spatial dim: the
    output is ``ceil(size / stride)`` and the odd pixel of the total goes to
    the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, stride, dilation, value) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``x`` padded for a SAME window: symmetric padding is returned for the
    op to apply itself, asymmetric padding is applied here with ``value``."""
    top, bottom = same_pads(x.shape[2], k[0], stride, dilation)
    left, right = same_pads(x.shape[3], k[1], stride, dilation)
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def conv(x, w, stride: int = 1, padding: str = "SAME", *, dilation: int = 1,
         groups: int = 1, bias=None):
    """``lax.conv_general_dilated`` on NCHW activations and an OIHW kernel."""
    pad = (0, 0)
    if padding == "SAME":
        x, pad = _pad_same(x, tuple(w.shape[2:]), stride, dilation, 0.0)
    return F.conv2d(x, w, bias, stride, pad, dilation, groups)


def max_pool(x, k: int, stride: int, padding: str):
    """``lax.reduce_window(max)``: SAME pads with -inf."""
    pad = (0, 0)
    if padding == "SAME":
        x, pad = _pad_same(x, (k, k), stride, 1, float("-inf"))
    return F.max_pool2d(x, k, stride, pad)


def _chan(v):
    """A per-channel vector broadcast over NCHW."""
    return v.view(-1, 1, 1)


def _conv_bn_act(params, name, x, stride=1, act="relu", fold=False):
    w = params[f"{name}_w"]
    if fold:
        # deployment graph: BN scale folded into conv weights, bias only
        y = conv(x, w, stride, bias=params[f"{name}_shift"])
    else:
        y = conv(x, w, stride)
        y = y * _chan(params[f"{name}_scale"]) + _chan(params[f"{name}_shift"])
    if act == "relu":
        y = F.relu(y)
    elif act == "silu":
        y = F.silu(y)
    return y


def _image(x):
    """An NHWC ``uint8`` frame as a contiguous NCHW f32 in [0, 1]."""
    return x.permute(0, 3, 1, 2).to(torch.float32, memory_format=torch.contiguous_format) / 255.0


def _planes(x):
    """NHWC f32 sensor planes as contiguous NCHW."""
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc_rows(x, width: int):
    """NCHW ``x`` as (batch, rows, width) in the reference's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


def _take_rows(t, idx):
    """``take_along_axis(t, idx[..., None], axis=1)`` for (b, n, c) ``t``."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def _pool_fc(h, w):
    return h.mean(dim=(2, 3)) @ w


def _frame(rng, input_size: int) -> np.ndarray:
    return rng.integers(0, 255, (1, input_size, input_size, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# VGG16
# ---------------------------------------------------------------------------

def make_vgg16(scale: float = 1.0, input_size: int = 224, seed: int = 0, *,
               device: Any = "cuda") -> OffloadableModel:
    rng = np.random.default_rng(seed)
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
           512, 512, 512, "M"]
    params: Dict[str, Any] = {}
    cin, i = 3, 0
    for v in cfg:
        if v == "M":
            continue
        _conv_params(rng, 3, cin, _c(v, scale), f"c{i}", params)
        cin = _c(v, scale)
        i += 1
    params["fc_w"] = rng.normal(0, 0.01, (cin, 1000)).astype(np.float32)

    def apply(params, x):
        h, i = _image(x), 0
        for v in cfg:
            if v == "M":
                h = max_pool(h, 2, 2, "VALID")
            else:
                h = _conv_bn_act(params, f"c{i}", h)
                i += 1
        return [_pool_fc(h, params["fc_w"])]

    return _model("vgg16", apply, params, (_frame(rng, input_size),), device,
                  input_wire_divisor=10.0)


# ---------------------------------------------------------------------------
# ResNet50 (+ FCN / DeepLabv3 / detection heads on top)
# ---------------------------------------------------------------------------

_R50_BLOCKS = [(3, 256, 64), (4, 512, 128), (6, 1024, 256), (3, 2048, 512)]


def _resnet50_params(rng, scale, params, prefix=""):
    _conv_params(rng, 7, 3, _c(64, scale), f"{prefix}stem", params)
    cin = _c(64, scale)
    for si, (n, cout, cmid) in enumerate(_R50_BLOCKS):
        cout, cmid = _c(cout, scale), _c(cmid, scale)
        for bi in range(n):
            nm = f"{prefix}s{si}b{bi}"
            _conv_params(rng, 1, cin, cmid, f"{nm}_1", params)
            _conv_params(rng, 3, cmid, cmid, f"{nm}_2", params)
            _conv_params(rng, 1, cmid, cout, f"{nm}_3", params)
            if bi == 0:
                _conv_params(rng, 1, cin, cout, f"{nm}_ds", params)
            cin = cout
    return cin


def _resnet50_apply(params, x, prefix="", return_feats=False):
    h = _conv_bn_act(params, f"{prefix}stem", x, stride=2)
    h = max_pool(h, 3, 2, "SAME")
    feats: List[torch.Tensor] = []
    for si, (n, _cout, _cmid) in enumerate(_R50_BLOCKS):
        for bi in range(n):
            nm = f"{prefix}s{si}b{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            y = _conv_bn_act(params, f"{nm}_1", h)
            y = _conv_bn_act(params, f"{nm}_2", y, stride=stride)
            y = _conv_bn_act(params, f"{nm}_3", y, act="none")
            sc = (
                _conv_bn_act(params, f"{nm}_ds", h, stride=stride, act="none")
                if bi == 0
                else h
            )
            h = F.relu(y + sc)
        feats.append(h)
    return (h, feats) if return_feats else h


def make_resnet50(scale: float = 1.0, input_size: int = 224, seed: int = 0, *,
                  device: Any = "cuda") -> OffloadableModel:
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    cin = _resnet50_params(rng, scale, params)
    params["fc_w"] = rng.normal(0, 0.01, (cin, 1000)).astype(np.float32)

    def apply(params, x):
        return [_pool_fc(_resnet50_apply(params, _image(x)), params["fc_w"])]

    return _model("resnet50", apply, params, (_frame(rng, input_size),), device,
                  input_wire_divisor=10.0)


def _class_map(h, size):
    """Bilinear upsampling of the class logits to the frame, then the class
    map the app downloads (not the logits)."""
    out = F.interpolate(h, size=size, mode="bilinear", align_corners=False)
    return out.argmax(dim=1).to(torch.uint8)


def make_fcn_resnet50(scale: float = 1.0, input_size: int = 224, seed: int = 0, *,
                      device: Any = "cuda") -> OffloadableModel:
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    cin = _resnet50_params(rng, scale, params)
    _conv_params(rng, 3, cin, _c(512, scale), "head1", params)
    params["cls_w"] = rng.normal(
        0, 0.01, (1, 1, _c(512, scale), 21)
    ).astype(np.float32)

    def apply(params, x):
        x = _image(x)
        h = _resnet50_apply(params, x)
        h = _conv_bn_act(params, "head1", h)
        h = conv(h, params["cls_w"])
        return [_class_map(h, x.shape[2:])]

    return _model("fcn_resnet50", apply, params, (_frame(rng, input_size),), device,
                  input_wire_divisor=10.0)


def make_deeplabv3_resnet50(scale: float = 1.0, input_size: int = 224, seed: int = 0, *,
                            device: Any = "cuda") -> OffloadableModel:
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    cin = _resnet50_params(rng, scale, params)
    for i, rate in enumerate([1, 12, 24, 36]):
        _conv_params(rng, 3 if rate > 1 else 1, cin, _c(256, scale), f"aspp{i}", params)
    _conv_params(rng, 1, cin, _c(256, scale), "aspp_pool", params)
    _conv_params(rng, 1, 5 * _c(256, scale), _c(256, scale), "aspp_proj", params)
    params["cls_w"] = rng.normal(0, 0.01, (1, 1, _c(256, scale), 21)).astype(np.float32)

    def apply(params, x):
        x = _image(x)
        h = _resnet50_apply(params, x)
        branches = []
        for i, rate in enumerate([1, 12, 24, 36]):
            y = conv(h, params[f"aspp{i}_w"], dilation=rate)
            y = F.relu(y * _chan(params[f"aspp{i}_scale"]) + _chan(params[f"aspp{i}_shift"]))
            branches.append(y)
        pooled = h.mean(dim=(2, 3), keepdim=True)
        pooled = _conv_bn_act(params, "aspp_pool", pooled)
        pooled = pooled.expand(-1, -1, *branches[0].shape[2:])
        h = torch.cat(branches + [pooled], dim=1)
        h = _conv_bn_act(params, "aspp_proj", h)
        h = conv(h, params["cls_w"])
        return [_class_map(h, x.shape[2:])]

    return _model("deeplabv3_resnet50", apply, params, (_frame(rng, input_size),), device,
                  input_wire_divisor=10.0)


# ---------------------------------------------------------------------------
# ConvNeXt-T
# ---------------------------------------------------------------------------

def make_convnext_tiny(scale: float = 1.0, input_size: int = 224, seed: int = 0, *,
                       device: Any = "cuda") -> OffloadableModel:
    rng = np.random.default_rng(seed)
    depths, dims = [3, 3, 9, 3], [96, 192, 384, 768]
    dims = [_c(d, scale) for d in dims]
    params: Dict[str, Any] = {}
    params["stem_w"] = rng.normal(0, 0.05, (4, 4, 3, dims[0])).astype(np.float32)
    for si, (n, dim) in enumerate(zip(depths, dims)):
        for bi in range(n):
            nm = f"s{si}b{bi}"
            params[f"{nm}_dw"] = rng.normal(0, 0.05, (7, 7, 1, dim)).astype(np.float32)
            params[f"{nm}_norm"] = np.ones((dim,), np.float32)
            params[f"{nm}_p1"] = rng.normal(0, (2 / dim) ** 0.5, (dim, 4 * dim)).astype(np.float32)
            params[f"{nm}_p2"] = rng.normal(0, (2 / (4 * dim)) ** 0.5, (4 * dim, dim)).astype(np.float32)
            params[f"{nm}_gamma"] = np.full((dim,), 1e-6, np.float32)
        if si < 3:
            params[f"ds{si}_w"] = rng.normal(
                0, 0.05, (2, 2, dim, dims[si + 1])
            ).astype(np.float32)
    params["fc_w"] = rng.normal(0, 0.01, (dims[-1], 1000)).astype(np.float32)

    def apply(params, x):
        h = conv(_image(x), params["stem_w"], 4, "VALID")
        for si, (n, dim) in enumerate(zip(depths, dims)):
            for bi in range(n):
                nm = f"s{si}b{bi}"
                # depthwise conv, then the channel MLP on NHWC rows
                y = conv(h, params[f"{nm}_dw"], groups=dim).permute(0, 2, 3, 1)
                mu = y.mean(dim=-1, keepdim=True)
                var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
                y = (y - mu) * torch.rsqrt(var + 1e-6) * params[f"{nm}_norm"]
                y = y @ params[f"{nm}_p1"]
                y = F.gelu(y, approximate="tanh")     # jax.nn.gelu's default
                y = y @ params[f"{nm}_p2"]
                h = h + (y * params[f"{nm}_gamma"]).permute(0, 3, 1, 2)
            if si < 3:
                h = conv(h, params[f"ds{si}_w"], 2, "VALID")
        return [_pool_fc(h, params["fc_w"])]

    return _model("convnext_tiny", apply, params, (_frame(rng, input_size),), device,
                  input_wire_divisor=10.0)


# ---------------------------------------------------------------------------
# sensor encoder / recurrent decoder — partial-offloading workloads
# ---------------------------------------------------------------------------

def make_sensor_encoder(
    scale: float = 1.0, input_size: int = 96, seed: int = 0, n_blocks: int = 12, *,
    device: Any = "cuda",
) -> OffloadableModel:
    """Multi-channel sensor encoder with an early spatial bottleneck: an
    8-channel raw sensor stack (ships uncompressed), a cheap stride-4 stem
    and a deep residual trunk at the reduced resolution."""
    rng = np.random.default_rng(seed)
    c_in = 8
    c_stem = _c(16, scale)
    c_trunk = _c(256, scale)
    params: Dict[str, Any] = {}
    _conv_params(rng, 5, c_in, c_stem, "stem", params)
    _conv_params(rng, 1, c_stem, c_trunk, "expand", params)
    for i in range(n_blocks):
        _conv_params(rng, 3, c_trunk, c_trunk, f"b{i}_1", params)
        _conv_params(rng, 3, c_trunk, c_trunk, f"b{i}_2", params)
    params["fc_w"] = rng.normal(0, 0.01, (c_trunk, 64)).astype(np.float32)

    def apply(params, x):
        h = _conv_bn_act(params, "stem", _planes(x), stride=4)
        h = _conv_bn_act(params, "expand", h)
        for i in range(n_blocks):
            y = _conv_bn_act(params, f"b{i}_1", h)
            y = _conv_bn_act(params, f"b{i}_2", y, act="none")
            h = F.relu(h + y)
        return [_pool_fc(h, params["fc_w"])]

    x = rng.normal(0, 1, (1, input_size, input_size, c_in)).astype(np.float32)
    # raw sensor planes: no camera-style wire compression
    return _model("sensor_encoder", apply, params, (x,), device, input_wire_divisor=1.0)


def make_recurrent_sensor_decoder(
    scale: float = 1.0, input_size: int = 96, seed: int = 0,
    n_blocks: int = 16, d_state: int = 256, *, device: Any = "cuda",
) -> OffloadableModel:
    """Sensor-conditioned autoregressive decoder, the stateful sibling of
    :func:`make_sensor_encoder`: ``apply(p, frame, h) -> [y, h']``.  The
    carried hidden state FiLM-modulates the expanded features before the
    residual trunk, and a GRU-style cell folds the pooled trunk output back
    into the new state."""
    rng = np.random.default_rng(seed)
    c_in = 8
    c_stem = _c(16, scale)
    c_trunk = _c(256, scale)
    params: Dict[str, Any] = {}
    _conv_params(rng, 5, c_in, c_stem, "stem", params)
    _conv_params(rng, 1, c_stem, c_trunk, "expand", params)
    params["cond_w"] = rng.normal(
        0, (1.0 / d_state) ** 0.5, (d_state, c_trunk)
    ).astype(np.float32)
    for i in range(n_blocks):
        _conv_params(rng, 3, c_trunk, c_trunk, f"b{i}_1", params)
        _conv_params(rng, 3, c_trunk, c_trunk, f"b{i}_2", params)
    params["mix_w"] = rng.normal(
        0, (1.0 / c_trunk) ** 0.5, (c_trunk, d_state)
    ).astype(np.float32)
    params["rec_w"] = rng.normal(
        0, (1.0 / d_state) ** 0.5, (d_state, d_state)
    ).astype(np.float32)
    params["out_w"] = rng.normal(0, 0.01, (d_state, 64)).astype(np.float32)

    def apply(params, frame, h):
        # stateless prologue: the input encoder
        z = _conv_bn_act(params, "stem", _planes(frame), stride=4)
        z = _conv_bn_act(params, "expand", z)
        # the carried state conditions everything downstream
        gate = torch.tanh(h @ params["cond_w"])
        z = z * (1.0 + gate[:, :, None, None])
        for i in range(n_blocks):
            y = _conv_bn_act(params, f"b{i}_1", z)
            y = _conv_bn_act(params, f"b{i}_2", y, act="none")
            z = F.relu(z + y)
        feats = z.mean(dim=(2, 3))
        h_new = torch.tanh(feats @ params["mix_w"] + h @ params["rec_w"])
        return [h_new @ params["out_w"], h_new]

    frame = rng.normal(0, 1, (1, input_size, input_size, c_in)).astype(np.float32)
    h0 = np.zeros((1, d_state), np.float32)
    # raw sensor planes: no camera-style wire compression
    return _model("recurrent_sensor_decoder", apply, params, (frame, h0), device,
                  input_wire_divisor=1.0)


# ---------------------------------------------------------------------------
# detection: FPN + RetinaNet / Faster-RCNN (static-shape variants)
# ---------------------------------------------------------------------------

def _fpn_params(rng, scale, params, cins):
    for i, cin in enumerate(cins):
        _conv_params(rng, 1, cin, _c(256, scale), f"fpn_lat{i}", params)
        _conv_params(rng, 3, _c(256, scale), _c(256, scale), f"fpn_out{i}", params)


def _upsample_to(x, like):
    """``jax.image.resize(..., "nearest")``: half-pixel nearest source."""
    return F.interpolate(x, size=like.shape[2:], mode="nearest-exact")


def _fpn_apply(params, feats):
    lats = [
        _conv_bn_act(params, f"fpn_lat{i}", f, act="none")
        for i, f in enumerate(feats)
    ]
    outs = [lats[-1]]
    for i in range(len(lats) - 2, -1, -1):
        outs.insert(0, lats[i] + _upsample_to(outs[0], lats[i]))
    return [
        _conv_bn_act(params, f"fpn_out{i}", o, act="none")
        for i, o in enumerate(outs)
    ]


def make_retinanet_resnet50(scale: float = 1.0, input_size: int = 256, seed: int = 0, *,
                            device: Any = "cuda") -> OffloadableModel:
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    _resnet50_params(rng, scale, params)
    cins = [_c(c, scale) for c in (512, 1024, 2048)]
    _fpn_params(rng, scale, params, cins)
    c = _c(256, scale)
    for head in ("cls", "box"):
        for i in range(4):
            _conv_params(rng, 3, c, c, f"{head}_h{i}", params)
        out_ch = 9 * 80 if head == "cls" else 9 * 4
        params[f"{head}_out_w"] = rng.normal(0, 0.01, (3, 3, c, out_ch)).astype(np.float32)

    def apply(params, x):
        _, feats = _resnet50_apply(params, _image(x), return_feats=True)
        pyr = _fpn_apply(params, feats[1:])
        outs = []
        for f in pyr:
            hc, hb = f, f
            for i in range(4):
                hc = _conv_bn_act(params, f"cls_h{i}", hc)
                hb = _conv_bn_act(params, f"box_h{i}", hb)
            cls = conv(hc, params["cls_out_w"])
            box = conv(hb, params["box_out_w"])
            # the app downloads top-k candidates per level, not raw maps
            cls_f = _nhwc_rows(cls, 80)
            box_f = _nhwc_rows(box, 4)
            score = cls_f.amax(dim=-1)
            _, idx = torch.topk(score, 64)
            outs.append(_take_rows(cls_f, idx))
            outs.append(_take_rows(box_f, idx))
        return outs

    return _model("retinanet_resnet50", apply, params, (_frame(rng, input_size),), device,
                  input_wire_divisor=10.0)


def make_fasterrcnn_resnet50(scale: float = 1.0, input_size: int = 256, seed: int = 0, *,
                             device: Any = "cuda") -> OffloadableModel:
    """Static-shape Faster-RCNN: RPN + fixed-count top-k proposals + ROI head
    (the dynamic NMS/proposal sampling made static-shape)."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    _resnet50_params(rng, scale, params)
    cins = [_c(c, scale) for c in (512, 1024, 2048)]
    _fpn_params(rng, scale, params, cins)
    c = _c(256, scale)
    _conv_params(rng, 3, c, c, "rpn_conv", params)
    params["rpn_cls_w"] = rng.normal(0, 0.01, (1, 1, c, 3)).astype(np.float32)
    params["rpn_box_w"] = rng.normal(0, 0.01, (1, 1, c, 12)).astype(np.float32)
    params["roi_fc1"] = rng.normal(0, 0.01, (c * 49, 1024)).astype(np.float32)
    params["roi_fc2"] = rng.normal(0, 0.01, (1024, 1024)).astype(np.float32)
    params["roi_cls"] = rng.normal(0, 0.01, (1024, 91)).astype(np.float32)
    params["roi_box"] = rng.normal(0, 0.01, (1024, 91 * 4)).astype(np.float32)

    n_props = 64

    def apply(params, x):
        _, feats = _resnet50_apply(params, _image(x), return_feats=True)
        pyr = _fpn_apply(params, feats[1:])
        scores = []
        for f in pyr:
            r = _conv_bn_act(params, "rpn_conv", f)
            s = conv(r, params["rpn_cls_w"])
            conv(r, params["rpn_box_w"])    # computed and unused, as in the reference
            scores.append(s.permute(0, 2, 3, 1).reshape(s.shape[0], -1))
        allsc = torch.cat(scores, dim=1)
        _, top_idx = torch.topk(allsc, n_props)          # static top-k proposals
        # static ROI pooling stand-in: gather fixed 7x7 windows from pyr[0]
        f0 = pyr[0]
        b, cc, hh, ww = f0.shape
        flat = _nhwc_rows(f0, cc)
        centers = top_idx % (hh * ww)
        rois = _take_rows(flat, centers)[:, :, None, :]
        rois = rois.repeat(1, 1, 49, 1).reshape(b, n_props, 49 * cc)
        h = F.relu(rois @ params["roi_fc1"])
        h = F.relu(h @ params["roi_fc2"])
        return [h @ params["roi_cls"], h @ params["roi_box"]]

    return _model("fasterrcnn_resnet50", apply, params, (_frame(rng, input_size),), device,
                  input_wire_divisor=10.0)


# ---------------------------------------------------------------------------
# KAPAO (YOLOv5-style keypoint detector) — calibrated to Tab. III
# ---------------------------------------------------------------------------

def _csp_block(params, name, x, n_inner):
    y1 = _conv_bn_act(params, f"{name}_a", x, act="silu", fold=True)
    y2 = _conv_bn_act(params, f"{name}_b", x, act="silu", fold=True)
    for i in range(n_inner):
        r = _conv_bn_act(params, f"{name}_i{i}_1", y1, act="silu", fold=True)
        r = _conv_bn_act(params, f"{name}_i{i}_2", r, act="silu", fold=True)
        y1 = y1 + r
    y = torch.cat([y1, y2], dim=1)
    return _conv_bn_act(params, f"{name}_out", y, act="silu", fold=True)


def _csp_params(rng, name, cin, cmid, cout, n_inner, params):
    _conv_params(rng, 1, cin, cmid, f"{name}_a", params)
    _conv_params(rng, 1, cin, cmid, f"{name}_b", params)
    for i in range(n_inner):
        _conv_params(rng, 1, cmid, cmid, f"{name}_i{i}_1", params)
        _conv_params(rng, 3, cmid, cmid, f"{name}_i{i}_2", params)
    _conv_params(rng, 1, 2 * cmid, cout, f"{name}_out", params)


def _kapao_setup(params, x, imsz, ratio):
    """YOLO inference-pipeline init: per-scale mesh grids sized to the input
    image (built on the first inference, cached on the device)."""
    grids = {}
    h, w = x.shape[1], x.shape[2]
    f32, dev = torch.float32, x.device
    for i, s in enumerate([4, 8, 16, 32]):
        gh, gw = h // s, w // s
        gy = torch.arange(gh, dtype=f32, device=dev)[:, None] * torch.ones((1, gw), dtype=f32,
                                                                          device=dev)
        gx = torch.ones((gh, 1), dtype=f32, device=dev) * torch.arange(gw, dtype=f32,
                                                                       device=dev)[None, :]
        grids[f"g{i}"] = torch.stack([gx, gy], dim=-1)
    return grids


def _kapao_apply(extra_ops: int):
    """KAPAO's steady inference with a decode chain of ``extra_ops``
    sigmoids (one kernel each)."""

    def apply(params, grids, x, imsz, ratio):
        x = _image(x)                           # camera frame, normalized on device
        h = _conv_bn_act(params, "stem", x, stride=2, act="silu", fold=True)
        feats = []
        for i in range(4):
            h = _conv_bn_act(params, f"down{i}", h, stride=2, act="silu", fold=True)
            h = _csp_block(params, f"csp{i}", h, [1, 1, 2, 1][i])
            feats.append(h)
        # SPPF
        y = _conv_bn_act(params, "sppf_in", h, act="silu", fold=True)
        p1 = max_pool(y, 5, 1, "SAME")
        p2 = max_pool(p1, 5, 1, "SAME")
        y = torch.cat([y, p1, p2], dim=1)
        h = _conv_bn_act(params, "sppf_out", y, act="silu", fold=True)
        feats[3] = h
        # PAN up path
        ups = [feats[3]]
        for i, fi in enumerate([2, 1, 0]):
            cat = torch.cat([_upsample_to(ups[0], feats[fi]), feats[fi]], dim=1)
            ups.insert(0, _csp_block(params, f"up{i}", cat, 1))
        # PAN down path
        outs = [ups[0]]
        for i in range(3):
            d = _conv_bn_act(params, f"pan_down{i}", outs[-1], stride=2, act="silu", fold=True)
            cat = torch.cat([d, ups[i + 1]], dim=1)
            outs.append(_csp_block(params, f"pan{i}", cat, 1))
        # heads: 4 scales x (det, kp) = 8 outputs, decoded with cached grids,
        # reduced to top-k candidates per scale (what a tracking app downloads)
        topk = 64
        results = []
        for i, f in enumerate(outs):
            det = conv(f, params[f"det{i}_w"])
            xy = det[:, :2] + grids[f"g{i}"].permute(2, 0, 1) * ratio[0]
            det = torch.cat([xy, det[:, 2:]], dim=1)
            flat = _nhwc_rows(det, det.shape[1])
            # top_k on raw logits: sigmoid is monotone, same candidates
            _, idx = torch.topk(flat[..., 4], topk)
            det_top = _take_rows(flat, idx).clone()      # explicit DtoD staging copy
            kp = conv(f, params[f"kp{i}_w"])
            kp_top = _take_rows(_nhwc_rows(kp, kp.shape[1]), idx).clone()
            results.append(det_top)
            results.append(kp_top)
        # one more DtoD (output staging buffer)
        results[0] = results[0].clone()
        # YOLO-style decode post-processing chain; its length is calibrated
        # so the steady inference records exactly 522 kernel launches
        c = params["calib_w"]
        for _ in range(extra_ops):
            c = torch.sigmoid(c)
        results[-1] = results[-1] + c.sum() * 0.0
        return results

    return apply


def make_kapao(scale: float = 1.0, input_size: int = 256, seed: int = 0,
               extra_ops: int = 0, *, device: Any = "cuda") -> OffloadableModel:
    """KAPAO/YOLOv5-class model: CSP backbone + PAN neck + 4 detect heads.
    Per steady inference: 3 HtoD (image, ``imsz`` (unused, but uploaded),
    ``ratio``), 8 DtoH (4 scales x (det, kp)), 9 DtoD copies; the first
    inference also builds the YOLO mesh grids (the setup graph)."""
    rng = np.random.default_rng(seed)
    widths = [_c(w, scale) for w in (64, 128, 256, 512, 768)]
    params: Dict[str, Any] = {}
    _conv_params(rng, 6, 3, widths[0], "stem", params)
    depths = [1, 1, 2, 1]
    for i in range(4):
        _conv_params(rng, 3, widths[i], widths[i + 1], f"down{i}", params)
        _csp_params(rng, f"csp{i}", widths[i + 1], widths[i + 1] // 2,
                    widths[i + 1], depths[i], params)
    # SPPF (two pooling stages)
    _conv_params(rng, 1, widths[4], widths[4] // 2, "sppf_in", params)
    _conv_params(rng, 1, (widths[4] // 2) * 3, widths[4], "sppf_out", params)
    # PAN neck
    for i, (ci, co) in enumerate([(widths[4] + widths[3], widths[3]),
                                  (widths[3] + widths[2], widths[2]),
                                  (widths[2] + widths[1], widths[1])]):
        _csp_params(rng, f"up{i}", ci, co // 2, co, 1, params)
    for i in range(3):
        ci = widths[1 + i] + widths[2 + i]
        co = widths[2 + i]
        _conv_params(rng, 3, widths[1 + i], widths[1 + i], f"pan_down{i}", params)
        _csp_params(rng, f"pan{i}", ci, co // 2, co, 1, params)
    # detect heads (4 scales x (det, keypoint))
    no = 3 * (56 + 5)  # anchors x (kp-objects + box)
    for i, w in enumerate([widths[1], widths[2], widths[3], widths[4]]):
        params[f"det{i}_w"] = rng.normal(0, 0.01, (1, 1, w, no)).astype(np.float32)
        params[f"kp{i}_w"] = rng.normal(0, 0.01, (1, 1, w, 3 * 34)).astype(np.float32)
    params["calib_w"] = np.zeros((16,), np.float32)

    x = _frame(rng, input_size)
    imsz = np.array([input_size, input_size], np.float32)
    ratio = np.array([1.0, 1.0], np.float32)
    return _model(
        "kapao", _kapao_apply(extra_ops), params, (x, imsz, ratio), device,
        setup=_kapao_setup,
        input_wire_divisor=10.0,   # JPEG-compressed camera frames on the wire
    )


def make_kapao_calibrated(scale: float = 1.0, input_size: int = 256, seed: int = 0,
                          target_kernels: int = 522, *, device: Any = "cuda") -> OffloadableModel:
    """KAPAO with the decode chain's length chosen so the steady inference
    records exactly ``target_kernels`` kernel launches (Tab. III loop
    column): the steady graph's nodes less its DtoD clones, counted on the
    graph a session traces."""
    dev = resolve_device(device)
    model = make_kapao(scale, input_size, seed, device=dev)
    n_kernels = trace_model(model, dev).n_kernel_records
    if n_kernels > target_kernels:
        raise ValueError(f"kapao base graph has {n_kernels} > {target_kernels} kernels")
    # each sigmoid of the chain is one aten node
    return dataclasses.replace(model, apply=_kapao_apply(target_kernels - n_kernels))


ZOO = {
    "vgg16": make_vgg16,
    "resnet50": make_resnet50,
    "sensor_encoder": make_sensor_encoder,
    "recurrent_sensor_decoder": make_recurrent_sensor_decoder,
    "convnext_tiny": make_convnext_tiny,
    "fcn_resnet50": make_fcn_resnet50,
    "deeplabv3_resnet50": make_deeplabv3_resnet50,
    "fasterrcnn_resnet50": make_fasterrcnn_resnet50,
    "retinanet_resnet50": make_retinanet_resnet50,
    "kapao": make_kapao_calibrated,
}
