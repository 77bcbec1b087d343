"""Run a parsed TFLite graph as one torch program on the filter's device.

The counterpart of ``nnstreamer_tpu/tools/tflite_exec.py``. Where the
reference's ``.tflite`` files go through the TFLite C++ interpreter
(op-by-op CPU dispatch), this walks the flatbuffer graph once and emits
the whole network as torch ops on the device: a fused segment captures it
with the ops around it, so on the card a frame through a ``.tflite`` model
is one CUDA graph replay. No interpreter is in the loop.

Quantized graphs run in *fake-quant* float, as in the reference: weights
are dequantized exactly off their integer grid once, at build, and every
activation is rounded onto its tensor's (scale, zero_point) grid
(:func:`_qdq`, half to even as ``jnp.round``).

Where torch and TFLite differ, the program follows TFLite:

- layout: activations stay NHWC; a conv permutes to torch's NCHW view
  (channels-last memory, so no copy) and back. Conv filters are OHWI,
  depthwise filters ``[1, kh, kw, C·mult]`` (``groups = C``), dense
  weights ``[out, in]``;
- ``SAME`` padding is TFLite's: the odd row and column go bottom and
  right, padded explicitly (``F.pad``) where the two sides differ;
- an average pool under ``SAME`` divides by the window's in-image count.

Supported ops: CONV_2D, DEPTHWISE_CONV_2D, ADD / MUL / SUB,
AVERAGE_POOL_2D / MAX_POOL_2D, RESHAPE, SQUEEZE, SOFTMAX, LOGISTIC,
RESIZE_BILINEAR (``align_corners``, ``half_pixel_centers``),
CONCATENATION, FULLY_CONNECTED, MEAN, PAD and DEQUANTIZE, with the fused
activations NONE / RELU / RELU6 / RELU_N1_TO_1 / TANH. Any other op raises
``NotImplementedError`` naming the op and its code.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.device import DeviceLike, resolve_device
from nnstreamer_tpu_torch.tools.tflite_parse import Operator, Tensor, TFLiteModel, parse

_QRANGE = {np.uint8: (0, 255), np.int8: (-128, 127), np.int16: (-32768, 32767)}


def _act(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name is None:
        return x
    if name == "RELU":
        return torch.clamp_min(x, 0.0)
    if name == "RELU6":
        return torch.clamp(x, 0.0, 6.0)
    if name == "RELU_N1_TO_1":
        return torch.clamp(x, -1.0, 1.0)
    if name == "TANH":
        return torch.tanh(x)
    raise NotImplementedError(f"activation {name}")


def _gridded(t: Tensor) -> bool:
    """Whether tensor ``t`` carries an integer activation grid."""
    return (t.quant is not None and t.quant.quantized
            and np.dtype(t.dtype).type in _QRANGE)


def _qdq(x: torch.Tensor, t: Tensor) -> torch.Tensor:
    """Round-trip a float activation through tensor t's integer grid: the
    float emulation of the interpreter's requantize step. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    if not _gridded(t):
        return x
    lo, hi = _QRANGE[np.dtype(t.dtype).type]
    s = float(t.quant.scale[0])
    z = float(t.quant.zero_point[0]) if t.quant.zero_point.size else 0.0
    q = torch.clamp(torch.round(x / s) + z, lo, hi)
    return (q - z) * s


def _same(n: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of one axis under TFLite ``SAME``: the odd
    element goes high."""
    k_eff = (k - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def _pads(o: Dict[str, Any], h: int, w: int, kh: int, kw: int) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of a conv or pool op's padding."""
    if o.get("padding", "SAME") != "SAME":
        return 0, 0, 0, 0
    ph = _same(h, kh, o["stride_h"], o.get("dilation_h", 1))
    pw = _same(w, kw, o["stride_w"], o.get("dilation_w", 1))
    return ph[0], ph[1], pw[0], pw[1]


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               o: Dict[str, Any], groups: int) -> torch.Tensor:
    """NHWC conv with an OIHW weight under the op's strides, dilations and
    TFLite padding → NHWC."""
    kh, kw = w.shape[-2:]
    top, bottom, left, right = _pads(o, x.shape[1], x.shape[2], kh, kw)
    xc = x.permute(0, 3, 1, 2)
    if top == bottom and left == right:
        padding = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        padding = (0, 0)
    y = F.conv2d(xc, w, b, (o["stride_h"], o["stride_w"]), padding,
                 (o.get("dilation_h", 1), o.get("dilation_w", 1)), groups)
    return y.permute(0, 2, 3, 1)


def _pool_nhwc(x: torch.Tensor, o: Dict[str, Any], kind: str) -> torch.Tensor:
    kh, kw, sh, sw = o["filter_h"], o["filter_w"], o["stride_h"], o["stride_w"]
    top, bottom, left, right = _pads(o, x.shape[1], x.shape[2], kh, kw)
    xc = x.permute(0, 3, 1, 2)
    padded = top or bottom or left or right
    if kind == "MAX_POOL_2D":
        if padded:
            xc = F.pad(xc, (left, right, top, bottom), value=float("-inf"))
        y = F.max_pool2d(xc, (kh, kw), (sh, sw))
    elif not padded:
        y = F.avg_pool2d(xc, (kh, kw), (sh, sw))
    else:
        # the window's sum over the in-image count (padding not counted)
        pad = (left, right, top, bottom)
        total = F.avg_pool2d(F.pad(xc, pad), (kh, kw), (sh, sw), divisor_override=1)
        ones = torch.ones((1, 1, x.shape[1], x.shape[2]), dtype=x.dtype, device=x.device)
        count = F.avg_pool2d(F.pad(ones, pad), (kh, kw), (sh, sw), divisor_override=1)
        y = total / count
    return y.permute(0, 2, 3, 1)


def _resize_bilinear(x: torch.Tensor, oh: int, ow: int, align: bool,
                     half_pixel: bool) -> torch.Tensor:
    """TF-semantics bilinear resize of an NHWC tensor (the reference's
    ``_resize_bilinear``, in plain torch: the reference computes it in jnp,
    outside the crop/resize kernel)."""
    ih, iw = x.shape[1], x.shape[2]

    def coords(o: int, i: int) -> torch.Tensor:
        if align and o > 1:
            return torch.linspace(0.0, i - 1.0, o, device=x.device)
        r = torch.arange(o, device=x.device, dtype=torch.float32)
        if half_pixel:
            return torch.clamp_min((r + 0.5) * (i / o) - 0.5, 0.0)
        return r * (i / o)

    ys, xs = coords(oh, ih), coords(ow, iw)
    y0 = torch.clamp(torch.floor(ys).long(), 0, ih - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, iw - 1)
    y1, x1 = torch.clamp_max(y0 + 1, ih - 1), torch.clamp_max(x0 + 1, iw - 1)
    wy = (ys - y0).to(x.dtype)[None, :, None, None]
    wx = (xs - x0).to(x.dtype)[None, None, :, None]

    def g(yi, xi):
        return x[:, yi][:, :, xi]

    top = g(y0, x0) * (1.0 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1.0 - wx) + g(y1, x1) * wx
    return top * (1.0 - wy) + bot * wy


class TFLiteProgram:
    """A .tflite graph as one torch program on ``device``.

    ``prog(*xs)``: inputs in the graph's declared dtypes (uint8 / int8 for
    quantized graphs: dequantization is part of the program) → a list of
    float32 outputs on the device (quantized outputs come back
    dequantized). :meth:`trace` is the body, for a fused segment to take
    whole. ``device`` defaults to ``cuda`` (raises without a GPU unless
    ``"cpu"`` is asked for)."""

    def __init__(self, model: TFLiteModel | str, fake_quant: Optional[bool] = None,
                 compute_dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        m = parse(model) if isinstance(model, str) else model
        self.model = m
        self.device = resolve_device(device)
        if fake_quant is None:
            fake_quant = any(_gridded(t) for t in m.tensors)
        self.fake_quant = fake_quant
        self.compute_dtype = compute_dtype
        # constants dequantized once, here: on the device for the ops that
        # compute with them, on the host (numpy) for the shape operands
        # (resize sizes, reduce axes, pad widths) read while tracing
        self._host: Dict[int, np.ndarray] = {}
        self._consts: Dict[int, torch.Tensor] = {}
        for t in m.tensors:
            if t.data is None:
                continue
            d = t.dequantized()
            d = d if d is not None else t.data
            self._host[t.index] = d
            c = torch.from_numpy(np.array(d))  # a writable copy of the file's bytes
            if c.is_floating_point():
                c = c.to(compute_dtype)
            self._consts[t.index] = c.to(self.device)
        self._weights = self._prepare_weights()
        self.input_shapes = [m.tensors[i].shape for i in m.inputs]
        self.input_dtypes = [np.dtype(m.tensors[i].dtype) for i in m.inputs]
        self.input_shape = self.input_shapes[0]  # single-input shorthand
        self.input_dtype = self.input_dtypes[0]
        self.output_shapes = [m.tensors[o].shape for o in m.outputs]

    def _prepare_weights(self) -> Dict[int, Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """Each conv / dense op's constant weight in torch's layout (OIHW
        in channels-last memory, which is TFLite's OHWI bytes; dense
        ``[out, in]`` as it is) and its bias, once, by operator index."""
        out = {}
        for k, op in enumerate(self.model.operators):
            if op.name not in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
                continue
            w = self._consts.get(op.inputs[1])
            if w is None:
                continue  # a weight computed in the graph: laid out per call
            bias = self._bias(op)
            if op.name == "CONV_2D":
                w = w.permute(0, 3, 1, 2)
            elif op.name == "DEPTHWISE_CONV_2D":
                w = w.permute(3, 0, 1, 2).contiguous(memory_format=torch.channels_last)
            out[k] = (w, bias)
        return out

    def _bias(self, op: Operator) -> Optional[torch.Tensor]:
        # -1 is tflite's missing-optional-input sentinel
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            return self._consts.get(op.inputs[2])
        return None

    def _run(self, xs) -> List[torch.Tensor]:
        m = self.model
        if len(xs) != len(m.inputs):
            raise ValueError(f"graph takes {len(m.inputs)} inputs, got {len(xs)}")
        cd = self.compute_dtype
        env: Dict[int, Any] = dict(self._consts)
        for idx, x in zip(m.inputs, xs):
            t_in = m.tensors[idx]
            if np.issubdtype(np.dtype(t_in.dtype), np.integer) and \
                    t_in.quant is not None and t_in.quant.quantized:
                s = float(t_in.quant.scale[0])
                z = float(t_in.quant.zero_point[0])
                x = (x.to(cd) - z) * s
            else:
                x = x.to(cd)
            env[idx] = x

        for k, op in enumerate(m.operators):
            o = op.options
            outs = op.outputs
            a = env[op.inputs[0]] if op.inputs and op.inputs[0] >= 0 else None
            if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                w, b = self._weights.get(k) or self._layout(op, env)
                groups = a.shape[-1] if op.name == "DEPTHWISE_CONV_2D" else 1
                y = _act(_conv_nhwc(a, w, b, o, groups), o.get("activation"))
            elif op.name in ("ADD", "MUL", "SUB"):
                b = env[op.inputs[1]]
                y = {"ADD": torch.add, "MUL": torch.mul, "SUB": torch.sub}[op.name](a, b)
                y = _act(y, o.get("activation"))
            elif op.name in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
                y = _act(_pool_nhwc(a, o, op.name), o.get("activation"))
            elif op.name == "RESHAPE":
                shape = list(m.tensors[outs[0]].shape)
                if shape:
                    shape[0] = a.shape[0]  # batch-general
                y = a.reshape(shape)
            elif op.name == "SQUEEZE":
                y = a.reshape(m.tensors[outs[0]].shape)
            elif op.name == "SOFTMAX":
                y = torch.softmax(a * o.get("beta", 1.0), dim=-1)
            elif op.name == "LOGISTIC":
                y = torch.sigmoid(a)
            elif op.name == "RESIZE_BILINEAR":
                size = self._host[op.inputs[1]]
                y = _resize_bilinear(a, int(size[0]), int(size[1]),
                                     o.get("align_corners", False),
                                     o.get("half_pixel_centers", False))
            elif op.name == "CONCATENATION":
                y = torch.cat([env[i] for i in op.inputs], dim=o.get("axis", -1))
                y = _act(y, o.get("activation"))
            elif op.name == "FULLY_CONNECTED":
                w, b = self._weights.get(k) or self._layout(op, env)
                y = F.linear(a.reshape(a.shape[0], -1), w, b)
                y = _act(y, o.get("activation"))
            elif op.name == "MEAN":
                axes = tuple(int(v) for v in np.atleast_1d(self._host[op.inputs[1]]))
                y = torch.mean(a, dim=axes, keepdim=o.get("keep_dims", False))
            elif op.name == "PAD":
                pads = self._host[op.inputs[1]]
                flat: List[int] = []
                for lo, hi in reversed([(int(lo), int(hi)) for lo, hi in pads]):
                    flat += [lo, hi]
                y = F.pad(a, flat)
            elif op.name == "DEQUANTIZE":
                y = a  # constants were dequantized at build time
            else:
                raise NotImplementedError(f"tflite op {op.name} (code {op.opcode})")
            if self.fake_quant:
                y = _qdq(y, m.tensors[outs[0]])
            env[outs[0]] = y
        return [env[oi].to(torch.float32) for oi in m.outputs]

    def _layout(self, op: Operator, env) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """A weight the graph computes, laid out as :meth:`_prepare_weights`
        lays out a constant one."""
        w = env[op.inputs[1]]
        if op.name == "CONV_2D":
            w = w.permute(0, 3, 1, 2)
        elif op.name == "DEPTHWISE_CONV_2D":
            w = w.permute(3, 0, 1, 2)
        b = env[op.inputs[2]] if len(op.inputs) > 2 and op.inputs[2] >= 0 else None
        return w, b

    def trace(self, *xs: torch.Tensor) -> List[torch.Tensor]:
        """The program's body over device tensors, without capture: a fused
        segment takes it whole with the ops around it."""
        return self._run(xs)

    def __call__(self, *xs) -> List[torch.Tensor]:
        ins = [torch.as_tensor(x).to(self.device) for x in xs]
        with torch.inference_mode():
            return self._run(ins)


def compile_tflite(path: str, **kw) -> TFLiteProgram:
    """Parse a .tflite file and build its program (``kw``: fake_quant,
    compute_dtype, device)."""
    return TFLiteProgram(path, **kw)
