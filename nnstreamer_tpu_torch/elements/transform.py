"""tensor_transform: elementwise and image ops on tensor streams.

The counterpart of ``nnstreamer_tpu/elements/transform.py``
(reference gst/nnstreamer/elements/gsttensor_transform.c). Every mode is a
torch expression that fuses into the adjacent segment, so preprocessing
runs on the device next to the filter.

Option-string syntax is reference-compatible (dim indices are the
reference's innermost-first; translated to canonical axes internally):

- mode=typecast option=TYPE
- mode=arithmetic option=[typecast:TYPE,][per-channel:true@DIM,]
    {add|sub|mul|div}:NUM[@CH_IDX][,...]
- mode=transpose option=D1:D2:D3:D4   (innermost-first permutation)
- mode=dimchg option=FROM:TO          (move innermost-first dim FROM to TO)
- mode=clamp option=MIN:MAX
- mode=stand option={default|dc-average}[:TYPE][,per-channel:true]

Applied to every tensor in the frame.

Image modes, through the K1 kernel (ops/image.py):

- mode=resize option=H:W — bilinear resize of every HWC/NHWC image
  tensor to H×W (dtype preserved).
- mode=crop-resize option=H:W — the frame is (image, boxes) in either
  order: image [H,W,C] or [1,H,W,C]; boxes [N,4] int (x,y,w,h) pixel
  regions (zero-size rows zero their crop), [N,4] float (x1,y1,x2,y2)
  pixels, [N,6] decoded detections or [N,7] OV rows (normalized coords,
  scaled by the image size). Emits ONE [N,H,W,C] crop batch in the image
  dtype.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    NegotiationError,
    PropSpec,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

_ARITH_OP = re.compile(
    r"^(typecast:(?P<cast>[a-z0-9]+)|per-channel:(?P<pc>true|false)(@(?P<pcdim>\d+))?|"
    r"(?P<op>add|sub|mul|div):(?P<num>-?[0-9.eE+-]+)(@(?P<ch>\d+))?)$"
)


def _ref_axis(canonical_rank: int, ref_dim: int) -> int:
    """Reference innermost-first dim index → canonical axis."""
    if ref_dim >= canonical_rank:
        raise NegotiationError(
            f"dim index {ref_dim} out of range for rank {canonical_rank}"
        )
    return canonical_rank - 1 - ref_dim


@registry.element("tensor_transform")
class TensorTransform(TensorOp):
    FACTORY_NAME = "tensor_transform"

    PROPERTIES = {
        "mode": PropSpec(
            "enum", None,
            ("typecast", "arithmetic", "transpose", "dimchg", "clamp",
             "stand", "resize", "crop-resize"),
        ),
        "option": PropSpec("str", "", desc="per-mode option string"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.mode = str(self.get_property("mode", "")).lower()
        self.option = str(self.get_property("option", ""))
        if self.mode not in (
            "typecast",
            "arithmetic",
            "transpose",
            "dimchg",
            "clamp",
            "stand",
            "resize",
            "crop-resize",
        ):
            raise ValueError(f"{self.name}: unknown mode {self.mode!r}")

    # -- negotiation -------------------------------------------------------
    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input, got {spec}")
        if self.mode == "crop-resize":
            # cross-tensor mode: (image, boxes) → one crop batch
            return [self._crop_resize_spec(spec)]
        outs = [self._transform_spec(t) for t in spec]
        return [TensorsSpec(tuple(outs), spec.format, spec.rate)]

    def _parse_hw(self) -> Tuple[int, int]:
        try:
            h, w = (int(x) for x in self.option.split(":"))
        except ValueError as exc:
            raise NegotiationError(
                f"{self.name}: bad {self.mode} size {self.option!r} "
                "(want H:W)"
            ) from exc
        if h <= 0 or w <= 0:
            raise NegotiationError(
                f"{self.name}: {self.mode} size must be positive, got "
                f"{h}:{w}"
            )
        return h, w

    def _crop_resize_layout(self, spec: TensorsSpec):
        """Resolve the (image, boxes) tensor roles statically from the
        negotiated spec: image is the rank-3 HWC / rank-4 [1,H,W,C]
        tensor, boxes the rank-2 [N, 4|6|7] one."""
        if spec.num_tensors != 2:
            raise NegotiationError(
                f"{self.name}: crop-resize needs (image, boxes), got "
                f"{spec.num_tensors} tensors"
            )
        img_idx = next(
            (i for i, t in enumerate(spec) if t.rank >= 3), None
        )
        if img_idx is None:
            raise NegotiationError(
                f"{self.name}: crop-resize found no image tensor "
                f"(rank ≥ 3) in {spec}"
            )
        box_idx = 1 - img_idx
        img, box = spec[img_idx], spec[box_idx]
        if img.rank == 4 and img.shape[0] not in (1, None):
            raise NegotiationError(
                f"{self.name}: crop-resize crops one image per frame "
                f"(batch {img.shape[0]})"
            )
        if img.rank not in (3, 4):
            raise NegotiationError(
                f"{self.name}: image must be HWC or [1,H,W,C], got {img}"
            )
        if box.rank != 2 or box.shape[-1] not in (4, 6, 7):
            raise NegotiationError(
                f"{self.name}: boxes must be [N, 4|6|7] (pixel regions, "
                f"decoded detections, or OV rows), got {box}"
            )
        return img_idx, box_idx

    def _crop_resize_spec(self, spec: TensorsSpec) -> TensorsSpec:
        h, w = self._parse_hw()
        img_idx, box_idx = self._crop_resize_layout(spec)
        img, box = spec[img_idx], spec[box_idx]
        c = img.shape[-1]
        out = TensorSpec((box.shape[0], h, w, c), img.dtype, name="crops")
        return TensorsSpec.of(out, rate=spec.rate)

    def _transform_spec(self, t: TensorSpec) -> TensorSpec:
        m = self.mode
        if m == "typecast":
            return t.with_dtype(DType.from_any(self.option))
        if m == "arithmetic":
            cast, _, _, _ = self._parse_arith()
            return t.with_dtype(cast) if cast else t
        if m == "transpose":
            perm = self._canonical_perm(t.rank)
            return t.with_shape(tuple(t.shape[a] for a in perm))
        if m == "dimchg":
            src, dst = self._parse_dimchg(t.rank)
            shape = list(t.shape)
            shape.insert(dst, shape.pop(src))
            return t.with_shape(tuple(shape))
        if m == "clamp":
            self._parse_clamp()
            return t
        if m == "stand":
            _, _, out_type = self._parse_stand()
            if out_type:
                return t.with_dtype(out_type)
            return t if t.dtype.is_float else t.with_dtype(DType.FLOAT32)
        if m == "resize":
            h, w = self._parse_hw()
            if t.rank == 3:
                return t.with_shape((h, w, t.shape[2]))
            if t.rank == 4:
                return t.with_shape((t.shape[0], h, w, t.shape[3]))
            raise NegotiationError(
                f"{self.name}: resize needs HWC/NHWC image tensors, "
                f"got {t}"
            )
        raise AssertionError(m)

    # -- option parsing ----------------------------------------------------
    def _parse_arith(self):
        cast: Optional[DType] = None
        per_channel = False
        pc_axis_ref = 0
        ops: List[Tuple[str, float, Optional[int]]] = []
        for part in self.option.split(","):
            part = part.strip()
            if not part:
                continue
            m = _ARITH_OP.match(part)
            if not m:
                raise NegotiationError(f"{self.name}: bad arithmetic option {part!r}")
            if m.group("cast"):
                cast = DType.from_any(m.group("cast"))
            elif m.group("pc"):
                per_channel = m.group("pc") == "true"
                if m.group("pcdim"):
                    pc_axis_ref = int(m.group("pcdim"))
            else:
                ch = int(m.group("ch")) if m.group("ch") else None
                ops.append((m.group("op"), float(m.group("num")), ch))
        return cast, per_channel, pc_axis_ref, ops

    def _canonical_perm(self, rank: int) -> Tuple[int, ...]:
        ref_perm = [int(p) for p in self.option.split(":") if p != ""]
        if sorted(ref_perm) != list(range(len(ref_perm))):
            raise NegotiationError(f"{self.name}: bad transpose {self.option!r}")
        while len(ref_perm) < rank:
            ref_perm.append(len(ref_perm))
        # out canonical axis a = in canonical axis rank-1-ref_perm[rank-1-a]
        return tuple(rank - 1 - ref_perm[rank - 1 - a] for a in range(rank))

    def _parse_dimchg(self, rank: int) -> Tuple[int, int]:
        try:
            frm, to = (int(x) for x in self.option.split(":"))
        except ValueError as exc:
            raise NegotiationError(f"{self.name}: bad dimchg {self.option!r}") from exc
        return _ref_axis(rank, frm), _ref_axis(rank, to)

    def _parse_clamp(self) -> Tuple[float, float]:
        try:
            lo, hi = (float(x) for x in self.option.split(":"))
        except ValueError as exc:
            raise NegotiationError(f"{self.name}: bad clamp {self.option!r}") from exc
        if lo > hi:
            raise NegotiationError(f"{self.name}: clamp min {lo} > max {hi}")
        return lo, hi

    def _parse_stand(self):
        mode, per_channel, out_type = "default", False, None
        for i, part in enumerate(p.strip() for p in self.option.split(",")):
            if not part:
                continue
            if part.startswith("per-channel:"):
                per_channel = part.split(":", 1)[1] == "true"
                continue
            bits = part.split(":")
            mode = bits[0] or "default"
            if len(bits) > 1:
                out_type = DType.from_any(bits[1])
        if mode not in ("default", "dc-average"):
            raise NegotiationError(f"{self.name}: bad stand mode {mode!r}")
        return mode, per_channel, out_type

    # -- fused fn ----------------------------------------------------------
    def make_fn(self) -> Callable:
        mode = self.mode
        in_spec: TensorsSpec = self.in_specs[0]
        out_spec: TensorsSpec = self.out_specs[0]

        if mode == "typecast":
            dt = DType.from_any(self.option).torch_dtype

            def fn(tensors):
                return tuple(t.to(dt) for t in tensors)

        elif mode == "arithmetic":
            cast, per_channel, pc_axis_ref, ops = self._parse_arith()

            def apply_one(x, rank):
                y = x.to(cast.torch_dtype) if cast is not None else x
                axis = _ref_axis(rank, pc_axis_ref) if per_channel else None
                for op, num, ch in ops:
                    if ch is not None and axis is not None:
                        # per-channel constant applied to one channel index
                        sel = [slice(None)] * rank
                        sel[axis] = ch
                        upd = _arith(y[tuple(sel)], op, num)
                        y = y.clone() if upd.dtype == y.dtype else y.to(upd.dtype)
                        y[tuple(sel)] = upd
                    else:
                        y = _arith(y, op, num)
                return y

            def fn(tensors):
                return tuple(
                    apply_one(t, s.rank) for t, s in zip(tensors, in_spec)
                )

        elif mode == "transpose":
            perms = [self._canonical_perm(s.rank) for s in in_spec]

            def fn(tensors):
                return tuple(t.permute(p) for t, p in zip(tensors, perms))

        elif mode == "dimchg":
            moves = [self._parse_dimchg(s.rank) for s in in_spec]

            def fn(tensors):
                return tuple(
                    torch.movedim(t, s, d) for t, (s, d) in zip(tensors, moves)
                )

        elif mode == "clamp":
            lo, hi = self._parse_clamp()

            def fn(tensors):
                return tuple(
                    torch.clamp(t, *_clamp_bounds(t, lo, hi)) for t in tensors
                )

        elif mode == "resize":
            out_h, out_w = self._parse_hw()
            from nnstreamer_tpu_torch.ops.image import resize_bilinear

            def fn(tensors):
                return tuple(resize_bilinear(t, out_h, out_w) for t in tensors)

        elif mode == "crop-resize":
            out_h, out_w = self._parse_hw()
            img_idx, box_idx = self._crop_resize_layout(in_spec)
            img_spec, box_spec = in_spec[img_idx], in_spec[box_idx]
            img_rank4 = img_spec.rank == 4
            ih, iw = (
                img_spec.shape[1:3] if img_rank4 else img_spec.shape[0:2]
            )
            bcols = box_spec.shape[-1]
            box_is_int = not box_spec.dtype.is_float
            out_dtype = img_spec.dtype.torch_dtype
            from nnstreamer_tpu_torch.ops.image import crop_regions

            def fn(tensors):
                img = tensors[img_idx]
                if img_rank4:
                    img = img[0]
                b = tensors[box_idx].to(torch.float32)
                scale = torch.tensor(
                    [iw, ih, iw, ih], dtype=torch.float32, device=b.device
                )
                if bcols == 4 and box_is_int:
                    # tensor_crop pixel regions (x, y, w, h)
                    xyxy = torch.cat([b[:, :2], b[:, :2] + b[:, 2:4]], dim=-1)
                    valid = (b[:, 2] > 0) & (b[:, 3] > 0)
                elif bcols == 4:
                    xyxy = b  # pixel x1,y1,x2,y2 — all rows live
                    valid = None
                elif bcols == 6:
                    # decoded detections (normalized; score col 5)
                    xyxy = b[:, :4] * scale
                    valid = b[:, 5] > 0
                else:
                    # OV rows (image_id, label, conf, x1, y1, x2, y2)
                    xyxy = b[:, 3:7] * scale
                    valid = b[:, 2] > 0
                return (crop_regions(
                    img, xyxy.contiguous(), out_h, out_w,
                    valid=valid, out_dtype=out_dtype,
                ),)

        elif mode == "stand":
            smode, per_channel, out_type = self._parse_stand()

            def stand_one(x, out_dtype):
                y = x.to(torch.float32)
                dims = tuple(range(y.dim() - 1)) if per_channel else None
                mean = y.mean(dim=dims, keepdim=per_channel)
                if smode == "default":
                    # population std as jnp.std computes it
                    d = y - mean
                    std = torch.sqrt((d * d).mean(dim=dims, keepdim=per_channel))
                    y = (y - mean) / (std + 1e-10)
                else:  # dc-average
                    y = y - mean
                return y.to(out_dtype)

            def fn(tensors):
                return tuple(
                    stand_one(t, s.dtype.torch_dtype)
                    for t, s in zip(tensors, out_spec)
                )

        else:
            raise AssertionError(mode)
        return fn


def _arith(y: torch.Tensor, op: str, num: float) -> torch.Tensor:
    # the constant takes the operand's dtype (integers truncate it), as
    # jnp.asarray(num, dtype=y.dtype) does in the reference
    const = torch.tensor(num, dtype=torch.float64).to(y.dtype).to(y.device)
    if op == "add":
        return y + const
    if op == "sub":
        return y - const
    if op == "mul":
        return y * const
    if op == "div":
        # an expanded (not 0-d) divisor keeps this a true division: a
        # scalar divisor may be applied as a multiply by its reciprocal
        return y / const.expand_as(y)
    raise AssertionError(op)


def _clamp_bounds(t: torch.Tensor, lo: float, hi: float):
    # integer clamps round the bounds like the reference's typed clamp
    if not t.dtype.is_floating_point:
        return int(lo), int(hi)
    return lo, hi
