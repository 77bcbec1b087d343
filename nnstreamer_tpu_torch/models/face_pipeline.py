"""Face detection and landmark models: the detect → crop → landmark cascade.

The counterpart of ``nnstreamer_tpu/models/face_pipeline.py``. Three zoo
models come from it:

- ``face_detect``: uint8 [1, 128, 128, 3] → OV detection rows
  [max_faces, 7] (image_id, label, conf, x1, y1, x2, y2, normalized), or
  with ``output=regions`` int32 pixel (x, y, w, h) regions [max_faces, 4]
  that feed ``tensor_crop``, or (image, regions) with
  ``output=regions+image``. An anchor-free head on an 8×8 grid; the box
  decode and the top-k run on the device.
- ``face_landmark``: uint8 (or float) [N, 112, 112, 3] crops → [N, 136]
  (x, y) pairs of 68 landmarks in [0, 1]; the trunk is pooled globally,
  so any crop size of 16 or more works.
- ``face_composite``: detect → crop+resize of the normalized image to
  112² through K1's crop entry (``ops/image.crop_and_resize``) → landmark
  on all ``max_faces`` crops as one batch, rows below ``threshold``
  zeroed: (landmarks [max_faces, 136], detections [max_faces, 7]).

The top-k keeps ``jax.lax.top_k``'s order: scores descending, equal
scores by index. The weights are random from a ``torch.Generator`` seed,
or carried over from the reference's trees (:func:`detect_leaf_paths`,
:func:`landmark_leaf_paths`, :func:`composite_leaf_paths`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from nnstreamer_tpu_torch.models.jax_weights import BIASED, CONV_BN, SEP_CONV, tree_paths
from nnstreamer_tpu_torch.models.nn import (
    BiasConv,
    ConvBN,
    SepConv,
    image_input,
    init_dense,
    nhwc,
    normalize_uint8,
)
from nnstreamer_tpu_torch.ops.detection import argsort_desc, true_div

MAX_FACES = 16
DETECT_SIZE = 128
LANDMARK_SIZE = 112
NUM_LANDMARKS = 68

# detector trunk: (out_channels, stride) sep-conv plan, 128 → 8 grid
_DET_BLOCKS = ((32, 2), (64, 1), (64, 2), (128, 1), (128, 2), (128, 1))
# landmark trunk: 112 → 7
_LMK_BLOCKS = ((32, 2), (64, 2), (128, 2), (128, 1))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest of a 1-D ``x``, descending,
    equal values by index (``jax.lax.top_k``'s order; ``torch.topk`` does
    not promise one)."""
    idx = argsort_desc(x)[:k]
    return x[idx], idx


def _trunk(cin: int, plan, generator) -> Tuple[ConvBN, nn.ModuleList]:
    stem = ConvBN(3, cin, 3, stride=2, generator=generator)
    blocks = []
    for cout, stride in plan:
        blocks.append(SepConv(cin, cout, stride, generator=generator))
        cin = cout
    return stem, nn.ModuleList(blocks)


class FaceDetect(nn.Module):
    """uint8/float NHWC [N, 128, 128, 3] → [max_faces, 7] OV rows of the
    first image (the reference's batch-1 semantics), float32."""

    def __init__(self, max_faces: int = MAX_FACES,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.max_faces = max_faces
        self.stem, self.blocks = _trunk(16, _DET_BLOCKS, generator)
        # per-cell head: (objectness, dy, dx, dh, dw)
        self.head = BiasConv(_DET_BLOCKS[-1][0], 5, 3, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem(image_input(x, self.stem.weight.dtype))
        for blk in self.blocks:
            y = blk(y)
        head = nhwc(self.head(y)).to(torch.float32)
        g = head.shape[1]
        head = head.reshape(head.shape[0], g * g, 5)[0]  # batch 1
        conf = torch.sigmoid(head[:, 0])
        cell = torch.arange(g * g, device=head.device)
        rows = torch.div(cell, g, rounding_mode="floor").to(torch.float32)
        cols = (cell % g).to(torch.float32)
        # cell-anchored decode: centre = cell centre + tanh offset, size = sigmoid
        cy = true_div(rows + 0.5, g) + true_div(torch.tanh(head[:, 1]), g)
        cx = true_div(cols + 0.5, g) + true_div(torch.tanh(head[:, 2]), g)
        bh = torch.sigmoid(head[:, 3])
        bw = torch.sigmoid(head[:, 4])
        x1 = torch.clamp(cx - bw / 2, 0.0, 1.0)
        y1 = torch.clamp(cy - bh / 2, 0.0, 1.0)
        x2 = torch.clamp(cx + bw / 2, 0.0, 1.0)
        y2 = torch.clamp(cy + bh / 2, 0.0, 1.0)
        top_conf, idx = top_k(conf, self.max_faces)
        return torch.stack(
            [torch.zeros_like(top_conf), torch.ones_like(top_conf), top_conf,
             x1[idx], y1[idx], x2[idx], y2[idx]],
            dim=-1,
        )


def detections_to_regions(det: torch.Tensor, frame_w: int, frame_h: int,
                          threshold: float = 0.5) -> torch.Tensor:
    """[max, 7] OV rows → [max, 4] int32 pixel (x, y, w, h) for tensor_crop;
    rows below ``threshold`` become zero-size regions (the crop zeroes
    them). The float → int32 cast truncates toward zero, as the
    reference's ``astype``."""
    keep = det[:, 2] >= threshold
    out = torch.stack([
        det[:, 3] * frame_w,
        det[:, 4] * frame_h,
        (det[:, 5] - det[:, 3]) * frame_w,
        (det[:, 6] - det[:, 4]) * frame_h,
    ], dim=-1)
    return torch.where(keep[:, None], out, torch.zeros_like(out)).to(torch.int32)


class DetectRegions(nn.Module):
    """``face_detect output=regions`` (regions alone) or
    ``output=regions+image`` (the image passed through untouched, then the
    regions), the regions scaled to a ``frame_w`` × ``frame_h`` frame."""

    def __init__(self, detect: FaceDetect, frame_w: int, frame_h: int,
                 threshold: float = 0.5, with_image: bool = False) -> None:
        super().__init__()
        self.detect = detect
        self.frame_w, self.frame_h, self.threshold = frame_w, frame_h, threshold
        self.with_image = with_image

    def forward(self, image: torch.Tensor):
        regions = detections_to_regions(self.detect(image), self.frame_w, self.frame_h,
                                        self.threshold)
        return (image, regions) if self.with_image else regions


class FaceLandmark(nn.Module):
    """uint8/float NHWC crops [N, H, W, 3] (H, W ≥ 16) → [N, 136] float32
    in [0, 1]."""

    def __init__(self, num_landmarks: int = NUM_LANDMARKS,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.stem, self.blocks = _trunk(16, _LMK_BLOCKS, generator)
        self.fc = init_dense(_LMK_BLOCKS[-1][0], 2 * num_landmarks, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem(image_input(x, self.stem.weight.dtype))
        for blk in self.blocks:
            y = blk(y)
        y = y.mean(dim=(2, 3))  # global pool: the net takes any crop size
        return torch.sigmoid(self.fc(y)).to(torch.float32)


class FaceComposite(nn.Module):
    """The whole cascade on the device: uint8/float [1, H, W, 3] →
    (landmarks [max_faces, 136], detections [max_faces, 7]), float32.

    The detector's boxes (normalized x1, y1, x2, y2) scaled to pixels crop
    the image, normalized in the compute dtype, to 112² through K1's crop
    entry; the landmark net runs on all ``max_faces`` crops at once, and
    the rows whose confidence is under ``threshold`` are zeroed (they keep
    their top-k place)."""

    def __init__(self, detect: FaceDetect, landmark: FaceLandmark,
                 threshold: float = 0.5) -> None:
        super().__init__()
        self.detect, self.landmark, self.threshold = detect, landmark, threshold

    def forward(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        from nnstreamer_tpu_torch.ops.image import crop_and_resize

        det = self.detect(image)
        h, w = image.shape[1], image.shape[2]
        # normalized → pixel corners, column by column: no constant to upload
        boxes = torch.stack([det[:, 3] * w, det[:, 4] * h, det[:, 5] * w, det[:, 6] * h], -1)
        dtype = self.detect.stem.weight.dtype
        img = image[0]
        img = normalize_uint8(img, dtype) if img.dtype == torch.uint8 else img.to(dtype)
        crops = crop_and_resize(img, boxes, LANDMARK_SIZE, LANDMARK_SIZE)
        lmk = self.landmark(crops)
        keep = det[:, 2] >= self.threshold
        return torch.where(keep[:, None], lmk, torch.zeros_like(lmk)), det


# -- weights carried over from the JAX package --------------------------------


def _trunk_tree(n_blocks: int, top: str) -> dict:
    return {"stem": CONV_BN, "blocks": [SEP_CONV] * n_blocks, top: BIASED}


def detect_leaf_paths() -> List[Tuple]:
    """Leaf paths of ``init_detect_params``' tree in flatten order."""
    return tree_paths(_trunk_tree(len(_DET_BLOCKS), "head"))


def landmark_leaf_paths() -> List[Tuple]:
    """Leaf paths of ``init_landmark_params``' tree in flatten order."""
    return tree_paths(_trunk_tree(len(_LMK_BLOCKS), "fc"))


def composite_leaf_paths() -> List[Tuple]:
    """Leaf paths of the reference's ``face_composite`` tree, ``{"detect",
    "landmark"}``: the detector's leaves first, so an npz of the detector
    alone overlays the detector alone."""
    return tree_paths({"detect": _trunk_tree(len(_DET_BLOCKS), "head"),
                       "landmark": _trunk_tree(len(_LMK_BLOCKS), "fc")})
