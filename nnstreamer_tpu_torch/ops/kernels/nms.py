"""Greedy NMS suppression: the CUDA kernel K2 and its plain version.

Replaces the Pallas TPU kernel ``nnstreamer_tpu/ops/pallas/nms.py``
(``nms``, body ``_nms_kernel``). The kernel is ``csrc/nms.cu`` (CUDA C++
for ``sm_90a``, built by ``nvcc`` at first use and bound with ``ctypes``);
its design and its bound are noted there.

Both take the boxes already ranked by score and return the alive mask of
the greedy recurrence; ranking and top-k packing stay outside, in
``ops/detection.py nms``, as the JAX package keeps them outside Pallas.

Dispatch is by the device of the boxes, nothing else: a CUDA tensor
launches the kernel (and raises if the launch fails or ``n`` exceeds
:data:`MAX_N`), a CPU tensor takes :func:`plain_nms_mask`, anything else
raises. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from nnstreamer_tpu_torch.ops.kernels import LaunchCounter

#: the most candidates the kernel takes (its alive flags fill 32 KB of
#: shared memory); the 25,200 rows of a YOLOv5 head at 640x640 fit
MAX_N = 32768

#: launches of the K2 CUDA kernel
nms_launches = LaunchCounter()


def _iou_row(x1, y1, x2, y2, area, bx1, by1, bx2, by2, barea):
    """IoU of the columns with one box, in the reference's float order."""
    iw = torch.clamp(torch.minimum(x2, bx2) - torch.maximum(x1, bx1), min=0.0)
    ih = torch.clamp(torch.minimum(y2, by2) - torch.maximum(y1, by1), min=0.0)
    inter = iw * ih
    union = area + barea - inter
    return torch.where(union > 0.0, inter / union, torch.zeros_like(inter))


def plain_nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``_nms_kernel``'s loop of
    masked IoU rows over score-ranked boxes [n, 4] (x1, y1, x2, y2) and
    scores [n], float32 → alive [n] bool. Candidates with score <= 0 start
    dead; since they rank last, the loop stops at the live prefix m."""
    x1, y1, x2, y2 = boxes.unbind(1)
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    alive = scores > 0.0
    live = torch.nonzero(alive)
    m = int(live[-1]) + 1 if len(live) else 0
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    for i in range(m):
        if not bool(alive[i]):
            continue
        j = slice(i + 1, m)
        iou = _iou_row(
            x1[j], y1[j], x2[j], y2[j], area[j],
            x1[i], y1[i], x2[i], y2[i], area[i],
        )
        alive[j] &= ~(iou > thr)
    return alive


@functools.cache
def _kernel_fn():
    """``nns_nms_mask`` from the built library, with its C signature (set
    once, at the first launch)."""
    from nnstreamer_tpu_torch.ops.kernels import _build

    fn = _build.load("nms").nns_nms_mask
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _cuda_nms(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on contiguous float32 CUDA tensors → (alive [n]
    float32 0/1, live [1] int32: m, the greedy steps walked), both still
    being computed. Reading ``live`` waits for the kernel."""
    n = boxes.shape[0]
    if n > MAX_N:
        raise ValueError(f"nms kernel takes at most {MAX_N} candidates, got {n}")
    if boxes.data_ptr() % 16:
        raise ValueError("nms kernel needs 16-byte aligned boxes")
    fn = _kernel_fn()
    alive = torch.empty((n,), dtype=torch.float32, device=boxes.device)
    live = torch.empty((1,), dtype=torch.int32, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(
            boxes.data_ptr(), scores.data_ptr(), alive.data_ptr(), live.data_ptr(),
            n, float(iou_threshold), stream,
        )
    if err != 0:
        raise RuntimeError(f"nns_nms_mask launch failed: cudaError_t {err}")
    nms_launches.add()
    return alive, live


def nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Score-ranked boxes [n, 4] and scores [n] → alive [n] bool: the
    kernel on a CUDA tensor, the plain version on a CPU tensor. Float
    inputs of another type are cast to float32 first."""
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"nms boxes must be [n, 4], got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:1]:
        raise ValueError(
            f"nms scores must be [{boxes.shape[0]}], got {tuple(scores.shape)}"
        )
    if not (boxes.dtype.is_floating_point and scores.dtype.is_floating_point):
        raise TypeError(f"nms takes float boxes and scores, got {boxes.dtype}, {scores.dtype}")
    if scores.device != boxes.device:
        raise ValueError(f"scores on {scores.device}, boxes on {boxes.device}")
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    if boxes.is_cuda:
        if boxes.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.bool, device=boxes.device)
        alive, _ = _cuda_nms(boxes, scores, iou_threshold)
        return alive > 0.0
    if boxes.device.type == "cpu":
        return plain_nms_mask(boxes, scores, iou_threshold)
    raise RuntimeError(
        f"nms kernel has no implementation on {boxes.device} "
        "(CUDA launches the kernel, CPU takes the plain version)"
    )
