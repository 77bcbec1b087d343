"""Greedy NMS suppression: the CUDA kernel K2 and its plain version.

Replaces the Pallas TPU kernel ``nnstreamer_tpu/ops/pallas/nms.py``
(``nms``, body ``_nms_kernel``). The kernel is ``csrc/nms.cu`` (CUDA C++
for ``sm_90a``, built by ``nvcc`` at first use and bound with ``ctypes``):
a parallel IoU bitmask over 64 x 64 tiles, then a one-block scan over its
64-bit words; its design and its bound are noted there.
:func:`plain_nms_bitmask` is that design's plain twin, and
:func:`nms_plan` gives its launch.

Both take the boxes already ranked by score and return the alive mask of
the greedy recurrence; ranking and top-k packing stay outside, in
``ops/detection.py nms``, as the JAX package keeps them outside Pallas.

Dispatch is by the device of the boxes, nothing else: a CUDA tensor
launches the kernel (and raises if the launch fails or ``n`` exceeds
:data:`MAX_N`), a CPU tensor takes :func:`plain_nms_mask`, anything else
raises. There is no fallback from the kernel to the plain version.

The kernel pair is the custom op ``nns::nms_mask`` over rows of
candidates (boxes [..., n, 4], scores [..., n]), with a fake (shapes
alone, for fake-tensor traces) and a vmap rule: under
``torch.func.vmap`` a window of B frames is ONE mask launch of grid
(tiles, B) and one scan of B blocks, each row's words in its own slice of
the workspace (the reference vmaps its ``pallas_call``). On the CPU the
rule runs the plain version row by row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from nnstreamer_tpu_torch.ops.kernels import LaunchCounter

#: the most candidates the kernel takes (the scan keeps one bit each, 4 KB,
#: in shared memory); the 25,200 rows of a YOLOv5 head at 640x640 fit
MAX_N = 32768
#: candidates a mask word holds (rows and columns of a mask tile)
WORD_BITS = 64

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


#: the most rows one launch takes (the mask kernel's grid y extent)
MAX_ROWS = 65535


class NmsPlan(NamedTuple):
    """The kernel's launch for ``rows`` rows of ``n`` candidates."""

    words: int  #: 64-bit mask words a candidate (``ceil(n / 64)``)
    tiles: int  #: 64 x 64 tiles of a row's upper triangle: the mask grid's x extent
    workspace_bytes: int  #: the words, [rows, n, words] of 8 bytes


def nms_plan(n: int, rows: int = 1) -> NmsPlan:
    """Words, mask tiles and workspace bytes for ``rows`` rows of ``n``
    candidates."""
    words = -(-n // WORD_BITS)
    return NmsPlan(words, words * (words + 1) // 2, 8 * rows * n * words)


_M64 = (1 << 64) - 1
_ROW_CHUNK = 1024  # rows of IoUs the twin's mask pass holds at once
#: the value of each bit of an int64 word; bit 63 is the sign bit
_BIT_VALUES = tuple(1 << k for k in range(63)) + (-(1 << 63),)


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool [r, 64·w] → int64 [r, w]: bit k of word c is column 64c + k.
    The bits are disjoint, so their sum is their OR (bit 63 adds -2^63)."""
    values = torch.tensor(_BIT_VALUES, dtype=torch.int64, device=bits.device)
    return (bits.reshape(bits.shape[0], -1, WORD_BITS).to(torch.int64) * values).sum(-1)


def plain_nms_bitmask(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the kernel's design, same inputs as
    :func:`plain_nms_mask` → (words int64 [n, ceil(n/64)], alive [n] bool).

    Mask pass: bit k of ``words[i, c]`` is set iff ``64c + k > i`` and
    IoU(i, 64c + k) > thr, the IoU in the kernel's float order (every row,
    here, where the kernel writes the live rows' words right of the
    diagonal). Scan: the "removed" bits start as ``score <= 0``; word block
    by word block up to the live prefix m, the 64 candidates are resolved in
    order (kept iff not removed; keeping one ORs its row's word of the
    block in), then the kept rows' words for the later blocks are ORed into
    "removed". A word read as a Python int is masked to 64 bits first (an
    int64 with bit 63 set is negative). ``alive`` equals
    :func:`plain_nms_mask` for any input."""
    n = boxes.shape[0]
    nw = nms_plan(n).words
    x1, y1, x2, y2 = boxes.unbind(1)
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    cols = torch.arange(nw * WORD_BITS, device=boxes.device)
    pad = nw * WORD_BITS - n
    words = torch.zeros((n, nw), dtype=torch.int64, device=boxes.device)
    for a in range(0, n, _ROW_CHUNK):
        r = slice(a, min(a + _ROW_CHUNK, n))
        iou = _iou_row(
            x1[None], y1[None], x2[None], y2[None], area[None],
            x1[r, None], y1[r, None], x2[r, None], y2[r, None], area[r, None],
        )
        bits = torch.nn.functional.pad(iou > thr, (0, pad))
        bits &= cols[None] > torch.arange(a, r.stop, device=boxes.device)[:, None]
        words[r] = _pack_words(bits)

    live = scores > 0.0
    idx = torch.nonzero(live)
    m = int(idx[-1]) + 1 if len(idx) else 0
    nb = -(-m // WORD_BITS)
    live_words = _pack_words(torch.nn.functional.pad(live, (0, pad))[None])[0]
    removed = [~int(w) & _M64 for w in live_words[:nb].tolist()]
    kept = []
    for c in range(nb):
        first = WORD_BITS * c
        diag = [int(w) & _M64 for w in words[first:first + WORD_BITS, c].tolist()]
        cur, block = removed[c], []
        for t, d in enumerate(diag):
            if not (cur >> t) & 1:
                block.append(first + t)
                cur |= d
        if block and c + 1 < nb:
            acc = words[block[0], c + 1:nb].clone()
            for i in block[1:]:
                acc |= words[i, c + 1:nb]
            for k, w in enumerate(acc.tolist()):
                removed[c + 1 + k] |= w & _M64
        kept += block
    alive = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    alive[kept] = True
    return words, alive


@functools.cache
def _kernel_fn():
    """``nns_nms_mask`` from the built library, with its C signature (set
    once, at the first launch)."""
    from nnstreamer_tpu_torch.ops.kernels import _build

    fn = _build.load("nms").nns_nms_mask
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _cuda_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    words: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel pair on contiguous float32 CUDA tensors, boxes
    [n, 4] and scores [n], or R rows of them ([R, n, 4], [R, n]) → (alive
    [n] or [R, n] float32 0/1, live [1] or [R] int32: each row's m, the
    live prefix the scan walked in ceil(m/64) word blocks), both still
    being computed. Reading ``live`` waits for the kernels. ``words`` is
    the int64 [n, ceil(n/64)] (or [R, n, ceil(n/64)]) workspace, allocated
    here when not given (a caller that passes one can read the words the
    mask kernel wrote)."""
    batched = boxes.dim() == 3
    rows = boxes.shape[0] if batched else 1
    n = boxes.shape[-2]
    if n > MAX_N:
        raise ValueError(f"nms kernel takes at most {MAX_N} candidates, got {n}")
    if rows > MAX_ROWS:
        raise ValueError(f"nms kernel takes at most {MAX_ROWS} rows a launch, got {rows}")
    if boxes.data_ptr() % 16:
        raise ValueError("nms kernel needs 16-byte aligned boxes")
    nw = nms_plan(n).words
    lead = boxes.shape[:-2]
    if words is not None and (
        words.shape != lead + (n, nw) or words.dtype != torch.int64
        or words.device != boxes.device or not words.is_contiguous()
    ):
        raise ValueError(f"nms workspace must be contiguous int64 {list(lead) + [n, nw]} "
                         f"on {boxes.device}")
    fn = _kernel_fn()
    if words is None:
        words = torch.empty(lead + (n, nw), dtype=torch.int64, device=boxes.device)
    alive = torch.empty(lead + (n,), dtype=torch.float32, device=boxes.device)
    live = torch.empty((rows,), dtype=torch.int32, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(
            boxes.data_ptr(), scores.data_ptr(), words.data_ptr(), alive.data_ptr(),
            live.data_ptr(), rows, n, float(iou_threshold), stream,
        )
    if err != 0:
        raise RuntimeError(f"nns_nms_mask launch failed: cudaError_t {err}")
    nms_launches.add()
    return alive, live


@torch.library.custom_op("nns::nms_mask", mutates_args=())
def _nms_mask_op(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """K2 on checked float32 operands: score-ranked boxes [..., n, 4] and
    scores [..., n], each leading index an independent row → alive [..., n]
    bool. On CUDA one launch of the pair for every row; on the CPU the
    plain version, row by row."""
    if scores.numel() == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=boxes.device)
    n = scores.shape[-1]
    b3 = boxes.reshape(-1, n, 4).contiguous()
    s2 = scores.reshape(-1, n).contiguous()
    if boxes.is_cuda:
        one = scores.dim() == 1  # a frame: the single-row launch
        alive, _ = _cuda_nms(b3[0] if one else b3, s2[0] if one else s2, iou_threshold)
        return (alive > 0.0).reshape(scores.shape)
    if boxes.device.type == "cpu":
        return torch.stack([plain_nms_mask(b, s, iou_threshold)
                            for b, s in zip(b3, s2)]).reshape(scores.shape)
    raise RuntimeError(
        f"nms kernel has no implementation on {boxes.device} "
        "(CUDA launches the kernel, CPU takes the plain version)"
    )


@_nms_mask_op.register_fake
def _(boxes, scores, iou_threshold):
    return scores.new_empty(scores.shape, dtype=torch.bool)


@_nms_mask_op.register_vmap
def _(info, in_dims, boxes, scores, iou_threshold):
    """The vmapped axis becomes the op's leading row axis: one launch of
    the pair for the window's B rows (an operand the rows share is
    expanded to them)."""
    bsz = info.batch_size
    boxes_dim, scores_dim = in_dims[0], in_dims[1]
    boxes = (boxes.movedim(boxes_dim, 0) if boxes_dim is not None
             else boxes.expand((bsz,) + boxes.shape))
    scores = (scores.movedim(scores_dim, 0) if scores_dim is not None
              else scores.expand((bsz,) + scores.shape))
    return _nms_mask_op(boxes, scores, iou_threshold), 0


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
    if boxes.device.type not in ("cuda", "cpu"):
        raise RuntimeError(
            f"nms kernel has no implementation on {boxes.device} "
            "(CUDA launches the kernel, CPU takes the plain version)"
        )
    return _nms_mask_op(boxes.to(torch.float32), scores.to(torch.float32), float(iou_threshold))
