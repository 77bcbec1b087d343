"""Host-side rasterization for egress decoders.

The counterpart of ``nnstreamer_tpu/decoders/render.py`` (reference
tensordecutil.c: label loading, label text; the box drawing of
tensordec-boundingbox.c). The post-processing (thresholding, NMS) already
ran on the device (ops/detection.py); what remains here is drawing RGBA
overlays on numpy canvases, which the reference also does pixel by pixel
on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# Red 100% in RGBA — the reference's box color (tensordec-boundingbox.c:128)
PIXEL_RGBA = (255, 0, 0, 255)


def load_labels(path: str) -> List[str]:
    """One label per line (tensordecutil.c loadImageLabels)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def as_tensor(t) -> torch.Tensor:
    """A frame tensor as a torch tensor where it is (numpy → CPU tensor)."""
    return t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))


def parse_wh(s: str, what: str) -> Tuple[int, int]:
    """Parse a WIDTH:HEIGHT decoder option."""
    from nnstreamer_tpu_torch.elements.base import NegotiationError

    parts = s.split(":")
    if len(parts) < 2:
        raise NegotiationError(f"{what} must be WIDTH:HEIGHT, got {s!r}")
    return int(parts[0]), int(parts[1])


def new_canvas(width: int, height: int) -> np.ndarray:
    """Transparent RGBA canvas: the reference decoders draw on a
    transparent background for compositing downstream."""
    return np.zeros((height, width, 4), np.uint8)


def draw_rect(
    canvas: np.ndarray,
    x1: int,
    y1: int,
    x2: int,
    y2: int,
    color: Tuple[int, int, int, int] = PIXEL_RGBA,
    thickness: int = 1,
) -> None:
    h, w = canvas.shape[:2]
    x1, x2 = sorted((int(np.clip(x1, 0, w - 1)), int(np.clip(x2, 0, w - 1))))
    y1, y2 = sorted((int(np.clip(y1, 0, h - 1)), int(np.clip(y2, 0, h - 1))))
    t = max(1, thickness)
    canvas[y1 : y1 + t, x1 : x2 + 1] = color
    canvas[max(y2 - t + 1, 0) : y2 + 1, x1 : x2 + 1] = color
    canvas[y1 : y2 + 1, x1 : x1 + t] = color
    canvas[y1 : y2 + 1, max(x2 - t + 1, 0) : x2 + 1] = color


def draw_line(
    canvas: np.ndarray,
    x1: int,
    y1: int,
    x2: int,
    y2: int,
    color: Tuple[int, int, int, int] = PIXEL_RGBA,
) -> None:
    """Bresenham (tensordec-pose.c skeleton edges)."""
    h, w = canvas.shape[:2]
    x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
    dx, dy = abs(x2 - x1), -abs(y2 - y1)
    sx = 1 if x1 < x2 else -1
    sy = 1 if y1 < y2 else -1
    err = dx + dy
    while True:
        if 0 <= x1 < w and 0 <= y1 < h:
            canvas[y1, x1] = color
        if x1 == x2 and y1 == y2:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x1 += sx
        if e2 <= dx:
            err += dx
            y1 += sy


def draw_point(
    canvas: np.ndarray,
    x: int,
    y: int,
    radius: int = 2,
    color: Tuple[int, int, int, int] = PIXEL_RGBA,
) -> None:
    h, w = canvas.shape[:2]
    x, y = int(x), int(y)
    y0, y1 = max(0, y - radius), min(h, y + radius + 1)
    x0, x1 = max(0, x - radius), min(w, x + radius + 1)
    canvas[y0:y1, x0:x1] = color


def draw_text(
    canvas: np.ndarray,
    text: str,
    x: int,
    y: int,
    color: Tuple[int, int, int, int] = PIXEL_RGBA,
) -> None:
    """Rasterize a small label string with PIL's built-in bitmap font (the
    role of the reference's 8x13 ASCII sprites, font.c). Without PIL this
    raises: a label the caller asked for is never dropped quietly."""
    if not text:
        return
    try:
        from PIL import Image, ImageDraw
    except ImportError as exc:
        raise ImportError(
            "drawing detection labels needs Pillow (PIL); leave out the "
            "labels option to draw boxes only"
        ) from exc
    img = Image.fromarray(canvas, "RGBA")
    ImageDraw.Draw(img).text((int(x), int(y)), text, fill=tuple(color))
    canvas[:] = np.asarray(img)


def render_detections(
    detections: np.ndarray,
    width: int,
    height: int,
    labels: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """[N, 6] (x1, y1, x2, y2, class, score) normalized → RGBA overlay,
    with the label drawn above each box like the reference's draw_label."""
    canvas = new_canvas(width, height)
    for row in np.asarray(detections, np.float32):
        x1, y1, x2, y2, cls, score = row
        if score <= 0:
            continue
        draw_rect(canvas, x1 * width, y1 * height, x2 * width, y2 * height)
        if labels:
            ci = int(cls)
            name = labels[ci] if 0 <= ci < len(labels) else str(ci)
            draw_text(canvas, name, x1 * width, max(y1 * height - 12, 0))
    return canvas


def voc_colormap(num_labels: int = 21) -> np.ndarray:
    """The Pascal-VOC palette (the deeplab colours; the reference's
    image-segment decoder sets grey or random ones)."""
    cmap = np.zeros((num_labels, 3), np.uint8)
    for i in range(num_labels):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def render_segmentation(label_map: np.ndarray, num_labels: int = 21) -> np.ndarray:
    """[H, W] uint8 label map → RGBA (label 0, the background, transparent)."""
    cmap = voc_colormap(max(num_labels, int(label_map.max()) + 1))
    rgb = cmap[label_map]
    alpha = np.where(label_map > 0, 255, 0).astype(np.uint8)[..., None]
    return np.concatenate([rgb, alpha], axis=-1)
