"""Shared host-side helpers for egress decoders (the label loader of
``nnstreamer_tpu/decoders/render.py``; reference tensordecutil.c)."""

from __future__ import annotations

from typing import List


def load_labels(path: str) -> List[str]:
    """One label per line (tensordecutil.c loadImageLabels)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]
