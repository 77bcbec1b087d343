"""Logging shim (the counterpart of ``nnstreamer_tpu/log.py``): stdlib
logging under one framework-wide logger tree."""

from __future__ import annotations

import logging
import os

_ROOT = logging.getLogger("nnstreamer_tpu_torch")
if not _ROOT.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname).1s: %(message)s")
    )
    _ROOT.addHandler(_h)
    _ROOT.setLevel(os.environ.get("NNS_TPU_LOG_LEVEL", "WARNING").upper())


def get_logger(name: str = "") -> logging.Logger:
    return _ROOT.getChild(name) if name else _ROOT
