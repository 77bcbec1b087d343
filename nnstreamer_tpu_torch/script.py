"""Loader for user python-script subplugins.

The counterpart of ``nnstreamer_tpu/script.py`` (the reference's
embedded-CPython subplugins: tensor_filter_python3.cc,
tensor_converter_python3, tensordec-python3). Scripts are plain python
modules loaded by path; the class name looked up per kind keeps one file
usable as several subplugin kinds at once. A script is handed numpy
arrays, as the reference's scripts are.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Sequence


def load_script_module(path: str, prefix: str):
    """Execute the python file at ``path`` as a fresh module."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"script not found: {path}")
    spec = importlib.util.spec_from_file_location(f"{prefix}_{abs(hash(path))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_script_object(path: str, class_names: Sequence[str]) -> Any:
    """Load ``path`` and instantiate the first matching class attribute."""
    module = load_script_module(path, "nns_tpu_torch_script")
    for name in class_names:
        obj = getattr(module, name, None)
        if obj is not None:
            return obj() if isinstance(obj, type) else obj
    raise AttributeError(f"{path} defines none of {list(class_names)}")
