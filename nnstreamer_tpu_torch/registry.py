"""Subplugin registry: name → implementation per subplugin kind.

The counterpart of ``nnstreamer_tpu/registry.py``, with a process-local
table of its own so the two packages can be imported side by side
without their element and backend names colliding. Lookups load lazily,
in order, on a miss:

1. built-in modules (``nnstreamer_tpu_torch.backends`` / ``.decoders`` /
   ``.elements``),
2. Python entry points (group ``nnstreamer_tpu_torch.<kind>``),
3. ``*.py`` files named ``nns_<kind>_<name>.py`` on the config search paths,
   executed and expected to call :func:`register`.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import threading
from typing import Any, Dict, List, Optional

from nnstreamer_tpu_torch.config import conf
from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("registry")

KIND_FILTER = "filter"
KIND_DECODER = "decoder"
KIND_CONVERTER = "converter"
KIND_ELEMENT = "element"
KINDS = (KIND_FILTER, KIND_DECODER, KIND_CONVERTER, KIND_ELEMENT)

_BUILTIN_MODULES: Dict[str, List[str]] = {
    KIND_FILTER: ["nnstreamer_tpu_torch.backends"],
    KIND_DECODER: ["nnstreamer_tpu_torch.decoders"],
    KIND_CONVERTER: [],
    KIND_ELEMENT: ["nnstreamer_tpu_torch.elements"],
}

_lock = threading.RLock()
_registry: Dict[str, Dict[str, Any]] = {k: {} for k in KINDS}
_builtins_loaded: Dict[str, bool] = {k: False for k in KINDS}


def register(kind: str, name: str, impl: Any, *, replace: bool = False) -> Any:
    """Register ``impl`` under ``name``; double registration is an error
    unless ``replace=True`` (or the same object is registered again)."""
    if kind not in KINDS:
        raise ValueError(f"unknown subplugin kind {kind!r}")
    name = name.lower()
    with _lock:
        if name in _registry[kind] and not replace:
            if _registry[kind][name] is impl:
                return impl
            raise ValueError(f"{kind} subplugin {name!r} already registered")
        _registry[kind][name] = impl
    return impl


def _load_builtins(kind: str) -> None:
    if _builtins_loaded[kind]:
        return
    _builtins_loaded[kind] = True
    for mod in _BUILTIN_MODULES.get(kind, []):
        importlib.import_module(mod)


def _load_entry_points(kind: str, name: str) -> bool:
    from importlib.metadata import entry_points

    for ep in entry_points(group=f"nnstreamer_tpu_torch.{kind}"):
        if ep.name.lower() == name:
            register(kind, name, ep.load(), replace=True)
            return True
    return False


def _load_from_search_paths(kind: str, name: str) -> bool:
    fname = f"nns_{kind}_{name}.py"
    for path in conf().plugin_paths(kind):
        full = os.path.join(path, fname)
        if os.path.isfile(full):
            spec = importlib.util.spec_from_file_location(
                f"nns_tpu_torch_plugin_{kind}_{name}", full
            )
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)  # plugin calls register()
            return name in _registry[kind]
    return False


def get(kind: str, name: str) -> Any:
    """Lazy-loading lookup; raises KeyError on a miss or when the
    ``[common] restricted_elements`` whitelist blocks an element."""
    name = name.lower()
    if kind == KIND_ELEMENT:
        allowed = [a.lower() for a in conf().get_list("common", "restricted_elements")]
        if allowed and name not in allowed:
            raise KeyError(
                f"element {name!r} is not allowed by [common] "
                f"restricted_elements ({sorted(allowed)})"
            )
    with _lock:
        if name not in _registry[kind]:
            _load_builtins(kind)
        if name not in _registry[kind]:
            if not _load_entry_points(kind, name):
                _load_from_search_paths(kind, name)
        if name not in _registry[kind]:
            raise KeyError(
                f"no {kind} subplugin named {name!r}; known: {sorted(_registry[kind])}"
            )
        return _registry[kind][name]


def available(kind: str) -> List[str]:
    with _lock:
        _load_builtins(kind)
        return sorted(_registry[kind])


def detect_filter_framework(model_path: str) -> Optional[str]:
    """framework=auto: backend from the model extension + priority config."""
    ext = os.path.splitext(model_path)[1].lstrip(".").lower()
    if not ext:
        return None
    for candidate in conf().framework_priority(ext):
        try:
            get(KIND_FILTER, candidate)
            return candidate
        except KeyError:
            continue
    return None


def filter_backend(*names: str):
    """Decorator registering a Backend class under one or more names."""

    def deco(cls):
        for name in names:
            register(KIND_FILTER, name, cls)
        return cls

    return deco


def decoder_plugin(name: str):
    def deco(obj):
        return register(KIND_DECODER, name, obj)

    return deco


def element(name: str):
    """Decorator registering a pipeline element class under its factory name."""

    def deco(cls):
        register(KIND_ELEMENT, name, cls)
        cls.FACTORY_NAME = name
        return cls

    return deco
