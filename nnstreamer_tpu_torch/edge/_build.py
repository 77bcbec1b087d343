"""On-demand g++ build of the in-tree native edge components.

The counterpart of ``nnstreamer_tpu/edge/_build.py``. The sources are the
repository's ``native/*.cpp`` (read, never edited); the port compiles them
into ``build/torch_native/lib<stem>.so``, apart from the reference's own
``build/lib<stem>.so``. A build writes a file of its own name and moves it
into place with ``os.replace``, so a process never loads a half-written
library while another (a test worker, the reference package) builds the
same source. A missing toolchain degrades to the pure-python fallbacks
(transport.py): that is host transport, and the elements report which one
runs.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Optional

from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("edge.build")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")

# NNS_EDGE_SANITIZE=thread|address builds an instrumented variant under its
# own name, so normal runs stay fast
SANITIZE = os.environ.get("NNS_EDGE_SANITIZE", "")
_suffix = f"_{SANITIZE}" if SANITIZE else ""

_lock = threading.Lock()
_cache: dict = {}  # source basename -> path | None (None = build failed)


def build_native(source_name: str, extra_flags=()) -> Optional[str]:
    """Compile native/<source_name> into build/torch_native/lib<stem>.so
    (cached while the library is newer than its source). Returns None when
    the toolchain or the source is missing; the failure is cached for the
    life of the process."""
    src = os.path.join(_REPO_ROOT, "native", source_name)
    stem = os.path.splitext(source_name)[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}{_suffix}.so")
    with _lock:
        if source_name in _cache:
            return _cache[source_name]
        result: Optional[str] = None
        if os.path.isfile(src):
            try:
                if not (os.path.isfile(so) and os.path.getmtime(so) >= os.path.getmtime(src)):
                    os.makedirs(BUILD_DIR, exist_ok=True)
                    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
                    cmd = [
                        "g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                        "-pthread", *extra_flags, src, "-o", tmp, "-lrt",
                    ]
                    if SANITIZE:
                        cmd[1:1] = [f"-fsanitize={SANITIZE}", "-g"]
                    try:
                        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                        os.replace(tmp, so)
                    finally:
                        if os.path.exists(tmp):
                            os.unlink(tmp)
                    _log.info("built native lib: %s", so)
                result = so
            except (subprocess.SubprocessError, OSError) as exc:
                _log.warning("native build of %s failed: %s", source_name, exc)
        _cache[source_name] = result
        return result


def native_lib_path() -> Optional[str]:
    """The edge transport library (native/nns_edge.cpp)."""
    return build_native("nns_edge.cpp")
