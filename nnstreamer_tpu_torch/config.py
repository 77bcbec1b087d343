"""Layered configuration: env vars > ini file > hardcoded defaults.

The part of ``nnstreamer_tpu/config.py`` that the port reads: plugin
search paths, the element restriction whitelist, the framework
auto-detect priority and the ``[llm]`` serving defaults. Env mapping:
section ``filter`` key ``framework_priority_pt`` is overridden by
``NNS_TPU_FILTER_FRAMEWORK_PRIORITY_PT``. The ini file is read only from
the path in ``NNS_TPU_CONF``.
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

_DEFAULTS: Dict[str, Dict[str, str]] = {
    "common": {
        "enable_envvar": "true",
        # comma list of allowed elements; empty = all
        "restricted_elements": "",
    },
    "filter": {
        # search paths for out-of-tree backend plugins; colon separated
        "plugin_paths": "",
        # model-extension → backend auto-detection priority
        "framework_priority_pt": "torch",
        "framework_priority_pth": "torch",
    },
    "decoder": {"plugin_paths": ""},
    "converter": {"plugin_paths": ""},
    "llm": {
        # continuous-batching LLM serving defaults (tensor_llm_serversink
        # props override). kv_layout: slot (one contiguous cache per slot;
        # the only layout ported so far) | paged (not ported yet)
        "kv_layout": "slot",
        # decode attention: xla (inline masked attention) | pallas (the
        # decode-attention kernel, CUDA on the card)
        "attn_impl": "xla",
        # paged-layout settings, kept for the reference's config files
        "kv_attn": "auto",
        "block_size": "16",
        "kv_blocks": "",
        "prefill_chunks": "1",
        "memory_bound": "",
    },
}

_ENV_PREFIX = "NNS_TPU_"


class Config:
    """Thread-safe layered config with the reference's 3-level priority."""

    def __init__(self, ini_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._parser = configparser.ConfigParser()
        self.load(ini_path)

    def load(self, ini_path: Optional[str] = None) -> None:
        with self._lock:
            self._parser = configparser.ConfigParser()
            path = ini_path or os.environ.get(_ENV_PREFIX + "CONF")
            if path and os.path.isfile(path):
                self._parser.read(path)

    @property
    def env_enabled(self) -> bool:
        raw = self._layered("common", "enable_envvar", use_env=False)
        return raw.strip().lower() in ("1", "true", "yes", "on")

    def _layered(self, section: str, key: str, use_env: bool = True) -> str:
        if use_env:
            env_key = f"{_ENV_PREFIX}{section.upper()}_{key.upper()}"
            if env_key in os.environ:
                return os.environ[env_key]
        if self._parser.has_option(section, key):
            return self._parser.get(section, key)
        return _DEFAULTS.get(section, {}).get(key, "")

    def get(self, section: str, key: str, default: str = "") -> str:
        val = self._layered(section, key, use_env=self.env_enabled)
        return val if val != "" else default

    def get_list(self, section: str, key: str, sep: str = ",") -> List[str]:
        raw = self.get(section, key, "")
        return [p.strip() for p in raw.split(sep) if p.strip()]

    def plugin_paths(self, kind: str) -> List[str]:
        return self.get_list(kind, "plugin_paths", sep=":")

    def framework_priority(self, model_ext: str) -> List[str]:
        return self.get_list("filter", f"framework_priority_{model_ext.lstrip('.')}")


_global: Optional[Config] = None
_global_lock = threading.Lock()


def conf() -> Config:
    """Global config singleton, loaded on first use."""
    global _global
    with _global_lock:
        if _global is None:
            _global = Config()
        return _global
