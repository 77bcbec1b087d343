"""Config sanity checker.

The counterpart of ``nnstreamer_tpu/tools/confchk.py`` (the reference's
tools/development/confchk) over the port's layered config
(nnstreamer_tpu_torch/config.py) and registry: unknown sections and keys,
plugin_paths entries that are not directories, framework priorities naming
backends the port does not register, and the effective (env > ini >
default) value of every key.

Usage: python -m nnstreamer_tpu_torch.tools.confchk [INI_PATH]
Exit code: 0 clean, 1 warnings, 2 errors.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.config import _DEFAULTS, Config


def check(ini_path=None) -> Tuple[List[str], List[str], List[str]]:
    """Returns (info, warnings, errors) message lists."""
    info: List[str] = []
    warnings: List[str] = []
    errors: List[str] = []
    cfg = Config(ini_path)

    parser = cfg._parser
    for section in parser.sections():
        if section not in _DEFAULTS:
            warnings.append(f"unknown section [{section}]")
            continue
        for key in parser[section]:
            if key not in _DEFAULTS[section]:
                warnings.append(f"unknown key [{section}] {key}")

    for kind in (registry.KIND_FILTER, registry.KIND_DECODER, registry.KIND_CONVERTER):
        for p in cfg.plugin_paths(kind):
            if not os.path.isdir(p):
                errors.append(f"[{kind}] plugin_paths entry not a directory: {p}")

    for key in _DEFAULTS["filter"]:
        if not key.startswith("framework_priority_"):
            continue
        ext = key[len("framework_priority_"):]
        for backend in cfg.framework_priority(ext):
            try:
                registry.get(registry.KIND_FILTER, backend)
                info.append(f"priority .{ext} → {backend}: available")
            except KeyError:
                warnings.append(f"priority .{ext} names unavailable backend {backend!r}")

    for section, keys in _DEFAULTS.items():
        for key in keys:
            info.append(f"[{section}] {key} = {cfg.get(section, key)!r}")
    return info, warnings, errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-confchk", description=__doc__)
    ap.add_argument("ini", nargs="?", default=None)
    ap.add_argument("-q", "--quiet", action="store_true", help="problems only")
    args = ap.parse_args(argv)
    info, warnings, errors = check(args.ini)
    if not args.quiet:
        for m in info:
            print(f"  {m}")
    for m in warnings:
        print(f"WARN: {m}")
    for m in errors:
        print(f"ERROR: {m}")
    if errors:
        return 2
    return 1 if warnings else 0


if __name__ == "__main__":
    sys.exit(main())
