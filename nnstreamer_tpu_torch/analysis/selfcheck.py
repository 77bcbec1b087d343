"""The analyzers' self-checks: the catalogs must cover the code, and the
port's own text must cover the catalogs.

The counterpart of ``nnstreamer_tpu/analysis/selfcheck.py``:

- :func:`self_check` (``nns-lint-torch --self-check``): every property an
  element class reads (``get_property("...")`` / ``props.pop("...")``) is
  in its merged ``PROPERTIES`` schema;
- :func:`san_self_check` (``nns-san-torch --self-check``): every code an
  analyzer emits is cataloged, every cataloged code has an emitter, slugs
  are unique, severities match the E/W prefixes, and the catalog is
  listed in the port's text;
- :func:`obs_self_check`, :func:`xray_self_check`,
  :func:`kscope_self_check`, :func:`disagg_self_check`: the metric catalog,
  the chain codes, the kernel codes and kernels, and the disaggregation
  code and metrics, each wired both ways.

The port's text is the README's "PyTorch/CUDA port" section (the
reference's ``docs/*.md`` describe the JAX package); a checkout without
that section fails each check that reads it.
"""

from __future__ import annotations

import importlib
import inspect
import os
import re
from typing import Dict, List, Optional, Set

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import PROPS_ANY

_PROP_READ = re.compile(r"""(?:get_property|props\.pop)\(\s*["']([^"']+)["']""")
_CODE_REF = re.compile(r"""(NNS-[EWRS]\d{3})""")
_CODE_LITERAL = re.compile(r"""["'](NNS-[EWRS]\d{3})""")
_PORT_HEADING = "## PyTorch/CUDA port"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def port_text(problems: List[str]) -> Optional[str]:
    """The README's "PyTorch/CUDA port" section, or None, with a problem
    added to ``problems``, where the README or the section is missing."""
    path = os.path.join(_repo_root(), "README.md")
    text = ""
    if os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            text = f.read()
    i = text.find(_PORT_HEADING)
    if i < 0:
        problems.append(f"no {_PORT_HEADING[3:]!r} section in {path}: the text "
                        "the catalogs are held to is missing")
        return None
    j = text.find("\n## ", i + len(_PORT_HEADING))
    return text[i:j if j >= 0 else len(text)]


def _source_codes(module: str) -> Set[str]:
    # importlib, not `import a.b as m`: analysis/__init__ binds `lint` and
    # `xray` to the functions of the same names
    return set(_CODE_LITERAL.findall(inspect.getsource(importlib.import_module(module))))


# -- nns-lint --self-check: PROPERTIES schemas cover the code ----------------

def scan_class_properties(cls: type) -> Set[str]:
    """Property names the class source reads (dash-normalized), over the
    MRO so inherited reads are attributed too."""
    names: Set[str] = set()
    for klass in cls.__mro__:
        if klass is object:
            continue
        try:
            src = inspect.getsource(klass)
        except (OSError, TypeError):  # pragma: no cover - builtins only
            continue
        for m in _PROP_READ.finditer(src):
            names.add(m.group(1).replace("_", "-"))
    return names


def self_check() -> List[str]:
    """Problems (empty = every element schema covers its code)."""
    problems: List[str] = []
    seen: Dict[type, str] = {}
    for name in registry.available(registry.KIND_ELEMENT):
        try:
            cls = registry.get(registry.KIND_ELEMENT, name)
        except KeyError:  # restricted by the runtime config
            continue
        if cls in seen:  # aliases check once
            continue
        seen[cls] = name
        schema = cls.property_schema()
        if PROPS_ANY in schema:
            continue
        for prop in sorted(scan_class_properties(cls)):
            if prop not in schema:
                problems.append(
                    f"{name} ({cls.__module__}.{cls.__name__}): property {prop!r} is read "
                    "by the code but missing from PROPERTIES")
    return problems


# -- nns-san --self-check: the diagnostic catalog covers the code -------------

_EMITTERS = (
    "nnstreamer_tpu_torch.analysis.kernels",
    "nnstreamer_tpu_torch.analysis.lint",
    "nnstreamer_tpu_torch.analysis.racecheck",
    "nnstreamer_tpu_torch.analysis.xray",
    "nnstreamer_tpu_torch.pipeline.sanitize",
)


def _emitted_codes() -> Set[str]:
    """Every code an analyzer or the sanitizer references (the catalog's
    own module does not count)."""
    out: Set[str] = set()
    for name in _EMITTERS:
        out |= _source_codes(name)
    return out


def san_self_check() -> List[str]:
    """Problems of the diagnostic catalog against the code and the port's
    text: emitted but uncataloged, cataloged with no emitter, a slug used
    twice, a severity that contradicts its prefix, a code the text does
    not list, a code the text names that the catalog lacks."""
    from nnstreamer_tpu_torch.analysis.diagnostics import CATALOG, Severity

    problems: List[str] = []
    emitted = _emitted_codes()
    for code in sorted(emitted - set(CATALOG)):
        problems.append(f"code {code} is emitted but not in the catalog")
    for code in sorted(set(CATALOG) - emitted):
        problems.append(f"catalog code {code} has no emitter in the code")
    slugs: Dict[str, str] = {}
    for code, (sev, slug, _desc) in CATALOG.items():
        if slug in slugs:
            problems.append(f"slug {slug!r} used by both {slugs[slug]} and {code}")
        slugs[slug] = code
        if code.startswith("NNS-E") and sev is not Severity.ERROR:
            problems.append(f"{code} has an E prefix but severity {sev}")
        if code.startswith("NNS-W") and sev is not Severity.WARNING:
            problems.append(f"{code} has a W prefix but severity {sev}")
    text = port_text(problems)
    if text is not None:
        for code in sorted(CATALOG):
            if code not in text:
                problems.append(f"{code} is not listed in the README's port section")
        for code in sorted(set(_CODE_REF.findall(text)) - set(CATALOG)):
            problems.append(f"the README's port section names {code}, which the port's "
                            "catalog lacks")
    return problems


# -- the metric catalog covers the code -----------------------------------------

_METRIC_EMIT = re.compile(r"""(?:counter|gauge|histogram)\(\s*\n?\s*["'](nns_[a-z0-9_]+)["']""")


def obs_self_check() -> List[str]:
    """The metric catalog against the code and the port's text: every
    metric the package emits through a registry call is in
    ``METRIC_CATALOG``, every cataloged one has an emitter, and the text
    names every cataloged metric."""
    from nnstreamer_tpu_torch.obs.metrics import METRIC_CATALOG

    problems: List[str] = []
    pkg_root = os.path.join(_repo_root(), "nnstreamer_tpu_torch")
    catalog_file = os.path.join(pkg_root, "obs", "metrics.py")
    emitted: Set[str] = set()
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            path = os.path.join(dirpath, fn)
            if not fn.endswith(".py") or os.path.samefile(path, catalog_file):
                continue
            with open(path, encoding="utf-8") as f:
                emitted |= set(_METRIC_EMIT.findall(f.read()))
    for name in sorted(emitted - set(METRIC_CATALOG)):
        problems.append(f"metric {name} is emitted but not in METRIC_CATALOG")
    for name in sorted(set(METRIC_CATALOG) - emitted):
        problems.append(f"catalog metric {name} has no emitter in the package")
    text = port_text(problems)
    if text is not None:
        for name in sorted(METRIC_CATALOG):
            if name not in text:
                problems.append(f"metric {name} is not named in the README's port section")
    return problems


# -- nns-xray --self-check: the chain codes ---------------------------------------

_XRAY_CODES = ("NNS-W120", "NNS-W121", "NNS-W122", "NNS-W124", "NNS-W125")


def _wired(codes, module: str, what: str) -> List[str]:
    from nnstreamer_tpu_torch.analysis.diagnostics import CATALOG

    problems: List[str] = []
    emitted = _source_codes(module)
    text = port_text(problems)
    for code in codes:
        if code not in CATALOG:
            problems.append(f"{what} code {code} missing from the catalog")
        if code not in emitted:
            problems.append(f"{what} code {code} has no emitter in {module}")
        if text is not None and code not in text:
            problems.append(f"{code} is not listed in the README's port section")
    return problems


def xray_self_check() -> List[str]:
    """W120-W125 (the port has no W123) are in the catalog, emitted by
    analysis/xray.py and listed in the port's text; and the chain
    program's hazard pass reads xray's walkers (one source)."""
    problems = _wired(_XRAY_CODES, "nnstreamer_tpu_torch.analysis.xray", "chain")
    src = inspect.getsource(importlib.import_module("nnstreamer_tpu_torch.pipeline.chain_program"))
    for walker in ("segment_hazard", "chain_cost"):
        if walker not in src:
            problems.append(f"pipeline/chain_program.py does not use the analyzers' {walker}: "
                            "the executor and nns-xray could disagree")
    return problems


# -- nns-kscope --self-check: the kernel codes and the kernels --------------------

_KSCOPE_CODES = ("NNS-W127", "NNS-W128", "NNS-W129")


def kscope_self_check() -> List[str]:
    """W127-W129 are in the catalog, emitted by analysis/kernels.py and
    listed in the port's text; every kernel source in csrc/ has a spec and
    exports its launch query, every spec names an existing source; and
    the dispatch table probes K1-K5."""
    from nnstreamer_tpu_torch.analysis.kernels import SPECS
    from nnstreamer_tpu_torch.analysis.xray import DISPATCH_PROBES

    problems = _wired(_KSCOPE_CODES, "nnstreamer_tpu_torch.analysis.kernels", "kernel")
    root = _repo_root()
    csrc = os.path.join(root, "nnstreamer_tpu_torch", "csrc")
    sources = {f"nnstreamer_tpu_torch/csrc/{f}" for f in os.listdir(csrc) if f.endswith(".cu")}
    specced = {s.source for s in SPECS}
    for src in sorted(sources - specced):
        problems.append(f"{src} has no kernel spec (nns-kscope cannot analyze it)")
    for src in sorted(specced - sources):
        problems.append(f"a kernel spec names {src}, which does not exist")
    for src in sorted(sources & specced):
        with open(os.path.join(root, src), encoding="utf-8") as f:
            if not re.search(r'extern "C" int nns_\w+_launch_info\(', f.read()):
                problems.append(f"{src} exports no nns_*_launch_info query")
    want = {f"K{i}" for i in range(1, 6)}
    for k in sorted(want - {s.tpu_kernel for s in SPECS}):
        problems.append(f"no kernel spec for {k}")
    for k in sorted(want - {k for _, k, _, _ in DISPATCH_PROBES}):
        problems.append(f"the dispatch table probes no entry point of {k}")
    return problems


# -- the disaggregation code and metrics -------------------------------------------

_DISAGG_CODES = ("NNS-W130",)


def disagg_self_check() -> List[str]:
    """W130 is in the catalog, emitted by analysis/lint.py and listed in
    the port's text; the disaggregation metrics are cataloged and emitted
    where the serving and edge code hand requests off."""
    from nnstreamer_tpu_torch.obs.metrics import METRIC_CATALOG

    problems = _wired(_DISAGG_CODES, "nnstreamer_tpu_torch.analysis.lint", "disagg")
    wanted = {
        "nns_disagg_handoffs_total": "nnstreamer_tpu_torch.serving_plane.disagg",
        "nns_route_prefix_hits_total": "nnstreamer_tpu_torch.edge.query",
    }
    for metric, mod_name in wanted.items():
        if metric not in METRIC_CATALOG:
            problems.append(f"disagg metric {metric} missing from METRIC_CATALOG")
        src = inspect.getsource(importlib.import_module(mod_name))
        if f'"{metric}"' not in src and f"'{metric}'" not in src:
            problems.append(f"disagg metric {metric} has no emitter in {mod_name}")
    return problems


def main(argv=None) -> int:  # pragma: no cover - thin wrapper
    problems = self_check()
    for p in problems:
        print(p)
    if problems:
        print(f"{len(problems)} schema gap(s)")
        return 1
    print("all element PROPERTIES schemas cover their code")
    return 0
