"""Element / backend / subplugin reference generator.

The counterpart of ``nnstreamer_tpu/tools/gendoc.py``: every element,
backend, decoder and converter of the port registers with a docstring, and
this renders the port's whole registry as one markdown reference (the
gst-inspect analogue), each element with its own property table.

Usage: python -m nnstreamer_tpu_torch.tools.gendoc [-o docs/torch-elements.md]
"""

from __future__ import annotations

import argparse
import inspect
import sys

from nnstreamer_tpu_torch import registry

_SECTIONS = (
    (registry.KIND_ELEMENT, "Pipeline elements"),
    (registry.KIND_FILTER, "tensor_filter backends (framework=...)"),
    (registry.KIND_DECODER, "tensor_decoder subplugins (mode=...)"),
    (registry.KIND_CONVERTER, "tensor_converter subplugins"),
)


def _property_lines(impl) -> list:
    """An element's own PROPERTIES (beyond the Element base props) as a
    markdown list: the gst-inspect property table."""
    from nnstreamer_tpu_torch.elements.base import PROPS_ANY, Element

    if not (inspect.isclass(impl) and issubclass(impl, Element)):
        return []
    base = Element.property_schema()
    own = {k: ps for k, ps in impl.property_schema().items()
           if k != PROPS_ANY and base.get(k) is not ps}
    if not own:
        return []
    lines = ["Properties:", ""]
    for key in sorted(own):
        ps = own[key]
        typ = ps.type
        if ps.type == "enum" and ps.choices:
            typ = "enum: " + "/".join(ps.choices)
        bits = [typ]
        if ps.default is not None:
            bits.append(f"default {ps.default!r}")
        desc = f" — {ps.desc}" if ps.desc else ""
        lines.append(f"- `{key}` ({', '.join(bits)}){desc}")
    lines.append("")
    return lines


def generate() -> str:
    lines = [
        "# Element & subplugin reference (PyTorch port)",
        "",
        "Generated by `python -m nnstreamer_tpu_torch.tools.gendoc` — do not edit.",
        "",
        "Entry points run on `cuda` unless `--device cpu` (or `device=\"cpu\"`)",
        "is asked for. Device elements between a source and a sink fuse into",
        "one segment, on the card one CUDA graph replayed a frame.",
        "",
    ]
    for kind, title in _SECTIONS:
        lines += [f"## {title}", ""]
        for name in registry.available(kind):
            try:
                impl = registry.get(kind, name)
            except KeyError:
                # restricted by the runtime config: gendoc documents the
                # code, not the product whitelist
                continue
            doc = inspect.getdoc(impl)
            if not doc:
                # a subplugin class without a docstring documents itself at
                # module level
                mod = inspect.getmodule(impl)
                mod_doc = inspect.getdoc(mod) if mod else None
                doc = (mod_doc or "(undocumented)").split("\n\n")[0]
            lines += [f"### `{name}`", "", doc, ""]
            lines += _property_lines(impl)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-gendoc", description=__doc__)
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)
    text = generate()
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output} ({len(text.splitlines())} lines)")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
