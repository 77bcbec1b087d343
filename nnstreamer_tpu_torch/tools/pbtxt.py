"""Pipeline description → mediapipe-style pbtxt converter.

The counterpart of ``nnstreamer_tpu/tools/pbtxt.py`` (the reference's
tools/development/parser): the port's own parser (pipeline/parse.py)
builds the graph on the host, nothing is opened or run, and this renders
it as mediapipe-style ``node { calculator / input_stream / output_stream
}`` text, the same text the reference's tool writes.

Usage: python -m nnstreamer_tpu_torch.tools.pbtxt "videotestsrc ! tensor_converter ! tensor_sink"
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List


def to_pbtxt(description: str) -> str:
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    # the graph only: elements open nothing until negotiation, so the host
    # device serves on any machine
    pipeline = parse_pipeline(description, device="cpu")
    # stream name per (src element, src pad)
    stream_of: Dict = {}
    for link in pipeline.links:
        key = (link.src.name, link.src_pad)
        if key not in stream_of:
            suffix = f"_{link.src_pad}" if link.src_pad else ""
            stream_of[key] = f"{link.src.name}{suffix}"

    lines: List[str] = [f"# pbtxt of pipeline: {description!r}"]
    for e in pipeline.elements:
        lines.append("node {")
        lines.append(f'  calculator: "{e.FACTORY_NAME}"')
        lines.append(f'  name: "{e.name}"')
        for link in pipeline.links:
            if link.dst is e:
                lines.append(f'  input_stream: "{stream_of[(link.src.name, link.src_pad)]}"')
        for (src_name, _pad), stream in stream_of.items():
            if src_name == e.name:
                lines.append(f'  output_stream: "{stream}"')
        props = {k: v for k, v in (getattr(e, "props", None) or {}).items() if v is not None}
        if props:
            lines.append("  node_options {")
            for k, v in sorted(props.items()):
                lines.append(f'    option: "{k}={v}"')
            lines.append("  }")
        lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-pbtxt", description=__doc__)
    ap.add_argument("description", help="pipeline description string")
    ap.add_argument("-o", "--output", default=None, help="write to file")
    args = ap.parse_args(argv)
    text = to_pbtxt(args.description)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
