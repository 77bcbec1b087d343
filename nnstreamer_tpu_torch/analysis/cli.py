"""nns-lint for the port: the standalone static-analyzer CLI.

    nns-lint-torch "videotestsrc ! tensor_converter ! tensor_sink"
    nns-lint-torch --device cpu "..."         # negotiate on the host
    nns-lint-torch --dot "..." > graph.dot    # diagnostics painted on nodes
    nns-lint-torch --json "..."               # machine-readable findings
    nns-lint-torch --self-check               # PROPERTIES schemas cover code?
    nns-lint-torch --strict "..."             # warnings fail hard (exit 2)

Exit codes: 0 clean, 1 warnings only, 2 errors (and 1 on --self-check
failure), and 2 when no GPU is there and ``--device cpu`` was not asked for.
The pipeline is parsed, negotiated on a clone (a tensor_filter's model
loads on the device) and analyzed, but NEVER started. ``nns-san-torch``
covers the concurrency race lint and the graph deadlock passes.
"""

from __future__ import annotations

import argparse
import json
import sys


def diagnostics_json(diags, where_key: str = "element") -> list:
    """The findings as JSON rows (shared by the analyzers' CLIs)."""
    return [
        {"code": d.code, "severity": d.severity.value, "slug": d.slug,
         where_key: d.element, "message": d.message, "hint": d.hint}
        for d in diags
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-lint-torch", description=__doc__)
    ap.add_argument("description", nargs="?", help="pipeline description")
    ap.add_argument("--device", default=None,
                    help="device the dry run negotiates on (default cuda; 'cpu' on the host)")
    ap.add_argument("--dot", action="store_true",
                    help="print graphviz with diagnostics annotated on the nodes")
    ap.add_argument("--json", action="store_true", help="JSON findings")
    ap.add_argument("--self-check", action="store_true",
                    help="verify every builtin element's PROPERTIES schema covers the "
                    "properties its code reads")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as errors (warnings-only runs exit 2)")
    ap.add_argument("--quiet", "-q", action="store_true")
    args = ap.parse_args(argv)

    if args.self_check:
        from nnstreamer_tpu_torch.analysis.selfcheck import main as selfcheck_main

        return selfcheck_main()
    if not args.description:
        ap.error("pipeline description required (or --self-check)")

    from nnstreamer_tpu_torch.analysis import annotated_dot, lint
    from nnstreamer_tpu_torch.device import NoDeviceError

    try:
        result = lint(args.description, device=args.device)
    except NoDeviceError as exc:
        print(f"nns-lint: {exc}", file=sys.stderr)
        return 2
    rc = result.exit_code
    if args.strict and rc == 1:
        rc = 2  # warnings fail hard under --strict
    if args.dot:
        print(annotated_dot(result))
        return rc
    if args.json:
        print(json.dumps({"exit_code": rc,
                          "diagnostics": diagnostics_json(result.diagnostics)}, indent=2))
        return rc
    if not args.quiet or result.diagnostics:
        print(result.render())
    return rc


if __name__ == "__main__":
    sys.exit(main())
