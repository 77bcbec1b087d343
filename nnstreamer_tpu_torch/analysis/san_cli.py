"""nns-san for the port: the concurrency race and deadlock analyzer CLI.

    nns-san-torch --race [paths...]     # AST concurrency lint (default: the
                                        # nnstreamer_tpu_torch package)
    nns-san-torch --deadlock "a ! b"    # graph deadlock / capacity findings
    nns-san-torch --device cpu --deadlock "..."
    nns-san-torch --self-check          # diagnostic catalog covers the code?
    nns-san-torch --json --race ...     # machine-readable findings

Exit codes: 0 clean, 1 warnings only, 2 errors (and 1 on --self-check
failure), and 2 when --deadlock finds no GPU and ``--device cpu`` was
not asked for; ``--strict`` treats warnings as errors. The RUNTIME half of
the sanitizer is enabled per run with ``NNS_TPU_SANITIZE=1``
(pipeline/sanitize.py); this CLI is the static half.
"""

from __future__ import annotations

import argparse
import json
import sys


def _emit(report, as_json: bool, strict: bool) -> int:
    from nnstreamer_tpu_torch.analysis.cli import diagnostics_json

    rc = report.exit_code
    if strict and rc == 1:
        rc = 2
    if as_json:
        print(json.dumps({"exit_code": rc,
                          "diagnostics": diagnostics_json(report.diagnostics, "where")},
                         indent=2))
    else:
        print(report.render())
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-san-torch", description=__doc__)
    ap.add_argument("--race", nargs="*", metavar="PATH",
                    help="race-lint .py sources (default: the nnstreamer_tpu_torch package)")
    ap.add_argument("--deadlock", metavar="DESC",
                    help="graph deadlock/capacity analysis of a pipeline description")
    ap.add_argument("--device", default=None,
                    help="device --deadlock negotiates on (default cuda; 'cpu' on the host)")
    ap.add_argument("--self-check", action="store_true",
                    help="validate the diagnostic catalog against the code")
    ap.add_argument("--json", action="store_true", help="JSON findings")
    ap.add_argument("--strict", action="store_true", help="treat warnings as errors (exit 2)")
    args = ap.parse_args(argv)

    if args.self_check:
        from nnstreamer_tpu_torch.analysis.selfcheck import san_self_check

        problems = san_self_check()
        for p in problems:
            print(p)
        if problems:
            print(f"{len(problems)} catalog problem(s)")
            return 1
        print("diagnostic catalog covers the code")
        return 0

    if args.deadlock is not None:
        from nnstreamer_tpu_torch.analysis.diagnostics import LintReport
        from nnstreamer_tpu_torch.analysis.lint import DEADLOCK_CODES, lint
        from nnstreamer_tpu_torch.device import NoDeviceError

        try:
            full = lint(args.deadlock, device=args.device)
        except NoDeviceError as exc:
            print(f"nns-san: {exc}", file=sys.stderr)
            return 2
        report = LintReport([d for d in full.diagnostics if d.code in DEADLOCK_CODES])
        return _emit(report, args.json, args.strict)

    if args.race is not None:
        import os

        import nnstreamer_tpu_torch
        from nnstreamer_tpu_torch.analysis.racecheck import run_race_lint

        paths = args.race or [os.path.dirname(nnstreamer_tpu_torch.__file__)]
        return _emit(run_race_lint(paths), args.json, args.strict)

    ap.error("one of --race, --deadlock, --self-check is required")
    return 2  # pragma: no cover - ap.error exits


if __name__ == "__main__":
    sys.exit(main())
