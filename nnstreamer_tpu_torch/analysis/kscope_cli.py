"""nns-kscope for the port: the static launch analyzer CLI for K1-K5.

    nns-kscope-torch                    # plan / roofline / card reading a kernel x case
    nns-kscope-torch --device cpu       # the plan-only analysis, no GPU needed
    nns-kscope-torch --json             # machine-readable rows + findings
    nns-kscope-torch --kernel K5        # one kernel (K number, entry point or .cu stem)
    nns-kscope-torch --self-check       # W127-W129 emitters<->catalog<->README wiring
    nns-kscope-torch --engage           # K1-K5 probed on the device, counters read
    nns-kscope-torch --strict           # warnings fail hard (exit 2)

For every kernel and main-path case (analysis/kernels.py ``SPECS``): the
launch plan (grid, threads, dynamic shared memory), the roofline row
(bytes, operations, the bound on an H100), and the findings NNS-W127 (a
launch the card cannot run) and NNS-W128 (a plan hazard). On ``--device``
``cuda`` (the default) each launch is also read through the ``.cu``'s own
query: registers, static shared memory, local bytes, blocks an SM, and the
plan held to the host code's launch; ``--device cpu`` asks for the
plan-only analysis. ``--engage`` runs on ``--device`` too (``cpu`` takes
the plain versions) and exits 1 unless every entry point engaged what the
device takes. Exit codes: 0 clean, 1 warnings only, 2 errors or no GPU
without ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _print_case(r) -> None:
    for i, ln in enumerate(r.launches):
        card = ""
        if i < len(r.card):
            c = r.card[i]
            card = (f" regs={c['regs']} static_smem={c['static_smem']}B "
                    f"local={c['local_bytes']}B blocks/SM={c['blocks_per_sm']}")
        print(f"{r.tpu_kernel}:{r.case}: {ln.kernel} grid={ln.grid} block={ln.block} "
              f"dyn_smem={ln.dyn_smem}B{card}")
    tail = "" if r.plan_matches is None else f" plan={'matches' if r.plan_matches else 'DIFFERS'}"
    print(f"  bytes={r.cost.hbm_bytes} ops={r.cost.flops} ({r.cost.unit}) "
          f"bound={r.cost.bound_ms():.6g} ms ({r.cost.bound_by()}){tail}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-kscope-torch", description=__doc__)
    ap.add_argument("--json", action="store_true", help="JSON report")
    ap.add_argument("--kernel", default="", help="analyze only this kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default): read each launch on the card; cpu: the "
                    "plan-only analysis. With --engage: the device probed")
    ap.add_argument("--self-check", action="store_true",
                    help="W127-W129 emitters<->catalog<->README, and every kernel source "
                    "with a spec")
    ap.add_argument("--engage", action="store_true",
                    help="probe K1-K5's entry points on the device and read their counters")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as errors (warnings-only runs exit 2)")
    ap.add_argument("--quiet", "-q", action="store_true")
    args = ap.parse_args(argv)

    from nnstreamer_tpu_torch.analysis import kernels as K
    from nnstreamer_tpu_torch.analysis.cli import diagnostics_json
    from nnstreamer_tpu_torch.device import NoDeviceError, resolve_device

    specs = None
    if args.kernel:
        spec = K.find(args.kernel)
        if spec is None:
            print(f"unknown kernel {args.kernel!r}; known: "
                  + ", ".join(f"{s.tpu_kernel} ({s.name})" for s in K.SPECS), file=sys.stderr)
            return 2
        specs = [spec]

    if args.self_check:
        from nnstreamer_tpu_torch.analysis.selfcheck import kscope_self_check

        problems = kscope_self_check()
        for p in problems:
            print(p)
        print("kscope self-check: " + ("OK" if not problems else f"{len(problems)} problem(s)"))
        return 1 if problems else 0

    try:
        if args.engage:
            rows = K.engage(args.device)
            if args.json:
                print(json.dumps(rows, indent=2))
            else:
                from nnstreamer_tpu_torch.analysis.xray import dispatch_row_text

                for row in rows:
                    print(dispatch_row_text(row) + ("" if row["ok"] else "  FAILED"))
            return 0 if all(r["ok"] for r in rows) else 1
        card = resolve_device(args.device).type == "cuda"
        reports, lint_report = K.analyze(specs, card=card)
    except NoDeviceError as exc:
        print(f"nns-kscope: {exc}", file=sys.stderr)
        return 2
    rc = lint_report.exit_code
    if args.strict and rc == 1:
        rc = 2  # warnings fail hard under --strict
    if args.json:
        print(json.dumps({"exit_code": rc, "cases": [r.to_row() for r in reports],
                          "diagnostics": diagnostics_json(lint_report.diagnostics)}, indent=2))
        return rc
    if not args.quiet:
        for r in reports:
            _print_case(r)
    if lint_report.diagnostics:
        print(lint_report.render())
    elif not args.quiet:
        print(f"{len(reports)} kernel case(s) clean")
    return rc


if __name__ == "__main__":
    sys.exit(main())
