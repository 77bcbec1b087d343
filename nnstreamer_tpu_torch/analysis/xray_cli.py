"""nns-xray for the port: the whole-chain compile-unit analyzer CLI.

    nns-xray-torch "videotestsrc device=true ! tensor_converter ! ..."
    nns-xray-torch --device cpu "..."   # compile the plan on the host
    nns-xray-torch --json "..."         # machine-readable chains + findings
    nns-xray-torch --dispatch           # which of K1-K5 engage, by launch counter
    nns-xray-torch --self-check         # W120-W125 emitters<->catalog<->README
    nns-xray-torch --strict "..."       # warnings fail hard (exit 2)

Reports compile units (chains of fused segments joined by device
handoffs), per-chain params / activation / transient bytes, the predicted
transfer bytes a frame at every host boundary, and the program lint's
findings (NNS-W120..W125). Exit codes: 0 clean or degraded, 1 warnings
only, 2 errors (also when no GPU is there and ``--device cpu`` was not
asked for). The plan is compiled on the device (negotiation runs,
backends open) but NEVER started.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-xray-torch", description=__doc__)
    ap.add_argument("description", nargs="?", help="pipeline description")
    ap.add_argument("--device", default=None,
                    help="device the plan and the probes run on (default cuda; 'cpu' on "
                    "the host)")
    ap.add_argument("--json", action="store_true", help="JSON report")
    ap.add_argument("--dispatch", action="store_true",
                    help="print the kernel dispatch table (K1-K5's entry points probed on "
                    "the device, their launch counters read)")
    ap.add_argument("--no-probe", action="store_true",
                    help="with --dispatch: the static columns only, no probe calls")
    ap.add_argument("--self-check", action="store_true",
                    help="verify the W120-W125 emitters<->catalog<->README wiring")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as errors (warnings-only runs exit 2)")
    ap.add_argument("--quiet", "-q", action="store_true")
    args = ap.parse_args(argv)

    if args.self_check:
        from nnstreamer_tpu_torch.analysis.selfcheck import xray_self_check

        problems = xray_self_check()
        for p in problems:
            print(p)
        print("xray self-check: " + ("OK" if not problems else f"{len(problems)} problem(s)"))
        return 1 if problems else 0

    from nnstreamer_tpu_torch.analysis.cli import diagnostics_json
    from nnstreamer_tpu_torch.analysis.xray import dispatch_row_text, dispatch_table, xray
    from nnstreamer_tpu_torch.device import NoDeviceError

    try:
        if args.dispatch and not args.description:
            rows = dispatch_table(args.device, run=not args.no_probe)
            if args.json:
                print(json.dumps(rows, indent=2))
            else:
                for row in rows:
                    print(dispatch_row_text(row))
            return 1 if any(r["error"] for r in rows) else 0
        if not args.description:
            ap.error("pipeline description required (or --dispatch / --self-check)")
        result = xray(args.description, device=args.device)
        if args.dispatch:
            result.dispatch = dispatch_table(args.device, run=not args.no_probe)
    except NoDeviceError as exc:
        print(f"nns-xray: {exc}", file=sys.stderr)
        return 2
    rc = result.exit_code
    if args.strict and rc == 1:
        rc = 2  # warnings fail hard under --strict
    if args.json:
        print(json.dumps({
            "exit_code": rc,
            "degraded": result.degraded,
            "device": result.device,
            "chains": [
                {"name": c.name, "segments": c.segments, "n_ops": c.n_ops,
                 "params_bytes": c.cost.params_bytes,
                 "activation_bytes": c.cost.activation_bytes,
                 "transient_bytes": c.cost.transient_bytes,
                 "boundary_in_bytes": c.cost.boundary_in_bytes,
                 "boundary_out_bytes": c.cost.boundary_out_bytes,
                 "compiled": c.compiled, "notes": c.notes}
                for c in result.chains
            ],
            "boundaries": [
                {"producer": b.producer, "consumer": b.consumer, "direction": b.direction,
                 "bytes_per_frame": b.bytes_per_frame, "reason": b.reason}
                for b in result.boundaries
            ],
            "predicted": result.predicted,
            "dispatch": result.dispatch,
            "notes": result.notes,
            "errors": result.errors,
            "diagnostics": diagnostics_json(result.diagnostics),
        }, indent=2))
        return rc
    if not args.quiet or result.diagnostics or result.errors:
        print(result.render())
    return rc


if __name__ == "__main__":
    sys.exit(main())
