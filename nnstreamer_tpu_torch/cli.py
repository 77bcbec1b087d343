"""nns-launch for the port: run pipeline descriptions from the command line.

    python -m nnstreamer_tpu_torch.cli "videotestsrc num-frames=10 ! \\
        tensor_converter ! tensor_transform mode=resize option=224:224 ! \\
        tensor_filter framework=torch model=zoo:mobilenet_v2 ! \\
        tensor_decoder mode=image_labeling ! tensor_sink"

    python -m nnstreamer_tpu_torch.cli --inspect                # list elements
    python -m nnstreamer_tpu_torch.cli --inspect tensor_filter  # element detail
    python -m nnstreamer_tpu_torch.cli --dot "..." > graph.dot  # graph dump

The pipeline runs on the GPU; ``--device cpu`` runs it on the host. Errors
exit nonzero with one ``nns-launch:`` line on stderr and no traceback.
``--check`` lints the description instead of running it (nns-lint-torch:
exit 0 clean, 1 warnings, 2 errors or no GPU without ``--device cpu``;
``--dot`` then paints the findings on the graph).
``--timeout`` bounds a pipeline that does not end: at the bound it stops,
prints "Timeout reached" with the sinks' counts, and exits 0.

Observability: ``--stats`` prints the per-node stats as JSON (metrics on,
so the rows carry latency_p50/p95/p99_ms and queue-wait percentiles, and
``__pipeline__`` the frame accounting and transfer bytes); ``--metrics
FILE`` writes the metrics snapshot at EOS (``nns-top`` renders it);
``--trace FILE`` writes a chrome://tracing JSON of the nodes' frame spans;
``--profile DIR`` runs the pipeline under ``torch.profiler`` (CPU and CUDA
activities) and writes its Chrome trace into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _inspect(name) -> int:
    from nnstreamer_tpu_torch import registry

    if not name:
        print("Available elements:")
        for n in registry.available(registry.KIND_ELEMENT):
            cls = registry.get(registry.KIND_ELEMENT, n)
            doc = (cls.__doc__ or "").strip().splitlines()
            print(f"  {n:24s} {doc[0] if doc else ''}")
        for kind, label in (
            (registry.KIND_FILTER, "filter backends"),
            (registry.KIND_DECODER, "decoder subplugins"),
            (registry.KIND_CONVERTER, "converter subplugins"),
        ):
            names = registry.available(kind)
            if names:
                print(f"\nAvailable {label}: {', '.join(names)}")
        return 0
    cls = registry.get(registry.KIND_ELEMENT, name)
    print(f"Element: {name}\n")
    print(cls.__doc__ or "(no documentation)")
    return 0


def main(argv=None) -> int:
    from nnstreamer_tpu_torch import __version__

    ap = argparse.ArgumentParser(prog="nns-launch", description=__doc__)
    ap.add_argument("description", nargs="?", help="pipeline description")
    ap.add_argument("--inspect", nargs="?", const="", default=None, metavar="ELEMENT")
    ap.add_argument("--dot", action="store_true", help="print graphviz, don't run")
    ap.add_argument(
        "--check", action="store_true",
        help="statically lint the pipeline without starting it (nns-lint-torch); exit 0 "
        "clean / 1 warnings / 2 errors; with --dot the graph carries the findings",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device to run on (default cuda; 'cpu' runs on the host)",
    )
    ap.add_argument("--timeout", type=float, default=None, help="run timeout (s)")
    ap.add_argument(
        "--stats", action="store_true",
        help="print per-node stats JSON (metrics on: the rows carry latency_p50/p95/p99_ms "
        "and queue-wait percentiles)",
    )
    ap.add_argument("--metrics", metavar="FILE", default=None,
                    help="write the metrics JSON snapshot at EOS (nns-top renders it)")
    ap.add_argument("--trace", metavar="FILE", default=None,
                    help="write chrome://tracing JSON of per-node frame spans")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="run under torch.profiler (CPU and CUDA) and write its Chrome trace "
                    "into DIR")
    ap.add_argument("--quiet", "-q", action="store_true")
    ap.add_argument("--version", action="version", version=f"nns-launch {__version__}")
    args = ap.parse_args(argv)

    if args.inspect is not None:
        try:
            return _inspect(args.inspect or None)
        except KeyError as exc:
            print(f"nns-launch: {exc}", file=sys.stderr)
            return 1
    if not args.description:
        ap.error("pipeline description required")

    from nnstreamer_tpu_torch.device import NoDeviceError

    if args.check:
        from nnstreamer_tpu_torch.analysis import annotated_dot, lint

        try:
            result = lint(args.description, device=args.device)
        except NoDeviceError as exc:
            print(f"nns-launch: {exc}", file=sys.stderr)
            return 2
        if args.dot:
            print(annotated_dot(result))
        elif not args.quiet or result.diagnostics:
            print(result.render())
        return result.exit_code

    from nnstreamer_tpu_torch.elements.base import ElementError, NegotiationError
    from nnstreamer_tpu_torch.pipeline.parse import ParseError, parse_pipeline

    # construction/negotiation failures are user errors: one clean line
    # and rc 1, never a traceback
    try:
        pipeline = parse_pipeline(args.description, device=args.device)
        pipeline.negotiate()
    except (ParseError, NegotiationError, ElementError, NoDeviceError,
            KeyError, ValueError, NotImplementedError) as exc:
        print(f"nns-launch: {exc}", file=sys.stderr)
        return 1
    if args.dot:
        print(pipeline.dump_dot())
        return 0
    if not args.quiet:
        print(
            f"Setting pipeline PLAYING ({len(pipeline.elements)} elements) "
            f"on {pipeline.device}",
            file=sys.stderr,
        )
    from nnstreamer_tpu_torch import trace as trace_mod
    from nnstreamer_tpu_torch.obs import metrics as obs_metrics

    if args.stats or args.metrics:
        # the percentile columns need the histograms recording; the
        # executor resolves the registry when run() builds it
        obs_metrics.enable()
    tracer = trace_mod.enable() if args.trace else None
    profile_cm = (trace_mod.device_profile(args.profile) if args.profile
                  else contextlib.nullcontext())
    t0 = time.perf_counter()
    timed_out = False
    with profile_cm:
        try:
            ex = pipeline.run(timeout=args.timeout)
        except TimeoutError:
            # an operator-requested bound on a pipeline that does not end: a
            # stop, not an error (the run stopped every node before raising)
            ex = pipeline._executor
            timed_out = True
        except Exception as exc:  # noqa: BLE001 — CLI boundary: report, exit 1
            print(f"nns-launch: pipeline error: {type(exc).__name__}: {exc}", file=sys.stderr)
            return 1
    dt = time.perf_counter() - t0
    if tracer is not None:
        tracer.save(args.trace)
        if not args.quiet:
            print(f"Trace written to {args.trace}", file=sys.stderr)
    if args.profile and not args.quiet:
        print(f"Profile written to {args.profile}", file=sys.stderr)
    if not args.quiet:
        msg = "Timeout reached" if timed_out else "EOS"
        print(f"{msg} after {dt:.3f}s", file=sys.stderr)
        for e in pipeline.elements:
            if hasattr(e, "rendered"):
                print(f"  {e.name}: rendered {e.rendered} frames", file=sys.stderr)
    if args.metrics:
        from nnstreamer_tpu_torch.obs import expo

        expo.dump_json(args.metrics, expo.snapshot(obs_metrics.get(), ex.stats(), ex.totals()))
        if not args.quiet:
            print(f"Metrics snapshot written to {args.metrics}", file=sys.stderr)
    if args.stats:
        stats = ex.stats()
        # the pipeline's frame accounting beside the node rows; element
        # names are the user's, so never clobber one
        totals_key = "__pipeline__"
        while totals_key in stats:
            totals_key = "_" + totals_key
        stats[totals_key] = ex.totals()
        print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
