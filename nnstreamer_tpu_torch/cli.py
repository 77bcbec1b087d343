"""nns-launch for the port: run pipeline descriptions from the command line.

    python -m nnstreamer_tpu_torch.cli "videotestsrc num-frames=10 ! \\
        tensor_converter ! tensor_transform mode=resize option=224:224 ! \\
        tensor_filter framework=torch model=zoo:mobilenet_v2 ! \\
        tensor_decoder mode=image_labeling ! tensor_sink"

The pipeline runs on the GPU; ``--device cpu`` runs it on the host. Errors
exit nonzero with one ``nns-launch:`` line on stderr and no traceback.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-launch", description=__doc__)
    ap.add_argument("description", help="pipeline description")
    ap.add_argument(
        "--device", default=None,
        help="torch device to run on (default cuda; 'cpu' runs on the host)",
    )
    ap.add_argument("--timeout", type=float, default=None, help="run timeout (s)")
    ap.add_argument("--quiet", "-q", action="store_true")
    args = ap.parse_args(argv)

    from nnstreamer_tpu_torch.device import NoDeviceError
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
    if not args.quiet:
        print(
            f"Setting pipeline PLAYING ({len(pipeline.elements)} elements) "
            f"on {pipeline.device}",
            file=sys.stderr,
        )
    t0 = time.perf_counter()
    try:
        pipeline.run(timeout=args.timeout)
    except TimeoutError as exc:
        print(f"nns-launch: {exc}", file=sys.stderr)
        return 1
    except Exception as exc:  # noqa: BLE001 — CLI boundary: report, exit 1
        print(f"nns-launch: pipeline error: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"EOS after {time.perf_counter() - t0:.3f}s", file=sys.stderr)
        for e in pipeline.elements:
            if hasattr(e, "rendered"):
                print(f"  {e.name}: rendered {e.rendered} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
