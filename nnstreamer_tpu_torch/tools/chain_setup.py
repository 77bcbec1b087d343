"""Set-up time of a whole-chain pipeline, phase by phase.

Runs the 720p labeling pipeline with a queue between its two fused
segments (converter + resize => MobileNet-v2 + labeling decoder; the chain
program's own case) ``--runs`` times, each from a fresh parse, and times:

- ``parse_s``: parse, negotiation and the plan;
- ``decide_s``: :func:`decide_chain` over the plan's chains (the chain
  verdict: structural checks, then the analyzers' hazard pass);
- ``executor_s``: ``Executor(plan)`` on the same plan (its own verdicts
  included);
- ``run_s``: start to EOS over ``--frames`` frames, the captures included.

``--preimport`` first times ``import torch._dynamo`` (``preimport_s``),
which ``FakeTensorMode`` pulls in at its first use, so the first run's
``decide_s`` shows the trace without that one-off import.

``--root`` imports the port's package from another checkout (default: the
checkout holding this file), so two commits can be timed on one card in
one call: run it as a file, once for each root, in the order parent,
change, change, parent. Prints one JSON object.

    python3 nnstreamer_tpu_torch/tools/chain_setup.py [--root DIR]
        [--device cuda|cpu] [--runs 5] [--frames 16] [--width 1280 --height 720]
        [--preimport]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

DESC = (
    "videotestsrc name=src pattern=gradient width={w} height={h} num-frames={n} ! "
    "tensor_converter name=conv queue-size=128 ! "
    "tensor_transform name=resize mode=resize option=224:224 ! queue name=q ! "
    "tensor_filter name=f framework=torch model=zoo:mobilenet_v2 ! "
    "tensor_decoder name=dec mode=image_labeling ! tensor_sink name=out"
)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here, help="checkout whose package is timed")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--preimport", action="store_true",
                    help="time `import torch._dynamo` before the runs")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != os.path.dirname(__file__)]
    os.environ["NNS_TPU_EXECUTOR_CHAIN_MODE"] = "auto"
    os.environ["NNS_TPU_EXECUTOR_CHAIN_UNROLL"] = "4"
    from nnstreamer_tpu_torch.pipeline.chain_program import decide_chain
    from nnstreamer_tpu_torch.pipeline.executor import Executor
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    desc = DESC.format(w=args.width, h=args.height, n=args.frames)
    preimport_s = None
    if args.preimport:
        t0 = time.perf_counter()
        import torch._dynamo  # noqa: F401

        preimport_s = time.perf_counter() - t0
    runs = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        p = parse_pipeline(desc, device=args.device)
        plan = p.compile_plan()
        t1 = time.perf_counter()
        verdicts = [decide_chain(plan, chain) for chain in plan.chains()]
        t2 = time.perf_counter()
        ex = Executor(plan)
        t3 = time.perf_counter()
        ex.start()
        done = ex.wait(600)
        ex.stop()
        t4 = time.perf_counter()
        if ex.errors or not done:
            raise SystemExit(f"chain_setup: run failed: {ex.errors or 'no EOS'}")
        if len(p["out"].frames) != args.frames:
            raise SystemExit(f"chain_setup: {len(p['out'].frames)} frames at the sink")
        runs.append({"parse_s": t1 - t0, "decide_s": t2 - t1, "executor_s": t3 - t2,
                     "run_s": t4 - t3,
                     "chains": [[v.compiles, v.reason, v.unroll] for v in verdicts]})
    import torch

    print(json.dumps({"root": root, "device": args.device or "cuda",
                      "torch": torch.__version__, "preimport_s": preimport_s, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
