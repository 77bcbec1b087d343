#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nnstreamer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero:

1. build    — compile every CUDA source under nnstreamer_tpu_torch/csrc
              with nvcc for sm_90a (one nvcc per source, all at once).
2. kernels  — the crop/resize kernel (K1) in both entry points against its
              plain PyTorch version on the same GPU inputs: error, kernel /
              plain / library device time (torch.profiler; the stream time
              of back-to-back calls, host dispatch gaps included, beside
              it), and the bound (bytes over 3.35 TB/s vs float ops over
              67 TFLOP/s, the larger).
3. pipeline — the image-labeling pipeline (1280x720 gradient frames →
              resize 224 → MobileNet-v2 1.0/224/1001 → image_labeling) for
              64 frames on the GPU: K1 launched exactly once per frame, the
              model's outputs on the GPU, the first labels equal to the
              port's own CPU run; frames per second free-running, and
              end-to-end latency p50/p99 with the source paced at 30 fps.
4. profile  — device time by kernel over 16 pipeline frames (torch.profiler).
5. single   — SingleShot invoke on the GPU, logits against the CPU's.

TF32 is off throughout (cuDNN would otherwise run float32 convolutions in
TF32), so GPU and CPU runs compare at float32 precision. The last lines
are the card's name and power limit (nvidia-smi), the kernel summary
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import zlib

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12  # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2**20
FRAMES = 64
PIPELINE = (
    "videotestsrc pattern=gradient width=1280 height=720 num-frames={n}{live} "
    "stamp-wall=true ! tensor_converter ! "
    "tensor_transform mode=resize option=224:224 ! "
    "tensor_filter name=f framework=torch model=zoo:mobilenet_v2 ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, pool, reps: int) -> float:
    """Device time per call: the summed durations of every GPU kernel and
    copy the calls ran (torch.profiler), over ``reps`` calls cycling through
    ``pool`` (inputs larger than L2, so each call reads cold memory)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for args in pool[:3]:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*pool[i % len(pool)])
        torch.cuda.synchronize()
    total_us = sum(
        ev.self_device_time_total for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA
    )
    if total_us <= 0:
        raise AssertionError("profiler recorded no device time")
    return total_us / 1e3 / reps


def time_ms(torch, fn, pool, reps: int) -> float:
    """Stream time per call over ``reps`` back-to-back calls (CUDA events):
    device time plus any gap while the host dispatches the next call."""
    for args in pool[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*pool[i % len(pool)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_case(torch, np, ik, name, dtype, shape, out_hw, boxes=None,
                scale=None, offset=None):
    """One K1 case on the GPU: kernel vs plain version, timings, bound."""
    import torch.nn.functional as F

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    out_h, out_w = out_hw
    h, w, c = shape[-3:]
    host = (
        rng.integers(0, 256, shape).astype(np.uint8) if dtype is torch.uint8
        else rng.standard_normal(shape).astype(np.float32)
    )
    img = torch.from_numpy(host).cuda().to(dtype)
    crop = boxes is not None
    tbox = torch.from_numpy(boxes).cuda() if crop else None
    n = boxes.shape[0] if crop else shape[0]
    out_dtype = torch.float32 if (scale is not None or offset is not None) else dtype

    def kernel(x, b):
        if crop:
            return ik.crop_and_resize(x, b, out_h, out_w, scale=scale, offset=offset)
        return ik.resize_bilinear(x, out_h, out_w, scale=scale, offset=offset)

    def plain(x, b):
        return ik.plain_crop_resize(x, b, n, out_h, out_w, scale, offset, out_dtype)

    got = kernel(img, tbox)
    want = plain(img, tbox)
    torch.cuda.synchronize()
    err = (got.to(torch.float32) - want.to(torch.float32)).abs().max().item()
    tol = ik.interp_atol(out_dtype, h, w)
    if got.shape != want.shape or got.dtype != want.dtype or not err <= tol:
        raise AssertionError(f"{name}: kernel vs plain max_abs_err {err} > {tol}")

    in_bytes = img.numel() * img.element_size()
    copies = min(64, max(2, math.ceil(2 * L2_BYTES / in_bytes)))
    pool = [(img.clone(), tbox) for _ in range(copies)]
    ms = device_ms(torch, kernel, pool, 100)
    stream_ms = time_ms(torch, kernel, pool, 200)
    plain_ms = device_ms(torch, plain, pool, 20)
    library_ms = library_stream_ms = None
    if not crop:
        # the same full-image resize as one PyTorch call, on float NCHW
        lib_pool = [
            (x.permute(0, 3, 1, 2).to(torch.float32 if dtype is torch.uint8 else dtype)
             .contiguous(), None) for x, _ in pool
        ]

        def library(x, _):
            return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                                 align_corners=False, antialias=False)

        library_ms = device_ms(torch, library, lib_pool, 100)
        library_stream_ms = time_ms(torch, library, lib_pool, 200)
        del lib_pool

    # bound: each distinct source row a sample touches read once, the
    # output written once; ~9 float ops per output element (3 lerps)
    cpu_boxes = (
        torch.from_numpy(boxes) if crop
        else torch.tensor([[0.0, 0.0, float(w), float(h)]]).expand(n, 4)
    )
    y0, y1, _ = ik._axis_taps(cpu_boxes[:, 1], cpu_boxes[:, 3], out_h, h)
    rows = torch.cat([y0, y1], dim=1)
    images_rows = (
        len(torch.unique(rows)) if crop
        else sum(len(torch.unique(r)) for r in rows)
    )
    row_bytes = w * c * img.element_size()
    out_bytes = got.numel() * got.element_size()
    n_bytes = images_rows * row_bytes + out_bytes + (boxes.nbytes if crop else 0)
    n_ops = got.numel() * (9 + (scale is not None) + (offset is not None))
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_F32_OPS_S * 1e3
    return {
        "case": name,
        "entry": "crop_and_resize" if crop else "resize_bilinear",
        "in": f"{list(shape)} {str(dtype).removeprefix('torch.')}",
        "out": f"{list(got.shape)} {str(out_dtype).removeprefix('torch.')}",
        "max_abs_err": err,
        "tolerance": tol,
        "kernel_ms": ms,
        "kernel_stream_ms": stream_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_stream_ms": library_stream_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes,
    }


def run_pipeline(parse_pipeline, device, n, live=False, hook=None):
    p = parse_pipeline(
        PIPELINE.format(n=n, live=" is-live=true framerate=30/1" if live else ""),
        device=device,
    )
    p.negotiate()
    if hook is not None:
        p["f"].backend.module.register_forward_hook(hook)
    t0 = time.perf_counter()
    p.run(timeout=600)
    wall = time.perf_counter() - t0
    frames = p["out"].frames
    labels = [int(f.tensors[0][0]) for f in frames]
    lat_ms = sorted((f.meta["render_t"] - f.meta["wall_t0"]) * 1e3 for f in frames)
    return labels, wall, lat_ms


def pct(sorted_vals, q):
    return sorted_vals[min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from nnstreamer_tpu_torch.ops.kernels import _build
    from nnstreamer_tpu_torch.ops.kernels import image_kernels as ik
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
    from nnstreamer_tpu_torch.single import SingleShot

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_info()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 1. build -------------------------------------------------------------
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    libs = _build.build(sources)
    emit({"phase": "build", "sources": sources, "seconds": time.perf_counter() - t0,
          "libraries": [str(p.name) for p in libs.values()]})

    # 2. kernels -------------------------------------------------------------
    crop_boxes = np.array([
        [0, 0, 1280, 720], [100.5, 50.25, 400.75, 300.5], [-20, -10, 200, 150],
        [640, 360, 640, 360],  # degenerate
        [900, 500, 1279, 719], [10, 600, 300, 719.5], [500, 0, 780, 720],
        [1200.5, 700.5, 1300, 760],
    ], np.float32)
    cases = [
        kernel_case(torch, np, ik, "resize-u8-720p-224", torch.uint8,
                    (1, 720, 1280, 3), (224, 224)),
        kernel_case(torch, np, ik, "resize-f32-480p-300", torch.float32,
                    (2, 480, 640, 3), (300, 300)),
        kernel_case(torch, np, ik, "resize-bf16-480p-300", torch.bfloat16,
                    (2, 480, 640, 3), (300, 300)),
        kernel_case(torch, np, ik, "crop-u8-720p-8box-112", torch.uint8,
                    (720, 1280, 3), (112, 112), boxes=crop_boxes),
        kernel_case(torch, np, ik, "resize-u8-720p-224-normalize", torch.uint8,
                    (1, 720, 1280, 3), (224, 224), scale=1 / 255, offset=-0.5),
    ]
    emit({"phase": "kernels", "cases": cases})

    # 3. pipeline ------------------------------------------------------------
    dev = torch.device("cuda")
    run_pipeline(parse_pipeline, dev, 4)  # warm-up: cuDNN, allocator, library
    cpu_labels, _, _ = run_pipeline(parse_pipeline, "cpu", 4)
    out_devices = set()
    ik.crop_resize_launches.reset()
    labels, wall, lat_free = run_pipeline(
        parse_pipeline, dev, FRAMES,
        hook=lambda m, i, o: out_devices.add(o.device.type),
    )
    launches = ik.crop_resize_launches.count
    if launches != FRAMES:
        raise AssertionError(f"K1 launched {launches} times for {FRAMES} frames")
    if out_devices != {"cuda"}:
        raise AssertionError(f"filter outputs on {out_devices}, want cuda")
    if len(labels) != FRAMES or labels[:4] != cpu_labels:
        raise AssertionError(f"labels {labels[:4]} != CPU run {cpu_labels}")
    ik.crop_resize_launches.reset()
    _, _, lat_live = run_pipeline(parse_pipeline, dev, FRAMES, live=True)
    live_launches = ik.crop_resize_launches.count
    if live_launches != FRAMES:
        raise AssertionError(f"paced run: K1 launched {live_launches} times")
    emit({
        "phase": "pipeline", "frames": FRAMES, "k1_launches": launches,
        "labels_first4": labels[:4], "cpu_labels_first4": cpu_labels,
        "fps": FRAMES / wall, "wall_s": wall,
        "free_latency_ms_p50": pct(lat_free, 0.5), "free_latency_ms_p99": pct(lat_free, 0.99),
        "paced30_latency_ms_p50": pct(lat_live, 0.5),
        "paced30_latency_ms_p99": pct(lat_live, 0.99),
    })

    # 4. profile -------------------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = parse_pipeline(PIPELINE.format(n=16, live=""), device=dev)
    p.negotiate()  # model built and warmed outside the profiled window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.run(timeout=600)
        prof_wall = time.perf_counter() - t0
    rows = sorted(
        ((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    classes = {"conv": 0.0, "crop_resize (K1)": 0.0, "memcpy": 0.0, "other": 0.0}
    for dt, key, _ in rows:
        low = key.lower()
        if "crop_resize" in low:
            classes["crop_resize (K1)"] += dt / 1e3
        elif "memcpy" in low or "memset" in low:
            classes["memcpy"] += dt / 1e3
        elif any(t in low for t in ("conv", "xmma", "fprop", "gemm", "cudnn")):
            classes["conv"] += dt / 1e3
        else:
            classes["other"] += dt / 1e3
    device_ms = sum(classes.values())
    emit({
        "phase": "profile", "frames": 16, "wall_ms": prof_wall * 1e3,
        "device_ms": device_ms if rows else "not measured",
        "device_busy_share": device_ms / 1e3 / prof_wall if rows else "not measured",
        "device_ms_by_class": classes,
        "device_kernels": sum(n for _, _, n in rows),
        "top_kernels": [
            {"name": k[:80], "device_ms": dt / 1e3, "calls": n} for dt, k, n in rows[:8]
        ],
    })

    # 5. single --------------------------------------------------------------
    x = np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3)).astype(np.uint8)
    with SingleShot(framework="torch", model="zoo:mobilenet_v2", device=dev) as s:
        (gpu_logits,) = s.invoke(x)
        gpu_logits = gpu_logits.cpu()
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.invoke(x)[0].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
    with SingleShot(framework="torch", model="zoo:mobilenet_v2", device="cpu") as s:
        (cpu_logits,) = s.invoke(x)
    err = (gpu_logits - cpu_logits).abs().max().item()
    tol = 1e-3 * cpu_logits.abs().max().item()  # float32, two summation orders
    if gpu_logits.shape != (1, 1001) or not torch.isfinite(gpu_logits).all():
        raise AssertionError(f"bad logits {gpu_logits.shape}")
    if not err <= tol or gpu_logits.argmax() != cpu_logits.argmax():
        raise AssertionError(f"single: GPU vs CPU logits err {err} > {tol} or top-1 differs")
    emit({"phase": "single", "max_abs_err": err, "tolerance": tol,
          "top1": int(gpu_logits.argmax()), "invoke_ms_p50": sorted(times)[10]})

    main_case = cases[0]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "crop_resize",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/image_kernels.cu",
        "replaces": "nnstreamer_tpu/ops/pallas/image_kernels.py:165",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
