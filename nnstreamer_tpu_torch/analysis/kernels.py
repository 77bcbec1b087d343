"""nns-kscope for the port: a static launch analyzer for K1-K5 on Hopper.

The counterpart of ``nnstreamer_tpu/analysis/kernels.py``, which walks
Pallas ``BlockSpec`` index maps over a TPU grid against the core's VMEM.
The port's kernels are CUDA (``nnstreamer_tpu_torch/csrc``), so what a
launch asks of the card is a grid, a block and shared memory, and what
can break is the SM's budget. For every kernel and case (the main path's
shapes, :data:`SPECS`):

- **one launch plan** (:class:`Launch`, per kernel of the launch, in
  launch order): grid, threads a block and dynamic shared memory, from
  the geometry the wrappers compute (``decode_attention.split_plan``,
  ``nms.nms_plan``) and each ``.cu``'s shared-memory formula
  (``chunk_smem_bytes`` and the block table in
  ``attn_tile.cuh`` / ``paged_attention.cu``, ``smem16_bytes`` /
  ``smem32_bytes`` in ``flash_attention.cu``; K1 and K2 use static shared
  memory only). On the card, :func:`read_launches` asks each ``.cu``'s
  ``nns_*_launch_info`` query (csrc/launch_info.cuh) for the launch its
  own host code makes, and the two must be equal;
- **NNS-W127**: a launch the card cannot run — dynamic shared memory above
  232448 B a block, registers x threads above 65536, more than 1024
  threads, ``gridDim.y`` or ``gridDim.z`` above 65535, or no block
  resident on an SM (registers and residency are the card's readings);
- **NNS-W128**: a plan hazard — an operand whose alignment or size breaks
  a vector load the kernel assumes (16-byte ``cp.async`` rows, ``float4``
  boxes, a candidate count past the scan's shared words), or a head dim
  the kernel refuses;
- **a roofline row** (:class:`~nnstreamer_tpu_torch.analysis.costmodel.KernelCost`):
  the bytes the function must move, the operations and the unit that does
  them, and the bound at 3.35 TB/s or that unit's peak — the same
  arithmetic as ``chip_smoke.py``'s bound column.

Registers, static shared memory, spills (local bytes) and resident blocks
an SM are row values, read on the card only. The Pallas-only parts of the
reference (index-map walks, lane / sublane tiles, VMEM) have no
counterpart here.

:func:`kernel_request_pass` is the pipeline consumer (NNS-W129): an
element that explicitly requests a kernel (``impl=pallas``,
``attn-impl=pallas``, ``attn:flash``) the card cannot honour, told at
lint time. :func:`engage` is ``nns-xray``'s dispatch table on the device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from nnstreamer_tpu_torch.analysis.costmodel import H100, KernelCost
from nnstreamer_tpu_torch.analysis.diagnostics import LintReport

# -- the card's limits (NVIDIA H100, compute capability 9.0) ----------------
MAX_DYN_SMEM = 232_448        # dynamic shared memory a block can opt into
REGS_PER_SM = 65_536          # 32-bit registers an SM (and a block) has
MAX_THREADS = 1_024           # threads a block
MAX_GRID_YZ = 65_535          # gridDim.y and gridDim.z
MAX_GRID_X = 2 ** 31 - 1

#: the fields ``nns_*_launch_info`` writes a kernel (csrc/launch_info.cuh)
INFO_FIELDS = ("grid_x", "grid_y", "grid_z", "block_x", "block_y", "block_z", "dyn_smem",
               "regs", "static_smem", "local_bytes", "max_threads", "blocks_per_sm")

_ESIZE = {"uint8": 1, "int8": 1, "bfloat16": 2, "float16": 2, "float32": 4}
_DTYPE_CODE = {"uint8": 0, "float32": 1, "bfloat16": 2}  # image_kernels.cu's enum
_ATTN_CODE = {"float32": 0, "bfloat16": 1, "int8": 2}     # attn_tile.cuh's DType
_FLASH_CODE = {"float32": 0, "bfloat16": 1, "float16": 2}


@dataclass(frozen=True)
class Launch:
    """One kernel launch of a plan: what the host code asks of the card."""

    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    dyn_smem: int = 0

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    def key(self) -> Tuple:
        return (self.grid, self.block, self.dyn_smem)


@dataclass(frozen=True)
class Case:
    name: str
    params: Dict[str, Any]


@dataclass
class KernelSpec:
    """One hand-written kernel: the TPU kernel it replaces, its source,
    its main-path cases, and its plan / cost / hazard / card-query
    functions of a case's params."""

    name: str                      # the entry point
    tpu_kernel: str                # K1 .. K5
    replaces: str                  # file:line of the pl.pallas_call
    source: str                    # the .cu in the repo
    cases: List[Case]
    plan: Callable[[Dict[str, Any]], List[Launch]]
    cost: Callable[[Dict[str, Any]], KernelCost]
    hazards: Callable[[Dict[str, Any]], List[str]]
    query: Callable[[Dict[str, Any]], List[Dict[str, int]]]


# -- K1: bilinear crop / resize ---------------------------------------------

def _k1_rows(p: Dict[str, Any]) -> int:
    """Distinct source rows the samples touch (counted a box for a resize,
    once over all boxes of a crop): the ``_axis_taps`` of the kernel."""
    import torch

    from nnstreamer_tpu_torch.ops.kernels.image_kernels import _axis_taps

    h, w = p["h"], p["w"]
    if p.get("boxes") is None:
        boxes = torch.tensor([[0.0, 0.0, float(w), float(h)]]).expand(p["n"], 4)
    else:
        boxes = torch.tensor(p["boxes"], dtype=torch.float32)
    y0, y1, _ = _axis_taps(boxes[:, 1], boxes[:, 3], p["out_h"], h)
    rows = torch.cat([y0, y1], dim=1)
    if p.get("boxes") is not None:
        return len(torch.unique(rows))
    return sum(len(torch.unique(r)) for r in rows)


def k1_plan(p: Dict[str, Any]) -> List[Launch]:
    total = p["n"] * p["out_h"] * p["out_w"]
    return [Launch("crop_resize_kernel", (-(-total // 256), 1, 1), (256, 1, 1), 0)]


def k1_cost(p: Dict[str, Any]) -> KernelCost:
    esz, osz = _ESIZE[p["dtype"]], _ESIZE[p.get("out_dtype", p["dtype"])]
    out_elems = p["n"] * p["out_h"] * p["out_w"] * p["c"]
    boxes = 16 * p["n"] if p.get("boxes") is not None else 0
    epilogue = ("scale" in p) + ("offset" in p)
    return KernelCost(hbm_read_bytes=_k1_rows(p) * p["w"] * p["c"] * esz + boxes,
                      hbm_write_bytes=out_elems * osz, flops=out_elems * (9 + epilogue),
                      unit="fp32")


def k1_hazards(p: Dict[str, Any]) -> List[str]:
    out = []
    if p["dtype"] not in _DTYPE_CODE or p.get("out_dtype", p["dtype"]) not in _DTYPE_CODE:
        out.append(f"dtype {p['dtype']} -> {p.get('out_dtype', p['dtype'])}: the kernel "
                   "takes uint8, float32 and bfloat16")
    if p["out_h"] <= 0 or p["out_w"] <= 0:
        out.append(f"output {p['out_h']}x{p['out_w']} is empty")
    return out


def k1_query(p: Dict[str, Any]) -> List[Dict[str, int]]:
    fn = _lib("image_kernels").nns_crop_resize_launch_info
    args = (_DTYPE_CODE[p["dtype"]], _DTYPE_CODE[p.get("out_dtype", p["dtype"])], p["n"], p["h"],
            p["w"], p["c"], p["out_h"], p["out_w"])
    return _call(fn, args, 1, "nns_crop_resize_launch_info")


# -- K2: greedy NMS, IoU bitmask + word scan ----------------------------------

NMS_TILE = 64
NMS_MASK_WAVE = 132 * 8          # nms.cu kMaskWave
NMS_SCAN_THREADS = 512
NMS_OPS_PER_COLUMN = 12          # one masked IoU column (chip_smoke.py)


def k2_plan(p: Dict[str, Any]) -> List[Launch]:
    from nnstreamer_tpu_torch.ops.kernels.nms import nms_plan

    tiles = nms_plan(p["n"]).tiles
    four = tiles <= NMS_MASK_WAVE
    return [Launch(f"nms_kernel_mask<{4 if four else 1}>", (tiles, 1, 1),
                   ((4 if four else 1) * NMS_TILE, 1, 1), 0),
            Launch("nms_kernel_scan", (1, 1, 1), (NMS_SCAN_THREADS, 1, 1), 0)]


def k2_cost(p: Dict[str, Any]) -> KernelCost:
    """Boxes and scores in, the alive mask out; the IoU columns the greedy
    steps visit: sum over kept i of (m - 1 - i). The data decides which
    are kept: ``kept`` (their indices) where the case gives it, else every
    one of the ``m`` live candidates (the most the data could need)."""
    n = p["n"]
    m = p.get("m", n)
    kept = p.get("kept")
    columns = (sum(m - 1 - i for i in kept) if kept is not None else m * (m - 1) // 2)
    return KernelCost(hbm_read_bytes=n * 20, hbm_write_bytes=n * 4,
                      flops=NMS_OPS_PER_COLUMN * columns, unit="fp32")


def k2_hazards(p: Dict[str, Any]) -> List[str]:
    from nnstreamer_tpu_torch.ops.kernels.nms import MAX_N

    out = []
    if not 0 < p["n"] <= MAX_N:
        out.append(f"n {p['n']} candidates: the scan's shared words hold 1..{MAX_N}")
    if p.get("boxes_offset", 0) % 16:
        out.append(f"boxes start {p['boxes_offset']} B past a 16-byte boundary: the kernel "
                   "reads each box as one float4")
    return out


def k2_query(p: Dict[str, Any]) -> List[Dict[str, int]]:
    return _call(_lib("nms").nns_nms_launch_info, (p["n"],), 2, "nns_nms_launch_info")


# -- K3 / K4: split decode attention --------------------------------------------

ATTN_STAGES = 4
ATTN_THREADS = 128
ATTN_MAX_CHUNK = 1024


def _padded_d(d: int) -> int:
    return 64 if d <= 64 else 128 if d <= 128 else 256


def heads_per_block(g: int) -> int:
    """attn_tile.cuh ``heads_per_block``."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def chunk_smem_bytes(dtype: str, dp: int, gh: int) -> int:
    """attn_tile.cuh ``chunk_smem_bytes<CT, kQuant, DP, GH>``: the cp.async
    ring of kStages tiles (K and V rows, int8 scales beside them), reused
    after the loop for the groups' states and merge weights."""
    quant = dtype == "int8"
    groups = 4 * (32 // (32 if dp == 256 else 16))
    tile_rows = groups * 2
    stage = 2 * tile_rows * (dp * _ESIZE[dtype] + (4 if quant else 0))
    merge = 4 * groups * gh * (dp + 3)
    return max(ATTN_STAGES * stage, merge)


def _attn_launches(p: Dict[str, Any], rows: int, table: bool) -> List[Launch]:
    from nnstreamer_tpu_torch.ops.kernels.decode_attention import split_plan

    plan = split_plan(rows)
    g = p["h"] // p["kv"]
    gh = heads_per_block(g)
    smem = chunk_smem_bytes(p["dtype"], _padded_d(p["d"]), gh)
    if table:
        smem += 4 * (plan.chunk + 4)  # paged_attention.cu table_bytes(chunk)
    grid = (p["kv"] * -(-g // gh), p["b"], plan.splits)
    name = "paged_attention" if table else "decode_attention"
    return [Launch(f"{name}_split_kernel", grid, (ATTN_THREADS, 1, 1), smem),
            Launch(f"{name}_combine_kernel", (p["h"], p["b"], 1), (ATTN_THREADS, 1, 1), 0)]


def k3_plan(p: Dict[str, Any]) -> List[Launch]:
    return _attn_launches(p, p["s"], table=False)


def k3_cost(p: Dict[str, Any]) -> KernelCost:
    """The live rows' K and V (int8 scales beside them), q in, out and pos;
    q.k and p.v a multiply-add each per element (chip_smoke.py)."""
    live = [min(max(x, 0) + 1, p["s"]) for x in p["pos"]]
    esz = _ESIZE[p["dtype"]]
    qsz = 2 if p.get("q_dtype") == "bfloat16" else 4
    kvb = sum(live) * p["kv"] * p["d"] * 2 * esz
    if p["dtype"] == "int8":
        kvb += sum(live) * p["kv"] * 2 * 4
    b, h, d = p["b"], p["h"], p["d"]
    unit = "fp32"
    return KernelCost(hbm_read_bytes=kvb + b * h * d * qsz + b * 4,
                      hbm_write_bytes=b * h * d * 4, flops=sum(live) * h * 4 * d, unit=unit)


def _attn_hazards(p: Dict[str, Any]) -> List[str]:
    out = []
    h, kv, d = p["h"], p["kv"], p["d"]
    if kv <= 0 or h % kv:
        out.append(f"H {h} is no multiple of KV {kv}")
    elif h // kv > 32:
        out.append(f"{h // kv} query heads a kv head: the kernel takes at most 32")
    if not (0 < d <= 256 and d % 4 == 0):
        out.append(f"head dim {d}: the kernel takes D % 4 == 0 up to 256")
    if p.get("cache_offset", 0) % 16:
        out.append(f"cache rows start {p['cache_offset']} B past a 16-byte boundary: the "
                   "kernel's cp.async loads move 16 bytes")
    if p["dtype"] not in _ATTN_CODE:
        out.append(f"cache dtype {p['dtype']}: the kernel takes float32, bfloat16 and int8")
    return out


def k3_query(p: Dict[str, Any]) -> List[Dict[str, int]]:
    from nnstreamer_tpu_torch.ops.kernels.decode_attention import split_plan

    plan = split_plan(p["s"])
    q = 1 if p.get("q_dtype") == "bfloat16" else 0
    args = (q, _ATTN_CODE[p["dtype"]], p["b"], p["s"], p["h"], p["kv"], p["d"], plan.chunk,
            plan.splits)
    return _call(_lib("decode_attention").nns_decode_attention_launch_info, args, 2,
                 "nns_decode_attention_launch_info")


def k4_plan(p: Dict[str, Any]) -> List[Launch]:
    return _attn_launches(p, p["nb"] * p["bs"], table=True)


def k4_cost(p: Dict[str, Any]) -> KernelCost:
    """K3's bytes over each slot's history rows (pos, clamped to the
    table), the live table entries, and the pending token's K and V."""
    b, h, kv, d, bs, nb = p["b"], p["h"], p["kv"], p["d"], p["bs"], p["nb"]
    hist = [min(max(x, 0), nb * bs) for x in p["pos"]]
    esz = _ESIZE[p["dtype"]]
    rows = sum(hist)
    kvb = rows * kv * d * 2 * esz + (rows * kv * 2 * 4 if p["dtype"] == "int8" else 0)
    blocks = sum(-(-x // bs) for x in hist)
    qsz = 2 if p.get("q_dtype") == "bfloat16" else 4
    return KernelCost(
        hbm_read_bytes=kvb + blocks * 4 + b * h * d * qsz + 2 * b * kv * d * qsz + b * 4,
        hbm_write_bytes=b * h * d * 4, flops=(rows + b) * h * 4 * d, unit="fp32")


def k4_query(p: Dict[str, Any]) -> List[Dict[str, int]]:
    from nnstreamer_tpu_torch.ops.kernels.decode_attention import split_plan

    plan = split_plan(p["nb"] * p["bs"])
    q = 1 if p.get("q_dtype") == "bfloat16" else 0
    args = (q, _ATTN_CODE[p["dtype"]], p["b"], p["nb"], p["bs"], p["h"], p["kv"], p["d"],
            plan.chunk, plan.splits)
    return _call(_lib("paged_attention").nns_paged_attention_launch_info, args, 2,
                 "nns_paged_attention_launch_info")


# -- K5: flash prefill attention ----------------------------------------------

FLASH_BQ = 64
FLASH_BK32 = 32
FLASH_THREADS = 128


def flash_smem_bytes(dtype: str, dp: int) -> int:
    """flash_attention.cu ``smem32_bytes`` (float32: Q and two K, V tiles
    of [rows][DP + 4] floats) or ``smem16_bytes`` (16-bit: 1 KiB of
    alignment and five [64][DP] tiles)."""
    if dtype == "float32":
        return 4 * (dp + 4) * (FLASH_BQ + 4 * FLASH_BK32)
    return 1024 + 5 * FLASH_BQ * dp * 2


def k5_plan(p: Dict[str, Any]) -> List[Launch]:
    dp = _padded_d(p["d"])
    return [Launch("flash_attention32_kernel" if p["dtype"] == "float32"
                   else "flash_attention16_kernel",
                   (-(-p["t"] // FLASH_BQ), p["h"], p["b"]), (FLASH_THREADS, 1, 1),
                   flash_smem_bytes(p["dtype"], dp))]


def k5_cost(p: Dict[str, Any]) -> KernelCost:
    """q, k, v in, float32 out; the live (query, key) pairs' q.k and p.v.
    float32 runs three TF32 products a product (3xTF32); 16-bit one."""
    b, t, h, d = p["b"], p["t"], p["h"], p["d"]
    esz = _ESIZE[p["dtype"]]
    pairs = t * (t + 1) // 2 if p.get("causal", True) else t * t
    ops = 4 * b * h * d * pairs
    f32 = p["dtype"] == "float32"
    return KernelCost(hbm_read_bytes=3 * b * t * h * d * esz, hbm_write_bytes=b * t * h * d * 4,
                      flops=3 * ops if f32 else ops, unit="tf32" if f32 else "bf16")


def k5_hazards(p: Dict[str, Any]) -> List[str]:
    from nnstreamer_tpu_torch.ops.kernels.flash_attention import kernel_takes_head_dim

    out = []
    if not kernel_takes_head_dim(p["d"]):
        out.append(f"head dim {p['d']}: the kernel takes D % 8 == 0 up to 256")
    if p["dtype"] not in _FLASH_CODE:
        out.append(f"dtype {p['dtype']}: the kernel takes float32, bfloat16 and float16")
    vec = 16 // _ESIZE.get(p["dtype"], 4)
    for s in p.get("strides", ()):
        if s % vec:
            out.append(f"stride {s} elements is no multiple of {vec}: the kernel's cp.async "
                       "rows start on 16-byte boundaries")
            break
    return out


def k5_query(p: Dict[str, Any]) -> List[Dict[str, int]]:
    args = (_FLASH_CODE[p["dtype"]], p["b"], p["t"], p["h"], p["d"])
    return _call(_lib("flash_attention").nns_flash_attention_launch_info, args, 1,
                 "nns_flash_attention_launch_info")


# -- the card's query ----------------------------------------------------------

def _lib(name: str):
    from nnstreamer_tpu_torch.ops.kernels import _build

    return _build.load(name)


def _call(fn, args: Sequence[int], n_launches: int, what: str) -> List[Dict[str, int]]:
    info = (ctypes.c_longlong * (len(INFO_FIELDS) * n_launches))()
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_longlong)]
    err = fn(*args, info)
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
    k = len(INFO_FIELDS)
    return [dict(zip(INFO_FIELDS, info[i * k:(i + 1) * k])) for i in range(n_launches)]


# -- the registry of kernels and their main-path cases --------------------------

_MISTRAL = dict(b=8, h=32, kv=8, d=128)

SPECS: List[KernelSpec] = [
    KernelSpec(
        "crop_and_resize / resize_bilinear", "K1",
        "nnstreamer_tpu/ops/pallas/image_kernels.py:165",
        "nnstreamer_tpu_torch/csrc/image_kernels.cu",
        [Case("resize-u8-720p-224", dict(n=1, h=720, w=1280, c=3, out_h=224, out_w=224,
                                         dtype="uint8")),
         Case("resize-u8-720p-300", dict(n=1, h=720, w=1280, c=3, out_h=300, out_w=300,
                                         dtype="uint8")),
         Case("crop-f32-128-16box-112", dict(
             n=16, h=128, w=128, c=3, out_h=112, out_w=112, dtype="float32",
             boxes=[[8.0 * (i % 4), 8.0 * (i // 4), 8.0 * (i % 4) + 96, 8.0 * (i // 4) + 96]
                    for i in range(16)]))],
        k1_plan, k1_cost, k1_hazards, k1_query),
    KernelSpec(
        "nms_mask", "K2", "nnstreamer_tpu/ops/pallas/nms.py:119",
        "nnstreamer_tpu_torch/csrc/nms.cu",
        [Case("nms-ssd-1917", dict(n=1917)), Case("nms-yolo-6300", dict(n=6300))],
        k2_plan, k2_cost, k2_hazards, k2_query),
    KernelSpec(
        "decode_attention", "K3", "nnstreamer_tpu/ops/pallas/decode_attention.py:178",
        "nnstreamer_tpu_torch/csrc/decode_attention.cu",
        [Case("serve-f32-pos600", dict(_MISTRAL, s=4096, pos=[600] * 8, dtype="float32")),
         Case("serve-bf16-pos600", dict(_MISTRAL, s=4096, pos=[600] * 8, dtype="bfloat16",
                                        q_dtype="bfloat16")),
         Case("serve-int8-pos600", dict(_MISTRAL, s=4096, pos=[600] * 8, dtype="int8"))],
        k3_plan, k3_cost, _attn_hazards, k3_query),
    KernelSpec(
        "paged_decode_attention", "K4", "nnstreamer_tpu/ops/pallas/paged_attention.py:202",
        "nnstreamer_tpu_torch/csrc/paged_attention.cu",
        [Case("serve-f32-pos600", dict(_MISTRAL, bs=16, nb=256, n_blocks=1025, pos=[600] * 8,
                                       dtype="float32"))],
        k4_plan, k4_cost, _attn_hazards, k4_query),
    KernelSpec(
        "flash_attention", "K5", "nnstreamer_tpu/ops/pallas/flash_attention.py:158",
        "nnstreamer_tpu_torch/csrc/flash_attention.cu",
        [Case("b1-t4096-h32-d128-causal-f32", dict(b=1, t=4096, h=32, d=128, dtype="float32")),
         Case("b1-t4096-h32-d128-causal-bf16", dict(b=1, t=4096, h=32, d=128,
                                                    dtype="bfloat16"))],
        k5_plan, k5_cost, k5_hazards, k5_query),
]


def find(name: str) -> Optional[KernelSpec]:
    """The spec whose entry point, K number or source stem is ``name``."""
    for s in SPECS:
        stem = s.source.rsplit("/", 1)[-1][:-3]
        if name in (s.tpu_kernel, stem) or name in s.name.split(" / "):
            return s
    return None


# -- per-case report -------------------------------------------------------------

@dataclass
class CaseReport:
    """Everything nns-kscope derives for one kernel × case; ``card`` holds
    the card's reading per launch when :func:`analyze` read it."""

    kernel: str
    tpu_kernel: str
    case: str
    launches: List[Launch]
    cost: KernelCost
    hazards: List[str] = field(default_factory=list)
    card: List[Dict[str, int]] = field(default_factory=list)
    plan_matches: Optional[bool] = None

    def limits(self) -> List[str]:
        """Every way a launch exceeds the card (NNS-W127)."""
        out = []
        for i, ln in enumerate(self.launches):
            tag = f"{ln.kernel}"
            if ln.dyn_smem > MAX_DYN_SMEM:
                out.append(f"{tag}: {ln.dyn_smem} B of dynamic shared memory > {MAX_DYN_SMEM}")
            if ln.threads > MAX_THREADS:
                out.append(f"{tag}: {ln.threads} threads a block > {MAX_THREADS}")
            if ln.grid[1] > MAX_GRID_YZ or ln.grid[2] > MAX_GRID_YZ:
                out.append(f"{tag}: grid {ln.grid} past gridDim.y/z {MAX_GRID_YZ}")
            if ln.grid[0] > MAX_GRID_X or min(ln.grid) < 1:
                out.append(f"{tag}: grid {ln.grid} out of range")
            if i < len(self.card):
                c = self.card[i]
                if c["regs"] * ln.threads > REGS_PER_SM:
                    out.append(f"{tag}: {c['regs']} registers x {ln.threads} threads > "
                               f"{REGS_PER_SM}")
                if c["blocks_per_sm"] < 1:
                    out.append(f"{tag}: no block resident on an SM")
                if ln.threads > c["max_threads"]:
                    out.append(f"{tag}: {ln.threads} threads > the kernel's "
                               f"{c['max_threads']}")
        return out

    def to_row(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {
            "kernel": self.kernel, "tpu_kernel": self.tpu_kernel, "case": self.case,
            "launches": [
                {"kernel": ln.kernel, "grid": list(ln.grid), "block": list(ln.block),
                 "dyn_smem": ln.dyn_smem, **({k: self.card[i][k] for k in (
                     "regs", "static_smem", "local_bytes", "blocks_per_sm", "max_threads")}
                     if i < len(self.card) else {})}
                for i, ln in enumerate(self.launches)],
            "hbm_read_bytes": self.cost.hbm_read_bytes,
            "hbm_write_bytes": self.cost.hbm_write_bytes,
            "flops": self.cost.flops, "unit": self.cost.unit,
            "arithmetic_intensity": self.cost.arithmetic_intensity,
            "bound_ms": self.cost.bound_ms(H100), "bound_by": self.cost.bound_by(H100),
            "hazards": list(self.hazards), "limits": self.limits(),
            "plan_matches": self.plan_matches,
        }
        return row


def read_launches(spec: KernelSpec, case: Case) -> List[Dict[str, int]]:
    """The card's description of the launch the ``.cu``'s host code makes
    for ``case`` (needs a GPU and the kernel's library: built on first use)."""
    return spec.query(dict(case.params))


def analyze_case(spec: KernelSpec, case: Case, card: bool = False) -> CaseReport:
    """The static verdicts for one kernel × case; ``card`` also reads the
    launch the ``.cu`` makes and compares it with the plan."""
    p = dict(case.params)
    r = CaseReport(spec.name, spec.tpu_kernel, case.name, spec.plan(p), spec.cost(p),
                   spec.hazards(p))
    if card and not r.hazards:
        r.card = read_launches(spec, case)
        r.plan_matches = len(r.card) == len(r.launches) and all(
            ((c["grid_x"], c["grid_y"], c["grid_z"]), (c["block_x"], c["block_y"], c["block_z"]),
             c["dyn_smem"]) == ln.key() for c, ln in zip(r.card, r.launches))
    return r


def analyze(specs: Optional[Sequence[KernelSpec]] = None,
            card: bool = False) -> Tuple[List[CaseReport], LintReport]:
    """Every kernel × case → case reports and a LintReport of NNS-W127
    (a launch the card cannot run) and NNS-W128 (a plan hazard). ``card``
    reads each launch on the card too (registers, residency, the plan
    against the host code's launch)."""
    report = LintReport()
    reports: List[CaseReport] = []
    for spec in SPECS if specs is None else specs:
        for case in spec.cases:
            r = analyze_case(spec, case, card)
            reports.append(r)
            where = f"{r.tpu_kernel}:{r.case}"
            for lim in r.limits():
                report.add(
                    "NNS-W127", where, f"launch cannot run on the card: {lim}",
                    "shrink the tile (rows a block, stages) or split the launch; an H100 "
                    "block has at most 232448 B of dynamic shared memory, 65536 registers "
                    "and 1024 threads")
            for h in r.hazards:
                report.add(
                    "NNS-W128", where, f"plan hazard: {h}",
                    "keep operands 16-byte aligned with rows of whole 16-byte vectors, and "
                    "head dims the kernel takes (its wrapper raises before a launch)")
            if r.plan_matches is False:
                report.add(
                    "NNS-W128", where,
                    f"the analyzer's plan {[ln.key() for ln in r.launches]} differs from the "
                    f"launch the host code makes {r.card}",
                    "bring analysis/kernels.py's plan in line with the .cu's launcher")
    return reports, report


def engage(device=None) -> List[Dict[str, Any]]:
    """``nns-kscope --engage``: K1-K5's entry points probed on ``device``
    and their launch counters read (analysis/xray.py ``dispatch_table``).
    A row is ``ok`` when the implementation the device takes engaged: the
    kernel on CUDA, the plain version on the CPU."""
    from nnstreamer_tpu_torch.analysis.xray import dispatch_table

    rows = dispatch_table(device)
    for r in rows:
        r["ok"] = r["error"] is None and r["engaged"] == r["expected"]
    return rows


# -- pipeline-level pass (NNS-W129) ------------------------------------------

#: tensor_transform image modes with a kernel (K1) behind them
_TRANSFORM_KERNELS = {"resize": "resize_bilinear", "crop-resize": "crop_and_resize"}
_K1_DTYPES = ("uint8", "float32", "bfloat16")


def _input_dtype(pipeline, specs, e) -> Optional[str]:
    """The dtype the transform's kernel would see: the image tensor of the
    upstream out spec (the first tensor of rank >= 3, else the first)."""
    for link in pipeline.in_links(e):
        up = specs.get(link.src.name)
        if not up or link.src_pad >= len(up):
            continue
        tensors = getattr(up[link.src_pad], "tensors", None)
        if not tensors:
            continue
        img = next((t for t in tensors if t.rank >= 3), tensors[0])
        return str(img.dtype.value)
    return None


def _lm_heads(opts: Dict[str, str]) -> Tuple[int, int, int]:
    """(H, KV, D) of a zoo:transformer_lm custom string (its defaults)."""
    d_model = int(opts.get("d_model", 256))
    h = int(opts.get("n_heads", 8)) or 1
    kv = int(opts.get("n_kv_heads", h))
    return h, kv, d_model // h


def kernel_request_pass(pipeline, report: LintReport, specs) -> None:
    """NNS-W129: an element explicitly requests a kernel the card cannot
    honour: ``impl=pallas`` on a tensor_transform mode with no kernel (the
    request is ignored) or on a dtype K1 refuses (raises); an LLM
    serversink's ``attn-impl=pallas`` (K3 / K4) with heads or a head dim
    the kernel refuses; a ``zoo:transformer_lm`` filter with ``attn:flash``
    whose head dim K5 refuses on the card (the CPU's plain version takes
    any). Runs after lint's spec pass (``specs``: the upstream dtypes)."""
    from nnstreamer_tpu_torch.backends.base import FilterProps
    from nnstreamer_tpu_torch.ops.kernels.flash_attention import kernel_takes_head_dim

    for e in pipeline.elements:
        factory = getattr(type(e), "FACTORY_NAME", "")
        if factory == "tensor_transform":
            if str(e.get_property("impl", "auto") or "auto").lower() != "pallas":
                continue
            mode = str(e.get_property("mode", "") or "").lower()
            kernel = _TRANSFORM_KERNELS.get(mode)
            if kernel is None:
                report.add(
                    "NNS-W129", e.name,
                    f"impl=pallas requested but mode={mode} has no kernel: the request is "
                    "ignored and the mode's torch ops run",
                    "only resize / crop-resize run a kernel (K1): drop impl=pallas or "
                    "switch modes")
                continue
            dtype = _input_dtype(pipeline, specs, e)
            if dtype is not None and dtype not in _K1_DTYPES:
                report.add(
                    "NNS-W129", e.name,
                    f"impl=pallas requested but {kernel} (K1) refuses {dtype} input: the "
                    "wrapper raises",
                    "cast to uint8, float32 or bfloat16 upstream (tensor_transform "
                    "mode=typecast)")
        elif factory == "tensor_llm_serversink":
            if str(e.get_property("attn-impl", "") or "").strip().lower() != "pallas":
                continue
            h, kv, d = _lm_heads(FilterProps(custom=str(e.get_property("custom") or ""))
                                 .custom_dict())
            probs = _attn_hazards(dict(h=h, kv=kv, d=d, dtype="float32"))
            if probs:
                report.add(
                    "NNS-W129", e.name,
                    f"attn-impl=pallas requested but the decode-attention kernel (K3/K4) "
                    f"refuses this model: {probs[0]}; the kernel raises on the card",
                    "pick heads the kernel takes (D % 4 == 0 up to 256, H / KV <= 32) or "
                    "drop attn-impl=pallas")
        elif factory == "tensor_filter":
            opts = FilterProps(custom=str(e.get_property("custom") or "")).custom_dict()
            if str(e.get_property("model") or "") != "zoo:transformer_lm" or \
                    opts.get("attn") != "flash":
                continue
            _, _, d = _lm_heads(opts)
            if not kernel_takes_head_dim(d):
                report.add(
                    "NNS-W129", e.name,
                    f"attn:flash requested with head dim {d}: the flash kernel (K5) takes "
                    "D % 8 == 0 up to 256 and raises on the card before a launch",
                    "pick d_model / n_heads to give such a head dim, or attn:dense")
