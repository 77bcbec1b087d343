"""The port's launch analyzer for K1-K5 (analysis/kernels.py, nns-kscope)
on the CPU. The reference's test_kernel_analysis.py is Pallas-specific
(index maps, VMEM, lane tiles), so this file holds the Hopper analyzer to
its own contract:

- hand-computed launch plans at the main path's shapes, from the .cu
  sources' formulas (``chunk_smem_bytes`` + the block table for K3/K4,
  ``smem32_bytes`` / ``smem16_bytes`` for K5, static shared memory only
  for K1 and K2), and the wrappers' geometry (``split_plan``,
  ``nms_plan``);
- NNS-W127 when a launch exceeds the card (dynamic shared memory,
  registers x threads, threads, gridDim.y/z, no resident block) and only
  then; NNS-W128 on a plan hazard (alignment, a refused head dim, too many
  candidates, a plan that differs from the host code's launch) and only
  then; the card's readings faked here, read on the card by chip_smoke.py;
- the roofline bounds of PERF.md §6: K3 at B 8, H 32, KV 8, D 128, pos
  600, float32 (0.01184 ms) and K5 float32 causal at T 4096, H 32, D 128
  (0.833 ms), within 0.5 %;
- NNS-W129 through the port's lint: a kernel request the card cannot
  honour;
- nns-kscope-torch's CLI.
"""

import json

import pytest

from nnstreamer_tpu_torch.analysis import kernels as K
from nnstreamer_tpu_torch.analysis import lint as _lint


def lint(desc):
    return _lint(desc, device="cpu")


def _case(tk, name):
    spec = K.find(tk)
    return spec, next(c for c in spec.cases if c.name == name)


def _report(tk, name, **override):
    spec, case = _case(tk, name)
    return K.analyze_case(spec, K.Case(case.name, {**case.params, **override}))


# ----------------------------------------------------------- hand plans
def test_k1_plan():
    r = _report("K1", "resize-u8-720p-224")
    # one thread an output pixel, 256 a block: ceil(224 * 224 / 256)
    assert [ln.key() for ln in r.launches] == [((196, 1, 1), (256, 1, 1), 0)]


def test_k2_plans_switch_the_mask_block_at_the_wave():
    # n 1917: 30 words, 30 * 31 / 2 = 465 tiles <= 1056 -> four threads a row
    assert [ln.key() for ln in _report("K2", "nms-ssd-1917").launches] == [
        ((465, 1, 1), (256, 1, 1), 0), ((1, 1, 1), (512, 1, 1), 0)]
    # n 6300: 99 words, 4950 tiles -> one thread a row
    assert [ln.key() for ln in _report("K2", "nms-yolo-6300").launches] == [
        ((4950, 1, 1), (64, 1, 1), 0), ((1, 1, 1), (512, 1, 1), 0)]


def test_k3_and_k4_plans():
    # g = 4 query heads a kv head -> 4 a block; DP 128: 8 lane groups, 16-row
    # tiles; ring 4 x 2 x 16 x 128 x 4 B = 65536 > merge 4 x 8 x 4 x 131
    # S 4096 in 128-row chunks: 32 splits
    r = _report("K3", "serve-f32-pos600")
    assert [ln.key() for ln in r.launches] == [
        ((8, 8, 32), (128, 1, 1), 65536), ((32, 8, 1), (128, 1, 1), 0)]
    # bfloat16 halves the ring; int8 a quarter of it plus 4 B of scales a row
    assert _report("K3", "serve-bf16-pos600").launches[0].dyn_smem == 32768
    assert _report("K3", "serve-int8-pos600").launches[0].dyn_smem == 4 * 2 * 16 * (128 + 4)
    # K4 adds the chunk's table entries: 4 x (128 + 4) B
    r = _report("K4", "serve-f32-pos600")
    assert [ln.key() for ln in r.launches] == [
        ((8, 8, 32), (128, 1, 1), 65536 + 528), ((32, 8, 1), (128, 1, 1), 0)]


def test_k5_plans():
    # 64 query rows a block, a warpgroup; float32: (D + 4) x (64 + 4 x 32) floats
    r = _report("K5", "b1-t4096-h32-d128-causal-f32")
    assert [ln.key() for ln in r.launches] == [((64, 32, 1), (128, 1, 1), 4 * 132 * 192)]
    # 16-bit: 1 KiB of alignment and five 64 x 128 tiles of 2 B
    r = _report("K5", "b1-t4096-h32-d128-causal-bf16")
    assert r.launches[0].dyn_smem == 1024 + 5 * 64 * 128 * 2


def test_plans_follow_the_wrappers_geometry():
    from nnstreamer_tpu_torch.ops.kernels.decode_attention import split_plan
    from nnstreamer_tpu_torch.ops.kernels.nms import nms_plan

    for s in (1, 127, 128, 600, 4096):
        r = _report("K3", "serve-f32-pos600", s=s, pos=[min(600, s - 1)] * 8)
        assert r.launches[0].grid[2] == split_plan(s).splits
    for n in (1, 64, 65, 1917, 6300, 32768):
        r = _report("K2", "nms-ssd-1917", n=n)
        assert r.launches[0].grid[0] == nms_plan(n).tiles


# ------------------------------------------------------------------ bounds
def test_bounds_reproduce_perf_md():
    k3 = _report("K3", "serve-f32-pos600").cost
    # 8 slots x 601 rows x 8 kv heads x 128 x 4 B x (K, V) + q and out
    assert k3.hbm_bytes == 8 * 8 * 601 * 128 * 4 * 2 + 2 * 8 * 32 * 128 * 4 + 8 * 4
    assert k3.bound_ms() == pytest.approx(0.01184, rel=5e-3) and k3.bound_by() == "bytes"
    k5 = _report("K5", "b1-t4096-h32-d128-causal-f32").cost
    # 3 TF32 products x 4 B H D (T (T + 1) / 2) at 495 TFLOP/s
    assert k5.flops == 3 * 4 * 32 * 128 * (4096 * 4097 // 2)
    assert k5.bound_ms() == pytest.approx(0.833, rel=5e-3) and k5.bound_by() == "operations"
    assert _report("K5", "b1-t4096-h32-d128-causal-bf16").cost.bound_ms() == pytest.approx(
        0.139, rel=5e-3)
    assert _report("K4", "serve-f32-pos600").cost.bound_ms() == pytest.approx(0.01184, rel=5e-3)
    assert _report("K1", "resize-u8-720p-224").cost.bound_ms() == pytest.approx(
        0.000558, rel=5e-3)


def test_k2_bound_counts_the_data_it_is_given():
    worst = _report("K2", "nms-ssd-1917").cost
    assert worst.flops == 12 * 1917 * 1916 // 2
    kept = _report("K2", "nms-ssd-1917", kept=[0, 5, 9]).cost
    assert kept.flops == 12 * ((1916) + (1911) + (1907))


# ------------------------------------------------------------- W127 / W128
def test_clean_main_shapes():
    reports, report = K.analyze()
    assert report.diagnostics == [] and len(reports) == sum(len(s.cases) for s in K.SPECS)
    assert {r.tpu_kernel for r in reports} == {"K1", "K2", "K3", "K4", "K5"}


def _card(r, **over):
    return [dict({"grid_x": ln.grid[0], "grid_y": ln.grid[1], "grid_z": ln.grid[2],
                  "block_x": ln.block[0], "block_y": ln.block[1], "block_z": ln.block[2],
                  "dyn_smem": ln.dyn_smem, "regs": 64, "static_smem": 0, "local_bytes": 0,
                  "max_threads": 1024, "blocks_per_sm": 2}, **over) for ln in r.launches]


@pytest.mark.parametrize("over,fires", [
    ({}, False),
    ({"regs": 513}, True),            # 513 x 128 threads > 65536
    ({"regs": 512}, False),           # exactly the SM's 65536
    ({"blocks_per_sm": 0}, True),
    ({"max_threads": 64}, True),
], ids=["clean", "regs", "regs-fit", "no-resident-block", "kernel-thread-limit"])
def test_w127_from_the_cards_readings(monkeypatch, over, fires):
    spec, _ = _case("K3", "serve-f32-pos600")
    monkeypatch.setattr(spec, "query", lambda p: _card(K.CaseReport(
        "", "", "", spec.plan(p), None), **over))
    reports, report = K.analyze([spec], card=True)
    codes = [d.code for d in report.diagnostics]
    assert ("NNS-W127" in codes) == fires and "NNS-W128" not in codes
    assert reports[0].plan_matches


def test_w127_from_the_plan(monkeypatch):
    spec, _ = _case("K5", "b1-t4096-h32-d128-causal-f32")
    for over, fires in (({"t": 64 * 65535}, False), ({"h": 65536}, True), ({"b": 65536}, True)):
        case = K.Case("x", {**spec.cases[0].params, **over})
        r = K.analyze_case(spec, case)
        assert bool(r.limits()) == fires, (over, r.limits())
    big = K.Launch("k", (1, 1, 1), (1024, 1, 1), K.MAX_DYN_SMEM)
    assert K.CaseReport("k", "K0", "c", [big], None).limits() == []
    for ln in (K.Launch("k", (1, 1, 1), (1025, 1, 1), 0),
               K.Launch("k", (1, 1, 1), (128, 1, 1), K.MAX_DYN_SMEM + 1)):
        assert K.CaseReport("k", "K0", "c", [ln], None).limits()


def test_w128_plan_mismatch_against_the_host_code(monkeypatch):
    spec, case = _case("K1", "resize-u8-720p-224")
    r = K.analyze_case(spec, case)
    monkeypatch.setattr(spec, "query", lambda p: _card(r, grid_x=197))
    reports, report = K.analyze([spec], card=True)
    assert reports[0].plan_matches is False
    assert "NNS-W128" in report.codes


@pytest.mark.parametrize("tk,case,over,fires", [
    ("K5", "b1-t4096-h32-d128-causal-f32", {"d": 12}, True),
    ("K5", "b1-t4096-h32-d128-causal-f32", {"d": 256}, False),
    ("K5", "b1-t4096-h32-d128-causal-f32", {"d": 264}, True),
    ("K5", "b1-t4096-h32-d128-causal-bf16", {"strides": [4096 * 128, 128, 4]}, True),
    ("K5", "b1-t4096-h32-d128-causal-bf16", {"strides": [4096 * 128, 128, 8]}, False),
    ("K3", "serve-f32-pos600", {"d": 6}, True),
    ("K3", "serve-f32-pos600", {"d": 20}, False),
    ("K3", "serve-f32-pos600", {"h": 30}, True),
    ("K3", "serve-f32-pos600", {"h": 64, "kv": 1}, True),
    ("K3", "serve-f32-pos600", {"cache_offset": 8}, True),
    ("K4", "serve-f32-pos600", {"d": 260}, True),
    ("K2", "nms-ssd-1917", {"n": 32769}, True),
    ("K2", "nms-ssd-1917", {"n": 32768}, False),
    ("K2", "nms-ssd-1917", {"boxes_offset": 8}, True),
    ("K1", "resize-u8-720p-224", {"dtype": "float16"}, True),
])
def test_w128_fires_exactly_on_plan_hazards(tk, case, over, fires):
    r = _report(tk, case, **over)
    assert bool(r.hazards) == fires, r.hazards
    spec, c = _case(tk, case)
    _, report = K.analyze([K.KernelSpec(spec.name, spec.tpu_kernel, spec.replaces, spec.source,
                                        [K.Case(c.name, {**c.params, **over})], spec.plan,
                                        spec.cost, spec.hazards, spec.query)])
    assert ("NNS-W128" in report.codes) == fires


# ------------------------------------------------------------------ W129
@pytest.mark.parametrize("desc,fires", [
    ("tensorsrc dimensions=4 ! tensor_transform mode=typecast option=float32 impl=pallas ! "
     "tensor_sink", True),
    ("videotestsrc num-frames=1 ! tensor_converter ! tensor_transform mode=resize "
     "option=32:32 impl=pallas ! tensor_sink", False),
    ("tensorsrc dimensions=3:16:16 types=int16 ! tensor_transform mode=resize option=8:8 "
     "impl=pallas ! tensor_sink", True),
    ("tensorsrc dimensions=16 types=int32 ! tensor_llm_serversink id=k1 attn-impl=pallas "
     'custom="vocab:64,d_model:24,n_heads:4,n_layers:1"', True),
    ("tensorsrc dimensions=16 types=int32 ! tensor_llm_serversink id=k2 attn-impl=pallas "
     'custom="vocab:64,d_model:32,n_heads:4,n_layers:1"', False),
    ("tensorsrc dimensions=16 types=int32 ! tensor_llm_serversink id=k3 "
     'custom="vocab:64,d_model:24,n_heads:4,n_layers:1"', False),
    ("tensorsrc dimensions=16:1 types=int32 ! tensor_filter framework=torch "
     'model=zoo:transformer_lm custom="vocab:64,d_model:48,n_heads:4,n_layers:1,seqlen:16,'
     'attn:flash" ! tensor_sink', True),
    ("tensorsrc dimensions=16:1 types=int32 ! tensor_filter framework=torch "
     'model=zoo:transformer_lm custom="vocab:64,d_model:64,n_heads:4,n_layers:1,seqlen:16,'
     'attn:flash" ! tensor_sink', False),
], ids=["no-kernel-mode", "resize-u8", "resize-int16", "lm-d6", "lm-d8", "lm-no-request",
        "flash-d12", "flash-d16"])
def test_w129_kernel_requests(desc, fires):
    r = lint(desc)
    assert ("NNS-W129" in r.codes) == fires, r.render()


# ------------------------------------------------------------------- CLI
def test_cli(capsys, monkeypatch):
    import torch

    from nnstreamer_tpu_torch.analysis.kscope_cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([]) == 2 and main(["--engage"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "K5:b1-t4096-h32-d128-causal-f32" in out and "case(s) clean" in out
    assert main(["--json", "--kernel", "K3", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert {c["tpu_kernel"] for c in doc["cases"]} == {"K3"}
    assert doc["cases"][0]["bound_by"] == "bytes"
    assert main(["--kernel", "nope"]) == 2
    assert main(["--self-check"]) == 0
    capsys.readouterr()
    assert main(["--engage", "--device", "cpu"]) == 0
    assert "flash_attention (K5) on cpu: engaged=plain" in capsys.readouterr().out
