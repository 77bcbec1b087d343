"""LLM pumps through a shared plane (nnstreamer_tpu_torch/serving_plane/llm.py
and the ``plane=`` branch of tensor_llm_serversink) against the JAX
package on the CPU, on the same exported weights (1 layer, vocab 127,
d_model 16):

- two serversink/serversrc pairs on one plane: greedy generations equal
  to the reference plane's (the same two-pair pipelines through the JAX
  package) and to the port's private paged batcher; each serversrc emits
  only its own stream's requests; the per-stream counters; the
  block-native decode path with ``kv_gather_dispatches`` 0;
- the refusals of tests/test_plane_async.py (slot layout, speculate,
  stream) in both packages, and ``refuse_migration`` on
  ``drain(migrate_to=)``, the migration probe/adopt and a checkpoint prop;
- the registry: a sharer with other batcher knobs is refused, the last
  release drops the plane.
"""

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.elements import llm_serve as jllm
from nnstreamer_tpu.elements.base import ElementError as JElementError
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu.serving_plane import llm as jllm_plane
from nnstreamer_tpu_torch.elements import llm_serve as tllm
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.serving_plane import llm as llm_plane
from nnstreamer_tpu_torch.serving_plane.llm import LlmPlaneError

VOCAB, D_MODEL, N_HEADS, N_LAYERS = 127, 16, 2, 1
OPTS = f"vocab:{VOCAB},d_model:{D_MODEL},n_heads:{N_HEADS},n_layers:{N_LAYERS}"
SINK = {"model": "zoo:transformer_lm", "n-slots": 2, "max-len": 16, "prompt-len": 8,
        "max-new-tokens": 4, "pump": 2, "block-size": 8, "kv-blocks": 8, "kv-layout": "paged"}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lm_npz(tmp_path_factory):
    jp = jtfm.init_params(jax.random.PRNGKey(9), VOCAB, D_MODEL, N_HEADS, N_LAYERS)
    path = tmp_path_factory.mktemp("lmplane") / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree_util.tree_leaves(jp))})
    return str(path)


def _prompts():
    rng = np.random.default_rng(11)
    return {f"s{k}r{i}": rng.integers(1, VOCAB, (6,)).astype(np.int32)
            for k in range(2) for i in range(2)}


def _serve_pairs(pkg, plane, path, prompts):
    """Two serversink/serversrc pairs (ids <plane>0, <plane>1) on one
    plane, each fed its own two prompts → ({req: tokens}, {k: stats},
    {k: the reqs its serversrc emitted})."""
    if pkg == "port":
        from nnstreamer_tpu_torch.elements.sink import AppSink
        from nnstreamer_tpu_torch.elements.sources import AppSrc
        from nnstreamer_tpu_torch.pipeline.graph import Pipeline
        from nnstreamer_tpu_torch.tensors.frame import Frame
        from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec
        mod, kw = tllm, {"device": "cpu"}
    else:
        from nnstreamer_tpu.elements.sink import AppSink
        from nnstreamer_tpu.elements.sources import AppSrc
        from nnstreamer_tpu.pipeline.graph import Pipeline
        from nnstreamer_tpu.tensors.frame import Frame
        from nnstreamer_tpu.tensors.spec import TensorFormat, TensorsSpec
        mod, kw = jllm, {}
    pipes, ends = [], {}
    for k in range(2):
        src = AppSrc(spec=TensorsSpec(format=TensorFormat.FLEXIBLE))
        sink = mod.LlmServerSink(**{"id": f"{plane}{k}", "custom": f"{OPTS},params:{path}",
                                    "plane": plane, **SINK})
        osrc = mod.LlmServerSrc(**{"id": f"{plane}{k}"})
        osink = AppSink()
        p = Pipeline(**kw).chain(src, sink)
        p.chain(osrc, osink)
        p.start()
        pipes.append(p)
        ends[k] = (src, osink, osrc)
    results, stats, emitted = {}, {}, {}
    try:
        for k, (src, _, _) in ends.items():
            for name, pr in prompts.items():
                if name.startswith(f"s{k}"):
                    src.push(Frame((pr,), meta={"req": name}))
            src.end_of_stream()
        for k, (_, osink, osrc) in ends.items():
            emitted[k] = []
            for _ in range(2):
                f = osink.pop(timeout=120)
                assert f is not None, "llm plane drained early"
                results[f.meta["req"]] = [int(t) for t in np.asarray(f.tensors[0])[0]]
                emitted[k].append(f.meta["req"])
            stats[k] = osrc.serving_stats()
    finally:
        for p in pipes:
            p.stop()
    return results, stats, emitted


def test_two_serversinks_on_one_plane_match_reference_and_private(lm_npz):
    prompts = _prompts()
    got, stats, emitted = _serve_pairs("port", "tlp", lm_npz, prompts)
    want, _, _ = _serve_pairs("jax", "jlp", lm_npz, prompts)
    assert got == want
    # the port's private paged batcher, built after the plane is released
    assert llm_plane.get("tlp") is None and jllm_plane.get("jlp") is None
    cb = tllm._build_batcher("zoo:transformer_lm", dict(
        p.split(":", 1) for p in f"{OPTS},params:{lm_npz}".split(",")), 2, 16, 8, "auto",
        "xla", CPU, dict(kv_layout="paged", block_size=8, kv_blocks=8))
    rids = {name: cb.submit(pr, 4) for name, pr in prompts.items() if name.endswith("r0")}
    while any(cb.result(r) is None for r in rids.values()):
        cb.step_pump(2)
    rids.update({name: cb.submit(pr, 4) for name, pr in prompts.items() if name.endswith("r1")})
    while any(cb.result(r) is None for r in rids.values()):
        cb.step_pump(2)
    assert {name: [int(t) for t in cb.result(r)] for name, r in rids.items()} == got
    for k in range(2):
        assert sorted(emitted[k]) == [f"s{k}r0", f"s{k}r1"]  # only its own requests
        st = stats[k]
        assert st["plane"] == "tlp" and st["kv_attn"] == "block"
        assert st.get("kv_gather_dispatches", 0) == 0
        assert st["stream_submitted"] == 2 and st["stream_served"] == 2
        assert st["stream_errors"] == 0 and st["stream_active"] == 0


def _server_kw(**extra):
    return dict(model="zoo:transformer_lm",
                options={"vocab": "127", "d_model": "16", "n_heads": "2", "n_layers": "1"},
                n_slots=2, max_len=32, prompt_len=16, default_new=4, **extra)


@pytest.mark.parametrize("case,match", [
    ("slot", "kv-layout=paged"), ("speculate", "speculate"), ("stream", "stream"),
])
def test_plane_refuses_incompatible_modes_like_the_reference(case, match):
    port_kw = {"slot": dict(kv_kw=None), "speculate": dict(speculate=4),
               "stream": dict(stream=True)}[case]
    ref_kw = {"slot": dict(kv_layout="slot"), "speculate": dict(kv_layout="paged", speculate=4),
              "stream": dict(kv_layout="paged", stream=True)}[case]
    if case != "slot":
        port_kw["kv_kw"] = dict(kv_layout="paged", block_size=16)
    with pytest.raises(ElementError, match=match):
        tllm._LlmServer(**_server_kw(device=CPU, plane=f"bad-{case}", **port_kw))
    with pytest.raises(JElementError, match=match):
        jllm._LlmServer(**_server_kw(plane=f"jbad-{case}", **ref_kw))
    assert llm_plane.get(f"bad-{case}") is None


@pytest.mark.parametrize("prop", ["checkpoint-every-tokens", "checkpoint-dir"])
def test_checkpoints_on_a_plane_raise_before_any_model_load(prop, monkeypatch, tmp_path):
    built = []
    monkeypatch.setattr(tllm, "_build_batcher", lambda *a, **k: built.append(a))
    value = 4 if prop == "checkpoint-every-tokens" else str(tmp_path)
    sink = tllm.LlmServerSink(**{"id": "ck0", "custom": OPTS, "plane": "ckp",
                                 "kv-layout": "paged", prop: value})
    with pytest.raises(LlmPlaneError, match="checkpoint"):
        tllm._get_server("ck0", dict(sink._create_kw, device=CPU))
    assert built == [] and llm_plane.get("ckp") is None


def test_plane_shared_batcher_refuses_migration(lm_npz):
    srv = tllm._LlmServer(**_server_kw(
        device=CPU, plane="mig", kv_kw=dict(kv_layout="paged", block_size=16)))
    try:
        for call in (lambda: srv.drain(migrate_to="127.0.0.1:1"), lambda: srv.drain(),
                     lambda: srv.migration_probe([1, 2, 3]), lambda: srv.migration_adopt(b"")):
            with pytest.raises(LlmPlaneError, match="refused"):
                call()
        assert not srv.draining
    finally:
        srv.release_plane()
        srv.release_plane()  # idempotent
    assert llm_plane.get("mig") is None


def test_registry_refuses_a_sharer_with_other_knobs():
    kv = dict(kv_layout="paged", block_size=16)
    a = tllm._LlmServer(**_server_kw(device=CPU, plane="reg", kv_kw=kv))
    try:
        with pytest.raises(LlmPlaneError, match="already bound"):
            tllm._LlmServer(**dict(_server_kw(device=CPU, plane="reg", kv_kw=kv), n_slots=4))
        b = tllm._LlmServer(**_server_kw(device=CPU, plane="reg", kv_kw=kv, srv_id="0"))
        assert b.cb is a.cb and len(llm_plane.get("reg")._sched) == 2
        b.release_plane()
        assert llm_plane.get("reg") is not None
    finally:
        a.release_plane()
    assert llm_plane.get("reg") is None


def test_zoo_d_ff_sets_the_ffn_width():
    """``d_ff`` (the port's zoo option a serving pipeline needs for a
    published config's FFN width) shapes every layer's SwiGLU; without
    it the width stays 4 x d_model, the reference's."""
    from nnstreamer_tpu_torch.models import zoo

    kw = dict(device="cpu", vocab="16", d_model="16", n_heads="2", n_layers="2")
    lm = zoo.get("transformer_lm", d_ff="24", **kw).params
    assert lm.blocks[1].w_gate.weight.shape == (24, 16)
    assert zoo.get("transformer_lm", **kw).params.blocks[0].w_down.weight.shape == (16, 64)
