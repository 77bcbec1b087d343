"""The port's observability (nnstreamer_tpu_torch/obs/, the executor's
wiring, cli.py's --stats / --metrics / --trace / --profile) against the
JAX package's (nnstreamer_tpu/obs/, nnstreamer_tpu/cli.py), on the CPU:

- the same observations give the same Prometheus text and the same JSON
  snapshot through both registries; the metric catalog is the same;
- ``--stats`` through both CLIs: the same node rows with the reference's
  keys (the percentile columns among them) and the same frame accounting;
- the executor records every node's latency histogram, frames and queue
  waits; faults, sheds, the degraded gauge and the plane's metrics;
- the metrics endpoint serves /metrics and /metrics.json on localhost
  while a pipeline runs and closes with it;
- nns-top renders the same tables from the same snapshot in both
  packages, including the models and requests views, and from a live
  port executor.
"""

import io
import json
import socket
import threading
import time
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

from nnstreamer_tpu import cli as jcli
from nnstreamer_tpu.obs import expo as jexpo
from nnstreamer_tpu.obs import metrics as jmetrics
from nnstreamer_tpu.obs import nns_top as jtop
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.obs import expo, nns_top
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

TIMEOUT = 60
SIMPLE = ("videotestsrc name=src num-frames={n} width=8 height=8 ! tensor_converter name=conv ! "
          "tensor_sink name=out")


@pytest.fixture(autouse=True)
def _registries():
    obs_metrics.disable()
    jmetrics.disable()
    yield
    obs_metrics.disable()
    jmetrics.disable()


def _observe(mod):
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(3)
    h = reg.histogram("nns_element_latency_us", element="f")
    for v in rng.lognormal(5.0, 1.2, 500):
        h.observe(float(v))
    reg.counter("nns_element_frames_total", element="f").inc(500)
    reg.counter("nns_fault_events_total", element="f", action="drop").inc(3)
    reg.gauge("nns_degraded_segments", element="f").set(1)
    reg.histogram("nns_batch_size", lo=1.0, growth=2.0 ** 0.5, nbuckets=16,
                  element="f").observe(6)
    return reg


def test_same_observations_give_the_same_prometheus_text():
    reg, jreg = _observe(obs_metrics), _observe(jmetrics)
    assert expo.to_prometheus(reg) == jexpo.to_prometheus(jreg)
    assert reg.to_dict() == jreg.to_dict()
    h, jh = (r.find("nns_element_latency_us", element="f") for r in (reg, jreg))
    assert h.percentiles() == jh.percentiles()


def test_metric_catalog_is_the_reference_catalog():
    assert obs_metrics.METRIC_CATALOG == jmetrics.METRIC_CATALOG
    with pytest.raises(KeyError, match="METRIC_CATALOG"):
        obs_metrics.MetricsRegistry().counter("nns_not_a_metric")


def test_snapshot_document_and_atomic_dump(tmp_path):
    reg = _observe(obs_metrics)
    doc = expo.snapshot(reg, {"f": {"frames": 1}}, {"balance": 0}, process="p")
    jdoc = jexpo.snapshot(_observe(jmetrics), {"f": {"frames": 1}}, {"balance": 0}, process="p")
    for d in (doc, jdoc):
        d.pop("time_unix_s")
    assert doc == jdoc
    path = tmp_path / "m.json"
    expo.dump_json(str(path), doc)
    assert json.loads(path.read_text())["schema"] == "nns-obs/1"
    assert list(tmp_path.iterdir()) == [path]


def _cli_stats(main, desc, extra=()):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main([desc, "--stats", "-q", *extra])
    assert rc == 0
    return json.loads(buf.getvalue())


def test_stats_rows_through_both_clis():
    desc = SIMPLE.format(n=20)
    got = _cli_stats(cli.main, desc, ("--device", "cpu"))
    obs_metrics.disable()
    want = _cli_stats(jcli.main, desc)
    assert set(got) == set(want)
    for name, row in want.items():
        if name == "__pipeline__":
            for k in ("produced", "rendered", "dropped", "balance", "transfer"):
                assert got[name][k] == row[k], k
            continue
        assert set(row) - {"invoke_count", "invoke_latency_us", "invoke_throughput_fps"} \
            <= set(got[name]), name
        assert got[name]["frames"] == row["frames"] == 20
        assert got[name]["latency_p50_ms"] <= got[name]["latency_p95_ms"] \
            <= got[name]["latency_p99_ms"]
    assert "queue_wait_p50_ms" in got["out"]


def test_stats_without_metrics_records_nothing():
    p = parse_pipeline(SIMPLE.format(n=4), device="cpu")
    ex = p.run(timeout=TIMEOUT)
    assert obs_metrics._registry is None and ex.metrics is None
    row = ex.stats()["out"]
    assert "latency_p50_ms" not in row and row["frames"] == 4
    assert all(n._lat_hist is None for n in ex.nodes)


def test_executor_metrics_for_every_node():
    reg = obs_metrics.enable()
    p = parse_pipeline(
        "tensorsrc name=src dimensions=4 num-frames=40 pattern=counter ! "
        "tensor_filter name=f framework=scaler batching=true max-batch=4 ! "
        "queue name=q ! tensor_filter name=g framework=scaler ! tensor_sink name=out",
        device="cpu")
    ex = p.run(timeout=TIMEOUT)
    for n in ex.nodes:
        h = reg.find("nns_element_latency_us", element=n.name)
        assert h is not None and h.count > 0, n.name
        assert reg.find("nns_element_frames_total", element=n.name).value == 40, n.name
    assert reg.find("nns_batch_size", element="f").count >= 1
    # every frame's wait (and the EOS marker's) is one observation
    assert reg.find("nns_queue_wait_us", element="out", pad="0").count == 41
    assert reg.find("nns_transfer_bytes_total", direction="d2h").value >= 40 * 16


def test_fault_layer_metrics():
    reg = obs_metrics.enable()
    p = parse_pipeline(
        "tensorsrc dimensions=4 num-frames=20 pattern=counter ! "
        "tensor_filter name=f framework=faulty custom=fail_every_n:5 on-error=drop ! "
        "tensor_sink name=out", device="cpu")
    ex = p.run(timeout=TIMEOUT)
    dropped = ex.stats()["f"]["error_dropped"]
    assert dropped >= 1
    assert reg.find("nns_fault_events_total", element="f", action="drop").value == dropped


def test_device_fault_and_degraded_gauge():
    reg = obs_metrics.enable()
    p = parse_pipeline(
        "tensorsrc dimensions=4 num-frames=30 pattern=counter ! "
        "tensor_filter name=f framework=faulty "
        "custom=traceable:true,compile_fail:true,compile_fail_first_n:1 "
        "device-fallback=true ! tensor_sink name=out", device="cpu")
    ex = p.run(timeout=TIMEOUT)
    s = ex.stats()["f"]
    if not s.get("device_faults"):
        pytest.fail(f"no device fault recorded: {s}")
    total = sum(m.value for m in reg.metrics()
                if m.name == "nns_device_faults_total" and m.labels.get("element") == "f")
    assert total == s["device_faults"]
    assert reg.find("nns_degraded_segments", element="f").value == s["device_degraded"]


def test_deadline_shed_counter():
    from nnstreamer_tpu_torch.elements.sources import AppSrc
    from nnstreamer_tpu_torch.tensors.frame import Frame

    reg = obs_metrics.enable()
    p = parse_pipeline("appsrc name=src dimensions=4 types=float32 ! "
                       "tensor_filter name=f framework=scaler ! tensor_sink name=out",
                       device="cpu")
    src = p["src"]
    assert isinstance(src, AppSrc)
    old = time.monotonic() - 10.0
    for i in range(3):
        src.push(Frame((np.full(4, float(i), np.float32),),
                       meta={"deadline_ms": 1.0, "admit_t": old}))
    src.end_of_stream()
    ex = p.run(timeout=TIMEOUT)
    shed = sum(r.get("deadline_shed", 0) for r in ex.stats().values())
    assert shed == 3
    total = sum(m.value for m in reg.metrics() if m.name == "nns_deadline_shed_total")
    assert total == 3


def test_plane_metrics():
    from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

    reg = obs_metrics.enable()
    desc = ("tensorsrc dimensions=4 pattern=counter num-frames=24 ! tensor_filter "
            "framework=scaler plane=obsplane ring-depth=2 ! tensor_sink name=out")
    p = parse_pipeline(desc, device="cpu")
    p.run(timeout=TIMEOUT)
    assert len(p["out"].frames) == 24
    occ = reg.find("nns_plane_batch_occupancy", plane="obsplane")
    assert occ is not None and occ.count >= 1 and occ.sum == 24
    assert reg.find("nns_plane_submit_wait_ms", plane="obsplane").count >= 1
    assert reg.find("nns_plane_inflight_windows", plane="obsplane").value == 0
    assert reg.find("nns_plane_queue_depth", plane="obsplane") is not None
    assert plane_mod.get("obsplane") is None  # released with the pipeline


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_endpoint_serves_during_live_pipeline(monkeypatch):
    port = _free_port()
    monkeypatch.setenv("NNS_TPU_METRICS_PORT", str(port))
    p = parse_pipeline("videotestsrc name=src num-frames=40 is-live=true framerate=40/1 "
                       "width=8 height=8 ! tensor_converter ! tensor_sink name=out", device="cpu")
    ex = p.start()
    try:
        url = f"http://127.0.0.1:{port}"
        for _ in range(50):  # the server binds inside start(); poll it up
            try:
                with urllib.request.urlopen(url + "/metrics", timeout=2) as r:
                    prom = r.read().decode()
                break
            except OSError:
                time.sleep(0.05)
        else:
            pytest.fail("endpoint never came up")
        assert "nns_element_latency_us" in prom
        with urllib.request.urlopen(url + "/metrics.json", timeout=2) as r:
            doc = json.loads(r.read())
        assert "src" in doc["nodes"]
        assert ex.wait(30)
    finally:
        ex.stop()
    assert ex._metrics_server is None
    assert not any(t.name == "nns-obs-http" for t in threading.enumerate())


# -- the CLI's files -----------------------------------------------------------
def test_cli_metrics_trace_and_profile_files(tmp_path):
    m, t, prof = tmp_path / "m.json", tmp_path / "t.json", tmp_path / "prof"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([
            "videotestsrc num-frames=6 width=64 height=48 ! tensor_converter name=conv ! "
            "tensor_transform name=resize mode=resize option=16:16 ! tensor_sink name=out",
            "--device", "cpu", "-q", "--metrics", str(m), "--trace", str(t),
            "--profile", str(prof)])
    assert rc == 0
    doc = json.loads(m.read_text())
    assert doc["schema"] == "nns-obs/1" and doc["nodes"]["out"]["frames"] == 6
    names = {x["labels"].get("element") for x in doc["metrics"]
             if x["name"] == "nns_element_latency_us"}
    assert names == set(doc["nodes"])
    events = json.loads(t.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    for node in doc["nodes"]:
        assert sum(e["name"] == node for e in spans) == 6, node
    trace = json.loads((prof / "device_profile.json").read_text())
    assert trace["traceEvents"], "the profile recorded nothing"
    assert "Trace written" not in buf.getvalue()  # -q keeps the notes off stdout


# -- nns-top ---------------------------------------------------------------
SNAP = {
    "process": "pid1",
    "nodes": {
        "filter0": {
            "frames": 100, "fps": 50.0, "latency_p50_ms": 2.0, "latency_p99_ms": 9.5,
            "queue_wait_p50_ms": 0.4, "queue_depth": [3], "avg_batch_size": 6.2,
            "pad_waste_pct": 9.4, "errors": 2, "error_retries": 5, "cb_opens": 1,
            "cb_open": True, "san_spec_violations": 1, "chain_segments": 2,
            "chain_unroll": 4, "chain_launches": 25,
            "plane_name": "p", "plane_mode": "single", "plane_streams": 2,
            "plane_queue_depth": 1, "plane_dispatches": 10, "plane_occupancy_pct": 80.0,
            "plane_stream_admitted": 40, "plane_stream_served": 40, "plane_inflight": 1,
        },
        "serversrc": {
            "frames": 3,
            "serving_requests": {
                "0": {"state": "decoding", "slot": 0, "tokens": 5, "blocks": 2,
                      "queue_ms": 1.0, "ttft_ms": 3.0, "tpot_ms": None, "preemptions": 0,
                      "deadline_s": 1.5},
                "1": {"state": "done", "tokens": 8, "queue_ms": 2.0, "ttft_ms": 4.0,
                      "tpot_ms": 1.2, "preemptions": 1},
            },
        },
        "_totals_like": {"frames": 1},
    },
    "totals": {"produced": 100, "rendered": 98, "dropped": {"x": 2}, "balance": 0},
}


@pytest.mark.parametrize("view", ["render", "render_models", "render_requests",
                                  "render_clients", "render_fleet"])
def test_nns_top_tables_equal_the_reference(view):
    assert getattr(nns_top, view)(SNAP) == getattr(jtop, view)(SNAP)


def test_nns_top_render_notes_and_fps_diff():
    out = nns_top.render(SNAP)
    assert "filter0" in out and "9.50" in out and "retry=5" in out
    assert "_totals_like" not in out and "produced=100" in out
    prev = {"nodes": {"filter0": {"frames": 50}}}
    assert "25.0" in nns_top.render(SNAP, prev, interval_s=2.0)


def test_nns_top_reads_a_live_port_executor_and_a_snapshot_file(tmp_path, capsys):
    obs_metrics.enable()
    p = parse_pipeline(SIMPLE.format(n=8), device="cpu")
    ex = p.run(timeout=TIMEOUT)
    snap = nns_top.snapshot_executor(ex)
    assert "out" in snap["nodes"] and "P99ms" in nns_top.render(snap)
    path = tmp_path / "snap.json"
    expo.dump_json(str(path), snap)
    assert nns_top.main([str(path), "--once"]) == 0
    assert "out" in capsys.readouterr().out
