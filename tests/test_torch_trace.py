"""The port's tracer (nnstreamer_tpu_torch/trace.py) against the JAX
package's (nnstreamer_tpu/trace.py), on the CPU: the event kinds and their
Chrome trace form, labelled lanes, the bounded buffer, the atomic save and
merge, one span a frame a node through the executor (batch spans on a
batched node, fault and stall events), off by default, and
``device_profile`` writing a torch.profiler Chrome trace."""

import json
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu import trace as jtrace
from nnstreamer_tpu_torch import trace
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _off():
    trace.disable()
    yield
    trace.disable()


def _strip(evs):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")} for e in evs]


def test_event_kinds_equal_the_reference():
    def record(mod):
        t = mod.Tracer(process="p")
        with t.span("work", "element", frame=1):
            pass
        t.instant("mark")
        t.counter("queue_depth", q0=3)
        t.batch("node", time.perf_counter(), 0.001, batch=4, bucket=4, wait_s=0.0, frame=4)
        t.fault("node", "drop", ValueError("x"), attempts=1)
        t.san("node", "NNS-S001", message="m")
        return t.events()

    got, want = record(trace), record(jtrace)
    assert [e["ph"] for e in got] == ["X", "i", "C", "X", "i", "i"]
    assert _strip(got) == _strip(want)


def test_lanes_are_labelled_and_stable():
    t = trace.Tracer(process="proc")
    barrier = threading.Barrier(3)

    def work(name):
        barrier.wait()  # alive together: three distinct threads, three lanes
        t.instant(name)
        barrier.wait()

    threads = [threading.Thread(target=work, args=(f"e{i}",), name=f"lane-{i}")
               for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    doc = t.to_chrome_trace()
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert {"lane-0", "lane-1", "lane-2"} <= names
    tids = [e["tid"] for e in doc["traceEvents"] if e.get("ph") == "i"]
    assert len(set(tids)) == 3 and max(tids) <= 3


def test_bounded_buffer_drops_oldest():
    t = trace.Tracer(max_events=5)
    for i in range(8):
        t.instant(f"e{i}")
    assert [e["name"] for e in t.events()] == ["e3", "e4", "e5", "e6", "e7"]
    assert t.dropped_events == 3


def test_save_is_atomic_and_merge_aligns(tmp_path):
    a, b = trace.Tracer(process="client"), trace.Tracer(process="server")
    a.instant("sent")
    b.instant("got")
    path = tmp_path / "t.json"
    a.save(str(path))
    assert list(tmp_path.iterdir()) == [path]
    merged = trace.merge([a.to_chrome_trace(), b.to_chrome_trace()])
    jmerged = jtrace.merge([a.to_chrome_trace(), b.to_chrome_trace()])
    assert merged == jmerged
    names = {e["name"] for e in merged["traceEvents"] if e.get("ph") == "i"}
    assert names == {"sent", "got"}


def test_pipeline_records_one_span_a_frame_a_node(tmp_path):
    tracer = trace.enable()
    tracer.clear()
    p = parse_pipeline("videotestsrc name=src num-frames=5 width=8 height=8 ! "
                       "tensor_converter name=conv ! tensor_sink name=out", device="cpu")
    ex = p.run(timeout=TIMEOUT)
    spans = [e for e in tracer.events() if e["ph"] == "X"]
    for n in ex.nodes:
        assert sum(e["name"] == n.name for e in spans) == 5, n.name
    out = tmp_path / "trace.json"
    tracer.save(str(out))
    doc = json.loads(out.read_text())
    assert doc["traceEvents"] and all("ts" in e for e in doc["traceEvents"])


def test_batched_node_records_batch_spans():
    tracer = trace.enable()
    tracer.clear()
    p = parse_pipeline("tensorsrc dimensions=4 num-frames=16 pattern=counter ! "
                       "tensor_filter name=f framework=scaler batching=true max-batch=4 ! "
                       "tensor_sink name=out", device="cpu")
    p.run(timeout=TIMEOUT)
    batches = [e for e in tracer.events() if e["name"] == "f"]
    assert batches and all(e["cat"] == "batch" for e in batches)
    assert sum(e["args"]["batch"] for e in batches) == 16


def test_fault_events_are_traced():
    tracer = trace.enable()
    tracer.clear()
    p = parse_pipeline("tensorsrc dimensions=4 num-frames=10 pattern=counter ! "
                       "tensor_filter name=f framework=faulty custom=fail_every_n:5 "
                       "on-error=drop ! tensor_sink name=out", device="cpu")
    ex = p.run(timeout=TIMEOUT)
    drops = [e for e in tracer.events() if e.get("cat") == "fault" and e["name"] == "f"]
    assert len(drops) == ex.stats()["f"]["error_dropped"] >= 1
    assert all(e["args"]["action"] == "drop" for e in drops)


def test_disabled_by_default():
    assert trace.get() is None
    p = parse_pipeline("videotestsrc num-frames=1 width=8 height=8 ! tensor_converter ! "
                       "tensor_sink name=out", device="cpu")
    p.run(timeout=TIMEOUT)
    assert trace.get() is None


def test_device_profile_writes_a_chrome_trace(tmp_path):
    import torch

    with trace.device_profile(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    doc = json.loads((tmp_path / "prof" / "device_profile.json").read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert np.isfinite(len(doc["traceEvents"]))
