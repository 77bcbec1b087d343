"""shared-tensor-filter-key in the port (nnstreamer_tpu_torch/elements/
filter.py): filters with one key share ONE opened backend (one weight copy,
a reload through any sharer swaps it for all), against the JAX package's
table on the CPU. The counterpart of tests/test_shared_filter_key.py."""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.base import NegotiationError as JNegotiationError
from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
from nnstreamer_tpu_torch.elements.base import NegotiationError
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


def _spec():
    return TensorsSpec.from_strings("4", "float32")


def _filter(key, **props):
    f = TensorFilter(**props, **{"shared-tensor-filter-key": key})
    f.device = torch.device("cpu")
    return f


def test_same_key_shares_backend_instance():
    a = _filter("k1", framework="scaler", custom="factor:3")
    b = _filter("k1", framework="scaler", custom="factor:3")
    ja = JFilter(framework="scaler", custom="factor:3", **{"shared-tensor-filter-key": "jk1"})
    jb = JFilter(framework="scaler", custom="factor:3", **{"shared-tensor-filter-key": "jk1"})
    try:
        for f in (a, b):
            f.negotiate([_spec()])
        for f in (ja, jb):
            f.negotiate([JSpec.from_strings("4", "float32")])
        assert a.backend is b.backend and ja.backend is jb.backend
        x = np.arange(4, dtype=np.float32)
        got = b.host_process(Frame((torch.from_numpy(x),))).tensors[0]
        want = jb.host_process(JFrame((x,))).tensors[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    finally:
        for f in (a, b, ja, jb):
            f.stop()


def test_refcounted_close():
    a = _filter("k2", framework="scaler")
    b = _filter("k2", framework="scaler")
    a.negotiate([_spec()])
    b.negotiate([_spec()])
    shared = a.backend
    a.stop()
    # still open for b: a third filter re-acquires the SAME instance
    c = _filter("k2", framework="scaler")
    c.negotiate([_spec()])
    assert c.backend is shared
    b.stop()
    c.stop()
    # every ref dropped: a new filter gets a FRESH instance
    d = _filter("k2", framework="scaler")
    d.negotiate([_spec()])
    assert d.backend is not shared
    d.stop()


def test_key_conflict_rejected():
    a = _filter("k3", framework="scaler")
    a.negotiate([_spec()])
    ja = JFilter(framework="scaler", **{"shared-tensor-filter-key": "jk3"})
    ja.negotiate([JSpec.from_strings("4", "float32")])
    try:
        with pytest.raises(NegotiationError, match="already bound"):
            _filter("k3", framework="passthrough").negotiate([_spec()])
        with pytest.raises(JNegotiationError, match="already bound"):
            JFilter(framework="passthrough", **{"shared-tensor-filter-key": "jk3"}).negotiate(
                [JSpec.from_strings("4", "float32")])
    finally:
        a.stop()
        ja.stop()


def test_reload_visible_to_all_sharers(tmp_path):
    """A reload through one sharer swaps the model for all (the torch
    backend's get_model scripts, where the reference's are jax ones)."""
    paths = {}
    for name, k in (("m1", 10.0), ("m2", 100.0)):
        paths[name] = tmp_path / f"{name}.py"
        paths[name].write_text("def get_model(options):\n"
                               f"    return (lambda t: (t[0] * {k},)), None\n")
        (tmp_path / f"j{name}.py").write_text("def get_model(options):\n"
                                              f"    return (lambda x: x * {k}), None\n")
    props = dict(input="4", inputtype="float32")
    a = _filter("k4", framework="torch", model=str(paths["m1"]), **props)
    b = _filter("k4", framework="torch", model=str(paths["m1"]), **props)
    ja = JFilter(framework="jax", model=str(tmp_path / "jm1.py"), **props,
                 **{"shared-tensor-filter-key": "jk4"})
    jb = JFilter(framework="jax", model=str(tmp_path / "jm1.py"), **props,
                 **{"shared-tensor-filter-key": "jk4"})
    try:
        a.negotiate([_spec()])
        b.negotiate([_spec()])
        ja.negotiate([JSpec.from_strings("4", "float32")])
        jb.negotiate([JSpec.from_strings("4", "float32")])
        x = np.ones(4, np.float32)

        def outs():
            got = b.host_process(Frame((torch.from_numpy(x),))).tensors[0].numpy()
            want = np.asarray(jb.host_process(JFrame((x,))).tensors[0])
            np.testing.assert_array_equal(got, want)
            return got

        np.testing.assert_array_equal(outs(), np.full(4, 10.0))
        a.reload_model(str(paths["m2"]))
        ja.reload_model(str(tmp_path / "jm2.py"))
        np.testing.assert_array_equal(outs(), np.full(4, 100.0))
    finally:
        for f in (a, b, ja, jb):
            f.stop()


def test_shared_backend_stats_are_per_element():
    """Sharers of one backend do not report each other's invokes; the
    backend keeps the per-framework view; a stopped sharer's view freezes."""
    a = _filter("ks", framework="scaler")
    b = _filter("ks", framework="scaler")
    ja = JFilter(framework="scaler", **{"shared-tensor-filter-key": "jks"})
    jb = JFilter(framework="scaler", **{"shared-tensor-filter-key": "jks"})
    try:
        a.negotiate([_spec()])
        b.negotiate([_spec()])
        ja.negotiate([JSpec.from_strings("4", "float32")])
        jb.negotiate([JSpec.from_strings("4", "float32")])
        f, jf = Frame((torch.ones(4),)), JFrame((np.ones(4, np.float32),))
        for _ in range(3):
            a.host_process(f)
            ja.host_process(jf)
        b.host_process(f)
        jb.host_process(jf)
        counts = (a.invoke_stats.total_invoke_num, b.invoke_stats.total_invoke_num,
                  a.backend.stats.total_invoke_num)
        assert counts == (ja.invoke_stats.total_invoke_num, jb.invoke_stats.total_invoke_num,
                          ja.backend.stats.total_invoke_num) == (3, 1, 4)
        a.stop()
        before = a.invoke_stats.total_invoke_num
        b.host_process(f)  # the other sharer keeps running
        assert a.invoke_stats.total_invoke_num == before
    finally:
        for x in (a, b, ja, jb):
            x.stop()
