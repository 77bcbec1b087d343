"""Port parity for ``.tflite`` models: the flatbuffer reader
(tools/tflite_parse.py) against the JAX package's, field by field; the
port's torch program (tools/tflite_exec.py) against the reference's jnp
program and the TFLite interpreter; the ``framework=tflite`` host
interpreter and ``framework=auto`` against the reference's backends; an
unbuildable op refused at ``open``; a ``.tflite`` labeling pipeline fused
into one segment; ``load_tflite_params``; and ``chip_smoke.py``'s own
``.tflite`` writer, checked here where tensorflow is.

The files are converted once per module (about 15 s a Keras conversion):
a float Keras MobileNetV2 at alpha 0.35 / 96² with numpy-seeded weights
(Keras's default init gives every class the same logit) and
``classifier_activation=None``, its full-int8 conversion (int8 input and
output), a small graph of RESIZE_BILINEAR (both alignments),
CONCATENATION, PAD, both pools, LOGISTIC and RESHAPE, and two jax2tf
graphs (an add, and a uint8 cast whose CAST the programs do not build).

Tolerances:

- parses: equal (names, shapes, dtypes, buffers, quantization, bytes,
  ops, options);
- the float MobileNetV2 against the reference's program: 5e-5 of
  max(1, max |ref|) (two summation orders over 64 ops); against the
  interpreter the same;
- the small graph: 1e-6 of max(1, max |ref|);
- the int8 graph against the reference's fake-quant program: each op,
  fed the reference's activations, within one quantization step of its
  output grid (plus float32 rounding of the dequantized values): two
  summation orders can put a value on either side of a rounding edge;
- ``framework=tflite``: equal to the reference's interpreter backend (the
  same interpreter);
- pipelines: labels equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from nnstreamer_tpu.backends.base import BackendError as JBackendError
from nnstreamer_tpu.models import mobilenet_v2 as jmb
from nnstreamer_tpu.models import zoo as jzoo
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu.single import SingleShot as JSingleShot
from nnstreamer_tpu.tools import tflite_exec as jexec
from nnstreamer_tpu.tools import tflite_parse as jparse
from nnstreamer_tpu_torch.backends.base import BackendError
from nnstreamer_tpu_torch.models.mobilenet_v2 import load_tflite_params
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.single import SingleShot
from nnstreamer_tpu_torch.tools import tflite_exec as texec
from nnstreamer_tpu_torch.tools import tflite_parse as tparse

tf = pytest.importorskip("tensorflow", reason="converting the graphs needs tensorflow")


def _keras_weights(model, rng):
    """Seeded weights for every Keras variable: He-normal kernels, batch
    norms of non-trivial moments, small biases."""
    out = []
    for w in model.weights:
        name, shape = w.path, tuple(w.shape)
        if "gamma" in name or "moving_variance" in name:
            a = rng.uniform(0.5, 1.5, shape)
        elif "beta" in name or "moving_mean" in name or "bias" in name:
            a = rng.normal(0.0, 0.1, shape)
        else:
            fan_in = int(np.prod(shape[:2] if "depthwise" in name else shape[:-1]))
            a = rng.standard_normal(shape) * np.sqrt(2.0 / max(fan_in, 1))
        out.append(a.astype(np.float32))
    return out


def _small_graph():
    rng = np.random.default_rng(2)
    w1 = tf.constant((rng.standard_normal((3, 3, 3, 8)) * 0.3).astype(np.float32))
    b1 = tf.constant(rng.normal(0.0, 0.1, 8).astype(np.float32))

    @tf.function(input_signature=[tf.TensorSpec((1, 16, 16, 3), tf.float32)])
    def small(x):
        y = tf.nn.relu(tf.nn.conv2d(x, w1, strides=2, padding="SAME") + b1)
        a = tf.compat.v1.image.resize_bilinear(y, (12, 12), align_corners=True)
        b = tf.image.resize(y, (12, 12), method="bilinear")  # half-pixel centers
        c = tf.pad(tf.concat([a, b], axis=-1), [[0, 0], [1, 1], [2, 0], [0, 0]])
        s = tf.sigmoid(tf.nn.max_pool2d(c, 3, 2, "SAME") + tf.nn.avg_pool2d(c, 3, 2, "SAME"))
        return tf.reshape(s, (1, -1))

    return small


def _jax2tf(fn, shape, dtype, path):
    from jax.experimental import jax2tf

    tf_fn = tf.function(jax2tf.convert(fn, native_serialization=False),
                        input_signature=[tf.TensorSpec(shape, dtype)], autograph=False)
    conv = tf.lite.TFLiteConverter.from_concrete_functions([tf_fn.get_concrete_function()])
    path.write_bytes(conv.convert())
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tflite")
    model = tf.keras.applications.MobileNetV2(
        input_shape=(96, 96, 3), alpha=0.35, weights=None, classes=16,
        classifier_activation=None)
    model.set_weights(_keras_weights(model, np.random.default_rng(0)))
    out = {"float": d / "mobilenet_float.tflite", "int8": d / "mobilenet_int8.tflite",
           "small": d / "small.tflite", "writer": d / "writer.tflite"}
    out["float"].write_bytes(tf.lite.TFLiteConverter.from_keras_model(model).convert())
    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    rng = np.random.default_rng(1)
    conv.representative_dataset = lambda: (
        [rng.uniform(-1, 1, (1, 96, 96, 3)).astype(np.float32)] for _ in range(4))
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    out["int8"].write_bytes(conv.convert())
    small = _small_graph()
    out["small"].write_bytes(
        tf.lite.TFLiteConverter.from_concrete_functions([small.get_concrete_function()],
                                                       small).convert())
    graph = chip_smoke.write_mobilenet_v2_tflite(np, str(out["writer"]), seed=3, size=96,
                                                 num_classes=16)
    add = jzoo.get("add", dims="4")
    paths = {k: str(v) for k, v in out.items()}
    paths["add"] = _jax2tf(add.fn, (4,), tf.float32, d / "add.tflite")
    paths["cast"] = _jax2tf(lambda x: x.astype(jnp.float32) * 2.0, (1, 8, 8, 3), tf.uint8,
                            d / "cast.tflite")
    return paths, graph


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _scale(ref):
    return max(1.0, float(np.abs(np.asarray(ref)).max()))


def _input(path, seed):
    m = tparse.parse(path)
    t = m.tensors[m.inputs[0]]
    rng = np.random.default_rng(seed)
    if np.dtype(t.dtype) == np.int8:
        return rng.integers(-128, 128, t.shape).astype(np.int8)
    if np.dtype(t.dtype) == np.uint8:
        return rng.integers(0, 256, t.shape).astype(np.uint8)
    return rng.uniform(-1, 1, t.shape).astype(np.float32)


def _interpreter(path, x):
    it = tf.lite.Interpreter(model_path=path)
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    od = it.get_output_details()[0]
    return it.get_tensor(od["index"])


def _assert_same_parse(a, b):
    assert (a.inputs, a.outputs, a.description) == (b.inputs, b.outputs, b.description)
    assert len(a.tensors) == len(b.tensors) and len(a.operators) == len(b.operators)
    for x, y in zip(a.tensors, b.tensors):
        assert (x.index, x.name, x.shape, x.dtype, x.buffer) == \
               (y.index, y.name, y.shape, y.dtype, y.buffer)
        assert (x.quant is None) == (y.quant is None)
        if x.quant is not None:
            np.testing.assert_array_equal(x.quant.scale, y.quant.scale)
            np.testing.assert_array_equal(x.quant.zero_point, y.quant.zero_point)
            assert x.quant.quantized_dimension == y.quant.quantized_dimension
        assert (x.data is None) == (y.data is None)
        if x.data is not None:
            assert x.data.dtype == y.data.dtype
            np.testing.assert_array_equal(x.data, y.data)
            np.testing.assert_array_equal(x.dequantized(), y.dequantized())
    for x, y in zip(a.operators, b.operators):
        assert (x.opcode, x.name, x.inputs, x.outputs, x.options, x.custom_code) == \
               (y.opcode, y.name, y.inputs, y.outputs, y.options, y.custom_code)


@pytest.mark.parametrize("name", ["float", "int8", "small", "writer", "add", "cast"])
def test_parse_equals_reference(files, name):
    path = files[0][name]
    a, b = tparse.parse(path), jparse.parse(path)
    _assert_same_parse(a, b)
    assert tparse.summarize(a) == jparse.summarize(b)


def test_writer_file_parses_back_to_the_graph_written(files):
    paths, graph = files
    assert chip_smoke.parse_matches_graph(np, tparse.parse(paths["writer"]), graph) > 0


@pytest.mark.parametrize("name,rel", [("float", 5e-5), ("small", 1e-6), ("writer", 5e-5)])
def test_program_matches_reference_and_interpreter(files, name, rel):
    path = files[0][name]
    x = _input(path, 0)
    ref = np.asarray(jexec.TFLiteProgram(path)(x)[0])
    prog = texec.TFLiteProgram(path, device="cpu")
    assert prog.fake_quant is False
    (got,) = prog(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert _err(got, ref) <= rel * _scale(ref)
    assert _err(got, _interpreter(path, x)) <= rel * _scale(ref)


def test_small_graph_has_the_ops_it_stands_for(files):
    ops = {op.name for op in tparse.parse(files[0]["small"]).operators}
    assert {"RESIZE_BILINEAR", "CONCATENATION", "PAD", "MAX_POOL_2D", "AVERAGE_POOL_2D",
            "LOGISTIC", "RESHAPE"} <= ops
    aligns = {(op.options["align_corners"], op.options["half_pixel_centers"])
              for op in tparse.parse(files[0]["small"]).operators
              if op.name == "RESIZE_BILINEAR"}
    assert aligns == {(True, False), (False, True)}


def _op_alone(m, op):
    """``m`` cut to one operator: its non-constant inputs in, its output out."""
    ins = [i for i in op.inputs if i >= 0 and m.tensors[i].data is None]
    return dataclasses.replace(m, operators=[op], inputs=ins, outputs=[op.outputs[0]]), ins


def _on_grid(v, t):
    """A fake-quant activation back to its integer tensor (exact: it is on
    the grid)."""
    s, z = float(t.quant.scale[0]), int(t.quant.zero_point[0])
    return (np.round(np.asarray(v, np.float64) / s) + z).astype(t.dtype)


def test_int8_program_each_op_within_one_step(files):
    """Every op of the int8 graph, fed the reference program's own
    activations, gives its output within one quantization step of the
    reference op's. (End to end the two fake-quant programs may part: a
    value a float32 rounding apart lands on the other side of a grid edge,
    and these random weights amplify one step into many downstream.)"""
    path = files[0]["int8"]
    jm, tm = jparse.parse(path), tparse.parse(path)
    out_t = tm.tensors[tm.outputs[0]]
    assert np.dtype(tm.tensors[tm.inputs[0]].dtype) == np.int8 and np.dtype(out_t.dtype) == np.int8
    prog = texec.TFLiteProgram(path, device="cpu")
    assert prog.fake_quant is True
    x = _input(path, 0)
    acts = dict(zip(
        [op.outputs[0] for op in jm.operators],
        (np.asarray(v) for v in jexec.TFLiteProgram(dataclasses.replace(
            jm, outputs=[op.outputs[0] for op in jm.operators]))(x))))
    acts[jm.inputs[0]] = x
    for jop, top in zip(jm.operators, tm.operators):
        jsub, ins = _op_alone(jm, jop)
        tsub, _ = _op_alone(tm, top)
        feed = [acts[i] if i == jm.inputs[0] else _on_grid(acts[i], jm.tensors[i]) for i in ins]
        want = np.asarray(jexec.TFLiteProgram(jsub)(*feed)[0])
        got = texec.TFLiteProgram(tsub, device="cpu")(*feed)[0].numpy()
        t = tm.tensors[top.outputs[0]]
        step = float(t.quant.scale[0])
        assert _err(got, want) <= step + 4 * float(np.spacing(np.float32(_scale(want)))), top.name
    # end to end: finite, on the output grid, inside the int8 range
    got = prog(x)[0].numpy()
    q = np.asarray(got, np.float64) / float(out_t.quant.scale[0]) + int(out_t.quant.zero_point[0])
    assert np.isfinite(got).all() and np.abs(q - np.round(q)).max() < 1e-3
    assert q.min() >= -128.5 and q.max() <= 127.5


def test_qdq_rounds_half_to_even_at_exact_ties():
    t = tparse.Tensor(0, "t", (6,), np.int8, 0,
                      tparse.QuantParams(scale=np.array([0.5], np.float32),
                                         zero_point=np.array([1], np.int64)))
    jt = jparse.Tensor(0, "t", (6,), np.int8, 0,
                       jparse.QuantParams(scale=np.array([0.5], np.float32),
                                          zero_point=np.array([1], np.int64)))
    # x / s = 0.5, 1.5, 2.5, -0.5, -1.5 (ties) and a clamp past the top
    x = np.array([0.25, 0.75, 1.25, -0.25, -0.75, 100.0], np.float32)
    got = texec._qdq(torch.from_numpy(x), t).numpy()
    want = np.asarray(jexec._qdq(jnp.asarray(x), jt))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.array([0.0, 1.0, 1.0, -0.0, -1.0, 63.0], np.float32))


def test_unbuildable_op_is_refused_at_open(files):
    path = files[0]["cast"]
    assert "STRIDED_SLICE" in {op.name for op in tparse.parse(path).operators}
    with pytest.raises(BackendError, match="code 53"):
        SingleShot(framework="torch", model=path, device="cpu").open()
    with pytest.raises(JBackendError):
        JSingleShot(framework="jax", model=path).open()


def test_framework_tflite_matches_reference_interpreter_backend(files):
    path = files[0]["float"]
    x = _input(path, 4)
    with SingleShot(framework="tflite", model=path, device="cpu") as s:
        (got,) = s.invoke(x)
        in_spec = s.input_spec
    with JSingleShot(framework="tflite", model=path) as s:
        (want,) = s.invoke(x)
        jin = s.input_spec
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(in_spec[0].shape) == tuple(jin[0].shape)


def test_framework_auto_picks_the_interpreter(files):
    """The reference's test_tflite_framework_autodetect, in the port."""
    path = files[0]["add"]
    with SingleShot(model=path, device="cpu") as s:
        assert s.props.framework == "tflite"
        (out,) = s.invoke(np.ones(4, np.float32))
    np.testing.assert_allclose(out.numpy(), np.full(4, 3.0))
    with SingleShot(framework="torch", model=path, device="cpu") as s:
        (out,) = s.invoke(np.ones(4, np.float32))
        assert s.backend.traceable_fn() is not None
    np.testing.assert_allclose(out.numpy(), np.full(4, 3.0))


LABELING = (
    "videotestsrc pattern=gradient width=160 height=120 num-frames=3 ! tensor_converter ! "
    "tensor_transform mode=resize option=96:96 ! tensor_transform mode=typecast option=float32 ! "
    "tensor_filter name=f framework={fw} model={model} ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out"
)


def test_tflite_labeling_pipeline_is_one_fused_segment(files):
    path = files[0]["writer"]
    p = parse_pipeline(LABELING.format(fw="torch", model=path), device="cpu")
    p.negotiate()
    prog = p["f"].backend.program
    assert {c.device.type for c in prog._consts.values()} == {"cpu"}  # the filter's device
    p.run(timeout=120)
    fused = [seg for seg in p._executor.plan.segments if seg.fused]
    assert len(fused) == 1
    assert {op.FACTORY_NAME for op in fused[0].ops} >= {"tensor_transform", "tensor_filter",
                                                        "tensor_decoder"}
    got = [int(np.asarray(f.tensors[0]).reshape(-1)[0]) for f in p["out"].frames]
    ref = jax_parse(LABELING.format(fw="jax", model=path))
    ref.run(timeout=120)
    want = [int(np.asarray(f.tensors[0]).reshape(-1)[0]) for f in ref["out"].frames]
    assert len(got) == 3 and got == want


def test_load_tflite_params_matches_reference(files):
    path = files[0]["writer"]
    x = np.random.default_rng(5).integers(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    params = jmb.load_tflite_params(path)
    ref = np.asarray(jax.jit(jmb.apply)(params, x))
    model = load_tflite_params(path)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 16)
    assert _err(got, ref) <= 1e-4 * _scale(ref)
    # the same weights as the program that runs the whole file
    prog = texec.TFLiteProgram(path, device="cpu")
    whole = np.concatenate([prog(x[i:i + 1].astype(np.float32))[0].numpy() for i in range(2)])
    assert _err(got, whole) <= 1e-4 * _scale(whole)
    with pytest.raises(ValueError, match="mobilenet_v2"):
        load_tflite_params(files[0]["small"])
