"""The port's wire codecs and host decoders against the JAX package's.

- The port writes protobuf and flatbuffers by hand (it imports neither
  runtime). Its ``serialize_frame`` and ``encode_flatbuf`` must give the
  bytes of the reference's ``frame_to_message(...).SerializeToString()``
  and ``encode_flatbuf`` (the libraries' own encoders), and its flexbuf
  encoder the reference's ``encode_frame_tensors``. The cases come from
  numpy seeds: every dtype each codec takes (int32, whose type field
  proto3 leaves out, included), 1 to 16 tensors (flatbuffers shares the
  first Tensor table's vtable with the rest), shape ``()`` and zero-size
  tensors, rate None, 30/1 and 30000/1001, static and flexible format;
  hypothesis adds random ones.
- Each package's decoder parses the other package's bytes to the same
  arrays (bytes, dtype, shape) and rate.
- The ``octet_stream``, ``direct_video`` (batched, pts split) and ``font``
  decoders and the ``python3`` converter give the reference's output on
  the same frames; ``tensor_converter mode=`` (subplugins, custom-code,
  custom-script, the input-norm refusal) behaves as the reference's.
- The seven codec goldens through ``nnstreamer_tpu_torch.cli --device
  cpu``, byte for byte, and the codec pairs inside pipelines against the
  JAX pipelines.
"""

import struct
from fractions import Fraction

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from nnstreamer_tpu.converters import flatbuf as jfb
from nnstreamer_tpu.converters import protobuf as jpb
from nnstreamer_tpu.converters import python_script as jpy
from nnstreamer_tpu.decoders import direct_video as jdv
from nnstreamer_tpu.decoders import font as jfont
from nnstreamer_tpu.decoders import octet_stream as joctet
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu.proto import nns_tensors_pb2
from nnstreamer_tpu.tensors import meta as jmeta
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu.tensors.spec import TensorFormat as JFormat
from nnstreamer_tpu.tensors.spec import TensorSpec as JTSpec
from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.converters import flatbuf as tfb
from nnstreamer_tpu_torch.converters import protobuf as tpb
from nnstreamer_tpu_torch.converters import python_script as tpy
from nnstreamer_tpu_torch.decoders import direct_video as tdv
from nnstreamer_tpu_torch.decoders import font as tfont
from nnstreamer_tpu_torch.decoders import octet_stream as toctet
from nnstreamer_tpu_torch.elements import converter as tconv
from nnstreamer_tpu_torch.elements.base import MediaSpec, NegotiationError
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors import meta as tmeta
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorSpec, TensorsSpec

from test_golden import FIXTURE_DIR, GOLDEN_DIR, PIPELINES

PB_DTYPES = ["int32", "uint32", "int16", "uint16", "int8", "uint8", "float64", "float32",
             "int64", "uint64", "float16", "bfloat16"]
FB_DTYPES = PB_DTYPES[:10]  # the flatbuffers schema has no 16-bit floats
SHAPES = [(2, 3, 4), (), (0,), (3, 0, 2), (1, 4, 4, 3), (5,), (2, 1, 1, 1, 3)]
RATES = {"none": None, "30": Fraction(30, 1), "ntsc": Fraction(30000, 1001)}
FORMATS = {"static": (TensorFormat.STATIC, JFormat.STATIC),
           "flexible": (TensorFormat.FLEXIBLE, JFormat.FLEXIBLE)}
CODEC_GOLDENS = ["decoder_flexbuf", "decoder_protobuf", "decoder_flatbuf", "decoder_octet",
                 "converter_flexbuf_roundtrip", "decoder_direct_video", "decoder_python3"]


def np_dtype(name):
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" else np.dtype(name)


def seeded_arrays(seed, dtypes, shapes):
    """Arrays of random bytes (any bit pattern, NaNs included) from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(max(len(dtypes), len(shapes))):
        dt, shape = np_dtype(dtypes[i % len(dtypes)]), shapes[i % len(shapes)]
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(rng.integers(0, 256, n, dtype=np.uint8).view(dt).reshape(shape))
    return out


def as_torch(a):
    """A numpy array (an ml_dtypes bfloat16 one too) as a torch tensor."""
    if a.dtype == np_dtype("bfloat16"):
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def host_view(t):
    """(bytes, dtype name, shape) of a decoded tensor of either package."""
    if isinstance(t, torch.Tensor):
        name = str(t.dtype).removeprefix("torch.")
        t = t.view(torch.uint16) if t.dtype is torch.bfloat16 else t
        return t.numpy().tobytes(), name, tuple(t.shape)
    a = np.asarray(t)
    return a.tobytes(), a.dtype.name, a.shape


def frames(arrays, rate=None, names=None):
    meta = {}
    if rate is not None:
        meta["rate"] = rate
    if names:
        meta["names"] = names
    return Frame(tuple(as_torch(a) for a in arrays), meta=dict(meta)), JFrame(
        tuple(arrays), meta=dict(meta))


CASES = {
    **{f"{d}": (1, [d], [(2, 3, 4)]) for d in PB_DTYPES},
    "scalar-shape": (2, ["float32", "int32"], [()]),
    "zero-size": (3, ["uint8", "float32", "int32"], [(0,), (3, 0, 2)]),
    **{f"{n}-tensors": (10 + n, FB_DTYPES, SHAPES) for n in (1, 2, 3, 16)},
}


FB_CASES = sorted(c for c in CASES if c not in ("float16", "bfloat16"))


def case_arrays(case, dtypes_allowed):
    seed, dtypes, shapes = CASES[case]
    dtypes = [d for d in dtypes if d in dtypes_allowed]
    n = int(case.split("-")[0]) if case.endswith("-tensors") else max(len(dtypes), len(shapes))
    return seeded_arrays(seed, dtypes, (shapes * n)[:n])[:n]


# -- protobuf ---------------------------------------------------------------------

@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("rate", sorted(RATES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_protobuf_bytes_equal_the_library_encoder(case, rate, fmt):
    arrays = case_arrays(case, PB_DTYPES)
    port, ref = frames(arrays, RATES[rate])
    tfmt, jfmt = FORMATS[fmt]
    want = jpb.frame_to_message(ref, jfmt).SerializeToString()
    assert tpb.serialize_frame(port, tfmt) == want


def test_protobuf_int32_carries_no_type_field():
    """proto3 leaves out a field at its default: an int32 tensor has no
    type, and the empty name and STATIC format are absent too."""
    port, ref = frames([np.arange(6, dtype=np.int32).reshape(2, 3)])
    blob = tpb.serialize_frame(port)
    assert blob == jpb.frame_to_message(ref).SerializeToString()
    assert b"\x10" not in blob[:8] and len(blob) == 2 + 2 + 4 + 2 + 24


def test_protobuf_names_and_explicit_rate():
    arrays = seeded_arrays(5, ["float32", "uint8"], [(2, 2), (3,)])
    names = {0: "boxes", 1: "scores"}
    port, ref = frames(arrays, Fraction(15, 2), names)
    for rate in (None, Fraction(60, 1)):
        want = jpb.frame_to_message(ref, JFormat.SPARSE, rate=rate).SerializeToString()
        assert tpb.serialize_frame(port, TensorFormat.SPARSE, rate=rate) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_protobuf_each_decoder_parses_the_others_bytes(case):
    arrays = case_arrays(case, PB_DTYPES)
    port, ref = frames(arrays, Fraction(30000, 1001))
    port_bytes = tpb.serialize_frame(port)
    ref_bytes = jpb.frame_to_message(ref).SerializeToString()
    mine, (rn, rd) = tpb.parse_tensors(ref_bytes)
    msg = nns_tensors_pb2.Tensors.FromString(port_bytes)
    theirs = jpb.message_to_tensors(msg)
    assert (rn, rd) == (msg.fr.rate_n, msg.fr.rate_d) == (30000, 1001)
    assert [host_view(t) for t in mine] == [host_view(t) for t in theirs]
    # a shape () tensor carries no dimension field: it comes back flat
    assert [host_view(t) for t in theirs] == [
        host_view(a if a.shape else a.reshape(1)) for a in arrays]


def test_protobuf_parser_takes_unpacked_dimensions_and_unknown_fields():
    """Any valid encoding parses: a dimension field written unpacked, an
    unknown varint, fixed64 and fixed32 field, and the rate merged from
    two fr fields."""
    body = (b"\x10\x07"              # type FLOAT32
            b"\x18\x03\x18\x02"      # dimension 3, 2 (unpacked)
            b"\x28\x05"              # unknown varint field 5
            b"\x31" + bytes(8) +     # unknown fixed64 field 6
            b"\x22\x18" + np.arange(6, dtype=np.float32).tobytes())
    msg = (b"\x12\x02\x08\x19" + b"\x1a" + bytes([len(body)]) + body
           + b"\x3d" + bytes(4) + b"\x12\x02\x10\x01")
    (t,), rate = tpb.parse_tensors(msg)
    assert rate == (25, 1)
    assert t.dtype is torch.float32 and tuple(t.shape) == (2, 3)
    assert torch.equal(t.reshape(-1), torch.arange(6, dtype=torch.float32))


def test_protobuf_parser_refuses_truncated_messages():
    blob = tpb.serialize_frame(frames([np.zeros((4,), np.float32)])[0])
    with pytest.raises(ValueError, match="protobuf"):
        tpb.parse_tensors(blob[:-3])


# -- flatbuffers -------------------------------------------------------------------

@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("rate", sorted(RATES))
@pytest.mark.parametrize("case", FB_CASES)
def test_flatbuf_bytes_equal_the_library_builder(case, rate, fmt):
    arrays = case_arrays(case, FB_DTYPES)
    r = RATES[rate]
    pair = (r.numerator, r.denominator) if r else None
    tfmt, jfmt = FORMATS[fmt]
    want = jfb.encode_flatbuf(arrays, rate=pair, fmt=jfmt)
    assert tfb.encode_flatbuf([as_torch(a) for a in arrays], rate=pair, fmt=tfmt) == want


def test_flatbuf_shares_the_first_tensor_tables_vtable():
    """16 tensors of one rank: one Tensor vtable in the whole buffer."""
    arrays = seeded_arrays(7, ["float32"], [(2, 3)] * 16)
    blob = tfb.encode_flatbuf([as_torch(a) for a in arrays])
    assert blob == jfb.encode_flatbuf(arrays)

    def u32(pos):
        return struct.unpack_from("<I", blob, pos)[0]

    root = u32(0)
    vt = root - struct.unpack_from("<i", blob, root)[0]
    vec = root + struct.unpack_from("<H", blob, vt + 8)[0]
    vec += u32(vec)
    tables = [vec + 4 + 4 * j + u32(vec + 4 + 4 * j) for j in range(u32(vec))]
    vtables = {t - struct.unpack_from("<i", blob, t)[0] for t in tables}
    assert len(tables) == 16 and len(vtables) == 1


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_flatbuf_refuses_16_bit_floats_as_the_reference_does(dtype):
    (a,) = seeded_arrays(1, [dtype], [(2, 2)])
    with pytest.raises(ValueError, match="not representable") as mine:
        tfb.encode_flatbuf([as_torch(a)])
    with pytest.raises(ValueError, match="not representable") as theirs:
        jfb.encode_flatbuf([a])
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("case", FB_CASES)
def test_flatbuf_each_decoder_parses_the_others_bytes(case):
    arrays = case_arrays(case, FB_DTYPES)
    port_bytes = tfb.encode_flatbuf([as_torch(a) for a in arrays], rate=(30, 1))
    ref_bytes = jfb.encode_flatbuf(arrays, rate=(30, 1))
    mine, mine_rate = tfb.decode_flatbuf(ref_bytes)
    theirs, their_rate = jfb.decode_flatbuf(port_bytes)
    assert mine_rate == their_rate == (30, 1)
    assert [host_view(t) for t in mine] == [host_view(t) for t in theirs]


def test_flatbuf_decodes_shape_mismatch_flat_as_the_reference():
    """An element count that does not fill the dimensions stays flat."""
    a = np.arange(6, dtype=np.int16)
    blob = jfb.encode_flatbuf([a])
    bad = blob.replace(np.array([6], np.uint32).tobytes(), np.array([5], np.uint32).tobytes(), 1)
    (mine,), _ = tfb.decode_flatbuf(bad)
    (theirs,), _ = jfb.decode_flatbuf(bad)
    assert host_view(mine) == host_view(theirs)


# -- flexbuf -----------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_flexbuf_bytes_and_parse_match_the_reference(case):
    arrays = case_arrays(case, PB_DTYPES)
    blob = tmeta.encode_frame_tensors([as_torch(a) for a in arrays])
    assert blob == jmeta.encode_frame_tensors(arrays)
    assert ([host_view(t) for t in tmeta.decode_frame_tensors(blob)]
            == [host_view(t) for t in jmeta.decode_frame_tensors(blob)])


# -- random cases --------------------------------------------------------------------

_shape = st.lists(st.integers(0, 5), min_size=0, max_size=4).map(tuple)


@settings(max_examples=40, deadline=None)
@given(dtypes=st.lists(st.sampled_from(FB_DTYPES), min_size=1, max_size=16),
       shapes=st.lists(_shape, min_size=1, max_size=16),
       seed=st.integers(0, 2**16), rate=st.sampled_from(sorted(RATES)))
def test_random_frames_encode_as_the_libraries_do(dtypes, shapes, seed, rate):
    arrays = seeded_arrays(seed, dtypes, shapes)[:16]
    port, ref = frames(arrays, RATES[rate])
    assert tpb.serialize_frame(port) == jpb.frame_to_message(ref).SerializeToString()
    r = RATES[rate]
    pair = (r.numerator, r.denominator) if r else None
    assert tfb.encode_flatbuf(port.tensors, rate=pair) == jfb.encode_flatbuf(arrays, rate=pair)


# -- host decoders and the python3 converter ------------------------------------------

def test_octet_stream_decoder_matches_reference():
    arrays = seeded_arrays(21, ["float32", "uint8", "int64"], [(2, 3), (4,), ()])
    port, ref = frames(arrays)
    (mine,) = toctet.OctetStreamDecoder().decode(port, {}).tensors
    (theirs,) = joctet.OctetStreamDecoder().decode(ref, {}).tensors
    assert mine.dtype == np.uint8 and mine.tobytes() == np.asarray(theirs).tobytes()


@pytest.mark.parametrize("n", [1, 3])
def test_direct_video_decoder_splits_batches_as_the_reference(n):
    (batch,) = seeded_arrays(22, ["uint8"], [(n, 6, 8, 3)])
    port = Frame((as_torch(batch),), pts=1000, duration=999)
    ref = JFrame((batch,), pts=1000, duration=999)
    spec = TensorsSpec.of(TensorSpec((n, 6, 8, 3), "uint8"), rate=Fraction(30, 1))
    media = tdv.DirectVideoDecoder().negotiate(spec, {})
    assert (media.width, media.height, media.format, media.rate) == (8, 6, "RGB", 30)
    mine = tdv.DirectVideoDecoder().decode(port, {})
    theirs = jdv.DirectVideoDecoder().decode(ref, {})
    mine, theirs = (x if isinstance(x, list) else [x] for x in (mine, theirs))
    assert len(mine) == len(theirs) == n
    for a, b in zip(mine, theirs):
        assert (a.pts, a.duration) == (b.pts, b.duration)
        assert np.array_equal(a.tensors[0], np.asarray(b.tensors[0]))


@pytest.mark.parametrize("spec", [TensorSpec((2, 6, 8, 3), "float32"),
                                  TensorSpec((6, 8, 3), "uint8"),
                                  TensorSpec((1, 6, 8, 2), "uint8")])
def test_direct_video_refuses_what_the_reference_refuses(spec):
    with pytest.raises(NegotiationError):
        tdv.DirectVideoDecoder().negotiate(TensorsSpec.of(spec), {})


def test_font_decoder_matches_reference():
    text = np.frombuffer(b"hello\nport\0ignored", np.uint8)
    for opts in ({}, {"option1": "96:40"}):
        mine_dec, their_dec = tfont.FontDecoder(), jfont.FontDecoder()
        spec = TensorsSpec.of(TensorSpec((text.size,), "uint8"))
        mine_dec.negotiate(spec, opts)
        their_dec.negotiate(JSpec.of(JTSpec((text.size,), "uint8")), opts)
        mine = mine_dec.decode(Frame((torch.from_numpy(text.copy()),)), opts)
        theirs = their_dec.decode(JFrame((text,)), opts)
        assert mine.meta["text"] == theirs.meta["text"] == "hello\nport"
        assert np.array_equal(mine.tensors[0], np.asarray(theirs.tensors[0]))


SCRIPT = '''
import numpy as np

class CustomConverter:
    def convert(self, tensors):
        raw = np.asarray(tensors[0]).reshape(-1)
        return (raw[:12].astype(np.float32).reshape(3, 4) / 2, raw[-4:].copy())
'''


def test_python3_converter_matches_reference(tmp_path):
    path = tmp_path / "conv.py"
    path.write_text(SCRIPT)
    (raw,) = seeded_arrays(23, ["uint8"], [(40,)])
    props = {"script": str(path)}
    mine = tpy.PythonScriptConverter().convert(Frame((as_torch(raw),)), props)
    theirs = jpy.PythonScriptConverter().convert(JFrame((raw,)), props)
    assert [host_view(t) for t in mine.tensors] == [host_view(t) for t in theirs.tensors]
    assert tpy.PythonScriptConverter().negotiate(None, props).format is TensorFormat.FLEXIBLE


# -- tensor_converter mode= ----------------------------------------------------------

def _converter(mode, **props):
    c = tconv.TensorConverter(mode=mode, **props)
    c.device = torch.device("cpu")
    return c


def test_custom_code_converter_register_and_unregister():
    calls = []

    def fn(frame, props):
        calls.append(frame)
        return frame.with_tensors((np.asarray(frame.tensors[0]).astype(np.int32) + 1,))

    tconv.register_custom_converter("plus1", fn)
    try:
        c = _converter("custom-code:plus1")
        (spec,) = c.fix_negotiation([MediaSpec("octet", rate=Fraction(5, 1))])
        assert spec.format is TensorFormat.FLEXIBLE and spec.rate == 5
        raw = np.arange(4, dtype=np.uint8)
        out = c.host_process(Frame((raw,)))
        assert calls[0].tensors[0] is raw  # the frame as it arrived, on the host
        assert isinstance(out.tensors[0], torch.Tensor)
        assert out.tensors[0].tolist() == [1, 2, 3, 4]
    finally:
        assert tconv.unregister_custom_converter("plus1")
    assert not tconv.unregister_custom_converter("plus1")
    with pytest.raises(NegotiationError, match="not registered"):
        _converter("custom-code:plus1").fix_negotiation([MediaSpec("octet")])


def test_custom_script_mode_runs_the_python3_subplugin(tmp_path):
    path = tmp_path / "conv.py"
    path.write_text(SCRIPT)
    c = _converter(f"custom-script:{path}")
    (spec,) = c.fix_negotiation([MediaSpec("octet")])
    assert spec.format is TensorFormat.FLEXIBLE and c.mode == "python3"
    (raw,) = seeded_arrays(24, ["uint8"], [(40,)])
    out = c.host_process(Frame((raw,)))
    assert torch.equal(out.tensors[1], torch.from_numpy(raw[-4:].copy()))


@pytest.mark.parametrize("mode", ["flexbuf", "custom-code:x"])
def test_input_norm_with_a_mode_is_refused(mode):
    c = _converter(mode, **{"input-norm": "127.5:127.5"})
    with pytest.raises(NegotiationError, match="input-norm"):
        c.fix_negotiation([MediaSpec("video", width=4, height=4)])


def test_subplugin_node_takes_frames_where_they_are():
    """The converter's host node does not move the wire bytes to the
    device before the subplugin parses them on the host."""
    p = parse_pipeline(
        "videotestsrc num-frames=1 width=4 height=4 ! tensor_converter ! "
        "tensor_decoder mode=protobuf ! tensor_converter name=c mode=protobuf ! "
        "tensor_sink name=out", device="cpu")
    plan = p.compile_plan()
    seg = plan.seg_of[p["c"]]
    assert not seg.fused and p["c"].DEVICE_PASSTHROUGH
    seen = []
    real = p["c"]._subplugin.convert
    p["c"]._subplugin.convert = lambda f, props: (seen.append(f.tensors[0]), real(f, props))[1]
    p.run(timeout=60)
    assert isinstance(seen[0], np.ndarray)
    assert isinstance(p["out"].frames[0].tensors[0], np.ndarray)


# -- pipelines -------------------------------------------------------------------------

@pytest.mark.parametrize("name", CODEC_GOLDENS)
def test_codec_golden(name, tmp_path):
    out = tmp_path / "dump.raw"
    desc = PIPELINES[name].format(out=out, fix=FIXTURE_DIR)
    assert cli.main(["--device", "cpu", "-q", desc]) == 0
    with open(f"{GOLDEN_DIR}/{name}.raw", "rb") as f:
        assert out.read_bytes() == f.read()


ROUNDTRIP = (
    "videotestsrc pattern=gradient width=32 height=24 num-frames=3 framerate=30000/1001 ! "
    "tensor_converter ! tensor_transform mode=typecast option={dtype} ! "
    "tensor_decoder mode={m} ! tensor_converter mode={m} ! tensor_sink name=out"
)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("m", ["flexbuf", "protobuf", "flatbuf"])
def test_codec_roundtrip_pipeline_matches_reference(m, dtype):
    """The codec-roundtrip-720p pipeline at a small size: every frame back
    as it left, and equal to the JAX pipeline's."""
    desc = ROUNDTRIP.format(m=m, dtype=dtype)
    port = parse_pipeline(desc, device="cpu")
    port.run(timeout=60)
    ref = jax_parse(desc)
    ref.run(timeout=60)
    src = parse_pipeline(desc.split(" ! tensor_decoder")[0] + " ! tensor_sink name=out",
                         device="cpu")
    src.run(timeout=60)
    got, want = port["out"].frames, ref["out"].frames
    assert len(got) == len(want) == 3
    for g, w, s in zip(got, want, src["out"].frames):
        assert host_view(g.tensors[0]) == host_view(w.tensors[0]) == host_view(s.tensors[0])
        assert g.pts == w.pts
