"""The port's media and sensor sources and ``tensor_stage``
(nnstreamer_tpu_torch/elements/media.py, iio.py, stage.py) against the JAX
package's, on the CPU:

- ``videofilesrc`` on an mp4v clip and a png that ``cv2`` writes in
  ``tmp_path``: the same decoded frames (bit for bit: the same decoder),
  pts, formats, loop and a still image, through a port pipeline; the
  missing-file and missing-camera errors; a missing ``cv2`` raises an
  ``ElementError`` naming it;
- ``tensor_src_iio`` on a fake sysfs tree: scale and offset, channel
  selection, the buffered character-device mode's packed records, the
  same frames as the reference's element;
- ``tensor_stage``: the spec passes through, frames leave as tensors on
  the pipeline's device (the CPU here), a bad device index is refused.
"""

import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2", reason="the media sources need OpenCV")

from nnstreamer_tpu.elements import iio as jiio
from nnstreamer_tpu.elements import media as jmedia
from nnstreamer_tpu.tensors.frame import EOS_FRAME as JEOS
from nnstreamer_tpu_torch.elements import iio, media
from nnstreamer_tpu_torch.elements.base import ElementError, HostElement
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.sources import AppSrc
from nnstreamer_tpu_torch.elements.stage import TensorStage
from nnstreamer_tpu_torch.pipeline.graph import Pipeline
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

W, H, N_FRAMES = 64, 48, 6


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An mp4v clip: frame i a solid level i*30."""
    path = str(tmp_path_factory.mktemp("media") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
    assert w.isOpened(), "this OpenCV build cannot encode mp4v"
    for i in range(N_FRAMES):
        w.write(np.full((H, W, 3), i * 30, np.uint8))
    w.release()
    return path


@pytest.fixture(scope="module")
def still(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("media") / "img.png")
    img = np.zeros((H, W, 3), np.uint8)
    img[:, :, 2] = 200  # red in BGR order (png is lossless)
    assert cv2.imwrite(path, img)
    return path


def _is_eos(f):
    return f is EOS_FRAME or f is JEOS  # either package's end of stream


def _drain(src):
    src.start()
    frames = []
    while True:
        f = src.generate()
        if _is_eos(f):
            break
        if f is not None:
            frames.append(f)
    src.stop()
    return frames


@pytest.mark.parametrize("fmt", ["RGB", "BGR", "GRAY8"])
def test_videofilesrc_decodes_the_reference_frames(clip, fmt):
    src = media.VideoFileSrc(location=clip, format=fmt)
    jsrc = jmedia.VideoFileSrc(location=clip, format=fmt)
    spec, jspec = src.output_spec(), jsrc.output_spec()
    assert (spec.width, spec.height, spec.format) == (jspec.width, jspec.height, jspec.format)
    frames, jframes = _drain(src), _drain(jsrc)
    assert len(frames) == len(jframes) == N_FRAMES
    for i, (f, jf) in enumerate(zip(frames, jframes)):
        img = np.asarray(f.tensors[0])
        assert img.flags["C_CONTIGUOUS"] and img.dtype == np.uint8
        np.testing.assert_array_equal(img, np.asarray(jf.tensors[0]))
        assert f.pts == jf.pts
        if fmt != "GRAY8":
            assert abs(float(img.mean()) - i * 30) < 6
    assert frames[1].pts == 100_000_000


def test_videofilesrc_through_a_pipeline(clip):
    p = parse_pipeline(f"videofilesrc location={clip} ! tensor_converter ! "
                       "tensor_filter framework=passthrough ! tensor_sink name=out", device="cpu")
    p.run(timeout=120)
    assert p["out"].rendered == N_FRAMES
    assert np.asarray(p["out"].frames[0].tensors[0]).shape == (1, H, W, 3)


def test_videofilesrc_loop_caps_at_num_frames(clip):
    frames = _drain(media.VideoFileSrc(location=clip, loop="true", **{"num-frames": 10}))
    assert len(frames) == 10


def test_videofilesrc_still_image(still):
    src = media.VideoFileSrc(location=still, format="RGB")
    src.start()
    f = src.generate()
    assert src.generate() is EOS_FRAME  # a still emits once by default
    img = np.asarray(f.tensors[0])
    assert img.shape == (H, W, 3) and img[0, 0, 0] == 200 and img[0, 0, 2] == 0
    src.stop()
    jsrc = jmedia.VideoFileSrc(location=still, format="RGB")
    jsrc.start()
    np.testing.assert_array_equal(img, np.asarray(jsrc.generate().tensors[0]))
    jsrc.stop()


def test_missing_file_and_camera_raise(tmp_path):
    with pytest.raises(ElementError, match="cannot"):
        media.VideoFileSrc(location=str(tmp_path / "nope.mp4"))
    with pytest.raises(ElementError, match="cannot open camera"):
        media.V4l2Src(device="/dev/video99")


def test_missing_cv2_names_it(clip, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    with pytest.raises(ElementError, match=r"cv2"):
        media.VideoFileSrc(location=clip)
    with pytest.raises(ElementError, match=r"cv2"):
        media.V4l2Src(device="0")


# -- tensor_src_iio ------------------------------------------------------------
def _fake_device(tmp_path, n=0, name="accel_3d", channels=("accel_x", "accel_y")):
    d = tmp_path / f"iio:device{n}"
    d.mkdir(parents=True)
    (d / "name").write_text(name + "\n")
    for i, c in enumerate(channels):
        (d / f"in_{c}_raw").write_text(f"{100 + i}\n")
        (d / f"in_{c}_scale").write_text("0.5\n")
        (d / f"in_{c}_offset").write_text("2\n")
    (d / "sampling_frequency").write_text("100\n")
    return d


def _first(src):
    f = None
    while f is None:
        f = src.generate()
    return f


def test_iio_scan_scale_offset_and_channels(tmp_path):
    _fake_device(tmp_path, 0, "accel_3d", channels=("accel_x", "accel_y", "accel_z"))
    _fake_device(tmp_path, 1, "gyro_3d", channels=("anglvel_x",))
    assert set(iio.scan_devices(str(tmp_path))) == set(jiio.scan_devices(str(tmp_path)))
    props = {"base-dir": str(tmp_path), "device": "accel_3d", "frequency": 1000,
             "num-frames": 2, "channels": "accel_z,accel_x"}
    src, jsrc = iio.TensorSrcIIO(**props), jiio.TensorSrcIIO(**props)
    assert src.output_spec()[0].shape == jsrc.output_spec()[0].shape == (1, 2)
    assert src._channels == ["accel_z", "accel_x"]
    got, want = np.asarray(_first(src).tensors[0]), np.asarray(_first(jsrc).tensors[0])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, [[52.0, 51.0]])  # (raw + offset) * scale


def test_iio_missing_device_and_eos(tmp_path):
    _fake_device(tmp_path, 0)
    with pytest.raises(ElementError, match="not found"):
        iio.TensorSrcIIO(**{"base-dir": str(tmp_path), "device": "nope"}).output_spec()
    src = iio.TensorSrcIIO(**{"base-dir": str(tmp_path), "frequency": 10000, "num-frames": 1})
    src.output_spec()
    _first(src)
    assert src.generate() is EOS_FRAME


def test_iio_pipeline_end_to_end(tmp_path):
    _fake_device(tmp_path, 0)
    src = iio.TensorSrcIIO(**{"base-dir": str(tmp_path), "frequency": 500, "num-frames": 3})
    sink = TensorSink()
    Pipeline(device="cpu").chain(src, sink).run(timeout=30)
    assert sink.rendered == 3 and sink.frames[0].tensors[0].shape == (1, 2)


def _fake_buffered_device(tmp_path, records):
    d = tmp_path / "sys" / "iio:device0"
    scan = d / "scan_elements"
    scan.mkdir(parents=True)
    (d / "name").write_text("accel_3d\n")
    (d / "buffer").mkdir()
    (d / "buffer" / "length").write_text("16\n")
    (d / "buffer" / "enable").write_text("0\n")
    for c, idx, t in (("accel_x", 0, "le:s12/16>>0"), ("accel_y", 1, "be:u10/16>>2"),
                      ("temp", 2, "le:s8/8>>0")):
        (scan / f"in_{c}_en").write_text("0\n")
        (scan / f"in_{c}_index").write_text(f"{idx}\n")
        (scan / f"in_{c}_type").write_text(t + "\n")
        (d / f"in_{c}_scale").write_text("1.0\n")
        (d / f"in_{c}_offset").write_text("0\n")
    dev = tmp_path / "dev"
    dev.mkdir(exist_ok=True)
    blob = b""
    for x, y, t in records:
        blob += int(x).to_bytes(2, "little") + int(y).to_bytes(2, "big")
        blob += int(t).to_bytes(1, "little") + b"\x00"
    (dev / "iio:device0").write_bytes(blob)
    return d


@pytest.mark.parametrize("mod", [iio, jiio])
def test_iio_buffered_records(tmp_path, mod):
    records = [(0x801 & 0xFFFF, 40 << 2, (-5) & 0xFF), (100, 3 << 2, 7)]
    d = _fake_buffered_device(tmp_path, records)
    src = mod.TensorSrcIIO(**{"base-dir": str(tmp_path / "sys"), "dev-dir": str(tmp_path / "dev"),
                              "mode": "buffer", "frequency": 100, "num-frames": len(records)})
    assert src.output_spec()[0].shape == (1, 3)
    frames = []
    while True:
        f = src.generate()
        if _is_eos(f):
            break
        if f is not None:
            frames.append(f)
    src.stop()
    np.testing.assert_allclose(np.asarray(frames[0].tensors[0]), [[-2047.0, 40.0, -5.0]])
    np.testing.assert_allclose(np.asarray(frames[1].tensors[0]), [[100.0, 3.0, 7.0]])
    assert [f.pts for f in frames] == [0, 10_000_000]
    assert (d / "buffer" / "enable").read_text() == "0"  # the teardown disabled it


def test_iio_bad_type_string_rejected():
    with pytest.raises(ElementError, match="bad IIO channel type"):
        iio.ChannelFormat("xx:s12/16>>0")


# -- tensor_stage ----------------------------------------------------------------
class _TypeProbe(HostElement):
    FACTORY_NAME = "test_type_probe"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.types = []

    def negotiate(self, in_specs):
        return list(in_specs)

    def process(self, frame):
        self.types.append(type(frame.tensors[0]))
        return frame


def _frames(n):
    return [np.full((1, 8, 8, 3), i, np.uint8) for i in range(n)]


def test_stage_moves_frames_up_and_passes_the_spec():
    spec = TensorsSpec.from_strings("3:8:8:1", "uint8")
    st, probe, sink = TensorStage(stamp=True), _TypeProbe(), TensorSink()
    p = Pipeline(device="cpu").chain(AppSrc(iterable=_frames(3), spec=spec), st, probe, sink)
    p.run(timeout=30)
    assert sink.rendered == 3 and probe.types == [torch.Tensor] * 3
    assert st.out_specs == st.in_specs
    assert all("staged_at" in f.meta for f in sink.frames)
    assert [int(f.tensors[0][0, 0, 0, 0]) for f in sink.frames] == [0, 1, 2]


def test_stage_bad_device_index():
    spec = TensorsSpec.from_strings("3:8:8:1", "uint8")
    st = TensorStage(device="99")
    with pytest.raises(Exception, match="out of range"):
        Pipeline(device="cpu").chain(AppSrc(iterable=_frames(1), spec=spec), st,
                                     TensorSink()).run(timeout=30)
