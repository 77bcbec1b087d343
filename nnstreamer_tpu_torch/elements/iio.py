"""tensor_src_iio: Linux Industrial-I/O sensor source.

The counterpart of ``nnstreamer_tpu/elements/iio.py``.

Reference: gst/nnstreamer/elements/gsttensor_srciio.c (2604 LoC) — scans
/sys/bus/iio/devices for iio:deviceN entries, resolves a device by name or
number, enumerates in_*_raw scan channels, configures sampling frequency,
and merges enabled channels into one tensor per capture (registration is
Linux-only, registerer/nnstreamer.c:113-119).

TPU-native redesign: the sysfs scanning/config logic is host-side and
stays faithful (same device/channel resolution, scale/offset application:
value = (raw + offset) * scale). Two capture modes:

- ``mode=oneshot`` (default): poll in_<ch>_raw at ``frequency`` Hz with a
  bounded wait so the executor's stop event is honored (the reference's
  poll() timeout, gsttensor_srciio.c:379-381).
- ``mode=buffer``: the /dev/iio:deviceN character-device path
  (gsttensor_srciio.c:2511) — enables scan_elements channels
  (in_<ch>_en), parses each channel's packed format from in_<ch>_type
  (``le:s12/16>>0`` = endianness : sign realbits / storagebits >> shift),
  orders by in_<ch>_index, sets buffer/length and buffer/enable, then
  reads fixed-size records from the device node and decodes them
  vectorized with numpy (mask, shift, sign-extend).

``base-dir`` points the scanner at any sysfs root and ``dev-dir`` at the
device-node directory, which is how tests provide a fake device tree
(the reference tests do the same with mock sysfs dirs).

Output: one float32 tensor [1, n_channels] per capture (merge-channels
layout), framerate = frequency; pts in integer nanoseconds.
"""

from __future__ import annotations

import os
import re
import time
from fractions import Fraction
from typing import Dict, List, Optional

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    ElementError,
    PropSpec,
    Source,
    Spec,
)
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

import numpy as np

DEFAULT_BASE_DIR = "/sys/bus/iio/devices"
DEFAULT_DEV_DIR = "/dev"
_CHANNEL_RE = re.compile(r"^in_(.+)_raw$")
_SCAN_EN_RE = re.compile(r"^in_(.+)_en$")
# scan_elements type string: "le:s12/16>>4" (IIO ABI buffer format)
_TYPE_RE = re.compile(r"^(be|le):(s|u)(\d+)/(\d+)>>(\d+)$")


class ChannelFormat:
    """One scan_elements channel's packed wire format."""

    def __init__(self, type_str: str) -> None:
        m = _TYPE_RE.match(type_str.strip())
        if not m:
            raise ElementError(f"bad IIO channel type {type_str!r}")
        endian, sign, real, storage, shift = m.groups()
        self.big_endian = endian == "be"
        self.signed = sign == "s"
        self.realbits = int(real)
        self.storagebits = int(storage)
        self.shift = int(shift)
        if self.storagebits % 8 or self.storagebits not in (8, 16, 32, 64):
            raise ElementError(f"unsupported storage bits in {type_str!r}")
        self.nbytes = self.storagebits // 8

    def decode(self, raw: np.ndarray) -> np.ndarray:
        """uint storage words → float32 channel values (shift, mask to
        realbits, sign-extend)."""
        v = (raw >> np.uint64(self.shift)) & np.uint64((1 << self.realbits) - 1)
        v = v.astype(np.int64)
        if self.signed:
            sign_bit = np.int64(1) << (self.realbits - 1)
            v = (v ^ sign_bit) - sign_bit
        return v.astype(np.float32)


def _read(path: str, default: Optional[str] = None) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return default


def scan_devices(base_dir: str = DEFAULT_BASE_DIR) -> Dict[str, str]:
    """name → device dir for every iio:deviceN under base_dir."""
    out: Dict[str, str] = {}
    try:
        entries = sorted(os.listdir(base_dir))
    except OSError:
        return out
    for entry in entries:
        if not entry.startswith("iio:device"):
            continue
        d = os.path.join(base_dir, entry)
        name = _read(os.path.join(d, "name"), entry)
        out[name] = d
    return out


@registry.element("tensor_src_iio")
class TensorSrcIIO(Source):
    """Props: device (name), device-number, frequency (Hz, default 10),
    channels (comma list of channel names, default all), num-frames
    (-1 = endless), mode=oneshot|buffer (buffer = packed records from the
    /dev/iio:deviceN node via scan_elements), buffer-length,
    base-dir (sysfs root) / dev-dir (node dir) for tests/containers."""

    FACTORY_NAME = "tensor_src_iio"

    PROPERTIES = {
        "device": PropSpec("str", None, desc="iio device name"),
        "device-number": PropSpec("int", None),
        "frequency": PropSpec("float", 10.0, desc="sampling rate (Hz)"),
        "num-frames": PropSpec("int", -1, desc="-1 = endless"),
        "mode": PropSpec("enum", "oneshot", ("oneshot", "buffer")),
        "buffer-length": PropSpec("int", 16),
        "channels": PropSpec("str", "", desc="comma list; empty = all"),
        "base-dir": PropSpec("str", None, desc="sysfs root override"),
        "dev-dir": PropSpec("str", None, desc="device node dir override"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.base_dir = str(self.get_property("base-dir", DEFAULT_BASE_DIR))
        self.dev_dir = str(self.get_property("dev-dir", DEFAULT_DEV_DIR))
        self.iio_device = self.get_property("device", None)
        self.device_number = self.get_property("device-number", None)
        self.frequency = float(self.get_property("frequency", 10.0))
        self.num_frames = int(self.get_property("num-frames", -1))
        self.mode = str(self.get_property("mode", "oneshot"))
        if self.mode not in ("oneshot", "buffer"):
            raise ElementError(f"{self.name}: mode must be oneshot|buffer")
        self.buffer_length = int(self.get_property("buffer-length", 16))
        chans = str(self.get_property("channels", ""))
        self._want_channels = [c for c in chans.split(",") if c] or None
        self._dir: Optional[str] = None
        self._channels: List[str] = []
        self._scales: Optional[np.ndarray] = None
        self._offsets: Optional[np.ndarray] = None
        self._i = 0
        self._next_t: Optional[float] = None
        # buffered-mode state
        self._fd: Optional[int] = None
        self._formats: List[ChannelFormat] = []
        self._record_size = 0
        self._pending = b""

    # -- device resolution (reference: scan + match by name/number) --------
    def _resolve_buffer_channels(self) -> None:
        """Buffered mode: channels come from scan_elements (in_<ch>_en /
        _index / _type), ordered by index; enable the wanted set and the
        buffer (gsttensor_srciio.c buffered setup)."""
        scan_dir = os.path.join(self._dir, "scan_elements")
        if not os.path.isdir(scan_dir):
            raise ElementError(
                f"{self.name}: device has no scan_elements (no buffer support)"
            )
        found = sorted(
            m.group(1)
            for m in (_SCAN_EN_RE.match(f) for f in os.listdir(scan_dir))
            if m
        )
        want = self._want_channels or found
        missing = [c for c in want if c not in found]
        if missing:
            raise ElementError(f"{self.name}: scan channels not found: {missing}")

        def _write(path: str, value: str) -> None:
            try:
                with open(path, "w") as f:
                    f.write(value)
            except OSError:
                pass  # read-only fake sysfs trees are fine

        ordered = []
        for c in found:
            _write(os.path.join(scan_dir, f"in_{c}_en"), "1" if c in want else "0")
            if c not in want:
                continue
            idx_s = _read(os.path.join(scan_dir, f"in_{c}_index"), "0")
            type_s = _read(os.path.join(scan_dir, f"in_{c}_type"))
            if type_s is None:
                raise ElementError(f"{self.name}: missing in_{c}_type")
            ordered.append((int(idx_s), c, ChannelFormat(type_s)))
        ordered.sort()
        self._channels = [c for _, c, _ in ordered]
        self._formats = [f for _, _, f in ordered]
        # field layout: each element aligned to its own storage size, record
        # padded to the largest element's alignment (Linux IIO buffer ABI)
        off = 0
        self._field_offsets = []
        for f in self._formats:
            off = (off + f.nbytes - 1) // f.nbytes * f.nbytes
            self._field_offsets.append(off)
            off += f.nbytes
        align = max(f.nbytes for f in self._formats)
        self._record_size = (off + align - 1) // align * align
        _write(os.path.join(self._dir, "buffer", "length"),
               str(self.buffer_length))
        _write(os.path.join(self._dir, "buffer", "enable"), "1")

    def _resolve(self) -> None:
        if self._dir is not None:
            return
        if self.device_number is not None:
            d = os.path.join(self.base_dir, f"iio:device{int(self.device_number)}")
            if not os.path.isdir(d):
                raise ElementError(f"{self.name}: no such IIO device dir {d}")
            self._dir = d
        else:
            devices = scan_devices(self.base_dir)
            if not devices:
                raise ElementError(
                    f"{self.name}: no IIO devices under {self.base_dir}"
                )
            if self.iio_device is None:
                self._dir = next(iter(devices.values()))
            elif str(self.iio_device) in devices:
                self._dir = devices[str(self.iio_device)]
            else:
                raise ElementError(
                    f"{self.name}: IIO device {self.iio_device!r} not found; "
                    f"available: {sorted(devices)}"
                )
        if self.mode == "buffer":
            self._resolve_buffer_channels()
        else:
            found = sorted(
                m.group(1)
                for m in (_CHANNEL_RE.match(f) for f in os.listdir(self._dir))
                if m
            )
            if self._want_channels:
                missing = [c for c in self._want_channels if c not in found]
                if missing:
                    raise ElementError(
                        f"{self.name}: channels not found: {missing}"
                    )
                self._channels = list(self._want_channels)
            else:
                self._channels = found
        if not self._channels:
            raise ElementError(f"{self.name}: device has no capture channels")
        # per-channel scale/offset with device-wide fallback (IIO ABI)
        def per_channel(suffix: str, default: float) -> np.ndarray:
            dev_wide = _read(os.path.join(self._dir, f"in_{suffix}"))
            vals = []
            for c in self._channels:
                v = _read(os.path.join(self._dir, f"in_{c}_{suffix}"), dev_wide)
                vals.append(float(v) if v is not None else default)
            return np.asarray(vals, np.float32)

        self._scales = per_channel("scale", 1.0)
        self._offsets = per_channel("offset", 0.0)
        # push requested sampling frequency if the device exposes the knob
        freq_path = os.path.join(self._dir, "sampling_frequency")
        if os.path.isfile(freq_path) and os.access(freq_path, os.W_OK):
            try:
                with open(freq_path, "w") as f:
                    f.write(str(self.frequency))
            except OSError:
                pass

    def output_spec(self) -> Spec:
        self._resolve()
        rate = Fraction(self.frequency).limit_denominator(1000)
        return TensorsSpec.of(
            TensorSpec((1, len(self._channels)), DType.FLOAT32, name="iio"),
            rate=rate,
        )

    def _emit(self, raw: np.ndarray):
        data = ((raw + self._offsets) * self._scales).reshape(1, -1)
        pts = int(self._i * 1_000_000_000 / self.frequency)
        self._i += 1
        return Frame((data,), pts=pts,
                     duration=int(1_000_000_000 / self.frequency))

    def _generate_buffered(self):
        """Read one fixed-size record from the device node and decode it
        (the reference's poll()+read loop, gsttensor_srciio.c:2511)."""
        if self._fd is None:
            node = os.path.join(self.dev_dir, os.path.basename(self._dir))
            try:
                self._fd = os.open(node, os.O_RDONLY | os.O_NONBLOCK)
            except OSError as exc:
                raise ElementError(
                    f"{self.name}: cannot open IIO device node {node}: {exc}"
                )
        try:
            chunk = os.read(self._fd, self._record_size - len(self._pending))
        except BlockingIOError:
            chunk = b""
        if chunk:
            self._pending += chunk
        if len(self._pending) < self._record_size:
            if not chunk:
                time.sleep(0.01)  # bounded wait (reference poll timeout)
            return None
        rec, self._pending = (
            self._pending[: self._record_size],
            self._pending[self._record_size:],
        )
        raw = np.empty((len(self._channels),), np.float32)
        for j, (fmt, off) in enumerate(zip(self._formats, self._field_offsets)):
            word = int.from_bytes(
                rec[off : off + fmt.nbytes],
                "big" if fmt.big_endian else "little",
            )
            raw[j] = fmt.decode(np.asarray([word], np.uint64))[0]
        return self._emit(raw)

    def generate(self):
        if self.num_frames >= 0 and self._i >= self.num_frames:
            return EOS_FRAME
        if self.mode == "buffer":
            return self._generate_buffered()
        now = time.monotonic()
        if self._next_t is None:
            self._next_t = now
        if now < self._next_t:
            # bounded wait so the executor can stop us (reference poll timeout)
            time.sleep(min(self._next_t - now, 0.1))
            if time.monotonic() < self._next_t:
                return None
        self._next_t += 1.0 / self.frequency
        raw = np.empty((len(self._channels),), np.float32)
        for j, c in enumerate(self._channels):
            v = _read(os.path.join(self._dir, f"in_{c}_raw"), "0")
            try:
                raw[j] = float(v)
            except ValueError:
                raise ElementError(f"{self.name}: bad raw value {v!r} for {c}")
        return self._emit(raw)

    def stop(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        if self.mode == "buffer" and self._dir is not None:
            try:
                with open(os.path.join(self._dir, "buffer", "enable"), "w") as f:
                    f.write("0")
            except OSError:
                pass
