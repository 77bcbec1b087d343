"""Built-in model zoo: named (module, input spec) bundles for the native
backend (``model=zoo:<name>``).

The counterpart of ``nnstreamer_tpu/models/zoo.py`` for ``mobilenet_v2``,
``ssd_mobilenet_v2``, ``ssd_mobilenet_v2_pp``, ``yolov5``, ``posenet``,
``deeplab_v3``, ``face_detect``, ``face_landmark``, ``face_composite``,
``vit``, ``kws``, ``add`` and ``transformer_lm``. Options come from the filter's
``custom=`` string. Every vision model takes ``seed`` (a
``torch.Generator`` seed — these random weights are NOT the JAX
package's, whose generator differs), ``params:<path.npz>`` (leaves
``p{i}`` in the reference's tree-flatten order: the way to run the JAX
weights here), ``input_dtype`` and ``compute_dtype`` (float32 |
bfloat16), and:

- mobilenet_v2: ``size``, ``num_classes``, ``width``, ``batch``,
  ``quantize=int8|int8w`` (``models/quantize.py``; int8 calibrates on
  ``calib_batches`` seeded batches, default 2);
- ssd_mobilenet_v2: ``batch``, ``num_classes``;
- ssd_mobilenet_v2_pp (batch 1, 91 classes): ``max_out``, ``threshold``;
- yolov5: ``size`` (a multiple of 32, default 320), ``num_classes`` (80),
  ``width`` (32), ``batch``;
- posenet, deeplab_v3 (257 × 257): ``batch``;
- face_detect (batch 1, 128 × 128): ``output=ov|regions|regions+image``,
  ``threshold`` (0.5), ``frame_size=W:H`` (the regions' frame, default
  128:128), ``max_faces`` (16);
- face_landmark: ``batch``, ``size`` (112);
- face_composite (batch 1): ``size`` (128), ``threshold``, ``max_faces``;
  its ``params`` npz is the whole ``{"detect", "landmark"}`` tree, the
  detector's leaves first (an npz of the detector alone overlays it
  alone, as in the reference, which overlays the detector only);
- vit (ViT-S/16 at its defaults): ``num_classes`` (1001), ``d_model``
  (384), ``n_heads`` (6), ``n_layers`` (12), ``patch`` (16), ``size``
  (224; a multiple of ``patch``, else it raises), ``batch``;
- kws (int16 PCM ``(samples, channels)`` at batch 1, else ``(batch,
  samples, channels)``): ``samples`` (1024), ``channels`` (1),
  ``num_classes`` (12), ``width`` (32), ``batch``; its ``input_dtype`` is
  int16, so it takes no ``input_dtype`` option;
- add: ``const``, ``dims``;
- transformer_lm: ``seed``, ``vocab``, ``d_model``, ``n_heads``,
  ``n_layers``, ``n_kv_heads``, ``d_ff`` (the FFN width, default
  4 × d_model; the reference's zoo has no such option, so a serving
  pipeline can run a published config such as Mistral-7B's 14336),
  ``batch``, ``seqlen``, ``params``,
  ``compute_dtype`` (float32 | bfloat16 | float16), ``attn=dense|flash``
  (flash: the flash-attention kernel K5 on the no-cache forward, in every
  compute dtype, where the reference degrades float16 to dense attention;
  with ``generate`` it is accepted and unused, as in the reference),
  ``quantize=int8w`` (weight-only int8, ``models/quantize.py``; any other
  value raises, where the reference ignores it),
  ``generate`` (> 0: prompt tokens in, generated tokens out),
  ``decode=greedy|beam|ngram``, ``temperature``, ``gen_seed``,
  ``beam_width``, ``spec_k`` and ``spec_ngram`` (``decode=ngram``: the
  chunk width and the n-gram the lookup matches).

An unknown option raises: quietly ignoring, say, ``quantize:int8`` would
serve a different model than the one asked for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn

from nnstreamer_tpu_torch.device import DeviceLike, resolve_device
from nnstreamer_tpu_torch.models import decode as dec
from nnstreamer_tpu_torch.models import audio, deeplab_v3, posenet, ssd_mobilenet, vit, yolo
from nnstreamer_tpu_torch.models import face_pipeline as fp
from nnstreamer_tpu_torch.models import quantize as qz
from nnstreamer_tpu_torch.models import transformer as tfm
from nnstreamer_tpu_torch.models.jax_weights import (
    BIASED,
    CONV_BN,
    load_npz,
    load_transformer_npz,
    load_vit_npz,
    tree_paths,
)
from nnstreamer_tpu_torch.models.nn import compute_dtype_of
from nnstreamer_tpu_torch.models.mobilenet_v2 import (  # noqa: F401
    MobileNetV2,
    load_jax_npz,
    mobilenet_v2_from_jax,
)
from nnstreamer_tpu_torch.ops.kernels.flash_attention import make_flash_attention
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


@dataclass
class ZooModel:
    name: str
    module: nn.Module  # (*tensors) -> tensor | tuple, on ``device``
    input_spec: TensorsSpec
    device: torch.device
    params: Optional[nn.Module] = None  # the weights, where a caller needs them (LMs)


_FACTORIES: Dict[str, Callable[..., ZooModel]] = {}
_OPTIONS: Dict[str, tuple] = {}


def model_factory(name: str, options: tuple):
    def deco(fn):
        _FACTORIES[name] = fn
        _OPTIONS[name] = options
        return fn

    return deco


def get(name: str, device: DeviceLike = None, **options: str) -> ZooModel:
    """Build zoo model ``name`` on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``)."""
    if name not in _FACTORIES:
        raise KeyError(f"unknown zoo model {name!r}; known: {sorted(_FACTORIES)}")
    unknown = sorted(set(options) - set(_OPTIONS[name]))
    if unknown:
        raise ValueError(
            f"zoo:{name}: unsupported option(s) {unknown}; "
            f"this port takes {sorted(_OPTIONS[name])}"
        )
    dev = resolve_device(device)
    return _FACTORIES[name](dev, **options)


def available():
    return sorted(_FACTORIES)


class _Add(nn.Module):
    def __init__(self, const: float) -> None:
        super().__init__()
        self.const = const

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + torch.full((), self.const, dtype=x.dtype, device=x.device)


@model_factory("add", ("const", "dims"))
def _add(device: torch.device, **options) -> ZooModel:
    """y = x + const (the reference's add.tflite test model)."""
    const = float(options.get("const", 2.0))
    spec = TensorsSpec.of(
        TensorSpec.from_dim_string(options.get("dims", "1"), "float32")
    )
    return ZooModel("add", _Add(const).to(device), spec, device)


_VISION = ("seed", "params", "input_dtype", "compute_dtype")


def _generator(options) -> torch.Generator:
    return torch.Generator().manual_seed(int(options.get("seed", 0)))


def _load(model: nn.Module, options, paths) -> nn.Module:
    if options.get("params"):
        load_npz(model, options["params"], paths)
    return model


def _on(model: nn.Module, device: torch.device, options) -> nn.Module:
    """float32 weights → eval mode on ``device`` in the compute dtype,
    activations in ``channels_last`` memory (the reference's NHWC)."""
    dtype = compute_dtype_of(options.get("compute_dtype", "float32"))
    return model.eval().to(device=device, dtype=dtype, memory_format=torch.channels_last)


@model_factory(
    "mobilenet_v2",
    _VISION + ("num_classes", "width", "batch", "size", "quantize", "calib_batches"),
)
def _mobilenet_v2(device: torch.device, **options) -> ZooModel:
    model = MobileNetV2(
        num_classes=int(options.get("num_classes", 1001)),
        width=float(options.get("width", 1.0)),
        generator=_generator(options),
    )
    if options.get("params"):
        load_jax_npz(model, options["params"])
    batch, size = int(options.get("batch", 1)), int(options.get("size", 224))
    quantize = options.get("quantize", "")
    if quantize not in ("", "int8", "int8w"):
        raise ValueError(f"zoo:mobilenet_v2: quantize {quantize!r} (int8 | int8w)")
    if "calib_batches" in options and quantize != "int8":
        raise ValueError("zoo:mobilenet_v2: calib_batches goes with quantize:int8")
    if quantize:
        dtype = compute_dtype_of(options.get("compute_dtype", "float32"))
        folded = qz.fold_mobilenet(model.eval())
        if quantize == "int8":
            calib = qz.calibration_batches(int(options.get("seed", 0)),
                                           int(options.get("calib_batches", 2)), batch, size)
            scales = qz.calibrate_mobilenet(folded, (torch.from_numpy(c) for c in calib))
            model = qz.quantize_mobilenet(folded, scales, dtype)
        else:
            model = qz.quantize_mobilenet_weights(folded, dtype)
        model = model.eval().to(device=device)
    else:
        model = _on(model, device, options)
    spec = _image_spec(batch, size, options.get("input_dtype", "uint8"))
    return ZooModel("mobilenet_v2", model, spec, device)


def _image_spec(batch: int, size: int, in_dtype: str) -> TensorsSpec:
    return TensorsSpec.of(
        TensorSpec((batch, size, size, 3), DType.from_any(in_dtype), name="image")
    )


def _ssd(options, num_classes: int) -> ssd_mobilenet.SSDMobileNetV2:
    model = ssd_mobilenet.SSDMobileNetV2(num_classes=num_classes, generator=_generator(options))
    if options.get("params"):
        ssd_mobilenet.load_jax_npz(model, options["params"])
    return model


@model_factory("ssd_mobilenet_v2", _VISION + ("batch", "num_classes"))
def _ssd_mobilenet_v2(device: torch.device, **options) -> ZooModel:
    """Raw two-tensor SSD (locations + class logits) for the decoder's
    mobilenet-ssd mode; the analogue of ssd_mobilenet_v2_coco.tflite."""
    num_classes = int(options.get("num_classes", ssd_mobilenet.NUM_CLASSES))
    model = _on(_ssd(options, num_classes), device, options)
    spec = _image_spec(
        int(options.get("batch", 1)), ssd_mobilenet.INPUT_SIZE,
        options.get("input_dtype", "uint8"),
    )
    return ZooModel("ssd_mobilenet_v2", model, spec, device)


@model_factory("ssd_mobilenet_v2_pp", _VISION + ("max_out", "threshold"))
def _ssd_mobilenet_v2_pp(device: torch.device, **options) -> ZooModel:
    """SSD + on-device decode and NMS → the TFLite detection-postprocess
    4-tensor layout (decoder mode=mobilenet-ssd-postprocess). Batch 1."""
    model = ssd_mobilenet.SSDMobileNetV2PP(
        _on(_ssd(options, ssd_mobilenet.NUM_CLASSES), device, options),
        max_out=int(options.get("max_out", 10)),
        threshold=float(options.get("threshold", 0.001)),
    )
    model = model.eval().to(device=device)  # the priors stay float32
    spec = _image_spec(1, ssd_mobilenet.INPUT_SIZE, options.get("input_dtype", "uint8"))
    return ZooModel("ssd_mobilenet_v2_pp", model, spec, device)


@model_factory("yolov5", _VISION + ("batch", "size", "num_classes", "width"))
def _yolov5(device: torch.device, **options) -> ZooModel:
    """YOLOv5-style detector (models/yolo.py): [B, S, S, 3] → decoded
    [B, rows, 5 + C] predictions for the decoder's yolov5 mode."""
    size = int(options.get("size", 320))
    if size % 32:
        raise ValueError(f"yolov5 size must be a multiple of 32, got {size}")
    model = yolo.YOLOv5(num_classes=int(options.get("num_classes", 80)),
                        width=int(options.get("width", 32)), generator=_generator(options))
    model = _on(_load(model, options, yolo.jax_leaf_paths()), device, options)
    spec = _image_spec(int(options.get("batch", 1)), size, options.get("input_dtype", "uint8"))
    return ZooModel("yolov5", model, spec, device)


@model_factory("posenet", _VISION + ("batch",))
def _posenet(device: torch.device, **options) -> ZooModel:
    """PoseNet MobileNet-v1 257x257 (heatmap, offsets, displacements) for
    the pose_estimation decoder."""
    model = posenet.PoseNet(generator=_generator(options))
    model = _on(_load(model, options, posenet.jax_leaf_paths()), device, options)
    spec = _image_spec(int(options.get("batch", 1)), posenet.INPUT_SIZE,
                       options.get("input_dtype", "uint8"))
    return ZooModel("posenet", model, spec, device)


@model_factory("deeplab_v3", _VISION + ("batch",))
def _deeplab_v3(device: torch.device, **options) -> ZooModel:
    """DeepLab-v3 MobileNet-v2 257x257x21 for the image_segment decoder
    (tflite-deeplab)."""
    model = deeplab_v3.DeepLabV3(generator=_generator(options))
    model = _on(_load(model, options, deeplab_v3.jax_leaf_paths()), device, options)
    spec = _image_spec(int(options.get("batch", 1)), deeplab_v3.INPUT_SIZE,
                       options.get("input_dtype", "uint8"))
    return ZooModel("deeplab_v3", model, spec, device)


_FACE_OUTPUTS = ("ov", "regions", "regions+image", "regions_image")


@model_factory("face_detect",
               _VISION + ("max_faces", "output", "threshold", "frame_size"))
def _face_detect(device: torch.device, **options) -> ZooModel:
    """Face detector: [max_faces, 7] OV rows (output=ov, the default), int32
    [max_faces, 4] pixel regions of a ``frame_size`` frame
    (output=regions), or (image, regions) (output=regions+image). Any
    other output raises (the reference serves OV rows for it)."""
    out_mode = options.get("output", "ov")
    if out_mode not in _FACE_OUTPUTS:
        raise ValueError(f"zoo:face_detect: output {out_mode!r} ({' | '.join(_FACE_OUTPUTS)})")
    fw, fh = (int(v) for v in options.get(
        "frame_size", f"{fp.DETECT_SIZE}:{fp.DETECT_SIZE}").split(":"))
    detect = fp.FaceDetect(int(options.get("max_faces", fp.MAX_FACES)), _generator(options))
    model = _load(detect, options, fp.detect_leaf_paths())
    if out_mode != "ov":
        model = fp.DetectRegions(detect, fw, fh, float(options.get("threshold", 0.5)),
                                 with_image=out_mode != "regions")
    model = _on(model, device, options)
    spec = _image_spec(1, fp.DETECT_SIZE, options.get("input_dtype", "uint8"))
    return ZooModel("face_detect", model, spec, device)


@model_factory("face_landmark", _VISION + ("batch", "size"))
def _face_landmark(device: torch.device, **options) -> ZooModel:
    """68-point landmark net on face crops (global-pooled trunk, so any
    crop size >= 16 works; the spec advertises the canonical 112)."""
    model = fp.FaceLandmark(generator=_generator(options))
    model = _on(_load(model, options, fp.landmark_leaf_paths()), device, options)
    spec = _image_spec(int(options.get("batch", 1)), int(options.get("size", fp.LANDMARK_SIZE)),
                       options.get("input_dtype", "uint8"))
    return ZooModel("face_landmark", model, spec, device)


@model_factory("face_composite", _VISION + ("max_faces", "threshold", "size"))
def _face_composite(device: torch.device, **options) -> ZooModel:
    """detect → crop+resize (K1's crop entry) → landmark on the device:
    uint8 [1, S, S, 3] → (landmarks [max, 136], detections [max, 7])."""
    gen = _generator(options)
    model = fp.FaceComposite(
        fp.FaceDetect(int(options.get("max_faces", fp.MAX_FACES)), gen),
        fp.FaceLandmark(generator=gen),
        threshold=float(options.get("threshold", 0.5)),
    )
    model = _on(_load(model, options, fp.composite_leaf_paths()), device, options)
    spec = _image_spec(1, int(options.get("size", fp.DETECT_SIZE)),
                       options.get("input_dtype", "uint8"))
    return ZooModel("face_composite", model, spec, device)


@model_factory("vit", _VISION + ("num_classes", "d_model", "n_heads", "n_layers", "patch",
                                  "batch", "size"))
def _vit(device: torch.device, **options) -> ZooModel:
    """Vision Transformer classifier (models/vit.py): patch embedding and a
    non-causal encoder stack → image-labeling logits."""
    patch = int(options.get("patch", vit.PATCH))
    size = int(options.get("size", vit.INPUT_SIZE))
    model = vit.ViT(
        num_classes=int(options.get("num_classes", 1001)),
        d_model=int(options.get("d_model", 384)), n_heads=int(options.get("n_heads", 6)),
        n_layers=int(options.get("n_layers", 12)), patch=patch, size=size,
        generator=_generator(options),
    )
    if options.get("params"):
        load_vit_npz(model, options["params"])
    model = _on(model, device, options)
    spec = _image_spec(int(options.get("batch", 1)), size, options.get("input_dtype", "uint8"))
    return ZooModel("vit", model, spec, device)


def kws_leaf_paths():
    """The reference keyword-spotting tree's leaf paths in flatten order."""
    return tree_paths({"stem": CONV_BN, "c2": CONV_BN, "c3": CONV_BN, "c4": CONV_BN,
                       "head": BIASED})


@model_factory("kws", ("seed", "params", "compute_dtype", "batch", "samples", "channels",
                       "num_classes", "width"))
def _kws(device: torch.device, **options) -> ZooModel:
    """Keyword-spotting raw-waveform classifier (models/audio.py, an M5-style
    conv net): the converter's audio tensor [samples, channels] S16LE, or
    batched [B, samples, C] → logits [B, num_classes]."""
    batch = int(options.get("batch", 1))
    samples = int(options.get("samples", 1024))
    channels = int(options.get("channels", 1))
    model = audio.KWS(num_classes=int(options.get("num_classes", 12)),
                      width=int(options.get("width", 32)), generator=_generator(options))
    model = _on(_load(model, options, kws_leaf_paths()), device, options)
    shape = (samples, channels) if batch == 1 else (batch, samples, channels)
    spec = TensorsSpec.of(TensorSpec(shape, DType.INT16, name="pcm"))
    return ZooModel("kws", model, spec, device)


class _LMApply(nn.Module):
    """tokens [B, T] → logits [B, T, vocab] float32 (``attn_fn`` None: dense
    attention)."""

    def __init__(self, lm: tfm.TransformerLM, n_heads: int, compute_dtype: torch.dtype,
                 attn_fn: Optional[Callable] = None) -> None:
        super().__init__()
        self.lm, self.n_heads, self.compute_dtype = lm, n_heads, compute_dtype
        self.attn_fn = attn_fn

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return tfm.apply(self.lm, tokens, self.n_heads, attn_fn=self.attn_fn,
                         compute_dtype=self.compute_dtype)


class _LMGenerate(nn.Module):
    """prompt tokens [B, T] → generated tokens [B, n_new] int32 (greedy, or
    sampled at ``temperature`` from a generator seeded ``gen_seed`` anew
    for each call)."""

    CAPTURABLE = False  # a generator made anew each call, sampling on it

    def __init__(self, lm: tfm.TransformerLM, n_heads: int, n_new: int, temperature: float,
                 gen_seed: int, compute_dtype: torch.dtype) -> None:
        super().__init__()
        self.lm, self.n_heads, self.n_new = lm, n_heads, n_new
        self.temperature, self.gen_seed, self.compute_dtype = temperature, gen_seed, compute_dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        rng = torch.Generator(device=tokens.device).manual_seed(self.gen_seed)
        return dec.generate(self.lm, tokens, self.n_heads, self.n_new,
                            temperature=self.temperature, rng=rng,
                            compute_dtype=self.compute_dtype)


class _LMBeam(nn.Module):
    """prompt tokens [1, T] → the best beam's tokens [1, n_new] int32."""

    CAPTURABLE = False  # the best beam is traced back on the host

    def __init__(self, lm: tfm.TransformerLM, n_heads: int, n_new: int, beam_width: int,
                 compute_dtype: torch.dtype) -> None:
        super().__init__()
        self.lm, self.n_heads, self.n_new = lm, n_heads, n_new
        self.beam_width, self.compute_dtype = beam_width, compute_dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        toks, _ = dec.beam_search(self.lm, tokens, self.n_heads, self.n_new,
                                  beam_width=self.beam_width, compute_dtype=self.compute_dtype)
        return toks


class _LMNgram(nn.Module):
    """prompt tokens [1, T] → generated tokens [1, n_new] int32 by n-gram
    speculation (``speculative.ngram_generate_scanned``): the target's
    greedy stream."""

    CAPTURABLE = False  # the rounds' loop condition is read on the host

    def __init__(self, lm: tfm.TransformerLM, n_heads: int, n_new: int, k: int, g: int,
                 compute_dtype: torch.dtype) -> None:
        super().__init__()
        self.lm, self.n_heads, self.n_new = lm, n_heads, n_new
        self.k, self.g, self.compute_dtype = k, g, compute_dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        from nnstreamer_tpu_torch.models.speculative import ngram_generate_scanned

        toks, _ = ngram_generate_scanned(self.lm, tokens, self.n_heads, self.n_new, k=self.k,
                                         g=self.g, compute_dtype=self.compute_dtype)
        return toks


_LM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@model_factory(
    "transformer_lm",
    ("seed", "vocab", "d_model", "n_heads", "n_layers", "n_kv_heads", "d_ff", "batch", "seqlen",
     "params", "compute_dtype", "generate", "decode", "temperature", "gen_seed", "attn",
     "quantize", "beam_width", "spec_k", "spec_ngram"),
)
def _transformer_lm(device: torch.device, **options) -> ZooModel:
    """Decoder-only transformer LM (models/transformer.py): tokens [B, T]
    int32 → logits [B, T, vocab], or with ``generate`` > 0 prompt tokens →
    generated tokens. ``params`` is the :class:`TransformerLM` itself (the
    weights a serving batcher takes), quantized in place by
    ``quantize=int8w``."""
    attn_kind = options.get("attn", "dense")
    if attn_kind not in ("dense", "flash"):
        raise KeyError(f"transformer_lm: unknown attn {attn_kind!r}")
    quantize = options.get("quantize")
    if quantize not in (None, "", "int8w"):
        raise ValueError(f"zoo:transformer_lm: quantize {quantize!r} (int8w only)")
    compute = options.get("compute_dtype", "float32")
    if compute not in _LM_DTYPES:
        raise ValueError(
            f"zoo:transformer_lm: compute_dtype {compute!r} (float32 | bfloat16 | float16)"
        )
    dtype = _LM_DTYPES[compute]
    n_heads = int(options.get("n_heads", 8))
    gen = torch.Generator(device=device).manual_seed(int(options.get("seed", 0)))
    lm = tfm.init_params(
        gen, int(options.get("vocab", 1024)), int(options.get("d_model", 256)), n_heads,
        int(options.get("n_layers", 4)), n_kv_heads=int(options.get("n_kv_heads", n_heads)),
        d_ff=int(options["d_ff"]) if options.get("d_ff") else None, device=device,
    )
    if options.get("params"):
        load_transformer_npz(lm, options["params"])
    if quantize == "int8w":
        qz.quantize_lm_weights(lm)
    gen_tokens = int(options.get("generate", 0))
    if gen_tokens > 0:
        strategy = options.get("decode", "greedy")
        if strategy == "ngram":
            module = _LMNgram(lm, n_heads, gen_tokens, int(options.get("spec_k", 4)),
                              int(options.get("spec_ngram", 2)), dtype)
        elif strategy == "beam":
            module = _LMBeam(lm, n_heads, gen_tokens, int(options.get("beam_width", 4)), dtype)
        elif strategy == "greedy":
            module = _LMGenerate(lm, n_heads, gen_tokens,
                                 float(options.get("temperature", 0.0)),
                                 int(options.get("gen_seed", 0)), dtype)
        else:
            raise KeyError(
                f"transformer_lm: unknown decode strategy {strategy!r} (greedy|beam|ngram)"
            )
    else:
        attn_fn = make_flash_attention() if attn_kind == "flash" else None
        module = _LMApply(lm, n_heads, dtype, attn_fn)
    spec = TensorsSpec.of(
        TensorSpec((int(options.get("batch", 1)), int(options.get("seqlen", 128))),
                   DType.from_any("int32"), name="tokens")
    )
    return ZooModel("transformer_lm", module.eval(), spec, device, params=lm)
