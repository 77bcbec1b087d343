"""Built-in model zoo: named (module, input spec) bundles for the native
backend (``model=zoo:<name>``).

The counterpart of ``nnstreamer_tpu/models/zoo.py`` for ``mobilenet_v2``,
``ssd_mobilenet_v2``, ``ssd_mobilenet_v2_pp``, ``add`` and
``transformer_lm``. Options come
from the filter's ``custom=`` string:

- mobilenet_v2: ``size``, ``num_classes``, ``width``, ``batch``,
  ``input_dtype``, ``seed`` (a ``torch.Generator`` seed — these random
  weights are NOT the JAX package's, whose generator differs) and
  ``params:<path.npz>`` (leaves ``p{i}`` in the reference's tree-flatten
  order: the way to run the JAX weights here);
- ssd_mobilenet_v2: ``seed``, ``batch``, ``num_classes``, ``input_dtype``,
  ``params``, ``compute_dtype`` (float32 only: bfloat16 is not ported yet);
- ssd_mobilenet_v2_pp (batch 1, 91 classes): ``seed``, ``max_out``,
  ``threshold``, ``input_dtype``, ``params``, ``compute_dtype``;
- add: ``const``, ``dims``;
- transformer_lm: ``seed``, ``vocab``, ``d_model``, ``n_heads``,
  ``n_layers``, ``n_kv_heads``, ``batch``, ``seqlen``, ``params``,
  ``compute_dtype`` (float32 | bfloat16), ``generate`` (> 0: prompt
  tokens in, generated tokens out), ``decode=greedy``, ``temperature``,
  ``gen_seed``; ``attn=dense``. Not ported yet, and raising:
  ``attn=flash`` (kernel K5), ``quantize=int8w``, ``decode=beam|ngram``.

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
from nnstreamer_tpu_torch.models import ssd_mobilenet
from nnstreamer_tpu_torch.models import transformer as tfm
from nnstreamer_tpu_torch.models.jax_weights import load_transformer_npz
from nnstreamer_tpu_torch.models.mobilenet_v2 import (  # noqa: F401
    MobileNetV2,
    load_jax_npz,
    mobilenet_v2_from_jax,
)
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


@model_factory(
    "mobilenet_v2",
    ("seed", "num_classes", "width", "batch", "size", "input_dtype", "params"),
)
def _mobilenet_v2(device: torch.device, **options) -> ZooModel:
    gen = torch.Generator().manual_seed(int(options.get("seed", 0)))
    model = MobileNetV2(
        num_classes=int(options.get("num_classes", 1001)),
        width=float(options.get("width", 1.0)),
        generator=gen,
    )
    if options.get("params"):
        load_jax_npz(model, options["params"])
    model = model.eval().to(device=device, memory_format=torch.channels_last)
    spec = _image_spec(
        int(options.get("batch", 1)), int(options.get("size", 224)),
        options.get("input_dtype", "uint8"),
    )
    return ZooModel("mobilenet_v2", model, spec, device)


def _image_spec(batch: int, size: int, in_dtype: str) -> TensorsSpec:
    return TensorsSpec.of(
        TensorSpec((batch, size, size, 3), DType.from_any(in_dtype), name="image")
    )


def _check_float32(name: str, options) -> None:
    compute = options.get("compute_dtype", "float32")
    if compute != "float32":
        raise ValueError(
            f"zoo:{name}: compute_dtype {compute!r} is not ported yet (float32 only)"
        )


def _ssd(options, num_classes: int) -> ssd_mobilenet.SSDMobileNetV2:
    gen = torch.Generator().manual_seed(int(options.get("seed", 0)))
    model = ssd_mobilenet.SSDMobileNetV2(num_classes=num_classes, generator=gen)
    if options.get("params"):
        ssd_mobilenet.load_jax_npz(model, options["params"])
    return model


@model_factory(
    "ssd_mobilenet_v2",
    ("seed", "batch", "num_classes", "input_dtype", "params", "compute_dtype"),
)
def _ssd_mobilenet_v2(device: torch.device, **options) -> ZooModel:
    """Raw two-tensor SSD (locations + class logits) for the decoder's
    mobilenet-ssd mode; the analogue of ssd_mobilenet_v2_coco.tflite."""
    _check_float32("ssd_mobilenet_v2", options)
    num_classes = int(options.get("num_classes", ssd_mobilenet.NUM_CLASSES))
    model = _ssd(options, num_classes)
    model = model.eval().to(device=device, memory_format=torch.channels_last)
    spec = _image_spec(
        int(options.get("batch", 1)), ssd_mobilenet.INPUT_SIZE,
        options.get("input_dtype", "uint8"),
    )
    return ZooModel("ssd_mobilenet_v2", model, spec, device)


@model_factory(
    "ssd_mobilenet_v2_pp",
    ("seed", "max_out", "threshold", "input_dtype", "params", "compute_dtype"),
)
def _ssd_mobilenet_v2_pp(device: torch.device, **options) -> ZooModel:
    """SSD + on-device decode and NMS → the TFLite detection-postprocess
    4-tensor layout (decoder mode=mobilenet-ssd-postprocess). Batch 1."""
    _check_float32("ssd_mobilenet_v2_pp", options)
    model = ssd_mobilenet.SSDMobileNetV2PP(
        _ssd(options, ssd_mobilenet.NUM_CLASSES),
        max_out=int(options.get("max_out", 10)),
        threshold=float(options.get("threshold", 0.001)),
    )
    model = model.eval().to(device=device, memory_format=torch.channels_last)
    spec = _image_spec(1, ssd_mobilenet.INPUT_SIZE, options.get("input_dtype", "uint8"))
    return ZooModel("ssd_mobilenet_v2_pp", model, spec, device)


class _LMApply(nn.Module):
    """tokens [B, T] → logits [B, T, vocab] float32."""

    def __init__(self, lm: tfm.TransformerLM, n_heads: int, compute_dtype: torch.dtype) -> None:
        super().__init__()
        self.lm, self.n_heads, self.compute_dtype = lm, n_heads, compute_dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return tfm.apply(self.lm, tokens, self.n_heads, compute_dtype=self.compute_dtype)


class _LMGenerate(nn.Module):
    """prompt tokens [B, T] → generated tokens [B, n_new] int32 (greedy, or
    sampled at ``temperature`` from a generator seeded ``gen_seed`` anew
    for each call)."""

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


_LM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@model_factory(
    "transformer_lm",
    ("seed", "vocab", "d_model", "n_heads", "n_layers", "n_kv_heads", "batch", "seqlen",
     "params", "compute_dtype", "generate", "decode", "temperature", "gen_seed", "attn",
     "quantize"),
)
def _transformer_lm(device: torch.device, **options) -> ZooModel:
    """Decoder-only transformer LM (models/transformer.py): tokens [B, T]
    int32 → logits [B, T, vocab], or with ``generate`` > 0 prompt tokens →
    generated tokens. ``params`` is the :class:`TransformerLM` itself (the
    weights a serving batcher takes)."""
    if options.get("attn", "dense") != "dense":
        if options["attn"] == "flash":
            raise NotImplementedError(
                "zoo:transformer_lm attn=flash (the flash-attention kernel K5) is not ported yet"
            )
        raise KeyError(f"transformer_lm: unknown attn {options['attn']!r}")
    if options.get("quantize"):
        raise NotImplementedError(
            f"zoo:transformer_lm quantize={options['quantize']} (models/quantize.py) "
            "is not ported yet"
        )
    compute = options.get("compute_dtype", "float32")
    if compute not in _LM_DTYPES:
        raise ValueError(f"zoo:transformer_lm: compute_dtype {compute!r} (float32 | bfloat16)")
    dtype = _LM_DTYPES[compute]
    n_heads = int(options.get("n_heads", 8))
    gen = torch.Generator(device=device).manual_seed(int(options.get("seed", 0)))
    lm = tfm.init_params(
        gen, int(options.get("vocab", 1024)), int(options.get("d_model", 256)), n_heads,
        int(options.get("n_layers", 4)), n_kv_heads=int(options.get("n_kv_heads", n_heads)),
        device=device,
    )
    if options.get("params"):
        load_transformer_npz(lm, options["params"])
    gen_tokens = int(options.get("generate", 0))
    if gen_tokens > 0:
        strategy = options.get("decode", "greedy")
        if strategy in ("beam", "ngram"):
            raise NotImplementedError(
                f"zoo:transformer_lm decode={strategy} is not ported yet (greedy only)"
            )
        if strategy != "greedy":
            raise KeyError(
                f"transformer_lm: unknown decode strategy {strategy!r} (greedy|beam|ngram)"
            )
        module = _LMGenerate(lm, n_heads, gen_tokens, float(options.get("temperature", 0.0)),
                             int(options.get("gen_seed", 0)), dtype)
    else:
        module = _LMApply(lm, n_heads, dtype)
    spec = TensorsSpec.of(
        TensorSpec((int(options.get("batch", 1)), int(options.get("seqlen", 128))),
                   DType.from_any("int32"), name="tokens")
    )
    return ZooModel("transformer_lm", module.eval(), spec, device, params=lm)
