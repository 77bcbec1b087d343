"""Single-shot invoke API: open a model, invoke it, no pipeline.

The counterpart of ``nnstreamer_tpu/single.py`` (reference
tensor_filter_single.c, the ML C-API's ml_single_invoke):

    SingleShot(framework=, model=, ...)  → open() / context-manager enter
    SingleShot.invoke(...)               → outputs as torch tensors
    SingleShot.close()

The model runs on ``device`` (default ``cuda``; without a GPU it raises
unless ``device="cpu"``). Inputs may be numpy arrays or tensors anywhere:
they are moved to the device (pinned, ``non_blocking``) before the invoke.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps
from nnstreamer_tpu_torch.device import DeviceLike, resolve_device
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


class SingleShot:
    """Open → invoke → close.

    >>> with SingleShot(framework="torch", model="zoo:mobilenet_v2",
    ...                 device="cpu") as s:
    ...     (logits,) = s.invoke(np.zeros((1, 224, 224, 3), np.uint8))
    """

    def __init__(
        self,
        framework: str = "auto",
        model: Union[str, Sequence[str]] = (),
        input_spec: Optional[TensorsSpec] = None,
        custom: str = "",
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        models = (model,) if isinstance(model, str) else tuple(model)
        models = tuple(m for m in models if m)
        if framework == "auto":
            detected = registry.detect_filter_framework(models[0]) if models else None
            if detected is None:
                raise BackendError(
                    f"cannot auto-detect framework for model {models[:1]}"
                )
            framework = detected
        self.props = FilterProps(
            framework=framework,
            model=models,
            input_spec=input_spec,
            custom=custom,
            device=self.device,
        )
        self._backend: Optional[Backend] = None

    @property
    def backend(self) -> Backend:
        if self._backend is None:
            raise BackendError("SingleShot not opened")
        return self._backend

    def open(self) -> "SingleShot":
        if self._backend is not None:
            return self
        cls = registry.get(registry.KIND_FILTER, self.props.framework)
        backend: Backend = cls()
        backend.open(self.props)
        if self.props.input_spec is not None:
            cur_in, _ = backend.get_model_info()
            if not cur_in.is_compatible(self.props.input_spec):
                backend.set_input_info(self.props.input_spec)
        self._backend = backend
        return self

    def close(self) -> None:
        if self._backend is not None:
            self._backend.close()
            self._backend = None

    def __enter__(self) -> "SingleShot":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def input_spec(self) -> TensorsSpec:
        return self.backend.get_model_info()[0]

    @property
    def output_spec(self) -> TensorsSpec:
        return self.backend.get_model_info()[1]

    def invoke(self, *tensors: Any) -> Tuple[torch.Tensor, ...]:
        """Invoke on arrays or tensors; returns a tuple of output tensors
        on the device (they may still be computing: reading them waits)."""
        frame = Frame(tensors).to_device(self.device)
        with torch.inference_mode():
            return tuple(self.backend.invoke_timed(frame.tensors))

    @property
    def latency_us(self) -> float:
        return self.backend.stats.latency_us
