"""Single-shot invoke API: open a model, invoke it, no pipeline.

The counterpart of ``nnstreamer_tpu/single.py`` (reference
tensor_filter_single.c, the ML C-API's ml_single_invoke):

    SingleShot(framework=, model=, ...)  → open() / context-manager enter
    SingleShot.invoke(...)               → outputs as torch tensors
    SingleShot.set_input_info(spec)      → the output spec for a new input
    SingleShot.reload_model(model)       → model swap
    SingleShot.close()

The model runs on ``device`` (default ``cuda``; without a GPU it raises
unless ``device="cpu"``). Inputs may be numpy arrays or tensors anywhere:
they are moved to the device (pinned, ``non_blocking``) before the invoke.
``accelerator`` is accepted as the reference accepts it (the device is
``device``); its ``mesh=`` clause (``true:gpu:mesh=dp2``) runs the model
over a device mesh in the torch backend, as the filter's does;
``**options`` ride in the backend's ``FilterProps.options``.
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
        output_spec: Optional[TensorsSpec] = None,
        custom: str = "",
        accelerator: str = "",
        device: DeviceLike = None,
        **options: str,
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
            output_spec=output_spec,
            custom=custom,
            accelerator=accelerator,
            device=self.device,
            options=dict(options),
        )
        self._backend: Optional[Backend] = None

    @property
    def backend(self) -> Backend:
        if self._backend is None:
            raise BackendError("SingleShot not opened")
        return self._backend

    @property
    def is_open(self) -> bool:
        return self._backend is not None

    def open(self) -> "SingleShot":
        if self._backend is not None:
            return self
        cls = registry.get(registry.KIND_FILTER, self.props.framework)
        backend: Backend = cls()
        backend.open(self.props)
        if self.props.input_spec is not None:
            try:
                cur_in, _ = backend.get_model_info()
                need_set = not cur_in.is_compatible(self.props.input_spec)
            except BackendError:
                need_set = True  # the spec is known only once set
            if need_set:
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

    def set_input_info(self, spec: TensorsSpec) -> TensorsSpec:
        """Renegotiate the model for ``spec`` → its output spec."""
        return self.backend.set_input_info(spec)

    def invoke(self, *tensors: Any) -> Union[Tuple[torch.Tensor, ...], Frame]:
        """Invoke on arrays or tensors; returns a tuple of output tensors
        on the device (they may still be computing: reading them waits).
        A single :class:`Frame` argument is unwrapped, and the outputs come
        back as a Frame with its metadata."""
        if len(tensors) == 1 and isinstance(tensors[0], Frame):
            frame = tensors[0]
            with torch.inference_mode():
                out = self.backend.invoke_timed(frame.to_device(self.device).tensors)
            return frame.with_tensors(tuple(out))
        frame = Frame(tensors).to_device(self.device)
        with torch.inference_mode():
            return tuple(self.backend.invoke_timed(frame.tensors))

    def reload_model(self, model: Union[str, Sequence[str]]) -> None:
        """Model swap (the reference's is-updatable / RELOAD_MODEL)."""
        models = (model,) if isinstance(model, str) else tuple(model)
        self.backend.reload(models)

    @property
    def latency_us(self) -> float:
        return self.backend.stats.latency_us

    @property
    def throughput_fps(self) -> float:
        return self.backend.stats.throughput_fps
