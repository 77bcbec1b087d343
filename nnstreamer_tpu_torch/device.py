"""Device selection for every entry point of the port.

The port runs on ``cuda`` unless the caller asks for the CPU by name.
Without a GPU, a call that did not ask for the CPU raises: a pipeline that
quietly ran on the host would report host numbers as the card's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


class NoDeviceError(RuntimeError):
    """CUDA was asked for (explicitly or by default) but is unavailable."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a GPU raises
    :class:`NoDeviceError`; ``"cpu"`` is honoured as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the CLI) to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev


def is_fake(t) -> bool:
    """True for a tensor of a fake-tensor trace (the analyzers' program
    traces, analysis/costmodel.py ``trace_program``): a cache of constants
    keeps no such tensor, or a later real run would compute with it."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)
