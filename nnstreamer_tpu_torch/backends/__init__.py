"""Filter backends. Importing this package registers the built-in ones."""

from nnstreamer_tpu_torch.backends.base import (  # noqa: F401
    Backend,
    BackendError,
    FilterProps,
)
from nnstreamer_tpu_torch.backends import custom  # noqa: F401  (registers)
from nnstreamer_tpu_torch.backends import fakes  # noqa: F401  (registers)
from nnstreamer_tpu_torch.backends import torch_backend  # noqa: F401  (registers)
from nnstreamer_tpu_torch.backends import tflite_backend  # noqa: F401  (registers)
from nnstreamer_tpu_torch.backends.custom import (  # noqa: F401
    register_custom_easy,
    unregister_custom_easy,
)
