"""Pipeline elements. Importing registers every built-in element factory."""

from nnstreamer_tpu_torch.elements.base import (  # noqa: F401
    Element,
    MediaSpec,
    NegotiationError,
    Sink,
    Source,
    TensorOp,
)
from nnstreamer_tpu_torch.elements import sources  # noqa: F401
from nnstreamer_tpu_torch.elements import converter  # noqa: F401
from nnstreamer_tpu_torch.elements import transform  # noqa: F401
from nnstreamer_tpu_torch.elements import filter as filter_elem  # noqa: F401
from nnstreamer_tpu_torch.elements import decoder  # noqa: F401
from nnstreamer_tpu_torch.elements import sink  # noqa: F401
from nnstreamer_tpu_torch.elements import llm_serve  # noqa: F401
