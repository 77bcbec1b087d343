"""Pipeline elements. Importing registers every built-in element factory."""

from nnstreamer_tpu_torch.elements.base import (  # noqa: F401
    Element,
    HostElement,
    MediaSpec,
    NegotiationError,
    Routing,
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
from nnstreamer_tpu_torch.elements import flow  # noqa: F401
from nnstreamer_tpu_torch.elements import routing  # noqa: F401
from nnstreamer_tpu_torch.elements import control  # noqa: F401
from nnstreamer_tpu_torch.elements import windowing  # noqa: F401
from nnstreamer_tpu_torch.elements import sparse_elems  # noqa: F401
from nnstreamer_tpu_torch.elements import chaos  # noqa: F401
from nnstreamer_tpu_torch.elements import stage  # noqa: F401
from nnstreamer_tpu_torch.elements import media  # noqa: F401
from nnstreamer_tpu_torch.elements import iio  # noqa: F401
