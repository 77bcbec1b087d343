"""Decoder subplugins. Importing registers the built-ins."""

from nnstreamer_tpu_torch.decoders import (  # noqa: F401
    bounding_box,
    image_labeling,
    image_segment,
    pose,
)
