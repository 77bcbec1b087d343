"""Decoder subplugins. Importing registers the built-ins."""

from nnstreamer_tpu_torch.decoders import bounding_box, image_labeling  # noqa: F401
