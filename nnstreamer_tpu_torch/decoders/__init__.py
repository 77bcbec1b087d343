"""Decoder subplugins. Importing registers the built-ins."""

from nnstreamer_tpu_torch.decoders import (  # noqa: F401
    bounding_box,
    direct_video,
    flatbuf,
    flexbuf,
    font,
    image_labeling,
    image_segment,
    octet_stream,
    pose,
    protobuf,
    python_script,
)
