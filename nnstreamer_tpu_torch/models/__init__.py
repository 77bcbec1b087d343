"""Model zoo of the port (the counterpart of ``nnstreamer_tpu/models``)."""
