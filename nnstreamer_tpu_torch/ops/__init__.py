"""Device ops of the port (the counterpart of ``nnstreamer_tpu/ops``)."""
