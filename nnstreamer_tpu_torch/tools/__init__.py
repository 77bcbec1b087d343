"""Developer tools, the counterparts of ``nnstreamer_tpu/tools/``: the
TFLite flatbuffer reader (tflite_parse) and its torch program
(tflite_exec), codegen (custom-plugin scaffolds), confchk (config sanity
checker), gendoc (the registry as markdown) and pbtxt (pipeline
description → mediapipe-style pbtxt). Each runs as
``python -m nnstreamer_tpu_torch.tools.<name>``."""
