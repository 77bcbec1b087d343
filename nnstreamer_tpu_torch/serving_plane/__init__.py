"""The serving plane: N streams served by one shared model instance.

The counterpart of ``nnstreamer_tpu/serving_plane``:

- :mod:`plane`: :class:`ModelPlane`, a process-wide shared device batcher
  per model: N client streams (one per attached ``tensor_filter
  plane=<name>``, across executors) feed ONE batched device program, with
  per-stream FIFO reassembly and weighted-fair scheduling
  (:mod:`scheduler`), so one hot stream cannot starve the rest.
- :mod:`sharding`: the programs a plane dispatches to (one device, or a
  host backend's own batching).
- :mod:`llm`: :class:`~nnstreamer_tpu_torch.serving_plane.llm.LlmPlane`,
  one shared paged LLM batcher behind N ``tensor_llm_serversink
  plane=<name>`` streams.

Not ported yet: the placement planner and data-sharded meshes (ROADMAP
A.8), failover replicas (A.6a), disaggregated prefill/decode (A.7).
"""

from nnstreamer_tpu_torch.serving_plane.plane import (
    ModelPlane,
    PlaneClosedError,
    PlaneConfig,
    acquire,
    release,
    resolve_plane_config,
)
from nnstreamer_tpu_torch.serving_plane.scheduler import PlaneStream, StreamScheduler

__all__ = [
    "ModelPlane",
    "PlaneClosedError",
    "PlaneConfig",
    "PlaneStream",
    "StreamScheduler",
    "acquire",
    "release",
    "resolve_plane_config",
]
