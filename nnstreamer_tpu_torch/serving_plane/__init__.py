"""The serving plane: N streams served by one shared model instance.

The counterpart of ``nnstreamer_tpu/serving_plane``:

- :mod:`plane`: :class:`ModelPlane`, a process-wide shared device batcher
  per model: N client streams (one per attached ``tensor_filter
  plane=<name>``, across executors) feed ONE batched device program, with
  per-stream FIFO reassembly and weighted-fair scheduling
  (:mod:`scheduler`), so one hot stream cannot starve the rest.
- :mod:`sharding`: the programs a plane dispatches to: one device, a
  data-sharded ``dp`` mesh (parallel/mesh.py), failover replicas, or a
  host backend's own batching.
- :mod:`placement`: the Hermes-style planner: a pipeline's stages on
  devices under a per-device memory bound, adjacent stages co-resident
  while they fit.
- :mod:`llm`: :class:`~nnstreamer_tpu_torch.serving_plane.llm.LlmPlane`,
  one shared paged LLM batcher behind N ``tensor_llm_serversink
  plane=<name>`` streams.
- :mod:`disagg`: :class:`~nnstreamer_tpu_torch.serving_plane.disagg.DisaggController`,
  disaggregated prefill/decode: a prefill server hands each request's KV
  span to a decode peer over the edge layer's CTRL channel.
"""

from nnstreamer_tpu_torch.serving_plane.placement import (
    PlacementError,
    place_pipeline,
    plan_placement,
)
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
    "PlacementError",
    "StreamScheduler",
    "acquire",
    "place_pipeline",
    "plan_placement",
    "release",
    "resolve_plane_config",
]
