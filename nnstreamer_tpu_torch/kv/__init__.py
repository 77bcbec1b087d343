"""Paged KV-cache management for continuous-batching LLM serving.

The counterpart of ``nnstreamer_tpu/kv``, behind
``ContinuousBatcher(kv_layout="paged")``:

- :mod:`blocks` — :class:`BlockPool`: fixed-size token blocks of one
  device arena per layer, ref-counted with copy-on-write, and a
  rolling-prefix-hash index so requests sharing a token prefix share
  physical blocks;
- :mod:`block_attn` — the default block-native decode step
  (``kv_attn="auto"|"block"``): attention reads go through the block
  tables (kernel K4 with ``attn_impl="pallas"``), the decoded token's K/V
  lands in place in its owning block;
- :mod:`gather` — the arena, the admission-path block ops and the
  gather → contiguous view → scatter oracle behind ``kv_attn="gather"``;
- :mod:`sched` — chunked-prefill jobs and the preemption victim rule;
- :mod:`migrate` — the KV-span wire format of request migration and span
  checkpoints.

Not ported yet: the SLO ledger.
"""

from nnstreamer_tpu_torch.kv.blocks import BlockPool, NoBlocksError, PoolCapacityError
from nnstreamer_tpu_torch.kv.sched import PrefillJob, choose_victim

__all__ = ["BlockPool", "NoBlocksError", "PoolCapacityError", "PrefillJob", "choose_victim"]
