"""Online inference on the GPU: the continuous-batching plane.

Counterpart of ``hetu_tpu/serving``. Ported so far:

* :class:`~hetu_tpu_torch.serving.kvcache.PagedKVCache` — block-paged
  pooled K/V on the device, refcounted free-list allocator,
  :class:`~hetu_tpu_torch.serving.kvcache.PrefixCache` with
  copy-on-write block sharing;
* :class:`~hetu_tpu_torch.serving.scheduler.ContinuousBatchingEngine` —
  iteration-level join/leave scheduling over the paged cache, bucketed
  dispatch shapes, KV-block admission control, prefix caching and
  chunked prefill;
* :class:`~hetu_tpu_torch.serving.router.SLOWindow`,
  :func:`~hetu_tpu_torch.serving.session.next_bucket` and
  :mod:`~hetu_tpu_torch.serving.lifecycle`.

``InferenceSession``, ``MicroBatcher``, ``GPTDecoder``, the HTTP
frontend, ``ReplicaRouter`` and PS-backed embeddings are not ported
yet.
"""
from .session import next_bucket
from .kvcache import (BlockAllocator, KVCacheExhausted, PagedKVCache,
                      PrefixCache)
from .lifecycle import RequestTimeline, mint_request_id
from .router import SLOWindow
from .scheduler import ContinuousBatchingEngine, EngineOverloaded

__all__ = ["next_bucket", "BlockAllocator", "KVCacheExhausted",
           "PagedKVCache", "PrefixCache",
           "ContinuousBatchingEngine", "EngineOverloaded", "SLOWindow",
           "RequestTimeline", "mint_request_id"]
