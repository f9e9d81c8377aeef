"""Online inference on the GPU: the serving plane.

Counterpart of ``hetu_tpu/serving``. Ported:

* :class:`~hetu_tpu_torch.serving.session.InferenceSession` — frozen
  eval graphs restored from an ``Executor.save`` checkpoint, with
  batch/sequence shape bucketing;
* :class:`~hetu_tpu_torch.serving.decode.GPTDecoder` — dense-KV
  autoregressive decode (prefill on kernel K1, cached single-token
  steps), greedy or sampled;
* :class:`~hetu_tpu_torch.serving.batcher.MicroBatcher` — request-level
  dynamic micro-batching;
* :class:`~hetu_tpu_torch.serving.router.ReplicaRouter` and
  :class:`~hetu_tpu_torch.serving.router.SLOWindow` — least-inflight
  routing over replicas under an SLO probe;
* :class:`~hetu_tpu_torch.serving.http.ServingHTTPServer` — the stdlib
  JSON frontend;
* :class:`~hetu_tpu_torch.serving.kvcache.PagedKVCache` and
  :class:`~hetu_tpu_torch.serving.kvcache.PrefixCache`, and
  :class:`~hetu_tpu_torch.serving.scheduler.ContinuousBatchingEngine` —
  iteration-level batching over the block-paged cache;
* :mod:`~hetu_tpu_torch.serving.lifecycle` — request ids and in-flight
  tables;
* :func:`~hetu_tpu_torch.serving.embedding.serve_embeddings_from_ps`
  and :class:`~hetu_tpu_torch.serving.embedding.ReadOnlyPSClient` —
  sessions that read their embedding rows from the parameter server.
"""
from .batcher import MicroBatcher
from .decode import GPTDecoder
from .embedding import ReadOnlyPSClient, serve_embeddings_from_ps
from .http import ServingHTTPServer
from .kvcache import (BlockAllocator, KVCacheExhausted, PagedKVCache,
                      PrefixCache)
from .lifecycle import RequestTimeline, mint_request_id
from .router import ReplicaRouter, RouterOverloaded, SLOWindow
from .scheduler import ContinuousBatchingEngine, EngineOverloaded
from .session import InferenceSession, next_bucket

__all__ = ["InferenceSession", "next_bucket", "GPTDecoder",
           "MicroBatcher", "ServingHTTPServer", "ReplicaRouter",
           "RouterOverloaded", "SLOWindow", "BlockAllocator",
           "KVCacheExhausted", "PagedKVCache", "PrefixCache",
           "ContinuousBatchingEngine", "EngineOverloaded",
           "RequestTimeline", "mint_request_id", "ReadOnlyPSClient",
           "serve_embeddings_from_ps"]
