"""PS-backed sparse serving: read-only embedding resolution.

Counterpart of ``hetu_tpu/serving/embedding.py``. Two pieces:

* :func:`serve_embeddings_from_ps` rewrites an eval graph's
  ``EmbeddingLookUp(table, ids)`` nodes into
  ``ParameterServerSparsePullOp`` host ops, so a serving session resolves
  rows through the PS client per request instead of materializing the
  (potentially trillion-parameter) table on the worker — the inference
  analogue of the training sparse-pull path.
* :class:`ReadOnlyPSClient` wraps the PS client for serving sessions:
  every mutating RPC (push, set_param, ...) raises — a serving session
  that would push is a bug, not a mode — and ``sparse_pull`` goes through
  a host LRU row cache that counts its hits and misses (``hit_rate``).
"""
from __future__ import annotations

import collections

import numpy as np

from ..graph.autodiff import find_topo_sort
from ..ops.comm import parameterServerSparsePull_op
from ..ops.embedding import EmbeddingLookUp
from ..ops.variable import PlaceholderOp

__all__ = ["ReadOnlyPSClient", "serve_embeddings_from_ps"]


def serve_embeddings_from_ps(eval_node_list, tables=None):
    """Rewrite PS-managed embedding lookups to read-only sparse pulls.

    ``tables`` limits the rewrite to the given table nodes; ``None``
    rewrites every lookup into a trainable placeholder table. The tables
    must already be registered on the PS server (a training run or an
    explicit ``init_tensor``/``set_param``). Mutates the graph in place
    (including ``eval_node_list`` entries) and returns the new pull ops.
    """
    topo = find_topo_sort(eval_node_list)
    replaced = {}
    for n in topo:
        if not isinstance(n, EmbeddingLookUp):
            continue
        tbl = n.inputs[0]
        if not (isinstance(tbl, PlaceholderOp) and tbl.trainable):
            continue
        if tables is not None and tbl not in tables:
            continue
        replaced[n] = parameterServerSparsePull_op(tbl, n.inputs[1])
    if replaced:
        for n in topo:
            n.inputs = [replaced.get(i, i) for i in n.inputs]
        for i, n in enumerate(eval_node_list):
            if n in replaced:
                eval_node_list[i] = replaced[n]
    return list(replaced.values())


# RPCs that mutate server state; everything else delegates verbatim
_BLOCKED = frozenset({
    "push", "sparse_push", "push_embedding", "dd_pushpull", "sd_pushpull",
    "ss_pushpull", "set_param", "init_tensor", "push_data", "load_param",
})


class ReadOnlyPSClient:
    """Read-only facade over a :class:`~hetu_tpu_torch.ps.client.PSClient`.

    Serving guard: calling any mutating RPC raises ``RuntimeError``.
    Row cache: ``cache_rows > 0`` keeps that many embedding rows (per
    table) in host memory with LRU eviction — rows a hot serving id set
    touches repeatedly skip the server RPC entirely. The cache has no
    invalidation protocol (serving reads a frozen table); call
    ``invalidate()`` after the server's values change.
    """

    def __init__(self, client, cache_rows=0):
        self._client = client
        self.cache_rows = int(cache_rows)
        self._cache = {}        # tid -> OrderedDict[id -> row]
        self.hits = 0
        self.misses = 0

    def __getattr__(self, name):
        if name in _BLOCKED:
            def _blocked(*args, **kwargs):
                raise RuntimeError(
                    f"read-only serving PS client: {name}() would "
                    f"mutate parameter-server state; serving sessions "
                    f"never push")
            return _blocked
        return getattr(self._client, name)

    # ------------------------------------------------------------------
    def invalidate(self):
        self._cache.clear()

    @property
    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def _note(self, hits, misses):
        self.hits += hits
        self.misses += misses

    def sparse_pull(self, tid, indices, width):
        idx = np.asarray(indices)
        if not self.cache_rows:
            self._note(0, idx.size)
            return self._client.sparse_pull(tid, idx, width)
        cache = self._cache.setdefault(tid, collections.OrderedDict())
        flat = idx.ravel().astype(np.int64)
        uniq, inv = np.unique(flat, return_inverse=True)
        rows = np.empty((len(uniq), int(width)), np.float32)
        miss_pos = []
        for i, eid in enumerate(uniq):
            row = cache.get(int(eid))
            if row is None:
                miss_pos.append(i)
            else:
                cache.move_to_end(int(eid))
                rows[i] = row
        self._note(len(uniq) - len(miss_pos), len(miss_pos))
        if miss_pos:
            miss_ids = uniq[miss_pos]
            fetched = self._client.sparse_pull(tid, miss_ids, width)
            fetched = np.asarray(fetched).reshape(len(miss_ids), width)
            for i, eid, row in zip(miss_pos, miss_ids, fetched):
                rows[i] = row
                # copy: caching a view would pin the WHOLE fetched
                # batch array for as long as any one row survives LRU
                cache[int(eid)] = row.copy()
                while len(cache) > self.cache_rows:
                    cache.popitem(last=False)
        return rows[inv].reshape(tuple(idx.shape) + (int(width),))
