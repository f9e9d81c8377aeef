"""CacheSparseTable — Python facade over the C++ host embedding cache.

Counterpart of ``hetu_tpu/cstable.py`` (reference parity:
python/hetu/cstable.py:19-211 over the hetu_cache module): a bounded
host-memory cache of one PS embedding table (``native/ps_cache.cc`` in
the port's server library) under the policies LRU, LFU and LFUOpt,
with bounded-staleness pulls and pushes against the server and the
reference's perf counters. The PS runtime's host path reads a table
through it when ``cstable_policy`` names one of the policies.

The reference's one telemetry site here is the health monitor's
staleness shadow (``telemetry/health.py``), which comes with the port's
health monitor (ROADMAP item 14).
"""
from __future__ import annotations

import numpy as np

from .ps.native_lib import as_f32, as_i64, fptr, get_lib, lptr

__all__ = ["CacheSparseTable"]

_POLICIES = {"LRU": 0, "LFU": 1, "LFUOpt": 2}


class CacheSparseTable:
    """Bounded-staleness cached view of one PS embedding table."""

    def __init__(self, node_id, length, width, limit, policy="LFUOpt",
                 pull_bound=100, push_bound=100):
        if policy not in _POLICIES:
            raise ValueError(f"unknown cache policy {policy!r}; expected "
                             f"one of {sorted(_POLICIES)}")
        self.node_id = node_id
        self.length = length
        self.width = int(width)
        self.limit = int(limit)
        self.policy = policy
        self.lib = get_lib()
        self.handle = self.lib.CacheCreate(
            node_id, self.limit, self.width, _POLICIES[policy],
            int(pull_bound), int(push_bound))
        self.push_bound = int(push_bound)

    def embedding_lookup(self, keys):
        idx = as_i64(keys).ravel()
        out = np.empty((idx.size, self.width), np.float32)
        self.lib.CacheLookup(self.handle, lptr(idx), idx.size, fptr(out))
        return out.reshape(tuple(np.shape(keys)) + (self.width,))

    def embedding_update(self, keys, grads):
        idx = as_i64(keys).ravel()
        g = as_f32(grads).reshape(idx.size, self.width)
        self.lib.CacheUpdate(self.handle, lptr(idx), fptr(g), idx.size)

    def flush(self):
        self.lib.CacheFlush(self.handle)

    # -- perf counters (reference cstable.py:126-187) -------------------
    @property
    def perf(self):
        names = ["hits", "misses", "evicts", "size", "pushed_rows",
                 "pulled_rows"]
        return {n: int(self.lib.CachePerf(self.handle, i))
                for i, n in enumerate(names)}

    def miss_rate(self):
        p = self.perf
        total = p["hits"] + p["misses"]
        return p["misses"] / total if total else 0.0

    def __del__(self):
        try:
            self.lib.CacheDestroy(self.handle)
        except Exception:
            pass
