"""CacheSparseTable — Python facade over the C++ host embedding cache.

Counterpart of ``hetu_tpu/cstable.py`` (reference parity:
python/hetu/cstable.py:19-211 over the hetu_cache module): a bounded
host-memory cache of one PS embedding table (``native/ps_cache.cc`` in
the port's server library) under the policies LRU, LFU and LFUOpt,
with bounded-staleness pulls and pushes against the server and the
reference's perf counters. The PS runtime's host path reads a table
through it when ``cstable_policy`` names one of the policies.

While a health monitor is live (``telemetry/health.py``) the table
keeps the reference's staleness shadow: per-key pending-update counts
since the last explicit flush, reported at lookup (``cstable``, an upper
bound, never a trip).
"""
from __future__ import annotations

import numpy as np

from .ps.native_lib import as_f32, as_i64, fptr, get_lib, lptr
from .telemetry import health as _health

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
        # observed-staleness shadow (telemetry/health.py): per-key
        # pending-update counts since the last explicit flush. The C
        # cache also flushes on its own bound, so these are an UPPER
        # bound on true staleness — histogram-only, never a trip. Kept
        # only while a health monitor is live; ``health_monitor``
        # (stamped by the PS runtime) scopes the observations to the
        # owning executor's
        self._upd_pending = {}
        self.health_monitor = None

    def embedding_lookup(self, keys):
        idx = as_i64(keys).ravel()
        out = np.empty((idx.size, self.width), np.float32)
        self.lib.CacheLookup(self.handle, lptr(idx), idx.size, fptr(out))
        if self._upd_pending and (self.health_monitor is not None
                                  or _health.active()):
            uniq = np.unique(idx)
            obs = np.fromiter(
                (self._upd_pending.get(int(i), 0) for i in uniq),
                np.int64, count=len(uniq))
            obs = obs[obs > 0]
            if len(obs):
                _health.observe_staleness("cstable", self.node_id, obs,
                                          self.push_bound,
                                          monitor=self.health_monitor)
        return out.reshape(tuple(np.shape(keys)) + (self.width,))

    def embedding_update(self, keys, grads):
        idx = as_i64(keys).ravel()
        g = as_f32(grads).reshape(idx.size, self.width)
        self.lib.CacheUpdate(self.handle, lptr(idx), fptr(g), idx.size)
        if self.health_monitor is not None or _health.active():
            uniq, counts = np.unique(idx, return_counts=True)
            pend = self._upd_pending
            for i, n in zip(uniq, counts):
                i = int(i)
                pend[i] = pend.get(i, 0) + int(n)
            if len(pend) > (1 << 16):
                pend.clear()     # bound memory; counts restart (approx)

    def flush(self):
        self.lib.CacheFlush(self.handle)
        self._upd_pending.clear()

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
