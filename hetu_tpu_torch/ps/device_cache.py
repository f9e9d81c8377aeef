"""Device-resident embedding cache with bounded staleness.

Counterpart of ``hetu_tpu/ps/device_cache.py`` (the HET design; the
reference's cache-enabled embedding path, python/hetu/cstable.py over
hetu_cache): the hot rows of a PS embedding table live on the card, so
the steady-state training step touches them with no host transfer:

  * lookups gather from the cache tensor inside the step,
  * the worker optimizer applies the local sparse update in the step,
  * raw gradients also scatter-add into a device accumulator (``acc``
    state), and every ``push_bound`` steps the accumulated rows drain
    to the server on a background thread (PushEmbedding applies the
    server optimizer and bumps per-row versions),
  * misses and stale rows are fetched with SparsePull / SyncEmbedding
    and copied into the cache (:func:`pad_fill`).

The host keeps only the id <-> slot map, per-slot versions and dirty
counters, in numpy as in the reference. The reference's jitted
gathers and scatters become ``index_copy_``, ``index_select`` and
``index_fill_`` on the cache and accumulator in place; its
power-of-two padding of their row counts bounded ``jit`` recompiles
and changed no result, so the eager port drops it.

Two copies cross the host link, each fenced by an event:

* a miss fill stages the pulled rows in pinned memory and copies them
  with ``non_blocking`` on the step's stream, so the copy is ordered
  before the step that reads them; :class:`HostStaging` keeps the
  pinned buffer until the copy's event has fired;
* a drain gathers the accumulator rows and zeroes them on the step's
  stream (the gather ordered before the zeroing), copies the gathered
  rows into pinned memory with ``non_blocking`` and records an event;
  the push thread waits on that event before it reads them
  (:func:`host_rows`).

Observed staleness feeds the health monitor (``telemetry/health.py``):
how far a refreshed row ran behind the server (``pull``) and how many
local updates a drain claimed per row (``push``, a trip past
``push_bound``), to the owning executor's monitor that the PS runtime
stamps on ``health_monitor``, else to every live one. The misses this
cache fills are counted by the PS runtime (``dcache_miss_rows``).
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..telemetry import health as _health

__all__ = ["DeviceCacheTable", "HostStaging", "pad_fill",
           "pad_gather_zero", "to_host_async", "host_rows"]


class DeviceCacheTable:
    """Host-side bookkeeping for one device-cached embedding table.

    The cache itself is the tensor ``executor.params[cache_sid]``
    (shape ``[capacity + 1, width]``; the last row is the scratch slot,
    as in the reference) and the push accumulator
    ``executor.state[cache_sid]["acc"]``, both on the device.
    """

    def __init__(self, table_node, cache_node, client, *, capacity, width,
                 rows, push_bound=100, pull_bound=100, nworkers=1,
                 drain_compress=False):
        self.table_node = table_node
        self.cache_node = cache_node
        self.cache_sid = str(cache_node.id)
        self.tid = table_node.id
        self.client = client
        self.capacity = int(capacity)
        self.width = int(width)
        self.rows = int(rows)
        self.push_bound = int(push_bound)
        self.pull_bound = int(pull_bound)
        self.nworkers = int(nworkers)
        self.drain_compress = bool(drain_compress)

        # id -> slot map: direct-indexed for tables that fit, dict above
        # (a 33.7M-row Criteo map is a 135MB int32 array; a trillion-row
        # table falls back to hashing)
        if self.rows <= (1 << 26):
            self._slot_of = np.full(self.rows, -1, np.int32)
        else:
            self._slot_of = None
            self._slot_dict = {}
        self.id_of = np.full(self.capacity, -1, np.int64)
        self.ver = np.zeros(self.capacity, np.int64)    # client row version
        self.upd = np.zeros(self.capacity, np.int64)    # updates since push
        self.dirty = np.zeros(self.capacity, bool)
        self._clock = np.zeros(self.capacity, bool)     # recency bit
        self._pinned = np.zeros(self.capacity, bool)    # current batch's rows
        self._hand = 0
        self._n_used = 0
        self.steps_since_drain = 0
        # perf counters (reference cstable.py:163-187)
        self.hits = 0
        self.misses = 0
        self.evicts = 0
        self.pushed_rows = 0
        self.pulled_rows = 0
        # the owning executor's health monitor (stamped by the PS
        # runtime): staleness observations go to it alone
        self.health_monitor = None

    # -- id<->slot -------------------------------------------------------
    def _lookup_slots(self, uniq_ids):
        if self._slot_of is not None:
            return self._slot_of[uniq_ids]
        d = self._slot_dict
        return np.fromiter((d.get(int(i), -1) for i in uniq_ids),
                           np.int32, count=len(uniq_ids))

    def _set_slot(self, eid, slot):
        if self._slot_of is not None:
            self._slot_of[eid] = slot
        elif slot < 0:
            self._slot_dict.pop(int(eid), None)
        else:
            self._slot_dict[int(eid)] = slot

    def _alloc(self, n, inline_drain):
        """Allocate ``n`` slots, evicting clean rows by CLOCK. Rows the
        current batch touches are pinned and never candidates; dirty rows
        are never evicted silently — if only dirty rows remain, the
        caller drains first (``inline_drain`` callback)."""
        out = np.empty(n, np.int64)
        got = 0
        # fast path: never-used slots
        while got < n and self._n_used < self.capacity:
            s = self._n_used
            self._n_used += 1
            self._pinned[s] = True
            out[got] = s
            got += 1
        scanned = 0
        drained = False
        limit = 2 * self.capacity
        while got < n:
            if scanned >= limit:
                if drained:
                    raise RuntimeError(
                        f"device cache for tensor {self.tid} has capacity "
                        f"{self.capacity} but one batch needs more unique "
                        f"rows — raise cache_capacity")
                # every candidate is dirty: push pending updates, retry
                inline_drain()
                drained = True
                scanned = 0
                continue
            s = self._hand
            self._hand = (self._hand + 1) % self.capacity
            scanned += 1
            if self._pinned[s]:
                continue
            if self._clock[s]:
                self._clock[s] = False
                continue
            if self.dirty[s]:
                continue
            old = self.id_of[s]
            if old >= 0:
                self._set_slot(old, -1)
                self.evicts += 1
            self.id_of[s] = -1
            self._pinned[s] = True
            out[got] = s
            got += 1
        return out

    # -- per-step assignment ----------------------------------------------
    def assign(self, ids, inline_drain):
        """Map a batch of ids to slots, allocating for misses.

        Returns ``(slots, miss_ids, miss_slots, uniq_slots)`` — slots has
        ids' shape (int32); miss rows must be fetched and scattered into
        the cache before (in dispatch order) the step consumes it.
        """
        flat = np.asarray(ids).ravel().astype(np.int64)
        uniq, inv = np.unique(flat, return_inverse=True)
        slots = self._lookup_slots(uniq)
        miss = slots < 0
        n_miss = int(miss.sum())
        self.hits += len(uniq) - n_miss
        self.misses += n_miss
        # this batch's resident rows must survive its own miss evictions
        self._pinned[slots[~miss]] = True
        if n_miss:
            miss_ids = uniq[miss]
            new_slots = self._alloc(n_miss, inline_drain)
            if self._slot_of is not None:
                self._slot_of[miss_ids] = new_slots.astype(np.int32)
            else:
                for eid, s in zip(miss_ids, new_slots):
                    self._slot_dict[int(eid)] = int(s)
            self.id_of[new_slots] = miss_ids
            self.ver[new_slots] = 0
            self.upd[new_slots] = 0
            slots[miss] = new_slots
            self.pulled_rows += n_miss
        else:
            miss_ids = np.empty(0, np.int64)
            new_slots = np.empty(0, np.int64)
        self._clock[slots] = True
        # pins persist until release_pins(): a table consumed by several
        # lookups in one step must not evict slots an earlier assign()
        # already baked into its slots feed
        full = slots[inv].reshape(np.shape(ids)).astype(np.int32)
        return full, miss_ids, new_slots, slots

    def assign_block(self, ids_arr, inline_drain):
        """Vectorized :meth:`assign` for a whole block of steps. Every
        row any step of the block touches stays resident for the whole
        block — the residency set of running :meth:`assign` per step
        with pins held, with one unique / one alloc / one miss fill
        instead of ``nsteps`` of each; the steps then run one after
        another over the one cache.

        ``ids_arr`` is ``[nsteps, ...]``.  Returns ``(slots int32 of
        ids_arr's shape, miss_ids, miss_slots, uniq_slots, counts)``
        where ``counts[i]`` is the number of steps touching unique row
        ``i`` — per-step upd/version accounting for the staleness
        protocol is preserved bit-for-bit.
        """
        ids_arr = np.asarray(ids_arr)
        nsteps = ids_arr.shape[0]
        flat = ids_arr.reshape(nsteps, -1).astype(np.int64)
        uniq, inv = np.unique(flat, return_inverse=True)
        inv = inv.reshape(flat.shape)
        nuniq = len(uniq)
        # dedup (step, row) pairs -> how many steps touch each row
        pairs = np.unique(inv + np.arange(nsteps)[:, None] * nuniq)
        counts = np.bincount(pairs % nuniq, minlength=nuniq)
        slots = self._lookup_slots(uniq)
        miss = slots < 0
        n_miss = int(miss.sum())
        # a block row's first touch is the miss; later steps re-hit it
        self.hits += int(counts.sum()) - n_miss
        self.misses += n_miss
        self._pinned[slots[~miss]] = True
        if n_miss:
            miss_ids = uniq[miss]
            new_slots = self._alloc(n_miss, inline_drain)
            if self._slot_of is not None:
                self._slot_of[miss_ids] = new_slots.astype(np.int32)
            else:
                for eid, s in zip(miss_ids, new_slots):
                    self._slot_dict[int(eid)] = int(s)
            self.id_of[new_slots] = miss_ids
            self.ver[new_slots] = 0
            self.upd[new_slots] = 0
            slots[miss] = new_slots
            self.pulled_rows += n_miss
        else:
            miss_ids = np.empty(0, np.int64)
            new_slots = np.empty(0, np.int64)
        self._clock[slots] = True
        full = slots[inv].reshape(ids_arr.shape).astype(np.int32)
        return full, miss_ids, new_slots, slots, counts

    def release_pins(self):
        """End-of-step: this step's resident rows become evictable."""
        self._pinned[:] = False

    def note_update(self, uniq_slots, counts=1):
        """Record that the step (or block: ``counts`` from
        :meth:`assign_block`) just dispatched updates to these rows
        (called once per lookup; step accounting is ``note_step``)."""
        self.dirty[uniq_slots] = True
        self.upd[uniq_slots] += counts
        self.ver[uniq_slots] += counts

    def note_step(self):
        self.steps_since_drain += 1

    # -- staleness refresh (multi-worker) ----------------------------------
    def stale_check(self, uniq_ids, uniq_slots):
        """SyncEmbedding: rows whose server version ran more than
        ``pull_bound`` ahead of ours come back refreshed. Returns
        ``(slots_to_fill, rows)`` or ``(None, None)``. Single-worker
        tables skip the RPC — no other writer exists."""
        if self.nworkers <= 1:
            return None, None
        vers = self.ver[uniq_slots].copy()
        out = np.zeros((len(uniq_ids), self.width), np.float32)
        n_ref = self.client.sync_embedding(
            self.tid, self.pull_bound, uniq_ids, vers, out, self.width)
        if not n_ref:
            return None, None
        pos = np.nonzero(vers != self.ver[uniq_slots])[0]
        self._observe_pull(pos, vers, uniq_slots)
        self.ver[uniq_slots[pos]] = vers[pos]
        self.pulled_rows += len(pos)
        return uniq_slots[pos], out[pos]

    def _observe_pull(self, pos, vers, uniq_slots):
        """Observed read staleness: how many server updates each
        refreshed row ran behind before the sync caught it up — the
        consistency knob, measured against ``pull_bound``."""
        if len(pos) and (self.health_monitor is not None
                         or _health.active()):
            _health.observe_staleness(
                "pull", self.tid, vers[pos] - self.ver[uniq_slots][pos],
                self.pull_bound, monitor=self.health_monitor)

    # -- combined drain + refresh (kPushSyncEmbedding) ---------------------
    def push_sync(self, push_ids, push_rows, upds, uniq_ids, uniq_slots):
        """One RPC per shard that both applies the accumulated grads
        (PushEmbedding semantics: server optimizer runs, per-row
        versions bump by ``upds``) and refreshes the rows whose server
        version ran more than ``pull_bound`` ahead (SyncEmbedding
        semantics). The caller already claimed the dirty set with
        :meth:`take_dirty`; read bookkeeping mirrors
        :meth:`stale_check`. Returns ``(slots_to_fill, rows)`` or
        ``(None, None)``."""
        if self.nworkers > 1:
            push_rows = push_rows / self.nworkers
        vers = self.ver[uniq_slots].copy()
        out = np.zeros((len(uniq_ids), self.width), np.float32)
        n_ref = self.client.push_sync_embedding(
            self.tid, push_ids, push_rows, upds, self.pull_bound,
            uniq_ids, vers, out, self.width)
        if not n_ref:
            return None, None
        pos = np.nonzero(vers != self.ver[uniq_slots])[0]
        self._observe_pull(pos, vers, uniq_slots)
        self.ver[uniq_slots[pos]] = vers[pos]
        self.pulled_rows += len(pos)
        return uniq_slots[pos], out[pos]

    # -- drain --------------------------------------------------------------
    def take_dirty(self):
        """Claim the dirty set for a push; resets counters. Returns
        ``(slots int64[n], ids int64[n], upd_counts int64[n])``."""
        slots = np.nonzero(self.dirty)[0]
        ids = self.id_of[slots]
        upds = self.upd[slots].copy()
        self.dirty[slots] = False
        self.upd[slots] = 0
        self.steps_since_drain = 0
        keep = ids >= 0
        if keep.any() and (self.health_monitor is not None
                           or _health.active()):
            # observed write staleness: local updates a row had that the
            # server had not seen when this drain claimed it; past
            # push_bound the drain cadence failed to hold the bound
            _health.observe_staleness("push", self.tid, upds[keep],
                                      self.push_bound,
                                      monitor=self.health_monitor)
        return slots[keep].astype(np.int64), ids[keep], upds[keep]

    def invalidate(self):
        """Drop every cached row (e.g. after a checkpoint load replaced
        the server values). Pending updates must be drained first."""
        assert not self.dirty.any(), \
            "invalidate() with un-drained updates would lose them"
        if self._slot_of is not None:
            self._slot_of[:] = -1
        else:
            self._slot_dict.clear()
        self.id_of[:] = -1
        self.ver[:] = 0
        self.upd[:] = 0
        self._clock[:] = False
        self._pinned[:] = False
        self._hand = 0
        self._n_used = 0

    @property
    def perf(self):
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evicts": self.evicts, "size": self._n_used,
                "pushed_rows": self.pushed_rows,
                "pulled_rows": self.pulled_rows,
                "miss_rate": self.misses / total if total else 0.0}


class HostStaging:
    """Host-to-device copies through pinned memory, so the host does not
    wait for the device (a copy from pageable memory would wait for
    every kernel queued before it). Each pinned buffer is held until the
    event recorded after its copy has fired, so a ``non_blocking`` copy
    never reads freed memory."""

    def __init__(self):
        self._inflight = deque()

    def to_device(self, arr, device):
        """``arr`` (numpy) as a tensor on ``device``, copied on the
        current stream without the host waiting for it."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type != "cuda":
            return host.to(device)
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        pinned = host.pin_memory()
        out = pinned.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._inflight.append((done, pinned))
        return out


def pad_fill(cache, slots, rows, staging):
    """Copy host ``rows`` into the cache tensor at ``slots``, in place,
    on the step's stream (so before the next step reads them). Returns
    the cache tensor."""
    dev = cache.device
    idx = staging.to_device(np.asarray(slots, np.int64), dev)
    cache.index_copy_(0, idx, staging.to_device(
        np.asarray(rows, np.float32), dev).to(cache.dtype))
    return cache


def pad_gather_zero(acc, slots, staging, compress=False):
    """Gather the accumulator rows at ``slots``, then zero them in
    place — one stream, so the gather reads the sums before the zeroing
    — and start their copy to pinned host memory. Returns ``(acc, (host
    rows, event), n)``; :func:`host_rows` waits on the event.

    ``compress=True`` casts the gathered sums to bf16 on the device
    first: half the device-to-host bytes; the server widens them and
    applies its optimizer in f32, and the worker's own cache rows are
    untouched."""
    n = len(slots)
    idx = staging.to_device(np.asarray(slots, np.int64), acc.device)
    rows = acc.index_select(0, idx)
    if compress:
        rows = rows.to(torch.bfloat16)
    acc.index_fill_(0, idx, 0.0)
    return acc, to_host_async(rows), n


def to_host_async(t):
    """Start copying ``t`` into pinned host memory on the current
    stream; returns ``(host tensor, event)`` for :func:`host_rows`. On
    the CPU the tensor itself and no event (``t`` must not be written
    afterwards: the callers pass tensors nothing else holds)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def host_rows(staged):
    """The f32 numpy value of a :func:`to_host_async` copy, once its
    event has fired (the push threads call this)."""
    host, done = staged
    if done is not None:
        done.synchronize()
    if host.dtype != torch.float32:
        host = host.float()      # widen bf16
    return host.numpy()
