"""Executor-side PS runtime: schedules host pushes and pulls around each
step.

Counterpart of ``hetu_tpu/ps/runtime.py`` (reference parity: the
d2h-stream PS path of SubExecutor, executor.py:1800-1825, and
ParameterServerCommunicateOp's _compute_asp_prefetch,
ParameterServerCommunicate.py:38-70). Two embedding paths:

* **host path** (default): per step, sparse-pull the rows this batch
  needs, feed them to the step, push the gradients after. Every
  transfer is on the critical path — used by BSP and small tables. A
  ``cstable_policy`` of LRU / LFU / LFUOpt reads the rows through the
  host cache (:class:`~hetu_tpu_torch.cstable.CacheSparseTable`).
* **device-cache path** (``cstable_policy="Device"``, the HET design):
  rows live on the card in a cache tensor the worker optimizer updates
  in the step; the runtime only (a) maps ids to cache slots on the
  host, (b) copies missed rows in, and (c) drains the device gradient
  accumulator to the server on a background thread every
  ``cache_bound`` steps (:mod:`.device_cache`).

Dense PS parameters follow the same split: a synchronous DDPushPull per
step, or — under the device cache's ASP mode with SGD — local updates
with their gradients summed on the device and drained on the cache's
cadence.

Where the reference threads cache, accumulator and parameters through
a pure jitted step, the port updates them in place: the drain's gather
is ordered before its zeroing on the step's stream and its copy to the
host is fenced by an event the push thread waits on; a miss fill's
pinned buffer is held until its copy's event fires
(:mod:`.device_cache`).

Which modes give the same numbers on every run at one worker: BSP,
``prefetch=False``, and ASP with :meth:`PSRuntime.drain` after every
step on the host path; the device-cache path at one worker in any mode
(a re-missed row whose gradients are still in flight waits for their
push). ASP on the host path lets a pull race the previous step's push.
Over several workers (``HETU_PS_NWORKERS``, one process each) pushes
are scaled by 1 / nworkers; BSP on the host path is the one mode that
gives the same numbers on every run, because each step pulls, barriers,
pushes, barriers and then pulls the dense values back (the reference
pulls them in the push's round trip, before its one barrier, so they
race the other workers' pushes). The device cache over several workers
refreshes rows whose server version ran ``cache_bound`` updates ahead
(``SyncEmbedding``), so it depends on timing by design.

With the session's health monitor on (``health_options``), the runtime
stamps it on each device and host cache it registers (their staleness
observations go to it alone), feeds it every pulled id stream (hot-key
skew), pre-warms the tiered store with the ids it measured hottest, and
hands it the step (``after_step``, after the pushes and the barrier) or
a block's sampled steps (``after_block``), with itself for the server
table sample.
"""
from __future__ import annotations

import atexit
import contextlib
import functools
import os
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..ingest import DaemonPool, IngestEngine, to_device
from ..ndarray import IndexedSlices, NDArray
from .device_cache import (DeviceCacheTable, HostStaging, host_rows,
                           pad_fill, pad_gather_zero, to_host_async)

__all__ = ["PSRuntime"]


def _opt_spec(optimizer):
    """(server optimizer name, lrs) of a worker optimizer (reference
    runtime.py:44)."""
    name = optimizer.name
    lr = float(optimizer.learning_rate)
    if name == "SGD":
        return "SGD", [lr]
    if name == "Momentum":
        kind = "Nesterov" if getattr(optimizer, "nesterov", False) \
            else "Momentum"
        return kind, [lr, float(optimizer.momentum)]
    if name == "AdaGrad":
        return "AdaGrad", [lr, float(optimizer.eps)]
    if name in ("Adam", "AdamW"):
        # lrs[4], if present, is decoupled weight decay, applied by the
        # server's Adam after the moment update
        lrs = [lr, float(optimizer.beta1), float(optimizer.beta2),
               float(optimizer.epsilon)]
        if name == "AdamW":
            lrs.append(float(optimizer.weight_decay))
        return "Adam", lrs
    return "SGD", [lr]


def _check_ids(idx, rows, what):
    """The id-dtype check of the embedding lookup on host ids: float
    ids and integer dtypes too narrow for the table are refused."""
    from ..ops.embedding import check_id_dtype
    check_id_dtype(torch.from_numpy(np.empty(0, idx.dtype)).dtype, rows,
                   what)


class PSRuntime:
    def __init__(self, executor, config):
        self.executor = executor
        self.config = config
        self.client = config.ps_comm
        self.device = config.device
        self.registered = set()
        self.caches = {}        # param.id -> CacheSparseTable (host cache)
        self.device_tables = {}  # table.id -> DeviceCacheTable
        self._sub_cached = {}   # sub.name -> [(table_rt, ids, slots), ...]
        self._staging = HostStaging()
        # ASP: gradient readback + push run on this pool so the loop can
        # issue the next step at once; BSP must see every push before
        # its barrier, so it has none
        self._push_pool = None
        self._pending_push = []
        self.updates_dropped = False   # drain() skipped after shutdown
        if config.prefetch and not config.bsp:
            # daemon workers with a bounded-join shutdown: a push wedged
            # in an RPC against a dead server never deadlocks close()
            self._push_pool = DaemonPool(max_workers=2,
                                         thread_name_prefix="hetu-ps-push")
        # dense HET pipeline: dense PS params updated locally in the
        # step, gradients summed in device state; the drain pushes the
        # sums and, multi-worker, pulls rebased values
        self._dense_steps = 0
        self._dense_future = None
        self._dense_ready = None     # {sid: (param, np value)} to swap in
        self._dense_mu = threading.Lock()
        self._times_mu = threading.Lock()
        # host seconds per step phase (phase_breakdown)
        self.times = {"slot_assign": 0.0, "miss_fill": 0.0, "refresh": 0.0,
                      "dispatch": 0.0, "drain_submit": 0.0, "dense": 0.0,
                      "host_pull": 0.0, "sync_push": 0.0,
                      "feed_ingest": 0.0, "prefetch": 0.0,
                      "repull": 0.0}
        # pipelined-stream bookkeeping (run_stream_pipelined): the table
        # ids speculative pulls read (None = not streaming), the sparse
        # ids the last run_step pushed, and the ids of ASP pushes still
        # in flight, which seed new preps' dirty sets
        self._track_push_tids = None
        self._last_pushed = {}
        self._inflight_pushed = {}
        self._closed = False
        # tables converted to the tiered row store (_maybe_store_config)
        self._store_tids = set()
        # eager registration so save()/load() work before the first step
        self._register_all()
        atexit.register(self._atexit)

    @contextlib.contextmanager
    def _phase(self, name):
        """One PS step phase: its host seconds add to ``times`` (the
        step logger's deltas) and, with telemetry on, a ``ps:<name>``
        span, a ``ps_<name>_ms`` histogram and a flight record (a phase
        that never completes — a hung server — is a pending entry)."""
        tel = self.config.telemetry
        t0n = tel.clock() if tel.enabled else 0
        t0 = time.perf_counter()
        frec = (tel.flight.start("ps", "ps:" + name)
                if tel.enabled else None)
        try:
            yield
        finally:
            with self._times_mu:    # prep phases run on the ingest worker
                self.times[name] += time.perf_counter() - t0
            tel.flight_complete(frec)
            if tel.enabled:
                t1n = tel.clock()
                tel.complete("ps:" + name, t0n, t1n)
                tel.observe(f"ps_{name}_ms", (t1n - t0n) / 1e6)

    def _put(self, value, shape=None):
        """A host numpy value as a tensor on the session's device."""
        value = np.asarray(value, np.float32)
        if shape is not None:
            value = value.reshape(shape)
        return to_device(value, self.device)

    # ------------------------------------------------------------------
    def _register_all(self):
        fresh = False
        for op in self.config.ps_nodes:
            if self._register_one(op):
                fresh = True
        for entry in self.config.device_cache_tables:
            if self._register_device_table(entry):
                fresh = True
        for param, opt in self.config.ps_dense_cached:
            if param.id in self.registered:
                continue
            opt_name, lrs = _opt_spec(opt)
            self.client.init_tensor(param.id, tuple(param.shape), kind=0,
                                    opt=opt_name, lrs=lrs)
            self.client.set_param(param.id, self._initial(param))
            self.registered.add(param.id)
            fresh = True
        if fresh and self.config.bsp:
            self.client.barrier()

    def _initial(self, param):
        value = self.executor.params.get(str(param.id))
        if value is None:
            return param.initial_value(seed=self.config.seed)
        return NDArray(value).asnumpy()

    def _register_one(self, op):
        """Register one PS-managed parameter on the server; True when it
        was newly registered."""
        opt = getattr(op, "optimizer_info", None)
        opt_name, lrs = _opt_spec(opt) if opt is not None else ("SGD", [0.1])
        param = op.parameter
        if param.id in self.registered:
            return False
        tid = param.id
        shape = tuple(param.shape)
        if param.is_embed:
            kind = 2 if self.config.cstable_policy else 1
            self._init_table(param, kind, opt_name, lrs)
            if self.config.cstable_policy:
                from ..cstable import CacheSparseTable
                bound = self.config.cache_bound
                cache = CacheSparseTable(
                    tid, shape[0], int(np.prod(shape[1:])),
                    limit=max(1, shape[0] // 5),
                    policy=self.config.cstable_policy,
                    pull_bound=bound, push_bound=bound)
                # staleness observations go to this executor's monitor
                cache.health_monitor = self.config.health_monitor
                self.caches[param.id] = cache
        else:
            self.client.init_tensor(tid, shape, kind=0, opt=opt_name,
                                    lrs=lrs)
            self.client.set_param(tid, self._initial(param))
        self.registered.add(param.id)
        return True

    def _init_table(self, table, kind, opt_name, lrs):
        """Register an embedding table: drawn on the server when its
        initializer has a ``dist_spec`` (the table never materializes on
        the worker), else set from its value."""
        shape = tuple(table.shape)
        init = None
        if table.initializer is not None:
            init = table.initializer.dist_spec()
        if init is not None:
            self.client.init_tensor(table.id, shape, kind=kind, init=init,
                                    seed=self.config.seed + table.id,
                                    opt=opt_name, lrs=lrs)
        else:
            self.client.init_tensor(table.id, shape, kind=kind,
                                    opt=opt_name, lrs=lrs)
            self.client.set_param(table.id, table.initial_value(
                seed=self.config.seed))
        self._maybe_store_config(table.id, opt_name)

    def _maybe_store_config(self, tid, opt_name):
        """Apply the tiered / quantized row-store knobs to a fresh table
        (``HETU_PS_STORE_DTYPE`` = f32 | f16 | int8,
        ``HETU_PS_STORE_DRAM_ROWS`` resident rows per shard,
        ``HETU_PS_STORE_DIR`` spill directory). The tiered store keeps no
        optimizer slots, so a slot-carrying optimizer keeps flat f32
        storage, with a warning. The ids the health monitor measured
        hottest so far are pre-warmed into the DRAM pool."""
        dt = os.environ.get("HETU_PS_STORE_DTYPE")
        dram = os.environ.get("HETU_PS_STORE_DRAM_ROWS")
        if dt is None and dram is None:
            return
        if opt_name not in ("SGD", "None"):
            print(f"[hetu-ps] table {tid}: HETU_PS_STORE_* ignored — "
                  f"tiered rows need a stateless server optimizer, "
                  f"got {opt_name}", file=sys.stderr)
            return
        hm = self.config.health_monitor
        hot = hm.hot_ids(tid) if hm is not None else ()
        self.client.store_config(
            tid, dtype=dt or "f32", dram_rows=int(dram) if dram else -1,
            hot_ids=hot)
        self._store_tids.add(tid)

    def _refresh_hot_rows(self, tid, k=1024):
        """Pin the measured-hot ids (the health monitor's skew telemetry)
        into the tiered store's DRAM pool again: a repeated StoreConfig
        on a tiered table is a read-promotion pass, so placement follows
        the observed ids instead of a guessed prefix."""
        hm = self.config.health_monitor
        if hm is None or tid not in self._store_tids:
            return
        hot = hm.hot_ids(tid, k)
        if len(hot):
            self.client.store_config(tid, hot_ids=hot)

    def _register_device_table(self, entry):
        """Register a device-cached table (kind 2: the server keeps
        per-row versions for the bounded-staleness sync)."""
        tbl = entry["table"]
        if tbl.id in self.registered:
            return False
        opt = entry.get("optimizer")
        opt_name, lrs = _opt_spec(opt) if opt is not None else ("SGD", [0.1])
        self._init_table(tbl, 2, opt_name, lrs)
        push_bound = 1 if self.config.bsp else self.config.cache_bound
        rt = DeviceCacheTable(
            tbl, entry["cache"], self.client,
            capacity=entry["capacity"], width=entry["width"],
            rows=entry["rows"], push_bound=push_bound,
            pull_bound=self.config.cache_bound,
            nworkers=max(1, self.client.nworkers),
            drain_compress=self.config.drain_compress)
        # staleness observations go to this executor's monitor
        rt.health_monitor = self.config.health_monitor
        rt._drain_future = None
        rt._inflight_ids = None
        self.device_tables[tbl.id] = rt
        self.registered.add(tbl.id)
        return True

    # ------------------------------------------------------------------
    def _cached_for(self, sub):
        """[(table_rt, ids_node, slots_node)] of this subgraph."""
        if sub.name in self._sub_cached:
            return self._sub_cached[sub.name]
        out = []
        topo = set(sub.topo_order)
        for entry in self.config.device_cache_tables:
            rt = self.device_tables[entry["table"].id]
            for ids_node, slots_node in entry["slots_by_ids"].items():
                if slots_node in topo:
                    out.append((rt, ids_node, slots_node))
        self._sub_cached[sub.name] = out
        return out

    def _swap_dense_ready(self):
        """Swap in dense parameters rebased by a completed drain cycle
        (multi-worker: the server value folds the other workers'
        pushes)."""
        with self._dense_mu:
            ready, self._dense_ready = self._dense_ready, None
        if ready:
            params = self.executor.params
            for sid, (param, value) in ready.items():
                if sid in params:
                    params[sid] = self._put(value, param.shape)

    def _fill_misses(self, rt, miss_ids, miss_slots):
        """Pull missed rows and copy them into the cache. A re-missed id
        whose gradients are still in an in-flight drain would read a
        pre-push row: that drain is waited for first."""
        self.config.telemetry.inc("dcache_miss_rows", len(miss_ids))
        with self._phase("miss_fill"):
            fut = rt._drain_future
            if fut is not None and not fut.done() and \
                    rt._inflight_ids is not None and \
                    np.isin(miss_ids, rt._inflight_ids).any():
                fut.result()
                rt._drain_future = None
            rows = self.client.sparse_pull(rt.tid, miss_ids, rt.width)
            params = self.executor.params
            params[rt.cache_sid] = pad_fill(params[rt.cache_sid],
                                            miss_slots, rows,
                                            self._staging)

    # ------------------------------------------------------------------
    def run_step(self, sub, feed_dict, convert_to_numpy_ret_vals=False,
                 prepped=None, dirty=None):
        """One PS step. ``prepped`` (from :meth:`prep_step`, usually run
        on the ingest worker while the previous step computed) carries
        transferred feeds and speculative SparsePull rows; ``dirty``
        maps table id -> ids pushed since the prep was issued — those
        rows are pulled again (after the in-flight pushes are flushed),
        so the overlapped pull sees what a synchronous loop would."""
        executor = self.executor
        client = self.client
        nworkers = max(1, client.nworkers)
        feed_dict = feed_dict or {}
        cached = self._cached_for(sub)
        topo_set = sub.topo_set
        self._swap_dense_ready()

        feed_map = {}
        host_feeds = {}      # node -> host value (no readback needed)
        spec_pulls = {}
        if prepped is not None:
            feed_map.update(prepped["feed_map"])
            host_feeds.update(prepped["host_feeds"])
            spec_pulls = prepped["pulls"]
        for node, value in feed_dict.items():
            if node in feed_map or node in host_feeds:
                continue        # pre-ingested on the worker
            if isinstance(value, np.ndarray):
                host_feeds[node] = value
            if node in topo_set:
                feed_map[node] = sub._ingest(value)
        for dl in sub.dataloader_ops:
            if dl in feed_map:
                continue        # pre-fetched in step order by the stream
            host_val = dl.get_arr(sub.name)
            if isinstance(host_val, np.ndarray):
                host_feeds[dl] = host_val
            feed_map[dl] = sub._ingest(host_val)

        def host_ids(index_node, what, rows=None):
            if index_node in host_feeds:
                idx = np.asarray(host_feeds[index_node])
            elif _is_loader(index_node) and index_node not in feed_map:
                # an ids dataloader the cache rewrite took out of the
                # graph: driven from here
                idx = np.asarray(index_node.get_arr(sub.name))
                host_feeds[index_node] = idx
            elif index_node in feed_map:
                # ids on the device: one readback
                idx = feed_map[index_node].cpu().numpy()
            else:
                raise RuntimeError(
                    f"PS {what} requires its indices to be a feed or "
                    f"dataloader output")
            _check_ids(idx, rows, f"PS {what}")
            return idx

        # 0. device-cache path: ids -> slots, copy missed rows in (on
        # the step's stream, so before the step reads them)
        note = []
        hm = self.config.health_monitor
        for rt, ids_node, slots_node in cached:
            with self._phase("slot_assign"):
                ids = host_ids(ids_node, "device-cached lookup",
                               rows=rt.rows)
                if hm is not None:
                    hm.observe_ids(rt.tid, ids)     # hot-key skew
                slots, miss_ids, miss_slots, uniq_slots = rt.assign(
                    ids, functools.partial(self._drain_device_table, rt,
                                           wait=True))
            if len(miss_ids):
                self._fill_misses(rt, miss_ids, miss_slots)
            if rt.nworkers > 1:
                with self._phase("refresh"):
                    uniq_ids = rt.id_of[uniq_slots]
                    fut = rt._drain_future
                    if (rt.steps_since_drain + 1 >= rt.push_bound
                            and rt.dirty.any()
                            and (fut is None or fut.done())):
                        # a drain falls due this step: fold it into the
                        # refresh as one kPushSyncEmbedding round trip
                        fill_slots, fill_rows = \
                            self._push_sync_device_table(rt, uniq_ids,
                                                         uniq_slots)
                    else:
                        fill_slots, fill_rows = rt.stale_check(
                            uniq_ids, uniq_slots)
                    if fill_slots is not None:
                        executor.params[rt.cache_sid] = pad_fill(
                            executor.params[rt.cache_sid], fill_slots,
                            fill_rows, self._staging)
            feed_map[slots_node] = sub._ingest(slots)
            if sub.training:
                note.append((rt, uniq_slots))

        # 1. embedding rows of this batch (reference SparsePull path,
        # EmbeddingLookUp.py:27-40): duplicate ids are pulled once and
        # scattered back on the host
        for lk in sub.ps_lookups:
            if lk in spec_pulls:
                feed_map[lk] = self._settle_spec_pull(spec_pulls[lk],
                                                      dirty)
                continue
            with self._phase("host_pull"):
                idx = host_ids(lk.inputs[1], "embedding lookup",
                               rows=int(lk.inputs[0].shape[0]))
                if hm is not None:
                    hm.observe_ids(lk.inputs[0].id, idx)
                width = int(lk.inputs[0].shape[-1])
                cache = self.caches.get(lk.inputs[0].id)
                if cache is not None:
                    rows = cache.embedding_lookup(idx)
                else:
                    uniq, inv = np.unique(idx.ravel(),
                                          return_inverse=True)
                    rows = client.sparse_pull(
                        lk.inputs[0].id, uniq, width)[inv].reshape(
                            idx.shape + (width,))
                feed_map[lk] = self._put(rows)
        # explicit sparse-pull ops (the inference path, reference
        # ParameterServerCommunicate.py:236-288) are fed the same way
        for op in sub.ps_pull_ops:
            if op in spec_pulls:
                feed_map[op] = self._settle_spec_pull(spec_pulls[op],
                                                      dirty)
                continue
            idx = host_ids(op.inputs[0], "sparse pull",
                           rows=int(op.parameter.shape[0]))
            if hm is not None:
                hm.observe_ids(op.parameter.id, idx)
            width = int(op.parameter.shape[-1])
            rows = client.sparse_pull(op.parameter.id, idx, width)
            feed_map[op] = self._put(rows)

        with self._phase("dispatch"):
            outputs, ps_grads = sub.step(executor, feed_map)
        # BSP over several workers reads and writes the server in two
        # phases a step, each closed by a barrier: every worker has
        # pulled this step's rows before any pushes (a faster worker's
        # push would race a slower one's pull), and every push has
        # landed before the dense values are pulled back
        bsp_fleet = self.config.bsp and nworkers > 1
        if bsp_fleet:
            client.barrier()
        dense_pulls = []

        # 2. device-cache bookkeeping and the periodic drain
        stepped = set()
        for rt, uniq_slots in note:
            rt.note_update(uniq_slots)
            stepped.add(rt.tid)
        for rt, _, _ in cached:
            rt.release_pins()
            if rt.tid in stepped:
                stepped.discard(rt.tid)
                rt.note_step()
                if rt.steps_since_drain >= rt.push_bound:
                    self._drain_device_table(rt, wait=self.config.bsp)
                    self._refresh_hot_rows(rt.tid)

        # 3. push PS gradients / pull updated dense params
        track = self._track_push_tids
        pushed = {} if track else None
        for op, g in zip(sub.ps_ops, ps_grads):
            param = op.parameter
            tid = param.id
            if isinstance(g, IndexedSlices):
                if pushed is not None and tid in track:
                    # ids this push dirties: the pipelined stream merges
                    # them into every in-flight prep's dirty set
                    ids = np.unique(g.indices.cpu().numpy()).tolist()
                    pushed.setdefault(tid, set()).update(ids)
                    if self._push_pool is not None and \
                            param.id not in self.caches:
                        self._inflight_pushed.setdefault(
                            tid, set()).update(ids)
                if self._push_pool is not None and \
                        param.id not in self.caches:
                    # ASP: readback and push off the critical path — the
                    # next step's pull may see the table one push stale
                    self._drain_done()
                    staged = (to_host_async(g.indices),
                              to_host_async(g.values))
                    self._pending_push.append(self._push_pool.submit(
                        self._push_sparse, param, staged, nworkers))
                    continue
                with self._phase("sync_push"):
                    staged = (to_host_async(g.indices),
                              to_host_async(g.values))
                    self._push_sparse(param, staged, nworkers)
                    client.wait(tid)
            else:
                with self._phase("sync_push"):
                    grad = host_rows(to_host_async(g)).ravel()
                    if nworkers > 1:
                        grad = grad / nworkers
                    if bsp_fleet:
                        client.push(tid, grad)
                        client.wait(tid)
                        dense_pulls.append(param)
                        continue
                    new_value = client.dd_pushpull(tid, grad)
                    client.wait(tid)
                    sid = str(param.id)
                    if sid in executor.params:
                        executor.params[sid] = self._put(new_value,
                                                         param.shape)
        if pushed is not None:
            self._last_pushed = pushed

        # 3b. the dense HET drain cadence (gradients summed in the step)
        if self.config.ps_dense_cached and sub.training:
            with self._phase("dense"):
                self._dense_steps += 1
                if self._dense_steps >= max(1, self.config.cache_bound):
                    self._drain_dense_cached(nworkers)

        # 4. synchronization: BSP barrier, or ASP free-running with a
        # bounded pipeline (reference ParameterServerCommunicate.py:226)
        if self.config.bsp:
            client.barrier()
            for param in dense_pulls:
                with self._phase("sync_push"):
                    sid = str(param.id)
                    value = client.pull(param.id,
                                        (int(np.prod(param.shape)),))
                    if sid in executor.params:
                        executor.params[sid] = self._put(value,
                                                         param.shape)
        elif len(self._pending_push) > 4:
            self._pending_push[0].result()
            self._drain_done()
        if hm is not None and sub.training:
            # after the pushes and the barrier, so that the raise rung
            # never leaves this step's server updates half applied; the
            # monitor folds in this runtime's staleness and hot-key
            # observations and samples the server's tables
            hm.after_step(sub, runtime=self)
        return sub.results(outputs, convert_to_numpy_ret_vals)

    # ------------------------------------------------------------------
    def prep_step(self, sub, feed_dict, dl_host=None):
        """The worker-safe host phase of one step: transfer the plain
        feeds (and pre-fetched dataloader batches, ``dl_host``) and
        speculatively SparsePull the rows the step needs. Stateful work
        — host-cache lookups, slot assignment, pushes, barriers — stays
        on the caller; :meth:`run_step` revalidates the speculative
        pulls against pushes that landed after this prep. Under
        multi-worker BSP pulls are not speculated (another worker's
        push is invisible to the dirty tracking)."""
        topo_set = sub.topo_set
        feed_map, host_feeds = {}, {}
        for node, value in (feed_dict or {}).items():
            if isinstance(value, np.ndarray):
                host_feeds[node] = value
            if node in topo_set:
                feed_map[node] = sub._ingest(value)
        for dl, host_val in (dl_host or {}).items():
            host_val = np.asarray(host_val)
            host_feeds[dl] = host_val
            feed_map[dl] = sub._ingest(host_val)
        pulls = {}
        speculate = not (self.config.bsp
                         and max(1, self.client.nworkers) > 1)
        if speculate:
            for lk in sub.ps_lookups:
                if self.caches.get(lk.inputs[0].id) is not None:
                    continue      # host cache: stateful, pulled inline
                idx = host_feeds.get(lk.inputs[1])
                if idx is None:
                    continue      # ids on the device: pulled inline
                pulls[lk] = self._spec_pull(
                    lk.inputs[0].id, np.asarray(idx),
                    int(lk.inputs[0].shape[-1]))
            for op in sub.ps_pull_ops:
                idx = host_feeds.get(op.inputs[0])
                if idx is None:
                    continue
                pulls[op] = self._spec_pull(
                    op.parameter.id, np.asarray(idx),
                    int(op.parameter.shape[-1]))
        return {"feed_map": feed_map, "host_feeds": host_feeds,
                "pulls": pulls}

    def _spec_pull(self, tid, idx, width):
        """One speculative (deduplicated) SparsePull, with what is needed
        to revalidate and reassemble it at consumption time."""
        _check_ids(idx, None, "PS speculative pull")
        hm = self.config.health_monitor
        if hm is not None:
            hm.observe_ids(tid, idx)     # hot-key skew (ingest worker)
        with self._phase("prefetch"):
            uniq, inv = np.unique(idx.ravel(), return_inverse=True)
            rows = self.client.sparse_pull(tid, uniq, width)
        return {"tid": tid, "width": width, "uniq": uniq, "inv": inv,
                "shape": tuple(idx.shape), "rows": rows}

    def _settle_spec_pull(self, spec, dirty):
        """Speculative rows -> the device feed, pulling again the rows
        whose ids were pushed after the prep was issued."""
        tid, rows = spec["tid"], spec["rows"]
        d = (dirty or {}).get(tid)
        if d:
            stale = np.isin(spec["uniq"],
                            np.fromiter(d, dtype=np.int64, count=len(d)))
            if stale.any():
                with self._phase("repull"):
                    self._flush_pushes(tid)
                    rows[stale] = self.client.sparse_pull(
                        tid, spec["uniq"][stale], spec["width"])
        full = rows[spec["inv"]].reshape(spec["shape"] + (spec["width"],))
        return self._put(full)

    def _flush_pushes(self, tid):
        """Block until every submitted push that could touch ``tid`` has
        reached the server."""
        for f in self._pending_push:
            f.result()
        self._pending_push.clear()
        self.client.wait(tid)
        self._inflight_pushed.pop(tid, None)

    # ------------------------------------------------------------------
    def run_stream_pipelined(self, sub, blocks,
                             convert_to_numpy_ret_vals=False,
                             lookahead=2, sink=None):
        """Per-step execution for host-path PS and BSP streams with the
        host phase of steps i+1..i+lookahead (feed transfer and
        speculative SparsePull, :meth:`prep_step`) on the ingest worker
        while step i runs. Push and barrier order is untouched and the
        speculative pulls revalidate against each push, so the numbers
        equal a synchronous :meth:`run_step` loop. Returns the last
        block's per-step results (the run_batches contract)."""
        from ..dataloader import GNNDataLoaderOp

        spec_tids = frozenset(
            lk.inputs[0].id for lk in sub.ps_lookups
            if lk.inputs[0].id not in self.caches) | frozenset(
            op.parameter.id for op in sub.ps_pull_ops)

        def step_stream():
            for block in blocks:
                n = len(block)
                for si, fd in enumerate(block):
                    yield fd, si == n - 1

        def fetch_dl():
            # dataloaders advance state: fetched in step order here; the
            # worker only transfers
            out = {dl: dl.get_arr(sub.name) for dl in sub.dataloader_ops
                   if not isinstance(dl, GNNDataLoaderOp)}
            return out or None

        it = enumerate(step_stream())
        first = next(it, None)
        if first is None:
            return None
        engine = IngestEngine(self.config.telemetry, lookahead=lookahead,
                              name="ps-ingest", sink=sink)
        pending = deque()    # (fd, block_end, dirty) aligned with engine
        self._track_push_tids = spec_tids or None
        out, block_out = None, []
        try:
            with engine:

                def refill():
                    # a low-reuse id stream grows the in-flight seed
                    # without tripping a re-pull (which flushes it):
                    # past a bound, settle the pushes now
                    for t in [t for t, s in self._inflight_pushed.items()
                              if len(s) > 4096]:
                        self._flush_pushes(t)
                    while engine.depth < lookahead:
                        nxt = next(it, None)
                        if nxt is None:
                            return
                        i, (fd, block_end) = nxt
                        # ids whose ASP pushes are still in flight: this
                        # prep's pull races them
                        seed = {t: set(s) for t, s
                                in self._inflight_pushed.items() if s}
                        pending.append((fd, block_end, seed))
                        engine.submit(self.prep_step, sub, fd, fetch_dl(),
                                      tag=i)

                _, (fd, block_end) = first
                # settle pushes of earlier run() steps: they predate the
                # tracking
                for tid in spec_tids:
                    self._flush_pushes(tid)
                pre = self.prep_step(sub, fd, fetch_dl())   # priming
                dirty = {}
                refill()
                tel = self.config.telemetry
                while fd is not None:
                    # a step window of its own (this path runs per step,
                    # under no Executor.run span); the engine.pop wait
                    # lands inside it
                    with tel.span("step", subgraph=sub.name,
                                  pipelined=True) \
                            if tel.enabled else _telemetry._NULL_SPAN:
                        res = self.run_step(sub, fd,
                                            convert_to_numpy_ret_vals,
                                            prepped=pre, dirty=dirty)
                        block_out.append(res)
                        if block_end:
                            out, block_out = block_out, []
                        pushed = self._last_pushed
                        if pushed:
                            # this step's pushes dirty every in-flight
                            # prep
                            for _fd, _be, d in pending:
                                for tid, ids in pushed.items():
                                    d.setdefault(tid, set()).update(ids)
                        if pending:
                            fd, block_end, dirty = pending.popleft()
                            _, pre = engine.pop()
                            refill()
                        else:
                            fd = None
        finally:
            self._track_push_tids = None
            self._last_pushed = {}
            self._inflight_pushed = {}
        return out

    # ------------------------------------------------------------------
    def ingest_feeds(self, sub, feed_dicts, dl_host=None):
        """Stack and transfer a block's plain feeds (the stateless part
        of run_block's host phase, safe on the ingest worker) and, when
        the caller fetched them in block order, its dataloader batches
        (``dl_host``: {dl: [per-step host arrays]}). Returns the
        {node: (stacked, tiled)} map run_block accepts as
        ``pre_ingested``."""
        out = {}
        for node in (feed_dicts[0] or {}):
            if node not in sub.topo_set:
                continue     # raw ids replaced by the slots feed
            out[node] = sub._stack_feed([fd[node] for fd in feed_dicts])
        for dl, arrs in (dl_host or {}).items():
            out[dl] = sub._stack_feed(arrs)
        return out

    def run_block(self, sub, feed_dicts, convert_to_numpy_ret_vals=False,
                  pre_ingested=None):
        """``len(feed_dicts)`` steps of a device-cached graph: the slots
        of every step are assigned up front (misses are filled before
        the block; pins hold for the whole block, so no row a step of
        the block touches is evicted), feeds are stacked into one
        transfer each, and the steps run one after another — the
        reference's scan block, unrolled. Host-path PS graphs and BSP
        (whose barrier is per step) run step by step. ``pre_ingested``
        (from :meth:`ingest_feeds`, possibly on the ingest worker) skips
        the in-line stacking."""
        if (sub.ps_lookups or sub.ps_pull_ops or sub.ps_ops
                or self.config.bsp):
            return [self.run_step(sub, fd, convert_to_numpy_ret_vals)
                    for fd in feed_dicts]
        from ..dataloader import DataloaderOp, GNNDataLoaderOp
        executor = self.executor
        nsteps = len(feed_dicts)
        cached = self._cached_for(sub)
        self._swap_dense_ready()

        with self._phase("feed_ingest"):
            feed_map = dict(pre_ingested if pre_ingested is not None
                            else self.ingest_feeds(sub, feed_dicts))
        for dl in sub.dataloader_ops:
            if dl not in feed_map:
                feed_map[dl] = sub._stack_feed(
                    [dl.get_arr(sub.name) for _ in range(nsteps)])

        # per-step ids, fetched once per source (a dataloader shared by
        # two cached tables advances once per step)
        ids_block = {}
        for rt, ids_node, slots_node in cached:
            if ids_node in ids_block:
                continue
            rows = []
            for fd in feed_dicts:
                if ids_node in fd:
                    rows.append(np.asarray(fd[ids_node]))
                elif isinstance(ids_node, (DataloaderOp, GNNDataLoaderOp)):
                    rows.append(np.asarray(ids_node.get_arr(sub.name)))
                else:
                    raise RuntimeError(
                        "device-cached lookup needs host ids per step")
            ids_block[ids_node] = rows

        note = []
        hm = self.config.health_monitor
        for rt, ids_node, slots_node in cached:
            # one assignment for the whole block: the residency set of
            # per-step assigns with pins held (assign_block)
            with self._phase("slot_assign"):
                ids_stacked = np.stack(ids_block[ids_node])
                _check_ids(ids_stacked, rt.rows, "device-cached lookup")
                if hm is not None:
                    hm.observe_ids(rt.tid, ids_stacked)
                slots_full, miss_ids, miss_slots, uniq_slots, counts = \
                    rt.assign_block(
                        ids_stacked,
                        functools.partial(self._drain_device_table, rt,
                                          wait=True))
            if len(miss_ids):
                self._fill_misses(rt, miss_ids, miss_slots)
            if rt.nworkers > 1:
                # bounded-staleness refresh before the block
                with self._phase("refresh"):
                    uniq_ids = rt.id_of[uniq_slots]
                    fill_slots, fill_rows = rt.stale_check(uniq_ids,
                                                           uniq_slots)
                    if fill_slots is not None:
                        executor.params[rt.cache_sid] = pad_fill(
                            executor.params[rt.cache_sid], fill_slots,
                            fill_rows, self._staging)
            with self._phase("slot_assign"):
                feed_map[slots_node] = (sub._ingest(slots_full,
                                                    staged=True), False)
                if sub.training:
                    note.append((rt, uniq_slots, counts))

        results, health = [], []
        step0 = sub.step_count
        with self._phase("dispatch"):
            for k in range(nsteps):
                step_feeds = {node: value if tiled else value[k]
                              for node, (value, tiled) in feed_map.items()}
                outputs, _ = sub.step(executor, step_feeds)
                results.append(outputs)
                if sub._last_health is not None:
                    health.append(sub._last_health)
                    sub._last_health = None
        if health:
            # the block's sampled steps, checked from one stacked fetch
            # (the reference's scan stacks every step's sentinels)
            hm.after_block(sub, dict(health[0], values=torch.stack(
                [h["values"] for h in health])), step0, nsteps,
                runtime=self)

        stepped_tables = set()
        for rt, uniq_slots, counts in note:
            rt.note_update(uniq_slots, counts)
            stepped_tables.add(rt)
        for rt, _, _ in cached:
            rt.release_pins()
        for rt in stepped_tables:
            for _ in range(nsteps):
                rt.note_step()
            if rt.steps_since_drain >= rt.push_bound:
                self._drain_device_table(rt)
        if self.config.ps_dense_cached and sub.training:
            self._dense_steps += nsteps
            if self._dense_steps >= max(1, self.config.cache_bound):
                self._drain_dense_cached(max(1, self.client.nworkers))
        return [sub.results(out, convert_to_numpy_ret_vals)
                for out in results]

    # ------------------------------------------------------------------
    def _claim_dirty(self, rt):
        """Claim a table's dirty rows: gather their accumulated sums and
        zero them on the step's stream, and start the copy to the host.
        Returns ``(ids, upds, staged rows, n)`` or None."""
        slots, ids, upds = rt.take_dirty()
        if not len(slots):
            return None
        state = self.executor.state[rt.cache_sid]
        acc, staged, n = pad_gather_zero(state["acc"], slots,
                                         self._staging,
                                         compress=rt.drain_compress)
        self.executor.state[rt.cache_sid] = {"acc": acc}
        rt.pushed_rows += n
        return ids, upds, staged, n

    def _drain_device_table(self, rt, wait=False):
        """Drain one device table's gradient accumulator to the server:
        the claim runs here, the readback and PushEmbedding on the push
        pool. ``wait=True`` (BSP, a dirty eviction) blocks until the push
        reached the server."""
        fut = rt._drain_future
        if fut is not None:
            if not fut.done() and not wait:
                return              # the previous drain is in flight
            fut.result()
            rt._drain_future = None
        with self._phase("drain_submit"):
            claim = self._claim_dirty(rt)
            if claim is None:
                return
            ids, upds, staged, n = claim
            rt._inflight_ids = ids

            def push():
                rows = host_rows(staged)[:n]
                if rt.nworkers > 1:
                    rows = rows / rt.nworkers
                self.client.push_embedding(rt.tid, ids, rows, upds,
                                           rt.width)
                self.client.wait(rt.tid)

            if self._push_pool is not None and not wait:
                rt._drain_future = self._push_pool.submit(push)
            else:
                push()

    def _push_sync_device_table(self, rt, uniq_ids, uniq_slots):
        """Fold a due drain into the staleness refresh: one
        kPushSyncEmbedding per shard applies the push and returns the
        refreshed rows."""
        fut = rt._drain_future
        if fut is not None:
            fut.result()
            rt._drain_future = None
        claim = self._claim_dirty(rt)
        if claim is None:
            return rt.stale_check(uniq_ids, uniq_slots)
        ids, upds, staged, n = claim
        rows = host_rows(staged)[:n]
        return rt.push_sync(ids, rows, upds, uniq_ids, uniq_slots)

    def _drain_dense_cached(self, nworkers, wait=False):
        """Drain the dense HET accumulators: each is replaced by zeros
        and its sum copied to the host, then pushed through the server
        optimizer on the push pool. Multi-worker, the server value is
        pulled back and swapped in at the next step."""
        fut = self._dense_future
        if fut is not None:
            if not fut.done() and not wait:
                return
            fut.result()
            self._dense_future = None
        executor = self.executor
        staged, params = {}, {}
        for param, _opt in self.config.ps_dense_cached:
            sid = str(param.id)
            st = executor.state.get(sid)
            if st is None:
                continue
            # the old sum is no longer written: the step adds into the
            # new zeros from now on
            staged[sid] = to_host_async(st["acc"])
            executor.state[sid] = {"acc": torch.zeros_like(st["acc"])}
            params[sid] = param
        if not staged:
            return
        self._dense_steps = 0

        def cycle():
            for sid, s in staged.items():
                grad = host_rows(s).ravel()
                if nworkers > 1:
                    grad = grad / nworkers
                self.client.push(params[sid].id, grad)
            ready = {}
            for sid, param in params.items():
                self.client.wait(param.id)
                if nworkers > 1:
                    ready[sid] = (param, self.client.pull(
                        param.id, (int(np.prod(param.shape)),)))
            if ready:
                with self._dense_mu:
                    self._dense_ready = ready

        if self._push_pool is not None and not wait:
            self._dense_future = self._push_pool.submit(cycle)
        else:
            cycle()

    # ------------------------------------------------------------------
    def _push_sparse(self, param, staged, nworkers):
        """Push one IndexedSlices gradient (on the push thread under
        ASP, inline otherwise); ``staged`` holds its indices' and
        values' copies to the host."""
        width = int(param.shape[-1])
        idx_host, idx_done = staged[0]
        if idx_done is not None:
            idx_done.synchronize()
        idx = idx_host.numpy().ravel()
        vals = host_rows(staged[1]).reshape(idx.size, width)
        if nworkers > 1:
            vals = vals / nworkers
        cache = self.caches.get(param.id)
        if cache is not None:
            cache.embedding_update(idx, vals)
        else:
            self.client.sparse_push(param.id, idx, vals, width)

    def _drain_done(self):
        still = []
        for f in self._pending_push:
            if f.done():
                f.result()          # surface push-thread exceptions
            else:
                still.append(f)
        self._pending_push = still

    def drain(self):
        """Block until every in-flight push (ASP sparse pushes,
        device-cache drains, dense cycles) has reached the server; over
        several workers the dense HET weights then hold the server's
        value as the last cycle read it. If the servers were already
        shut down, pending updates are dropped and ``updates_dropped``
        is set."""
        if getattr(self.client, "servers_down", False):
            self.updates_dropped = True
            print("[hetu-ps] drain skipped: servers already shut down",
                  file=sys.stderr)
            return
        for rt in self.device_tables.values():
            self._drain_device_table(rt, wait=True)
        if self.config.ps_dense_cached:
            self._drain_dense_cached(max(1, self.client.nworkers),
                                     wait=True)
        if self._dense_future is not None:
            self._dense_future.result()
            self._dense_future = None
        # several workers: the dense HET weights take the values the
        # cycle pulled back now, not at the next step
        self._swap_dense_ready()
        for f in self._pending_push:
            f.result()
        self._pending_push.clear()
        self.client.wait_all()

    def close(self):
        """Teardown drain: pending ASP pushes are not dropped when a
        script ends without save(); exceptions of queued pushes raise
        here."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self._atexit)
        self.drain()
        if self._push_pool is not None:
            # after drain() the workers are idle; after a shutdown of
            # the servers a push may be wedged in an RPC retry: cancel
            # and abandon the daemon worker instead
            ok = self._push_pool.shutdown(
                wait=not self.updates_dropped,
                cancel_futures=self.updates_dropped, timeout=30.0)
            if not self.updates_dropped and not ok:
                print("[hetu-ps] close(): push worker still busy after "
                      "the shutdown timeout; abandoning the daemon "
                      "worker", file=sys.stderr)

    def _atexit(self):
        try:
            self.close()
        except Exception as e:                       # noqa: BLE001
            print(f"[hetu-ps] teardown drain failed: {e}", file=sys.stderr)

    def reset_phase_times(self):
        """Zero the phase counters (exclude warm-up from a breakdown)."""
        with self._times_mu:
            for k in self.times:
                self.times[k] = 0.0

    def phase_breakdown(self):
        """Accumulated host seconds per phase, and each device table's
        cache counters under ``cache_perf``."""
        with self._times_mu:
            out = dict(self.times)
        for rt in self.device_tables.values():
            out.setdefault("cache_perf", {})[rt.table_node.name] = rt.perf
        return out

    def save(self, path):
        self.drain()
        if self.updates_dropped:
            raise RuntimeError(
                "PS save() after the servers were shut down: pending "
                "updates were dropped, a checkpoint now would hold stale "
                "server values (save before shutting the servers down)")
        for cache in self.caches.values():
            cache.flush()       # pending gradients reach the server first
        for tid in sorted(self.registered):
            self.client.save_param(tid, os.path.join(path, f"ps_{tid}.bin"))

    def load(self, path):
        """Load the server's tensors from ``save``'s ``ps_<id>.bin``
        files, by tensor id when the files hold every tensor of this
        session (a session that registered none, such as a serving one,
        loads nothing). Tensor ids are node ids, which differ between
        graphs (and between this package and ``hetu_tpu``): otherwise
        files and tensors are matched in creation order — ascending id
        against ascending id, as ``load_state`` matches op state — and a
        different count raises."""
        # flush pending updates first: the checkpoint supersedes them,
        # and invalidate() refuses to drop undrained rows
        self.drain()
        theirs = sorted(int(f[3:-4]) for f in os.listdir(path)
                        if f.startswith("ps_") and f.endswith(".bin"))
        mine = sorted(self.registered)
        if set(mine) <= set(theirs):
            theirs = mine           # the same graph: by id
        elif len(theirs) != len(mine):
            raise ValueError(
                f"checkpoint {path} holds {len(theirs)} PS tensors "
                f"({theirs}); this session has {len(mine)} ({mine})")
        for tid, src in zip(mine, theirs):
            rc = self.client.load_param(
                tid, os.path.join(path, f"ps_{src}.bin"))
            if rc != 0:
                raise RuntimeError(f"LoadParam({tid}) from ps_{src}.bin "
                                   f"failed: {rc}")
        # cached rows predate the load: they refill on the next lookups
        for rt in self.device_tables.values():
            rt.invalidate()
        # dense HET params keep a worker-local copy that one worker never
        # pulls back: refresh it from the server, and zero the sums the
        # checkpoint supersedes
        executor = self.executor
        for param, _opt in self.config.ps_dense_cached:
            sid = str(param.id)
            value = self.client.pull(param.id, (int(np.prod(param.shape)),))
            if sid in executor.params:
                executor.params[sid] = self._put(value, param.shape)
            st = executor.state.get(sid)
            if st is not None:
                executor.state[sid] = {"acc": torch.zeros_like(st["acc"])}


def _is_loader(node):
    from ..dataloader import DataloaderOp, GNNDataLoaderOp
    return isinstance(node, (DataloaderOp, GNNDataLoaderOp))
