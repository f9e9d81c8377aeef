"""Dynamic micro-batching (Orca/TF-Serving shape, host-side tick loop).

A copy of ``hetu_tpu/serving/batcher.py`` (pure host code: numpy feeds,
one thread, Futures). Concurrent ``submit()`` calls coalesce into ONE
forward per tick: the batcher thread claims up to ``max_batch_size``
rows, waiting at most ``max_wait_ms`` for stragglers after the first
request arrives, then concatenates the feeds along the batch dim, runs
``serve_fn`` once, and splits the outputs back per request. Requests up
to ``max_batch_size`` stay whole — their rows never split across ticks;
wider requests split server-side into adjacent chunks that resolve
through one Future. ``stats()`` also counts the ticks served and the
rows they carried, so a run can read its mean batch occupancy with
telemetry off.

Telemetry (the reference's names, behind ``telemetry.enabled``):
``<name>_queue_depth`` gauge, ``<name>_latency_ms`` histogram (submit ->
result),
``<name>_batch_size`` / ``<name>_batch_occupancy`` histograms,
``<name>_requests`` / ``<name>_batches`` counters and the fleet-level
``serve_queue_wait_ms`` histogram (submit -> tick claim).
"""
from __future__ import annotations

import collections
import functools
import threading
import time
from concurrent.futures import Future

import numpy as np

from .. import telemetry as _telemetry
from . import lifecycle as _lifecycle
from .lifecycle import mint_request_id

__all__ = ["MicroBatcher"]


def _stitch_chunks(results, n):
    """Reassemble per-chunk serve outputs into one request's view:
    row-sliced outputs (chunk first-dims summing to ``n``) concatenate
    back in chunk order; whole-batch passthrough outputs (the
    ``_serve`` non-sliceable case) are identical per chunk, so the
    first chunk's copy stands for the request."""
    single = not isinstance(results[0], (list, tuple))
    width = 1 if single else len(results[0])
    out = []
    for j in range(width):
        pieces = [r if single else r[j] for r in results]
        if all(getattr(p, "ndim", 0) for p in pieces) and \
                sum(p.shape[0] for p in pieces) == n:
            out.append(np.concatenate([np.asarray(p) for p in pieces]))
        else:
            out.append(pieces[0])
    return out[0] if single else out


class _Request:
    __slots__ = ("feeds", "n", "future", "t_submit", "rid")

    def __init__(self, feeds, n, future, rid):
        self.feeds = feeds
        self.n = n
        self.future = future
        self.t_submit = time.perf_counter()
        self.rid = rid


class MicroBatcher:
    """Coalesce concurrent requests into one forward per tick.

    ``serve_fn(feeds)`` takes ``{key: np.ndarray}`` with a shared leading
    batch dim and returns an array, or a list/tuple of arrays, each with
    that same leading dim (an ``InferenceSession.predict`` bound method
    fits directly; so does a jitted decode step)."""

    def __init__(self, serve_fn, *, max_batch_size=32, max_wait_ms=2.0,
                 telemetry=None, name="serve"):
        self.serve_fn = serve_fn
        self.max_batch_size = int(max_batch_size)
        self.max_wait = float(max_wait_ms) / 1e3
        self.telemetry = _telemetry.resolve(telemetry)
        self.name = name
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._ticks = 0         # ticks served, and the rows they carried
        self._rows = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"{name}-batcher")
        _lifecycle.register(self)   # crash-time in-flight dumps
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, feeds, request_id=None):
        """Enqueue one request (each value ``[n, ...]``); returns a
        Future resolving to ``serve_fn``'s output sliced to this
        request's rows. ``request_id`` is the end-to-end tracing id
        (minted here when the caller didn't supply one)."""
        arrays = {k: np.asarray(v) for k, v in feeds.items()}
        sizes = {v.shape[0] for v in arrays.values() if v.ndim}
        if len(sizes) != 1:
            raise ValueError(
                f"request feeds disagree on batch size: {sorted(sizes)}")
        n = sizes.pop()
        rid = str(request_id) if request_id is not None \
            else mint_request_id()
        if n > self.max_batch_size:
            # oversized requests split server-side across ticks: the
            # chunks enqueue adjacently (FIFO keeps row order), and ONE
            # combining Future stitches the per-chunk outputs back in
            # request row order
            return self._submit_split(arrays, n, rid)
        req = _Request(arrays, n, Future(), rid)
        with self._cond:
            # submit/close race contract (pinned by the racecheck
            # stress test): a submit that wins the lock before close()
            # flips _closed is queued and WILL be served by the drain
            # loop; one that loses raises here — never hangs, never
            # silently drops
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(req)
            self._set_depth()
            self._cond.notify()
        return req.future

    def _submit_split(self, arrays, n, rid):
        """Split an ``n > max_batch_size`` request into consecutive
        chunks enqueued atomically (they stay adjacent in the FIFO, so
        the rows come back in submission order even when they land in
        different ticks) and return ONE Future resolving to the stitched
        outputs. The first chunk failure fails the whole request; every
        chunk carries the parent's request id."""
        size = self.max_batch_size
        chunks = []
        for off in range(0, n, size):
            sub = {k: (v[off:off + size] if v.ndim else v)
                   for k, v in arrays.items()}
            chunks.append(_Request(sub, min(size, n - off), Future(),
                                   rid))
        combined = Future()
        state_lock = threading.Lock()
        pending = [len(chunks)]
        results = [None] * len(chunks)

        def _done(i, fut):
            with state_lock:
                exc = fut.exception()
                if exc is not None:
                    if not combined.done():
                        combined.set_exception(exc)
                    return
                results[i] = fut.result()
                pending[0] -= 1
                if pending[0] == 0 and not combined.done():
                    try:
                        combined.set_result(_stitch_chunks(results, n))
                    except Exception as e:          # noqa: BLE001
                        combined.set_exception(e)

        with self._cond:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.extend(chunks)
            self._set_depth()
            self._cond.notify_all()
        if self.telemetry.enabled:
            self.telemetry.inc(f"{self.name}_split_requests")
        for i, req in enumerate(chunks):
            req.future.add_done_callback(functools.partial(_done, i))
        return combined

    def _set_depth(self):
        if self.telemetry.enabled:
            self.telemetry.set_gauge(f"{self.name}_queue_depth",
                                     len(self._queue))

    # ------------------------------------------------------------------
    def _take_tick(self):
        """Block for the next tick's requests (None = closed + drained)."""
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                self._cond.wait()
            # the wait budget runs from the FIRST request's submit, not
            # from when this thread got around to looking — a request
            # that already queued behind a slow tick must not wait the
            # full max_wait again
            deadline = self._queue[0].t_submit + self.max_wait
            batch, total = [], 0
            keys = frozenset(self._queue[0].feeds)
            try:
                while True:
                    while self._queue and \
                            frozenset(self._queue[0].feeds) == keys and \
                            (not batch
                             or total + self._queue[0].n
                             <= self.max_batch_size):
                        req = self._queue.popleft()
                        batch.append(req)
                        total += req.n
                    if total >= self.max_batch_size or self._closed:
                        break
                    if self._queue:
                        # head doesn't fit, or carries a DIFFERENT
                        # feed-key set (coalescing it would drop its
                        # extra keys): it starts the next tick
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            except BaseException:
                # crash mid-coalesce (e.g. an interrupt landing in the
                # straggler wait): put the claimed requests back so
                # _loop's crash handler fails THEIR futures too instead
                # of stranding them in this frame's local
                self._queue.extendleft(reversed(batch))
                raise
            self._set_depth()
            return batch

    def _loop(self):
        batch = None
        try:
            while True:
                batch = self._take_tick()
                if batch is None:
                    return
                self._serve(batch)
                batch = None
        except BaseException as e:      # noqa: BLE001 — tick machinery died
            # _serve guards serve_fn, but a crash in the tick machinery
            # itself (or a KeyboardInterrupt landing on this thread)
            # must not strand every queued/future submit in a silent
            # hang: refuse new requests and fail the queued ones AND
            # the in-flight batch already popped off the queue
            with self._cond:
                self._closed = True
                pending = list(self._queue)
                self._queue.clear()
                self._cond.notify_all()
            for r in (batch or []) + pending:
                if not r.future.done():
                    r.future.set_exception(
                        RuntimeError(f"batcher thread died: {e!r}"))
            raise

    def _serve(self, batch):
        # queue wait ends when the tick claims the batch — measured
        # before serve_fn so it carries coalescing/straggler wait only,
        # the same serve_queue_wait_ms bucket the engine records (the
        # serving A/B compares like-for-like)
        t_claim = time.perf_counter()
        # the WHOLE tick is guarded: a malformed request (ragged trailing
        # dims, mismatched feed keys) must fail that tick's futures, not
        # kill the batcher thread and strand every later submit
        try:
            keys = list(batch[0].feeds)
            feeds = {k: (np.concatenate([r.feeds[k] for r in batch])
                         if len(batch) > 1 else batch[0].feeds[k])
                     for k in keys}
            outs = self.serve_fn(feeds)
        except Exception as e:                          # noqa: BLE001
            for r in batch:
                r.future.set_exception(e)
            return
        single = not isinstance(outs, (list, tuple))
        outs = [outs] if single else list(outs)
        total = sum(r.n for r in batch)
        off = 0
        now = time.perf_counter()
        tel = self.telemetry
        try:
            for r in batch:
                sl = [o[off:off + r.n]
                      if getattr(o, "ndim", 0) and o.shape[0] >= total
                      else o for o in outs]
                r.future.set_result(sl[0] if single else sl)
                off += r.n
                if tel.enabled:
                    tel.observe(f"{self.name}_latency_ms",
                                (now - r.t_submit) * 1e3)
                    tel.observe("serve_queue_wait_ms",
                                (t_claim - r.t_submit) * 1e3)
        except Exception as e:                          # noqa: BLE001
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        with self._cond:
            self._ticks += 1
            self._rows += total
        if tel.enabled:
            tel.inc(f"{self.name}_requests", len(batch))
            tel.inc(f"{self.name}_batches")
            tel.observe(f"{self.name}_batch_size", total)
            tel.observe(f"{self.name}_batch_occupancy",
                        total / self.max_batch_size)

    # ------------------------------------------------------------------
    def inflight_requests(self):
        """Live in-flight table (``GET /v1/requests`` and the
        crash-dump ``requests_rank<r>.json``): queued requests with id,
        row count, and age."""
        now = time.perf_counter()
        with self._cond:
            snap = list(self._queue)
        return [{"request_id": r.rid, "phase": "waiting", "rows": r.n,
                 "age_ms": round((now - r.t_submit) * 1e3, 3)}
                for r in snap]

    def stats(self):
        """One batcher snapshot for ``GET /stats``: also the ticks served,
        the rows they carried and their mean occupancy (rows over
        ``max_batch_size``, None before the first tick)."""
        with self._cond:
            waiting = len(self._queue)
            ticks, rows = self._ticks, self._rows
        return {"name": self.name, "kind": "MicroBatcher",
                "waiting": waiting,
                "max_batch_size": self.max_batch_size,
                "max_wait_ms": self.max_wait * 1e3,
                "ticks": ticks, "rows": rows,
                "mean_batch_occupancy": rows / (ticks * self.max_batch_size)
                if ticks else None}

    # ------------------------------------------------------------------
    def close(self):
        """Stop accepting requests, serve what's queued, join the
        thread. Idempotent; safe to race with submit() — see the
        contract note there."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()
        # belt-and-braces: if the loop died (crash path above) between
        # a submit and its tick, nothing serves the leftovers — fail
        # them instead of letting .result() hang forever
        with self._cond:
            leftover = list(self._queue)
            self._queue.clear()
        for r in leftover:
            if not r.future.done():
                r.future.set_exception(RuntimeError("batcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
