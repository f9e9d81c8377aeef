"""Async host ingest: hide the host behind the device.

Counterpart of ``hetu_tpu/ingest.py``: :class:`OverlapOptions` (the
ingest switch, the lookahead depth and ``bucket_bytes``),
:class:`IngestEngine` (one ordered background worker and a bounded
queue of pending jobs; consumers measure their stall on :meth:`pop`),
:class:`DaemonPool` (a ``submit`` / ``shutdown`` pool over daemon
threads whose join is bounded, so a job wedged in an RPC never hangs
teardown), :func:`on_worker` and the stats helpers.

The port adds :func:`to_device`, the one host-to-device copy of the
ingest paths: on a CUDA device the array is staged in pinned memory
and copied with ``non_blocking`` on a side stream, fenced by an event.
A job on the engine's worker thus copies the next block's feeds while
the device runs the current one.

Error contract: a failing ingest job surfaces as :class:`IngestError`
naming the offending block index, and an error anywhere in the stream
cancels the not-yet-started jobs instead of waiting them out.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future

import numpy as np
import torch

__all__ = ["OverlapOptions", "IngestEngine", "IngestError", "DaemonPool",
           "on_worker", "overlap_fraction", "new_stats", "merge_stats",
           "stats_fields", "to_device"]

_worker_local = threading.local()


def on_worker():
    """True when the calling thread is an IngestEngine worker — used to
    mark transfers/pulls issued by the lookahead as ``overlapped``."""
    return getattr(_worker_local, "active", False)


class OverlapOptions:
    """The reference's ``Executor(overlap_options=...)`` knobs.

    ``ingest``       — master switch for the async ingest engine
                       (default True; False makes every
                       ``run_batches_stream`` path synchronous).
    ``lookahead``    — how many blocks (block paths) or steps
                       (pipelined host-path PS) of host work stay in
                       flight ahead of the device. Default 2.
    ``bucket_bytes`` — gradient-allreduce bucketing on the data-parallel
                       path, which the port does not have yet: only
                       None (the default) is accepted by the executor.
    """

    __slots__ = ("ingest", "lookahead", "bucket_bytes")
    _DEFAULTS = {"ingest": True, "lookahead": 2, "bucket_bytes": None}

    def __init__(self, ingest=True, lookahead=2, bucket_bytes=None):
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        if bucket_bytes is not None and int(bucket_bytes) <= 0:
            raise ValueError(
                f"bucket_bytes must be a positive byte count or None, "
                f"got {bucket_bytes}")
        self.ingest = bool(ingest)
        self.lookahead = int(lookahead)
        self.bucket_bytes = None if bucket_bytes is None \
            else int(bucket_bytes)

    @classmethod
    def resolve(cls, arg):
        """None / dict / OverlapOptions -> OverlapOptions (validated)."""
        if arg is None:
            return cls()
        if isinstance(arg, cls):
            return arg
        if not isinstance(arg, dict):
            raise TypeError(
                f"overlap_options must be a dict or OverlapOptions, got "
                f"{type(arg).__name__}")
        unknown = set(arg) - set(cls._DEFAULTS)
        if unknown:
            raise ValueError(
                f"unknown overlap_options keys {sorted(unknown)}; "
                f"expected {sorted(cls._DEFAULTS)}")
        kw = dict(cls._DEFAULTS)
        kw.update(arg)
        return cls(**kw)

    def __repr__(self):
        return (f"OverlapOptions(ingest={self.ingest}, "
                f"lookahead={self.lookahead}, "
                f"bucket_bytes={self.bucket_bytes})")


class IngestError(RuntimeError):
    """An async ingest job failed; names the block/step it belonged
    to."""

    def __init__(self, tag, cause):
        self.tag = tag
        super().__init__(
            f"async ingest of block {tag} failed: "
            f"{type(cause).__name__}: {cause}")


def new_stats():
    """Fresh per-executor ingest accounting (wait/busy milliseconds)."""
    return {"wait_ms": [], "busy_ms": 0.0, "pops": 0}


def merge_stats(sink, wait_ms=None, busy_ms=0.0, pops=0):
    if sink is None:
        return
    if wait_ms:
        sink["wait_ms"].extend(wait_ms)
    sink["busy_ms"] += busy_ms
    sink["pops"] += pops


def overlap_fraction(wait_ms_sum, busy_ms_sum):
    """Share of host ingest time hidden behind the device: the worker
    was busy ``busy_ms_sum`` while the consumer only stalled
    ``wait_ms_sum`` — 1.0 means the device never waited for the host,
    0.0 means fully serialized (or nothing to overlap)."""
    if busy_ms_sum <= 0.0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - wait_ms_sum / busy_ms_sum))


def stats_fields(stats):
    """Bench/metric fields from a ``new_stats`` accumulator."""
    wait = stats["wait_ms"]
    p50 = float(np.percentile(wait, 50)) if wait else 0.0
    return {
        "ingest_wait_ms": round(p50, 3),
        "ingest_wait_ms_sum": round(float(sum(wait)), 3),
        "ingest_busy_ms_sum": round(stats["busy_ms"], 3),
        "overlap_fraction": round(
            overlap_fraction(sum(wait), stats["busy_ms"]), 4),
    }


class DaemonPool:
    """Tiny ``submit()``/``shutdown()`` pool over **daemon** threads.

    Why not ``ThreadPoolExecutor``: its workers are non-daemon and
    ``concurrent.futures`` joins every one of them at interpreter exit.
    A worker wedged in a blocking job — a PS push retrying against a
    dead server, an ingest job stuck in ``queue.get`` — therefore hangs
    the *interpreter*, not just the owner. Here workers are daemon
    threads with a cooperative stop flag, ``shutdown(wait=True)`` bounds its join with
    a timeout, and a wedged worker is abandoned to die with the process
    instead of deadlocking teardown.

    Jobs return ``concurrent.futures.Future`` with the standard
    cancel/result/exception semantics; one worker (the default) keeps
    submission order — the IngestEngine ordering contract.
    """

    def __init__(self, max_workers=1, thread_name_prefix="hetu-pool"):
        self._jobs = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{thread_name_prefix}-{i}")
            for i in range(max(1, int(max_workers)))]
        for t in self._threads:
            t.start()

    def submit(self, fn, *args, **kwargs):
        fut = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("submit after DaemonPool.shutdown()")
            self._jobs.append((fut, fn, args, kwargs))
            self._cv.notify()
        return fut

    def _worker(self):
        while True:
            with self._cv:
                while not self._jobs:
                    if self._closed:
                        return
                    self._cv.wait()
                fut, fn, args, kwargs = self._jobs.popleft()
            if not fut.set_running_or_notify_cancel():
                continue                # cancelled while queued
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — future carries it
                fut.set_exception(e)

    def shutdown(self, wait=True, cancel_futures=False, timeout=30.0):
        """Stop the workers. ``cancel_futures`` drops queued-but-
        unstarted jobs (their futures raise CancelledError); ``wait``
        joins the workers but — unlike ThreadPoolExecutor — bounded by
        ``timeout`` per pool, so a job wedged in a blocking call can
        never deadlock teardown or interpreter exit. Returns True when
        every worker actually exited."""
        with self._cv:
            self._closed = True
            if cancel_futures:
                while self._jobs:
                    fut, _fn, _a, _kw = self._jobs.popleft()
                    fut.cancel()
            self._cv.notify_all()
        ok = True
        if wait:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            for t in self._threads:
                t.join(None if deadline is None
                       else max(0.0, deadline - time.monotonic()))
                ok = ok and not t.is_alive()
        return ok

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(cancel_futures=exc_type is not None)
        return False


class IngestEngine:
    """Ordered background ingest worker with a bounded pending queue.

    One worker thread keeps ingest jobs ordered (slot assignment and
    dataloader advancement stay deterministic); the deque holds up to
    ``lookahead`` submitted-but-unconsumed jobs so job i+lookahead
    starts the moment job i+1 finishes instead of waiting for the
    device. ``pop()`` joins the oldest job and records the consumer's
    stall; exceptions from the worker re-raise wrapped as
    :class:`IngestError` with the job's tag.
    """

    def __init__(self, telemetry=None, lookahead=2, name="ingest",
                 sink=None):
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        self.tel = telemetry
        self.lookahead = int(lookahead)
        self.name = name
        self.sink = sink
        self._pool = DaemonPool(
            max_workers=1, thread_name_prefix=f"hetu-{name}")
        self._pending = deque()
        self.wait_ms = []
        self.busy_ms = 0.0
        self._closed = False

    # -- submission ------------------------------------------------------
    def submit(self, fn, *args, tag=None):
        """Queue one ingest job; returns immediately."""
        assert not self._closed, "IngestEngine used after close()"
        fut = self._pool.submit(self._run_job, fn, args)
        self._pending.append((tag, fut))
        self._gauge()

    def _run_job(self, fn, args):
        _worker_local.active = True
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            _worker_local.active = False
            dt = (time.perf_counter() - t0) * 1000.0
            self.busy_ms += dt
            if self.tel is not None and self.tel.enabled:
                self.tel.observe("ingest_ms", dt)

    @property
    def depth(self):
        return len(self._pending)

    def _gauge(self):
        if self.tel is not None and self.tel.enabled:
            self.tel.set_gauge("ingest_queue_depth", len(self._pending))

    # -- consumption -----------------------------------------------------
    def pop(self, record_wait=True):
        """Join the oldest pending job -> (tag, result). The time spent
        blocked here is the device-waited-on-host number
        (``ingest_wait_ms``); ``record_wait=False`` skips recording for
        pipeline-fill pops that are expected to wait."""
        tag, fut = self._pending.popleft()
        self._gauge()
        tel_on = self.tel is not None and self.tel.enabled
        t0n = self.tel.clock() if tel_on else 0
        t0 = time.perf_counter()
        try:
            result = fut.result()
        except CancelledError:
            raise
        except Exception as e:              # noqa: BLE001 — re-tagged
            raise IngestError(tag, e) from e
        if record_wait:
            dt = (time.perf_counter() - t0) * 1000.0
            self.wait_ms.append(dt)
            if tel_on:
                # the stall is a first-class span, not just a histogram:
                # the doctor attributes it to the h2d_ingest bucket as
                # EXPOSED host time (it rides the consumer thread, on
                # the critical path — unlike the worker's overlapped=
                # transfers)
                self.tel.complete("ingest_wait", t0n, self.tel.clock(),
                                  {"tag": tag})
                self.tel.observe("ingest_wait_ms", dt)
        return tag, result

    # -- teardown --------------------------------------------------------
    def close(self, cancel=False):
        """Shut the worker down. ``cancel=True`` (the error path) drops
        queued-but-unstarted jobs instead of waiting them out before
        re-raising. Teardown can never deadlock on a worker
        wedged in a blocking job (``queue.get``, a PS RPC against a
        dead server): the worker is a daemon thread and the clean-path
        join is bounded, so both mid-error teardown and interpreter
        exit proceed while the wedged job dies with the process."""
        if self._closed:
            return
        self._closed = True
        ok = self._pool.shutdown(wait=not cancel, cancel_futures=cancel)
        if not cancel and not ok:
            # the bounded join expired on the CLEAN path: a job is
            # still running past the old wait-it-out guarantee — say
            # so instead of silently abandoning it mid-side-effect
            import sys
            print(f"[hetu-ingest] close(): worker '{self.name}' still "
                  f"busy after the shutdown timeout; abandoning the "
                  f"daemon worker", file=sys.stderr)
        merge_stats(self.sink, wait_ms=self.wait_ms, busy_ms=self.busy_ms,
                    pops=len(self.wait_ms))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(cancel=exc_type is not None)
        return False


_side_streams = {}
_side_lock = threading.Lock()


def _side_stream(device):
    with _side_lock:
        stream = _side_streams.get(device)
        if stream is None:
            stream = _side_streams[device] = torch.cuda.Stream(device)
        return stream


def to_device(arr, device):
    """A host array (numpy or a CPU tensor) as a tensor on ``device``.

    On the CPU the tensor shares the array's memory. On a CUDA device
    the array is staged in pinned memory, copied with ``non_blocking``
    on the device's side stream, and the caller waits on the copy's
    event, so the data is on the device when this returns; the tensor
    is then marked as used by the default stream, on which the step
    runs, so the allocator does not reuse its memory early. Torch's
    pinned allocator keeps the staging buffer until the copy's event
    has fired."""
    host = arr if isinstance(arr, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host.to(device)
    pinned = host.pin_memory()
    stream = _side_stream(device)
    with torch.cuda.stream(stream):
        out = pinned.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    out.record_stream(torch.cuda.default_stream(device))
    return out
