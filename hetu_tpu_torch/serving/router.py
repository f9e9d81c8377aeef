"""Replica routing over N serving backends, driven by the SLO probe.

A copy of ``hetu_tpu/serving/router.py`` (pure host code). Two pieces:

* :class:`SLOWindow` — the rolling (ok, latency_ms) window behind the
  ``/healthz`` SLO probe, shared by the router, the HTTP frontend and
  the continuous-batching engine: p99 latency over the window against
  ``slo_p99_ms``, error rate against ``slo_error_rate``.
* :class:`ReplicaRouter` — a thin router over N replica backends
  (anything with ``submit(...) -> Future``: a
  :class:`~hetu_tpu_torch.serving.scheduler.ContinuousBatchingEngine`,
  a :class:`~hetu_tpu_torch.serving.batcher.MicroBatcher`, ...). Each
  submit goes to the healthy replica with the fewest in-flight requests
  (round-robin on ties); completion latency and errors feed that
  replica's window, so a degraded replica drains itself out of the
  rotation. When EVERY replica is breached the router sheds load:
  :class:`RouterOverloaded` — a fast 503, not a slow timeout.

A replica that exposes its own ``health()`` (the engine, an HTTP
frontend) is consulted in preference to the router's outside view —
the replica knows about queue pressure the router can't see.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from .. import telemetry as _telemetry
from . import lifecycle as _lifecycle

__all__ = ["SLOWindow", "ReplicaRouter", "RouterOverloaded"]


class RouterOverloaded(RuntimeError):
    """Every replica is breaching its SLO — the request is shed, not
    queued behind a fleet-wide stall."""


class SLOWindow:
    """Rolling window of request outcomes + the SLO breach verdict.

    ``note(ok, ms, ttft_ms=None)`` records one request; ``health()``
    returns ``(healthy, reason)`` — healthy whenever no SLO is
    configured or the window is empty, breached when the windowed error
    rate exceeds ``error_rate``, the windowed p99 of
    successful-request latency exceeds ``p99_ms``, or the windowed p99
    of time-to-first-token exceeds ``ttft_p99_ms``. Requests noted
    without a TTFT don't count toward the TTFT percentile.
    Thread-safe."""

    def __init__(self, p99_ms=None, error_rate=None, window=128,
                 ttft_p99_ms=None):
        self.p99_ms = p99_ms
        self.error_rate = error_rate
        self.ttft_p99_ms = ttft_p99_ms
        # (ok, latency_ms, ttft_ms-or-None)
        self._window = deque(maxlen=int(window))
        self._lock = threading.Lock()

    def note(self, ok, ms, ttft_ms=None):
        with self._lock:
            self._window.append(
                (bool(ok), float(ms),
                 None if ttft_ms is None else float(ttft_ms)))

    def health(self):
        """(healthy, reason) under the configured SLOs."""
        if self.p99_ms is None and self.error_rate is None \
                and self.ttft_p99_ms is None:
            return True, "ok"
        with self._lock:
            window = list(self._window)
        if not window:
            return True, "ok (no traffic)"
        if self.error_rate is not None:
            rate = sum(1 for ok, _, _ in window if not ok) / len(window)
            if rate > self.error_rate:
                return False, (f"error rate {rate:.3f} > SLO "
                               f"{self.error_rate:.3f} over "
                               f"{len(window)} requests")
        if self.p99_ms is not None:
            lats = [ms for ok, ms, _ in window if ok]
            if lats:
                p99 = float(np.percentile(lats, 99))
                if p99 > self.p99_ms:
                    return False, (f"serve_latency_ms p99 {p99:.1f} > "
                                   f"SLO {self.p99_ms:.1f} over "
                                   f"{len(lats)} requests")
        if self.ttft_p99_ms is not None:
            ttfts = [t for ok, _, t in window if ok and t is not None]
            if ttfts:
                p99 = float(np.percentile(ttfts, 99))
                if p99 > self.ttft_p99_ms:
                    return False, (f"serve_ttft_ms p99 {p99:.1f} > "
                                   f"SLO {self.ttft_p99_ms:.1f} over "
                                   f"{len(ttfts)} requests")
        return True, "ok"


class _ReplicaState:
    __slots__ = ("replica", "window", "inflight", "routed")

    def __init__(self, replica, window):
        self.replica = replica
        self.window = window
        self.inflight = 0
        self.routed = 0

    def health(self):
        probe = getattr(self.replica, "health", None)
        if callable(probe):
            return probe()
        return self.window.health()


class ReplicaRouter:
    """Least-inflight routing over replicas, SLO-probed per replica."""

    def __init__(self, replicas, *, slo_p99_ms=None, slo_error_rate=None,
                 slo_window=128, telemetry=None, name="router"):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.telemetry = _telemetry.resolve(telemetry)
        self.name = name
        self._lock = threading.Lock()
        self._rr = 0
        self._states = [
            _ReplicaState(r, SLOWindow(slo_p99_ms, slo_error_rate,
                                       slo_window))
            for r in replicas]
        _lifecycle.register(self)   # crash-time in-flight dumps

    @property
    def replicas(self):
        return [s.replica for s in self._states]

    def stats(self):
        """Per-replica routing snapshot for ``GET /stats``: inflight /
        routed counts and the breach verdict, plus each replica's own
        ``stats()`` when it has one."""
        out = []
        for i, s in enumerate(self._states):
            ok, reason = s.health()
            entry = {"index": i, "inflight": s.inflight,
                     "routed": s.routed, "healthy": ok,
                     "reason": reason}
            sub = getattr(s.replica, "stats", None)
            if callable(sub):
                try:
                    entry["replica"] = sub()
                except Exception:   # noqa: BLE001 — introspection only
                    pass
            out.append(entry)
        return {"name": self.name, "kind": "ReplicaRouter",
                "replicas": out}

    def inflight_requests(self):
        """Fleet in-flight table: the union of every replica's
        ``inflight_requests()``, each row tagged with its replica
        index."""
        rows = []
        for i, s in enumerate(self._states):
            fn = getattr(s.replica, "inflight_requests", None)
            if not callable(fn):
                continue
            try:
                for row in fn():
                    row = dict(row)
                    row["replica"] = i
                    rows.append(row)
            except Exception:       # noqa: BLE001 — introspection only
                continue
        return rows

    def health(self):
        """(healthy, reason): healthy while ANY replica is."""
        reasons = []
        for i, s in enumerate(self._states):
            ok, reason = s.health()
            if ok:
                return True, "ok"
            reasons.append(f"replica {i}: {reason}")
        return False, "; ".join(reasons)

    def _pick(self):
        with self._lock:
            healthy = [(i, s) for i, s in enumerate(self._states)
                       if s.health()[0]]
            if not healthy:
                raise RouterOverloaded(
                    "all replicas breaching SLO — "
                    + self.health()[1])
            lo = min(s.inflight for _, s in healthy)
            tied = [(i, s) for i, s in healthy if s.inflight == lo]
            i, state = tied[self._rr % len(tied)]
            self._rr += 1
            state.inflight += 1
            state.routed += 1
            return i, state

    def submit(self, *args, **kwargs):
        """Route one request; returns the replica's Future. Raises
        :class:`RouterOverloaded` when every replica is breached.
        All arguments (``request_id=`` included) pass through to the
        chosen replica, so end-to-end tracing survives the hop."""
        i, state = self._pick()
        tel = self.telemetry
        if tel.enabled:
            tel.inc(f"{self.name}_requests")
            tel.inc(f"{self.name}_replica{i}_requests")
        t0 = time.perf_counter()
        try:
            fut = state.replica.submit(*args, **kwargs)
        except Exception:
            with self._lock:
                state.inflight -= 1
            state.window.note(False, (time.perf_counter() - t0) * 1e3)
            raise

        def _done(f):
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                state.inflight -= 1
            state.window.note(f.exception() is None, ms)
            if tel.enabled:
                tel.observe(f"{self.name}_latency_ms", ms)

        fut.add_done_callback(_done)
        return fut
