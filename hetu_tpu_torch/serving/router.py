"""SLO probe shared by the serving plane.

Counterpart of ``hetu_tpu/serving/router.py``; only :class:`SLOWindow`
is ported so far (``ReplicaRouter`` comes with the HTTP frontend).
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np

__all__ = ["SLOWindow"]


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
