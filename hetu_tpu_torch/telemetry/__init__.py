"""Unified runtime telemetry: span tracer + metrics registry + flight
recorder.

Counterpart of ``hetu_tpu/telemetry/__init__.py``, with its surface:

* ``Telemetry.span("h2d_transfer", bytes=...)`` — thread-safe span
  context manager buffered in a bounded ring (tracer.py), exported as
  Chrome trace-event JSON per rank; ``merge_traces`` stitches per-rank
  files into ONE Perfetto-loadable timeline (rank -> pid).
* ``Telemetry.inc/observe/set_gauge`` — counters, gauges, streaming
  p50/p95/p99 histograms (metrics.py), exportable as JSONL and as a
  Prometheus text scrape (``MetricsRegistry.serve``).
* ``python -m hetu_tpu_torch.telemetry.check trace.json`` — schema
  validator (check.py), including the typed span-attr schema.
* the flight recorder (flight.py), the device-memory gauges and OOM
  report (memory.py), and the launcher's hang watchdog (watchdog.py).
* ``python -m hetu_tpu_torch.telemetry.doctor <dir>`` — the perf
  doctor: a step's wall attributed into buckets (bubble, p2p,
  collective, ps, compute, ...) with a conservation check, and its
  ``--serving`` mode per request (doctor.py).
* the fleet plane (fleet.py): per-rank step timelines, the launcher's
  ``--watch`` monitor naming a straggler, ``python -m
  hetu_tpu_torch.telemetry.fleet <dir>`` after the run.

Wiring: ``Executor(..., telemetry=...)`` threads an instance through
the executor, the PS runtime and client, the p2p channel and every
pipeline runner; ``HETU_TELEMETRY=<dir>`` (exported by the launcher's
``--telemetry``) enables the process-global default and flushes
per-rank files at exit.

Spans time host work. The port's walk is eager and asynchronous, so a
span closes when its work is issued, not when the device finishes it:
no span, gauge or histogram synchronizes the device, and a step's
values are the same with telemetry on or off.

Overhead contract: with telemetry disabled the hot path costs ONE
attribute check + a shared no-op context manager — zero per-step
allocations (tests/test_torch_telemetry.py pins it). Instrumentation
sites that would build kwargs dicts guard on ``tel.enabled`` first.

No module of this package imports torch at module level (memory.py
imports it inside its functions): the PS server process and the check
CLI load it without torch.
"""
from __future__ import annotations

import atexit
import os
import sys

from .tracer import Tracer, merge_traces
from .metrics import MetricsRegistry, uptime_gauge
from .check import validate
from .flight import FlightRecorder, install_crash_handlers

__all__ = ["Telemetry", "Tracer", "MetricsRegistry", "FlightRecorder",
           "merge_traces", "validate", "get_telemetry", "configure",
           "resolve", "from_env", "uptime_gauge", "NULL"]


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _env_rank():
    return int(os.environ.get("HETU_PROC_ID",
                              os.environ.get("HETU_PS_RANK", "0")))


class Telemetry:
    """Facade bundling one Tracer, one MetricsRegistry and one
    FlightRecorder."""

    def __init__(self, enabled=True, out_dir=None, rank=None,
                 service=None, trace_capacity=65536):
        self.enabled = bool(enabled)
        self.rank = _env_rank() if rank is None else int(rank)
        self.out_dir = out_dir
        self.service = service or f"rank{self.rank}"
        self.tracer = None
        self.metrics = None
        self.flight = None
        self._flushed_paths = []
        if self.enabled:
            self.tracer = Tracer(pid=self.rank, capacity=trace_capacity,
                                 process_name=self.service)
            self.metrics = MetricsRegistry()
            self.flight = FlightRecorder(rank=self.rank)
        if self.enabled and self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)
            atexit.register(self.flush)
            # black-box layer: SIGTERM / fatal-exception flight dumps +
            # SIGUSR1 faulthandler stacks into out_dir (flight.py); the
            # signal handlers install from the main thread only, so a
            # thread rank's executor does not fail for them
            install_crash_handlers(self)

    # -- tracing ---------------------------------------------------------
    def span(self, name, **args):
        if not self.enabled:
            return _NULL_SPAN
        return self.tracer.span(name, **args)

    def instant(self, name, **args):
        if self.enabled:
            self.tracer.instant(name, **args)

    def clock(self):
        return self.tracer.clock() if self.enabled else 0

    def complete(self, name, t0_ns, t1_ns, args=None):
        if self.enabled:
            self.tracer.complete(name, t0_ns, t1_ns, args)

    # -- metrics ---------------------------------------------------------
    def inc(self, name, n=1):
        if self.enabled:
            self.metrics.counter(name).inc(n)

    def observe(self, name, value):
        if self.enabled:
            self.metrics.histogram(name).observe(value)

    def set_gauge(self, name, value):
        if self.enabled:
            self.metrics.gauge(name).set(value)

    def counter_value(self, name):
        if not self.enabled:
            return 0
        return self.metrics.counter(name).value

    # -- flight recorder (black box; flight.py) --------------------------
    def flight_start(self, group, kind, peer=None, tag=None, nbytes=0):
        """Record an enqueued cross-rank op; returns a record to pass
        to ``flight_complete`` (None — allocation-free — when off)."""
        if not self.enabled:
            return None
        return self.flight.start(group, kind, peer=peer, tag=tag,
                                 nbytes=nbytes)

    @staticmethod
    def flight_complete(rec):
        if rec is not None:
            FlightRecorder.complete(rec)

    def flight_record(self, group, kind, peer=None, tag=None, nbytes=0):
        """One-shot already-complete event."""
        if self.enabled:
            self.flight.record(group, kind, peer=peer, tag=tag,
                               nbytes=nbytes)

    def flight_step(self, step_no):
        """Mark a completed step boundary."""
        if self.enabled:
            self.flight.step(step_no)

    def serve_metrics(self, port, host="127.0.0.1", sock=None):
        """Serve the registry's ``/metrics`` (and ``/fleet``) on ``port``,
        or on ``sock``, a listening socket claimed for it."""
        if not self.enabled:
            return None
        return self.metrics.serve(port, host=host, sock=sock)

    # -- export ----------------------------------------------------------
    def flush(self):
        """Write ``trace_rank<r>.json`` + ``metrics_rank<r>.jsonl`` (and
        the flight dump, and the serving plane's in-flight requests)
        into ``out_dir``; idempotent (atexit + explicit close both call
        it). Returns the written paths."""
        if not (self.enabled and self.out_dir):
            return []
        trace = os.path.join(self.out_dir,
                             f"trace_rank{self.rank}.json")
        self.tracer.export(trace)
        mpath = os.path.join(self.out_dir,
                             f"metrics_rank{self.rank}.jsonl")
        self.metrics.dump_jsonl(mpath)
        self._flushed_paths = [trace, mpath]
        if self.flight is not None:
            fpath = self.flight.dump(self.out_dir, reason="flush")
            if fpath:
                self._flushed_paths.append(fpath)
        # serving in-flight request tables ride beside the flight rings
        # (the crash handlers call flush(), so a stuck engine's
        # requests land in requests_rank<r>.json without extra hooks).
        # Looked up via sys.modules so a crash handler never IMPORTS the
        # serving plane — if it was never loaded, nothing is in flight.
        lifecycle = sys.modules.get("hetu_tpu_torch.serving.lifecycle")
        if lifecycle is not None:
            try:
                rpath = lifecycle.dump_inflight(self.out_dir, self.rank)
            except Exception:   # noqa: BLE001 — never mask the crash
                rpath = None
            if rpath:
                self._flushed_paths.append(rpath)
        # the fleet step timelines (same sys.modules discipline: a crash
        # handler must not import the fleet plane if nothing armed it)
        fleet = sys.modules.get("hetu_tpu_torch.telemetry.fleet")
        if fleet is not None:
            try:
                tpath = fleet.dump_current(self.out_dir)
            except Exception:   # noqa: BLE001 — never mask the crash
                tpath = None
            if tpath:
                self._flushed_paths.append(tpath)
        return self._flushed_paths


NULL = Telemetry(enabled=False)

_default = None


def from_env():
    """Process-global default from the launcher env: enabled (with
    per-rank files under ``$HETU_TELEMETRY``) when the launcher exported
    it, the shared disabled singleton otherwise."""
    out_dir = os.environ.get("HETU_TELEMETRY")
    if out_dir:
        return Telemetry(enabled=True, out_dir=out_dir)
    return NULL


def get_telemetry():
    """The process-global Telemetry (used by components without a config
    to read from: the p2p channel, the PS client)."""
    global _default
    if _default is None:
        _default = from_env()
    return _default


def configure(enabled=True, out_dir=None, rank=None, service=None):
    """Install a process-global Telemetry and return it."""
    global _default
    _default = Telemetry(enabled=enabled, out_dir=out_dir, rank=rank,
                         service=service)
    return _default


def resolve(arg=None):
    """``Executor(telemetry=...)`` argument -> Telemetry instance.

    None -> the process-global default (env-driven; disabled unless
    ``HETU_TELEMETRY`` is set). True -> enabled (env out_dir if any).
    str -> enabled with that output directory. False -> disabled.
    A Telemetry instance passes through. Enabled instances also become
    the process-global default so config-less components (p2p channel,
    PS client) attribute into the same trace.

    True/path requests REUSE an enabled default targeting the same
    out_dir instead of constructing a fresh instance: two instances
    would share trace_rank<r>.json, and their LIFO atexit flushes would
    let the OLDER executor's trace overwrite the real run's.
    """
    global _default
    if arg is None:
        return get_telemetry()
    if isinstance(arg, Telemetry):
        tel = arg
    elif arg is False:
        return NULL
    elif arg is True or isinstance(arg, (str, os.PathLike)):
        out_dir = (os.environ.get("HETU_TELEMETRY") if arg is True
                   else os.fspath(arg))
        cur = _default
        if cur is not None and cur.enabled and cur.out_dir == out_dir:
            return cur
        tel = Telemetry(enabled=True, out_dir=out_dir)
    else:
        raise TypeError(f"telemetry must be None/bool/path/Telemetry, "
                        f"got {type(arg).__name__}")
    if tel.enabled:
        _default = tel
    return tel
