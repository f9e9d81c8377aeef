"""Span tracer (counterpart of ``hetu_tpu/telemetry/tracer.py``, kept
as its own copy: the port imports nothing of the JAX package):
Dapper-style always-on, low-overhead tracing exported in
the Chrome trace-event format that Perfetto / chrome://tracing /
TensorBoard already render.

Design constraints (tests/test_torch_telemetry.py pins all three):

* **Thread-safe**: events append to a bounded ring from any thread;
  each thread gets its own ``tid`` in the export, so nested spans on
  one thread never interleave with another thread's.
* **Bounded**: the ring (``capacity`` events) makes tracing safe to
  leave on for a whole training run — old events fall off the back
  instead of growing host RSS.
* **Cross-process mergeable**: timestamps anchor ``perf_counter_ns``
  to the wall clock at tracer creation, so two ranks' traces (each
  exported with its own ``pid``) line up on one Perfetto timeline when
  ``merge_traces`` stitches them.
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time
from collections import deque

__all__ = ["Tracer", "merge_traces"]

_clock = time.perf_counter_ns


class _Span:
    """Context manager recording one complete ("ph":"X") event."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self._name, self._t0, _clock(), self._args)
        return False


class Tracer:
    """Bounded in-memory span recorder; one per process."""

    def __init__(self, pid=0, capacity=65536, process_name=None):
        self.pid = int(pid)
        self.process_name = process_name or f"rank{self.pid}"
        # wall-clock anchor: perf_counter epochs differ per process, so
        # exported ts = anchor_wall + (now - anchor_perf) aligns ranks
        self._anchor_wall_ns = time.time_ns()
        self._anchor_perf_ns = _clock()
        # deque appends are GIL-atomic; the lock only guards export/tid
        self._events = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._tids = {}             # thread ident -> (small tid, name)

    # -- recording -------------------------------------------------------
    def clock(self):
        """Raw span clock (ns); pair with ``complete``."""
        return _clock()

    def span(self, name, **args):
        """Context manager timing a complete event."""
        return _Span(self, name, args or None)

    def complete(self, name, t0_ns, t1_ns, args=None):
        """Record a complete event from explicit begin/end clock values
        (the non-``with`` form used by phase timers that also accumulate
        their own counters)."""
        self._events.append(
            (name, "X", t0_ns, max(0, t1_ns - t0_ns),
             threading.get_ident(), args))

    def instant(self, name, **args):
        self._events.append(
            (name, "i", _clock(), 0, threading.get_ident(), args or None))

    def events_between(self, t0_ns, t1_ns):
        """Raw complete events whose END falls in ``[t0_ns, t1_ns]``
        (span clock), newest-window reads in O(window): events append
        at completion time, so the ring is end-time ordered and a
        reversed walk can stop at the first event older than the
        window — the fleet timeline's per-step incremental read.
        Returns ``(name, t0_ns, dur_ns, thread_ident, args)`` tuples
        in completion order."""
        out = []
        with self._lock:
            for name, ph, et0, dur, ident, args in reversed(self._events):
                end = et0 + dur
                if end < t0_ns:
                    break
                if ph == "X" and end <= t1_ns:
                    out.append((name, et0, dur, ident, args))
        out.reverse()
        return out

    # -- export ----------------------------------------------------------
    def _tid_of(self, ident):
        ent = self._tids.get(ident)
        if ent is None:
            ent = self._tids[ident] = len(self._tids)
        return ent

    def _ts_us(self, perf_ns):
        return (self._anchor_wall_ns
                + (perf_ns - self._anchor_perf_ns)) / 1000.0

    def drain(self, clear=False):
        """Snapshot the ring (optionally clearing it); returns Chrome
        trace-event dicts sorted by ts (metadata events first). Export
        does NOT clear — flush() must be idempotent so an executor
        close followed by the atexit flush rewrites the same file, not
        a truncated one."""
        with self._lock:
            raw = list(self._events)
            if clear:
                self._events.clear()
            out = [{"name": "process_name", "ph": "M", "ts": 0,
                    "pid": self.pid, "tid": 0,
                    "args": {"name": self.process_name}}]
            events = []
            for name, ph, t0, dur, ident, args in raw:
                ev = {"name": name, "ph": ph, "cat": "hetu",
                      "ts": round(self._ts_us(t0), 3),
                      "pid": self.pid, "tid": self._tid_of(ident)}
                if ph == "X":
                    ev["dur"] = round(dur / 1000.0, 3)
                elif ph == "i":
                    ev["s"] = "t"
                if args:
                    ev["args"] = args
                events.append(ev)
            for ident, tid in self._tids.items():
                out.append({"name": "thread_name", "ph": "M", "ts": 0,
                            "pid": self.pid, "tid": tid,
                            "args": {"name": f"thread{tid}"}})
        events.sort(key=lambda e: e["ts"])
        return out + events

    def export(self, path):
        """Write one Perfetto-loadable Chrome trace JSON file."""
        doc = {"traceEvents": self.drain(), "displayTimeUnit": "ms"}
        # a temp file of the writer's own: thread ranks share one
        # Telemetry and close (so flush) at once on their threads
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def _salvage_events(text):
    """Best-effort parse of a truncated trace file: decode whole event
    objects from the ``traceEvents`` array until the JSON breaks off,
    and keep that valid prefix. A rank that crashed or was killed mid-
    export must not fail the whole fleet's merge."""
    idx = text.find('"traceEvents"')
    start = text.find("[", idx if idx >= 0 else 0)
    if start < 0:
        return []
    decoder = json.JSONDecoder()
    events, pos = [], start + 1
    n = len(text)
    while pos < n:
        while pos < n and text[pos] in ", \t\r\n":
            pos += 1
        if pos >= n or text[pos] == "]":
            break
        try:
            obj, pos = decoder.raw_decode(text, pos)
        except ValueError:
            break               # torn tail: keep the prefix
        if isinstance(obj, dict):
            events.append(obj)
    return events


def _load_events(path):
    with open(path, errors="replace") as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        events = _salvage_events(text)
        print(f"telemetry: WARNING {path} is truncated/corrupt — "
              f"salvaged {len(events)} events from the valid prefix")
        return events
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def merge_traces(inputs, out_path=None):
    """Merge per-rank trace files into ONE Perfetto-loadable trace.

    ``inputs``: a directory (every ``trace_*.json`` inside it) or an
    explicit list of paths. Each file keeps its events under a distinct
    ``pid`` — the file's own pid when unique, else a fresh one — so a
    2-process pipeline run yields one timeline with one process row per
    rank (plus the PS server when it exported too). Returns the merged
    path (default ``<dir>/trace_merged.json``).
    """
    if isinstance(inputs, str):
        dirname = inputs
        paths = sorted(glob.glob(os.path.join(inputs, "trace_*.json")))
        paths = [p for p in paths
                 if not p.endswith("trace_merged.json")]
    else:
        paths = list(inputs)
        dirname = os.path.dirname(paths[0]) if paths else "."
    if not paths:
        raise ValueError(f"no trace_*.json files to merge in {inputs!r}")
    if out_path is None:
        out_path = os.path.join(dirname, "trace_merged.json")

    merged, used_pids = [], set()
    for path in paths:
        events = _load_events(path)
        pids = {e.get("pid", 0) for e in events}
        remap = {}
        for pid in sorted(pids):
            new = pid
            while new in used_pids:
                new += 1           # collide -> next free pid
            remap[pid] = new
            used_pids.add(new)
        for e in events:
            e = dict(e)
            e["pid"] = remap[e.get("pid", 0)]
            merged.append(e)
    meta = [e for e in merged if e.get("ph") == "M"]
    rest = sorted((e for e in merged if e.get("ph") != "M"),
                  key=lambda e: e.get("ts", 0))
    with open(out_path, "w") as f:
        json.dump({"traceEvents": meta + rest,
                   "displayTimeUnit": "ms"}, f)
    return out_path
