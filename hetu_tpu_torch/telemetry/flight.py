"""Flight recorder: the black-box layer for runs that *fail*.

The span tracer (tracer.py) explains runs that finish; a rank that
hangs in a collective, deadlocks in 1F1B, or OOMs on the first donated
step never reaches the exporter. This module keeps a per-rank,
lock-free ring of every cross-rank operation — collective dispatches,
p2p boundary transfers, PS RPCs — with a per-group sequence number,
peer/byte attribution, and an enqueued/completed state, plus a smaller
ring of step boundaries. On SIGTERM, fatal exception, or a watchdog
fire the ring dumps to ``$HETU_TELEMETRY/flight_rank<r>.json``, in the
format of ``hetu_tpu/telemetry/flight.py`` (whose ``blackbox`` analyzer
merges per-rank dumps and names the guilty rank).

Design constraints:

* **Lock-free recording**: sequence numbers come from
  ``itertools.count`` (GIL-atomic) and each event is one list written
  into its ring slot with a single store — safe from any thread, no
  lock on the hot path. ``start`` returns the record itself, so
  ``complete`` marks it even after the slot was recycled.
* **Signal-safe dumping**: ``dump`` snapshots the ring and writes one
  JSON file via tmp+rename — a torn write never corrupts a previous
  dump.
* **Groups**: events carry a group — ``collective`` entries are
  SPMD-symmetric (every rank records the same sequence, so the first
  seq-number divergence names who entered a collective the others
  didn't); ``p2p``/``ps``/``sched`` entries are rank-local and are
  diagnosed by their pending (enqueued-but-never-completed) state.
"""
from __future__ import annotations

import faulthandler
import itertools
import json
import os
import signal
import sys
import threading
import time

__all__ = ["FlightRecorder", "install_crash_handlers",
           "GROUPS"]

GROUPS = ("collective", "p2p", "ps", "sched", "serve")

# record layout (a list, mutated in place by complete()):
_SEQ, _GROUP, _KIND, _PEER, _TAG, _BYTES, _STEP, _T0, _T1 = range(9)


class FlightRecorder:
    """Bounded in-memory event ring; one per process."""

    def __init__(self, rank=0, capacity=4096, step_capacity=64):
        self.rank = int(rank)
        self._ring = [None] * int(capacity)
        self._idx = itertools.count()           # global slot counter
        self._gseq = {g: itertools.count() for g in GROUPS}
        self._steps = [None] * int(step_capacity)
        self._steps_idx = itertools.count()
        self._last_step = -1
        self._reason = None     # first non-routine dump reason sticks
        # process facts recorders stamp for the post-mortem analyzer
        # (e.g. ps/client.py records ps_nservers so an analyzer can name
        # which server a pending RPC's tensor lives on)
        self.meta = {}

    # -- recording -------------------------------------------------------
    def start(self, group, kind, peer=None, tag=None, nbytes=0):
        """Record an enqueued event; returns the record (pass it to
        ``complete``). ``group`` must be one of ``GROUPS``."""
        seq = next(self._gseq[group])
        rec = [seq, group, kind, peer, tag, int(nbytes), self._last_step,
               time.time(), None]
        self._ring[next(self._idx) % len(self._ring)] = rec
        return rec

    @staticmethod
    def complete(rec):
        rec[_T1] = time.time()

    def record(self, group, kind, peer=None, tag=None, nbytes=0):
        """One-shot event that is already complete (e.g. a collective
        dispatch that returned)."""
        rec = self.start(group, kind, peer=peer, tag=tag, nbytes=nbytes)
        rec[_T1] = rec[_T0]
        return rec

    def step(self, step_no):
        """Mark a completed step boundary (kept in its own small ring —
        the last N steps survive any volume of comm events)."""
        self._last_step = int(step_no)
        self._steps[next(self._steps_idx) % len(self._steps)] = \
            (int(step_no), time.time())

    # -- export ----------------------------------------------------------
    def snapshot(self):
        events = []
        for rec in self._ring:
            if rec is None:
                continue
            events.append({
                "seq": rec[_SEQ], "group": rec[_GROUP],
                "kind": rec[_KIND], "peer": rec[_PEER],
                "tag": rec[_TAG], "bytes": rec[_BYTES],
                "step": rec[_STEP], "t0": rec[_T0], "t1": rec[_T1]})
        events.sort(key=lambda e: e["t0"])
        steps = sorted(s for s in self._steps if s is not None)
        return {"rank": self.rank, "pid": os.getpid(),
                "nprocs": int(os.environ.get("HETU_NUM_PROCS", "1")),
                "wall": time.time(),
                "last_step": self._last_step,
                "meta": dict(self.meta),
                "steps": [list(s) for s in steps],
                "events": events}

    def dump(self, out_dir, reason=""):
        """Write ``flight_rank<r>.json`` atomically; returns the path
        (best effort — black-box dumping must never raise out of a
        signal handler or excepthook)."""
        try:
            if reason and reason != "flush":
                # a crash reason must survive the atexit flush re-dump
                self._reason = reason
            doc = self.snapshot()
            doc["reason"] = self._reason or reason
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"flight_rank{self.rank}.json")
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            return path
        except OSError:
            return None


# ---------------------------------------------------------------------------
# crash handlers: SIGTERM / fatal exception / SIGUSR1 stack dumps
# ---------------------------------------------------------------------------

_current = None         # the Telemetry the process-global handlers dump
_handlers_installed = False
_stack_file = None      # kept open for faulthandler; one per process


def _dump_current(reason):
    tel = _current
    if tel is None:
        return
    try:
        if tel.flight is not None:
            tel.flight.dump(tel.out_dir, reason=reason)
        tel.flush()
    except Exception:           # noqa: BLE001 — never mask the crash
        pass


def install_crash_handlers(tel):
    """Make ``tel`` (an enabled Telemetry with an out_dir) the black
    box the process dumps on the three failure paths:

    * **SIGTERM** (launcher shutdown, watchdog fire): dump flight ring
      + flush trace/metrics, then re-raise the default handler so the
      exit status still says "killed by SIGTERM".
    * **fatal exception**: ``sys.excepthook`` chain — dump, then the
      previous hook prints the traceback as usual.
    * **SIGUSR1**: ``faulthandler`` stack dump of every thread to
      ``stacks_rank<r>.log`` — a live hang is inspectable with one
      ``kill -USR1`` even without the watchdog.

    The handlers install ONCE per process and dispatch to a mutable
    "current telemetry" slot, so repeated Telemetry construction (test
    suites, notebooks) retargets the existing handlers instead of
    chaining a closure — and the previous run's ring stays collectable.
    Off the main thread only the dump target and the SIGUSR1 file are
    set. Handler installation failures (exotic platforms) are
    swallowed — observability must never take down the data path.
    """
    global _current, _handlers_installed, _stack_file
    _current = tel

    # SIGUSR1 -> thread stacks (satellite: live-hang inspection);
    # re-registering replaces the previous target file, which is then
    # safe to close (no FD growth across instances)
    try:
        path = os.path.join(tel.out_dir, f"stacks_rank{tel.rank}.log")
        if _stack_file is None or _stack_file.name != path \
                or _stack_file.closed:
            f = open(path, "a")
            faulthandler.register(signal.SIGUSR1, file=f,
                                  all_threads=True)
            old, _stack_file = _stack_file, f
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
    except (ValueError, OSError, AttributeError):
        pass

    if _handlers_installed:
        return
    if threading.current_thread() is not threading.main_thread():
        # signal.signal raises off the main thread: a thread rank's
        # executor retargets the dump slot and leaves the installing to
        # the main thread's first Telemetry
        return
    _handlers_installed = True

    # SIGTERM -> dump, then default disposition
    def _on_term(signum, frame):
        _dump_current(f"signal {signum}")
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass                    # not the main thread

    prev_hook = sys.excepthook

    def _on_uncaught(tp, val, tb):
        _dump_current(f"uncaught {tp.__name__}: {val}")
        prev_hook(tp, val, tb)

    sys.excepthook = _on_uncaught
