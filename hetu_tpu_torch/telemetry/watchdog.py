"""Fleet watchdog: heartbeats per rank + a launcher-side monitor that
turns an eternal hang into a diagnosed failure.

Worker side (:class:`Heartbeat`): each executor writes a tiny JSON file
``hb_rank<r>.json`` — rank, pid, step counter, wall clock, plus a
step-time EMA and the top exposed bucket when the executor feeds them
(fleet.py) — at step boundaries, throttled to at most one write per
``interval`` seconds (step changes force a write after a short floor),
and marks it ``done`` on clean close. Enabled by the launcher exporting
``HETU_WATCHDOG_DIR`` (the launcher's ``--hang-timeout``); with the env
unset the executor holds no Heartbeat at all, so the disabled path costs
one ``is None`` check per step. Counterpart of
``hetu_tpu/telemetry/watchdog.py``.

Launcher side (:class:`FleetWatchdog`): polls the heartbeat files.
When any rank's heartbeat goes stale past ``timeout`` — a hung
collective, a deadlocked 1F1B schedule, a SIGKILLed process — the
launcher fires: SIGUSR1 to every live worker (faulthandler stack dumps
into the telemetry dir), then SIGTERM (flight-record dumps via the
crash handlers), then kill, and exits with the distinct
:data:`EXIT_WATCHDOG` code so CI can tell "hang" from "test failure".

A rank that exited cleanly (returncode 0) or marked its heartbeat done
is never considered stalled; a rank that has not heartbeat *yet* gets a
boot grace of ``max(3x timeout, 60s)`` so import/compile time doesn't
false-fire.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["Heartbeat", "FleetWatchdog", "EXIT_WATCHDOG",
           "heartbeat_from_env"]

# distinct fleet exit code: "the watchdog shot the fleet", not "a test
# assertion failed" (1) and not "timeout(1) gave up" (124)
EXIT_WATCHDOG = 117


class Heartbeat:
    """Per-rank liveness file writer (worker side)."""

    def __init__(self, out_dir, rank, interval=1.0):
        self.out_dir = out_dir
        self.rank = int(rank)
        self.interval = float(interval)
        self.path = os.path.join(out_dir, f"hb_rank{self.rank}.json")
        self._last_write = 0.0
        self._step = 0
        self._step_ms_ema = None
        self._top_bucket = None
        os.makedirs(out_dir, exist_ok=True)
        self._write(done=False)         # boot beat: pid discoverable

    def _write(self, done):
        doc = {"rank": self.rank, "pid": os.getpid(),
               "step": self._step, "last_step": self._step,
               "time": time.time(), "done": done}
        if self._step_ms_ema is not None:
            doc["step_ms_ema"] = round(self._step_ms_ema, 3)
        if self._top_bucket is not None:
            doc["top_bucket"] = self._top_bucket
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
            self._last_write = time.monotonic()
        except OSError:
            pass                        # liveness is best effort

    def beat(self, step=None, step_ms=None, top_bucket=None):
        """Record progress; writes at most once per ``interval``, except
        that a *step change* forces a write after a much shorter floor —
        the FleetMonitor aligns ranks by step index, so a heartbeat
        frozen a full interval behind would smear the skew signal."""
        stepped = False
        if step is not None and int(step) != self._step:
            self._step = int(step)
            stepped = True
        if step_ms is not None:
            e = self._step_ms_ema
            self._step_ms_ema = (float(step_ms) if e is None
                                 else 0.8 * e + 0.2 * float(step_ms))
        if top_bucket is not None:
            self._top_bucket = top_bucket
        floor = min(0.05, self.interval) if stepped else self.interval
        if time.monotonic() - self._last_write >= floor:
            self._write(done=False)

    def done(self):
        """Final beat marking clean completion — the watchdog stops
        counting this rank's staleness."""
        self._write(done=True)


def heartbeat_from_env(rank=None):
    """Heartbeat for this worker when the launcher armed the watchdog
    (``HETU_WATCHDOG_DIR``); None otherwise — the executor's per-step
    check is then a single ``is None``."""
    out_dir = os.environ.get("HETU_WATCHDOG_DIR")
    if not out_dir:
        return None
    if rank is None:
        rank = int(os.environ.get("HETU_PROC_ID",
                                  os.environ.get("HETU_PS_RANK", "0")))
    timeout = float(os.environ.get("HETU_HANG_TIMEOUT", "0") or 0)
    interval = min(1.0, timeout / 5) if timeout > 0 else 1.0
    return Heartbeat(out_dir, rank, interval=max(0.05, interval))


class FleetWatchdog:
    """Launcher-side monitor over the per-rank heartbeat files."""

    def __init__(self, hb_dir, num_workers, timeout):
        self.hb_dir = hb_dir
        self.num_workers = int(num_workers)
        self.timeout = float(timeout)
        self.boot_grace = max(3 * self.timeout, 60.0)
        self.started = time.time()

    def _read(self, rank):
        try:
            with open(os.path.join(self.hb_dir,
                                   f"hb_rank{rank}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def check(self, procs=None):
        """Stalled ranks right now: ``[(rank, age_seconds, last_step)]``.

        ``procs`` maps rank -> Popen (or None); a rank whose process
        exited 0 is skipped — finished is not stalled. A nonzero-exited
        or still-running rank with a stale heartbeat IS stalled (a
        SIGKILLed rank stops beating; its stall is how the fleet learns
        it died)."""
        now = time.time()
        stalled = []
        for rank in range(self.num_workers):
            p = procs.get(rank) if procs else None
            if p is not None and p.poll() == 0:
                continue
            hb = self._read(rank)
            if hb is not None and float(hb.get("time", 0)) < self.started:
                # a leftover heartbeat from a previous fleet in a reused
                # dir must not count as this fleet's stall — treat it as
                # "has not heartbeat yet" (boot grace)
                hb = None
            if hb is None:
                if now - self.started > self.boot_grace:
                    stalled.append((rank, now - self.started, -1))
                continue
            if hb.get("done"):
                continue
            age = now - float(hb.get("time", 0))
            if age > self.timeout:
                stalled.append((rank, age, int(hb.get("step", -1))))
        return stalled

    def fire(self, procs, sig_grace=1.0, term_grace=5.0):
        """Diagnose-then-kill: SIGUSR1 (stack dumps) -> SIGTERM
        (flight-record dumps) -> kill. ``procs`` maps rank -> Popen.

        Launcher-local ranks only: for a remote rank the Popen is the
        ssh client, which neither forwards SIGUSR1/SIGTERM to the
        remote command nor can produce dumps on the launcher's
        filesystem — the launcher warns about this scope when it arms
        a multi-host watchdog."""
        import signal as _signal
        live = [p for p in procs.values()
                if p is not None and p.poll() is None]
        for p in live:
            try:
                p.send_signal(_signal.SIGUSR1)
            except OSError:
                pass
        time.sleep(sig_grace)
        for p in live:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.time() + term_grace
        for p in live:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        return EXIT_WATCHDOG
