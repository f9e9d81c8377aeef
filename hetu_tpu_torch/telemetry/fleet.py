"""Fleet watch: the LIVE plane over a running multi-rank job.

Every other observability consumer is post-hoc — the perf doctor,
blackbox, health and serving doctors all read a run after it ends (or
dies), and the FleetWatchdog only notices total silence. This module
watches the fleet *while it runs* and answers two questions the
post-hoc tools can't: **who is slow right now** (straggler vs victim
attribution across ranks) and **is reality drifting from the cost
model** (the HT910 claim-vs-measured comparison run as a runtime
check).

Three pieces:

* :class:`StepTimeline` (worker side) — a lock-free ring (flight.py
  idiom) of per-step records: step idx, wall ms, and a doctor-style
  exposed-bucket split computed *incrementally* from just the spans
  the tracer recorded inside the step window (the doctor's interval claiming
  over one window instead of a whole exported trace). Flushed as
  ``timeline_rank<r>.jsonl`` (tmp+rename, crash-safe) and summarized
  into the watchdog heartbeat (``step_ms_ema`` / ``top_bucket``) so
  the launcher reads skew signal for free. Served live at ``/fleet``
  on the per-rank metrics port. Enabled by ``HETU_FLEET`` (exported by
  the launcher's ``--watch``); with the env unset the executor holds no
  timeline at all — the disabled path is one ``is None`` per step.

* :class:`FleetMonitor` (launcher side) — polls heartbeats + scrapes
  per-rank ``/fleet``, aligns ranks on the newest step index every
  rank has reported (restart/ragged-start tolerant: the latest record
  per step wins, and with no common step it degrades to each rank's
  latest), and attributes skew: the **straggler** is the rank whose
  own work (wall minus collective/p2p/bubble wait) is slow; the
  **victims** are the ranks whose wait grew to cover it. Emits
  ``fleet_watch`` spans, a ``straggler_skew`` gauge, and a refreshed
  ``fleet_report.json``.

* :class:`DriftDetector` — compares each rank's measured
  collective/p2p exposed ms against the CostDB ``estimate_ms``
  prediction for the bytes that step actually moved, using perfcheck's
  HT910 soundness bound (measured > SOUND_FACTOR x predicted +
  SOUND_SLACK_MS). ``k`` consecutive exceeded windows fire a
  health-monitor-style trip: a ``drift`` event, a counter, and a
  WARN — the signal a re-planner keys off.

Consumers::

    python -m hetu_tpu_torch.launcher -c conf.yml --watch python train.py
    python -m hetu_tpu_torch.telemetry.fleet DIR [--json]   # post-hoc,
        # works on crashed runs (reads the flushed timelines); the
        # blackbox report gains a STRAGGLER line from the same data
    curl http://127.0.0.1:<port>/fleet            # per-rank JSON

Counterpart of ``hetu_tpu/telemetry/fleet.py``. Where the port differs:

* **Thread ranks.** A session whose ranks are threads of one process
  (``parallel/local_ranks.py``) shares one ``os.environ``, so
  ``HETU_PROC_ID`` cannot tell its ranks apart: each thread rank holds a
  timeline of its own, named by its rank (``timeline_rank<r>.jsonl``),
  that reads only its own thread's spans (another rank's thread is not
  this rank's hidden work), and ``HETU_FAULT_SLOW_RANK`` names a thread
  rank there. :func:`dump_current` flushes every live timeline.
* **The drift bound** is perfcheck's (``SOUND_FACTOR``,
  ``SOUND_SLACK_MS``), copied here: importing ``analysis/perfcheck.py``
  imports torch, which the launcher's monitor runs without. A kind the CostDB holds no entry of is not
  looked up at all, so the CLI and the launcher's monitor read the DB
  without torch until it holds a measurement to compare against (a
  lookup keys by the platform, which asks torch for the card).
* **Spans time host work** (``telemetry/__init__.py``): a rank's buckets
  are what its host spent, and a wait on the device lands where the host
  synchronizes.

No torch at module level: the launcher runs the monitor without it, and
the CLI runs where no card is.
"""
from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import sys
import threading
import time

from .doctor import _PRIORITY, _merge, _subtract, _total, classify

# the HT910 soundness bound, defined here because the launcher runs this
# module without torch; analysis/perfcheck.py imports it from here. A
# priced claim over SOUND_FACTOR x its measured bucket + SOUND_SLACK_MS is
# unsound (the cold-start model must rank, not predict walls; the slack
# absorbs sub-threshold buckets on fast steps), and a measured comm time
# over SOUND_FACTOR x predicted + SOUND_SLACK_MS is an exceeded window
SOUND_FACTOR = 3.0
SOUND_SLACK_MS = 0.5

__all__ = ["StepTimeline", "FleetMonitor", "DriftDetector",
           "timeline_from_env", "fault_slow_from_env", "dump_current",
           "attribute_skew", "align_windows", "load_timelines",
           "load_heartbeats", "analyze_dir", "render_report",
           "summarize_for_blackbox", "main",
           "WAIT_BUCKETS", "SKEW_MIN_MS", "SKEW_FRAC", "SOUND_FACTOR",
           "SOUND_SLACK_MS"]

# skew significance: the straggler is named only when its own-work
# excess over the fleet baseline clears an absolute floor AND a
# fraction of the median step wall — jitter on a healthy fleet must
# not produce a rotating accusation
SKEW_MIN_MS = 2.0
SKEW_FRAC = 0.2

# buckets that are *waiting on someone else*: a rank's own work is its
# step wall minus these. A straggler shows a fat self_ms; its victims
# show grown collective/p2p/bubble waits.
WAIT_BUCKETS = ("collective", "p2p", "bubble")

# timeline comm-byte accounting: bucket -> CostDB kind the drift
# detector prices that bucket's measured ms against
_DRIFT_KINDS = {"collective": "allreduce", "p2p": "p2p"}


def _rank_of(path, prefix):
    base = os.path.basename(path)
    try:
        return int(base[len(prefix) + 5:].split(".", 1)[0])
    except (ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# worker side: per-step timeline ring
# ---------------------------------------------------------------------------

class StepTimeline:
    """Bounded per-rank ring of per-step records (worker side).

    Records are plain dicts written into ring slots with a single
    store (flight.py idiom — safe from the step thread with zero
    locking); dumps snapshot the ring and write one JSONL file via
    tmp+rename, so a torn write never corrupts the previous flush.
    """

    def __init__(self, telemetry, rank=None, capacity=256,
                 flush_every=8, out_dir=None, own_thread_only=False):
        self.tel = telemetry
        self.rank = telemetry.rank if rank is None else int(rank)
        self.out_dir = out_dir or telemetry.out_dir
        # a thread rank's timeline: other threads are other ranks, not
        # this rank's hidden work, so their spans are skipped
        self.own_thread_only = bool(own_thread_only)
        self._ring = [None] * int(capacity)
        self._idx = itertools.count()
        self._flush_every = max(1, int(flush_every))
        self._since_flush = 0
        self._last_flush = 0.0
        self._last_step_ms = None
        self._last_top = None

    # -- recording -------------------------------------------------------
    def on_step(self, step, t0_ns, t1_ns, wall_ms, steps=1):
        """Attribute one finished step window [t0_ns, t1_ns) (tracer
        span clock) into exposed buckets and append the record.

        This is the doctor's interval claiming run incrementally: only the
        spans the tracer completed inside THIS window are classified
        and claimed in priority order, so the cost is proportional to
        the step's own span count, not the trace length. Spans on
        another thread or stamped ``overlapped=True`` are hidden —
        accounted, never charged against the step wall (the doctor's
        exposed/hidden contract)."""
        me = threading.get_ident()
        per_bucket = {}
        hidden_ns = 0
        comm_bytes = {}
        for name, et0, dur, ident, args in \
                self.tel.tracer.events_between(t0_ns, t1_ns):
            b = classify(name)
            if b is None or (self.own_thread_only and ident != me):
                continue
            if b in _DRIFT_KINDS and args:
                nb = args.get("bytes")
                if isinstance(nb, int) and not isinstance(nb, bool):
                    comm_bytes[b] = comm_bytes.get(b, 0) + nb
            if ident != me or (args is not None
                               and args.get("overlapped")):
                hidden_ns += dur
                continue
            s = max(et0, t0_ns)
            e = min(et0 + dur, t1_ns)
            if e > s:
                per_bucket.setdefault(b, []).append([s, e])
        claimed = []
        buckets = {}
        for b in _PRIORITY:
            ivs = per_bucket.get(b)
            if not ivs:
                continue
            own = _subtract(_merge(ivs), claimed)
            ms = _total(own) / 1e6
            if ms > 0:
                buckets[b] = round(ms, 3)
            claimed = _merge(claimed + own)
        accounted = sum(buckets.values())
        unacc = wall_ms - accounted
        if unacc > 0.001:
            buckets["unaccounted"] = round(unacc, 3)
        rec = {"step": int(step), "t": time.time(),
               "wall_ms": round(float(wall_ms), 3),
               "steps": int(steps), "buckets": buckets}
        if hidden_ns:
            rec["hidden_ms"] = round(hidden_ns / 1e6, 3)
        if comm_bytes:
            rec["comm_bytes"] = comm_bytes
        ps = self._ps_stats()
        if ps:
            rec["ps"] = ps
        self._ring[next(self._idx) % len(self._ring)] = rec
        per_step = rec["wall_ms"] / max(1, rec["steps"])
        self._last_step_ms = round(per_step, 3)
        self._last_top = (max(buckets, key=buckets.get)
                          if buckets else None)
        self._since_flush += 1
        now = time.monotonic()
        if self._since_flush >= self._flush_every \
                or now - self._last_flush > 2.0:
            self.dump()
            self._since_flush = 0
            self._last_flush = now
        return rec

    def _ps_stats(self):
        """Tiered/replicated PS live gauges riding the record (set by
        PSRuntime on the drain cadence); absent on non-PS graphs."""
        reg = self.tel.metrics
        if reg is None:
            return None
        depth = reg.peek("ps_repl_queue_depth")
        if depth is None:
            return None
        out = {"repl_queue_depth": int(depth)}
        for name in list(reg.names()):
            if name.startswith("ps_table_") and \
                    name.endswith("_spill_hit_rate"):
                out[name[len("ps_"):]] = round(float(reg.peek(name)), 4)
        return out

    # -- summaries / export ----------------------------------------------
    def summary(self):
        """(last per-step wall ms, top exposed bucket) for the
        heartbeat enrichment — what the launcher reads for free."""
        return self._last_step_ms, self._last_top

    def snapshot(self):
        recs = [r for r in self._ring if r is not None]
        recs.sort(key=lambda r: (r["t"], r["step"]))
        return recs

    def fleet_json(self, last=64):
        """The ``/fleet`` endpoint payload."""
        recs = self.snapshot()
        return {"rank": self.rank, "pid": os.getpid(),
                "time": time.time(), "records": recs[-int(last):]}

    def close(self):
        """The last dump, and the process forgets this timeline (a later
        flush of another session's telemetry does not write it again).
        Returns the dump's path."""
        path = self.dump()
        if _live.get(self.rank) is self:
            del _live[self.rank]
        return path

    def dump(self, out_dir=None):
        """Write ``timeline_rank<r>.jsonl`` atomically (best effort —
        the crash handlers call this; it must never raise)."""
        out_dir = out_dir or self.out_dir
        if not out_dir:
            return None
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir,
                                f"timeline_rank{self.rank}.jsonl")
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                for rec in self.snapshot():
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, path)
            return path
        except OSError:
            return None


_live = {}     # rank -> the process's live timelines (crash-dump targets)


def timeline_from_env(telemetry, rank=None):
    """StepTimeline for this worker when the launcher armed the fleet
    plane (``HETU_FLEET``, exported by the launcher's ``--watch``) and
    telemetry is enabled with an output dir; None otherwise — the
    executor's per-step check is then a single ``is None``. ``rank``
    names a thread rank (its timeline reads its own thread's spans
    only); None is the process's rank."""
    if os.environ.get("HETU_FLEET", "") in ("", "0", "false"):
        return None
    if not telemetry.enabled or not telemetry.out_dir:
        return None
    tl = StepTimeline(telemetry, rank=rank,
                      own_thread_only=rank is not None)
    _live[tl.rank] = tl
    return tl


def dump_current(out_dir=None):
    """Flush the process's live timelines (Telemetry.flush / crash
    handlers call this via sys.modules — never imports anything).
    Returns the path of the first written, or None."""
    paths = [tl.dump(out_dir) for tl in list(_live.values())]
    return next((p for p in paths if p), None)


def fault_slow_from_env(rank=None):
    """Injected straggler fault (tests/CI): seconds to sleep per step
    when THIS rank is named by ``HETU_FAULT_SLOW_RANK`` (sleep length
    ``HETU_FAULT_SLOW_MS``, default 50). 0.0 otherwise. ``rank`` is a
    thread rank's; None reads the process's (``HETU_PROC_ID``, else
    ``HETU_PS_RANK``, else 0)."""
    spec = os.environ.get("HETU_FAULT_SLOW_RANK")
    if not spec:
        return 0.0
    if rank is None:
        rank = int(os.environ.get("HETU_PROC_ID",
                                  os.environ.get("HETU_PS_RANK", "0")))
    try:
        if int(spec) != rank:
            return 0.0
    except ValueError:
        return 0.0
    return float(os.environ.get("HETU_FAULT_SLOW_MS", "50")) / 1000.0


# ---------------------------------------------------------------------------
# straggler / victim attribution (pure math — unit-testable)
# ---------------------------------------------------------------------------

def rank_stats(rec):
    """One timeline record -> per-step normalized (wall, self, wait)
    ms plus its top bucket. ``step_block`` records carry ``steps``
    weight — a 100-step block is 100 steps of wall, not one."""
    steps = max(1, int(rec.get("steps", 1)))
    buckets = rec.get("buckets") or {}
    wall = float(rec.get("wall_ms", 0.0)) / steps
    wait = sum(float(buckets.get(k, 0.0)) for k in WAIT_BUCKETS) / steps
    top = max(buckets, key=buckets.get) if buckets else None
    return {"step": int(rec.get("step", -1)),
            "wall_ms": round(wall, 3),
            "self_ms": round(max(0.0, wall - wait), 3),
            "wait_ms": round(wait, 3),
            "top_bucket": top}


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return 0.0
    mid = n // 2
    return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0


def attribute_skew(window, min_ms=SKEW_MIN_MS, frac=SKEW_FRAC):
    """Attribute cross-rank skew over one aligned window.

    ``window`` maps rank -> timeline record. The straggler is the rank
    with the largest own-work time (wall minus collective/p2p/bubble
    wait); its skew is the excess over the *other* ranks' median
    self_ms. Victims are the other ranks whose wait exceeds the
    straggler's by a quarter of the skew — they are stalled covering
    for it, not slow themselves. Below the significance threshold
    (``max(min_ms, frac x median wall)``) nobody is named."""
    stats = {int(r): rank_stats(rec) for r, rec in window.items()}
    out = {"ranks": stats, "straggler": None, "skew_ms": 0.0,
           "victims": []}
    if len(stats) < 2:
        return out
    self_ms = {r: s["self_ms"] for r, s in stats.items()}
    straggler = max(self_ms, key=self_ms.get)
    baseline = _median([v for r, v in self_ms.items() if r != straggler])
    skew = self_ms[straggler] - baseline
    med_wall = _median([s["wall_ms"] for s in stats.values()])
    out["skew_ms"] = round(skew, 3)
    if skew <= max(min_ms, frac * med_wall):
        return out
    out["straggler"] = straggler
    floor = stats[straggler]["wait_ms"] + 0.25 * skew
    out["victims"] = sorted(
        r for r, s in stats.items()
        if r != straggler and s["wait_ms"] > floor)
    return out


def align_windows(timelines):
    """Align per-rank record lists on a common step index.

    Returns ``(step, {rank: record}, aligned)``. The chosen step is
    the NEWEST one every rank has reported; when a rank restarted and
    re-ran a step, its latest record for that step wins. With no
    common step (ragged starts, a rank that died before its first
    flush) it degrades to each rank's latest record with
    ``aligned=False`` — the report stays useful, just unsynchronized.
    """
    by_step = {}
    for r, recs in timelines.items():
        if recs:
            by_step[int(r)] = {int(rec.get("step", -1)): rec
                               for rec in recs}
    if not by_step:
        return -1, {}, False
    common = set.intersection(*(set(m) for m in by_step.values()))
    if common:
        step = max(common)
        return step, {r: m[step] for r, m in by_step.items()}, True
    latest = {r: recs[-1] for r, recs in timelines.items() if recs}
    return -1, latest, False


# ---------------------------------------------------------------------------
# drift detector: runtime HT910
# ---------------------------------------------------------------------------

class DriftDetector:
    """Measured comm ms vs CostDB prediction, perfcheck's HT910 bound
    run as a runtime check: a window is *exceeded* when measured >
    ``factor`` x predicted + ``slack_ms`` (factor/slack default to the
    lint's SOUND_FACTOR / SOUND_SLACK_MS); ``k`` consecutive exceeded
    windows on one (rank, kind) fire the trip — a ``drift`` event, a
    ``drift_trips`` counter, and a WARN, health-monitor ladder style.
    Only measured/curve DB entries are compared: a cold-start guess
    drifting from reality is the expected state, not a finding."""

    def __init__(self, db=None, factor=None, slack_ms=None, k=3,
                 telemetry=None):
        self.factor = SOUND_FACTOR if factor is None else float(factor)
        self.slack_ms = (SOUND_SLACK_MS if slack_ms is None
                         else float(slack_ms))
        self.k = max(1, int(k))
        self._db = db
        self._db_lock = threading.Lock()
        self.tel = telemetry
        self._consec = {}
        self._fired = set()
        self.trips = []

    def db(self):
        if self._db is None:
            with self._db_lock:
                if self._db is None:
                    from .costdb import CostDB, default_db_path
                    self._db = CostDB(default_db_path())
        return self._db

    def observe(self, rank, kind, nbytes, measured_ms):
        """One window's measurement; returns the verdict dict, or None
        when the DB has no measured entry to compare against."""
        if nbytes <= 0 or measured_ms <= 0:
            return None
        db = self.db()
        if kind not in db.kinds():
            return None     # nothing measured: estimate_info gives None
        pred, src = db.estimate_info(kind, int(nbytes), cold_start=False)
        if pred is None:
            return None
        exceeded = measured_ms > self.factor * pred + self.slack_ms
        key = (int(rank), kind)
        n = self._consec.get(key, 0) + 1 if exceeded else 0
        self._consec[key] = n
        tripped = exceeded and n >= self.k
        verdict = {"rank": int(rank), "kind": kind, "bytes": int(nbytes),
                   "measured_ms": round(float(measured_ms), 3),
                   "predicted_ms": round(float(pred), 3),
                   "source": src, "exceeded": exceeded,
                   "windows": n, "tripped": tripped}
        tel = self.tel
        if tel is not None and tel.enabled and exceeded:
            tel.instant("drift", rank=int(rank), kind=kind,
                        bytes=int(nbytes),
                        measured_ms=verdict["measured_ms"],
                        predicted_ms=verdict["predicted_ms"],
                        windows=n, tripped=tripped, source=src)
        if tripped and key not in self._fired:
            self._fired.add(key)
            self.trips.append(verdict)
            if tel is not None:
                tel.inc("drift_trips")
            print(f"fleet: DRIFT rank {rank} {kind}: measured "
                  f"{verdict['measured_ms']}ms > {self.factor:g}x "
                  f"predicted {verdict['predicted_ms']}ms "
                  f"+ {self.slack_ms:g}ms for {n} consecutive windows "
                  f"— the CostDB no longer describes this fleet "
                  f"(re-plan / re-measure)", file=sys.stderr)
        return verdict

    @property
    def tripped(self):
        return bool(self.trips)


# ---------------------------------------------------------------------------
# launcher side: the live monitor
# ---------------------------------------------------------------------------

class FleetMonitor:
    """Polls heartbeats + per-rank ``/fleet`` scrapes, attributes
    skew, runs the drift detector, and persists ``fleet_report.json``.

    Source ladder per rank: live ``/fleet`` scrape (when the launcher
    gave the rank a metrics port) -> flushed ``timeline_rank<r>.jsonl``
    on disk -> heartbeat summary only (``step_ms_ema``/``top_bucket``
    from the heartbeat — skew signal survives with no metrics port at
    all, just without the victim/wait split)."""

    def __init__(self, tdir, num_workers, metrics_ports=None,
                 telemetry=None, costdb=None, drift_k=3,
                 interval=None, host="127.0.0.1", out_path=None):
        self.tdir = tdir
        self.n = int(num_workers)
        self.ports = {int(r): int(p)
                      for r, p in (metrics_ports or {}).items()}
        self.tel = telemetry
        self.host = host
        self.interval = float(
            os.environ.get("HETU_WATCH_INTERVAL", "1.0")
            if interval is None else interval)
        self.drift = DriftDetector(db=costdb, k=drift_k,
                                   telemetry=telemetry)
        self.out_path = out_path
        self.report = None
        self._last_poll = 0.0
        self._drift_seen = {}       # rank -> newest drift-checked step

    # -- sources ---------------------------------------------------------
    def _scrape(self, rank):
        port = self.ports.get(rank)
        if not port:
            return None
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"http://{self.host}:{port}/fleet",
                    timeout=0.25) as resp:
                doc = json.loads(resp.read().decode())
            return doc.get("records") or None
        except Exception:       # noqa: BLE001 — rank not up yet / gone
            return None

    def _gather(self):
        timelines = {}
        for r in range(self.n):
            recs = self._scrape(r)
            if recs:
                timelines[r] = recs
        missing = [r for r in range(self.n) if r not in timelines]
        if missing:
            disk = load_timelines(self.tdir, ranks=missing)
            timelines.update(disk)
        return timelines, load_heartbeats(self.tdir)

    # -- polling ---------------------------------------------------------
    def poll(self, force=False):
        """One monitoring window; throttled to ``interval`` (returns
        the cached report between windows)."""
        now = time.monotonic()
        if not force and now - self._last_poll < self.interval:
            return None
        self._last_poll = now
        tel = self.tel
        if tel is not None and tel.enabled:
            t0 = tel.clock()
            rep = self._poll_once()
            tel.complete("fleet_watch", t0, tel.clock(), {
                "step": int(rep["step"]),
                "straggler": rep["straggler"],
                "skew_ms": rep["skew_ms"],
                "victims": len(rep["victims"])})
            tel.set_gauge("straggler_skew", rep["skew_ms"])
        else:
            rep = self._poll_once()
        self.report = rep
        self._persist(rep)
        return rep

    def _poll_once(self):
        timelines, beats = self._gather()
        # heartbeat-only ranks still contribute skew signal: synthesize
        # a waitless record from the enriched beat
        for r, hb in beats.items():
            if r in timelines or hb.get("step_ms_ema") is None:
                continue
            timelines[r] = [{"step": int(hb.get("last_step",
                                                hb.get("step", -1))),
                             "t": float(hb.get("time", 0.0)),
                             "wall_ms": float(hb["step_ms_ema"]),
                             "steps": 1, "buckets": {},
                             "src": "heartbeat"}]
        step, window, aligned = align_windows(timelines)
        skew = attribute_skew(window) if len(window) >= 2 else \
            {"ranks": {int(r): rank_stats(rec)
                       for r, rec in window.items()},
             "straggler": None, "skew_ms": 0.0, "victims": []}
        drift = self._check_drift(timelines)
        rows = {}
        for r in range(self.n):
            hb = beats.get(r) or {}
            st = skew["ranks"].get(r)
            rows[str(r)] = {
                "step": (st or {}).get("step",
                                       int(hb.get("step", -1))),
                "step_ms": (st or {}).get("wall_ms",
                                          hb.get("step_ms_ema")),
                "self_ms": (st or {}).get("self_ms"),
                "wait_ms": (st or {}).get("wait_ms"),
                "top_bucket": ((st or {}).get("top_bucket")
                               or hb.get("top_bucket")),
                "done": bool(hb.get("done")),
                "heartbeat_age_s": (round(time.time()
                                          - float(hb["time"]), 1)
                                    if hb.get("time") else None),
                "drift": drift.get(r),
            }
        return {"time": time.time(), "step": int(step),
                "aligned": bool(aligned),
                "straggler": skew["straggler"],
                "skew_ms": skew["skew_ms"],
                "victims": skew["victims"],
                "ranks": rows,
                "drift_trips": list(self.drift.trips)}

    def _check_drift(self, timelines):
        """Feed every not-yet-checked record through the detector;
        returns rank -> latest verdict summary string."""
        out = {}
        for r, recs in timelines.items():
            seen = self._drift_seen.get(r, -1)
            last = None
            for rec in recs:
                step = int(rec.get("step", -1))
                if step <= seen or rec.get("src") == "heartbeat":
                    continue
                seen = max(seen, step)
                steps = max(1, int(rec.get("steps", 1)))
                buckets = rec.get("buckets") or {}
                for bucket, kind in _DRIFT_KINDS.items():
                    nbytes = (rec.get("comm_bytes") or {}).get(bucket, 0)
                    measured = float(buckets.get(bucket, 0.0)) / steps
                    v = self.drift.observe(r, kind, nbytes // steps,
                                           measured)
                    if v is not None:
                        last = v
            self._drift_seen[r] = seen
            if last is not None:
                out[r] = ("DRIFT" if last["tripped"] else
                          "high" if last["exceeded"] else "ok")
        return out

    def _persist(self, rep):
        if not self.out_path:
            return
        try:
            tmp = f"{self.out_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(rep, f, indent=1)
            os.replace(tmp, self.out_path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# post-hoc: load flushed timelines, analyze a directory
# ---------------------------------------------------------------------------

def load_timelines(tdir, ranks=None):
    """{rank: [records]} from the flushed ``timeline_rank<r>.jsonl``
    files (torn tails tolerated — a crashed rank's last line may be
    half-written only if the tmp+rename was interrupted; skip bad
    lines rather than failing the post-mortem)."""
    out = {}
    for path in glob.glob(os.path.join(tdir, "timeline_rank*.jsonl")):
        r = _rank_of(path, "timeline")
        if r is None or (ranks is not None and r not in ranks):
            continue
        recs = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict):
                        recs.append(rec)
        except OSError:
            continue
        if recs:
            recs.sort(key=lambda rec: (rec.get("t", 0),
                                       rec.get("step", -1)))
            out[r] = recs
    return out


def load_heartbeats(tdir):
    out = {}
    for path in glob.glob(os.path.join(tdir, "hb_rank*.json")):
        r = _rank_of(path, "hb")
        if r is None:
            continue
        try:
            with open(path) as f:
                out[r] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def analyze_dir(tdir, costdb=None, drift_k=3):
    """Post-hoc fleet report over a telemetry directory — same
    attribution as the live monitor, over everything that was flushed
    (works on crashed runs: the timelines and heartbeats are already
    on disk when the watchdog shoots the fleet)."""
    timelines = load_timelines(tdir)
    beats = load_heartbeats(tdir)
    if not timelines and not beats:
        return None
    n = max(list(timelines) + list(beats)) + 1 if (timelines or beats) \
        else 0
    monitor = FleetMonitor(tdir, num_workers=n, costdb=costdb,
                           drift_k=drift_k, interval=0.0)
    return monitor.poll(force=True)


def summarize_for_blackbox(tdir):
    """Straggler line for the blackbox report: None when no timelines
    (the fleet plane was off) or no significant skew."""
    timelines = load_timelines(tdir)
    if len(timelines) < 2:
        return None
    step, window, aligned = align_windows(timelines)
    skew = attribute_skew(window)
    if skew["straggler"] is None:
        return None
    st = skew["ranks"][skew["straggler"]]
    return {"straggler": skew["straggler"], "step": int(step),
            "aligned": bool(aligned), "skew_ms": skew["skew_ms"],
            "self_ms": st["self_ms"], "top_bucket": st["top_bucket"],
            "victims": skew["victims"]}


def render_report(rep):
    """The live-dashboard / CLI text table."""
    head = (f"fleet watch @ step {rep['step']}"
            + (" (aligned)" if rep["aligned"] else " (UNALIGNED — no "
               "common step across ranks yet)"))
    lines = [head,
             f"{'rank':>4}  {'step':>6}  {'step_ms':>8}  "
             f"{'self_ms':>8}  {'wait_ms':>8}  {'top bucket':<12} "
             f"{'role':<9} {'drift':<5}"]
    for key in sorted(rep["ranks"], key=int):
        r = int(key)
        row = rep["ranks"][key]
        role = ("STRAGGLER" if rep["straggler"] == r else
                "victim" if r in rep["victims"] else
                "done" if row.get("done") else "")
        fmt = (lambda v, w: f"{v:>{w}.1f}" if isinstance(
            v, (int, float)) else f"{'-':>{w}}")
        lines.append(
            f"{r:>4}  {row.get('step', -1):>6}  "
            f"{fmt(row.get('step_ms'), 8)}  "
            f"{fmt(row.get('self_ms'), 8)}  "
            f"{fmt(row.get('wait_ms'), 8)}  "
            f"{(row.get('top_bucket') or '-'):<12} {role:<9} "
            f"{(row.get('drift') or '-'):<5}")
    if rep["straggler"] is not None:
        lines.append(
            f"  skew {rep['skew_ms']:.1f}ms — straggler rank "
            f"{rep['straggler']}"
            + (f"; victims (grown wait): {rep['victims']}"
               if rep["victims"] else ""))
    else:
        lines.append("  no significant skew")
    for trip in rep.get("drift_trips") or []:
        lines.append(
            f"  DRIFT rank {trip['rank']} {trip['kind']}: measured "
            f"{trip['measured_ms']}ms vs predicted "
            f"{trip['predicted_ms']}ms ({trip['windows']} windows)")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.telemetry.fleet",
        description="post-hoc fleet report: straggler/victim "
                    "attribution + CostDB drift over the flushed "
                    "per-rank step timelines (works on crashed runs)")
    parser.add_argument("dir", help="telemetry directory with "
                                    "timeline_rank*.jsonl / "
                                    "hb_rank*.json")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable report")
    parser.add_argument("--costdb", default=None,
                        help="CostDB path for the drift check "
                             "(default: the shared cache DB)")
    parser.add_argument("--drift-k", type=int, default=3,
                        help="consecutive exceeded windows before the "
                             "drift trip fires (default 3)")
    args = parser.parse_args(argv)
    db = None
    if args.costdb:
        from .costdb import CostDB
        db = CostDB(args.costdb)
    rep = analyze_dir(args.dir, costdb=db, drift_k=args.drift_k)
    if rep is None:
        print(f"{args.dir}: no timeline_rank*.jsonl or hb_rank*.json "
              f"found (was the fleet plane armed? the launcher's "
              f"--watch)",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(rep, indent=2, default=str))
    else:
        print(render_report(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
