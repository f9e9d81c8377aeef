"""Training health monitor: numerics sentinels on sampled steps,
embedding/staleness telemetry, and a divergence doctor.

Counterpart of ``hetu_tpu/telemetry/health.py``, with its records, trip
ladder, CLI and exit codes. The observability triad's third leg: the
black box (blackbox.py) explains runs that *crash* — this module catches
runs that are silently *wrong*. Three layers:

* **Sentinels on sampled steps** (executor.py ``SubExecutor.step`` +
  ``OptimizerOp.compute``): per-layer gradient global-norms, nonfinite
  counts, update/weight ratios, and the scalar loss. The reference
  computes them inside its jitted step every step and reads them every
  ``every_n`` steps; the port's step is eager, so it computes them only
  on a sampled step (``step % every_n == 0``, :meth:`HealthMonitor.wants`)
  and stacks them into one float64 tensor, which the monitor reads in
  ONE device-to-host copy. The records are the reference's (values off
  the cadence are never read); an off-cadence step does no extra device
  work and no host sync, and with the monitor off ``health_monitor is
  None`` is the only per-step check.
* **Sparse-side telemetry**: observed-staleness histograms for the
  bounded-staleness embedding caches (``observe_staleness`` — fed by
  ps/device_cache.py's SyncEmbedding refresh deltas and drain update
  counts, and cstable.py's shadow pending-update counters), hot-key
  skew from the pull id streams (``HealthMonitor.observe_ids``), and
  per-table row-norm / dead-row stats sampled from the server
  (``HealthMonitor.sample_tables``). The paper's consistency knob —
  cache_bound — becomes *measurable*: actual staleness vs the
  configured bound.
* **Trip ladder**: nonfinite values, grad-norm spikes vs a running
  baseline, and staleness-bound violations fire ``warn`` (log +
  metrics) → ``dump`` (flight ring + last-good health record through
  the crash-dump machinery, flight.py) → ``raise`` (HealthError), per
  ``HealthOptions.action``.

Everything lands as ``health`` spans / ``health_trip`` instants /
``health_*`` metrics plus a per-rank ``health_rank<r>.jsonl``, and

    python -m hetu_tpu_torch.telemetry.health <dir> [--json]

merges the rank files and reports first-bad-step, the layer/table that
tripped, and a ranked probable cause (lr spike, staleness violation,
data anomaly, rank divergence). The module imports no torch (a sampled
step's tensor is read with its own ``.cpu()``), so the CLI runs where no
card is.

Enable with ``Executor(health_options=...)`` (True / dict / spec
string) or fleet-wide via the launcher's ``--health SPEC`` (exports
``HETU_HEALTH``).
"""
from __future__ import annotations

import glob
import json
import logging
import math
import os
import re
import threading
import time
import weakref

import numpy as np

__all__ = ["HealthOptions", "HealthMonitor", "HealthError",
           "observe_staleness", "active", "last_summary",
           "merge_records", "diagnose", "format_report", "main"]

log = logging.getLogger(__name__)

# monitors registered for the module-level observation hooks
# (observe_staleness from ps/device_cache.py + cstable.py). WeakSet so
# abandoned executors' monitors are collectable; ``active()`` is the
# disabled path's entire cost — one falsy check, zero allocations.
_MONITORS = weakref.WeakSet()

# last sampled health summary in this process — bench.py emit() stamps
# loss_finite / grad_norm_final from it onto headline metrics. Reset
# when a new monitor is constructed so a bench unit that never sampled
# can't inherit the previous unit's verdict.
_LAST = None

# jsonl paths this process already opened: the FIRST open per process
# truncates (a rerun reusing a telemetry dir must not merge two runs'
# records in the doctor — the launcher clears stale files, but direct
# HETU_HEALTH=1 runs don't go through it), later monitors in the same
# process append (multi-executor runs accumulate into one timeline).
_OPENED_PATHS = set()


def active():
    """True when any health monitor is live in this process (the
    sparse-side hooks' zero-cost gate)."""
    return bool(_MONITORS)


def last_summary():
    """The most recent sampled health record's summary fields (or None
    when no monitor has sampled yet): ``{"step", "loss_finite",
    "grad_norm_total"}``."""
    return _LAST


def observe_staleness(kind, tid, values, bound, monitor=None):
    """Record observed staleness samples for one bounded-staleness
    table. ``kind``: ``"pull"`` (SyncEmbedding refresh deltas — how far
    behind the server a row actually ran before refresh), ``"push"``
    (per-row update counts claimed by a drain — local updates the
    server hadn't seen), or ``"cstable"`` (host-cache shadow pending
    counts, an upper bound). Only ``"push"`` samples past the bound
    count as violations — a pull-side refresh delta > bound is the
    protocol *enforcing* the bound, not breaking it.

    ``monitor`` scopes the observation to the owning executor's
    monitor (the PS runtime stamps it onto the cache objects it
    registers); without it the sample broadcasts to every live monitor
    — fine for single-executor processes, cross-attributed otherwise.
    """
    if monitor is not None:
        monitor._observe_staleness(kind, tid, values, bound)
        return
    if not _MONITORS:
        return
    for m in list(_MONITORS):
        m._observe_staleness(kind, tid, values, bound)


class HealthError(RuntimeError):
    """Raised by the ``raise`` rung of the trip ladder."""

    def __init__(self, trips, step):
        self.trips = trips
        self.step = step
        what = "; ".join(
            f"{t['kind']}"
            + (f" in layer {t['layer']!r}" if t.get("layer") else "")
            + (f" on table {t['table']}" if t.get("table") else "")
            for t in trips)
        super().__init__(
            f"training health trip at step {step}: {what} "
            f"(artifacts dumped; see health_rank*.jsonl)")


class HealthOptions:
    """Resolved ``Executor(health_options=...)`` configuration.

    Fields (all settable via dict or ``k=v,k=v`` spec string — the
    ``HETU_HEALTH`` env form the launcher exports):

    * ``every_n`` (10) — sampling cadence in steps: the sentinels
      compute, and the fetch+check runs, on every ``every_n``-th step.
    * ``action`` ("warn") — trip ladder top: ``warn`` logs + metrics;
      ``dump`` additionally dumps the flight ring and the last-good
      health record; ``raise`` additionally raises HealthError.
    * ``spike_factor`` (25.0) — grad-norm trip threshold as a multiple
      of the running EMA baseline.
    * ``warmup`` (3) — sampled records before spike checks arm.
    * ``baseline_decay`` (0.9) — EMA decay for the grad-norm baseline.
    * ``table_sample`` (64) — server rows sampled per table per check
      for row-norm / dead-row stats (0 disables the RPC).
    * ``hot_sample`` (4096) — ids sampled per pull for hot-key skew
      (0 disables).
    * ``out_dir`` — where ``health_rank<r>.jsonl`` lands; defaults to
      the telemetry out_dir / ``$HETU_TELEMETRY``.
    """

    _DEFAULTS = {"every_n": 10, "action": "warn", "spike_factor": 25.0,
                 "warmup": 3, "baseline_decay": 0.9, "table_sample": 64,
                 "hot_sample": 4096, "out_dir": None}
    _ACTIONS = ("warn", "dump", "raise")

    def __init__(self, enabled=False, **kw):
        self.enabled = bool(enabled)
        for k, v in self._DEFAULTS.items():
            setattr(self, k, v)
        for k, v in kw.items():
            if k not in self._DEFAULTS:
                raise ValueError(
                    f"unknown health option {k!r}; expected one of "
                    f"{sorted(self._DEFAULTS)}")
            setattr(self, k, v)
        if self.action not in self._ACTIONS:
            raise ValueError(
                f"health action must be one of {self._ACTIONS}, got "
                f"{self.action!r}")
        self.every_n = max(1, int(self.every_n))

    @classmethod
    def resolve(cls, arg):
        """``Executor(health_options=...)`` argument -> HealthOptions.
        None reads ``HETU_HEALTH`` (the launcher contract); False/"0"
        disables; True enables defaults; dict / spec-string configure.
        """
        if isinstance(arg, cls):
            return arg
        if arg is None:
            arg = os.environ.get("HETU_HEALTH") or False
        if arg is False:
            return cls(enabled=False)
        if arg is True:
            return cls(enabled=True)
        if isinstance(arg, dict):
            d = dict(arg)
            enabled = bool(d.pop("enabled", True))
            return cls(enabled=enabled, **d)
        if isinstance(arg, str):
            return cls._from_spec(arg)
        raise TypeError(
            f"health_options must be None/bool/dict/str/HealthOptions, "
            f"got {type(arg).__name__}")

    @classmethod
    def _from_spec(cls, spec):
        spec = spec.strip()
        if spec.lower() in ("", "0", "off", "false", "no"):
            return cls(enabled=False)
        if spec.lower() in ("1", "on", "true", "yes"):
            return cls(enabled=True)
        kw = {}
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if "=" not in tok:
                raise ValueError(
                    f"bad HETU_HEALTH token {tok!r}; expected k=v")
            k, v = (s.strip() for s in tok.split("=", 1))
            if k in ("every_n", "warmup", "table_sample", "hot_sample"):
                v = int(v)
            elif k in ("spike_factor", "baseline_decay"):
                v = float(v)
            kw[k] = v
        return cls(enabled=True, **kw)


def _finite_or_none(x):
    """float(x) for JSONL, nonfinite -> None (strict JSON; the
    ``*_finite`` flags and nonfinite counts carry the signal)."""
    try:
        v = float(x)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


def _unpack(h, vals):
    """A sampled step's sentinels as the reference's host pytree:
    ``{"layers": {name: {"grad_norm", "nonfinite", "update_ratio"}},
    "loss"}`` from ``vals``, the step's stacked float64 values (three a
    layer in ``h["names"]`` order, then the loss where ``h["loss"]``)."""
    out = {"layers": {n: {"grad_norm": vals[3 * i],
                          "nonfinite": vals[3 * i + 1],
                          "update_ratio": vals[3 * i + 2]}
                      for i, n in enumerate(h["names"])}}
    if h["loss"]:
        out["loss"] = vals[-1]
    return out


class HealthMonitor:
    """Per-executor training health monitor (one per enabled config).

    On a sampled step (:meth:`wants`) the executor stacks the step's
    sentinels into one tensor on the subexecutor (``sub._last_health``:
    ``{"names", "loss", "values"}``) and calls :meth:`after_step` /
    :meth:`after_block`; the monitor fetches it (one ``.cpu()`` of a
    handful of float64 scalars), folds in the sparse-side observations,
    checks the trip conditions, appends a JSONL record, and fires the
    action ladder."""

    def __init__(self, options, telemetry=None):
        self.opts = options
        self.tel = telemetry            # may be disabled; spans gated
        self.rank = getattr(telemetry, "rank", None)
        if self.rank is None:
            self.rank = int(os.environ.get(
                "HETU_PROC_ID", os.environ.get("HETU_PS_RANK", "0")))
        self.out_dir = (options.out_dir
                        or getattr(telemetry, "out_dir", None)
                        or os.environ.get("HETU_TELEMETRY"))
        self.records = []               # sampled records (bounded)
        self.trips = []                 # every trip fired
        self.sample_wall_ms = 0.0       # host cost accounting (tests)
        self._baseline = None
        self._samples = 0
        self._stale = {}                # (kind, tid) -> accumulator
        self._hot = {}                  # tid -> {id: count}
        self._hot_n = {}                # tid -> ids observed
        self._lock = threading.Lock()
        self._fh = None
        self._dumped = False
        self._closed = False
        self._last_good = None
        _MONITORS.add(self)
        # a fresh monitor means a fresh executor: the process-global
        # summary must not carry the previous executor's verdict into
        # this one's bench stamps
        global _LAST
        _LAST = None

    # -- executor hooks --------------------------------------------------
    def wants(self, step):
        """Whether step ``step`` (1-based, as :meth:`after_step` counts
        it) is sampled: the executor computes the sentinels on those
        steps only."""
        return not self._closed and step % self.opts.every_n == 0

    def after_step(self, sub, runtime=None):
        """Called once per completed step (plain and PS paths). Cheap
        off-cadence: one modulo. At cadence: one fetch + check."""
        h = getattr(sub, "_last_health", None)
        if h is None or self._closed:
            return
        step = sub.step_count
        if step % self.opts.every_n:
            return
        sub._last_health = None         # read once
        t0 = time.perf_counter()
        host = _unpack(h, h["values"].cpu().numpy())    # one d2h copy
        self._sample(sub, host, step, runtime)
        self.sample_wall_ms += (time.perf_counter() - t0) * 1000.0

    def after_block(self, sub, health_stacked, step0, nsteps,
                    runtime=None):
        """Block path: the sampled steps' sentinels arrive stacked
        ``[sampled steps, ...]`` (``{"names", "loss", "values"}``, the
        reference's scan stacks all ``nsteps``); the sampled steps
        inside the block are checked from ONE fetch."""
        if health_stacked is None or self._closed:
            return
        every = self.opts.every_n
        sampled = [k for k in range(1, nsteps + 1)
                   if (step0 + k) % every == 0]
        if not sampled:
            return
        t0 = time.perf_counter()
        rows = health_stacked["values"].cpu().numpy()   # one d2h copy
        if len(rows) != len(sampled):
            raise ValueError(f"{len(rows)} stacked sentinel rows for "
                             f"sampled steps {sampled}")
        for i, k in enumerate(sampled):
            row = _unpack(health_stacked, rows[i])
            # every sampled step in the block sees the SAME post-block
            # server state: run the table-sampling RPC sweep once (on
            # the last record), not once per sampled step
            rt = runtime if i == len(sampled) - 1 else None
            self._sample(sub, row, step0 + k, rt)
        self.sample_wall_ms += (time.perf_counter() - t0) * 1000.0

    # -- sparse-side observation hooks -----------------------------------
    def _observe_staleness(self, kind, tid, values, bound):
        values = np.atleast_1d(np.asarray(values))
        if not len(values):
            return
        vmax = float(values.max())
        with self._lock:
            ent = self._stale.setdefault(
                (kind, int(tid)),
                {"n": 0, "sum": 0.0, "max": 0.0,
                 "bound": float(bound), "violations": 0})
            ent["n"] += int(len(values))
            ent["sum"] += float(values.sum())
            ent["max"] = max(ent["max"], vmax)
            if kind == "push":
                ent["violations"] += int((values > bound).sum())
        tel = self.tel
        if tel is not None and tel.enabled:
            # bounded subsample into the streaming histogram
            for v in values[:128]:
                tel.observe(f"staleness_{kind}", float(v))

    def observe_ids(self, tid, ids):
        """Feed a pull id stream sample (hot-key skew accounting)."""
        k = self.opts.hot_sample
        if not k:
            return
        ids = np.asarray(ids).ravel()[:k]
        if not len(ids):
            return
        uniq, counts = np.unique(ids, return_counts=True)
        with self._lock:
            c = self._hot.setdefault(int(tid), {})
            for i, n in zip(uniq, counts):
                i = int(i)
                c[i] = c.get(i, 0) + int(n)
            self._hot_n[int(tid)] = \
                self._hot_n.get(int(tid), 0) + int(len(ids))
            if len(c) > (1 << 16):
                # bound memory on huge id spaces: keep the hot half
                keep = sorted(c.items(), key=lambda kv: -kv[1])[:1 << 15]
                self._hot[int(tid)] = dict(keep)

    def hot_ids(self, tid, k=1024):
        """Top-``k`` hottest ids observed for table ``tid`` since the
        last drain — the tiered PS store pre-warms these into its DRAM
        pool (measured placement, not a guessed prefix)."""
        with self._lock:
            c = self._hot.get(int(tid))
            if not c:
                return np.empty(0, np.int64)
            top = sorted(c.items(), key=lambda kv: -kv[1])[:k]
        return np.asarray([i for i, _ in top], dtype=np.int64)

    def _drain_sparse(self):
        with self._lock:
            stale, self._stale = self._stale, {}
            hot, self._hot = self._hot, {}
            hot_n, self._hot_n = self._hot_n, {}
        stale_out = {}
        for (kind, tid), ent in stale.items():
            stale_out[f"{kind}:{tid}"] = {
                "kind": kind, "table": str(tid), "n": ent["n"],
                "mean": round(ent["sum"] / max(1, ent["n"]), 3),
                "max": ent["max"], "bound": ent["bound"],
                "violations": ent["violations"]}
        hot_out = {}
        for tid, c in hot.items():
            total = sum(c.values())
            if not total:
                continue
            top = sorted(c.values(), reverse=True)
            hot_out[str(tid)] = {
                "n": hot_n.get(tid, total), "unique": len(c),
                "top1_share": round(top[0] / total, 4),
                "top8_share": round(sum(top[:8]) / total, 4)}
        return stale_out, hot_out

    def sample_tables(self, runtime, step):
        """Row-norm / dead-row stats from a bounded server sample of
        every registered embedding table. Best effort: a health RPC
        must never take down the data path."""
        k = self.opts.table_sample
        if runtime is None or not k:
            return {}
        out = {}
        try:
            rng = np.random.default_rng(step)
            seen = set()
            tables = [(rt.tid, rt.rows, rt.width)
                      for rt in runtime.device_tables.values()]
            for op in runtime.config.ps_nodes:
                p = getattr(op, "parameter", None)
                if p is not None and getattr(p, "is_embed", False):
                    tables.append((p.id, int(p.shape[0]),
                                   int(np.prod(p.shape[1:]))))
            for tid, rows, width in tables:
                if tid in seen or rows <= 0:
                    continue
                seen.add(tid)
                n = min(k, rows)
                ids = rng.choice(rows, size=n, replace=False) \
                    if rows > n else np.arange(rows)
                sampled = runtime.client.sparse_pull(tid, ids, width)
                norms = np.linalg.norm(
                    sampled.reshape(n, -1).astype(np.float64), axis=1)
                out[str(tid)] = {
                    "rows_sampled": int(n),
                    "row_norm_mean": round(float(norms.mean()), 4),
                    "row_norm_max": round(float(norms.max()), 4),
                    "dead_frac": round(float((norms < 1e-12).mean()), 4)}
                tel = self.tel
                if tel is not None and tel.enabled:
                    tel.set_gauge(f"ps_table_{tid}_dead_frac",
                                  out[str(tid)]["dead_frac"])
                    tel.set_gauge(f"ps_table_{tid}_row_norm_mean",
                                  out[str(tid)]["row_norm_mean"])
        except Exception as e:         # noqa: BLE001 — telemetry only
            log.warning("health: table sampling failed: %s", e)
        return out

    # -- the sampled check ----------------------------------------------
    def _sample(self, sub, host, step, runtime):
        tel = self.tel
        t0n = tel.clock() if tel is not None and tel.enabled else 0
        layers = {}
        total_sq = 0.0
        any_nonfinite = False
        for name, m in (host.get("layers") or {}).items():
            gn = float(m["grad_norm"])
            nf = int(m["nonfinite"])
            ur = float(m["update_ratio"])
            if nf > 0 or not math.isfinite(gn):
                any_nonfinite = True
            layers[name] = {"grad_norm": _finite_or_none(gn),
                            "nonfinite": nf,
                            "update_ratio": _finite_or_none(ur)}
            if math.isfinite(gn):
                total_sq += gn * gn
        total = math.sqrt(total_sq) if not any_nonfinite else float("nan")
        loss = float(host["loss"]) if "loss" in host else None
        loss_finite = loss is None or math.isfinite(loss)
        lr = None
        for opt in getattr(sub, "optimizer_ops", []):
            lr = float(opt.optimizer.learning_rate)
            break
        stale, hot = self._drain_sparse()
        tables = self.sample_tables(runtime, step)

        rec = {"step": int(step), "rank": self.rank,
               "t": round(time.time(), 3),
               "subgraph": getattr(sub, "name", None),
               "loss": _finite_or_none(loss),
               "loss_name": getattr(sub, "_health_loss_name", None),
               "loss_finite": bool(loss_finite),
               "grad_norm_total": _finite_or_none(total),
               "lr": lr,
               "baseline": _finite_or_none(self._baseline),
               "layers": layers}
        if stale:
            rec["staleness"] = stale
        if hot:
            rec["hot_keys"] = hot
        if tables:
            rec["tables"] = tables

        trips = self._check(rec, total, loss_finite)
        rec["trips"] = trips

        # baseline EMA over finite totals only (a NaN baseline would
        # disarm the spike check forever)
        if math.isfinite(total):
            d = self.opts.baseline_decay
            self._baseline = total if self._baseline is None \
                else d * self._baseline + (1 - d) * total
        self._samples += 1

        self.records.append(rec)
        if len(self.records) > 1024:
            del self.records[:512]
        if not trips:
            self._last_good = rec
        self._write(rec)
        global _LAST
        _LAST = {"step": rec["step"], "loss_finite": rec["loss_finite"],
                 "grad_norm_total": rec["grad_norm_total"]}

        if tel is not None and tel.enabled:
            if math.isfinite(total):
                tel.observe("health_grad_norm", total)
            tel.set_gauge("health_last_step", int(step))
            for t in trips:
                args = {"step": int(step), "kind": t["kind"]}
                if t.get("layer"):
                    args["layer"] = t["layer"]
                if t.get("table"):
                    args["table"] = t["table"]
                v = _finite_or_none(t.get("value"))
                if v is not None:
                    args["value"] = v
                lim = _finite_or_none(t.get("limit"))
                if lim is not None:
                    args["limit"] = lim
                tel.instant("health_trip", **args)
            tel.complete("health", t0n, tel.clock(),
                         {"step": int(step), "layers": len(layers),
                          "trips": len(trips)})
        if trips:
            self._fire(trips, rec)

    def _check(self, rec, total, loss_finite):
        trips = []
        if not loss_finite:
            trips.append({"kind": "nonfinite", "what": "loss",
                          "layer": None,
                          "value": None, "limit": None})
        bad = [(n, m) for n, m in rec["layers"].items()
               if m["nonfinite"] > 0 or m["grad_norm"] is None]
        if bad:
            n0, m0 = bad[0]
            trips.append({"kind": "nonfinite", "what": "grad",
                          "layer": n0, "value": float(m0["nonfinite"]),
                          "limit": 0, "layers_affected": len(bad)})
        elif (self._baseline is not None
                and self._samples >= self.opts.warmup
                and math.isfinite(total)
                and total > self.opts.spike_factor * self._baseline):
            worst = max(rec["layers"].items(),
                        key=lambda kv: kv[1]["grad_norm"] or 0.0,
                        default=(None, None))[0]
            trips.append({"kind": "grad_spike", "what": "grad",
                          "layer": worst, "value": total,
                          "limit": self.opts.spike_factor
                          * self._baseline})
        for key, ent in (rec.get("staleness") or {}).items():
            if ent["violations"]:
                trips.append({"kind": "staleness", "what": ent["kind"],
                              "layer": None, "table": ent["table"],
                              "value": ent["max"],
                              "limit": ent["bound"]})
        return trips

    # -- trip ladder ------------------------------------------------------
    def _fire(self, trips, rec):
        self.trips.extend(trips)
        for t in trips:
            log.warning(
                "health trip at step %d: %s%s%s (value=%s limit=%s)",
                rec["step"], t["kind"],
                f" layer={t['layer']}" if t.get("layer") else "",
                f" table={t['table']}" if t.get("table") else "",
                t.get("value"), t.get("limit"))
        tel = self.tel
        if tel is not None and tel.enabled:
            tel.inc("health_trips", len(trips))
        if self.opts.action in ("dump", "raise") and not self._dumped:
            self._dump(trips, rec)
        if self.opts.action == "raise":
            raise HealthError(trips, rec["step"])

    def _dump(self, trips, rec):
        """The ladder's dump rung: flight ring + last-good health
        record via the crash-dump machinery (flight.py; once per
        monitor)."""
        self._dumped = True
        if self._fh is not None:
            try:
                self._fh.flush()
            except OSError:
                pass
        if self.out_dir:
            try:
                os.makedirs(self.out_dir, exist_ok=True)
                path = os.path.join(
                    self.out_dir, f"health_lastgood_rank{self.rank}.json")
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump(self._last_good or rec, f)
                os.replace(tmp, path)
            except OSError:
                pass
        tel = self.tel
        if tel is not None and tel.enabled and tel.out_dir:
            reason = "health trip: " + trips[0]["kind"]
            if tel.flight is not None:
                tel.flight.dump(tel.out_dir, reason=reason)
            tel.flush()

    # -- output ----------------------------------------------------------
    def _write(self, rec):
        if not self.out_dir:
            return
        # one lock over open AND write: an ingest-worker observation
        # and the step loop's sample can race both the first open
        # (HT605 check-then-create — only one may truncate the file)
        # and the write itself (TextIOWrapper is not thread-safe; two
        # interleaved json lines corrupt the record the doctor parses)
        with self._lock:
            if self._fh is None:
                if not self.out_dir:
                    return              # a failed open already gave up
                try:
                    os.makedirs(self.out_dir, exist_ok=True)
                    path = os.path.join(
                        self.out_dir, f"health_rank{self.rank}.jsonl")
                    mode = "a" if path in _OPENED_PATHS else "w"
                    _OPENED_PATHS.add(path)
                    self._fh = open(path, mode)
                except OSError:
                    self.out_dir = None     # never retry per step
                    return
            try:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()
            except (OSError, ValueError):
                pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        _MONITORS.discard(self)
        with self._lock:                # serialize vs an in-flight _write
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# ---------------------------------------------------------------------------
# divergence doctor: merge health_rank<r>.jsonl files and rank causes
# ---------------------------------------------------------------------------

def merge_records(tdir):
    """{rank: [records sorted by step]} from ``health_rank*.jsonl``
    files under ``tdir`` (torn trailing lines skipped)."""
    out = {}
    for path in glob.glob(os.path.join(tdir, "health_rank*.jsonl")):
        m = re.search(r"health_rank(\d+)\.jsonl$", path)
        if m is None:
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
                        continue        # torn tail
                    if isinstance(rec, dict) and "step" in rec:
                        recs.append(rec)
        except OSError:
            continue
        recs.sort(key=lambda r: r["step"])
        out[int(m.group(1))] = recs
    return out


def _rec_bad(rec):
    if rec.get("trips"):
        return True
    if rec.get("loss_finite") is False:
        return True
    for m in (rec.get("layers") or {}).values():
        if m.get("nonfinite"):
            return True
    return False


def _rank_causes(ranks, first_bad, bad_rank, bad_rec):
    """Ranked probable causes for the first bad step."""
    causes = {}

    def add(cause, score, detail):
        if cause not in causes or causes[cause]["score"] < score:
            causes[cause] = {"cause": cause, "score": round(score, 2),
                             "detail": detail}

    trip_kinds = {t.get("kind") for t in (bad_rec.get("trips") or [])}

    # staleness violation observed at/before the first bad step
    stale_steps = [rec["step"] for recs in ranks.values() for rec in recs
                   if rec["step"] <= first_bad
                   and any(t.get("kind") == "staleness"
                           for t in rec.get("trips") or [])]
    if stale_steps:
        add("staleness_violation", 0.9,
            f"bounded-staleness violation first observed at step "
            f"{min(stale_steps)}, at/before first bad step {first_bad} "
            f"— check cache_bound vs the drain cadence")

    prior = [r for r in ranks.get(bad_rank, [])
             if r["step"] < first_bad]
    lrs = [r["lr"] for r in prior if r.get("lr")]
    if lrs and bad_rec.get("lr"):
        med = sorted(lrs)[len(lrs) // 2]
        if med > 0 and bad_rec["lr"] > 1.5 * med:
            add("lr_spike", 0.85,
                f"lr at the bad step is {bad_rec['lr']:g} vs a prior "
                f"median of {med:g} — scheduler spike")
    gpre = [r["grad_norm_total"] for r in prior
            if r.get("grad_norm_total")]
    if len(gpre) >= 2 and gpre[0] > 0 and gpre[-1] > 5 * gpre[0]:
        add("lr_spike", 0.6,
            f"grad norms grew {gpre[-1] / gpre[0]:.1f}x over the "
            f"samples before the trip — optimization instability "
            f"(lr too high for this phase)")

    # rank divergence: only a subset of ranks bad at the first bad
    # step, or finite losses across ranks disagree on a common step
    if len(ranks) >= 2:
        at_bad = {r: next((rec for rec in recs
                           if rec["step"] == first_bad), None)
                  for r, recs in ranks.items()}
        have = {r: rec for r, rec in at_bad.items() if rec}
        if len(have) >= 2:
            badness = {r: _rec_bad(rec) for r, rec in have.items()}
            if any(badness.values()) and not all(badness.values()):
                bad_rs = sorted(r for r, b in badness.items() if b)
                add("rank_divergence", 0.8,
                    f"only rank(s) {bad_rs} tripped at step "
                    f"{first_bad}; the other ranks were healthy — "
                    f"rank-local data or comm corruption")
            else:
                losses = {r: rec.get("loss") for r, rec in have.items()
                          if rec.get("loss") is not None}
                if len(losses) >= 2:
                    vs = list(losses.values())
                    spread = max(vs) - min(vs)
                    scale = max(1e-9, max(abs(v) for v in vs))
                    if spread / scale > 1e-3:
                        add("rank_divergence", 0.55,
                            f"losses diverge across ranks at step "
                            f"{first_bad} (spread {spread:g})")

    # data anomaly: went nonfinite with NO preceding grad growth and
    # a stable lr — a bad input batch is the usual source
    if "nonfinite" in trip_kinds:
        stable_grads = (len(gpre) < 2
                        or gpre[-1] <= 3 * max(gpre[0], 1e-12))
        stable_lr = not ("lr_spike" in causes
                         and causes["lr_spike"]["score"] >= 0.8)
        if stable_grads and stable_lr \
                and "staleness_violation" not in causes:
            add("data_anomaly", 0.7,
                "loss/grads went nonfinite with no preceding grad-norm "
                "growth and a stable lr — inspect the input batches "
                "around the first bad step")
        elif not causes:
            add("numeric_instability", 0.4,
                "nonfinite values with mixed signals — inspect the "
                "named layer's activations/grads around the bad step")
    return sorted(causes.values(), key=lambda c: -c["score"])


def diagnose(tdir):
    """Analyze one directory of ``health_rank*.jsonl`` files; returns a
    plain-dict report or None when nothing is there."""
    ranks = merge_records(tdir)
    if not ranks:
        return None
    first_bad, bad_rec, bad_rank = None, None, None
    bad_ranks = set()
    for r, recs in sorted(ranks.items()):
        for rec in recs:
            if _rec_bad(rec):
                bad_ranks.add(r)
                if first_bad is None or rec["step"] < first_bad:
                    first_bad, bad_rec, bad_rank = rec["step"], rec, r
    trips = (bad_rec or {}).get("trips") or []
    layer = next((t.get("layer") for t in trips if t.get("layer")), None)
    table = next((t.get("table") for t in trips if t.get("table")), None)
    last = {r: recs[-1] for r, recs in ranks.items() if recs}
    loss_finite = all(rec.get("loss_finite", True)
                      for rec in last.values())
    return {
        "dir": tdir,
        "ranks": sorted(ranks),
        "records": {str(r): len(recs) for r, recs in ranks.items()},
        "last_step": max((rec["step"] for rec in last.values()),
                         default=-1),
        "healthy": first_bad is None,
        "loss_finite": bool(loss_finite),
        "first_bad_step": first_bad,
        "bad_rank": bad_rank,
        "bad_ranks": sorted(bad_ranks),
        "trip_kinds": sorted({t.get("kind") for t in trips
                              if t.get("kind")}),
        "layer": layer,
        "table": table,
        "probable_causes": ([] if first_bad is None
                            else _rank_causes(ranks, first_bad,
                                              bad_rank, bad_rec)),
    }


def summarize_for_blackbox(tdir):
    """Compact health summary the blackbox post-mortem folds into its
    verdict; None when no health files exist."""
    rep = diagnose(tdir)
    if rep is None:
        return None
    return {k: rep[k] for k in
            ("healthy", "loss_finite", "first_bad_step", "bad_rank",
             "bad_ranks", "trip_kinds", "layer", "table", "last_step")}


def format_report(rep):
    lines = [f"training health: {rep['dir']}"]
    for r in rep["ranks"]:
        lines.append(f"  rank {r}: {rep['records'][str(r)]} sampled "
                     f"record(s)")
    if rep["healthy"]:
        lines.append(f"  HEALTHY through step {rep['last_step']} "
                     f"(loss_finite={str(rep['loss_finite']).lower()})")
        return "\n".join(lines)
    what = ", ".join(rep["trip_kinds"]) or "trip"
    where = ""
    if rep["layer"]:
        where += f" layer {rep['layer']!r}"
    if rep["table"]:
        where += f" table {rep['table']}"
    lines.append(f"  FIRST BAD STEP {rep['first_bad_step']} on rank "
                 f"{rep['bad_rank']}: {what}{where}")
    if rep["bad_ranks"]:
        lines.append(f"  tripped rank(s): {rep['bad_ranks']}")
    if rep["probable_causes"]:
        lines.append("  probable causes (ranked):")
        for c in rep["probable_causes"]:
            lines.append(f"    {c['score']:.2f}  {c['cause']}: "
                         f"{c['detail']}")
    else:
        lines.append("  no probable cause ranked — inspect the trip "
                     "records in health_rank*.jsonl")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    import sys
    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.telemetry.health",
        description="merge per-rank health_rank<r>.jsonl files and "
                    "report first-bad-step, the tripped layer/table, "
                    "and ranked probable causes")
    parser.add_argument("dir", help="telemetry directory with "
                                    "health_rank*.jsonl files")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable report")
    args = parser.parse_args(argv)
    rep = diagnose(args.dir)
    if rep is None:
        print(f"{args.dir}: no health_rank*.jsonl files found",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(rep, indent=2, default=str))
    else:
        print(format_report(rep))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
