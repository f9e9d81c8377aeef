"""Measured per-op / per-collective cost database.

Counterpart of ``hetu_tpu/telemetry/costdb.py``. The auto-planner's cost
model (:mod:`..parallel.autoplan`) needs costs that are "estimated, then
refined by measurement". This module is the measurement substrate: one
persistent JSON table of measured milliseconds keyed like
``tune/autotune.py``'s cache — ``(platform, kind, shape, dtype)``, the
platform ``cpu`` or ``cuda-<card name>`` — so an entry measured on one
is never served to the other.

Three producers populate it:

* ``record_profile(db, records)`` — per-op timings from
  ``profiler.profile_op_records`` (the step's ops run one by one with a
  ``torch.cuda.synchronize()`` after each): one entry per (op kind,
  output shape, dtype).
* ``record_spans(db, events)`` — comm aggregates lifted from trace
  events: ``h2d_transfer`` / ``ps:pull`` / ``p2p_send`` / ``p2p_recv``
  spans carry byte counts, so each becomes a (kind, pow2-bucketed
  bytes) cost point measured in situ.
* ``comm_microbench(db)`` — a sweep of h2d/d2h copies on the device and,
  over a group of ranks, allreduce (``GroupComm.all_reduce``, as the
  data-parallel gradients go) and p2p (``parallel/p2p.py``'s channel,
  as a pipeline's boundaries go between ranks) over a size ladder;
  plus ``ps_microbench(db, client)`` for SparsePull/SparsePush against
  a live PS server. The resulting points feed ``curve()`` — a
  least-squares latency+bandwidth fit per comm kind, the function the
  planner queries (``estimate_ms(kind, nbytes)``).

Entries keep a running mean, min and sample count, so repeated
measurement refines rather than overwrites. Persistence mirrors the
autotune cache: atomic temp+rename writes under an advisory flock, with
a read-merge so two processes measuring different kinds against one
file don't drop each other's entries.

CLI::

    python -m hetu_tpu_torch.telemetry.costdb --show [--json]
    python -m hetu_tpu_torch.telemetry.costdb --sweep [--ranks N] \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

__all__ = ["CostDB", "default_db_path", "record_profile", "record_spans",
           "comm_microbench", "ps_microbench", "COMM_KINDS",
           "cold_start_ms", "cold_start_flops_ms", "pow2_bucket",
           "latency_crossover_bytes", "recommend_bucket_bytes", "main"]

_DB_ENV = "HETU_COSTDB"
_VERSION = 1

# the comm kinds the planner's cost model queries
COMM_KINDS = ("h2d", "d2h", "allreduce", "p2p", "ps_sparse_pull",
              "ps_sparse_push", "ps_pull", "ps_push")


def default_db_path():
    p = os.environ.get(_DB_ENV)
    if not p:
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "hetu_tpu", "costdb.json")
    p = os.path.expanduser(p)
    if p.endswith(".json"):
        return p
    return os.path.join(p, "costdb.json")


def _platform():
    from ..tune.autotune import platform_tag
    return platform_tag()


def _shape_str(shape):
    if shape is None:
        return "?"
    if isinstance(shape, (int, float)):
        return str(int(shape))
    try:
        dims = [str(int(d)) for d in shape]
    except TypeError:
        return str(shape)
    return "x".join(dims) if dims else "scalar"


# ---------------------------------------------------------------------------
# cold-start heuristics: the analytic floor the planner trusts when the
# DB has never measured a kind. The values are the JAX package's
# (hetu_tpu/telemetry/costdb.py), kept exactly: round-number assumptions
# whose job is to RANK plans on a fresh checkout, not rates of any link
# or card, and the committed fixture's plans depend on them. One
# comm_microbench sweep replaces them with measurements.
# ---------------------------------------------------------------------------

# assumed sustained rate per comm kind, GB/s
_COLD_GBPS = {"h2d": 8.0, "d2h": 8.0, "allreduce": 40.0, "p2p": 40.0,
              "ps_sparse_pull": 1.0, "ps_sparse_push": 1.0,
              "ps_pull": 1.0, "ps_push": 1.0,
              # a recompile is latency, not bytes: the GBps term only
              # keeps the arithmetic uniform
              "jit_compile": 1000.0}
_COLD_LATENCY_MS = {"h2d": 0.1, "d2h": 0.1, "allreduce": 0.05,
                    "p2p": 0.02, "ps_sparse_pull": 0.3,
                    "ps_sparse_push": 0.3, "ps_pull": 0.3,
                    "ps_push": 0.3,
                    # the reference's recompile latency floor (its
                    # efficiency lint prices recompiles against it)
                    "jit_compile": 200.0}
# assumed compute rate (GFLOP/s) for the FLOPs-proportional compute
# fallback when NO op of a graph was ever profiled; one profile of the
# graph (profiler.profile_op_records) replaces it
_COLD_GFLOPS = 50.0


def cold_start_ms(kind, nbytes):
    """Analytic latency+bandwidth floor for a comm kind the DB has no
    measurements for: ``latency + nbytes / bandwidth`` with the
    documented ``_COLD_*`` assumptions (unknown kinds get the slowest
    class). The planner's last resort — `coverage()` tells callers
    which estimates rest on it."""
    lat = _COLD_LATENCY_MS.get(kind, 0.3)
    gbps = _COLD_GBPS.get(kind, 1.0)
    return lat + max(0, int(nbytes)) / (gbps * 1e6)


def cold_start_flops_ms(flops):
    """FLOPs-proportional compute floor (``flops / _COLD_GFLOPS``) for
    ops with no profiled entry and no calibration anchor in the DB."""
    return max(0.0, float(flops)) / (_COLD_GFLOPS * 1e6)


def pow2_bucket(nbytes):
    """Round a byte count up to a power of two: span-derived transfer
    sizes vary per batch, but cost points only need size-class
    resolution to fit a latency/bandwidth curve."""
    n = max(1, int(nbytes))
    b = 1
    while b < n:
        b <<= 1
    return b


class CostDB:
    """Persistent measured-cost table; one JSON file, autotune-style
    ``platform|kind|shape|dtype`` keys."""

    def __init__(self, path=None):
        self.path = default_db_path() if path is None else os.fspath(path)
        self._entries = None
        self._lock = threading.RLock()

    # -- keys ------------------------------------------------------------
    @staticmethod
    def key(kind, shape, dtype="float32"):
        return "|".join((_platform(), str(kind), _shape_str(shape),
                         str(dtype)))

    # -- persistence (the autotune cache's discipline) -------------------
    def _load(self):
        if self._entries is not None:
            return self._entries
        entries = {}
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and doc.get("version") == _VERSION:
                entries = dict(doc.get("entries") or {})
        except (OSError, ValueError):
            pass                        # cold or corrupt: start fresh
        self._entries = entries
        return entries

    def save(self):
        """Atomic write (temp + rename) with a read-merge under an
        advisory flock, so two processes measuring different kinds
        against one file serialize instead of dropping entries. On-disk
        entries merge by sample count: whichever side has seen more
        measurements wins (our freshly-recorded side usually has)."""
        with self._lock:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            lf = None
            try:
                try:
                    import fcntl
                    lf = open(self.path + ".lock", "w")
                    fcntl.flock(lf, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    pass
                entries = self._load()
                try:
                    with open(self.path) as f:
                        doc = json.load(f)
                    if isinstance(doc, dict) and \
                            doc.get("version") == _VERSION:
                        for k, ent in (doc.get("entries") or {}).items():
                            ours = entries.get(k)
                            if ours is None or ent.get("n", 0) > \
                                    ours.get("n", 0):
                                entries[k] = ent
                        self._entries = entries
                except (OSError, ValueError):
                    pass
                tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"version": _VERSION, "entries": entries},
                              f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            finally:
                if lf is not None:
                    lf.close()

    # -- recording -------------------------------------------------------
    def record(self, kind, shape, dtype, ms, source="measure",
               nbytes=None):
        """Fold one measurement in: running mean + min + count. Returns
        the updated entry."""
        ks = self.key(kind, shape, dtype)
        with self._lock:
            entries = self._load()
            ent = entries.get(ks)
            ms = float(ms)
            if ent is None:
                ent = entries[ks] = {
                    "kind": str(kind), "shape": _shape_str(shape),
                    "dtype": str(dtype), "ms": round(ms, 5),
                    "min_ms": round(ms, 5), "n": 1, "source": source,
                    "ts": time.time()}
            else:
                n = int(ent.get("n", 1))
                ent["ms"] = round((ent["ms"] * n + ms) / (n + 1), 5)
                ent["min_ms"] = round(min(ent.get("min_ms", ms), ms), 5)
                ent["n"] = n + 1
                ent["source"] = source
                ent["ts"] = time.time()
            if nbytes is not None:
                # running mean like ms: ms is averaged over every
                # sample in the size class, so the curve-fit x-point
                # must be too — last-sample nbytes against mean ms
                # would skew the bandwidth fit by arrival order
                prev = ent.get("nbytes")
                n = int(ent.get("n", 1))
                if prev is None or n <= 1:
                    ent["nbytes"] = int(nbytes)
                else:
                    ent["nbytes"] = int(round(
                        (prev * (n - 1) + nbytes) / n))
        return dict(ent)

    # -- queries ---------------------------------------------------------
    def get(self, kind, shape, dtype="float32"):
        with self._lock:
            ent = self._load().get(self.key(kind, shape, dtype))
        return dict(ent) if ent else None

    def kinds(self):
        with self._lock:
            return sorted({e.get("kind", k.split("|")[1])
                           for k, e in self._load().items()})

    def entries(self):
        with self._lock:
            return {k: dict(v) for k, v in self._load().items()}

    def __len__(self):
        with self._lock:
            return len(self._load())

    def coverage(self, required=COMM_KINDS):
        """(measured, guessed) over ``required`` — the doctor's cost-DB
        coverage-gap report and the autoplan report's measured-vs-
        guessed split. Entries may be bare kinds (covered when ANY
        entry of that kind exists) or ``(kind, shape[, dtype])`` tuples
        (covered only by an exact entry — what the planner's per-op
        lookups actually hit). A kind in the second list is served by
        the cold-start heuristic, not a measurement."""
        have = set(self.kinds())
        measured, guessed = [], []
        for k in required:
            if isinstance(k, (tuple, list)):
                hit = self.get(*k) is not None
            else:
                hit = k in have
            (measured if hit else guessed).append(
                tuple(k) if isinstance(k, list) else k)
        return measured, guessed

    # -- comm curves -----------------------------------------------------
    def curve(self, kind):
        """Least-squares ``ms = latency + nbytes / bandwidth`` fit over
        every entry of ``kind`` that carries a byte count. Returns
        {latency_ms, GBps, points} or None with <2 points."""
        import numpy as np
        with self._lock:
            pts = [(e["nbytes"], e["ms"])
                   for e in self._load().values()
                   if e.get("kind") == kind and e.get("nbytes")]
        if len(pts) < 2:
            return None
        x = np.array([p[0] for p in pts], dtype=float)
        y = np.array([p[1] for p in pts], dtype=float)
        a = np.vstack([np.ones_like(x), x]).T
        (lat, slope), *_ = np.linalg.lstsq(a, y, rcond=None)
        lat = max(0.0, float(lat))
        # non-positive slope = latency-dominated over the measured
        # range (or noise): no bandwidth estimate, stay JSON-able
        gbps = round(1.0 / slope / 1e6, 3) if slope > 0 else None
        return {"latency_ms": round(lat, 5), "GBps": gbps,
                "points": len(pts)}

    def estimate_ms(self, kind, nbytes, cold_start=False):
        """Predicted milliseconds for moving ``nbytes`` through ``kind``
        from the fitted curve (exact entry preferred when one exists) —
        the query the cost-model planner makes. Size-class entries come
        from two producers with different dtype tags (span points are
        ``bytes``, microbench points ``float32``); try both.

        ``cold_start=True`` never returns None: a kind with no entries
        falls back to the cold-start heuristic
        (:func:`cold_start_ms`) so a fresh checkout can still rank
        plans — the planner reports which estimates came from
        measurement via :meth:`coverage` / :meth:`estimate_info`."""
        ms, _src = self.estimate_info(kind, nbytes,
                                      cold_start=cold_start)
        return ms

    def estimate_info(self, kind, nbytes, cold_start=True):
        """(ms, source) where source is ``"measured"`` (exact size-class
        entry), ``"curve"`` (latency+bandwidth fit), or
        ``"cold_start"`` (analytic heuristic; None when cold_start is
        off and the DB is empty for the kind)."""
        bucket = pow2_bucket(nbytes)
        ent = self.get(kind, bucket, "bytes") or self.get(kind, bucket)
        if ent is not None:
            return float(ent["ms"]), "measured"
        cv = self.curve(kind)
        if cv is not None:
            gbps = cv["GBps"]
            bw_ms = 0.0 if not gbps else nbytes / (gbps * 1e6)
            return cv["latency_ms"] + bw_ms, "curve"
        if not cold_start:
            return None, None
        return cold_start_ms(kind, nbytes), "cold_start"


# ---------------------------------------------------------------------------
# derived knob recommendations (the planner/efficiency-lint queries)
# ---------------------------------------------------------------------------

# bucket-size clamp for gradient-allreduce bucketing: below 1 MiB a
# bucket is still latency-dominated, above 64 MiB the tail collective
# stops overlapping the remaining backward (the DDP paper's regime)
_BUCKET_MIN = 1 << 20
_BUCKET_MAX = 64 << 20
_BUCKET_COLD = 4 << 20          # DDP's 25MB-class default, scaled down


def latency_crossover_bytes(db, kind="allreduce"):
    """Byte count where the fitted curve's bandwidth term equals its
    latency term — transfers below it are latency-dominated (the
    "fragmented collective" regime HT904 prices). Falls back to the
    cold-start constants when the DB has no curve for ``kind``."""
    cv = db.curve(kind) if db is not None else None
    if cv is not None and cv.get("GBps"):
        return int(cv["latency_ms"] * cv["GBps"] * 1e6)
    return int(_COLD_LATENCY_MS.get(kind, 0.3)
               * _COLD_GBPS.get(kind, 1.0) * 1e6)


def recommend_bucket_bytes(db=None):
    """CostDB-derived ``overlap_options.bucket_bytes`` default: 4x the
    measured allreduce latency-bandwidth crossover (so a bucket is
    ~80% bandwidth-bound), clamped to [1 MiB, 64 MiB]; the documented
    4 MiB cold-start default when no curve exists. The autoplan
    planner applies this to dp plans so ``parallel="auto"`` never
    ships the per-grad (HT904) collective pattern by default."""
    if db is None:
        return _BUCKET_COLD
    cv = db.curve("allreduce")
    if cv is None or not cv.get("GBps"):
        return _BUCKET_COLD
    return int(min(_BUCKET_MAX, max(
        _BUCKET_MIN, 4 * latency_crossover_bytes(db, "allreduce"))))


# ---------------------------------------------------------------------------
# producers
# ---------------------------------------------------------------------------

def record_profile(db, records, save=True):
    """Fold ``profiler.profile_op_records`` output into the DB; returns
    the number of entries touched."""
    n = 0
    for rec in records:
        db.record(rec["kind"], rec.get("shape"),
                  rec.get("dtype", "float32"), rec["ms"],
                  source="profile_ops")
        n += 1
    if save and n:
        db.save()
    return n


_SPAN_KIND = {"h2d_transfer": "h2d", "h2d_stacked": "h2d",
              "ps:pull": "ps_pull", "p2p_send": "p2p",
              "p2p_recv": "p2p"}


def record_spans(db, events, save=True):
    """Lift comm cost points from exported trace events: every complete
    span with a byte count becomes a (kind, pow2-bucketed bytes) entry
    measured in situ. Returns the number of points recorded."""
    n = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        kind = _SPAN_KIND.get(ev.get("name"))
        if kind is None:
            continue
        args = ev.get("args") or {}
        nbytes = args.get("bytes")
        dur = ev.get("dur")
        if not nbytes or dur is None:
            continue
        # KEY by the pow2 size class (stable across batches), but keep
        # the REAL byte count as the curve-fit x-point — fitting
        # against the rounded bucket would overstate bandwidth by up
        # to 2x
        db.record(kind, pow2_bucket(nbytes), "bytes", dur / 1000.0,
                  source="span", nbytes=nbytes)
        n += 1
    if save and n:
        db.save()
    return n


def _timeit_ms(run, sync, reps=3):
    from ..tune.autotune import timeit
    return timeit(run, sync=sync, reps=reps, windows=2) * 1000.0


def _sync_of(device):
    import torch
    if device.type == "cuda":
        return lambda _out: torch.cuda.synchronize(device)
    return None


def _collective_points(rank, device, comm, channel, nranks, sizes, reps):
    """allreduce and p2p ms at each size, as one rank of ``nranks``
    measures them: every rank runs the same calls in the same order (a
    collective each), rank ``rank``'s clock times them. p2p is a ring:
    each rank sends its tensor to the next and takes the previous one's,
    moved onto its device as a pipeline's boundary is."""
    import numpy as np
    import torch
    sync = _sync_of(device)
    rng = np.random.RandomState(rank)
    dst, calls = (rank + 1) % nranks, [0]
    points = []
    for nbytes in sizes:
        value = torch.from_numpy(
            rng.randn(max(1, nbytes // 4)).astype(np.float32)).to(device)
        ar_ms = _timeit_ms(lambda: comm.all_reduce(value),
                           sync, reps=reps)

        def hop():
            calls[0] += 1
            tag = f"costdb/p2p/{nbytes}/{calls[0]}"
            channel.send(dst, tag, value)
            return channel.recv(tag).to(device)

        p2p_ms = _timeit_ms(hop, sync, reps=reps)
        points.append((nbytes, ar_ms, p2p_ms))
    return points


def comm_microbench(db, sizes=None, reps=3, save=True, device=None,
                    ranks=None):
    """Sweep h2d/d2h copies (always) and allreduce/p2p over a group of
    ranks over a size ladder; every point lands in the DB as (kind,
    nbytes). Returns {kind: points_recorded}.

    ``device`` is where the copies and the ranks' tensors live (default
    the card; pass ``"cpu"`` for the CPU). The group: in a launcher's
    job (``torch.distributed`` joined, more than one rank) every rank of
    the job calls this, the collectives ride the job's group and its
    pipe channel, and rank 0 records; outside a job ``ranks`` (an int,
    default the card count, 1 on the CPU) thread ranks of this process
    over a :class:`~..parallel.mesh.LocalJob`, rank ``r`` on
    ``cuda:(r mod cards)``. One rank measures no collective."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..device import resolve_device
    from ..ops.comm import GroupComm
    from ..tune.autotune import platform_scope

    device = resolve_device(device)
    sizes = tuple(sizes or (1 << 14, 1 << 17, 1 << 20, 1 << 23))
    sync = _sync_of(device)
    in_job = dist.is_initialized() and dist.get_world_size() > 1
    my_rank = dist.get_rank() if in_job else 0
    out = {}
    with platform_scope(device):
        if my_rank == 0:
            rng = np.random.RandomState(0)
            for nbytes in sizes:
                host = torch.from_numpy(
                    rng.randn(nbytes // 4).astype(np.float32))
                ms = _timeit_ms(lambda: host.to(device, copy=True), sync,
                                reps=reps)
                db.record("h2d", nbytes, "float32", ms, source="comm_bench",
                          nbytes=nbytes)
                dev = host.to(device)
                ms = _timeit_ms(lambda: dev.to("cpu", copy=True), None,
                                reps=reps)
                db.record("d2h", nbytes, "float32", ms, source="comm_bench",
                          nbytes=nbytes)
            out["h2d"] = out["d2h"] = len(sizes)

        points = None
        if in_job:
            from ..parallel.mesh import Job
            got = _collective_points(my_rank, device, GroupComm(),
                                     Job.from_env().channel(),
                                     dist.get_world_size(), sizes, reps)
            points = got if my_rank == 0 else None
        else:
            if ranks is None:
                ranks = torch.cuda.device_count() \
                    if device.type == "cuda" else 1
            if int(ranks) > 1:
                points = _local_points(int(ranks), device, sizes, reps)
        if points is not None:
            for nbytes, ar_ms, p2p_ms in points:
                db.record("allreduce", nbytes, "float32", ar_ms,
                          source="comm_bench", nbytes=nbytes)
                db.record("p2p", nbytes, "float32", p2p_ms,
                          source="comm_bench", nbytes=nbytes)
            out["allreduce"] = out["p2p"] = len(sizes)
        if save and my_rank == 0:
            db.save()
    return out


def _local_points(n, device, sizes, reps):
    """:func:`_collective_points` over ``n`` thread ranks of this process
    (a LocalJob: gloo groups over one store, a loopback pipe channel
    each); rank 0's points."""
    import torch
    from ..ops.comm import GroupComm
    from ..parallel.local_ranks import DEFAULT_TIMEOUT_S
    from ..parallel.mesh import LocalJob

    local = LocalJob(n, timeout_s=DEFAULT_TIMEOUT_S)
    results, errors = [None] * n, []

    def run(r):
        try:
            job = local.job(r)
            dev = device
            if device.type == "cuda":
                dev = torch.device("cuda", r % torch.cuda.device_count())
                torch.cuda.set_device(dev)
            group = job.new_group(list(range(n)))
            results[r] = _collective_points(r, dev, GroupComm(group),
                                            job.channel(), n, sizes, reps)
        except BaseException as e:      # raised again on the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True,
                                name=f"hetu-costdb-rank{r}")
               for r in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEFAULT_TIMEOUT_S)
    finally:
        local.close()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"comm_microbench: a thread rank of {n} did not "
                           f"finish within {DEFAULT_TIMEOUT_S} s")
    return results[0]


def ps_microbench(db, client, tid=900_001, width=64, sizes=None,
                  reps=3, save=True):
    """SparsePull / SparsePush / dense Pull / dense Push size sweep
    against a live PS server (``client``: a ``ps.client.PSClient``).
    Registers its own scratch table under ``tid``. Returns
    {kind: points}."""
    import numpy as np

    sizes = tuple(sizes or (64, 512, 4096))   # rows per RPC
    nrows = max(sizes) * 2
    client.init_tensor(tid, (nrows, width), kind=1)
    client.init_tensor(tid + 1, (nrows * width,), kind=0)
    rng = np.random.RandomState(0)
    for rows in sizes:
        ids = rng.randint(0, nrows, rows).astype(np.int64)
        vals = rng.randn(rows, width).astype(np.float32)
        nbytes = rows * width * 4
        ms = _timeit_ms(lambda: client.sparse_pull(tid, ids, width),
                        lambda x: None, reps=reps)
        db.record("ps_sparse_pull", nbytes, "float32", ms,
                  source="ps_bench", nbytes=nbytes)
        ms = _timeit_ms(
            lambda: (client.sparse_push(tid, ids, vals, width),
                     client.wait(tid)),
            lambda x: None, reps=reps)
        db.record("ps_sparse_push", nbytes, "float32", ms,
                  source="ps_bench", nbytes=nbytes)
        dense_n = rows * width
        ms = _timeit_ms(lambda: client.pull(tid + 1, (dense_n,)),
                        lambda x: None, reps=reps)
        db.record("ps_pull", nbytes, "float32", ms, source="ps_bench",
                  nbytes=nbytes)
        grad = rng.randn(dense_n).astype(np.float32)
        ms = _timeit_ms(
            lambda: (client.push(tid + 1, grad), client.wait(tid + 1)),
            lambda x: None, reps=reps)
        db.record("ps_push", nbytes, "float32", ms, source="ps_bench",
                  nbytes=nbytes)
    if save:
        db.save()
    return {k: len(sizes) for k in ("ps_sparse_pull", "ps_sparse_push",
                                    "ps_pull", "ps_push")}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.telemetry.costdb",
        description="measured per-op/per-collective cost database")
    parser.add_argument("--db", default=None,
                        help=f"DB file (default ${_DB_ENV} or "
                             f"~/.cache/hetu_tpu/costdb.json)")
    parser.add_argument("--sweep", action="store_true",
                        help="run the comm microbench and record curves")
    parser.add_argument("--ranks", type=int, default=None,
                        help="thread ranks of the sweep's collectives "
                             "(default: the card count)")
    parser.add_argument("--device", default=None,
                        help="where the sweep runs (default: the card; "
                             "'cpu' for the CPU)")
    parser.add_argument("--show", action="store_true",
                        help="print the table summary")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    db = CostDB(args.db)
    if args.sweep:
        swept = comm_microbench(db, device=args.device, ranks=args.ranks)
        print(f"comm microbench: {swept}", file=sys.stderr)
    if args.json:
        doc = {"path": db.path, "entries": db.entries(),
               "curves": {k: cv for k in COMM_KINDS
                          for cv in [db.curve(k)] if cv}}
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    ents = db.entries()
    print(f"{db.path}: {len(ents)} entries, "
          f"{len(db.kinds())} kinds")
    if args.show or args.sweep:
        for ks in sorted(ents):
            e = ents[ks]
            print(f"  {ks}  {e['ms']:.4f} ms (min {e['min_ms']:.4f}, "
                  f"n={e['n']}, {e['source']})")
        present, missing = db.coverage()
        print(f"comm coverage: {present or '-'}; missing: "
              f"{missing or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
