"""The doctor-validated soundness twin of the efficiency lint (HT910).

Counterpart of ``hetu_tpu/analysis/perfcheck.py``. The static pass
(``analysis/efficiency.py``) *prices* inefficiencies in predicted
ms/step; this module holds those prices to what a step measures — the
rangecheck idiom applied to performance. A short telemetry-traced
training window runs, the perf doctor (``telemetry/doctor.py``)
attributes every step to disjoint buckets, and each priced static claim
is held against the **measured** bucket it charges
(``efficiency.DOCTOR_BUCKET``):

* **soundness gate** — a claim's ``estimated_ms_per_step`` must not
  exceed what its measured bucket contains, past a documented bound
  (:data:`SOUND_FACTOR` x measured + :data:`SOUND_SLACK_MS`). A
  violation is an **HT910** error: the pricing model promised savings a
  real step has no room for.
* **constant-feed detection** (HT905's dynamic half) — feeds whose bytes
  are identical across every measured step are re-transferred h2d each
  step for nothing; statically unknowable, measured here.
* **A/B confirmation** — :func:`ab_bucketed_allreduce` measures the
  bucketed-vs-per-gradient collective delta the HT904 pricing predicts,
  between two thread ranks over ``GroupComm`` (gloo), with the
  prediction made from a curve fitted on the same machine's measured
  points; the test gate holds the two within :data:`AB_TOLERANCE`.

CLI::

    python -m hetu_tpu_torch.analysis.perfcheck [models...] [--steps N]
        [--json] [--device cpu|cuda]

drives the default zoo pair (mlp + wdl_adult — a dense and a sparse
path) on the card unless ``--device`` names another, validates every
surviving priced claim, and exits 1 on any HT910 violation.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from .findings import Report
from .efficiency import DOCTOR_BUCKET, efficiency_pass
# a priced claim survives while estimated_ms_per_step <= SOUND_FACTOR x
# measured-bucket ms/step + SOUND_SLACK_MS; past that, the static model
# is inventing time that the measured step does not contain. Defined in
# telemetry/fleet.py, whose torch-free CLI reads the same bound.
from ..telemetry.fleet import SOUND_FACTOR, SOUND_SLACK_MS

__all__ = ["measure_buckets", "soundness_pass", "perfcheck_model",
           "perfcheck_session", "ab_bucketed_allreduce", "serving_claim_check",
           "SOUND_FACTOR", "SOUND_SLACK_MS", "AB_TOLERANCE", "main"]

# measured-vs-predicted agreement bound for the HT904 A/B: predictions
# come from a latency+bandwidth curve fitted on this machine's own
# measured collective points, so the two must agree within 4x either
# way (host dispatch jitter dominates below the ms scale)
AB_TOLERANCE = 4.0

# feeds below this never matter for HT905's constant-feed check
_CONST_FEED_FLOOR = 64 << 10


def measure_buckets(executor, feed_fn, steps=8, name="default"):
    """Drive ``steps`` ``run()`` calls and return the doctor's
    per-step bucket attribution ``{bucket: ms/step}`` for the window
    (plus the raw attribution dict). The executor must have been built
    with a telemetry sink whose ``out_dir`` we can flush and read."""
    from ..telemetry import doctor

    tel = executor.config.telemetry
    if not (tel.enabled and tel.out_dir):
        raise ValueError("measure_buckets needs an executor built with "
                         "Telemetry(enabled=True, out_dir=...)")
    for i in range(steps):
        executor.run(name, feed_dict=feed_fn(i))
    tel.flush()
    per = doctor.attribute_trace(tel.out_dir)
    if not per:
        return {}, None
    label = next(iter(per))
    return dict(per[label]["per_step_ms"]), per[label]


def soundness_pass(findings, measured_buckets, report=None,
                   factor=SOUND_FACTOR, slack_ms=SOUND_SLACK_MS):
    """Hold every priced static claim against the measured bucket it
    charges. Emits HT910 errors into ``report``; returns (report,
    checked count). Claims with no bucket (HT908 advisories) and
    buckets the doctor did not measure are vacuous."""
    if report is None:
        report = Report()
    checked = 0
    for f in findings:
        bucket = f.data.get("bucket") or DOCTOR_BUCKET.get(f.code)
        claim = f.data.get("estimated_ms_per_step")
        if bucket is None or claim is None or \
                bucket not in measured_buckets:
            continue
        checked += 1
        measured = float(measured_buckets[bucket])
        bound = factor * measured + slack_ms
        if float(claim) > bound:
            report.add(
                "HT910", "error",
                f"{f.code} claims {float(claim):.4f} ms/step of "
                f"savings from the '{bucket}' bucket, but the measured "
                f"bucket holds only {measured:.4f} ms/step (bound "
                f"{bound:.4f} = {factor:g}x + {slack_ms:g}) — the "
                f"pricing model is unsound here; re-measure the "
                f"CostDB or fix the estimator", node=f.node,
                where=f.where, claim_code=f.code,
                claimed_ms=round(float(claim), 6),
                measured_ms=round(measured, 6))
    return report, checked


def serving_claim_check(claimed_tokens_per_s, counted_tokens, wall_s,
                        factor=SOUND_FACTOR):
    """The serving half of the HT910 attribution discipline: a bench's
    *claimed* tokens/sec must agree with the rate its own telemetry
    counters support — ``counted_tokens`` (the engine's ``<name>_tokens``
    counter delta over the measured window) divided by the window's
    wall clock. Within ``factor`` either way the claim is attributed;
    outside it, the bench's workload arithmetic and the engine's token
    accounting have drifted apart and the number is asserted, not
    measured. Returns ``(ok, measured_tokens_per_s)``."""
    wall_s = float(wall_s)
    if wall_s <= 0 or counted_tokens <= 0:
        return False, 0.0
    measured = float(counted_tokens) / wall_s
    claimed = float(claimed_tokens_per_s)
    if claimed <= 0:
        return False, measured
    ratio = claimed / measured
    return (1.0 / factor) <= ratio <= factor, measured


def _as_numpy(value):
    """A feed as numpy (a tensor on the card is copied back)."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _constant_feeds(feed_history, report, costdb=None):
    """HT905 dynamic half: feeds byte-identical across every measured
    step re-pay their h2d each step for nothing. ``feed_history`` is
    [{node: array}] per step."""
    from .efficiency import _db

    if len(feed_history) < 2:
        return report
    db = _db(costdb)
    first = feed_history[0]
    for node, arr in first.items():
        a0 = _as_numpy(arr)
        if a0.nbytes < _CONST_FEED_FLOOR:
            continue
        same = all(np.array_equal(a0, _as_numpy(h[node]))
                   for h in feed_history[1:] if node in h)
        if not same:
            continue
        ms, source = db.estimate_info("h2d", a0.nbytes)
        report.add(
            "HT905", "warn",
            f"feed {getattr(node, 'name', node)} was byte-identical "
            f"across {len(feed_history)} measured steps "
            f"({a0.nbytes / 1e6:.2f} MB) — a constant re-transferred "
            f"h2d every step; put it on the device once (or make it a "
            f"Variable) instead of feeding it", node=node,
            estimated_ms_per_step=round(ms, 6),
            bucket=DOCTOR_BUCKET["HT905"], source=source,
            bytes=int(a0.nbytes))
    return report


def perfcheck_session(executor, eval_nodes, feed_fn, feed_shapes=None,
                      steps=8, costdb=None, name="default"):
    """Hold one session's priced claims to its measured steps: drive
    ``steps`` telemetry-traced ``run()`` calls of ``executor`` (built
    with ``Telemetry(enabled=True, out_dir=...)``), doctor-attribute
    them, price the executor's topo order (comm ops spliced) in the
    dtype the session computes in, keyed by its device's CostDB
    partition, and gate every surviving claim (HT910) plus the dynamic
    constant-feed check. Returns ``{"report", "checked", "buckets",
    "attribution", "static", "op_ms", "sources"}`` — ``report`` holds
    HT910 + dynamic findings, ``static`` the priced lint."""
    from .shapes import shape_pass
    from ..parallel.autoplan import _session_feed_shapes
    from ..tune.autotune import platform_scope

    history = []

    def recorded(i):
        feeds = feed_fn(i)
        history.append(feeds)
        return feeds

    buckets, attribution = measure_buckets(executor, recorded, steps=steps,
                                           name=name)
    config = executor.config
    topo = executor.subexecutors[name].topo_order
    if config.dtype is not None:
        feed_shapes = _session_feed_shapes(topo, feed_shapes, config.dtype)
    dtypes, op_ms, sources = {}, {}, {}
    static = Report()
    with platform_scope(config.device):
        shapes = shape_pass(topo, Report(), feed_shapes=feed_shapes,
                            dtypes_out=dtypes)
        efficiency_pass(topo, static, shapes=shapes, dtypes=dtypes,
                        config=config, costdb=costdb,
                        eval_nodes=eval_nodes, steps=steps,
                        op_ms_out=op_ms, sources_out=sources)
    report, checked = soundness_pass(static.findings, buckets)
    _constant_feeds(history, report, costdb=costdb)
    return {"report": report, "checked": checked, "buckets": buckets,
            "attribution": attribution, "static": static,
            "op_ms": op_ms, "sources": sources}


def perfcheck_model(model, steps=8, costdb=None, feed_fn=None,
                    tel_dir=None, device=None):
    """Round-trip one zoo model on ``device`` (None: the card) through
    :func:`perfcheck_session`. Returns ``(report, claims_checked,
    buckets, static_report)`` — ``report`` holds HT910 + dynamic
    findings."""
    from . import zoo
    from .rangecheck import _synth_feeds
    from .shapes import _resolve_feed_shapes
    from ..executor import Executor
    from ..graph.autodiff import find_topo_sort
    from ..telemetry import Telemetry

    eval_nodes, feed_shapes = zoo.build(model)
    specs = _resolve_feed_shapes(feed_shapes,
                                 find_topo_sort(list(eval_nodes)))
    if feed_fn is None:
        def feed_fn(i):                     # noqa: F811 — default feeds
            return _synth_feeds(specs, seed=i)

    own_dir = tel_dir is None
    if own_dir:
        tel_dir = tempfile.mkdtemp(prefix="perfcheck_")
    tel = Telemetry(enabled=True, out_dir=tel_dir, rank=0)
    exe = Executor(list(eval_nodes), telemetry=tel, device=device)
    try:
        got = perfcheck_session(exe, eval_nodes, feed_fn,
                                feed_shapes=feed_shapes, steps=steps,
                                costdb=costdb)
    finally:
        exe.close()
        if own_dir:
            # the attribution is already in memory; don't leak a trace
            # dir per invocation (out_dir=None disarms the atexit
            # flush that would otherwise re-write into the removed dir)
            import shutil
            shutil.rmtree(tel_dir, ignore_errors=True)
            tel.out_dir = None
    return got["report"], got["checked"], got["buckets"], got["static"]


# ---------------------------------------------------------------------------
# HT904 measured A/B: per-grad vs bucketed collective emission
# ---------------------------------------------------------------------------

def ab_bucketed_allreduce(n_grads=12, nbytes=1 << 14, reps=8, db=None,
                          device=None, ranks=2):
    """Measure the fragmented-vs-bucketed collective delta the HT904
    pricing predicts, between ``ranks`` thread ranks of this process
    over ``GroupComm`` (gloo, as ``costdb``'s sweep measures it), their
    tensors on ``device`` (default the card): ``n_grads`` separate
    ``all_reduce`` calls of ``nbytes`` each, against one over the
    concatenation. The *prediction* comes from a latency+bandwidth
    curve fitted to collective points measured here first (the exact
    estimate_info path HT904 prices with), so predicted and measured
    deltas must agree within :data:`AB_TOLERANCE` either way.

    Returns ``{predicted_ms, measured_ms, per_grad_ms, bucketed_ms,
    n_grads, nbytes, curve}`` as rank 0 measured them — or None with
    fewer than two ranks (no collective to measure)."""
    import torch

    from ..device import resolve_device
    from ..telemetry.costdb import CostDB, on_thread_ranks
    from ..tune.autotune import platform_scope, timeit

    if int(ranks) < 2:
        return None
    device = resolve_device(device)
    if db is None:
        # in-memory only: never save()d, so no file/dir to clean up
        db = CostDB(os.path.join(tempfile.gettempdir(),
                                 "perfab_unwritten.json"))
        db._entries = {}        # don't read a stale file either

    def body(rank, dev, comm, _job):
        rng = np.random.RandomState(rank)

        def value(total_bytes):
            n = max(1, total_bytes // 4)
            return torch.from_numpy(
                rng.randn(n).astype(np.float32)).to(dev)

        if dev.type == "cuda":
            def sync(_out):
                torch.cuda.synchronize(dev)
        else:
            sync = None

        def ms(run):
            return timeit(run, sync=sync, reps=reps) * 1000.0

        # fit the curve from measured points at both size classes — the
        # same producer HT904's estimate_info consumes
        points = []
        for sz in (nbytes, n_grads * nbytes):
            v = value(sz)
            points.append((sz, ms(lambda: comm.all_reduce(v))))
        grads = [value(nbytes) for _ in range(n_grads)]
        big = value(n_grads * nbytes)

        def per_grad():
            for g in grads:
                comm.all_reduce(g)
            return grads[-1]

        per_grad_ms = ms(per_grad)
        bucketed_ms = ms(lambda: comm.all_reduce(big))
        return points, per_grad_ms, bucketed_ms

    points, per_grad_ms, bucketed_ms = on_thread_ranks(
        int(ranks), device, body)[0]
    with platform_scope(device):
        for sz, point_ms in points:
            db.record("allreduce", sz, "float32", point_ms,
                      source="perfcheck", nbytes=sz)
        predicted = (n_grads * db.estimate_info("allreduce", nbytes)[0]
                     - db.estimate_info("allreduce",
                                        n_grads * nbytes)[0])
        curve = db.curve("allreduce")
    measured = per_grad_ms - bucketed_ms
    return {"predicted_ms": round(predicted, 4),
            "measured_ms": round(measured, 4),
            "per_grad_ms": round(per_grad_ms, 4),
            "bucketed_ms": round(bucketed_ms, 4),
            "n_grads": n_grads, "nbytes": nbytes, "curve": curve}


DEFAULT_MODELS = ("mlp", "wdl_adult")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.analysis.perfcheck",
        description="doctor-validated soundness twin: run zoo models "
                    "under the trace, attribute measured buckets, and "
                    "gate every priced HT9xx claim against them "
                    "(HT910)")
    parser.add_argument("models", nargs="*",
                        help=f"zoo models (default: "
                             f"{' '.join(DEFAULT_MODELS)})")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--device", default=None,
                        help="the device the steps run on (default: "
                             "the card; 'cpu' runs the plain versions "
                             "of the kernels)")
    args = parser.parse_args(argv)

    models = args.models or list(DEFAULT_MODELS)
    rc = 0
    out = {}
    for model in models:
        report, checked, buckets, static = perfcheck_model(
            model, steps=args.steps, device=args.device)
        viol = [f for f in report.findings if f.code == "HT910"]
        out[model] = {
            "claims": len(static), "checked": checked,
            "violations": len(viol),
            "dynamic_findings": len(report) - len(viol),
            "buckets": {b: v for b, v in buckets.items() if v > 0}}
        if not args.json:
            print(f"== {model}: {'ok' if not viol else 'UNSOUND'} "
                  f"({len(static)} priced claim(s), {checked} checked "
                  f"against measured buckets, {len(viol)} "
                  f"violation(s))")
            for f in report.findings:
                print("   " + str(f))
        if viol:
            rc = 1
    if args.json:
        print(json.dumps(out, indent=2))
    return rc


if __name__ == "__main__":
    import sys
    sys.exit(main())
