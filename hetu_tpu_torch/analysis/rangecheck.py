"""The measured-range harness: the numerics verifier's dynamic twin.

Counterpart of ``hetu_tpu/analysis/rangecheck.py``. The static pass
(``analysis/numerics.py``) derives per-node value intervals; this module
measures them. A :class:`RangeRecorder` attached to an executor arms a
:class:`RangeCapture` on its sub-executor: on a step of the recorder's
``every_n`` cadence the eager walk reduces each floating-point value to
an f32 ``(min, max)`` on the device as it is produced, before the walk
frees it, and folds the step's pairs into one device tensor, with the
running min/max of the steps captured since the last read (a
``run_batches`` block's); ``sample()`` reads it in one copy.
Off cadence, or with no recorder, the walk does no work, no host sync
and no allocation for it. The reference reduces inside its compiled
step on every step instead, and fetches at the cadence: the fetched
ranges are the same. The twin relationship is enforced both ways:

* **soundness gate** — every measured per-op range must lie inside the
  static interval; an escape is an ``HT810`` error (the static model
  lied, which would silence every HT801/HT804 built on it), and
* **measured-range DB** — measured ranges persist in an atomic-JSON
  :class:`RangeDB` keyed by ``numerics.stable_keys`` (topo position
  and op type, stable across rebuilds), and
  ``numerics_pass(measured=...)`` re-seeds from them, turning loose
  initializer bounds into tight measured ones on re-analysis.

A session the walk cannot measure as the graph's values raises at
``attach()``, naming its mode: a staged pipeline, thread ranks, or a
tensor-parallel rank (which holds shards and partial sums). A
data-parallel rank measures its own rows.

CLI::

    python -m hetu_tpu_torch.analysis.rangecheck [models...] [--db PATH]
        [--steps N] [--device cpu|cuda]

drives a few training steps of the named zoo models (default: mlp and
wdl_adult, a dense and a sparse path) on synthetic feeds, on the card
unless ``--device`` names another, validates the soundness gate and
persists the DB. Exit 1 on any violation.
"""
from __future__ import annotations

import json
import math
import os
import tempfile

import numpy as np
import torch

from ..ndarray import IndexedSlices
from .findings import Report
from .numerics import stable_keys

__all__ = ["RangeDB", "RangeRecorder", "measure_ranges",
           "soundness_pass", "rangecheck_model", "main"]

# measured values may touch the static bound exactly; compare with a
# hair of slack so float32 round trips do not fabricate violations
_SLACK_ABS = 1e-6
_SLACK_REL = 1e-5


def default_db_path():
    p = os.environ.get("HETU_RANGEDB")
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "hetu_tpu_torch", "ranges.json")


class RangeDB:
    """The persistent measured-range database (atomic JSON):
    ``{model: {stable_key: {"lo", "hi", "n"}}}`` with a running min/max
    merge across runs."""

    def __init__(self, path=None):
        self.path = path or default_db_path()
        self.data = {}
        self._load()

    def _load(self):
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if isinstance(raw, dict):
                self.data = raw.get("models", {})
        except (OSError, ValueError):
            self.data = {}          # corrupt or absent: a cold start

    def get(self, model):
        """{stable_key: (lo, hi)} of one model, or None."""
        ent = self.data.get(model)
        if not ent:
            return None
        return {k: (v["lo"], v["hi"]) for k, v in ent.items()
                if isinstance(v, dict) and "lo" in v and "hi" in v}

    def update(self, model, measured):
        """Merge ``{stable_key: (lo, hi)}`` with a running min/max."""
        ent = self.data.setdefault(model, {})
        for key, (lo, hi) in measured.items():
            cur = ent.get(key)
            if cur is None:
                ent[key] = {"lo": float(lo), "hi": float(hi), "n": 1}
            else:
                cur["lo"] = min(cur["lo"], float(lo))
                cur["hi"] = max(cur["hi"], float(hi))
                cur["n"] = int(cur.get("n", 0)) + 1

    def save(self):
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": 1, "models": self.data}, f,
                          indent=1)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


class RangeCapture:
    """What the eager walk (``SubExecutor.step``) calls while a recorder
    is attached: ``wants(step)`` once a step, then, on a captured step,
    ``observe(i, value)`` for the value of topo node ``i`` as it is
    produced and ``end_step()`` after the walk. The pairs stay on the
    device until :meth:`take`."""

    def __init__(self, every_n=1):
        self.every_n = every_n
        self._idx, self._lo, self._hi = [], [], []
        # [(topo indices, [k, 2] f32 (min, max))], consecutive steps of
        # the same indices folded into one entry
        self._pending = []

    def wants(self, step):
        """Whether step number ``step`` (1-based) is captured."""
        return step % self.every_n == 0

    def observe(self, i, value):
        if isinstance(value, IndexedSlices):
            value = value.values    # the gathered rows, as the reference
        if not isinstance(value, torch.Tensor) \
                or not value.is_floating_point() or value.numel() == 0:
            return
        lo, hi = torch.aminmax(value.detach())
        self._idx.append(i)
        self._lo.append(lo)
        self._hi.append(hi)

    def end_step(self):
        if not self._idx:
            return
        idx = tuple(self._idx)
        pairs = torch.stack([torch.stack(self._lo).float(),
                             torch.stack(self._hi).float()], dim=1)
        self._idx, self._lo, self._hi = [], [], []
        if self._pending and self._pending[-1][0] == idx:
            prev = self._pending[-1][1]
            # torch.minimum / maximum propagate NaN, as the reference's
            # jnp.min / max do
            pairs = torch.stack([torch.minimum(prev[:, 0], pairs[:, 0]),
                                 torch.maximum(prev[:, 1], pairs[:, 1])],
                                dim=1)
            self._pending[-1] = (idx, pairs)
        else:
            self._pending.append((idx, pairs))

    def take(self):
        """``[(topo index, lo, hi)]`` of the steps captured since the
        last take, read to the host in one copy; None where none was."""
        if not self._pending:
            return None
        host = torch.cat([p for _, p in self._pending]).cpu().tolist()
        idx = [i for ids, _ in self._pending for i in ids]
        self._pending = []
        return [(i, lo, hi) for i, (lo, hi) in zip(idx, host)]


def _refusal(executor, sub):
    """The mode a recorder cannot measure, or None."""
    from ..executor import SubExecutor
    if getattr(executor, "_threads", None) is not None:
        return ("a session of thread ranks (each rank walks its own "
                "clone of the graph)")
    if not isinstance(sub, SubExecutor):
        return (f"a staged pipeline ({type(sub).__name__}: the stages "
                f"walk their own parts of the graph)")
    if sub.tp is not None:
        return ("a tensor-parallel rank (its values are shards and "
                "partial sums, not the graph's)")
    return None


class RangeRecorder:
    """Attach to an executor's subgraph; read the captured per-node
    ranges at the cadence; keep the running measured min/max per
    node."""

    def __init__(self, executor, name="default", every_n=1):
        self.executor = executor
        self.name = name
        self.every_n = max(1, int(every_n))
        self.sub = executor.subexecutors[name]
        self.measured = {}          # node name -> [lo, hi]
        self.fetches = 0
        self._attached = False

    def attach(self):
        why = _refusal(self.executor, self.sub)
        if why is not None:
            raise NotImplementedError(
                f"RangeRecorder: {why} is not measured; record the "
                f"graph on a single-device session")
        self.sub._range_capture = RangeCapture(self.every_n)
        self._attached = True
        return self

    def detach(self):
        if self._attached:
            self.sub._range_capture = None
            self._attached = False

    def sample(self):
        """Read the captured ranges (call after ``run()`` or
        ``run_batches()``; off the cadence it reads nothing)."""
        if self.sub.step_count % self.every_n:
            return
        cap = getattr(self.sub, "_range_capture", None)
        got = cap.take() if cap is not None else None
        if got is None:
            return
        self.fetches += 1
        tel = self.executor.config.telemetry
        if tel is not None and tel.enabled:
            tel.inc("rangecheck_fetches")
            tel.set_gauge("rangecheck_nodes", len({i for i, _, _ in got}))
        topo = self.sub.topo_order
        for i, lo, hi in got:
            name = topo[i].name
            cur = self.measured.get(name)
            if cur is None:
                self.measured[name] = [lo, hi]
            else:
                # min()/max() keep a NaN only where it comes first:
                # propagate it explicitly, as the device fold does
                cur[0] = lo if math.isnan(lo) else min(cur[0], lo)
                cur[1] = hi if math.isnan(hi) else max(cur[1], hi)

    def by_stable_key(self):
        """Measured ranges keyed by ``numerics.stable_keys`` (the DB's
        key space: node names embed the process-wide id counter and do
        not survive a rebuild)."""
        topo = self.sub.topo_order
        keys = stable_keys(topo)
        out = {}
        for node, key in zip(topo, keys):
            m = self.measured.get(node.name)
            if m is not None:
                out[key] = (m[0], m[1])
        return out


def measure_ranges(executor, feed_fn, steps=4, name="default",
                   every_n=1):
    """Drive ``steps`` ``run()`` calls feeding ``feed_fn(step)`` with a
    recorder attached; returns ``{stable_key: (lo, hi)}``."""
    rec = RangeRecorder(executor, name=name, every_n=every_n).attach()
    try:
        for i in range(steps):
            executor.run(name, feed_dict=feed_fn(i))
            rec.sample()
    finally:
        rec.detach()
    return rec.by_stable_key()


def soundness_pass(topo, static_ranges, measured, report=None):
    """Every measured range must lie inside its static interval; an
    unknown static interval is vacuous (counted out, not a finding).
    Emits HT810 errors; returns (report, checked count)."""
    if report is None:
        report = Report()
    keys = stable_keys(topo)
    by_key = {k: n for k, n in zip(keys, topo)}
    static_by_key = {k: static_ranges.get(n)
                     for k, n in zip(keys, topo)}
    checked = 0
    for key, m in measured.items():
        s = static_by_key.get(key)
        if s is None:
            continue
        checked += 1
        # per-endpoint slack from the FINITE endpoint checked: a
        # half-bounded static interval (exp's [lo, inf)) still enforces
        # its finite side, and a NaN measurement — the very failure the
        # verifier exists for — is always a violation
        viol = math.isnan(m[0]) or math.isnan(m[1])
        if not viol and math.isfinite(s[0]) \
                and m[0] < s[0] - (_SLACK_ABS + _SLACK_REL * abs(s[0])):
            viol = True
        if not viol and math.isfinite(s[1]) \
                and m[1] > s[1] + (_SLACK_ABS + _SLACK_REL * abs(s[1])):
            viol = True
        if viol:
            node = by_key.get(key)
            report.add(
                "HT810", "error",
                f"measured range [{m[0]:.4g}, {m[1]:.4g}] escapes the "
                f"static interval [{s[0]:.4g}, {s[1]:.4g}] for {key} — "
                f"the abstract interpretation is unsound here (fix the "
                f"transfer rule or the seed)", node=node)
    return report, checked


def _synth_feeds(feed_shapes, seed=0):
    """Deterministic synthetic feeds per (shape, dtype) spec: modest
    normals for floats, small non-negative ids for integers (always
    valid rows of the zoo's tables)."""
    from .shapes import _kind, dtype_name
    rng = np.random.RandomState(seed)
    feeds = {}
    for node, (shape, dt) in feed_shapes.items():
        if dt is not None and _kind(dt) in "iu":
            feeds[node] = rng.randint(0, 8, size=shape).astype(
                dtype_name(dt))
        else:
            # numpy has no bf16: the executor casts a float feed to the
            # session's dtype itself
            name = dtype_name(dt) if dt in (torch.float16,
                                            torch.float64) else "float32"
            feeds[node] = (rng.standard_normal(shape) * 0.5).astype(name)
    return feeds


def rangecheck_model(model, steps=4, every_n=1, db=None, seed=0,
                     device=None):
    """Round-trip one zoo model on ``device`` (None: the card): run
    ``steps`` training steps with the capture on, soundness-check
    measured against static, fold into the DB. Returns (report,
    measured, checked)."""
    from . import zoo
    from .numerics import numerics_pass
    from .shapes import _resolve_feed_shapes, shape_pass
    from ..executor import Executor
    from ..graph.autodiff import find_topo_sort

    eval_nodes, feed_shapes = zoo.build(model)
    specs = _resolve_feed_shapes(feed_shapes, find_topo_sort(eval_nodes))

    exe = Executor(eval_nodes, device=device)
    measured = measure_ranges(
        exe, lambda i: _synth_feeds(specs, seed=seed + i), steps=steps,
        every_n=every_n)

    # the static side runs over the EXECUTOR's topo order (comm ops
    # spliced), so the stable keys line up with the measured capture
    topo = exe.subexecutors["default"].topo_order
    dtypes = {}
    shapes = shape_pass(topo, Report(), feed_shapes=feed_shapes,
                        dtypes_out=dtypes)
    static = numerics_pass(topo, Report(), shapes=shapes, dtypes=dtypes)
    report, checked = soundness_pass(topo, static, measured)
    if db is not None:
        db.update(model, measured)
    return report, measured, checked


DEFAULT_MODELS = ("mlp", "wdl_adult")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.analysis.rangecheck",
        description="measured-range harness: run zoo models with the "
                    "per-op range capture, validate every measured "
                    "range against the static interval, persist the "
                    "range DB")
    parser.add_argument("models", nargs="*",
                        help=f"zoo models (default: "
                             f"{' '.join(DEFAULT_MODELS)})")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--every-n", type=int, default=1)
    parser.add_argument("--db", default=None, metavar="PATH",
                        help="range DB path (default: $HETU_RANGEDB or "
                             "~/.cache/hetu_tpu_torch/ranges.json)")
    parser.add_argument("--device", default=None,
                        help="the device the steps run on (default: "
                             "the card; 'cpu' runs the plain versions "
                             "of the kernels)")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    models = args.models or list(DEFAULT_MODELS)
    db = RangeDB(args.db)
    rc = 0
    out = {}
    for model in models:
        report, measured, checked = rangecheck_model(
            model, steps=args.steps, every_n=args.every_n, db=db,
            seed=0, device=args.device)
        ok = not report.errors
        out[model] = {"measured": len(measured), "checked": checked,
                      "violations": len(report.errors)}
        if not args.json:
            print(f"== {model}: {'ok' if ok else 'UNSOUND'} "
                  f"({len(measured)} node(s) measured, {checked} "
                  f"checked against a static interval, "
                  f"{len(report.errors)} violation(s))")
            for f in report.errors:
                print("   " + str(f))
        if not ok:
            rc = 1
    db.save()
    if args.json:
        print(json.dumps({"db": db.path, "models": out}, indent=2))
    else:
        print(f"range DB written to {db.path}")
    return rc


if __name__ == "__main__":
    import sys
    sys.exit(main())
