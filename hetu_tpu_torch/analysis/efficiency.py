"""Pass 7 — the CostDB-priced static performance lint (HT9xx).

Counterpart of ``hetu_tpu/analysis/efficiency.py``. The other passes
cover crash (HT1xx–HT4xx) and silently wrong (HT8xx); this one covers
**slow**: the patterns the perf doctor diagnoses after a run has paid
for them — recompile storms, GEMM padding waste, host syncs on the hot
path, fragmented collectives, redundant reshards, dead compute, untuned
kernels — found statically over the topo order and the session's plan,
and **priced** through the measured CostDB (``telemetry/costdb.py``
``estimate_info``), so every finding carries an
``estimated_ms_per_step`` a reviewer can rank by.

Codes (severity: ``warn`` where the priced cost clears the ms
threshold, ``info`` below it — an HT9xx finding is never an ``error``
and never blocks a launch; HT908 is always advisory)::

  HT901  recompile hazard: more distinct dispatch signatures than the
         budget whose varying dims are not pow2-bucketed (the serving
         bucketing contract is the clean model). A pure function of the
         signatures it is handed: the port's eager walk compiles
         nothing, so no executor hook calls it
  HT902  GEMM padding waste on the card: matmul / conv dims misaligned
         to the granule at which an H100 GEMM's time steps (per dtype,
         measured: :data:`_GRANULE`), priced as the share of the op's
         ms the padding takes on the card's roofline (the padded-work
         fraction where the GEMM is compute-bound, nothing where its
         bytes bound it); an embedding's gathered rows rounded up to the
         32-byte DRAM sector, priced at the card's copy rate
  HT903  host sync on the hot path: per-step scalar fetches beyond a
         budget; in a host script's step loop ``.item()``,
         ``.asnumpy()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()`` or
         ``np.asarray`` of a run result, ``torch.cuda.synchronize()``
  HT904  fragmented collectives: optimizer-bound per-gradient
         allreduces in the CostDB's latency regime while
         ``overlap_options.bucket_bytes`` is unset, priced as the
         latency delta against bucketed emission
  HT905  redundant reshard: gather-then-identical-resplit Dispatch
         chains (per-step h2d of constant feeds is ``perfcheck``'s
         dynamic half), priced from the comm curves
  HT906  cost-weighted dead compute: the HT110 dead-subgraph lint with
         predicted ms attached
  HT907  untuned hot-path kernel: flash-attention call sites whose
         autotune cache has no entry — armed once the kernels offer
         more than one block configuration (ROADMAP item 13)
  HT908  CostDB coverage gap (advisory): hot ops priced from guesses

Every finding carries ``estimated_ms_per_step``, ``estimated_pct``
(share of the predicted step), ``bucket`` (the perf doctor's bucket the
claim charges: ``analysis/perfcheck.py`` holds each priced claim against
the measured bucket, HT910) and ``source`` (``measured`` / ``curve`` /
``cold_start``). ``# ht-ok: HT9xx <reason>`` on the construction line
waives a finding (``findings.suppressed_at``).

CLI::

    python -m hetu_tpu_torch.analysis.efficiency [models...] [--json]
        [--out efficiency_report.json] [--costdb PATH]
        [--threshold-ms MS] [--scripts PATH...]

runs every zoo model, prints the findings sorted by predicted savings,
and exits 1 when an unsuppressed warn-or-error finding survives. The
prices are only as good as the CostDB: measure it on the card
(``profiler.profile_ops(costdb=...)``, ``python -m
hetu_tpu_torch.telemetry.costdb --sweep``); cold-start prices are
guesses.
"""
from __future__ import annotations

import ast
import json
import os

import numpy as np
import torch

from .findings import Report, suppressed, suppressed_at

__all__ = ["efficiency_pass", "predict", "EfficiencyResult", "op_costs",
           "recompile_pass", "check_host_sync_source", "check_zoo",
           "sorted_by_savings", "DOCTOR_BUCKET", "DEFAULT_MS_THRESHOLD",
           "main"]

# warn-vs-info pricing threshold (ms/step); HETU_EFF_THRESHOLD_MS
# overrides per process
DEFAULT_MS_THRESHOLD = 0.05

# one-time costs (recompiles, autotune sweeps) amortize over this many
# steps for the per-step price when the caller knows no step count
_AMORTIZE_STEPS = 1000

# the perf-doctor bucket each code's claimed savings would come out of
# (telemetry/doctor.py BUCKETS) — perfcheck's soundness gate joins the
# static claim to the measured bucket through this map
DOCTOR_BUCKET = {"HT901": "jit", "HT902": "compute",
                 "HT903": "unaccounted", "HT904": "collective",
                 "HT905": "h2d_ingest", "HT906": "compute",
                 "HT907": "jit"}

# distinct dispatch signatures a session may accumulate before HT901
# calls it churn (train + eval + a couple of block variants)
RECOMPILE_BUDGET = 4

# HT902 floors: below these, padding is real but not worth a finding
_FLOPS_FLOOR = 1e7              # 10 MFLOP/step on the op
_WASTE_FRAC_FLOOR = 0.3         # >=30% of the padded work is padding
_EMBED_WASTE_FLOOR = 1 << 20    # >=1 MiB of gathered padding a step
_EMBED_WASTE_FRAC = 0.5

# HT902's card model, from measure_card_model() on an NVIDIA H100 80GB
# HBM3 at a power limit of 700.00 W, three runs alike (chip_smoke.py's
# efficiency_train runs it again and prints it beside these):
# - the (K, N) granule at which a compute-bound GEMM's time steps, the
#   coarsest whose padding costs no time (fit_granule) over the median of
#   3 passes: f32 (no TF32: the executor's default precision) at M=8192
#   over K and N from 40 to 264 with the other 4096 — K adds time every 8
#   (0.10 ms at 40 to 0.44 at 256), N in steps of 64 (0.11 ms to 64, 0.18
#   to 128, 0.34 to 192); bf16 at M=8192 over K and N from 264 to 776 with
#   the other 8192 — K in steps of 64 (0.093 ms to 320, 0.104 to 384),
#   N in steps of 32 to 64 (0.065 ms to 312, 0.077 to 384, 0.088 to 440);
# - each dtype's GEMM rate, TFLOP/s, the median over those sweeps' GEMMs
#   whose dims sit on the granule: the roofline a padding share is
#   priced on;
# - bf16's misalignment share, the median of 1 - time(d rounded up to a
#   multiple of 8) / time(d) over K and N from 40 to 264 not multiples of
#   8, the other 4096, M=8192 (0.34-0.59 between its 10th and 90th
#   percentiles): bf16 at these widths reads its big operand at about the
#   copy rate, and a row that is not whole 16-byte vectors runs 1.4-2.5x
#   as long;
# - the bytes a device-to-device copy of 1 GiB moves a second (read plus
#   written): the roofline's byte rate and a gather's padding's.
_GRANULE = {"float32": (8, 64), "bfloat16": (64, 32)}
_GEMM_TFLOPS = {"float32": 38.3, "bfloat16": 612.0}
_DRAM_GBPS = 2987.8
_VECTOR_BYTES = 16
_MISALIGNED_SHARE = {"bfloat16": 0.51}
# the DRAM access unit: a gathered row costs whole 32-byte sectors
_SECTOR_BYTES = 32

# HT903: scalar fetches in the per-step eval list beyond this are
# host syncs the sampling cadence should own
_SCALAR_FETCH_BUDGET = 4

# HT907: dispatches one sweep candidate costs (1 warmup + 2 windows x
# 3 reps, tune/autotune.py timeit)
_SWEEP_DISPATCHES = 7

# NOTE on pricing: unlike autoplan (fwd-only topo, x3 training
# factor), this pass prices the FULL step topo — gradient ops are
# their own nodes and price individually, so no factor applies.


def _db(costdb):
    if costdb is None:
        from ..telemetry.costdb import CostDB
        return CostDB()
    return costdb


def _threshold(ms_threshold):
    if ms_threshold is not None:
        return float(ms_threshold)
    env = os.environ.get("HETU_EFF_THRESHOLD_MS")
    return float(env) if env else DEFAULT_MS_THRESHOLD


def _suppressed_node(node, code):
    # a waiver anchors on the user construction line (defined_at) OR
    # the in-package line that composed the op (composed_at — the
    # models/ctr.py line for zoo-built graphs, whatever script called
    # the builder notwithstanding), and — because the fix for a
    # width/shape finding usually lives on the *parameter* line — on
    # either site of a trainable input too
    for n in (node, *(i for i in getattr(node, "inputs", ())
                      if getattr(i, "trainable", False))):
        for site in (getattr(n, "defined_at", None),
                     getattr(n, "composed_at", None)):
            if site and suppressed_at(site[0], site[1], code):
                return True
    return False


def _prod(shape):
    try:
        return int(np.prod([int(d) for d in shape])) if shape else 0
    except (TypeError, ValueError):
        return 0


def _itemsize(dt):
    """Bytes an element of a shape-pass dtype (a ``torch.dtype``; 4
    where unknown)."""
    return dt.itemsize if isinstance(dt, torch.dtype) else 4


def _nbytes(shape, dt=None):
    return _prod(shape) * _itemsize(dt)


def _is_half(dt):
    return isinstance(dt, torch.dtype) and dt.is_floating_point \
        and dt.itemsize == 2


def tile_for(dt):
    """The (K, N) granule at which a GEMM of dtype ``dt`` steps in time
    on the card (:data:`_GRANULE`): 16-bit floats take the bf16 entry,
    everything else the f32 one."""
    return _GRANULE["bfloat16" if _is_half(dt) else "float32"]


def _pad(d, m):
    d = max(1, int(d))
    return ((d + m - 1) // m) * m


def _flops(node, shapes):
    """Analytic per-op FLOPs: autoplan's model plus the attention
    family (4*B*H*S^2*D — QK^T and PV)."""
    if "Attention" in node.op_type:
        q = shapes.get(node.inputs[0]) if node.inputs else None
        if q and len(q) == 4:
            b, h, s, d = (int(x) for x in q)
            return 4.0 * b * h * s * s * d
    from ..parallel.autoplan import flops_of
    return flops_of(node, shapes)


_SKIP_COST_TYPES = ("OptimizerOp", "DataloaderOp", "GNNDataLoaderOp",
                    "DispatchOp", "PipelineSendOp", "PipelineReceiveOp")


def _is_compute(node):
    if node.op_type in _SKIP_COST_TYPES or "Communicate" in node.op_type \
            or "SparsePull" in node.op_type:
        return False
    from ..ops.variable import PlaceholderOp
    return not isinstance(node, PlaceholderOp)


def op_costs(topo, shapes, db, dtypes=None):
    """({node: predicted ms}, {node: source}, total_ms) over the
    compute ops — measured CostDB entries preferred (looked up in the
    dtype the shape pass gives the op, ``dtypes``: a bf16 session's
    ``profile_ops`` entries are keyed ``bfloat16``), FLOPs scaled against the
    measured anchors otherwise, the documented cold-start rate as the
    last resort (autoplan's calibration, applied to the full step graph
    so gradient ops price too)."""
    from ..telemetry import costdb as _costdb

    from ..parallel.autoplan import _dtype_name

    dtypes = dtypes or {}
    op_ms, sources = {}, {}
    measured = {}
    cal_fl = cal_ms = 0.0
    compute = [n for n in topo if _is_compute(n)]
    for node in compute:
        ent = db.get(node.op_type, shapes.get(node),
                     _dtype_name(dtypes.get(node)))
        if ent is not None:
            measured[node] = float(ent["ms"])
            fl = _flops(node, shapes)
            if fl > 0 and ent["ms"] > 0:
                cal_fl += fl
                cal_ms += float(ent["ms"])
    flops_per_ms = (cal_fl / cal_ms) if cal_ms > 0 else None
    for node in compute:
        if node in measured:
            op_ms[node] = measured[node]
            sources[node] = "measured"
            continue
        fl = _flops(node, shapes)
        if flops_per_ms:
            op_ms[node] = fl / flops_per_ms
            sources[node] = "flops_scaled"
        else:
            op_ms[node] = _costdb.cold_start_flops_ms(fl)
            sources[node] = "cold_start"
    return op_ms, sources, sum(op_ms.values())


class EfficiencyResult:
    """One graph's priced lint: the findings ``Report``, the per-node
    predicted ms map, cost sources, and the predicted compute floor of
    a step."""

    __slots__ = ("report", "op_ms", "sources", "total_ms", "topo")

    def __init__(self, report, op_ms, sources, total_ms, topo):
        self.report = report
        self.op_ms = op_ms
        self.sources = sources
        self.total_ms = total_ms
        self.topo = topo

    @property
    def findings(self):
        return sorted_by_savings(self.report)

    def predicted_waste_ms(self):
        """Total priced ms/step across the findings — what the graph
        throws away per step if every finding is real. HT908 is
        excluded: its price is the ms *resting on guesses* (pricing
        uncertainty), not waste, and counting it would double-bill ops
        that also carry a real HT902/HT906 price."""
        return round(sum(f.data.get("estimated_ms_per_step", 0.0)
                         for f in self.report.findings
                         if f.code != "HT908"), 6)

    def to_dict(self):
        return {
            "total_predicted_ms": round(self.total_ms, 6),
            "predicted_waste_ms": self.predicted_waste_ms(),
            "findings": [f.to_dict() for f in self.findings],
        }


def sorted_by_savings(report):
    """Findings sorted by predicted savings, biggest first — the
    reading order of a priced report."""
    return sorted(report.findings,
                  key=lambda f: -float(
                      f.data.get("estimated_ms_per_step", 0.0)))


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def efficiency_pass(topo, report, shapes=None, dtypes=None, config=None,
                    costdb=None, eval_nodes=None, extra_roots=(),
                    shape_keys=None, steps=None, ms_threshold=None,
                    feed_shapes=None, op_ms_out=None, sources_out=None):
    """Run every HT90x check over a topo-sorted graph; returns the
    per-node predicted-ms map. ``shape_keys`` (observed dispatch
    signatures) enables HT901; ``extra_roots`` enables HT906;
    ``config`` (a HetuConfig) supplies the plan knobs HT904 reads.
    Findings land in ``report`` with ``estimated_ms_per_step`` /
    ``estimated_pct`` / ``bucket`` / ``source`` attached;
    ``op_ms_out``/``sources_out`` (dicts) receive the per-node pricing
    so callers never pay the cost sweep twice."""
    if shapes is None or dtypes is None:
        from .shapes import shape_pass
        dtypes = {} if dtypes is None else dtypes
        shapes = shape_pass(topo, Report(), feed_shapes=feed_shapes,
                            dtypes_out=dtypes)
    db = _db(costdb)
    threshold = _threshold(ms_threshold)
    op_ms, sources, total_ms = op_costs(topo, shapes, db, dtypes)
    if op_ms_out is not None:
        op_ms_out.update({n: round(v, 6) for n, v in op_ms.items()})
    if sources_out is not None:
        sources_out.update(sources)

    def add(code, message, node, ms, source, extra_sev=None, **data):
        if node is not None and _suppressed_node(node, code):
            return None
        sev = extra_sev or ("warn" if ms >= threshold else "info")
        pct = round(ms / total_ms, 4) if total_ms > 0 else None
        return report.add(
            code, sev, message, node=node,
            estimated_ms_per_step=round(float(ms), 6),
            estimated_pct=pct, bucket=DOCTOR_BUCKET.get(code),
            source=source, **data)

    if shape_keys is not None:
        recompile_pass(shape_keys, report, costdb=db, steps=steps,
                       ms_threshold=threshold)
    _tiling_pass(topo, shapes, dtypes, op_ms, db, add)
    if eval_nodes is not None:
        _fetch_pass(topo, eval_nodes, shapes, db, add)
        _collective_pass(topo, eval_nodes, shapes, dtypes, config, db,
                         add)
        if extra_roots:
            _dead_compute_pass(topo, eval_nodes, extra_roots, db, add)
    _reshard_pass(topo, shapes, dtypes, db, add)
    _autotune_pass(topo, shapes, dtypes, db, steps, add)
    _coverage_pass(topo, shapes, op_ms, sources, db, add, threshold)
    return op_ms


def predict(eval_nodes, feed_shapes=None, config=None, costdb=None,
            extra_roots=(), shape_keys=None, steps=None,
            ms_threshold=None):
    """Priced lint over a graph in one call: shape-propagate, run
    :func:`efficiency_pass`, return an :class:`EfficiencyResult` —
    the CLI's entry point."""
    from .shapes import shape_pass
    from ..graph.autodiff import find_topo_sort

    topo = find_topo_sort(list(eval_nodes))
    dtypes = {}
    shapes = shape_pass(topo, Report(), feed_shapes=feed_shapes,
                        dtypes_out=dtypes)
    report = Report()
    sources = {}
    op_ms = efficiency_pass(
        topo, report, shapes=shapes, dtypes=dtypes, config=config,
        costdb=costdb, eval_nodes=eval_nodes, extra_roots=extra_roots,
        shape_keys=shape_keys, steps=steps, ms_threshold=ms_threshold,
        sources_out=sources)
    named = {n.name: round(v, 6) for n, v in op_ms.items()}
    return EfficiencyResult(report, named,
                            {n.name: s for n, s in sources.items()},
                            sum(op_ms.values()), topo)


# ---------------------------------------------------------------------------
# HT901 — recompile hazard
# ---------------------------------------------------------------------------

def _leaf_ints(key, out):
    if isinstance(key, (tuple, list)):
        for k in key:
            _leaf_ints(k, out)
    elif isinstance(key, (int, np.integer)):
        out.append(int(key))


def _bucketed(keys):
    """True when every dim that varies across the observed signatures
    only takes power-of-two values — the serving bucketing contract
    (serving/session.py): pow2 buckets bound distinct signatures by
    log2(range), which is the clean model for dynamic shapes."""
    flat = []
    for k in keys:
        ints = []
        _leaf_ints(k, ints)
        flat.append(tuple(ints))
    if len({len(f) for f in flat}) != 1:
        return False            # structurally different keys: not a
        # bucket ladder at all (e.g. feeds appearing and vanishing)
    for pos in range(len(flat[0])):
        vals = {f[pos] for f in flat}
        if len(vals) <= 1:
            continue
        if not all(v > 0 and (v & (v - 1)) == 0 for v in vals):
            return False
    return True


def recompile_pass(shape_keys, report, costdb=None, steps=None,
                   node=None, budget=RECOMPILE_BUDGET,
                   ms_threshold=None):
    """HT901 over a set of observed dispatch signatures (any recorded
    shape history): more than ``budget`` distinct signatures whose
    varying dims do *not* follow the pow2 bucketing contract is a
    recompile storm — every new signature pays a full compile where the
    program compiles per shape. Priced from the CostDB's measured
    ``jit_compile`` entries (cold start: the documented 200 ms floor),
    amortized over ``steps``."""
    keys = list(dict.fromkeys(tuple(k) if isinstance(k, list) else k
                              for k in shape_keys))
    n = len(keys)
    if n <= budget or _bucketed(keys):
        return None
    if node is not None and _suppressed_node(node, "HT901"):
        return None
    db = _db(costdb)
    threshold = _threshold(ms_threshold)
    compile_ms, source = db.estimate_info("jit_compile", 0)
    excess = n - budget
    total = excess * compile_ms
    horizon = max(1, int(steps)) if steps else _AMORTIZE_STEPS
    ms = total / horizon
    sev = "warn" if ms >= threshold else "info"
    return report.add(
        "HT901", sev,
        f"recompile hazard: {n} distinct dispatch signatures observed "
        f"(budget {budget}) and the varying dims are not pow2-bucketed "
        f"— every new feed shape pays a full compile "
        f"(~{compile_ms:.0f} ms each, {source}). Bucket dynamic dims "
        f"like serving does (pad up to pow2, trim outputs) or pin the "
        f"feed shapes", node=node,
        estimated_ms_per_step=round(ms, 6),
        estimated_ms_total=round(total, 3),
        bucket=DOCTOR_BUCKET["HT901"], source=source,
        signatures=n)


# ---------------------------------------------------------------------------
# HT902 — GEMM padding waste on the card
# ---------------------------------------------------------------------------

def _lane_waste(k, n, dt, count_k=True):
    """Padded-work fraction over the ARCHITECTURAL GEMM dims: the
    contraction (K) and output-feature (N) dims, each rounded up to its
    granule. M scales with the batch — a harness artifact, not a model
    property — so it never fires the lint on its own; ``count_k=False``
    additionally excludes K for weight-gradient matmuls, whose
    contraction rides the batch dim too."""
    gk, gn = tile_for(dt)
    true, padded = n, _pad(n, gn)
    if count_k:
        true *= k
        padded *= _pad(k, gk)
    return 1.0 - true / padded if padded else 0.0


def _roofline_ms(flops, nbytes, dt):
    """The card's least time for a GEMM: its FLOPs at the dtype's
    measured GEMM rate (:data:`_GEMM_TFLOPS`) or its bytes at the copy
    rate, whichever is longer."""
    rate = _GEMM_TFLOPS["bfloat16" if _is_half(dt) else "float32"]
    return max(flops / (rate * 1e9), nbytes / (_DRAM_GBPS * 1e6))


def _padding_share(waste, flops, nbytes, dt):
    """The share of a GEMM's time its padding takes: 1 - t(the true
    work) / t(the padded work) on :func:`_roofline_ms`, the bytes the
    same in both (the padding lives in the tiles, not in DRAM). It is
    the padded-work fraction ``waste`` where the GEMM is compute-bound
    and shrinks to nothing where its bytes bound it."""
    if flops <= 0:
        return 0.0
    padded = flops / (1.0 - waste)
    return 1.0 - _roofline_ms(flops, nbytes, dt) / \
        _roofline_ms(padded, nbytes, dt)


def _matmul_mkn(node, ins, out):
    """Effective (M, K, N) honoring the transpose flags (a gradient
    matmul is trans_A/trans_B; reading raw operand dims would price
    the wrong contraction)."""
    m, n = int(out[-2]), int(out[-1])
    k = int(ins[0][-2] if getattr(node, "matmul_attr_trans_A", False)
            else ins[0][-1])
    return m, k, n


def _dtype_key(dt):
    return "bfloat16" if _is_half(dt) else "float32"


def _matmul_share(m, k, n, dt, count_k=True, rows=()):
    """(padded-work fraction, share of the GEMM's time lost, whether its
    rows are misaligned) for an [m, k] x [k, n] GEMM in ``dt`` on the
    card: the padding's share on the roofline (:func:`_padding_share`)
    and, where a stored row (``rows``: the operands' and the result's
    last dims) of a 16-bit GEMM is not whole :data:`_VECTOR_BYTES`
    vectors, the measured misalignment share on top."""
    waste = _lane_waste(k, n, dt, count_k=count_k)
    item = _itemsize(dt)
    share = _padding_share(waste, 2.0 * m * k * n,
                           item * (m * k + k * n + m * n), dt)
    mis = any(int(r) * item % _VECTOR_BYTES for r in rows) and \
        _dtype_key(dt) in _MISALIGNED_SHARE
    if mis:
        share = 1.0 - (1.0 - share) * \
            (1.0 - _MISALIGNED_SHARE[_dtype_key(dt)])
    return waste, share, mis


def _tiling_pass(topo, shapes, dtypes, op_ms, db, add):
    from ..parallel.autoplan import _dtype_name

    for node in topo:
        kind = node.op_type
        out = shapes.get(node)
        ins = [shapes.get(i) for i in node.inputs]
        dt = dtypes.get(node)
        if kind in ("MatMulOp", "BatchMatMulOp") and len(ins) >= 2 \
                and ins[0] and ins[1] and out and len(out) >= 2:
            m, k, n = _matmul_mkn(node, ins, out)
            fl = 2.0 * m * k * n
            # trans_A = a weight-gradient matmul: K is the batch dim
            waste, share, mis = _matmul_share(
                m, k, n, dt,
                count_k=not getattr(node, "matmul_attr_trans_A", False),
                rows=(ins[0][-1], ins[1][-1], out[-1]))
            # the floor holds the share of TIME lost (the padding's is at
            # most its share of work: equal where the GEMM is
            # compute-bound)
            if fl >= _FLOPS_FLOOR and share >= _WASTE_FRAC_FLOOR:
                ms = op_ms.get(node, 0.0) * share
                gk, gn = tile_for(dt)
                vec = _VECTOR_BYTES // _itemsize(dt)
                add("HT902",
                    f"{kind} {node.name}: dims [{m}x{k}]x[{k}x{n}] round "
                    f"up to the card's (K {gk}, N {gn}) GEMM granule with "
                    f"{waste:.0%} of the GEMM's work spent on padding"
                    + (f", and rows of the operands or result are not "
                       f"whole {_VECTOR_BYTES}-byte vectors" if mis else "")
                    + f" — {share:.0%} of its time on the card. Align K={k} "
                    f"to {gk} and N={n} to {gn}"
                    + (f" (every row a multiple of {vec} elements)"
                       if mis else "")
                    + " or waive with a measured justification", node, ms,
                    "measured" if db.get(kind, out, _dtype_name(dt))
                    else "cold_start",
                    waste_frac=round(waste, 4))
        elif kind == "Conv2dOp" and len(ins) >= 2 and ins[1] \
                and len(ins[1]) == 4 and out:
            cout, cin, kh, kw = (int(x) for x in ins[1])
            m = _prod(out) // max(1, cout)      # N*H*W rows of im2col
            k = cin * kh * kw
            fl = _flops(node, shapes)
            waste = _lane_waste(k, cout, dt)
            share = _padding_share(
                waste, fl, _nbytes(ins[0], dt) + _nbytes(ins[1], dt)
                + _nbytes(out, dt), dt)
            if fl >= _FLOPS_FLOOR and share >= _WASTE_FRAC_FLOOR:
                ms = op_ms.get(node, 0.0) * share
                gk, gn = tile_for(dt)
                add("HT902",
                    f"Conv2d {node.name}: im2col [{m}x{k}]x[{k}x{cout}] "
                    f"rounds up to the card's (K {gk}, N {gn}) GEMM "
                    f"granule with {waste:.0%} padding waste (cout={cout}, "
                    f"cin*kh*kw={k}), {share:.0%} of its time on the "
                    f"card's roofline — align the channel counts or waive "
                    f"with a measured justification", node, ms,
                    "measured" if db.get(kind, out, _dtype_name(dt))
                    else "cold_start",
                    waste_frac=round(waste, 4))
        elif kind == "EmbeddingLookUp" and ins and ins[0] \
                and len(ins[0]) == 2:
            # a table on the card is stored unpadded: no residency to
            # price, only each gathered row's bytes rounded up to whole
            # DRAM sectors
            width = int(ins[0][1])
            row = width * _itemsize(dtypes.get(node.inputs[0]))
            padded = _pad(row, _SECTOR_BYTES)
            frac = 1.0 - row / padded
            nlook = _prod(ins[1]) if len(ins) > 1 and ins[1] else 1
            waste_bytes = nlook * (padded - row)
            if waste_bytes >= _EMBED_WASTE_FLOOR \
                    and frac >= _EMBED_WASTE_FRAC:
                ms = waste_bytes / (_DRAM_GBPS * 1e6)
                add("HT902",
                    f"EmbeddingLookUp {node.name}: each gathered row is "
                    f"{row} B, read as {padded} B of whole "
                    f"{_SECTOR_BYTES}-byte DRAM sectors — {frac:.0%} of "
                    f"the gather's traffic ({waste_bytes / (1 << 20):.1f} "
                    f"MiB a step) is padding. Widen the rows to a "
                    f"multiple of {_SECTOR_BYTES} B, pack them, or waive "
                    f"with a measured justification",
                    node, ms, "cold_start",
                    waste_frac=round(frac, 4), padded_mib=round(
                        waste_bytes / (1 << 20), 1))


# ---------------------------------------------------------------------------
# HT902's card model: where _GRANULE and _DRAM_GBPS come from
# ---------------------------------------------------------------------------

# each dtype's sweep: M, the dim held (N while K is swept, K while N is),
# and the swept dims — every GEMM compute-bound on the card (f32 past ~20
# FLOPs a byte, bf16 past ~250), where padding costs time if it costs any
_SWEEP = {"float32": (8192, 4096, tuple(range(40, 265, 4))),
          "bfloat16": (8192, 8192, tuple(range(264, 777, 8)))}
_GRANULES = (8, 16, 32, 64, 128, 256)
# the 16-bit misalignment sweep: M, the held dim and dims of which every
# other one is not a whole 16-byte vector (the model's widths are these)
_ALIGN_SWEEP = (8192, 4096, tuple(range(40, 265, 4)))
# padding up to the granule is "free" where the padded GEMM takes no more
# than this much longer, at this share of the swept dims at least
_FREE_TOL, _FREE_SHARE = 0.05, 0.8


def _event_ms(fn, reps, device):
    """Median ms of ``fn()`` over 3 windows of ``reps`` launches (CUDA
    events on a card, the host clock elsewhere), after one warm-up."""
    import time
    fn()
    samples = []
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / reps)
    return float(np.median(samples))


def fit_granule(times, granules=_GRANULES, tol=_FREE_TOL,
                share=_FREE_SHARE):
    """The coarsest granule ``g`` at which padding a GEMM dim up costs
    no time: for at least ``share`` of the swept dims ``d`` whose
    round-up to ``g`` was swept too, ``times[d] >= (1 - tol) *
    times[pad(d, g)]``. 1 where no granule holds (time grows with every
    element: nothing to pad)."""
    best = 1
    for g in granules:
        pairs = [(d, _pad(d, g)) for d in times
                 if d % g and _pad(d, g) in times]
        if not pairs:
            continue
        free = sum(times[d] >= (1.0 - tol) * times[p] for d, p in pairs)
        if free >= share * len(pairs):
            best = g
    return best


def _gemm_timer(m, kmax, nmax, dt, device, reps, seed=0):
    """``time(k, n)``: the ms of ``torch.matmul`` at [m, k] x [k, n] in
    ``dt``, its operands contiguous views of buffers made once."""
    g = torch.Generator(device=device).manual_seed(seed)
    a_buf = torch.randn(m * kmax, generator=g, device=device).to(dt)
    b_buf = torch.randn(kmax * nmax, generator=g, device=device).to(dt)
    c_buf = torch.empty(m * nmax, dtype=dt, device=device)

    def time(k, n, rows=m):
        a = a_buf[:rows * k].view(rows, k)
        b = b_buf[:k * n].view(k, n)
        c = c_buf[:rows * n].view(rows, n)
        return _event_ms(lambda: torch.matmul(a, b, out=c), reps, device)
    return time


def _sweep_ms(m, held, dims, dt, device, reps, rounds):
    """``{"N": {d: ms}, "K": {d: ms}}``: ``torch.matmul`` at [m, held] x
    [held, d] and [m, d] x [d, held] in ``dt``, each the median of
    ``rounds`` passes over the dims."""
    top = max(held, *dims)
    time = _gemm_timer(m, top, top, dt, device, reps)
    runs = {"N": {d: [] for d in dims}, "K": {d: [] for d in dims}}
    for _ in range(rounds):
        for d in dims:
            runs["N"][d].append(time(held, d))
            runs["K"][d].append(time(d, held))
    return {axis: {d: float(np.median(v)) for d, v in per.items()}
            for axis, per in runs.items()}


def measure_card_model(device=None, sweep=None, align_sweep=None,
                       copy_bytes=1 << 30, reps=10, rounds=3):
    """Measure HT902's card model on ``device`` (default the card): for
    each dtype of ``sweep`` (default :data:`_SWEEP`: f32, run without
    TF32 as the session runs it, and bf16) ``torch.matmul`` at [M, K] x
    [K, N] over N at the held K and over K at the held N, each dim's
    time the median of ``rounds`` passes over the dims; each dim's
    :func:`fit_granule`; the dtype's GEMM rate, the median TFLOP/s of the
    swept GEMMs whose dims sit on the fitted granule; for a 16-bit dtype
    the same over ``align_sweep`` (default :data:`_ALIGN_SWEEP`), and the
    median share of a GEMM's time that a dim not a whole 16-byte vector
    costs (``1 - time(d rounded up to one) / time(d)``); and one
    device-to-device copy of ``copy_bytes``, as the bytes moved (read
    plus written) a second. Returns ``{"card", "matmul_ms": {dtype:
    {"N": {d: ms}, "K": {d: ms}}}, "granule": {dtype: (K, N)},
    "tflops": {dtype: rate}, "misaligned_ms": {dtype: {...}},
    "misaligned_share": {dtype: share}, "copy": {"bytes", "ms",
    "gbps"}}`` — what :data:`_GRANULE`, :data:`_GEMM_TFLOPS`,
    :data:`_MISALIGNED_SHARE` and :data:`_DRAM_GBPS` were set from."""
    from ..device import resolve_device

    device = resolve_device(device)
    out = {"card": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else str(device)),
           "matmul_ms": {}, "granule": {}, "tflops": {},
           "misaligned_ms": {}, "misaligned_share": {}}
    for name, (m, held, dims) in (sweep or _SWEEP).items():
        dt = getattr(torch, name)
        got = _sweep_ms(m, held, dims, dt, device, reps, rounds)
        gk, gn = fit_granule(got["K"]), fit_granule(got["N"])
        rates = [2.0 * m * held * d / (ms * 1e9)
                 for axis, g in (("N", gn), ("K", gk))
                 for d, ms in got[axis].items() if d % g == 0]
        out["matmul_ms"][name] = got
        out["granule"][name] = (gk, gn)
        out["tflops"][name] = float(np.median(rates))
        if dt.itemsize != 2:
            continue
        m, held, dims = align_sweep or _ALIGN_SWEEP
        got = _sweep_ms(m, held, dims, dt, device, reps, rounds)
        vec = _VECTOR_BYTES // dt.itemsize
        out["misaligned_ms"][name] = got
        out["misaligned_share"][name] = float(np.median(
            [1.0 - ms[_pad(d, vec)] / ms[d] for ms in got.values()
             for d in ms if d % vec and _pad(d, vec) in ms]))
    src = torch.empty(copy_bytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ms = _event_ms(lambda: dst.copy_(src), max(1, reps // 2), device)
    out["copy"] = {"bytes": copy_bytes, "ms": ms,
                   "gbps": 2 * copy_bytes / (ms * 1e6)}
    return out


def measure_padding_share(m, k, n, dtype, device=None, reps=10,
                          rounds=3):
    """What HT902 claims of one GEMM, measured: ``torch.matmul`` at [m,
    k] x [k, n] in ``dtype`` against the same work on dims aligned to
    the granule (:func:`tile_for`: K and N rounded down to it where that
    leaves one, up otherwise, M scaled to keep the FLOPs), the two timed
    in turn ``rounds`` times. Returns ``{"dims", "aligned_dims", "ms",
    "aligned_ms", "measured_share", "priced_share", "waste_frac"}``: the
    measured share is ``1 - aligned_ms / ms``, the priced one
    :func:`_matmul_share`'s."""
    from ..device import resolve_device

    device = resolve_device(device)
    gk, gn = tile_for(dtype)

    def aligned(d, g):
        return d // g * g if d >= g else _pad(d, g)
    ka, na = aligned(k, gk), aligned(n, gn)
    ma = int(round(m * k * n / (ka * na)))
    time = _gemm_timer(max(m, ma), max(k, ka), max(n, na), dtype, device,
                       reps)
    runs = [(time(k, n, m), time(ka, na, ma)) for _ in range(rounds)]
    ms, aligned_ms = (float(np.median(v)) for v in zip(*runs))
    waste, share, _mis = _matmul_share(m, k, n, dtype, rows=(k, n, n))
    return {"dims": (m, k, n), "aligned_dims": (ma, ka, na), "ms": ms,
            "aligned_ms": aligned_ms,
            "measured_share": 1.0 - aligned_ms / ms,
            "priced_share": share, "waste_frac": waste}


# ---------------------------------------------------------------------------
# HT903 — host sync on the hot path
# ---------------------------------------------------------------------------

def _fetch_pass(topo, eval_nodes, shapes, db, add):
    """Graph half: a per-step fetch list carrying many scalar outputs
    is a per-step host sync per scalar — the sentinel/health pattern
    (one fused aux fetch, at cadence) is the clean model."""
    from ..optimizer import OptimizerOp

    scalars = [n for n in eval_nodes
               if not isinstance(n, OptimizerOp)
               and shapes.get(n) is not None
               and _prod(shapes.get(n)) <= 1]
    extra = len(scalars) - _SCALAR_FETCH_BUDGET
    if extra <= 0:
        return
    per, source = db.estimate_info("d2h", 8)
    ms = extra * per
    add("HT903",
        f"{len(scalars)} scalar outputs in the per-step fetch list — "
        f"each is a device round-trip every step (budget "
        f"{_SCALAR_FETCH_BUDGET}). Fuse them into one aux fetch (the "
        f"health-sentinel pattern) or sample at cadence",
        scalars[_SCALAR_FETCH_BUDGET], ms, source,
        scalar_fetches=len(scalars))


class _LoopWalker(ast.NodeVisitor):
    """Find host step loops (For/While whose body calls .run/.predict/
    run_step) and the device syncs inside them. ``.item()`` /
    ``.block_until_ready()`` / ``.synchronize()`` / ``device_get``
    always sync; ``np.asarray``/``np.array`` of, and ``.asnumpy()`` /
    ``.cpu()`` / ``.numpy()`` / ``.tolist()`` on, a value only count
    when it is (a subscript of) a name assigned from the run call —
    host-side feed construction with the same spelling is not a device
    round-trip."""

    _RUN_NAMES = {"run", "run_step", "run_batches",
                  "run_batches_stream", "predict"}
    _SYNC_ATTRS = {"item", "block_until_ready", "synchronize"}
    _SYNC_ALWAYS = {"device_get"}
    _SYNC_ON_RESULT = {"asarray", "array"}
    _SYNC_METHODS_ON_RESULT = {"asnumpy", "cpu", "numpy", "tolist"}

    def __init__(self):
        self.loops = []         # (loop node, [sync nodes])

    @staticmethod
    def _is_run_call(node):
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _LoopWalker._RUN_NAMES)

    def _visit_loop(self, node):
        runs = False
        results = set()         # names bound to a run call's result
        for sub in ast.walk(node):
            if self._is_run_call(sub):
                runs = True
            elif isinstance(sub, ast.Assign) and \
                    self._is_run_call(sub.value):
                results.update(t.id for t in sub.targets
                               if isinstance(t, ast.Name))

        def on_result(arg):
            while isinstance(arg, ast.Subscript):
                arg = arg.value
            return isinstance(arg, ast.Name) and arg.id in results

        syncs = []
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if name in self._SYNC_ATTRS or name in self._SYNC_ALWAYS:
                syncs.append(sub)
            elif name in self._SYNC_ON_RESULT and sub.args \
                    and on_result(sub.args[0]):
                syncs.append(sub)
            elif name in self._SYNC_METHODS_ON_RESULT \
                    and isinstance(fn, ast.Attribute) \
                    and on_result(fn.value):
                syncs.append(sub)
        if runs and syncs:
            self.loops.append((node, syncs))
        self.generic_visit(node)

    visit_For = _visit_loop
    visit_While = _visit_loop


def _cadence_guarded(tree, sync):
    """True when ``sync`` sits under an ``if ... % n`` guard — sampled
    at cadence, the clean pattern."""
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and any(
                isinstance(b, ast.BinOp) and isinstance(b.op, ast.Mod)
                for b in ast.walk(node.test)):
            for sub in ast.walk(node):
                guarded.add(id(sub))
    return id(sync) in guarded


def check_host_sync_source(src, path="<string>", costdb=None,
                           ms_threshold=None):
    """HT903 AST half over a host training script: a device sync
    (:class:`_LoopWalker`'s spellings) inside a step loop (a For/While
    that drives ``run()``/``predict()``), unless cadence-guarded (``if
    step % n``). Returns a Report."""
    report = Report()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        report.add("HT900", "warn", f"unparseable script: {e}",
                   where=path)
        return report
    db = _db(costdb)
    threshold = _threshold(ms_threshold)
    per, source = db.estimate_info("d2h", 8)
    lines = src.splitlines()
    walker = _LoopWalker()
    walker.visit(tree)
    for loop, syncs in walker.loops:
        for sync in syncs:
            if _cadence_guarded(loop, sync):
                continue
            if suppressed(lines, sync.lineno, "HT903"):
                continue
            fn = sync.func
            name = fn.attr if isinstance(fn, ast.Attribute) else fn.id
            sev = "warn" if per >= threshold else "info"
            report.add(
                "HT903", sev,
                f"{name}() inside the step loop at line {loop.lineno} "
                f"forces a device sync every step (~{per:.3f} ms, "
                f"{source}) — guard it with a cadence (if step % n) "
                f"or fuse the value into the step's aux fetch",
                where=f"{path}:{sync.lineno}",
                estimated_ms_per_step=round(per, 6),
                bucket=DOCTOR_BUCKET["HT903"], source=source)
    return report


# ---------------------------------------------------------------------------
# HT904 — fragmented collectives
# ---------------------------------------------------------------------------

def _collective_pass(topo, eval_nodes, shapes, dtypes, config, db, add):
    from ..optimizer import OptimizerOp
    from ..ops.comm import optimizer_allreduce_ops
    from ..telemetry.costdb import (latency_crossover_bytes,
                                    recommend_bucket_bytes)

    overlap = getattr(config, "overlap", None) if config is not None \
        else None
    if overlap is not None and overlap.bucket_bytes:
        return                  # bucketing on: the pattern is handled
    optimizer_ops = [n for n in topo if isinstance(n, OptimizerOp)]
    if not optimizer_ops:
        return
    ars = optimizer_allreduce_ops(topo, optimizer_ops, eval_nodes)
    if len(ars) < 2:
        return
    sizes = []
    for op in sorted(ars, key=lambda n: n.id):
        shape = shapes.get(op) or shapes.get(op.inputs[0])
        sizes.append((op, _nbytes(shape, dtypes.get(op))))
    crossover = latency_crossover_bytes(db, "allreduce")
    frag = [(op, s) for op, s in sizes if 0 < s < crossover]
    if len(frag) < 2:
        return
    per_grad = 0.0
    source = "cold_start"
    for _, s in sizes:
        ms, src = db.estimate_info("allreduce", s)
        per_grad += ms
        if src in ("measured", "curve"):
            source = src
    bucket_bytes = recommend_bucket_bytes(db)
    # greedy size-targeted packing, the settle_deferred_allreduce shape
    buckets, cur = [], 0
    for _, s in sizes:
        if cur and cur + s > bucket_bytes:
            buckets.append(cur)
            cur = 0
        cur += s
    if cur:
        buckets.append(cur)
    bucketed = sum(db.estimate_info("allreduce", b)[0] for b in buckets)
    delta = per_grad - bucketed
    if delta <= 0:
        return
    add("HT904",
        f"{len(sizes)} per-gradient allreduces ({len(frag)} below the "
        f"{crossover / 1e6:.2f} MB latency crossover) with "
        f"overlap_options.bucket_bytes unset — {len(sizes)} latency "
        f"payments per step where {len(buckets)} would do. Set "
        f"bucket_bytes={bucket_bytes} (CostDB-derived; "
        f"autoplan applies it to dp plans automatically)",
        frag[0][0], delta, source,
        collectives=len(sizes), buckets=len(buckets),
        recommended_bucket_bytes=bucket_bytes)


# ---------------------------------------------------------------------------
# HT905 — redundant reshard / transfer
# ---------------------------------------------------------------------------

def _reshard_pass(topo, shapes, dtypes, db, add):
    from ..ops.comm import DispatchOp

    def is_gather(n):
        return isinstance(n, DispatchOp) and all(
            p <= 1 for p in n.parts)

    def is_split(n):
        return isinstance(n, DispatchOp) and any(
            p > 1 for p in n.parts)

    consumers = {}
    for op in topo:
        for inp in op.inputs:
            consumers.setdefault(id(inp), []).append(op)

    for node in topo:
        if not (is_split(node) and node.inputs):
            continue
        g = node.inputs[0]
        if not (is_gather(g) and g.inputs):
            continue
        s = g.inputs[0]
        if not (is_split(s) and s.parts == node.parts):
            continue
        if len(consumers.get(id(g), ())) > 1:
            continue            # the gathered value is used elsewhere
        shape = shapes.get(s) or shapes.get(g)
        nb = _nbytes(shape, dtypes.get(s))
        # gather-then-identical-resplit: the bytes ride the links twice
        # for a no-op — price both hops off the collective curve
        ms, source = db.estimate_info("allreduce", nb)
        add("HT905",
            f"gather-then-resplit Dispatch chain {s.name} -> {g.name} "
            f"-> {node.name} re-creates the same {tuple(node.parts)} "
            f"partition it gathered — "
            f"{nb / 1e6:.2f} MB resharded round-trip per step for a "
            f"no-op; drop the pair and keep the split output",
            node, 2 * ms, source, bytes=nb)


# ---------------------------------------------------------------------------
# HT906 — cost-weighted dead compute
# ---------------------------------------------------------------------------

def _dead_compute_pass(topo, eval_nodes, extra_roots, db, add):
    from ..graph.autodiff import find_topo_sort
    from .shapes import shape_pass

    live = {id(n) for n in topo}
    dead_topo = [n for n in find_topo_sort(list(extra_roots))
                 if id(n) not in live]
    dead = [n for n in dead_topo if _is_compute(n)]
    if not dead:
        return
    dtypes = {}
    dshapes = shape_pass(dead_topo, Report(), dtypes_out=dtypes)
    dms, _src, _tot = op_costs(dead_topo, dshapes, db, dtypes)
    ms = sum(dms.get(n, 0.0) for n in dead)
    names = ", ".join(n.name for n in dead[:5])
    add("HT906",
        f"{len(dead)} dead compute op(s) reachable from constructed "
        f"roots but not from the eval outputs ({names}"
        f"{'...' if len(dead) > 5 else ''}) — if a step function "
        f"evaluates them they burn ~{ms:.4f} ms/step for nothing; "
        f"delete the subgraph or fetch its outputs",
        dead[0], ms, "cold_start", dead_ops=len(dead))


# ---------------------------------------------------------------------------
# HT907 — untuned hot-path kernel
# ---------------------------------------------------------------------------

def _autotune_pass(topo, shapes, dtypes, db, steps, add):
    from ..ops import flash_attention as fa
    from ..ops.attention import FlashAttentionOp
    from ..parallel.autoplan import _dtype_name
    from ..tune.autotune import AutotuneTable, tuning_mode

    mode = tuning_mode()
    if mode in ("off", "cache"):
        return                  # no sweep will ever run at dispatch
    table = None
    for node in topo:
        if not isinstance(node, FlashAttentionOp):
            continue            # grad ops share the forward's key
        q = shapes.get(node.inputs[0]) if node.inputs else None
        if not q or len(q) != 4:
            continue
        b, h, s, d = (int(x) for x in q)
        dt = dtypes.get(node.inputs[0]) or torch.float32
        cands = fa._candidates(s, d, dt)
        if len(cands) < 2:
            continue            # nothing to sweep (one configuration)
        causal = bool(getattr(node, "causal", False))
        has_mask = bool(getattr(node, "has_mask", False))
        missing = []
        if table is None:
            table = AutotuneTable()
        for kind in ("fwd", "fwd_lse", "bwd"):
            name, key = fa.tune_key(kind, s, d, dt, causal, has_mask)
            if table.get(name, key) is None:
                missing.append(kind)
        if not missing:
            continue
        ent = db.get(node.op_type, q, _dtype_name(dt))
        if ent is not None:
            op_ms, source = float(ent["ms"]), "measured"
        else:
            from ..telemetry.costdb import cold_start_flops_ms
            op_ms = cold_start_flops_ms(_flops(node, shapes))
            source = "cold_start"
        sweep_ms = len(cands) * _SWEEP_DISPATCHES * op_ms * len(missing)
        horizon = max(1, int(steps)) if steps else _AMORTIZE_STEPS
        add("HT907",
            f"flash-attention S={s} D={d} has no autotune cache entry "
            f"for {missing} — the first step pays a "
            f"{len(cands)}-candidate sweep (~{sweep_ms:.1f} ms, "
            f"{source}-priced). Warm the cache (HETU_AUTOTUNE=1 after "
            f"one tuning run) so measured steps never sweep",
            node, sweep_ms / horizon, source,
            estimated_ms_first_step=round(sweep_ms, 3),
            sweep_candidates=len(cands))


# ---------------------------------------------------------------------------
# HT908 — CostDB coverage gap (advisory)
# ---------------------------------------------------------------------------

_COVERAGE_TOP = 5


def _coverage_pass(topo, shapes, op_ms, sources, db, add, threshold):
    if db is None or len(db) == 0:
        # a fully cold DB guesses everything; the doctor's global
        # "run costdb --sweep" hint owns that case — an advisory per
        # graph would be noise
        return
    guessed = [(n, m) for n, m in op_ms.items()
               if sources.get(n) != "measured" and m >= threshold]
    if not guessed:
        return
    guessed.sort(key=lambda nm: -nm[1])
    top = guessed[:_COVERAGE_TOP]
    at_stake = sum(m for _, m in guessed)
    keys = ", ".join(f"({n.op_type}, "
                     f"{'x'.join(str(d) for d in (shapes.get(n) or ()))})"
                     for n, _ in top)
    add("HT908",
        f"{len(guessed)} hot op(s) priced from guesses, not "
        f"measurements ({keys}"
        f"{'...' if len(guessed) > _COVERAGE_TOP else ''}) — "
        f"~{at_stake:.3f} ms/step of this report rests on the "
        f"cold-start model. profile_ops(costdb=...) one real run to "
        f"replace them", top[0][0], at_stake, "cold_start",
        extra_sev="info", guessed_ops=len(guessed))


# ---------------------------------------------------------------------------
# CLI: zoo sweep gating on unsuppressed warn/error findings
# ---------------------------------------------------------------------------

def check_zoo(names=None, costdb=None, ms_threshold=None):
    """{model: EfficiencyResult} over the zoo graphs."""
    from . import zoo

    out = {}
    for name in names or sorted(zoo.ZOO):
        eval_nodes, feed_shapes = zoo.build(name)
        out[name] = predict(eval_nodes, feed_shapes=feed_shapes,
                            costdb=costdb, ms_threshold=ms_threshold)
    return out


def main(argv=None):
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.analysis.efficiency",
        description="CostDB-priced static performance lint (HT9xx) "
                    "over the zoo graphs; exits 1 on any unsuppressed "
                    "warn-or-error finding")
    parser.add_argument("models", nargs="*",
                        help="zoo model names (default: all)")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--out", default=None, metavar="FILE",
                        help="write the priced report JSON here")
    parser.add_argument("--costdb", default=None, metavar="PATH",
                        help="cost DB (default: $HETU_COSTDB or the "
                             "standard path; cold-start pricing when "
                             "absent)")
    parser.add_argument("--threshold-ms", type=float, default=None,
                        help=f"warn-vs-info pricing threshold "
                             f"(default {DEFAULT_MS_THRESHOLD} or "
                             f"$HETU_EFF_THRESHOLD_MS)")
    parser.add_argument("--scripts", nargs="*", default=(),
                        metavar="PATH",
                        help="also run the HT903 host-sync AST lint "
                             "over these training scripts")
    args = parser.parse_args(argv)

    from . import zoo
    names = args.models or sorted(zoo.ZOO)
    unknown = [n for n in names if n not in zoo.ZOO]
    if unknown:
        parser.error(f"unknown zoo model(s) {unknown}")

    db = None
    if args.costdb:
        from ..telemetry.costdb import CostDB
        db = CostDB(args.costdb)
    results = check_zoo(names, costdb=db,
                        ms_threshold=args.threshold_ms)
    script_reports = {}
    for path in args.scripts:
        with open(path, encoding="utf-8") as f:
            script_reports[path] = check_host_sync_source(
                f.read(), path=path, costdb=db,
                ms_threshold=args.threshold_ms)

    gate = 0
    doc = {}
    for name, res in results.items():
        gating = [f for f in res.report.findings
                  if f.severity in ("warn", "error")]
        doc[name] = res.to_dict()
        if gating:
            gate = 1
        if not args.json:
            status = "FAIL" if gating else "ok"
            print(f"== {name}: {status} ({len(res.report)} finding(s), "
                  f"predicted waste {res.predicted_waste_ms():.4f} "
                  f"ms/step of {res.total_ms:.4f})")
            for f in res.findings:
                print(f"   {f}  "
                      f"[{f.data.get('estimated_ms_per_step', 0):.4f} "
                      f"ms/step]")
    for path, rep in script_reports.items():
        gating = [f for f in rep.findings
                  if f.severity in ("warn", "error")]
        doc[path] = {"findings": [f.to_dict()
                                  for f in sorted_by_savings(rep)]}
        if gating:
            gate = 1
        if not args.json:
            print(f"== {path}: "
                  f"{'FAIL' if gating else 'ok'} "
                  f"({len(rep)} finding(s))")
            for f in sorted_by_savings(rep):
                print("   " + str(f))
    if args.json:
        print(json.dumps(doc, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"priced report written to {args.out}", file=sys.stderr)
    total = sum(len(r.report) for r in results.values()) + \
        sum(len(r) for r in script_reports.values())
    if not args.json:
        print(f"efficiency: {total} finding(s) across {len(names)} "
              f"zoo model(s)"
              + (f" + {len(script_reports)} script(s)"
                 if script_reports else ""))
    if gate:
        print("efficiency: FAILED — fix the inefficiency, or waive "
              "with '# ht-ok: HT9xx <reason>' on the construction "
              "line", file=sys.stderr)
    return gate


if __name__ == "__main__":
    import sys
    sys.exit(main())
