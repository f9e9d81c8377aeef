"""Cost-model auto-parallelism planner.

Counterpart of ``hetu_tpu/parallel/autoplan.py``. Hand-written parallel
configs — per-node ``ht.dispatch`` specs, stage contexts, microbatch
counts — become one declarative call::

    exe = Executor([loss, train_op], parallel="auto",
                   rules={"out": "tp", "vocab": "tp", "embed": None})

The planner:

1. **enumerates candidates** — factorizations of every device count up
   to the world size into ``(dp, tp, pp)`` mesh shapes, pruned against
   the graph (a tp that divides no rule-splittable parameter dim is
   invalid; a pp deeper than the graph's op chain is invalid),
2. **compiles the rules table** (``rules={logical_axis: mesh_axis|
   None}``, the ``DEFAULT_RULES`` idiom) down to per-parameter
   ``dispatch`` specs — the hand-spec equivalent the planner
   (:mod:`.planner`) and the realization (:mod:`.tensor_parallel`)
   already lower; a hand-written dispatch that contradicts the
   compiled rule is an HT205 finding (plan-vs-rules conflict),
3. **scores each candidate** with a closed-form cost model on the
   measured :class:`~hetu_tpu_torch.telemetry.costdb.CostDB`:

   * compute from per-op DB entries (``profile_op_records`` populated),
     FLOPs-proportional on a miss — calibrated against the ops the DB
     did measure, the cold-start ``cold_start_flops_ms`` when it
     measured none;
   * comm from the DB's latency+bandwidth curves applied to the dp
     gradient-allreduce bytes, the tp partial-sum bytes and the
     pipeline boundary bytes;
   * the pipeline bubble from the schedule's analytic fill/drain
     fraction (``pipeline.analytic_bubble_fraction``), with a per-tick
     overhead from the p2p latency curve, which is what picks M, V and
     fuse_ticks;

4. **optionally refines** the top-k finalists by measurement through
   the ``tune/autotune.py`` engine (keyed ``platform|autoplan|model|
   nworld``; deterministic under ``HETU_AUTOTUNE=1`` with a warm
   cache), and
5. **applies** the winner (:func:`apply_plan`, :func:`plan_overrides`):
   dispatch markers spliced for tp, stage contexts over the balanced
   per-op-cost cut for pp, the executor kwargs (schedule, M,
   ``pp_options``, the dp bucket) returned, and the ranks that run it:
   a mesh over a launcher job's ranks, or thread ranks of this process
   (:mod:`.local_ranks`) outside one. In a job rank 0 plans and every
   rank takes its plan (:func:`agree_on_plan`).

Estimates are labeled ``measured`` / ``curve`` / ``cold_start`` per
input (``CostDB.coverage``), and the report — printed under
``HETU_AUTOPLAN_REPORT`` and by the launcher's ``--autoplan`` — carries
the split, so a ranking that rests on guesses says so on its face.
"""
from __future__ import annotations

import logging
import os

import numpy as np

__all__ = ["DEFAULT_RULES", "Plan", "AutoPlanResult", "RuleBinding",
           "logical_axes_of", "compile_rules", "apply_rules",
           "enumerate_candidates", "balance_stages", "flops_of",
           "graph_costs", "score_plan", "choose_plan", "default_nworld",
           "apply_plan", "plan_overrides", "agree_on_plan", "plan_key"]

logger = logging.getLogger(__name__)

# logical axis -> mesh axis or None (replicated). "dp"/"tp" are the
# planner's mesh axes; a model can extend the vocabulary via
# Variable(..).logical_axes.
DEFAULT_RULES = {
    "batch": "dp",      # feed batch dim (data parallelism)
    "in": None,         # matmul contraction dim: replicated
    "out": "tp",        # matmul output features: column-split
    "vocab": "tp",      # embedding rows / output vocab
    "embed": None,      # embedding width / bias dims
    "cout": "tp",       # conv output channels
}


def logical_axes_of(param, topo):
    """Per-dim logical axis names of a trainable parameter: an explicit
    ``param.logical_axes`` wins; otherwise inferred from the consuming
    op: matmul weights are ("in", "out"), embedding tables ("vocab",
    "embed"), conv filters ("cout", "cin", "kh", "kw"), 1-D params
    ("embed",)."""
    explicit = getattr(param, "logical_axes", None)
    if explicit:
        return tuple(explicit)
    from ..ops.comm import DispatchOp
    from ..ops.conv import Conv2dOp
    from ..ops.embedding import EmbeddingLookUp
    from ..ops.linalg import BatchMatMulOp, MatMulOp
    ndim = len(getattr(param, "shape", ()) or ())
    # see through hand Dispatch wrappers: the classifying consumer of
    # dispatch(param, ...) is the param's consumer
    alias = {param}
    for node in topo:
        if isinstance(node, DispatchOp) and node.inputs \
                and node.inputs[0] in alias:
            alias.add(node)

    def feeds(node, pos=None):
        ins = getattr(node, "inputs", ())
        if pos is not None:
            return len(ins) > pos and ins[pos] in alias
        return any(i in alias for i in ins)

    for node in topo:
        if not feeds(node):
            continue
        if isinstance(node, EmbeddingLookUp) and feeds(node, 0):
            return ("vocab", "embed")
        if isinstance(node, (MatMulOp, BatchMatMulOp)) \
                and feeds(node, 1) and ndim == 2:
            return ("in", "out")
        if isinstance(node, Conv2dOp) and feeds(node, 1) and ndim == 4:
            return ("cout", "cin", "kh", "kw")
    if ndim == 1:
        return ("embed",)
    return None


class RuleBinding:
    """One parameter's compiled split: the Dispatch spec the rules table
    implies (``parts`` is the DispatchOp constructor tuple)."""

    __slots__ = ("param", "axes", "parts", "dim", "axis_name")

    def __init__(self, param, axes, parts, dim, axis_name):
        self.param = param
        self.axes = axes
        self.parts = parts
        self.dim = dim
        self.axis_name = axis_name

    def __repr__(self):
        return (f"RuleBinding({self.param.name}: {self.axes} -> "
                f"parts {self.parts})")


def compile_rules(eval_nodes, rules=None, tp=1, topo=None):
    """Compile a ``{logical_axis: mesh_axis|None}`` table down to
    per-parameter Dispatch ``parts`` tuples (the hand-spec equivalent).

    Returns ``(bindings, conflicts)``: one :class:`RuleBinding` per
    parameter the rules split ``tp`` ways, and an HT205 conflict entry
    per parameter whose graph ALREADY carries a hand Dispatch that
    disagrees with the compiled rule (the hand spec wins at apply time;
    the finding goes to the active ``analysis.findings.collecting``
    report, else to a logged warning). A dim that ``tp`` does not divide
    is skipped."""
    from ..analysis.findings import emit
    from ..graph.autodiff import find_topo_sort
    from ..ops.comm import DispatchOp
    from ..ops.variable import PlaceholderOp

    rules = dict(DEFAULT_RULES) if rules is None else dict(rules)
    if topo is None:
        topo = find_topo_sort(list(eval_nodes))
    hand = {}       # param -> existing DispatchOp parts
    for node in topo:
        if isinstance(node, DispatchOp) and node.inputs \
                and isinstance(node.inputs[0], PlaceholderOp):
            hand[node.inputs[0]] = node.parts
    bindings, conflicts = [], []
    if tp <= 1:
        return bindings, conflicts
    for node in topo:
        if not (isinstance(node, PlaceholderOp) and node.trainable):
            continue
        axes = logical_axes_of(node, topo)
        if not axes:
            continue
        shape = tuple(getattr(node, "shape", ()) or ())
        for dim, axis in enumerate(axes):
            if rules.get(axis) != "tp":
                continue
            if dim >= len(shape) or shape[dim] % tp != 0:
                continue
            parts = tuple(tp if d == dim else 1
                          for d in range(len(shape)))
            if node in hand:
                if tuple(hand[node]) != parts:
                    msg = (f"plan-vs-rules conflict on {node.name}: "
                           f"hand-written dispatch {tuple(hand[node])} "
                           f"vs rules-compiled {parts} (axis "
                           f"{axis!r} -> tp={tp}) — the hand spec "
                           f"wins; drop it or fix the rules table")
                    conflicts.append((node, tuple(hand[node]), parts))
                    if not emit("HT205", "warn", msg, node=node):
                        logger.warning("%s", msg)
                break       # hand spec present: never double-split
            bindings.append(RuleBinding(node, axes, parts, dim, axis))
            break           # one split dim per param
    return bindings, conflicts


def _placed(node):
    ctx = node.raw_ctx
    return ctx is not None and ctx.worker_num + ctx.server_num > 0


def apply_rules(eval_nodes, bindings, shapes=None):
    """Splice the compiled Dispatch markers into the graph: for each
    binding, consumers of the parameter are rewired through a fresh
    ``DispatchOp(param, parts)``, and each split op's OUTPUT is rewired
    through an all-ones gather dispatch — the hand-TP idiom's
    ``act = ht.dispatch(act, (1, 1))`` between layers, without which
    consecutive splits compound into a tp^depth-way plan. ``shapes``
    (node -> shape) sizes each gather's parts; without it they are
    ``(1, 1)``, and a status shorter than its tensor pads with 1s.
    Returns the spliced dispatch ops."""
    from ..graph.autodiff import find_topo_sort
    from ..ops.comm import dispatch

    if not bindings:
        return []
    topo = find_topo_sort(list(eval_nodes))
    shapes = shapes or {}
    spliced = []
    consumers_of = {}
    for node in topo:
        for i in getattr(node, "inputs", ()):
            consumers_of.setdefault(id(i), []).append(node)
    for b in bindings:
        # the dispatch sits where its parameter's readers are: a pipeline
        # puts unplaced compute in its deepest input's stage, and a
        # model built outside every stage context (staged_gpt) leaves
        # its parameters unplaced
        readers = [n for n in consumers_of.get(id(b.param), ())
                   if _placed(n)]
        ctx = b.param.raw_ctx if _placed(b.param) or not readers \
            else readers[0].raw_ctx
        d = dispatch(b.param, b.parts, ctx=ctx)
        split_ops = []
        for node in consumers_of.get(id(b.param), ()):
            if node is d:
                continue
            node.inputs = [d if i is b.param else i
                           for i in node.inputs]
            split_ops.append(node)
        spliced.append(d)
        for op in split_ops:
            out_shape = shapes.get(op)
            ndim = len(out_shape) if out_shape else 2
            g = dispatch(op, (1,) * ndim, ctx=op.raw_ctx)
            for cons in consumers_of.get(id(op), ()):
                if cons is g:
                    continue
                cons.inputs = [g if i is op else i
                               for i in cons.inputs]
            spliced.append(g)
    return spliced


_M_CANDIDATES = (2, 4, 8, 16, 32)
_V_CANDIDATES = (1, 2, 4)
_TRAIN_FLOP_FACTOR = 3.0    # fwd + ~2x fwd for the backward
# at Executor construction feeds are unshaped, so activation shapes are
# unknown; weight-touching ops then assume this batch for their FLOPs
# (pass feed_shapes / autoplan_options={"feed_shapes": ...} for exact
# numbers — ranking only needs relative mass, which params dominate)
_DEFAULT_BATCH = 32


class Plan:
    """One candidate parallel configuration plus its predicted cost."""

    __slots__ = ("dp", "tp", "pp", "M", "V", "fuse_ticks", "schedule",
                 "stage_cut", "predicted_ms", "measured_ms",
                 "breakdown", "bindings", "rules", "notes")

    def __init__(self, dp=1, tp=1, pp=1, M=1, V=1, fuse_ticks=1,
                 schedule="spmd", stage_cut=(), predicted_ms=None,
                 breakdown=None, bindings=(), rules=None, notes=()):
        self.dp, self.tp, self.pp = int(dp), int(tp), int(pp)
        self.M, self.V = int(M), int(V)
        self.fuse_ticks = int(fuse_ticks)
        self.schedule = schedule
        self.stage_cut = tuple(stage_cut)
        self.predicted_ms = predicted_ms
        self.measured_ms = None
        self.breakdown = dict(breakdown or {})
        self.bindings = tuple(bindings)
        self.rules = dict(rules) if rules is not None else None
        self.notes = tuple(notes)

    @property
    def nworld(self):
        return self.dp * self.tp * self.pp

    def key(self):
        return (self.dp, self.tp, self.pp, self.M, self.V,
                self.fuse_ticks)

    def describe(self):
        s = f"dp{self.dp}·tp{self.tp}·pp{self.pp}"
        if self.pp > 1:
            s += f" {self.schedule} M={self.M}"
            if self.V > 1:
                s += f" V={self.V}"
            if self.fuse_ticks > 1:
                s += f" fuse={self.fuse_ticks}"
        return s

    def to_dict(self):
        return {"dp": self.dp, "tp": self.tp, "pp": self.pp,
                "M": self.M, "V": self.V, "fuse_ticks": self.fuse_ticks,
                "schedule": self.schedule, "stage_cut": list(self.stage_cut),
                "predicted_ms": self.predicted_ms,
                "measured_ms": self.measured_ms,
                "breakdown": self.breakdown, "notes": list(self.notes)}

    def __repr__(self):
        return f"Plan({self.describe()}, predicted={self.predicted_ms})"


def plan_key(plan):
    """Stable string form of a plan's knobs — the CI snapshot unit and
    the autotune-refinement candidate id."""
    return "dp{}-tp{}-pp{}-M{}-V{}-f{}".format(*plan.key())


# ---------------------------------------------------------------------------
# per-op cost extraction
# ---------------------------------------------------------------------------

def flops_of(node, shapes):
    """Analytic forward FLOPs of one op (the fallback scale when the
    CostDB has no measured entry): matmul/conv count multiply-adds,
    everything else counts one op per output element."""
    out = shapes.get(node) or ()
    ins = [shapes.get(i) for i in getattr(node, "inputs", ())]
    kind = type(node).__name__

    def prod(s):
        try:
            return int(np.prod([int(d) for d in s])) if s else 0
        except (TypeError, ValueError):
            return 0

    if kind == "MatMulOp" and len(ins) == 2 and ins[1]:
        if ins[0] and out:
            # contraction dim honors the transpose flag: a gradient
            # matmul (trans_A=True) contracts over ins[0][-2], and
            # reading [-1] there inflates its FLOPs by the weight dim
            k = int(ins[0][-2]
                    if getattr(node, "matmul_attr_trans_A", False)
                    else ins[0][-1])
            return 2.0 * prod(out) * k
        # activation shape unknown (construction-time planning):
        # assume the default batch over the known weight
        return 2.0 * _DEFAULT_BATCH * prod(ins[1])
    if kind == "BatchMatMulOp" and len(ins) == 2 and ins[0] and out:
        return 2.0 * prod(out) * int(ins[0][-1])
    if kind == "Conv2dOp" and len(ins) == 2 and ins[1] and len(
            ins[1]) == 4:
        cin, kh, kw = int(ins[1][1]), int(ins[1][2]), int(ins[1][3])
        base = prod(out) if out else \
            _DEFAULT_BATCH * int(ins[1][0])
        return 2.0 * base * cin * kh * kw
    if kind in ("EmbeddingLookUp", "EmbeddingLookUpGradient"):
        return float(prod(out)) if out else \
            float(_DEFAULT_BATCH * (ins[0][-1] if ins[0] else 1))
    return float(prod(out))


def _bytes_of(shape, itemsize=4):
    try:
        return int(np.prod([int(d) for d in shape])) * itemsize \
            if shape else 0
    except (TypeError, ValueError):
        return 0


def _session_feed_shapes(topo, feed_shapes, dtype):
    """``feed_shapes`` with every float leaf of ``topo`` (a parameter, a
    feed) declared ``dtype``: a session of ``HetuConfig(dtype=...)``
    casts its float parameters and feeds to it, and the shape pass then
    gives each op the dtype it computes in."""
    from ..analysis.shapes import _resolve_feed_shapes, as_dtype
    from ..ops.variable import PlaceholderOp
    declared = _resolve_feed_shapes(feed_shapes, topo)
    out = {}
    for node in topo:
        if not isinstance(node, PlaceholderOp):
            continue
        shape, dt = declared.get(node, (
            tuple(node.shape) if node.shape is not None else None, None))
        if shape is None:
            continue
        dt = dt if dt is not None else as_dtype(getattr(node, "dtype", None))
        if dt is None or dt.is_floating_point:
            dt = dtype
        out[node] = (shape, dt)
    return out


def _dtype_name(dt):
    """A shape-pass dtype as a CostDB entry names it (``float32`` where
    it is unknown, the JAX package's one lookup key)."""
    return "float32" if dt is None else str(dt).split(".")[-1]


def graph_costs(eval_nodes, db=None, feed_shapes=None, topo=None,
                dtype=None):
    """Per-op compute costs + the volumes the comm model needs.

    Returns a dict:

    * ``op_ms``      — {node: ms} per forward op (training factor
      applied), measured entries preferred, FLOPs-scaled otherwise. An
      op's entry is the one of its kind, shape and dtype, the dtype the
      shape pass gives it (under ``dtype``, a session's ``HetuConfig``
      dtype, its float leaves in that dtype; ``float32`` where unknown:
      the JAX package's key, which it gives every op);
    * ``sources``    — {node: "measured"|"flops_scaled"|"cold_start"};
    * ``fwd_order``  — the forward (non-placeholder, non-optimizer)
      ops in topo order (the stage-cut axis);
    * ``shapes``     — the shape map (for comm-byte estimates);
    * ``param_bytes``— total trainable parameter bytes;
    * ``splittable`` — {tp candidate divisor -> True} probe source:
      per-param dim sizes the rules could split.
    """
    from ..graph.autodiff import find_topo_sort
    from ..optimizer import OptimizerOp
    from ..ops.variable import PlaceholderOp
    from ..analysis.findings import Report
    from ..analysis.shapes import shape_pass
    from ..telemetry import costdb as _costdb

    if topo is None:
        topo = find_topo_sort(list(eval_nodes))
    if dtype is not None:
        feed_shapes = _session_feed_shapes(topo, feed_shapes, dtype)
    dtypes = {}
    shapes = shape_pass(topo, Report(), feed_shapes=feed_shapes,
                        dtypes_out=dtypes) or {}

    # the stage-cut axis is the FORWARD graph only (pipeline stages
    # place forward ops; each stage's backward is its own vjp) — the
    # _TRAIN_FLOP_FACTOR on forward op costs accounts for the backward,
    # so costing grad ops separately would double-count it
    fwd_roots = [n for n in eval_nodes
                 if not isinstance(n, OptimizerOp)]
    fwd_topo = find_topo_sort(fwd_roots) if fwd_roots else []
    fwd = [n for n in fwd_topo if not isinstance(n, PlaceholderOp)]
    params = [n for n in topo
              if isinstance(n, PlaceholderOp) and n.trainable]

    # measured-vs-flops calibration: ops the DB measured anchor the
    # FLOPs scale for the ones it did not
    op_ms, sources = {}, {}
    cal_fl, cal_ms = 0.0, 0.0
    measured = {}
    if db is not None:
        for node in fwd:
            ent = db.get(type(node).__name__, shapes.get(node),
                         _dtype_name(dtypes.get(node)))
            if ent is not None:
                measured[node] = float(ent["ms"])
                fl = flops_of(node, shapes)
                if fl > 0 and ent["ms"] > 0:
                    cal_fl += fl
                    cal_ms += float(ent["ms"])
    flops_per_ms = (cal_fl / cal_ms) if cal_ms > 0 else None
    for node in fwd:
        if node in measured:
            op_ms[node] = measured[node] * _TRAIN_FLOP_FACTOR
            sources[node] = "measured"
            continue
        fl = flops_of(node, shapes) * _TRAIN_FLOP_FACTOR
        if flops_per_ms:
            op_ms[node] = fl / flops_per_ms
            sources[node] = "flops_scaled"
        else:
            op_ms[node] = _costdb.cold_start_flops_ms(fl)
            sources[node] = "cold_start"

    splittable = set()
    for p in params:
        for d in tuple(getattr(p, "shape", ()) or ()):
            # divisors up to a practical mesh width — a million-row
            # embedding table must not cost a million-iteration scan
            for q in range(2, min(int(d), 512) + 1):
                if d % q == 0:
                    splittable.add(q)
    return {
        "op_ms": op_ms,
        "sources": sources,
        "fwd_order": fwd,
        "shapes": shapes,
        "params": params,
        "param_bytes": sum(_bytes_of(p.shape) for p in params),
        "splittable": splittable,
        "topo": topo,
    }


def balance_stages(costs, fwd_order, pp):
    """Contiguous pp-way cut of the forward op chain minimizing the max
    stage cost (greedy over prefix sums — the per-op measured costs are
    what makes "balanced" mean milliseconds, not op counts). Returns
    (cut_indices, stage_ms): ``cut_indices`` are the pp-1 topo
    positions where a new stage starts."""
    ms = [max(0.0, costs.get(n, 0.0)) for n in fwd_order]
    total = sum(ms)
    if pp <= 1 or not ms:
        return (), [total]
    target = total / pp
    cuts, acc, stage_ms = [], 0.0, []
    for i, v in enumerate(ms):
        remaining_stages = pp - len(cuts)
        if len(cuts) < pp - 1 and acc >= target and \
                len(ms) - i >= remaining_stages - 1:
            cuts.append(i)
            stage_ms.append(acc)
            acc = 0.0
        acc += v
    stage_ms.append(acc)
    while len(stage_ms) < pp:       # degenerate: not enough mass
        stage_ms.append(0.0)
    return tuple(cuts), stage_ms


# ---------------------------------------------------------------------------
# candidate enumeration + scoring
# ---------------------------------------------------------------------------

def enumerate_candidates(nworld, info=None, rules=None, max_pp=None):
    """``(dp, tp, pp)`` factorizations of every device count up to
    ``nworld`` (a tiny model's best plan is often to use FEWER devices
    than the world — the single-device (1,1,1) baseline is always a
    candidate), pruned against the graph. Returns (valid, rejected)
    where rejected pairs each pruned tuple with its reason — the
    enumeration must be auditable, not just correct."""
    valid, rejected = [], []
    rules = dict(DEFAULT_RULES) if rules is None else dict(rules)
    tp_on = any(v == "tp" for v in rules.values())
    splittable = (info or {}).get("splittable", set())
    n_ops = len((info or {}).get("fwd_order", ()))
    seen = set()
    for world in _divisors(nworld):
        for dp in _divisors(world):
            for tp in _divisors(world // dp):
                pp = world // dp // tp
                cand = (dp, tp, pp)
                if cand in seen:
                    continue
                seen.add(cand)
                if tp > 1 and not tp_on:
                    rejected.append(
                        (cand, "rules bind no axis to tp"))
                    continue
                if tp > 1 and info is not None \
                        and tp not in splittable:
                    rejected.append(
                        (cand,
                         f"no parameter dim divisible by tp={tp}"))
                    continue
                if max_pp is not None and pp > max_pp:
                    rejected.append(
                        (cand, f"pp={pp} > max_pp={max_pp}"))
                    continue
                if pp > 1 and info is not None and pp > max(n_ops, 1):
                    rejected.append(
                        (cand,
                         f"pp={pp} deeper than the {n_ops}-op chain"))
                    continue
                valid.append(cand)
    return valid, rejected


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def _comm_est(db, kind, nbytes):
    """(ms, source) from the CostDB with the cold-start floor."""
    from ..telemetry import costdb as _costdb
    if db is None:
        return _costdb.cold_start_ms(kind, nbytes), "cold_start"
    return db.estimate_info(kind, nbytes, cold_start=True)


def score_plan(dp, tp, pp, info, db=None, schedule=None,
               num_microbatches=None):
    """Closed-form cost of one mesh factorization; picks the best
    (M, V, fuse_ticks, stage cut) for the pipeline dimension and
    returns the resulting :class:`Plan` with its breakdown.

    The model (the JAX package's docs/parallelism.md, "Cost-model
    inputs"):

    * compute: sum of per-op ms / dp (batch split), split ops
      additionally / tp;
    * dp comm: one gradient allreduce of the (tp-reduced) parameter
      bytes;
    * tp comm: implicit-reshard volume — for each split parameter, its
      consumer's activation row is partially reduced across tp (the
      HT203 edge set), costed on the allreduce curve;
    * pp: per-stage compute from the balanced cut, wall multiplied by
      the analytic fill/drain factor ``(V·M + S - 1)/(V·M)``, plus
      boundary p2p bytes and a per-tick latency term that penalizes
      large M·V when the p2p latency curve says ticks are expensive —
      the argmin over (M, V) IS the auto-pick.
    """
    from .pipeline import analytic_bubble_fraction

    op_ms = info["op_ms"]
    shapes = info["shapes"]
    fwd = info["fwd_order"]
    notes = []

    # tp: which ops the rules-compiled split accelerates
    split_ops = set()
    if tp > 1:
        bindings = info.get("bindings") or ()
        split_params = {b.param for b in bindings}
        for node in fwd:
            if any(i in split_params for i in
                   getattr(node, "inputs", ())):
                split_ops.add(node)
    eff_ms = {n: (v / tp if n in split_ops else v)
              for n, v in op_ms.items()}
    compute_ms = sum(eff_ms.values()) / max(1, dp)

    comm_ms = 0.0
    srcs = set(info["sources"].values())
    if dp > 1:
        grad_bytes = info["param_bytes"]
        if tp > 1:
            grad_bytes = int(grad_bytes / tp)
        ms, src = _comm_est(db, "allreduce", grad_bytes)
        comm_ms += ms
        srcs.add(src)
    if tp > 1:
        # partial-sum reduction per split matmul's output row (the
        # HT203 implicit-reshard edges the sharding pass reports)
        reshard = sum(_bytes_of(shapes.get(n)) for n in split_ops)
        ms, src = _comm_est(db, "allreduce", max(1, reshard))
        comm_ms += ms
        srcs.add(src)

    if pp <= 1:
        plan = Plan(dp, tp, pp, M=1, V=1, schedule="spmd",
                    predicted_ms=compute_ms + comm_ms,
                    breakdown={"compute_ms": round(compute_ms, 4),
                               "comm_ms": round(comm_ms, 4),
                               "bubble_fraction": 0.0,
                               "sources": sorted(srcs)},
                    notes=notes)
        return plan

    cut, stage_ms = balance_stages(eff_ms, fwd, pp)
    stage_max = max(stage_ms) if stage_ms else 0.0
    # boundary tensor: the activation crossing the first cut (uniform
    # chains have one size; fall back to the largest activation)
    if cut:
        bnode = fwd[cut[0] - 1]
        bbytes = _bytes_of(shapes.get(bnode)) or 4
    else:
        bbytes = max((_bytes_of(shapes.get(n)) for n in fwd),
                     default=4)
    bbytes = max(1, bbytes // max(1, dp))

    best = None
    m_fixed = [num_microbatches] if num_microbatches else _M_CANDIDATES
    for M in m_fixed:
        for V in _V_CANDIDATES:
            if V > 1 and (M < pp or schedule == "gpipe"):
                continue        # interleaving requires M >= S devices
            bubble = analytic_bubble_fraction(pp * V, M, V)
            wall = stage_max / max(1e-9, (1.0 - bubble))
            # per-microbatch boundary transfer (fwd + cotangent) and a
            # per-tick latency term: more ticks cost more dispatch
            per_mb, src = _comm_est(db, "p2p", max(1, bbytes // M) * 2)
            ticks = V * M + pp - 1
            lat_ms, lsrc = _comm_est(db, "p2p", 1)
            pipe_comm = per_mb * M * max(1, pp - 1) / max(1, pp) \
                + ticks * lat_ms
            total = wall + comm_ms + pipe_comm
            cand = (total, M, V, bubble, pipe_comm,
                    {src, lsrc})
            if best is None or total < best[0]:
                best = cand
    total, M, V, bubble, pipe_comm, psrc = best
    srcs |= psrc
    sched = schedule or ("collective" if V > 1 else "gpipe")
    fuse = 2 if M * V >= 8 and sched == "collective" else 1
    plan = Plan(dp, tp, pp, M=M, V=V, fuse_ticks=fuse, schedule=sched,
                stage_cut=cut,
                predicted_ms=total,
                breakdown={"compute_ms": round(compute_ms, 4),
                           "stage_max_ms": round(stage_max, 4),
                           "comm_ms": round(comm_ms + pipe_comm, 4),
                           "bubble_fraction": round(bubble, 4),
                           "sources": sorted(srcs)},
                notes=notes)
    return plan


# ---------------------------------------------------------------------------
# the planner front door
# ---------------------------------------------------------------------------

class AutoPlanResult:
    """Chosen plan + the full scored candidate table + the DB coverage
    split — everything the ``--autoplan`` report prints."""

    def __init__(self, plan, candidates, rejected, coverage, model,
                 nworld, info=None):
        self.plan = plan
        self.candidates = candidates
        self.rejected = rejected
        self.coverage = coverage        # (measured kinds, guessed kinds)
        self.model = model
        self.nworld = nworld
        self.info = info                # graph_costs() output (apply reuse)

    def to_dict(self):
        measured, guessed = self.coverage
        return {"model": self.model, "nworld": self.nworld,
                "chosen": self.plan.to_dict(),
                "candidates": [p.to_dict() for p in self.candidates],
                "rejected": [{"mesh": list(c), "reason": r}
                             for c, r in self.rejected],
                "coverage": {"measured": [str(k) for k in measured],
                             "guessed": [str(k) for k in guessed]}}

    def render(self):
        """The predicted-vs-measured cost table (text)."""
        lines = [f"autoplan: {self.model} over {self.nworld} device(s)"]
        lines.append(f"{'candidate':<30} {'predicted':>12} "
                     f"{'measured':>12}  breakdown")
        for p in self.candidates:
            mark = " *" if p is self.plan else "  "
            meas = (f"{p.measured_ms:.2f} ms"
                    if p.measured_ms is not None else "-")
            bd = p.breakdown
            det = (f"compute {bd.get('compute_ms', 0):.2f} / comm "
                   f"{bd.get('comm_ms', 0):.2f} / bubble "
                   f"{bd.get('bubble_fraction', 0):.3f}")
            lines.append(f"{mark}{p.describe():<28} "
                         f"{p.predicted_ms:>9.2f} ms {meas:>12}  {det}")
        for cand, reason in self.rejected:
            lines.append(f"  pruned dp{cand[0]}·tp{cand[1]}"
                         f"·pp{cand[2]}: {reason}")
        measured, guessed = self.coverage
        lines.append(f"cost inputs measured: "
                     f"{[str(k) for k in measured] or '-'}")
        lines.append(f"cost inputs guessed (cold start): "
                     f"{[str(k) for k in guessed] or 'none'} — run "
                     f"`python -m hetu_tpu_torch.telemetry.costdb --sweep` "
                     f"to measure")
        lines.append(f"chosen: {self.plan.describe()} "
                     f"(predicted {self.plan.predicted_ms:.2f} ms)")
        return "\n".join(lines)


def default_nworld(device=None):
    """The world the planner plans for when the caller names none: the
    job's world size in a launcher's job (joined, or about to be:
    ``HETU_NUM_PROCS``), else the card count where the session is on a
    card, else 1."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    procs = int(os.environ.get("HETU_NUM_PROCS", "1"))
    if procs > 1:
        return procs
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def choose_plan(eval_nodes, nworld=None, rules=None, db=None,
                feed_shapes=None, num_microbatches=None, model="model",
                measure=None, topk=3, max_pp=None, device=None,
                dtype=None):
    """Enumerate, score, and (optionally) measure candidates; returns
    an :class:`AutoPlanResult` with the argmin plan.

    ``nworld`` defaults to :func:`default_nworld` (the JAX package takes
    ``len(jax.devices())``); ``device`` keys the CostDB and autotune
    lookups by its platform (default: the card when there is one);
    ``dtype`` is the session's compute dtype (``HetuConfig``'s), under
    which :func:`graph_costs` looks its ops up.
    ``measure(plan) -> seconds`` activates the top-``topk`` refinement
    through the autotune engine: the winner is cached under
    ``platform|autoplan|<model>|<nworld>`` exactly like a kernel block
    sweep, so a re-run plans once and CI replays deterministically
    under ``HETU_AUTOTUNE=1``."""
    from ..telemetry.costdb import CostDB, COMM_KINDS
    from ..tune.autotune import platform_scope

    with platform_scope(device):
        if nworld is None:
            nworld = default_nworld(device)
        if db is None:
            db = CostDB()
        info = graph_costs(eval_nodes, db=db, feed_shapes=feed_shapes,
                           dtype=dtype)
        info["db"] = db             # apply_plan derives dp knob defaults
        # (bucket_bytes) from the same DB the plan was scored on
        rules = dict(DEFAULT_RULES) if rules is None else dict(rules)

        cands, rejected = enumerate_candidates(nworld, info=info,
                                               rules=rules,
                                               max_pp=max_pp)
        plans = []
        compiled_by_tp = {}     # rules compilation depends only on tp
        for dp, tp, pp in cands:
            if tp not in compiled_by_tp:
                compiled_by_tp[tp] = compile_rules(eval_nodes, rules, tp,
                                                   topo=info["topo"])
            bindings, _conf = compiled_by_tp[tp]
            if tp > 1 and not bindings:
                rejected.append(((dp, tp, pp),
                                 "rules compile to no split at this tp"))
                continue
            info["bindings"] = bindings
            plan = score_plan(dp, tp, pp, info, db=db,
                              num_microbatches=num_microbatches)
            plan.bindings = tuple(bindings)
            plan.rules = dict(rules)
            plans.append(plan)
        if not plans:
            plans = [Plan(predicted_ms=sum(info["op_ms"].values()),
                          rules=rules)]
        plans.sort(key=lambda p: p.predicted_ms)

        if measure is not None and len(plans) > 1:
            winner_key = _refine_measured(plans[:max(1, topk)], measure,
                                          model, nworld)
            plans.sort(key=lambda p: (p.measured_ms
                                      if p.measured_ms is not None
                                      else p.predicted_ms))
            if winner_key is not None:
                # a warm autotune cache returns the winner WITHOUT
                # re-measuring (times empty): honor it anyway, or
                # re-runs would silently fall back to the predicted
                # argmin
                for i, p in enumerate(plans):
                    if plan_key(p) == winner_key:
                        plans.insert(0, plans.pop(i))
                        break

        comm_cov = db.coverage(COMM_KINDS)
        # fold the per-op compute coverage into the same report: how
        # many op costs were measured vs guessed
        n_meas = sum(1 for s in info["sources"].values()
                     if s == "measured")
        n_all = max(1, len(info["sources"]))
        measured_k, guessed_k = list(comm_cov[0]), list(comm_cov[1])
        if n_meas:
            measured_k.append(f"op-compute:{n_meas}/{n_all}")
        else:
            guessed_k.append("op-compute (FLOPs cold start)")
        return AutoPlanResult(plans[0], plans, rejected,
                              (measured_k, guessed_k), model, nworld,
                              info=info)


def _refine_measured(finalists, measure, model, nworld):
    """Measure the finalists through tune/autotune: candidates are
    plan keys, the winner persists in the shared autotune cache.
    Returns the winner's plan key (the cached one on a warm-cache
    replay, where ``measure`` never runs) or None when tuning is
    off / the sweep produced nothing."""
    from ..tune.autotune import autotune, tuning_mode

    if tuning_mode() == "off":
        return None
    by_key = {plan_key(p): p for p in finalists}
    times = {}

    def measure_rec(key):
        dt = float(measure(by_key[key]))
        times[key] = dt
        return dt

    winner = autotune("autoplan", (model, nworld), list(by_key),
                      measure_rec, default=None)
    for key, dt in times.items():
        by_key[key].measured_ms = dt * 1000.0
    return winner if winner in by_key else None


# ---------------------------------------------------------------------------
# plan application (the Executor(parallel="auto") path)
# ---------------------------------------------------------------------------

def _in_job():
    """Whether this process is one rank of a launcher's job of several
    (joined, or about to join: ``HETU_NUM_PROCS``)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size() > 1
    return int(os.environ.get("HETU_NUM_PROCS", "1")) > 1


def apply_plan(eval_nodes, plan, info=None, _splice_rules=True,
               device=None, in_job=None):
    """Mutate the graph per the chosen plan and return the executor
    kwargs overrides ``HetuConfig`` merges in:

    * tp: the compiled Dispatch markers splice in (``apply_rules``) —
      the existing planner lowers them from here;
    * pp: forward ops get stage device contexts over the balanced cut.
      In one process they are ``rcpu`` / ``rgpu`` (after ``device``'s
      kind; default the card where there is one) ``("localhost", k)``
      for stage k, ``("v<v>", k)`` for virtual stage v of V > 1, as the
      JAX package names them; the pipeline runs them all in this
      process (``gpu(k)`` wraps around the cards there are). In a
      launcher's job (``in_job``, default: one is joined or about to
      be) chunk c's host is ``worker<c mod pp>``, which the pipeline
      maps to that rank (``pipeline._owner_of``), so V > 1 chunks fold
      round-robin onto the pp ranks exactly like the reference's; its
      device id is that rank's card, offset by whole multiples of the
      card count per virtual stage so a rank's V chunks stay distinct
      stages;
    * dp: the plan's ``overlap_options`` bucket; the ranks themselves
      come from :func:`plan_overrides`.

    Returns ``{"gpipe"/"pipedream"/"pipeline_mode": ...,
    "num_microbatches": ..., "pp_options": ..., "overlap_options":
    ...}`` (empty for a one-device plan)."""
    import torch

    from ..context import DeviceGroup
    from ..ndarray import rcpu, rgpu

    overrides = {}
    if info is None:
        info = graph_costs(eval_nodes)
    if plan.dp > 1:
        # dp plans bucket their gradient allreduce by default: the
        # CostDB-derived bucket_bytes (4x the measured latency-
        # bandwidth crossover, costdb.recommend_bucket_bytes); a
        # user-supplied overlap_options value still wins in the
        # executor's merge
        from ..telemetry.costdb import recommend_bucket_bytes
        overrides["overlap_options"] = {
            "bucket_bytes": recommend_bucket_bytes(info.get("db"))}
    bindings = plan.bindings
    if plan.tp > 1 and _splice_rules:
        # a plan is often applied to a REBUILT graph (a measure-per-
        # candidate loop, a fresh training process reusing a cached
        # plan): stored bindings reference the scored graph's nodes, so
        # recompile the rules against THIS graph whenever the stored
        # params aren't its nodes — silently splicing nothing would
        # report a tp plan while running unsplit
        here = set(info["topo"])
        if not bindings or not all(b.param in here for b in bindings):
            bindings, _conf = compile_rules(eval_nodes, plan.rules,
                                            plan.tp,
                                            topo=info["topo"])
            plan.bindings = tuple(bindings)
    if bindings and _splice_rules:
        apply_rules(eval_nodes, bindings, shapes=info.get("shapes"))
    if plan.pp <= 1:
        return overrides

    fwd = info["fwd_order"]
    n_chunks = plan.pp * plan.V
    cuts = plan.stage_cut
    if len(cuts) != n_chunks - 1:
        # the score pass cut pp ways; V>1 application needs pp*V chunks
        cuts = balance_stages(info["op_ms"], fwd, n_chunks)[0]
    if device is None:
        on_cpu = not torch.cuda.is_available()
    else:
        on_cpu = torch.device(device).type == "cpu"
    mk = rcpu if on_cpu else rgpu
    if in_job is None:
        in_job = _in_job()
    cards = max(1, torch.cuda.device_count())

    def ctx_for(chunk):
        v, dev = chunk // plan.pp, chunk % plan.pp
        if in_job:
            return DeviceGroup(mk(f"worker{dev}",
                                  dev + v * plan.pp * cards))
        host = "localhost" if plan.V == 1 else f"v{v}"
        return DeviceGroup(mk(host, dev))

    chunk = 0
    bounds = set(cuts)
    chunk_of = {}
    for i, node in enumerate(fwd):
        if i in bounds and chunk < n_chunks - 1:
            chunk += 1
        node.raw_ctx = ctx_for(chunk)
        chunk_of[node] = chunk
    if plan.schedule == "collective":
        # the collective builder's contract (linear chain, homogeneous
        # per-stage params) would refuse a non-uniform cut; downgrade to
        # the staged runner when the auto cut can't satisfy the cheap
        # half of it (equal per-chunk param-shape lists), rather than
        # ship a plan that dies on first dispatch
        from ..ops.comm import DispatchOp
        from ..ops.variable import PlaceholderOp

        def _param_of(inp):
            # the tp splice above rewired params behind DispatchOps:
            # resolve through them, or every chunk list is vacuously
            # empty and the guard never fires
            while isinstance(inp, DispatchOp) and inp.inputs:
                inp = inp.inputs[0]
            return inp if (isinstance(inp, PlaceholderOp)
                           and inp.trainable) else None

        per_chunk = [[] for _ in range(n_chunks)]
        for node in fwd:
            for inp in getattr(node, "inputs", ()):
                p = _param_of(inp)
                if p is not None:
                    per_chunk[chunk_of[node]].append(
                        tuple(p.shape or ()))
        uniform = all(sorted(c) == sorted(per_chunk[0])
                      for c in per_chunk)
        if not uniform:
            plan.schedule = "gpipe"
            if plan.V > 1:
                # re-place with V folded out (staged gpipe has no
                # virtual stages; contexts must be one per device);
                # the rules were already spliced above, so the
                # recursion only redoes stage placement
                plan.V = 1
                return apply_plan(eval_nodes, plan, info=info,
                                  _splice_rules=False, device=device,
                                  in_job=in_job)
    if plan.schedule == "collective":
        overrides["pipeline_mode"] = "collective"
    elif plan.schedule == "1f1b":
        overrides["pipedream"] = True
    else:
        overrides["gpipe"] = True
    overrides["num_microbatches"] = plan.M
    pp_opts = {"virtual_stages": plan.V}
    if plan.schedule == "collective":
        pp_opts["fuse_ticks"] = plan.fuse_ticks
    overrides["pp_options"] = pp_opts
    return overrides


def plan_overrides(eval_nodes, plan, info=None, device=None):
    """:func:`apply_plan`, then the ranks that realize the plan: the
    executor kwargs of a session that runs it (``Executor(nodes,
    **plan_overrides(...))``, the user's own kwargs beside them).

    * A ``collective`` plan (a uniform chain at V > 1) runs as
      ``pipeline_mode="collective"`` with its ``virtual_stages``; in a
      launcher's job its stages span the worker processes, which the
      collective pipeline refuses, as the reference's does.
    * dp and tp without a pipeline: ``mesh`` over the plan's ranks,
      ``{"dp": dp, "tp0": ..., ...}`` (tp by its prime factors). In a
      launcher's job it is a mesh over the job's first dp·tp ranks
      (every rank of the job must call this, in one order: the mesh's
      groups are made on every rank); a rank it leaves out gets
      ``{"idle": True}`` and its session runs nothing. Outside a job it
      is a :class:`~.mesh.LocalMesh`: one thread rank a position.
    * A one-device plan in a job: rank 0 runs the step alone
      (``{"alone": True}``), the others are idle.
    * A pipeline plan runs its stages on its pp ranks (or, in one
      process, on this process's devices); dp and tp inside its stages
      stay unrealized, as the JAX package's staged runner leaves them
      (its stage contexts are single devices too)."""
    import torch.distributed as dist

    from .mesh import Job, LocalMesh, factorized_axes, subset_mesh

    in_job = _in_job()
    overrides = apply_plan(eval_nodes, plan, info=info, device=device,
                           in_job=in_job)
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("HETU_NUM_PROCS", "1"))
    if in_job and plan.nworld > world:
        raise ValueError(
            f"the plan {plan.describe()} needs {plan.nworld} ranks, the "
            f"job has {world}: plan for the job's world "
            f"(autoplan_options={{'nworld': {world}}})")
    if plan.pp > 1:
        return overrides
    axes = {"dp": plan.dp} if plan.dp > 1 else {}
    axes.update(factorized_axes(plan.tp))
    if not in_job:
        if axes:
            overrides["mesh"] = LocalMesh(axes)
        return overrides
    rank = dist.get_rank()
    if not axes:
        overrides["alone" if rank == 0 else "idle"] = True
        return overrides
    mesh = subset_mesh(axes, list(range(plan.dp * plan.tp)),
                       Job(rank, world))
    if mesh is None:
        overrides["idle"] = True
    else:
        overrides["mesh"] = mesh
    return overrides


def agree_on_plan(result):
    """In a launcher's job: rank 0's plan, on every rank. Rank 0 sends
    its plan's knobs (``plan_key``, schedule, stage cut; every rank
    calls this, a collective); each rank takes the candidate of its own
    scoring with that key, set to rank 0's knobs, or builds one from
    them. Timings (and so a measured refinement) differ by rank, and
    ranks choosing for themselves could split the job. Outside a job
    ``result.plan`` as it is."""
    import torch.distributed as dist
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return result.plan
    mine = dict(result.plan.to_dict(), key=plan_key(result.plan))
    box = [mine if dist.get_rank() == 0 else None]
    if dist.get_backend() == "nccl":
        from ..device import resolve_device
        dist.broadcast_object_list(box, src=0, device=resolve_device())
    else:
        dist.broadcast_object_list(box, src=0)
    sent = box[0]
    plan = next((p for p in result.candidates
                 if plan_key(p) == sent["key"]), None)
    if plan is None:
        plan = Plan(sent["dp"], sent["tp"], sent["pp"],
                    predicted_ms=sent["predicted_ms"],
                    breakdown=sent["breakdown"], rules=result.plan.rules)
    plan.M, plan.V = int(sent["M"]), int(sent["V"])
    plan.fuse_ticks = int(sent["fuse_ticks"])
    plan.schedule = sent["schedule"]
    plan.stage_cut = tuple(sent["stage_cut"])
    plan.measured_ms = sent["measured_ms"]
    result.plan = plan
    return plan
