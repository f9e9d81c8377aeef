"""The rules compiler of the auto-parallel planner: a logical-axis rules
table compiled to ``dispatch`` specs on a model's parameters.

Counterpart of part of ``hetu_tpu/parallel/autoplan.py``
(``DEFAULT_RULES``, ``logical_axes_of``, ``RuleBinding``,
``compile_rules``, ``apply_rules``): the JAX package's way to put
tensor-parallel specs on a zoo model without writing them by hand::

    bindings, _ = compile_rules([loss, train_op], tp=2)
    apply_rules([loss, train_op], bindings)

From there the planner (:mod:`.planner`) and the realization
(:mod:`.tensor_parallel`) own everything, exactly as if the user had
written the specs by hand. The planner that scores (dp, tp, pp) plans
with a cost model (``choose_plan``), and the executor's ``parallel=`` /
``rules=`` options, wait for ROADMAP item 11b.3. The JAX package's HT205
finding (a hand spec that contradicts the rules) is a ``logging``
warning here, with the same text.
"""
from __future__ import annotations

import logging

__all__ = ["DEFAULT_RULES", "RuleBinding", "logical_axes_of",
           "compile_rules", "apply_rules", "choose_plan"]

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
    parameter the rules split ``tp`` ways, and a conflict entry per
    parameter whose graph ALREADY carries a hand Dispatch that disagrees
    with the compiled rule (the hand spec wins, with a warning). A dim
    that ``tp`` does not divide is skipped."""
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
                    conflicts.append((node, tuple(hand[node]), parts))
                    logger.warning(
                        "plan-vs-rules conflict on %s: hand-written "
                        "dispatch %s vs rules-compiled %s (axis %r -> "
                        "tp=%d) — the hand spec wins; drop it or fix the "
                        "rules table", node.name, tuple(hand[node]), parts,
                        axis, tp)
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


def choose_plan(*args, **kwargs):
    """The cost-model planner (dp, tp, pp candidates scored on measured
    costs) is not ported."""
    raise NotImplementedError(
        "choose_plan scores (dp, tp, pp) plans with a cost model: ROADMAP "
        "item 11b.3; put tensor-parallel specs on a model with "
        "compile_rules + apply_rules, or ht.dispatch by hand")
