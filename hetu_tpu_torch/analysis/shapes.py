"""Pass 1 — static shape/dtype propagation + graph lint (HT1xx).

Counterpart of ``hetu_tpu/analysis/shapes.py``. Walks the topo order
through the ops' ``infer_shape`` protocol (the same code the executor's
shape inference runs at the first step) but *catches* the error an op
raises on mismatched inputs and turns it into a finding naming the op,
instead of a traceback from deep inside ``executor.py``. Feed
placeholders have no shape until run time, so propagation treats them
as *unknown* unless the caller supplies ``feed_shapes``; unknown inputs
simply stop propagation along that path (no false positives).

Dtypes are ``torch.dtype`` values: the reference's promotion lattice
(``jnp.promote_types``) and PyTorch's (``torch.promote_types``) agree
on the types a graph carries — bf16 with f32 is f32, an integer with a
float is the float — where numpy's would invent float64s, and numpy has
no bf16.

Error codes
-----------
HT101  shape inference failed (mismatched operands)        error
HT102  dtype-kind mismatch between declared operand dtypes  warn
HT110  dead subgraph (reachable from extra roots only)      info
HT111  trainable variable not covered by any optimizer      warn
HT112  duplicate trainable parameter name                   warn
HT150  frozen-graph violation: optimizer op                 error
HT151  frozen-graph violation: PS push op                   error
HT152  frozen-graph violation: dataloader op                error
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["shape_pass", "lint_pass", "frozen_graph_pass", "as_dtype",
           "dtype_name"]

# ops whose operands must agree in dtype *kind* (float vs int); lookup /
# indexing ops legitimately mix and are excluded
_DTYPE_STRICT = {
    "AddOp", "MulOp", "DivOp", "MatMulOp", "BatchMatMulOp", "Conv2dOp",
    "MatrixDotOp",
}


def as_dtype(dt):
    """A numpy dtype, its name, a type or a ``torch.dtype`` -> the
    ``torch.dtype`` (None where it names none)."""
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        named = getattr(torch, dt, None)
        if isinstance(named, torch.dtype):
            return named
    try:
        return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype
    except (TypeError, ValueError):
        return None


def dtype_name(dt):
    """``torch.float32`` -> ``"float32"`` (numpy's name for the same
    type)."""
    return None if dt is None else str(dt).split(".")[-1]


def _kind(dt):
    """numpy's dtype kind letter of a torch dtype."""
    if dt == torch.bool:
        return "b"
    if dt.is_complex:
        return "c"
    if dt.is_floating_point:
        return "f"
    return "i" if dt.is_signed else "u"


def _node_dtype(node):
    return as_dtype(getattr(node, "dtype", None))


def _result_dtype(node, in_dts):
    """Static result dtype for one op: declared dtype for leaves and
    casts, the promotion lattice over the known operand dtypes
    otherwise. None when nothing is known."""
    if node.op_type == "CastOp":
        return _node_dtype(node)
    if node.op_type == "OneHotOp":
        return torch.float32
    known = [d for d in in_dts if d is not None]
    if not known:
        return _node_dtype(node)
    out = known[0]
    for d in known[1:]:
        try:
            out = torch.promote_types(out, d)
        except (TypeError, RuntimeError):
            return out
    return out


def _resolve_feed_shapes(feed_shapes, topo):
    """Accept {node: shape} or {name: shape}; values may be a bare shape
    tuple or (shape, dtype)."""
    if not feed_shapes:
        return {}
    by_name = {n.name: n for n in topo}
    out = {}
    for key, val in feed_shapes.items():
        node = by_name.get(key) if isinstance(key, str) else key
        if node is None:
            continue
        if (isinstance(val, tuple) and len(val) == 2
                and isinstance(val[0], (tuple, list))):
            out[node] = (tuple(val[0]), as_dtype(val[1]))
        else:
            out[node] = (tuple(val), None)
    return out


_MISSING = object()


def shape_pass(topo, report, feed_shapes=None, dtypes_out=None):
    """Propagate shapes/dtypes; returns {node: shape or None}.

    ``dtypes_out`` (optional dict) receives ``{node: torch.dtype or
    None}``. Feed dtypes come from ``feed_shapes`` when declared there
    (id feeds are routinely built as default-float32 Variables and fed
    integer arrays; the feed spec is the truth).

    Gradient ops read a *non-input* forward node's ``inferred_shape``,
    so the pass sets it on each node as it walks (and deletes it where
    the shape is unknown, so a cross-reference to an unshaped node
    raises AttributeError and is treated as *unknown*, not as a user
    error). Prior values are restored on exit — analysis leaves the
    graph untouched.
    """
    from ..dataloader import DataloaderOp, GNNDataLoaderOp
    from ..ops.comm import PipelineReceiveOp, PipelineSendOp
    from ..ops.variable import PlaceholderOp
    from ..optimizer import OptimizerOp

    feeds = _resolve_feed_shapes(feed_shapes, topo)
    shapes = {}
    dtypes = dtypes_out if dtypes_out is not None else {}
    unknown = 0
    saved = {}

    def _mark(node, shape):
        shapes[node] = shape
        if id(node) not in saved:
            saved[id(node)] = (node,
                               getattr(node, "inferred_shape", _MISSING))
        if shape is not None:
            node.inferred_shape = shape
        elif hasattr(node, "inferred_shape"):
            del node.inferred_shape

    try:
        for node in topo:
            if node in feeds:
                shape, dt = feeds[node]
                _mark(node, shape)
                dtypes[node] = dt if dt is not None else _node_dtype(node)
                continue
            if isinstance(node, PlaceholderOp):
                _mark(node, (tuple(node.shape)
                             if node.shape is not None else None))
                dtypes[node] = _node_dtype(node)
                if shapes[node] is None:
                    unknown += 1
                continue
            if isinstance(node, (OptimizerOp, DataloaderOp,
                                 GNNDataLoaderOp, PipelineReceiveOp)):
                # host/schedule nodes carry no statically inferable shape
                # (a recv's shape comes from its bound send at run time)
                _mark(node, None)
                dtypes[node] = None
                continue
            in_shapes = [shapes.get(i) for i in node.inputs]
            if any(s is None for s in in_shapes):
                _mark(node, (in_shapes[0]
                             if isinstance(node, PipelineSendOp)
                             else None))
                dtypes[node] = _result_dtype(
                    node, [dtypes.get(i) for i in node.inputs])
                continue
            try:
                _mark(node, tuple(node.infer_shape(list(in_shapes))))
            except NotImplementedError:
                _mark(node, None)
            except AttributeError as e:
                if "inferred_shape" in str(e):
                    # cross-reference into an unshaped subgraph (a grad
                    # op's forward/target node fed by an unknown feed)
                    _mark(node, None)
                else:
                    report.add(
                        "HT101", "error",
                        f"shape inference failed for {node.op_type} "
                        f"{node.name}: {e}", node=node)
                    _mark(node, None)
            except Exception as e:  # noqa: BLE001 — the op's mismatch check
                report.add(
                    "HT101", "error",
                    f"shape inference failed for {node.op_type} "
                    f"{node.name}: {e} (inputs "
                    f"{[(i.name, shapes.get(i)) for i in node.inputs]})",
                    node=node)
                _mark(node, None)
            # dtype-kind check on strict arithmetic ops (declared only)
            in_dts = [dtypes.get(i) for i in node.inputs]
            known = [d for d in in_dts if d is not None]
            if node.op_type in _DTYPE_STRICT and len(known) >= 2:
                kinds = {_kind(d) for d in known}
                if len(kinds) > 1:
                    report.add(
                        "HT102", "warn",
                        f"{node.op_type} {node.name} mixes operand "
                        f"dtype kinds "
                        f"{sorted(dtype_name(d) for d in known)} — "
                        f"the computation will promote silently",
                        node=node)
            dtypes[node] = _result_dtype(node, in_dts)
    finally:
        for node, old in saved.values():
            if old is _MISSING:
                if hasattr(node, "inferred_shape"):
                    del node.inferred_shape
            else:
                node.inferred_shape = old
    if unknown:
        report.add(
            "HT100", "info",
            f"{unknown} feed placeholder(s) have no static shape; pass "
            f"feed_shapes= to check the full graph")
    return shapes


def lint_pass(topo, report, eval_nodes=None, extra_roots=()):
    """Dead-subgraph / unused-variable / duplicate-param lint."""
    from ..graph.autodiff import find_topo_sort
    from ..ops.variable import PlaceholderOp
    from ..optimizer import OptimizerOp

    # HT112: duplicate trainable names (Executor.save would collide)
    seen = {}
    for n in topo:
        if isinstance(n, PlaceholderOp) and n.trainable:
            if n.name in seen:
                report.add(
                    "HT112", "warn",
                    f"two trainable parameters share the name "
                    f"{n.name!r} (node ids {seen[n.name].id} and "
                    f"{n.id}) — Executor.save will refuse this graph",
                    node=n)
            else:
                seen[n.name] = n

    # HT111: trainable variable no optimizer updates (frozen by accident)
    opts = [n for n in topo if isinstance(n, OptimizerOp)]
    if opts:
        covered = set()
        for op in opts:
            covered.update(id(p) for p in (op.optimizer.params or ()))
        for n in topo:
            if isinstance(n, PlaceholderOp) and n.trainable \
                    and id(n) not in covered:
                report.add(
                    "HT111", "warn",
                    f"trainable variable {n.name!r} is consumed by the "
                    f"graph but updated by no optimizer — it trains as "
                    f"a frozen constant",
                    node=n)

    # HT110: subgraphs reachable only from extra construction roots
    if extra_roots:
        live = {id(n) for n in topo}
        dead = [n for n in find_topo_sort(list(extra_roots))
                if id(n) not in live]
        if dead:
            names = ", ".join(n.name for n in dead[:6])
            report.add(
                "HT110", "info",
                f"{len(dead)} node(s) are reachable from constructed "
                f"roots but not from the eval outputs (dead subgraph): "
                f"{names}{'...' if len(dead) > 6 else ''}",
                node=dead[0])


def frozen_graph_pass(topo, report):
    """Serving contract: an inference graph must be optimizer-,
    dataloader- and PS-push-free."""
    from ..dataloader import DataloaderOp, GNNDataLoaderOp
    from ..ops.comm import ParameterServerCommunicateOp
    from ..optimizer import OptimizerOp

    for n in topo:
        if isinstance(n, OptimizerOp):
            report.add(
                "HT150", "error",
                "InferenceSession over a training graph: eval nodes "
                "reach an OptimizerOp — pass the model outputs only "
                "(no train_op)", node=n)
        elif isinstance(n, ParameterServerCommunicateOp):
            report.add(
                "HT151", "error",
                "InferenceSession graph contains a PS push op "
                "(ParameterServerCommunicate) — serving sessions "
                "never push gradients", node=n)
        elif isinstance(n, (DataloaderOp, GNNDataLoaderOp)):
            report.add(
                "HT152", "error",
                "InferenceSession graphs are feed-driven; replace "
                "dataloader ops with placeholder feeds", node=n)
