"""Tensor-parallel planner: NodeStatus propagation → partition specs.

Counterpart of ``hetu_tpu/parallel/planner.py`` (reference parity:
``assign_context_by_traverse_nodes``, context.py:256-726). Statuses
seed at the ``dispatch`` markers and propagate through the ops'
``deduce_states`` (the matmul row/col/k table, MatrixMult.py:88-141,
and the others), then lower to partition specs over the rank mesh's
prime-factored model axes: a tuple with, for each dim, the mesh axis
(or tuple of axes) it is split over, or None.

The JAX package stops there and lets XLA's SPMD partitioner realize the
specs. The port realizes them itself, as the original Hetu did with
split/concat/add and send/recv: each rank holds its shard of a node by
its spec, and :mod:`.tensor_parallel` computes every op on the shards
or moves values between layouts with ``torch.distributed``
collectives. A status the planner cannot map is replicated, which is
exact: it only forfeits the split.

An unmappable status (HT201) and a ``deduce_states`` rule that raises
(HT202) become analysis findings under an active collector
(:func:`~hetu_tpu_torch.analysis.findings.emit`), with the node's
construction site; without one they stay ``logging`` warnings.
"""
from __future__ import annotations

import logging

from ..context import NodeStatus
from .mesh import mesh_for_statuses

__all__ = ["assign_states", "propagate_statuses", "spec_for_status"]

logger = logging.getLogger(__name__)


def _prime_factors(n):
    out = []
    d = 2
    while n > 1:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1 if d == 2 else 2
    return out


def spec_for_status(status, model_axes, node=None):
    """Lower a NodeStatus to a partition spec over prime-factored model
    axes; returns None when the status is unmappable (the node is then
    replicated).

    Each split dim claims unused axes whose sizes multiply to its split
    count; the duplicate (replica) axis stays unsharded. Dropping a
    *distributed* status is numerically safe but it silently forfeits
    the memory/compute split the user asked for — so it warns, naming
    the node and status.
    """
    if status is None or status.state is None or not status.is_dist():
        return () if status is not None else None
    avail = {name: size for name, size in model_axes.items()}
    spec = []
    for parts in status.state:
        if parts == 1:
            spec.append(None)
            continue
        take = []
        for p in _prime_factors(parts):
            cand = next((n for n, s in avail.items()
                         if s == p and n not in take), None)
            if cand is None:
                from ..analysis.findings import emit
                msg = (f"TP constraint unmappable: "
                       f"{node if node is not None else '<node>'} "
                       f"wants status {status} but the {parts}-way "
                       f"split has no free mesh axis of size {p} in "
                       f"{dict(model_axes)} — the node would run "
                       f"unconstrained (replicated layout, no "
                       f"memory/compute split)")
                if not emit("HT201", "error", msg, node=node):
                    logger.warning("%s", msg)
                return None
            take.append(cand)
        for n in take:
            avail.pop(n, None)
        spec.append(tuple(take) if len(take) > 1 else take[0])
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def propagate_statuses(topo, sweeps=3):
    """Seed statuses from DispatchOp markers and propagate through
    ``deduce_states`` in topo order to a fixpoint.

    Returns the node -> NodeStatus dict (empty when no dispatch present).
    Mesh-independent: callers lower the statuses to specs over whatever
    mesh fits their ranks.
    """
    from ..ops.comm import DispatchGradientOp, DispatchOp
    from ..ops.variable import PlaceholderOp

    dispatch_ops = [n for n in topo if isinstance(n, DispatchOp)]
    if not dispatch_ops:
        return {}

    status = {}
    for d in dispatch_ops:
        st = d.target_status()
        status[d] = st
        # a parameter feeding a dispatch is stored sharded (the TP memory
        # win — reference Variable.reshape_in_mp slices it per device,
        # Variable.py:82-108; the executor keeps only the rank's shard)
        if isinstance(d.inputs[0], PlaceholderOp):
            status[d.inputs[0]] = st

    # forward propagation to a fixpoint: ops without an explicit rule use
    # the elementwise default (Op.deduce_states)
    for _ in range(sweeps):
        changed = False
        for node in topo:
            if node in status and isinstance(
                    node, (DispatchOp, PlaceholderOp)):
                continue
            in_sts = [status.get(i) for i in node.inputs]
            if all(s is None for s in in_sts):
                continue
            st = NodeStatus()
            try:
                node.deduce_states(
                    [NodeStatus.from_other(s) if s is not None else None
                     for s in in_sts], st, False)
            except Exception as e:
                # the node stays replicated (exact), but a broken rule
                # must not be silent: HT202 under an analysis pass
                from ..analysis.findings import emit
                msg = (f"deduce_states failed for {node} "
                       f"({type(e).__name__}: {e}) — conflicting or "
                       f"malformed input partition statuses; the node "
                       f"runs unconstrained")
                if not emit("HT202", "error", msg, node=node):
                    logger.warning("%s", msg)
                continue
            if st.state is None:
                continue
            if st.duplicate is None or st.order is None:
                st.get_default()
            if status.get(node) != st:
                status[node] = st
                changed = True
        if not changed:
            break

    # gradient side: DispatchGradientOp mirrors its forward input's status
    for node in topo:
        if isinstance(node, DispatchGradientOp) and \
                node.forward_input in status:
            status[node] = status[node.forward_input]
    return status


def assign_states(eval_node_list, config):
    """Whole-graph planning for a tensor-parallel session: propagate
    statuses, take the mesh, assign specs.

    Fills ``config.node_status`` (node -> NodeStatus) and
    ``config.node_spec`` (node -> spec); sets ``config.model_axes``,
    and ``config.mesh`` when the session has none with model axes
    (:func:`~.mesh.mesh_for_statuses` over the joined job). Returns
    False, leaving the session as it was, when nothing is split.
    """
    from ..graph.autodiff import find_topo_sort

    topo = find_topo_sort(eval_node_list)
    status = propagate_statuses(topo)
    if not status or not any(
            st is not None and st.is_dist() for st in status.values()):
        # only degenerate (1,1) dispatches: nothing is actually split
        return False

    mesh = config.mesh
    model_axes = {} if mesh is None else {
        a: mesh.shape[a] for a in mesh.axis_names if a != "dp"}
    if not model_axes:
        dp = mesh.shape["dp"] if mesh is not None else 1
        mesh, model_axes = mesh_for_statuses(status.values(), dp=dp)
        config.mesh = mesh
    config.model_axes = model_axes
    config.node_status = status
    config.node_spec = {}
    for node, st in status.items():
        spec = spec_for_status(st, model_axes, node=node)
        if spec is not None:
            config.node_spec[node] = spec
    return True
