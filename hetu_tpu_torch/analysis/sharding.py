"""Pass 2 — sharding consistency (HT2xx).

Counterpart of ``hetu_tpu/analysis/sharding.py``. Re-runs the planner's
``propagate_statuses`` fixpoint (the propagation
``parallel/planner.py`` lowers dispatch markers with) under the
findings collector, so the failure modes that degrade to a
``logging`` warning at run time become preflight findings with node
provenance:

HT201  distributed status has no mappable mesh axes (the node would
       run replicated — no memory/compute split)                 error
HT202  an op's ``deduce_states`` rule raised (conflicting or
       malformed input statuses)                                 error
HT203  implicit reshard: producer and consumer disagree on
       partition state — the port moves the value between
       layouts with collectives here                             info
HT204  plan wants more ranks than the session runs on            error

HT204 counts ranks, not cards: the port runs a plan's ranks as
processes of a launcher's job (several may share one card) or as
thread ranks of one process, which the session makes one a shard
(:mod:`~hetu_tpu_torch.parallel.local_ranks`). So the count is the
job's world size; outside a job no plan lacks ranks, and the check is
skipped, as it is under ``HETU_PREFLIGHT`` (the launcher machine's
devices say nothing about the fleet's). An explicit ``ndevices`` is
checked as given.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["sharding_pass", "plan_ranks"]


def _bytes_of(shape, itemsize=4):
    if not shape:
        return None
    try:
        return int(np.prod([int(s) for s in shape])) * itemsize
    except (TypeError, ValueError):
        return None


def plan_ranks():
    """The ranks a plan of this process runs on: the launcher job's
    world size (joined, or ``HETU_NUM_PROCS`` before it is), else None
    (outside a job the session makes the thread ranks a plan needs)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    n = int(os.environ.get("HETU_NUM_PROCS", "1"))
    return n if n > 1 else None


def sharding_pass(topo, report, shapes=None, ndevices=None):
    """Validate the TP plan; returns the node -> NodeStatus dict."""
    from .findings import collecting
    from ..ops.comm import DispatchGradientOp, DispatchOp
    from ..parallel.mesh import factorized_axes
    from ..parallel.planner import propagate_statuses, spec_for_status

    with collecting(report):
        status = propagate_statuses(topo)
    dist = {n: st for n, st in status.items()
            if st is not None and st.is_dist()}
    if not dist:
        return status

    # HT204: the plan must fit the ranks it runs on
    if ndevices is None and "HETU_PREFLIGHT" not in os.environ:
        ndevices = plan_ranks()
    if ndevices is not None:
        for node, st in dist.items():
            need = st.device_num
            if need is not None and need > ndevices:
                report.add(
                    "HT204", "error",
                    f"{node.name} wants a {need}-device layout "
                    f"({st}) but only {ndevices} device(s) are "
                    f"attached", node=node)

    # HT201: every distributed status must lower to a partition spec
    # over the mesh the planner would build (spec_for_status emits
    # through the active collector; outside analysis it warns)
    tp_degree = 1
    for st in dist.values():
        tp_degree = max(tp_degree, int(np.prod([s for s in st.state])))
    model_axes = factorized_axes(tp_degree)
    with collecting(report):
        for node, st in dist.items():
            spec_for_status(st, model_axes, node=node)

    # HT203: edges where the producer's state differs from the
    # consumer's — an implicit reshard the port realizes as collectives
    shapes = shapes or {}
    for node, st in status.items():
        if isinstance(node, (DispatchOp, DispatchGradientOp)):
            continue  # explicit repartition markers: resharding is the point
        if st is None or st.state is None:
            continue
        for inp in node.inputs:
            sti = status.get(inp)
            if sti is None or sti.state is None:
                continue
            if not (st.is_dist() or sti.is_dist()):
                continue
            if sti.state != st.state:
                nbytes = _bytes_of(shapes.get(inp))
                est = (f", ~{nbytes / 2 ** 20:.1f} MiB moved per step"
                       if nbytes else "")
                report.add(
                    "HT203", "info",
                    f"implicit reshard on edge {inp.name} -> "
                    f"{node.name}: producer state {sti.state} vs "
                    f"consumer state {st.state}{est} — insert an "
                    f"explicit dispatch if unintended", node=node)
    return status
