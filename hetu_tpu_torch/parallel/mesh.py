"""Rank meshes over ``torch.distributed``.

Counterpart of ``hetu_tpu/parallel/mesh.py``. Where the reference names
the axes of a ``jax.sharding.Mesh`` of devices, the port names the axes
of a grid of process ranks: one process per card (the launcher's
``spmd: true``), each axis slice a process subgroup
(``torch.distributed.new_group``) that the graph's collectives ride.
:func:`mesh_for_statuses` lays the tensor-parallel planner's job out
as ``("dp", "tp0", "tp1", ...)``: the data-parallel axis major, the
prime-factored model axes minor.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Mesh", "build_mesh", "factorized_axes", "mesh_for_statuses"]


class Mesh:
    """A grid of process ranks with named axes (insertion order = major
    -> minor), and this process's subgroup along each axis.

    ``groups`` maps each axis to the process group of the slice that
    holds this ``rank``; :func:`build_mesh` makes them over the default
    process group. A test may pass groups of its own (gloo groups of one
    process's threads)."""

    def __init__(self, axis_sizes, rank, groups):
        self.axis_names = tuple(axis_sizes)
        self.shape = dict(axis_sizes)
        self.rank = int(rank)
        sizes = [self.shape[a] for a in self.axis_names]
        self.devices = np.arange(int(np.prod(sizes))).reshape(sizes)
        missing = [a for a in self.axis_names if a not in groups]
        if missing:
            raise ValueError(f"mesh axes {missing} have no process group")
        self._groups = dict(groups)
        self._comms = {}

    def group(self, axis):
        """The process group of this rank's slice along ``axis``."""
        return self._groups[axis]

    def coord(self, axis):
        """This rank's coordinate along ``axis`` (its rank in the
        axis's group)."""
        sizes = [self.shape[a] for a in self.axis_names]
        return int(np.unravel_index(self.rank, sizes)[
            self.axis_names.index(axis)])

    def comm(self, axis):
        """The :class:`~hetu_tpu_torch.ops.comm.GroupComm` of ``axis``:
        one per axis, so its counters gather every collective on it."""
        if axis not in self._comms:
            from ..ops.comm import GroupComm
            self._comms[axis] = GroupComm(self._groups[axis])
        return self._comms[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def build_mesh(axis_sizes, devices=None):
    """Mesh from an ``{axis_name: size}`` dict over the default process
    group (joined by ``executor.maybe_init_distributed``), ranks
    ``devices`` (default 0..n-1) laid out row-major. Every rank of the
    job must call it, in the same order as its other ``new_group``
    calls: each axis slice's group is made on every rank.

    >>> build_mesh({"dp": 2, "tp": 2})   # 4 processes
    """
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs the job's process group: run one process "
            "per card under the launcher (spmd: true) and join it with "
            "hetu_tpu_torch.executor.maybe_init_distributed()")
    names = list(axis_sizes)
    sizes = [int(axis_sizes[n]) for n in names]
    need = int(np.prod(sizes)) if sizes else 1
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(d) for d in
                                                        devices]
    if len(ranks) < need:
        raise ValueError(f"mesh {axis_sizes} needs {need} ranks, the job "
                         f"has {len(ranks)}")
    grid = np.asarray(ranks[:need]).reshape(sizes)
    me = dist.get_rank()
    groups = {}
    for i, axis in enumerate(names):
        for members in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            members = [int(r) for r in members]
            group = dist.new_group(members)
            if me in members:
                groups[axis] = group
    if me not in grid:
        raise ValueError(f"rank {me} is not in the mesh's ranks "
                         f"{grid.ravel().tolist()}")
    return Mesh(dict(zip(names, sizes)),
                int(np.argwhere(grid.ravel() == me)[0][0]), groups)


def factorized_axes(n, prefix="tp"):
    """Factor n into prime-power axes, largest first — a mesh that can
    express any split whose per-dim factors multiply subsets of these.

    >>> factorized_axes(8) -> {"tp0": 2, "tp1": 2, "tp2": 2}
    """
    axes = {}
    i = 0
    d = 2
    while n > 1:
        while n % d == 0:
            axes[f"{prefix}{i}"] = d
            n //= d
            i += 1
        d += 1 if d == 2 else 2
    return axes


def tp_degree(statuses):
    """The largest number of shards any status splits a tensor into."""
    degree = 1
    for st in statuses:
        if st is not None and st.state is not None:
            degree = max(degree, int(np.prod([s for s in st.state])))
    return degree


def mesh_for_statuses(statuses, dp=1, devices=None):
    """Build a mesh able to express every NodeStatus in ``statuses``
    over the job's ranks (reference mesh.py:75-96).

    The model axes come from prime-factorizing the max TP degree; a
    leading "dp" axis carries data parallelism when ``dp`` > 1. The
    job (``devices``, default every rank of the default process group)
    must hold exactly dp × the TP degree ranks. Returns (mesh,
    model_axes) where model_axes is the {name: size} dict of the TP
    axes (used by the planner's spec assignment)."""
    import torch.distributed as dist
    model_axes = factorized_axes(tp_degree(statuses))
    axes = {}
    if dp > 1:
        axes["dp"] = dp
    axes.update(model_axes)
    need = int(np.prod(list(axes.values()))) if axes else 1
    world = (len(devices) if devices is not None
             else dist.get_world_size() if dist.is_initialized() else 1)
    if world != need:
        raise ValueError(
            f"the tensor-parallel plan {axes} needs {need} ranks, the job "
            f"has {world}: run dp x tp processes under the launcher's "
            f"spmd: true (or pass mesh= a Mesh of your own groups)")
    return build_mesh(axes, devices), model_axes
