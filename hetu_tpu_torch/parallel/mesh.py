"""Rank meshes over ``torch.distributed``.

Counterpart of ``hetu_tpu/parallel/mesh.py``. Where the reference names
the axes of a ``jax.sharding.Mesh`` of devices, the port names the axes
of a grid of process ranks: one process per card (the launcher's
``spmd: true``), each axis slice a process subgroup
(``torch.distributed.new_group``) that the graph's collectives ride.
:func:`mesh_for_statuses` lays the tensor-parallel planner's job out
as ``("dp", "tp0", "tp1", ...)``: the data-parallel axis major, the
prime-factored model axes minor. A pipeline stage over several ranks
takes a mesh over those alone (:func:`subset_mesh`, through its
:class:`Job`).
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["Job", "Mesh", "build_mesh", "factorized_axes",
           "mesh_for_statuses", "subset_mesh"]


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


class Job:
    """The worker processes of one job as a pipeline sees them: this
    process's ``rank``, their count ``nprocs``, ``new_group(members)``
    (the process group over a list of ranks, or None on a rank outside
    it) and ``channel()`` (the host channel stage boundaries cross,
    :mod:`.p2p`).

    :meth:`from_env` reads a launcher's job (``HETU_PROC_ID``,
    ``HETU_NUM_PROCS``; groups by ``torch.distributed.new_group``, which
    every rank of the job must call for every group, in one order). A
    test running ranks as threads of one process passes its own (the
    executor's ``pp_options={"job": ...}``): they share one environment,
    and so one rank and one channel."""

    def __init__(self, rank, nprocs, new_group=None, channel=None):
        self.rank = int(rank)
        self.nprocs = int(nprocs)
        self._new_group = new_group
        self._channel = channel

    @classmethod
    def from_env(cls):
        return cls(int(os.environ.get("HETU_PROC_ID", "0")),
                   int(os.environ.get("HETU_NUM_PROCS", "1")))

    def new_group(self, members):
        if self._new_group is not None:
            return self._new_group(list(members))
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                f"a stage over the ranks {list(members)} needs the job's "
                f"process group: run one process a rank under the "
                f"launcher's spmd: true")
        group = dist.new_group(list(members))
        return group if self.rank in members else None

    def channel(self):
        if self._channel is None:
            from .p2p import get_channel
            self._channel = get_channel()
        return self._channel


def subset_mesh(axis_sizes, ranks, job):
    """The mesh of ``axis_sizes`` over ``ranks`` (a subset of the job's,
    laid out row-major) for ``job``'s rank, or None where it is not one
    of them. Every rank of the job calls it for every subset, in one
    order: each axis slice's group is made on every rank, as
    ``torch.distributed.new_group`` needs."""
    names = list(axis_sizes)
    sizes = [int(axis_sizes[n]) for n in names]
    grid = np.asarray(ranks).reshape(sizes)
    groups = {}
    for i, axis in enumerate(names):
        for members in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            members = [int(r) for r in members]
            group = job.new_group(members)
            if job.rank in members:
                groups[axis] = group
    if job.rank not in grid:
        return None
    return Mesh(dict(zip(names, sizes)),
                int(np.argwhere(grid.ravel() == job.rank)[0][0]), groups)


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
    mesh = subset_mesh(dict(zip(names, sizes)), ranks[:need],
                       Job(dist.get_rank(), world))
    if mesh is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh's "
                         f"ranks {ranks[:need]}")
    return mesh


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
