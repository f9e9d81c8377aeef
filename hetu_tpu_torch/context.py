"""Device groups, the ``with ht.context(...)`` stack and the launch walk.

Counterpart of ``hetu_tpu/context.py``: :class:`DeviceGroup` (an
ordered set of :class:`~hetu_tpu_torch.ndarray.DLContext` split into
workers — GPUs — and servers — host CPUs, the parameter-server role),
:func:`context`, :func:`get_current_context` and
:func:`get_launch_config_by_traverse_nodes`, which infers each node's
communication strategy (PS where its group has servers and workers,
AllReduce where it has several workers) and the session's mode from
the device groups, and :class:`NodeStatus`, the partition state the
tensor-parallel planner propagates (:mod:`.parallel.planner`).
"""
from __future__ import annotations

import contextlib
import re

import numpy as np

from .ndarray import DLContext, is_gpu_ctx

__all__ = ["DeviceGroup", "NodeStatus", "context", "get_current_context",
           "get_launch_config_by_traverse_nodes"]


class DeviceGroup:
    """An ordered set of device contexts (reference context.py:7-96).
    Accepts a context, a list of them, or a string like ``"gpu:0"`` or
    ``"host:cpu:0"``. GPUs are workers, CPUs are servers; a tuple of
    contexts is one worker whose devices share a model-parallel copy:
    as a pipeline stage's context it lists the stage's ranks, one a
    device, each the owner of its hostname (``'worker<k>'`` or
    ``HETU_HOSTS``; :mod:`.parallel.pipeline`)."""

    def __init__(self, ctxs):
        self._contexts = self.parse_contexts(ctxs)
        self._workers = [c for c in self._contexts
                         if isinstance(c, tuple) or is_gpu_ctx(c)]
        self._servers = [c for c in self._contexts
                         if not (isinstance(c, tuple) or is_gpu_ctx(c))]

    @classmethod
    def parse_contexts(cls, ctxs):
        if isinstance(ctxs, DeviceGroup):
            return list(ctxs._contexts)
        if isinstance(ctxs, str):
            ctxs = [c for c in re.split(";|,| +", ctxs.lower()) if c]
        if not isinstance(ctxs, list):
            ctxs = [ctxs]
        return [tuple(cls.str2ctx(cc) for cc in c) if isinstance(c, tuple)
                else cls.str2ctx(c) for c in ctxs]

    @staticmethod
    def str2ctx(c):
        if isinstance(c, DLContext):
            return c
        if isinstance(c, str):
            parts = c.lower().split(":")
            if len(parts) not in (2, 3):
                raise ValueError(f"bad context: {c!r}")
            kind = "gpu" if parts[-2] == "cuda" else parts[-2]
            host = parts[0] if len(parts) == 3 else "localhost"
            return DLContext(kind, int(parts[-1]), hostname=host)
        raise ValueError(f"bad context: {c!r}")

    @property
    def worker_num(self):
        return len(self._workers)

    @property
    def server_num(self):
        return len(self._servers)

    @property
    def workers(self):
        return list(self._workers)

    @property
    def servers(self):
        return list(self._servers)

    def flat_workers(self):
        """All worker device contexts, model-parallel tuples flattened."""
        out = []
        for w in self._workers:
            out.extend(w if isinstance(w, tuple) else (w,))
        return out

    def index(self, ctx):
        return self._contexts.index(ctx)

    def get_sorted(self):
        return DeviceGroup(sorted(
            self._contexts,
            key=lambda x: hash(x.hostname) + hash(x.device_id)))

    def __getitem__(self, key):
        return self._contexts[key]

    def __iter__(self):
        return iter(self._contexts)

    def __len__(self):
        return len(self._contexts)

    def __eq__(self, other):
        return isinstance(other, DeviceGroup) and \
            self._contexts == other._contexts

    def __hash__(self):
        return hash(tuple(self._contexts))

    def __repr__(self):
        return "DeviceGroup(" + ", ".join(map(str, self._contexts)) + ")"


_stack = []


def get_current_context():
    return _stack[-1] if _stack else None


@contextlib.contextmanager
def context(ctx):
    group = DeviceGroup(ctx)
    _stack.append(group)
    try:
        yield group
    finally:
        _stack.pop()


class NodeStatus:
    """Partition state of one graph node (reference context.py:116-193).

    * ``state``     — tuple of split counts per tensor dim, e.g. (1, 2)
                      splits dim 1 two ways.
    * ``duplicate`` — number of replicas of each shard.
    * ``order``     — device-order permutation over dims, -1 = replica axis.

    ``to_partition_spec`` names the mesh axis each dim binds (a tuple,
    one entry a dim, trailing unsplit dims dropped); the tensor-parallel
    realization (:mod:`.parallel.tensor_parallel`) lays a node's shards
    out over the rank mesh by it and moves values between layouts with
    ``torch.distributed`` collectives.
    """

    def __init__(self, state=None, duplicate=None, order=None):
        if isinstance(state, dict):
            ndim = max(state) + 1 if state else 0
            state = tuple(state.get(i, 1) for i in range(ndim))
        self._state = tuple(state) if state is not None else None
        self._duplicate = duplicate
        self._order = tuple(order) if order is not None else None
        self._defaulted = False
        self._try_device_num()

    @classmethod
    def from_other(cls, other):
        if other is None:
            return cls(None, None, None)
        return cls(other._state, other._duplicate, other._order)

    # -- accessors ----------------------------------------------------------
    @property
    def state(self):
        return self._state

    @property
    def duplicate(self):
        return self._duplicate

    @property
    def order(self):
        return self._order

    @property
    def device_num(self):
        return self._device_num

    def is_dist(self):
        return not (self._state is None or all(x == 1 for x in self._state))

    def get_default(self):
        self._defaulted = True
        if self._duplicate is None:
            self._duplicate = 1
        if self._order is None:
            self._order = (-1,) + tuple(range(len(self._state)))
        self._try_device_num()
        return self._state, self._duplicate, self._order

    def set_attr(self, duplicate, order):
        if self._defaulted:
            assert self._duplicate == duplicate and self._order == tuple(order)
        else:
            self._duplicate = duplicate
            self._order = tuple(order)
            self._try_device_num()

    def set_state(self, state):
        if isinstance(state, dict):
            ndim = max(state) + 1 if state else 0
            state = tuple(state.get(i, 1) for i in range(ndim))
        self._state = tuple(state)
        self._try_device_num()

    def _try_device_num(self):
        self._device_num = (
            None if self._duplicate is None or self._state is None
            else int(np.prod(self._state, dtype=int)) * self._duplicate)

    def check_devices(self, devices):
        assert self._device_num == len(devices), \
            f"status wants {self._device_num} devices, got {len(devices)}"

    # -- device-index algebra ----------------------------------------------
    def map_dev_to_index(self, global_index):
        """Which shard coordinates the global_index-th device holds."""
        coords = [0] * len(self._state)
        for dim in self._order[::-1]:
            if dim < 0:
                global_index //= self._duplicate
            else:
                coords[dim] = global_index % self._state[dim]
                global_index //= self._state[dim]
        return coords

    def get_loop_sizes(self):
        loop_sizes = [1]
        for dim in self._order[::-1]:
            step = self._duplicate if dim < 0 else self._state[dim]
            loop_sizes.insert(0, loop_sizes[0] * step)
        loop_sizes.pop(0)
        return loop_sizes

    # -- mesh lowering ------------------------------------------------------
    def to_partition_spec(self, mesh_axes=None):
        """The mesh axis of each dim, as the reference's PartitionSpec
        holds them: a tuple with an axis name for a split dim and None
        for an unsplit one, trailing Nones dropped.

        mesh_axes: mapping from tensor dim -> mesh axis name. By default
        the i-th split dim (in order) binds to axis ``'mp%d' % k``.
        """
        if self._state is None or not self.is_dist():
            return ()
        spec = []
        k = 0
        for dim, parts in enumerate(self._state):
            if parts > 1:
                if mesh_axes and dim in mesh_axes:
                    spec.append(mesh_axes[dim])
                else:
                    spec.append(f"mp{k}")
                k += 1
            else:
                spec.append(None)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    def mesh_shape(self):
        """(axis_names, sizes) for building a Mesh that fits this status."""
        names, sizes = [], []
        k = 0
        for parts in self._state or ():
            if parts > 1:
                names.append(f"mp{k}")
                sizes.append(parts)
                k += 1
        if self._duplicate and self._duplicate > 1:
            names.append("dup")
            sizes.append(self._duplicate)
        return names, sizes

    def __eq__(self, other):
        return (isinstance(other, NodeStatus)
                and self._state == other._state
                and self._duplicate == other._duplicate
                and self._order == other._order)

    def __hash__(self):
        return hash((self._state, self._duplicate, self._order))

    def __repr__(self):
        return (f"NodeStatus(state={self._state}, "
                f"duplicate={self._duplicate}, order={self._order})")


def get_launch_config_by_traverse_nodes(node_list, default_ctx):
    """``(launch_mpi, launch_ps, node_strategy, devices)`` (reference
    context.py:326): a node whose group has servers and workers uses
    PS, a node on more than one worker AllReduce, any other none; the
    session launches PS if its own group or any node does, and
    AllReduce likewise."""
    node_strategy = {}
    devices = set(default_ctx)
    launch_ps = default_ctx.server_num > 0 and default_ctx.worker_num > 0
    launch_mpi = (not launch_ps) and default_ctx.worker_num > 1
    nrank = default_ctx.worker_num
    stack = list(node_list)
    while stack:
        node = stack.pop()
        if node in node_strategy:
            continue
        strategy = None
        raw = node.raw_ctx
        if raw is not None and raw.server_num > 0 and raw.worker_num > 0:
            strategy = "PS"
        elif raw is not None and raw.worker_num > 1:
            strategy = "AllReduce"
        node_strategy[node] = strategy
        if raw is not None:
            devices.update(raw)
            if nrank and raw.worker_num not in (0, nrank):
                raise ValueError(
                    f"inconsistent worker counts: {node.name} is on "
                    f"{raw.worker_num} workers, the session on {nrank}")
        stack.extend(node.inputs)
    launch_ps = launch_ps or any(s == "PS" for s in node_strategy.values())
    launch_mpi = launch_mpi or any(
        s == "AllReduce" for s in node_strategy.values())
    return launch_mpi, launch_ps, node_strategy, devices
