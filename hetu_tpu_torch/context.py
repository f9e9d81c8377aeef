"""Device groups, the ``with ht.context(...)`` stack and the launch walk.

Counterpart of ``hetu_tpu/context.py``: :class:`DeviceGroup` (an
ordered set of :class:`~hetu_tpu_torch.ndarray.DLContext` split into
workers — GPUs — and servers — host CPUs, the parameter-server role),
:func:`context`, :func:`get_current_context` and
:func:`get_launch_config_by_traverse_nodes`, which infers each node's
communication strategy (PS where its group has servers and workers,
AllReduce where it has several workers) and the session's mode from
the device groups. ``NodeStatus`` waits for the tensor-parallel
planner (ROADMAP item 11b): the PS strategy reads only the device
groups, and data parallelism one process's worker and the job's process
group (``executor.HetuConfig``).
"""
from __future__ import annotations

import contextlib
import re

from .ndarray import DLContext, is_gpu_ctx

__all__ = ["DeviceGroup", "context", "get_current_context",
           "get_launch_config_by_traverse_nodes"]


class DeviceGroup:
    """An ordered set of device contexts (reference context.py:7-96).
    Accepts a context, a list of them, or a string like ``"gpu:0"`` or
    ``"host:cpu:0"``. GPUs are workers, CPUs are servers; a tuple of
    contexts is one worker whose devices share a model-parallel copy
    (a pipeline refuses it until tensor parallelism, ROADMAP item
    11b)."""

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
