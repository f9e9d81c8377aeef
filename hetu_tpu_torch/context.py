"""Device groups and the ``with ht.context(...)`` stack.

Counterpart of ``hetu_tpu/context.py``, the part ``Op.__init__`` and the
single-device executor need: :class:`DeviceGroup` (an ordered set of
:class:`~hetu_tpu_torch.ndarray.DLContext`), :func:`context` and
:func:`get_current_context`. ``NodeStatus`` and the launch-config walk
belong to the parallel modes and wait for them.
"""
from __future__ import annotations

import contextlib
import re

from .ndarray import DLContext

__all__ = ["DeviceGroup", "context", "get_current_context"]


class DeviceGroup:
    """An ordered set of device contexts (reference context.py:7-96).
    Accepts a context, a list of them, or a string like ``"gpu:0"``."""

    def __init__(self, ctxs):
        self._contexts = self.parse_contexts(ctxs)

    @classmethod
    def parse_contexts(cls, ctxs):
        if isinstance(ctxs, DeviceGroup):
            return list(ctxs._contexts)
        if isinstance(ctxs, str):
            ctxs = [c for c in re.split(";|,| +", ctxs.lower()) if c]
        if not isinstance(ctxs, list):
            ctxs = [ctxs]
        return [cls.str2ctx(c) for c in ctxs]

    @staticmethod
    def str2ctx(c):
        if isinstance(c, DLContext):
            return c
        if isinstance(c, str):
            kind, _, idx = c.lower().rpartition(":")
            kind = "gpu" if kind == "cuda" else kind
            return DLContext(kind, int(idx))
        raise ValueError(f"bad context: {c!r}")

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
