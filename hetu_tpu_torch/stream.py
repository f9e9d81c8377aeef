"""Streams and events (counterpart of ``hetu_tpu/stream.py``; reference:
python/hetu/stream.py).

The port computes on one CUDA stream per device, PyTorch's current one,
as the JAX package dispatches to one queue: a :class:`Stream` is a
named lane (comp, h2d, d2h, ...) that keeps the reference's API and
starts no stream of its own. An :class:`Event` marks a value: on the
card ``record`` puts a ``torch.cuda.Event`` on the current stream after
the work queued so far, and ``sync()`` returns once that work — the
value — is done. A value on the CPU is computed when it exists, so its
``sync()`` returns at once. :class:`PSEvent` and :class:`CSEvent` keep
the reference's waits on a parameter-server request and an embedding
cache's timestamp.
"""
from __future__ import annotations

import torch

__all__ = ["Stream", "Event", "PSEvent", "CSEvent", "create_stream_handle",
           "create_event_handle"]


def _tensor_of(value):
    """The tensor behind ``value`` (a tensor or an NDArray), else None."""
    if isinstance(value, torch.Tensor):
        return value
    tensor = getattr(value, "tensor", None)
    return tensor if isinstance(tensor, torch.Tensor) else None


class Event:
    """Completion marker of a node's output (reference stream.py:38)."""

    def __init__(self, node_name=""):
        self.node_name = node_name
        self._event = None

    def record(self, value=None, stream=None):
        """Mark ``value``: it is done when the work queued on its
        device's current stream so far is. ``stream`` (a :class:`Stream`)
        only names the lane."""
        tensor = _tensor_of(value)
        if tensor is not None and tensor.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))
        else:
            self._event = None

    def update(self):
        pass

    def sync(self):
        """Return once the recorded value is computed."""
        if self._event is not None:
            self._event.synchronize()


class Stream:
    """A named lane of work (the reference's comp / h2d / d2h / nccl /
    p2p streams); ``sync()`` waits for the last value recorded on it."""

    def __init__(self, name="comp"):
        self.name = name
        self._last = Event(name)

    def record(self, value):
        self._last.record(value, self)
        return value

    def sync(self):
        self._last.sync()


class PSEvent(Event):
    """Waits on the parameter-server request outstanding for this node
    (reference stream.py:67: ``comm.Wait(node_id)``)."""

    def __init__(self, comm, node_name=""):
        super().__init__(node_name)
        self.comm = comm

    def sync(self):
        if self.comm is not None:
            self.comm.wait(self.node_name)


class CSEvent(Event):
    """Waits for an embedding cache to reach the timestamp ``ts``
    (reference stream.py:85); ``ts`` < 0 means nothing to wait for."""

    def __init__(self, cache, node_name=""):
        super().__init__(node_name)
        self.cache = cache
        self.ts = -1

    def sync(self):
        if self.cache is not None and self.ts >= 0:
            self.cache.wait(self.ts)


def create_stream_handle(ctx=None, name="comp"):
    return Stream(name)


def create_event_handle(ctx=None, name=""):
    return Event(name)
