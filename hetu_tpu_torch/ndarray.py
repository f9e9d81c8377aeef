"""Array and device layer of the port.

Counterpart of ``hetu_tpu/ndarray.py``: a :class:`DLContext` names a
logical device (``cpu`` or ``gpu``, the reference's own kinds) and
resolves to a ``torch.device``; an :class:`NDArray` is the executor's
boundary type around a torch tensor; :class:`IndexedSlices` is the
sparse gradient of an embedding lookup.
"""
from __future__ import annotations

import torch

from .device import resolve_device

__all__ = ["DLContext", "cpu", "gpu", "NDArray", "IndexedSlices"]


class DLContext:
    """A logical device: (hostname, kind, device_id), kind ``cpu`` or
    ``gpu`` (reference ndarray.py:17)."""

    __slots__ = ("hostname", "kind", "device_id")

    def __init__(self, kind, device_id=0, hostname="localhost"):
        if kind not in ("cpu", "gpu"):
            raise ValueError(f"unknown device kind {kind!r}")
        self.kind = kind
        self.device_id = int(device_id)
        self.hostname = hostname

    def torch_device(self):
        """The ``torch.device`` this context names; ``gpu`` without CUDA
        raises (:func:`~hetu_tpu_torch.device.resolve_device`)."""
        if self.kind == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self.device_id}")

    def __eq__(self, other):
        return (isinstance(other, DLContext)
                and (self.hostname, self.kind, self.device_id)
                == (other.hostname, other.kind, other.device_id))

    def __hash__(self):
        return hash((self.hostname, self.kind, self.device_id))

    def __repr__(self):
        return f"{self.kind}:{self.device_id}"


def cpu(dev_id=0):
    return DLContext("cpu", dev_id)


def gpu(dev_id=0):
    return DLContext("gpu", dev_id)


class NDArray:
    """A torch tensor plus its logical context: what ``Executor.run``
    returns."""

    __slots__ = ("_value", "ctx")

    def __init__(self, value, ctx=None):
        self._value = value
        self.ctx = ctx if ctx is not None else cpu(0)

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def tensor(self):
        return self._value

    def asnumpy(self):
        """A host numpy copy; bfloat16 comes back as float32 (numpy has
        no bfloat16)."""
        t = self._value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __repr__(self):
        return f"NDArray(shape={self.shape}, dtype={self.dtype}, ctx={self.ctx})"


class IndexedSlices:
    """Sparse gradient of an embedding lookup: ``values[..., dim]`` for
    the rows ``indices[...]`` of a ``dense_shape`` table (reference
    ndarray.py:482)."""

    __slots__ = ("indices", "values", "dense_shape")

    def __init__(self, indices=None, values=None, dense_shape=None):
        self.indices = indices
        self.values = values
        self.dense_shape = dense_shape

    def get_dense_rows(self):
        return self.values.reshape(-1, self.dense_shape[-1])

    def get_flat_indices(self):
        return self.indices.reshape(-1)

    def dedup(self):
        """(unique row indices, summed rows): duplicate indices merged so
        an optimizer applies each row once. Unlike the reference, which
        pads to a static size for ``jit``, the result has exactly the
        unique rows."""
        uniq, inv = torch.unique(self.get_flat_indices(),
                                 return_inverse=True)
        rows = self.get_dense_rows()
        summed = torch.zeros(uniq.shape[0], rows.shape[1], dtype=rows.dtype,
                             device=rows.device).index_add_(0, inv, rows)
        return uniq, summed

    def to_dense(self):
        rows = self.get_dense_rows()
        return torch.zeros(self.dense_shape, dtype=rows.dtype,
                           device=rows.device).index_add_(
            0, self.get_flat_indices(), rows)
