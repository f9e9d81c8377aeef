"""Array and device layer of the port.

Counterpart of ``hetu_tpu/ndarray.py``: a :class:`DLContext` names a
logical device (``cpu`` or ``gpu``, the reference's own kinds) and
resolves to a ``torch.device``; an :class:`NDArray` is the executor's
boundary type around a torch tensor (``array`` / ``empty`` make one,
``copyto`` and the async copies move it); :class:`IndexedSlices` is the
sparse gradient of an embedding lookup; :class:`ND_Sparse_Array` is a
CSR matrix as users feed it (``sparse_array`` builds one from COO) and
:class:`CSRValue` its in-graph form on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["DLContext", "cpu", "gpu", "NDArray", "IndexedSlices", "array",
           "empty", "ND_Sparse_Array", "sparse_array", "CSRValue"]


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

    def copyto(self, target):
        """A copy on ``target``: a :class:`DLContext` gives a new array
        there; an :class:`NDArray` takes the value on its own context
        and is returned (reference ndarray.py:178-184)."""
        if isinstance(target, DLContext):
            return NDArray(self._value.to(target.torch_device(), copy=True),
                           target)
        if not isinstance(target, NDArray):
            raise TypeError(f"copyto needs a DLContext or an NDArray, got "
                            f"{type(target).__name__}")
        target._value = self._value.to(target.ctx.torch_device(), copy=True)
        return target

    def async_h2d(self, source, stream_handle=None, event_handle=None):
        """Take ``source`` (numpy or an NDArray) onto this array's
        context without waiting for the copy; ``event_handle.sync()``
        returns once it has landed. The port computes on one stream
        per device: ``stream_handle`` only names it."""
        if isinstance(source, NDArray):
            source = source._value
        self._value = torch.as_tensor(source).to(self.ctx.torch_device(),
                                                 non_blocking=True)
        if event_handle is not None:
            event_handle.record(self._value)

    def async_d2h(self, source, stream_handle=None, event_handle=None):
        """Take ``source``'s value into host memory without waiting for
        the copy; read it after ``event_handle.sync()``."""
        value = source._value
        if value.is_cuda:
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=True)
            host.copy_(value, non_blocking=True)
            value = host
        self._value = value
        if event_handle is not None:
            event_handle.record(source._value)

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


def array(arr, ctx=None, dtype=np.float32):
    """An NDArray of ``arr`` as ``dtype`` on ``ctx`` (default the host,
    as in the reference, ndarray.py:210)."""
    ctx = ctx if ctx is not None else cpu(0)
    value = torch.from_numpy(np.array(arr, dtype=dtype))
    return NDArray(value.to(ctx.torch_device()), ctx)


def empty(shape, ctx=None, dtype=np.float32):
    """An NDArray of zeros of ``shape`` on ``ctx`` (default the host)."""
    return array(np.zeros(shape, dtype=dtype), ctx=ctx, dtype=dtype)


def _host(v):
    return np.asarray(v.asnumpy() if isinstance(v, NDArray) else v)


class ND_Sparse_Array:
    """A CSR matrix as a user feeds it (reference ndarray.py:229):
    ``data`` [nnz], ``row`` (the indptr, [nrow + 1]) and ``col`` (the
    indices, [nnz]), each an NDArray or a numpy array."""

    __slots__ = ("data", "row", "col", "nrow", "ncol", "ctx")

    def __init__(self, data, row, col, nrow, ncol, ctx=None):
        self.data = data
        self.row = row
        self.col = col
        self.nrow = nrow
        self.ncol = ncol
        self.ctx = ctx if ctx is not None else cpu(0)

    @property
    def shape(self):
        return (self.nrow, self.ncol)

    def asnumpy(self):
        """The dense matrix (duplicate entries summed)."""
        import scipy.sparse as sp
        return sp.csr_matrix(
            (_host(self.data), _host(self.col), _host(self.row)),
            shape=self.shape).toarray()


def sparse_array(values, indices, shape, ctx=None, dtype=np.float32):
    """A CSR ND_Sparse_Array from COO ``values`` at ``indices`` = (rows,
    cols), duplicates summed (reference ndarray.py:255)."""
    import scipy.sparse as sp
    mat = sp.csr_matrix((values, indices), shape=shape, dtype=dtype)
    return ND_Sparse_Array(
        array(mat.data, ctx=ctx, dtype=dtype),
        array(mat.indptr, ctx=ctx, dtype=np.int32),
        array(mat.indices, ctx=ctx, dtype=np.int32),
        shape[0], shape[1], ctx=ctx)


class CSRValue:
    """The in-graph value of a CSR matrix: device tensors ``data``,
    ``indptr``, ``indices`` and the sizes (reference ndarray.py:302).

    Made once at ingest on the host, beside the CSR itself:
    ``row_ids``, the row of each entry (the COO row array), and A^T in
    the same sorted form — ``t_data`` / ``t_indices`` (the entries and
    their rows, sorted by column, stable), ``t_row_ids`` (the sorted
    columns) and ``t_indptr`` (A^T's row pointer). The transposed
    product of every csrmm backward is then a gather and a sorted
    segment-sum too. A hand-built CSRValue may leave them None; the ops
    fall back (``ops/sparse.py``).

    ``shape`` is (nrow, ncol) and ``dtype`` the values': what the
    executor's shape pass and shape key read."""

    __slots__ = ("data", "indptr", "indices", "nrow", "ncol", "row_ids",
                 "t_data", "t_indices", "t_row_ids", "t_indptr")

    def __init__(self, data, indptr, indices, nrow, ncol, row_ids=None,
                 t_data=None, t_indices=None, t_row_ids=None,
                 t_indptr=None):
        self.data = data
        self.indptr = indptr
        self.indices = indices
        self.nrow = nrow
        self.ncol = ncol
        self.row_ids = row_ids
        self.t_data = t_data
        self.t_indices = t_indices
        self.t_row_ids = t_row_ids
        self.t_indptr = t_indptr

    @property
    def shape(self):
        return (self.nrow, self.ncol)

    @property
    def dtype(self):
        return self.data.dtype

    def to(self, device):
        """This value on ``device``: itself where it already lies there."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.data.device == device:
            return self
        return CSRValue(*(v.to(device) if isinstance(v, torch.Tensor) else v
                          for v in (getattr(self, f)
                                    for f in self.__slots__)))

    @classmethod
    def from_sparse_array(cls, sp, device=None):
        """``sp`` (an ND_Sparse_Array) on ``device`` (default ``cuda``),
        after checking it is a well-formed CSR: indptr of nrow + 1
        non-decreasing entries from 0 to nnz, every column in range.
        Duplicate columns in a row are allowed and summed."""
        device = resolve_device(device)
        data = _host(sp.data).astype(np.float32, copy=False)
        indptr = _host(sp.row).astype(np.int32, copy=False)
        indices = _host(sp.col).astype(np.int32, copy=False)
        nrow, ncol = int(sp.nrow), int(sp.ncol)
        if indptr.shape != (nrow + 1,) or indptr[0] != 0 \
                or indptr[-1] != data.shape[0] \
                or indices.shape != data.shape \
                or np.any(np.diff(indptr) < 0):
            raise ValueError(
                f"not a CSR of {nrow} rows: indptr {indptr.shape} from "
                f"{indptr[:1]} to {indptr[-1:]}, {data.shape[0]} values, "
                f"{indices.shape[0]} indices")
        if indices.size and (indices.min() < 0 or indices.max() >= ncol):
            raise ValueError(f"column index out of [0, {ncol}): "
                             f"{indices.min()}..{indices.max()}")
        row_ids = np.repeat(np.arange(nrow, dtype=np.int32),
                            np.diff(indptr))
        perm = np.argsort(indices, kind="stable")
        t_indptr = np.zeros(ncol + 1, np.int32)
        np.cumsum(np.bincount(indices, minlength=ncol), out=t_indptr[1:])

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(dev(data), dev(indptr), dev(indices), nrow, ncol,
                   dev(row_ids), dev(data[perm]), dev(row_ids[perm]),
                   dev(indices[perm]), dev(t_indptr))
