"""CSR sparse matmul ops (counterpart of ``hetu_tpu/ops/sparse.py``;
reference: gpu_ops/CuSparse.py, src/ops/CuSparseCsrmm.cu).

CSR x dense is computed as the JAX package computes it: gather the
dense rows each entry names, scale them by the entry's value, and sum
them per row with a sorted segment-sum (``torch.segment_reduce`` over
the row pointer, which adds a segment's rows in their order, so the
result does not depend on the device's scheduling). The same code runs
on the CPU and on the card. A row may hold one column several times —
the sampled subgraphs pad their last row with zero-valued column-0
entries — and each occurrence is summed. The transposed product (every
csrmm backward) uses the copy of A^T the ingest made
(:class:`~hetu_tpu_torch.ndarray.CSRValue`); a hand-built CSRValue
without it scatter-adds by column instead.

The gather holds an [nnz, F] intermediate (1.39 GB at OGB-arxiv's
1,354,709 entries and F=256, f32). ``distgcn_15d_op`` needs the
multi-GPU port's device mesh and raises until it exists.
"""
from __future__ import annotations

import torch

from ..graph.node import Op

__all__ = ["csrmv_op", "csrmm_op", "distgcn_15d_op", "CsrmmOp", "CsrmvOp"]


def _row_ids(sp):
    """The row of each entry: made at ingest, else from the row pointer
    (a hand-built CSR)."""
    if sp.row_ids is not None:
        return sp.row_ids
    indptr = sp.indptr.long()
    return torch.repeat_interleave(
        torch.arange(sp.nrow, device=indptr.device), indptr.diff(),
        output_size=int(sp.data.shape[0]))


def _segment_matmul(data, indptr, indices, dense):
    """y[i] = sum over row i's entries e of data[e] * dense[indices[e]],
    the entries of a row contiguous and ``indptr`` their offsets."""
    gathered = dense.index_select(0, indices)
    gathered = gathered * (data[:, None] if gathered.dim() == 2 else data)
    # the CSR is checked at ingest (CSRValue.from_sparse_array): unsafe
    # skips the check's reads back to the host
    return torch.segment_reduce(gathered, "sum", offsets=indptr, axis=0,
                                unsafe=True)


def _scatter_matmul(data, rows, cols, dense, nout):
    """y[cols[e]] += data[e] * dense[rows[e]]: the transposed product
    without A^T's sorted copy."""
    contrib = dense.index_select(0, rows)
    contrib = contrib * (data[:, None] if contrib.dim() == 2 else data)
    out = torch.zeros((nout,) + tuple(contrib.shape[1:]),
                      dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, cols, contrib)


def _csr_product(sp, dense, trans):
    """A @ dense, or A^T @ dense with ``trans``, for a CSRValue A."""
    if not trans:
        return _segment_matmul(sp.data, sp.indptr, sp.indices, dense)
    if sp.t_data is not None:
        return _segment_matmul(sp.t_data, sp.t_indptr, sp.t_indices, dense)
    return _scatter_matmul(sp.data, _row_ids(sp), sp.indices, dense,
                           sp.ncol)


class CsrmmOp(Op):
    """CSR ``node_A`` (fed as an ND_Sparse_Array or a CSRValue) @ dense
    ``node_B``, either transposed."""

    def __init__(self, node_A, node_B, trans_A=False, trans_B=False,
                 ctx=None):
        super().__init__(CsrmmOp, [node_A, node_B], ctx)
        self.trans_A = trans_A
        self.trans_B = trans_B

    def compute(self, input_vals, ectx):
        sp, dense = input_vals
        if self.trans_B:
            dense = dense.t()
        return _csr_product(sp, dense, self.trans_A)

    def gradient(self, output_grad):
        # d/dB is A^T @ dy, transposed again where the forward read B
        # transposed; A is a feed and gets none
        grad_b = csrmm_op(self.inputs[0], output_grad,
                          trans_A=not self.trans_A, ctx=self.raw_ctx)
        if self.trans_B:
            from .shape import transpose_op
            grad_b = transpose_op(grad_b, (1, 0), ctx=self.raw_ctx)
        return [None, grad_b]

    def infer_shape(self, input_shapes):
        a, b = input_shapes
        m = a[1] if self.trans_A else a[0]
        n = b[0] if self.trans_B else b[1]
        return (m, n)


class CsrmvOp(Op):
    """CSR ``node_A`` @ dense vector ``node_B`` (A^T @ it with
    ``trans``)."""

    def __init__(self, node_A, node_B, trans=False, ctx=None):
        super().__init__(CsrmvOp, [node_A, node_B], ctx)
        self.trans = trans

    def compute(self, input_vals, ectx):
        sp, vec = input_vals
        return _csr_product(sp, vec, self.trans)

    def gradient(self, output_grad):
        return [None, csrmv_op(self.inputs[0], output_grad,
                               trans=not self.trans, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        a = input_shapes[0]
        return (a[1],) if self.trans else (a[0],)


def csrmv_op(node_A, node_B, trans=False, ctx=None):
    return CsrmvOp(node_A, node_B, trans=trans, ctx=ctx)


def csrmm_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    return CsrmmOp(node_A, node_B, trans_A=trans_A, trans_B=trans_B, ctx=ctx)


def distgcn_15d_op(node_A, node_H, node_W, need_W=True, ctx=None):
    """The 1.5-D distributed GCN layer of the reference (DistGCN_15d.py)
    over a ("gr", "gc") device mesh: it comes with the multi-GPU port."""
    raise NotImplementedError(
        "distgcn_15d_op needs a ('gr', 'gc') device mesh, which comes with "
        "the multi-GPU port (ROADMAP.md item 11, beside "
        "parallel/distgcn.py); use csrmm_op on one device")
