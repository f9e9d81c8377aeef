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
1,354,709 entries and F=256, f32). ``distgcn_15d_op`` is the 1.5-D
distributed layer over a ("gr", "gc") rank mesh
(:mod:`~hetu_tpu_torch.parallel.distgcn`, the same block products).
"""
from __future__ import annotations

import torch

from ..graph.node import Op

__all__ = ["csrmv_op", "csrmm_op", "distgcn_15d_op", "CsrmmOp", "CsrmvOp",
           "DistGCN15dOp"]


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


class DistGCN15dOp(Op):
    """Distributed GCN layer z = A @ (H @ W) over a ("gr", "gc") mesh
    (reference gpu_ops/DistGCN_15d.py DistGCN_15dOp; JAX package
    ops/sparse.py:112-148). ``node_A`` feeds a
    :class:`~hetu_tpu_torch.parallel.distgcn.DistCSR15d` partition; W
    applies on whichever side keeps the SpMM feature dim smaller,
    exactly like the reference's dim check (DistGCN_15d.py:96-117),
    which also fixes the order of the sums. A training step keeps the
    SpMM's output A @ H where W follows it, for dW."""

    def __init__(self, node_A, node_H, node_W, need_W=True, ctx=None):
        super().__init__(DistGCN15dOp, [node_A, node_H, node_W], ctx)
        self.need_W = need_W

    def _w_first(self, h, w):
        return self.need_W and w.shape[1] < h.shape[1]

    def _mesh(self, ectx):
        mesh = getattr(getattr(ectx, "config", None), "mesh", None)
        if mesh is None or "gr" not in mesh.axis_names \
                or "gc" not in mesh.axis_names:
            raise AssertionError(
                "distgcn_15d_op needs a mesh with ('gr', 'gc') axes")
        return mesh

    def compute(self, input_vals, ectx):
        from ..parallel.distgcn import dist_gcn_spmm
        adj, h, w = input_vals
        mesh = self._mesh(ectx)
        if self._w_first(h, w):
            return dist_gcn_spmm(adj, h @ w, mesh)
        z = dist_gcn_spmm(adj, h, mesh)
        if not self.need_W:
            return z
        if ectx.training:
            ectx.cache[("distgcn_z", self.id)] = z
        return z @ w

    def _grad(self, which, adj, h, w, dy, ectx):
        """dH (``which`` 0) or dW (1): the forward's transpose, its ring
        run backwards (the JAX package's ``jax.vjp``, where ppermute
        transposes to the reverse rotation and psum to the identity).
        Where both outputs need the transposed SpMM (W first) it runs
        once a step and ``ectx.cache`` shares it."""
        from ..parallel.distgcn import dist_gcn_spmm, dist_gcn_spmm_t
        mesh = self._mesh(ectx)
        if self._w_first(h, w):
            key = ("distgcn_dhw", self.id)
            if key not in ectx.cache:
                ectx.cache[key] = dist_gcn_spmm_t(adj, dy, mesh)
            dhw = ectx.cache[key]
            return dhw @ w.t() if which == 0 else h.t() @ dhw
        if not self.need_W:
            return dist_gcn_spmm_t(adj, dy, mesh) if which == 0 \
                else torch.zeros_like(w)
        if which == 0:
            return dist_gcn_spmm_t(adj, dy @ w.t(), mesh)
        z = ectx.cache.get(("distgcn_z", self.id))
        if z is None:
            z = dist_gcn_spmm(adj, h, mesh)
        return z.t() @ dy

    def gradient(self, output_grad):
        grads = [_DistGCN15dGradOp(self, output_grad, i,
                                   ctx=self.raw_ctx) for i in range(2)]
        return [None, grads[0], grads[1]]

    def infer_shape(self, input_shapes):
        _, h, w = input_shapes
        return (h[0], w[1]) if self.need_W else tuple(h)


class _DistGCN15dGradOp(Op):
    """dH (``which`` 0) or dW (1) of a :class:`DistGCN15dOp`."""

    def __init__(self, forward_op, output_grad, which, ctx=None):
        super().__init__(_DistGCN15dGradOp,
                         list(forward_op.inputs) + [output_grad], ctx)
        self.forward_op = forward_op
        self.which = which

    def compute(self, input_vals, ectx):
        adj, h, w, dy = input_vals
        return self.forward_op._grad(self.which, adj, h, w, dy, ectx)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[1 + self.which]


def distgcn_15d_op(node_A, node_H, node_W, need_W=True, ctx=None):
    return DistGCN15dOp(node_A, node_H, node_W, need_W=need_W, ctx=ctx)
