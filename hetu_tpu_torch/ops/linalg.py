"""Matrix multiplication (counterpart of ``hetu_tpu/ops/linalg.py``;
reference: gpu_ops/MatrixMult.py). The products stay ``torch.matmul``
(cuBLAS on the card): the JAX package leaves them to XLA, outside any
Pallas kernel."""
from __future__ import annotations

import torch

from ..graph.node import Op

__all__ = ["matmul_op", "batch_matmul_op"]


class MatMulOp(Op):
    def __init__(self, node_A, node_B, trans_A=False, trans_B=False,
                 ctx=None):
        super().__init__(MatMulOp, [node_A, node_B], ctx)
        self.matmul_attr_trans_A = trans_A
        self.matmul_attr_trans_B = trans_B

    def compute(self, input_vals, ectx):
        a, b = input_vals
        if self.matmul_attr_trans_A:
            a = a.T
        if self.matmul_attr_trans_B:
            b = b.T
        return torch.matmul(a, b)

    def gradient(self, output_grad):
        tA, tB = self.matmul_attr_trans_A, self.matmul_attr_trans_B
        A, B = self.inputs
        # the four-case transpose table (reference MatrixMult.py:45-76)
        if not tA and not tB:
            dA = matmul_op(output_grad, B, False, True, ctx=self.raw_ctx)
            dB = matmul_op(A, output_grad, True, False, ctx=self.raw_ctx)
        elif tA and not tB:
            dA = matmul_op(B, output_grad, False, True, ctx=self.raw_ctx)
            dB = matmul_op(A, output_grad, False, False, ctx=self.raw_ctx)
        elif not tA and tB:
            dA = matmul_op(output_grad, B, False, False, ctx=self.raw_ctx)
            dB = matmul_op(output_grad, A, True, False, ctx=self.raw_ctx)
        else:
            dA = matmul_op(B, output_grad, True, True, ctx=self.raw_ctx)
            dB = matmul_op(output_grad, A, True, True, ctx=self.raw_ctx)
        return [dA, dB]

    def infer_shape(self, input_shapes):
        a, b = input_shapes
        m = a[1] if self.matmul_attr_trans_A else a[0]
        ka = a[0] if self.matmul_attr_trans_A else a[1]
        kb = b[1] if self.matmul_attr_trans_B else b[0]
        n = b[0] if self.matmul_attr_trans_B else b[1]
        if ka != kb:
            raise ValueError(f"matmul contraction mismatch {a} x {b}")
        return (m, n)

    def deduce_states(self, input_statuses, status, deduce_order):
        """Propagate partition state through the matmul.

        Logical dims: A=(m,k) B=(k,n) C=(m,n) after accounting for
        transposes. Row split of A -> row split of C; col split of B ->
        col split of C; matching k-splits contract into the replica
        (duplicate) axis: their partial products are all-reduced
        (:mod:`~hetu_tpu_torch.parallel.tensor_parallel`).
        """
        lA, lB = input_statuses
        tA, tB = self.matmul_attr_trans_A, self.matmul_attr_trans_B

        def dims(st, trans):
            if st is None or st.state is None:
                return None, None
            s = st.state + (1,) * (2 - len(st.state))
            return (s[1], s[0]) if trans else (s[0], s[1])

        a_row, a_col = dims(lA, tA)   # m, k
        b_row, b_col = dims(lB, tB)   # k, n
        if a_row is None and b_row is None:
            return
        m = a_row if a_row is not None else 1
        n = b_col if b_col is not None else 1
        k = a_col if a_col is not None else (b_row or 1)
        if not deduce_order:
            status.set_state((m, n))
            dup = max(lA.duplicate or 1 if lA else 1,
                      lB.duplicate or 1 if lB else 1) * (k or 1)
            order = (-1, 0, 1)
            status.set_attr(dup, order)


class BatchMatMulOp(Op):
    """Products over the two trailing dims, batched over the leading
    ones (reference BatchMatrixMult.py); ``trans_A`` / ``trans_B`` swap
    an operand's trailing dims."""

    def __init__(self, node_A, node_B, trans_A=False, trans_B=False,
                 ctx=None):
        super().__init__(BatchMatMulOp, [node_A, node_B], ctx)
        self.trans_A = trans_A
        self.trans_B = trans_B

    def compute(self, input_vals, ectx):
        a, b = input_vals
        if self.trans_A:
            a = a.transpose(-1, -2)
        if self.trans_B:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    def gradient(self, output_grad):
        tA, tB = self.trans_A, self.trans_B
        A, B = self.inputs
        # MatMulOp's transpose table over the trailing dims
        if not tA and not tB:
            dA = batch_matmul_op(output_grad, B, False, True, ctx=self.raw_ctx)
            dB = batch_matmul_op(A, output_grad, True, False, ctx=self.raw_ctx)
        elif tA and not tB:
            dA = batch_matmul_op(B, output_grad, False, True, ctx=self.raw_ctx)
            dB = batch_matmul_op(A, output_grad, False, False,
                                 ctx=self.raw_ctx)
        elif not tA and tB:
            dA = batch_matmul_op(output_grad, B, False, False,
                                 ctx=self.raw_ctx)
            dB = batch_matmul_op(output_grad, A, True, False, ctx=self.raw_ctx)
        else:
            dA = batch_matmul_op(B, output_grad, True, True, ctx=self.raw_ctx)
            dB = batch_matmul_op(output_grad, A, True, True, ctx=self.raw_ctx)
        return [dA, dB]

    def infer_shape(self, input_shapes):
        a, b = list(input_shapes[0]), list(input_shapes[1])
        if self.trans_A:
            a[-1], a[-2] = a[-2], a[-1]
        if self.trans_B:
            b[-1], b[-2] = b[-2], b[-1]
        if a[-1] != b[-2] or a[:-2] != b[:-2]:
            raise ValueError(f"batch matmul mismatch {a} x {b}")
        return tuple(a[:-1]) + (b[-1],)

    def deduce_states(self, input_statuses, status, deduce_order):
        """Batch dims pass through; m from A, n from B, matching k-splits
        contract into the duplicate axis (reference BatchMatrixMult.py's
        per-dim table, same shape algebra as MatMulOp over trailing dims).
        """
        lA, lB = input_statuses
        tA, tB = self.trans_A, self.trans_B

        def trail(st, trans):
            if st is None or st.state is None or len(st.state) < 2:
                return None, None, ()
            s = st.state
            batch = s[:-2]
            r, c = s[-2], s[-1]
            return ((c, r) if trans else (r, c)) + (batch,)

        a_row, a_col, a_batch = trail(lA, tA)
        b_row, b_col, b_batch = trail(lB, tB)
        if a_row is None and b_row is None:
            return
        batch = a_batch if a_batch else b_batch
        m = a_row if a_row is not None else 1
        n = b_col if b_col is not None else 1
        k = a_col if a_col is not None else (b_row or 1)
        if not deduce_order:
            status.set_state(tuple(batch) + (m, n))
            dup = max(lA.duplicate or 1 if lA else 1,
                      lB.duplicate or 1 if lB else 1) * (k or 1)
            status.set_attr(dup, (-1,) + tuple(range(len(batch) + 2)))


def matmul_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    return MatMulOp(node_A, node_B, trans_A, trans_B, ctx=ctx)


def batch_matmul_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    return BatchMatMulOp(node_A, node_B, trans_A, trans_B, ctx=ctx)
