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


def matmul_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    return MatMulOp(node_A, node_B, trans_A, trans_B, ctx=ctx)


def batch_matmul_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    return BatchMatMulOp(node_A, node_B, trans_A, trans_B, ctx=ctx)
