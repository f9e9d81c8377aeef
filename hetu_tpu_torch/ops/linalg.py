"""Matrix multiplication (counterpart of ``hetu_tpu/ops/linalg.py``;
reference: gpu_ops/MatrixMult.py). The products stay ``torch.matmul``
(cuBLAS on the card): the JAX package leaves them to XLA, outside any
Pallas kernel. ``batch_matmul_op`` comes with the composed attention
path of the BERT slice."""
from __future__ import annotations

import torch

from ..graph.node import Op

__all__ = ["matmul_op"]


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


def matmul_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    return MatMulOp(node_A, node_B, trans_A, trans_B, ctx=ctx)
