"""Elementwise arithmetic ops.

Counterpart of ``hetu_tpu/ops/basic.py`` (reference parity:
gpu_ops/{AddElewise,AddConst,MultiplyElewise,MultiplyConst,Opposite}.py):
the ops the graph API's operators and the autodiff adjoint sums reach.
Elementwise ops take inputs of equal shape; broadcasting goes through
explicit ``broadcastto_op``, as in the reference.
"""
from __future__ import annotations

import torch

from ..graph.node import Op
from ..ndarray import IndexedSlices

__all__ = ["add_op", "addbyconst_op", "mul_op", "mul_byconst_op",
           "opposite_op"]


def _elementwise_shape(what, a, b):
    if tuple(a) == (1,):
        return b
    if tuple(b) == (1,):
        return a
    if tuple(a) != tuple(b):
        raise ValueError(f"{what} shape mismatch {a} vs {b}")
    return a


class AddOp(Op):
    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(AddOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        a, b = input_vals
        # partial adjoints of an embedding table arrive as IndexedSlices
        # (a table looked up twice); keep them sparse
        if isinstance(a, IndexedSlices) and isinstance(b, IndexedSlices):
            return IndexedSlices(
                torch.cat([a.get_flat_indices(), b.get_flat_indices()]),
                torch.cat([a.get_dense_rows(), b.get_dense_rows()]),
                a.dense_shape)
        if isinstance(a, IndexedSlices):
            return a.to_dense() + b
        if isinstance(b, IndexedSlices):
            return a + b.to_dense()
        return a + b

    def gradient(self, output_grad):
        return [output_grad, output_grad]

    def infer_shape(self, input_shapes):
        return _elementwise_shape("add", *input_shapes)


class AddByConstOp(Op):
    def __init__(self, node_A, const_val, ctx=None):
        super().__init__(AddByConstOp, [node_A], ctx)
        self.const_attr = const_val

    def compute(self, input_vals, ectx):
        return input_vals[0] + self.const_attr

    def gradient(self, output_grad):
        return [output_grad]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class MulOp(Op):
    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(MulOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        return input_vals[0] * input_vals[1]

    def gradient(self, output_grad):
        return [mul_op(self.inputs[1], output_grad, ctx=self.raw_ctx),
                mul_op(self.inputs[0], output_grad, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return _elementwise_shape("mul", *input_shapes)


class MulByConstOp(Op):
    def __init__(self, node_A, const_val, ctx=None):
        super().__init__(MulByConstOp, [node_A], ctx)
        self.const_attr = const_val

    def compute(self, input_vals, ectx):
        return input_vals[0] * self.const_attr

    def gradient(self, output_grad):
        return [mul_byconst_op(output_grad, self.const_attr,
                               ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class OppositeOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(OppositeOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return -input_vals[0]

    def gradient(self, output_grad):
        return [opposite_op(output_grad, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


def add_op(node_A, node_B, ctx=None):
    return AddOp(node_A, node_B, ctx=ctx)


def addbyconst_op(node_A, const_val, ctx=None):
    return AddByConstOp(node_A, const_val, ctx=ctx)


def mul_op(node_A, node_B, ctx=None):
    return MulOp(node_A, node_B, ctx=ctx)


def mul_byconst_op(node_A, const_val, ctx=None):
    return MulByConstOp(node_A, const_val, ctx=ctx)


def opposite_op(node_A, ctx=None):
    return OppositeOp(node_A, ctx=ctx)
