"""Activation ops (counterpart of ``hetu_tpu/ops/activations.py``;
reference: gpu_ops/{Relu,Tanh}.py). gelu is the tanh approximation, as
in the JAX package (``jax.nn.gelu(approximate=True)``). Softmax, dropout
and the rest come with the BERT slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graph.node import Op
from .basic import addbyconst_op, mul_op, opposite_op

__all__ = ["relu_op", "relu_gradient_op", "tanh_op", "gelu_op",
           "gelu_gradient_op"]


class ReluOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(ReluOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return torch.clamp_min(input_vals[0], 0)

    def gradient(self, output_grad):
        return [relu_gradient_op(self.inputs[0], output_grad,
                                 ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class ReluGradientOp(Op):
    """grad * (x > 0) (node_A = forward input, node_B = adjoint)."""

    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(ReluGradientOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        x, grad = input_vals
        return grad * (x > 0).to(grad.dtype)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class TanhOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(TanhOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return torch.tanh(input_vals[0])

    def gradient(self, output_grad):
        one_minus_sq = addbyconst_op(opposite_op(mul_op(self, self)), 1.0)
        return [mul_op(output_grad, one_minus_sq, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class GeluOp(Op):
    """tanh-approximation GELU."""

    def __init__(self, node_A, ctx=None):
        super().__init__(GeluOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return F.gelu(input_vals[0], approximate="tanh")

    def gradient(self, output_grad):
        return [gelu_gradient_op(self.inputs[0], output_grad,
                                 ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class GeluGradientOp(Op):
    """The vjp of tanh-gelu at the forward input (node_A) for the adjoint
    (node_B)."""

    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(GeluGradientOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        x, grad = input_vals
        return torch.ops.aten.gelu_backward(grad, x, approximate="tanh")

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


def relu_op(node, ctx=None):
    return ReluOp(node, ctx=ctx)


def relu_gradient_op(node_A, node_B, ctx=None):
    return ReluGradientOp(node_A, node_B, ctx=ctx)


def tanh_op(node, ctx=None):
    return TanhOp(node, ctx=ctx)


def gelu_op(node, ctx=None):
    return GeluOp(node, ctx=ctx)


def gelu_gradient_op(node_A, node_B, ctx=None):
    return GeluGradientOp(node_A, node_B, ctx=ctx)
