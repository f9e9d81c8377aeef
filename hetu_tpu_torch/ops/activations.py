"""Activation ops (counterpart of ``hetu_tpu/ops/activations.py``;
reference: gpu_ops/{Relu,LeakyRelu,Sigmoid,Tanh,Sign,Softmax,Dropout}.py),
whole. gelu is the tanh approximation, as in the JAX package
(``jax.nn.gelu(approximate=True)``).

Dropout draws its mask from the step's per-op generator
(``ExecContext.generator_for``), and its gradient op draws it again
from the forward op's generator, so both apply one mask without keeping
it between the two. The numbers differ from ``jax.random``'s: tests
check dropout by its properties, and the parity twins run without it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graph.node import Op
from .basic import addbyconst_op, mul_op, opposite_op

__all__ = ["relu_op", "relu_gradient_op", "leaky_relu_op",
           "leaky_relu_gradient_op", "sigmoid_op", "tanh_op", "gelu_op",
           "gelu_gradient_op", "sign_op", "softmax_func", "softmax_op",
           "softmax_gradient_op", "dropout_op", "dropout_gradient_op",
           "dropout2d_op", "dropout2d_gradient_op"]


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


class LeakyReluOp(Op):
    def __init__(self, node_A, alpha, ctx=None):
        super().__init__(LeakyReluOp, [node_A], ctx)
        self.alpha = alpha

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        return torch.where(x > 0, x, self.alpha * x)

    def gradient(self, output_grad):
        return [leaky_relu_gradient_op(self.inputs[0], output_grad,
                                       self.alpha, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class LeakyReluGradientOp(Op):
    """grad where x > 0, else alpha * grad (node_A = forward input,
    node_B = adjoint)."""

    def __init__(self, node_A, node_B, alpha, ctx=None):
        super().__init__(LeakyReluGradientOp, [node_A, node_B], ctx)
        self.alpha = alpha

    def compute(self, input_vals, ectx):
        x, grad = input_vals
        return torch.where(x > 0, grad, self.alpha * grad)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class SignOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(SignOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return torch.sign(input_vals[0])

    def gradient(self, output_grad):
        return [None]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class SigmoidOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(SigmoidOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return torch.sigmoid(input_vals[0])

    def gradient(self, output_grad):
        # y' = y (1 - y), on the graph as in the reference
        one_minus = addbyconst_op(opposite_op(self), 1.0)
        return [mul_op(output_grad, mul_op(self, one_minus),
                       ctx=self.raw_ctx)]

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


class SoftmaxOp(Op):
    """softmax over the last axis."""

    def __init__(self, node_A, ctx=None):
        super().__init__(SoftmaxOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return torch.softmax(input_vals[0], dim=-1)

    def gradient(self, output_grad):
        return [softmax_gradient_op(self, output_grad, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class SoftmaxGradientOp(Op):
    """dx = y * (dy - sum(dy * y, -1, keepdims)) from the forward's output
    y (node_A) and the adjoint dy (node_B)."""

    def __init__(self, forward_node, grad_node, ctx=None):
        super().__init__(SoftmaxGradientOp, [forward_node, grad_node], ctx)

    def compute(self, input_vals, ectx):
        y, dy = input_vals
        return y * (dy - (dy * y).sum(dim=-1, keepdim=True))

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


def _dropout_mask(ectx, op, keep_prob, shape, dtype, per_channel=False):
    """The mask of dropout ``op`` in this step: keep with probability
    ``keep_prob``, kept entries scaled by ``1 / keep_prob``; one decision
    per (N, C) plane for dropout2d. The same (seed, step, op) gives the
    same mask."""
    mask_shape = tuple(shape)
    if per_channel:
        mask_shape = mask_shape[:2] + (1,) * (len(mask_shape) - 2)
    keep = torch.rand(mask_shape, generator=ectx.generator_for(op),
                      device=ectx.device) < keep_prob
    return keep.to(dtype) / keep_prob


class DropoutOp(Op):
    """x * mask in training, x in eval."""

    per_channel = False

    def __init__(self, node_in, keep_prob, ctx=None):
        super().__init__(type(self), [node_in], ctx)
        self.keep_prob = keep_prob

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        if not ectx.training:
            return x
        return x * _dropout_mask(ectx, self, self.keep_prob, x.shape,
                                 x.dtype, self.per_channel)

    def gradient(self, output_grad):
        grad_op = Dropout2dGradientOp if self.per_channel \
            else DropoutGradientOp
        return [grad_op(output_grad, self.keep_prob, self, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class Dropout2dOp(DropoutOp):
    """Dropout of whole (N, C) planes."""

    per_channel = True


class DropoutGradientOp(Op):
    """The adjoint times the forward op's mask, drawn again from the
    forward op's generator (identity in eval)."""

    def __init__(self, node_in, keep_prob, forward_node, ctx=None):
        super().__init__(type(self), [node_in], ctx)
        self.keep_prob = keep_prob
        self.forward_node = forward_node

    def compute(self, input_vals, ectx):
        grad = input_vals[0]
        if not ectx.training:
            return grad
        return grad * _dropout_mask(ectx, self.forward_node, self.keep_prob,
                                    grad.shape, grad.dtype,
                                    self.forward_node.per_channel)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class Dropout2dGradientOp(DropoutGradientOp):
    pass


def relu_op(node, ctx=None):
    return ReluOp(node, ctx=ctx)


def relu_gradient_op(node_A, node_B, ctx=None):
    return ReluGradientOp(node_A, node_B, ctx=ctx)


def leaky_relu_op(node, alpha=0.01, ctx=None):
    return LeakyReluOp(node, alpha, ctx=ctx)


def leaky_relu_gradient_op(node_A, node_B, alpha=0.01, ctx=None):
    return LeakyReluGradientOp(node_A, node_B, alpha, ctx=ctx)


def sign_op(node, ctx=None):
    return SignOp(node, ctx=ctx)


def sigmoid_op(node, ctx=None):
    return SigmoidOp(node, ctx=ctx)


def tanh_op(node, ctx=None):
    return TanhOp(node, ctx=ctx)


def gelu_op(node, ctx=None):
    return GeluOp(node, ctx=ctx)


def gelu_gradient_op(node_A, node_B, ctx=None):
    return GeluGradientOp(node_A, node_B, ctx=ctx)


def softmax_func(node):
    return softmax_op(node)


def softmax_op(node, ctx=None):
    return SoftmaxOp(node, ctx=ctx)


def softmax_gradient_op(forward_node, grad_node, ctx=None):
    return SoftmaxGradientOp(forward_node, grad_node, ctx=ctx)


def dropout_op(node_in, keep_prob, ctx=None):
    return DropoutOp(node_in, keep_prob, ctx=ctx)


def dropout_gradient_op(node_in, keep_prob, forward_node, ctx=None):
    return DropoutGradientOp(node_in, keep_prob, forward_node, ctx=ctx)


def dropout2d_op(node_in, keep_prob, ctx=None):
    return Dropout2dOp(node_in, keep_prob, ctx=ctx)


def dropout2d_gradient_op(node_in, keep_prob, forward_node, ctx=None):
    return Dropout2dGradientOp(node_in, keep_prob, forward_node, ctx=ctx)
