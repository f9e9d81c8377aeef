"""Elementwise arithmetic ops.

Counterpart of ``hetu_tpu/ops/basic.py`` (reference parity:
gpu_ops/{AddElewise,AddConst,MultiplyElewise,MultiplyConst,Division,
Opposite,Sqrt,Where,OneHot,MatrixDot}.py), whole. Elementwise ops take
inputs of equal shape (or one of shape ``(1,)``); broadcasting goes
through explicit ``broadcastto_op``, as in the reference. Each gradient
is the reference's graph of ops.

``where_op`` treats any nonzero condition as true, as JAX does: the
Transformer passes integer token ids as the condition.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.node import Op
from ..ndarray import IndexedSlices

__all__ = [
    "add_op", "addbyconst_op", "mul_op", "mul_byconst_op", "div_op",
    "div_const_op", "div_handle_zero_op", "opposite_op", "sqrt_op",
    "rsqrt_op", "where_op", "one_hot_op", "matrix_dot_op", "power_op",
    "exp_op", "log_op", "abs_op", "erf_op", "cast_op", "clip_op",
    "clip_mask_op",
]


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


class DivOp(Op):
    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(DivOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        return input_vals[0] / input_vals[1]

    def gradient(self, output_grad):
        # d(a/b)/da = 1/b ; d(a/b)/db = -a/b^2
        grad_a = div_op(output_grad, self.inputs[1], ctx=self.raw_ctx)
        grad_b = opposite_op(
            div_op(mul_op(output_grad, self.inputs[0]),
                   mul_op(self.inputs[1], self.inputs[1])),
            ctx=self.raw_ctx)
        return [grad_a, grad_b]

    def infer_shape(self, input_shapes):
        return _elementwise_shape("div", *input_shapes)


class DivConstOp(Op):
    """const / node (reference Division.py DivConstOp)."""

    def __init__(self, const_val, node_A, ctx=None):
        super().__init__(DivConstOp, [node_A], ctx)
        self.const_attr = const_val

    def compute(self, input_vals, ectx):
        return self.const_attr / input_vals[0]

    def gradient(self, output_grad):
        return [opposite_op(
            div_op(mul_byconst_op(output_grad, self.const_attr),
                   mul_op(self.inputs[0], self.inputs[0])),
            ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class DivHandleZeroOp(Op):
    """a / b with x / 0 := 0."""

    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(DivHandleZeroOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        a, b = input_vals
        zero = b == 0
        return torch.where(zero, torch.zeros_like(a),
                           a / torch.where(zero, torch.ones_like(b), b))

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class _UnaryOp(Op):
    """An elementwise op of one input: ``fn`` forward, ``grad(op, adjoint)``
    the reference's gradient graph."""

    fn = None

    def __init__(self, node_A, ctx=None):
        super().__init__(type(self), [node_A], ctx)

    def compute(self, input_vals, ectx):
        return type(self).fn(input_vals[0])

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class SqrtOp(_UnaryOp):
    fn = torch.sqrt

    def gradient(self, output_grad):
        # d sqrt(x) = 0.5 / sqrt(x)
        return [mul_op(output_grad,
                       mul_byconst_op(rsqrt_op(self.inputs[0]), 0.5),
                       ctx=self.raw_ctx)]


class ReciprocalSqrtOp(_UnaryOp):
    # 1 / sqrt(x), rounded as the reference's reciprocal(sqrt(x))
    fn = staticmethod(lambda x: torch.reciprocal(torch.sqrt(x)))

    def gradient(self, output_grad):
        # d x^{-1/2} = -1/2 * rsqrt(x) / x
        x = self.inputs[0]
        g = mul_byconst_op(div_op(rsqrt_op(x), x), -0.5)
        return [mul_op(output_grad, g, ctx=self.raw_ctx)]


class ErfOp(_UnaryOp):
    """Gauss error function (ONNX Erf)."""

    fn = torch.erf

    def gradient(self, output_grad):
        # d erf(x) = 2/sqrt(pi) * exp(-x^2)
        x = self.inputs[0]
        g = mul_byconst_op(exp_op(opposite_op(mul_op(x, x))),
                           2.0 / np.sqrt(np.pi))
        return [mul_op(output_grad, g, ctx=self.raw_ctx)]


class ExpOp(_UnaryOp):
    fn = torch.exp

    def gradient(self, output_grad):
        return [mul_op(output_grad, self, ctx=self.raw_ctx)]


class LogOp(_UnaryOp):
    fn = torch.log

    def gradient(self, output_grad):
        return [div_op(output_grad, self.inputs[0], ctx=self.raw_ctx)]


class AbsOp(_UnaryOp):
    fn = torch.abs

    def gradient(self, output_grad):
        from .activations import sign_op
        return [mul_op(output_grad, sign_op(self.inputs[0]),
                       ctx=self.raw_ctx)]


class PowerOp(Op):
    def __init__(self, node_A, p, ctx=None):
        super().__init__(PowerOp, [node_A], ctx)
        self.p = p

    def compute(self, input_vals, ectx):
        return torch.pow(input_vals[0], self.p)

    def gradient(self, output_grad):
        return [mul_op(output_grad,
                       mul_byconst_op(power_op(self.inputs[0], self.p - 1),
                                      self.p),
                       ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class WhereOp(Op):
    """``cond ? a : b`` with any nonzero ``cond`` (of any dtype) true."""

    def __init__(self, cond, node_A, node_B, ctx=None):
        super().__init__(WhereOp, [cond, node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        cond, a, b = input_vals
        return torch.where(cond != 0, a, b)

    def gradient(self, output_grad):
        zero = mul_byconst_op(output_grad, 0.0)
        return [None,
                where_op(self.inputs[0], output_grad, zero,
                         ctx=self.raw_ctx),
                where_op(self.inputs[0], zero, output_grad,
                         ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[1]


class OneHotOp(Op):
    """f32 one-hot rows; an id outside ``[0, num_classes)`` gives a row
    of zeros, as ``jax.nn.one_hot`` does."""

    def __init__(self, node, num_classes, ctx=None):
        super().__init__(OneHotOp, [node], ctx)
        self.num_classes = num_classes

    def compute(self, input_vals, ectx):
        ids = input_vals[0].to(torch.int32).unsqueeze(-1)
        classes = torch.arange(self.num_classes, dtype=torch.int32,
                               device=ids.device)
        return (ids == classes).to(torch.float32)

    def gradient(self, output_grad):
        return [None]

    def infer_shape(self, input_shapes):
        return tuple(input_shapes[0]) + (self.num_classes,)


class MatrixDotOp(Op):
    """The reference's MatrixDot: the elementwise product (``axes`` is
    kept for its signature)."""

    def __init__(self, node_A, node_B, axes=0, ctx=None):
        super().__init__(MatrixDotOp, [node_A, node_B], ctx)
        self.axes = axes

    def compute(self, input_vals, ectx):
        return input_vals[0] * input_vals[1]

    def gradient(self, output_grad):
        return [mul_op(output_grad, self.inputs[1], ctx=self.raw_ctx),
                mul_op(output_grad, self.inputs[0], ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class CastOp(Op):
    """Dtype cast (ONNX Cast): ``dtype`` a numpy or torch dtype. The
    gradient passes through a cast to a floating dtype; a cast to an
    integer or bool dtype contributes zeros."""

    def __init__(self, node_A, dtype, ctx=None):
        super().__init__(CastOp, [node_A], ctx)
        self.dtype = _torch_dtype(dtype)

    def compute(self, input_vals, ectx):
        return input_vals[0].to(self.dtype)

    def gradient(self, output_grad):
        if not (self.dtype.is_floating_point or self.dtype.is_complex):
            from .shape import zeroslike_op
            return [zeroslike_op(self.inputs[0], ctx=self.raw_ctx)]
        return [output_grad]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class ClipOp(Op):
    """Clamp to [min_val, max_val], either bound None for none; the
    gradient is masked to where the input lies within the bounds (ONNX
    Clip)."""

    def __init__(self, node_A, min_val=None, max_val=None, ctx=None):
        super().__init__(ClipOp, [node_A], ctx)
        self.min_val = min_val
        self.max_val = max_val

    def compute(self, input_vals, ectx):
        if self.min_val is None and self.max_val is None:
            return input_vals[0]
        return torch.clamp(input_vals[0], self.min_val, self.max_val)

    def gradient(self, output_grad):
        mask = clip_mask_op(self.inputs[0], self.min_val, self.max_val,
                            ctx=self.raw_ctx)
        return [mul_op(output_grad, mask, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class ClipMaskOp(Op):
    def __init__(self, node_A, min_val, max_val, ctx=None):
        super().__init__(ClipMaskOp, [node_A], ctx)
        self.min_val = min_val
        self.max_val = max_val

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        mask = torch.ones_like(x)
        if self.min_val is not None:
            mask = mask * (x >= self.min_val)
        if self.max_val is not None:
            mask = mask * (x <= self.max_val)
        return mask

    def gradient(self, output_grad):
        raise NotImplementedError

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


def div_op(node_A, node_B, ctx=None):
    return DivOp(node_A, node_B, ctx=ctx)


def div_const_op(const_val, node_A, ctx=None):
    return DivConstOp(const_val, node_A, ctx=ctx)


def div_handle_zero_op(node_A, node_B, ctx=None):
    return DivHandleZeroOp(node_A, node_B, ctx=ctx)


def sqrt_op(node, ctx=None):
    return SqrtOp(node, ctx=ctx)


def rsqrt_op(node, ctx=None):
    return ReciprocalSqrtOp(node, ctx=ctx)


def erf_op(node, ctx=None):
    return ErfOp(node, ctx=ctx)


def exp_op(node, ctx=None):
    return ExpOp(node, ctx=ctx)


def log_op(node, ctx=None):
    return LogOp(node, ctx=ctx)


def abs_op(node, ctx=None):
    return AbsOp(node, ctx=ctx)


def power_op(node, p, ctx=None):
    return PowerOp(node, p, ctx=ctx)


def where_op(cond, node_A, node_B, ctx=None):
    return WhereOp(cond, node_A, node_B, ctx=ctx)


def one_hot_op(node, num_classes, ctx=None):
    return OneHotOp(node, num_classes, ctx=ctx)


def matrix_dot_op(node_A, node_B, axes=0, ctx=None):
    return MatrixDotOp(node_A, node_B, axes=axes, ctx=ctx)


def cast_op(node, dtype, ctx=None):
    return CastOp(node, dtype, ctx=ctx)


def clip_op(node, min_val=None, max_val=None, ctx=None):
    return ClipOp(node, min_val=min_val, max_val=max_val, ctx=ctx)


def clip_mask_op(node, min_val, max_val, ctx=None):
    return ClipMaskOp(node, min_val, max_val, ctx=ctx)
