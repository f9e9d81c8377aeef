"""Elementwise arithmetic ops.

Counterpart of ``hetu_tpu/ops/basic.py`` (reference parity:
gpu_ops/{AddElewise,AddConst,MultiplyElewise,MultiplyConst,Division,
Opposite,Sqrt,Where,OneHot,MatrixDot}.py), whole. Elementwise ops take
inputs of equal shape (or one of shape ``(1,)``); broadcasting goes
through explicit ``broadcastto_op``, as in the reference. Each gradient
is the reference's graph of ops.

``where_op`` treats any nonzero condition as true, as JAX does: the
Transformer passes integer token ids as the condition.

Each op with known value semantics also defines ``infer_range``, its
interval rule for the numerics verifier (``analysis/numerics.py``).
"""
from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# interval semantics (the HT8xx numerics verifier's transfer protocol)
# ---------------------------------------------------------------------------
# ``infer_range(input_ranges, input_shapes=None)`` returns a (lo, hi)
# float pair bounding every element of the output given per-input
# (lo, hi) bounds (None = unknown), beside ``infer_shape``.
# analysis/numerics.py walks the topo order through it; ops without it
# fall back to the shape-aware table there (matmul, conv, reductions).

def _iv_sorted(lo, hi):
    return (min(lo, hi), max(lo, hi))


def _mul_ep(x, y):
    """Endpoint product with interval arithmetic's 0 * inf := 0: a plain
    product gives NaN there, and a (nan, nan) interval would disarm
    every check downstream (a one-sided clip makes half-bounded
    intervals in ordinary graphs)."""
    if x == 0.0 or y == 0.0:
        return 0.0
    return x * y


def _iv_mul(a, b):
    if any(v != v for v in (*a, *b)):   # a NaN endpoint: no claim
        return None
    ps = (_mul_ep(a[0], b[0]), _mul_ep(a[0], b[1]),
          _mul_ep(a[1], b[0]), _mul_ep(a[1], b[1]))
    return (min(ps), max(ps))


def _iv_exp(x):
    if x >= 709.0:                  # float64 exp's overflow knee
        return float("inf")
    try:
        return math.exp(x)
    except OverflowError:
        return float("inf")


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

    def infer_range(self, input_ranges, input_shapes=None):
        a, b = input_ranges
        if a is None or b is None:
            return None
        return (a[0] + b[0], a[1] + b[1])


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

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        try:
            c = float(self.const_attr)
        except (TypeError, ValueError):
            return None
        return None if a is None else (a[0] + c, a[1] + c)


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

    def infer_range(self, input_ranges, input_shapes=None):
        a, b = input_ranges
        if a is None or b is None:
            return None
        if self.inputs[0] is self.inputs[1]:
            # x * x is a square, not a product of two intervals: the
            # correlation-blind product would reach below 0 and hide
            # every "square + eps" guard HT804 looks for
            lo = 0.0 if a[0] <= 0.0 <= a[1] else min(a[0] * a[0],
                                                     a[1] * a[1])
            return (lo, max(a[0] * a[0], a[1] * a[1]))
        return _iv_mul(a, b)


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

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        try:
            c = float(self.const_attr)
        except (TypeError, ValueError):
            return None
        return None if a is None else _iv_sorted(a[0] * c, a[1] * c)


class OppositeOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(OppositeOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return -input_vals[0]

    def gradient(self, output_grad):
        return [opposite_op(output_grad, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        return None if a is None else (-a[1], -a[0])


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

    def infer_range(self, input_ranges, input_shapes=None):
        a, b = input_ranges
        if a is None or b is None or (b[0] <= 0.0 <= b[1]):
            return None           # a zero-crossing denominator: HT804's
        return _iv_mul(a, (1.0 / b[1], 1.0 / b[0]))


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

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        try:
            c = float(self.const_attr)
        except (TypeError, ValueError):
            return None
        if a is None or (a[0] <= 0.0 <= a[1]):
            return None
        return _iv_sorted(c / a[1], c / a[0])


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

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        if a is None:
            return None
        # bound over the defined (x >= 0) region; a negative lo is
        # HT804's finding, not this bound's
        return (math.sqrt(max(a[0], 0.0)), math.sqrt(max(a[1], 0.0)))


class ReciprocalSqrtOp(_UnaryOp):
    # 1 / sqrt(x), rounded as the reference's reciprocal(sqrt(x))
    fn = staticmethod(lambda x: torch.reciprocal(torch.sqrt(x)))

    def gradient(self, output_grad):
        # d x^{-1/2} = -1/2 * rsqrt(x) / x
        x = self.inputs[0]
        g = mul_byconst_op(div_op(rsqrt_op(x), x), -0.5)
        return [mul_op(output_grad, g, ctx=self.raw_ctx)]

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        if a is None or a[0] <= 0.0:
            return None           # a zero or negative operand: HT804's
        return (1.0 / math.sqrt(a[1]), 1.0 / math.sqrt(a[0]))


class ErfOp(_UnaryOp):
    """Gauss error function (ONNX Erf)."""

    fn = torch.erf

    def gradient(self, output_grad):
        # d erf(x) = 2/sqrt(pi) * exp(-x^2)
        x = self.inputs[0]
        g = mul_byconst_op(exp_op(opposite_op(mul_op(x, x))),
                           2.0 / np.sqrt(np.pi))
        return [mul_op(output_grad, g, ctx=self.raw_ctx)]

    def infer_range(self, input_ranges, input_shapes=None):
        from .activations import _saturate
        a = input_ranges[0]
        if a is None:
            return (-1.0, 1.0)
        return _saturate(math.erf(a[0]), math.erf(a[1]), -1.0, 1.0)


class ExpOp(_UnaryOp):
    fn = torch.exp

    def gradient(self, output_grad):
        return [mul_op(output_grad, self, ctx=self.raw_ctx)]

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        if a is None:
            return None
        # an inf upper bound is what HT801 looks for in an unshifted exp
        # whose operand reaches the overflow knee
        return (_iv_exp(a[0]), _iv_exp(a[1]))


class LogOp(_UnaryOp):
    fn = torch.log

    def gradient(self, output_grad):
        return [div_op(output_grad, self.inputs[0], ctx=self.raw_ctx)]

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        if a is None or a[0] <= 0.0:
            return None           # a zero-reaching operand: HT804's
        return (math.log(a[0]), math.log(a[1]))


class AbsOp(_UnaryOp):
    fn = torch.abs

    def gradient(self, output_grad):
        from .activations import sign_op
        return [mul_op(output_grad, sign_op(self.inputs[0]),
                       ctx=self.raw_ctx)]

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        if a is None:
            return None
        lo = 0.0 if a[0] <= 0.0 <= a[1] else min(abs(a[0]), abs(a[1]))
        return (lo, max(abs(a[0]), abs(a[1])))


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

    def infer_range(self, input_ranges, input_shapes=None):
        a = input_ranges[0]
        p = self.p
        if a is None or p != int(p) or p < 0:
            return None           # a negative p over 0: HT804's
        p = int(p)
        try:
            vals = (a[0] ** p, a[1] ** p)
        except OverflowError:
            return (0.0 if p % 2 == 0 else -float("inf"), float("inf"))
        if p % 2 == 0:
            lo = 0.0 if a[0] <= 0.0 <= a[1] else min(vals)
            return (lo, max(vals))
        return _iv_sorted(*vals)


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

    def infer_range(self, input_ranges, input_shapes=None):
        _, a, b = input_ranges
        if a is None or b is None:
            return None
        return (min(a[0], b[0]), max(a[1], b[1]))


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

    def infer_range(self, input_ranges, input_shapes=None):
        return (0.0, 1.0)


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

    def infer_range(self, input_ranges, input_shapes=None):
        a, b = input_ranges
        if a is None or b is None:
            return None
        return _iv_mul(a, b)


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

    def infer_range(self, input_ranges, input_shapes=None):
        # the interval survives the cast unchanged: whether the target
        # dtype holds it is HT801's check, which reads this op's
        # unclamped interval against self.dtype's max
        return input_ranges[0]


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

    def infer_range(self, input_ranges, input_shapes=None):
        # a half-bounded result (e.g. [1e-12, inf) from a one-sided clip
        # of an unknown operand) still carries the zero-exclusion guard
        # HT804 looks for
        a = input_ranges[0]
        lo = -float("inf") if a is None else a[0]
        hi = float("inf") if a is None else a[1]
        if self.min_val is not None:
            lo = max(lo, float(self.min_val))
            hi = max(hi, float(self.min_val))
        if self.max_val is not None:
            hi = min(hi, float(self.max_val))
            lo = min(lo, float(self.max_val))
        return (lo, hi)


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

    def infer_range(self, input_ranges, input_shapes=None):
        return (0.0, 1.0)


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
