"""Shape-manipulation and reduction ops.

Counterpart of ``hetu_tpu/ops/shape.py`` (reference parity:
gpu_ops/{Reshape,Broadcast,Split,Transpose,ReduceSum,ReduceMean,
OnesLike,ZerosLike}.py), the part the GPT training graph and its
gradients reach. Views stand in for copies where torch allows it
(``expand``, ``permute``, slicing); consumers that need contiguous
memory make it.

Several gradient ops read the forward input's ``inferred_shape``, which
the executor's shape pass (``SubExecutor._infer_shapes``) sets on every
node before the first step of a feed-shape signature, as in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.node import Op

__all__ = [
    "array_reshape_op", "array_reshape_gradient_op", "broadcastto_op",
    "unbroadcast_op", "split_op", "split_gradient_op", "transpose_op",
    "reduce_sum_op", "reduce_mean_op", "broadcast_shape_grad_source_op",
    "squeeze_op", "oneslike_op", "zeroslike_op",
]


def _resolve_shape(shape, total):
    """Fill one -1 dim like the reference (Reshape.py)."""
    shape = list(shape)
    if -1 in shape:
        known = -int(np.prod(shape))
        shape[shape.index(-1)] = total // known
    return tuple(shape)


class ArrayReshapeOp(Op):
    def __init__(self, node_A, output_shape, ctx=None):
        super().__init__(ArrayReshapeOp, [node_A], ctx)
        self.output_shape = tuple(output_shape)

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        return x.reshape(_resolve_shape(self.output_shape, x.numel()))

    def gradient(self, output_grad):
        return [array_reshape_gradient_op(output_grad, self,
                                          ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return _resolve_shape(self.output_shape,
                              int(np.prod(input_shapes[0])))


class ArrayReshapeGradientOp(Op):
    """The adjoint of a reshape (or squeeze): back to the forward input's
    shape."""

    def __init__(self, grad_node, forward_node, ctx=None):
        super().__init__(ArrayReshapeGradientOp, [grad_node], ctx)
        self.forward_node = forward_node

    def compute(self, input_vals, ectx):
        return input_vals[0].reshape(self.input_shape)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        self.input_shape = tuple(self.forward_node.inputs[0].inferred_shape)
        return self.input_shape


class BroadcastToOp(Op):
    """Broadcast node_A to the shape of node_B (reference Broadcast.py):
    numpy's right-aligned rules."""

    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(BroadcastToOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        return input_vals[0].expand(input_vals[1].shape)

    def gradient(self, output_grad):
        return [unbroadcast_op(output_grad, self.inputs[0],
                               ctx=self.raw_ctx), None]

    def infer_shape(self, input_shapes):
        return input_shapes[1]


class UnbroadcastOp(Op):
    """Adjoint of a broadcast: sum the grad back to the target node's
    shape (extra leading dims and stretched size-1 dims)."""

    def __init__(self, grad_node, target_node, ctx=None):
        super().__init__(UnbroadcastOp, [grad_node], ctx)
        self.target_node = target_node

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        target = self.target_shape
        lead = x.dim() - len(target)
        if lead > 0:
            x = x.sum(dim=tuple(range(lead)))
        stretched = tuple(i for i, s in enumerate(target)
                          if s == 1 and x.shape[i] != 1)
        if stretched:
            x = x.sum(dim=stretched, keepdim=True)
        return x.reshape(target)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        self.target_shape = tuple(self.target_node.inferred_shape)
        return self.target_shape


class SplitOp(Op):
    """Take the ``indices``-th piece when splitting each axis in ``axes``
    into ``splits`` parts (reference Split.py)."""

    def __init__(self, node_A, axes, indices, splits, ctx=None):
        super().__init__(SplitOp, [node_A], ctx)
        self.axes = list(axes)
        self.indices = list(indices)
        self.splits = list(splits)
        if not len(self.axes) == len(self.splits) == len(self.indices) \
                or any(a < 0 for a in self.axes):
            raise ValueError("split_op: axes, indices, splits must have "
                             "one length and axes must be >= 0")

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        index = [slice(None)] * x.dim()
        for ax, ind, spl in zip(self.axes, self.indices, self.splits):
            size = x.shape[ax] // spl
            index[ax] = slice(ind * size, (ind + 1) * size)
        return x[tuple(index)]

    def gradient(self, output_grad):
        return [split_gradient_op(output_grad, self.axes, self.indices,
                                  self.splits, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        out = list(input_shapes[0])
        for ax, spl in zip(self.axes, self.splits):
            if out[ax] % spl:
                raise ValueError(f"split_op: dim {ax} of size {out[ax]} "
                                 f"does not split {spl} ways")
            out[ax] //= spl
        return tuple(out)


class SplitGradientOp(Op):
    """Adjoint of a split: the piece placed in zeros of the full shape."""

    def __init__(self, node_A, axes, indices, splits, ctx=None):
        super().__init__(SplitGradientOp, [node_A], ctx)
        self.axes = list(axes)
        self.indices = list(indices)
        self.splits = list(splits)

    def compute(self, input_vals, ectx):
        grad = input_vals[0]
        out_shape = list(grad.shape)
        index = [slice(None)] * grad.dim()
        for ax, ind, spl in zip(self.axes, self.indices, self.splits):
            out_shape[ax] = grad.shape[ax] * spl
            index[ax] = slice(ind * grad.shape[ax],
                              (ind + 1) * grad.shape[ax])
        out = grad.new_zeros(out_shape)
        out[tuple(index)] = grad
        return out

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        out = list(input_shapes[0])
        for ax, spl in zip(self.axes, self.splits):
            out[ax] *= spl
        return tuple(out)


class TransposeOp(Op):
    def __init__(self, node_A, perm=None, ctx=None):
        super().__init__(TransposeOp, [node_A], ctx)
        self.perm = tuple(perm) if perm is not None else None

    def _perm(self, ndim):
        return self.perm if self.perm is not None \
            else tuple(reversed(range(ndim)))

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        return x.permute(self._perm(x.dim()))

    def gradient(self, output_grad):
        inv = None if self.perm is None \
            else tuple(int(i) for i in np.argsort(self.perm))
        return [transpose_op(output_grad, inv, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        shape = input_shapes[0]
        return tuple(shape[p] for p in self._perm(len(shape)))


class _ReduceOp(Op):
    """Shared body of reduce_sum / reduce_mean (reference
    ReduceSum.py / ReduceMean.py)."""

    _mean = False

    def __init__(self, op_type, node_A, axes, keepdims=False, ctx=None):
        super().__init__(op_type, [node_A], ctx)
        self.axes = [axes] if isinstance(axes, int) else list(axes)
        if isinstance(keepdims, bool):
            self.keepdims = [keepdims] * len(self.axes)
        else:
            self.keepdims = list(keepdims)

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        fn = torch.mean if self._mean else torch.sum
        if all(self.keepdims) or not any(self.keepdims):
            return fn(x, dim=tuple(self.axes), keepdim=self.keepdims[0]
                      if self.keepdims else False)
        for ax, keep in reversed(list(zip(self.axes, self.keepdims))):
            x = fn(x, dim=ax, keepdim=keep)
        return x

    def gradient(self, output_grad):
        add_axes = [ax for ax, keep in zip(self.axes, self.keepdims)
                    if not keep]
        return [broadcast_shape_grad_source_op(
            output_grad, self.inputs[0], add_axes, mean=self._mean,
            mean_axes=self.axes, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        shape = list(input_shapes[0])
        axes = [ax if ax >= 0 else ax + len(shape) for ax in self.axes]
        out = []
        for i, s in enumerate(shape):
            if i in axes:
                if self.keepdims[axes.index(i)]:
                    out.append(1)
            else:
                out.append(s)
        return tuple(out) if out else (1,)


class ReduceSumOp(_ReduceOp):
    def __init__(self, node_A, axes, keepdims=False, ctx=None):
        super().__init__(ReduceSumOp, node_A, axes, keepdims, ctx)


class ReduceMeanOp(_ReduceOp):
    _mean = True

    def __init__(self, node_A, axes, keepdims=False, ctx=None):
        super().__init__(ReduceMeanOp, node_A, axes, keepdims, ctx)


class BroadcastShapeGradSourceOp(Op):
    """Adjoint of reduce_sum / reduce_mean: the grad broadcast back to the
    input's shape (divided by the reduced size for mean)."""

    def __init__(self, grad_node, target_node, add_axes, mean=False,
                 mean_axes=None, ctx=None):
        super().__init__(BroadcastShapeGradSourceOp, [grad_node], ctx)
        self.target_node = target_node
        self.add_axes = list(add_axes)
        self.mean = mean
        self.mean_axes = mean_axes

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        target = self.target_shape
        for ax in sorted(self.add_axes):
            x = x.unsqueeze(ax)
        out = x.expand(target)
        if self.mean:
            out = out / int(np.prod([target[ax] for ax in self.mean_axes]))
        return out

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        self.target_shape = tuple(self.target_node.inferred_shape)
        return self.target_shape


class SqueezeOp(Op):
    """Drop size-1 dims — the given ``axes``, or all when None."""

    def __init__(self, node_A, axes=None, ctx=None):
        super().__init__(SqueezeOp, [node_A], ctx)
        self.axes = None if axes is None else tuple(int(a) for a in axes)

    def _out_shape(self, in_shape):
        if self.axes is None:
            return tuple(d for d in in_shape if d != 1)
        axes = {a % len(in_shape) for a in self.axes}
        return tuple(d for i, d in enumerate(in_shape) if i not in axes)

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        return x.reshape(self._out_shape(tuple(x.shape)))

    def gradient(self, output_grad):
        return [array_reshape_gradient_op(output_grad, self,
                                          ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return self._out_shape(tuple(input_shapes[0]))


class OnesLikeOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(OnesLikeOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return torch.ones_like(input_vals[0])

    def gradient(self, output_grad):
        return [zeroslike_op(self.inputs[0], ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class ZerosLikeOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(ZerosLikeOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return torch.zeros_like(input_vals[0])

    def gradient(self, output_grad):
        return [zeroslike_op(self.inputs[0], ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


def array_reshape_op(node, output_shape, ctx=None):
    return ArrayReshapeOp(node, output_shape, ctx=ctx)


def array_reshape_gradient_op(node, forward_node, ctx=None):
    return ArrayReshapeGradientOp(node, forward_node, ctx=ctx)


def broadcastto_op(node_A, node_B, ctx=None):
    return BroadcastToOp(node_A, node_B, ctx=ctx)


def unbroadcast_op(grad_node, target_node, ctx=None):
    return UnbroadcastOp(grad_node, target_node, ctx=ctx)


def split_op(node, axes, indices, splits, ctx=None):
    return SplitOp(node, axes, indices, splits, ctx=ctx)


def split_gradient_op(node, axes, indices, splits, ctx=None):
    return SplitGradientOp(node, axes, indices, splits, ctx=ctx)


def transpose_op(node_A, perm=None, ctx=None):
    return TransposeOp(node_A, perm=perm, ctx=ctx)


def reduce_sum_op(node, axes, keepdims=False, ctx=None):
    return ReduceSumOp(node, axes, keepdims=keepdims, ctx=ctx)


def reduce_mean_op(node, axes, keepdims=False, ctx=None):
    return ReduceMeanOp(node, axes, keepdims=keepdims, ctx=ctx)


def broadcast_shape_grad_source_op(grad_node, target_node, add_axes,
                                   mean=False, mean_axes=None, ctx=None):
    return BroadcastShapeGradSourceOp(grad_node, target_node, add_axes,
                                      mean=mean, mean_axes=mean_axes, ctx=ctx)


def squeeze_op(node, axes=None, ctx=None):
    return SqueezeOp(node, axes=axes, ctx=ctx)


def oneslike_op(node, ctx=None):
    return OnesLikeOp(node, ctx=ctx)


def zeroslike_op(node, ctx=None):
    return ZerosLikeOp(node, ctx=ctx)
