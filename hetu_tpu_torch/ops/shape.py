"""Shape-manipulation and reduction ops.

Counterpart of ``hetu_tpu/ops/shape.py`` (reference parity:
gpu_ops/{Reshape,Broadcast,BroadcastShape,Concat,Concatenate,Split,Slice,
Transpose,Pad,ReduceSum,ReduceMean,ReduceSumAxisZero,OnesLike,
ZerosLike}.py), whole. Views stand in for copies where torch allows it
(``expand``, ``permute``, slicing); consumers that need contiguous
memory make it.

``pad_op`` pads any axis in the reference's three modes. Its REFLECT and
SYMMETRIC modes gather along each padded axis through an index built
with numpy's rules (``torch.nn.functional.pad`` reflects only the last
dims and has no symmetric mode), and their gradient scatter-adds back
through the same index.

The tensor-parallel planner's ``deduce_states`` rules of reshape,
broadcast, concat, concatenate, split, transpose, reduce-sum and
reduce-mean are the JAX package's.

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
    "unbroadcast_op", "split_op", "split_gradient_op", "slice_op",
    "slice_gradient_op", "transpose_op", "concat_op", "concat_gradient_op",
    "concatenate_op", "pad_op", "pad_gradient_op", "reduce_sum_op",
    "reduce_mean_op", "broadcast_shape_grad_source_op", "squeeze_op",
    "oneslike_op", "zeroslike_op", "broadcast_shape_op", "flatten_op",
    "unsqueeze_op", "reducesumaxiszero_op",
]


def _concat_deduce(input_statuses, status, deduce_order, axis):
    """Shared concat rule: non-axis splits must agree across inputs (take
    the first distributed one); the concat axis can't stay split (shard
    boundaries interleave) — it folds into the duplicate axis."""
    st = next((s for s in input_statuses
               if s is not None and s.state is not None), None)
    if st is None:
        return
    state = list(st.state)
    folded = 1
    if axis < len(state):
        folded = state[axis]
        state[axis] = 1
    if not deduce_order:
        status.set_state(tuple(state))
        status.set_attr((st.duplicate or 1) * folded,
                        (-1,) + tuple(range(len(state))))


def _reduce_deduce(input_statuses, status, deduce_order, axes, keepdims):
    """Shared reduce rule: splits on reduced axes become partial sums —
    they fold into the duplicate axis; kept axes carry their splits
    through (reference ReduceSum.py deduce_states)."""
    st = input_statuses[0]
    if st is None or st.state is None:
        return
    ndim = len(st.state)
    ax_norm = [a if a >= 0 else a + ndim for a in axes]
    state, folded = [], 1
    for i, p in enumerate(st.state):
        if i in ax_norm:
            folded *= p
            if keepdims[ax_norm.index(i)]:
                state.append(1)
        else:
            state.append(p)
    if not state:
        state = [1]
    if not deduce_order:
        status.set_state(tuple(state))
        status.set_attr((st.duplicate or 1) * folded,
                        (-1,) + tuple(range(len(state))))


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

    def deduce_states(self, input_statuses, status, deduce_order):
        """Only a leading-dim split survives a reshape for sure (the
        reference Reshape.py likewise allows dim-0 splits only), and only
        when the reshape preserves the leading row blocks: dim 0 of -1
        (the batch-agnostic pattern) or a dim 0 that divides the input's.
        A reshape that reorders dim 0 away (e.g. (B,S,D)->(S,B*D)) folds
        the split into the duplicate axis instead.
        """
        st = input_statuses[0]
        if st is None or st.state is None:
            return
        ndim = len(self.output_shape)
        lead = st.state[0] if st.state else 1
        in_shape = getattr(self.inputs[0], "inferred_shape", None)
        keep_lead = self.output_shape[0] == -1 or (
            in_shape is not None and in_shape[0] > 0
            and self.output_shape[0] % in_shape[0] == 0)
        if not keep_lead:
            lead, fold = 1, lead
        else:
            fold = 1
        rest = fold
        for p in st.state[1:]:
            rest *= p
        if not deduce_order:
            status.set_state((lead,) + (1,) * (ndim - 1))
            status.set_attr((st.duplicate or 1) * rest,
                            (-1,) + tuple(range(ndim)))


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

    def deduce_states(self, input_statuses, status, deduce_order):
        # output has node_B's shape, so adopt node_B's partition state
        st = input_statuses[1]
        if st is None or st.state is None:
            return
        if not deduce_order:
            status.set_state(st.state)
            if st.duplicate is not None and st.order is not None:
                status.set_attr(st.duplicate, st.order)


class BroadcastShapeOp(Op):
    """Broadcast to an explicit shape, inserting new axes at ``add_axes``
    first (reference BroadcastShape.py)."""

    def __init__(self, node_A, shape, add_axes=(), ctx=None):
        super().__init__(BroadcastShapeOp, [node_A], ctx)
        self.shape = tuple(shape)
        self.add_axes = tuple(add_axes)

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        for ax in sorted(self.add_axes):
            x = x.unsqueeze(ax)
        return x.expand(self.shape)

    def gradient(self, output_grad):
        return [unbroadcast_op(output_grad, self.inputs[0],
                               sum_axes=self.add_axes, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return self.shape


class UnbroadcastOp(Op):
    """Adjoint of a broadcast: sum the grad back to the target node's
    shape — first the ``sum_axes`` (the axes a ``broadcast_shape_op``
    inserted), then extra leading dims and stretched size-1 dims."""

    def __init__(self, grad_node, target_node, sum_axes=(), ctx=None):
        super().__init__(UnbroadcastOp, [grad_node], ctx)
        self.target_node = target_node
        self.sum_axes = tuple(sum_axes)

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        if self.sum_axes:
            x = x.sum(dim=self.sum_axes)
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

    def deduce_states(self, input_statuses, status, deduce_order):
        # each output piece is a slice: splits on the sliced axes can't be
        # carried (the shard boundary moved) — force them to 1
        st = input_statuses[0]
        if st is None or st.state is None:
            return
        state = list(st.state)
        for ax in self.axes:
            if ax < len(state):
                state[ax] = 1
        if not deduce_order:
            status.set_state(tuple(state))
            status.set_attr(st.duplicate or 1,
                            (-1,) + tuple(range(len(state))))


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


class SliceOp(Op):
    """``size`` elements from ``begin`` along each leading dim (-1: to
    the end); dims past ``len(size)`` pass through whole."""

    def __init__(self, node_A, begin_pos, output_shape, ctx=None):
        super().__init__(SliceOp, [node_A], ctx)
        self.begin_pos = tuple(begin_pos)
        self.output_shape = tuple(output_shape)

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        sizes = [x.shape[i] - self.begin_pos[i] if s == -1 else s
                 for i, s in enumerate(self.output_shape)]
        return x[tuple(slice(b, b + s)
                       for b, s in zip(self.begin_pos, sizes))]

    def gradient(self, output_grad):
        return [slice_gradient_op(output_grad, self.begin_pos,
                                  self.output_shape, self, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        in_shape = input_shapes[0]
        out = [in_shape[i] - self.begin_pos[i] if s == -1 else s
               for i, s in enumerate(self.output_shape)]
        # begin/size may cover only the leading dims (partial indexing,
        # as compute's tuple of slices): trailing dims pass through
        out.extend(in_shape[len(self.output_shape):])
        return tuple(out)


class SliceGradientOp(Op):
    """Adjoint of a slice: the grad placed at ``begin`` in zeros of the
    forward input's shape."""

    def __init__(self, node_A, begin_pos, output_shape=None,
                 forward_node=None, ctx=None):
        super().__init__(SliceGradientOp, [node_A], ctx)
        self.begin_pos = tuple(begin_pos)
        self.forward_node = forward_node

    def compute(self, input_vals, ectx):
        grad = input_vals[0]
        out = grad.new_zeros(self.full_shape)
        out[tuple(slice(b, b + s)
                  for b, s in zip(self.begin_pos, grad.shape))] = grad
        return out

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        self.full_shape = tuple(self.forward_node.inputs[0].inferred_shape)
        return self.full_shape


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

    def deduce_states(self, input_statuses, status, deduce_order):
        # permute the split counts exactly like the dims (reference
        # Transpose.py deduce_states)
        st = input_statuses[0]
        if st is None or st.state is None:
            return
        perm = self.perm if self.perm is not None \
            else tuple(reversed(range(len(st.state))))
        state = st.state + (1,) * (len(perm) - len(st.state))
        if not deduce_order:
            status.set_state(tuple(state[p] for p in perm))
            status.set_attr(st.duplicate or 1,
                            (-1,) + tuple(range(len(perm))))


class ConcatOp(Op):
    def __init__(self, node_A, node_B, axis=0, ctx=None):
        super().__init__(ConcatOp, [node_A, node_B], ctx)
        self.axis = axis

    def compute(self, input_vals, ectx):
        return torch.cat(input_vals, dim=self.axis)

    def gradient(self, output_grad):
        return [concat_gradient_op(output_grad, self.inputs[0], self.axis, 0,
                                   ctx=self.raw_ctx),
                concat_gradient_op(output_grad, self.inputs[1], self.axis, 1,
                                   ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        out = list(input_shapes[0])
        out[self.axis] += input_shapes[1][self.axis]
        return tuple(out)

    def deduce_states(self, input_statuses, status, deduce_order):
        _concat_deduce(input_statuses, status, deduce_order, self.axis)


class ConcatGradientOp(Op):
    """The ``idx``-th (0 or 1) part of a two-way concat's adjoint, as
    wide as ``input_node`` along ``axis``."""

    def __init__(self, grad_node, input_node, axis, idx, ctx=None):
        super().__init__(ConcatGradientOp, [grad_node, input_node], ctx)
        self.axis = axis
        self.idx = idx

    def compute(self, input_vals, ectx):
        grad, ref = input_vals
        size = ref.shape[self.axis]
        start = 0 if self.idx == 0 else grad.shape[self.axis] - size
        return grad.narrow(self.axis, start, size)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[1]


class ConcatenateOp(Op):
    """N-ary concat."""

    def __init__(self, nodes, axis=0, ctx=None):
        super().__init__(ConcatenateOp, list(nodes), ctx)
        self.axis = axis

    def compute(self, input_vals, ectx):
        return torch.cat(input_vals, dim=self.axis)

    def gradient(self, output_grad):
        return [ConcatenateGradientOp(output_grad, self, i, self.axis,
                                      ctx=self.raw_ctx)
                for i in range(len(self.inputs))]

    def infer_shape(self, input_shapes):
        out = list(input_shapes[0])
        out[self.axis] = sum(s[self.axis] for s in input_shapes)
        return tuple(out)

    def deduce_states(self, input_statuses, status, deduce_order):
        _concat_deduce(input_statuses, status, deduce_order, self.axis)


class ConcatenateGradientOp(Op):
    """The ``idx``-th input's part of an N-ary concat's adjoint."""

    def __init__(self, grad_node, forward_node, idx, axis, ctx=None):
        super().__init__(ConcatenateGradientOp, [grad_node], ctx)
        self.forward_node = forward_node
        self.idx = idx
        self.axis = axis

    def compute(self, input_vals, ectx):
        sizes = [inp.inferred_shape[self.axis]
                 for inp in self.forward_node.inputs]
        return input_vals[0].narrow(self.axis, sum(sizes[:self.idx]),
                                    sizes[self.idx])

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return tuple(self.forward_node.inputs[self.idx].inferred_shape)


_PAD_MODES = ("CONSTANT", "REFLECT", "SYMMETRIC")


def _pad_index(n, lo, hi, mode, device):
    """For one axis of length ``n`` padded by (lo, hi): the input index
    of every output position, numpy's ``reflect`` (edge not repeated) or
    ``symmetric`` (edge repeated) rule, repeated past the edges as numpy
    repeats it for pads wider than the axis."""
    pos = np.arange(-lo, n + hi)
    if mode == "REFLECT":
        period = max(2 * (n - 1), 1)
        pos = np.abs(pos) % period
        pos = np.where(pos >= n, period - pos, pos)
    else:
        pos = np.mod(pos, 2 * n)
        pos = np.where(pos >= n, 2 * n - 1 - pos, pos)
    return torch.as_tensor(pos, dtype=torch.long, device=device)


class PadOp(Op):
    """Pad with ``paddings`` = [(before, after)] per axis (reference
    Pad.py): CONSTANT fills ``constant_values``; REFLECT and SYMMETRIC
    mirror the axis without and with its edge element."""

    def __init__(self, node_A, paddings, mode="CONSTANT", constant_values=0,
                 ctx=None):
        super().__init__(PadOp, [node_A], ctx)
        self.paddings = [tuple(p) for p in paddings]
        self.mode = mode.upper()
        if self.mode not in _PAD_MODES:
            raise ValueError(f"pad_op: mode {mode!r} is not one of "
                             f"{_PAD_MODES}")
        self.constant_values = constant_values

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        if self.mode == "CONSTANT":
            flat = [p for lo_hi in reversed(self.paddings) for p in lo_hi]
            return torch.nn.functional.pad(x, flat,
                                           value=self.constant_values)
        for axis, (lo, hi) in enumerate(self.paddings):
            if lo or hi:
                x = x.index_select(axis, _pad_index(
                    x.shape[axis], lo, hi, self.mode, x.device))
        return x

    def gradient(self, output_grad):
        return [pad_gradient_op(output_grad, self.paddings, self.mode,
                                ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return tuple(s + lo + hi
                     for s, (lo, hi) in zip(input_shapes[0], self.paddings))


class PadGradientOp(Op):
    """Adjoint of a pad: CONSTANT crops; REFLECT and SYMMETRIC add each
    padded position's adjoint into the element it mirrors."""

    def __init__(self, node_A, paddings, mode="CONSTANT", ctx=None):
        super().__init__(PadGradientOp, [node_A], ctx)
        self.paddings = [tuple(p) for p in paddings]
        self.mode = mode.upper()

    def compute(self, input_vals, ectx):
        grad = input_vals[0]
        if self.mode == "CONSTANT":
            return grad[tuple(slice(lo, grad.shape[i] - hi)
                              for i, (lo, hi) in enumerate(self.paddings))]
        for axis, (lo, hi) in enumerate(self.paddings):
            if lo or hi:
                n = grad.shape[axis] - lo - hi
                shape = list(grad.shape)
                shape[axis] = n
                grad = grad.new_zeros(shape).index_add_(
                    axis, _pad_index(n, lo, hi, self.mode, grad.device),
                    grad)
        return grad

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return tuple(s - lo - hi
                     for s, (lo, hi) in zip(input_shapes[0], self.paddings))


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

    def deduce_states(self, input_statuses, status, deduce_order):
        _reduce_deduce(input_statuses, status, deduce_order,
                       self.axes, self.keepdims)


class ReduceMeanOp(_ReduceOp):
    _mean = True

    def __init__(self, node_A, axes, keepdims=False, ctx=None):
        super().__init__(ReduceMeanOp, node_A, axes, keepdims, ctx)

    def deduce_states(self, input_statuses, status, deduce_order):
        _reduce_deduce(input_statuses, status, deduce_order,
                       self.axes, self.keepdims)


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


class ReduceSumAxisZeroOp(Op):
    def __init__(self, node_A, ctx=None):
        super().__init__(ReduceSumAxisZeroOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return input_vals[0].sum(dim=0)

    def gradient(self, output_grad):
        return [broadcastto_op(output_grad, self.inputs[0],
                               ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        shape = tuple(input_shapes[0][1:])
        return shape if shape else (1,)


class FlattenOp(Op):
    """ONNX Flatten: always the 2-D ``(prod(dims[:axis]),
    prod(dims[axis:]))``."""

    def __init__(self, node_A, axis=1, ctx=None):
        super().__init__(FlattenOp, [node_A], ctx)
        self.axis = int(axis)

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        return x.reshape(int(np.prod(x.shape[:self.axis])), -1)

    def gradient(self, output_grad):
        return [array_reshape_gradient_op(output_grad, self,
                                          ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        s = input_shapes[0]
        return (int(np.prod(s[:self.axis])), int(np.prod(s[self.axis:])))


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


class UnsqueezeOp(Op):
    """Insert size-1 dims at ``axes`` (positions in the output shape)."""

    def __init__(self, node_A, axes, ctx=None):
        super().__init__(UnsqueezeOp, [node_A], ctx)
        self.axes = tuple(int(a) for a in axes)

    def _out_shape(self, in_shape):
        ndim = len(in_shape) + len(self.axes)
        axes = {a % ndim for a in self.axes}
        it = iter(in_shape)
        return tuple(1 if i in axes else next(it) for i in range(ndim))

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


def broadcast_shape_op(node_A, shape, add_axes=(), ctx=None):
    return BroadcastShapeOp(node_A, shape, add_axes=add_axes, ctx=ctx)


def unbroadcast_op(grad_node, target_node, sum_axes=(), ctx=None):
    return UnbroadcastOp(grad_node, target_node, sum_axes=sum_axes, ctx=ctx)


def split_op(node, axes, indices, splits, ctx=None):
    return SplitOp(node, axes, indices, splits, ctx=ctx)


def split_gradient_op(node, axes, indices, splits, ctx=None):
    return SplitGradientOp(node, axes, indices, splits, ctx=ctx)


def slice_op(node, begin, size, ctx=None):
    return SliceOp(node, begin, size, ctx=ctx)


def slice_gradient_op(node, begin, size=None, forward_node=None, ctx=None):
    return SliceGradientOp(node, begin, size, forward_node=forward_node,
                           ctx=ctx)


def transpose_op(node_A, perm=None, ctx=None):
    return TransposeOp(node_A, perm=perm, ctx=ctx)


def concat_op(node_A, node_B, axis=0, ctx=None):
    return ConcatOp(node_A, node_B, axis=axis, ctx=ctx)


def concat_gradient_op(grad_node, input_node, axis, idx, ctx=None):
    return ConcatGradientOp(grad_node, input_node, axis, idx, ctx=ctx)


def concatenate_op(nodes, axis=0, ctx=None):
    return ConcatenateOp(nodes, axis=axis, ctx=ctx)


def pad_op(node_A, paddings, mode="CONSTANT", constant_values=0, ctx=None):
    return PadOp(node_A, paddings, mode=mode,
                 constant_values=constant_values, ctx=ctx)


def pad_gradient_op(node_A, paddings, mode="CONSTANT", ctx=None):
    return PadGradientOp(node_A, paddings, mode=mode, ctx=ctx)


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


def flatten_op(node, axis=1, ctx=None):
    return FlattenOp(node, axis=axis, ctx=ctx)


def unsqueeze_op(node, axes, ctx=None):
    return UnsqueezeOp(node, axes, ctx=ctx)


def reducesumaxiszero_op(node, ctx=None):
    return ReduceSumAxisZeroOp(node, ctx=ctx)
