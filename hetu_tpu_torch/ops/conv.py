"""Convolution and pooling ops: NCHW data, OIHW filters.

Counterpart of ``hetu_tpu/ops/conv.py`` (reference parity:
gpu_ops/{Conv2d,MaxPool,AvgPool,Conv2dBroadcast,Conv2dReduceSum}.py).
The JAX package lowers these to ``lax.conv_general_dilated`` and
``lax.reduce_window``, outside any Pallas kernel; here they are
PyTorch's own calls (cuDNN's convolutions on the card), and each
gradient op calls ATen's backward of the same forward:
``convolution_backward`` for one of its two outputs,
``max_pool2d_with_indices_backward``, ``avg_pool2d_backward``.
``padding`` and ``stride`` are an int or an (h, w) pair; padding is
symmetric.

Max pool pads with -inf, and its gradient sends each window's adjoint
to the window's first largest element in row-major order: what the
JAX package's vjp of ``reduce_window(max)`` does (select-and-scatter
keeping the earlier element on ``>=``), and what ATen's indices hold.
Ties are common (a window of zeros after relu). Avg pool divides by
``kh * kw``, padded zeros included (``count_include_pad``).

On the card an f32 graph runs its convolutions in true f32: the
executor turns cuDNN's TF32 off while it walks one (``executor.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graph.node import Op

__all__ = [
    "conv2d_op", "conv2d_gradient_of_data_op", "conv2d_gradient_of_filter_op",
    "max_pool2d_op", "max_pool2d_gradient_op", "avg_pool2d_op",
    "avg_pool2d_gradient_op", "conv2d_broadcastto_op", "conv2d_reducesum_op",
]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _out_hw(h, w, kh, kw, padding, stride):
    ph, pw = _pair(padding)
    sh, sw = _pair(stride)
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


class Conv2dOp(Op):
    def __init__(self, node_A, node_B, padding=0, stride=1, ctx=None):
        super().__init__(Conv2dOp, [node_A, node_B], ctx)
        self.padding = padding
        self.stride = stride

    def compute(self, input_vals, ectx):
        data, filt = input_vals
        return F.conv2d(data, filt, stride=_pair(self.stride),
                        padding=_pair(self.padding))

    def gradient(self, output_grad):
        return [conv2d_gradient_of_data_op(self.inputs[1], output_grad,
                                           self.inputs[0],
                                           padding=self.padding,
                                           stride=self.stride,
                                           ctx=self.raw_ctx),
                conv2d_gradient_of_filter_op(self.inputs[0], output_grad,
                                             self.inputs[1],
                                             padding=self.padding,
                                             stride=self.stride,
                                             ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        n, _, h, w = input_shapes[0]
        o, _, kh, kw = input_shapes[1]
        return (n, o) + _out_hw(h, w, kh, kw, self.padding, self.stride)

    def deduce_states(self, input_statuses, status, deduce_order):
        """Data (n,c,h,w) × filter (o,c,kh,kw) → (n,o,oh,ow): batch split
        from data dim 0, out-channel split from filter dim 0, matching
        in-channel splits contract into the duplicate axis. Spatial splits
        would need halo exchange — left unsplit (reference Conv2d.py
        forbids them too).
        """
        ld, lf = input_statuses

        def dims(st):
            if st is None or st.state is None:
                return None
            return st.state + (1,) * (4 - len(st.state))

        d, f = dims(ld), dims(lf)
        if d is None and f is None:
            return
        n = d[0] if d is not None else 1
        o = f[0] if f is not None else 1
        c = d[1] if d is not None else (f[1] if f is not None else 1)
        if not deduce_order:
            status.set_state((n, o, 1, 1))
            dup = max(ld.duplicate or 1 if ld else 1,
                      lf.duplicate or 1 if lf else 1) * (c or 1)
            status.set_attr(dup, (-1, 0, 1, 2, 3))


class Conv2dGradientOfDataOp(Op):
    """inputs: (filter, grad_y[, data_ref]); output: grad wrt data."""

    def __init__(self, node_filter, node_grad, node_data=None, padding=0,
                 stride=1, ctx=None):
        inputs = [node_filter, node_grad]
        self.has_ref = node_data is not None
        if self.has_ref:
            inputs.append(node_data)
        super().__init__(Conv2dGradientOfDataOp, inputs, ctx)
        self.padding = padding
        self.stride = stride

    def compute(self, input_vals, ectx):
        filt, grad = input_vals[0], input_vals[1]
        data_shape = (input_vals[2].shape if self.has_ref
                      else self.data_shape)
        return torch.nn.grad.conv2d_input(
            data_shape, filt, grad, stride=_pair(self.stride),
            padding=_pair(self.padding))

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        if self.has_ref:
            self.data_shape = tuple(input_shapes[2])
        return self.data_shape


class Conv2dGradientOfFilterOp(Op):
    """inputs: (data, grad_y[, filter_ref]); output: grad wrt filter."""

    def __init__(self, input_X, gradient_Y, node_filter=None, padding=0,
                 stride=1, ctx=None):
        inputs = [input_X, gradient_Y]
        self.has_ref = node_filter is not None
        if self.has_ref:
            inputs.append(node_filter)
        super().__init__(Conv2dGradientOfFilterOp, inputs, ctx)
        self.padding = padding
        self.stride = stride

    def compute(self, input_vals, ectx):
        data, grad = input_vals[0], input_vals[1]
        filt_shape = (input_vals[2].shape if self.has_ref
                      else self.filter_shape)
        return torch.nn.grad.conv2d_weight(
            data, filt_shape, grad, stride=_pair(self.stride),
            padding=_pair(self.padding))

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        if self.has_ref:
            self.filter_shape = tuple(input_shapes[2])
        return self.filter_shape


class _Pool2dOp(Op):
    """Shared fields and shape of the pools and their gradients."""

    def __init__(self, op_type, inputs, kernel_H, kernel_W, padding, stride,
                 ctx):
        super().__init__(op_type, inputs, ctx)
        self.kernel_H = kernel_H
        self.kernel_W = kernel_W
        self.padding = padding
        self.stride = stride

    def _window(self):
        """(kernel, stride, padding) as ATen takes them."""
        return ((self.kernel_H, self.kernel_W), _pair(self.stride),
                _pair(self.padding))

    def infer_shape(self, input_shapes):
        n, c, h, w = input_shapes[0]
        return (n, c) + _out_hw(h, w, self.kernel_H, self.kernel_W,
                                self.padding, self.stride)


class _Pool2dGradientOp(_Pool2dOp):
    """inputs: (forward output, grad_y, forward input)."""

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[2]


class MaxPool2dOp(_Pool2dOp):
    def __init__(self, node_A, kernel_H, kernel_W, padding=0, stride=1,
                 ctx=None):
        super().__init__(MaxPool2dOp, [node_A], kernel_H, kernel_W, padding,
                         stride, ctx)

    def compute(self, input_vals, ectx):
        return F.max_pool2d(input_vals[0], *self._window())

    def gradient(self, output_grad):
        return [max_pool2d_gradient_op(self, output_grad, self.inputs[0],
                                       self.kernel_H, self.kernel_W,
                                       self.padding, self.stride,
                                       ctx=self.raw_ctx)]


class MaxPool2dGradientOp(_Pool2dGradientOp):
    def __init__(self, node_out, node_out_gradient, node_in, kernel_H,
                 kernel_W, padding=0, stride=1, ctx=None):
        super().__init__(MaxPool2dGradientOp,
                         [node_out, node_out_gradient, node_in], kernel_H,
                         kernel_W, padding, stride, ctx)

    def compute(self, input_vals, ectx):
        _, grad, x = input_vals
        kernel, stride, padding = self._window()
        _, indices = torch.ops.aten.max_pool2d_with_indices(
            x, kernel, stride, padding)
        return torch.ops.aten.max_pool2d_with_indices_backward(
            grad, x, kernel, stride, padding, (1, 1), False, indices)


class AvgPool2dOp(_Pool2dOp):
    def __init__(self, node_A, kernel_H, kernel_W, padding=0, stride=1,
                 ctx=None):
        super().__init__(AvgPool2dOp, [node_A], kernel_H, kernel_W, padding,
                         stride, ctx)

    def compute(self, input_vals, ectx):
        return F.avg_pool2d(input_vals[0], *self._window(),
                            count_include_pad=True)

    def gradient(self, output_grad):
        return [avg_pool2d_gradient_op(self, output_grad, self.inputs[0],
                                       self.kernel_H, self.kernel_W,
                                       self.padding, self.stride,
                                       ctx=self.raw_ctx)]


class AvgPool2dGradientOp(_Pool2dGradientOp):
    def __init__(self, node_out, node_out_gradient, node_in, kernel_H,
                 kernel_W, padding=0, stride=1, ctx=None):
        super().__init__(AvgPool2dGradientOp,
                         [node_out, node_out_gradient, node_in], kernel_H,
                         kernel_W, padding, stride, ctx)

    def compute(self, input_vals, ectx):
        _, grad, x = input_vals
        return torch.ops.aten.avg_pool2d_backward(
            grad, x, *self._window(), False, True, None)


class Conv2dBroadcastToOp(Op):
    """Broadcast a bias (C,) over an NCHW activation (reference
    Conv2dBroadcast.py)."""

    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(Conv2dBroadcastToOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        bias, ref = input_vals
        return bias.reshape(1, -1, 1, 1).expand(ref.shape)

    def gradient(self, output_grad):
        return [conv2d_reducesum_op(output_grad, ctx=self.raw_ctx), None]

    def infer_shape(self, input_shapes):
        return input_shapes[1]


class Conv2dReduceSumOp(Op):
    """Per-channel sums (C,) of an NCHW tensor: the bias gradient
    (reference Conv2dReduceSum.py)."""

    def __init__(self, node_A, ctx=None):
        super().__init__(Conv2dReduceSumOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return input_vals[0].sum(dim=(0, 2, 3))

    def gradient(self, output_grad):
        return [conv2d_broadcastto_op(output_grad, self.inputs[0],
                                      ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return (input_shapes[0][1],)


def conv2d_op(node_A, node_B, padding=0, stride=1, ctx=None):
    return Conv2dOp(node_A, node_B, padding=padding, stride=stride, ctx=ctx)


def conv2d_gradient_of_data_op(node_filter, node_grad, node_data=None,
                               padding=0, stride=1, ctx=None):
    return Conv2dGradientOfDataOp(node_filter, node_grad, node_data,
                                  padding=padding, stride=stride, ctx=ctx)


def conv2d_gradient_of_filter_op(input_X, gradient_Y, node_filter=None,
                                 padding=0, stride=1, ctx=None):
    return Conv2dGradientOfFilterOp(input_X, gradient_Y, node_filter,
                                    padding=padding, stride=stride, ctx=ctx)


def max_pool2d_op(node_A, kernel_H, kernel_W, padding=0, stride=1, ctx=None):
    return MaxPool2dOp(node_A, kernel_H, kernel_W, padding, stride, ctx=ctx)


def max_pool2d_gradient_op(node_out, node_out_gradient, node_in, kernel_H,
                           kernel_W, padding=0, stride=1, ctx=None):
    return MaxPool2dGradientOp(node_out, node_out_gradient, node_in,
                               kernel_H, kernel_W, padding, stride, ctx=ctx)


def avg_pool2d_op(node_A, kernel_H, kernel_W, padding=0, stride=1, ctx=None):
    return AvgPool2dOp(node_A, kernel_H, kernel_W, padding, stride, ctx=ctx)


def avg_pool2d_gradient_op(node_out, node_out_gradient, node_in, kernel_H,
                           kernel_W, padding=0, stride=1, ctx=None):
    return AvgPool2dGradientOp(node_out, node_out_gradient, node_in,
                               kernel_H, kernel_W, padding, stride, ctx=ctx)


def conv2d_broadcastto_op(node_A, node_B, ctx=None):
    return Conv2dBroadcastToOp(node_A, node_B, ctx=ctx)


def conv2d_reducesum_op(node_A, ctx=None):
    return Conv2dReduceSumOp(node_A, ctx=ctx)
