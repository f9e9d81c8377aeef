"""Batch, layer and instance normalization (counterpart of
``hetu_tpu/ops/norm.py``; reference: gpu_ops/{BatchNorm,LayerNorm,
InstanceNorm2d}.py). As in the reference, one packed gradient op
computes ``(dx, dscale, dbias)`` of a batch or layer norm in closed form
and three readers unpack it. Every variance is the population variance
(jnp.var; torch's default is the unbiased one), also in batch norm's
running statistics.

Batch norm's running statistics are op state: in training ``compute``
normalizes over the batch (N, H, W) and writes
``running = momentum * running + (1 - momentum) * batch`` through
``ectx.put_state`` (momentum 0.99 keeps 99% of the old value: the
opposite of ``torch.nn.BatchNorm2d``'s ``momentum``); in inference it
normalizes with the running statistics ``ectx.get_state`` gives it.
The executor initializes them to mean 0 and variance 1 and threads them
between steps. ``eps`` is 0.01 unless given, and scale and bias may be
shaped ``(C,)`` or ``(1, C, 1, 1)``. The three forward ops define
``infer_range``, their interval rule for the numerics verifier
(``analysis/numerics.py``)."""
from __future__ import annotations

import math

import torch

from ..graph.node import Op

__all__ = ["batch_normalization_op", "batch_normalization_gradient_op",
           "batch_normalization_gradient_of_data_op",
           "batch_normalization_gradient_of_scale_op",
           "batch_normalization_gradient_of_bias_op",
           "instance_normalization2d_op",
           "instance_normalization2d_gradient_op",
           "layer_normalization_op", "layer_normalization_gradient_op",
           "layer_normalization_gradient_of_data_op",
           "layer_normalization_gradient_of_scale_op",
           "layer_normalization_gradient_of_bias_op"]


_NCHW_STAT_AXES = (0, 2, 3)


def _bcast_c(v):
    """A per-channel (C,) or (1, C, 1, 1) value shaped to broadcast over
    NCHW."""
    return v.reshape(1, -1, 1, 1)


def _inv_std(var, eps):
    return torch.reciprocal(torch.sqrt(var + eps))


def _norm_range(n, scale_range, bias_range):
    """A value standardized over ``n`` samples has |x - mean| / std <=
    sqrt(n - 1), so the affine output is bounded by sqrt(n) * |scale| +
    |bias| whatever the input's range (eps > 0 keeps the rsqrt finite;
    eps <= 0 is HT804's)."""
    if scale_range is None:
        return None
    k = math.sqrt(float(max(n, 1)))
    sm = max(abs(scale_range[0]), abs(scale_range[1]))
    bm = 0.0 if bias_range is None else max(abs(bias_range[0]),
                                            abs(bias_range[1]))
    m = k * sm + bm
    return (-m, m)


def _normalize(x, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    inv = _inv_std(var, eps)
    return (x - mean) * inv, inv


class BatchNormalizationOp(Op):
    stateful = True

    def __init__(self, node_in, bn_scale, bn_bias, momentum=0.99, eps=0.01,
                 ctx=None):
        super().__init__(BatchNormalizationOp,
                         [node_in, bn_scale, bn_bias], ctx)
        self.momentum = momentum
        self.eps = eps

    def state_shapes(self, input_shapes):
        c = input_shapes[0][1]
        return {"running_mean": (c,), "running_var": (c,)}

    def compute(self, input_vals, ectx):
        x, scale, bias = input_vals
        state = ectx.get_state(self)
        if ectx.training:
            var, mean = torch.var_mean(x, dim=_NCHW_STAT_AXES, correction=0)
            if state is not None:
                m = self.momentum
                ectx.put_state(self, {
                    "running_mean": m * state["running_mean"] + (1 - m) * mean,
                    "running_var": m * state["running_var"] + (1 - m) * var,
                })
        elif state is None:
            raise RuntimeError(f"{self.name}: batch norm in inference needs "
                               f"its running statistics")
        else:
            mean, var = state["running_mean"], state["running_var"]
        a = _inv_std(var, self.eps) * scale.reshape(-1)
        return torch.addcmul(_bcast_c(bias), x - _bcast_c(mean), _bcast_c(a))

    def gradient(self, output_grad):
        packed = batch_normalization_gradient_op(
            output_grad, self.inputs[0], self.inputs[1], self, self.eps,
            ctx=self.raw_ctx)
        return [
            batch_normalization_gradient_of_data_op(packed, self.inputs[0],
                                                    ctx=self.raw_ctx),
            batch_normalization_gradient_of_scale_op(packed, self.inputs[1],
                                                     ctx=self.raw_ctx),
            batch_normalization_gradient_of_bias_op(packed, self.inputs[2],
                                                    ctx=self.raw_ctx),
        ]

    def infer_shape(self, input_shapes):
        return input_shapes[0]

    def infer_range(self, input_ranges, input_shapes=None):
        n = 1
        if input_shapes and input_shapes[0] and len(input_shapes[0]) == 4:
            s = input_shapes[0]
            n = s[0] * s[2] * s[3]
        return _norm_range(n, input_ranges[1], input_ranges[2])


class BatchNormalizationGradientOp(Op):
    """Packed ``(dx, dscale, dbias)``: the closed-form backward over the
    batch statistics (reference BatchNorm.py:96-159)."""

    def __init__(self, out_gradient, in_node, bn_scale, forward_node, eps,
                 ctx=None):
        super().__init__(BatchNormalizationGradientOp,
                         [out_gradient, in_node, bn_scale], ctx)
        self.forward_node = forward_node
        self.eps = eps

    def compute(self, input_vals, ectx):
        dy, x, scale = input_vals
        n = x.shape[0] * x.shape[2] * x.shape[3]
        var, mean = torch.var_mean(x, dim=_NCHW_STAT_AXES, correction=0)
        inv = _inv_std(var, self.eps)
        xhat = (x - _bcast_c(mean)) * _bcast_c(inv)
        dbias = dy.sum(dim=_NCHW_STAT_AXES)
        dscale = (dy * xhat).sum(dim=_NCHW_STAT_AXES)
        dx = _bcast_c(scale.reshape(-1) * inv / n) * (
            n * dy - _bcast_c(dbias) - xhat * _bcast_c(dscale))
        return (dx, dscale, dbias)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class InstanceNormalization2dOp(Op):
    """Each (N, C) plane normalized over its H x W values; no affine."""

    def __init__(self, node_in, eps=0.01, ctx=None):
        super().__init__(InstanceNormalization2dOp, [node_in], ctx)
        self.eps = eps

    def compute(self, input_vals, ectx):
        x = input_vals[0]
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
        return (x - mean) * _inv_std(var, self.eps)

    def gradient(self, output_grad):
        return [instance_normalization2d_gradient_op(
            output_grad, self.inputs[0], self, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]

    def infer_range(self, input_ranges, input_shapes=None):
        n = 1
        if input_shapes and input_shapes[0] and len(input_shapes[0]) == 4:
            n = input_shapes[0][2] * input_shapes[0][3]
        return _norm_range(n, (1.0, 1.0), None)


class InstanceNormalization2dGradientOp(Op):
    def __init__(self, out_gradient, in_node, forward_node, ctx=None):
        super().__init__(InstanceNormalization2dGradientOp,
                         [out_gradient, in_node], ctx)
        self.forward_node = forward_node

    def compute(self, input_vals, ectx):
        dy, x = input_vals
        n = x.shape[2] * x.shape[3]
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
        inv = _inv_std(var, self.forward_node.eps)
        xhat = (x - mean) * inv
        dsum = dy.sum(dim=(2, 3), keepdim=True)
        ddot = (dy * xhat).sum(dim=(2, 3), keepdim=True)
        return inv / n * (n * dy - dsum - xhat * ddot)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[1]


class LayerNormalizationOp(Op):
    def __init__(self, node_in, ln_scale, ln_bias, eps=0.01, ctx=None):
        super().__init__(LayerNormalizationOp,
                         [node_in, ln_scale, ln_bias], ctx)
        self.eps = eps

    def compute(self, input_vals, ectx):
        x, scale, bias = input_vals
        return _normalize(x, self.eps)[0] * scale + bias

    def gradient(self, output_grad):
        packed = layer_normalization_gradient_op(
            output_grad, self.inputs[0], self.inputs[1], self, self.eps,
            ctx=self.raw_ctx)
        return [
            layer_normalization_gradient_of_data_op(packed, self.inputs[0],
                                                    ctx=self.raw_ctx),
            layer_normalization_gradient_of_scale_op(packed, self.inputs[1],
                                                     ctx=self.raw_ctx),
            layer_normalization_gradient_of_bias_op(packed, self.inputs[2],
                                                    ctx=self.raw_ctx),
        ]

    def infer_shape(self, input_shapes):
        return input_shapes[0]

    def infer_range(self, input_ranges, input_shapes=None):
        n = 1
        if input_shapes and input_shapes[0]:
            n = input_shapes[0][-1]
        return _norm_range(n, input_ranges[1], input_ranges[2])


class LayerNormalizationGradientOp(Op):
    def __init__(self, out_gradient, in_node, ln_scale, forward_node, eps,
                 ctx=None):
        super().__init__(LayerNormalizationGradientOp,
                         [out_gradient, in_node, ln_scale], ctx)
        self.forward_node = forward_node
        self.eps = eps

    def compute(self, input_vals, ectx):
        dy, x, scale = input_vals
        d = x.shape[-1]
        xhat, inv = _normalize(x, self.eps)
        reduce_axes = tuple(range(x.dim() - 1))
        dscale = (dy * xhat).sum(dim=reduce_axes)
        dbias = dy.sum(dim=reduce_axes)
        dxhat = dy * scale
        dx = inv / d * (
            d * dxhat
            - dxhat.sum(dim=-1, keepdim=True)
            - xhat * (dxhat * xhat).sum(dim=-1, keepdim=True))
        return (dx, dscale, dbias)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class _PackedIndexOp(Op):
    """Reads one part of a packed gradient, shaped like ``like_node``."""

    idx = None

    def __init__(self, op_type, packed, like_node, ctx=None):
        super().__init__(op_type, [packed, like_node], ctx)

    def compute(self, input_vals, ectx):
        return input_vals[0][self.idx].reshape(input_vals[1].shape)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[1]


class BatchNormalizationGradientOfDataOp(_PackedIndexOp):
    idx = 0

    def __init__(self, bn_gradient, in_arr, ctx=None):
        super().__init__(BatchNormalizationGradientOfDataOp, bn_gradient,
                         in_arr, ctx=ctx)


class BatchNormalizationGradientOfScaleOp(_PackedIndexOp):
    idx = 1

    def __init__(self, bn_gradient, in_scale, ctx=None):
        super().__init__(BatchNormalizationGradientOfScaleOp, bn_gradient,
                         in_scale, ctx=ctx)


class BatchNormalizationGradientOfBiasOp(_PackedIndexOp):
    idx = 2

    def __init__(self, bn_gradient, in_bias, ctx=None):
        super().__init__(BatchNormalizationGradientOfBiasOp, bn_gradient,
                         in_bias, ctx=ctx)


class LayerNormalizationGradientOfDataOp(_PackedIndexOp):
    idx = 0

    def __init__(self, ln_gradient, in_arr, ctx=None):
        super().__init__(LayerNormalizationGradientOfDataOp, ln_gradient,
                         in_arr, ctx=ctx)


class LayerNormalizationGradientOfScaleOp(_PackedIndexOp):
    idx = 1

    def __init__(self, ln_gradient, in_scale, ctx=None):
        super().__init__(LayerNormalizationGradientOfScaleOp, ln_gradient,
                         in_scale, ctx=ctx)


class LayerNormalizationGradientOfBiasOp(_PackedIndexOp):
    idx = 2

    def __init__(self, ln_gradient, in_bias, ctx=None):
        super().__init__(LayerNormalizationGradientOfBiasOp, ln_gradient,
                         in_bias, ctx=ctx)


def batch_normalization_op(node_in, bn_scale, bn_bias, momentum=0.99,
                           eps=0.01, ctx=None):
    return BatchNormalizationOp(node_in, bn_scale, bn_bias,
                                momentum=momentum, eps=eps, ctx=ctx)


def batch_normalization_gradient_op(out_gradient, in_node, bn_scale,
                                    forward_node, eps, ctx=None):
    return BatchNormalizationGradientOp(out_gradient, in_node, bn_scale,
                                        forward_node, eps, ctx=ctx)


def batch_normalization_gradient_of_data_op(bn_gradient, in_arr, ctx=None):
    return BatchNormalizationGradientOfDataOp(bn_gradient, in_arr, ctx=ctx)


def batch_normalization_gradient_of_scale_op(bn_gradient, in_scale,
                                             ctx=None):
    return BatchNormalizationGradientOfScaleOp(bn_gradient, in_scale,
                                               ctx=ctx)


def batch_normalization_gradient_of_bias_op(bn_gradient, in_bias, ctx=None):
    return BatchNormalizationGradientOfBiasOp(bn_gradient, in_bias, ctx=ctx)


def instance_normalization2d_op(node_in, eps=0.01, ctx=None):
    return InstanceNormalization2dOp(node_in, eps=eps, ctx=ctx)


def instance_normalization2d_gradient_op(out_gradient, in_node, forward_node,
                                         ctx=None):
    return InstanceNormalization2dGradientOp(out_gradient, in_node,
                                             forward_node, ctx=ctx)


def layer_normalization_op(node_in, ln_scale, ln_bias, eps=0.01, ctx=None):
    return LayerNormalizationOp(node_in, ln_scale, ln_bias, eps=eps, ctx=ctx)


def layer_normalization_gradient_op(out_gradient, in_node, ln_scale,
                                    forward_node, eps, ctx=None):
    return LayerNormalizationGradientOp(out_gradient, in_node, ln_scale,
                                        forward_node, eps, ctx=ctx)


def layer_normalization_gradient_of_data_op(ln_gradient, in_arr, ctx=None):
    return LayerNormalizationGradientOfDataOp(ln_gradient, in_arr, ctx=ctx)


def layer_normalization_gradient_of_scale_op(ln_gradient, in_scale,
                                             ctx=None):
    return LayerNormalizationGradientOfScaleOp(ln_gradient, in_scale,
                                               ctx=ctx)


def layer_normalization_gradient_of_bias_op(ln_gradient, in_bias, ctx=None):
    return LayerNormalizationGradientOfBiasOp(ln_gradient, in_bias, ctx=ctx)
