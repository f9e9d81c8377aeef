"""Layer normalization (counterpart of ``hetu_tpu/ops/norm.py``;
reference: gpu_ops/LayerNorm.py). As in the reference, one packed
gradient op computes ``(dx, dscale, dbias)`` in closed form and three
readers unpack it. The variance is the population variance (jnp.var;
torch's default is the unbiased one). Batch and instance norm come with
the CNN slice."""
from __future__ import annotations

import torch

from ..graph.node import Op

__all__ = ["layer_normalization_op", "layer_normalization_gradient_op",
           "layer_normalization_gradient_of_data_op",
           "layer_normalization_gradient_of_scale_op",
           "layer_normalization_gradient_of_bias_op"]


def _normalize(x, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    return (x - mean) * inv, inv


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
