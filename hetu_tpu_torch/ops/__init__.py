"""The port's ops: graph-op builders (reference-named ``*_op``, the CSR
products of ``sparse.py`` among them) and the attention kernels'
wrappers (``flash_attention``, ``_build``)."""
from .activations import (dropout2d_gradient_op, dropout2d_op,
                          dropout_gradient_op, dropout_op, gelu_gradient_op,
                          gelu_op, leaky_relu_gradient_op, leaky_relu_op,
                          relu_gradient_op, relu_op, sigmoid_op, sign_op,
                          softmax_func, softmax_gradient_op, softmax_op,
                          tanh_op)
from .attention import FlashAttentionOp, flash_attention_op
from .basic import (abs_op, add_op, addbyconst_op, cast_op, clip_mask_op,
                    clip_op, div_const_op, div_handle_zero_op, div_op,
                    erf_op, exp_op, log_op, matrix_dot_op, mul_byconst_op,
                    mul_op, one_hot_op, opposite_op, power_op, rsqrt_op,
                    sqrt_op, where_op)
from .conv import (avg_pool2d_gradient_op, avg_pool2d_op,
                   conv2d_broadcastto_op, conv2d_gradient_of_data_op,
                   conv2d_gradient_of_filter_op, conv2d_op,
                   conv2d_reducesum_op, max_pool2d_gradient_op,
                   max_pool2d_op)
from .embedding import embedding_lookup_gradient_op, embedding_lookup_op
from .linalg import batch_matmul_op, matmul_op
from .losses import (binarycrossentropy_gradient_op,
                     binarycrossentropy_op, crossentropy_op,
                     softmaxcrossentropy_gradient_op,
                     softmaxcrossentropy_op,
                     softmaxcrossentropy_sparse_gradient_op,
                     softmaxcrossentropy_sparse_op)
from .norm import (batch_normalization_gradient_of_bias_op,
                   batch_normalization_gradient_of_data_op,
                   batch_normalization_gradient_of_scale_op,
                   batch_normalization_gradient_op, batch_normalization_op,
                   instance_normalization2d_gradient_op,
                   instance_normalization2d_op,
                   layer_normalization_gradient_of_bias_op,
                   layer_normalization_gradient_of_data_op,
                   layer_normalization_gradient_of_scale_op,
                   layer_normalization_gradient_op, layer_normalization_op)
from .shape import (array_reshape_gradient_op, array_reshape_op,
                    broadcast_shape_grad_source_op, broadcast_shape_op,
                    broadcastto_op, concat_gradient_op, concat_op,
                    concatenate_op, flatten_op, oneslike_op, pad_gradient_op,
                    pad_op, reduce_mean_op, reduce_sum_op,
                    reducesumaxiszero_op, slice_gradient_op, slice_op,
                    split_gradient_op, split_op, squeeze_op, transpose_op,
                    unbroadcast_op, unsqueeze_op, zeroslike_op)
from .sparse import csrmm_op, csrmv_op, distgcn_15d_op
from .variable import PlaceholderOp, Variable, placeholder_op

__all__ = [
    "Variable", "placeholder_op", "PlaceholderOp",
    "add_op", "addbyconst_op", "mul_op", "mul_byconst_op", "opposite_op",
    "div_op", "div_const_op", "div_handle_zero_op", "sqrt_op", "rsqrt_op",
    "erf_op", "exp_op", "log_op", "abs_op", "power_op", "where_op",
    "one_hot_op", "matrix_dot_op", "cast_op", "clip_op", "clip_mask_op",
    "array_reshape_op", "array_reshape_gradient_op", "broadcastto_op",
    "unbroadcast_op", "split_op", "split_gradient_op", "slice_op",
    "slice_gradient_op", "transpose_op", "concat_op", "concat_gradient_op",
    "concatenate_op", "pad_op", "pad_gradient_op",
    "reduce_sum_op", "reduce_mean_op", "broadcast_shape_grad_source_op",
    "squeeze_op", "oneslike_op", "zeroslike_op", "broadcast_shape_op",
    "flatten_op", "unsqueeze_op", "reducesumaxiszero_op",
    "matmul_op", "batch_matmul_op",
    "relu_op", "relu_gradient_op", "leaky_relu_op", "leaky_relu_gradient_op",
    "sigmoid_op", "tanh_op", "gelu_op", "gelu_gradient_op", "sign_op",
    "softmax_func", "softmax_op", "softmax_gradient_op",
    "dropout_op", "dropout_gradient_op", "dropout2d_op",
    "dropout2d_gradient_op",
    "conv2d_op", "conv2d_gradient_of_data_op",
    "conv2d_gradient_of_filter_op", "max_pool2d_op",
    "max_pool2d_gradient_op", "avg_pool2d_op", "avg_pool2d_gradient_op",
    "conv2d_broadcastto_op", "conv2d_reducesum_op",
    "batch_normalization_op", "batch_normalization_gradient_op",
    "batch_normalization_gradient_of_data_op",
    "batch_normalization_gradient_of_scale_op",
    "batch_normalization_gradient_of_bias_op",
    "instance_normalization2d_op", "instance_normalization2d_gradient_op",
    "layer_normalization_op", "layer_normalization_gradient_op",
    "layer_normalization_gradient_of_data_op",
    "layer_normalization_gradient_of_scale_op",
    "layer_normalization_gradient_of_bias_op",
    "embedding_lookup_op", "embedding_lookup_gradient_op",
    "softmaxcrossentropy_op", "softmaxcrossentropy_gradient_op",
    "softmaxcrossentropy_sparse_op",
    "softmaxcrossentropy_sparse_gradient_op", "binarycrossentropy_op",
    "binarycrossentropy_gradient_op", "crossentropy_op",
    "flash_attention_op", "FlashAttentionOp",
    "csrmm_op", "csrmv_op", "distgcn_15d_op",
]
