"""The port's ops: graph-op builders (reference-named ``*_op``) and the
attention kernels' wrappers (``flash_attention``, ``_build``)."""
from .activations import (gelu_gradient_op, gelu_op, relu_gradient_op,
                          relu_op, tanh_op)
from .attention import FlashAttentionOp, flash_attention_op
from .basic import (add_op, addbyconst_op, mul_byconst_op, mul_op,
                    opposite_op)
from .embedding import embedding_lookup_gradient_op, embedding_lookup_op
from .linalg import matmul_op
from .losses import (softmaxcrossentropy_sparse_gradient_op,
                     softmaxcrossentropy_sparse_op)
from .norm import (layer_normalization_gradient_of_bias_op,
                   layer_normalization_gradient_of_data_op,
                   layer_normalization_gradient_of_scale_op,
                   layer_normalization_gradient_op, layer_normalization_op)
from .shape import (array_reshape_gradient_op, array_reshape_op,
                    broadcast_shape_grad_source_op, broadcastto_op,
                    oneslike_op, reduce_mean_op, reduce_sum_op,
                    split_gradient_op, split_op, squeeze_op, transpose_op,
                    unbroadcast_op, zeroslike_op)
from .variable import PlaceholderOp, Variable, placeholder_op

__all__ = [
    "Variable", "placeholder_op", "PlaceholderOp",
    "add_op", "addbyconst_op", "mul_op", "mul_byconst_op", "opposite_op",
    "array_reshape_op", "array_reshape_gradient_op", "broadcastto_op",
    "unbroadcast_op", "split_op", "split_gradient_op", "transpose_op",
    "reduce_sum_op", "reduce_mean_op", "broadcast_shape_grad_source_op",
    "squeeze_op", "oneslike_op", "zeroslike_op",
    "matmul_op",
    "relu_op", "relu_gradient_op", "tanh_op", "gelu_op", "gelu_gradient_op",
    "layer_normalization_op", "layer_normalization_gradient_op",
    "layer_normalization_gradient_of_data_op",
    "layer_normalization_gradient_of_scale_op",
    "layer_normalization_gradient_of_bias_op",
    "embedding_lookup_op", "embedding_lookup_gradient_op",
    "softmaxcrossentropy_sparse_op",
    "softmaxcrossentropy_sparse_gradient_op",
    "flash_attention_op", "FlashAttentionOp",
]
