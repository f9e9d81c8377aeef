"""BERT family — the layer utilities so far.

Counterpart of the layer utilities of ``hetu_tpu/models/bert.py``
(reference: examples/nlp/bert/hetu_bert.py:700-745), which the GPT
graph model builds on: ``_act``, ``Embedding``, ``BertLayerNorm``,
``Dropout`` and ``Linear``. ``BertConfig``, the BERT modules and the
pre-training heads come with the BERT training slice, and with them
``dropout_op`` (per-op generators): until then a ``Dropout`` with a
nonzero rate raises.
"""
from __future__ import annotations

from .. import initializers as init
from ..ops import (array_reshape_op, broadcastto_op, embedding_lookup_op,
                   gelu_op, layer_normalization_op, matmul_op, relu_op,
                   tanh_op)

__all__ = ["Embedding", "BertLayerNorm", "Dropout", "Linear"]


def _act(name):
    return {"relu": relu_op, "gelu": gelu_op, "tanh": tanh_op}[name]


class Embedding:
    def __init__(self, num_embeddings, embedding_dim, name=None,
                 initializer=init.xavier_normal):
        self.weight = initializer(name=name,
                                  shape=(num_embeddings, embedding_dim))

    def __call__(self, input_tensor):
        return embedding_lookup_op(self.weight, input_tensor)


class BertLayerNorm:
    def __init__(self, hidden_size, eps=1e-12, name="layer_norm"):
        self.eps = eps
        self.scale = init.ones(name=name + "_scale", shape=(hidden_size,))
        self.bias = init.zeros(name=name + "_bias", shape=(hidden_size,))

    def __call__(self, x):
        return layer_normalization_op(x, self.scale, self.bias, eps=self.eps)


class Dropout:
    def __init__(self, dropout_prob=None):
        self.dropout_prob = dropout_prob

    def __call__(self, x):
        if not self.dropout_prob:
            return x
        raise NotImplementedError(
            "dropout_op is not ported yet (it comes with the BERT training "
            "slice): use hidden_dropout_prob=0.0")


class Linear:
    """Dense layer over the trailing dim; >2D inputs collapse to 2D for
    the matmul and are restored afterwards (reference
    hetu_bert.py:719-745)."""

    def __init__(self, in_features, out_features, bias=True, activation=None,
                 kernel_initializer=init.xavier_normal,
                 bias_initializer=init.zeros, name="dense"):
        self.activation = activation
        self.in_features = in_features
        self.out_features = out_features
        self.weights = kernel_initializer(name=name + "_weights",
                                          shape=(in_features, out_features))
        self.bias = (bias_initializer(name=name + "_bias",
                                      shape=(out_features,))
                     if bias else None)

    def __call__(self, x, restore_shape=None):
        if restore_shape is not None:
            x = array_reshape_op(x, [-1, self.in_features])
        out = matmul_op(x, self.weights)
        if self.bias is not None:
            out = out + broadcastto_op(self.bias, out)
        if self.activation is not None:
            out = self.activation(out)
        if restore_shape is not None:
            out = array_reshape_op(
                out, list(restore_shape[:-1]) + [self.out_features])
        return out
