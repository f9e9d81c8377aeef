"""CTR models (counterpart of ``hetu_tpu/models/ctr.py``; reference
parity: examples/ctr/models/): Wide & Deep on Criteo and on Adult,
DeepFM, Deep & Cross and Deep Crossing.

Builders keep the reference's ``model(dense_input, sparse_input, y_) ->
(loss, y, y_, train_op)`` convention, its Criteo dimensions as defaults
and its parameter names, so both packages draw the same initial values.
``embed_ctx`` places the tables' ops, as in the reference: with
``ht.cpu(0)`` and an executor in ``comm_mode="PS"`` or ``"Hybrid"`` the
tables live on the parameter server (or its device cache); without a
PS mode they stay on the device.
"""
from __future__ import annotations

from .. import initializers as init
from ..optimizer import SGDOptimizer
from ..ops import (array_reshape_op, binarycrossentropy_op, broadcastto_op,
                   concat_op, embedding_lookup_op, matmul_op, mul_op,
                   reduce_mean_op, reduce_sum_op, relu_op, sigmoid_op,
                   softmaxcrossentropy_op)

__all__ = ["wdl_criteo", "wdl_adult", "deepfm_criteo", "dcn_criteo",
           "dc_criteo"]

CRITEO_SPARSE_SLOTS = 26
CRITEO_DENSE_DIM = 13
CRITEO_FEATURE_DIM = 33762577


def _dnn(x, dims, name="W"):
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = init.random_normal([din, dout], stddev=0.01,
                               name=f"{name}{i + 1}")
        x = matmul_op(x, w)
        if i < len(dims) - 2:
            x = relu_op(x)
    return x


def _bce_sgd(y, y_, learning_rate):
    loss = reduce_mean_op(binarycrossentropy_op(y, y_), [0])
    train_op = SGDOptimizer(learning_rate=learning_rate).minimize(loss)
    return loss, y, y_, train_op


def _embedded(sparse_input, feature_dimension, embedding_size, embed_ctx):
    """The ``snd_order_embedding`` rows of every slot, flattened to
    ``[B, 26 * embedding_size]``."""
    embedding = init.random_normal([feature_dimension, embedding_size],
                                   stddev=0.01, name="snd_order_embedding",
                                   ctx=embed_ctx)
    sparse = embedding_lookup_op(embedding, sparse_input, ctx=embed_ctx)
    return array_reshape_op(sparse,
                            (-1, CRITEO_SPARSE_SLOTS * embedding_size))


def wdl_criteo(dense_input, sparse_input, y_,
               feature_dimension=CRITEO_FEATURE_DIM, embedding_size=128,
               learning_rate=0.01, embed_ctx=None):
    """Wide & Deep on Criteo (reference wdl_criteo.py)."""
    sparse = _embedded(sparse_input, feature_dimension, embedding_size,
                       embed_ctx)
    deep = _dnn(dense_input, [CRITEO_DENSE_DIM, 256, 256, 256])
    wide_deep = concat_op(sparse, deep, axis=1)
    w4 = init.random_normal(
        [256 + CRITEO_SPARSE_SLOTS * embedding_size, 1], stddev=0.01,
        name="W4")
    return _bce_sgd(sigmoid_op(matmul_op(wide_deep, w4)), y_, learning_rate)


def wdl_adult(dense_input, sparse_input, y_, learning_rate=5e-5):
    """Wide & Deep on the Adult census set (reference wdl_adult.py):
    8 categorical slots, 6 dense features, 2-class softmax head."""
    n_slot, n_dense, embedding_size = 8, 6, 8
    embedding = init.random_normal([50000, embedding_size], stddev=0.1,
                                   name="wide_embedding")
    sparse = embedding_lookup_op(embedding, sparse_input)
    sparse = array_reshape_op(sparse, (-1, n_slot * embedding_size))
    x = concat_op(sparse, dense_input, axis=1)
    y = _dnn(x, [n_slot * embedding_size + n_dense, 50, 50, 2],
             name="adult_W")
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    train_op = SGDOptimizer(learning_rate=learning_rate).minimize(loss)
    return loss, y, y_, train_op


def deepfm_criteo(dense_input, sparse_input, y_,
                  feature_dimension=CRITEO_FEATURE_DIM, embedding_size=128,
                  learning_rate=0.01, embed_ctx=None):
    """DeepFM (reference deepfm_criteo.py): 1st-order + FM 2nd-order +
    DNN over shared embeddings."""
    embedding1 = init.random_normal([feature_dimension, 1], stddev=0.01,
                                    name="fst_order_embedding",
                                    ctx=embed_ctx)
    fm_w = init.random_normal([CRITEO_DENSE_DIM, 1], stddev=0.01,
                              name="dense_parameter")
    sparse_1dim = embedding_lookup_op(embedding1, sparse_input,
                                      ctx=embed_ctx)
    y1 = matmul_op(dense_input, fm_w) + reduce_sum_op(sparse_1dim, [1])

    embedding2 = init.random_normal([feature_dimension, embedding_size],
                                    stddev=0.01,
                                    name="snd_order_embedding",
                                    ctx=embed_ctx)
    sparse_2dim = embedding_lookup_op(embedding2, sparse_input,
                                      ctx=embed_ctx)
    sum_sq = reduce_sum_op(sparse_2dim, [1])
    sum_sq = mul_op(sum_sq, sum_sq)
    sq_sum = reduce_sum_op(mul_op(sparse_2dim, sparse_2dim), [1])
    y2 = reduce_sum_op((sum_sq + -1 * sq_sum) * 0.5, [1], keepdims=True)

    flatten = array_reshape_op(
        sparse_2dim, (-1, CRITEO_SPARSE_SLOTS * embedding_size))
    y3 = _dnn(flatten, [CRITEO_SPARSE_SLOTS * embedding_size, 256, 256, 1])
    return _bce_sgd(sigmoid_op(y1 + y2 + y3), y_, learning_rate)


def _cross_layer(x0, x1, embedding_len, name):
    """One DCN cross layer: y = x0 * (x1 w) + b + x1 (dcn_criteo.py:8-19)."""
    weight = init.random_normal(shape=(embedding_len, 1), stddev=0.01,
                                name=name + "_weight")
    bias = init.random_normal(shape=(embedding_len,), stddev=0.01,
                              name=name + "_bias")
    x1w = matmul_op(x1, weight)
    y = mul_op(x0, broadcastto_op(x1w, x0))
    return y + x1 + broadcastto_op(bias, y)


def dcn_criteo(dense_input, sparse_input, y_,
               feature_dimension=CRITEO_FEATURE_DIM, embedding_size=128,
               learning_rate=0.003, num_cross_layers=3, embed_ctx=None):
    """Deep & Cross (reference dcn_criteo.py)."""
    sparse = _embedded(sparse_input, feature_dimension, embedding_size,
                       embed_ctx)
    x = concat_op(sparse, dense_input, axis=1)
    embedding_len = CRITEO_SPARSE_SLOTS * embedding_size + CRITEO_DENSE_DIM

    cross = x
    for i in range(num_cross_layers):
        cross = _cross_layer(x, cross, embedding_len, f"cross{i + 1}")

    deep = _dnn(x, [embedding_len, 256, 256, 256])
    y4 = concat_op(cross, deep, axis=1)
    w4 = init.random_normal([256 + embedding_len, 1], stddev=0.01,
                            name="W4")
    return _bce_sgd(sigmoid_op(matmul_op(y4, w4)), y_, learning_rate)


def dc_criteo(dense_input, sparse_input, y_,
              feature_dimension=CRITEO_FEATURE_DIM, embedding_size=128,
              learning_rate=0.001, embed_ctx=None):
    """Deep Crossing (reference dc_criteo.py): residual MLP units over the
    concatenated embedding."""
    sparse = _embedded(sparse_input, feature_dimension, embedding_size,
                       embed_ctx)
    x = concat_op(sparse, dense_input, axis=1)
    input_dim = CRITEO_SPARSE_SLOTS * embedding_size + CRITEO_DENSE_DIM

    def residual_unit(h, hidden, name):
        w1 = init.random_normal([input_dim, hidden], stddev=0.01,
                                name=name + "_w1")
        w2 = init.random_normal([hidden, input_dim], stddev=0.01,
                                name=name + "_w2")
        out = relu_op(matmul_op(h, w1))
        return relu_op(matmul_op(out, w2) + h)

    h = residual_unit(x, 256, "dc_res1")
    h = residual_unit(h, 256, "dc_res2")
    w_out = init.random_normal([input_dim, 1], stddev=0.01, name="dc_out")
    return _bce_sgd(sigmoid_op(matmul_op(h, w_out)), y_, learning_rate)
