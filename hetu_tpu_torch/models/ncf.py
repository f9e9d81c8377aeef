"""Neural Collaborative Filtering (counterpart of ``hetu_tpu/models/ncf.py``;
reference parity: examples/rec/hetu_ncf.py:7-47).

NeuMF = GMF + MLP over shared user/item embedding tables: each table is
``[n, embed_dim + layers[0]//2]`` wide, sliced into the GMF factor (first
``embed_dim`` columns, elementwise product) and the MLP factor (the rest,
concatenated through the tower). The tables live on the device; placing
them on ``ht.cpu(0)`` (``embed_ctx``, the reference's PS and Hybrid
placement) raises until the PS port.
"""
from __future__ import annotations

from .. import initializers as init
from ..optimizer import SGDOptimizer
from ..ops import (binarycrossentropy_op, concat_op, embedding_lookup_op,
                   matmul_op, mul_op, reduce_mean_op, relu_op, sigmoid_op,
                   slice_op)
from .ctr import check_embed_ctx

__all__ = ["neural_mf", "ML25M_USERS", "ML25M_ITEMS"]

# MovieLens cardinalities (reference run_hetu.py:103-107)
ML1M_USERS, ML1M_ITEMS = 6040, 3706
ML20M_USERS, ML20M_ITEMS = 138493, 26744
ML25M_USERS, ML25M_ITEMS = 162541, 59047


def neural_mf(user_input, item_input, y_, num_users, num_items,
              embed_dim=8, layers=(64, 32, 16, 8), learning_rate=0.01,
              embed_ctx=None, opt=None):
    """Build NeuMF; returns ``(loss, y, train_op)``.

    ``user_input``/``item_input`` are ``[B]`` int id nodes, ``y_`` is the
    ``[B, 1]`` implicit-feedback label. ``layers`` is the MLP tower
    (``layers[0]//2`` is each side's MLP embedding width).
    """
    check_embed_ctx(embed_ctx)
    mlp_dim = layers[0] // 2
    width = embed_dim + mlp_dim
    user_embedding = init.random_normal(
        (num_users, width), stddev=0.01, name="user_embed", ctx=embed_ctx)
    item_embedding = init.random_normal(
        (num_items, width), stddev=0.01, name="item_embed", ctx=embed_ctx)

    user_latent = embedding_lookup_op(user_embedding, user_input,
                                      ctx=embed_ctx)
    item_latent = embedding_lookup_op(item_embedding, item_input,
                                      ctx=embed_ctx)

    mf_user = slice_op(user_latent, (0, 0), (-1, embed_dim))
    mlp_user = slice_op(user_latent, (0, embed_dim), (-1, -1))
    mf_item = slice_op(item_latent, (0, 0), (-1, embed_dim))
    mlp_item = slice_op(item_latent, (0, embed_dim), (-1, -1))

    mf_vector = mul_op(mf_user, mf_item)
    x = concat_op(mlp_user, mlp_item, axis=1)
    for i, (din, dout) in enumerate(zip(layers[:-1], layers[1:])):
        w = init.random_normal((din, dout), stddev=0.1, name=f"ncf_W{i+1}")
        x = relu_op(matmul_op(x, w))

    concat_vector = concat_op(mf_vector, x, axis=1)
    w_out = init.random_normal((embed_dim + layers[-1], 1), stddev=0.1,
                               name=f"ncf_W{len(layers)}")
    y = sigmoid_op(matmul_op(concat_vector, w_out))
    loss = reduce_mean_op(binarycrossentropy_op(y, y_), [0])
    if opt is None:
        opt = SGDOptimizer(learning_rate=learning_rate)
    train_op = opt.minimize(loss)
    return loss, y, train_op
