"""Analysis targets: the model zoo's training graphs with canonical feed
shapes.

Counterpart of ``hetu_tpu/analysis/zoo.py``. Each builder constructs a
small training instance of a zoo model of the port and returns
``(eval_nodes, feed_shapes)``, the graph and its fully shaped feeds;
the same builder of the JAX package, at the same names, draws the same
initial weights (both packages draw a parameter from its name and the
session's seed). The auto-planner's snapshot test plans these graphs
against the committed CostDB fixture.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ZOO", "build"]

ZOO = {}


def _register(name):
    def deco(fn):
        ZOO[name] = fn
        return fn
    return deco


def build(name):
    """(eval_nodes, feed_shapes) for a registered zoo model."""
    return ZOO[name]()


def _xy(xshape, num_classes=10):
    import hetu_tpu_torch as ht
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    return x, y_, {x: (tuple(xshape), np.float32),
                   y_: ((xshape[0], num_classes), np.float32)}


def _train(model_fn, xshape, num_classes=10):
    import hetu_tpu_torch as ht
    x, y_, feeds = _xy(xshape, num_classes)
    loss, _y = model_fn(x, y_)
    train_op = ht.optim.SGDOptimizer(learning_rate=0.01).minimize(loss)
    return [loss, train_op], feeds


@_register("logreg")
def _logreg():
    from ..models import logreg
    return _train(logreg, (8, 784))


@_register("mlp")
def _mlp():
    from ..models import mlp
    return _train(mlp, (8, 3072))


@_register("cnn_3_layers")
def _cnn():
    from ..models import cnn_3_layers
    return _train(cnn_3_layers, (4, 784))


@_register("lenet")
def _lenet():
    from ..models import lenet
    return _train(lenet, (4, 784))


@_register("alexnet")
def _alexnet():
    from ..models import alexnet
    return _train(alexnet, (2, 3, 32, 32))


@_register("vgg16")
def _vgg16():
    from ..models import vgg16
    return _train(vgg16, (2, 3, 32, 32))


@_register("resnet18")
def _resnet18():
    from ..models import resnet18
    return _train(resnet18, (2, 3, 32, 32))


@_register("rnn")
def _rnn():
    from ..models import rnn
    return _train(rnn, (4, 784))


@_register("lstm")
def _lstm():
    from ..models import lstm
    return _train(lstm, (4, 784))


@_register("bert_tiny")
def _bert_tiny():
    import hetu_tpu_torch as ht
    from ..models import BertConfig, BertForPreTraining
    bs, sl = 4, 16
    config = BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=16)
    model = BertForPreTraining(config)
    ids = ht.Variable("input_ids", trainable=False)
    tok = ht.Variable("token_type_ids", trainable=False)
    mask = ht.Variable("attention_mask", trainable=False)
    mlm = ht.Variable("masked_lm_labels", trainable=False)
    nsp = ht.Variable("next_sentence_label", trainable=False)
    _, _, mlm_loss, nsp_loss = model(ids, tok, mask, mlm, nsp)
    loss = ht.reduce_mean_op(mlm_loss, [0, 1]) + \
        ht.reduce_mean_op(nsp_loss, [0])
    train_op = ht.optim.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    feeds = {ids: ((bs, sl), np.int32), tok: ((bs, sl), np.int32),
             mask: ((bs, sl), np.float32), mlm: ((bs, sl), np.int32),
             nsp: ((bs,), np.int32)}
    return [loss, train_op], feeds


@_register("gpt_tiny")
def _gpt_tiny():
    import hetu_tpu_torch as ht
    from ..models import GPTConfig, GPTLMHeadModel
    bs, sl = 2, 16
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=8, max_position_embeddings=sl,
                    hidden_dropout_prob=0.0)
    model = GPTLMHeadModel(cfg)
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _logits, loss = model(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    train_op = ht.optim.AdamOptimizer(1e-3).minimize(lm)
    return [lm, train_op], {ids: ((bs, sl), np.int32),
                            labels: ((bs, sl), np.int64)}


@_register("wdl_adult")
def _wdl_adult():
    import hetu_tpu_torch as ht
    from ..models.ctr import wdl_adult
    dense = ht.Variable("dense_input", trainable=False)
    sparse = ht.Variable("sparse_input", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    loss, _y, y_, train_op = wdl_adult(dense, sparse, y_)
    return [loss, train_op], {dense: ((16, 6), np.float32),
                              sparse: ((16, 8), np.int32),
                              y_: ((16, 2), np.float32)}


@_register("ncf")
def _ncf():
    import hetu_tpu_torch as ht
    from ..models import neural_mf
    user = ht.Variable("user_input", trainable=False)
    item = ht.Variable("item_input", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    loss, _y, train_op = neural_mf(user, item, y_, num_users=50,
                                   num_items=80)
    return [loss, train_op], {user: ((16,), np.int32),
                              item: ((16,), np.int32),
                              y_: ((16, 1), np.float32)}


@_register("gcn")
def _gcn():
    import hetu_tpu_torch as ht
    from ..models import gcn
    n, fdim, ncls = 40, 12, 3
    feat = ht.Variable("feat", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    mask_ = ht.Variable("mask_", trainable=False)
    norm_adj = ht.Variable("norm_adj", trainable=False)
    loss, _y, train_op = gcn(feat, y_, mask_, norm_adj, fdim, 16, ncls)
    return ([ht.reduce_mean_op(loss, [0]), train_op],
            {feat: ((n, fdim), np.float32), y_: ((n, ncls), np.float32),
             mask_: ((n,), np.float32), norm_adj: ((n, n), np.float32)})
