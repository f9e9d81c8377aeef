"""Graph neural network layers and models (counterpart of
``hetu_tpu/models/gnn.py``; reference: examples/gnn/gnn_model/
{layer,model}.py).

``GCN`` and ``SageConv`` are the reference's layer classes; ``gcn`` and
``graphsage`` build its two-layer node classifier (masked
cross-entropy, SGD). The normalized adjacency is a CSR feed (a
placeholder fed an ``ND_Sparse_Array`` or a ``CSRValue``, or a
``GNNDataLoaderOp``), and message passing is ``csrmm_op``. Parameter
names are the reference's, so checkpoints move between the packages.
"""
from __future__ import annotations

from .. import initializers as init
from ..ops import (broadcastto_op, concat_op, csrmm_op, dropout_op,
                   matmul_op, mul_op, reduce_mean_op, relu_op,
                   softmaxcrossentropy_op)
from ..ops.variable import Variable

__all__ = ["GCN", "SageConv", "gcn_layer", "gcn", "graphsage"]


def _activate(x, activation):
    if activation == "relu":
        return relu_op(x)
    if activation is not None:
        raise NotImplementedError(f"activation {activation!r}")
    return x


class GCN:
    """Graph convolution: x -> norm_adj @ (x W + b) (reference
    layer.py:5-35). ``custom_init`` = (weight, bias) arrays."""

    def __init__(self, in_features, out_features, norm_adj, activation=None,
                 dropout=0, name="GCN", custom_init=None):
        if custom_init is not None:
            self.weight = Variable(name + "_Weight", value=custom_init[0])
            self.bias = Variable(name + "_Bias", value=custom_init[1])
        else:
            self.weight = init.xavier_uniform(
                shape=(in_features, out_features), name=name + "_Weight")
            self.bias = init.zeros(shape=(out_features,),
                                   name=name + "_Bias")
        self.mp = norm_adj
        self.activation = activation
        self.dropout = dropout
        self.output_width = out_features

    def __call__(self, x):
        if self.dropout > 0:
            x = dropout_op(x, 1 - self.dropout)
        x = matmul_op(x, self.weight)
        msg = x + broadcastto_op(self.bias, x)
        return _activate(csrmm_op(self.mp, msg), self.activation)


class SageConv:
    """GraphSAGE convolution: concat(relu(adj @ x W + b), x W2)
    (reference layer.py:38-69). ``custom_init`` is accepted and unused,
    as in the reference."""

    def __init__(self, in_features, out_features, norm_adj, activation=None,
                 dropout=0, name="Sage", custom_init=None):
        self.weight = init.xavier_uniform(shape=(in_features, out_features),
                                          name=name + "_Weight")
        self.bias = init.zeros(shape=(out_features,), name=name + "_Bias")
        self.weight2 = init.xavier_uniform(
            shape=(in_features, out_features), name=name + "_Weight2")
        self.mp = norm_adj
        self.activation = activation
        self.dropout = dropout
        self.output_width = 2 * out_features

    def __call__(self, x):
        feat = x
        if self.dropout > 0:
            x = dropout_op(x, 1 - self.dropout)
        x = csrmm_op(self.mp, x)
        x = matmul_op(x, self.weight)
        x = _activate(x + broadcastto_op(self.bias, x), self.activation)
        return concat_op(x, matmul_op(feat, self.weight2), axis=1)


def gcn_layer(x, in_features, out_features, norm_adj, activation=None,
              name="GCN"):
    return GCN(in_features, out_features, norm_adj, activation=activation,
               name=name)(x)


def _node_classifier(feat, y_, mask_, norm_adj, feature_dim,
                     hidden_layer_size, num_classes, lr, arch):
    """Two ``arch`` layers and a linear classifier (reference
    model.py:42-63): (per-node loss, logits, SGD train op of the loss
    averaged under the mask)."""
    from ..optimizer import SGDOptimizer
    l1 = arch(feature_dim, hidden_layer_size, norm_adj, activation="relu",
              name="gnn_l1")
    l2 = arch(l1.output_width, hidden_layer_size, norm_adj,
              activation="relu", name="gnn_l2")
    classifier = init.xavier_uniform(shape=(l2.output_width, num_classes),
                                     name="gnn_classifier")
    y = matmul_op(l2(l1(feat)), classifier)
    loss = softmaxcrossentropy_op(y, y_)
    train_loss = reduce_mean_op(mul_op(loss, mask_), [0])
    train_op = SGDOptimizer(lr).minimize(train_loss)
    return loss, y, train_op


def gcn(feat, y_, mask_, norm_adj, feature_dim, hidden_layer_size,
        num_classes, lr=0.1):
    return _node_classifier(feat, y_, mask_, norm_adj, feature_dim,
                            hidden_layer_size, num_classes, lr, GCN)


def graphsage(feat, y_, mask_, norm_adj, feature_dim, hidden_layer_size,
              num_classes, lr=0.1):
    return _node_classifier(feat, y_, mask_, norm_adj, feature_dim,
                            hidden_layer_size, num_classes, lr, SageConv)
