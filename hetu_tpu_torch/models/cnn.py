"""CNN/RNN model zoo (counterpart of ``hetu_tpu/models/cnn.py``;
reference parity: examples/cnn/models/*.py).

All builders follow the reference convention ``model(x, y_) -> (loss, y)``
where ``x`` / ``y_`` are placeholder (or dataloader) nodes. Shapes mirror
the reference: MNIST models take (N, 784), CIFAR models take
(N, 3, 32, 32) NCHW, labels are one-hot (N, classes). Parameter names
are the reference's, so both packages draw the same weights.
"""
from __future__ import annotations

from .. import initializers as init
from ..ops import (add_op, array_reshape_op, avg_pool2d_op,
                   batch_normalization_op, broadcastto_op, conv2d_op,
                   dropout_op, matmul_op, max_pool2d_op, mul_op, pad_op,
                   reduce_mean_op, relu_op, sigmoid_op, slice_op,
                   softmaxcrossentropy_op, tanh_op)

__all__ = ["logreg", "mlp", "cnn_3_layers", "digits_cnn", "lenet",
           "alexnet", "vgg16", "vgg19", "resnet18", "resnet34", "rnn",
           "lstm"]


def fc(x, shape, name, with_relu=True):
    """Linear layer (reference examples/cnn/models/MLP.py:5-13)."""
    weight = init.random_normal(shape=shape, stddev=0.1, name=name + "_weight")
    bias = init.random_normal(shape=shape[-1:], stddev=0.1,
                              name=name + "_bias")
    x = matmul_op(x, weight)
    x = x + broadcastto_op(bias, x)
    if with_relu:
        x = relu_op(x)
    return x


def conv2d(x, in_channel, out_channel, kernel=3, stride=1, padding=1,
           name=""):
    weight = init.random_normal(
        shape=(out_channel, in_channel, kernel, kernel), stddev=0.1,
        name=name + "_weight")
    return conv2d_op(x, weight, stride=stride, padding=padding)


def conv_bn_relu(x, in_channel, out_channel, name):
    weight = init.random_normal(
        shape=(out_channel, in_channel, 3, 3), stddev=0.1,
        name=name + "_weight")
    bn_scale = init.random_normal(
        shape=(1, out_channel, 1, 1), stddev=0.1, name=name + "_scale")
    bn_bias = init.random_normal(
        shape=(1, out_channel, 1, 1), stddev=0.1, name=name + "_bias")
    x = conv2d_op(x, weight, padding=1, stride=1)
    x = batch_normalization_op(x, bn_scale, bn_bias)
    return relu_op(x)


# ---------------------------------------------------------------------------
# simple models
# ---------------------------------------------------------------------------

def logreg(x, y_, input_dim=784, num_classes=10):
    """Logistic regression on MNIST (reference models/LogReg.py)."""
    weight = init.zeros((input_dim, num_classes), name="logreg_weight")
    bias = init.zeros((num_classes,), name="logreg_bias")
    y = matmul_op(x, weight)
    y = y + broadcastto_op(bias, y)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


def mlp(x, y_, input_dim=3072, num_classes=10):
    """3-layer MLP (reference models/MLP.py; CIFAR10 default dims)."""
    x = fc(x, (input_dim, 256), "mlp_fc1")
    x = fc(x, (256, 256), "mlp_fc2")
    y = fc(x, (256, num_classes), "mlp_fc3", with_relu=False)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


def cnn_3_layers(x, y_):
    """3-conv CNN on MNIST (reference models/CNN.py): 32f5 -> 64f5 -> fc."""
    x = array_reshape_op(x, (-1, 1, 28, 28))
    x = conv2d(x, 1, 32, kernel=5, padding=2, name="cnn3_conv1")
    x = relu_op(x)
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = conv2d(x, 32, 64, kernel=5, padding=2, name="cnn3_conv2")
    x = relu_op(x)
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = array_reshape_op(x, (-1, 7 * 7 * 64))
    y = fc(x, (7 * 7 * 64, 10), "cnn3_fc", with_relu=False)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


def digits_cnn(x, y_):
    """Conv net for the checked-in REAL 8x8 digit images (ht.data.digits):
    32f3 -> pool -> 64f3 -> pool -> fc. The real-image conv accuracy
    workload that runs without a network (full MNIST needs the IDX
    files dropped into HETU_DATA_DIR — the loader reads them,
    data.py:mnist)."""
    x = array_reshape_op(x, (-1, 1, 8, 8))
    x = conv2d(x, 1, 32, kernel=3, padding=1, name="dcnn_conv1")
    x = relu_op(x)
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = conv2d(x, 32, 64, kernel=3, padding=1, name="dcnn_conv2")
    x = relu_op(x)
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = array_reshape_op(x, (-1, 2 * 2 * 64))
    x = fc(x, (2 * 2 * 64, 128), "dcnn_fc1")
    y = fc(x, (128, 10), "dcnn_fc2", with_relu=False)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


def lenet(x, y_):
    """LeNet-5 on MNIST (reference models/LeNet.py)."""
    x = array_reshape_op(x, (-1, 1, 28, 28))
    x = conv2d(x, 1, 6, kernel=5, padding=2, name="lenet_conv1")
    x = relu_op(x)
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = conv2d(x, 6, 16, kernel=5, padding=0, name="lenet_conv2")
    x = relu_op(x)
    x = max_pool2d_op(x, 2, 2, stride=2)
    x = array_reshape_op(x, (-1, 16 * 5 * 5))
    x = fc(x, (16 * 5 * 5, 120), "lenet_fc1")
    x = fc(x, (120, 84), "lenet_fc2")
    y = fc(x, (84, 10), "lenet_fc3", with_relu=False)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


def alexnet(x, y_):
    """AlexNet sized for CIFAR10 32x32 (reference models/AlexNet.py)."""
    x = conv2d(x, 3, 64, kernel=5, padding=2, name="alexnet_conv1")
    x = relu_op(x)
    x = max_pool2d_op(x, 3, 3, padding=1, stride=2)
    x = conv2d(x, 64, 192, kernel=5, padding=2, name="alexnet_conv2")
    x = relu_op(x)
    x = max_pool2d_op(x, 3, 3, padding=1, stride=2)
    x = conv2d(x, 192, 384, kernel=3, padding=1, name="alexnet_conv3")
    x = relu_op(x)
    x = conv2d(x, 384, 256, kernel=3, padding=1, name="alexnet_conv4")
    x = relu_op(x)
    x = conv2d(x, 256, 256, kernel=3, padding=1, name="alexnet_conv5")
    x = relu_op(x)
    x = max_pool2d_op(x, 3, 3, padding=1, stride=2)
    x = array_reshape_op(x, (-1, 256 * 4 * 4))
    x = fc(x, (256 * 4 * 4, 1024), "alexnet_fc1")
    x = dropout_op(x, 0.5)
    x = fc(x, (1024, 512), "alexnet_fc2")
    x = dropout_op(x, 0.5)
    y = fc(x, (512, 10), "alexnet_fc3", with_relu=False)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

_VGG_PLANS = {
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


def _vgg(x, y_, depth):
    """VGG for CIFAR10 (reference models/VGG.py)."""
    plan = _VGG_PLANS[depth]
    channels = (64, 128, 256, 512, 512)
    in_c = 3
    for stage, (reps, out_c) in enumerate(zip(plan, channels)):
        for i in range(reps):
            x = conv_bn_relu(x, in_c, out_c,
                             name=f"vgg_conv{stage + 1}_{i + 1}")
            in_c = out_c
        x = max_pool2d_op(x, 2, 2, stride=2)
    x = array_reshape_op(x, (-1, 512))
    x = fc(x, (512, 4096), "vgg_fc1")
    x = fc(x, (4096, 4096), "vgg_fc2")
    y = fc(x, (4096, 10), "vgg_fc3", with_relu=False)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


def vgg16(x, y_):
    return _vgg(x, y_, 16)


def vgg19(x, y_):
    return _vgg(x, y_, 19)


# ---------------------------------------------------------------------------
# ResNet (pre-activation, reference models/ResNet.py)
# ---------------------------------------------------------------------------

def _bn_relu(x, channels, name):
    scale = init.random_normal(shape=(1, channels, 1, 1), stddev=0.1,
                               name=name + "_scale")
    bias = init.random_normal(shape=(1, channels, 1, 1), stddev=0.1,
                              name=name + "_bias")
    return relu_op(batch_normalization_op(x, scale, bias))


def _resnet_block(x, in_channel, num_blocks, is_first=False, name=""):
    if is_first:
        out_channel = in_channel
        identity = x
        x = conv2d(x, in_channel, out_channel, name=name + "_conv1")
        x = _bn_relu(x, out_channel, name + "_bn1")
        x = conv2d(x, out_channel, out_channel, name=name + "_conv2")
        x = x + identity
    else:
        out_channel = 2 * in_channel
        identity = x
        x = _bn_relu(x, in_channel, name + "_bn0")
        x = pad_op(x, [[0, 0], [0, 0], [0, 1], [0, 1]])
        x = conv2d(x, in_channel, out_channel, stride=2, padding=0,
                   name=name + "_conv1")
        x = _bn_relu(x, out_channel, name + "_bn1")
        x = conv2d(x, out_channel, out_channel, name=name + "_conv2")
        identity = avg_pool2d_op(identity, 2, 2, padding=0, stride=2)
        identity = pad_op(identity, [[0, 0],
                                     [in_channel // 2, in_channel // 2],
                                     [0, 0], [0, 0]])
        x = x + identity
    for i in range(1, num_blocks):
        identity = x
        x = _bn_relu(x, out_channel, name + f"_bn{2 * i}")
        x = conv2d(x, out_channel, out_channel,
                   name=name + f"_conv{2 * i + 1}")
        x = _bn_relu(x, out_channel, name + f"_bn{2 * i + 1}")
        x = conv2d(x, out_channel, out_channel,
                   name=name + f"_conv{2 * i + 2}")
        x = x + identity
    return x


def _resnet(x, y_, num_layers, num_class=10):
    base = 16
    x = conv2d(x, 3, base, name="resnet_init_conv")
    x = _bn_relu(x, base, "resnet_init_bn")
    if num_layers == 18:
        blocks = (2, 2, 2)
    elif num_layers == 34:
        blocks = (5, 5, 5)
    else:
        raise ValueError(f"unsupported resnet depth {num_layers}")
    x = _resnet_block(x, base, blocks[0], is_first=True, name="resnet_b1")
    x = _resnet_block(x, base, blocks[1], name="resnet_b2")
    x = _resnet_block(x, 2 * base, blocks[2], name="resnet_b3")
    x = _bn_relu(x, 4 * base, "resnet_final_bn")
    x = array_reshape_op(x, (-1, 64 * 8 * 8))
    y = fc(x, (64 * 8 * 8, num_class), "resnet_fc", with_relu=False)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


def resnet18(x, y_):
    return _resnet(x, y_, 18)


def resnet34(x, y_):
    return _resnet(x, y_, 34)


# ---------------------------------------------------------------------------
# recurrent models on MNIST rows (reference models/RNN.py, models/LSTM.py)
# ---------------------------------------------------------------------------

def rnn(x, y_, diminput=28, dimhidden=128, dimoutput=10, nsteps=28):
    """Elman RNN over MNIST rows, the graph unrolled over the rows as in
    the reference (models/RNN.py)."""
    w_ih = init.random_normal((diminput, dimhidden), stddev=0.1,
                              name="rnn_w_ih")
    w_hh = init.random_normal((dimhidden, dimhidden), stddev=0.1,
                              name="rnn_w_hh")
    b_h = init.random_normal((dimhidden,), stddev=0.1, name="rnn_b_h")
    w_out = init.random_normal((dimhidden, dimoutput), stddev=0.1,
                               name="rnn_w_out")
    b_out = init.random_normal((dimoutput,), stddev=0.1, name="rnn_b_out")

    h = None
    for t in range(nsteps):
        xt = slice_op(x, (0, t * diminput), (-1, diminput))
        pre = matmul_op(xt, w_ih)
        pre = pre + broadcastto_op(b_h, pre)
        if h is not None:
            pre = pre + matmul_op(h, w_hh)
        h = tanh_op(pre)
    y = matmul_op(h, w_out)
    y = y + broadcastto_op(b_out, y)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y


def lstm(x, y_, diminput=28, dimhidden=128, dimoutput=10, nsteps=28):
    """LSTM over MNIST rows (reference models/LSTM.py)."""
    def gate_params(gname):
        return (init.random_normal((diminput, dimhidden), stddev=0.1,
                                   name=f"lstm_{gname}_w"),
                init.random_normal((dimhidden, dimhidden), stddev=0.1,
                                   name=f"lstm_{gname}_u"),
                init.random_normal((dimhidden,), stddev=0.1,
                                   name=f"lstm_{gname}_b"))

    fw, fu, fb = gate_params("forget_gate")
    iw, iu, ib = gate_params("input_gate")
    ow, ou, ob = gate_params("output_gate")
    cw, cu, cb = gate_params("tanh")
    w_out = init.random_normal((dimhidden, dimoutput), stddev=0.1,
                               name="lstm_out_weight")
    b_out = init.random_normal((dimoutput,), stddev=0.1, name="lstm_out_bias")

    h = c = None

    def gate(xt, w, u, b, act):
        pre = matmul_op(xt, w)
        pre = pre + broadcastto_op(b, pre)
        if h is not None:
            pre = pre + matmul_op(h, u)
        return act(pre)

    for t in range(nsteps):
        xt = slice_op(x, (0, t * diminput), (-1, diminput))
        f = gate(xt, fw, fu, fb, sigmoid_op)
        i = gate(xt, iw, iu, ib, sigmoid_op)
        o = gate(xt, ow, ou, ob, sigmoid_op)
        g = gate(xt, cw, cu, cb, tanh_op)
        c = mul_op(i, g) if c is None else add_op(mul_op(f, c),
                                                  mul_op(i, g))
        h = mul_op(o, tanh_op(c))
    y = matmul_op(h, w_out)
    y = y + broadcastto_op(b_out, y)
    loss = reduce_mean_op(softmaxcrossentropy_op(y, y_), [0])
    return loss, y
