"""Shared pieces of the port's parallel-config zoo (counterpart of
``examples/runner/parallel/common.py``): fixed weights so that every
config trains the same model, the loss series logged to
``results/*.npy``, and ``validate_results.py`` holding each against the
base run.

A config is one process of the port's launcher; ``device(i)`` is the
i-th device it drives: ``ht.gpu(i)`` where CUDA is available (every
``gpu(i)`` of a one-card host is that card), else ``ht.cpu(i)``. The
executor runs a context or a tuple stage of several such devices as
one thread rank a device.

The weights are the JAX package's zoo weights, drawn by the same
``RandomState`` draws in the same order (its ``ensure_std``), so both
packages start from the same values; they are made in memory and
written to ``std/`` beside this file only by ``--save``.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", "..", ".."))

import torch                                            # noqa: E402

import hetu_tpu_torch as ht                             # noqa: E402

STD = os.path.join(HERE, "std")
RESULTS = os.path.join(HERE, "results")

DIMS = dict(in_dim=784, hidden1=256, special=512, out_dim=10)

_MLP_SPECS = {
    "mlp_fc1_weight": (DIMS["in_dim"], DIMS["hidden1"]),
    "mlp_fc1_bias": (DIMS["hidden1"],),
    "special_weight": (DIMS["hidden1"], DIMS["special"]),
    "mlp_fc2_weight": (DIMS["special"], DIMS["out_dim"]),
    "mlp_fc2_bias": (DIMS["out_dim"],),
}
_CNN_SPECS = {
    "cnn_conv1_weight": (32, 1, 5, 5),
    "special_cnn_weight": (32, 32, 5, 5),
    "cnn_fc_weight": (32 * 7 * 7, 10),
    "cnn_fc_bias": (10,),
}
_weights = {}


def device(i):
    """The i-th device of this process: the card where there is one,
    else the CPU."""
    return ht.gpu(i) if torch.cuda.is_available() else ht.cpu(i)


def _draw(specs, seed, scale):
    rng = np.random.RandomState(seed)
    return {name: (rng.randn(*shape) * scale).astype(np.float32)
            for name, shape in specs.items()}


def _weights_of():
    if not _weights:
        _weights.update(_draw(_MLP_SPECS, 42, 0.05))
        _weights.update(_draw(_CNN_SPECS, 43, 0.04))
    return _weights


def ensure_std(force=False):
    """With ``force`` (the scripts' ``--save``), write the MLP weights to
    ``std/`` for inspection; training never reads the files."""
    _write(_MLP_SPECS, force)


def ensure_cnn_std(force=False):
    """As :func:`ensure_std`, for the CNN zoo's weights."""
    _write(_CNN_SPECS, force)


def _write(specs, force):
    if not force:
        return
    os.makedirs(STD, exist_ok=True)
    for name in specs:
        np.save(os.path.join(STD, name + ".npy"), _weights_of()[name])


def load_std(name):
    return _weights_of()[name].copy()


def conv_relu(x, name, ctx=None):
    """5x5/pad2 conv + relu from the fixed weights (reference
    test_model_cnn_base.py conv_relu)."""
    w = ht.Variable(name, value=load_std(name), ctx=ctx)
    return ht.relu_op(ht.conv2d_op(x, w, padding=2, stride=1))


# conv split vocabulary -> (data parts, filter parts) over NCHW x OIHW:
# 'left' batch-splits the data, 'right' splits the filter's output
# channels, 'middle' splits the contracted input channels on both
CNN_SPLITS = {
    "left": ((2, 1, 1, 1), (1, 1, 1, 1)),
    "right": ((1, 1, 1, 1), (2, 1, 1, 1)),
    "middle": ((1, 2, 1, 1), (1, 2, 1, 1)),
}


def fc(x, name, with_relu=True, ctx=None):
    """Linear layer from the fixed weights (reference
    test_mlp_mp_pp.py:8-17)."""
    weight = ht.Variable(name + "_weight", value=load_std(name + "_weight"),
                         ctx=ctx)
    bias = ht.Variable(name + "_bias", value=load_std(name + "_bias"),
                       ctx=ctx)
    x = ht.matmul_op(x, weight)
    x = x + ht.broadcastto_op(bias, x)
    if with_relu:
        x = ht.relu_op(x)
    return x


def batches(batch_size=64, batch_num=5, seed=7):
    """Deterministic MNIST-shaped batches (the MNIST files when present,
    ``ht.data.mnist()``'s stand-in otherwise: the same arrays as the JAX
    package's zoo)."""
    (tx, ty), _, _ = ht.data.mnist()
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(tx))[:batch_size * batch_num]
    xs = tx[idx].reshape(batch_num, batch_size, -1)
    ys = ty[idx].reshape(batch_num, batch_size, -1)
    return xs, ys


def train_and_log(executor, x, y_, steps, log_path, batch_size=64):
    """Run ``steps`` steps over the fixed batches; save the loss series
    (the artifact validate_results.py compares)."""
    xs, ys = batches(batch_size=batch_size)
    losses = []
    for i in range(steps):
        out = executor.run(feed_dict={x: xs[i % len(xs)],
                                      y_: ys[i % len(ys)]})
        losses.append(float(np.asarray(out[0].asnumpy()).reshape(())))
    print("losses:", [round(v, 6) for v in losses])
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                    exist_ok=True)
        np.save(log_path, np.asarray(losses))
    executor.close()
    return losses


# the reference's split vocabulary -> (activation parts, weight parts)
# for y = a @ w (test_mlp_mp_pp.py:66-89): 'left' row-splits the batch,
# 'right' col-splits the weight, 'middle' splits the contraction dim,
# '0'-'4' are the 4-way composites
SPLITS = {
    "left": ((2, 1), (1, 1)),
    "right": ((1, 1), (1, 2)),
    "middle": ((1, 2), (2, 1)),
    "0": ((4, 1), (1, 1)),
    "1": ((2, 2), (2, 1)),
    "2": ((2, 1), (1, 2)),
    "3": ((1, 2), (2, 2)),
    "4": ((1, 1), (1, 4)),
}
