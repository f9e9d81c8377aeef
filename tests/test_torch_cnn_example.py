"""The port's CNN entry point, ``hetu_tpu_torch.examples.cnn_main``,
trained to the reference's accuracy bars on the checked-in real digits
(``datasets/digits.npz``) on the CPU, with the settings of
tests/test_accuracy.py: logistic regression >= 0.92 held-out accuracy,
``digits_cnn`` >= 0.96.

The ``cuda``-marked test runs one VGG-16 training step (full width, B=8)
on the card and on the CPU from the same weights and batch. It imports
neither JAX nor hetu_tpu, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cnn_example.py

Tolerances there: the loss within 1e-4 relative; the first convolution's
weight gradient and the first batch norm's scale gradient within 1e-3 of
their largest element (cuDNN's algorithms and its atomics in the weight
gradient sum in another order than the CPU's).
"""
import numpy as np
import pytest
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.examples import cnn_main


def _run(*argv):
    return cnn_main.run(cnn_main.parse_args(
        ["--dataset", "DIGITS", "--validate", "--batch-size", "64",
         "--num-epochs", "25", "--device", "cpu", *argv]))


def test_logreg_digits_accuracy():
    results = _run("--model", "logreg", "--learning-rate", "0.5")
    assert results["val_acc"] >= 0.92, results


def test_cnn_digits_real_accuracy():
    results = _run("--model", "digits_cnn", "--learning-rate", "0.002",
                   "--opt", "adam", "--timing")
    assert results["val_acc"] >= 0.96, results
    assert results["epoch_time"] > 0


def test_parse_args_refuses_an_unknown_model():
    with pytest.raises(AssertionError, match="not supported"):
        cnn_main.parse_args(["--model", "gpt", "--dataset", "DIGITS"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _vgg16_step(device, x, y):
    px = ht.Variable("x", trainable=False)
    py = ht.Variable("y_", trainable=False)
    loss, _ = ht.models.vgg16(px, py)
    opt = ht.optim.MomentumOptimizer(0.1)
    train = opt.minimize(loss)
    pick = [i for i, p in enumerate(opt.params)
            if p.name in ("vgg_conv1_1_weight", "vgg_conv1_1_scale")]
    exe = ht.Executor([loss] + [train.inputs[i] for i in pick] + [train],
                      device=device)
    out = exe.run(feed_dict={px: x, py: y})
    return [o.asnumpy() for o in out[:-1]]


@pytest.mark.cuda
def test_vgg16_step_on_the_card_matches_the_cpu(cuda):
    rng = np.random.RandomState(0)
    x = rng.rand(8, 3, 32, 32).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)]
    got = _vgg16_step(cuda, x, y)
    want = _vgg16_step("cpu", x, y)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()
