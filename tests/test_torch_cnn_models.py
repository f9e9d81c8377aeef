"""The CNN/RNN zoo: every builder of ``models/cnn.py`` trained 3 steps in
hetu_tpu and in the port on the CPU from the same weights (both packages
draw them from numpy, seeded by parameter name) and the same numpy
batches.

Tolerances, relative on the losses: 1e-5, and 1e-4 for the models with
13 or more batch norms (VGG-16, VGG-19, ResNet-34), where float32
differences in the batch statistics compound over the layers (measured:
at most 8.0e-07 without them, 5.0e-06 on VGG-16). Batch-norm running
statistics after the steps: rtol 1e-4, atol 1e-5.

AlexNet has dropout 0.5 hard-coded in its training graph. The two
packages draw dropout masks from different generators (``jax.random``
against ``torch.Generator``), so their training losses differ by design;
AlexNet's ``validate`` subgraph (no dropout) is compared instead, and
its training loss must fall over 16 steps on one batch at lr 2e-5,
whatever dropout masks the process-wide op counter gives.
"""
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM

STEPS = 3
MNIST, CIFAR = (784,), (3, 32, 32)
# builder: (input shape, batch, learning rate, loss rtol). The rates keep
# every loss finite over the steps from the zoo's stddev-0.1 weights; each
# step trains on a batch of its own
MODELS = {
    "logreg": (MNIST, 8, 0.1, 1e-5),
    "mlp": ((3072,), 8, 0.01, 1e-5),
    "cnn_3_layers": (MNIST, 4, 1e-3, 1e-5),
    "digits_cnn": ((64,), 8, 0.01, 1e-5),
    "lenet": (MNIST, 4, 1e-3, 1e-5),
    "vgg16": (CIFAR, 4, 1e-3, 1e-4),
    "vgg19": (CIFAR, 4, 1e-3, 1e-4),
    "resnet18": (CIFAR, 4, 1e-3, 1e-5),
    "resnet34": (CIFAR, 4, 1e-3, 1e-4),
    "rnn": (MNIST, 4, 0.01, 1e-5),
    "lstm": (MNIST, 4, 0.01, 1e-5),
}
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
# AlexNet's training loss is held at a rate at which it learns
ALEXNET_LR, ALEXNET_STEPS = 2e-5, 16


def _batches(shape, batch, steps, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.rand(steps, batch, *shape).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.randint(0, 10, (steps, batch))]
    return xs, ys


def _session(ht, models, name, opt):
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    loss, y = getattr(models, name)(x, y_)
    train = opt.minimize(loss)
    nodes = {"train": [loss, train], "validate": [loss, y]}
    kw = {"ctx": tht.cpu(0)} if ht is tht else {}
    return ht.Executor(nodes, **kw), x, y_


def _scalar(value):
    return float(np.asarray(value.asnumpy()).reshape(-1)[0])


def _train(ht, models, name, opt, xs, ys, subgraph="train"):
    exe, x, y_ = _session(ht, models, name, opt)
    losses = [_scalar(exe.run(subgraph, feed_dict={x: xb, y_: yb})[0])
              for xb, yb in zip(xs, ys)]
    return exe, losses


def _state_in_creation_order(exe):
    """Op state as [{key: array}] by ascending op id (how the port's
    load_state matches the two packages' stateful ops)."""
    return [{k: np.asarray(v) for k, v in exe.state[key].items()}
            for key in sorted(exe.state, key=int)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_builder_trains_like_the_reference(name):
    shape, batch, lr, rtol = MODELS[name]
    xs, ys = _batches(shape, batch, STEPS)
    jexe, jl = _train(jht, JM, name, jht.optim.SGDOptimizer(lr), xs, ys)
    texe, tl = _train(tht, TM, name, tht.optim.SGDOptimizer(lr), xs, ys)
    assert np.all(np.isfinite(tl)), tl
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=0)
    jstate, tstate = (_state_in_creation_order(e) for e in (jexe, texe))
    assert len(tstate) == len(jstate)
    for j, t in zip(jstate, tstate):
        assert sorted(t) == sorted(j) == ["running_mean", "running_var"]
        for k in j:
            np.testing.assert_allclose(t[k], j[k], **STATE_TOL)
    # inference over the trained weights and state
    vj = jexe.run("validate", feed_dict={_feeds(jexe)[0]: xs[0],
                                         _feeds(jexe)[1]: ys[0]})
    vt = texe.run("validate", feed_dict={_feeds(texe)[0]: xs[0],
                                         _feeds(texe)[1]: ys[0]})
    np.testing.assert_allclose(_scalar(vt[0]), _scalar(vj[0]), rtol=rtol)


def _feeds(exe):
    sub = exe.subexecutors["validate"]
    by_name = {n.name: n for n in sub.feed_nodes}
    return by_name["x"], by_name["y_"]


def test_alexnet_validate_matches_and_training_loss_falls():
    xs, ys = _batches(CIFAR, 4, STEPS)
    _, jl = _train(jht, JM, "alexnet", jht.optim.SGDOptimizer(1e-8), xs,
                   ys, "validate")
    texe, tl = _train(tht, TM, "alexnet", tht.optim.SGDOptimizer(1e-8), xs,
                      ys, "validate")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # training under dropout 0.5: the masks come from generators seeded
    # by op id, a process-wide counter, so they depend on how many ops
    # the process made before. At a rate at which AlexNet learns, one
    # batch trained ALEXNET_STEPS times loses most of its loss whatever
    # the masks (the mean of the last quarter was at most 0.32 of the
    # first's over 12 counter offsets, 0 to 12345)
    texe, x, y_ = _session(tht, TM, "alexnet",
                           tht.optim.SGDOptimizer(ALEXNET_LR))
    train = [_scalar(texe.run("train", feed_dict={x: xs[0], y_: ys[0]})[0])
             for _ in range(ALEXNET_STEPS)]
    quarter = ALEXNET_STEPS // 4
    assert np.all(np.isfinite(train)), train
    assert np.mean(train[-quarter:]) < np.mean(train[:quarter]), train


def test_vgg16_diverges_at_lr_0_1_like_the_reference():
    """VGG-16 from the zoo's stddev-0.1 weights with MomentumOptimizer at
    examples/cnn/main.py's default rate 0.1 diverges, in the reference as
    in the port: the loss grows a hundredfold within three steps (17.59,
    1186.9, 3720.6 at B=4 in both). The two agree on the first two
    losses within 1e-4; past them the divergence amplifies float32
    differences. The card's VGG-16 pass therefore trains at 0.01
    (chip_smoke.py CNN_PASSES)."""
    xs, ys = _batches(CIFAR, 4, 3)
    losses = [_train(ht, models, "vgg16", ht.optim.MomentumOptimizer(0.1),
                     xs, ys)[1] for ht, models in ((jht, JM), (tht, TM))]
    np.testing.assert_allclose(losses[1][:2], losses[0][:2], rtol=1e-4)
    for curve in losses:
        assert not curve[-1] < 100 * curve[0], curve


@pytest.mark.parametrize("opt", ["momentum", "nesterov", "adagrad"])
def test_optimizer_twins(opt):
    """Momentum (Hetu's v = m v - lr g), Nesterov and AdaGrad: 3 steps of
    an MLP; losses and every parameter after the steps."""
    def make(ht):
        return {"momentum": lambda: ht.optim.MomentumOptimizer(0.05),
                "nesterov": lambda: ht.optim.MomentumOptimizer(
                    0.05, momentum=0.8, nesterov=True),
                "adagrad": lambda: ht.optim.AdaGradOptimizer(
                    0.05, initial_accumulator_value=0.1)}[opt]()
    xs, ys = _batches((64,), 16, STEPS)
    jexe, jl = _train_mlp(jht, JM, make(jht), xs, ys)
    texe, tl = _train_mlp(tht, TM, make(tht), xs, ys)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jp, tp = _params(jexe), _params(texe)
    assert sorted(tp) == sorted(jp)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], rtol=1e-5, atol=1e-6)


def _train_mlp(ht, models, opt, xs, ys):
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    loss, _ = models.mlp(x, y_, input_dim=xs.shape[-1])
    kw = {"ctx": tht.cpu(0)} if ht is tht else {}
    exe = ht.Executor([loss, opt.minimize(loss)], **kw)
    return exe, [_scalar(exe.run(feed_dict={x: xb, y_: yb})[0])
                 for xb, yb in zip(xs, ys)]


def _params(exe):
    return {node.name: np.asarray(exe.params[sid])
            for sid, node in exe._param_nodes.items()}


def test_reference_checkpoint_with_batch_norm_state(tmp_path):
    """ResNet-18 trained 2 steps by hetu_tpu and saved; the port's
    Executor.load restores its parameters and its 13 batch norms'
    running statistics (matched in creation order), and validates as
    the reference does. A session with another number of stateful ops
    refuses it at load, one whose ops need other shapes at its first
    step."""
    xs, ys = _batches(CIFAR, 4, 2)
    jexe, _ = _train(jht, JM, "resnet18", jht.optim.SGDOptimizer(1e-3),
                     xs, ys)
    jexe.save(str(tmp_path))
    texe, x, y_ = _session(tht, TM, "resnet18", tht.optim.SGDOptimizer(1e-3))
    texe.load(str(tmp_path))
    jstate, tstate = (_state_in_creation_order(e) for e in (jexe, texe))
    assert len(tstate) == len(jstate) == 13
    for j, t in zip(jstate, tstate):
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    jp, tp = _params(jexe), _params(texe)
    for name in jp:
        np.testing.assert_array_equal(tp[name], jp[name])
    jx, jy = _feeds(jexe)
    want = _scalar(jexe.run("validate", feed_dict={jx: xs[1], jy: ys[1]})[0])
    got = _scalar(texe.run("validate", feed_dict={x: xs[1], y_: ys[1]})[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)

    vgg19, _, _ = _session(tht, TM, "vgg19", tht.optim.SGDOptimizer(1e-3))
    with pytest.raises(ValueError, match="state of 13 ops for a session "
                                         "with 16 stateful ops"):
        vgg19.load_state(jexe.state)
    vgg16, x, y_ = _session(tht, TM, "vgg16", tht.optim.SGDOptimizer(1e-3))
    vgg16.load_state(jexe.state)                # 13 batch norms too
    with pytest.raises(ValueError, match="does not match"):
        vgg16.run("validate", feed_dict={x: xs[0], y_: ys[0]})


def test_port_checkpoint_round_trip_with_batch_norm_state(tmp_path):
    """The port's save writes the batch norms' running statistics into
    the sidecar's "state"; load restores them into a session that has
    already run (its state recreated at the next step's shape pass) and
    an empty "state" leaves every op to start afresh."""
    xs, ys = _batches(CIFAR, 2, 3)
    exe, x, y_ = _session(tht, TM, "resnet18", tht.optim.SGDOptimizer(1e-3))
    for xb, yb in zip(xs[:2], ys[:2]):
        exe.run("train", feed_dict={x: xb, y_: yb})
    exe.save(str(tmp_path))
    want = _scalar(exe.run("validate", feed_dict={x: xs[2], y_: ys[2]})[0])

    other, ox, oy = _session(tht, TM, "resnet18",
                             tht.optim.SGDOptimizer(1e-3))
    other.run("train", feed_dict={ox: xs[2], oy: ys[2]})
    other.load(str(tmp_path))
    for j, t in zip(_state_in_creation_order(exe),
                    _state_in_creation_order(other)):
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    got = _scalar(other.run("validate", feed_dict={ox: xs[2], oy: ys[2]})[0])
    assert got == want
    other.load_state({})
    other.run("validate", feed_dict={ox: xs[2], oy: ys[2]})
    fresh = _state_in_creation_order(other)
    assert len(fresh) == 13
    assert all((s["running_mean"] == 0).all() and (s["running_var"] == 1).all()
               for s in fresh)
