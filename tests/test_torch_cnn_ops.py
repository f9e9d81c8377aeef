"""The CNN slice's ops against hetu_tpu on the CPU: convolution, pooling,
pad, concat, sigmoid, dense softmax cross-entropy, batch and instance
norm, forward and gradient ops, on the same numpy inputs through both
packages (each graph walked eagerly op by op).

Tolerance: atol = rtol = 1e-5 in float32 (tighter than the reference's
own conv test, rtol 1e-3 / atol 1e-4, tests/test_ops.py:140); exact
where nothing is summed (pad, concat, the routing of a max pool's
gradient). The max-pool inputs hold ties — relu of small integers, so
windows of equal values and of zeros are common — and the gradient must
go to the element JAX's vjp of ``reduce_window(max)`` picks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
from hetu_tpu.graph.node import ExecContext as JCtx
from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
from hetu_tpu_torch.graph.node import ExecContext as TCtx

TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = dict(rtol=0, atol=0)
PACKAGES = ((jht, JCtx, jnp.asarray, jtopo),
            (tht, TCtx, torch.from_numpy, ttopo))


def _twin(build, feeds, grads_of, ectx_kw=None):
    """Build the same graph in both packages with ``build(ht)`` -> (out,
    {name: placeholder}); the upstream adjoint is the fed ``"w"`` (shaped
    like ``out``): d(sum(out * w))/d(placeholders in ``grads_of``). Both
    graphs are walked eagerly. Returns ([out, *grads] of hetu_tpu, the
    same of the port) as numpy."""
    results = []
    for ht, ctx, conv, topo_sort in PACKAGES:
        out, phs = build(ht)
        phs["w"] = ht.Variable("w", trainable=False)
        grads = ht.gradients(out, [phs[n] for n in grads_of],
                             insert_grad=phs["w"])
        nodes = [out] + grads
        topo = topo_sort(nodes)
        env = {phs[n]: conv(np.ascontiguousarray(v))
               for n, v in feeds.items()}
        for node in topo:                     # shape pass, then compute
            node.inferred_shape = tuple(env[node].shape) if node in env \
                else node.infer_shape([i.inferred_shape for i in node.inputs])
        ectx = ctx(**(ectx_kw or {"training": True}))
        for node in topo:
            if node not in env:
                env[node] = node.compute([env[i] for i in node.inputs],
                                         ectx)
        results.append([np.asarray(env[n]) for n in nodes])
    return results


def _check(results, tol=TOL):
    (jres, tres) = results
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, **tol)


def _placeholders(ht, names):
    return {n: ht.Variable(n, trainable=False) for n in names}


@pytest.mark.parametrize("stride,padding", [
    (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2), ((1, 2), (2, 1))])
def test_conv2d_and_both_gradients(stride, padding):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 9, 8).astype(np.float32)
    f = rng.randn(4, 3, 3, 3).astype(np.float32)

    def build(ht):
        p = _placeholders(ht, "xf")
        return ht.conv2d_op(p["x"], p["f"], padding=padding,
                            stride=stride), p

    jx = jht.conv2d_op(jht.Variable("x"), jht.Variable("f"), padding=padding,
                       stride=stride)
    out_shape = jx.infer_shape([x.shape, f.shape])
    w = rng.randn(*out_shape).astype(np.float32)
    _check(_twin(build, {"x": x, "f": f, "w": w}, ["x", "f"]))


def test_conv2d_bias_broadcast_and_reduce_sum():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    w = rng.randn(2, 5, 4, 3).astype(np.float32)

    def build(ht):
        p = _placeholders(ht, "xb")
        return p["x"] + ht.conv2d_broadcastto_op(p["b"], p["x"]), p

    _check(_twin(build, {"x": x, "b": b, "w": w}, ["x", "b"]))

    def build_sum(ht):
        p = _placeholders(ht, "x")
        return ht.conv2d_reducesum_op(p["x"]), p

    _check(_twin(build_sum, {"x": x, "w": rng.randn(5).astype(np.float32)},
                 ["x"]))


POOLS = [(2, 2, 0, 2), (3, 3, 1, 2), (3, 3, 1, 1), (2, 3, (1, 1), (1, 2))]


def _tied(rng, shape):
    """relu of small integers: most windows hold ties, many all zeros."""
    return np.maximum(rng.randint(-2, 3, shape), 0).astype(np.float32)


@pytest.mark.parametrize("kh,kw,padding,stride", POOLS)
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pools_and_their_gradients_with_ties(kind, kh, kw, padding, stride):
    rng = np.random.RandomState(2)
    x = _tied(rng, (2, 3, 8, 7))
    op = jht.max_pool2d_op if kind == "max" else jht.avg_pool2d_op
    out_shape = op(jht.Variable("x"), kh, kw, padding=padding,
                   stride=stride).infer_shape([x.shape])
    w = rng.randn(*out_shape).astype(np.float32)

    def build(ht):
        p = _placeholders(ht, "x")
        pool = ht.max_pool2d_op if kind == "max" else ht.avg_pool2d_op
        return pool(p["x"], kh, kw, padding=padding, stride=stride), p

    results = _twin(build, {"x": x, "w": w}, ["x"])
    _check(results)
    if kind == "max":
        # each adjoint lands on the same element: the gradients agree
        # exactly, not only within the tolerance
        _check(results, EXACT)


def test_max_pool_gradient_goes_to_the_first_of_tied_elements():
    """A window of four equal values sends its adjoint to its first
    element (row-major), in both packages."""
    x = np.ones((1, 1, 2, 2), np.float32)
    w = np.full((1, 1, 1, 1), 5.0, np.float32)

    def build(ht):
        p = _placeholders(ht, "x")
        return ht.max_pool2d_op(p["x"], 2, 2, stride=2), p

    (_, jg), (_, tg) = _twin(build, {"x": x, "w": w}, ["x"])
    np.testing.assert_array_equal(tg, [[[[5.0, 0.0], [0.0, 0.0]]]])
    np.testing.assert_array_equal(jg, tg)


@pytest.mark.parametrize("mode", ["CONSTANT", "REFLECT", "SYMMETRIC"])
@pytest.mark.parametrize("paddings", [
    [[0, 0], [2, 1], [0, 0], [0, 0]],           # a non-last axis only
    [[1, 0], [0, 2], [3, 1], [0, 0]],
    [[0, 0], [1, 1], [2, 0], [1, 2]]])
def test_pad_modes_on_any_axis_and_the_gradient(mode, paddings):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 5, 3).astype(np.float32)
    w = rng.randn(*[s + lo + hi for s, (lo, hi) in
                    zip(x.shape, paddings)]).astype(np.float32)

    def build(ht):
        p = _placeholders(ht, "x")
        return ht.pad_op(p["x"], paddings, mode=mode,
                         constant_values=0.5 if mode == "CONSTANT" else 0), p

    (jo, jg), (to, tg) = _twin(build, {"x": x, "w": w}, ["x"])
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(
        to, np.pad(x, paddings, mode=mode.lower(),
                   **({"constant_values": 0.5} if mode == "CONSTANT"
                      else {})))
    np.testing.assert_allclose(tg, jg, **TOL)


def test_pad_gradient_op_alone():
    rng = np.random.RandomState(4)
    g = rng.randn(3, 9, 6).astype(np.float32)
    paddings = [[0, 0], [3, 2], [1, 1]]
    for mode in ("CONSTANT", "REFLECT", "SYMMETRIC"):
        j = jht.pad_gradient_op(jht.Variable("g"), paddings, mode).compute(
            [jnp.asarray(g)], JCtx())
        t = tht.pad_gradient_op(tht.Variable("g"), paddings, mode).compute(
            [torch.from_numpy(g)], TCtx())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_concat_and_concatenate_with_gradients(axis):
    rng = np.random.RandomState(5)
    shapes = [[2, 3, 4], [2, 3, 4], [2, 3, 4]]
    for i, s in enumerate(shapes):
        s[axis] += i
    a, b, c = (rng.randn(*s).astype(np.float32) for s in shapes)
    two = np.concatenate([a, b], axis=axis)
    three = np.concatenate([a, b, c], axis=axis)

    def build2(ht):
        p = _placeholders(ht, "ab")
        return ht.concat_op(p["a"], p["b"], axis=axis), p

    def build3(ht):
        p = _placeholders(ht, "abc")
        return ht.concatenate_op([p["a"], p["b"], p["c"]], axis=axis), p

    res = _twin(build2, {"a": a, "b": b, "w": rng.randn(*two.shape)
                         .astype(np.float32)}, ["a", "b"])
    _check(res, EXACT)
    np.testing.assert_array_equal(res[1][0], two)
    res = _twin(build3, {"a": a, "b": b, "c": c, "w": rng.randn(*three.shape)
                         .astype(np.float32)}, ["a", "b", "c"])
    _check(res, EXACT)
    np.testing.assert_array_equal(res[1][0], three)


def test_sigmoid_and_its_gradient():
    rng = np.random.RandomState(6)
    x = (rng.randn(4, 7) * 4).astype(np.float32)
    w = rng.randn(4, 7).astype(np.float32)

    def build(ht):
        p = _placeholders(ht, "x")
        return ht.sigmoid_op(p["x"]), p

    _check(_twin(build, {"x": x, "w": w}, ["x"]))


@pytest.mark.parametrize("soft", [False, True])
def test_dense_softmax_cross_entropy_and_its_gradient(soft):
    rng = np.random.RandomState(7)
    logits = (rng.randn(6, 10) * 3).astype(np.float32)
    if soft:
        y = rng.rand(6, 10).astype(np.float32)
        y /= y.sum(1, keepdims=True)
    else:
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 6)]
    w = rng.randn(6).astype(np.float32)

    def build(ht):
        p = _placeholders(ht, "ly")
        return ht.softmaxcrossentropy_op(p["l"], p["y"]), p

    _check(_twin(build, {"l": logits, "y": y, "w": w}, ["l"]))


@pytest.mark.parametrize("param_shape", [(5,), (1, 5, 1, 1)])
def test_batch_norm_training_and_its_packed_gradient(param_shape):
    rng = np.random.RandomState(8)
    x = (rng.randn(4, 5, 3, 3) * 2 + 1).astype(np.float32)
    s = (1 + 0.1 * rng.randn(*param_shape)).astype(np.float32)
    b = (0.1 * rng.randn(*param_shape)).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)

    def build(ht):
        p = _placeholders(ht, "xsb")
        return ht.batch_normalization_op(p["x"], p["s"], p["b"]), p

    res = _twin(build, {"x": x, "s": s, "b": b, "w": w}, ["x", "s", "b"])
    _check(res)
    assert res[1][2].shape == res[1][3].shape == param_shape


def _bn_state_step(ht, ctx, conv, x, scale, bias, state, training):
    """One BN forward through ``ht`` with ``state`` as the op's running
    statistics: (output, the state the op wrote or None)."""
    p = _placeholders(ht, "xsb")
    op = ht.batch_normalization_op(p["x"], p["s"], p["b"], momentum=0.9)
    ectx = ctx(training=training)
    ectx.state = {op: {k: conv(v) for k, v in state.items()}}
    out = op.compute([conv(x), conv(scale), conv(bias)], ectx)
    new = ectx.new_state.get(op)
    return np.asarray(out), (None if new is None else
                             {k: np.asarray(v) for k, v in new.items()})


def test_batch_norm_running_statistics_and_inference():
    """Training writes momentum * running + (1 - momentum) * batch with
    the population variance; inference normalizes with the running
    statistics and writes nothing."""
    rng = np.random.RandomState(9)
    x = (rng.randn(3, 4, 2, 5) * 3 - 1).astype(np.float32)
    scale = rng.randn(4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    state = {"running_mean": rng.randn(4).astype(np.float32),
             "running_var": (rng.rand(4) + 0.5).astype(np.float32)}
    for training in (True, False):
        (jo, js), (to, ts) = (
            _bn_state_step(ht, ctx, conv, x, scale, bias, state, training)
            for ht, ctx, conv, _ in PACKAGES)
        np.testing.assert_allclose(to, jo, **TOL)
        if not training:
            assert js is None and ts is None
            continue
        want = {"running_mean": 0.9 * state["running_mean"]
                + 0.1 * x.mean(axis=(0, 2, 3)),
                "running_var": 0.9 * state["running_var"]
                + 0.1 * x.var(axis=(0, 2, 3))}          # ddof 0
        for k in want:
            np.testing.assert_allclose(ts[k], js[k], **TOL)
            np.testing.assert_allclose(ts[k], want[k], **TOL)


def test_batch_norm_inference_needs_running_statistics():
    p = _placeholders(tht, "xsb")
    op = tht.batch_normalization_op(p["x"], p["s"], p["b"])
    with pytest.raises(RuntimeError, match="running statistics"):
        op.compute([torch.zeros(2, 3, 1, 1), torch.ones(3), torch.zeros(3)],
                   TCtx(training=False))


def test_instance_norm_and_its_gradient():
    rng = np.random.RandomState(10)
    x = (rng.randn(2, 3, 4, 5) * 2 + 0.5).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)

    def build(ht):
        p = _placeholders(ht, "x")
        return ht.instance_normalization2d_op(p["x"], eps=1e-3), p

    _check(_twin(build, {"x": x, "w": w}, ["x"]))
