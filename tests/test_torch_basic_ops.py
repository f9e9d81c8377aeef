"""The rest of the port's basic, shape, loss and activation ops against
hetu_tpu on the CPU: each op's forward and the gradient ops of its
inputs, built by ``gradients`` of a weighted sum of its output, on the
same numpy inputs. Tolerance: 1e-6 relative and absolute, 1e-5 for erf,
power and log (the two frameworks' f32 transcendentals differ in the
last bits). Also ``Op / Op``, ``const / Op`` and the integer condition of
``where_op`` (any nonzero id is true, as in JAX).
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

TIGHT, LOOSE = 1e-6, 1e-5


def _walk(ht, build, feeds, grads_of):
    """Build ``build(ht) -> (out, {name: placeholder})``; with
    ``grads_of``, add the gradients of sum(out * w) (w fed like out) with
    respect to those placeholders. Run the graph op by op on the CPU and
    return the numpy values of out and the gradients."""
    jax_side = ht is jht
    out, phs = build(ht)
    nodes = [out]
    feeds = dict(feeds)
    if grads_of:
        w = ht.Variable("w", trainable=False)
        phs["w"] = w
        shape = np.shape(_walk(ht, build, feeds, ())[0])
        feeds["w"] = np.random.RandomState(7).uniform(
            0.5, 1.5, shape).astype(np.float32)
        loss = ht.reduce_sum_op(out * w, list(range(len(shape))))
        nodes += ht.gradients(loss, [phs[n] for n in grads_of])
    conv = jnp.asarray if jax_side else torch.from_numpy
    env = {phs[n]: conv(np.asarray(v)) for n, v in feeds.items()}
    topo = (jtopo if jax_side else ttopo)(nodes)
    for node in topo:
        node.inferred_shape = tuple(env[node].shape) if node in env \
            else node.infer_shape([i.inferred_shape for i in node.inputs])
    ectx = (JCtx if jax_side else TCtx)(training=True)
    for node in topo:
        if node not in env:
            env[node] = node.compute([env[i] for i in node.inputs], ectx)
    return [np.asarray(env[n]) for n in nodes]


def _check(build, feeds, grads_of=(), tol=TIGHT):
    want = _walk(jht, build, feeds, grads_of)
    got = _walk(tht, build, feeds, grads_of)
    assert len(got) == len(want) == 1 + len(grads_of)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    return got


def _ph(ht, *names):
    return {n: ht.Variable(n, trainable=False) for n in names}


RNG = np.random.RandomState(0)
X = RNG.randn(4, 6).astype(np.float32)
Y = RNG.randn(4, 6).astype(np.float32)
POS = RNG.uniform(0.2, 3.0, (4, 6)).astype(np.float32)
POS2 = RNG.uniform(0.2, 3.0, (4, 6)).astype(np.float32)
IDS = RNG.randint(0, 3, (4, 6))           # int condition, zeros included


def _op(ht, op_name):
    # hetu_tpu exports erf_op from its ops.basic module only
    return getattr(ht.ops.basic, op_name, None) or getattr(ht.ops, op_name)


def _unary(op_name, *args):
    def build(ht):
        phs = _ph(ht, "x")
        return _op(ht, op_name)(phs["x"], *args), phs
    return build


def _binary(op_name):
    def build(ht):
        phs = _ph(ht, "a", "b")
        return _op(ht, op_name)(phs["a"], phs["b"]), phs
    return build


# name: (build, feeds, inputs differentiated, tolerance)
GRAD_CASES = {
    "div": (_binary("div_op"), {"a": X, "b": POS}, ("a", "b"), TIGHT),
    "div_by_operator": (
        lambda ht: (lambda p: (p["a"] / p["b"], p))(_ph(ht, "a", "b")),
        {"a": X, "b": POS}, ("a", "b"), TIGHT),
    "div_const": (
        lambda ht: (lambda p: (ht.div_const_op(2.0, p["x"]), p))(
            _ph(ht, "x")), {"x": POS}, ("x",), TIGHT),
    "rtruediv": (
        lambda ht: (lambda p: (2.0 / p["x"], p))(_ph(ht, "x")),
        {"x": POS}, ("x",), TIGHT),
    "sqrt": (_unary("sqrt_op"), {"x": POS}, ("x",), TIGHT),
    "rsqrt": (_unary("rsqrt_op"), {"x": POS}, ("x",), TIGHT),
    "erf": (_unary("erf_op"), {"x": X}, ("x",), LOOSE),
    "exp": (_unary("exp_op"), {"x": X}, ("x",), TIGHT),
    "log": (_unary("log_op"), {"x": POS}, ("x",), LOOSE),
    "abs": (_unary("abs_op"), {"x": X}, ("x",), TIGHT),
    "power_int": (_unary("power_op", 3), {"x": X}, ("x",), LOOSE),
    "power_frac": (_unary("power_op", 2.5), {"x": POS}, ("x",), LOOSE),
    "where_int_condition": (
        lambda ht: (lambda p: (ht.where_op(p["c"], p["a"], p["b"]), p))(
            _ph(ht, "c", "a", "b")),
        {"c": IDS, "a": X, "b": Y}, ("a", "b"), TIGHT),
    "matrix_dot": (_binary("matrix_dot_op"), {"a": X, "b": Y}, ("a", "b"),
                   TIGHT),
    "cast_float": (_unary("cast_op", np.float32), {"x": X}, ("x",), TIGHT),
    "cast_int": (_unary("cast_op", np.int32), {"x": X * 3}, ("x",), TIGHT),
    "clip": (_unary("clip_op", -0.5, 0.7), {"x": X}, ("x",), TIGHT),
    "clip_no_upper_bound": (_unary("clip_op", 0.3, None), {"x": X}, ("x",),
                            TIGHT),
    "clip_no_lower_bound": (_unary("clip_op", None, 0.3), {"x": X}, ("x",),
                            TIGHT),
    "broadcast_shape_add_axes": (
        lambda ht: (lambda p: (ht.broadcast_shape_op(
            p["x"], (2, 4, 3, 6), add_axes=(0, 2)), p))(_ph(ht, "x")),
        {"x": X}, ("x",), TIGHT),
    "broadcast_shape": (
        lambda ht: (lambda p: (ht.broadcast_shape_op(p["x"], (4, 6)), p))(
            _ph(ht, "x")), {"x": X[:1]}, ("x",), TIGHT),
    "flatten": (_unary("flatten_op", 2),
                {"x": RNG.randn(2, 3, 4, 5).astype(np.float32)}, ("x",),
                TIGHT),
    "unsqueeze": (_unary("unsqueeze_op", (0, -1)), {"x": X}, ("x",), TIGHT),
    "reducesumaxiszero": (_unary("reducesumaxiszero_op"), {"x": X}, ("x",),
                          TIGHT),
    "binarycrossentropy": (
        _binary("binarycrossentropy_op"),
        # one prediction at exactly 0 (label 0) goes through the clip
        {"a": np.concatenate([[[0.0]], RNG.uniform(
            0.05, 0.95, (7, 1))]).astype(np.float32),
         "b": np.concatenate([[[0.0]], RNG.randint(0, 2, (7, 1))]).astype(
             np.float32)}, ("a",), TIGHT),
    # the gradient broadcasts the adjoint right-aligned (as the reference
    # does), which is the adjoint's own shape only for one distribution
    "crossentropy": (
        _binary("crossentropy_op"),
        {"a": np.array([0.1, 0.2, 0.0, 0.7], np.float32),
         "b": np.array([0.0, 0.3, 0.1, 0.6], np.float32)}, ("a",), TIGHT),
    "leaky_relu": (_unary("leaky_relu_op", 0.1), {"x": X}, ("x",), TIGHT),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_op_and_its_gradient_match_the_reference(case):
    build, feeds, grads_of, tol = GRAD_CASES[case]
    _check(build, feeds, grads_of, tol)


FORWARD_CASES = {
    "div_handle_zero": (_binary("div_handle_zero_op"),
                        {"a": X, "b": POS * (IDS > 0)}),
    # ids outside [0, 5) give rows of zeros, as jax.nn.one_hot's do
    "one_hot": (_unary("one_hot_op", 5),
                {"x": np.array([[0, 4, -1], [5, 2, 1]])}),
    "clip_mask": (_unary("clip_mask_op", -0.5, None), {"x": X}),
    "sign": (_unary("sign_op"),
             {"x": np.concatenate([X, np.zeros((1, 6), np.float32)])}),
    "crossentropy_rows": (_binary("crossentropy_op"),
                          {"a": POS / POS.sum(1, keepdims=True),
                           "b": POS2 / POS2.sum(1, keepdims=True)}),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_only_op_matches_the_reference(case):
    build, feeds = FORWARD_CASES[case]
    _check(build, feeds)


def test_where_treats_any_nonzero_id_as_true():
    (out,) = _check(
        lambda ht: (lambda p: (ht.where_op(p["c"], p["a"], p["b"]), p))(
            _ph(ht, "c", "a", "b")), {"c": IDS, "a": X, "b": Y})
    np.testing.assert_array_equal(out, np.where(IDS != 0, X, Y))


def test_div_through_the_executor_matches_the_reference():
    """``a / b`` on two nodes, forward and gradients, through each
    package's Executor."""
    vals = []
    for ht in (jht, tht):
        a, b = ht.Variable("a", trainable=False), ht.Variable(
            "b", trainable=False)
        out = a / b
        grads = ht.gradients(ht.reduce_sum_op(out, [0, 1]), [a, b])
        kw = {"ctx": tht.cpu(0)} if ht is tht else {}
        exe = ht.Executor([out, *grads], **kw)
        vals.append([np.asarray(v.asnumpy()) for v in exe.run(
            feed_dict={a: X, b: POS})])
    for g, w in zip(*reversed(vals)):
        np.testing.assert_allclose(g, w, rtol=TIGHT, atol=TIGHT)
    np.testing.assert_allclose(vals[1][1], 1 / POS, rtol=TIGHT)
