"""The port's graph core and op set against hetu_tpu on the CPU:
``gradients`` on a small graph, and the shape, layer-norm and sparse
cross-entropy ops (forward and gradient ops) against their JAX twins on
the same numpy inputs. Tolerance: atol = rtol = 1e-5 (float32; the two
frameworks sum in different orders), exact where nothing is summed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu.graph.node import ExecContext as JCtx
from hetu_tpu_torch.graph.node import ExecContext as TCtx

TOL = dict(rtol=1e-5, atol=1e-5)


def _twin(build, feeds, grads_of):
    """Build the same graph in both packages with ``build(ht)`` -> (out,
    {name: placeholder}), take d(sum out)/d(placeholders in grads_of)
    with ``gradients``, and run both eagerly op by op."""
    results = []
    for ht, ctx, conv in ((jht, JCtx, jnp.asarray),
                          (tht, TCtx, torch.from_numpy)):
        out, phs = build(ht)
        loss = ht.reduce_sum_op(out, list(range(len(feeds["shape"]))))
        grads = ht.gradients(loss, [phs[n] for n in grads_of])
        nodes = [out] + grads
        topo = _topo(ht, nodes)
        env = {phs[n]: conv(v) for n, v in feeds.items() if n != "shape"}
        for node in topo:                     # shape pass, then compute
            node.inferred_shape = tuple(env[node].shape) if node in env \
                else node.infer_shape([i.inferred_shape for i in node.inputs])
        ectx = ctx(training=True)
        for node in topo:
            if node not in env:
                env[node] = node.compute([env[i] for i in node.inputs],
                                         ectx)
        results.append([np.asarray(env[n]) for n in nodes])
    return results


def _topo(ht, nodes):
    if ht is jht:
        from hetu_tpu.graph.autodiff import find_topo_sort
    else:
        from hetu_tpu_torch.graph.autodiff import find_topo_sort
    return find_topo_sort(nodes)


def test_gradients_of_a_small_graph():
    """y = (a * b + a) * 3 - b: grads through add, mul, const ops and
    the adjoint sums of a fanned-out node."""
    rng = np.random.RandomState(0)
    a, b = (rng.randn(3, 4).astype(np.float32) for _ in range(2))

    def build(ht):
        pa, pb = ht.Variable("a", trainable=False), \
            ht.Variable("b", trainable=False)
        return (pa * pb + pa) * 3.0 - pb, {"a": pa, "b": pb}

    (jo, jga, jgb), (to, tga, tgb) = _twin(
        build, {"a": a, "b": b, "shape": a.shape}, ["a", "b"])
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tga, 3 * (b + 1), **TOL)
    np.testing.assert_allclose(tgb, 3 * a - 1, **TOL)
    np.testing.assert_allclose(tga, jga, **TOL)
    np.testing.assert_allclose(tgb, jgb, **TOL)


def test_gradients_raises_without_a_path():
    x, y = tht.Variable("x", trainable=False), tht.Variable("y",
                                                            trainable=False)
    with pytest.raises(ValueError, match="no gradient path"):
        tht.gradients(tht.oneslike_op(x) * 2.0, [y])


def test_shape_ops_and_their_gradients():
    """reshape, transpose, split, squeeze, broadcast_to, reduce_mean and
    their adjoints, in the pattern of the GPT attention split."""
    rng = np.random.RandomState(1)
    x = rng.randn(2 * 5, 3 * 2 * 4).astype(np.float32)
    bias = rng.randn(3 * 2 * 4).astype(np.float32)

    def build(ht):
        px, pb = ht.Variable("x", trainable=False), \
            ht.Variable("b", trainable=False)
        h = px + ht.broadcastto_op(pb, px)
        h = ht.array_reshape_op(h, [-1, 5, 3, 2, 4])
        h = ht.transpose_op(h, [2, 0, 3, 1, 4])
        k = ht.squeeze_op(ht.split_op(h, [0], [1], [3]), axes=[0])
        k = ht.transpose_op(k, [0, 2, 1, 3])
        mean = ht.reduce_mean_op(k, [3], keepdims=True)
        return ht.broadcastto_op(mean, k) * k, {"x": px, "b": pb}

    (jo, jgx, jgb), (to, tgx, tgb) = _twin(
        build, {"x": x, "b": bias, "shape": (2, 5, 2, 4)}, ["x", "b"])
    assert to.shape == jo.shape == (2, 5, 2, 4)
    for t, j in ((to, jo), (tgx, jgx), (tgb, jgb)):
        np.testing.assert_allclose(t, j, **TOL)


def test_layer_norm_and_its_packed_gradient():
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 6, 32) * 2 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    bias = (0.1 * rng.randn(32)).astype(np.float32)
    w = rng.randn(4, 6, 32).astype(np.float32)

    def build(ht):
        p = {n: ht.Variable(n, trainable=False) for n in "xsbw"}
        y = ht.layer_normalization_op(p["x"], p["s"], p["b"], eps=1e-12)
        return y * p["w"], p

    feeds = {"x": x, "s": scale, "b": bias, "w": w, "shape": x.shape}
    jres, tres = _twin(build, feeds, ["x", "s", "b"])
    for t, j in zip(tres, jres):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_sparse_cross_entropy_and_its_gradient():
    """Ignored labels (-1) give 0 loss and 0 gradient; labels past the
    class range are clipped, as the reference's gather clips."""
    rng = np.random.RandomState(3)
    logits = (rng.randn(3, 5, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, (3, 5))
    labels[0, :2] = -1
    labels[1, 0] = 13

    def build(ht):
        pl, py = ht.Variable("l", trainable=False), \
            ht.Variable("y", trainable=False)
        return ht.softmaxcrossentropy_sparse_op(pl, py), {"l": pl, "y": py}

    (jo, jg), (to, tg) = _twin(
        build, {"l": logits, "y": labels, "shape": (3, 5)}, ["l"])
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    assert (to[0, :2] == 0).all() and (tg[0, :2] == 0).all()


def test_embedding_gradient_is_indexed_slices_and_dedups():
    ids = torch.tensor([[1, 3], [3, 1]])
    rows = torch.arange(8, dtype=torch.float32).reshape(2, 2, 2)
    grad = tht.embedding_lookup_gradient_op(
        tht.Variable("g", trainable=False),
        tht.Variable("ids", trainable=False), embed_shape=(5, 2))
    sl = grad.compute([rows, ids], TCtx())
    assert isinstance(sl, tht.IndexedSlices)
    uniq, summed = sl.dedup()
    assert uniq.tolist() == [1, 3]
    assert summed.tolist() == [[0 + 6, 1 + 7], [2 + 4, 3 + 5]]
    dense = sl.to_dense()
    assert dense[0].tolist() == [0, 0] and dense[1].tolist() == [6, 8]
    with pytest.raises(TypeError, match="float ids"):
        grad.compute([rows, ids.float()], TCtx())


def test_per_op_generators_are_deterministic_and_distinct():
    a, b = (tht.Variable(n, trainable=False) for n in "ab")

    def draw(ectx, op):
        return torch.rand(4, generator=ectx.generator_for(op))

    first = draw(TCtx(seed=3, step=5), a)
    assert torch.equal(first, draw(TCtx(seed=3, step=5), a))
    assert not torch.equal(first, draw(TCtx(seed=3, step=5), b))
    assert not torch.equal(first, draw(TCtx(seed=3, step=6), a))


def test_executor_drops_every_intermediate_after_its_last_consumer():
    """The eager walk frees each value once its last consumer ran: only
    the fetched outputs, parameters and feeds outlive the step."""
    x = tht.Variable("x", trainable=False)
    w = tht.init.ones((3, 2), name="w")
    h = tht.matmul_op(x, w)
    loss = tht.reduce_mean_op(h * h, [0, 1])
    train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    exe = tht.Executor([loss, train], ctx=tht.cpu(0))
    sub = exe.subexecutors["default"]
    freed = [n for group in sub._free_after for n in group]
    kept = {loss, train, w, x}
    assert len(freed) == len(set(freed))
    assert set(freed) == set(sub.topo_order) - kept
    out = exe.run(feed_dict={x: np.ones((4, 3), np.float32)})
    assert float(out[0].asnumpy()) == 9.0 and out[1] is None
