"""The ops the BERT slice adds to the port — ``batch_matmul_op``,
``softmax_op``, ``slice_op`` and dropout — against hetu_tpu on the CPU.

The first three run on the same numpy inputs through both packages,
forward and gradient ops, at atol = rtol = 1e-6 (float32: the two
frameworks sum a product's few terms in different orders; slicing is
exact). The adjoint is a random tensor, not ones, so a transposed
gradient cannot pass by symmetry.

Dropout cannot match: torch's generators do not reproduce
``jax.random.fold_in``. It is held to its properties instead: identity
in eval, the keep fraction within 4 sigma of ``keep_prob``, kept values
scaled by ``1 / keep_prob``, the gradient op applying the forward's own
mask, and one mask per (seed, step, op).
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

TOL = dict(rtol=1e-6, atol=1e-6)


def _twin(build, feeds, grads_of, seed=0):
    """Build ``build(ht) -> (out, {name: placeholder})`` in both packages,
    take the gradients of sum(out * w) for a random w with respect to the
    placeholders named in ``grads_of``, and run both op by op on the
    same numpy feeds. Returns [[out, *grads] numpy] per package (JAX
    first)."""
    results = []
    for ht, ctx, conv, topo in ((jht, JCtx, jnp.asarray, jtopo),
                                (tht, TCtx, torch.from_numpy, ttopo)):
        out, phs = build(ht)
        w = ht.Variable("w", trainable=False)
        loss = ht.reduce_sum_op(out * w, [0])
        grads = ht.gradients(loss, [phs[n] for n in grads_of])
        nodes = [out] + grads
        order = topo(nodes + [loss])
        env = {phs[n]: conv(v) for n, v in feeds.items()}
        for node in order:              # shape pass, then w of out's shape
            node.inferred_shape = tuple(env[node].shape) if node in env \
                else (None if node is w else node.infer_shape(
                    [i.inferred_shape for i in node.inputs]))
            if node is out:
                shape = node.inferred_shape
                w.inferred_shape = shape
                env[w] = conv(np.random.RandomState(seed).randn(*shape)
                              .astype(np.float32))
        ectx = ctx(training=True)
        for node in order:
            if node not in env:
                env[node] = node.compute([env[i] for i in node.inputs], ectx)
        results.append([np.asarray(env[n]) for n in nodes])
    return results


@pytest.mark.parametrize("trans_A", [False, True])
@pytest.mark.parametrize("trans_B", [False, True])
def test_batch_matmul_and_its_gradients(trans_A, trans_B):
    rng = np.random.RandomState(0)
    m, k, n = 3, 5, 4
    a = rng.randn(2, 3, *((k, m) if trans_A else (m, k))).astype(np.float32)
    b = rng.randn(2, 3, *((n, k) if trans_B else (k, n))).astype(np.float32)

    def build(ht):
        pa, pb = ht.Variable("a", trainable=False), \
            ht.Variable("b", trainable=False)
        return ht.batch_matmul_op(pa, pb, trans_A, trans_B), \
            {"a": pa, "b": pb}

    jres, tres = _twin(build, {"a": a, "b": b}, ["a", "b"])
    want = np.matmul(a.swapaxes(-1, -2) if trans_A else a,
                     b.swapaxes(-1, -2) if trans_B else b)
    np.testing.assert_allclose(tres[0], want, rtol=1e-5, atol=1e-5)
    assert tres[0].shape == (2, 3, m, n)
    assert [t.shape for t in tres[1:]] == [a.shape, b.shape]
    for t, j in zip(tres, jres):
        np.testing.assert_allclose(t, j, **TOL)


def test_batch_matmul_rejects_mismatched_shapes():
    a, b = (tht.Variable(n, trainable=False) for n in "ab")
    op = tht.batch_matmul_op(a, b)
    with pytest.raises(ValueError, match="batch matmul mismatch"):
        op.infer_shape([(2, 3, 4), (2, 5, 6)])
    with pytest.raises(ValueError, match="batch matmul mismatch"):
        op.infer_shape([(2, 3, 4), (3, 4, 6)])


def test_softmax_and_its_gradient():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 3, 4, 7) * 3).astype(np.float32)

    def build(ht):
        px = ht.Variable("x", trainable=False)
        return ht.softmax_op(px), {"x": px}

    jres, tres = _twin(build, {"x": x}, ["x"])
    np.testing.assert_allclose(tres[0].sum(-1), 1.0, rtol=1e-6)
    for t, j in zip(tres, jres):
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("begin,size", [
    ((0, 0, 0), (-1, 1, 6)),          # BertPooler's [CLS] row
    ((1, 2), (1, -1)),                # partial indexing: dim 2 whole
    ((0, 1, 2), (2, 3, 3))])
def test_slice_and_its_gradient(begin, size):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 6).astype(np.float32)

    def build(ht):
        px = ht.Variable("x", trainable=False)
        return ht.slice_op(px, begin, size), {"x": px}

    jres, tres = _twin(build, {"x": x}, ["x"])
    index = tuple(slice(b, None if s == -1 else b + s)
                  for b, s in zip(begin, size))
    np.testing.assert_array_equal(tres[0], x[index])
    # the adjoint w placed at the slice, zeros elsewhere
    want = np.zeros_like(x)
    want[index] = np.random.RandomState(0).randn(*tres[0].shape)
    np.testing.assert_array_equal(tres[1], want)
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# dropout, by its properties
# ---------------------------------------------------------------------------

N = 100_000


def _dropout(keep_prob, per_channel=False):
    x = tht.Variable("x", trainable=False)
    op = (tht.dropout2d_op if per_channel else tht.dropout_op)(x, keep_prob)
    grad_op = op.gradient(tht.Variable("dy", trainable=False))[0]
    return op, grad_op


@pytest.mark.parametrize("per_channel", [False, True])
def test_dropout_is_the_identity_in_eval(per_channel):
    op, grad_op = _dropout(0.5, per_channel)
    x = torch.randn(4, 3, 5, 5)
    ectx = TCtx(training=False)
    assert op.compute([x], ectx) is x
    assert grad_op.compute([x], ectx) is x


@pytest.mark.parametrize("keep_prob", [0.9, 0.5])
def test_dropout_keeps_keep_prob_and_scales_by_its_inverse(keep_prob):
    op, _ = _dropout(keep_prob)
    out = op.compute([torch.ones(N)], TCtx(seed=1, step=0))
    kept = out != 0
    sigma = (keep_prob * (1 - keep_prob) / N) ** 0.5
    assert abs(float(kept.float().mean()) - keep_prob) < 4 * sigma
    assert torch.equal(out[kept],
                       torch.full((int(kept.sum()),), 1.0) / keep_prob)


@pytest.mark.parametrize("per_channel", [False, True])
def test_dropout_gradient_applies_the_forward_mask(per_channel):
    op, grad_op = _dropout(0.7, per_channel)
    x = torch.randn(8, 16, 9, 9)
    dy = torch.randn(8, 16, 9, 9)
    ectx = TCtx(seed=3, step=2)
    mask = op.compute([torch.ones_like(x)], ectx)
    assert torch.equal(op.compute([x], ectx), x * mask)
    assert torch.equal(grad_op.compute([dy], ectx), dy * mask)
    assert 0 < int((mask == 0).sum()) < mask.numel()
    if per_channel:        # one decision per (N, C) plane
        assert torch.equal(mask, mask[..., :1, :1].expand_as(mask))


def test_dropout_mask_is_fixed_by_seed_step_and_op():
    op, _ = _dropout(0.5)
    other, _ = _dropout(0.5)
    ones = torch.ones(4096)

    def mask(o, seed, step):
        return o.compute([ones], TCtx(seed=seed, step=step))

    first = mask(op, 0, 0)
    assert torch.equal(first, mask(op, 0, 0))
    assert not torch.equal(first, mask(op, 0, 1))
    assert not torch.equal(first, mask(other, 0, 0))
    assert not torch.equal(first, mask(op, 1, 0))
