"""The CSR sparse products of the port (``ops/sparse.py``) against
hetu_tpu's on the CPU, on the same numpy inputs: ``csrmm_op`` forward and
its gradient in every ``trans_A`` x ``trans_B`` case and ``csrmv_op`` in
both, at 1e-6 relative, over a CSR from COO (``sparse_array``), one with
empty rows, the sampled subgraph's padded last row (zero-valued
column-0 entries, many to a row) and hand-built CSRValues without the
ingest's row ids and A^T copy. Both packages gather, scale and sum each
row's entries in order, so the sums agree to the bit here.

Also: ``distgcn_15d_op`` refuses until the multi-GPU port, a malformed
CSR is refused at ingest, the executor's CSR feeds, ``ND_Sparse_Array``,
``array`` / ``empty`` / ``copyto`` / the async copies, and ``stream.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu import ndarray as jnd
from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
from hetu_tpu.graph.node import ExecContext as JCtx
from hetu_tpu_torch import ndarray as tnd
from hetu_tpu_torch import stream
from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
from hetu_tpu_torch.graph.node import ExecContext as TCtx

NROW, NCOL, F = 9, 6, 5
TOL = dict(rtol=1e-6, atol=0)


def _coo(seed=0):
    """A COO matrix with repeated (row, col) pairs (summed by the CSR)
    and rows 2 and 7 empty."""
    rng = np.random.RandomState(seed)
    rows = rng.choice([0, 1, 3, 4, 5, 6, 8], 30)
    cols = rng.randint(0, NCOL, 30)
    return rng.randn(30).astype(np.float32), (rows, cols)


def _padded(seed=1):
    """The sampler's padded CSR: 4 real rows, the rest empty but the
    last, which holds the unused budget as zero-valued column-0
    entries (more of them than there are columns)."""
    rng = np.random.RandomState(seed)
    counts = np.array([2, 3, 1, 2] + [0] * (NROW - 4))
    nnz = int(counts.sum())
    pad = 14
    counts[-1] += pad
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = np.concatenate([rng.randint(0, NCOL, nnz),
                              np.zeros(pad)]).astype(np.int32)
    data = np.concatenate([rng.rand(nnz),
                           np.zeros(pad)]).astype(np.float32)
    return data, indptr, indices


def _csr_arrays(case):
    if case == "padded":
        return _padded()
    import scipy.sparse as sp
    m = sp.csr_matrix(_coo(), shape=(NROW, NCOL), dtype=np.float32)
    return (m.data.astype(np.float32), m.indptr.astype(np.int32),
            m.indices.astype(np.int32))


def _values(case):
    """The same CSR as each package's in-graph value: the ingest's
    (row ids and A^T made) or, for "bare", hand-built without them."""
    data, indptr, indices = _csr_arrays("padded" if case == "padded_bare"
                                        else "coo")
    if case in ("bare", "padded_bare"):
        return (jnd.CSRValue(jnp.asarray(data), jnp.asarray(indptr),
                             jnp.asarray(indices), NROW, NCOL),
                tnd.CSRValue(torch.from_numpy(data),
                             torch.from_numpy(indptr),
                             torch.from_numpy(indices), NROW, NCOL))
    if case == "padded":
        data, indptr, indices = _padded()
    jsp = jht.ND_Sparse_Array(data, indptr, indices, NROW, NCOL)
    tsp = tht.ND_Sparse_Array(data, indptr, indices, NROW, NCOL)
    return (jnd.CSRValue.from_sparse_array(jsp),
            tnd.CSRValue.from_sparse_array(tsp, "cpu"))


def _eager(ht, topo, env, ctx):
    for node in topo:
        if node not in env:
            node.inferred_shape = node.infer_shape(
                [i.inferred_shape for i in node.inputs])
    ectx = ctx(training=True)
    for node in topo:
        if node not in env:
            env[node] = node.compute([env[i] for i in node.inputs], ectx)
    return env


def _twin(op, case, b, w, **kw):
    """``op``(A, B) and d(sum(op(A, B) * w))/dB in both packages."""
    out = []
    for ht, topo, ctx, conv, value in (
            (jht, jtopo, JCtx, jnp.asarray, _values(case)[0]),
            (tht, ttopo, TCtx, torch.from_numpy, _values(case)[1])):
        pa, pb, pw = (ht.Variable(n, trainable=False) for n in "abw")
        y = getattr(ht, op)(pa, pb, **kw)
        loss = ht.reduce_sum_op(ht.mul_op(y, pw), list(range(w.ndim)))
        (grad,) = ht.gradients(loss, [pb])
        env = {pa: value, pb: conv(b), pw: conv(w)}
        pa.inferred_shape = (NROW, NCOL)
        pb.inferred_shape, pw.inferred_shape = b.shape, w.shape
        env = _eager(ht, topo([y, grad]), env, ctx)
        out.append((np.asarray(env[y]), np.asarray(env[grad])))
    return out


CASES = ["coo", "padded", "bare", "padded_bare"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("trans_A", [False, True])
@pytest.mark.parametrize("trans_B", [False, True])
def test_csrmm_and_its_gradient_match_the_reference(case, trans_A, trans_B):
    rng = np.random.RandomState(7)
    k, m = (NROW, NCOL) if trans_A else (NCOL, NROW)
    b = rng.randn(*((F, k) if trans_B else (k, F))).astype(np.float32)
    w = rng.randn(m, F).astype(np.float32)
    (jy, jg), (ty, tg) = _twin("csrmm_op", case, b, w, trans_A=trans_A,
                               trans_B=trans_B)
    assert ty.shape == jy.shape == (m, F)
    assert tg.shape == jg.shape == b.shape
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("trans", [False, True])
def test_csrmv_and_its_gradient_match_the_reference(case, trans):
    rng = np.random.RandomState(8)
    k, m = (NROW, NCOL) if trans else (NCOL, NROW)
    v = rng.randn(k).astype(np.float32)
    w = rng.randn(m).astype(np.float32)
    (jy, jg), (ty, tg) = _twin("csrmv_op", case, v, w, trans=trans)
    assert ty.shape == (m,)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


def test_padded_row_sums_every_duplicate():
    """The padded last row holds column 0 many times: each entry counts
    (here with nonzero values, so a dropped duplicate would show)."""
    data, indptr, indices = _padded()
    data = data + 1.0
    dense = np.random.RandomState(9).randn(NCOL, F).astype(np.float32)
    want = np.zeros((NROW, F), np.float64)
    for r in range(NROW):
        for e in range(indptr[r], indptr[r + 1]):
            want[r] += data[e] * dense[indices[e]]
    value = tnd.CSRValue.from_sparse_array(
        tht.ND_Sparse_Array(data, indptr, indices, NROW, NCOL), "cpu")
    got = tht.csrmm_op(tht.Variable("a"), tht.Variable("b")).compute(
        [value, torch.from_numpy(dense)], None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ingest_copies_and_refuses_a_malformed_csr():
    data, indptr, indices = _csr_arrays("coo")
    value = tnd.CSRValue.from_sparse_array(
        tht.ND_Sparse_Array(data, indptr, indices, NROW, NCOL), "cpu")
    jvalue = jnd.CSRValue.from_sparse_array(
        jht.ND_Sparse_Array(data, indptr, indices, NROW, NCOL))
    for f in ("row_ids", "t_data", "t_indices", "t_row_ids"):
        np.testing.assert_array_equal(getattr(value, f).numpy(),
                                      np.asarray(getattr(jvalue, f)), f)
    np.testing.assert_array_equal(
        value.t_indptr.numpy(),
        np.searchsorted(value.t_row_ids.numpy(), np.arange(NCOL + 1)))
    assert value.shape == (NROW, NCOL) and value.dtype == torch.float32
    assert value.to("cpu") is value
    bad = [(data, indptr[:-1], indices),              # short indptr
           (data, indptr[::-1].copy(), indices),      # decreasing
           (data, indptr, indices + NCOL)]            # column out of range
    for d, p, i in bad:
        with pytest.raises(ValueError):
            tnd.CSRValue.from_sparse_array(
                tht.ND_Sparse_Array(d, p, i, NROW, NCOL), "cpu")


def test_the_executor_feeds_a_csr_and_passes_a_pinned_one_through():
    data, indptr, indices = _csr_arrays("coo")
    dense = np.random.RandomState(10).randn(NCOL, F).astype(np.float32)
    pa, pb = tht.Variable("a", trainable=False), \
        tht.Variable("b", trainable=False)
    exe = tht.Executor([tht.csrmm_op(pa, pb)], ctx=tht.cpu(0))
    sp_arr = tht.ND_Sparse_Array(tht.array(data), tht.array(indptr,
                                                            dtype=np.int32),
                                 tht.array(indices, dtype=np.int32),
                                 NROW, NCOL)
    pinned = tnd.CSRValue.from_sparse_array(sp_arr, "cpu")
    sub = exe.subexecutors["default"]
    assert sub._ingest(pinned) is pinned
    for feed in (sp_arr, pinned):
        (y,) = exe.run(feed_dict={pa: feed, pb: dense})
        np.testing.assert_allclose(y.asnumpy(), sp_arr.asnumpy() @ dense,
                                   rtol=1e-5, atol=1e-6)
    assert pa.inferred_shape == (NROW, NCOL)


def test_distgcn_15d_op_waits_for_the_multi_gpu_port():
    a, h, w = (tht.Variable(n) for n in "ahw")
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 11"):
        tht.distgcn_15d_op(a, h, w)


def test_sparse_array_and_asnumpy_match_the_reference():
    values, idx = _coo()
    t = tht.sparse_array(values, idx, (NROW, NCOL))
    j = jht.sparse_array(values, idx, (NROW, NCOL))
    assert t.shape == j.shape == (NROW, NCOL)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(t.row.asnumpy(), j.row.asnumpy())
    assert t.row.asnumpy().dtype == np.int32
    # numpy fields too (the sampler's), duplicates summed
    data, indptr, indices = _padded()
    want = np.zeros((NROW, NCOL), np.float32)
    np.add.at(want, (np.repeat(np.arange(NROW), np.diff(indptr)), indices),
              data)
    np.testing.assert_array_equal(
        tht.ND_Sparse_Array(data, indptr, indices, NROW, NCOL).asnumpy(),
        want)


def test_array_empty_copyto_and_async_copies():
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    a = tht.array(x)
    assert a.ctx == tht.cpu(0) and a.dtype == torch.float32
    np.testing.assert_array_equal(a.asnumpy(), jht.array(x).asnumpy())
    e = tht.empty((3, 2), dtype=np.int32)
    np.testing.assert_array_equal(e.asnumpy(),
                                  jht.empty((3, 2), dtype=np.int32).asnumpy())
    b = a.copyto(tht.cpu(0))
    assert b.tensor.data_ptr() != a.tensor.data_ptr()
    np.testing.assert_array_equal(b.asnumpy(), x)
    assert a.copyto(e) is e
    np.testing.assert_array_equal(e.asnumpy(), x)
    with pytest.raises(TypeError):
        a.copyto("cpu")
    ev = stream.create_event_handle(name="h2d")
    dst = tht.empty((2, 3))
    dst.async_h2d(x.astype(np.float32), stream.create_stream_handle(
        name="h2d"), ev)
    ev.sync()
    np.testing.assert_array_equal(dst.asnumpy(), x)
    host = tht.empty((1,))
    host.async_d2h(dst, event_handle=ev)
    ev.sync()
    np.testing.assert_array_equal(host.asnumpy(), x)


class _Comm:
    def __init__(self):
        self.waited = []

    def wait(self, name):
        self.waited.append(name)


def test_stream_events_keep_the_reference_semantics():
    """record/sync on a CPU value returns at once (the value exists);
    a Stream hands back what it records; PSEvent waits on its node's
    request, CSEvent on its timestamp only once one is set."""
    from hetu_tpu import stream as jstream
    value = torch.ones(3)
    for mod in (stream, jstream):
        s = mod.create_stream_handle(name="comp")
        assert s.name == "comp"
        assert s.record(value) is value
        s.sync()
        ev = mod.create_event_handle(name="n")
        assert ev.node_name == "n"
        ev.sync()                      # nothing recorded: returns
        ev.record(tht.NDArray(value) if mod is stream else None)
        ev.update()
        ev.sync()
        comm = _Comm()
        mod.PSEvent(comm, "emb").sync()
        mod.PSEvent(None, "emb").sync()
        assert comm.waited == ["emb"]
        cache = _Comm()
        cs = mod.CSEvent(cache, "emb")
        cs.sync()
        assert cache.waited == []
        cs.ts = 4
        cs.sync()
        assert cache.waited == [4]


@pytest.mark.cuda
def test_event_sync_waits_for_the_card():
    """On the card, sync() returns after the recorded work: a value
    queued behind a spin kernel is complete once its event syncs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda._sleep(50_000_000)
    y = x * 2
    ev = stream.Event("y")
    ev.record(y)
    assert not ev._event.query()
    ev.sync()
    assert ev._event.query()
    assert float(y.sum()) == 2 * (1 << 20)
