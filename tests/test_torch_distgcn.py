"""DistGCN-1.5D in the port against the JAX package's
(tests/test_distgcn.py's graph and meshes).

The JAX side runs ``hetu_tpu.parallel.distgcn`` under ``shard_map`` on
the host CPU devices tests/conftest.py provides; the port's ranks are
threads of this process over a local job (gloo groups over one
in-memory store, ``parallel/mesh.py`` ``LocalJob``). Tolerances are the
reference's: the SpMM and its transpose within 1e-5, the training losses
within 1e-5 relative of the JAX package's run and within 1e-4 of each
package's own ``csrmm_op`` model.
"""
import threading

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import hetu_tpu as jht
import hetu_tpu_torch as tht
import torch
from hetu_tpu.executor import HetuConfig as JConfig
from hetu_tpu.parallel import distgcn as jdg
from hetu_tpu_torch.parallel import distgcn as tdg
from hetu_tpu_torch.parallel import mesh as tmesh

MESHES = [(4, 2), (8, 1), (2, 2)]


def _graph(n=37, deg=4, seed=0):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.randint(0, n, n * deg)
    adj = sp.coo_matrix((np.ones(n * deg, np.float32), (rows, cols)),
                        shape=(n, n)).tocsr()
    adj = adj + sp.eye(n, format="csr", dtype=np.float32)
    d = np.asarray(adj.sum(1)).ravel()
    dinv = sp.diags(1.0 / np.sqrt(d))
    return (dinv @ adj @ dinv).tocsr()


def _jax_mesh(gr, gc):
    devs = np.asarray(jax.devices()[:gr * gc]).reshape(gr, gc)
    return Mesh(devs, axis_names=("gr", "gc"))


def _on_local_ranks(axes, fn):
    """``fn(mesh)`` on one thread a rank of a local job over ``axes``;
    the results by rank."""
    lm = tmesh.build_mesh(axes)
    job = tmesh.LocalJob(lm.size)
    out, errors = [None] * lm.size, []

    def go(r):
        try:
            out[r] = fn(lm.rank_mesh(job.job(r)))
        except BaseException as e:      # raised again below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(r,), daemon=True)
               for r in range(lm.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a rank did not finish"
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("gr,gc", MESHES)
def test_partition_is_bit_equal_to_the_reference(gr, gc):
    adj = _graph()
    want = jdg.partition_csr_15d(adj, gr, gc)
    got = tdg.partition_csr_15d(adj, gr, gc)
    for field in ("data", "rows", "cols"):
        w, g = getattr(want, field), getattr(got, field)
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)
    for field in ("n_per", "n_nodes", "gr", "gc"):
        assert getattr(got, field) == getattr(want, field)
    assert got.shape == (37, 37)


@pytest.mark.parametrize("gr,gc", MESHES)
def test_spmm_and_its_transpose_match_the_reference(gr, gc):
    """dist_gcn_spmm on every rank against the JAX package's and adj @ h;
    dist_gcn_spmm_t against the JAX package's vjp and adj.T @ dz."""
    adj = _graph()
    rng = np.random.RandomState(1)
    h = rng.randn(37, 8).astype(np.float32)
    dz = rng.randn(37, 8).astype(np.float32)
    jpart = jdg.partition_csr_15d(adj, gr, gc)
    mesh = _jax_mesh(gr, gc)
    with mesh:
        jz, vjp = jax.vjp(lambda x: jdg.dist_gcn_spmm(
            jax.device_put(jpart), x, mesh), jnp.asarray(h))
        (jdh,) = vjp(jnp.asarray(dz))
    part = tdg.partition_csr_15d(adj, gr, gc)
    got = _on_local_ranks(
        {"gr": gr, "gc": gc},
        lambda m: (tdg.dist_gcn_spmm(part, torch.from_numpy(h), m),
                   tdg.dist_gcn_spmm_t(part, torch.from_numpy(dz), m)))
    for z, dh in got:
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(z.numpy(), adj @ h, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(dh.numpy(), adj.T @ dz, rtol=1e-5,
                                   atol=1e-5)


def _gcn_inputs(n=37, fdim=8, hidden=12, ncls=4):
    adj = _graph(n=n)
    rng = np.random.RandomState(2)
    feat = rng.randn(n, fdim).astype(np.float32)
    y = np.eye(ncls, dtype=np.float32)[rng.randint(0, ncls, n)]
    w1 = rng.randn(fdim, hidden).astype(np.float32) * 0.3
    w2 = rng.randn(hidden, ncls).astype(np.float32) * 0.3
    return adj, feat, y, w1, w2


def _gcn(ht, w1_np, w2_np, dist):
    """tests/test_distgcn.py's 2-layer GCN: distgcn_15d_op layers, or
    csrmm_op ones (``dist`` False)."""
    feat = ht.Variable("feat", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    adj = ht.Variable("adj", trainable=False)
    w1 = ht.Variable("w1", value=w1_np)
    w2 = ht.Variable("w2", value=w2_np)
    if dist:
        h1 = ht.relu_op(ht.distgcn_15d_op(adj, feat, w1))
        logits = ht.distgcn_15d_op(adj, h1, w2)
    else:
        h1 = ht.relu_op(ht.csrmm_op(adj, ht.matmul_op(feat, w1)))
        logits = ht.csrmm_op(adj, ht.matmul_op(h1, w2))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return (feat, y_, adj), [loss, train]


def _losses(exe, feeds, values, steps=4):
    return [float(exe.run(feed_dict=dict(zip(feeds, values)),
                          convert_to_numpy_ret_vals=True)[0])
            for _ in range(steps)]


def test_training_at_4x2_matches_the_reference_and_one_device():
    """The twin of test_distgcn_training_matches_single_device: the
    2-layer GCN at (4, 2) for 4 SGD steps, the port in one process
    through ``mesh=`` (eight thread ranks), the JAX package on its host
    devices; each also against its own csrmm_op run."""
    adj, feat, y, w1, w2 = _gcn_inputs()
    n = adj.shape[0]
    sp_t = tht.ND_Sparse_Array(adj.data.astype(np.float32),
                               adj.indptr.astype(np.int32),
                               adj.indices.astype(np.int32), nrow=n, ncol=n)
    sp_j = jht.ND_Sparse_Array(adj.data.astype(np.float32),
                               adj.indptr.astype(np.int32),
                               adj.indices.astype(np.int32), nrow=n, ncol=n)

    feeds, nodes = _gcn(tht, w1, w2, dist=False)
    t_ref = _losses(tht.Executor(nodes, ctx=tht.cpu(0)), feeds,
                    (feat, y, sp_t))
    feeds, nodes = _gcn(tht, w1, w2, dist=True)
    exe = tht.Executor(nodes, ctx=tht.cpu(0),
                       mesh=tht.parallel.build_mesh({"gr": 4, "gc": 2}))
    assert exe.config.local_ranks.n == 8
    t_got = _losses(exe, feeds, (feat, y, tdg.partition_csr_15d(adj, 4, 2)))
    weights = [[r.params[str(p.id)].numpy() for p in
                (nodes[1].optimizer.params)] for r in exe.ranks]
    exe.close()

    feeds, nodes = _gcn(jht, w1, w2, dist=False)
    j_ref = _losses(jht.Executor(nodes), feeds, (feat, y, sp_j))
    feeds, nodes = _gcn(jht, w1, w2, dist=True)
    config = JConfig(eval_node_list=nodes, mesh=_jax_mesh(4, 2))
    j_got = _losses(jht.Executor({"default": nodes}, config=config), feeds,
                    (feat, y, jdg.partition_csr_15d(adj, 4, 2)))

    np.testing.assert_allclose(t_got, j_got, rtol=1e-5)
    np.testing.assert_allclose(t_got, t_ref, rtol=1e-4)
    np.testing.assert_allclose(j_got, j_ref, rtol=1e-4)
    # every rank updated the same replicated weights
    for rank in weights[1:]:
        for w, w0 in zip(rank, weights[0]):
            np.testing.assert_array_equal(w, w0)


@pytest.mark.parametrize("widths", [(8, 4), (4, 8)],
                         ids=["w_first", "spmm_first"])
@pytest.mark.parametrize("need_w", [True, False])
def test_layer_and_its_gradients_match_the_reference(widths, need_w):
    """One distgcn_15d_op layer at (2, 2): its value and dH, dW against
    the JAX package's, in both orders of the reference's rule (W first
    when it narrows the features) and without W."""
    fin, fout = widths
    adj = _graph()
    rng = np.random.RandomState(3)
    h_np = rng.randn(37, fin).astype(np.float32)
    w_np = rng.randn(fin, fout).astype(np.float32) * 0.3
    g_np = rng.randn(37, fout if need_w else fin).astype(np.float32)

    def run(ht, exe_of, part):
        h = ht.Variable("h", value=h_np)
        w = ht.Variable("w", value=w_np)
        a = ht.Variable("a", trainable=False)
        g = ht.Variable("g", trainable=False)
        z = ht.distgcn_15d_op(a, h, w, need_W=need_w)
        loss = ht.reduce_sum_op(z * g, [0, 1])
        dh, dw = ht.gradients(loss, [h, w])
        exe = exe_of(ht, [z, dh, dw])
        out = exe.run(feed_dict={a: part, g: g_np},
                      convert_to_numpy_ret_vals=True)
        return [np.asarray(v) for v in out]

    def port_exe(ht, nodes):
        return ht.Executor(nodes, ctx=ht.cpu(0),
                           mesh=ht.parallel.build_mesh({"gr": 2, "gc": 2}))

    def jax_exe(ht, nodes):
        config = JConfig(eval_node_list=nodes, mesh=_jax_mesh(2, 2))
        return ht.Executor({"default": nodes}, config=config)

    got = run(tht, port_exe, tdg.partition_csr_15d(adj, 2, 2))
    want = run(jht, jax_exe, jdg.partition_csr_15d(adj, 2, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_the_op_needs_a_gr_gc_mesh():
    """Without a ("gr", "gc") mesh both packages fail with the
    reference's message."""
    msg = r"distgcn_15d_op needs a mesh with \('gr', 'gc'\) axes"
    adj, feat, y, w1, _ = _gcn_inputs()
    for ht, dg in ((tht, tdg), (jht, jdg)):
        a = ht.Variable("a", trainable=False)
        h = ht.Variable("h", trainable=False)
        w = ht.Variable("w", value=w1)
        z = ht.distgcn_15d_op(a, h, w)
        kwargs = {"ctx": ht.cpu(0)} if ht is tht else {}
        exe = ht.Executor([z], **kwargs)
        with pytest.raises(AssertionError, match=msg):
            exe.run(feed_dict={a: dg.partition_csr_15d(adj, 1, 1),
                               h: feat})
