"""The GNN models of ``models/gnn.py`` and the modules that came with
them, trained in hetu_tpu and in the port on the CPU from the same
initial values (both draw them from numpy, seeded by parameter name) and
the same numpy inputs:

* ``gcn`` and ``graphsage`` at ``tests/test_models.py``'s sizes (40
  nodes, 12 features, hidden 16, 3 classes): 4 SGD steps, the losses
  within 1e-5 relative and every parameter after them within 1e-5; a
  ``GCN`` layer with ``custom_init``; a hetu_tpu checkpoint loaded into
  the port;
* ``GNNDataLoaderOp``: the double buffer, and executors that mix graph
  loaders (which count no batches) with a dataloader;
* the step, multi-step, exponential and plateau schedules over 30 steps,
  and SGD under a step schedule over 5 executor steps;
* AdamW over 3 steps, on a dense weight and on a table's sparse
  gradient (no decay there). The table has a spare last row no id
  touches: hetu_tpu's lazy Adam drops the slots of a table's last row
  when ids repeat (ROADMAP.md §3).
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu.models.gnn as JG
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu import lr_scheduler as jlr
from hetu_tpu_torch import lr_scheduler as tlr
from hetu_tpu_torch.dataloader import GNNDataLoaderOp

N, FDIM, HIDDEN, NCLS, STEPS = 40, 12, 16, 3, 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _norm_adj(n, avg_deg=4, seed=3):
    """tests/test_models.py's graph: random edges, self loops,
    symmetric normalization."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), avg_deg)
    cols = rng.randint(0, n, n * avg_deg)
    m = sp.coo_matrix((np.ones(n * avg_deg), (rows, cols)),
                      shape=(n, n)).tocsr()
    m = m + sp.eye(n, format="csr")
    deg = np.asarray(m.sum(1)).ravel()
    dinv = sp.diags(1.0 / np.sqrt(deg))
    return (dinv @ m @ dinv).tocsr()


def _graph_feeds(seed=4):
    rng = np.random.RandomState(seed)
    adj = _norm_adj(N)
    mask = np.ones(N, np.float32)
    mask[::5] = 0.0
    return {"adj": (adj.data.astype(np.float32), adj.indptr.astype(np.int32),
                    adj.indices.astype(np.int32)),
            "feat": rng.randn(N, FDIM).astype(np.float32),
            "y": np.eye(NCLS, dtype=np.float32)[rng.randint(0, NCLS, N)],
            "mask": mask}


def _kw(ht):
    return {"ctx": tht.cpu(0)} if ht is tht else {"ctx": jht.cpu(0)}


def _gnn_session(ht, models, builder):
    nodes = [ht.Variable(n, trainable=False)
             for n in ("feat", "y_", "mask_", "norm_adj")]
    loss, y, train_op = getattr(models, builder)(*nodes, FDIM, HIDDEN, NCLS)
    exe = ht.Executor([ht.reduce_mean_op(loss, [0]), y, train_op],
                      **_kw(ht))
    return exe, nodes


def _feed_dict(ht, nodes, f):
    # an ND_Sparse_Array every step: the executor makes it a CSRValue
    sp_adj = ht.ND_Sparse_Array(*f["adj"], nrow=N, ncol=N)
    return dict(zip(nodes, (f["feat"], f["y"], f["mask"], sp_adj)))


def _train(ht, exe, nodes, f, steps):
    return [float(np.asarray(exe.run(
        feed_dict=_feed_dict(ht, nodes, f))[0].asnumpy()).reshape(-1)[0])
        for _ in range(steps)]


def _params(exe):
    return {node.name: np.asarray(exe.params[sid])
            for sid, node in exe._param_nodes.items()}


def _assert_params(texe, jexe):
    tp, jp = _params(texe), _params(jexe)
    assert sorted(tp) == sorted(jp)
    for key in jp:
        np.testing.assert_allclose(tp[key], jp[key], err_msg=key, **TOL)


@pytest.mark.parametrize("builder", ["gcn", "graphsage"])
def test_gnn_builder_trains_like_the_reference(builder):
    f = _graph_feeds()
    jexe, jn = _gnn_session(jht, JM, builder)
    texe, tn = _gnn_session(tht, TM, builder)
    jl = _train(jht, jexe, jn, f, STEPS)
    tl = _train(tht, texe, tn, f, STEPS)
    assert tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    _assert_params(texe, jexe)
    names = set(_params(texe))
    assert {"gnn_l1_Weight", "gnn_l1_Bias", "gnn_l2_Weight", "gnn_l2_Bias",
            "gnn_classifier"} <= names
    assert ("gnn_l1_Weight2" in names) == (builder == "graphsage")


def test_gcn_layer_with_custom_init_trains_like_the_reference():
    f = _graph_feeds(seed=5)
    rng = np.random.RandomState(6)
    init = (rng.randn(FDIM, NCLS).astype(np.float32) * 0.3,
            rng.randn(NCLS).astype(np.float32) * 0.1)
    out = []
    for ht, models in ((jht, JG), (tht, TM)):
        nodes = [ht.Variable(n, trainable=False)
                 for n in ("feat", "y_", "mask_", "norm_adj")]
        layer = models.GCN(FDIM, NCLS, nodes[3], custom_init=init,
                           name="custom")
        logits = layer(nodes[0])
        loss = ht.reduce_mean_op(ht.mul_op(
            ht.softmaxcrossentropy_op(logits, nodes[1]), nodes[2]), [0])
        train_op = ht.optim.SGDOptimizer(0.5).minimize(loss)
        exe = ht.Executor([loss, train_op], **_kw(ht))
        out.append((exe, _train(ht, exe, nodes, f, 3)))
    (jexe, jl), (texe, tl) = out
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    _assert_params(texe, jexe)
    first = _params(tht.Executor([texe.eval_node_dict["default"][0]],
                                 ctx=tht.cpu(0)))
    np.testing.assert_array_equal(first["custom_Weight"], init[0])
    np.testing.assert_array_equal(first["custom_Bias"], init[1])


def test_a_hetu_tpu_checkpoint_loads_into_the_port(tmp_path):
    """Two steps in hetu_tpu, saved; the port loads them and both take
    a third step alike."""
    f = _graph_feeds(seed=7)
    jexe, jn = _gnn_session(jht, JM, "gcn")
    _train(jht, jexe, jn, f, 2)
    jexe.save(str(tmp_path))
    texe, tn = _gnn_session(tht, TM, "gcn")
    texe.load(str(tmp_path))
    _assert_params(texe, jexe)
    np.testing.assert_allclose(_train(tht, texe, tn, f, 1),
                               _train(jht, jexe, jn, f, 1), rtol=1e-5,
                               atol=0)
    _assert_params(texe, jexe)


@pytest.fixture
def _fresh_graph_buffer():
    GNNDataLoaderOp.graph = GNNDataLoaderOp.nxt_graph = None
    yield
    GNNDataLoaderOp.graph = GNNDataLoaderOp.nxt_graph = None


def test_gnn_loader_double_buffer_protocol(_fresh_graph_buffer):
    """step(g) rotates (current, next) for every instance at once
    (tests/test_gnn_sampled.py:47-62, on the port's class)."""
    a = {"v": np.ones(2, np.float32)}
    b = {"v": np.full(2, 2.0, np.float32)}
    c = {"v": np.full(2, 3.0, np.float32)}
    GNNDataLoaderOp.step(a)
    GNNDataLoaderOp.step(b)
    dl = GNNDataLoaderOp(lambda g: g["v"])
    other = GNNDataLoaderOp(lambda g: g["v"] * 10)
    np.testing.assert_array_equal(dl.get_arr("train"), a["v"])
    np.testing.assert_array_equal(dl.get_next_arr("train"), b["v"])
    np.testing.assert_array_equal(other.get_arr("train"), a["v"] * 10)
    assert dl.get_cur_shape("train") == (2,)
    assert dl.get_batch_num("train") is None
    GNNDataLoaderOp.step(c)
    np.testing.assert_array_equal(dl.get_arr("train"), b["v"])
    np.testing.assert_array_equal(dl.get_next_arr("train"), c["v"])


def test_executor_reads_the_current_graph_beside_a_dataloader(
        _fresh_graph_buffer):
    """A graph loader counts no batches, so the subgraph's batch count is
    the dataloader's, or None without one; each run reads the current
    graph, not the staged one."""
    x = GNNDataLoaderOp(lambda g: g["x"])
    alone = tht.Executor([tht.reduce_sum_op(x, [0])], ctx=tht.cpu(0))
    assert alone.batch_num is None
    z = tht.dataloader_op([tht.Dataloader(
        np.arange(12, dtype=np.float32).reshape(6, 2), 2, "default")])
    exe = tht.Executor([tht.reduce_sum_op(x, [0]),
                        tht.reduce_sum_op(z, [0])], ctx=tht.cpu(0))
    assert exe.batch_num == 3 and exe.get_batch_num() == 3
    graphs = [{"x": np.full((2, 2), float(i), np.float32)}
              for i in range(5)]
    GNNDataLoaderOp.step(graphs[0])
    GNNDataLoaderOp.step(graphs[1])
    for i in range(3):
        GNNDataLoaderOp.step(graphs[i + 2])     # current: graphs[i + 1]
        gx, gz = exe.run()
        np.testing.assert_array_equal(gx.asnumpy(), [2.0 * (i + 1)] * 2)
        np.testing.assert_array_equal(gz.asnumpy(),
                                      np.arange(4 * i, 4 * i + 4,
                                                dtype=np.float32)
                                      .reshape(2, 2).sum(0))


SCHEDULES = [
    ("StepScheduler", (0.5, 4), {"gamma": 0.5}),
    ("MultiStepScheduler", (0.5, [3, 10, 10, 22]), {"gamma": 0.3}),
    ("ExponentialScheduler", (0.5,), {"gamma": 0.9}),
    ("ReduceOnPlateauScheduler", (0.5,), {"patience": 2, "factor": 0.5}),
    ("ReduceOnPlateauScheduler", (0.5,),
     {"mode": "max", "threshold": 0.05, "threshold_mode": "abs",
      "patience": 1}),
]


@pytest.mark.parametrize("name,args,kwargs", SCHEDULES)
def test_schedules_match_the_reference_over_30_steps(name, args, kwargs):
    metrics = 1.0 + 0.3 * np.sin(np.arange(30) * 0.7) \
        + np.linspace(0, -0.5, 30)
    mine = getattr(tlr, name)(*args, **kwargs)
    theirs = getattr(jlr, name)(*args, **kwargs)
    for i in range(30):
        assert mine.get() == theirs.get(), i
        metric = float(metrics[i]) if "Plateau" in name else None
        assert mine.step(metric) == theirs.step(metric), i
    assert mine.get() == theirs.get()
    if "Plateau" in name:
        assert mine.get() < args[0]
        assert mine.step() == mine.get()         # no metric: no move


def test_schedules_refuse_bad_arguments():
    with pytest.raises(ValueError):
        tlr.StepScheduler(0.1, 0)
    with pytest.raises(ValueError):
        tlr.ReduceOnPlateauScheduler(0.1, mode="up")
    with pytest.raises(ValueError):
        tlr.ReduceOnPlateauScheduler(0.1, threshold_mode="pct")


def _dense_session(ht, opt):
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w = ht.init.xavier_uniform((6, 3), name="dense_w")
    b = ht.init.zeros((3,), name="dense_b")
    logits = ht.matmul_op(x, w)
    logits = logits + ht.broadcastto_op(b, logits)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    return ht.Executor([loss, opt.minimize(loss)], **_kw(ht)), (x, y_)


def _dense_batches(steps, seed=11):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 6).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])
            for _ in range(steps)]


def _run_twins(build, batches):
    out = []
    for ht in (jht, tht):
        exe, nodes = build(ht)
        losses = [float(np.asarray(exe.run(
            feed_dict=dict(zip(nodes, b)))[0].asnumpy()).reshape(-1)[0])
            for b in batches]
        out.append((exe, losses))
    return out


def test_sgd_under_a_step_schedule_trains_like_the_reference():
    def build(ht):
        sched = ht.lr.StepScheduler(0.8, step_size=2, gamma=0.5)
        return _dense_session(ht, ht.optim.SGDOptimizer(sched))
    (jexe, jl), (texe, tl) = _run_twins(build, _dense_batches(5))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    _assert_params(texe, jexe)
    opt = texe.subexecutors["default"].optimizer_ops[0].optimizer
    assert opt.learning_rate == 0.8 * 0.5 ** 2


def test_adamw_dense_trains_like_the_reference():
    def build(ht):
        return _dense_session(ht, ht.optim.AdamWOptimizer(
            0.05, weight_decay=0.1))
    (jexe, jl), (texe, tl) = _run_twins(build, _dense_batches(3, seed=12))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    _assert_params(texe, jexe)


def test_adamw_decays_dense_weights_and_not_sparse_rows():
    rows, width = 10, 4
    rng = np.random.RandomState(13)
    # ids repeat within a batch and never reach the spare last row
    batches = [(rng.randint(0, rows - 1, (8, 3)),
                np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)])
               for _ in range(3)]

    def build(ht):
        ids = ht.Variable("ids", trainable=False)
        y_ = ht.Variable("y_", trainable=False)
        table = ht.init.random_normal((rows, width), stddev=0.5,
                                      name="table")
        w = ht.init.xavier_uniform((width, 3), name="head_w")
        h = ht.reduce_sum_op(ht.embedding_lookup_op(table, ids), [1])
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
            ht.matmul_op(h, w), y_), [0])
        opt = ht.optim.AdamWOptimizer(0.05, weight_decay=0.5)
        return ht.Executor([loss, opt.minimize(loss)], **_kw(ht)), (ids, y_)
    (jexe, jl), (texe, tl) = _run_twins(build, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    _assert_params(texe, jexe)
    # rows no id touched kept their initial values: no decay on them
    table0 = _params(tht.Executor(
        [texe.eval_node_dict["default"][0]], ctx=tht.cpu(0)))["table"]
    untouched = sorted(set(range(rows)) - set(np.concatenate(
        [b[0].ravel() for b in batches])))
    assert untouched and untouched[-1] == rows - 1
    np.testing.assert_array_equal(_params(texe)["table"][untouched],
                                  table0[untouched])
