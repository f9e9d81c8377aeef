"""Several devices of one process's context, run as thread ranks
(``parallel/local_ranks.py``), on the CPU.

Each mode is held bit-equal to the same graph run as a job whose ranks
the test starts itself (tests/torch_tp_util.py: a thread a rank, each
executor given its ``mesh=`` or ``pp_options={"job": ...}``, as the
launcher's processes run it), and the data-parallel and tensor-parallel
MLPs to the JAX package's one-device run of it within 1e-5 relative.
A rank that raises makes ``run`` raise, and one that hangs fails within
``local_ranks.DEFAULT_TIMEOUT_S``.
"""
import inspect
import threading
import time

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu_torch.graph.node import Op
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.parallel import local_ranks
from hetu_tpu_torch.parallel import mesh as tmesh

from test_torch_pp_tp import _data as _pp_data, _mlp as _pp_mlp
from test_torch_pp_tp import _weights as _pp_weights
from torch_tp_util import job_ranks, ranks, same_ids

STEPS = 3


def _weights():
    rng = np.random.RandomState(0)
    return (rng.randn(12, 16).astype("f") * 0.3,
            rng.randn(16, 6).astype("f") * 0.3)


def _feeds(step):
    rng = np.random.RandomState(10 + step)
    return (rng.randn(8, 12).astype("f"),
            np.eye(6, dtype="f")[rng.randint(0, 6, 8)])


def _mlp(ht, split=None, extra=None):
    """A two-layer MLP; ``split`` = (activation parts, weight parts) of
    the second matmul; ``extra(h)`` wraps the hidden activation."""
    w1v, w2v = _weights()
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w1 = ht.Variable("w1", value=w1v)
    w2 = ht.Variable("w2", value=w2v)
    h = ht.relu_op(ht.matmul_op(x, w1))
    if extra is not None:
        h = extra(h)
    if split is None:
        logits = ht.matmul_op(h, w2)
    else:
        logits = ht.dispatch(ht.matmul_op(ht.dispatch(h, split[0]),
                                          ht.dispatch(w2, split[1])), (1, 1))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    train = ht.optim.SGDOptimizer(0.2).minimize(loss)
    return (x, y_), [loss, train], (w1, w2)


def _train(exe, feeds, steps=STEPS):
    out = []
    for i in range(steps):
        vals = exe.run(feed_dict=dict(zip(feeds, _feeds(i))),
                       convert_to_numpy_ret_vals=True)
        out.append(float(vals[0]))
    return out


def _params(exe, params):
    return [exe.params[str(p.id)].numpy().copy() for p in params]


def _jax_losses():
    feeds, nodes, _ = _mlp(jht)
    return _train(jht.Executor(nodes), feeds)


SPLITS = {
    "dp": (None, {"dp": 2}),
    "right": ((((1, 1), (1, 2))), {"tp0": 2}),
    "left": ((((2, 1), (1, 1))), {"tp0": 2}),
    "middle": ((((1, 2), (2, 1))), {"tp0": 2}),
    "grid": ((((2, 2), (2, 1))), {"tp0": 2, "tp1": 2}),
}


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_one_process_equals_the_thread_job(case):
    """AllReduce over a context of two workers, and each tensor-parallel
    split with no job: the thread ranks' losses and weights are the
    launcher-style job's bit for bit, and the JAX package's one-device
    losses within 1e-5."""
    split, axes = SPLITS[case]
    feeds, nodes, params = same_ids(_mlp, tht, split)
    kwargs = {"ctx": [tht.gpu(0), tht.gpu(1)], "device": "cpu"} \
        if split is None else {"ctx": tht.cpu(0)}
    exe = tht.Executor(nodes, **kwargs)
    plan = exe.config.local_ranks
    assert (plan.kind, plan.axes) == ("dp" if split is None else "tp", axes)
    got = _train(exe, feeds)
    got_w = [_params(r, params) for r in exe.ranks]
    exe.close()

    def run(r, mesh, built):
        feeds, nodes, params = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
        return _train(exe, feeds), _params(exe, params)

    want = ranks(axes, run, lambda r: _mlp(tht, split))
    assert got == want[0][0]
    for (_, w), g in zip(want, got_w):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, _jax_losses(), rtol=1e-5)


def test_a_local_mesh_is_the_context_of_workers():
    """``mesh=`` a mesh built outside a job runs the same ranks as a
    context of as many workers."""
    feeds, nodes, _ = same_ids(_mlp, tht)
    mesh = tht.parallel.build_mesh({"dp": 2})
    assert isinstance(mesh, tmesh.LocalMesh) and mesh.contexts is None
    by_mesh = _train(tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh), feeds)
    feeds, nodes, _ = _mlp(tht)
    by_ctx = _train(tht.Executor(nodes, ctx=[tht.gpu(0), tht.gpu(1)],
                                 device="cpu"), feeds)
    assert by_mesh == by_ctx
    named = tht.parallel.build_mesh({"dp": 2}, [tht.cpu(0), tht.cpu(1)])
    assert named.contexts == [tht.cpu(0), tht.cpu(1)]


@pytest.mark.parametrize("schedule", ["gpipe", "pipedream"])
def test_a_tuple_stage_equals_the_thread_job(schedule):
    """tests/test_torch_pp_tp.py's MLP (stage 0 column-splits w1 over two
    devices, stage 1 row-splits its activations over two more) in one
    process: four thread ranks, one a device in order of first use,
    bit-equal to the job of four ranks whose stages name their workers."""
    weights = _pp_weights(3)
    xs, ys = _pp_data(8, 4)
    opts = {schedule: True, "num_microbatches": 2 if schedule == "gpipe"
            else 1}
    x, y_, loss, train = same_ids(
        _pp_mlp, tht, weights, (tht.cpu(0), tht.cpu(1)),
        (tht.cpu(2), tht.cpu(3)))
    exe = tht.Executor([loss, train], **opts)
    assert exe.config.local_ranks.n == 4
    got = [float(exe.run(feed_dict={x: xs, y_: ys},
                         convert_to_numpy_ret_vals=True)[0])
           for _ in range(STEPS)]
    exe.close()

    def run(r, job, built):
        x, y_, loss, train = built
        exe = tht.Executor([loss, train], device="cpu",
                           pp_options={"job": job}, **opts)
        out = [exe.run(feed_dict={x: xs, y_: ys},
                       convert_to_numpy_ret_vals=True)[0]
               for _ in range(STEPS)]
        return out

    w = [(0, 1), (2, 3)]
    want = job_ranks(4, run, lambda r: _pp_mlp(
        tht, weights, tuple(tht.rcpu(f"worker{k}", 0) for k in w[0]),
        tuple(tht.rcpu(f"worker{k}", 0) for k in w[1])))
    losses = next(o for o in want if o[0] is not None)
    assert got == [float(v) for v in losses]


def test_save_load_and_run_batches_through_thread_ranks(tmp_path):
    """A 2-way split saved by its thread ranks writes whole tensors that
    a one-device session loads; run_batches is the loop of runs."""
    split = ((1, 1), (1, 2))
    feeds, nodes, params = same_ids(_mlp, tht, split)
    exe = tht.Executor(nodes, ctx=tht.cpu(0))
    blocks = exe.run_batches([dict(zip(feeds, _feeds(i)))
                              for i in range(STEPS)],
                             convert_to_numpy_ret_vals=True)
    exe.save(str(tmp_path))
    assert [r.params[str(params[1].id)].shape for r in exe.ranks] \
        == [(16, 3), (16, 3)]
    exe.close()
    feeds1, nodes1, params1 = same_ids(_mlp, tht, split)
    loop = tht.Executor(nodes1, ctx=tht.cpu(0))
    assert [float(b[0]) for b in blocks] == _train(loop, feeds1)
    one_feeds, one_nodes, one_params = _mlp(tht)
    one = tht.Executor(one_nodes, ctx=tht.cpu(0))
    one.load(str(tmp_path))
    whole = np.load(tmp_path / "w2.npy")
    assert whole.shape == (16, 6)
    np.testing.assert_array_equal(one.params[str(one_params[1].id)].numpy(),
                                  whole)
    # and the thread ranks load it back, each keeping its shard
    loop.load(str(tmp_path))
    np.testing.assert_array_equal(
        np.concatenate([r.params[str(params1[1].id)].numpy()
                        for r in loop.ranks], axis=1), whole)
    loop.close()


class _OnRank(Op):
    """The identity, except on dp rank 1, where ``action()`` runs
    first."""

    def __init__(self, node, action):
        super().__init__(_OnRank, [node])
        self.action = action

    def compute(self, input_vals, ectx):
        if ectx.config.mesh.coord("dp") == 1:
            self.action()
        return input_vals[0]

    def gradient(self, output_grad):
        return [output_grad]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


def _boom():
    raise ValueError("boom on rank 1")


def test_a_rank_that_raises_fails_the_run(monkeypatch):
    """Rank 1 raises while rank 0 waits in the gradient's all-reduce: the
    caller gets rank 1's exception at once, and the session refuses to
    run again."""
    monkeypatch.setattr(local_ranks, "DEFAULT_TIMEOUT_S", 20)
    feeds, nodes, _ = _mlp(tht, extra=lambda h: _OnRank(h, _boom))
    exe = tht.Executor(nodes, ctx=[tht.gpu(0), tht.gpu(1)], device="cpu")
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="boom on rank 1"):
        exe.run(feed_dict=dict(zip(feeds, _feeds(0))))
    assert time.monotonic() - t0 < 10
    with pytest.raises(RuntimeError, match="failed before"):
        exe.run(feed_dict=dict(zip(feeds, _feeds(0))))


def test_a_rank_that_hangs_fails_within_its_timeout(monkeypatch):
    monkeypatch.setattr(local_ranks, "DEFAULT_TIMEOUT_S", 2)
    release = threading.Event()
    feeds, nodes, _ = _mlp(tht, extra=lambda h: _OnRank(
        h, lambda: release.wait(30)))
    exe = tht.Executor(nodes, ctx=[tht.gpu(0), tht.gpu(1)], device="cpu")
    t0 = time.monotonic()
    try:
        with pytest.raises(TimeoutError, match=r"rank\(s\) \[.*1.*\]"):
            exe.run(feed_dict=dict(zip(feeds, _feeds(0))))
        assert time.monotonic() - t0 < 6
    finally:
        release.set()


def test_a_rank_copies_every_option_of_the_session():
    """Each thread rank's config is made from every argument of
    HetuConfig but the graph, the device and the mesh, which are the
    rank's own; the context is the one the session resolved."""
    from hetu_tpu_torch.executor import HetuConfig
    feeds, nodes, _ = _mlp(tht)
    exe = tht.Executor(nodes, ctx=[tht.gpu(0), tht.gpu(1)], device="cpu",
                       seed=7, cache_bound=3, bsp=True)
    opts = exe.config.rank_options
    params = set(inspect.signature(HetuConfig).parameters)
    assert set(opts) == params - {"eval_node_list", "device", "mesh",
                                  "options"}
    assert (opts["seed"], opts["cache_bound"], opts["bsp"]) == (7, 3, True)
    assert opts["ctx"] is exe.config.context
    assert all(r.config.seed == 7 and r.config.cache_bound == 3
               for r in exe.ranks)
    exe.close()


def test_a_clone_keeps_ids_and_shares_only_arrays():
    feeds, nodes, params = _mlp(tht)
    copied, mapping = local_ranks.clone_graph({"default": nodes})
    twin = copied["default"]
    assert [n.id for n in twin] == [n.id for n in nodes]
    assert all(mapping[n] is not n and mapping[n].id == n.id
               for n in mapping)
    w1 = mapping[params[0]]
    assert w1.tensor_value is params[0].tensor_value
    opt, topt = nodes[1].optimizer, twin[1].optimizer
    assert topt is not opt and topt.params == [mapping[p]
                                               for p in opt.params]


def test_launches_count_by_rank_where_ranks_are_threads():
    _build.reset_launch_counts()

    def go(r):
        _build.set_rank(r)
        for _ in range(r + 1):
            _build.count_launch("k", "tc")
        _build.set_rank(None)

    threads = [threading.Thread(target=go, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert _build.launch_counts["k"] == 6
    assert {r: c["k.tc"] for r, c in _build.rank_launch_counts.items()} \
        == {0: 1, 1: 2, 2: 3}
    _build.reset_launch_counts()
    assert not _build.rank_launch_counts


def test_ring_shift_goes_either_way():
    """``step=1`` sends to the next rank (ring attention's hop), ``-1`` to
    the previous (DistGCN's)."""
    mesh = tht.parallel.build_mesh({"gr": 3})
    job = tmesh.LocalJob(3)
    out = [None] * 3

    def go(r):
        comm = mesh.rank_mesh(job.job(r)).comm("gr")
        t = torch.full((2,), float(r))
        out[r] = (comm.ring_shift([t])[0].tolist(),
                  comm.ring_shift([t], step=-1)[0].tolist())

    threads = [threading.Thread(target=go, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert [o[0][0] for o in out] == [2.0, 0.0, 1.0]
    assert [o[1][0] for o in out] == [1.0, 2.0, 0.0]


def test_what_stays_refused(monkeypatch):
    """Hybrid over devices of one process (each worker needs its own
    parameter-server client), and several workers of one context inside
    a launcher's job of several processes."""
    feeds, nodes, _ = _mlp(tht)
    with pytest.raises(NotImplementedError,
                       match="refused on purpose.*spmd: true"):
        tht.HetuConfig(nodes, ctx=[tht.gpu(0), tht.gpu(1)], device="cpu",
                       comm_mode="Hybrid")
    monkeypatch.setenv("HETU_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="inside a launcher job"):
        tht.HetuConfig(nodes, ctx=[tht.gpu(0), tht.gpu(1)], device="cpu")


def test_ids_and_counts_hold_under_many_threads():
    """Thread ranks build ops and count launches at once: with more
    threads than cores and a short switch interval, every op gets an id
    of its own and no launch or collective count is lost."""
    import os
    import sys
    from hetu_tpu_torch.ops.comm import GroupComm
    n, per = 4 * (os.cpu_count() or 1) + 4, 200
    made = [None] * n
    comm = GroupComm.__new__(GroupComm)
    comm._stats_lock = threading.Lock()
    comm.reset_stats()
    _build.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def go(r):
            x = tht.Variable(f"v{r}", trainable=False)
            made[r] = [tht.relu_op(x) for _ in range(per)]
            for _ in range(per):
                _build.count_launch("k", "tc")
                comm._count("ring", time.perf_counter(), 1)

        threads = [threading.Thread(target=go, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    ids = [op.id for ops in made for op in ops]
    assert len(set(ids)) == n * per
    assert _build.launch_counts["k"] == n * per
    assert comm.stats["ring"]["calls"] == n * per
    _build.reset_launch_counts()
