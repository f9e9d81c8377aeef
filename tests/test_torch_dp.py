"""Data parallelism in the port, in one process: the collectives, the
feed split, the fetch gather, the bucketed allreduce and the refusals.

Each rank is a thread with a gloo process group of its own over one
in-memory store (``ProcessGroupGloo``), and the executor's ``mesh=`` a
:class:`~hetu_tpu_torch.parallel.mesh.Mesh` over it: the executor's
code is the launcher's processes' (tests/test_torch_dp_fleet.py runs
those), without their start-up. The graphs are built before the threads
start (node ids come from one counter). References: the JAX package's
one-process run (``hetu_tpu``), and the port's own where the JAX package
has no such path. Tolerances: losses rtol 1e-5 (float32 sums in two
halves against one), the bucketed allreduce bit-equal to the
per-gradient one (the same elementwise sums).
"""
import datetime
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu_torch.executor import dp_backend
from hetu_tpu_torch.ndarray import IndexedSlices
from hetu_tpu_torch.ops import comm as tcomm
from hetu_tpu_torch.parallel import mesh as tmesh

RTOL = 1e-5


def _ranks(n, run, build=None):
    """``run(rank, comm_group, built)`` on n threads, each a rank of one
    gloo group; ``build(rank)`` runs first, serially. Returns the
    results by rank; a rank's exception is raised here."""
    built = [build(r) if build else None for r in range(n)]
    store = dist.HashStore()
    results, errors = [None] * n, [None] * n

    def go(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("dp", store), r, n,
                                       datetime.timedelta(seconds=60))
            results[r] = run(r, pg, built[r])
        except BaseException as e:      # raised again on the caller
            errors[r] = e

    threads = [threading.Thread(target=go, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a rank did not finish"
    for e in errors:
        if e is not None:
            raise e
    return results


def _mesh(rank, pg, n):
    return tmesh.Mesh({"dp": n}, rank, {"dp": pg})


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(12, 16).astype("f") * 0.3,
            rng.randn(16, 4).astype("f") * 0.3)


def _mlp(ht, weights=None, fetch_logits=False):
    """The JAX package's SPMD_DP_WORKER MLP (tests/test_launcher.py)."""
    w1v, w2v = weights or _weights()
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w1 = ht.Variable("w1", value=w1v)
    w2 = ht.Variable("w2", value=w2v)
    h = ht.relu_op(ht.matmul_op(x, w1))
    logits = ht.matmul_op(h, w2)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    train = ht.optim.SGDOptimizer(0.2).minimize(loss)
    nodes = [loss, train] if not fetch_logits else \
        [loss, logits, loss * 2.0 + 1.0, train]
    return x, y_, nodes, (w1, w2)


def _data(rows=32, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, 12).astype("f"),
            np.eye(4, dtype="f")[rng.randint(0, 4, rows)])


def _run(exe, x, y_, xs, ys, steps=6):
    out = []
    for _ in range(steps):
        vals = exe.run(feed_dict={x: xs, y_: ys},
                       convert_to_numpy_ret_vals=True)
        out.append([v for v in vals if v is not None])
    return out


def _jax_mlp_losses(xs, ys, steps=6):
    x, y_, nodes, _ = _mlp(jht)
    exe = jht.Executor(nodes, ctx=jht.cpu(0))
    return [float(np.asarray(o[0]).reshape(())) for o in
            _run(exe, x, y_, xs, ys, steps)]


def _port_dp(n, xs, ys, steps=6, fetch_logits=False, **options):
    def build(r):
        return _mlp(tht, fetch_logits=fetch_logits)

    def run(r, pg, built):
        x, y_, nodes, ws = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=_mesh(r, pg, n),
                           **options)
        out = _run(exe, x, y_, xs, ys, steps)
        params = [exe.params[str(w.id)].numpy().copy() for w in ws]
        return out, params, exe

    return _ranks(n, run, build)


# --- the collectives --------------------------------------------------------

def _count(comm):
    calls = []
    inner = comm.all_reduce

    def counted(tensor, op=None, kind="dense"):
        calls.append((kind, tuple(tensor.shape)))
        return inner(tensor, op, kind)

    comm.all_reduce = counted
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64, torch.bool,
                                   torch.bfloat16])
def test_gather_rows_pads_ragged_counts(dtype):
    """The all-gather as an all_reduce: the counts first, every rank's
    rows padded to the largest, the padding cut; two collectives, one
    when the caller knows the counts are equal."""
    def run(r, pg, _):
        comm = tcomm.GroupComm(pg)
        calls = _count(comm)
        rows = torch.arange(6 * (3 + 2 * r)).reshape(3 + 2 * r, 6) + 100 * r
        got = comm.gather_rows((rows % 3 == 0) if dtype == torch.bool
                               else rows.to(dtype))
        same = comm.gather_rows(torch.full((2, 3), r, dtype=torch.float32),
                                equal=True)
        return got, same, calls

    results = _ranks(2, run)
    want = torch.cat([torch.arange(6 * (3 + 2 * r)).reshape(-1, 6) + 100 * r
                      for r in range(2)])
    want = (want % 3 == 0) if dtype == torch.bool else want.to(dtype)
    for got, same, calls in results:
        assert got.dtype == dtype and torch.equal(got, want)
        assert same.tolist() == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
        assert [k for k, _ in calls] == ["fetch"] * 3


def test_sparse_gradient_is_all_gathered():
    """An IndexedSlices gradient: every rank's indices and values, the
    values divided by the rank count (reference comm.py:78-84), ragged
    index counts included."""
    def run(r, pg, _):
        comm = tcomm.GroupComm(pg)
        grad = IndexedSlices(torch.tensor([[r, 5]] * (1 + r)),
                             torch.full((1 + r, 2, 3), float(r + 1)),
                             (10, 3))
        out = comm.gather_slices(grad)
        return out.indices.tolist(), out.values, comm.stats["sparse"]

    for idx, vals, stats in _ranks(2, run):
        assert idx == [0, 5, 1, 5, 1, 5]
        np.testing.assert_array_equal(vals.numpy(), np.repeat(
            [[0.5] * 3, [0.5] * 3, [1.0] * 3, [1.0] * 3, [1.0] * 3,
             [1.0] * 3], 1, axis=0))
        assert stats["calls"] == 4         # counts and rows, twice


def test_dense_mean_keeps_the_dtype():
    """A dense gradient is averaged in its own dtype (the reference's
    pmean), bf16 included; the input is left as it was."""
    def run(r, pg, _):
        comm = tcomm.GroupComm(pg)
        g = torch.full((4,), 1.0 + r, dtype=torch.bfloat16)
        return comm.mean(g), g

    for out, g in _ranks(2, run):
        assert out.dtype == torch.bfloat16 and out.tolist() == [1.5] * 4
        assert g.tolist() in ([1.0] * 4, [2.0] * 4)


def test_group_allreduce_rides_its_mesh_axis():
    """``groupallreduceCommunicate_op(x, group="dp")`` averages over the
    mesh's dp axis; an axis the mesh lacks leaves the value as it is (the
    reference's op where its axis is unbound)."""
    def build(r):
        x = tht.Variable("x", trainable=False)
        return x, [tht.groupallreduceCommunicate_op(x, group="dp"),
                   tht.groupallreduceCommunicate_op(x, group="tp")]

    def run(r, pg, built):
        x, nodes = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=_mesh(r, pg, 2))
        return exe.run(feed_dict={x: np.full((3,), r + 1.0, "f")},
                       convert_to_numpy_ret_vals=True)

    for r, (dp, tp) in enumerate(_ranks(2, run, build)):
        assert dp.tolist() == [1.5] * 3 and tp.tolist() == [r + 1.0] * 3


# --- the executor -----------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_mlp_matches_the_jax_package_in_one_process(n):
    """The launcher test's MLP, global batch 32 over n ranks: losses as
    the JAX package's one process trains it, and every rank's weights
    the same."""
    xs, ys = _data()
    want = _jax_mlp_losses(xs, ys)
    results = _port_dp(n, xs, ys)
    for out, params, exe in results:
        assert exe.config.comm_mode == "AllReduce" and exe.config.nrank == n
        np.testing.assert_allclose([o[0] for o in out], want, rtol=RTOL)
        for a, b in zip(params, results[0][1]):
            np.testing.assert_array_equal(a, b)


def test_fetched_values_are_global():
    """Row-sharded fetches are gathered (the logits), means and affine
    ops of means averaged (the loss, 2 * loss + 1): each rank fetches
    what one process computes on the whole batch."""
    xs, ys = _data()
    x, y_, nodes, _ = _mlp(tht, fetch_logits=True)
    one = _run(tht.Executor(nodes, ctx=tht.cpu(0)), x, y_, xs, ys, 3)
    for out, _, exe in _port_dp(2, xs, ys, 3, fetch_logits=True):
        sub = exe.subexecutors["default"]
        kinds = [sub.dp.kind[n] for n in sub.eval_node_list[:3]]
        assert kinds == ["mean", ("rows", 0), "mean"]
        for got, want in zip(out, one):
            assert got[1].shape == (32, 4)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6)


def test_feed_split_replicated_ragged_feed_and_run_batches():
    """A feed whose dim 0 does not divide by the rank count is replicated
    (every rank computes the whole batch, the reference's rule); a
    run_batches block splits each step's feeds as run does."""
    xs, ys = _data(rows=15)
    want = _jax_mlp_losses(xs, ys, 3)

    def run(r, pg, built):
        x, y_, nodes, _ = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=_mesh(r, pg, 2))
        ragged = _run(exe, x, y_, xs, ys, 3)
        dp = exe.subexecutors["default"].dp
        shard = dp.shard({x: torch.zeros(16, 12), y_: torch.zeros(15, 4),
                          "n": 3})
        shard = (tuple(shard[x].shape), tuple(shard[y_].shape), shard["n"])
        block = exe.run_batches([{x: a, y_: b} for a, b in
                                 zip(np.split(_data(48)[0], 3),
                                     np.split(_data(48)[1], 3))],
                                convert_to_numpy_ret_vals=True)
        return ragged, shard, block, dp.kind[nodes[0]]

    results = _ranks(2, run, lambda r: _mlp(tht))
    x48, y48 = _data(48)
    x, y_, nodes, _ = _mlp(tht)
    one = tht.Executor(nodes, ctx=tht.cpu(0))
    _run(one, x, y_, xs, ys, 3)
    block_want = [one.run(feed_dict={x: a, y_: b},
                          convert_to_numpy_ret_vals=True)[0]
                  for a, b in zip(np.split(x48, 3), np.split(y48, 3))]
    for r, (ragged, shard, block, kind) in enumerate(results):
        np.testing.assert_allclose([o[0] for o in ragged], want, rtol=RTOL)
        assert shard == ((8, 12), (15, 4), 3)
        assert kind == "mean"
        np.testing.assert_allclose([b[0] for b in block], block_want,
                                   rtol=RTOL)


def _refused(build, feeds, match):
    def run(r, pg, built):
        nodes, feed_nodes = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=_mesh(r, pg, 2))
        with pytest.raises(NotImplementedError, match=match):
            exe.run(feed_dict=dict(zip(feed_nodes, feeds)))
        return True

    assert all(_ranks(2, run, lambda r: build()))


def test_a_sum_over_the_rows_is_refused():
    """DDP's rule averages gradients: a loss summed over the rows would
    train at 1 / nrank of the global batch's gradient."""
    def build():
        x = tht.Variable("x", trainable=False)
        w = tht.Variable("w", value=np.ones((3, 2), "f"))
        loss = tht.reduce_sum_op(tht.matmul_op(x, w), [0, 1])
        return [loss, tht.optim.SGDOptimizer(0.1).minimize(loss)], [x]

    _refused(build, [np.ones((4, 3), "f")],
             "ReduceSumOp.*ROADMAP item 11a\\.1")


def test_batch_norm_statistics_under_dp_are_refused():
    """Batch norm in a training step normalizes by its rows' statistics:
    each rank's would be its shard's (synced batch norm)."""
    def build():
        x = tht.Variable("x", trainable=False)
        w = tht.Variable("w", value=np.ones((1, 2, 3, 3), "f"))
        scale = tht.Variable("s", value=np.ones(2, "f"))
        bias = tht.Variable("b", value=np.zeros(2, "f"))
        h = tht.batch_normalization_op(tht.conv2d_op(x, w, padding=1),
                                       scale, bias)
        loss = tht.reduce_mean_op(h, [0, 1, 2, 3])
        return [loss, tht.optim.SGDOptimizer(0.1).minimize(loss)], [x]

    _refused(build, [np.ones((4, 1, 5, 5), "f")],
             "BatchNormalizationOp.*synced batch norm.*11a")


def test_a_per_row_op_of_a_mean_is_refused():
    """Centering the rows on the batch mean: each rank's mean is its
    shard's."""
    def build():
        x = tht.Variable("x", trainable=False)
        w = tht.Variable("w", value=np.ones((3, 2), "f"))
        h = tht.matmul_op(x, w)
        mean = tht.broadcastto_op(tht.reduce_mean_op(h, [0], keepdims=True),
                                  h)
        loss = tht.reduce_mean_op((h - mean) * (h - mean), [0, 1])
        return [loss, tht.optim.SGDOptimizer(0.1).minimize(loss)], [x]

    _refused(build, [np.arange(12, dtype="f").reshape(4, 3)],
             "per-row op.*11a")


def test_modes_that_stay_refused():
    """A pipeline over a data-parallel mesh stays refused (11b.4), and a
    mesh for the planner's statuses outside a job names the ranks it
    needs. Several devices of one process's context, a mesh built
    outside a job and a graph with a splitting dispatch run as thread
    ranks of this process (tests/test_torch_local_ranks.py): the config
    holds their plan."""
    x, y_, nodes, _ = _mlp(tht)
    mesh = tmesh.Mesh({"dp": 1}, 0, {"dp": None})
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 11b\.4"):
        tht.HetuConfig(nodes, gpipe=True, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks, the job has 1"):
        tmesh.mesh_for_statuses([None], dp=2)
    plan = tht.HetuConfig(nodes, ctx=[tht.gpu(0), tht.gpu(1)],
                          device="cpu").local_ranks
    assert (plan.kind, plan.n, plan.axes) == ("dp", 2, {"dp": 2})
    local = tmesh.build_mesh({"dp": 2})
    assert isinstance(local, tmesh.LocalMesh) and local.size == 2
    h = tht.reduce_mean_op(tht.dispatch(x, (2, 1)), [0, 1])
    plan = tht.HetuConfig([h], device="cpu").local_ranks
    assert (plan.kind, plan.n, plan.axes) == ("tp", 2, {"tp0": 2})


def test_reference_communicator_outside_a_job(monkeypatch):
    """Without a launcher's job: rank 0 of 1, on card 0."""
    monkeypatch.delenv("HETU_COORDINATOR", raising=False)
    comm = tht.wrapped_mpi_nccl_init()
    assert (comm.rank, comm.nrank, comm.dev_id()) == (0, 1, 0)
    assert tht.mpi_nccl_init()[1] == 0


def test_mesh_helpers_match_the_reference():
    from hetu_tpu.parallel.mesh import factorized_axes
    for n in (1, 2, 6, 8, 12, 30):
        assert tmesh.factorized_axes(n) == factorized_axes(n)
    m = tmesh.Mesh({"dp": 2, "tp": 3}, 4, {"dp": "g0", "tp": "g1"})
    assert m.axis_names == ("dp", "tp") and m.devices.shape == (2, 3)
    assert m.group("tp") == "g1" and m.shape == {"dp": 2, "tp": 3}
    with pytest.raises(ValueError, match="no process group"):
        tmesh.Mesh({"dp": 2}, 0, {})


def test_backend_follows_the_layout(monkeypatch):
    """nccl where the rank's card is its own, gloo on the CPU and where
    ranks share a card (NCCL refuses two ranks on one card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for local, want in (("0", "nccl"), ("1", "gloo")):
        monkeypatch.setenv("LOCAL_RANK", local)
        assert dp_backend("cuda") == want
    assert dp_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert dp_backend(None) == "nccl"
    assert tht.resolve_device(None) == torch.device("cuda:3")


# --- the bucketed allreduce -------------------------------------------------

class _Ectx:
    def __init__(self, config, defer):
        self.config = config
        self.allreduce_defer = defer


class _Config:
    def __init__(self, comm, bucket_bytes):
        self.nrank = comm.nrank
        self.dp_comm = comm
        self.overlap = type("O", (), {"bucket_bytes": bucket_bytes})()


def test_buckets_reduce_as_the_per_gradient_path():
    """Reverse input order, dtype-pure buckets, one collective a bucket:
    one big bucket gives one collective for the f32 gradients (and one
    for the bf16 one), bucket_bytes=1 one a gradient; both bit-equal to
    the per-gradient reduction."""
    def run(r, pg, _):
        comm = tcomm.GroupComm(pg)
        g = torch.Generator().manual_seed(r)
        vals = [torch.randn(2, 2, generator=g).to(torch.bfloat16),
                torch.randn(3, 4, generator=g), torch.randn(5, generator=g),
                torch.randn(7, generator=g)]
        ops = [tcomm.AllReduceCommunicateOp(tht.Variable(f"g{i}"), comm=comm)
               for i in range(4)]
        per = [comm.mean(v) for v in vals]
        out = {}
        for bucket in (1 << 30, 1):
            calls = _count(comm)
            got = tcomm.settle_deferred_allreduce(
                ops, vals, _Ectx(_Config(comm, bucket), frozenset(ops)))
            out[bucket] = (got, [int(np.prod(s)) for _, s in calls])
            comm.all_reduce = tcomm.GroupComm.all_reduce.__get__(comm)
        return per, out

    for per, out in _ranks(2, run):
        assert out[1 << 30][1] == [7 + 5 + 12, 4]
        assert out[1][1] == [7, 5, 12, 4]
        for got, _ in out.values():
            for a, b in zip(got, per):
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_bucket_bytes_is_a_numeric_no_op_end_to_end():
    """The MLP under bucket_bytes: the same losses and weights as the
    per-gradient path, with one collective a step for its two dense
    gradients (the whole bucket) where the per-gradient path makes two."""
    xs, ys = _data()
    plain = _port_dp(2, xs, ys, 3)
    bucketed = _port_dp(2, xs, ys, 3,
                        overlap_options={"bucket_bytes": 1 << 20})
    for (out, params, exe), (bout, bparams, bexe) in zip(plain, bucketed):
        assert [o[0] for o in out] == [o[0] for o in bout]
        for a, b in zip(params, bparams):
            np.testing.assert_array_equal(a, b)
        assert exe.config.dp_comm.stats["dense"]["calls"] == 2 * 3
        assert bexe.config.dp_comm.stats["dense"]["calls"] == 3
        sub = bexe.subexecutors["default"]
        assert len(sub.allreduce_defer) == 2
