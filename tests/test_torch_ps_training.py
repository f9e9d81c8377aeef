"""PS and Hybrid training: the port against hetu_tpu, each package on
its own parameter server, from the same numpy table and weights and the
same numpy batches, on the CPU.

Every case trains a model with an embedding table and a dense weight
(the reference's tests/test_hybrid.py model) for STEPS steps in both
packages, then drains and reads the server's tensors: losses within
1e-5 relative, server rows within 1e-5 of the largest element. The
cases run the modes whose numbers do not depend on thread timing at one
worker: the host path under BSP, with ``prefetch=False`` and under ASP
with ``drain()`` after every step; the device cache with a capacity
small enough to evict and ``cache_bound`` 3, so drains happen during
the run, with the unified dense HET path for the dense weight under
SGD; Hybrid with the device cache and on the host path under BSP; and
Adam, Momentum and AdaGrad applied by the server. The host cache (LRU,
LFU, LFUOpt) pushes and pulls inside the C++ cache asynchronously, so
two runs of either package differ: it is held to its properties. Also:
``run_batches`` blocks against hetu_tpu's ``run_batches``,
``run_batches_stream`` equal to ``run_batches``, a hetu_tpu PS
checkpoint loaded by the port's ``Executor.load``, rows kept in float16
by the server's tiered store, AdaGrad on a sparse gradient, the
``loss_scale`` refusal and the mode inferred from the device group.
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch as tht
from torch_ps_util import both_servers

STEPS, B, SLOTS, ROWS, WIDTH = 10, 8, 3, 64, 4
TOL = 1e-5


@pytest.fixture(scope="module")
def clients():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with both_servers() as pair:
        yield pair
    torch.set_num_threads(threads)


def _opt(ht, name, lr):
    if name == "sgd":
        return ht.optim.SGDOptimizer(lr)
    if name == "adam":
        return ht.optim.AdamOptimizer(lr)
    if name == "momentum":
        return ht.optim.MomentumOptimizer(lr, momentum=0.9)
    return ht.optim.AdaGradOptimizer(lr)


def _model(ht, table, w_val, opt="sgd", lr=0.05, **opt_kw):
    ids = ht.Variable("ps_ids", trainable=False)
    y_ = ht.Variable("ps_y", trainable=False)
    tbl = ht.Variable("ps_table", value=table)
    w = ht.Variable("ps_w", value=w_val)
    rows = ht.embedding_lookup_op(tbl, ids)
    pred = ht.matmul_op(ht.reduce_sum_op(rows, [1]), w)
    diff = pred + (-1) * y_
    loss = ht.reduce_mean_op(ht.reduce_sum_op(diff * diff, [1]), [0])
    train = _opt(ht, opt, lr).minimize(loss)
    return dict(ids=ids, y=y_, tbl=tbl, w=w, loss=loss, train=train)


def _data(seed, steps=STEPS, rows=ROWS):
    rng = np.random.RandomState(seed)
    table = rng.randn(rows, WIDTH).astype(np.float32)
    w_val = (rng.randn(WIDTH, 2) * 0.3).astype(np.float32)
    batches = [(rng.randint(0, rows, (B, SLOTS)),
                rng.randn(B, 2).astype(np.float32)) for _ in range(steps)]
    return table, w_val, batches


def _executor(ht, m, kwargs):
    extra = {"ctx": tht.cpu(0)} if ht is tht else {}
    return ht.Executor([m["loss"], m["train"]], **extra, **kwargs)


def _server_tensors(client, m):
    """The server's table rows."""
    return client.sparse_pull(m["tbl"].id, np.arange(m["tbl"].shape[0]),
                              WIDTH)


def _train(ht, client, data, kwargs, opt="sgd", drain_each=False):
    table, w_val, batches = data
    m = _model(ht, table, w_val, opt)
    exe = _executor(ht, m, kwargs)
    losses = []
    for ids, y in batches:
        out = exe.run(feed_dict={m["ids"]: ids, m["y"]: y},
                      convert_to_numpy_ret_vals=True)
        losses.append(float(np.asarray(out[0]).ravel()[0]))
        if drain_each:
            exe.ps_runtime.drain()
    exe.ps_runtime.drain()
    info = {"losses": np.array(losses),
            "table": _server_tensors(client, m), "exe": exe, "m": m}
    exe.close()
    return info


def _close(got, want, tol=TOL):
    """Within ``tol`` of the largest element of ``want``."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


CASES = {
    "host_bsp": (dict(comm_mode="PS", bsp=True), False),
    "host_sync_push": (dict(comm_mode="PS", prefetch=False), False),
    "host_asp_drained": (dict(comm_mode="PS"), True),
    "device_cache_evicting": (dict(comm_mode="PS", cstable_policy="Device",
                                   cache_bound=3, cache_capacity=24), False),
    "device_cache_bsp": (dict(comm_mode="PS", cstable_policy="Device",
                              bsp=True), False),
    "hybrid_device_cache": (dict(comm_mode="Hybrid",
                                 cstable_policy="Device", cache_bound=3,
                                 cache_capacity=24), False),
    "hybrid_host_bsp": (dict(comm_mode="Hybrid", bsp=True), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ps_training_matches_hetu_tpu(clients, case):
    jc, tc = clients
    kwargs, drain_each = CASES[case]
    data = _data(seed=sorted(CASES).index(case))
    want = _train(jht, jc, data, kwargs, drain_each=drain_each)
    got = _train(tht, tc, data, kwargs, drain_each=drain_each)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    _close(got["table"], want["table"])
    # the cases exercise what they name
    sub = got["exe"].subexecutors["default"]
    cfg = got["exe"].config
    rt = got["exe"].ps_runtime
    if "device_cache" in case:
        assert sub.cached_lookups and not sub.ps_lookups
        dt = next(iter(rt.device_tables.values()))
        if case != "device_cache_bsp":
            assert dt.evicts > 0 and dt.pushed_rows > 0, dt.perf
    else:
        assert sub.ps_lookups and not sub.cached_lookups
    # the dense weight: on the server in PS mode, local in Hybrid
    m = got["m"]
    if case.startswith("hybrid"):
        assert m["w"].id not in rt.registered
    else:
        assert m["w"].id in rt.registered
        _close(tc.pull(m["w"].id, (WIDTH, 2)),
               jc.pull(want["m"]["w"].id, (WIDTH, 2)))
    assert (case == "device_cache_evicting") == bool(cfg.ps_dense_cached)


@pytest.mark.parametrize("policy", ["LRU", "LFU", "LFUOpt"])
def test_host_cache_policies_train(clients, policy):
    """The host cache (``cstable.py`` over ``ps_cache.cc``): one batch
    trained 10 times — finite losses that fall, lookups that hit and
    miss, and after a flush the server's rows of the batch have moved
    from the initial table, finite."""
    _, tc = clients
    table, w_val, batches = _data(seed=30 + len(policy))
    data = (table, w_val, [batches[0]] * STEPS)
    got = _train(tht, tc, data, dict(comm_mode="PS",
                                     cstable_policy=policy))
    losses = got["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    rt = got["exe"].ps_runtime
    cache = next(iter(rt.caches.values()))
    perf = cache.perf
    assert perf["hits"] > 0 and perf["misses"] > 0, perf
    cache.flush()
    tc.wait_all()
    ids = np.unique(batches[0][0])
    rows = tc.sparse_pull(got["m"]["tbl"].id, ids, WIDTH)
    assert np.isfinite(rows).all()
    assert np.abs(rows - table[ids]).max() > 1e-3


@pytest.mark.parametrize("opt", ["adam", "momentum", "adagrad"])
def test_server_optimizers_match_hetu_tpu(clients, opt):
    """The worker's optimizer runs on the server (PS host path, BSP):
    the server's Adam, Momentum and AdaGrad update table and weight."""
    jc, tc = clients
    data = _data(seed=20 + ["adam", "momentum", "adagrad"].index(opt))
    kwargs = dict(comm_mode="PS", bsp=True)
    want = _train(jht, jc, data, kwargs, opt=opt)
    got = _train(tht, tc, data, kwargs, opt=opt)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    _close(got["table"], want["table"])
    _close(tc.pull(got["m"]["w"].id, (WIDTH, 2)),
           jc.pull(want["m"]["w"].id, (WIDTH, 2)))


def _blocks(ht, client, data, kwargs, nblock, stream=False):
    table, w_val, batches = data
    m = _model(ht, table, w_val)
    exe = _executor(ht, m, kwargs)
    feeds = [{m["ids"]: ids, m["y"]: y} for ids, y in batches]
    blocks = [feeds[i:i + nblock] for i in range(0, len(feeds), nblock)]
    losses = []
    if stream:
        # the stream returns the last block's results: one block a call
        for block in blocks:
            out = exe.run_batches_stream([block],
                                         convert_to_numpy_ret_vals=True)
            losses += [float(np.asarray(o[0]).ravel()[0]) for o in out]
    else:
        for block in blocks:
            out = exe.run_batches(block, convert_to_numpy_ret_vals=True)
            losses += [float(np.asarray(o[0]).ravel()[0]) for o in out]
    exe.ps_runtime.drain()
    info = {"losses": np.array(losses),
            "table": _server_tensors(client, m), "exe": exe}
    exe.close()
    return info


BLOCK_CASES = {
    "device_cache": dict(comm_mode="PS", cstable_policy="Device",
                         cache_bound=3, cache_capacity=100),
    "host_bsp": dict(comm_mode="PS", bsp=True),
    "host_sync_push": dict(comm_mode="PS", prefetch=False),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_run_batches_blocks_match_hetu_tpu(clients, case):
    """Blocks of 4 steps: slots for a whole block are assigned up front
    (the device cache evicts between blocks and drains after them), as
    hetu_tpu's run_batches does; then run_batches_stream gives what
    run_batches gives."""
    jc, tc = clients
    kwargs = BLOCK_CASES[case]
    data = _data(seed=40 + sorted(BLOCK_CASES).index(case), steps=12,
                 rows=128)
    want = _blocks(jht, jc, data, kwargs, 4)
    got = _blocks(tht, tc, data, kwargs, 4)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    _close(got["table"], want["table"])
    if case == "device_cache":
        dt = next(iter(got["exe"].ps_runtime.device_tables.values()))
        assert dt.evicts > 0, dt.perf
    stream = _blocks(tht, tc, data, kwargs, 4, stream=True)
    np.testing.assert_array_equal(stream["losses"], got["losses"])
    np.testing.assert_array_equal(stream["table"], got["table"])


def test_port_loads_a_hetu_tpu_ps_checkpoint(clients, tmp_path):
    """hetu_tpu trains 3 steps in PS mode and saves (its worker's .npy
    files and the server's ps_<id>.bin); the port's Executor.load puts
    them into its own session and server, matching tensor ids by
    creation order; the next step's loss and the server's rows then
    agree."""
    jc, tc = clients
    table, w_val, batches = _data(seed=60, steps=4)
    kwargs = dict(comm_mode="PS", prefetch=False)
    jm = _model(jht, table, w_val)
    jexe = _executor(jht, jm, kwargs)
    for ids, y in batches[:3]:
        jexe.run(feed_dict={jm["ids"]: ids, jm["y"]: y})
    jexe.save(str(tmp_path))
    ids, y = batches[3]
    want = float(np.asarray(jexe.run(feed_dict={jm["ids"]: ids, jm["y"]: y},
                                     convert_to_numpy_ret_vals=True)[0]
                            ).ravel()[0])
    jexe.ps_runtime.drain()
    want_table = _server_tensors(jc, jm)
    jexe.close()

    tm = _model(tht, np.zeros_like(table), np.zeros_like(w_val))
    texe = _executor(tht, tm, kwargs)
    texe.load(str(tmp_path))
    got = float(texe.run(feed_dict={tm["ids"]: ids, tm["y"]: y},
                         convert_to_numpy_ret_vals=True)[0].ravel()[0])
    texe.ps_runtime.drain()
    np.testing.assert_allclose(got, want, rtol=TOL)
    _close(_server_tensors(tc, tm), want_table)
    texe.close()


def test_sparse_adagrad_matches_dense_rows():
    """AdaGrad on an IndexedSlices gradient updates the deduplicated
    rows as dense AdaGrad would, the table's last row included (the
    reference's padded dedup can keep that row's old accumulator when
    ids repeat, ROADMAP §3), and leaves the other rows alone."""
    opt = tht.optim.AdaGradOptimizer(0.1, initial_accumulator_value=0.1)
    rng = np.random.RandomState(7)
    param = torch.tensor(rng.randn(6, 3), dtype=torch.float32)
    idx = torch.tensor([5, 1, 5, 2])
    rows = torch.tensor(rng.randn(4, 3), dtype=torch.float32)
    accum = torch.full((6, 3), 0.1)
    grad = tht.IndexedSlices(idx, rows, (6, 3))
    new, slots = opt.update_one(param, grad, {"accum": accum}, 0.1, 0)
    dense = grad.to_dense()
    want_acc = accum + dense * dense
    want = param - 0.1 * dense / (torch.sqrt(want_acc) + opt.eps)
    touched = [1, 2, 5]
    torch.testing.assert_close(new[touched], want[touched], rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(slots["accum"][touched], want_acc[touched],
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(new[[0, 3, 4]], param[[0, 3, 4]])
    assert torch.equal(slots["accum"][[0, 3, 4]], accum[[0, 3, 4]])


def test_loss_scale_is_refused_with_ps_gradients(clients):
    table, w_val, _ = _data(seed=70, steps=1)
    m = _model(tht, table, w_val)
    m["train"].optimizer.loss_scale = 8.0
    with pytest.raises(ValueError, match="loss_scale"):
        _executor(tht, m, dict(comm_mode="PS"))


def test_tiered_f16_rows_train_like_hetu_tpu(clients, monkeypatch):
    """``HETU_PS_STORE_DTYPE=f16``: each package's runtime converts its
    freshly registered table to the server's tiered store, rows kept in
    float16 (2 bytes an element); the host path under BSP then trains
    as hetu_tpu's does, losses within 1e-5 relative."""
    jc, tc = clients
    monkeypatch.setenv("HETU_PS_STORE_DTYPE", "f16")
    data = _data(seed=90)
    kwargs = dict(comm_mode="PS", bsp=True)
    want = _train(jht, jc, data, kwargs)
    got = _train(tht, tc, data, kwargs)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    stats = tc.store_stats(got["m"]["tbl"].id)
    assert stats["row_bytes"] < 4 * WIDTH, stats
    _close(got["table"], want["table"])


def test_comm_mode_is_inferred_from_the_device_group(clients):
    """As in the reference (context.py:326): a session over a GPU worker
    and a CPU server is PS, one without a server uses no communication,
    and two workers are allreduce: outside a job, two devices of one
    process's context run as two thread ranks
    (tests/test_torch_local_ranks.py)."""
    table, w_val, _ = _data(seed=100, steps=1)
    m = _model(tht, table, w_val)
    cfg = tht.HetuConfig([m["loss"], m["train"]],
                         ctx=[tht.gpu(0), tht.cpu(0)], device="cpu")
    assert cfg.comm_mode == "PS" and cfg.nrank == 1
    assert cfg.ps_comm is clients[1]
    m = _model(tht, table, w_val)
    cfg = tht.HetuConfig([m["loss"], m["train"]], device="cpu")
    assert cfg.comm_mode is None and not cfg.ps_nodes
    m = _model(tht, table, w_val)
    cfg = tht.HetuConfig([m["loss"], m["train"]],
                         ctx=[tht.gpu(0), tht.gpu(1)], device="cpu")
    assert cfg.comm_mode == "AllReduce"
    assert (cfg.local_ranks.kind, cfg.local_ranks.n) == ("dp", 2)
