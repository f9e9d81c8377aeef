"""Several PS workers on localhost with the port's client and runtime
(mirrors ``tests/test_ps_multiworker.py``): push/pull across a barrier,
a BSP fleet's losses against the JAX package trained in one process on
the workers' batches together, the device cache's staleness refresh,
its kPushSyncEmbedding fold, the drain and the dense HET weights'
pull-back at two workers, and Hybrid refused across worker processes
outside one job.
Module-level imports stay light: spawned workers import this module."""
import multiprocessing as mp
import os

import numpy as np
import pytest

from hetu_tpu_torch.ps import server as ps_server
from torch_ps_util import start_server

CONFIG = """
nodes:
  - host: localhost
    servers: 2
    workers: 2
    chief: true
"""


def _worker(rank, nworkers, port, results):
    os.environ["HETU_PS_PORTS"] = str(port)
    os.environ["HETU_PS_HOSTS"] = "127.0.0.1"
    from hetu_tpu_torch.ps.client import PSClient
    client = PSClient(rank=rank, nworkers=nworkers)
    tid = 3000
    client.init_tensor(tid, (4,), kind=0, opt="None")   # first init wins
    client.barrier()
    if rank == 0:
        client.set_param(tid, np.zeros(4, np.float32))
    client.barrier()
    # every worker pushes rank+1; after barrier all see the sum
    client.push(tid, np.full(4, rank + 1, np.float32))
    client.wait(tid)
    client.barrier()
    out = client.pull(tid, (4,))
    results[rank] = float(out[0])
    client.barrier()
    client.close()


def test_two_workers_push_pull_barrier():
    port, _ = start_server(nworkers=2)
    ctx = mp.get_context("spawn")
    try:
        with ctx.Manager() as mgr:
            results = mgr.dict()
            ps_ = [ctx.Process(target=_worker, args=(r, 2, port, results))
                   for r in range(2)]
            for p in ps_:
                p.start()
            for p in ps_:
                p.join(timeout=60)
                assert p.exitcode == 0
            # 1 + 2 pushed onto zeros
            assert results[0] == results[1] == 3.0
    finally:
        for p in ps_:
            if p.is_alive():
                p.kill()
        ps_server.shutdown_server()


# a CTR graph whose table and dense weight live on the servers; each
# rank draws its own batches
GRAPH = """
import os
import numpy as np
import hetu_tpu_torch as ht

rank = int(os.environ["HETU_PS_RANK"])
rng = np.random.RandomState(0)
emb_val = rng.randn(50, 8).astype("f") * 0.1
w_val = rng.randn(8 * 4 + 5, 1).astype("f") * 0.1
dense = ht.Variable("dense", trainable=False)
sparse = ht.Variable("sparse", trainable=False)
y_ = ht.Variable("y_", trainable=False)
emb = ht.Variable("ctr_embedding", value=emb_val)
w = ht.Variable("ctr_w", value=w_val)
look = ht.embedding_lookup_op(emb, sparse)
flat = ht.array_reshape_op(look, (-1, 8 * 4))
feats = ht.concat_op(flat, dense, axis=1)
y = ht.sigmoid_op(ht.matmul_op(feats, w))
loss = ht.reduce_mean_op(ht.binarycrossentropy_op(y, y_), [0])
train_op = ht.optim.SGDOptimizer(learning_rate=0.3).minimize(loss)
frng = np.random.RandomState(1 + rank)


def batch():
    d = frng.randn(16, 5).astype("f")
    s = frng.randint(0, 50, (16, 4))
    return {dense: d, sparse: s, y_: (d[:, :1] > 0).astype("f")}


def out(name):
    return os.path.join(os.environ["HETU_TEST_OUT"], f"{name}_{rank}")
"""

BSP_WORKER = GRAPH + """
exe = ht.Executor([loss, train_op], ctx=ht.cpu(0), comm_mode="PS",
                  bsp=True)
losses = [exe.run(feed_dict=batch())[0].asnumpy().item()
          for _ in range(12)]
exe.close()
np.save(out("bsp"), np.array(losses))
"""

BSP_STEPS = 12


def _one_process_twin():
    """The JAX package in one process, without a server: each step
    evaluates the loss on each rank's batch, then trains one SGD step on
    the two batches together. The mean over 32 rows has the gradient
    (g0 + g1) / 2, which is what the server applies from the two
    workers' pushes scaled by 1 / nworkers."""
    import hetu_tpu as ht
    rng = np.random.RandomState(0)
    emb_val = rng.randn(50, 8).astype("f") * 0.1
    w_val = rng.randn(8 * 4 + 5, 1).astype("f") * 0.1
    dense = ht.Variable("dense", trainable=False)
    sparse = ht.Variable("sparse", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    emb = ht.Variable("ctr_embedding", value=emb_val)
    w = ht.Variable("ctr_w", value=w_val)
    look = ht.embedding_lookup_op(emb, sparse)
    flat = ht.array_reshape_op(look, (-1, 8 * 4))
    feats = ht.concat_op(flat, dense, axis=1)
    y = ht.sigmoid_op(ht.matmul_op(feats, w))
    loss = ht.reduce_mean_op(ht.binarycrossentropy_op(y, y_), [0])
    train_op = ht.optim.SGDOptimizer(learning_rate=0.3).minimize(loss)
    exe = ht.Executor({"train": [loss, train_op], "eval": [loss]},
                      ctx=ht.cpu(0))
    rngs = [np.random.RandomState(1 + r) for r in range(2)]
    losses = [[], []]
    for _ in range(BSP_STEPS):
        feeds = []
        for r in range(2):
            d = rngs[r].randn(16, 5).astype("f")
            s = rngs[r].randint(0, 50, (16, 4))
            feeds.append((d, s, (d[:, :1] > 0).astype("f")))
            losses[r].append(np.asarray(exe.run("eval", feed_dict={
                dense: d, sparse: s, y_: feeds[-1][2]})[0].asnumpy()
            ).item())
        d, s, yv = (np.concatenate(x) for x in zip(*feeds))
        exe.run("train", feed_dict={dense: d, sparse: s, y_: yv})
    return losses


def test_bsp_fleet_matches_one_process_twin(tmp_path):
    """BSP over 2 workers and 2 servers, the dense weight and shared rows
    trained through the servers: each step pulls, barriers, pushes,
    barriers and pulls the dense weight back, so every worker computes
    from the same values and the fleet is the one-process SGD on both
    batches. Each rank's losses agree with the JAX package's twin
    within 1e-5 relative."""
    from torch_ps_util import run_fleet
    proc = run_fleet("hetu_tpu_torch", CONFIG, BSP_WORKER, tmp_path)
    assert proc.returncode == 0, proc.stdout
    want = _one_process_twin()
    for rank in range(2):
        got = np.load(tmp_path / f"bsp_{rank}.npy")
        assert len(got) == BSP_STEPS
        np.testing.assert_allclose(got, want[rank], rtol=1e-5)


CACHE_WORKER = GRAPH + """
exe = ht.Executor([loss, train_op], ctx=ht.cpu(0), comm_mode="PS",
                  cstable_policy="Device", cache_bound=2)
client = exe.config.ps_comm
assert client.nworkers == 2 and client.nservers == 2
assert len(exe.config.ps_dense_cached) == 1      # w on the HET path
folds = [0]
push_sync = client.push_sync_embedding


def counted(*args, **kwargs):
    folds[0] += 1
    return push_sync(*args, **kwargs)


client.push_sync_embedding = counted
rt = exe.ps_runtime
dt = next(iter(rt.device_tables.values()))
client.barrier()            # train side by side
losses = [exe.run(feed_dict=batch())[0].asnumpy().item()
          for _ in range(15)]                    # run(): the fold path
# both workers' updates so far are on the server: the blocks' refresh
# must see the other worker's
rt.drain()
client.barrier()
for _ in range(3):                               # run_batches blocks
    losses += [o[0].asnumpy().item()
               for o in exe.run_batches([batch() for _ in range(5)])]
rt.drain()
dirty = bool(dt.dirty.any())
client.barrier()            # every worker's last pushes have landed
rt.drain()                  # pushes zeros, pulls the dense value back
client.barrier()
wid = str(w.id)
server_w = client.pull(w.id, (8 * 4 + 5,))
dense_err = float(np.abs(exe.params[wid].numpy().ravel() - server_w).max())
ids = np.arange(50)
moved = float(np.abs(client.sparse_pull(dt.tid, ids, 8) - emb_val).max())
client.barrier()            # no worker reads past another's exit
np.save(out("cache"), np.array(losses))
with open(out("cache") + ".txt", "w") as f:
    f.write(f"{dt.pulled_rows - dt.misses} {folds[0]} {int(dirty)} "
            f"{dense_err} {moved} {dt.pushed_rows}")
exe.close()
"""


def test_device_cache_fleet_refreshes_folds_and_drains(tmp_path):
    """The device cache over 2 workers and 2 servers (ASP, cache_bound
    2, the dense weight on the unified HET path): the staleness refresh
    pulls rows the other worker moved, a due drain folds into the
    refresh as one kPushSyncEmbedding, drain() leaves no dirty row, the
    server rows move, and after the last drains every worker holds the
    server's dense value."""
    from torch_ps_util import run_fleet
    proc = run_fleet("hetu_tpu_torch", CONFIG, CACHE_WORKER, tmp_path)
    assert proc.returncode == 0, proc.stdout
    for rank in range(2):
        losses = np.load(tmp_path / f"cache_{rank}.npy")
        refreshed, folds, dirty, dense_err, moved, pushed = (
            tmp_path / f"cache_{rank}.txt").read_text().split()
        assert len(losses) == 30 and np.all(np.isfinite(losses))
        assert np.mean(losses[15:]) < np.mean(losses[:15]), losses
        assert int(refreshed) > 0 and int(folds) > 0
        assert int(dirty) == 0 and int(pushed) > 0
        assert float(dense_err) == 0.0
        assert float(moved) > 1e-4


def test_hybrid_is_refused_across_worker_processes(monkeypatch):
    """Each worker process of a fleet sees one worker in its context, so
    the client's worker count decides: Hybrid across worker processes
    that have not joined one job (the launcher's ``spmd: true``) has no
    process group for its dense allreduce, and is refused; PS mode is
    accepted. Hybrid in such a job trains: tests/test_torch_hybrid_fleet.py."""
    import hetu_tpu_torch as tht
    from hetu_tpu_torch.ps import client as ps_client
    port, _ = start_server(nworkers=2)
    monkeypatch.setenv("HETU_PS_PORTS", str(port))
    monkeypatch.setenv("HETU_PS_HOSTS", "127.0.0.1")
    monkeypatch.setenv("HETU_PS_NWORKERS", "2")
    monkeypatch.setenv("HETU_PS_RANK", "1")
    prev = ps_client._default_client
    ps_client._default_client = None

    def graph():
        table = tht.Variable("t", value=np.zeros((4, 2), np.float32))
        ids = tht.Variable("i", trainable=False)
        loss = tht.reduce_sum_op(tht.embedding_lookup_op(table, ids), [0])
        return [loss, tht.optim.SGDOptimizer(0.1).minimize(loss)]

    try:
        with pytest.raises(NotImplementedError,
                           match="refused on purpose.*spmd: true"):
            tht.HetuConfig(graph(), comm_mode="Hybrid", device="cpu")
        cfg = tht.HetuConfig(graph(), comm_mode="PS", device="cpu")
        assert cfg.ps_comm.nworkers == 2 and cfg.ps_comm.rank == 1
        assert cfg.rank == 1
    finally:
        ps_client.close_default_client()
        ps_client._default_client = prev
        ps_server.shutdown_server()
