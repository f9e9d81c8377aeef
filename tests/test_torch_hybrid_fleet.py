"""Hybrid across the port's launcher's worker processes: the dense
weights all-reduced over the job's process group (``spmd: true``, gloo
on the CPU), the embedding table on one parameter server, two workers
fed the same global batch (the JAX package's
``tests/test_hybrid.py`` and ``tests/test_launcher.py``
``SPMD_HYBRID_WORKER``).

* **The device cache under BSP** (``test_hybrid.py`` ``_model``, 10
  steps, cache_bound 4): each rank's cache is its own, its rows'
  gradient all-gathered so every cache takes the global batch's update,
  and each rank drains its accumulator / 2 to the server every step.
  Losses and the server's rows after ``drain()`` against the JAX
  package's one-process twin, rtol 1e-4 (``test_hybrid.py``'s).
* **ASP through the device cache** (``SPMD_HYBRID_WORKER``: 25 steps,
  cache_bound 3, drains on the push pool): timing decides what a refresh
  reads, so the run is held to the JAX test's properties — losses fall,
  the server's rows moved, and the dense weights identical on both ranks
  (rtol 1e-5).
* **The host path under BSP** (``test_hybrid.py``'s host-path model):
  rows pulled for the global batch, each rank's sparse gradient pushed
  / 2. Losses against the one-process twin, rtol 1e-5.

Dense weights ride the allreduce, never the PS: ``ps_dense_cached``
stays empty. One fleet runs all three sessions (a module fixture).
"""
import numpy as np
import pytest

import hetu_tpu as jht
from torch_ps_util import run_fleet

CONFIG = """
spmd: true
nodes:
  - host: localhost
    servers: 1
    workers: 2
    chief: true
"""

DATA = r"""
import numpy as np


def cache_data():
    rng = np.random.RandomState(0)
    table = rng.randn(64, 4).astype(np.float32)
    w_val = rng.randn(4, 2).astype(np.float32) * 0.3
    batches = [(rng.randint(0, 64, (16, 3)),
                rng.randn(16, 2).astype(np.float32)) for _ in range(10)]
    return table, w_val, batches


def host_data():
    rng = np.random.RandomState(1)
    table = rng.randn(40, 4).astype(np.float32)
    w_val = rng.randn(4, 2).astype(np.float32) * 0.3
    batches = [(rng.randint(0, 40, (8, 3)),
                rng.randn(8, 2).astype(np.float32)) for _ in range(8)]
    return table, w_val, batches


def model(ht, table, w_val):
    ids = ht.Variable("hy_ids", trainable=False)
    y_ = ht.Variable("hy_y", trainable=False)
    tbl = ht.Variable("hy_table", value=table)
    w = ht.Variable("hy_w", value=w_val)
    rows = ht.embedding_lookup_op(tbl, ids)
    pred = ht.matmul_op(ht.reduce_sum_op(rows, [1]), w)
    diff = pred + (-1) * y_
    loss = ht.reduce_mean_op(ht.reduce_sum_op(diff * diff, [1]), [0])
    train = ht.optim.SGDOptimizer(0.05).minimize(loss)
    return ids, y_, loss, train, tbl
"""

WORKER = DATA + r"""
import os
import torch.distributed as dist
import hetu_tpu_torch as ht

out = os.environ["HETU_TEST_OUT"]
rank = int(os.environ["RANK"])


def run(exe, ids, y_, batches):
    return [float(exe.run(feed_dict={ids: i, y_: y},
                          convert_to_numpy_ret_vals=True)[0])
            for i, y in batches]


def server_rows(exe, tid, n, width):
    client = exe.config.ps_comm
    return client.sparse_pull(tid, np.arange(n), width)


# 1. the device cache under BSP
table, w_val, batches = cache_data()
ids, y_, loss, train, tbl = model(ht, table, w_val)
exe = ht.Executor([loss, train], ctx=ht.cpu(0), comm_mode="Hybrid",
                  cstable_policy="Device", cache_bound=4, bsp=True)
cfg = exe.config
assert cfg.nrank == 2 and dist.get_backend() == "gloo", cfg.nrank
assert cfg.device_cache_tables and not cfg.ps_dense_cached
losses = run(exe, ids, y_, batches)
exe.ps_runtime.drain()
dist.barrier()
np.savez(os.path.join(out, f"cache_{rank}.npz"), losses=losses,
         rows=server_rows(exe, tbl.id, 64, 4))
exe.close()

# 2. ASP through the device cache: the JAX package's SPMD_HYBRID_WORKER
rng = np.random.RandomState(0)
emb_val = rng.randn(50, 8).astype("f") * 0.1
w_val = rng.randn(8 * 4 + 5, 1).astype("f") * 0.1
dense = ht.Variable("dense", trainable=False)
sparse = ht.Variable("sparse", trainable=False)
y2 = ht.Variable("y_", trainable=False)
emb = ht.Variable("hy2_embedding", value=emb_val)
w = ht.Variable("hy2_w", value=w_val)
look = ht.embedding_lookup_op(emb, sparse)
flat = ht.array_reshape_op(look, (-1, 8 * 4))
feats = ht.concat_op(flat, dense, axis=1)
y = ht.sigmoid_op(ht.matmul_op(feats, w))
loss = ht.reduce_mean_op(ht.binarycrossentropy_op(y, y2), [0])
train = ht.optim.SGDOptimizer(learning_rate=0.3).minimize(loss)
exe = ht.Executor([loss, train], ctx=ht.cpu(0), comm_mode="Hybrid",
                  cstable_policy="Device", cache_bound=3)
assert not exe.config.ps_dense_cached
frng = np.random.RandomState(1)    # the same batches on both ranks
losses = []
for step in range(25):
    d = frng.randn(16, 5).astype("f")
    s = frng.randint(0, 50, (16, 4))
    yv = (d[:, :1] > 0).astype("f")
    losses.append(float(exe.run(feed_dict={dense: d, sparse: s, y2: yv}
                                )[0].asnumpy()))
exe.ps_runtime.drain()
rt = next(iter(exe.ps_runtime.device_tables.values()))
touched = np.nonzero(rt.id_of >= 0)[0]
moved_ids = rt.id_of[touched][:5]
delta = float(np.abs(exe.config.ps_comm.sparse_pull(rt.tid, moved_ids, 8)
                     - emb_val[moved_ids]).max())
np.savez(os.path.join(out, f"asp_{rank}.npz"), losses=losses, delta=delta,
         w=exe.params[str(w.id)].numpy())
dist.barrier()
exe.close()

# 3. the host path under BSP
table, w_val, batches = host_data()
ids, y_, loss, train, tbl = model(ht, table, w_val)
exe = ht.Executor([loss, train], ctx=ht.cpu(0), comm_mode="Hybrid",
                  bsp=True)
assert exe.subexecutors["default"].ps_lookups
assert not exe.config.ps_dense_cached
losses = run(exe, ids, y_, batches)
exe.ps_runtime.drain()
dist.barrier()
np.savez(os.path.join(out, f"host_{rank}.npz"), losses=losses,
         rows=server_rows(exe, tbl.id, 40, 4),
         dense_calls=exe.config.dp_comm.stats["dense"]["calls"])
exe.close()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid")
    proc = run_fleet("hetu_tpu_torch", CONFIG, WORKER, tmp, timeout=240)
    assert proc.returncode == 0, proc.stdout
    return tmp


def _twin(data):
    """The JAX package in one process, without a server (``comm_mode``
    None): the losses and the table after the steps."""
    scope = {}
    exec(DATA, scope)
    table, w_val, batches = scope[data]()
    ids, y_, loss, train, tbl = scope["model"](jht, table, w_val)
    exe = jht.Executor([loss, train], comm_mode=None)
    losses = [float(exe.run(feed_dict={ids: i, y_: y},
                            convert_to_numpy_ret_vals=True)[0])
              for i, y in batches]
    return losses, np.asarray(exe.params[str(tbl.id)])


def test_device_cache_fleet_matches_the_one_process_twin(fleet):
    losses, table = _twin("cache_data")
    for r in range(2):
        rec = np.load(fleet / f"cache_{r}.npz")
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(rec["rows"], table, rtol=1e-4,
                                   atol=1e-6)


def test_asp_fleet_trains_and_keeps_the_dense_weights_together(fleet):
    """The JAX package's two-process Hybrid ASP test's assertions."""
    recs = [np.load(fleet / f"asp_{r}.npz") for r in range(2)]
    for rec in recs:
        losses = rec["losses"]
        assert losses[-1] < losses[0], (losses[:3], losses[-3:])
        assert float(rec["delta"]) > 1e-4
    np.testing.assert_allclose(recs[0]["w"], recs[1]["w"], rtol=1e-5,
                               atol=1e-7)


def test_host_path_bsp_fleet_matches_the_one_process_twin(fleet):
    losses, table = _twin("host_data")
    for r in range(2):
        rec = np.load(fleet / f"host_{r}.npz")
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(rec["rows"], table, rtol=1e-5,
                                   atol=1e-6)
        # the dense weight's gradient: one allreduce a step
        assert int(rec["dense_calls"]) == 8
