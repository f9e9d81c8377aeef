"""PS-backed serving: the port against hetu_tpu on the CPU.

Each package trains the same embedding model in PS mode (synchronous
pushes, so the numbers do not depend on thread timing) on its own
server from the same numpy values, saves, rewrites its eval graph with
``serve_embeddings_from_ps`` and serves it from an
``InferenceSession(comm_mode="PS")`` with a row cache: the two
sessions' predictions agree within 1e-5, and each equals its training
executor's eval output. Also: the read-only client refuses every
mutating RPC, the session refuses a graph that pushes, and the LRU row
cache's hit and miss accounting.
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.serving as jserving
import hetu_tpu_torch as tht
import hetu_tpu_torch.serving as tserving
from hetu_tpu_torch.serving import InferenceSession, ReadOnlyPSClient
from hetu_tpu_torch.serving.embedding import _BLOCKED
from torch_ps_util import both_servers

ROWS, WIDTH, SLOTS = 200, 4, 3


@pytest.fixture(scope="module")
def clients():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with both_servers() as pair:
        yield pair
    torch.set_num_threads(threads)


def _model(ht, table, w_val):
    ids = ht.Variable("srv_ids", trainable=False)
    y_ = ht.Variable("srv_y", trainable=False)
    tbl = ht.Variable("srv_table", value=table)
    w = ht.Variable("srv_w", value=w_val)
    pred = ht.matmul_op(ht.reduce_sum_op(ht.embedding_lookup_op(tbl, ids),
                                         [1]), w)
    diff = pred + (-1) * y_
    loss = ht.reduce_mean_op(ht.reduce_sum_op(diff * diff, [1]), [0])
    train = ht.optim.SGDOptimizer(0.05).minimize(loss)
    return ids, y_, pred, loss, train


def _serve(ht, serving, path, table, w_val, batches, query):
    """Train 4 steps, save, serve; returns (training eval, session
    predictions twice, session)."""
    ids, y_, pred, loss, train = _model(ht, table, w_val)
    cpu = {"ctx": tht.cpu(0)} if ht is tht else {}
    exe = ht.Executor({"train": [loss, train], "eval": [pred]},
                      comm_mode="PS", prefetch=False, **cpu)
    for i, y in batches:
        exe.run("train", feed_dict={ids: i, y_: y})
    want = np.asarray(exe.run("eval", feed_dict={ids: query},
                              convert_to_numpy_ret_vals=True)[0])
    exe.save(str(path))
    exe.close()
    nodes = [pred]
    pulls = serving.serve_embeddings_from_ps(nodes)
    assert len(pulls) == 1
    sess = serving.InferenceSession(nodes, checkpoint=str(path),
                                    comm_mode="PS", embed_cache_rows=64,
                                    **cpu)
    first = sess.predict({ids: query})[0]
    again = sess.predict({ids: query})[0]
    return want, first, again, sess


def test_ps_session_matches_hetu_tpu(clients, tmp_path):
    rng = np.random.RandomState(0)
    table = rng.randn(ROWS, WIDTH).astype(np.float32)
    w_val = (rng.randn(WIDTH, 2) * 0.3).astype(np.float32)
    batches = [(rng.randint(0, ROWS, (8, SLOTS)),
                rng.randn(8, 2).astype(np.float32)) for _ in range(4)]
    query = rng.randint(0, 40, (13, SLOTS))     # ragged: bucket 16
    jwant, jfirst, jagain, jsess = _serve(
        jht, jserving, tmp_path / "j", table, w_val, batches, query)
    twant, tfirst, tagain, tsess = _serve(
        tht, tserving, tmp_path / "t", table, w_val, batches, query)
    assert tfirst.shape == (13, 2)
    np.testing.assert_allclose(tfirst, jfirst, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfirst, twant, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tagain, tfirst)
    np.testing.assert_allclose(jfirst, jwant, rtol=1e-5, atol=1e-6)
    # the second predict read every row from the row cache
    client = tsess.ps_client
    assert isinstance(client, ReadOnlyPSClient)
    uniq = len(np.unique(query))
    assert (client.hits, client.misses) == (uniq, uniq)
    assert client.hit_rate == 0.5 == jsess.ps_client.hit_rate
    with pytest.raises(RuntimeError, match="read-only"):
        client.push(123, np.zeros(4, np.float32))
    jsess.close()
    tsess.close()


@pytest.mark.parametrize("rpc", sorted(_BLOCKED))
def test_read_only_client_refuses_every_mutating_rpc(rpc):
    calls = []

    class _Client:
        def __getattr__(self, name):
            return lambda *a, **k: calls.append(name)

    client = ReadOnlyPSClient(_Client())
    with pytest.raises(RuntimeError, match="read-only"):
        getattr(client, rpc)(1, np.zeros(2, np.float32))
    client.wait(1)                     # reads delegate
    assert calls == ["wait"]


def test_session_refuses_a_graph_that_pushes(clients):
    ids, y_, pred, loss, train = _model(
        tht, np.zeros((ROWS, WIDTH), np.float32),
        np.zeros((WIDTH, 2), np.float32))
    cfg = tht.HetuConfig([loss, train], ctx=tht.cpu(0), comm_mode="PS")
    push = train.inputs[0]          # spliced in by the PS graph pass
    assert cfg.ps_nodes and push in cfg.ps_nodes
    with pytest.raises(ValueError, match="PS push"):
        InferenceSession([push], device="cpu")


def test_lru_row_cache_accounting():
    """Hits and misses count unique ids per pull; only misses reach the
    server; the least recently used row leaves first."""
    pulled = []

    class _Server:
        def sparse_pull(self, tid, ids, width):
            pulled.append(np.asarray(ids).tolist())
            return np.repeat(np.asarray(ids, np.float32)[:, None], width, 1)

    client = ReadOnlyPSClient(_Server(), cache_rows=3)
    rows = client.sparse_pull(7, np.array([[1, 2], [2, 3]]), 2)
    np.testing.assert_array_equal(rows[..., 0], [[1, 2], [2, 3]])
    assert (client.hits, client.misses) == (0, 3)
    client.sparse_pull(7, np.array([1, 4]), 2)      # 1 hits; 4 evicts 2
    assert (client.hits, client.misses) == (1, 4)
    client.sparse_pull(7, np.array([2, 3]), 2)      # 2 refetched
    assert (client.hits, client.misses) == (2, 5)
    assert pulled == [[1, 2, 3], [4], [2]]
    assert client.hit_rate == 2 / 7
    client.invalidate()
    client.sparse_pull(7, np.array([3]), 2)
    assert pulled[-1] == [3]
    uncached = ReadOnlyPSClient(_Server())
    uncached.sparse_pull(7, np.array([5, 5]), 2)
    assert (uncached.hits, uncached.misses) == (0, 2)
