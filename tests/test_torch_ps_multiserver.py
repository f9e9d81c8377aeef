"""Key-range partitioning on the port's client (mirrors
``tests/test_ps_multiserver.py``): one tensor's rows spread across two
server processes of the port, split and reassembled by the client
library's row-wise shards (``ps/native/ps_client.cc``, ``route_sparse``)
for every request kind, stored apart and re-split on load."""
import os

import numpy as np
import pytest

from hetu_tpu_torch.ps import client as ps_client
from hetu_tpu_torch.ps import server as ps_server
from torch_ps_util import start_server

ROWS, WIDTH = 10, 4


@pytest.fixture(scope="module")
def ps2():
    """Two servers of the port and the port's client over both, their
    addresses given explicitly (nothing is left in os.environ)."""
    try:
        ports = [start_server()[0] for _ in range(2)]
        client = ps_client.PSClient(hosts="127.0.0.1,127.0.0.1",
                                    ports=",".join(map(str, ports)),
                                    rank=0, nworkers=1)
        assert client.nservers == 2
        yield client
        client.shutdown_servers()
        client.close()
    finally:
        ps_server.shutdown_server()


def test_dense_spans_servers(ps2):
    ps2.init_tensor(2001, (ROWS, WIDTH), kind=0, opt="None")
    val = np.arange(ROWS * WIDTH, dtype=np.float32).reshape(ROWS, WIDTH)
    ps2.set_param(2001, val)
    np.testing.assert_allclose(ps2.pull(2001, (ROWS, WIDTH)), val)
    ps2.push(2001, np.ones((ROWS, WIDTH), np.float32))
    ps2.wait(2001)
    np.testing.assert_allclose(ps2.pull(2001, (ROWS, WIDTH)), val + 1)


def test_dense_server_sgd_partitioned(ps2):
    ps2.init_tensor(2002, (8,), kind=0, opt="SGD", lrs=[0.5])
    ps2.set_param(2002, np.zeros(8, np.float32))
    out = ps2.dd_pushpull(2002, np.arange(8, dtype=np.float32))
    ps2.wait(2002)
    np.testing.assert_allclose(out, -0.5 * np.arange(8))


@pytest.mark.parametrize("kind,tid", [(1, 2003), (2, 2013)])
def test_sparse_rows_cross_boundary(ps2, kind, tid):
    """Rows 0-4 live on server 0, rows 5-9 on server 1; one request that
    touches both must be split and reassembled in caller order — for a
    plain sparse table (kind 1) and a versioned one (kind 2, the device
    cache's)."""
    ps2.init_tensor(tid, (ROWS, WIDTH), kind=kind, opt="None")
    base = np.tile(np.arange(ROWS, dtype=np.float32)[:, None], (1, WIDTH))
    ps2.set_param(tid, base)
    idx = np.array([7, 2, 9, 0, 5, 4])          # interleaved across servers
    got = ps2.sparse_pull(tid, idx, width=WIDTH)
    np.testing.assert_allclose(got, base[idx])

    ps2.sparse_push(tid, idx, np.ones((idx.size, WIDTH), np.float32),
                    width=WIDTH)
    ps2.wait(tid)
    got = ps2.sparse_pull(tid, np.arange(ROWS), width=WIDTH)
    want = base.copy()
    want[idx] += 1
    np.testing.assert_allclose(got, want)


def test_ss_pushpull_partitioned(ps2):
    ps2.init_tensor(2004, (ROWS, 2), kind=1, opt="None")
    base = np.tile(np.arange(ROWS, dtype=np.float32)[:, None], (1, 2))
    ps2.set_param(2004, base)
    out = ps2.ss_pushpull(2004, np.array([1, 8]),
                          10 * np.ones((2, 2), np.float32),
                          np.array([8, 1, 3]), width=2)
    ps2.wait(2004)
    np.testing.assert_allclose(out[0], [18, 18])   # pushed then pulled
    np.testing.assert_allclose(out[1], [11, 11])
    np.testing.assert_allclose(out[2], [3, 3])


def test_cache_protocol_partitioned(ps2):
    ps2.init_tensor(2005, (ROWS, WIDTH), kind=2, opt="None")
    base = np.zeros((ROWS, WIDTH), np.float32)
    ps2.set_param(2005, base)
    idx = np.array([3, 6])                       # one row on each server
    ps2.push_embedding(2005, idx, np.ones((2, WIDTH), np.float32),
                       np.array([1, 1]), width=WIDTH)
    ps2.wait(2005)
    ver = np.full(2, -1, np.int64)               # stale: force refresh
    out = np.zeros((2, WIDTH), np.float32)
    n = ps2.sync_embedding(2005, 0, idx, ver, out, WIDTH)
    assert n == 2
    np.testing.assert_allclose(out, np.ones((2, WIDTH)))
    assert (ver >= 1).all()


def test_shards_really_live_apart(ps2, tmp_path):
    """save_param writes one file per range — proof the table is stored
    split, not mirrored."""
    ps2.init_tensor(2006, (ROWS, WIDTH), kind=1, opt="None")
    ps2.set_param(2006, np.arange(ROWS * WIDTH,
                                  dtype=np.float32).reshape(ROWS, WIDTH))
    path = str(tmp_path / "t2006.bin")
    ps2.save_param(2006, path)
    p0, p1 = path + ".part0", path + ".part1"
    assert os.path.exists(p0) and os.path.exists(p1)
    assert not os.path.exists(path)
    # 10 rows split 5/5: each shard file holds half the payload
    assert os.path.getsize(p0) == os.path.getsize(p1)
    total = os.path.getsize(p0) + os.path.getsize(p1)
    assert total >= ROWS * WIDTH * 4

    # round-trip: clear then load from the per-range files
    ps2.clear(2006)
    np.testing.assert_allclose(
        ps2.sparse_pull(2006, np.arange(ROWS), width=WIDTH), 0)
    ps2.load_param(2006, path)
    np.testing.assert_allclose(
        ps2.sparse_pull(2006, np.arange(ROWS), width=WIDTH),
        np.arange(ROWS * WIDTH, dtype=np.float32).reshape(ROWS, WIDTH))


def test_on_server_init_partitioned(ps2):
    """Random init runs per shard with decorrelated seeds."""
    ps2.init_tensor(2007, (100, 8), kind=1, init=(2, 0.0, 1.0), seed=11,
                    opt="None")
    rows = ps2.sparse_pull(2007, np.arange(100), width=8)
    assert 0.5 < rows.std() < 1.5 and abs(rows.mean()) < 0.3
    # the two halves must not be identical (seed decorrelation)
    assert not np.allclose(rows[:50], rows[50:])
