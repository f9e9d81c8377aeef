"""The port's parameter-server client against the port's server, as
tests/test_ps.py holds hetu_tpu's (reference strategy: the roles on
localhost, asserting push/pull/init semantics): dense push and pull,
server SGD, sparse ops, ss_pushpull, on-server initialization with save
and load, bounded staleness, the barrier, data blobs, duplicate-row
SGD, kPushSyncEmbedding; and the pieces around them — the library's
hashed build outside the sources, ``ensure_server`` adopting a live
port, ``get_default_client`` and the device cache's bookkeeping. Exact values: the server is the same
C++ code in both packages.
"""
import numpy as np
import pytest
import torch

from hetu_tpu_torch.ps import client as ps_client
from hetu_tpu_torch.ps import native_lib
from hetu_tpu_torch.ps import server as ps_server
from hetu_tpu_torch.ps.device_cache import (DeviceCacheTable, HostStaging,
                                            host_rows, pad_fill,
                                            pad_gather_zero)
from torch_ps_util import torch_server


@pytest.fixture(scope="module")
def ps():
    with torch_server() as (client, _):
        yield client


def test_dense_push_pull(ps):
    ps.init_tensor(1001, (8, 4), kind=0, opt="None")
    val = np.arange(32, dtype=np.float32).reshape(8, 4)
    ps.set_param(1001, val)
    np.testing.assert_array_equal(ps.pull(1001, (8, 4)), val)
    # OptKind None: push accumulates (worker pre-scaled grads)
    ps.push(1001, np.ones((8, 4), np.float32))
    ps.wait(1001)
    np.testing.assert_array_equal(ps.pull(1001, (8, 4)), val + 1)


def test_dense_server_sgd(ps):
    ps.init_tensor(1002, (4,), kind=0, opt="SGD", lrs=[0.5])
    ps.set_param(1002, np.zeros(4, np.float32))
    out = ps.dd_pushpull(1002, np.ones(4, np.float32))
    ps.wait(1002)
    np.testing.assert_array_equal(out, -0.5 * np.ones(4))


def test_sparse_ops(ps):
    ps.init_tensor(1003, (10, 3), kind=1, opt="None")
    ps.set_param(1003, np.zeros((10, 3), np.float32))
    ps.sparse_push(1003, np.array([2, 5, 2]), np.ones((3, 3), np.float32),
                   width=3)
    ps.wait(1003)
    got = ps.sparse_pull(1003, np.array([2, 5, 0]), width=3)
    np.testing.assert_array_equal(got[0], 2 * np.ones(3))   # row 2 twice
    np.testing.assert_array_equal(got[1], np.ones(3))
    np.testing.assert_array_equal(got[2], np.zeros(3))


def test_ss_pushpull_prefetch(ps):
    ps.init_tensor(1004, (6, 2), kind=1, opt="None")
    ps.set_param(1004, np.tile(np.arange(6, dtype=np.float32)[:, None],
                               (1, 2)))
    out = ps.ss_pushpull(1004, np.array([0]),
                         10 * np.ones((1, 2), np.float32),
                         np.array([0, 3]), width=2)
    ps.wait(1004)
    np.testing.assert_array_equal(out[0], [10, 10])   # pushed, then pulled
    np.testing.assert_array_equal(out[1], [3, 3])


def test_on_server_init_and_save_load(ps, tmp_path):
    ps.init_tensor(1005, (100, 8), kind=1, init=(2, 0.0, 1.0), seed=7,
                   opt="None")
    rows = ps.sparse_pull(1005, np.arange(100), width=8)
    assert 0.5 < rows.std() < 1.5 and abs(rows.mean()) < 0.3
    path = str(tmp_path / "t1005.bin")
    ps.save_param(1005, path)
    ps.clear(1005)
    assert ps.pull(1005, (100, 8)).std() == 0
    ps.load_param(1005, path)
    np.testing.assert_array_equal(ps.pull(1005, (100, 8)),
                                  rows.reshape(100, 8))


def test_bounded_staleness_sync(ps):
    """Only rows whose server version ran more than the bound ahead of
    the client's are pulled (reference hetu_client.cc:6-38)."""
    ps.init_tensor(1006, (5, 2), kind=2, opt="None")
    ps.set_param(1006, np.zeros((5, 2), np.float32))
    cache = np.zeros((3, 2), np.float32)
    versions = np.zeros(3, np.int64)
    idx = np.array([0, 1, 2])
    assert ps.sync_embedding(1006, 0, idx, versions, cache, 2) == 0
    ps.sparse_push(1006, np.array([0, 1]), np.ones((2, 2), np.float32), 2)
    ps.wait(1006)
    assert ps.sync_embedding(1006, 0, idx, versions, cache, 2) == 2
    np.testing.assert_array_equal(cache[0], [1, 1])
    np.testing.assert_array_equal(versions, [1, 1, 0])
    # bound 1 tolerates one update: nothing to refresh; bound 0 forces it
    ps.sparse_push(1006, np.array([0]), np.ones((1, 2), np.float32), 2)
    ps.wait(1006)
    assert ps.sync_embedding(1006, 1, idx, versions, cache, 2) == 0
    assert ps.sync_embedding(1006, 0, idx, versions, cache, 2) == 1
    np.testing.assert_array_equal(cache[0], [2, 2])


def test_push_sync_embedding_pushes_then_refreshes(ps):
    """kPushSyncEmbedding: one round trip applies the push (versions
    bump by the update counts) and returns the rows past the bound."""
    ps.init_tensor(1007, (4, 2), kind=2, opt="None")
    ps.set_param(1007, np.zeros((4, 2), np.float32))
    versions = np.zeros(2, np.int64)
    out = np.zeros((2, 2), np.float32)
    n = ps.push_sync_embedding(1007, np.array([1]),
                               np.full((1, 2), 3.0, np.float32),
                               np.array([2]), 0, np.array([1, 2]), versions,
                               out, 2)
    assert n == 1
    np.testing.assert_array_equal(out[0], [3, 3])
    np.testing.assert_array_equal(versions, [2, 0])


def test_barrier_single_worker(ps):
    ps.barrier()     # one worker: returns at once


def test_data_blobs(ps):
    ps.push_data(42, np.arange(5, dtype=np.float32))
    np.testing.assert_array_equal(ps.pull_data(42, 5), np.arange(5))


def test_sparse_push_duplicate_rows_sgd(ps):
    """Duplicate row ids in one push aggregate exactly."""
    ps.init_tensor(1010, (16, 4), kind=1, opt="SGD", lrs=[1.0])
    ps.set_param(1010, np.zeros((16, 4), np.float32))
    idx = np.array([3] * 64 + [7] * 32, dtype=np.int64)
    ps.sparse_push(1010, idx, np.ones((96, 4), np.float32), width=4)
    ps.wait(1010)
    got = ps.sparse_pull(1010, np.array([3, 7, 0]), width=4)
    np.testing.assert_array_equal(got[0], -64 * np.ones(4))
    np.testing.assert_array_equal(got[1], -32 * np.ones(4))
    np.testing.assert_array_equal(got[2], np.zeros(4))


def test_library_builds_outside_the_sources_under_a_hash():
    """The .so lives in _build/ under a name hashing the sources; the
    source directory holds none."""
    path = native_lib.lib_path()
    assert path.exists() and path.parent == native_lib.BUILD_DIR
    assert path.name.startswith("libhetu_ps_") and path.suffix == ".so"
    assert not list(native_lib.NATIVE_DIR.glob("*.so"))


def test_ensure_server_adopts_a_listening_port(ps):
    """A second ensure_server on a port that already serves starts
    nothing."""
    live = [p.args for p in ps_server._server_procs]
    # the server entry runs by path: [python, run_server.py, PORT, N]
    assert live and all(a[1] == ps_server.RUN_SERVER for a in live)
    port = int(live[0][2])
    assert ps_server.ensure_server(port=port) is None
    assert len(ps_server._server_procs) == len(live)


def test_default_client_reads_the_environment(ps, monkeypatch):
    """get_default_client builds one client from HETU_PS_* when none is
    set, and returns it again."""
    port = int(ps_server._server_procs[0].args[2])
    saved = ps_client._default_client
    monkeypatch.setenv("HETU_PS_PORTS", str(port))
    monkeypatch.setenv("HETU_PS_HOSTS", "127.0.0.1")
    ps_client._default_client = None
    try:
        client = ps_client.get_default_client()
        assert client is ps_client.get_default_client()
        assert client.nworkers == 1 and client.rank == 0
        client.push_data(43, np.ones(2, np.float32))
        np.testing.assert_array_equal(client.pull_data(43, 2), [1, 1])
        ps_client.set_default_client(None)
    finally:
        ps_client._default_client = saved


def test_device_cache_bookkeeping_and_copies():
    """The device cache's host side (the reference's numpy slot map,
    unchanged) and its device side on the CPU: a fill lands in the rows
    named, a drain gathers the sums before zeroing them."""
    class _Node:
        def __init__(self, i, name):
            self.id, self.name = i, name

    rt = DeviceCacheTable(_Node(1, "t"), _Node(2, "t__dcache"), None,
                          capacity=4, width=2, rows=10)
    slots, miss_ids, miss_slots, uniq = rt.assign(np.array([[3, 5], [3, 7]]),
                                                  inline_drain=None)
    np.testing.assert_array_equal(miss_ids, [3, 5, 7])
    assert slots.dtype == np.int32 and slots[0, 0] == slots[1, 0]
    rt.note_update(uniq)
    rt.release_pins()
    cache = torch.zeros(5, 2)
    pad_fill(cache, miss_slots, np.arange(6, dtype=np.float32).reshape(3, 2),
             HostStaging())
    np.testing.assert_array_equal(cache[torch.as_tensor(miss_slots)].numpy(),
                                  np.arange(6).reshape(3, 2))
    acc = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    acc, staged, n = pad_gather_zero(acc, np.array([1, 3]), HostStaging(),
                                     compress=True)
    assert n == 2
    np.testing.assert_array_equal(host_rows(staged), [[2, 3], [6, 7]])
    np.testing.assert_array_equal(acc[[1, 3]].numpy(), np.zeros((2, 2)))
    claimed, ids, upds = rt.take_dirty()
    np.testing.assert_array_equal(np.sort(ids), [3, 5, 7])
    np.testing.assert_array_equal(upds, [1, 1, 1])
    assert rt.perf["misses"] == 3 and rt.perf["hits"] == 0
