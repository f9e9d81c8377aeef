"""One wire protocol, several servers.

The port's server library is built from the same sources as
hetu_tpu's, so each package's client must work against the other's
server: hetu_tpu's client drives the port's server and the port's
client drives hetu_tpu's, through dense, sparse, server-optimizer and
bounded-staleness requests, with exact values. Then the multi-server
placement (a ``HETU_PS_PORTS`` list): the port trains on two servers
what hetu_tpu trains on one, on the host path under BSP, losses within
1e-5 relative and the table within 1e-5 of its largest element. Each
test starts and stops its own servers.
"""
import numpy as np
import torch

import hetu_tpu as jht
import hetu_tpu.ps.client as jclient
import hetu_tpu.ps.server as jserver
import hetu_tpu_torch as tht
import hetu_tpu_torch.ps.client as tclient
import hetu_tpu_torch.ps.server as tserver
from test_torch_ps_training import _close, _data, _train
from torch_ps_util import both_servers, jax_server, torch_server


def _exchange(client):
    """Requests of every kind; returns what came back."""
    out = {}
    client.init_tensor(2001, (6, 3), kind=1, opt="SGD", lrs=[0.5])
    client.set_param(2001, np.arange(18, dtype=np.float32).reshape(6, 3))
    client.sparse_push(2001, np.array([1, 4, 1]),
                       np.ones((3, 3), np.float32), 3)
    client.wait(2001)
    out["sparse"] = client.sparse_pull(2001, np.array([1, 4, 0]), 3)
    client.init_tensor(2002, (4,), kind=0, opt="Momentum", lrs=[0.1, 0.9])
    client.set_param(2002, np.ones(4, np.float32))
    for _ in range(2):
        dense = client.dd_pushpull(2002, np.arange(4, dtype=np.float32))
        client.wait(2002)
    out["dense"] = dense.copy()
    client.init_tensor(2003, (5, 2), kind=2, opt="None")
    client.set_param(2003, np.zeros((5, 2), np.float32))
    client.push_embedding(2003, np.array([2]), np.ones((1, 2), np.float32),
                          np.array([3]), 2)
    client.wait(2003)
    versions = np.zeros(2, np.int64)
    rows = np.zeros((2, 2), np.float32)
    out["synced"] = client.sync_embedding(2003, 1, np.array([2, 3]),
                                          versions, rows, 2)
    out["versions"], out["rows"] = versions, rows
    return out


WANT = {"sparse": np.array([[2, 3, 4], [11.5, 12.5, 13.5], [0, 1, 2]],
                           np.float32),
        # momentum: m = -0.1 g, then 0.9 m - 0.1 g
        "dense": np.array([1, 1 - 0.29, 1 - 0.58, 1 - 0.87], np.float32),
        "synced": 1, "versions": np.array([3, 0]),
        "rows": np.array([[1, 1], [0, 0]], np.float32)}


def _check(got):
    np.testing.assert_array_equal(got["sparse"], WANT["sparse"])
    np.testing.assert_allclose(got["dense"], WANT["dense"], rtol=1e-6)
    assert got["synced"] == WANT["synced"]
    np.testing.assert_array_equal(got["versions"], WANT["versions"])
    np.testing.assert_array_equal(got["rows"], WANT["rows"])


def test_hetu_tpu_client_against_the_port_server():
    with torch_server() as (_, ports):
        assert tserver._server_procs
        client = jclient.PSClient(hosts="127.0.0.1", ports=str(ports[0]))
        try:
            _check(_exchange(client))
        finally:
            client.close()


def test_port_client_against_the_hetu_tpu_server():
    with jax_server() as (_, ports):
        assert jserver._server_procs
        client = tclient.PSClient(hosts="127.0.0.1", ports=str(ports[0]))
        try:
            _check(_exchange(client))
        finally:
            client.close()


def test_two_servers_train_as_one():
    """The table and the weight are placed across two port servers
    (tensor id modulo the server count, split tables by row range);
    the numbers are those of hetu_tpu on one server."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with both_servers(nservers=2) as (jc, tc):
            data = _data(seed=80, rows=64)
            kwargs = dict(comm_mode="PS", bsp=True)
            want = _train(jht, jc, data, kwargs)
            got = _train(tht, tc, data, kwargs)
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-5)
            _close(got["table"], want["table"])
    finally:
        torch.set_num_threads(threads)
