"""Replicated PS shards on the port (mirrors ``tests/test_ps_failover.py``
:72-272 and its teardown case, and ``tests/test_ps_resize.py``): a
primary armed with its backup through ``HETU_PS_MY_BACKUP_*``, the
client's failover through ``HETU_PS_BACKUP_HOSTS`` / ``_PORTS``
(SIGKILL of the primary mid-run: every update lands exactly once), the
launcher's respawn of a dead server and its replicated fleet
(``HETU_PS_REPLICATE``), an idempotent teardown, and a checkpoint
loaded into a fleet of another size."""
import os
import subprocess
import threading
import time
import types

import numpy as np
import pytest

import hetu_tpu_torch as tht
from hetu_tpu_torch import launcher
from hetu_tpu_torch.ps import client as ps_client
from hetu_tpu_torch.ps import server as ps_server
from torch_ps_util import start_server


def _address(monkeypatch, ports, backups=()):
    monkeypatch.setenv("HETU_PS_HOSTS", ",".join(["127.0.0.1"] * len(ports)))
    monkeypatch.setenv("HETU_PS_PORTS", ",".join(map(str, ports)))
    if backups:
        monkeypatch.setenv("HETU_PS_BACKUP_HOSTS",
                           ",".join(["127.0.0.1"] * len(backups)))
        monkeypatch.setenv("HETU_PS_BACKUP_PORTS",
                           ",".join(map(str, backups)))
    else:
        monkeypatch.delenv("HETU_PS_BACKUP_HOSTS", raising=False)
        monkeypatch.delenv("HETU_PS_BACKUP_PORTS", raising=False)


def _replicated(monkeypatch):
    """A replicated shard: the backup first (the primary dials it at
    startup), then the primary armed with HETU_PS_MY_BACKUP_*. Returns
    (primary, backup) processes."""
    bport, backup = start_server()
    pport, primary = start_server(
        extra_env={"HETU_PS_MY_BACKUP_HOST": "127.0.0.1",
                   "HETU_PS_MY_BACKUP_PORT": str(bport)})
    _address(monkeypatch, [pport], [bport])
    monkeypatch.setenv("HETU_PS_TIMEOUT_MS", "3000")
    monkeypatch.setenv("HETU_PS_RETRY_MS", "20000")
    return primary, backup


def _teardown(client):
    try:
        client.shutdown_servers()
    finally:
        client.close()
        ps_server.shutdown_server()


@pytest.fixture()
def ps_pair(monkeypatch):
    try:
        primary, backup = _replicated(monkeypatch)
        client = ps_client.PSClient(rank=0, nworkers=1)
    except BaseException:
        ps_server.shutdown_server()
        raise
    yield client, primary, backup
    _teardown(client)


def test_client_reports_replicas(ps_pair):
    client, _, _ = ps_pair
    assert client.nservers == 1
    assert client.nreplicas == 2


@pytest.mark.parametrize("settle", [True, False])
def test_sigkill_primary_keeps_every_update_once(ps_pair, settle):
    """Train, SIGKILL the primary, keep training: every update lands
    exactly once (SGD lr=1.0, unit grads: param == -pushes). With a
    settle the replication forwards the acked tail; without one the
    client's acked-window replay must, and its dedup keeps a replayed
    and forwarded update single."""
    client, primary, _ = ps_pair
    tid, before, after = (6100, 5, 3) if settle else (6101, 7, 1)
    client.init_tensor(tid, (8,), opt="SGD", lrs=(1.0,))
    client.set_param(tid, np.zeros(8, np.float32))
    for _ in range(before):
        client.push(tid, np.ones(8, np.float32))
        client.wait(tid)
    np.testing.assert_allclose(client.pull(tid, (8,)), -before * np.ones(8))
    if settle:
        time.sleep(0.5)
    primary.kill()
    primary.wait()
    t0 = time.perf_counter()
    for _ in range(after):
        client.push(tid, np.ones(8, np.float32))
        client.wait(tid)
    recovery = time.perf_counter() - t0
    np.testing.assert_allclose(client.pull(tid, (8,)),
                               -(before + after) * np.ones(8))
    assert recovery < 30, f"failover took {recovery:.1f}s"


def test_sparse_state_survives_failover(ps_pair):
    """Embedding-table state crosses the flip: sparse pushes before the
    kill are visible from the backup."""
    client, primary, _ = ps_pair
    tid = 6102
    client.init_tensor(tid, (32, 4), kind=1, opt="SGD", lrs=(1.0,))
    client.set_param(tid, np.zeros((32, 4), np.float32))
    ids = np.array([1, 5, 9], np.int64)
    client.sparse_push(tid, ids, np.ones((3, 4), np.float32), 4)
    client.wait(tid)
    time.sleep(0.5)
    primary.kill()
    primary.wait()
    got = client.sparse_pull(tid, np.arange(32), 4)
    want = np.zeros((32, 4), np.float32)
    want[ids] = -1.0
    np.testing.assert_allclose(got, want)


def _ctr_graph():
    rng = np.random.RandomState(0)
    emb_val = rng.randn(50, 8).astype("f") * 0.1
    w_val = rng.randn(8 * 4 + 5, 1).astype("f") * 0.1
    dense = tht.Variable("dense", trainable=False)
    sparse = tht.Variable("sparse", trainable=False)
    y_ = tht.Variable("y_", trainable=False)
    emb = tht.Variable("ctr_embedding", value=emb_val)
    w = tht.Variable("ctr_w", value=w_val)
    look = tht.embedding_lookup_op(emb, sparse)
    flat = tht.array_reshape_op(look, (-1, 8 * 4))
    feats = tht.concat_op(flat, dense, axis=1)
    y = tht.sigmoid_op(tht.matmul_op(feats, w))
    loss = tht.reduce_mean_op(tht.binarycrossentropy_op(y, y_), [0])
    train_op = tht.optim.SGDOptimizer(learning_rate=0.5).minimize(loss)
    return dense, sparse, y_, loss, train_op


def test_training_loss_matches_no_kill_twin(monkeypatch):
    """PS-mode training whose primary is SIGKILLed mid-run gives the
    same losses as the unreplicated run without a kill: failover and the
    acked-window replay are exactly-once, so the optimizer never sees
    the kill."""
    frng = np.random.RandomState(1)
    feeds = [(frng.randn(16, 5).astype("f"),
              frng.randint(0, 50, (16, 4)),
              frng.randint(0, 2, (16, 1)).astype("f"))
             for _ in range(14)]

    def run(replicated, kill_at=None):
        primary = None
        if replicated:
            primary, _ = _replicated(monkeypatch)
        else:
            port, _ = start_server()
            _address(monkeypatch, [port])
        client = ps_client.PSClient(rank=0, nworkers=1)
        prev = ps_client._default_client
        ps_client.set_default_client(client)
        try:
            dense, sparse, y_, loss, train_op = _ctr_graph()
            # prefetch=False: synchronous pushes, comparable loss for loss
            exe = tht.Executor([loss, train_op], ctx=tht.cpu(0),
                               comm_mode="PS", prefetch=False)
            losses = []
            for i, (d, s, yv) in enumerate(feeds):
                if i == kill_at:
                    time.sleep(0.3)      # some forwards land, some not
                    primary.kill()
                    primary.wait()
                losses.append(exe.run(
                    feed_dict={dense: d, sparse: s, y_: yv}
                )[0].asnumpy().item())
            exe.close()
            return losses
        finally:
            _teardown(client)
            ps_client._default_client = prev

    base = run(replicated=False)
    got = run(replicated=True, kill_at=7)
    assert all(np.isfinite(base)) and all(np.isfinite(got))
    np.testing.assert_allclose(got, base, rtol=1e-6)


def test_launcher_respawns_dead_server_in_place():
    """The watchdog's respawn (its watchdog comes with ROADMAP item 14):
    a dead local server record is respawned on its endpoint, an alive
    record is left alone, and a remote one is tombstoned instead of
    respawned over ssh."""
    cfg = types.SimpleNamespace(num_workers=1)
    port = ps_server.pick_free_port()
    dead = subprocess.Popen(["true"])
    dead.wait()
    alive = subprocess.Popen(["sleep", "30"])
    remote_dead = subprocess.Popen(["false"])
    remote_dead.wait()
    servers = [
        {"proc": dead, "host": "127.0.0.1", "port": port, "env": {},
         "identify": None},
        {"proc": alive, "host": "127.0.0.1", "port": 1, "env": {},
         "identify": None},
        {"proc": remote_dead, "host": "10.0.0.99", "port": 2, "env": {},
         "identify": None},
    ]
    try:
        launcher._respawn_dead_servers(servers, cfg)
        assert servers[0]["proc"] is not dead          # respawned
        assert servers[1]["proc"] is alive             # untouched
        assert servers[2]["proc"] is not remote_dead   # tombstoned
        # the respawn returns once the standby serves
        assert ps_server._port_open("127.0.0.1", port)
        maps = open(f"/proc/{servers[0]['proc'].pid}/maps").read()
        assert "libtorch" not in maps
        # the tombstone is a finished no-op: the watchdog loop must not
        # fire the remote warning again every poll
        assert servers[2]["proc"].wait(5) is not None
    finally:
        for rec in servers:
            if rec["proc"].poll() is None:
                rec["proc"].kill()
        alive.kill()
        launcher._shutdown()


REPLICATED_WORKER = """
import os
import numpy as np
import hetu_tpu_torch as ht

rank = int(os.environ["HETU_PS_RANK"])
x = ht.Variable("x", trainable=False)
w = ht.Variable("w", value=np.zeros((3, 1), np.float32))
loss = ht.reduce_mean_op(ht.matmul_op(x, w), [0, 1])
train = ht.optim.SGDOptimizer(1.0).minimize(loss)
exe = ht.Executor([loss, train], ctx=ht.cpu(0), comm_mode="PS", bsp=True)
client = exe.config.ps_comm
for _ in range(4):
    exe.run(feed_dict={x: np.ones((2, 3), np.float32)})
exe.close()
with open(os.path.join(os.environ["HETU_TEST_OUT"], f"rep_{rank}"),
          "w") as f:
    f.write(f"{client.nservers} {client.nreplicas} "
            f"{os.environ['HETU_PS_BACKUP_PORTS']} "
            f"{exe.params[str(w.id)].numpy().ravel()[0]}")
"""


def test_replicated_fleet_from_the_launcher(tmp_path):
    """``HETU_PS_REPLICATE=1``: the launcher starts a backup for each
    primary, arms the primary with it, and names the backups to the
    workers; the fleet trains on the replicated shards (BSP, 2 workers,
    4 steps of gradient 1 / 2 each from each worker: w = -4)."""
    from torch_ps_util import run_fleet
    config = ("nodes:\n  - host: localhost\n    servers: 2\n"
              "    workers: 2\n    chief: true\n")
    proc = run_fleet("hetu_tpu_torch", config, REPLICATED_WORKER, tmp_path,
                     HETU_PS_REPLICATE="1")
    assert proc.returncode == 0, proc.stdout
    for rank in range(2):
        nservers, nreplicas, backups, w0 = (
            tmp_path / f"rep_{rank}").read_text().split()
        assert (int(nservers), int(nreplicas)) == (2, 2)
        assert len(backups.split(",")) == 2
        assert float(w0) == pytest.approx(-4.0)


def test_teardown_idempotent_and_thread_clean(monkeypatch):
    """shutdown_servers()/close() twice is a no-op, and no Python-side
    threads outlive the client."""
    before = set(threading.enumerate())
    port, _ = start_server()
    _address(monkeypatch, [port])
    client = ps_client.PSClient(rank=0, nworkers=1)
    client.init_tensor(6400, (4,), opt="None")
    client.set_param(6400, np.ones(4, np.float32))
    client.shutdown_servers()
    client.shutdown_servers()        # a second call is a no-op
    client.close()
    client.close()
    ps_server.shutdown_server()
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
    assert not leaked, leaked


# --- a checkpoint loaded into a fleet of another size ------------------

ROWS, WIDTH = 10, 4
TID = 4700


def _fleet(monkeypatch, nservers):
    ports = [start_server()[0] for _ in range(nservers)]
    _address(monkeypatch, ports)
    client = ps_client.PSClient(rank=0, nworkers=1)
    assert client.nservers == nservers
    return client


@pytest.mark.parametrize("saved,loaded", [(2, 1), (2, 3), (1, 2)])
def test_checkpoint_loads_into_a_fleet_of_another_size(tmp_path, monkeypatch,
                                                       saved, loaded):
    """A row-partitioned tensor saved by one server count loads under
    another: the client reassembles the saved shards from the manifest
    and re-splits them over the new ranges; a single server's
    checkpoint (no manifest) is one full dump, re-split."""
    val = np.linspace(0, 1, ROWS * WIDTH, dtype=np.float32).reshape(
        ROWS, WIDTH)
    path = str(tmp_path / "emb.bin")
    client = _fleet(monkeypatch, saved)
    try:
        client.init_tensor(TID, (ROWS, WIDTH), kind=0, opt="None")
        client.set_param(TID, val)
        assert client.save_param(TID, path) == 0
    finally:
        _teardown(client)
    assert os.path.exists(path + ".part0") == (saved > 1)
    client = _fleet(monkeypatch, loaded)
    try:
        client.init_tensor(TID, (ROWS, WIDTH), kind=0, opt="None")
        assert client.load_param(TID, path) == 0
        np.testing.assert_allclose(client.pull(TID, (ROWS, WIDTH)), val)
    finally:
        _teardown(client)
