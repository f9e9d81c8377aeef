"""The port's launcher (``python -m hetu_tpu_torch.launcher``) against
the JAX package's (``tests/test_launcher.py``): the cluster config, PS
fleets of servers and workers on localhost, the parity of one BSP
fleet's losses across the two packages, the refused options, the
torch.distributed rendezvous, and the executor's side of a fleet (the
role functions, its rank, the options it accepts, worker placement)."""
import os
import sys

import numpy as np
import pytest
import torch

import hetu_tpu_torch as tht
from hetu_tpu_torch import launcher
from hetu_tpu_torch.launcher import ClusterConfig, parse_config
from torch_ps_util import clean_fleet_env, run_fleet

CONFIG = """
nodes:
  - host: localhost
    servers: 2
    workers: 2
    chief: true
"""

# the JAX package's launcher test's worker, for either package: a CTR
# graph whose table and dense weight live on the servers
CTR_WORKER = """
import os
import importlib
import numpy as np
ht = importlib.import_module(os.environ["HT_PACKAGE"])

rank = int(os.environ["HETU_PS_RANK"])
rng = np.random.RandomState(0)
emb_val = rng.randn(50, 8).astype("f") * 0.1
w_val = rng.randn(8 * 4 + 5, 1).astype("f") * 0.1
dense = ht.Variable("dense", trainable=False)
sparse = ht.Variable("sparse", trainable=False)
y_ = ht.Variable("y_", trainable=False)
emb = ht.Variable("ctr_embedding", value=emb_val)
w = ht.Variable("ctr_w", value=w_val, trainable=TRAIN_DENSE)
look = ht.embedding_lookup_op(emb, sparse)
flat = ht.array_reshape_op(look, (-1, 8 * 4))
feats = ht.concat_op(flat, dense, axis=1)
y = ht.sigmoid_op(ht.matmul_op(feats, w))
loss = ht.reduce_mean_op(ht.binarycrossentropy_op(y, y_), [0])
train_op = ht.optim.SGDOptimizer(learning_rate=0.3).minimize(loss)
exe = ht.Executor([loss, train_op], ctx=ht.cpu(0), comm_mode="PS",
                  OPTIONS)
frng = np.random.RandomState(1 + rank)
losses = []
for _ in range(STEPS):
    d = frng.randn(16, 5).astype("f")
    s = IDS
    # planted signal: label = sign of the first dense feature
    yv = (d[:, :1] > 0).astype("f")
    losses.append(exe.run(feed_dict={dense: d, sparse: s, y_: yv}
                          )[0].asnumpy().item())
exe.close()
out = os.path.join(os.environ["HETU_TEST_OUT"],
                   f"{os.environ['HT_PACKAGE']}_{rank}.txt")
with open(out, "w") as f:
    f.write(" ".join(repr(x) for x in losses))
"""


def _worker(options="", steps=20, train_dense=True,
            ids="frng.randint(0, 50, (16, 4))"):
    return (CTR_WORKER.replace("OPTIONS", options)
            .replace("STEPS", str(steps))
            .replace("TRAIN_DENSE", str(train_dense))
            .replace("IDS", ids))


def _losses(tmp_path, package, rank):
    path = tmp_path / f"{package}_{rank}.txt"
    assert path.exists(), f"{package} worker {rank} wrote no losses"
    return np.array([float(x) for x in path.read_text().split()])


@pytest.mark.parametrize("yaml_module", ["present", "hidden"])
def test_parse_config(tmp_path, monkeypatch, yaml_module):
    """The config parser, through PyYAML and through the fallback parser
    that runs where PyYAML is missing (the chip machine)."""
    if yaml_module == "hidden":
        monkeypatch.setitem(sys.modules, "yaml", None)
    cfg_path = tmp_path / "cluster.yml"
    cfg_path.write_text("spmd: true\n" + CONFIG)
    cfg = parse_config(str(cfg_path))
    assert cfg.chief == "localhost" and cfg.spmd
    assert cfg.num_servers == 2 and cfg.num_workers == 2
    assert cfg.single_host
    try:
        eps = cfg.server_endpoints()
        assert len(eps) == 2 and eps[0][1] != eps[1][1]
        assert set(launcher._claims) == {p for _, p in eps}
    finally:
        launcher._shutdown()
    assert not launcher._claims


def test_parse_config_rejects_two_chiefs():
    with pytest.raises(AssertionError):
        ClusterConfig([{"host": "a", "chief": True},
                       {"host": "b", "chief": True}])


def test_multi_host_endpoints_and_worker_env():
    """Several hosts: deterministic server ports from the base, the
    chief's workers first, and the rendezvous of one job in each
    worker's environment."""
    cfg = ClusterConfig([{"host": "w1", "workers": 2},
                         {"host": "w0", "servers": 2, "workers": 1,
                          "chief": True}])
    assert not cfg.single_host
    assert cfg.server_endpoints(base_port=20000) == [("w0", 20000),
                                                     ("w0", 20001)]
    assert cfg.worker_hosts() == [("w0", 1), ("w1", 2)]
    env = launcher._worker_env(cfg, {"X": "1"}, 2, master=("w0", 29400),
                               local_rank=1)
    assert env == {"X": "1", "HETU_PS_RANK": "2",
                   "HETU_COORDINATOR": "w0:29400", "HETU_NUM_PROCS": "3",
                   "HETU_PROC_ID": "2", "MASTER_ADDR": "w0",
                   "MASTER_PORT": "29400", "RANK": "2", "WORLD_SIZE": "3",
                   "LOCAL_RANK": "1"}
    assert launcher._worker_env(cfg, {}, 0) == {"HETU_PS_RANK": "0"}


def test_ps_fleet_end_to_end(tmp_path):
    """2 servers + 2 workers on localhost, PS-mode CTR training (ASP),
    losses written per worker; both fall."""
    proc = run_fleet("hetu_tpu_torch", CONFIG, _worker(), tmp_path,
                     HT_PACKAGE="hetu_tpu_torch")
    assert proc.returncode == 0, proc.stdout
    for rank in range(2):
        losses = _losses(tmp_path, "hetu_tpu_torch", rank)
        assert len(losses) == 20 and np.all(np.isfinite(losses))
        # ASP with 2 workers is noisy: compare half-means
        assert np.mean(losses[10:]) < np.mean(losses[:10]), (rank, losses)


# what an earlier fleet or the caller's shell may leave behind: a
# rendezvous with no one on it, another fleet's servers and backups
LEAKED = {"HETU_COORDINATOR": "127.0.0.1:1", "HETU_NUM_PROCS": "3",
          "HETU_PROC_ID": "2", "MASTER_ADDR": "127.0.0.1",
          "MASTER_PORT": "1", "RANK": "2", "WORLD_SIZE": "3",
          "LOCAL_RANK": "2", "HETU_PS_HOSTS": "127.0.0.1",
          "HETU_PS_PORTS": "1", "HETU_PS_NWORKERS": "5",
          "HETU_PS_BACKUP_HOSTS": "127.0.0.1", "HETU_PS_BACKUP_PORTS": "1",
          "HETU_PS_MY_BACKUP_HOST": "127.0.0.1",
          "HETU_PS_MY_BACKUP_PORT": "1"}


def test_single_host_fleet_ignores_a_leaked_fleet_environment(tmp_path):
    """A single-host fleet started inside another fleet's environment:
    its servers and workers inherit none of it (a worker's executor
    would join the leaked rendezvous and hang, a server would replicate
    to a backup that is not there), and both workers train."""
    reset = {"HETU_PS_HOSTS", "HETU_PS_PORTS", "HETU_PS_NWORKERS"}
    check = (f"import os\nfor k in {sorted(set(LEAKED) - reset)!r}:\n"
             "    assert k not in os.environ, k\n"
             "assert os.environ['HETU_PS_PORTS'] != '1'\n"
             "assert os.environ['HETU_PS_NWORKERS'] == '2'\n")
    proc = run_fleet("hetu_tpu_torch", CONFIG, check + _worker(steps=3),
                     tmp_path, HT_PACKAGE="hetu_tpu_torch", **LEAKED)
    assert proc.returncode == 0, proc.stdout
    for rank in range(2):
        assert np.all(np.isfinite(_losses(tmp_path, "hetu_tpu_torch", rank)))


def test_device_cache_fleet_two_workers(tmp_path):
    """2 servers + 2 workers through the device cache (bounded
    staleness 3): drains and refreshes against a live multi-worker
    fleet; both workers' losses fall."""
    proc = run_fleet("hetu_tpu_torch", CONFIG,
                     _worker('cstable_policy="Device", cache_bound=3', 25),
                     tmp_path, HT_PACKAGE="hetu_tpu_torch")
    assert proc.returncode == 0, proc.stdout
    for rank in range(2):
        losses = _losses(tmp_path, "hetu_tpu_torch", rank)
        assert np.all(np.isfinite(losses))
        assert losses[-1] < losses[0], (rank, losses[0], losses[-1])


def test_bsp_fleet_matches_the_jax_packages_fleet(tmp_path):
    """One BSP host-path script, 2 servers + 2 workers, run by
    ``hetu_tpu.launcher`` and by the port's: each rank's losses agree
    within 1e-5 relative. The JAX package pulls a dense value back in
    its push's round trip, before the barrier, so its dense weights
    race the other worker's pushes (ROADMAP §3); here the dense weight
    is fixed and the workers read disjoint rows (even and odd ids, so
    both servers serve both), which leaves its fleet no race to lose.
    The port's own BSP fleet, dense weights and shared rows included,
    is held to the JAX package in test_torch_ps_multiworker.py."""
    script = _worker("bsp=True", 20, train_dense=False,
                     ids="2 * frng.randint(0, 25, (16, 4)) + rank")
    for package in ("hetu_tpu", "hetu_tpu_torch"):
        proc = run_fleet(package, CONFIG, script, tmp_path,
                         HT_PACKAGE=package)
        assert proc.returncode == 0, proc.stdout
    for rank in range(2):
        want = _losses(tmp_path, "hetu_tpu", rank)
        got = _losses(tmp_path, "hetu_tpu_torch", rank)
        assert len(got) == 20 and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("flag", ["--telemetry=d", "--health=1", "--watch",
                                  "--hang-timeout=30", "--preflight"])
def test_options_of_modes_still_to_port_are_refused(tmp_path, capsys, flag):
    cfg_path = tmp_path / "cluster.yml"
    cfg_path.write_text(CONFIG)
    rc = launcher.main(["-c", str(cfg_path), flag, sys.executable, "-c",
                        "raise SystemExit(0)"])
    assert rc != 0
    name = flag.split("=")[0]
    item = launcher.REFUSED[name[2:].replace("-", "_")][1]
    err = capsys.readouterr().err
    assert name in err and f"ROADMAP {item}" in err
    assert not launcher._procs and not launcher._claims


SPMD_CONFIG = """
spmd: true
nodes:
  - host: localhost
    workers: 2
    chief: true
"""

SPMD_WORKER = """
import os
import torch
import torch.distributed as dist
import hetu_tpu_torch as ht
from hetu_tpu_torch.executor import maybe_init_distributed

assert maybe_init_distributed("cpu")
assert not maybe_init_distributed("cpu")       # joined once
rank = dist.get_rank()
assert rank == int(os.environ["RANK"]) == int(os.environ["HETU_PS_RANK"])
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
t = torch.tensor([float(rank + 1)])
dist.all_reduce(t)
# an executor of the job reads its rank from the launcher
x = ht.Variable("x", trainable=False)
cfg = ht.HetuConfig([ht.reduce_sum_op(x, [0])], ctx=ht.cpu(0))
with open(os.path.join(os.environ["HETU_TEST_OUT"], f"spmd_{rank}.txt"),
          "w") as f:
    f.write(f"{t.item()} {cfg.rank} {os.environ['LOCAL_RANK']}")
dist.destroy_process_group()
"""


def test_spmd_fleet_joins_torch_distributed(tmp_path):
    """``spmd: true``: the two workers are one job; each joins the
    launcher's rendezvous (gloo on the CPU) and all-reduces rank + 1 to
    3."""
    proc = run_fleet("hetu_tpu_torch", SPMD_CONFIG, SPMD_WORKER, tmp_path)
    assert proc.returncode == 0, proc.stdout
    for rank in range(2):
        total, cfg_rank, local = (tmp_path / f"spmd_{rank}.txt"
                                  ).read_text().split()
        assert float(total) == 3.0
        assert int(cfg_rank) == rank and int(local) == rank


FAILING_WORKER = """
import os, sys, time
if os.environ["HETU_PS_RANK"] == "1":
    sys.exit(3)
time.sleep(600)         # as a worker left waiting at a barrier would
"""


def test_a_failed_worker_stops_the_fleet(tmp_path):
    """A worker that exits non-zero ends the run with its code; the
    worker left waiting and the servers are stopped."""
    proc = run_fleet("hetu_tpu_torch", CONFIG, FAILING_WORKER, tmp_path,
                     timeout=60)
    assert proc.returncode == 3, proc.stdout


def _touch(args):
    with open(os.path.join(args.out, os.environ["HETU_PS_RANK"]), "w") as f:
        f.write(os.environ["HETU_PS_PORTS"] + " "
                + os.environ["HETU_PS_NWORKERS"])


def test_launch_runs_target_in_worker_processes(tmp_path, monkeypatch):
    """``launch(target, args)``: the target runs once per worker, with
    the fleet's servers up and named in its environment."""
    import argparse
    cfg_path = tmp_path / "cluster.yml"
    cfg_path.write_text(CONFIG)
    for k, v in clean_fleet_env().items():
        monkeypatch.setenv(k, v)
    launcher.launch(_touch, argparse.Namespace(config=str(cfg_path),
                                               out=str(tmp_path)))
    got = [(tmp_path / str(r)).read_text().split() for r in range(2)]
    assert got[0] == got[1] and got[0][1] == "2"
    assert len(got[0][0].split(",")) == 2
    assert not launcher._procs


# --- the executor's side of a fleet ------------------------------------

def _graph():
    x = tht.Variable("x", trainable=False)
    w = tht.Variable("w", value=np.ones((3, 2), np.float32))
    loss = tht.reduce_mean_op(tht.matmul_op(x, w), [0, 1])
    return x, loss, tht.optim.SGDOptimizer(0.1).minimize(loss)


def test_role_functions_and_placement_names_are_exported():
    for name in ("rcpu", "rgpu", "rtpu", "is_gpu_ctx", "is_tpu_ctx",
                 "worker_init", "worker_finish", "server_init",
                 "server_finish", "scheduler_init", "scheduler_finish",
                 "get_worker_communicate", "launcher"):
        assert hasattr(tht, name), name
    assert tht.launcher is launcher
    tht.scheduler_init()            # no scheduler: direct addressing
    tht.scheduler_finish()


def test_role_functions_run_a_server_and_a_worker(monkeypatch):
    """``server_init`` starts a server on ``HETU_PS_PORTS``,
    ``worker_init`` connects this process's default client to it, and
    the finish functions undo both."""
    from hetu_tpu_torch.ps import client as ps_client
    from hetu_tpu_torch.ps import server as ps_server
    port = ps_server.pick_free_port()
    monkeypatch.setenv("HETU_PS_PORTS", str(port))
    monkeypatch.setenv("HETU_PS_HOSTS", "127.0.0.1")
    monkeypatch.setenv("HETU_PS_NWORKERS", "1")
    monkeypatch.setenv("HETU_PS_RANK", "0")
    prev = ps_client._default_client
    ps_client._default_client = None
    try:
        tht.server_init()
        tht.worker_init()
        comm = tht.get_worker_communicate()
        assert comm is ps_client._default_client and comm.nservers == 1
        comm.init_tensor(7, (3,), opt="None")
        comm.set_param(7, np.arange(3, dtype=np.float32))
        np.testing.assert_allclose(comm.pull(7, (3,)), [0, 1, 2])
        comm.shutdown_servers()
        tht.worker_finish()
        assert ps_client._default_client is None
    finally:
        tht.server_finish()
        ps_client._default_client = prev


@pytest.mark.parametrize("env,rank", [({}, 0), ({"HETU_PS_RANK": "3"}, 3),
                                      ({"HETU_PS_RANK": "3",
                                        "HETU_PROC_ID": "1"}, 1)])
def test_executor_rank_comes_from_the_launcher(monkeypatch, env, rank):
    for k in ("HETU_PS_RANK", "HETU_PROC_ID", "HETU_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, loss, _ = _graph()
    assert tht.HetuConfig([loss], ctx=tht.cpu(0)).rank == rank


def test_reference_options_are_accepted(tmp_path):
    """``dynamic_memory``, ``enable_lazy``, ``use_sparse_pull``,
    ``train_name`` and ``val_name`` are accepted and change nothing;
    ``overlap_options`` reaches ``config.overlap`` (``bucket_bytes``
    too), ``mesh`` is accepted; the options of modes still to port stay
    refused, naming ROADMAP."""
    x, loss, train = _graph()
    feed = {x: np.ones((4, 3), np.float32)}
    plain = tht.Executor([loss, train], ctx=tht.cpu(0))
    want = [plain.run(feed_dict=feed)[0].asnumpy() for _ in range(3)]
    x, loss, train = _graph()
    feed = {x: np.ones((4, 3), np.float32)}
    exe = tht.Executor([loss, train], ctx=tht.cpu(0), dynamic_memory=True,
                       enable_lazy=True, use_sparse_pull=False,
                       train_name="t", val_name="v",
                       overlap_options={"ingest": False, "lookahead": 3})
    got = [exe.run(feed_dict=feed)[0].asnumpy() for _ in range(3)]
    np.testing.assert_array_equal(got, want)
    cfg = exe.config
    assert (cfg.train_name, cfg.val_name) == ("t", "v")
    assert cfg.dynamic_memory and cfg.enable_lazy
    assert not cfg.use_sparse_pull
    assert not cfg.overlap.ingest and cfg.overlap.lookahead == 3
    # the engine off: run_batches_stream runs its blocks synchronously
    out = exe.run_batches_stream([[feed] * 2, [feed]])
    assert len(out) == 1
    # bucket_bytes buckets the data-parallel allreduce
    # (tests/test_torch_dp.py); mesh=None is the job's process group
    cfg = tht.HetuConfig([loss], ctx=tht.cpu(0), mesh=None,
                         overlap_options={"bucket_bytes": 1 << 20})
    assert cfg.overlap.bucket_bytes == 1 << 20 and cfg.mesh is None
    for option in ({"pipeline_mode": "collective"},
                   {"telemetry": None},
                   {"health_options": None}, {"validate": "warn"},
                   {"log_path": str(tmp_path)}):
        with pytest.raises(TypeError, match="ROADMAP"):
            tht.HetuConfig([loss], ctx=tht.cpu(0), **option)
    # the pipelines are ported: gpipe is accepted (tests/test_torch_pipeline.py)
    assert tht.HetuConfig([loss], ctx=tht.cpu(0), gpipe=True).use_gpipe


def test_contexts_place_workers_as_the_reference_does(monkeypatch):
    """``rcpu(host, i)`` is a host CPU (a server in a device group, the
    CPU as a session's device); ``rgpu(host, i)`` a worker's card: a
    fleet's processes each run on their own host's cards, so the id
    wraps around the cards there are (on a one-card host every worker
    uses ``cuda:0``). ``local`` / ``relocalize`` as the reference's."""
    ctx = tht.rcpu("worker0", 0)
    assert not ctx.local and repr(ctx) == "worker0:cpu:0"
    assert ctx.torch_device() == torch.device("cpu")
    group = tht.DeviceGroup([tht.rcpu("worker0", 0), tht.rgpu("worker0", 1)])
    assert group.server_num == 1 and group.worker_num == 1
    ctx.relocalize()
    assert ctx.local and ctx.hostname == "localhost" and repr(ctx) == "cpu:0"
    assert tht.tpu(2) == tht.gpu(2) and tht.is_tpu_ctx(tht.rtpu("h", 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [tht.rgpu("localhost", r).torch_device() for r in range(4)] \
        == [torch.device("cuda", 0)] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tht.rgpu("worker1", 5).torch_device() == torch.device("cuda", 1)
    x, loss, _ = _graph()
    with tht.context(tht.rcpu("worker0", 0)):
        cfg = tht.HetuConfig([tht.reduce_sum_op(x, [0])])
    assert cfg.device == torch.device("cpu")
