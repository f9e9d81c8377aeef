"""The port's launcher: a yaml cluster config -> a fleet of PS servers
and worker processes.

    python -m hetu_tpu_torch.launcher -c cluster.yml <command> [args...]

Counterpart of ``hetu_tpu/launcher.py`` (reference parity: ``bin/heturun``
-> ``python/runner.py:148-270`` and ``python/hetu/launcher.py:18-58``):
the yaml ``nodes:`` config, the chief, servers forked locally or
started over ssh, backup replicas, the dead-server respawn, and the
in-process ``launch(target, args)``.

* **No scheduler process.** The PS transport is direct-addressed: the
  launcher fixes every server's host:port up front and hands workers
  the list (``HETU_PS_HOSTS`` / ``HETU_PS_PORTS``, ``HETU_PS_NWORKERS``,
  each worker's ``HETU_PS_RANK``). On one host each port is claimed by a
  listening socket from the moment it is chosen until its server runs
  on that socket, so two fleets started at once cannot pick one port.
* **Servers import no torch.** A server is
  ``hetu_tpu_torch/ps/run_server.py`` run by path (:mod:`.ps.server`),
  which loads the server library and nothing of the package's
  ``__init__``.
* **The rendezvous is torch.distributed's.** A fleet across hosts, or
  one host's with ``spmd: true``, is one job: each worker gets
  ``MASTER_ADDR`` / ``MASTER_PORT`` (the chief, which runs rank 0),
  ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, beside the reference's
  ``HETU_COORDINATOR`` / ``HETU_NUM_PROCS`` / ``HETU_PROC_ID``; the
  executor joins it (``executor.maybe_init_distributed``: NCCL where
  every rank has a card of its own, else gloo), and a rank's default
  device is its ``LOCAL_RANK``'s card. Its data-parallel sessions run
  over that group.
* **Pipeline stages across workers** reach each other over the host
  channel (``parallel/p2p.py``): such a job's workers also get
  ``HETU_PIPE_HOSTS`` (each rank's host, loopback on one host),
  ``HETU_PIPE_BASE_PORT`` (rank k listens on base + k; the caller's
  value, else on one host a range free at launch, so jobs that share a
  host keep apart, and 19500 across hosts) and ``HETU_HOSTS`` (each
  rank's hostname, which maps a stage's hostname to its owner), as the
  reference's launcher exports them.
* **A fleet's environment is its own.** What the launcher sets on its
  servers and workers (:data:`FLEET_VARS`) is taken out of the
  environment they inherit first, so a value left by an earlier fleet
  or the caller's shell (an old rendezvous, another fleet's backups)
  never reaches this one.
* **Local workers share the host's cores**: each gets
  ``OMP_NUM_THREADS`` = cores / local workers unless the variable is
  set.
* **A worker that fails stops the fleet**: the others would wait for it
  at a BSP barrier for ever. The launcher exits with the first non-zero
  exit code.

``--autoplan`` previews the cost-model planner's choice
(:func:`run_autoplan`): the command runs once, in a plain process, with
``HETU_AUTOPLAN_REPORT`` set; its first ``Executor`` prints the plan
table, writes the JSON report and exits before any fleet starts.

The options of modes still to port are refused, each naming its
ROADMAP item: ``--telemetry``, ``--health``, ``--watch`` and
``--hang-timeout`` (item 14, which also brings the watchdog that calls
:func:`_respawn_dead_servers`) and ``--preflight`` (item 17).

Config (the reference's shape):

.. code-block:: yaml

    nodes:
      - host: localhost
        servers: 1
        workers: 2
        chief: true
"""
from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import time

__all__ = ["ClusterConfig", "parse_config", "launch", "launch_command",
           "run_autoplan", "main"]

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_SERVER = os.path.join("hetu_tpu_torch", "ps", "run_server.py")

# the options of modes the port does not have yet -> their ROADMAP item
REFUSED = {"telemetry": ("--telemetry", "item 14"),
           "health": ("--health", "item 14"),
           "watch": ("--watch", "item 14"),
           "hang_timeout": ("--hang-timeout", "item 14"),
           "preflight": ("--preflight", "item 17")}

# what the launcher sets on a fleet's servers and workers, or sets for
# one fleet only: never inherited from the caller
FLEET_VARS = ("HETU_PS_HOSTS", "HETU_PS_PORTS", "HETU_PS_NWORKERS",
              "HETU_PS_RANK", "HETU_PS_BACKUP_HOSTS", "HETU_PS_BACKUP_PORTS",
              "HETU_PS_MY_BACKUP_HOST", "HETU_PS_MY_BACKUP_PORT",
              "HETU_PS_REPLICATE", "HETU_COORDINATOR", "HETU_NUM_PROCS",
              "HETU_PROC_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK", "HETU_PIPE_HOSTS",
              "HETU_PIPE_BASE_PORT", "HETU_HOSTS")

_procs = []
_claims = {}        # port -> the listening socket that claims it


def _load_yaml(path):
    try:
        import yaml
        with open(path) as f:
            return yaml.safe_load(f)
    except ImportError:
        # minimal fallback parser for the flat nodes schema above
        # (yaml is an optional dependency; configs are tiny)
        nodes, cur = [], None
        top = {}
        with open(path) as f:
            for raw in f:
                line = raw.split("#", 1)[0].rstrip()
                if not line.strip() or line.strip() == "nodes:":
                    continue
                stripped = line.strip()
                if stripped.startswith("- "):
                    cur = {}
                    nodes.append(cur)
                    stripped = stripped[2:]
                if ":" in stripped:
                    k, v = (x.strip() for x in stripped.split(":", 1))
                    if v.lower() in ("true", "false"):
                        v = v.lower() == "true"
                    elif v.isdigit():
                        v = int(v)
                    # unindented lines are top-level keys (e.g. spmd)
                    if line[0] not in " \t" and not line.startswith("- "):
                        top[k] = v
                    elif cur is not None:
                        cur[k] = v
        return {"nodes": nodes, **top}


class ClusterConfig:
    """Parsed cluster description (reference runner.py:158-186).

    ``spmd=True`` (yaml top-level ``spmd: true``) makes every worker a
    process of one ``torch.distributed`` job even on a single machine."""

    def __init__(self, nodes, spmd=False):
        self.hosts = []
        self.servers = {}       # host -> count
        self.workers = {}       # host -> count
        self.chief = None
        self.spmd = bool(spmd)
        allowed = {"host", "servers", "workers", "chief"}
        for node in nodes:
            extra = set(node) - allowed
            assert not extra, f"invalid node attributes: {extra}"
            host = node["host"]
            self.hosts.append(host)
            if node.get("servers", 0):
                self.servers[host] = int(node["servers"])
            if node.get("workers", 0):
                self.workers[host] = int(node["workers"])
            if node.get("chief", False):
                assert self.chief is None, "there should be only one chief"
                self.chief = host
        assert self.chief is not None, "there should be one chief"

    @property
    def num_servers(self):
        return sum(self.servers.values())

    @property
    def num_workers(self):
        return sum(self.workers.values())

    @property
    def single_host(self):
        # a cluster with one remote host is not single-host: ports
        # claimed here say nothing about where its servers bind
        return set(self.hosts) <= {"localhost", "127.0.0.1"}

    def server_endpoints(self, base_port=None):
        """[(host, port)] for every server.

        Single-host: a free port for each, claimed here by a listening
        socket that its server will be handed. Multi-host: a port
        claimed here says nothing about a remote host, so a
        deterministic contiguous range from ``base_port``
        (``HETU_PS_BASE_PORT``, default 18590) instead."""
        eps = []
        if self.single_host and base_port is None:
            from .ps.server import claim_port
            for host, n in self.servers.items():
                for _ in range(n):
                    sock = claim_port(0)
                    port = sock.getsockname()[1]
                    _claims[port] = sock
                    eps.append((host, port))
            return eps
        port = base_port if base_port is not None else int(
            os.environ.get("HETU_PS_BASE_PORT", "18590"))
        for host, n in self.servers.items():
            for _ in range(n):
                eps.append((host, port))
                port += 1
        return eps

    def worker_hosts(self):
        """Worker hosts with the chief first: rank 0 runs on the chief,
        which serves the rendezvous."""
        hosts = list(self.workers.items())
        hosts.sort(key=lambda kv: kv[0] != self.chief)
        return hosts


def parse_config(path):
    settings = _load_yaml(path)
    return ClusterConfig(settings["nodes"],
                         spmd=settings.get("spmd", False))


def _inherited_env():
    """The caller's environment without :data:`FLEET_VARS`: the base of
    every local server's and worker's."""
    return {k: v for k, v in os.environ.items() if k not in FLEET_VARS}


def _is_local(host):
    return host in ("localhost", "127.0.0.1")


def _ps_env(cfg, endpoints, backups=None):
    env = {}
    if endpoints:
        env["HETU_PS_HOSTS"] = ",".join(h for h, _ in endpoints)
        env["HETU_PS_PORTS"] = ",".join(str(p) for _, p in endpoints)
        env["HETU_PS_NWORKERS"] = str(cfg.num_workers)
    if backups:
        # clients fail over to these per-shard replicas (ps_client.cc)
        env["HETU_PS_BACKUP_HOSTS"] = ",".join(h for h, _ in backups)
        env["HETU_PS_BACKUP_PORTS"] = ",".join(str(p)
                                               for _, p in backups)
    return env


def _backup_endpoints(cfg, endpoints):
    """One backup endpoint per primary shard (``HETU_PS_REPLICATE=1``):
    single-host claims fresh free ports; multi-host extends the
    deterministic range past the primaries."""
    if os.environ.get("HETU_PS_REPLICATE", "0") in ("0", "", "false") \
            or not endpoints:
        return []
    if cfg.single_host:
        return cfg.server_endpoints()
    base = int(os.environ.get("HETU_PS_BASE_PORT", "18590"))
    return cfg.server_endpoints(base_port=base + len(endpoints))


def _spawn_one_server(cfg, host, port, senv, identify):
    """Start one PS server process (fork locally, ssh remotely). A local
    one serves the port's claim (made again for a respawn) and is
    running when this returns."""
    if _is_local(host):
        from .ps.server import claim_port, spawn_server
        lsock = _claims.pop(port, None) or claim_port(port)
        p = spawn_server(lsock, cfg.num_workers, wait_s=60, extra_env=senv,
                         base_env=_inherited_env())
    else:
        ssh = ["ssh"] + (["-i", identify] if identify else []) + [host]
        remote = " ".join(shlex.quote(a) for a in [
            "python3", os.path.join(PKG_ROOT, RUN_SERVER), str(port),
            str(cfg.num_workers)])
        exports = " ".join(f"{k}={shlex.quote(str(v))}"
                           for k, v in senv.items())
        p = subprocess.Popen(ssh + [f"env {exports} {remote}"])
    _procs.append(p)
    return p


def _spawn_servers(cfg, endpoints, identify=None, extra_env=None):
    """Start every PS server. ``extra_env`` maps endpoint index -> env
    dict (the replication target of a primary). Returns one record per
    server: the respawn handle."""
    servers = []
    for i, (host, port) in enumerate(endpoints):
        senv = (extra_env or {}).get(i, {})
        p = _spawn_one_server(cfg, host, port, senv, identify)
        servers.append({"proc": p, "host": host, "port": port,
                        "env": senv, "identify": identify})
    # remote servers: wait until each accepts (a worker whose PSClient
    # connects before its server binds raises at once)
    from .ps.server import _port_open
    deadline = time.time() + 60
    for host, port in endpoints:
        if _is_local(host):
            continue
        while not _port_open(host, port):
            assert time.time() < deadline, \
                f"PS server {host}:{port} not up"
            time.sleep(0.05)
    return servers


def _worker_env(cfg, base_env, rank, master=None, local_rank=0):
    """A worker's environment: its PS rank, and with ``master`` (host,
    port) the rendezvous of one multi-process job — the reference's
    ``HETU_*`` names and torch.distributed's."""
    env = dict(base_env)
    env["HETU_PS_RANK"] = str(rank)
    if master:
        host, port = master
        env["HETU_COORDINATOR"] = f"{host}:{port}"
        env["HETU_NUM_PROCS"] = str(cfg.num_workers)
        env["HETU_PROC_ID"] = str(rank)
        env["MASTER_ADDR"] = host
        env["MASTER_PORT"] = str(port)
        env["RANK"] = str(rank)
        env["WORLD_SIZE"] = str(cfg.num_workers)
        env["LOCAL_RANK"] = str(local_rank)
    return env


def _master(cfg):
    """(host, port) of the job's rendezvous, or None for a fleet of
    independent PS workers (one host without ``spmd``)."""
    if cfg.single_host and not cfg.spmd:
        return None
    port = os.environ.get("HETU_COORDINATOR_PORT")
    if cfg.single_host:
        if port is None:
            from .ps.server import pick_free_port
            port = pick_free_port()
        return "127.0.0.1", int(port)
    return cfg.chief, int(port or 29400)


def _free_port_range(n, tries=64):
    """A base port whose ``n`` ports from it up are all free on every
    interface now, as the pipeline channel binds them."""
    import socket
    from .ps.server import pick_free_port
    for _ in range(tries):
        base = pick_free_port()
        if base + n > 65536:
            continue
        held = []
        try:
            for k in range(n):
                s = socket.socket()
                held.append(s)
                s.bind(("0.0.0.0", base + k))
            return base
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
    raise RuntimeError(f"no {n} free consecutive ports for the pipeline "
                       f"channel; set HETU_PIPE_BASE_PORT")


def _pipe_env(cfg):
    """The pipeline channel's addresses for a job's workers (reference
    launcher.py:465-482): one endpoint per rank, the chief's first. Only
    a single-host cluster may use loopback: in a mixed one, a remote
    rank dialing 127.0.0.1 for a local rank would dial itself. The base
    port is ``HETU_PIPE_BASE_PORT``; unset, a single host takes a range
    free now (as ``_master`` does for the rendezvous), so two jobs on
    one host do not share a channel, and a cluster the reference's
    19500."""
    pipe_hosts, hosts = [], []
    for host, n in cfg.worker_hosts():
        pipe_hosts.extend(["127.0.0.1" if cfg.single_host else host] * n)
        hosts.extend([host] * n)
    base = os.environ.get("HETU_PIPE_BASE_PORT")
    if base is None:
        base = _free_port_range(len(hosts)) if cfg.single_host else 19500
    return {"HETU_PIPE_HOSTS": ",".join(pipe_hosts),
            "HETU_PIPE_BASE_PORT": str(base),
            "HETU_HOSTS": ",".join(hosts)}


def _omp_threads(nlocal):
    """The CPU threads of one of ``nlocal`` workers on this host, unless
    ``OMP_NUM_THREADS`` says otherwise: the host's cores shared out.
    Each torch process would otherwise start a thread per core, and
    workers that share a host's cores wait on each other's spinning
    threads (a fleet's CPU step slows tenfold)."""
    if "OMP_NUM_THREADS" in os.environ:
        return os.environ["OMP_NUM_THREADS"]
    return str(max(1, len(os.sched_getaffinity(0)) // nlocal))


def _wait_workers(workers):
    """Wait for every worker; on the first that exits non-zero stop the
    rest (they would wait for it at a barrier) and return its code."""
    rc = 0
    pending = list(workers)
    while pending:
        for p in list(pending):
            code = p.poll()
            if code is None:
                continue
            pending.remove(p)
            if code != 0 and rc == 0:
                rc = code
                for q in pending:
                    q.terminate()
        time.sleep(0.05)
    return rc


def run_autoplan(cfg, command):
    """Cost-model plan preview (``--autoplan``; reference launcher.py:300):
    run ``command`` ONCE in a plain subprocess with
    ``HETU_AUTOPLAN_REPORT`` set — the executor's config (``HetuConfig``)
    runs the planner over the graph the script builds, prints the chosen
    plan and its predicted-vs-measured table to stderr, writes the JSON
    report, prints ``autoplan: OK`` and exits before any fleet machinery.
    No fleet variable reaches it (no rendezvous, no PS hosts) but the
    job's size, ``HETU_NUM_PROCS`` (the world the planner plans for) and
    ``HETU_HOSTS``, so pp plans map hostnames the way the real launch
    would. Returns the subprocess's exit code: 0 = plan printed;
    anything else = the script failed before an Executor was built."""
    import tempfile
    hosts_in_order = []
    for host, n in cfg.worker_hosts():
        hosts_in_order.extend([host] * n)
    report_path = os.path.join(tempfile.mkdtemp(prefix="hetu-autoplan-"),
                               "autoplan.json")
    env = {**_inherited_env(),
           "PYTHONPATH": PKG_ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", ""),
           "HETU_AUTOPLAN_REPORT": report_path,
           "HETU_NUM_PROCS": str(max(1, cfg.num_workers))}
    if hosts_in_order:
        env["HETU_HOSTS"] = ",".join(hosts_in_order)
    env.pop("HETU_PREFLIGHT", None)
    p = subprocess.run(command, env=env)
    if p.returncode == 0:
        if os.path.exists(report_path):
            print(f"autoplan: report written to {report_path}", flush=True)
        else:
            print("autoplan: WARNING script exited 0 but no report "
                  "file appeared — either the script never built an "
                  "Executor, or the report path was unwritable (a "
                  "plan table printed above means the latter)", flush=True)
    return p.returncode


def launch_command(cfg, command, identify=None):
    """Run ``command`` once per worker with the cluster env wired (the
    ``python -m hetu_tpu_torch.launcher -c conf.yml python train.py``
    path). Returns the first non-zero exit code of a worker, else 0."""
    try:
        endpoints = cfg.server_endpoints()
        # replicated shards (HETU_PS_REPLICATE=1): backups come up first
        # so each primary can dial its replication target at startup;
        # workers learn both endpoint lists and fail over client-side
        server_env = {}
        backups = _backup_endpoints(cfg, endpoints)
        if backups:
            _spawn_servers(cfg, backups, identify)
            for i, (bhost, bport) in enumerate(backups):
                server_env[i] = {"HETU_PS_MY_BACKUP_HOST": bhost,
                                 "HETU_PS_MY_BACKUP_PORT": str(bport)}
        _spawn_servers(cfg, endpoints, identify, extra_env=server_env)
        ps_env = _ps_env(cfg, endpoints, backups)
        master = _master(cfg)
        if master is not None:
            ps_env.update(_pipe_env(cfg))
        pypath = PKG_ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")
        workers = []
        rank = 0
        for host, n in cfg.worker_hosts():  # chief first: rank 0 there
            for local_rank in range(n):
                wenv = _worker_env(cfg, ps_env, rank, master, local_rank)
                wenv["PYTHONPATH"] = pypath
                if _is_local(host):
                    wenv.setdefault("OMP_NUM_THREADS", _omp_threads(n))
                    p = subprocess.Popen(command,
                                         env={**_inherited_env(), **wenv})
                else:
                    ssh = ["ssh"] + (["-i", identify] if identify else [])
                    exports = " ".join(f"{k}={shlex.quote(str(v))}"
                                       for k, v in wenv.items())
                    quoted = " ".join(shlex.quote(c) for c in command)
                    p = subprocess.Popen(
                        ssh + [host, f"env {exports} {quoted}"])
                workers.append(p)
                _procs.append(p)
                rank += 1
        return _wait_workers(workers)
    finally:
        _shutdown()


def _respawn_dead_servers(servers, cfg):
    """In-job PS failover, launcher side: a dead server process is not
    a fleet failure — clients flip to the shard's other replica and
    replay their acked-push window (ps_client.cc), so the launcher
    respawns a fresh standby on the same endpoint (it rejoins empty; the
    one-way client flip never reads it, but a later death of the
    surviving replica has somewhere to forward to). The fleet watchdog
    that calls this comes with ROADMAP item 14."""
    for srec in servers or []:
        p = srec["proc"]
        if p.poll() is None:
            continue
        host, port = srec["host"], srec["port"]
        if not _is_local(host):
            print(f"launcher: PS server {host}:{port} exited "
                  f"rc={p.returncode}; remote respawn unsupported — "
                  f"clients run on the surviving replica")
            srec["proc"] = subprocess.Popen(["true"])   # stop re-firing
            continue
        print(f"launcher: PS server {host}:{port} exited "
              f"rc={p.returncode} — respawning a standby (clients fail "
              f"over to the backup replica and replay)")
        srec["proc"] = _spawn_one_server(cfg, host, port, srec["env"],
                                         srec["identify"])


def _launch_worker(target, args, wenv):
    # module-level so the 'spawn' context can pickle it
    for k in FLEET_VARS:
        os.environ.pop(k, None)
    os.environ.update(wenv)
    target(args)


def launch(target, args):
    """In-process API (reference launcher.py:18-38): run
    ``cfg.num_workers`` copies of ``target(args)`` in local processes
    with the PS fleet of ``args.config`` running. ``target`` must be a
    module-level function (it crosses a 'spawn' process boundary)."""
    import multiprocessing as mp
    cfg = parse_config(args.config)
    try:
        endpoints = cfg.server_endpoints()
        _spawn_servers(cfg, endpoints)
        ps_env = _ps_env(cfg, endpoints)
        ctx = mp.get_context("spawn")
        ps = [ctx.Process(target=_launch_worker,
                          args=(target, args, _worker_env(cfg, ps_env, r)))
              for r in range(cfg.num_workers)]
        for p in ps:
            p.start()
        for p in ps:
            p.join()
    finally:
        _shutdown()


def _shutdown(*_a):
    for p in _procs:
        if p.poll() is None:
            p.terminate()
    for p in _procs:
        try:
            p.wait(timeout=3)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    _procs.clear()
    for sock in _claims.values():
        sock.close()
    _claims.clear()


def _on_signal(signum, _frame):
    _shutdown()
    sys.exit(128 + signum)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.launcher",
        description="launch a hetu_tpu_torch PS/worker cluster from yaml")
    parser.add_argument("-c", "--config", required=True,
                        help="cluster yaml (nodes: host/servers/workers)")
    parser.add_argument("-i", "--identify", default=None,
                        help="ssh identity file for remote hosts")
    # the reference's options of modes still to port: parsed so that
    # they are refused by name, not taken for the command
    parser.add_argument("--telemetry", default=None, metavar="DIR",
                        help="refused: telemetry waits for ROADMAP item 14")
    parser.add_argument("--health", default=None, metavar="SPEC",
                        help="refused: health waits for ROADMAP item 14")
    parser.add_argument("--watch", action="store_true",
                        help="refused: the fleet plane waits for ROADMAP "
                             "item 14")
    parser.add_argument("--hang-timeout", type=float, default=None,
                        metavar="SECONDS",
                        help="refused: the watchdog waits for ROADMAP "
                             "item 14")
    parser.add_argument("--preflight", action="store_true",
                        help="refused: the analysis waits for ROADMAP "
                             "item 17")
    parser.add_argument("--autoplan", action="store_true",
                        help="cost-model plan preview: run the command "
                             "once with the auto-parallelism planner "
                             "armed (HETU_AUTOPLAN_REPORT), print the "
                             "chosen (dp,tp,pp,M,V) plan and its "
                             "predicted-vs-measured cost table, and "
                             "exit WITHOUT spawning the fleet")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="worker command, e.g. python train.py")
    args = parser.parse_args(argv)
    for dest, (flag, item) in REFUSED.items():
        if getattr(args, dest) not in (None, False):
            print(f"launcher: {flag} is not ported yet: it waits for "
                  f"ROADMAP {item}", file=sys.stderr)
            return 2
    if not args.command:
        parser.error("no worker command given")
    cfg = parse_config(args.config)
    print(f"Cluster: chief={cfg.chief} "
          f"servers({cfg.num_servers})={cfg.servers} "
          f"workers({cfg.num_workers})={cfg.workers}", flush=True)
    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    if args.autoplan:
        return run_autoplan(cfg, args.command)
    return launch_command(cfg, args.command, args.identify)


if __name__ == "__main__":
    sys.exit(main())
