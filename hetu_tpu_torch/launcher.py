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
  ``HETU_COORDINATOR`` / ``HETU_NUM_PROCS`` / ``HETU_PROC_ID``. On one
  host the launcher claims the rendezvous port (a listening socket) and
  hands it to rank 0 (``HETU_MASTER_LISTEN_FD``), whose store serves
  it: no other process can take the port in between. The
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
  reference's launcher exports them. On one host, a range the caller did
  not set is claimed (listening sockets) and rank k is handed port
  base + k's (``HETU_PIPE_LISTEN_FD``), as the rendezvous port is.
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

``--telemetry DIR`` turns telemetry on fleet-wide (:func:`launch_command`):
every worker writes its per-rank trace, metrics and flight dump there
(``HETU_TELEMETRY``), each PS server serves a ``/metrics`` scrape
(``HETU_TELEMETRY_PORT``), and the launcher merges the ranks' traces
into ``trace_merged.json`` at the end. ``--hang-timeout S`` arms the
watchdog (:func:`_wait_with_watchdog`): workers heartbeat a step into
the telemetry dir, and a rank stalled past ``S`` seconds has the fleet
dumped and killed, with exit code
:data:`~.telemetry.watchdog.EXIT_WATCHDOG`. ``--health SPEC`` arms the
training health monitor in every worker (``HETU_HEALTH``; records
``health_rank<r>.jsonl`` in the telemetry dir, a temporary one without
``--telemetry``). ``--watch`` arms the fleet plane
(``telemetry/fleet.py``): every worker records a step timeline
(``HETU_FLEET``, flushed as ``timeline_rank<r>.jsonl``) and serves
``/fleet`` on a metrics port claimed for its rank
(``HETU_METRICS_PORT``, handed over as ``HETU_METRICS_LISTEN_FD``), and
the launcher runs a :class:`~.telemetry.fleet.FleetMonitor` beside the
wait that names a straggler and writes ``fleet_report.json`` and
``trace_fleet.json`` (every ``HETU_WATCH_INTERVAL`` seconds, default 1).
A monitor that fails makes the launcher exit non-zero.

``--preflight`` is the static gate (:func:`run_preflight`): the command
runs once, in a plain process, with ``HETU_PREFLIGHT`` set; its first
``Executor`` analyzes the graph (:mod:`hetu_tpu_torch.analysis`),
prints the findings, writes the JSON report and exits before it
touches a device, a process group or a server. No worker, server or
store starts: the exit code is 0 on a clean graph,
:data:`~hetu_tpu_torch.analysis.EXIT_PREFLIGHT` (121) on error
findings, else the script's own.

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
           "run_autoplan", "run_preflight", "main"]

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_SERVER = os.path.join("hetu_tpu_torch", "ps", "run_server.py")

# the options of modes the port does not have yet -> their ROADMAP item
REFUSED = {}

# the launcher's exit code where every worker succeeded but the fleet
# monitor failed (--watch): the run's report is missing
EXIT_MONITOR = 1

# what the launcher sets on a fleet's servers and workers, or sets for
# one fleet only: never inherited from the caller
FLEET_VARS = ("HETU_PS_HOSTS", "HETU_PS_PORTS", "HETU_PS_NWORKERS",
              "HETU_PS_RANK", "HETU_PS_BACKUP_HOSTS", "HETU_PS_BACKUP_PORTS",
              "HETU_PS_MY_BACKUP_HOST", "HETU_PS_MY_BACKUP_PORT",
              "HETU_PS_REPLICATE", "HETU_COORDINATOR", "HETU_NUM_PROCS",
              "HETU_PROC_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK", "HETU_PIPE_HOSTS",
              "HETU_PIPE_BASE_PORT", "HETU_HOSTS", "HETU_MASTER_LISTEN_FD",
              "HETU_PIPE_LISTEN_FD", "HETU_WATCHDOG_DIR",
              "HETU_HANG_TIMEOUT", "HETU_TELEMETRY_PORT", "HETU_FLEET",
              "HETU_METRICS_PORT", "HETU_METRICS_LISTEN_FD")

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
        # the scrape port's claim goes to the first server on it; a
        # respawn binds the port its dead predecessor released
        scrape = _claims.pop(int(senv.get("HETU_TELEMETRY_PORT", 0)), None)
        p = spawn_server(lsock, cfg.num_workers, wait_s=60, extra_env=senv,
                         base_env=_inherited_env(), scrape_sock=scrape)
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
            # claimed, not just picked: a port picked free and released
            # can be taken by any other process (a server or store that
            # binds port 0 gets it) before rank 0's store binds it; the
            # claim is handed to rank 0 (HETU_MASTER_LISTEN_FD)
            from .ps.server import claim_port
            sock = claim_port(0)
            port = sock.getsockname()[1]
            _claims[port] = sock
        return "127.0.0.1", int(port)
    return cfg.chief, int(port or 29400)


def _claim_port_range(n, tries=64):
    """``n`` consecutive ports, each claimed by a listening socket
    (:func:`~.ps.server.claim_port`): ``(base, sockets)``, for the
    pipeline channel's ranks. A range picked free and released could
    lose a port to any process binding port 0 before the rank that
    listens on it starts."""
    from .ps.server import claim_port, pick_free_port
    for _ in range(tries):
        base = pick_free_port()
        if base + n > 65536:
            continue
        held = []
        try:
            for k in range(n):
                held.append(claim_port(base + k))
            return base, held
        except OSError:
            for s in held:
                s.close()
    raise RuntimeError(f"no {n} free consecutive ports for the pipeline "
                       f"channel; set HETU_PIPE_BASE_PORT")


def _pipe_env(cfg):
    """The pipeline channel's addresses for a job's workers (reference
    launcher.py:465-482): one endpoint per rank, the chief's first. Only
    a single-host cluster may use loopback: in a mixed one, a remote
    rank dialing 127.0.0.1 for a local rank would dial itself. The base
    port is ``HETU_PIPE_BASE_PORT``; unset, a single host claims a range
    (``_claims``, handed to the ranks at spawn, as ``_master`` claims the
    rendezvous), so two jobs on one host do not share a channel, and a
    cluster takes the reference's 19500."""
    pipe_hosts, hosts = [], []
    for host, n in cfg.worker_hosts():
        pipe_hosts.extend(["127.0.0.1" if cfg.single_host else host] * n)
        hosts.extend([host] * n)
    base = os.environ.get("HETU_PIPE_BASE_PORT")
    if base is None and cfg.single_host:
        base, socks = _claim_port_range(len(hosts))
        for k, sock in enumerate(socks):
            _claims[base + k] = sock
    elif base is None:
        base = 19500
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


def _exit_text(code):
    """A worker's exit code as words: a negative code is the signal
    that killed it (the launcher's own exit status is then 256 - n)."""
    if code >= 0:
        return f"exit code {code}"
    try:
        name = signal.Signals(-code).name
    except ValueError:
        name = f"signal {-code}"
    return f"killed by {name} (exit code {code}, {code & 0xff} from the " \
           f"launcher)"


def _wait_workers(workers, tick=None):
    """Wait for every worker; on the first that exits non-zero say which
    rank and how on stderr, stop the rest (they would wait for it at a
    barrier) and return its code. ``tick`` (the fleet monitor's poll) is
    called between checks."""
    rc = 0
    pending = list(workers)
    while pending:
        if tick is not None:
            tick()
        for p in list(pending):
            code = p.poll()
            if code is None:
                continue
            pending.remove(p)
            if code != 0 and rc == 0:
                rc = code
                print(f"launcher: worker rank {workers.index(p)} (pid "
                      f"{p.pid}) {_exit_text(code)}; stopping the others",
                      file=sys.stderr, flush=True)
                for q in pending:
                    q.terminate()
        time.sleep(0.05)
    return rc


def _plain_run_env(cfg, var, path):
    """The environment of a command run once outside the fleet
    (``--preflight``, ``--autoplan``): the caller's without the fleet's
    variables, ``var`` set to ``path``, and the job's size
    (``HETU_NUM_PROCS``) and hosts in rank order (``HETU_HOSTS``), so
    stage hostnames map to the ranks the real launch would use."""
    hosts_in_order = []
    for host, n in cfg.worker_hosts():
        hosts_in_order.extend([host] * n)
    env = {**_inherited_env(),
           "PYTHONPATH": PKG_ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", ""),
           var: path,
           "HETU_NUM_PROCS": str(max(1, cfg.num_workers))}
    if hosts_in_order:
        env["HETU_HOSTS"] = ",".join(hosts_in_order)
    return env


def run_preflight(cfg, command):
    """The static preflight gate (``--preflight``; reference
    launcher.py:257-297): run ``command`` ONCE in a plain subprocess
    with ``HETU_PREFLIGHT`` set. The script's ``HetuConfig`` analyzes
    the graph it builds, prints the findings, writes the JSON report and
    exits before it resolves a device, joins a process group or reaches
    a server; no fleet variable reaches it, so a multi-host script
    preflights on the launcher's machine, without a card. Returns the
    subprocess's exit code: 0 = a clean graph,
    ``analysis.EXIT_PREFLIGHT`` (121) = findings rejected it, anything
    else = the script failed before the analysis ran (as much a reason
    not to start the fleet)."""
    import tempfile
    report_path = os.path.join(tempfile.mkdtemp(prefix="hetu-preflight-"),
                               "preflight.json")
    env = _plain_run_env(cfg, "HETU_PREFLIGHT", report_path)
    env.pop("HETU_AUTOPLAN_REPORT", None)
    p = subprocess.run(command, env=env)
    if p.returncode == 0:
        if os.path.exists(report_path):
            print(f"preflight: graph verified clean "
                  f"(report: {report_path})", flush=True)
        else:
            # exit 0 and no report: the script never built an Executor,
            # so nothing was verified
            print("preflight: WARNING script exited 0 but never built a "
                  "graph (no Executor constructed); nothing was "
                  "verified", flush=True)
    return p.returncode


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
    report_path = os.path.join(tempfile.mkdtemp(prefix="hetu-autoplan-"),
                               "autoplan.json")
    env = _plain_run_env(cfg, "HETU_AUTOPLAN_REPORT", report_path)
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


def launch_command(cfg, command, identify=None, telemetry=None,
                   hang_timeout=None, health=None, watch=False):
    """Run ``command`` once per worker with the cluster env wired (the
    ``python -m hetu_tpu_torch.launcher -c conf.yml python train.py``
    path). Returns the first non-zero exit code of a worker, else 0.

    ``telemetry`` (a directory, ``--telemetry``): every worker exports
    its per-rank trace and metrics there (``HETU_TELEMETRY``), each PS
    server serves a Prometheus ``/metrics`` scrape
    (``HETU_TELEMETRY_PORT``: ``HETU_TELEMETRY_BASE_PORT`` + i where it
    is set, else on one host a free port, across hosts 18790 + i), a
    reused directory loses the previous fleet's heartbeats and dumps
    first, and after the workers exit the ranks' traces merge into one
    ``trace_merged.json``.

    ``hang_timeout`` (seconds, ``--hang-timeout``) arms the watchdog:
    workers heartbeat a step into the telemetry dir
    (``HETU_WATCHDOG_DIR``); a rank stalled past the timeout has every
    live worker's stacks and flight ring dumped, the fleet killed, and
    the launcher exits with ``EXIT_WATCHDOG``. It implies telemetry (a
    temporary directory where ``--telemetry`` was not given).

    ``health`` (a ``HealthOptions`` spec string, ``--health``) arms the
    training health monitor in every worker: each executor resolves
    ``health_options=None`` from the exported ``HETU_HEALTH``, writes
    ``health_rank<r>.jsonl`` into the telemetry dir and trips its action
    ladder on nonfinite values, gradient spikes and staleness
    violations (``telemetry/health.py``). It implies telemetry, as the
    health doctor needs a directory to merge.

    ``watch`` (``--watch``) arms the fleet plane (reference
    launcher.py:372-385, :429-445): workers record step timelines
    (``HETU_FLEET``) and heartbeats (``HETU_WATCHDOG_DIR``, even without
    ``--hang-timeout``) and serve ``/fleet`` on a metrics port a rank
    (``HETU_METRICS_BASE_PORT`` + rank where it is set, else claimed on
    one host and 18890 + rank across hosts), and a
    :class:`~.telemetry.fleet.FleetMonitor` polls them while the fleet
    runs, naming the straggler in
    ``fleet_report.json``; its spans go to ``trace_fleet.json``. A
    monitor that fails makes the launcher return :data:`EXIT_MONITOR`
    where the workers succeeded. It implies telemetry."""
    tdir = None
    if (hang_timeout or health or watch) and not telemetry:
        import tempfile
        prefix, flag, what = (
            ("fleet", "--watch", "timelines and the fleet report")
            if watch else
            ("watchdog", "--hang-timeout", "black-box dumps") if hang_timeout
            else ("health", "--health", "health records"))
        telemetry = tempfile.mkdtemp(prefix=f"hetu-{prefix}-")
        print(f"{prefix}: {flag} without --telemetry; {what} go to "
              f"{telemetry}", flush=True)
    try:
        endpoints = cfg.server_endpoints()
        server_env = {}
        if telemetry:
            tdir = os.path.abspath(telemetry)
            os.makedirs(tdir, exist_ok=True)
            _clear_stale_blackbox(tdir)
            for i, port in enumerate(_scrape_ports(cfg, len(endpoints))):
                server_env[i] = {"HETU_TELEMETRY_PORT": str(port),
                                 # server stacks land beside the workers'
                                 "HETU_TELEMETRY": tdir}
                print(f"telemetry: PS server {i} scrape at "
                      f"http://{endpoints[i][0]}:{port}/metrics",
                      flush=True)
        # replicated shards (HETU_PS_REPLICATE=1): backups come up first
        # so each primary can dial its replication target at startup;
        # workers learn both endpoint lists and fail over client-side
        backups = _backup_endpoints(cfg, endpoints)
        servers = []
        if backups:
            servers += _spawn_servers(cfg, backups, identify)
            for i, (bhost, bport) in enumerate(backups):
                server_env.setdefault(i, {}).update({
                    "HETU_PS_MY_BACKUP_HOST": bhost,
                    "HETU_PS_MY_BACKUP_PORT": str(bport)})
        servers += _spawn_servers(cfg, endpoints, identify,
                                  extra_env=server_env)
        ps_env = _ps_env(cfg, endpoints, backups)
        if tdir:
            ps_env["HETU_TELEMETRY"] = tdir
        if health:
            # every worker's Executor resolves health_options from it
            ps_env["HETU_HEALTH"] = str(health)
        metrics_ports = None
        if watch:
            ps_env["HETU_FLEET"] = "1"
            # live skew signal needs heartbeats even without
            # --hang-timeout (the watchdog itself fires only with it)
            ps_env["HETU_WATCHDOG_DIR"] = tdir
            # each rank's /fleet scrape: claimed on one host and handed
            # to the rank at spawn (_hand_claims)
            metrics_ports = dict(enumerate(_scrape_ports(
                cfg, cfg.num_workers, "HETU_METRICS_BASE_PORT", 18890)))
            if not cfg.single_host:
                print("fleet: WARNING multi-host fleet — /fleet scrapes "
                      "and flushed timelines cover launcher-local ranks "
                      "only; remote ranks contribute heartbeat signal "
                      "written on their own filesystem", flush=True)
        if hang_timeout:
            ps_env["HETU_WATCHDOG_DIR"] = tdir
            ps_env["HETU_HANG_TIMEOUT"] = str(float(hang_timeout))
            if not cfg.single_host:
                print("watchdog: WARNING multi-host fleet — stall "
                      "detection and dumps cover launcher-local ranks "
                      "only", flush=True)
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
                if metrics_ports:
                    wenv["HETU_METRICS_PORT"] = str(metrics_ports[rank])
                if _is_local(host):
                    wenv.setdefault("OMP_NUM_THREADS", _omp_threads(n))
                    fds = _hand_claims(wenv, master, rank)
                    p = subprocess.Popen(command, pass_fds=fds,
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
        monitor = _FleetWatch(len(workers), tdir, metrics_ports) \
            if watch else None
        tick = monitor.tick if monitor is not None else None
        if hang_timeout:
            rc = _wait_with_watchdog(workers, tdir, float(hang_timeout),
                                     servers, cfg, tick=tick)
        else:
            rc = _wait_workers(workers, tick=tick)
        if monitor is not None and not monitor.finish():
            rc = rc or EXIT_MONITOR
    finally:
        _shutdown()
    if tdir:
        _merge_telemetry(tdir, cfg.num_workers)
    return rc


def _hand_claims(wenv, master, rank):
    """The launcher's claimed ports that rank ``rank`` serves, set in its
    environment: the rendezvous for rank 0 (``HETU_MASTER_LISTEN_FD``,
    its store's socket), its channel port (``HETU_PIPE_LISTEN_FD``) and
    its metrics port under ``--watch`` (``HETU_METRICS_LISTEN_FD``).
    Returns the file descriptors to pass."""
    fds = []
    if master and rank == 0 and master[1] in _claims:
        fds.append(_claims[master[1]].fileno())
        wenv["HETU_MASTER_LISTEN_FD"] = str(fds[-1])
    base = wenv.get("HETU_PIPE_BASE_PORT")
    pipe = _claims.get(int(base) + rank) if base else None
    if pipe is not None:
        fds.append(pipe.fileno())
        wenv["HETU_PIPE_LISTEN_FD"] = str(fds[-1])
    mport = wenv.get("HETU_METRICS_PORT")
    msock = _claims.get(int(mport)) if mport else None
    if msock is not None:
        fds.append(msock.fileno())
        wenv["HETU_METRICS_LISTEN_FD"] = str(fds[-1])
    return tuple(fds)


class _FleetWatch:
    """The launcher's side of ``--watch`` (reference launcher.py:553-
    577): a FleetMonitor over the job's telemetry dir, polled between the
    wait's checks (throttled to its interval inside), its dashboard
    printed a window. Its Telemetry has no out_dir on purpose, so the
    launcher installs no crash handlers or atexit flushes; its
    ``fleet_watch`` / ``drift`` spans go to ``trace_fleet.json`` at the
    end. A poll that raises is remembered, polling stops, and
    :meth:`finish` reports the failure."""

    def __init__(self, nworkers, tdir, metrics_ports):
        from .telemetry import Telemetry
        from .telemetry.fleet import FleetMonitor
        self.tdir = tdir
        self.monitor = FleetMonitor(
            tdir, num_workers=nworkers, metrics_ports=metrics_ports,
            telemetry=Telemetry(enabled=True, rank=nworkers + 900,
                                service="fleet-monitor"),
            out_path=os.path.join(tdir, "fleet_report.json"))
        self.error = None

    def tick(self):
        if self.error is not None:
            return
        from .telemetry.fleet import render_report
        try:
            rep = self.monitor.poll()       # None between windows
        except Exception as e:             # noqa: BLE001 — reported
            self.error = repr(e)
            print(f"fleet: monitor FAILED: {self.error}", file=sys.stderr,
                  flush=True)
            return
        if rep is not None:
            print(render_report(rep), flush=True)

    def finish(self):
        """The last forced poll, its report and the monitor's trace, on
        a normal exit and after the watchdog fired (the last window is
        the one that matters). Returns False where the monitor failed,
        now or before."""
        from .telemetry.fleet import render_report
        if self.error is None:
            try:
                print(render_report(self.monitor.poll(force=True)),
                      flush=True)
                self.monitor.tel.tracer.export(
                    os.path.join(self.tdir, "trace_fleet.json"))
                print(f"fleet: report -> {self.monitor.out_path}",
                      flush=True)
            except Exception as e:         # noqa: BLE001 — reported
                self.error = repr(e)
        if self.error is not None:
            print(f"fleet: the monitor failed ({self.error}); the run has "
                  f"no fleet report", file=sys.stderr, flush=True)
            return False
        return True


def _scrape_ports(cfg, n, base_var="HETU_TELEMETRY_BASE_PORT",
                  default_base=18790):
    """``n`` scrape ports (the PS servers', or under ``--watch`` the
    worker ranks' ``/fleet``): ``base_var``'s value + i where it is set;
    else on one host a port claimed for each (``_claims``, handed to its
    server or rank at spawn, so fleets that share a host keep apart),
    across hosts ``default_base`` + i."""
    base = os.environ.get(base_var)
    if base is None and cfg.single_host:
        from .ps.server import claim_port
        ports = []
        for _ in range(n):
            sock = claim_port(0)
            ports.append(sock.getsockname()[1])
            _claims[ports[-1]] = sock
        return ports
    base = int(base or default_base)
    return [base + i for i in range(n)]


def _wait_with_watchdog(workers, tdir, hang_timeout, servers=None,
                        cfg=None, tick=None):
    """Wait for the workers under :class:`~.telemetry.watchdog.
    FleetWatchdog` (reference launcher.py:580-627, without the fleet
    monitor, which comes with ``--watch``): a stalled rank — hung, or
    dead, its heartbeat stopped — triggers the diagnose-then-kill
    sequence (SIGUSR1 stacks, SIGTERM flight dumps, kill) on the live
    ones and the watchdog's exit code. When every worker has exited
    with a code of its own, the first non-zero one, at once (a crash is
    not a hang). A rank killed by a signal is named by its stall even
    where the others then exit at once (a peer's broken channel); past
    the timeout with no stall, the first non-zero exit code. A dead PS
    server is survivable (replicated shards): it respawns instead of
    failing the fleet. ``tick`` (the fleet monitor's poll under
    ``--watch``) is called between checks."""
    from .telemetry.watchdog import FleetWatchdog
    wd = FleetWatchdog(tdir, num_workers=len(workers),
                       timeout=hang_timeout)
    by_rank = dict(enumerate(workers))
    poll_s = min(0.25, hang_timeout / 8)
    gone = None         # when every worker had exited, one by a signal
    while True:
        codes = [p.poll() for p in workers]
        if all(c == 0 for c in codes):
            break
        if None not in codes:
            if min(codes) >= 0:
                break
            gone = gone or time.time()
            if time.time() - gone > hang_timeout + 1.0:
                break   # a rank that never beat is not waited for
        if cfg is not None:
            _respawn_dead_servers(servers, cfg)
        if tick is not None:
            tick()
        stalled = wd.check(by_rank)
        if stalled:
            for rank, age, step in stalled:
                print(f"watchdog: rank {rank} stalled {age:.1f}s > "
                      f"{hang_timeout:.1f}s (last step {step}) — "
                      f"collecting stack + flight dumps, killing fleet",
                      flush=True)
            rc = wd.fire(by_rank)
            print(f"watchdog: fleet killed; stacks_rank*.log and "
                  f"flight_rank*.json are in {tdir} (exit code {rc})",
                  flush=True)
            return rc
        time.sleep(poll_s)
    rc = 0
    for p in workers:
        rc = rc or p.returncode
    return rc


def _clear_stale_blackbox(tdir):
    """Drop a previous fleet's heartbeats, flight dumps, stack logs, OOM
    reports, health records, step timelines and fleet report from a
    reused telemetry dir: a stale
    ``hb_rank*.json`` with an old timestamp would false-fire the
    watchdog on the new fleet, stale dumps would pollute its
    post-mortem, and the health doctor would merge two runs' steps."""
    import glob as _glob
    for pat in ("hb_rank*.json", "flight_rank*.json", "stacks_*.log",
                "oom_rank*.txt", "requests_rank*.json",
                "health_rank*.jsonl", "health_lastgood_rank*.json",
                "timeline_rank*.jsonl", "fleet_report.json",
                "trace_fleet.json"):
        for path in _glob.glob(os.path.join(tdir, pat)):
            try:
                os.remove(path)
            except OSError:
                pass


def _merge_telemetry(tdir, num_workers=None):
    """Merge the per-rank traces into one validated Perfetto file (best
    effort: a worker that never built an Executor exports nothing).
    Warns when fewer rank files exist than workers: remote ranks write
    on their own filesystem."""
    import glob as _glob
    from .telemetry import merge_traces
    from .telemetry.check import validate
    ranks = _glob.glob(os.path.join(tdir, "trace_rank*.json"))
    if num_workers and len(ranks) < num_workers:
        print(f"telemetry: WARNING only {len(ranks)}/{num_workers} "
              f"rank traces present under {tdir} — remote workers "
              f"export on their own filesystem; the merged trace "
              f"covers launcher-local ranks only", flush=True)
    try:
        merged = merge_traces(tdir)
    except ValueError as e:
        print(f"telemetry: no traces to merge ({e})", flush=True)
        return None
    n, errors = validate(merged)
    if errors:
        print(f"telemetry: merged trace INVALID: {errors[:3]}", flush=True)
    else:
        print(f"telemetry: merged trace -> {merged} ({n} events)",
              flush=True)
    return merged


def _respawn_dead_servers(servers, cfg):
    """In-job PS failover, launcher side: a dead server process is not
    a fleet failure — clients flip to the shard's other replica and
    replay their acked-push window (ps_client.cc), so the launcher
    respawns a fresh standby on the same endpoint (it rejoins empty; the
    one-way client flip never reads it, but a later death of the
    surviving replica has somewhere to forward to). The watchdog's wait
    (:func:`_wait_with_watchdog`) calls it."""
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
    parser.add_argument("--telemetry", default=None, metavar="DIR",
                        help="fleet-wide telemetry: per-rank Chrome "
                             "traces + metrics into DIR, a /metrics "
                             "scrape on each PS server, and one merged "
                             "trace_merged.json at the end")
    parser.add_argument("--hang-timeout", type=float, default=None,
                        metavar="SECONDS",
                        help="arm the watchdog: a rank whose heartbeat "
                             "goes stale past SECONDS has the fleet "
                             "dumped and killed (exit code 117); implies "
                             "telemetry")
    parser.add_argument("--health", default=None, metavar="SPEC",
                        help="arm the training health monitor in every "
                             "worker (HETU_HEALTH, e.g. "
                             "'every_n=5,action=dump'): per-rank "
                             "health_rank<r>.jsonl records and the trip "
                             "ladder; implies telemetry")
    parser.add_argument("--watch", action="store_true",
                        help="arm the fleet plane: per-rank step "
                             "timelines and /fleet scrapes, and a live "
                             "monitor naming the straggler into "
                             "fleet_report.json; implies telemetry")
    parser.add_argument("--preflight", action="store_true",
                        help="static gate: run the command once with "
                             "the preflight analysis armed "
                             "(HETU_PREFLIGHT), print its findings and "
                             "exit WITHOUT spawning the fleet: 0 on a "
                             "clean graph, 121 on error findings (the "
                             "passes of ROADMAP item 17a)")
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
    if args.preflight:
        return run_preflight(cfg, args.command)
    if args.autoplan:
        return run_autoplan(cfg, args.command)
    return launch_command(cfg, args.command, args.identify,
                          telemetry=args.telemetry,
                          hang_timeout=args.hang_timeout,
                          health=args.health, watch=args.watch)


if __name__ == "__main__":
    sys.exit(main())
