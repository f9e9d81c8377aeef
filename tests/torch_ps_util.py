"""Parameter servers for the PS parity tests: one server of each package
on localhost, each package's client connected to its own, and both
packages' default clients set. The two server libraries are separate
builds loaded RTLD_LOCAL, so the two clients' connection states do not
meet; the tests pass addresses explicitly instead of through
``HETU_PS_PORTS``. And fleets of either package's launcher, run with a
clean environment."""
import contextlib
import fcntl
import os
import signal
import subprocess
import sys

import hetu_tpu.ps.client as jclient
import hetu_tpu.ps.native_lib as jnative
import hetu_tpu.ps.server as jserver
import hetu_tpu_torch.ps.client as tclient
import hetu_tpu_torch.ps.native_lib as tnative
import hetu_tpu_torch.ps.server as tserver
from launcher_util import clean_launcher_env


def build_jax_lib():
    """The JAX package's server library, built here if it is not yet.
    Its ``build_lib`` runs ``make`` with no lock, and each of its
    servers calls it on start: left to them, two servers of one fleet
    (and any other test process) run ``make`` on one tree at once, and
    its launcher gives local servers 15 s to come up. So it is built
    before any child starts, one builder at a time."""
    tnative.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(tnative.BUILD_DIR / "hetu_tpu_ps_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return jnative.build_lib()


@contextlib.contextmanager
def jax_server(nservers=1):
    """``nservers`` hetu_tpu servers and a hetu_tpu client on them."""
    build_jax_lib()         # before the child: it builds on first use
    ports = [jserver.pick_free_port() for _ in range(nservers)]
    try:
        for port in ports:
            jserver.ensure_server(port=port, nworkers=1, wait_s=60)
        client = jclient.PSClient(
            hosts=",".join(["127.0.0.1"] * nservers),
            ports=",".join(map(str, ports)), rank=0, nworkers=1)
        jclient.set_default_client(client)
        yield client, ports
        client.shutdown_servers()
        jclient.close_default_client()
    finally:
        jserver.shutdown_server()


def start_server(nworkers=1, extra_env=None):
    """A server of the port on a port the kernel picks, claimed from that
    moment (no other test process can take it between the pick and the
    server's start); ``tserver.shutdown_server()`` stops it. Returns
    (port, process)."""
    lsock = tserver.claim_port(0)
    port = lsock.getsockname()[1]
    proc = tserver.spawn_server(lsock, nworkers, wait_s=60,
                                extra_env=extra_env)
    tserver._server_procs.append(proc)
    return port, proc


@contextlib.contextmanager
def torch_server(nservers=1):
    """``nservers`` servers of the port and the port's client on them."""
    try:
        ports = [start_server()[0] for _ in range(nservers)]
        client = tclient.PSClient(
            hosts=",".join(["127.0.0.1"] * nservers),
            ports=",".join(map(str, ports)), rank=0, nworkers=1)
        tclient.set_default_client(client)
        yield client, ports
        client.shutdown_servers()
        tclient.close_default_client()
    finally:
        tserver.shutdown_server()


@contextlib.contextmanager
def both_servers(nservers=1):
    """``(hetu_tpu client, port client)``; the port's on ``nservers``
    servers."""
    with jax_server() as (jc, _), torch_server(nservers) as (tc, _):
        yield jc, tc


# --- fleets started by a launcher ---------------------------------------

def clean_fleet_env(**extra):
    """The JAX package's clean launcher environment (its fleet tests'
    scrub of leaked fleet state), with JAX on the CPU: the environment
    of either package's launcher run. The port's launcher also takes
    its own fleet variables out of what its servers and workers
    inherit."""
    return clean_launcher_env(JAX_PLATFORMS="cpu", **extra)


def run_fleet(package, config, script, tmp_path, timeout=120, **extra):
    """``python -m <package>.launcher -c <config> python <script>`` with
    a clean environment (``HETU_TEST_OUT`` = ``tmp_path``); the
    launcher runs in a session of its own, and on a timeout the whole
    session is killed, servers and workers with it. Returns the
    completed process. The package's server library is built first: its
    servers would build it themselves, inside the launcher's wait for
    them to come up."""
    if package == "hetu_tpu":
        build_jax_lib()
    else:
        tnative.build_lib()
    cfg = tmp_path / f"cluster_{package}.yml"
    cfg.write_text(config)
    src = tmp_path / f"worker_{package}.py"
    src.write_text(script)
    env = clean_fleet_env(HETU_TEST_OUT=str(tmp_path), **extra)
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.launcher", "-c", str(cfg),
         sys.executable, str(src)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"fleet timed out after {timeout} s:\n{out}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out)
