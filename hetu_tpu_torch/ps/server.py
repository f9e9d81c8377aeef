"""PS server process management.

Counterpart of ``hetu_tpu/ps/server.py`` (reference parity:
python/hetu/launcher.py's server role). The server is the C++
``hetu_ps_run_server`` loop of the port's own library, run in a
subprocess (``python hetu_tpu_torch/ps/run_server.py PORT NWORKERS``,
by path, so that it imports no torch); addressing is direct
(``HETU_PS_HOSTS`` / ``HETU_PS_PORTS``), so no scheduler process is
needed. The server runs on the host by design: the port puts nothing
of it on the card.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

from .native_lib import build_lib

__all__ = ["ensure_server", "shutdown_server", "claim_port", "spawn_server",
           "pick_free_port", "default_port", "ensure_scheduler",
           "shutdown_scheduler"]

# the server entry, run by path (see run_server.py)
RUN_SERVER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "run_server.py")
_server_procs = []
_atexit_registered = False


def default_port():
    return int(os.environ.get("HETU_PS_PORTS", "18590").split(",")[0])


def _port_open(host, port):
    try:
        with socket.create_connection((host, port), timeout=0.2):
            return True
    except OSError:
        return False


def pick_free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def claim_port(port=0):
    """A socket bound to ``port`` on every interface and listening: the
    claim that makes a port this process's. A second bind against a
    listening socket fails even under SO_REUSEADDR (bind alone is not
    exclusive), so of two claimants exactly one wins; the loser gets
    ``OSError``. Port 0 claims a free port the kernel picks, held from
    that moment: no other process can take it before the server runs.
    Connections that arrive before the server's accept loop queue in
    the backlog."""
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        sock.bind(("0.0.0.0", port))
        sock.listen(64)
    except OSError:
        sock.close()
        raise
    return sock


def spawn_server(lsock, nworkers, wait_s=10.0, extra_env=None,
                 base_env=None, scrape_sock=None):
    """Start a server process on the claimed socket ``lsock`` (closed
    here: the child holds its own copy) and wait until it serves.
    Returns its ``Popen``.

    The child is ``run_server.py`` run as a script, so it loads neither
    the package's ``__init__`` nor torch. It is handed the socket
    (``HETU_PS_LISTEN_FD``) and a readiness pipe: the port is listening
    before the child runs, so "port open" does not mean "serving" — the
    child writes one byte when its accept loop is about to run, and a
    child that dies during startup closes the pipe instead (without
    this, a crashed child would be handed back as a live server because
    connections queue happily in the claimed socket's backlog).
    ``extra_env`` adds to the child's environment — the replication
    hook: a primary is armed with its backup target via
    ``HETU_PS_MY_BACKUP_HOST``/``HETU_PS_MY_BACKUP_PORT``. ``base_env``
    replaces ``os.environ`` as the environment it adds to.
    ``scrape_sock``, a claimed port for the ``/metrics`` scrape, is
    handed over as the PS socket is (``HETU_TELEMETRY_LISTEN_FD``) and
    closed here too."""
    port = lsock.getsockname()[1]
    # build the library here, not in the child: a first build takes
    # longer than the child's startup allowance
    build_lib()
    lsock.set_inheritable(True)
    scrape = {}
    if scrape_sock is not None:
        scrape_sock.set_inheritable(True)
        scrape["HETU_TELEMETRY_LISTEN_FD"] = str(scrape_sock.fileno())
    rfd, wfd = os.pipe()
    try:
        try:
            proc = subprocess.Popen(
                [sys.executable, RUN_SERVER, str(port), str(nworkers)],
                env={**(os.environ if base_env is None else base_env),
                     "HETU_PS_LISTEN_FD": str(lsock.fileno()),
                     "HETU_PS_READY_FD": str(wfd),
                     **(extra_env or {}), **scrape},
                pass_fds=(lsock.fileno(), wfd) + tuple(
                    int(fd) for fd in scrape.values()),
                # a fresh fd table otherwise: the child must not hold
                # the parent's stdio pipes open past the parent's
                # death (a `script | tail` would otherwise never see
                # EOF while the server lives)
                stdin=subprocess.DEVNULL)
        except BaseException:
            os.close(rfd)       # spawn failed: nothing will read it
            raise
    finally:
        # the child inherited its own copies; keeping ours would hold
        # the port (and the claim, and the pipe's EOF) for life
        lsock.close()
        if scrape_sock is not None:
            scrape_sock.close()
        os.close(wfd)
    import select
    deadline = time.time() + wait_s
    try:
        while time.time() < deadline:
            readable, _, _ = select.select([rfd], [], [], 0.05)
            if readable:
                if os.read(rfd, 1):
                    return proc          # child reached its serve loop
                # EOF without the readiness byte: died during startup
                try:
                    rc = proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    rc = "no exit (readiness pipe closed unready)"
                raise RuntimeError(
                    f"PS server exited with {rc} during startup")
    finally:
        os.close(rfd)
    proc.kill()
    proc.wait()
    raise RuntimeError(f"PS server did not come up on :{port}")


def ensure_server(port=None, nworkers=None, wait_s=10.0, extra_env=None):
    """Start a PS server subprocess on ``port`` if none is listening.

    Startup races are resolved by the claim (:func:`claim_port`): two
    processes (two workers hitting the in-process convenience path at
    once) can both observe the port closed and both try to spawn; the
    parent claims the port before it spawns, and the loser simply waits
    for the winner's port and adopts it (returns None, like the
    port-already-open fast path). Returns the new server's ``Popen``
    otherwise (see :func:`spawn_server`)."""
    port = port or default_port()
    nworkers = nworkers or int(os.environ.get("HETU_PS_NWORKERS", "1"))
    if _port_open("127.0.0.1", port):
        return None
    try:
        lsock = claim_port(port)
    except OSError:
        # lost the claim: another spawner (or a just-started server)
        # owns the port — wait for it and adopt
        deadline = time.time() + wait_s
        while time.time() < deadline:
            if _port_open("127.0.0.1", port):
                return None
            time.sleep(0.05)
        raise RuntimeError(
            f"port {port} is claimed by another process but no PS "
            f"server came up on it")
    proc = spawn_server(lsock, nworkers, wait_s=wait_s, extra_env=extra_env)
    _server_procs.append(proc)
    if not _atexit_registered:
        # single-process convenience runs (examples' ensure_local_ps)
        # must not leak the fleet past interpreter exit
        import atexit
        atexit.register(shutdown_server)
        globals()["_atexit_registered"] = True
    return proc


def shutdown_server():
    for proc in _server_procs:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                proc.kill()
    _server_procs.clear()


def ensure_scheduler():
    """Direct-addressed transport needs no rendezvous scheduler; kept
    for the reference's API (its launcher's scheduler role)."""


def shutdown_scheduler():
    pass
