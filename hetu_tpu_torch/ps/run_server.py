"""Server-role entry point: ``python hetu_tpu_torch/ps/run_server.py
PORT NWORKERS``.

Counterpart of ``hetu_tpu/ps/run_server.py``: loads (building on first
use) the port's server library and runs its request loop. It is run as
a script, by path: ``python -m hetu_tpu_torch.ps.run_server`` would run
the package's ``__init__``, which imports torch, and a server needs
only :mod:`.native_lib` (the standard library and numpy), which the
script loads by its file path either way.

With ``HETU_PS_LISTEN_FD`` set it serves the socket
:func:`~.server.spawn_server` already claimed; ``HETU_PS_READY_FD`` is
the pipe on which it reports that its accept loop is about to run.

With ``HETU_TELEMETRY_PORT`` set (the launcher's ``--telemetry`` gives
each server one from ``HETU_TELEMETRY_BASE_PORT``), the process serves a
Prometheus text-format ``/metrics`` scrape on a daemon thread beside the
native request loop: uptime, identity (port, nworkers, pid) and RSS. The
registry is ``telemetry/metrics.py``, loaded by its path as
``native_lib.py`` is (neither imports torch).
"""
import importlib.util
import os
import sys

# by path: the script imports nothing of its package, whose __init__
# imports torch
_spec = importlib.util.spec_from_file_location(
    "hetu_ps_native_lib",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "native_lib.py"))
_native = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_native)
get_lib = _native.get_lib


def _load_metrics():
    """``telemetry/metrics.py`` by its path (no package ``__init__``)."""
    spec = importlib.util.spec_from_file_location(
        "hetu_ps_metrics",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "telemetry", "metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve_metrics(ps_port, nworkers):
    """The server's scrape on ``HETU_TELEMETRY_PORT`` (all interfaces:
    the scrape may come from another host), on the launcher's claim of
    it where it handed one (``HETU_TELEMETRY_LISTEN_FD``); None when
    the port is unset."""
    scrape_port = int(os.environ.get("HETU_TELEMETRY_PORT", "0"))
    if not scrape_port:
        return None
    metrics = _load_metrics()
    reg = metrics.MetricsRegistry()
    metrics.uptime_gauge(reg, "hetu_ps_server_uptime_seconds")
    reg.gauge("hetu_ps_server_port").set(ps_port)
    reg.gauge("hetu_ps_server_nworkers").set(nworkers)
    reg.gauge("hetu_ps_server_pid").set(os.getpid())

    def _rss_bytes():
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
        except (OSError, ValueError, IndexError):
            return 0

    reg.gauge("hetu_ps_server_rss_bytes", fn=_rss_bytes)
    fd = os.environ.get("HETU_TELEMETRY_LISTEN_FD")
    if fd is not None:
        import socket
        reg.serve(scrape_port, host="0.0.0.0",
                  sock=socket.socket(fileno=int(fd)))
    else:
        reg.serve(scrape_port, host="0.0.0.0")
    return reg


def _register_faulthandler(port):
    """SIGUSR1 -> all-thread stack dump, so a wedged server process is
    inspectable live (the launcher's watchdog collects server stacks
    too). Dumps land in the telemetry dir when the launcher exported
    one (``HETU_TELEMETRY``), stderr otherwise."""
    import faulthandler
    import signal
    try:
        tdir = os.environ.get("HETU_TELEMETRY")
        if tdir:
            os.makedirs(tdir, exist_ok=True)
            f = open(os.path.join(tdir, f"stacks_server{port}.log"), "a")
        else:
            f = sys.stderr
        faulthandler.register(signal.SIGUSR1, file=f, all_threads=True)
    except (ValueError, OSError, AttributeError):
        pass


def main():
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 18590
    nworkers = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    _register_faulthandler(port)
    try:
        _serve_metrics(port, nworkers)
    except OSError as e:
        # observability must never take down the data path: a scrape
        # port collision logs and the request loop starts anyway
        print(f"[hetu-ps] telemetry scrape disabled: {e}",
              file=sys.stderr)
    lfd = int(os.environ.get("HETU_PS_LISTEN_FD", "-1"))
    lib = get_lib()          # lazy native build: the slow failure mode
    # readiness: the parent pre-listened the port, so connectability
    # does not mean "serving" — one byte on the pipe does; a child that
    # dies earlier closes the pipe instead
    ready = int(os.environ.get("HETU_PS_READY_FD", "-1"))
    if ready >= 0:
        try:
            os.write(ready, b"1")
            os.close(ready)
        except OSError:
            pass
    if lfd >= 0:
        sys.exit(lib.hetu_ps_run_server_fd(lfd, port, nworkers))
    sys.exit(lib.hetu_ps_run_server(port, nworkers))


if __name__ == "__main__":
    main()
