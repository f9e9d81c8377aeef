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
the pipe on which it reports that its accept loop is about to run. The
reference's Prometheus scrape of the server (``HETU_TELEMETRY_PORT``)
waits for the port's telemetry.
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


def _register_faulthandler():
    """SIGUSR1 -> all-thread stack dump on stderr, so a wedged server
    process is inspectable live."""
    import faulthandler
    import signal
    try:
        faulthandler.register(signal.SIGUSR1, file=sys.stderr,
                              all_threads=True)
    except (ValueError, OSError, AttributeError):
        pass


def main():
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 18590
    nworkers = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    _register_faulthandler()
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
