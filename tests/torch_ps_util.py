"""Parameter servers for the PS parity tests: one server of each package
on localhost, each package's client connected to its own, and both
packages' default clients set. The two server libraries are separate
builds loaded RTLD_LOCAL, so the two clients' connection states do not
meet; the tests pass addresses explicitly instead of through
``HETU_PS_PORTS``."""
import contextlib

import hetu_tpu.ps.client as jclient
import hetu_tpu.ps.native_lib as jnative
import hetu_tpu.ps.server as jserver
import hetu_tpu_torch.ps.client as tclient
import hetu_tpu_torch.ps.server as tserver


@contextlib.contextmanager
def jax_server(nservers=1):
    """``nservers`` hetu_tpu servers and a hetu_tpu client on them."""
    jnative.build_lib()     # before the child: it builds on first use
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


@contextlib.contextmanager
def torch_server(nservers=1):
    """``nservers`` servers of the port and the port's client on them."""
    ports = [tserver.pick_free_port() for _ in range(nservers)]
    try:
        for port in ports:
            tserver.ensure_server(port=port, nworkers=1, wait_s=60)
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
