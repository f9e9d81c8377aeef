"""Worker-side PS client.

Counterpart of ``hetu_tpu/ps/client.py`` (reference parity:
KVWorker/PSAgent via python_binding.cc): the numpy-level API over the
C client in the port's own build of the server library
(:mod:`.native_lib`). Async ops (push, dd_pushpull, sparse_push) return
immediately; ``wait(tensor_id)`` blocks until that tensor's outstanding
requests complete. The library's sources are the JAX package's, so
this client and ``hetu_tpu``'s talk to either package's server.

The connection state lives in the loaded library, one per process: a
second :class:`PSClient` re-initializes it. Addresses come from
``HETU_PS_HOSTS`` / ``HETU_PS_PORTS`` (comma lists: one server per
entry) unless given.
"""
from __future__ import annotations

import os

import numpy as np

from .. import telemetry as _telemetry
from .native_lib import as_f32, as_i64, fptr, get_lib, lptr

__all__ = ["PSClient", "OPT_KIND", "get_default_client",
           "set_default_client", "close_default_client"]

_default_client = None


def _flight(kind, tid, nbytes):
    """Black-box record of one PS RPC (flight.py): an RPC that never
    returns — dead server, wedged van thread — is a pending entry
    naming the tensor id and byte count. The disabled path returns
    before the tag string is built — no per-RPC allocations with
    telemetry off."""
    tel = _telemetry.get_telemetry()
    if not tel.enabled:
        return None
    return tel.flight.start("ps", kind, tag=f"tid{tid}", nbytes=nbytes)


_flight_done = _telemetry.Telemetry.flight_complete


def _pull_span(nbytes):
    """``ps:pull`` trace span for one pull-family RPC. The
    ``overlapped`` attr marks pulls issued from the ingest worker
    (:mod:`hetu_tpu_torch.ingest`): speculative pulls riding under the
    device's in-flight work. Returns the shared null context when
    telemetry is off."""
    tel = _telemetry.get_telemetry()
    if not tel.enabled:
        return _telemetry._NULL_SPAN
    from ..ingest import on_worker
    return tel.span("ps:pull", bytes=int(nbytes), overlapped=on_worker())

# reference OptType mapping (ps/server/optimizer.h:15-22)
OPT_KIND = {"SGD": 0, "Momentum": 1, "Nesterov": 2, "AdaGrad": 3,
            "Adam": 4, "None": 5}


class PSClient:
    def __init__(self, hosts=None, ports=None, rank=0, nworkers=1):
        hosts = hosts or os.environ.get("HETU_PS_HOSTS", "127.0.0.1")
        ports = ports or os.environ.get("HETU_PS_PORTS", "18590")
        self.lib = get_lib()
        self.nservers = self.lib.PSInit(
            hosts.encode(), str(ports).encode(), rank, nworkers)
        self.nreplicas = int(self.lib.PSNumReplicas())
        self.rank = rank
        self.nworkers = nworkers
        self.servers_down = False
        self._closed = False
        # post-mortem breadcrumb: with the fleet size on the flight
        # dump, a pending RPC's tensor id maps to its server shard
        # (tid % nservers) and the replica set it waited on
        tel = _telemetry.get_telemetry()
        if tel.enabled and tel.flight is not None:
            tel.flight.meta["ps_nservers"] = int(self.nservers)
            tel.flight.meta["ps_nreplicas"] = self.nreplicas
        # fail fast on a dead fleet (async paths would otherwise drop
        # requests silently); with replication a dead primary is
        # survivable — any reachable replica of shard 0 counts
        import socket
        probes = [(hosts.split(",")[0], int(str(ports).split(",")[0]))]
        bhosts = os.environ.get("HETU_PS_BACKUP_HOSTS", "")
        bports = os.environ.get("HETU_PS_BACKUP_PORTS", "")
        if self.nreplicas > 1 and bhosts and bports:
            probes.append((bhosts.split(",")[0],
                           int(bports.split(",")[0])))
        err = None
        for host, port in probes:
            try:
                socket.create_connection((host, port), timeout=2).close()
                err = None
                break
            except OSError as e:
                err = e
        if err is not None:
            where = ", ".join(f"{h}:{p}" for h, p in probes)
            raise RuntimeError(
                f"no PS server reachable at any replica of shard 0 "
                f"({where}); start one with "
                f"hetu_tpu_torch.ps.server.ensure_server() or the heturun "
                f"launcher") from err

    # -- registration ---------------------------------------------------
    def init_tensor(self, tid, shape, kind=0, init=(0, 0.0, 0.0), seed=0,
                    opt="None", lrs=(0.1,)):
        length = int(shape[0]) if len(shape) > 1 else int(np.prod(shape))
        width = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        lrs = as_f32(np.asarray(lrs))
        rc = self.lib.InitTensor(
            tid, kind, length, width, int(init[0]), float(init[1]),
            float(init[2]), int(seed), OPT_KIND[opt], fptr(lrs), len(lrs))
        assert rc == 0, f"InitTensor({tid}) failed: {rc}"

    def set_param(self, tid, value):
        v = as_f32(value).ravel()
        rc = self.lib.SetParam(tid, fptr(v), v.size)
        assert rc == 0, f"SetParam({tid}) failed: {rc}"

    # -- dense ----------------------------------------------------------
    def pull(self, tid, shape):
        out = np.empty(int(np.prod(shape)), np.float32)
        rec = _flight("ps_pull", tid, out.nbytes)
        with _pull_span(out.nbytes):
            rc = self.lib.Pull(tid, fptr(out), out.size)
        _flight_done(rec)
        assert rc == 0, f"Pull({tid}) failed: {rc}"
        return out.reshape(shape)

    def push(self, tid, grad):
        g = as_f32(grad).ravel()
        rec = _flight("ps_push", tid, g.nbytes)
        self.lib.Push(tid, fptr(g), g.size)
        _flight_done(rec)

    def dd_pushpull(self, tid, grad, out=None):
        g = as_f32(grad).ravel()
        if out is None:
            out = np.empty_like(g)
        # the C call is async and keeps a raw pointer: the output buffer
        # must be the caller-visible contiguous memory, not a ravel() copy
        assert out.dtype == np.float32 and out.flags["C_CONTIGUOUS"], \
            "dd_pushpull needs a C-contiguous float32 output buffer"
        rec = _flight("ps_dd_pushpull", tid, g.nbytes)
        self.lib.DDPushPull(tid, fptr(g), fptr(out), g.size)
        _flight_done(rec)
        return out

    # -- sparse ---------------------------------------------------------
    def sparse_push(self, tid, indices, values, width):
        idx = as_i64(indices).ravel()
        vals = as_f32(values).reshape(idx.size, width)
        rec = _flight("ps_sparse_push", tid, vals.nbytes)
        self.lib.SparsePush(tid, lptr(idx), fptr(vals), idx.size, width)
        _flight_done(rec)

    def sparse_pull(self, tid, indices, width):
        idx = as_i64(indices).ravel()
        out = np.empty((idx.size, width), np.float32)
        rec = _flight("ps_sparse_pull", tid, out.nbytes)
        with _pull_span(out.nbytes):
            rc = self.lib.SparsePull(tid, lptr(idx), fptr(out), idx.size,
                                     width)
        _flight_done(rec)
        assert rc == 0, f"SparsePull({tid}) failed: {rc}"
        return out.reshape(tuple(np.shape(indices)) + (width,))

    def sd_pushpull(self, tid, indices, values, width, out_len):
        idx = as_i64(indices).ravel()
        vals = as_f32(values).reshape(idx.size, width)
        out = np.empty(out_len, np.float32)
        self.lib.SDPushPull(tid, lptr(idx), fptr(vals), idx.size,
                            fptr(out), out_len, width)
        return out

    def ss_pushpull(self, tid, push_idx, values, pull_idx, width):
        pidx = as_i64(push_idx).ravel()
        vals = as_f32(values).reshape(pidx.size, width)
        oidx = as_i64(pull_idx).ravel()
        out = np.empty((oidx.size, width), np.float32)
        self.lib.SSPushPull(tid, lptr(pidx), fptr(vals), pidx.size,
                            lptr(oidx), oidx.size, fptr(out), width)
        return out.reshape(tuple(np.shape(pull_idx)) + (width,))

    # -- bounded-staleness cache protocol -------------------------------
    def sync_embedding(self, tid, bound, indices, versions, out_rows,
                       width):
        """Refresh rows of ``out_rows`` whose server version is more than
        ``bound`` ahead of ``versions``; updates versions in place.
        Returns refreshed-row count (cache miss-rate numerator)."""
        idx = as_i64(indices).ravel()
        ver = as_i64(versions).ravel()
        rec = _flight("ps_sync_embedding", tid, idx.size * 4 * width)
        with _pull_span(idx.size * 4 * width):
            n = self.lib.SyncEmbedding(tid, int(bound), lptr(idx),
                                       lptr(ver), idx.size, fptr(out_rows),
                                       width)
        _flight_done(rec)
        versions[...] = ver.reshape(np.shape(versions))
        return n

    def push_embedding(self, tid, indices, values, updates, width):
        idx = as_i64(indices).ravel()
        vals = as_f32(values).reshape(idx.size, width)
        upd = as_i64(updates).ravel()
        rec = _flight("ps_push_embedding", tid, vals.nbytes)
        self.lib.PushEmbedding(tid, lptr(idx), fptr(vals), lptr(upd),
                               idx.size, width)
        _flight_done(rec)

    def push_sync_embedding(self, tid, push_idx, values, updates, bound,
                            sync_idx, versions, out_rows, width):
        """Combined PushEmbedding + SyncEmbedding in one round trip per
        shard (kPushSyncEmbedding): applies the dirty-row push and
        refreshes rows of ``out_rows`` whose server version is more than
        ``bound`` ahead of ``versions`` — halving the cache's
        drain+refresh round trips. Updates versions in place; returns
        refreshed-row count."""
        pidx = as_i64(push_idx).ravel()
        vals = as_f32(values).reshape(pidx.size, width)
        upd = as_i64(updates).ravel()
        sidx = as_i64(sync_idx).ravel()
        ver = as_i64(versions).ravel()
        rec = _flight("ps_push_sync_embedding", tid,
                      vals.nbytes + sidx.size * 4 * width)
        with _pull_span(sidx.size * 4 * width):
            n = self.lib.PushSyncEmbedding(
                tid, int(bound), lptr(pidx), fptr(vals), lptr(upd),
                pidx.size, lptr(sidx), lptr(ver), sidx.size,
                fptr(out_rows), width)
        _flight_done(rec)
        versions[...] = ver.reshape(np.shape(versions))
        return n

    # -- tiered / quantized row storage ---------------------------------
    def store_config(self, tid, dtype="f32", dram_rows=-1,
                     spill_dir=None, hot_ids=()):
        """Convert table ``tid`` to tiered row storage: a bounded DRAM
        pool (``dram_rows`` resident rows per shard, <0 = all) over an
        mmap'd disk spill file, rows quantized as ``dtype`` ("f32" |
        "f16" | "int8"; per-row scale, dequant-on-pull). ``hot_ids``
        (measured hot keys) are pre-warmed into DRAM."""
        dt = {"f32": 0, "f16": 1, "int8": 2}[dtype]
        spill_dir = spill_dir or os.environ.get("HETU_PS_STORE_DIR",
                                                "/tmp")
        hot = as_i64(np.asarray(hot_ids, dtype=np.int64).ravel())
        rc = self.lib.StoreConfig(tid, dt, int(dram_rows),
                                  str(spill_dir).encode(), lptr(hot),
                                  hot.size)
        assert rc == 0, f"StoreConfig({tid}) failed: {rc}"

    def store_stats(self, tid):
        """Tiered-store counters summed across the table's shards;
        ``repl_queue`` is the summed replication-forward backlog (0 on
        unreplicated fleets — the fleet gauges read it live)."""
        out = np.zeros(6, np.int64)
        rc = self.lib.StoreStats(tid, lptr(out), out.size)
        assert rc == 0, f"StoreStats({tid}) failed: {rc}"
        return {"dram_hits": int(out[0]), "spill_hits": int(out[1]),
                "spill_writes": int(out[2]), "dram_rows": int(out[3]),
                "row_bytes": int(out[4]), "repl_queue": int(out[5])}

    # -- control --------------------------------------------------------
    def wait(self, tid):
        rec = _flight("ps_wait", tid, 0)
        self.lib.Wait(tid)
        _flight_done(rec)

    def wait_all(self):
        rec = _flight("ps_wait_all", -1, 0)
        self.lib.WaitAll()
        _flight_done(rec)

    def barrier(self):
        # the BSP barrier is the canonical distributed hang site: a
        # worker that died mid-step leaves everyone else pending here
        rec = _flight("ps_barrier", -1, 0)
        self.lib.BarrierWorker()
        _flight_done(rec)

    def clear(self, tid):
        return self.lib.Clear(tid)

    def save_param(self, tid, path):
        return self.lib.SaveParam(tid, str(path).encode())

    def load_param(self, tid, path):
        return self.lib.LoadParam(tid, str(path).encode())

    def push_data(self, key, values):
        v = as_f32(values).ravel()
        return self.lib.PushData(int(key), fptr(v), v.size)

    def pull_data(self, key, n):
        out = np.empty(int(n), np.float32)
        rc = self.lib.PullData(int(key), fptr(out), out.size)
        assert rc == 0, f"PullData({key}) failed: {rc}"
        return out

    def get_loads(self):
        return int(self.lib.GetLoads())

    def shutdown_servers(self):
        # idempotent + failover-aware: repeated teardown (fixture
        # finalizers, atexit, error paths) must be a no-op, and a dead
        # primary must not keep the surviving replica set from being
        # notified — the C sweep sends every replica one bounded
        # attempt instead of burning the retry budget on a dead socket
        if self.servers_down:
            return
        # late drains must fail fast, not burn the reconnect/retry
        # budget against servers we just stopped (PSRuntime.drain checks)
        self.servers_down = True
        self.lib.ShutdownServers()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.lib.PSFinalize()


def get_default_client():
    global _default_client
    if _default_client is None:
        rank = int(os.environ.get("HETU_PS_RANK", "0"))
        nworkers = int(os.environ.get("HETU_PS_NWORKERS", "1"))
        _default_client = PSClient(rank=rank, nworkers=nworkers)
    return _default_client


def set_default_client(client):
    global _default_client
    _default_client = client


def close_default_client():
    global _default_client
    if _default_client is not None:
        _default_client.close()
        _default_client = None
