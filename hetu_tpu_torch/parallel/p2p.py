"""Host-mediated pipeline boundary transport between worker processes.

Counterpart of ``hetu_tpu/parallel/p2p.py`` (reference parity:
PipelineSend/PipelineReceive over NCCL p2p, gpu_ops/PipelineSend.py).
When pipeline stages span worker processes, a boundary tensor crosses
a direct TCP channel between the owning processes, carried as a host
buffer. Not NCCL: several worker processes may share one card, and
NCCL refuses two ranks on one device, so nothing here calls a
``torch.distributed`` collective.

Addressing: rank k listens on ``HETU_PIPE_HOSTS[k] : HETU_PIPE_BASE_PORT
+ k`` (the launcher exports both; the defaults cover one machine). On one
host the launcher claims the ports and hands rank k its listening socket
(``HETU_PIPE_LISTEN_FD``), so no other process can take it first.
Messages are tagged; ``recv(tag)`` blocks until a matching message
arrives, so the pipeline's data dependencies are the cross-process
schedule — no separate barrier.

Wire: a header (magic, tag length, dtype-name length, payload bytes),
the tag, the dtype's name (``float32``, ``bfloat16``, ``int64``, ...),
the rank and the dims, then the payload's raw bytes. numpy has no
bfloat16, so a tensor crosses as its bytes under its torch dtype's
name and comes back as that dtype. A CUDA tensor is staged through a
pinned host buffer of the channel's (one copy, then the socket reads
from it); ``recv`` returns a CPU tensor, which the caller moves.

Flow control: the inbox is bounded at ``HETU_PIPE_MAX_BUF_MB`` (default
256). While it is full and the consumer is neither in ``recv`` nor in
``send``, reader threads stop draining their sockets, so TCP's window
pushes back on the sender instead of host memory growing. Payloads go
out in 4 MB chunks from the tensor's own buffer.

``stats()`` counts what crossed: messages and bytes each way, seconds
spent sending and seconds a ``recv`` waited.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from collections import deque

import torch

from .. import telemetry as _telemetry

__all__ = ["PipeChannel", "get_channel"]

_MAGIC = 0x48503250  # "HP2P"
_HDR = struct.Struct("<IHHQ")  # magic, taglen, dtypelen, payload bytes
_CHUNK = 4 << 20


def _dtype_name(dtype):
    return str(dtype).split(".")[-1]


class PipeChannel:
    """Tagged tensor messages between the worker processes of one job.
    Each rank's host comes from ``HETU_PIPE_HOSTS``; ``base_port`` and
    ``max_buffered_mb`` default to ``HETU_PIPE_BASE_PORT`` and
    ``HETU_PIPE_MAX_BUF_MB``."""

    def __init__(self, rank, nprocs, base_port=None, max_buffered_mb=None,
                 listen_fd=None):
        self.rank = rank
        self.nprocs = nprocs
        hosts = os.environ.get(
            "HETU_PIPE_HOSTS", ",".join(["127.0.0.1"] * nprocs)).split(",")
        if base_port is None:
            base_port = int(os.environ.get("HETU_PIPE_BASE_PORT", "19500"))
        self.addrs = [(hosts[i % len(hosts)], base_port + i)
                      for i in range(nprocs)]
        if max_buffered_mb is None:
            max_buffered_mb = int(os.environ.get("HETU_PIPE_MAX_BUF_MB",
                                                 "256"))
        self.max_buffered = int(max_buffered_mb) << 20
        self._inbox = {}          # tag -> deque of tensors
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._buffered = 0        # inbox bytes (flow-control accounting)
        self._wanted = set()      # tags a recv() is blocked on
        self._sending = 0         # sends in flight (see _conn_loop)
        self._out = {}            # dst rank -> (socket, send lock)
        self._out_mu = threading.Lock()   # guards the map only
        self._staging = {}        # nbytes -> pinned host buffer
        self._staging_mu = threading.Lock()
        self._closing = False
        self.reset_stats()
        if listen_fd is not None:
            # the launcher's claim of this rank's port, already listening
            self._listener = socket.socket(fileno=listen_fd)
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(("0.0.0.0", self.addrs[rank][1]))
            self._listener.listen(8)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- accounting ------------------------------------------------------
    def reset_stats(self):
        self._stats = {"sent_messages": 0, "sent_bytes": 0, "send_s": 0.0,
                       "recv_messages": 0, "recv_bytes": 0,
                       "recv_wait_s": 0.0}

    def stats(self):
        """Messages and bytes sent and received since the last
        ``reset_stats``, seconds in ``send`` and seconds ``recv``
        waited."""
        return dict(self._stats)

    # -- receive side ----------------------------------------------------
    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    @staticmethod
    def _read_into(conn, view):
        got, n = 0, len(view)
        while got < n:
            r = conn.recv_into(view[got:], n - got)
            if r == 0:
                return False
            got += r
        return True

    def _read(self, conn, n):
        buf = bytearray(n)
        return buf if self._read_into(conn, memoryview(buf)) else None

    def _conn_loop(self, conn):
        with conn:
            while True:
                hdr = self._read(conn, _HDR.size)
                if hdr is None:
                    return
                magic, taglen, dtlen, nbytes = _HDR.unpack(hdr)
                if magic != _MAGIC:
                    return
                meta = self._read(conn, taglen + dtlen + 4)
                if meta is None:
                    return
                tag = meta[:taglen].decode()
                dtype = getattr(torch, meta[taglen:taglen + dtlen].decode())
                ndim = struct.unpack_from("<i", meta, taglen + dtlen)[0]
                dims = self._read(conn, 8 * ndim) if ndim else b""
                if dims is None:
                    return
                shape = struct.unpack(f"<{ndim}q", dims) if ndim else ()
                body = torch.empty(nbytes, dtype=torch.uint8)
                if nbytes and not self._read_into(
                        conn, memoryview(body.numpy())):
                    return
                value = body.view(dtype).reshape(shape)
                with self._cv:
                    # backpressure: hold this reader (and through its
                    # unread bytes, its sender) while the consumer lags —
                    # neither in recv() nor in send(). While it is in
                    # either, always admit: the message a blocked recv
                    # wants may sit behind any other, and a consumer
                    # blocked in send() (the peer's inbox full) with its
                    # own inbox at the cap would deadlock both ranks of a
                    # bidirectional pipeline. So the cap bounds memory in
                    # the runaway case: the producer far ahead of a
                    # consumer that is busy computing.
                    self._cv.wait_for(
                        lambda: self._buffered < self.max_buffered
                        or self._wanted or self._sending
                        or self._closing)
                    if self._closing:
                        return
                    self._inbox.setdefault(tag, deque()).append(value)
                    self._buffered += nbytes
                    self._cv.notify_all()

    def recv(self, tag, timeout=None):
        """Block until a message tagged ``tag`` arrives (FIFO per tag)
        and return it as a CPU tensor. ``timeout`` defaults to
        ``HETU_PIPE_TIMEOUT_S`` (600 s: the peer may be building its
        kernels on its first step); past it, ``TimeoutError``. With
        telemetry on, the wait is a ``p2p_recv`` span with the payload's
        bytes, and a flight record: a recv that never completes names
        its tag (and, in a 2-process job, its peer) in the black box."""
        tel = _telemetry.get_telemetry()
        if not tel.enabled:
            return self._recv(tag, timeout)
        frec = tel.flight_start("p2p", "p2p_recv",
                                peer=self._peer_of_tag(tag), tag=tag)
        t0 = tel.clock()
        value = self._recv(tag, timeout)
        t1 = tel.clock()
        tel.flight_complete(frec)
        nbytes = value.numel() * value.element_size()
        tel.complete("p2p_recv", t0, t1, {"tag": tag, "bytes": nbytes})
        tel.inc("p2p_recv_bytes", nbytes)
        tel.observe("p2p_recv_wait_ms", (t1 - t0) / 1e6)
        return value

    def _peer_of_tag(self, tag):
        """Best-effort peer rank for a recv: in a 2-process job the
        sender is unambiguous; beyond that the tag is the diagnostic."""
        if self.nprocs == 2:
            return 1 - self.rank
        return None

    def _recv(self, tag, timeout=None):
        if timeout is None:
            timeout = float(os.environ.get("HETU_PIPE_TIMEOUT_S", "600"))
        t0 = time.perf_counter()
        with self._cv:
            self._wanted.add(tag)
            self._cv.notify_all()   # readers holding this tag may admit
            try:
                ok = self._cv.wait_for(lambda: self._inbox.get(tag),
                                       timeout=timeout)
            finally:
                self._wanted.discard(tag)
            if not ok:
                raise TimeoutError(f"pipeline recv timed out waiting for "
                                   f"{tag!r} on rank {self.rank}")
            q = self._inbox[tag]
            value = q.popleft()
            if not q:
                del self._inbox[tag]    # tags are step-unique: no leak
            nbytes = value.numel() * value.element_size()
            self._buffered -= nbytes
            self._cv.notify_all()       # wake readers held by backpressure
            st = self._stats
            st["recv_messages"] += 1
            st["recv_bytes"] += nbytes
            st["recv_wait_s"] += time.perf_counter() - t0
        return value

    # -- send side -------------------------------------------------------
    def _conn_to(self, dst):
        """(socket, per-destination send lock) for ``dst``. The connect
        retries outside the map's lock: a peer still starting must not
        stall sends to every other rank."""
        with self._out_mu:
            ent = self._out.get(dst)
        if ent is not None:
            return ent
        host, port = self.addrs[dst]
        t0 = time.time()
        while True:
            try:
                s = socket.create_connection((host, port), timeout=5)
                break
            except OSError:
                if time.time() - t0 > 60.0:
                    raise
                time.sleep(0.1)
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        drop = None
        with self._out_mu:
            ent = self._out.get(dst)
            if ent is not None or self._closing:
                # two senders raced the first connect (keep the mapped
                # socket: its peer may have bytes from it), or close()
                # already emptied the map
                drop = s
            else:
                ent = self._out[dst] = (s, threading.Lock())
        if drop is not None:
            drop.close()
        if ent is None:
            raise OSError("PipeChannel is closed")
        return ent

    def _host_bytes(self, value):
        """(uint8 host tensor of ``value``'s bytes, release callback):
        a CPU tensor's own bytes, a CUDA tensor's through the channel's
        pinned staging buffer of that size (held until released)."""
        flat = value.detach().contiguous().reshape(-1)
        if flat.device.type == "cpu":
            return flat.view(torch.uint8), None
        nbytes = flat.numel() * flat.element_size()
        self._staging_mu.acquire()
        buf = self._staging.get(nbytes)
        if buf is None:
            buf = self._staging[nbytes] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=True)
        buf.copy_(flat.view(torch.uint8), non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        return buf, self._staging_mu.release

    def send(self, dst, tag, value):
        """Send tensor ``value`` to rank ``dst`` under ``tag``. Returns
        when its bytes are in the kernel's socket buffer. With telemetry
        on: a ``p2p_send`` span, a flight record and ``p2p_send_bytes``."""
        tel = _telemetry.get_telemetry()
        if not tel.enabled:
            return self._send(dst, tag, value)
        nbytes = value.numel() * value.element_size()
        frec = tel.flight_start("p2p", "p2p_send", peer=dst, tag=tag,
                                nbytes=nbytes)
        with tel.span("p2p_send", tag=tag, dst=dst, bytes=nbytes):
            self._send(dst, tag, value)
        tel.flight_complete(frec)
        tel.inc("p2p_send_bytes", nbytes)

    def _send(self, dst, tag, value):
        t0 = time.perf_counter()
        body, release = self._host_bytes(value)
        try:
            tb = tag.encode()
            db = _dtype_name(value.dtype).encode()
            shape = tuple(value.shape)
            nbytes = body.numel()
            hdr = (_HDR.pack(_MAGIC, len(tb), len(db), nbytes) + tb + db
                   + struct.pack("<i", len(shape))
                   + struct.pack(f"<{len(shape)}q", *shape))
            view = memoryview(body.numpy())
            s, send_lk = self._conn_to(dst)
            with self._cv:
                self._sending += 1
                self._cv.notify_all()   # readers may admit while we send
            try:
                # frames on one socket must not interleave; a large
                # tensor to one rank must not hold sends to the others
                with send_lk:
                    s.sendall(hdr)
                    for off in range(0, nbytes, _CHUNK):
                        s.sendall(view[off:off + _CHUNK])
            finally:
                with self._cv:
                    self._sending -= 1
        finally:
            if release is not None:
                release()
        st = self._stats
        st["sent_messages"] += 1
        st["sent_bytes"] += nbytes
        st["send_s"] += time.perf_counter() - t0

    def close(self):
        self._closing = True
        with self._cv:
            self._cv.notify_all()   # release readers held by backpressure
        try:
            self._listener.close()
        except OSError:
            pass
        with self._out_mu:
            for s, _lk in self._out.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._out.clear()


_channel = None
_channel_mu = threading.Lock()


def get_channel():
    """The process's channel, built from the launcher's environment
    (``HETU_PROC_ID``, ``HETU_NUM_PROCS``, the ``HETU_PIPE_*`` addresses)
    on first use, listening on the socket the launcher claimed for it
    where it handed one (``HETU_PIPE_LISTEN_FD``, taken once)."""
    global _channel
    if _channel is None:
        with _channel_mu:
            if _channel is None:
                fd = os.environ.pop("HETU_PIPE_LISTEN_FD", None)
                _channel = PipeChannel(
                    int(os.environ.get("HETU_PROC_ID", "0")),
                    int(os.environ.get("HETU_NUM_PROCS", "1")),
                    listen_fd=None if fd is None else int(fd))
    return _channel

