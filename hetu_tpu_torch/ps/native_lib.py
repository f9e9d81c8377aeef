"""ctypes binding to the parameter server's shared library.

Counterpart of ``hetu_tpu/ps/native_lib.py`` (reference parity:
python/hetu/_base.py loading the C runtime): the same argtypes over
the same C ABI. The library is built on first use from ``native/``
by its Makefile (``g++ -O2 -std=c++17 -fPIC -fopenmp -pthread``, the
four sources in parallel, linked against ``libgomp.so.1`` by name; and
``-fno-gnu-unique``, so this library and the JAX package's, loaded in
one process, keep separate client states) into
``hetu_tpu_torch/_build/`` — never into the source directory — under a
name that carries a hash of the sources, so an edited source never
loads a stale build. The build writes a temporary name and renames it
into place: test workers and the server subprocess may all trigger it
at once, and a loader never sees a half-written library.

A failed build raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["get_lib", "build_lib", "lib_path", "as_f32", "as_i64", "fptr",
           "lptr"]

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("ps_common.h", "ps_server.cc", "ps_client.cc", "ps_cache.cc",
           "ps_store.cc", "ps_store.h", "Makefile")

_lib = None
_lock = threading.Lock()


def lib_path():
    """``_build/libhetu_ps_<hash>.so`` for the current sources."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libhetu_ps_{digest.hexdigest()[:12]}.so"


def build_lib():
    """Build the library unless the current sources' build exists;
    returns its path."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one compiler at a time across processes: the others wait on the
    # lock and then find the library (the rename stays the guarantee)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp.so")
        proc = subprocess.run(["make", "-s", "-j4", "-C", str(NATIVE_DIR),
                               f"OUT={tmp}"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the parameter server library failed (make "
                f"exited {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_lib()))

        i64 = ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        lp = ctypes.POINTER(ctypes.c_int64)

        lib.PSInit.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int, ctypes.c_int]
        lib.PSInit.restype = ctypes.c_int
        lib.PSRank.argtypes = []
        lib.PSRank.restype = ctypes.c_int
        lib.PSNumWorkers.argtypes = []
        lib.PSNumWorkers.restype = ctypes.c_int
        lib.PSFinalize.argtypes = []
        lib.InitTensor.argtypes = [ctypes.c_int, ctypes.c_int, i64, i64,
                                   ctypes.c_int, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_uint64,
                                   ctypes.c_int, fp, ctypes.c_int]
        lib.InitTensor.restype = ctypes.c_int
        lib.Pull.argtypes = [ctypes.c_int, fp, i64]
        lib.Pull.restype = ctypes.c_int
        lib.Push.argtypes = [ctypes.c_int, fp, i64]
        lib.DDPushPull.argtypes = [ctypes.c_int, fp, fp, i64]
        lib.SparsePush.argtypes = [ctypes.c_int, lp, fp, i64, i64]
        lib.SparsePull.argtypes = [ctypes.c_int, lp, fp, i64, i64]
        lib.SparsePull.restype = ctypes.c_int
        lib.SDPushPull.argtypes = [ctypes.c_int, lp, fp, i64, fp, i64, i64]
        lib.SSPushPull.argtypes = [ctypes.c_int, lp, fp, i64, lp, i64, fp,
                                   i64]
        lib.SyncEmbedding.argtypes = [ctypes.c_int, i64, lp, lp, i64, fp,
                                      i64]
        lib.SyncEmbedding.restype = ctypes.c_int
        lib.PushEmbedding.argtypes = [ctypes.c_int, lp, fp, lp, i64, i64]
        lib.PushSyncEmbedding.argtypes = [ctypes.c_int, i64, lp, fp, lp,
                                          i64, lp, lp, i64, fp, i64]
        lib.PushSyncEmbedding.restype = ctypes.c_int
        lib.StoreConfig.argtypes = [ctypes.c_int, ctypes.c_int, i64,
                                    ctypes.c_char_p, lp, i64]
        lib.StoreConfig.restype = ctypes.c_int
        lib.StoreStats.argtypes = [ctypes.c_int, lp, i64]
        lib.StoreStats.restype = ctypes.c_int
        lib.PSNumReplicas.argtypes = []
        lib.PSNumReplicas.restype = ctypes.c_int
        lib.Wait.argtypes = [ctypes.c_int]
        lib.WaitAll.argtypes = []
        lib.BarrierWorker.argtypes = []
        lib.SetParam.argtypes = [ctypes.c_int, fp, i64]
        lib.SetParam.restype = ctypes.c_int
        lib.Clear.argtypes = [ctypes.c_int]
        lib.Clear.restype = ctypes.c_int
        lib.SaveParam.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.SaveParam.restype = ctypes.c_int
        lib.LoadParam.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.LoadParam.restype = ctypes.c_int
        lib.PushData.argtypes = [i64, fp, i64]
        lib.PushData.restype = ctypes.c_int
        lib.PullData.argtypes = [i64, fp, i64]
        lib.PullData.restype = ctypes.c_int
        lib.GetLoads.argtypes = []
        lib.GetLoads.restype = ctypes.c_uint64
        lib.ShutdownServers.argtypes = []
        lib.hetu_ps_run_server.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.hetu_ps_run_server.restype = ctypes.c_int
        lib.hetu_ps_run_server_fd.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int]
        lib.hetu_ps_run_server_fd.restype = ctypes.c_int

        # the host embedding cache (ps_cache.cc, cstable.py)
        lib.CacheCreate.argtypes = [ctypes.c_int, i64, i64, ctypes.c_int,
                                    i64, i64]
        lib.CacheCreate.restype = ctypes.c_int
        lib.CacheDestroy.argtypes = [ctypes.c_int]
        lib.CacheLookup.argtypes = [ctypes.c_int, lp, i64, fp]
        lib.CacheUpdate.argtypes = [ctypes.c_int, lp, fp, i64]
        lib.CacheFlush.argtypes = [ctypes.c_int]
        lib.CachePerf.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.CachePerf.restype = ctypes.c_uint64

        _lib = lib
        return lib


def as_f32(arr):
    return np.ascontiguousarray(arr, dtype=np.float32)


def as_i64(arr):
    return np.ascontiguousarray(arr, dtype=np.int64)


def fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def lptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
