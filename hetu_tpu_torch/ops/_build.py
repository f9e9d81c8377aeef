"""Build and load the port's CUDA kernels; count their launches.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. On
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``hetu_tpu_torch/_build/`` (listed in ``.gitignore``)
and loaded with ``ctypes`` — no PyTorch headers, no ``ninja``, so a
build takes seconds. The library name carries a hash of the source
and of every header (``csrc/*.cuh``) it may include, so an edited
kernel or header never loads a stale build.

:data:`launch_counts` is the per-process launch counter: every wrapper
adds one to its kernel's entry through :func:`count_launch` right after
a successful launch, and nowhere else, so a run can show that its main
path went through the kernels. The count stays exact when several
threads launch (a server's batcher threads). :data:`launch_shapes`
counts the same launches by ``(key, route, shape)`` where the wrapper
gives its shape, so a path that launches one kernel at several shapes
(a sequence-parallel ring's blocks) can tell them apart. Where the ranks
of a job are threads of one process, each thread names its rank
(:func:`set_rank`) and :data:`rank_launch_counts` counts its launches
apart as well.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "build_log", "load", "launch_counts", "launch_shapes",
           "rank_launch_counts", "set_rank", "count_launch",
           "reset_launch_counts", "check", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ["-O3", "-std=c++17",
              "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts = collections.Counter()
launch_shapes = collections.Counter()
rank_launch_counts = collections.defaultdict(collections.Counter)
_thread = threading.local()

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs = {}


def count_launch(key, route, shape=None):
    """One launch of kernel ``key`` on ``route``: counted under ``key``
    and ``f"{key}.{route}"``, and under ``(key, route, shape)`` in
    :data:`launch_shapes` when ``shape`` is given. A ``+=`` on the
    counter is a read and a write, so two threads could lose one without
    the lock."""
    rank = getattr(_thread, "rank", None)
    with _count_lock:
        launch_counts[key] += 1
        launch_counts[f"{key}.{route}"] += 1
        if shape is not None:
            launch_shapes[(key, route, tuple(shape))] += 1
        if rank is not None:
            rank_launch_counts[rank][key] += 1
            rank_launch_counts[rank][f"{key}.{route}"] += 1


def set_rank(rank):
    """Count this thread's launches under ``rank`` too (None: stop)."""
    _thread.rank = rank


def reset_launch_counts():
    with _count_lock:
        launch_counts.clear()
        launch_shapes.clear()
        rank_launch_counts.clear()


def _nvcc():
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _lib_path(name):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names):
    """Compile every kernel in ``names`` that has no current build, one
    ``nvcc`` process per source, all started together. Returns
    ``{name: seconds}`` for the sources compiled by this call (0.0 for
    up-to-date ones). Raises with nvcc's output on any failure; the
    compiler's report (registers, shared memory, spills) is kept in
    ``_build/<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        src, out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader never
        #                           sees a half-written library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name):
    """nvcc's output for the current build of ``name`` (ptxas's
    registers, shared memory and spills per kernel); "" if the library
    was not compiled in this build directory."""
    log = _lib_path(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name):
    """The loaded ``ctypes.CDLL`` of one kernel, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)[1]))
            lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.hetu_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib, name, rc):
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        msg = lib.hetu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"cudaError {rc} ({msg})")
