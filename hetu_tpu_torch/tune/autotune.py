"""Generic autotuner: sweep-once, cache-forever config selection.

Counterpart of ``hetu_tpu/tune/autotune.py``. ``autotune(name, key,
candidates, measure)`` sweeps ``candidates`` through the caller's
``measure`` on the first lookup of a given (platform, name, key),
records the winner in an in-process table backed by a persistent JSON
file, and returns the cached winner on every later lookup (including
later processes). The engine carries nothing kernel-specific: the
auto-planner's measured refinement (:mod:`..parallel.autoplan`) is its
consumer here; the flash-attention block sweep (K5) waits for ROADMAP
item 13.

Environment:

* ``HETU_AUTOTUNE`` — ``0`` disables tuning entirely (callers keep
  their static defaults), ``1`` is use-cache-only (a miss returns the
  default with NO sweep — deterministic CI runs), ``force`` re-sweeps
  even on a cache hit; unset/``auto`` sweeps on miss, hits otherwise.
* ``HETU_AUTOTUNE_CACHE`` — cache file (or directory, file named
  ``autotune.json`` inside); default ``~/.cache/hetu_tpu/autotune.json``.

Keys start with :func:`platform_tag`: ``cpu`` for work on CPU tensors,
``cuda-<card name>`` on a card, so an entry measured on one is never
served to the other. The JAX package sweeps on a thread of its own
because JAX traces on the caller's; here ``measure`` runs on the
caller's thread. One sweep a key at a time (single-flight): thread
ranks of one process that look a key up together wait for the first.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["AutotuneTable", "autotune", "get_table", "configure",
           "reset", "tuning_mode", "default_cache_path", "platform_tag",
           "platform_scope", "timeit"]

_MODE_ENV = "HETU_AUTOTUNE"
_CACHE_ENV = "HETU_AUTOTUNE_CACHE"
_VERSION = 1


def tuning_mode():
    """'off' | 'cache' | 'force' | 'auto' from ``HETU_AUTOTUNE``."""
    raw = os.environ.get(_MODE_ENV, "").strip().lower()
    if raw in ("0", "off", "false", "no"):
        return "off"
    if raw in ("1", "cache"):
        return "cache"
    if raw == "force":
        return "force"
    return "auto"


def default_cache_path():
    p = os.environ.get(_CACHE_ENV)
    if not p:
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "hetu_tpu", "autotune.json")
    p = os.path.expanduser(p)
    if p.endswith(".json"):
        return p
    return os.path.join(p, "autotune.json")


def _sanitize(text):
    return "".join(c if c.isalnum() else "_"
                   for c in str(text).strip().lower()) or "unknown"


_TAGS = {}                      # device index -> tag (memo)
_scope = threading.local()


def _device_tag(device):
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    tag = _TAGS.get(index)
    if tag is None:
        tag = "cuda-" + _sanitize(torch.cuda.get_device_name(index))
        _TAGS[index] = tag      # racing writers store the same value
    return tag


# the partition of a card that is not named: asking a card for its name
# initializes CUDA, which a preflight must not do (analysis.analyze)
UNNAMED_CARD = "cuda-unnamed"


def platform_tag(device=None):
    """Cache partition for where the work runs: ``cpu`` for CPU tensors,
    ``cuda-<card name>`` for a card. ``device`` names it; else the
    innermost :func:`platform_scope` of this thread; else the card when
    CUDA is there, the CPU otherwise."""
    if device is None:
        tag = getattr(_scope, "tag", None)
        if tag is not None:
            return tag
        device = getattr(_scope, "device", None)
    if device is None:
        import torch
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return _device_tag(device)


@contextlib.contextmanager
def platform_scope(device=None, tag=None):
    """Key this thread's lookups (and CostDB entries) by ``device``'s
    platform for the duration, or by the partition ``tag`` itself (which
    asks no device for its name); ``None`` for both leaves the current
    one."""
    prev = (getattr(_scope, "device", None), getattr(_scope, "tag", None))
    if tag is not None:
        _scope.device, _scope.tag = None, tag
    elif device is not None:
        _scope.device, _scope.tag = device, None
    try:
        yield
    finally:
        _scope.device, _scope.tag = prev


def _key_string(name, key):
    parts = [platform_tag(), str(name)]
    if isinstance(key, (tuple, list)):
        parts += [str(k) for k in key]
    else:
        parts.append(str(key))
    return "|".join(parts)


def _freeze(cfg):
    """JSON round-trips tuples as lists; hand configs back frozen so a
    cache hit and a fresh sweep return the same type."""
    if isinstance(cfg, list):
        return tuple(_freeze(c) for c in cfg)
    return cfg


def timeit(run, sync=None, reps=3, windows=2):
    """Seconds per ``run()`` call: one warmup, then the best of
    ``windows`` timed windows of ``reps`` back-to-back calls, each
    window ended by ``sync(out)`` (a readback or a
    ``torch.cuda.synchronize``: the card runs asynchronously)."""
    out = run()
    if sync is not None:
        sync(out)
    best = float("inf")
    for _ in range(max(1, windows)):
        t0 = time.perf_counter()
        for _ in range(max(1, reps)):
            out = run()
        if sync is not None:
            sync(out)
        best = min(best, (time.perf_counter() - t0) / max(1, reps))
    return best


class AutotuneTable:
    """In-process config table backed by one JSON cache file.

    ``mode=None`` re-reads ``HETU_AUTOTUNE`` at every lookup, so tests
    and CLI runs can flip the env without rebuilding the table.
    """

    def __init__(self, path=None, mode=None):
        self.path = default_cache_path() if path is None else \
            os.fspath(path)
        self._mode = mode
        self._entries = None            # lazy: {key_str: entry dict}
        self._lock = threading.RLock()
        self._inflight = {}             # key_str -> Event (sweep runs)

    # -- persistence -----------------------------------------------------
    def _load(self):
        if self._entries is not None:
            return self._entries
        entries = {}
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and doc.get("version") == _VERSION:
                entries = dict(doc.get("entries") or {})
        except (OSError, ValueError):
            pass                        # cold or corrupt cache: resweep
        self._entries = entries
        return entries

    def save(self):
        """Atomic write (temp + rename): a concurrently-reading process
        sees the old file or the new one, never a torn write. Merges
        with whatever is on disk first (our entries win) so two
        processes tuning different keys against one cache file don't
        drop each other's winners — the read-merge-write runs under an
        advisory flock on a sidecar .lock file so two ranks saving
        simultaneously serialize instead of racing the re-read
        (best-effort: platforms without fcntl fall back to the atomic
        rename alone, where a lost entry just re-sweeps next run)."""
        with self._lock:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            lf = None
            try:
                try:
                    import fcntl
                    lf = open(self.path + ".lock", "w")
                    fcntl.flock(lf, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    pass
                entries = self._load()
                try:
                    with open(self.path) as f:
                        doc = json.load(f)
                    if isinstance(doc, dict) and \
                            doc.get("version") == _VERSION:
                        disk = dict(doc.get("entries") or {})
                        disk.update(entries)
                        self._entries = entries = disk
                except (OSError, ValueError):
                    pass
                tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"version": _VERSION, "entries": entries},
                              f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            finally:
                if lf is not None:
                    lf.close()      # closing releases the flock

    # -- table access ----------------------------------------------------
    def get(self, name, key):
        with self._lock:
            ent = self._load().get(_key_string(name, key))
        return _freeze(ent["config"]) if ent else None

    def put(self, name, key, config, picked_ms=None, candidates_ms=None):
        """Record a config directly (tests, offline tuning runs)."""
        ent = {"config": list(config) if isinstance(config, tuple)
               else config, "ts": time.time()}
        if picked_ms is not None:
            ent["picked_ms"] = round(float(picked_ms), 4)
        if candidates_ms is not None:
            ent["candidates_ms"] = candidates_ms
        with self._lock:
            self._load()[_key_string(name, key)] = ent
            self.save()

    # -- the engine ------------------------------------------------------
    def lookup(self, name, key, candidates, measure, default=None):
        """The cached winner for (platform, name, key), sweeping
        ``candidates`` through ``measure(config) -> seconds`` when the
        mode calls for it. ``default`` is returned when tuning is off,
        on a use-cache-only miss, or when every candidate fails."""
        mode = self._mode or tuning_mode()
        if mode == "off" or not candidates:
            return default
        ks = _key_string(name, key)
        # cache check and in-flight registration share ONE locked
        # section: checking in one section and claiming ownership in a
        # later one would let a thread that missed just before the
        # previous owner persisted re-run the whole sweep
        wait_ev = ev = None
        with self._lock:
            if mode != "force":
                ent = self._load().get(ks)
                if ent is not None:
                    return _freeze(ent["config"])
            if mode != "cache":
                ev = self._inflight.get(ks)
                if ev is None:
                    self._inflight[ks] = ev = threading.Event()
                else:
                    wait_ev, ev = ev, None
        if mode == "cache":
            return default
        if wait_ev is not None:
            # single-flight per key: a second thread looking up the same
            # key waits for the running sweep instead of duplicating it
            wait_ev.wait(timeout=600.0)
            with self._lock:
                ent = self._load().get(ks)
            if ent is not None:
                return _freeze(ent["config"])
            return default          # the owner's sweep failed entirely
        try:
            return self._sweep(ks, candidates, measure, default)
        finally:
            with self._lock:
                self._inflight.pop(ks, None)
            ev.set()

    def _sweep(self, key_str, candidates, measure, default):
        results = {}
        best_cfg, best_dt = None, float("inf")
        for cfg in candidates:
            try:
                dt = float(measure(cfg))
            except Exception:
                # a candidate that does not build or does not fit: skip
                # it, never abort the sweep — some candidate works
                results[str(cfg)] = None
                continue
            results[str(cfg)] = round(dt * 1000, 4)
            if dt < best_dt:
                best_cfg, best_dt = cfg, dt
        if best_cfg is None:
            return default
        ent = {"config": list(best_cfg) if isinstance(best_cfg, tuple)
               else best_cfg, "picked_ms": round(best_dt * 1000, 4),
               "candidates_ms": results, "ts": time.time()}
        with self._lock:
            self._load()[key_str] = ent
            try:
                self.save()
            except OSError:
                pass                    # read-only FS: in-process only
        return _freeze(best_cfg) if isinstance(best_cfg, (tuple, list)) \
            else best_cfg


_table = None
_table_lock = threading.Lock()


def get_table():
    """The process-global table (default cache path, env-driven mode)."""
    global _table
    with _table_lock:
        if _table is None:
            _table = AutotuneTable()
        return _table


def configure(path=None, mode=None):
    """Install a fresh process-global table and return it."""
    global _table
    with _table_lock:
        _table = AutotuneTable(path=path, mode=mode)
        return _table


def reset():
    """Drop the process-global table (tests)."""
    global _table
    with _table_lock:
        _table = None


def autotune(name, key, candidates, measure, default=None):
    """Module-level shorthand for ``get_table().lookup(...)``."""
    return get_table().lookup(name, key, candidates, measure,
                              default=default)
