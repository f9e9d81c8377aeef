"""Memory accounting: runtime device-memory gauges and the OOM
post-mortem.

Counterpart of ``hetu_tpu/telemetry/memory.py``:

* :func:`observe_device_memory` — per-step live/peak device bytes from
  ``torch.cuda.memory_stats(device)``, which reads the caching
  allocator's counters on the host and does not synchronize the
  device; a no-op (``{}``) where no card is initialized, so the CPU
  path costs one check per step.
* :func:`oom_report` — on ``torch.cuda.OutOfMemoryError`` the executor
  calls this to render a table of the largest live tensors (named
  parameters first) before re-raising, so an OOM names the tensor
  instead of just the byte count.

The reference's ``capture_compile`` and its ``memory_analysis`` span
read a compiled program's memory analysis; the port compiles nothing,
so it has no counterpart (ROADMAP §3).

Imports no torch at module level: the package must load on a machine
without it (the PS server, ``python -m hetu_tpu_torch.telemetry.check``).
"""
from __future__ import annotations

import os
import sys

__all__ = ["observe_device_memory", "oom_report", "is_oom",
           "device_memory_stats", "fmt_bytes"]


def device_memory_stats():
    """{device_index: {"bytes_in_use":, "peak_bytes_in_use":}} for the
    cards this process has initialized; {} on the CPU (torch not
    loaded, or no card in use). A host-side read of the allocator's
    counters: no device synchronization."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    try:
        if not torch.cuda.is_available() or \
                not torch.cuda.is_initialized():
            return {}
        out = {}
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            live = int(stats.get("allocated_bytes.all.current", 0))
            out[i] = {"bytes_in_use": live,
                      "peak_bytes_in_use": int(
                          stats.get("allocated_bytes.all.peak", live))}
        return out
    except Exception:           # noqa: BLE001 — optional accounting
        return {}


def observe_device_memory(tel):
    """Per-step live/peak gauges (summed over the process's cards);
    no-op when telemetry is off or no card reports."""
    if tel is None or not tel.enabled:
        return
    stats = device_memory_stats()
    if not stats:
        return
    tel.set_gauge("memory_live_bytes",
                  sum(s["bytes_in_use"] for s in stats.values()))
    tel.set_gauge("memory_peak_bytes",
                  sum(s["peak_bytes_in_use"] for s in stats.values()))


# ---------------------------------------------------------------------------
# OOM post-mortem
# ---------------------------------------------------------------------------

def is_oom(exc):
    """Does this exception look like a device allocator failure? A
    ``torch.cuda.OutOfMemoryError``, or the reference's message test
    (an allocator failure surfaced as a plain ``RuntimeError``)."""
    torch = sys.modules.get("torch")
    oom_type = getattr(getattr(torch, "cuda", None), "OutOfMemoryError",
                       None) if torch is not None else None
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = repr(exc)
    return "RESOURCE_EXHAUSTED" in text or "Out of memory" in text \
        or "out of memory" in text


def fmt_bytes(n):
    """Human-readable byte count."""
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return (f"{n:.1f}{unit}" if unit != "B" else f"{n}{unit}")
        n /= 1024.0
    return f"{n}B"


def _live_tensors():
    """Every tensor the garbage collector can reach, deduplicated by
    storage (a view and its base are one buffer)."""
    import gc

    import torch
    seen, out = set(), []
    for obj in gc.get_objects():
        try:
            # type(), not isinstance: isinstance reads __class__, which
            # warns on deprecated module proxies
            if not issubclass(type(obj), torch.Tensor) or obj.is_meta:
                continue
            key = (obj.device.type, obj.untyped_storage().data_ptr())
        except Exception:       # noqa: BLE001 — exotic tensor subclasses
            continue
        if key in seen:
            continue
        seen.add(key)
        out.append(obj)
    return out


def oom_report(named_params=None, limit=20, out_dir=None, rank=0,
               device=None):
    """Table of the largest live tensors, named parameters labelled by
    name and listed first; returns the rendered text and (best effort)
    writes ``oom_rank<r>.txt`` into ``out_dir``. ``device`` (a device
    type or ``torch.device``: the session's) selects the tensors; None
    keeps every tensor that is not on the CPU. Never raises."""
    try:
        by_ptr = {}
        for name, t in (named_params or {}).items():
            try:
                by_ptr[t.untyped_storage().data_ptr()] = name
            except Exception:   # noqa: BLE001
                continue
        kind = getattr(device, "type", device)
        rows = []
        for t in _live_tensors():
            if (t.device.type == "cpu") if kind is None \
                    else t.device.type != kind:
                continue
            nbytes = int(t.untyped_storage().nbytes())
            name = by_ptr.get(t.untyped_storage().data_ptr())
            rows.append((name is None, -nbytes,
                         name or "<activation/temp>",
                         str(tuple(t.shape)),
                         str(t.dtype).replace("torch.", ""), nbytes))
        rows.sort()
        total = sum(r[5] for r in rows)
        lines = [f"device OOM post-mortem: {len(rows)} live buffers, "
                 f"{fmt_bytes(total)} total; largest {limit} (named "
                 f"parameters first):",
                 f"{'bytes':>12}  {'shape':<20} {'dtype':<10} name"]
        for _, _, name, shape, dtype, nbytes in rows[:limit]:
            lines.append(f"{fmt_bytes(nbytes):>12}  {shape:<20} "
                         f"{dtype:<10} {name}")
        for did, s in sorted(device_memory_stats().items()):
            lines.append(f"device {did}: live "
                         f"{fmt_bytes(s['bytes_in_use'])}, peak "
                         f"{fmt_bytes(s['peak_bytes_in_use'])}")
        text = "\n".join(lines)
        if out_dir:
            try:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(out_dir,
                                       f"oom_rank{rank}.txt"), "w") as f:
                    f.write(text + "\n")
            except OSError:
                pass
        return text
    except Exception:           # noqa: BLE001 — never mask the OOM
        return "device OOM post-mortem unavailable"
