"""Per-request serving lifecycle: ids, phase timelines, in-flight dumps.

A copy of ``hetu_tpu/serving/lifecycle.py`` (pure host code, no tensor
ops): the engine creates a timeline only when telemetry is enabled, and
``Telemetry.flush`` writes the in-flight tables. The text below is the
reference's and names the reference's tools (the doctor is still to
port: ROADMAP item 14).

The serving plane used to be observable only at engine granularity
(``step`` spans + counters); this module is the request-level layer the
whole plane shares:

* **request ids** — :func:`mint_request_id` mints a process-unique id;
  ``ServingHTTPServer`` honors/echoes ``x-request-id`` at ingress,
  ``ReplicaRouter`` propagates it, and
  ``ContinuousBatchingEngine.submit`` / ``MicroBatcher.submit`` accept
  it (minting one themselves when the caller didn't).
* **phase timelines** — :class:`RequestTimeline` accumulates one
  retired request's contiguous phase episodes (``queue`` -> ``prefill``
  -> per-step ``decode``, with post-preemption episodes rebadged
  ``replay`` until the request re-earns the tokens it lost). The engine
  creates a timeline ONLY when telemetry is enabled, so the disabled
  path keeps its zero-alloc-per-step contract (every recording
  site guards on ``tel.enabled`` / ``seq.tl is not None`` first).
  :func:`emit_request` exports the episodes retroactively as
  ``serve_phase`` / ``serve_request`` Chrome-trace spans (explicit
  ``perf_counter_ns`` clocks through ``Telemetry.complete``) that
  ``merge_traces`` interleaves with the engine's own step spans, and
  ``python -m hetu_tpu.telemetry.doctor --serving`` attributes into
  conserving queue/prefill/decode/replay/overhead buckets.
* **in-flight dumps** — serving components :func:`register` themselves
  in a process-wide WeakSet; :func:`dump_inflight` (called from
  ``Telemetry.flush``, which the crash handlers already invoke)
  writes ``requests_rank<r>.json`` beside the flight rings so a
  crashed/watchdogged engine names its stuck requests (id, phase,
  tokens, blocks held, age) in the black-box report.
"""
from __future__ import annotations

import itertools
import json
import os
import time
import weakref

__all__ = ["mint_request_id", "RequestTimeline", "emit_request",
           "register", "dump_inflight", "PHASES"]

# the disjoint per-request buckets the serving doctor attributes into;
# "overhead" is the exact residual (e2e minus recorded episodes), never
# an emitted span — conservation is by construction, then checked
PHASES = ("queue", "prefill", "decode", "replay", "overhead")

_RID = itertools.count(1)


def mint_request_id():
    """Process-unique request id (``req-<pid>-<n>``, both hex)."""
    return f"req-{os.getpid():x}-{next(_RID):x}"


class RequestTimeline:
    """Phase episodes of ONE request, on explicit ``perf_counter_ns``
    clocks. Created only when telemetry is enabled; recording is a
    tuple append (no locks — every writer is the scheduler thread)."""

    __slots__ = ("rid", "t_submit", "t_wait_start", "t_first_token",
                 "episodes")

    def __init__(self, rid, now_ns):
        self.rid = rid
        self.t_submit = now_ns
        # waiting-episode cursor: submit time initially, reset to the
        # preemption instant when a sequence bounces back to the queue
        self.t_wait_start = now_ns
        self.t_first_token = None       # TTFT point: last prefill end
        self.episodes = []              # (phase, t0_ns, t1_ns, attrs)

    def note(self, phase, t0_ns, t1_ns, attrs=None):
        """Record one episode; ``attrs`` (optional dict) rides onto the
        exported ``serve_phase`` span — the prefix/chunked-prefill path
        stamps ``cached_tokens`` / ``computed_tokens`` here so the
        doctor can attribute prompt work to the cache vs the chip."""
        self.episodes.append((phase, t0_ns, t1_ns, attrs))


def emit_request(tel, tl, t_retire_ns, tokens, preempts):
    """Export one retired request's timeline: one ``serve_phase`` span
    per episode plus the enclosing ``serve_request`` span (attrs typed
    in ``telemetry.check.SPAN_SCHEMA``)."""
    for phase, t0, t1, attrs in tl.episodes:
        args = {"request_id": tl.rid, "phase": phase}
        if attrs:
            args.update(attrs)
        tel.complete("serve_phase", t0, t1, args)
    tel.complete("serve_request", tl.t_submit, t_retire_ns,
                 {"request_id": tl.rid, "phase": "retired",
                  "tokens": int(tokens), "preempts": int(preempts)})


# ---------------------------------------------------------------------------
# in-flight registry: the crash-dump view of the serving plane
# ---------------------------------------------------------------------------

# live serving components exposing inflight_requests() (engines,
# batchers, routers); weak so a closed engine never pins itself here
_COMPONENTS = weakref.WeakSet()


def register(component):
    """Track a serving component for crash-time in-flight dumps."""
    _COMPONENTS.add(component)


def dump_inflight(out_dir, rank):
    """Write ``requests_rank<rank>.json`` — every registered
    component's in-flight request table (+ its ``stats()`` snapshot) —
    atomically (tmp+rename, flight-ring discipline). Returns the path,
    or None when no component is registered or the write failed; never
    raises (this runs inside crash handlers)."""
    entries = []
    for comp in list(_COMPONENTS):
        try:
            entry = {"name": getattr(comp, "name", None)
                     or type(comp).__name__,
                     "kind": type(comp).__name__,
                     "requests": comp.inflight_requests()}
            stats = getattr(comp, "stats", None)
            if callable(stats):
                entry["stats"] = stats()
            entries.append(entry)
        except Exception:       # noqa: BLE001 — never mask the crash
            continue
    if not entries:
        return None
    try:
        doc = {"rank": int(rank), "pid": os.getpid(),
               "wall": time.time(), "components": entries}
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"requests_rank{int(rank)}.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None
