"""Perf doctor: trace analytics and critical-path attribution.

The observability stack answers "what happened" (spans/metrics) and
"why it died" (the black box); this module answers **"why is it
slow"** — mechanically, from the same Chrome-trace files the tracer
already exports, instead of a human reading Perfetto by eye.

The engine parses per-rank trace files into a per-rank span forest,
finds the **step windows** (``step`` spans from ``Executor.run`` and
``step_block`` spans from the block/stream paths, weighted by their
``steps`` attr), and attributes each window's wall time into named
buckets:

===============  ===========================================================
bucket           span producers
===============  ===========================================================
``jit``          ``jit_compile``, ``autotune_sweep``, ``cpp_build``
``compute``      ``device_dispatch``, ``block_dispatch``, ``cpp_dispatch``,
                 ``cpp_tick``, ``ps:dispatch``, pipeline fwd/bwd blocks
``collective``   ``allreduce*`` / ``collective*`` spans (``GroupComm``'s
                 host-side collectives, ``ops/comm.py``)
``p2p``          ``p2p_send`` / ``p2p_recv``
``ps_pull``      ``ps:pull``, ``ps:host_pull``, ``ps:miss_fill``,
                 ``ps:refresh``, ``ps:prefetch``, ``ps:repull``
``ps_push``      ``ps:sync_push``, ``ps:drain_submit``, ``ps:drain_push``,
                 ``ps:dense``
``h2d_ingest``   ``h2d_transfer``, ``ingest_wait``, ``cpp_pack_feeds``,
                 ``ps:feed_ingest``, ``ps:slot_assign``
``bubble``       ``pp_stage_idle`` (the measured pipeline bubble)
``unaccounted``  window wall time no span claims (host Python, GC, ...)
===============  ===========================================================

Attribution is **conserving by construction**: within a window, spans
claim time in priority order over disjoint interval sets (a nested
``ps:pull`` inside ``ps:host_pull`` can't double-count; a
``pp_stage_idle`` inside a fwd block is bubble, not compute), and
``unaccounted`` is the exact residual — so buckets always sum to the
measured step wall, and the conservation check guards the arithmetic
rather than hoping. Spans stamped ``overlapped=True`` (the async
ingest worker) — and any span riding a thread other than the window's
— are **hidden**: accounted separately, never charged against the
critical path. The hidden/exposed split is what proves (or disproves)
that the host is actually hidden.

CLI::

    python -m hetu_tpu_torch.telemetry.doctor TELEMETRY_DIR [--json]
        [--bench BENCH_r07.json] [--costdb PATH] [--tolerance 0.1]

prints a ranked diagnosis — top exposed bucket, bubble fraction,
comm:compute ratio, transfer hidden fraction, cost-DB coverage gaps —
each with a remediation pointer into the existing knobs
(``overlap_options.lookahead`` / ``bucket_bytes``, ``pp_options`` M /
``fuse_ticks``, ``HETU_AUTOTUNE``).

**Serving mode**::

    python -m hetu_tpu_torch.telemetry.doctor --serving TELEMETRY_DIR [--json]

switches the unit of attribution from the training step to the served
**request**: each retired request's ``serve_request``/``serve_phase``
spans (serving/lifecycle.py) are rebuilt into a timeline and its
end-to-end latency attributed into disjoint queue / prefill / decode /
replay / overhead buckets (conservation checked per request), with
TTFT/TPOT/queue-wait percentiles, preemption stats, and a top-bucket
diagnosis citing the serving knobs (``num_blocks``,
``max_batch_size``, ``reserve``, ``prompt_buckets``, replicas).

Counterpart of ``hetu_tpu/telemetry/doctor.py``: the same attribution
arithmetic over the port's traces. Two span names are the port's own and
have no reference twin: ``cpp_tick`` (one tick of the collective
pipeline over every stage's stream, ``parallel/collective_pp.py``) is
``compute``, and ``GroupComm``'s ``allreduce`` / ``collective_*`` spans
are ``collective`` (the reference runs its collectives inside the
compiled step, so no span of its own covers them). Spans time host work
(``telemetry/__init__.py``): a bucket is the host time its spans held,
not the device's, so a step whose device lags its host shows that wait
where the host synchronizes (a loss read, a collective). Imports no
torch: the CLI runs where no card is (``python -m`` skips the package's
torch import, ``hetu_tpu_torch/__init__.py``); the cost DB is read only
when it is there.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

__all__ = ["classify", "attribute_events", "attribute_trace",
           "diagnose", "load_telemetry_dir", "main",
           "SERVE_BUCKETS", "parse_request_events",
           "summarize_requests", "attribute_request_events",
           "attribute_requests_dir", "render_serving_text"]

# exposed-time buckets, in claim-priority order: when two spans overlap
# on the window's thread, the more *specific* cause wins the interval
# (an idle wait inside a stage block is bubble, a pull inside a phase
# is ps_pull, ...); compute — the coarse dispatch spans — claims last
_PRIORITY = ("bubble", "p2p", "ps_pull", "ps_push", "jit", "h2d_ingest",
             "collective", "compute")
BUCKETS = _PRIORITY + ("unaccounted",)

_WINDOW_NAMES = ("step", "step_block")

_EXACT = {
    "jit_compile": "jit", "autotune_sweep": "jit", "cpp_build": "jit",
    "attn_probe": "jit",
    "device_dispatch": "compute", "block_dispatch": "compute",
    "cpp_dispatch": "compute", "ps:dispatch": "compute",
    "pp_fill": "compute", "pp_steady": "compute", "pp_drain": "compute",
    "pp_fwd_block": "compute", "pp_bwd_block": "compute",
    "cpp_tick": "compute",
    "p2p_send": "p2p", "p2p_recv": "p2p",
    "pp_stage_idle": "bubble",
    "ps:pull": "ps_pull", "ps:host_pull": "ps_pull",
    "ps:miss_fill": "ps_pull", "ps:refresh": "ps_pull",
    "ps:prefetch": "ps_pull", "ps:repull": "ps_pull",
    "ps:sync_push": "ps_push", "ps:drain_submit": "ps_push",
    "ps:drain_push": "ps_push", "ps:dense": "ps_push",
    "h2d_transfer": "h2d_ingest", "ingest_wait": "h2d_ingest",
    "cpp_pack_feeds": "h2d_ingest", "cpp_replicate_feeds": "h2d_ingest",
    "ps:feed_ingest": "h2d_ingest", "ps:slot_assign": "h2d_ingest",
}


def classify(name):
    """Span name -> bucket (None for container/unknown spans)."""
    b = _EXACT.get(name)
    if b is not None:
        return b
    if name.startswith(("allreduce", "collective")):
        return "collective"
    if name.startswith("ps:"):
        return "ps_pull"           # unknown PS phase: pull-side default
    return None


# -- interval arithmetic (all in trace µs) ----------------------------------

def _merge(intervals):
    """Sorted disjoint union of [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _subtract(intervals, claimed):
    """``intervals`` minus ``claimed`` (both sorted disjoint). The
    cursor into ``claimed`` only advances past intervals that end at or
    before the CURRENT input's start — a claimed interval straddling
    two inputs (e.g. a bubble span overlapping the tail of one h2d
    span and the head of the next) must subtract from both."""
    if not claimed:
        return [list(iv) for iv in intervals]
    out = []
    j = 0
    for s, e in intervals:
        while j > 0 and claimed[j - 1][1] > s:
            j -= 1              # safety: never strand an overlapper
        while j < len(claimed) and claimed[j][1] <= s:
            j += 1
        k = j
        while s < e and k < len(claimed) and claimed[k][0] < e:
            cs, ce = claimed[k]
            if s < cs:
                out.append([s, cs])
            s = max(s, ce)
            k += 1
        if s < e:
            out.append([s, e])
    return out


def _total(intervals):
    return sum(e - s for s, e in intervals)


# -- attribution ------------------------------------------------------------

def _spans(events):
    return [e for e in events
            if e.get("ph") == "X" and isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("dur"), (int, float))]


def attribute_events(events, tolerance=0.10):
    """Attribute one rank's trace events. Returns None when the trace
    holds no step/step_block windows; else a dict with ``steps``,
    ``windows``, ``wall_ms``, ``buckets`` (ms, incl. unaccounted),
    ``per_step_ms``, ``hidden_ms`` (off-critical-path time by bucket),
    ``segments`` (top span names by RAW span time — nested spans of
    different names each count; the buckets are the disjoint
    accounting), and ``conserved``."""
    spans = _spans(events)
    windows = []
    for e in spans:
        if e["name"] in _WINDOW_NAMES:
            args = e.get("args") or {}
            try:
                weight = max(1, int(args.get("steps", 1)))
            except (TypeError, ValueError):
                weight = 1
            windows.append((e, weight))
    if not windows:
        return None

    # windows can nest only by accident (a step inside a step_block
    # would double-bill the wall); keep outermost windows only. One
    # sorted sweep per (pid, tid) — containment is only meaningful on
    # the window's own thread (a concurrent executor on another thread
    # of the same process is a real window, not a nested one), and an
    # all-pairs check would be O(W^2) over the tens of thousands of
    # step windows a pipelined run records
    by_pid_windows = {}
    for w, weight in windows:
        key = (w.get("pid"), w.get("tid"))
        by_pid_windows.setdefault(key, []).append((w, weight))
    outer = []
    for ws in by_pid_windows.values():
        ws.sort(key=lambda wv: (wv[0]["ts"], -wv[0]["dur"]))
        best = None                 # (ts, end) of the widest outer seen
        for w, weight in ws:
            s, e = w["ts"], w["ts"] + w["dur"]
            if best is not None and e <= best[1] and (s, e) != best:
                continue            # nested inside `best`
            outer.append((w, weight))
            if best is None or e > best[1]:
                best = (s, e)

    # classify + bucket every span once, sorted by ts, so each window
    # visits only the spans that can overlap it (bisect on start)
    import bisect
    cand = []
    for e in spans:
        if e["name"] in _WINDOW_NAMES:
            continue
        bucket = classify(e["name"])
        if bucket is None:
            continue
        cand.append(e)
    cand.sort(key=lambda e: e["ts"])
    cand_ts = [e["ts"] for e in cand]
    max_dur = max((e["dur"] for e in cand), default=0.0)

    buckets = {b: 0.0 for b in BUCKETS}
    hidden = {}
    seg = {}
    steps = 0
    wall_us = 0.0
    for w, weight in outer:
        w0, w1 = w["ts"], w["ts"] + w["dur"]
        wtid, wpid = w.get("tid"), w.get("pid")
        steps += weight
        wall_us += w["dur"]
        by_bucket = {}
        lo = bisect.bisect_left(cand_ts, w0 - max_dur)
        hi = bisect.bisect_right(cand_ts, w1)
        for e in cand[lo:hi]:
            if e.get("pid") != wpid:
                continue
            s, t = e["ts"], e["ts"] + e["dur"]
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            bucket = classify(e["name"])
            overlapped = bool((e.get("args") or {}).get("overlapped"))
            if overlapped or e.get("tid") != wtid:
                # off the window thread / ingest-worker stamped: the
                # time is real host work but rides UNDER the device —
                # report it, never charge the critical path with it
                hidden[bucket] = hidden.get(bucket, 0.0) + (t - s)
                continue
            by_bucket.setdefault(bucket, []).append([s, t])
            seg[e["name"]] = seg.get(e["name"], 0.0) + (t - s)
        claimed = []
        for bucket in _PRIORITY:
            ivs = _merge(by_bucket.get(bucket, []))
            if not ivs:
                continue
            fresh = _subtract(ivs, claimed)
            buckets[bucket] += _total(fresh)
            claimed = _merge(claimed + fresh)
        buckets["unaccounted"] += max(0.0, w["dur"] - _total(claimed))

    total = sum(buckets.values())
    conserved = abs(total - wall_us) <= tolerance * max(wall_us, 1e-9)
    to_ms = lambda us: round(us / 1000.0, 3)          # noqa: E731
    return {
        "steps": steps,
        "windows": len(outer),
        "wall_ms": to_ms(wall_us),
        "buckets": {b: to_ms(v) for b, v in buckets.items()},
        "per_step_ms": {b: round(v / 1000.0 / max(steps, 1), 4)
                        for b, v in buckets.items()},
        "step_wall_ms": round(wall_us / 1000.0 / max(steps, 1), 4),
        "hidden_ms": {b: to_ms(v) for b, v in sorted(hidden.items())},
        "segments": [
            {"name": n, "ms": to_ms(v)} for n, v in
            sorted(seg.items(), key=lambda kv: -kv[1])[:8]],
        "conserved": bool(conserved),
        "conservation_error": round(
            abs(total - wall_us) / max(wall_us, 1e-9), 6),
    }


def load_telemetry_dir(path):
    """{rank_label: events} from a telemetry dir: per-rank
    ``trace_rank*.json`` files preferred (truncation-salvaged like
    ``merge_traces``), the merged file split by pid otherwise."""
    from .tracer import _load_events
    out = {}
    ranks = sorted(p for p in glob.glob(os.path.join(path, "trace_*.json"))
                   if not p.endswith("trace_merged.json"))
    if ranks:
        for p in ranks:
            label = os.path.splitext(os.path.basename(p))[0]
            label = label[len("trace_"):] or label
            out[label] = _load_events(p)
        return out
    merged = os.path.join(path, "trace_merged.json")
    if os.path.exists(merged):
        by_pid = {}
        for e in _load_events(merged):
            by_pid.setdefault(e.get("pid", 0), []).append(e)
        return {f"pid{pid}": evs for pid, evs in sorted(by_pid.items())}
    if os.path.isfile(path):
        return {os.path.basename(path): _load_events(path)}
    return {}


def attribute_trace(path, tolerance=0.10):
    """Attribute every rank found under ``path`` (a telemetry dir or
    one trace file); returns {rank_label: attribution}, skipping ranks
    with no step windows."""
    out = {}
    for label, events in load_telemetry_dir(path).items():
        attr = attribute_events(events, tolerance=tolerance)
        if attr is not None:
            out[label] = attr
    return out


# -- serving mode: per-REQUEST attribution ----------------------------------
#
# The step attribution above answers "why is a training step slow"; the
# serving plane's unit of latency is the request. ``--serving`` rebuilds
# each retired request's lifecycle from its ``serve_request`` (submit ->
# retire) and ``serve_phase`` (queue / prefill / decode / replay
# episodes) spans and attributes the end-to-end latency into disjoint
# buckets with the same conservation discipline: the engine records the
# episodes sequentially on one scheduler thread, ``overhead`` is the
# exact residual, and the check guards the arithmetic (an episode
# leaking past retire, or overlapping episodes summing past e2e, fails
# the request rather than silently misattributing it).

SERVE_BUCKETS = ("queue", "prefill", "decode", "replay", "overhead")


def _pctl(vals, q):
    """Linear-interpolated percentile over a plain list (stdlib-only,
    like the rest of this module)."""
    if not vals:
        return 0.0
    vs = sorted(vals)
    k = (len(vs) - 1) * q / 100.0
    f = int(k)
    c = min(f + 1, len(vs) - 1)
    return vs[f] + (vs[c] - vs[f]) * (k - f)


def _account_request(r, tolerance, slack_us=2.0):
    """One parsed request -> accounted dict (all times ms). Buckets sum
    to e2e by construction (overhead is the residual); ``conserved``
    demands the residual is non-negative within tolerance AND every
    episode lies inside the [submit, retire] window."""
    t0, e2e_us = r["t0"], r["e2e"]
    t1 = t0 + e2e_us
    buckets = {b: 0.0 for b in SERVE_BUCKETS}
    seen = set()
    in_window = True
    prefill_ends, decode_starts = [], []
    cached_tokens = computed_tokens = 0
    for ph, s, t, a in r["episodes"]:
        buckets[ph] = buckets.get(ph, 0.0) + (t - s)
        seen.add(ph)
        if s < t0 - slack_us or t > t1 + slack_us:
            in_window = False
        if ph == "prefill":
            prefill_ends.append(t)
            try:
                cached_tokens += int(a.get("cached_tokens", 0))
                computed_tokens += int(a.get("computed_tokens", 0))
            except (TypeError, ValueError):
                pass
        elif ph == "decode":
            decode_starts.append(s)
    # TTFT point: the LAST prefill end that precedes the first decode
    # start — under chunked prefill a prompt spans several prefill
    # episodes and the first token only exists once the final chunk
    # lands (the first-episode end would fake a fast TTFT)
    first_decode = min(decode_starts) if decode_starts else None
    prefill_end = None
    for t in prefill_ends:
        if first_decode is not None and t > first_decode + slack_us:
            continue
        if prefill_end is None or t > prefill_end:
            prefill_end = t
    claimed = sum(v for b, v in buckets.items() if b != "overhead")
    residual = e2e_us - claimed
    conserved = in_window and \
        residual >= -(tolerance * max(e2e_us, 1.0) + slack_us)
    buckets["overhead"] = max(0.0, residual)
    # a complete timeline saw the request wait (queue) and prefill and
    # produce at least one token — anything less means a recording site
    # was skipped and the attribution under-claims
    complete = "queue" in seen and prefill_end is not None \
        and r["tokens"] >= 1
    tokens = r["tokens"]
    ttft_ms = (prefill_end - t0) / 1000.0 \
        if prefill_end is not None else None
    tpot_ms = (t1 - prefill_end) / 1000.0 / max(1, tokens - 1) \
        if prefill_end is not None else None
    return {
        "request_id": r["request_id"],
        "e2e_ms": round(e2e_us / 1000.0, 3),
        "tokens": tokens,
        "preempts": r["preempts"],
        "buckets_ms": {b: round(v / 1000.0, 3)
                       for b, v in buckets.items()},
        "ttft_ms": None if ttft_ms is None else round(ttft_ms, 3),
        "tpot_ms": None if tpot_ms is None else round(tpot_ms, 4),
        "queue_ms": round(buckets["queue"] / 1000.0, 3),
        "cached_tokens": cached_tokens,
        "computed_tokens": computed_tokens,
        "complete": bool(complete),
        "conserved": bool(conserved),
    }


def parse_request_events(events, tolerance=0.05):
    """One rank's trace events -> list of accounted per-request dicts
    (retired requests only: a request with no ``serve_request`` span was
    still in flight at export and has no e2e to attribute)."""
    reqs = {}
    for e in _spans(events):
        name = e["name"]
        if name not in ("serve_request", "serve_phase"):
            continue
        args = e.get("args") or {}
        rid = args.get("request_id")
        if not isinstance(rid, str):
            continue
        r = reqs.setdefault(rid, {"request_id": rid, "episodes": [],
                                  "e2e": None, "t0": None, "tokens": 0,
                                  "preempts": 0})
        if name == "serve_request":
            r["t0"] = e["ts"]
            r["e2e"] = e["dur"]
            try:
                r["tokens"] = int(args.get("tokens", 0))
                r["preempts"] = int(args.get("preempts", 0))
            except (TypeError, ValueError):
                pass
        else:
            ph = args.get("phase")
            if isinstance(ph, str):
                r["episodes"].append((ph, e["ts"], e["ts"] + e["dur"],
                                      args))
    return [_account_request(r, tolerance) for r in reqs.values()
            if r["e2e"] is not None]


# knob remediations per serving bucket — each one names a real
# constructor argument / deployment action, mirroring _REMEDY above
_SERVE_REMEDY = {
    "queue": "admission-starved: raise ContinuousBatchingEngine "
             "num_blocks (a bigger KV pool admits sooner) or "
             "max_batch_size, or add a replica behind ReplicaRouter",
    "prefill": "TTFT rides prefill compute: prefix_cache=True shares "
               "repeated system-prompt K/V (prefill_cached_tokens vs "
               "prefill_tokens shows the resolved fraction) and "
               "prefill_chunk=N interleaves long cold prompts with "
               "decode; also compare engine_prefill_pad_tokens vs "
               "engine_prefill_tokens for prompt-bucket padding",
    "decode": "decode-compute bound: the device is the limit — raise "
              "max_batch_size for step occupancy, or scale replicas",
    "replay": "preemption replay recomputes lost tokens: "
              "reserve='full' removes mid-decode preemption, or raise "
              "num_blocks so lazy growth stops evicting",
    "overhead": "host scheduler overhead between dispatches: raise "
                "max_batch_size so each step carries more sequences",
}


def summarize_requests(reqs, tolerance=0.05):
    """Accounted per-request dicts -> fleet summary: bucket totals,
    TTFT/TPOT/queue-wait percentiles, preemption stats, top bucket +
    remedy, and the conservation verdict (every request's buckets must
    sum to its e2e)."""
    if not reqs:
        return {"requests": 0, "conserved": False, "complete": False,
                "error": "no serve_request spans found "
                         "(was serving telemetry enabled?)"}
    totals = {b: sum(r["buckets_ms"][b] for r in reqs)
              for b in SERVE_BUCKETS}
    e2e_total = sum(r["e2e_ms"] for r in reqs) or 1e-9
    violations = [r["request_id"] for r in reqs if not r["conserved"]]
    incomplete = [r["request_id"] for r in reqs if not r["complete"]]
    ttfts = [r["ttft_ms"] for r in reqs if r["ttft_ms"] is not None]
    tpots = [r["tpot_ms"] for r in reqs if r["tpot_ms"] is not None]
    queues = [r["queue_ms"] for r in reqs]
    e2es = [r["e2e_ms"] for r in reqs]
    preempted = sum(1 for r in reqs if r["preempts"] > 0)
    top = max(totals.items(), key=lambda kv: kv[1])
    return {
        "requests": len(reqs),
        "conserved": not violations,
        "complete": not incomplete,
        "violations": violations[:20],
        "incomplete": incomplete[:20],
        "tolerance": tolerance,
        "e2e_total_ms": round(e2e_total, 3),
        "e2e_p50_ms": round(_pctl(e2es, 50), 3),
        "e2e_p99_ms": round(_pctl(e2es, 99), 3),
        "serve_ttft_p50_ms": round(_pctl(ttfts, 50), 3),
        "serve_ttft_p99_ms": round(_pctl(ttfts, 99), 3),
        "serve_tpot_p50_ms": round(_pctl(tpots, 50), 4),
        "serve_queue_wait_p99_ms": round(_pctl(queues, 99), 3),
        "buckets_ms": {b: round(v, 3) for b, v in totals.items()},
        "bucket_fraction": {b: round(v / e2e_total, 4)
                            for b, v in totals.items()},
        "preempted_requests": preempted,
        "preempt_rate": round(preempted / len(reqs), 4),
        # prefix-cache efficacy across retired requests: prompt tokens
        # the cache resolved vs tokens the chip actually prefilled
        "prefill_cached_tokens": sum(r["cached_tokens"] for r in reqs),
        "prefill_computed_tokens": sum(r["computed_tokens"]
                                       for r in reqs),
        "replay_fraction": round(totals["replay"] / e2e_total, 4),
        "top_bucket": {
            "bucket": top[0],
            "ms": round(top[1], 3),
            "fraction": round(top[1] / e2e_total, 4),
            "remedy": _SERVE_REMEDY.get(top[0], "")},
        "slowest_requests": sorted(reqs, key=lambda r: -r["e2e_ms"])[:8],
    }


def attribute_request_events(events, tolerance=0.05):
    """One event list (e.g. an in-process ``tracer.drain()``) ->
    serving summary. ``bench.py serving_continuous`` gates on this."""
    return summarize_requests(parse_request_events(events, tolerance),
                              tolerance)


def attribute_requests_dir(path, tolerance=0.05):
    """Telemetry dir -> serving summary, requests merged across ranks
    (requests are independent; each request's conservation is checked
    against its own rank's clocks)."""
    reqs = []
    for _, events in load_telemetry_dir(path).items():
        reqs.extend(parse_request_events(events, tolerance))
    return summarize_requests(reqs, tolerance)


def render_serving_text(diag):
    if not diag.get("requests"):
        return "serving doctor: " + diag.get("error", "no requests")
    lines = []
    lines.append(f"serving doctor — {diag['requests']} retired "
                 f"request(s), e2e p50/p99 {diag['e2e_p50_ms']:.1f}/"
                 f"{diag['e2e_p99_ms']:.1f} ms")
    lines.append("")
    lines.append("  bucket        total ms    fraction of e2e")
    for b in SERVE_BUCKETS:
        v = diag["buckets_ms"].get(b, 0.0)
        lines.append(f"  {b:<12}{_fmt_ms(v)}    "
                     f"{diag['bucket_fraction'].get(b, 0.0):6.1%}")
    check = "OK" if diag["conserved"] else "FAILED"
    lines.append(f"  conservation: buckets sum to each request's e2e "
                 f"for {diag['requests'] - len(diag['violations'])}"
                 f"/{diag['requests']} requests [{check}]")
    if diag["violations"]:
        lines.append(f"  violating: {', '.join(diag['violations'][:5])}")
    if not diag["complete"]:
        lines.append(f"  INCOMPLETE timelines: "
                     f"{', '.join(diag['incomplete'][:5])}")
    lines.append("")
    lines.append(f"TTFT p50/p99: {diag['serve_ttft_p50_ms']:.1f}/"
                 f"{diag['serve_ttft_p99_ms']:.1f} ms   "
                 f"TPOT p50: {diag['serve_tpot_p50_ms']:.2f} ms   "
                 f"queue wait p99: "
                 f"{diag['serve_queue_wait_p99_ms']:.1f} ms")
    lines.append(f"preempted: {diag['preempted_requests']} request(s) "
                 f"(rate {diag['preempt_rate']:.1%}), replay fraction "
                 f"{diag['replay_fraction']:.1%}")
    top = diag["top_bucket"]
    lines.append(f"top bucket: {top['bucket']} ({top['ms']:.1f} ms, "
                 f"{top['fraction']:.1%} of total e2e)")
    if top.get("remedy"):
        lines.append(f"  -> {top['remedy']}")
    lines.append("slowest requests:")
    for r in diag["slowest_requests"][:5]:
        bms = r["buckets_ms"]
        dom = max(bms.items(), key=lambda kv: kv[1])
        lines.append(f"  {r['e2e_ms']:9.1f} ms  {r['request_id']}  "
                     f"tokens={r['tokens']} preempts={r['preempts']} "
                     f"dominant={dom[0]} ({dom[1]:.1f} ms)")
    return "\n".join(lines)


# -- diagnosis --------------------------------------------------------------

# the static-verifier code that lints each bucket's pattern before a
# launch (analysis/efficiency.py, DOCTOR_BUCKET inverted): remediation
# lines cite it so the measured view and the priced static report
# cross-reference — `python -m hetu_tpu_torch.analysis.efficiency`
# predicts what this diagnosis measures
_REMEDY_CODE = {
    "h2d_ingest": "HT905", "collective": "HT904", "jit": "HT901/HT907",
    "unaccounted": "HT903", "compute": "HT902/HT906",
}

_REMEDY = {
    "h2d_ingest": "raise Executor(overlap_options={'lookahead': N}) "
                  "(and keep 'ingest': True) so feed H2D rides under "
                  "compute; stream via run_batches_stream",
    "ps_pull": "device-cache the table (cstable_policy='Device') or "
               "raise overlap_options.lookahead so speculative "
               "SparsePulls overlap in-flight compute",
    "ps_push": "ASP prefetch pool hides pushes; check drain_compress "
               "and overlap_options.lookahead",
    "p2p": "raise pp_options num_microbatches (M) or switch "
           "pipeline_mode='collective'; p2p waits are stage skew",
    "bubble": "raise pp_options M / fuse_ticks (bubble ~ (S-1)/(M+S-1)); "
              "consider the collective pipeline schedule",
    "collective": "set overlap_options.bucket_bytes to bucket gradient "
                  "allreduce; on one card gloo crosses the host, so a "
                  "card a rank (NCCL) is the lever",
    "jit": "shape churn: bucket feed shapes; warm HETU_AUTOTUNE=1 "
           "cache so sweeps never run in measured steps",
    "unaccounted": "host Python between dispatches (the eager walk): "
                   "fewer, larger ops a step, or run_batches_stream to "
                   "hide the feeds",
    "compute": "the walk's issue time: spans close when work is issued, "
               "so compute is host-bound unless the device idle share "
               "is low; tune kernels or scale the mesh",
}


def _remedy(bucket):
    """Remediation string for a bucket, citing the matching HT9xx
    static-lint code when one exists."""
    text = _REMEDY.get(bucket, "")
    code = _REMEDY_CODE.get(bucket)
    if text and code:
        text += (f" [static twin: {code} — "
                 f"python -m hetu_tpu_torch.analysis.efficiency]")
    return text


def diagnose(per_rank, costdb=None, bench=None, tolerance=0.10):
    """Fleet-level diagnosis over ``attribute_trace`` output: straggler
    rank, ranked exposed buckets, ratios, cost-DB coverage, remediation
    pointers. Returns a JSON-able dict."""
    if not per_rank:
        return {"ok": False, "error": "no step/step_block windows found"}
    straggler = max(per_rank, key=lambda r: per_rank[r]["step_wall_ms"])
    a = per_rank[straggler]
    per_step = a["per_step_ms"]
    ranked = sorted(((b, v) for b, v in per_step.items()
                     if b not in ("compute", "jit") and v > 0),
                    key=lambda kv: -kv[1])
    top = ranked[0] if ranked else ("compute", per_step.get("compute", 0))
    wall = max(a["step_wall_ms"], 1e-9)
    comm = sum(per_step.get(b, 0) for b in
               ("collective", "p2p", "ps_pull", "ps_push"))
    compute = per_step.get("compute", 0.0)
    # hidden vs exposed over the TRANSFER buckets only, like-for-like
    # (total ms both sides): counting hidden ps_pull against exposed
    # h2d would claim "transfer hidden" while pulls sit exposed on the
    # critical path
    transfer = ("h2d_ingest", "ps_pull", "ps_push")
    hidden_t = sum(a["hidden_ms"].get(b, 0.0) for b in transfer)
    exposed_t = sum(a["buckets"].get(b, 0.0) for b in transfer)
    hidden_frac = hidden_t / (hidden_t + exposed_t) \
        if (hidden_t + exposed_t) > 0 else None
    diag = {
        "ok": all(r["conserved"] for r in per_rank.values()),
        "ranks": {r: v for r, v in per_rank.items()},
        "straggler": straggler,
        "steps": a["steps"],
        "step_wall_ms": a["step_wall_ms"],
        "top_exposed_bucket": {
            "bucket": top[0], "ms_per_step": top[1],
            "fraction": round(top[1] / wall, 4),
            "remedy": _remedy(top[0]),
            "ht_code": _REMEDY_CODE.get(top[0])},
        "ranked_exposed": [
            {"bucket": b, "ms_per_step": v,
             "fraction": round(v / wall, 4),
             "ht_code": _REMEDY_CODE.get(b)} for b, v in ranked],
        "bubble_fraction": round(per_step.get("bubble", 0.0) / wall, 4),
        "comm_compute_ratio": round(comm / compute, 4)
        if compute > 0 else None,
        "transfer_hidden_fraction": None if hidden_frac is None
        else round(hidden_frac, 4),
        "conserved": all(r["conserved"] for r in per_rank.values()),
        "tolerance": tolerance,
    }
    if costdb is not None:
        present, missing = costdb.coverage()
        curves = {k: cv for k in present
                  for cv in [costdb.curve(k)] if cv}
        diag["costdb"] = {
            "path": costdb.path, "entries": len(costdb),
            "kinds": len(costdb.kinds()), "comm_covered": present,
            "comm_gaps": missing, "curves": curves}
    if bench:
        diag["bench"] = bench
    return diag


def _bench_summary(path):
    """Headline metrics from a BENCH_*.json (or bench JSONL) file, for
    printing beside the trace attribution."""
    from .regress import load_metrics
    try:
        metrics = load_metrics(path)
    except OSError:
        return None
    out = {}
    for name, rec in metrics.items():
        keep = {k: rec[k] for k in
                ("value", "unit", "step_ms_p50", "step_ms_p95",
                 "h2d_MBps", "overlap_fraction", "ingest_wait_ms")
                if k in rec}
        out[name] = keep
    return out


def _fmt_ms(v):
    return f"{v:9.3f}"


def render_text(diag):
    lines = []
    if not diag.get("ranks"):
        return diag.get("error", "no attribution")
    a = diag["ranks"][diag["straggler"]]
    lines.append(f"perf doctor — {len(diag['ranks'])} rank(s), "
                 f"straggler {diag['straggler']}: "
                 f"{diag['steps']} steps @ "
                 f"{diag['step_wall_ms']:.3f} ms/step")
    lines.append("")
    lines.append("  bucket          ms/step    fraction")
    wall = max(diag["step_wall_ms"], 1e-9)
    for b in BUCKETS:
        v = a["per_step_ms"].get(b, 0.0)
        if v <= 0:
            continue
        lines.append(f"  {b:<14}{_fmt_ms(v)}    {v / wall:6.1%}")
    check = "OK" if a["conserved"] else "FAILED"
    lines.append(f"  conservation: buckets sum to "
                 f"{sum(a['per_step_ms'].values()):.3f} ms vs wall "
                 f"{diag['step_wall_ms']:.3f} ms [{check}]")
    if a["hidden_ms"]:
        hid = ", ".join(f"{b} {v:.1f} ms" for b, v in
                        a["hidden_ms"].items())
        lines.append(f"  hidden (overlapped, off critical path): {hid}")
    lines.append("")
    top = diag["top_exposed_bucket"]
    lines.append(f"top exposed bucket: {top['bucket']} "
                 f"({top['ms_per_step']:.3f} ms/step, "
                 f"{top['fraction']:.1%} of step)")
    if top.get("remedy"):
        lines.append(f"  -> {top['remedy']}")
    lines.append(f"bubble fraction: {diag['bubble_fraction']:.1%}")
    if diag.get("comm_compute_ratio") is not None:
        lines.append(f"comm:compute ratio: "
                     f"{diag['comm_compute_ratio']:.3f}")
    if diag.get("transfer_hidden_fraction") is not None:
        lines.append(f"transfer hidden fraction: "
                     f"{diag['transfer_hidden_fraction']:.1%}")
    if a["segments"]:
        # raw per-name span time: nested spans of DIFFERENT names each
        # count (the bucket table above is the disjoint accounting)
        lines.append("busiest spans (raw span time, may nest):")
        for s in a["segments"][:5]:
            lines.append(f"  {s['ms']:9.1f} ms  {s['name']}")
    cdb = diag.get("costdb")
    if cdb:
        lines.append(f"cost DB: {cdb['entries']} entries "
                     f"({cdb['kinds']} kinds) at {cdb['path']}")
        if cdb["comm_gaps"]:
            lines.append(f"  coverage gaps: {cdb['comm_gaps']} — run "
                         f"python -m hetu_tpu_torch.telemetry.costdb "
                         f"--sweep")
    bench = diag.get("bench")
    if bench:
        lines.append("bench headline(s) beside the trace:")
        for name, rec in sorted(bench.items())[:8]:
            extra = "".join(
                f", {k}={rec[k]}" for k in
                ("step_ms_p50", "overlap_fraction") if k in rec)
            lines.append(f"  {name}: {rec.get('value')} "
                         f"{rec.get('unit', '')}{extra}")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.telemetry.doctor",
        description="trace analytics: per-step bucket attribution + "
                    "ranked perf diagnosis from a telemetry dir")
    parser.add_argument("telemetry", help="telemetry dir (per-rank "
                        "trace_rank*.json) or one trace file")
    parser.add_argument("--bench", default=None,
                        help="BENCH_*.json (or bench JSONL) to print "
                             "beside the attribution")
    parser.add_argument("--costdb", default=None,
                        help="cost DB path for the coverage report "
                             "(default: the standard DB if it exists)")
    parser.add_argument("--tolerance", type=float, default=0.10,
                        help="conservation tolerance (default 0.10)")
    parser.add_argument("--serving", action="store_true",
                        help="request-level serving attribution "
                             "(serve_request/serve_phase spans) instead "
                             "of step attribution")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    if not os.path.exists(args.telemetry):
        print(f"no such telemetry dir: {args.telemetry}",
              file=sys.stderr)
        return 2
    if args.serving:
        tol = args.tolerance if args.tolerance != 0.10 else 0.05
        diag = attribute_requests_dir(args.telemetry, tolerance=tol)
        if args.json:
            print(json.dumps(diag, indent=1, sort_keys=True))
        else:
            print(render_serving_text(diag))
        if not diag["requests"]:
            print("doctor: no serve_request spans in the trace "
                  "(was serving telemetry enabled?)", file=sys.stderr)
            return 1
        return 0 if diag["conserved"] and diag["complete"] else 1
    per_rank = attribute_trace(args.telemetry, tolerance=args.tolerance)
    db = None
    from .costdb import CostDB, default_db_path
    if args.costdb:
        db = CostDB(args.costdb)
    elif os.path.exists(default_db_path()):
        db = CostDB()
    bench = _bench_summary(args.bench) if args.bench else None
    diag = diagnose(per_rank, costdb=db, bench=bench,
                    tolerance=args.tolerance)
    if args.json:
        print(json.dumps(diag, indent=1, sort_keys=True))
    else:
        print(render_text(diag))
    if not per_rank:
        print("doctor: no step/step_block windows in the trace "
              "(was the run telemetry-enabled?)", file=sys.stderr)
        return 1
    return 0 if diag["conserved"] else 1


if __name__ == "__main__":
    sys.exit(main())
