"""Chrome trace-event schema validator:

    python -m hetu_tpu_torch.telemetry.check trace.json [more.json ...]

Used by the tests and as the CI gate on every exported/merged trace:
exit 0 with an event count when every file validates, exit 1 with the
first errors otherwise. ``validate()`` is the library form.

Beyond the structural Chrome-trace checks (required keys, known phase,
monotonic ts), known **span kinds carry a typed attr schema**: every
instrumentation site in the codebase registers its span name and attr
types in ``SPAN_SCHEMA`` below, and an exported trace whose known span
carries an attr of the wrong type — or an attr the schema has never
heard of — fails validation. That is the drift gate: a span attr
shipped with no schema could be silently misread by a consumer of the
trace. New span kinds/attrs must be added HERE.

Counterpart of ``hetu_tpu/telemetry/check.py``, with the same schema and
exit codes (0 valid, 1 invalid, 2 usage), plus the spans only the port
emits (``cpp_tick``). The schema also holds the names of modules that the
port has not ported yet, so traces of both packages check alike.
"""
from __future__ import annotations

import json
import sys

__all__ = ["validate", "main", "SPAN_SCHEMA", "check_args"]

_REQUIRED = ("name", "ph", "ts", "pid", "tid")
_KNOWN_PH = {"X", "B", "E", "i", "I", "M", "C", "b", "e", "n", "s", "t",
             "f"}

# attr-type vocabulary
_INT = (int,)
_NUM = (int, float)
_STR = (str,)
_BOOL = (bool,)
_DICT = (dict,)


def _opt(kinds):
    """Optional attr: absent is fine, wrong type is not."""
    return ("opt", kinds)


def _req(kinds):
    """Required attr: a producer that drops it regressed."""
    return ("req", kinds)


def _any():
    return ("opt", None)            # any JSON type (tags, labels)


# one entry per span/instant kind the codebase emits; key attrs typed,
# memory_* / per-candidate payloads validated loosely where the value
# set is open-ended. ``...`` (Ellipsis) allows arbitrary extra attrs
# for spans whose payload is a measurement dict (memory analysis).
SPAN_SCHEMA = {
    # executor (executor.py)
    "step": {"subgraph": _opt(_STR), "pipelined": _opt(_BOOL)},
    "step_block": {"steps": _req(_INT), "subgraph": _opt(_STR)},
    "jit_compile": {"subgraph": _opt(_STR), "shape_key": _opt(_STR),
                    "allreduce_defer": _opt(_INT), ...: True},
    "device_dispatch": {"subgraph": _opt(_STR)},
    "block_dispatch": {"steps": _opt(_INT), "subgraph": _opt(_STR)},
    "h2d_transfer": {"bytes": _req(_INT), "overlapped": _req(_BOOL)},
    "h2d_stacked": {"bytes": _req(_INT), "overlapped": _req(_BOOL)},
    "memory_analysis": {"label": _opt(_STR), ...: True},
    "step_logged": {"step": _opt(_INT), "wall_ms": _opt(_NUM)},
    # async ingest (ingest.py)
    "ingest_wait": {"tag": _any()},
    # PS runtime / client (ps/) — PSRuntime._phase emits every phase
    # as an argless ps:<name> span; registering them means a future
    # attr addition must land here (and in the doctor's classifier)
    "ps:pull": {"bytes": _req(_INT), "overlapped": _req(_BOOL)},
    "ps:drain_push": {"rows": _opt(_INT)},
    "ps:slot_assign": {}, "ps:miss_fill": {}, "ps:refresh": {},
    "ps:dispatch": {}, "ps:drain_submit": {}, "ps:dense": {},
    "ps:host_pull": {}, "ps:sync_push": {}, "ps:feed_ingest": {},
    "ps:prefetch": {}, "ps:repull": {},
    # pipeline (parallel/pipeline.py)
    "pp_stage_idle": {"stage": _req(_INT), "tag": _any(),
                      "bytes": _opt(_INT)},
    "pp_fill": {"warmup": _opt(_INT)},
    "pp_steady": {"ticks": _opt(_INT)},
    "pp_drain": {"ticks": _opt(_INT)},
    "pp_fwd_block": {"stage": _req(_INT)},
    "pp_bwd_block": {"stage": _req(_INT)},
    # p2p channel (parallel/p2p.py)
    "p2p_send": {"tag": _any(), "dst": _req(_INT), "bytes": _req(_INT)},
    "p2p_recv": {"tag": _any(), "bytes": _req(_INT)},
    # GroupComm's host-side collectives (ops/comm.py): the port's own
    # spans, one a call, its bytes and stats kind (the doctor's
    # ``collective`` bucket)
    "allreduce": {"bytes": _req(_INT), "kind": _req(_STR)},
    "collective_all_gather": {"bytes": _req(_INT), "kind": _req(_STR)},
    "collective_all_to_all": {"bytes": _req(_INT), "kind": _req(_STR)},
    "collective_ring": {"bytes": _req(_INT), "kind": _req(_STR)},
    # collective pipeline (parallel/collective_pp.py)
    "cpp_build": {},
    "cpp_pack_feeds": {"bytes": _opt(_INT)},
    "cpp_replicate_feeds": {},
    "cpp_dispatch": {"ticks": _req(_INT), "fill": _opt(_INT),
                     "drain": _opt(_INT), "fuse_ticks": _opt(_INT),
                     "stages": _opt(_INT), "microbatches": _opt(_INT),
                     "virtual_stages": _opt(_INT), "bytes": _opt(_INT)},
    # the port's collective pipeline issues each tick from the host: one
    # span a tick and lane (stage = the chunk)
    "cpp_tick": {"tick": _req(_INT), "stage": _req(_INT),
                 "microbatch": _req(_INT), "phase": _req(_STR)},
    # fleet monitor (telemetry/fleet.py): one fleet_watch span per
    # monitor poll (straggler attribution over the aligned step window),
    # one "drift" instant per CostDB drift verdict that tripped — both
    # strictly typed, no open payload (the post-hoc CLI and CI assert on
    # these fields).
    "fleet_watch": {"step": _req(_INT), "straggler": _opt(_INT),
                    "skew_ms": _req(_NUM), "victims": _opt(_INT),
                    "aligned": _opt(_BOOL), "ranks": _opt(_INT)},
    "drift": {"rank": _req(_INT), "kind": _req(_STR),
              "bytes": _opt(_INT), "measured_ms": _req(_NUM),
              "predicted_ms": _req(_NUM), "windows": _req(_INT),
              "tripped": _opt(_BOOL), "source": _opt(_STR)},
    # training health monitor (telemetry/health.py): one "health" span
    # per sampled check, one "health_trip" instant per ladder firing
    "health": {"step": _req(_INT), "layers": _opt(_INT),
               "trips": _opt(_INT)},
    "health_trip": {"step": _req(_INT), "kind": _req(_STR),
                    "layer": _opt(_STR), "table": _opt(_STR),
                    "value": _opt(_NUM), "limit": _opt(_NUM)},
    # serving request lifecycle (serving/lifecycle.py + scheduler.py):
    # one serve_request span per retired request (submit -> retire), one
    # serve_phase span per recorded episode (queue / prefill / decode /
    # replay), one serve_preempt instant per preemption. request_id is
    # the end-to-end tracing id minted at ingress; the serving doctor
    # keys its per-request conservation check on these — typed strictly,
    # no open payload.
    "serve_request": {"request_id": _req(_STR), "tokens": _req(_INT),
                      "preempts": _req(_INT), "phase": _opt(_STR)},
    # prefill episodes under the prefix cache split prompt tokens into
    # cache-resolved vs chip-computed (admission charged only the
    # latter) — the doctor's cache-efficacy attribution keys on these
    "serve_phase": {"request_id": _req(_STR), "phase": _req(_STR),
                    "tokens": _opt(_INT), "cached_tokens": _opt(_INT),
                    "computed_tokens": _opt(_INT)},
    "serve_preempt": {"request_id": _req(_STR), "tokens": _opt(_INT)},
    # one span per chunked/suffix prefill dispatch (scheduler.py
    # _prefill_suffix_step): seqs in the group, computed (real, unpadded)
    # tokens, the pow2 chunk bucket dispatched, and prefix-cache tokens
    # resolved for sequences on their first chunk
    "serve_prefill_chunk": {"seqs": _req(_INT), "tokens": _req(_INT),
                            "bucket": _opt(_INT), "cached": _opt(_INT)},
    # autotuner / probe (tune/)
    "autotune_sweep": {"kernel": _req(_STR), "key": _req(_STR),
                       "chosen": _req(_STR), "picked_ms": _req(_NUM),
                       "candidates_ms": _req(_DICT)},
    "attn_probe": {"kernel": _opt(_STR), "ms": _opt(_NUM),
                   "blocks": _opt(_STR), "seq": _opt(_INT),
                   "head_dim": _opt(_INT), "dtype": _opt(_STR)},
}


def check_args(name, args):
    """Validate one event's ``args`` against SPAN_SCHEMA. Returns a
    list of error strings (empty = clean). Spans not in the schema are
    user spans — unchecked."""
    schema = SPAN_SCHEMA.get(name)
    if schema is None:
        return []
    if args is not None and not isinstance(args, dict):
        # a malformed trace must report INVALID, not traceback the gate
        return [f"span {name!r}: args must be an object, got "
                f"{type(args).__name__}"]
    errors = []
    open_ended = schema.get(..., False)
    args = args or {}
    for key, value in args.items():
        spec = schema.get(key)
        if spec is None:
            if open_ended:
                continue
            errors.append(
                f"span {name!r}: unknown attr {key!r} — register it in "
                f"telemetry.check.SPAN_SCHEMA (drift gate)")
            continue
        _, kinds = spec
        if kinds is None or value is None:
            continue
        # bool is an int subclass: an int-typed attr must not accept a
        # bool, and a bool-typed attr must be exactly bool
        if kinds == _BOOL:
            ok = isinstance(value, bool)
        elif isinstance(value, bool):
            ok = False
        else:
            ok = isinstance(value, kinds)
        if not ok:
            errors.append(
                f"span {name!r}: attr {key!r} has type "
                f"{type(value).__name__}, expected "
                f"{'/'.join(k.__name__ for k in kinds)}")
    for key, spec in schema.items():
        if key is ... or spec[0] != "req":
            continue
        if key not in args:
            errors.append(
                f"span {name!r}: required attr {key!r} missing")
    return errors


def validate(path, check_attrs=True):
    """Validate one trace file; returns (n_events, errors).
    ``check_attrs=False`` skips the span-attr schema (structural checks
    only — foreign traces)."""
    errors = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return 0, [f"{path}: unreadable JSON: {e}"]
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return 0, [f"{path}: no 'traceEvents' list"]
    elif isinstance(doc, list):
        events = doc
    else:
        return 0, [f"{path}: top level must be an object or array"]

    last_ts = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            errors.append(f"event {i} ({ev.get('name')!r}): missing "
                          f"keys {missing}")
            continue
        ph = ev["ph"]
        if ph not in _KNOWN_PH:
            errors.append(f"event {i}: unknown ph {ph!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            errors.append(f"event {i}: bad ts {ev['ts']!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: 'X' event needs dur >= 0 "
                              f"(got {dur!r})")
        if check_attrs and ph in ("X", "i", "I"):
            for e in check_args(ev["name"], ev.get("args")):
                errors.append(f"event {i}: {e}")
        if ph != "M":
            # exporters sort non-metadata events: ts must be monotonic
            # non-decreasing so Perfetto's sequential parsers stay happy
            if last_ts is not None and ev["ts"] < last_ts:
                errors.append(
                    f"event {i}: ts {ev['ts']} < previous {last_ts} "
                    f"(non-monotonic)")
            last_ts = ev["ts"]
        if len(errors) >= 20:
            errors.append("... (truncated)")
            break
    return len(events), errors


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    check_attrs = True
    if "--no-attrs" in argv:
        argv = [a for a in argv if a != "--no-attrs"]
        check_attrs = False
    if not argv:
        print("usage: python -m hetu_tpu_torch.telemetry.check [--no-attrs] "
              "<trace.json>...", file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        n, errors = validate(path, check_attrs=check_attrs)
        if errors:
            rc = 1
            print(f"{path}: INVALID ({len(errors)} errors)")
            for e in errors:
                print(f"  {e}")
        else:
            print(f"{path}: OK ({n} events)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
