"""Benchmark regression gate:

    python -m hetu_tpu_torch.telemetry.regress OLD.json NEW.json

Compares two ``BENCH_*.json`` files (or raw bench JSONL output)
metric-by-metric and exits nonzero when any metric regressed past the
tolerance (``--tolerance``, default 0.15) — the check CI runs so a
perf PR can't silently give back a previous PR's win.

Metric direction is inferred from the unit: ``ms/...`` and plain time
units regress when the value goes UP; ``.../sec...`` throughput units
regress when it goes DOWN. ``error`` units and metrics present in only
one file are reported but never fail the gate (a new benchmark is not
a regression).

Counterpart of ``hetu_tpu/telemetry/regress.py``, the same module: it
reads JSON and imports neither torch nor numpy, so the CLI runs where no
card is (``python -m hetu_tpu_torch.telemetry.regress`` skips the
package's torch import, ``hetu_tpu_torch/__init__.py``).
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["load_metrics", "compare", "history", "history_markdown",
           "main"]

_LOWER_IS_BETTER = ("ms", "seconds", "s/step", "s/epoch")
_HIGHER_IS_BETTER = ("/sec", "samples", "tokens", "flops", "rate")

# per-record extra fields the gate also compares when both sides carry
# them — the unit heuristic can't see these (they ride on the metric
# record, not as their own metric). Value: True = lower is better.
# overlap_fraction is the ingest engine's host-hidden share (ingest.py)
# — HIGHER is better; ingest_wait_ms is device-waited-on-host — lower.
# bubble_fraction is the pipeline's analytic idle share (pipeline.py)
# — lower; autoplan_vs_hand is the planner's throughput ratio against
# the best hand config (parallel/autoplan.py) — higher. serve_p99_ms is
# the continuous-batching bench's closed-loop request tail latency
# (bench_serving_continuous) — lower; kv_hbm_utilization is its peak
# paged-pool occupancy (serving/kvcache.py) — higher means the blocks
# provisioned against the HBM budget actually carry traffic.
# (serving_tokens_per_sec_per_chip needs no entry: it's a metric of its
# own and "tokens...": the unit heuristic already reads it higher-is-
# better.)
_FIELD_DIRECTION = {"overlap_fraction": False, "ingest_wait_ms": True,
                    "bubble_fraction": True, "autoplan_vs_hand": False,
                    "serve_p99_ms": True, "kv_hbm_utilization": False,
                    # request-level serving percentiles stamped by
                    # bench_serving_continuous from the doctor's
                    # per-request attribution (serving/lifecycle.py):
                    # time-to-first-token tail, median per-token decode
                    # latency, and queue-wait tail — all latencies, all
                    # lower-is-better
                    "serve_ttft_p99_ms": True,
                    "serve_tpot_p50_ms": True,
                    "serve_queue_wait_p99_ms": True,
                    # prefix-cache efficacy (bench_serving_prefix):
                    # token-weighted share of prompt tokens the cache
                    # resolved instead of prefilling — higher; a drop
                    # means the cache stopped matching (keying or
                    # eviction regression), which silently re-inflates
                    # TTFT and prefill FLOPs
                    "serve_prefix_hit_rate": False,
                    # fault-tolerant PS fields (bench_wdl_ps_scale):
                    # scale_vs_1s is the 4-server/1-server throughput
                    # ratio — higher; spill_hit_rate is the share of
                    # tiered-store row reads the DRAM pool absorbed
                    # rather than the disk spill file — higher (a drop
                    # means the measured-hot pre-warm stopped keeping
                    # the working set resident); ps_row_bytes is the
                    # quantized on-server row stride — lower.
                    # ps_failover_recovery_s (kill-to-next-acked-push
                    # on the backup) is its own metric with a
                    # "seconds" unit (already lower-is-better); the
                    # entry covers it if it ever rides as a field.
                    "scale_vs_1s": False,
                    "spill_hit_rate": False,
                    "ps_row_bytes": True,
                    "ps_failover_recovery_s": True}

# informational per-record fields: the health monitor's stamps
# (telemetry/health.py — a loss_finite flip is a broken run to
# investigate, not a perf ratio) and the efficiency verifier's
# (analysis/efficiency.py — estimated_ms_per_step is the *predicted*
# per-step waste from the HT9xx priced lint and ht9xx_findings its
# finding count; both are model outputs, not measurements, so a move
# means the model changed, never that the build regressed). Reported
# on their face, NEVER direction-compared.
_INFORMATIONAL_FIELDS = ("loss_finite", "grad_norm_final",
                         "estimated_ms_per_step", "ht9xx_findings")


def _metric_lines(text):
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "metric" in rec and "value" in rec:
            out[rec["metric"]] = rec
    return out


def load_metrics(path):
    """{metric: record} from a BENCH_*.json run file (metric JSONL
    in its ``tail``), a raw JSONL dump, or a JSON list of records."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        return _metric_lines(text)          # raw JSONL
    if isinstance(doc, dict) and "metric" in doc and "value" in doc:
        return {doc["metric"]: doc}
    if isinstance(doc, dict):               # BENCH_*.json run format
        return _metric_lines(doc.get("tail", ""))
    if isinstance(doc, list):
        return {rec["metric"]: rec for rec in doc
                if isinstance(rec, dict) and "metric" in rec}
    return {}


def _lower_is_better(unit):
    # time units first: "ms/step" must not trip the "/sec" throughput
    # match by substring accident
    u = (unit or "").lower()
    if u.startswith(("ms", "s/", "us", "ns")) or \
            any(k in u for k in _LOWER_IS_BETTER):
        return True
    if any(k in u for k in _HIGHER_IS_BETTER) or u.endswith("/s"):
        return False
    return False            # unknown units treated as throughput-like


def compare(old, new, tolerance):
    """[(metric, old, new, ratio, status)] — status in
    {'ok', 'improved', 'REGRESSED', 'new', 'removed', 'skipped'}."""
    rows = []
    for name in sorted(set(old) | set(new)):
        o, n = old.get(name), new.get(name)
        if o is None:
            rows.append((name, None, n["value"], None, "new"))
            continue
        if n is None:
            rows.append((name, o["value"], None, None, "removed"))
            continue
        unit = n.get("unit") or o.get("unit")
        if unit == "error" or o.get("unit") == "error":
            rows.append((name, o.get("value"), n.get("value"), None,
                         "skipped"))
            continue
        ov, nv = float(o["value"]), float(n["value"])
        if ov == 0:
            rows.append((name, ov, nv, None, "skipped"))
            continue
        # ratio > 1 means NEW is better, whatever the direction
        ratio = (ov / nv) if _lower_is_better(unit) else (nv / ov)
        if ratio < 1.0 - tolerance:
            status = "REGRESSED"
        elif ratio > 1.0 + tolerance:
            status = "improved"
        else:
            status = "ok"
        rows.append((name, ov, nv, ratio, status))
        for field, lower in _FIELD_DIRECTION.items():
            if field not in o or field not in n:
                continue
            fo, fn = float(o[field]), float(n[field])
            if fo == 0:
                rows.append((f"{name}.{field}", fo, fn, None, "skipped"))
                continue
            if lower and fn == 0:
                # e.g. ingest_wait_ms dropping to exactly 0.0 — the
                # number this field exists to drive down; not a divide
                rows.append((f"{name}.{field}", fo, fn, float("inf"),
                             "improved"))
                continue
            fr = (fo / fn) if lower else (fn / fo)
            if fr < 1.0 - tolerance:
                fs = "REGRESSED"
            elif fr > 1.0 + tolerance:
                fs = "improved"
            else:
                fs = "ok"
            rows.append((f"{name}.{field}", fo, fn, fr, fs))
        for field in _INFORMATIONAL_FIELDS:
            if field in o or field in n:
                rows.append((f"{name}.{field}", o.get(field),
                             n.get(field), None, "info"))
    return rows


def _round_label(path):
    """Short column label for a bench round file: BENCH_r05.json ->
    r05; anything else keeps its basename stem."""
    import os
    stem = os.path.splitext(os.path.basename(path))[0]
    if stem.startswith("BENCH_"):
        return stem[len("BENCH_"):]
    return stem


def history(paths):
    """Metric trajectories across ALL bench rounds, not just two files:
    returns (labels, {metric: {"unit": u, "values": [v_or_None per
    round]}}) in the given file order. A two-file compare answers "did
    this PR regress"; the trajectory answers "where did this metric's
    history bend" without opening five round files by hand."""
    labels = [_round_label(p) for p in paths]
    rounds = [load_metrics(p) for p in paths]
    names = sorted({n for r in rounds for n in r})
    table = {}
    for name in names:
        # unit from the first round with a REAL record: a unit that
        # errored in r01 but recovered later must keep its trajectory
        unit = next((r[name].get("unit") for r in rounds
                     if name in r and r[name].get("unit") != "error"),
                    None)
        if unit is None:
            continue                # errored in every round
        values = []
        for r in rounds:
            rec = r.get(name)
            try:
                v = None if rec is None or rec.get("unit") == "error" \
                    else float(rec["value"])
            except (TypeError, ValueError):
                v = None            # structured values (phase dicts)
            values.append(v)
        if any(v is not None for v in values):
            table[name] = {"unit": unit, "values": values}
    return labels, table


def history_markdown(labels, table, tolerance=0.15):
    """Markdown trajectory table: one row per metric, one column per
    round, the last column calling the latest-vs-previous move
    (improved / REGRESSED / ok by the unit-inferred direction)."""
    lines = ["| metric | unit | " + " | ".join(labels) + " | trend |",
             "|---|---|" + "---|" * (len(labels) + 1)]
    for name in sorted(table):
        row = table[name]
        vals = row["values"]
        cells = ["-" if v is None else f"{v:g}" for v in vals]
        # the trend column calls the LATEST round's move; a missing/
        # errored latest value is "-", never a verdict about two older
        # rounds
        last = vals[-1]
        prior = [v for v in vals[:-1] if v is not None]
        if last is None:
            trend = "-"
        elif not prior:
            trend = "new"
        else:
            prev = prior[-1]
            if prev == 0 or last == 0:
                # bench rounds values: a sub-0.05ms step lands as 0.0;
                # a zero on either side has no meaningful ratio
                trend = "improved" if last == 0 and prev > 0 \
                    and _lower_is_better(row["unit"]) else "-"
            else:
                ratio = (prev / last) if _lower_is_better(row["unit"]) \
                    else (last / prev)
                if ratio < 1.0 - tolerance:
                    trend = f"REGRESSED x{ratio:.2f}"
                elif ratio > 1.0 + tolerance:
                    trend = f"improved x{ratio:.2f}"
                else:
                    trend = "ok"
        lines.append(f"| {name} | {row['unit'] or ''} | "
                     + " | ".join(cells) + f" | {trend} |")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.telemetry.regress",
        description="compare two bench result files metric-by-metric "
                    "(exit 1 on regression), or --history over ALL "
                    "rounds for a markdown trajectory table")
    parser.add_argument("files", nargs="+",
                        help="BENCH_*.json (or JSONL) files: exactly "
                             "two (old new) without --history, any "
                             "number in round order with it")
    parser.add_argument("--history", action="store_true",
                        help="emit a metric-trajectory markdown table "
                             "across every given round file instead of "
                             "gating two")
    parser.add_argument("--markdown", default=None, metavar="PATH",
                        help="with --history: also write the table to "
                             "this file (the CI artifact)")
    parser.add_argument("--tolerance", type=float, default=0.15,
                        help="relative slack before a metric counts as "
                             "regressed (default 0.15)")
    parser.add_argument("--warn-only", action="store_true",
                        help="report regressions but exit 0 anyway "
                             "(CI on CPU runners, where absolute bench "
                             "numbers are not comparable to the "
                             "committed baseline). Machinery "
                             "failures — unparseable inputs — still "
                             "exit 2: a broken pipeline is not a perf "
                             "delta")
    args = parser.parse_args(argv)
    if args.history:
        try:
            labels, table = history(args.files)
        except OSError as e:
            print(f"cannot read bench file: {e}", file=sys.stderr)
            return 2
        if not table:
            print("no metrics parsed from any round file",
                  file=sys.stderr)
            return 2
        md = history_markdown(labels, table,
                              tolerance=args.tolerance)
        print(md)
        if args.markdown:
            with open(args.markdown, "w") as f:
                f.write(f"# Bench trajectory ({len(labels)} rounds)\n\n"
                        + md + "\n")
        return 0
    if len(args.files) != 2:
        print("exactly two files (old new) required without --history",
              file=sys.stderr)
        return 2
    old_path, new_path = args.files
    try:
        old, new = load_metrics(old_path), load_metrics(new_path)
    except OSError as e:
        # unreadable input = broken machinery (exit 2, never the
        # perf-regression exit 1, never suppressed by --warn-only)
        print(f"cannot read bench file: {e}", file=sys.stderr)
        return 2
    if not old or not new:
        # broken machinery, not a perf delta: fails even under
        # --warn-only (which scopes to regressions only)
        print(f"no metrics parsed ({old_path}: {len(old)}, "
              f"{new_path}: {len(new)})", file=sys.stderr)
        return 2
    rows = compare(old, new, args.tolerance)
    regressed = 0
    for name, ov, nv, ratio, status in rows:
        if status == "info":
            print(f"{status:>10}  {name}  {ov} -> {nv}")
            continue
        if status in ("new", "removed", "skipped"):
            print(f"{status:>10}  {name}")
            continue
        if status == "REGRESSED":
            regressed += 1
        print(f"{status:>10}  {name}  {ov:g} -> {nv:g}  "
              f"(x{ratio:.3f} vs tolerance {1 - args.tolerance:.2f})")
    print(f"{regressed} regression(s) past tolerance "
          f"{args.tolerance:g} over {len(rows)} metric(s)"
          + (" [warn-only]" if args.warn_only else ""))
    if args.warn_only:
        return 0
    return 1 if regressed else 0


if __name__ == "__main__":
    sys.exit(main())
