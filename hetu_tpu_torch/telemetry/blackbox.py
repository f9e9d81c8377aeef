"""Post-mortem black-box analyzer:

    python -m hetu_tpu_torch.telemetry.blackbox DIR [--json]

Merges the per-rank flight-record dumps (``flight_rank<r>.json``) and
heartbeat files (``hb_rank<r>.json``) a failed ``heturun`` fleet left
under its telemetry directory and names the guilty rank without a
rerun:

* **dead ranks** — heartbeat present but no flight dump (the process
  died without reaching its SIGTERM/excepthook dumper: SIGKILL, OOM
  kill, segfault) or a rank other dumps expected that left no files;
* **first collective seq divergence** — ``collective``-group events
  are SPMD-symmetric, so the first sequence number some rank recorded
  that another never reached names who entered a collective the others
  didn't;
* **pending operations** — events enqueued but never completed (a
  ``p2p_recv`` stuck waiting on a peer names that peer); pending PS
  RPCs are cross-referenced against the wire contract
  (``analysis/wire.py``): the verdict names the op on the wire, the
  response framing the thread was blocked decoding, the server shard
  the tensor id maps to, and whether that server was among the dead
  ranks;
* **last completed step per rank** — the MegaScale-style straggler
  view; when the fleet plane was armed (``heturun --watch``), the
  flushed ``timeline_rank<r>.jsonl`` files upgrade this to a measured
  STRAGGLER line — which rank's own work was slow, by how much, and
  which ranks were victims waiting on it (telemetry/fleet.py);
* **training health** — when the run's health monitor left
  ``health_rank<r>.jsonl`` files (telemetry/health.py), the verdict
  also names the first bad step and the tripped layer/table, so a
  post-mortem on a health-tripped run reads as one story: which rank
  died AND where the numerics first went wrong;
* **in-flight serving requests** — when the crash dump rode beside a
  serving plane, ``Telemetry.flush()`` also wrote
  ``requests_rank<r>.json`` (serving/lifecycle.py): the per-component
  in-flight request tables at the moment of death. A crashed or
  watchdogged engine's verdict then names the stuck requests — id,
  phase, tokens done/budget, preempt count, age — instead of only the
  guilty rank.

Exit codes: 0 = report produced, 2 = nothing to analyze.

Counterpart of ``hetu_tpu/telemetry/blackbox.py``, reading the files the
port writes: ``flight_rank<r>.json`` (flight.py), ``hb_rank<r>.json``
(watchdog.py), ``requests_rank<r>.json`` (``Telemetry.flush``) and
``health_rank<r>.jsonl`` (health.py), and the fleet plane's
``timeline_rank<r>.jsonl`` (fleet.py: the STRAGGLER line). The wire
cross-reference stays an optional augmentation: ``analysis/wire.py`` is
not ported yet (ROADMAP item 17), so it finds nothing. Imports no torch:
the CLI runs where no card is.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

__all__ = ["analyze", "format_report", "main"]


def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _rank_of(path, prefix):
    m = re.search(rf"{prefix}_rank(\d+)\.json$", path)
    return int(m.group(1)) if m else None


def _wire_annotate(pending, meta, dead_ranks):
    """Cross-reference pending PS RPCs against the wire contract
    (analysis/wire.py): name the op on the wire, the response framing
    the thread is blocked decoding, the server shard the tensor id maps
    to (``tid % nservers``, single-part placement), and whether that
    server index is among the dead ranks of the verdict (co-scheduled
    server/worker fleets — the common ``heturun`` layout — number the
    server process with the rank it rode along with)."""
    try:
        # looked for before importing: the analysis package's other
        # passes import torch, which this CLI never needs
        if not os.path.exists(os.path.join(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))), "analysis",
                "wire.py")):
            return
        from ..analysis.wire import rpc_contract
        contract = rpc_contract()
    except Exception:           # noqa: BLE001 — augmentation only
        contract = {}
    if not contract:
        return
    nservers = int(meta.get("ps_nservers", 0) or 0)
    nreplicas = int(meta.get("ps_nreplicas", 1) or 1)
    for ev in pending:
        if ev.get("group") != "ps":
            continue
        c = contract.get(ev.get("kind"))
        if c is None:
            continue
        info = {"op": c["op"], "response": c["response"],
                "blocking": c["blocking"]}
        m = re.match(r"tid(\d+)$", str(ev.get("tag") or ""))
        if m and nservers:
            server = int(m.group(1)) % nservers
            info["server"] = server
            info["nservers"] = nservers
            if nreplicas > 1:
                # replicated shards: a pending RPC against a
                # dead primary is survivable — the client flips to the
                # backup replica and replays its acked window
                info["nreplicas"] = nreplicas
            if server in dead_ranks:
                info["server_dead"] = True
        ev["wire"] = info


def analyze(tdir):
    """Analyze one telemetry directory; returns a plain-dict report."""
    dumps, beats = {}, {}
    for path in glob.glob(os.path.join(tdir, "flight_rank*.json")):
        r = _rank_of(path, "flight")
        doc = _load_json(path)
        if r is not None and doc is not None:
            dumps[r] = doc
    for path in glob.glob(os.path.join(tdir, "hb_rank*.json")):
        r = _rank_of(path, "hb")
        doc = _load_json(path)
        if r is not None and doc is not None:
            beats[r] = doc
    # serving in-flight request tables dumped by Telemetry.flush()
    # beside the flight rings (serving/lifecycle.py:dump_inflight)
    serving = {}
    for path in glob.glob(os.path.join(tdir, "requests_rank*.json")):
        r = _rank_of(path, "requests")
        doc = _load_json(path)
        if r is not None and doc is not None:
            serving[r] = doc

    expected = set(beats) | set(dumps)
    for doc in list(dumps.values()) + list(beats.values()):
        n = int(doc.get("nprocs", 0) or 0)
        if n > 1:
            expected |= set(range(n))
    if not expected and not serving:
        return None
    expected |= set(serving)

    ranks = {}
    for r in sorted(expected):
        hb = beats.get(r)
        dump = dumps.get(r)
        pending = []
        last_seq = {}
        if dump:
            for ev in dump.get("events", []):
                g = ev.get("group")
                s = ev.get("seq", -1)
                if g is not None and s > last_seq.get(g, -1):
                    last_seq[g] = s
                if ev.get("t1") is None:
                    pending.append(ev)
        last_step = -1
        if dump and dump.get("last_step", -1) >= 0:
            last_step = int(dump["last_step"])
        elif hb:
            last_step = int(hb.get("step", -1))
        ranks[r] = {
            "rank": r,
            "heartbeat": bool(hb),
            "heartbeat_done": bool(hb and hb.get("done")),
            "heartbeat_time": float(hb["time"]) if hb else None,
            "flight_dump": bool(dump),
            "dump_reason": dump.get("reason") if dump else None,
            "last_step": last_step,
            "last_seq": last_seq,
            "pending": pending,
            "meta": (dump.get("meta") or {}) if dump else {},
        }

    # -- dead ranks: expected but dumped nothing -------------------------
    dead = [r for r, info in ranks.items()
            if not info["flight_dump"] and not info["heartbeat_done"]]

    # -- wire-contract view of pending PS RPCs ---------------------------
    for info in ranks.values():
        _wire_annotate(info["pending"], info["meta"], set(dead))

    # -- first collective seq divergence ---------------------------------
    divergence = None
    coll_last = {r: info["last_seq"].get("collective", -1)
                 for r, info in ranks.items() if info["flight_dump"]}
    if len(coll_last) >= 2 and len(set(coll_last.values())) > 1:
        floor = min(coll_last.values())
        behind = sorted(r for r, s in coll_last.items() if s == floor)
        ahead = sorted(r for r, s in coll_last.items() if s > floor)
        first_extra = None
        for r in ahead:
            for ev in dumps[r].get("events", []):
                if ev.get("group") == "collective" and \
                        ev.get("seq", -1) == floor + 1:
                    first_extra = ev
                    break
            if first_extra:
                break
        divergence = {"seq": floor + 1, "ahead": ahead, "behind": behind,
                      "event": first_extra}

    # -- straggler / suspect naming --------------------------------------
    waited_on = sorted({ev.get("peer") for info in ranks.values()
                        for ev in info["pending"]
                        if isinstance(ev.get("peer"), int)})
    suspects = sorted(set(dead))
    if not suspects and divergence:
        suspects = list(divergence["behind"])
    if not suspects and waited_on:
        suspects = waited_on
    if not suspects:
        steps = {r: info["last_step"] for r, info in ranks.items()
                 if info["last_step"] >= 0}
        if steps and len(set(steps.values())) > 1:
            lag = min(steps.values())
            suspects = sorted(r for r, s in steps.items() if s == lag)

    # -- training health (health_rank<r>.jsonl, when present) ------------
    health = None
    try:
        from . import health as _health
        health = _health.summarize_for_blackbox(tdir)
    except Exception:           # noqa: BLE001 — augmentation only
        health = None
    if not suspects and health and health.get("bad_ranks"):
        suspects = list(health["bad_ranks"])

    # -- fleet straggler (timeline_rank<r>.jsonl, when present) ----------
    fleet_sum = None
    try:
        from . import fleet as _fleet
        fleet_sum = _fleet.summarize_for_blackbox(tdir)
    except Exception:           # noqa: BLE001 — augmentation only
        fleet_sum = None
    if not suspects and fleet_sum:
        suspects = [fleet_sum["straggler"]]

    # -- serving in-flight requests (requests_rank<r>.json) --------------
    serving_report = None
    if serving:
        serving_report = {}
        for r, doc in sorted(serving.items()):
            rows = []
            for comp in doc.get("components", []) or []:
                for req in comp.get("requests", []) or []:
                    if isinstance(req, dict):
                        row = dict(req)
                        row["component"] = comp.get("name")
                        rows.append(row)
            serving_report[str(r)] = {
                "stuck_requests": rows,
                "components": [{"name": c.get("name"),
                                "kind": c.get("kind"),
                                "stats": c.get("stats")}
                               for c in doc.get("components", []) or []]}

    return {"dir": tdir,
            "ranks": {str(r): info for r, info in ranks.items()},
            "dead_ranks": dead,
            "divergence": divergence,
            "waited_on_ranks": waited_on,
            "health": health,
            "fleet": fleet_sum,
            "serving": serving_report,
            "suspect_ranks": suspects}


def format_report(rep):
    lines = [f"black box: {rep['dir']}"]
    for key in sorted(rep["ranks"], key=int):
        info = rep["ranks"][key]
        r = info["rank"]
        bits = []
        if info["heartbeat_done"]:
            bits.append("finished cleanly")
        elif not info["flight_dump"]:
            bits.append("NO flight dump"
                        + (" (heartbeat present — died without dumping)"
                           if info["heartbeat"] else " and NO heartbeat"))
        else:
            bits.append(f"dump reason: {info['dump_reason']!r}")
        bits.append(f"last step {info['last_step']}")
        if info["last_seq"]:
            seqs = ", ".join(f"{g}={s}" for g, s in
                             sorted(info["last_seq"].items()))
            bits.append(f"last seq {seqs}")
        lines.append(f"  rank {r}: " + "; ".join(bits))
        for ev in info["pending"][:5]:
            where = ev.get("tag") or ev.get("kind")
            peer = ev.get("peer")
            line = (f"    PENDING {ev.get('kind')} seq={ev.get('seq')} "
                    f"tag={where!r}"
                    + (f" waiting on rank {peer}"
                       if peer is not None else ""))
            wire = ev.get("wire")
            if wire:
                bits = [wire["op"]]
                if wire.get("server") is not None:
                    shard = (f"server {wire['server']}/"
                             f"{wire['nservers']}")
                    if wire.get("nreplicas"):
                        shard += (f" x{wire['nreplicas']} replicas "
                                  f"(client fails over)")
                    bits.append(shard)
                bits.append("awaiting " + wire["response"] + " response"
                            if wire["blocking"]
                            else "fire-and-forget (" + wire["response"]
                            + ")")
                if wire.get("server_dead"):
                    bits.append("SERVER AMONG DEAD RANKS")
                line += "  [" + "; ".join(bits) + "]"
            lines.append(line)
    if rep["divergence"]:
        d = rep["divergence"]
        ev = d.get("event") or {}
        lines.append(
            f"  DIVERGENCE at collective seq {d['seq']}: rank(s) "
            f"{d['ahead']} entered {ev.get('kind', '?')!r} that rank(s) "
            f"{d['behind']} never did")
    if rep["dead_ranks"]:
        lines.append(f"  DEAD rank(s): {rep['dead_ranks']} — no flight "
                     f"dump; killed before any handler could run")
    health = rep.get("health")
    if health:
        if health.get("healthy"):
            lines.append(
                f"  HEALTH: no trips through step {health['last_step']}"
                f" (loss_finite="
                f"{str(health.get('loss_finite')).lower()})")
        else:
            what = ", ".join(health.get("trip_kinds") or []) or "trip"
            where = ""
            if health.get("layer"):
                where += f" layer {health['layer']!r}"
            if health.get("table"):
                where += f" table {health['table']}"
            lines.append(
                f"  HEALTH: first bad step {health['first_bad_step']} "
                f"on rank {health['bad_rank']} ({what}{where}) — "
                f"`python -m hetu_tpu_torch.telemetry.health {rep['dir']}` "
                f"for the ranked causes")
    fleet = rep.get("fleet")
    if fleet:
        lines.append(
            f"  STRAGGLER rank {fleet['straggler']} at step "
            f"{fleet['step']}: self {fleet['self_ms']}ms "
            f"({fleet['skew_ms']}ms over the fleet median, top bucket "
            f"{fleet['top_bucket']!r})"
            + (f"; victims (grown wait): {fleet['victims']}"
               if fleet.get("victims") else "")
            + f" — `python -m hetu_tpu_torch.telemetry.fleet {rep['dir']}` "
              f"for the full table")
    serving = rep.get("serving")
    if serving:
        for key in sorted(serving, key=int):
            rows = serving[key]["stuck_requests"]
            if not rows:
                continue
            lines.append(f"  SERVING rank {key}: {len(rows)} request(s) "
                         f"in flight when the dump was taken")
            for row in rows[:5]:
                bits = [f"phase={row.get('phase')!r}"]
                if row.get("tokens_budget") is not None:
                    bits.append(f"tokens {row.get('tokens_done', 0)}/"
                                f"{row['tokens_budget']}")
                if row.get("kv_blocks"):
                    bits.append(f"{row['kv_blocks']} KV blocks held")
                if row.get("preempts"):
                    bits.append(f"{row['preempts']} preempt(s)")
                if row.get("age_ms") is not None:
                    bits.append(f"age {row['age_ms']:.0f}ms")
                lines.append(f"    STUCK {row.get('request_id')!r} "
                             f"[{row.get('component')}]: "
                             + "; ".join(bits))
            if len(rows) > 5:
                lines.append(f"    ... and {len(rows) - 5} more")
    if rep["suspect_ranks"]:
        lines.append(f"  SUSPECT rank(s): {rep['suspect_ranks']}")
    else:
        lines.append("  no divergence or dead rank detected")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.telemetry.blackbox",
        description="merge per-rank flight-record dumps and name the "
                    "guilty rank")
    parser.add_argument("dir", help="telemetry directory with "
                                    "flight_rank*.json / hb_rank*.json")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable report")
    args = parser.parse_args(argv)
    rep = analyze(args.dir)
    if rep is None:
        print(f"{args.dir}: no flight dumps or heartbeats found",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(rep, indent=2, default=str))
    else:
        print(format_report(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
