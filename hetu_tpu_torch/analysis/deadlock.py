"""Pass 3 — static deadlock detection for pipeline schedules (HT3xx).

Counterpart of ``hetu_tpu/analysis/deadlock.py``. A define-then-run
session knows its whole communication schedule before launch: stages
come from the device contexts (``parallel/pipeline.py``
``_build_stages``), ranks from ``_owner_of``, and the issue order from
the schedule drivers (the GPipe sweep, ``_drive_1f1b``). This pass
rebuilds that schedule symbolically — per rank, an ordered program of
send/recv/collective events with the tags the runtime uses — and runs
it over a buffered channel model (the p2p channel's reader threads
drain the sockets, so sends never block; only recvs do). A schedule
that cannot drain is a fleet that hangs at step 0 until the watchdog
kills it after ``--hang-timeout`` seconds; here it is a finding naming
the blocked ranks, before any worker starts.

A tuple stage is run by a rank a device, as the port runs it
(``PipelineSubExecutor._plan_stages``): device *i* of the stage's
tuple context belongs to the owner of its hostname, a tuple stage
whose statuses split nothing keeps its first rank alone, and rank *k*
of a reading stage takes a boundary from rank *k* mod width of the
stage that makes it (``_hand_over`` / ``_take``). A stage of one device
is one rank, and there the programs are the JAX package's.

Error codes
-----------
HT301  recv never satisfied (no rank ever sends the tag)        error
HT302  cyclic wait between ranks (true deadlock)                error
HT303  collective issue order diverges across ranks             error
HT304  unpaired pipeline send/recv markers                      error
HT305  send never received (orphan boundary transfer)           warn
HT306  collective-pipeline contract violation (non-linear
       chain, loss off the last stage, ...)                     error
HT307  stage consumes a boundary produced by a LATER stage on
       the same rank (forward schedule order violation)         error
HT308  interleaved (virtual-stage) schedule without round-robin
       stage ownership — the runtime refuses it at construction
       and the bubble reduction is forfeited                    error

The ``interleaved_1f1b`` schedule (``pp_options virtual_stages > 1``,
stages placed round-robin so each rank owns V chunks) runs the same
per-microbatch 1F1B driver, so its programs are the 1F1B replay over
the interleaved ownership; HT308 is the placement check of its own.
"""
from __future__ import annotations

import os
from collections import Counter

__all__ = ["build_plan", "rank_programs", "simulate",
           "collective_order_pass", "interleaved_placement_pass",
           "deadlock_pass", "Event", "PipelinePlan"]


class Event:
    """One symbolic schedule action of a rank."""

    __slots__ = ("kind", "peer", "tag", "label")

    def __init__(self, kind, peer=None, tag=None, label=""):
        self.kind = kind          # "send" | "recv" | "collective"
        self.peer = peer          # the other rank (send dst / recv src)
        self.tag = tag
        self.label = label

    def __repr__(self):
        return f"Event({self.kind}, peer={self.peer}, tag={self.tag})"


class _Stage:
    __slots__ = ("index", "owner", "ranks", "device_id", "devices",
                 "nodes", "in_nodes", "out_nodes", "consumed_outs")

    def __init__(self, index, devices):
        self.index = index
        self.devices = list(devices)      # (hostname, device id) each
        self.device_id = self.devices[0][1]
        self.ranks = [0]
        self.owner = 0
        self.nodes = []
        self.in_nodes = []
        self.out_nodes = []
        self.consumed_outs = []


class PipelinePlan:
    """Stage graph and ranks, mirrored from the pipeline executor's
    ``_build_stages`` / ``_plan_stages`` without touching a device."""

    def __init__(self, stages, assign, consumers, loss_node):
        self.stages = stages
        self.assign = assign            # node -> stage index
        self.consumers = consumers      # node -> [consuming stages]
        self.loss_node = loss_node

    @property
    def nranks(self):
        return len({r for s in self.stages for r in s.ranks})


def build_plan(eval_nodes, nprocs=None):
    """Stage the forward graph as ``PipelineSubExecutor`` would; returns
    None when fewer than two stages exist (no pipeline)."""
    from ..graph.autodiff import find_topo_sort
    from ..optimizer import OptimizerOp
    from ..ops.comm import PipelineReceiveOp, PipelineSendOp
    from ..ops.variable import PlaceholderOp
    from ..parallel.pipeline import _device_key, _owner_of
    from ..parallel.planner import propagate_statuses

    eval_fwd = [n for n in eval_nodes if not isinstance(n, OptimizerOp)]
    if not eval_fwd:
        return None
    topo = [n for n in find_topo_sort(eval_fwd)
            if not isinstance(n, (PipelineSendOp, PipelineReceiveOp))]

    keys = []
    for node in topo:
        k = _device_key(node)
        if k is not None and k not in keys \
                and not isinstance(node, PlaceholderOp):
            keys.append(k)
    if len(keys) < 2:
        return None
    key_to_stage = {k: i for i, k in enumerate(keys)}
    stages = [_Stage(i, k) for i, k in enumerate(keys)]

    assign = {}
    for node in topo:
        if isinstance(node, PlaceholderOp):
            continue
        s = key_to_stage.get(_device_key(node))
        if s is None:
            s = max((assign.get(i, 0) for i in node.inputs), default=0)
        assign[node] = s
        stages[s].nodes.append(node)
    for node in topo:
        if isinstance(node, PlaceholderOp):
            consumers = [assign[n] for n in topo
                         if not isinstance(n, PlaceholderOp)
                         and node in n.inputs]
            assign[node] = min(consumers) if consumers else 0

    for node in topo:
        if isinstance(node, PlaceholderOp):
            continue
        s = assign[node]
        for inp in node.inputs:
            si = assign.get(inp, s)
            if si != s and not isinstance(inp, PlaceholderOp):
                if inp not in stages[s].in_nodes:
                    stages[s].in_nodes.append(inp)
                if inp not in stages[si].out_nodes:
                    stages[si].out_nodes.append(inp)
    loss_node = eval_fwd[0]
    for ev in eval_fwd:
        s = assign.get(ev)
        if s is not None and ev not in stages[s].out_nodes:
            stages[s].out_nodes.append(ev)
    all_ins = set()
    for st in stages:
        all_ins.update(st.in_nodes)
    for st in stages:
        st.consumed_outs = [n for n in st.out_nodes if n in all_ins]

    if nprocs is None:
        nprocs = int(os.environ.get("HETU_NUM_PROCS", "1"))
    # a rank a device of the stage's context; a tuple stage whose
    # statuses split nothing runs on its first device alone
    status = propagate_statuses(topo) \
        if any(len(st.devices) > 1 for st in stages) else {}
    for st in stages:
        st.ranks = [_owner_of(host, nprocs) for host, _ in st.devices]
        if len(st.ranks) > 1:
            own = [n for n, s in assign.items() if s == st.index]
            if not any(status.get(n) is not None and status[n].is_dist()
                       for n in own):
                st.ranks = st.ranks[:1]
        st.owner = st.ranks[0]

    consumers = {}
    for st in stages:
        for node in st.in_nodes:
            consumers.setdefault(node, []).append(st)
    return PipelinePlan(stages, assign, consumers, loss_node)


# ---------------------------------------------------------------------------
# schedule -> per-rank symbolic programs
# ---------------------------------------------------------------------------

def _fwd_events(plan, progs, report, m=None):
    """One forward sweep (stage order) — the shared shape of the GPipe
    block phase and each 1F1B ``forward(m)``. Rank k of a stage takes a
    boundary from rank k mod width of the stage that made it."""
    stages = plan.stages
    reported = set()
    for stage in stages:
        for k, r in enumerate(stage.ranks):
            for node in stage.in_nodes:
                src = stages[plan.assign[node]]
                peer = src.ranks[k % len(src.ranks)]
                if peer != r:
                    progs[r].append(Event(
                        "recv", peer=peer, tag=("f", m, node.id,
                                                stage.index),
                        label=f"{node.name} (stage {stage.index} <- stage "
                              f"{src.index})"))
                elif src.index > stage.index and report is not None \
                        and m in (None, 0) and node not in reported:
                    # structural: reported once, not once a microbatch
                    reported.add(node)
                    report.add(
                        "HT307", "error",
                        f"stage {stage.index} consumes {node.name} "
                        f"produced by LATER stage {src.index} on the same "
                        f"rank — the forward schedule runs stages in order "
                        f"and would read an unset boundary", node=node)
            for node in stage.consumed_outs:
                for cons in plan.consumers.get(node, ()):
                    for kk, dst in enumerate(cons.ranks):
                        if kk % len(stage.ranks) != k or dst == r:
                            continue
                        progs[r].append(Event(
                            "send", peer=dst,
                            tag=("f", m, node.id, cons.index),
                            label=f"{node.name} (stage {stage.index} -> "
                                  f"stage {cons.index})"))


def _bwd_events(plan, progs, m=None):
    """One backward sweep (reverse stage order): cotangent recvs from
    foreign consumers, cotangent sends to foreign producers."""
    stages = plan.stages
    for stage in reversed(stages):
        for k, r in enumerate(stage.ranks):
            for node in stage.out_nodes:
                for cons in plan.consumers.get(node, ()):
                    peer = cons.ranks[k % len(cons.ranks)]
                    if peer != r:
                        progs[r].append(Event(
                            "recv", peer=peer,
                            tag=("b", m, node.id, cons.index),
                            label=f"cotangent of {node.name} (stage "
                                  f"{stage.index} <- stage {cons.index})"))
            for node in stage.in_nodes:
                src = stages[plan.assign[node]]
                for kk, dst in enumerate(src.ranks):
                    if kk % len(stage.ranks) != k or dst == r:
                        continue
                    progs[r].append(Event(
                        "send", peer=dst,
                        tag=("b", m, node.id, stage.index),
                        label=f"cotangent of {node.name} (stage "
                              f"{stage.index} -> stage {src.index})"))


def rank_programs(plan, schedule="gpipe", num_microbatches=None,
                  report=None):
    """Per-rank ordered event programs for a schedule, mirroring the
    runtime drivers (one forward then one backward sweep for gpipe; the
    exact ``_drive_1f1b`` interleaving for 1f1b)."""
    from ..ops.comm import AllReduceCommunicateOp
    from ..parallel.pipeline import _drive_1f1b

    ranks = sorted({r for s in plan.stages for r in s.ranks})
    progs = {r: [] for r in ranks}
    S = len(plan.stages)
    M = num_microbatches or max(2, S)

    # in-stage collectives: their issue order, so the ranks of a stage
    # can be checked against each other
    for stage in plan.stages:
        for node in stage.nodes:
            if isinstance(node, AllReduceCommunicateOp):
                for r in stage.ranks:
                    progs[r].append(Event(
                        "collective", tag=node.op_type, label=node.name))

    if schedule == "gpipe":
        _fwd_events(plan, progs, report)
        _bwd_events(plan, progs)
    else:        # 1f1b / interleaved_1f1b — replay the real driver
        _drive_1f1b(lambda m: _fwd_events(plan, progs, report, m=m),
                    lambda m: _bwd_events(plan, progs, m=m), S, M)
    return progs


def interleaved_placement_pass(plan, report, virtual_stages=None):
    """HT308: a schedule declared interleaved (virtual_stages > 1) must
    place stages round-robin over the ranks — stage i on rank i mod
    nranks, V = nstages / nranks chunks a rank (what
    ``pipeline.virtual_stage_program`` models). The runtime refuses
    anything else at construction (``PipelineSubExecutor`` raises
    ``ValueError``), so the static form is an error."""
    owners = [s.ranks[0] if len(s.ranks) == 1 else tuple(s.ranks)
              for s in plan.stages]
    nr = len(set(owners))
    S = len(owners)
    ok = (nr > 0 and S % nr == 0
          and all(o == owners[i % nr] for i, o in enumerate(owners)))
    v = S // nr if nr else 1
    if not ok:
        report.add(
            "HT308", "error",
            f"interleaved schedule (virtual_stages="
            f"{virtual_stages or v}) without round-robin placement: "
            f"stage owners are {owners}, expected stage i on rank "
            f"i mod {nr} — the pipeline executor refuses this at "
            f"construction (and consecutive chunks on one rank would "
            f"forfeit the ~1/V bubble reduction anyway); cycle the "
            f"worker contexts V times")
    return ok


# ---------------------------------------------------------------------------
# symbolic execution
# ---------------------------------------------------------------------------

def simulate(programs, report):
    """Execute the per-rank programs over a buffered channel; report
    HT301/HT302/HT305. Returns True when every program drains."""
    pcs = {r: 0 for r in programs}
    chan = Counter()
    progressed = True
    while progressed:
        progressed = False
        for r, prog in programs.items():
            while pcs[r] < len(prog):
                ev = prog[pcs[r]]
                if ev.kind == "send":
                    chan[(ev.peer, ev.tag)] += 1
                elif ev.kind == "recv":
                    if chan[(r, ev.tag)] <= 0:
                        break
                    chan[(r, ev.tag)] -= 1
                pcs[r] += 1
                progressed = True

    blocked = {r: prog[pcs[r]] for r, prog in programs.items()
               if pcs[r] < len(prog)}
    for r, ev in sorted(blocked.items()):
        # does any rank still hold a future send matching this recv?
        sender = None
        for r2, prog in programs.items():
            for e2 in prog[pcs[r2]:]:
                if e2.kind == "send" and e2.peer == r \
                        and e2.tag == ev.tag:
                    sender = r2
                    break
            if sender is not None:
                break
        if sender is None:
            report.add(
                "HT301", "error",
                f"rank {r} blocks forever waiting to receive "
                f"{ev.label} from rank {ev.peer}: no rank ever sends "
                f"it — mis-paired pipeline send/recv")
        else:
            peer_ev = blocked.get(sender)
            peer_txt = (f"rank {sender} is itself blocked waiting to "
                        f"receive {peer_ev.label} from rank "
                        f"{peer_ev.peer}" if peer_ev is not None
                        else f"rank {sender} would send it only later "
                        f"in its schedule")
            report.add(
                "HT302", "error",
                f"static deadlock: rank {r} waits to receive "
                f"{ev.label} from rank {sender}, while {peer_txt} — "
                f"cyclic wait, the fleet would hang at this step")
    if not blocked:
        for (dst, tag), n in chan.items():
            if n > 0:
                report.add(
                    "HT305", "warn",
                    f"{n} boundary send(s) to rank {dst} (tag {tag}) "
                    f"are never received — dead transfer, likely a "
                    f"stale or duplicated pipeline marker")
    return not blocked


def collective_order_pass(programs, report):
    """Every rank taking part in collectives must issue the identical
    sequence — a divergence is a certain cross-rank hang (HT303)."""
    seqs = {r: [ev.tag for ev in prog if ev.kind == "collective"]
            for r, prog in programs.items()}
    seqs = {r: s for r, s in seqs.items() if s}
    if len(seqs) < 2:
        return
    ranks = sorted(seqs)
    ref_rank, ref = ranks[0], seqs[ranks[0]]
    for r in ranks[1:]:
        s = seqs[r]
        if s == ref:
            continue
        k = next((i for i, (a, b) in enumerate(zip(ref, s)) if a != b),
                 min(len(ref), len(s)))
        a = ref[k] if k < len(ref) else "<end of schedule>"
        b = s[k] if k < len(s) else "<end of schedule>"
        report.add(
            "HT303", "error",
            f"collective issue order diverges: rank {ref_rank} issues "
            f"{a} as collective #{k} but rank {r} issues {b} — the "
            f"fleet deadlocks at the first mismatched collective")


def _collective_interleaved_pass(plan, report, virtual_stages):
    """HT308, collective form: virtual_stages=V folds S·V stages onto
    S devices, so the stage contexts' device ids must repeat
    round-robin (stage i on device i % S_dev, the first S_dev
    distinct) — the check ``_build_collective`` makes at the first
    dispatch; here it refuses the launch instead."""
    V = int(virtual_stages)
    S = len(plan.stages)
    devs = [s.device_id for s in plan.stages]
    if S % V != 0:
        report.add(
            "HT308", "error",
            f"interleaved collective pipeline: virtual_stages={V} "
            f"must divide the stage count {S}")
        return False
    s_dev = S // V
    if len(set(devs[:s_dev])) != s_dev or any(
            devs[i] != devs[i % s_dev] for i in range(S)):
        report.add(
            "HT308", "error",
            f"interleaved collective pipeline (virtual_stages={V}) "
            f"needs round-robin placement: stage i on device "
            f"i % {s_dev}, got devices {devs} — the collective "
            f"builder refuses this at first dispatch; cycle the "
            f"ht.context(...) device list V times")
        return False
    return True


def _collective_chain_pass(plan, report):
    """The collective pipeline's linear-chain contract, statically (its
    builder raises at the first dispatch; preflight reports before
    launch)."""
    S = len(plan.stages)
    ls = plan.assign.get(plan.loss_node)
    if ls is not None and ls != S - 1:
        report.add(
            "HT306", "error",
            f"collective pipeline expects the loss on the last stage "
            f"(found on stage {ls})", node=plan.loss_node)
    for i, st in enumerate(plan.stages):
        if i == 0 and st.in_nodes:
            report.add("HT306", "error",
                       "collective pipeline: stage 0 must not consume "
                       "boundary tensors")
        if i > 0 and (len(st.in_nodes) != 1
                      or plan.assign[st.in_nodes[0]] != i - 1):
            report.add(
                "HT306", "error",
                f"collective pipeline needs a linear chain with one "
                f"boundary per stage; stage {i} consumes "
                f"{[(n.name, plan.assign[n]) for n in st.in_nodes]}")
        if i < S - 1 and len(st.consumed_outs) != 1:
            report.add(
                "HT306", "error",
                f"collective pipeline: stage {i} must export exactly "
                f"one boundary tensor (got {len(st.consumed_outs)})")


def deadlock_pass(eval_nodes, report, schedule="gpipe", nprocs=None,
                  num_microbatches=None, virtual_stages=None):
    """Full pass: marker pairing, staging, per-schedule symbolic run."""
    from ..graph.autodiff import find_topo_sort
    from ..ops.comm import PipelineReceiveOp, PipelineSendOp

    topo = find_topo_sort(list(eval_nodes))
    unbound = [n for n in topo if isinstance(n, PipelineReceiveOp)
               and n.bound_send is None]
    if unbound:
        pending = PipelineSendOp.pending()
        if len(pending) != len(unbound):
            report.add(
                "HT304", "error",
                f"unpaired pipeline markers: {len(pending)} pending "
                f"send(s) vs {len(unbound)} receive(s) — each recv "
                f"must pair with exactly one send built for this graph",
                node=unbound[0])
            return None

    plan = build_plan(eval_nodes, nprocs=nprocs)
    if plan is None:
        return None
    if schedule == "collective":
        _collective_chain_pass(plan, report)
        if virtual_stages and virtual_stages > 1:
            _collective_interleaved_pass(plan, report, virtual_stages)
        return plan
    if schedule == "interleaved_1f1b" or (virtual_stages
                                          and virtual_stages > 1):
        if plan.nranks > 1:
            interleaved_placement_pass(plan, report,
                                       virtual_stages=virtual_stages)
        schedule = "1f1b"       # same driver: replay its event order
    programs = rank_programs(plan, schedule=schedule,
                             num_microbatches=num_microbatches,
                             report=report)
    simulate(programs, report)
    collective_order_pass(programs, report)
    return plan
