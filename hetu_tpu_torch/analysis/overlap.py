"""Pass 5 — host-overlap advisory (HT5xx).

Counterpart of ``hetu_tpu/analysis/overlap.py``. A PS-backed graph is
feed-bound by construction: every step moves ids, feeds and embedding
rows over the host link. The async ingest engine
(``hetu_tpu_torch/ingest.py``) exists to hide exactly that, so a
session that is known feed-bound but runs with the engine off, or
drives the session through a plain per-step ``run()`` loop that never
reaches the engine, gets a pointer at the fix.

Codes
-----
HT501  PS-backed graph built with overlap_options ingest=False    info
HT502  PS-backed graph driven by a long plain run() loop          info
       (the ingest engine never engaged — use run_batches_stream)

Both are advisories (severity ``info``): they never fail
``validate="error"`` or ``--preflight`` — a synchronous loop is
correct, just slow.

The executor analyzes a graph before its PS ops are spliced in (the
preflight comes before any device or server is touched), so a graph
also counts as PS-backed where its session's communication mode is
``PS`` or ``Hybrid``.
"""
from __future__ import annotations

import logging

from .findings import Finding

__all__ = ["overlap_pass", "RunLoopAdvisor", "RUN_LOOP_ADVISORY_STEPS",
           "DOCS_POINTER"]

logger = logging.getLogger(__name__)

DOCS_POINTER = "README.md, the PS and Hybrid modes' run_batches_stream"

# plain run() steps on a PS-backed graph before the advisory fires —
# past any warm-up loop, clearly a training loop by then
RUN_LOOP_ADVISORY_STEPS = 32


def _ps_backed(topo, config=None):
    """True when the graph talks to a parameter server (sparse pulls,
    push/pull comm ops, device-cached embedding tables, or a session
    in the PS or Hybrid mode) — the feed-bound family the ingest engine
    was built for."""
    from ..ops.comm import (ParameterServerCommunicateOp,
                            ParameterServerSparsePullOp)
    if getattr(config, "comm_mode", None) in ("PS", "Hybrid"):
        return True
    for node in topo:
        if isinstance(node, (ParameterServerCommunicateOp,
                             ParameterServerSparsePullOp)):
            return True
        if getattr(node, "device_cached", False):
            return True
    return False


def overlap_pass(topo, report, config=None):
    """Static half: a PS-backed (known feed-bound) graph built with the
    ingest engine switched off (``overlap_options={"ingest": False}``)."""
    overlap = getattr(config, "overlap", None)
    if overlap is None or overlap.ingest:
        return
    if not _ps_backed(topo, config):
        return
    report.add(
        "HT501", "info",
        "PS-backed graph with the async ingest engine disabled "
        "(overlap_options ingest=False): every pull and feed transfer "
        "will serialize with compute on a feed-bound config. Re-enable "
        f"ingest or see {DOCS_POINTER}.")


class RunLoopAdvisor:
    """Runtime half: a PS-backed session driven by a long plain
    ``run()`` loop never reaches the ingest engine — per-step pulls and
    feed transfers sit on the critical path even though the engine is
    nominally on. After :data:`RUN_LOOP_ADVISORY_STEPS` consecutive
    ``run()`` steps with no ``run_batches`` / ``run_batches_stream``
    call, emit HT502 once (a log line, and a finding in the session's
    analysis report when ``Executor(validate=...)`` keeps one).

    Cost when quiet: one integer increment a step.
    """

    def __init__(self, config):
        self.config = config
        self._consecutive = 0
        self._fired = False

    def on_run_step(self):
        if self._fired:
            return
        self._consecutive += 1
        if self._consecutive >= RUN_LOOP_ADVISORY_STEPS:
            self._fire()

    def on_stream(self):
        """A block or stream API engaged — the loop is not plain run()."""
        self._consecutive = 0

    def _fire(self):
        self._fired = True
        engine = "disabled (overlap_options ingest=False)" \
            if not self.config.overlap.ingest else "idle"
        f = Finding(
            "HT502", "info",
            f"PS-backed graph driven by {self._consecutive} consecutive "
            f"per-step run() calls — the async ingest engine is "
            f"{engine} and every SparsePull/feed transfer serializes "
            f"with compute. Batch the loop through "
            f"run_batches_stream(...) to overlap the host; see "
            f"{DOCS_POINTER}.")
        logger.warning("%s", f)
        report = getattr(self.config, "analysis_report", None)
        if report is not None:
            report.findings.append(f)
