"""Preflight graph analysis for ``hetu_tpu_torch`` define-then-run
sessions.

Counterpart of ``hetu_tpu/analysis/``. A session hands over the whole
program — graph, partition statuses, pipeline schedule, placement —
before a byte moves, so these static passes run over the topo-sorted
graph between construction and the first dispatch, each emitting
structured :class:`~.findings.Finding` objects with stable codes and
the user's construction line (``Op.defined_at``):

1. **shapes** (HT1xx) — shape/dtype propagation through
   ``Op.infer_shape``, and the dead-subgraph / unused-variable /
   duplicate-parameter lint;
2. **sharding** (HT2xx) — the planner's status propagation checked:
   unmappable or conflicting statuses, implicit reshards with their
   bytes, a plan wider than its job;
3. **deadlock** (HT3xx) — the GPipe / 1F1B / interleaved / collective
   schedules run symbolically rank by rank: unmatched sends and recvs
   and cyclic waits become findings instead of hung fleets;
4. **memory** (HT4xx) — a static footprint estimate against a
   device-memory budget;
5. **overlap** (HT5xx, advisory) — PS-backed sessions with the ingest
   engine off, or driven by plain ``run()`` loops (the runtime half is
   in ``executor.py``);
6. **numerics** (HT8xx) — interval and dtype abstract interpretation:
   per-node value intervals seeded from initializer distributions and
   op semantics, precision classes riding the dtype propagation;
   overflow-prone low-precision ops, unguarded div/log/rsqrt domains,
   integer-exactness cliffs on the id paths, low-precision
   accumulation, boundary and underflow risks, PRNG stream reuse
   (:mod:`.numerics`), with :mod:`.rangecheck` as its measured-range
   twin (the HT810 soundness gate and a range DB that tightens
   re-analysis);
7. **efficiency** (HT9xx) — the CostDB-priced static performance lint:
   recompile hazards, GEMM padding waste on the card's measured
   granule, hot-path host syncs, fragmented collectives, redundant
   reshards, cost-weighted dead compute, untuned kernels, coverage-gap
   advisories, every finding priced in predicted ms/step
   (:mod:`.efficiency`), with :mod:`.perfcheck` as its doctor-validated
   soundness twin (HT910). Its findings are warnings or advisories:
   they never block a launch.

The JAX package's PS-wire pass (HT7xx) and its self-lints (jit purity,
concurrency, protocol) are ROADMAP item 17d: :func:`analyze` leaves them
out until they are ported.

Surfaces: ``Executor(validate="error"|"warn"|"off")`` (or
``HETU_VALIDATE``), ``python -m hetu_tpu_torch.launcher ...
--preflight`` (the ``HETU_PREFLIGHT`` contract: the script's first
``Executor`` analyzes, prints, writes its JSON report and exits before
any device, process group or server is touched), and ``python -m
hetu_tpu_torch.analysis`` over the model zoo (:mod:`.zoo`).
"""
from __future__ import annotations

import os
import sys

from .findings import (Finding, GraphValidationError, Report, collecting,
                       emit, provenance, suppressed)
from .shapes import frozen_graph_pass, lint_pass, shape_pass
from .sharding import sharding_pass
from .deadlock import deadlock_pass
from .memory import memory_pass
from .overlap import RunLoopAdvisor, overlap_pass
from .numerics import numerics_pass
from .efficiency import efficiency_pass
from ..tune.autotune import UNNAMED_CARD, platform_scope

__all__ = ["Finding", "Report", "GraphValidationError", "collecting",
           "emit", "provenance", "suppressed", "analyze",
           "finish_preflight", "shape_pass", "lint_pass",
           "frozen_graph_pass", "sharding_pass", "deadlock_pass",
           "memory_pass", "overlap_pass", "numerics_pass",
           "efficiency_pass", "RunLoopAdvisor", "EXIT_PREFLIGHT"]

# the exit code of "preflight found errors" (cf. the watchdog's 117):
# the launcher does not start the fleet when it sees it
EXIT_PREFLIGHT = 121


def _schedule_of(config):
    if config is None:
        return "gpipe"
    if getattr(config, "pipeline_mode", None) == "collective":
        return "collective"
    if getattr(config, "use_pipedream", False):
        v = (getattr(config, "pp_options", None) or {}).get(
            "virtual_stages", 1) or 1
        return "interleaved_1f1b" if int(v) > 1 else "1f1b"
    return "gpipe"


def _pricing_platform(device):
    """The CostDB partition the efficiency pass prices under: the
    session's device where one is named and this is no preflight; else
    the CPU's for a CPU session or a host with no card and, for a card,
    a partition that names none (asking a card its name initializes
    CUDA, and a preflight's host need not hold the fleet's cards — so a
    preflight prices a card's ops from FLOPs, as ``memory_pass`` there
    takes no budget)."""
    import torch
    if device is not None and "HETU_PREFLIGHT" not in os.environ:
        return {"device": device}
    if (device is not None and torch.device(device).type == "cpu") \
            or not torch.cuda.is_available():
        return {"tag": "cpu"}
    return {"tag": UNNAMED_CARD}


def analyze(eval_node_list, feed_shapes=None, config=None, schedule=None,
            nprocs=None, num_microbatches=None, hbm_budget=None,
            extra_roots=(), frozen=False, virtual_stages=None,
            device=None):
    """Run the static passes over a graph; returns a :class:`Report`.

    ``config`` (a HetuConfig) refines the passes — the pipeline
    schedule, the microbatch count, the overlap options — but is
    optional: the passes derive staging and statuses from the graph
    itself. ``device`` is the session's device, whose memory is the
    budget where none is given and whose CostDB entries price the
    efficiency pass (:func:`_pricing_platform`: never a card's name
    under ``HETU_PREFLIGHT`` or with no device named, so a preflight
    initializes no CUDA). A pass that crashes becomes an HT001
    warning, so one broken analyzer never blocks a launch the others
    cleared.
    """
    from ..graph.autodiff import find_topo_sort

    report = Report()
    topo = find_topo_sort(list(eval_node_list))
    if config is not None:
        schedule = schedule or _schedule_of(config)
        num_microbatches = (num_microbatches
                            or getattr(config, "num_microbatches", None))
        if virtual_stages is None:
            virtual_stages = (getattr(config, "pp_options", None)
                              or {}).get("virtual_stages")

    def _guard(name, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — analysis must not kill a launch
            report.add("HT001", "warn",
                       f"analysis pass {name!r} crashed "
                       f"({type(e).__name__}: {e}) — its findings are "
                       f"incomplete")
            return None

    dtypes = {}
    shapes = _guard("shapes", shape_pass, topo, report,
                    feed_shapes=feed_shapes, dtypes_out=dtypes) or {}
    _guard("lint", lint_pass, topo, report,
           eval_nodes=eval_node_list, extra_roots=extra_roots)
    _guard("sharding", sharding_pass, topo, report, shapes=shapes)
    _guard("numerics", numerics_pass, topo, report, shapes=shapes,
           dtypes=dtypes, feed_shapes=feed_shapes, config=config)
    _guard("deadlock", deadlock_pass, eval_node_list, report,
           schedule=schedule or "gpipe", nprocs=nprocs,
           num_microbatches=num_microbatches,
           virtual_stages=virtual_stages)
    _guard("memory", memory_pass, topo, shapes, report,
           budget=hbm_budget, device=device)
    _guard("overlap", overlap_pass, topo, report, config=config)
    # the priced performance lint (HT9xx): warn above the ms threshold,
    # info below, never error — slow is advisory at launch time; the zoo
    # CLI (python -m hetu_tpu_torch.analysis.efficiency) owns the gate
    with platform_scope(**_pricing_platform(device)):
        _guard("efficiency", efficiency_pass, topo, report, shapes=shapes,
               dtypes=dtypes, config=config, eval_nodes=eval_node_list,
               extra_roots=extra_roots)
    if frozen:
        _guard("frozen", frozen_graph_pass, topo, report)
    return report


def finish_preflight(report, out_path=None):
    """The end of a preflight (the ``HETU_PREFLIGHT`` contract): print
    the report, write its JSON where ``out_path`` names a file, and exit
    the process — 0 on a clean graph, :data:`EXIT_PREFLIGHT` where
    errors exist — before any device, process group or server is
    touched."""
    text = report.to_text()
    print(text, file=sys.stderr if report.errors else sys.stdout)
    if out_path and out_path not in ("1", "true"):
        try:
            os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                        exist_ok=True)
            with open(out_path, "w") as f:
                f.write(report.to_json() + "\n")
        except OSError as e:
            print(f"preflight: could not write {out_path}: {e}",
                  file=sys.stderr)
    if report.errors:
        print("preflight: FAILED — fix the errors above before "
              "launching", file=sys.stderr)
        raise SystemExit(EXIT_PREFLIGHT)
    print("preflight: OK")
    raise SystemExit(0)
