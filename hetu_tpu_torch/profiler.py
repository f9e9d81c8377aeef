"""Per-op profiling.

Counterpart of part of ``hetu_tpu/profiler.py``: ``profile_op_records``
and ``profile_ops`` run the forward ops of a step's topological order
op by op, outside the executor's own walk, with a
``torch.cuda.synchronize()`` after each op on a card, and time each
one. The step runs with ``training=False``, so attention takes the
inference route (K1, ``flash_attention``) and no parameter, optimizer
slot or op state changes. The times attribute cost; they are not the
step's (the walk's own dispatch overlaps ops that this syncs apart).

The reference also times the step's gradient ops. The port does not:
the planner prices forward ops only (``parallel/autoplan.graph_costs``
scales each by the training factor), and after an eval forward there is
no (o, logsumexp) residual for K3/K4, so attention's gradient would run
its plain composed version on the card (ROADMAP §3).

``StepLogger`` (the executor's ``log_path``) appends one JSON line per
step, and mirrors it into the telemetry layer when given one.
``trace(logdir)`` records a ``torch.profiler`` trace (CUDA activity
where a card is present) and exports it as a Chrome trace into
``logdir``: the reference's ``jax.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

__all__ = ["StepLogger", "profile_ops", "profile_op_records", "trace"]


class StepLogger:
    """Appends one JSON line per step: wall ms, step index, optional
    extra phase dict (reference ``hetu_tpu/profiler.py:27-85``). Kept as
    a compatibility wrapper over the telemetry layer: when constructed
    with an enabled Telemetry it mirrors each step into the span trace
    (a ``step_logged`` instant) and the ``steplogger_wall_ms``
    histogram, so the JSONL timeline and the trace agree. The wall time
    is the host's: it closes when the step's work is issued, and never
    synchronizes the device."""

    def __init__(self, path, telemetry=None):
        self.path = path
        self._f = open(path, "a")
        self._t0 = None
        self._phase_snap = {}
        self.step = 0
        self.telemetry = telemetry

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self, executor=None, **extra):
        dt = (time.perf_counter() - self._t0) * 1000 \
            if self._t0 is not None else None
        # `dt is not None`, NOT truthiness: a clock-granularity 0.0 ms
        # step is a real measurement, null means begin() never ran
        rec = {"step": self.step,
               "wall_ms": round(dt, 3) if dt is not None else None}
        rt = getattr(executor, "ps_runtime", None) if executor else None
        if rt is not None:
            # rt.times accumulates for the runtime's life: log the DELTA
            # since the previous step, which is this step's cost
            delta = {k: v - self._phase_snap.get(k, 0.0)
                     for k, v in rt.times.items()}
            self._phase_snap = dict(rt.times)
            rec["ps_phases_ms"] = {k: round(v * 1000, 3)
                                   for k, v in delta.items() if v > 0}
        rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        tel = self.telemetry
        if tel is not None and tel.enabled and dt is not None:
            tel.instant("step_logged", step=self.step,
                        wall_ms=rec["wall_ms"])
            tel.observe("steplogger_wall_ms", dt)
        self.step += 1

    def close(self):
        if not self._f.closed:
            self._f.close()

    @property
    def closed(self):
        return self._f.closed


def profile_op_records(executor, feed_dict=None, name="default",
                       costdb=None):
    """Per-op cost attribution with full op *identity*: execute the
    forward ops of the step's topo order (the ops reachable from its
    eval nodes but the optimizer's: what ``graph_costs`` prices) op by
    op, synchronizing after each, and return one record per op — ``{"name", "kind", "shape", "dtype", "ms"}`` — with
    exactly the fields a ``telemetry.costdb.CostDB`` entry is keyed on
    (``dtype`` by numpy's name: ``float32``, ``bfloat16``, ...).
    ``costdb=`` (a CostDB instance or a path) folds every record
    straight into the persistent database under the session device's
    platform, source-tagged ``profile_ops``. A session of thread ranks
    profiles its first rank; a pipeline session is refused."""
    import torch

    from .executor import SubExecutor
    from .graph.autodiff import find_topo_sort
    from .graph.node import ExecContext
    from .ops.variable import PlaceholderOp
    from .optimizer import OptimizerOp

    executor = executor.ranks[0]
    sub = executor.subexecutors[name]
    if not isinstance(sub, SubExecutor):
        raise NotImplementedError(
            "profile_op_records over a pipeline session: profile the same "
            "graph in a one-device executor")
    config = sub.config
    device = config.device
    feed_map = {}
    for node, value in (feed_dict or {}).items():
        feed_map[node] = sub._ingest(value)
    for dl in sub.dataloader_ops:
        feed_map[dl] = sub._ingest(dl.get_arr(sub.name))
    sub._infer_shapes(feed_map)
    sub._ensure_state(executor)

    ectx = ExecContext(training=False, seed=config.seed,
                       step=sub.step_count, device=device, config=config)
    params = {n: executor.params[str(n.id)] for n in sub.param_nodes}
    if config.dtype is not None:
        ectx.master_params = params
        params = {n: v.to(config.dtype) if v.is_floating_point() else v
                  for n, v in params.items()}
    ectx.params = params
    ectx.opt_state = executor.opt_state
    ectx.state = {n: executor.state[str(n.id)] for n in sub.stateful_ops}
    ectx.lr = 0.0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    env = dict(feed_map)
    env.update(params)
    records = []
    forward = set(find_topo_sort(
        [n for n in sub.eval_node_list if not isinstance(n, OptimizerOp)]))
    skip = sub._host_ops
    sync()
    for i, node in enumerate(sub.topo_order):
        if node in forward and node not in env and node not in skip:
            if isinstance(node, PlaceholderOp):
                env[node] = None
            else:
                ins = [env[n] for n in node.inputs]
                t0 = time.perf_counter()
                out = node.compute(ins, ectx)
                sync()
                ms = (time.perf_counter() - t0) * 1000
                dtype = getattr(out, "dtype", None)
                records.append({
                    "name": node.name,
                    "kind": type(node).__name__,
                    "shape": getattr(node, "inferred_shape", None),
                    "dtype": (str(dtype).split(".")[-1]
                              if dtype is not None else "float32"),
                    "ms": ms})
                env[node] = out
        for dead in sub._free_after[i]:
            env.pop(dead, None)
    records.sort(key=lambda r: -r["ms"])
    if costdb is not None:
        from .telemetry.costdb import CostDB, record_profile
        from .tune.autotune import platform_scope
        db = costdb if isinstance(costdb, CostDB) else CostDB(costdb)
        with platform_scope(device):
            record_profile(db, records)
    return records


def profile_ops(executor, feed_dict=None, name="default", top=20,
                printout=True, costdb=None):
    """Per-op cost attribution: execute the step's forward ops op by op,
    synchronizing after each (reference HetuProfiler's per-node timers).
    Returns [(op_name, ms)] sorted by cost; ``costdb=`` additionally
    persists each measurement (see ``profile_op_records``)."""
    records = profile_op_records(executor, feed_dict, name=name,
                                 costdb=costdb)
    times = [(r["name"], r["ms"]) for r in records]
    if printout:
        total = sum(t for _, t in times)
        print(f"per-op profile ({len(times)} ops, total {total:.1f} ms "
              f"op by op — attribution only; the step's walk overlaps "
              f"what this synchronizes apart):")
        for opname, ms in times[:top]:
            print(f"  {ms:8.3f} ms  {opname}")
    return times


@contextlib.contextmanager
def trace(logdir):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a card is present), exported as a Chrome trace
    ``torch_profile_<pid>.json`` into ``logdir`` (Perfetto and
    chrome://tracing render it). Yields the profiler; its file is
    ``prof.trace_path`` after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = None
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(logdir, f"torch_profile_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path
