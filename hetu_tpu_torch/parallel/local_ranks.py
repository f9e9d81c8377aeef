"""Several devices of one process's context, run as thread ranks.

The JAX package drives a tuple context, a context of several workers or
a mesh from one process. The port realizes each parallel mode as one
rank a device (a launcher's process each, NCCL or gloo between them);
where the user names n devices that all map to this process, and no
launcher job is joined, the executor starts n ranks as threads of this
process instead, so that a script of the reference runs unchanged:

* **AllReduce** over a context of n workers (or a tuple context with
  ``comm_mode="AllReduce"``): a ``{"dp": n}`` mesh;
* **tensor parallel** (``ht.dispatch`` specs, no pipeline): the plan's
  ``("dp", "tp0", ...)`` mesh, dp the context's worker count;
* **a pipeline** whose tuple stage splits something: one rank a device
  the stages' contexts name, in order of first use, each stage's
  devices its ranks (:class:`~.mesh.Job`'s ``device_ranks``);
* **``mesh=``** a :class:`~.mesh.LocalMesh` (:func:`~.mesh.build_mesh`
  outside a job): one rank a position.

Each rank has its own clone of the user's graph, node ids kept (the
planner's statuses, inferred shapes, the comm ops the graph pass
splices and the optimizer's scheduler are per rank), its own
sub-executor, device, :class:`~.mesh.Job` of a :class:`~.mesh.LocalJob`
(gloo groups over one in-memory store, a loopback pipe channel),
parameters, drawn from the seed as every rank draws them, and, where the
session arms them, health monitor (records in ``health_rank<i>.jsonl``)
and fleet step timeline (``timeline_rank<i>.jsonl``, the launcher's
``--watch``; ``HETU_FAULT_SLOW_RANK`` names a thread rank). ``run`` hands
every rank the same feeds and returns the fetched values once, each the
first rank's that has it (the values every rank makes global; a
pipeline's loss from the rank that owns it). Rank i runs on
``cuda:(i mod device_count)`` (all on the one card of a one-card host),
or on the CPU where the session is. A rank's exception is raised in the
caller; a rank that outlives ``DEFAULT_TIMEOUT_S`` seconds raises
``TimeoutError`` there. Either leaves the session unusable: no rank is
retried alone.
"""
from __future__ import annotations

import copy
import os
import threading
import time
import types

import numpy as np
import torch

__all__ = ["LocalPlan", "LocalRanks", "clone_graph", "plan_local_ranks",
           "thread_rank"]

_thread = threading.local()


def thread_rank():
    """The thread rank this thread runs (set by :meth:`LocalRanks.on_ranks`
    around its work), or None outside a session's thread ranks. The ranks
    share one process and one ``os.environ``, so this, not
    ``HETU_PROC_ID``, names them (the fleet plane's timelines and its
    straggler fault)."""
    return getattr(_thread, "rank", None)

# seconds a call of the thread ranks may take before it fails
DEFAULT_TIMEOUT_S = 900


class LocalPlan:
    """How a session's thread ranks are laid out: their count ``n``,
    ``kind`` ("dp", "tp", "pipeline" or "mesh"), the mesh ``axes`` each
    rank builds over its job (None for a pipeline), each rank's
    ``devices`` and, for a pipeline, ``device_ranks``."""

    def __init__(self, kind, n, devices, axes=None, local_mesh=None,
                 device_ranks=None):
        self.kind = kind
        self.n = int(n)
        self.devices = list(devices)
        self.axes = axes
        self.local_mesh = local_mesh
        self.device_ranks = dict(device_ranks or {})

    def rank_mesh(self, job):
        """Rank ``job.rank``'s mesh over its job's groups (a collective:
        every rank builds it)."""
        from .mesh import subset_mesh
        if self.local_mesh is not None:
            return self.local_mesh.rank_mesh(job)
        if self.axes is None:
            return None
        return subset_mesh(self.axes, list(range(self.n)), job)

    def __repr__(self):
        return f"LocalPlan({self.kind}, n={self.n}, axes={self.axes})"


def _in_job(mesh, pp_options):
    """Whether this process is one rank of a job of several (a launcher's,
    or threads that pass their own job or mesh)."""
    import torch.distributed as dist
    from .mesh import Mesh
    if isinstance(mesh, Mesh) or "job" in pp_options:
        return True
    if int(os.environ.get("HETU_NUM_PROCS", "1")) > 1:
        return True
    return dist.is_initialized() and dist.get_world_size() > 1


def _rank_devices(config, contexts, n):
    """The device of each of ``n`` ranks: the CPU where the session is,
    else each context's (when ``contexts`` names one a rank), else
    ``cuda:(i mod device_count)``."""
    if config.device.type == "cpu":
        return [torch.device("cpu")] * n
    if contexts is not None and len(contexts) == n:
        return [c.torch_device() for c in contexts]
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _stage_devices(eval_node_list):
    """The devices the nodes' contexts name, in order of first use, as
    {(hostname, device_id): context}: a stage's tuple lists its devices."""
    from ..graph.autodiff import find_topo_sort
    out = {}
    for node in find_topo_sort(eval_node_list):
        raw = node.raw_ctx
        if raw is None or not len(raw):
            continue
        first = raw[0]
        for d in (first if isinstance(first, tuple) else (first,)):
            out.setdefault((d.hostname, d.device_id), d)
    return out


def _has_tuple_stage(eval_node_list):
    from ..graph.autodiff import find_topo_sort
    return any(node.raw_ctx is not None and len(node.raw_ctx)
               and isinstance(node.raw_ctx[0], tuple)
               and len(node.raw_ctx[0]) > 1
               for node in find_topo_sort(eval_node_list))


def plan_local_ranks(config, eval_node_list, mesh, tp, pipeline):
    """The :class:`LocalPlan` of a session that names several devices of
    this process outside a job, else None (one rank: this process)."""
    from .mesh import LocalMesh, factorized_axes
    pp_options = config.pp_options
    if isinstance(mesh, LocalMesh):
        return LocalPlan("mesh", mesh.size,
                         _rank_devices(config, mesh.contexts, mesh.size),
                         local_mesh=mesh)
    workers = config.context.flat_workers()
    many = len(workers) > 1 and config.comm_mode in ("AllReduce", "Hybrid")
    if _in_job(mesh, pp_options):
        if many and mesh is None and config.context.worker_num > 1:
            raise ValueError(
                f"{config.comm_mode} over {len(workers)} devices of one "
                f"process's context inside a launcher job: each process of "
                f"a job is one rank; give each one device, or run the "
                f"script alone (its devices then run as thread ranks)")
        return None
    if pipeline:
        if tp <= 1 or not _has_tuple_stage(eval_node_list):
            return None     # a stage that splits nothing: one device
        found = _stage_devices(eval_node_list)
        ranks = {key: r for r, key in enumerate(found)}
        return LocalPlan("pipeline", len(found),
                         _rank_devices(config, list(found.values()),
                                       len(found)),
                         device_ranks=ranks)
    if config.comm_mode == "Hybrid" and many:
        raise NotImplementedError(
            f"Hybrid over {len(workers)} devices of one process's context: "
            f"the parameter server's client is one a process, so each "
            f"worker needs its own (refused on purpose, ROADMAP §3); run "
            f"one worker process a device under the launcher's spmd: true")
    if tp > 1:
        dp = len(workers) if many else 1
        axes = ({"dp": dp} if dp > 1 else {})
        axes.update(factorized_axes(tp))
        n = int(np.prod(list(axes.values())))
        return LocalPlan("tp", n, _rank_devices(config, None, n), axes=axes)
    if many and mesh is None:
        return LocalPlan("dp", len(workers),
                         _rank_devices(config, workers, len(workers)),
                         axes={"dp": len(workers)})
    return None


# ---------------------------------------------------------------------------
_SHARED = (np.ndarray, torch.Tensor, torch.Generator, type, types.ModuleType,
           types.FunctionType, types.BuiltinFunctionType,
           type(threading.Lock()), type(threading.RLock()))


def _shared_leaves(roots):
    """{id: object} of what every clone shares: arrays and tensors (a
    parameter's initial value, a dataloader's data), device contexts,
    functions and locks, wherever they hang off the graph."""
    from ..context import DeviceGroup
    from ..ndarray import DLContext
    shared = _SHARED + (DLContext, DeviceGroup)
    memo, seen = {}, set()
    stack = list(roots)
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, shared):
            memo[id(obj)] = obj
        elif isinstance(obj, (list, tuple, set, frozenset)):
            stack.extend(obj)
        elif isinstance(obj, dict):
            stack.extend(obj.keys())
            stack.extend(obj.values())
        elif hasattr(obj, "__dict__"):
            stack.extend(vars(obj).values())
    return memo


def clone_graph(eval_node_dict):
    """A copy of the graph under ``eval_node_dict`` ({name: [nodes]}) with
    every node's id kept, sharing only arrays, tensors and contexts.
    Returns (the copy's dict, {original node: its copy})."""
    from ..graph.autodiff import find_topo_sort
    from ..graph.node import Op
    roots = [n for nodes in eval_node_dict.values() for n in nodes]
    memo = _shared_leaves(roots)
    copied = copy.deepcopy(eval_node_dict, memo)
    mapping = {}
    for node in find_topo_sort(roots):
        twin = memo.get(id(node))
        if isinstance(twin, Op):
            mapping[node] = twin
    return copied, mapping


class LocalRanks:
    """The thread ranks of one session (:class:`~hetu_tpu_torch.executor.
    Executor` builds it where ``config.local_ranks`` is set): one
    sub-executor a rank, each on a clone of the graph."""

    def __init__(self, eval_node_dict, config):
        from .mesh import LocalJob
        plan = config.local_ranks
        self.plan = plan
        self.n = plan.n
        self.devices = plan.devices
        self.timeout = float(DEFAULT_TIMEOUT_S)
        self._failed = None
        if config.use_gpipe or config.use_pipedream:
            from .pipeline import splice_send_recv
            splice_send_recv([n for nodes in eval_node_dict.values()
                              for n in nodes])
        clones = [clone_graph(eval_node_dict) for _ in range(self.n)]
        self.maps = [m for _, m in clones]
        self.job = LocalJob(self.n, timeout_s=self.timeout,
                            device_ranks=plan.device_ranks)

        def make(r):
            from ..executor import Executor
            job = self.job.job(r)
            opts = dict(config.rank_options)
            opts["device"] = self.devices[r]
            opts["mesh"] = plan.rank_mesh(job)
            if plan.kind == "pipeline":
                opts["pp_options"] = dict(opts.get("pp_options") or {},
                                          job=job)
            exe = Executor(clones[r][0], **opts)
            exe._heartbeat = None   # the process beats through the front
            if exe.config.health_monitor is not None:
                # each rank's records go to a file of its own
                exe.config.health_monitor.rank = r
            return exe

        self.executors = self.on_ranks(make)

    # ------------------------------------------------------------------
    def on_ranks(self, fn):
        """``fn(rank)`` on one thread a rank; their results by rank. The
        first rank's exception is raised here as soon as it is known; a
        rank still running after ``timeout`` seconds raises
        ``TimeoutError``."""
        from ..ops import _build
        if self._failed is not None:
            raise RuntimeError(f"the session's thread ranks failed before "
                               f"({self._failed}); build a new executor")
        n = self.n
        results, errors = [None] * n, [None] * n
        cv = threading.Condition()
        left = [n]

        def target(r):
            _build.set_rank(r)
            _thread.rank = r
            try:
                if self.devices[r].type == "cuda":
                    torch.cuda.set_device(self.devices[r])
                results[r] = fn(r)
            except BaseException as e:      # raised again on the caller
                errors[r] = e
            finally:
                _build.set_rank(None)
                _thread.rank = None
                with cv:
                    left[0] -= 1
                    cv.notify_all()

        threads = [threading.Thread(target=target, args=(r,), daemon=True,
                                    name=f"hetu-rank{r}") for r in range(n)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.timeout
        with cv:
            while left[0] and not any(e is not None for e in errors):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                cv.wait(remaining)
        for r, e in enumerate(errors):
            if e is not None:
                self._failed = f"rank {r}: {e!r}"
                raise e
        if left[0]:
            alive = [r for r, t in enumerate(threads) if t.is_alive()]
            self._failed = f"rank(s) {alive} outlived {self.timeout} s"
            raise TimeoutError(
                f"thread rank(s) {alive} of {n} did not finish within "
                f"{self.timeout} s (local_ranks.DEFAULT_TIMEOUT_S): a "
                f"collective hung or a rank is stuck")
        return results

    def _feeds(self, r, feed_dict):
        if not feed_dict:
            return feed_dict
        return {self.maps[r].get(k, k): v for k, v in feed_dict.items()}

    @staticmethod
    def _merge(outs):
        """One list of values from every rank's: each position the first
        rank's that is not None."""
        return [next((o[i] for o in outs if o[i] is not None), None)
                for i in range(len(outs[0]))]

    def run(self, name, feed_dict, convert_to_numpy_ret_vals):
        return self._merge(self.on_ranks(
            lambda r: self.executors[r].run(
                name, feed_dict=self._feeds(r, feed_dict),
                convert_to_numpy_ret_vals=convert_to_numpy_ret_vals)))

    def run_batches(self, feed_dicts, name, convert_to_numpy_ret_vals):
        feed_dicts = list(feed_dicts)
        outs = self.on_ranks(
            lambda r: self.executors[r].run_batches(
                [self._feeds(r, f) for f in feed_dicts], name,
                convert_to_numpy_ret_vals))
        return [self._merge(step) for step in zip(*outs)]

    def save(self, file_path, file_name=None):
        """Every rank where saving gathers shards or splits stages; rank 0
        alone where every rank holds every parameter whole (data
        parallel), as their files would be the same."""
        first = self.executors[0]
        whole = first.config.tp_layouts is None and not (
            first.config.use_gpipe or first.config.use_pipedream)
        if whole:
            return first.save(file_path, file_name)
        self.on_ranks(lambda r: self.executors[r].save(file_path,
                                                       file_name))
        return None

    def each(self, method, *args, **kwargs):
        """``method`` of every rank's executor, on its thread."""
        return self.on_ranks(
            lambda r: getattr(self.executors[r], method)(*args, **kwargs))

    def close(self):
        try:
            if self._failed is None:
                self.each("close")
        finally:
            self.job.close()
