"""Executor: define-then-run sessions, run eagerly on one device.

Counterpart of ``hetu_tpu/executor.py``, its single-device path and its
PS and Hybrid modes: ``HetuConfig`` (seed, device, mixed-precision
``dtype``, the communication mode and the PS options), ``SubExecutor``
(one eval subgraph) and ``Executor`` (parameter, op-state and
optimizer-slot materialization, ``run``, ``run_batches``,
``run_batches_stream``, dataloaders and ``get_batch_num``, ``save`` /
``load``, ``close``).

Where the reference traces the topological order once per feed-shape
signature into one XLA program, this executor walks it eagerly every
step, calling each op's ``compute`` on torch tensors (the kernels launch
from there). The mixed-precision rule is the reference's
(``executor.py:695-712``): with ``dtype`` set, floating parameters are
cast to it for compute while the optimizer updates their f32 masters,
floating feeds are cast, integer feeds and parameters are not. Each
intermediate value is dropped after its last consumer, so a step holds
only what the rest of the step still reads.

A graph without ``dtype`` computes in f32, as the reference's does: its
walk runs with cuDNN's TF32 off (``_EXACT_F32_CONVS``), so convolutions
on the card round like the CPU's; PyTorch's matmuls are f32 by default.
The process-wide flag is restored when the last such walk ends.

Op state (batch norm's running statistics) is one ``Executor.state``
shared by every subgraph: created once shapes are known, updated by
training steps, read by the others, which run their ops in inference
mode (no optimizer in the subgraph). Dataloader ops give each run of a
subgraph the next batch of the dataloader of its name; graph loader ops
(``GNNDataLoaderOp``) the current sampled graph's part.

A CSR feed (an ``ND_Sparse_Array``) becomes a ``CSRValue`` on the
device at every run; a ``CSRValue`` already there, as a full-batch
trainer pins its graph once, is used as it is. Its shape is (nrow,
ncol). A DistGCN partition (``DistCSR15d``) puts only the rank's own
(r, c) stages on its device, once a feed object; its shape is
(n_nodes, n_nodes).

**PS and Hybrid** (``comm_mode``, or inferred from the device groups:
a group of GPU workers and CPU servers is PS). The optimizer's graph
pass splices a PS push op onto each PS-managed gradient
(``OptimizerOp.backward_hook``); PS embedding tables never materialize
on the worker, their lookups are fed rows pulled from the server; with
``cstable_policy="Device"`` the lookups are rewritten onto a device
cache (``_rewrite_device_cache``). A subgraph that touches the PS runs
its steps through :class:`~hetu_tpu_torch.ps.runtime.PSRuntime`, which
pulls before :meth:`SubExecutor.step` and pushes after it. The PS mode
runs one worker per process of a launcher's fleet
(:mod:`hetu_tpu_torch.launcher`), any number of them, against any
number of servers. Hybrid puts the dense gradients on allreduce.

**Data parallel** (AllReduce, and Hybrid's dense half): one process a
rank, as a launcher's ``spmd: true`` job starts them. The executor joins
the job's ``torch.distributed`` rendezvous (:func:`maybe_init_distributed`:
NCCL where every rank owns a card, else gloo), and with more than one
rank and no pipeline its rank count is the group's (or the ``dp`` axis
of ``mesh=``, a :func:`~hetu_tpu_torch.parallel.mesh.build_mesh` mesh).
Every rank is fed the global batch, as in the reference: each step runs
on the rank's contiguous row shard of every feed whose dim 0 divides by
the rank count, the optimizer's allreduce ops average the gradients
(``overlap_options["bucket_bytes"]`` buckets them), and the fetched
values are made global
(:class:`~hetu_tpu_torch.parallel.data_parallel.DataParallel`, which
also refuses graphs whose rows are reduced other than by a mean).

**Several devices of one process** (a context of several workers under
AllReduce, a tensor-parallel plan, a pipeline's tuple stage that splits,
or ``mesh=`` a :class:`~hetu_tpu_torch.parallel.mesh.LocalMesh`) outside
a launcher's job: the session runs one thread rank a device, each a
sub-executor on its own clone of the graph, fed the same feeds, the
fetched values returned once (:mod:`~hetu_tpu_torch.parallel.local_ranks`,
whose ``DEFAULT_TIMEOUT_S`` bounds a call).

**Pipelines** (``gpipe=True``, ``pipedream=True`` or
``pipeline_mode="collective"``, with ``num_microbatches`` and
``pp_options``): stages placed by ``with ht.context(...)`` run under
GPipe, PipeDream 1F1B or the collective schedule
(:class:`~hetu_tpu_torch.parallel.pipeline.PipelineSubExecutor`), in one
process or across a launcher's worker processes; each parameter, and
its optimizer slots, lives on its stage's device, and a worker process
materializes only its own stages' parameters.

**Tensor parallel** (``ht.dispatch`` specs, by hand or from
:func:`~hetu_tpu_torch.parallel.autoplan.apply_rules`): without a
pipeline the planner propagates the dispatches' statuses to a partition
spec a node (reference executor.py:320-330,
:mod:`~hetu_tpu_torch.parallel.planner`) over a mesh of the job's ranks,
``("dp", "tp0", ...)`` — ``mesh=`` or, without one, the joined job laid
out by ``mesh_for_statuses``. Each rank draws every parameter whole from
the seed, as one process does, and keeps its shard (its optimizer slots
are the shard's); the step's walk runs through
:class:`~hetu_tpu_torch.parallel.tensor_parallel.TensorParallel`, which
computes each op on the shards or moves values between layouts; fetched
values are made whole; ``save`` gathers (every rank calls it, the mesh's
rank 0 writes) and ``load_params`` slices. Data parallelism then rides
the mesh's ``dp`` axis alone, and its dropout seed is the rank's ``dp``
coordinate. Inside a pipeline the planner runs per stage instead: a
stage whose context is a tuple of devices is split over its own ranks
(:mod:`~hetu_tpu_torch.parallel.pipeline`), its parameters stored as
shards, ``save`` gathering each stage and its first rank writing it.
**Sequence parallel** (``ring_attention_op``, ``ulysses_attention_op``,
the models' ``sequence_parallel``): over a mesh with an ``"sp"`` axis,
``("sp",)`` or ``("dp", "sp")``, the attention ops cut the sequence over
the axis's ranks and gather their output whole; every other op, and
every parameter, is replicated over it, and dropout draws the same
masks on its ranks (the seed is the ``dp`` coordinate's). The axis
beside model axes, in a pipeline or on a parameter server is refused.

**The cost-model planner** (``parallel="auto"``, ``rules=``,
``autoplan_options=``; :mod:`~hetu_tpu_torch.parallel.autoplan`): the
session chooses a (dp, tp, pp) plan for the graph over ``nworld``
devices (the job's world size in a launcher's job, else the card count
on a card, else 1; ``autoplan_options={"nworld": n}`` wins), applies it
(dispatch splices, stage contexts; its schedule, microbatches and
``pp_options`` over the caller's, its dp bucket under the caller's
``overlap_options``, as the reference merges them) and runs it on a
mesh of the job's ranks, or on thread ranks of
this process outside a job; in a job rank 0 plans and every rank takes
its plan, and a rank the plan leaves out runs nothing (``run`` returns
None for every eval node). ``HETU_AUTOPLAN_REPORT`` prints the plan and
exits (the launcher's ``--autoplan``). A ``collective`` plan runs as
``pipeline_mode="collective"``.
**The collective pipeline** (``pipeline_mode="collective"``,
``pp_options``' ``feed_mode``, ``fuse_ticks``, ``unroll_fill_drain``,
``boundary_dtype``, ``virtual_stages``;
:mod:`~hetu_tpu_torch.parallel.collective_pp`): GPipe over a uniform
chain of stages as one tick loop over each stage's device and stream.
**Telemetry** (``telemetry=``, ``log_path=``; :mod:`.telemetry`): a
``step`` span and the ``step_wall_ms`` histogram a ``run``,
``h2d_transfer`` spans and the ``h2d_bytes`` counter a host feed,
``device_dispatch`` around the walk, ``step_block`` around
``run_batches``, the device-memory gauges, the flight recorder's step
ring, the OOM report before an allocator failure re-raises, the
watchdog's heartbeat (``HETU_WATCHDOG_DIR``), and ``close()`` flushing
the per-rank files. No span synchronizes the device. With the fleet
plane armed (``HETU_FLEET``, the launcher's ``--watch``;
:mod:`.telemetry.fleet`) each step window also goes into the rank's
step timeline, its last step ms and top bucket into the heartbeat, and
``/fleet`` is served on the rank's metrics port.
**The health monitor** (``health_options=``, or ``HETU_HEALTH``, which
the launcher's ``--health`` exports; :mod:`.telemetry.health`): on every
``every_n``-th training step the optimizers record each parameter's
gradient norm, nonfinite count and update/weight ratio, PS-pushed
gradients theirs as ``ps:<name>``, beside the step's loss, all stacked
into one float64 tensor that the monitor reads in one copy to the host;
the other steps run as with the monitor off. The PS runtime feeds it the
caches' staleness and the pulls' ids.
**The preflight analysis** (``validate="off"|"warn"|"error"``, or
``HETU_VALIDATE``; :mod:`.analysis`): ``HetuConfig`` analyzes the graph
before it resolves the device, joins a job or reaches a server, keeps
the report as ``analysis_report`` and, under ``"error"``, raises
``GraphValidationError`` on error findings; the first dispatch of each
new feed shape runs the shape pass on the real shapes. Under
``HETU_PREFLIGHT`` (the launcher's ``--preflight``) the first
``HetuConfig`` prints the report, writes its JSON and exits, 0 or
``EXIT_PREFLIGHT`` (121). A PS-backed session driven by a long plain
``run()`` loop logs the HT502 advisory once.
**The range capture** (a ``RangeRecorder`` of
:mod:`.analysis.rangecheck` attached): on the recorder's cadence steps
the walk reduces each floating-point value to its (min, max) on the
device as it makes it, one device tensor the recorder reads in one copy;
the other steps run as with no recorder.
TP on a parameter server is still to port (ROADMAP item 11b.5).
"""
from __future__ import annotations

import contextlib
import glob
import logging
import os
import pickle
import sys
import threading
import time
import warnings
from collections import deque

import numpy as np
import torch

from .context import (DeviceGroup, get_current_context,
                      get_launch_config_by_traverse_nodes)
from .dataloader import DataloaderOp, GNNDataLoaderOp
from .device import resolve_device
from .graph.autodiff import find_topo_sort, gradients
from .graph.node import ExecContext
from .ingest import (IngestEngine, OverlapOptions, new_stats, on_worker,
                     stats_fields, to_device)
from .ndarray import CSRValue, ND_Sparse_Array, NDArray, cpu, gpu
from .optimizer import OptimizerOp
from .ops.comm import (ParameterServerCommunicateOp,
                       ParameterServerSparsePullOp)
from .ops.embedding import EmbeddingLookUp
from .ops.variable import PlaceholderOp
from . import telemetry as _telemetry
from .telemetry import memory as _memory
from .telemetry import fleet as _fleet
from .telemetry import watchdog as _watchdog

__all__ = ["Executor", "HetuConfig", "SubExecutor", "gradients",
           "scheduler_init", "scheduler_finish", "worker_init",
           "worker_finish", "server_init", "server_finish",
           "get_worker_communicate", "maybe_init_distributed",
           "wrapped_mpi_nccl_init", "new_group_comm", "dp_backend"]

logger = logging.getLogger(__name__)

# the reference's options of modes still to port -> their ROADMAP item
_REFUSED_OPTIONS = {}
# HetuConfig's arguments that are not a thread rank's to copy: the rank
# has its own graph, device and mesh (parallel/local_ranks.py)
_NOT_RANK_OPTIONS = ("self", "eval_node_list", "device", "mesh", "options")


def dp_backend(device=None):
    """This rank's choice of collective backend, from the host's
    layout: ``nccl`` where its card is its own (``LOCAL_RANK`` below the
    card count), else ``gloo`` — on the CPU, and where ranks share a card
    (NCCL refuses two ranks on one card). ``gloo`` reduces CUDA tensors
    too, through the host."""
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    if not cuda:
        return "gloo"
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return "nccl" if local < torch.cuda.device_count() else "gloo"


def maybe_init_distributed(device=None):
    """Join the launcher's multi-process job (reference
    executor.py:68-87, where ``jax.distributed`` joins it): with the
    launcher's rendezvous set (``HETU_COORDINATOR``, and the
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` it
    exports beside it), ``torch.distributed.init_process_group`` over
    its TCP store. The backend is decided before the group exists:
    every rank posts :func:`dp_backend` to the store, and the job takes
    ``nccl`` if every rank can, else ``gloo`` (one rank on the CPU, or
    two on one card, makes it gloo). ``dist.get_backend()`` reports it.
    Returns True when it joined now, False when there is nothing to
    join or the group already exists."""
    import datetime
    import torch.distributed as dist
    if "HETU_COORDINATOR" not in os.environ or dist.is_initialized():
        return False
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    # rank 0 of a one-host job serves the socket the launcher claimed
    # for the rendezvous, so no other process can have bound its port
    fd = env.get("HETU_MASTER_LISTEN_FD") if rank == 0 else None
    store = dist.TCPStore(env["MASTER_ADDR"], int(env["MASTER_PORT"]),
                          world, rank == 0,
                          timeout=datetime.timedelta(seconds=300),
                          **({"master_listen_fd": int(fd)} if fd else {}))
    store.set(f"hetu_backend/{rank}", dp_backend(device))
    votes = {store.get(f"hetu_backend/{r}").decode() for r in range(world)}
    dist.init_process_group(backend="nccl" if votes == {"nccl"} else "gloo",
                            store=store, world_size=world, rank=rank)
    # leave the group before the interpreter tears down: a group left to
    # the teardown can abort the process ("terminate called without an
    # active exception", a backend thread destroyed after the thread
    # states are freed)
    import atexit
    atexit.register(_leave_job)
    return True


def _leave_job():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def wrapped_mpi_nccl_init(init_nccl=True, devices=None):
    """The job's communicator (reference executor.py:42-50, which boots
    MPI and NCCL): joins the launcher's job if there is one and returns
    an object with ``rank``, ``nrank`` and ``dev_id()``, the rank's card
    (``LOCAL_RANK``; 0 outside a job)."""
    import torch.distributed as dist
    maybe_init_distributed()

    class _JobComm:
        rank = dist.get_rank() if dist.is_initialized() else 0
        nrank = dist.get_world_size() if dist.is_initialized() else 1

        @staticmethod
        def dev_id():
            count = torch.cuda.device_count()
            local = int(os.environ.get("LOCAL_RANK", "0"))
            return local % count if count else 0

    return _JobComm()


def new_group_comm(devices=None):
    """A communicator over a subgroup of the job's ranks (reference
    executor.py:53-60): ``devices`` lists ranks (or contexts, by their
    device id), None all of them. Every rank must call it, as
    ``torch.distributed.new_group`` is collective; a rank outside the
    subgroup gets None."""
    import torch.distributed as dist
    from .ops.comm import GroupComm
    if devices is None:
        return GroupComm()
    ranks = sorted({int(getattr(d, "device_id", d)) for d in devices})
    group = dist.new_group(ranks)
    return GroupComm(group) if dist.get_rank() in ranks else None


def ingest_value(value, device, dtype=None, staged=False):
    """A feed value on ``device``, floating values in ``dtype`` where it
    is set. ``staged`` copies a host array through pinned memory on the
    side stream (the ingest worker's path,
    :func:`~hetu_tpu_torch.ingest.to_device`)."""
    # a CSR feed: made a CSRValue on the device each run, as the
    # reference does; one already there (a pinned graph) as it is
    if isinstance(value, ND_Sparse_Array):
        return CSRValue.from_sparse_array(value, device)
    if isinstance(value, CSRValue):
        return value.to(device)
    if isinstance(value, NDArray):
        value = value.tensor
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    # float64 feeds (numpy's default, JSON bodies) compute in f32, as
    # the reference's JAX canonicalizes them with 64-bit mode off
    if value.dtype == torch.float64:
        value = value.to(torch.float32)
    if staged and value.device.type == "cpu":
        value = to_device(value, device)
    else:
        value = value.to(device)
    if dtype is not None and value.is_floating_point():
        value = value.to(dtype)
    return value


def _host_bytes(value):
    """The bytes of a feed that crosses from the host, as the reference
    counts them (the host array's own ``nbytes``); None for a value that
    is no host array: a tensor on a device, an ``NDArray``, a CSR feed."""
    if isinstance(value, (NDArray, ND_Sparse_Array, CSRValue)):
        return None
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            return None
        return value.numel() * value.element_size()
    return int(np.asarray(value).nbytes)


def _first_stage_device(eval_node_list):
    """The device of the first op placed by a context, in topological
    order: a pipeline's first stage (its session device)."""
    for node in find_topo_sort(eval_node_list):
        if isinstance(node, PlaceholderOp) or node.raw_ctx is None \
                or not len(node.raw_ctx):
            continue
        first = node.raw_ctx[0]
        return (first[0] if isinstance(first, tuple)
                else first).torch_device()
    return None


class HetuConfig:
    """Session configuration (reference executor.py:107-356): the eval
    nodes, the seed of parameter initialization and of per-op
    generators, the device, the compute dtype, and the PS and Hybrid
    options.

    The device is ``device`` if given, else the first worker (GPU) of
    ``ctx`` or of the enclosing ``ht.context``, else its first context,
    else ``cuda`` — which raises without a GPU
    (:func:`~hetu_tpu_torch.device.resolve_device`).

    PS options, as in the reference: ``comm_mode`` ("PS", "Hybrid",
    "AllReduce" or None to infer it from the device groups), ``bsp``
    (a barrier after every step; else ASP), ``prefetch`` (ASP pushes on
    a background pool), ``cstable_policy`` ("Device" for the device
    cache, LRU / LFU / LFUOpt for the host cache), ``cache_bound``
    (the staleness bound and drain cadence, in steps),
    ``cache_capacity`` (device cache rows; default min(rows, 2^20)) and
    ``drain_compress`` (bf16 drains).

    ``health_options`` (None reads ``HETU_HEALTH``; False, True, a dict,
    a ``k=v,...`` spec or a ``HealthOptions``) arms the training health
    monitor: ``health_monitor`` is a
    :class:`~hetu_tpu_torch.telemetry.health.HealthMonitor`, or None when
    it is off.

    ``overlap_options`` (a dict or ``OverlapOptions``) sets the ingest
    engine of ``run_batches_stream`` and, with ``bucket_bytes``, buckets
    the data-parallel allreduce. ``mesh`` (a
    :class:`~hetu_tpu_torch.parallel.mesh.Mesh`) names the process
    groups: data parallelism runs over its ``dp`` axis; without it, over
    the whole job when one is joined; a graph with tensor-parallel
    dispatches lays them over the mesh's model axes (``tp0``, ``tp1``,
    ...; without ``mesh``, a mesh over the joined job) and
    :meth:`spec_for` names each node's partition; its ``sp`` axis (a
    ``("sp",)`` or ``("dp", "sp")`` mesh) carries the sequence-parallel
    attention ops, everything else replicated over it. ``gpipe`` /
    ``pipedream`` (or ``pipeline_mode="collective"``, which sets
    ``use_gpipe``) train under a pipeline schedule over
    ``num_microbatches`` microbatches (``pp_options``:
    ``virtual_stages``, the collective schedule's knobs, and ``job``, a
    :class:`~hetu_tpu_torch.parallel.mesh.Job` where ranks are not
    processes of a launcher's job); a
    pipeline refuses ``mesh``; without ``ctx`` or ``device`` the session's
    device is then the first stage's. Where the session names several
    devices of this process outside a job, ``local_ranks`` holds the
    plan of its thread ranks (:mod:`~hetu_tpu_torch.parallel.local_ranks`)
    and the config is their template: each rank makes its own from
    ``rank_options``, this call's arguments but the rank's ``device``
    and ``mesh``. The reference's ``train_name``,
    ``val_name``, ``use_sparse_pull``, ``enable_lazy`` and
    ``dynamic_memory`` are accepted and, as there, change nothing.

    ``validate`` (None reads ``HETU_VALIDATE``, default ``"off"``) runs
    the preflight analysis (:meth:`_analyze`) before anything touches a
    device: ``analysis_report`` is its report."""

    def __init__(self, eval_node_list, train_name="default",
                 val_name="default", ctx=None, seed=0, dtype=None,
                 device=None, comm_mode=None, use_sparse_pull=True,
                 bsp=False, prefetch=True, enable_lazy=False,
                 cstable_policy=None, cache_bound=100, cache_capacity=None,
                 drain_compress=False, dynamic_memory=False,
                 overlap_options=None, gpipe=False, pipedream=False,
                 num_microbatches=None, pp_options=None, mesh=None,
                 parallel=None, rules=None, autoplan_options=None,
                 pipeline_mode=None, telemetry=None, log_path=None,
                 health_options=None, validate=None, **options):
        # what a thread rank makes its own config from: every argument
        # but the graph and the rank's own device and mesh
        rank_options = {k: v for k, v in locals().items()
                        if k not in _NOT_RANK_OPTIONS}
        if options:
            items = "; ".join(f"{k}: ROADMAP {_REFUSED_OPTIONS[k]}"
                              for k in sorted(options)
                              if k in _REFUSED_OPTIONS)
            raise TypeError(
                f"HetuConfig options {sorted(options)} are not ported: "
                f"{items or 'not options of the reference either'} (see "
                f"ROADMAP.md)")
        if dtype is not None and not (isinstance(dtype, torch.dtype)
                                      and dtype.is_floating_point):
            raise TypeError(f"dtype must be a floating torch.dtype, got "
                            f"{dtype!r}")
        if comm_mode not in (None, "PS", "Hybrid", "AllReduce"):
            raise ValueError(f"unknown comm_mode {comm_mode!r}; expected "
                             f"'PS', 'Hybrid', 'AllReduce' or None")
        if cstable_policy not in (None, "Device", "LRU", "LFU", "LFUOpt"):
            raise ValueError(
                f"unknown cstable_policy {cstable_policy!r}; expected "
                f"'Device', 'LRU', 'LFU', 'LFUOpt' or None")
        if pipeline_mode not in (None, "collective"):
            raise ValueError(
                f"unknown pipeline_mode {pipeline_mode!r}; expected "
                "'collective' (one tick loop over the stages' devices and "
                "streams) or None (staged gpipe/pipedream runners)")
        if parallel not in (None, "auto"):
            raise ValueError(
                f"unknown parallel={parallel!r}; expected 'auto' (the "
                f"cost-model planner, parallel/autoplan.py) or None")
        # the static preflight (analysis/): "error" rejects a graph with
        # error findings at construction, "warn" logs them, "off" (the
        # default) changes nothing
        if validate is None:
            validate = os.environ.get("HETU_VALIDATE", "off")
        if validate not in ("off", "warn", "error"):
            raise ValueError(
                f"unknown validate={validate!r}; expected 'off', "
                "'warn' or 'error'")
        self.validate = validate
        self.analysis_report = None
        self.eval_node_list = eval_node_list
        # dropout draws key by an op's id less this (graph/node.py
        # generator_for): graphs built before this one do not move them,
        # and a clone of the graph (ids kept) draws the same
        self.op_id_base = min((n.id for n in find_topo_sort(eval_node_list)),
                              default=0)
        self.seed = seed
        self.dtype = dtype
        ctx = ctx if ctx is not None else get_current_context()
        self.context = DeviceGroup(ctx if ctx is not None else [])
        if device is None and len(self.context):
            first = (self.context.workers or list(self.context))[0]
            device = (first[0] if isinstance(first, tuple)
                      else first).torch_device()
        # the cost-model planner (parallel/autoplan.py): choose a plan,
        # apply it to the graph, and take its kwargs; its ranks come as
        # a mesh (a launcher job's ranks, or thread ranks outside one)
        self.autoplan = None
        self.idle = self.alone = False
        if parallel == "auto" or \
                os.environ.get("HETU_AUTOPLAN_REPORT") is not None:
            # a preflight plans where it runs, with no card: as the
            # reference's plans over the launcher machine's devices
            device = torch.device(device or "cpu") \
                if "HETU_PREFLIGHT" in os.environ else resolve_device(device)
            planned = self._autoplan(eval_node_list, device, rules,
                                     num_microbatches, autoplan_options,
                                     train_name)
            gpipe = planned.get("gpipe", gpipe)
            pipedream = planned.get("pipedream", pipedream)
            pipeline_mode = planned.get("pipeline_mode", pipeline_mode)
            num_microbatches = planned.get("num_microbatches",
                                           num_microbatches)
            if "pp_options" in planned:
                pp_options = {**(pp_options or {}), **planned["pp_options"]}
            if "overlap_options" in planned and \
                    not isinstance(overlap_options, OverlapOptions):
                # plan-derived knob defaults (the dp bucket): the user's
                # explicit overlap_options keys win
                overlap_options = {**planned["overlap_options"],
                                   **(overlap_options or {})}
            if mesh is None:
                mesh = planned.get("mesh")
            self.idle = planned.get("idle", False)
            self.alone = planned.get("alone", False)
            # the ranks run the plan this config chose: its kwargs, and
            # no planner of their own
            rank_options.update(gpipe=gpipe, pipedream=pipedream,
                                pipeline_mode=pipeline_mode,
                                num_microbatches=num_microbatches,
                                pp_options=pp_options,
                                overlap_options=overlap_options,
                                parallel=None, autoplan_options=None)
        self.use_gpipe = bool(gpipe) or pipeline_mode == "collective"
        self.use_pipedream = bool(pipedream)
        self.pipeline_mode = pipeline_mode
        self.num_microbatches = num_microbatches
        self.pp_options = dict(pp_options or {})
        pipeline = self.use_gpipe or self.use_pipedream
        # the front session analyzes the graph once; its thread ranks
        # do not again
        self.rank_options = dict(rank_options, ctx=self.context,
                                 validate="off")
        self.overlap = OverlapOptions.resolve(overlap_options)
        # the communication mode, from the argument or the contexts
        self.comm_mode = comm_mode
        launch_mpi, launch_ps, self.node_strategy, _ = \
            get_launch_config_by_traverse_nodes(eval_node_list,
                                                self.context)
        if self.comm_mode is None:
            if launch_ps and launch_mpi:
                self.comm_mode = "Hybrid"
            elif launch_ps:
                self.comm_mode = "PS"
            elif launch_mpi:
                self.comm_mode = "AllReduce"
        # explicit pipeline send/recv markers splice before the analysis
        # and before parameters materialize (reference
        # executor.py:312-316)
        if pipeline:
            from .parallel.pipeline import splice_send_recv
            splice_send_recv(eval_node_list)
        # the preflight, before any device, process group or server is
        # touched: under HETU_PREFLIGHT it exits here
        self._analyze(eval_node_list, device)
        if device is None and pipeline:
            device = _first_stage_device(eval_node_list)
        self.device = resolve_device(device)
        # span tracer + metrics (telemetry/): None follows the
        # process default, which the launcher's --telemetry enables
        # through HETU_TELEMETRY
        self.telemetry = _telemetry.resolve(telemetry)
        self.log_path = log_path
        # the thread ranks share this process's one Telemetry (each
        # records under its own thread id); the front session alone
        # writes the step log
        self.rank_options.update(telemetry=self.telemetry, log_path=None)
        # the training health monitor (telemetry/health.py), made below
        # by a session that runs steps itself: each thread rank has its
        # own. Imported here so the health CLI's module stays a clean
        # runpy target
        from .telemetry import health as _health
        self.health = _health.HealthOptions.resolve(health_options)
        self.health_monitor = None
        # accepted as the reference accepts them: dynamic_memory and
        # enable_lazy are no-ops there too (the allocator and the eager
        # walk's views subsume them), use_sparse_pull and val_name are
        # stored and never read, train_name names the autoplan model
        self.train_name = train_name
        self.val_name = val_name
        self.use_sparse_pull = use_sparse_pull
        self.enable_lazy = enable_lazy
        self.dynamic_memory = dynamic_memory
        maybe_init_distributed(self.device)
        if self.idle:
            self._idle_session()
            return

        self.bsp = bsp
        self.prefetch = prefetch
        self.cstable_policy = cstable_policy
        self.cache_bound = cache_bound
        self.cache_capacity = cache_capacity
        self.drain_compress = drain_compress
        # data parallel: one process a rank, over the mesh's dp axis or
        # the joined job (reference executor.py:276-283, :307-310)
        self.mesh = mesh
        self.dp_comm = None
        if mesh is not None and "sp" in mesh.axis_names:
            self._refuse_sp(mesh, pipeline)
        if pipeline and (mesh is not None or self.comm_mode is not None):
            where = "over mesh=" if mesh is not None \
                else f"in the {self.comm_mode} mode"
            raise NotImplementedError(
                f"a pipeline {where}: "
                f"a pipeline plans each stage over the ranks of its own "
                f"context, so data parallelism inside a stage is a "
                f"row-splitting ht.dispatch(act, (n, 1)) in a stage whose "
                f"context is a tuple of n devices (ROADMAP item 11b.4); "
                f"parameter-server stages are not ported")
        # tensor parallel: the planner's statuses on the user's graph
        # decide the TP degree, and with it the job's mesh (dp x tp)
        self.node_status, self.node_spec, self.model_axes = {}, {}, {}
        self.tp_layouts = None
        from .parallel.mesh import tp_degree
        from .parallel.planner import propagate_statuses
        statuses = propagate_statuses(find_topo_sort(eval_node_list))
        tp = tp_degree(statuses.values())
        if tp > 1 and mesh is not None and "sp" in mesh.axis_names:
            raise NotImplementedError(
                f"sequence parallelism beside a {tp}-way tensor-parallel "
                f"plan: the sp axis beside model axes is ROADMAP item "
                f"11c.1")
        if tp > 1:
            self._refuse_tp(tp)
        # several devices of this process outside a job: thread ranks,
        # each with its own config (parallel/local_ranks.py)
        from .parallel.local_ranks import plan_local_ranks
        self.local_ranks = plan_local_ranks(self, eval_node_list, mesh, tp,
                                            pipeline)
        if self.local_ranks is not None:
            return
        if self.health.enabled:
            self.health_monitor = _health.HealthMonitor(self.health,
                                                        self.telemetry)
        if tp > 1 and not pipeline:     # a pipeline plans per stage
            mesh = self._tp_mesh(statuses, mesh, tp)
            self.mesh = mesh
        if mesh is not None:
            if "dp" in mesh.axis_names:
                self.dp_comm = mesh.comm("dp")
        elif not pipeline and self.comm_mode != "PS" and not self.alone:
            import torch.distributed as dist
            if dist.is_initialized() and dist.get_world_size() > 1:
                from .ops.comm import GroupComm
                self.dp_comm = GroupComm()
        ranks = self.dp_comm.nrank if self.dp_comm is not None else 1
        if self.comm_mode is None and ranks > 1:
            self.comm_mode = "AllReduce"
        self.nrank = ranks if self.comm_mode in ("AllReduce", "Hybrid") \
            else 1
        # the process's rank in a launcher's fleet: HETU_PROC_ID in one
        # job (spmd, several hosts), else HETU_PS_RANK (a PS worker)
        self.rank = int(os.environ.get(
            "HETU_PROC_ID", os.environ.get("HETU_PS_RANK", "0")))
        if self.comm_mode == "Hybrid":
            # each worker process of a fleet sees one worker in its own
            # context: the PS client knows the fleet, and its dense
            # weights stay together only through the job's allreduce
            from .ps.client import get_default_client
            nworkers = get_default_client().nworkers
            if nworkers > 1 and self.nrank != nworkers:
                raise NotImplementedError(
                    f"Hybrid over {nworkers} worker processes with "
                    f"{self.nrank} data-parallel rank(s): the dense "
                    f"weights' allreduce runs over the job's process group "
                    f"(refused on purpose, ROADMAP §3); start the fleet "
                    f"with the launcher's spmd: true")
        self.ps_nodes = []
        self.ps_comm = None
        # the device cache (HET path): PS embedding lookups gather from
        # a cache parameter on the card (ps/device_cache.py); the host
        # cache policies stay on the host path
        self.device_cache_tables = []
        self.ps_dense_cached = []     # [(param, optimizer)], see
        # OptimizerOp.backward_hook's unified dense HET path
        if self.cstable_policy == "Device" and \
                self.comm_mode in ("PS", "Hybrid"):
            self._rewrite_device_cache(eval_node_list)
            self.cstable_policy = None
        # the graph pass: splice the comm ops, then bind contexts and
        # process groups (reference executor.py:314, topo_sort_with_hook)
        for node in reversed(find_topo_sort(eval_node_list)):
            node.backward_hook(self)
        for node in find_topo_sort(eval_node_list):
            node.forward_hook(self)
        # the TP planner (reference executor.py:320-330), on the graph
        # with its comm ops spliced; a pipeline plans each stage instead
        # (parallel/pipeline.py, JAX package executor.py:321-327)
        if tp > 1 and not pipeline:
            from .parallel.planner import assign_states
            from .parallel.tensor_parallel import Layouts
            assign_states(eval_node_list, self)
            self.tp_layouts = Layouts(self.mesh, self.model_axes)
        if self.comm_mode in ("PS", "Hybrid") or self.ps_nodes:
            from .ps.client import get_default_client
            self.ps_comm = get_default_client()

    def _analyze(self, eval_node_list, device):
        """The static preflight (reference executor.py:330-348):
        under ``HETU_PREFLIGHT`` (the launcher's ``--preflight``) analyze
        the graph, print the findings, write the JSON report there and
        exit (:func:`~.analysis.finish_preflight`); under
        ``validate="error"`` raise :class:`~.analysis.GraphValidationError`
        on error findings, under ``"warn"`` log them. The report is
        ``analysis_report``. Called before the device is resolved, the
        job joined or a server reached, so a preflight needs no card."""
        preflight_path = os.environ.get("HETU_PREFLIGHT")
        if preflight_path is None and self.validate == "off":
            return
        from . import analysis
        report = analysis.analyze(eval_node_list, config=self,
                                  device=device)
        self.analysis_report = report
        if preflight_path is not None:
            analysis.finish_preflight(report, preflight_path)
        if self.validate == "error" and report.errors:
            raise analysis.GraphValidationError(report)
        if self.validate == "warn":
            for f in report.errors + report.warnings:
                logger.warning("preflight: %s", f)

    def _autoplan(self, eval_node_list, device, rules, num_microbatches,
                  options, train_name):
        """Choose the session's plan (reference executor.py:129-205):
        ``choose_plan`` over ``autoplan_options`` (``nworld``, ``db``,
        ``feed_shapes``, ``measure``, ``topk``, ``max_pp``, ``model``),
        rank 0's plan on every rank of a launcher's job (rank 0 alone
        measures). Under ``HETU_AUTOPLAN_REPORT`` print the table to
        stderr, write the JSON report there (unless it is ``1`` /
        ``true``), print ``autoplan: OK`` and exit 0 before any fleet
        machinery. Returns :func:`~.parallel.autoplan.plan_overrides`."""
        import sys
        import torch.distributed as dist
        from .parallel import autoplan
        report = os.environ.get("HETU_AUTOPLAN_REPORT")
        if report is None:
            maybe_init_distributed(device)      # plan over the job's world
        opts = dict(options or {})
        if dist.is_initialized() and dist.get_rank() != 0:
            opts.pop("measure", None)
        result = autoplan.choose_plan(
            eval_node_list, rules=rules, num_microbatches=num_microbatches,
            model=opts.pop("model", train_name), device=device,
            dtype=self.dtype, **opts)
        autoplan.agree_on_plan(result)
        self.autoplan = result
        if report is not None:
            import json
            print(result.render(), file=sys.stderr)
            if report not in ("1", "true"):
                try:
                    os.makedirs(os.path.dirname(os.path.abspath(report)),
                                exist_ok=True)
                    with open(report, "w") as f:
                        json.dump(result.to_dict(), f, indent=1)
                        f.write("\n")
                except OSError as e:
                    print(f"autoplan: could not write {report}: {e}",
                          file=sys.stderr)
            print("autoplan: OK", flush=True)
            raise SystemExit(0)
        return autoplan.plan_overrides(eval_node_list, result.plan,
                                       info=result.info, device=device)

    def _idle_session(self):
        """A rank of a launcher's job that the session's plan leaves out:
        it holds nothing and runs nothing; the executor's ``run`` returns
        None for every eval node."""
        self.local_ranks = None
        self.mesh = self.dp_comm = self.tp_layouts = self.ps_comm = None
        self.node_status, self.node_spec, self.model_axes = {}, {}, {}
        self.comm_mode = None
        self.nrank = 1
        self.rank = int(os.environ.get("HETU_PROC_ID", "0"))
        self.ps_nodes = []
        self.device_cache_tables = []
        self.ps_dense_cached = []
        self.bsp = False
        self.cstable_policy = None

    def _refuse_tp(self, degree):
        """A ``degree``-way tensor-parallel plan where the port has none:
        on a parameter server. Raises naming its ROADMAP item."""
        if self.comm_mode in ("PS", "Hybrid"):
            raise NotImplementedError(
                f"tensor parallel ({degree}-way dispatch) in the "
                f"{self.comm_mode} mode: a split parameter on a parameter "
                f"server is not ported (ROADMAP item 11b.5)")

    def _refuse_sp(self, mesh, pipeline):
        """A mesh with an ``"sp"`` axis where the port has no sequence
        parallelism: beside model axes, in a pipeline, on a parameter
        server. Raises naming its ROADMAP item."""
        other = [a for a in mesh.axis_names if a not in ("dp", "sp")]
        if other:
            raise NotImplementedError(
                f"a mesh {mesh.shape}: the sp axis beside model axes "
                f"{other} is ROADMAP item 11c.1; sequence parallelism "
                f"takes ('sp',) or ('dp', 'sp')")
        if pipeline:
            raise NotImplementedError(
                f"a pipeline over a mesh {mesh.shape}: sequence "
                f"parallelism inside a pipeline stage is ROADMAP item "
                f"11c.2")
        if self.comm_mode in ("PS", "Hybrid"):
            raise NotImplementedError(
                f"sequence parallelism in the {self.comm_mode} mode is "
                f"ROADMAP item 11c.3")

    def _tp_mesh(self, statuses, mesh, degree):
        """The session's mesh for a ``degree``-way plan: ``mesh`` if the
        caller gave one (its model axes must be the degree's prime
        factors, ``tp0``, ``tp1``, ...), else one over the joined job,
        ``("dp", "tp0", ...)`` with dp = world / degree."""
        from .parallel.mesh import factorized_axes, mesh_for_statuses
        want = factorized_axes(degree)
        if mesh is not None:
            have = {a: mesh.shape[a] for a in mesh.axis_names if a != "dp"}
            if have != want or list(have) != list(want):
                raise ValueError(
                    f"a {degree}-way tensor-parallel plan needs the model "
                    f"axes {want} beside an optional 'dp' axis; the mesh "
                    f"has {mesh.shape}")
            return mesh
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() else 1
        return mesh_for_statuses(statuses.values(),
                                 dp=max(1, world // degree))[0]

    def spec_for(self, node):
        """The partition spec the TP planner assigned ``node`` (None: it
        is replicated)."""
        return self.node_spec.get(node)

    def _rewrite_device_cache(self, eval_node_list):
        """Rewrite PS embedding lookups onto device-cache parameters
        (reference executor.py:362-445). For each PS-managed table T
        read by ``EmbeddingLookUp(T, ids)``:

          * a cache parameter ``[capacity + 1, width]`` (the last row is
            the scratch slot) replaces T in the graph and in the
            optimizer's parameters — the worker optimizer applies the
            local sparse update in the step;
          * a slots placeholder replaces ``ids`` in the lookup and its
            gradient, fed each step from the PS runtime's id -> slot
            map;
          * T itself lives only on the server; the runtime registers it
            and drains the accumulated gradients to it.
        """
        from .initializers import ZerosInit
        from .ops.embedding import EmbeddingLookUpGradient

        topo = find_topo_sort(eval_node_list)
        lookups_by_table = {}
        for n in topo:
            if not isinstance(n, EmbeddingLookUp):
                continue
            tbl = n.inputs[0]
            if not (isinstance(tbl, PlaceholderOp) and tbl.trainable):
                continue
            strategy = self.node_strategy.get(tbl) or self.comm_mode
            if strategy not in ("PS", "Hybrid"):
                continue
            lookups_by_table.setdefault(tbl, []).append(n)
        if not lookups_by_table:
            return
        grads = [n for n in topo if isinstance(n, EmbeddingLookUpGradient)]
        optimizer_ops = [n for n in topo if isinstance(n, OptimizerOp)]

        for tbl, lookups in lookups_by_table.items():
            rows, width = int(tbl.shape[0]), int(np.prod(tbl.shape[1:]))
            capacity = min(rows, int(self.cache_capacity or (1 << 20)))
            cache = PlaceholderOp(
                f"{tbl.name}__dcache",
                initializer=ZerosInit((capacity + 1, width)),
                trainable=True)
            cache.is_embed = True
            cache.device_cached = True
            cache.cache_table = tbl
            cache.stateful = True
            cache.state_shapes = \
                lambda shapes, c=capacity + 1, w=width: {"acc": (c, w)}
            slots_by_ids = {}
            slots_of_lookup = {}
            for lk in lookups:
                ids = lk.inputs[1]
                if ids not in slots_by_ids:
                    slots_by_ids[ids] = PlaceholderOp(
                        f"{tbl.name}__slots{len(slots_by_ids)}",
                        trainable=False, dtype=np.int32)
                slots_of_lookup[lk] = slots_by_ids[ids]
            for g in grads:
                if g.forward_node in slots_of_lookup:
                    g.inputs = [g.inputs[0], slots_of_lookup[g.forward_node]]
                    g.embed_shape = (capacity + 1, width)
            for lk in lookups:
                lk.inputs = [cache, slots_of_lookup[lk]]
            table_opt = None
            for opt_op in optimizer_ops:
                params = opt_op.optimizer.params
                for i, p in enumerate(params):
                    if p is tbl:
                        params[i] = cache
                        table_opt = opt_op.optimizer
            self.device_cache_tables.append({
                "table": tbl, "cache": cache,
                "slots_by_ids": dict(slots_by_ids),
                "capacity": capacity, "width": width, "rows": rows,
                "optimizer": table_opt,
            })


class _ExactF32Convs:
    """Turns cuDNN's TF32 off while any f32 walk runs and restores the
    caller's setting when the last one ends. The flag is the process's,
    and threads (serving batchers) walk concurrently, so the walks are
    counted under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    def __enter__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
            self._depth += 1

    def __exit__(self, *exc):
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                torch.backends.cudnn.allow_tf32 = self._saved


_EXACT_F32_CONVS = _ExactF32Convs()


class SubExecutor:
    """Runs one eval subgraph (reference executor.py:1340-1864)."""

    def __init__(self, name, eval_node_list, config):
        self.name = name
        self.eval_node_list = eval_node_list
        self.config = config
        self.topo_order = find_topo_sort(eval_node_list)
        self.topo_set = set(self.topo_order)
        self.optimizer_ops = [n for n in self.topo_order
                              if isinstance(n, OptimizerOp)]
        self.training = bool(self.optimizer_ops)
        self.param_nodes = [n for n in self.topo_order
                            if isinstance(n, PlaceholderOp)
                            and (n.tensor_value is not None
                                 or n.initializer is not None)]
        self.feed_nodes = [n for n in self.topo_order
                           if isinstance(n, PlaceholderOp)
                           and n not in self.param_nodes]
        self.dataloader_ops = [n for n in self.topo_order
                               if isinstance(n, (DataloaderOp,
                                                 GNNDataLoaderOp))]
        self.stateful_ops = [n for n in self.topo_order if n.stateful]
        # the PS side (reference executor.py:519-533): push ops, pull
        # ops, lookups of PS tables (fed rows pulled from the server)
        # and lookups of device caches (fed slots). PS-managed params
        # are known session-wide (config.ps_nodes), so an eval subgraph
        # sharing a PS table also routes its lookups through the PS
        self.ps_ops = [n for n in self.topo_order
                       if isinstance(n, ParameterServerCommunicateOp)]
        self.ps_pull_ops = [n for n in self.topo_order
                            if isinstance(n, ParameterServerSparsePullOp)]
        ps_params = {op.parameter for op in config.ps_nodes}
        self.ps_lookups = [n for n in self.topo_order
                           if isinstance(n, EmbeddingLookUp)
                           and n.inputs[0] in ps_params]
        self.cached_lookups = [n for n in self.topo_order
                               if isinstance(n, EmbeddingLookUp)
                               and getattr(n.inputs[0], "device_cached",
                                           False)]
        # PS embedding tables never materialize on the worker
        self._ps_tables = {n for n in self.param_nodes
                           if n in ps_params and n.is_embed}
        self.param_nodes = [n for n in self.param_nodes
                            if n not in self._ps_tables]
        self.needs_ps = bool(self.ps_ops or self.ps_lookups
                             or self.ps_pull_ops or self.cached_lookups)
        self._host_ops = set(self.ps_ops) | self._ps_tables
        # batches an epoch: the fewest any of its dataloaders gives (a
        # graph loader has no count), those too whose ids the device-cache
        # rewrite took out of the graph (the PS runtime drives them; the
        # reference counts only the ones left in it, so its validate
        # subgraph over a device cache has no batch count)
        detached = [ids for entry in config.device_cache_tables
                    for ids, slots in entry["slots_by_ids"].items()
                    if slots in self.topo_set]
        self.batch_num = min((dl.get_batch_num(name)
                              for dl in self.dataloader_ops + detached
                              if isinstance(dl, DataloaderOp)), default=None)
        self.step_count = 0
        self._shapes_key = None
        # the health monitor's: a sampled step's sentinels until read,
        # and the name of the eval output it took for the loss
        self._last_health = None
        self._health_loss_name = None
        # an attached RangeRecorder's capture (analysis/rangecheck.py):
        # None, or the object the walk hands each value of a captured
        # step to
        self._range_capture = None
        # data parallel over the session's ranks: the feeds' row shards
        # in, the fetched values made global out
        self.dp = None
        if config.nrank > 1:
            from .parallel.data_parallel import DataParallel
            self.dp = DataParallel(self, config.dp_comm)
        # tensor parallel: every node laid out over the mesh's model axes
        self.tp = None
        if config.tp_layouts is not None:
            from .parallel.tensor_parallel import TensorParallel
            self.tp = TensorParallel(self.topo_order, config.tp_layouts,
                                     config.spec_for)
        self.allreduce_defer = None
        if config.nrank > 1 and config.overlap.bucket_bytes:
            from .ops.comm import optimizer_allreduce_ops
            self.allreduce_defer = optimizer_allreduce_ops(
                self.topo_order, self.optimizer_ops, eval_node_list)
        # the step index after which each value is dead: its last
        # consumer's position, or never for what the caller fetches and
        # for the gradients the PS runtime pushes after the step
        keep = set(eval_node_list) | set(self.param_nodes) \
            | set(self.feed_nodes) | set(self.dataloader_ops) \
            | {op.inputs[0] for op in self.ps_ops}
        last = {}
        for i, node in enumerate(self.topo_order):
            for inp in node.inputs:
                last[inp] = i
        self._free_after = [[] for _ in self.topo_order]
        for node, i in last.items():
            if node not in keep:
                self._free_after[i].append(node)

    def _infer_shapes(self, feed_map):
        """Set ``inferred_shape`` on every node (gradient ops read their
        forward's input shapes from it), as the reference does once per
        feed-shape signature."""
        if self.config.validate != "off":
            self._validate_shapes(feed_map)
        for node in self.topo_order:
            if node in feed_map:
                shape = tuple(feed_map[node].shape)
            elif isinstance(node, PlaceholderOp):
                shape = tuple(node.shape)
            else:
                shape = node.infer_shape(
                    [inp.inferred_shape for inp in node.inputs])
            node.inferred_shape = shape

    def _validate_shapes(self, feed_map):
        """The first dispatch's half of the preflight (reference
        executor.py:593-627): with the real feed shapes known, run the
        analysis shape pass, so a mismatch raises a
        ``GraphValidationError`` naming the user's line instead of an
        op's assertion inside ``infer_shape``. Under
        ``Executor(validate=...)`` only, once a new feed-shape key."""
        from . import analysis
        feed_shapes = {}
        for node, v in feed_map.items():
            dtype = getattr(v, "dtype", None)
            feed_shapes[node] = (tuple(v.shape), dtype
                                 if isinstance(dtype, torch.dtype) else None)
        report = analysis.Report()
        analysis.shape_pass(self.topo_order, report,
                            feed_shapes=feed_shapes)
        session = self.config.analysis_report
        if session is not None:
            # one report a session: a new feed-shape key adds no finding
            # it holds already
            seen = {(f.code, f.node, f.where, f.message)
                    for f in session.findings}
            session.extend(f for f in report.findings
                           if (f.code, f.node, f.where, f.message)
                           not in seen)
        if report.errors:
            if self.config.validate == "error":
                raise analysis.GraphValidationError(report)
            for f in report.errors + report.warnings:
                logger.warning("preflight: %s", f)

    def _ensure_state(self, executor):
        """Create the state of this subgraph's stateful ops that the
        session does not hold yet — 1 for a key naming a variance, else
        0 — and refuse held state (loaded from a checkpoint) whose keys
        or shapes differ from what the op now needs."""
        for node in self.stateful_ops:
            shapes = {k: tuple(shape) for k, shape in node.state_shapes(
                [inp.inferred_shape for inp in node.inputs]).items()}
            held = executor.state.get(str(node.id))
            if held is None:
                executor.state[str(node.id)] = {
                    k: torch.full(shape, 1.0 if "var" in k else 0.0,
                                  dtype=torch.float32,
                                  device=self.config.device)
                    for k, shape in shapes.items()}
            elif {k: tuple(v.shape) for k, v in held.items()} != shapes:
                raise ValueError(
                    f"{node.name}: state {sorted(held)} of shapes "
                    f"{[tuple(v.shape) for v in held.values()]} does not "
                    f"match the op's {shapes}")

    def _ingest(self, value, staged=False):
        from .parallel.distgcn import DistCSR15d
        mesh = self.config.mesh
        if isinstance(value, DistCSR15d):
            # a DistGCN partition: only this rank's (r, c) stages move
            # (off a ("gr", "gc") mesh the op itself refuses it)
            if mesh is None or not {"gr", "gc"} <= set(mesh.axis_names):
                return value
            return value.local(mesh.coord("gr"), mesh.coord("gc"),
                               self.config.device)
        tel = self.config.telemetry
        if tel.enabled:
            nbytes = _host_bytes(value)
            if nbytes is not None:
                # h2d attribution: bytes on the span + running counter
                # (the copy is issued, not awaited: the span times the
                # host side); `overlapped` marks the ingest worker's
                with tel.span("h2d_transfer", bytes=nbytes,
                              overlapped=on_worker()):
                    out = ingest_value(value, self.config.device,
                                       self.config.dtype, staged)
                tel.inc("h2d_bytes", nbytes)
                return out
        return ingest_value(value, self.config.device, self.config.dtype,
                            staged)

    def _stack_feed(self, values):
        """A block's per-step values of one feed -> ``(tensor, tiled)``:
        the same host array every step is transferred once and read by
        every step (``tiled``); else the values are stacked into one
        ``[nsteps, ...]`` transfer that step k indexes."""
        first = values[0]
        if all(v is first for v in values):
            return self._ingest(first, staged=True), True
        return self._ingest(np.stack([np.asarray(v) for v in values]),
                            staged=True), False

    def run(self, executor, feed_dict=None, convert_to_numpy_ret_vals=False):
        if self.needs_ps:
            if executor.ps_runtime is None:
                raise RuntimeError("a PS-mode graph needs the parameter-"
                                   "server runtime")
            return executor.ps_runtime.run_step(
                self, feed_dict, convert_to_numpy_ret_vals)
        feed_dict = feed_dict or {}
        missing = [n.name for n in self.feed_nodes if n not in feed_dict]
        if missing:
            raise ValueError(f"no feed for placeholder(s) {missing}")
        env = {node: self._ingest(feed_dict[node])
               for node in self.feed_nodes}
        for dl in self.dataloader_ops:
            env[dl] = self._ingest(dl.get_arr(self.name))
        outputs, _ = self.step(executor, env)
        hm = self.config.health_monitor
        if hm is not None and self.training:
            hm.after_step(self)
        return self.results(outputs, convert_to_numpy_ret_vals)

    def step(self, executor, feed_map):
        """One step over ``feed_map`` (every fed node's device value:
        feeds, dataloader batches and, on the PS path, pulled rows and
        cache slots). Returns the eval nodes' values (None for an
        optimizer) and the gradients of the PS push ops, which the PS
        runtime pushes."""
        config = self.config
        key = tuple((n.id, tuple(v.shape), v.dtype)
                    for n, v in feed_map.items())
        dp = self.dp
        if dp is not None:
            global_feed, feed_map = feed_map, dp.shard(feed_map)
        tp = self.tp
        if key != self._shapes_key:
            if dp is not None:
                dp.classify(global_feed, feed_map)
            else:
                self._infer_shapes(feed_map)
            if tp is not None:
                tp.classify()
            self._ensure_state(executor)
            self._shapes_key = key
        if tp is not None:
            feed_map = tp.shard_feeds(feed_map)

        # each data-parallel rank draws its own dropout masks for its
        # rows (dp.rank is the rank's coordinate on the dp axis: the
        # ranks of one tensor-parallel group draw the same masks)
        seed = config.seed if dp is None else \
            config.seed * 1_000_003 + dp.rank
        ectx = ExecContext(training=self.training, seed=seed,
                           step=self.step_count, device=config.device,
                           config=config)
        ectx.allreduce_defer = self.allreduce_defer
        hm = config.health_monitor
        if hm is not None and self.training and \
                hm.wants(self.step_count + 1):
            ectx.health_sentinels = []      # a sampled step
        params = {n: executor.params[str(n.id)] for n in self.param_nodes}
        if config.dtype is not None:
            ectx.master_params = params
            params = {n: v.to(config.dtype) if v.is_floating_point() else v
                      for n, v in params.items()}
        ectx.params = params
        ectx.opt_state = executor.opt_state
        ectx.state = {n: executor.state[str(n.id)] for n in self.stateful_ops}
        for opt in self.optimizer_ops:
            ectx.lr = float(opt.optimizer.learning_rate)
        env = dict(feed_map)
        env.update(params)
        host_ops = self._host_ops
        tel = config.telemetry
        # the range capture reduces each value as the walk makes it, on
        # the recorder's cadence only: off it, the walk is unchanged
        cap = self._range_capture
        if cap is not None and not cap.wants(self.step_count + 1):
            cap = None
        with _EXACT_F32_CONVS if config.dtype in (None, torch.float32) \
                else contextlib.nullcontext(), \
                tel.span("device_dispatch", subgraph=self.name) \
                if tel.enabled else _telemetry._NULL_SPAN:
            for i, node in enumerate(self.topo_order):
                if node not in env:
                    # a PS push op or an unmaterialized PS table: the PS
                    # runtime works on them between steps
                    vals = [env[n] for n in node.inputs]
                    env[node] = None if node in host_ops \
                        else node.compute(vals, ectx) if tp is None \
                        else tp.compute(node, vals, ectx)
                if cap is not None:
                    cap.observe(i, env[node])
                for dead in self._free_after[i]:
                    env.pop(dead, None)
            if cap is not None:
                cap.end_step()

        if self.training:
            for node, value in ectx.new_params.items():
                executor.params[str(node.id)] = value
            for node, value in ectx.new_state.items():
                executor.state[str(node.id)] = value
            executor.opt_state = ectx.new_opt_state
            for opt in self.optimizer_ops:
                opt.optimizer.lr_sched.step()
        self.step_count += 1
        outputs = [None if isinstance(node, OptimizerOp) else env[node]
                   for node in self.eval_node_list]
        if tp is not None:
            outputs = tp.fetch(self.eval_node_list, outputs)
        if dp is not None:
            outputs = dp.fetch(self.eval_node_list, outputs)
        ps_grads = [env[op.inputs[0]] for op in self.ps_ops]
        if ectx.health_sentinels is not None:
            self._last_health = self._health_values(ectx.health_sentinels,
                                                    outputs, ps_grads)
        return outputs, ps_grads

    def _health_values(self, sentinels, outputs, ps_grads):
        """A sampled step's sentinels for the health monitor (reference
        executor.py:741-787) as ``{"names", "loss", "values"}``:
        ``values`` is one float64 tensor, three a layer (the optimizers'
        parameters by name, a repeated name suffixed ``#2``, ``#3``, ...;
        each PS-pushed gradient as ``ps:<name>``), then the loss where
        ``loss``. The loss is the first scalar floating eval output whose
        name says loss, else the first scalar one."""
        from .optimizer import sentinel_rows
        names, rows = [], []
        for chunk, chunk_rows in sentinels:
            names += chunk
            rows.append(chunk_rows)
        pushed = [(op, g) for op, g in zip(self.ps_ops, ps_grads)
                  if g is not None and hasattr(op, "parameter")]
        if pushed:
            names += [f"ps:{op.parameter.name}" for op, _ in pushed]
            rows.append(sentinel_rows([None] * len(pushed),
                                      [g for _, g in pushed],
                                      [None] * len(pushed)))
        seen = set()
        for i, name in enumerate(names):
            key, k = name, 2
            while key in seen:
                key, k = f"{name}#{k}", k + 1
            seen.add(key)
            names[i] = key
        parts = [r.reshape(-1) for r in rows]
        loss_node, loss_val = None, None
        for node, v in zip(self.eval_node_list, outputs):
            if isinstance(node, OptimizerOp) or \
                    not isinstance(v, torch.Tensor) or v.numel() != 1 or \
                    not v.is_floating_point():
                continue
            if "loss" in (node.name or "").lower():
                loss_node, loss_val = node, v
                break
            if loss_node is None:
                loss_node, loss_val = node, v
        if loss_node is not None:
            parts.append(loss_val.reshape(1).double())
            self._health_loss_name = loss_node.name
        values = torch.cat(parts) if parts else torch.zeros(
            0, dtype=torch.float64, device=self.config.device)
        return {"names": names, "loss": loss_node is not None,
                "values": values}

    def results(self, outputs, convert_to_numpy_ret_vals=False):
        """A step's values as ``run`` returns them: NDArrays, or numpy
        with ``convert_to_numpy_ret_vals``."""
        ctx = _context_of(self.config)
        return [None if value is None
                else NDArray(value).asnumpy() if convert_to_numpy_ret_vals
                else NDArray(value, ctx) for value in outputs]


class _IdleSubExecutor:
    """A subgraph on a rank that the session's plan leaves out
    (``parallel="auto"`` in a launcher job with fewer ranks in the plan
    than in the job): every run returns None for every eval node."""

    def __init__(self, name, eval_node_list):
        self.name = name
        self.eval_node_list = eval_node_list
        self.batch_num = None
        self.step_count = 0
        self.multiproc = False

    def run(self, executor, feed_dict=None, convert_to_numpy_ret_vals=False):
        self.step_count += 1
        return [None] * len(self.eval_node_list)

    def writes(self, node):
        return False


def _context_of(config):
    dev = config.device
    return cpu(0) if dev.type == "cpu" else gpu(dev.index or 0)


class Executor:
    """Session over one or more eval subgraphs (reference
    executor.py:317-455)."""

    def __init__(self, eval_node_dict, config=None, **kargs):
        if not isinstance(eval_node_dict, dict):
            eval_node_dict = {"default": eval_node_dict}
        self.eval_node_dict = eval_node_dict
        all_eval_nodes = []
        for nodes in eval_node_dict.values():
            for n in nodes:
                if n not in all_eval_nodes:
                    all_eval_nodes.append(n)
        if config is None:
            config = HetuConfig(eval_node_list=all_eval_nodes, **kargs)
        self.config = config
        # the step timeline (reference profiler hooks): a compatibility
        # wrapper over the telemetry sink, one JSON line a step
        self.step_logger = None
        if config.log_path:
            from .profiler import StepLogger
            self.step_logger = StepLogger(config.log_path,
                                          telemetry=config.telemetry)
        # the watchdog's heartbeat, armed by the launcher's
        # --hang-timeout (HETU_WATCHDOG_DIR); None otherwise, so the
        # disabled path costs one `is None` check a step. Thread ranks
        # beat through the front session's (parallel/local_ranks.py)
        self._heartbeat = _watchdog.heartbeat_from_env()
        # the fleet step timeline (telemetry/fleet.py), armed by the
        # launcher's --watch (HETU_FLEET): None otherwise, so the
        # disabled path stays one `is None` check a step. The injected
        # straggler fault (HETU_FAULT_SLOW_RANK) rides the same plane.
        # A front session of thread ranks holds none: each rank holds
        # its own, named by its rank
        self._fleet_timeline = None
        self._fault_slow_s = 0.0
        self._metrics_server = False
        if config.local_ranks is None:
            self._arm_fleet(config)
        # several devices of this process: one thread rank each, and this
        # session their front (parallel/local_ranks.py)
        self._threads = None
        if config.local_ranks is not None:
            from .parallel.local_ranks import LocalRanks
            self._threads = LocalRanks(eval_node_dict, config)
            return
        if config.idle:
            # a rank of the job that the session's plan leaves out
            self.params, self.opt_state, self.state = {}, {}, {}
            self._param_nodes, self._stage_layouts = {}, {}
            self._stateful_ops = []
            self.subexecutors = {name: _IdleSubExecutor(name, nodes)
                                 for name, nodes in eval_node_dict.items()}
            self.ps_runtime = self._run_loop_advisor = None
            self._ingest_stats = new_stats()
            return

        # parameters: f32 masters (integer parameters keep their dtype)
        # drawn from numpy with the reference's name-seeded draw
        self.params = {}
        self.opt_state = {}
        self.state = {}
        self._param_nodes = {}
        topo = find_topo_sort(all_eval_nodes)
        # stateful ops in creation order: how load_state matches them
        self._stateful_ops = sorted((n for n in topo if n.stateful),
                                    key=lambda n: n.id)
        ps_embeds = {op.parameter for op in config.ps_nodes
                     if op.parameter.is_embed}
        # a pipeline places each parameter on its stage's device, and a
        # worker process materializes only its own stages' (None); a
        # split stage stores its shards
        placement = None
        self._stage_layouts = {}
        if config.use_gpipe or config.use_pipedream:
            from .parallel.pipeline import PipelineSubExecutor
            if config.pipeline_mode == "collective":
                schedule = "collective"
            else:
                schedule = "gpipe" if config.use_gpipe else "1f1b"
            self.subexecutors = {
                name: PipelineSubExecutor(name, nodes, config, schedule,
                                          config.num_microbatches)
                for name, nodes in eval_node_dict.items()}
            placement = {}
            for sub in self.subexecutors.values():
                placement.update(sub.param_devices())
                self._stage_layouts.update(sub.param_layouts())
        for node in topo:
            if node in ps_embeds:
                continue        # lives on the PS server only
            if isinstance(node, PlaceholderOp) and (
                    node.tensor_value is not None
                    or node.initializer is not None):
                device = config.device if placement is None \
                    else placement.get(node)
                if device is None:
                    continue        # another worker process's stage
                if getattr(node, "device_cached", False) and node.is_embed:
                    # cache rows fill from the server on a miss: zeros
                    # made on the device, no table-sized host transfer
                    value = torch.zeros(node.shape, dtype=torch.float32,
                                        device=device)
                else:
                    # drawn whole, as one process draws it; a rank of a
                    # tensor-parallel session keeps its shard
                    value = self._local(node, torch.from_numpy(
                        np.ascontiguousarray(
                            node.initial_value(seed=config.seed))))
                    value = value.contiguous().to(device)
                self.params[str(node.id)] = value
                self._param_nodes[str(node.id)] = node
        if placement is None:
            for nodes in eval_node_dict.values():
                for n in find_topo_sort(nodes):
                    if isinstance(n, OptimizerOp):
                        self.opt_state.update(n.optimizer.init_state(
                            {p: self.params[str(p.id)]
                             for p in n.optimizer.params
                             if str(p.id) in self.params}))
            self.subexecutors = {name: SubExecutor(name, nodes, config)
                                 for name, nodes in eval_node_dict.items()}
        else:
            # the slots of what the pipeline trains: every trainable
            # parameter the loss reaches once markers are spliced
            for sub in self.subexecutors.values():
                self.opt_state.update(sub.optimizer.init_state(
                    {p: self.params[str(p.id)] for p in sub.train_params
                     if str(p.id) in self.params}))
        # the PS runtime: registers the PS tensors on the server now,
        # so save() and load() work before the first step
        self.ps_runtime = None
        if config.ps_comm is not None:
            from .ps.runtime import PSRuntime
            self.ps_runtime = PSRuntime(self, config)
        self._ingest_stats = new_stats()
        # the HT502 advisory (analysis/overlap.py): a PS-backed session
        # driven by a long plain run() loop never reaches the ingest
        # engine. None off the PS, so a step costs one `is None` check
        self._run_loop_advisor = None
        if self.ps_runtime is not None:
            from .analysis.overlap import RunLoopAdvisor
            self._run_loop_advisor = RunLoopAdvisor(config)

    def __getattr__(self, name):
        # a session of thread ranks reads its first rank's state
        # (parameters, optimizer slots, subexecutors)
        local = self.__dict__.get("_threads")
        if local is None or name.startswith("__"):
            raise AttributeError(name)
        return getattr(local.executors[0], name)

    @property
    def ranks(self):
        """The thread ranks' executors (a one-process session: itself)."""
        return [self] if self._threads is None else self._threads.executors

    def _arm_fleet(self, config):
        """The fleet plane of this session (reference executor.py:1338-
        1350): the step timeline and the straggler fault, by the thread
        rank running this constructor where there is one
        (``local_ranks.thread_rank``), else by the process's rank. With
        ``HETU_METRICS_PORT`` (the launcher's ``--watch``) the registry
        serves ``/metrics`` and ``/fleet`` on the port the launcher
        claimed for this rank (``HETU_METRICS_LISTEN_FD``); a thread
        session's rank 0 serves for the process."""
        from .parallel.local_ranks import thread_rank
        tel = config.telemetry
        rank = thread_rank()
        self._fleet_timeline = _fleet.timeline_from_env(tel, rank=rank)
        self._fault_slow_s = _fleet.fault_slow_from_env(rank=rank)
        port = os.environ.get("HETU_METRICS_PORT")
        if not (port and tel.enabled and rank in (None, 0)):
            return
        reg = tel.metrics
        if self._fleet_timeline is not None:
            reg.fleet_source = self._fleet_timeline.fleet_json
        if reg.serving:
            return
        fd = os.environ.pop("HETU_METRICS_LISTEN_FD", None)
        if fd is not None:
            import socket
            tel.serve_metrics(int(port), sock=socket.socket(fileno=int(fd)))
        else:
            try:
                tel.serve_metrics(int(port))
            except OSError as e:
                # a port given but not claimed (a multi-host job's base
                # port) may be taken: the monitor reads the flushed
                # timeline from disk instead
                print(f"fleet: metrics port {port} not served ({e}); "
                      f"the monitor reads this rank's timeline from disk",
                      file=sys.stderr)
                return
        self._metrics_server = True

    def _beat(self, step):
        """The watchdog's heartbeat, with the fleet timeline's last step
        ms and top bucket when the plane is armed (a thread session's:
        rank 0's)."""
        tl = self._fleet_timeline if self._threads is None \
            else self._threads.executors[0]._fleet_timeline
        if tl is not None:
            ms, top = tl.summary()
            self._heartbeat.beat(step, step_ms=ms, top_bucket=top)
        else:
            self._heartbeat.beat(step)

    def run(self, name="default", eval_node_list=None, feed_dict=None,
            convert_to_numpy_ret_vals=False):
        if isinstance(name, dict) and feed_dict is None:
            feed_dict, name = name, "default"     # positional run(feeds)
        if self.step_logger is not None:
            self.step_logger.begin()
        if self._threads is not None:
            # each thread rank records its own step span
            out = self._threads.run(name, feed_dict,
                                    convert_to_numpy_ret_vals)
        else:
            name = self._sub_name(name)
            sub = self.subexecutors[name]
            if self._run_loop_advisor is not None:
                self._run_loop_advisor.on_run_step()
            tel = self.config.telemetry
            tl = self._fleet_timeline
            try:
                if tel.enabled:
                    t0 = time.perf_counter()
                    t0_ns = tel.clock() if tl is not None else 0
                    with tel.span("step", subgraph=name):
                        if self._fault_slow_s:
                            time.sleep(self._fault_slow_s)
                        out = sub.run(self, feed_dict,
                                      convert_to_numpy_ret_vals)
                    wall_ms = (time.perf_counter() - t0) * 1000.0
                    tel.observe("step_wall_ms", wall_ms)
                    if tl is not None:
                        tl.on_step(sub.step_count, t0_ns, tel.clock(),
                                   wall_ms)
                    # black box: the step boundary into the flight ring,
                    # and the allocator's live/peak bytes (a host read)
                    tel.flight_step(sub.step_count)
                    _memory.observe_device_memory(tel)
                else:
                    if self._fault_slow_s:
                        time.sleep(self._fault_slow_s)
                    out = sub.run(self, feed_dict,
                                  convert_to_numpy_ret_vals)
            except Exception as e:
                if _memory.is_oom(e):
                    self._report_oom(e)
                raise
        if self._heartbeat is not None:
            self._beat(self._sub(name).step_count)
        if self.step_logger is not None:
            self.step_logger.end(self, subgraph=name)
        return out

    def _sub_name(self, name):
        if name not in self.subexecutors and "default" in self.subexecutors:
            name = "default"
        return name

    def _sub(self, name):
        return self.subexecutors[self._sub_name(name)]

    def _report_oom(self, exc):
        """Allocator-failure post-mortem: print (and write into the
        telemetry dir) the largest live tensors, named parameters first,
        before the error re-raises, so the OOM names tensors instead of
        just a byte count."""
        named = {node.name: self.params[sid]
                 for sid, node in self._param_nodes.items()
                 if sid in self.params}
        text = _memory.oom_report(
            named_params=named, out_dir=self.config.telemetry.out_dir,
            rank=self.config.telemetry.rank, device=self.config.device)
        print(text, file=sys.stderr)

    def run_batches(self, feed_dicts, name="default",
                    convert_to_numpy_ret_vals=False):
        """One step per feed dict: a list of per-step output lists. An
        empty feed dict takes the subgraph's dataloaders' next batch.
        The reference compiles the block into one ``lax.scan`` dispatch;
        the port's walk is eager, so this is the same math as that many
        ``run`` calls. A device-cached PS graph runs the block through
        :meth:`PSRuntime.run_block`: slots for the whole block are
        assigned up front, as in the reference."""
        if self._threads is not None:
            return self._threads.run_batches(feed_dicts, name,
                                           convert_to_numpy_ret_vals)
        sub = self._sub(name)
        if isinstance(sub, _IdleSubExecutor):
            return [sub.run(self) for _ in feed_dicts]
        if self._run_loop_advisor is not None:
            self._run_loop_advisor.on_stream()
        if not isinstance(sub, SubExecutor):
            raise ValueError(
                "run_batches is not supported for gpipe/pipedream "
                "executors — the pipeline schedule already amortizes "
                "dispatch over microbatches; call run() per step")
        tel = self.config.telemetry
        # the fleet timeline's window is the block, weighted by its steps
        tl = self._fleet_timeline if tel.enabled else None
        if tl is not None:
            t0, t0_ns = time.perf_counter(), tel.clock()
        try:
            with tel.span("step_block", steps=len(feed_dicts),
                          subgraph=self._sub_name(name)) \
                    if tel.enabled else _telemetry._NULL_SPAN:
                if self._fault_slow_s:
                    time.sleep(self._fault_slow_s * len(feed_dicts))
                if sub.needs_ps:
                    out = self.ps_runtime.run_block(
                        sub, feed_dicts, convert_to_numpy_ret_vals)
                else:
                    out = [sub.run(self, feeds, convert_to_numpy_ret_vals)
                           for feeds in feed_dicts]
        except Exception as e:
            if _memory.is_oom(e):
                self._report_oom(e)
            raise
        if tl is not None:
            tl.on_step(sub.step_count, t0_ns, tel.clock(),
                       (time.perf_counter() - t0) * 1000.0,
                       steps=len(feed_dicts))
        if tel.enabled:
            tel.flight_step(sub.step_count)
            _memory.observe_device_memory(tel)
        if self._heartbeat is not None:
            self._beat(sub.step_count)
        return out

    def run_batches_stream(self, blocks, name="default",
                           convert_to_numpy_ret_vals=False,
                           lookahead=None):
        """``run_batches`` over an iterable of blocks with the ingest
        engine hiding the host (reference executor.py:1520-1580): for a
        device-cached PS graph, the engine's worker stacks and
        transfers the next ``lookahead`` blocks' feeds while a block
        runs (slot assignment stays in order on the caller); host-path
        PS and BSP graphs run per step through
        :meth:`PSRuntime.run_stream_pipelined`, the next steps' feed
        transfer and SparsePull on the worker. Other graphs run their
        blocks one after another. Returns the last block's results."""
        if self._threads is not None:
            raise NotImplementedError(
                "run_batches_stream over thread ranks: call run_batches")
        lookahead = self.config.overlap.lookahead if lookahead is None \
            else lookahead
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        sub = self._sub(name)
        if self._run_loop_advisor is not None:
            self._run_loop_advisor.on_stream()
        if not isinstance(sub, SubExecutor):
            raise ValueError(
                "run_batches_stream is not supported for pipeline "
                "executors — the pipeline schedule already amortizes "
                "dispatch over microbatches; call run() per step")
        blocks = iter(blocks)
        gnn = any(isinstance(dl, GNNDataLoaderOp)
                  for dl in sub.dataloader_ops)
        if not sub.needs_ps or gnn or not self.config.overlap.ingest:
            out = None
            for block in blocks:
                out = self.run_batches(block, name,
                                       convert_to_numpy_ret_vals)
            return out
        rt = self.ps_runtime
        if sub.ps_lookups or sub.ps_pull_ops or sub.ps_ops \
                or self.config.bsp:
            return rt.run_stream_pipelined(
                sub, blocks, convert_to_numpy_ret_vals,
                lookahead=lookahead, sink=self._ingest_stats)

        def fetch_dl(block):
            # dataloaders advance state: their batches are fetched in
            # block order here; the worker only stacks and transfers
            if not sub.dataloader_ops:
                return None
            return {dl: [dl.get_arr(sub.name) for _ in block]
                    for dl in sub.dataloader_ops}

        cur = next(blocks, None)
        if cur is None:
            return None
        out = None
        engine = IngestEngine(self.config.telemetry, lookahead=lookahead,
                              sink=self._ingest_stats)
        blocks_enum = enumerate(blocks, start=1)
        pending = deque()
        with engine:    # an error cancels the queued ingests

            def refill():
                while engine.depth < lookahead:
                    i, nxt = next(blocks_enum, (None, None))
                    if nxt is None:
                        return
                    pending.append(nxt)
                    engine.submit(rt.ingest_feeds, sub, nxt,
                                  fetch_dl(nxt), tag=i)

            tel = self.config.telemetry
            tl = self._fleet_timeline if tel.enabled else None
            pre = rt.ingest_feeds(sub, cur, fetch_dl(cur))    # priming
            refill()
            while cur is not None:
                steps = len(cur)
                if tl is not None:
                    t0, t0_ns = time.perf_counter(), tel.clock()
                # the window covers the block AND the wait for the next
                # block's ingest, so an exposed host stall lands in it
                with tel.span("step_block", steps=steps,
                              subgraph=self._sub_name(name)) \
                        if tel.enabled else _telemetry._NULL_SPAN:
                    if self._fault_slow_s:
                        time.sleep(self._fault_slow_s * steps)
                    out = rt.run_block(sub, cur, convert_to_numpy_ret_vals,
                                       pre_ingested=pre)
                    if pending:
                        cur = pending.popleft()
                        _, pre = engine.pop()
                        refill()
                    else:
                        cur, pre = None, None
                if tl is not None:
                    tl.on_step(sub.step_count, t0_ns, tel.clock(),
                               (time.perf_counter() - t0) * 1000.0,
                               steps=steps)
                if self._heartbeat is not None:
                    self._beat(sub.step_count)
        return out

    def ingest_stats(self):
        """Async-ingest accounting since the last reset: the p50 of the
        consumer's stalls (``ingest_wait_ms``), wait and busy sums, and
        ``overlap_fraction`` (the share of ingest host time hidden
        behind the device)."""
        return stats_fields(self._ingest_stats)

    def reset_ingest_stats(self):
        self._ingest_stats = new_stats()

    def get_batch_num(self, name="default"):
        """Batches in an epoch of subgraph ``name``: the fewest any of
        its dataloaders gives (None without dataloaders)."""
        if self._threads is not None:
            return self.ranks[0].get_batch_num(name)
        return self.subexecutors[name].batch_num

    @property
    def batch_num(self):
        if len(self.subexecutors) != 1:
            raise ValueError("batch_num needs a single subgraph: use "
                             "get_batch_num(name)")
        return next(iter(self.subexecutors.values())).batch_num

    # ------------------------------------------------------------------
    def _by_name(self):
        by_name = {}
        for sid, node in self._param_nodes.items():
            if node.name in by_name:
                raise ValueError(
                    f"two parameters share the name {node.name!r} (node ids "
                    f"{by_name[node.name]} and {sid}): their .npy files "
                    f"would overwrite each other; give the variables "
                    f"distinct names")
            by_name[node.name] = sid
        return by_name

    def _tp_of(self, node):
        """(Layouts, layout) of a parameter: its pipeline stage's or the
        session's; the layout None where it is held whole."""
        if node in self._stage_layouts:
            return self._stage_layouts[node]
        tp = self.config.tp_layouts
        return (None, None) if tp is None else \
            (tp, tp.fit(self.config.spec_for(node), tuple(node.shape)))

    def _layout(self, node):
        """A parameter's tensor-parallel layout (None: held whole)."""
        return self._tp_of(node)[1]

    def _local(self, node, value):
        """This rank's shard of a parameter's (or slot's) whole value."""
        lay, layout = self._tp_of(node)
        return value if layout is None else lay.local(value, layout)

    def _whole(self, node, value):
        """A parameter's (or slot's) whole value from every rank's shard:
        a collective over its group under tensor parallelism."""
        lay, layout = self._tp_of(node)
        return value if layout is None else \
            lay.redistribute(value, layout, None)[0]

    def _writes(self, node):
        """Whether this rank writes ``node`` in ``save``: every parameter
        in one process; a tensor-parallel session's mesh rank 0; a
        pipeline stage's first rank its stage's."""
        subs = [s for s in self.subexecutors.values()
                if not isinstance(s, SubExecutor)]
        if subs:
            return any(s.writes(node) for s in subs)
        return self.config.tp_layouts is None or not self.config.mesh.rank

    def save(self, file_path, file_name=None):
        """One ``<name>.npy`` per parameter (the f32 masters) plus
        optimizer slots and op state (keyed by op id) in a sidecar
        pickle — ``hetu_tpu``'s layout (reference executor.py:376-434).
        A tensor-parallel session saves whole tensors: every rank calls
        ``save`` (the shards are gathered) and the mesh's rank 0
        writes. Across a pipeline's worker processes each stage's first
        rank writes its stage's, the sidecar of a rank k > 0 under the
        name suffixed ``.rank<k>``, which ``load`` reads beside it. Thread
        ranks save as those processes would."""
        if self._threads is not None:
            return self._threads.save(file_path, file_name)
        if self.config.idle:
            return None
        nodes = {node.id: node for node in self._param_nodes.values()}
        params = {sid: self._whole(node, self.params[sid])
                  for sid, node in self._param_nodes.items()}
        slots_of = {k: {s: self._whole(nodes[k], t) if k in nodes else t
                        for s, t in slots.items()}
                    for k, slots in self.opt_state.items()}
        mine = {sid: node for sid, node in self._param_nodes.items()
                if self._writes(node)}
        if not mine and (self._param_nodes or self.config.tp_layouts
                         is not None):
            return
        os.makedirs(file_path, exist_ok=True)
        self._by_name()
        for sid, node in mine.items():
            np.save(os.path.join(file_path, node.name + ".npy"),
                    NDArray(params[sid]).asnumpy())
        slots_of = {k: v for k, v in slots_of.items()
                    if k not in nodes or str(k) in mine}
        sidecar = {
            "opt_state": {k: {s: NDArray(t).asnumpy()
                              for s, t in slots.items()}
                          for k, slots in slots_of.items()},
            "state": {k: {s: NDArray(t).asnumpy() for s, t in vals.items()}
                      for k, vals in self.state.items()},
            "id_to_name": {sid: node.name for sid, node in mine.items()},
        }
        name = file_name or "session.ckpt"
        rank = self._pipeline_rank()
        if rank:
            name += f".rank{rank}"
        with open(os.path.join(file_path, name), "wb") as f:
            pickle.dump(sidecar, f)
        if self.ps_runtime is not None:
            # the server's tensors, one ps_<id>.bin each, after every
            # pending push has landed
            self.ps_runtime.save(file_path)

    def load(self, file_path, file_name=None):
        """Read what ``save`` — this package's or ``hetu_tpu``'s — wrote:
        parameters by name, optimizer slots by the sidecar's id -> name
        map, op state as ``load_state`` matches it, and the PS tensors
        into the server (``ps_<id>.bin``, by tensor id: the graph must be
        built as the saving one was). A parameter without a file keeps
        its value, with a warning."""
        if self._threads is not None:
            self._threads.each("load", file_path, file_name)
            return
        values = {}
        for node in self._param_nodes.values():
            path = os.path.join(file_path, node.name + ".npy")
            if os.path.exists(path):
                values[node.name] = np.load(path)
            else:
                warnings.warn(
                    f"checkpoint {file_path} has no file for parameter "
                    f"{node.name!r} ({node.name}.npy); keeping its current "
                    f"value", stacklevel=2)
        self.load_params(values)
        ckpt = os.path.join(file_path, file_name or "session.ckpt")
        if os.path.exists(ckpt):
            self._load_sidecar(ckpt)
        # the other pipeline ranks' slots (see save)
        for extra in sorted(glob.glob(glob.escape(ckpt) + ".rank*")):
            self._load_sidecar(extra, state=False)
        if self.ps_runtime is not None:
            self.ps_runtime.load(file_path)

    def _load_sidecar(self, ckpt, state=True):
        # the sidecar is a pickle of plain dicts and numpy arrays written
        # by Executor.save of this package or of hetu_tpu
        with open(ckpt, "rb") as f:
            sidecar = pickle.load(f)
        if state:
            self.load_state(sidecar["state"])
        node_of = {node.name: node for node in self._param_nodes.values()}
        for key, slots in sidecar["opt_state"].items():
            node = node_of.get(sidecar["id_to_name"].get(str(key)))
            if node is None or node.id not in self.opt_state:
                continue
            mine = self.opt_state[node.id]
            self.opt_state[node.id] = {
                s: self._local(node, torch.as_tensor(
                    np.asarray(v), dtype=mine[s].dtype)).contiguous().to(
                    mine[s].device)
                for s, v in slots.items() if s in mine}

    def load_state(self, state):
        """Set op state (batch norm's running statistics) from ``{op id:
        {key: array}}``, as an executor of this package or of
        ``hetu_tpu`` holds and saves it. Op ids differ between graphs,
        so ops are matched in creation order: ascending id in ``state``
        against this session's stateful ops by ascending id, which the
        same builders create in the same order. A different number of
        ops raises here; a key or shape an op does not have raises at the
        next run, where shapes are inferred again. Empty ``state`` (saved
        before any step) leaves every op to start afresh."""
        if self._threads is not None:
            self._threads.each("load_state", state)
            return
        theirs = sorted(state.items(), key=lambda item: int(item[0]))
        if theirs and len(theirs) != len(self._stateful_ops):
            raise ValueError(
                f"state of {len(theirs)} ops for a session with "
                f"{len(self._stateful_ops)} stateful ops "
                f"({[n.name for n in self._stateful_ops]})")
        self.state = {
            str(node.id): {k: torch.tensor(np.asarray(v),
                                           dtype=torch.float32,
                                           device=self.config.device)
                           for k, v in values.items()}
            for node, (_, values) in zip(self._stateful_ops, theirs)}
        for sub in self.subexecutors.values():
            sub._shapes_key = None

    def load_params(self, values):
        """Set parameters from ``{name: array}``; names the session does
        not have are ignored, shapes must match (the whole shape: a
        tensor-parallel rank keeps its shard)."""
        if self._threads is not None:
            self._threads.each("load_params", values)
            return
        by_name = self._by_name()
        for name, value in values.items():
            sid = by_name.get(name)
            if sid is None:
                continue
            old, node = self.params[sid], self._param_nodes[sid]
            value = np.asarray(value)
            want = tuple(node.shape) if self._layout(node) is not None \
                else tuple(old.shape)
            if tuple(value.shape) != want:
                raise ValueError(f"parameter {name!r}: checkpoint shape "
                                 f"{value.shape} != {want}")
            self.params[sid] = self._local(node, torch.as_tensor(
                value, dtype=old.dtype)).contiguous().to(old.device)

    def _pipeline_rank(self):
        """This process's rank in a pipeline across worker processes,
        else 0."""
        return max((s.my_rank for s in self.subexecutors.values()
                    if getattr(s, "multiproc", False)), default=0)

    def recordLoads(self):
        """The PS client's load counter (reference executor.py:1724);
        {} without a PS."""
        if self.config.ps_comm is not None:
            return self.config.ps_comm.get_loads()
        return {}

    def close(self):
        """Flush in-flight PS work (ASP pushes, device-cache drains) and
        stop the push pool (thread ranks close theirs and their job's
        channels), release the step logger's file, mark the heartbeat
        done, close the health monitor, and write this rank's telemetry
        files when an output directory is configured."""
        if self._threads is not None:
            self._threads.close()
        elif self.ps_runtime is not None:
            self.ps_runtime.close()
        if self.step_logger is not None:
            self.step_logger.close()
            self.step_logger = None
        if self._heartbeat is not None:
            # clean completion: the watchdog stops counting this rank
            self._heartbeat.done()
        if self.config.health_monitor is not None:
            self.config.health_monitor.close()
        if self._fleet_timeline is not None:
            self._fleet_timeline.close()
        if self._metrics_server:
            self.config.telemetry.metrics.shutdown()
            self._metrics_server = False
        self.config.telemetry.flush()


def scheduler_init():
    from .ps.server import ensure_scheduler
    ensure_scheduler()


def scheduler_finish():
    from .ps.server import shutdown_scheduler
    shutdown_scheduler()


def server_init():
    from .ps.server import ensure_server
    ensure_server()


def server_finish():
    from .ps.server import shutdown_server
    shutdown_server()


def worker_init():
    from .ps.client import get_default_client
    get_default_client()


def worker_finish():
    from .ps.client import close_default_client
    close_default_client()


def get_worker_communicate():
    from .ps.client import get_default_client
    return get_default_client()
