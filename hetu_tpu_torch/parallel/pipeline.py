"""Pipeline-parallel training: GPipe, PipeDream 1F1B and the collective
schedule.

Counterpart of ``hetu_tpu/parallel/pipeline.py`` (reference parity:
SubExecutor4Gpipe, executor.py:457-809, and SubExecutor4Pipedream,
executor.py:812-1337). Users place stages as in the reference — ``with
ht.context(ht.gpu(i)):`` around layer blocks — and pass ``gpipe=True``
or ``pipedream=True`` (with ``num_microbatches``) to the Executor.

* **Stages.** The forward graph splits at context changes
  (:func:`_device_key`); a stage's device wraps around the cards there
  are (``DLContext.torch_device``), so ``gpu(0)``…``gpu(3)`` are four
  stages on one card when it is alone. Placeholders go to their first
  consumer's stage; a feed read by several stages is fed to each.
* **The backward of a stage** is the graph's own gradient ops, as the
  single-device executor runs them: the pipeline builds the gradient
  graph of the loss once with ``autodiff.gradients``, whose ``place``
  hook gives every gradient op the stage of the forward op whose
  ``gradient()`` made it — not its ``raw_ctx``, which ``minimize``
  sets from the last stage's context. A partial adjoint made in a
  later stage crosses back as a boundary, and the graph's own add sums
  the partials of a value several stages read. So the flash attention
  backward (K3, K4) launches in the stage that holds the attention,
  from the residual its forward left in that stage's and microbatch's
  ``ExecContext``.
* **GPipe** (`_run_gpipe`): every microbatch's forward, stage by stage,
  then every backward in reverse stage order, the loss's adjoint seeded
  with 1/M, the gradients summed over microbatches in the parameters'
  dtype, then one optimizer update per stage. It keeps all M
  microbatches' activations (the reference recomputes the forward
  inside its backward instead).
* **PipeDream 1F1B** (`_run_1f1b`): the one order of `_drive_1f1b`,
  one update per stage per microbatch. A microbatch's backward reads the
  weights its forward read — its stash — because they are the tensors
  its walk kept: dense updates are out of place, so stashing keeps
  references, never copies. The microbatch's activations and
  cotangents go with its stash. SGD's sparse update writes the table in
  place and would change a stash, so PipeDream refuses SGD on an
  embedding table.
* **Collective** (`_run_collective`, ``pipeline_mode="collective"``):
  GPipe's math as one tick loop over each stage's device and stream
  (:mod:`.collective_pp`): at tick t stage r runs microbatch t - r, the
  backward is the reverse tick loop, boundaries cross as device tensors
  ordered by events, one update a step. Its contract is the
  reference's: a linear chain of one boundary shape, homogeneous
  stages, the loss on the last, one device a stage (``virtual_stages``
  V > 1: stage i on device i mod S/V), no stage over several ranks,
  all in one process.
* **Across worker processes** (``HETU_NUM_PROCS`` > 1, stages owned by
  ``'worker<k>'`` hostnames or ``HETU_HOSTS``): each rank runs its own
  stages' share of the same global schedule; boundaries cross the host
  channel (:mod:`.p2p`) under tags, whose blocking receives are the
  cross-process schedule. ``pp_options={"virtual_stages": V}`` needs
  round-robin ownership.
* **TP and DP inside a stage** (reference context.py:652-656; JAX
  package pipeline.py:431-460): a stage whose context is a tuple runs on
  one rank a device, ``_owner_of`` each device's hostname in a
  launcher's job, the job's ``device_ranks`` where the ranks are thread
  ranks of one process (:mod:`.local_ranks`; the JAX package drives a
  tuple stage's devices from one process). The
  planner's statuses propagate once over the whole graph, forward and
  backward; a stage whose statuses split something gets a mesh over its
  ranks (:func:`~.mesh.subset_mesh`, every stage's groups made on every
  rank in one order), its nodes' specs over it, and walks through its
  own :class:`~.tensor_parallel.TensorParallel` — a column-split weight
  is TP, a row-split activation (``dispatch(act, (n, 1))``) DP. Its
  parameters and their slots are stored as shards. A tuple stage whose
  statuses split nothing runs on its first rank alone, as the JAX
  package runs it on its first device. A boundary value is made whole
  in the sending group; rank k of the receiving group takes it from rank
  k mod width of the sending group and cuts its own layout locally;
  adjoints cross back alike.

The LR scheduler advances once per global step under every schedule;
all M updates of a 1F1B step share its rate and step count. ``run``
returns the mean of the microbatch losses for the loss node (on the
rank that owns it; None elsewhere) and None for the other eval nodes
and the train op. Dropout draws one stream per (op, microbatch):
``ExecContext.step`` is ``step * M + m``.

Telemetry (the session's): ``pp_fwd_block`` / ``pp_bwd_block`` spans a
stage and microbatch, each also a ``sched`` flight record (a job that
hangs mid-schedule leaves how far each rank got in the black box);
``pp_fill`` / ``pp_steady`` / ``pp_drain`` around 1F1B's phases; a
cross-process receive as ``pp_stage_idle`` with the
``pp_stage<i>_idle_ms`` histogram (the stage's bubble); and the
analytic ``pp_bubble_fraction`` a step.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..dataloader import DataloaderOp, GNNDataLoaderOp
from ..graph.autodiff import find_topo_sort, gradients
from ..graph.node import ExecContext
from ..ndarray import IndexedSlices, NDArray, cpu, gpu
from ..optimizer import Optimizer, OptimizerOp, SGDOptimizer
from ..ops.comm import DispatchOp, PipelineReceiveOp, PipelineSendOp
from ..ops.embedding import EmbeddingLookUp
from ..ops.shape import oneslike_op
from ..ops.variable import PlaceholderOp
from .mesh import Job, factorized_axes, subset_mesh, tp_degree
from .planner import propagate_statuses, spec_for_status
from .tensor_parallel import Layouts, TensorParallel

__all__ = ["PipelineSubExecutor", "analytic_bubble_fraction",
           "virtual_stage_program", "splice_send_recv"]

_NULL_CM = _telemetry._NULL_SPAN       # shared no-op context manager


class _FlightSpan:
    """Span context manager that also completes a flight-ring record on
    exit — one object so stage-block call sites stay a single `with`."""

    __slots__ = ("_tel", "_span", "_rec")

    def __init__(self, tel, span, rec):
        self._tel = tel
        self._span = span
        self._rec = rec

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._tel.flight_complete(self._rec)
        return self._span.__exit__(*exc)


class _Stage:
    __slots__ = ("index", "ctx", "device", "owner", "ranks", "axes", "mesh",
                 "node_spec", "tp", "nodes", "param_nodes", "feed_nodes",
                 "in_nodes", "grad_nodes", "grad_in", "train_params",
                 "free_after", "compute_params")

    def __init__(self, index, ctx):
        self.index = index
        self.ctx = ctx           # its contexts (a tuple), or None
        self.device = None       # None: run by other worker processes
        self.ranks = [0]         # the ranks that run it, one a context
        self.owner = 0           # the first of them
        self.axes = {}           # its plan's model axes, where it splits
        self.mesh = None         # over them, on its ranks
        self.node_spec = {}      # node -> partition spec over that mesh
        self.tp = None           # its TensorParallel walk, on its ranks
        self.nodes = []          # forward ops, topological order
        self.param_nodes = []
        self.feed_nodes = []
        self.in_nodes = []       # forward values from other stages
        self.grad_nodes = []     # this stage's gradient ops
        self.grad_in = []        # adjoint values from later stages
        self.train_params = []
        self.free_after = []     # per position of nodes + grad_nodes
        self.compute_params = None   # {param: value in the compute dtype}


def _device_key(node):
    """Stage identity of a node from its raw_ctx: (hostname, device id)
    of each device of its first context (a tuple context lists several:
    a stage that is model-parallel inside)."""
    ctx = node.raw_ctx
    if ctx is None or ctx.worker_num + ctx.server_num == 0:
        return None
    first = ctx[0]
    if isinstance(first, tuple):
        return tuple((d.hostname, d.device_id) for d in first)
    return ((first.hostname, first.device_id),)


def _drive_1f1b(forward, backward, nstages, M, telemetry=None):
    """The 1F1B order: min(nstages, M) warm-up forwards, then backward
    and forward alternating, then the drain. The one definition every
    runner executes — in one process, and each rank's share across
    processes — which is why their losses agree. ``telemetry``
    brackets the fill / steady / drain phases as spans."""
    warmup = min(nstages, M)
    tel = telemetry
    span = (tel.span if tel is not None and tel.enabled
            else lambda *a, **k: _NULL_CM)
    done_f = done_b = 0
    with span("pp_fill", warmup=warmup):
        for _ in range(warmup):
            forward(done_f)
            done_f += 1
    with span("pp_steady", ticks=max(M - warmup, 0)):
        while done_f < M:
            backward(done_b)
            done_b += 1
            forward(done_f)
            done_f += 1
    with span("pp_drain", ticks=M - done_b):
        while done_b < M:
            backward(done_b)
            done_b += 1


def analytic_bubble_fraction(nstages, M, V=1, schedule="1f1b"):
    """Inherent idle fraction of a pipeline schedule: (S - 1) / (M + S -
    1) for ``nstages`` = S stages and M microbatches; with V virtual
    stages per rank the depth folds to S / V and the schedule runs V·M
    chunk ticks, (S/V - 1) / (V·M + S/V - 1). GPipe and 1F1B share it
    (1F1B lowers memory, not the bubble)."""
    del schedule
    V = max(1, int(V))
    S = max(1, int(nstages))
    if V > 1 and S % V == 0:
        sd = S // V
        return (sd - 1) / (V * M + sd - 1)
    return (S - 1) / (M + S - 1)


def virtual_stage_program(nranks, nstages, M):
    """Per-rank (phase, microbatch, stage) program of the interleaved
    schedule: stage s on rank s % nranks, driven by `_drive_1f1b` —
    forward(m) visits a rank's stages in ascending order, backward(m)
    in descending."""
    progs = {r: [] for r in range(nranks)}

    def forward(m):
        for s in range(nstages):
            progs[s % nranks].append(("fwd", m, s))

    def backward(m):
        for s in reversed(range(nstages)):
            progs[s % nranks].append(("bwd", m, s))

    _drive_1f1b(forward, backward, nstages, M)
    return progs


def _owner_of(hostname, nprocs):
    """Worker-process rank that owns a stage's hostname: 'worker<k>' ->
    k; a name listed in ``HETU_HOSTS`` -> its index; 'localhost' /
    '127.0.0.1' (or any name in one process) -> 0. Any other name in a
    multi-process run raises: a rank-local fallback would resolve one
    stage to different owners on different ranks."""
    if hostname.startswith("worker") and hostname[6:].isdigit():
        return int(hostname[6:]) % max(nprocs, 1)
    hosts = os.environ.get("HETU_HOSTS", "")
    if hosts:
        names = hosts.split(",")
        if hostname in names:
            return names.index(hostname)
    if nprocs > 1 and hostname not in ("localhost", "127.0.0.1"):
        raise ValueError(
            f"stage hostname {hostname!r} does not map to any worker rank "
            f"(nprocs={nprocs}): use 'worker<k>' names or list it in "
            f"HETU_HOSTS")
    return 0


def splice_send_recv(eval_nodes, topo=None):
    """Explicit PipelineSend/Receive markers: pair them in construction
    order (send k with receive k), bind each receive to its send, and
    point every consumer of either at the sent value. Mutates the
    graph; the executor calls it before parameters materialize. Returns
    True if it spliced anything."""
    if topo is None:
        topo = find_topo_sort(eval_nodes)
    recvs = [n for n in topo if isinstance(n, PipelineReceiveOp)]
    if not recvs:
        return False
    # a receive has no input edge, so its send is unreachable from the
    # eval nodes: take the unconsumed sends from the construction
    # registry, and refuse a count mismatch (stale sends of an
    # abandoned graph) rather than wire receives to another graph
    sends = PipelineSendOp.pending()
    if len(sends) != len(recvs):
        raise ValueError(
            f"unpaired pipeline markers: {len(sends)} pending sends against "
            f"{len(recvs)} receives (stale sends of an abandoned graph?): "
            f"build and run pipeline graphs one at a time")
    PipelineSendOp.consume(sends)
    payload = {}
    for s, r in zip(sorted(sends, key=lambda n: n.id),
                    sorted(recvs, key=lambda n: n.id)):
        r.bound_send = s
        payload[r] = s.inputs[0]
        payload[s] = s.inputs[0]
    for node in topo:
        if node not in payload and node.inputs:
            node.inputs = [payload.get(i, i) for i in node.inputs]
    return True


def _accumulate(acc, grad):
    """Sum of two gradients of one parameter: IndexedSlices concatenate
    (the optimizer deduplicates), anything else adds densely."""
    if acc is None:
        return grad
    if isinstance(acc, IndexedSlices) and isinstance(grad, IndexedSlices):
        return IndexedSlices(
            torch.cat([acc.get_flat_indices(), grad.get_flat_indices()]),
            torch.cat([acc.get_dense_rows(), grad.get_dense_rows()]),
            acc.dense_shape)
    if isinstance(acc, IndexedSlices):
        acc = acc.to_dense()
    if isinstance(grad, IndexedSlices):
        grad = grad.to_dense()
    return acc + grad


def _as_dtype(grad, dtype):
    if isinstance(grad, IndexedSlices):
        if grad.values.dtype == dtype:
            return grad
        return IndexedSlices(grad.indices, grad.values.to(dtype),
                             grad.dense_shape)
    return grad if grad.dtype == dtype else grad.to(dtype)


class PipelineSubExecutor:
    """Runs one training subgraph under a pipeline schedule ("gpipe" or
    "1f1b"); ``Executor`` builds it for ``gpipe=True`` /
    ``pipedream=True``."""

    def __init__(self, name, eval_node_list, config, schedule="gpipe",
                 num_microbatches=None):
        if schedule not in ("gpipe", "1f1b", "collective"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.name = name
        self.config = config
        self.schedule = schedule
        optimizer_ops = [n for n in eval_node_list
                         if isinstance(n, OptimizerOp)]
        if len(optimizer_ops) != 1:
            raise ValueError("a pipeline executor runs one training "
                             "subgraph: exactly one train op among its "
                             "eval nodes")
        self.optimizer = optimizer_ops[0].optimizer
        self.eval_nodes = [n for n in eval_node_list
                           if not isinstance(n, OptimizerOp)]
        self.eval_node_list = list(eval_node_list)
        self.loss_node = self.eval_nodes[0]
        self.batch_num = None
        self.step_count = 0

        # the forward graph (HetuConfig has spliced the markers out)
        topo = find_topo_sort(self.eval_nodes)
        for n in topo:
            if n.stateful or isinstance(n, (DataloaderOp, GNNDataLoaderOp)):
                raise NotImplementedError(
                    f"{n.name}: op state (batch norm) and dataloader ops in "
                    f"a pipeline stage are not ported; feed placeholders")
        self._build_stages(topo)
        self._build_backward()
        self._shape_topo = find_topo_sort(
            self.eval_nodes + list(self.param_grad.values()))
        self._wire = {n: i for i, n in enumerate(self._shape_topo)}
        self._plan_stages()
        self.virtual_stages = max(1, int(
            config.pp_options.get("virtual_stages", 1)))
        self.num_microbatches = int(num_microbatches
                                    or max(2, len(self.stages)))
        if self.virtual_stages > 1 and self.multiproc and \
                schedule != "collective":
            # the interleaved schedule is round-robin ownership under the
            # unchanged 1F1B order; a blocked placement would forfeit it
            owners = [tuple(s.ranks) for s in self.stages]
            nr = len(set(owners))
            if len(owners) % nr or any(o != owners[i % nr]
                                       for i, o in enumerate(owners)):
                raise ValueError(
                    f"virtual_stages={self.virtual_stages} needs round-robin "
                    f"stage ownership (stage i on rank i % {nr}); got owners "
                    f"{owners}: cycle the worker contexts V times")
        if schedule == "1f1b" and type(self.optimizer) is SGDOptimizer:
            tables = [n.inputs[0].name for n in topo
                      if isinstance(n, EmbeddingLookUp)
                      and n.inputs[0] in self.train_params]
            if tables:
                raise ValueError(
                    f"pipedream with SGD on the embedding table(s) {tables}: "
                    f"SGD updates a table in place, which would change the "
                    f"weights stashed for microbatches in flight; use "
                    f"gpipe=True or an optimizer whose sparse update is out "
                    f"of place (Adam, AdaGrad)")
        self._feed_shapes = None
        self._cpp = None        # the collective schedule, built at step 1

    # ------------------------------------------------------------------
    def _build_stages(self, topo):
        keys, ctx_of = [], {}
        for node in topo:
            k = _device_key(node)
            if k is None or isinstance(node, PlaceholderOp) or k in keys:
                continue
            keys.append(k)
            first = node.raw_ctx[0]
            ctx_of[k] = first if isinstance(first, tuple) else (first,)
        if not keys:
            keys = [(("localhost", 0),)]
            ctx_of[keys[0]] = None
        key_to_stage = {k: i for i, k in enumerate(keys)}
        stages = [_Stage(i, ctx_of[k]) for i, k in enumerate(keys)]

        assign = {}
        for node in topo:
            if isinstance(node, PlaceholderOp):
                continue
            s = key_to_stage.get(_device_key(node))
            if s is None:
                # unplaced compute follows its deepest input's stage
                s = max((assign.get(i, 0) for i in node.inputs), default=0)
            assign[node] = s
            stages[s].nodes.append(node)
        consumers = {}
        for node in topo:
            if not isinstance(node, PlaceholderOp):
                for inp in node.inputs:
                    if isinstance(inp, PlaceholderOp):
                        consumers.setdefault(inp, set()).add(assign[node])
        for node in topo:
            if not isinstance(node, PlaceholderOp):
                continue
            at = sorted(consumers.get(node, {0}))
            assign[node] = at[0]
            if node.tensor_value is not None or node.initializer is not None:
                if len(at) > 1:
                    raise ValueError(
                        f"parameter {node.name} is read by stages {at}: a "
                        f"parameter lives in one stage (tie weights inside "
                        f"a stage, or give each stage its own)")
                stages[at[0]].param_nodes.append(node)
            else:
                for s in at:
                    stages[s].feed_nodes.append(node)
        self.assign = assign
        self.stages = stages
        # the rank of each device of a stage's context
        self.job = self.config.pp_options.get("job") or Job.from_env()
        self.my_rank = self.job.rank
        owners = self.job.device_ranks
        for st, key in zip(stages, keys):
            st.ranks = [owners[(host, dev)] if (host, dev) in owners
                        else _owner_of(host, self.job.nprocs)
                        for host, dev in key]

    def _plan_stages(self):
        """The stages' plans (JAX package pipeline.py:431-460), then who
        runs each stage and on which device. Statuses propagate once over
        the forward and backward graph; a stage over several ranks whose
        statuses split something gets a mesh over them, its nodes' specs
        over it and a TensorParallel walk, and every rank makes every
        such stage's groups in stage order; one whose statuses split
        nothing keeps its first rank alone."""
        status = propagate_statuses(self._shape_topo)
        for st in self.stages:
            own = set(st.nodes) | set(st.param_nodes) | \
                set(st.feed_nodes) | set(st.grad_nodes)
            sts = {n: s for n, s in status.items() if n in own}
            if not any(s is not None and s.is_dist() for s in sts.values()):
                st.ranks = st.ranks[:1]
            if len(st.ranks) < 2:
                continue
            if len(set(st.ranks)) < len(st.ranks):
                raise ValueError(
                    f"stage {st.index} over the contexts {st.ctx}: their "
                    f"hostnames map to the ranks {st.ranks} of a job of "
                    f"{self.job.nprocs} processes, one process a rank; name "
                    f"each device's worker ('worker<k>' or HETU_HOSTS), or "
                    f"run the script alone (its devices then run as thread "
                    f"ranks)")
            axes = factorized_axes(tp_degree(sts.values()))
            need = int(np.prod(list(axes.values())))
            if need != len(st.ranks):
                raise ValueError(
                    f"stage {st.index}: its tensor-parallel plan {axes} "
                    f"needs {need} ranks, its context {st.ctx} lists "
                    f"{len(st.ranks)}")
            st.axes = axes
            st.mesh = subset_mesh(axes, st.ranks, self.job)
            st.node_spec = {n: spec for n, s in sts.items() for spec in
                            [spec_for_status(s, axes, node=n)]
                            if spec is not None}
            if st.mesh is not None:
                topo = st.param_nodes + st.feed_nodes + st.nodes \
                    + st.grad_nodes
                st.tp = TensorParallel(topo, Layouts(st.mesh, axes),
                                       st.node_spec.get)
        everyone = {r for st in self.stages for r in st.ranks}
        self.multiproc = self.job.nprocs > 1 and len(everyone) > 1
        for st in self.stages:
            if not self.multiproc:
                st.ranks = [self.my_rank]       # this process runs it all
            st.owner = st.ranks[0]
            if self.my_rank not in st.ranks:
                continue            # other processes run it
            if self.config.device.type == "cpu" or st.ctx is None:
                st.device = self.config.device
            else:
                st.device = st.ctx[st.ranks.index(self.my_rank)] \
                    .torch_device()

    def _build_backward(self):
        """The gradient graph of the loss, placed on the stages by
        ``autodiff.gradients`` (every gradient op in the stage of the
        forward op that made it), then each stage's programs, boundaries
        and frees."""
        loss = self.loss_node
        assign = self.assign
        # every trainable parameter the loss reaches, after the splice
        self.train_params = Optimizer.get_var_list(loss)
        self._seed = oneslike_op(loss, ctx=loss.raw_ctx)
        place = dict(assign)
        grads = gradients(loss, self.train_params, self._seed, place)
        self.param_grad = dict(zip(self.train_params, grads))
        stage_of = {n: s for n, s in place.items() if n not in assign}
        bwd = [n for n in find_topo_sort(grads) if n in stage_of]
        for st in self.stages:
            st.grad_nodes = [n for n in bwd if stage_of[n] == st.index]
            st.train_params = [p for p in self.train_params
                               if assign[p] == st.index]
        self.stage_of_grad = stage_of

        # boundaries: every value a stage's program reads that another
        # stage makes — forward values forward, adjoints backward
        self._readers = {}              # value -> stages reading it
        for st in self.stages:
            for node in st.nodes + st.grad_nodes:
                for inp in node.inputs:
                    self._add_edge(st, inp)
        evals = set(self.eval_nodes)

        # frees over each stage's forward + backward walk: a value goes
        # after its last local reader, or when handed over if no local
        # op reads it; the evals and the parameter gradients stay
        for st in self.stages:
            seq = st.nodes + st.grad_nodes
            keep = evals | {self.param_grad[p] for p in st.train_params}
            last = {}
            for i, node in enumerate(seq):
                for inp in node.inputs:
                    last[inp] = i
            for i, node in enumerate(seq):
                last.setdefault(node, i)
            st.free_after = [[] for _ in seq]
            for value, i in last.items():
                if value not in keep:
                    st.free_after[i].append(value)

    def _add_edge(self, st, inp):
        """Record that stage ``st`` reads ``inp`` (see _build_backward)."""
        if inp in self.stage_of_grad:
            src = self.stage_of_grad[inp]
            if src == st.index:
                return
            if src < st.index:
                raise ValueError(
                    f"{inp.name}: an adjoint made in stage {src} is read by "
                    f"the backward of stage {st.index}; the backward runs "
                    f"stages in reverse order")
            if inp not in st.grad_in:
                st.grad_in.append(inp)
        elif isinstance(inp, PlaceholderOp):
            if inp in st.param_nodes or inp in st.feed_nodes:
                return
            if inp.tensor_value is not None or inp.initializer is not None:
                raise ValueError(f"parameter {inp.name} is read by stages "
                                 f"{self.assign[inp]} and {st.index}")
            st.feed_nodes.append(inp)
            return
        else:
            src = self.assign[inp]
            if src == st.index:
                return
            if src > st.index:
                raise ValueError(f"{inp.name} of stage {src} is read by "
                                 f"the earlier stage {st.index}")
            if inp not in st.in_nodes:
                st.in_nodes.append(inp)
        readers = self._readers.setdefault(inp, [])
        if st not in readers:
            readers.append(st)

    # ------------------------------------------------------------------
    def param_devices(self):
        """{parameter: the device of its stage, or None where other
        worker processes run the stage}: where the executor materializes
        each parameter."""
        return {p: st.device for st in self.stages for p in st.param_nodes}

    def param_layouts(self):
        """{parameter: (Layouts, layout)} of this rank's split stages'
        parameters: how each is stored (a layout None is whole)."""
        return {p: (st.tp.lay, st.tp.lay.fit(st.node_spec.get(p),
                                               tuple(p.shape)))
                for st in self._own() if st.tp is not None
                for p in st.param_nodes}

    def writes(self, param):
        """Whether this rank writes ``param`` when the session is saved:
        the first rank of its stage does."""
        return any(param in st.param_nodes and st.owner == self.my_rank
                   for st in self.stages)

    def _own(self):
        return [st for st in self.stages if st.device is not None]

    def _compute_params(self, executor, st):
        """The stage's parameters in the compute dtype (the masters where
        none is set), cast once per weight version."""
        if st.compute_params is None:
            dtype = self.config.dtype
            st.compute_params = {
                p: v.to(dtype) if dtype is not None and v.is_floating_point()
                else v
                for p in st.param_nodes
                for v in [executor.params[str(p.id)]]}
        return st.compute_params

    def _exec_context(self, st, m):
        ectx = ExecContext(training=True, seed=self.config.seed,
                           step=self.step_count * self.num_microbatches + m,
                           device=st.device, config=self.config)
        ectx.params = st.compute_params
        return ectx

    def _tag(self, kind, m, node, st):
        # a node by its place in the graph's topological order: the same
        # in every rank's copy of the graph, where the gradient ops'
        # ids, drawn as each rank's executor builds them, need not be
        return f"{kind}{self.step_count}:{m}:{self._wire[node]}:{st.index}"

    def _hand_over(self, st, m, node, value, kind):
        """Pass a boundary value to every other stage that reads it, made
        whole in ``st``'s group first: rank k of a reading stage takes it
        from rank k mod width of ``st``'s, into its inbox in this
        process, over the channel to another. A tag is unique per (step,
        microbatch, node, reading stage) on the receiving rank."""
        if st.tp is not None:
            value = st.tp.whole(node, value)
        me = st.ranks.index(self.my_rank)
        for reader in self._readers.get(node, ()):
            for k, dst in enumerate(reader.ranks):
                if k % len(st.ranks) != me:
                    continue
                if dst == self.my_rank:
                    self._inbox[(reader.index, m, node)] = \
                        value.to(reader.device) if self._cpp is None \
                        else self._cpp.send(value, reader.index,
                                             reader.device)
                else:
                    self.job.channel().send(
                        dst, self._tag(kind, m, node, reader), value)

    def _take(self, st, m, node, kind):
        """A boundary value the microbatch's ``kind`` ("f" forward, "b"
        backward) walk of ``st`` reads, whole: from its inbox, or the
        channel."""
        src = self.stages[self.stage_of_grad[node] if kind == "b"
                          else self.assign[node]]
        k = st.ranks.index(self.my_rank)
        if src.ranks[k % len(src.ranks)] == self.my_rank:
            value = self._inbox.pop((st.index, m, node))
            return value if self._cpp is None else self._cpp.receive(value)
        return self._recv_traced(self._tag(kind, m, node, st),
                                 st.index).to(st.device)

    def _recv_traced(self, tag, stage_index):
        """Blocking channel recv, recorded as that stage's idle (bubble)
        interval: the time a stage waits on a boundary from another rank
        is its pipeline bubble."""
        tel = self.config.telemetry
        if not tel.enabled:
            return self.job.channel().recv(tag)
        t0 = tel.clock()
        val = self.job.channel().recv(tag)
        t1 = tel.clock()
        tel.complete("pp_stage_idle", t0, t1,
                     {"stage": stage_index, "tag": tag,
                      "bytes": val.numel() * val.element_size()})
        tel.observe(f"pp_stage{stage_index}_idle_ms", (t1 - t0) / 1e6)
        return val

    def _stage_span(self, name, stage_index):
        """Span for one stage's walk of a microbatch (the shared no-op
        when telemetry is off: the kwargs dict builds only on the
        enabled path), also a ``sched`` flight record."""
        tel = self.config.telemetry
        if not tel.enabled:
            return _NULL_CM
        rec = tel.flight_start("sched", name, tag=f"stage{stage_index}")
        return _FlightSpan(tel, tel.span(name, stage=stage_index), rec)

    def _walk(self, st, env, ectx, nodes, offset, m, kind):
        handed = self._readers
        tp = st.tp
        for i, node in enumerate(nodes):
            if node not in env:
                vals = [env[x] for x in node.inputs]
                env[node] = node.compute(vals, ectx) if tp is None \
                    else tp.compute(node, vals, ectx)
            if node in handed:
                self._hand_over(st, m, node, env[node], kind)
            for dead in st.free_after[offset + i]:
                env.pop(dead, None)

    def _forward(self, executor, st, m):
        with self._stage_span("pp_fwd_block", st.index):
            self._forward_walk(executor, st, m)

    def _forward_walk(self, executor, st, m):
        env = dict(self._compute_params(executor, st))
        feeds = self._feeds[(st.index, m)]
        env.update(feeds if st.tp is None else st.tp.shard_feeds(feeds))
        for node in st.in_nodes:
            env[node] = self._take(st, m, node, "f")
        ectx = self._exec_context(st, m)
        self._walk(st, env, ectx, st.nodes, 0, m, "f")
        self._envs[(st.index, m)] = (env, ectx)
        if self.assign[self.loss_node] == st.index:
            loss = env[self.loss_node]
            self._losses.append(loss if st.tp is None
                                else st.tp.whole(self.loss_node, loss))

    def _backward_env(self, st, m):
        """The microbatch's forward environment, its stash: the weights,
        activations and residuals its forward kept for the backward."""
        return self._envs.pop((st.index, m))

    def _backward(self, executor, st, m):
        """The microbatch's backward through the stage: its parameters'
        gradients, in the masters' dtype."""
        with self._stage_span("pp_bwd_block", st.index):
            return self._backward_walk(executor, st, m)

    def _backward_walk(self, executor, st, m):
        env, ectx = self._backward_env(st, m)
        if self.assign[self.loss_node] == st.index:
            env[self._seed] = torch.full_like(env[self.loss_node],
                                              self._seed_scale)
        for node in st.grad_in:
            env[node] = self._take(st, m, node, "b")
        self._walk(st, env, ectx, st.grad_nodes, len(st.nodes), m, "b")
        grads = {}
        for p in st.train_params:
            node = self.param_grad[p]
            g = env[node]
            if st.tp is not None:     # into the parameter's layout
                g = st.tp.to_param(node, p, g, st.tp.layout.get(node))
            grads[p] = _as_dtype(g, executor.params[str(p.id)].dtype)
        return grads

    def _apply(self, executor, st, grads):
        """One optimizer update of the stage's parameters (``grads`` is
        emptied), a parameter at a time: each one's new value and slots
        replace the old before the next is made, and its gradient goes,
        so an update holds one parameter's old and new state at once,
        not the stage's (1F1B updates while other microbatches'
        activations are live)."""
        if not grads:
            return
        for p in list(grads):
            key = str(p.id)
            new_params, new_state = self.optimizer.update(
                {p: executor.params[key]}, {p: grads.pop(p)},
                executor.opt_state, self._lr, self.step_count)
            executor.params[key] = new_params[p]
            executor.opt_state.update(new_state)
        st.compute_params = None

    # -- schedules -------------------------------------------------------
    def _run_gpipe(self, executor, M):
        own = self._own()
        for m in range(M):
            for st in own:
                self._forward(executor, st, m)
        acc = {st.index: {} for st in own}
        for m in range(M):
            for st in reversed(own):
                for p, g in self._backward(executor, st, m).items():
                    acc[st.index][p] = _accumulate(acc[st.index].get(p), g)
        for st in own:
            self._apply(executor, st, acc[st.index])

    def _run_1f1b(self, executor, M):
        own = self._own()

        def forward(m):
            for st in own:
                self._forward(executor, st, m)

        def backward(m):
            for st in reversed(own):
                self._apply(executor, st, self._backward(executor, st, m))

        _drive_1f1b(forward, backward, len(self.stages), M,
                    telemetry=self.config.telemetry)

    def _build_collective(self, executor):
        """The collective schedule over the stages (JAX package
        pipeline.py:1012-1115): the reference's contract, checked in its
        order with its words, then the lanes' streams."""
        from .collective_pp import CollectiveGPipe
        stages = self.stages
        S = len(stages)
        if any(len(st.ranks) > 1 for st in stages):
            raise ValueError(
                "pipeline_mode='collective' does not compose with "
                "in-stage TP/DP meshes yet; use the staged runners")
        if self.multiproc:
            raise ValueError(
                "pipeline_mode='collective' is the in-slice SPMD mode; "
                "stages spanning worker processes keep the staged "
                "runners (the p2p channel is the DCN transport)")
        if S < 2:
            raise ValueError(
                "pipeline_mode='collective' needs >= 2 stages (wrap "
                "layer blocks in distinct ht.context(...) scopes)")
        # a stage's device is its context's (kind, id): gpu(0)..gpu(3)
        # are four devices even where they share one card
        devs = [f"{st.ctx[0].kind}:{st.ctx[0].device_id}" for st in stages]
        V = self.virtual_stages
        if V > 1:
            if S % V != 0:
                raise ValueError(
                    f"virtual_stages={V} must divide the stage count "
                    f"{S}: build V chunks per device (contexts "
                    f"cycling over the same device list V times)")
            s_dev = S // V
            if len(set(devs[:s_dev])) != s_dev or any(
                    devs[i] != devs[i % s_dev] for i in range(S)):
                raise ValueError(
                    f"interleaved collective pipeline needs round-robin "
                    f"placement: stage i on device i % {s_dev} "
                    f"(got {devs}) — cycle the ht.context(...) device "
                    f"list V={V} times over the same devices")
        elif len(set(devs)) != S:
            raise ValueError(
                "pipeline_mode='collective' needs one distinct "
                f"device per stage; got {devs} — on a single chip "
                "use the staged/fused runners instead (or fold "
                "stages with pp_options virtual_stages)")
        loss_stage = self.assign[self.loss_node]
        if loss_stage != S - 1:
            raise ValueError(
                f"collective pipeline expects the loss on the last "
                f"stage (found on stage {loss_stage})")
        exported = [[n for n in self._readers if n in self.assign
                     and self.assign[n] == i] for i in range(S)]
        for i, st in enumerate(stages):
            if i == 0 and st.in_nodes:
                raise ValueError("stage 0 must not consume boundaries")
            if i > 0 and (len(st.in_nodes) != 1 or
                          self.assign[st.in_nodes[0]] != i - 1):
                raise ValueError(
                    f"collective pipeline needs a linear chain with one "
                    f"boundary tensor per stage; stage {i} consumes "
                    f"{[(n.name, self.assign[n]) for n in st.in_nodes]}")
            if i < S - 1 and len(exported[i]) != 1:
                raise ValueError(
                    f"stage {i} must export exactly one boundary tensor "
                    f"(got {len(exported[i])})")
        shapes0 = [tuple(executor.params[str(p.id)].shape)
                   for p in stages[0].param_nodes]
        for st in stages[1:]:
            shp = [tuple(executor.params[str(p.id)].shape)
                   for p in st.param_nodes]
            if shp != shapes0:
                raise ValueError(
                    "collective pipeline needs homogeneous stages: "
                    f"stage {st.index} params {shp} != stage 0 "
                    f"{shapes0} — make the stage blocks uniform or use "
                    "the staged runners")
        first = tuple(exported[0][0].inferred_shape)
        for i in range(1, S - 1):
            shape = tuple(exported[i][0].inferred_shape)
            if shape != first:
                raise ValueError(
                    "collective pipeline needs one uniform boundary "
                    f"shape; stage {i} emits {shape} after {first}")
        opts = {k: v for k, v in self.config.pp_options.items()
                if k not in ("job", "boundary_rtol")}
        opts.setdefault("virtual_stages", V)
        cpp = CollectiveGPipe(S, self.num_microbatches,
                              telemetry=self.config.telemetry, **opts)
        cpp.bind([stages[r].device for r in range(cpp.S_dev)])
        return cpp

    def _run_collective(self, executor):
        """One step of the collective schedule: every tick's forwards on
        their lanes' streams, the reverse ticks' backwards, the gradients
        summed over microbatches on each stage's lane, then one update a
        stage there."""
        cpp = self._cpp
        acc = [{} for _ in self.stages]

        def forward(chunk, m):
            with cpp.on_lane(chunk):
                self._forward(executor, self.stages[chunk], m)

        def backward(chunk, m):
            with cpp.on_lane(chunk):
                grads = self._backward(executor, self.stages[chunk], m)
                for p, g in grads.items():
                    acc[chunk][p] = _accumulate(acc[chunk].get(p), g)

        cpp.begin()
        try:
            cpp.run(forward, backward)
            for st in self.stages:
                with cpp.on_lane(st.index):
                    self._apply(executor, st, acc[st.index])
        finally:
            cpp.end()

    # ------------------------------------------------------------------
    def _split_feeds(self, feed_dict, M):
        """Every stage's feeds of each microbatch, on its device; every
        stage's feed shapes (for shape inference, on every rank)."""
        from ..executor import ingest_value
        missing = sorted({n.name for st in self.stages
                          for n in st.feed_nodes if n not in feed_dict})
        if missing:
            raise ValueError(f"no feed for placeholder(s) {missing}")
        feeds, shapes, done = {}, {}, {}
        every = [n for st in self.stages for n in st.feed_nodes]
        # the collective schedule's replicated transport: every feed on
        # every stage's device
        replicated = self.schedule == "collective" and \
            self.config.pp_options.get("feed_mode") == "replicated"
        for st in self.stages:
            for node in dict.fromkeys(every) if replicated \
                    else st.feed_nodes:
                value = feed_dict[node]
                if isinstance(value, NDArray):
                    value = value.tensor
                elif not isinstance(value, torch.Tensor):
                    value = np.asarray(value)
                rows = value.shape[0]
                if rows % M:
                    raise ValueError(f"{node.name}: batch {rows} is not "
                                     f"divisible into {M} microbatches")
                mb = rows // M
                shapes[node] = (mb,) + tuple(value.shape[1:])
                if st.device is None:
                    continue
                for m in range(M):
                    key = (node, st.device, m)
                    if key not in done:
                        done[key] = ingest_value(value[m * mb:(m + 1) * mb],
                                                 st.device, self.config.dtype)
                    feeds.setdefault((st.index, m), {})[node] = done[key]
        for st in self._own():
            for m in range(M):
                feeds.setdefault((st.index, m), {})
        return feeds, shapes

    def _infer_shapes(self, shapes):
        """``inferred_shape`` on the forward and gradient nodes (gradient
        ops read their forward's input shapes from it) for the
        microbatch's feed shapes: again whenever they changed, or when
        another executor over the same nodes inferred others since."""
        if self._feed_shapes == shapes and all(
                getattr(n, "inferred_shape", None) == s
                for n, s in shapes.items()):
            return
        for node in self._shape_topo:
            if node in shapes:
                node.inferred_shape = shapes[node]
            elif isinstance(node, PlaceholderOp):
                node.inferred_shape = tuple(node.shape)
            else:
                node.inferred_shape = node.infer_shape(
                    [inp.inferred_shape for inp in node.inputs])
        for st in self.stages:
            self._check_splits(st)
            if st.tp is not None and st.device is not None:
                st.tp.classify()
        self._feed_shapes = shapes

    @staticmethod
    def _check_splits(st):
        """Refuse a split that a stage's dispatch asks for and its value's
        shape at the microbatch does not divide, as the JAX package's
        sharding constraint refuses it, where the stage would otherwise
        hold the value whole. Every rank checks every stage, so all of
        them stop before any boundary crosses."""
        for node, spec in st.node_spec.items():
            if not spec or not isinstance(node, (DispatchOp, PlaceholderOp)):
                continue
            shape = tuple(node.inferred_shape)
            for d, entry in enumerate(spec):
                axes = (entry,) if isinstance(entry, str) else entry or ()
                parts = int(np.prod([st.axes[a] for a in axes]))
                if d >= len(shape) or shape[d] % parts:
                    raise ValueError(
                        f"stage {st.index}: {node.name} splits dim {d} of "
                        f"its value of shape {shape} {parts} ways (spec "
                        f"{spec} over {st.axes}), which does not divide "
                        f"it; a microbatch is the batch / num_microbatches "
                        f"rows: make it a multiple of the split")

    def run(self, executor, feed_dict=None, convert_to_numpy_ret_vals=False):
        from ..executor import _EXACT_F32_CONVS
        M = self.num_microbatches
        self._feeds, shapes = self._split_feeds(feed_dict or {}, M)
        self._infer_shapes(shapes)
        if self.schedule == "collective":
            if self._cpp is None:
                with self.config.telemetry.span("cpp_build"):
                    self._cpp = self._build_collective(executor)
            self._cpp.check_feeds([
                [((M,) + shapes[n], self._feeds[(st.index, 0)][n].dtype)
                 for n in st.feed_nodes] for st in self.stages])
        self._lr = float(self.optimizer.learning_rate)
        scale = float(self.optimizer.loss_scale or 1.0)
        self._seed_scale = scale if self.schedule == "1f1b" else scale / M
        self._envs, self._inbox, self._losses = {}, {}, []
        for st in self.stages:      # the weights as the executor holds them
            st.compute_params = None
        exact = self.config.dtype in (None, torch.float32)
        try:
            with _EXACT_F32_CONVS if exact else contextlib.nullcontext():
                if self.schedule == "gpipe":
                    self._run_gpipe(executor, M)
                elif self.schedule == "collective":
                    self._run_collective(executor)
                else:
                    self._run_1f1b(executor, M)
            losses = self._losses
        finally:
            self._feeds = self._envs = self._inbox = self._losses = None
        loss = torch.stack([l.reshape(-1) for l in losses]).mean(0) \
            .reshape(losses[0].shape) if losses else None
        return self._finish_step(loss, convert_to_numpy_ret_vals)

    def _finish_step(self, loss, convert_to_numpy_ret_vals):
        # the LR scheduler advances once per global step under both
        # schedules
        self.optimizer.lr_sched.step()
        self.step_count += 1
        tel = self.config.telemetry
        if tel.enabled:
            # the analytic bubble at this (S, M, V); the measured idle
            # of each stage is the pp_stage_idle spans across processes
            tel.observe("pp_bubble_fraction", self.bubble_fraction)
        out = []
        for node in self.eval_node_list:
            if node is not self.loss_node or loss is None:
                out.append(None)
            elif convert_to_numpy_ret_vals:
                out.append(NDArray(loss).asnumpy())
            else:
                dev = loss.device
                out.append(NDArray(loss, cpu(0) if dev.type == "cpu"
                                   else gpu(dev.index or 0)))
        return out

    @property
    def bubble_fraction(self):
        """analytic_bubble_fraction at this executor's (S, M, V)."""
        return analytic_bubble_fraction(len(self.stages),
                                        self.num_microbatches,
                                        self.virtual_stages)
