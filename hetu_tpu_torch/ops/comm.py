"""Communication ops: the data-parallel allreduce, the PS and Hybrid
modes' push and pull, and the pipeline's boundaries.

Counterpart of ``hetu_tpu/ops/comm.py`` (reference parity:
gpu_ops/AllReduceCommunicate.py, gpu_ops/ParameterServerCommunicate.py,
gpu_ops/DataTransfer.py, gpu_ops/PipelineSend.py,
gpu_ops/PipelineReceive.py).

* :class:`AllReduceCommunicateOp` averages a gradient over the
  session's data-parallel ranks (one process each, ``torch.distributed``;
  :class:`GroupComm`): a dense gradient is summed and divided by the
  rank count, as the reference's ``lax.pmean``; an ``IndexedSlices``
  gradient is all-gathered, indices and values / nrank. At one rank it
  is the identity. With ``overlap_options["bucket_bytes"]`` the
  optimizer settles its dense gradients in buckets instead
  (:func:`settle_deferred_allreduce`).
  :class:`GroupAllReduceCommunicateOp` reduces over one axis of the
  session's mesh (:mod:`~hetu_tpu_torch.parallel.mesh`).
* :class:`ParameterServerCommunicateOp` pushes a gradient to the
  parameter server (and, for a dense parameter, pulls the updated
  value back). It is a *host op*: the executor never computes it; the
  PS runtime takes its input gradient after the step and pushes it,
  and the optimizer skips the parameter (the server updates it).
* :class:`ParameterServerSparsePullOp` pulls embedding rows for given
  ids — the inference path. Also a host op: the PS runtime feeds its
  value before the step.
* :class:`DispatchOp` (``dispatch``) marks a tensor-parallel partition
  and :class:`DispatchGradientOp` mirrors it in the backward; the
  tensor-parallel realization moves their values between layouts.

The gradients' collectives and the tensor-parallel layouts' are
``all_reduce`` calls: an all-gather there is an ``all_reduce`` of a
zeroed ``[nrank, ...]`` buffer in which each rank fills its slot
(:meth:`GroupComm.gather_rows`), which also takes row counts that differ
between ranks. It moves about twice an all-gather's bytes; putting
gloo's all-gather in its place is a performance item of ``ROADMAP.md``.
Sequence parallelism uses the group's own collectives: an all-gather
(:meth:`GroupComm.all_gather`), an all-to-all
(:meth:`GroupComm.all_to_all`) and a ring hop
(:meth:`GroupComm.ring_shift`, the reference's ``lax.ppermute``). Gloo's
all-gather and all-to-all take CUDA tensors (they copy them through the
host themselves); its send and receive read a CUDA tensor's pointer as
host memory, so on a gloo group a hop's CUDA tensors go through pinned
host copies.

With telemetry on, each collective of :class:`GroupComm` is a span with
the bytes this rank put in and its stats kind: ``allreduce`` for an
all_reduce (the means and row gathers are made of them),
``collective_all_gather``, ``collective_all_to_all`` and
``collective_ring``. The perf doctor's ``collective`` bucket reads them
and the fleet timeline sums their bytes; the reference runs its
collectives inside the compiled step and has no such span.
"""
from __future__ import annotations

import threading
import time

import torch

from .. import telemetry as _telemetry
from ..context import NodeStatus
from ..graph.node import Op
from ..ndarray import IndexedSlices

__all__ = ["AllReduceCommunicateOp", "GroupAllReduceCommunicateOp",
           "GroupComm", "DispatchOp", "DispatchGradientOp", "ParameterServerCommunicateOp",
           "ParameterServerSparsePullOp", "DataH2DOp", "DataD2HOp",
           "PipelineSendOp", "PipelineReceiveOp", "allreduceCommunicate_op",
           "groupallreduceCommunicate_op", "optimizer_allreduce_ops",
           "settle_deferred_allreduce", "parameterServerCommunicate_op",
           "parameterServerSparsePull_op", "datah2d_op", "datad2h_op",
           "pipeline_send_op", "pipeline_receive_op", "dispatch"]

# the dtypes a gradient is reduced in as it is (the reference's pmean
# reduces in the gradient's own dtype); gloo and NCCL sum every one of
# them on the CPU and on CUDA, bf16 included. Others go through f32.
_REDUCE_DTYPES = (torch.float32, torch.float64, torch.float16,
                  torch.bfloat16, torch.int32, torch.int64, torch.uint8)


class GroupComm:
    """The collectives of one process group, as the graph's comm ops use
    them: every collective is one ``torch.distributed.all_reduce`` on
    ``group`` (a ``ProcessGroup``; None for the default group).

    ``stats`` counts, by kind ("dense" gradients, "sparse" gradients,
    "fetch" for values made global; the tensor-parallel realization's
    and sequence parallelism's "gather" for their all-gathers and
    "reduce" for partial sums; "ring" for ring hops, "all_to_all"), the
    calls, the bytes each rank put in and their host seconds; "staged"
    counts the hops whose CUDA tensors went through pinned host memory,
    their bytes and the seconds of those copies.
    With ``sync_timing`` set the device is synchronized before each is
    timed, so its seconds start when its inputs are ready and not
    before: the collective's own cost (gloo copies a CUDA tensor to the
    host and back inside an all_reduce)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self.group = group
        pg = group if group is not None else dist.group.WORLD
        self.nrank = int(pg.size())
        self.rank = int(pg.rank())
        self.backend = str(pg.name()).lower()
        self.sync_timing = False
        self._stats_lock = threading.Lock()
        self.reset_stats()

    def reset_stats(self):
        with self._stats_lock:
            self.stats = {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
                          for k in ("dense", "sparse", "fetch", "gather",
                                    "reduce", "ring", "all_to_all",
                                    "staged")}

    def _pg(self):
        import torch.distributed as dist
        return self.group if self.group is not None else dist.group.WORLD

    def _start(self, tensor):
        if self.sync_timing and tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        return time.perf_counter()

    @staticmethod
    def _span(tel, name, c0, nbytes, kind):
        # the collective's span (telemetry on only; the callers' disabled
        # path reads tel.enabled and allocates nothing)
        tel.complete(name, c0, tel.clock(), {"bytes": int(nbytes),
                                              "kind": kind})

    def _count(self, kind, t0, nbytes, seconds=None):
        # a rank's comms are its own, but a caller may read or reset the
        # counters from another thread (thread ranks of one process)
        with self._stats_lock:
            st = self.stats[kind]
            st["calls"] += 1
            st["bytes"] += nbytes
            st["seconds"] += time.perf_counter() - t0 if seconds is None \
                else seconds

    def ring_shift(self, tensors, kind="ring", step=1):
        """One hop of a ring (the reference's ``lax.ppermute`` over
        ``[(i, (i + step) % n)]``): each of ``tensors`` goes to rank
        ``rank + step`` of the group, and rank ``rank - step``'s takes its
        place (``step=-1``: DistGCN's ring, ``[(i, (i - 1) % n)]``).
        None entries stay None. Counted as one call of the bytes this
        rank sends; on a gloo group CUDA tensors cross through pinned
        host copies, counted under "staged" with the copies' seconds."""
        live = [i for i, t in enumerate(tensors) if t is not None]
        out = list(tensors)
        if self.nrank == 1 or not live:
            return out
        sends = [tensors[i].contiguous() for i in live]
        t0 = self._start(sends[0])
        tel = _telemetry.get_telemetry()
        c0 = tel.clock() if tel.enabled else 0
        staged = sends[0].is_cuda and self.backend == "gloo"
        if staged:
            sends = [torch.empty(t.shape, dtype=t.dtype,
                                 pin_memory=True).copy_(t) for t in sends]
            copy_s = time.perf_counter() - t0
        recvs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 if staged else torch.empty_like(t) for t in sends]
        pg = self._pg()
        nxt = (self.rank + step) % self.nrank
        prv = (self.rank - step) % self.nrank
        works = []
        for tag, (snd, rcv) in enumerate(zip(sends, recvs)):
            works.append(pg.send([snd], nxt, tag))
            works.append(pg.recv([rcv], prv, tag))
        for w in works:
            w.wait()
        t1 = time.perf_counter()
        for i, r in zip(live, recvs):
            out[i] = r.to(tensors[i].device)
        nbytes = sum(t.numel() * t.element_size() for t in sends)
        self._count(kind, t0, nbytes)
        if tel.enabled:
            self._span(tel, "collective_ring", c0, nbytes, kind)
        if staged:
            self._count("staged", t1, nbytes,
                        copy_s + time.perf_counter() - t1)
        return out

    def all_to_all(self, value, kind="all_to_all"):
        """``value``'s dim 0 (of size nrank) split, part j sent to rank
        j; returns the parts received, by source rank, on dim 0 (the
        reference's tiled ``lax.all_to_all``)."""
        import torch.distributed as dist
        if self.nrank == 1:
            return value
        x = value.contiguous()
        t0 = self._start(x)
        tel = _telemetry.get_telemetry()
        c0 = tel.clock() if tel.enabled else 0
        out = torch.empty_like(x)
        self._pg().alltoall_base(out, x, [], [],
                                 dist.AllToAllOptions()).wait()
        nbytes = x.numel() * x.element_size()
        self._count(kind, t0, nbytes)
        if tel.enabled:
            self._span(tel, "collective_all_to_all", c0, nbytes, kind)
        return out

    def all_gather(self, value, dim, kind="gather"):
        """Every rank's ``value`` (one shape on every rank) concatenated
        on ``dim`` in rank order, by the group's all-gather. Counted as
        one call of the bytes this rank puts in."""
        import torch.distributed as dist
        if self.nrank == 1:
            return value
        x = value.movedim(dim, 0).contiguous()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        t0 = self._start(x)
        tel = _telemetry.get_telemetry()
        c0 = tel.clock() if tel.enabled else 0
        out = torch.empty((self.nrank,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather(list(out.unbind(0)), x, group=self.group)
        nbytes = x.numel() * x.element_size()
        self._count(kind, t0, nbytes)
        if tel.enabled:
            self._span(tel, "collective_all_gather", c0, nbytes, kind)
        out = out.reshape((-1,) + tuple(x.shape[1:])).to(value.dtype)
        return out.movedim(0, dim)

    def all_reduce(self, tensor, op=None, kind="dense"):
        """Reduce ``tensor`` in place over the group (SUM by default)."""
        import torch.distributed as dist
        t0 = self._start(tensor)
        tel = _telemetry.get_telemetry()
        c0 = tel.clock() if tel.enabled else 0
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM if op is None else op,
                        group=self.group)
        nbytes = tensor.numel() * tensor.element_size()
        self._count(kind, t0, nbytes)
        if tel.enabled:
            self._span(tel, "allreduce", c0, nbytes, kind)
        return tensor

    def mean(self, value, kind="dense"):
        """The average of ``value`` over the ranks, in its dtype (a copy:
        the input is left as it was)."""
        dtype = value.dtype
        wire = dtype if dtype in _REDUCE_DTYPES else torch.float32
        buf = value.detach().to(wire, memory_format=torch.contiguous_format,
                                copy=True)
        self.all_reduce(buf, kind=kind)
        if not buf.is_floating_point():
            buf = buf.to(torch.float32)
        buf.div_(self.nrank)
        return buf if buf.dtype == dtype else buf.to(dtype)

    def gather_rows(self, value, kind="fetch", equal=False):
        """Every rank's ``value`` concatenated on dim 0, in rank order.
        Rows may differ between ranks: their counts are all-reduced first
        (each rank fills its slot of a zeroed count vector), each rank
        pads to the largest, and the padding is cut off again. ``equal``
        (every rank holds the same row count) skips the counts."""
        n = value.shape[0]
        if equal:
            counts = [n] * self.nrank
        else:
            cnt = torch.zeros(self.nrank, dtype=torch.int64,
                              device=value.device)
            cnt[self.rank] = n
            counts = self.all_reduce(cnt, kind=kind).tolist()
        width = max(counts)
        dtype = value.dtype
        wire = dtype if dtype in _REDUCE_DTYPES and dtype != torch.bool \
            else (torch.uint8 if dtype == torch.bool else torch.float32)
        buf = torch.zeros((self.nrank, width) + tuple(value.shape[1:]),
                          dtype=wire, device=value.device)
        buf[self.rank, :n] = value.to(wire)
        self.all_reduce(buf, kind=kind)
        out = torch.cat([buf[r, :c] for r, c in enumerate(counts)]) \
            if width != n or any(c != n for c in counts) \
            else buf.reshape((-1,) + tuple(value.shape[1:]))
        return out.to(dtype) if wire != dtype else out

    def gather_slices(self, grad):
        """An ``IndexedSlices`` gradient of every rank: indices and
        values all-gathered, values / nrank (reference
        AllReduceCommunicate.py:25-53)."""
        idx = self.gather_rows(grad.get_flat_indices(), kind="sparse")
        vals = self.gather_rows(grad.get_dense_rows(), kind="sparse")
        return IndexedSlices(idx, vals / self.nrank, grad.dense_shape)


class AllReduceCommunicateOp(Op):
    """Gradient allreduce over the session's data-parallel ranks
    (reference AllReduceCommunicate.py:11-60): the identity at one
    rank."""

    def __init__(self, node_A, comm=None, ctx=None):
        super().__init__(AllReduceCommunicateOp, [node_A], ctx)
        self.comm = comm

    def group_comm(self, ectx):
        """The :class:`GroupComm` this op reduces over, or None (one
        rank: nothing to reduce)."""
        config = ectx.config
        if config is None or getattr(config, "nrank", 1) <= 1:
            return None
        return self.comm or getattr(config, "dp_comm", None)

    def _deferred(self, ectx, val):
        """True when the consuming OptimizerOp buckets this op's
        reduction (``overlap_options["bucket_bytes"]``): the per-gradient
        collective is skipped here and :func:`settle_deferred_allreduce`
        reduces it in a bucket. Sparse gradients never defer (their
        all-gather has no bucket)."""
        defer = getattr(ectx, "allreduce_defer", None)
        return (defer is not None and self in defer
                and not isinstance(val, IndexedSlices))

    def compute(self, input_vals, ectx):
        val = input_vals[0]
        comm = self.group_comm(ectx)
        if comm is None or comm.nrank == 1 or self._deferred(ectx, val):
            return val
        if isinstance(val, IndexedSlices):
            return comm.gather_slices(val)
        return comm.mean(val)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]

    def forward_hook(self, config):
        super().forward_hook(config)
        if self.comm is None:
            self.comm = getattr(config, "dp_comm", None)


class GroupAllReduceCommunicateOp(AllReduceCommunicateOp):
    """Allreduce within a subgroup (model-parallel replica groups,
    reference AllReduceCommunicate.py:92-123): ``group`` names an axis of
    the session's mesh, and the op reduces over that axis's process
    group. Without that axis (no mesh, or a mesh without it) it is the
    identity, as the reference's op is where the axis is unbound."""

    def __init__(self, node_A, group=None, ctx=None):
        super().__init__(node_A, ctx=ctx)
        self.op_type = "GroupAllReduceCommunicateOp"
        self.group = group

    def group_comm(self, ectx):
        config = ectx.config
        mesh = getattr(config, "mesh", None)
        if self.group is None:
            return super().group_comm(ectx)
        if mesh is None or self.group not in mesh.axis_names:
            return None
        return mesh.comm(self.group)

    def compute(self, input_vals, ectx):
        val = input_vals[0]
        comm = self.group_comm(ectx)
        if comm is None or comm.nrank == 1 or self._deferred(ectx, val):
            return val
        return comm.mean(val)


def optimizer_allreduce_ops(topo, optimizer_ops, eval_nodes):
    """The gradient allreduce ops eligible for bucketing: optimizer
    inputs that are allreduce ops, not fetched by the session
    themselves, and consumed by nothing but optimizers (a second
    consumer needs the per-gradient value in place)."""
    optimizer_set = set(optimizer_ops)
    consumers = {}
    for op in topo:
        for inp in op.inputs:
            consumers.setdefault(inp, []).append(op)
    eval_set = set(eval_nodes)
    return frozenset(
        inp for op in optimizer_set for inp in op.inputs
        if isinstance(inp, AllReduceCommunicateOp)
        and inp not in eval_set
        and all(c in optimizer_set for c in consumers.get(inp, ())))


def settle_deferred_allreduce(inputs, input_vals, ectx):
    """Bucketed gradient allreduce (PyTorch DDP's, Li et al., VLDB
    2020): the OptimizerOp's deferred dense gradients are reduced in
    size-targeted buckets, one flattened ``all_reduce`` a bucket in
    place of one a gradient. Buckets form in reverse input order (the
    backward makes the last layers' gradients first), are pure in dtype
    (a concat must not promote) and in process group (one collective
    rides one group), and close once they hold ``bucket_bytes``. The
    sum and the division are elementwise, so the result is the
    per-gradient path's, bit for bit.

    Returns a new ``input_vals`` with the deferred positions replaced by
    their reduced values; everything else passes through."""
    defer = getattr(ectx, "allreduce_defer", None)
    overlap = getattr(ectx.config, "overlap", None)
    bucket_bytes = overlap.bucket_bytes if overlap is not None else None
    if not defer or not bucket_bytes:
        return input_vals
    items = []          # (position, dense gradient, comm)
    for pos, (op, val) in enumerate(zip(inputs, input_vals)):
        if op not in defer or val is None or \
                isinstance(val, IndexedSlices):
            continue
        comm = op.group_comm(ectx)
        if comm is None or comm.nrank == 1:
            continue
        items.append((pos, val, comm))
    out = list(input_vals)
    buckets, cur, cur_bytes, cur_key = [], [], 0, None
    for pos, val, comm in reversed(items):
        key = (id(comm), val.dtype)
        if cur and (key != cur_key or cur_bytes >= bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur_key = key
        cur.append((pos, val, comm))
        cur_bytes += val.numel() * val.element_size()
    if cur:
        buckets.append(cur)
    for members in buckets:
        comm = members[0][2]
        if len(members) == 1:
            pos, val, _ = members[0]
            out[pos] = comm.mean(val)
            continue
        red = comm.mean(torch.cat([v.reshape(-1) for _, v, _ in members]))
        off = 0
        for pos, val, _ in members:
            n = val.numel()
            out[pos] = red[off:off + n].view(val.shape)
            off += n
    return out


class ParameterServerCommunicateOp(Op):
    """Push a gradient to the PS (and pull the updated parameter):
    a host op the PS runtime runs between steps (reference
    ParameterServerCommunicate.py:38-70)."""

    def __init__(self, node_A, parameter, optimizer_info=None, ctx=None):
        super().__init__(ParameterServerCommunicateOp, [node_A], ctx)
        self.parameter = parameter
        self.optimizer_info = optimizer_info

    def compute(self, input_vals, ectx):
        raise AssertionError("PS communicate is a host op; the executor "
                             "must not compute it")

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class ParameterServerSparsePullOp(Op):
    """Rows of ``parameter`` for the given ids, pulled from the PS
    (reference ParameterServerCommunicate.py:236-288): a host op the
    PS runtime feeds before the step."""

    def __init__(self, parameter, index, ctx=None):
        super().__init__(ParameterServerSparsePullOp, [index], ctx)
        self.parameter = parameter

    def compute(self, input_vals, ectx):
        raise AssertionError("PS sparse pull is a host op")

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return tuple(input_shapes[0]) + (self.parameter.shape[-1],)


class DataH2DOp(Op):
    """Host -> device transfer (reference DataTransfer.py): the identity,
    as the eager walk places values on their consumer's device."""

    def __init__(self, node_A, ctx=None):
        super().__init__(DataH2DOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return input_vals[0]

    def gradient(self, output_grad):
        return [datad2h_op(output_grad, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class DataD2HOp(Op):
    """Device -> host transfer: the identity, as :class:`DataH2DOp`."""

    def __init__(self, node_A, ctx=None):
        super().__init__(DataD2HOp, [node_A], ctx)

    def compute(self, input_vals, ectx):
        return input_vals[0]

    def gradient(self, output_grad):
        return [datah2d_op(output_grad, ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class DispatchOp(Op):
    """Marks the desired partition of its input (reference Dispatch.py).

    ``parts`` is a tuple of split counts per dim (-1 = duplicate axis).
    Planning turns it into a NodeStatus (:mod:`~hetu_tpu_torch.parallel.
    planner`); a tensor-parallel session moves the value to that
    layout here (:mod:`~hetu_tpu_torch.parallel.tensor_parallel`: a
    local slice, or an all-gather over the split axes). Outside one it
    is the identity, as the JAX package's sharding constraint is
    without a mesh.
    """

    def __init__(self, node_A, parts, ctx=None):
        super().__init__(DispatchOp, [node_A], ctx)
        if isinstance(parts, dict):
            ndim = max(parts) + 1 if parts else 0
            parts = tuple(parts.get(i, 1) for i in range(ndim))
        self.parts = tuple(parts)

    def target_status(self):
        state = tuple(p if p > 0 else 1 for p in self.parts)
        dup = 1
        for p in self.parts:
            if p < 0:
                dup *= -p
        st = NodeStatus(state, duplicate=dup)
        st.get_default()
        return st

    def compute(self, input_vals, ectx):
        return input_vals[0]

    def gradient(self, output_grad):
        return [DispatchGradientOp(output_grad, self.inputs[0],
                                   ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]

    def deduce_states(self, input_statuses, status, deduce_order):
        target = self.target_status()
        status.set_state(target.state)
        status.set_attr(target.duplicate, target.order)


class DispatchGradientOp(Op):
    """Gradient of a dispatch mirrors the forward *input's* partition
    (reference Dispatch.py:50-65): a tensor-parallel session moves it
    to that layout."""

    def __init__(self, node_A, forward_input, ctx=None):
        super().__init__(DispatchGradientOp, [node_A], ctx)
        self.forward_input = forward_input

    def compute(self, input_vals, ectx):
        return input_vals[0]

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class PipelineSendOp(Op):
    """Stage-boundary marker: the value leaves this pipeline stage
    (reference PipelineSend.py); inside a stage it is the identity.

    ``registry`` keeps the sends in construction order: a receive has no
    input edge to follow, so the pipeline pairs send k with receive k.
    Paired sends leave the registry when spliced; only a pipeline graph
    built and never run leaves some behind, and the next splice's count
    check names them."""

    registry = []

    def __init__(self, node_A, destination=None, comm=None, ctx=None):
        super().__init__(PipelineSendOp, [node_A], ctx)
        self.destination = destination
        PipelineSendOp.registry.append(self)

    @classmethod
    def pending(cls):
        """Unconsumed sends in construction order."""
        return list(cls.registry)

    @classmethod
    def consume(cls, sends):
        for s in sends:
            cls.registry.remove(s)

    def compute(self, input_vals, ectx):
        return input_vals[0]

    def gradient(self, output_grad):
        return [pipeline_receive_op(source=self.destination,
                                    ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class PipelineReceiveOp(Op):
    """Stage-boundary marker: a value enters this stage from another
    (reference PipelineReceive.py); the splice binds it to its send."""

    def __init__(self, source=None, comm=None, ctx=None):
        super().__init__(PipelineReceiveOp, [], ctx)
        self.source = source
        self.bound_send = None

    def compute(self, input_vals, ectx):
        raise AssertionError("a pipeline receive is bound by the pipeline "
                             "executor, never computed")

    def gradient(self, output_grad):
        return [pipeline_send_op(output_grad, destination=self.source,
                                 ctx=self.raw_ctx)]

    def infer_shape(self, input_shapes):
        assert self.bound_send is not None, \
            "pipeline receive not bound to a send"
        return self.bound_send.inferred_shape


def allreduceCommunicate_op(node, comm=None, ctx=None):
    return AllReduceCommunicateOp(node, comm=comm, ctx=ctx)


def groupallreduceCommunicate_op(node, group=None, ctx=None):
    return GroupAllReduceCommunicateOp(node, group=group, ctx=ctx)


def parameterServerCommunicate_op(node, parameter, optimizer_info=None,
                                  ctx=None):
    return ParameterServerCommunicateOp(node, parameter, optimizer_info,
                                        ctx=ctx)


def parameterServerSparsePull_op(parameter, index, ctx=None):
    return ParameterServerSparsePullOp(parameter, index, ctx=ctx)


def datah2d_op(node, ctx=None):
    return DataH2DOp(node, ctx=ctx)


def datad2h_op(node, ctx=None):
    return DataD2HOp(node, ctx=ctx)


def pipeline_send_op(node, destination=None, comm=None, stream=None,
                     ctx=None):
    return PipelineSendOp(node, destination=destination, ctx=ctx)


def pipeline_receive_op(source=None, comm=None, stream=None, ctx=None):
    return PipelineReceiveOp(source=source, ctx=ctx)


def dispatch(node, parts, ctx=None):
    return DispatchOp(node, parts, ctx=ctx)
