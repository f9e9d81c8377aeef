"""Communication ops of the PS and Hybrid modes and the pipeline.

Counterpart of ``hetu_tpu/ops/comm.py``, its PS part, the single-worker
AllReduce, the host/device transfer markers and the pipeline stage
boundaries (reference parity: gpu_ops/ParameterServerCommunicate.py,
gpu_ops/AllReduceCommunicate.py, gpu_ops/DataTransfer.py,
gpu_ops/PipelineSend.py, gpu_ops/PipelineReceive.py).

* :class:`ParameterServerCommunicateOp` pushes a gradient to the
  parameter server (and, for a dense parameter, pulls the updated
  value back). It is a *host op*: the executor never computes it; the
  PS runtime takes its input gradient after the step and pushes it,
  and the optimizer skips the parameter (the server updates it).
* :class:`ParameterServerSparsePullOp` pulls embedding rows for given
  ids — the inference path. Also a host op: the PS runtime feeds its
  value before the step.
* :class:`AllReduceCommunicateOp` averages a gradient over the data-
  parallel workers. With one worker — all the port runs until the
  launcher and the multi-card modes come (ROADMAP item 11) — it is the
  identity; the session refuses more than one worker.
"""
from __future__ import annotations

from ..graph.node import Op

__all__ = ["AllReduceCommunicateOp", "ParameterServerCommunicateOp",
           "ParameterServerSparsePullOp", "DataH2DOp", "DataD2HOp",
           "PipelineSendOp", "PipelineReceiveOp", "allreduceCommunicate_op",
           "parameterServerCommunicate_op", "parameterServerSparsePull_op",
           "datah2d_op", "datad2h_op", "pipeline_send_op",
           "pipeline_receive_op"]


class AllReduceCommunicateOp(Op):
    """Gradient allreduce over the session's workers (reference
    AllReduceCommunicate.py:11-60): the identity at one worker."""

    def __init__(self, node_A, comm=None, ctx=None):
        super().__init__(AllReduceCommunicateOp, [node_A], ctx)
        self.comm = comm

    def compute(self, input_vals, ectx):
        nrank = getattr(ectx.config, "nrank", 1)
        if nrank > 1:
            raise NotImplementedError(
                f"allreduce over {nrank} workers: the multi-card modes "
                f"wait for ROADMAP item 11")
        return input_vals[0]

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


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
