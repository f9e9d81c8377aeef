"""Communication ops of the PS and Hybrid modes.

Counterpart of ``hetu_tpu/ops/comm.py``, its PS part and the
single-worker AllReduce (reference parity: gpu_ops/
ParameterServerCommunicate.py, gpu_ops/AllReduceCommunicate.py).

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
           "ParameterServerSparsePullOp", "allreduceCommunicate_op",
           "parameterServerCommunicate_op", "parameterServerSparsePull_op"]


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


def allreduceCommunicate_op(node, comm=None, ctx=None):
    return AllReduceCommunicateOp(node, comm=comm, ctx=ctx)


def parameterServerCommunicate_op(node, parameter, optimizer_info=None,
                                  ctx=None):
    return ParameterServerCommunicateOp(node, parameter, optimizer_info,
                                        ctx=ctx)


def parameterServerSparsePull_op(parameter, index, ctx=None):
    return ParameterServerSparsePullOp(parameter, index, ctx=ctx)
