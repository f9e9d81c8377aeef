"""Graph node base class and the per-step execution context.

Counterpart of ``hetu_tpu/graph/node.py``. An :class:`Op` is a DAG node
with inputs, a device context, operator-overloading sugar and the
``compute(input_vals, ectx)`` / ``gradient(output_grad)`` /
``infer_shape(input_shapes)`` protocol users write against. ``compute``
takes and returns torch tensors (or an
:class:`~hetu_tpu_torch.ndarray.IndexedSlices`, or a tuple for packed
gradients); the executor calls it eagerly in topological order.
"""
from __future__ import annotations

import torch

from ..context import DeviceGroup, get_current_context

__all__ = ["Op", "ExecContext"]

G_NODE_ID = 0


class ExecContext:
    """Everything one step threads through ``Op.compute`` that is not a
    graph edge:

    * ``training`` — train vs inference behaviour (the flash routing);
    * ``generator_for(op)`` — the per-op ``torch.Generator`` of this
      step, in place of the reference's ``rng_for`` (its numbers differ
      from ``jax.random``'s: tests feed both packages the same numpy
      draws instead);
    * ``params`` / ``master_params`` — parameter values in the compute
      dtype and their f32 masters; ``new_params`` — updates written by
      the optimizer;
    * ``opt_state`` / ``new_opt_state`` — optimizer slots;
    * ``state`` / ``new_state`` — op state keyed by op (batch norm's
      running statistics), read with ``get_state`` and written with
      ``put_state``; the executor keeps what a training step writes;
    * ``cache`` — values shared between a forward op and its gradient
      ops inside the step (the flash residuals and grads).
    """

    def __init__(self, training=True, seed=0, step=0, device=None,
                 config=None):
        self.training = training
        self.seed = seed
        self.step = step
        self.device = torch.device("cpu") if device is None else device
        self.config = config
        self.params = {}
        self.master_params = None
        self.new_params = {}
        self.opt_state = None
        self.new_opt_state = None
        self.lr = None
        self.state = {}
        self.new_state = {}
        self.cache = {}

    def get_state(self, op, default=None):
        return self.state.get(op, default)

    def put_state(self, op, value):
        self.new_state[op] = value

    def generator_for(self, op):
        seed = ((self.seed * 1_000_003 + self.step) * 1_000_003 + op.id) \
            % (1 << 63)
        return torch.Generator(device=self.device).manual_seed(seed)


class Op:
    """A node in the dataflow graph (reference Node.py:9).

    An op that keeps state between steps sets ``stateful = True`` and
    defines ``state_shapes(input_shapes)``: ``{key: shape}`` of its f32
    state, which the executor creates (0, or 1 for a key naming a
    variance) once the shapes are known."""

    stateful = False

    def __init__(self, op_type, inputs, ctx=None):
        global G_NODE_ID
        self.inputs = list(inputs)
        self.raw_ctx = (get_current_context() if ctx is None
                        else DeviceGroup(ctx))
        self.ctx = ctx
        self.const_attr = None
        self.dtype = None
        self.op_type = (op_type if isinstance(op_type, str)
                        else op_type.__name__)
        self.id = G_NODE_ID
        G_NODE_ID += 1
        self.name = self.op_type + str(self.id)
        self.desc = self.name + "(" + ", ".join(
            inp.name for inp in self.inputs) + ")"

    def compute(self, input_vals, ectx):
        """Input values -> output value."""
        raise NotImplementedError

    def gradient(self, output_grad):
        """Given the summed adjoint, build the gradient op of each input
        (None where there is none)."""
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        raise NotImplementedError

    # ------------------------------------------------------------- operators
    def __add__(self, other):
        from ..ops.basic import add_op, addbyconst_op
        if isinstance(other, Op):
            return add_op(self, other)
        return addbyconst_op(self, other)

    def __mul__(self, other):
        from ..ops.basic import mul_byconst_op, mul_op
        if isinstance(other, Op):
            return mul_op(self, other)
        return mul_byconst_op(self, other)

    def __sub__(self, other):
        from ..ops.basic import add_op, addbyconst_op, opposite_op
        if isinstance(other, Op):
            return add_op(self, opposite_op(other))
        return addbyconst_op(self, -other)

    def __rsub__(self, other):
        from ..ops.basic import addbyconst_op, opposite_op
        return addbyconst_op(opposite_op(self), other)

    def __neg__(self):
        from ..ops.basic import opposite_op
        return opposite_op(self)

    def __truediv__(self, other):
        from ..ops.basic import div_op, mul_byconst_op
        if isinstance(other, Op):
            return div_op(self, other)
        return mul_byconst_op(self, 1.0 / other)

    def __rtruediv__(self, other):
        from ..ops.basic import div_const_op
        return div_const_op(other, self)

    __radd__ = __add__
    __rmul__ = __mul__

    def __str__(self):
        return self.name

    def __repr__(self):
        return self.desc
