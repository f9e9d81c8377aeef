"""Graph node base class and the per-step execution context.

Counterpart of ``hetu_tpu/graph/node.py``. An :class:`Op` is a DAG node
with inputs, a device context, operator-overloading sugar and the
``compute(input_vals, ectx)`` / ``gradient(output_grad)`` /
``infer_shape(input_shapes)`` protocol users write against, the
numerics verifier's ``infer_range(input_ranges, input_shapes)``, and
``deduce_states``, the tensor-parallel planner's partition rule
(:mod:`~hetu_tpu_torch.parallel.planner`). Each op records where it
was built (``defined_at``, ``composed_at``), the line the analysis
findings name (:mod:`~hetu_tpu_torch.analysis`). ``compute``
takes and returns torch tensors (or an
:class:`~hetu_tpu_torch.ndarray.IndexedSlices`, or a tuple for packed
gradients); the executor calls it eagerly in topological order.
"""
from __future__ import annotations

import os
import sys
import threading

import torch

from ..context import DeviceGroup, get_current_context

__all__ = ["Op", "ExecContext"]

G_NODE_ID = 0
# thread ranks of one process build their comm and gradient ops at once
_ID_LOCK = threading.Lock()

# the package's root: the first stack frame outside it is the user's
# line that built an op (the trailing separator keeps a sibling such as
# .../hetu_tpu_torch_models.py out)
_PKG_DIR = os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))) + os.sep
# co_filename is the path a module was imported under (a sys.path entry
# such as "tests/../examples/.." stays in it), so paths are normalized
# before the prefix check; the set of names on any stack is small
_NORM_CACHE = {}
# the op, initializer and optimizer plumbing is never the site that
# composed an op: where the package builds a graph itself (the zoo, the
# spliced comm ops), the site is the first frame outside these, the
# models/ (or parallel/) line that composed it
_INTERNAL_PREFIXES = tuple(
    os.path.join(_PKG_DIR, p) for p in ("graph", "ops")) + tuple(
    os.path.join(_PKG_DIR, p) for p in ("initializers.py",
                                        "optimizer.py"))


def _norm(fn):
    n = _NORM_CACHE.get(fn)
    if n is None:
        n = fn if fn.startswith("<") else os.path.normpath(
            os.path.abspath(fn))
        _NORM_CACHE[fn] = n
    return n


def _construction_site():
    """((filename, lineno) or None, (filename, lineno) or None): the
    nearest caller outside the package (the user's line that built the
    op, which the analysis findings name) and the nearest frame outside
    the op and initializer plumbing (the line that composed it: a
    ``models/`` line where the package built its own graph). One frame
    walk an op; either may be None."""
    try:
        f = sys._getframe(2)
    except ValueError:
        return None, None
    composed = None
    while f is not None:
        fn = _norm(f.f_code.co_filename)
        if not fn.startswith(_PKG_DIR) and not fn.startswith("<frozen") \
                and not fn.endswith(os.sep + "runpy.py"):
            # runpy is `python -m`'s launcher, not a construction site
            return (fn, f.f_lineno), composed
        if composed is None and fn.startswith(_PKG_DIR) \
                and not fn.startswith(_INTERNAL_PREFIXES):
            composed = (fn, f.f_lineno)
        f = f.f_back
    return composed, composed


class ExecContext:
    """Everything one step threads through ``Op.compute`` that is not a
    graph edge:

    * ``training`` — train vs inference behaviour (the flash routing);
    * ``generator_for(op)`` — the per-op ``torch.Generator`` of this
      step, in place of the reference's ``rng_for`` (its numbers differ
      from ``jax.random``'s: tests feed both packages the same numpy
      draws instead), keyed by the op's id less the session graph's
      smallest (``config.op_id_base``), so graphs built before it do not
      move its draws;
    * ``params`` / ``master_params`` — parameter values in the compute
      dtype and their f32 masters; ``new_params`` — updates written by
      the optimizer;
    * ``opt_state`` / ``new_opt_state`` — optimizer slots;
    * ``state`` / ``new_state`` — op state keyed by op (batch norm's
      running statistics), read with ``get_state`` and written with
      ``put_state``; the executor keeps what a training step writes;
    * ``cache`` — values shared between a forward op and its gradient
      ops inside the step (the flash residuals and grads);
    * ``allreduce_defer`` — the allreduce ops whose reduction the
      optimizer settles in buckets (None: each reduces its own);
    * ``health_sentinels`` — on a step the health monitor samples, the
      list the optimizers append their sentinels to (None otherwise).
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
        self.allreduce_defer = None
        self.health_sentinels = None

    def get_state(self, op, default=None):
        return self.state.get(op, default)

    def put_state(self, op, value):
        self.new_state[op] = value

    def generator_for(self, op):
        key = op.id - getattr(self.config, "op_id_base", 0)
        seed = ((self.seed * 1_000_003 + self.step) * 1_000_003 + key) \
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
        with _ID_LOCK:
            self.id = G_NODE_ID
            G_NODE_ID += 1
        # defined_at: the user's line (the analysis findings name it);
        # composed_at: the package's model line that composed the op
        self.defined_at, self.composed_at = _construction_site()
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

    def infer_range(self, input_ranges, input_shapes=None):
        """Interval semantics for the HT8xx numerics verifier
        (:mod:`~hetu_tpu_torch.analysis.numerics`): given per-input
        ``(lo, hi)`` bounds (None = unknown), a ``(lo, hi)`` bounding
        every element of the output, or None for no claim. Ops with
        known value semantics override it (``ops/*.py``); the
        shape-aware cases (matmul, conv, reductions) are the pass's
        own."""
        return None

    def backward_hook(self, config):
        """The session's graph pass over this node, run in reverse
        topological order before the first step (the optimizer splices
        its PS and allreduce ops here)."""

    def forward_hook(self, config):
        """The session's second graph pass, in topological order after
        every ``backward_hook`` (reference executor.py
        ``topo_sort_with_hook``): an op without a context takes the
        session's, and an allreduce op binds its process group."""
        if self.ctx is None:
            self.ctx = config.context

    # --------------------------------------------------------- parallel (TP)
    def deduce_states(self, input_statuses, status, deduce_order):
        """Propagate NodeStatus through this op. Default: elementwise — all
        inputs and the output share one partition state (reference
        Node.py:160-190)."""
        if deduce_order:
            for st in input_statuses:
                if st is not None and st.order is not None:
                    status.set_attr(st.duplicate, st.order)
                    break
        else:
            for st in input_statuses:
                if st is not None and st.state is not None:
                    status.set_state(st.state)
                    if st.duplicate is not None and st.order is not None:
                        status.set_attr(st.duplicate, st.order)
                    break
            for st in input_statuses:
                if st is not None and st.state is None and \
                        status.state is not None:
                    st.set_state(status.state)

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
