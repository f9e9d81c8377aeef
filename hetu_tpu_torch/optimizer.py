"""Optimizers.

Counterpart of ``hetu_tpu/optimizer.py`` (reference parity:
python/hetu/optimizer.py): SGD, Momentum (with Nesterov), AdaGrad and
Adam (with amsgrad), AdamW, the
``l2reg`` / ``loss_scale`` handling every update path shares, and
``OptimizerOp``, which applies the optimizer to its gradient inputs
inside a step. Sparse (IndexedSlices) gradients update only the rows
they name: SGD scatter-adds them, Adam and AdaGrad are lazy — their
slots and the parameter move only on the deduplicated rows; Momentum
makes them dense, as the reference does.

``update`` is functional, as in the reference: it returns new tensors
and the executor swaps them in after the step — but for SGD's sparse
update, which scatter-adds into the table in place and returns the same
tensor: copying a table the size of Criteo's for a few hundred rows a
step would move the whole table through memory twice. The reference's
compiled step donates its parameters, so its scatter-add is in place
too.

``OptimizerOp.backward_hook`` is the PS, Hybrid and AllReduce modes'
graph pass (reference optimizer.py:381-432): per gradient, a PS push
op, the device cache's pass-through, the unified dense HET path for
SGD, or an allreduce; under ``overlap_options["bucket_bytes"]`` the op
settles its dense allreduces in buckets before the update
(:func:`~hetu_tpu_torch.ops.comm.settle_deferred_allreduce`).

On a step the health monitor samples (``ectx.health_sentinels`` set,
:mod:`~hetu_tpu_torch.telemetry.health`), ``OptimizerOp`` records each
parameter's sentinels (:func:`sentinel_rows`): the unscaled gradient's
norm and nonfinite count, and the update/weight ratio of the f32
masters. An in-place update (sparse SGD) has lost the old weight when
the new one exists, so its weight norm is taken before the update and
its update norm from the deduplicated rows times lr.
"""
from __future__ import annotations

import math

import torch

from .graph.node import Op
from .lr_scheduler import FixedScheduler
from .ndarray import IndexedSlices
from .ops.variable import PlaceholderOp

__all__ = ["Optimizer", "OptimizerOp", "SGDOptimizer", "MomentumOptimizer",
           "AdaGradOptimizer", "AdamOptimizer", "AdamWOptimizer",
           "sentinel_stats", "sentinel_rows"]


def _norm32(t):
    return torch.linalg.vector_norm(t.float())


def sentinel_rows(params, grads, new_params, in_place=None):
    """The health sentinels of several parameters as one float64 tensor
    ``[n, 3]``: per row the gradient's global norm (in f32; an
    ``IndexedSlices`` gradient by its values), its nonfinite element
    count, and the update/weight ratio ``||new - param|| / (||param|| +
    1e-12)`` in f32 — 0 where ``param`` or ``new_param`` is None (a
    PS-pushed gradient has no worker-side update). ``in_place`` maps a
    row index to ``(||param||, ||update||)`` taken around an update that
    overwrote ``param``. Reference: ``hetu_tpu/optimizer.py``
    ``sentinel_stats``, three reductions a parameter in its jitted step;
    here the norms of all the rows are ``torch._foreach_norm`` calls."""
    in_place = in_place or {}
    vals = [(g.values if isinstance(g, IndexedSlices) else g).float()
            for g in grads]
    device = vals[0].device
    grad_norm = torch.stack(torch._foreach_norm(vals)).double()
    nonfinite = torch.stack([(~torch.isfinite(v)).sum() for v in vals])
    ratio = torch.zeros(len(vals), dtype=torch.float32, device=device)
    dense = [i for i, (p, q) in enumerate(zip(params, new_params))
             if p is not None and q is not None and i not in in_place]
    if dense:
        olds = [params[i].float() for i in dense]
        diffs = torch._foreach_sub([new_params[i].float() for i in dense],
                                   olds)
        upd = torch._foreach_norm(diffs)
        pn = torch._foreach_norm(olds)
        ratio[dense] = torch.stack(upd) / (torch.stack(pn) + 1e-12)
    for i, (pn, upd) in in_place.items():
        ratio[i] = upd / (pn + 1e-12)
    return torch.stack([grad_norm, nonfinite.double(), ratio.double()],
                       dim=1)


def sentinel_stats(param, grad, new_param):
    """One parameter's health sentinels (reference
    ``hetu_tpu/optimizer.py:29-49``): ``{"grad_norm", "nonfinite",
    "update_ratio"}`` as 0-dim tensors (f32, int64, f32), from
    :func:`sentinel_rows`."""
    row = sentinel_rows([param], [grad], [new_param])[0]
    return {"grad_norm": row[0].float(), "nonfinite": row[1].long(),
            "update_ratio": row[2].float()}


class Optimizer:
    name = "Optimizer"

    def __init__(self, learning_rate, l2reg=0, loss_scale=None):
        if isinstance(learning_rate, FixedScheduler):
            self.lr_sched = learning_rate
        else:
            self.lr_sched = FixedScheduler(learning_rate)
        if l2reg < 0:
            raise ValueError(f"l2reg must be >= 0, got {l2reg}")
        if loss_scale is not None and loss_scale <= 0:
            raise ValueError(f"loss_scale must be > 0, got {loss_scale}")
        self.l2reg = l2reg
        # static loss scaling: minimize() differentiates loss_scale *
        # loss, _apply_l2 divides the gradients back in the master dtype
        self.loss_scale = loss_scale
        self.params = None

    @property
    def learning_rate(self):
        return self.lr_sched.get()

    @staticmethod
    def get_var_list(loss):
        visited = set()
        trainable = []
        stack = list(reversed(loss if isinstance(loss, list) else [loss]))
        while stack:
            node = stack.pop()
            if id(node) in visited:
                continue
            visited.add(id(node))
            if isinstance(node, PlaceholderOp) and node.trainable:
                trainable.append(node)
                continue
            stack.extend(reversed(node.inputs))
        return trainable

    def minimize(self, loss, var_list=None):
        from .graph.autodiff import gradients
        from .ops.basic import mul_byconst_op
        from .ops.shape import oneslike_op
        self.params = var_list or self.get_var_list(loss)
        target = loss
        if self.loss_scale and self.loss_scale != 1:
            target = mul_byconst_op(loss, float(self.loss_scale))
        seed = oneslike_op(target, ctx=target.raw_ctx)
        return OptimizerOp(gradients(target, self.params, insert_grad=seed),
                           self, seed)

    # ------------------------------------------------------- functional API
    def init_state(self, param_vals):
        """Slot tensors per parameter node id."""
        return {}

    def _apply_l2(self, param, grad):
        # every update unscales here, exactly once, before l2 applies
        grad = self._unscale(grad)
        if self.l2reg > 0 and not isinstance(grad, IndexedSlices):
            return grad + self.l2reg * param
        return grad

    def _unscale(self, grad):
        s = self.loss_scale
        if not s or s == 1:
            return grad
        inv = 1.0 / float(s)
        if isinstance(grad, IndexedSlices):
            return IndexedSlices(grad.indices, grad.values * inv,
                                 grad.dense_shape)
        return grad * inv

    def update_one(self, param, grad, slots, lr, step):
        """(new_param, new_slots) for one parameter."""
        raise NotImplementedError

    @staticmethod
    def updates_in_place(grad):
        """Whether ``update_one`` writes into the parameter it is given
        (its old value is gone once the new one exists)."""
        return False

    def update(self, param_vals, grad_vals, state, lr, step):
        """New parameters and slots over dicts keyed by parameter node."""
        new_params, new_state = {}, {}
        for node, param in param_vals.items():
            slots = state.get(node.id, {})
            p, s = self.update_one(
                param, self._apply_l2(param, grad_vals[node]), slots, lr,
                step)
            new_params[node] = p
            if s or node.id in state:
                new_state[node.id] = s
        return new_params, new_state


class SGDOptimizer(Optimizer):
    name = "SGD"

    @staticmethod
    def updates_in_place(grad):
        """Whether ``update_one`` writes into the parameter (the sparse
        scatter-add) instead of returning a new tensor."""
        return isinstance(grad, IndexedSlices)

    def update_one(self, param, grad, slots, lr, step):
        if isinstance(grad, IndexedSlices):
            return param.index_add_(0, grad.get_flat_indices(),
                                    grad.get_dense_rows(), alpha=-lr), slots
        return param - lr * grad, slots


class MomentumOptimizer(Optimizer):
    """Hetu's momentum, not torch's: ``v = m * v - lr * g``, then
    ``p + v``, or ``p + m * v - lr * g`` with Nesterov (reference
    optimizer.py:170-191)."""

    name = "Momentum"

    def __init__(self, learning_rate=0.01, momentum=0.9, nesterov=False,
                 l2reg=0, loss_scale=None):
        super().__init__(learning_rate, l2reg, loss_scale)
        self.momentum = momentum
        self.nesterov = nesterov

    def init_state(self, param_vals):
        return {node.id: {"velocity": torch.zeros_like(v)}
                for node, v in param_vals.items()}

    def update_one(self, param, grad, slots, lr, step):
        if isinstance(grad, IndexedSlices):
            grad = grad.to_dense()
        v = self.momentum * slots["velocity"] - lr * grad
        if self.nesterov:
            return param + self.momentum * v - lr * grad, {"velocity": v}
        return param + v, {"velocity": v}


class AdaGradOptimizer(Optimizer):
    """``accum += g * g``; ``p -= lr * g / (sqrt(accum) + eps)``, the
    accumulator starting at ``initial_accumulator_value``."""

    name = "AdaGrad"

    def __init__(self, learning_rate=0.01, initial_accumulator_value=0.0,
                 eps=1e-7, l2reg=0, loss_scale=None):
        super().__init__(learning_rate, l2reg, loss_scale)
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init_state(self, param_vals):
        return {node.id: {"accum": torch.full_like(
            v, self.initial_accumulator_value)}
            for node, v in param_vals.items()}

    def update_one(self, param, grad, slots, lr, step):
        if isinstance(grad, IndexedSlices):
            # lazy: only the deduplicated rows; the reference's padded
            # dedup can keep the table's last row's old accumulator when
            # ids repeat (its lazy Adam's fault, ROADMAP §3) — the port
            # updates that row as any other
            idx, rows = grad.dedup()
            picked = slots["accum"][idx] + rows * rows
            upd = lr * rows / (torch.sqrt(picked) + self.eps)
            return (param.index_add(0, idx, upd, alpha=-1),
                    {"accum": slots["accum"].index_copy(0, idx, picked)})
        accum = slots["accum"] + grad * grad
        return (param - lr * grad / (torch.sqrt(accum) + self.eps),
                {"accum": accum})


class AdamOptimizer(Optimizer):
    name = "Adam"

    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, l2reg=0, amsgrad=False, loss_scale=None):
        super().__init__(learning_rate, l2reg, loss_scale)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.amsgrad = amsgrad

    def init_state(self, param_vals):
        state = {}
        for node, v in param_vals.items():
            slots = {"m": torch.zeros_like(v), "v": torch.zeros_like(v)}
            if self.amsgrad:
                slots["vmax"] = torch.zeros_like(v)
            state[node.id] = slots
        return state

    def _step_scale(self, lr, step):
        t = step + 1
        return lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)

    def update_one(self, param, grad, slots, lr, step):
        b1, b2 = self.beta1, self.beta2
        scale = self._step_scale(lr, step)
        if isinstance(grad, IndexedSlices):
            idx, rows = grad.dedup()
            m_rows = b1 * slots["m"][idx] + (1 - b1) * rows
            v_rows = b2 * slots["v"][idx] + (1 - b2) * rows * rows
            out = {"m": slots["m"].index_copy(0, idx, m_rows),
                   "v": slots["v"].index_copy(0, idx, v_rows)}
            vhat_rows = v_rows
            if self.amsgrad:
                vhat_rows = torch.maximum(slots["vmax"][idx], v_rows)
                out["vmax"] = slots["vmax"].index_copy(0, idx, vhat_rows)
            upd = scale * m_rows / (torch.sqrt(vhat_rows) + self.epsilon)
            return param.index_add(0, idx, upd, alpha=-1), out
        m = b1 * slots["m"] + (1 - b1) * grad
        v = b2 * slots["v"] + (1 - b2) * grad * grad
        out = {"m": m, "v": v}
        vhat = v
        if self.amsgrad:
            vhat = torch.maximum(slots["vmax"], v)
            out["vmax"] = vhat
        return param - scale * m / (torch.sqrt(vhat) + self.epsilon), out


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay: after Adam's update a dense
    parameter also loses ``lr * weight_decay`` times its value before
    the step; a sparse (IndexedSlices) gradient's rows get no decay, as
    in the reference (optimizer.py:283-297)."""

    name = "AdamW"

    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, weight_decay=0.01, l2reg=0,
                 loss_scale=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, l2reg,
                         loss_scale=loss_scale)
        self.weight_decay = weight_decay

    def update_one(self, param, grad, slots, lr, step):
        new_param, out = super().update_one(param, grad, slots, lr, step)
        if not isinstance(grad, IndexedSlices):
            new_param = new_param - lr * self.weight_decay * param
        return new_param, out


class OptimizerOp(Op):
    """Applies the optimizer to its gradient inputs (reference
    optimizer.py:88-177): writes the new parameters and slots into the
    step's ExecContext; the executor swaps them in after the step."""

    def __init__(self, grads, optimizer, grad_seed=None):
        super().__init__(OptimizerOp, grads, None)
        self.name = "Optimizer_%s" % optimizer.name
        self.optimizer = optimizer
        # the loss's seed adjoint: every gradient op descends from it, so
        # the data-parallel session tells the forward graph by it
        self.grad_seed = grad_seed

    def compute(self, input_vals, ectx):
        opt = self.optimizer
        if getattr(ectx, "allreduce_defer", None):
            # bucketed data-parallel gradients: the allreduce ops feeding
            # only optimizers skipped their collective; reduce them here
            # in buckets (ops/comm.py)
            from .ops.comm import settle_deferred_allreduce
            input_vals = settle_deferred_allreduce(self.inputs, input_vals,
                                                   ectx)
        # mixed precision: update the f32 masters from upcast gradients;
        # ectx.params holds the compute-dtype copies
        masters = ectx.master_params or ectx.params
        grad_vals, param_vals = {}, {}
        for node, gval in zip(opt.params, input_vals):
            if gval is None:
                continue        # PS-managed parameter: updated server-side
            pval = masters[node]
            if isinstance(gval, IndexedSlices):
                if gval.values.dtype != pval.dtype:
                    gval = IndexedSlices(gval.indices,
                                         gval.values.to(pval.dtype),
                                         gval.dense_shape)
            elif gval.dtype != pval.dtype:
                gval = gval.to(pval.dtype)
            grad_vals[node] = gval
            param_vals[node] = pval
            if getattr(node, "device_cached", False):
                # HET push accumulator: the raw gradients add up in the
                # device state, in place; the PS runtime drains it to the
                # server every cache_bound steps
                acc = ectx.state[node]["acc"]
                if isinstance(gval, IndexedSlices):
                    acc.index_add_(0, gval.get_flat_indices(),
                                   gval.get_dense_rows().to(acc.dtype))
                else:
                    acc.add_(gval.to(acc.dtype))
                ectx.new_state[node] = {"acc": acc}
        lr = ectx.lr if ectx.lr is not None else opt.learning_rate
        sentinels = getattr(ectx, "health_sentinels", None)
        in_place = {}
        if sentinels is not None:
            # a sampled step of the health monitor: an in-place update
            # loses the old weight, so its norms are taken now — the
            # update of a scatter-add is lr times the deduplicated rows
            for i, (node, g) in enumerate(grad_vals.items()):
                if opt.updates_in_place(g):
                    _, rows = opt._unscale(g).dedup()
                    in_place[i] = (_norm32(param_vals[node]),
                                   float(lr) * _norm32(rows))
        new_params, new_state = opt.update(
            param_vals, grad_vals, ectx.opt_state or {}, lr, ectx.step)
        if sentinels is not None and param_vals:
            # the UNSCALED gradient: with loss_scale set the raw
            # gradients are scale times reality
            nodes = list(param_vals)
            sentinels.append(([n.name for n in nodes], sentinel_rows(
                [param_vals[n] for n in nodes],
                [opt._unscale(grad_vals[n]) for n in nodes],
                [new_params.get(n, param_vals[n]) for n in nodes],
                in_place)))
        ectx.new_params.update(new_params)
        ectx.new_opt_state = {**(ectx.opt_state or {}), **new_state}
        return torch.zeros(1, dtype=torch.float32, device=ectx.device)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return (1,)

    def backward_hook(self, config):
        """Splice a communication op onto each gradient by the node's
        strategy (reference optimizer.py:381-432)."""
        from .ops.comm import (allreduceCommunicate_op,
                               parameterServerCommunicate_op)
        new_inputs = []
        for grad, param in zip(self.inputs, self.optimizer.params):
            strategy = config.node_strategy.get(param) or config.comm_mode
            if strategy in ("PS", "Hybrid") and \
                    (self.optimizer.loss_scale or 1) != 1:
                # a PS-pushed gradient bypasses update()'s unscale and
                # would apply loss_scale times too large server-side
                raise ValueError(
                    "loss_scale is worker-local (unscaled inside the "
                    "optimizer update); it cannot be combined with "
                    "PS-pushed gradients")
            if getattr(param, "device_cached", False):
                # device cache: the worker optimizer updates the cache
                # rows in the step; the accumulated gradients drain to
                # the server from the PS runtime, not through a comm op.
                # Over several data-parallel ranks the rows' gradient is
                # all-gathered first, so that every rank's cache takes
                # the global batch's update
                comm = grad
                if config.nrank > 1 and strategy in ("AllReduce", "Hybrid"):
                    comm = allreduceCommunicate_op(grad, ctx=grad.raw_ctx)
            elif (strategy == "PS" and not param.is_embed
                    and config.device_cache_tables
                    and config.prefetch and not config.bsp
                    and isinstance(self.optimizer, SGDOptimizer)):
                # unified HET path for a dense PS parameter under the
                # device cache's ASP mode: updated locally every step,
                # raw gradients summed in device state and drained to
                # the server on the cache's cadence. SGD only: the
                # summed gradients applied server-side commute with the
                # worker's steps, so the server value (what save()
                # writes) tracks the worker's; a stateful optimizer
                # would diverge and takes the per-step comm op instead
                param.device_cached = True
                param.stateful = True
                param.state_shapes = \
                    lambda shapes, s=tuple(param.shape): {"acc": s}
                config.ps_dense_cached.append((param, self.optimizer))
                comm = grad
            elif strategy == "PS" or (strategy == "Hybrid"
                                      and param.is_embed):
                comm = parameterServerCommunicate_op(
                    grad, param, self.optimizer, ctx=grad.raw_ctx)
                config.ps_nodes.append(comm)
            elif strategy in ("AllReduce", "Hybrid"):
                comm = allreduceCommunicate_op(grad, ctx=grad.raw_ctx)
            else:
                comm = grad
            new_inputs.append(comm)
        self.inputs = new_inputs
