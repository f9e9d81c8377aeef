"""Optimizers.

Counterpart of ``hetu_tpu/optimizer.py`` (reference parity:
python/hetu/optimizer.py): SGD, Momentum (with Nesterov), AdaGrad and
Adam (with amsgrad), AdamW, the
``l2reg`` / ``loss_scale`` handling every update path shares, and
``OptimizerOp``, which applies the optimizer to its gradient inputs
inside a step. Sparse (IndexedSlices) gradients update only the rows
they name: SGD scatter-adds them, Adam is lazy — ``m``, ``v`` and the
parameter move only on the deduplicated rows; Momentum makes them
dense, as the reference does.

``update`` is functional, as in the reference: it returns new tensors
and the executor swaps them in after the step — but for SGD's sparse
update, which scatter-adds into the table in place and returns the same
tensor: copying a table the size of Criteo's for a few hundred rows a
step would move the whole table through memory twice. The reference's
compiled step donates its parameters, so its scatter-add is in place
too. AdaGrad on sparse
gradients (its caller, the PS path, is not ported), the health
``sentinel_stats`` and the PS / allreduce hooks are still to port.
"""
from __future__ import annotations

import math

import torch

from .graph.node import Op
from .lr_scheduler import FixedScheduler
from .ndarray import IndexedSlices
from .ops.variable import PlaceholderOp

__all__ = ["Optimizer", "OptimizerOp", "SGDOptimizer", "MomentumOptimizer",
           "AdaGradOptimizer", "AdamOptimizer", "AdamWOptimizer"]


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
        self.params = var_list or self.get_var_list(loss)
        target = loss
        if self.loss_scale and self.loss_scale != 1:
            target = mul_byconst_op(loss, float(self.loss_scale))
        return OptimizerOp(gradients(target, self.params), self)

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
            raise NotImplementedError(
                "AdaGrad on a sparse gradient comes with the PS path")
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

    def __init__(self, grads, optimizer):
        super().__init__(OptimizerOp, grads, None)
        self.name = "Optimizer_%s" % optimizer.name
        self.optimizer = optimizer

    def compute(self, input_vals, ectx):
        opt = self.optimizer
        # mixed precision: update the f32 masters from upcast gradients;
        # ectx.params holds the compute-dtype copies
        masters = ectx.master_params or ectx.params
        grad_vals, param_vals = {}, {}
        for node, gval in zip(opt.params, input_vals):
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
        lr = ectx.lr if ectx.lr is not None else opt.learning_rate
        new_params, new_state = opt.update(
            param_vals, grad_vals, ectx.opt_state or {}, lr, ectx.step)
        ectx.new_params.update(new_params)
        ectx.new_opt_state = {**(ectx.opt_state or {}), **new_state}
        return torch.zeros(1, dtype=torch.float32, device=ectx.device)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return (1,)
