"""Softmax cross-entropy (counterpart of ``hetu_tpu/ops/losses.py``;
reference: gpu_ops/{SoftmaxCrossEntropy,SoftmaxCrossEntropySparse}.py).

The dense loss takes one-hot or soft labels shaped like the logits and
returns the per-row loss; its gradient is ``(softmax - labels) *
grad``. The sparse loss takes integer labels: labels equal to
``ignored_index`` contribute 0 loss and 0 gradient; other labels are
clipped into the class range, as the reference's gather clips. The
losses run in the logits' dtype (bf16 under a bf16 executor), as in the
reference.

Binary cross-entropy and ``crossentropy_op`` take probabilities, which
both directions clip to ``[_PROB_EPS, 1 - _PROB_EPS]`` (CE: from below
only) before any log or division, as the reference does."""
from __future__ import annotations

import torch

from ..graph.node import Op

__all__ = ["softmaxcrossentropy_op", "softmaxcrossentropy_gradient_op",
           "softmaxcrossentropy_sparse_op",
           "softmaxcrossentropy_sparse_gradient_op", "binarycrossentropy_op",
           "binarycrossentropy_gradient_op", "crossentropy_op"]

_PROB_EPS = 1e-12


class SoftmaxCrossEntropyOp(Op):
    """Per-row CE of logits (node_A) against one-hot or soft labels
    (node_B); the output has the batch dims."""

    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(SoftmaxCrossEntropyOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        logits, labels = input_vals
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        return -(labels * (logits - logz)).sum(dim=-1)

    def gradient(self, output_grad):
        return [softmaxcrossentropy_gradient_op(
            self.inputs[0], self.inputs[1], output_grad,
            ctx=self.raw_ctx), None]

    def infer_shape(self, input_shapes):
        shape = tuple(input_shapes[0][:-1])
        return shape if shape else (1,)


class SoftmaxCrossEntropyGradientOp(Op):
    def __init__(self, node_A, node_B, grad_node, ctx=None):
        super().__init__(SoftmaxCrossEntropyGradientOp,
                         [node_A, node_B, grad_node], ctx)

    def compute(self, input_vals, ectx):
        logits, labels, grad = input_vals
        return (torch.softmax(logits, dim=-1) - labels) * grad.unsqueeze(-1)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


def _clipped(labels, nclass):
    return labels.long().clamp(0, nclass - 1).unsqueeze(-1)


class SoftmaxCrossEntropySparseOp(Op):
    def __init__(self, node_A, node_B, ignored_index=-1, ctx=None):
        super().__init__(SoftmaxCrossEntropySparseOp, [node_A, node_B], ctx)
        self.ignored_index = ignored_index

    def compute(self, input_vals, ectx):
        logits, labels = input_vals
        logz = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, _clipped(labels, logits.shape[-1]))
        loss = logz - picked.squeeze(-1)
        return loss.masked_fill(labels == self.ignored_index, 0.0)

    def gradient(self, output_grad):
        return [softmaxcrossentropy_sparse_gradient_op(
            self.inputs[0], self.inputs[1], output_grad,
            self.ignored_index, ctx=self.raw_ctx), None]

    def infer_shape(self, input_shapes):
        shape = tuple(input_shapes[0][:-1])
        return shape if shape else (1,)


class SoftmaxCrossEntropySparseGradientOp(Op):
    """``(softmax(logits) - onehot(labels)) * grad``, 0 on ignored rows.
    The one-hot is never built: 1 is subtracted at each row's label in
    the softmax tensor itself (a ``[B*S, vocab]`` one-hot in int64 would
    be 3.3 GB at GPT-2's vocabulary and B*S = 8192)."""

    def __init__(self, node_A, node_B, node_C, ignored_index=-1, ctx=None):
        super().__init__(SoftmaxCrossEntropySparseGradientOp,
                         [node_A, node_B, node_C], ctx)
        self.ignored_index = ignored_index

    def compute(self, input_vals, ectx):
        logits, labels, grad = input_vals
        d = torch.softmax(logits, dim=-1)
        idx = _clipped(labels, logits.shape[-1])
        d.scatter_(-1, idx, d.gather(-1, idx) - 1)
        d.mul_(grad.unsqueeze(-1))
        return d.masked_fill_((labels == self.ignored_index).unsqueeze(-1),
                              0.0)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class BinaryCrossEntropyOp(Op):
    """Elementwise BCE of predictions (node_A, already in (0, 1)) against
    labels (node_B) (reference BinaryCrossEntropy.py)."""

    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(BinaryCrossEntropyOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        pred, label = input_vals
        pred = torch.clamp(pred, _PROB_EPS, 1 - _PROB_EPS)
        return -(label * torch.log(pred) + (1 - label) * torch.log(1 - pred))

    def gradient(self, output_grad):
        return [binarycrossentropy_gradient_op(
            self.inputs[0], self.inputs[1], output_grad, ctx=self.raw_ctx),
            None]

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class BinaryCrossEntropyGradientOp(Op):
    def __init__(self, node_A, node_B, node_C, ctx=None):
        super().__init__(BinaryCrossEntropyGradientOp,
                         [node_A, node_B, node_C], ctx)

    def compute(self, input_vals, ectx):
        pred, label, grad = input_vals
        pred = torch.clamp(pred, _PROB_EPS, 1 - _PROB_EPS)
        return grad * (pred - label) / (pred * (1 - pred))

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class CrossEntropyOp(Op):
    """``-sum(labels * log(probs))`` over the last axis, the
    probabilities already normalized. Its gradient broadcasts the
    adjoint to the probabilities' shape right-aligned, as the
    reference's does."""

    def __init__(self, node_A, node_B, ctx=None):
        super().__init__(CrossEntropyOp, [node_A, node_B], ctx)

    def compute(self, input_vals, ectx):
        probs, labels = input_vals
        return -(labels * torch.log(torch.clamp(probs, min=_PROB_EPS))).sum(
            dim=-1)

    def gradient(self, output_grad):
        from .basic import clip_op, div_op, mul_op, opposite_op
        from .shape import broadcastto_op
        d = opposite_op(div_op(self.inputs[1],
                               clip_op(self.inputs[0], _PROB_EPS, None)))
        g = broadcastto_op(output_grad, self.inputs[0])
        return [mul_op(d, g, ctx=self.raw_ctx), None]

    def infer_shape(self, input_shapes):
        shape = tuple(input_shapes[0][:-1])
        return shape if shape else (1,)


def softmaxcrossentropy_op(node_A, node_B, use_cudnn=True, ctx=None):
    """``use_cudnn`` is the reference's argument and selects nothing."""
    return SoftmaxCrossEntropyOp(node_A, node_B, ctx=ctx)


def softmaxcrossentropy_gradient_op(node_A, node_B, grad_node, ctx=None):
    return SoftmaxCrossEntropyGradientOp(node_A, node_B, grad_node, ctx=ctx)


def softmaxcrossentropy_sparse_op(node_A, node_B, ignored_index=-1,
                                  ctx=None):
    return SoftmaxCrossEntropySparseOp(node_A, node_B,
                                       ignored_index=ignored_index, ctx=ctx)


def softmaxcrossentropy_sparse_gradient_op(node_A, node_B, node_C,
                                           ignored_index=-1, ctx=None):
    return SoftmaxCrossEntropySparseGradientOp(
        node_A, node_B, node_C, ignored_index=ignored_index, ctx=ctx)


def binarycrossentropy_op(node_A, node_B, ctx=None):
    return BinaryCrossEntropyOp(node_A, node_B, ctx=ctx)


def binarycrossentropy_gradient_op(node_A, node_B, node_C, ctx=None):
    return BinaryCrossEntropyGradientOp(node_A, node_B, node_C, ctx=ctx)


def crossentropy_op(node_A, node_B, ctx=None):
    return CrossEntropyOp(node_A, node_B, ctx=ctx)
