"""Attention: the fused graph op and the serving functions.

Counterpart of ``hetu_tpu/ops/attention.py``: ``attention_reference``,
the serving helpers, and the graph op :class:`FlashAttentionOp` with
its gradient op, routed as in the reference (training at S >=
:data:`FUSED_BWD_MIN_SEQ` runs kernel K2 forward and K3 + K4 backward,
otherwise K1 forward and the composed vjp backward). The
sequence-parallel variants (ring, Ulysses) wait for the parallel
modes. Layouts match the reference: ``[B, H, S, D]`` for dense
attention, ``[num_blocks, block_size, H, D]`` (or flat
``[num_blocks * block_size, H, D]``) for the paged pools.

The composed paths mask with -1e9, as the reference does; only the
flash kernel uses ``NEG_INF`` (-1e30).
"""
from __future__ import annotations

import torch

from ..graph.node import Op
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_with_lse)

__all__ = ["attention_reference", "decode_attention", "prefill_attention",
           "paged_decode_attention", "paged_prefill_attention",
           "flash_attention_op", "FlashAttentionOp", "FUSED_BWD_MIN_SEQ"]

# sequence length from which training takes the fused kernels (K2
# forward, K3 + K4 backward) instead of K1 and the composed vjp; the
# reference's value, picked on the TPU. PERF.md holds this card's
# crossover measurement.
FUSED_BWD_MIN_SEQ = 512


def attention_reference(q, k, v, mask, sm_scale):
    """softmax(q k^T * scale + mask) v — [B, H, S, D] layout."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def decode_attention(q, k_cache, v_cache, pos, sm_scale):
    """One query token ``q [B, H, D]`` against a dense cache
    ``[B, H, S_max, D]`` whose rows ``0..pos`` are valid. Returns
    ``[B, H, D]``."""
    s_max = k_cache.shape[2]
    scores = torch.einsum("bhd,bhsd->bhs", q * sm_scale, k_cache)
    valid = torch.arange(s_max, device=q.device) <= pos
    scores = scores.masked_fill(~valid[None, None, :], -1e9)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhs,bhsd->bhd", probs.to(v_cache.dtype), v_cache)


def _flat_pool(pool):
    return pool.reshape(-1, *pool.shape[2:]) if pool.dim() == 4 else pool


def paged_decode_attention(q, k_pool, v_pool, slot_idx, positions,
                           sm_scale):
    """One query token per sequence against a block-paged KV pool.

    ``q [B, H, D]``; ``slot_idx [B, S]`` maps position ``j`` of
    sequence ``b`` to its flat pool slot; ``positions [B]`` is each
    sequence's current 0-based position, so ragged lengths decode in
    one call (positions past it sit behind the ``j <= positions[b]``
    mask). Returns ``[B, H, D]``."""
    k = _flat_pool(k_pool)[slot_idx]                    # [B, S, H, D]
    v = _flat_pool(v_pool)[slot_idx]
    scores = torch.einsum("bhd,bshd->bhs", q * sm_scale, k)
    valid = torch.arange(slot_idx.shape[1], device=q.device)[None, :] \
        <= positions[:, None]
    scores = scores.masked_fill(~valid[:, None, :], -1e9)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhs,bshd->bhd", probs.to(v.dtype), v)


def paged_prefill_attention(q, k_pool, v_pool, slot_idx, starts,
                            sm_scale):
    """A chunk of ``C`` query positions per sequence, ``q [B, C, H, D]``
    starting at ``starts [B]``, against the paged pool; the chunk's own
    K/V rows are already scattered. Chunk row ``i`` sees positions
    ``<= starts[b] + i``. Returns ``[B, C, H, D]``."""
    k = _flat_pool(k_pool)[slot_idx]                    # [B, S, H, D]
    v = _flat_pool(v_pool)[slot_idx]
    scores = torch.einsum("bihd,bshd->bhis", q * sm_scale, k)
    pos = starts[:, None] + torch.arange(q.shape[1], device=q.device)[None]
    valid = torch.arange(slot_idx.shape[1], device=q.device)[None, None, :] \
        <= pos[:, :, None]                              # [B, C, S]
    scores = scores.masked_fill(~valid[:, None, :, :], -1e9)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhis,bshd->bihd", probs.to(v.dtype), v)


def prefill_attention(q, k, v, sm_scale, causal=True):
    """Dense prompt-phase attention over ``[B, H, S, D]`` q/k/v: the
    flash kernel K1 on CUDA tensors, the composed reference elsewhere
    (the reference's own split between its TPU and other backends)."""
    if q.is_cuda:
        return flash_attention(q, k, v, None, sm_scale=sm_scale,
                               causal=causal)
    mask = _causal_mask(q.shape[-2], q.device) if causal else None
    return attention_reference(q, k, v, mask, sm_scale)


def _causal_mask(s, device):
    """The composed paths' additive causal mask, [1, 1, S, S], -1e9."""
    return torch.where(torch.ones(s, s, dtype=torch.bool,
                                  device=device).tril(), 0.0, -1e9)[None, None]


class FlashAttentionOp(Op):
    """Fused attention over [B, H, S, D] q/k/v with an additive mask of
    shape [B, 1, 1, S] (or None); ``causal`` is a kernel flag."""

    def __init__(self, q, k, v, mask=None, sm_scale=1.0, causal=False,
                 ctx=None):
        inputs = [q, k, v] + ([mask] if mask is not None else [])
        super().__init__(FlashAttentionOp, inputs, ctx)
        self.has_mask = mask is not None
        self.sm_scale = sm_scale
        self.causal = causal

    def compute(self, input_vals, ectx):
        q, k, v = input_vals[:3]
        mask = input_vals[3] if self.has_mask else None
        # the logsumexp residual is stashed for the fused backward only
        # when something will consume it: training at a length where
        # the fused path engages
        if ectx.training and q.shape[-2] >= FUSED_BWD_MIN_SEQ:
            o, lse = flash_attention_with_lse(
                q, k, v, mask, sm_scale=self.sm_scale, causal=self.causal)
            if o is not None:
                ectx.cache[("flash_res", self.id)] = (o, lse)
                return o
        return flash_attention(q, k, v, mask, sm_scale=self.sm_scale,
                               causal=self.causal)

    def gradient(self, output_grad):
        grads = [_FlashAttentionGradOp(self, output_grad, i,
                                       ctx=self.raw_ctx) for i in range(3)]
        if self.has_mask:
            grads.append(None)
        return grads

    def infer_shape(self, input_shapes):
        return input_shapes[0]


class _FlashAttentionGradOp(Op):
    """dq / dk / dv, one op per operand so the graph stays an adjoint DAG.
    The first of the three to run computes all three — by K3 + K4 from
    the forward's stashed residual, or by the composed vjp — and each
    takes its own; the step's cache drops the residual and the grads as
    soon as they are consumed."""

    def __init__(self, forward_op, output_grad, which, ctx=None):
        super().__init__(_FlashAttentionGradOp,
                         list(forward_op.inputs) + [output_grad], ctx)
        self.forward_op = forward_op
        self.which = which

    def compute(self, input_vals, ectx):
        fwd = self.forward_op
        q, k, v = input_vals[:3]
        mask = input_vals[3] if fwd.has_mask else None
        dy = input_vals[4 if fwd.has_mask else 3]
        key = ("flashattn_vjp", fwd.id)
        if key not in ectx.cache:
            res = ectx.cache.pop(("flash_res", fwd.id), None)
            if res is not None and q.shape[-2] >= FUSED_BWD_MIN_SEQ:
                o, lse = res
                grads = flash_attention_bwd(q, k, v, mask, o, lse, dy,
                                            sm_scale=fwd.sm_scale,
                                            causal=fwd.causal)
            else:
                def f(q_, k_, v_):
                    m = mask
                    if fwd.causal:
                        cm = _causal_mask(q_.shape[-2], q_.device)
                        m = cm if m is None else m + cm
                    return attention_reference(q_, k_, v_, m, fwd.sm_scale)
                _, vjp = torch.func.vjp(f, q, k, v)
                grads = vjp(dy)
            ectx.cache[key] = list(grads)
        grads = ectx.cache[key]
        out, grads[self.which] = grads[self.which], None
        if all(g is None for g in grads):
            del ectx.cache[key]
        return out

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        return input_shapes[self.which]


def flash_attention_op(q, k, v, mask=None, sm_scale=1.0, causal=False,
                       ctx=None):
    return FlashAttentionOp(q, k, v, mask, sm_scale, causal, ctx=ctx)
