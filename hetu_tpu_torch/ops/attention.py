"""Attention functions of the serving path.

Counterpart of the pure functions in ``hetu_tpu/ops/attention.py``
(``attention_reference`` and the serving helpers); the graph ops
(``FlashAttentionOp`` and the sequence-parallel variants) come with the
training slice. Layouts match the reference: ``[B, H, S, D]`` for dense
attention, ``[num_blocks, block_size, H, D]`` (or flat
``[num_blocks * block_size, H, D]``) for the paged pools.

The composed paths mask with -1e9, as the reference does; only the
flash kernel uses ``NEG_INF`` (-1e30).
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention

__all__ = ["attention_reference", "decode_attention", "prefill_attention",
           "paged_decode_attention", "paged_prefill_attention"]


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
    mask = None
    if causal:
        s = q.shape[-2]
        mask = torch.where(
            torch.ones(s, s, dtype=torch.bool, device=q.device).tril(),
            0.0, -1e9)[None, None]
    return attention_reference(q, k, v, mask, sm_scale)
