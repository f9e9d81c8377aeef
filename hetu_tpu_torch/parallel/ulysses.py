"""Ulysses sequence parallelism: all-to-all head/sequence exchange.

Counterpart of ``hetu_tpu/parallel/ulysses.py``. Where the ring passes
K/V shards from rank to rank, Ulysses re-shards with two all-to-alls
over the group (:meth:`~hetu_tpu_torch.ops.comm.GroupComm.all_to_all`):
the first turns sequence-sharded ``[B, H, S/n, D]`` projections into
head-sharded ``[B, H/n, S, D]``, each rank attends the whole sequence
for its heads, and the second restores the sequence split. It needs
``H % n == 0``, which the ring does not.

The whole-sequence attention of a rank's heads is kernel K2 (causal or
masked) with K3 + K4 for its backward, wherever the kernel takes the
shape; elsewhere (lengths the kernel's tiles do not divide) the
reference's ``_blocked_attention``, composed in torch over key blocks
with the online-softmax merge (:func:`blocked_attention`), counted in
:data:`~hetu_tpu_torch.parallel.ring.composed_blocks`.

Every function here runs on one rank; :mod:`~hetu_tpu_torch.ops.
attention` cuts the shards and gathers the output
(``UlyssesAttentionOp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ring import (_MASKED, _bias, _count, _kernel_shape, merge,
                   partial_attention, partial_attention_bwd)
from ..ops.flash_attention import (flash_attention_bwd,
                                   flash_attention_with_lse)

__all__ = ["seq_to_heads", "heads_to_seq", "blocked_attention",
           "blocked_attention_bwd", "ulysses_attention",
           "ulysses_attention_bwd"]


def _check_heads(h, n):
    if h % n:
        raise ValueError(
            f"Ulysses needs heads ({h}) divisible by the sp axis ({n})")


def seq_to_heads(x, comm):
    """``[..., H, S/n, D]`` sequence shards -> ``[..., H/n, S, D]`` head
    shards (the reference's tiled ``all_to_all(split_axis=1,
    concat_axis=2)``), leading dims kept: one all-to-all."""
    n = comm.nrank
    *lead, h, sl, d = x.shape
    _check_heads(h, n)
    parts = x.reshape(*lead, n, h // n, sl, d).movedim(-4, 0)
    got = comm.all_to_all(parts)            # [n (source rank), ..., H/n, Sl, D]
    return got.movedim(0, -3).reshape(*lead, h // n, n * sl, d)


def heads_to_seq(x, comm):
    """The inverse of :func:`seq_to_heads`: ``[..., H/n, S, D]`` ->
    ``[..., H, S/n, D]``."""
    n = comm.nrank
    *lead, hn, s, d = x.shape
    parts = x.reshape(*lead, hn, n, s // n, d).movedim(-3, 0)
    got = comm.all_to_all(parts)            # [n (source rank), ..., H/n, Sl, D]
    return got.movedim(0, -4).reshape(*lead, n * hn, s // n, d)


def _key_blocks(s, block):
    block = min(block, s)
    return block, -s % block


def blocked_attention(q, k, v, sm_scale, mask, block=1024, causal=False):
    """The reference's ``_blocked_attention`` in (output, logsumexp)
    form: whole-sequence attention as a loop over key blocks of
    ``block`` with the online-softmax merge, O(S * block) scores. When S
    is not a block multiple, K/V pad up to one and the tail is masked
    out; ``causal`` adds the decoder mask per block from global
    positions. Returns f32 (o, lse)."""
    b, h, s, d = q.shape
    block, pad = _key_blocks(s, block)
    k, v, mask = _pad_keys(k, v, mask, b, s, pad)
    acc = None
    for start in range(0, s + pad, block):
        ks = slice(start, start + block)
        bias = _bias(q, k[:, :, ks], mask[..., ks], causal, k0=start)
        acc = merge(acc, partial_attention(q, k[:, :, ks], v[:, :, ks],
                                           bias, sm_scale))
    return acc


def blocked_attention_bwd(q, k, v, sm_scale, mask, o, lse, do, block=1024,
                          causal=False):
    """The adjoint of :func:`blocked_attention` over the same key blocks,
    each at the whole rows' softmax. Returns f32 (dq, dk, dv)."""
    b, h, s, d = q.shape
    block, pad = _key_blocks(s, block)
    kp, vp, mask = _pad_keys(k, v, mask, b, s, pad)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kp.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vp.shape, dtype=torch.float32, device=q.device)
    for start in range(0, s + pad, block):
        ks = slice(start, start + block)
        bias = _bias(q, kp[:, :, ks], mask[..., ks], causal, k0=start)
        gq, gk, gv = partial_attention_bwd(q, kp[:, :, ks], vp[:, :, ks],
                                           bias, o, lse, do, sm_scale)
        dq += gq
        dk[:, :, ks] += gk
        dv[:, :, ks] += gv
    return dq, dk[:, :, :s], dv[:, :, :s]


def _pad_keys(k, v, mask, b, s, pad):
    """K/V padded by ``pad`` zero rows, and the key mask (zeros where
    None) by -1e9 over them."""
    if mask is None:
        mask = torch.zeros(b, 1, 1, s, dtype=torch.float32, device=k.device)
    mask = mask.to(torch.float32).expand(b, 1, 1, s)
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad), value=_MASKED)
    return k, v, mask


def _local_attention(q, k, v, mask, sm_scale, causal):
    """A rank's whole-sequence attention for its heads: K2, else the
    composed blocked attention (counted). Returns (o in q's dtype, f32
    lse)."""
    o, lse = flash_attention_with_lse(q, k, v, mask, sm_scale=sm_scale,
                                      causal=causal)
    if o is not None:
        return o, lse
    _count("ulysses.fwd")
    o, lse = blocked_attention(q, k, v, sm_scale, mask, causal=causal)
    return o.to(q.dtype), lse


def ulysses_attention(q, k, v, comm, sm_scale=1.0, mask=None,
                      causal=False):
    """One rank's Ulysses attention: ``q``, ``k``, ``v`` this rank's
    sequence shards ``[B, H, S/n, D]``, ``mask`` its key-mask shard or
    None. Returns (output ``[B, H, S/n, D]`` in q's dtype, the residual
    its backward reads: the head shards, the whole mask, their output
    and logsumexp)."""
    _check_heads(q.shape[1], comm.nrank)
    qh, kh, vh = seq_to_heads(torch.stack([q, k, v]), comm).unbind(0)
    mask_full = None if mask is None else comm.all_gather(
        mask.contiguous(), dim=mask.dim() - 1)
    oh, lse = _local_attention(qh, kh, vh, mask_full, sm_scale, causal)
    return heads_to_seq(oh, comm), (qh, kh, vh, mask_full, oh, lse)


def ulysses_attention_bwd(residual, do, comm, sm_scale=1.0, causal=False):
    """The adjoint of :func:`ulysses_attention` on one rank: ``do`` the
    output's adjoint on the rank's rows ``[B, H, S/n, D]`` goes to the
    head shards by the first all-to-all, K3 + K4 (or the composed
    adjoint) give the head shards' (dq, dk, dv), and the second
    all-to-all returns them to the rank's rows. Returns (dq, dk, dv)
    ``[B, H, S/n, D]`` in q's dtype."""
    qh, kh, vh, mask_full, oh, lse = residual
    doh = seq_to_heads(do.to(qh.dtype), comm)
    if _kernel_shape(qh):
        grads = flash_attention_bwd(qh, kh, vh, mask_full, oh, lse, doh,
                                    sm_scale=sm_scale, causal=causal)
    else:
        _count("ulysses.bwd")
        grads = blocked_attention_bwd(qh, kh, vh, sm_scale, mask_full, oh,
                                      lse, doh, causal=causal)
    stacked = torch.stack([g.to(qh.dtype) for g in grads])
    return heads_to_seq(stacked, comm).unbind(0)
