"""Ring attention: sequence parallelism over a ring of ranks.

Counterpart of ``hetu_tpu/parallel/ring.py``. The sequence axis is cut
over the ranks of a process group (:class:`~hetu_tpu_torch.ops.comm.
GroupComm`, the session mesh's ``"sp"`` axis): each rank keeps its
query shard, and the K/V shards (and the key mask's) pass to the next
rank, one hop at a time, while the blocks' partial results merge by the
online-softmax rule, the distributed form of flash attention.

A block is one attention of a query shard against a key shard:
:func:`attention_block` returns its output and its per-row logsumexp,
by kernel K2 (:func:`~hetu_tpu_torch.ops.flash_attention.
flash_attention_with_lse`) wherever the kernel takes the shape, else by
the reference's own arithmetic composed in torch (counted in
:data:`composed_blocks`). :func:`merge` combines two blocks by their
logsumexp in f32. The backward runs the same ring again with K3 and K4
on every block (:func:`attention_block_bwd`), fed the merged output's
rows and their global logsumexp, so each block's ``p = exp(s - lse)``
is the global softmax: dQ accumulates on the rank, the dK/dV partials
travel with their K/V block and come home after the last hop.

Causal attention uses the zigzag layout (:func:`zigzag_indices`): rank
r holds chunks ``(r, 2n-1-r)`` of a 2n-chunk split, so every rank
scores the same number of pairs at every hop. The local rows keep the
global order, so the diagonal block is K2 with its causal flag; a hop
from an earlier rank attends both query chunks to the first key chunk,
a hop from a later one the second query chunk to both key chunks. K2-K4
take q, k and v of one shape, so each such hop is two square blocks.

Every function here runs on one rank and returns that rank's rows;
:mod:`~hetu_tpu_torch.ops.attention` cuts the shards and gathers the
output (``RingAttentionOp``).
"""
from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ..ops.flash_attention import (flash_attention_bwd,
                                   flash_attention_with_lse)

__all__ = ["zigzag_indices", "attention_block", "attention_block_bwd",
           "merge", "ring_attention", "ring_attention_bwd",
           "zigzag_ring_attention", "zigzag_ring_attention_bwd",
           "composed_blocks", "reset_composed_blocks"]

# blocks computed by the composed arithmetic, by ``"<where>.fwd"`` /
# ``"<where>.bwd"``: on the card a block the kernels do not take shows
# here, so a run can hold its shapes to zero
composed_blocks = collections.Counter()
_count_lock = threading.Lock()

# the composed paths' masked-score value, as the reference's
_MASKED = -1e9


def reset_composed_blocks():
    with _count_lock:
        composed_blocks.clear()


def _count(key):
    with _count_lock:
        composed_blocks[key] += 1


def zigzag_indices(s, n):
    """Index permutation mapping the natural sequence order to the zigzag
    shard layout: shard r holds chunks (r, 2n-1-r) of a 2n-chunk split.
    Returns (perm, inv): ``x[perm]`` is zigzag order, ``y[inv]`` undoes it.
    """
    if s % (2 * n):
        raise ValueError(
            f"causal ring needs seq len ({s}) divisible by 2*sp axis "
            f"({2 * n})")
    c = s // (2 * n)
    perm = np.concatenate([
        np.concatenate([np.arange(r * c, (r + 1) * c),
                        np.arange((2 * n - 1 - r) * c, (2 * n - r) * c)])
        for r in range(n)])
    return perm, np.argsort(perm)


# ---------------------------------------------------------------------------
# one block: K2 forward, K3 + K4 backward, or the composed arithmetic
# ---------------------------------------------------------------------------

def _bias(q, k, mask, causal, k0=0):
    """The composed block's additive bias: the key mask and, under
    ``causal``, -1e9 where key position ``k0 + j`` follows query row
    ``i`` (positions local to the block's rows, which keep the global
    order)."""
    bias = None if mask is None else mask.to(torch.float32)
    if causal:
        q_pos = torch.arange(q.shape[2], device=q.device)
        k_pos = k0 + torch.arange(k.shape[2], device=q.device)
        cm = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                         _MASKED)[None, None]
        bias = cm if bias is None else bias + cm
    return bias


def _scores(q, k, bias, sm_scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * sm_scale
    return s if bias is None else s + bias


def partial_attention(q, k, v, bias, sm_scale):
    """The reference's ``_partial_attn`` in (output, logsumexp) form: the
    f32 scores, their row max m and normalizer l, the output of ``p``
    rounded to v's dtype against v; returns (o / l, m + log l), both
    f32."""
    s = _scores(q, k, bias, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o / l, (m + torch.log(l))[..., 0]


def partial_attention_bwd(q, k, v, bias, o, lse, do, sm_scale):
    """The adjoint of one block at the global softmax: ``p = exp(s -
    lse)`` from the merged rows' logsumexp, ``D = rowsum(dO o)`` from
    their merged output. Returns f32 (dq, dk, dv), the block's part."""
    f32 = torch.float32
    p = torch.exp(_scores(q, k, bias, sm_scale) - lse[..., None])
    dof = do.to(f32)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.to(f32))
    delta = (dof * o.to(f32)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * sm_scale
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.to(f32)),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f32)), dv)


def attention_block(q, k, v, mask, sm_scale, causal=False, where="ring"):
    """(output, f32 logsumexp ``[B, H, Sq]``) of ``q`` against one key
    block: K2 where the kernel takes the shape (q, k, v of one shape
    and a length ``_supported`` takes; its output in q's dtype), else
    the composed arithmetic (f32), counted under ``f"{where}.fwd"``."""
    if q.shape == k.shape:
        o, lse = flash_attention_with_lse(q, k, v, mask, sm_scale=sm_scale,
                                          causal=causal)
        if o is not None:
            return o, lse
    _count(f"{where}.fwd")
    return partial_attention(q, k, v, _bias(q, k, mask, causal), sm_scale)


def attention_block_bwd(q, k, v, mask, o, lse, do, sm_scale, causal=False,
                        where="ring"):
    """(dq, dk, dv) of one block at the global softmax (``o``, ``lse``
    the merged rows'): K3 + K4 where K2 took the block's shape (their
    outputs in q's dtype), else the composed adjoint (f32), counted
    under ``f"{where}.bwd"``."""
    if q.shape == k.shape and _kernel_shape(q):
        return flash_attention_bwd(q, k, v, mask, o.to(q.dtype), lse,
                                   do.to(q.dtype), sm_scale=sm_scale,
                                   causal=causal)
    _count(f"{where}.bwd")
    return partial_attention_bwd(q, k, v, _bias(q, k, mask, causal), o,
                                 lse, do, sm_scale)


def _kernel_shape(q):
    from ..ops.flash_attention import _block_sizes, _supported
    s, d = q.shape[-2], q.shape[-1]
    return _supported(s, d, *_block_sizes(s, d))


def merge(acc, blk):
    """Two (output, logsumexp) partials of the same rows merged in f32:
    the reference's ``_merge`` (the flash rescale rule) in (o, lse)
    form. ``acc`` None is the empty partial."""
    o_b, lse_b = blk[0].to(torch.float32), blk[1]
    if acc is None:
        return o_b, lse_b
    o_a, lse_a = acc
    lse = torch.logaddexp(lse_a, lse_b)
    return (o_a * torch.exp(lse_a - lse)[..., None]
            + o_b * torch.exp(lse_b - lse)[..., None]), lse


# ---------------------------------------------------------------------------
# the non-causal ring
# ---------------------------------------------------------------------------

def _key_part(mask, sl):
    return None if mask is None else mask[..., sl]


def ring_attention(q, k, v, comm, sm_scale=1.0, mask=None):
    """One rank's ring attention (bidirectional): ``q``, ``k``, ``v``
    this rank's shards ``[B, H, S/n, D]``, ``mask`` its key-mask shard
    ``[B, 1, 1, S/n]`` or None. K/V and the mask pass to the next rank
    of ``comm`` n-1 times. Returns (output in q's dtype, f32
    logsumexp) of the rank's rows."""
    acc = None
    k_cur, v_cur, m_cur = k, v, mask
    for t in range(comm.nrank):
        if t:
            k_cur, v_cur, m_cur = comm.ring_shift([k_cur, v_cur, m_cur])
        acc = merge(acc, attention_block(q, k_cur, v_cur, m_cur, sm_scale))
    return acc[0].to(q.dtype), acc[1]


def ring_attention_bwd(q, k, v, o, lse, do, comm, sm_scale=1.0, mask=None):
    """The adjoint of :func:`ring_attention` on one rank: the ring again,
    each block's (dq, dk, dv) from K3 + K4 at the global softmax. dQ
    sums on the rank; the dK/dV sums travel with their K/V block and a
    last hop brings them home. Sums are f32; each block's part comes out
    of K3/K4 in q's dtype (bf16 on the card's main path), rounded once
    before it is added. Returns f32 (dq, dk, dv) of the rank's shards."""
    f32 = torch.float32
    n = comm.nrank
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=q.device)
    dv = torch.zeros(v.shape, dtype=f32, device=q.device)
    k_cur, v_cur, m_cur = k, v, mask
    for t in range(n):
        if t:
            k_cur, v_cur, m_cur, dk, dv = comm.ring_shift(
                [k_cur, v_cur, m_cur, dk, dv])
        gq, gk, gv = attention_block_bwd(q, k_cur, v_cur, m_cur, o, lse, do,
                                         sm_scale)
        dq += gq
        dk += gk
        dv += gv
    if n > 1:
        dk, dv = comm.ring_shift([dk, dv])
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the zigzag causal ring
# ---------------------------------------------------------------------------

def _zigzag_blocks(r, src, c):
    """The (query rows, key rows) square blocks of a hop from ``src`` to
    rank ``r`` (chunks of length ``c``): the diagonal (causal) at
    ``src == r``; from an earlier rank both query chunks against the
    first key chunk; from a later one the second query chunk against
    both key chunks."""
    first, second, both = slice(0, c), slice(c, 2 * c), slice(0, 2 * c)
    if src == r:
        return [(both, both, True)]
    if src < r:
        return [(first, first, False), (second, first, False)]
    return [(second, first, False), (second, second, False)]


def zigzag_ring_attention(q, k, v, comm, sm_scale=1.0, mask=None):
    """One rank's causal ring attention over the zigzag layout: ``q``,
    ``k``, ``v`` chunks ``(r, 2n-1-r)`` of the 2n-chunk sequence
    ``[B, H, 2c, D]``, ``mask`` their key-mask shard (zigzag order) or
    None. Returns (output in q's dtype, f32 logsumexp) of the rank's
    rows."""
    n, r = comm.nrank, comm.rank
    c = q.shape[2] // 2
    acc = [None, None]                  # the two query chunks' partials
    k_cur, v_cur, m_cur = k, v, mask
    for t in range(n):
        if t:
            k_cur, v_cur, m_cur = comm.ring_shift([k_cur, v_cur, m_cur])
        for qs, ks, causal in _zigzag_blocks(r, (r - t) % n, c):
            blk = attention_block(q[:, :, qs], k_cur[:, :, ks],
                                  v_cur[:, :, ks], _key_part(m_cur, ks),
                                  sm_scale, causal)
            if causal:                  # the diagonal: both chunks
                acc = [merge(a, (blk[0][:, :, s], blk[1][:, :, s]))
                       for a, s in zip(acc, (slice(0, c), slice(c, 2 * c)))]
            else:
                i = qs.start // c
                acc[i] = merge(acc[i], blk)
    o = torch.cat([acc[0][0], acc[1][0]], dim=2)
    return o.to(q.dtype), torch.cat([acc[0][1], acc[1][1]], dim=2)


def zigzag_ring_attention_bwd(q, k, v, o, lse, do, comm, sm_scale=1.0,
                              mask=None):
    """The adjoint of :func:`zigzag_ring_attention` on one rank, as
    :func:`ring_attention_bwd` is of the ring: each hop's square blocks
    through K3 + K4 at the merged rows' output and logsumexp. Returns
    f32 (dq, dk, dv) of the rank's shards."""
    f32 = torch.float32
    n, r = comm.nrank, comm.rank
    c = q.shape[2] // 2
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=q.device)
    dv = torch.zeros(v.shape, dtype=f32, device=q.device)
    k_cur, v_cur, m_cur = k, v, mask
    for t in range(n):
        if t:
            k_cur, v_cur, m_cur, dk, dv = comm.ring_shift(
                [k_cur, v_cur, m_cur, dk, dv])
        for qs, ks, causal in _zigzag_blocks(r, (r - t) % n, c):
            gq, gk, gv = attention_block_bwd(
                q[:, :, qs], k_cur[:, :, ks], v_cur[:, :, ks],
                _key_part(m_cur, ks), o[:, :, qs], lse[:, :, qs],
                do[:, :, qs], sm_scale, causal)
            dq[:, :, qs] += gq
            dk[:, :, ks] += gk
            dv[:, :, ks] += gv
    if n > 1:
        dk, dv = comm.ring_shift([dk, dv])
    return dq, dk, dv
