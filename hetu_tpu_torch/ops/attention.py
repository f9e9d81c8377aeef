"""Attention: the fused graph op and the serving functions.

Counterpart of ``hetu_tpu/ops/attention.py``: ``attention_reference``,
the serving helpers, and the graph op :class:`FlashAttentionOp` with
its gradient op, routed as in the reference (training at S >=
:data:`FUSED_BWD_MIN_SEQ` runs kernel K2 forward and K3 + K4 backward,
otherwise K1 forward and the composed vjp backward), and the
sequence-parallel ops :class:`RingAttentionOp` and
:class:`UlyssesAttentionOp`, which run over the session mesh's ``"sp"``
axis and take :class:`FlashAttentionOp`'s path off it. Layouts match
the reference: ``[B, H, S, D]`` for dense
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
           "flash_attention_op", "FlashAttentionOp", "FUSED_BWD_MIN_SEQ",
           "RingAttentionOp", "UlyssesAttentionOp", "ring_attention_op",
           "ulysses_attention_op"]

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


# ---------------------------------------------------------------------------
# sequence parallelism: ring and Ulysses attention as graph ops
# ---------------------------------------------------------------------------

def _sp_comm(ectx):
    """The :class:`~hetu_tpu_torch.ops.comm.GroupComm` of the session
    mesh's ``"sp"`` axis, or None where the mesh has none (the
    reference's ``_sp_mesh``)."""
    mesh = getattr(getattr(ectx, "config", None), "mesh", None)
    if mesh is not None and "sp" in mesh.axis_names:
        return mesh.comm("sp")
    return None


def _cut(x, rows, dim):
    """``x``'s ``rows`` (a slice or an index tensor) on ``dim``."""
    if isinstance(rows, slice):
        return x.narrow(dim, rows.start, rows.stop - rows.start)
    return x.index_select(dim, rows.to(x.device))


class _SeqParallelAttentionOp(FlashAttentionOp):
    """Base of the sequence-parallel attention ops (the reference's
    ``_SeqParallelAttentionOp``). On a session mesh with an ``"sp"``
    axis each rank cuts its shard of the (replicated) q, k, v and mask
    (:meth:`_rows`), runs the sharded program over the axis's group,
    and gathers the output whole: what ``shard_map``'s sequence-sharded
    output, consumed whole, amounts to. Its gradient ops return dq, dk
    and dv whole, gathered the same way, so every ``sp`` rank holds the
    same gradient of every replicated parameter. Off such a mesh the op
    is :class:`FlashAttentionOp`."""

    def _rows(self, s, comm):
        """(this rank's rows of the sequence, the order that puts the
        gathered rows back, or None)."""
        n, r = comm.nrank, comm.rank
        if s % n:
            raise ValueError(f"sequence parallelism needs the sequence "
                             f"({s}) divisible by the sp axis ({n})")
        sl = s // n
        return slice(r * sl, (r + 1) * sl), None

    def _shards(self, input_vals, rows):
        q, k, v = (_cut(x, rows, 2) for x in input_vals[:3])
        mask = input_vals[3] if self.has_mask else None
        if mask is not None:
            mask = _cut(mask, rows, mask.dim() - 1)
        return q, k, v, mask

    def _whole(self, x, comm, inv, dim):
        out = comm.all_gather(x, dim=dim)
        return out if inv is None else out.index_select(
            dim, inv.to(out.device))

    def compute(self, input_vals, ectx):
        comm = _sp_comm(ectx)
        if comm is None:
            return super().compute(input_vals, ectx)
        rows, inv = self._rows(input_vals[0].shape[2], comm)
        out, res = self._forward(*self._shards(input_vals, rows), comm)
        if ectx.training:
            ectx.cache[("sp_res", self.id)] = res
        return self._whole(out, comm, inv, 2)

    def _forward(self, q, k, v, mask, comm):
        """(this rank's output rows, the residual of its backward)."""
        raise NotImplementedError

    def _backward(self, shards, res, do, comm):
        """This rank's (dq, dk, dv) rows from the residual and the
        output's adjoint on its rows."""
        raise NotImplementedError

    def gradient(self, output_grad):
        grads = [_SeqParallelAttentionGradOp(self, output_grad, i,
                                             ctx=self.raw_ctx)
                 for i in range(3)]
        if self.has_mask:
            grads.append(None)
        return grads


class _SeqParallelAttentionGradOp(_FlashAttentionGradOp):
    """dq / dk / dv of a sequence-parallel op through its sharded
    program: the first of the three to run computes all three on the
    rank's rows and gathers them whole (one collective for the three);
    off an ``"sp"`` mesh, :class:`_FlashAttentionGradOp`."""

    def compute(self, input_vals, ectx):
        comm = _sp_comm(ectx)
        if comm is None:
            return super().compute(input_vals, ectx)
        fwd = self.forward_op
        key = ("spattn_vjp", fwd.id)
        if key not in ectx.cache:
            dy = input_vals[4 if fwd.has_mask else 3]
            rows, inv = fwd._rows(dy.shape[2], comm)
            shards = fwd._shards(input_vals, rows)
            res = ectx.cache.pop(("sp_res", fwd.id), None)
            if res is None:             # the forward ran without training
                res = fwd._forward(*shards, comm)[1]
            grads = fwd._backward(shards, res, _cut(dy, rows, 2), comm)
            stacked = torch.stack([g.to(shards[0].dtype) for g in grads])
            ectx.cache[key] = list(fwd._whole(stacked, comm, inv, 3)
                                   .unbind(0))
        grads = ectx.cache[key]
        out, grads[self.which] = grads[self.which], None
        if all(g is None for g in grads):
            del ectx.cache[key]
        return out


class RingAttentionOp(_SeqParallelAttentionOp):
    """Sequence-parallel attention over [B, H, S, D]: the sequence is cut
    over the mesh's ``"sp"`` axis and K/V shards pass around the ring
    with online-softmax merging (:mod:`~hetu_tpu_torch.parallel.ring`),
    forward and backward; ``causal=True`` takes the load-balanced zigzag
    layout. Every block is K2 forward and K3 + K4 backward where the
    kernels take its shape."""

    def _rows(self, s, comm):
        if not self.causal:
            return super()._rows(s, comm)
        from ..parallel.ring import zigzag_indices
        perm, inv = zigzag_indices(s, comm.nrank)
        sl = s // comm.nrank
        rows = torch.as_tensor(perm[comm.rank * sl:(comm.rank + 1) * sl])
        return rows, torch.as_tensor(inv)

    def _forward(self, q, k, v, mask, comm):
        from ..parallel import ring
        fn = ring.zigzag_ring_attention if self.causal \
            else ring.ring_attention
        o, lse = fn(q, k, v, comm, sm_scale=self.sm_scale, mask=mask)
        return o, (o, lse)

    def _backward(self, shards, res, do, comm):
        from ..parallel import ring
        q, k, v, mask = shards
        fn = ring.zigzag_ring_attention_bwd if self.causal \
            else ring.ring_attention_bwd
        return fn(q, k, v, *res, do, comm, sm_scale=self.sm_scale,
                  mask=mask)


class UlyssesAttentionOp(_SeqParallelAttentionOp):
    """Ulysses sequence parallelism: an all-to-all swaps the cut from the
    sequence to the heads, each rank attends the whole sequence for its
    heads (K2, K3 + K4), and a second all-to-all restores the sequence
    cut (:mod:`~hetu_tpu_torch.parallel.ulysses`). Needs H % n == 0."""

    def _forward(self, q, k, v, mask, comm):
        from ..parallel.ulysses import ulysses_attention
        return ulysses_attention(q, k, v, comm, sm_scale=self.sm_scale,
                                 mask=mask, causal=self.causal)

    def _backward(self, shards, res, do, comm):
        from ..parallel.ulysses import ulysses_attention_bwd
        return ulysses_attention_bwd(res, do, comm, sm_scale=self.sm_scale,
                                     causal=self.causal)


def ring_attention_op(q, k, v, mask=None, sm_scale=1.0, causal=False,
                      ctx=None):
    """Sequence-parallel (ring) attention; see RingAttentionOp."""
    return RingAttentionOp(q, k, v, mask, sm_scale, causal=causal, ctx=ctx)


def ulysses_attention_op(q, k, v, mask=None, sm_scale=1.0, causal=False,
                         ctx=None):
    """Sequence-parallel (Ulysses all-to-all) attention; see
    UlyssesAttentionOp."""
    return UlyssesAttentionOp(q, k, v, mask, sm_scale, causal=causal,
                              ctx=ctx)
