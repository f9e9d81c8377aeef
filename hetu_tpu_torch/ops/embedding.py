"""Embedding lookup with sparse (IndexedSlices) gradients.

Counterpart of ``hetu_tpu/ops/embedding.py`` (reference parity:
gpu_ops/EmbeddingLookUp.py). The forward is a row gather; the gradient
is an :class:`~hetu_tpu_torch.ndarray.IndexedSlices` carried to the
optimizer, which updates only the rows it names (lazy Adam) without
densifying the table.
"""
from __future__ import annotations

import math

import torch

from ..graph.node import Op
from ..ndarray import IndexedSlices

__all__ = ["embedding_lookup_op", "embedding_lookup_gradient_op",
           "EmbeddingLookUp", "EmbeddingLookUpGradient", "check_id_dtype"]


def check_id_dtype(dtype, rows, what):
    """Reject id feeds whose dtype cannot address the table exactly:
    float ids lose integer exactness past 2^(mantissa + 1) and are
    refused outright; an integer dtype narrower than the row count is
    the same cliff (the reference's HT803 runtime check)."""
    if dtype.is_floating_point:
        # finfo.eps = 2^-mantissa: integers are exact up to 2^(mantissa+1)
        exact = 1 - int(math.log2(torch.finfo(dtype).eps))
        raise TypeError(
            f"{what}: ids arrived as {dtype} — float ids lose integer "
            f"exactness past 2^{exact} and are rejected (HT803); feed an "
            f"integer id array")
    if rows is not None and int(rows) - 1 > torch.iinfo(dtype).max:
        raise ValueError(
            f"{what}: id dtype {dtype} cannot address the declared "
            f"{rows}-row table (HT803); widen the id dtype")


class EmbeddingLookUp(Op):
    def __init__(self, embedding, index, ctx=None):
        super().__init__(EmbeddingLookUp, [embedding, index], ctx)
        from .variable import PlaceholderOp
        if isinstance(embedding, PlaceholderOp):
            embedding.is_embed = True

    def compute(self, input_vals, ectx):
        table, idx = input_vals
        check_id_dtype(idx.dtype, table.shape[0], "embedding lookup")
        return table[idx.long()]

    def gradient(self, output_grad):
        return [embedding_lookup_gradient_op(output_grad, self.inputs[1],
                                             self, ctx=self.raw_ctx), None]

    def infer_shape(self, input_shapes):
        emb_shape, idx_shape = input_shapes
        return tuple(idx_shape) + (emb_shape[-1],)

    def infer_range(self, input_ranges, input_shapes=None):
        # the gathered rows are a subset of the table
        return input_ranges[0]

    def deduce_states(self, input_statuses, status, deduce_order):
        """Output [*idx_dims, D]: index splits pass through the leading
        dims; a table column split (dim 1) splits the feature dim; a table
        row split (dim 0, vocab-sharded) contracts into the duplicate axis
        — realized as a masked gather of the local rows and an
        all-reduce (reference EmbeddingLookUp.py:109-131 requires
        dim-0-only table splits for the same layout).
        """
        lt, li = input_statuses
        if li is None or li.state is None:
            # index rank unknown — guessing it would shard the wrong dim
            # of the [*idx_dims, D] output; leave unconstrained
            return
        idx_state = li.state
        tbl = lt.state + (1,) * (2 - len(lt.state)) \
            if lt is not None and lt.state is not None else (1, 1)
        if not deduce_order:
            status.set_state(tuple(idx_state) + (tbl[1],))
            dup = max(lt.duplicate or 1 if lt else 1,
                      li.duplicate or 1 if li else 1) * (tbl[0] or 1)
            status.set_attr(dup, (-1,) + tuple(range(len(idx_state) + 1)))


class EmbeddingLookUpGradient(Op):
    """The lookup's adjoint as IndexedSlices (reference
    EmbeddingLookUp_Gradient:88-108)."""

    def __init__(self, vectors, index, forward_node=None, embed_shape=None,
                 ctx=None):
        super().__init__(EmbeddingLookUpGradient, [vectors, index], ctx)
        self.forward_node = forward_node
        self.embed_shape = embed_shape

    def compute(self, input_vals, ectx):
        grad, idx = input_vals
        rows = self.embed_shape[0] if self.embed_shape else None
        check_id_dtype(idx.dtype, rows, "embedding gradient scatter")
        return IndexedSlices(indices=idx.long(), values=grad,
                             dense_shape=self.embed_shape)

    def gradient(self, output_grad):
        raise NotImplementedError

    def infer_shape(self, input_shapes):
        if self.embed_shape is None:
            self.embed_shape = tuple(
                self.forward_node.inputs[0].inferred_shape)
        return tuple(self.embed_shape)


def embedding_lookup_op(embedding, index, ctx=None):
    return EmbeddingLookUp(embedding, index, ctx=ctx)


def embedding_lookup_gradient_op(vectors, index, forward_node=None,
                                 embed_shape=None, ctx=None):
    return EmbeddingLookUpGradient(vectors, index, forward_node=forward_node,
                                   embed_shape=embed_shape, ctx=ctx)
