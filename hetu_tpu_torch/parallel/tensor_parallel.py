"""Tensor parallelism across processes: the planner's partition specs
realized on shards.

The JAX package annotates its graph with partition specs
(:mod:`.planner`) and leaves their realization to XLA's SPMD
partitioner. PyTorch has none the port can lean on, so this module is
that realization, as the original Hetu's split/concat/add and
send/recv were (reference context.py:352-512), over the ranks of the
session's mesh (:class:`~.mesh.Mesh`: one process a rank, a process
group an axis) and its :class:`~hetu_tpu_torch.ops.comm.GroupComm`
collectives.

**Layout.** A node's layout is, for each of its dims, the model axes
the dim is split over (empty for an unsplit dim): its spec made to fit
its shape (:meth:`Layouts.fit`). A rank holds the block at its mesh
coordinates, numbered row-major over the axes a dim binds — the rule of
``jax.sharding.NamedSharding``, so rank r holds exactly what the JAX
package's device r holds. A node without a spec, or whose spec does not
fit its shape, is replicated: every rank of a tensor-parallel group holds
it whole.

**Local rules** compute an op on the shards where they give its output
exactly (:class:`TensorParallel`):

* matmul and batch-matmul: row, column, k and grid splits; the partial
  products of a k-split are all-reduced at once over the contracted
  axes' groups (the replicated-with-duplicate meaning of its status);
* elementwise ops whose inputs have the output's shape;
* a lookup into a row-split table: a masked gather of the local rows,
  then an all-reduce;
* convolution over batch, out-channel and in-channel splits;
* transpose, and a reshape that leaves each split dim whole (or cuts
  only dim 0 into equal row blocks).

**Every other op** with a distributed input or output gathers its inputs,
computes as one process would and keeps its own shard of the result:
exact by construction, and counted by op type
(:attr:`TensorParallel.moves`). ``dispatch`` and its gradient move their
value to their layout: a local slice costs no communication, a gather is
an all-gather over the split axes. The optimizer takes each gradient in
its parameter's layout (a sparse gradient keeps the rows of the local
shard, re-based to it), so parameters and their slots live as shards.

Every rank of the job walks one topological order and takes every
decision from the plan and the shapes, never from its data, so every
rank issues the same collectives in the same order. Random ops (dropout)
take the gather rule: each rank draws the whole mask from the same
generator, so replicated regions stay bit-identical across the ranks of
a tensor-parallel group.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ndarray import IndexedSlices
from ..ops import activations as _act
from ..ops import basic as _basic
from ..ops import shape as _shape
from ..ops.comm import (AllReduceCommunicateOp, DataD2HOp, DataH2DOp,
                        DispatchGradientOp, DispatchOp)
from ..ops.conv import Conv2dOp
from ..ops.embedding import EmbeddingLookUp, check_id_dtype
from ..ops.linalg import BatchMatMulOp, MatMulOp
from ..optimizer import OptimizerOp

__all__ = ["Layouts", "TensorParallel"]

# ops whose output element i is a function of their inputs' elements i
# alone (given inputs of the output's shape)
_ELEMENTWISE = (
    _basic.AddOp, _basic.AddByConstOp, _basic.MulOp, _basic.MulByConstOp,
    _basic.OppositeOp, _basic.DivOp, _basic.DivConstOp,
    _basic.DivHandleZeroOp, _basic._UnaryOp, _basic.PowerOp, _basic.CastOp,
    _act.ReluOp, _act.ReluGradientOp, _act.LeakyReluOp,
    _act.LeakyReluGradientOp, _act.SignOp, _act.SigmoidOp, _act.TanhOp,
    _act.GeluOp, _act.GeluGradientOp, _shape.OnesLikeOp, _shape.ZerosLikeOp,
    DataH2DOp, DataD2HOp)
_RESHAPES = (_shape.ArrayReshapeOp, _shape.ArrayReshapeGradientOp,
             _shape.SqueezeOp, _shape.UnsqueezeOp, _shape.FlattenOp)


def _norm(layout):
    """A layout with no split dim is replicated: None."""
    if layout is None or not any(layout):
        return None
    return tuple(tuple(axes) for axes in layout)


def _dims(layout, ndim):
    return tuple(layout) if layout is not None else ((),) * ndim


def _axes_of(layout):
    return {a for axes in (layout or ()) for a in axes}


class Layouts:
    """The layout algebra of one rank: its coordinate along each model
    axis of ``mesh`` and the collectives of each axis's group."""

    def __init__(self, mesh, model_axes):
        self.sizes = dict(model_axes)
        self.coord = {a: mesh.coord(a) for a in self.sizes}
        self.comms = {a: mesh.comm(a) for a in self.sizes}

    def fit(self, spec, shape):
        """The layout of a node of ``shape`` with partition ``spec``, or
        None (replicated) where there is none or it does not fit: more
        entries than dims, an axis not in the mesh, or a dim its axes'
        sizes do not divide. A spec shorter than the shape pads with
        unsplit dims."""
        if not spec or shape is None or len(spec) > len(shape):
            return None
        out = []
        for d, entry in enumerate(tuple(spec)
                                  + (None,) * (len(shape) - len(spec))):
            axes = () if entry is None else \
                (entry,) if isinstance(entry, str) else tuple(entry)
            if any(a not in self.sizes for a in axes) or \
                    shape[d] % self.parts(axes):
                return None
            out.append(axes)
        return _norm(out)

    def parts(self, axes):
        return int(np.prod([self.sizes[a] for a in axes])) if axes else 1

    def index(self, axes):
        """This rank's block along a dim split over ``axes``: row-major
        over their coordinates."""
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.coord[a]
        return idx

    def local(self, value, layout):
        """This rank's block of a whole ``value`` (a view)."""
        for d, axes in enumerate(layout or ()):
            if axes:
                n = value.shape[d] // self.parts(axes)
                value = value.narrow(d, self.index(axes) * n, n)
        return value

    def gather_dim(self, value, dim, axes, kind="gather"):
        """All-gather dim ``dim`` split over ``axes``: the minor axis
        first, so the blocks concatenate in row-major order."""
        for a in reversed(axes):
            moved = value.movedim(dim, 0).contiguous()
            value = self.comms[a].gather_rows(moved, kind=kind,
                                              equal=True).movedim(0, dim)
        return value

    def all_reduce(self, value, axes):
        """The sum of every rank's partial ``value`` over ``axes`` (in
        place on a fresh tensor)."""
        value = value.contiguous()
        for a in axes:
            self.comms[a].all_reduce(value, kind="reduce")
        return value

    def redistribute(self, value, src, dst, kind="gather"):
        """``value``, held in layout ``src``, in layout ``dst``: the dims
        whose split changes are all-gathered, then the ones ``dst``
        splits are sliced locally. Returns (value, moved) where moved is
        None, "slice" or "gather"."""
        if _norm(src) == _norm(dst):
            return value, None
        nd = value.dim()
        cur, dst = list(_dims(src, nd)), _dims(dst, nd)
        moved = "slice"
        for d in range(nd):
            if cur[d] and cur[d] != dst[d]:
                value = self.gather_dim(value, d, cur[d], kind)
                cur[d] = ()
                moved = "gather"
        for d in range(nd):
            if dst[d] and cur[d] != dst[d]:
                n = value.shape[d] // self.parts(dst[d])
                value = value.narrow(d, self.index(dst[d]) * n, n)
        return value, moved

    def local_slices(self, grad, layout):
        """A sparse gradient of a table in ``layout``: the rows of the
        local shard, re-based to it (and its columns, where split)."""
        if layout is None:
            return grad
        rows_ax, cols_ax = (tuple(layout) + ((),))[:2]
        flat, vals = grad.get_flat_indices(), grad.get_dense_rows()
        shape = list(grad.dense_shape)
        if rows_ax:
            rows = shape[0] // self.parts(rows_ax)
            lo = self.index(rows_ax) * rows
            keep = (flat >= lo) & (flat < lo + rows)
            flat, vals, shape[0] = flat[keep] - lo, vals[keep], rows
        if cols_ax:
            cols = shape[1] // self.parts(cols_ax)
            vals = vals.narrow(1, self.index(cols_ax) * cols, cols)
            shape[1] = cols
        return IndexedSlices(flat, vals, tuple(shape))


def _reshape_layout(in_shape, out_shape, layout, parts):
    """The output layout of a reshape of an input in ``layout``, or None
    where its shards are no blocks of the output: each split dim must
    come through whole (the same size after the same leading product),
    or be the only split dim, dim 0, cut into row blocks that the
    output's dim 0 also divides (``parts(axes)`` is the split count)."""
    out = [()] * len(out_shape)
    split = [d for d, axes in enumerate(layout) if axes]
    for d in split:
        pre = int(np.prod(in_shape[:d]))
        e = next((e for e in range(len(out_shape))
                  if int(np.prod(out_shape[:e])) == pre
                  and out_shape[e] == in_shape[d]), None)
        if e is None and split == [0] and out_shape and \
                out_shape[0] % parts(layout[0]) == 0:
            e = 0
        if e is None:
            return None
        out[e] = layout[d]
    return tuple(out)


class TensorParallel:
    """One subgraph's tensor-parallel walk: :meth:`classify` lays every
    node out at new feed shapes, :meth:`shard_feeds` cuts the feeds that
    a dispatch splits, :meth:`compute` runs an op on its shards and
    :meth:`fetch` makes fetched values whole.

    ``moves`` counts, by op type, the values moved between layouts:
    ``"gather"`` where a collective ran, ``"slice"`` where a local cut
    sufficed; ``gather_rule`` counts the ops computed whole by the
    gather rule."""

    def __init__(self, sub, config):
        self.sub = sub
        self.config = config
        self.lay = config.tp_layouts
        self.layout = {}
        self.reset_stats()

    def reset_stats(self):
        self.moves = {"gather": {}, "slice": {}}
        self.gather_rule = {}

    def classify(self):
        """Every node's layout, from its spec and its inferred shape: a
        dispatch gradient takes its forward input's, an optimizer none."""
        spec_for = self.config.spec_for
        for node in self.sub.topo_order:
            src = node.forward_input \
                if isinstance(node, DispatchGradientOp) else node
            self.layout[node] = None if isinstance(node, OptimizerOp) \
                else self.lay.fit(spec_for(src),
                                  getattr(node, "inferred_shape", None))

    def shard_feeds(self, feed_map):
        return {node: self.lay.local(value, self.layout.get(node))
                if isinstance(value, torch.Tensor) else value
                for node, value in feed_map.items()}

    def _move(self, node, value, src, dst, kind="gather"):
        value, moved = self.lay.redistribute(value, src, dst, kind)
        if moved is not None:
            counts = self.moves[moved]
            counts[node.op_type] = counts.get(node.op_type, 0) + 1
        return value

    def compute(self, node, vals, ectx):
        """``node``'s value on this rank, in its layout."""
        ins = [self.layout.get(i) for i in node.inputs]
        out = self.layout.get(node)
        if out is None and not any(ins) and \
                not isinstance(node, OptimizerOp):
            return node.compute(vals, ectx)
        value, have = self._rule(node)(node, vals, ins, out, ectx)
        if not isinstance(value, torch.Tensor):
            self.layout[node] = None
            return value
        return self._move(node, value, have, out)

    def _rule(self, node):
        if isinstance(node, (DispatchOp, DispatchGradientOp)):
            return self._identity
        if isinstance(node, OptimizerOp):
            return self._optimizer
        if isinstance(node, AllReduceCommunicateOp):
            return self._unary
        if isinstance(node, _ELEMENTWISE):
            return self._elementwise
        if isinstance(node, MatMulOp):
            return self._matmul
        if isinstance(node, BatchMatMulOp):
            return self._batch_matmul
        if isinstance(node, EmbeddingLookUp):
            return self._lookup
        if isinstance(node, Conv2dOp):
            return self._conv
        if isinstance(node, _shape.TransposeOp):
            return self._transpose
        if isinstance(node, _RESHAPES):
            return self._reshape
        return self._gather_rule

    # -- rules: each returns (local value, the layout it is in) -----------
    def _identity(self, node, vals, ins, out, ectx):
        return vals[0], ins[0]

    def _unary(self, node, vals, ins, out, ectx):
        return node.compute(vals, ectx), ins[0]

    def _gather_rule(self, node, vals, ins, out, ectx):
        whole = [self._move(node, v, l, None)
                 if l is not None and isinstance(v, torch.Tensor) else v
                 for v, l in zip(vals, ins)]
        self.gather_rule[node.op_type] = \
            self.gather_rule.get(node.op_type, 0) + 1
        return node.compute(whole, ectx), None

    def _elementwise(self, node, vals, ins, out, ectx):
        shape = tuple(node.inferred_shape)
        if not all(isinstance(v, torch.Tensor) for v in vals) or any(
                tuple(i.inferred_shape) != shape for i in node.inputs):
            return self._gather_rule(node, vals, ins, out, ectx)
        if all(_norm(l) == _norm(ins[0]) for l in ins):
            return node.compute(vals, ectx), ins[0]
        vals = [self._move(node, v, l, out) for v, l in zip(vals, ins)]
        return node.compute(vals, ectx), out

    def _contract(self, node, vals, ectx, la, lb, batch, trans):
        """The (batch-)matmul rule over layouts ``la`` (A) and ``lb`` (B),
        each given in storage order with ``batch`` leading batch dims:
        batch splits pass through (A's where both split), then m from
        A, n from B, k from A else B, every axis used once; the inputs
        move to those layouts (a replicated side is sliced locally), the
        local product is computed and a k-split's partial sums are
        all-reduced."""
        tA, tB = trans
        bt = tuple(x or y for x, y in zip(la[:batch], lb[:batch]))
        used = _axes_of(bt)
        if len(used) != sum(len(x) for x in bt):
            bt, used = ((),) * batch, set()
        mA, kA = (la[-1], la[-2]) if tA else (la[-2], la[-1])
        kB, nB = (lb[-1], lb[-2]) if tB else (lb[-2], lb[-1])
        K = kA or kB
        if set(K) & used:
            K = ()
        used |= set(K)
        M = () if set(mA) & used else mA
        used |= set(M)
        N = () if set(nB) & used else nB
        want_a = bt + ((K, M) if tA else (M, K))
        want_b = bt + ((N, K) if tB else (K, N))
        a = self._move(node, vals[0], la, want_a)
        b = self._move(node, vals[1], lb, want_b)
        value = node.compute([a, b], ectx)
        if K:
            value = self.lay.all_reduce(value, K)
        return value, _norm(bt + (M, N))

    def _matmul(self, node, vals, ins, out, ectx):
        return self._contract(
            node, vals, ectx, _dims(ins[0], 2), _dims(ins[1], 2), 0,
            (node.matmul_attr_trans_A, node.matmul_attr_trans_B))

    def _batch_matmul(self, node, vals, ins, out, ectx):
        nd = len(node.inferred_shape)
        return self._contract(
            node, vals, ectx, _dims(ins[0], nd), _dims(ins[1], nd), nd - 2,
            (node.trans_A, node.trans_B))

    def _lookup(self, node, vals, ins, out, ectx):
        table, ids = vals
        rows_ax, cols_ax = _dims(ins[0], 2)
        id_l = _dims(ins[1], ids.dim())
        if set(rows_ax) & (set(cols_ax) | _axes_of(id_l)) or \
                set(cols_ax) & _axes_of(id_l):
            return self._gather_rule(node, vals, ins, out, ectx)
        have = _norm(id_l + (cols_ax,))
        if not rows_ax:
            return node.compute(vals, ectx), have
        total = node.inputs[0].inferred_shape[0]
        check_id_dtype(ids.dtype, total, "embedding lookup")
        ids = ids.long()
        ids = torch.where(ids < 0, ids + total, ids)   # python's indexing
        rows = table.shape[0]
        local = ids - self.lay.index(rows_ax) * rows
        mine = (local >= 0) & (local < rows)
        picked = table[local.clamp(0, rows - 1)]
        value = torch.where(mine.unsqueeze(-1), picked,
                            torch.zeros((), dtype=picked.dtype,
                                        device=picked.device))
        return self.lay.all_reduce(value, rows_ax), have

    def _conv(self, node, vals, ins, out, ectx):
        ld, lf = _dims(ins[0], 4), _dims(ins[1], 4)
        C = ld[1] or lf[1]
        N = () if set(ld[0]) & set(C) else ld[0]
        O = () if set(lf[0]) & (set(C) | set(N)) else lf[0]
        data = self._move(node, vals[0], ld, (N, C, (), ()))
        filt = self._move(node, vals[1], lf, (O, C, (), ()))
        value = node.compute([data, filt], ectx)
        if C:
            value = self.lay.all_reduce(value, C)
        return value, _norm((N, O, (), ()))

    def _transpose(self, node, vals, ins, out, ectx):
        value = node.compute(vals, ectx)
        perm = node._perm(value.dim())
        src = _dims(ins[0], value.dim())
        return value, _norm(tuple(src[p] for p in perm))

    def _reshape(self, node, vals, ins, out, ectx):
        out_shape = tuple(node.inferred_shape)
        have = _reshape_layout(tuple(node.inputs[0].inferred_shape),
                               out_shape, _dims(ins[0], vals[0].dim()),
                               self.lay.parts)
        if have is None:
            return self._gather_rule(node, vals, ins, out, ectx)
        local = [s // self.lay.parts(axes)
                 for s, axes in zip(out_shape, have)]
        return vals[0].reshape(local), _norm(have)

    def _optimizer(self, node, vals, ins, out, ectx):
        grads = []
        for param, g, lg in zip(node.optimizer.params, vals, ins):
            lp = self.layout.get(param)
            if isinstance(g, IndexedSlices):
                g = self.lay.local_slices(g, lp)
            elif g is not None:
                g = self._move(node, g, lg, lp)
            grads.append(g)
        return node.compute(grads, ectx), None

    def fetch(self, nodes, values):
        """Fetched values made whole (all-gathered where split)."""
        out = []
        for node, value in zip(nodes, values):
            layout = self.layout.get(node)
            if layout is not None and isinstance(value, torch.Tensor):
                value = self._move(node, value, layout, None, kind="fetch")
            out.append(value)
        return out
