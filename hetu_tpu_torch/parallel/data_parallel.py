"""Data parallelism across processes: the global batch split over the
ranks and made global again.

The reference's data parallelism is the global batch
(``hetu_tpu/executor.py:1208-1233``): every rank is fed the same batch,
a feed whose dim 0 divides by the rank count is split into contiguous
row shards and any other feed is replicated, and what a step fetches
and updates is what one process computes on the whole batch. JAX
partitions one program over a mesh to get there. The port runs one
process a rank and DDP's rule: each rank walks the graph on its shard,
and every gradient is averaged over the ranks by the allreduce ops the
optimizer's graph pass splices (``ops/comm.py``).

That rule equals the global batch where every reduction over the rows
is a mean over equal shards. :class:`DataParallel` checks it once per
feed shapes, before the step computes anything, from the shapes the
graph infers at the global and at the local feed shapes:

* a node whose shape differs is row-sharded on the first dim that
  differs; a fetched one is gathered on that dim;
* a node of the step's forward graph with the global shape whose inputs
  are row-sharded reduces over the rows: a mean over the sharded dim
  (``ReduceMeanOp``) is averaged over the ranks when fetched, and so is
  an affine op of such means (a sum of losses, a scaled loss);
* any other reduction over the rows raises: a sum over the rows, a
  product contracted over them, batch norm's batch statistics in a
  training step, a per-row op of a reduced value. The reference's
  partitioner makes those global, and DDP's rule would not (ROADMAP
  item 11a.1).

The forward graph is every node that does not descend from an
optimizer's seed adjoint (``OptimizerOp.grad_seed``, the ones that
``minimize`` differentiates from): the gradient ops do, and DDP's rule
holds them to the global batch through their allreduce.
"""
from __future__ import annotations

import torch

from ..ops.basic import (AddByConstOp, AddOp, MulByConstOp, MulOp,
                         OppositeOp)
from ..ops.norm import BatchNormalizationOp
from ..ops.shape import ReduceMeanOp
from ..ops.variable import PlaceholderOp

__all__ = ["DataParallel"]

_ROADMAP = "ROADMAP item 11a.1"
# ops of reduced values that stay reduced: the average over the ranks of
# their local values is their value at the global means
_AFFINE = (AddOp, AddByConstOp, MulByConstOp, OppositeOp)
PARTIAL = "mean"


class DataParallel:
    """One subgraph's data-parallel step over ``comm`` (a
    :class:`~hetu_tpu_torch.ops.comm.GroupComm` of ``nrank`` > 1
    ranks): :meth:`shard` the global feeds, :meth:`classify` the graph
    at new feed shapes, :meth:`fetch` the step's values made global."""

    def __init__(self, sub, comm):
        self.sub = sub
        self.comm = comm
        self.nrank = comm.nrank
        self.rank = comm.rank
        self.kind = {}
        backward = {op.grad_seed for op in sub.optimizer_ops}
        for node in sub.topo_order:
            if any(i in backward for i in node.inputs):
                backward.add(node)
        self.forward = [n for n in sub.topo_order if n not in backward]

    def shard(self, feed_map):
        """This rank's feeds: a tensor whose dim 0 divides by the rank
        count is cut to its contiguous row shard (a view); every other
        feed is replicated."""
        out = {}
        for node, value in feed_map.items():
            if isinstance(value, torch.Tensor) and value.dim() and \
                    value.shape[0] and value.shape[0] % self.nrank == 0:
                rows = value.shape[0] // self.nrank
                value = value[self.rank * rows:(self.rank + 1) * rows]
            out[node] = value
        return out

    def classify(self, global_feed, local_feed):
        """Infer shapes at the global and at the local feeds (leaving the
        local ones on the nodes, as the step computes them) and classify
        every node: ``("rows", dim)``, :data:`PARTIAL` or None
        (replicated, or a gradient). Raises ``NotImplementedError`` for
        a graph whose rows are reduced in another way than a mean."""
        sub = self.sub
        sub._infer_shapes(global_feed)
        whole = {n: tuple(n.inferred_shape) for n in sub.topo_order}
        sub._infer_shapes(local_feed)
        forward = set(self.forward)
        kind = {}
        for node in sub.topo_order:
            g, local = whole[node], tuple(node.inferred_shape)
            ins = [kind.get(i) for i in node.inputs]
            rows = [k for k in ins if isinstance(k, tuple)]
            if g != local:
                dim = next(i for i, (a, b) in enumerate(zip(g, local))
                           if a != b)
                kind[node] = ("rows", dim)
                if node in forward and PARTIAL in ins:
                    self._refuse(node, "reads a value reduced over the "
                                       "rows in a per-row op")
                if node in forward and sub.training and \
                        isinstance(node, BatchNormalizationOp):
                    self._refuse(node, "normalizes by the batch's "
                                       "statistics; synced batch norm")
                continue
            if node in local_feed or isinstance(node, PlaceholderOp) or \
                    node not in forward or not (rows or PARTIAL in ins):
                kind[node] = None
                continue
            if isinstance(node, ReduceMeanOp) and rows and \
                    PARTIAL not in ins and self._mean_over(node, rows[0][1]):
                kind[node] = PARTIAL
            elif not rows and (isinstance(node, _AFFINE) or (
                    isinstance(node, MulOp) and ins.count(PARTIAL) == 1)):
                kind[node] = PARTIAL
            else:
                self._refuse(node, "reduces over the rows by another "
                                   "reduction than a mean")
        self.kind = kind

    @staticmethod
    def _mean_over(node, dim):
        ndim = len(node.inputs[0].inferred_shape)
        return dim in {a % ndim for a in node.axes}

    def _refuse(self, node, why):
        raise NotImplementedError(
            f"data parallel over {self.nrank} ranks: {node.name} {why}. "
            f"Each rank computes its shard of the global batch and the "
            f"gradients are averaged (DDP's rule), which is the global "
            f"batch only where every reduction over the rows is a mean; "
            f"anything else is {_ROADMAP}")

    def fetch(self, nodes, values):
        """The step's fetched values made global: row-sharded values
        gathered on their dim, means averaged over the ranks (in f32);
        the others, replicated or already reduced, as they are."""
        out = []
        for node, value in zip(nodes, values):
            k = self.kind.get(node)
            if value is None or not isinstance(value, torch.Tensor) \
                    or k is None:
                out.append(value)
            elif k == PARTIAL:
                out.append(self.comm.mean(value.float(), kind="fetch")
                           .to(value.dtype))
            else:
                dim = k[1]
                gathered = self.comm.gather_rows(
                    value.movedim(dim, 0).contiguous(), equal=True)
                out.append(gathered.movedim(0, dim))
        return out
