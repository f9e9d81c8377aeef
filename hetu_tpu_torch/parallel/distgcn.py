"""DistGCN-1.5D: the full-graph GCN SpMM over a ("gr", "gc") rank mesh.

Counterpart of ``hetu_tpu/parallel/distgcn.py`` (reference parity:
gpu_ops/DistGCN_15d.py:19-156). The graph's rows shard over ``gr``
ranks, replicated ``gc`` times; rank (r, c) multiplies the column
blocks b of its row block whose column ``b mod gc`` is its own, so the
SpMM's work divides by ``gc``. The blocks of H travel around the ``gr``
ring: at hop k rank r holds block ``(r + k) mod gr``, each hop sending
to rank ``r - 1`` (the reference's ``ppermute`` over ``[(i, (i - 1) %
gr)]``), and the rank adds its stage-k block product. A sum over ``gc``
plays the reference's row-group all-reduce, and a gather over ``gr``
makes ``z`` whole on every rank, the port's convention for a sharded op
inside a replicated graph.

A block product is the CSR product of :mod:`~hetu_tpu_torch.ops.sparse`:
gather the rows an entry names, scale them, and sum each row's entries
in their order with a segment sum, so a rank's sums do not depend on
the device's scheduling. :func:`dist_gcn_spmm_t` is the transpose (the
backward): each rank adds ``A_blkᵀ · dz_r`` for the block it multiplied
into a partial sum that travels around the ring with its block, as the
dK/dV sums do in :mod:`.ring`, and lands on the block's owner; then the
same sum over ``gc`` and gather over ``gr``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DistCSR15d", "partition_csr_15d", "dist_gcn_spmm",
           "dist_gcn_spmm_t"]


class DistCSR15d:
    """Padded per-(rank, ring-step) COO stages of the adjacency.

    data:  [gr, gc, gr, nnz_max] float32
    rows:  [gr, gc, gr, nnz_max] int32   (row within the rank's shard)
    cols:  [gr, gc, gr, nnz_max] int32   (row within the incoming block)
    ``n_per`` rows per shard (graph padded to gr * n_per). A feed of
    this type puts only rank (r, c)'s stages on its device
    (:meth:`local`); its shape is ``(n_nodes, n_nodes)``."""

    dtype = torch.float32

    def __init__(self, data, rows, cols, n_per, n_nodes, gr, gc):
        self.data = data
        self.rows = rows
        self.cols = cols
        self.n_per = int(n_per)
        self.n_nodes = int(n_nodes)
        self.gr = int(gr)
        self.gc = int(gc)
        self._local = {}

    @property
    def shape(self):
        return (self.n_nodes, self.n_nodes)

    def local(self, r, c, device):
        """Rank (r, c)'s stages on ``device``, made once a device (the
        thread ranks of one process share the feed)."""
        key = (int(r), int(c), str(torch.device(device)))
        held = self._local.get(key)
        if held is None:
            held = LocalStages(self.data[r, c], self.rows[r, c],
                               self.cols[r, c], self.n_per, self.n_nodes,
                               self.gr, self.gc, device)
            self._local[key] = held
        return held


def _sorted_csr(data, seg, other, nseg):
    """Entries stably sorted by ``seg`` (their order kept within a
    segment) as (data, other, offsets) of a CSR over ``nseg`` segments."""
    order = np.argsort(seg, kind="stable")
    offsets = np.zeros(nseg + 1, np.int64)
    np.cumsum(np.bincount(seg, minlength=nseg), out=offsets[1:])
    return data[order], other[order].astype(np.int64), offsets


class LocalStages:
    """One rank's ``gr`` stages as CSRs on its device: by row for the
    forward (``A_blk · h``) and by column for the transpose (``A_blkᵀ ·
    dz``). The zero padding stays: a padded entry adds ``0 · h[0]`` to
    row 0, which leaves a finite sum as it was."""

    def __init__(self, data, rows, cols, n_per, n_nodes, gr, gc, device):
        self.n_per, self.n_nodes = int(n_per), int(n_nodes)
        self.gr, self.gc = int(gr), int(gc)
        self.shape = (self.n_nodes, self.n_nodes)
        self.dtype = torch.float32
        self.fwd, self.bwd = [], []
        dev = torch.device(device)
        for k in range(gr):
            d, ri, ci = (np.asarray(a[k]) for a in (data, rows, cols))
            for out, seg, other in ((self.fwd, ri, ci), (self.bwd, ci, ri)):
                vals, idx, offsets = _sorted_csr(d, seg, other, self.n_per)
                out.append(tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 .to(dev) for a in (vals, idx, offsets)))

    @property
    def device(self):
        return self.fwd[0][0].device


def partition_csr_15d(adj, gr, gc):
    """scipy CSR -> DistCSR15d for a (gr, gc) mesh.

    Rank (r, c) at ring step k multiplies A[rows_r, block_b] where
    b = (r + k) mod gr, but only when b mod gc == c (its column
    assignment) — other steps carry zero padding."""
    import scipy.sparse as sp

    n = adj.shape[0]
    n_per = -(-n // gr)
    padded = n_per * gr
    if padded != n:
        adj = sp.csr_matrix((adj.data, adj.indices, adj.indptr),
                            shape=(n, n))
        adj.resize((padded, padded))

    stages = {}
    nnz_max = 1
    for r in range(gr):
        rows_lo, rows_hi = r * n_per, (r + 1) * n_per
        a_r = adj[rows_lo:rows_hi]
        for c in range(gc):
            for k in range(gr):
                b = (r + k) % gr
                if b % gc != c:
                    continue
                blk = a_r[:, b * n_per:(b + 1) * n_per].tocoo()
                stages[(r, c, k)] = (
                    blk.data.astype(np.float32),
                    blk.row.astype(np.int32),
                    blk.col.astype(np.int32))
                nnz_max = max(nnz_max, len(blk.data))

    data = np.zeros((gr, gc, gr, nnz_max), np.float32)
    rows = np.zeros((gr, gc, gr, nnz_max), np.int32)
    cols = np.zeros((gr, gc, gr, nnz_max), np.int32)
    for (r, c, k), (d, ri, ci) in stages.items():
        data[r, c, k, :len(d)] = d
        rows[r, c, k, :len(d)] = ri
        cols[r, c, k, :len(d)] = ci
    return DistCSR15d(data, rows, cols, n_per, n, gr, gc)


def _stages(adj, mesh, device):
    if isinstance(adj, LocalStages):
        return adj
    return adj.local(mesh.coord("gr"), mesh.coord("gc"), device)


def _product(stage, dense):
    """One stage's CSR (vals, idx, offsets) times ``dense``."""
    vals, idx, offsets = stage
    gathered = dense.index_select(0, idx) * vals.to(dense.dtype)[:, None]
    return torch.segment_reduce(gathered, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def _own_rows(x, adj, r):
    """Rows ``[r·n_per, (r+1)·n_per)`` of ``x`` padded to ``gr·n_per``."""
    lo = r * adj.n_per
    part = x[lo:lo + adj.n_per]
    if part.shape[0] < adj.n_per:
        part = torch.nn.functional.pad(
            part, (0, 0, 0, adj.n_per - part.shape[0]))
    return part


def _combine(z, adj, mesh):
    """The row block's sum over ``gc``, then every block gathered over
    ``gr``: ``z`` whole, cut back to the graph's rows."""
    if mesh.shape["gc"] > 1:
        z = mesh.comm("gc").all_reduce(z, kind="reduce")
    z = mesh.comm("gr").all_gather(z, 0, kind="gather")
    return z[:adj.n_nodes]


def dist_gcn_spmm(adj, h, mesh):
    """z = A @ h over the ("gr", "gc") mesh, on this rank: ``adj`` a
    :class:`DistCSR15d` (or this rank's :class:`LocalStages`), ``h`` and
    ``z`` ``[N, F]`` whole on every rank."""
    adj = _stages(adj, mesh, h.device)
    gr, r = adj.gr, mesh.coord("gr")
    ring = mesh.comm("gr")
    h_cur = _own_rows(h, adj, r)
    z = torch.zeros_like(h_cur)
    # gr-1 hops in the loop; the last block accumulates after it
    for k in range(gr - 1):
        z = z + _product(adj.fwd[k], h_cur)
        h_cur = ring.ring_shift([h_cur], step=-1)[0]
    z = z + _product(adj.fwd[gr - 1], h_cur)
    return _combine(z, adj, mesh)


def dist_gcn_spmm_t(adj, dz, mesh):
    """Aᵀ @ dz over the mesh, the transpose of :func:`dist_gcn_spmm`:
    ``dz`` ``[N, F]`` whole on every rank (the gradient of a replicated
    graph), the result whole too. At step j rank r adds ``A_{r,b}ᵀ ·
    dz_r`` for b = (r + j + 1) mod gr into the partial sum of block b,
    which then moves to rank r - 1 with the block's next stage: after
    gr - 1 hops rank r holds block r's."""
    adj = _stages(adj, mesh, dz.device)
    gr, r = adj.gr, mesh.coord("gr")
    ring = mesh.comm("gr")
    dz_r = _own_rows(dz, adj, r)
    acc = torch.zeros_like(dz_r)
    for j in range(gr):
        acc = acc + _product(adj.bwd[(j + 1) % gr], dz_r)
        if j < gr - 1:
            acc = ring.ring_shift([acc], step=-1)[0]
    return _combine(acc, adj, mesh)
