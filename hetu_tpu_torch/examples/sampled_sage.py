"""Minibatch GraphSAGE over sampled subgraphs, on the port: the
counterpart of ``examples/gnn/train_sampled_sage.py`` (reference
parity: examples/gnn/run_single.py, whose GraphMix graph servers sample
a subgraph per batch and double-buffer them through
``GNNDataLoaderOp.step``; here an in-process numpy neighbour sampler,
the reference example's, plays their part, with the same draws).

Every subgraph is padded to a fixed node and entry budget (empty rows,
zero-valued column-0 entries in the last row), so every step has the
same shapes: the executor infers them once. It runs on the GPU unless
``--device cpu`` is given.

    python -m hetu_tpu_torch.examples.sampled_sage --timing
    python -m hetu_tpu_torch.examples.sampled_sage --device cpu
"""
import argparse
import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch.dataloader import GNNDataLoaderOp
from hetu_tpu_torch.models import graphsage


def make_graph(n=4000, deg=8, fdim=64, ncls=7, seed=0):
    """A random graph with a planted signal (the recipe of gcn_main):
    (adjacency as a scipy CSR, features, one-hot labels)."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.randint(0, n, n * deg)
    adj = sp.coo_matrix((np.ones(n * deg, np.float32), (rows, cols)),
                        shape=(n, n)).tocsr()
    y = rng.randint(0, ncls, n)
    feat = rng.randn(n, fdim).astype(np.float32)
    block = fdim // ncls
    for c in range(ncls):
        feat[y == c, c * block:(c + 1) * block] += 0.4
    return adj, feat, np.eye(ncls, dtype=np.float32)[y]


class SubgraphSampler:
    """A batch of seed nodes -> their induced subgraph over up to
    ``fanout`` sampled neighbours each, at a fixed budget, with a
    degree-normalized CSR adjacency (the GraphMix server's part, in
    process)."""

    def __init__(self, adj, feat, onehot, batch_seeds, fanout=8, seed=0):
        self.adj = adj
        self.feat = feat
        self.onehot = onehot
        self.batch_seeds = batch_seeds
        self.fanout = fanout
        self.rng = np.random.RandomState(seed)
        self.n_sub = batch_seeds * (fanout + 1)
        self.nnz_budget = self.n_sub * (fanout + 2)
        self.order = self.rng.permutation(adj.shape[0])
        self.cursor = 0

    def _neighbors(self, v):
        return self.adj.indices[self.adj.indptr[v]:self.adj.indptr[v + 1]]

    def next(self):
        """The next batch's {"feat", "y", "mask", "adj"}."""
        n = self.adj.shape[0]
        if self.cursor + self.batch_seeds > n:
            self.order = self.rng.permutation(n)
            self.cursor = 0
        seeds = self.order[self.cursor:self.cursor + self.batch_seeds]
        self.cursor += self.batch_seeds

        nodes = list(seeds)
        seen = set(int(s) for s in seeds)
        for s in seeds:
            nbrs = self._neighbors(int(s))
            if len(nbrs) > self.fanout:
                nbrs = self.rng.choice(nbrs, self.fanout, replace=False)
            for v in nbrs:
                v = int(v)
                if v not in seen and len(nodes) < self.n_sub:
                    seen.add(v)
                    nodes.append(v)
        nodes = np.asarray(nodes, np.int64)
        n_real = len(nodes)
        loc = {int(g): i for i, g in enumerate(nodes)}

        rows, cols = [], []
        for i, g in enumerate(nodes):
            rows.append(i)
            cols.append(i)                      # self loop
            for v in self._neighbors(int(g)):
                j = loc.get(int(v))
                if j is not None:
                    rows.append(i)
                    cols.append(j)
        rows = np.asarray(rows)[:self.nnz_budget]
        cols = np.asarray(cols)[:self.nnz_budget]
        deg = np.bincount(rows, minlength=self.n_sub).astype(np.float32)
        vals = (1.0 / np.maximum(deg, 1.0))[rows]

        # the fixed budget: rows past n_real stay empty, and the unused
        # entries are zero-valued column-0 entries of the last row (no
        # numeric effect; that row may hold column 0 many times)
        pad = self.nnz_budget - len(rows)
        indptr = np.zeros(self.n_sub + 1, np.int32)
        counts = np.bincount(rows, minlength=self.n_sub)
        order = np.argsort(rows, kind="stable")
        data = np.concatenate([vals[order], np.zeros(pad, np.float32)])
        indices = np.concatenate([cols[order],
                                  np.zeros(pad, np.int32)]).astype(np.int32)
        counts[self.n_sub - 1] += pad
        indptr[1:] = np.cumsum(counts)

        feat = np.zeros((self.n_sub, self.feat.shape[1]), np.float32)
        feat[:n_real] = self.feat[nodes]
        y = np.zeros((self.n_sub, self.onehot.shape[1]), np.float32)
        y[:n_real] = self.onehot[nodes]
        mask = np.zeros(self.n_sub, np.float32)
        mask[:len(seeds)] = 1.0                 # the loss of the seeds only
        sp_adj = ht.ND_Sparse_Array(data, indptr, indices,
                                    nrow=self.n_sub, ncol=self.n_sub)
        return {"feat": feat, "y": y, "mask": mask, "adj": sp_adj}


def main(args):
    """Train ``args.num_epoch`` epochs of nodes // batch_seeds steps:
    the last epoch's mean ``loss``, every epoch's in ``losses`` and its
    time in ``epoch_times`` (with ``--timing`` also ``nodes_per_sec``)."""
    device = ht.resolve_device(args.device)
    adj, feat_arr, onehot = make_graph(args.nodes, fdim=args.features,
                                       ncls=args.classes)
    sampler = SubgraphSampler(adj, feat_arr, onehot, args.batch_seeds,
                              fanout=args.fanout)

    feat = GNNDataLoaderOp(lambda g: g["feat"])
    y_ = GNNDataLoaderOp(lambda g: g["y"])
    mask_ = GNNDataLoaderOp(lambda g: g["mask"])
    norm_adj = GNNDataLoaderOp(lambda g: g["adj"])
    loss, y, train_op = graphsage(
        feat, y_, mask_, norm_adj, args.features, args.hidden_size,
        args.classes, lr=args.learning_rate)
    train_loss = ht.reduce_mean_op(ht.mul_op(loss, mask_), [0])
    exe = ht.Executor([train_loss, train_op], device=device)
    sub = exe.subexecutors["default"]

    # the double buffer's first current and next graphs
    GNNDataLoaderOp.step(sampler.next())
    GNNDataLoaderOp.step(sampler.next())
    nbatches = args.nodes // args.batch_seeds
    results = {"losses": [], "epoch_times": []}
    first_key = None
    for ep in range(args.num_epoch):
        ep_st = time.time()
        ep_loss = []
        for _ in range(nbatches):
            GNNDataLoaderOp.step(sampler.next())   # stage the next batch
            out = exe.run(feed_dict={})
            ep_loss.append(float(np.mean(out[0].asnumpy())))
            first_key = first_key or sub._shapes_key
        dt = time.time() - ep_st
        msg = f"epoch {ep}: loss {np.mean(ep_loss):.4f}"
        if args.timing:
            sps = nbatches * args.batch_seeds / dt
            msg += f", {dt:.2f}s ({sps:.0f} seed nodes/sec)"
            results["nodes_per_sec"] = sps
        print(msg, flush=True)
        results["loss"] = float(np.mean(ep_loss))
        results["losses"].append(results["loss"])
        results["epoch_times"].append(dt)
    # the fixed budgets give every step the shapes of the first
    if sub._shapes_key is not first_key:
        raise AssertionError("a sampled subgraph changed the step's shapes")
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodes", type=int, default=4000)
    parser.add_argument("--features", type=int, default=64)
    parser.add_argument("--classes", type=int, default=7)
    parser.add_argument("--hidden-size", type=int, default=64)
    parser.add_argument("--batch-seeds", type=int, default=64)
    parser.add_argument("--fanout", type=int, default=8)
    parser.add_argument("--num-epoch", type=int, default=5)
    parser.add_argument("--learning-rate", type=float, default=0.5)
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
