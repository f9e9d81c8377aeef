"""Full-batch GCN / GraphSAGE training of the port: the counterpart of
``examples/gnn/train_hetu_gcn.py`` (reference parity:
examples/gnn/train_hetu_gcn.py), with its flags, graph and per-epoch
loss / accuracy / time, plus ``--device``. The graph is an OGB-style
npz under ``HETU_DATA_DIR`` (default ``datasets/graph.npz``) where one
exists, else the reference's synthetic arxiv-scale graph from
``RandomState(0)``; the symmetric-normalized adjacency and the features
are put on the device once. It runs on the GPU unless ``--device cpu``
is given.

    python -m hetu_tpu_torch.examples.gcn_main --model gcn --timing
    python -m hetu_tpu_torch.examples.gcn_main --nodes 2000 --device cpu
"""
import argparse
import os
import time

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.models import gcn, graphsage
from hetu_tpu_torch.ndarray import CSRValue


def load_graph(args):
    """(normalized adjacency as a scipy CSR, features, one-hot labels,
    train mask), as the reference example makes them."""
    import scipy.sparse as sp
    ddir = os.environ.get("HETU_DATA_DIR", "datasets")
    path = os.path.join(ddir, "graph.npz")
    if os.path.exists(path):
        z = np.load(path)
        adj = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                            shape=tuple(z["shape"]))
        feat, y = z["features"], z["labels"]
        mask = z["train_mask"] if "train_mask" in z.files \
            else np.ones(adj.shape[0], np.float32)
        ncls = int(y.max()) + 1
    else:
        rng = np.random.RandomState(0)
        n, deg, ncls = args.nodes, 7, args.classes
        rows = np.repeat(np.arange(n), deg)
        cols = rng.randint(0, n, n * deg)
        adj = sp.coo_matrix(
            (np.ones(n * deg, np.float32), (rows, cols)),
            shape=(n, n)).tocsr()
        feat = rng.randn(n, args.features).astype(np.float32)
        y = rng.randint(0, ncls, n)
        # the planted signal: a label shifts its block of features
        block = args.features // ncls
        for c in range(ncls):
            feat[y == c, c * block:(c + 1) * block] += 0.3
        mask = np.ones(n, np.float32)
    adj = adj + sp.eye(adj.shape[0], format="csr", dtype=np.float32)
    d = np.asarray(adj.sum(1)).ravel()
    dinv = sp.diags(1.0 / np.sqrt(d))
    norm = (dinv @ adj @ dinv).tocsr()
    onehot = np.eye(ncls, dtype=np.float32)[y]
    return norm, feat.astype(np.float32), onehot, mask.astype(np.float32)


def run(args):
    """Train ``args.num_epochs`` full-graph steps: the last epoch's
    ``loss``, ``acc`` and ``epoch_time``, and every epoch's in
    ``losses``, ``accs`` and ``epoch_times``."""
    device = ht.resolve_device(args.device)
    norm, feat_np, y_np, mask_np = load_graph(args)
    n, fdim = feat_np.shape
    ncls = y_np.shape[1]

    feat = ht.Variable("feat", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    mask_ = ht.Variable("mask_", trainable=False)
    norm_adj = ht.Variable("norm_adj", trainable=False)
    builder = gcn if args.model == "gcn" else graphsage
    loss, y, train_op = builder(feat, y_, mask_, norm_adj, fdim,
                                args.hidden, ncls, lr=args.learning_rate)
    executor = ht.Executor([ht.reduce_mean_op(loss, [0]), y, train_op],
                           device=device)

    sp_adj = ht.ND_Sparse_Array(
        norm.data.astype(np.float32), norm.indptr.astype(np.int32),
        norm.indices.astype(np.int32), nrow=n, ncol=n)
    # the graph and the features go to the device once
    feeds = {feat: torch.from_numpy(feat_np).to(device),
             y_: torch.from_numpy(y_np).to(device),
             mask_: torch.from_numpy(mask_np).to(device),
             norm_adj: CSRValue.from_sparse_array(sp_adj, device)}
    labels = np.argmax(y_np, 1)

    results = {"losses": [], "accs": [], "epoch_times": []}
    for ep in range(args.num_epochs):
        t0 = time.perf_counter()
        loss_val, y_pred, _ = executor.run(feed_dict=feeds,
                                           convert_to_numpy_ret_vals=True)
        dt = time.perf_counter() - t0
        acc = float(np.mean(np.argmax(y_pred, 1) == labels))
        loss_mean = float(np.mean(loss_val))
        msg = f"epoch {ep}: loss {loss_mean:.4f} acc {acc:.4f}"
        if args.timing:
            msg += f" | {dt * 1000:.1f} ms/epoch"
        print(msg, flush=True)
        results["losses"].append(loss_mean)
        results["accs"].append(acc)
        results["epoch_times"].append(dt)
        results.update(loss=loss_mean, acc=acc, epoch_time=dt)
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="gcn",
                        choices=["gcn", "graphsage"])
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--nodes", type=int, default=169_343)
    parser.add_argument("--features", type=int, default=128)
    parser.add_argument("--classes", type=int, default=40)
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
