"""CTR training entry point of the port: the counterpart of
``examples/ctr/run_hetu.py`` (reference parity: examples/ctr/run_hetu.py),
with its command line, models, data and per-epoch loss/acc/AUC, on
``hetu_tpu_torch``. The embedding table lives on the device; the PS and
Hybrid modes (``--comm-mode PS/Hybrid``) wait for the PS port and are
refused. It runs on the GPU unless ``--device cpu`` is given.

    python -m hetu_tpu_torch.examples.ctr_main --model wdl_criteo --timing
    python -m hetu_tpu_torch.examples.ctr_main --model dcn_criteo --all \
        --val --dim 100000 --nepoch 1
"""
import argparse
import os
import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch.data import _data_dir
from hetu_tpu_torch.metrics import auc
from hetu_tpu_torch.models import ctr as ctr_models

MODELS = ["wdl_criteo", "dcn_criteo", "dc_criteo", "deepfm_criteo",
          "wdl_adult"]


def load_criteo(args):
    """Criteo-format arrays from ``$HETU_DATA_DIR/criteo``, else a
    synthetic stand-in with Criteo's shape and a planted signal: 13
    normal dense features, 26 slots of ids drawn zipf(1.3) mod ``--dim``."""
    path = os.path.join(_data_dir(), "criteo")
    if os.path.exists(os.path.join(path, "train_dense_feats.npy")):
        dense = np.load(os.path.join(path, "train_dense_feats.npy"))
        sparse = np.load(os.path.join(path, "train_sparse_feats.npy"))
        labels = np.load(os.path.join(path, "train_labels.npy"))
        return (dense.astype(np.float32), sparse.astype(np.int64),
                labels.reshape(-1, 1).astype(np.float32))
    rng = np.random.RandomState(0)
    n = args.nsamples
    dense = rng.randn(n, 13).astype(np.float32)
    sparse = (rng.zipf(1.3, size=(n, 26)) - 1) % args.dim
    labels = ((dense[:, 0] + (sparse[:, 0] % 2)) > 0.9).astype(
        np.float32).reshape(-1, 1)
    return dense, sparse, labels


def worker(args):
    if args.comm_mode in ("PS", "Hybrid"):
        raise NotImplementedError(
            f"--comm-mode {args.comm_mode}: PS mode waits for the PS port; "
            f"the port keeps the table on the device (leave --comm-mode "
            f"unset)")
    model = getattr(ctr_models, args.model)
    dense, sparse, labels = load_criteo(args)
    n_train = int(len(labels) * 0.9)

    batch = args.batch_size
    dense_input = ht.dataloader_op([
        ht.Dataloader(dense[:n_train], batch, "train"),
        ht.Dataloader(dense[n_train:], batch, "validate")])
    sparse_input = ht.dataloader_op([
        ht.Dataloader(sparse[:n_train], batch, "train"),
        ht.Dataloader(sparse[n_train:], batch, "validate")])
    y_ = ht.dataloader_op([
        ht.Dataloader(labels[:n_train], batch, "train"),
        ht.Dataloader(labels[n_train:], batch, "validate")])

    if args.model == "wdl_adult":
        loss, y, y_, train_op = model(dense_input, sparse_input, y_)
    else:
        loss, y, y_, train_op = model(
            dense_input, sparse_input, y_, feature_dimension=args.dim,
            learning_rate=args.learning_rate)

    eval_nodes = {"train": [loss, y, y_, train_op]}
    if args.val:
        eval_nodes["validate"] = [loss, y, y_]
    options = {} if args.comm_mode is None else {"comm_mode": args.comm_mode}
    executor = ht.Executor(eval_nodes, device=args.device, **options)

    results = {}
    for ep in range(args.nepoch):
        ep_st = time.perf_counter()
        train_loss, train_acc, train_auc = [], [], []
        batches = executor.get_batch_num("train")
        if args.all:
            # metrics loop: one host sync per step (reference behavior)
            for _ in range(batches):
                loss_val, predict_y, y_val, _ = executor.run(
                    "train", convert_to_numpy_ret_vals=True)
                acc = np.equal(y_val, predict_y > 0.5).astype(np.float32)
                train_loss.append(float(np.mean(loss_val)))
                train_acc.append(float(np.mean(acc)))
                if len(np.unique(y_val)) > 1:
                    train_auc.append(auc(predict_y, y_val))
        else:
            # throughput loop: blocks of steps, one sync per epoch
            kblock = min(args.block_steps, batches)
            done = 0
            while done < batches:
                k = min(kblock, batches - done)
                out = executor.run_batches([{}] * k, name="train")
                done += k
            out[-1][0].asnumpy()
        ep_time = time.perf_counter() - ep_st
        sps = batches * batch / ep_time
        msg = f"epoch {ep}"
        if args.all and train_loss:
            msg += (f": loss {np.mean(train_loss):.4f} "
                    f"acc {np.mean(train_acc):.4f}")
            if train_auc:
                msg += f" auc {np.mean(train_auc):.4f}"
        if args.timing:
            msg += f" | {ep_time:.2f}s/epoch, {sps:.0f} samples/sec"
        print(msg, flush=True)
        results.update(epoch_time=ep_time, samples_per_sec=sps)
        if args.all and train_loss:
            results.update(loss=float(np.mean(train_loss)),
                           acc=float(np.mean(train_acc)))
            if train_auc:
                results.update(auc=float(np.mean(train_auc)))
        if args.val:
            val_loss, val_acc, val_auc = [], [], []
            for _ in range(executor.get_batch_num("validate")):
                loss_val, pred, y_val = executor.run(
                    "validate", convert_to_numpy_ret_vals=True)
                val_loss.append(float(np.mean(loss_val)))
                val_acc.append(float(np.mean(
                    np.equal(y_val, pred > 0.5))))
                if len(np.unique(y_val)) > 1:
                    val_auc.append(auc(pred, y_val))
            msg = (f"validate: loss {np.mean(val_loss):.4f} "
                   f"acc {np.mean(val_acc):.4f}")
            if val_auc:
                msg += f" auc {np.mean(val_auc):.4f}"
                results.update(val_auc=float(np.mean(val_auc)))
            print(msg, flush=True)
            results.update(val_loss=float(np.mean(val_loss)))
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="wdl_criteo",
                        help=f"one of {MODELS}")
    parser.add_argument("--comm-mode", default=None,
                        help="None / AllReduce / PS / Hybrid (the port has "
                             "none of them yet)")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--nepoch", type=int, default=3)
    parser.add_argument("--dim", type=int, default=1_000_000,
                        help="embedding rows (synthetic data)")
    parser.add_argument("--nsamples", type=int, default=128 * 600,
                        help="synthetic dataset size")
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--all", action="store_true",
                        help="compute loss/acc/AUC each step")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--block-steps", type=int, default=20,
                        help="steps per run_batches call in the "
                             "throughput loop")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    assert args.model in MODELS, f"model {args.model} not supported"
    return args


if __name__ == "__main__":
    worker(parse_args())
