"""NCF training entry point of the port: the counterpart of
``examples/rec/run_hetu.py`` (reference parity: examples/rec/run_hetu.py),
with its command line, data and HR@10 / NDCG@10 retrieval evaluation over
each user's 100 candidates, on ``hetu_tpu_torch``. The embedding tables
live on the device; the PS and Hybrid modes (``--comm PS/Hybrid``) wait
for the PS port and are refused. It runs on the GPU unless
``--device cpu`` is given.

    python -m hetu_tpu_torch.examples.rec_main --val --timing
"""
import argparse
import math
import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch.examples.movielens import getdata
from hetu_tpu_torch.models.ncf import neural_mf


def hit_ratio(ranklist, gt_item):
    return int(gt_item in ranklist)


def ndcg(ranklist, gt_item):
    for i, item in enumerate(ranklist):
        if item == gt_item:
            return math.log(2) / math.log(i + 2)
    return 0.0


def worker(args):
    if args.comm in ("PS", "Hybrid"):
        raise NotImplementedError(
            f"--comm {args.comm}: PS mode waits for the PS port; the port "
            f"keeps the tables on the device (leave --comm unset)")
    train, test, num_users, num_items = getdata(args.dataset)
    train_users = train["user_input"]
    train_items = train["item_input"]
    train_labels = train["labels"].astype(np.float32).reshape(-1, 1)
    if not args.all:   # reference default: first 1,024,000 samples
        cap = min(len(train_labels), 1_024_000)
        train_users, train_items, train_labels = (
            train_users[:cap], train_items[:cap], train_labels[:cap])
    if num_users is None:
        # test rows are indexed by user id; test cells are item ids
        num_users = int(max(train_users.max() + 1, test.shape[0]))
        num_items = int(max(train_items.max(), test.max()) + 1)
    test_user_input = np.repeat(
        np.arange(test.shape[0], dtype=np.int32), 100)
    test_item_input = test.reshape(-1).astype(np.int32)

    batch = args.batch_size
    topk = 10
    # score eval_users users' 100 candidates a step: the model is
    # pointwise over [B] ids, so this is the reference's one user a step
    # with fewer steps; drop_last=False scores every user
    eval_batch = 100 * args.eval_users
    user_input = ht.dataloader_op([
        ht.Dataloader(train_users, batch, "train"),
        ht.Dataloader(test_user_input, eval_batch, "validate",
                      drop_last=False)])
    item_input = ht.dataloader_op([
        ht.Dataloader(train_items, batch, "train"),
        ht.Dataloader(test_item_input, eval_batch, "validate",
                      drop_last=False)])
    y_ = ht.dataloader_op([
        ht.Dataloader(train_labels, batch, "train")])

    loss, y, train_op = neural_mf(
        user_input, item_input, y_, num_users, num_items,
        learning_rate=args.learning_rate)
    options = {} if args.comm is None else {"comm_mode": args.comm}
    executor = ht.Executor({"train": [loss, train_op], "validate": [y]},
                           device=args.device, **options)

    def validate():
        hits, ndcgs = [], []
        done = 0
        for _ in range(executor.get_batch_num("validate")):
            pred = executor.run("validate",
                                convert_to_numpy_ret_vals=True)[0]
            nu = len(pred) // 100
            scores = pred.reshape(nu, 100)
            items = test_item_input[done:done + nu * 100].reshape(nu, 100)
            done += nu * 100
            # rank each user's 100 candidates; col 0 is the held-out item
            order = np.argsort(-scores, axis=1)[:, :topk]
            for u in range(nu):
                ranklist = items[u, order[u]].tolist()
                hits.append(hit_ratio(ranklist, int(items[u, 0])))
                ndcgs.append(ndcg(ranklist, int(items[u, 0])))
        return float(np.mean(hits)), float(np.mean(ndcgs))

    results = {}
    start = time.time()
    for ep in range(args.nepoch):
        ep_st = time.time()
        train_loss = []
        nbatch = executor.get_batch_num("train")
        if args.metrics_every_step:
            for _ in range(nbatch):
                loss_val = executor.run(
                    "train", convert_to_numpy_ret_vals=True)
                train_loss.append(float(loss_val[0]))
        else:
            kblock = min(args.block_steps, nbatch)
            done = 0
            while done < nbatch:
                k = min(kblock, nbatch - done)
                out = executor.run_batches([{}] * k, name="train")
                done += k
                train_loss.extend(
                    float(np.mean(o[0].asnumpy())) for o in out)
        ep_time = time.time() - ep_st
        msg = f"epoch {ep}: train_loss {np.mean(train_loss):.4f}"
        if args.val:
            hr, nd = validate()
            msg += f", HR@{topk} {hr:.4f}, NDCG@{topk} {nd:.4f}"
            results.update(hr=hr, ndcg=nd)
        if args.timing:
            sps = nbatch * batch / ep_time
            msg += f", train_time {ep_time:.2f}s ({sps:.0f} samples/sec)"
            results.update(samples_per_sec=sps)
        print(msg, flush=True)
        results.update(loss=float(np.mean(train_loss)),
                       train_time=ep_time, steps_per_epoch=nbatch)
    print(f"all time: {time.time() - start:.2f}s", flush=True)
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--val", action="store_true",
                        help="HR@10/NDCG@10 retrieval eval per epoch")
    parser.add_argument("--all", action="store_true",
                        help="use the full train set (default 1,024,000)")
    parser.add_argument("--comm", default=None,
                        help="None / PS / Hybrid (the port has none of "
                             "them yet)")
    parser.add_argument("--dataset", default="ml-25m")
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--nepoch", type=int, default=7)
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--eval-users", type=int, default=50,
                        help="users scored per validation step")
    parser.add_argument("--metrics-every-step", action="store_true",
                        help="read the loss back every step (reference "
                             "loop); default runs blocks of steps")
    parser.add_argument("--block-steps", type=int, default=50)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    worker(parse_args())
