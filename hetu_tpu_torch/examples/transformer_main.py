"""Seq2seq Transformer trainer of the port: the counterpart of
``examples/nlp/train_hetu_transformer.py`` (reference parity:
examples/nlp/train_hetu_transformer.py), with its command line, data and
``main(args) -> results``, on ``hetu_tpu_torch``. It runs on the GPU
unless ``--device cpu`` is given.

Data: token-id pairs from ``$HETU_DATA_DIR/mt/{src,tgt}.npy`` when
present ([N, T] int arrays, 0 = pad, 1 = BOS); otherwise a synthetic
transduction task (reverse the source) that a working model drives far
below the uniform loss.

    python -m hetu_tpu_torch.examples.transformer_main --timing
"""
import argparse
import os
import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch.data import _data_dir
from hetu_tpu_torch.models import Transformer, TransformerConfig


def load_pairs(args):
    sp, tp = (os.path.join(_data_dir(), "mt", n)
              for n in ("src.npy", "tgt.npy"))
    if os.path.exists(sp) and os.path.exists(tp):
        return np.load(sp), np.load(tp)
    rng = np.random.RandomState(0)
    src = rng.randint(2, args.vocab_size, (args.nsamples, args.maxlen))
    return src, src[:, ::-1].copy()    # the rule: reverse the source


def main(args):
    src_arr, tgt_arr = load_pairs(args)
    n, t1 = src_arr.shape
    t2 = tgt_arr.shape[1] + 1      # BOS-shifted decoder input
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        d_ff=args.d_ff, num_blocks=args.num_blocks,
        num_heads=args.num_heads, maxlen1=t1, maxlen2=t2,
        batch_size=args.batch_size, dropout_rate=args.dropout,
        label_smoothing=args.label_smoothing)
    model = Transformer(cfg)

    src = ht.Variable("src_ids", trainable=False)
    dec = ht.Variable("dec_ids", trainable=False)
    tgt = ht.Variable("tgt_ids", trainable=False)
    loss = model(src, dec, tgt)
    train_op = ht.optim.AdamOptimizer(args.learning_rate).minimize(loss)
    options = {} if args.comm_mode is None else {"comm_mode": args.comm_mode}
    exe = ht.Executor([loss, train_op], device=args.device, **options)

    bos = np.ones((args.batch_size, 1), np.int64)
    steps_per_epoch = n // args.batch_size
    results = {}
    for ep in range(args.nepoch):
        ep_st = time.time()
        ep_loss = []
        for i in range(steps_per_epoch):
            lo = i * args.batch_size
            s = src_arr[lo:lo + args.batch_size]
            t = tgt_arr[lo:lo + args.batch_size]
            d = np.concatenate([bos, t[:, :-1]], 1)
            out = exe.run(feed_dict={src: s, dec: d, tgt: t})
            ep_loss.append(float(out[0].asnumpy()))
        dt = time.time() - ep_st
        msg = f"epoch {ep}: loss {np.mean(ep_loss):.4f}"
        if args.timing:
            tps = steps_per_epoch * args.batch_size * (t2 - 1) / dt
            msg += f", {dt:.2f}s ({tps:.0f} target tokens/sec)"
            results["tokens_per_sec"] = tps
        print(msg, flush=True)
        results["loss"] = float(np.mean(ep_loss))
        results["epoch_time"] = dt
        results["steps_per_epoch"] = steps_per_epoch
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--vocab-size", type=int, default=2000)
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--d-ff", type=int, default=1024)
    parser.add_argument("--num-blocks", type=int, default=4)
    parser.add_argument("--num-heads", type=int, default=8)
    parser.add_argument("--maxlen", type=int, default=24)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--nsamples", type=int, default=64 * 200)
    parser.add_argument("--nepoch", type=int, default=5)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--label-smoothing", type=float, default=0.1)
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--comm-mode", default=None,
                        help="None / AllReduce / PS / Hybrid (the port has "
                             "none of them yet)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
