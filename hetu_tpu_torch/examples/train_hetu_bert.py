"""BERT pre-training trainer of the port: the counterpart of
``examples/nlp/bert/train_hetu_bert.py``, with its command line (batch,
sequence length, widths, ``--fp32``, ``--no-flash``, ``--comm-mode``),
its synthetic batches (MLM + NSP, Adam, the loss and tokens/s every
``--log-every`` steps) and ``run(args) -> results``, on
``hetu_tpu_torch``. It runs on the GPU unless ``--device cpu`` is given.

bf16 mixed precision and the flash attention are on by default: at
S=128 the forward is the K1 kernel and the backward the composed vjp,
at S >= 512 (``ops.attention.FUSED_BWD_MIN_SEQ``) K2-K4.

    python -m hetu_tpu_torch.examples.train_hetu_bert --timing \\
        --num-steps 50
"""
import argparse
import time

import numpy as np
import torch

import hetu_tpu_torch as ht
import hetu_tpu_torch.models as M


def synthetic_batch(rng, batch, seq_len, vocab):
    input_ids = rng.randint(0, vocab, (batch, seq_len))
    token_type_ids = np.zeros((batch, seq_len), np.int64)
    token_type_ids[:, seq_len // 2:] = 1
    attention_mask = np.ones((batch, seq_len), np.float32)
    masked_lm_labels = np.where(rng.rand(batch, seq_len) < 0.15,
                                input_ids, -1)
    next_sentence_label = rng.randint(0, 2, (batch,))
    return (input_ids, token_type_ids, attention_mask, masked_lm_labels,
            next_sentence_label)


def run(args):
    cfg = M.BertConfig(
        vocab_size=args.vocab_size, hidden_size=args.hidden_size,
        num_hidden_layers=args.num_layers,
        num_attention_heads=args.num_heads,
        intermediate_size=args.hidden_size * 4,
        max_position_embeddings=args.seq_length,
        use_flash_attention=not args.no_flash)
    model = M.BertForPreTraining(cfg)

    input_ids = ht.Variable("input_ids", trainable=False)
    token_type_ids = ht.Variable("token_type_ids", trainable=False)
    attention_mask = ht.Variable("attention_mask", trainable=False)
    mlm_labels = ht.Variable("masked_lm_labels", trainable=False)
    nsp_label = ht.Variable("next_sentence_label", trainable=False)
    _, _, mlm_loss, nsp_loss = model(input_ids, token_type_ids,
                                     attention_mask, mlm_labels, nsp_label)
    loss = ht.reduce_mean_op(mlm_loss, [0, 1]) + \
        ht.reduce_mean_op(nsp_loss, [0])
    opt = ht.optim.AdamOptimizer(learning_rate=args.lr)
    train_op = opt.minimize(loss)

    executor = ht.Executor(
        [loss, train_op], comm_mode=args.comm_mode, device=args.device,
        dtype=None if args.fp32 else torch.bfloat16)

    rng = np.random.RandomState(0)
    feed_nodes = (input_ids, token_type_ids, attention_mask, mlm_labels,
                  nsp_label)
    results = {"losses": []}
    t0 = time.perf_counter()
    window_tokens = 0
    for step in range(args.num_steps):
        values = synthetic_batch(rng, args.batch_size, args.seq_length,
                                 args.vocab_size)
        out = executor.run(feed_dict=dict(zip(feed_nodes, values)))
        window_tokens += args.batch_size * args.seq_length
        loss_val = float(np.asarray(out[0].asnumpy()))
        results["losses"].append(loss_val)
        if (step + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            tps = window_tokens / dt
            msg = f"step {step + 1}: loss {loss_val:.4f}"
            if args.timing:
                msg += f", {tps:.0f} tokens/sec"
            print(msg, flush=True)
            results.update(loss=loss_val, tokens_per_sec=tps)
            t0 = time.perf_counter()
            window_tokens = 0
    executor.close()
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--seq-length", type=int, default=128)
    parser.add_argument("--vocab-size", type=int, default=30522)
    parser.add_argument("--hidden-size", type=int, default=768)
    parser.add_argument("--num-layers", type=int, default=12)
    parser.add_argument("--num-heads", type=int, default=12)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--num-steps", type=int, default=100)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--fp32", action="store_true",
                        help="disable bf16 mixed precision")
    parser.add_argument("--no-flash", action="store_true",
                        help="the composed attention in place of the "
                             "flash kernels")
    parser.add_argument("--comm-mode", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
