"""GPT causal-LM trainer of the port: the counterpart of
``examples/nlp/train_hetu_gpt.py``, with its command line, data and
``main(args) -> results``, on ``hetu_tpu_torch``. It runs on the GPU
unless ``--device cpu`` is given.

Data: a token-id corpus from ``$HETU_DATA_DIR/lm/corpus.npy`` when
present ([N] int array, chunked into sequences); otherwise a synthetic
Markov corpus (each token is a deterministic function of the previous
two) that a working decoder drives far below the uniform-loss floor.

``--sequence-parallel ring|ulysses`` builds the model's attention as
the sequence-parallel op. In one process that is the fused path, as in
the reference; as a launcher job of n processes (``spmd: true``) the
session takes an ``{"sp": n}`` mesh and each rank attends its share of
the sequence:

    python -m hetu_tpu_torch.examples.train_hetu_gpt --timing
    python -m hetu_tpu_torch.launcher -c sp.yml \\
        python -m hetu_tpu_torch.examples.train_hetu_gpt \\
        --sequence-parallel ring --device cpu
"""
import argparse
import os
import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch.data import _data_dir
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel


def load_corpus(args):
    path = os.path.join(_data_dir(), "lm", "corpus.npy")
    if os.path.exists(path):
        flat = np.load(path).astype(np.int64)
        assert flat.max() < args.vocab_size and flat.min() >= 0, (
            f"corpus ids span [{flat.min()}, {flat.max()}] but "
            f"--vocab-size is {args.vocab_size}; the embedding gather "
            "would silently clamp out-of-range ids")
    else:
        rng = np.random.RandomState(0)
        n = args.nsamples * args.seq_len
        flat = np.empty(n, np.int64)
        flat[0], flat[1] = rng.randint(0, args.vocab_size, 2)
        # order-2 Markov rule: learnable, not memorizable marginals
        for i in range(2, n):
            flat[i] = (3 * flat[i - 1] + 5 * flat[i - 2] + 7) \
                % args.vocab_size
    nseq = len(flat) // args.seq_len
    return flat[:nseq * args.seq_len].reshape(nseq, args.seq_len)


def sp_mesh(device):
    """An ``{"sp": n}`` mesh over the launcher job this process is a rank
    of (n its processes), or None outside a job."""
    nprocs = int(os.environ.get("HETU_NUM_PROCS", "1"))
    if nprocs <= 1 or "HETU_COORDINATOR" not in os.environ:
        return None
    from hetu_tpu_torch.executor import maybe_init_distributed
    maybe_init_distributed(device)
    return ht.parallel.build_mesh({"sp": nprocs})


def main(args):
    data = load_corpus(args)
    cfg = GPTConfig(
        vocab_size=args.vocab_size, hidden_size=args.hidden_size,
        num_hidden_layers=args.num_layers,
        num_attention_heads=args.num_heads,
        max_position_embeddings=args.seq_len,
        hidden_dropout_prob=args.dropout,
        use_flash_attention=True,
        sequence_parallel=args.sequence_parallel)
    model = GPTLMHeadModel(cfg)
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = model(ids, labels)
    lm_loss = ht.reduce_mean_op(loss, [0, 1])
    opt = ht.optim.AdamOptimizer(learning_rate=args.learning_rate)
    train_op = opt.minimize(lm_loss)
    mesh = sp_mesh(args.device)
    executor = ht.Executor([lm_loss, train_op], device=args.device,
                           mesh=mesh)
    tag = "" if mesh is None else f"rank {mesh.rank} "

    nbatch = max(1, len(data) // args.batch_size)
    results = {"losses": []}
    for epoch in range(args.nepoch):
        t0 = time.time()
        losses = []
        for b in range(nbatch):
            x = data[b * args.batch_size:(b + 1) * args.batch_size]
            # shift by one; the final position has no next token: pad
            # with the sparse-CE op's ignored_index so it trains nothing
            y = np.concatenate(
                [x[:, 1:], np.full((len(x), 1), -1, np.int64)], axis=1)
            out = executor.run(feed_dict={ids: x, labels: y},
                               convert_to_numpy_ret_vals=True)
            losses.append(float(out[0]))
        msg = f"{tag}epoch {epoch}: loss {np.mean(losses):.8f}"
        if args.timing:
            msg += f", {time.time() - t0:.2f}s"
        print(msg, flush=True)
        results["loss"] = float(np.mean(losses))
        results["losses"].append(results["loss"])
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--hidden-size", type=int, default=128)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--nsamples", type=int, default=256)
    p.add_argument("--nepoch", type=int, default=2)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--timing", action="store_true")
    p.add_argument("--sequence-parallel", default=None,
                   choices=[None, "ring", "ulysses"])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
