"""CNN model-parallel zoo variants: the special conv's operands are
dispatched across devices — batch ('left'), output channels ('right'),
or the contracted input channels ('middle') — and every split must
reproduce the base loss series (reference
examples/runner/parallel/test_model_cnn.py + all_cnn_tests.sh).

The port realizes the dispatch parts as partition specs over one thread
rank a device of the tuple context; the in-channel split contracts with
an all-reduce over the ranks.

    python -m hetu_tpu_torch.launcher -c config2.yml python test_cnn_mp.py --split middle \
        --log results/cnn_res1.npy
"""
import argparse

import common
import hetu_tpu_torch as ht
from test_cnn_base import build


def main(args):
    common.ensure_std()
    common.ensure_cnn_std()
    act_parts, w_parts = common.CNN_SPLITS[args.split]
    ndev = act_parts[0] * act_parts[1] * w_parts[0]
    devices = tuple(common.device(i) for i in range(ndev))
    x, y_, loss = build(common.device(0), special_ctx=devices,
                        split=args.split)
    with ht.context(common.device(0)):
        train_op = ht.optim.SGDOptimizer(
            learning_rate=args.learning_rate).minimize(loss)
        executor = ht.Executor([loss, train_op])
    common.train_and_log(executor, x, y_, args.steps, args.log,
                         batch_size=args.batch_size)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--split", default="left",
                        choices=sorted(common.CNN_SPLITS))
    parser.add_argument("--log", default=None)
    main(parser.parse_args())
