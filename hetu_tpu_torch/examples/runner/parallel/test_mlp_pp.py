"""Pipeline-parallel config: the MLP split into two stages on two
devices, trained with the GPipe schedule — loss-equivalent to
the base run (reference examples/runner/parallel/test_mlp_pp.py).

    python -m hetu_tpu_torch.launcher -c config2.yml python test_mlp_pp.py --log results/res0.npy
"""
import argparse

import common
import hetu_tpu_torch as ht


def main(args):
    common.ensure_std()
    with ht.context(common.device(0)):
        x = ht.Variable("dataloader_x", trainable=False)
        act = common.fc(x, "mlp_fc1", with_relu=True)
        w = ht.Variable("special_weight",
                        value=common.load_std("special_weight"))
        act = ht.matmul_op(act, w)
    with ht.context(common.device(1)):
        act = ht.relu_op(act)
        y_pred = common.fc(act, "mlp_fc2", with_relu=False)
        y_ = ht.Variable("dataloader_y", trainable=False)
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(y_pred, y_), [0])
        train_op = ht.optim.SGDOptimizer(
            learning_rate=args.learning_rate).minimize(loss)
    executor = ht.Executor([loss, train_op], gpipe=True,
                           num_microbatches=args.micro_batches)
    common.train_and_log(executor, x, y_, args.steps, args.log,
                         batch_size=args.batch_size)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--micro-batches", type=int, default=4)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--log", default=None)
    main(parser.parse_args())
