"""Tensor-parallel configs: the middle matmul's operands are dispatched
across devices; every --split must reproduce the base loss series
(reference examples/runner/parallel/test_mlp_mp.py — same split
vocabulary, same validation workflow).

The port's planner turns the ``ht.dispatch`` parts into partition specs
over one thread rank a device, and gloo collectives move values between
layouts.

    python -m hetu_tpu_torch.launcher -c config2.yml python test_mlp_mp.py --split left \
        --log results/res1.npy
"""
import argparse

import common
import hetu_tpu_torch as ht


def main(args):
    common.ensure_std()
    act_parts, w_parts = common.SPLITS[args.split]
    # device count = batch-rows x contraction x weight-cols (the three
    # parallel axes of y = a @ w; max() would undercount composite '2')
    ndev = act_parts[0] * act_parts[1] * w_parts[1]
    devices = tuple(common.device(i) for i in range(ndev))

    with ht.context(common.device(0)):
        x = ht.Variable("dataloader_x", trainable=False)
        act = common.fc(x, "mlp_fc1", with_relu=True)

    with ht.context(devices):
        w = ht.Variable("special_weight",
                        value=common.load_std("special_weight"))
        act = ht.dispatch(act, act_parts)
        w = ht.dispatch(w, w_parts)
        act = ht.matmul_op(act, w)

    with ht.context(common.device(0)):
        act = ht.dispatch(act, (1, 1))
        act = ht.relu_op(act)
        y_pred = common.fc(act, "mlp_fc2", with_relu=False)
        y_ = ht.Variable("dataloader_y", trainable=False)
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(y_pred, y_), [0])
        train_op = ht.optim.SGDOptimizer(
            learning_rate=args.learning_rate).minimize(loss)
        executor = ht.Executor([loss, train_op])
    common.train_and_log(executor, x, y_, args.steps, args.log,
                         batch_size=args.batch_size)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--split", default="left",
                        choices=sorted(common.SPLITS))
    parser.add_argument("--log", default=None)
    main(parser.parse_args())
