"""CNN zoo ground truth: the conv model on one device (reference
examples/runner/parallel/test_model_cnn_base.py).

    python -m hetu_tpu_torch.launcher -c config1.yml python test_cnn_base.py --save \
        --log results/cnn_base.npy
"""
import argparse

import common
import hetu_tpu_torch as ht


def build(device0, special_ctx=None, split=None):
    """The shared zoo conv model; ``split`` dispatches the special
    conv's operands (test_cnn_mp.py passes it)."""
    with ht.context(device0):
        x = ht.Variable("dataloader_x", trainable=False)
        act = ht.array_reshape_op(x, (-1, 1, 28, 28))
        act = common.conv_relu(act, "cnn_conv1_weight")
        act = ht.max_pool2d_op(act, 2, 2, stride=2)

    with ht.context(special_ctx or device0):
        w = ht.Variable("special_cnn_weight",
                        value=common.load_std("special_cnn_weight"))
        if split is not None:
            act_parts, w_parts = common.CNN_SPLITS[split]
            act = ht.dispatch(act, act_parts)
            w = ht.dispatch(w, w_parts)
        act = ht.conv2d_op(act, w, padding=2, stride=1)

    with ht.context(device0):
        if split is not None:
            act = ht.dispatch(act, (1, 1, 1, 1))
        act = ht.relu_op(act)
        act = ht.max_pool2d_op(act, 2, 2, stride=2)
        act = ht.array_reshape_op(act, (-1, 32 * 7 * 7))
        y_pred = common.fc(act, "cnn_fc", with_relu=False)
        y_ = ht.Variable("dataloader_y", trainable=False)
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(y_pred, y_), [0])
    return x, y_, loss


def main(args):
    common.ensure_std()
    common.ensure_cnn_std(force=args.save)
    x, y_, loss = build(common.device(0))
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
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--log", default=None)
    main(parser.parse_args())
