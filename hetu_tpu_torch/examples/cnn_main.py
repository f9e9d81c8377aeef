"""CNN/MLP/RNN training entry point of the port: the counterpart of
``examples/cnn/main.py`` (reference parity: examples/cnn/main.py), with
the same command line, models and ``run`` results, on ``hetu_tpu_torch``.
It runs on the GPU unless ``--device cpu`` is given.

    python -m hetu_tpu_torch.examples.cnn_main --model vgg16 \
        --dataset CIFAR10 --opt momentum --timing
    python -m hetu_tpu_torch.examples.cnn_main --model digits_cnn \
        --dataset DIGITS --validate --num-epochs 25 --opt adam \
        --learning-rate 0.002 --batch-size 64
"""
import argparse
import logging
from time import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch import models

logger = logging.getLogger("hetu.examples.cnn")

MODELS = ["alexnet", "cnn_3_layers", "digits_cnn", "lenet", "logreg",
          "lstm", "mlp", "resnet18", "resnet34", "rnn", "vgg16", "vgg19"]
CONV_MODELS = {"alexnet", "cnn_3_layers", "digits_cnn", "lenet",
               "resnet18", "resnet34", "vgg16", "vgg19"}


def build_optimizer(name, lr):
    if name == "sgd":
        return ht.optim.SGDOptimizer(learning_rate=lr)
    if name == "momentum":
        return ht.optim.MomentumOptimizer(learning_rate=lr)
    if name == "nesterov":
        return ht.optim.MomentumOptimizer(learning_rate=lr, nesterov=True)
    if name == "adagrad":
        return ht.optim.AdaGradOptimizer(learning_rate=lr)
    return ht.optim.AdamOptimizer(learning_rate=lr)


def load_dataset(name, model):
    """(train_x, train_y, val_x, val_y); images are NCHW for conv nets,
    flat for dense nets (reference main.py's per-model reshapes)."""
    conv = model in CONV_MODELS
    assert model != "digits_cnn" or name == "DIGITS", \
        "digits_cnn is the 8x8-geometry conv net: use --dataset DIGITS"
    if name == "MNIST":
        (tx, ty), (vx, vy), _ = ht.data.mnist()
        if conv:
            tx = tx.reshape(-1, 1, 28, 28)
            vx = vx.reshape(-1, 1, 28, 28)
    elif name == "DIGITS":
        # the checked-in real shard (data.py digits()); conv path is
        # digits_cnn (8x8 geometry — the 28x28 stacks don't fit)
        assert not conv or model == "digits_cnn", \
            "DIGITS supports logreg/mlp/digits_cnn (8x8 images)"
        (tx, ty), (vx, vy), _ = ht.data.digits()
    elif name in ("CIFAR10", "CIFAR100"):
        loader = ht.data.cifar10 if name == "CIFAR10" else ht.data.cifar100
        tx, ty, vx, vy = loader()
        if not conv:
            tx = tx.reshape(tx.shape[0], -1)
            vx = vx.reshape(vx.shape[0], -1)
    else:
        raise ValueError(f"dataset {name} not supported")
    if model in ("rnn", "lstm"):
        tx = tx.reshape(-1, 28, 28)
        vx = vx.reshape(-1, 28, 28)
    return tx, ty, vx, vy


def run(args):
    model = getattr(models, args.model)
    tx, ty, vx, vy = load_dataset(args.dataset, args.model)

    x = ht.dataloader_op([ht.Dataloader(tx, args.batch_size, "train"),
                          ht.Dataloader(vx, args.batch_size, "validate")])
    y_ = ht.dataloader_op([ht.Dataloader(ty, args.batch_size, "train"),
                           ht.Dataloader(vy, args.batch_size, "validate")])
    kwargs = {}
    if args.model in ("logreg", "mlp"):
        # dense models take the flattened feature width of whatever
        # dataset was loaded (784 MNIST, 64 DIGITS, 3072 CIFAR)
        kwargs["input_dim"] = int(tx.shape[1])
    loss, y = model(x, y_, **kwargs)
    opt = build_optimizer(args.opt, args.learning_rate)
    train_op = opt.minimize(loss)

    eval_nodes = {"train": [loss, y, y_, train_op]}
    if args.validate:
        eval_nodes["validate"] = [loss, y, y_]
    # the port has no communication modes yet: HetuConfig refuses one
    options = {} if args.comm_mode is None else {"comm_mode": args.comm_mode}
    executor = ht.Executor(eval_nodes, device=args.device, **options)

    results = {}
    for epoch in range(args.num_epochs):
        ep_st = time()
        train_loss, train_acc = [], []
        for _ in range(executor.get_batch_num("train")):
            loss_val, predict_y, y_val, _ = executor.run(
                "train", convert_to_numpy_ret_vals=True)
            train_loss.append(loss_val[0] if np.ndim(loss_val) else loss_val)
            train_acc.append(np.mean(np.argmax(y_val, 1)
                                     == np.argmax(predict_y, 1)))
        ep_en = time()
        msg = (f"Epoch {epoch}: train loss {np.mean(train_loss):.4f}, "
               f"train acc {np.mean(train_acc):.4f}")
        if args.timing:
            msg += f", epoch time {ep_en - ep_st:.3f}s"
            results["epoch_time"] = ep_en - ep_st
        if args.validate:
            val_loss, val_acc = [], []
            for _ in range(executor.get_batch_num("validate")):
                loss_val, val_y_pred, y_val = executor.run(
                    "validate", convert_to_numpy_ret_vals=True)
                val_loss.append(loss_val[0]
                                if np.ndim(loss_val) else loss_val)
                val_acc.append(np.mean(np.argmax(y_val, 1)
                                       == np.argmax(val_y_pred, 1)))
            msg += (f", val loss {np.mean(val_loss):.4f}, "
                    f"val acc {np.mean(val_acc):.4f}")
            results["val_acc"] = float(np.mean(val_acc))
        logger.info(msg)
        results["train_loss"] = float(np.mean(train_loss))
        results["train_acc"] = float(np.mean(train_acc))
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        help=f"one of {MODELS}")
    parser.add_argument("--dataset", required=True,
                        help="MNIST / CIFAR10 / CIFAR100")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--learning-rate", type=float, default=0.1)
    parser.add_argument("--opt", default="sgd",
                        choices=["sgd", "momentum", "nesterov", "adagrad",
                                 "adam"])
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--comm-mode", default=None,
                        help="None / AllReduce / PS / Hybrid (the port has "
                             "none of them yet)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    assert args.model in MODELS, f"model {args.model} not supported"
    return args


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(message)s")
    run(parse_args())
