"""Data parallelism across two worker processes of one launcher job
(reference examples/runner/parallel/dist_data_pipeline_mlp.py +
dist_config8.yml): each process is one rank of a ``{"dp": 2}`` mesh and
the gradients are all-reduced over it, so the loss series matches the
single-device base run.

    python -m hetu_tpu_torch.launcher -c dist_config2.yml \
        python dist_data_mlp.py --log results/res0.npy
"""
import argparse
import os

import common
import hetu_tpu_torch as ht
from hetu_tpu_torch.executor import maybe_init_distributed


def main(args):
    common.ensure_std()
    dev = common.device(0)
    maybe_init_distributed(dev.torch_device())
    import torch.distributed as dist
    assert dist.is_initialized() and dist.get_world_size() == 2, \
        "run under a launcher job of two processes (dist_config2.yml)"
    with ht.context(dev):
        x = ht.Variable("dataloader_x", trainable=False)
        act = common.fc(x, "mlp_fc1", with_relu=True)
        w = ht.Variable("special_weight",
                        value=common.load_std("special_weight"))
        act = ht.relu_op(ht.matmul_op(act, w))
        y_pred = common.fc(act, "mlp_fc2", with_relu=False)
        y_ = ht.Variable("dataloader_y", trainable=False)
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(y_pred, y_), [0])
        train_op = ht.optim.SGDOptimizer(
            learning_rate=args.learning_rate).minimize(loss)
        executor = ht.Executor([loss, train_op],
                               mesh=ht.parallel.build_mesh({"dp": 2}))
    log = args.log
    if log and int(os.environ.get("HETU_PROC_ID", "0")) != 0:
        log = None               # rank 0 writes the comparison artifact
    common.train_and_log(executor, x, y_, args.steps, log,
                         batch_size=args.batch_size)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--log", default=None)
    main(parser.parse_args())
