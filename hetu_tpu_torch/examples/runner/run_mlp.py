"""MLP-on-MNIST trainer for the launcher's configs (counterpart of
``examples/runner/run_mlp.py``, the runner family's dense workload) over
the port's ``cnn_main``: the comm mode comes from ``--comm-mode``, the
ranks from the launcher's job.

    python hetu_tpu_torch/examples/runner/run_mlp.py --timing --validate
    python -m hetu_tpu_torch.launcher \\
        -c hetu_tpu_torch/examples/runner/local_allreduce.yml \\
        python hetu_tpu_torch/examples/runner/run_mlp.py \\
        --comm-mode AllReduce --timing
"""
import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

from hetu_tpu_torch.examples import cnn_main            # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--learning-rate", type=float, default=0.1)
    parser.add_argument("--opt", default="sgd",
                        choices=["sgd", "momentum", "nesterov", "adagrad",
                                 "adam"])
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--comm-mode", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(a):
    argv = ["--model", "mlp", "--dataset", "MNIST",
            "--batch-size", str(a.batch_size),
            "--learning-rate", str(a.learning_rate), "--opt", a.opt,
            "--num-epochs", str(a.num_epochs)]
    if a.validate:
        argv.append("--validate")
    if a.timing:
        argv.append("--timing")
    if a.comm_mode:
        argv += ["--comm-mode", a.comm_mode]
    if a.device:
        argv += ["--device", a.device]
    return cnn_main.run(cnn_main.parse_args(argv))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(message)s")
    print(main(parse_args()))
