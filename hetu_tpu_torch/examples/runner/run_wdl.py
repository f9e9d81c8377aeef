"""Wide&Deep-on-Criteo trainer for the launcher's configs (counterpart
of ``examples/runner/run_wdl.py``, the runner family's sparse and PS
workload) over the port's ``ctr_main``.

    python -m hetu_tpu_torch.launcher \\
        -c hetu_tpu_torch/examples/runner/local_ps.yml \\
        python hetu_tpu_torch/examples/runner/run_wdl.py --comm-mode PS \\
        --timing
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

from hetu_tpu_torch.examples import ctr_main            # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--nepoch", type=int, default=3)
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--comm-mode", default=None,
                        help="None / PS / Hybrid")
    parser.add_argument("--cache", default="Device")
    parser.add_argument("--bound", type=int, default=100)
    parser.add_argument("--bsp", action="store_true")
    parser.add_argument("--dim", type=int, default=None,
                        help="the synthetic table's rows (ctr_main's)")
    parser.add_argument("--nsamples", type=int, default=None,
                        help="the synthetic samples (ctr_main's)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(a):
    argv = ["--model", "wdl_criteo", "--batch-size", str(a.batch_size),
            "--learning-rate", str(a.learning_rate),
            "--nepoch", str(a.nepoch), "--cache", a.cache,
            "--bound", str(a.bound)]
    for flag in ("val", "timing", "all", "bsp"):
        if getattr(a, flag):
            argv.append("--" + flag)
    for opt in ("comm_mode", "dim", "nsamples", "device"):
        if getattr(a, opt) is not None:
            argv += ["--" + opt.replace("_", "-"), str(getattr(a, opt))]
    return ctr_main.worker(ctr_main.parse_args(argv))


if __name__ == "__main__":
    print(main(parse_args()))
