"""The port's GNN examples against the JAX package's on the CPU:
``examples/sampled_sage.py`` at ``tests/test_gnn_sampled.py``'s settings
reaches its bar (loss < 0.5) with every epoch's loss within 1e-4 of
``examples/gnn/train_sampled_sage.py``'s (which prints four decimals),
and ``examples/gcn_main.py`` on a 2000-node graph gives every epoch's
loss within 1e-5 relative, and accuracy within 1e-3, of
``examples/gnn/train_hetu_gcn.py``'s.

Run as a script, it prints the JAX package's per-epoch losses and
accuracies of ``train_hetu_gcn.py`` at the arguments given, at full
precision: where ``chip_smoke.py``'s ``gcn_example`` constants come from.

    JAX_PLATFORMS=cpu python tests/test_torch_gnn_example.py \\
        --learning-rate 10
"""
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "examples", "gnn"))
import train_hetu_gcn as ref_gcn                        # noqa: E402
import train_sampled_sage as ref_sage                   # noqa: E402

import hetu_tpu as jht                                  # noqa: E402
from hetu_tpu_torch.dataloader import GNNDataLoaderOp   # noqa: E402

SAGE_ARGS = ["--num-epoch", "4", "--nodes", "1200", "--batch-seeds", "32"]
GCN_ARGS = ["--nodes", "2000", "--num-epochs", "5"]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Steps of small ops: one intra-op thread runs them fastest, and
    parallel test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_gcn(argv):
    """``train_hetu_gcn.run`` on hetu_tpu (the CPU) with ``argv``: each
    epoch's mean loss and accuracy, at full precision (the example
    prints four decimals)."""
    outs = []
    base = jht.Executor

    class Recording(base):
        def run(self, *args, **kwargs):
            out = super().run(*args, **kwargs)
            outs.append(out)
            return out

    args = ref_gcn.parse_args(argv)
    jht.Executor = Recording
    try:
        ref_gcn.run(args)
    finally:
        jht.Executor = base
    labels = np.argmax(ref_gcn.load_graph(args)[2], 1)
    return {"losses": [float(np.mean(o[0])) for o in outs],
            "accs": [float(np.mean(np.argmax(o[1], 1) == labels))
                     for o in outs]}


def test_sampled_sage_trains_like_the_reference(capsys):
    from hetu_tpu_torch.examples import sampled_sage
    ref_sage.main(ref_sage.parse_args(SAGE_ARGS))
    printed = capsys.readouterr().out
    want = [float(v) for v in re.findall(r"loss ([0-9.]+)", printed)]
    got = sampled_sage.main(sampled_sage.parse_args(SAGE_ARGS
                                                    + ["--device", "cpu"]))
    assert got["loss"] < 0.5, got
    assert len(want) == len(got["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=1e-4)
    # the double buffer is the class's: leave it as a fresh process has it
    GNNDataLoaderOp.graph = GNNDataLoaderOp.nxt_graph = None


@pytest.mark.parametrize("lr", ["0.01", "10"])
def test_gcn_main_trains_like_the_reference(lr):
    """At the example's default rate and at chip_smoke.py's."""
    from hetu_tpu_torch.examples import gcn_main
    argv = GCN_ARGS + ["--learning-rate", lr]
    want = reference_gcn(argv)
    got = gcn_main.run(gcn_main.parse_args(argv + ["--device", "cpu"]))
    assert len(got["losses"]) == 5
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(got["accs"], want["accs"], rtol=0, atol=1e-3)
    assert got["losses"][-1] < got["losses"][0]


if __name__ == "__main__":
    print(json.dumps(reference_gcn(sys.argv[1:])))
