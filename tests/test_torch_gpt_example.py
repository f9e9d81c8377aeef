"""The port's GPT example (``hetu_tpu_torch/examples/train_hetu_gpt.py``),
the counterpart of ``examples/nlp/train_hetu_gpt.py``: the reference's
accuracy bar in one process, and a launcher job of two CPU workers
under ``--sequence-parallel ring`` against the one process."""
import json

import numpy as np

from torch_ps_util import run_fleet

from hetu_tpu_torch.examples import train_hetu_gpt as gm

SPMD = """
spmd: true
nodes:
  - host: localhost
    workers: 2
    chief: true
"""

WORKER = """
import json
import os
from hetu_tpu_torch.examples import train_hetu_gpt as gm
results = gm.main(gm.parse_args(ARGS))
rank = os.environ["RANK"]
with open(os.path.join(os.environ["HETU_TEST_OUT"], f"rank_{rank}.json"),
          "w") as f:
    json.dump(results, f)
"""

JOB_ARGS = ["--nepoch", "2", "--nsamples", "64", "--seq-len", "64",
            "--hidden-size", "64", "--num-layers", "2", "--device", "cpu"]


def test_gpt_example_learns_markov_corpus(monkeypatch, tmp_path):
    """tests/test_accuracy.py::test_gpt_example_learns_markov_corpus's
    arguments and bar: a few epochs on the order-2 Markov corpus drive
    next-token loss below 1.5 (ln(V) = 5.55 uniform). HETU_DATA_DIR
    points at an empty dir so the synthetic task runs."""
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    results = gm.main(gm.parse_args(
        ["--nepoch", "6", "--nsamples", "128", "--seq-len", "64",
         "--hidden-size", "128", "--num-layers", "2", "--device", "cpu"]))
    assert results["loss"] < 1.5, results


def test_ring_job_of_two_workers_matches_one_process(monkeypatch, tmp_path):
    """``--sequence-parallel ring`` as an ``spmd: true`` job of two CPU
    workers: each rank takes an {"sp": 2} mesh and attends half of each
    sequence; both ranks' epoch losses are equal and within rtol 1e-4 of
    the one-process run (the fused path)."""
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    want = gm.main(gm.parse_args(JOB_ARGS))["losses"]
    script = WORKER.replace("ARGS", repr(
        JOB_ARGS + ["--sequence-parallel", "ring"]))
    proc = run_fleet("hetu_tpu_torch", SPMD, script, tmp_path,
                     timeout=240, HETU_DATA_DIR=str(tmp_path))
    assert proc.returncode == 0, proc.stdout
    got = [json.loads((tmp_path / f"rank_{r}.json").read_text())["losses"]
           for r in range(2)]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=1e-4)
