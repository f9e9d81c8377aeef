"""The efficiency lint's card model and perfcheck on the card
(``analysis/efficiency.py``, ``analysis/perfcheck.py``). A fresh
``measure_card_model`` sweep reproduces the committed HT902 constants:
each dtype's (K, N) granule exactly, the GEMM rates and the copy rate
within 10%, bf16's misalignment share within 0.1. HT902's priced share
of a flagged GEMM's time is at most ``SOUND_FACTOR`` (HT910's bound)
times what aligning its dims measurably saves.
``perfcheck_model("mlp")`` on the card leaves no HT910. And a
``--preflight`` on the card's host initializes no CUDA: the efficiency
pass prices its graph without asking the card its name. Marked
``cuda``: it skips without a GPU. Imports neither JAX nor ``hetu_tpu``,
so it runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_efficiency_cuda.py
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from hetu_tpu_torch.analysis import efficiency, perfcheck

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE_TOL = 0.10
SHARE_TOL = 0.10
# GEMMs HT902 flags on the card, (M, K, N, dtype): f32 padded to the N
# granule, bf16 with rows that are not whole 16-byte vectors
FLAGGED = [(8192, 4096, 72, torch.float32),
           (8192, 4096, 260, torch.bfloat16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)


def test_card_model_reproduces_the_committed_constants(cuda):
    got = efficiency.measure_card_model(cuda)
    assert got["granule"] == {k: tuple(v) for k, v in
                              efficiency._GRANULE.items()}, got
    for dtype, rate in got["tflops"].items():
        want = efficiency._GEMM_TFLOPS[dtype]
        assert abs(rate - want) <= RATE_TOL * want, got["tflops"]
    rate = got["copy"]["gbps"]
    assert abs(rate - efficiency._DRAM_GBPS) <= \
        RATE_TOL * efficiency._DRAM_GBPS, got["copy"]
    assert set(got["misaligned_share"]) == \
        set(efficiency._MISALIGNED_SHARE)
    for dtype, share in got["misaligned_share"].items():
        assert abs(share - efficiency._MISALIGNED_SHARE[dtype]) <= \
            SHARE_TOL, got["misaligned_share"]


@pytest.mark.parametrize("m,k,n,dtype", FLAGGED)
def test_ht902_price_is_sound_against_the_measured_saving(cuda, m, k, n,
                                                          dtype):
    got = efficiency.measure_padding_share(m, k, n, dtype, cuda)
    assert got["priced_share"] >= efficiency._WASTE_FRAC_FLOOR, got
    assert got["priced_share"] <= \
        perfcheck.SOUND_FACTOR * got["measured_share"], got


def test_perfcheck_mlp_on_the_card(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("HETU_COSTDB", str(tmp_path / "costdb.json"))
    report, checked, buckets, _static = perfcheck.perfcheck_model(
        "mlp", steps=6, device=cuda)
    assert not [f for f in report.findings if f.code == "HT910"], \
        [str(f) for f in report.findings]
    assert buckets


_PREFLIGHT_SCRIPT = """
import atexit, json, os
import numpy as np
import torch
import hetu_tpu_torch as ht


def touched():
    with open(os.environ["HETU_TEST_OUT"] + "/touched.json", "w") as f:
        json.dump({"cuda": torch.cuda.is_initialized()}, f)


atexit.register(touched)
x = ht.Variable("x", value=np.zeros((256, 4096), "f"), trainable=False)
w = ht.Variable("w", value=np.zeros((4096, 72), "f"))
loss = ht.reduce_mean_op(ht.matmul_op(x, w), [0, 1])
ht.Executor([loss])
open(os.environ["HETU_TEST_OUT"] + "/RAN_ON", "w").write("x")
"""


def test_preflight_on_the_card_initializes_no_cuda(cuda, tmp_path):
    """The launcher's ``--preflight`` on a host with a card: the graph
    (an HT902-flagged GEMM, so the efficiency pass prices it) is
    analyzed, the script exits before its body goes on, and its process
    never initialized CUDA."""
    cfg = tmp_path / "cluster.yml"
    cfg.write_text("nodes:\n  - host: localhost\n    chief: true\n"
                   "    servers: 0\n    workers: 1\n")
    script = tmp_path / "train.py"
    script.write_text(_PREFLIGHT_SCRIPT)
    env = {**os.environ, "HETU_TEST_OUT": str(tmp_path),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get(
               "PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.launcher", "-c", str(cfg),
         "--preflight", sys.executable, str(script)], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text
    assert "HT902" in text, text
    assert not (tmp_path / "RAN_ON").exists()
    assert json.loads((tmp_path / "touched.json").read_text()) == \
        {"cuda": False}, text
