"""Telemetry on the card: ``chip_smoke.py``'s ``telemetry_train`` checks
at 2 layers of GPT-2-small's widths. Two executors over one graph, one
with ``telemetry=<dir>`` and ``log_path``, one with telemetry off, run
interleaved; the traced losses must equal the untraced ones bit for bit
(no span synchronizes or reorders the device's work), and the trace,
the counters, the memory gauges, the step log and the kernels' launches
must be what the steps did. Marked ``cuda``: it skips without a GPU.
Imports neither JAX nor ``hetu_tpu``, so it runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_telemetry_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

import hetu_tpu_torch as ht
import hetu_tpu_torch.models as M
from hetu_tpu_torch import telemetry
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

WIDTHS = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=2,
              num_attention_heads=12, max_position_embeddings=1024,
              hidden_dropout_prob=0.0, use_flash_attention=True)
BATCH, STEPS = 8, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)
    telemetry._default = None


def test_traced_training_equals_untraced_and_records_the_steps(cuda,
                                                               tmp_path):
    cfg = M.GPTConfig(**WIDTHS)
    seq = cfg.max_position_embeddings
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    train = ht.optim.AdamOptimizer(learning_rate=1e-4).minimize(lm)
    rng = np.random.RandomState(0)
    x = rng.randint(0, cfg.vocab_size, (BATCH, seq))
    y = np.concatenate([x[:, 1:], np.full((BATCH, 1), -1)], axis=1)
    feeds = {ids: x, labels: y}
    tdir = str(tmp_path / "tel")
    traced = ht.Executor([lm, train], dtype=torch.bfloat16, telemetry=tdir,
                         log_path=os.path.join(tdir, "steps.jsonl"))
    plain = ht.Executor([lm, train], dtype=torch.bfloat16, telemetry=False)
    tel = traced.config.telemetry
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    got, want = [], []
    for _ in range(STEPS):
        got.append(float(traced.run(feed_dict=feeds)[0].asnumpy()))
        want.append(float(plain.run(feed_dict=feeds)[0].asnumpy()))
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    assert got == want and np.all(np.isfinite(got))
    n = cfg.num_hidden_layers * 2 * STEPS
    for k in (fa.K2, fa.K3, fa.K4):
        assert launches[k] == launches[f"{k}.tc"] == n, launches
    assert launches.get(fa.K1, 0) == 0
    assert tel.counter_value("h2d_bytes") == STEPS * (x.nbytes + y.nbytes)
    assert tel.metrics.histogram("step_wall_ms").count == STEPS
    live = tel.metrics.peek("memory_live_bytes")
    assert 0 < live <= tel.metrics.peek("memory_peak_bytes") <= peak
    traced.close()
    trace = os.path.join(tdir, "trace_rank0.json")
    n_events, errors = telemetry.validate(trace)
    assert not errors and n_events > 0, errors
    events = json.load(open(trace))["traceEvents"]
    names = [e["name"] for e in events]
    assert names.count("step") == STEPS
    assert names.count("h2d_transfer") == 2 * STEPS
    lines = open(os.path.join(tdir, "steps.jsonl")).read().splitlines()
    assert len(lines) == STEPS
