"""The port's ``StepLogger`` and ``trace`` (hetu_tpu_torch/profiler.py)
against the JAX package's (tests/test_profiler.py): the executor's
``log_path`` step timeline, the zero-ms step, the context manager, and
``trace(logdir)`` over ``torch.profiler``. ``profile_ops``' twin is
tests/test_torch_costdb.py's."""
import json
import os

import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu import profiler as jprof
from hetu_tpu_torch import profiler as tprof


def _mlp(ht):
    x = ht.Variable("pr_x", trainable=False)
    y_ = ht.Variable("pr_y", trainable=False)
    w1 = ht.init.xavier_normal((16, 12), name="pr_w1")
    w2 = ht.init.xavier_normal((12, 4), name="pr_w2")
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return x, y_, loss, train


def _timeline(ht, log, **kw):
    x, y_, loss, train = _mlp(ht)
    exe = ht.Executor([loss, train], log_path=log, **kw)
    rng = np.random.RandomState(0)
    for _ in range(4):
        exe.run(feed_dict={
            x: rng.randn(8, 16).astype("f"),
            y_: np.eye(4, dtype="f")[rng.randint(0, 4, 8)]})
    exe.close()      # closes the step logger too
    assert exe.step_logger is None
    return [json.loads(l) for l in open(log)]


def test_step_timeline(tmp_path):
    """One line a step, positive wall ms, steps 0..3, and the same keys
    as the reference's lines."""
    got = _timeline(tht, str(tmp_path / "port.jsonl"), ctx=tht.cpu(0))
    want = _timeline(jht, str(tmp_path / "jax.jsonl"))
    assert len(got) == len(want) == 4
    assert all(l["wall_ms"] > 0 for l in got)
    assert [l["step"] for l in got] == [0, 1, 2, 3]
    assert [sorted(l) for l in got] == [sorted(l) for l in want]
    assert {l["subgraph"] for l in got} == {"default"}


@pytest.mark.parametrize("module", [tprof, jprof], ids=["port", "jax"])
def test_steplogger_zero_ms_step_is_not_null(tmp_path, monkeypatch,
                                             module):
    """A 0.0 ms step (clock granularity) logs as 0.0, not null; only a
    step without ``begin()`` logs null."""
    class _FrozenTime:
        perf_counter = staticmethod(lambda: 123.456)

    log = str(tmp_path / "zero.jsonl")
    sl = module.StepLogger(log)
    monkeypatch.setattr(module, "time", _FrozenTime)
    sl.begin()
    sl.end()
    sl.close()
    assert json.loads(open(log).read())["wall_ms"] == 0.0
    sl2 = module.StepLogger(log)
    sl2.end()
    sl2.close()
    assert json.loads(open(log).read().splitlines()[-1])["wall_ms"] is None


def test_steplogger_context_manager_closes(tmp_path):
    log = str(tmp_path / "cm.jsonl")
    with tprof.StepLogger(log) as sl:
        sl.begin()
        sl.end(extra=1)
        assert not sl.closed
    assert sl.closed
    sl.close()          # idempotent
    lines = open(log).read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["extra"] == 1


def test_steplogger_mirrors_into_telemetry(tmp_path):
    """With an enabled Telemetry each logged step is a ``step_logged``
    instant and a ``steplogger_wall_ms`` observation, as the
    reference's."""
    from hetu_tpu_torch.telemetry import Telemetry
    tel = Telemetry(enabled=True, rank=0)
    with tprof.StepLogger(str(tmp_path / "t.jsonl"), telemetry=tel) as sl:
        for _ in range(3):
            sl.begin()
            sl.end()
    assert tel.metrics.histogram("steplogger_wall_ms").count == 3
    marks = [e for e in tel.tracer.drain() if e["name"] == "step_logged"]
    assert [m["args"]["step"] for m in marks] == [0, 1, 2]


def test_trace_exports_a_chrome_trace(tmp_path):
    """``trace(logdir)`` records the block through ``torch.profiler``
    (CPU activity here) and writes a Chrome trace into ``logdir``."""
    x, y_, loss, train = _mlp(tht)
    exe = tht.Executor([loss, train], ctx=tht.cpu(0))
    rng = np.random.RandomState(0)
    feeds = {x: rng.randn(8, 16).astype("f"),
             y_: np.eye(4, dtype="f")[rng.randint(0, 4, 8)]}
    with tprof.trace(str(tmp_path / "prof")) as prof:
        exe.run(feed_dict=feeds)
    assert prof.trace_path and os.path.dirname(prof.trace_path) == \
        str(tmp_path / "prof")
    doc = json.load(open(prof.trace_path))
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
