"""The port's telemetry (hetu_tpu_torch/telemetry) against the JAX
package's (tests/test_telemetry.py): the span tracer, the metrics
registry, the Chrome-trace export, merge and check, the executor's and
the pipeline's sites, and the overhead contract. The executor cases run
the same tiny MLP and tiny GPT through both packages and compare what
they record; the only names the port does not record are the compile's
(``jit_compile``, ``jit_compiles``, ``jit_compile_ms``, the
``memory_analysis`` instant and its ``memory_*`` gauges): the port
compiles nothing (ROADMAP §3). ``test_bench_emit_requires_attribution``
reads ``bench.py`` and has no twin."""
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu.telemetry as jtel
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.ops import attention as tattn
from hetu_tpu_torch.telemetry import (NULL, MetricsRegistry, Telemetry,
                                      Tracer, merge_traces, validate)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what only a compiling executor records (the JAX package's jit path)
COMPILE_SPANS = {"jit_compile", "memory_analysis"}
COMPILE_METRICS = {"jit_compiles", "jit_compile_ms", "memory_arg_bytes",
                   "memory_out_bytes", "memory_temp_bytes",
                   "memory_alias_bytes", "memory_code_bytes"}


@pytest.fixture(autouse=True)
def _reset_global_telemetry():
    """An enabled ``telemetry=`` becomes the process default of either
    package; reset both so later tests run with telemetry off."""
    yield
    ttel._default = None
    jtel._default = None


def _env():
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_spans_nest_across_threads(tmp_path):
    """Each thread records under its own tid; nested spans stay
    contained within their parent on that tid. The threads meet at a
    barrier inside their spans: a thread's ident is reused once it has
    exited, so two threads that never overlap may share one."""
    tr = Tracer(pid=0)
    both = threading.Barrier(2)

    def work():
        with tr.span("outer"):
            both.wait(timeout=30)
            with tr.span("inner"):
                time.sleep(0.002)
            time.sleep(0.001)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    path = tr.export(str(tmp_path / "trace_rank0.json"))
    events = json.load(open(path))["traceEvents"]
    by_tid = {}
    for e in events:
        if e["ph"] == "X":
            by_tid.setdefault(e["tid"], {})[e["name"]] = e
    assert len(by_tid) == 2, "two threads must get two distinct tids"
    for named in by_tid.values():
        outer, inner = named["outer"], named["inner"]
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= \
            outer["ts"] + outer["dur"] + 0.01


def test_export_is_valid_chrome_trace(tmp_path):
    tr = Tracer(pid=3)
    with tr.span("a", bytes=128):
        pass
    tr.instant("mark", step=1)
    with tr.span("b"):
        pass
    path = tr.export(str(tmp_path / "trace_rank3.json"))
    n, errors = validate(path)
    assert not errors, errors
    events = json.load(open(path))["traceEvents"]
    assert n == len(events) >= 5          # 2 meta + 3 recorded
    ts = [e["ts"] for e in events if e["ph"] != "M"]
    assert ts == sorted(ts)
    assert all(e["pid"] == 3 for e in events)
    # the reference's validator reads the port's file alike
    assert jtel.validate(path) == (n, [])


def test_check_cli_gate(tmp_path):
    """``python -m hetu_tpu_torch.telemetry.check``: exit 0 and OK on a
    valid trace, 1 and INVALID on a broken one, 2 without arguments —
    the reference's codes."""
    tr = Tracer(pid=0)
    with tr.span("x"):
        pass
    good = tr.export(str(tmp_path / "trace_rank0.json"))
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"traceEvents": [{"name": "x", "ph": "X"}]}, f)
    typed = str(tmp_path / "typed.json")
    with open(typed, "w") as f:     # a known span with a mistyped attr
        json.dump({"traceEvents": [{"name": "h2d_transfer", "ph": "X",
                                    "ts": 1, "dur": 1, "pid": 0, "tid": 0,
                                    "args": {"bytes": "8",
                                             "overlapped": False}}]}, f)
    cli = [sys.executable, "-m", "hetu_tpu_torch.telemetry.check"]
    ok = subprocess.run(cli + [good], capture_output=True, text=True,
                        env=_env())
    assert ok.returncode == 0 and "OK" in ok.stdout, ok.stdout + ok.stderr
    for path in (bad, typed):
        nok = subprocess.run(cli + [path], capture_output=True,
                             text=True, env=_env())
        assert nok.returncode == 1 and "INVALID" in nok.stdout
    loose = subprocess.run(cli + ["--no-attrs", typed], capture_output=True,
                           text=True, env=_env())
    assert loose.returncode == 0, loose.stdout
    usage = subprocess.run(cli, capture_output=True, text=True, env=_env())
    assert usage.returncode == 2


def test_span_schema_holds_the_reference_schema():
    """The port's schema is the reference's, every entry, plus the
    spans only the port emits: the collective pipeline's tick and
    ``GroupComm``'s collectives."""
    from hetu_tpu.telemetry.check import SPAN_SCHEMA as ref
    from hetu_tpu_torch.telemetry.check import SPAN_SCHEMA as mine
    for name, spec in ref.items():
        assert mine[name] == spec, name
    assert set(mine) - set(ref) == {
        "cpp_tick", "allreduce", "collective_all_gather",
        "collective_all_to_all", "collective_ring"}


def test_ring_is_bounded():
    tr = Tracer(pid=0, capacity=16)
    for i in range(100):
        tr.instant(f"e{i}")
    events = [e for e in tr.drain() if e["ph"] != "M"]
    assert len(events) == 16
    assert events[-1]["name"] == "e99"    # newest survive


def test_merge_assigns_distinct_pids(tmp_path):
    for rank in range(2):
        tr = Tracer(pid=rank)
        with tr.span(f"work_r{rank}"):
            pass
        tr.export(str(tmp_path / f"trace_rank{rank}.json"))
    merged = merge_traces(str(tmp_path))
    assert merged.endswith("trace_merged.json")
    n, errors = validate(merged)
    assert not errors, errors
    events = json.load(open(merged))["traceEvents"]
    assert {e["pid"] for e in events} == {0, 1}
    assert {"work_r0", "work_r1"} <= {e["name"] for e in events}


def test_merge_three_ranks_skewed_anchors_one_truncated(tmp_path, capsys):
    """Skewed wall anchors and one rank's file torn mid-export: distinct
    pids, per-rank monotonic ts, the torn rank's prefix salvaged."""
    for rank in range(3):
        tr = Tracer(pid=rank)
        tr._anchor_wall_ns += rank * 3_000_000_000
        for i in range(4):
            with tr.span(f"r{rank}_e{i}", idx=i):
                time.sleep(0.001)
        tr.export(str(tmp_path / f"trace_rank{rank}.json"))
    p2 = tmp_path / "trace_rank2.json"
    text = p2.read_text()
    p2.write_text(text[: int(len(text) * 0.6)])
    merged = merge_traces(str(tmp_path))
    assert "salvaged" in capsys.readouterr().out
    events = json.load(open(merged))["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    assert {e["pid"] for e in spans} == {0, 1, 2}
    assert 0 < len([e for e in spans if e["pid"] == 2]) < 4
    for pid in (0, 1, 2):
        ts = [e["ts"] for e in events
              if e.get("pid") == pid and e.get("ph") != "M"]
        assert ts == sorted(ts), f"rank {pid} ts not monotonic"
    t0 = min(e["ts"] for e in spans if e["pid"] == 0)
    t1 = min(e["ts"] for e in spans if e["pid"] == 1)
    assert t1 - t0 > 1_000_000
    assert validate(merged) == (len(events), [])


def test_merge_remaps_colliding_pids(tmp_path):
    for i in range(2):
        tr = Tracer(pid=0)
        with tr.span(f"f{i}"):
            pass
        tr.export(str(tmp_path / f"trace_{i}.json"))
    merged = merge_traces([str(tmp_path / "trace_0.json"),
                           str(tmp_path / "trace_1.json")],
                          str(tmp_path / "m.json"))
    events = json.load(open(merged))["traceEvents"]
    assert len({e["pid"] for e in events}) == 2


def test_merge_matches_the_reference_merge(tmp_path):
    """The port's per-rank files merged by the port and by the
    reference's ``merge_traces`` come out the same."""
    for rank in range(2):
        tr = Tracer(pid=rank)
        for i in range(3):
            with tr.span("work", rank=rank, i=i):
                pass
            tr.instant("mark", i=i)
        tr.export(str(tmp_path / f"trace_rank{rank}.json"))
    mine = merge_traces(str(tmp_path), str(tmp_path / "mine.json"))
    ref = jtel.merge_traces([str(tmp_path / f"trace_rank{r}.json")
                             for r in range(2)],
                            str(tmp_path / "ref.json"))
    assert json.load(open(mine)) == json.load(open(ref))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_histogram_percentiles_match_numpy():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms")
    sample = np.random.RandomState(7).gamma(2.0, 3.0, size=1000)
    for v in sample:
        h.observe(v)
    for q in (50, 95, 99):
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(sample, q)), rel=1e-12)
    snap = h.snapshot()
    assert snap["count"] == 1000
    assert snap["p50"] == pytest.approx(float(np.percentile(sample, 50)))


def test_registry_exports_jsonl_and_prometheus(tmp_path):
    """JSONL and Prometheus text, equal to the reference registry's on
    the same observations."""
    regs = (MetricsRegistry(), jtel.MetricsRegistry())
    for reg in regs:
        reg.counter("h2d_bytes").inc(4096)
        reg.gauge("bubble_fraction").set(0.25)
        h = reg.histogram("step wall ms")      # name needs sanitizing
        for v in (1.0, 2.0, 3.0):
            h.observe(v)
    reg = regs[0]
    by_name = {l["name"]: l for l in map(json.loads,
                                         reg.to_jsonl().splitlines())}
    assert by_name["h2d_bytes"]["value"] == 4096
    assert by_name["step wall ms"]["p50"] == 2.0
    prom = reg.to_prometheus()
    assert "# TYPE h2d_bytes counter" in prom
    assert "# TYPE bubble_fraction gauge" in prom
    assert 'step_wall_ms{quantile="0.5"} 2.0' in prom
    assert "step_wall_ms_count 3" in prom
    assert prom == regs[1].to_prometheus()
    assert reg.to_jsonl() == regs[1].to_jsonl()
    path = reg.dump_jsonl(str(tmp_path / "m.jsonl"))
    assert len(open(path).read().splitlines()) == 3


def test_prometheus_http_scrape():
    import urllib.request
    reg = MetricsRegistry()
    reg.counter("scrapes").inc(5)
    port = reg.serve(0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "scrapes 5" in body
    finally:
        reg.close()


# ---------------------------------------------------------------------------
# overhead contract
# ---------------------------------------------------------------------------

def test_disabled_span_zero_allocations():
    """Telemetry off: span() returns one shared no-op context manager —
    zero net per-step allocations on the hot path."""
    assert not NULL.enabled
    assert NULL.span("a") is NULL.span("b")
    assert NULL.flight_start("p2p", "x") is None
    for _ in range(200):
        with NULL.span("step"):
            pass
        NULL.inc("x")
        NULL.observe("y", 1.0)
    gc.collect()
    gc.disable()
    try:
        before = sys.getallocatedblocks()
        for _ in range(5000):
            with NULL.span("step"):
                pass
            NULL.inc("x")
            NULL.flight_complete(NULL.flight_start("p2p", "x"))
        after = sys.getallocatedblocks()
    finally:
        gc.enable()
    assert after - before <= 8, \
        f"disabled span leaked {after - before} blocks over 5000 steps"


def _retained_blocks(exe, feeds, warm=500, steps=2000):
    """Blocks still allocated after ``steps`` more steps of ``exe`` than
    before them (garbage collected at both ends, after ``warm`` steps
    that fill the executor's caches). A per-step record that lives, as
    an enabled trace's spans do, adds at least one block a step."""
    for _ in range(warm):
        exe.run(feed_dict=feeds)
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(steps):
        exe.run(feed_dict=feeds)
    gc.collect()
    return sys.getallocatedblocks() - before


def test_disabled_executor_step_allocates_no_telemetry():
    """The executor with telemetry off holds the shared NULL instance,
    no step logger and no heartbeat, and its steps leave nothing behind:
    2000 steps retain fewer blocks than a quarter of one a step."""
    x, y_, loss, train = _mlp(tht)
    exe = tht.Executor([loss, train], ctx=tht.cpu(0))
    assert exe.config.telemetry is NULL
    assert exe.step_logger is None and exe._heartbeat is None
    rng = np.random.RandomState(0)
    grown = _retained_blocks(exe, _mlp_feeds(x, y_, rng))
    assert grown < 2000 // 4, f"2000 disabled steps kept {grown} blocks"
    assert NULL.tracer is None and NULL.metrics is None \
        and NULL.flight is None


@pytest.mark.parametrize("mode", [
    dict(gpipe=True), dict(pipedream=True),
    dict(pipeline_mode="collective")],
    ids=["gpipe", "1f1b", "collective"])
def test_disabled_pipeline_step_allocates_nothing(mode):
    """A two-stage pipeline step (M=4) with telemetry off goes through
    the runners' shared no-op span and keeps nothing: 2000 steps retain
    fewer blocks than a quarter of one a step (the same steps with an
    enabled trace keep tens a step)."""
    rng = np.random.RandomState(0)
    with tht.context(tht.cpu(0)):
        x = tht.Variable("da_x", trainable=False)
        w1 = tht.Variable("da_w1", value=rng.randn(6, 6).astype("f"))
        a = tht.relu_op(tht.matmul_op(x, w1))
    with tht.context(tht.cpu(1)):
        w2 = tht.Variable("da_w2", value=rng.randn(6, 6).astype("f"))
        y_ = tht.Variable("da_y", trainable=False)
        loss = tht.reduce_mean_op(tht.softmaxcrossentropy_op(
            tht.matmul_op(a, w2), y_), [0])
        train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    exe = tht.Executor([loss, train], num_microbatches=4, device="cpu",
                       **mode)
    assert exe.config.telemetry is NULL
    feeds = {x: rng.randn(8, 6).astype("f"),
             y_: np.eye(6, dtype="f")[rng.randint(0, 6, 8)]}
    grown = _retained_blocks(exe, feeds)
    assert grown < 2000 // 4, f"2000 disabled steps kept {grown} blocks"


def test_overhead_guard_traced_step_under_1pct():
    """The reference's per-site guard: 32 disabled instrumentation sites
    cost under 1% of the median step of a 128x3072 -> 1024 -> 10 MLP
    (deterministic: sites x per-site cost against the step)."""
    rng = np.random.RandomState(0)
    x = tht.Variable("ov_x", trainable=False)
    y_ = tht.Variable("ov_y", trainable=False)
    w1 = tht.init.xavier_normal((3072, 1024), name="ov_w1")
    w2 = tht.init.xavier_normal((1024, 10), name="ov_w2")
    h = tht.relu_op(tht.matmul_op(x, w1))
    loss = tht.reduce_mean_op(
        tht.softmaxcrossentropy_op(tht.matmul_op(h, w2), y_), [0])
    train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    exe = tht.Executor([loss, train], ctx=tht.cpu(0))
    assert not exe.config.telemetry.enabled
    feeds = {x: rng.randn(128, 3072).astype("f"),
             y_: np.eye(10, dtype="f")[rng.randint(0, 10, 128)]}
    for _ in range(3):
        exe.run(feed_dict=feeds)
    times = []
    for _ in range(15):
        t0 = time.perf_counter()
        exe.run(feed_dict=feeds)[0].asnumpy()
        times.append(time.perf_counter() - t0)
    step_ms = float(np.median(times)) * 1000
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with NULL.span("site"):
            pass
    per_site_ms = (time.perf_counter() - t0) / n * 1000
    assert 32 * per_site_ms < 0.01 * step_ms, (per_site_ms, step_ms)


# ---------------------------------------------------------------------------
# executor integration, both packages
# ---------------------------------------------------------------------------

def _mlp(ht):
    x = ht.Variable("tel_x", trainable=False)
    y_ = ht.Variable("tel_y", trainable=False)
    w1 = ht.init.xavier_normal((16, 12), name="tel_w1")
    w2 = ht.init.xavier_normal((12, 4), name="tel_w2")
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return x, y_, loss, train


def _mlp_feeds(x, y_, rng):
    return {x: rng.randn(8, 16).astype("f"),
            y_: np.eye(4, dtype="f")[rng.randint(0, 4, 8)]}


GPT_CFG = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64,
               hidden_dropout_prob=0.0, use_flash_attention=True)


def _gpt(ht, models):
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = models.GPTLMHeadModel(models.GPTConfig(**GPT_CFG))(ids,
                                                                 labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    train = ht.optim.AdamOptimizer(learning_rate=1e-3).minimize(lm)
    return ids, labels, lm, train


def _gpt_feeds(ids, labels, rng):
    x = rng.randint(0, 40, (2, 64))
    y = np.concatenate([x[:, 1:], np.full((2, 1), -1)], axis=1)
    return {ids: x, labels: y}


def _traced_run(package, model, out_dir):
    """3 steps of ``model`` with an enabled Telemetry writing to
    ``out_dir``; returns (losses, telemetry, trace path)."""
    ht, models, T = {"jax": (jht, JM, jtel.Telemetry),
                     "port": (tht, TM, Telemetry)}[package]
    if model == "mlp":
        a, b, loss, train = _mlp(ht)
        feeds = _mlp_feeds
    else:
        a, b, loss, train = _gpt(ht, models)
        feeds = _gpt_feeds
    tel = T(enabled=True, out_dir=str(out_dir), rank=0)
    kw = {"ctx": tht.cpu(0)} if package == "port" else {}
    exe = ht.Executor([loss, train], telemetry=tel, **kw)
    rng = np.random.RandomState(0)
    losses = [float(exe.run(feed_dict=feeds(a, b, rng))[0].asnumpy())
              for _ in range(3)]
    exe.close()
    return losses, tel, os.path.join(str(out_dir), "trace_rank0.json")


def _names(trace):
    return {e["name"] for e in json.load(open(trace))["traceEvents"]
            if e["ph"] != "M"}


@pytest.mark.parametrize("model", ["mlp", "gpt"])
def test_executor_telemetry_end_to_end(tmp_path, monkeypatch, model):
    """The same model, seed and feeds in both packages: the port's trace
    validates under both validators, its span names and metric names
    are the reference's but the compile's, ``h2d_bytes`` and the
    ``step_wall_ms`` count are equal, and the per-rank files are
    flushed by ``close()``."""
    monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    j_losses, jt, jtrace = _traced_run("jax", model, tmp_path / "jax")
    t_losses, tt, ttrace = _traced_run("port", model, tmp_path / "port")
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    for check in (validate, jtel.validate):
        n, errors = check(ttrace)
        assert not errors and n > 0, errors
    assert _names(ttrace) == _names(jtrace) - COMPILE_SPANS
    assert {"step", "device_dispatch", "h2d_transfer"} <= _names(ttrace)
    assert set(tt.metrics.names()) == \
        set(jt.metrics.names()) - COMPILE_METRICS
    assert tt.counter_value("h2d_bytes") == jt.counter_value("h2d_bytes") > 0
    assert tt.metrics.histogram("step_wall_ms").count == \
        jt.metrics.histogram("step_wall_ms").count == 3
    steps = [e for e in json.load(open(ttrace))["traceEvents"]
             if e["name"] == "step"]
    assert len(steps) == 3
    out = os.listdir(tmp_path / "port")
    assert {"trace_rank0.json", "metrics_rank0.jsonl",
            "flight_rank0.json"} <= set(out)
    metrics = [json.loads(l) for l in
               open(tmp_path / "port" / "metrics_rank0.jsonl")]
    assert any(m["name"] == "step_wall_ms" and "p50" in m
               for m in metrics)


def test_traced_losses_equal_untraced(tmp_path):
    """Telemetry records host spans only: the losses with it on are the
    losses with it off, bit for bit."""
    def losses(telemetry):
        x, y_, loss, train = _mlp(tht)
        exe = tht.Executor([loss, train], ctx=tht.cpu(0),
                           telemetry=telemetry)
        rng = np.random.RandomState(0)
        return [exe.run(feed_dict=_mlp_feeds(x, y_, rng))[0].asnumpy()
                for _ in range(3)]
    off = losses(None)
    on = losses(str(tmp_path / "tel"))
    np.testing.assert_array_equal(on, off)


def test_env_enables_the_process_default(tmp_path, monkeypatch):
    """``HETU_TELEMETRY`` (the launcher's ``--telemetry``) enables an
    executor made with ``telemetry=None``; two executors writing to one
    directory share one instance."""
    monkeypatch.setenv("HETU_TELEMETRY", str(tmp_path))
    ttel._default = None
    x, y_, loss, train = _mlp(tht)
    a = tht.Executor([loss, train], ctx=tht.cpu(0))
    b = tht.Executor([loss, train], ctx=tht.cpu(0),
                     telemetry=str(tmp_path))
    assert a.config.telemetry.enabled
    assert a.config.telemetry is b.config.telemetry
    a.run(feed_dict=_mlp_feeds(x, y_, np.random.RandomState(0)))
    a.close()
    assert (tmp_path / "trace_rank0.json").exists()


def test_run_batches_is_one_step_block(tmp_path):
    """``run_batches`` records one ``step_block`` span over its steps."""
    tel = Telemetry(enabled=True, rank=0)
    x, y_, loss, train = _mlp(tht)
    exe = tht.Executor([loss, train], ctx=tht.cpu(0), telemetry=tel)
    rng = np.random.RandomState(0)
    exe.run_batches([_mlp_feeds(x, y_, rng) for _ in range(4)])
    events = [e for e in tel.tracer.drain() if e["ph"] == "X"]
    blocks = [e for e in events if e["name"] == "step_block"]
    assert len(blocks) == 1 and blocks[0]["args"]["steps"] == 4
    assert sum(e["name"] == "device_dispatch" for e in events) == 4


def test_executor_pipeline_bubble_metric():
    """GPipe at S=2, M=4 observes the analytic bubble (S-1)/(M+S-1) =
    0.2 a step, as the reference's pipeline does; every stage walk is a
    pp_fwd_block / pp_bwd_block span."""
    def run(ht):
        tel = (Telemetry if ht is tht else jtel.Telemetry)(enabled=True,
                                                          rank=0)
        rng = np.random.RandomState(0)
        with ht.context(ht.cpu(0)):
            x = ht.Variable("tb_x", trainable=False)
            w1 = ht.Variable("tb_w1", value=rng.randn(8, 6).astype("f"))
            a = ht.relu_op(ht.matmul_op(x, w1))
        with ht.context(ht.cpu(1)):
            w2 = ht.Variable("tb_w2", value=rng.randn(6, 3).astype("f"))
            y_ = ht.Variable("tb_y", trainable=False)
            loss = ht.reduce_mean_op(
                ht.softmaxcrossentropy_op(ht.matmul_op(a, w2), y_), [0])
            train = ht.optim.SGDOptimizer(0.1).minimize(loss)
        kw = {"device": "cpu"} if ht is tht else {}
        exe = ht.Executor([loss, train], gpipe=True, num_microbatches=4,
                          telemetry=tel, **kw)
        feeds = {x: rng.randn(8, 8).astype("f"),
                 y_: np.eye(3, dtype="f")[rng.randint(0, 3, 8)]}
        for _ in range(2):
            exe.run(feed_dict=feeds)
        return tel
    for tel in (run(tht), run(jht)):
        h = tel.metrics.histogram("pp_bubble_fraction")
        assert h.count == 2
        assert h.percentile(50) == pytest.approx(0.2)
    names = [e["name"] for e in tel_events(run(tht))]
    assert names.count("pp_fwd_block") == 2 * 2 * 4
    assert names.count("pp_bwd_block") == 2 * 2 * 4


def tel_events(tel):
    return [e for e in tel.tracer.drain() if e["ph"] != "M"]


def test_one_f_one_b_phases_and_collective_ticks():
    """1F1B brackets its fill / steady / drain; the collective pipeline
    records one cpp_tick a tick and lane inside cpp_dispatch."""
    def staged(**kw):
        tel = Telemetry(enabled=True, rank=0)
        rng = np.random.RandomState(0)
        with tht.context(tht.cpu(0)):
            x = tht.Variable("c_x", trainable=False)
            w1 = tht.Variable("c_w1", value=rng.randn(6, 6).astype("f"))
            a = tht.relu_op(tht.matmul_op(x, w1))
        with tht.context(tht.cpu(1)):
            w2 = tht.Variable("c_w2", value=rng.randn(6, 6).astype("f"))
            y_ = tht.Variable("c_y", trainable=False)
            loss = tht.reduce_mean_op(tht.softmaxcrossentropy_op(
                tht.matmul_op(a, w2), y_), [0])
            train = tht.optim.SGDOptimizer(0.1).minimize(loss)
        exe = tht.Executor([loss, train], num_microbatches=4,
                           telemetry=tel, device="cpu", **kw)
        exe.run(feed_dict={x: rng.randn(8, 6).astype("f"),
                           y_: np.eye(6, dtype="f")[rng.randint(0, 6, 8)]})
        return [e for e in tel_events(tel)]
    names = [e["name"] for e in staged(pipedream=True)]
    assert names.count("pp_fill") == names.count("pp_drain") == 1
    assert names.count("pp_steady") == 1
    ev = staged(pipeline_mode="collective")
    ticks = [e for e in ev if e["name"] == "cpp_tick"]
    assert len(ticks) == 2 * 2 * 4          # fwd + bwd, 2 stages, M=4
    assert {t["args"]["phase"] for t in ticks} == {"fwd", "bwd"}
    disp = [e for e in ev if e["name"] == "cpp_dispatch"]
    assert len(disp) == 1 and disp[0]["args"]["ticks"] == 4 + 2 - 1
    assert [e["name"] for e in ev].count("cpp_build") == 1


def test_steplogger_compat_wrapper(tmp_path):
    """StepLogger rides the telemetry sink: the JSONL line and the
    step histogram both record."""
    tel = Telemetry(enabled=True, rank=0)
    log = str(tmp_path / "steps.jsonl")
    x, y_, loss, train = _mlp(tht)
    exe = tht.Executor([loss, train], ctx=tht.cpu(0), log_path=log,
                       telemetry=tel)
    rng = np.random.RandomState(0)
    for _ in range(2):
        exe.run(feed_dict=_mlp_feeds(x, y_, rng))
    exe.close()
    lines = [json.loads(l) for l in open(log)]
    assert len(lines) == 2 and [l["step"] for l in lines] == [0, 1]
    assert tel.metrics.histogram("steplogger_wall_ms").count == 2
    assert sum(e["name"] == "step_logged" for e in tel_events(tel)) == 2


# ---------------------------------------------------------------------------
# imports without torch
# ---------------------------------------------------------------------------

NO_TORCH = r"""
import importlib.abc, os, sys, types
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "torch" or name.startswith("torch."):
            raise ImportError("torch is blocked")
sys.meta_path.insert(0, _Block())
pkg = os.path.join(sys.argv[1], "hetu_tpu_torch")
mod = types.ModuleType("hetu_tpu_torch")
mod.__path__ = [pkg]
sys.modules["hetu_tpu_torch"] = mod
sys.path.insert(0, sys.argv[1])
import hetu_tpu_torch.telemetry as tel
for name in ("tracer", "metrics", "check", "flight", "memory",
             "watchdog"):
    importlib = __import__("importlib")
    importlib.import_module("hetu_tpu_torch.telemetry." + name)
from hetu_tpu_torch.telemetry import memory
assert memory.device_memory_stats() == {}
t = tel.Telemetry(enabled=True, out_dir=sys.argv[2], rank=0)
with t.span("step"):
    pass
t.flush()
sys.argv = [sys.argv[0], "9"]
import importlib.util
spec = importlib.util.spec_from_file_location(
    "rs", os.path.join(pkg, "ps", "run_server.py"))
rs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(rs)
import socket
s = socket.socket(); s.bind(("127.0.0.1", 0))
port = s.getsockname()[1]; s.close()
os.environ["HETU_TELEMETRY_PORT"] = str(port)
reg = rs._serve_metrics(1234, 2)
import urllib.request
body = urllib.request.urlopen(
    "http://127.0.0.1:%d/metrics" % port, timeout=5).read().decode()
assert "hetu_ps_server_port 1234" in body and "uptime" in body, body
reg.shutdown()
assert "torch" not in sys.modules
print("NO_TORCH_OK")
"""


def test_telemetry_and_server_scrape_import_without_torch(tmp_path):
    """Every telemetry module, and the PS server script's scrape, load
    and work in a process where ``import torch`` fails (the server
    process has no torch; ``check`` runs where no card is)."""
    src = tmp_path / "no_torch.py"
    src.write_text(NO_TORCH)
    proc = subprocess.run([sys.executable, str(src), REPO,
                           str(tmp_path / "tel")],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "NO_TORCH_OK" in proc.stdout, \
        proc.stdout + proc.stderr
    assert validate(str(tmp_path / "tel" / "trace_rank0.json"))[1] == []


# ---------------------------------------------------------------------------
# 2-process GPipe under the port's launcher with --telemetry
# ---------------------------------------------------------------------------

TELEMETRY_CONFIG = """
spmd: true
nodes:
  - host: localhost
    servers: 1
    workers: 2
    chief: true
"""

TELEMETRY_PP_WORKER = """
import os
import numpy as np
import hetu_tpu_torch as ht

rank = int(os.environ["HETU_PROC_ID"])
rng = np.random.RandomState(0)
with ht.context(ht.rgpu("worker0", 0)):
    x = ht.Variable("x", trainable=False)
    w1 = ht.Variable("w1", value=rng.randn(12, 16).astype("f") * 0.3)
    a = ht.relu_op(ht.matmul_op(x, w1))
with ht.context(ht.rgpu("worker1", 0)):
    w2 = ht.Variable("w2", value=rng.randn(16, 4).astype("f") * 0.3)
    y_ = ht.Variable("y_", trainable=False)
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(a, w2), y_), [0])
    train_op = ht.optim.SGDOptimizer(0.2).minimize(loss)
exe = ht.Executor([loss, train_op], gpipe=True, num_microbatches=4,
                  device="cpu")
assert exe.config.telemetry.enabled, "HETU_TELEMETRY must enable it"
assert exe.subexecutors["default"].multiproc
frng = np.random.RandomState(3)
xs = frng.randn(32, 12).astype("f")
ys = np.eye(4, dtype="f")[frng.randint(0, 4, 32)]
for _ in range(4):
    exe.run(feed_dict={x: xs, y_: ys})
exe.close()

if rank == 0:
    # a small PS-mode session on the same fleet: its phases land in
    # this rank's trace as ps:* spans
    emb = ht.Variable("tel_emb", value=rng.randn(20, 4).astype("f"))
    ids = ht.Variable("ids", trainable=False)
    yp = ht.Variable("yp", trainable=False)
    look = ht.embedding_lookup_op(emb, ids)
    flat = ht.array_reshape_op(look, (-1, 4 * 3))
    wp = ht.Variable("wp", value=rng.randn(12, 1).astype("f") * 0.1)
    out = ht.sigmoid_op(ht.matmul_op(flat, wp))
    loss2 = ht.reduce_mean_op(ht.binarycrossentropy_op(out, yp), [0])
    train2 = ht.optim.SGDOptimizer(0.1).minimize(loss2)
    exe2 = ht.Executor([loss2, train2], ctx=ht.cpu(0), comm_mode="PS")
    for _ in range(3):
        exe2.run(feed_dict={ids: frng.randint(0, 20, (8, 3)),
                            yp: frng.randint(0, 2, (8, 1)).astype("f")})
    exe2.close()
"""


def test_two_process_gpipe_merged_trace(tmp_path):
    """A 2-process GPipe job under the port's launcher with
    ``--telemetry`` yields one merged trace that the check CLI of both
    packages passes, with spans of both ranks, the pipeline's and the
    channel's spans, a PS phase span, and both ranks' metrics files."""
    from torch_ps_util import clean_fleet_env
    from hetu_tpu_torch.ps import native_lib
    native_lib.build_lib()
    cfg_path = tmp_path / "tel.yml"
    cfg_path.write_text(TELEMETRY_CONFIG)
    script = tmp_path / "worker.py"
    script.write_text(TELEMETRY_PP_WORKER)
    tdir = tmp_path / "teldir"
    env = clean_fleet_env()
    env.pop("HETU_TELEMETRY", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "hetu_tpu_torch",
                                      "run_launcher.py"),
         "-c", str(cfg_path), "--telemetry", str(tdir), sys.executable,
         str(script)], env=env, capture_output=True, text=True,
        timeout=300)
    # the job's whole output, kept beside its files and carried by every
    # failed check below (ROADMAP §3: a failure of this test once left
    # nothing to read)
    job = (f"launcher exit {proc.returncode}\n--- stdout ---\n{proc.stdout}"
           f"\n--- stderr ---\n{proc.stderr}\n--- {tdir} ---\n"
           + "\n".join(sorted(os.listdir(tdir)) if tdir.exists() else []))
    (tmp_path / "job.log").write_text(job)
    try:
        assert proc.returncode == 0
        merged = tdir / "trace_merged.json"
        assert merged.exists()
        for pkg in ("hetu_tpu_torch", "hetu_tpu"):
            check = subprocess.run(
                [sys.executable, "-m", f"{pkg}.telemetry.check",
                 str(merged)], env=_env(), capture_output=True, text=True)
            assert check.returncode == 0, check.stdout + check.stderr
        events = json.load(open(merged))["traceEvents"]
        spans = [e for e in events if e["ph"] == "X"]
        assert len({e["pid"] for e in spans}) >= 2
        names = {e["name"] for e in spans}
        assert any(n.startswith("ps:") for n in names), sorted(names)
        assert {"p2p_send", "p2p_recv", "pp_fwd_block", "pp_bwd_block",
                "pp_stage_idle"} <= names, sorted(names)
        assert (tdir / "metrics_rank0.jsonl").exists()
        assert (tdir / "metrics_rank1.jsonl").exists()
        bubble = [json.loads(l) for l in open(tdir / "metrics_rank0.jsonl")
                  if "pp_bubble_fraction" in l]
        assert bubble and bubble[0]["p50"] == pytest.approx(0.2)
    except AssertionError as e:
        raise AssertionError(f"{e}\n{job}") from e
