"""The port's black-box layer against the JAX package's
(tests/test_blackbox.py): the flight recorder's rings, the memory
accounting and OOM report, the disabled paths' zero allocations, the
heartbeat and the launcher's watchdog (a SIGKILLed rank of a 2-process
GPipe job named and the fleet shot with ``EXIT_WATCHDOG``), the salvage
of a truncated trace, and ``/healthz`` with its 503s.
The ``blackbox`` analyzer and the ``regress`` gate: each report against
the JAX package's on the same files, and both CLIs.
``test_memory_analysis_captured_at_compile`` has no counterpart (the
port compiles nothing, ROADMAP §3)."""
import gc
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import hetu_tpu.telemetry as jtel
import hetu_tpu_torch as tht
from hetu_tpu.telemetry.flight import FlightRecorder as JFlight
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.telemetry import (NULL, FlightRecorder, MetricsRegistry,
                                      Telemetry, Tracer, memory,
                                      merge_traces, validate)
from hetu_tpu_torch.telemetry.watchdog import (EXIT_WATCHDOG, FleetWatchdog,
                                               Heartbeat)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_global_telemetry():
    yield
    ttel._default = None


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _without_times(doc):
    doc = dict(doc, pid=None, wall=None,
               steps=[s for s, _ in doc["steps"]])
    doc["events"] = [dict(e, t0=None, t1=e["t1"] is not None)
                     for e in doc["events"]]
    return doc


def test_flight_ring_wraparound(tmp_path):
    """Only the newest ``capacity`` events survive; a record completed
    after its slot was recycled does not corrupt the ring. The dump is
    the reference's, field for field (times aside)."""
    docs = []
    for cls in (FlightRecorder, JFlight):
        fr = cls(rank=0, capacity=8)
        early = fr.start("p2p", "p2p_recv", peer=1, tag="early")
        for i in range(30):
            fr.record("collective", "cpp_dispatch", tag=f"step{i}")
        fr.complete(early)
        fr.step(29)
        out = tmp_path / cls.__module__
        docs.append(json.load(open(fr.dump(str(out), reason="test"))))
    doc = docs[0]
    assert len(doc["events"]) == 8
    assert [e["seq"] for e in doc["events"]] == list(range(22, 30))
    assert all(e["t1"] is not None for e in doc["events"])
    assert doc["last_step"] == 29 and doc["reason"] == "test"
    assert _without_times(docs[0]) == _without_times(docs[1])


def test_flight_step_ring_survives_event_volume():
    fr = FlightRecorder(rank=0, capacity=4, step_capacity=16)
    for s in range(3):
        fr.step(s)
        for _ in range(50):
            fr.record("ps", "ps_pull", nbytes=4)
    snap = fr.snapshot()
    assert [s for s, _ in snap["steps"]] == [0, 1, 2]
    assert all(e["step"] == 2 for e in snap["events"])


def test_flight_crash_reason_survives_flush(tmp_path):
    fr = FlightRecorder(rank=3)
    fr.dump(str(tmp_path), reason="signal 15")
    fr.dump(str(tmp_path), reason="flush")      # atexit re-dump
    assert json.load(open(tmp_path / "flight_rank3.json"))["reason"] == \
        "signal 15"


def test_crash_handlers_install_off_the_main_thread(tmp_path):
    """An enabled Telemetry made on a thread (a thread rank's executor)
    does not fail for ``signal.signal``; it becomes the dump target."""
    import threading
    from hetu_tpu_torch.telemetry import flight
    made = {}

    def make():
        made["tel"] = Telemetry(enabled=True, out_dir=str(tmp_path),
                                rank=5)
    t = threading.Thread(target=make)
    t.start()
    t.join()
    assert flight._current is made["tel"]
    flight._dump_current("test")
    assert json.load(open(tmp_path / "flight_rank5.json"))["reason"] == \
        "test"


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------

def test_device_memory_stats_graceful_on_cpu():
    """No card: the probe returns {} and the per-step observer is a
    no-op instead of raising, in both packages."""
    assert memory.device_memory_stats() == {}
    assert jtel.memory.device_memory_stats() == {}
    tel = Telemetry(enabled=True, rank=0)
    memory.observe_device_memory(tel)
    memory.observe_device_memory(NULL)
    assert "memory_live_bytes" not in tel.metrics.names()


def test_oom_report_names_parameters(tmp_path):
    """The report lists the largest live tensors with the named
    parameters first; ``is_oom`` recognises the allocator's error (a
    ``torch.cuda.OutOfMemoryError`` built by hand) and the reference's
    message test."""
    big = torch.zeros(256, 256)
    other = torch.zeros(512, 512)
    text = memory.oom_report(named_params={"my_table": big}, limit=5,
                             out_dir=str(tmp_path), rank=2, device="cpu")
    assert "my_table" in text and "live buffers" in text
    rows = text.splitlines()[2:]
    assert rows[0].endswith("my_table")
    assert (tmp_path / "oom_rank2.txt").read_text().strip() == text
    assert memory.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert memory.is_oom(RuntimeError("RESOURCE_EXHAUSTED: oom"))
    assert not memory.is_oom(ValueError("shapes disagree"))
    del other


def test_executor_reports_oom_before_reraising(tmp_path, monkeypatch,
                                               capsys):
    """An allocator failure in a step prints (and writes) the post-mortem
    naming the session's parameters, then re-raises."""
    x = tht.Variable("oom_x", trainable=False)
    w = tht.init.xavier_normal((16, 8), name="oom_w")
    loss = tht.reduce_mean_op(tht.matmul_op(x, w), [0, 1])
    tel = Telemetry(enabled=True, out_dir=str(tmp_path), rank=0)
    exe = tht.Executor([loss], ctx=tht.cpu(0), telemetry=tel)
    op = loss.inputs[0]

    def boom(vals, ectx):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried")
    monkeypatch.setattr(op, "compute", boom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        exe.run(feed_dict={x: np.ones((4, 16), np.float32)})
    report = (tmp_path / "oom_rank0.txt").read_text()
    assert "oom_w" in report
    assert "OOM post-mortem" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the disabled paths
# ---------------------------------------------------------------------------

def test_disabled_flight_zero_allocations():
    assert NULL.flight_start("p2p", "p2p_recv") is None
    for _ in range(200):
        NULL.flight_complete(NULL.flight_start("p2p", "x"))
        NULL.flight_step(1)
    gc.collect()
    gc.disable()
    try:
        before = sys.getallocatedblocks()
        for _ in range(5000):
            NULL.flight_complete(NULL.flight_start("p2p", "x"))
            NULL.flight_step(1)
        after = sys.getallocatedblocks()
    finally:
        gc.enable()
    assert after - before <= 8, \
        f"disabled flight path leaked {after - before} blocks"


def test_disabled_pipeline_sites_share_one_null_span():
    """The pipeline's stage spans and 1F1B phases are the shared no-op
    with telemetry off (no kwargs dict, no record)."""
    from hetu_tpu_torch.parallel import pipeline
    rng = np.random.RandomState(0)
    with tht.context(tht.cpu(0)):
        x = tht.Variable("dp_x", trainable=False)
        w1 = tht.Variable("dp_w1", value=rng.randn(4, 4).astype("f"))
        a = tht.relu_op(tht.matmul_op(x, w1))
    with tht.context(tht.cpu(1)):
        w2 = tht.Variable("dp_w2", value=rng.randn(4, 2).astype("f"))
        loss = tht.reduce_mean_op(tht.matmul_op(a, w2), [0, 1])
        train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    exe = tht.Executor([loss, train], gpipe=True, num_microbatches=2,
                       device="cpu")
    sub = exe.subexecutors["default"]
    assert sub.config.telemetry is NULL
    assert sub._stage_span("pp_fwd_block", 0) is pipeline._NULL_CM
    assert pipeline._NULL_CM is ttel._NULL_SPAN
    exe.run(feed_dict={x: rng.randn(4, 4).astype("f")})


# ---------------------------------------------------------------------------
# heartbeat + watchdog
# ---------------------------------------------------------------------------

def test_heartbeat_throttles_and_marks_done(tmp_path):
    hb = Heartbeat(str(tmp_path), rank=2, interval=30.0)
    first = json.load(open(tmp_path / "hb_rank2.json"))
    assert first["pid"] == os.getpid() and not first["done"]
    hb.beat()                      # inside the interval: no write
    assert json.load(open(tmp_path / "hb_rank2.json"))["step"] == 0
    hb.beat(5)                     # a new step writes after a short floor
    time.sleep(0.06)
    hb.beat(5)
    hb.done()
    doc = json.load(open(tmp_path / "hb_rank2.json"))
    assert doc["done"] and doc["step"] == 5


def test_watchdog_check_stall_semantics(tmp_path):
    wd = FleetWatchdog(str(tmp_path), num_workers=2, timeout=5.0)
    wd.started = time.time() - 120
    now = time.time()
    for rank, age in enumerate((1.0, 60.0)):
        with open(tmp_path / f"hb_rank{rank}.json", "w") as f:
            json.dump({"rank": rank, "pid": 1, "step": 3,
                       "time": now - age, "done": False}, f)
    assert [r for r, _, _ in wd.check()] == [1]
    with open(tmp_path / "hb_rank1.json", "w") as f:
        json.dump({"rank": 1, "pid": 1, "step": 9,
                   "time": now - 60.0, "done": True}, f)
    assert wd.check() == []
    os.remove(tmp_path / "hb_rank0.json")
    wd.started = time.time()
    assert wd.check() == []
    wd.started = time.time() - 120
    assert [r for r, _, _ in wd.check()] == [0]


def test_watchdog_ignores_prestart_heartbeats(tmp_path):
    with open(tmp_path / "hb_rank0.json", "w") as f:
        json.dump({"rank": 0, "pid": 1, "step": 7,
                   "time": time.time() - 600, "done": False}, f)
    wd = FleetWatchdog(str(tmp_path), num_workers=1, timeout=5.0)
    assert wd.check() == []


def test_heartbeat_from_env_arms_the_executor(tmp_path, monkeypatch):
    """``HETU_WATCHDOG_DIR`` arms the executor's heartbeat: a beat a
    step, done on close."""
    monkeypatch.setenv("HETU_WATCHDOG_DIR", str(tmp_path))
    monkeypatch.setenv("HETU_HANG_TIMEOUT", "5")
    monkeypatch.setenv("HETU_PROC_ID", "1")
    x = tht.Variable("hb_x", trainable=False)
    w = tht.init.xavier_normal((4, 2), name="hb_w")
    loss = tht.reduce_mean_op(tht.matmul_op(x, w), [0, 1])
    exe = tht.Executor([loss], ctx=tht.cpu(0))
    assert exe._heartbeat is not None and exe._heartbeat.rank == 1
    for _ in range(3):
        exe.run(feed_dict={x: np.ones((2, 4), np.float32)})
        time.sleep(0.06)
    exe.close()
    doc = json.load(open(tmp_path / "hb_rank1.json"))
    assert doc["done"] and doc["step"] >= 2


WATCHDOG_CONFIG = """
spmd: true
nodes:
  - host: localhost
    workers: 2
    chief: true
"""

WATCHDOG_WORKER = """
import os, time
import numpy as np
import hetu_tpu_torch as ht

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
assert exe._heartbeat is not None, "HETU_WATCHDOG_DIR must arm it"
frng = np.random.RandomState(3)
xs = frng.randn(32, 12).astype("f")
ys = np.eye(4, dtype="f")[frng.randint(0, 4, 32)]
# rank 1 idles between steps, so rank 0 waits in a recv most of the time
pause = 0.05 if os.environ["HETU_PROC_ID"] == "0" else 0.3
for _ in range(600):
    exe.run(feed_dict={x: xs, y_: ys})
    time.sleep(pause)
exe.close()
"""


def test_watchdog_names_sigkilled_rank(tmp_path):
    """SIGKILL one rank of a 2-process GPipe job under the port's
    launcher with ``--hang-timeout``: the watchdog fires within the
    timeout, the fleet exits with ``EXIT_WATCHDOG``, the survivor's
    stacks and flight ring are dumped, and the flight dump shows where
    it waited on the dead peer."""
    from torch_ps_util import clean_fleet_env
    cfg = tmp_path / "wd.yml"
    cfg.write_text(WATCHDOG_CONFIG)
    script = tmp_path / "worker.py"
    script.write_text(WATCHDOG_WORKER)
    tdir = tmp_path / "teldir"
    env = clean_fleet_env()
    env.pop("HETU_TELEMETRY", None)
    hang_timeout = 8.0
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "hetu_tpu_torch",
                                      "run_launcher.py"), "-c", str(cfg),
         "--telemetry", str(tdir), "--hang-timeout", str(hang_timeout),
         sys.executable, str(script)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    victim_pid = None
    try:
        hb1 = tdir / "hb_rank1.json"
        deadline = time.time() + 180
        while time.time() < deadline and proc.poll() is None:
            try:
                doc = json.loads(hb1.read_text())
                if doc.get("step", 0) >= 2:
                    victim_pid = doc["pid"]
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.2)
        assert victim_pid is not None, \
            (proc.poll(), tdir.exists() and sorted(os.listdir(tdir)))
        t_kill = time.time()
        os.kill(victim_pid, signal.SIGKILL)
        out, _ = proc.communicate(timeout=120)
        fired_after = time.time() - t_kill
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == EXIT_WATCHDOG, (proc.returncode, out)
    assert fired_after < hang_timeout + 30, fired_after
    assert "watchdog: rank 1 stalled" in out, out
    assert (tdir / "flight_rank0.json").exists(), sorted(os.listdir(tdir))
    assert not (tdir / "flight_rank1.json").exists()
    dump0 = json.loads((tdir / "flight_rank0.json").read_text())
    # the survivor is mostly caught waiting in a recv on the dead peer:
    # the watchdog's SIGUSR1 dumps its stacks and SIGTERM its ring, with
    # the recv pending; a kill while rank 0 sends breaks its channel
    # instead, and its excepthook dumps with an "uncaught" reason
    if dump0["reason"].startswith("uncaught"):
        assert "BrokenPipe" in dump0["reason"] \
            or "Connection" in dump0["reason"], dump0["reason"]
    else:
        assert dump0["reason"] == f"signal {int(signal.SIGTERM)}"
        stacks = tdir / "stacks_rank0.log"
        assert stacks.exists() and "Thread" in stacks.read_text()
        pend = [e for e in dump0["events"] if e["t1"] is None]
        assert pend and pend[-1]["group"] in ("p2p", "sched"), pend
    assert any(e["kind"].startswith("p2p_") for e in dump0["events"])


CRASH_WORKER = WATCHDOG_WORKER.split("exe.close()")[0].replace(
    "for _ in range(600):", "for _ in range(2):") + """
raise RuntimeError("a bug of the script, not a hang")
"""


def test_watchdog_reports_a_crash_at_once(tmp_path):
    """Under ``--hang-timeout`` a job whose ranks all exit on an
    uncaught exception returns their exit code (1) as soon as they have
    exited, as the reference's wait does: no stall is named and the
    timeout is not waited out (a crash is not a hang)."""
    from torch_ps_util import clean_fleet_env
    cfg = tmp_path / "wd.yml"
    cfg.write_text(WATCHDOG_CONFIG)
    script = tmp_path / "worker.py"
    script.write_text(CRASH_WORKER)
    env = clean_fleet_env()
    env.pop("HETU_TELEMETRY", None)
    hang_timeout = 300.0
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "hetu_tpu_torch",
                                      "run_launcher.py"), "-c", str(cfg),
         "--telemetry", str(tmp_path / "teldir"),
         "--hang-timeout", str(hang_timeout), sys.executable, str(script)],
        env=env, capture_output=True, text=True, timeout=240)
    wall = time.time() - t0
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, (proc.returncode, out)
    assert "a bug of the script" in out and "stalled" not in out, out
    assert wall < hang_timeout, wall
    hb = json.loads((tmp_path / "teldir" / "hb_rank0.json").read_text())
    assert hb["step"] >= 1 and not hb.get("done"), hb


# ---------------------------------------------------------------------------
# truncated-trace salvage
# ---------------------------------------------------------------------------

def test_merge_salvages_truncated_trace(tmp_path, capsys):
    for rank in range(2):
        tr = Tracer(pid=rank)
        for i in range(20):
            with tr.span(f"w{rank}_{i}"):
                pass
        tr.export(str(tmp_path / f"trace_rank{rank}.json"))
    p1 = tmp_path / "trace_rank1.json"
    text = p1.read_text()
    p1.write_text(text[:int(len(text) * 0.6)])
    merged = merge_traces(str(tmp_path))
    assert "salvaged" in capsys.readouterr().out
    n, errors = validate(merged)
    assert not errors, errors
    events = json.load(open(merged))["traceEvents"]
    assert {e["pid"] for e in events} == {0, 1}
    r1 = [e for e in events if e["pid"] == 1 and e["ph"] == "X"]
    assert 0 < len(r1) < 20


# ---------------------------------------------------------------------------
# /healthz
# ---------------------------------------------------------------------------

def test_metrics_server_healthz_and_shutdown():
    import urllib.error
    import urllib.request
    reg = MetricsRegistry()
    reg.counter("x").inc()
    port = reg.serve(0)
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=5).read()
    assert json.loads(body)["ok"] is True
    reg.shutdown()
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=1)


def _post(url, timeout=5):
    import urllib.request
    req = urllib.request.Request(
        f"{url}/v1/predict",
        data=json.dumps({"inputs": {"x": [[1.0]]}}).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout).read()


def test_serving_healthz_slo_503():
    import urllib.error
    import urllib.request
    from hetu_tpu_torch.serving.http import ServingHTTPServer

    class SlowBackend:
        def predict(self, feeds):
            time.sleep(0.05)
            return [np.zeros(1)]

    srv = ServingHTTPServer(SlowBackend(), slo_p99_ms=10.0, slo_window=16)
    port = srv.start()
    try:
        url = f"http://127.0.0.1:{port}"
        body = urllib.request.urlopen(f"{url}/healthz", timeout=5).read()
        assert json.loads(body)["ok"] is True
        _post(url)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{url}/healthz", timeout=5)
        assert exc.value.code == 503
        assert "p99" in json.loads(exc.value.read())["reason"]
    finally:
        srv.stop()


def test_serving_healthz_error_rate_503():
    import urllib.error
    import urllib.request
    from hetu_tpu_torch.serving.http import ServingHTTPServer

    class FailingBackend:
        def predict(self, feeds):
            raise RuntimeError("backend down")

    srv = ServingHTTPServer(FailingBackend(), slo_error_rate=0.5,
                            slo_window=16)
    port = srv.start()
    try:
        url = f"http://127.0.0.1:{port}"
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(url)
        assert exc.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{url}/healthz", timeout=5)
        assert exc.value.code == 503
        assert "error rate" in json.loads(exc.value.read())["reason"]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the black-box analyzer and the regression gate
# ---------------------------------------------------------------------------

def _cli_env():
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def _write_dump(tmp_path, rank, events, last_step=0, nprocs=2):
    doc = {"rank": rank, "pid": 1000 + rank, "nprocs": nprocs,
           "wall": time.time(), "last_step": last_step,
           "steps": [[last_step, time.time()]], "events": events,
           "reason": "flush"}
    with open(tmp_path / f"flight_rank{rank}.json", "w") as f:
        json.dump(doc, f)


def _coll(seq, kind="cpp_dispatch", t1=1.0):
    return {"seq": seq, "group": "collective", "kind": kind,
            "peer": None, "tag": f"s{seq}", "bytes": 0, "step": seq,
            "t0": 1.0, "t1": t1}


def _both_reports(tdir):
    """The port's report and text on ``tdir``, held equal to the JAX
    package's (its report, and its text up to the module path the
    health line names)."""
    from hetu_tpu.telemetry import blackbox as jbb
    from hetu_tpu_torch.telemetry import blackbox as tbb
    rep, want = tbb.analyze(str(tdir)), jbb.analyze(str(tdir))
    assert rep == want
    text = tbb.format_report(rep)
    assert text == jbb.format_report(want).replace(
        "hetu_tpu.telemetry", "hetu_tpu_torch.telemetry")
    return rep, text


def test_blackbox_seq_divergence(tmp_path):
    """Rank 0 entered collective seq 4 that rank 1 never did -> rank 1
    is the laggard/suspect and the divergence names the op."""
    _write_dump(tmp_path, 0, [_coll(s) for s in range(5)], last_step=4)
    _write_dump(tmp_path, 1, [_coll(s) for s in range(4)], last_step=3)
    rep, text = _both_reports(tmp_path)
    d = rep["divergence"]
    assert d is not None
    assert d["seq"] == 4 and d["ahead"] == [0] and d["behind"] == [1]
    assert d["event"]["kind"] == "cpp_dispatch"
    assert rep["suspect_ranks"] == [1]
    assert "DIVERGENCE at collective seq 4" in text


def test_blackbox_dead_rank_and_pending(tmp_path):
    """A rank with a heartbeat but no flight dump is dead; a surviving
    rank's pending recv corroborates by naming the peer."""
    pending = {"seq": 0, "group": "p2p", "kind": "p2p_recv", "peer": 1,
               "tag": "f3:77:1", "bytes": 0, "step": 3, "t0": 5.0,
               "t1": None}
    _write_dump(tmp_path, 0, [pending], last_step=3)
    for rank, step in ((0, 3), (1, 2)):
        with open(tmp_path / f"hb_rank{rank}.json", "w") as f:
            json.dump({"rank": rank, "pid": 1000 + rank, "step": step,
                       "time": time.time() - 60, "done": False}, f)
    rep, text = _both_reports(tmp_path)
    assert rep["dead_ranks"] == [1]
    assert rep["suspect_ranks"] == [1]
    assert rep["ranks"]["0"]["pending"][0]["kind"] == "p2p_recv"
    assert "NO flight dump" in text and "PENDING p2p_recv" in text
    # a pending PS RPC: the wire cross-reference waits for analysis/
    # wire.py (ROADMAP item 17), so the port names the event alone
    ps = {"seq": 1, "group": "ps", "kind": "ps_sparse_pull", "peer": None,
          "tag": "tid7", "bytes": 0, "step": 3, "t0": 6.0, "t1": None}
    _write_dump(tmp_path, 0, [pending, ps], last_step=3)
    from hetu_tpu_torch.telemetry import blackbox as tbb
    rep = tbb.analyze(str(tmp_path))
    assert [e["kind"] for e in rep["ranks"]["0"]["pending"]] == \
        ["p2p_recv", "ps_sparse_pull"]
    assert "wire" not in rep["ranks"]["0"]["pending"][1]
    assert rep["fleet"] is None


def test_blackbox_cli(tmp_path):
    _write_dump(tmp_path, 0, [_coll(0)], last_step=1)
    out = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.blackbox",
         str(tmp_path), "--json"],
        capture_output=True, text=True, env=_cli_env())
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert "0" in rep["ranks"]
    text = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.blackbox",
         str(tmp_path)], capture_output=True, text=True, env=_cli_env())
    assert text.returncode == 0 and "black box:" in text.stdout
    empty = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.blackbox",
         str(tmp_path / "nope")],
        capture_output=True, text=True, env=_cli_env())
    assert empty.returncode == 2


def _bench_file(path, metrics):
    lines = "\n".join(json.dumps(m) for m in metrics)
    with open(path, "w") as f:
        json.dump({"n": 1, "cmd": "bench", "rc": 0, "tail": lines,
                   "parsed": metrics[-1]}, f)


def test_regress_cli_gates_on_regression(tmp_path):
    old = tmp_path / "OLD.json"
    new_ok = tmp_path / "NEW_OK.json"
    new_bad = tmp_path / "NEW_BAD.json"
    base = [
        {"metric": "step_time", "value": 10.0, "unit": "ms/step"},
        {"metric": "tput", "value": 1000.0, "unit": "samples/sec/chip"},
        {"metric": "broken", "value": -1, "unit": "error"},
    ]
    _bench_file(old, base)
    _bench_file(new_ok, [
        {"metric": "step_time", "value": 10.9, "unit": "ms/step"},
        {"metric": "tput", "value": 950.0, "unit": "samples/sec/chip"},
        {"metric": "broken", "value": -1, "unit": "error"},
        {"metric": "fresh", "value": 1.0, "unit": "ms/step"},
    ])
    _bench_file(new_bad, [
        {"metric": "step_time", "value": 14.0, "unit": "ms/step"},
        {"metric": "tput", "value": 1000.0, "unit": "samples/sec/chip"},
    ])
    ok = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.regress",
         str(old), str(new_ok), "--tolerance", "0.15"],
        capture_output=True, text=True, env=_cli_env())
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 regression(s)" in ok.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.regress",
         str(old), str(new_bad), "--tolerance", "0.15"],
        capture_output=True, text=True, env=_cli_env())
    assert bad.returncode == 1
    assert "REGRESSED" in bad.stdout and "step_time" in bad.stdout
    assert "tput" in bad.stdout
    # the reference's gate says the same of the same files
    ref = subprocess.run(
        [sys.executable, "-m", "hetu_tpu.telemetry.regress",
         str(old), str(new_bad), "--tolerance", "0.15"],
        capture_output=True, text=True, env=_cli_env())
    assert ref.returncode == 1 and ref.stdout == bad.stdout
    # --history over the rounds, and --warn-only
    hist = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.regress",
         "--history", str(old), str(new_ok), str(new_bad)],
        capture_output=True, text=True, env=_cli_env())
    assert hist.returncode == 0 and "| step_time |" in hist.stdout
    warn = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.regress",
         str(old), str(new_bad), "--warn-only"],
        capture_output=True, text=True, env=_cli_env())
    assert warn.returncode == 0 and "[warn-only]" in warn.stdout


def test_regress_direction_inference():
    # ms-like units regress UP, throughput units regress DOWN
    from hetu_tpu.telemetry import regress as jregress
    from hetu_tpu_torch.telemetry import regress
    old = {"a": {"metric": "a", "value": 10.0, "unit": "ms/step"},
           "b": {"metric": "b", "value": 100.0, "unit": "tokens/sec"}}
    new = {"a": {"metric": "a", "value": 8.0, "unit": "ms/step"},
           "b": {"metric": "b", "value": 130.0, "unit": "tokens/sec"}}
    rows = {r[0]: r[4] for r in regress.compare(old, new, 0.15)}
    assert rows == {"a": "improved", "b": "improved"}
    assert regress.compare(old, new, 0.15) == \
        jregress.compare(old, new, 0.15)
