"""The port's fleet plane (hetu_tpu_torch/telemetry/fleet.py) against the
JAX package's (tests/test_fleet.py): straggler / victim attribution,
step alignment, the worker-side StepTimeline, the CostDB drift detector,
the FleetMonitor over flushed files and heartbeats, the ``/fleet``
endpoint, the post-hoc CLI and the black-box summary line.

The pure functions take the same records in both packages and must give
the same results exactly: they are the same Python arithmetic. The
driven twins run the same MLP through both packages' executors with the
plane armed and compare what does not depend on the clock: the steps
recorded and which buckets are non-zero. Beyond the twins: thread ranks
(one timeline a rank, ``HETU_FAULT_SLOW_RANK`` naming a thread rank),
the overhead contract held structurally, the CLIs with ``import torch``
failing, and the reference's acceptance job — two GPipe processes under
the port's launcher with ``--watch``, rank 1 slowed — named live, post
hoc and by the black box.

No twin: ``test_enabled_timeline_overhead_under_1pct``, a wall-clock
bound of the same family as ``test_health.py``'s overhead guard, which
fails under load; its twin here is structural (one ``is None`` check and
no allocation a disabled step, no device synchronization in
``on_step``)."""
import gc
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.telemetry as jtel
import hetu_tpu_torch as tht
from hetu_tpu.telemetry import fleet as jfleet
from hetu_tpu.telemetry.costdb import CostDB as JCostDB
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.telemetry import NULL, Telemetry, fleet
from hetu_tpu_torch.telemetry.costdb import CostDB, pow2_bucket
from hetu_tpu_torch.telemetry.watchdog import Heartbeat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_fleet_global(monkeypatch):
    """Tests that arm timeline_from_env register the process's live
    timelines (the crash-dump targets); never leak them into later
    tests, nor an enabled telemetry default."""
    monkeypatch.setattr(fleet, "_live", {})
    monkeypatch.setattr(jfleet, "_current", None)
    for var in ("HETU_FLEET", "HETU_FAULT_SLOW_RANK", "HETU_FAULT_SLOW_MS",
                "HETU_METRICS_PORT", "HETU_WATCHDOG_DIR"):
        monkeypatch.delenv(var, raising=False)
    yield
    ttel._default = None
    jtel._default = None


def _rec(step, wall, buckets=None, comm_bytes=None, steps=1, t=None):
    rec = {"step": step, "t": float(step if t is None else t),
           "wall_ms": float(wall), "steps": steps,
           "buckets": dict(buckets or {})}
    if comm_bytes:
        rec["comm_bytes"] = dict(comm_bytes)
    return rec


def _both(fn_name, *args, **kwargs):
    """``fn_name`` of both packages on the same arguments: (port, ref)."""
    return (getattr(fleet, fn_name)(*args, **kwargs),
            getattr(jfleet, fn_name)(*args, **kwargs))


# ---------------------------------------------------------------------------
# straggler / victim math: exact twins
# ---------------------------------------------------------------------------

WINDOWS = {
    "three_ranks": {
        0: _rec(5, 26.0, {"compute": 10.0, "collective": 16.0}),
        1: _rec(5, 26.0, {"compute": 25.0, "collective": 1.0}),
        2: _rec(5, 26.0, {"compute": 11.0, "collective": 15.0})},
    "jitter": {0: _rec(3, 10.0, {"compute": 10.0}),
               1: _rec(3, 10.5, {"compute": 10.5})},
    "one_rank": {0: _rec(3, 10.0)},
    "blocks": {0: _rec(8, 1000.0, {"compute": 600.0, "p2p": 400.0},
                       steps=100),
               1: _rec(8, 1600.0, {"compute": 1500.0, "bubble": 100.0},
                       steps=100)},
    "bubble_victim": {0: _rec(4, 130.0, {"bubble": 128.0, "compute": 2.0}),
                      1: _rec(4, 129.0, {"unaccounted": 128.0,
                                         "p2p": 1.0})},
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_attribute_skew_equals_the_reference(case):
    """The straggler, its skew and the victims: exactly the reference's
    (and the reference test's expectations on its cases)."""
    port, ref = _both("attribute_skew", WINDOWS[case])
    assert port == ref
    for r, rec in WINDOWS[case].items():
        assert fleet.rank_stats(rec) == jfleet.rank_stats(rec)
    if case == "three_ranks":
        assert port["straggler"] == 1 and port["victims"] == [0, 2]
        assert port["skew_ms"] == pytest.approx(14.5, abs=0.01)
    if case in ("jitter", "one_rank"):
        assert port["straggler"] is None and port["victims"] == []


def test_rank_stats_normalizes_block_records_by_steps():
    st = fleet.rank_stats(_rec(10, 1000.0, {"compute": 600.0,
                                            "collective": 400.0},
                               steps=100))
    assert (st["wall_ms"], st["wait_ms"], st["self_ms"]) == (10.0, 4.0,
                                                             6.0)
    assert st["top_bucket"] == "compute"


ALIGNS = {
    "newest_common": {0: [_rec(s, 10.0) for s in range(1, 6)],
                      1: [_rec(s, 10.0) for s in range(3, 8)]},
    "restart_latest_wins": {0: [_rec(4, 50.0, t=1.0), _rec(4, 12.0, t=9.0)],
                            1: [_rec(4, 11.0, t=5.0)]},
    "ragged": {0: [_rec(1, 10.0), _rec(2, 10.0)],
               1: [_rec(10, 11.0), _rec(11, 12.0)]},
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(ALIGNS))
def test_align_windows_equals_the_reference(case):
    port, ref = _both("align_windows", ALIGNS[case])
    assert port == ref
    step, window, aligned = port
    if case == "newest_common":
        assert aligned and step == 5
    elif case == "restart_latest_wins":
        assert aligned and window[0]["wall_ms"] == 12.0
    elif case == "ragged":
        assert not aligned and step == -1
        assert window[0]["step"] == 2 and window[1]["step"] == 11
    else:
        assert port == (-1, {}, False)


# ---------------------------------------------------------------------------
# StepTimeline: the same spans in both packages' tracers
# ---------------------------------------------------------------------------

def _timeline_record(pkg_tel, pkg_fleet):
    tel = pkg_tel.Telemetry(enabled=True, rank=0)
    base = 1_000_000_000
    tel.complete("device_dispatch", base + 1_000_000, base + 6_000_000)
    tel.complete("p2p_recv", base + 6_000_000, base + 9_000_000,
                 {"bytes": 2048})
    tel.complete("p2p_send", base + 2_000_000, base + 4_000_000,
                 {"bytes": 512, "overlapped": True})
    tel.complete("pp_stage_idle", base + 9_000_000, base + 9_500_000,
                 {"stage": 0, "tag": "t", "bytes": 8})
    tl = pkg_fleet.StepTimeline(tel, rank=0)
    rec = tl.on_step(7, base, base + 10_000_000, 10.0)
    return tl, {k: v for k, v in rec.items() if k != "t"}


def test_timeline_record_equals_the_reference():
    """One window's record — buckets claimed in priority order, the
    hidden span, the bytes — is the reference's, but its clock stamp."""
    tl, port = _timeline_record(ttel, fleet)
    _, ref = _timeline_record(jtel, jfleet)
    assert port == ref
    assert port["buckets"] == {"compute": 5.0, "p2p": 3.0, "bubble": 0.5,
                               "unaccounted": 1.5}
    assert port["comm_bytes"] == {"p2p": 2048 + 512}
    assert port["hidden_ms"] == pytest.approx(2.0)
    assert tl.summary() == (10.0, "compute")
    assert tl.fleet_json()["records"][-1]["step"] == 7


def test_collective_span_is_a_collective_bucket_with_bytes():
    """``GroupComm``'s spans (the port's own) land in the collective
    bucket, their bytes in ``comm_bytes`` for the drift detector."""
    tel = Telemetry(enabled=True, rank=0)
    base = 1_000_000_000
    tel.complete("device_dispatch", base, base + 8_000_000)
    tel.complete("allreduce", base + 2_000_000, base + 5_000_000,
                 {"bytes": 4096, "kind": "dense"})
    tel.complete("collective_all_gather", base + 5_000_000,
                 base + 6_000_000, {"bytes": 100, "kind": "gather"})
    rec = fleet.StepTimeline(tel, rank=0).on_step(1, base,
                                                  base + 8_000_000, 8.0)
    assert rec["buckets"] == {"collective": 4.0, "compute": 4.0}
    assert rec["comm_bytes"] == {"collective": 4196}


def test_timeline_dump_load_roundtrip_reads_in_both(tmp_path):
    tel = Telemetry(enabled=True, rank=3)
    tl = fleet.StepTimeline(tel, rank=3, out_dir=str(tmp_path), capacity=4)
    base = 1_000_000_000
    for s in range(6):          # 6 records through a 4-slot ring
        tl.on_step(s, base, base, 5.0 + s)
    assert tl.dump() == str(tmp_path / "timeline_rank3.jsonl")
    with open(tmp_path / "timeline_rank3.jsonl", "a") as f:
        f.write('{"step": 99, "wall')            # a torn tail: skipped
    port, ref = _both("load_timelines", str(tmp_path))
    assert port == ref and [r["step"] for r in port[3]] == [2, 3, 4, 5]


def test_timeline_from_env_gating_and_dump(tmp_path, monkeypatch):
    tel = Telemetry(enabled=True, out_dir=str(tmp_path), rank=0)
    assert fleet.timeline_from_env(tel) is None
    monkeypatch.setenv("HETU_FLEET", "1")
    assert fleet.timeline_from_env(NULL) is None
    assert fleet.timeline_from_env(Telemetry(enabled=True, rank=0)) is None
    tl = fleet.timeline_from_env(tel)
    assert isinstance(tl, fleet.StepTimeline) and not tl.own_thread_only
    tl.on_step(1, 1_000_000_000, 1_000_000_000, 4.0)
    assert fleet.dump_current() == str(tmp_path / "timeline_rank0.jsonl")
    # Telemetry.flush reaches it through sys.modules
    assert str(tmp_path / "timeline_rank0.jsonl") in tel.flush()
    # a thread rank's timeline is named by its rank and reads its thread
    t1 = fleet.timeline_from_env(tel, rank=1)
    assert t1.rank == 1 and t1.own_thread_only
    assert sorted(fleet._live) == [0, 1]
    t1.close()
    assert sorted(fleet._live) == [0]
    assert (tmp_path / "timeline_rank1.jsonl").exists()


def test_fault_slow_from_env_names_a_process_or_a_thread_rank(monkeypatch):
    monkeypatch.delenv("HETU_PROC_ID", raising=False)
    assert fleet.fault_slow_from_env() == 0.0
    monkeypatch.setenv("HETU_FAULT_SLOW_RANK", "1")
    assert fleet.fault_slow_from_env() == jfleet.fault_slow_from_env() \
        == 0.0
    monkeypatch.setenv("HETU_PROC_ID", "1")
    monkeypatch.setenv("HETU_FAULT_SLOW_MS", "80")
    assert fleet.fault_slow_from_env() == jfleet.fault_slow_from_env() \
        == pytest.approx(0.08)
    # a thread rank's own number, not the process's
    assert fleet.fault_slow_from_env(rank=0) == 0.0
    assert fleet.fault_slow_from_env(rank=1) == pytest.approx(0.08)


def test_heartbeat_carries_the_timeline_summary(tmp_path):
    hb = Heartbeat(str(tmp_path), rank=0, interval=0.01)
    time.sleep(0.02)
    hb.beat(step=1, step_ms=10.0, top_bucket="compute")
    doc = json.load(open(tmp_path / "hb_rank0.json"))
    assert (doc["step_ms_ema"], doc["top_bucket"]) == (10.0, "compute")
    time.sleep(0.06)
    hb.beat(step=2, step_ms=20.0, top_bucket="collective")
    doc = json.load(open(tmp_path / "hb_rank0.json"))
    assert doc["step_ms_ema"] == pytest.approx(0.8 * 10 + 0.2 * 20)
    assert doc["top_bucket"] == "collective"


# ---------------------------------------------------------------------------
# drift detector: the reference's verdicts on the same DB entries
# ---------------------------------------------------------------------------

NBYTES = 1 << 20


def _dbs(tmp_path, name, ms):
    """The same entry in a DB of each package (the port's keys name the
    CPU here, as the reference's do)."""
    port = CostDB(str(tmp_path / f"port_{name}"))
    port.record("p2p", pow2_bucket(NBYTES), "bytes", ms, nbytes=NBYTES)
    ref = JCostDB(str(tmp_path / f"ref_{name}"))
    ref.record("p2p", pow2_bucket(NBYTES), "bytes", ms, nbytes=NBYTES)
    return port, ref


@pytest.mark.parametrize("case", ["poisoned", "honest", "recovers",
                                  "empty"])
def test_drift_verdicts_equal_the_reference(tmp_path, case):
    """Every verdict and trip, window by window, is the reference's: a
    poisoned DB trips on the k-th exceeded window, once; an honest one
    and a recovered window stay clean; an empty DB is no baseline."""
    ms, measured = {"poisoned": (0.4, [10.0] * 4),
                    "honest": (9.0, [10.0] * 5),
                    "recovers": (0.4, [10.0, 10.0, 0.5, 10.0]),
                    "empty": (None, [50.0])}[case]
    if ms is None:
        dbs = (CostDB(str(tmp_path / "e1.json")),
               JCostDB(str(tmp_path / "e2.json")))
    else:
        dbs = _dbs(tmp_path, f"{case}.json", ms)
    dets = [mod.DriftDetector(db=db, k=3)
            for mod, db in zip((fleet, jfleet), dbs)]
    for m in measured:
        port, ref = (d.observe(1, "p2p", NBYTES, m) for d in dets)
        assert port == ref
    assert dets[0].trips == dets[1].trips
    assert dets[0].observe(0, "p2p", 0, 5.0) is None
    assert dets[0].tripped == (case == "poisoned")
    assert (fleet.SOUND_FACTOR, fleet.SOUND_SLACK_MS) == (3.0, 0.5)


# ---------------------------------------------------------------------------
# FleetMonitor over flushed files + /fleet endpoint + CLI
# ---------------------------------------------------------------------------

def _write_fleet_dir(tmp_path, slow_rank=1, steps=4, drift=False):
    for r in range(3):
        with open(tmp_path / f"timeline_rank{r}.jsonl", "w") as f:
            for s in range(steps):
                self_ms = 25.0 if r == slow_rank else 10.0
                rec = _rec(s, 27.0, {"compute": self_ms,
                                     "collective": 27.0 - self_ms - 2.0,
                                     "p2p": 2.0},
                           comm_bytes={"p2p": NBYTES} if drift else None,
                           t=s + r * 0.001)
                f.write(json.dumps(rec) + "\n")


def _stable(rep):
    """A report without its clock readings."""
    rep = dict(rep)
    rep.pop("time")
    rep["ranks"] = {k: {kk: vv for kk, vv in v.items()
                        if kk != "heartbeat_age_s"}
                    for k, v in rep["ranks"].items()}
    return rep


@pytest.mark.parametrize("heartbeat_only", [False, True],
                         ids=["timelines", "heartbeat_only_rank"])
def test_monitor_report_equals_the_reference(tmp_path, heartbeat_only):
    """The monitor's report over the same directory (three ranks, rank 1
    slow; or rank 2 with a heartbeat only) is the reference's, and its
    rendering too."""
    _write_fleet_dir(tmp_path)
    if heartbeat_only:
        os.remove(tmp_path / "timeline_rank2.jsonl")
        with open(tmp_path / "hb_rank2.json", "w") as f:
            json.dump({"rank": 2, "pid": 1, "step": 3, "last_step": 3,
                       "time": time.time(), "done": False,
                       "step_ms_ema": 27.0, "top_bucket": "collective"}, f)
    out = str(tmp_path / "fleet_report.json")
    reps = [mod.FleetMonitor(str(tmp_path), num_workers=3, interval=0.0,
                             out_path=out).poll(force=True)
            for mod in (jfleet, fleet)]
    assert _stable(reps[1]) == _stable(reps[0])
    assert json.load(open(out))["straggler"] == reps[1]["straggler"]
    assert fleet.render_report(reps[1]) == jfleet.render_report(reps[1])
    if heartbeat_only:
        # a heartbeat carries no wait split: its whole step is own work
        assert reps[1]["ranks"]["2"]["step_ms"] == 27.0
        assert reps[1]["ranks"]["2"]["top_bucket"] == "collective"
    else:
        assert reps[1]["straggler"] == 1 and reps[1]["victims"] == [0, 2]
        assert "STRAGGLER" in fleet.render_report(reps[1])
    mon = fleet.FleetMonitor(str(tmp_path), num_workers=3, interval=60.0)
    assert mon.poll(force=True) is not None and mon.poll() is None


@pytest.mark.parametrize("ms", [0.1, 2.0], ids=["poisoned", "honest"])
def test_analyze_dir_drift_equals_the_reference(tmp_path, ms):
    _write_fleet_dir(tmp_path, drift=True)
    port_db, ref_db = _dbs(tmp_path, "db.json", ms)
    port = fleet.analyze_dir(str(tmp_path), costdb=port_db, drift_k=3)
    ref = jfleet.analyze_dir(str(tmp_path), costdb=ref_db, drift_k=3)
    assert _stable(port) == _stable(ref)
    assert bool(port["drift_trips"]) == (ms == 0.1)


def test_blackbox_summary_equals_the_reference(tmp_path):
    _write_fleet_dir(tmp_path)
    port, ref = _both("summarize_for_blackbox", str(tmp_path))
    assert port == ref and port["straggler"] == 1
    for r in (1, 2):
        os.remove(tmp_path / f"timeline_rank{r}.jsonl")
    assert fleet.summarize_for_blackbox(str(tmp_path)) is None


def test_fleet_endpoint_serves_the_timeline():
    from hetu_tpu_torch.ps.server import claim_port
    tel = Telemetry(enabled=True, rank=0)
    reg = tel.metrics
    sock = claim_port(0)
    port = sock.getsockname()[1]
    tel.serve_metrics(port, sock=sock)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet",
                                   timeout=5)
        assert exc.value.code == 404       # no timeline installed yet
        tl = fleet.StepTimeline(tel, rank=0)
        tl.on_step(2, 1_000_000_000, 1_005_000_000, 5.0)
        reg.fleet_source = tl.fleet_json
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet",
                                    timeout=5) as resp:
            doc = json.loads(resp.read().decode())
        assert doc["rank"] == 0 and doc["records"][-1]["step"] == 2
    finally:
        reg.shutdown()
    assert not reg.serving


def test_posthoc_cli(tmp_path, capsys):
    _write_fleet_dir(tmp_path)
    assert fleet.main([str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["straggler"] == 1
    assert fleet.main([str(tmp_path)]) == 0
    assert "STRAGGLER" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert fleet.main([str(empty)]) == 2


# ---------------------------------------------------------------------------
# driven twins: the same MLP through both executors with the plane armed
# ---------------------------------------------------------------------------

def _mlp(ht, prefix):
    rng = np.random.RandomState(0)
    x = ht.Variable(f"{prefix}_x", trainable=False)
    y_ = ht.Variable(f"{prefix}_y", trainable=False)
    w1 = ht.Variable(f"{prefix}_w1", value=rng.randn(16, 12).astype("f"))
    w2 = ht.Variable(f"{prefix}_w2", value=rng.randn(12, 4).astype("f"))
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    return x, y_, loss, ht.optim.SGDOptimizer(0.1).minimize(loss)


def _drive(ht, tdir, **kw):
    x, y_, loss, train = _mlp(ht, "fl")
    exe = ht.Executor([loss, train], telemetry=str(tdir), **kw)
    rng = np.random.RandomState(1)

    def feeds():
        return {x: rng.randn(8, 16).astype("f"),
                y_: np.eye(4, dtype="f")[rng.randint(0, 4, 8)]}
    for _ in range(4):
        exe.run(feed_dict=feeds())
    exe.run_batches([feeds() for _ in range(4)])
    exe.close()
    return exe


def test_driven_timelines_follow_the_reference(tmp_path, monkeypatch):
    """Both packages' executors under ``HETU_FLEET``: the same records
    (four steps, then one 4-step block), their step weights, and the
    same buckets non-zero — but ``jit``, which the port never has (it
    compiles nothing, ROADMAP §3), and the block's ``h2d_ingest``: the
    reference stacks a block's feeds into one ``h2d_stacked`` transfer,
    which no bucket claims, where the port's block is a loop of steps,
    each feed an ``h2d_transfer`` — and every record's buckets summing
    to its wall within 1e-3 ms a bucket (their rounding)."""
    monkeypatch.setenv("HETU_FLEET", "1")
    recs = {}
    for name, ht, kw in (("jax", jht, {}),
                         ("port", tht, {"ctx": tht.cpu(0)})):
        tdir = tmp_path / name
        _drive(ht, tdir, **kw)
        recs[name] = fleet.load_timelines(str(tdir))[0]
        for mod in (ttel, jtel):
            mod._default = None
    port, ref = recs["port"], recs["jax"]
    assert [(r["step"], r["steps"]) for r in port] == \
        [(r["step"], r["steps"]) for r in ref] == \
        [(1, 1), (2, 1), (3, 1), (4, 1), (8, 4)]
    for p, j in zip(port, ref):
        block = p["steps"] > 1
        assert set(p["buckets"]) - ({"h2d_ingest"} if block else set()) \
            == set(j["buckets"]) - {"jit"}, (p, j)
        assert "h2d_ingest" in p["buckets"]
        assert sum(p["buckets"].values()) == pytest.approx(
            p["wall_ms"], abs=1e-3 * len(p["buckets"]))


def test_thread_ranks_hold_a_timeline_each_and_name_the_slow_one(
        tmp_path, monkeypatch):
    """A session of two thread ranks (AllReduce over two workers of one
    process) under ``HETU_FLEET``: one timeline a rank, named by its
    rank; ``HETU_FAULT_SLOW_RANK=1`` slows thread rank 1 alone, and the
    post-hoc analysis names it, rank 0 its victim waiting in the
    allreduce."""
    monkeypatch.setenv("HETU_FLEET", "1")
    monkeypatch.setenv("HETU_FAULT_SLOW_RANK", "1")
    monkeypatch.setenv("HETU_FAULT_SLOW_MS", "100")
    x, y_, loss, train = _mlp(tht, "tr")
    exe = tht.Executor([loss, train], ctx=[tht.gpu(0), tht.gpu(1)],
                       device="cpu", telemetry=str(tmp_path))
    assert exe._fleet_timeline is None
    assert [e._fleet_timeline.rank for e in exe.ranks] == [0, 1]
    assert [e._fault_slow_s for e in exe.ranks] == [0.0, 0.1]
    rng = np.random.RandomState(0)
    for _ in range(4):
        exe.run(feed_dict={x: rng.randn(8, 16).astype("f"),
                           y_: np.eye(4, dtype="f")[rng.randint(0, 4, 8)]})
    exe.close()
    assert not fleet._live
    rep = fleet.analyze_dir(str(tmp_path))
    assert rep["aligned"] and rep["step"] == 4
    assert rep["straggler"] == 1 and rep["victims"] == [0], rep
    assert rep["skew_ms"] > 50, rep
    assert rep["ranks"]["0"]["wait_ms"] > 50, rep


def test_a_failing_monitor_fails_the_job(tmp_path, monkeypatch, capsys):
    """``--watch`` whose monitor raises: the workers finish, the launcher
    says the run has no fleet report and exits non-zero."""
    from hetu_tpu_torch import launcher

    def broken(self, force=False):
        raise RuntimeError("the monitor broke")
    monkeypatch.setattr(fleet.FleetMonitor, "poll", broken)
    cfg = tmp_path / "one.yml"
    cfg.write_text("nodes:\n  - host: localhost\n    workers: 1\n"
                   "    chief: true\n")
    rc = launcher.main(["-c", str(cfg), "--watch", "--telemetry",
                        str(tmp_path / "tel"), sys.executable, "-c",
                        "import time; time.sleep(0.5)"])
    assert rc == launcher.EXIT_MONITOR != 0
    err = capsys.readouterr().err
    assert "the monitor broke" in err and "no fleet report" in err
    assert not (tmp_path / "tel" / "fleet_report.json").exists()


# ---------------------------------------------------------------------------
# overhead contract, held structurally
# ---------------------------------------------------------------------------

def test_disabled_fleet_zero_allocations():
    """No ``--watch``: no timeline, no fault, and the executor's per-step
    fleet path (its ``is None`` check and the fault's test) allocates
    nothing; an executor holds no timeline."""
    tl = fleet.timeline_from_env(NULL)
    fault = fleet.fault_slow_from_env()
    assert tl is None and fault == 0.0
    gc.collect()
    gc.disable()
    try:
        before = sys.getallocatedblocks()
        for _ in range(5000):
            if tl is not None:          # the executor's path, verbatim
                tl.on_step(0, 0, 0, 0.0)
            if fault:
                time.sleep(fault)
        after = sys.getallocatedblocks()
    finally:
        gc.enable()
    assert after - before <= 8, after - before
    x, y_, loss, train = _mlp(tht, "dz")
    exe = tht.Executor([loss, train], ctx=tht.cpu(0))
    assert exe._fleet_timeline is None and exe._fault_slow_s == 0.0


def test_enabled_on_step_never_synchronizes_the_device(tmp_path,
                                                      monkeypatch):
    """With the plane on, ``on_step`` reads the tracer's ring and nothing
    of torch: a device synchronization, a tensor read back or a copy to
    the host inside it fails the test. The module holds no torch."""
    monkeypatch.setenv("HETU_FLEET", "1")
    assert "torch" not in vars(fleet)
    calls = []
    inside = [False]

    def forbid(name):
        def fn(*a, **k):
            if inside[0]:
                calls.append(name)
            return originals[name](*a, **k)
        return fn
    originals = {"synchronize": torch.cuda.synchronize,
                 "item": torch.Tensor.item, "cpu": torch.Tensor.cpu,
                 "numpy": torch.Tensor.numpy, "tolist": torch.Tensor.tolist}
    monkeypatch.setattr(torch.cuda, "synchronize", forbid("synchronize"))
    for name in ("item", "cpu", "numpy", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, forbid(name))
    on_step = fleet.StepTimeline.on_step

    def watched(self, *a, **k):
        inside[0] = True
        try:
            return on_step(self, *a, **k)
        finally:
            inside[0] = False
    monkeypatch.setattr(fleet.StepTimeline, "on_step", watched)
    exe = _drive(tht, tmp_path, ctx=tht.cpu(0))
    assert exe._fleet_timeline is not None
    assert len(fleet.load_timelines(str(tmp_path))[0]) == 5
    assert calls == []


# ---------------------------------------------------------------------------
# the CLIs without torch, and the acceptance job
# ---------------------------------------------------------------------------

def _no_torch_env(tmp_path):
    site = tmp_path / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(
        "import importlib.abc, sys\n"
        "class _Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name == 'torch' or name.startswith('torch.'):\n"
        "            raise ImportError('torch is blocked')\n"
        "sys.meta_path.insert(0, _Block())\n")
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(site), REPO, os.environ.get("PYTHONPATH", "")]),
        "HOME": str(tmp_path)}


SPMD_CONFIG = """
spmd: true
nodes:
  - host: localhost
    workers: 2
    chief: true
"""

SPMD_PP_WORKER = """
import json, os, urllib.request
import numpy as np
import hetu_tpu_torch as ht

rng = np.random.RandomState(0)
w1v = rng.randn(12, 16).astype("f") * 0.3
w2v = rng.randn(16, 4).astype("f") * 0.3
with ht.context(ht.rgpu("worker0", 0)):
    x = ht.Variable("x", trainable=False)
    w1 = ht.Variable("w1", value=w1v)
    a = ht.relu_op(ht.matmul_op(x, w1))
with ht.context(ht.rgpu("worker1", 0)):
    w2 = ht.Variable("w2", value=w2v)
    y_ = ht.Variable("y_", trainable=False)
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(a, w2), y_), [0])
    train_op = ht.optim.SGDOptimizer(0.2).minimize(loss)
exe = ht.Executor([loss, train_op], gpipe=True, num_microbatches=4,
                  device="cpu")
assert exe._fleet_timeline is not None, "HETU_FLEET must arm it"
frng = np.random.RandomState(3)
xs = frng.randn(32, 12).astype("f")
ys = np.eye(4, dtype="f")[frng.randint(0, 4, 32)]
for _ in range(8):
    exe.run(feed_dict={x: xs, y_: ys})
# /fleet is served on the port the launcher claimed for this rank
assert exe._metrics_server and "HETU_METRICS_LISTEN_FD" not in os.environ
port = os.environ["HETU_METRICS_PORT"]
with urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet",
                            timeout=10) as resp:
    doc = json.loads(resp.read().decode())
assert doc["rank"] == int(os.environ["HETU_PROC_ID"])
assert doc["records"][-1]["step"] == 8, doc
exe.close()
"""


def test_watch_dryrun_names_slow_rank(tmp_path):
    """The reference's acceptance job through the port's launcher: two
    GPipe processes under ``--watch --hang-timeout 120``, rank 1 slowed
    120 ms a step by ``HETU_FAULT_SLOW_RANK``. Each rank serves ``/fleet``
    on the port the launcher claimed for it. The live monitor's
    ``fleet_report.json`` names rank 1 (skew over 50 ms) and printed it;
    both ranks flushed timelines; the post-hoc fleet CLI and the black
    box, run with ``import torch`` failing, name rank 1 too; the doctor
    CLI conserves each rank's steps and measures rank 0's bubble."""
    from torch_ps_util import clean_fleet_env
    (tmp_path / "spmd.yml").write_text(SPMD_CONFIG)
    (tmp_path / "pp_worker.py").write_text(SPMD_PP_WORKER)
    tdir = tmp_path / "tel"
    env = clean_fleet_env(HETU_FAULT_SLOW_RANK="1", HETU_FAULT_SLOW_MS="120",
                          HETU_WATCH_INTERVAL="0.5")
    env.pop("HETU_TELEMETRY", None)
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.launcher", "-c",
         str(tmp_path / "spmd.yml"), "--telemetry", str(tdir), "--watch",
         "--hang-timeout", "120", sys.executable,
         str(tmp_path / "pp_worker.py")],
        env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.load(open(tdir / "fleet_report.json"))
    assert rep["straggler"] == 1 and rep["skew_ms"] > 50, rep
    assert "STRAGGLER" in proc.stdout, proc.stdout
    for r in range(2):
        assert (tdir / f"timeline_rank{r}.jsonl").exists()
    assert (tdir / "trace_fleet.json").exists()

    bare = _no_torch_env(tmp_path)
    cli = {}
    for tool, args in (("fleet", ["--json"]), ("blackbox", ["--json"]),
                       ("doctor", ["--json"])):
        cli[tool] = subprocess.run(
            [sys.executable, "-m", f"hetu_tpu_torch.telemetry.{tool}",
             str(tdir), *args], env=bare, capture_output=True, text=True,
            timeout=60, cwd=str(tmp_path))
        assert cli[tool].returncode == 0, cli[tool].stdout + cli[tool].stderr
    assert json.loads(cli["fleet"].stdout)["straggler"] == 1
    box = json.loads(cli["blackbox"].stdout)
    assert box["fleet"]["straggler"] == 1 and box["suspect_ranks"] == [1], \
        box
    diag = json.loads(cli["doctor"].stdout)
    assert diag["conserved"] and set(diag["ranks"]) == {"rank0", "rank1"}
    assert diag["ranks"]["rank0"]["per_step_ms"]["bubble"] > 0
