"""The port's training health monitor (hetu_tpu_torch/telemetry/health.py)
against the JAX package's (tests/test_health.py): options, sentinels at
their cadence, the trip ladder (warn / dump / raise), the block path,
staleness, hot-key and table telemetry, the divergence doctor and its
CLI, the span schema, ``regress``'s informational fields, and the 2-rank
injected-NaN acceptance run under the port's launcher.

Beyond the twins: the same MLP through both packages' executors, record
by record (and through a PS ``comm_mode``, host path and device cache);
the overhead contract, held structurally (an off-cadence step computes
no sentinel and allocates nothing the monitor-off step does not; a
sampled step reads its sentinels in one copy to the host); the
telemetry CLIs with ``import torch`` failing; thread ranks' monitors;
and dropout masks that graphs built earlier do not move.

No twin: ``test_bench_emit_stamps_loss_finite`` (``bench.py``'s emit
waits for the port's benchmark, ROADMAP item 7) and
``test_overhead_guard_under_2pct_at_every_n_10``, a wall-clock bound
that fails under load; its twin here is structural."""
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.telemetry as jtel
import hetu_tpu_torch as tht
from hetu_tpu.telemetry import health as jhealth
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.telemetry import Telemetry, check, health
from hetu_tpu_torch.telemetry.health import (HealthError, HealthMonitor,
                                             HealthOptions)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5          # the cross-package tolerance: sentinels and losses


@pytest.fixture(autouse=True)
def _reset_global_state(monkeypatch):
    monkeypatch.delenv("HETU_HEALTH", raising=False)
    yield
    ttel._default = None
    jtel._default = None
    health._LAST = None
    jhealth._LAST = None


def _cli_env(**extra):
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep
            + os.environ.get("PYTHONPATH", ""), **extra}


def _mlp(prefix, ht=tht, w1=None, w2=None, lr=0.1):
    x = ht.Variable(f"{prefix}_x", trainable=False)
    y_ = ht.Variable(f"{prefix}_y", trainable=False)
    if w1 is None:
        w1 = ht.init.xavier_normal((16, 12), name=f"{prefix}_w1")
        w2 = ht.init.xavier_normal((12, 4), name=f"{prefix}_w2")
    else:
        w1 = ht.Variable(f"{prefix}_w1", value=w1)
        w2 = ht.Variable(f"{prefix}_w2", value=w2)
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    train = ht.optim.SGDOptimizer(lr).minimize(loss)
    return x, y_, loss, train


def _feeds(rng, n=8):
    xs = rng.randn(n, 16).astype("f")
    ys = np.eye(4, dtype="f")[rng.randint(0, 4, n)]
    return xs, ys


def _exe(nodes, **kw):
    return tht.Executor(nodes, ctx=tht.cpu(0), **kw)


# ---------------------------------------------------------------------------
# options resolution
# ---------------------------------------------------------------------------

def test_options_resolve_forms(monkeypatch):
    assert not HealthOptions.resolve(None).enabled
    assert not HealthOptions.resolve(False).enabled
    assert HealthOptions.resolve(True).enabled
    o = HealthOptions.resolve({"every_n": 3, "action": "raise"})
    assert o.enabled and o.every_n == 3 and o.action == "raise"
    o = HealthOptions.resolve("every_n=5,action=dump,spike_factor=8.5")
    assert o.enabled and o.every_n == 5 and o.action == "dump"
    assert o.spike_factor == 8.5
    assert vars(o) == vars(jhealth.HealthOptions.resolve(
        "every_n=5,action=dump,spike_factor=8.5"))
    monkeypatch.setenv("HETU_HEALTH", "every_n=7")
    assert HealthOptions.resolve(None).every_n == 7
    monkeypatch.setenv("HETU_HEALTH", "0")
    assert not HealthOptions.resolve(None).enabled
    with pytest.raises(ValueError):
        HealthOptions.resolve({"action": "explode"})
    with pytest.raises(ValueError):
        HealthOptions.resolve({"bogus_knob": 1})


# ---------------------------------------------------------------------------
# sentinels + cadence (plain run path)
# ---------------------------------------------------------------------------

def test_sentinels_sampled_at_cadence(tmp_path):
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hc")
    exe = _exe([loss, train], health_options={
        "every_n": 5, "out_dir": str(tmp_path)})
    hm = exe.config.health_monitor
    assert hm is not None
    xs, ys = _feeds(rng)
    for _ in range(12):
        exe.run(feed_dict={x: xs, y_: ys})
    assert [r["step"] for r in hm.records] == [5, 10]
    rec = hm.records[0]
    assert set(rec["layers"]) == {"hc_w1", "hc_w2"}
    for m in rec["layers"].values():
        assert m["grad_norm"] > 0 and m["nonfinite"] == 0
        assert m["update_ratio"] > 0
    assert rec["loss_finite"] and rec["loss"] > 0
    assert rec["loss_name"] == loss.name     # the scalar eval output's
    assert rec["lr"] == pytest.approx(0.1)
    assert rec["grad_norm_total"] == pytest.approx(
        float(np.sqrt(sum(m["grad_norm"] ** 2
                          for m in rec["layers"].values()))), rel=1e-5)
    assert not rec["trips"]
    # the JSONL landed, one line per sampled record
    lines = [json.loads(ln) for ln in
             (tmp_path / "health_rank0.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [5, 10]
    exe.close()
    # last_summary feeds a benchmark's loss_finite stamp
    s = health.last_summary()
    assert s["step"] == 10 and s["loss_finite"] is True


def test_nan_trip_names_step_and_layer_and_dumps(tmp_path):
    """NaN injected at step 3 trips at the next sampled step (4, with
    every_n=2), names a layer, dumps the flight ring + last-good
    record, and the doctor reproduces first-bad-step from the JSONL."""
    tel = Telemetry(enabled=True, out_dir=str(tmp_path), rank=0)
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hn")
    exe = _exe([loss, train], telemetry=tel, health_options={
        "every_n": 2, "action": "dump"})
    hm = exe.config.health_monitor
    xs, ys = _feeds(rng)
    for step in range(1, 7):
        xv = xs.copy()
        if step == 3:
            xv[0, 0] = np.nan       # poisons params from step 3 on
        exe.run(feed_dict={x: xv, y_: ys})
    trip_recs = [r for r in hm.records if r["trips"]]
    assert trip_recs and trip_recs[0]["step"] == 4   # within every_n
    kinds = {t["kind"] for t in trip_recs[0]["trips"]}
    assert kinds == {"nonfinite"}
    named = [t["layer"] for t in trip_recs[0]["trips"] if t["layer"]]
    assert named and named[0] in ("hn_w1", "hn_w2")
    assert not trip_recs[0]["loss_finite"]
    # dump rung artifacts: flight ring with the health reason + the
    # last-good record (step 2, the sample before the poison)
    dump = json.loads((tmp_path / "flight_rank0.json").read_text())
    assert dump["reason"].startswith("health trip: nonfinite")
    lastgood = json.loads(
        (tmp_path / "health_lastgood_rank0.json").read_text())
    assert lastgood["step"] == 2 and not lastgood["trips"]
    exe.close()
    # doctor: same first-bad-step from the merged JSONL
    rep = health.diagnose(str(tmp_path))
    assert rep["first_bad_step"] == 4
    assert rep["layer"] == named[0]
    assert not rep["healthy"] and not rep["loss_finite"]
    assert any(c["cause"] == "data_anomaly"
               for c in rep["probable_causes"])


def test_action_raise_raises_health_error(tmp_path):
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hr")
    exe = _exe([loss, train], health_options={
        "every_n": 1, "action": "raise", "out_dir": str(tmp_path)})
    xs, ys = _feeds(rng)
    xs[0, 0] = np.inf
    with pytest.raises(HealthError, match="nonfinite"):
        exe.run(feed_dict={x: xs, y_: ys})
    # the record (with its trips) still reached the JSONL before raise
    lines = (tmp_path / "health_rank0.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["trips"]


def test_grad_spike_trip_vs_baseline(tmp_path):
    """A sudden grad explosion (loss scale jump) trips grad_spike
    against the running EMA baseline and names the worst layer."""
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hs")
    exe = _exe([loss, train], health_options={
        "every_n": 1, "spike_factor": 50.0, "warmup": 3,
        "out_dir": str(tmp_path)})
    hm = exe.config.health_monitor
    xs, ys = _feeds(rng)
    for _ in range(5):
        exe.run(feed_dict={x: xs, y_: ys})
    assert not hm.trips
    exe.run(feed_dict={x: xs * 1e4, y_: ys})    # grads blow up, finite
    spikes = [t for t in hm.trips if t["kind"] == "grad_spike"]
    assert spikes, hm.records[-1]
    assert spikes[0]["layer"] in ("hs_w1", "hs_w2")
    assert spikes[0]["value"] > spikes[0]["limit"]


# ---------------------------------------------------------------------------
# block path (run_batches)
# ---------------------------------------------------------------------------

def test_block_path_samples_inside_block(tmp_path):
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hb")
    exe = _exe([loss, train], health_options={
        "every_n": 3, "out_dir": str(tmp_path)})
    hm = exe.config.health_monitor
    blocks = []
    for _ in range(8):
        xs, ys = _feeds(rng)
        blocks.append({x: xs, y_: ys})
    exe.run_batches(blocks)
    assert [r["step"] for r in hm.records] == [3, 6]
    for rec in hm.records:
        assert rec["loss_finite"] and rec["layers"]["hb_w1"][
            "grad_norm"] > 0


def test_block_nan_trip(tmp_path):
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hbn")
    exe = _exe([loss, train], health_options={
        "every_n": 2, "out_dir": str(tmp_path)})
    hm = exe.config.health_monitor
    blocks = []
    for k in range(6):
        xs, ys = _feeds(rng)
        if k == 2:                  # step 3 of the block
            xs[0, 0] = np.nan
        blocks.append({x: xs, y_: ys})
    exe.run_batches(blocks)
    trip_recs = [r for r in hm.records if r["trips"]]
    assert trip_recs and trip_recs[0]["step"] == 4


# ---------------------------------------------------------------------------
# overhead contract
# ---------------------------------------------------------------------------

def test_disabled_path_zero_allocations():
    """No live monitor: the sparse-side hooks (the only health code on
    the disabled hot path beyond `health_monitor is None` checks) are
    one falsy check — zero net allocations."""
    gc.collect()                    # drop any dead monitors first
    assert not health.active()
    upds = np.array([1, 2, 3], np.int64)
    for _ in range(200):            # warm caches
        health.observe_staleness("push", 1, upds, 4)
        health.active()
    gc.collect()
    gc.disable()
    try:
        before = sys.getallocatedblocks()
        for _ in range(5000):
            health.observe_staleness("push", 1, upds, 4)
            health.active()
        after = sys.getallocatedblocks()
    finally:
        gc.enable()
    assert after - before <= 8, \
        f"disabled health hooks leaked {after - before} blocks"


def test_disabled_executor_has_no_monitor():
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hd")
    exe = _exe([loss, train])
    assert exe.config.health_monitor is None
    xs, ys = _feeds(rng)
    exe.run(feed_dict={x: xs, y_: ys})
    sub = exe.subexecutors["default"]
    assert getattr(sub, "_last_health", None) is None


def _allocations(fn):
    """The CPU allocator events (count, bytes allocated) of ``fn()``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    sizes = [e.cpu_memory_usage for e in prof.events()
             if e.name == "[memory]" and e.cpu_memory_usage > 0]
    return len(sizes), sum(sizes)


def test_overhead_is_structural(tmp_path, monkeypatch):
    """The reference's guard times the monitor's host cost against the
    step (under 2% at every_n=10) and fails under a loaded host. Its twin
    holds what that cost is made of: an off-cadence step calls no
    sentinel reduction, reads nothing to the host and allocates exactly
    what the same step with the monitor off allocates; a sampled step
    computes the sentinels once (one ``sentinel_rows`` a subgraph's
    optimizer) and reads them in ONE copy to the host, a float64 vector
    of three values a layer and the loss."""
    import hetu_tpu_torch.optimizer as topt
    rng = np.random.RandomState(0)
    xs, ys = _feeds(rng)
    calls = {"rows": 0, "cpu": 0}
    real_rows = topt.sentinel_rows

    def counted_rows(*a, **k):
        calls["rows"] += 1
        return real_rows(*a, **k)

    monkeypatch.setattr(topt, "sentinel_rows", counted_rows)
    x, y_, loss, train = _mlp("ho")
    on = _exe([loss, train], health_options={
        "every_n": 10, "out_dir": str(tmp_path)})
    off = _exe([loss, train])
    hm = on.config.health_monitor
    feeds = {x: xs, y_: ys}
    for _ in range(3):                      # steps 1-3: off cadence
        on.run(feed_dict=feeds)
        off.run(feed_dict=feeds)
    assert calls["rows"] == 0 and not hm.records
    sub = on.subexecutors["default"]
    assert sub._last_health is None
    # step 4 of each, off cadence: the same allocations
    got = _allocations(lambda: on.run(feed_dict=feeds))
    want = _allocations(lambda: off.run(feed_dict=feeds))
    assert got == want, (got, want)
    for _ in range(5):
        on.run(feed_dict=feeds)
    assert calls["rows"] == 0
    # step 10: sampled, one copy to the host
    real_after = hm.after_step
    seen = []

    def after_step(s, runtime=None):
        h = s._last_health
        if h is not None:
            seen.append(h)
            real_cpu = h["values"].cpu

            def cpu():
                calls["cpu"] += 1
                return real_cpu()
            h["values"] = _Fetch(h["values"], cpu)
        return real_after(s, runtime)

    monkeypatch.setattr(hm, "after_step", after_step)
    on.run(feed_dict=feeds)
    assert [r["step"] for r in hm.records] == [10]
    assert calls == {"rows": 1, "cpu": 1}
    (h,) = seen
    assert h["names"] == ["ho_w1", "ho_w2"] and h["loss"]
    assert h["values"].t.dtype == torch.float64
    assert tuple(h["values"].t.shape) == (3 * 2 + 1,)
    assert hm.sample_wall_ms > 0 and sub._last_health is None


class _Fetch:
    """A stacked sentinel tensor whose ``.cpu()`` is counted."""

    def __init__(self, t, cpu):
        self.t, self.cpu = t, cpu


# ---------------------------------------------------------------------------
# staleness / hot-key / table telemetry
# ---------------------------------------------------------------------------

def test_staleness_observation_and_push_trip(tmp_path):
    """Push-side staleness past the bound (a drain that claimed more
    per-row updates than push_bound) is a violation and trips; pull-
    side refresh deltas are histogram-only (the protocol enforcing the
    bound is not a violation)."""
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hst")
    exe = _exe([loss, train], health_options={
        "every_n": 1, "out_dir": str(tmp_path)})
    hm = exe.config.health_monitor
    health.observe_staleness("pull", 7, np.array([6, 9]), 4)
    health.observe_staleness("push", 7, np.array([3, 9]), 4)
    xs, ys = _feeds(rng)
    exe.run(feed_dict={x: xs, y_: ys})
    rec = hm.records[-1]
    st = rec["staleness"]
    assert st["pull:7"]["max"] == 9 and st["pull:7"]["violations"] == 0
    assert st["push:7"]["violations"] == 1
    assert st["push:7"]["bound"] == 4.0
    trips = [t for t in rec["trips"] if t["kind"] == "staleness"]
    assert trips and trips[0]["table"] == "7"
    assert trips[0]["value"] == 9 and trips[0]["limit"] == 4.0
    exe.close()


def test_device_cache_take_dirty_feeds_staleness(tmp_path):
    """DeviceCacheTable.take_dirty routes per-row update counts into
    the live monitor (kind=push, bound=push_bound)."""
    from hetu_tpu_torch.ps.device_cache import DeviceCacheTable

    class _Tbl:
        id = 42
        name = "t42"

    class _Cache:
        id = 43

    hm = HealthMonitor(HealthOptions(enabled=True,
                                     out_dir=str(tmp_path)))
    try:
        rt = DeviceCacheTable(_Tbl(), _Cache(), client=None, capacity=8,
                              width=4, rows=16, push_bound=2,
                              pull_bound=2, nworkers=1)
        slots, miss_ids, new_slots, uniq = rt.assign(
            np.array([1, 2, 3]), lambda: None)
        for _ in range(3):                       # 3 updates > bound 2
            rt.note_update(uniq)
        rt.take_dirty()
        key = ("push", 42)
        assert key in hm._stale
        assert hm._stale[key]["max"] == 3
        assert hm._stale[key]["violations"] == 3  # all rows past bound
    finally:
        hm.close()


def test_scoped_staleness_does_not_cross_attribute(tmp_path):
    """An observation carrying its owning monitor (the PS runtime
    stamps it onto registered cache objects) lands ONLY there — two
    executors in one process never cross-attribute staleness."""
    hm_a = HealthMonitor(HealthOptions(enabled=True,
                                       out_dir=str(tmp_path / "a")))
    hm_b = HealthMonitor(HealthOptions(enabled=True,
                                       out_dir=str(tmp_path / "b")))
    try:
        health.observe_staleness("push", 11, np.array([9]), 4,
                                 monitor=hm_a)
        assert ("push", 11) in hm_a._stale
        assert ("push", 11) not in hm_b._stale
        # unscoped fallback (bare cache objects) still broadcasts
        health.observe_staleness("push", 12, np.array([1]), 4)
        assert ("push", 12) in hm_a._stale and ("push", 12) in hm_b._stale
    finally:
        hm_a.close()
        hm_b.close()


def test_jsonl_truncates_across_processes_appends_within(tmp_path):
    """First open of health_rank<r>.jsonl in a process truncates (a
    rerun reusing a telemetry dir must not merge two runs in the
    doctor); later monitors in the SAME process append."""
    stale = tmp_path / "health_rank0.jsonl"
    stale.write_text(json.dumps(_rec(99, 0)) + "\n")   # "previous run"
    health._OPENED_PATHS.discard(str(stale))           # fresh process
    hm = HealthMonitor(HealthOptions(enabled=True,
                                     out_dir=str(tmp_path)))
    hm._write(_rec(5, 0))
    hm.close()
    hm2 = HealthMonitor(HealthOptions(enabled=True,
                                      out_dir=str(tmp_path)))
    hm2._write(_rec(10, 0))
    hm2.close()
    steps = [json.loads(ln)["step"]
             for ln in stale.read_text().splitlines()]
    assert steps == [5, 10]        # stale run gone, same-process kept


def test_hot_key_skew_in_record(tmp_path):
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hk")
    exe = _exe([loss, train], health_options={
        "every_n": 1, "out_dir": str(tmp_path)})
    hm = exe.config.health_monitor
    ids = np.concatenate([np.zeros(90, np.int64),
                          np.arange(1, 11, dtype=np.int64)])
    hm.observe_ids(5, ids)
    assert list(hm.hot_ids(5, 2)) == [0, 1]
    xs, ys = _feeds(rng)
    exe.run(feed_dict={x: xs, y_: ys})
    hot = hm.records[-1]["hot_keys"]["5"]
    assert hot["n"] == 100 and hot["unique"] == 11
    assert hot["top1_share"] == pytest.approx(0.9)
    # drained per sample: the next record starts a fresh window
    exe.run(feed_dict={x: xs, y_: ys})
    assert "hot_keys" not in hm.records[-1]
    exe.close()


def test_table_sampling_with_stub_runtime(tmp_path):
    """Row-norm / dead-row stats from a (stubbed) server sample: half
    the sampled rows are zero -> dead_frac 0.5."""

    class _Client:
        def sparse_pull(self, tid, ids, width):
            rows = np.ones((len(ids), width), np.float32)
            rows[::2] = 0.0
            return rows

    class _RT:
        tid, rows, width = 9, 128, 8

    class _Config:
        ps_nodes = ()

    class _Runtime:
        device_tables = {9: _RT()}
        client = _Client()
        config = _Config()

    hm = HealthMonitor(HealthOptions(enabled=True, table_sample=32,
                                     out_dir=str(tmp_path)))
    try:
        out = hm.sample_tables(_Runtime(), step=10)
        assert out["9"]["rows_sampled"] == 32
        assert out["9"]["dead_frac"] == 0.5
        assert out["9"]["row_norm_max"] == pytest.approx(np.sqrt(8),
                                                         abs=1e-3)
    finally:
        hm.close()


def test_cstable_shadow_staleness(tmp_path):
    """The host-cache shadow counts pending updates per key and reports
    them (kind=cstable, histogram-only) at lookup — against the port's
    own server."""
    from hetu_tpu_torch.cstable import CacheSparseTable
    from hetu_tpu_torch.ps import client as ps_client
    from hetu_tpu_torch.ps import server as ps_server
    from torch_ps_util import start_server
    port, _ = start_server()
    client = ps_client.PSClient(hosts="127.0.0.1", ports=str(port),
                                rank=0, nworkers=1)
    ps_client.set_default_client(client)
    hm = HealthMonitor(HealthOptions(enabled=True,
                                     out_dir=str(tmp_path)))
    try:
        client.init_tensor(990, (64, 4), kind=2, opt="SGD", lrs=[1.0])
        client.set_param(990, np.zeros((64, 4), np.float32))
        tbl = CacheSparseTable(990, 64, 4, limit=16, policy="LRU",
                               pull_bound=100, push_bound=100)
        tbl.embedding_lookup(np.array([1, 2], np.int64))  # fill rows
        keys = np.array([1, 2, 1], np.int64)
        tbl.embedding_update(keys, np.ones((3, 4), np.float32))
        assert tbl._upd_pending == {1: 2, 2: 1}
        tbl.embedding_lookup(np.array([1, 2], np.int64))
        key = ("cstable", 990)
        assert key in hm._stale and hm._stale[key]["max"] == 2
        assert hm._stale[key]["violations"] == 0    # never a trip
        tbl.flush()
        assert not tbl._upd_pending
        del tbl
    finally:
        hm.close()
        client.shutdown_servers()
        ps_client.close_default_client()
        ps_server.shutdown_server()


# ---------------------------------------------------------------------------
# divergence doctor
# ---------------------------------------------------------------------------

def _write_jsonl(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _rec(step, rank, loss=1.0, loss_finite=True, lr=0.1, gn=1.0,
         trips=(), layers=None):
    return {"step": step, "rank": rank, "t": 0.0, "loss": loss,
            "loss_finite": loss_finite, "grad_norm_total": gn,
            "lr": lr, "layers": layers or
            {"w": {"grad_norm": gn, "nonfinite": 0,
                   "update_ratio": 0.01}},
            "trips": list(trips)}


def _diagnose(tdir):
    """The port's report, equal to the JAX package's on the same files."""
    rep = health.diagnose(str(tdir))
    assert rep == jhealth.diagnose(str(tdir))
    return rep


def test_doctor_rank_divergence_cause(tmp_path):
    """Only rank 1 trips at step 10 -> first_bad_step 10, cause
    rank_divergence ranked."""
    _write_jsonl(tmp_path / "health_rank0.jsonl",
                 [_rec(5, 0), _rec(10, 0, gn=1.1)])
    bad = _rec(10, 1, loss=None, loss_finite=False, gn=None,
               trips=[{"kind": "nonfinite", "layer": "w",
                       "value": 3.0, "limit": 0}],
               layers={"w": {"grad_norm": None, "nonfinite": 3,
                             "update_ratio": None}})
    _write_jsonl(tmp_path / "health_rank1.jsonl", [_rec(5, 1), bad])
    rep = _diagnose(tmp_path)
    assert rep["first_bad_step"] == 10 and rep["bad_rank"] == 1
    assert rep["bad_ranks"] == [1]
    assert rep["layer"] == "w" and not rep["loss_finite"]
    causes = {c["cause"]: c for c in rep["probable_causes"]}
    assert "rank_divergence" in causes
    assert rep["trip_kinds"] == ["nonfinite"]


def test_doctor_staleness_cause_ranked_first(tmp_path):
    stale_trip = {"kind": "staleness", "table": "7", "value": 9,
                  "limit": 4}
    recs = [_rec(5, 0),
            _rec(10, 0, trips=[stale_trip]),
            _rec(15, 0, loss=None, loss_finite=False, gn=None,
                 trips=[{"kind": "nonfinite", "layer": "w",
                         "value": 1, "limit": 0}])]
    _write_jsonl(tmp_path / "health_rank0.jsonl", recs)
    rep = _diagnose(tmp_path)
    assert rep["first_bad_step"] == 10
    causes = rep["probable_causes"]
    assert causes and causes[0]["cause"] == "staleness_violation"


def test_doctor_lr_spike_cause(tmp_path):
    recs = [_rec(2, 0, lr=0.1), _rec(4, 0, lr=0.1),
            _rec(6, 0, lr=0.1),
            _rec(8, 0, lr=5.0, loss=None, loss_finite=False, gn=None,
                 trips=[{"kind": "nonfinite", "layer": "w",
                         "value": 1, "limit": 0}])]
    _write_jsonl(tmp_path / "health_rank0.jsonl", recs)
    rep = _diagnose(tmp_path)
    causes = {c["cause"] for c in rep["probable_causes"]}
    assert "lr_spike" in causes


def test_doctor_healthy_run_and_cli(tmp_path):
    _write_jsonl(tmp_path / "health_rank0.jsonl",
                 [_rec(5, 0), _rec(10, 0)])
    rep = _diagnose(tmp_path)
    assert rep["healthy"] and rep["loss_finite"]
    assert rep["first_bad_step"] is None
    assert health.main([str(tmp_path)]) == 0
    assert health.main([str(tmp_path), "--json"]) == 0
    assert health.main([str(tmp_path / "empty")]) == 2
    text = health.format_report(rep)
    assert "HEALTHY" in text and text == jhealth.format_report(rep)


def test_blackbox_ingests_health_records(tmp_path):
    """The black box folds the health summary into its verdict: the
    first bad step and layer, and the tripped rank as the suspect where
    no rank died or diverged. Its fleet half: no timelines, no fleet
    line; with two ranks' flushed timelines (rank 1 slow) the STRAGGLER
    line appears beside the health verdict, which still names the
    suspect, as the reference's black box does on the same files."""
    from hetu_tpu_torch.telemetry import blackbox
    (tmp_path / "flight_rank0.json").write_text(json.dumps(
        {"rank": 0, "pid": 1, "nprocs": 1, "reason": "flush",
         "last_step": 12, "steps": [], "events": []}))
    _write_jsonl(tmp_path / "health_rank0.jsonl",
                 [_rec(5, 0),
                  _rec(10, 0, loss=None, loss_finite=False, gn=None,
                       trips=[{"kind": "nonfinite", "layer": "w",
                               "value": 2, "limit": 0}])])
    rep = blackbox.analyze(str(tmp_path))
    assert rep["health"]["first_bad_step"] == 10
    assert rep["health"]["layer"] == "w"
    assert rep["health"] == jhealth.summarize_for_blackbox(str(tmp_path))
    assert rep["suspect_ranks"] == [0]
    text = blackbox.format_report(rep)
    assert "HEALTH: first bad step 10" in text
    assert "python -m hetu_tpu_torch.telemetry.health" in text
    assert rep["fleet"] is None and "STRAGGLER" not in text
    from hetu_tpu.telemetry import blackbox as jblackbox
    for r, self_ms in ((0, 10.0), (1, 30.0)):
        _write_jsonl(tmp_path / f"timeline_rank{r}.jsonl", [
            {"step": s, "t": float(s), "wall_ms": 32.0, "steps": 1,
             "buckets": {"compute": self_ms, "p2p": 32.0 - self_ms}}
            for s in (11, 12)])
    rep = blackbox.analyze(str(tmp_path))
    ref = jblackbox.analyze(str(tmp_path))
    assert rep["fleet"] == ref["fleet"]
    assert rep["fleet"]["straggler"] == 1 and rep["fleet"]["victims"] == [0]
    assert rep["suspect_ranks"] == ref["suspect_ranks"] == [0]
    text = blackbox.format_report(rep)
    assert "STRAGGLER rank 1 at step 12" in text
    assert "python -m hetu_tpu_torch.telemetry.fleet" in text


# ---------------------------------------------------------------------------
# span-attr schema: producer fixture + drift case
# ---------------------------------------------------------------------------

def test_health_spans_validate_against_schema(tmp_path):
    """The monitor's real trace output — the producer fixture for the
    health/health_trip schema entries — passes the drift gate of both
    packages."""
    tel = Telemetry(enabled=True, out_dir=str(tmp_path / "tel"), rank=0)
    rng = np.random.RandomState(0)
    x, y_, loss, train = _mlp("hv")
    exe = _exe([loss, train], telemetry=tel, health_options={
        "every_n": 2})
    xs, ys = _feeds(rng)
    xs[0, 0] = np.nan
    for _ in range(2):
        exe.run(feed_dict={x: xs, y_: ys})
    paths = tel.flush()
    trace = paths[0]
    doc = json.load(open(trace))
    names = {e["name"] for e in doc["traceEvents"]}
    assert "health" in names and "health_trip" in names
    n, errors = check.validate(trace)
    assert not errors, errors
    assert jtel.validate(trace) == (n, [])
    assert tel.counter_value("health_trips") == 2
    assert tel.metrics.peek("health_last_step") == 2
    exe.close()


@pytest.mark.parametrize("name,args,match", [
    ("health", {"layers": 2}, "missing"),            # step required
    ("health", {"step": 2, "novel": 1}, "unknown attr"),
    ("health_trip", {"step": 2}, "kind"),            # kind required
    ("health_trip", {"step": 2, "kind": "nonfinite", "layer": 3},
     "layer"),                                       # wrong type
])
def test_health_schema_drift_rejected(tmp_path, name, args, match):
    from hetu_tpu_torch.telemetry import Tracer
    tr = Tracer(pid=0)
    t = tr.clock()
    tr.complete(name, t, t + 1000, args)
    path = tr.export(str(tmp_path / "trace_rank0.json"))
    _, errors = check.validate(path)
    assert errors and any(match in e for e in errors), (errors, match)


def test_regress_health_fields_informational():
    from hetu_tpu_torch.telemetry.regress import compare
    old = {"m": {"metric": "m", "value": 100.0, "unit": "samples/sec",
                 "loss_finite": True, "grad_norm_final": 1.0}}
    new = {"m": {"metric": "m", "value": 99.0, "unit": "samples/sec",
                 "loss_finite": False, "grad_norm_final": 900.0}}
    rows = compare(old, new, tolerance=0.15)
    by_name = {r[0]: r for r in rows}
    assert by_name["m.loss_finite"][4] == "info"
    assert by_name["m.grad_norm_final"][4] == "info"
    # a loss_finite flip (or a 900x grad norm) is never a perf verdict
    assert all(r[4] != "REGRESSED" for r in rows)


# ---------------------------------------------------------------------------
# the two packages, record by record
# ---------------------------------------------------------------------------

def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(16, 12) * 0.3).astype("f"),
            (rng.randn(12, 4) * 0.3).astype("f"))


def _twin_run(ht, tdir, steps=5, nan_step=3):
    w1, w2 = _weights()
    x, y_, loss, train = _mlp("tw", ht, w1, w2)
    kw = {"ctx": tht.cpu(0)} if ht is tht else {}
    exe = ht.Executor([loss, train], health_options={
        "every_n": 1, "out_dir": str(tdir)}, **kw)
    rng = np.random.RandomState(1)
    for step in range(1, steps + 1):
        xs, ys = _feeds(rng)
        if step == nan_step:
            xs[0, 0] = np.nan
        exe.run(feed_dict={x: xs, y_: ys})
    recs = list(exe.config.health_monitor.records)
    exe.close()
    return recs


def _same_number(got, want, what):
    if want is None:
        assert got is None, what
    else:
        assert got == pytest.approx(want, rel=REL, abs=1e-12), what


def _same_records(got, want):
    """Record by record: steps, layer names, nonfinite counts and trips
    equal; grad norms, update ratios and losses within REL."""
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        what = f"step {w['step']}"
        assert set(g["layers"]) == set(w["layers"]), what
        for name, m in w["layers"].items():
            gm = g["layers"][name]
            assert gm["nonfinite"] == m["nonfinite"], (what, name)
            for k in ("grad_norm", "update_ratio"):
                _same_number(gm[k], m[k], (what, name, k))
        for k in ("loss", "grad_norm_total", "lr"):
            _same_number(g[k], w[k], (what, k))
        assert g["loss_finite"] == w["loss_finite"], what
        trips = [{k: v for k, v in t.items() if k not in ("value",
                                                          "limit")}
                 for t in g["trips"]]
        assert trips == [{k: v for k, v in t.items()
                          if k not in ("value", "limit")}
                         for t in w["trips"]], what
        for gt, wt in zip(g["trips"], w["trips"]):
            _same_number(gt["value"], wt["value"], (what, "trip value"))
            _same_number(gt["limit"], wt["limit"], (what, "trip limit"))


def test_records_match_the_jax_package(tmp_path):
    """The JAX package's Executor and the port's run the same MLP from the
    same numpy weights and feeds, every_n=1, a NaN fed at step 3: every
    record's steps, layers, nonfinite counts and trips equal, its
    sentinels and loss within 1e-5, and ``diagnose()`` on the two
    directories the same report."""
    want = _twin_run(jht, tmp_path / "jax")
    got = _twin_run(tht, tmp_path / "torch")
    assert [r["step"] for r in got] == [1, 2, 3, 4, 5]
    assert [bool(r["trips"]) for r in got] == [False, False, True, True,
                                                True]
    _same_records(got, want)
    rep = health.diagnose(str(tmp_path / "torch"))
    ref = jhealth.diagnose(str(tmp_path / "jax"))
    assert {k: v for k, v in rep.items() if k != "dir"} == \
        {k: v for k, v in ref.items() if k != "dir"}
    assert rep["first_bad_step"] == 3


def test_sentinel_stats_match_the_reference():
    """``sentinel_stats`` against the reference's on one parameter: a
    dense update, a PS-pushed gradient (ratio 0), an IndexedSlices
    gradient by its values; and the in-place sparse SGD update's ratio,
    taken from the deduplicated rows times lr, against the reference's
    ``new - param`` over the table."""
    import jax.numpy as jnp
    from hetu_tpu.ndarray import IndexedSlices as JSlices
    from hetu_tpu.optimizer import sentinel_stats as jstats
    from hetu_tpu_torch.ndarray import IndexedSlices
    from hetu_tpu_torch.optimizer import sentinel_stats
    rng = np.random.RandomState(0)
    p = rng.randn(6, 3).astype("f")
    g = rng.randn(6, 3).astype("f")
    q = (p - 0.1 * g).astype("f")
    g[0, 0] = np.nan
    got = sentinel_stats(torch.from_numpy(p), torch.from_numpy(g),
                         torch.from_numpy(q))
    want = jstats(jnp.asarray(p), jnp.asarray(g), jnp.asarray(q))
    for k in ("nonfinite", "update_ratio"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=REL)
    assert not np.isfinite(float(got["grad_norm"]))
    assert float(sentinel_stats(None, torch.from_numpy(g),
                                None)["update_ratio"]) == 0.0
    idx = np.array([1, 4, 1], np.int64)
    vals = rng.randn(3, 3).astype("f")
    got = sentinel_stats(None, IndexedSlices(
        torch.from_numpy(idx), torch.from_numpy(vals), (6, 3)), None)
    want = jstats(None, JSlices(indices=jnp.asarray(idx),
                                values=jnp.asarray(vals),
                                dense_shape=(6, 3)), None)
    assert float(got["grad_norm"]) == pytest.approx(
        float(want["grad_norm"]), rel=REL)
    # sparse SGD updates the table in place: the optimizer takes the
    # norms around the scatter-add
    from hetu_tpu_torch.graph.node import ExecContext
    tbl = tht.Variable("st_tbl", value=p)
    opt = tht.optim.SGDOptimizer(0.5)
    opt.params = [tbl]
    op = tht.optim.OptimizerOp([tbl], opt)
    ectx = ExecContext()
    table = torch.from_numpy(p.copy())
    ectx.params = {tbl: table}
    ectx.opt_state = {}
    ectx.health_sentinels = []
    op.compute([IndexedSlices(torch.from_numpy(idx),
                              torch.from_numpy(vals), (6, 3))], ectx)
    assert ectx.new_params[tbl] is table        # in place
    (names, rows), = ectx.health_sentinels
    dense = np.zeros((6, 3), np.float32)
    np.add.at(dense, idx, vals)
    ref = jstats(jnp.asarray(p), jnp.asarray(dense),
                 jnp.asarray(p - 0.5 * dense))
    assert names == ["st_tbl"]
    assert float(rows[0, 2]) == pytest.approx(float(ref["update_ratio"]),
                                              rel=REL)
    assert float(rows[0, 0]) == pytest.approx(
        float(np.linalg.norm(vals)), rel=REL)


def _ps_twin_run(ht, client, kwargs, tdir, steps=8, nan_step=None):
    from test_torch_ps_training import _data, _executor, _model
    table, w_val, batches = _data(seed=3, steps=steps)
    m = _model(ht, table, w_val)
    kw = dict(kwargs, health_options={"every_n": 2, "table_sample": 16,
                                      "out_dir": str(tdir)})
    exe = _executor(ht, m, kw)
    losses = []
    for step, (ids, y) in enumerate(batches, start=1):
        if step == nan_step:
            y = y.copy()
            y[0, 0] = np.nan
        out = exe.run(feed_dict={m["ids"]: ids, m["y"]: y},
                      convert_to_numpy_ret_vals=True)
        losses.append(float(np.asarray(out[0]).ravel()[0]))
    recs = list(exe.config.health_monitor.records)
    tid = {str(m["tbl"].id): "tbl", str(m["w"].id): "w"}
    exe.close()
    return recs, tid, losses


def _renamed(recs, tid):
    """Records with each table id replaced by its name (the packages'
    node ids differ)."""
    def key(k):
        kind, _, t = k.partition(":")
        return f"{kind}:{tid.get(t, t)}" if t else tid.get(k, k)
    out = []
    for r in recs:
        r = json.loads(json.dumps(r))
        for field in ("staleness", "hot_keys", "tables"):
            if field in r:
                r[field] = {key(k): v for k, v in r[field].items()}
                for v in r[field].values():
                    if "table" in v:
                        v["table"] = tid.get(v["table"], v["table"])
        for t in r["trips"]:
            if t.get("table"):
                t["table"] = tid.get(t["table"], t["table"])
        out.append(r)
    return out


PS_TWINS = {
    # the host path: every gradient pushed, sentinelled as ps:<name>
    "host_bsp": dict(comm_mode="PS", bsp=True),
    # the device cache: the table's cache trained in place by SGD, the
    # drain's per-row update counts as staleness, the dense weight on
    # the unified HET path
    "device_cache": dict(comm_mode="PS", cstable_policy="Device",
                         cache_bound=3, cache_capacity=24),
}


@pytest.mark.parametrize("case", sorted(PS_TWINS))
def test_ps_records_match_the_jax_package(tmp_path, case):
    """The twin above through a PS ``comm_mode``, each package on its own
    server: the same layers (``ps:`` ones on the host path), sentinels
    and losses within 1e-5, staleness and hot keys equal, the server
    table sample within its rounding, and a NaN label's trip at the
    same step."""
    from torch_ps_util import both_servers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with both_servers() as (jc, tc):
            want, jtid, jl = _ps_twin_run(jht, jc, PS_TWINS[case],
                                          tmp_path / "jax", nan_step=7)
            got, ttid, tl = _ps_twin_run(tht, tc, PS_TWINS[case],
                                         tmp_path / "torch", nan_step=7)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(tl[:6], jl[:6], rtol=REL)
    got, want = _renamed(got, ttid), _renamed(want, jtid)
    _same_records(got, want)
    layers = set(got[0]["layers"])
    if case == "host_bsp":
        assert layers == {"ps:ps_table", "ps:ps_w"}
        assert all(m["update_ratio"] == 0.0
                   for m in got[0]["layers"].values())
    else:
        assert "ps_w" in layers and len(layers) == 2
        assert any("staleness" in r for r in got)
    assert [r["step"] for r in got if r["trips"]][:1] == [8]
    for g, w in zip(got, want):
        assert g.get("staleness") == w.get("staleness"), g["step"]
        assert g.get("hot_keys") == w.get("hot_keys"), g["step"]
        assert set(g.get("tables", {})) == set(w.get("tables", {}))
        for t, s in w.get("tables", {}).items():
            for k, v in s.items():
                assert g["tables"][t][k] == pytest.approx(v, abs=2e-4,
                                                          nan_ok=True)
    assert "hot_keys" in got[0] and "tables" in got[0]


# ---------------------------------------------------------------------------
# thread ranks, the telemetry CLIs without torch, dropout keys
# ---------------------------------------------------------------------------

def test_thread_ranks_each_have_a_monitor(tmp_path):
    """A context of two workers under AllReduce runs two thread ranks;
    each has its own monitor and rank number, so each writes its own
    records, and their gradients (averaged) agree."""
    w1, w2 = _weights()
    x, y_, loss, train = _mlp("tr", tht, w1, w2)
    exe = tht.Executor([loss, train], ctx=[tht.gpu(0), tht.gpu(1)],
                       device="cpu", health_options={
                           "every_n": 2, "out_dir": str(tmp_path)})
    assert exe.config.health_monitor is None     # the front runs no step
    monitors = [r.config.health_monitor for r in exe.ranks]
    assert [m.rank for m in monitors] == [0, 1]
    rng = np.random.RandomState(0)
    xs, ys = _feeds(rng)
    for _ in range(4):
        exe.run(feed_dict={x: xs, y_: ys})
    exe.close()
    recs = health.merge_records(str(tmp_path))
    assert sorted(recs) == [0, 1]
    for r in (0, 1):
        assert [rec["step"] for rec in recs[r]] == [2, 4]
        assert recs[r][0]["rank"] == r
    for a, b in zip(recs[0], recs[1]):
        for name in a["layers"]:
            assert a["layers"][name]["grad_norm"] == pytest.approx(
                b["layers"][name]["grad_norm"], rel=1e-6)


@pytest.mark.parametrize("tool", ["check", "health", "blackbox", "regress"])
def test_telemetry_clis_run_without_torch(tmp_path, tool):
    """``python -m hetu_tpu_torch.telemetry.<tool>`` in a process where
    ``import torch`` fails: the package's API (and its torch import)
    stays off the path of the four file tools."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import importlib.abc, sys\n"
        "class _Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name == 'torch' or name.startswith('torch.'):\n"
        "            raise ImportError('torch is blocked')\n"
        "sys.meta_path.insert(0, _Block())\n")
    tdir = tmp_path / "tel"
    tdir.mkdir()
    _write_jsonl(tdir / "health_rank0.jsonl", [_rec(5, 0), _rec(10, 0)])
    from hetu_tpu_torch.telemetry import Tracer
    tr = Tracer(pid=0)
    with tr.span("step"):
        pass
    trace = tr.export(str(tdir / "trace_rank0.json"))
    (tdir / "flight_rank0.json").write_text(json.dumps(
        {"rank": 0, "pid": 1, "nprocs": 1, "reason": "flush",
         "last_step": 10, "steps": [], "events": []}))
    bench = tdir / "b.json"
    bench.write_text(json.dumps(
        {"metric": "m", "value": 1.0, "unit": "ms/step"}))
    args = {"check": [trace], "health": [str(tdir), "--json"],
            "blackbox": [str(tdir), "--json"],
            "regress": [str(bench), str(bench)]}[tool]
    env = _cli_env()
    env["PYTHONPATH"] = str(site) + os.pathsep + env["PYTHONPATH"]
    proc = subprocess.run(
        [sys.executable, "-m", f"hetu_tpu_torch.telemetry.{tool}", *args],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch is blocked" not in proc.stderr
    blocked = subprocess.run(
        [sys.executable, "-c", "import hetu_tpu_torch"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path))
    assert blocked.returncode != 0 and "torch is blocked" in blocked.stderr


def _dropout_masks(build_first):
    """Two steps of a dropout MLP; ``build_first`` builds an unrelated
    graph before it, taking node ids."""
    if build_first:
        for k in range(build_first):
            _mlp(f"other{k}")
    rng = np.random.RandomState(0)
    x = tht.Variable("dm_x", trainable=False)
    w = tht.Variable("dm_w", value=rng.randn(16, 32).astype("f"))
    h = tht.dropout_op(tht.relu_op(tht.matmul_op(x, w)), 0.5)
    loss = tht.reduce_mean_op(tht.reduce_sum_op(h, [1]), [0])
    train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    exe = _exe([h, loss, train])
    xs = rng.randn(8, 16).astype("f")
    return [exe.run(feed_dict={x: xs}, convert_to_numpy_ret_vals=True)[0]
            for _ in range(2)]


def test_dropout_masks_do_not_move_with_other_graphs():
    """Dropout draws key by an op's id less the session graph's smallest:
    building unrelated graphs first (node ids taken) leaves a graph's
    masks, and so its values, as they were."""
    first = _dropout_masks(0)
    later = _dropout_masks(3)
    for a, b in zip(first, later):
        np.testing.assert_array_equal(a, b)
    assert (first[0] == 0).any() and (first[0] != first[1]).any()


# ---------------------------------------------------------------------------
# acceptance: 2-rank job under the port's launcher, NaN at a known step
# ---------------------------------------------------------------------------

HEALTH_CONFIG = """
nodes:
  - host: localhost
    workers: 2
    chief: true
"""

HEALTH_WORKER = """
import os
import numpy as np
import hetu_tpu_torch as ht

rank = int(os.environ.get("HETU_PS_RANK", "0"))
x = ht.Variable("x", trainable=False)
y_ = ht.Variable("y_", trainable=False)
w1 = ht.init.xavier_normal((12, 16), name="acc_w1")
w2 = ht.init.xavier_normal((16, 4), name="acc_w2")
h = ht.relu_op(ht.matmul_op(x, w1))
loss = ht.reduce_mean_op(
    ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
train = ht.optim.SGDOptimizer(0.1).minimize(loss)
exe = ht.Executor([loss, train], ctx=ht.cpu(0))
assert exe.config.health_monitor is not None, "HETU_HEALTH must arm it"
frng = np.random.RandomState(3 + rank)
for step in range(1, 14):
    xs = frng.randn(8, 12).astype("f")
    ys = np.eye(4, dtype="f")[frng.randint(0, 4, 8)]
    if step == 7:
        xs[0, 0] = np.nan          # the known injection step
    exe.run(feed_dict={x: xs, y_: ys})
exe.close()
print("health dryrun rank", rank, "done", flush=True)
"""


def test_acceptance_2rank_nan_injection(tmp_path):
    """Acceptance: NaN injected at step 7 of a 2-rank job trips within
    every_n=5 steps (at the step-10 sample), names the step and a layer,
    dumps artifacts, and the doctor CLI and the black box reproduce
    first-bad-step from the merged JSONL."""
    from torch_ps_util import clean_fleet_env
    cfg = tmp_path / "health.yml"
    cfg.write_text(HEALTH_CONFIG)
    script = tmp_path / "worker.py"
    script.write_text(HEALTH_WORKER)
    tdir = tmp_path / "teldir"
    env = clean_fleet_env()
    env.pop("HETU_TELEMETRY", None)
    env.pop("HETU_HEALTH", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "hetu_tpu_torch",
                                      "run_launcher.py"),
         "-c", str(cfg), "--telemetry", str(tdir),
         "--health", "every_n=5,action=dump", sys.executable, str(script)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("health dryrun rank") == 2, proc.stdout
    # per-rank health records exist and both ranks tripped at step 10
    for r in (0, 1):
        lines = [json.loads(ln) for ln in
                 (tdir / f"health_rank{r}.jsonl").read_text()
                 .splitlines()]
        assert [rec["step"] for rec in lines] == [5, 10]
        assert lines[0]["loss_finite"] and not lines[1]["loss_finite"]
        trips = lines[1]["trips"]
        assert any(t["kind"] == "nonfinite" for t in trips)
        assert any(t.get("layer") in ("acc_w1", "acc_w2")
                   for t in trips)
        # dump-rung artifacts via the crash-dump machinery
        assert (tdir / f"flight_rank{r}.json").exists()
        lastgood = json.loads(
            (tdir / f"health_lastgood_rank{r}.json").read_text())
        assert lastgood["step"] == 5
    # the doctor CLI reproduces first-bad-step from the merged JSONL
    out = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.health",
         str(tdir), "--json"],
        capture_output=True, text=True, env=_cli_env())
    assert out.returncode == 0, out.stdout + out.stderr
    rep = json.loads(out.stdout)
    assert rep["first_bad_step"] == 10
    assert rep["bad_ranks"] == [0, 1]
    assert rep["layer"] in ("acc_w1", "acc_w2")
    assert rep["loss_finite"] is False and rep["healthy"] is False
    assert rep["probable_causes"], rep
    # and the blackbox post-mortem names the same first bad step
    bb = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.blackbox",
         str(tdir), "--json"],
        capture_output=True, text=True, env=_cli_env())
    assert bb.returncode == 0, bb.stdout + bb.stderr
    bb_rep = json.loads(bb.stdout)
    assert bb_rep["health"]["first_bad_step"] == 10
