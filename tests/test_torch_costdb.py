"""The port's CostDB (``hetu_tpu_torch/telemetry/costdb.py``) and per-op
profiler against the JAX package's: twins of tests/test_doctor.py's
CostDB tests, tests/test_efficiency.py's bucket recommendation and
tests/test_autoplan.py's cold-start and coverage tests. Each feeds both
packages' databases the same records and compares what they answer;
the producers (the per-op profile, the comm sweep over thread ranks,
the PS sweep against the port's own server) run in the port.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu.telemetry import costdb as jcost
from hetu_tpu_torch.telemetry import costdb as tcost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jcost, "port": tcost}


def _ev(name, ts, dur, **args):
    ev = {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
          "pid": 0, "tid": 0, "cat": "hetu"}
    if args:
        ev["args"] = args
    return ev


def _mlp(ht):
    """An MLP whose forward holds nine op kinds (a biased layer, a gated
    activation), so that a profile of its forward ops alone, with the
    comm sweep's four, persists 13 kinds."""
    x = ht.Variable("dr_x", trainable=False)
    y_ = ht.Variable("dr_y", trainable=False)
    w1 = ht.init.xavier_normal((16, 12), name="dr_w1")
    b1 = ht.init.zeros((12,), name="dr_b1")
    w2 = ht.init.xavier_normal((12, 4), name="dr_w2")
    z = ht.matmul_op(x, w1)
    z = ht.relu_op(ht.add_op(z, ht.broadcastto_op(b1, z)))
    h = ht.mul_op(ht.sigmoid_op(z), ht.tanh_op(z))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return x, y_, loss, train


def test_costdb_12_kinds_survive_restart(tmp_path):
    """profile_op_records + the comm sweep (two thread ranks on the CPU:
    allreduce over their gloo group, p2p through their pipe channels)
    persist >= 12 kinds, and a FRESH CostDB over the same file serves
    every profiled record. The op kinds, shapes and dtypes are the JAX
    package's profile of the same graph's forward ops (the port times
    no gradient op: the planner prices forward ops only)."""
    from hetu_tpu.graph.autodiff import find_topo_sort
    from hetu_tpu.profiler import profile_op_records as jprofile
    from hetu_tpu_torch.profiler import profile_op_records as tprofile
    rng = np.random.RandomState(0)
    xv = rng.randn(8, 16).astype("f")
    yv = np.eye(4, dtype="f")[rng.randint(0, 4, 8)]
    records = {}
    for name, ht, profile, kw in (
            ("jax", jht, jprofile, {}),
            ("port", tht, tprofile, {"ctx": tht.cpu(0)})):
        x, y_, loss, train = _mlp(ht)
        exe = ht.Executor([loss, train], **kw)
        exe.run(feed_dict={x: xv, y_: yv})
        db = PACKAGES[name].CostDB(str(tmp_path / f"{name}.json"))
        records[name] = profile(exe, {x: xv, y_: yv}, costdb=db)
        assert all({"name", "kind", "shape", "dtype", "ms"} <= set(r)
                   for r in records[name])
        if name == "jax":
            forward = {n.name for n in find_topo_sort([loss])}
            assert len(forward) < len(records[name])
            records[name] = [r for r in records[name]
                             if r["name"] in forward]

    def ident(recs):
        return sorted((r["kind"], tuple(r["shape"] or ()), r["dtype"])
                      for r in recs)

    assert ident(records["port"]) == ident(records["jax"])
    db_path = str(tmp_path / "port.json")
    db = tcost.CostDB(db_path)
    swept = tcost.comm_microbench(db, sizes=(1 << 14, 1 << 16), reps=1,
                                  device="cpu", ranks=2)
    assert swept == {k: 2 for k in ("h2d", "d2h", "allreduce", "p2p")}
    reloaded = tcost.CostDB(db_path)          # fresh instance: disk only
    kinds = reloaded.kinds()
    assert len(kinds) >= 12, kinds
    assert {"h2d", "d2h", "allreduce", "p2p"} <= set(kinds)
    hits = sum(1 for r in records["port"]
               if reloaded.get(r["kind"], r["shape"], r["dtype"]))
    assert hits == len(records["port"])
    assert reloaded.curve("h2d")["points"] >= 2
    assert reloaded.estimate_ms("h2d", 1 << 15) is not None
    assert all(k.startswith("cpu|") for k in reloaded.entries())


def test_costdb_running_mean_and_min(tmp_path):
    got = {}
    for name, mod in PACKAGES.items():
        db = mod.CostDB(str(tmp_path / f"{name}.json"))
        db.record("MatMulOp", (8, 8), "float32", 2.0)
        db.record("MatMulOp", (8, 8), "float32", 4.0)
        ent = db.get("MatMulOp", (8, 8))
        got[name] = (ent["n"], ent["ms"], ent["min_ms"], ent["shape"])
    assert got["port"] == got["jax"] == (2, 3.0, 2.0, "8x8")


def test_costdb_record_spans_from_trace(tmp_path):
    events = [
        _ev("h2d_transfer", 0, 500, bytes=3000, overlapped=False),
        _ev("ps:pull", 600, 1500, bytes=8192, overlapped=True),
        _ev("p2p_send", 2200, 700, tag="t", dst=1, bytes=4096),
        _ev("step", 0, 10),           # not a comm span: ignored
    ]
    got = {}
    for name, mod in PACKAGES.items():
        db = mod.CostDB(str(tmp_path / f"{name}.json"))
        n = mod.record_spans(db, events)
        got[name] = (n, db.get("h2d", 4096, "bytes")["ms"],
                     db.get("ps_pull", 8192, "bytes")["ms"],
                     db.get("p2p", 4096, "bytes")["ms"], db.coverage())
    assert got["port"] == got["jax"]
    n, h2d, pull, p2p, (present, missing) = got["port"]
    assert n == 3 and (h2d, pull, p2p) == (0.5, 1.5, 0.7)
    assert "h2d" in present and "ps_sparse_pull" in missing


def test_costdb_ps_microbench_live_server(tmp_path):
    """The PS sweep against the port's own server (started here on a
    port of its own, with a timeout of its own): bandwidth points for
    all four PS comm kinds, persisted."""
    from torch_ps_util import torch_server
    result = {}

    def sweep():
        with torch_server() as (client, _ports):
            db = tcost.CostDB(str(tmp_path / "c.json"))
            result["swept"] = tcost.ps_microbench(db, client,
                                                  sizes=(16, 128), reps=1)

    t = threading.Thread(target=sweep, daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "the PS sweep did not finish within 120 s"
    assert result["swept"] == {k: 2 for k in
                               ("ps_sparse_pull", "ps_sparse_push",
                                "ps_pull", "ps_push")}
    reloaded = tcost.CostDB(str(tmp_path / "c.json"))
    present, _missing = reloaded.coverage()
    assert {"ps_sparse_pull", "ps_sparse_push", "ps_pull",
            "ps_push"} <= set(present)
    assert reloaded.curve("ps_sparse_pull")["points"] == 2


def test_costdb_corrupt_file_cold_start(tmp_path):
    for name, mod in PACKAGES.items():
        p = tmp_path / f"{name}.json"
        p.write_text("{not json")
        db = mod.CostDB(str(p))
        assert len(db) == 0
        db.record("k", (1,), "float32", 1.0)
        db.save()
        assert mod.CostDB(str(p)).get("k", (1,)) is not None


def test_costdb_files_are_read_by_both_packages(tmp_path):
    """One file, written by either package, reads the same in both:
    keys, curves and estimates (the committed fixture is one such)."""
    path = str(tmp_path / "shared.json")
    tdb = tcost.CostDB(path)
    for nbytes, ms in ((1 << 14, 0.3), (1 << 20, 1.1), (1 << 23, 4.7)):
        tdb.record("allreduce", nbytes, "float32", ms, nbytes=nbytes)
    tdb.save()
    jdb = jcost.CostDB(path)
    assert jdb.entries() == tcost.CostDB(path).entries()
    assert jdb.curve("allreduce") == tdb.curve("allreduce")
    for nbytes in (1 << 12, 1 << 14, 3 << 20):
        assert tdb.estimate_info("allreduce", nbytes) == \
            jdb.estimate_info("allreduce", nbytes)


def test_recommend_bucket_bytes(tmp_path):
    got = {}
    for name, mod in PACKAGES.items():
        db = mod.CostDB(str(tmp_path / f"{name}.json"))
        cold = (mod.recommend_bucket_bytes(None),
                mod.recommend_bucket_bytes(db))
        db.record("allreduce", 1 << 14, "float32", 5.0, nbytes=1 << 14)
        db.record("allreduce", 1 << 24, "float32", 30.0, nbytes=1 << 24)
        got[name] = cold + (mod.recommend_bucket_bytes(db),
                            mod.latency_crossover_bytes(db))
    assert got["port"] == got["jax"]
    c0, c1, rec, cross = got["port"]
    assert c0 == c1 == 4 << 20
    assert rec == int(min(64 << 20, max(1 << 20, 4 * cross)))


def test_autoplan_dp_plan_sets_bucket_bytes():
    from hetu_tpu.parallel import autoplan as japlan
    from hetu_tpu_torch.parallel import autoplan as taplan

    def matmul(ht):
        a = ht.init.random_normal((256, 4096), name="a902")
        b = ht.init.random_normal((4096, 128), name="b902")
        return [ht.reduce_mean_op(ht.matmul_op(a, b), [0, 1])]

    for ht, ap in ((jht, japlan), (tht, taplan)):
        ov = ap.apply_plan(matmul(ht), ap.Plan(dp=2, tp=1, pp=1,
                                               schedule="spmd"))
        assert ov["overlap_options"]["bucket_bytes"] == 4 << 20
        assert "overlap_options" not in ap.apply_plan(
            matmul(ht), ap.Plan(dp=1, tp=1, pp=1, schedule="spmd"))


def test_costdb_cold_start_fallback(tmp_path):
    got = {}
    for name, mod in PACKAGES.items():
        db = mod.CostDB(str(tmp_path / f"{name}.json"))
        cold = db.estimate_ms("allreduce", 1 << 20, cold_start=True)
        info = db.estimate_info("allreduce", 1 << 20)
        none = db.estimate_ms("allreduce", 1 << 20)
        db.record("allreduce", 1 << 20, "bytes", 2.5, nbytes=1 << 20)
        got[name] = (cold, info, none, db.estimate_info("allreduce",
                                                        1 << 20))
    assert got["port"] == got["jax"]
    cold, (val, src), none, measured = got["port"]
    assert 0 < cold < 1e4 and src == "cold_start" and val == cold
    assert none is None and measured == (2.5, "measured")
    # the cold-start constants are the reference's, value for value
    assert tcost._COLD_GBPS == jcost._COLD_GBPS
    assert tcost._COLD_LATENCY_MS == jcost._COLD_LATENCY_MS
    assert tcost._COLD_GFLOPS == jcost._COLD_GFLOPS
    assert tcost.cold_start_flops_ms(1e9) == jcost.cold_start_flops_ms(1e9)


def test_costdb_coverage_measured_vs_guessed(tmp_path):
    got = {}
    for name, mod in PACKAGES.items():
        db = mod.CostDB(str(tmp_path / f"{name}.json"))
        db.record("h2d", 1 << 14, "float32", 0.5, nbytes=1 << 14)
        got[name] = (db.coverage(("h2d", "allreduce")),
                     db.coverage((("h2d", 1 << 14, "float32"),
                                  ("h2d", 1 << 20, "float32"))))
    assert got["port"] == got["jax"]
    (measured, guessed), (m2, g2) = got["port"]
    assert measured == ["h2d"] and guessed == ["allreduce"]
    assert len(m2) == 1 and len(g2) == 1


def test_microbench_refuses_the_card_without_cuda(tmp_path):
    """An entry point not asked for the CPU runs on the card, and a
    CPU-only host raises instead of measuring the CPU under the card's
    name."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcost.comm_microbench(tcost.CostDB(str(tmp_path / "c.json")),
                              sizes=(1 << 14,), reps=1)


def test_costdb_cli_sweep_and_show(tmp_path):
    """``python -m hetu_tpu_torch.telemetry.costdb --sweep --device cpu
    --ranks 2`` then ``--show --json``: the file the sweep wrote, its
    comm curves, every key ``cpu|...``."""
    path = str(tmp_path / "cli.json")
    env = {**os.environ, "PYTHONPATH": ROOT}
    sweep = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.costdb", "--db",
         path, "--sweep", "--device", "cpu", "--ranks", "2"],
        env=env, capture_output=True, text=True, timeout=180)
    assert sweep.returncode == 0, sweep.stderr
    assert "comm coverage" in sweep.stdout
    show = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.costdb", "--db",
         path, "--show", "--json"],
        env=env, capture_output=True, text=True, timeout=120)
    assert show.returncode == 0, show.stderr
    doc = json.loads(show.stdout)
    assert {"h2d", "d2h", "allreduce", "p2p"} <= set(doc["curves"])
    assert all(k.startswith("cpu|") for k in doc["entries"])


def test_telemetry_facade_imports_without_side_effects():
    """The disabled facade stays what it was: importing it (and the
    CostDB beside it) loads no JAX, touches no file and enables
    nothing."""
    code = (
        "import sys, os\n"
        "import hetu_tpu_torch.telemetry as t\n"
        "import hetu_tpu_torch.telemetry.costdb as c\n"
        "assert t.NULL.enabled is False and t.resolve() is t.NULL\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'hetu_tpu')]\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": ROOT,
           "HOME": os.path.join(ROOT, "_no_home_")}
    env.pop("HETU_TELEMETRY", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert not os.path.exists(os.path.join(ROOT, "_no_home_"))
