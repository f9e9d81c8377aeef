"""The port's preflight surfaces against the JAX package's: the
launcher's ``--preflight`` (the ``HETU_PREFLIGHT`` contract), the
zoo CLI, the JSON report, the pipeline-schedule checks of
``tests/test_autoplan.py`` (interleaved programs, HT301, HT308, the
auto-planned zoo), the overlap advisories of
``tests/test_ingest_overlap.py`` on the port's parameter server, and
GPT-2-small's footprint estimate.

The JAX package's ``test_heturun_preflight_rejects_deadlock_fast``
bounds the preflight's wall time at 5 s, which fails under load; its
twin holds the bound by structure instead: exit 121, HT302 naming both
ranks, no worker body run, no launcher process or port claim left, and
a preflight process that initialized no CUDA and joined no process
group — here, where there is no card, with the session's device left
to its default, ``cuda``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.analysis as janalysis
import hetu_tpu_torch as tht
import hetu_tpu_torch.analysis as tanalysis
from hetu_tpu_torch import launcher
from hetu_tpu_torch.analysis import deadlock as tdead
from test_torch_analysis import PKGS, staged_2rank, view
from torch_ps_util import clean_fleet_env, torch_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CLUSTER_YML = """
nodes:
  - host: localhost
    chief: true
    servers: 0
    workers: 2
"""

# the JAX package's deadlocking script on the port; its atexit hook
# records what the process touched before the preflight ended it
_DEADLOCK_SCRIPT = """
import atexit, json, os
import numpy as np
import hetu_tpu_torch as ht
from hetu_tpu_torch.executor import Executor


def _touched():
    import torch
    import torch.distributed as dist
    with open(os.environ["HETU_TEST_OUT"] + "/touched.json", "w") as f:
        json.dump({"cuda": torch.cuda.is_initialized(),
                   "group": dist.is_available() and dist.is_initialized()},
                  f)


atexit.register(_touched)
with ht.context("worker0:cpu:0"):
    x = ht.Variable("x", trainable=False)
    w1 = ht.Variable("w1", value=np.zeros((20, 32), "f"))
    a = ht.relu_op(ht.matmul_op(x, w1))
with ht.context("worker1:cpu:0"):
    w2 = ht.Variable("w2", value=np.zeros((32, 32), "f"))
    b = ht.relu_op(ht.matmul_op(a, w2))
with ht.context("worker0:cpu:0"):
    w3 = ht.Variable("w3", value=np.zeros((32, 10), "f"))
    y_ = ht.Variable("y_", trainable=False)
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(b, w3), y_), [0])
    train_op = ht.optim.SGDOptimizer(0.1).minimize(loss)
exe = Executor([loss, train_op], gpipe=True, num_microbatches=4)
# preflight exits inside HetuConfig: this sentinel must never appear
open(os.environ["HETU_TEST_OUT"] + "/WORKER_RAN", "w").write("x")
"""

_CLEAN_SCRIPT = _DEADLOCK_SCRIPT.replace(
    'with ht.context("worker0:cpu:0"):\n    w3',
    'with ht.context("worker1:cpu:0"):\n    w3')


# ---------------------------------------------------------------------------
# the launcher's --preflight
# ---------------------------------------------------------------------------

def test_heturun_preflight_rejects_deadlock_fast(tmp_path, capfd,
                                                 monkeypatch):
    """A mis-paired 2-stage schedule: exit 121 with HT302 naming both
    ranks, no worker spawned, nothing left behind, no card touched."""
    cfg_path = tmp_path / "cluster.yml"
    cfg_path.write_text(_CLUSTER_YML)
    script = tmp_path / "train.py"
    script.write_text(_DEADLOCK_SCRIPT)
    cfg = launcher.parse_config(str(cfg_path))
    monkeypatch.setenv("HETU_TEST_OUT", str(tmp_path))
    rc = launcher.run_preflight(cfg, [sys.executable, str(script)])
    assert rc == tanalysis.EXIT_PREFLIGHT == janalysis.EXIT_PREFLIGHT \
        == 121
    assert not (tmp_path / "WORKER_RAN").exists(), \
        "preflight ran the worker body"
    assert not launcher._procs and not launcher._claims
    touched = json.loads((tmp_path / "touched.json").read_text())
    assert touched == {"cuda": False, "group": False}
    out = capfd.readouterr()
    text = out.out + out.err
    assert "HT302" in text and "rank 0" in text and "rank 1" in text
    # the JAX package finds the same on the same graph
    jreport = janalysis.analyze(staged_2rank(jht, back_edge=True),
                                schedule="gpipe", nprocs=2,
                                num_microbatches=4)
    assert {f.code for f in jreport.errors} == {"HT302"}
    assert text.count("[HT302]") == len(jreport.errors)


def test_heturun_preflight_cli_clean_graph(tmp_path):
    """The whole CLI: a clean graph preflights OK (rc 0), writes its
    report, and still does not run the worker body."""
    cfg_path = tmp_path / "cluster.yml"
    cfg_path.write_text(_CLUSTER_YML)
    script = tmp_path / "train.py"
    script.write_text(_CLEAN_SCRIPT)
    env = clean_fleet_env(HETU_TEST_OUT=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.launcher", "-c",
         str(cfg_path), "--preflight", sys.executable, str(script)],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text
    assert "preflight: OK" in text and "graph verified clean" in text
    assert not (tmp_path / "WORKER_RAN").exists()
    report = text.split("graph verified clean (report: ")[1].split(")")[0]
    data = json.loads(open(report).read())
    assert data["errors"] == 0
    os.remove(report)
    os.rmdir(os.path.dirname(report))


def test_analysis_cli_zoo_subset():
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.analysis", "mlp", "logreg",
         "--all"],
        env=clean_fleet_env(), capture_output=True, text=True,
        timeout=120, cwd=REPO)
    # --all is refused naming its items; without it the subset runs
    assert proc.returncode == 2
    assert "ROADMAP item 17d" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.analysis", "mlp", "logreg"],
        env=clean_fleet_env(), capture_output=True, text=True,
        timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "== mlp: ok" in proc.stdout
    assert "== logreg: ok" in proc.stdout


def test_analysis_cli_refusals_and_list(capsys):
    """In process: ``--jit-purity`` is refused naming item 17d; ``--list``
    lists the JAX package's zoo."""
    from hetu_tpu.analysis import zoo as jzoo
    from hetu_tpu_torch.analysis.__main__ import main
    assert main(["--jit-purity"]) == 2
    assert "ROADMAP item 17d" in capsys.readouterr().err
    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(jzoo.ZOO)


def test_preflight_report_json_written(tmp_path):
    """The HETU_PREFLIGHT contract writes a machine-readable report at
    the given path; its findings are the JAX package's."""
    got = {}
    for pkg, (ht, analysis, topo, _) in PKGS.items():
        nodes = staged_2rank(ht, back_edge=True)
        report = analysis.analyze(nodes, schedule="gpipe", nprocs=2)
        path = tmp_path / f"preflight_{pkg}.json"
        with pytest.raises(SystemExit) as ei:
            analysis.finish_preflight(report, str(path))
        assert ei.value.code == analysis.EXIT_PREFLIGHT
        data = json.loads(path.read_text())
        assert data["errors"] >= 1
        assert any(f["code"] == "HT302" for f in data["findings"])
        got[pkg] = view(report, nodes, topo, messages=True)
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# pipeline schedules (tests/test_autoplan.py)
# ---------------------------------------------------------------------------

def _chain(ht, layers=4, h=32, seed=1, ctx_of=None):
    """Uniform matmul chain; ``ctx_of(k)`` supplies a context string per
    layer (None = one context)."""
    r = np.random.RandomState(seed)
    act = x = loss = train = y_ = None
    for k in range(layers):
        ctx = ht.context(ctx_of(k)) if ctx_of else ht.context(ht.cpu(0))
        with ctx:
            if k == 0:
                x = ht.Variable("x", trainable=False)
                act = x
            w = ht.Variable(f"w{k}", value=r.randn(h, h).astype("f") * .05)
            act = ht.matmul_op(act, w)
            if k < layers - 1:
                act = ht.relu_op(act)
            else:
                y_ = ht.Variable("y_", trainable=False)
                loss = ht.reduce_mean_op(
                    ht.softmaxcrossentropy_op(act, y_), [0])
                train = ht.optim.SGDOptimizer(0.3).minimize(loss)
    feeds = {x: ((16, h), np.float32), y_: ((16, h), np.float32)}
    return x, y_, loss, train, feeds


_INTERLEAVED = ["worker0:cpu:0", "worker1:cpu:0",
                "worker0:cpu:1", "worker1:cpu:1"]


def _programs_view(progs, nodes, topo):
    """Each rank's events with node ids less the graph's smallest."""
    base = min(n.id for n in topo(nodes))

    def tag(t):
        return t if not isinstance(t, tuple) else \
            (t[0], t[1], t[2] - base, t[3])
    return {r: [(e.kind, e.peer, tag(e.tag)) for e in prog]
            for r, prog in progs.items()}


def test_interleaved_rank_programs_drain_clean():
    """4 stages round-robin over worker0 / worker1 (V=2): the same
    per-rank programs as the JAX package's, event by event, and they
    drain."""
    got = {}
    for pkg, (ht, analysis, topo, dead) in PKGS.items():
        _, _, loss, train, _ = _chain(ht, layers=4, h=16,
                                      ctx_of=lambda k: _INTERLEAVED[k])
        plan = dead.build_plan([loss, train], nprocs=2)
        assert [s.owner for s in plan.stages] == [0, 1, 0, 1]
        report = analysis.Report()
        progs = dead.rank_programs(plan, schedule="1f1b",
                                   num_microbatches=4, report=report)
        got[pkg] = _programs_view(progs, [loss, train], topo)
        assert dead.simulate(progs, report)
        assert not report.errors
    assert got["torch"] == got["jax"]
    assert {r: len(p) for r, p in got["torch"].items()} == {0: 24, 1: 24}


def test_interleaved_lost_send_is_ht301():
    """A mutated fixture: drop one of rank 0's sends from the interleaved
    program — the symbolic run names the blocked recv."""
    got = {}
    for pkg, (ht, analysis, topo, dead) in PKGS.items():
        _, _, loss, train, _ = _chain(ht, layers=4, h=16,
                                      ctx_of=lambda k: _INTERLEAVED[k])
        plan = dead.build_plan([loss, train], nprocs=2)
        progs = dead.rank_programs(plan, schedule="1f1b",
                                   num_microbatches=4,
                                   report=analysis.Report())
        sends = [i for i, ev in enumerate(progs[0]) if ev.kind == "send"]
        del progs[0][sends[0]]
        bad = analysis.Report()
        assert not dead.simulate(progs, bad)
        got[pkg] = view(bad, [loss, train], topo, messages=True)
    assert got["torch"] == got["jax"]
    assert any(r[0] in ("HT301", "HT302") for r in got["torch"])


def test_blocked_collective_placement_is_ht308_in_preflight():
    """The collective form of HT308: virtual stages folded onto
    contexts that are not round-robin fail the preflight, as the
    collective builder refuses them at the first dispatch."""
    for ctx_of, bad in ((lambda k: f"v0:cpu:{k // 2}", True),
                        (lambda k: f"v{k // 4}:cpu:{k % 4}", False)):
        got = {}
        for pkg, (ht, analysis, topo, _) in PKGS.items():
            _, _, loss, train, _ = _chain(ht, layers=8, h=32,
                                          ctx_of=ctx_of)
            report = analysis.analyze([loss, train], schedule="collective",
                                      virtual_stages=2)
            got[pkg] = view(report, [loss, train], topo, messages=True)
        assert got["torch"] == got["jax"]
        codes = [r[0] for r in got["torch"] if r[1] == "error"]
        assert ("HT308" in codes) == bad


def test_blocked_placement_is_ht308():
    ctxs = ["worker0:cpu:0", "worker0:cpu:1",
            "worker1:cpu:0", "worker1:cpu:1"]
    got = {}
    for pkg, (ht, analysis, topo, dead) in PKGS.items():
        _, _, loss, train, _ = _chain(ht, layers=4, h=16,
                                      ctx_of=lambda k: ctxs[k])
        plan = dead.build_plan([loss, train], nprocs=2)
        report = analysis.Report()
        assert not dead.interleaved_placement_pass(plan, report,
                                                   virtual_stages=2)
        got[pkg] = view(report, [loss, train], topo, messages=True)
    assert got["torch"] == got["jax"]
    assert [r[0] for r in got["torch"]] == ["HT308"]


def test_auto_plans_preflight_clean_across_zoo():
    """The auto-picked plan for every zoo model passes the static
    preflight with zero errors once applied, in both packages, with the
    same findings."""
    from hetu_tpu.analysis import zoo as jzoo
    from hetu_tpu.parallel import autoplan as japlan
    from hetu_tpu.telemetry.costdb import CostDB as JDB
    from hetu_tpu_torch.analysis import zoo as tzoo
    from hetu_tpu_torch.parallel import autoplan as taplan
    from hetu_tpu_torch.telemetry.costdb import CostDB as TDB
    sides = {"jax": (jzoo, japlan, JDB), "torch": (tzoo, taplan, TDB)}
    failures, apart = {}, {}
    for name in sorted(tzoo.ZOO):
        views = {}
        for pkg, (zoo, aplan, DB) in sides.items():
            analysis, topo = PKGS[pkg][1], PKGS[pkg][2]
            nodes, feeds = zoo.build(name)
            res = aplan.choose_plan(nodes, nworld=8, feed_shapes=feeds,
                                    db=DB("/nonexistent/db.json"),
                                    model=name)
            overrides = aplan.apply_plan(nodes, res.plan, info=res.info)
            schedule = ("collective" if overrides.get("pipeline_mode")
                        else "1f1b" if overrides.get("pipedream")
                        else "gpipe")
            report = analysis.analyze(
                nodes, feed_shapes=feeds, schedule=schedule,
                num_microbatches=overrides.get("num_microbatches"),
                hbm_budget="64G")
            if report.errors:
                failures[f"{pkg}/{name}"] = [str(f) for f in report.errors]
            views[pkg] = view(report, nodes, topo)
        if views["torch"] != views["jax"]:
            apart[name] = views
    assert not failures, failures
    assert not apart, apart


def test_pp_tp_gpt_plan_preflights_clean_at_four_ranks():
    """``pp_tp_gpt``'s shape: a tiny GPT in 2 stages x tp=2, each stage a
    tuple context of two workers' devices, run by four ranks. The port's
    owners (a rank a device of a splitting tuple stage) give programs
    that drain with zero errors, and boundaries fan out rank k -> rank k
    of the next stage."""
    import hetu_tpu_torch.models as TM
    ctxs = [(tht.rgpu("worker0", 0), tht.rgpu("worker1", 0)),
            (tht.rgpu("worker2", 0), tht.rgpu("worker3", 0))]
    cfg = TM.GPTConfig(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=64,
                       hidden_dropout_prob=0.0, use_flash_attention=True)
    ids, labels, loss, _, train = TM.staged_gpt(cfg, ctxs, 1e-3)
    nodes = [loss, train]
    bindings, _ = tht.parallel.compile_rules(nodes, tp=2)
    tht.parallel.apply_rules(nodes, bindings)
    plan = tdead.build_plan(nodes, nprocs=4)
    assert [s.ranks for s in plan.stages] == [[0, 1], [2, 3]]
    for schedule, m in (("gpipe", None), ("1f1b", 4)):
        report = tanalysis.analyze(
            nodes, feed_shapes={ids: ((8, 64), np.int64),
                                labels: ((8, 64), np.int64)},
            schedule=schedule, nprocs=4, num_microbatches=m)
        assert report.ok, report.to_text()
        progs = tdead.rank_programs(plan, schedule=schedule,
                                    num_microbatches=m)
        peers = {r: {e.peer for e in p} for r, p in progs.items()}
        assert peers == {0: {2}, 1: {3}, 2: {0}, 3: {1}}


def test_tuple_stage_that_splits_nothing_runs_on_its_first_rank():
    """A tuple stage with no splitting dispatch keeps its first rank
    alone, as ``PipelineSubExecutor._plan_stages`` runs it; its second
    rank takes no part in the schedule."""
    with tht.context((tht.rgpu("worker0", 0), tht.rgpu("worker1", 0))):
        x = tht.Variable("x", trainable=False)
        w1 = tht.Variable("w1", value=np.zeros((8, 8), "f"))
        a = tht.relu_op(tht.matmul_op(x, w1))
    with tht.context(tht.rgpu("worker2", 0)):
        w2 = tht.Variable("w2", value=np.zeros((8, 4), "f"))
        y_ = tht.Variable("y_", trainable=False)
        loss = tht.reduce_mean_op(
            tht.softmaxcrossentropy_op(tht.matmul_op(a, w2), y_), [0])
        train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    plan = tdead.build_plan([loss, train], nprocs=3)
    assert [s.ranks for s in plan.stages] == [[0], [2]]
    report = tanalysis.Report()
    tdead.deadlock_pass([loss, train], report, nprocs=3)
    assert not report.findings


# ---------------------------------------------------------------------------
# overlap advisories (tests/test_ingest_overlap.py) on the port's server
# ---------------------------------------------------------------------------

def _embed_model(table_value, lr=0.1):
    ids = tht.Variable("io_ids", trainable=False)
    y_ = tht.Variable("io_y", trainable=False)
    table = tht.Variable("io_table", value=table_value)
    w = tht.Variable("io_w", value=np.full((4, 2), 0.3, np.float32))
    rows = tht.embedding_lookup_op(table, ids)
    pred = tht.matmul_op(tht.reduce_sum_op(rows, [1]), w)
    diff = pred + (-1) * y_
    loss = tht.reduce_mean_op(tht.reduce_sum_op(diff * diff, [1]), [0])
    train = tht.optim.SGDOptimizer(lr).minimize(loss)
    return ids, y_, w, loss, train


def _data(rng, steps, nrows=40, batch=8):
    return [(rng.randint(0, nrows, (batch, 3)),
             rng.randn(batch, 2).astype(np.float32))
            for _ in range(steps)]


@pytest.fixture(scope="module")
def ps_client():
    with torch_server() as (client, _):
        yield client


def test_ht501_ingest_disabled_on_ps_graph(ps_client):
    rng = np.random.RandomState(31)
    table = rng.randn(40, 4).astype(np.float32)
    ids, y_, w, loss, train = _embed_model(table)
    exe = tht.Executor([loss, train], comm_mode="PS", validate="warn",
                       ctx=tht.cpu(0), overlap_options={"ingest": False})
    codes = [f.code for f in exe.config.analysis_report.findings]
    assert "HT501" in codes
    exe.close()

    ids2, y2, w2, loss2, train2 = _embed_model(table)
    exe2 = tht.Executor([loss2, train2], comm_mode="PS", validate="warn",
                        ctx=tht.cpu(0))
    codes = [f.code for f in exe2.config.analysis_report.findings]
    assert "HT501" not in codes, "advisory must not fire with ingest on"
    exe2.close()


def test_ht502_plain_run_loop_advisory(ps_client, monkeypatch):
    from hetu_tpu_torch.analysis import overlap as overlap_mod
    monkeypatch.setattr(overlap_mod, "RUN_LOOP_ADVISORY_STEPS", 5)
    rng = np.random.RandomState(37)
    table = rng.randn(40, 4).astype(np.float32)
    data = _data(rng, 12)
    ids, y_, w, loss, train = _embed_model(table)
    exe = tht.Executor([loss, train], comm_mode="PS", validate="warn",
                       ctx=tht.cpu(0))
    for i, y in data[:4]:
        exe.run(feed_dict={ids: i, y_: y})
    # a block call resets the counter — no advisory yet
    exe.run_batches([{ids: i, y_: y} for i, y in data[4:6]])
    codes = [f.code for f in exe.config.analysis_report.findings]
    assert "HT502" not in codes
    for i, y in data[6:12]:
        exe.run(feed_dict={ids: i, y_: y})
    codes = [f.code for f in exe.config.analysis_report.findings]
    assert codes.count("HT502") == 1
    f = next(f for f in exe.config.analysis_report.findings
             if f.code == "HT502")
    assert "run_batches_stream" in f.message
    assert f.severity == "info", "advisory must never fail preflight"
    # fires once, not per step
    for i, y in data[:6]:
        exe.run(feed_dict={ids: i, y_: y})
    codes = [f.code for f in exe.config.analysis_report.findings]
    assert codes.count("HT502") == 1
    exe.close()


# ---------------------------------------------------------------------------
# GPT-2-small at full width
# ---------------------------------------------------------------------------

def test_gpt2_small_footprint_estimate_is_the_reference_bytes():
    """``train``'s graph on the card (GPT-2-small, B=8, S=1024, Adam):
    building it draws no weight in either package (parameters draw at
    the session's first step), so the full width is analyzed here; the
    HT402 breakdown is the JAX package's to the byte."""
    import hetu_tpu.models as JM
    import hetu_tpu_torch.models as TM
    widths = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=12,
                  num_attention_heads=12, max_position_embeddings=1024)
    got = {}
    for pkg, models in (("jax", JM), ("torch", TM)):
        ht, analysis, topo, _ = PKGS[pkg]
        cfg = models.GPTConfig(**widths, hidden_dropout_prob=0.0,
                               use_flash_attention=True)
        ids = ht.Variable("input_ids", trainable=False)
        labels = ht.Variable("labels", trainable=False)
        _, loss = models.GPTLMHeadModel(cfg)(ids, labels)
        lm = ht.reduce_mean_op(loss, [0, 1])
        train = ht.optim.AdamOptimizer(learning_rate=1e-4).minimize(lm)
        params = [n for n in topo([lm, train])
                  if getattr(n, "trainable", False)]
        assert params and all(getattr(p, "tensor_value", None) is None
                              for p in params)
        report = analysis.Report()
        order = topo([lm, train])
        shapes = analysis.shape_pass(
            order, report, feed_shapes={ids: ((8, 1024), np.int64),
                                        labels: ((8, 1024), np.int64)})
        got[pkg] = analysis.memory_pass(order, shapes, report,
                                        budget="80G")
        assert [f.code for f in report.findings] == ["HT402"]
    assert got["torch"] == got["jax"]
    # 163.0M parameters (the LM head a weight of its own), Adam's 2 slots
    assert got["torch"]["param_bytes"] == 4 * 163037184
    assert got["torch"]["opt_slot_bytes"] == 2 * got["torch"]["param_bytes"]


def test_a_preflight_plans_parallel_auto_without_a_card(monkeypatch):
    """Under ``HETU_PREFLIGHT`` an ``Executor(parallel="auto")`` plans on
    the machine it runs on, without a card, and the preflight analyzes
    the planned graph: exit 0, CUDA never initialized."""
    import torch
    monkeypatch.setenv("HETU_PREFLIGHT", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y_, loss, train, feeds = _chain(tht, layers=2, h=32)
    with pytest.raises(SystemExit) as exited:
        tht.Executor([loss, train], parallel="auto",
                     autoplan_options={"nworld": 2, "feed_shapes": feeds})
    assert exited.value.code == 0
    assert not torch.cuda.is_initialized()
