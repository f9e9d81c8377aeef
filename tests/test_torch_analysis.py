"""The port's preflight analysis (``hetu_tpu_torch/analysis``) against
the JAX package's: the twins of ``tests/test_analysis.py``'s graph
passes — shapes with the user's line, sharding, deadlock, memory, the
zoo, the frozen-graph pass — and ``Executor(validate=...)``.

Each twin builds the same graph in both packages from one builder (so
a node's construction line is the same line of this file), runs both
packages' ``analyze`` (or pass), and compares what the findings say:
code, severity, ``where``, the node's name up to the graph's id offset
(a name carries its package's node counter, which other graphs built in
the process have moved), and the data fields (HT402's bytes exactly).
The numerics (HT8xx) and efficiency (HT9xx) findings are compared too;
HT902 prices the card's GEMM granule where the JAX package prices the
TPU's lanes, and no twin graph here pads either. The JAX package's wire
pass (HT7xx) is ROADMAP item 17d and stays out of the comparison.
"""
import logging
import re

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.analysis as janalysis
import hetu_tpu_torch as tht
import hetu_tpu_torch.analysis as tanalysis
from hetu_tpu.analysis import deadlock as jdead
from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
from hetu_tpu_torch.analysis import deadlock as tdead
from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo

PKGS = {"jax": (jht, janalysis, jtopo, jdead),
        "torch": (tht, tanalysis, ttopo, tdead)}
# the pass still to port (ROADMAP 17d)
LATER = ("HT7",)


def _renumber(text, base):
    """``MatMulOp17`` -> ``MatMulOp<17 - base>`` everywhere in ``text``."""
    if text is None:
        return None
    return re.sub(r"\b([A-Z]\w*Op)(\d+)\b",
                  lambda m: f"{m.group(1)}{int(m.group(2)) - base}", text)


def view(report, nodes, topo, messages=False):
    """What ``report`` says, comparable across the packages: sorted
    (code, severity, where, node, data[, message]) of every finding
    outside HT7xx, node ids less the graph's smallest."""
    order = topo(list(nodes)) if nodes else []
    base = min((n.id for n in order), default=0)
    out = []
    for f in report.findings:
        if f.code.startswith(LATER):
            continue
        row = (f.code, f.severity, f.where, _renumber(f.node, base),
               tuple(sorted((k, repr(v)) for k, v in f.data.items())))
        if messages:
            row += (_renumber(f.message, base),)
        out.append(row)
    return sorted(out, key=repr)


def both(build, run, messages=False):
    """``build(ht)`` -> eval nodes (or (nodes, extra)), ``run(analysis,
    nodes, extra)`` -> report, in each package; returns {pkg: view}."""
    out = {}
    for name, (ht, analysis, topo, _) in PKGS.items():
        built = build(ht)
        nodes, extra = built if isinstance(built, tuple) else (built, None)
        out[name] = view(run(analysis, nodes, extra), nodes, topo,
                         messages)
    return out


# ---------------------------------------------------------------------------
# graph builders: one line of this file builds each node in both packages
# ---------------------------------------------------------------------------

def mlp_nodes(ht, w2_rows=256):
    """Tiny MLP; ``w2_rows != 256`` plants a matmul contraction
    mismatch. Returns ((eval_nodes, feeds), the mismatching line)."""
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w1 = ht.Variable("w1", value=np.zeros((784, 256), "f"))
    w2 = ht.Variable("w2", value=np.zeros((w2_rows, 10), "f"))
    h = ht.relu_op(ht.matmul_op(x, w1))
    logits = ht.matmul_op(h, w2)   # <- provenance must point HERE
    bad_line = logits.defined_at[1]
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    train_op = ht.optim.SGDOptimizer(0.1).minimize(loss)
    feeds = {x: ((8, 784), np.float32), y_: ((8, 10), np.float32)}
    return ([loss, train_op], feeds), bad_line


def staged_2rank(ht, back_edge=False):
    """2-stage MLP across worker0/worker1 hostname contexts. With
    ``back_edge`` the last block returns to worker0: a stage-0 node
    consuming a stage-1 boundary, a cross-rank cyclic wait."""
    with ht.context("worker0:cpu:0"):
        x = ht.Variable("x", trainable=False)
        w1 = ht.Variable("w1", value=np.zeros((20, 32), "f"))
        a = ht.relu_op(ht.matmul_op(x, w1))
    with ht.context("worker1:cpu:0"):
        w2 = ht.Variable("w2", value=np.zeros((32, 32), "f"))
        b = ht.relu_op(ht.matmul_op(a, w2))
    tail_ctx = "worker0:cpu:0" if back_edge else "worker1:cpu:0"
    with ht.context(tail_ctx):
        w3 = ht.Variable("w3", value=np.zeros((32, 10), "f"))
        y_ = ht.Variable("y_", trainable=False)
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(ht.matmul_op(b, w3), y_), [0])
        train_op = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return [loss, train_op]


def _feed(topo, nodes, name):
    return next(n for n in topo(nodes) if getattr(n, "name", "") == name)


# ---------------------------------------------------------------------------
# pass 1: shapes, and the user's line
# ---------------------------------------------------------------------------

def test_shape_mismatch_reports_user_line():
    lines = {}

    def build(ht):
        (nodes, feeds), lines[ht.__name__] = mlp_nodes(ht, w2_rows=128)
        return nodes, feeds

    got = both(build, lambda an, nodes, feeds: an.analyze(
        nodes, feed_shapes=feeds))
    assert got["torch"] == got["jax"]
    assert lines["hetu_tpu"] == lines["hetu_tpu_torch"]
    errs = [row for row in got["torch"] if row[0] == "HT101"]
    assert len(errs) == 1
    code, severity, where, node, _ = errs[0]
    assert severity == "error" and node.startswith("MatMulOp")
    # provenance: THIS test file and the logits = matmul_op(...) line
    assert "test_torch_analysis.py" in where
    assert where.endswith(f":{lines['hetu_tpu_torch']}")


def test_construction_site_names_the_models_line_inside_the_package():
    """A graph the package builds itself (the zoo): ``defined_at`` is the
    first caller outside the package (this file), ``composed_at`` the
    ``models/`` line that composed the op, as in the JAX package."""
    from hetu_tpu.analysis import zoo as jzoo
    from hetu_tpu_torch.analysis import zoo as tzoo
    sites = {}
    for name, zoo, topo in (("jax", jzoo, jtopo), ("torch", tzoo, ttopo)):
        nodes, _ = zoo.build("mlp")
        relu = next(n for n in topo(nodes) if n.op_type == "ReluOp")
        sites[name] = (relu.defined_at, relu.composed_at)
    for name, pkg in (("jax", "hetu_tpu"), ("torch", "hetu_tpu_torch")):
        (dfile, _), (cfile, _) = sites[name]
        assert dfile.endswith("test_torch_analysis.py")
        assert cfile.endswith(f"{pkg}/models/cnn.py")
    assert sites["torch"][0] == sites["jax"][0]


def test_clean_graph_no_errors_and_side_effect_free():
    got = {}
    for name, (ht, analysis, topo, _) in PKGS.items():
        (nodes, feeds), _ = mlp_nodes(ht)
        order = topo(nodes)
        report = analysis.analyze(nodes, feed_shapes=feeds)
        assert report.ok, report.to_text()
        # the pass must not leave inferred_shape droppings on the graph
        assert not any(hasattr(n, "inferred_shape") for n in order)
        got[name] = view(report, nodes, topo)
    assert got["torch"] == got["jax"]


def test_unknown_feeds_stop_propagation_without_false_positives():
    got = both(lambda ht: mlp_nodes(ht, w2_rows=128)[0][0],
               lambda an, nodes, _: an.analyze(nodes))
    assert got["torch"] == got["jax"]
    assert not [r for r in got["torch"] if r[0] == "HT101"]
    assert [r for r in got["torch"] if r[0] == "HT100"]


# ---------------------------------------------------------------------------
# Executor(validate=...)
# ---------------------------------------------------------------------------

def test_validate_error_raises_at_first_dispatch():
    wheres = {}
    for name, (ht, analysis, topo, _) in PKGS.items():
        (nodes, _), bad_line = mlp_nodes(ht, w2_rows=128)
        x, y_ = _feed(topo, nodes, "x"), _feed(topo, nodes, "y_")
        kw = {"device": "cpu"} if name == "torch" else {}
        exe = ht.Executor({"default": nodes}, ctx=ht.cpu(0),
                          validate="error", **kw)
        with pytest.raises(analysis.GraphValidationError) as ei:
            exe.run(feed_dict={x: np.zeros((8, 784), "f"),
                               y_: np.zeros((8, 10), "f")})
        f = ei.value.report.errors[0]
        assert f.code == "HT101" and f.where.endswith(f":{bad_line}")
        wheres[name] = f.where
    assert wheres["torch"] == wheres["jax"]


def test_validate_default_off_and_env_override(monkeypatch):
    from hetu_tpu.executor import HetuConfig as JConfig
    for ht, config_cls in ((jht, JConfig), (tht, tht.HetuConfig)):
        monkeypatch.delenv("HETU_VALIDATE", raising=False)
        (nodes, _), _ = mlp_nodes(ht)
        config = config_cls(eval_node_list=nodes, ctx=ht.cpu(0))
        assert config.validate == "off" and config.analysis_report is None
        monkeypatch.setenv("HETU_VALIDATE", "warn")
        (nodes2, _), _ = mlp_nodes(ht)
        config2 = config_cls(eval_node_list=nodes2, ctx=ht.cpu(0))
        assert config2.validate == "warn"
        assert config2.analysis_report is not None
        with pytest.raises(ValueError, match="unknown validate"):
            (nodes3, _), _ = mlp_nodes(ht)
            config_cls(eval_node_list=nodes3, ctx=ht.cpu(0),
                       validate="loud")


def test_validate_warn_clean_graph_runs():
    rng = np.random.RandomState(0)
    xv = rng.randn(8, 784).astype("f")
    yv = np.eye(10, dtype="f")[rng.randint(0, 10, 8)]
    got = {}
    for name, (ht, analysis, topo, _) in PKGS.items():
        (nodes, _), _ = mlp_nodes(ht)
        x, y_ = _feed(topo, nodes, "x"), _feed(topo, nodes, "y_")
        kw = {"device": "cpu"} if name == "torch" else {}
        exe = ht.Executor({"default": nodes}, ctx=ht.cpu(0),
                          validate="warn", **kw)
        out = exe.run(feed_dict={x: xv, y_: yv})
        got[name] = float(np.asarray(out[0].asnumpy()).item())
        assert np.isfinite(got[name])
        assert exe.config.analysis_report is not None
        got[name + "_view"] = view(exe.config.analysis_report, nodes, topo)
    assert got["torch_view"] == got["jax_view"]
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5)


def test_validate_warn_logs_the_error_findings(caplog):
    """``"warn"`` keeps the session and logs each error and warning."""
    (nodes, feeds), _ = mlp_nodes(tht)
    w = tht.Variable("dup_w1", value=np.zeros((4, 4), "f"))
    w2 = tht.Variable("dup_w1", value=np.zeros((4, 4), "f"))
    x = tht.Variable("xd", trainable=False)
    loss = tht.reduce_mean_op(tht.matmul_op(tht.matmul_op(x, w), w2), [0])
    train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    with caplog.at_level(logging.WARNING, logger="hetu_tpu_torch.executor"):
        cfg = tht.HetuConfig([loss, train], ctx=tht.cpu(0), validate="warn")
    assert "HT112" in {f.code for f in cfg.analysis_report.findings}
    assert any("preflight: [HT112]" in r.getMessage()
               for r in caplog.records)


def test_lint_duplicate_param_and_unused_variable():
    def build(ht):
        x = ht.Variable("x", trainable=False)
        w = ht.Variable("dup_w", value=np.zeros((4, 4), "f"))
        w2 = ht.Variable("dup_w", value=np.zeros((4, 4), "f"))
        frozen = ht.Variable("frozen_w", value=np.zeros((4, 4), "f"))
        y = ht.matmul_op(ht.matmul_op(ht.matmul_op(x, w), w2), frozen)
        loss = ht.reduce_mean_op(y, [0])
        # optimizer only covers w — w2/frozen train as constants
        train_op = ht.optim.SGDOptimizer(0.1).minimize(loss, var_list=[w])
        return [loss, train_op], {x: ((2, 4), np.float32)}

    got = both(build, lambda an, nodes, feeds: an.analyze(
        nodes, feed_shapes=feeds))
    assert got["torch"] == got["jax"]
    codes = {r[0] for r in got["torch"]}
    assert "HT112" in codes      # duplicate trainable name
    assert "HT111" in codes      # trainable but never updated


# ---------------------------------------------------------------------------
# pass 2: sharding
# ---------------------------------------------------------------------------

def _status(pkg, state, duplicate):
    from hetu_tpu.context import NodeStatus as JStatus
    from hetu_tpu_torch.context import NodeStatus as TStatus
    cls = JStatus if pkg == "jax" else TStatus
    return cls(state=state, duplicate=duplicate)


def _planner(pkg):
    from hetu_tpu.parallel import planner as jplanner
    from hetu_tpu_torch.parallel import planner as tplanner
    return jplanner if pkg == "jax" else tplanner


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_unmappable_status_becomes_ht201_with_collector(pkg):
    analysis = PKGS[pkg][1]
    st = _status(pkg, (1, 3), 1)                  # 3-way split...
    report = analysis.Report()
    with analysis.collecting(report):             # ...on a 2-axis mesh
        assert _planner(pkg).spec_for_status(st, {"tp0": 2},
                                             node="w_tp") is None
    assert [f.code for f in report.errors] == ["HT201"]
    assert "w_tp" in report.errors[0].message


def test_unmappable_status_messages_are_the_reference_words():
    msgs = {}
    for pkg in PKGS:
        analysis = PKGS[pkg][1]
        report = analysis.Report()
        with analysis.collecting(report):
            _planner(pkg).spec_for_status(_status(pkg, (1, 3), 1),
                                          {"tp0": 2}, node="w_tp")
        msgs[pkg] = [(f.code, f.severity, f.node, f.message)
                     for f in report.findings]
    assert msgs["torch"] == msgs["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_unmappable_status_warns_without_collector(pkg, caplog):
    logger = ("hetu_tpu" if pkg == "jax" else "hetu_tpu_torch") \
        + ".parallel.planner"
    with caplog.at_level(logging.WARNING, logger=logger):
        assert _planner(pkg).spec_for_status(
            _status(pkg, (1, 3), 1), {"tp0": 2}, node="w_tp") is None
    assert any("unmappable" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_emit_returns_false_without_collector(pkg):
    analysis = PKGS[pkg][1]
    assert analysis.emit("HT999", "error", "nobody listening") is False
    report = analysis.Report()
    with analysis.collecting(report):
        assert analysis.emit("HT999", "error", "captured", node="n0")
    assert len(report) == 1 and report.errors[0].node == "n0"


def test_deduce_states_that_raises_is_ht202():
    """A node whose ``deduce_states`` raises stays replicated; under a
    collector that is an HT202 finding naming it, in both packages."""
    got = {}
    for pkg, (ht, analysis, topo, _) in PKGS.items():
        with ht.context((ht.cpu(0), ht.cpu(1))):
            x = ht.Variable("x", trainable=False)
            w = ht.Variable("w_bad", value=np.zeros((8, 64), "f"))
            y = ht.relu_op(ht.matmul_op(x, ht.dispatch(w, (1, 2))))

        def broken(*_a, **_k):
            raise ValueError("planted")
        y.deduce_states = broken
        report = analysis.Report()
        with analysis.collecting(report):
            _planner(pkg).propagate_statuses(topo([y]))
        got[pkg] = view(report, [y], topo, messages=True)
    assert got["torch"] == got["jax"]
    assert {r[0] for r in got["torch"]} == {"HT202"}


def test_tp_plan_over_device_budget_is_ht204():
    def build(ht):
        with ht.context((ht.cpu(0), ht.cpu(1))):
            x = ht.Variable("x", trainable=False)
            w = ht.Variable("w_big", value=np.zeros((8, 64), "f"))
            wd = ht.dispatch(w, (1, 2))
            y = ht.matmul_op(x, wd)
            loss = ht.reduce_mean_op(y, [0])
        return [loss]

    got = {}
    for pkg, (ht, analysis, topo, _) in PKGS.items():
        nodes = build(ht)
        report = analysis.Report()
        analysis.sharding_pass(topo(nodes), report, ndevices=1)
        got[pkg] = view(report, nodes, topo, messages=True)
    assert got["torch"] == got["jax"]
    assert [r for r in got["torch"] if r[0] == "HT204"]


def test_ht204_counts_the_ranks_of_the_job(monkeypatch):
    """The port counts a plan's ranks, not cards: a launcher job's world
    size (several ranks may share one card); outside a job the session
    makes a plan's thread ranks itself, so none is short."""
    from hetu_tpu_torch.analysis.sharding import plan_ranks
    with tht.context((tht.cpu(0), tht.cpu(1))):
        x = tht.Variable("x", trainable=False)
        w = tht.Variable("w4", value=np.zeros((8, 64), "f"))
        loss = tht.reduce_mean_op(
            tht.matmul_op(x, tht.dispatch(w, (1, 4))), [0])
    order = ttopo([loss])
    monkeypatch.delenv("HETU_NUM_PROCS", raising=False)
    monkeypatch.delenv("HETU_PREFLIGHT", raising=False)
    assert plan_ranks() is None
    report = tanalysis.Report()
    tanalysis.sharding_pass(order, report)
    assert not [f for f in report.errors if f.code == "HT204"]
    monkeypatch.setenv("HETU_NUM_PROCS", "2")
    assert plan_ranks() == 2
    report = tanalysis.Report()
    tanalysis.sharding_pass(order, report)
    assert {f.code for f in report.errors} == {"HT204"}
    # a job of four ranks fits the 4-way split
    monkeypatch.setenv("HETU_NUM_PROCS", "4")
    report = tanalysis.Report()
    tanalysis.sharding_pass(order, report)
    assert not report.errors
    # under the launcher's --preflight the check is skipped
    monkeypatch.setenv("HETU_NUM_PROCS", "2")
    monkeypatch.setenv("HETU_PREFLIGHT", "1")
    report = tanalysis.Report()
    tanalysis.sharding_pass(order, report)
    assert not report.errors


# ---------------------------------------------------------------------------
# pass 3: deadlock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,kw", [("gpipe", {}),
                                         ("1f1b", {"num_microbatches": 4})])
def test_clean_gpipe_and_1f1b_schedules_have_zero_errors(schedule, kw):
    def run(analysis, nodes, _):
        report = analysis.Report()
        analysis.deadlock_pass(nodes, report, schedule=schedule, nprocs=2,
                               **kw)
        return report

    got = both(lambda ht: staged_2rank(ht), run, messages=True)
    assert got["torch"] == got["jax"] == []


def test_collective_chain_contract_clean():
    def run(analysis, nodes, _):
        report = analysis.Report()
        analysis.deadlock_pass(nodes, report, schedule="collective",
                               nprocs=2)
        return report

    got = both(lambda ht: staged_2rank(ht), run, messages=True)
    assert got["torch"] == got["jax"] == []


def test_cross_rank_cycle_is_ht302_naming_both_ranks():
    def run(analysis, nodes, _):
        report = analysis.Report()
        analysis.deadlock_pass(nodes, report, schedule="gpipe", nprocs=2)
        return report

    got = both(lambda ht: staged_2rank(ht, back_edge=True), run,
               messages=True)
    assert got["torch"] == got["jax"]
    errs = [r for r in got["torch"] if r[0] == "HT302"]
    assert errs
    text = " ".join(r[-1] for r in errs)
    assert "rank 0" in text and "rank 1" in text


def test_mutated_schedule_lost_send_is_ht301():
    """Mis-pair the schedule as a mutated splice would: rank 0's
    boundary send never happens, so rank 1 blocks forever on a transfer
    nobody makes."""
    got = {}
    for pkg, (ht, analysis, topo, dead) in PKGS.items():
        nodes = staged_2rank(ht)
        plan = dead.build_plan(nodes, nprocs=2)
        assert plan is not None and plan.nranks == 2
        programs = dead.rank_programs(plan, schedule="gpipe")
        programs[0] = [ev for ev in programs[0] if ev.kind != "send"]
        report = analysis.Report()
        assert not dead.simulate(programs, report)
        got[pkg] = view(report, nodes, topo, messages=True)
    assert got["torch"] == got["jax"]
    errs = [r for r in got["torch"] if r[0] == "HT301"]
    assert errs and "rank 1" in errs[0][-1] and "rank 0" in errs[0][-1]


def test_unpaired_markers_are_ht304():
    from hetu_tpu.ops.comm import PipelineSendOp as JSend
    from hetu_tpu_torch.ops.comm import PipelineSendOp as TSend
    got = {}
    for pkg, (ht, analysis, topo, _) in PKGS.items():
        send_cls = JSend if pkg == "jax" else TSend
        pending_before = send_cls.pending()
        try:
            recv = ht.pipeline_receive_op(source=0, ctx=ht.cpu(0))
            y = ht.relu_op(recv)
            report = analysis.Report()
            analysis.deadlock_pass([y], report, schedule="gpipe", nprocs=2)
            got[pkg] = view(report, [y], topo, messages=True)
        finally:
            stale = [s for s in send_cls.pending()
                     if s not in pending_before]
            send_cls.consume(stale)
    assert got["torch"] == got["jax"]
    assert [r[0] for r in got["torch"]] == ["HT304"]


def test_collective_order_divergence_is_ht303():
    got = {}
    for pkg, (_, analysis, _, dead) in PKGS.items():
        programs = {
            0: [dead.Event("collective", tag="AllReduceOp", label="g1"),
                dead.Event("collective", tag="AllGatherOp", label="g2")],
            1: [dead.Event("collective", tag="AllGatherOp", label="g2"),
                dead.Event("collective", tag="AllReduceOp", label="g1")],
        }
        report = analysis.Report()
        dead.collective_order_pass(programs, report)
        got[pkg] = view(report, [], None, messages=True)
    assert got["torch"] == got["jax"]
    errs = [r for r in got["torch"] if r[0] == "HT303"]
    assert errs and "#0" in errs[0][-1]


# ---------------------------------------------------------------------------
# pass 4: memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,want", [
    ("8G", 8 * 2 ** 30), ("512MiB", 512 * 2 ** 20), ("1024", 1024),
    (2048, 2048), ("1.5k", 1536), ("eight gigs", ValueError)])
def test_parse_bytes_units(value, want):
    from hetu_tpu.analysis.memory import parse_bytes as jparse
    from hetu_tpu_torch.analysis.memory import parse_bytes as tparse
    if want is ValueError:
        for parse in (jparse, tparse):
            with pytest.raises(ValueError):
                parse(value)
    else:
        assert tparse(value) == jparse(value) == want


def test_memory_budget_ht401_and_breakdown():
    got = {}
    for pkg, (ht, analysis, topo, _) in PKGS.items():
        (nodes, feeds), _ = mlp_nodes(ht)
        report = analysis.analyze(nodes, feed_shapes=feeds,
                                  hbm_budget="64K")
        errs = [f for f in report.errors if f.code == "HT401"]
        assert errs and "64.0KiB" in errs[0].message
        info = next(f for f in report.infos if f.code == "HT402")
        assert info.data["param_bytes"] == (784 * 256 + 256 * 10) * 4
        assert info.data["grad_bytes"] == info.data["param_bytes"]  # SGD
        assert info.data["opt_slot_bytes"] == 0
        # a generous budget stays clean
        assert analysis.analyze(nodes, feed_shapes=feeds,
                                hbm_budget="8G").ok
        got[pkg] = view(report, nodes, topo, messages=True)
    assert got["torch"] == got["jax"]


def test_memory_budget_resolution_order(monkeypatch):
    """Explicit > ``HETU_HBM_BUDGET`` > the card's memory (none here, and
    never read under ``HETU_PREFLIGHT``)."""
    from hetu_tpu_torch.analysis import memory
    monkeypatch.delenv("HETU_HBM_BUDGET", raising=False)
    monkeypatch.delenv("HETU_PREFLIGHT", raising=False)
    assert memory.resolve_budget() is None
    assert memory.resolve_budget(device="cpu") is None
    monkeypatch.setenv("HETU_HBM_BUDGET", "2G")
    assert memory.resolve_budget() == 2 * 2 ** 30
    assert memory.resolve_budget("1M") == 2 ** 20
    # the card's total memory where there is one, read from torch.cuda
    monkeypatch.delenv("HETU_HBM_BUDGET")

    class Props:
        total_memory = 80 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    assert memory.resolve_budget() == 80 * 2 ** 30
    assert memory.resolve_budget(device="cpu") is None
    monkeypatch.setenv("HETU_PREFLIGHT", "1")
    assert memory.resolve_budget() is None


def test_adam_slots_in_the_breakdown():
    got = {}
    for pkg, (ht, analysis, topo, _) in PKGS.items():
        x = ht.Variable("x", trainable=False)
        w = ht.Variable("w_adam", value=np.zeros((16, 8), "f"))
        loss = ht.reduce_mean_op(ht.matmul_op(x, w), [0])
        train = ht.optim.AdamOptimizer(1e-3).minimize(loss)
        report = analysis.analyze([loss, train],
                                  feed_shapes={x: ((4, 16), np.float32)})
        info = next(f for f in report.infos if f.code == "HT402")
        assert info.data["opt_slot_bytes"] == 2 * 16 * 8 * 4
        got[pkg] = view(report, [loss, train], topo)
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# the zoo, the frozen-graph pass and the serving session
# ---------------------------------------------------------------------------

def test_all_zoo_models_preflight_clean():
    from hetu_tpu.analysis import zoo as jzoo
    from hetu_tpu_torch.analysis import zoo as tzoo
    assert sorted(tzoo.ZOO) == sorted(jzoo.ZOO)
    failed, apart = {}, {}
    for name in sorted(tzoo.ZOO):
        views = {}
        for pkg, zoo in (("jax", jzoo), ("torch", tzoo)):
            _, analysis, topo, _ = PKGS[pkg]
            nodes, feeds = zoo.build(name)
            report = analysis.analyze(nodes, feed_shapes=feeds,
                                      hbm_budget="64G")
            if pkg == "torch" and report.errors:
                failed[name] = report.to_text()
            views[pkg] = view(report, nodes, topo)
        if views["torch"] != views["jax"]:
            apart[name] = views
    assert not failed, failed
    assert not apart, apart


def test_frozen_graph_pass_flags_training_ops():
    got = {}
    for pkg, (ht, analysis, topo, _) in PKGS.items():
        (nodes, _), _ = mlp_nodes(ht)
        report = analysis.analyze(nodes, frozen=True)
        assert [f for f in report.errors if f.code == "HT150"]
        # the eval-only closure is clean
        loss = nodes[0]
        assert not [f for f in analysis.analyze([loss], frozen=True).errors
                    if f.code in ("HT150", "HT151", "HT152")]
        got[pkg] = view(report, nodes, topo)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_inference_session_raises_via_analysis(pkg):
    ht = PKGS[pkg][0]
    if pkg == "jax":
        from hetu_tpu.serving import InferenceSession
        kw = {}
    else:
        from hetu_tpu_torch.serving import InferenceSession
        kw = {"device": "cpu"}
    (nodes, _), _ = mlp_nodes(ht)
    with pytest.raises(ValueError, match="OptimizerOp"):
        InferenceSession(nodes, ctx=ht.cpu(0), **kw)


def test_validate_analyzes_thread_ranks_and_pipelines_once(monkeypatch):
    """A session of thread ranks, and a staged pipeline, analyze the graph
    once (the front session; not each rank or stage), and train as they
    would unvalidated."""
    calls = []
    analyze = tanalysis.analyze

    def counted(*a, **kw):
        calls.append(1)
        return analyze(*a, **kw)
    monkeypatch.setattr(tanalysis, "analyze", counted)
    rng = np.random.RandomState(3)
    feeds = (rng.randn(8, 784).astype("f"),
             np.eye(10, dtype="f")[rng.randint(0, 10, 8)])
    losses = []
    for validate in ("off", "error"):
        (nodes, _), _ = mlp_nodes(tht)
        order = ttopo(nodes)
        exe = tht.Executor(nodes, ctx=[tht.gpu(0), tht.gpu(1)],
                           device="cpu", validate=validate)
        assert exe.config.local_ranks is not None
        assert [r.config.validate for r in exe.ranks] == ["off", "off"]
        out = exe.run(feed_dict=dict(zip(
            [_feed(ttopo, nodes, "x"), _feed(ttopo, nodes, "y_")], feeds)))
        losses.append(float(out[0].asnumpy()))
        exe.close()
        assert len(order) == len(ttopo(nodes))
    assert len(calls) == 1 and losses[0] == losses[1]
    nodes = staged_2rank(tht)
    exe = tht.Executor(nodes, gpipe=True, num_microbatches=2,
                       device="cpu", validate="error")
    assert len(calls) == 2 and exe.config.analysis_report.ok
