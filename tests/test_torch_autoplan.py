"""The port's cost-model planner (``hetu_tpu_torch/parallel/autoplan.py``)
and ``Executor(parallel="auto")`` against the JAX package's: twins of
tests/test_autoplan.py's planner tests, run on both packages in the same
test over the same numpy weights and feeds; the committed snapshot over
the committed CostDB fixture (the same ``plan_key``, the same candidate
order, ``predicted_ms`` within 1e-9 relative); ``parallel="auto"``
training against the JAX package's run of the same graph (rtol 2e-4,
atol 1e-5), on plans of each kind (dp, tp, pp; the port runs dp and tp
on thread ranks of one process, the JAX package on its host devices);
``HETU_AUTOPLAN_REPORT`` and the launcher's ``--autoplan`` in a
subprocess; two launcher ranks agreeing on one plan; a ``collective``
plan run as ``pipeline_mode="collective"``; and the refusals (no card
where one was not asked for).
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu.analysis import zoo as jzoo
from hetu_tpu.parallel import autoplan as japlan
from hetu_tpu.telemetry.costdb import CostDB as JDB
from hetu_tpu_torch.analysis import zoo as tzoo
from hetu_tpu_torch.parallel import autoplan as taplan
from hetu_tpu_torch.telemetry.costdb import CostDB as TDB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
FIXTURE = os.path.join(DATA, "costdb_fixture.json")
PACKAGES = {"jax": (jht, japlan, JDB, {}),
            "port": (tht, taplan, TDB, {"ctx": tht.cpu(0)})}


# ---------------------------------------------------------------------------
# model builders (tests/test_autoplan.py's, for either package)
# ---------------------------------------------------------------------------

def _chain(ht, layers=4, h=32, seed=1, widths=None, rows=16):
    """A matmul chain; ``widths`` gives each layer's (in, out)."""
    r = np.random.RandomState(seed)
    widths = widths or [(h, h)] * layers
    act = x = loss = train = y_ = None
    for k, (win, wout) in enumerate(widths):
        with ht.context(ht.cpu(0)):
            if k == 0:
                x = ht.Variable("x", trainable=False)
                act = x
            w = ht.Variable(f"w{k}",
                            value=r.randn(win, wout).astype("f") * .05)
            act = ht.matmul_op(act, w)
            if k < len(widths) - 1:
                act = ht.relu_op(act)
            else:
                y_ = ht.Variable("y_", trainable=False)
                loss = ht.reduce_mean_op(
                    ht.softmaxcrossentropy_op(act, y_), [0])
                train = ht.optim.SGDOptimizer(0.3).minimize(loss)
    feeds = {x: ((rows, widths[0][0]), np.float32),
             y_: ((rows, widths[-1][1]), np.float32)}
    return x, y_, loss, train, feeds


def _rows(rows, win, wout, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, win).astype("f"),
            np.eye(wout, dtype="f")[rng.randint(0, wout, rows)])


def _run(exe, x, y_, xv, yv, steps=3):
    out = []
    for _ in range(steps):
        res = exe.run(feed_dict={x: xv, y_: yv})
        out.append(float(np.asarray(res[0].asnumpy()).reshape(())))
    return np.asarray(out)


def _synthetic_db(DB, path, allreduce_ms, p2p_ms=0.01):
    db = DB(str(path))
    for nbytes in (1 << 14, 1 << 20):
        db.record("allreduce", nbytes, "float32", allreduce_ms,
                  nbytes=nbytes)
        db.record("p2p", nbytes, "float32", p2p_ms, nbytes=nbytes)
        db.record("h2d", nbytes, "float32", 0.05, nbytes=nbytes)
    return db


def _plans(res, ap):
    return [(ap.plan_key(p), p.predicted_ms, p.schedule, p.stage_cut)
            for p in res.candidates]


def _same_plans(got, want):
    assert [p[0] for p in got] == [p[0] for p in want]
    assert [p[2:] for p in got] == [p[2:] for p in want]
    for (_, a, _, _), (_, b, _, _) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-9, abs=0)


# ---------------------------------------------------------------------------
# 1. candidate enumeration and the cost inputs
# ---------------------------------------------------------------------------

def test_enumeration_prunes_invalid_factorizations():
    got = {}
    for name, (ht, ap, _DB, _kw) in PACKAGES.items():
        x, y_, loss, train, feeds = _chain(ht, layers=3, h=6)
        info = ap.graph_costs([loss, train], feed_shapes=feeds)
        got[name] = (ap.enumerate_candidates(8, info=info),
                     ap.enumerate_candidates(8, info=info,
                                             rules={"out": None}),
                     ap.enumerate_candidates(8, info=info, max_pp=2))
    assert got["port"] == got["jax"]
    (valid, rejected), (valid2, rejected2), _ = got["port"]
    assert all(tp in (1, 2, 3, 6) for _, tp, _ in valid)
    reasons = {c: r for c, r in rejected}
    assert any("divisible by tp=4" in r for r in reasons.values())
    assert (1, 1, 1) in valid
    assert all(tp == 1 for _, tp, _ in valid2)
    assert any("rules bind no axis to tp" in r for _, r in rejected2)
    assert any("deeper than" in r for _, r in rejected)


def test_balance_stages_by_measured_cost():
    costs = {f"op{i}": ms for i, ms in
             enumerate([1.0, 1.0, 1.0, 1.0, 4.0, 4.0])}
    order = list(costs)
    for pp in (1, 2, 3, 4, 6, 8):
        assert taplan.balance_stages(costs, order, pp) == \
            japlan.balance_stages(costs, order, pp)
    cuts, stage_ms = taplan.balance_stages(costs, order, 2)
    assert len(cuts) == 1 and abs(stage_ms[0] - stage_ms[1]) <= 4.0
    assert sum(stage_ms) == pytest.approx(12.0)


@pytest.mark.parametrize("model", ["gpt_tiny", "mlp", "wdl_adult",
                                   "resnet18"])
def test_graph_costs_match_the_reference(model, tmp_path):
    """op_ms, sources, param_bytes and splittable, node by node, over a
    DB that measured some ops (the rest FLOPs-scaled against them) and
    over an empty one (every op cold start)."""
    jnodes, jfeeds = jzoo.build(model)
    tnodes, tfeeds = tzoo.build(model)
    path = tmp_path / "ops.json"
    jinfo0 = japlan.graph_costs(jnodes, feed_shapes=jfeeds)
    db = JDB(str(path))
    for i, node in enumerate(jinfo0["fwd_order"][::3]):
        db.record(type(node).__name__, jinfo0["shapes"][node], "float32",
                  0.01 * (i + 1))
    db.save()
    for make in (lambda: None, lambda: "db"):
        jdb = JDB(str(path)) if make() else None
        tdb = TDB(str(path)) if make() else None
        j = japlan.graph_costs(jnodes, db=jdb, feed_shapes=jfeeds)
        t = taplan.graph_costs(tnodes, db=tdb, feed_shapes=tfeeds)
        # matched by place in the forward order (a node's name carries
        # its package's node counter)
        assert [n.op_type for n in t["fwd_order"]] == \
            [n.op_type for n in j["fwd_order"]]
        for tn, jn in zip(t["fwd_order"], j["fwd_order"]):
            assert t["op_ms"][tn] == pytest.approx(j["op_ms"][jn],
                                                   rel=1e-12, abs=0)
            assert t["sources"][tn] == j["sources"][jn]
        assert t["param_bytes"] == j["param_bytes"]
        assert t["splittable"] == j["splittable"]
    assert "measured" in t["sources"].values()


def test_graph_costs_take_a_bf16_profile(tmp_path):
    """The port keys a bf16 session's profiled ops ``bfloat16``. Its
    cost model looks each op up under the dtype it computes in: a
    session of ``dtype=torch.bfloat16`` reads the bf16 entries, an f32
    one the f32 entries, in a DB that holds both (the JAX package looks
    every op up as float32)."""
    import torch
    tnodes, tfeeds = tzoo.build("mlp")
    info0 = taplan.graph_costs(tnodes, feed_shapes=tfeeds)
    db = TDB(str(tmp_path / "bf16.json"))
    for node in info0["fwd_order"]:
        db.record(type(node).__name__, info0["shapes"][node], "bfloat16",
                  0.5)
    info = taplan.graph_costs(tnodes, db=db, feed_shapes=tfeeds,
                              dtype=torch.bfloat16)
    assert set(info["sources"].values()) == {"measured"}
    assert all(v == pytest.approx(1.5) for v in info["op_ms"].values())
    f32 = taplan.graph_costs(tnodes, db=db, feed_shapes=tfeeds)
    assert "measured" not in set(f32["sources"].values())
    for node in info0["fwd_order"]:
        db.record(type(node).__name__, info0["shapes"][node], "float32",
                  2.0)
    f32 = taplan.graph_costs(tnodes, db=db, feed_shapes=tfeeds)
    assert set(f32["sources"].values()) == {"measured"}
    assert all(v == pytest.approx(6.0) for v in f32["op_ms"].values())
    info = taplan.graph_costs(tnodes, db=db, feed_shapes=tfeeds,
                              dtype=torch.bfloat16)
    assert all(v == pytest.approx(1.5) for v in info["op_ms"].values())


def test_a_profile_prices_every_op_the_planner_prices(tmp_path):
    """``profile_op_records`` times the forward ops (the JAX package
    also times the gradient ops, which its planner never reads): over
    either package's profile of the zoo's tiny GPT, ``graph_costs``
    reads a measured cost for every op. A bf16 session's profile
    (flash attention, the port alone) is read under its dtype."""
    import torch
    from hetu_tpu.profiler import profile_op_records as jprofile
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.profiler import profile_op_records as tprofile
    rng = np.random.RandomState(0)
    sources = {}
    for name, zoo, ap, DB, profile, kw in (
            ("jax", jzoo, japlan, JDB, jprofile, {}),
            ("port", tzoo, taplan, TDB, tprofile, {"ctx": tht.cpu(0)})):
        nodes, feeds = zoo.build("gpt_tiny")
        values = {n: rng.randint(0, 64, shape).astype(dt)
                  for n, (shape, dt) in feeds.items()}
        rng = np.random.RandomState(0)
        exe = (jht if name == "jax" else tht).Executor(nodes, **kw)
        db = DB(str(tmp_path / f"{name}.json"))
        records = profile(exe, values, costdb=db)
        info = ap.graph_costs(nodes, db=db, feed_shapes=feeds)
        sources[name] = [info["sources"][n] for n in info["fwd_order"]]
        if name == "port":
            forward = {n.name for n in find_topo_sort(nodes[:1])}
            assert {r["name"] for r in records} <= forward
            assert len(records) == len(info["fwd_order"])
    assert sources["port"] == sources["jax"]
    assert set(sources["port"]) == {"measured"}

    cfg = tht.models.GPTConfig(vocab_size=64, hidden_size=32,
                               num_hidden_layers=2, num_attention_heads=4,
                               max_position_embeddings=16,
                               hidden_dropout_prob=0.0,
                               use_flash_attention=True)
    ids = tht.Variable("input_ids", trainable=False)
    labels = tht.Variable("labels", trainable=False)
    _, loss = tht.models.GPTLMHeadModel(cfg)(ids, labels)
    lm = tht.reduce_mean_op(loss, [0, 1])
    nodes = [lm, tht.optim.AdamOptimizer(1e-3).minimize(lm)]
    x = rng.randint(0, 64, (2, 16))
    shapes = {ids: ((2, 16), np.int64), labels: ((2, 16), np.int64)}
    exe = tht.Executor(nodes, ctx=tht.cpu(0), dtype=torch.bfloat16)
    db = TDB(str(tmp_path / "bf16.json"))
    records = tprofile(exe, {ids: x, labels: x}, costdb=db)
    assert not any("Grad" in r["kind"] for r in records)
    assert "bfloat16" in {r["dtype"] for r in records}
    info = taplan.graph_costs(nodes, db=db, feed_shapes=shapes,
                              dtype=torch.bfloat16)
    assert set(info["sources"].values()) == {"measured"}


# ---------------------------------------------------------------------------
# 2. the cost model and the measured refinement
# ---------------------------------------------------------------------------

def test_cost_model_ranks_slow_axis_tp_below_good_plan(tmp_path):
    got = {}
    for name, (ht, ap, DB, _kw) in PACKAGES.items():
        x, y_, loss, train, feeds = _chain(ht, layers=4, h=64)
        nodes = [loss, train]
        out = []
        for speed, ms in (("slow", 5000.0), ("fast", 0.001)):
            db = _synthetic_db(DB, tmp_path / f"{name}_{speed}.json", ms)
            info = ap.graph_costs(nodes, db=db, feed_shapes=feeds)
            info["bindings"], _ = ap.compile_rules(nodes, None, 8,
                                                   topo=info["topo"])
            out += [ap.score_plan(1, 8, 1, info, db=db).predicted_ms,
                    ap.score_plan(1, 1, 1, info, db=db).predicted_ms]
        got[name] = out
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-12)
    bad, good, bad_f, good_f = got["port"]
    assert bad > good and bad_f < good_f


def test_measured_refinement_overrides_prediction(tmp_path, monkeypatch):
    """The top-k finalists run through the autotune engine; the measured
    argmin wins even where the prediction preferred another plan, and
    the winner is cached (a second call sweeps nothing)."""
    from hetu_tpu import tune as jtune
    from hetu_tpu_torch import tune as ttune
    monkeypatch.delenv("HETU_AUTOTUNE", raising=False)
    got = {}
    for name, (ht, ap, DB, _kw), tune in (
            ("jax", PACKAGES["jax"], jtune),
            ("port", PACKAGES["port"], ttune)):
        tune.configure(path=str(tmp_path / f"{name}_tune.json"), mode="auto")
        try:
            x, y_, loss, train, feeds = _chain(ht, layers=4, h=64)
            db = DB(str(tmp_path / f"{name}_db.json"))
            measured = []

            def measure(plan):
                measured.append(ap.plan_key(plan))
                return 0.001 if plan.key()[:3] == (1, 1, 1) else 0.1

            res = ap.choose_plan([loss, train], nworld=8, db=db,
                                 feed_shapes=feeds, model="refine",
                                 measure=measure, topk=4)
            again = ap.choose_plan([loss, train], nworld=8, db=db,
                                   feed_shapes=feeds, model="refine",
                                   measure=lambda p: 1 / 0, topk=4)
            got[name] = (ap.plan_key(res.plan), measured,
                         [p.measured_ms is not None for p in res.candidates],
                         ap.plan_key(again.plan))
        finally:
            tune.reset()
    assert got["port"][:3] == got["jax"][:3]
    key, measured, _, again = got["port"]
    assert len(measured) == 4 and key == "dp1-tp1-pp1-M1-V1-f1"
    assert again == key


# ---------------------------------------------------------------------------
# 3. rules -> dispatch compilation
# ---------------------------------------------------------------------------

def _hand_mlp(ht, split):
    r = np.random.RandomState(1)
    x = ht.Variable("x", trainable=False)
    w1 = ht.Variable("w1", value=r.randn(8, 4).astype("f"))
    act = ht.matmul_op(x, ht.dispatch(w1, split) if split else w1)
    y_ = ht.Variable("y_", trainable=False)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(act, y_), [0])
    train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return w1, [loss, train]


def test_rules_compile_equals_hand_mlp_spec():
    from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
    from hetu_tpu.parallel.planner import propagate_statuses as jprop
    from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
    from hetu_tpu_torch.parallel.planner import propagate_statuses as tprop
    got = {}
    for name, (ht, ap, _DB, _kw), topo, prop in (
            ("jax", PACKAGES["jax"], jtopo, jprop),
            ("port", PACKAGES["port"], ttopo, tprop)):
        w1, hand = _hand_mlp(ht, (1, 2))
        hand_st = prop(topo(hand))[w1]
        w1b, nodes = _hand_mlp(ht, None)
        bindings, conflicts = ap.compile_rules(nodes, None, tp=2)
        ap.apply_rules(nodes, bindings)
        auto_st = prop(topo(nodes))[w1b]
        assert auto_st == hand_st and not conflicts
        got[name] = ([(b.param.name, b.parts) for b in bindings],
                     (auto_st.state, auto_st.duplicate, auto_st.order))
    assert got["port"] == got["jax"]
    assert got["port"][0] == [("w1", (1, 2))]


def test_rules_compile_equals_hand_embedding_spec():
    got = {}
    for name, (ht, ap, _DB, _kw) in PACKAGES.items():
        ids = ht.Variable("ids", trainable=False, dtype=np.int32)
        tbl = ht.Variable("tbl", value=np.random.RandomState(0)
                          .randn(16, 4).astype("f"))
        emb = ht.embedding_lookup_op(tbl, ids)
        loss = ht.reduce_mean_op(ht.reduce_sum_op(emb, [1]), [0])
        train = ht.optim.SGDOptimizer(0.1).minimize(loss)
        bindings, conflicts = ap.compile_rules([loss, train], None, tp=2)
        got[name] = [(b.param.name, b.parts, b.axes) for b in bindings
                     if b.param is tbl], conflicts
    assert got["port"] == got["jax"]
    assert got["port"][0] == [("tbl", (2, 1), ("vocab", "embed"))]


def test_hand_spec_conflict_is_ht205():
    from hetu_tpu.analysis import findings as jfind
    from hetu_tpu_torch.analysis import findings as tfind
    got = {}
    for name, (ht, ap, _DB, _kw), find in (
            ("jax", PACKAGES["jax"], jfind),
            ("port", PACKAGES["port"], tfind)):
        w1, nodes = _hand_mlp(ht, (2, 1))   # hand: rows; rules: columns
        report = find.Report()
        with find.collecting(report):
            bindings, conflicts = ap.compile_rules(nodes, None, tp=2)
        assert conflicts and conflicts[0][0] is w1
        assert not any(b.param is w1 for b in bindings)   # hand spec wins
        got[name] = [(f.code, f.severity, f.message, f.node)
                     for f in report.findings]
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == "HT205"


# ---------------------------------------------------------------------------
# 4. plan application
# ---------------------------------------------------------------------------

def _nonuniform(ht):
    return _chain(ht, widths=[(32, 16), (16, 32), (32, 16), (16, 32)])


def test_nonuniform_collective_plan_downgrades_without_resplice():
    from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
    from hetu_tpu.ops.comm import DispatchOp as JD
    from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
    from hetu_tpu_torch.ops.comm import DispatchOp as TD
    got = {}
    for name, (ht, ap, _DB, _kw), topo, D in (
            ("jax", PACKAGES["jax"], jtopo, JD),
            ("port", PACKAGES["port"], ttopo, TD)):
        x, y_, loss, train, feeds = _nonuniform(ht)
        nodes = [loss, train]
        info = ap.graph_costs(nodes, feed_shapes=feeds)
        bindings, _ = ap.compile_rules(nodes, None, 2, topo=info["topo"])
        plan = ap.Plan(dp=1, tp=2, pp=2, M=4, V=2, schedule="collective",
                       bindings=bindings)
        ov = ap.apply_plan(nodes, plan, info=info)
        disp = [n for n in topo(nodes) if isinstance(n, D)]
        assert disp and not any(isinstance(d.inputs[0], D) for d in disp)
        got[name] = (ov, plan.V, plan.schedule, len(disp),
                     [(n.raw_ctx[0].hostname, n.raw_ctx[0].device_id)
                      for n in info["fwd_order"]])
    assert got["port"] == got["jax"]
    ov = got["port"][0]
    assert "pipeline_mode" not in ov and ov.get("gpipe")


def test_apply_plan_to_rebuilt_graph_resplices():
    """A plan applied to a REBUILT graph recompiles its rules against
    that graph: the same dispatches splice in as the reference's."""
    from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
    from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
    counts = {}
    for name, (ht, ap, _DB, _kw), topo in (
            ("jax", PACKAGES["jax"], jtopo),
            ("port", PACKAGES["port"], ttopo)):
        x, y_, loss, train, _ = _chain(ht, layers=2, h=32)
        bindings, _ = ap.compile_rules([loss, train], None, tp=2)
        plan = ap.Plan(dp=1, tp=2, pp=1, schedule="spmd",
                       bindings=bindings, rules=None)
        x2, y2, loss2, train2, _ = _chain(ht, layers=2, h=32)
        ap.apply_plan([loss2, train2], plan)
        counts[name] = [tuple(n.parts) for n in topo([loss2, train2])
                        if type(n).__name__ == "DispatchOp"]
    assert counts["port"] == counts["jax"]
    assert len(counts["port"]) >= 2


def _chunk_names(ht, ap, **kw):
    """(hostname, device id) of each chunk of a pp=2, V=2 plan of an
    8-layer chain, in order."""
    x, y_, loss, train, feeds = _chain(ht, layers=8, h=32)
    info = ap.graph_costs([loss, train], feed_shapes=feeds)
    ap.apply_plan([loss, train], ap.Plan(dp=1, tp=1, pp=2, M=4, V=2,
                                         schedule="collective"),
                  info=info, **kw)
    names = []
    for n in info["fwd_order"]:
        c = n.raw_ctx[0]
        if (c.hostname, c.device_id) not in names:
            names.append((c.hostname, c.device_id))
    return names


def test_virtual_chunks_fold_onto_ranks_as_the_reference():
    """In one process a V > 1 plan's chunks carry the reference's names
    (``v<v>``, device c mod pp); in a launcher's job chunk c is
    ``worker<c mod pp>``, which the pipeline maps to that rank: the same
    round-robin fold onto the pp ranks as the reference's onto its
    devices."""
    from hetu_tpu_torch.parallel.pipeline import _owner_of
    want = _chunk_names(jht, japlan)
    assert want == [("v0", 0), ("v0", 1), ("v1", 0), ("v1", 1)]
    assert _chunk_names(tht, taplan, device="cpu", in_job=False) == want
    in_job = _chunk_names(tht, taplan, device="cpu", in_job=True)
    assert [_owner_of(h, 2) for h, _ in in_job] == [d for _, d in want]
    assert len(set(in_job)) == 4        # four distinct stages


def test_collective_plan_is_refused_naming_11b2():
    """A ``collective`` plan (a uniform chain at V > 1) is applied as the
    JAX package applies it: ``pipeline_mode="collective"`` with its
    ``virtual_stages`` and M, the chunks on the reference's contexts."""
    x, y_, loss, train, feeds = _chain(tht, layers=8, h=32)
    info = taplan.graph_costs([loss, train], feed_shapes=feeds)
    plan = taplan.Plan(dp=1, tp=1, pp=2, M=4, V=2, schedule="collective")
    ov = taplan.plan_overrides([loss, train], plan, info=info, device="cpu")
    assert ov["pipeline_mode"] == "collective"
    assert ov["pp_options"]["virtual_stages"] == 2
    assert ov["num_microbatches"] == 4 and not ov.get("gpipe")
    jx, jy, jloss, jtrain, jfeeds = _chain(jht, layers=8, h=32)
    jov = japlan.apply_plan([jloss, jtrain], plan, info=japlan.graph_costs(
        [jloss, jtrain], feed_shapes=jfeeds))
    assert {k: jov[k] for k in ("pipeline_mode", "num_microbatches")} == \
        {k: ov[k] for k in ("pipeline_mode", "num_microbatches")}
    assert jov["pp_options"]["virtual_stages"] == 2


def test_collective_choice_is_refused_by_the_executor(tmp_path):
    """A uniform chain whose cheapest plan over two devices is the
    interleaved collective pipeline (V=4), which survives the uniformity
    check: both packages choose it and run it as ``pipeline_mode=
    "collective"``; the port's ``parallel="auto"`` session trains it as
    the JAX package's does, 3 losses within 1e-5."""
    widths = [(256, 256)] * 8
    losses, plans = {}, {}
    for name, (ht, ap, DB, kw) in PACKAGES.items():
        x, y_, loss, train, feeds = _chain(ht, widths=widths, rows=64)
        db = _synthetic_db(DB, tmp_path / f"{name}.json", 1000.0, 1e-6)
        exe = ht.Executor([loss, train], parallel="auto",
                          rules={"out": None},
                          autoplan_options={"nworld": 2, "db": db,
                                            "feed_shapes": feeds}, **kw)
        plan = exe.config.autoplan.plan
        assert plan.schedule == "collective" and plan.V == 4
        assert exe.config.pipeline_mode == "collective"
        plans[name] = ap.plan_key(plan)
        xv, yv = _rows(64, 256, 256)
        losses[name] = _run(exe, x, y_, xv, yv)
    sub = exe.subexecutors["default"]
    assert sub.schedule == "collective"
    assert (sub._cpp.V, sub._cpp.S_dev) == (4, 2)
    assert plans["port"] == plans["jax"]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)


def test_more_microbatches_than_rows_is_refused_by_both():
    """``score_plan`` may pick M above the batch's rows (it sees no
    batch): the JAX package's staged runner refuses it at the first step
    and so does the port's (ROADMAP §3, a fault of the reference)."""
    widths = [(512, 256), (256, 512), (512, 256), (256, 512)]
    errors = {}
    for name, (ht, ap, DB, kw) in PACKAGES.items():
        x, y_, loss, train, feeds = _chain(ht, widths=widths, rows=64)
        db = _synthetic_db(DB, f"/nonexistent/{name}.json", 1000.0, 1e-6)
        exe = ht.Executor([loss, train], parallel="auto",
                          rules={"out": None},
                          autoplan_options={"nworld": 8, "db": db,
                                            "feed_shapes": feeds}, **kw)
        plan = exe.config.autoplan.plan
        assert plan.pp == 2 and plan.M == 32
        xv, yv = _rows(16, 512, 512)
        with pytest.raises((AssertionError, ValueError)) as e:
            exe.run(feed_dict={x: xv, y_: yv})
        errors[name] = str(e.value)
    assert "32 microbatches" in errors["jax"]
    assert "32 microbatches" in errors["port"]


# ---------------------------------------------------------------------------
# 5. Executor(parallel="auto") against the JAX package's run
# ---------------------------------------------------------------------------

def _auto_losses(name, tmp_path, allreduce_ms, p2p_ms, rules, widths,
                 rows, nworld=8, shaped=True):
    ht, ap, DB, kw = PACKAGES[name]
    x, y_, loss, train, feeds = _chain(ht, widths=widths, rows=rows)
    db = None if allreduce_ms is None else _synthetic_db(
        DB, tmp_path / f"{name}.json", allreduce_ms, p2p_ms)
    opts = {"nworld": nworld, "feed_shapes": feeds if shaped else None}
    opts["db"] = db if db is not None else DB(str(tmp_path / "none.json"))
    exe = ht.Executor([loss, train], parallel="auto", rules=rules,
                      autoplan_options=opts, **kw)
    xv, yv = _rows(rows, widths[0][0], widths[-1][1])
    return ap.plan_key(exe.config.autoplan.plan), _run(exe, x, y_, xv, yv), \
        exe


@pytest.mark.parametrize("case", ["baseline", "dp", "tp", "pp"])
def test_executor_parallel_auto_matches_the_reference(case, tmp_path):
    """The plan each package picks is the same, and its training is the
    JAX package's within rtol 2e-4 / atol 1e-5: the one-device baseline
    (tests/test_autoplan.py:508's graph), a dp plan (8 thread ranks),
    a tp plan (8 thread ranks, the weights split by the rules) and a
    2-stage GPipe plan (in one process)."""
    spec = {"baseline": (None, None, None, [(32, 32)] * 3, 16),
            "dp": (1e-6, 1e-6, {"out": None}, [(32, 32)] * 4, 16),
            "tp": (1e-6, 1e-6, None, [(32, 32)] * 3, 16),
            "pp": (1000.0, 1e-6, {"out": None},
                   [(512, 256), (256, 512), (512, 256), (256, 512)], 64)}
    ar, p2p, rules, widths, rows = spec[case]
    # unshaped feeds (construction-time planning) price the tp splits'
    # partial sums at no bytes: the tp plan wins there
    shaped = case != "tp"
    jkey, jloss, _ = _auto_losses("jax", tmp_path, ar, p2p, rules, widths,
                                  rows, shaped=shaped)
    tkey, tloss, exe = _auto_losses("port", tmp_path, ar, p2p, rules,
                                    widths, rows, shaped=shaped)
    assert tkey == jkey
    want = {"baseline": "dp1-tp1-pp1", "dp": "dp8-tp1-pp1",
            "tp": "dp1-tp8-pp1", "pp": "dp1-tp1-pp2"}[case]
    assert tkey.startswith(want)
    np.testing.assert_allclose(tloss, jloss, rtol=2e-4, atol=1e-5)
    ranks = {"baseline": 1, "dp": 8, "tp": 8, "pp": 1}[case]
    assert len(exe.ranks) == ranks
    if case == "dp":
        assert exe.config.overlap.bucket_bytes == 4 << 20
    if case == "pp":
        assert exe.config.use_gpipe and exe.config.num_microbatches == 32


def test_autoplan_snapshot_against_the_fixture(monkeypatch):
    """With the committed fixture CostDB each snapshot model's plan, its
    candidate order and every candidate's predicted ms are the JAX
    package's (1e-9 relative), and the key is the committed snapshot."""
    monkeypatch.setenv("HETU_AUTOTUNE", "1")    # cache-only: no sweeps
    snapshot = json.loads(open(os.path.join(
        DATA, "autoplan_snapshot.json")).read())
    got = {}
    for name in snapshot:
        jnodes, jfeeds = jzoo.build(name)
        tnodes, tfeeds = tzoo.build(name)
        jres = japlan.choose_plan(jnodes, nworld=8, db=JDB(FIXTURE),
                                  feed_shapes=jfeeds, model=name)
        tres = taplan.choose_plan(tnodes, nworld=8, db=TDB(FIXTURE),
                                  feed_shapes=tfeeds, model=name,
                                  device="cpu")
        _same_plans(_plans(tres, taplan), _plans(jres, japlan))
        assert tres.rejected == jres.rejected
        assert tres.coverage == jres.coverage
        got[name] = taplan.plan_key(tres.plan)
    assert got == snapshot


def test_autoplan_report_env_exits_before_fleet(tmp_path):
    """HETU_AUTOPLAN_REPORT: the config prints the plan table, writes
    the JSON report and exits 0 before any executor machinery; the JSON
    is the JAX package's report of the same script, field for field
    but the measured times."""
    docs = {}
    for package in ("hetu_tpu", "hetu_tpu_torch"):
        ctx = ", ctx=ht.cpu(0)" if package == "hetu_tpu_torch" else ""
        script = tmp_path / f"train_{package}.py"
        script.write_text(
            "import numpy as np\n"
            f"import {package} as ht\n"
            "x = ht.Variable('x', trainable=False)\n"
            "w = ht.Variable('w', value=np.ones((8, 8), 'f'))\n"
            "y_ = ht.Variable('y_', trainable=False)\n"
            "loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(\n"
            "    ht.matmul_op(x, w), y_), [0])\n"
            "train = ht.optim.SGDOptimizer(0.1).minimize(loss)\n"
            f"exe = ht.Executor([loss, train]{ctx})\n"
            "raise SystemExit('executor machinery ran past the report')\n")
        report_path = tmp_path / f"{package}.json"
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               "HETU_AUTOPLAN_REPORT": str(report_path),
               "HETU_COSTDB": str(tmp_path / "none.json"),
               "HETU_NUM_PROCS": "8"}
        proc = subprocess.run([sys.executable, str(script)], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "autoplan: OK" in proc.stdout
        assert "chosen:" in proc.stderr
        docs[package] = json.loads(report_path.read_text())
    t, j = docs["hetu_tpu_torch"], docs["hetu_tpu"]
    assert t["chosen"] == j["chosen"] and t["rejected"] == j["rejected"]
    assert t["coverage"] == j["coverage"]
    assert [c["predicted_ms"] for c in t["candidates"]] == \
        pytest.approx([c["predicted_ms"] for c in j["candidates"]],
                      rel=1e-9)
    assert "hetu_tpu_torch.telemetry.costdb --sweep" in \
        taplan.AutoPlanResult(taplan.Plan(predicted_ms=1.0), [], [],
                              ([], []), "m", 1).render()


def test_entry_point_not_asked_for_the_cpu_raises():
    """No fallback that hides the device: without ``ctx=cpu`` the
    planned session runs on the card, and a CPU-only host raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    x, y_, loss, train, feeds = _chain(tht, layers=2, h=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tht.Executor([loss, train], parallel="auto",
                     autoplan_options={"nworld": 1})


# ---------------------------------------------------------------------------
# 6. a launcher job: --autoplan, and two ranks that agree on one plan
# ---------------------------------------------------------------------------

# (widths, rows) of the launcher jobs' chains: the synthetic DB makes
# collectives free for "dp", allreduce slow and p2p free for "pp" (a
# 2-stage GPipe plan); "one" plans over an empty DB
JOB_CASES = {"dp": ([(32, 32)] * 3, 16), "one": ([(32, 32)] * 3, 16),
             "pp": ([(512, 256), (256, 512), (512, 256), (256, 512)], 64)}

SPMD = """
spmd: true
nodes:
  - host: localhost
    workers: 2
    chief: true
"""

WORKER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, os.environ["TEST_DIR"])
import hetu_tpu_torch as ht
from hetu_tpu_torch.telemetry.costdb import CostDB
from test_torch_autoplan import _chain, _rows, _synthetic_db, JOB_CASES
CASES = JOB_CASES

case = os.environ["AUTO_CASE"]
out = os.environ["HETU_TEST_OUT"]
rank = int(os.environ.get("RANK", "0"))
widths, rows = CASES[case]
x, y_, loss, train, feeds = _chain(ht, widths=widths, rows=rows)
db = CostDB(os.path.join(out, "none.json")) if case == "one" else \
    _synthetic_db(CostDB, os.path.join(out, f"db{rank}.json"),
                  1e-6 if case == "dp" else 1000.0, 1e-6)
exe = ht.Executor([loss, train], ctx=ht.cpu(0), parallel="auto",
                  rules={"out": None},
                  autoplan_options={"db": db, "feed_shapes": feeds})
xv, yv = _rows(rows, widths[0][0], widths[-1][1])
losses = []
for _ in range(3):
    res = exe.run(feed_dict={x: xv, y_: yv})
    losses.append(None if res[0] is None else float(res[0].asnumpy()))
from hetu_tpu_torch.parallel.autoplan import plan_key
with open(os.path.join(out, f"{case}_{rank}.json"), "w") as f:
    json.dump({"key": plan_key(exe.config.autoplan.plan),
               "nworld": exe.config.autoplan.nworld, "losses": losses,
               "idle": exe.config.idle}, f)
"""


def _launch(tmp_path, case, autoplan=False, timeout=180):
    from torch_ps_util import clean_fleet_env
    cfg = tmp_path / "spmd.yml"
    cfg.write_text(SPMD)
    script = tmp_path / "auto_worker.py"
    script.write_text(WORKER)
    env = clean_fleet_env(HETU_TEST_OUT=str(tmp_path), AUTO_CASE=case,
                          TEST_DIR=os.path.join(ROOT, "tests"))
    cmd = [sys.executable, os.path.join(ROOT, "hetu_tpu_torch",
                                        "run_launcher.py"),
           "-c", str(cfg)] + (["--autoplan"] if autoplan else []) + \
        [sys.executable, str(script)]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"the job did not finish in {timeout} s:\n"
                             + out[-4000:])
    return proc.returncode, out


def test_launcher_autoplan_previews_the_plan_of_the_job(tmp_path):
    """``--autoplan`` runs the script once, plans for the job's world
    (two ranks) and exits 0 with the report; then the job itself, with
    ``parallel="auto"``: both ranks take rank 0's plan (dp=2: the
    synthetic DB makes collectives free), and their losses are one
    process's."""
    rc, out = _launch(tmp_path, "dp", autoplan=True)
    assert rc == 0, out
    assert "autoplan: OK" in out and "autoplan: report written to" in out
    path = out.split("autoplan: report written to ")[1].split()[0]
    report = json.loads(open(path).read())
    assert report["nworld"] == 2
    preview = "dp{dp}-tp{tp}-pp{pp}-M{M}-V{V}-f{fuse_ticks}".format(
        **report["chosen"])
    rc, out = _launch(tmp_path, "dp")
    assert rc == 0, out
    ranks = [json.loads((tmp_path / f"dp_{r}.json").read_text())
             for r in range(2)]
    assert ranks[0]["key"] == ranks[1]["key"] == preview
    assert preview.startswith("dp2-tp1-pp1")
    assert ranks[0]["losses"] == ranks[1]["losses"]
    _, one, _ = _auto_losses("port", tmp_path, None, None, None,
                             [(32, 32)] * 3, 16, nworld=1)
    np.testing.assert_allclose(ranks[0]["losses"], one, rtol=1e-5)


def test_launcher_ranks_left_out_of_the_plan_run_nothing(tmp_path):
    """An empty CostDB prices collectives at the cold-start floor and
    the one-device plan wins: rank 0 trains alone (its losses one
    process's), rank 1 is idle and returns None."""
    rc, out = _launch(tmp_path, "one")
    assert rc == 0, out
    ranks = [json.loads((tmp_path / f"one_{r}.json").read_text())
             for r in range(2)]
    assert ranks[0]["key"] == ranks[1]["key"] == "dp1-tp1-pp1-M1-V1-f1"
    assert ranks[0]["nworld"] == ranks[1]["nworld"] == 2
    assert not ranks[0]["idle"] and ranks[1]["idle"]
    assert ranks[1]["losses"] == [None] * 3
    _, one, _ = _auto_losses("port", tmp_path, None, None, None,
                             [(32, 32)] * 3, 16, nworld=1)
    np.testing.assert_allclose(ranks[0]["losses"], one, rtol=1e-6)


def test_launcher_pipeline_plan_runs_its_stages_on_the_ranks(tmp_path):
    """A 2-stage GPipe plan in a 2-rank job: chunk k on ``worker<k>``,
    rank 1 owns the loss; its losses are the same plan's in one
    process (the stages on this process's devices), bit for bit."""
    rc, out = _launch(tmp_path, "pp")
    assert rc == 0, out
    ranks = [json.loads((tmp_path / f"pp_{r}.json").read_text())
             for r in range(2)]
    assert ranks[0]["key"] == ranks[1]["key"] == "dp1-tp1-pp2-M32-V1-f2"
    assert ranks[0]["losses"] == [None] * 3
    widths, rows = JOB_CASES["pp"]
    _, one, _ = _auto_losses("port", tmp_path, 1000.0, 1e-6,
                             {"out": None}, widths, rows, nworld=2)
    np.testing.assert_array_equal(ranks[1]["losses"], one)
