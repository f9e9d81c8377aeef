"""The port's measured-range harness (``hetu_tpu_torch/analysis/
rangecheck.py``) and the executor's range capture against the JAX
package's: the twins of ``tests/test_numerics.py``'s recorder, soundness
gate, range DB and CLI tests, on ``_mlp_executor``'s graph in f32 with
the same weights (drawn from the names) and the same numpy feeds.

The port measures on the eager walk, on the recorder's cadence only (the
reference reduces inside every compiled step and fetches at the
cadence): the measured (lo, hi) per stable key agree within 1e-5
relative; a ``run_batches`` block folds its steps on the device and is
read in one fetch. Off cadence the capture costs nothing, which
``test_off_cadence_capture_is_structurally_free`` pins. Everything runs
on the CPU (``device="cpu"``); ``tests/test_torch_rangecheck_cuda.py``
holds the card's ranges against these.
"""
import json
import math

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu.analysis import Report as JReport
from hetu_tpu.analysis import rangecheck as jrc
from hetu_tpu.analysis.numerics import numerics_pass as jnumerics
from hetu_tpu.analysis.shapes import shape_pass as jshape_pass
from hetu_tpu.telemetry import health as jhealth
from hetu_tpu import telemetry as jtel
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.analysis import Report
from hetu_tpu_torch.analysis import numerics as tnum
from hetu_tpu_torch.analysis import rangecheck as trc
from hetu_tpu_torch.analysis.shapes import shape_pass
from hetu_tpu_torch.graph.autodiff import find_topo_sort
from hetu_tpu_torch.telemetry import health as thealth
from test_torch_health import _allocations
from test_torch_numerics import codes, twin

REL = 1e-5


@pytest.fixture(autouse=True)
def _reset_global_state():
    """An enabled ``telemetry=`` becomes its package's process default
    and a health monitor its package's last one: reset both packages'
    after each test, so later tests run with neither."""
    yield
    ttel._default = None
    jtel._default = None
    thealth._LAST = None
    jhealth._LAST = None


def _mlp_executor(ht, **kw):
    x = ht.Variable("xrc", trainable=False)
    w1 = ht.init.xavier_normal((6, 8), name="w1rc")
    w2 = ht.init.xavier_normal((8, 2), name="w2rc")
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(ht.matmul_op(h, w2), [0, 1])
    train = ht.optim.SGDOptimizer(0.05).minimize(loss)
    if ht is tht:
        kw.setdefault("ctx", tht.cpu(0))
    return ht.Executor([loss, train], **kw), x


def _close(a, b):
    return a == b or (math.isfinite(a) and math.isfinite(b)
                      and abs(a - b) <= REL * max(abs(a), abs(b)) + 1e-7)


def assert_same_measured(got, want):
    assert got and got.keys() == want.keys(), (sorted(got), sorted(want))
    diff = {k: (got[k], want[k]) for k in got
            if not (_close(got[k][0], want[k][0])
                    and _close(got[k][1], want[k][1]))}
    assert not diff, diff


def _recorded(ht, rc, drive, every_n=1):
    exe, x = _mlp_executor(ht)
    rec = rc.RangeRecorder(exe, every_n=every_n).attach()
    try:
        drive(exe, x, rec)
    finally:
        rec.detach()
    return exe, x, rec


def _steps(n, seed=1):
    def drive(exe, x, rec):
        rng = np.random.RandomState(seed)
        for _ in range(n):
            exe.run(feed_dict={x: rng.randn(4, 6).astype("f")})
            rec.sample()
    return drive


# ---------------------------------------------------------------------------
# the capture and the recorder
# ---------------------------------------------------------------------------

def test_range_recorder_fused_capture():
    _, _, jrec = _recorded(jht, jrc, _steps(3))
    exe, x, rec = _recorded(tht, trc, _steps(3))
    assert rec.fetches == jrec.fetches == 3
    assert rec.measured, "no ranges captured"
    for name, (lo, hi) in rec.measured.items():
        assert lo <= hi, name
    keyed = rec.by_stable_key()
    assert keyed and all(":" in k for k in keyed)
    assert_same_measured(keyed, jrec.by_stable_key())
    # the detached executor runs without the capture
    sub = exe.subexecutors["default"]
    assert sub._range_capture is None
    exe.run(feed_dict={x: np.ones((4, 6), "f")})


def test_range_recorder_block_path():
    # a run_batches block keeps the running min/max of its steps on the
    # device: one fetch after it, as after the reference's scan block
    def drive(exe, x, rec):
        rng = np.random.RandomState(2)
        exe.run_batches([{x: rng.randn(4, 6).astype("f")}
                         for _ in range(3)])
        rec.sample()
    _, _, jrec = _recorded(jht, jrc, drive)
    exe, _, rec = _recorded(tht, trc, drive)
    assert rec.fetches == jrec.fetches == 1 and rec.measured
    for name, (lo, hi) in rec.measured.items():
        assert np.isscalar(lo) or np.ndim(lo) == 0
        assert lo <= hi, name
    assert_same_measured(rec.by_stable_key(), jrec.by_stable_key())


def test_cadence_measures_what_the_reference_fetches():
    # every_n=2 over 4 steps: steps 2 and 4 are read, in both packages
    _, _, jrec = _recorded(jht, jrc, _steps(4), every_n=2)
    _, _, rec = _recorded(tht, trc, _steps(4), every_n=2)
    assert rec.fetches == jrec.fetches == 2
    assert_same_measured(rec.by_stable_key(), jrec.by_stable_key())


def test_losses_with_the_recorder_equal_losses_without():
    feeds = np.random.RandomState(3).randn(5, 4, 6).astype("f")
    losses = []
    for on in (True, False):
        exe, x = _mlp_executor(tht)
        rec = trc.RangeRecorder(exe).attach() if on else None
        got = []
        for f in feeds:
            got.append(exe.run(feed_dict={x: f},
                               convert_to_numpy_ret_vals=True)[0])
            if rec is not None:
                rec.sample()
        losses.append(np.array(got))
    np.testing.assert_array_equal(losses[0], losses[1])


def test_off_cadence_capture_is_structurally_free(monkeypatch):
    """An off-cadence step observes nothing, reads nothing to the host
    and allocates exactly what the same step without a recorder
    allocates; a captured step is read in ONE copy, the steps' pairs
    folded into one [nodes, 2] f32 tensor on the device."""
    calls = {"observe": 0, "cpu": 0}
    real_observe = trc.RangeCapture.observe

    def observe(self, i, value):
        calls["observe"] += 1
        return real_observe(self, i, value)

    monkeypatch.setattr(trc.RangeCapture, "observe", observe)
    on, x = _mlp_executor(tht)
    off, x_off = _mlp_executor(tht)
    rec = trc.RangeRecorder(on, every_n=4).attach()
    sub = on.subexecutors["default"]
    f = np.random.RandomState(0).randn(4, 6).astype("f")
    for _ in range(2):                      # steps 1-2: off cadence
        on.run(feed_dict={x: f})
        off.run(feed_dict={x_off: f})
        rec.sample()
    assert calls["observe"] == 0 and rec.fetches == 0
    assert sub._range_capture._pending == []
    # step 3 of each, off cadence: the same allocations
    got = _allocations(lambda: on.run(feed_dict={x: f}))
    want = _allocations(lambda: off.run(feed_dict={x_off: f}))
    assert got == want, (got, want)
    assert calls["observe"] == 0
    # step 4: captured, one device tensor, read in one copy
    on.run(feed_dict={x: f})
    n = len(sub.topo_order)
    assert calls["observe"] == n
    (entry,) = sub._range_capture._pending
    assert entry[1].dtype == torch.float32 and entry[1].shape[1] == 2
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        calls["cpu"] += 1
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    rec.sample()
    monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
    assert calls["cpu"] == 1 and rec.fetches == 1
    assert len(rec.measured) == entry[1].shape[0]
    rec.detach()


def test_capture_measures_what_the_reference_measures():
    """The values measured: floating, non-empty tensors (a 0-d loss
    too), an IndexedSlices gradient by its rows (the reference's
    ``.values``), NaN kept as NaN; host values, integers, bools and
    empty tensors skipped."""
    from hetu_tpu_torch.ndarray import IndexedSlices
    cap = trc.RangeCapture()
    rows = torch.tensor([[1.0, -3.0], [2.0, 5.0]])
    cap.observe(0, torch.tensor([1.5, -2.0], dtype=torch.bfloat16))
    cap.observe(1, None)
    cap.observe(2, torch.tensor([1, 2]))
    cap.observe(3, torch.tensor([True]))
    cap.observe(4, torch.zeros(0, 3))
    cap.observe(5, torch.tensor(0.25))
    cap.observe(6, IndexedSlices(torch.tensor([0, 9]), rows, (10, 2)))
    cap.observe(7, torch.tensor([1.0, float("nan")]))
    cap.observe(8, (torch.ones(2), torch.ones(2)))   # a packed gradient
    cap.end_step()
    got = cap.take()
    assert [i for i, _, _ in got] == [0, 5, 6, 7]
    assert got[0][1:] == (-2.0, 1.5) and got[1][1:] == (0.25, 0.25)
    assert got[2][1:] == (-3.0, 5.0)
    assert math.isnan(got[3][1]) and math.isnan(got[3][2])
    assert cap.take() is None
    # a NaN in a later step survives the device fold
    cap.observe(0, torch.tensor([1.0, 2.0]))
    cap.end_step()
    cap.observe(0, torch.tensor([float("nan")]))
    cap.end_step()
    ((_, lo, hi),) = cap.take()
    assert math.isnan(lo) and math.isnan(hi)


def test_health_monitor_values_unchanged_by_the_recorder(tmp_path):
    feeds = np.random.RandomState(4).randn(4, 6).astype("f")
    values = []
    for on in (False, True):
        exe, x = _mlp_executor(tht, health_options={
            "every_n": 1, "out_dir": str(tmp_path / str(on))})
        rec = trc.RangeRecorder(exe).attach() if on else None
        seen = []
        hm = exe.config.health_monitor
        real_after = hm.after_step

        def after_step(s, runtime=None, seen=seen, real=real_after):
            seen.append(s._last_health["values"].clone())
            return real(s, runtime)
        hm.after_step = after_step
        exe.run(feed_dict={x: feeds})
        if rec is not None:
            rec.sample()
            assert rec.fetches == 1
        values.append(seen[0])
    assert torch.equal(values[0], values[1])


def test_sessions_the_walk_cannot_measure_are_refused():
    from test_torch_pipeline import _mlp as pp_mlp
    from test_torch_pipeline import _weights
    # a staged pipeline: the stages walk their own parts
    x, y_, loss, train = pp_mlp(tht, _weights(), True)
    exe = tht.Executor([loss, train], gpipe=True, num_microbatches=2)
    with pytest.raises(NotImplementedError, match="staged pipeline"):
        trc.RangeRecorder(exe).attach()
    # thread ranks: each rank walks its own clone
    exe, _ = _mlp_executor(tht, ctx=[tht.gpu(0), tht.gpu(1)],
                           device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="thread ranks"):
            trc.RangeRecorder(exe).attach()
    finally:
        exe.close()
    # a tensor-parallel rank holds shards and partial sums
    exe, _ = _mlp_executor(tht)
    sub = exe.subexecutors["default"]
    sub.tp = object()
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        trc.RangeRecorder(exe).attach()
    assert sub._range_capture is None


def test_telemetry_counts_fetches(tmp_path):
    exe, x = _mlp_executor(tht, telemetry=str(tmp_path))
    rec = trc.RangeRecorder(exe).attach()
    for _ in range(2):
        exe.run(feed_dict={x: np.ones((4, 6), "f")})
        rec.sample()
    tel = exe.config.telemetry
    assert tel.counter_value("rangecheck_fetches") == 2
    assert tel.metrics.gauge("rangecheck_nodes").value == len(rec.measured)


# ---------------------------------------------------------------------------
# the zoo round trip and the range DB
# ---------------------------------------------------------------------------

def test_rangecheck_roundtrip_two_zoo_models(tmp_path):
    # every measured per-op range inside its static interval on two zoo
    # models, the same ranges as the reference's; the DB persisted
    db = trc.RangeDB(str(tmp_path / "rangedb_roundtrip.json"))
    for model in ("mlp", "wdl_adult"):
        report, measured, checked = trc.rangecheck_model(
            model, steps=3, db=db, device="cpu")
        assert measured, model
        assert checked > 0, model
        assert not report.errors, \
            f"{model}: {[str(f) for f in report.errors]}"
        jreport, jmeasured, jchecked = jrc.rangecheck_model(model, steps=3)
        assert checked == jchecked and not jreport.errors
        assert_same_measured(measured, jmeasured)
    db.save()
    reloaded = trc.RangeDB(db.path)
    assert set(reloaded.data) == {"mlp", "wdl_adult"}
    got = reloaded.get("mlp")
    assert got and all(lo <= hi for lo, hi in got.values())


def _maps(model, zoo, shape_pass_, numerics_pass_, report_cls, topo_f,
          measured):
    eval_nodes, feed_shapes = zoo.build(model)
    topo = topo_f(list(eval_nodes))
    dtypes = {}
    shapes = shape_pass_(topo, report_cls(), feed_shapes=feed_shapes,
                         dtypes_out=dtypes)
    plain = numerics_pass_(topo, report_cls(), shapes=shapes,
                           dtypes=dtypes)
    tight = numerics_pass_(topo, report_cls(), shapes=shapes,
                           dtypes=dtypes, measured=measured)
    return topo, plain, tight


def test_measured_db_tightens_reanalysis(tmp_path):
    from hetu_tpu.analysis import zoo as jzoo
    from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
    from hetu_tpu_torch.analysis import zoo as tzoo
    gained = {}
    for pkg, rc, zoo, sp, npass, rep, topo_f in (
            ("torch", trc, tzoo, shape_pass, tnum.numerics_pass, Report,
             find_topo_sort),
            ("jax", jrc, jzoo, jshape_pass, jnumerics, JReport, jtopo)):
        db = rc.RangeDB(str(tmp_path / f"rangedb_tighten_{pkg}.json"))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        report, _, _ = rc.rangecheck_model("mlp", steps=3, db=db, **kw)
        assert not report.errors
        topo, plain, tight = _maps("mlp", zoo, sp, npass, rep, topo_f,
                                   db.get("mlp"))
        known_plain = sum(1 for r in plain.values() if r is not None)
        known_tight = sum(1 for r in tight.values() if r is not None)
        assert known_tight >= known_plain
        # a previously unknown interval (the feed path) is now bounded
        gained[pkg] = [i for i, n in enumerate(topo)
                       if plain.get(n) is None and tight.get(n) is not None]
        assert gained[pkg], "measured DB tightened nothing"
    assert gained["torch"] == gained["jax"]


# ---------------------------------------------------------------------------
# interval products, the soundness gate
# ---------------------------------------------------------------------------

def test_interval_product_survives_half_bounded_operands():
    # clip(x, None, 1) of an unknown operand is (-inf, 1]; its product
    # with a zero-touching operand does not NaN out (0*inf := 0), and the
    # unguarded div downstream still fires HT804
    prods = {}

    def build(ht):
        x = ht.Variable("xiv", trainable=False)
        r = ht.init.random_uniform((4,), 0.0, 2.0, "riv", trainable=False)
        clipped = ht.clip_op(x, None, 1.0)
        prods[ht] = prod = ht.mul_op(clipped, r)
        num = ht.init.ones((4,), name="niv", trainable=False)
        return [ht.div_op(num, prod)]
    report, ranges, _ = twin(build)
    rng = ranges[prods[tht]]
    assert rng is not None and rng[0] == -float("inf") \
        and rng[1] == 2.0, rng
    assert "HT804" in codes(report)


def _gate(ht, rc, num, init_args, op, static, measured_by_key):
    x = ht.init.random_uniform(*init_args, trainable=False)
    y = op(ht, x)
    topo = find_topo_sort([y]) if ht is tht else \
        __import__("hetu_tpu.graph.autodiff", fromlist=["_"]) \
        .find_topo_sort([y])
    ranges = {n: None for n in topo}
    ranges[y] = static
    key = num.stable_keys(topo)[topo.index(y)]
    out = []
    for m in measured_by_key:
        rep, checked = rc.soundness_pass(topo, ranges, {key: m})
        out.append(([f.code for f in rep.errors], checked))
    return out


def test_soundness_gate_enforces_finite_side_of_half_bounded():
    # a static [1, inf) still rejects a measured min below it, and a NaN
    # measurement is always a violation
    from hetu_tpu.analysis import numerics as jnum
    cases = [(-5.0, 100.0), (float("nan"), 1.0), (1.5, 1e30)]
    got = {ht: _gate(ht, rc, num, ((4,), 0.5, 2.0, "xhb"),
                     lambda ht, x: ht.exp_op(x), (1.0, float("inf")),
                     cases)
           for ht, rc, num in ((jht, jrc, jnum), (tht, trc, tnum))}
    assert got[tht] == got[jht]
    assert [c for c, _ in got[tht]] == [["HT810"], ["HT810"], []]


def test_soundness_gate_flags_escaping_range():
    from hetu_tpu.analysis import numerics as jnum
    cases = [(-0.5, 3.0), (-0.9, 0.9), (-1.0 - 5e-6, 1.0 + 5e-6),
             (-1.0 - 5e-5, 1.0)]
    got = {ht: _gate(ht, rc, num, ((4,), -1.0, 1.0, "xsg"),
                     lambda ht, x: ht.tanh_op(x), (-1.0, 1.0), cases)
           for ht, rc, num in ((jht, jrc, jnum), (tht, trc, tnum))}
    assert got[tht] == got[jht]
    # the slack is the reference's: 1e-6 + 1e-5 |bound|
    assert got[tht] == [(["HT810"], 1), ([], 1), ([], 1), (["HT810"], 1)]
    assert (trc._SLACK_ABS, trc._SLACK_REL) == (jrc._SLACK_ABS,
                                                jrc._SLACK_REL)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_numerics_cli_and_rangecheck_cli(tmp_path, capsys):
    assert tnum.main(["mlp", "logreg"]) == 0
    db = str(tmp_path / "rangedb_cli.json")
    assert trc.main(["mlp", "--steps", "2", "--db", db,
                     "--device", "cpu"]) == 0
    data = json.load(open(db))
    assert data["models"]["mlp"]
    out = capsys.readouterr().out
    assert "== mlp: ok" in out and "range DB written to" in out
    # the JAX package's CLI over the same model writes the same keys
    jdb = str(tmp_path / "rangedb_cli_jax.json")
    assert jrc.main(["mlp", "--steps", "2", "--db", jdb]) == 0
    jdata = json.load(open(jdb))
    assert set(data["models"]["mlp"]) == set(jdata["models"]["mlp"])


def test_rangecheck_cli_asks_for_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trc.main(["mlp", "--steps", "1", "--db",
                  str(tmp_path / "rangedb_nocard.json")])


def test_range_db_survives_a_corrupt_file(tmp_path):
    path = tmp_path / "rangedb_corrupt.json"
    path.write_text("{not json")
    db = trc.RangeDB(str(path))
    assert db.data == {} and db.get("mlp") is None
    db.update("mlp", {"0000:PlaceholderOp": (-1.0, 2.0)})
    db.update("mlp", {"0000:PlaceholderOp": (-3.0, 1.0)})
    db.save()
    again = trc.RangeDB(str(path))
    assert again.get("mlp") == {"0000:PlaceholderOp": (-3.0, 2.0)}
    assert again.data["mlp"]["0000:PlaceholderOp"]["n"] == 2
