"""The port's numerics verifier (``hetu_tpu_torch/analysis/numerics.py``,
HT801–HT807) against the JAX package's: the twins of
``tests/test_numerics.py``'s static tests, the interval protocol
(``Op.infer_range``, ``BaseInit.interval``) rule by rule, and
``analyze`` / ``Executor(validate=...)`` with HT8xx in them.

Each twin builds the same graph in both packages from one function, so a
node's construction line is the same line of this file, and compares
what the findings say (code, severity, ``where``, the node's name up to
the graph's id offset, the data fields; a waiver silences both) and the
interval maps per stable key: equal where both are known, the same
Nones. Both packages draw a parameter from its name, so the seeds are
the same numbers. Where the port's own text differs on purpose (HT802's
remedy, HT803's x64 warning) the test says so.
"""
import math
import os

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.analysis as janalysis
import hetu_tpu_torch as tht
import hetu_tpu_torch.analysis as tanalysis
from hetu_tpu.analysis import numerics as jnum
from hetu_tpu.analysis import shapes as jshapes
from hetu_tpu import initializers as jinit
from hetu_tpu import telemetry as jtel
from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
from hetu_tpu.telemetry import health as jhealth
from hetu_tpu_torch import initializers as tinit
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.analysis import numerics as tnum
from hetu_tpu_torch.analysis import shapes as tshapes
from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
from hetu_tpu_torch.graph.node import Op as TOp
from hetu_tpu_torch.telemetry import health as thealth
from test_torch_analysis import view

THIS_FILE = os.path.abspath(__file__)

PKGS = {"jax": (jht, janalysis, jshapes, jnum, jtopo),
        "torch": (tht, tanalysis, tshapes, tnum, ttopo)}


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


def dt(ht, name):
    """The package's dtype object of ``name`` (jnp's or torch's)."""
    if ht is jht:
        import jax.numpy as jnp
        return getattr(jnp, name)
    return getattr(torch, name)


def run_pass(pkg, eval_nodes, feed_shapes=None, config=None):
    _, analysis, shapes_mod, num, topo_f = PKGS[pkg]
    topo = topo_f(list(eval_nodes))
    dtypes = {}
    shapes = shapes_mod.shape_pass(topo, analysis.Report(),
                                   feed_shapes=feed_shapes,
                                   dtypes_out=dtypes)
    report = analysis.Report()
    ranges = num.numerics_pass(topo, report, shapes=shapes, dtypes=dtypes,
                               config=config)
    return report, ranges, topo


def keyed(ranges, topo, num):
    return dict(zip(num.stable_keys(topo), (ranges[n] for n in topo)))


def same_interval(a, b):
    if a is None or b is None:
        return a is None and b is None
    return all(x == y or (math.isfinite(x) and math.isfinite(y)
                          and math.isclose(x, y, rel_tol=1e-12))
               for x, y in zip(a, b))


def assert_same_maps(got, want):
    assert got.keys() == want.keys()
    diff = {k: (got[k], want[k]) for k in got
            if not same_interval(got[k], want[k])}
    assert not diff, diff


def twin(build, feed_shapes=None, config=None):
    """Run ``build(ht)`` -> eval nodes through both packages' pass
    (``config(ht)`` builds each one's config); compare findings and
    interval maps. Returns the port's (report, ranges, topo)."""
    out = {}
    for pkg, (ht, _, _, num, topo_f) in PKGS.items():
        nodes = build(ht)
        cfg = config(ht) if config is not None else None
        report, ranges, topo = run_pass(pkg, nodes, feed_shapes, cfg)
        out[pkg] = (report, ranges, topo, nodes, view(report, nodes,
                                                      topo_f),
                    keyed(ranges, topo, num))
    assert out["torch"][4] == out["jax"][4]
    assert_same_maps(out["torch"][5], out["jax"][5])
    return out["torch"][:3]


def codes(report):
    return {f.code for f in report.findings}


def assert_provenance(finding):
    """Every fixture finding carries this test file's line."""
    assert finding.where is not None, finding
    path, _, line = finding.where.rpartition(":")
    assert os.path.abspath(path) == THIS_FILE, finding.where
    assert int(line) > 0


# ---------------------------------------------------------------------------
# HT801 — overflow-prone op in low precision
# ---------------------------------------------------------------------------

def _ht801_graph(ht, waived=False):
    x = ht.init.random_uniform((4, 4), -30.0, 30.0, "x801")
    h = ht.cast_op(x, dt(ht, "float16"))
    if waived:
        y = ht.exp_op(h)  # ht-ok: HT801 fixture waiver
    else:
        y = ht.exp_op(h)
    return [ht.reduce_mean_op(y, [0, 1])]


def test_ht801_unshifted_exp_in_fp16():
    report, _, _ = twin(_ht801_graph)
    hits = [f for f in report.findings if f.code == "HT801"]
    assert hits and hits[0].severity == "error"
    assert "float16" in hits[0].message
    assert_provenance(hits[0])


def test_ht801_waived_on_construction_line():
    report, _, _ = twin(lambda ht: _ht801_graph(ht, waived=True))
    assert "HT801" not in codes(report)


def test_ht801_fp32_to_fp16_downcast_overflow():
    # the interval survives the cast; past the TARGET dtype's max is
    # overflow created by the cast
    def build(ht):
        x = ht.init.random_uniform((4,), -1e6, 1e6, "x801d",
                                   trainable=False)
        return [ht.cast_op(x, dt(ht, "float16"))]
    report, _, _ = twin(build)
    hits = [f for f in report.findings if f.code == "HT801"]
    assert hits and hits[0].severity == "error"
    assert "CastOp" in hits[0].message


def test_ht801_fp32_shifted_exp_clean():
    # exp of a bounded negative operand (the erf-gradient idiom): clean
    def build(ht):
        x = ht.init.random_uniform((4, 4), -3.0, 3.0, "x801c")
        y = ht.exp_op(ht.opposite_op(ht.mul_op(x, x)))
        return [ht.reduce_mean_op(y, [0, 1])]
    report, ranges, topo = twin(build)
    assert "HT801" not in codes(report)
    rng = ranges[topo[-1]]
    assert rng is not None and rng[1] <= 1.0 + 1e-9


# ---------------------------------------------------------------------------
# HT802 — low-precision accumulation
# ---------------------------------------------------------------------------

def test_ht802_bf16_matmul_accumulation():
    def build(ht):
        x = ht.Variable("x802", trainable=False)
        w = ht.init.random_normal((1024, 16), name="w802")
        return [ht.matmul_op(ht.cast_op(x, dt(ht, "bfloat16")),
                             ht.cast_op(w, dt(ht, "bfloat16")))]
    report, _, _ = twin(build, feed_shapes={
        "x802": ((8, 1024), np.float32)})
    hits = [f for f in report.findings if f.code == "HT802"]
    assert hits, report
    assert "1024" in hits[0].message
    # the port names its own remedy (the reference's names
    # preferred_element_type=jnp.float32)
    assert "accumulate in f32" in hits[0].message
    assert "dtype=" in hits[0].message
    assert_provenance(hits[0])

    def build32(ht):
        w = ht.init.random_normal((1024, 16), name="w802")
        return [ht.matmul_op(ht.Variable("x802b", trainable=False), w)]
    rep32, _, _ = twin(build32, feed_shapes={
        "x802b": ((8, 1024), np.float32)})
    assert "HT802" not in codes(rep32)
    assert tnum.accum_error_bound(torch.bfloat16, 1024) > \
        tnum.accum_error_bound(torch.float32, 1024)
    assert tnum.accum_error_bound(torch.bfloat16, 1024) == \
        jnum.accum_error_bound("bfloat16", 1024)


def _low_config(name):
    def make(ht):
        class _Config:
            dtype = dt(ht, name)
            pipeline_mode = None
            pp_options = None
        return _Config()
    return make


def test_ht802_mixed_precision_session_uses_compute_dtype():
    # Executor(dtype=bf16) casts the whole forward: the verifier analyzes
    # at the session's EFFECTIVE precision, not the declared fp32
    def build(ht):
        x = ht.Variable("x802m", trainable=False)
        w = ht.init.random_normal((4096, 16), name="w802m")
        return [ht.matmul_op(x, w)]         # no explicit casts anywhere
    feeds = {"x802m": ((8, 4096), np.float32)}
    report, _, _ = twin(build, feed_shapes=feeds,
                        config=_low_config("bfloat16"))
    assert any(f.code == "HT802" for f in report.findings), report
    plain, _, _ = twin(build, feed_shapes=feeds)
    assert "HT802" not in codes(plain)


# ---------------------------------------------------------------------------
# HT803 — integer-exactness loss on the id paths
# ---------------------------------------------------------------------------

def test_ht803_float_ids_past_2_24_rows():
    def build(ht):
        tbl = ht.init.random_normal(((1 << 24) + 2, 4), name="tbl803")
        ids = ht.Variable("ids803", trainable=False)
        return [ht.embedding_lookup_op(tbl, ids)]
    report, _, _ = twin(build, feed_shapes={"ids803": ((8,), np.float32)})
    hits = [f for f in report.findings if f.code == "HT803"]
    assert hits and hits[0].severity == "error"
    assert_provenance(hits[0])


def _lookup_803(ht, ids_name):
    tbl = ht.init.random_normal(((1 << 31) + 2, 1), name="tbl803b")
    ids = ht.Variable(ids_name, trainable=False)
    return [ht.embedding_lookup_op(tbl, ids)]


def test_ht803_id_dtype_narrower_than_table():
    report, _, _ = twin(lambda ht: _lookup_803(ht, "ids803b"),
                        feed_shapes={"ids803b": ((8,), np.int32)})
    hits = [f for f in report.findings if f.code == "HT803"]
    assert hits and hits[0].severity == "error"
    assert "int32" in hits[0].message
    # int64 ids address the table. The reference then warns that JAX's
    # x64 is off (its device feeds canonicalize int64 to int32); the
    # port keeps int64 ids on the card, so that warning alone is absent
    feeds = {"ids803c": ((8,), np.int64)}
    got = {}
    for pkg, (ht, _, _, _, topo_f) in PKGS.items():
        nodes = _lookup_803(ht, "ids803c")
        report, _, topo = run_pass(pkg, nodes, feeds)
        got[pkg] = (report, view(report, nodes, topo_f))
    jrep, jview = got["jax"]
    trep, tview = got["torch"]
    assert not [f for f in trep.findings
                if f.code == "HT803" and f.severity == "error"]
    assert not any("x64" in f.message for f in trep.findings)
    x64 = [f for f in jrep.findings if "x64" in f.message]
    assert len(x64) == 1 and x64[0].code == "HT803"
    assert tview == [row for row in jview if row[0] != "HT803"]
    assert len(tview) == len(jview) - 1


def test_ht803_runtime_twin_rejects_float_ids():
    from hetu_tpu.ops.embedding import check_id_dtype as jcheck
    from hetu_tpu_torch.ops.embedding import check_id_dtype
    for check, f32, i32, i64 in (
            (jcheck, np.float32, np.int32, np.int64),
            (check_id_dtype, torch.float32, torch.int32, torch.int64)):
        with pytest.raises(TypeError, match="HT803"):
            check(f32, None, "unit")
        with pytest.raises(ValueError, match="HT803"):
            check(i32, (1 << 31) + 2, "unit")
        check(i64, (1 << 31) + 2, "unit")   # fits
        check(i32, 1000, "unit")            # fits
    for spelling in (np.float32, torch.float32, "float32"):
        assert tnum.exact_int_limit(spelling) == 1 << 24 == \
            jnum.exact_int_limit(np.float32)


def test_dataloader_preserves_integer_ids():
    ids = np.arange(40, dtype=np.int64).reshape(10, 4)
    for ht in (jht, tht):
        dl = ht.Dataloader(ids, 2)
        assert dl.raw_data.dtype == np.int32   # fits int32: canonical
        big = ids + (1 << 40)
        assert ht.Dataloader(big, 2).raw_data.dtype == np.int64
        floats = np.ones((10, 4), np.float64)
        assert ht.Dataloader(floats, 2).raw_data.dtype == np.float32


# ---------------------------------------------------------------------------
# HT804 — unguarded zero-crossing domains
# ---------------------------------------------------------------------------

def test_ht804_log_of_zero_crossing_interval():
    def build(ht):
        x = ht.init.random_uniform((4,), -1.0, 1.0, "x804",
                                   trainable=False)
        return [ht.log_op(x)]
    report, _, _ = twin(build)
    hits = [f for f in report.findings if f.code == "HT804"]
    assert hits, report
    assert_provenance(hits[0])


def test_ht804_eps_guard_recognized():
    # x*x + eps excludes zero: interval arithmetic IS the guard check
    def build(ht):
        x = ht.init.random_uniform((4,), -1.0, 1.0, "x804b",
                                   trainable=False)
        safe = ht.log_op(ht.addbyconst_op(ht.mul_op(x, x), 1e-6))
        rsafe = ht.rsqrt_op(ht.addbyconst_op(ht.mul_op(x, x), 1e-6))
        return [safe, rsafe]
    report, _, _ = twin(build)
    assert "HT804" not in codes(report)


def test_ht804_div_by_zero_crossing_denominator():
    def build(ht, clip=False):
        x = ht.init.random_uniform((4,), -1.0, 1.0, "x804c",
                                   trainable=False)
        num = ht.init.ones((4,), name="num804", trainable=False)
        if clip:
            x = ht.clip_op(x, 1e-6, None)
        return [ht.div_op(num, x)]
    report, _, _ = twin(build)
    assert "HT804" in codes(report)
    # the clip-guarded twin is clean
    report2, _, _ = twin(lambda ht: build(ht, clip=True))
    assert "HT804" not in codes(report2)


def test_ht804_log_sigmoid_saturation():
    # sigmoid rounds to exactly 0.0 for very negative operands: the
    # interval stays closed at 0, so the log downstream is flagged
    def build(ht):
        x = ht.init.random_uniform((4,), -200.0, -10.0, "x804s",
                                   trainable=False)
        return [ht.log_op(ht.sigmoid_op(x))]
    report, _, _ = twin(build)
    assert "HT804" in codes(report)


def test_ht804_zero_eps_norms_all_flagged():
    def build(ht):
        x = ht.Variable("x804n", trainable=False)
        scale = ht.init.ones((8,), name="s804n")
        bias = ht.init.zeros((8,), name="b804n")
        ln = ht.layer_normalization_op(x, scale, bias, eps=0.0)
        inorm = ht.instance_normalization2d_op(
            ht.Variable("x804i", trainable=False), eps=0.0)
        return [ht.reduce_mean_op(ln, [0, 1]),
                ht.reduce_mean_op(inorm, [0, 1])]
    report, _, _ = twin(build, feed_shapes={
        "x804n": ((4, 8), np.float32), "x804i": ((2, 3, 4, 4), np.float32)})
    hits = [f for f in report.findings if f.code == "HT804"]
    assert len(hits) == 2, report.to_text()


def test_losses_make_no_claim_for_off_simplex_labels():
    # labels outside [0, 1] take BCE/CE negative: no bound rather than an
    # unsound [0, hi]
    for ht in (jht, tht):
        pred = ht.Variable("p_os", trainable=False)
        bce = ht.binarycrossentropy_op(pred, pred)
        assert bce.infer_range([(0.1, 0.9), (0.0, 2.0)]) is None
        assert bce.infer_range([(0.1, 0.9), (0.0, 1.0)])[0] == 0.0


def test_ht804_bad_optimizer_eps():
    def build(ht):
        x = ht.Variable("x804d", trainable=False)
        w = ht.init.random_normal((6, 2), name="w804d")
        loss = ht.reduce_mean_op(ht.matmul_op(x, w), [0, 1])
        train = ht.optim.AdamOptimizer(1e-3, epsilon=0.0).minimize(loss)
        return [loss, train]
    report, _, _ = twin(build, feed_shapes={"x804d": ((4, 6), np.float32)})
    assert any(f.code == "HT804" and "eps" in f.message
               for f in report.findings)


# ---------------------------------------------------------------------------
# HT805 — low-precision cross-replica or pipeline boundary
# ---------------------------------------------------------------------------

def _boundary_config(boundary_dtype, boundary_rtol=None):
    def make(ht):
        class _Config:
            dtype = None
            pipeline_mode = "collective"
            pp_options = {"boundary_dtype": boundary_dtype(ht)
                          if callable(boundary_dtype) else boundary_dtype}
        if boundary_rtol is not None:
            _Config.pp_options["boundary_rtol"] = boundary_rtol
        return _Config()
    return make


def _tiny_train(ht, prefix="805", loss_scale=None):
    x = ht.Variable(f"x{prefix}", trainable=False)
    w = ht.init.random_normal((6, 2), name=f"w{prefix}")
    loss = ht.reduce_mean_op(ht.matmul_op(x, w), [0, 1])
    train = ht.optim.SGDOptimizer(0.1, loss_scale=loss_scale).minimize(loss)
    return [loss, train]


TINY_FEEDS = {"x805": ((4, 6), np.float32)}


def test_ht805_bf16_boundary_covered_by_declared_rtol():
    from hetu_tpu_torch.parallel.collective_pp import BOUNDARY_RTOL
    # one bf16 cast hop stays inside the collective pipeline's rtol
    assert tnum.boundary_error_bound("bfloat16", hops=1) <= BOUNDARY_RTOL
    assert tnum.boundary_error_bound(torch.bfloat16, hops=3) == \
        jnum.boundary_error_bound("bfloat16", hops=3)
    report, _, _ = twin(_tiny_train, feed_shapes=TINY_FEEDS,
                        config=_boundary_config("bf16"))
    assert not [f for f in report.findings if f.code == "HT805"]


def test_ht805_bf16_boundary_with_too_tight_rtol_trips():
    report, _, _ = twin(_tiny_train, feed_shapes=TINY_FEEDS,
                        config=_boundary_config("bf16", 1e-5))
    hits = [f for f in report.findings if f.code == "HT805"]
    assert hits and hits[0].severity == "error"


@pytest.mark.parametrize("spelling", ["numpy", "package"])
def test_ht805_accepts_dtype_object_spellings(spelling):
    # dtype OBJECTS are accepted as the runtime accepts them: numpy's,
    # and each package's own
    spec = (lambda ht: np.float16) if spelling == "numpy" \
        else (lambda ht: dt(ht, "float16"))
    report, _, _ = twin(_tiny_train, feed_shapes=TINY_FEEDS,
                        config=_boundary_config(spec))
    assert any(f.code == "HT805" for f in report.findings)


def test_ht805_fp16_boundary_requires_retune():
    # widening the boundary to fp16 halves the exponent range: the
    # verifier does not stay silent until someone retunes
    report, _, _ = twin(_tiny_train, feed_shapes=TINY_FEEDS,
                        config=_boundary_config("fp16"))
    hits = [f for f in report.findings if f.code == "HT805"]
    assert hits
    assert any("65504" in f.message or "exponent" in f.message
               for f in hits)
    assert tnum.dtype_max("float16") == 65504.0 == \
        tnum.dtype_max(torch.float16) == jnum.dtype_max("float16")


# ---------------------------------------------------------------------------
# HT806 — fp16 backward with no loss scale
# ---------------------------------------------------------------------------

def test_ht806_fp16_training_without_loss_scale():
    report, _, _ = twin(_tiny_train, feed_shapes=TINY_FEEDS,
                        config=_low_config("float16"))
    hits = [f for f in report.findings if f.code == "HT806"]
    assert hits and "loss_scale" in hits[0].message


def test_ht806_loss_scale_clears_it():
    report, _, _ = twin(
        lambda ht: _tiny_train(ht, "806", loss_scale=1024),
        feed_shapes={"x806": ((4, 6), np.float32)},
        config=_low_config("float16"))
    assert "HT806" not in codes(report)


def _scaled_mlp(ht, scale, prefix):
    x = ht.Variable(f"x{prefix}", trainable=False)
    w = ht.Variable(f"w{prefix}", value=np.full((6, 2), 0.3, "f"))
    loss = ht.reduce_mean_op(ht.matmul_op(x, w), [0, 1])
    opt = ht.optim.SGDOptimizer(0.1, loss_scale=scale)
    return [loss, opt.minimize(loss)], x


def _exe(ht, nodes, **kw):
    if ht is tht:
        kw["ctx"] = tht.cpu(0)
    return ht.Executor(nodes, **kw)


def test_loss_scale_is_numerically_neutral():
    # loss_scale scales the backward and unscales in the update: the
    # fp32 trajectory is (near-)identical, in both packages alike
    feeds = np.random.RandomState(0).randn(4, 6).astype("f")
    outs = {}
    for ht in (jht, tht):
        for scale in (None, 512.0):
            nodes, x = _scaled_mlp(ht, scale, "ls")
            exe = _exe(ht, nodes)
            for _ in range(3):
                out = exe.run(feed_dict={x: feeds},
                              convert_to_numpy_ret_vals=True)
            outs[ht.__name__, scale] = out[0]
    for ht in ("hetu_tpu", "hetu_tpu_torch"):
        np.testing.assert_allclose(outs[ht, None], outs[ht, 512.0],
                                   rtol=1e-5)
    np.testing.assert_allclose(outs["hetu_tpu_torch", None],
                               outs["hetu_tpu", None], rtol=1e-5)


def test_loss_scale_sentinels_report_unscaled_grads(tmp_path):
    # the health monitor's grad-norm sentinels see the unscaled
    # gradients, not the scaled backward
    def grad_norm(ht, scale):
        nodes, x = _scaled_mlp(ht, scale, "sn")
        opts = {"every_n": 1}
        if ht is tht:
            opts["out_dir"] = str(tmp_path)
        exe = _exe(ht, nodes, health_options=opts)
        feeds = np.random.RandomState(0).randn(4, 6).astype("f")
        exe.run(feed_dict={x: feeds})
        return exe.config.health_monitor.records[-1]["grad_norm_total"]

    got = {ht: (grad_norm(ht, None), grad_norm(ht, 4096.0))
           for ht in (jht, tht)}
    plain, scaled = got[tht]
    assert scaled == pytest.approx(plain, rel=1e-4)
    assert plain == pytest.approx(got[jht][0], rel=1e-5)


# ---------------------------------------------------------------------------
# HT807 — PRNG stream reuse
# ---------------------------------------------------------------------------

def test_ht807_shared_key_between_independent_dropouts():
    names = {}

    def build(ht):
        x = ht.Variable("x807", value=np.ones((4, 4), "f"),
                        trainable=False)
        d1 = ht.dropout_op(x, 0.9)
        d2 = ht.dropout_op(x, 0.9)
        d2.rng_key = d1.id          # graph-surgery id collision
        names[ht] = (d1.name, d2.name)
        return [ht.reduce_mean_op(ht.add_op(d1, d2), [0, 1])]
    report, _, _ = twin(build)
    hits = [f for f in report.findings if f.code == "HT807"]
    assert hits and hits[0].severity == "error"
    d1, d2 = names[tht]
    assert d1 in hits[0].message and d2 in hits[0].message


def test_ht807_forward_grad_pair_is_not_reuse():
    # a dropout and its gradient replay ONE mask by design: clean
    def build(ht):
        x = ht.Variable("x807b", value=np.ones((4, 4), "f"),
                        trainable=False)
        w = ht.init.random_normal((4, 2), name="w807b")
        d = ht.dropout_op(x, 0.9)
        loss = ht.reduce_mean_op(ht.matmul_op(d, w), [0, 1])
        train = ht.optim.SGDOptimizer(0.1).minimize(loss)
        return [loss, train]
    report, _, _ = twin(build)
    assert "HT807" not in codes(report)


# ---------------------------------------------------------------------------
# analyze, Executor(validate=), the zoo gate
# ---------------------------------------------------------------------------

def test_validate_error_rejects_fp16_overflow_graph():
    for ht, analysis in ((jht, janalysis), (tht, tanalysis)):
        with pytest.raises(analysis.GraphValidationError, match="HT801"):
            _exe(ht, _ht801_graph(ht), validate="error")


def test_zoo_clean_under_numerics_gate():
    from hetu_tpu_torch.analysis import zoo as tzoo
    from hetu_tpu.analysis import zoo as jzoo
    reports = tnum.check_zoo()
    assert len(reports) == 14 and set(reports) == set(jnum.check_zoo())
    dirty = {n: [str(f) for f in r.findings]
             for n, r in reports.items() if len(r)}
    assert not dirty, dirty
    # the interval maps of every zoo graph, key by key
    for name in sorted(tzoo.ZOO):
        maps = {}
        for pkg, (_, analysis, shapes_mod, num, topo_f) in PKGS.items():
            zoo = tzoo if pkg == "torch" else jzoo
            nodes, feed_shapes = zoo.build(name)
            _, ranges, topo = run_pass(pkg, nodes, feed_shapes)
            maps[pkg] = keyed(ranges, topo, num)
        assert_same_maps(maps["torch"], maps["jax"])


def test_analyze_includes_numerics_findings():
    got = {}
    for pkg, (ht, analysis, _, _, topo_f) in PKGS.items():
        nodes = _ht801_graph(ht)
        report = analysis.analyze(nodes)
        assert "HT801" in codes(report)
        got[pkg] = view(report, nodes, topo_f)
    assert got["torch"] == got["jax"]


def test_analyze_runs_numerics_with_the_session_dtype():
    # analyze hands the numerics pass the session's config: a bf16
    # session's 4096-deep contraction is HT802 there, as in the reference
    got = {}
    for pkg, (ht, analysis, _, _, topo_f) in PKGS.items():
        x = ht.Variable("xan", trainable=False)
        w = ht.init.random_normal((4096, 16), name="wan")
        nodes = [ht.matmul_op(x, w)]
        report = analysis.analyze(
            nodes, feed_shapes={"xan": ((8, 4096), np.float32)},
            config=_low_config("bfloat16")(ht))
        assert "HT802" in codes(report)
        got[pkg] = view(report, nodes, topo_f)
    assert got["torch"] == got["jax"]


def test_numerics_cli_over_the_zoo(capsys):
    assert tnum.main([]) == 0
    out = capsys.readouterr().out
    assert "0 unsuppressed finding(s) across 14 zoo model(s)" in out
    with pytest.raises(SystemExit):
        tnum.main(["no_such_model"])


# ---------------------------------------------------------------------------
# the dtype tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["float64", "float32", "bfloat16",
                                  "float16", "int32", "int64", "uint8",
                                  "bool"])
def test_dtype_tables_accept_every_spelling(name):
    want = jnum.prec_class(np.dtype(name)) if name != "bfloat16" \
        else "bf16"
    spellings = [getattr(torch, name), name]
    if name != "bfloat16":
        spellings.append(np.dtype(name))
    for s in spellings:
        assert tnum.prec_class(s) == want, s
    if want not in ("int", None):
        t = getattr(torch, name)
        j = dt(jht, name)
        assert tnum.dtype_max(t) == jnum.dtype_max(j)
        assert tnum.dtype_eps(name) == jnum.dtype_eps(j)
        assert tnum.dtype_tiny(t) == jnum.dtype_tiny(j)
        assert tnum.exact_int_limit(t) == jnum.exact_int_limit(j)
    assert tnum.prec_class(None) is None
    assert tnum.prec_class("no_such_dtype") is None


def test_bf16_is_its_own_class():
    # bf16 reads as bf16, never None: otherwise HT801/HT802 go blind on
    # the bf16 training path
    assert tnum.prec_class(torch.bfloat16) == "bf16"
    assert tnum._canon_low_prec(torch.bfloat16) == "bfloat16"
    assert tnum._canon_low_prec("BF16") == "bfloat16"
    assert tnum._canon_low_prec(np.float16) == "float16"
    assert tnum._canon_low_prec(torch.float32) is None


# ---------------------------------------------------------------------------
# the interval protocol, rule by rule
# ---------------------------------------------------------------------------

INF = float("inf")
NAN = float("nan")
# unknown, bounded, zero-touching, half-bounded both ways, negative,
# a NaN endpoint
INTERVALS = [None, (-2.0, 3.0), (0.0, 1.5), (0.5, INF), (-INF, 1.0),
             (-3.0, -0.25), (0.25, 4.0), (NAN, 1.0), (-800.0, 800.0)]


def _basic(ht):
    """The package's ops/basic.py (the reference's top level has no
    ``erf_op``)."""
    import hetu_tpu.ops.basic as jbasic
    import hetu_tpu_torch.ops.basic as tbasic
    return jbasic if ht is jht else tbasic


def _x(ht, name, shape=(2, 3, 4, 4)):
    return ht.Variable(name, value=np.ones(shape, "f"), trainable=False)


# (label, the op made in package ht, number of interval inputs)
PROTOCOL = [
    ("AddOp", lambda ht, a, b, c: ht.add_op(a, b), 2),
    ("AddByConstOp", lambda ht, a, b, c: ht.addbyconst_op(a, 1.5), 1),
    ("MulOp", lambda ht, a, b, c: ht.mul_op(a, b), 2),
    ("MulOp_square", lambda ht, a, b, c: ht.mul_op(a, a), 1),
    ("MulByConstOp", lambda ht, a, b, c: ht.mul_byconst_op(a, -2.0), 1),
    ("DivOp", lambda ht, a, b, c: ht.div_op(a, b), 2),
    ("DivConstOp", lambda ht, a, b, c: ht.div_const_op(3.0, a), 1),
    ("OppositeOp", lambda ht, a, b, c: ht.opposite_op(a), 1),
    ("SqrtOp", lambda ht, a, b, c: ht.sqrt_op(a), 1),
    ("ErfOp", lambda ht, a, b, c: _basic(ht).erf_op(a), 1),
    ("ReciprocalSqrtOp", lambda ht, a, b, c: ht.rsqrt_op(a), 1),
    ("ExpOp", lambda ht, a, b, c: ht.exp_op(a), 1),
    ("LogOp", lambda ht, a, b, c: ht.log_op(a), 1),
    ("AbsOp", lambda ht, a, b, c: ht.abs_op(a), 1),
    ("PowerOp_2", lambda ht, a, b, c: ht.power_op(a, 2), 1),
    ("PowerOp_3", lambda ht, a, b, c: ht.power_op(a, 3), 1),
    ("PowerOp_half", lambda ht, a, b, c: ht.power_op(a, 0.5), 1),
    ("WhereOp", lambda ht, a, b, c: ht.where_op(c, a, b), 3),
    ("OneHotOp", lambda ht, a, b, c: ht.one_hot_op(a, 4), 1),
    ("MatrixDotOp", lambda ht, a, b, c: ht.matrix_dot_op(a, b), 2),
    ("CastOp", lambda ht, a, b, c: ht.cast_op(a, dt(ht, "float16")), 1),
    ("ClipOp", lambda ht, a, b, c: ht.clip_op(a, 0.1, 2.0), 1),
    ("ClipOp_low", lambda ht, a, b, c: ht.clip_op(a, 1e-12, None), 1),
    ("ClipOp_high", lambda ht, a, b, c: ht.clip_op(a, None, 1.0), 1),
    ("ClipMaskOp", lambda ht, a, b, c: ht.clip_mask_op(a, 0.0, 1.0), 1),
    ("ReluOp", lambda ht, a, b, c: ht.relu_op(a), 1),
    ("ReluGradientOp", lambda ht, a, b, c: ht.relu_gradient_op(a, b), 2),
    ("LeakyReluOp", lambda ht, a, b, c: ht.leaky_relu_op(a, 0.1), 1),
    ("SigmoidOp", lambda ht, a, b, c: ht.sigmoid_op(a), 1),
    ("TanhOp", lambda ht, a, b, c: ht.tanh_op(a), 1),
    ("GeluOp", lambda ht, a, b, c: ht.gelu_op(a), 1),
    ("SignOp", lambda ht, a, b, c: ht.sign_op(a), 1),
    ("SoftmaxOp", lambda ht, a, b, c: ht.softmax_op(a), 1),
    ("SoftmaxGradientOp",
     lambda ht, a, b, c: ht.softmax_gradient_op(a, b), 2),
    ("DropoutOp", lambda ht, a, b, c: ht.dropout_op(a, 0.8), 1),
    ("DropoutGradientOp", lambda ht, a, b, c: ht.dropout_gradient_op(
        a, 0.8, ht.dropout_op(b, 0.8)), 1),
    ("Dropout2dOp", lambda ht, a, b, c: ht.dropout2d_op(a, 0.5), 1),
    ("Dropout2dGradientOp", lambda ht, a, b, c: ht.dropout2d_gradient_op(
        a, 0.5, ht.dropout2d_op(b, 0.5)), 1),
    ("SoftmaxCrossEntropyOp",
     lambda ht, a, b, c: ht.softmaxcrossentropy_op(a, b), 2),
    ("SoftmaxCrossEntropyGradientOp",
     lambda ht, a, b, c: ht.softmaxcrossentropy_gradient_op(a, b, c), 3),
    ("SoftmaxCrossEntropySparseOp",
     lambda ht, a, b, c: ht.softmaxcrossentropy_sparse_op(a, b), 2),
    ("SoftmaxCrossEntropySparseGradientOp",
     lambda ht, a, b, c: ht.softmaxcrossentropy_sparse_gradient_op(
         a, b, c), 3),
    ("BinaryCrossEntropyOp",
     lambda ht, a, b, c: ht.binarycrossentropy_op(a, b), 2),
    ("BinaryCrossEntropyGradientOp",
     lambda ht, a, b, c: ht.binarycrossentropy_gradient_op(a, b, c), 3),
    ("CrossEntropyOp", lambda ht, a, b, c: ht.crossentropy_op(a, b), 2),
    ("BatchNormalizationOp",
     lambda ht, a, b, c: ht.batch_normalization_op(a, b, c), 3),
    ("LayerNormalizationOp",
     lambda ht, a, b, c: ht.layer_normalization_op(a, b, c), 3),
    ("InstanceNormalization2dOp",
     lambda ht, a, b, c: ht.instance_normalization2d_op(a), 1),
    ("EmbeddingLookUp",
     lambda ht, a, b, c: ht.embedding_lookup_op(a, b), 2),
]
SHAPES = [None, [(2, 3, 4, 4), (2, 3, 4, 4), (2, 3, 4, 4)],
          [(8, 5), (8, 5), (8,)]]


def _protocol_cases(n):
    """Every interval for the first input, the others cycled against
    it, so each rule meets unknown, half-bounded, zero-touching and NaN
    endpoints on every input."""
    k = len(INTERVALS)
    return [[INTERVALS[(i + 3 * j) % k] for j in range(n)]
            for i in range(k)]


@pytest.mark.parametrize("label,build,n", PROTOCOL,
                         ids=[p[0] for p in PROTOCOL])
def test_infer_range_protocol_twin(label, build, n):
    ops = {}
    for ht in (jht, tht):
        a, b, c = (_x(ht, f"p{i}") for i in range(3))
        ops[ht] = build(ht, a, b, c)
    op_type = label.split("_")[0]
    assert ops[tht].op_type == ops[jht].op_type == op_type
    # the rule is the port class's own, not Op's default
    assert type(ops[tht]).infer_range is not \
        TOp.infer_range
    for ins in _protocol_cases(n):
        # the op's real arity: a constant-taking op has one input
        arity = len(ops[jht].inputs)
        ins = (ins + [None] * arity)[:arity]
        for shapes in SHAPES:
            sh = None if shapes is None else shapes[:arity]
            got = _infer(ops[tht], ins, sh)
            want = _infer(ops[jht], ins, sh)
            assert _same_or_both_nan(got, want), (ins, sh, got, want)


def _infer(op, ins, shapes):
    try:
        return ("ok", op.infer_range(ins, shapes))
    except Exception as e:      # noqa: BLE001 — the pass reads it as None
        return ("raised", type(e).__name__)


def _same_or_both_nan(a, b):
    if a[0] != b[0] or a[0] == "raised":
        return a == b
    x, y = a[1], b[1]
    if x is None or y is None:
        return x is None and y is None
    return all(u == v or (u != u and v != v) for u, v in zip(x, y))


def test_every_reference_rule_has_a_port_rule():
    """Each op class of the reference with its own ``infer_range`` has
    one in the port, on the class of the same op_type."""
    import inspect
    from hetu_tpu.graph.node import Op as JOp
    mods = ("basic", "activations", "losses", "norm", "embedding")
    ref = set()
    for m in mods:
        mod = __import__(f"hetu_tpu.ops.{m}", fromlist=["_"])
        for name, cls in inspect.getmembers(mod, inspect.isclass):
            if issubclass(cls, JOp) and cls is not JOp \
                    and "infer_range" in vars(cls):
                ref.add(name)
    assert len(ref) >= 44
    covered = {p[0].split("_")[0] for p in PROTOCOL}
    assert ref <= covered, ref - covered
    for name in ref:
        mod = next(__import__(f"hetu_tpu_torch.ops.{m}", fromlist=["_"])
                   for m in mods if hasattr(__import__(
                       f"hetu_tpu_torch.ops.{m}", fromlist=["_"]), name))
        assert getattr(mod, name).infer_range is not \
            TOp.infer_range, name


@pytest.mark.parametrize("make", [
    lambda init: init.ConstantInit(2.5, (3,)),
    lambda init: init.ZerosInit((3,)),
    lambda init: init.UniformInit((3,), -0.2, 0.7),
    lambda init: init.NormalInit((3,), 0.1, 0.3),
    lambda init: init.TruncatedNormalInit((3,), -0.1, 0.2),
    lambda init: init.XavierNormalInit((8, 16)),
    lambda init: init.XavierUniformInit((8, 16)),
    lambda init: init.HeNormalInit((8, 16)),
    lambda init: init.HeUniformInit((4, 3, 3, 3)),
    lambda init: init.LecunNormalInit((8, 16)),
    lambda init: init.LecunUniformInit((8, 16)),
])
def test_initializer_interval_twin(make):
    got = make(tinit).interval()
    want = make(jinit).interval()
    assert got == want
    assert got is not None and got[0] <= got[1]


def test_initializer_interval_unknown_and_default():
    class _Custom(tinit.BaseInit):
        def init_numpy(self, seed=0):
            return np.zeros(self.shape, np.float32)
    assert _Custom((2,)).interval() is None
    node = _x(tht, "pdefault")
    assert TOp.infer_range(node, [(0.0, 1.0)]) is None
