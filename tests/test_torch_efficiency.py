"""The port's efficiency lint (``hetu_tpu_torch/analysis/efficiency.py``,
HT9xx) and its doctor-validated soundness twin (``perfcheck.py``, HT910)
against the JAX package's: the twins of ``tests/test_efficiency.py``.

Each twin builds the same graph in both packages from one builder (so a
node's construction line is the same line of this file), runs both
packages' pass with isolated CostDB and autotune caches (a CostDB a test
gives is one JSON file handed to both), and compares what the findings
say: code, severity, ``where``, the node's name up to the graph's id
offset, and every data field — ``bucket``, ``source`` and the prices
(``estimated_ms_per_step``, ``estimated_pct``) within 1e-9 relative.

Where the port differs by design (ROADMAP §3):

* **HT902** prices the card: a GEMM's dims round up to the granule at
  which an H100 GEMM's time steps (``efficiency._GRANULE``, measured),
  and an embedding's gathered rows to 32-byte DRAM sectors at the card's
  copy rate; the port's fixtures are its own.
* **HT901** has no runtime half: the port's eager walk compiles nothing.
* **HT903**'s script lint also knows the port's syncs: ``.asnumpy()``,
  ``.cpu()``, ``.numpy()``, ``.tolist()`` on a run result and
  ``torch.cuda.synchronize()``.
* **HT907** fires nothing until ROADMAP item 13: each kernel route has
  one block configuration.
* **The HT904 A/B** runs between two thread ranks over gloo.

``test_graphboard_waste_overlay`` waits for ROADMAP item 15 (graphboard);
``test_recommend_bucket_bytes`` and ``test_autoplan_dp_plan_sets_bucket_bytes``
have their twins in ``tests/test_torch_costdb.py``.
"""
import json
import math
import os
import re

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu_torch as tht
from hetu_tpu import telemetry as jtel
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu.analysis import Report as JReport
from hetu_tpu.analysis import analyze as janalyze
from hetu_tpu.analysis import efficiency as jeff
from hetu_tpu.analysis import perfcheck as jperf
from hetu_tpu.analysis.shapes import shape_pass as jshape_pass
from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
from hetu_tpu_torch.analysis import Report as TReport
from hetu_tpu_torch.analysis import analyze as tanalyze
from hetu_tpu_torch.analysis import efficiency as teff
from hetu_tpu_torch.analysis import perfcheck as tperf
from hetu_tpu_torch.analysis.findings import Finding
from hetu_tpu_torch.analysis.shapes import shape_pass as tshape_pass
from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
from hetu_tpu_torch.ops import flash_attention as fa

THIS_FILE = os.path.abspath(__file__)
PKGS = {"jax": (jht, jeff, jshape_pass, jtopo, JReport),
        "torch": (tht, teff, tshape_pass, ttopo, TReport)}


@pytest.fixture(autouse=True)
def _isolated_dbs(tmp_path, monkeypatch):
    """Deterministic cold-start pricing: the developer's real cost /
    autotune caches must not leak measured entries into fixture
    expectations. An enabled ``telemetry=`` (perfcheck's) becomes its
    package's process default: reset both packages' after each test."""
    monkeypatch.setenv("HETU_COSTDB", str(tmp_path / "costdb.json"))
    monkeypatch.setenv("HETU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("HETU_AUTOTUNE", raising=False)
    monkeypatch.delenv("HETU_EFF_THRESHOLD_MS", raising=False)
    yield
    ttel._default = None
    jtel._default = None


def _renumber(text, base):
    """``MatMulOp17`` -> ``MatMulOp<17 - base>`` everywhere in ``text``."""
    if text is None:
        return None
    return re.sub(r"\b([A-Z]\w*Op)(\d+)\b",
                  lambda m: f"{m.group(1)}{int(m.group(2)) - base}", text)


def rows(report, base):
    """(code, severity, where, node, data) of each finding, node ids less
    ``base``, sorted."""
    return sorted(((f.code, f.severity, f.where, _renumber(f.node, base),
                    f.data) for f in report.findings), key=repr)


def assert_same(got):
    """``got``: {pkg: rows}. Equal but the floats, which agree within
    1e-9 relative."""
    jrows, trows = got["jax"], got["torch"]
    assert [r[:4] for r in trows] == [r[:4] for r in jrows], got
    for (*_, jd), (*_, td) in zip(jrows, trows):
        assert set(td) == set(jd), (jd, td)
        for key, want in jd.items():
            have = td[key]
            if isinstance(want, float):
                assert math.isclose(have, want, rel_tol=1e-9,
                                    abs_tol=1e-12), (key, have, want)
            else:
                assert have == want, (key, have, want)


def run_pass(pkg, eval_nodes, feed_shapes=None, config=None,
             extra_roots=(), costdb=None, steps=None):
    _, eff, shape_pass, topo_of, Report = PKGS[pkg]
    topo = topo_of(list(eval_nodes))
    dtypes = {}
    shapes = shape_pass(topo, Report(), feed_shapes=feed_shapes,
                        dtypes_out=dtypes)
    report = Report()
    eff.efficiency_pass(topo, report, shapes=shapes, dtypes=dtypes,
                        config=config, costdb=costdb,
                        eval_nodes=eval_nodes, extra_roots=extra_roots,
                        steps=steps)
    return report, topo


def base_of(pkg, nodes):
    return min(n.id for n in PKGS[pkg][3](list(nodes)))


def twin(build, run=None):
    """``build(ht)`` -> (eval_nodes, kwargs of run_pass) in each
    package; returns ({pkg: rows}, {pkg: report})."""
    got, reports = {}, {}
    for pkg, (ht, *_rest) in PKGS.items():
        nodes, kw = build(ht)
        roots = list(nodes) + list(kw.get("extra_roots", ()))
        report = run(pkg, nodes, kw) if run else run_pass(pkg, nodes,
                                                          **kw)[0]
        got[pkg] = rows(report, base_of(pkg, roots))
        reports[pkg] = report
    return got, reports


def codes(report):
    return {f.code for f in report.findings}


def assert_priced(finding):
    """Every fixture finding carries the priced field + provenance at
    THIS file."""
    assert finding.data.get("estimated_ms_per_step") is not None, finding
    assert finding.data["estimated_ms_per_step"] > 0, finding
    assert finding.where is not None, finding
    path, _, line = finding.where.rpartition(":")
    assert os.path.abspath(path) == THIS_FILE, finding.where
    assert int(line) > 0


# ---------------------------------------------------------------------------
# HT901 — recompile hazard
# ---------------------------------------------------------------------------

KEYS_901 = [((b, 64), "float32") for b in (3, 5, 6, 7, 9, 11)]


def test_ht901_recompile_fixture():
    got = {}
    for pkg, (ht, eff, *_rest) in PKGS.items():
        anchor = ht.Variable("feed901", trainable=False)
        report = PKGS[pkg][4]()
        f = eff.recompile_pass(KEYS_901, report, steps=10, node=anchor)
        assert f is not None and f.code == "HT901"
        assert f.severity == "warn"      # 2 excess compiles / 10 steps
        assert_priced(f)
        assert f.data["bucket"] == "jit"
        got[pkg] = rows(report, anchor.id)
        # clean twin: the serving pow2-bucketing contract
        assert eff.recompile_pass(
            [((b, 64), "float32") for b in (1, 2, 4, 8, 16, 32)],
            PKGS[pkg][4](), steps=10) is None
        # under budget is clean too
        assert eff.recompile_pass(KEYS_901[:3], PKGS[pkg][4](),
                                  steps=10) is None
    assert_same(got)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_ht901_suppressed(pkg):
    ht, eff = PKGS[pkg][:2]
    anchor = ht.Variable("feed901s", trainable=False)  # ht-ok: HT901 test waiver: fixture pins the suppression path
    assert eff.recompile_pass(KEYS_901, PKGS[pkg][4](), steps=10,
                              node=anchor) is None


def test_ht901_runtime_advisor():
    """The JAX executor's compile-churn hook fires HT901 once over 8
    distinct non-pow2 feed shapes. The port's eager walk compiles
    nothing and has no such hook: its session report holds no HT901,
    and the static pass over the same signatures prices what the
    reference's hook reports."""
    from hetu_tpu.executor import Executor as JExecutor
    batches = (3, 5, 6, 7, 9, 11, 13, 17)
    rng = np.random.RandomState(0)
    feeds = [rng.randn(b, 4).astype("f") for b in batches]
    found = {}
    for pkg in PKGS:
        ht = PKGS[pkg][0]
        x = ht.Variable("x901rt", trainable=False)
        w = ht.init.random_normal((4, 3), name="w901rt")
        loss = ht.reduce_mean_op(ht.matmul_op(x, w), [0, 1])
        exe = (JExecutor([loss], validate="warn") if pkg == "jax" else
               tht.Executor([loss], validate="warn", device="cpu"))
        try:
            for value in feeds:
                exe.run(feed_dict={x: value})
        finally:
            exe.close()
        found[pkg] = [f for f in exe.config.analysis_report.findings
                      if f.code == "HT901"]
    assert len(found["jax"]) == 1        # fires once, not per compile
    assert found["jax"][0].data["signatures"] >= 8
    assert found["torch"] == []
    static = teff.recompile_pass([((b, 4), "float32") for b in batches],
                                 TReport(), steps=len(batches))
    ref = found["jax"][0]
    assert static.severity == ref.severity
    assert static.data["signatures"] == len(batches)
    assert {k: static.data[k] for k in ("bucket", "source")} == \
        {k: ref.data[k] for k in ("bucket", "source")}


# ---------------------------------------------------------------------------
# HT902 — GEMM padding waste, held to the card's model
# ---------------------------------------------------------------------------

def _ht902_matmul(ht, n_out=72, k=4096, waived=False):
    a = ht.init.random_normal((256, k), name="a902")
    if waived:
        b = ht.init.random_normal((k, n_out), name="b902w")
        y = ht.matmul_op(a, b)  # ht-ok: HT902 test waiver: fixture pins the suppression path
    else:
        b = ht.init.random_normal((k, n_out), name="b902")
        y = ht.matmul_op(a, b)
    return [ht.reduce_mean_op(y, [0, 1])]


def _card_waste(k, n, dtype="float32"):
    gk, gn = teff._GRANULE[dtype]
    return 1.0 - (k * n) / (teff._pad(k, gk) * teff._pad(n, gn))


def test_ht902_matmul_fixture():
    """N=72 (f32) rounds up to the card's 64-wide N granule: 44% of the
    GEMM's work is padding, as the TPU's 128 lanes make it; the finding
    is the reference's. A K or N aligned on the card is clean, and the
    waiver works."""
    waste = _card_waste(4096, 72)
    assert waste >= teff._WASTE_FRAC_FLOOR
    got, reports = twin(lambda ht: (_ht902_matmul(ht), {}))
    assert_same(got)
    hits = [f for f in reports["torch"].findings if f.code == "HT902"]
    assert len(hits) == 1
    f = hits[0]
    assert f.severity == "warn"
    assert_priced(f)
    assert f.data["bucket"] == "compute"
    assert f.data["waste_frac"] == round(waste, 4)
    for n_out in (64, 128):
        clean, _ = run_pass("torch", _ht902_matmul(tht, n_out=n_out))
        assert "HT902" not in codes(clean)
    waived, _ = run_pass("torch", _ht902_matmul(tht, waived=True))
    assert "HT902" not in codes(waived)


@pytest.mark.parametrize("n_out,k", [(160, 4096), (128, 168)])
def test_ht902_card_granule_diverges_from_the_tpu_lane(n_out, k):
    """Where the TPU's 128-lane tile pads and the card's granule does
    not (N=160 is 2.5 of its 64-wide steps; K steps every 8 on the card),
    the JAX package fires and the port is clean."""
    assert _card_waste(k, n_out) < teff._WASTE_FRAC_FLOOR
    fired = {pkg: codes(run_pass(pkg, _ht902_matmul(PKGS[pkg][0],
                                                    n_out=n_out, k=k))[0])
             for pkg in PKGS}
    assert "HT902" in fired["jax"] and "HT902" not in fired["torch"]


def _bf16_matmul(n_out):
    a = tht.Variable("a902h", trainable=False)
    b = tht.Variable("b902h", trainable=False)
    y = tht.matmul_op(a, b)
    return [tht.reduce_mean_op(y, [0, 1])], {
        a: ((256, 4096), torch.bfloat16),
        b: ((4096, n_out), torch.bfloat16)}


def test_ht902_bf16_granule():
    """A bf16 GEMM takes the card's bf16 model. N=260 stores rows that
    are not whole 16-byte vectors: it fires, priced at the measured
    misalignment share on top of its padding's. N=264 is aligned but
    pads to the 32-wide N granule: at M=256 the GEMM's bytes bound it,
    so the padding costs no time and it is clean; N=256 is clean."""
    nodes, feeds = _bf16_matmul(260)
    report, topo = run_pass("torch", nodes, feed_shapes=feeds)
    hits = [f for f in report.findings if f.code == "HT902"]
    waste = _card_waste(4096, 260, "bfloat16")
    assert [f.data["waste_frac"] for f in hits] == [round(waste, 4)]
    _, share, mis = teff._matmul_share(256, 4096, 260, torch.bfloat16,
                                       rows=(4096, 260, 260))
    assert mis and share >= teff._MISALIGNED_SHARE["bfloat16"]
    shapes, dtypes = _shapes_dtypes(topo, feeds)
    op_ms, _, _ = teff.op_costs(topo, shapes, teff._db(None), dtypes)
    matmul = next(n for n in topo if n.op_type == "MatMulOp")
    assert hits[0].data["estimated_ms_per_step"] == round(
        op_ms[matmul] * share, 6)
    for n_out in (264, 256):
        nodes, feeds = _bf16_matmul(n_out)
        clean, _ = run_pass("torch", nodes, feed_shapes=feeds)
        assert "HT902" not in codes(clean), n_out


def _shapes_dtypes(topo, feeds):
    dtypes = {}
    shapes = tshape_pass(topo, TReport(), feed_shapes=feeds,
                         dtypes_out=dtypes)
    return shapes, dtypes


@pytest.mark.parametrize("m,k,n,dtype,bound", [
    (256, 4096, 72, torch.float32, "operations"),
    (8192, 8192, 264, torch.bfloat16, "operations"),
    (256, 4096, 264, torch.bfloat16, "bytes")])
def test_ht902_prices_padding_on_the_roofline(m, k, n, dtype, bound):
    """The padding's share of a GEMM's time is its share of the work
    where the card's GEMM rate bounds the GEMM, and nothing where its
    bytes at the copy rate do."""
    waste = teff._lane_waste(k, n, dtype)
    nbytes = dtype.itemsize * (m * k + k * n + m * n)
    share = teff._padding_share(waste, 2.0 * m * k * n, nbytes, dtype)
    if bound == "operations":
        assert math.isclose(share, waste, rel_tol=1e-9)
    else:
        assert share == 0.0 < waste


def _ht902_embedding(ht, width, ids_shape, waived=False):
    table = ht.init.random_normal((1000, width), name="e902")
    ids = ht.Variable("ids902", trainable=False)
    if waived:
        y = ht.embedding_lookup_op(table, ids)  # ht-ok: HT902 test waiver: fixture pins the suppression path
    else:
        y = ht.embedding_lookup_op(table, ids)
    return ([ht.reduce_mean_op(y, [0, 1, 2])],
            {"feed_shapes": {ids: (ids_shape, np.int32)}})


def test_ht902_embedding_fixture():
    """The reference's fixture (300000 rows of 8 f32, 16x8 ids) pads
    TPU lanes: it fires in the JAX package. On the card a row of 32 B
    is one DRAM sector: clean. A 16-byte row gathered 512x1024 times
    wastes half of each sector read, 8 MiB a step: an info finding
    priced at the card's copy rate."""
    def reference(ht):
        table = ht.init.random_normal((300000, 8), name="e902r")
        ids = ht.Variable("ids902r", trainable=False)
        y = ht.embedding_lookup_op(table, ids)
        return ([ht.reduce_mean_op(y, [0, 1, 2])],
                {ids: ((16, 8), np.int32)})
    for pkg in PKGS:
        nodes, feeds = reference(PKGS[pkg][0])
        fired = codes(run_pass(pkg, nodes, feed_shapes=feeds)[0])
        assert ("HT902" in fired) == (pkg == "jax")

    nodes, kw = _ht902_embedding(tht, 4, (512, 1024))
    report, _ = run_pass("torch", nodes, **kw)
    hits = [f for f in report.findings if f.code == "HT902"]
    assert len(hits) == 1
    f = hits[0]
    assert f.severity == "info"          # gather waste prices tiny
    assert_priced(f)
    waste = 512 * 1024 * 16
    assert f.data["padded_mib"] == round(waste / (1 << 20), 1)
    assert f.data["estimated_ms_per_step"] == round(
        waste / (teff._DRAM_GBPS * 1e6), 6)
    for width, shape, waived in ((8, (512, 1024), False),
                                 (4, (16, 8), False),
                                 (4, (512, 1024), True)):
        nodes, kw = _ht902_embedding(tht, width, shape, waived)
        assert "HT902" not in codes(run_pass("torch", nodes, **kw)[0])


def test_fit_granule_reads_the_step():
    """``fit_granule``: the coarsest granule padding up to which costs
    no time (5%, at 80% of the dims). Steps of 64 give 64; time linear in
    the dim costs under 5% for 4 more elements, so 8; time growing
    faster than that gives none (1); a flat curve gives the coarsest
    candidate (the sweep runs where GEMMs are compute-bound, so no
    curve of it is flat)."""
    dims = range(40, 265, 4)
    assert teff.fit_granule({d: float(-(-d // 64)) for d in dims}) == 64
    assert teff.fit_granule({d: float(d) for d in dims}) == 8
    assert teff.fit_granule({d: 2.0 ** (d / 8) for d in dims}) == 1
    assert teff.fit_granule({d: 1.0 for d in dims}) == teff._GRANULES[-1]


def test_measure_card_model_runs_on_the_cpu_at_a_small_size():
    got = teff.measure_card_model(
        "cpu", sweep={"float32": (16, 16, (8, 12, 16)),
                      "bfloat16": (16, 16, (8, 16, 24))},
        align_sweep=(16, 16, (8, 12, 16)), copy_bytes=1 << 12, reps=1,
        rounds=1)
    assert got["card"] == "cpu"
    assert set(got["matmul_ms"]) == set(got["granule"]) == \
        set(got["tflops"]) == {"float32", "bfloat16"}
    assert set(got["matmul_ms"]["float32"]["N"]) == {8, 12, 16}
    assert set(got["misaligned_share"]) == {"bfloat16"}
    assert got["copy"]["bytes"] == 1 << 12 and got["copy"]["gbps"] > 0
    share = teff.measure_padding_share(16, 16, 72, torch.float32, "cpu",
                                       reps=1, rounds=1)
    assert share["aligned_dims"] == (18, 16, 64)
    assert share["waste_frac"] == _card_waste(16, 72)
    assert share["priced_share"] == teff._matmul_share(
        16, 16, 72, torch.float32, rows=(16, 72, 72))[1]


# ---------------------------------------------------------------------------
# HT903 — host sync on the hot path
# ---------------------------------------------------------------------------

def _ht903_graph(ht, n_scalars):
    x = ht.Variable("x903", trainable=False)
    w = ht.init.random_normal((16, 8), name="w903")
    y = ht.matmul_op(x, w)
    loss = ht.reduce_mean_op(y, [0, 1])
    scalars = [ht.reduce_mean_op(y * float(i + 1), [0, 1])
               for i in range(8)]
    return ([loss] + scalars[:n_scalars],
            {"feed_shapes": {x: ((4, 16), np.float32)}})


def test_ht903_scalar_fetch_fixture():
    got, reports = twin(lambda ht: _ht903_graph(ht, 8))
    assert_same(got)
    hits = [f for f in reports["torch"].findings if f.code == "HT903"]
    assert len(hits) == 1
    assert hits[0].severity == "warn"    # cold d2h latency 0.1 ms each
    assert_priced(hits[0])
    assert hits[0].data["scalar_fetches"] == 9
    # clean twin: loss + a couple of metrics is normal
    clean, _ = twin(lambda ht: _ht903_graph(ht, 2))
    assert_same(clean)
    assert not [r for r in clean["torch"] if r[0] == "HT903"]


_HT903_SRC = """
def train(exe, feeds):
    for step in range(100):
        out = exe.run(feed_dict=feeds)
        print(out[0].item())
"""

_HT903_SRC_CADENCE = """
def train(exe, feeds):
    for step in range(100):
        out = exe.run(feed_dict=feeds)
        if step % 10 == 0:
            print(out[0].item())
"""

_HT903_SRC_WAIVED = """
def train(exe, feeds):
    for step in range(100):
        out = exe.run(feed_dict=feeds)
        print(out[0].item())  # ht-ok: HT903 debugging run
"""

# np.array/np.asarray building HOST feeds is not a device sync —
# only application to (a subscript of) the run result counts
_HT903_SRC_HOST_FEED = """
import numpy as np
def train(exe, x, data):
    for step in range(100):
        feeds = {x: np.array(data[step])}
        out = exe.run(feed_dict=feeds)
"""

_HT903_SRC_RESULT_ASARRAY = """
import numpy as np
def train(exe, feeds, log):
    for step in range(100):
        out = exe.run(feed_dict=feeds)
        log.append(np.asarray(out[0]))
"""

REFERENCE_SCRIPTS = {"sync": _HT903_SRC, "cadence": _HT903_SRC_CADENCE,
                     "waived": _HT903_SRC_WAIVED,
                     "host_feed": _HT903_SRC_HOST_FEED,
                     "result_asarray": _HT903_SRC_RESULT_ASARRAY}


@pytest.mark.parametrize("script", sorted(REFERENCE_SCRIPTS))
def test_ht903_ast_fixture(script):
    """On the reference's fixture scripts the findings are the
    reference's."""
    src = REFERENCE_SCRIPTS[script]
    got = {pkg: rows(PKGS[pkg][1].check_host_sync_source(
        src, path="train.py"), 0) for pkg in PKGS}
    assert_same(got)
    want = {"sync": ["train.py:5"], "result_asarray": ["train.py:6"]}
    assert [r[2] for r in got["torch"]] == want.get(script, [])


_PORT_SYNC = """
import torch
def train(exe, feeds, log, host):
    for step in range(100):
        out = exe.run(feed_dict=feeds)
        log.append(out[0].{call}())
        log.append(host.{call}())
"""


@pytest.mark.parametrize("call", ["asnumpy", "cpu", "numpy", "tolist"])
def test_ht903_port_spellings_on_a_run_result(call):
    """The port's syncs on a run result fire; the same method on a host
    value does not."""
    report = teff.check_host_sync_source(_PORT_SYNC.format(call=call),
                                         path="train.py")
    assert [(f.code, f.where) for f in report.findings] == [
        ("HT903", "train.py:6")]
    assert report.findings[0].data["bucket"] == "unaccounted"


def test_ht903_cuda_synchronize_in_the_step_loop():
    src = ("import torch\n"
           "def train(exe, feeds):\n"
           "    for step in range(100):\n"
           "        exe.run(feed_dict=feeds)\n"
           "        torch.cuda.synchronize()\n"
           "        if step % 10 == 0:\n"
           "            torch.cuda.synchronize()\n")
    report = teff.check_host_sync_source(src, path="train.py")
    assert [f.where for f in report.findings] == ["train.py:5"]


# ---------------------------------------------------------------------------
# HT904 — fragmented collectives
# ---------------------------------------------------------------------------

def _ht904_graph(ht, waived=False):
    comm = __import__(f"{ht.__name__}.ops.comm", fromlist=["x"])
    optimizer = __import__(f"{ht.__name__}.optimizer", fromlist=["x"])
    x = ht.Variable("x904", trainable=False)
    ws = [ht.init.random_normal((64, 64), name=f"w904_{i}")
          for i in range(5)]
    act = x
    for w in ws:
        act = ht.matmul_op(act, w)
    loss = ht.reduce_mean_op(act, [0, 1])
    opt = ht.optim.SGDOptimizer(0.01)
    opt.params = ws
    grads = ht.gradients(loss, ws)
    if waived:
        ars = [comm.allreduceCommunicate_op(g) for g in grads]  # ht-ok: HT904 test waiver: fixture pins the suppression path
    else:
        ars = [comm.allreduceCommunicate_op(g) for g in grads]
    train = optimizer.OptimizerOp(ars, opt)
    return [loss, train], {"feed_shapes": {x: ((32, 64), np.float32)}}


def test_ht904_fragmented_fixture():
    got, reports = twin(_ht904_graph)
    assert_same(got)
    hits = [f for f in reports["torch"].findings if f.code == "HT904"]
    assert len(hits) == 1
    f = hits[0]
    assert f.severity == "warn"
    assert_priced(f)
    assert f.data["bucket"] == "collective"
    assert f.data["collectives"] == 5
    assert f.data["buckets"] < 5
    assert f.data["recommended_bucket_bytes"] >= (1 << 20)


def test_ht904_clean_when_bucketed():
    from hetu_tpu.ingest import OverlapOptions as JOverlap
    from hetu_tpu_torch.ingest import OverlapOptions as TOverlap

    configs = {"jax": JOverlap, "torch": TOverlap}

    def run(pkg, nodes, kw):
        class Cfg:
            overlap = configs[pkg](bucket_bytes=4 << 20)
        return run_pass(pkg, nodes, config=Cfg(), **kw)[0]

    got, _ = twin(_ht904_graph, run)
    assert_same(got)
    assert not [r for r in got["torch"] if r[0] == "HT904"]


def test_ht904_suppressed():
    got, _ = twin(lambda ht: _ht904_graph(ht, waived=True))
    assert_same(got)
    assert not [r for r in got["torch"] if r[0] == "HT904"]


# ---------------------------------------------------------------------------
# HT905 — redundant reshard
# ---------------------------------------------------------------------------

def _ht905_graph(ht, resplit=True, waived=False):
    comm = __import__(f"{ht.__name__}.ops.comm", fromlist=["x"])
    x = ht.Variable("x905", trainable=False)
    w = ht.init.random_normal((1024, 1024), name="w905")
    s = comm.dispatch(w, (2, 1))
    g = comm.dispatch(s, (1, 1))
    if resplit:
        if waived:
            r = comm.dispatch(g, (2, 1))  # ht-ok: HT905 test waiver: fixture pins the suppression path
        else:
            r = comm.dispatch(g, (2, 1))
    else:
        r = g
    y = ht.matmul_op(x, r)
    return ([ht.reduce_mean_op(y, [0, 1])],
            {"feed_shapes": {x: ((8, 1024), np.float32)}})


@pytest.mark.parametrize("case", ["resplit", "gather_only", "waived"])
def test_ht905_reshard_fixture(case):
    got, reports = twin(lambda ht: _ht905_graph(
        ht, resplit=case != "gather_only", waived=case == "waived"))
    assert_same(got)
    hits = [f for f in reports["torch"].findings if f.code == "HT905"]
    assert len(hits) == (case == "resplit")
    if hits:
        f = hits[0]
        assert f.severity == "warn"      # 4 MB x 2 hops off the curve
        assert_priced(f)
        assert f.data["bucket"] == "h2d_ingest"
        assert f.data["bytes"] == 1024 * 1024 * 4


def test_ht905_constant_feed_dynamic():
    """perfcheck's dynamic half: byte-identical large feeds across
    measured steps fire HT905; varying feeds stay clean. A feed held on
    the card compares by its bytes too."""
    const = np.ones((256, 256), np.float32)
    rng = np.random.RandomState(0)
    varying = [rng.randn(256, 256).astype("f") for _ in range(3)]
    got = {}
    for pkg, perf in (("jax", jperf), ("torch", tperf)):
        x = PKGS[pkg][0].Variable("x905c", trainable=False)
        report = PKGS[pkg][4]()
        perf._constant_feeds([{x: const}, {x: const.copy()},
                              {x: const.copy()}], report)
        got[pkg] = rows(report, x.id)
        clean = PKGS[pkg][4]()
        perf._constant_feeds([{x: v} for v in varying], clean)
        assert len(clean) == 0
    assert_same(got)
    assert len(got["torch"]) == 1
    assert got["torch"][0][4]["estimated_ms_per_step"] > 0
    x = tht.Variable("x905t", trainable=False)
    report = TReport()
    tperf._constant_feeds([{x: torch.from_numpy(const)}] * 2, report)
    assert codes(report) == {"HT905"}


# ---------------------------------------------------------------------------
# HT906 — cost-weighted dead compute
# ---------------------------------------------------------------------------

def _ht906_graphs(ht, waived=False):
    x = ht.Variable("x906", trainable=False)
    w = ht.init.random_normal((16, 8), name="w906")
    loss = ht.reduce_mean_op(ht.matmul_op(x, w), [0, 1])
    da = ht.init.random_normal((512, 4096), name="dead_a906")
    db_ = ht.init.random_normal((4096, 512), name="dead_b906")
    if waived:
        dead = ht.matmul_op(da, db_)  # ht-ok: HT906 test waiver: fixture pins the suppression path
    else:
        dead = ht.matmul_op(da, db_)
    return [loss], {"feed_shapes": {x: ((4, 16), np.float32)},
                    "extra_roots": [dead]}


@pytest.mark.parametrize("case", ["dead", "no_roots", "waived"])
def test_ht906_dead_compute_fixture(case):
    def build(ht):
        nodes, kw = _ht906_graphs(ht, waived=case == "waived")
        if case == "no_roots":
            kw.pop("extra_roots")
        return nodes, kw
    got, reports = twin(build)
    assert_same(got)
    hits = [f for f in reports["torch"].findings if f.code == "HT906"]
    assert len(hits) == (case == "dead")
    if hits:
        f = hits[0]
        assert f.severity == "warn"      # ~2.1 GFLOP of dead matmul
        assert_priced(f)
        assert f.data["dead_ops"] == 1


# ---------------------------------------------------------------------------
# HT907 — untuned hot-path kernel: nothing until ROADMAP item 13
# ---------------------------------------------------------------------------

def _ht907_graph(ht, waived=False):
    q = ht.Variable("q907", trainable=False)
    k = ht.Variable("k907", trainable=False)
    v = ht.Variable("v907", trainable=False)
    if waived:
        attn = ht.flash_attention_op(q, k, v, causal=True)  # ht-ok: HT907 test waiver: fixture pins the suppression path
    else:
        attn = ht.flash_attention_op(q, k, v, causal=True)
    shp = ((2, 4, 2048, 64), np.float32)
    return [attn], {"feed_shapes": {q: shp, k: shp, v: shp}}


def test_ht907_untuned_flash_fixture(monkeypatch):
    """The JAX package's sweep has 16 block candidates at S=2048 and
    fires; each port kernel route compiles one configuration, so
    nothing fires on the port until item 13 gives it more. Handed two
    candidates, the port's pass fires as the reference's does and is
    clean under HETU_AUTOTUNE=0 or a warmed cache."""
    nodes, kw = _ht907_graph(jht)
    assert "HT907" in codes(run_pass("jax", nodes, steps=100, **kw)[0])
    assert fa._candidates(2048, 64, torch.float32) == ["simt"]
    assert fa._candidates(2048, 64, torch.bfloat16) == ["tc"]
    nodes, kw = _ht907_graph(tht)
    assert "HT907" not in codes(run_pass("torch", nodes, steps=100,
                                         **kw)[0])

    monkeypatch.setattr(fa, "_candidates", lambda s, d, dt: [0, 1])
    report, _ = run_pass("torch", nodes, steps=100, **kw)
    hits = [f for f in report.findings if f.code == "HT907"]
    assert len(hits) == 1
    f = hits[0]
    assert f.severity == "warn"
    assert_priced(f)
    assert f.data["bucket"] == "jit"
    assert f.data["estimated_ms_first_step"] > \
        f.data["estimated_ms_per_step"]
    assert f.data["sweep_candidates"] == 2
    monkeypatch.setenv("HETU_AUTOTUNE", "0")
    clean, _ = run_pass("torch", nodes, **kw)
    assert "HT907" not in codes(clean)
    monkeypatch.delenv("HETU_AUTOTUNE")
    from hetu_tpu_torch.tune.autotune import AutotuneTable
    table = AutotuneTable()
    for kind in ("fwd", "fwd_lse", "bwd"):
        name, key = fa.tune_key(kind, 2048, 64, torch.float32, True, False)
        table.put(name, key, (64, 64))
    warm, _ = run_pass("torch", nodes, **kw)
    assert "HT907" not in codes(warm)


def test_ht907_suppressed(monkeypatch):
    monkeypatch.setattr(fa, "_candidates", lambda s, d, dt: [0, 1])
    for pkg in PKGS:
        nodes, kw = _ht907_graph(PKGS[pkg][0], waived=True)
        assert "HT907" not in codes(run_pass(pkg, nodes, **kw)[0])


# ---------------------------------------------------------------------------
# HT908 — coverage-gap advisory
# ---------------------------------------------------------------------------

def test_ht908_coverage_advisory(tmp_path):
    """One CostDB file, handed to both packages."""
    from hetu_tpu.telemetry.costdb import CostDB as JCostDB
    from hetu_tpu_torch.telemetry.costdb import CostDB as TCostDB
    path = str(tmp_path / "cov.json")
    db = TCostDB(path)
    db.record("SomeOtherOp", (1, 1), "float32", 0.5)
    db.save()
    dbs = {"jax": JCostDB(path), "torch": TCostDB(path)}
    got, reports = twin(lambda ht: (_ht902_matmul(ht, n_out=128), {}),
                        lambda pkg, nodes, kw: run_pass(
                            pkg, nodes, costdb=dbs[pkg], **kw)[0])
    assert_same(got)
    hits = [f for f in reports["torch"].findings if f.code == "HT908"]
    assert len(hits) == 1
    f = hits[0]
    assert f.severity == "info"          # advisory, never gates
    assert_priced(f)
    assert f.data["guessed_ops"] >= 1
    # clean twin: a fully cold DB is vacuous (the doctor owns the
    # global "run costdb --sweep" hint)
    cold, _ = run_pass("torch", _ht902_matmul(tht, n_out=128),
                       costdb=TCostDB(str(tmp_path / "cold.json")))
    assert "HT908" not in codes(cold)


def test_a_bf16_session_prices_its_bf16_profile(tmp_path):
    """A CostDB entry measured in bf16 (``profile_op_records`` keys a
    bf16 session's ops by that dtype) prices the op where the shape pass
    gives it bf16, and not its f32 twin (the JAX package keys every
    lookup ``float32``)."""
    from hetu_tpu_torch.telemetry.costdb import CostDB
    db = CostDB(str(tmp_path / "bf16.json"))
    db.record("MatMulOp", (256, 256), "bfloat16", 0.25)
    for dtype, want in ((torch.bfloat16, "measured"),
                        (torch.float32, "cold_start")):
        nodes, feeds = _bf16_matmul(256)
        feeds = {n: (shape, dtype) for n, (shape, _) in feeds.items()}
        sources = {}
        topo = ttopo(nodes)
        teff.efficiency_pass(topo, TReport(), costdb=db,
                             feed_shapes=feeds, sources_out=sources)
        matmul = next(n for n in topo if n.op_type == "MatMulOp")
        assert sources[matmul] == want


# ---------------------------------------------------------------------------
# report shape, CLI, zoo gate, analyze() wiring
# ---------------------------------------------------------------------------

def test_sorted_by_savings_and_result_shape():
    res = {}
    for pkg in PKGS:
        nodes, kw = _ht906_graphs(PKGS[pkg][0])
        res[pkg] = PKGS[pkg][1].predict(nodes, **kw)
    r = res["torch"]
    assert isinstance(r, teff.EfficiencyResult)
    assert r.total_ms > 0
    assert r.predicted_waste_ms() > 0
    ms = [f.data["estimated_ms_per_step"] for f in r.findings]
    assert ms == sorted(ms, reverse=True)
    doc = r.to_dict()
    assert doc["findings"] and "estimated_ms_per_step" in \
        doc["findings"][0]
    assert math.isclose(r.total_ms, res["jax"].total_ms, rel_tol=1e-9)
    assert r.predicted_waste_ms() == res["jax"].predicted_waste_ms()
    assert [f.code for f in r.findings] == \
        [f.code for f in res["jax"].findings]


def test_zoo_clean_gate():
    """Every zoo model carries zero unsuppressed HT9xx findings under
    the card's model — with none of the reference's TPU-lane waivers in
    the port's models."""
    results = teff.check_zoo()
    bad = [(name, str(f)) for name, res in results.items()
           for f in res.report.findings]
    assert not bad, bad


def test_efficiency_cli_zoo_subset(tmp_path, capsys):
    out = tmp_path / "efficiency_report.json"
    assert teff.main(["mlp", "wdl_adult", "--json", "--out",
                      str(out)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {"mlp", "wdl_adult"}
    assert os.path.exists(out)
    assert json.loads(out.read_text())["mlp"]["findings"] == []


def test_efficiency_cli_gates_a_script(tmp_path, capsys):
    script = tmp_path / "train.py"
    script.write_text(_HT903_SRC)
    assert teff.main(["logreg", "--scripts", str(script)]) == 1
    assert f"{script}:5" in capsys.readouterr().out


def test_analyze_includes_efficiency_pass_never_errors():
    """HT9xx findings surface through analyze() (Executor validate /
    preflight) at warn severity — they advise, never block a launch —
    and are the reference's."""
    got = {}
    for pkg, an in (("jax", janalyze), ("torch", tanalyze)):
        nodes = _ht902_matmul(PKGS[pkg][0])
        report = an(nodes)
        hits = [f for f in report.findings if f.code == "HT902"]
        assert hits and hits[0].severity == "warn"
        assert report.ok                 # no errors: launch proceeds
        nine = PKGS[pkg][4]()
        nine.findings.extend(f for f in report.findings
                             if f.code.startswith("HT9"))
        got[pkg] = rows(nine, base_of(pkg, nodes))
    assert_same(got)


@pytest.mark.parametrize("preflight,device,want", [
    (True, None, "cuda-unnamed"), (True, "cuda", "cuda-unnamed"),
    (True, "cpu", "cpu"), (False, None, "cuda-unnamed"),
    (False, "cpu", "cpu")])
def test_analyze_prices_without_asking_the_card_its_name(
        monkeypatch, preflight, device, want):
    """On a host with a card (faked here), ``analyze`` under
    ``HETU_PREFLIGHT`` or with no device named prices the efficiency
    pass in a partition that asks the card nothing — asking its name
    initializes CUDA, which a preflight must not — and a named CPU
    session in the CPU's partition."""
    import importlib
    import hetu_tpu_torch.analysis as tanalysis
    autotune = importlib.import_module("hetu_tpu_torch.tune.autotune")

    def no_name(*_a, **_k):
        raise AssertionError("the card was asked its name")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", no_name)
    monkeypatch.setattr(autotune, "_TAGS", {})
    if preflight:
        monkeypatch.setenv("HETU_PREFLIGHT", "1")
    seen = []
    real = tanalysis.efficiency_pass

    def spy(*a, **kw):
        seen.append(autotune.platform_tag())
        return real(*a, **kw)
    monkeypatch.setattr(tanalysis, "efficiency_pass", spy)
    report = tanalyze(_ht902_matmul(tht), device=device)
    assert seen == [want]
    assert not [f for f in report.findings
                if f.code == "HT001" and "'efficiency'" in str(f)]
    assert "HT902" in codes(report)


def test_validate_error_session_runs_with_ht9xx_findings():
    """``validate="error"`` lets a session with HT9xx warnings run."""
    nodes = _ht902_matmul(tht)
    exe = tht.Executor(nodes, device="cpu", validate="error")
    try:
        out = exe.run(feed_dict={})
    finally:
        exe.close()
    assert "HT902" in codes(exe.config.analysis_report)
    assert np.isfinite(float(out[0].asnumpy()))


# ---------------------------------------------------------------------------
# satellites: doctor cross-link, regress, the fleet's bound
# ---------------------------------------------------------------------------

def test_doctor_remediation_cites_ht_codes():
    from hetu_tpu_torch.telemetry import doctor

    a = {"steps": 4, "windows": 4, "wall_ms": 4.0,
         "buckets": {"collective": 2.0, "compute": 2.0},
         "per_step_ms": {"collective": 0.5, "compute": 0.5},
         "step_wall_ms": 1.0, "hidden_ms": {}, "segments": [],
         "conserved": True, "conservation_error": 0.0}
    diag = doctor.diagnose({"rank0": a})
    top = diag["top_exposed_bucket"]
    assert top["bucket"] == "collective"
    assert top["ht_code"] == "HT904"
    assert "HT904" in top["remedy"]
    assert "python -m hetu_tpu_torch.analysis.efficiency" in top["remedy"]
    ranked = {r["bucket"]: r for r in diag["ranked_exposed"]}
    assert ranked["collective"]["ht_code"] == "HT904"


def test_regress_estimated_ms_informational():
    from hetu_tpu_torch.telemetry.regress import compare

    old = {"m": {"metric": "m", "value": 10.0, "unit": "ms/step",
                 "estimated_ms_per_step": 1.0, "ht9xx_findings": 2}}
    new = {"m": {"metric": "m", "value": 10.0, "unit": "ms/step",
                 "estimated_ms_per_step": 99.0, "ht9xx_findings": 0}}
    rows_ = compare(old, new, 0.15)
    by_name = {r[0]: r for r in rows_}
    # reported on their face, never direction-compared
    assert by_name["m.estimated_ms_per_step"][4] == "info"
    assert by_name["m.ht9xx_findings"][4] == "info"
    assert by_name["m"][4] == "ok"


def test_fleet_bound_is_perfchecks():
    """perfcheck's HT910 bound is the one the fleet plane defines for
    its torch-free CLI, and the reference's."""
    from hetu_tpu_torch.telemetry import fleet
    assert tperf.SOUND_FACTOR is fleet.SOUND_FACTOR
    assert tperf.SOUND_SLACK_MS is fleet.SOUND_SLACK_MS
    assert (tperf.SOUND_FACTOR, tperf.SOUND_SLACK_MS) == \
        (jperf.SOUND_FACTOR, jperf.SOUND_SLACK_MS)
    assert tperf.AB_TOLERANCE == jperf.AB_TOLERANCE
    assert teff.DOCTOR_BUCKET == jeff.DOCTOR_BUCKET


# ---------------------------------------------------------------------------
# perfcheck: the doctor-validated soundness twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["mlp", "wdl_adult"])
def test_perfcheck_roundtrip(model):
    """A dense and a sparse zoo model run under the trace on the CPU;
    every surviving priced claim is consistent with the measured doctor
    buckets — no HT910."""
    report, checked, buckets, static = tperf.perfcheck_model(
        model, steps=6, device="cpu")
    viol = [f for f in report.findings if f.code == "HT910"]
    assert not viol, [str(f) for f in viol]
    assert buckets, "doctor produced no measured buckets"
    assert buckets.get("compute", 0) >= 0


def test_perfcheck_cli_on_the_cpu(capsys):
    assert tperf.main(["logreg", "--steps", "3", "--device", "cpu",
                       "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["logreg"]["violations"] == 0


def test_ht910_escape_fixture():
    """The gate bites: a priced claim bigger than its measured bucket
    allows is an HT910 error naming both numbers."""
    big_claim = Finding("HT904", "warn", "synthetic fragmented claim",
                        node="AllReduce_x", where="model.py:7",
                        estimated_ms_per_step=100.0,
                        bucket="collective", source="cold_start")
    fine_claim = Finding("HT902", "warn", "synthetic tile claim",
                         node="MatMul_y", where="model.py:9",
                         estimated_ms_per_step=0.2,
                         bucket="compute", source="cold_start")
    measured = {"collective": 0.01, "compute": 1.5}
    report, checked = tperf.soundness_pass([big_claim, fine_claim],
                                           measured)
    assert checked == 2
    viol = [f for f in report.findings if f.code == "HT910"]
    assert len(viol) == 1
    v = viol[0]
    assert v.severity == "error"
    assert v.data["claim_code"] == "HT904"
    assert v.data["claimed_ms"] == 100.0
    assert v.data["measured_ms"] == 0.01
    ref, _ = jperf.soundness_pass([big_claim, fine_claim], measured)
    assert [(f.code, f.node, f.where, f.data) for f in ref.findings] == \
        [(f.code, f.node, f.where, f.data) for f in report.findings]
    # unmeasured buckets and unpriced advisories are vacuous
    report2, checked2 = tperf.soundness_pass([big_claim], {"compute": 1.0})
    assert checked2 == 0 and not report2.findings


def test_serving_claim_check_is_the_references():
    for args in ((100.0, 1000, 10.0), (1000.0, 1000, 10.0),
                 (100.0, 0, 10.0), (0.0, 1000, 10.0)):
        assert tperf.serving_claim_check(*args) == \
            jperf.serving_claim_check(*args)


def test_ht904_ab_measured_confirms_prediction():
    """The HT904 pricing's predicted bucketed-vs-per-grad savings is
    confirmed by a measured A/B between two CPU thread ranks within the
    documented AB_TOLERANCE (the prediction uses a curve fitted on this
    machine's own measured collective points)."""
    assert tperf.ab_bucketed_allreduce(ranks=1, device="cpu") is None
    r = tperf.ab_bucketed_allreduce(reps=4, device="cpu")

    def consistent(r):
        return (r["predicted_ms"] > 0 and r["measured_ms"] > 0
                and 1.0 / tperf.AB_TOLERANCE
                <= r["measured_ms"] / r["predicted_ms"]
                <= tperf.AB_TOLERANCE)

    if not consistent(r):
        # one refinement pass: a loaded CI box can smear the first
        # measurement window; more reps tighten both sides
        r = tperf.ab_bucketed_allreduce(reps=12, device="cpu")
    assert r["predicted_ms"] > 0, r
    assert r["measured_ms"] > 0, r
    assert consistent(r), r
    assert r["curve"]["points"] == 2
