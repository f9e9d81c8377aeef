"""The port's perf doctor (hetu_tpu_torch/telemetry/doctor.py, training
mode) against the JAX package's (tests/test_doctor.py): the span
classes, the interval arithmetic, bucket attribution with its
conservation check, hidden against exposed transfer, ``step_block``
weighting, the diagnosis and its text, and the CLI — on the same
synthetic traces in both packages, exactly, as it is the same
arithmetic. The port's own span names: ``cpp_tick`` is ``compute``, and
``GroupComm``'s ``allreduce`` / ``collective_*`` spans are
``collective``.

Driven twins: the same MLP through both packages' executors with
telemetry on (runs, a ``run_batches`` block and streamed blocks), whose
traces the doctor attributes to the same steps, conserved, with the same
buckets holding time but the compile's; and a data-parallel session of
two thread ranks, whose allreduce time lands in ``collective``; the
disabled collective allocates nothing.

Twins elsewhere: the CostDB (test_torch_costdb.py), the span schema
(test_torch_telemetry.py), ``regress`` (test_torch_blackbox_core.py).
No twin yet: ``test_bench_emit_stamps_doctor_buckets`` needs the port's
benchmark (ROADMAP item 7)."""
import gc
import json
import sys

import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.telemetry as jtel
import hetu_tpu_torch as tht
from hetu_tpu.telemetry import doctor as jdoctor
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.telemetry import NULL, check, doctor
from hetu_tpu_torch.telemetry.costdb import CostDB


@pytest.fixture(autouse=True)
def _reset_global_telemetry():
    yield
    ttel._default = None
    jtel._default = None


def _ev(name, ts, dur, pid=0, tid=0, **args):
    ev = {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
          "pid": pid, "tid": tid, "cat": "hetu"}
    if args:
        ev["args"] = args
    return ev


# ---------------------------------------------------------------------------
# synthetic traces: exact twins
# ---------------------------------------------------------------------------

TRACES = {
    "priority": [
        _ev("step", 0, 1000, subgraph="default"),
        _ev("ps:host_pull", 0, 300),
        _ev("ps:pull", 50, 200, bytes=1024, overlapped=False),
        _ev("pp_fwd_block", 300, 400, stage=0),
        _ev("pp_stage_idle", 350, 100, stage=0, tag="t", bytes=64),
        _ev("device_dispatch", 700, 200, subgraph="default")],
    "straddling_claim": [
        _ev("step", 0, 20),
        _ev("pp_stage_idle", 5, 10, stage=0, tag="t", bytes=1),
        _ev("h2d_transfer", 0, 10, bytes=1, overlapped=False),
        _ev("h2d_transfer", 12, 8, bytes=1, overlapped=False)],
    "hidden_transfer": [
        _ev("step", 0, 1000),
        _ev("h2d_transfer", 100, 300, bytes=4096, overlapped=True),
        _ev("ps:pull", 200, 400, tid=7, bytes=2048, overlapped=True),
        _ev("h2d_transfer", 600, 100, bytes=512, overlapped=False)],
    "step_block": [
        _ev("step_block", 0, 5000, steps=50, subgraph="default"),
        _ev("block_dispatch", 500, 4000, steps=50, subgraph="default"),
        _ev("step", 600, 100)],
    "ps_remedy": [
        _ev("step", 0, 1000),
        _ev("ps:host_pull", 0, 600),
        _ev("device_dispatch", 600, 300)],
    "two_ranks_two_threads": [
        _ev("step", 0, 800, pid=0), _ev("device_dispatch", 0, 500, pid=0),
        _ev("allreduce", 500, 250, pid=0, bytes=4096, kind="dense"),
        _ev("step", 0, 800, pid=0, tid=1),
        _ev("device_dispatch", 0, 700, pid=0, tid=1),
        _ev("collective_all_gather", 700, 50, pid=0, tid=1, bytes=64,
            kind="gather"),
        _ev("step", 10, 900, pid=1), _ev("p2p_recv", 10, 600, pid=1,
                                         tag="a", bytes=8),
        _ev("step", 1000, 900, pid=1), _ev("unknown_user_span", 1000, 900,
                                           pid=1)],
    "no_windows": [_ev("h2d_transfer", 0, 10, bytes=1, overlapped=False)],
}


@pytest.mark.parametrize("case", sorted(TRACES))
def test_attribution_equals_the_reference(case):
    """Buckets, windows, steps, hidden time, segments and the
    conservation verdict: exactly the reference's; and the reference
    tests' expectations on its cases."""
    events = TRACES[case]
    port = doctor.attribute_events(events)
    assert port == jdoctor.attribute_events(events)
    if case == "no_windows":
        assert port is None
        return
    assert port["conserved"]
    assert sum(port["buckets"].values()) == pytest.approx(port["wall_ms"])
    b = port["buckets"]
    if case == "priority":
        assert (b["ps_pull"], b["bubble"], b["compute"], b["unaccounted"]) \
            == pytest.approx((0.3, 0.1, 0.5, 0.1))
    elif case == "straddling_claim":
        assert (b["bubble"], b["h2d_ingest"]) == pytest.approx((0.01, 0.01))
    elif case == "hidden_transfer":
        assert port["hidden_ms"] == {"h2d_ingest": 0.3, "ps_pull": 0.4}
    elif case == "step_block":
        assert (port["steps"], port["windows"]) == (50, 1)
        assert port["per_step_ms"]["compute"] == pytest.approx(0.08)
    elif case == "two_ranks_two_threads":
        assert b["collective"] == pytest.approx(0.3)
        assert b["p2p"] == pytest.approx(0.6)


@pytest.mark.parametrize("case", ["priority", "hidden_transfer",
                                  "ps_remedy", "two_ranks_two_threads"])
def test_diagnosis_equals_the_reference(case):
    """The diagnosis over the same attribution — straggler, ranked
    buckets, bubble fraction, comm:compute, transfer hidden fraction —
    is the reference's but the remedy texts, which name the port's
    knobs; the text differs only in those lines."""
    events = TRACES[case]
    if case == "two_ranks_two_threads":
        per = {f"rank{p}": doctor.attribute_events(
            [e for e in events if e["pid"] == p]) for p in (0, 1)}
    else:
        per = {"rank0": doctor.attribute_events(events)}
    port = doctor.diagnose(per)
    ref = jdoctor.diagnose(per)
    assert port["top_exposed_bucket"].pop("remedy")
    ref["top_exposed_bucket"].pop("remedy")
    assert port == ref

    def text(mod, diag):
        return [ln for ln in mod.render_text(diag).splitlines()
                if not ln.startswith("  -> ")]
    assert text(doctor, doctor.diagnose(per)) == \
        text(jdoctor, jdoctor.diagnose(per))
    if case == "hidden_transfer":
        assert port["transfer_hidden_fraction"] == pytest.approx(0.875)
    if case == "ps_remedy":
        assert port["top_exposed_bucket"]["bucket"] == "ps_pull"
        assert "lookahead" in doctor._remedy("ps_pull")
        assert port["comm_compute_ratio"] == pytest.approx(2.0, rel=1e-3)


def test_classes_are_the_references_plus_the_ports_spans():
    """Every span name the reference classifies is classified alike;
    the port adds ``cpp_tick`` (compute) — the reference leaves it
    unclassified — and its collectives fall under the reference's own
    ``allreduce`` / ``collective`` prefixes."""
    for name in list(jdoctor._EXACT) + ["ps:new_phase", "allreduce_x",
                                        "collective_y", "user_span"]:
        assert doctor.classify(name) == jdoctor.classify(name), name
    assert doctor.classify("cpp_tick") == "compute"
    assert jdoctor.classify("cpp_tick") is None
    for name in ("allreduce", "collective_all_gather",
                 "collective_all_to_all", "collective_ring"):
        assert doctor.classify(name) == "collective"
        assert name in check.SPAN_SCHEMA
    assert doctor.BUCKETS == jdoctor.BUCKETS


def test_cpp_tick_is_compute_where_the_reference_leaves_it_unaccounted():
    events = [_ev("step", 0, 1000), _ev("cpp_tick", 0, 400, tick=0,
                                         stage=0, microbatch=0, phase="f"),
              _ev("cpp_tick", 400, 400, tick=1, stage=1, microbatch=0,
                  phase="f")]
    port = doctor.attribute_events(events)
    ref = jdoctor.attribute_events(events)
    assert port["buckets"]["compute"] == pytest.approx(0.8)
    assert ref["buckets"]["unaccounted"] == pytest.approx(1.0)
    assert port["conserved"] and ref["conserved"]


def test_interval_arithmetic_equals_the_reference():
    rng = np.random.RandomState(0)
    for _ in range(200):
        ivs = [sorted(rng.randint(0, 100, 2).tolist())
               for _ in range(rng.randint(0, 8))]
        claimed = [sorted(rng.randint(0, 100, 2).tolist())
                   for _ in range(rng.randint(0, 8))]
        a, b = doctor._merge(ivs), doctor._merge(claimed)
        assert a == jdoctor._merge(ivs)
        assert doctor._subtract(a, b) == jdoctor._subtract(a, b)
        assert doctor._total(a) == jdoctor._total(a)
        # the subtraction conserves: fresh + overlap = the input
        fresh = doctor._subtract(a, b)
        inter = doctor._total(a) - doctor._total(fresh)
        assert 0 <= inter <= doctor._total(b)


# ---------------------------------------------------------------------------
# driven twins
# ---------------------------------------------------------------------------

def _mlp(ht):
    rng = np.random.RandomState(0)
    x = ht.Variable("dr_x", trainable=False)
    y_ = ht.Variable("dr_y", trainable=False)
    w1 = ht.Variable("dr_w1", value=rng.randn(16, 12).astype("f") * 0.3)
    w2 = ht.Variable("dr_w2", value=rng.randn(12, 4).astype("f") * 0.3)
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    return x, y_, loss, ht.optim.SGDOptimizer(0.1).minimize(loss)


def _drive(ht, tel_mod, tdir, **kw):
    """4 run() steps, a 4-step run_batches block and 3 streamed 4-step
    blocks: 20 steps (the reference test's run)."""
    tel = tel_mod.Telemetry(enabled=True, out_dir=str(tdir), rank=0)
    x, y_, loss, train = _mlp(ht)
    exe = ht.Executor([loss, train], telemetry=tel, **kw)
    rng = np.random.RandomState(0)

    def feeds():
        return {x: rng.randn(8, 16).astype("f"),
                y_: np.eye(4, dtype="f")[rng.randint(0, 4, 8)]}
    for _ in range(4):
        exe.run(feed_dict=feeds())
    exe.run_batches([feeds() for _ in range(4)])
    exe.run_batches_stream([[feeds() for _ in range(4)] for _ in range(3)])
    exe.close()
    tel.flush()
    tel_mod._default = None


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    root = tmp_path_factory.mktemp("doctor")
    _drive(tht, ttel, root / "port", ctx=tht.cpu(0))
    _drive(jht, jtel, root / "jax")
    return root


def test_driven_trace_attributes_as_the_reference(driven):
    """The same 20 steps in both packages' traces: valid, conserved
    within the doctor's 10% (both), and the same buckets holding time
    but ``jit`` (the port compiles nothing, ROADMAP §3)."""
    n, errors = check.validate(str(driven / "port" / "trace_rank0.json"))
    assert not errors, errors
    port = doctor.attribute_trace(str(driven / "port"))["rank0"]
    ref = jdoctor.attribute_trace(str(driven / "jax"))["rank0"]
    assert port["steps"] == ref["steps"] == 20
    assert port["windows"] == ref["windows"]
    for a in (port, ref):
        assert a["conserved"]
        assert abs(sum(a["buckets"].values()) - a["wall_ms"]) \
            <= 0.10 * a["wall_ms"]
    assert {k for k, v in port["buckets"].items() if v > 0} == \
        {k for k, v in ref["buckets"].items() if v > 0} - {"jit"}
    assert port["buckets"]["compute"] > 0 and port["buckets"]["jit"] == 0


def test_doctor_cli(driven, tmp_path, capsys):
    """``main`` (what ``python -m hetu_tpu_torch.telemetry.doctor``
    runs): ``--json`` exits 0 with a conserved diagnosis, the text names
    the top bucket, a cost DB's coverage and a bench file's headline ride
    beside it; an empty dir exits 1, a missing one 2."""
    tdir = str(driven / "port")
    db = CostDB(str(tmp_path / "costdb.json"))
    db.record("allreduce", 1024, "bytes", 0.5, nbytes=1024)
    db.save()
    bench = tmp_path / "b.json"
    bench.write_text(json.dumps({"metric": "m", "value": 1.0,
                                 "unit": "ms/step", "step_ms_p50": 2.0}))
    assert doctor.main([tdir, "--json", "--costdb", db.path,
                        "--bench", str(bench)]) == 0
    diag = json.loads(capsys.readouterr().out)
    assert diag["conserved"] is True
    assert diag["ranks"]["rank0"]["steps"] == 20
    assert diag["costdb"]["comm_covered"] == ["allreduce"]
    assert "h2d" in diag["costdb"]["comm_gaps"]
    assert diag["bench"]["m"] == {"value": 1.0, "unit": "ms/step",
                                  "step_ms_p50": 2.0}
    assert doctor.main([tdir]) == 0
    out = capsys.readouterr().out
    assert "top exposed bucket" in out and "conservation" in out
    assert doctor.main([str(tmp_path / "empty_dir_none")]) == 2
    (tmp_path / "empty").mkdir()
    assert doctor.main([str(tmp_path / "empty")]) == 1


def _dp_session(tel):
    x, y_, loss, train = _mlp(tht)
    exe = tht.Executor([loss, train], ctx=[tht.gpu(0), tht.gpu(1)],
                       device="cpu", telemetry=tel)
    rng = np.random.RandomState(0)
    feeds = {x: rng.randn(8, 16).astype("f"),
             y_: np.eye(4, dtype="f")[rng.randint(0, 4, 8)]}
    return exe, feeds


def test_data_parallel_collectives_are_the_collective_bucket(tmp_path):
    """Two data-parallel thread ranks (one gloo group): each step's
    gradient allreduce is an ``allreduce`` span with its bytes, so the
    doctor's ``collective`` bucket holds time, every window conserves,
    and the trace is valid under both packages' checks."""
    from hetu_tpu.telemetry.check import validate as jvalidate
    exe, feeds = _dp_session(tel=str(tmp_path))
    for _ in range(4):
        exe.run(feed_dict=feeds)
    exe.close()
    trace = str(tmp_path / "trace_rank0.json")
    assert not check.validate(trace)[1] and not jvalidate(trace)[1]
    events = json.load(open(trace))["traceEvents"]
    spans = [e for e in events if e.get("name") == "allreduce"]
    assert spans and all(e["args"]["bytes"] > 0 for e in spans)
    # one step span a rank a run, each on its rank's thread of the run
    steps = [e for e in events if e.get("name") == "step"]
    assert len(steps) == 8
    a = doctor.attribute_trace(str(tmp_path))["rank0"]
    assert a["steps"] == 8 and a["conserved"]
    assert a["buckets"]["collective"] > 0


def _retained(fn, warm=200, calls=2000):
    for _ in range(warm):
        fn()
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(calls):
        fn()
    gc.collect()
    return sys.getallocatedblocks() - before


def test_disabled_collective_allocates_nothing(monkeypatch):
    """``GroupComm``'s collectives with telemetry off read the shared
    disabled instance and keep nothing: 2000 all_reduces over a gloo
    group retain fewer blocks than a quarter of one a call, where the
    same calls with telemetry on keep their spans (one or more a call)."""
    import torch
    import torch.distributed as dist
    from hetu_tpu_torch.ops.comm import GroupComm
    pg = dist.ProcessGroupGloo(dist.HashStore(), 0, 1)
    comm = GroupComm(pg)
    buf = torch.ones(64)
    monkeypatch.setattr(ttel, "_default", NULL)
    grown = _retained(lambda: comm.all_reduce(buf))
    assert grown < 2000 // 4, f"2000 disabled all_reduces kept {grown}"
    monkeypatch.setattr(ttel, "_default", ttel.Telemetry(enabled=True))
    kept = _retained(lambda: comm.all_reduce(buf))
    assert kept >= 2000, kept
    spans = [e for e in ttel._default.tracer.drain()
             if e["name"] == "allreduce"]
    assert len(spans) == 2200 and spans[0]["args"] == {"bytes": 256,
                                                       "kind": "dense"}
