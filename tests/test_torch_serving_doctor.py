"""The port's serving doctor (``hetu_tpu_torch/telemetry/doctor.py
--serving``) against the JAX package's (tests/test_serving_doctor.py):
per-request attribution into queue / prefill / decode / replay /
overhead with its conservation check, TTFT at the last prefill chunk,
the cached/computed prefill split, the fleet summary and its rendering,
on the same synthetic spans in both packages — exactly, as it is the
same arithmetic. Then the same engine case through both packages'
engines: the retired requests, their completeness and conservation, and
which buckets hold time; the CLI's exit codes; and the CLI with ``import
torch`` failing.

Twins elsewhere: the span schema and ``check`` (test_torch_telemetry.py),
the flushed in-flight tables and the black box's serving section
(test_torch_serving_observability.py, test_torch_blackbox_core.py),
``regress``'s serving directions (test_torch_health.py)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import hetu_tpu.serving as jserving
import hetu_tpu.telemetry as jtel
from hetu_tpu.models.gpt import GPTConfig as JConfig
from hetu_tpu.telemetry import doctor as jdoctor
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.models.gpt import GPTConfig, random_gpt_checkpoint
from hetu_tpu_torch.serving import ContinuousBatchingEngine
from hetu_tpu_torch.telemetry import doctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ = 64, 32
KW = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, max_position_embeddings=SEQ)


@pytest.fixture(autouse=True)
def _reset_global_telemetry():
    yield
    ttel._default = None
    jtel._default = None


def _span(name, ts, dur, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur,
            "pid": 0, "tid": 1, "args": args}


def _request(rid, episodes, t0, e2e, tokens, preempts=0):
    """serve_phase spans for (phase, start, end[, args]) and the
    retiring serve_request span."""
    evs = [_span("serve_phase", e[1], e[2] - e[1], request_id=rid,
                 phase=e[0], **(e[3] if len(e) > 3 else {}))
           for e in episodes]
    if e2e is not None:
        evs.append(_span("serve_request", t0, e2e, request_id=rid,
                         phase="retired", tokens=tokens,
                         preempts=preempts))
    return evs


CASES = {
    "exact": _request("synth-1", [
        ("queue", 1000, 3000), ("prefill", 3000, 5000),
        ("decode", 5000, 6000), ("decode", 6500, 7500),
        ("decode", 8000, 9000)], 1000, 10000, 5),
    "replay": _request("synth-p", [
        ("queue", 0, 1000), ("prefill", 1000, 2000), ("decode", 2000, 3000),
        ("replay", 3000, 7000), ("decode", 7000, 8000)], 0, 9000, 4,
        preempts=1),
    "chunked_prefill": _request("synth-chunk", [
        ("queue", 0, 1000), ("prefill", 1000, 2000), ("prefill", 2500, 3500),
        ("prefill", 4000, 6000), ("decode", 6000, 7000),
        ("decode", 7000, 8000)], 0, 9000, 3),
    "cached_vs_computed": _request("r-cold", [
        ("queue", 0, 500),
        ("prefill", 500, 1500, {"cached_tokens": 0,
                                "computed_tokens": 20}),
        ("decode", 1500, 2000)], 0, 2500, 2) + _request("r-hot", [
            ("queue", 0, 500),
            ("prefill", 500, 1500, {"cached_tokens": 16,
                                    "computed_tokens": 4}),
            ("decode", 1500, 2000)], 0, 2500, 2),
    "overclaim": _request("synth-bad", [
        ("queue", 0, 4000), ("prefill", 4000, 9000),
        ("decode", 9000, 15000)], 0, 10000, 3),
    "out_of_window": _request("synth-oow", [
        ("queue", 5000, 6000), ("prefill", 6000, 7000),
        ("decode", 1000, 2000)], 5000, 5000, 2),
    "incomplete": _request("synth-inc", [
        ("prefill", 0, 2000), ("decode", 2000, 3000)], 0, 4000, 2),
    "in_flight": _request("still-going", [("queue", 0, 1000)], 0, None, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_request_attribution_equals_the_reference(case):
    """Each request's buckets, TTFT, TPOT and verdicts, the summary and
    its text: exactly the reference's on the same spans, and the
    reference tests' expectations on each case."""
    evs = CASES[case]
    port = doctor.parse_request_events(evs)
    assert port == jdoctor.parse_request_events(evs)
    diag = doctor.attribute_request_events(evs)
    assert diag == jdoctor.attribute_request_events(evs)
    if diag["requests"]:
        assert doctor.render_serving_text(diag) == \
            jdoctor.render_serving_text(diag)
    by_id = {r["request_id"]: r for r in port}
    if case == "exact":
        r = by_id["synth-1"]
        assert r["buckets_ms"] == {"queue": 2.0, "prefill": 2.0,
                                   "decode": 3.0, "replay": 0.0,
                                   "overhead": 3.0}
        assert (r["ttft_ms"], r["tpot_ms"]) == (4.0, 1.5)
        assert "[OK]" in doctor.render_serving_text(diag)
    elif case == "replay":
        assert diag["preempted_requests"] == 1
        assert diag["buckets_ms"]["replay"] == 4.0
    elif case == "chunked_prefill":
        assert by_id["synth-chunk"]["ttft_ms"] == 6.0
    elif case == "cached_vs_computed":
        assert diag["prefill_cached_tokens"] == 16
        assert diag["prefill_computed_tokens"] == 24
    elif case in ("overclaim", "out_of_window"):
        assert not diag["conserved"]
        assert "FAILED" in doctor.render_serving_text(diag)
    elif case == "incomplete":
        assert diag["conserved"] and not diag["complete"]
    else:
        assert diag["requests"] == 0 and "error" in diag
    if diag["requests"] and diag["conserved"]:
        for r in port:
            assert sum(r["buckets_ms"].values()) == pytest.approx(
                r["e2e_ms"], abs=1e-9)


def test_serving_remedies_name_the_ports_knobs():
    for knob in ("prefix_cache", "prefill_chunk"):
        assert knob in doctor._SERVE_REMEDY["prefill"]
    assert doctor.SERVE_BUCKETS == jdoctor.SERVE_BUCKETS


@pytest.fixture(scope="module")
def ckpt():
    return random_gpt_checkpoint(GPTConfig(**KW, initializer_range=0.5),
                                 seed=3)


def _engine_diags(ckpt, out_dir):
    """The same lazy-reserve engine case (a pool too small for all four
    requests, so some are preempted and replay) through both packages'
    engines: (port diag, JAX diag, port telemetry)."""
    kw = dict(num_blocks=7, block_size=4, max_batch_size=4, reserve="lazy")
    tels = (ttel.Telemetry(enabled=True, out_dir=str(out_dir), rank=0),
            jtel.Telemetry(enabled=True))
    port = ContinuousBatchingEngine(GPTConfig(**KW), ckpt.__getitem__,
                                    device="cpu", start=False,
                                    telemetry=tels[0], **kw)
    ref = jserving.ContinuousBatchingEngine(JConfig(**KW), ckpt.__getitem__,
                                            start=False, telemetry=tels[1],
                                            **kw)
    diags = []
    for eng, tel, mod in ((port, tels[0], doctor), (ref, tels[1], jdoctor)):
        rng = np.random.RandomState(7)
        futs = [eng.submit(rng.randint(0, VOCAB, (5,)), 6,
                           request_id=f"sd-{i}") for i in range(4)]
        steps = 0
        while any(not f.done() for f in futs):
            eng.step()
            steps += 1
            assert steps < 800
        eng.close()
        events = tel.tracer.drain()
        diags.append(mod.attribute_request_events(events))
    return diags[0], diags[1], tels[0]


def test_engine_requests_conserve_as_the_reference(ckpt, tmp_path):
    """Both engines retire the same four requests, each timeline complete
    and conserved (buckets sum to its e2e within the doctor's 5%
    tolerance), with as many preempted, and the same buckets holding
    time (the times themselves are each machine's); the port's flushed
    trace gives the CLI the same summary."""
    port, ref, tel = _engine_diags(ckpt, tmp_path)
    for diag in (port, ref):
        assert diag["requests"] == 4
        assert diag["conserved"] and diag["complete"], diag
    assert sorted(r["request_id"] for r in port["slowest_requests"]) == \
        sorted(r["request_id"] for r in ref["slowest_requests"])
    assert port["preempted_requests"] == ref["preempted_requests"] > 0
    assert {b for b, v in port["buckets_ms"].items() if v > 0} == \
        {b for b, v in ref["buckets_ms"].items() if v > 0}
    for r in port["slowest_requests"]:
        assert sum(r["buckets_ms"].values()) == pytest.approx(
            r["e2e_ms"], rel=0.05, abs=0.5)
    # the engine's spans were drained above; a fresh case fills the file
    tel2 = ttel.Telemetry(enabled=True, out_dir=str(tmp_path / "cli"),
                          rank=0)
    eng = ContinuousBatchingEngine(GPTConfig(**KW), ckpt.__getitem__,
                                   device="cpu", start=False,
                                   telemetry=tel2, num_blocks=30,
                                   block_size=4, max_batch_size=4)
    futs = [eng.submit(np.arange(4) + i, 3) for i in range(3)]
    while any(not f.done() for f in futs):
        eng.step()
    eng.close()
    tel2.flush()
    assert doctor.main(["--serving", str(tmp_path / "cli"), "--json"]) == 0


def test_serving_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "trace_rank0.json").write_text(json.dumps(
        {"traceEvents": CASES["overclaim"]}))
    assert doctor.main(["--serving", str(bad)]) == 1
    assert "FAILED" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "trace_rank0.json").write_text(json.dumps({"traceEvents": []}))
    assert doctor.main(["--serving", str(empty)]) == 1
    assert doctor.main(["--serving", str(tmp_path / "nope")]) == 2


def test_serving_cli_runs_without_torch(tmp_path):
    """``python -m hetu_tpu_torch.telemetry.doctor --serving`` with
    ``import torch`` failing: the package's ``__init__`` skips its API
    for the telemetry tools."""
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
    (tdir / "trace_rank0.json").write_text(json.dumps(
        {"traceEvents": CASES["exact"] + CASES["replay"]}))
    env = {**os.environ, "HOME": str(tmp_path),
           "PYTHONPATH": os.pathsep.join(
               [str(site), REPO, os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.telemetry.doctor",
         "--serving", str(tdir), "--json"], env=env, capture_output=True,
        text=True, timeout=60, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    diag = json.loads(proc.stdout)
    assert diag["requests"] == 2 and diag["conserved"]
    assert diag == jdoctor.attribute_requests_dir(str(tdir))
