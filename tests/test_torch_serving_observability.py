"""Request-level serving observability with the port's telemetry enabled
(hetu_tpu_torch/serving + telemetry) against the JAX package's
(tests/test_serving_observability.py), each engine case on the same tiny
GPT and seed in both packages: minted request ids and the serving
histograms, preemption episodes, the in-flight tables and ``stats()``,
the router's union, the batcher's queue wait, the TTFT SLO window, the
HTTP id echo and overload mapping, ``/v1/requests``, ``/stats`` and
``/metrics``, the flushed in-flight table, the disabled engine's zero
allocations, and each retired request's timeline conserved end to end
by the serving doctor (``telemetry/doctor.py``)."""
import gc
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest

import hetu_tpu.serving as jserving
import hetu_tpu.telemetry as jtel
from hetu_tpu.models.gpt import GPTConfig as JConfig
from hetu_tpu_torch import telemetry as ttel
from hetu_tpu_torch.models.gpt import GPTConfig, random_gpt_checkpoint
from hetu_tpu_torch.serving import (ContinuousBatchingEngine,
                                    EngineOverloaded, KVCacheExhausted,
                                    MicroBatcher, ReplicaRouter,
                                    RouterOverloaded, ServingHTTPServer,
                                    SLOWindow, lifecycle)

VOCAB, SEQ = 64, 32
KW = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, max_position_embeddings=SEQ)
SERVE_HISTS = ("serve_ttft_ms", "serve_tpot_ms", "serve_queue_wait_ms",
               "serve_preempts")


@pytest.fixture(autouse=True)
def _reset_global_telemetry():
    yield
    ttel._default = None
    jtel._default = None


@pytest.fixture(scope="module")
def ckpt():
    return random_gpt_checkpoint(GPTConfig(**KW, initializer_range=0.5),
                                 seed=3)


def _engines(ckpt, tel=True, **kw):
    """(port engine, JAX engine) over the same weights, each with an
    enabled Telemetry of its package when ``tel``."""
    kw = dict(dict(num_blocks=30, block_size=4, max_batch_size=4), **kw)
    port = ContinuousBatchingEngine(
        GPTConfig(**KW), ckpt.__getitem__, device="cpu", start=False,
        telemetry=ttel.Telemetry(enabled=True) if tel else None, **kw)
    ref = jserving.ContinuousBatchingEngine(
        JConfig(**KW), ckpt.__getitem__, start=False,
        telemetry=jtel.Telemetry(enabled=True) if tel else None, **kw)
    return port, ref


def _drive(engine, futures, limit=800):
    steps = 0
    while any(not f.done() for f in futures):
        engine.step()
        steps += 1
        assert steps < limit, "engine failed to converge"
    return steps


def _spans(tel, name):
    return [e for e in tel.tracer.drain() if e["name"] == name]


# ---------------------------------------------------------------------------
# timelines on a live engine
# ---------------------------------------------------------------------------

def test_request_timelines_conserve_end_to_end(ckpt):
    """Every retired request carries a complete timeline whose
    queue / prefill / decode / replay / overhead buckets sum to its
    measured e2e (the doctor's check, and within 6% or 0.5 ms request by
    request, the reference test's bound), in both packages' engines on
    the same requests; the ingress ids survive to the attribution, and
    the same buckets hold time in both."""
    from hetu_tpu.telemetry.doctor import attribute_request_events as jattr
    from hetu_tpu_torch.telemetry.doctor import attribute_request_events
    diags = []
    for eng, attr in zip(_engines(ckpt), (attribute_request_events,
                                          jattr)):
        rng = np.random.RandomState(1)
        futs = [eng.submit(rng.randint(0, VOCAB,
                                       (int(rng.randint(2, 10)),)),
                           int(g), request_id=f"obs-{i}")
                for i, g in enumerate(rng.randint(1, 7, 6))]
        _drive(eng, futs)
        eng.close()
        diag = attr(eng.telemetry.tracer.drain())
        assert diag["requests"] == 6
        assert diag["conserved"], f"violations: {diag['violations']}"
        assert diag["complete"], f"incomplete: {diag['incomplete']}"
        assert {r["request_id"] for r in diag["slowest_requests"]} <= \
            {f"obs-{i}" for i in range(6)}
        for r in diag["slowest_requests"]:
            assert r["ttft_ms"] is not None and r["ttft_ms"] >= 0
            assert all(v >= 0 for v in r["buckets_ms"].values())
            assert sum(r["buckets_ms"].values()) == pytest.approx(
                r["e2e_ms"], rel=0.06, abs=0.5)
        assert diag["serve_ttft_p99_ms"] > 0
        assert diag["top_bucket"]["remedy"]
        diags.append(diag)
    assert {b for b, v in diags[0]["buckets_ms"].items() if v > 0} == \
        {b for b, v in diags[1]["buckets_ms"].items() if v > 0}


def test_minted_ids_and_histograms(ckpt):
    """submit() without a request id mints one; each retired request is
    one ``serve_request`` span and one observation of each serving
    histogram; the tokens are the reference engine's."""
    out = []
    for eng in _engines(ckpt):
        futs = [eng.submit(np.arange(3) + i, 3) for i in range(3)]
        _drive(eng, futs)
        eng.close()
        tel = eng.telemetry
        spans = _spans(tel, "serve_request")
        assert len(spans) == 3
        assert all(e["args"]["request_id"].startswith("req-")
                   for e in spans)
        snap = {s["name"]: s for s in tel.metrics.snapshot()}
        out.append(([f.result(1).tolist() for f in futs],
                    {h: snap[h]["count"] for h in SERVE_HISTS},
                    sorted({e["name"] for e in tel.tracer.drain()
                            if e["ph"] != "M"})))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1] == {h: 3 for h in SERVE_HISTS}
    assert {"serve_request", "serve_phase"} <= set(out[0][2])
    assert set(out[0][2]) <= set(out[1][2]) | {"serve_prefill_chunk"}


def test_preemption_becomes_replay_episodes(ckpt):
    """A lazy-reserve pool too small for everyone: preemptions counted,
    a ``serve_preempt`` instant each, and the preempted request's
    timeline carries ``replay`` episodes; every request's timeline is
    complete (queue, prefill, then decode or replay)."""
    counts = []
    for eng in _engines(ckpt, num_blocks=7, reserve="lazy"):
        rng = np.random.RandomState(7)
        futs = [eng.submit(rng.randint(0, VOCAB, (5,)), 6)
                for _ in range(4)]
        _drive(eng, futs)
        eng.close()
        tel = eng.telemetry
        events = tel.tracer.drain()
        preempts = tel.counter_value("engine_preemptions")
        assert preempts > 0, "the 7-block pool never preempted"
        assert sum(e["name"] == "serve_preempt" for e in events) == preempts
        phases = {}
        for e in events:
            if e["name"] == "serve_phase":
                phases.setdefault(e["args"]["request_id"], []).append(
                    e["args"]["phase"])
        assert len(phases) == 4
        for seq in phases.values():
            assert seq[0] == "queue" and "prefill" in seq
        assert any("replay" in seq for seq in phases.values())
        counts.append((preempts, [f.result(1).tolist() for f in futs]))
    assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# live introspection
# ---------------------------------------------------------------------------

def test_engine_inflight_table_and_stats(ckpt):
    tables = []
    for eng in _engines(ckpt, tel=False):
        fut = eng.submit(np.arange(4), 3, request_id="intro-1")
        (row,) = eng.inflight_requests()
        assert row["request_id"] == "intro-1" and row["phase"] == "waiting"
        assert row["tokens_done"] == 0 and row["tokens_budget"] == 3
        assert row["kv_blocks"] == 0 and row["preempts"] == 0
        assert row["age_ms"] >= 0
        eng.step()
        (run,) = eng.inflight_requests()
        assert run["phase"] == "running" and run["kv_blocks"] > 0
        _drive(eng, [fut])
        assert eng.inflight_requests() == []
        st = eng.stats()
        assert st["kind"] == "ContinuousBatchingEngine"
        assert st["running"] == 0 and st["waiting"] == 0
        assert st["kv_blocks"] == 30 and st["kv_blocks_used"] == 0
        assert st["jit_compiles"] <= st["compile_bound"]
        assert st["healthy"] is True
        eng.close()
        tables.append((sorted(row), sorted(run), sorted(st)))
    assert tables[0] == tables[1]


class _Replica:
    def __init__(self, i):
        self.i = i

    def inflight_requests(self):
        return [{"request_id": f"r{self.i}", "phase": "waiting"}]

    def stats(self):
        return {"kind": "stub", "i": self.i}


def test_router_unions_replica_tables():
    got = []
    for cls in (ReplicaRouter, jserving.ReplicaRouter):
        router = cls([_Replica(0), _Replica(1)])
        rows = router.inflight_requests()
        assert {(r["request_id"], r["replica"]) for r in rows} == \
            {("r0", 0), ("r1", 1)}
        st = router.stats()
        assert st["kind"] == "ReplicaRouter" and len(st["replicas"]) == 2
        assert st["replicas"][1]["replica"] == {"kind": "stub", "i": 1}
        assert all(e["healthy"] for e in st["replicas"])
        got.append((rows, [sorted(e) for e in st["replicas"]]))
    assert got[0] == got[1]


def test_batcher_inflight_and_queue_wait_histogram():
    tel = ttel.Telemetry(enabled=True)
    release = threading.Event()

    def serve(feeds):
        release.wait(5)
        return [feeds["x"] * 2]

    with MicroBatcher(serve, max_batch_size=4, max_wait_ms=1,
                      telemetry=tel) as mb:
        fut = mb.submit({"x": np.ones((1, 2), "f")}, request_id="batch-1")
        deadline = time.time() + 5
        while not mb.inflight_requests() and time.time() < deadline:
            time.sleep(0.005)
        rows = mb.inflight_requests()
        if rows:            # the tick may have claimed it already
            assert rows[0]["request_id"] == "batch-1"
            assert rows[0]["phase"] == "waiting"
        st = mb.stats()
        assert st["kind"] == "MicroBatcher" and st["max_batch_size"] == 4
        release.set()
        np.testing.assert_array_equal(fut.result(5)[0], np.full((1, 2), 2.))
    snap = {s["name"]: s for s in tel.metrics.snapshot()}
    assert snap["serve_queue_wait_ms"]["count"] >= 1
    assert snap["serve_requests"]["value"] == 1


# ---------------------------------------------------------------------------
# TTFT-aware SLO window
# ---------------------------------------------------------------------------

def test_slo_window_ttft_breach():
    for cls in (SLOWindow, jserving.SLOWindow):
        slo = cls(p99_ms=1000.0, ttft_p99_ms=50.0)
        for _ in range(40):
            slo.note(True, 200.0, ttft_ms=180.0)
        healthy, reason = slo.health()
        assert not healthy and "serve_ttft_ms" in reason
        slo2 = cls(p99_ms=1000.0, ttft_p99_ms=50.0)
        for _ in range(40):
            slo2.note(True, 200.0)
        assert slo2.health()[0]


def test_engine_accepts_ttft_slo(ckpt):
    """Every request meets the e2e SLO, yet ``health()`` flips on the
    TTFT one (the timelines feed the window with telemetry on)."""
    for eng in _engines(ckpt, slo_p99_ms=1e9, slo_ttft_p99_ms=0.0001):
        futs = [eng.submit(np.arange(4) + i, 2) for i in range(3)]
        _drive(eng, futs)
        healthy, reason = eng.health()
        assert not healthy and "serve_ttft_ms" in reason
        eng.close()


# ---------------------------------------------------------------------------
# HTTP ingress
# ---------------------------------------------------------------------------

def _post(port, body=b'{"inputs": {"x": [[1.0]]}}', headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=5)


class _OkBackend:
    def __init__(self):
        self.rids = []

    def submit(self, feeds, request_id=None):
        self.rids.append(request_id)
        fut = Future()
        fut.set_result([np.asarray([[42.0]])])
        return fut


class _RaisingBackend:
    def __init__(self, exc):
        self.exc = exc

    def submit(self, feeds, request_id=None):
        raise self.exc


def test_http_request_id_honored_and_echoed():
    backend = _OkBackend()
    with ServingHTTPServer(backend) as srv:
        resp = _post(srv.port, headers={"x-request-id": "client-7"})
        body = json.loads(resp.read())
        assert resp.headers["X-Request-Id"] == "client-7"
        assert body["request_id"] == "client-7"
        assert backend.rids == ["client-7"]
        resp = _post(srv.port)
        rid = json.loads(resp.read())["request_id"]
        assert rid.startswith("req-")
        assert resp.headers["X-Request-Id"] == rid
        assert backend.rids[-1] == rid


@pytest.mark.parametrize("exc,code,retry_s", [
    (EngineOverloaded("queue full"), 429, 1),
    (RouterOverloaded("fleet breached"), 503, 2),
    (KVCacheExhausted("pool dry"), 503, 2),
])
def test_http_overload_maps_to_structured_backpressure(exc, code, retry_s):
    tel = ttel.Telemetry(enabled=True)
    with ServingHTTPServer(_RaisingBackend(exc), telemetry=tel) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, headers={"x-request-id": "shed-1"})
        err = ei.value
        assert err.code == code
        assert err.headers["Retry-After"] == str(retry_s)
        assert err.headers["X-Request-Id"] == "shed-1"
        body = json.loads(err.read())
        assert body["request_id"] == "shed-1"
        assert body["retry_after_ms"] == retry_s * 1000
        assert type(exc).__name__ in body["error"]
    assert tel.counter_value("http_shed_requests") == 1


def test_http_model_bugs_still_500_with_rid():
    with ServingHTTPServer(_RaisingBackend(RuntimeError("boom"))) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port)
        assert ei.value.code == 500
        body = json.loads(ei.value.read())
        assert "boom" in body["error"]
        assert body["request_id"].startswith("req-")


def test_http_requests_stats_and_metrics_routes():
    """``/v1/requests`` and ``/stats`` answer from the backend;
    ``/metrics`` is the Prometheus text of an enabled telemetry (the
    HTTP frontend's own histograms among it) and 404 with it off."""
    class _Introspectable(_OkBackend):
        def inflight_requests(self):
            return [{"request_id": "live-1", "phase": "running"}]

        def stats(self):
            return {"kind": "stub", "running": 1}

    tel = ttel.Telemetry(enabled=True)
    with ServingHTTPServer(_Introspectable(), slo_p99_ms=500.0,
                           telemetry=tel) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        doc = json.loads(urllib.request.urlopen(f"{base}/v1/requests",
                                                timeout=5).read())
        assert doc["count"] == 1
        assert doc["requests"][0]["request_id"] == "live-1"
        doc = json.loads(urllib.request.urlopen(f"{base}/stats",
                                                timeout=5).read())
        assert doc["healthy"] is True and doc["slo_p99_ms"] == 500.0
        assert doc["backend"] == {"kind": "stub", "running": 1}
        _post(srv.port).read()
        resp = urllib.request.urlopen(f"{base}/metrics", timeout=5)
        assert resp.status == 200
        text = resp.read().decode()
        assert "# TYPE http_request_ms summary" in text, text
    ttel._default = None    # the enabled instance became the default
    with ServingHTTPServer(_OkBackend()) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        for route in ("/v1/requests", "/metrics"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + route, timeout=5)
            assert ei.value.code == 404


def test_flush_writes_the_inflight_requests(ckpt, tmp_path):
    """``Telemetry.flush`` writes ``requests_rank<r>.json`` beside the
    trace: the engine's in-flight requests, as the reference's."""
    tel = ttel.Telemetry(enabled=True, out_dir=str(tmp_path), rank=0)
    eng = ContinuousBatchingEngine(
        GPTConfig(**KW), ckpt.__getitem__, device="cpu", start=False,
        num_blocks=30, block_size=4, max_batch_size=4, telemetry=tel)
    eng.submit(np.arange(4), 3, request_id="stuck-1")
    eng.step()
    paths = tel.flush()
    req = tmp_path / "requests_rank0.json"
    assert str(req) in paths and (tmp_path / "trace_rank0.json").exists()
    doc = json.loads(req.read_text())
    rows = [r for comp in doc["components"] for r in comp["requests"]]
    assert [r["request_id"] for r in rows] == ["stuck-1"]
    assert rows[0]["phase"] == "running"
    eng.close()
    assert sys.modules.get("hetu_tpu_torch.serving.lifecycle") is lifecycle


# ---------------------------------------------------------------------------
# the disabled path
# ---------------------------------------------------------------------------

def test_disabled_engine_allocates_no_timelines(ckpt):
    eng, ref = _engines(ckpt, tel=False)
    ref.close()
    assert not eng.telemetry.enabled
    fut = eng.submit(np.arange(4), 2)
    assert eng._waiting[0].tl is None       # no timeline object built
    assert eng._waiting[0].rid              # the id still exists
    _drive(eng, [fut])
    for _ in range(5200):
        eng.step()
    gc.collect()
    gc.disable()
    try:
        before = sys.getallocatedblocks()
        for _ in range(5000):
            eng.step()
        after = sys.getallocatedblocks()
    finally:
        gc.enable()
    assert after - before <= 8, \
        f"disabled idle step leaked {after - before} blocks over 5000"
    eng.close()
