"""The port's request-level serving frontends on the CPU: MicroBatcher,
ReplicaRouter and ServingHTTPServer, over the port's InferenceSession
and GPTDecoder (tiny widths: vocab 64, hidden 32, 2 layers, 4 heads, 32
positions).

The cases are the reference's (tests/test_serving.py batcher and HTTP
tests, tests/test_paged_serving.py and
tests/test_serving_observability.py router and HTTP tests) with
telemetry off (the enabled cases are
tests/test_torch_serving_observability.py's): the batcher's ``stats()``
carries the tick and row counts. Numerics: session outputs within rtol 1e-5 of the numpy
product; tokens through the stack identical to a direct
``GPTDecoder.generate``.
"""
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest

import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.serving import (EngineOverloaded, GPTDecoder,
                                    InferenceSession, KVCacheExhausted,
                                    MicroBatcher, ReplicaRouter,
                                    RouterOverloaded, ServingHTTPServer,
                                    next_bucket)

VOCAB, SEQ, PROMPT, GEN = 64, 32, 8, 4
# every request goes to the server on 127.0.0.1 itself, never through a
# proxy named in the environment
_open = urllib.request.build_opener(urllib.request.ProxyHandler({})).open


def _linear_session(seed):
    rng = np.random.RandomState(seed)
    w = tht.Variable("w", value=rng.randn(20, 4).astype("f"))
    x = tht.Variable("x", trainable=False)
    sess = InferenceSession([tht.matmul_op(x, w)], device="cpu")
    return sess, sess.params_by_name()["w"].numpy()


@pytest.fixture(scope="module")
def decoder():
    cfg = TM.GPTConfig(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=SEQ,
                       hidden_dropout_prob=0.0, use_flash_attention=True)
    ids = tht.Variable("input_ids", trainable=False)
    sess = InferenceSession([TM.GPTLMHeadModel(cfg)(ids)],
                            seq_buckets=(SEQ,), seed=0, device="cpu")
    return GPTDecoder.from_session(sess, cfg)


def _serve_tick(dec):
    """A tick's serve function as the chip's serve_dense pass runs it:
    the batch padded to its power-of-two bucket, the tick's longest
    ``gen`` generated for every row."""
    def serve(feeds):
        x, gen = feeds["ids"], int(np.max(feeds["gen"]))
        n = len(x)
        x = np.concatenate([x, np.repeat(x[-1:], next_bucket(n) - n, 0)])
        return dec.generate(x, gen)[:n]
    return serve


def _post(port, payload=None, body=None, headers=None, timeout=30):
    data = body if body is not None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    return _open(req, timeout=timeout)


def _get(port, path):
    return json.loads(_open(
        f"http://127.0.0.1:{port}{path}", timeout=10).read())


# ---------------------------------------------------------------------------
# MicroBatcher
# ---------------------------------------------------------------------------

def test_batcher_coalesces_and_splits():
    sess, w = _linear_session(8)
    calls = []

    def serve(feeds):
        calls.append(feeds["x"].shape[0])
        return sess.predict(feeds)

    rows = np.random.RandomState(8).randn(24, 20).astype("f")
    with MicroBatcher(serve, max_batch_size=16, max_wait_ms=25) as mb:
        futs = [mb.submit({"x": rows[i:i + 1]}) for i in range(24)]
        outs = [f.result(30) for f in futs]
        stats = mb.stats()
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o[0], rows[i:i + 1] @ w, rtol=1e-5)
    assert len(calls) < 24, f"no coalescing happened: {calls}"
    assert sum(calls) == 24
    assert stats["kind"] == "MicroBatcher" and stats["waiting"] == 0
    assert stats["ticks"] == len(calls) and stats["rows"] == 24
    assert stats["mean_batch_occupancy"] == pytest.approx(
        24 / (16 * len(calls)))


def test_batcher_survives_malformed_tick():
    def serve(feeds):
        return feeds["x"] * 2.0

    with MicroBatcher(serve, max_batch_size=8, max_wait_ms=30) as mb:
        f1 = mb.submit({"x": np.zeros((1, 4))})
        f2 = mb.submit({"x": np.zeros((1, 5))})   # ragged: concat fails
        excs = 0
        for f in (f1, f2):
            try:
                f.result(30)
            except ValueError:
                excs += 1
        assert excs >= 1
        ok = mb.submit({"x": np.ones((2, 3))}).result(30)
        np.testing.assert_allclose(ok, 2.0)


def test_batcher_propagates_errors_and_rejects_after_close():
    def boom(feeds):
        raise RuntimeError("kaboom")

    mb = MicroBatcher(boom, max_wait_ms=1)
    fut = mb.submit({"x": np.zeros((1, 2))})
    with pytest.raises(RuntimeError, match="kaboom"):
        fut.result(10)
    assert mb.stats()["ticks"] == 0 and \
        mb.stats()["mean_batch_occupancy"] is None
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit({"x": np.zeros((1, 2))})


def test_batcher_splits_oversized_request_into_one_future():
    sess, w = _linear_session(9)
    calls = []

    def serve(feeds):
        calls.append(feeds["x"].shape[0])
        return sess.predict(feeds)

    rows = np.random.RandomState(9).randn(10, 20).astype("f")
    with MicroBatcher(serve, max_batch_size=4, max_wait_ms=5) as mb:
        got = mb.submit({"x": rows}).result(30)[0]
    np.testing.assert_allclose(got, rows @ w, rtol=1e-5, atol=1e-5)
    assert max(calls) <= 4 and sum(calls) == 10
    attempts = []

    def flaky(feeds):
        attempts.append(feeds["x"].shape[0])
        if len(attempts) >= 2:
            raise RuntimeError("chunk 2 kaboom")
        return feeds["x"] * 2.0

    with MicroBatcher(flaky, max_batch_size=4, max_wait_ms=5) as mb:
        with pytest.raises(RuntimeError, match="kaboom"):
            mb.submit({"x": rows}).result(30)


def test_batcher_over_the_decoder_matches_direct_generate(decoder):
    rng = np.random.RandomState(3)
    prompts = rng.randint(0, VOCAB, (5, PROMPT))
    gens = [GEN, GEN - 1, GEN, 2, GEN]
    with MicroBatcher(_serve_tick(decoder), max_batch_size=4,
                      max_wait_ms=20) as mb:
        futs = [mb.submit({"ids": prompts[i:i + 1],
                           "gen": np.asarray([[g]])})
                for i, g in enumerate(gens)]
        outs = [f.result(60)[0] for f in futs]
        assert mb.stats()["rows"] == 5
    want = decoder.generate(prompts, GEN)
    for i, g in enumerate(gens):
        np.testing.assert_array_equal(outs[i][:g], want[i, :g])


# ---------------------------------------------------------------------------
# ReplicaRouter
# ---------------------------------------------------------------------------

class _FakeReplica:
    def __init__(self, fail=False):
        self.fail = fail
        self.calls = 0

    def submit(self, prompt, max_new):
        self.calls += 1
        f = Future()
        if self.fail:
            f.set_exception(RuntimeError("replica down"))
        else:
            f.set_result(np.zeros(max_new, np.int32))
        return f


def test_router_least_inflight_and_load_shedding():
    r1, r2 = _FakeReplica(), _FakeReplica(fail=True)
    router = ReplicaRouter([r1, r2], slo_error_rate=0.2, slo_window=8)
    for _ in range(10):
        try:
            router.submit(np.zeros(2, np.int32), 2).result(1)
        except RuntimeError:
            pass
    before = r2.calls
    for _ in range(6):
        router.submit(np.zeros(2, np.int32), 2).result(1)
    assert r2.calls == before, "router kept routing to a breached replica"
    assert router.health()[0]
    router2 = ReplicaRouter([_FakeReplica(fail=True)],
                            slo_error_rate=0.1, slo_window=4)
    for _ in range(6):
        try:
            router2.submit(np.zeros(2, np.int32), 2).result(1)
        except RuntimeError:
            pass
    with pytest.raises(RouterOverloaded):
        router2.submit(np.zeros(2, np.int32), 2)
    ok, reason = router2.health()
    assert not ok and "error rate" in reason
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaRouter([])


def test_router_prefers_replica_own_health_probe():
    class _Unhealthy(_FakeReplica):
        def health(self):
            return False, "draining"

    good, draining = _FakeReplica(), _Unhealthy()
    router = ReplicaRouter([draining, good])
    for _ in range(4):
        router.submit(np.zeros(2, np.int32), 2).result(1)
    assert draining.calls == 0 and good.calls == 4


def test_router_unions_replica_tables():
    class _Replica:
        def __init__(self, i):
            self.i = i

        def inflight_requests(self):
            return [{"request_id": f"r{self.i}", "phase": "waiting"}]

        def stats(self):
            return {"kind": "stub", "i": self.i}

    router = ReplicaRouter([_Replica(0), _Replica(1)])
    rows = router.inflight_requests()
    assert {(r["request_id"], r["replica"]) for r in rows} == \
        {("r0", 0), ("r1", 1)}
    st = router.stats()
    assert st["kind"] == "ReplicaRouter" and len(st["replicas"]) == 2
    assert st["replicas"][1]["replica"] == {"kind": "stub", "i": 1}
    assert all(e["healthy"] for e in st["replicas"])


# ---------------------------------------------------------------------------
# ServingHTTPServer
# ---------------------------------------------------------------------------

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


def test_http_predict_and_health_over_the_session():
    sess, w = _linear_session(9)
    v = np.random.RandomState(9).randn(3, 20).astype("f")
    with ServingHTTPServer(sess) as srv:
        resp = json.loads(_post(srv.port, {"inputs": {"x": v.tolist()}})
                          .read())
        np.testing.assert_allclose(np.asarray(resp["outputs"][0]), v @ w,
                                   rtol=1e-4)
        assert _get(srv.port, "/healthz") == {"ok": True}
        with pytest.raises(urllib.error.HTTPError) as err:
            _open(f"http://127.0.0.1:{srv.port}/metrics",
                                   timeout=10)
        assert err.value.code == 404        # telemetry disabled
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.port, body=b'{"inputs": [1, 2]}')
        assert err.value.code == 400
    assert srv._thread is None and srv._httpd is None


def test_http_closed_loop_through_router_and_batchers(decoder):
    """4 client threads x 3 requests over HTTP -> router -> two
    batchers -> the decoder: every reply equals a direct generate of
    its prompt, and the router spread the requests over both."""
    rng = np.random.RandomState(10)
    prompts = rng.randint(0, VOCAB, (12, PROMPT))
    want = decoder.generate(prompts, GEN)
    batchers = [MicroBatcher(_serve_tick(decoder), max_batch_size=4,
                             max_wait_ms=5, name=f"b{i}") for i in range(2)]
    router = ReplicaRouter(batchers)
    errors, got = [], {}
    try:
        with ServingHTTPServer(router) as srv:
            def client(k):
                try:
                    for i in range(k * 3, k * 3 + 3):
                        body = json.loads(_post(srv.port, {"inputs": {
                            "ids": prompts[i:i + 1].tolist(),
                            "gen": [[GEN]]}}, timeout=60).read())
                        got[i] = np.asarray(body["outputs"][0])
                except Exception as e:          # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            stats = _get(srv.port, "/stats")
    finally:
        for mb in batchers:
            mb.close()
    assert not errors, errors
    for i in range(12):
        np.testing.assert_array_equal(got[i], want[i:i + 1])
    routed = [r["routed"] for r in stats["backend"]["replicas"]]
    assert sum(routed) == 12 and min(routed) > 0, routed
    assert sum(r["replica"]["rows"] for r in
               stats["backend"]["replicas"]) == 12


def test_http_request_id_honored_and_echoed():
    backend = _OkBackend()
    with ServingHTTPServer(backend) as srv:
        resp = _post(srv.port, {"inputs": {"x": [[1.0]]}},
                     headers={"x-request-id": "client-7"})
        body = json.loads(resp.read())
        assert resp.headers["X-Request-Id"] == "client-7"
        assert body["request_id"] == "client-7"
        assert backend.rids == ["client-7"]
        resp = _post(srv.port, {"inputs": {"x": [[1.0]]}})
        rid = json.loads(resp.read())["request_id"]
        assert rid.startswith("req-")
        assert resp.headers["X-Request-Id"] == rid == backend.rids[-1]


@pytest.mark.parametrize("exc,code,retry_s", [
    (EngineOverloaded("queue full"), 429, 1),
    (RouterOverloaded("fleet breached"), 503, 2),
    (KVCacheExhausted("pool dry"), 503, 2),
])
def test_http_overload_maps_to_structured_backpressure(exc, code, retry_s):
    with ServingHTTPServer(_RaisingBackend(exc), slo_error_rate=0.5) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, {"inputs": {"x": [[1.0]]}},
                  headers={"x-request-id": "shed-1"})
        err = ei.value
        assert err.code == code
        assert err.headers["Retry-After"] == str(retry_s)
        assert err.headers["X-Request-Id"] == "shed-1"
        body = json.loads(err.read())
        assert body["request_id"] == "shed-1"
        assert body["retry_after_ms"] == retry_s * 1000
        assert type(exc).__name__ in body["error"]
        # shed requests count against the error SLO
        assert srv.health()[0] is False


def test_http_model_bugs_still_500_with_rid():
    with ServingHTTPServer(_RaisingBackend(RuntimeError("boom"))) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, {"inputs": {"x": [[1.0]]}})
        assert ei.value.code == 500
        body = json.loads(ei.value.read())
        assert "boom" in body["error"]
        assert body["request_id"].startswith("req-")


def test_http_requests_and_stats_routes():
    class _Introspectable(_OkBackend):
        def inflight_requests(self):
            return [{"request_id": "live-1", "phase": "running"}]

        def stats(self):
            return {"kind": "stub", "running": 1}

    with ServingHTTPServer(_Introspectable(), slo_p99_ms=500.0) as srv:
        doc = _get(srv.port, "/v1/requests")
        assert doc["count"] == 1
        assert doc["requests"][0]["request_id"] == "live-1"
        doc = _get(srv.port, "/stats")
        assert doc["healthy"] is True
        assert doc["slo_p99_ms"] == 500.0
        assert doc["backend"] == {"kind": "stub", "running": 1}
    with ServingHTTPServer(_OkBackend()) as srv:
        with pytest.raises(urllib.error.HTTPError) as err:
            _open(f"http://127.0.0.1:{srv.port}/v1/requests", timeout=10)
        assert err.value.code == 404
