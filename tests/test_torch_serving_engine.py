"""hetu_tpu_torch.serving (kvcache.py, scheduler.py) on the CPU.

The host logic is the reference's, so its invariants are re-checked on
the port: allocator refcounts, prefix-cache keying and LRU, copy-on-write
isolation on torch pools, the bounded dispatch signatures, admission and
preemption. The engine's greedy tokens must equal
``hetu_tpu.serving.ContinuousBatchingEngine``'s on the same numpy
weights, with prefix caching and chunked prefill off and on — exact
token equality; the weights are drawn wide (std 0.5) so no argmax is a
near tie at float32 noise.
"""
import numpy as np
import pytest
import torch

from hetu_tpu.models.gpt import GPTConfig as JConfig
from hetu_tpu.serving import ContinuousBatchingEngine as JEngine
from hetu_tpu_torch.models.gpt import GPTConfig, random_gpt_checkpoint
from hetu_tpu_torch.serving import (BlockAllocator, ContinuousBatchingEngine,
                                    EngineOverloaded, KVCacheExhausted,
                                    PagedKVCache, PrefixCache)
from hetu_tpu_torch.serving.kvcache import gpt_param_bytes, kv_block_bytes

VOCAB, SEQ = 64, 64
KW = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, max_position_embeddings=SEQ)


def _cfg():
    return GPTConfig(**KW, initializer_range=0.5)


@pytest.fixture(scope="module")
def ckpt():
    return random_gpt_checkpoint(_cfg(), seed=7)


def _engine(ckpt, **kw):
    kw.setdefault("block_size", 4)
    kw.setdefault("max_batch_size", 4)
    return ContinuousBatchingEngine(_cfg(), ckpt.__getitem__, device="cpu",
                                    start=False, **kw)


def _drive(engine, futures, limit=800):
    steps = 0
    while any(not f.done() for f in futures):
        engine.step()
        steps += 1
        assert steps < limit, "engine failed to converge"
    return steps


def _serve(engine, trace):
    futs = [engine.submit(p, g) for p, g in trace]
    _drive(engine, futs)
    return [f.result(1).tolist() for f in futs]


def _shared_prompt_trace(seed, n=8):
    rng = np.random.RandomState(seed)
    sys_prompt = rng.randint(0, VOCAB, (12,))
    trace = []
    for k in range(n):
        if k % 3 == 2:
            p = rng.randint(0, VOCAB, (int(rng.randint(4, 16)),))
        else:
            p = np.concatenate(
                [sys_prompt, rng.randint(0, VOCAB, (int(rng.randint(2, 6)),))])
        trace.append((p.astype(np.int32), int(rng.randint(2, 6))))
    return trace


# ---------------------------------------------------------------------------
# allocator, prefix cache, paged cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["stress", "underflow"])
def test_block_allocator(case):
    a = BlockAllocator(8, 4, first_id=1)
    if case == "stress":
        # a shadow refcount model agrees with the allocator after every
        # alloc / share / free; failed allocs take nothing
        rng = np.random.RandomState(0)
        refs = []
        for _ in range(300):
            r = rng.rand()
            if refs and r < 0.35:
                a.free(refs.pop(rng.randint(len(refs))))
            elif refs and r < 0.55:
                blocks = refs[rng.randint(len(refs))]
                a.share(blocks)
                refs.append(list(blocks))
            else:
                n = int(rng.randint(1, 4))
                if n <= a.available:
                    refs.append(a.alloc(n))
                else:
                    used = a.used
                    with pytest.raises(KVCacheExhausted):
                        a.alloc(n)
                    assert a.used == used
            want = {}
            for blocks in refs:
                for b in blocks:
                    want[b] = want.get(b, 0) + 1
            assert want == {b: a.refcount(b) for b in want}
            assert a.available == 8 - len(want)
        for blocks in refs:
            a.free(blocks)
        assert a.alloc(8) == list(range(1, 9))   # deterministic reuse
    else:
        blocks = a.alloc(2)
        a.share(blocks)
        with pytest.raises(ValueError, match="double free"):
            a.free(blocks * 3)
        assert all(a.refcount(b) == 2 for b in blocks)
        assert a.free(blocks) == []
        assert sorted(a.free(blocks)) == sorted(blocks)
        with pytest.raises(ValueError, match="non-live"):
            a.share([blocks[0]])
        assert a.used == 0 and a.available == 8


@pytest.mark.parametrize("case", ["full_and_tail", "position_sensitive",
                                  "lru"])
def test_prefix_cache(case):
    pc = PrefixCache(block_size=4)
    if case == "full_and_tail":
        prompt = np.arange(10, dtype=np.int32)
        assert pc.insert_full(prompt[:4], 7)
        assert pc.insert_full(prompt[:8], 8)
        assert pc.insert_tail(prompt[:8], prompt[8:], 9)
        assert pc.match(prompt) == ([7, 8, 9], 10)
        div = prompt.copy()
        div[5] += 1
        assert pc.match(div) == ([7], 4)
        assert pc.match(prompt[:9]) == ([7, 8], 8)
    elif case == "position_sensitive":
        a = np.array([1, 2, 3, 4, 1, 2, 3, 4], np.int32)
        assert pc.insert_full(a[:4], 5)
        assert pc.insert_full(a[:8], 6)
        assert pc.match(a) == ([5, 6], 8)
        assert pc.match(a[:4])[0] == [5]
    else:
        for i in range(3):
            assert pc.insert_full(np.arange(i * 100, i * 100 + 4), 10 + i)
        for b in (10, 11, 12):
            pc.mark_unreferenced(b)
        pc.mark_referenced(11)
        assert [pc.pop_lru(), pc.pop_lru(), pc.pop_lru()] == [10, 12, None]
        assert pc.cached_blocks == 1


def test_paged_cache_tables_disjoint_and_scratch_reserved():
    cache = PagedKVCache(_cfg(), num_blocks=10, block_size=4, device="cpu")
    assert cache.pools[0]["k"].shape == (11, 4, 4, 8)
    rng = np.random.RandomState(1)
    for sid in range(6):
        cache.add_seq(sid, int(rng.randint(1, 9)))
    flat = [b for t in cache.tables.values() for b in t]
    assert len(flat) == len(set(flat)) and 0 not in flat
    for sid, table in cache.tables.items():
        slots = cache.slot_mapping(sid, 0, cache.capacity_tokens(sid))
        assert set(s // 4 for s in slots) == set(table)
    before = {sid: list(t) for sid, t in cache.tables.items()}
    with pytest.raises(KVCacheExhausted):
        cache.add_seq(99, 40)
    assert {sid: list(t) for sid, t in cache.tables.items()} == before
    for sid in list(cache.tables):
        cache.free_seq(sid)
    assert cache.used_blocks == 0


@pytest.mark.parametrize("budget", [None, "64MiB"])
def test_paged_cache_budget(monkeypatch, budget):
    monkeypatch.delenv("HETU_HBM_BUDGET", raising=False)
    if budget is None:
        with pytest.raises(ValueError, match="num_blocks"):
            PagedKVCache(_cfg(), device="cpu")
        return
    monkeypatch.setenv("HETU_HBM_BUDGET", budget)
    cache = PagedKVCache(_cfg(), block_size=8, device="cpu")
    want = (int((64 << 20) * 0.9) - gpt_param_bytes(_cfg())) \
        // kv_block_bytes(_cfg(), 8)
    assert cache.num_blocks == want
    assert cache.hbm_bytes() + gpt_param_bytes(_cfg()) <= 64 << 20


@pytest.mark.parametrize("case", ["hit_shares", "cow", "cow_exhausted",
                                  "evict"])
def test_paged_cache_prefix_sharing(case):
    nb = {"cow_exhausted": 2, "evict": 4}.get(case, 16)
    cache = PagedKVCache(_cfg(), num_blocks=nb, block_size=4,
                         prefix_cache=True, device="cpu")
    if case == "hit_shares":
        prompt = np.arange(10, dtype=np.int32)
        blocks, cached = cache.add_seq_prefix(0, 10, prompt)
        assert cached == 0 and len(blocks) == 3
        cache.insert_prefix(0, prompt)
        used = cache.used_blocks
        blocks2, cached2 = cache.add_seq_prefix(1, 10, prompt)
        assert cached2 == 9 and blocks2 == blocks
        assert cache.used_blocks == used
        assert cache.allocator.refcount(blocks[0]) == 3
        cache.free_seq(0)
        cache.free_seq(1)
        assert cache.referenced_blocks == 0 and cache.cached_blocks == 3
    elif case == "cow":
        prompt = np.arange(6, dtype=np.int32)
        cache.add_seq_prefix(0, 10, prompt)
        cache.insert_prefix(0, prompt)
        tail = cache.tables[0][1]
        for layer in cache.pools:           # recognisable history rows
            layer["k"][tail] = torch.randn(4, 4, 8)
            layer["v"][tail] = torch.randn(4, 4, 8)
        assert cache.ensure_writable(0, 6, 7) == 1
        fresh = cache.tables[0][1]
        assert fresh != tail and tail in cache.match_prefix(prompt)[0]
        for layer in cache.pools:
            for key in ("k", "v"):
                torch.testing.assert_close(layer[key][fresh],
                                           layer[key][tail], rtol=0, atol=0)
        assert cache.ensure_writable(0, 7, 8) == 0
    elif case == "cow_exhausted":
        prompt = np.arange(6, dtype=np.int32)
        cache.add_seq_prefix(0, 6, prompt)
        cache.insert_prefix(0, prompt)
        tail = cache.tables[0][1]
        assert cache.ensure_writable(0, 6, 7) == 0      # wrote in place
        assert cache.tables[0][1] == tail
        assert cache.allocator.refcount(tail) == 1
        assert tail not in cache.match_prefix(prompt)[0]
    else:
        a = np.arange(8, dtype=np.int32)
        cache.add_seq_prefix(0, 8, a)
        cache.insert_prefix(0, a)
        cache.free_seq(0)
        assert cache.cached_blocks == 2
        cache.add_seq(1, 16)
        assert cache.prefix.evictions == 2
        assert cache.match_prefix(a) == ([], 0)
        cache.free_seq(1)
    cache.assert_consistent()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("features", [
    {}, {"prefix_cache": True, "prefill_chunk": 8}])
def test_engine_greedy_tokens_equal_reference_engine(ckpt, features):
    trace = _shared_prompt_trace(2)
    trace.append((np.arange(40, dtype=np.int32) % VOCAB, 4))  # 5 chunks
    ref = JEngine(JConfig(**KW), ckpt.__getitem__, num_blocks=64,
                  block_size=4, max_batch_size=4, start=False, **features)
    want = _serve(ref, trace)
    ref.close()
    eng = _engine(ckpt, num_blocks=64, **features)
    got = _serve(eng, trace)
    assert got == want
    assert len({tuple(t) for t in got}) > 3, "degenerate outputs"
    assert eng.jit_compiles <= eng.compile_bound
    assert eng.cache.referenced_blocks == 0
    if features:
        # the same host logic on the same trace: the same hits
        assert eng.cache.prefix.hit_rate() == ref.cache.prefix.hit_rate() \
            > 0.2
    eng.cache.assert_consistent()
    eng.close()


def test_engine_dispatch_signatures_bounded_under_churn(ckpt):
    eng = _engine(ckpt, num_blocks=40)
    rng = np.random.RandomState(3)
    trace = [(rng.randint(0, VOCAB, (int(rng.randint(1, 12)),)),
              int(rng.randint(1, 8))) for _ in range(10)]

    def wave():
        futs = []
        for p, g in trace:
            futs.append(eng.submit(p, g))
            eng.step()
        _drive(eng, futs)

    wave()
    warm = eng.jit_compiles
    assert 0 < warm <= eng.compile_bound
    wave()
    assert eng.jit_compiles == warm, "steady state added dispatch shapes"
    eng.close()


@pytest.mark.parametrize("case", ["queue", "reject", "never_fits",
                                  "queue_full"])
def test_engine_admission(ckpt, case):
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, VOCAB, (5,)) for _ in range(6)]
    if case == "queue":
        want = _serve(_engine(ckpt, num_blocks=64), [(p, 4) for p in prompts])
        eng = _engine(ckpt, num_blocks=6)
        assert _serve(eng, [(p, 4) for p in prompts]) == want
    elif case == "reject":
        eng = _engine(ckpt, num_blocks=6, admission="reject")
        futs = [eng.submit(p, 4) for p in prompts]
        _drive(eng, futs)
        shed = [isinstance(f.exception(1), EngineOverloaded) for f in futs]
        assert any(shed) and not all(shed)
    elif case == "never_fits":
        eng = _engine(ckpt, num_blocks=2, max_batch_size=2)
        with pytest.raises(KVCacheExhausted):
            eng.submit(np.zeros(5, np.int32), 10)
    else:
        eng = _engine(ckpt, num_blocks=8, max_batch_size=2, max_queue=1)
        eng.submit(np.zeros(2, np.int32), 2)
        with pytest.raises(EngineOverloaded):
            eng.submit(np.zeros(2, np.int32), 2)
    eng.close()


def test_engine_lazy_reserve_preempts_and_reproduces(ckpt):
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, VOCAB, (5,)) for _ in range(4)]

    def serve(**kw):
        eng = _engine(ckpt, **kw)
        preempts = []
        orig = eng._preempt
        eng._preempt = lambda v: (preempts.append(v.rid), orig(v))
        futs = [eng.submit(p, 6, temperature=0.8, seed=40 + i)
                for i, p in enumerate(prompts)]
        _drive(eng, futs)
        assert eng.cache.used_blocks == 0
        eng.close()
        return [f.result(1).tolist() for f in futs], preempts

    want, _ = serve(num_blocks=40, reserve="full")
    got, preempts = serve(num_blocks=7, reserve="lazy")
    assert got == want
    assert preempts, "7-block lazy pool never preempted"


def test_engine_from_checkpoint_dir(ckpt, tmp_path):
    for name, arr in ckpt.items():
        np.save(tmp_path / f"{name}.npy", arr)
    trace = [(np.arange(9, dtype=np.int32), 3)]
    eng = ContinuousBatchingEngine.from_checkpoint(
        _cfg(), str(tmp_path), device="cpu", num_blocks=16, block_size=4,
        start=False)
    assert _serve(eng, trace) == _serve(_engine(ckpt, num_blocks=16), trace)
    eng.close()


def test_engine_background_thread_and_introspection(ckpt):
    with ContinuousBatchingEngine(_cfg(), ckpt.__getitem__, device="cpu",
                                  num_blocks=32, block_size=4,
                                  max_batch_size=2, prefix_cache=True,
                                  slo_p99_ms=60_000.0) as eng:
        rng = np.random.RandomState(9)
        futs = [eng.submit(rng.randint(0, VOCAB, (int(rng.randint(2, 8)),)),
                           int(rng.randint(1, 5)), request_id=f"q{i}")
                for i in range(6)]
        outs = [f.result(60) for f in futs]
        assert all(o.dtype == np.int32 for o in outs)
        assert eng.health()[0]
        st = eng.stats()
        assert st["kind"] == "ContinuousBatchingEngine"
        assert st["prefix_cache"] is True and "serve_cow_copies" in st
        assert eng.inflight_requests() == []
    with pytest.raises(RuntimeError):
        eng.submit(np.zeros(2, np.int32), 1)
