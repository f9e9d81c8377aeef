"""Iteration-level continuous batching over the paged KV cache.

Counterpart of ``hetu_tpu/serving/scheduler.py``. The scheduling is the
reference's host code unchanged; what differs is the dispatch. The
reference runs ``jax.jit`` programs with the pools donated; here the
forward functions run eagerly on the engine's device (``cuda`` by
default) and update the pools in place. The signature accounting stays:
every dispatch still snaps to the same bucket ladders, and
``jit_compiles`` (distinct dispatch shapes seen) stays within
``compile_bound``, which keeps the shape set a later CUDA-graph capture
would need finite. The rest of this docstring is the reference's.

``GPTDecoder.generate`` + ``MicroBatcher`` is *request-level* batching:
a tick's requests fuse into one batch that prefills together, decodes
together, and finishes together — every sequence pays the longest
member's generation length, a late arrival waits for the whole batch,
and each batch allocates dense ``[B, H, S_max, D]`` cache buffers.

:class:`ContinuousBatchingEngine` schedules at *iteration* granularity
instead (Orca, OSDI '22), over the block-paged cache of
``serving/kvcache.py`` (vLLM's PagedAttention, SOSP '23). Every
scheduler step:

1. **finish** — sequences that produced their last token leave the
   batch immediately, resolve their Future, and free their KV blocks;
2. **admit** — waiting requests join while batch width and free KV
   blocks allow. Admission is the only gate on cache memory:
   ``admission="queue"`` (default) holds the FIFO head until blocks
   free up, ``admission="reject"`` fails its Future with
   :class:`EngineOverloaded` instead (load shedding at the engine). A
   request that could NEVER fit the pool raises
   :class:`~hetu_tpu.serving.kvcache.KVCacheExhausted` at submit;
3. **prefill** — newly admitted prompts run one causal forward
   (grouped per prompt bucket) that scatters their K/V rows into the
   pool via ``models/gpt.py:gpt_paged_prefill``;
4. **decode** — ALL running sequences take one token step in ONE jit
   program (``gpt_paged_step``): per-sequence position vectors make
   the batch ragged-safe, block tables make it gather from the pool.

**The HT901 contract is load-bearing here.** Sequences join/leave every
step, so naive shapes would retrace constantly. Instead every dispatch
snaps to precomputed ladders — batch width to the power-of-two ladder
(``session.py:next_bucket``), context length to a block-aligned ladder,
prompt length to the decoder's prompt ladder — so distinct jit
signatures are bounded by :attr:`compile_bound` =
``|batch| x (|prompt| + |ctx|)`` ladder products no matter how churny
the trace (the serving test measures exactly this).

``reserve="full"`` (default) allocates a request's whole
``prompt + max_new_tokens`` block budget at admission — no mid-decode
exhaustion, ever. ``reserve="lazy"`` allocates blocks as positions are
written (higher occupancy) and, on exhaustion, **preempts** the
youngest running sequence: its blocks free, it requeues at the waiting
head, and because sampling is keyed on ``(seed, token_index)`` the
recompute reproduces the exact tokens it lost.

**Prefix caching** (``prefix_cache=True``): admission resolves each
prompt against the pool's :class:`~hetu_tpu.serving.kvcache.PrefixCache`
— the cached prefix's blocks are *shared* (refcount bumped, zero new
blocks, zero prefill compute) and only the non-cached suffix is
allocated, charged, and prefilled (``gpt_paged_suffix_prefill`` starts
at the first non-cached position). Finished prefills publish their
blocks back to the cache; retired requests leave cached blocks resident
for the next hit (LRU-evicted only under allocation pressure). Shared
blocks are copy-on-write: a sequence extending into one (suffix prefill
into a shared tail, or the first decode write past a cache-frozen
prompt tail) copies it first, so sharers never see each other's writes
— with ``reserve="full"`` admission charges those copies up front and
the no-mid-decode-exhaustion guarantee stands; a genuine multi-sharer
shortfall preempts the youngest sequence exactly like lazy exhaustion.

**Chunked prefill** (``prefill_chunk=N``): a prompt longer than ``N``
non-cached tokens prefills one chunk per engine step, interleaved with
the running batch's decode, so one long cold prompt no longer stalls
TPOT for every running sequence. Chunk widths snap to their own pow2
ladder and the suffix-prefill program keys on (batch, chunk, ctx)
buckets, so :attr:`compile_bound` stays a finite ladder product —
HT901 holds with both features on.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..device import resolve_device
from ..models.gpt import (gpt_paged_prefill, gpt_paged_step,
                          gpt_paged_suffix_prefill, gpt_serving_params)
from . import lifecycle as _lifecycle
from .kvcache import DEFAULT_BLOCK_SIZE, KVCacheExhausted, PagedKVCache
from .lifecycle import RequestTimeline, mint_request_id
from .router import SLOWindow
from .session import next_bucket

__all__ = ["ContinuousBatchingEngine", "EngineOverloaded"]


class EngineOverloaded(RuntimeError):
    """Admission control shed this request: the waiting queue is full,
    or ``admission="reject"`` and the KV pool can't hold it right now."""


def _pow2_ladder(start, cap):
    """Power-of-two ladder from ``start`` capped (and terminated) at
    ``cap`` — the finite bucket set one dispatch dimension snaps to."""
    ladder, b = [], max(1, int(start))
    while b < cap:
        ladder.append(b)
        b *= 2
    ladder.append(int(cap))
    return tuple(ladder)


def _choose_token(logits_row, temperature, seed, idx):
    """Greedy or temperature sampling, host-side. Randomness is keyed
    on ``(seed, token_index)`` — NOT on any global stream — so a
    preempted sequence's recompute reproduces the tokens it already
    produced."""
    if temperature and temperature > 0.0:
        z = logits_row.astype(np.float64) / float(temperature)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(idx)])
        return int(rng.choice(len(p), p=p))
    return int(np.argmax(logits_row))


class _Seq:
    __slots__ = ("id", "prompt", "max_new", "temperature", "seed",
                 "future", "generated", "pending", "n_written",
                 "t_submit", "preempts", "rid", "tl", "tokens_lost",
                 "cached_tokens", "prefill_pos")

    def __init__(self, sid, prompt, max_new, temperature, seed, rid,
                 tl):
        self.id = sid
        self.prompt = prompt
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.future = Future()
        self.generated = []     # chosen tokens, pending included
        self.pending = None     # chosen but not yet written to the cache
        self.n_written = 0      # cache rows written (prompt + decode)
        self.t_submit = time.perf_counter()
        self.preempts = 0
        self.rid = rid          # request id (caller-supplied or minted)
        self.tl = tl            # RequestTimeline, None when tel disabled
        # tokens the last preemption threw away; while
        # len(generated) <= tokens_lost the sequence is re-earning them
        # (its episodes are "replay", and live introspection says so)
        self.tokens_lost = 0
        # prompt tokens the prefix cache resolved at admission (their
        # K/V was already resident — never recomputed)
        self.cached_tokens = 0
        # next prompt position to prefill; < len(prompt) means the
        # sequence is still in (possibly chunked) prefill
        self.prefill_pos = 0

    def prefilling(self):
        return self.prefill_pos < self.prompt.shape[0]

    def replaying(self):
        return self.tokens_lost > 0 and \
            len(self.generated) <= self.tokens_lost


class ContinuousBatchingEngine:
    """See the module docstring. ``lookup(name) -> array`` resolves
    checkpoint parameter names (``models/gpt.py:gpt_param_names``);
    ``from_checkpoint`` reads an ``Executor.save`` directory of the
    reference. Parameters and pools live on ``device`` (``cuda`` by
    default; ``"cpu"`` runs the plain PyTorch paths).

    With ``start=True`` (default) a daemon scheduler thread drives
    :meth:`step` whenever work exists; with ``start=False`` the caller
    drives ``step()`` directly (deterministic tests) — never both.

    ``submit()`` returns a Future resolving to the generated tokens as
    a 1-D int32 array of length ``max_new_tokens``."""

    def __init__(self, config, lookup, *, num_blocks=None,
                 block_size=DEFAULT_BLOCK_SIZE, budget=None, max_len=None,
                 max_batch_size=8, admission="queue", max_queue=256,
                 reserve="full", prefix_cache=False, prefill_chunk=None,
                 slo_p99_ms=None, slo_error_rate=None,
                 slo_window=128, slo_ttft_p99_ms=None, telemetry=None,
                 name="engine", start=True, device=None):
        if admission not in ("queue", "reject"):
            raise ValueError(f"admission must be 'queue' or 'reject', "
                             f"got {admission!r}")
        if reserve not in ("full", "lazy"):
            raise ValueError(f"reserve must be 'full' or 'lazy', "
                             f"got {reserve!r}")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.config = config
        self.max_len = int(max_len or config.max_position_embeddings)
        if self.max_len > config.max_position_embeddings:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's learned "
                f"positions ({config.max_position_embeddings})")
        self.max_batch_size = int(max_batch_size)
        self.admission = admission
        self.max_queue = int(max_queue)
        self.reserve = reserve
        self.name = name
        self.telemetry = _telemetry.resolve(telemetry)
        self.slo = SLOWindow(slo_p99_ms, slo_error_rate, slo_window,
                             ttft_p99_ms=slo_ttft_p99_ms)
        self.prefix_cache = bool(prefix_cache)
        self.prefill_chunk = int(prefill_chunk) \
            if prefill_chunk is not None else None
        # prefix hits and chunking both mean "prefill from a token
        # offset into an existing table" — one suffix-prefill program
        # serves both, so either knob switches prefill onto it
        self._suffix_mode = self.prefix_cache \
            or self.prefill_chunk is not None
        self.device = resolve_device(device)
        self.params = gpt_serving_params(config, lookup, self.device)
        self.cache = PagedKVCache(config, num_blocks=num_blocks,
                                  block_size=block_size, budget=budget,
                                  telemetry=self.telemetry,
                                  prefix_cache=self.prefix_cache,
                                  device=self.device)
        # HT901 ladders: every dispatch dimension snaps to one of these,
        # so signatures stay bounded under per-step churn
        self.batch_buckets = _pow2_ladder(1, self.max_batch_size)
        self.prompt_buckets = _pow2_ladder(1, self.max_len)
        self.ctx_buckets = _pow2_ladder(self.cache.block_size,
                                        self.max_len)
        self.chunk_buckets = _pow2_ladder(
            1, min(self.prefill_chunk or self.max_len, self.max_len))
        nh = config.num_attention_heads
        act = getattr(config, "hidden_act", "gelu")
        self._prefill_fn = functools.partial(
            gpt_paged_prefill, num_heads=nh, hidden_act=act)
        self._step_fn = functools.partial(
            gpt_paged_step, num_heads=nh, hidden_act=act)
        self._sprefill_fn = functools.partial(
            gpt_paged_suffix_prefill, num_heads=nh, hidden_act=act)
        self._signatures = set()
        self._ids = itertools.count()
        self._waiting = collections.deque()
        self._running = []
        self._cond = threading.Condition()
        self._closed = False
        self._thread = None
        _lifecycle.register(self)   # crash-time in-flight dumps
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=f"{name}-scheduler")
            self._thread.start()

    # ------------------------------------------------------------------
    @classmethod
    def from_session(cls, session, config, **kw):
        """From a live :class:`~hetu_tpu_torch.serving.InferenceSession`
        over the same model: shares the session's device-resident
        parameter tensors (on the session's device unless ``device``
        says otherwise)."""
        kw.setdefault("device", session.device)
        return cls(config, session.params_by_name().__getitem__, **kw)

    @classmethod
    def from_checkpoint(cls, config, path, **kw):
        """From an ``Executor.save`` checkpoint directory."""
        def lookup(name):
            f = os.path.join(path, name + ".npy")
            if not os.path.exists(f):
                raise FileNotFoundError(
                    f"checkpoint {path} has no parameter {name!r} "
                    f"(expected {f})")
            return np.load(f)
        return cls(config, lookup, **kw)

    # ------------------------------------------------------------------
    @property
    def compile_bound(self):
        """The HT901 ladder-product bound on distinct jit signatures:
        prefill keys on (batch, prompt) buckets, decode on (batch, ctx)
        buckets, suffix prefill (prefix cache / chunked prefill) on
        (batch, chunk, ctx) buckets — churn can never compile more
        programs than this."""
        bound = len(self.batch_buckets) * (len(self.prompt_buckets)
                                           + len(self.ctx_buckets))
        if self._suffix_mode:
            bound += (len(self.batch_buckets) * len(self.chunk_buckets)
                      * len(self.ctx_buckets))
        return bound

    @property
    def jit_compiles(self):
        """Distinct jit signatures dispatched so far (always <=
        :attr:`compile_bound`; the serving test asserts it)."""
        return len(self._signatures)

    def health(self):
        """(healthy, reason) under the configured SLOs — the same probe
        contract as ``ServingHTTPServer.health`` / ``/healthz``, so the
        replica router treats engines and HTTP replicas uniformly."""
        return self.slo.health()

    def inflight_requests(self):
        """Live in-flight table (``GET /v1/requests`` and the
        crash-dump ``requests_rank<r>.json``): one row per waiting or
        running request — id, phase (waiting / preempted / running /
        replay), tokens done vs budget, KV blocks held, preemption
        count, age. Works with telemetry disabled."""
        now = time.perf_counter()
        with self._cond:
            snap = [(s, "waiting" if s.preempts == 0 else "preempted")
                    for s in self._waiting]
            snap += [(s, "replay" if s.replaying() else "running")
                     for s in self._running]
        tables = self.cache.tables
        return [{"request_id": s.rid,
                 "phase": phase,
                 "tokens_done": len(s.generated),
                 "tokens_budget": s.max_new,
                 "kv_blocks": len(tables.get(s.id, ())),
                 "cached_tokens": s.cached_tokens,
                 "preempts": s.preempts,
                 "age_ms": round((now - s.t_submit) * 1e3, 3)}
                for s, phase in snap]

    def stats(self):
        """One engine snapshot for ``GET /stats``: queue depths, KV
        pressure, HT901 compile accounting, SLO verdict."""
        with self._cond:
            running, waiting = len(self._running), len(self._waiting)
        healthy, reason = self.health()
        out = {"name": self.name,
               "kind": "ContinuousBatchingEngine",
               "running": running,
               "waiting": waiting,
               "max_batch_size": self.max_batch_size,
               "admission": self.admission,
               "reserve": self.reserve,
               "kv_blocks": self.cache.num_blocks,
               "kv_blocks_used": self.cache.used_blocks,
               "kv_hbm_utilization": round(self.cache.utilization, 4),
               "jit_compiles": self.jit_compiles,
               "compile_bound": self.compile_bound,
               "healthy": healthy,
               "health_reason": reason}
        out["prefix_cache"] = self.prefix_cache
        out["prefill_chunk"] = self.prefill_chunk
        if self.prefix_cache:
            # utilization above counts only sequence-referenced blocks;
            # the cached-unreferenced remainder is reclaimable HBM
            out["kv_blocks_cached"] = self.cache.cached_blocks
            out["kv_hbm_utilization_cached"] = round(
                self.cache.cached_utilization, 4)
            out["serve_prefix_hit_rate"] = round(
                self.cache.prefix.hit_rate(), 4)
            out["serve_cow_copies"] = self.cache.cow_copies
            out["serve_prefix_evictions"] = self.cache.prefix.evictions
        return out

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens, temperature=0.0, seed=0,
               request_id=None):
        """Enqueue one request; returns a Future resolving to the
        generated tokens (1-D int32, length ``max_new_tokens``).

        ``request_id`` is the end-to-end tracing id (minted here when
        the caller — HTTP ingress, router — didn't supply one); every
        lifecycle span, in-flight table row, and flight-ring event for
        this request carries it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = prompt.shape[0]
        if p < 1:
            raise ValueError("submit() needs at least one prompt token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if p + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt {p} + {max_new_tokens} new tokens exceeds the "
                f"engine's max_len {self.max_len}")
        if not self.cache.fits_at_all(p + int(max_new_tokens)):
            # no amount of queueing serves this: the pool is too small
            raise KVCacheExhausted(
                f"request of {p}+{max_new_tokens} tokens needs "
                f"{self.cache.allocator.blocks_for_tokens(p + int(max_new_tokens))} "
                f"blocks; the pool has {self.cache.num_blocks}")
        tel = self.telemetry
        rid = str(request_id) if request_id is not None \
            else mint_request_id()
        tl = RequestTimeline(rid, time.perf_counter_ns()) \
            if tel.enabled else None
        seq = _Seq(next(self._ids), prompt, max_new_tokens, temperature,
                   seed, rid, tl)
        if tel.enabled:
            tel.flight_record("serve", "submit", tag=rid)
        with self._cond:
            if self._closed:
                raise RuntimeError("engine closed")
            if len(self._waiting) >= self.max_queue:
                raise EngineOverloaded(
                    f"waiting queue full ({self.max_queue} requests)")
            self._waiting.append(seq)
            self._set_depth_locked()
            self._cond.notify()
        return seq.future

    def _set_depth_locked(self):
        if self.telemetry.enabled:
            self.telemetry.set_gauge(f"{self.name}_queue_depth",
                                     len(self._waiting))

    # ------------------------------------------------------------------
    def step(self):
        """One scheduler iteration (admit -> prefill -> decode ->
        finish); returns the number of sequences still running."""
        tel = self.telemetry
        t0 = time.perf_counter()
        with self._cond:
            admitted = self._admit_locked()
        if not admitted and not self._running:
            return 0
        width = len(self._running)
        cm = tel.span("step", subgraph="serving_engine") \
            if tel.enabled else contextlib.nullcontext()
        with cm:
            if self._suffix_mode:
                # chunked/prefix prefill: EVERY still-prefilling
                # sequence (not just this step's admissions) computes
                # one chunk, then the running batch decodes — long cold
                # prompts interleave with decode instead of stalling it
                prefilling = [s for s in self._running if s.prefilling()]
                if prefilling:
                    self._prefill_suffix_step(prefilling)
            elif admitted:
                self._prefill_admitted(admitted)
            self._finish_done()
            if self._running:
                self._decode_once()
                self._finish_done()
        if tel.enabled:
            tel.observe(f"{self.name}_step_ms",
                        (time.perf_counter() - t0) * 1e3)
            tel.observe(f"{self.name}_batch_width", width)
        return len(self._running)

    def _can_admit_locked(self, seq, reserve_tokens):
        """Block check for one admission. Without a prefix cache this is
        plain free-list arithmetic; with one, the request is charged
        only its non-cached remainder plus the copy-on-write spares its
        writes into shared blocks will need, against free + evictable
        blocks (matched blocks excluded — sharing them un-LRUs them
        before any eviction could touch them)."""
        if not self.prefix_cache:
            return self.cache.can_admit(reserve_tokens)
        need = self.cache.admit_blocks_needed(seq.prompt, reserve_tokens)
        matched, _ = self.cache.match_prefix(seq.prompt)
        evictable = max(0, self.cache.cached_blocks - len(matched))
        return need <= self.cache.allocator.available + evictable

    def _admit_locked(self):
        admitted = []
        while self._waiting and \
                len(self._running) + len(admitted) < self.max_batch_size:
            seq = self._waiting[0]
            p = seq.prompt.shape[0]
            reserve_tokens = p + (seq.max_new
                                  if self.reserve == "full" else 0)
            if not self._can_admit_locked(seq, reserve_tokens):
                if self.admission == "reject":
                    self._waiting.popleft()
                    seq.future.set_exception(EngineOverloaded(
                        f"KV admission rejected request: "
                        f"{self.cache.allocator.blocks_for_tokens(reserve_tokens)} "
                        f"block(s) needed, "
                        f"{self.cache.allocator.available} free"))
                    continue
                # queue policy: the FIFO head waits for blocks — later
                # arrivals never jump it (no starvation)
                break
            self._waiting.popleft()
            if self.prefix_cache:
                _, cached = self.cache.add_seq_prefix(
                    seq.id, reserve_tokens, seq.prompt)
                seq.cached_tokens = cached
                seq.prefill_pos = cached
                seq.n_written = cached   # cached rows are resident
                if cached and self.telemetry.enabled:
                    self.telemetry.inc(
                        f"{self.name}_prefill_cached_tokens", cached)
            else:
                self.cache.add_seq(seq.id, reserve_tokens)
                seq.cached_tokens = 0
                seq.prefill_pos = 0
            admitted.append(seq)
        self._set_depth_locked()
        self._running.extend(admitted)
        if admitted and self.telemetry.enabled:
            # close each admitted sequence's waiting episode: queue on
            # first admission, replay-wait after a preemption bounce
            now = time.perf_counter_ns()
            for s in admitted:
                if s.tl is not None:
                    s.tl.note("queue" if s.preempts == 0 else "replay",
                              s.tl.t_wait_start, now)
                    self.telemetry.flight_record("serve", "admit",
                                                 tag=s.rid)
        return admitted

    # ------------------------------------------------------------------
    def _dev(self, arr):
        """Host int32 index array -> int64 tensor on the engine's
        device."""
        return torch.as_tensor(np.asarray(arr, np.int64), device=self.device)

    def _dispatch(self, key, fn, *args):
        """Run one forward, accounting dispatch signatures the way the
        reference accounts jit compiles (HT901's runtime half): first
        sighting of a signature key incs ``jit_compiles`` under a
        ``jit_compile`` span, steady-state dispatches ride
        ``device_dispatch``."""
        tel = self.telemetry
        if key not in self._signatures:
            self._signatures.add(key)
            if tel.enabled:
                with tel.span("jit_compile", subgraph="serving_engine",
                              shape_key=str(key)):
                    out = fn(*args)
                tel.inc("jit_compiles")
                return out
            return fn(*args)
        if tel.enabled:
            with tel.span("device_dispatch", subgraph="serving_engine"):
                return fn(*args)
        return fn(*args)

    def _prefill_admitted(self, admitted):
        tel = self.telemetry
        groups = {}
        for s in admitted:
            pb = next_bucket(s.prompt.shape[0], self.prompt_buckets)
            groups.setdefault(pb, []).append(s)
        for pb, group in sorted(groups.items()):
            bb = next_bucket(len(group), self.batch_buckets)
            ids = np.zeros((bb, pb), np.int32)
            slots = np.zeros((bb, pb), np.int32)   # 0 = scratch block
            for i, s in enumerate(group):
                p = s.prompt.shape[0]
                ids[i, :p] = s.prompt
                ids[i, p:] = s.prompt[-1]   # edge pad stays in-vocab
                slots[i, :p] = self.cache.slot_mapping(s.id, 0, p)
            t0 = time.perf_counter_ns() if tel.enabled else 0
            logits, pools = self._dispatch(
                ("prefill", bb, pb), self._prefill_fn, self.params,
                self.cache.pools, self._dev(ids), self._dev(slots))
            self.cache.pools = pools
            last = logits[list(range(len(group))),
                          [s.prompt.shape[0] - 1 for s in group]] \
                .cpu().numpy()
            # episode ends AFTER the host sync above — the wall between
            # t0 and t1 is the prefill compute each member rode
            t1 = time.perf_counter_ns() if tel.enabled else 0
            for i, s in enumerate(group):
                p = s.prompt.shape[0]
                tok = _choose_token(last[i], s.temperature, s.seed, 0)
                s.generated.append(tok)
                s.pending = tok
                s.n_written = p
                s.prefill_pos = p
                if s.tl is not None:
                    s.tl.note("replay" if s.replaying() else "prefill",
                              t0, t1, {"cached_tokens": 0,
                                       "computed_tokens": p})
                    if s.tl.t_first_token is None:
                        s.tl.t_first_token = t1     # TTFT point
            if tel.enabled:
                real = sum(s.prompt.shape[0] for s in group)
                tel.inc(f"{self.name}_prefill_tokens", real)
                tel.inc(f"{self.name}_prefill_pad_tokens",
                        bb * pb - real)
                tel.inc(f"{self.name}_tokens", len(group))

    def _cow_or_preempt(self, s, start, stop):
        """Copy-on-write the blocks positions ``[start, stop)`` touch
        before ``s`` writes them, preempting the youngest running
        sequence when the copy can't be allocated (same victim policy
        as lazy-reserve exhaustion; the victim replays exactly).
        Returns False when ``s`` itself was the last resort victim."""
        while True:
            try:
                self.cache.ensure_writable(s.id, start, stop)
                return True
            except KVCacheExhausted:
                victim = self._running[-1]
                self._preempt(victim)
                if victim is s:
                    return False

    def _prefill_suffix_step(self, prefilling):
        """One chunk of prompt prefill per still-prefilling sequence:
        the prefix-cache/chunked path (``gpt_paged_suffix_prefill``).
        Each sequence computes ``min(prefill_chunk, remaining)`` tokens
        from its ``prefill_pos`` — the first non-cached position on a
        fresh admission — grouped per chunk bucket; the final chunk
        samples token 0 and publishes the prompt's blocks to the prefix
        cache."""
        tel = self.telemetry
        chunk = self.prefill_chunk or self.max_len
        groups = {}
        for s in prefilling:
            if s not in self._running:
                continue        # preempted by an earlier group's CoW
            w = min(chunk, s.prompt.shape[0] - s.prefill_pos)
            # shared blocks this chunk writes into copy FIRST, so the
            # write slots below point at private storage
            if not self._cow_or_preempt(s, s.prefill_pos,
                                        s.prefill_pos + w):
                continue
            cw = next_bucket(w, self.chunk_buckets)
            groups.setdefault(cw, []).append((s, w))
        for cw, group in sorted(groups.items()):
            group = [(s, w) for s, w in group if s in self._running]
            if not group:
                continue
            bb = next_bucket(len(group), self.batch_buckets)
            sb = next_bucket(max(s.prefill_pos + w for s, w in group),
                             self.ctx_buckets)
            ids = np.zeros((bb, cw), np.int32)
            starts = np.zeros(bb, np.int32)
            write_slots = np.zeros((bb, cw), np.int32)  # 0 = scratch
            slot_grid = np.zeros((bb, sb), np.int32)
            slot_grid[:len(group)] = self.cache.gather_slots(
                [s.id for s, _ in group], sb)
            for i, (s, w) in enumerate(group):
                pos = s.prefill_pos
                ids[i, :w] = s.prompt[pos:pos + w]
                ids[i, w:] = s.prompt[pos + w - 1]   # edge pad in-vocab
                starts[i] = pos
                write_slots[i, :w] = self.cache.slot_mapping(
                    s.id, pos, pos + w)
            t0 = time.perf_counter_ns() if tel.enabled else 0
            logits, pools = self._dispatch(
                ("sprefill", bb, cw, sb), self._sprefill_fn,
                self.params, self.cache.pools, self._dev(ids),
                self._dev(starts), self._dev(slot_grid),
                self._dev(write_slots))
            self.cache.pools = pools
            finishing = [(i, s, w) for i, (s, w) in enumerate(group)
                         if s.prefill_pos + w >= s.prompt.shape[0]]
            last = logits[[i for i, _, _ in finishing],
                          [w - 1 for _, _, w in finishing]].cpu().numpy() \
                if finishing else None
            t1 = time.perf_counter_ns() if tel.enabled else 0
            for j, (i, s, w) in enumerate(finishing):
                tok = _choose_token(last[j], s.temperature, s.seed, 0)
                s.generated.append(tok)
                s.pending = tok
            cached_resolved = 0
            for i, (s, w) in enumerate(group):
                first_chunk = s.prefill_pos == s.cached_tokens
                if first_chunk:
                    cached_resolved += s.cached_tokens
                s.prefill_pos += w
                s.n_written = s.prefill_pos
                if s.tl is not None:
                    s.tl.note(
                        "replay" if s.replaying() else "prefill", t0, t1,
                        {"cached_tokens": s.cached_tokens
                         if first_chunk else 0, "computed_tokens": w})
                if not s.prefilling():
                    # prompt fully resident: publish it for later hits
                    # (the cache freezes these blocks; the first decode
                    # write past the tail copy-on-writes)
                    self.cache.insert_prefix(s.id, s.prompt)
                    if s.tl is not None and s.tl.t_first_token is None:
                        s.tl.t_first_token = t1     # TTFT point
            if tel.enabled:
                computed = sum(w for _, w in group)
                tel.complete("serve_prefill_chunk", t0, t1,
                             {"seqs": len(group),
                              "tokens": int(computed),
                              "bucket": int(cw),
                              "cached": int(cached_resolved)})
                tel.inc(f"{self.name}_prefill_tokens", computed)
                tel.inc(f"{self.name}_prefill_pad_tokens",
                        bb * cw - computed)
                tel.inc(f"{self.name}_tokens", len(finishing))

    def _ensure_capacity_lazy(self, active):
        """Lazy-reserve growth: make every active sequence's table
        cover its write position, preempting the youngest running
        sequence on exhaustion. Returns the surviving active list."""
        for s in list(active):
            if s not in self._running:
                continue            # already preempted as a victim
            while s.n_written + 1 > self.cache.capacity_tokens(s.id):
                try:
                    self.cache.extend_seq(s.id, s.n_written + 1)
                except KVCacheExhausted:
                    victim = self._running[-1]
                    self._preempt(victim)
                    if victim is s:
                        break
        return [s for s in active if s in self._running]

    def _preempt(self, victim):
        """Free a sequence's blocks and requeue it at the waiting head;
        recompute reproduces its tokens ((seed, index)-keyed
        sampling)."""
        self.cache.free_seq(victim.id)
        lost = len(victim.generated)
        victim.tokens_lost = lost
        victim.generated = []
        victim.pending = None
        victim.n_written = 0
        victim.prefill_pos = 0
        victim.cached_tokens = 0
        victim.preempts += 1
        with self._cond:
            self._running.remove(victim)
            self._waiting.appendleft(victim)
            self._set_depth_locked()
        if self.telemetry.enabled:
            self.telemetry.inc(f"{self.name}_preemptions")
            self.telemetry.instant("serve_preempt",
                                   request_id=victim.rid, tokens=lost)
            self.telemetry.flight_record("serve", "preempt",
                                         tag=victim.rid)
            if victim.tl is not None:
                # the replay-wait episode starts now and closes at
                # re-admission (_admit_locked)
                victim.tl.t_wait_start = time.perf_counter_ns()

    def _decode_once(self):
        active = [s for s in self._running
                  if len(s.generated) < s.max_new
                  and not s.prefilling()]
        if self.reserve == "lazy":
            active = self._ensure_capacity_lazy(active)
        if self.prefix_cache:
            # the first write past a cached/frozen prompt tail lands in
            # a shared block — copy it before computing write slots
            # (reserve="full" admission pre-charged this block)
            for s in list(active):
                if s in self._running:
                    self._cow_or_preempt(s, s.n_written, s.n_written + 1)
            active = [s for s in active if s in self._running]
        if not active:
            return
        bb = next_bucket(len(active), self.batch_buckets)
        cb = next_bucket(max(s.n_written for s in active) + 1,
                         self.ctx_buckets)
        tokens = np.zeros(bb, np.int32)
        positions = np.zeros(bb, np.int32)
        write_slots = np.zeros(bb, np.int32)       # 0 = scratch block
        slot_grid = np.zeros((bb, cb), np.int32)
        slot_grid[:len(active)] = self.cache.gather_slots(
            [s.id for s in active], cb)
        for i, s in enumerate(active):
            tokens[i] = s.pending
            positions[i] = s.n_written
            write_slots[i] = self.cache.slot_of(s.id, s.n_written)
        tel = self.telemetry
        t0 = time.perf_counter_ns() if tel.enabled else 0
        logits, pools = self._dispatch(
            ("decode", bb, cb), self._step_fn, self.params,
            self.cache.pools, self._dev(tokens),
            self._dev(positions), self._dev(slot_grid),
            self._dev(write_slots))
        self.cache.pools = pools
        last = logits[:len(active)].cpu().numpy()
        t1 = time.perf_counter_ns() if tel.enabled else 0
        for i, s in enumerate(active):
            s.n_written += 1
            tok = _choose_token(last[i], s.temperature, s.seed,
                                len(s.generated))
            s.generated.append(tok)
            s.pending = tok
            if s.tl is not None:
                # a preempted sequence re-earning lost tokens is in
                # "replay", not "decode" — the doctor's replay bucket
                s.tl.note("replay" if s.replaying() else "decode",
                          t0, t1)
        if tel.enabled:
            tel.inc(f"{self.name}_tokens", len(active))

    def _finish_done(self):
        tel = self.telemetry
        with self._cond:
            done = [s for s in self._running
                    if len(s.generated) >= s.max_new]
            for s in done:
                self._running.remove(s)
        for s in done:
            self.cache.free_seq(s.id)
            ms = (time.perf_counter() - s.t_submit) * 1e3
            ttft_ms = None
            if s.tl is not None:
                t_retire = time.perf_counter_ns()
                _lifecycle.emit_request(tel, s.tl, t_retire,
                                        len(s.generated), s.preempts)
                tel.flight_record("serve", "retire", tag=s.rid)
                if s.tl.t_first_token is not None:
                    ttft_ms = (s.tl.t_first_token - s.tl.t_submit) / 1e6
                    tel.observe("serve_ttft_ms", ttft_ms)
                    tel.observe(
                        "serve_tpot_ms",
                        (t_retire - s.tl.t_first_token) / 1e6
                        / max(1, len(s.generated) - 1))
                tel.observe("serve_queue_wait_ms",
                            sum(t1 - t0
                                for ph, t0, t1, _ in s.tl.episodes
                                if ph == "queue") / 1e6)
                tel.observe("serve_preempts", s.preempts)
            self.slo.note(True, ms, ttft_ms=ttft_ms)
            if tel.enabled:
                tel.observe(f"{self.name}_latency_ms", ms)
                tel.inc(f"{self.name}_requests")
            s.future.set_result(
                np.asarray(s.generated[:s.max_new], np.int32))

    # ------------------------------------------------------------------
    def _loop(self):
        try:
            while True:
                with self._cond:
                    while not self._closed and not self._waiting \
                            and not self._running:
                        self._cond.wait()
                    if self._closed and not self._waiting \
                            and not self._running:
                        return
                    if self._closed:
                        break       # drain what's in flight, then fail
                self.step()
        except BaseException as e:  # noqa: BLE001 — scheduler died
            self._fail_outstanding(
                RuntimeError(f"engine scheduler died: {e!r}"))
            raise
        # closed with work outstanding: fail it rather than hang callers
        self._fail_outstanding(RuntimeError("engine closed"))

    def _fail_outstanding(self, exc):
        with self._cond:
            self._closed = True
            leftovers = list(self._waiting) + list(self._running)
            self._waiting.clear()
            self._running.clear()
            self._cond.notify_all()
        for s in leftovers:
            self.cache.free_seq(s.id)
            if not s.future.done():
                s.future.set_exception(exc)

    def close(self):
        """Stop the scheduler; outstanding Futures fail with
        "engine closed". Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._fail_outstanding(RuntimeError("engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
