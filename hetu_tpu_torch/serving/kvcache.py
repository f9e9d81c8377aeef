"""Paged KV cache: fixed-size block pools + a block allocator.

Counterpart of ``hetu_tpu/serving/kvcache.py``: the host-side
bookkeeping (allocator, prefix cache, tables, slot math) is the
reference's code unchanged; the pools are torch tensors on the engine's
device, updated in place (copy-on-write is an in-place block copy), and
the budget falls back to ``torch.cuda.mem_get_info`` instead of the
TPU's ``bytes_limit``.

The dense decode path (``serving/decode.py``) preallocates one
``[B, H, S_max, D]`` K/V pair per layer per batch — every sequence pays
for ``S_max`` positions whether it uses 8 or 800, and a new batch means
a new allocation. This module is the vLLM/PagedAttention shape instead:

* **one pooled buffer per layer** — ``[num_blocks, block_size, H, D]``
  for K and V, allocated once and shared by every sequence the engine
  ever serves;
* **per-sequence block tables** — a sequence owns an ordered list of
  block ids; token position ``j`` lives in flat pool slot
  ``table[j // block_size] * block_size + j % block_size``. Sequences
  are contiguous *logically*, scattered *physically*;
* **a refcounted free-list allocator** with deterministic exhaustion
  behavior: ``alloc`` is all-or-nothing and raises
  :class:`KVCacheExhausted` (never partially allocates, never corrupts
  a neighbor's blocks); ``share`` bumps a live block's refcount so
  several sequences (or the prefix cache) can reference one physical
  block; ``free`` decrements and a block rejoins the free list only at
  refcount 0 — underflow / double-free of a shared block raises.
* **a prefix cache** (:class:`PrefixCache`): full prompt blocks key by
  a rolling hash of the token prefix, so a repeated system prompt
  resolves to the already-resident blocks — zero prefill compute, zero
  new blocks — and admission charges only the non-cached suffix.
  Blocks whose last sequence retired stay cached (refcount 1, held by
  the cache) on an LRU list and are evicted only under allocation
  pressure, never eagerly.
* **copy-on-write**: a sequence about to write into a block someone
  else also references (another sequence, or the cache's frozen tail
  entry) copies it first (:meth:`PagedKVCache.ensure_writable`), so
  shared partial tails are read-shared and write-private.

**Physical block 0 is the scratch block.** Padded batch lanes (the
bucketing that keeps jit signatures bounded) write their garbage K/V
rows to slot ``0..block_size-1`` and gather from them behind a length
mask; the allocator never hands block 0 to a real sequence, so padding
can never corrupt live cache rows.

With ``num_blocks=None`` the pool sizes itself against the resolved
device-memory budget (explicit argument > ``HETU_HBM_BUDGET`` > the
CUDA device's total memory from ``torch.cuda.mem_get_info``) minus the
model's parameter bytes and a headroom fraction. On the CPU with no
budget resolvable, pass ``num_blocks`` explicitly.
"""
from __future__ import annotations

import collections
import hashlib
import math
import os
import re

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["KVCacheExhausted", "BlockAllocator", "PagedKVCache",
           "PrefixCache", "kv_block_bytes", "gpt_param_bytes",
           "blocks_for_budget", "DEFAULT_BLOCK_SIZE"]

DEFAULT_BLOCK_SIZE = 16

# fraction of the resolved budget kept free for activations and
# temporaries when auto-sizing the pool
_BUDGET_HEADROOM = 0.10

_UNITS = {"": 1, "k": 2 ** 10, "m": 2 ** 20, "g": 2 ** 30, "t": 2 ** 40}


def _parse_bytes(value):
    """'8G' / '512MiB' / '1073741824' -> bytes (int)."""
    if isinstance(value, (int, float)):
        return int(value)
    m = re.fullmatch(r"\s*([0-9]*\.?[0-9]+)\s*([kKmMgGtT]?)i?[bB]?\s*",
                     str(value))
    if not m:
        raise ValueError(f"unparseable byte size {value!r}")
    return int(float(m.group(1)) * _UNITS[m.group(2).lower()])


def _resolve_budget(budget, device):
    """Explicit budget > HETU_HBM_BUDGET > the CUDA device's total
    memory > None (CPU)."""
    if budget is not None:
        return _parse_bytes(budget)
    env = os.environ.get("HETU_HBM_BUDGET")
    if env:
        return _parse_bytes(env)
    if device is not None and device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return None


class KVCacheExhausted(RuntimeError):
    """Raised by :meth:`BlockAllocator.alloc` when the free list cannot
    cover a request. All-or-nothing: no blocks were allocated. The
    engine's admission plane turns this into queueing/rejection; seeing
    it escape means a caller bypassed admission control."""


def kv_block_bytes(config, block_size, dtype_bytes=4):
    """HBM bytes one cache block costs across ALL layers (K + V)."""
    return (2 * config.num_hidden_layers * int(block_size)
            * config.hidden_size * dtype_bytes)


def gpt_param_bytes(config, dtype_bytes=4):
    """Parameter bytes of a ``GPTLMHeadModel`` with this config (the
    serving-params pytree ``models/gpt.py:gpt_serving_params`` builds)
    — what the pool sizing subtracts from the HBM budget."""
    h = config.hidden_size
    i = config.intermediate_size
    per_layer = (2 * h                      # ln1
                 + h * 3 * h + 3 * h        # qkv
                 + h * h + h                # attn proj
                 + 2 * h                    # ln2
                 + h * i + i                # mlp fc
                 + i * h + h)               # mlp proj
    total = (config.vocab_size * h          # wte
             + config.max_position_embeddings * h   # wpe
             + config.num_hidden_layers * per_layer
             + 2 * h                        # ln_f
             + h * config.vocab_size)       # lm_head
    return total * dtype_bytes


def blocks_for_budget(config, block_size=DEFAULT_BLOCK_SIZE, budget=None,
                      headroom=_BUDGET_HEADROOM, device=None):
    """KV blocks the resolved budget affords after the model's
    parameters and a headroom fraction. Returns ``None`` when no budget
    resolves (CPU without ``HETU_HBM_BUDGET``); raises when a budget
    resolves but can't fit even two blocks."""
    budget = _resolve_budget(budget, device)
    if budget is None:
        return None
    avail = int(budget * (1.0 - headroom)) - gpt_param_bytes(config)
    nb = avail // kv_block_bytes(config, block_size)
    if nb < 2:
        raise ValueError(
            f"device-memory budget of {budget} bytes leaves room for {nb} "
            f"KV block(s) after {gpt_param_bytes(config)} bytes of "
            f"parameters — the model doesn't fit a paged cache here")
    return int(nb)


class BlockAllocator:
    """Refcounted free-list over ``num_blocks`` usable block ids.

    ``alloc(n)`` is all-or-nothing (raises :class:`KVCacheExhausted`
    listing need vs. free, allocating nothing) and hands blocks out at
    refcount 1. ``share(blocks)`` bumps a live block's refcount — how
    the prefix cache and prefix-hit sequences reference one physical
    block. ``free(blocks)`` decrements; a block rejoins the free list
    only when its refcount reaches 0, and freeing a dead block (or
    decrementing past zero) raises ``ValueError`` without mutating
    anything. Blocks hand out lowest-id-first and freed blocks rejoin
    in sorted order, so identical alloc/share/free traces produce
    identical tables — exhaustion and reuse are deterministic, not
    load-dependent."""

    def __init__(self, num_blocks, block_size, first_id=0):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._first = int(first_id)
        self._free = collections.deque(
            range(self._first, self._first + self.num_blocks))
        self._ref = {}          # block id -> refcount (live blocks only)

    @property
    def available(self):
        return len(self._free)

    @property
    def used(self):
        return len(self._ref)

    def refcount(self, block):
        """Live refcount of one block (0 when free/unknown)."""
        return self._ref.get(block, 0)

    def blocks_for_tokens(self, ntokens):
        return max(1, math.ceil(int(ntokens) / self.block_size))

    def alloc(self, n):
        n = int(n)
        if n > len(self._free):
            raise KVCacheExhausted(
                f"KV cache exhausted: need {n} block(s), "
                f"{len(self._free)} free of {self.num_blocks}")
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def share(self, blocks):
        """Add one reference to each (live) block — all-or-nothing:
        sharing a free/unknown block raises without mutating."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"share of non-live KV block {b}")
        for b in blocks:
            self._ref[b] += 1

    def free(self, blocks):
        """Drop one reference per listed block; blocks reaching
        refcount 0 rejoin the free list. Validated before any mutation:
        releasing more references than a block holds (double free /
        refcount underflow) raises ``ValueError`` and nothing changes.
        Returns the blocks that actually went free."""
        need = collections.Counter(blocks)
        for b, n in need.items():
            have = self._ref.get(b, 0)
            if n > have:
                raise ValueError(
                    f"double free of KV block {b}: releasing {n} "
                    f"reference(s) but it holds {have}")
        released = []
        for b, n in need.items():
            left = self._ref[b] - n
            if left == 0:
                del self._ref[b]
                released.append(b)
            else:
                self._ref[b] = left
        if released:
            # sorted re-insertion keeps reuse deterministic regardless
            # of the order sequences finished in
            self._free = collections.deque(
                sorted(list(self._free) + released))
        return released


def _chain_key(prev, tokens):
    """One rolling-hash step: digest of (previous chain key, this
    block's token ids). Position sensitivity is free — a chunk's key
    encodes every token before it, so identical token blocks at
    different offsets never collide."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


class PrefixCache:
    """Token-chunk -> resident-block map for prompt prefix sharing.

    Two entry kinds, both keyed off the rolling hash chain:

    * **full-block entries** — chain key of blocks ``0..i`` -> the
      physical block holding positions ``i*bs..(i+1)*bs-1``. Inserted
      when a prompt's full blocks finish prefilling; immutable by
      construction (a sequence never rewrites a filled position).
    * **tail entries** — ``(chain key, tail token tuple)`` -> the block
      holding the prompt's trailing partial block. A later prompt whose
      next tokens start with the stored tail shares the block for those
      rows; the block is frozen the moment it's inserted — ANY sequence
      extending into it (the inserter included) copies first
      (:meth:`PagedKVCache.ensure_writable`), which is the whole
      copy-on-write story.

    The cache holds one allocator reference per cached block (bumped by
    :class:`PagedKVCache` at insert), so a cached block whose sequences
    all retired survives at refcount 1 on the LRU list — eviction
    happens under allocation pressure (:meth:`PagedKVCache`'s
    ``_evict_for``), never eagerly. This class is pure host-side
    bookkeeping: refcounts and device copies belong to the owner."""

    def __init__(self, block_size):
        self.block_size = int(block_size)
        self._full = {}         # chain key -> block id
        self._tails = {}        # chain key -> {tail token tuple: block}
        self._entry = {}        # block id -> (kind, key[, tail tuple])
        # blocks cached but referenced by no sequence, oldest first —
        # the eviction ladder
        self._lru = collections.OrderedDict()
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0

    @property
    def cached_blocks(self):
        return len(self._entry)

    @property
    def evictable(self):
        return len(self._lru)

    def hit_rate(self):
        """Token-weighted lifetime hit rate over every match() call."""
        total = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / total if total else 0.0

    def is_cached(self, block):
        return block in self._entry

    def match(self, prompt, count=True):
        """Longest cached prefix of ``prompt``: ``(blocks, ntokens)``
        — whole blocks first, then at most one partial tail. Pure
        lookup: refcounts and LRU state are untouched (``count=False``
        also skips the hit/miss accounting, for admission probes)."""
        prompt = np.asarray(prompt).reshape(-1)
        bs = self.block_size
        key = b""
        blocks, cached = [], 0
        for i in range(len(prompt) // bs):
            nxt = _chain_key(key, prompt[i * bs:(i + 1) * bs])
            b = self._full.get(nxt)
            if b is None:
                break
            blocks.append(b)
            cached += bs
            key = nxt
        # the partial tail: longest stored tail that prefixes the
        # remaining tokens (typically 0 or 1 candidates per key)
        best = None
        for tail, b in self._tails.get(key, {}).items():
            if len(tail) + cached <= len(prompt) and \
                    (best is None or len(tail) > len(best[0])) and \
                    tuple(int(t) for t in
                          prompt[cached:cached + len(tail)]) == tail:
                best = (tail, b)
        if best is not None:
            blocks.append(best[1])
            cached += len(best[0])
        if count:
            self.hit_tokens += cached
            self.miss_tokens += len(prompt) - cached
        return blocks, cached

    def insert_full(self, key_prefix_tokens, block):
        """Insert one full block under the chain key of every token up
        to and including its own. Returns True when inserted (False:
        the chunk was already cached — keep the existing block)."""
        prompt = np.asarray(key_prefix_tokens).reshape(-1)
        bs = self.block_size
        key = b""
        for i in range(len(prompt) // bs):
            key = _chain_key(key, prompt[i * bs:(i + 1) * bs])
        if key in self._full or block in self._entry:
            return False
        self._full[key] = block
        self._entry[block] = ("full", key)
        return True

    def insert_tail(self, full_prefix_tokens, tail_tokens, block):
        """Insert a partial-tail entry: ``tail_tokens`` at positions
        following the full-block prefix live in ``block`` rows
        ``0..len(tail)-1``. Returns True when inserted."""
        prompt = np.asarray(full_prefix_tokens).reshape(-1)
        bs = self.block_size
        key = b""
        for i in range(len(prompt) // bs):
            key = _chain_key(key, prompt[i * bs:(i + 1) * bs])
        tail = tuple(int(t) for t in np.asarray(tail_tokens).reshape(-1))
        if not tail or len(tail) >= bs:
            raise ValueError(f"tail must be 1..{bs - 1} tokens, "
                             f"got {len(tail)}")
        per_key = self._tails.setdefault(key, {})
        if tail in per_key or block in self._entry:
            return False
        per_key[tail] = block
        self._entry[block] = ("tail", key, tail)
        return True

    def mark_referenced(self, block):
        """A sequence took a reference to this cached block — it is no
        longer evictable."""
        self._lru.pop(block, None)

    def mark_unreferenced(self, block):
        """The last sequence referencing this cached block released it
        — it joins the evictable LRU tail (most recently used end)."""
        if block in self._entry:
            self._lru.pop(block, None)
            self._lru[block] = None

    def pop_lru(self):
        """Evict the least-recently-used unreferenced cached block:
        drops its map entry and returns the block id (caller releases
        the cache's allocator reference), or None when nothing is
        evictable."""
        if not self._lru:
            return None
        block, _ = self._lru.popitem(last=False)
        self.drop(block)
        self.evictions += 1
        return block

    def drop(self, block):
        """Remove a block's cache entry (eviction or CoW bookkeeping)."""
        ent = self._entry.pop(block, None)
        self._lru.pop(block, None)
        if ent is None:
            return
        if ent[0] == "full":
            self._full.pop(ent[1], None)
        else:
            per_key = self._tails.get(ent[1])
            if per_key is not None:
                per_key.pop(ent[2], None)
                if not per_key:
                    del self._tails[ent[1]]


class PagedKVCache:
    """Per-layer pooled K/V buffers + per-sequence block tables.

    The pools are f32 torch tensors on ``device`` (``cuda`` by default)
    that the engine's forward functions update in place; everything
    else — tables, the allocator, slot math — is host-side numpy.
    ``config`` is GPT-shaped (``num_hidden_layers``,
    ``num_attention_heads``, ``hidden_size``).

    With ``prefix_cache=True`` the cache grows the prefix-sharing
    plane: :meth:`add_seq_prefix` resolves a prompt's cached prefix to
    shared blocks (refcount bumped per sharer), :meth:`insert_prefix`
    publishes a prefilled prompt's blocks for later requests,
    :meth:`ensure_writable` copy-on-writes shared blocks before a
    sequence extends into them, and retiring sequences leave cached
    blocks resident (LRU-evicted only under allocation pressure).
    Everything stays single-threaded under the engine's scheduler —
    none of this is locked."""

    def __init__(self, config, num_blocks=None,
                 block_size=DEFAULT_BLOCK_SIZE, budget=None,
                 telemetry=None, prefix_cache=False, device=None):
        from .. import telemetry as _telemetry
        self.config = config
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        if num_blocks is None:
            num_blocks = blocks_for_budget(config, self.block_size,
                                           budget, device=self.device)
            if num_blocks is None:
                raise ValueError(
                    "no device-memory budget resolvable to size the KV "
                    "pool (CPU?): pass num_blocks= explicitly or set "
                    "HETU_HBM_BUDGET")
        self.num_blocks = int(num_blocks)
        self.telemetry = _telemetry.resolve(telemetry)
        # block 0 is the scratch block padded lanes target; real
        # sequences allocate from 1..num_blocks
        self.allocator = BlockAllocator(self.num_blocks, self.block_size,
                                        first_id=1)
        self.prefix = PrefixCache(self.block_size) if prefix_cache \
            else None
        self.pools = self._init_pools()
        self.tables = {}            # seq_id -> [block ids]
        self.peak_utilization = 0.0
        self.cow_copies = 0

    def _init_pools(self):
        nh = self.config.num_attention_heads
        hs = self.config.hidden_size // nh
        shape = (self.num_blocks + 1, self.block_size, nh, hs)
        return [{"k": torch.zeros(shape, device=self.device),
                 "v": torch.zeros(shape, device=self.device)}
                for _ in range(self.config.num_hidden_layers)]

    # -- accounting ------------------------------------------------------
    @property
    def used_blocks(self):
        return self.allocator.used

    @property
    def cached_blocks(self):
        """Cached blocks referenced by NO live sequence (the
        LRU-evictable pool the prefix cache keeps resident)."""
        return self.prefix.evictable if self.prefix is not None else 0

    @property
    def referenced_blocks(self):
        """Blocks at least one live sequence references."""
        return self.allocator.used - self.cached_blocks

    @property
    def utilization(self):
        """Fraction of the (non-scratch) pool held by live sequences
        (cached-but-unreferenced blocks are reclaimable, so they don't
        count here — see :attr:`cached_utilization`)."""
        return self.referenced_blocks / self.num_blocks

    @property
    def cached_utilization(self):
        """Fraction of the pool holding cached-unreferenced blocks."""
        return self.cached_blocks / self.num_blocks

    def hbm_bytes(self):
        """Bytes the pools occupy (scratch block included)."""
        return kv_block_bytes(self.config, self.block_size) \
            * (self.num_blocks + 1)

    def can_admit(self, ntokens):
        return self.allocator.blocks_for_tokens(ntokens) \
            <= self.allocator.available + self.cached_blocks

    def fits_at_all(self, ntokens):
        """Whether a sequence of ``ntokens`` could EVER be served by
        this pool (the submit-time guard)."""
        return self.allocator.blocks_for_tokens(ntokens) \
            <= self.allocator.num_blocks

    def _note_util(self):
        u = self.utilization
        if u > self.peak_utilization:
            self.peak_utilization = u
        if self.telemetry.enabled:
            self.telemetry.set_gauge("kv_blocks_used",
                                     self.referenced_blocks)
            self.telemetry.set_gauge("kv_blocks_free",
                                     self.allocator.available)
            self.telemetry.set_gauge("kv_seqs", len(self.tables))
            self.telemetry.set_gauge("kv_hbm_utilization", u)
            if self.prefix is not None:
                self.telemetry.set_gauge("kv_blocks_cached",
                                         self.cached_blocks)
                self.telemetry.set_gauge("kv_hbm_utilization_cached",
                                         self.cached_utilization)
                self.telemetry.set_gauge("serve_prefix_hit_rate",
                                         self.prefix.hit_rate())

    # -- allocation under cache pressure --------------------------------
    def _evict_for(self, n):
        """Evict LRU cached-unreferenced blocks until ``n`` are free
        (or nothing is left to evict)."""
        if self.prefix is None:
            return
        while self.allocator.available < n:
            b = self.prefix.pop_lru()
            if b is None:
                return
            self.allocator.free([b])    # the cache's own reference
            if self.telemetry.enabled:
                self.telemetry.inc("serve_prefix_evictions")

    def _alloc(self, n):
        """Allocate ``n`` blocks, reclaiming cached-unreferenced blocks
        LRU-first when the free list alone can't cover it."""
        self._evict_for(n)
        return self.allocator.alloc(n)

    def _release_block(self, block):
        """Drop one reference; a cached block whose only remaining
        reference is the cache's moves to the evictable LRU."""
        self.allocator.free([block])
        if self.prefix is not None and self.prefix.is_cached(block) \
                and self.allocator.refcount(block) == 1:
            self.prefix.mark_unreferenced(block)

    # -- sequence lifecycle ---------------------------------------------
    def add_seq(self, seq_id, ntokens):
        """Allocate blocks covering ``ntokens`` positions for a new
        sequence (all-or-nothing; raises :class:`KVCacheExhausted`)."""
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id} already has a table")
        blocks = self._alloc(self.allocator.blocks_for_tokens(ntokens))
        self.tables[seq_id] = blocks
        self._note_util()
        return blocks

    def match_prefix(self, prompt):
        """Pure admission probe: ``(shared_blocks, cached_tokens)`` the
        prompt would resolve against the prefix cache right now, with
        ``cached_tokens`` capped at ``len(prompt) - 1`` so prefill
        always recomputes at least the last prompt token (the logits
        the first sampled token needs)."""
        if self.prefix is None:
            return [], 0
        blocks, cached = self.prefix.match(prompt, count=False)
        return blocks, min(cached, len(np.asarray(prompt).reshape(-1)) - 1)

    def admit_blocks_needed(self, prompt, ntokens):
        """Blocks a prefix-aware admission must find for this request:
        the non-cached remainder of its table, plus the copy-on-write
        spares its writes into shared blocks will consume."""
        blocks, cached = self.match_prefix(prompt)
        need = self.allocator.blocks_for_tokens(ntokens) - len(blocks)
        p = len(np.asarray(prompt).reshape(-1))
        # suffix prefill's first write lands inside a shared block
        if blocks and cached // self.block_size < len(blocks):
            need += 1
        # the first decode write extends the (cache-frozen) prompt tail
        if self.prefix is not None and p % self.block_size != 0:
            need += 1
        return need

    def add_seq_prefix(self, seq_id, ntokens, prompt):
        """Prefix-aware :meth:`add_seq`: resolve the prompt's cached
        prefix to shared blocks (one reference each), allocate only the
        remainder, install the table. Returns ``(blocks,
        cached_tokens)`` — all-or-nothing (shared references roll back
        on exhaustion)."""
        if self.prefix is None:
            return self.add_seq(seq_id, ntokens), 0
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id} already has a table")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        shared, cached = self.prefix.match(prompt)
        cached = min(cached, len(prompt) - 1)
        self.allocator.share(shared)
        for b in shared:
            self.prefix.mark_referenced(b)
        try:
            fresh = self._alloc(
                self.allocator.blocks_for_tokens(ntokens) - len(shared))
        except KVCacheExhausted:
            for b in shared:
                self._release_block(b)
            raise
        self.tables[seq_id] = shared + fresh
        self._note_util()
        return self.tables[seq_id], cached

    def insert_prefix(self, seq_id, prompt):
        """Publish a fully-prefilled prompt's blocks into the prefix
        cache: every full block under its rolling-hash chain key, plus
        one frozen tail entry for the trailing partial block. The cache
        takes one reference per published block (that reference is what
        keeps a retired prompt resident). No-op without a prefix cache;
        already-cached chunks keep their existing blocks."""
        if self.prefix is None:
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        table = self.tables[seq_id]
        bs = self.block_size
        inserted = 0
        for i in range(len(prompt) // bs):
            b = table[i]
            if self.prefix.insert_full(prompt[:(i + 1) * bs], b):
                self.allocator.share([b])
                inserted += 1
        f = len(prompt) % bs
        if f:
            b = table[len(prompt) // bs]
            if self.prefix.insert_tail(prompt[:len(prompt) - f],
                                       prompt[len(prompt) - f:], b):
                self.allocator.share([b])
                inserted += 1
        self._note_util()
        return inserted

    def ensure_writable(self, seq_id, start, stop):
        """Copy-on-write guard for writes to positions ``[start,
        stop)``: any touched block someone else also references (a
        concurrent sharer, or the prefix cache's frozen entry) is
        copied into a fresh block first and the table repointed. When
        allocation for the copy can't be covered and the ONLY other
        referent is the cache, the entry is dropped instead (write in
        place — the cache relinquishes rather than kill the sequence).
        Returns the number of blocks copied."""
        table = self.tables[seq_id]
        bs = self.block_size
        copied = 0
        for i in range(int(start) // bs, (int(stop) - 1) // bs + 1):
            b = table[i]
            if self.allocator.refcount(b) <= 1:
                continue
            cache_only = (self.prefix is not None
                          and self.prefix.is_cached(b)
                          and self.allocator.refcount(b) == 2)
            try:
                (fresh,) = self._alloc(1)
            except KVCacheExhausted:
                if cache_only:
                    # relinquish the cache entry: the block becomes
                    # privately ours, no copy needed
                    self.prefix.drop(b)
                    self.allocator.free([b])
                    continue
                raise
            self._copy_block(b, fresh)
            table[i] = fresh
            self._release_block(b)
            copied += 1
            self.cow_copies += 1
            if self.telemetry.enabled:
                self.telemetry.inc("serve_cow_copies")
        if copied:
            self._note_util()
        return copied

    def _copy_block(self, src, dst):
        """Copy one block's K/V rows across every layer, in place on
        the device."""
        for p in self.pools:
            p["k"][dst].copy_(p["k"][src])
            p["v"][dst].copy_(p["v"][src])

    def extend_seq(self, seq_id, ntokens):
        """Grow a sequence's table to cover ``ntokens`` total positions
        (no-op when it already does)."""
        table = self.tables[seq_id]
        need = self.allocator.blocks_for_tokens(ntokens) - len(table)
        if need > 0:
            table.extend(self._alloc(need))
            self._note_util()
        return table

    def free_seq(self, seq_id):
        """Release a sequence's references. Unshared blocks return to
        the free list; cached blocks stay resident (the cache's
        reference) and become evictable once no sequence holds them."""
        blocks = self.tables.pop(seq_id, None)
        if blocks:
            for b in blocks:
                self._release_block(b)
        self._note_util()

    def capacity_tokens(self, seq_id):
        return len(self.tables[seq_id]) * self.block_size

    def assert_consistent(self):
        """Debug invariant sweep (tests call this after churn): every
        allocator refcount equals the number of table references plus
        the cache's, the free list and live set partition the pool, and
        every LRU block is genuinely unreferenced."""
        refs = collections.Counter()
        for table in self.tables.values():
            refs.update(table)
        if self.prefix is not None:
            refs.update(self.prefix._entry.keys())
        alloc = self.allocator
        assert dict(refs) == alloc._ref, \
            f"dangling refcounts: expected {dict(refs)} got {alloc._ref}"
        assert len(alloc._free) + len(alloc._ref) == alloc.num_blocks
        assert not (set(alloc._free) & set(alloc._ref))
        if self.prefix is not None:
            for b in self.prefix._lru:
                assert alloc.refcount(b) == 1, \
                    f"LRU block {b} is still referenced"

    # -- slot math (host-side; the jit programs take these as inputs) ---
    def slot_of(self, seq_id, pos):
        """Flat pool slot of one position."""
        table = self.tables[seq_id]
        return table[pos // self.block_size] * self.block_size \
            + pos % self.block_size

    def slot_mapping(self, seq_id, start, stop):
        """Flat slots for positions ``[start, stop)`` as int32."""
        table = np.asarray(self.tables[seq_id], np.int32)
        pos = np.arange(start, stop)
        return (table[pos // self.block_size] * self.block_size
                + pos % self.block_size).astype(np.int32)

    def gather_slots(self, seq_ids, width):
        """``[len(seq_ids), width]`` int32 slot grid covering positions
        ``0..width-1`` per sequence; positions beyond a sequence's
        allocated blocks point at the scratch block (they sit behind
        the attention length mask anyway)."""
        bs = self.block_size
        off = np.arange(width, dtype=np.int64)
        out = np.zeros((len(seq_ids), width), np.int32)
        for i, sid in enumerate(seq_ids):
            table = np.asarray(self.tables[sid], np.int64)
            cap = len(table) * bs
            w = min(width, cap)
            out[i, :w] = (table[off[:w] // bs] * bs
                          + off[:w] % bs).astype(np.int32)
        return out
