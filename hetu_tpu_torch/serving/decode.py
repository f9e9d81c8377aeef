"""KV-cache autoregressive decode for the GPT family.

Counterpart of ``hetu_tpu/serving/decode.py``. ``GPTDecoder`` lifts a
trained ``GPTLMHeadModel`` checkpoint (or a live ``InferenceSession``)
into a weight-level decode loop:

* **prefill**: one causal forward over the prompt (kernel K1 on CUDA,
  through ``prefill_attention``) that also writes the prompt's K/V rows
  into preallocated ``[B, H, S_max, D]`` buffers,
* **decode**: the cached single-token forward
  (``models/gpt.py:gpt_cached_step``) — write-index into the K/V
  buffers in place, position-indexed learned embeddings, no ``[S, S]``
  mask,
* **generate**: greedy or temperature sampling, held against the
  full-sequence graph forward by the tests.

Where the reference keys a ``jit`` compile on (batch, prompt length),
the port runs eagerly, but ``generate()`` buckets ragged prompt lengths
all the same (``prompt_buckets``, power-of-two ladder by default), so
the prefill kernels see a bounded set of shapes. Bare ``prefill()``
calls are exact-shape by design (callers needing the per-position
prompt logits get exactly their length back).

Sampling draws from a ``torch.Generator`` seeded from ``(seed, t)`` for
token ``t``: the same seed gives the same tokens, but not the tokens
JAX's PRNG gives the reference (ROADMAP.md section 3).
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..device import resolve_device
from ..models.gpt import (gpt_cached_step, gpt_prefill, gpt_serving_params,
                          init_kv_cache)
from .session import next_bucket

__all__ = ["GPTDecoder"]


def _sampling_seed(seed, t):
    """The generator seed of token ``t``, a 32-bit hash of ``(seed, t)``
    (the reference folds ``t`` into its key). The CPU generator reads
    only a seed's low 32 bits, so the two are mixed, not stacked."""
    return int(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(t)]).generate_state(1)[0])


class GPTDecoder:
    def __init__(self, config, lookup, max_len=None, prompt_buckets=None,
                 telemetry=None, device=None):
        """``lookup(name) -> array or tensor`` resolves checkpoint
        parameter names (see ``models/gpt.py:gpt_param_names``); use the
        classmethods for the common sources. ``prompt_buckets`` bounds
        the prefill shapes generate() runs under ragged prompt lengths
        (None = powers of two). Parameters and K/V buffers live on
        ``device`` (``cuda`` by default; ``"cpu"`` runs the plain
        PyTorch paths)."""
        self.config = config
        self.prompt_buckets = (tuple(sorted(prompt_buckets))
                               if prompt_buckets else None)
        self.max_len = int(max_len or config.max_position_embeddings)
        if self.max_len > config.max_position_embeddings:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's learned "
                f"positions ({config.max_position_embeddings})")
        self.telemetry = _telemetry.resolve(telemetry)
        self.device = resolve_device(device)
        self.params = gpt_serving_params(config, lookup, self.device)
        nh = config.num_attention_heads
        act = getattr(config, "hidden_act", "gelu")
        self._prefill = functools.partial(gpt_prefill, num_heads=nh,
                                          hidden_act=act)
        self._step = functools.partial(gpt_cached_step, num_heads=nh,
                                       hidden_act=act)

    # ------------------------------------------------------------------
    @classmethod
    def from_session(cls, session, config, **kw):
        """From a live :class:`InferenceSession` over the same model:
        shares the session's device-resident parameter tensors (on the
        session's device unless ``device`` says otherwise)."""
        kw.setdefault("device", session.device)
        return cls(config, session.params_by_name().__getitem__, **kw)

    @classmethod
    def from_checkpoint(cls, config, path, **kw):
        """From an ``Executor.save`` checkpoint directory (frozen:
        reads only the per-parameter ``.npy`` files)."""
        def lookup(name):
            f = os.path.join(path, name + ".npy")
            if not os.path.exists(f):
                raise FileNotFoundError(
                    f"checkpoint {path} has no parameter {name!r} "
                    f"(expected {f})")
            return np.load(f)
        return cls(config, lookup, **kw)

    # ------------------------------------------------------------------
    def _ids(self, x):
        """Token ids (numpy, list or tensor) -> int64 on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    def prefill(self, ids, real_len=None):
        """Prompt phase over ``ids [B, P]``: returns
        ``(logits [B, P, V], kv)`` with K/V rows ``0..P-1`` written.

        ``real_len`` is the true prompt length when ``ids`` arrives
        already bucket-padded (generate() passes it): the
        ``decode_prefill_tokens`` counter counts only REAL tokens, and
        the padding overhead lands in ``decode_prefill_pad_tokens``."""
        ids = self._ids(ids)
        kv = init_kv_cache(self.config, ids.shape[0], self.max_len,
                           self.device)
        logits, kv = self._prefill(self.params, kv, ids)
        if self.telemetry.enabled:
            b, p = ids.shape
            real = b * min(int(real_len), p) if real_len is not None \
                else b * p
            self.telemetry.inc("decode_prefill_tokens", real)
            if b * p > real:
                self.telemetry.inc("decode_prefill_pad_tokens",
                                   b * p - real)
        return logits, kv

    def decode_step(self, kv, tokens, pos):
        """One cached step: ``tokens [B]`` at position ``pos``. Returns
        ``(logits [B, V], kv)``. The passed ``kv`` is consumed: its
        buffers are updated in place and returned."""
        return self._step(self.params, kv, self._ids(tokens), pos)

    # ------------------------------------------------------------------
    def generate(self, prompts, max_new_tokens, temperature=0.0, seed=0,
                 return_prompt=False):
        """Autoregressive continuation of ``prompts [B, P]``.

        ``temperature=0`` is greedy argmax; otherwise tokens sample from
        ``softmax(logits / temperature)``. Returns ``[B, T]`` int32 numpy
        (``[B, P+T]`` with ``return_prompt=True``)."""
        prompts = np.asarray(prompts)
        b, p = prompts.shape
        if p < 1:
            raise ValueError("generate() needs at least one prompt token")
        if max_new_tokens < 1:
            return prompts.copy() if return_prompt else \
                np.empty((b, 0), np.int32)
        if p + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {p} + {max_new_tokens} new tokens exceeds the "
                f"decoder's max_len {self.max_len}")
        tel = self.telemetry
        t_start = time.perf_counter() if tel.enabled else 0.0
        out = []            # device tensors; ONE host transfer at the end
        # prompt-length bucketing: prefill runs once per (batch,
        # bucket) shape, not once per exact length. The padded tail
        # writes junk K/V rows at positions >= p, but decode overwrites
        # row j at pos=j BEFORE the first step whose validity mask
        # (arange <= pos) admits it — generation from pos=p proceeds
        # sequentially, so no padded row is ever attended
        pb = min(next_bucket(p, self.prompt_buckets), self.max_len)
        with torch.inference_mode():
            if pb > p:
                pad = np.repeat(prompts[:, -1:], pb - p, axis=1)
                logits, kv = self.prefill(
                    np.concatenate([prompts, pad], axis=1), real_len=p)
            else:
                logits, kv = self.prefill(prompts)
            last = logits[:, p - 1]
            del logits
            if tel.enabled:
                # the fleet-level TTFT histogram the continuous-batching
                # engine records; the sync is the price of an honest
                # measurement (telemetry-on only)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_first = time.perf_counter()
                tel.observe("serve_ttft_ms", (t_first - t_start) * 1e3)
            for t in range(max_new_tokens):
                if temperature and temperature > 0.0:
                    g = torch.Generator(device=self.device)
                    g.manual_seed(_sampling_seed(seed, t))
                    probs = torch.softmax(last / temperature, dim=-1)
                    tok = torch.multinomial(probs, 1, generator=g)[:, 0]
                else:
                    tok = last.argmax(dim=-1)
                out.append(tok)     # stays on the device: no per-token sync
                if t + 1 < max_new_tokens:
                    last, kv = self.decode_step(kv, tok, p + t)
            gen = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        if tel.enabled:
            tel.inc("decode_tokens", b * max_new_tokens)
            # the host transfer above is the sync: every step is done
            tel.observe("serve_tpot_ms",
                        (time.perf_counter() - t_first) * 1e3
                        / max(1, max_new_tokens - 1))
        if return_prompt:
            return np.concatenate([prompts, gen], axis=1)
        return gen
