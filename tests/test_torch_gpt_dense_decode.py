"""hetu_tpu_torch.models.gpt dense decode (init_kv_cache, gpt_prefill,
gpt_cached_step) against hetu_tpu.models.gpt on the CPU.

Both packages get the same numpy checkpoint (``random_gpt_checkpoint``)
and the same ids: the prefill's logits and the K/V rows it writes, then
the cached step's logits at every step of a 6-token continuation, must
agree within rtol = atol = 1e-5 (float32, the reference's own pin,
tests/test_serving.py), for each serving activation. The port updates
its K/V buffers in place and returns them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.models import gpt as jgpt
from hetu_tpu_torch.models import gpt as tgpt
from hetu_tpu_torch.ops import _build

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, max_position_embeddings=32)
NH = KW["num_attention_heads"]
B, PROMPT, STEPS = 2, 10, 6


@functools.lru_cache(maxsize=None)
def _jit(name, act):
    return jax.jit(functools.partial(getattr(jgpt, name), num_heads=NH,
                                     hidden_act=act))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["gelu", "relu", "tanh"])
def test_prefill_and_cached_steps_match_reference(act):
    tcfg = tgpt.GPTConfig(**KW, hidden_act=act)
    jcfg = jgpt.GPTConfig(**KW, hidden_act=act)
    ckpt = tgpt.random_gpt_checkpoint(tcfg, seed=5)
    tparams = tgpt.gpt_serving_params(tcfg, ckpt.__getitem__, "cpu")
    jparams = jgpt.gpt_serving_params(jcfg, ckpt.__getitem__)
    rng = np.random.RandomState(7)
    ids = rng.randint(0, KW["vocab_size"], (B, PROMPT + STEPS))

    tkv = tgpt.init_kv_cache(tcfg, B, device="cpu")
    jkv = jgpt.init_kv_cache(jcfg, B)
    assert [tuple(layer["k"].shape) for layer in tkv] == \
        [tuple(layer["k"].shape) for layer in jkv]
    buffers = [layer["k"] for layer in tkv]
    before = dict(_build.launch_counts)
    tlogits, tkv_out = tgpt.gpt_prefill(
        tparams, tkv, torch.as_tensor(ids[:, :PROMPT]), NH, act)
    jlogits, jkv = _jit("gpt_prefill", act)(
        jparams, jkv, jnp.asarray(ids[:, :PROMPT], jnp.int32))
    assert tkv_out is tkv and all(
        layer["k"] is buf for layer, buf in zip(tkv, buffers)), \
        "the K/V buffers must be updated in place"
    _close(tlogits, jlogits)
    for tl, jl in zip(tkv, jkv):
        for key in ("k", "v"):
            _close(tl[key], jl[key])        # rows written and the zeros

    for t in range(STEPS):
        pos = PROMPT + t
        # the port takes pos as an int or a 0-d tensor
        tpos = pos if t % 2 else torch.tensor(pos)
        tstep, tkv = tgpt.gpt_cached_step(
            tparams, tkv, torch.as_tensor(ids[:, pos]), tpos, NH, act)
        jstep, jkv = _jit("gpt_cached_step", act)(
            jparams, jkv, jnp.asarray(ids[:, pos], jnp.int32),
            jnp.int32(pos))
        _close(tstep, jstep)
    for tl, jl in zip(tkv, jkv):
        for key in ("k", "v"):
            _close(tl[key], jl[key])
    assert dict(_build.launch_counts) == before, \
        "a CPU decode counted a kernel launch"


def test_cached_steps_match_the_prefill_of_the_whole_sequence():
    """Teacher-forced: the cached step's logits at each position equal
    the prefill of the sequence up to it (the port alone, f32)."""
    cfg = tgpt.GPTConfig(**KW)
    params = tgpt.gpt_serving_params(
        cfg, tgpt.random_gpt_checkpoint(cfg, seed=2).__getitem__, "cpu")
    ids = torch.as_tensor(np.random.RandomState(2).randint(
        0, KW["vocab_size"], (B, PROMPT + STEPS)))
    full, _ = tgpt.gpt_prefill(params, tgpt.init_kv_cache(cfg, B,
                                                          device="cpu"),
                               ids, NH)
    _, kv = tgpt.gpt_prefill(params, tgpt.init_kv_cache(cfg, B, device="cpu"),
                             ids[:, :PROMPT], NH)
    for pos in range(PROMPT, PROMPT + STEPS):
        step, kv = tgpt.gpt_cached_step(params, kv, ids[:, pos], pos, NH)
        _close(step, full[:, pos])
    assert not full.requires_grad and torch.is_inference(full)
