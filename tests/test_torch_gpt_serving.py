"""hetu_tpu_torch.models.gpt (serving forward) against
hetu_tpu.models.gpt on the CPU.

Both packages get the same numpy checkpoint (``random_gpt_checkpoint``)
and the same ids/slots; prefill, single-token step and suffix prefill
must agree on logits and on the K/V pools, with block 0 (the scratch
block padded lanes write, in no defined order) excluded. Tolerance:
rtol = atol = 1e-5 (float32), the paged path's own pin
(tests/test_paged_serving.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.models import gpt as jgpt
from hetu_tpu.serving.kvcache import PagedKVCache as JCache
from hetu_tpu_torch.models import gpt as tgpt
from hetu_tpu_torch.serving.kvcache import PagedKVCache as TCache

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, max_position_embeddings=64)
NH = KW["num_attention_heads"]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _pools_close(tpools, jpools):
    for tp, jp in zip(tpools, jpools):
        for key in ("k", "v"):
            _close(tp[key][1:], np.asarray(jp[key])[1:])


@pytest.fixture(scope="module")
def models():
    tcfg, jcfg = tgpt.GPTConfig(**KW), jgpt.GPTConfig(**KW)
    ckpt = tgpt.random_gpt_checkpoint(tcfg, seed=3)
    return (tcfg, tgpt.gpt_serving_params(tcfg, ckpt.__getitem__, "cpu"),
            jcfg, jgpt.gpt_serving_params(jcfg, ckpt.__getitem__))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


def _j(x):
    return jnp.asarray(np.asarray(x, np.int32))


@functools.lru_cache(maxsize=None)
def _jit(name):
    # one compile per function instead of op-by-op dispatch
    return jax.jit(functools.partial(getattr(jgpt, name), num_heads=NH))


def test_random_checkpoint_covers_every_parameter():
    cfg = tgpt.GPTConfig(**KW)
    ckpt = tgpt.random_gpt_checkpoint(cfg, seed=0)
    names = tgpt.gpt_param_names(cfg)
    assert names == jgpt.gpt_param_names(jgpt.GPTConfig(**KW))
    flat = {names["wte"], names["wpe"], names["lm_head"], *names["ln_f"]}
    for blk in names["blocks"]:
        for pair in blk.values():
            flat.update(pair)
    assert set(ckpt) == flat
    assert all(a.dtype == np.float32 for a in ckpt.values())
    assert ckpt["gpt_wte"].shape == (96, 32)
    assert ckpt["gpt_lm_head_weights"].shape == (32, 96)
    assert ckpt["gpt_h1_mlp_fc_weights"].shape == (32, 128)
    again = tgpt.random_gpt_checkpoint(cfg, seed=0)
    assert all(np.array_equal(ckpt[n], again[n]) for n in ckpt)


def test_paged_prefill_step_and_suffix_match_reference(models):
    """Teacher-forced paged serving in both packages: a 2-sequence
    prefill of ragged prompts (edge-padded, padding to scratch), decode
    steps, then a suffix-prefill chunk — logits and pools agree."""
    tcfg, tparams, jcfg, jparams = models
    tc = TCache(tcfg, num_blocks=24, block_size=4, device="cpu")
    jc = JCache(jcfg, num_blocks=24, block_size=4)
    rng = np.random.RandomState(0)
    x = rng.randint(0, KW["vocab_size"], (2, 30))
    lens, p = (7, 5), 8
    for c in (tc, jc):
        c.add_seq(0, 30)
        c.add_seq(1, 30)
    ids = np.zeros((2, p), np.int64)
    slots = np.zeros((2, p), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = x[i, :n]
        ids[i, n:] = x[i, n - 1]
        slots[i, :n] = tc.slot_mapping(i, 0, n)
    tl, tpools = tgpt.gpt_paged_prefill(tparams, tc.pools, _t(ids),
                                        _t(slots), num_heads=NH)
    jl, jpools = _jit("gpt_paged_prefill")(jparams, jc.pools, _j(ids),
                                        _j(slots))
    assert tpools is tc.pools, "the port updates the pools in place"
    _close(tl, jl)
    _pools_close(tpools, jpools)

    pos = np.array(lens)
    for _ in range(4):
        tok = x[[0, 1], pos]
        grid = tc.gather_slots([0, 1], 16)
        write = np.array([tc.slot_of(0, pos[0]), tc.slot_of(1, pos[1])])
        tl, tpools = tgpt.gpt_paged_step(tparams, tpools, _t(tok), _t(pos),
                                         _t(grid), _t(write), num_heads=NH)
        jl, jpools = _jit("gpt_paged_step")(jparams, jpools, _j(tok), _j(pos),
                                         _j(grid), _j(write))
        _close(tl, jl)
        pos = pos + 1
    _pools_close(tpools, jpools)

    # a 6-wide chunk bucket carrying 5 and 3 real positions
    w, cw = (5, 3), 6
    ids = np.zeros((2, cw), np.int64)
    write = np.zeros((2, cw), np.int64)
    for i in range(2):
        ids[i, :w[i]] = x[i, pos[i]:pos[i] + w[i]]
        ids[i, w[i]:] = x[i, pos[i] + w[i] - 1]
        write[i, :w[i]] = tc.slot_mapping(i, pos[i], pos[i] + w[i])
    grid = tc.gather_slots([0, 1], 32)
    tl, tpools = tgpt.gpt_paged_suffix_prefill(
        tparams, tpools, _t(ids), _t(pos), _t(grid), _t(write),
        num_heads=NH)
    jl, jpools = _jit("gpt_paged_suffix_prefill")(
        jparams, jpools, _j(ids), _j(pos), _j(grid), _j(write))
    for i in range(2):
        _close(tl[i, :w[i]], np.asarray(jl)[i, :w[i]])
    _pools_close(tpools, jpools)


def test_suffix_prefill_positions_past_the_table_clamp_like_jax(models):
    """A padded chunk running past the learned positions: JAX clamps
    the position gather; the port clamps the same way (real rows
    agree, nothing raises)."""
    tcfg, tparams, jcfg, jparams = models
    tc = TCache(tcfg, num_blocks=24, block_size=4, device="cpu")
    jc = JCache(jcfg, num_blocks=24, block_size=4)
    for c in (tc, jc):
        c.add_seq(0, 64)
    start, cw = 60, 8               # 4 real positions, 4 past the table
    ids = np.full((1, cw), 7, np.int64)
    write = np.zeros((1, cw), np.int64)
    write[0, :4] = tc.slot_mapping(0, start, 64)
    grid = tc.gather_slots([0], 64)
    tl, _ = tgpt.gpt_paged_suffix_prefill(
        tparams, tc.pools, _t(ids), _t([start]), _t(grid), _t(write),
        num_heads=NH)
    jl, _ = _jit("gpt_paged_suffix_prefill")(
        jparams, jc.pools, _j(ids), _j([start]), _j(grid), _j(write))
    _close(tl, jl)


def test_params_from_a_reference_pytree(models):
    tcfg, tparams, jcfg, jparams = models
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    conv = tgpt.serving_params_from_numpy(tree, device="cpu")
    ids = _t([[1, 2, 3, 4, 5, 6, 7, 8]])
    slots = _t([np.arange(4, 12)])
    tc = TCache(tcfg, num_blocks=8, block_size=4, device="cpu")
    a, _ = tgpt.gpt_paged_prefill(conv, tc.pools, ids, slots, num_heads=NH)
    b, _ = tgpt.gpt_paged_prefill(tparams, tc.pools, ids, slots,
                                  num_heads=NH)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("trap", ["ln_population_variance", "gelu_tanh"])
def test_numerics_traps(trap):
    """The two places where torch's defaults differ from jnp's:
    ``torch.var`` is unbiased unless told otherwise (jnp.var is the
    population variance), and ``F.gelu`` is exact unless told tanh."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 8) * 4 + 2).astype(np.float32)    # n = 8: 8/7 apart
    if trap == "ln_population_variance":
        sb = (rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32))
        want = jgpt._serve_ln(jnp.asarray(x), tuple(map(jnp.asarray, sb)))
        got = tgpt._serve_ln(torch.from_numpy(x),
                             tuple(map(torch.from_numpy, sb)))
        unbiased = (torch.from_numpy(x) - torch.from_numpy(x).mean(-1, True)) \
            / torch.sqrt(torch.from_numpy(x).var(-1, keepdim=True) + 1e-12)
        wrong = unbiased * torch.from_numpy(sb[0]) + torch.from_numpy(sb[1])
    else:
        want = jgpt._serve_act("gelu")(jnp.asarray(x))
        got = tgpt._serve_act("gelu")(torch.from_numpy(x))
        wrong = torch.nn.functional.gelu(torch.from_numpy(x))
    _close(got, want)
    assert not np.allclose(wrong.numpy(), np.asarray(want), **TOL), \
        "the trap input does not tell the two numerics apart"
