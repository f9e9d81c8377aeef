"""hetu_tpu_torch.serving.GPTDecoder against hetu_tpu's on the CPU.

The tiny GPT of tests/test_torch_serving_session.py (vocab 64, hidden
32, 2 layers, 4 heads, 32 positions) in both packages from one seed.
The decoder is built ``from_session`` (sharing the session's tensors)
or ``from_checkpoint``; on the CPU its prefill runs the composed
attention, the session's graph forward kernel K1's plain version.
Logits agree within rtol = atol = 1e-5 (float32, the reference's pin);
greedy tokens are identical to the reference decoder's and to the
argmax chain of repeated full forwards. Temperature sampling draws
from a ``torch.Generator`` (not JAX's PRNG), so it is held to its own
properties: tokens in the vocabulary, the same seed the same tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
from hetu_tpu.serving import GPTDecoder as JDecoder
from hetu_tpu.serving import InferenceSession as JSession
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.serving import (ContinuousBatchingEngine, GPTDecoder,
                                    InferenceSession)

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, SEQ = 64, 32
GPT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=SEQ,
           hidden_dropout_prob=0.0, use_flash_attention=True)


def _session(seed=0, **kw):
    cfg = TM.GPTConfig(**{**GPT, **kw})
    ids = tht.Variable("input_ids", trainable=False)
    sess = InferenceSession([TM.GPTLMHeadModel(cfg)(ids)],
                            seq_buckets=(SEQ,), seed=seed, device="cpu")
    return cfg, ids, sess


def _jax_session(seed=0):
    cfg = JM.GPTConfig(**GPT)
    ids = jht.Variable("input_ids", trainable=False)
    return cfg, JSession([JM.GPTLMHeadModel(cfg)(ids)],
                         seq_buckets=(SEQ,), seed=seed)


def _argmax_chain(sess, ids, x, n):
    cur = x.copy()
    for _ in range(n):
        full = sess.predict({ids: cur})[0]
        cur = np.concatenate([cur, full[:, -1].argmax(-1)[:, None]], axis=1)
    return cur[:, x.shape[1]:]


def test_kv_decode_matches_full_forward_every_step():
    cfg, ids, sess = _session(seed=0)
    dec = GPTDecoder.from_session(sess, cfg)
    x = np.random.RandomState(0).randint(0, VOCAB, (2, 16))
    full = sess.predict({ids: x})[0]
    prefix = 6
    logits, kv = dec.prefill(x[:, :prefix])
    np.testing.assert_allclose(logits.numpy(), full[:, :prefix], **TOL)
    for pos in range(prefix, 16):
        step, kv = dec.decode_step(kv, x[:, pos], pos)
        np.testing.assert_allclose(step.numpy(), full[:, pos], **TOL)


def test_greedy_generate_matches_reference_and_full_forward_chain():
    cfg, ids, sess = _session(seed=1)
    jcfg, jsess = _jax_session(seed=1)
    dec = GPTDecoder.from_session(sess, cfg)
    jdec = JDecoder.from_session(jsess, jcfg)
    x = np.random.RandomState(1).randint(0, VOCAB, (2, 8))
    got = dec.generate(x, max_new_tokens=6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(jdec.generate(x, 6)))
    np.testing.assert_array_equal(got, _argmax_chain(sess, ids, x, 6))
    logits, _ = dec.prefill(x)
    jlogits, _ = jdec.prefill(x)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    full = dec.generate(x, 3, return_prompt=True)
    np.testing.assert_array_equal(full, np.concatenate([x, got[:, :3]], 1))
    assert dec.generate(x, 0).shape == (2, 0)


def test_generate_bucketed_ragged_prompts_match_exact():
    """Ragged prompt lengths pad to their bucket for the prefill; the
    padded tail's K/V rows are overwritten before they become
    attendable, so tokens equal the exact-length argmax chain."""
    cfg, ids, sess = _session(seed=4)
    dec = GPTDecoder.from_session(sess, cfg)
    exact = GPTDecoder.from_session(sess, cfg, prompt_buckets=range(1, SEQ))
    rng = np.random.RandomState(4)
    for p in (5, 7, 12):              # buckets 8, 8, 16 — none exact
        x = rng.randint(0, VOCAB, (2, p))
        got = dec.generate(x, 4)
        np.testing.assert_array_equal(got, exact.generate(x, 4))
        np.testing.assert_array_equal(got, _argmax_chain(sess, ids, x, 4))


def test_generate_refuses_what_does_not_fit():
    cfg, _, sess = _session(seed=6)
    dec = GPTDecoder.from_session(sess, cfg, max_len=16)
    with pytest.raises(ValueError, match="max_len 16"):
        dec.generate(np.zeros((1, 10), np.int64), 8)
    with pytest.raises(ValueError, match="at least one prompt token"):
        dec.generate(np.zeros((1, 0), np.int64), 2)
    with pytest.raises(ValueError, match="learned positions"):
        GPTDecoder.from_session(sess, cfg, max_len=SEQ + 1)


def test_temperature_sampling_in_vocab_and_repeatable():
    cfg, _, sess = _session(seed=2)
    dec = GPTDecoder.from_session(sess, cfg)
    x = np.random.RandomState(2).randint(0, VOCAB, (2, 4))
    out = dec.generate(x, 8, temperature=1.0, seed=3)
    assert out.shape == (2, 8)
    assert (out >= 0).all() and (out < VOCAB).all()
    np.testing.assert_array_equal(
        out, dec.generate(x, 8, temperature=1.0, seed=3))
    others = [dec.generate(x, 8, temperature=1.0, seed=s) for s in (4, 5)]
    assert any(not np.array_equal(out, o) for o in others)


def test_from_session_shares_the_session_tensors():
    cfg, _, sess = _session(seed=3)
    params = sess.params_by_name()
    for owner in (GPTDecoder.from_session(sess, cfg),
                  ContinuousBatchingEngine.from_session(
                      sess, cfg, num_blocks=8, block_size=4, start=False)):
        assert owner.device == sess.device
        p = owner.params
        pairs = [(p["wte"], "gpt_wte"), (p["wpe"], "gpt_wpe"),
                 (p["lm_head"], "gpt_lm_head_weights"),
                 (p["blocks"][1]["qkv"][0], "gpt_h1_attn_qkv_weights"),
                 (p["ln_f"][1], "gpt_ln_f_bias")]
        for got, name in pairs:
            assert got.data_ptr() == params[name].data_ptr(), name
        if isinstance(owner, ContinuousBatchingEngine):
            owner.close()


def test_continuous_engine_from_session_matches_the_decoder():
    cfg, _, sess = _session(seed=8)
    dec = GPTDecoder.from_session(sess, cfg)
    eng = ContinuousBatchingEngine.from_session(
        sess, cfg, num_blocks=16, block_size=4, start=False)
    x = np.random.RandomState(8).randint(0, VOCAB, 7).astype(np.int32)
    fut = eng.submit(x, 5)
    while not fut.done():
        eng.step()
    eng.close()
    np.testing.assert_array_equal(fut.result(), dec.generate(x[None], 5)[0])


def test_decoder_from_checkpoint(tmp_path):
    cfg, ids, sess = _session(seed=3)
    sess.executor.save(str(tmp_path))
    dec = GPTDecoder.from_checkpoint(cfg, str(tmp_path), device="cpu")
    x = np.random.RandomState(3).randint(0, VOCAB, (1, 5))
    logits, _ = dec.prefill(x)
    np.testing.assert_allclose(logits.numpy(), sess.predict({ids: x})[0],
                               **TOL)
    jdec = JDecoder.from_checkpoint(JM.GPTConfig(**GPT), str(tmp_path))
    jlogits, _ = jdec.prefill(jnp.asarray(x, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    with pytest.raises(FileNotFoundError, match="gpt_wte"):
        GPTDecoder.from_checkpoint(cfg, str(tmp_path / "none"),
                                   device="cpu")
