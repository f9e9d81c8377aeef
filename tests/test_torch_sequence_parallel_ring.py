"""The port's ring attention against the JAX package's on a CPU mesh of
the same size, on an sp mesh of thread ranks (tests/torch_tp_util.py):
the twins of tests/test_attention.py's ring cases against
``ring_attention_sharded`` (the output within 2e-5, the gradients of
sum(out^2) within 1e-4, and 8k tokens), and BERT at S=2048 under
``sequence_parallel=True`` (of
tests/test_sequence_parallel.py::test_bert_sequence_parallel_long_seq,
losses rtol 1e-4).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import hetu_tpu as jht
import hetu_tpu.models as JM
from hetu_tpu.parallel import ring as jring
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM

from torch_sp_util import (LOSS_RTOL, SP, jax_exe,  # noqa: F401
                           one_intra_op_thread, port_ranks, run_steps)

# ---------------------------------------------------------------------------
# tests/test_attention.py's ring cases: the output and its gradients
# ---------------------------------------------------------------------------

def _attention_values(b=2, h=4, s=64, d=16, seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) * scale
            for _ in range(3)]


def _padding(b, s, valid):
    m = np.zeros((b, 1, 1, s), np.float32)
    m[:, :, :, valid:] = -1e9
    return m


def _port_ring_outputs(sp, vals, mask, sm_scale, grads):
    """The port's ring op on an sp mesh of ``sp`` thread ranks: its output
    (and, with ``grads``, the gradients of sum(out^2)) on every rank."""
    def build(ht):
        q, k, v = (ht.Variable(f"a_{n}", value=x, trainable=False)
                   for n, x in zip("qkv", vals))
        m = None if mask is None else ht.Variable("a_m", value=mask,
                                                  trainable=False)
        out = ht.ring_attention_op(q, k, v, mask=m, sm_scale=sm_scale)
        nodes = [out]
        if grads:
            loss = ht.reduce_sum_op(out * out, [0, 1, 2, 3])
            nodes += ht.gradients(loss, [q, k, v])
        return nodes, None

    def run(exe, built):
        return [np.asarray(x.asnumpy()) for x in exe.run(feed_dict={})]

    return port_ranks({"sp": sp}, build, run)


RING_CASES = {  # (b, h, s, d, seed, mask valid length, scale, grads)
    "matches_reference": (2, 4, 64, 16, 3, None, 0.25, False),
    "with_mask": (2, 4, 64, 16, 4, 40, 0.25, False),
    "gradients": (1, 2, 32, 8, 5, None, 0.3, True),
    "long_context": (1, 2, 8192, 16, 0, None, 0.25, False),
}


@pytest.mark.parametrize("sp", SP)
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_the_jax_packages_ring(case, sp):
    """The ring op's output (2e-5) and the gradients of sum(out^2) (1e-4)
    against the JAX package's ``ring_attention_sharded`` on ``sp`` host
    devices, which tests/test_attention.py holds to the composed
    reference; the long context (8k tokens) against it too."""
    b, h, s, d, seed, valid, scale, grads = RING_CASES[case]
    vals = _attention_values(b, h, s, d, seed, 0.1 if s > 1024 else 0.3)
    mask = None if valid is None else _padding(b, s, valid)
    jmesh = JMesh(np.asarray(jax.devices()[:sp]), axis_names=("sp",))
    jq, jk, jv = (jnp.asarray(x) for x in vals)
    jmask = None if mask is None else jnp.asarray(mask)

    def ring(q_, k_, v_):
        return jring.ring_attention_sharded(q_, k_, v_, jmesh, "sp",
                                            sm_scale=scale, mask=jmask)

    want = [np.asarray(jax.jit(ring)(jq, jk, jv))]
    if grads:
        want += [np.asarray(g) for g in jax.jit(jax.grad(
            lambda *a: jnp.sum(ring(*a) ** 2), argnums=(0, 1, 2)))(jq, jk,
                                                                    jv)]
    for got in _port_ring_outputs(sp, vals, mask, scale, grads):
        assert got[0].shape == (b, h, s, d) and np.isfinite(got[0]).all()
        np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def _bert(ht, models, sp, seq, batch=2, vocab=128):
    """tests/test_sequence_parallel.py's long-sequence BERT."""
    cfg = models.BertConfig(
        vocab_size=vocab, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=seq, sequence_parallel=sp,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    feeds = [ht.Variable(n, trainable=False) for n in (
        "input_ids", "token_type_ids", "attention_mask", "masked_lm_labels",
        "next_sentence_label")]
    _, _, mlm, nsp = models.BertForPreTraining(cfg)(*feeds)
    loss = ht.reduce_mean_op(mlm, [0, 1]) + ht.reduce_mean_op(nsp, [0])
    return [loss, ht.optim.SGDOptimizer(0.01).minimize(loss)], feeds


def _bert_feeds(feeds, seq, batch=2, vocab=128, padded=False):
    rng = np.random.RandomState(0)
    mask = np.ones((batch, seq), np.float32)
    if padded:
        mask[:, seq - seq // 3:] = 0
    values = (rng.randint(0, vocab, (batch, seq)),
              rng.randint(0, 2, (batch, seq)), mask,
              rng.randint(0, vocab, (batch, seq)),
              rng.randint(0, 2, (batch,)))
    return lambda i: dict(zip(feeds, values))


@pytest.mark.parametrize("sp", SP)
def test_bert_sequence_parallel_long_seq(sp):
    """BertConfig(sequence_parallel=True) at S=2048 on an sp mesh of n
    ranks (a masked, non-causal ring over 2048/n-row shards, K2-K4's
    plain versions on every block) against the JAX package's run on n
    host devices, and against the port's flash path in one process:
    losses rtol 1e-4 over 2 SGD steps."""
    seq = 2048
    nodes, feeds = _bert(jht, JM, True, seq)
    want = run_steps(jax_exe(nodes, {"sp": sp}), 2, _bert_feeds(feeds, seq))
    nodes, feeds = _bert(tht, TM, False, seq)
    flash = run_steps(tht.Executor(nodes, ctx=tht.cpu(0)), 2,
                 _bert_feeds(feeds, seq))
    results = port_ranks({"sp": sp}, lambda ht: _bert(ht, TM, True, seq),
                          lambda exe, b: run_steps(exe, 2,
                                              _bert_feeds(b[1], seq)))
    for got in results:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, flash, rtol=LOSS_RTOL)
