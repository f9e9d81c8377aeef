"""Plain versions of kernels K2 (forward with logsumexp), K3 and K4
(fused backward) against the Pallas kernels in interpret mode, and the
port's FlashAttentionOp / gradient-op routing against jax.vjp of the
composed reference — on the CPU, same numpy inputs on both sides.

Tolerances are the reference's own (tests/test_attention.py:167-240):
o and lse atol = rtol = 2e-5, dq / dk / dv 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetu_tpu_torch as tht
from hetu_tpu.ops import attention as jattn
from hetu_tpu.ops import pallas_attention as pk
from hetu_tpu_torch.graph.node import ExecContext
from hetu_tpu_torch.ops import attention as tattn
from hetu_tpu_torch.ops import flash_attention as fa

FWD = dict(rtol=2e-5, atol=2e-5)
BWD = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _static_tiles(monkeypatch):
    # the reference kernels' default tiles, no autotune sweep in
    # interpret mode: the plain versions walk the same tiles
    monkeypatch.setenv("HETU_AUTOTUNE", "0")


def _inputs(b, h, s, d, masked, seed):
    rng = np.random.RandomState(seed)
    q, k, v = [(rng.randn(b, h, s, d) * 0.3).astype(np.float32)
               for _ in range(3)]
    dy = rng.randn(b, h, s, d).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((b, 1, 1, s), np.float32)
        mask[..., s - 10:] = -1e9
    return q, k, v, dy, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("s,masked,causal,b,h,d", [
    (64, False, False, 2, 3, 16), (64, True, False, 2, 3, 16),
    (64, False, True, 2, 3, 16), (64, True, True, 2, 3, 16),
    (128, False, False, 2, 3, 16), (128, True, False, 2, 3, 16),
    (128, False, True, 2, 3, 16), (128, True, True, 2, 3, 16),
    # the reference tiles bq = 256 != bk = 512: K3's q loop starts at
    # (kj bk) // bq, K4's k loop stops at cdiv((qi + 1) bq, bk)
    (512, True, True, 1, 2, 8), (512, False, False, 1, 2, 8),
])
def test_plain_k2_k3_k4_match_pallas_interpret(s, masked, causal, b, h, d):
    q, k, v, dy, mask = _inputs(b, h, s, d, masked, seed=s + causal)
    o, lse = pk.flash_attention_with_lse(_j(q), _j(k), _j(v), _j(mask),
                                         sm_scale=0.25, causal=causal,
                                         interpret=True)
    want = pk.flash_attention_bwd(_j(q), _j(k), _j(v), _j(mask), o, lse,
                                  _j(dy), sm_scale=0.25, causal=causal,
                                  interpret=True)
    to, tlse = fa.flash_attention_with_lse(_t(q), _t(k), _t(v), _t(mask),
                                           0.25, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), **FWD)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), **FWD)
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(mask), to, tlse,
                                 _t(dy), 0.25, causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD,
                                   err_msg=f"d{name}")


def test_with_lse_returns_none_on_unsupported_shapes():
    q = torch.zeros(1, 2, 260, 16)
    assert fa.flash_attention_with_lse(q, q, q) == (None, None)
    q = torch.zeros(1, 2, 4, 8)
    assert fa.flash_attention_with_lse(q, q, q, causal=True) == (None, None)


def _composed_vjp(q, k, v, mask, dy, causal, s):
    def f(q_, k_, v_):
        m = _j(mask)
        if causal:
            cm = jnp.where(jnp.tril(jnp.ones((s, s), bool)), 0.0,
                           -1e9)[None, None]
            m = cm if m is None else m + cm
        return jattn.attention_reference(q_, k_, v_, m, 0.25)
    out, vjp = jax.vjp(f, _j(q), _j(k), _j(v))
    return out, vjp(_j(dy))


def _op_pass(masked, causal, s, training=True):
    """FlashAttentionOp forward, then its three gradient ops, as the
    executor runs them."""
    q, k, v, dy, mask = _inputs(2, 3, s, 16, masked, seed=13 + s)
    ectx = ExecContext(training=training)
    qn, kn, vn, mn = [tht.Variable(n, trainable=False) for n in "qkvm"]
    fwd = tht.flash_attention_op(qn, kn, vn, mn if masked else None,
                                 sm_scale=0.25, causal=causal)
    vals = [_t(q), _t(k), _t(v)] + ([_t(mask)] if masked else [])
    out = fwd.compute(vals, ectx)
    stashed = ("flash_res", fwd.id) in ectx.cache
    dyn = tht.Variable("dy", trainable=False)
    grad_ops = fwd.gradient(dyn)[:3]
    grads = [g.compute(vals + [_t(dy)], ectx) for g in grad_ops]
    want_out, want = _composed_vjp(q, k, v, mask, dy, causal, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FWD)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD)
    assert not ectx.cache, "the step cache kept a consumed residual"
    return stashed


@pytest.mark.parametrize("masked,causal", [(True, False), (False, True),
                                           (True, True)])
def test_op_fused_path_stashes_and_consumes_the_residual(monkeypatch,
                                                         masked, causal):
    monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    calls = []
    monkeypatch.setattr(tattn, "flash_attention_bwd",
                        lambda *a, **kw: calls.append(1)
                        or fa.flash_attention_bwd(*a, **kw))
    assert _op_pass(masked, causal, s=32)
    assert calls == [1], "the three grad ops must share one fused call"


@pytest.mark.parametrize("training", [True, False])
def test_op_below_threshold_takes_k1_and_the_composed_vjp(monkeypatch,
                                                          training):
    monkeypatch.setattr(tattn, "flash_attention_bwd", None)  # never called
    assert not _op_pass(True, True, s=64, training=training)
