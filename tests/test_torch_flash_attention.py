"""hetu_tpu_torch.ops (flash_attention.py, attention.py) against
hetu_tpu.ops on the CPU.

The plain blocked version of kernel K1 (``flash_attention_plain``) is
held against the Pallas kernel run in interpret mode, as
tests/test_attention.py runs it, and against the composed reference;
the serving attention helpers against their jnp originals. Same numpy
inputs on both sides. Tolerance: rtol = atol = 2e-5 (float32, the
reference's own flash-attention pin).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops import attention as jattn
from hetu_tpu.ops import pallas_attention as pk
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import attention as tattn
from hetu_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b=2, h=3, s=64, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, h, s, d) * 0.3).astype(np.float32)
            for _ in range(3)]


def _mask(b, s, valid, full_row=False):
    m = np.zeros((b, 1, 1, s), np.float32)
    m[..., valid:] = -1e9
    if full_row:
        m[-1] = -1e9                    # every key of the last row masked
    return m


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.fixture(autouse=True)
def _static_tiles(monkeypatch):
    # the reference kernel's default tiles, no autotune sweep in
    # interpret mode: the plain version walks the same tiles
    monkeypatch.setenv("HETU_AUTOTUNE", "0")


def test_neg_inf_pinned_to_the_reference_kernel():
    assert fa.NEG_INF == pk.NEG_INF == -1e30


@pytest.mark.parametrize("s,mask_kind,causal", [
    (64, None, False),
    (64, None, True),
    (64, "pad", False),
    (64, "pad", True),
    (64, "full_row", False),
    (64, "full_row", True),
    (512, "pad", True),     # 2 q-tiles x 1 k-tile: the causal skip
])
def test_flash_plain_matches_pallas_interpret(s, mask_kind, causal):
    q, k, v = _qkv(s=s, seed=s + bool(causal))
    mask = None if mask_kind is None else \
        _mask(2, s, valid=s * 3 // 4, full_row=mask_kind == "full_row")
    want = pk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), sm_scale=0.25,
        causal=causal, interpret=True)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    got = fa.flash_attention_plain(*t, tm, 0.25, causal)
    _close(got, want)
    # and the composed reference, with the causal mask written out
    m = tm
    if causal:
        cm = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), 0.0,
                         -1e9)[None, None]
        m = cm if m is None else m + cm
    _close(got, tattn.attention_reference(*t, m, 0.25))


def test_flash_attention_on_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(seed=3))
    before = dict(_build.launch_counts)
    out = fa.flash_attention(q, k, v, None, sm_scale=0.5, causal=True)
    torch.testing.assert_close(
        out, fa.flash_attention_plain(q, k, v, None, 0.5, True),
        rtol=0, atol=0)
    assert dict(_build.launch_counts) == before, \
        "a CPU call counted a kernel launch"


@pytest.mark.parametrize("s,d,causal", [(4, 8, False), (4, 8, True),
                                        (260, 16, True), (16, 12, False)])
def test_unsupported_shapes_take_the_composed_reference(s, d, causal):
    """``_supported`` as in the reference: s < 8, d % 8, or S not
    divisible by the tiles route to attention_reference."""
    assert not fa._supported(s, d, *fa._block_sizes(s, d))
    assert fa._block_sizes(s, d) == pk._block_sizes(s, d)
    q, k, v = _qkv(b=1, h=2, s=s, d=d, seed=s)
    want = pk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), None, sm_scale=0.5,
                              causal=causal, interpret=True)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             None, sm_scale=0.5, causal=causal)
    _close(got, want)


@pytest.mark.parametrize("s", [6, 32])
def test_prefill_attention_matches_reference(s):
    q, k, v = _qkv(s=s, seed=11)
    want = jattn.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), sm_scale=0.25)
    got = tattn.prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  sm_scale=0.25)
    _close(got, want)


def test_decode_attention_matches_reference():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 3, 8).astype(np.float32)
    kc, vc = (rng.randn(2, 3, 20, 8).astype(np.float32) for _ in range(2))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), 11, 0.3)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), 11, 0.3)
    _close(got, want)


@pytest.mark.parametrize("flat", [False, True])
def test_paged_attention_helpers_match_reference(flat):
    rng = np.random.RandomState(6)
    nb, bs, h, d = 9, 4, 3, 8
    kp, vp = (rng.randn(nb, bs, h, d).astype(np.float32) for _ in range(2))
    if flat:
        kp, vp = kp.reshape(-1, h, d), vp.reshape(-1, h, d)
    slots = rng.randint(0, nb * bs, (2, 16)).astype(np.int64)
    positions = np.array([5, 15], np.int64)
    q1 = rng.randn(2, h, d).astype(np.float32)
    want = jattn.paged_decode_attention(
        jnp.asarray(q1), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(slots, jnp.int32), jnp.asarray(positions, jnp.int32),
        0.4)
    got = tattn.paged_decode_attention(
        torch.from_numpy(q1), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(slots), torch.from_numpy(positions), 0.4)
    _close(got, want)
    qc = rng.randn(2, 5, h, d).astype(np.float32)
    starts = np.array([0, 9], np.int64)
    want = jattn.paged_prefill_attention(
        jnp.asarray(qc), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(slots, jnp.int32), jnp.asarray(starts, jnp.int32), 0.4)
    got = tattn.paged_prefill_attention(
        torch.from_numpy(qc), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(slots), torch.from_numpy(starts), 0.4)
    _close(got, want)
