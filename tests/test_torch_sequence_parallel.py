"""Sequence parallelism in the port: the ring and Ulysses attention ops
against the JAX package's on a CPU mesh of the same size.

Each rank is a thread with gloo groups of its own
(tests/torch_tp_util.py); the executor gets ``mesh=`` an ``{"sp": n}``
:class:`~hetu_tpu_torch.parallel.mesh.Mesh` over them. The JAX side runs
the same graph with ``HetuConfig(mesh=...)`` over n of its 8 host
devices (tests/conftest.py), its sequence-parallel ops a ``shard_map``.
The twins are those of tests/test_sequence_parallel.py's op cases, at
its tolerances: losses rtol 1e-4, weights rtol 1e-3 / atol 1e-5; the
blocked attention at rtol 2e-4 / atol 1e-5. On the CPU the port's blocks
run the plain versions of K2, K3 and K4 where the kernels take the
shape, the composed arithmetic elsewhere (odd lengths). The ring's
output and gradients are in test_torch_sequence_parallel_ring.py, the
models in test_torch_sequence_parallel_models.py, the mesh in
test_torch_sequence_parallel_mesh.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import hetu_tpu as jht
from hetu_tpu.parallel import ring as jring
from hetu_tpu.parallel import ulysses as julysses
import hetu_tpu_torch as tht
from hetu_tpu_torch.parallel import ring as tring
from hetu_tpu_torch.parallel import ulysses as tulysses

from torch_sp_util import (LOSS_RTOL, SP, W_ATOL, W_RTOL,  # noqa: F401
                           jax_exe, one_intra_op_thread, port_ranks,
                           run_steps, value)

# ---------------------------------------------------------------------------
# tests/test_sequence_parallel.py's ops through a training step
# ---------------------------------------------------------------------------

def _qkv_values(seed, b, h, s, d, masked=False):
    rng = np.random.RandomState(seed)
    vals = [rng.randn(b, h, s, d).astype(np.float32) * 0.3 for _ in range(3)]
    mask = np.where(rng.rand(b, 1, 1, s) < 0.2, -1e9, 0.0).astype(
        np.float32) if masked else None
    return vals, mask


def _attn_graph(ht, op_name, vals, mask, causal, train=True):
    q, k, v = (ht.Variable(f"sp_{n}", value=x) for n, x in zip("qkv", vals))
    m = None if mask is None else ht.Variable("sp_m", value=mask,
                                              trainable=False)
    out = getattr(ht, op_name)(q, k, v, mask=m, sm_scale=0.35,
                               causal=causal)
    loss = ht.reduce_mean_op(ht.reduce_sum_op(out * out, [1, 2, 3]), [0])
    nodes = [loss]
    if train:
        nodes.append(ht.optim.SGDOptimizer(0.1).minimize(loss))
    return nodes, (q, k, v)


# (op, seed, heads, length, masked, causal, the parameter compared,
# trained): tests/test_sequence_parallel.py's cases
OP_CASES = {
    "ring": ("ring_attention_op", 0, 2, 256, False, False, 0, True),
    "causal_ring": ("ring_attention_op", 7, 2, 256, True, True, 1, True),
    "ulysses": ("ulysses_attention_op", 4, 8, 256, False, False, 0, True),
    "ulysses_masked": ("ulysses_attention_op", 5, 8, 128, True, False, 0,
                       False),
    "causal_ulysses": ("ulysses_attention_op", 8, 8, 256, False, True, 2,
                       True),
}


@pytest.mark.parametrize("sp", SP)
@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_matches_the_jax_packages_sp_run(case, sp):
    """The op on an sp mesh of n ranks against the JAX package's on n
    host devices, 3 SGD steps (the forward alone for the masked
    Ulysses case): losses rtol 1e-4, the compared q/k/v after the steps
    rtol 1e-3 / atol 1e-5, and the same on every rank."""
    op, seed, h, s, masked, causal, which, train = OP_CASES[case]
    vals, mask = _qkv_values(seed, 2, h, s, 8, masked)
    steps = 3 if train else 1
    nodes, params = _attn_graph(jht, op, vals, mask, causal, train)
    jexe = jax_exe(nodes, {"sp": sp})
    want = run_steps(jexe, steps)
    want_w = value(jexe, params[which])

    def run(exe, built):
        return run_steps(exe, steps), value(exe, built[1][which])

    results = port_ranks({"sp": sp}, lambda ht: _attn_graph(
        ht, op, vals, mask, causal, train), run)
    for got, got_w in results:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got_w, want_w, rtol=W_RTOL, atol=W_ATOL)
        np.testing.assert_array_equal(got_w, results[0][1])


@pytest.mark.parametrize("op", ["ring_attention_op", "ulysses_attention_op"])
def test_off_an_sp_mesh_the_op_is_the_fused_path(op):
    """Without an "sp" mesh axis the op is FlashAttentionOp (bit for bit,
    forward and a training step), and its loss the JAX package's
    off-mesh one."""
    vals, _ = _qkv_values(6, 1, 4, 64, 8)
    nodes, _ = _attn_graph(tht, op, vals, None, False)
    got = run_steps(tht.Executor(nodes, ctx=tht.cpu(0)), 2)
    nodes, _ = _attn_graph(tht, "flash_attention_op", vals, None, False)
    assert got == run_steps(tht.Executor(nodes, ctx=tht.cpu(0)), 2)
    jnodes, _ = _attn_graph(jht, op, vals, None, False)
    np.testing.assert_allclose(got, run_steps(jax_exe(jnodes), 2), rtol=1e-5)


# ---------------------------------------------------------------------------
# the pieces: zigzag layout, the composed blocked attention, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,n", [(64, 4), (256, 2), (1024, 2), (96, 3)])
def test_zigzag_indices_match_the_jax_packages(s, n):
    perm, inv = tring.zigzag_indices(s, n)
    jperm, jinv = jring.zigzag_indices(s, n)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(perm[inv], np.arange(s))
    c = s // (2 * n)
    np.testing.assert_array_equal(
        perm[:2 * c], np.concatenate([np.arange(0, c),
                                      np.arange((2 * n - 1) * c, 2 * n * c)]))


def test_zigzag_indices_refuse_an_indivisible_length():
    with pytest.raises(ValueError, match="divisible by 2\\*sp axis"):
        tring.zigzag_indices(100, 8)


@pytest.mark.parametrize("causal", [False, True])
def test_blocked_attention_pads_odd_lengths(causal):
    """The composed blocked attention at S=300 in blocks of 256 (a padded
    tail) against the JAX package's ``_blocked_attention`` (rtol 2e-4,
    atol 1e-5); its adjoint against autograd through it."""
    import torch
    vals, _ = _qkv_values(9, 1, 2, 300, 8)
    want = np.asarray(julysses._blocked_attention(
        *(jnp.asarray(x) for x in vals), 0.35, None, block=256,
        causal=causal))
    q, k, v = (torch.tensor(x, requires_grad=True) for x in vals)
    o, lse = tulysses.blocked_attention(q, k, v, 0.35, None, block=256,
                                        causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), want, rtol=2e-4,
                               atol=1e-5)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    auto = torch.autograd.grad(o, (q, k, v), do)
    mine = tulysses.blocked_attention_bwd(q.detach(), k.detach(), v.detach(),
                                          0.35, None, o.detach(),
                                          lse.detach(), do, block=256,
                                          causal=causal)
    for a, m in zip(auto, mine):
        np.testing.assert_allclose(m.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("op,s", [("ring_attention_op", 600),
                                  ("ulysses_attention_op", 300)])
def test_odd_lengths_take_the_composed_blocks(op, s):
    """Lengths K2's tiles do not divide, on 2 ranks: the ring's 300-row
    shards of S=600 and Ulysses' whole S=300 take the composed
    arithmetic, counted; the losses and weights after 3 SGD steps are
    the JAX package's."""
    vals, mask = _qkv_values(11, 2, 4, s, 8, masked=True)
    nodes, params = _attn_graph(jht, op, vals, mask, False)
    jexe = jax_exe(nodes, {"sp": 2})
    want, want_q = run_steps(jexe, 3), value(jexe, params[0])
    tring.reset_composed_blocks()
    results = port_ranks(
        {"sp": 2}, lambda ht: _attn_graph(ht, op, vals, mask, False),
        lambda exe, b: (run_steps(exe, 3), value(exe, b[1][0])))
    for got, got_q in results:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got_q, want_q, rtol=W_RTOL, atol=W_ATOL)
    where = op.split("_")[0]
    assert tring.composed_blocks[f"{where}.fwd"] > 0
    assert tring.composed_blocks[f"{where}.bwd"] > 0


def test_ulysses_refuses_heads_indivisible_by_the_axis():
    vals, _ = _qkv_values(2, 1, 2, 64, 8)
    with pytest.raises(ValueError, match=r"heads \(2\) divisible by the "
                                         r"sp axis \(4\)"):
        port_ranks({"sp": 4}, lambda ht: _attn_graph(
            ht, "ulysses_attention_op", vals, None, False, train=False),
            lambda exe, b: run_steps(exe, 1))


def test_ring_refuses_a_length_indivisible_by_the_axis():
    vals, _ = _qkv_values(2, 1, 2, 66, 8)
    with pytest.raises(ValueError, match=r"divisible by the sp axis"):
        port_ranks({"sp": 4}, lambda ht: _attn_graph(
            ht, "ring_attention_op", vals, None, False, train=False),
            lambda exe, b: run_steps(exe, 1))
