"""Kernels K2 (flash_fwd.cu with lse), K3 and K4 (flash_bwd_tc.cu for
bf16 at D in (64, 128), flash_bwd.cu otherwise) against their plain
PyTorch versions on the card. Marked ``cuda``: they skip
without a GPU. Import neither JAX nor hetu_tpu, so they run on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_bwd_cuda.py

Tolerance (atol = rtol): float32 1e-4 for o, lse, dq, dk, dv (the
kernel and the plain version sum in different orders); bfloat16 2e-2
for o (one rounding of p and of the output) and 5e-2 for the gradients
(p and dS each rounded to bf16 before a product, sums over S); each
gradient row also within 1e-4 / 2e-2 of its own 2-norm plus 1e-3 of the
tensor's largest row, so late causal rows, ~1e-2 the size of the early
ones, are held to their own size. The padding mask leaves every row some unmasked key: a fully masked row
has p = exp(s - lse) = 1 for every key under the reference's formula
(s and lse both round to -1e9), which the tests do not pin.
"""
import pytest
import torch

from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import flash_attention as fa

FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
BWD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_ROW_FLOOR = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(b, h, s, d, dtype, masked, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=device)
                   .to(dtype) for _ in range(4))
    mask = None
    if masked:
        mask = torch.zeros(b, 1, 1, s, device=device)
        mask[0, ..., s // 2:] = -1e9
        mask[-1, ..., 3 * s // 4:] = -1e9
    return q, k, v, do, mask


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _close_grad(got, want, dtype):
    _close(got, want, BWD_TOL[dtype])
    size = want.float().norm(dim=-1)
    diff = (got.float() - want.float()).norm(dim=-1)
    worst = float((diff / (size + BWD_ROW_FLOOR * size.max() + 1e-30)).max())
    assert worst <= BWD_ROW_TOL[dtype], worst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,h,s,d", [(1, 12, 8, 64), (2, 4, 128, 64),
                                     (2, 3, 520, 64), (1, 4, 512, 128),
                                     (1, 2, 256, 256), (2, 3, 64, 8)])
def test_flash_lse_and_bwd_kernels_match_plain(cuda, b, h, s, d, dtype,
                                               causal, masked):
    q, k, v, do, mask = _inputs(b, h, s, d, dtype, masked, seed=s + d,
                                device=cuda)
    scale = d ** -0.5
    before = dict(_build.launch_counts)
    o, lse = fa.flash_attention_with_lse(q, k, v, mask, scale, causal)
    grads = fa.flash_attention_bwd(q, k, v, mask, o, lse, do, scale, causal)
    torch.cuda.synchronize()
    route = fa._bwd_route(dtype, d)
    for key in (fa.K2, fa.K3, fa.K4, f"{fa.K3}.{route}", f"{fa.K4}.{route}"):
        assert _build.launch_counts[key] == before.get(key, 0) + 1, key
    assert _build.launch_counts[fa.K1] == before.get(fa.K1, 0)
    ro, rlse = fa.flash_attention_with_lse_plain(q, k, v, mask, scale,
                                                 causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    _close(o, ro, FWD_TOL[dtype])
    _close(lse, rlse, FWD_TOL[dtype])
    # the plain backward from the kernel's own residuals: this isolates
    # K3/K4 from K2's rounding
    want = fa.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, scale,
                                        causal)
    for g, w in zip(grads, want):
        assert g.dtype == dtype and g.shape == q.shape
        _close_grad(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,d,masked,causal", [
    (2, 4, 1024, 64, False, True), (1, 4, 520, 128, True, False),
    (2, 3, 520, 64, True, True)])
def test_tc_route_k3_k4_match_plain(cuda, b, h, s, d, masked, causal):
    # bf16 at D in (64, 128): wgmma + TMA (flash_bwd_tc.cu), K4 computing
    # the D that K3 reads; S = 520 leaves a ragged last tile of each head
    dtype = torch.bfloat16
    q, k, v, do, mask = _inputs(b, h, s, d, dtype, masked, seed=s + d + 1,
                                device=cuda)
    scale = d ** -0.5
    o, lse = fa.flash_attention_with_lse(q, k, v, mask, scale, causal)
    bwd = (q, k, v, mask, o, lse, do, scale, causal)
    before = dict(_build.launch_counts)
    grads = fa.flash_attention_bwd(*bwd)
    torch.cuda.synchronize()
    for key, n in ((fa.K3, 1), (fa.K4, 1), (f"{fa.K3}.tc", 1),
                   (f"{fa.K4}.tc", 1), (f"{fa.K3}.simt", 0),
                   (f"{fa.K4}.simt", 0)):
        assert _build.launch_counts[key] == before.get(key, 0) + n, key
    want = fa.flash_attention_bwd_plain(*bwd)
    for g, w in zip(grads, want):
        assert g.dtype == dtype and g.shape == q.shape
        _close_grad(g, w, dtype)
    # each kernel alone: K3 with D from the torch reduction, K4 with its own
    alone = (fa.flash_attention_bwd_dq(*bwd), *fa.flash_attention_bwd_dkv(*bwd))
    for g, w in zip(alone, want):
        _close_grad(g, w, dtype)


@pytest.mark.cuda
def test_tc_route_k2_k4_at_the_bert_s2048_shape(cuda):
    # BERT-small at S=2048: bf16 B=8 H=8 D=64, non-causal, each row
    # padded past a length drawn from [S/2, S] with BERT's bf16 mask
    # ((m - 1) * 10000: -9984): 32 q and 32 k tiles a head
    b, h, s, d, dtype = 8, 8, 2048, 64, torch.bfloat16
    q, k, v, do, _ = _inputs(b, h, s, d, dtype, False, seed=11,
                             device=cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    lengths = torch.randint(s // 2, s + 1, (b, 1), generator=g, device=cuda)
    keep = (torch.arange(s, device=cuda)[None] < lengths).to(dtype)
    mask = ((keep - 1) * 10000).view(b, 1, 1, s)
    scale = d ** -0.5
    before = dict(_build.launch_counts)
    o, lse = fa.flash_attention_with_lse(q, k, v, mask, scale, False)
    bwd = (q, k, v, mask, o, lse, do, scale, False)
    grads = fa.flash_attention_bwd(*bwd)
    torch.cuda.synchronize()
    for key in (fa.K2, fa.K3, fa.K4):
        assert _build.launch_counts[f"{key}.tc"] == \
            before.get(f"{key}.tc", 0) + 1, key
    ro, rlse = fa.flash_attention_with_lse_plain(q, k, v, mask, scale, False)
    _close(o, ro, FWD_TOL[dtype])
    _close(lse, rlse, FWD_TOL[dtype])
    for g_, w in zip(grads, fa.flash_attention_bwd_plain(*bwd)):
        assert g_.dtype == dtype and g_.shape == q.shape
        _close_grad(g_, w, dtype)


@pytest.mark.cuda
def test_flash_bwd_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 16, 64, device=cuda, dtype=torch.float16)
    lse = torch.zeros(1, 1, 16, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q)
    q = torch.zeros(1, 1, 16, 264, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, None, q, lse, q)
    q = torch.zeros(1, 1, 16, 64, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, None, q, lse[..., :8], q)
