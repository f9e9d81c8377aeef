"""Kernels K1 and K2 (hetu_tpu_torch/ops/csrc/flash_fwd_tc.cu for bf16 at
D in (64, 128), flash_fwd.cu otherwise) against their plain PyTorch
versions on the card. Marked ``cuda``: it skips without a GPU. Imports
neither JAX nor hetu_tpu, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_cuda.py

Tolerance: atol = rtol = 1e-4 in float32 (the kernel and the plain
version sum in different orders), 2e-2 in bfloat16 (one bf16 rounding
of p and of the output).
"""
import pytest
import torch

from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import flash_attention as fa
from hetu_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(b, h, s, d, dtype, masked, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=device)
               .to(dtype) for _ in range(3))
    mask = None
    if masked:
        mask = torch.zeros(b, 1, 1, s, device=device)
        mask[0, ..., s // 2:] = -1e9
        if b > 1:
            mask[-1] = -1e9             # every key of this row masked
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,h,s,d", [(1, 12, 8, 64), (4, 12, 128, 64),
                                     (2, 4, 512, 128), (1, 2, 256, 256),
                                     (2, 3, 64, 8)])
def test_flash_fwd_kernel_matches_plain(cuda, b, h, s, d, dtype, causal,
                                        masked):
    q, k, v, mask = _inputs(b, h, s, d, dtype, masked, seed=s + d,
                            device=cuda)
    before = dict(_build.launch_counts)
    out = flash_attention(q, k, v, mask, sm_scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    route = fa._fwd_route(dtype, d)
    for key in (fa.K1, f"{fa.K1}.{route}"):
        assert _build.launch_counts[key] == before.get(key, 0) + 1, key
    ref = flash_attention_plain(q, k, v, mask, d ** -0.5, causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,d,masked,causal", [
    (2, 4, 1024, 64, False, True), (1, 4, 520, 128, True, False),
    (4, 12, 128, 64, True, True)])
def test_tc_route_k1_k2_match_plain(cuda, b, h, s, d, masked, causal):
    # bf16 at D in (64, 128): wgmma + TMA (flash_fwd_tc.cu). S = 520
    # leaves a ragged last tile of each head; with b = 4 the mask of the
    # last batch element hides every key of its rows
    dtype = torch.bfloat16
    q, k, v, mask = _inputs(b, h, s, d, dtype, masked, seed=s + d + 1,
                            device=cuda)
    scale = d ** -0.5
    before = dict(_build.launch_counts)
    out = flash_attention(q, k, v, mask, scale, causal)
    o, lse = fa.flash_attention_with_lse(q, k, v, mask, scale, causal)
    torch.cuda.synchronize()
    for key, n in ((fa.K1, 1), (f"{fa.K1}.tc", 1), (f"{fa.K1}.simt", 0),
                   (fa.K2, 1), (f"{fa.K2}.tc", 1), (f"{fa.K2}.simt", 0)):
        assert _build.launch_counts[key] == before.get(key, 0) + n, key
    ro, rlse = fa.flash_attention_with_lse_plain(q, k, v, mask, scale,
                                                 causal)
    assert out.dtype == o.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    tol = TOL[dtype]
    for got, want in ((out, ro), (o, ro), (lse, rlse)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def _padding_mask(b, s, dtype, g, device):
    # BERT's mask as its bf16 graph builds it: (m - 1) * 10000, each row
    # keeping a length drawn from [S/2, S] (a padded key carries -9984)
    lengths = torch.randint(s // 2, s + 1, (b, 1), generator=g,
                            device=device)
    keep = (torch.arange(s, device=device)[None] < lengths).to(dtype)
    return ((keep - 1) * 10000).view(b, 1, 1, s)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_tc_route_k1_at_the_bert_base_shape(cuda, causal):
    # BERT-base's attention: bf16 B=64 H=12 S=128 D=64 under the padding
    # mask, 768 (batch, head) rows over 64 mask rows
    b, h, s, d, dtype = 64, 12, 128, 64, torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    mask = _padding_mask(b, s, dtype, g, cuda)
    before = dict(_build.launch_counts)
    out = flash_attention(q, k, v, mask, d ** -0.5, causal)
    torch.cuda.synchronize()
    for key, n in ((fa.K1, 1), (f"{fa.K1}.tc", 1), (f"{fa.K1}.simt", 0)):
        assert _build.launch_counts[key] == before.get(key, 0) + n, key
    ref = flash_attention_plain(q, k, v, mask, d ** -0.5, causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
def test_flash_fwd_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros(1, 1, 16, 264, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
