"""Kernel K1 (hetu_tpu_torch/ops/csrc/flash_fwd.cu) against its plain
PyTorch version on the card. Marked ``cuda``: it skips without a GPU.
Imports neither JAX nor hetu_tpu, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_cuda.py

Tolerance: atol = rtol = 1e-4 in float32 (the kernel and the plain
version sum in different orders), 2e-2 in bfloat16 (one bf16 rounding
of p and of the output).
"""
import pytest
import torch

from hetu_tpu_torch.ops import _build
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
    before = _build.launch_counts["flash_fwd"]
    out = flash_attention(q, k, v, mask, sm_scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == before + 1
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
