"""``IndexedSlices``' row sums (``ndarray._sum_rows``): a stable sort and
a segment sum on every device, so a repeated index adds its rows in the
order they came. On the CPU that is ``index_add_``'s order; on the card
two runs of one step give the same bits (``cuda``-marked; skips without
a GPU)."""
import numpy as np
import pytest
import torch

from hetu_tpu_torch.ndarray import IndexedSlices, _sum_rows


def _inputs(n_rows, n_idx, width, dtype, device="cpu", seed=0):
    rng = np.random.RandomState(seed)
    # few distinct indices, so most rows land on a repeated one
    idx = torch.from_numpy(rng.randint(0, n_rows, n_idx)).to(device)
    rows = torch.from_numpy(rng.randn(n_idx, width).astype(np.float32))
    return idx, rows.to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sum_rows_is_index_add_on_the_cpu(dtype):
    idx, rows = _inputs(7, 500, 16, dtype)
    want = torch.zeros(9, 16, dtype=dtype).index_add_(0, idx, rows)
    got = _sum_rows(idx, rows, 9)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_sum_rows_of_16_bit_rows_sums_in_f32():
    idx, rows = _inputs(3, 400, 8, torch.bfloat16)
    want = torch.zeros(5, 8).index_add_(0, idx, rows.float())
    got = _sum_rows(idx, rows, 5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_dedup_and_to_dense_sum_repeated_rows():
    idx, rows = _inputs(6, 64, 4, torch.float32)
    grad = IndexedSlices(idx.reshape(8, 8), rows.reshape(8, 8, 4), (10, 4))
    dense = torch.zeros(10, 4).index_add_(0, idx, rows)
    assert torch.equal(grad.to_dense(), dense)
    uniq, summed = grad.dedup()
    assert torch.equal(uniq, torch.unique(idx))
    assert torch.equal(summed, dense[uniq])
    empty = _sum_rows(torch.zeros(0, dtype=torch.int64), torch.zeros(0, 3), 4)
    assert torch.equal(empty, torch.zeros(4, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repeated_rows_sum_to_the_same_bits_on_the_card(dtype):
    """BERT's 2-row token-type table takes 16,384 lookups a step; two runs
    of such a sum on the card give equal bits, within f32 rounding of
    the CPU's sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, rows = _inputs(2, 16384, 512, dtype, "cuda")
    first = _sum_rows(idx, rows, 2)
    for _ in range(3):
        assert torch.equal(_sum_rows(idx, rows, 2), first)
    want = torch.zeros(2, 512, dtype=torch.float64).index_add_(
        0, idx.cpu(), rows.cpu().double())
    err = (first.cpu().double() - want).abs().max().item()
    assert err <= (1e-2 if dtype == torch.bfloat16 else 1e-3) * \
        want.abs().max().item()
