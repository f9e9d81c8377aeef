"""Flash-attention forward: the hand-written CUDA kernel K1 and its
plain PyTorch version.

Counterpart of ``hetu_tpu/ops/pallas_attention.py`` (forward without
the logsumexp residual). :func:`flash_attention` computes
``softmax(q k^T * sm_scale + mask) v`` over ``[B, H, S, D]``:

* on CUDA tensors it launches ``csrc/flash_fwd.cu`` (built on first
  use by :mod:`._build`) or raises — there is no fallback from the
  kernel;
* on CPU tensors it runs :func:`flash_attention_plain`, the same
  blocked online-softmax loop written in PyTorch over the reference's
  own tiles (``_block_sizes``);
* shapes the reference kernel does not take (``_supported``: S < 8,
  D % 8, S not divisible by the tiles) take the composed
  ``attention_reference`` on every device, as the reference does.

``mask`` is an additive padding mask broadcastable to ``[B, 1, 1, S]``;
causality is the ``causal`` flag, masked with :data:`NEG_INF`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "NEG_INF"]

# the reference kernel's masked-score value (pallas_attention.py:44);
# the composed paths use -1e9 instead
NEG_INF = -1e30

_KERNEL = "flash_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256


def _block_sizes(seq_len, head_dim):
    """The reference kernel's default tiles (bq <= 256, bk <= 512)."""
    bq = min(256, seq_len)
    while seq_len % bq:
        bq //= 2
    bk = min(512, seq_len)
    while seq_len % bk:
        bk //= 2
    return max(bq, 8), max(bk, 8)


def _supported(s, d, block_q, block_k):
    return not (s < 8 or d % 8 or s % block_q or s % block_k)


def _mask_rows(mask, b, h, s):
    """[B, 1, 1, S]-broadcastable additive mask -> [B, S] f32 rows."""
    return mask.expand(b, 1, 1, s).reshape(b, s).to(torch.float32) \
        .contiguous()


def flash_attention(q, k, v, mask=None, sm_scale=1.0, causal=False):
    """softmax(q k^T * sm_scale + mask) v over [B, H, S, D] q/k/v."""
    from .attention import attention_reference
    b, h, s, d = q.shape
    if not _supported(s, d, *_block_sizes(s, d)):
        m = mask
        if causal:
            cmask = torch.where(
                torch.ones(s, s, dtype=torch.bool, device=q.device).tril(),
                0.0, NEG_INF)[None, None]
            m = cmask if m is None else m + cmask
        return attention_reference(q, k, v, m, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, sm_scale, causal)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device "
                           f"{q.device}")
    return _flash_attention_cuda(q, k, v, mask, sm_scale, causal)


def flash_attention_plain(q, k, v, mask=None, sm_scale=1.0, causal=False):
    """The kernel's arithmetic in plain PyTorch: per q-tile, stream the
    K/V tiles with a running max, sum and f32 accumulator, stopping at
    the diagonal under ``causal``. Dots take the input values with f32
    accumulation and ``p`` is rounded to ``v``'s dtype before ``p v``,
    as in the reference kernel. Takes supported shapes only."""
    b, h, s, d = q.shape
    bq, bk = _block_sizes(s, d)
    if not _supported(s, d, bq, bk):
        raise ValueError(f"flash_attention_plain: unsupported shape "
                         f"S={s}, D={d}")
    qr = q.reshape(b * h, s, d).to(torch.float32)
    kr = k.reshape(b * h, s, d).to(torch.float32)
    vr = v.reshape(b * h, s, d).to(torch.float32)
    rows = None
    if mask is not None:
        rows = _mask_rows(mask, b, h, s).repeat_interleave(h, dim=0)
    out = torch.empty(b * h, s, d, dtype=q.dtype, device=q.device)
    for qi in range(s // bq):
        qb = qr[:, qi * bq:(qi + 1) * bq]
        num_kb = s // bk
        if causal:
            num_kb = min(num_kb, -(-(qi + 1) * bq // bk))
        m = torch.full((b * h, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b * h, bq, 1), device=q.device)
        acc = torch.zeros((b * h, bq, d), device=q.device)
        for i in range(num_kb):
            kb = kr[:, i * bk:(i + 1) * bk]
            vb = vr[:, i * bk:(i + 1) * bk]
            sc = torch.matmul(qb, kb.transpose(1, 2)) * sm_scale
            if rows is not None:
                sc = sc + rows[:, None, i * bk:(i + 1) * bk]
            if causal:
                q_pos = qi * bq + torch.arange(bq, device=q.device)
                k_pos = i * bk + torch.arange(bk, device=q.device)
                sc = torch.where(q_pos[:, None] >= k_pos[None, :], sc,
                                 NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                p.to(v.dtype).to(torch.float32), vb)
            m = m_new
        out[:, qi * bq:(qi + 1) * bq] = (acc / l).to(q.dtype)
    return out.reshape(b, h, s, d)


def _flash_attention_cuda(q, k, v, mask, sm_scale, causal):
    b, h, s, d = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_fwd needs q, k, v of one shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    if d > _MAX_D:
        raise ValueError(f"flash_fwd takes head dim <= {_MAX_D}, got {d}")
    if not (k.device == q.device == v.device):
        raise ValueError("flash_fwd: q, k, v on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    rows = None
    if mask is not None:
        rows = _mask_rows(mask.to(q.device), b, h, s)
    out = torch.empty_like(q)
    lib = _build.load(_KERNEL)
    fn = lib.hetu_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                rows.data_ptr() if rows is not None else None,
                out.data_ptr(), b * h, h, s, d, float(sm_scale),
                int(bool(causal)), _DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, _KERNEL, rc)
    _build.launch_counts[_KERNEL] += 1
    return out
