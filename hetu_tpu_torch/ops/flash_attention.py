"""Flash attention: the hand-written CUDA kernels K1–K4 and their plain
PyTorch versions.

Counterpart of ``hetu_tpu/ops/pallas_attention.py``. Over ``[B, H, S,
D]`` q/k/v:

* :func:`flash_attention` (K1) computes ``softmax(q k^T * sm_scale +
  mask) v``;
* :func:`flash_attention_with_lse` (K2) also returns the per-row
  logsumexp ``lse = m + log(l)`` as f32 ``[B, H, S]`` — the residual of
  the fused backward (the same kernels as K1, with their lse output
  set). Two sources implement K1 and K2, and :func:`_fwd_route` alone
  picks one per call: ``"tc"`` (``csrc/flash_fwd_tc.cu``: bf16 products
  on the tensor cores with ``wgmma``, K/V staged by TMA) for bf16 at D
  in (64, 128), ``"simt"`` (``csrc/flash_fwd.cu``, exact f32 on the
  CUDA cores, K/V staged by ``cp.async``) for the rest;
* :func:`flash_attention_bwd` (K3 + K4) recomputes the score tiles from
  ``lse`` and returns ``(dq, dk, dv)``: K3 per K/V tile, K4 per Q tile,
  so dQ needs no atomics and the split stays deterministic. Two
  sources implement them, and :func:`_bwd_route` alone picks one per
  call from the dtype and head dim: ``"tc"`` (``csrc/flash_bwd_tc.cu``:
  bf16 products on the tensor cores with ``wgmma``, tiles staged by
  TMA) for bf16 at D in (64, 128), ``"simt"`` (``csrc/flash_bwd.cu``,
  f32 on the CUDA cores) for the rest.

Each entry point

* on CUDA tensors launches its kernel (built on first use by
  :mod:`._build`) or raises — there is no fallback from the kernel;
* on CPU tensors runs its ``*_plain`` version: the same blocked loops
  written in PyTorch over the reference's own tiles (``_block_sizes``),
  rounding where the reference rounds;
* on shapes the reference kernel does not take (``_supported``: S < 8,
  D % 8, S not divisible by the tiles): K1 takes the composed
  ``attention_reference`` and K2 returns ``(None, None)`` on every
  device, as the reference does.

``mask`` is an additive padding mask broadcastable to ``[B, 1, 1, S]``;
causality is the ``causal`` flag, masked with :data:`NEG_INF`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_with_lse", "flash_attention_with_lse_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "NEG_INF", "K1", "K2", "K3", "K4"]

# the reference kernel's masked-score value (pallas_attention.py:44);
# the composed paths use -1e9 instead
NEG_INF = -1e30

# launch-count keys of the four kernels (``_build.launch_counts``); each
# launch also counts under ``f"{key}.{route}"`` (see _fwd_route,
# _bwd_route)
K1, K2, K3, K4 = "flash_fwd", "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"

_FWD_LIBS = {"simt": "flash_fwd", "tc": "flash_fwd_tc"}
_BWD_LIBS = {"simt": "flash_bwd", "tc": "flash_bwd_tc"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
# head dims the tensor-core kernels are instantiated for
_TC_HEAD_DIMS = (64, 128)


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


def _causal_keep(q0, nq, k0, nk, device):
    q_pos = q0 + torch.arange(nq, device=device)
    k_pos = k0 + torch.arange(nk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _scores(qb, kb, rows, k0, bk, sm_scale, causal, q0):
    """One [BH, bq, bk] f32 score tile as the reference kernel builds it:
    q k^T * scale, + the mask row, NEG_INF above the diagonal."""
    sc = torch.matmul(qb, kb.transpose(1, 2)) * sm_scale
    if rows is not None:
        sc = sc + rows[:, None, k0:k0 + bk]
    if causal:
        sc = torch.where(_causal_keep(q0, qb.shape[1], k0, bk, qb.device),
                         sc, NEG_INF)
    return sc


def _plain_inputs(q, k, v, mask, what):
    b, h, s, d = q.shape
    bq, bk = _block_sizes(s, d)
    if not _supported(s, d, bq, bk):
        raise ValueError(f"{what}: unsupported shape S={s}, D={d}")
    f32 = [x.reshape(b * h, s, d).to(torch.float32) for x in (q, k, v)]
    rows = None
    if mask is not None:
        rows = _mask_rows(mask, b, h, s).repeat_interleave(h, dim=0)
    return (b, h, s, d, bq, bk, *f32, rows)


# ---------------------------------------------------------------------------
# forward: K1 (output) and K2 (output + logsumexp)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, mask=None, sm_scale=1.0, causal=False):
    """softmax(q k^T * sm_scale + mask) v over [B, H, S, D] q/k/v (K1)."""
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
    _require_cuda(q, "flash_attention")
    return _flash_fwd_cuda(q, k, v, mask, sm_scale, causal, want_lse=False)


def flash_attention_with_lse(q, k, v, mask=None, sm_scale=1.0,
                             causal=False):
    """(output, logsumexp f32 [B, H, S]) — the pair the fused backward
    needs (K2). Returns (None, None) on shapes the kernel does not
    support; callers then take the composed path for both directions."""
    b, h, s, d = q.shape
    if not _supported(s, d, *_block_sizes(s, d)):
        return None, None
    if q.device.type == "cpu":
        return flash_attention_with_lse_plain(q, k, v, mask, sm_scale,
                                              causal)
    _require_cuda(q, "flash_attention_with_lse")
    return _flash_fwd_cuda(q, k, v, mask, sm_scale, causal, want_lse=True)


def flash_attention_plain(q, k, v, mask=None, sm_scale=1.0, causal=False):
    """K1's arithmetic in plain PyTorch (the output of
    :func:`flash_attention_with_lse_plain`). Takes supported shapes
    only."""
    return flash_attention_with_lse_plain(q, k, v, mask, sm_scale,
                                          causal)[0]


def flash_attention_with_lse_plain(q, k, v, mask=None, sm_scale=1.0,
                                   causal=False):
    """The forward kernel's arithmetic in plain PyTorch: per q-tile,
    stream the K/V tiles with a running max, sum and f32 accumulator,
    stopping at the diagonal under ``causal``. Dots take the input
    values with f32 accumulation and ``p`` is rounded to ``v``'s dtype
    before ``p v``, as in the reference kernel; ``lse = m + log(l)``
    per row, f32. Takes supported shapes only."""
    b, h, s, d, bq, bk, qr, kr, vr, rows = _plain_inputs(
        q, k, v, mask, "flash_attention_plain")
    out = torch.empty(b * h, s, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    for qi in range(s // bq):
        qb = qr[:, qi * bq:(qi + 1) * bq]
        num_kb = s // bk
        if causal:
            num_kb = min(num_kb, -(-(qi + 1) * bq // bk))
        m = torch.full((b * h, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b * h, bq, 1), device=q.device)
        acc = torch.zeros((b * h, bq, d), device=q.device)
        for i in range(num_kb):
            sc = _scores(qb, kr[:, i * bk:(i + 1) * bk], rows, i * bk, bk,
                         sm_scale, causal, qi * bq)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                p.to(v.dtype).to(torch.float32), vr[:, i * bk:(i + 1) * bk])
            m = m_new
        out[:, qi * bq:(qi + 1) * bq] = (acc / l).to(q.dtype)
        lse[:, qi * bq:(qi + 1) * bq] = (m + torch.log(l))[..., 0]
    return out.reshape(b, h, s, d), lse.reshape(b, h, s)


# ---------------------------------------------------------------------------
# fused backward: K3 (dK, dV) + K4 (dQ)
# ---------------------------------------------------------------------------

def flash_attention_bwd(q, k, v, mask, o, lse, do, sm_scale=1.0,
                        causal=False):
    """(dq, dk, dv) via the recompute-form kernels K3 and K4. ``lse`` is
    the forward's logsumexp (:func:`flash_attention_with_lse`), ``o``
    its output, ``do`` the output's adjoint."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, o, lse, do,
                                         sm_scale, causal)
    _require_cuda(q, "flash_attention_bwd")
    # K4 first: on the tc route it writes the D that K3 reads
    prep = _bwd_prepare(q, k, v, mask, o, lse, do)
    dq = _launch_dq(prep, sm_scale, causal)
    return (dq, *_launch_dkv(prep, sm_scale, causal))


def flash_attention_bwd_dkv(q, k, v, mask, o, lse, do, sm_scale=1.0,
                            causal=False):
    """(dk, dv) alone: kernel K3 (its plain version on the CPU)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, mask, o, lse, do,
                                             sm_scale, causal)
    _require_cuda(q, "flash_attention_bwd_dkv")
    prep = _bwd_prepare(q, k, v, mask, o, lse, do)
    if prep["route"] == "tc":       # no K4 before it to write D
        prep["delta"] = _pad_ld(_delta(prep["o"], prep["do"]), prep["ld"])
    return _launch_dkv(prep, sm_scale, causal)


def flash_attention_bwd_dq(q, k, v, mask, o, lse, do, sm_scale=1.0,
                           causal=False):
    """dq alone: kernel K4 (its plain version on the CPU)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, mask, o, lse, do,
                                            sm_scale, causal)
    _require_cuda(q, "flash_attention_bwd_dq")
    return _launch_dq(_bwd_prepare(q, k, v, mask, o, lse, do), sm_scale,
                      causal)


def _delta(o, do):
    """D = rowsum(dO * O) in f32 (pallas_attention.py:463-467, an XLA
    reduce outside the kernels there; here a torch reduction on the simt
    route and for K3 launched alone, computed by K4 on the tc route)."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, mask, o, lse, do, sm_scale=1.0,
                              causal=False):
    """K3 and K4's arithmetic in plain PyTorch: (dq, dk, dv)."""
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, mask, o, lse, do,
                                           sm_scale, causal)
    return (flash_attention_bwd_dq_plain(q, k, v, mask, o, lse, do,
                                         sm_scale, causal), dk, dv)


class _PlainBwd:
    """What K3's and K4's plain versions share: f32 views over the
    reference's tiles, the mask rows, lse and D, and the per-tile
    recompute of p and dS."""

    def __init__(self, q, k, v, mask, o, lse, do, sm_scale, causal):
        (self.b, self.h, self.s, self.d, self.bq, self.bk, self.qr,
         self.kr, self.vr, self.rows) = _plain_inputs(
            q, k, v, mask, "flash_attention_bwd_plain")
        bh = self.b * self.h
        self.dor = do.reshape(bh, self.s, self.d).to(torch.float32)
        self.lser = lse.reshape(bh, self.s).to(torch.float32)
        self.ddr = _delta(o, do).reshape(bh, self.s)
        self.sm_scale, self.causal = sm_scale, causal

    def tile(self, qi, kj):
        """(p, dS) of one (q-tile, k-tile) pair, both f32 and unrounded."""
        bq, bk = self.bq, self.bk
        qs, ks = slice(qi * bq, (qi + 1) * bq), slice(kj * bk, (kj + 1) * bk)
        sc = _scores(self.qr[:, qs], self.kr[:, ks], self.rows, kj * bk, bk,
                     self.sm_scale, self.causal, qi * bq)
        p = torch.exp(sc - self.lser[:, qs, None])
        dp = torch.matmul(self.dor[:, qs], self.vr[:, ks].transpose(1, 2))
        return p, p * (dp - self.ddr[:, qs, None]) * self.sm_scale


def flash_attention_bwd_dkv_plain(q, k, v, mask, o, lse, do, sm_scale=1.0,
                                  causal=False):
    """K3's arithmetic in plain PyTorch over the reference's tiles: per
    K/V tile, ``dV += p^T dO`` (p rounded to dO's dtype) and ``dK +=
    dS^T Q`` (dS rounded to q's dtype), the q loop starting at the
    diagonal under ``causal``. Takes supported shapes only."""
    t = _PlainBwd(q, k, v, mask, o, lse, do, sm_scale, causal)
    bq, bk = t.bq, t.bk
    dk = torch.empty(t.b * t.h, t.s, t.d, dtype=k.dtype, device=q.device)
    dv = torch.empty(t.b * t.h, t.s, t.d, dtype=v.dtype, device=q.device)
    for kj in range(t.s // bk):
        dk_acc = torch.zeros(t.b * t.h, bk, t.d, device=q.device)
        dv_acc = torch.zeros(t.b * t.h, bk, t.d, device=q.device)
        for qi in range((kj * bk) // bq if causal else 0, t.s // bq):
            qs = slice(qi * bq, (qi + 1) * bq)
            p, ds = t.tile(qi, kj)
            dv_acc += torch.matmul(
                p.to(do.dtype).to(torch.float32).transpose(1, 2), t.dor[:, qs])
            dk_acc += torch.matmul(
                ds.to(q.dtype).to(torch.float32).transpose(1, 2), t.qr[:, qs])
        dk[:, kj * bk:(kj + 1) * bk] = dk_acc.to(k.dtype)
        dv[:, kj * bk:(kj + 1) * bk] = dv_acc.to(v.dtype)
    return dk.reshape(q.shape), dv.reshape(q.shape)


def flash_attention_bwd_dq_plain(q, k, v, mask, o, lse, do, sm_scale=1.0,
                                 causal=False):
    """K4's arithmetic in plain PyTorch over the reference's tiles: per Q
    tile, ``dQ += dS K`` (dS rounded to k's dtype), the k loop stopping
    at the diagonal under ``causal``. Takes supported shapes only."""
    t = _PlainBwd(q, k, v, mask, o, lse, do, sm_scale, causal)
    bq, bk = t.bq, t.bk
    dq = torch.empty(t.b * t.h, t.s, t.d, dtype=q.dtype, device=q.device)
    for qi in range(t.s // bq):
        num_kb = t.s // bk
        if causal:
            num_kb = min(num_kb, -(-(qi + 1) * bq // bk))
        dq_acc = torch.zeros(t.b * t.h, bq, t.d, device=q.device)
        for kj in range(num_kb):
            _, ds = t.tile(qi, kj)
            dq_acc += torch.matmul(ds.to(k.dtype).to(torch.float32),
                                   t.kr[:, kj * bk:(kj + 1) * bk])
        dq[:, qi * bq:(qi + 1) * bq] = dq_acc.to(q.dtype)
    return dq.reshape(q.shape)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _require_cuda(q, what):
    if q.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {q.device}")


def _check_qkv(name, *ts):
    q = ts[0]
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"dtype, got {[str(t.dtype) for t in ts]}")
    if any(t.shape != q.shape for t in ts):
        raise ValueError(f"{name} needs tensors of one shape, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if q.shape[-1] > _MAX_D or q.shape[-1] % 8:
        raise ValueError(f"{name} takes a head dim that is a multiple of 8 "
                         f"and <= {_MAX_D}, got {q.shape[-1]}")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: tensors on different devices")
    return [t.contiguous() for t in ts]


# what follows the pointer arguments of each C entry point
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = {  # (bh, heads, s, d), scale, causal, dtype, stream
    "simt": (_I, _I, _I, _I, _F, _I, _I, _P),
    # (bh, heads, s, d, ld), scale, causal, stream
    "tc": (_I, _I, _I, _I, _I, _F, _I, _P),
    # (bh, heads, s, d), scale, causal, stream
    "fwd_tc": (_I, _I, _I, _I, _F, _I, _P)}


@functools.cache
def _fn(lib_name, symbol, nptr, tail="simt"):
    """(library, ``symbol`` of it) with argtypes bound once per loaded
    library: ``nptr`` pointers, then ``_TAIL[tail]``."""
    lib = _build.load(lib_name)
    fn = getattr(lib, symbol)
    fn.argtypes = [_P] * nptr + list(_TAIL[tail])
    fn.restype = ctypes.c_int
    return lib, fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned16(*ts):
    """Each tensor with a 16-byte aligned base (a copy where it is not):
    TMA and 16-byte ``cp.async`` read nothing else."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def _fwd_route(dtype, d):
    """The source K1 and K2 launch from, decided before the launch and
    nowhere else: ``"tc"`` (``flash_fwd_tc.cu``, wgmma + TMA) for bf16
    at a head dim in :data:`_TC_HEAD_DIMS`, ``"simt"``
    (``flash_fwd.cu``) for every other dtype and head dim."""
    return "tc" if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS \
        else "simt"


def _flash_fwd_cuda(q, k, v, mask, sm_scale, causal, want_lse):
    """Launch K1 (``want_lse=False``) or K2 on the route of q's dtype and
    head dim; count it under its key and ``f"{key}.{route}"``."""
    b, h, s, d = q.shape
    q, k, v = _aligned16(*_check_qkv("flash_fwd", q, k, v))
    rows = None if mask is None else _mask_rows(mask.to(q.device), b, h, s)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device) \
        if want_lse else None
    route = _fwd_route(q.dtype, d)
    lib_name = _FWD_LIBS[route]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rows),
            out.data_ptr(), _ptr(lse))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "tc":
        lib, fn = _fn(lib_name, "hetu_flash_fwd_tc", 6, "fwd_tc")
        args = (b * h, h, s, d, float(sm_scale), int(bool(causal)), stream)
    else:
        lib, fn = _fn(lib_name, "hetu_flash_fwd", 6)
        args = (b * h, h, s, d, float(sm_scale), int(bool(causal)),
                _DTYPE_CODES[q.dtype], stream)
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, *args)
    _build.check(lib, lib_name, rc)
    key = K2 if want_lse else K1
    _build.launch_counts[key] += 1
    _build.launch_counts[f"{key}.{route}"] += 1
    return (out, lse) if want_lse else out


def _bwd_route(dtype, d):
    """The source K3 and K4 launch from, decided before the launch and
    nowhere else: ``"tc"`` (``flash_bwd_tc.cu``, wgmma + TMA) for bf16
    at a head dim in :data:`_TC_HEAD_DIMS`, ``"simt"``
    (``flash_bwd.cu``) for every other dtype and head dim."""
    return "tc" if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS \
        else "simt"


def _pad_ld(t, ld):
    """[B, H, S] f32 -> [B, H, ld], zeros in [S, ld)."""
    return t if t.shape[-1] == ld else F.pad(t, (0, ld - t.shape[-1]))


def _bwd_prepare(q, k, v, mask, o, lse, do):
    """Checked, contiguous inputs of K3 / K4, with D, the mask rows and
    the route. The simt route takes D from :func:`_delta`. On the tc
    route ``delta`` is a buffer that K4 fills (K3 launched alone has it
    filled by its caller), and TMA reads q, k, v, dO, lse and D: their
    bases must be 16-byte aligned and the lse / D rows a multiple of 4
    floats long (``ld``), so a misaligned tensor is copied and lse is
    padded where S % 4."""
    b, h, s, d = q.shape
    q, k, v, o, do = _check_qkv("flash_bwd", q, k, v, o, do)
    if tuple(lse.shape) != (b, h, s):
        raise ValueError(f"flash_bwd: lse must be [B, H, S] = {(b, h, s)}, "
                         f"got {tuple(lse.shape)}")
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    rows = None if mask is None else _mask_rows(mask.to(q.device), b, h, s)
    route = _bwd_route(q.dtype, d)
    if route == "simt":
        return dict(q=q, k=k, v=v, o=o, do=do, lse=lse, rows=rows,
                    delta=_delta(o, do).contiguous(), route=route, ld=s)
    q, k, v, o, do, lse = _aligned16(q, k, v, o, do, lse)
    ld = -(-s // 4) * 4
    return dict(q=q, k=k, v=v, o=o, do=do, lse=_pad_ld(lse, ld), rows=rows,
                delta=torch.empty(b, h, ld, dtype=torch.float32,
                                  device=q.device),
                route=route, ld=ld)


# pointer arguments of each C entry point, from the prepared inputs,
# before the outputs; K4 on the tc route writes D as its last output
_BWD_PTRS = {"simt": ("q", "k", "v", "do", "lse", "delta", "rows"),
             "tc_dkv": ("q", "k", "v", "do", "lse", "delta", "rows"),
             "tc_dq": ("q", "k", "v", "do", "o", "lse", "rows")}


def _launch_bwd(prep, kernel, key, outs, sm_scale, causal):
    """Launch K3 (``kernel="dkv"``) or K4 (``"dq"``) on ``prep``'s
    route; count it under ``key`` and ``f"{key}.{route}"``."""
    q, route = prep["q"], prep["route"]
    b, h, s, d = q.shape
    lib_name = _BWD_LIBS[route]
    if route == "tc" and kernel == "dq":
        outs = (*outs, prep["delta"])
    names = _BWD_PTRS["simt" if route == "simt" else f"tc_{kernel}"]
    ptrs = [_ptr(prep[n]) for n in names] + [t.data_ptr() for t in outs]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "tc":
        lib, fn = _fn(lib_name, f"hetu_flash_bwd_tc_{kernel}", len(ptrs),
                      "tc")
        args = (b * h, h, s, d, prep["ld"], float(sm_scale),
                int(bool(causal)), stream)
    else:
        lib, fn = _fn(lib_name, f"hetu_flash_bwd_{kernel}", len(ptrs))
        args = (b * h, h, s, d, float(sm_scale), int(bool(causal)),
                _DTYPE_CODES[q.dtype], stream)
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, *args)
    _build.check(lib, lib_name, rc)
    _build.launch_counts[key] += 1
    _build.launch_counts[f"{key}.{route}"] += 1


def _launch_dkv(prep, sm_scale, causal):
    dk, dv = torch.empty_like(prep["k"]), torch.empty_like(prep["v"])
    _launch_bwd(prep, "dkv", K3, (dk, dv), sm_scale, causal)
    return dk, dv


def _launch_dq(prep, sm_scale, causal):
    dq = torch.empty_like(prep["q"])
    _launch_bwd(prep, "dq", K4, (dq,), sm_scale, causal)
    return dq
