// Flash-attention forward (K1, and K2 with its logsumexp output) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// hetu_tpu/ops/pallas_attention.py, launched by `_flash_attention_jit`
// with need_lse=False (K1) and need_lse=True (K2): out = softmax(q k^T *
// sm_scale + mask) v over [B*H, S, D], online softmax over K/V tiles,
// the [S, S] score matrix never written to device memory. With `lse`
// set (K2) the kernel also writes each row's logsumexp m + log(l) as
// plain f32 [B*H, S] -- the residual the fused backward (flash_bwd.cu)
// recomputes p from; the TPU kernel's 128-lane broadcast of it is a
// TPU layout artifact and is not reproduced.
//
// Design. One thread block of 256 threads per (batch*head, 64-row
// q-tile); the TPU's sequential grid axis over K blocks becomes a loop
// inside the block. Q is staged once in shared memory, then each
// 64-row K/V tile in turn. Thread (ty, tx) = (tid / 16, tid % 16) owns
// query rows ty + 16 i (i < 4) and, inside a tile, key columns
// tx + 16 j (j < 4) and head-dim columns tx + 16 jd, so the 16 threads
// of one row sit in one half-warp and row max / row sum are shuffle
// reductions. Per row it keeps the running max, the running sum and an
// f32 accumulator in registers, exactly the carry of the TPU kernel.
// Q and K are stored transposed with a padded pitch (65), so both the
// global-to-shared stores and the inner-product reads are free of bank
// conflicts. Under `causal` the K loop stops at the q-tile's diagonal
// (as pallas_attention.py:57-60) and masks q_pos < k_pos with
// NEG_INF = -1e30, the reference kernel's value; the optional additive
// padding mask is one f32 row per batch element ([B, 1, S]), shared by
// its heads. Keys past S (ragged last tile) get -inf and drop out.
//
// Numerics follow the reference kernel: products accumulate in f32,
// all softmax math is f32, and p is rounded to the input dtype before
// the p.v product (p.astype(v.dtype)) while the row sum uses the
// unrounded p.
//
// Bound. The kernel does 4*S*D flops per (row, head) against 4 rows of
// D elements (q, k, v, o), S/4 flops per f32 byte: past S of about 80
// it is bound by operations, not bytes, on every prompt the serving
// engine pads to 128 or more. This first version runs those operations
// on the CUDA cores in f32 (no wgmma, no TMA), which is what a later
// PR replaces. Correctness first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per K/V tile
constexpr int THREADS = 256;
constexpr int RPT = BQ / 16;    // query rows per thread
constexpr int CPT = BK / 16;    // key columns per thread
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// DPT: head-dim columns per thread (ceil(D / 16) rounded up to 4, 8, 16)
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int heads,
                 int s, int d, int nqt, float sm_scale, int causal) {
  extern __shared__ float smem[];
  constexpr int QP = BQ + 1;    // padded pitches of the transposed tiles
  constexpr int KP = BK + 1;
  float* Qs = smem;             // [d][QP]
  float* Ks = Qs + d * QP;      // [d][KP]
  float* Vs = Ks + d * KP;      // [BK][d]
  float* Ps = Vs + BK * d;      // [BQ][BK]
  float* Ms = Ps + BQ * BK;     // [BK]

  const int bh = blockIdx.x / nqt;
  const int q0 = (blockIdx.x % nqt) * BQ;
  const size_t base = (size_t)bh * s * d;
  const float* mrow = mask ? mask + (size_t)(bh / heads) * s : nullptr;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int idx = tid; idx < BQ * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    Qs[c * QP + r] =
        q0 + r < s ? to_f32(q[base + (size_t)(q0 + r) * d + c]) : 0.f;
  }

  float m_i[RPT], l_i[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
  }

  int nkb = (s + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ + BK - 1) / BK);

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();            // last tile's readers are done
    for (int idx = tid; idx < BK * d; idx += THREADS) {
      const int r = idx / d, c = idx % d;
      const bool in = k0 + r < s;
      const size_t g = base + (size_t)(k0 + r) * d + c;
      Ks[c * KP + r] = in ? to_f32(k[g]) : 0.f;
      Vs[r * d + c] = in ? to_f32(v[g]) : 0.f;
    }
    if (tid < BK) Ms[tid] = (mrow && k0 + tid < s) ? mrow[k0 + tid] : 0.f;
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[c * QP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[c * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kl = tx + 16 * j;
        const int kpos = k0 + kl;
        float x = sc[i][j] * sm_scale;
        if (mrow) x += Ms[kl];
        if (causal && qpos < kpos) x = NEG_INF;
        if (kpos >= s) x = -INFINITY;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * BK + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

    const int kvalid = min(BK, s - k0);
    for (int c = 0; c < kvalid; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * BK + c];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        const int col = tx + 16 * jd;
        if (col < d) {
          const float vv = Vs[c * d + col];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s) continue;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int col = tx + 16 * jd;
      if (col < d)
        o[base + (size_t)r * d + col] = from_f32<T>(acc[i][jd] / l_i[i]);
    }
    if (lse && tx == 0) lse[(size_t)bh * s + r] = m_i[i] + logf(l_i[i]);
  }
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* o, float* lse, int bh,
                   int heads, int s, int d, float sm_scale, int causal,
                   cudaStream_t stream) {
  const int nqt = (s + BQ - 1) / BQ;
  const size_t smem =
      sizeof(float) * ((size_t)d * (BQ + 1) + (size_t)d * (BK + 1) +
                       (size_t)BK * d + BQ * BK + BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, DPT><<<(unsigned)((long long)bh * nqt), THREADS, smem,
                             stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, heads, s, d,
      nqt, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const float* mask, void* o, float* lse, int bh,
                       int heads, int s, int d, float sm_scale, int causal,
                       cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 4>(q, k, v, mask, o, lse, bh, heads, s, d, sm_scale,
                        causal, stream);
  if (d <= 128)
    return launch<T, 8>(q, k, v, mask, o, lse, bh, heads, s, d, sm_scale,
                        causal, stream);
  return launch<T, 16>(q, k, v, mask, o, lse, bh, heads, s, d, sm_scale,
                       causal, stream);
}

}  // namespace

// q, k, v, o: contiguous [bh, s, d] of dtype (0 = float32, 1 = bfloat16);
// mask: NULL or contiguous float32 [bh / heads, s]; lse: NULL (K1) or
// contiguous float32 [bh, s] (K2). Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int hetu_flash_fwd(const void* q, const void* k, const void* v,
                              const float* mask, void* o, float* lse, int bh,
                              int heads, int s, int d, float sm_scale,
                              int causal, int dtype, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads || s <= 0 || d <= 0 ||
      d % 8 || d > MAX_D ||
      (long long)bh * ((s + BQ - 1) / BQ) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, mask, o, lse, bh, heads, s, d,
                                  sm_scale, causal, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, mask, o, lse, bh, heads,
                                          s, d, sm_scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
