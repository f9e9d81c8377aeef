// Flash-attention fused backward (K3: dK/dV, K4: dQ) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel`
// in hetu_tpu/ops/pallas_attention.py (launched by
// `_flash_attention_bwd_jit`). The recompute form: from the forward's
// per-row logsumexp `lse` (flash_fwd.cu with lse set, K2) both kernels
// rebuild each score tile in shared memory and registers,
//   p  = exp(q k^T * scale + mask - lse)        (f32)
//   dS = p * (dO v^T - D) * scale               (D = rowsum(dO * O), f32)
// so no [S, S] matrix ever reaches device memory on the backward either.
//
// Design. Blocks run in parallel and in no order on Hopper, so the TPU's
// sequential grid axis becomes a loop inside each block, and the two
// directions stay two kernels, as on the TPU:
//   K3 `flash_bwd_dkv_kernel`: one block per (batch*head, K tile). The K
//     and V tiles stay in shared memory while the block streams the Q,
//     dO, lse and D tiles; dK += dS^T Q and dV += p^T dO accumulate in
//     registers. Under `causal` the q loop starts at the diagonal tile.
//   K4 `flash_bwd_dq_kernel`: one block per (batch*head, Q tile). The Q
//     and dO tiles stay resident while K/V tiles stream; dQ += dS K in
//     registers. Under `causal` the k loop stops at the diagonal tile.
// dQ is written once by its own block -- no atomics, so the result is
// deterministic. 256 threads as a 16 x 16 grid: thread (ty, tx) owns
// rows ty + 16 i of its tile and, for the products, columns tx + 16 j
// (score tile) or head-dim columns tx + 16 jd (accumulators). Every
// tile is staged transposed with a padded pitch (TILE + 1), so the
// global loads are coalesced and the shared reads conflict-free. Tiles
// are 64 x 64 for D <= 128 and 32 x 32 above (four [D, TILE+1] f32
// tiles of D = 256 at 64 would pass the 227 KB a block may use).
//
// Numerics follow the reference kernels: products accumulate in f32 from
// the input values, softmax math is f32, p is rounded to dO's dtype
// before p^T dO, and dS to q's / k's dtype before dS^T Q and dS K.
// Masked scores are NEG_INF = -1e30, so exp(s - lse) is exactly 0 there;
// rows and keys past S (ragged last tile) get p = 0.
//
// Bound. K3 does 8 S^2 D flops and K4 6 S^2 D per (batch*head) (halved
// under causal) against a few rows of D elements each: bound by
// operations at every training length. This first version runs them on
// the CUDA cores in f32 (no wgmma, no TMA), which a later PR replaces.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
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

// x rounded to T and back: where the reference casts before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// tile rows [r0, r0 + TILE) of a [s, d] matrix, transposed into
// dst[d][TILE + 1] as f32; rows past s become 0
template <typename T, int TILE>
__device__ __forceinline__ void load_t(float* dst, const T* __restrict__ src,
                                       int r0, int s, int d) {
  constexpr int P = TILE + 1;
  for (int idx = threadIdx.x; idx < TILE * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    dst[c * P + r] = r0 + r < s ? to_f32(src[(size_t)(r0 + r) * d + c]) : 0.f;
  }
}

// the shared-memory layout both kernels use: four transposed [d][TILE+1]
// tiles, one [TILE][TILE] tile of p or dS, and three [TILE] vectors
template <int TILE> size_t smem_bytes(int d) {
  return sizeof(float) *
         (4 * (size_t)d * (TILE + 1) + (size_t)TILE * TILE + 3 * TILE);
}

// scores s = q k^T (f32 sums) and dp = dO v^T of one (q tile, k tile),
// thread (ty, tx) holding rows ty + 16 i and keys tx + 16 j
template <int TILE, int R>
__device__ __forceinline__ void tile_products(
    const float* Qs, const float* Os, const float* Ks, const float* Vs,
    int d, int ty, int tx, float (&sc)[R][R], float (&dp)[R][R]) {
  constexpr int P = TILE + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = Qs[c * P + ty + 16 * i];
      ov[i] = Os[c * P + ty + 16 * i];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = Ks[c * P + tx + 16 * j];
      vv[j] = Vs[c * P + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// p (unrounded) and dS of element (i, j) of the tile, from its score and
// dp; Ls / Ds hold the q rows' lse and D, Ms the keys' mask values
__device__ __forceinline__ void p_and_ds(float sc, float dp, int qpos,
                                         int kpos, int ql, int kl, int s,
                                         const float* Ls, const float* Ds,
                                         const float* Ms, bool masked,
                                         int causal, float sm_scale,
                                         float& p, float& ds) {
  float x = sc * sm_scale;
  if (masked) x += Ms[kl];
  if (causal && qpos < kpos) x = NEG_INF;
  p = (qpos < s && kpos < s) ? expf(x - Ls[ql]) : 0.f;
  ds = p * (dp - Ds[ql]) * sm_scale;
}

// K3: dK, dV of one K/V tile
template <typename T, int TILE, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int s, int d, int nkt,
                     float sm_scale, int causal) {
  constexpr int P = TILE + 1;
  constexpr int R = TILE / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [d][P] q tile, transposed
  float* Os = Qs + d * P;       // [d][P] dO tile
  float* Ks = Os + d * P;       // [d][P] k tile (resident)
  float* Vs = Ks + d * P;       // [d][P] v tile (resident)
  float* Ps = Vs + d * P;       // [TILE][TILE] p, then dS
  float* Ls = Ps + TILE * TILE; // [TILE] lse of the q rows
  float* Ds = Ls + TILE;        // [TILE] D of the q rows
  float* Ms = Ds + TILE;        // [TILE] mask of the keys

  const int bh = blockIdx.x / nkt;
  const int k0 = (blockIdx.x % nkt) * TILE;
  const size_t base = (size_t)bh * s * d;
  const float* mrow = mask ? mask + (size_t)(bh / heads) * s : nullptr;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_t<T, TILE>(Ks, k + base, k0, s, d);
  load_t<T, TILE>(Vs, v + base, k0, s, d);
  if (tid < TILE) Ms[tid] = (mrow && k0 + tid < s) ? mrow[k0 + tid] : 0.f;

  float acc_k[R][DPT], acc_v[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.f;

  const int nqt = (s + TILE - 1) / TILE;
  for (int qt = causal ? k0 / TILE : 0; qt < nqt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();            // the last tile's readers are done
    load_t<T, TILE>(Qs, q + base, q0, s, d);
    load_t<T, TILE>(Os, dout + base, q0, s, d);
    if (tid < TILE) {
      const bool in = q0 + tid < s;
      Ls[tid] = in ? lse[(size_t)bh * s + q0 + tid] : 0.f;
      Ds[tid] = in ? delta[(size_t)bh * s + q0 + tid] : 0.f;
    }
    __syncthreads();

    float sc[R][R], dp[R][R];
    tile_products<TILE, R>(Qs, Os, Ks, Vs, d, ty, tx, sc, dp);
    // thread (ty, tx) holds q rows ty + 16 i, keys tx + 16 j: write p
    // rounded to dO's dtype, keep dS (rounded to q's) in registers
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ql = ty + 16 * i, kl = tx + 16 * j;
        float p, ds;
        p_and_ds(sc[i][j], dp[i][j], q0 + ql, k0 + kl, ql, kl, s, Ls, Ds,
                 Ms, mrow != nullptr, causal, sm_scale, p, ds);
        Ps[ql * TILE + kl] = round_to<T>(p);
        dp[i][j] = round_to<T>(ds);
      }
    __syncthreads();

    // dV[key][c] += sum_q p[q][key] dO[q][c]; this thread: keys
    // ty + 16 i, head-dim columns tx + 16 jd
    const int qvalid = min(TILE, s - q0);
    for (int qq = 0; qq < qvalid; ++qq) {
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[qq * TILE + ty + 16 * i];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        const int col = tx + 16 * jd;
        if (col < d) {
          const float ov = Os[col * P + qq];
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc_v[i][jd] = fmaf(pv[i], ov, acc_v[i][jd]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        Ps[(ty + 16 * i) * TILE + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dK[key][c] += sum_q dS[q][key] q[q][c]
    for (int qq = 0; qq < qvalid; ++qq) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = Ps[qq * TILE + ty + 16 * i];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        const int col = tx + 16 * jd;
        if (col < d) {
          const float qv = Qs[col * P + qq];
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc_k[i][jd] = fmaf(sv[i], qv, acc_k[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= s) continue;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int col = tx + 16 * jd;
      if (col < d) {
        dk[base + (size_t)r * d + col] = from_f32<T>(acc_k[i][jd]);
        dv[base + (size_t)r * d + col] = from_f32<T>(acc_v[i][jd]);
      }
    }
  }
}

// K4: dQ of one Q tile
template <typename T, int TILE, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq,
                    int heads, int s, int d, int nqt, float sm_scale,
                    int causal) {
  constexpr int P = TILE + 1;
  constexpr int R = TILE / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [d][P] q tile (resident)
  float* Os = Qs + d * P;       // [d][P] dO tile (resident)
  float* Ks = Os + d * P;       // [d][P] k tile
  float* Vs = Ks + d * P;       // [d][P] v tile
  float* Ss = Vs + d * P;       // [TILE][TILE] dS
  float* Ls = Ss + TILE * TILE; // [TILE] lse of the q rows
  float* Ds = Ls + TILE;        // [TILE] D of the q rows
  float* Ms = Ds + TILE;        // [TILE] mask of the keys

  const int bh = blockIdx.x / nqt;
  const int q0 = (blockIdx.x % nqt) * TILE;
  const size_t base = (size_t)bh * s * d;
  const float* mrow = mask ? mask + (size_t)(bh / heads) * s : nullptr;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_t<T, TILE>(Qs, q + base, q0, s, d);
  load_t<T, TILE>(Os, dout + base, q0, s, d);
  if (tid < TILE) {
    const bool in = q0 + tid < s;
    Ls[tid] = in ? lse[(size_t)bh * s + q0 + tid] : 0.f;
    Ds[tid] = in ? delta[(size_t)bh * s + q0 + tid] : 0.f;
  }

  float acc[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;

  int nkt = (s + TILE - 1) / TILE;
  if (causal) nkt = min(nkt, q0 / TILE + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();            // the last tile's readers are done
    load_t<T, TILE>(Ks, k + base, k0, s, d);
    load_t<T, TILE>(Vs, v + base, k0, s, d);
    if (tid < TILE) Ms[tid] = (mrow && k0 + tid < s) ? mrow[k0 + tid] : 0.f;
    __syncthreads();

    float sc[R][R], dp[R][R];
    tile_products<TILE, R>(Qs, Os, Ks, Vs, d, ty, tx, sc, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ql = ty + 16 * i, kl = tx + 16 * j;
        float p, ds;
        p_and_ds(sc[i][j], dp[i][j], q0 + ql, k0 + kl, ql, kl, s, Ls, Ds,
                 Ms, mrow != nullptr, causal, sm_scale, p, ds);
        Ss[ql * TILE + kl] = round_to<T>(ds);
      }
    __syncthreads();

    // dQ[q][c] += sum_key dS[q][key] k[key][c]; this thread: q rows
    // ty + 16 i, head-dim columns tx + 16 jd
    const int kvalid = min(TILE, s - k0);
    for (int kk = 0; kk < kvalid; ++kk) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = Ss[(ty + 16 * i) * TILE + kk];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        const int col = tx + 16 * jd;
        if (col < d) {
          const float kv = Ks[col * P + kk];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][jd] = fmaf(sv[i], kv, acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s) continue;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int col = tx + 16 * jd;
      if (col < d) dq[base + (size_t)r * d + col] = from_f32<T>(acc[i][jd]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *mask;
  void *dq, *dk, *dv;
  int bh, heads, s, d;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int TILE, int DPT>
cudaError_t launch(const Args& a, bool dkv) {
  const int nt = (a.s + TILE - 1) / TILE;
  const size_t smem = smem_bytes<TILE>(a.d);
  const unsigned grid = (unsigned)((long long)a.bh * nt);
  cudaError_t err;
  if (dkv) {
    auto* kern = flash_bwd_dkv_kernel<T, TILE, DPT>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, a.mask, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.heads, a.s, a.d, nt, a.sm_scale, a.causal);
  } else {
    auto* kern = flash_bwd_dq_kernel<T, TILE, DPT>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, a.mask, static_cast<T*>(a.dq), a.heads, a.s, a.d, nt,
        a.sm_scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T> cudaError_t dispatch_d(const Args& a, bool dkv) {
  if (a.d <= 64) return launch<T, 64, 4>(a, dkv);
  if (a.d <= 128) return launch<T, 64, 8>(a, dkv);
  return launch<T, 32, 16>(a, dkv);
}

int run(const Args& a, int dtype, bool dkv) {
  if (a.bh <= 0 || a.heads <= 0 || a.bh % a.heads || a.s <= 0 ||
      a.d <= 0 || a.d % 8 || a.d > MAX_D ||
      (long long)a.bh * ((a.s + 31) / 32) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_d<float>(a, dkv);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(a, dkv);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout: contiguous [bh, s, d] of dtype (0 = float32,
// 1 = bfloat16); lse, delta: contiguous float32 [bh, s] (the forward's
// logsumexp, and rowsum(dO * O)); mask: NULL or contiguous float32
// [bh / heads, s]. K3 writes dk, dv; K4 writes dq (each [bh, s, d] of
// dtype). Each launches on `stream` and returns cudaGetLastError() (0 on
// success); neither synchronises.
extern "C" int hetu_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  const float* mask, void* dk, void* dv,
                                  int bh, int heads, int s, int d,
                                  float sm_scale, int causal, int dtype,
                                  void* stream) {
  const Args a{q, k, v, dout, lse, delta, mask, nullptr, dk, dv, bh, heads,
               s, d, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(a, dtype, true);
}

extern "C" int hetu_flash_bwd_dq(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta,
                                 const float* mask, void* dq, int bh,
                                 int heads, int s, int d, float sm_scale,
                                 int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr, bh,
               heads, s, d, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run(a, dtype, false);
}

extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
