// Flash-attention forward on the CUDA cores (K1, and K2 with its
// logsumexp output) for Hopper, sm_90a: f32 at every head dim, and bf16
// at the head dims the tensor-core route (flash_fwd_tc.cu, bf16 at D in
// {64, 128}) does not take.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// hetu_tpu/ops/pallas_attention.py, launched by `_flash_attention_jit`
// with need_lse=False (K1) and need_lse=True (K2): out = softmax(q k^T *
// sm_scale + mask) v over [B*H, S, D], online softmax over K/V tiles,
// the [S, S] score matrix never written to device memory. With `lse`
// set (K2) the kernel also writes each row's logsumexp m + log(l) as
// plain f32 [B*H, S] -- the residual the fused backward recomputes p
// from; the TPU kernel's 128-lane broadcast of it is a TPU layout
// artifact and is not reproduced.
//
// Bound. 4 S^2 D flops per (batch*head), halved under causal, against
// four [S, D] tensors: bound by operations past S of about 80. f32 stays
// exact f32 on the CUDA cores (TF32 would keep 10 mantissa bits, short
// of the serving path's 1e-4), so the design feeds the FMA units:
//   - one block of 128 threads per (batch*head, 32-row q tile), the
//     heaviest causal tiles launched first: a 1024-token prefill of 12
//     heads is 384 blocks, three for each of the card's 132 SMs;
//   - Q resident in shared memory; K and V tiles of BK keys streamed by
//     16-byte cp.async through a two-stage ring, so tile j+1 loads while
//     tile j computes; rows past S and head-dim columns past D (D is
//     padded to DP, a multiple of 64 and a template parameter) are
//     zero-filled by the copy, so no loop carries a bounds branch;
//   - thread (ty, tx) = (tid / 16, tid % 16) owns q rows ty + 8i (i < 4)
//     and, for the scores, keys tx + 16j (j < BK / 16): Q and K rows are
//     read as float4 along d (K's row pitch padded by 16 bytes, so a
//     quarter-warp's 16-byte reads hit distinct banks), BK FMAs for
//     every 4 + BK/16 shared loads; the 16 threads of a row are one
//     half-warp, so its max and sum are shuffle reductions;
//   - for O += P V the same thread owns output columns 64jj + 4tx..+3:
//     p goes through shared memory once (each half-warp writes and reads
//     only its own rows, so a __syncwarp orders them) and is read back
//     as float4 along the keys, V as float4 along d.
// Under `causal` the K loop stops at the q tile's diagonal and masks
// q_pos < k_pos with NEG_INF = -1e30, the reference kernel's value; the
// optional additive padding mask is one f32 row per batch element
// ([B, 1, S]), shared by its heads. Keys past S get -inf and drop out.
//
// Numerics follow the reference kernel: products accumulate in f32, all
// softmax math is f32, the score is acc * sm_scale + mask with two
// roundings in that order (as the reference's; with a -1e9 padding mask
// the f32 spacing is 64, and another order changes which keys of a fully
// masked row survive), and p is rounded to the input dtype before the
// p.v product (p.astype(v.dtype)) while the row sum uses the unrounded p.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"   // allow_smem

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int THREADS = 128;
constexpr int TX = 16;          // threads sharing a row: a half-warp
constexpr int RPT = 4;          // rows per thread: ty + 8 i
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------- cp.async

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ------------------------------------------------------------ dtype I/O

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// x rounded to T and back (p.astype(v.dtype))
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// shared-memory layout of one block, in bytes
template <typename T, int DP, int BK> struct SimtLayout {
  static constexpr int QP = DP + 16 / (int)sizeof(T);  // padded Q / K pitch
  static constexpr int PP = BK + 16;                   // p pitch (floats)
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * QP * (int)sizeof(T);
  static constexpr int V = K + 2 * BK * QP * (int)sizeof(T);
  static constexpr int P = V + 2 * BK * DP * (int)sizeof(T);
  static constexpr int BYTES = P + BQ * PP * 4;
};

// `rows` rows of d values from `src` (row r at src + r * d, valid while
// row0 + r < s) into a [rows][pitch] tile, columns [d, DP) and invalid
// rows zero-filled, by 16-byte cp.async
template <typename T, int DP>
__device__ __forceinline__ void load_rows(T* dst, int pitch, const T* src,
                                          int rows, int row0, int s, int d) {
  constexpr int CH = 16 / sizeof(T);   // elements a copy
  constexpr int PER_ROW = DP / CH;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, col = (idx % PER_ROW) * CH;
    const bool valid = row0 + r < s && col < d;
    cp_async16(dst + r * pitch + col,
               valid ? src + (size_t)r * d + col : src, valid);
  }
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int heads,
                 int s, int d, float sm_scale, int causal) {
  using L = SimtLayout<T, DP, BK>;
  constexpr int KPT = BK / TX;   // score columns per thread
  constexpr int CPT = DP / 64;   // float4 output column groups per thread
  extern __shared__ __align__(16) uint8_t smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ps = reinterpret_cast<float*>(smem + L::P);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heavy tiles first
  const size_t head = (size_t)bh * s * d;
  const float* mrow = mask ? mask + (size_t)(bh / heads) * s : nullptr;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  int nkt = (s + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + BQ + BK - 1) / BK);

  load_rows<T, DP>(Qs, L::QP, q + head + (size_t)q0 * d, BQ, q0, s, d);
  auto load_kv = [&](int kt, int st) {
    const size_t off = head + (size_t)kt * BK * d;
    load_rows<T, DP>(Ks + st * BK * L::QP, L::QP, k + off, BK, kt * BK, s,
                     d);
    load_rows<T, DP>(Vs + st * BK * DP, DP, v + off, BK, kt * BK, s, d);
  };
  load_kv(0, 0);
  cp_async_commit();

  float m_i[RPT], l_i[RPT], acc[RPT][CPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (kt + 1 < nkt) load_kv(kt + 1, st ^ 1);
    cp_async_commit();           // possibly empty: one group an iteration
    float mk[KPT];               // the mask of this thread's keys
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = k0 + tx + TX * j;
      mk[j] = (mrow && kpos < s) ? mrow[kpos] : 0.f;
    }
    cp_async_wait_1();           // tile kt (and Q) landed
    __syncthreads();

    // scores: rows ty + 8i, keys tx + 16j
    const T* Kt = Ks + st * BK * L::QP;
    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = load4(Qs + (ty + 8 * i) * L::QP + c);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = load4(Kt + (tx + TX * j) * L::QP + c);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int ql = ty + 8 * i, qpos = q0 + ql;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        float x = __fmul_rn(sc[i][j], sm_scale);
        if (mrow) x = __fadd_rn(x, mk[j]);
        if (causal && qpos < kpos) x = NEG_INF;
        if (kpos >= s) x = -INFINITY;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[ql * L::PP + tx + TX * j] = round_to(p, q);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    __syncwarp();                // this half-warp's p rows are written

    // O += P V: rows ty + 8i, columns 64jj + 4tx .. + 3
    const T* Vt = Vs + st * BK * DP;
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 8 * i) * L::PP +
                                                 c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          const float4 vv = load4(Vt + (c + kk) * DP + 64 * jj + 4 * tx);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y
                          : kk == 2 ? pv[i].z : pv[i].w;
            acc[i][jj][0] = fmaf(p, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(p, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(p, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(p, vv.w, acc[i][jj][3]);
          }
        }
    }
    __syncthreads();             // stage st and the p rows are free again
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 8 * i;
    if (r >= s) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int col = 64 * jj + 4 * tx;
      if (col < d)
        store4(o + head + (size_t)r * d + col,
               make_float4(acc[i][jj][0] / l_i[i], acc[i][jj][1] / l_i[i],
                           acc[i][jj][2] / l_i[i], acc[i][jj][3] / l_i[i]));
    }
    if (lse && tx == 0) lse[(size_t)bh * s + r] = m_i[i] + logf(l_i[i]);
  }
}

template <typename T, int DP, int BK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* o, float* lse, int bh,
                   int heads, int s, int d, float sm_scale, int causal,
                   cudaStream_t stream) {
  auto* kern = flash_fwd_kernel<T, DP, BK>;
  const int smem = SimtLayout<T, DP, BK>::BYTES;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem(smem_set, kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, heads, s, d,
      sm_scale, causal);
  return cudaGetLastError();
}

// D padded to DP, a multiple of 64; K/V tiles of 64 keys at DP = 64, 32
// above, so a block stays within two or more an SM at every DP
template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const float* mask, void* o, float* lse, int bh,
                       int heads, int s, int d, float sm_scale, int causal,
                       cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64, 64>(q, k, v, mask, o, lse, bh, heads, s, d,
                             sm_scale, causal, stream);
  if (d <= 128)
    return launch<T, 128, 32>(q, k, v, mask, o, lse, bh, heads, s, d,
                              sm_scale, causal, stream);
  if (d <= 192)
    return launch<T, 192, 32>(q, k, v, mask, o, lse, bh, heads, s, d,
                              sm_scale, causal, stream);
  return launch<T, 256, 32>(q, k, v, mask, o, lse, bh, heads, s, d,
                            sm_scale, causal, stream);
}

}  // namespace

// q, k, v, o: contiguous [bh, s, d] of dtype (0 = float32, 1 = bfloat16),
// 16-byte aligned; mask: NULL or contiguous float32 [bh / heads, s]; lse:
// NULL (K1) or contiguous float32 [bh, s] (K2). Launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int hetu_flash_fwd(const void* q, const void* k, const void* v,
                              const float* mask, void* o, float* lse, int bh,
                              int heads, int s, int d, float sm_scale,
                              int causal, int dtype, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads || s <= 0 || d <= 0 ||
      d % 8 || d > MAX_D || (s + BQ - 1) / BQ > 65535 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o))
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
