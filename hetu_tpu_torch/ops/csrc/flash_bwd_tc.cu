// Flash-attention fused backward on the tensor cores (K3: dK/dV, K4: dQ)
// for Hopper, sm_90a: bf16 at head dims 64 and 128.
//
// Replaces the Pallas TPU kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel`
// in hetu_tpu/ops/pallas_attention.py (launched by
// `_flash_attention_bwd_jit`) on that route; flash_bwd.cu keeps f32 and
// the other head dims. Same recompute form: from the forward's per-row
// logsumexp `lse` (K2) and D = rowsum(dO * O) each block rebuilds its
// score tiles,
//   p  = exp(q k^T * scale + mask - lse)
//   dS = p * (dO v^T - D) * scale,
// so no [S, S] matrix reaches device memory.
//
// Bound. K3 does 8 S^2 D flops and K4 6 S^2 D per (batch*head), halved
// under causal, against O(S D) bytes: bound by operations at every
// training length. So every product runs on the tensor cores:
//   K3 `flash_bwd_dkv_tc_kernel`, one block per (batch*head, 64-key tile).
//     K and V stay resident in shared memory; Q, dO and the q rows' lse
//     and D stream through a ring of STAGES stages, each loaded by TMA
//     and completed on an mbarrier. Thread 0 issues a stage's next load
//     as soon as the warpgroup is done with it, so the load of tile i+1
//     overlaps the products of tile i. Per q tile the warpgroup computes
//     the transposed tiles S^T = K Q^T and dP^T = V dO^T with wgmma (A = K
//     or V, B = Q or dO, both K-major from shared memory), forms P^T and
//     dS^T in registers (lse and D per q column, the mask per key row),
//     and accumulates dV += P^T dO and dK += dS^T Q with A taken from
//     registers -- the f32 accumulator rounded to bf16 is already in
//     wgmma's A-fragment layout -- and B = dO or Q read MN-major. p and
//     dS never touch shared memory.
//   K4 `flash_bwd_dq_tc_kernel`, one block per (batch*head, 64-row q
//     tile): Q and dO resident, K and V streamed the same way;
//     S = Q K^T and dP = dO V^T with wgmma, dS in registers, dQ += dS K
//     with A from registers and B = K read MN-major. While its first
//     tiles load, it also computes D for its rows from dO and O and
//     writes it out, so a backward launches K4 first and K3 reads D:
//     no separate reduction over dO and O.
// dQ is written once by its own block: no atomics, deterministic.
// One consumer warpgroup a block (128 threads, 64 resident rows), so two
// blocks share an SM and overlap each other's softmax with products.
// Tiles are stored as TMA writes them with 128-byte swizzle: rows of 64
// bf16 (128 B), a D=128 tile as two such column blocks; the descriptors
// say SWIZZLE_128B. TMA reads through 3-D descriptors over (d, s,
// batch*head), so rows past S read as zeros, never as the next head's
// rows; p is masked to 0 there and the stores are guarded. Causal: K3's
// q loop starts at the diagonal, K4's k loop stops there, only tiles
// that cross it are position-masked, and the heaviest tiles are
// launched first (K3: low key tiles, K4: high q tiles).
//
// Numerics follow the reference kernels: products take bf16 operands
// with f32 accumulation, softmax math is f32, p is rounded to bf16
// before P^T dO and dS before dS^T Q and dS K (the roundings the
// reference makes, here by the operand type).
//
// Build: `nvcc -shared` with a plain C interface, no -lcuda. The host
// code reaches libcuda's cuTensorMapEncodeTiled through the runtime's
// entry-point lookup (cudaGetDriverEntryPoint*) and builds the TMA
// descriptors per call, since they hold the base pointers; they reach
// the kernels as __grid_constant__ parameters. Each kernel's shared
// memory limit is raised once per device, not per launch.
//
// The mbarrier, TMA and wgmma wrappers, the epilogue store and the host
// helpers are shared with flash_fwd_tc.cu through hopper_tc.cuh.
#include "hopper_tc.cuh"

namespace {

constexpr int BQ = 64;        // q rows K3 streams a tile (N of S^T, dP^T)
constexpr int STAGES = 2;     // ring of streamed tiles

// p and dS of one score element (f32, before rounding)
__device__ __forceinline__ void p_ds(float sc, float& dp, float bias,
                                     float lse, float delta, float scale,
                                     bool keep, float& p) {
  p = keep ? exp2f((fmaf(sc, scale, bias) - lse) * LOG2E) : 0.f;
  dp = p * (dp - delta) * scale;
}

// rowsum(a * b) over row `row` of two [s, D] bf16 matrices from `head`
// rows in, in f32, summed by the four threads c = 0..3 of a quad; 0 for
// rows past s
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, size_t head,
                                         int row, int s, int c) {
  float sum = 0.f;
  if (row < s) {
    const size_t off = (head + row) * D + c * (D / 4);
    const uint4* x = reinterpret_cast<const uint4*>(a + off);
    const uint4* y = reinterpret_cast<const uint4*>(b + off);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const uint4 xv = x[i], yv = y[i];
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(x2[e]);
        const float2 yf = __bfloat1622float2(y2[e]);
        sum = fmaf(xf.x, yf.x, sum);
        sum = fmaf(xf.y, yf.y, sum);
      }
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  return sum;
}

// ---------------------------------------------------------------------- K3

template <int D> struct DkvLayout {
  static constexpr int KV = ROWS * D * 2;  // a resident K or V tile
  static constexpr int QT = BQ * D * 2;    // a streamed Q or dO tile
  static constexpr int VEC = BQ * 4;       // a streamed lse or D vector
  static constexpr int K = 0, V = KV, Q = 2 * KV;
  static constexpr int O = Q + STAGES * QT;
  static constexpr int L = O + STAGES * QT;
  static constexpr int DL = L + STAGES * VEC;
  static constexpr int BAR = DL + STAGES * VEC;    // kv, then full[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;
  static constexpr uint32_t STAGE_TX = 2 * QT + 2 * VEC;
};

template <int D>
__global__ void __launch_bounds__(WG)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tlse,
                        const __grid_constant__ CUtensorMap tdelta,
                        const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int heads, int s,
                        float sm_scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int H = D / 64;     // 64-wide column blocks of a row
  constexpr int KD = D / 16;    // k16 slices over the head dim
  constexpr int KQ = BQ / 16;   // k16 slices over the q tile
  const uint32_t base = smem_base();
  const uint32_t kv_bar = base + L::BAR, full0 = kv_bar + 8;

  const int bh = blockIdx.x, k0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int key = k0 + 16 * (tid / 32) + g;   // this thread's rows: key, +8
  const int nqt = (s + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int n = nqt - qt0;

  auto load_stage = [&](int st, int qt) {
    const uint32_t bar = full0 + 8 * st;
    mbar_expect_tx(bar, L::STAGE_TX);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint32_t off = st * L::QT + h * BQ * ROW_BYTES;
      tma_load_3d(base + L::Q + off, &tq, bar, 64 * h, qt * BQ, bh);
      tma_load_3d(base + L::O + off, &tdo, bar, 64 * h, qt * BQ, bh);
    }
    tma_load_2d(base + L::L + st * L::VEC, &tlse, bar, qt * BQ, bh);
    tma_load_2d(base + L::DL + st * L::VEC, &tdelta, bar, qt * BQ, bh);
  };

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int i = 0; i < STAGES; ++i) mbar_init(full0 + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * L::KV);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      tma_load_3d(base + L::K + h * ROWS * ROW_BYTES, &tk, kv_bar, 64 * h, k0,
                  bh);
      tma_load_3d(base + L::V + h * ROWS * ROW_BYTES, &tv, kv_bar, 64 * h, k0,
                  bh);
    }
    for (int i = 0; i < STAGES && i < n; ++i) load_stage(i, qt0 + i);
  }

  const float* mrow = mask ? mask + (size_t)(bh / heads) * s : nullptr;
  const float m0 = (mrow && key < s) ? mrow[key] : 0.f;
  const float m1 = (mrow && key + 8 < s) ? mrow[key + 8] : 0.f;

  float dk_acc[H][32], dv_acc[H][32];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES;
    const int q0 = (qt0 + it) * BQ;
    const uint32_t qb = base + L::Q + st * L::QT;
    const uint32_t ob = base + L::O + st * L::QT;
    mbar_wait(full0 + 8 * st, (it / STAGES) & 1);

    // S^T = K Q^T, dP^T = V dO^T: rows = keys, columns = q
    float sc[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss_n64(sc, desc_k(base + L::K + kslice(kk, ROWS)),
                   desc_k(qb + kslice(kk, BQ)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss_n64(dp, desc_k(base + L::V + kslice(kk, ROWS)),
                   desc_k(ob + kslice(kk, BQ)), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P^T and dS^T in registers: element 4j + r is key row key (+8 for
    // r >= 2), q column q0 + 8j + 2c (+1 for odd r)
    const float* ls = smem_f32(base + L::L + st * L::VEC);
    const float* ds = smem_f32(base + L::DL + st * L::VEC);
    const bool edge = (causal && q0 < k0 + ROWS - 1) || q0 + BQ > s ||
                      k0 + ROWS > s;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int ql = 8 * j + 2 * c;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + ql);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + ql);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * j + r;
        const int qpos = q0 + ql + (r & 1);
        const int kpos = key + (r & 2) * 4;
        const bool keep = !edge || ((!causal || qpos >= kpos) && qpos < s &&
                                    kpos < s);
        p_ds(sc[i], dp[i], r < 2 ? m0 : m1, (r & 1) ? l2.y : l2.x,
             (r & 1) ? d2.y : d2.x, sm_scale, keep, sc[i]);
      }
    }

    // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major
    uint32_t pa[KQ][4], da[KQ][4];
    to_a_frags<KQ>(sc, pa);
    to_a_frags<KQ>(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs_n64(dv_acc[h], pa[kk],
                     desc_mn(ob + h * BQ * ROW_BYTES + kk * 16 * ROW_BYTES));
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs_n64(dk_acc[h], da[kk],
                     desc_mn(qb + h * BQ * ROW_BYTES + kk * 16 * ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < H; ++h) {
      fence_regs(dv_acc[h]);
      fence_regs(dk_acc[h]);
    }

    __syncthreads();   // the warpgroup is done with stage st
    if (tid == 0 && it + STAGES < n) load_stage(st, qt0 + it + STAGES);
  }

  const size_t head = (size_t)bh * s * D;
  store_tile<D>(dk + head, dk_acc, key, s, c);
  store_tile<D>(dv + head, dv_acc, key, s, c);
}

// ---------------------------------------------------------------------- K4

template <int D> struct DqLayout {
  static constexpr int T = ROWS * D * 2;  // one 64-row tile
  static constexpr int Q = 0, O = T, K = 2 * T;
  static constexpr int V = K + STAGES * T;
  static constexpr int BAR = V + STAGES * T;       // qo, then full[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WG)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __nv_bfloat16* __restrict__ dout,
                       const __nv_bfloat16* __restrict__ o,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, int ld,
                       const float* __restrict__ mask,
                       __nv_bfloat16* __restrict__ dq, int heads, int s,
                       float sm_scale, int causal) {
  using L = DqLayout<D>;
  constexpr int H = D / 64;
  constexpr int KD = D / 16;
  constexpr int KK = ROWS / 16;  // k16 slices over the key tile
  const uint32_t base = smem_base();
  const uint32_t qo_bar = base + L::BAR, full0 = qo_bar + 8;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heavy tiles first
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int row = q0 + 16 * (tid / 32) + g;  // this thread's rows: row, +8
  int nkt = (s + ROWS - 1) / ROWS;
  if (causal) nkt = min(nkt, q0 / ROWS + 1);

  auto load_stage = [&](int st, int kt) {
    const uint32_t bar = full0 + 8 * st;
    mbar_expect_tx(bar, 2 * L::T);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint32_t off = st * L::T + h * ROWS * ROW_BYTES;
      tma_load_3d(base + L::K + off, &tk, bar, 64 * h, kt * ROWS, bh);
      tma_load_3d(base + L::V + off, &tv, bar, 64 * h, kt * ROWS, bh);
    }
  };

  if (tid == 0) {
    mbar_init(qo_bar, 1);
    for (int i = 0; i < STAGES; ++i) mbar_init(full0 + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qo_bar, 2 * L::T);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      tma_load_3d(base + L::Q + h * ROWS * ROW_BYTES, &tq, qo_bar, 64 * h, q0,
                  bh);
      tma_load_3d(base + L::O + h * ROWS * ROW_BYTES, &tdo, qo_bar, 64 * h,
                  q0, bh);
    }
    for (int i = 0; i < STAGES && i < nkt; ++i) load_stage(i, i);
  }

  const float* lrow = lse + (size_t)bh * ld;
  const float lse0 = row < s ? lrow[row] : 0.f;
  const float lse1 = row + 8 < s ? lrow[row + 8] : 0.f;
  // D = rowsum(dO * O) of this thread's rows, while the tiles load: the
  // four threads of a row each sum a quarter of it, then exchange. K3
  // reads it back, rows [s, ld) as 0.
  const float dd0 = row_dot<D>(dout, o, (size_t)bh * s, row, s, c);
  const float dd1 = row_dot<D>(dout, o, (size_t)bh * s, row + 8, s, c);
  if (c == 0) {
    if (row < ld) delta[(size_t)bh * ld + row] = dd0;
    if (row + 8 < ld) delta[(size_t)bh * ld + row + 8] = dd1;
  }
  const float* mrow = mask ? mask + (size_t)(bh / heads) * s : nullptr;

  float dq_acc[H][32];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[h][i] = 0.f;

  mbar_wait(qo_bar, 0);
  for (int it = 0; it < nkt; ++it) {
    const int st = it % STAGES;
    const int k0 = it * ROWS;
    const uint32_t kb = base + L::K + st * L::T;
    const uint32_t vb = base + L::V + st * L::T;
    mbar_wait(full0 + 8 * st, (it / STAGES) & 1);

    // S = Q K^T, dP = dO V^T: rows = q, columns = keys
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss_n64(sc, desc_k(base + L::Q + kslice(kk, ROWS)),
                   desc_k(kb + kslice(kk, ROWS)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss_n64(dp, desc_k(base + L::O + kslice(kk, ROWS)),
                   desc_k(vb + kslice(kk, ROWS)), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS in registers: element 4j + r is q row row (+8 for r >= 2), key
    // column k0 + 8j + 2c (+1 for odd r)
    const bool edge = (causal && k0 + ROWS - 1 > q0) || k0 + ROWS > s ||
                      q0 + ROWS > s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * j + r;
        const int qpos = row + (r & 2) * 4;
        const int kpos = k0 + 8 * j + 2 * c + (r & 1);
        const bool keep = !edge || ((!causal || qpos >= kpos) && qpos < s &&
                                    kpos < s);
        const float bias = (mrow && kpos < s) ? mrow[kpos] : 0.f;
        float p;
        p_ds(sc[i], dp[i], bias, r < 2 ? lse0 : lse1, r < 2 ? dd0 : dd1,
             sm_scale, keep, p);
      }
    }

    // dQ += dS K: A from registers, B = K MN-major
    uint32_t da[KK][4];
    to_a_frags<KK>(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs_n64(dq_acc[h], da[kk],
                     desc_mn(kb + h * ROWS * ROW_BYTES + kk * 16 * ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(dq_acc[h]);

    __syncthreads();   // the warpgroup is done with stage st
    if (tid == 0 && it + STAGES < nkt) load_stage(st, it + STAGES);
  }

  store_tile<D>(dq + (size_t)bh * s * D, dq_acc, row, s, c);
}


// -------------------------------------------------------------------- host

// [bh, ld] f32 as a 2-D map, box of `cols` values of one head
bool map_vec(EncodeTiled enc, CUtensorMap* m, const float* p, int bh, int ld,
             int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)bh};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)cols, 1};
  const cuuint32_t unit[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v, *dout, *o;
  const float *lse, *delta, *mask;
  void *dq, *dk, *dv;
  int bh, heads, s, d, ld;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <int D> cudaError_t launch_dkv(EncodeTiled enc, const Args& a) {
  CUtensorMap tq, tk, tv, tdo, tl, td;
  if (!map_rows(enc, &tq, a.q, a.bh, a.s, D, BQ) ||
      !map_rows(enc, &tdo, a.dout, a.bh, a.s, D, BQ) ||
      !map_rows(enc, &tk, a.k, a.bh, a.s, D, ROWS) ||
      !map_rows(enc, &tv, a.v, a.bh, a.s, D, ROWS) ||
      !map_vec(enc, &tl, a.lse, a.bh, a.ld, BQ) ||
      !map_vec(enc, &td, a.delta, a.bh, a.ld, BQ))
    return cudaErrorInvalidValue;
  auto* kern = flash_bwd_dkv_tc_kernel<D>;
  const int smem = DkvLayout<D>::BYTES;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem(smem_set, kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s + ROWS - 1) / ROWS);   // low key tiles first
  kern<<<grid, WG, smem, a.stream>>>(
      tq, tk, tv, tdo, tl, td, a.mask, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.heads, a.s, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int D> cudaError_t launch_dq(EncodeTiled enc, const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  if (!map_rows(enc, &tq, a.q, a.bh, a.s, D, ROWS) ||
      !map_rows(enc, &tdo, a.dout, a.bh, a.s, D, ROWS) ||
      !map_rows(enc, &tk, a.k, a.bh, a.s, D, ROWS) ||
      !map_rows(enc, &tv, a.v, a.bh, a.s, D, ROWS))
    return cudaErrorInvalidValue;
  auto* kern = flash_bwd_dq_tc_kernel<D>;
  const int smem = DqLayout<D>::BYTES;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem(smem_set, kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s + ROWS - 1) / ROWS);
  kern<<<grid, WG, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const __nv_bfloat16*>(a.o), a.lse,
      const_cast<float*>(a.delta), a.ld, a.mask,
      static_cast<__nv_bfloat16*>(a.dq), a.heads, a.s, a.sm_scale, a.causal);
  return cudaGetLastError();
}

int run(const Args& a, bool dkv) {
  if (a.bh <= 0 || a.heads <= 0 || a.bh % a.heads || a.s <= 0 ||
      (a.d != 64 && a.d != 128) || a.ld < a.s || a.ld % 4 ||
      (a.s + ROWS - 1) / ROWS > 65535 || !aligned16(a.q) ||
      !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout) ||
      !aligned16(a.lse) || !aligned16(a.delta) || (!dkv && !aligned16(a.o)))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  if (dkv)
    return (int)(a.d == 64 ? launch_dkv<64>(enc, a) : launch_dkv<128>(enc, a));
  return (int)(a.d == 64 ? launch_dq<64>(enc, a) : launch_dq<128>(enc, a));
}

}  // namespace

// q, k, v, dout, o: contiguous bf16 [bh, s, d], d in {64, 128}, 16-byte
// aligned; lse, delta: f32 [bh, ld] (ld >= s, a multiple of 4; the
// forward's logsumexp and D = rowsum(dO * O)); mask: NULL or contiguous
// f32 [bh / heads, s]. K4 writes dq (bf16 [bh, s, d]) and, from dout and
// o, delta (rows [s, ld) as 0); K3 reads delta and writes dk, dv. So a
// backward launches K4 first. Each launches on `stream` and returns a
// cudaError_t (0 on success); neither synchronises.
extern "C" int hetu_flash_bwd_tc_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const float* mask, void* dk, void* dv,
                                     int bh, int heads, int s, int d, int ld,
                                     float sm_scale, int causal,
                                     void* stream) {
  const Args a{q,  k,  v,  dout,  nullptr, lse, delta, mask,     nullptr,
               dk, dv, bh, heads, s,       d,   ld,    sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run(a, true);
}

extern "C" int hetu_flash_bwd_tc_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* o, const float* lse,
                                    const float* mask, void* dq,
                                    float* delta, int bh, int heads, int s,
                                    int d, int ld, float sm_scale,
                                    int causal, void* stream) {
  const Args a{q,       k,       v,  dout,  o, lse, delta, mask,     dq,
               nullptr, nullptr, bh, heads, s, d,   ld,    sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run(a, false);
}

extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
