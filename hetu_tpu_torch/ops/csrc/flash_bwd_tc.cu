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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int WG = 128;       // one consumer warpgroup a block
constexpr int ROWS = 64;      // resident rows: one wgmma M tile
constexpr int BQ = 64;        // q rows K3 streams a tile (N of S^T, dP^T)
constexpr int STAGES = 2;     // ring of streamed tiles
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait for the phase with `parity` to complete. A load that never lands
// (a bad descriptor) traps after ~2^35 cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

// shared-memory matrix descriptor of a 128-byte-swizzled tile (1024-byte
// aligned): start address, leading and stride byte offsets, layout 1 =
// SWIZZLE_128B
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (rows = M or N, 64 contiguous K values a row): 8-row
// groups 1024 B apart; the leading offset is unused under the swizzle
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc(addr, 16, 1024);
}

// MN-major operand (rows = K, 64 contiguous N values a row): 8-row K
// groups 1024 B apart. The other offset reaches past 64 N values, which
// no instruction here does; both are set to the same 1024 B.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(o)                                                          \
  "+f"(d[(o) + 0]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]), \
      "+f"(d[(o) + 4]), "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (four bf16x2 a
// thread, the accumulator layout), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator (64 x 16*K) -> K A-fragments: slice kk holds columns
// 16kk..16kk+15, in the register order wgmma takes for A
template <int K>
__device__ __forceinline__ void to_a_frags(const float (&d)[8 * K],
                                           uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// byte offset of k16 slice kk of a K-major tile of `rows` rows whose K
// extent is split into 64-wide column blocks of rows * 128 bytes
__device__ __forceinline__ uint32_t kslice(int kk, int rows) {
  return (uint32_t)((kk / 4) * rows * ROW_BYTES + (kk % 4) * 32);
}

// p and dS of one score element (f32, before rounding)
__device__ __forceinline__ void p_ds(float sc, float& dp, float bias,
                                     float lse, float delta, float scale,
                                     bool keep, float& p) {
  p = keep ? exp2f((fmaf(sc, scale, bias) - lse) * LOG2E) : 0.f;
  dp = p * (dp - delta) * scale;
}

// store two adjacent bf16 outputs of an accumulator
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float lo,
                                       float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}

// this thread's part of a 64 x D accumulator (rows `row` and `row` + 8;
// D/64 column blocks of 32 values) -> a [s, D] bf16 matrix; rows past s
// are dropped
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* out,
                                           const float (&acc)[D / 64][32],
                                           int row, int s, int c) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * h + 8 * j + 2 * c;
      if (row < s)
        store2(out + (size_t)row * D + col, acc[h][4 * j], acc[h][4 * j + 1]);
      if (row + 8 < s)
        store2(out + (size_t)(row + 8) * D + col, acc[h][4 * j + 2],
               acc[h][4 * j + 3]);
    }
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

// aligned base of the dynamic shared memory (TMA's 128-byte swizzle
// needs 1024-byte aligned tiles; the launch asks for 1 KB of slack)
__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  return (smem_u32(smem_raw) + 1023u) & ~1023u;
}

__device__ __forceinline__ const float* smem_f32(uint32_t addr) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  return reinterpret_cast<const float*>(smem_raw +
                                        (addr - smem_u32(smem_raw)));
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [bh, s, d] bf16 as a 3-D map over (d, s, bh), box of 64 columns by
// `rows` rows of one head, 128-byte swizzle; out-of-range rows read 0
bool map_rows(EncodeTiled enc, CUtensorMap* m, const void* p, int bh, int s,
              int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

// a kernel's dynamic shared memory limit raised to `smem`, once per
// device: `done` is the kernel's bitmask of devices already set (setting
// it again is harmless, so two threads may race on it)
template <typename Kernel>
cudaError_t allow_smem(std::atomic<uint64_t>& done, Kernel* kern, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
