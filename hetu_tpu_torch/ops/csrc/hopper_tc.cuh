// Helpers shared by the tensor-core flash-attention kernels for Hopper,
// sm_90a: flash_fwd_tc.cu (K1/K2) and flash_bwd_tc.cu (K3/K4).
//
// - mbarrier init / expect-tx / wait (a wait that never completes traps);
// - TMA tile loads (cp.async.bulk.tensor, 2-D and 3-D);
// - wgmma: shared-memory matrix descriptors of 128-byte-swizzled tiles,
//   m64n64k16 bf16 -> f32 with both operands from shared memory (ss) or
//   A from registers (rs), fences, and the accumulator -> A-fragment
//   conversion (to_a_frags);
// - the epilogue store of a 64 x D accumulator (store_tile);
// - host side: libcuda's cuTensorMapEncodeTiled found through the
//   runtime (encoder), [bh, s, d] bf16 tensor maps (map_rows), and a
//   kernel's shared-memory limit raised once per device (allow_smem).
//
// Tiles are stored as TMA writes them with 128-byte swizzle: rows of 64
// bf16 (128 B), 8-row groups 1024 B apart, a D=128 tile as two 64-column
// blocks of `rows` x 128 B. Each source that includes this header is
// its own shared library; everything here has internal linkage.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int WG = 128;         // one consumer warpgroup a block
constexpr int ROWS = 64;        // resident rows: one wgmma M tile
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

// barriers initialised by thread 0, visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
