// Flash-attention forward on the tensor cores (K1, and K2 with its
// logsumexp output) for Hopper, sm_90a: bf16 at head dims 64 and 128.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// hetu_tpu/ops/pallas_attention.py (launched by `_flash_attention_jit`,
// need_lse=False for K1, True for K2) on that route; flash_fwd.cu keeps
// f32 and the other head dims. It computes
//   out = softmax(q k^T * sm_scale + mask) v   over [B*H, S, D],
// an online softmax over K/V tiles, so no [S, S] matrix reaches device
// memory; with `lse` set (K2) also each row's logsumexp m + log(l) as
// plain f32 [B*H, S], natural-log units (the residual the fused backward
// recomputes p from).
//
// Bound. 4 S^2 D flops per (batch*head), halved under causal, against
// four [S, D] bf16 tensors: S/2 flops a byte (S/4 causal) against the
// ~295 at which the tensor cores, not the memory, limit the card. So
// the training shape (S=1024, causal) is bound by its bytes, but only
// if both products run on the tensor cores: on the CUDA cores it would
// be bound by operations, 13 times its bytes. One warpgroup (128
// threads) a block, one block per (batch*head, 64-row q tile), the
// heaviest causal tiles launched first. Q stays resident in shared
// memory; K and V stream through a ring of STAGES stages, each loaded by
// TMA and completed on an mbarrier, thread 0 issuing a stage's next load
// as soon as the warpgroup is done with it, so tile j+1 loads while tile
// j computes. Per K/V tile:
//   S = Q K^T        wgmma, both operands K-major from shared memory;
//   online softmax   in registers: each thread holds two rows of S, a
//                    row's max and sum are reduced over the four threads
//                    of its quad by two shuffles, the running m and l are
//                    f32 and the f32 O accumulator is rescaled by alpha;
//   O += P V         p rounded to bf16 is already wgmma's A-fragment
//                    layout, so A comes from registers and B = V is read
//                    MN-major: p never touches shared memory.
// Causal: the K loop stops at the diagonal and only the tile that
// crosses it is position-masked. A block needs 8 KB of Q and 16 KB a
// stage at D=64, so three or four share an SM and overlap one another's
// softmax with their products.
//
// Tiles are stored as TMA writes them with 128-byte swizzle (see
// hopper_tc.cuh); 3-D descriptors over (d, s, batch*head), so rows past S
// read as zeros, never as the next head's rows. Keys past S are masked to
// -inf, rows past S are not stored.
//
// Numerics follow the reference kernel: products take bf16 operands with
// f32 accumulation; all softmax math is f32; the score is formed as
// acc * sm_scale + mask in f32, two roundings in that order, as the
// reference does (with a -1e9 padding mask the f32 spacing is 64, so any
// other order changes which keys of a fully masked row survive); log2(e)
// is folded in only after the row max is subtracted; masked positions
// take NEG_INF = -1e30 as in the reference; p is rounded to bf16 before
// P V while the row sum uses the unrounded p.
//
// Build: `nvcc -shared` with a plain C interface, no -lcuda (see
// hopper_tc.cuh); three tensor maps encoded per call, the kernel's shared
// memory limit raised once per device.
#include <math.h>

#include "hopper_tc.cuh"

namespace {

constexpr int STAGES = 2;          // ring of streamed K/V tiles
constexpr float NEG_INF = -1e30f;  // the reference kernel's masked score

template <int D> struct FwdLayout {
  static constexpr int T = ROWS * D * 2;  // one 64-row bf16 tile
  static constexpr int Q = 0, K = T;
  static constexpr int V = K + STAGES * T;
  static constexpr int BAR = V + STAGES * T;       // q, then full[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WG)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ mask,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int heads, int s, float sm_scale, int causal) {
  using L = FwdLayout<D>;
  constexpr int H = D / 64;      // 64-wide column blocks of a row
  constexpr int KD = D / 16;     // k16 slices over the head dim
  constexpr int KK = ROWS / 16;  // k16 slices over the key tile
  const uint32_t base = smem_base();
  const uint32_t q_bar = base + L::BAR, full0 = q_bar + 8;

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
    mbar_init(q_bar, 1);
    for (int i = 0; i < STAGES; ++i) mbar_init(full0 + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, L::T);
#pragma unroll
    for (int h = 0; h < H; ++h)
      tma_load_3d(base + L::Q + h * ROWS * ROW_BYTES, &tq, q_bar, 64 * h, q0,
                  bh);
    for (int i = 0; i < STAGES && i < nkt; ++i) load_stage(i, i);
  }
  const float* mrow = mask ? mask + (size_t)(bh / heads) * s : nullptr;

  float o_acc[H][32];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[h][i] = 0.f;
  // running max and sum of rows `row` (0) and `row` + 8 (1)
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_bar, 0);
  for (int it = 0; it < nkt; ++it) {
    const int st = it % STAGES;
    const int k0 = it * ROWS;
    const uint32_t kb = base + L::K + st * L::T;
    const uint32_t vb = base + L::V + st * L::T;
    mbar_wait(full0 + 8 * st, (it / STAGES) & 1);

    // S = Q K^T: rows = q, columns = keys
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss_n64(sc, desc_k(base + L::Q + kslice(kk, ROWS)),
                   desc_k(kb + kslice(kk, ROWS)), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores: element 4j + r is q row `row` (+8 for r >= 2), key column
    // k0 + 8j + 2c (+1 for odd r)
    const bool edge = (causal && k0 + ROWS - 1 > q0) || k0 + ROWS > s;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kc = k0 + 8 * j + 2 * c;
      float b0 = 0.f, b1 = 0.f;
      if (mrow) {
        b0 = kc < s ? mrow[kc] : 0.f;
        b1 = kc + 1 < s ? mrow[kc + 1] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * j + r;
        float x = __fmul_rn(sc[i], sm_scale);
        if (mrow) x = __fadd_rn(x, (r & 1) ? b1 : b0);
        if (edge) {
          const int kpos = kc + (r & 1);
          if (causal && row + (r & 2) * 4 < kpos) x = NEG_INF;
          if (kpos >= s) x = -INFINITY;
        }
        sc[i] = x;
        if (r < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f((m0 - mn0) * LOG2E);
    const float a1 = exp2f((m1 - mn1) * LOG2E);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool lo = (i & 2) == 0;
      const float p = exp2f((sc[i] - (lo ? mn0 : mn1)) * LOG2E);
      sc[i] = p;
      if (lo)
        rs0 += p;
      else
        rs1 += p;
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[h][i] *= (i & 2) ? a1 : a0;

    // O += P V: A = p rounded to bf16 from registers, B = V MN-major
    uint32_t pa[KK][4];
    to_a_frags<KK>(sc, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs_n64(o_acc[h], pa[kk],
                     desc_mn(vb + h * ROWS * ROW_BYTES + kk * 16 * ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(o_acc[h]);

    __syncthreads();   // the warpgroup is done with stage st
    if (tid == 0 && it + STAGES < nkt) load_stage(st, it + STAGES);
  }

#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[h][i] /= (i & 2) ? l1 : l0;
  store_tile<D>(o + (size_t)bh * s * D, o_acc, row, s, c);
  if (lse && c == 0) {
    if (row < s) lse[(size_t)bh * s + row] = m0 + logf(l0);
    if (row + 8 < s) lse[(size_t)bh * s + row + 8] = m1 + logf(l1);
  }
}

template <int D>
cudaError_t launch(EncodeTiled enc, const void* q, const void* k,
                   const void* v, const float* mask, void* o, float* lse,
                   int bh, int heads, int s, float sm_scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!map_rows(enc, &tq, q, bh, s, D, ROWS) ||
      !map_rows(enc, &tk, k, bh, s, D, ROWS) ||
      !map_rows(enc, &tv, v, bh, s, D, ROWS))
    return cudaErrorInvalidValue;
  auto* kern = flash_fwd_tc_kernel<D>;
  const int smem = FwdLayout<D>::BYTES;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem(smem_set, kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + ROWS - 1) / ROWS);
  kern<<<grid, WG, smem, stream>>>(tq, tk, tv, mask,
                                   static_cast<__nv_bfloat16*>(o), lse,
                                   heads, s, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 [bh, s, d], d in {64, 128}, q, k, v 16-byte
// aligned; mask: NULL or contiguous f32 [bh / heads, s]; lse: NULL (K1)
// or contiguous f32 [bh, s] (K2). Launches on `stream` and returns a
// cudaError_t (0 on success); never synchronises.
extern "C" int hetu_flash_fwd_tc(const void* q, const void* k, const void* v,
                                 const float* mask, void* o, float* lse,
                                 int bh, int heads, int s, int d,
                                 float sm_scale, int causal, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads || s <= 0 ||
      (d != 64 && d != 128) || (s + ROWS - 1) / ROWS > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      (reinterpret_cast<uintptr_t>(o) & 3))
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(d == 64 ? launch<64>(enc, q, k, v, mask, o, lse, bh, heads, s,
                                    sm_scale, causal, st)
                       : launch<128>(enc, q, k, v, mask, o, lse, bh, heads,
                                     s, sm_scale, causal, st));
}

extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
