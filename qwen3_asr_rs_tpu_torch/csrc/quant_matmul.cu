// Weight-only int8 matmul: out = (x @ w_q) * scales, the CUDA counterpart
// of the Pallas kernel
// qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py::quant_matmul.
//
// x (R, K) T; w_q (K, N) int8, row-major (the quantizer's layout, which K1
// reads too); scales (N,) float32; out (R, N) OutT. Products are formed
// from x's values and the int8 weights (an int8 is exact in bf16 and in
// float32, and a bf16 x int8 product is exact in float32), accumulate in
// float32, and the per-column scale multiplies the whole K sum (every K
// split's partial added first) before the one rounding to OutT. x is
// never quantized. Instances:
//   quant_matmul_bf16       x bf16, out bf16: the Pallas kernel's
//                           contract; the int8 linears of a bf16 decoder.
//   quant_matmul_bf16_f32   x bf16, out float32: the int8 lm_head, whose
//                           logits stay float32.
//   quant_matmul_f32        x float32, out float32: the float32 model's
//                           contract (the JAX decoder keeps x in float32).
//
// Three routes, chosen from the shapes (qm_plan; the wrapper's
// launch_plan mirrors it):
// - bf16 x, R > 32 (prefill rows: 96 to 4736 per clip, 3456 for a batch
//   of 8 clips of 30 s): bound by operations, 2 R K N (the 300 s clip's
//   four linears over 28 layers: 4.17 TFLOP, 4.2 ms at the data sheet's
//   989 TFLOP/s). qmm_wgmma_kernel computes out^T = W^T x^T in 128 x 128
//   tiles, two blocks per SM: a producer warp keeps a 3-stage ring of x
//   and int8 weight stages full by TMA (mbarrier full/empty per stage);
//   each of two consumer warpgroups converts its 64 weight columns of the
//   next stage exactly to bf16 (gm_i8_pair) into a swizzled MN-major tile
//   while the tensor cores run wgmma.m64n128k16 on the current one (A: the
//   converted weight, with the transpose bit; B: x's K-major stage). Both
//   operands come from shared memory, so no register but the accumulators
//   feeds wgmma and ptxas keeps the products asynchronous; with the
//   weight as the register operand instead, it serialized them. Ragged R,
//   N and K land as zeros (TMA out of bounds; a weight whose rows are not
//   16-byte aligned comes by 8-byte cp.async). Where the tiles cannot fill
//   the card (R = 432: 32 tiles for o and down), K is split, at most one
//   round of two blocks per SM and at least 4 stages per split; the
//   partials go to a workspace and qmm_sum_kernel adds them in split order
//   and applies the scale (no atomics). The output tile is staged in
//   shared memory and stored in 16-byte rows.
// - bf16 x, R <= 32 (the lm_head at the last prompt token and at each
//   decode step, up to 32 rows of a batch): bound by the weight bytes
//   (156 MB at 0.6B, 46 us at 3.35 TB/s), read once whatever R is:
//   qmv8_mma_kernel, gemv_mma.cuh's tensor-core GEMV blocks on int8
//   weights (mma.sync, 64 columns per block, a 4-stage cp.async ring, the
//   K split of gm_split_rows), the split partials summed as above. Even
//   at R = 1 they beat the CUDA-core GEMV (qmv_kernel: 0.078 against
//   0.072 ms device time on an H100 SXM), so bf16 x never takes it.
// - float32 x: the CUDA cores, qmv_kernel (R <= 8) and qmm_kernel (128 x
//   128 tiles). TF32 would round x, and three bf16 terms per element
//   would triple the tensor-core work of a path that only checks parity.
#include <cuda.h>

#include "gemv_mma.cuh"

enum QmRoute { QM_CORES = 0, QM_GEMV = 1, QM_WGMMA = 2 };

// ---- float32 x: the CUDA cores ------------------------------------------

constexpr int QMV_TX = 32;   // threads across columns, 8 columns each
constexpr int QMV_TY = 8;    // threads across K
constexpr int QMV_CPT = 8;
constexpr int QMV_TN = QMV_TX * QMV_CPT;  // 256 columns per block

template <typename T> __device__ __forceinline__ void store_out(T* p, float v) {
  *p = from_f<T>(v);
}

__device__ __forceinline__ void int8x8_to_float(uint2 u, float* w) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = (float)b[i];
}

// R <= 8: block (QMV_TX, QMV_TY) covers 256 columns and all of K for rows
// [blockIdx.z * NR, +NR); the K partials of the QMV_TY thread rows are
// added in shared memory, in row order.
template <typename T, typename OutT, int NR>
__global__ void __launch_bounds__(QMV_TX * QMV_TY)
qmv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scales, OutT* __restrict__ out, int R,
           int K, int N) {
  __shared__ float red[QMV_TY][QMV_TN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * QMV_TX + tx;
  const int r0 = blockIdx.z * NR;
  const int nrows = min(NR, R - r0);
  const int n0 = blockIdx.x * QMV_TN + tx * QMV_CPT;
  float acc[NR][QMV_CPT];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < QMV_CPT; ++c) acc[r][c] = 0.f;
  if (n0 < N) {
#pragma unroll 4
    for (int k = ty; k < K; k += QMV_TY) {
      float wf[QMV_CPT];
      int8x8_to_float(__ldg(reinterpret_cast<const uint2*>(w + (size_t)k * N + n0)),
                      wf);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < nrows) {
          const float xv = to_f(x[(size_t)(r0 + r) * K + k]);
#pragma unroll
          for (int c = 0; c < QMV_CPT; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
        }
      }
    }
  }
  const int n = blockIdx.x * QMV_TN + tid;  // column this thread finishes
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= nrows) break;
#pragma unroll
    for (int c = 0; c < QMV_CPT; ++c) red[ty][tx * QMV_CPT + c] = acc[r][c];
    __syncthreads();
    if (n < N) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < QMV_TY; ++y) s += red[y][tid];
      store_out(out + (size_t)(r0 + r) * N + n, s * scales[n]);
    }
    __syncthreads();
  }
}

constexpr int QMM_BM = 128, QMM_BN = 128, QMM_BK = 16;
constexpr int QMM_THREADS = 256;  // 16 x 16, an 8 x 8 register tile each

// R > 8: block (blockIdx.x, blockIdx.y) computes rows [by*128, +128) x
// columns [bx*128, +128). Per 16-deep K slice, x (128 x 16) and w (16 x
// 128) are staged as float32 in shared memory; thread (tx, ty) owns rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, and the same split of columns,
// so a warp's shared-memory reads are broadcasts or conflict-free float4s.
template <typename T, typename OutT>
__global__ void __launch_bounds__(QMM_THREADS)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scales, OutT* __restrict__ out, int R,
           int K, int N) {
  __shared__ __align__(16) float xs[QMM_BK][QMM_BM];
  __shared__ __align__(16) float ws[QMM_BK][QMM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * QMM_BM, col0 = blockIdx.x * QMM_BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // loaders: x as 128 rows x 16 k (8 per thread: row tid/2, k (tid%2)*8
  // .. +8); w as 16 k x 128 columns (8 bytes per thread: k tid/16,
  // columns (tid%16)*8 .. +8)
  const int xr = tid / 2, xk = (tid % 2) * 8;
  const int wk = tid / 16, wc = (tid % 16) * 8;
  for (int k0 = 0; k0 < K; k0 += QMM_BK) {
    {
      const int r = row0 + xr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + xk + i;
        xs[xk + i][xr] = (r < R && k < K) ? to_f(x[(size_t)r * K + k]) : 0.f;
      }
      const int k = k0 + wk, c = col0 + wc;
      float wf[8];
      if (k < K && c < N) {  // N % 8 == 0: all 8 columns are in range
        int8x8_to_float(__ldg(reinterpret_cast<const uint2*>(w + (size_t)k * N + c)),
                        wf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) wf[i] = 0.f;
      }
      *reinterpret_cast<float4*>(&ws[wk][wc]) = make_float4(wf[0], wf[1], wf[2], wf[3]);
      *reinterpret_cast<float4*>(&ws[wk][wc + 4]) = make_float4(wf[4], wf[5], wf[6], wf[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QMM_BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < N) store_out(out + (size_t)r * N + c, acc[i][j] * scales[c]);
    }
  }
}

namespace {

// Rows [k0, k0 + ROWS) and columns [c0, c0 + 16 * CH) of the int8 weight
// (row stride N bytes) into st, rows of `pitch` bytes; rows >= kend and
// columns >= N land as zeros. 16-byte copies where every row starts
// 16-byte aligned (al16), else 8-byte ones (N % 8 == 0).
template <int ROWS, int CH, int NTHREADS>
__device__ __forceinline__ void qm_load_w8(unsigned char* st, int pitch,
                                           const int8_t* w, int N, int k0,
                                           int kend, int c0, bool al16,
                                           int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH, k = k0 + r, n = c0 + 16 * c;
    unsigned char* d = st + r * pitch + 16 * c;
    const int8_t* s = w + (size_t)k * N + n;
    if (al16) {
      const bool ok = k < kend && n < N;
      cp_async16(d, ok ? s : w, ok);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = k < kend && n + 8 * h < N;
        cp_async8(d + 8 * h, ok ? s + 8 * h : w, ok);
      }
    }
  }
}

}  // namespace

// ---- bf16 x, R <= 32: the tensor-core GEMV blocks -----------------------

// y = x @ W for up to 32 rows (8 * NB8 staged, the rest zero): each block
// owns GM_TN columns and kb rows of K from blockIdx.y * kb; each warp 16
// columns, one float32 accumulator per (row, column) summed in K order.
// One split: the scaled sums are the output; else the split's partials
// go to ws (split, row, column) for qmm_sum_kernel.
template <typename OutT, int NB8>
__global__ void __launch_bounds__(GM_THREADS, 1)
qmv8_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, OutT* __restrict__ out,
                float* __restrict__ ws, int R, int K, int N, int kb,
                int al16) {
  constexpr int SB = gm_stage_bytes<W_INT8>();
  extern __shared__ __align__(16) unsigned char q8_buf[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = gridDim.y, split = blockIdx.y, c0 = blockIdx.x * GM_TN;
  const int k_begin = split * kb, k_end = min(K, k_begin + kb);
  const int nst = (k_end - k_begin + GM_KS - 1) / GM_KS;
  const int xstride = nst * GM_KS + GM_XPAD;
  bf16* xs = reinterpret_cast<bf16*>(q8_buf + GM_STAGES * SB);

  // the block's K range of x's rows as one cp.async group, zero past R
  // and K
  const int chunks = nst * GM_KS / 8;
  for (int i = tid; i < 8 * NB8 * chunks; i += GM_THREADS) {
    const int r = i / chunks, c = 8 * (i % chunks), k = k_begin + c;
    const bool ok = r < R && k < k_end;
    cp_async16(xs + (size_t)r * xstride + c,
               ok ? x + (size_t)r * K + k : x, ok);
  }
  cp_async_commit();
  auto fetch = [&](int st) {
    if (st < nst) {
      qm_load_w8<GM_KS, GM_TN / 16, GM_THREADS>(
          q8_buf + (st % GM_STAGES) * SB, GM_BROW, w, N,
          k_begin + st * GM_KS, k_end, c0, al16, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) fetch(s);

  float acc[NB8][4];
#pragma unroll
  for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nb][c] = 0.f;
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<GM_STAGES - 2>();
    __syncthreads();  // stage st landed; stage st - 1 is free for reuse
    fetch(st + GM_STAGES - 1);
    const unsigned char* p = q8_buf + (st % GM_STAGES) * SB;
#pragma unroll
    for (int kk = 0; kk < GM_KS / 16; ++kk) {
      unsigned a[4];
      gm_frag_int8(p, kk, warp, lane, a);
#pragma unroll
      for (int nb = 0; nb < NB8; ++nb) {
        unsigned b[2];
        gm_frag_x(xs, xstride, st * GM_KS + 16 * kk, nb, lane, b);
        gm_mma(acc[nb], a, b);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = 8 * nb + gm_acc_row(lane, c);
      const int n = c0 + gm_col<W_INT8>(warp, lane, c >> 1);
      if (r >= R || n >= N) continue;
      if (nk == 1) {
        out[(size_t)r * N + n] = from_f<OutT>(acc[nb][c] * scales[n]);
      } else {
        ws[((size_t)split * R + r) * N + n] = acc[nb][c];
      }
    }
}

// ---- bf16 x, R > 32: warpgroup tiles on wgmma ---------------------------

constexpr int QM_GEMV_ROWS = 32;   // bf16 rows the GEMV blocks take
constexpr int QM_BM = 128;         // rows of x per tile: wgmma's N side
constexpr int QM_BN = 128;         // weight columns per tile: 64 per warpgroup
constexpr int QM_BK = 64;          // K rows per stage: 128 bytes of bf16 x
constexpr int QM_STAGES = 3;
constexpr int QM_CONSUMERS = 256;  // two warpgroups
constexpr int QM_THREADS = QM_CONSUMERS + 32;  // and the producer warp
constexpr int QM_XS_BYTES = QM_BM * QM_BK * 2;  // a swizzled x stage
constexpr int QM_W8_BYTES = QM_BK * QM_BN;      // an int8 weight stage
constexpr int QM_A_BYTES = QM_BK * 64 * 2;      // a warpgroup's bf16 A tile
// the rings, each warpgroup's two A tiles, a full and an empty barrier
// per stage, and the slack that aligns the swizzled tiles: two blocks fit
// on an SM
constexpr int QM_RING =
    QM_STAGES * (QM_XS_BYTES + QM_W8_BYTES) + 2 * 2 * QM_A_BYTES;
constexpr int QM_SMEM = QM_RING + 2 * QM_STAGES * 8 + 1024;
static_assert(QM_BM * (QM_BN + 4) * 4 <= QM_RING,
              "the staged output tile fits the rings");
// Blocks a split launch aims at: two per SM of the H100 SXM's 132
constexpr int QM_TARGET_BLOCKS = 264;
constexpr int QM_MIN_STAGES = 4;   // K stages a split keeps at least

// The descriptor of a 128-byte-swizzled shared-memory operand, layout
// type 1 = SW128, 8-row groups 1024 bytes apart (the stride offset).
// K-major (x, the B operand): rows of 128 bytes (64 bf16 of K); the
// leading offset is unused. MN-major (the weight, the A operand, with the
// transpose bit): per K row 128 bytes of 64 columns, K rows 128 bytes
// apart; one 64-column atom, so the leading offset is unused too.
__device__ __forceinline__ uint64_t qm_desc(const void* smem) {
  const unsigned a = gm_smem_u32(smem);
  return (uint64_t)((a >> 4) & 0x3FFF) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void qm_fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void qm_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   gm_smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void qm_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   gm_smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void qm_bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   gm_smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void qm_bar_wait(uint64_t* bar, int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(gm_smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// The barrier's arrival once this thread's earlier cp.async copies land.
__device__ __forceinline__ void qm_bar_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   gm_smem_u32(bar)) : "memory");
}
// A box of a 2-D tensor map at (c0 inner, c1 outer) into shared memory,
// its bytes counted on bar; out of bounds lands as zeros.
__device__ __forceinline__ void qm_tma_2d(void* dst, const CUtensorMap* map,
                                          int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(gm_smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(gm_smem_u32(bar))
      : "memory");
}

// d (64 x 128 float32) += A (64 x 16 bf16, MN-major: the transpose bit) *
// B (16 x 128 bf16, K-major), both from shared memory
__device__ __forceinline__ void qm_wgmma(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Byte offset of weight column c and K row k in an int8 stage: 128-byte
// rows, the 16-byte chunk c / 16 at chunk ^ (k & 7) (the tensor map's
// 128-byte swizzle).
__device__ __forceinline__ int qm_w8_at(int k, int c) {
  return k * 128 + (((c >> 4) ^ (k & 7)) << 4) + (c & 15);
}

// Warpgroup g's 64 columns of an int8 stage as its bf16 A tile, exactly
// (gm_i8_pair): column m of K row k at 128 k, its 16-byte chunk m / 8 at
// chunk ^ (k & 7). Per thread 16 int8 bytes of one row in, two 16-byte
// chunks out: a warp reads 512 bytes of 8 rows and each of its two stores
// writes 512 bytes, each touching every 16-byte bank group four times (no
// conflicts).
__device__ __forceinline__ void qm_convert(const unsigned char* w8,
                                           unsigned char* a, int g, int t) {
#pragma unroll
  for (int i = t; i < QM_BK * 4; i += 128) {
    const int k = i >> 2, m = 16 * (i & 3);
    const uint4 u =
        *reinterpret_cast<const uint4*>(w8 + qm_w8_at(k, 64 * g + m));
    const uint4 lo = make_uint4(gm_i8_pair(u.x, 0, 1), gm_i8_pair(u.x, 2, 3),
                                gm_i8_pair(u.y, 0, 1), gm_i8_pair(u.y, 2, 3));
    const uint4 hi = make_uint4(gm_i8_pair(u.z, 0, 1), gm_i8_pair(u.z, 2, 3),
                                gm_i8_pair(u.w, 0, 1), gm_i8_pair(u.w, 2, 3));
    unsigned char* row = a + k * 128;
    *reinterpret_cast<uint4*>(row + (((m >> 3) ^ (k & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + ((((m >> 3) + 1) ^ (k & 7)) << 4)) = hi;
  }
}

// The accumulators (out^T) as E in a staged (QM_BM, QM_BN + 16 / sizeof(E))
// tile, times the column scales where `scaled`, then 16-byte stores of its
// rows < R and columns < N into dst (row stride N), by every thread of the
// block. Accumulator 4 j + 2 i + c of consumer thread (warpgroup g, warp
// w, lane l) is weight column 64 g + 16 w + l / 4 + 8 i and row of x 8 j +
// 2 (l % 4) + c.
template <typename E>
__device__ __forceinline__ void qm_store_tile(unsigned char* smem,
                                              const float* acc,
                                              const float* scales, bool scaled,
                                              E* dst, int r0, int c0, int R,
                                              int N, int tid) {
  constexpr int VPC = 16 / sizeof(E);  // values per 16-byte chunk
  constexpr int PITCH = QM_BN + VPC;   // staged row, elements
  E* st = reinterpret_cast<E*>(smem);
  if (tid < QM_CONSUMERS) {
    const int g = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 64 * g + 16 * w + (l >> 2) + 8 * i;
      const float s =
          !scaled ? 1.f : c0 + col < N ? __ldg(scales + c0 + col) : 0.f;
#pragma unroll
      for (int j = 0; j < QM_BM / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          st[(8 * j + 2 * (l & 3) + c) * PITCH + col] =
              from_f<E>(acc[4 * j + 2 * i + c] * s);
        }
    }
  }
  __syncthreads();
  constexpr int CPR = QM_BN / VPC;  // chunks per row
  for (int i = tid; i < QM_BM * CPR; i += QM_THREADS) {
    const int r = i / CPR, c = VPC * (i % CPR);
    if (r0 + r < R && c0 + c < N) {
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * N + c0 + c) =
          *reinterpret_cast<const uint4*>(st + r * PITCH + c);
    }
  }
}

// out^T = W^T x^T on the tensor cores: block (blockIdx.x, blockIdx.y,
// blockIdx.z) owns weight columns [128 x, +128), rows of x [128 y, +128)
// and K rows [z kb, +kb); warpgroup g the columns 64 g .. +64.
// The producer warp keeps a ring of QM_STAGES stages full: per stage one
// thread arms the stage's full barrier with its bytes and issues TMA
// copies of x's box (K-major, 128-byte swizzle: wgmma's B layout) and of
// the int8 weight's box; a weight whose rows are not 16-byte aligned
// comes by 8-byte cp.async from the warp's lanes instead, in the same
// layout. Each warpgroup converts its columns of stage s + 1 into its
// second A tile while the tensor cores run stage s (wgmma.m64n128k16, 4
// per stage, one commit group; wait_group 1 retires stage s - 1, whose
// slots then go back to the producer: the empty barrier, one arrival per
// consumer warp). No register is an operand of wgmma but the
// accumulators, so ptxas keeps the products asynchronous. One split
// (gridDim.z == 1): the scaled tile is the output; else the split's
// partials go to ws (split, row, column).
template <typename OutT>
__global__ void __launch_bounds__(QM_THREADS, 2)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const int8_t* __restrict__ w, const float* __restrict__ scales,
                 OutT* __restrict__ out, float* __restrict__ ws, int R, int K,
                 int N, int kb, int tma_w) {
  constexpr int S = QM_STAGES;
  extern __shared__ __align__(16) unsigned char qm_raw[];
  unsigned char* smem =
      qm_raw + ((1024 - (gm_smem_u32(qm_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                        // ring of x stages
  unsigned char* w8 = xs + S * QM_XS_BYTES;        // ring of int8 stages
  unsigned char* at = w8 + S * QM_W8_BYTES;        // [warpgroup][2] A tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + QM_RING);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * QM_BN, r0 = blockIdx.y * QM_BM;
  const int nk = gridDim.z, split = blockIdx.z;
  const int k_begin = split * kb, k_end = min(K, k_begin + kb);
  const int nst = (k_end - k_begin + QM_BK - 1) / QM_BK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      qm_bar_init(full + s, tma_w ? 1 : 1 + 32);
      qm_bar_init(empty + s, QM_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64];
  if (warp == QM_CONSUMERS / 32) {
    // the producer
    for (int st = 0; st < nst; ++st) {
      const int slot = st % S, k0 = k_begin + st * QM_BK;
      if (st >= S) qm_bar_wait(empty + slot, (st / S - 1) & 1);
      unsigned char* wd = w8 + slot * QM_W8_BYTES;
      if (lane == 0) {
        qm_bar_expect(full + slot, QM_XS_BYTES + (tma_w ? QM_W8_BYTES : 0));
        qm_tma_2d(xs + slot * QM_XS_BYTES, &xmap, k0, r0, full + slot);
        if (tma_w) qm_tma_2d(wd, &wmap, c0, k0, full + slot);
      }
      if (!tma_w) {
        for (int i = lane; i < QM_BK * QM_BN / 8; i += 32) {
          const int r = i / (QM_BN / 8), c = 8 * (i % (QM_BN / 8));
          const int k = k0 + r, n = c0 + c;
          const bool ok = k < k_end && n < N;
          cp_async8(wd + qm_w8_at(r, c), ok ? w + (size_t)k * N + n : w, ok);
        }
        qm_bar_cp_async(full + slot);
      }
    }
  } else {
    const int g = warp >> 2, t = tid & 127;
    unsigned char* a = at + g * 2 * QM_A_BYTES;
    // stage st's A tile: converted, made visible to wgmma (the async
    // proxy), and the warpgroup's threads met (named barrier 1 + g)
    auto convert = [&](int st) {
      qm_bar_wait(full + st % S, (st / S) & 1);
      qm_convert(w8 + (st % S) * QM_W8_BYTES, a + (st & 1) * QM_A_BYTES, g,
                 t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
    };
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    convert(0);
    for (int st = 0; st < nst; ++st) {
      const uint64_t da = qm_desc(a + (st & 1) * QM_A_BYTES);
      const uint64_t db = qm_desc(xs + (st % S) * QM_XS_BYTES);
      qm_fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < QM_BK / 16; ++kk) {
        // K step kk: 16 rows (2048 bytes) into A, 32 bytes into x's rows
        qm_wgmma(acc, da + 128 * kk, db + 2 * kk);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      qm_fence_acc(acc);
      if (st > 0) {
        // every product of stage st - 1 has completed
        __syncwarp();
        if (lane == 0) qm_bar_arrive(empty + (st - 1) % S);
      }
      if (st + 1 < nst) convert(st + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    qm_fence_acc(acc);
  }
  __syncthreads();  // every stage consumed: the rings are free for the tile
  if (nk == 1) {
    qm_store_tile<OutT>(smem, acc, scales, true, out, r0, c0, R, N, tid);
  } else {
    qm_store_tile<float>(smem, acc, scales, false,
                         ws + (size_t)split * R * N, r0, c0, R, N, tid);
  }
}

// ---- the split-K sum ----------------------------------------------------

// out (R, N) = (sum over splits, in split order, of ws (nk, R, N)) times
// the column scales, rounded once; one thread per 4 columns of a row.
template <typename OutT>
__global__ void __launch_bounds__(256)
qmm_sum_kernel(const float* __restrict__ ws, const float* __restrict__ scales,
               OutT* __restrict__ out, int R, int N, int nk) {
  const int q = N / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * q) return;
  const int r = (int)(i / q), c = 4 * (int)(i % q);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int ks = 0; ks < nk; ++ks) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(
        ws + ((size_t)ks * R + r) * N + c));
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  OutT* o = out + (size_t)r * N + c;
  o[0] = from_f<OutT>(s.x * scales[c]);
  o[1] = from_f<OutT>(s.y * scales[c + 1]);
  o[2] = from_f<OutT>(s.z * scales[c + 2]);
  o[3] = from_f<OutT>(s.w * scales[c + 3]);
}

// ---- plan and launch ----------------------------------------------------

namespace {

int qm_gemv_nb8(int R) { return R <= 8 ? 1 : R <= 16 ? 2 : 4; }

// The launch plan of an (R, K) x (K, N) product: {route, splits, K rows
// per split, grid x, grid y, workspace floats, shared bytes}. float32 x
// takes the CUDA cores, bf16 x the GEMV blocks up to 32 rows and the
// wgmma tiles above: 128 x 128 tiles, two blocks per SM, and a K split
// where the tiles cannot fill a round.
void qm_plan(int R, int K, int N, bool f32, long long* p) {
  const int route = f32 ? QM_CORES : R <= QM_GEMV_ROWS ? QM_GEMV : QM_WGMMA;
  int splits = 1, kb = K, gx = 0, gy = 0, smem = 0;
  if (route == QM_CORES) {
    gx = R <= 8 ? (N + QMV_TN - 1) / QMV_TN : (N + QMM_BN - 1) / QMM_BN;
    gy = R <= 8 ? 1 : (R + QMM_BM - 1) / QMM_BM;
  } else if (route == QM_GEMV) {
    const int nb8 = qm_gemv_nb8(R);
    gx = (N + GM_TN - 1) / GM_TN;
    kb = gm_split_rows(K, gx, R, 1, 1, GM_KS, nb8);
    splits = (K + kb - 1) / kb;
    gy = splits;
    smem = GM_STAGES * gm_stage_bytes<W_INT8>() + 16 * nb8 * (kb + GM_XPAD);
  } else if (route == QM_WGMMA) {
    gx = (N + QM_BN - 1) / QM_BN;
    gy = (R + QM_BM - 1) / QM_BM;
    const int tiles = gx * gy, nst = (K + QM_BK - 1) / QM_BK;
    if (tiles < QM_TARGET_BLOCKS / 2) {
      splits = QM_TARGET_BLOCKS / tiles;
      const int most = nst / QM_MIN_STAGES;
      if (splits > most) splits = most;
      if (splits < 1) splits = 1;
    }
    kb = (nst + splits - 1) / splits * QM_BK;
    splits = (K + kb - 1) / kb;
    smem = QM_SMEM;
  }
  p[0] = route;
  p[1] = splits;
  p[2] = kb;
  p[3] = gx;
  p[4] = gy;
  p[5] = splits > 1 ? (long long)splits * R * N : 0;
  p[6] = smem;
}

template <typename OutT, int NB8>
cudaError_t qm_launch_gemv(const bf16* x, const int8_t* w, const float* s,
                           OutT* out, float* ws, int R, int K, int N,
                           const long long* p, bool al16,
                           cudaStream_t stream) {
  static int ready = 0;
  cudaError_t err = allow_smem(qmv8_mma_kernel<OutT, NB8>, 200 * 1024, &ready);
  if (err != cudaSuccess) return err;
  qmv8_mma_kernel<OutT, NB8><<<dim3((unsigned)p[3], (unsigned)p[4]),
                               GM_THREADS, (size_t)p[6], stream>>>(
      x, w, s, out, ws, R, K, N, (int)p[2], al16);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links the CUDA runtime only, not libcuda)
typedef CUresult (*QmEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

QmEncodeTiled qm_encoder() {
  static QmEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<QmEncodeTiled>(p);
    }
  }
  return fn;
}

// A 2-D row-major tensor (rows x cols of `bytes`-byte elements) as boxes
// of box_rows x box_cols, 128-byte swizzled, zeros out of bounds.
bool qm_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            int bytes, long long rows, long long cols, int box_rows,
            int box_cols) {
  QmEncodeTiled encode = qm_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
cudaError_t qm_launch_wgmma(const bf16* x, const int8_t* w, const float* s,
                            OutT* out, float* ws, int R, int K, int N,
                            const long long* p, bool al16,
                            cudaStream_t stream) {
  static int ready = 0;
  cudaError_t err = allow_smem(qmm_wgmma_kernel<OutT>, QM_SMEM, &ready);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  if (!qm_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, R, K, QM_BM,
              QM_BK)) {
    return cudaErrorNotSupported;
  }
  // a weight whose rows are not 16-byte aligned comes by cp.async
  wmap = xmap;
  if (al16 && !qm_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, QM_BK,
                      QM_BN)) {
    return cudaErrorNotSupported;
  }
  qmm_wgmma_kernel<OutT><<<dim3((unsigned)p[3], (unsigned)p[4],
                                (unsigned)p[1]),
                           QM_THREADS, QM_SMEM, stream>>>(
      xmap, wmap, w, s, out, ws, R, K, N, (int)p[2], al16);
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t launch_quant_matmul(const T* x, const int8_t* w,
                                const float* scales, OutT* out, float* ws,
                                int R, int K, int N,
                                cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  if (R <= 0 || K <= 0 || N <= 0 || N % 8 != 0) return cudaErrorInvalidValue;
  long long p[7];
  qm_plan(R, K, N, f32, p);
  if (p[1] > 1 && ws == nullptr) return cudaErrorInvalidValue;
  if constexpr (f32) {
    const dim3 grid((unsigned)p[3], (unsigned)p[4]);
    if (R == 1) {
      qmv_kernel<T, OutT, 1><<<grid, dim3(QMV_TX, QMV_TY), 0, stream>>>(
          x, w, scales, out, R, K, N);
    } else if (R <= 8) {
      qmv_kernel<T, OutT, 8><<<grid, dim3(QMV_TX, QMV_TY), 0, stream>>>(
          x, w, scales, out, R, K, N);
    } else {
      qmm_kernel<T, OutT><<<grid, QMM_THREADS, 0, stream>>>(x, w, scales,
                                                           out, R, K, N);
    }
    return cudaGetLastError();
  } else {
    // 16-byte copies of x's rows; the weight's when its rows allow
    if (K % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 8 != 0) {
      return cudaErrorMisalignedAddress;
    }
    const bool al16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    cudaError_t err;
    if (p[0] == QM_GEMV) {
      switch (qm_gemv_nb8(R)) {
        case 1:
          err = qm_launch_gemv<OutT, 1>(x, w, scales, out, ws, R, K, N, p,
                                        al16, stream);
          break;
        case 2:
          err = qm_launch_gemv<OutT, 2>(x, w, scales, out, ws, R, K, N, p,
                                        al16, stream);
          break;
        default:
          err = qm_launch_gemv<OutT, 4>(x, w, scales, out, ws, R, K, N, p,
                                        al16, stream);
      }
    } else {
      err = qm_launch_wgmma<OutT>(x, w, scales, out, ws, R, K, N, p, al16,
                                  stream);
    }
    if (err != cudaSuccess || p[1] == 1) return err;
    const long long units = (long long)R * (N / 4);
    qmm_sum_kernel<OutT><<<(unsigned)((units + 255) / 256), 256, 0, stream>>>(
        ws, scales, out, R, N, (int)p[1]);
    return cudaGetLastError();
  }
}

}  // namespace

// plan: 7 int64 (qm_plan); f32: float32 x
extern "C" void quant_matmul_plan(int R, int K, int N, int f32,
                                  long long* plan) {
  qm_plan(R, K, N, f32 != 0, plan);
}

// ws: plan[5] floats (null when plan[1] == 1)
#define QUANT_MATMUL_ENTRY(NAME, T, OutT)                                    \
  extern "C" int NAME(const void* x, const void* w, const void* scales,     \
                      void* out, void* ws, int R, int K, int N,              \
                      void* stream) {                                        \
    return static_cast<int>(launch_quant_matmul<T, OutT>(                    \
        static_cast<const T*>(x), static_cast<const int8_t*>(w),             \
        static_cast<const float*>(scales), static_cast<OutT*>(out),          \
        static_cast<float*>(ws), R, K, N,                                    \
        static_cast<cudaStream_t>(stream)));                                 \
  }

QUANT_MATMUL_ENTRY(quant_matmul_bf16, bf16, bf16)
QUANT_MATMUL_ENTRY(quant_matmul_bf16_f32, bf16, float)
QUANT_MATMUL_ENTRY(quant_matmul_f32, float, float)
