// Weight-only int8 matmul: out = (x @ w_q) * scales, the CUDA counterpart
// of the Pallas kernel
// qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py::quant_matmul.
//
// x (R, K) T; w_q (K, N) int8, row-major; scales (N,) float32;
// out (R, N) OutT. Products are formed in float32 from x's values and the
// int8 weights (an int8 is exact in bf16 and in float32, and a bf16 x int8
// product is exact in float32), accumulate in float32, and the
// per-column scale multiplies the whole sum before the one rounding to
// OutT. Instances:
//   quant_matmul_bf16       x bf16, out bf16: the Pallas kernel's
//                           contract (it casts x to bf16 and rounds the
//                           scaled sum to the output dtype); the int8
//                           linears of a bf16 decoder.
//   quant_matmul_bf16_f32   x bf16, out float32: the int8 lm_head, whose
//                           logits stay float32.
//   quant_matmul_f32        x float32, out float32: the contract of the
//                           JAX decoder's int8 _linear and lm_head in a
//                           float32 model, which keeps x in float32 (the
//                           Pallas kernel would round x to bf16).
//
// What bounds it on the H100: for R <= 8 (the lm_head at one token:
// 156 MB of int8 per call, 46 us at the data-sheet 3.35 TB/s) the weight
// bytes; the GEMV reads 8 weight bytes per thread per row, coalesced
// along N, 256 columns per block, no split K. For prefill rows (R = 96
// to 4736) arithmetic: a 128 x 128 output tile per block, 16-row K
// slices staged in shared memory as float32, an 8 x 8 register tile per
// thread on the CUDA cores. The tensor cores (mma/wgmma over bf16
// operands, exact for int8 weights) are later work.
#include "common.cuh"

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

template <typename T, typename OutT>
cudaError_t launch_quant_matmul(const T* x, const int8_t* w,
                                const float* scales, OutT* out, int R, int K,
                                int N, cudaStream_t stream) {
  if (R <= 0 || K <= 0 || N <= 0 || N % 8 != 0) return cudaErrorInvalidValue;
  if (R == 1) {
    qmv_kernel<T, OutT, 1><<<dim3((N + QMV_TN - 1) / QMV_TN, 1, 1),
                             dim3(QMV_TX, QMV_TY), 0, stream>>>(
        x, w, scales, out, R, K, N);
  } else if (R <= 8) {
    qmv_kernel<T, OutT, 8><<<dim3((N + QMV_TN - 1) / QMV_TN, 1, 1),
                             dim3(QMV_TX, QMV_TY), 0, stream>>>(
        x, w, scales, out, R, K, N);
  } else {
    qmm_kernel<T, OutT><<<dim3((N + QMM_BN - 1) / QMM_BN,
                               (R + QMM_BM - 1) / QMM_BM),
                          QMM_THREADS, 0, stream>>>(x, w, scales, out, R, K, N);
  }
  return cudaGetLastError();
}

#define QUANT_MATMUL_ENTRY(NAME, T, OutT)                                    \
  extern "C" int NAME(const void* x, const void* w, const void* scales,     \
                      void* out, int R, int K, int N, void* stream) {        \
    return static_cast<int>(launch_quant_matmul<T, OutT>(                    \
        static_cast<const T*>(x), static_cast<const int8_t*>(w),             \
        static_cast<const float*>(scales), static_cast<OutT*>(out), R, K, N, \
        static_cast<cudaStream_t>(stream)));                                 \
  }

QUANT_MATMUL_ENTRY(quant_matmul_bf16, bf16, bf16)
QUANT_MATMUL_ENTRY(quant_matmul_bf16_f32, bf16, float)
QUANT_MATMUL_ENTRY(quant_matmul_f32, float, float)
