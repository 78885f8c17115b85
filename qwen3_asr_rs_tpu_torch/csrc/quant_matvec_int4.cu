// int4 lm_head matvec: out = x @ unpack(w_q4) * scales, float32 logits;
// the CUDA counterpart of the Pallas kernel
// qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py::quant_matvec_int4.
//
// x (R, K) T, any R >= 1; w_q4 (K, N_pad / 2) int8 in the tile-local
// packing of ops/quant.py::quantize_weight_int4_tiled: with tile = 8192,
// packed column t * 4096 + j holds column t * 8192 + j in its low nibble
// and column t * 8192 + 4096 + j in its high nibble; scales (N,) float32,
// N <= N_pad; out (R, N) float32. The padded columns N .. N_pad - 1 are
// never written. Products are formed in float32 from x's values and the
// sign-extended nibbles (exact for bf16 x), accumulate in float32, and
// the scale multiplies the whole sum, as in the Pallas kernel.
//
// What bounds it on the H100: the packed weight bytes, 80 MB at 0.6B
// (24 us at the data-sheet 3.35 TB/s). Each thread reads 8 packed bytes
// (16 weights: 8 columns of the tile's low half and the 8 matching
// columns of its high half) per K row, coalesced along the packed
// columns, 256 packed columns per block; the K partials of the block's 8
// thread rows are added in shared memory, in row order. Rows beyond the
// first NR run as further blocks along z, each reading the weight again
// (more than one row is not the decode path).
#include "common.cuh"

constexpr int Q4_TX = 32;   // threads across packed columns, 8 each
constexpr int Q4_TY = 8;    // threads across K
constexpr int Q4_CPT = 8;
constexpr int Q4_TN = Q4_TX * Q4_CPT;  // 256 packed columns per block
constexpr int Q4_HALF = 4096;          // tile / 2 of MATVEC_TILE = 8192

template <typename T, int NR>
__global__ void __launch_bounds__(Q4_TX * Q4_TY)
qmv4_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scales, float* __restrict__ out, int R,
            int K, int NP, int N) {
  __shared__ float red[Q4_TY][2 * Q4_TN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * Q4_TX + tx;
  const int r0 = blockIdx.z * NR;
  const int nrows = min(NR, R - r0);
  const int c0 = blockIdx.x * Q4_TN;  // first packed column of the block
  const int p0 = c0 + tx * Q4_CPT;
  float lo[NR][Q4_CPT], hi[NR][Q4_CPT];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < Q4_CPT; ++c) lo[r][c] = hi[r][c] = 0.f;
  if (p0 < NP) {
#pragma unroll 4
    for (int k = ty; k < K; k += Q4_TY) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(w + (size_t)k * NP + p0));
      const int8_t* b = reinterpret_cast<const int8_t*>(&u);
      float wl[Q4_CPT], wh[Q4_CPT];
#pragma unroll
      for (int c = 0; c < Q4_CPT; ++c) {
        const int v = b[c];
        wl[c] = (float)(((v & 0xF) ^ 8) - 8);  // low nibble, sign-extended
        wh[c] = (float)(v >> 4);               // high nibble
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < nrows) {
          const float xv = to_f(x[(size_t)(r0 + r) * K + k]);
#pragma unroll
          for (int c = 0; c < Q4_CPT; ++c) {
            lo[r][c] = fmaf(xv, wl[c], lo[r][c]);
            hi[r][c] = fmaf(xv, wh[c], hi[r][c]);
          }
        }
      }
    }
  }
  // entry i of a red row: packed column c0 + i % 256, low nibble's
  // column (i < 256) or high nibble's; Q4_TN divides Q4_HALF, so the
  // block lies in one tile
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= nrows) break;
#pragma unroll
    for (int c = 0; c < Q4_CPT; ++c) {
      red[ty][tx * Q4_CPT + c] = lo[r][c];
      red[ty][Q4_TN + tx * Q4_CPT + c] = hi[r][c];
    }
    __syncthreads();
    for (int i = tid; i < 2 * Q4_TN; i += Q4_TX * Q4_TY) {
      const int pci = c0 + i % Q4_TN;
      const int ni = (pci / Q4_HALF) * 2 * Q4_HALF + (i >= Q4_TN ? Q4_HALF : 0) +
                     pci % Q4_HALF;
      if (pci < NP && ni < N) {
        float s = 0.f;
#pragma unroll
        for (int y = 0; y < Q4_TY; ++y) s += red[y][i];
        out[(size_t)(r0 + r) * N + ni] = s * scales[ni];
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_quant_matvec_int4(const T* x, const int8_t* w,
                                     const float* scales, float* out, int R,
                                     int K, int NP, int N,
                                     cudaStream_t stream) {
  if (R <= 0 || (R + 3) / 4 > 65535 || K <= 0 || NP % Q4_HALF != 0 ||
      N > 2 * NP) {
    return cudaErrorInvalidValue;
  }
  const int nb = NP / Q4_TN;
  if (R == 1) {
    qmv4_kernel<T, 1><<<dim3(nb, 1, 1), dim3(Q4_TX, Q4_TY), 0, stream>>>(
        x, w, scales, out, R, K, NP, N);
  } else {
    qmv4_kernel<T, 4><<<dim3(nb, 1, (R + 3) / 4), dim3(Q4_TX, Q4_TY), 0,
                        stream>>>(x, w, scales, out, R, K, NP, N);
  }
  return cudaGetLastError();
}

#define QUANT_MATVEC_INT4_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const void* x, const void* w, const void* scales,     \
                      void* out, int R, int K, int NP, int N, void* stream) {\
    return static_cast<int>(launch_quant_matvec_int4<T>(                     \
        static_cast<const T*>(x), static_cast<const int8_t*>(w),             \
        static_cast<const float*>(scales), static_cast<float*>(out), R, K,   \
        NP, N, static_cast<cudaStream_t>(stream)));                          \
  }

QUANT_MATVEC_INT4_ENTRY(quant_matvec_int4_bf16, bf16)
QUANT_MATVEC_INT4_ENTRY(quant_matvec_int4_f32, float)
