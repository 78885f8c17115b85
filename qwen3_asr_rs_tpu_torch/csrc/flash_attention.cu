// Online-softmax ("flash") attention for prefill: the CUDA counterpart of
// the Pallas kernel qwen3_asr_rs_tpu/ops/pallas/flash_attention.py::
// flash_attention. Causal, kv_valid (keys >= kv_valid[b] masked) and
// kv_start (keys < kv_start[b] masked) masks, GQA query head h reading kv
// head h / G, and the (Sq, Sk) score matrix never leaves the block.
//
// Numerics follow the Pallas kernel: QK^T products of T values accumulate
// in float32, masked scores become -1e9 (rows stay NaN-free), the running
// max starts at -1e30, probabilities round to T before the PV product,
// and the output divides by max(l, 1e-30) once at the end.
//
// Design: one block of 256 threads per (64-query tile, query head,
// example), looping over 64-key tiles; Q, K, V and P tiles sit in shared
// memory as float32 (115 KB at D = 128, dynamic shared memory). Each
// thread owns a 4x4 micro-tile of the scores and a 4 x D/16 slice of the
// output accumulator; the row max and sum reduce over the 16 lanes that
// share a row with warp shuffles. Key tiles wholly above the diagonal,
// wholly at or past kv_valid, or wholly before kv_start are skipped.
//
// What bounds it on the H100: arithmetic. A causal prefill at 4736
// tokens, 16 heads, D = 128 is ~92 GFLOP per layer; this version runs the
// products on the CUDA cores in float32 (67 TFLOP/s peak) out of shared
// memory, not on the tensor cores (989 TFLOP/s bf16): wgmma/mma tiles and
// TMA-fed pipelines are the later, fast version.
#include "common.cuh"

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;  // 16 x 16
constexpr float FA_MASK = -1e9f;
constexpr float FA_INIT_M = -1e30f;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (FA_BQ * (D + 1) + FA_BK * (D + 1) + FA_BK * D + FA_BQ * (FA_BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_valid,
             const int* __restrict__ kv_start, T* __restrict__ o, int Sq,
             int Sk, int Hq, int Hkv, float scale, int causal) {
  constexpr int DJ = D / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][D + 1]
  float* Ks = Qs + FA_BQ * (D + 1);   // [BK][D + 1]
  float* Vs = Ks + FA_BK * (D + 1);   // [BK][D]
  float* Ps = Vs + FA_BK * D;         // [BQ][BK + 1]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * FA_BQ;
  const int valid = kv_valid != nullptr ? min(kv_valid[b], Sk) : Sk;
  const int kbegin = kv_start != nullptr ? max(kv_start[b], 0) : 0;

  for (int idx = tid; idx < FA_BQ * D; idx += FA_THREADS) {
    const int r = idx / D, d = idx % D, qr = q0 + r;
    Qs[r * (D + 1) + d] =
        qr < Sq ? to_f(q[(((size_t)b * Sq + qr) * Hq + h) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_INIT_M;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int kt_end = (min(Sk, valid) + FA_BK - 1) / FA_BK;
  if (causal) kt_end = min(kt_end, (q0 + FA_BQ - 1) / FA_BK + 1);
  for (int kt = kbegin / FA_BK; kt < kt_end; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int idx = tid; idx < FA_BK * D; idx += FA_THREADS) {
      const int r = idx / D, d = idx % D, kr = k0 + r;
      const size_t off = (((size_t)b * Sk + kr) * Hkv + kvh) * D + d;
      Ks[r * (D + 1) + d] = kr < Sk ? to_f(k[off]) : 0.f;
      Vs[r * D + d] = kr < Sk ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool bad = col >= Sk || col >= valid || col < kbegin ||
                         (causal && col > row);
        s[i][j] = bad ? FA_MASK : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (FA_BK + 1) + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (FA_BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      o[(((size_t)b * Sq + row) * Hq + h) * D + tx + 16 * j] =
          from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_flash(const T* q, const T* k, const T* v,
                         const int* kv_valid, const int* kv_start, T* o,
                         int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                         int causal, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  flash_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(
      q, k, v, kv_valid, kv_start, o, Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

// q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); o (B, Sq, Hq, D); kv_valid and
// kv_start are (B,) int32 device arrays or null.
#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* kv_valid, const void* kv_start, void* o,   \
                      int B, int Sq, int Sk, int Hq, int Hkv, int D,         \
                      float scale, int causal, void* stream) {               \
    if (Hkv <= 0 || Hq % Hkv != 0) {                                         \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    }                                                                        \
    const T* qq = static_cast<const T*>(q);                                  \
    const T* kk = static_cast<const T*>(k);                                  \
    const T* vv = static_cast<const T*>(v);                                  \
    const int* kvv = static_cast<const int*>(kv_valid);                      \
    const int* kvs = static_cast<const int*>(kv_start);                      \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    if (D == 128) {                                                          \
      return static_cast<int>(launch_flash<T, 128>(                          \
          qq, kk, vv, kvv, kvs, static_cast<T*>(o), B, Sq, Sk, Hq, Hkv,      \
          scale, causal, st));                                               \
    }                                                                        \
    if (D == 64) {                                                           \
      return static_cast<int>(launch_flash<T, 64>(                           \
          qq, kk, vv, kvv, kvs, static_cast<T*>(o), B, Sq, Sk, Hq, Hkv,      \
          scale, causal, st));                                               \
    }                                                                        \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }

FLASH_ENTRY(flash_attention_bf16, bf16)
FLASH_ENTRY(flash_attention_f32, float)
