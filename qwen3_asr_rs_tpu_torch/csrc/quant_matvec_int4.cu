// int4 lm_head matvec: out = x @ unpack(w_q4) * scales, float32 logits;
// the CUDA counterpart of the Pallas kernel
// qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py::quant_matvec_int4.
//
// x (R, K) T, any R >= 1; w_q4 (K, N_pad / 2) int8 in the tile-local
// packing of ops/quant.py::quantize_weight_int4_tiled: with tile = 8192,
// packed column t * 4096 + j holds column t * 8192 + j in its low nibble
// and column t * 8192 + 4096 + j in its high nibble; scales (N,) float32,
// N <= N_pad; out (R, N) float32. The padded columns N .. N_pad - 1 are
// never written. Products of x's values and the sign-extended nibbles are
// exact, accumulate in float32, and the scale multiplies the whole sum, as
// in the Pallas kernel.
//
// What bounds it on the H100: the packed weight bytes, 80 MB at 0.6B
// (24 us at the data-sheet 3.35 TB/s), read once per call whatever R is.
// The design (gemv_mma.cuh): blocks of 4 warps own 64 packed columns (128
// outputs); each block streams its K range through a 4-stage ring of
// 16-byte cp.async copies and runs mma.sync.m16n8k16 on nibbles converted
// to bf16 (exact) against x staged once in shared memory as bf16, up to
// 32 rows from one read of the weight. float32 x is staged as three bf16
// terms whose sum is x exactly (a subnormal x within 2^-134), so its
// products stay exact too. Above 32 rows a block keeps its whole K range
// of the weight in shared memory and runs the rows 32 at a time over it.
// The K split comes from the shapes (gm_split_rows: at 0.6B one split,
// 1216 blocks of 64 KB of weights, about 9 per SM); splits add their
// partials in split order in the last block of each column tile, so the
// result does not depend on the order of the blocks.
#include "gemv_mma.cuh"

constexpr int Q4_HALF = 4096;  // tile / 2 of MATVEC_TILE = 8192
constexpr int Q4_ROWS = 32;    // rows per pass over a block's weights
// shared memory a block whose K range stays resident may take
constexpr int Q4_RES_SMEM = 200 * 1024;

namespace {

template <typename T>
__host__ __device__ constexpr int q4_terms() {
  return sizeof(T) == 4 ? 3 : 1;  // bf16 terms per staged x value
}

// output column of packed column p's low (v = 0) or high nibble
__device__ __forceinline__ int q4_out_col(int p, int v) {
  return (p / Q4_HALF) * 2 * Q4_HALF + v * Q4_HALF + p % Q4_HALF;
}

// 8 values of x as NTERM bf16 terms: bf16 x is one term; float32 x is
// t0 + t1 + t2 exactly (each term the bf16 rounding of what is left; a
// subnormal x loses what lies below bf16's smallest subnormal)
template <typename T>
__device__ __forceinline__ void q4_terms_of(const T* p, uint4* u) {
  float v[8];
  load8(p, v);
#pragma unroll
  for (int t = 0; t < q4_terms<T>(); ++t) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      const float2 f = __bfloat1622float2(h);
      v[2 * j] -= f.x;
      v[2 * j + 1] -= f.y;
      w[j] = *reinterpret_cast<const unsigned*>(&h);
    }
    u[t] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, int NB8, bool RES>
__global__ void __launch_bounds__(GM_THREADS, 1)
qmv4_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, float* __restrict__ out,
                float* __restrict__ ws, int* __restrict__ counters, int R,
                int K, int NP, int N, int kb) {
  constexpr int NTERM = q4_terms<T>();
  constexpr int SB = gm_stage_bytes<W_INT4>();
  constexpr int ROWS = 8 * NB8;
  extern __shared__ __align__(16) unsigned char q4_buf[];
  __shared__ bool is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = gridDim.y, split = blockIdx.y, c0 = blockIdx.x * GM_TN;
  const int k_begin = split * kb, k_end = min(K, k_begin + kb);
  const int nst = (k_end - k_begin + GM_KS - 1) / GM_KS;
  const int nbuf = RES ? nst : GM_STAGES;
  const int xstride = nst * GM_KS + GM_XPAD;
  bf16* xs = reinterpret_cast<bf16*>(q4_buf + (size_t)nbuf * SB);

  auto fetch = [&](int st) {
    if (st < nst) {
      gm_load_stage<W_INT4>(q4_buf + (st % nbuf) * SB, w, NP,
                            k_begin + st * GM_KS, k_end, c0, NP, tid);
    }
    cp_async_commit();
  };
  // rows r0 .. r0 + ROWS - 1 of x over the block's K range, zero past R
  // and K: bf16 x as one cp.async group, all in flight at once; float32 x
  // as its three bf16 terms, through registers
  const int chunks = nst * GM_KS / 8;
  auto stage_x = [&](int r0, int rows) {
#pragma unroll 4
    for (int i = tid; i < ROWS * chunks; i += GM_THREADS) {
      const int r = i / chunks, c = 8 * (i % chunks), k = k_begin + c;
      const bool ok = r < rows && k < k_end;
      if constexpr (NTERM == 1) {
        cp_async16(xs + (size_t)r * xstride + c,
                   ok ? x + (size_t)(r0 + r) * K + k : x, ok);
      } else {
        uint4 u[NTERM];
#pragma unroll
        for (int t = 0; t < NTERM; ++t) u[t] = make_uint4(0, 0, 0, 0);
        if (ok) q4_terms_of(x + (size_t)(r0 + r) * K + k, u);
#pragma unroll
        for (int t = 0; t < NTERM; ++t) {
          *reinterpret_cast<uint4*>(xs + ((size_t)t * ROWS + r) * xstride +
                                    c) = u[t];
        }
      }
    }
    cp_async_commit();
  };
  stage_x(0, min(ROWS, R));
  // resident: every stage in flight at once; else the ring's first ones
  for (int s = 0; s < (RES ? nst : GM_STAGES - 1); ++s) fetch(s);

  const int groups = RES ? (R + ROWS - 1) / ROWS : 1;
  for (int rg = 0; rg < groups; ++rg) {
    const int r0 = rg * ROWS, rows = min(ROWS, R - r0);
    if (rg > 0) {  // every weight stage has landed (rg == 0 waited for them)
      __syncthreads();  // the last group's reads of x are done
      stage_x(r0, rows);
      cp_async_wait<0>();
    }
    float acc[2][NB8][4];
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[v][nb][c] = 0.f;
    for (int st = 0; st < nst; ++st) {
      if constexpr (RES) {
        if (rg == 0) gm_wait_groups(nst - 1 - st);
        __syncthreads();
      } else {
        cp_async_wait<GM_STAGES - 2>();
        __syncthreads();
        fetch(st + GM_STAGES - 1);
      }
      const unsigned char* p = q4_buf + (st % nbuf) * SB;
#pragma unroll
      for (int kk = 0; kk < GM_KS / 16; ++kk) {
        unsigned lo[4], hi[4];
        gm_frag_int4(p, kk, warp, lane, lo, hi);
#pragma unroll
        for (int t = 0; t < NTERM; ++t)
#pragma unroll
          for (int nb = 0; nb < NB8; ++nb) {
            unsigned b[2];
            gm_frag_x(xs + (size_t)t * ROWS * xstride, xstride,
                      st * GM_KS + 16 * kk, nb, lane, b);
            gm_mma(acc[0][nb], lo, b);
            gm_mma(acc[1][nb], hi, b);
          }
      }
    }
    // one split: the scaled sums are the output; else the split's partials
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = 8 * nb + gm_acc_row(lane, c);
          const int pc = c0 + gm_col<W_INT4>(warp, lane, c >> 1);
          if (r >= rows || pc >= NP) continue;
          if (nk == 1) {
            const int n = q4_out_col(pc, v);
            if (n < N) out[(size_t)(r0 + r) * N + n] = acc[v][nb][c] * scales[n];
          } else {
            ws[(((size_t)(r0 + r) * 2 + v) * nk + split) * NP + pc] =
                acc[v][nb][c];
          }
        }
  }
  cp_async_wait<0>();
  if (nk == 1) return;
  // the last block of the column tile adds the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[blockIdx.x], 1) == nk - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < R * 2 * GM_TN; i += GM_THREADS) {
    const int r = i / (2 * GM_TN), v = (i / GM_TN) & 1, pc = c0 + i % GM_TN;
    const int n = q4_out_col(pc, v);
    if (pc >= NP || n >= N) continue;
    const float* p = ws + ((size_t)r * 2 + v) * nk * NP + pc;
    float s = 0.f;
    for (int ks = 0; ks < nk; ++ks) s += __ldcg(p + (size_t)ks * NP);
    out[(size_t)r * N + n] = s * scales[n];
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

// The launch plan of R rows: {rows of K per block, splits, workspace
// floats, staged rows per pass (8 * NB8), resident (0/1), shared bytes}.
template <typename T>
void q4_plan(int R, int K, int NP, long long* plan) {
  constexpr int NTERM = q4_terms<T>();
  const int tiles = NP / GM_TN;
  const bool res = R > Q4_ROWS;
  const int nb8 = res ? Q4_ROWS / 8 : (R + 7) / 8;
  int kb;
  if (res) {  // the K range's weights and 32 staged rows in shared memory
    kb = (Q4_RES_SMEM - 16 * NTERM * Q4_ROWS) /
         (gm_stage_bytes<W_INT4>() / GM_KS + 2 * NTERM * Q4_ROWS);
    kb = kb / GM_KS * GM_KS;
    const int kr = (K + GM_KS - 1) / GM_KS * GM_KS;
    if (kb > kr) kb = kr;
  } else {
    kb = gm_split_rows(K, tiles, R, 2, 1, GM_KS, nb8 * NTERM);
  }
  const int nk = (K + kb - 1) / kb;
  const int nbuf = res ? kb / GM_KS : GM_STAGES;
  plan[0] = kb;
  plan[1] = nk;
  plan[2] = nk > 1 ? (long long)R * 2 * nk * NP : 0;
  plan[3] = 8 * nb8;
  plan[4] = res;
  plan[5] = (long long)nbuf * gm_stage_bytes<W_INT4>() +
            (long long)NTERM * 8 * nb8 * (kb + GM_XPAD) * 2;
}

template <typename T, int NB8, bool RES>
cudaError_t q4_launch(const T* x, const int8_t* w, const float* scales,
                      float* out, float* ws, int* counters, int R, int K,
                      int NP, int N, const long long* plan,
                      cudaStream_t stream) {
  static int ready = 0;
  cudaError_t err = allow_smem(qmv4_mma_kernel<T, NB8, RES>, Q4_RES_SMEM,
                               &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(NP / GM_TN, (unsigned)plan[1]);
  qmv4_mma_kernel<T, NB8, RES><<<grid, GM_THREADS, (size_t)plan[5], stream>>>(
      x, w, scales, out, ws, counters, R, K, NP, N, (int)plan[0]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quant_matvec_int4(const T* x, const int8_t* w,
                                     const float* scales, float* out,
                                     float* ws, int* counters, int R, int K,
                                     int NP, int N, cudaStream_t stream) {
  if (R <= 0 || K <= 0 || K % 8 != 0 || NP % Q4_HALF != 0 || N > 2 * NP) {
    return cudaErrorInvalidValue;
  }
  long long plan[6];
  q4_plan<T>(R, K, NP, plan);
  if (plan[1] > 1 && (ws == nullptr || counters == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (plan[4]) {
    return q4_launch<T, 4, true>(x, w, scales, out, ws, counters, R, K, NP, N,
                                 plan, stream);
  }
  switch (plan[3]) {
    case 8:
      return q4_launch<T, 1, false>(x, w, scales, out, ws, counters, R, K, NP,
                                    N, plan, stream);
    case 16:
      return q4_launch<T, 2, false>(x, w, scales, out, ws, counters, R, K, NP,
                                    N, plan, stream);
    case 24:
      return q4_launch<T, 3, false>(x, w, scales, out, ws, counters, R, K, NP,
                                    N, plan, stream);
    default:
      return q4_launch<T, 4, false>(x, w, scales, out, ws, counters, R, K, NP,
                                    N, plan, stream);
  }
}

}  // namespace

// plan: 6 int64 (q4_plan); f32: float32 x
extern "C" void quant_matvec_int4_plan(int R, int K, int NP, int f32,
                                       long long* plan) {
  if (f32) {
    q4_plan<float>(R, K, NP, plan);
  } else {
    q4_plan<bf16>(R, K, NP, plan);
  }
}

// ws: plan[2] floats (null when plan[1] == 1); counters: NP / 64 ints,
// zero on entry, left zero.
#define QUANT_MATVEC_INT4_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const void* x, const void* w, const void* scales,     \
                      void* out, void* ws, void* counters, int R, int K,     \
                      int NP, int N, void* stream) {                         \
    return static_cast<int>(launch_quant_matvec_int4<T>(                     \
        static_cast<const T*>(x), static_cast<const int8_t*>(w),             \
        static_cast<const float*>(scales), static_cast<float*>(out),         \
        static_cast<float*>(ws), static_cast<int*>(counters), R, K, NP, N,   \
        static_cast<cudaStream_t>(stream)));                                 \
  }

QUANT_MATVEC_INT4_ENTRY(quant_matvec_int4_bf16, bf16)
QUANT_MATVEC_INT4_ENTRY(quant_matvec_int4_f32, float)
