// One greedy decode step through all decoder layers for B rows (examples):
// the CUDA counterpart of the Pallas decode megakernel
// qwen3_asr_rs_tpu/ops/pallas/decode_layer.py::decode_layers_fused
// (its ffn_tiles=1 branches, with bf16/f32 activations, bf16/f32, int8,
// int4 or group-wise int4 (int4g) weights, merged or per projection,
// slabs of T or int8 with per-slot scales, and the folded lm_head).
//
// Per layer: RMSNorm -> q/k/v -> per-head QK-RMSNorm -> rotary -> GQA
// attention over each row's live slab range plus the fresh self K/V ->
// o-proj + residual -> RMSNorm -> SwiGLU -> down + residual. The step
// returns the hidden states and every layer's fresh K/V in T; the caller
// writes (and for an int8 slab quantizes) them into the slab.
// Rounding to T happens at the stages where the JAX path rounds to its
// compute dtype (text_decoder._decode_layer_masked, decode_layer._mm);
// norms, softmax and every accumulation run in float32, and a quantized
// product's per-column scale multiplies the whole float32 sum before it
// rounds to T. An int4g product's scales vary along K, so each group's
// float32 partial is scaled before the groups are summed: a GEMV block
// reduces a 128-row K slice, so at group sizes that are multiples of 128
// the block's slice lies in one group and its published split-K partial
// is scaled (one scale per block and column); at 32 and 64 each thread's
// 32-row stripes lie in one group each, and the thread scales the
// unpacked weights of a stripe before its FMAs, from the block's scales
// staged in shared memory.
//
// The folded lm_head (fold != FOLD_NONE) runs after the last layer: the
// final RMSNorm as the GEMVs' prologue, float32 logits against a (V, H)
// lm_head in T (one warp per vocab row, lanes along H) or an int8 (H, V)
// one with per-column scales (lanes along V, warps splitting H), and the
// argmax: each block's best (value, index) per row goes into one 64-bit
// atomicMax on (order-preserving float bits, ~index), so the result does
// not depend on the order of the blocks and a tie gives the lowest index,
// as jnp.argmax does. Up to FOLD_ROWS rows per launch: each launch
// streams the lm_head once (311 MB bf16, 156 MB int8 at 0.6B).
//
// What bounds it on the H100: the weight stream. At 0.6B a layer holds
// 15.7 M parameters, 28 layers 0.88 GB per step in bf16 (0.26 ms at the
// data-sheet 3.35 TB/s), 0.44 GB in int8, 0.22 GB in int4, whatever B
// is: each GEMV block loads its weight tile (128 rows x 64 columns) into
// registers once and applies it to every row of the batch, RB rows at a
// time (RB * accumulators <= 8, so B = 32 does not spill), so B rows
// share one weight stream. This first version is a chain of simple
// kernels, launched by one C entry that loops over the layers on the host
// side: 8 launches per layer unmerged, 6 merged, each latency-bound
// (small grids, dependent phases), so latency, not bytes, sets its time
// at small B. The GEMVs read 8 consecutive weights per thread and row (16
// bytes of bf16, 8 of int8, 8 bytes = 16 int4 weights), coalesced along
// `out`, and split K over 128-row chunks, with a deterministic last-block
// reduction instead of float atomics. The RMSNorm before a projection is
// recomputed by each GEMV block (one warp per row; a row is 2 KB), which
// saves a launch. Persistence, CUDA graphs and tensor cores are later work.
#include "decode_attention.cuh"

constexpr int GEMV_CPT = 8;                    // columns per thread
constexpr int GEMV_TX = 8;                     // threads across columns
constexpr int GEMV_TN = GEMV_CPT * GEMV_TX;    // 64 columns per block
constexpr int GEMV_TY = 32;                    // threads across rows of W
constexpr int GEMV_KC = 128;                   // rows of W per block
constexpr int GEMV_KPT = GEMV_KC / GEMV_TY;    // rows of W per thread
constexpr int GEMV_THREADS = GEMV_TX * GEMV_TY;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_MAX_ROWS = 32;              // batch rows per launch
constexpr int GEMV_MAX_ACC = 8;                // RB x accumulators

enum Epilogue { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

// How a weight is stored: T; int8 with per-column float32 scales; or
// int4, two per byte, where the byte at packed column j of a (K, N/2) row
// holds column j (low nibble) and column j + N/2 (high nibble), with
// per-column scales over the N unpacked columns (W_INT4) or (G, N) scales
// per group of K / G rows and column (W_INT4G).
enum WeightKind { W_FLOAT = 0, W_INT8 = 1, W_INT4 = 2, W_INT4G = 3 };

__host__ __device__ constexpr bool is_int4(int wk) {
  return wk == W_INT4 || wk == W_INT4G;
}

template <typename T>
struct GemvArgs {
  const T* x;        // (rows, K) input rows
  const T* norm_w;   // (K,) RMSNorm weight applied to each row first, or null
  float eps;
  // weights (K rows of stride ld elements; bytes for int8/int4) and their
  // per-output-column scales (null for T weights; W_INT4G: the (G, 2 NL)
  // group scales, G = K / gsize). The grid walks NL loaded columns; an
  // int4 byte column j gives outputs j and j + NL.
  const void* w0;
  const void* w1;    // EPI_SWIGLU with two sources: the "up" weight
  const float* s0;
  const float* s1;   // EPI_SWIGLU: the "up" scales
  int gsize;         // W_INT4G: rows per scale group
  const T* res;      // (rows, N) residual (EPI_RESIDUAL); may alias out
  // EPI_STORE writes output columns [0, split1) of each row to out (row
  // stride split1), [split1, split2) to out1 and [split2, N) to out2;
  // the other epilogues write (rows, N) to out
  T* out;
  T* out1;
  T* out2;
  int split1, split2;
  float* ws;         // (rows, accumulators, ceil(K / GEMV_KC), NL) partials
  int* counters;     // (ceil(NL / GEMV_TN),) zero on entry, zero on exit
  int rows, K, NL, ld;
};

// GEMV_CPT consecutive weights of one row of W, as loaded: 32-bit words
// (bf16: 4, float: 8, int8 and int4: 2).
template <typename T, int WK>
struct WeightVec {
  static constexpr int WORDS =
      WK == W_FLOAT ? (int)(GEMV_CPT * sizeof(T) / 4) : 2;
  uint32_t w[WORDS];
};

template <typename T, int WK>
__device__ __forceinline__ void load_wvec(const void* base, size_t off,
                                          WeightVec<T, WK>& v) {
  if constexpr (WK == W_FLOAT) {
    const uint4* p =
        reinterpret_cast<const uint4*>(static_cast<const T*>(base) + off);
#pragma unroll
    for (int i = 0; i < WeightVec<T, WK>::WORDS / 4; ++i) {
      const uint4 u = __ldg(p + i);
      v.w[4 * i] = u.x;
      v.w[4 * i + 1] = u.y;
      v.w[4 * i + 2] = u.z;
      v.w[4 * i + 3] = u.w;
    }
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(base) + off));
    v.w[0] = u.x;
    v.w[1] = u.y;
  }
}

// The loaded weights as float: lo gets the values (int4: the low
// nibbles), hi the int4 high nibbles.
template <typename T, int WK>
__device__ __forceinline__ void unpack_wvec(const WeightVec<T, WK>& v,
                                            float* lo, float* hi) {
  if constexpr (WK == W_FLOAT) {
    if constexpr (sizeof(T) == 2) {  // bf16: element 2i is word i's low half
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[2 * i] = __uint_as_float(v.w[i] << 16);
        lo[2 * i + 1] = __uint_as_float(v.w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < GEMV_CPT; ++i) lo[i] = __uint_as_float(v.w[i]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < GEMV_CPT; ++c) {
      // byte c, sign-extended
      const int b = (int)(v.w[c >> 2] << (24 - 8 * (c & 3))) >> 24;
      if constexpr (WK == W_INT8) {
        lo[c] = (float)b;
      } else {
        lo[c] = (float)(((b & 0xF) ^ 8) - 8);  // low nibble, sign-extended
        hi[c] = (float)(b >> 4);               // high nibble
      }
    }
  }
}

__device__ __forceinline__ float scaled(float v, const float* s, int n) {
  return s != nullptr ? v * s[n] : v;
}

// y = x @ W for every row of x over NSRC weights of kind WK, then a
// per-epilogue rounding (the scale multiplies the whole contraction, after
// the split-K partials are summed, and only then rounds to T):
//   STORE:    out = T(y s)
//   RESIDUAL: out = T(res + T(y s))
//   SWIGLU:   out = T(T(silu(T(gate s0))) * T(up s1)), where gate and up
//             come from two weights (w0, w1) or, for a merged int4
//             gate|up, from the low and high nibbles of one byte
// Each thread holds its GEMV_KPT x 8 weights in registers and applies
// them to RB rows at a time.
template <typename T, int EPI, int WK, int NSRC, int RB>
__global__ void __launch_bounds__(GEMV_THREADS) gemv_kernel(GemvArgs<T> a) {
  constexpr int NV = is_int4(WK) ? 2 : 1;  // values per loaded column
  constexpr int NACC = NSRC * NV;
  constexpr bool kGroups = WK == W_INT4G;
  static_assert(RB * NACC <= GEMV_MAX_ACC, "accumulators per thread");
  static_assert(GEMV_MAX_ROWS % RB == 0, "row groups tile the rows");
  static_assert(!kGroups || NSRC == 1, "int4g: one packed source");
  constexpr int XROWS = RB == 1 ? 1 : GEMV_MAX_ROWS;
  __shared__ float xs[XROWS][GEMV_KC];
  __shared__ float red[RB * NACC][GEMV_WARPS][GEMV_TN];
  __shared__ float rnorm[XROWS];
  // W_INT4G below 128 rows per group: stripe j's scales, low and high
  // nibbles, of the block's columns
  __shared__ __align__(16) float gsc[kGroups ? GEMV_KPT : 1][2][GEMV_TN];
  __shared__ bool is_last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * GEMV_TX + tx;
  const int lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.y * GEMV_KC;
  const int kend = min(k0 + GEMV_KC, a.K);
  const int nb = blockIdx.x * GEMV_TN;
  const int n0 = nb + tx * GEMV_CPT;
  const int nk = gridDim.y;

  // this thread's weights, loaded once: rows k0 + ty + GEMV_TY * j
  WeightVec<T, WK> wv[GEMV_KPT][NSRC];
#pragma unroll
  for (int j = 0; j < GEMV_KPT; ++j) {
    const int k = k0 + ty + GEMV_TY * j;
#pragma unroll
    for (int src = 0; src < NSRC; ++src) {
      if (k < kend && n0 < a.NL) {
        load_wvec<T, WK>(src == 0 ? a.w0 : a.w1, (size_t)k * a.ld + n0,
                         wv[j][src]);
      } else {
#pragma unroll
        for (int i = 0; i < WeightVec<T, WK>::WORDS; ++i) wv[j][src].w[i] = 0;
      }
    }
  }

  // RMSNorm factor of each row (one warp per row), then the block's
  // K-slice of every row, zero past the last row of the last group
  if (a.norm_w != nullptr) {
    for (int r = warp; r < a.rows; r += GEMV_WARPS) {
      const T* xr = a.x + (size_t)r * a.K;
      float ss = 0.f;
      for (int k = lane * 8; k < a.K; k += 32 * 8) {
        float v[8];
        load8(xr + k, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) ss = fmaf(v[i], v[i], ss);
      }
      ss = warp_sum(ss);
      if (lane == 0) rnorm[r] = 1.f / sqrtf(ss / a.K + a.eps);
    }
    __syncthreads();
  }
  const int ngroups = (a.rows + RB - 1) / RB;
  for (int idx = tid; idx < ngroups * RB * GEMV_KC; idx += GEMV_THREADS) {
    const int r = idx / GEMV_KC, kk = idx % GEMV_KC, k = k0 + kk;
    float v = 0.f;
    if (r < a.rows && k < kend) {
      v = to_f(a.x[(size_t)r * a.K + k]);
      if (a.norm_w != nullptr) v = round_to<T>(v * rnorm[r] * to_f(a.norm_w[k]));
    }
    xs[r][kk] = v;
  }
  const bool stripe_scales = kGroups && a.gsize < GEMV_KC;
  if constexpr (kGroups) {
    const int n_staged = stripe_scales ? GEMV_KPT * 2 * GEMV_TN : 0;
    for (int idx = tid; idx < n_staged; idx += GEMV_THREADS) {
      const int j = idx / (2 * GEMV_TN), v = (idx / GEMV_TN) % 2;
      const int col = idx % GEMV_TN, k = k0 + GEMV_TY * j;
      gsc[j][v][col] = k < a.K && nb + col < a.NL
          ? a.s0[(size_t)(k / a.gsize) * 2 * a.NL + nb + col + v * a.NL]
          : 0.f;
    }
  }
  __syncthreads();

  for (int g = 0; g < ngroups; ++g) {
    float acc[RB][NACC][GEMV_CPT];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < NACC; ++j)
#pragma unroll
        for (int c = 0; c < GEMV_CPT; ++c) acc[r][j][c] = 0.f;
#pragma unroll
    for (int j = 0; j < GEMV_KPT; ++j) {
      const int kk = ty + GEMV_TY * j;
#pragma unroll
      for (int src = 0; src < NSRC; ++src) {
        float lo[GEMV_CPT], hi[GEMV_CPT];
        unpack_wvec<T, WK>(wv[j][src], lo, hi);
        if constexpr (kGroups) {
          if (stripe_scales) {  // this stripe's group scales
#pragma unroll
            for (int c = 0; c < GEMV_CPT; ++c) {
              lo[c] *= gsc[j][0][tx * GEMV_CPT + c];
              hi[c] *= gsc[j][1][tx * GEMV_CPT + c];
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xv = xs[g * RB + r][kk];
#pragma unroll
          for (int c = 0; c < GEMV_CPT; ++c) {
            acc[r][src * NV][c] = fmaf(xv, lo[c], acc[r][src * NV][c]);
            if constexpr (NV == 2) {
              acc[r][src * NV + 1][c] = fmaf(xv, hi[c], acc[r][src * NV + 1][c]);
            }
          }
        }
      }
    }
    // sums over the block's 32 rows of W: the warp's 4 by shuffles, then
    // the 8 warps in order through shared memory
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < NACC; ++j)
#pragma unroll
        for (int c = 0; c < GEMV_CPT; ++c) {
          float v = acc[r][j][c];
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < GEMV_TX) red[r * NACC + j][warp][tx * GEMV_CPT + c] = v;
        }
    __syncthreads();
    // publish this block's partials to the split-K workspace
    for (int idx = tid; idx < RB * NACC * GEMV_TN; idx += GEMV_THREADS) {
      const int rj = idx / GEMV_TN, col = idx % GEMV_TN;
      const int r = g * RB + rj / NACC, which = rj % NACC, n = nb + col;
      float s = 0.f;
      for (int w = 0; w < GEMV_WARPS; ++w) s += red[rj][w][col];
      if constexpr (kGroups) {
        if (!stripe_scales && n < a.NL) {
          // the block's K slice lies in one group: its scale, on the partial
          s *= a.s0[(size_t)(k0 / a.gsize) * 2 * a.NL + n + which * a.NL];
        }
      }
      if (r < a.rows && n < a.NL) {
        a.ws[(((size_t)r * NACC + which) * nk + blockIdx.y) * a.NL + n] = s;
      }
    }
    __syncthreads();  // red is reused by the next group
  }

  // the last block of the column tile to arrive adds all partials in
  // split order and runs the epilogue for every row
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&a.counters[blockIdx.x], 1) == nk - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the epilogue's per-column scales (int4g partials are scaled already)
  const float* es0 = kGroups ? nullptr : a.s0;
  const float* es1 = kGroups ? nullptr : a.s1;
  for (int idx = tid; idx < a.rows * GEMV_TN; idx += GEMV_THREADS) {
    const int r = idx / GEMV_TN, nl = nb + idx % GEMV_TN;  // loaded column
    if (nl >= a.NL) continue;
    float tot[NACC];
#pragma unroll
    for (int which = 0; which < NACC; ++which) {
      const float* p = a.ws + ((size_t)r * NACC + which) * nk * a.NL + nl;
      float s = 0.f;
      for (int ks = 0; ks < nk; ++ks) s += __ldcg(p + (size_t)ks * a.NL);
      tot[which] = s;
    }
    if constexpr (EPI == EPI_SWIGLU) {
      // pairs (gate, up) of accumulators, each pair one output column
      constexpr int NPAIR = NSRC == 1 ? 1 : NV;
      const size_t N = (size_t)a.NL * NPAIR;
#pragma unroll
      for (int v = 0; v < NPAIR; ++v) {
        const int gi = NSRC == 1 ? 0 : v, ui = NSRC == 1 ? 1 : NV + v;
        const int on = nl + v * a.NL;
        const float gate = round_to<T>(scaled(tot[gi], es0, on));
        const float up = round_to<T>(scaled(tot[ui], es1, on));
        const float act = round_to<T>(gate * (1.f / (1.f + expf(-gate))));
        a.out[r * N + on] = from_f<T>(act * up);
      }
    } else {
      const size_t N = (size_t)a.NL * NV;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int on = nl + v * a.NL;
        const float y = round_to<T>(scaled(tot[v], es0, on));
        if constexpr (EPI == EPI_STORE) {
          if (on < a.split1) {
            a.out[r * a.split1 + on] = from_f<T>(y);
          } else if (on < a.split2) {
            a.out1[r * (a.split2 - a.split1) + on - a.split1] = from_f<T>(y);
          } else {
            a.out2[r * (N - a.split2) + on - a.split2] = from_f<T>(y);
          }
        } else {
          a.out[r * N + on] = from_f<T>(to_f(a.res[r * N + on]) + y);
        }
      }
    }
  }
  if (tid == 0) a.counters[blockIdx.x] = 0;
}

template <typename T, int EPI, int WK, int NSRC, int RB>
cudaError_t launch_gemv_rb(const GemvArgs<T>& a, cudaStream_t stream) {
  const dim3 grid((a.NL + GEMV_TN - 1) / GEMV_TN, (a.K + GEMV_KC - 1) / GEMV_KC);
  gemv_kernel<T, EPI, WK, NSRC, RB><<<grid, dim3(GEMV_TX, GEMV_TY), 0, stream>>>(a);
  return cudaGetLastError();
}

// One launch per GEMV_MAX_ROWS rows, each with the largest row group its
// rows and accumulators allow.
template <typename T, int EPI, int WK, int NSRC>
cudaError_t launch_gemv(const GemvArgs<T>& a, int rows, cudaStream_t stream) {
  constexpr int NV = is_int4(WK) ? 2 : 1;
  constexpr int RB_MAX = GEMV_MAX_ACC / (NSRC * NV);
  constexpr int RB4 = RB_MAX < 4 ? RB_MAX : 4;
  constexpr int NOUT = EPI == EPI_SWIGLU ? (NSRC == 1 ? 1 : NV) : NV;
  const size_t n = (size_t)a.NL * NOUT;  // output columns per row
  for (int r0 = 0; r0 < rows; r0 += GEMV_MAX_ROWS) {
    GemvArgs<T> g = a;
    g.rows = min(GEMV_MAX_ROWS, rows - r0);
    g.x = a.x + (size_t)r0 * a.K;
    if (EPI == EPI_STORE) {
      g.out = a.out + (size_t)r0 * a.split1;
      if (a.out1 != nullptr) g.out1 = a.out1 + (size_t)r0 * (a.split2 - a.split1);
      if (a.out2 != nullptr) g.out2 = a.out2 + (size_t)r0 * (n - a.split2);
    } else {
      g.out = a.out + (size_t)r0 * n;
      if (a.res != nullptr) g.res = a.res + (size_t)r0 * n;
    }
    cudaError_t err;
    if (g.rows == 1) {
      err = launch_gemv_rb<T, EPI, WK, NSRC, 1>(g, stream);
    } else if (g.rows == 2) {
      err = launch_gemv_rb<T, EPI, WK, NSRC, 2>(g, stream);
    } else if (g.rows <= 4) {
      err = launch_gemv_rb<T, EPI, WK, NSRC, RB4>(g, stream);
    } else {
      err = launch_gemv_rb<T, EPI, WK, NSRC, RB_MAX>(g, stream);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Per-head RMSNorm (q_norm / k_norm) then rotate-half rotary, one block of
// D threads per (head, row b): blocks x in [0, Hq) rotate q (B, Hq, D) in
// place, blocks x in [Hq, Hq + Hkv) read k_in (B, Hkv, D) and write the
// layer's fresh-K output; cos/sin are (B, D).
template <typename T>
__global__ void qk_norm_rope_kernel(T* q, const T* __restrict__ k_in,
                                    T* __restrict__ k_out,
                                    const T* __restrict__ q_norm,
                                    const T* __restrict__ k_norm,
                                    const float* __restrict__ cos,
                                    const float* __restrict__ sin, int Hq,
                                    int Hkv, float eps) {
  __shared__ float sbuf[32];
  __shared__ float y_s[256];
  const int D = blockDim.x, d = threadIdx.x, j = blockIdx.x, b = blockIdx.y;
  const bool is_q = j < Hq;
  const size_t off = is_q ? ((size_t)b * Hq + j) * D
                          : ((size_t)b * Hkv + (j - Hq)) * D;
  const T* src = is_q ? q + off : k_in + off;
  T* dst = is_q ? q + off : k_out + off;
  const T* w = is_q ? q_norm : k_norm;
  const float v = to_f(src[d]);
  const float ss = block_sum(v * v, sbuf, d, D);
  const float r = 1.f / sqrtf(ss / D + eps);
  const float y = round_to<T>(v * r * to_f(w[d]));
  y_s[d] = y;
  __syncthreads();
  const int half = D / 2;
  const float rot = d < half ? -y_s[d + half] : y_s[d - half];
  dst[d] = from_f<T>(y * cos[(size_t)b * D + d] + rot * sin[(size_t)b * D + d]);
}

// ---- the folded lm_head: final RMSNorm, logits, argmax -----------------

constexpr int FOLD_ROWS = 8;                  // batch rows per launch
constexpr int FOLD_WARPS = 8;
constexpr int FOLD_THREADS = FOLD_WARPS * 32;
constexpr int FOLD_VROWS = 64;                // vocab rows per block, (V, H)
constexpr int FOLD_COLS = 128;                // vocab columns per block, (H, V)
static_assert(FOLD_WARPS == FOLD_ROWS, "int8 fold: warp r reduces row r");

enum FoldKind { FOLD_NONE = 0, FOLD_T_ROWS = 1, FOLD_INT8 = 2 };

// A 64-bit key whose unsigned order is the order of (value, -index): the
// float's bits mapped to an order-preserving unsigned int, then ~index,
// so that of two equal values the lower index has the larger key.
__device__ __forceinline__ unsigned long long argmax_key(float v, int idx) {
  if (v == 0.f) v = 0.f;  // -0 ties +0, as a comparison does
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(~idx);
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// xs[r * H + k] = T(h_r[k] * rnorm_r * w[k]) for the launch's rows: the
// final RMSNorm, each normed value rounded to T as the JAX fold rounds its
// normed row; one warp per row computes the factor.
template <typename T>
__device__ void fold_prologue(const T* h, const T* w, float eps, int rows,
                              int H, float* xs) {
  __shared__ float rnorm[FOLD_ROWS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < rows; r += FOLD_WARPS) {
    const T* xr = h + (size_t)r * H;
    float ss = 0.f;
    for (int k = lane * 8; k < H; k += 32 * 8) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = fmaf(v[i], v[i], ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) rnorm[r] = 1.f / sqrtf(ss / H + eps);
  }
  __syncthreads();
  for (int idx = tid; idx < rows * H; idx += FOLD_THREADS) {
    const int r = idx / H, k = idx % H;
    xs[idx] = round_to<T>(to_f(h[idx]) * rnorm[r] * to_f(w[k]));
  }
  __syncthreads();
}

// (V, H) lm_head in T: the block's FOLD_VROWS vocab rows, one warp per
// row at a time, lanes along H (8 consecutive weights each); each lane r
// keeps row r's best key over its warp's vocab rows.
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
lm_fold_rows_kernel(const T* __restrict__ h, const T* __restrict__ norm_w,
                    float eps, const T* __restrict__ W, int rows, int H,
                    int V, unsigned long long* __restrict__ best) {
  extern __shared__ __align__(16) float fold_xs[];  // rows x H
  __shared__ unsigned long long wkey[FOLD_WARPS][FOLD_ROWS];
  fold_prologue<T>(h, norm_w, eps, rows, H, fold_xs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long mine = 0;
  for (int i = 0; i < FOLD_VROWS / FOLD_WARPS; ++i) {
    const int v = blockIdx.x * FOLD_VROWS + warp + FOLD_WARPS * i;
    if (v >= V) break;
    float acc[FOLD_ROWS];
#pragma unroll
    for (int r = 0; r < FOLD_ROWS; ++r) acc[r] = 0.f;
    const T* wr = W + (size_t)v * H;
    for (int k = lane * 8; k < H; k += 32 * 8) {
      float wv[8];
      load8(wr + k, wv);
#pragma unroll
      for (int r = 0; r < FOLD_ROWS; ++r) {
        if (r < rows) {
          const float4 a = *reinterpret_cast<const float4*>(fold_xs + r * H + k);
          const float4 b = *reinterpret_cast<const float4*>(fold_xs + r * H + k + 4);
          float s = acc[r];
          s = fmaf(wv[0], a.x, s); s = fmaf(wv[1], a.y, s);
          s = fmaf(wv[2], a.z, s); s = fmaf(wv[3], a.w, s);
          s = fmaf(wv[4], b.x, s); s = fmaf(wv[5], b.y, s);
          s = fmaf(wv[6], b.z, s); s = fmaf(wv[7], b.w, s);
          acc[r] = s;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < FOLD_ROWS; ++r) {
      if (r < rows) {
        const float s = warp_sum(acc[r]);  // every lane gets the sum
        if (lane == r) mine = key_max(mine, argmax_key(s, v));
      }
    }
  }
  if (lane < FOLD_ROWS) wkey[warp][lane] = mine;
  __syncthreads();
  if (threadIdx.x < rows) {
    unsigned long long k = 0;
    for (int w = 0; w < FOLD_WARPS; ++w) k = key_max(k, wkey[w][threadIdx.x]);
    atomicMax(best + threadIdx.x, k);
  }
}

// int8 (H, V) lm_head with per-column scales: the block's FOLD_COLS
// columns, lane l holding columns 4l..4l+3, the warps splitting H (k =
// warp, warp + 8, ...); the warps' partials are added in order, scaled,
// and warp r reduces row r's keys.
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
lm_fold_int8_kernel(const T* __restrict__ h, const T* __restrict__ norm_w,
                    float eps, const int8_t* __restrict__ W,
                    const float* __restrict__ scales, int rows, int H, int V,
                    unsigned long long* __restrict__ best) {
  extern __shared__ __align__(16) float fold_xs[];  // rows x H, then red
  float* red = fold_xs + (size_t)FOLD_ROWS * H;     // [warp][row][col]
  fold_prologue<T>(h, norm_w, eps, rows, H, fold_xs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * FOLD_COLS, c = c0 + lane * 4;
  float acc[FOLD_ROWS][4];
#pragma unroll
  for (int r = 0; r < FOLD_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  if (c < V) {  // V % 4 == 0: the lane's 4 columns are all in range
    for (int k = warp; k < H; k += FOLD_WARPS) {
      const unsigned u =
          __ldg(reinterpret_cast<const unsigned*>(W + (size_t)k * V + c));
      float w4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w4[j] = (float)((int)(u << (24 - 8 * j)) >> 24);
#pragma unroll
      for (int r = 0; r < FOLD_ROWS; ++r) {
        if (r < rows) {
          const float xv = fold_xs[r * H + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv, w4[j], acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FOLD_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * FOLD_ROWS + r) * FOLD_COLS + lane * 4 + j] = acc[r][j];
  __syncthreads();
  const int r = warp;
  if (r < rows) {
    unsigned long long mine = 0;
    for (int col = lane; col < FOLD_COLS; col += 32) {
      const int n = c0 + col;
      if (n < V) {
        float s = 0.f;
        for (int w = 0; w < FOLD_WARPS; ++w) {
          s += red[(w * FOLD_ROWS + r) * FOLD_COLS + col];
        }
        mine = key_max(mine, argmax_key(s * scales[n], n));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mine = key_max(mine, __shfl_xor_sync(0xffffffffu, mine, o));
    }
    if (lane == 0) atomicMax(best + r, mine);
  }
}

// tok[r] = the index in row r's best key; the key is reset to 0 for the
// next step.
__global__ void fold_finish_kernel(unsigned long long* best, int* tok, int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < B) {
    tok[r] = (int)~(unsigned)(best[r] & 0xffffffffull);
    best[r] = 0;
  }
}

// The folded lm_head for B rows of h: launches of up to FOLD_ROWS rows,
// each over all V columns, then the token ids.
template <typename T>
cudaError_t launch_lm_fold(const T* h, const T* norm_w, float eps,
                           const void* lm_w, const float* lm_s, int fold,
                           int B, int H, int V, unsigned long long* best,
                           int* tok, cudaStream_t stream) {
  cudaError_t err;
  for (int r0 = 0; r0 < B; r0 += FOLD_ROWS) {
    const int rows = min(FOLD_ROWS, B - r0);
    const T* hr = h + (size_t)r0 * H;
    if (fold == FOLD_INT8) {
      const size_t smem = sizeof(float) * ((size_t)FOLD_ROWS * H +
                                           FOLD_WARPS * FOLD_ROWS * FOLD_COLS);
      err = cudaFuncSetAttribute(lm_fold_int8_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      lm_fold_int8_kernel<T><<<(V + FOLD_COLS - 1) / FOLD_COLS, FOLD_THREADS,
                               smem, stream>>>(
          hr, norm_w, eps, static_cast<const int8_t*>(lm_w), lm_s, rows, H, V,
          best + r0);
    } else {
      const size_t smem = sizeof(float) * (size_t)FOLD_ROWS * H;
      err = cudaFuncSetAttribute(lm_fold_rows_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      lm_fold_rows_kernel<T><<<(V + FOLD_VROWS - 1) / FOLD_VROWS,
                               FOLD_THREADS, smem, stream>>>(
          hr, norm_w, eps, static_cast<const T*>(lm_w), rows, H, V,
          best + r0);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  fold_finish_kernel<<<(B + 127) / 128, 128, 0, stream>>>(best, tok, B);
  return cudaGetLastError();
}

// float32 words of the GEMV split-K partials of one step, rounded up to
// a 16-byte boundary: the attention workspace follows them.
static long long gemv_workspace_words(int B, int H, int Hq, int Hkv, int D,
                                      int I) {
  auto splits = [](int K) { return (long long)(K + GEMV_KC - 1) / GEMV_KC; };
  const long long rows = B < GEMV_MAX_ROWS ? B : GEMV_MAX_ROWS;
  const long long qkv = (long long)Hq * D + 2LL * Hkv * D;
  long long g = splits(H) * qkv;                        // q|k|v
  g = g > splits(Hq * D) * H ? g : splits(Hq * D) * H;  // o
  g = g > 2 * splits(H) * I ? g : 2 * splits(H) * I;    // gate + up
  g = g > splits(I) * H ? g : splits(I) * H;            // down
  return (rows * g + 3) & ~3LL;
}

// Scratch sizes for one step of B rows: sizes[0] 4-byte words of
// workspace (GEMV partials of up to GEMV_MAX_ROWS rows, then K2's
// partials and counters, which must be zero before the first step: the
// kernels leave them zero), sizes[1] int32 GEMV counters (zero likewise),
// sizes[2] T elements. Enough for every weight kind and layout.
extern "C" void decode_layers_fused_scratch(int B, int H, int Hq, int Hkv,
                                            int D, int I, int S,
                                            long long* sizes) {
  const long long qkv = (long long)Hq * D + 2LL * Hkv * D;
  long long n_max = qkv > I ? qkv : I;
  n_max = n_max > H ? n_max : H;
  sizes[0] = gemv_workspace_words(B, H, Hq, Hkv, D, I) +
             attn_workspace_words(B, Hq, Hkv, S, D);
  sizes[1] = (n_max + GEMV_TN - 1) / GEMV_TN;
  sizes[2] = (long long)B * (2LL * Hq * D + (long long)Hkv * D + I);
}

// The step's pointer table (a host array of device pointers): activations,
// slabs and scratch, then the stacked (L, ...) weights and their scales,
// then the slab scales, then the folded lm_head's operands. Merged trees
// pass qkv_w in P_W_Q and gateup_w in P_W_GATE (and their scales likewise)
// and null for k, v and up; float weights pass null scales; slabs of T
// pass null slab scales; an unfolded step passes null fold operands.
enum StepPtr {
  P_X, P_COS, P_SIN, P_IN_LN, P_POST_LN, P_Q_NORM, P_K_NORM, P_K_SLABS,
  P_V_SLABS, P_START, P_END, P_H, P_KS, P_VS, P_WS, P_COUNTERS, P_TMP,
  P_W_Q, P_W_K, P_W_V, P_W_O, P_W_GATE, P_W_UP, P_W_DOWN,
  P_S_Q, P_S_K, P_S_V, P_S_O, P_S_GATE, P_S_UP, P_S_DOWN,
  P_K_SCALES, P_V_SCALES,
  P_FINAL_LN, P_LM_W, P_LM_S, P_BEST, P_TOK, P_COUNT
};

// Layer l's slice of a stacked (L, K, N) weight of kind WK (N unpacked
// output columns) and of its (L, N) scales, or (L, K / gsize, N) for
// W_INT4G.
template <typename T, int WK>
struct Stacked {
  static int row(int N) { return is_int4(WK) ? N / 2 : N; }  // ld, NL
  static size_t esize() { return WK == W_FLOAT ? sizeof(T) : 1; }
  static const void* w(const void* base, int l, int K, int N) {
    return static_cast<const char*>(base) + (size_t)l * K * row(N) * esize();
  }
  static const float* s(const void* base, int l, int K, int N, int gsize) {
    const size_t groups = WK == W_INT4G ? K / gsize : 1;
    return base == nullptr
               ? nullptr
               : static_cast<const float*>(base) + (size_t)l * groups * N;
  }
};

// attn_launches is a host int, incremented once each time
// launch_decode_attention has enqueued K2's kernel (one launch, the merge
// inside it) without error, so the caller counts K2's launches where they are made.
template <typename T, int WK>
cudaError_t decode_layers_fused(const void* const* p, int merged,
                                int* attn_launches, int L, int B, int H,
                                int Hq, int Hkv, int D, int I, int S,
                                int gsize, int fold, int V, float eps,
                                cudaStream_t stream) {
  using W = Stacked<T, WK>;
  const T* x = static_cast<const T*>(p[P_X]);
  const float* cos = static_cast<const float*>(p[P_COS]);
  const float* sin = static_cast<const float*>(p[P_SIN]);
  const T* in_ln = static_cast<const T*>(p[P_IN_LN]);
  const T* post_ln = static_cast<const T*>(p[P_POST_LN]);
  const T* q_norm = static_cast<const T*>(p[P_Q_NORM]);
  const T* k_norm = static_cast<const T*>(p[P_K_NORM]);
  const float* k_scales = static_cast<const float*>(p[P_K_SCALES]);
  const float* v_scales = static_cast<const float*>(p[P_V_SCALES]);
  const int* start = static_cast<const int*>(p[P_START]);
  const int* end = static_cast<const int*>(p[P_END]);
  T* h = static_cast<T*>(const_cast<void*>(p[P_H]));
  T* ks = static_cast<T*>(const_cast<void*>(p[P_KS]));
  T* vs = static_cast<T*>(const_cast<void*>(p[P_VS]));
  float* ws = static_cast<float*>(const_cast<void*>(p[P_WS]));
  int* counters = static_cast<int*>(const_cast<void*>(p[P_COUNTERS]));
  T* tmp = static_cast<T*>(const_cast<void*>(p[P_TMP]));

  const int qd = Hq * D, kvd = Hkv * D, qkvd = qd + 2 * kvd;
  T* qbuf = tmp;                          // (B, Hq * D)
  T* attn = qbuf + (size_t)B * qd;        // (B, Hq * D)
  T* kbuf = attn + (size_t)B * qd;        // (B, Hkv * D)
  T* act = kbuf + (size_t)B * kvd;        // (B, I)
  float* attn_ws = ws + gemv_workspace_words(B, H, Hq, Hkv, D, I);
  const float scale = 1.f / sqrtf((float)D);
  cudaError_t err = cudaMemcpyAsync(h, x, sizeof(T) * B * H,
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  for (int l = 0; l < L; ++l) {
    T* k_l = ks + (size_t)l * B * kvd;  // (B, Hkv, D) of layer l
    T* v_l = vs + (size_t)l * B * kvd;
    GemvArgs<T> g{};
    g.ws = ws;
    g.counters = counters;
    g.eps = eps;
    g.gsize = gsize;
    // q, k, v = RMSNorm(h) @ W
    g.x = h;
    g.norm_w = in_ln + (size_t)l * H;
    g.K = H;
    if (merged) {
      // one product; output columns [0, qd) are q, then k, then v
      g.w0 = W::w(p[P_W_Q], l, H, qkvd);
      g.s0 = W::s(p[P_S_Q], l, H, qkvd, gsize);
      g.NL = g.ld = W::row(qkvd);
      g.out = qbuf; g.out1 = kbuf; g.out2 = v_l;
      g.split1 = qd; g.split2 = qd + kvd;
      if ((err = launch_gemv<T, EPI_STORE, WK, 1>(g, B, stream)) != cudaSuccess) return err;
    } else {
      T* outs[3] = {qbuf, kbuf, v_l};
      const int widths[3] = {qd, kvd, kvd};
      for (int j = 0; j < 3; ++j) {
        g.w0 = W::w(p[P_W_Q + j], l, H, widths[j]);
        g.s0 = W::s(p[P_S_Q + j], l, H, widths[j], gsize);
        g.NL = g.ld = W::row(widths[j]);
        g.out = outs[j]; g.out1 = g.out2 = nullptr;
        g.split1 = g.split2 = widths[j];
        if ((err = launch_gemv<T, EPI_STORE, WK, 1>(g, B, stream)) != cudaSuccess) return err;
      }
    }
    // QK-RMSNorm + rotary; k lands in the fresh-K output
    qk_norm_rope_kernel<T><<<dim3(Hq + Hkv, B), D, 0, stream>>>(
        qbuf, kbuf, k_l, q_norm + (size_t)l * D, k_norm + (size_t)l * D, cos,
        sin, Hq, Hkv, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // attention over each row's stale slab [start, end) + the self K/V
    if (k_scales != nullptr) {
      err = launch_decode_attention<T, int8_t>(
          qbuf, static_cast<const int8_t*>(p[P_K_SLABS]),
          static_cast<const int8_t*>(p[P_V_SLABS]), k_scales, v_scales, k_l,
          v_l, start, end, 0, 0, attn, attn_ws, l, B, Hq, Hkv, S, D, scale,
          stream);
    } else {
      err = launch_decode_attention<T, T>(
          qbuf, static_cast<const T*>(p[P_K_SLABS]),
          static_cast<const T*>(p[P_V_SLABS]), nullptr, nullptr, k_l, v_l,
          start, end, 0, 0, attn, attn_ws, l, B, Hq, Hkv, S, D, scale,
          stream);
    }
    if (err != cudaSuccess) return err;
    ++*attn_launches;
    // h = h + attn @ o_w
    g.x = attn; g.norm_w = nullptr; g.K = qd;
    g.w0 = W::w(p[P_W_O], l, qd, H);
    g.s0 = W::s(p[P_S_O], l, qd, H, gsize);
    g.NL = g.ld = W::row(H);
    g.res = h; g.out = h; g.out1 = g.out2 = nullptr;
    if ((err = launch_gemv<T, EPI_RESIDUAL, WK, 1>(g, B, stream)) != cudaSuccess) return err;
    // act = silu(RMSNorm(h) @ gate_w) * (RMSNorm(h) @ up_w)
    g.x = h; g.norm_w = post_ln + (size_t)l * H; g.K = H; g.out = act;
    g.res = nullptr;
    if (merged) {
      g.w0 = W::w(p[P_W_GATE], l, H, 2 * I);
      g.s0 = W::s(p[P_S_GATE], l, H, 2 * I, gsize);
      g.s1 = g.s0 == nullptr ? nullptr : g.s0 + I;
      if constexpr (is_int4(WK)) {
        // packed column j: gate j (low nibble), up j (high nibble)
        g.NL = g.ld = I;
        err = launch_gemv<T, EPI_SWIGLU, WK, 1>(g, B, stream);
      } else {
        // gate j and up j are columns j and I + j of one row
        g.w1 = static_cast<const char*>(g.w0) + (size_t)I * W::esize();
        g.NL = I; g.ld = 2 * I;
        err = launch_gemv<T, EPI_SWIGLU, WK, 2>(g, B, stream);
      }
    } else if constexpr (WK == W_INT4G) {
      err = cudaErrorInvalidValue;  // int4g: merged only
    } else {
      g.w0 = W::w(p[P_W_GATE], l, H, I); g.w1 = W::w(p[P_W_UP], l, H, I);
      g.s0 = W::s(p[P_S_GATE], l, H, I, gsize);
      g.s1 = W::s(p[P_S_UP], l, H, I, gsize);
      g.NL = g.ld = W::row(I);
      err = launch_gemv<T, EPI_SWIGLU, WK, 2>(g, B, stream);
    }
    if (err != cudaSuccess) return err;
    // h = h + act @ down_w
    g.x = act; g.norm_w = nullptr; g.K = I;
    g.w0 = W::w(p[P_W_DOWN], l, I, H); g.w1 = nullptr;
    g.s0 = W::s(p[P_S_DOWN], l, I, H, gsize); g.s1 = nullptr;
    g.NL = g.ld = W::row(H);
    g.res = h; g.out = h;
    if ((err = launch_gemv<T, EPI_RESIDUAL, WK, 1>(g, B, stream)) != cudaSuccess) return err;
  }
  if (fold != FOLD_NONE) {
    err = launch_lm_fold<T>(
        h, static_cast<const T*>(p[P_FINAL_LN]), eps, p[P_LM_W],
        static_cast<const float*>(p[P_LM_S]), fold, B, H, V,
        static_cast<unsigned long long*>(const_cast<void*>(p[P_BEST])),
        static_cast<int*>(const_cast<void*>(p[P_TOK])), stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// wkind: 0 T weights, 1 int8, 2 int4, 3 int4g (WeightKind; int4g merged
// only, with gsize rows per group); fold: FoldKind, over V vocab columns.
// Shapes the kernels cannot take are refused before anything is launched.
template <typename T>
int decode_layers_fused_entry(const void* const* p, int wkind, int merged,
                              int* attn_launches, int L, int B, int H,
                              int Hq, int Hkv, int D, int I, int S, int gsize,
                              int fold, int V, float eps, void* stream) {
  const int align = is_int4(wkind) ? 16 : 8;  // 8 loaded columns per thread
  if (B < 1 || D > 256 || D % 32 != 0 || H % align != 0 || I % align != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (wkind == W_INT4G &&
      (!merged || !(gsize == 32 || gsize == 64 || (gsize > 0 && gsize % 128 == 0)) ||
       H % gsize != 0 || I % gsize != 0 || (Hq * D) % gsize != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fold < FOLD_NONE || fold > FOLD_INT8 ||
      (fold != FOLD_NONE && (V < 1 || (fold == FOLD_INT8 && V % 4 != 0)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_LAYERS_CASE(WK)                                               \
  case WK:                                                                   \
    return static_cast<int>(decode_layers_fused<T, WK>(                      \
        p, merged, attn_launches, L, B, H, Hq, Hkv, D, I, S, gsize, fold, V, \
        eps, st));
  switch (wkind) {
    DECODE_LAYERS_CASE(W_FLOAT)
    DECODE_LAYERS_CASE(W_INT8)
    DECODE_LAYERS_CASE(W_INT4)
    DECODE_LAYERS_CASE(W_INT4G)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DECODE_LAYERS_CASE
}

#define DECODE_LAYERS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* const* p, int wkind, int merged,           \
                      int* attn_launches, int L, int B, int H, int Hq,       \
                      int Hkv, int D, int I, int S, int gsize, int fold,     \
                      int V, float eps, void* stream) {                      \
    return decode_layers_fused_entry<T>(p, wkind, merged, attn_launches, L,  \
                                        B, H, Hq, Hkv, D, I, S, gsize, fold, \
                                        V, eps, stream);                     \
  }

DECODE_LAYERS_ENTRY(decode_layers_fused_bf16, bf16)
DECODE_LAYERS_ENTRY(decode_layers_fused_f32, float)
