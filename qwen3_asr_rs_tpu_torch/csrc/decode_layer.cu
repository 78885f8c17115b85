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
// float32 partial is scaled before the groups are summed.
//
// The folded lm_head (fold != FOLD_NONE) runs after the last layer: the
// final RMSNorm as the GEMVs' prologue, float32 logits and their argmax:
// each block's best (value, index) per row goes into one 64-bit atomicMax
// on (order-preserving float bits, ~index), so the result does not depend
// on the order of the blocks and a tie gives the lowest index, as
// jnp.argmax does. A (V, H) lm_head in T runs one warp per vocab row,
// lanes along H; an int8 (H, V) one with per-column scales runs as a
// GEMV with an argmax epilogue (T = bf16: the tensor-core GEMV below).
//
// What bounds it on the H100: the weight stream. At 0.6B a layer holds
// 15.7 M parameters, 28 layers 0.88 GB per step in bf16 (0.26 ms at the
// data-sheet 3.35 TB/s), 0.44 GB in int8, 0.22 GB in int4, whatever B is:
// every GEMV reads its weight once for up to 32 rows. What the design does
// about it, for T = bf16 (the main path):
// - the GEMVs run on the tensor cores, so up to 32 rows take one pass over
//   the weights and no per-row FMAs. bf16 weights (gw_route) take the
//   wgmma GEMV (gemv_wgmma.cuh: a TMA ring of weight tiles,
//   wgmma.m64n32k16 with the batch rows as N, K split over a thread-block
//   cluster and summed in rank order in the owners' shared memory); every
//   quantized kind takes the mma.sync GEMV
//   (gemv_mma.cuh: m16n8k16, output columns as the 16-row side, batch rows
//   as the 8-wide side), which streams each block's K range through a
//   4-stage ring of 16-byte cp.async copies, with the K split from the
//   shapes and B (gm_split_rows): at most one round of two blocks per SM,
//   split-K partials in a global workspace no larger than the weights, a
//   deterministic last-block reduction in split order of at most 256 rows
//   x splits;
// - 6 launches per layer in every layout (q|k|v one launch, merged or as
//   three column segments); the GEMVs and the QK-norm kernel are launched
//   with programmatic dependent launch: a GEMV fetches its first weight
//   stages, which no earlier kernel writes, while the previous kernel
//   finishes, and waits for it (pdl_wait) before it reads its input or the
//   shared split-K counters. K2 is launched plainly: launched the same
//   way it made the step slower (PERF.md);
// - x comes into shared memory as one cp.async group; the RMSNorm before
//   a projection takes each row's sum of squares in parts, one per column
//   tile, that the residual GEMV which wrote the row left (added in tile
//   order, so the step is deterministic; layer 0 sums its input itself),
//   which saves a launch and each block's pass over whole rows.
// T = float keeps CUDA-core GEMVs (gemv_kernel): it is the float32 parity
// path, and bf16 operands would lose its 1e-3 parity.
#include <type_traits>

#include "decode_attention.cuh"
#include "gemv_mma.cuh"
#include "gemv_wgmma.cuh"

// the float32 parity path's CUDA-core GEMV
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
static_assert(GEMV_TN == GM_TN, "both GEMVs tile the columns alike");

// STORE, RESIDUAL and SWIGLU: see gemv_kernel; ARGMAX: the folded int8
// lm_head's logits into per-row argmax keys
enum Epilogue { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2, EPI_ARGMAX = 3 };

template <typename T>
struct GemvArgs {
  const T* x;        // (rows, K) input rows
  const T* norm_w;   // (K,) RMSNorm weight applied to each row first, or null
  float eps;
  // up to 3 column segments, each a weight (K rows of stride ld elements;
  // bytes for int8/int4) of nl loaded columns with its per-output-column
  // scales (null for T weights; W_INT4G: the (G, 2 nl) group scales, G =
  // K / gsize); an int4 byte column j gives outputs j and j + nl. Blocks
  // walk the segments' column tiles in order: unmerged q|k|v is one launch.
  int nseg;
  const void* w0[3];
  const float* s0[3];
  int nl[3], ld[3];
  const void* w1;    // EPI_SWIGLU with two sources (one segment): "up"
  const float* s1;
  int gsize;         // W_INT4G: rows per scale group
  const T* res;      // (rows, N) residual (EPI_RESIDUAL); may alias out
  // EPI_STORE writes output columns [0, split1) of each row (over all
  // segments, in order) to out (row stride split1), [split1, split2) to
  // out1 and [split2, ntot) to out2; the other epilogues write (rows,
  // ntot) to out
  T* out;
  T* out1;
  T* out2;
  int split1, split2, ntot;
  unsigned long long* best;  // EPI_ARGMAX: (rows,) keys
  // split-K partials, per segment (rows, accumulators, splits, nl)
  float* ws;
  int* counters;     // (column tiles,) zero on entry, zero on exit
  int rows, K;
  int kb;            // rows of K per block (the tensor-core GEMVs)
  int stages;        // the wgmma GEMV's ring of weight stages
  // Each row's sum of squares in parts, one per column tile of the GEMV
  // that wrote the row (row stride ssq_stride floats): EPI_RESIDUAL
  // writes the parts of its output (ssq_out), a normed GEMV adds the
  // ssq_tiles parts of its input in tile order for its RMSNorm (ssq_in;
  // null: it sums the row itself)
  float* ssq_out;
  const float* ssq_in;
  int ssq_stride, ssq_tiles;
};

// The segment of column tile `tile` of a launch: its weights, scales and
// width, its first loaded column c0, the output column of its first
// column, and where its split-K partials start.
struct GemvSeg {
  const void* w0;
  const void* w1;
  const float* s0;
  const float* s1;
  int seg, nl, ld, c0, obase;
  size_t ws_off;
};

template <typename T>
__device__ __forceinline__ GemvSeg gemv_segment(const GemvArgs<T>& a,
                                                int tile, int nv, int nacc,
                                                int nk) {
  int s = 0, before = 0;
  while (s + 1 < a.nseg) {
    const int t = (a.nl[s] + GEMV_TN - 1) / GEMV_TN;
    if (tile < t) break;
    tile -= t;
    before += a.nl[s];
    ++s;
  }
  GemvSeg g;
  g.seg = s;
  g.w0 = a.w0[s];
  g.w1 = a.w1;
  g.s0 = a.s0[s];
  g.s1 = a.s1;
  g.nl = a.nl[s];
  g.ld = a.ld[s];
  g.c0 = tile * GEMV_TN;
  g.obase = before * nv;
  g.ws_off = (size_t)a.rows * nacc * nk * before;
  return g;
}

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

__device__ __forceinline__ float scaled(float v, const float* s, int n) {
  return s != nullptr ? v * s[n] : v;
}

// Whether this block is the last of its column tile to publish its
// partials (then it runs the epilogue); the count is per column tile.
__device__ __forceinline__ bool gemv_last_block(int* counter, int nk,
                                                int tid) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == nk - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The epilogue of one output (row r, loaded column nl of the segment sg)
// from its NACC float32 sums t over all of K (the scale multiplies the
// whole contraction, after the partials are summed, and only then rounds
// to T; int4g partials are scaled already):
//   STORE:    out = T(y s)
//   RESIDUAL: out = T(res + T(y s)); returns the square of what it wrote
//             (res: the residual's NV values loaded already, or null)
//   SWIGLU:   out = T(T(silu(T(gate s0))) * T(up s1)), where gate and up
//             come from two weights (w0, w1) or, for a merged int4
//             gate|up, from the low and high nibbles of one byte
// Both tensor-core GEMVs end in it, so they round alike.
template <typename T, int EPI, int WK, int NSRC>
__device__ __forceinline__ float gemv_output(const GemvArgs<T>& a,
                                             const GemvSeg& sg, int r,
                                             int nl, const float* t,
                                             const float* res = nullptr) {
  constexpr int NV = is_int4(WK) ? 2 : 1;
  constexpr bool kGroups = WK == W_INT4G;
  const float* es0 = kGroups ? nullptr : sg.s0;
  const float* es1 = kGroups ? nullptr : sg.s1;
  float sq = 0.f;
  if constexpr (EPI == EPI_SWIGLU) {
    // pairs (gate, up) of accumulators, each pair one output column
    constexpr int NPAIR = NSRC == 1 ? 1 : NV;
    const size_t N = (size_t)sg.nl * NPAIR;
#pragma unroll
    for (int v = 0; v < NPAIR; ++v) {
      const int gi = NSRC == 1 ? 0 : v, ui = NSRC == 1 ? 1 : NV + v;
      const int on = nl + v * sg.nl;
      const float gate = round_to<T>(scaled(t[gi], es0, on));
      const float up = round_to<T>(scaled(t[ui], es1, on));
      const float act = round_to<T>(gate * (1.f / (1.f + expf(-gate))));
      a.out[r * N + on] = from_f<T>(act * up);
    }
  } else {
    static_assert(EPI == EPI_STORE || EPI == EPI_RESIDUAL,
                  "ARGMAX: gemv_epilogue's keys");
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int on = nl + v * sg.nl;
      const float y = round_to<T>(scaled(t[v], es0, on));
      if constexpr (EPI == EPI_STORE) {
        const int og = sg.obase + on;
        if (og < a.split1) {
          a.out[(size_t)r * a.split1 + og] = from_f<T>(y);
        } else if (og < a.split2) {
          a.out1[(size_t)r * (a.split2 - a.split1) + og - a.split1] =
              from_f<T>(y);
        } else {
          a.out2[(size_t)r * (a.ntot - a.split2) + og - a.split2] =
              from_f<T>(y);
        }
      } else {
        const size_t N = (size_t)sg.nl * NV;
        const float rv = res != nullptr ? res[v] : to_f(a.res[r * N + on]);
        const float o = round_to<T>(rv + y);
        a.out[r * N + on] = from_f<T>(o);
        sq = fmaf(o, o, sq);
      }
    }
  }
  return sq;
}

// The last block of a column tile adds all split-K partials in split
// order and runs the epilogue (gemv_output; ARGMAX: best[r] = max(best[r],
// key(y s, column))) for every row. A thread adds 4 adjacent columns of
// one row, 16-byte loads of several splits in flight, in split order,
// then runs the epilogue of each.
template <typename T, int EPI, int WK, int NSRC, int NTHREADS>
__device__ void gemv_epilogue(const GemvArgs<T>& a, const GemvSeg& sg,
                              int nk, int tid) {
  constexpr int NV = is_int4(WK) ? 2 : 1;
  constexpr int NACC = NSRC * NV;
  constexpr int TPR = GEMV_TN / 4;         // threads per row: 16, a half warp
  constexpr int RPP = NTHREADS / TPR;      // rows per pass
  __shared__ unsigned long long kbest[GEMV_MAX_ROWS];
  // RESIDUAL with ssq_out: each row's sum of squares of the outputs
  __shared__ float sq_row[GEMV_MAX_ROWS];
  const bool ssq = EPI == EPI_RESIDUAL && a.ssq_out != nullptr;
  const float* ws = a.ws + sg.ws_off;
  if constexpr (EPI == EPI_ARGMAX) {
    if (tid < a.rows) kbest[tid] = 0;
    __syncthreads();
  }
  // the output (row r, loaded column nl) from its NACC sums t
  auto output = [&](int r, int nl, const float* t) -> float {
    if constexpr (EPI == EPI_ARGMAX) {
      const float* es0 = WK == W_INT4G ? nullptr : sg.s0;
      atomicMax(&kbest[r], argmax_key(scaled(t[0], es0, nl), nl));
      return 0.f;
    } else {
      return gemv_output<T, EPI, WK, NSRC>(a, sg, r, nl, t);
    }
  };
  // every thread takes every pass (the row shuffles below)
  for (int r0 = 0; r0 < a.rows; r0 += RPP) {
    const int r = r0 + tid / TPR, nl0 = sg.c0 + 4 * (tid % TPR);
    const bool live = r < a.rows && nl0 < sg.nl;  // sg.nl % 4 == 0
    float4 tot[NACC];
#pragma unroll
    for (int which = 0; which < NACC; ++which) {
      tot[which] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float sq = 0.f;
    if (live) {
#pragma unroll(4 / NACC)
      for (int ks = 0; ks < nk; ++ks) {
#pragma unroll
        for (int which = 0; which < NACC; ++which) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              ws + (((size_t)r * NACC + which) * nk + ks) * sg.nl + nl0));
          tot[which].x += v.x;
          tot[which].y += v.y;
          tot[which].z += v.z;
          tot[which].w += v.w;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t[NACC];
#pragma unroll
        for (int which = 0; which < NACC; ++which) {
          const float4& v = tot[which];
          t[which] = c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
        }
        sq += output(r, nl0 + c, t);
      }
    }
    if (ssq) {  // the row's 16 threads, in a fixed order
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) {
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      if (tid % TPR == 0 && r < a.rows) sq_row[r] = sq;
    }
  }
  if (ssq) {
    __syncthreads();
    for (int r = tid; r < a.rows; r += NTHREADS) {
      a.ssq_out[(size_t)r * a.ssq_stride + blockIdx.x] = sq_row[r];
    }
  }
  if constexpr (EPI == EPI_ARGMAX) {
    __syncthreads();
    if (tid < a.rows) atomicMax(a.best + tid, kbest[tid]);
  }
  if (tid == 0) a.counters[blockIdx.x] = 0;
}

// ---- T = float: the CUDA-core GEMV -------------------------------------

// GEMV_CPT consecutive weights of one row of W, as loaded: 32-bit words
// (float: 8, int8 and int4: 2).
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
#pragma unroll
    for (int i = 0; i < GEMV_CPT; ++i) lo[i] = __uint_as_float(v.w[i]);
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

// y = x @ W for every row of x over NSRC weights of kind WK, then
// gemv_epilogue. Each thread holds its GEMV_KPT x 8 weights in registers
// and applies them to RB rows at a time; a block reduces a 128-row K
// slice. int4g: at group sizes that are multiples of 128 the block's slice
// lies in one group and its published partial is scaled; at 32 and 64
// each thread's 32-row stripes lie in one group each, and the thread
// scales the unpacked weights of a stripe before its FMAs.
template <int EPI, int WK, int NSRC, int RB>
__global__ void __launch_bounds__(GEMV_THREADS, 1)
gemv_kernel(GemvArgs<float> a) {
  using T = float;
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
  pdl_launch_dependents();
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * GEMV_TX + tx;
  const int lane = tid & 31, warp = tid >> 5;
  const int nk = gridDim.y;
  const GemvSeg sg = gemv_segment(a, blockIdx.x, NV, NACC, nk);
  const int k0 = blockIdx.y * GEMV_KC;
  const int kend = min(k0 + GEMV_KC, a.K);
  const int nb = sg.c0;
  const int n0 = nb + tx * GEMV_CPT;

  // this thread's weights, loaded once: rows k0 + ty + GEMV_TY * j
  WeightVec<T, WK> wv[GEMV_KPT][NSRC];
#pragma unroll
  for (int j = 0; j < GEMV_KPT; ++j) {
    const int k = k0 + ty + GEMV_TY * j;
#pragma unroll
    for (int src = 0; src < NSRC; ++src) {
      if (k < kend && n0 < sg.nl) {
        load_wvec<T, WK>(src == 0 ? sg.w0 : sg.w1, (size_t)k * sg.ld + n0,
                         wv[j][src]);
      } else {
#pragma unroll
        for (int i = 0; i < WeightVec<T, WK>::WORDS; ++i) wv[j][src].w[i] = 0;
      }
    }
  }
  pdl_wait();

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
      gsc[j][v][col] = k < a.K && nb + col < sg.nl
          ? sg.s0[(size_t)(k / a.gsize) * 2 * sg.nl + nb + col + v * sg.nl]
          : 0.f;
    }
  }
  __syncthreads();

  float* ws = a.ws + sg.ws_off;
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
        if (!stripe_scales && n < sg.nl) {
          // the block's K slice lies in one group: its scale, on the partial
          s *= sg.s0[(size_t)(k0 / a.gsize) * 2 * sg.nl + n + which * sg.nl];
        }
      }
      if (r < a.rows && n < sg.nl) {
        ws[(((size_t)r * NACC + which) * nk + blockIdx.y) * sg.nl + n] = s;
      }
    }
    __syncthreads();  // red is reused by the next group
  }
  if (!gemv_last_block(a.counters + blockIdx.x, nk, tid)) return;
  gemv_epilogue<T, EPI, WK, NSRC, GEMV_THREADS>(a, sg, nk, tid);
}

// ---- T = bf16: the tensor-core GEMV ------------------------------------

// dynamic shared memory a tensor-core GEMV may take
constexpr int GEMV_SMEM_MAX = 200 * 1024;

// y = x @ W for up to 32 rows (8 * NB8 staged, the rest zero) over NSRC
// weights of kind WK (gemv_mma.cuh), then gemv_epilogue. Each warp owns 16
// columns of the block's GEMV_TN and the block's whole K range (a.kb rows
// from blockIdx.y * a.kb): one float32 accumulator per (source, nibble,
// row, column). int4g: the warp sums each group of rows into its own
// float32 partial, which the group's scale (staged with the weights)
// multiplies before it joins the running sum, in group order; the K split
// never cuts a group.
template <int EPI, int WK, int NSRC, int NB8>
__global__ void __launch_bounds__(GM_THREADS, 1)
gemv_mma_kernel(GemvArgs<bf16> a) {
  constexpr int NV = is_int4(WK) ? 2 : 1;
  constexpr int NACC = NSRC * NV;
  constexpr bool kGroups = WK == W_INT4G;
  constexpr int SB = gm_stage_bytes<WK>();
  // a stage: the weight tiles, then (int4g) the scales of its <= 2 groups
  constexpr int STAGE = NSRC * SB + (kGroups ? 2 * 2 * GM_TN * 4 : 0);
  static_assert(!kGroups || NSRC == 1, "int4g: one packed source");
  extern __shared__ __align__(16) unsigned char gm_buf[];
  __shared__ float rnorm[GEMV_MAX_ROWS];
  pdl_launch_dependents();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = gridDim.y, split = blockIdx.y;
  const GemvSeg sg = gemv_segment(a, blockIdx.x, NV, NACC, nk);
  const int k_begin = split * a.kb, k_end = min(a.K, k_begin + a.kb);
  const int nst = (k_end - k_begin + GM_KS - 1) / GM_KS;
  // the block's K range of x in shared memory, bf16 rows of xstride, zero
  // past the last row and past K; a normed GEMV's norm weights after it
  const bool normed = a.norm_w != nullptr;
  const int xstride = a.kb + GM_XPAD;
  bf16* xs = reinterpret_cast<bf16*>(gm_buf + GM_STAGES * STAGE);
  bf16* nws = xs + (size_t)8 * NB8 * xstride;

  // stage st of the block's K range: the weight tiles (and the int4g
  // scales) as one cp.async group; past the range an empty group
  auto fetch = [&](int st) {
    if (st < nst) {
      unsigned char* p = gm_buf + (st % GM_STAGES) * STAGE;
      const int k0 = k_begin + st * GM_KS;
      gm_load_stage<WK>(p, sg.w0, sg.ld, k0, k_end, sg.c0, sg.nl, tid);
      if constexpr (NSRC == 2) {
        gm_load_stage<WK>(p + SB, sg.w1, sg.ld, k0, k_end, sg.c0, sg.nl, tid);
      }
      if constexpr (kGroups) {
        // [group of the stage][low, high nibble][GM_TN columns]
        float* sc = reinterpret_cast<float*>(p + NSRC * SB);
        const int ng = a.gsize < GM_KS ? GM_KS / a.gsize : 1;
        const int g0 = k0 / a.gsize;
        for (int i = tid; i < ng * 2 * (GM_TN / 4); i += GM_THREADS) {
          const int gi = i / (2 * (GM_TN / 4)), v = (i / (GM_TN / 4)) & 1;
          const int c = 4 * (i % (GM_TN / 4)), n = sg.c0 + c;
          const bool ok = n < sg.nl && (g0 + gi) * a.gsize < k_end;
          cp_async16(sc + (gi * 2 + v) * GM_TN + c,
                     ok ? sg.s0 + (size_t)(g0 + gi) * 2 * sg.nl + v * sg.nl + n
                        : sg.s0,
                     ok);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) fetch(s);
  pdl_wait();

  // the rows of x (and the norm weights) as one cp.async group, all in
  // flight at once
  for (int i = tid; i < 8 * NB8 * (a.kb / 8); i += GM_THREADS) {
    const int r = i / (a.kb / 8), c = 8 * (i % (a.kb / 8)), k = k_begin + c;
    const bool ok = r < a.rows && k < k_end;
    cp_async16(xs + (size_t)r * xstride + c,
               ok ? a.x + (size_t)r * a.K + k : a.x, ok);
  }
  if (normed) {
    for (int c = 8 * tid; c < nst * GM_KS; c += 8 * GM_THREADS) {
      const bool ok = k_begin + c < k_end;
      cp_async16(nws + c, ok ? a.norm_w + k_begin + c : a.norm_w, ok);
    }
  }
  cp_async_commit();
  if (normed) {
    // RMSNorm factor of each row: from the parts of its sum of squares the
    // GEMV that wrote it left (in tile order, while x's copies fly), else
    // from the row (one warp per row)
    if (a.ssq_in != nullptr) {
      for (int r = tid; r < a.rows; r += GM_THREADS) {
        const float* q = a.ssq_in + (size_t)r * a.ssq_stride;
        float ss = 0.f;
#pragma unroll 8
        for (int t = 0; t < a.ssq_tiles; ++t) ss += __ldcg(q + t);
        rnorm[r] = 1.f / sqrtf(ss / a.K + a.eps);
      }
    } else {
      for (int r = warp; r < a.rows; r += GM_WARPS) {
        const bf16* xr = a.x + (size_t)r * a.K;
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
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (normed) {
    // the block's K range of every row normed and rounded to T, in place
    const int chunks = (k_end - k_begin) / 8;
    for (int i = tid; i < a.rows * chunks; i += GM_THREADS) {
      const int r = i / chunks, c = 8 * (i % chunks);
      bf16* p = xs + (size_t)r * xstride + c;
      float v[8], w[8];
      lds8(p, v);
      lds8(nws + c, w);
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = __floats2bfloat162_rn(v[2 * j] * rnorm[r] * w[2 * j],
                                     v[2 * j + 1] * rnorm[r] * w[2 * j + 1]);
      }
      *reinterpret_cast<uint4*>(p) = u;
    }
  }
  float acc[NACC][NB8][4], gacc[NACC][NB8][4];
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][nb][c] = gacc[j][nb][c] = 0.f;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<GM_STAGES - 2>();
    __syncthreads();  // stage st landed; stage st - 1 is free for reuse
    fetch(st + GM_STAGES - 1);
    const unsigned char* p = gm_buf + (st % GM_STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < GM_KS / 16; ++kk) {
      const int kl = st * GM_KS + 16 * kk;
      unsigned b[NB8][2];
#pragma unroll
      for (int nb = 0; nb < NB8; ++nb) {
        gm_frag_x(xs, xstride, kl, nb, lane, b[nb]);
      }
#pragma unroll
      for (int src = 0; src < NSRC; ++src) {
        unsigned a0[4], a1[4];
        if constexpr (WK == W_FLOAT) {
          gm_frag_bf16(p + src * SB, kk, warp, lane, a0);
        } else if constexpr (WK == W_INT8) {
          gm_frag_int8(p + src * SB, kk, warp, lane, a0);
        } else {
          gm_frag_int4(p + src * SB, kk, warp, lane, a0, a1);
        }
#pragma unroll
        for (int nb = 0; nb < NB8; ++nb) {
          if constexpr (kGroups) {
            gm_mma(gacc[src * NV][nb], a0, b[nb]);
            gm_mma(gacc[src * NV + 1][nb], a1, b[nb]);
          } else {
            gm_mma(acc[src * NV][nb], a0, b[nb]);
            if constexpr (NV == 2) gm_mma(acc[src * NV + 1][nb], a1, b[nb]);
          }
        }
      }
      if constexpr (kGroups) {
        const int done = k_begin + kl + 16;  // rows of K summed so far
        if (done % a.gsize == 0 || done >= k_end) {
          // the group ends: its partial times its scales joins the sum
          const int gi = a.gsize < GM_KS ? (16 * kk) / a.gsize : 0;
          const float* sc =
              reinterpret_cast<const float*>(p + NSRC * SB) + gi * 2 * GM_TN;
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float s = sc[v * GM_TN + gm_col<WK>(warp, lane, c >> 1)];
#pragma unroll
              for (int nb = 0; nb < NB8; ++nb) {
                acc[v][nb][c] = fmaf(gacc[v][nb][c], s, acc[v][nb][c]);
                gacc[v][nb][c] = 0.f;
              }
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  // publish this block's partials to the split-K workspace
  float* ws = a.ws + sg.ws_off;
#pragma unroll
  for (int which = 0; which < NACC; ++which)
#pragma unroll
    for (int nb = 0; nb < NB8; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = 8 * nb + gm_acc_row(lane, c);
        const int n = sg.c0 + gm_col<WK>(warp, lane, c >> 1);
        if (r < a.rows && n < sg.nl) {
          ws[(((size_t)r * NACC + which) * nk + split) * sg.nl + n] =
              acc[which][nb][c];
        }
      }
  if (!gemv_last_block(a.counters + blockIdx.x, nk, tid)) return;
  gemv_epilogue<bf16, EPI, WK, NSRC, GM_THREADS>(a, sg, nk, tid);
}

// ---- T = bf16, bf16 weights: the wgmma GEMV ----------------------------

// The tensor maps of a wgmma GEMV launch: the weight of each column
// segment, the SwiGLU "up" weight (w1), and x
struct GwMaps {
  CUtensorMap w[3];
  CUtensorMap up;
  CUtensorMap x;
};

// y = x @ W for up to 8 * NB8 rows over NSRC bf16 weights (gemv_wgmma.cuh),
// then gemv_output. Block b of the grid is rank b % cs of a cluster of cs
// blocks (the cluster's K ranks: rows [rank a.kb, +a.kb) of K) that share
// column tile b / cs. Warp 4 is the producer: its lane 0 initializes the
// ring's barriers, issues the first GW_PREFETCH stages' weight tiles,
// waits for the previous kernel, issues their x, then keeps the ring of
// a.stages stages full.
// Threads 0-127 (a warpgroup) wait for the previous kernel, take a normed
// GEMV's RMSNorm factors and norm weights, and per stage (normed: round
// its x to the normed row in place) issue one wgmma per 16 rows of K and
// source into 4 NB8 float32 accumulators each. Partials: each rank
// stores its sums of row n into the shared memory of the owner of n
// (rank n / (N / cs)), slot rank; after one cluster barrier each owner
// adds its rows' slots in rank order (0 + p0 + p1 + ...: deterministic,
// as the mma.sync GEMV's split order) and runs the epilogue over the
// tile's 64 columns, 16 threads a row.
template <int EPI, int NB8>
__global__ void __launch_bounds__(GW_THREADS, 3)
gemv_wgmma_kernel(const __grid_constant__ GwMaps maps, GemvArgs<bf16> a) {
  constexpr int NSRC = EPI == EPI_SWIGLU ? 2 : 1;
  constexpr int N = 8 * NB8;           // staged rows: wgmma's N
  constexpr int NACC = 4 * NB8;        // accumulators per thread and source
  constexpr int STAGE = gw_stage_bytes(NSRC, NB8);
  constexpr int XOFF = NSRC * GW_W_BYTES;  // x's rows in a stage
  constexpr int TPR = GW_TN / 4;       // epilogue threads per row
  static_assert(EPI != EPI_ARGMAX, "bf16 weights: no folded argmax");
  static_assert(N / GW_MAX_CLUSTER >= 1, "every rank owns a row");
  extern __shared__ __align__(16) unsigned char gw_raw[];
  unsigned char* smem =
      gw_raw + ((1024 - (gm_smem_u32(gw_raw) & 1023)) & 1023);
  __shared__ float rnorm[N];
  pdl_launch_dependents();
  // every block of the cluster has started before any writes into
  // another's shared memory (the matching wait comes after the products)
  gw_cluster_arrive();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = (int)gw_cluster_size(), rank = (int)gw_cluster_rank();
  const int tile = blockIdx.x / cs, S = a.stages;
  const GemvSeg sg = gemv_segment(a, tile, 1, NSRC, 1);
  const int k_begin = rank * a.kb, k_end = min(a.K, k_begin + a.kb);
  const int nst = k_end > k_begin ? (k_end - k_begin + GW_KS - 1) / GW_KS : 0;
  unsigned char* ring = smem;                                  // S stages
  float* red = reinterpret_cast<float*>(ring + S * STAGE);     // partials
  bf16* nws = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(red) + gw_red_bytes(NSRC, NB8));
  uint64_t* full = reinterpret_cast<uint64_t*>(nws + a.kb);
  uint64_t* empty = full + S;
  const int rp = N / cs;  // rows per owner

  float acc[NSRC][NACC];
#pragma unroll
  for (int src = 0; src < NSRC; ++src)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[src][i] = 0.f;

  if (warp == GW_CONSUMERS / 32) {
    // the producer
    if (lane == 0) {
      // the descriptors of the first copies, fetched while the barriers
      // are set up
      gw_prefetch_map(&maps.w[sg.seg]);
      gw_prefetch_map(&maps.x);
      if constexpr (NSRC == 2) gw_prefetch_map(&maps.up);
      for (int s = 0; s < S; ++s) {
        gw_bar_init(full + s, 1);
        gw_bar_init(empty + s, GW_CONSUMERS / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    // the consumers may wait on the barriers
    asm volatile("bar.arrive 2, %0;\n" ::"n"(GW_THREADS) : "memory");
    if (lane == 0) {
      const CUtensorMap* wmap = &maps.w[sg.seg];
      auto weights = [&](int st) {
        unsigned char* d = ring + (st % S) * STAGE;
        uint64_t* bar = full + st % S;
        const int k0 = k_begin + st * GW_KS;
        gw_bar_expect(bar, STAGE);
        gw_tma_2d(d, wmap, sg.c0, k0, bar);
        if constexpr (NSRC == 2) {
          gw_tma_2d(d + GW_W_BYTES, &maps.up, sg.c0, k0, bar);
        }
      };
      auto xrows = [&](int st) {
        gw_tma_2d(ring + (st % S) * STAGE + XOFF, &maps.x,
                  k_begin + st * GW_KS, 0, full + st % S);
      };
      const int first = nst < S ? nst : S;
      const int pre = first < GW_PREFETCH ? first : GW_PREFETCH;
      for (int st = 0; st < pre; ++st) weights(st);
      pdl_wait();  // x is the previous kernel's output
      for (int st = 0; st < pre; ++st) xrows(st);
      for (int st = pre; st < first; ++st) {
        weights(st);
        xrows(st);
      }
      for (int st = S; st < nst; ++st) {
        gw_bar_wait(empty + st % S, (st / S - 1) & 1);
        weights(st);
        xrows(st);
      }
    }
  } else {
    pdl_wait();
    const bool normed = a.norm_w != nullptr;
    if (normed) {
      // the rank's norm weights (zero past K), one cp.async group
      for (int c = 8 * tid; c < a.kb; c += 8 * GW_CONSUMERS) {
        const bool ok = k_begin + c < k_end;
        cp_async16(nws + c, ok ? a.norm_w + k_begin + c : a.norm_w, ok);
      }
      cp_async_commit();
      if (a.ssq_in != nullptr && a.ssq_tiles % 16 == 0 &&
          a.ssq_tiles <= 4 * GW_SSQ_PER_THREAD && a.ssq_stride % 4 == 0 &&
          reinterpret_cast<uintptr_t>(a.ssq_in) % 16 == 0) {
        // RMSNorm factor of each row from the parts of its sum of squares
        // the GEMV that wrote it left, added in tile order: 4 threads a
        // row, thread j loading parts [j P, (j + 1) P) at once in 16-byte
        // loads (every block reads the same parts: one request a line
        // and instruction), the running sum handed from thread j to j + 1
        const int r = tid >> 2, j = tid & 3, P = a.ssq_tiles / 4;
        float part[GW_SSQ_PER_THREAD];
#pragma unroll
        for (int i = 0; i < GW_SSQ_PER_THREAD; i += 4) {
          const float4 v =
              r < a.rows && i < P
                  ? __ldcg(reinterpret_cast<const float4*>(
                        a.ssq_in + (size_t)r * a.ssq_stride + j * P + i))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          part[i] = v.x;
          part[i + 1] = v.y;
          part[i + 2] = v.z;
          part[i + 3] = v.w;
        }
        float run = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (j == jj) {
#pragma unroll
            for (int i = 0; i < GW_SSQ_PER_THREAD; ++i) run += part[i];
          }
          run = __shfl_sync(0xffffffffu, run, (lane & ~3) | jj);
        }
        if (j == 0 && r < a.rows) rnorm[r] = 1.f / sqrtf(run / a.K + a.eps);
      } else if (a.ssq_in != nullptr) {
        for (int r = tid; r < a.rows; r += GW_CONSUMERS) {
          const float* q = a.ssq_in + (size_t)r * a.ssq_stride;
          float ss = 0.f;
#pragma unroll 8
          for (int t = 0; t < a.ssq_tiles; ++t) ss += __ldcg(q + t);
          rnorm[r] = 1.f / sqrtf(ss / a.K + a.eps);
        }
      } else {
        // from the row itself (one warp per row)
        for (int r = warp; r < a.rows; r += GW_CONSUMERS / 32) {
          const bf16* xr = a.x + (size_t)r * a.K;
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
      }
      cp_async_wait<0>();
    }
    // the ring's barriers are initialized; rnorm and nws are complete
    asm volatile("bar.sync 2, %0;\n" ::"n"(GW_THREADS) : "memory");

    for (int st = 0; st < nst; ++st) {
      const int slot = st % S;
      unsigned char* stage = ring + slot * STAGE;
      gw_bar_wait(full + slot, (st / S) & 1);
      if (normed) {
        // this stage's x, normed and rounded to bf16 as the mma.sync GEMV
        // rounds it, in place: 16-byte chunk c of row n at c ^ (n & 7)
        for (int i = tid; i < a.rows * 8; i += GW_CONSUMERS) {
          const int n = i >> 3, c = i & 7;
          uint4* p = reinterpret_cast<uint4*>(stage + XOFF + n * 128 +
                                              ((c ^ (n & 7)) << 4));
          float v[8], w[8];
          lds8(reinterpret_cast<const bf16*>(p), v);
          lds8(nws + st * GW_KS + 8 * c, w);
          uint4 u;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            h[jj] = __floats2bfloat162_rn(
                v[2 * jj] * rnorm[n] * w[2 * jj],
                v[2 * jj + 1] * rnorm[n] * w[2 * jj + 1]);
          }
          *p = u;
        }
        // visible to the tensor cores (the async proxy), every part
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(GW_CONSUMERS) : "memory");
      }
      const uint64_t db = gw_desc(stage + XOFF);
      const uint64_t da = gw_desc(stage);
#pragma unroll
      for (int src = 0; src < NSRC; ++src) gw_fence_acc<NACC>(acc[src]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < GW_KS / 16; ++kk) {
        // K step kk: 16 rows (2048 bytes) into the weight tile, 32 bytes
        // into x's rows
#pragma unroll
        for (int src = 0; src < NSRC; ++src) {
          gw_wgmma<NB8>(acc[src], da + src * (GW_W_BYTES >> 4) + 128 * kk,
                        db + 2 * kk);
        }
      }
      // the stage's products complete before its slot goes back to the
      // producer, so that all a.stages stages are in flight (they take
      // far less than a stage's bytes take to arrive)
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int src = 0; src < NSRC; ++src) gw_fence_acc<NACC>(acc[src]);
      __syncwarp();
      if (lane == 0) gw_bar_arrive(empty + slot);
    }
  }

  // the partials into their owners' slots
  gw_cluster_wait();
  if (tid < GW_CONSUMERS) {
    const unsigned base = gm_smem_u32(red);
#pragma unroll
    for (int j = 0; j < NB8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 8 * j + 2 * (lane & 3) + c;
        if (n >= a.rows) continue;
        const int owner = n / rp, lr = n - owner * rp;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = 16 * warp + (lane >> 2) + 8 * i;
#pragma unroll
          for (int src = 0; src < NSRC; ++src) {
            const unsigned off =
                4u * (((rank * NSRC + src) * rp + lr) * GW_RPITCH + m);
            gw_st_remote(gw_remote(base + off, owner),
                         acc[src][4 * j + 2 * i + c]);
          }
        }
      }
  }
  gw_cluster_arrive();
  gw_cluster_wait();

  // the owner's rows: the slots in rank order, then the epilogue
  if (tid >= GW_CONSUMERS) return;
  const bool ssq = EPI == EPI_RESIDUAL && a.ssq_out != nullptr;
  for (int lr0 = 0; lr0 < rp; lr0 += GW_CONSUMERS / TPR) {
    const int lr = lr0 + tid / TPR, n = rank * rp + lr;
    const int m0 = 4 * (tid % TPR), nl0 = sg.c0 + m0;
    const bool live = lr < rp && n < a.rows && nl0 < sg.nl;  // sg.nl % 4 == 0
    float sq = 0.f;
    if (live) {
      // the residual's 4 values first: res may alias out
      float res[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (EPI == EPI_RESIDUAL) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            a.res + (size_t)n * sg.nl + nl0);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 f0 = __bfloat1622float2(h[0]);
        const float2 f1 = __bfloat1622float2(h[1]);
        res[0] = f0.x; res[1] = f0.y; res[2] = f1.x; res[3] = f1.y;
      }
      float4 tot[NSRC];
#pragma unroll
      for (int src = 0; src < NSRC; ++src) {
        tot[src] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int r = 0; r < cs; ++r) {
#pragma unroll
        for (int src = 0; src < NSRC; ++src) {
          const float4 v = *reinterpret_cast<const float4*>(
              red + ((r * NSRC + src) * rp + lr) * GW_RPITCH + m0);
          tot[src].x += v.x;
          tot[src].y += v.y;
          tot[src].z += v.z;
          tot[src].w += v.w;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t[NSRC];
#pragma unroll
        for (int src = 0; src < NSRC; ++src) {
          const float4& v = tot[src];
          t[src] = c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
        }
        sq += gemv_output<bf16, EPI, W_FLOAT, NSRC>(a, sg, n, nl0 + c, t,
                                                    res + c);
      }
    }
    if (ssq) {  // the row's 16 threads, in a fixed order
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) {
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      if (tid % TPR == 0 && lr < rp && n < a.rows) {
        a.ssq_out[(size_t)n * a.ssq_stride + tile] = sq;
      }
    }
  }
}

// ---- launches ----------------------------------------------------------

// column tiles of a launch (each segment's columns start a new tile)
template <typename T>
int gemv_tiles(const GemvArgs<T>& a) {
  int t = 0;
  for (int s = 0; s < a.nseg; ++s) t += (a.nl[s] + GEMV_TN - 1) / GEMV_TN;
  return t;
}

template <int EPI, int WK, int NSRC, int RB>
cudaError_t launch_gemv_rb(const GemvArgs<float>& a, cudaStream_t stream) {
  const dim3 grid(gemv_tiles(a), (a.K + GEMV_KC - 1) / GEMV_KC);
  return launch_pdl(gemv_kernel<EPI, WK, NSRC, RB>, grid,
                       dim3(GEMV_TX, GEMV_TY), 0, stream, a);
}

// bytes of a weight per loaded column and K row, over all sources
template <int WK, int NSRC>
constexpr int gemv_wbytes() {
  return (WK == W_FLOAT ? 2 : 1) * NSRC;
}

template <int WK>
int gemv_granule(int gsize) {
  return WK == W_INT4G && gsize > GM_KS ? gsize : GM_KS;
}

// Staged rows of the tensor-core GEMV for a launch of `rows` rows, in 8s
static int gemv_nb8(int rows) { return rows <= 8 ? 1 : rows <= 16 ? 2 : 4; }

// internal linkage: the launcher's static must not be one process-wide
// symbol shared with another build of this library loaded beside it
namespace {
template <int EPI, int WK, int NSRC, int NB8>
cudaError_t launch_gemv_mma(GemvArgs<bf16> a, cudaStream_t stream) {
  constexpr int NV = is_int4(WK) ? 2 : 1;
  constexpr int STAGE =
      NSRC * gm_stage_bytes<WK>() + (WK == W_INT4G ? 2 * 2 * GM_TN * 4 : 0);
  static int ready = 0;
  const int tiles = gemv_tiles(a);
  a.kb = gm_split_rows(a.K, tiles, a.rows, NSRC * NV, gemv_wbytes<WK, NSRC>(),
                       gemv_granule<WK>(a.gsize), NB8);
  const size_t smem =
      GM_STAGES * STAGE + ((size_t)8 * NB8 * (a.kb + GM_XPAD) +
                           (a.norm_w != nullptr ? a.kb : 0)) * sizeof(bf16);
  cudaError_t err = allow_smem(gemv_mma_kernel<EPI, WK, NSRC, NB8>,
                               GEMV_SMEM_MAX, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (a.K + a.kb - 1) / a.kb);
  return launch_pdl(gemv_mma_kernel<EPI, WK, NSRC, NB8>, grid,
                       dim3(GM_THREADS), smem, stream, a);
}

// The wgmma GEMV of a launch: gw_plan's cluster along K, the weight maps
// encoded here (for a captured step: at capture), launched as clusters
// with programmatic dependent launch.
template <int EPI, int NB8>
cudaError_t launch_gemv_wgmma(GemvArgs<bf16> a, const GwPlan& p,
                              cudaStream_t stream) {
  static int ready = 0;
  GwMaps maps;
  for (int s = 0; s < a.nseg; ++s) {
    if (!gw_map(&maps.w[s], a.w0[s], a.K, a.nl[s], a.ld[s], GW_KS, GW_TN)) {
      return cudaErrorNotSupported;
    }
  }
  if ((EPI == EPI_SWIGLU &&
       !gw_map(&maps.up, a.w1, a.K, a.nl[0], a.ld[0], GW_KS, GW_TN)) ||
      !gw_map(&maps.x, a.x, a.rows, a.K, a.K, 8 * NB8, GW_KS)) {
    return cudaErrorNotSupported;
  }
  a.kb = p.kr;
  a.stages = p.stages;
  cudaError_t err =
      allow_smem(gemv_wgmma_kernel<EPI, NB8>, GW_SMEM_MAX, &ready);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gemv_tiles(a) * p.cs);
  cfg.blockDim = dim3(GW_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, gemv_wgmma_kernel<EPI, NB8>, maps, a);
}
}  // namespace

// Which tensor-core GEMV a bf16-activation launch of `rows` rows (<= 32)
// takes: the wgmma GEMV for bf16 weights where its plan fits a block's
// shared memory, else the mma.sync GEMV (every quantized weight kind). A
// fixed rule on the shapes: at the 1.7B decoder's four GEMVs the wgmma
// GEMV is the faster at 1, 8, 16 and 32 rows alike (chip_smoke, PERF.md).
// ops/kernels/decode_layer.py::gemv_route mirrors it.
static bool gw_route(int wk, int rows, int K, int tiles, int nsrc) {
  return wk == W_FLOAT &&
         gw_plan(K, tiles, nsrc, gemv_nb8(rows)).smem <= GW_SMEM_MAX;
}

extern "C" int gemv_route(int wk, int rows, int K, int tiles, int nsrc) {
  return gw_route(wk, rows, K, tiles, nsrc) ? 1 : 0;
}

// routes of launch_gemv: the rule, or (the card checks) one forced
enum GemvRoute { ROUTE_RULE = -1, ROUTE_MMA = 0, ROUTE_WGMMA = 1 };

// One launch per GEMV_MAX_ROWS rows: T = float with the largest row group
// its rows and accumulators allow, T = bf16 with 8, 16 or 32 staged rows
// on the route gw_route picks (or `route` forces); wgmma_launches (a host
// int, or null) counts the launches of the wgmma GEMV.
template <typename T, int EPI, int WK, int NSRC>
cudaError_t launch_gemv(const GemvArgs<T>& a, int rows, cudaStream_t stream,
                        int* wgmma_launches = nullptr,
                        int route = ROUTE_RULE) {
  constexpr int NV = is_int4(WK) ? 2 : 1;
  constexpr int NOUT = EPI == EPI_SWIGLU ? (NSRC == 1 ? 1 : NV) : NV;
  int ntot = 0;  // output columns per row
  for (int s = 0; s < a.nseg; ++s) ntot += a.nl[s] * NOUT;
  for (int r0 = 0; r0 < rows; r0 += GEMV_MAX_ROWS) {
    GemvArgs<T> g = a;
    g.ntot = ntot;
    g.rows = min(GEMV_MAX_ROWS, rows - r0);
    g.x = a.x + (size_t)r0 * a.K;
    if (EPI == EPI_STORE) {
      g.out = a.out + (size_t)r0 * a.split1;
      if (a.out1 != nullptr) g.out1 = a.out1 + (size_t)r0 * (a.split2 - a.split1);
      if (a.out2 != nullptr) g.out2 = a.out2 + (size_t)r0 * (ntot - a.split2);
    } else if (EPI == EPI_ARGMAX) {
      g.best = a.best + r0;
    } else {
      g.out = a.out + (size_t)r0 * ntot;
      if (a.res != nullptr) g.res = a.res + (size_t)r0 * ntot;
    }
    if (a.ssq_out != nullptr) g.ssq_out = a.ssq_out + (size_t)r0 * a.ssq_stride;
    if (a.ssq_in != nullptr) g.ssq_in = a.ssq_in + (size_t)r0 * a.ssq_stride;
    cudaError_t err;
    if constexpr (std::is_same<T, float>::value) {
      static_assert(EPI != EPI_ARGMAX, "float32: the fold kernels");
      constexpr int RB_MAX = GEMV_MAX_ACC / (NSRC * NV);
      constexpr int RB4 = RB_MAX < 4 ? RB_MAX : 4;
      // int4g takes 2 rows as a group of 4: its 2-row build spilled
      constexpr int RB2 = WK == W_INT4G ? RB4 : 2;
      if (g.rows == 1) {
        err = launch_gemv_rb<EPI, WK, NSRC, 1>(g, stream);
      } else if (g.rows == 2) {
        err = launch_gemv_rb<EPI, WK, NSRC, RB2>(g, stream);
      } else if (g.rows <= 4) {
        err = launch_gemv_rb<EPI, WK, NSRC, RB4>(g, stream);
      } else {
        err = launch_gemv_rb<EPI, WK, NSRC, RB_MAX>(g, stream);
      }
    } else {
      constexpr bool kWgmma = WK == W_FLOAT && EPI != EPI_ARGMAX &&
                              NSRC == (EPI == EPI_SWIGLU ? 2 : 1);
      const int nb8 = gemv_nb8(g.rows);
      const GwPlan plan = gw_plan(g.K, gemv_tiles(g), NSRC, nb8);
      const bool wgmma =
          route == ROUTE_RULE
              ? gw_route(WK, g.rows, g.K, gemv_tiles(g), NSRC)
              : route == ROUTE_WGMMA;
      if (wgmma && !(kWgmma && plan.smem <= GW_SMEM_MAX)) {
        return cudaErrorInvalidValue;
      }
      if constexpr (kWgmma) {
        if (wgmma) {
          switch (nb8) {
            case 1: err = launch_gemv_wgmma<EPI, 1>(g, plan, stream); break;
            case 2: err = launch_gemv_wgmma<EPI, 2>(g, plan, stream); break;
            default: err = launch_gemv_wgmma<EPI, 4>(g, plan, stream);
          }
          if (err != cudaSuccess) return err;
          if (wgmma_launches != nullptr) ++*wgmma_launches;
          continue;
        }
      }
      switch (nb8) {
        case 1: err = launch_gemv_mma<EPI, WK, NSRC, 1>(g, stream); break;
        case 2: err = launch_gemv_mma<EPI, WK, NSRC, 2>(g, stream); break;
        default: err = launch_gemv_mma<EPI, WK, NSRC, 4>(g, stream);
      }
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Split-K partials (float32 words) of one GEMV of k rows over loaded
// columns `nl` (per segment): the most that any launch of up to `rows`
// rows takes, as it will split K (T = float: 128-row slices; T = bf16:
// gm_split_rows).
static long long gemv_ws_words(int rows, int K, const int* nl, int nseg,
                               int nacc, int wbytes, int granule) {
  int tiles = 0;
  long long cols = 0;
  for (int s = 0; s < nseg; ++s) {
    tiles += (nl[s] + GEMV_TN - 1) / GEMV_TN;
    cols += nl[s];
  }
  long long most = (long long)rows * ((K + GEMV_KC - 1) / GEMV_KC);
  for (int r = 1; r <= rows; ++r) {
    const int kb = gm_split_rows(K, tiles, r, nacc, wbytes, granule,
                                 gemv_nb8(r));
    const long long words = (long long)r * ((K + kb - 1) / kb);
    if (words > most) most = words;
  }
  return most * nacc * cols;
}

// Per-head RMSNorm (q_norm / k_norm) then rotate-half rotary, one block of
// D threads per (head, row b): blocks x in [0, Hq) rotate q (B, Hq, D) in
// place, blocks x in [Hq, Hq + Hkv) read k_in (B, Hkv, D) and write the
// layer's fresh-K output; cos/sin are (B, D). Launched with programmatic
// dependent launch after the q|k|v GEMV.
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
  pdl_launch_dependents();
  pdl_wait();
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

// float32 with an int8 (H, V) lm_head and per-column scales (the parity
// path; bf16 runs the tensor-core GEMV with EPI_ARGMAX): the block's
// FOLD_COLS columns, lane l holding columns 4l..4l+3, the warps splitting
// H (k = warp, warp + 8, ...); the warps' partials are added in order,
// scaled, and warp r reduces row r's keys.
__global__ void __launch_bounds__(FOLD_THREADS)
lm_fold_int8_kernel(const float* __restrict__ h,
                    const float* __restrict__ norm_w, float eps,
                    const int8_t* __restrict__ W,
                    const float* __restrict__ scales, int rows, int H, int V,
                    unsigned long long* __restrict__ best) {
  extern __shared__ __align__(16) float fold_xs[];  // rows x H, then red
  float* red = fold_xs + (size_t)FOLD_ROWS * H;     // [warp][row][col]
  fold_prologue<float>(h, norm_w, eps, rows, H, fold_xs);
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

// The folded lm_head for B rows of h, then the token ids. An int8 lm_head
// with T = bf16 is one tensor-core GEMV (ws, counters: the step's split-K
// scratch) per 32 rows; the other cases launch the fold kernels above per
// FOLD_ROWS rows.
template <typename T>
cudaError_t launch_lm_fold(const T* h, const T* norm_w, float eps,
                           const void* lm_w, const float* lm_s, int fold,
                           int B, int H, int V, unsigned long long* best,
                           int* tok, float* ws, int* counters,
                           const float* ssq, int ssq_stride, int ssq_tiles,
                           cudaStream_t stream) {
  cudaError_t err;
  bool gemv = false;
  if constexpr (std::is_same<T, bf16>::value) gemv = fold == FOLD_INT8;
  if (gemv) {
    GemvArgs<T> g{};
    g.x = h;
    g.norm_w = norm_w;
    g.eps = eps;
    g.nseg = 1;
    g.w0[0] = lm_w;
    g.s0[0] = lm_s;
    g.nl[0] = g.ld[0] = V;
    g.K = H;
    g.best = best;
    g.ws = ws;
    g.counters = counters;
    g.ssq_in = ssq;
    g.ssq_stride = ssq_stride;
    g.ssq_tiles = ssq_tiles;
    if constexpr (std::is_same<T, bf16>::value) {
      if ((err = launch_gemv<T, EPI_ARGMAX, W_INT8, 1>(g, B, stream)) != cudaSuccess) return err;
    }
  } else {
    for (int r0 = 0; r0 < B; r0 += FOLD_ROWS) {
      const int rows = min(FOLD_ROWS, B - r0);
      const T* hr = h + (size_t)r0 * H;
      if constexpr (std::is_same<T, float>::value) {
        if (fold == FOLD_INT8) {
          const size_t smem = sizeof(float) * ((size_t)FOLD_ROWS * H +
                                               FOLD_WARPS * FOLD_ROWS * FOLD_COLS);
          err = cudaFuncSetAttribute(lm_fold_int8_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
          if (err != cudaSuccess) return err;
          lm_fold_int8_kernel<<<(V + FOLD_COLS - 1) / FOLD_COLS, FOLD_THREADS,
                                smem, stream>>>(
              hr, norm_w, eps, static_cast<const int8_t*>(lm_w), lm_s, rows, H,
              V, best + r0);
          if ((err = cudaGetLastError()) != cudaSuccess) return err;
          continue;
        }
      }
      const size_t smem = sizeof(float) * (size_t)FOLD_ROWS * H;
      err = cudaFuncSetAttribute(lm_fold_rows_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      lm_fold_rows_kernel<T><<<(V + FOLD_VROWS - 1) / FOLD_VROWS,
                               FOLD_THREADS, smem, stream>>>(
          hr, norm_w, eps, static_cast<const T*>(lm_w), rows, H, V,
          best + r0);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  fold_finish_kernel<<<(B + 127) / 128, 128, 0, stream>>>(best, tok, B);
  return cudaGetLastError();
}

// float32 words of the GEMV split-K partials of one step (up to
// GEMV_MAX_ROWS rows at a time, every weight kind and layout, and the
// folded int8 lm_head over V columns), rounded up to a 16-byte boundary:
// the attention workspace follows them.
static long long gemv_workspace_words(int B, int H, int Hq, int Hkv, int D,
                                      int I, int gsize, int V) {
  const int rows = B < GEMV_MAX_ROWS ? B : GEMV_MAX_ROWS;
  const int qd = Hq * D, kvd = Hkv * D;
  long long g = 0;
  auto take = [&](long long w) { g = w > g ? w : g; };
  for (int wk = W_FLOAT; wk <= W_INT4G; ++wk) {
    const int pack = is_int4(wk) ? 2 : 1, nv = pack;
    const int esize = wk == W_FLOAT ? 2 : 1;
    const int granule = wk == W_INT4G && gsize > GM_KS ? gsize : GM_KS;
    const int merged_qkv[1] = {(qd + 2 * kvd) / pack};
    const int qkv3[3] = {qd / pack, kvd / pack, kvd / pack};
    const int o[1] = {H / pack}, gu[1] = {I / pack}, gu1[1] = {I};
    take(gemv_ws_words(rows, H, merged_qkv, 1, nv, esize, granule));
    take(gemv_ws_words(rows, H, qkv3, 3, nv, esize, granule));
    take(gemv_ws_words(rows, qd, o, 1, nv, esize, granule));
    take(gemv_ws_words(rows, I, o, 1, nv, esize, granule));
    // gate|up: two sources (per projection, or bf16/int8 merged), or one
    // int4 source whose nibbles are gate and up
    take(gemv_ws_words(rows, H, gu, 1, 2 * nv, 2 * esize, granule));
    if (is_int4(wk)) take(gemv_ws_words(rows, H, gu1, 1, 2, 1, granule));
  }
  if (V > 0) {
    const int lm[1] = {V};
    take(gemv_ws_words(rows, H, lm, 1, 1, 1, GM_KS));
  }
  return (g + 3) & ~3LL;
}

// The rows' sums of squares in parts (GemvArgs::ssq_*): B rows of one
// float per column tile of an H-wide GEMV
static int ssq_stride(int H) { return (H + GEMV_TN - 1) / GEMV_TN; }
static long long ssq_words(int B, int H) { return (long long)B * ssq_stride(H); }

// Scratch sizes for one step of B rows: sizes[0] 4-byte words of
// workspace (GEMV partials of up to GEMV_MAX_ROWS rows, then K2's
// partials and counters, which must be zero before the first step: the
// kernels leave them zero, then the rows' sums of squares in parts),
// sizes[1] int32 GEMV counters (zero likewise),
// sizes[2] T elements. Enough for every weight kind and layout at group
// size gsize (int4g) and, with V > 0, the folded lm_head.
extern "C" void decode_layers_fused_scratch(int B, int H, int Hq, int Hkv,
                                            int D, int I, int S, int gsize,
                                            int V, long long* sizes) {
  const long long qkv = (long long)Hq * D + 2LL * Hkv * D;
  long long n_max = qkv > I ? qkv : I;
  n_max = n_max > H ? n_max : H;
  n_max = n_max > V ? n_max : V;
  sizes[0] = gemv_workspace_words(B, H, Hq, Hkv, D, I, gsize, V) +
             attn_workspace_words(B, Hq, Hkv, S, D) + ssq_words(B, H);
  sizes[1] = (n_max + GEMV_TN - 1) / GEMV_TN + 3;  // + segment ends
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

// One segment of a GEMV: weight, scales, loaded columns (= row stride)
template <typename T>
void gemv_one(GemvArgs<T>& g, const void* w, const float* s, int nl,
              int ld) {
  g.nseg = 1;
  g.w0[0] = w;
  g.s0[0] = s;
  g.nl[0] = nl;
  g.ld[0] = ld;
}

// launches is two host ints: launches[0] is incremented once each time
// launch_decode_attention has enqueued K2's kernel (one launch, the merge
// inside it) without error, launches[1] once for each launch of the wgmma
// GEMV, so the caller counts both where they are made.
template <typename T, int WK>
cudaError_t decode_layers_fused(const void* const* p, int merged,
                                int* launches, int L, int B, int H,
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
  float* attn_ws = ws + gemv_workspace_words(B, H, Hq, Hkv, D, I, gsize,
                                             fold != FOLD_NONE ? V : 0);
  // bf16: the residual GEMVs leave each row's sum of squares in parts for
  // the next RMSNorm (layer 0's input sums its own rows)
  float* ssq = std::is_same<T, bf16>::value
                   ? attn_ws + attn_workspace_words(B, Hq, Hkv, S, D)
                   : nullptr;
  const int ssq_tiles = (W::row(H) + GEMV_TN - 1) / GEMV_TN;
  const float scale = 1.f / sqrtf((float)D);
  cudaError_t err;
  for (int l = 0; l < L; ++l) {
    T* k_l = ks + (size_t)l * B * kvd;  // (B, Hkv, D) of layer l
    T* v_l = vs + (size_t)l * B * kvd;
    // layer 0 reads the step's input; its o-projection writes h
    const T* h_in = l == 0 ? x : h;
    GemvArgs<T> g{};
    g.ws = ws;
    g.counters = counters;
    g.eps = eps;
    g.gsize = gsize;
    g.ssq_stride = ssq_stride(H);
    g.ssq_tiles = ssq_tiles;
    // q, k, v = RMSNorm(h) @ W, one launch: output columns [0, qd) are
    // q, then k, then v, from one merged weight or three segments
    g.x = h_in;
    g.norm_w = in_ln + (size_t)l * H;
    g.ssq_in = l == 0 ? nullptr : ssq;
    g.K = H;
    g.out = qbuf; g.out1 = kbuf; g.out2 = v_l;
    g.split1 = qd; g.split2 = qd + kvd;
    if (merged) {
      gemv_one(g, W::w(p[P_W_Q], l, H, qkvd), W::s(p[P_S_Q], l, H, qkvd, gsize),
               W::row(qkvd), W::row(qkvd));
    } else {
      const int widths[3] = {qd, kvd, kvd};
      g.nseg = 3;
      for (int j = 0; j < 3; ++j) {
        g.w0[j] = W::w(p[P_W_Q + j], l, H, widths[j]);
        g.s0[j] = W::s(p[P_S_Q + j], l, H, widths[j], gsize);
        g.nl[j] = g.ld[j] = W::row(widths[j]);
      }
    }
    if ((err = launch_gemv<T, EPI_STORE, WK, 1>(g, B, stream, launches + 1)) != cudaSuccess) return err;
    // QK-RMSNorm + rotary; k lands in the fresh-K output
    err = launch_pdl(qk_norm_rope_kernel<T>, dim3(Hq + Hkv, B), dim3(D), 0,
                        stream, qbuf, (const T*)kbuf, k_l,
                        q_norm + (size_t)l * D, k_norm + (size_t)l * D, cos,
                        sin, Hq, Hkv, eps);
    if (err != cudaSuccess) return err;
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
    ++launches[0];
    // h = h + attn @ o_w
    g = GemvArgs<T>{};
    g.ws = ws; g.counters = counters; g.eps = eps; g.gsize = gsize;
    g.ssq_stride = ssq_stride(H); g.ssq_tiles = ssq_tiles; g.ssq_out = ssq;
    g.x = attn; g.K = qd;
    gemv_one(g, W::w(p[P_W_O], l, qd, H), W::s(p[P_S_O], l, qd, H, gsize),
             W::row(H), W::row(H));
    g.res = h_in; g.out = h;
    if ((err = launch_gemv<T, EPI_RESIDUAL, WK, 1>(g, B, stream, launches + 1)) != cudaSuccess) return err;
    // act = silu(RMSNorm(h) @ gate_w) * (RMSNorm(h) @ up_w)
    g.x = h; g.norm_w = post_ln + (size_t)l * H; g.K = H; g.out = act;
    g.res = nullptr; g.ssq_out = nullptr; g.ssq_in = ssq;
    if (merged) {
      const float* s = W::s(p[P_S_GATE], l, H, 2 * I, gsize);
      if constexpr (is_int4(WK)) {
        // packed column j: gate j (low nibble), up j (high nibble)
        gemv_one(g, W::w(p[P_W_GATE], l, H, 2 * I), s, I, I);
        g.s1 = s == nullptr ? nullptr : s + I;
        err = launch_gemv<T, EPI_SWIGLU, WK, 1>(g, B, stream, launches + 1);
      } else {
        // gate j and up j are columns j and I + j of one row
        const void* w = W::w(p[P_W_GATE], l, H, 2 * I);
        gemv_one(g, w, s, I, 2 * I);
        g.w1 = static_cast<const char*>(w) + (size_t)I * W::esize();
        g.s1 = s == nullptr ? nullptr : s + I;
        err = launch_gemv<T, EPI_SWIGLU, WK, 2>(g, B, stream, launches + 1);
      }
    } else if constexpr (WK == W_INT4G) {
      err = cudaErrorInvalidValue;  // int4g: merged only
    } else {
      gemv_one(g, W::w(p[P_W_GATE], l, H, I), W::s(p[P_S_GATE], l, H, I, gsize),
               W::row(I), W::row(I));
      g.w1 = W::w(p[P_W_UP], l, H, I);
      g.s1 = W::s(p[P_S_UP], l, H, I, gsize);
      err = launch_gemv<T, EPI_SWIGLU, WK, 2>(g, B, stream, launches + 1);
    }
    if (err != cudaSuccess) return err;
    // h = h + act @ down_w
    g.x = act; g.norm_w = nullptr; g.K = I; g.ssq_in = nullptr; g.ssq_out = ssq;
    gemv_one(g, W::w(p[P_W_DOWN], l, I, H), W::s(p[P_S_DOWN], l, I, H, gsize),
             W::row(H), W::row(H));
    g.w1 = nullptr; g.s1 = nullptr;
    g.res = h; g.out = h;
    if ((err = launch_gemv<T, EPI_RESIDUAL, WK, 1>(g, B, stream, launches + 1)) != cudaSuccess) return err;
  }
  if (fold != FOLD_NONE) {
    err = launch_lm_fold<T>(
        h, static_cast<const T*>(p[P_FINAL_LN]), eps, p[P_LM_W],
        static_cast<const float*>(p[P_LM_S]), fold, B, H, V,
        static_cast<unsigned long long*>(const_cast<void*>(p[P_BEST])),
        static_cast<int*>(const_cast<void*>(p[P_TOK])), ws, counters, ssq,
        ssq_stride(H), ssq_tiles, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Loaded columns that a weight kind's GEMV takes: whole 16-byte copies.
static bool gemv_width_ok(int wkind, int n) {
  const int align = wkind == W_FLOAT ? 8 : is_int4(wkind) ? 32 : 16;
  return n > 0 && n % align == 0;
}

// wkind: 0 T weights, 1 int8, 2 int4, 3 int4g (WeightKind; int4g merged
// only, with gsize rows per group); fold: FoldKind, over V vocab columns.
// Shapes the kernels cannot take are refused before anything is launched.
template <typename T>
int decode_layers_fused_entry(const void* const* p, int wkind, int merged,
                              int* launches, int L, int B, int H,
                              int Hq, int Hkv, int D, int I, int S, int gsize,
                              int fold, int V, float eps, void* stream) {
  if (B < 1 || D > 256 || D % 32 != 0 || !gemv_width_ok(wkind, H) ||
      !gemv_width_ok(wkind, I) || !gemv_width_ok(wkind, Hq * D) ||
      !gemv_width_ok(wkind, Hkv * D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (wkind == W_INT4G &&
      (!merged || !(gsize == 32 || gsize == 64 || (gsize > 0 && gsize % 128 == 0)) ||
       H % gsize != 0 || I % gsize != 0 || (Hq * D) % gsize != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fold < FOLD_NONE || fold > FOLD_INT8 ||
      (fold != FOLD_NONE && (V < 1 || (fold == FOLD_INT8 && V % 16 != 0)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_LAYERS_CASE(WK)                                               \
  case WK:                                                                   \
    return static_cast<int>(decode_layers_fused<T, WK>(                      \
        p, merged, launches, L, B, H, Hq, Hkv, D, I, S, gsize, fold, V,      \
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
                      int* launches, int L, int B, int H, int Hq,            \
                      int Hkv, int D, int I, int S, int gsize, int fold,     \
                      int V, float eps, void* stream) {                      \
    return decode_layers_fused_entry<T>(p, wkind, merged, launches, L,       \
                                        B, H, Hq, Hkv, D, I, S, gsize, fold, \
                                        V, eps, stream);                     \
  }

DECODE_LAYERS_ENTRY(decode_layers_fused_bf16, bf16)
DECODE_LAYERS_ENTRY(decode_layers_fused_f32, float)

// ---- one GEMV alone, for the card checks -------------------------------

// The bf16 tensor-core GEMV of one projection with its prologue and
// epilogue, as K1 launches it: p = {x (rows, K), norm_w (K,) or null, w0,
// w1 or null, s0, s1, res, out, ws, counters, ssq_in, ssq_out, the
// second and third STORE segments' weights or null}; wkind a WeightKind,
// epi an Epilogue (STORE, RESIDUAL or SWIGLU), nsrc the sources (2:
// SWIGLU with separate gate and up weights of nl loaded columns and row
// stride ld). STORE with bf16 weights may take up to three column
// segments, as the step's q|k|v: nls[s] loaded columns each (nls[0] = nl;
// row stride ld, then nls[s]), their outputs side by side in out. ws:
// gemv_single_ws_words floats; counters: zero, left zero; ssq_in: null,
// or (rows, ssq_stride) parts of each row's sum of squares, ssq_tiles of
// them, for the RMSNorm; ssq_out: null, or RESIDUAL's (rows, ssq_stride)
// parts, one per column tile. route: a GemvRoute (the rule, or one
// forced); launches[0] counts the wgmma GEMV's launches.
extern "C" long long gemv_single_ws_words(int rows, int K, int nl) {
  return (long long)rows * 4 * ((K + GM_KS - 1) / GM_KS) * nl;
}

extern "C" int gemv_single_bf16(const void* const* p, int wkind, int epi,
                                int nsrc, int rows, int K, const int* nls,
                                int nseg, int ld, int gsize, int ssq_stride,
                                int ssq_tiles, float eps, int route,
                                int* launches, void* stream) {
  const int nl = nls[0];
  if (rows < 1 || K % 8 != 0 || nseg < 1 || nseg > 3 ||
      (nseg > 1 && (epi != EPI_STORE || wkind != W_FLOAT)) ||
      !gemv_width_ok(wkind, is_int4(wkind) ? 2 * nl : nl) ||
      (wkind == W_INT4G && (gsize < 32 || K % gsize != 0 ||
                            !(gsize == 32 || gsize == 64 || gsize % 128 == 0)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GemvArgs<bf16> g{};
  g.x = static_cast<const bf16*>(p[0]);
  g.norm_w = static_cast<const bf16*>(p[1]);
  g.eps = eps;
  gemv_one(g, p[2], static_cast<const float*>(p[4]), nl, ld);
  int ntot = nl;
  for (int s = 1; s < nseg; ++s) {
    if (!gemv_width_ok(wkind, nls[s])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.w0[s] = p[11 + s];
    g.nl[s] = g.ld[s] = nls[s];
    ntot += nls[s];
  }
  g.nseg = nseg;
  g.w1 = p[3];
  g.s1 = static_cast<const float*>(p[5]);
  g.gsize = gsize;
  g.res = static_cast<const bf16*>(p[6]);
  g.out = static_cast<bf16*>(const_cast<void*>(p[7]));
  g.ws = static_cast<float*>(const_cast<void*>(p[8]));
  g.counters = static_cast<int*>(const_cast<void*>(p[9]));
  g.ssq_in = static_cast<const float*>(p[10]);
  g.ssq_out = static_cast<float*>(const_cast<void*>(p[11]));
  g.ssq_stride = ssq_stride;
  g.ssq_tiles = ssq_tiles;
  g.K = K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define GEMV_SINGLE(E, WK, NSRC)                                        \
  if (epi == E && wkind == WK && nsrc == NSRC) {                        \
    g.split1 = g.split2 = ntot * (is_int4(WK) ? 2 : 1); /* STORE: out */ \
    err = launch_gemv<bf16, E, WK, NSRC>(g, rows, st, launches, route); \
  }
  GEMV_SINGLE(EPI_STORE, W_FLOAT, 1) GEMV_SINGLE(EPI_STORE, W_INT8, 1)
  GEMV_SINGLE(EPI_STORE, W_INT4, 1) GEMV_SINGLE(EPI_STORE, W_INT4G, 1)
  GEMV_SINGLE(EPI_RESIDUAL, W_FLOAT, 1) GEMV_SINGLE(EPI_RESIDUAL, W_INT8, 1)
  GEMV_SINGLE(EPI_RESIDUAL, W_INT4, 1) GEMV_SINGLE(EPI_RESIDUAL, W_INT4G, 1)
  GEMV_SINGLE(EPI_SWIGLU, W_FLOAT, 2) GEMV_SINGLE(EPI_SWIGLU, W_INT8, 2)
  GEMV_SINGLE(EPI_SWIGLU, W_INT4, 2) GEMV_SINGLE(EPI_SWIGLU, W_INT4, 1)
  GEMV_SINGLE(EPI_SWIGLU, W_INT4G, 1)
#undef GEMV_SINGLE
  return static_cast<int>(err);
}
