// One greedy decode step through all decoder layers for B rows (examples):
// the CUDA counterpart of the Pallas decode megakernel
// qwen3_asr_rs_tpu/ops/pallas/decode_layer.py::decode_layers_fused
// (its ffn_tiles=1, no-fold branches, with bf16/f32 activations,
// bf16/f32, int8 or int4 weights, merged or per projection, and slabs of
// T or int8 with per-slot scales).
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
// rounds to T.
//
// What bounds it on the H100: the weight stream. At 0.6B a layer holds
// 15.7 M parameters, 28 layers 0.88 GB per step in bf16 (0.26 ms at the
// data-sheet 3.35 TB/s), 0.44 GB in int8, 0.22 GB in int4, whatever B
// is: each GEMV block loads its weight tile (128 rows x 64 columns) into
// registers once and applies it to every row of the batch, RB rows at a
// time (RB * accumulators <= 8, so B = 32 does not spill), so B rows
// share one weight stream. This first version is a chain of simple
// kernels, launched by one C entry that loops over the layers on the host
// side: 9 launches per layer unmerged, 7 merged, each latency-bound
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
// per-column scales over the N unpacked columns.
enum WeightKind { W_FLOAT = 0, W_INT8 = 1, W_INT4 = 2 };

template <typename T>
struct GemvArgs {
  const T* x;        // (rows, K) input rows
  const T* norm_w;   // (K,) RMSNorm weight applied to each row first, or null
  float eps;
  // weights (K rows of stride ld elements; bytes for int8/int4) and their
  // per-output-column scales (null for T weights). The grid walks NL
  // loaded columns; an int4 byte column j gives outputs j and j + NL.
  const void* w0;
  const void* w1;    // EPI_SWIGLU with two sources: the "up" weight
  const float* s0;
  const float* s1;   // EPI_SWIGLU: the "up" scales
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
  constexpr int NV = WK == W_INT4 ? 2 : 1;  // values per loaded column
  constexpr int NACC = NSRC * NV;
  static_assert(RB * NACC <= GEMV_MAX_ACC, "accumulators per thread");
  static_assert(GEMV_MAX_ROWS % RB == 0, "row groups tile the rows");
  constexpr int XROWS = RB == 1 ? 1 : GEMV_MAX_ROWS;
  __shared__ float xs[XROWS][GEMV_KC];
  __shared__ float red[RB * NACC][GEMV_WARPS][GEMV_TN];
  __shared__ float rnorm[XROWS];
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
        const float gate = round_to<T>(scaled(tot[gi], a.s0, on));
        const float up = round_to<T>(scaled(tot[ui], a.s1, on));
        const float act = round_to<T>(gate * (1.f / (1.f + expf(-gate))));
        a.out[r * N + on] = from_f<T>(act * up);
      }
    } else {
      const size_t N = (size_t)a.NL * NV;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int on = nl + v * a.NL;
        const float y = round_to<T>(scaled(tot[v], a.s0, on));
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
  constexpr int NV = WK == W_INT4 ? 2 : 1;
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

// Scratch sizes for one step of B rows: sizes[0] float32 workspace (GEMV
// partials of up to GEMV_MAX_ROWS rows + attention partials), sizes[1]
// int32 counters, sizes[2] T elements. Enough for every weight kind and
// layout.
extern "C" void decode_layers_fused_scratch(int B, int H, int Hq, int Hkv,
                                            int D, int I, int S,
                                            long long* sizes) {
  auto splits = [](int K) { return (long long)(K + GEMV_KC - 1) / GEMV_KC; };
  const long long rows = B < GEMV_MAX_ROWS ? B : GEMV_MAX_ROWS;
  const long long qkv = (long long)Hq * D + 2LL * Hkv * D;
  long long g = splits(H) * qkv;                        // q|k|v
  g = g > splits(Hq * D) * H ? g : splits(Hq * D) * H;  // o
  g = g > 2 * splits(H) * I ? g : 2 * splits(H) * I;    // gate + up
  g = g > splits(I) * H ? g : splits(I) * H;            // down
  long long n_max = qkv > I ? qkv : I;
  n_max = n_max > H ? n_max : H;
  sizes[0] = rows * g + (long long)B * Hq * attn_num_splits(S) * (D + 2);
  sizes[1] = (n_max + GEMV_TN - 1) / GEMV_TN;
  sizes[2] = (long long)B * (2LL * Hq * D + (long long)Hkv * D + I);
}

// The step's pointer table (a host array of device pointers): activations,
// slabs and scratch, then the stacked (L, ...) weights and their scales,
// then the slab scales. Merged trees pass qkv_w in P_W_Q and gateup_w in
// P_W_GATE (and their scales likewise) and null for k, v and up; float
// weights pass null scales; slabs of T pass null slab scales.
enum StepPtr {
  P_X, P_COS, P_SIN, P_IN_LN, P_POST_LN, P_Q_NORM, P_K_NORM, P_K_SLABS,
  P_V_SLABS, P_START, P_END, P_H, P_KS, P_VS, P_WS, P_COUNTERS, P_TMP,
  P_W_Q, P_W_K, P_W_V, P_W_O, P_W_GATE, P_W_UP, P_W_DOWN,
  P_S_Q, P_S_K, P_S_V, P_S_O, P_S_GATE, P_S_UP, P_S_DOWN,
  P_K_SCALES, P_V_SCALES, P_COUNT
};

// Layer l's slice of a stacked (L, K, N) weight of kind WK (N unpacked
// output columns) and of its (L, N) scales.
template <typename T, int WK>
struct Stacked {
  static int row(int N) { return WK == W_INT4 ? N / 2 : N; }  // ld, NL
  static size_t esize() { return WK == W_FLOAT ? sizeof(T) : 1; }
  static const void* w(const void* base, int l, int K, int N) {
    return static_cast<const char*>(base) + (size_t)l * K * row(N) * esize();
  }
  static const float* s(const void* base, int l, int N) {
    return base == nullptr ? nullptr
                           : static_cast<const float*>(base) + (size_t)l * N;
  }
};

// attn_launches is a host int, incremented once each time
// launch_decode_attention has enqueued K2's kernels (split + merge)
// without error, so the caller counts K2's launches where they are made.
template <typename T, int WK>
cudaError_t decode_layers_fused(const void* const* p, int merged,
                                int* attn_launches, int L, int B, int H,
                                int Hq, int Hkv, int D, int I, int S,
                                float eps, cudaStream_t stream) {
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
  float* attn_ws = ws;
  {
    long long sz[3];
    decode_layers_fused_scratch(B, H, Hq, Hkv, D, I, S, sz);
    attn_ws = ws + (sz[0] - (long long)B * Hq * attn_num_splits(S) * (D + 2));
  }
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
    // q, k, v = RMSNorm(h) @ W
    g.x = h;
    g.norm_w = in_ln + (size_t)l * H;
    g.K = H;
    if (merged) {
      // one product; output columns [0, qd) are q, then k, then v
      g.w0 = W::w(p[P_W_Q], l, H, qkvd); g.s0 = W::s(p[P_S_Q], l, qkvd);
      g.NL = g.ld = W::row(qkvd);
      g.out = qbuf; g.out1 = kbuf; g.out2 = v_l;
      g.split1 = qd; g.split2 = qd + kvd;
      if ((err = launch_gemv<T, EPI_STORE, WK, 1>(g, B, stream)) != cudaSuccess) return err;
    } else {
      T* outs[3] = {qbuf, kbuf, v_l};
      const int widths[3] = {qd, kvd, kvd};
      for (int j = 0; j < 3; ++j) {
        g.w0 = W::w(p[P_W_Q + j], l, H, widths[j]);
        g.s0 = W::s(p[P_S_Q + j], l, widths[j]);
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
          v_l, start, end, attn, attn_ws, l, B, Hq, Hkv, S, D, scale, stream);
    } else {
      err = launch_decode_attention<T, T>(
          qbuf, static_cast<const T*>(p[P_K_SLABS]),
          static_cast<const T*>(p[P_V_SLABS]), nullptr, nullptr, k_l, v_l,
          start, end, attn, attn_ws, l, B, Hq, Hkv, S, D, scale, stream);
    }
    if (err != cudaSuccess) return err;
    ++*attn_launches;
    // h = h + attn @ o_w
    g.x = attn; g.norm_w = nullptr; g.K = qd;
    g.w0 = W::w(p[P_W_O], l, qd, H); g.s0 = W::s(p[P_S_O], l, H);
    g.NL = g.ld = W::row(H);
    g.res = h; g.out = h; g.out1 = g.out2 = nullptr;
    if ((err = launch_gemv<T, EPI_RESIDUAL, WK, 1>(g, B, stream)) != cudaSuccess) return err;
    // act = silu(RMSNorm(h) @ gate_w) * (RMSNorm(h) @ up_w)
    g.x = h; g.norm_w = post_ln + (size_t)l * H; g.K = H; g.out = act;
    g.res = nullptr;
    if (merged) {
      g.w0 = W::w(p[P_W_GATE], l, H, 2 * I);
      g.s0 = W::s(p[P_S_GATE], l, 2 * I);
      g.s1 = g.s0 == nullptr ? nullptr : g.s0 + I;
      if constexpr (WK == W_INT4) {
        // packed column j: gate j (low nibble), up j (high nibble)
        g.NL = g.ld = I;
        err = launch_gemv<T, EPI_SWIGLU, WK, 1>(g, B, stream);
      } else {
        // gate j and up j are columns j and I + j of one row
        g.w1 = static_cast<const char*>(g.w0) + (size_t)I * W::esize();
        g.NL = I; g.ld = 2 * I;
        err = launch_gemv<T, EPI_SWIGLU, WK, 2>(g, B, stream);
      }
    } else {
      g.w0 = W::w(p[P_W_GATE], l, H, I); g.w1 = W::w(p[P_W_UP], l, H, I);
      g.s0 = W::s(p[P_S_GATE], l, I); g.s1 = W::s(p[P_S_UP], l, I);
      g.NL = g.ld = W::row(I);
      err = launch_gemv<T, EPI_SWIGLU, WK, 2>(g, B, stream);
    }
    if (err != cudaSuccess) return err;
    // h = h + act @ down_w
    g.x = act; g.norm_w = nullptr; g.K = I;
    g.w0 = W::w(p[P_W_DOWN], l, I, H); g.w1 = nullptr;
    g.s0 = W::s(p[P_S_DOWN], l, H); g.s1 = nullptr;
    g.NL = g.ld = W::row(H);
    g.res = h; g.out = h;
    if ((err = launch_gemv<T, EPI_RESIDUAL, WK, 1>(g, B, stream)) != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// wkind: 0 T weights, 1 int8, 2 int4 (WeightKind); merged: qkv_w /
// gateup_w layout. Shapes the kernels cannot take are refused before
// anything is launched.
template <typename T>
int decode_layers_fused_entry(const void* const* p, int wkind, int merged,
                              int* attn_launches, int L, int B, int H,
                              int Hq, int Hkv, int D, int I, int S, float eps,
                              void* stream) {
  const int align = wkind == W_INT4 ? 16 : 8;  // 8 loaded columns per thread
  if (B < 1 || D > 256 || D % 32 != 0 || H % align != 0 || I % align != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wkind) {
    case W_FLOAT:
      return static_cast<int>(decode_layers_fused<T, W_FLOAT>(
          p, merged, attn_launches, L, B, H, Hq, Hkv, D, I, S, eps, st));
    case W_INT8:
      return static_cast<int>(decode_layers_fused<T, W_INT8>(
          p, merged, attn_launches, L, B, H, Hq, Hkv, D, I, S, eps, st));
    case W_INT4:
      return static_cast<int>(decode_layers_fused<T, W_INT4>(
          p, merged, attn_launches, L, B, H, Hq, Hkv, D, I, S, eps, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define DECODE_LAYERS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* const* p, int wkind, int merged,           \
                      int* attn_launches, int L, int B, int H, int Hq,       \
                      int Hkv, int D, int I, int S, float eps,               \
                      void* stream) {                                        \
    return decode_layers_fused_entry<T>(p, wkind, merged, attn_launches, L,  \
                                        B, H, Hq, Hkv, D, I, S, eps,         \
                                        stream);                             \
  }

DECODE_LAYERS_ENTRY(decode_layers_fused_bf16, bf16)
DECODE_LAYERS_ENTRY(decode_layers_fused_f32, float)
