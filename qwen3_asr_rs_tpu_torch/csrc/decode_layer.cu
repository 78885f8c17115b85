// One greedy decode step through all decoder layers, B = 1: the CUDA
// counterpart of the Pallas decode megakernel
// qwen3_asr_rs_tpu/ops/pallas/decode_layer.py::decode_layers_fused
// (its ffn_tiles=1, no-fold, no-int8-KV branches, with bf16/f32
// activations and bf16/f32, int8 or int4 weights, merged or per
// projection).
//
// Per layer: RMSNorm -> q/k/v -> per-head QK-RMSNorm -> rotary -> GQA
// attention over the slab's live range plus the fresh self K/V -> o-proj
// + residual -> RMSNorm -> SwiGLU -> down + residual. The step returns the
// hidden state and every layer's fresh K/V; the caller writes the slab.
// Rounding to T happens at the stages where the JAX path rounds to its
// compute dtype (text_decoder._decode_layer_masked, decode_layer._mm);
// norms, softmax and every accumulation run in float32, and a quantized
// product's per-column scale multiplies the whole float32 sum before it
// rounds to T.
//
// What bounds it on the H100: the weight stream. At 0.6B a layer holds
// 15.7 M parameters, 28 layers 0.88 GB per token in bf16 (0.26 ms at the
// data-sheet 3.35 TB/s), 0.44 GB in int8, 0.22 GB in int4. This first
// version is a chain of simple kernels, launched by one C entry that
// loops over the layers on the host side: 9 launches per layer unmerged,
// 7 merged, each latency-bound (small grids, dependent phases), so
// latency, not bytes, sets its time. The GEMVs read 8 consecutive
// weights per thread and row (16 bytes of bf16, 8 of int8, 8 bytes = 16
// int4 weights), coalesced along `out`, and split K over 128-row chunks,
// with a deterministic last-block reduction instead of float atomics.
// The RMSNorm before a projection is recomputed by each GEMV block (the
// hidden state is 2 KB), which saves a launch. Persistence, CUDA graphs
// and wgmma are later work.
#include "decode_attention.cuh"

constexpr int GEMV_CPT = 8;                    // columns per thread
constexpr int GEMV_TX = 8;                     // threads across columns
constexpr int GEMV_TN = GEMV_CPT * GEMV_TX;    // 64 columns per block
constexpr int GEMV_TY = 32;                    // threads across rows
constexpr int GEMV_KC = 128;                   // rows per block
constexpr int GEMV_THREADS = GEMV_TX * GEMV_TY;

enum Epilogue { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

// How a weight is stored: T; int8 with per-column float32 scales; or
// int4, two per byte, where the byte at packed column j of a (K, N/2) row
// holds column j (low nibble) and column j + N/2 (high nibble), with
// per-column scales over the N unpacked columns.
enum WeightKind { W_FLOAT = 0, W_INT8 = 1, W_INT4 = 2 };

template <typename T>
struct GemvArgs {
  const T* x;        // (K,) input row
  const T* norm_w;   // (K,) RMSNorm weight applied to x first, or null
  float eps;
  // weights (K rows of stride ld elements; bytes for int8/int4) and their
  // per-output-column scales (null for T weights). The grid walks NL
  // loaded columns; an int4 byte column j gives outputs j and j + NL.
  const void* w0;
  const void* w1;    // EPI_SWIGLU with two sources: the "up" weight
  const float* s0;
  const float* s1;   // EPI_SWIGLU: the "up" scales
  const T* res;      // (N,) residual (EPI_RESIDUAL); may alias out
  // EPI_STORE writes output columns [0, split1) to out, [split1, split2)
  // to out1 and [split2, N) to out2
  T* out;
  T* out1;
  T* out2;
  int split1, split2;
  float* ws;         // (accumulators, ceil(K / GEMV_KC), NL) split-K partials
  int* counters;     // (ceil(NL / GEMV_TN),) zero on entry, zero on exit
  int K, NL, ld;
};

// GEMV_CPT consecutive weights of one row as float: lo gets the values
// (int4: the low nibbles), hi the int4 high nibbles. Loads are 16 bytes
// (bf16), 32 bytes (float) or 8 bytes (int8, int4), aligned.
template <typename T, int WK>
__device__ __forceinline__ void load_weights(const void* base, size_t off,
                                             float* lo, float* hi) {
  if constexpr (WK == W_FLOAT) {
    load8(static_cast<const T*>(base) + off, lo);
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(base) + off));
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int c = 0; c < GEMV_CPT; ++c) {
      const int v = b[c];
      if constexpr (WK == W_INT8) {
        lo[c] = (float)v;
      } else {
        lo[c] = (float)(((v & 0xF) ^ 8) - 8);  // low nibble, sign-extended
        hi[c] = (float)(v >> 4);               // high nibble
      }
    }
  }
}

__device__ __forceinline__ float scaled(float v, const float* s, int n) {
  return s != nullptr ? v * s[n] : v;
}

// y = x @ W over NSRC weights of kind WK, then a per-epilogue rounding
// (the scale multiplies the whole contraction, after the split-K partials
// are summed, and only then rounds to T):
//   STORE:    out = T(y s)
//   RESIDUAL: out = T(res + T(y s))
//   SWIGLU:   out = T(T(silu(T(gate s0))) * T(up s1)), where gate and up
//             come from two weights (w0, w1) or, for a merged int4
//             gate|up, from the low and high nibbles of one byte
template <typename T, int EPI, int WK, int NSRC>
__global__ void __launch_bounds__(GEMV_THREADS) gemv_kernel(GemvArgs<T> a) {
  constexpr int NV = WK == W_INT4 ? 2 : 1;  // values per loaded column
  constexpr int NACC = NSRC * NV;
  static_assert(NACC * GEMV_TN <= GEMV_THREADS, "one thread per total");
  __shared__ float xs[GEMV_KC];
  __shared__ float red[NACC][GEMV_TY][GEMV_TN + 1];
  __shared__ float tot[NACC][GEMV_TN];
  __shared__ float sbuf[32];
  __shared__ bool is_last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * GEMV_TX + tx;
  const int k0 = blockIdx.y * GEMV_KC;
  const int kend = min(k0 + GEMV_KC, a.K);
  const int nb = blockIdx.x * GEMV_TN;

  float r = 1.f;
  if (a.norm_w != nullptr) {
    float ss = 0.f;
    for (int k = tid; k < a.K; k += GEMV_THREADS) {
      const float v = to_f(a.x[k]);
      ss += v * v;
    }
    ss = block_sum(ss, sbuf, tid, GEMV_THREADS);
    r = 1.f / sqrtf(ss / a.K + a.eps);
  }
  for (int k = k0 + tid; k < kend; k += GEMV_THREADS) {
    const float v = to_f(a.x[k]);
    xs[k - k0] = a.norm_w != nullptr ? round_to<T>(v * r * to_f(a.norm_w[k]))
                                     : v;
  }
  __syncthreads();

  float acc[NACC][GEMV_CPT];
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int c = 0; c < GEMV_CPT; ++c) acc[j][c] = 0.f;
  const int n0 = nb + tx * GEMV_CPT;
  if (n0 < a.NL) {
    for (int k = k0 + ty; k < kend; k += GEMV_TY) {
      const float xv = xs[k - k0];
#pragma unroll
      for (int src = 0; src < NSRC; ++src) {
        float lo[GEMV_CPT], hi[GEMV_CPT];
        load_weights<T, WK>(src == 0 ? a.w0 : a.w1, (size_t)k * a.ld + n0, lo,
                            hi);
#pragma unroll
        for (int c = 0; c < GEMV_CPT; ++c) {
          acc[src * NV][c] = fmaf(xv, lo[c], acc[src * NV][c]);
          if constexpr (NV == 2) {
            acc[src * NV + 1][c] = fmaf(xv, hi[c], acc[src * NV + 1][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int c = 0; c < GEMV_CPT; ++c) red[j][ty][tx * GEMV_CPT + c] = acc[j][c];
  __syncthreads();

  // column sums over the block's rows, in row-thread order
  const bool active = tid < NACC * GEMV_TN;
  const int which = tid / GEMV_TN, col = tid % GEMV_TN;
  const int n = nb + col;
  float s = 0.f;
  if (active) {
    for (int y = 0; y < GEMV_TY; ++y) s += red[which][y][col];
  }
  if (gridDim.y > 1) {
    // split K: publish this block's partial; the last block of the
    // column tile to arrive adds all partials in split order
    if (active && n < a.NL) {
      a.ws[((size_t)which * gridDim.y + blockIdx.y) * a.NL + n] = s;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(&a.counters[blockIdx.x], 1) == (int)gridDim.y - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (active && n < a.NL) {
      s = 0.f;
      for (int ks = 0; ks < (int)gridDim.y; ++ks) {
        s += __ldcg(&a.ws[((size_t)which * gridDim.y + ks) * a.NL + n]);
      }
    }
    if (tid == 0) a.counters[blockIdx.x] = 0;
  }
  if (active) tot[which][col] = s;
  __syncthreads();
  if (tid >= GEMV_TN || nb + tid >= a.NL) return;
  const int nl = nb + tid;  // loaded column
  if constexpr (EPI == EPI_SWIGLU) {
    // pairs (gate, up) of accumulators, each pair one output column
    constexpr int NPAIR = NSRC == 1 ? 1 : NV;
#pragma unroll
    for (int v = 0; v < NPAIR; ++v) {
      const int gi = NSRC == 1 ? 0 : v, ui = NSRC == 1 ? 1 : NV + v;
      const int on = nl + v * a.NL;
      const float gate = round_to<T>(scaled(tot[gi][tid], a.s0, on));
      const float up = round_to<T>(scaled(tot[ui][tid], a.s1, on));
      const float act = round_to<T>(gate * (1.f / (1.f + expf(-gate))));
      a.out[on] = from_f<T>(act * up);
    }
  } else {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int on = nl + v * a.NL;
      const float y = round_to<T>(scaled(tot[v][tid], a.s0, on));
      if constexpr (EPI == EPI_STORE) {
        if (on < a.split1) {
          a.out[on] = from_f<T>(y);
        } else if (on < a.split2) {
          a.out1[on - a.split1] = from_f<T>(y);
        } else {
          a.out2[on - a.split2] = from_f<T>(y);
        }
      } else {
        a.out[on] = from_f<T>(to_f(a.res[on]) + y);
      }
    }
  }
}

template <typename T, int EPI, int WK, int NSRC>
cudaError_t launch_gemv(const GemvArgs<T>& a, cudaStream_t stream) {
  const dim3 grid((a.NL + GEMV_TN - 1) / GEMV_TN, (a.K + GEMV_KC - 1) / GEMV_KC);
  gemv_kernel<T, EPI, WK, NSRC><<<grid, dim3(GEMV_TX, GEMV_TY), 0, stream>>>(a);
  return cudaGetLastError();
}

// Per-head RMSNorm (q_norm / k_norm) then rotate-half rotary, one block of
// D threads per head (B = 1): blocks [0, Hq) rotate q in place, blocks
// [Hq, Hq + Hkv) read k_in and write the layer's fresh-K output.
template <typename T>
__global__ void qk_norm_rope_kernel(T* q, const T* __restrict__ k_in,
                                    T* __restrict__ k_out,
                                    const T* __restrict__ q_norm,
                                    const T* __restrict__ k_norm,
                                    const float* __restrict__ cos,
                                    const float* __restrict__ sin, int Hq,
                                    float eps) {
  __shared__ float sbuf[32];
  __shared__ float y_s[256];
  const int D = blockDim.x, d = threadIdx.x, j = blockIdx.x;
  const bool is_q = j < Hq;
  const T* src = is_q ? q + (size_t)j * D : k_in + (size_t)(j - Hq) * D;
  T* dst = is_q ? q + (size_t)j * D : k_out + (size_t)(j - Hq) * D;
  const T* w = is_q ? q_norm : k_norm;
  const float v = to_f(src[d]);
  const float ss = block_sum(v * v, sbuf, d, D);
  const float r = 1.f / sqrtf(ss / D + eps);
  const float y = round_to<T>(v * r * to_f(w[d]));
  y_s[d] = y;
  __syncthreads();
  const int half = D / 2;
  const float rot = d < half ? -y_s[d + half] : y_s[d - half];
  dst[d] = from_f<T>(y * cos[d] + rot * sin[d]);
}

// Scratch sizes for one step: sizes[0] float32 workspace (GEMV partials +
// attention partials), sizes[1] int32 counters, sizes[2] T elements.
// Enough for every weight kind and layout.
extern "C" void decode_layers_fused_scratch(int H, int Hq, int Hkv, int D,
                                            int I, int S, long long* sizes) {
  auto splits = [](int K) { return (long long)(K + GEMV_KC - 1) / GEMV_KC; };
  const long long qkv = (long long)Hq * D + 2LL * Hkv * D;
  long long g = splits(H) * qkv;                        // q|k|v
  g = g > splits(Hq * D) * H ? g : splits(Hq * D) * H;  // o
  g = g > 2 * splits(H) * I ? g : 2 * splits(H) * I;    // gate + up
  g = g > splits(I) * H ? g : splits(I) * H;            // down
  long long n_max = qkv > I ? qkv : I;
  n_max = n_max > H ? n_max : H;
  sizes[0] = g + (long long)Hq * attn_num_splits(S) * (D + 2);
  sizes[1] = (n_max + GEMV_TN - 1) / GEMV_TN;
  sizes[2] = 2LL * Hq * D + (long long)Hkv * D + I;
}

// The step's pointer table (a host array of device pointers): activations,
// slabs and scratch, then the stacked (L, ...) weights and their scales.
// Merged trees pass qkv_w in P_W_Q and gateup_w in P_W_GATE (and their
// scales likewise) and null for k, v and up; float weights pass null
// scales.
enum StepPtr {
  P_X, P_COS, P_SIN, P_IN_LN, P_POST_LN, P_Q_NORM, P_K_NORM, P_K_SLABS,
  P_V_SLABS, P_START, P_END, P_H, P_KS, P_VS, P_WS, P_COUNTERS, P_TMP,
  P_W_Q, P_W_K, P_W_V, P_W_O, P_W_GATE, P_W_UP, P_W_DOWN,
  P_S_Q, P_S_K, P_S_V, P_S_O, P_S_GATE, P_S_UP, P_S_DOWN, P_COUNT
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
                                int* attn_launches, int L, int H, int Hq,
                                int Hkv, int D, int I, int S, float eps,
                                cudaStream_t stream) {
  using W = Stacked<T, WK>;
  const T* x = static_cast<const T*>(p[P_X]);
  const float* cos = static_cast<const float*>(p[P_COS]);
  const float* sin = static_cast<const float*>(p[P_SIN]);
  const T* in_ln = static_cast<const T*>(p[P_IN_LN]);
  const T* post_ln = static_cast<const T*>(p[P_POST_LN]);
  const T* q_norm = static_cast<const T*>(p[P_Q_NORM]);
  const T* k_norm = static_cast<const T*>(p[P_K_NORM]);
  const T* k_slabs = static_cast<const T*>(p[P_K_SLABS]);
  const T* v_slabs = static_cast<const T*>(p[P_V_SLABS]);
  const int* start = static_cast<const int*>(p[P_START]);
  const int* end = static_cast<const int*>(p[P_END]);
  T* h = static_cast<T*>(const_cast<void*>(p[P_H]));
  T* ks = static_cast<T*>(const_cast<void*>(p[P_KS]));
  T* vs = static_cast<T*>(const_cast<void*>(p[P_VS]));
  float* ws = static_cast<float*>(const_cast<void*>(p[P_WS]));
  int* counters = static_cast<int*>(const_cast<void*>(p[P_COUNTERS]));
  T* tmp = static_cast<T*>(const_cast<void*>(p[P_TMP]));

  const int qd = Hq * D, kvd = Hkv * D, qkvd = qd + 2 * kvd;
  T* qbuf = tmp;
  T* attn = tmp + qd;
  T* kbuf = tmp + 2 * qd;
  T* act = tmp + 2 * qd + kvd;
  float* attn_ws = ws;
  {
    long long sz[3];
    decode_layers_fused_scratch(H, Hq, Hkv, D, I, S, sz);
    attn_ws = ws + (sz[0] - (long long)Hq * attn_num_splits(S) * (D + 2));
  }
  const float scale = 1.f / sqrtf((float)D);
  cudaError_t err = cudaMemcpyAsync(h, x, sizeof(T) * H,
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  for (int l = 0; l < L; ++l) {
    T* k_l = ks + (size_t)l * kvd;
    T* v_l = vs + (size_t)l * kvd;
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
      if ((err = launch_gemv<T, EPI_STORE, WK, 1>(g, stream)) != cudaSuccess) return err;
    } else {
      T* outs[3] = {qbuf, kbuf, v_l};
      const int widths[3] = {qd, kvd, kvd};
      for (int j = 0; j < 3; ++j) {
        g.w0 = W::w(p[P_W_Q + j], l, H, widths[j]);
        g.s0 = W::s(p[P_S_Q + j], l, widths[j]);
        g.NL = g.ld = W::row(widths[j]);
        g.out = outs[j]; g.split1 = g.split2 = widths[j];
        if ((err = launch_gemv<T, EPI_STORE, WK, 1>(g, stream)) != cudaSuccess) return err;
      }
    }
    // QK-RMSNorm + rotary; k lands in the fresh-K output
    qk_norm_rope_kernel<T><<<Hq + Hkv, D, 0, stream>>>(
        qbuf, kbuf, k_l, q_norm + (size_t)l * D, k_norm + (size_t)l * D, cos,
        sin, Hq, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // attention over the stale slab [start, end) + the self K/V
    err = launch_decode_attention<T>(qbuf, k_slabs, v_slabs, k_l, v_l, start,
                                     end, attn, attn_ws, l, 1, Hq, Hkv, S, D,
                                     scale, stream);
    if (err != cudaSuccess) return err;
    ++*attn_launches;
    // h = h + attn @ o_w
    g.x = attn; g.norm_w = nullptr; g.K = qd;
    g.w0 = W::w(p[P_W_O], l, qd, H); g.s0 = W::s(p[P_S_O], l, H);
    g.NL = g.ld = W::row(H);
    g.res = h; g.out = h;
    if ((err = launch_gemv<T, EPI_RESIDUAL, WK, 1>(g, stream)) != cudaSuccess) return err;
    // act = silu(RMSNorm(h) @ gate_w) * (RMSNorm(h) @ up_w)
    g.x = h; g.norm_w = post_ln + (size_t)l * H; g.K = H; g.out = act;
    if (merged) {
      g.w0 = W::w(p[P_W_GATE], l, H, 2 * I);
      g.s0 = W::s(p[P_S_GATE], l, 2 * I);
      g.s1 = g.s0 == nullptr ? nullptr : g.s0 + I;
      if constexpr (WK == W_INT4) {
        // packed column j: gate j (low nibble), up j (high nibble)
        g.NL = g.ld = I;
        err = launch_gemv<T, EPI_SWIGLU, WK, 1>(g, stream);
      } else {
        // gate j and up j are columns j and I + j of one row
        g.w1 = static_cast<const char*>(g.w0) + (size_t)I * W::esize();
        g.NL = I; g.ld = 2 * I;
        err = launch_gemv<T, EPI_SWIGLU, WK, 2>(g, stream);
      }
    } else {
      g.w0 = W::w(p[P_W_GATE], l, H, I); g.w1 = W::w(p[P_W_UP], l, H, I);
      g.s0 = W::s(p[P_S_GATE], l, I); g.s1 = W::s(p[P_S_UP], l, I);
      g.NL = g.ld = W::row(I);
      err = launch_gemv<T, EPI_SWIGLU, WK, 2>(g, stream);
    }
    if (err != cudaSuccess) return err;
    // h = h + act @ down_w
    g.x = act; g.norm_w = nullptr; g.K = I;
    g.w0 = W::w(p[P_W_DOWN], l, I, H); g.w1 = nullptr;
    g.s0 = W::s(p[P_S_DOWN], l, H); g.s1 = nullptr;
    g.NL = g.ld = W::row(H);
    g.res = h; g.out = h;
    if ((err = launch_gemv<T, EPI_RESIDUAL, WK, 1>(g, stream)) != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// wkind: 0 T weights, 1 int8, 2 int4 (WeightKind); merged: qkv_w /
// gateup_w layout. Shapes the kernels cannot take are refused before
// anything is launched.
template <typename T>
int decode_layers_fused_entry(const void* const* p, int wkind, int merged,
                              int* attn_launches, int L, int H, int Hq,
                              int Hkv, int D, int I, int S, float eps,
                              void* stream) {
  const int align = wkind == W_INT4 ? 16 : 8;  // 8 loaded columns per thread
  if (D > 256 || D % 32 != 0 || H % align != 0 || I % align != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wkind) {
    case W_FLOAT:
      return static_cast<int>(decode_layers_fused<T, W_FLOAT>(
          p, merged, attn_launches, L, H, Hq, Hkv, D, I, S, eps, st));
    case W_INT8:
      return static_cast<int>(decode_layers_fused<T, W_INT8>(
          p, merged, attn_launches, L, H, Hq, Hkv, D, I, S, eps, st));
    case W_INT4:
      return static_cast<int>(decode_layers_fused<T, W_INT4>(
          p, merged, attn_launches, L, H, Hq, Hkv, D, I, S, eps, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define DECODE_LAYERS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* const* p, int wkind, int merged,           \
                      int* attn_launches, int L, int H, int Hq, int Hkv,     \
                      int D, int I, int S, float eps, void* stream) {        \
    return decode_layers_fused_entry<T>(p, wkind, merged, attn_launches, L,  \
                                        H, Hq, Hkv, D, I, S, eps, stream);   \
  }

DECODE_LAYERS_ENTRY(decode_layers_fused_bf16, bf16)
DECODE_LAYERS_ENTRY(decode_layers_fused_f32, float)
