// One greedy decode step through all decoder layers, B = 1: the CUDA
// counterpart of the Pallas decode megakernel
// qwen3_asr_rs_tpu/ops/pallas/decode_layer.py::decode_layers_fused
// (its bf16/f32, unmerged, ffn_tiles=1, no-fold, no-int8-KV branch).
//
// Per layer: RMSNorm -> q/k/v -> per-head QK-RMSNorm -> rotary -> GQA
// attention over the slab's live range plus the fresh self K/V -> o-proj
// + residual -> RMSNorm -> SwiGLU -> down + residual. The step returns the
// hidden state and every layer's fresh K/V; the caller writes the slab.
// Rounding to T happens at the stages where the JAX path rounds to its
// compute dtype (text_decoder._decode_layer_masked); norms, softmax and
// every accumulation run in float32.
//
// What bounds it on the H100: the weight stream. At 0.6B bf16 a layer
// holds 15.7 M parameters, 28 layers 0.88 GB per token: 0.26 ms at the
// data-sheet 3.35 TB/s. This first version is a chain of simple kernels,
// launched by one C entry that loops over the layers on the host side:
// 9 launches per layer, each latency-bound (small grids, dependent
// phases), so latency, not bytes, sets its time. The GEMVs read the
// (in, out) weights 16 bytes per thread, coalesced along `out`, and split
// K over 128-row chunks (64 to 384 blocks per GEMV at 0.6B), with a
// deterministic last-block reduction instead of float atomics. The RMSNorm before a
// projection is recomputed by each GEMV block (the hidden state is 2 KB),
// which saves a launch. Persistence, CUDA graphs and wgmma are later work.
#include "decode_attention.cuh"

constexpr int GEMV_CPT = 8;                    // columns per thread
constexpr int GEMV_TX = 8;                     // threads across columns
constexpr int GEMV_TN = GEMV_CPT * GEMV_TX;    // 64 columns per block
constexpr int GEMV_TY = 32;                    // threads across rows
constexpr int GEMV_KC = 128;                   // rows per block
constexpr int GEMV_THREADS = GEMV_TX * GEMV_TY;

enum Epilogue { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_SWIGLU = 2 };

template <typename T>
struct GemvArgs {
  const T* x;        // (K,) input row
  const T* norm_w;   // (K,) RMSNorm weight applied to x first, or null
  float eps;
  const T* w0;       // (K, N) row-major weight
  const T* w1;       // (K, N) SwiGLU "up" weight (EPI_SWIGLU)
  const T* res;      // (N,) residual (EPI_RESIDUAL); may alias out
  T* out;            // (N,)
  float* ws;         // (2, ceil(K / GEMV_KC), N) split-K partials
  int* counters;     // (ceil(N / GEMV_TN),) zero on entry, zero on exit
  int K, N;
};

// y = x @ w0 (and x @ w1) with a per-epilogue rounding:
//   STORE:    out = T(y)
//   RESIDUAL: out = T(res + T(y))
//   SWIGLU:   out = T(T(silu(T(y0))) * T(y1))
template <typename T, int EPI>
__global__ void __launch_bounds__(GEMV_THREADS) gemv_kernel(GemvArgs<T> a) {
  constexpr int NW = EPI == EPI_SWIGLU ? 2 : 1;
  __shared__ float xs[GEMV_KC];
  __shared__ float red[NW][GEMV_TY][GEMV_TN + 1];
  __shared__ float tot[NW][GEMV_TN];
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

  float acc[NW][GEMV_CPT];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int c = 0; c < GEMV_CPT; ++c) acc[j][c] = 0.f;
  const int n0 = nb + tx * GEMV_CPT;
  if (n0 < a.N) {
    for (int k = k0 + ty; k < kend; k += GEMV_TY) {
      const float xv = xs[k - k0];
      float w[GEMV_CPT];
      load8(a.w0 + (size_t)k * a.N + n0, w);
#pragma unroll
      for (int c = 0; c < GEMV_CPT; ++c) acc[0][c] = fmaf(xv, w[c], acc[0][c]);
      if (EPI == EPI_SWIGLU) {
        load8(a.w1 + (size_t)k * a.N + n0, w);
#pragma unroll
        for (int c = 0; c < GEMV_CPT; ++c)
          acc[NW - 1][c] = fmaf(xv, w[c], acc[NW - 1][c]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int c = 0; c < GEMV_CPT; ++c) red[j][ty][tx * GEMV_CPT + c] = acc[j][c];
  __syncthreads();

  // column sums over the block's rows, in row-thread order
  const bool active = tid < NW * GEMV_TN;
  const int which = tid / GEMV_TN, col = tid % GEMV_TN;
  const int n = nb + col;
  float s = 0.f;
  if (active) {
    for (int y = 0; y < GEMV_TY; ++y) s += red[which][y][col];
  }
  if (gridDim.y > 1) {
    // split K: publish this block's partial; the last block of the
    // column tile to arrive adds all partials in split order
    if (active && n < a.N) {
      a.ws[((size_t)which * gridDim.y + blockIdx.y) * a.N + n] = s;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(&a.counters[blockIdx.x], 1) == (int)gridDim.y - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (active && n < a.N) {
      s = 0.f;
      for (int ks = 0; ks < (int)gridDim.y; ++ks) {
        s += __ldcg(&a.ws[((size_t)which * gridDim.y + ks) * a.N + n]);
      }
    }
    if (tid == 0) a.counters[blockIdx.x] = 0;
  }
  if (active) tot[which][col] = s;
  __syncthreads();
  if (tid < GEMV_TN && n < a.N) {
    const float y0 = round_to<T>(tot[0][tid]);
    if (EPI == EPI_STORE) {
      a.out[n] = from_f<T>(y0);
    } else if (EPI == EPI_RESIDUAL) {
      a.out[n] = from_f<T>(to_f(a.res[n]) + y0);
    } else {
      const float up = round_to<T>(tot[NW - 1][tid]);
      const float act = round_to<T>(y0 * (1.f / (1.f + expf(-y0))));
      a.out[n] = from_f<T>(act * up);
    }
  }
}

template <typename T, int EPI>
cudaError_t launch_gemv(const GemvArgs<T>& a, cudaStream_t stream) {
  const dim3 grid((a.N + GEMV_TN - 1) / GEMV_TN, (a.K + GEMV_KC - 1) / GEMV_KC);
  gemv_kernel<T, EPI><<<grid, dim3(GEMV_TX, GEMV_TY), 0, stream>>>(a);
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
extern "C" void decode_layers_fused_scratch(int H, int Hq, int Hkv, int D,
                                            int I, int S, long long* sizes) {
  auto splits = [](int K) { return (long long)(K + GEMV_KC - 1) / GEMV_KC; };
  long long g = splits(H) * Hq * D;                    // q
  g = g > splits(Hq * D) * H ? g : splits(Hq * D) * H;  // o
  g = g > 2 * splits(H) * I ? g : 2 * splits(H) * I;    // gate + up
  g = g > splits(I) * H ? g : splits(I) * H;            // down
  long long n_max = Hq * D > I ? Hq * D : I;
  n_max = n_max > H ? n_max : H;
  sizes[0] = g + (long long)Hq * attn_num_splits(S) * (D + 2);
  sizes[1] = (n_max + GEMV_TN - 1) / GEMV_TN;
  sizes[2] = 2LL * Hq * D + (long long)Hkv * D + I;
}

// attn_launches is a host int, incremented once each time
// launch_decode_attention has enqueued K2's kernels (split + merge)
// without error, so the caller counts K2's launches where they are made.
template <typename T>
cudaError_t decode_layers_fused(
    const T* x, const float* cos, const float* sin, const T* in_ln,
    const T* post_ln, const T* q_norm, const T* k_norm, const T* q_w,
    const T* k_w, const T* v_w, const T* o_w, const T* gate_w,
    const T* up_w, const T* down_w, const T* k_slabs, const T* v_slabs,
    const int* start, const int* end, T* h, T* ks, T* vs, float* ws,
    int* counters, T* tmp, int* attn_launches, int L, int H, int Hq,
    int Hkv, int D, int I, int S, float eps, cudaStream_t stream) {
  const int qd = Hq * D, kvd = Hkv * D;
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
    g.w0 = q_w + (size_t)l * H * qd; g.out = qbuf; g.N = qd;
    if ((err = launch_gemv<T, EPI_STORE>(g, stream)) != cudaSuccess) return err;
    g.w0 = k_w + (size_t)l * H * kvd; g.out = kbuf; g.N = kvd;
    if ((err = launch_gemv<T, EPI_STORE>(g, stream)) != cudaSuccess) return err;
    g.w0 = v_w + (size_t)l * H * kvd; g.out = v_l;
    if ((err = launch_gemv<T, EPI_STORE>(g, stream)) != cudaSuccess) return err;
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
    g.w0 = o_w + (size_t)l * qd * H; g.res = h; g.out = h; g.N = H;
    if ((err = launch_gemv<T, EPI_RESIDUAL>(g, stream)) != cudaSuccess) return err;
    // act = silu(RMSNorm(h) @ gate_w) * (RMSNorm(h) @ up_w)
    g.x = h; g.norm_w = post_ln + (size_t)l * H; g.K = H;
    g.w0 = gate_w + (size_t)l * H * I; g.w1 = up_w + (size_t)l * H * I;
    g.out = act; g.N = I;
    if ((err = launch_gemv<T, EPI_SWIGLU>(g, stream)) != cudaSuccess) return err;
    // h = h + act @ down_w
    g.x = act; g.norm_w = nullptr; g.K = I;
    g.w0 = down_w + (size_t)l * I * H; g.w1 = nullptr; g.res = h; g.out = h;
    g.N = H;
    if ((err = launch_gemv<T, EPI_RESIDUAL>(g, stream)) != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

#define DECODE_LAYERS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                       \
      const void* x, const void* cos, const void* sin, const void* in_ln,    \
      const void* post_ln, const void* q_norm, const void* k_norm,           \
      const void* q_w, const void* k_w, const void* v_w, const void* o_w,    \
      const void* gate_w, const void* up_w, const void* down_w,              \
      const void* k_slabs, const void* v_slabs, const void* start,           \
      const void* end, void* h, void* ks, void* vs, void* ws,                \
      void* counters, void* tmp, int* attn_launches, int L, int H, int Hq,   \
      int Hkv, int D, int I, int S, float eps, void* stream) {               \
    if (D > 256 || D % 32 != 0 || H % 8 != 0 || I % 8 != 0) {                \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    }                                                                        \
    return static_cast<int>(decode_layers_fused<T>(                          \
        static_cast<const T*>(x), static_cast<const float*>(cos),            \
        static_cast<const float*>(sin), static_cast<const T*>(in_ln),        \
        static_cast<const T*>(post_ln), static_cast<const T*>(q_norm),       \
        static_cast<const T*>(k_norm), static_cast<const T*>(q_w),           \
        static_cast<const T*>(k_w), static_cast<const T*>(v_w),              \
        static_cast<const T*>(o_w), static_cast<const T*>(gate_w),           \
        static_cast<const T*>(up_w), static_cast<const T*>(down_w),          \
        static_cast<const T*>(k_slabs), static_cast<const T*>(v_slabs),      \
        static_cast<const int*>(start), static_cast<const int*>(end),        \
        static_cast<T*>(h), static_cast<T*>(ks), static_cast<T*>(vs),        \
        static_cast<float*>(ws), static_cast<int*>(counters),                \
        static_cast<T*>(tmp), attn_launches, L, H, Hq, Hkv, D, I, S, eps,    \
        static_cast<cudaStream_t>(stream)));                                 \
  }

DECODE_LAYERS_ENTRY(decode_layers_fused_bf16, bf16)
DECODE_LAYERS_ENTRY(decode_layers_fused_f32, float)
