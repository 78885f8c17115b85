// Decode attention over the stacked KV slab: one query token per example,
// GQA, live slots [start_b, end_b) of layer `layer`, plus the fresh self
// key/value as one extra key. The CUDA counterpart of the Pallas kernel
// qwen3_asr_rs_tpu/ops/pallas/decode_attention.py::decode_attention_dma
// (its bf16/f32 and int8-KV slab modes). Used alone (decode_attention.cu)
// and as the attention stage of the decode step (decode_layer.cu).
//
// Design (split-K "flash decoding"): the slot axis is cut into chunks of
// ATTN_CHUNK slots; block (split, kv_head, b) handles the G query heads
// that share one kv head over one chunk, so each K/V row is read once for
// all G heads, and only chunks that intersect the live range do any
// reading: no dead slot is loaded. Each of the block's warps walks every
// ATTN_WARPS-th slot with an online softmax (a lane holds D/32 dims),
// the warps merge in shared memory, and the block writes one partial
// (max, sum, acc[D]) per head. A merge kernel then folds the partials
// and the self term, in float32, and rounds to T once. Scores and
// softmax are float32 throughout, as in the Pallas kernel.
//
// int8 slabs (KV = int8_t) carry float32 scales per (layer, example, kv
// head, slot). As in the Pallas kernel the scales are folded instead of
// dequantizing K and V: q.(k_int8 * ks) = (q.k_int8) * ks multiplies the
// raw score, and sum_s p_s (v_int8_s * vs_s) = sum_s (p_s vs_s) v_int8_s
// the probabilities of the PV sum, while the softmax sum takes the
// unscaled p. Only live slots are ever scored here, so a dead slot's
// scale (0 in a fresh slab) cannot unmask it. The self K/V stay in T.
// The int8 slab halves the K/V bytes this kernel streams.
#pragma once

#include <type_traits>

#include "common.cuh"

constexpr int ATTN_CHUNK = 64;  // slab slots per split block
constexpr int ATTN_WARPS = 4;
constexpr int ATTN_MAXG = 8;    // query heads per kv head

inline int attn_num_splits(int S) { return (S + ATTN_CHUNK - 1) / ATTN_CHUNK; }

// The unsigned type of a lane's load of BYTES bytes.
template <int BYTES> struct LaneWord;
template <> struct LaneWord<2> { using type = unsigned short; };
template <> struct LaneWord<4> { using type = unsigned int; };
template <> struct LaneWord<8> { using type = uint2; };
template <> struct LaneWord<16> { using type = uint4; };

// DPL consecutive slab elements as float, in one load (2 to 16 bytes:
// int8 at D = 64 to f32 at D = 128); p is aligned to it.
template <typename KV, int DPL>
__device__ __forceinline__ void load_lane(const KV* p, float* out) {
  using Word = typename LaneWord<DPL * (int)sizeof(KV)>::type;
  const Word u = __ldg(reinterpret_cast<const Word*>(p));
  const KV* e = reinterpret_cast<const KV*>(&u);
#pragma unroll
  for (int i = 0; i < DPL; ++i) out[i] = to_f(e[i]);
}

// Partial results: ws[((b * Hq + h) * nsplit + split) * (D + 2) + {0: max,
// 1: sum, 2..: acc}]; an empty split stores max = -inf. k/v_scales are
// (L, B, Hkv, S) float32 for int8 slabs and null otherwise.
template <typename T, typename KV, int DPL>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
attn_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_slabs,
                  const KV* __restrict__ v_slabs,
                  const float* __restrict__ k_scales,
                  const float* __restrict__ v_scales,
                  const int* __restrict__ start, const int* __restrict__ end,
                  float* __restrict__ ws, int layer, int B, int Hq, int Hkv,
                  int S, float scale) {
  constexpr int D = DPL * 32;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the live range is clamped to the slab: no slot outside [0, S) is read
  const int lo = max(split * ATTN_CHUNK, start[b]);
  const int hi = min(min(split * ATTN_CHUNK + ATTN_CHUNK, end[b]), S);
  const size_t head_stride = (size_t)nsplit * (D + 2);
  float* part0 = ws + ((size_t)(b * Hq + kvh * G) * nsplit + split) * (D + 2);
  if (lo >= hi) {
    if (threadIdx.x < G) {
      part0[threadIdx.x * head_stride] = -INFINITY;
      part0[threadIdx.x * head_stride + 1] = 0.f;
    }
    return;
  }

  float qf[ATTN_MAXG][DPL], acc[ATTN_MAXG][DPL], m[ATTN_MAXG], l[ATTN_MAXG];
#pragma unroll
  for (int g = 0; g < ATTN_MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[g][i] = 0.f;
      qf[g][i] = g < G ? to_f(q[((size_t)b * Hq + kvh * G + g) * D +
                                lane * DPL + i])
                       : 0.f;
    }
  }

  // (layer, b, kvh) selects one row of S slots
  const size_t row = ((size_t)layer * B + b) * Hkv + kvh;
  const KV* kb = k_slabs + row * S * D + lane * DPL;
  const KV* vb = v_slabs + row * S * D + lane * DPL;
  for (int s = lo + warp; s < hi; s += ATTN_WARPS) {
    float kf[DPL], vf[DPL];
    load_lane<KV, DPL>(kb + (size_t)s * D, kf);
    load_lane<KV, DPL>(vb + (size_t)s * D, vf);
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = __ldg(k_scales + row * S + s);
      vs = __ldg(v_scales + row * S + s);
    }
#pragma unroll
    for (int g = 0; g < ATTN_MAXG; ++g) {
      if (g < G) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot = fmaf(qf[g][i], kf[i], dot);
        float sc = warp_sum(dot) * scale;
        if constexpr (kQuant) sc *= ks;  // the K scale, on the raw score
        const float mn = fmaxf(m[g], sc);
        const float corr = expf(m[g] - mn);
        const float p = expf(sc - mn);
        l[g] = l[g] * corr + p;  // the softmax sum: unscaled p
        const float pv = kQuant ? p * vs : p;  // the V scale
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * corr + pv * vf[i];
        m[g] = mn;
      }
    }
  }

  __shared__ float sm_m[ATTN_WARPS][ATTN_MAXG], sm_l[ATTN_WARPS][ATTN_MAXG];
  __shared__ float sm_acc[ATTN_WARPS][ATTN_MAXG][D];
#pragma unroll
  for (int g = 0; g < ATTN_MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][g][lane * DPL + i] = acc[g][i];
    }
  }
  __syncthreads();
  // warp 0 walked slot `lo`, so mx is finite; warps that saw no slot
  // (a chunk shorter than ATTN_WARPS slots) keep max = -inf and are skipped
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
    for (int w = 0; w < ATTN_WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f, s = 0.f;
    for (int w = 0; w < ATTN_WARPS; ++w) {
      if (sm_m[w][g] == -INFINITY) continue;
      const float e = expf(sm_m[w][g] - mx);
      a += sm_acc[w][g][d] * e;
      s += sm_l[w][g] * e;
    }
    float* part = part0 + g * head_stride;
    part[2 + d] = a;
    if (d == 0) {
      part[0] = mx;
      part[1] = s;
    }
  }
}

// One block of D threads per (query head, example): the self score, then
// the partials of every split folded in, divided once, rounded to T.
template <typename T>
__global__ void attn_merge_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k_self,
                                  const T* __restrict__ v_self,
                                  const float* __restrict__ ws,
                                  T* __restrict__ out, int nsplit, int Hq,
                                  int Hkv, float scale) {
  __shared__ float sbuf[32];
  const int D = blockDim.x;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = h / (Hq / Hkv);
  const float qv = to_f(q[((size_t)b * Hq + h) * D + d]);
  const float kv = to_f(k_self[((size_t)b * Hkv + kvh) * D + d]);
  const float s_self = block_sum(qv * kv, sbuf, d, D) * scale;
  const float* part = ws + (size_t)(b * Hq + h) * nsplit * (D + 2);
  float mx = s_self;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, part[(size_t)i * (D + 2)]);
  const float p_self = expf(s_self - mx);
  float s = p_self;
  float a = p_self * to_f(v_self[((size_t)b * Hkv + kvh) * D + d]);
  for (int i = 0; i < nsplit; ++i) {
    const float* pi = part + (size_t)i * (D + 2);
    if (pi[0] == -INFINITY) continue;  // empty split: acc never written
    const float e = expf(pi[0] - mx);
    s += pi[1] * e;
    a += pi[2 + d] * e;
  }
  out[((size_t)b * Hq + h) * D + d] = from_f<T>(a / fmaxf(s, 1e-30f));
}

// q (B, Hq, D); k/v_slabs (L, B, Hkv, S, D) of KV (T, or int8_t with
// k/v_scales (L, B, Hkv, S) float32); k/v_self (B, Hkv, D); start/end (B,)
// int32 on the device; out (B, Hq, D);
// ws >= B * Hq * attn_num_splits(S) * (D + 2) floats.
template <typename T, typename KV>
cudaError_t launch_decode_attention(const T* q, const KV* k_slabs,
                                    const KV* v_slabs, const float* k_scales,
                                    const float* v_scales, const T* k_self,
                                    const T* v_self, const int* start,
                                    const int* end, T* out, float* ws,
                                    int layer, int B, int Hq, int Hkv, int S,
                                    int D, float scale, cudaStream_t stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > ATTN_MAXG) {
    return cudaErrorInvalidValue;
  }
  if (std::is_same<KV, int8_t>::value &&
      (k_scales == nullptr || v_scales == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int nsplit = attn_num_splits(S);
  const dim3 grid(nsplit, Hkv, B);
  if (D == 128) {
    attn_split_kernel<T, KV, 4><<<grid, ATTN_WARPS * 32, 0, stream>>>(
        q, k_slabs, v_slabs, k_scales, v_scales, start, end, ws, layer, B,
        Hq, Hkv, S, scale);
  } else if (D == 64) {
    attn_split_kernel<T, KV, 2><<<grid, ATTN_WARPS * 32, 0, stream>>>(
        q, k_slabs, v_slabs, k_scales, v_scales, start, end, ws, layer, B,
        Hq, Hkv, S, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_merge_kernel<T><<<dim3(Hq, B), D, 0, stream>>>(
      q, k_self, v_self, ws, out, nsplit, Hq, Hkv, scale);
  return cudaGetLastError();
}
