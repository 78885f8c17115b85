// Decode attention over the stacked KV slab: one query token per example,
// GQA, live slots [start_b, end_b) of layer `layer`, plus the fresh self
// key/value as one extra key. The CUDA counterpart of the Pallas kernel
// qwen3_asr_rs_tpu/ops/pallas/decode_attention.py::decode_attention_dma
// (its bf16/f32 and int8-KV slab modes). Used alone (decode_attention.cu,
// also by decode_attention_slab) and as the attention stage of the decode
// step (decode_layer.cu).
//
// What bounds it on the H100: the live K/V bytes of one layer (at B = 8,
// 4737 live slots, 8 kv heads, D = 128, bf16: ~150 MB, 45 us at 3.35
// TB/s; half in int8). The design streams them from every SM in one
// launch:
//
// - One launch per layer. Block (split, kv head, example) takes the G
//   query heads of one kv head over one chunk of slots, so each K/V row
//   is read once for all G heads, and only the part of the chunk inside
//   [start_b, end_b) is read (a chunk outside it reads nothing). The
//   chunk length comes from the shapes (attn_chunk, mirrored in Python by
//   ops/kernels/decode_attention.py::split_chunk): as many splits as keep
//   splits x Hkv x B within two waves of the 132 SMs (264 blocks, which
//   two resident bf16 blocks per SM run as one round, so no block waits
//   for a second round), never under 64 slots.
// - The chunk streams through a ring of 64-slot K/V tiles in shared
//   memory (3 stages, 2 for float32 slabs), fed by 16-byte cp.async
//   copies: two tiles (64 KB in bf16 at D = 128) are in flight while a
//   third is scored. The rows sit in 16-byte chunks XOR-swizzled by the
//   slot, so the column reads below are free of bank conflicts.
// - Each tile is scored at once by 256 threads: four per slot (each takes
//   every fourth 16-byte chunk of D, the query heads in shared memory as
//   float32), then one online-softmax update per head and tile (warp g
//   for head g: max, exp, sum), then the PV sum with a thread per pair of
//   output dims and group of 16 slots (8 at D = 64) for every head, the
//   groups' sums added once after the last tile. All products are
//   float32 on the CUDA cores: at one query token per head there are 1 to
//   4 multiply-adds per slab byte, under the card's 10. What costs time
//   is latency: a block's tile goes through three dependent phases, so
//   the design keeps 16 warps per SM (two blocks of 8) to hide it.
// - The merge is inside the launch. Every block publishes its partial
//   (max, sum, acc[D]) per head; the last block of each (kv head,
//   example) to arrive (an atomic counter in the workspace, which the
//   kernel leaves at zero, after a __threadfence) folds them in parallel
//   over the splits: per-split weights exp(m_s - M) from a warp-wide max
//   and sum, the weighted accumulators summed by eight warps over
//   interleaved splits and reduced in shared memory. It adds the self
//   K/V term, divides once, and rounds to T. Scores and softmax are
//   float32 throughout, as in the Pallas kernel.
//
// int8 slabs (KV = int8_t) carry float32 scales per (layer, example, kv
// head, slot). As in the Pallas kernel the scales are folded instead of
// dequantizing K and V: q.(k_int8 * ks) = (q.k_int8) * ks multiplies the
// raw score, and sum_s p_s (v_int8_s * vs_s) = sum_s (p_s vs_s) v_int8_s
// the probabilities of the PV sum, while the softmax sum takes the
// unscaled p. Only live slots are ever scored here, so a dead slot's
// scale (0 in a fresh slab) cannot unmask it. The self K/V stay in T.
#pragma once

#include <type_traits>

#include "common.cuh"

// Internal linkage: decode_attention.cu and decode_layer.cu each build
// their own library, and a template's function-local static (the
// shared-memory flag in launch_decode_attention) would otherwise be one
// process-wide unique symbol shared by both libraries' kernels.
namespace {

constexpr int ATTN_WARPS = 8;
constexpr int ATTN_THREADS = 32 * ATTN_WARPS;
constexpr int ATTN_MAXG = 8;         // query heads per kv head (a warp each)
constexpr int ATTN_TILE = 64;        // slab slots per shared-memory tile
constexpr int ATTN_MIN_CHUNK = 64;   // slots per split, at least
// The H100 SXM's SM count, the one card this port is built and tuned for
// (sm_90a). The split rule assumes it: two waves of its SMs are the blocks
// two bf16 K/V rings per SM hold at once, so the whole grid runs as one
// round. On a card with fewer SMs (the H100 PCIe has 114) the grid is
// still correct and takes a second, partial round.
constexpr int ATTN_SMS = 132;
constexpr int ATTN_TARGET_BLOCKS = 2 * ATTN_SMS;

// The split rule: slots per split for B examples and Hkv kv heads over an
// S-slot slab; a multiple of ATTN_MIN_CHUNK. The kernel's C entry, the
// decode step and the workspace sizes all take it from here.
inline int attn_chunk(int B, int Hkv, int S) {
  const int cols = B * Hkv;
  const int splits = cols < ATTN_TARGET_BLOCKS ? ATTN_TARGET_BLOCKS / cols : 1;
  int chunk = (S + splits - 1) / splits;
  chunk = (chunk + ATTN_MIN_CHUNK - 1) / ATTN_MIN_CHUNK * ATTN_MIN_CHUNK;
  return chunk < ATTN_MIN_CHUNK ? ATTN_MIN_CHUNK : chunk;
}

inline int attn_num_splits(int B, int Hkv, int S) {
  const int chunk = attn_chunk(B, Hkv, S);
  return (S + chunk - 1) / chunk;
}

// 4-byte words of the launch's workspace: per (example, query head,
// split) the partial acc[D], then its (max, sum), then one int32 counter
// per (example, kv head), which must be zero before the first launch (the
// kernel leaves it zero).
inline long long attn_workspace_words(int B, int Hq, int Hkv, int S, int D) {
  const long long n = (long long)B * Hq * attn_num_splits(B, Hkv, S);
  return n * D + 2 * n + (long long)B * Hkv;
}

// Shared-memory geometry of one slab type and head dim.
template <typename KV, int D>
struct AttnGeom {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int STAGES = sizeof(KV) == 4 ? 2 : 3;
  static constexpr int ROW = D * (int)sizeof(KV);  // bytes per slot row
  static constexpr int CPR = ROW / 16;             // 16-byte chunks per row
  static constexpr int EPC = 16 / (int)sizeof(KV); // elements per chunk
  static constexpr int SWZ = CPR < 8 ? CPR - 1 : 7;
  static constexpr int TILE_BYTES = ATTN_TILE * ROW;
  static constexpr int STAGE_BYTES =
      2 * TILE_BYTES + (kQuant ? 2 * ATTN_TILE * 4 : 0);
  static constexpr int RING = STAGES * STAGE_BYTES;
  // the fold's weights [G][splits] and per-warp sums [warps][G][D], floats
  // (the publish step's per-group sums, [ATTN_THREADS / (D / 2)][G][D],
  // are no larger)
  static constexpr int FOLD_MAX =
      4 * (ATTN_MAXG * ATTN_TARGET_BLOCKS + 4 + ATTN_WARPS * ATTN_MAXG * D);
  static constexpr int SMEM = RING > FOLD_MAX ? RING : FOLD_MAX;
  // byte offset of element chunk c of slot row j in a tile
  static __device__ __forceinline__ int at(int j, int c) {
    return j * ROW + ((c ^ (j & SWZ)) << 4);
  }
};

// EPC consecutive elements of one 16-byte chunk as float.
__device__ __forceinline__ void unpack16(uint4 u, const bf16*, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(uint4 u, const float*, float* out) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(uint4 u, const int8_t*, float* out) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)e[i];
}

// Two consecutive elements of a slot row as float.
__device__ __forceinline__ float2 load_pair(const unsigned char* p, const bf16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const unsigned char* p, const float*) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const unsigned char* p, const int8_t*) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

// ws layout: acc (B * Hq * nsplit, D), then (max, sum) per partial, then
// the (B * Hkv) int32 counters. k/v_scales are (L, B, Hkv, S) float32 for
// int8 slabs and null otherwise. start/end are (B,) device arrays, or
// null for start_val/end_val in every row.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_kernel(const T* __restrict__ q, const KV* __restrict__ k_slabs,
            const KV* __restrict__ v_slabs, const float* __restrict__ k_scales,
            const float* __restrict__ v_scales, const T* __restrict__ k_self,
            const T* __restrict__ v_self, const int* __restrict__ start,
            const int* __restrict__ end, int start_val, int end_val,
            T* __restrict__ out, float* __restrict__ ws, int layer, int B,
            int Hq, int Hkv, int S, int chunk, float scale) {
  using Geo = AttnGeom<KV, D>;
  constexpr bool kQuant = Geo::kQuant;
  constexpr int STAGES = Geo::STAGES, CPR = Geo::CPR, EPC = Geo::EPC;
  constexpr int SG = ATTN_THREADS / (D / 2);  // slot groups of the PV phase
  constexpr int SPG = ATTN_TILE / SG;         // slots per group and tile
  extern __shared__ __align__(16) unsigned char attn_smem[];
  __shared__ __align__(16) float q_s[ATTN_MAXG * D];
  __shared__ __align__(16) float sc[ATTN_MAXG][ATTN_TILE];  // scores, then p
  __shared__ float corr_s[ATTN_MAXG], self_w[ATTN_MAXG], l_tot[ATTN_MAXG];
  __shared__ int is_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a next kernel launched with programmatic dependent launch (K1's
  // o-projection) may start fetching its weights now; it waits for this
  // kernel's completion before it reads the output
  pdl_launch_dependents();
  // the live range is clamped to the slab: no slot outside [0, S) is read
  const int lo = max(split * chunk, start != nullptr ? start[b] : start_val);
  const int hi = min(min(split * chunk + chunk,
                         end != nullptr ? end[b] : end_val), S);
  const size_t row = ((size_t)layer * B + b) * Hkv + kvh;  // (l, b, kvh)
  const KV* kb = k_slabs + row * S * D;
  const KV* vb = v_slabs + row * S * D;
  const size_t n_part = (size_t)B * Hq * nsplit;
  float* ws_ml = ws + n_part * D;
  int* counters = reinterpret_cast<int*>(ws_ml + 2 * n_part);
  const size_t part0 = (size_t)(b * Hq + kvh * G) * nsplit;  // head g: + g * nsplit

  const int ntiles = lo < hi ? (hi - lo + ATTN_TILE - 1) / ATTN_TILE : 0;
  auto stage = [&](int s) { return attn_smem + s * Geo::STAGE_BYTES; };
  auto load_tile = [&](int i, int s) {
    unsigned char* st = stage(s);
    const int t0 = lo + i * ATTN_TILE;
    for (int idx = tid; idx < ATTN_TILE * CPR; idx += ATTN_THREADS) {
      const int j = idx / CPR, c = idx % CPR;
      const bool ok = t0 + j < hi;
      const size_t off = ok ? (size_t)(t0 + j) * D + c * EPC : 0;
      cp_async16(st + Geo::at(j, c), kb + off, ok);
      cp_async16(st + Geo::TILE_BYTES + Geo::at(j, c), vb + off, ok);
    }
    if constexpr (kQuant) {
      if (tid < 2 * ATTN_TILE) {
        float* sc_s = reinterpret_cast<float*>(st + 2 * Geo::TILE_BYTES);
        const int j = tid % ATTN_TILE;
        const bool ok = t0 + j < hi;
        const float* src = tid < ATTN_TILE ? k_scales : v_scales;
        cp_async4(sc_s + tid, src + row * S + (ok ? t0 + j : 0), ok);
      }
    }
  };

  // phase C: thread = (pair of dims dp, group sg of SPG slots per tile),
  // every head; the groups' sums are added once, after the last tile
  const int dp = tid % (D / 2), sg = tid / (D / 2);
  float acc[ATTN_MAXG][2];
#pragma unroll
  for (int g = 0; g < ATTN_MAXG; ++g) acc[g][0] = acc[g][1] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // phase B: head `warp`

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  // the query heads load while the first tiles are in flight
  for (int i = tid; i < G * D; i += ATTN_THREADS) {
    q_s[i] = to_f(q[((size_t)b * Hq + kvh * G) * D + i]);
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed; tile i - 1 is no longer read
    if (i + STAGES - 1 < ntiles) load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* st = stage(i % STAGES);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * Geo::TILE_BYTES);
    const int nvalid = min(ATTN_TILE, hi - lo - i * ATTN_TILE);

    // A: scores, four threads per slot, each over every fourth chunk of D
    {
      const int j = tid >> 2, part = tid & 3;
      float dot[ATTN_MAXG];
#pragma unroll
      for (int g = 0; g < ATTN_MAXG; ++g) dot[g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPR / 4; ++cc) {
        const int c = 4 * cc + part;
        float kf[EPC];
        unpack16(*reinterpret_cast<const uint4*>(st + Geo::at(j, c)),
                 static_cast<const KV*>(nullptr), kf);
#pragma unroll
        for (int g = 0; g < ATTN_MAXG; ++g) {
          if (g < G) {
            const float4* qg = reinterpret_cast<const float4*>(q_s + g * D + c * EPC);
#pragma unroll
            for (int e4 = 0; e4 < EPC / 4; ++e4) {
              const float4 qv = qg[e4];
              dot[g] = fmaf(qv.x, kf[4 * e4], dot[g]);
              dot[g] = fmaf(qv.y, kf[4 * e4 + 1], dot[g]);
              dot[g] = fmaf(qv.z, kf[4 * e4 + 2], dot[g]);
              dot[g] = fmaf(qv.w, kf[4 * e4 + 3], dot[g]);
            }
          }
        }
      }
      float kscale = 1.f;
      if constexpr (kQuant) kscale = ksc[j];
#pragma unroll
      for (int g = 0; g < ATTN_MAXG; ++g) {
        if (g < G) {
          float d4 = dot[g] + __shfl_xor_sync(0xffffffffu, dot[g], 1);
          d4 += __shfl_xor_sync(0xffffffffu, d4, 2);
          if ((g & 3) == part) {
            // the K scale multiplies the raw score
            sc[g][j] = j < nvalid ? d4 * scale * kscale : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // B: online softmax, warp g for head g
    if (warp < G) {
      const int g = warp;
      const float s0 = sc[g][lane], s1 = sc[g][lane + 32];
      const float mn = fmaxf(m_run, warp_max(fmaxf(s0, s1)));
      const float corr = expf(m_run - mn);  // 0 on the first tile
      float p0 = expf(s0 - mn), p1 = expf(s1 - mn);
      l_run = l_run * corr + warp_sum(p0 + p1);  // unscaled p
      m_run = mn;
      if constexpr (kQuant) {  // the V scale, on the PV probabilities
        const float* vsc = ksc + ATTN_TILE;
        p0 *= vsc[lane];
        p1 *= vsc[lane + 32];
      }
      sc[g][lane] = p0;
      sc[g][lane + 32] = p1;
      if (lane == 0) corr_s[g] = corr;
    }
    __syncthreads();

    // C: acc = acc * corr + sum_j p_j v_j over this group's slots (past
    // nvalid: p = 0 and V = 0), dims (2 dp, 2 dp + 1)
    {
      const unsigned char* vt = st + Geo::TILE_BYTES;
      const int c = (2 * dp) / EPC, cb = ((2 * dp) % EPC) * (int)sizeof(KV);
#pragma unroll
      for (int g = 0; g < ATTN_MAXG; ++g) {
        if (g < G) {
          acc[g][0] *= corr_s[g];
          acc[g][1] *= corr_s[g];
        }
      }
#pragma unroll
      for (int j0 = sg * SPG; j0 < sg * SPG + SPG; j0 += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          vv[u] = load_pair(vt + Geo::at(j0 + u, c) + cb,
                            static_cast<const KV*>(nullptr));
        }
#pragma unroll
        for (int g = 0; g < ATTN_MAXG; ++g) {
          if (g < G) {
            const float4 p = *reinterpret_cast<const float4*>(&sc[g][j0]);
            acc[g][0] = fmaf(p.x, vv[0].x, acc[g][0]);
            acc[g][1] = fmaf(p.x, vv[0].y, acc[g][1]);
            acc[g][0] = fmaf(p.y, vv[1].x, acc[g][0]);
            acc[g][1] = fmaf(p.y, vv[1].y, acc[g][1]);
            acc[g][0] = fmaf(p.z, vv[2].x, acc[g][0]);
            acc[g][1] = fmaf(p.z, vv[2].y, acc[g][1]);
            acc[g][0] = fmaf(p.w, vv[3].x, acc[g][0]);
            acc[g][1] = fmaf(p.w, vv[3].y, acc[g][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // publish this split's partial per head (the slot groups' sums added in
  // group order); an empty split stores max = -inf
  float* red = reinterpret_cast<float*>(attn_smem);  // [SG][G][D], then the fold's
  if (ntiles > 0) {
    __syncthreads();  // the ring is no longer read
#pragma unroll
    for (int g = 0; g < ATTN_MAXG; ++g) {
      if (g < G) {
        red[(sg * G + g) * D + 2 * dp] = acc[g][0];
        red[(sg * G + g) * D + 2 * dp + 1] = acc[g][1];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * D; idx += ATTN_THREADS) {
      const int g = idx / D, d = idx % D;
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < SG; ++s) a += red[(s * G + g) * D + d];
      ws[(part0 + (size_t)g * nsplit + split) * D + d] = a;
    }
  }
  if (warp < G && lane == 0) {
    float* ml = ws_ml + 2 * (part0 + (size_t)warp * nsplit + split);
    ml[0] = m_run;  // -inf when the split held no live slot
    ml[1] = l_run;
  }

  // the last block of this (kv head, example) to arrive folds the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[b * Hkv + kvh], 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  float* wt = reinterpret_cast<float*>(attn_smem);  // [G][nsplit]
  red = wt + ((G * nsplit + 3) & ~3);               // [ATTN_WARPS][G][D]
  const size_t self0 = ((size_t)b * Hkv + kvh) * D;
  // per head (warp g): the self score, the max over splits and self, the
  // split weights exp(m_s - M) and the total softmax sum
  if (warp < G) {
    const int g = warp;
    float sd = 0.f;
    for (int d = lane; d < D; d += 32) sd += q_s[g * D + d] * to_f(k_self[self0 + d]);
    const float s_self = warp_sum(sd) * scale;
    const float* ml = ws_ml + 2 * (part0 + (size_t)g * nsplit);
    float mx = s_self;
    for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float ms = __ldcg(ml + 2 * s);
      // an empty split (max -inf) has no acc: weight 0, never read
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      wt[g * nsplit + s] = w;
      lsum += w == 0.f ? 0.f : w * __ldcg(ml + 2 * s + 1);
    }
    const float p_self = expf(s_self - mx);
    lsum = warp_sum(lsum) + p_self;
    if (lane == 0) {
      self_w[g] = p_self;
      l_tot[g] = lsum;
    }
  }
  __syncthreads();
  // weighted accumulators: warp w sums splits w, w + ATTN_WARPS, ...; a
  // lane holds D / 32 dims
  constexpr int DPL = D / 32;
  for (int g = 0; g < G; ++g) {
    float a[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) a[e] = 0.f;
    for (int s = warp; s < nsplit; s += ATTN_WARPS) {
      const float w = wt[g * nsplit + s];
      if (w == 0.f) continue;
      const float* src = ws + (part0 + (size_t)g * nsplit + s) * D + lane * DPL;
      if constexpr (DPL == 4) {
        const float4 v4 = __ldcg(reinterpret_cast<const float4*>(src));
        a[0] = fmaf(w, v4.x, a[0]); a[1] = fmaf(w, v4.y, a[1]);
        a[2] = fmaf(w, v4.z, a[2]); a[3] = fmaf(w, v4.w, a[3]);
      } else {
        const float2 v2 = __ldcg(reinterpret_cast<const float2*>(src));
        a[0] = fmaf(w, v2.x, a[0]); a[1] = fmaf(w, v2.y, a[1]);
      }
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) red[(warp * G + g) * D + lane * DPL + e] = a[e];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += ATTN_THREADS) {
    const int g = idx / D, d = idx % D;
    float tot = self_w[g] * to_f(v_self[self0 + d]);
#pragma unroll
    for (int w = 0; w < ATTN_WARPS; ++w) tot += red[(w * G + g) * D + d];
    out[((size_t)b * Hq + kvh * G + g) * D + d] =
        from_f<T>(tot / fmaxf(l_tot[g], 1e-30f));
  }
  if (tid == 0) counters[b * Hkv + kvh] = 0;
}

// q (B, Hq, D); k/v_slabs (L, B, Hkv, S, D) of KV (T, or int8_t with
// k/v_scales (L, B, Hkv, S) float32); k/v_self (B, Hkv, D); start/end (B,)
// int32 on the device, or null for start_val/end_val in every row; out
// (B, Hq, D); ws >= attn_workspace_words(B, Hq, Hkv, S, D) 4-byte words,
// its counters zero. One kernel launch.
template <typename T, typename KV>
cudaError_t launch_decode_attention(const T* q, const KV* k_slabs,
                                    const KV* v_slabs, const float* k_scales,
                                    const float* v_scales, const T* k_self,
                                    const T* v_self, const int* start,
                                    const int* end, int start_val, int end_val,
                                    T* out, float* ws, int layer, int B,
                                    int Hq, int Hkv, int S, int D,
                                    float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > ATTN_MAXG) {
    return cudaErrorInvalidValue;
  }
  if (std::is_same<KV, int8_t>::value &&
      (k_scales == nullptr || v_scales == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int chunk = attn_chunk(B, Hkv, S);
  const dim3 grid((S + chunk - 1) / chunk, Hkv, B);
  cudaError_t err;
#define ATTN_LAUNCH(DIM)                                                      \
  {                                                                           \
    static int ready = 0;                                                     \
    auto kernel = attn_kernel<T, KV, DIM>;                                    \
    constexpr int smem = AttnGeom<KV, DIM>::SMEM;                             \
    if ((err = allow_smem(kernel, smem, &ready)) != cudaSuccess) return err;  \
    kernel<<<grid, ATTN_THREADS, smem, stream>>>(                             \
        q, k_slabs, v_slabs, k_scales, v_scales, k_self, v_self, start, end,  \
        start_val, end_val, out, ws, layer, B, Hq, Hkv, S, chunk, scale);     \
  }
  if (D == 128) {
    ATTN_LAUNCH(128)
  } else if (D == 64) {
    ATTN_LAUNCH(64)
  } else {
    return cudaErrorInvalidValue;
  }
#undef ATTN_LAUNCH
  return cudaGetLastError();
}

}  // namespace
