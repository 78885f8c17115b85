// The sampled token of a decode step: jax.random.categorical on float32
// logits, drawn from JAX's own threefry stream, in one launch.
//
// Not a TPU kernel: the JAX package leaves its draw to XLA
// (qwen3_asr_rs_tpu/runtime/sampling.py::sample_token ->
// jax.random.categorical). Its plain PyTorch version is
// ops/prng.py::categorical.
//
// x (B, V) float32, row stride ld: the scaled, filtered logits. The key is
// derived in registers from a base key on the device and up to four
// fold_in data applied in order, each a device counter (or none) plus a
// constant; with `split` the draw takes fold_in(key, 1) and the last block
// sets the base key to fold_in(key, 0) (JAX's `key, sub = split(key)`).
// Row r draws as row g = rows[r] (rows given) or row_offset + r of the
// whole array: element (r, c) takes bits = y0 ^ y1 of threefry2x32(key,
// (hi, lo)), (hi, lo) the words of the flat index g * V + c, as JAX's
// partitionable random bits do. u = max(tiny, f + tiny), f the top 23
// bits as a float in [1, 2) minus 1 (JAX's uniform on [tiny, 1)); the
// noise is -logf(-logf(u)) (IEEE logf: the build sets no fast math), and
// out[r] = argmax over c of x[r, c] + noise, ties to the lowest index.
//
// What bounds it on the H100: the integer work of threefry (20 rounds of
// an add, a rotate and a xor, 5 key injections: about 110 operations an
// element) and two logf, against a read of 4 bytes an element (B = 8,
// V = 151,936: 4.9 MB, 1.5 us at 3.35 TB/s). The design: one pass over the
// logits; a block of 256 threads takes 1024 columns of one row, each thread
// 4 columns 256 apart (coalesced loads), with the key and its counters in
// registers; the block's best (value, index) goes into a 64-bit atomicMax
// per row (the key of decode_layer.cu's folded lm_head); the last block to
// finish (a ticket) writes each row's token, resets the per-row keys and
// the ticket to 0 for the next launch, and advances the base key when
// `split`. So a step in a CUDA graph derives its key, draws and, in
// serving, moves the pool's key chain, in this one launch.
#include "common.cuh"

namespace {

constexpr int GA_THREADS = 256;
constexpr int GA_ITEMS = 4;
constexpr int GA_COLS = GA_THREADS * GA_ITEMS;
constexpr int MAX_CHAIN = 4;
constexpr float F32_TINY = 1.17549435e-38f;

struct Chain {
  const long long* key;             // (2,) int64: the base key's words
  const long long* ctr[MAX_CHAIN];  // device counters, or null for 0
  long long add[MAX_CHAIN];         // added to each counter
  int n;                            // fold_in data applied in order
  int split;
};

__device__ __forceinline__ void tf_round(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

// threefry2x32 (20 rounds), as JAX's _threefry2x32_lowering
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  tf_round(x0, x1, 17); tf_round(x0, x1, 29);
  tf_round(x0, x1, 16); tf_round(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  tf_round(x0, x1, 17); tf_round(x0, x1, 29);
  tf_round(x0, x1, 16); tf_round(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
}

// fold_in(key, d) = threefry2x32(key, (0, d))
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry(k0, k1, x0, x1);
  k0 = x0; k1 = x1;
}

// The draw's key: the base key with the chain's data folded in, then
// fold_in(., 1) under `split`.
__device__ __forceinline__ void chain_key(const Chain& c, uint32_t& k0,
                                          uint32_t& k1) {
  k0 = (uint32_t)c.key[0];
  k1 = (uint32_t)c.key[1];
#pragma unroll
  for (int i = 0; i < MAX_CHAIN; ++i) {  // unrolled: the chain stays in
    if (i < c.n) {                       // registers, not on the stack
      const long long v =
          (c.ctr[i] != nullptr ? *c.ctr[i] : 0ll) + c.add[i];
      fold_in(k0, k1, (uint32_t)v);
    }
  }
  if (c.split) fold_in(k0, k1, 1u);
}

__device__ __forceinline__ uint32_t element_bits(uint32_t k0, uint32_t k1,
                                                 unsigned long long flat) {
  uint32_t x0 = (uint32_t)(flat >> 32), x1 = (uint32_t)flat;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

// JAX's float32 uniform on [minval, 1): max(minval, f * (1 - minval) +
// minval); 1 - minval rounds to 1 for minval in {0, tiny}
__device__ __forceinline__ float uniform_of(uint32_t bits, float minval) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(minval, __fadd_rn(f, minval));
}

__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  return -logf(-logf(uniform_of(bits, F32_TINY)));
}

// A 64-bit key whose unsigned order is the order of (value, -index)
// (decode_layer.cu's argmax_key): ties go to the lower index.
__device__ __forceinline__ unsigned long long argmax_key(float v, int idx) {
  if (v == 0.f) v = 0.f;  // -0 ties +0, as a comparison does
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(~idx);
}

__device__ __forceinline__ long long row_index(const long long* rows,
                                               long long row_offset, int r) {
  return rows != nullptr ? rows[r] : row_offset + r;
}

__global__ void __launch_bounds__(GA_THREADS)
gumbel_argmax_kernel(const float* __restrict__ x, long long ld, int B, int V,
                     Chain chain, const long long* __restrict__ rows,
                     long long row_offset, long long* __restrict__ out,
                     unsigned long long* __restrict__ best,
                     unsigned int* __restrict__ ticket) {
  __shared__ uint32_t skey[2];
  __shared__ unsigned long long swarp[GA_THREADS / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int r = blockIdx.y;
  if (tid == 0) {
    uint32_t k0, k1;
    chain_key(chain, k0, k1);
    skey[0] = k0;
    skey[1] = k1;
  }
  __syncthreads();
  const uint32_t k0 = skey[0], k1 = skey[1];
  const unsigned long long base =
      (unsigned long long)row_index(rows, row_offset, r) * (unsigned)V;
  const float* xr = x + (long long)r * ld;
  const int c0 = blockIdx.x * GA_COLS + tid;
  unsigned long long mine = 0ull;
#pragma unroll
  for (int j = 0; j < GA_ITEMS; ++j) {
    const int c = c0 + j * GA_THREADS;
    if (c < V) {
      const float v = __ldg(xr + c) + gumbel_of(element_bits(k0, k1,
                                                             base + c));
      const unsigned long long k = argmax_key(v, c);
      mine = k > mine ? k : mine;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, mine, o);
    mine = other > mine ? other : mine;
  }
  if ((tid & 31) == 0) swarp[tid >> 5] = mine;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < GA_THREADS / 32; ++w)
      mine = swarp[w] > mine ? swarp[w] : mine;
    atomicMax(best + r, mine);
  }
  // the last block to finish writes the tokens and resets the scratch
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < B; i += GA_THREADS) {
    const unsigned long long k = atomicExch(best + i, 0ull);
    out[i] = (long long)(int)~(unsigned)(k & 0xffffffffull);
  }
  if (tid == 0) {
    *ticket = 0u;
    if (chain.split) {  // every block has read the base key by now
      uint32_t b0 = (uint32_t)chain.key[0], b1 = (uint32_t)chain.key[1];
      fold_in(b0, b1, 0u);
      long long* key = const_cast<long long*>(chain.key);
      key[0] = b0;
      key[1] = b1;
    }
  }
}

// The draw's noise (B, V), for the checks and for the acceptance
// uniforms of speculative sampling: mode 0 the bits (int64), 1 uniform
// on [0, 1), 2 uniform on [tiny, 1), 3 Gumbel (float32).
__global__ void __launch_bounds__(GA_THREADS)
threefry_noise_kernel(int V, Chain chain, const long long* __restrict__ rows,
                      long long row_offset, int mode, void* out) {
  uint32_t k0, k1;
  chain_key(chain, k0, k1);
  const int r = blockIdx.y;
  const unsigned long long base =
      (unsigned long long)row_index(rows, row_offset, r) * (unsigned)V;
  const int c0 = blockIdx.x * GA_COLS + threadIdx.x;
#pragma unroll
  for (int j = 0; j < GA_ITEMS; ++j) {
    const int c = c0 + j * GA_THREADS;
    if (c >= V) continue;
    const uint32_t bits = element_bits(k0, k1, base + c);
    const long long at = (long long)r * V + c;
    if (mode == 0) {
      static_cast<long long*>(out)[at] = bits;
    } else {
      static_cast<float*>(out)[at] =
          mode == 1 ? uniform_of(bits, 0.0f)
                    : mode == 2 ? uniform_of(bits, F32_TINY) : gumbel_of(bits);
    }
  }
}

Chain make_chain(const void* key, const void* c0, const void* c1,
                 const void* c2, const void* c3, long long a0, long long a1,
                 long long a2, long long a3, int n, int split) {
  Chain c;
  c.key = static_cast<const long long*>(key);
  const void* ctr[MAX_CHAIN] = {c0, c1, c2, c3};
  const long long add[MAX_CHAIN] = {a0, a1, a2, a3};
  for (int i = 0; i < MAX_CHAIN; ++i) {
    c.ctr[i] = static_cast<const long long*>(ctr[i]);
    c.add[i] = add[i];
  }
  c.n = n;
  c.split = split;
  return c;
}

}  // namespace

extern "C" int gumbel_argmax(const void* x, const void* key, const void* c0,
                             const void* c1, const void* c2, const void* c3,
                             const void* rows, void* out, void* best,
                             void* ticket, long long ld, int B, int V,
                             long long a0, long long a1, long long a2,
                             long long a3, int n, int split,
                             long long row_offset, void* stream) {
  if (B < 1 || B > 65535 || V < 1 || n < 0 || n > MAX_CHAIN)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((V + GA_COLS - 1) / GA_COLS, B);
  gumbel_argmax_kernel<<<grid, GA_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ld, B, V,
      make_chain(key, c0, c1, c2, c3, a0, a1, a2, a3, n, split),
      static_cast<const long long*>(rows), row_offset,
      static_cast<long long*>(out), static_cast<unsigned long long*>(best),
      static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_noise(const void* key, const void* c0, const void* c1,
                              const void* c2, const void* c3,
                              const void* rows, void* out, int B, int V,
                              long long a0, long long a1, long long a2,
                              long long a3, int n, long long row_offset,
                              int mode, void* stream) {
  if (B < 1 || B > 65535 || V < 1 || n < 0 || n > MAX_CHAIN || mode < 0 ||
      mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((V + GA_COLS - 1) / GA_COLS, B);
  threefry_noise_kernel<<<grid, GA_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      V, make_chain(key, c0, c1, c2, c3, a0, a1, a2, a3, n, 0),
      static_cast<const long long*>(rows), row_offset, mode, out);
  return static_cast<int>(cudaGetLastError());
}
