// Online-softmax ("flash") attention for prefill: the CUDA counterpart of
// the Pallas kernel qwen3_asr_rs_tpu/ops/pallas/flash_attention.py::
// flash_attention. Causal, kv_valid (keys >= kv_valid[b] masked) and
// kv_start (keys < kv_start[b] masked) masks, GQA query head h reading kv
// head h / G, and the (Sq, Sk) score matrix never leaves the block.
//
// Numerics follow the Pallas kernel: QK^T products of T values accumulate
// in float32 and are then scaled, masked scores become -1e9 (rows stay
// NaN-free), the running max starts at -1e30, the softmax sum takes the
// float32 probabilities, the PV product takes them rounded to T, and the
// output divides by max(l, 1e-30) once at the end.
//
// What bounds it on the H100: arithmetic. A causal prefill at 4736 tokens,
// 16 heads, D = 128 is ~92 GFLOP per layer: 0.093 ms at the bf16
// tensor-core peak (989 TFLOP/s), 1.37 ms at the float32 CUDA-core peak
// (67 TFLOP/s). Each dtype takes its own path:
//
// bf16 (flash_mma_kernel, the serving path): both products on the tensor
// cores with mma.sync.m16n8k16 (bf16 in, float32 accumulate).
// - A block of 4 warps owns 64 (query row, head) pairs: 32 rows of the
//   two query heads that share a kv head when G is even (each K/V tile is
//   loaded once for both), else 64 rows of one head. Each warp owns 16
//   rows; its Q fragments stay in registers for the whole key loop. Two
//   blocks share an SM (212 registers a thread), so one block's softmax
//   overlaps the other's products (8 warps in one block ran 4% slower).
// - 64-key K/V tiles stay bf16 in shared memory, in rows of 16-byte
//   chunks XOR-swizzled by the row (chunk c of row r at c ^ (r & 7)), so
//   the ldmatrix reads (plain for K, transposed for V) are free of bank
//   conflicts. They arrive by 16-byte cp.async into a 2-stage ring: the
//   next tile loads while this one is computed.
// - S = Q K^T accumulates in float32 registers; the softmax runs on them
//   in place (max and sum over the 4 lanes that share a row; the scale
//   folds into the exponent's FMA, so it needs scale > 0), and P goes
//   from the S accumulators straight into the A operand of the P V
//   product, rounded to bf16, never through shared memory.
// - Blocks are launched longest-first (the causal q-tiles nearest the
//   end first), so the last wave is not one long diagonal tile. Key tiles
//   wholly above the diagonal, at or past kv_valid[b] or before
//   kv_start[b] are never loaded; only tiles that straddle a boundary are
//   masked, and a warp skips a tile that lies wholly above its own rows.
// - What holds it back: every warp reads the whole K and V tile from
//   shared memory for its 16 rows (32 KB per 64-key tile at D = 128), so
//   shared-memory bandwidth (128 B per clock per SM), not the tensor
//   cores, sets its ceiling near half the bf16 peak. wgmma (64-row
//   warpgroup tiles reading K/V from shared memory inside the tensor
//   core) with TMA loads and a producer warp is the way past it.
//
// float32 (flash_kernel, the parity mode): the products stay on the CUDA
// cores in full float32 (TF32 would keep ~3 decimal digits against the
// 1e-4 the parity tests hold it to). One block of 256 threads per
// (64-query tile, query head, example) looping over 64-key tiles; Q, K, V
// and P tiles in shared memory as float32; each thread owns a 4x4
// micro-tile of the scores and a 4 x D/16 slice of the output.
#include "common.cuh"

namespace {  // internal linkage, as in decode_attention.cuh

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;  // 16 x 16
constexpr float FA_MASK = -1e9f;
constexpr float FA_INIT_M = -1e30f;

// ---------------------------------------------------------------- float32

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

template <int D>
cudaError_t launch_flash_f32(const float* q, const float* k, const float* v,
                             const int* kv_valid, const int* kv_start,
                             float* o, int B, int Sq, int Sk, int Hq, int Hkv,
                             float scale, int causal, cudaStream_t stream) {
  static int ready = 0;
  constexpr int smem = (int)flash_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_kernel<float, D>, smem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  flash_kernel<float, D><<<grid, FA_THREADS, smem, stream>>>(
      q, k, v, kv_valid, kv_start, o, Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- bf16

constexpr int FM_WARPS = 4;  // per block; two blocks per SM
constexpr int FM_BK = 64;     // keys per tile
constexpr int FM_STAGES = 2;
constexpr float FM_LOG2E = 1.4426950408889634f;

template <int D>
constexpr int flash_mma_smem_bytes() {
  return 2 * D * (16 * FM_WARPS + FM_STAGES * 2 * FM_BK);  // Q, then K/V stages
}

// element (r, chunk c) of a swizzled [rows][D] bf16 tile
__device__ __forceinline__ int fm_at(int r, int c, int D) {
  return r * D + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx, flushing denormals: the softmax needs no more)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// HPB query heads per block (2 when G is even: they share one kv head),
// FM_WARPS warps of 16 (row, head) pairs each. Block order: the head
// groups of one q-tile together, q-tiles from the last (longest under a
// causal mask) to the first, examples inside that.
template <int D, int HPB>
__global__ void __launch_bounds__(32 * FM_WARPS, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_valid,
                 const int* __restrict__ kv_start, bf16* __restrict__ o,
                 int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                 int causal) {
  constexpr int PAIRS = 16 * FM_WARPS;  // (row, head) pairs per block
  constexpr int WPH = FM_WARPS / HPB;    // warps per head
  constexpr int QR = 16 * WPH;           // query rows per block
  constexpr int CPR = D / 8;             // 16-byte chunks per row
  constexpr int KD = D / 16;             // k16 steps over D
  constexpr int NT = FM_BK / 8;          // n8 tiles of S
  constexpr int DT = D / 8;              // n8 tiles of O
  extern __shared__ __align__(128) unsigned char fm_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fm_smem);  // [PAIRS][D]
  bf16* KVs = Qs + PAIRS * D;                   // stages x {K, V} [BK][D]

  const int ngroups = Hq / HPB, nq = (Sq + QR - 1) / QR;
  int idx = blockIdx.x;
  const int h0 = (idx % ngroups) * HPB;
  idx /= ngroups;
  const int b = idx % B, qt = nq - 1 - idx / B;
  const int kvh = h0 / (Hq / Hkv);
  const int q0 = qt * QR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hs = warp / WPH, r0 = (warp % WPH) * 16;  // warp's head, rows
  const int g = lane >> 2, t4 = lane & 3;

  const int valid = kv_valid != nullptr ? min(kv_valid[b], Sk) : Sk;
  const int kbegin = kv_start != nullptr ? max(kv_start[b], 0) : 0;
  int kend = valid;  // keys in [kbegin, kend) can be live
  if (causal) kend = min(kend, q0 + QR);
  const int kt0 = kbegin / FM_BK;
  const int kt1 = max(kt0, (kend + FM_BK - 1) / FM_BK);

  const size_t qrow = (size_t)Hq * D, krow = (size_t)Hkv * D;
  const bf16* qb = q + (size_t)b * Sq * qrow + (size_t)h0 * D;
  const bf16* kb = k + (size_t)b * Sk * krow + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * Sk * krow + (size_t)kvh * D;

  // Q: pair p = (head p / QR, row q0 + p % QR); rows past Sq are zeros
  for (int i = tid; i < PAIRS * CPR; i += 32 * FM_WARPS) {
    const int p = i / CPR, c = i % CPR, r = q0 + p % QR;
    const bool ok = r < Sq;
    cp_async16(Qs + fm_at(p, c, D),
               qb + (ok ? (size_t)r * qrow + (p / QR) * D + c * 8 : 0), ok);
  }
  cp_async_commit();
  auto load_kv = [&](int kt, int st) {
    bf16* Ks = KVs + st * 2 * FM_BK * D;
    bf16* Vs = Ks + FM_BK * D;
    for (int i = tid; i < FM_BK * CPR; i += 32 * FM_WARPS) {
      const int j = i / CPR, c = i % CPR, r = kt * FM_BK + j;
      const bool ok = r < Sk;  // V rows past Sk must be zeros, not garbage
      const size_t off = ok ? (size_t)r * krow + c * 8 : 0;
      cp_async16(Ks + fm_at(j, c, D), kb + off, ok);
      cp_async16(Vs + fm_at(j, c, D), vb + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < FM_STAGES - 1; ++s) {
    if (kt0 + s < kt1) load_kv(kt0 + s, s);
    cp_async_commit();
  }
  cp_async_wait<FM_STAGES - 1>();  // Q landed
  __syncthreads();

  unsigned qa[KD][4];
  {
    const int p = hs * QR + r0 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldsm_x4(qa[kk], Qs + fm_at(p, 2 * kk + (lane >> 4), D));
  }

  const float sl2 = scale * FM_LOG2E;  // raw score -> log2 units
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  float m_a = FA_INIT_M, m_b = FA_INIT_M, l_a = 0.f, l_b = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    cp_async_wait<FM_STAGES - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 is no longer read
    if (kt + FM_STAGES - 1 < kt1) load_kv(kt + FM_STAGES - 1, (i + FM_STAGES - 1) % FM_STAGES);
    cp_async_commit();
    const int k0 = kt * FM_BK;
    // a tile wholly above this warp's rows contributes nothing to them
    if (causal && k0 > q0 + r0 + 15) continue;
    const bf16* Ks = KVs + (i % FM_STAGES) * 2 * FM_BK * D;
    const bf16* Vs = Ks + FM_BK * D;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned bk[4];
        ldsm_x4(bk, Ks + fm_at(16 * jp + (lane & 7) + ((lane >> 4) << 3),
                               2 * kk + ((lane >> 3) & 1), D));
        mma_bf16(s[2 * jp], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // mask only a tile that straddles a boundary (raw scores: scaling by
    // sl2 > 0 keeps the order, and the scale folds into the exponent's FMA)
    const bool edge = k0 < kbegin || k0 + FM_BK > valid ||
                      (causal && k0 + FM_BK - 1 > q0 + r0);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= valid || col < kbegin || (causal && col > row)) {
            s[j][e] = FA_MASK;
          }
        }
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * sl2), mn_b = fmaxf(m_b, mx_b * sl2);
    const float corr_a = fast_exp2(m_a - mn_a), corr_b = fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    unsigned pa[FM_BK / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = fast_exp2(fmaf(s[j][0], sl2, -mn_a));
      const float p1 = fast_exp2(fmaf(s[j][1], sl2, -mn_a));
      const float p2 = fast_exp2(fmaf(s[j][2], sl2, -mn_b));
      const float p3 = fast_exp2(fmaf(s[j][3], sl2, -mn_b));
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      // the C fragments of n-tiles 2kk, 2kk + 1 are the A fragment of k-step kk
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * corr_a + sum_a;  // this thread's columns; summed at the end
    l_b = l_b * corr_b + sum_b;
    // rescale only when some row of the warp moved its running max
    if (__any_sync(0xffffffffu, corr_a != 1.f || corr_b != 1.f)) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= corr_a;
        acc[j][1] *= corr_a;
        acc[j][2] *= corr_b;
        acc[j][3] *= corr_b;
      }
    }
#pragma unroll
    for (int kk = 0; kk < FM_BK / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < DT / 2; ++jp) {
        unsigned bv[4];
        ldsm_x4_t(bv, Vs + fm_at(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                 2 * jp + (lane >> 4), D));
        mma_bf16(acc[2 * jp], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * jp + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  bf16* ob = o + ((size_t)b * Sq * Hq + h0 + hs) * D + 2 * t4;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (row_a < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * Hq * D + 8 * j) =
          __floats2bfloat162_rn(acc[j][0] / den_a, acc[j][1] / den_a);
    }
    if (row_b < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * Hq * D + 8 * j) =
          __floats2bfloat162_rn(acc[j][2] / den_b, acc[j][3] / den_b);
    }
  }
}

template <int D, int HPB>
cudaError_t launch_flash_mma(const bf16* q, const bf16* k, const bf16* v,
                             const int* kv_valid, const int* kv_start,
                             bf16* o, int B, int Sq, int Sk, int Hq, int Hkv,
                             float scale, int causal, cudaStream_t stream) {
  static int ready = 0;
  constexpr int smem = flash_mma_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_mma_kernel<D, HPB>, smem, &ready);
  if (err != cudaSuccess) return err;
  constexpr int QR = 16 * (FM_WARPS / HPB);
  const long long blocks = (long long)B * (Hq / HPB) * ((Sq + QR - 1) / QR);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_mma_kernel<D, HPB><<<(unsigned)blocks, 32 * FM_WARPS, smem, stream>>>(
      q, k, v, kv_valid, kv_start, o, B, Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_flash_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const int* kv_valid, const int* kv_start,
                              bf16* o, int B, int Sq, int Sk, int Hq, int Hkv,
                              float scale, int causal, cudaStream_t stream) {
  if (!(scale > 0.f)) return cudaErrorInvalidValue;
  if ((Hq / Hkv) % 2 == 0) {
    return launch_flash_mma<D, 2>(q, k, v, kv_valid, kv_start, o, B, Sq, Sk,
                                  Hq, Hkv, scale, causal, stream);
  }
  return launch_flash_mma<D, 1>(q, k, v, kv_valid, kv_start, o, B, Sq, Sk,
                                Hq, Hkv, scale, causal, stream);
}

}  // namespace

// q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); o (B, Sq, Hq, D); kv_valid and
// kv_start are (B,) int32 device arrays or null. bf16 runs on the tensor
// cores, float32 on the CUDA cores.
#define FLASH_ENTRY(NAME, T, LAUNCH)                                         \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* kv_valid, const void* kv_start, void* o,   \
                      int B, int Sq, int Sk, int Hq, int Hkv, int D,         \
                      float scale, int causal, void* stream) {               \
    if (B < 1 || Sq < 1 || Hkv <= 0 || Hq % Hkv != 0) {                      \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    }                                                                        \
    const T* qq = static_cast<const T*>(q);                                  \
    const T* kk = static_cast<const T*>(k);                                  \
    const T* vv = static_cast<const T*>(v);                                  \
    const int* kvv = static_cast<const int*>(kv_valid);                      \
    const int* kvs = static_cast<const int*>(kv_start);                      \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    if (D == 128) {                                                          \
      return static_cast<int>(LAUNCH<128>(qq, kk, vv, kvv, kvs,              \
                                          static_cast<T*>(o), B, Sq, Sk, Hq, \
                                          Hkv, scale, causal, st));          \
    }                                                                        \
    if (D == 64) {                                                           \
      return static_cast<int>(LAUNCH<64>(qq, kk, vv, kvv, kvs,               \
                                         static_cast<T*>(o), B, Sq, Sk, Hq,  \
                                         Hkv, scale, causal, st));           \
    }                                                                        \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }

FLASH_ENTRY(flash_attention_bf16, bf16, launch_flash_bf16)
FLASH_ENTRY(flash_attention_f32, float, launch_flash_f32)
