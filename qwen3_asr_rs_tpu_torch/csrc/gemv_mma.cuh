// Tensor-core GEMV building blocks for bf16 activations, shared by K1's
// GEMVs (decode_layer.cu) and K4 (quant_matvec_int4.cu).
//
// y (rows, N) = x (rows, K) @ W (K, N) with rows <= 32 runs as
// mma.sync.m16n8k16 with the operands swapped: 16 output columns form the
// M side (the A operand, from the weight tile in shared memory), up to 8
// batch rows the N side (the B operand, from x staged in shared memory as
// bf16; B = 1 pads to 8, which costs nothing at this intensity), and the
// accumulators are float32. bf16 weights reach the A operand by
// ldmatrix.trans; int8 and int4 weights are converted to bf16 in registers,
// which is exact (int8 through float32, int4 through the 0x4300 | nibble
// bf16 pattern minus 136). Products of bf16 x and exact bf16 weights are
// exact in float32, so against a CUDA-core GEMV only the order of the
// float32 summation changes.
//
// A block of GM_THREADS threads owns GM_TN loaded columns (16 per warp)
// and one K range; it streams that range of the weight through a ring of
// GM_STAGES stages of GM_KS rows, each stage one cp.async group of 16-byte
// copies coalesced along the columns. Each warp covers the whole K range
// of its 16 columns, so a (row, column) partial is one float32 sum in K
// order. Weights do not depend on the previous kernel: a caller launched
// with programmatic dependent launch starts the first stages before it
// waits for its inputs (pdl_wait).
#pragma once

#include "common.cuh"

// How a weight is stored: T; int8 with per-column float32 scales; or
// int4, two per byte, where the byte at packed column j of a (K, N/2) row
// holds column j (low nibble) and column j + N/2 (high nibble), with
// per-column scales over the N unpacked columns (W_INT4) or (G, N) scales
// per group of K / G rows and column (W_INT4G).
enum WeightKind { W_FLOAT = 0, W_INT8 = 1, W_INT4 = 2, W_INT4G = 3 };

__host__ __device__ constexpr bool is_int4(int wk) {
  return wk == W_INT4 || wk == W_INT4G;
}

namespace {

constexpr int GM_WARPS = 4;
constexpr int GM_THREADS = 32 * GM_WARPS;
constexpr int GM_TN = 16 * GM_WARPS;  // loaded columns per block
constexpr int GM_KS = 64;             // weight rows per stage
constexpr int GM_STAGES = 4;
constexpr int GM_HROW = 2 * GM_TN;    // bytes per row of a bf16 tile (swizzled)
constexpr int GM_BROW = GM_TN + 16;   // bytes per row of a byte tile (padded)
constexpr int GM_XPAD = 8;            // bf16 padding per staged x row
// Blocks a GEMV launch aims at: two per SM of the H100 SXM's 132.
constexpr int GM_TARGET_BLOCKS = 264;
// Rows x splits the last block of a column tile adds at most (its
// reduction is serial in the splits: at 32 rows, 8 splits; measured best
// of 128, 256 and no cap at B = 8 and 32, PERF.md)
constexpr int GM_EPI_ROWS = 256;
// Largest staged x (8 * NB8 rows of bf16) the K split allows, bytes: 32
// rows of 1024 columns and their padding.
constexpr int GM_XS_MAX = 68 * 1024;

template <int WK>
__host__ __device__ constexpr int gm_stage_bytes() {
  return GM_KS * (WK == W_FLOAT ? GM_HROW : GM_BROW);
}

// Copy rows [k0, k0 + GM_KS) and loaded columns [c0, c0 + GM_TN) of a
// weight (row stride ld elements) into stage st; rows >= kend and columns
// >= NL read nothing and land as zeros. bf16: chunk c of row r at
// c ^ (r & 7), so that the ldmatrix reads are free of bank conflicts.
// Bytes: rows of GM_BROW bytes, so that the fragment reads of the 4 k
// rows of a warp fall in 4 distinct bank groups.
template <int WK>
__device__ __forceinline__ void gm_load_stage(unsigned char* st,
                                              const void* w, int ld, int k0,
                                              int kend, int c0, int NL,
                                              int tid) {
  if constexpr (WK == W_FLOAT) {
    const bf16* src = static_cast<const bf16*>(w);
#pragma unroll
    for (int i = tid; i < GM_KS * 8; i += GM_THREADS) {
      const int r = i >> 3, c = i & 7, k = k0 + r, n = c0 + 8 * c;
      const bool ok = k < kend && n < NL;
      cp_async16(st + r * GM_HROW + ((c ^ (r & 7)) << 4),
                 ok ? src + (size_t)k * ld + n : src, ok);
    }
  } else {
    const int8_t* src = static_cast<const int8_t*>(w);
#pragma unroll
    for (int i = tid; i < GM_KS * 4; i += GM_THREADS) {
      const int r = i >> 2, c = i & 3, k = k0 + r, n = c0 + 16 * c;
      const bool ok = k < kend && n < NL;
      cp_async16(st + r * GM_BROW + 16 * c,
                 ok ? src + (size_t)k * ld + n : src, ok);
    }
  }
}

// The loaded column (within the block's GM_TN) of a warp's A-operand row
// m = g + 8 * hi, g = lane / 4: bf16 tiles keep the order; byte tiles
// interleave (m = g and g + 8 are the two bytes at 2g) so that one 16-bit
// read gives both.
template <int WK>
__device__ __forceinline__ int gm_col(int warp, int lane, int hi) {
  const int g = lane >> 2;
  return WK == W_FLOAT ? 16 * warp + g + 8 * hi : 16 * warp + 2 * g + hi;
}

__device__ __forceinline__ unsigned gm_smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A operand (16 columns x 16 k rows) of a bf16 tile: k16 step kk of the
// stage, the warp's 16 columns
__device__ __forceinline__ void gm_frag_bf16(const unsigned char* st, int kk,
                                             int warp, int lane,
                                             unsigned* a) {
  const int k = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
  const int c = 2 * warp + ((lane >> 3) & 1);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(gm_smem_u32(st + k * GM_HROW + ((c ^ (k & 7)) << 4))));
}

// The raw bytes of a byte tile behind one A operand: rows 2t, 2t + 1,
// 2t + 8, 2t + 9 of step kk as words w01 = (row 2t) | (row 2t + 1) << 16
// and w89 likewise, each 16-bit half holding columns m = g (low byte)
// and g + 8 (high byte)
__device__ __forceinline__ void gm_bytes(const unsigned char* st, int kk,
                                         int warp, int lane, unsigned& w01,
                                         unsigned& w89) {
  const int g = lane >> 2, t = lane & 3;
  const unsigned char* p = st + (16 * kk + 2 * t) * GM_BROW + 16 * warp + 2 * g;
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  w01 = (unsigned)h[0] | ((unsigned)h[GM_BROW / 2] << 16);
  w89 = (unsigned)h[4 * GM_BROW] | ((unsigned)h[9 * GM_BROW / 2] << 16);
}

// bf16 bits of signed byte i of w (exact: |v| <= 128 has 8 significant
// bits): 2^23 + 128 + v as float32, minus 2^23 + 128, whose low 16 bits
// are zero
__device__ __forceinline__ unsigned gm_i8_bits(unsigned w_x80, int i) {
  const float f =
      __uint_as_float(__byte_perm(w_x80, 0x4B000000u, 0x7540u + i)) -
      8388736.f;
  return __float_as_uint(f);
}

// two bf16 from bytes i (low half) and j (high half) of w
__device__ __forceinline__ unsigned gm_i8_pair(unsigned w, int i, int j) {
  const unsigned x = w ^ 0x80808080u;
  return __byte_perm(gm_i8_bits(x, i), gm_i8_bits(x, j), 0x7632u);
}

__device__ __forceinline__ void gm_frag_int8(const unsigned char* st, int kk,
                                             int warp, int lane,
                                             unsigned* a) {
  unsigned w01, w89;
  gm_bytes(st, kk, warp, lane, w01, w89);
  a[0] = gm_i8_pair(w01, 0, 2);  // m = g, k = 2t, 2t + 1
  a[1] = gm_i8_pair(w01, 1, 3);  // m = g + 8
  a[2] = gm_i8_pair(w89, 0, 2);  // m = g, k = 2t + 8, 2t + 9
  a[3] = gm_i8_pair(w89, 1, 3);
}

// two signed nibbles at bits 0-3 and 16-19 of u as bf16: 0x4300 | (q ^ 8)
// is 128 + q + 8, and the subtraction of 136 is exact
__device__ __forceinline__ unsigned gm_nib_pair(unsigned u) {
  unsigned v = (u & 0x000F000Fu) ^ 0x43084308u;
  const unsigned k136 = 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const unsigned*>(&r);
}

// int4 byte tile: lo gets the low nibbles' A operand, hi the high ones'
__device__ __forceinline__ void gm_frag_int4(const unsigned char* st, int kk,
                                             int warp, int lane, unsigned* lo,
                                             unsigned* hi) {
  unsigned w01, w89;
  gm_bytes(st, kk, warp, lane, w01, w89);
  lo[0] = gm_nib_pair(w01);
  lo[1] = gm_nib_pair(w01 >> 8);
  lo[2] = gm_nib_pair(w89);
  lo[3] = gm_nib_pair(w89 >> 8);
  hi[0] = gm_nib_pair(w01 >> 4);
  hi[1] = gm_nib_pair(w01 >> 12);
  hi[2] = gm_nib_pair(w89 >> 4);
  hi[3] = gm_nib_pair(w89 >> 12);
}

// B operand of batch rows 8 nb .. 8 nb + 7 at block-relative k row kl
// (a multiple of 16) of x staged as bf16 rows of xstride elements
__device__ __forceinline__ void gm_frag_x(const bf16* xs, int xstride, int kl,
                                          int nb, int lane, unsigned* b) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = xs + (size_t)(8 * nb + g) * xstride + kl + 2 * t;
  b[0] = *reinterpret_cast<const unsigned*>(p);
  b[1] = *reinterpret_cast<const unsigned*>(p + 8);
}

// c (16 columns x 8 rows, float32) += a (16 x 16 bf16) * b (16 x 8 bf16)
__device__ __forceinline__ void gm_mma(float* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Accumulator element c of a warp's 16 x 8 tile: batch row 2t + (c & 1)
// of the tile, A row m = g + 8 * (c >> 1)
__device__ __forceinline__ int gm_acc_row(int lane, int c) {
  return 2 * (lane & 3) + (c & 1);
}

// Wait until at most n of this thread's cp.async groups are in flight
// (n < 16), for a count known only at run time.
__device__ __forceinline__ void gm_wait_groups(int n) {
  switch (n) {
#define GM_WAIT_CASE(N) \
  case N:               \
    cp_async_wait<N>(); \
    break;
    GM_WAIT_CASE(0) GM_WAIT_CASE(1) GM_WAIT_CASE(2) GM_WAIT_CASE(3)
    GM_WAIT_CASE(4) GM_WAIT_CASE(5) GM_WAIT_CASE(6) GM_WAIT_CASE(7)
    GM_WAIT_CASE(8) GM_WAIT_CASE(9) GM_WAIT_CASE(10) GM_WAIT_CASE(11)
    GM_WAIT_CASE(12) GM_WAIT_CASE(13) GM_WAIT_CASE(14)
#undef GM_WAIT_CASE
    default:
      cp_async_wait<15>();
  }
}

// Rows of K per block of a tensor-core GEMV: a multiple of `granule`
// (GM_KS, or an int4g group of more rows, so that no group is cut), with
// as many splits as keep tiles x splits within GM_TARGET_BLOCKS (one
// round of the SMs, no tail), but no more than keeps the split-K partials
// (rows x nacc float32 per loaded column and split) within the weight
// bytes they sum (wbytes per loaded column and K row, all sources), and
// rows x splits within GM_EPI_ROWS; and no more K than GM_XS_MAX bytes
// of staged x (8 * nb8 rows) hold.
// ops/kernels/decode_layer.py::gemv_split_rows mirrors it.
int gm_split_rows(int K, int tiles, int rows, int nacc, int wbytes,
                  int granule, int nb8) {
  const int units = (K + granule - 1) / granule;
  const int want = tiles < GM_TARGET_BLOCKS ? GM_TARGET_BLOCKS / tiles : 1;
  int steps = (units + want - 1) / want;
  const int min_rows = (4 * rows * nacc + wbytes - 1) / wbytes;
  const int steps_ws = (min_rows + granule - 1) / granule;
  if (steps < steps_ws) steps = steps_ws;
  const int nk_epi = rows < GM_EPI_ROWS ? GM_EPI_ROWS / rows : 1;
  const int steps_epi = (units + nk_epi - 1) / nk_epi;
  if (steps < steps_epi) steps = steps_epi;
  const int steps_xs = (GM_XS_MAX / (16 * nb8) - GM_XPAD) / granule;
  if (steps > steps_xs) steps = steps_xs;
  if (steps > units) steps = units;
  if (steps < 1) steps = 1;
  return steps * granule;
}

}  // namespace

// The split rule, exported for the tests' mirror.
extern "C" int gemv_split_rows(int K, int tiles, int rows, int nacc,
                               int wbytes, int granule, int nb8) {
  return gm_split_rows(K, tiles, rows, nacc, wbytes, granule, nb8);
}
