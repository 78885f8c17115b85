// Hopper building blocks of K1's bf16-weight GEMV (decode_layer.cu,
// gemv_wgmma_kernel): TMA weight tiles in an mbarrier ring, wgmma with the
// batch rows as N, and a split-K summed over distributed shared memory.
//
// y (rows, N) = x (rows, K) @ W (K, N), rows <= 32, W bf16. What bounds it
// on the H100 is the weight stream: one decode step of the 1.7B decoder
// reads 100.7 MB a layer (30 us at 3.35 TB/s) for all 32 rows. The design:
// - a block owns GW_TN = 64 weight columns (wgmma's M side: A from a
//   128-byte-swizzled MN-major tile, the transpose bit set, as TMA lays a
//   box of 64 columns x GW_KS rows) and one K range; the batch rows are
//   wgmma's N (8, 16 or 32; B from x's box of GW_KS columns x N rows,
//   K-major, 128-byte swizzled), float32 accumulators in registers: at 32
//   rows one wgmma.m64n32k16 per 16 rows of K and source;
// - one producer warp keeps a ring of GW_KS-row stages in flight by TMA
//   (a full and an empty mbarrier per stage), each the weight tiles and
//   the same rows of x: it issues the first stage's weights as soon as
//   the block starts (weights never depend on the previous kernel), its x
//   first once the previous kernel has finished, then the rest of the
//   ring. A normed GEMV rounds
//   each stage's x to the normed bf16 row in place before its products,
//   its RMSNorm factors from the parts of each row's sum of squares, all
//   in flight at once. Every wait on memory is one round trip: under the
//   weight stream an L2 hit takes 1-2 us, so a chain of them costs more
//   than the stream (PERF.md). The tensor maps are encoded on the host
//   at launch, which for a captured step is capture time (the arena
//   keeps its addresses);
// - K is split across the blocks of one thread-block cluster (gw_plan: 1
//   to 8 ranks along K): each rank pushes its partial sums into the
//   shared memory of the rank that owns the rows (rank o owns rows
//   [o N / cs, (o + 1) N / cs)), one cluster barrier, and each owner adds
//   the partials in rank order (deterministic) and runs the epilogue. No
//   global workspace, fence, counter or serial last-block pass;
// - the plan (gw_plan) takes the most ranks whose blocks stay within two
//   per SM, and a ring of up to GW_MAX_STAGES stages: each block carries a
//   fixed chain of waits (start, x, partials, epilogue) that a longer K
//   range amortizes (measured best at the 1.7B shapes, PERF.md).
// Products of bf16 x and bf16 weights are exact in float32, so against
// the mma.sync GEMV (gemv_mma.cuh) only the order of the float32 sums
// changes.
#pragma once

#include <cuda.h>

#include "gemv_mma.cuh"

namespace {

constexpr int GW_TN = 64;            // weight columns per block: wgmma's M
constexpr int GW_KS = 64;            // K rows per stage
constexpr int GW_W_BYTES = GW_KS * GW_TN * 2;  // one source's weight tile
constexpr int GW_CONSUMERS = 128;    // one warpgroup
constexpr int GW_THREADS = GW_CONSUMERS + 32;  // and the producer warp
constexpr int GW_MAX_CLUSTER = 8;    // the portable cluster size
constexpr int GW_SMS = 132;          // SMs of the H100 SXM
// Blocks a launch may take: two per SM (more, shorter ranks repeat each
// block's fixed latency chain more often than they add to the stream)
constexpr int GW_TARGET_BLOCKS = 2 * GW_SMS;
// shared memory of an SM, and what each block takes beside its dynamic
// bytes (the 1 KB the runtime reserves, and the static rnorm)
constexpr int GW_SM_SMEM = 228 * 1024;
constexpr int GW_BLOCK_EXTRA = 1024 + 128;
constexpr int GW_SMEM_MAX = 227 * 1024 - 128;  // one block's dynamic bytes
constexpr int GW_MAX_STAGES = 4;
// Stages whose weights a block requests before the previous kernel ends:
// requests are served roughly in order, so x's, issued once that kernel
// has ended, wait behind whatever the SM asked for before them
constexpr int GW_PREFETCH = 1;
constexpr int GW_RPITCH = GW_TN + 4;  // floats per row of the partials
constexpr int GW_SLACK = 1024 + 128;  // 1024-byte alignment and barriers
constexpr int GW_SSQ_PER_THREAD = 16;  // sums-of-squares parts a thread adds

// a ring stage: the sources' weight tiles, then x's GW_KS columns of its
// 8 nb8 rows (128 bytes a row)
__host__ __device__ constexpr int gw_stage_bytes(int nsrc, int nb8) {
  return nsrc * GW_W_BYTES + 8 * nb8 * 128;
}
// the partials one owner receives: every rank's sums of its rows, per
// source
__host__ __device__ constexpr int gw_red_bytes(int nsrc, int nb8) {
  return nsrc * 8 * nb8 * GW_RPITCH * 4;
}

// The launch plan of a wgmma GEMV of `tiles` column tiles over K rows
// with nsrc sources at 8 * nb8 staged rows: the cluster size cs (the
// largest power of two up to GW_MAX_CLUSTER, and no more than K's
// stages, whose tiles x cs blocks stay within GW_TARGET_BLOCKS; at least
// 1), kr rows of K per rank (whole stages), the ring's stages (as many
// as a block's share of its SM holds beside the partials and the rank's
// norm weights, at most the rank's stages and GW_MAX_STAGES, at least 1)
// and the dynamic shared bytes.
// ops/kernels/decode_layer.py::gemv_wgmma_plan mirrors it.
struct GwPlan {
  int cs, kr, stages, smem;
};

GwPlan gw_plan(int K, int tiles, int nsrc, int nb8) {
  const int units = (K + GW_KS - 1) / GW_KS;
  const int stage = gw_stage_bytes(nsrc, nb8);
  GwPlan p;
  p.cs = 1;
  while (p.cs < GW_MAX_CLUSTER && 2 * tiles * p.cs <= GW_TARGET_BLOCKS &&
         2 * p.cs <= units) {
    p.cs *= 2;
  }
  const int nst = (units + p.cs - 1) / p.cs;
  p.kr = nst * GW_KS;
  const int per_sm = (tiles * p.cs + GW_SMS - 1) / GW_SMS;
  const int fixed = gw_red_bytes(nsrc, nb8) + 2 * p.kr + GW_SLACK;
  p.stages = (GW_SM_SMEM / per_sm - GW_BLOCK_EXTRA - fixed) / stage;
  if (p.stages > GW_MAX_STAGES) p.stages = GW_MAX_STAGES;
  if (p.stages > nst) p.stages = nst;
  if (p.stages < 1) p.stages = 1;
  p.smem = fixed + p.stages * stage;
  return p;
}

// ---- device helpers -----------------------------------------------------

__device__ __forceinline__ void gw_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   gm_smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void gw_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   gm_smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void gw_bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   gm_smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void gw_bar_wait(uint64_t* bar, int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(gm_smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// A box of a 2-D tensor map at (c0 inner, c1 outer) into this block's
// shared memory, its bytes counted on bar; out of bounds lands as zeros.
__device__ __forceinline__ void gw_tma_2d(void* dst, const CUtensorMap* map,
                                          int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(gm_smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(gm_smem_u32(bar))
      : "memory");
}

// Fetch a tensor map (a kernel parameter) into the TMA unit's cache
__device__ __forceinline__ void gw_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// The descriptor of a 128-byte-swizzled shared-memory operand, layout
// type 1 = SW128, 8-row groups 1024 bytes apart (the stride offset).
// K-major (x, the B operand): rows of 128 bytes (64 bf16 of K). MN-major
// (the weight, the A operand, with the transpose bit): per K row 128
// bytes of 64 columns, K rows 128 bytes apart. Both: one atom across, so
// the leading offset is unused.
__device__ __forceinline__ uint64_t gw_desc(const void* smem) {
  const unsigned a = gm_smem_u32(smem);
  return (uint64_t)((a >> 4) & 0x3FFF) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 weight columns x 8 NB8 batch rows, float32) += A (64 x 16 bf16,
// MN-major: the transpose bit) * B (16 x 8 NB8 bf16, K-major), both from
// shared memory. Accumulator 4 j + 2 i + c of consumer thread (warp w,
// lane l) is weight column 16 w + l / 4 + 8 i and batch row 8 j + 2 (l %
// 4) + c.
template <int NB8>
__device__ __forceinline__ void gw_wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void gw_wgmma<1>(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gw_wgmma<2>(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void gw_wgmma<4>(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void gw_fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ unsigned gw_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned gw_cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// The cluster barrier in two halves: every thread of every block of the
// cluster arrives, then waits for the others' arrivals (release /
// acquire: the shared-memory writes before the arrival are visible after
// the wait).
__device__ __forceinline__ void gw_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void gw_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The address of this block's shared-memory word at `local` in the block
// of cluster rank `rank`, and a float store there
__device__ __forceinline__ unsigned gw_remote(unsigned local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void gw_st_remote(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// ---- host: tensor maps ---------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links the CUDA runtime only, not libcuda)
typedef CUresult (*GwEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

GwEncodeTiled gw_encoder() {
  static GwEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<GwEncodeTiled>(p);
    }
  }
  return fn;
}

// A bf16 matrix of `rows` rows and `cols` columns (row stride ld
// elements) as boxes of box_rows x box_cols (128 bytes across), 128-byte
// swizzled, zeros out of bounds: a weight in boxes of GW_KS rows x GW_TN
// columns (wgmma's A), x in boxes of N rows x GW_KS columns (its B).
bool gw_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
            int box_rows, int box_cols) {
  GwEncodeTiled encode = gw_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The plan, exported for the tests' mirror: {cs, kr, stages, smem}.
extern "C" void gemv_wgmma_plan(int K, int tiles, int nsrc, int nb8,
                                int* out) {
  const GwPlan p = gw_plan(K, tiles, nsrc, nb8);
  out[0] = p.cs;
  out[1] = p.kr;
  out[2] = p.stages;
  out[3] = p.smem;
}
