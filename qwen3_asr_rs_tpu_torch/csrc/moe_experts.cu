// K7's expert products: the routed experts of a mixture-of-experts layer,
// grouped by expert (ops/kernels/moe_experts.py says what each launch
// takes; ``route`` and ``align`` there group the routes on the device).
//
// Two products, each one launch over a grid of (column tile, block of BM
// padded routes): gate-up, act = silu(x W_gate) * (x W_up) rounded to
// bf16, with W_gate and W_up the two halves of an expert's fused (H, 2 I)
// weight; and down, out = (act W_down) times each route's weight, float32
// rows in route order. A block belongs to one expert (block_expert; E for
// blocks past the last expert's run, which return at once), so it reads
// that expert's weight tiles once for all of its BM rows: at a decode
// step's few rows per expert (BM = 16) that is a GEMV-like stream of the
// touched experts' weights, at a prefill's (BM = 64) a matrix product.
//
// The tiles are gemv_mma.cuh's: mma.sync.m16n8k16 with the operands
// swapped (16 weight columns per warp on the M side from a swizzled
// bf16 stage by ldmatrix.trans, the block's rows on the N side in groups
// of 8), float32 accumulators. Each stage of the cp.async ring holds
// GM_KS rows of K of the weight tile (both halves for gate-up) and of the
// block's BM activation rows, gathered by route: row r of a gate-up block
// is x's row sorted[r] / top_k, of a down block act's own row; a pad or
// dead route loads zeros and stores nothing. Products of bf16 operands
// are exact in float32, so against the plain version only the order of
// the float32 sums differs.
#include "gemv_mma.cuh"

namespace {

constexpr int MX_XROW = GM_KS + GM_XPAD;  // bf16 per staged activation row

template <int BM, bool GATE_UP>
__host__ __device__ constexpr int mx_stage_bytes() {
  return BM * MX_XROW * 2 + (GATE_UP ? 2 : 1) * gm_stage_bytes<W_FLOAT>();
}

// the ring, then each row's source row and route
template <int BM, bool GATE_UP>
__host__ __device__ constexpr int mx_smem_bytes() {
  return GM_STAGES * mx_stage_bytes<BM, GATE_UP>() + 2 * BM * 4;
}

// a: gate-up x (T, H); down act (blocks * BM, I). w: gate-up (E, H, 2 I);
// down (E, I, H). out: gate-up act (bf16); down (N, H) float32.
template <int BM, bool GATE_UP>
__global__ void __launch_bounds__(GM_THREADS) moe_experts_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ w,
    const int* __restrict__ sorted_ids, const int* __restrict__ block_expert,
    const float* __restrict__ route_w, void* __restrict__ out, int n_routes,
    int n_experts, int H, int I, int top_k) {
  constexpr int STAGE = mx_stage_bytes<BM, GATE_UP>();
  constexpr int NB = BM / 8;
  const int mb = blockIdx.y;
  const int e = block_expert[mb];
  if (e >= n_experts) return;
  extern __shared__ __align__(128) unsigned char smem[];
  int* src_row = reinterpret_cast<int*>(smem + GM_STAGES * STAGE);
  int* route_of = src_row + BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = GATE_UP ? H : I;
  const int ld = GATE_UP ? 2 * I : H;
  const int a_ld = GATE_UP ? H : I;
  const int c0 = blockIdx.x * GM_TN;
  if (tid < BM) {
    const int rt = sorted_ids[mb * BM + tid];
    const bool ok = rt < n_routes;
    route_of[tid] = ok ? rt : -1;
    src_row[tid] = !ok ? -1 : GATE_UP ? rt / top_k : mb * BM + tid;
  }
  __syncthreads();
  const bf16* wexp = w + (size_t)e * K * ld;

  auto load = [&](int slot, int kt) {
    unsigned char* st = smem + slot * STAGE;
    bf16* xs = reinterpret_cast<bf16*>(st);
    const int k0 = kt * GM_KS;
#pragma unroll
    for (int i = tid; i < BM * 8; i += GM_THREADS) {
      const int r = i >> 3, c = i & 7, src = src_row[r];
      cp_async16(xs + r * MX_XROW + 8 * c,
                 src >= 0 ? a + (size_t)src * a_ld + k0 + 8 * c : a,
                 src >= 0);
    }
    unsigned char* ws = st + BM * MX_XROW * 2;
    gm_load_stage<W_FLOAT>(ws, wexp, ld, k0, K, c0, ld, tid);
    if constexpr (GATE_UP) {
      gm_load_stage<W_FLOAT>(ws + gm_stage_bytes<W_FLOAT>(), wexp, ld, k0,
                             K, I + c0, ld, tid);
    }
  };

  float acc[NB][4], acc_u[GATE_UP ? NB : 1][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[nb][c] = 0.f;
      if constexpr (GATE_UP) acc_u[nb][c] = 0.f;
    }
  }
  const int nk = K / GM_KS;
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GM_STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    const int next = kt + GM_STAGES - 1;
    if (next < nk) load(next % GM_STAGES, next);
    cp_async_commit();
    const unsigned char* st = smem + (kt % GM_STAGES) * STAGE;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const unsigned char* ws = st + BM * MX_XROW * 2;
#pragma unroll
    for (int kk = 0; kk < GM_KS / 16; ++kk) {
      unsigned ag[4], au[4];
      gm_frag_bf16(ws, kk, warp, lane, ag);
      if constexpr (GATE_UP) {
        gm_frag_bf16(ws + gm_stage_bytes<W_FLOAT>(), kk, warp, lane, au);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        unsigned b[2];
        gm_frag_x(xs, MX_XROW, 16 * kk, nb, lane, b);
        gm_mma(acc[nb], ag, b);
        if constexpr (GATE_UP) gm_mma(acc_u[nb], au, b);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = 8 * nb + gm_acc_row(lane, c);
      const int rt = route_of[r];
      if (rt < 0) continue;
      const int col = c0 + gm_col<W_FLOAT>(warp, lane, c >> 1);
      if constexpr (GATE_UP) {
        const float g = acc[nb][c];
        const float v = g / (1.f + expf(-g)) * acc_u[nb][c];
        static_cast<bf16*>(out)[(size_t)(mb * BM + r) * I + col] =
            __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(out)[(size_t)rt * H + col] =
            acc[nb][c] * route_w[rt];
      }
    }
  }
}

template <int BM, bool GATE_UP>
cudaError_t mx_launch(const bf16* a, const bf16* w, const int* sorted_ids,
                      const int* block_expert, const float* route_w,
                      void* out, int n_routes, int n_experts, int n_blocks,
                      int H, int I, int top_k, cudaStream_t stream) {
  static int smem_done = 0;
  constexpr int smem = mx_smem_bytes<BM, GATE_UP>();
  cudaError_t err =
      allow_smem(moe_experts_kernel<BM, GATE_UP>, smem, &smem_done);
  if (err != cudaSuccess) return err;
  const dim3 grid((GATE_UP ? I : H) / GM_TN, n_blocks);
  moe_experts_kernel<BM, GATE_UP><<<grid, GM_THREADS, smem, stream>>>(
      a, w, sorted_ids, block_expert, route_w, out, n_routes, n_experts, H, I,
      top_k);
  return cudaGetLastError();
}

template <bool GATE_UP>
cudaError_t mx_dispatch(const void* a, const void* w, const void* sorted_ids,
                        const void* block_expert, const void* route_w,
                        void* out, int n_routes, int n_experts, int n_blocks,
                        int H, int I, int top_k, int bm,
                        cudaStream_t stream) {
  if (H % GM_TN || I % GM_TN || n_blocks <= 0 || n_blocks > 65535 ||
      (bm != 16 && bm != 64)) {
    return cudaErrorInvalidValue;
  }
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* wb = static_cast<const bf16*>(w);
  const int* s = static_cast<const int*>(sorted_ids);
  const int* be = static_cast<const int*>(block_expert);
  const float* rw = static_cast<const float*>(route_w);
  if (bm == 16) {
    return mx_launch<16, GATE_UP>(ab, wb, s, be, rw, out, n_routes,
                                  n_experts, n_blocks, H, I, top_k, stream);
  }
  return mx_launch<64, GATE_UP>(ab, wb, s, be, rw, out, n_routes, n_experts,
                                n_blocks, H, I, top_k, stream);
}

}  // namespace

// x (T, H) bf16, gate_up_w (E, H, 2 I) bf16, sorted_ids and block_expert
// from align, act (n_blocks * bm, I) bf16 out, in padded route order.
extern "C" int moe_experts_gate_up(const void* x, const void* gate_up_w,
                                   const void* sorted_ids,
                                   const void* block_expert, void* act,
                                   int n_routes, int n_experts, int n_blocks,
                                   int H, int I, int top_k, int bm,
                                   void* stream) {
  return static_cast<int>(mx_dispatch<true>(
      x, gate_up_w, sorted_ids, block_expert, nullptr, act, n_routes,
      n_experts, n_blocks, H, I, top_k, bm,
      static_cast<cudaStream_t>(stream)));
}

// act from moe_experts_gate_up, down_w (E, I, H) bf16, route_w (N,)
// float32, out (N, H) float32: each live route's row times its weight.
extern "C" int moe_experts_down(const void* act, const void* down_w,
                                const void* sorted_ids,
                                const void* block_expert,
                                const void* route_w, void* out, int n_routes,
                                int n_experts, int n_blocks, int H, int I,
                                int bm, void* stream) {
  return static_cast<int>(mx_dispatch<false>(
      act, down_w, sorted_ids, block_expert, route_w, out, n_routes,
      n_experts, n_blocks, H, I, 1, bm, static_cast<cudaStream_t>(stream)));
}
