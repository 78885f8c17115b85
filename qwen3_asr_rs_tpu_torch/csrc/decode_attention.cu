// C entry points for the standalone decode-attention launch (see
// decode_attention.cuh for the kernels and their design). k_scales and
// v_scales are null for slabs of T and select the int8-slab kernels
// otherwise.
#include "decode_attention.cuh"

template <typename T>
int decode_attention_entry(const void* q, const void* k_slabs,
                           const void* v_slabs, const void* k_scales,
                           const void* v_scales, const void* k_self,
                           const void* v_self, const void* start,
                           const void* end, void* out, void* ws, int layer,
                           int B, int Hq, int Hkv, int S, int D, float scale,
                           void* stream) {
  const float* ksc = static_cast<const float*>(k_scales);
  const float* vsc = static_cast<const float*>(v_scales);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ksc != nullptr) {
    err = launch_decode_attention<T, int8_t>(
        static_cast<const T*>(q), static_cast<const int8_t*>(k_slabs),
        static_cast<const int8_t*>(v_slabs), ksc, vsc,
        static_cast<const T*>(k_self), static_cast<const T*>(v_self),
        static_cast<const int*>(start), static_cast<const int*>(end),
        static_cast<T*>(out), static_cast<float*>(ws), layer, B, Hq, Hkv, S,
        D, scale, st);
  } else {
    err = launch_decode_attention<T, T>(
        static_cast<const T*>(q), static_cast<const T*>(k_slabs),
        static_cast<const T*>(v_slabs), nullptr, nullptr,
        static_cast<const T*>(k_self), static_cast<const T*>(v_self),
        static_cast<const int*>(start), static_cast<const int*>(end),
        static_cast<T*>(out), static_cast<float*>(ws), layer, B, Hq, Hkv, S,
        D, scale, st);
  }
  return static_cast<int>(err);
}

#define DECODE_ATTENTION_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* q, const void* k_slabs,                    \
                      const void* v_slabs, const void* k_scales,             \
                      const void* v_scales, const void* k_self,              \
                      const void* v_self, const void* start,                 \
                      const void* end, void* out, void* ws, int layer,       \
                      int B, int Hq, int Hkv, int S, int D, float scale,     \
                      void* stream) {                                        \
    return decode_attention_entry<T>(q, k_slabs, v_slabs, k_scales,          \
                                     v_scales, k_self, v_self, start, end,   \
                                     out, ws, layer, B, Hq, Hkv, S, D,       \
                                     scale, stream);                         \
  }

DECODE_ATTENTION_ENTRY(decode_attention_bf16, bf16)
DECODE_ATTENTION_ENTRY(decode_attention_f32, float)

// float32 scratch the launch needs for its split partials
extern "C" long long decode_attention_workspace(int B, int Hq, int S, int D) {
  return (long long)B * Hq * attn_num_splits(S) * (D + 2);
}
