// C entry points for the standalone decode-attention launch (see
// decode_attention.cuh for the kernel and its design). k_scales and
// v_scales are null for slabs of T and select the int8-slab kernel
// otherwise; start and end are (B,) int32 device arrays, or null for
// start_val / end_val in every row.
#include "decode_attention.cuh"

template <typename T>
int decode_attention_entry(const void* q, const void* k_slabs,
                           const void* v_slabs, const void* k_scales,
                           const void* v_scales, const void* k_self,
                           const void* v_self, const void* start,
                           const void* end, void* out, void* ws, int layer,
                           int B, int Hq, int Hkv, int S, int D,
                           int start_val, int end_val, float scale,
                           void* stream) {
  const float* ksc = static_cast<const float*>(k_scales);
  const float* vsc = static_cast<const float*>(v_scales);
  const int* st = static_cast<const int*>(start);
  const int* en = static_cast<const int*>(end);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ksc != nullptr) {
    err = launch_decode_attention<T, int8_t>(
        static_cast<const T*>(q), static_cast<const int8_t*>(k_slabs),
        static_cast<const int8_t*>(v_slabs), ksc, vsc,
        static_cast<const T*>(k_self), static_cast<const T*>(v_self), st, en,
        start_val, end_val, static_cast<T*>(out), static_cast<float*>(ws),
        layer, B, Hq, Hkv, S, D, scale, s);
  } else {
    err = launch_decode_attention<T, T>(
        static_cast<const T*>(q), static_cast<const T*>(k_slabs),
        static_cast<const T*>(v_slabs), nullptr, nullptr,
        static_cast<const T*>(k_self), static_cast<const T*>(v_self), st, en,
        start_val, end_val, static_cast<T*>(out), static_cast<float*>(ws),
        layer, B, Hq, Hkv, S, D, scale, s);
  }
  return static_cast<int>(err);
}

#define DECODE_ATTENTION_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* q, const void* k_slabs,                    \
                      const void* v_slabs, const void* k_scales,             \
                      const void* v_scales, const void* k_self,              \
                      const void* v_self, const void* start,                 \
                      const void* end, void* out, void* ws, int layer,       \
                      int B, int Hq, int Hkv, int S, int D, int start_val,   \
                      int end_val, float scale, void* stream) {              \
    return decode_attention_entry<T>(q, k_slabs, v_slabs, k_scales,          \
                                     v_scales, k_self, v_self, start, end,   \
                                     out, ws, layer, B, Hq, Hkv, S, D,       \
                                     start_val, end_val, scale, stream);     \
  }

DECODE_ATTENTION_ENTRY(decode_attention_bf16, bf16)
DECODE_ATTENTION_ENTRY(decode_attention_f32, float)

// 4-byte words of scratch the launch needs (split partials and the
// fold's counters, which must start at zero; the kernel leaves them so)
extern "C" long long decode_attention_workspace(int B, int Hq, int Hkv, int S,
                                                int D) {
  return attn_workspace_words(B, Hq, Hkv, S, D);
}

// slots per split (the split rule)
extern "C" int decode_attention_chunk(int B, int Hkv, int S) {
  return attn_chunk(B, Hkv, S);
}

// the split rule's block target (for the Python mirror's tests)
extern "C" int decode_attention_target_blocks() { return ATTN_TARGET_BLOCKS; }
