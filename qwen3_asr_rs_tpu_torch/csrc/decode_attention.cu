// C entry points for the standalone decode-attention launch (see
// decode_attention.cuh for the kernels and their design).
#include "decode_attention.cuh"

#define DECODE_ATTENTION_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* q, const void* k_slabs,                    \
                      const void* v_slabs, const void* k_self,               \
                      const void* v_self, const void* start,                 \
                      const void* end, void* out, void* ws, int layer,       \
                      int B, int Hq, int Hkv, int S, int D, float scale,     \
                      void* stream) {                                        \
    return static_cast<int>(launch_decode_attention<T>(                      \
        static_cast<const T*>(q), static_cast<const T*>(k_slabs),            \
        static_cast<const T*>(v_slabs), static_cast<const T*>(k_self),       \
        static_cast<const T*>(v_self), static_cast<const int*>(start),       \
        static_cast<const int*>(end), static_cast<T*>(out),                  \
        static_cast<float*>(ws), layer, B, Hq, Hkv, S, D, scale,             \
        static_cast<cudaStream_t>(stream)));                                 \
  }

DECODE_ATTENTION_ENTRY(decode_attention_bf16, bf16)
DECODE_ATTENTION_ENTRY(decode_attention_f32, float)

// float32 scratch the launch needs for its split partials
extern "C" long long decode_attention_workspace(int B, int Hq, int S, int D) {
  return (long long)B * Hq * attn_num_splits(S) * (D + 2);
}
