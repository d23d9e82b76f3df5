// GQA decode attention over the int8 KV cache: the C entry point of
// the int8 instantiation of the kernel in decode_attention.cuh (which
// says what it computes, which TPU kernel it replaces, and its bound).
// A source of its own, so that nvcc builds it beside the float one.

#include "decode_attention.cuh"

// The int8 cache: codes k, v int8 (B, S, KV, hd) and float32 k_scale,
// v_scale (B, S, KV, 1); dtype (0 float32, 1 bfloat16) is q's and the
// output's.  Otherwise as decode_attention_launch (the partials entry
// too: out null and pm, pl, pa set), whose workspace and tickets it may
// share (not concurrently).
extern "C" int decode_attention_int8_launch(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, void* out, void* pm, void* pl,
    void* pa, void* ws, void* tickets, int B, int S, int H, int KV, int hd,
    int dtype, float scale, int window, int splits, int chunk,
    void* stream) {
  if (B == 0) return 0;
  if (bad_shape(B, S, H, KV, splits, chunk, ws, tickets, out, pm, pl, pa) ||
      k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               lengths,
               out,
               static_cast<float*>(pm),
               static_cast<float*>(pl),
               static_cast<float*>(pa),
               ws,
               tickets,
               B,
               S,
               H,
               KV,
               scale,
               window,
               splits,
               chunk,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_hd<float, int8_t>(hd, a);
  if (dtype == 1) return launch_hd<__nv_bfloat16, int8_t>(hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
