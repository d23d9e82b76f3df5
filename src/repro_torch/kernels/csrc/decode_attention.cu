// GQA decode attention over a float32 or bfloat16 KV cache: the C
// entry point of the kernel in decode_attention.cuh (which says what it
// computes, which TPU kernel it replaces, and its bound).

#include "decode_attention.cuh"

// Launch over a (splits, KV, B) grid on `stream`, split s covering the
// cache slots [s * chunk, (s + 1) * chunk); dtype 0 is float32 and 1
// bfloat16; head_dim 32, 64 or 128; H / KV at most 8.  With splits > 1,
// ws holds 2 + hd floats for each (b, kv head, split, query head) and
// tickets one int32 for each (b, kv head), all 0 before the first
// launch (each launch leaves them 0).  The partials entry passes out
// null and pm, pl (B, KV, G, 1) and pa (B, KV, G, hd) float32, where the
// launch writes the softmax statistics before the division instead of
// the output; the plain entry passes them null.  Returns the first CUDA
// error of setting the shared-memory size or of the launch, 0 if none.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* pm, void* pl,
                                       void* pa, void* ws, void* tickets,
                                       int B, int S, int H, int KV, int hd,
                                       int dtype, float scale, int window,
                                       int splits, int chunk, void* stream) {
  if (B == 0) return 0;
  if (bad_shape(B, S, H, KV, splits, chunk, ws, tickets, out, pm, pl, pa))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               nullptr,
               nullptr,
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
  if (dtype == 0) return launch_hd<float, float>(hd, a);
  if (dtype == 1) return launch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
