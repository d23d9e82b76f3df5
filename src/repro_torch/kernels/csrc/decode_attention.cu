// GQA decode attention: one query token per batch row against its KV
// cache, for the port's dense transformer.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_kernel
// (reached through decode_attention).  For q (B, H, hd), a cache k, v
// (B, S, KV, hd), float32 or bfloat16, and int32 lengths (B,), query
// head h of row b attends to the cache positions pos of kv head
// h / (H / KV) with pos <= lengths[b] (the slot at lengths[b] already
// holds the new token) and, when window != 0, lengths[b] - pos <
// window.  The softmax is the Pallas kernel's, in float32: masked
// scores NEG_INF = -0.7 * FLT_MAX, a running max, p = exp(s - m) (0
// where masked), a running sum l, an accumulator rescaled by
// exp(m_old - m_new), and out = acc / (l + 1e-30) in q's type, so a row
// with no admitted position gives 0.
//
// Design.  The Pallas grid (B*KV, S/bk) streams the cache through
// VMEM in order and keeps the statistics in scratch; here one block of
// 128 threads serves one (kv head, batch row) and its G = H / KV query
// heads, and the cache axis is a loop inside the block.  The admitted
// positions form one interval [lo, hi), lo = max(0, len - window + 1)
// under a window and hi = min(S, len + 1), so the loop visits only
// those: tiles past the row's length are never read.  Each tile of
// 4,096 / hd positions is staged in shared memory as float32 (K rows
// padded by one float, so the threads that each take one position's
// dot product read distinct banks).  A thread loads its share of a
// tile as 16-byte chunks, all issued at once into registers, and the
// next tile's loads are issued before the current tile is computed, so
// one memory latency per tile overlaps the arithmetic instead of one
// per element.  The G x tile scores go to shared memory, one warp per
// query head reduces its tile max and sum with shuffles, and every
// thread then updates its (head, dim) slice of the accumulator in
// registers.  The kernel reads the public (B, S, KV, hd)
// layout through its own offsets, and the tile need not divide S: a
// cache of seq_len + gen_tokens + 1 = 37 slots is one ragged tile.
//
// Bound.  Decoding reads the admitted cache once: at the long serve
// shape (B 32, cache 1,057, KV 16, hd 64, bf16) that is
// 2 * 32 * 1,057 * 16 * 64 * 2 B ~ 138 MB, ~0.041 ms at 3.35 TB/s; the
// products are ~0.14 GFLOP, far under any compute bound.  At batch 1
// the grid is only KV = 16 blocks on 132 SMs; splitting the cache axis
// across blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;              // query heads per kv head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

// The 16-byte chunk `u` as floats: 4 float32 or 8 bfloat16 values.
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const float*) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, int S, int H, int KV,
                        float scale, int window) {
  constexpr int kTile = 4096 / HD;        // cache positions per tile
  constexpr int kPad = HD + 1;            // padded K row
  constexpr int kMaxAcc = kMaxGroup * HD / kThreads;
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int kRowChunks = HD / kVec;
  constexpr int kMine = kTile * kRowChunks / kThreads;  // chunks a thread
  static_assert(kTile * kRowChunks % kThreads == 0, "tile split");
  __shared__ float k_s[kTile * kPad];
  __shared__ float v_s[kTile * HD];
  __shared__ float q_s[kMaxGroup * HD];
  __shared__ float p_s[kMaxGroup * kTile];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], a_s[kMaxGroup];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int64_t len = lengths[b];
  const int64_t hi64 = len + 1 < S ? len + 1 : S;
  int64_t lo64 = 0;
  if (window != 0) lo64 = len - window + 1 > 0 ? len - window + 1 : 0;
  const int hi = static_cast<int>(hi64 > 0 ? hi64 : 0);
  const int lo = static_cast<int>(lo64 < hi ? lo64 : hi);

  const T* qrow = q + (static_cast<int64_t>(b) * H + kvh * G) * HD;
  for (int e = tid; e < G * HD; e += kThreads) q_s[e] = to_f32(qrow[e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

  // this thread's chunks of the tile at t0, into registers (zero past
  // the admitted interval)
  uint4 kr[kMine], vr[kMine];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int c = tid + i * kThreads;
      const int pos = t0 + c / kRowChunks;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (pos < hi) {
        const int64_t off =
            ((static_cast<int64_t>(b) * S + pos) * KV + kvh) * HD +
            (c % kRowChunks) * kVec;
        kr[i] = *reinterpret_cast<const uint4*>(k + off);
        vr[i] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
  };
  if (lo < hi) load_tile(lo);
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += kTile) {
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int c = tid + i * kThreads;
      const int j = c / kRowChunks;
      const int d = (c % kRowChunks) * kVec;
      float kf[kVec], vf[kVec];
      unpack(kr[i], kf, k);
      unpack(vr[i], vf, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[j * kPad + d + e] = kf[e];
        v_s[j * HD + d + e] = vf[e];
      }
    }
    __syncthreads();
    if (t0 + kTile < hi) load_tile(t0 + kTile);   // in flight meanwhile

    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile;
      const int j = e % kTile;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d)
        dot = fmaf(q_s[g * HD + d], k_s[j * kPad + d], dot);
      p_s[e] = t0 + j < hi ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32)
        mx = fmaxf(mx, p_s[g * kTile + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = t0 + j < hi ? expf(p_s[g * kTile + j] - m_new) : 0.f;
        p_s[g * kTile + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int o = tid + r * kThreads;
      if (o < G * HD) {
        const int g = o / HD;
        const int d = o % HD;
        float a = acc[r] * a_s[g];
        for (int j = 0; j < kTile; ++j)
          a = fmaf(p_s[g * kTile + j], v_s[j * HD + d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

  T* orow = out + (static_cast<int64_t>(b) * H + kvh * G) * HD;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int o = tid + r * kThreads;
    if (o < G * HD)
      orow[o] = from_f32(acc[r] / (l_s[o / HD] + 1e-30f), orow);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, int B, int S, int H, int KV,
                 int hd, float scale, int window, cudaStream_t stream) {
  const dim3 grid(KV, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int32_t* lt = static_cast<const int32_t*>(lengths);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      decode_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, lt, ot, S, H, KV, scale, window);
      break;
    case 64:
      decode_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, lt, ot, S, H, KV, scale, window);
      break;
    case 128:
      decode_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, lt, ot, S, H, KV, scale, window);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch over a (KV, B) grid on `stream`; dtype 0 is float32 and 1
// bfloat16; head_dim 32, 64 or 128; H / KV at most 8.  Returns
// cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int S, int H,
                                       int KV, int hd, int dtype,
                                       float scale, int window,
                                       void* stream) {
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, lengths, out, B, S, H, KV, hd, scale,
                               window, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, lengths, out, B, S, H, KV,
                                       hd, scale, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
