// Blocked causal / sliding-window GQA prefill attention with an online
// softmax, for the port's dense transformer.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (reached through flash_attention).  For q (B, S, H, hd) and k, v
// (B, S, KV, hd), float32 or bfloat16, query head h reads kv head
// h / (H / KV) and, for every query position pq,
//     out[b, pq, h] = sum_pk p(pq, pk) v[b, pk, h / G]
// over the keys the mask admits: pk < S, pk <= pq when causal, and
// pq - pk < window when window != 0.  The softmax is the Pallas
// kernel's, in float32: scores (q . k) * scale, masked scores NEG_INF
// = -0.7 * FLT_MAX, a running max m, p = exp(s - m) (0 where masked),
// a running sum l and accumulator rescaled by exp(m_old - m_new), and
// out = acc / (l + 1e-30) in q's type, so a row with no admitted key
// gives 0.  Inputs are widened to float32 (a bf16 product is exact in
// float32), as the Pallas kernel does, and nothing is rounded to bf16
// before the output.
//
// Design.  The Pallas grid (B*H, S/bq, S/bk) runs its kv axis in
// order and keeps m, l and acc in VMEM scratch between grid steps; on
// Hopper blocks run in no order, so the kv axis is a loop inside the
// block.  One block of 128 threads serves (32 query rows, head h,
// batch row b): four threads per query row, each holding a quarter of
// the row's q and acc in registers (chunks of 4 dims interleaved, so
// the four read 64 contiguous bytes of shared memory at once).  Each
// 32-key tile of kv head h / G is staged in shared memory as float32;
// a thread computes its partial dot for every key of the tile, two
// xor-shuffles give all four the full score, and each then updates its
// slice of acc.  The four lanes of a row compute the same m, l and p
// bit for bit (float addition commutes), so no state is exchanged.
// The kernel reads the public (B, S, H, hd) layout through its own
// offsets: the Pallas wrapper's transposes to (B*H, S, hd) have no
// counterpart.  Under the causal mask the tiles past the block's last
// row are skipped, and under a window those before its first row's
// reach; a ragged last tile (S = 32 on the serve path is one tile,
// S = 1,024 is 32) is masked in the kernel.
//
// Bound.  At the long serve prompt (B 32, S 1,024, H 16, hd 64, bf16)
// the kernel must read q, k, v and write o, 268 MB, ~0.080 ms at
// 3.35 TB/s, and do 4 * B * H * hd * S (S + 1) / 2 ~ 69 GFLOP,
// ~0.069 ms at 989 TFLOP/s on the tensor cores: ~0.08 ms a launch.
// This kernel does its products on the CUDA cores in float32 (67
// TFLOP/s at most), so it sits an order of magnitude above the bound;
// a wgmma/TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kRows = 32;                  // query rows per block
constexpr int kLanes = 4;                  // threads per query row
constexpr int kKeys = 32;                  // keys per kv tile
constexpr int kThreads = kRows * kLanes;   // 128

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KV, float scale, int causal, int window) {
  constexpr int kChunks = HD / 4;          // float4 chunks in a head row
  constexpr int kMine = kChunks / kLanes;  // chunks a thread holds
  static_assert(kChunks % kLanes == 0, "head_dim must be a multiple of 16");
  __shared__ float4 ks[kKeys][kChunks];
  __shared__ float4 vs[kKeys][kChunks];

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int pq = q0 + row;

  float4 qr[kMine];
  float4 acc[kMine];
  const T* qrow = q + ((static_cast<int64_t>(b) * S + pq) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    qr[i] = pq < S ? load4(qrow + 4 * (lane + kLanes * i))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  // keys any row of this block admits: [lo, hi)
  int hi = S;
  if (causal) hi = min(S, q0 + kRows);
  int lo = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo = reach <= 0 ? 0 : reach >= S ? S : static_cast<int>(reach);
  }

  for (int t0 = lo; t0 < hi; t0 += kKeys) {
    for (int e = tid; e < kKeys * kChunks; e += kThreads) {
      const int j = e / kChunks;
      const int c = e % kChunks;
      const int pk = t0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (pk < S) {
        const int64_t off =
            ((static_cast<int64_t>(b) * S + pk) * KV + kvh) * HD + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[kKeys];
    uint32_t admit = 0;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 kk = ks[j][lane + kLanes * i];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int pk = t0 + j;
      bool ok = pk < S;
      if (causal) ok = ok && pk <= pq;
      if (window != 0) ok = ok && pq - pk < window;
      s[j] = ok ? part * scale : kNegInf;
      admit |= static_cast<uint32_t>(ok) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = (admit >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 vv = vs[j][lane + kLanes * i];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (pq < S) {
    const float denom = l + 1e-30f;
    T* orow = out + ((static_cast<int64_t>(b) * S + pq) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      store4(orow + 4 * (lane + kLanes * i),
             make_float4(acc[i].x / denom, acc[i].y / denom,
                         acc[i].z / denom, acc[i].w / denom));
    }
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int KV, int hd, float scale,
                 int causal, int window, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      flash_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, S, H, KV, scale, causal, window);
      break;
    case 64:
      flash_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, S, H, KV, scale, causal, window);
      break;
    case 128:
      flash_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, S, H, KV, scale, causal, window);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch over a (ceil(S / 32), H, B) grid on `stream`; dtype 0 is
// float32 and 1 bfloat16; head_dim 32, 64 or 128.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int S, int H, int KV, int hd,
                                      int dtype, float scale, int causal,
                                      int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, out, B, S, H, KV, hd, scale, causal,
                               window, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, scale,
                                       causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
