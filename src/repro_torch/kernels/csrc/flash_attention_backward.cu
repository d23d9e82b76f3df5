// The backward of the port's prefill attention (flash_attention.cu): dq,
// dk and dv of out = softmax(q k^T * scale, masked) v for every mode the
// forward takes (causal, windowed, unmasked with a key length SK of its
// own; GQA groups; the width pairs (32, 32), (64, 64), (128, 128) and
// MLA's (192, 128); float32 and bfloat16).
//
// No TPU kernel: the reference trains through XLA's autodiff of its
// plain sdpa (src/repro/models/attention.py:142).  Given the forward's
// output o and its row log-sum-exp lse (B, H, S), float32, written by
// the forward kernel when asked, and the output's gradient dO, with
//     P[i, j]  = exp(s[i, j] * scale - lse[i]) where the mask admits
//                (i, j), else 0       (s = q_i . k_j)
//     D[i]     = sum_c dO[i, c] o[i, c]
//     dS[i, j] = P[i, j] (dO_i . v_j - D[i])
// the gradients are
//     dv_j = sum_i P[i, j] dO_i,  dk_j = scale sum_i dS[i, j] q_i,
//     dq_i = scale sum_j dS[i, j] k_j,
// summed for dk and dv over the G = H / KV query heads that read kv
// head j's group.  A row with no admitted key has lse = +inf, P = 0
// and o = 0, so its gradients are 0.
//
// Three kernels, all on the CUDA cores in float32 whatever the inputs'
// type (bf16 inputs are widened when staged; the outputs are rounded
// once, to the inputs' type):
//   1. delta_kernel: D, one warp a (b, position, head) row.
//   2. dkdv_kernel: one block per (key tile, kv head, b).  Each key row
//      is held by LANES threads, each with a 1/LANES slice of k_j, v_j
//      and the dk_j, dv_j accumulators in registers.  The block walks
//      the group's query heads and, for each, the query tiles that can
//      see the key tile (from the tile's first key under the causal
//      mask, to its last key + window - 1 under a window), staging q,
//      dO, lse and D of 32 rows in shared memory as float32; for every
//      row a thread forms its partial dots of q_i . k_j and dO_i . v_j,
//      xor-shuffles complete them across the row's lanes, and each lane
//      updates its slices.
//   3. dq_kernel: one block per (query tile, head, b), the forward
//      float32 kernel's shape: LANES threads a query row holding slices
//      of q_i, dO_i and dq_i; 32-key tiles of k and v staged in shared
//      memory over the keys the forward's mask admits for the tile.
// Both main kernels recompute P and dP (the score and dO . v products)
// from q, k, v, dO and lse.  Each gradient element is written by one
// thread after a loop of fixed order, with no atomics, so two launches
// give the same bits.  LANES is 4 when hd + hdv <= 128 and 8 above, so
// that a thread's slices fit its registers at (192, 128).
//
// Bound.  At the training shape (B 8, S 512, 16 x 64, causal, bf16) the
// work must read q, k, v, o, dO and lse and write dq, dk, dv (~67 MB,
// 0.020 ms at 3.35 TB/s) and multiply 2.5 times the forward's products
// (~10.7 GFLOP, 0.011 ms at 989 TFLOP/s).  These kernels issue 3.5
// times the forward's products (the dk/dv pass recomputes S and dP, the
// dq pass both again) on the CUDA cores (67 TFLOP/s), so they are
// slower than that bound by design: right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = 32;   // query rows staged per step of dkdv
constexpr int kTileKeys = 32;   // keys staged per step of dq

template <int HDQ, int HDV>
struct Lanes {
  static constexpr int value = HDQ + HDV <= 128 ? 4 : 8;
};

// four consecutive elements as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// the sum over the LANES threads of a row (adjacent lanes of a warp)
template <int LANES>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool admitted(int pq, int pk, int causal,
                                         int window) {
  bool ok = true;
  if (causal) ok = pk <= pq;
  if (window != 0) ok = ok && pq - pk < window;
  return ok;
}

// ------------------------------------------------------------------ delta

template <typename T, int HDV>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(B) * S * H) return;
  // row = (b * S + s) * H + h, the public layout's row order
  const T* o = out + row * HDV;
  const T* g = dout + row * HDV;
  float acc = 0.f;
  for (int c = 4 * lane; c < HDV; c += 128)
    acc = dot4(load4(o + c), load4(g + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bs = row / H;
    const int s = static_cast<int>(bs % S);
    const int b = static_cast<int>(bs / S);
    delta[(static_cast<int64_t>(b) * H + h) * S + s] = acc;
  }
}

// ------------------------------------------------------------------- dkdv

template <typename T, int HDQ, int HDV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int SK, int H,
            int KV, float scale, int causal, int window) {
  constexpr int LANES = Lanes<HDQ, HDV>::value;
  constexpr int kKeys = kThreads / LANES;   // key rows per block
  constexpr int kQC = HDQ / 4 / LANES;      // float4 slices of q/k a lane
  constexpr int kVC = HDV / 4 / LANES;      // of v/dO a lane
  static_assert(kQC * 4 * LANES == HDQ && kVC * 4 * LANES == HDV,
                "widths must split over the lanes");
  __shared__ float4 qs[kTileRows][HDQ / 4];
  __shared__ float4 gs[kTileRows][HDV / 4];
  __shared__ float ls[kTileRows];
  __shared__ float ds[kTileRows];

  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int t0 = blockIdx.x * kKeys;
  const int pk = t0 + tid / LANES;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;

  float4 kr[kQC], vr[kVC], dkr[kQC], dvr[kVC];
  {
    const int64_t row = (static_cast<int64_t>(b) * SK + (pk < SK ? pk : 0)) *
                        KV + kvh;
#pragma unroll
    for (int i = 0; i < kQC; ++i) {
      kr[i] = pk < SK ? load4(k + row * HDQ + 4 * (lane + LANES * i))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      dkr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kVC; ++i) {
      vr[i] = pk < SK ? load4(v + row * HDV + 4 * (lane + LANES * i))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      dvr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // query rows any key of this tile is admitted by: [qlo, qhi)
  int qlo = causal ? t0 : 0;
  int64_t qhi = S;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(t0) + kKeys - 1 + window;
    qhi = reach < qhi ? reach : qhi;
  }
  if (qlo > S) qlo = S;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int64_t r0 = qlo; r0 < qhi; r0 += kTileRows) {
      __syncthreads();
      for (int e = tid; e < kTileRows * (HDQ / 4); e += kThreads) {
        const int r = e / (HDQ / 4);
        const int c = e % (HDQ / 4);
        const int64_t pq = r0 + r;
        qs[r][c] = pq < S ? load4(q + ((static_cast<int64_t>(b) * S + pq) *
                                           H + h) * HDQ + 4 * c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int e = tid; e < kTileRows * (HDV / 4); e += kThreads) {
        const int r = e / (HDV / 4);
        const int c = e % (HDV / 4);
        const int64_t pq = r0 + r;
        gs[r][c] = pq < S ? load4(dout + ((static_cast<int64_t>(b) * S +
                                           pq) * H + h) * HDV + 4 * c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (tid < kTileRows) {
        const int64_t pq = r0 + tid;
        const int64_t at = (static_cast<int64_t>(b) * H + h) * S + pq;
        ls[tid] = pq < S ? lse[at] : INFINITY;
        ds[tid] = pq < S ? delta[at] : 0.f;
      }
      __syncthreads();
      const int64_t left = qhi - r0;
      const int rows = left < kTileRows ? static_cast<int>(left) : kTileRows;
      for (int r = 0; r < rows; ++r) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < kQC; ++i) s = dot4(qs[r][lane + LANES * i],
                                               kr[i], s);
#pragma unroll
        for (int i = 0; i < kVC; ++i) dp = dot4(gs[r][lane + LANES * i],
                                                vr[i], dp);
        s = row_sum<LANES>(s);
        dp = row_sum<LANES>(dp);
        const int pq = static_cast<int>(r0) + r;
        const bool ok = pk < SK && admitted(pq, pk, causal, window);
        const float p = ok ? expf(s * scale - ls[r]) : 0.f;
        const float dsv = p * (dp - ds[r]);
#pragma unroll
        for (int i = 0; i < kVC; ++i) axpy4(dvr[i], p, gs[r][lane + LANES * i]);
#pragma unroll
        for (int i = 0; i < kQC; ++i)
          axpy4(dkr[i], dsv, qs[r][lane + LANES * i]);
      }
    }
  }

  if (pk < SK) {
    const int64_t row = (static_cast<int64_t>(b) * SK + pk) * KV + kvh;
#pragma unroll
    for (int i = 0; i < kQC; ++i)
      store4(dk + row * HDQ + 4 * (lane + LANES * i),
             make_float4(dkr[i].x * scale, dkr[i].y * scale,
                         dkr[i].z * scale, dkr[i].w * scale));
#pragma unroll
    for (int i = 0; i < kVC; ++i)
      store4(dv + row * HDV + 4 * (lane + LANES * i), dvr[i]);
  }
}

// --------------------------------------------------------------------- dq

template <typename T, int HDQ, int HDV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int SK, int H, int KV, float scale,
          int causal, int window) {
  constexpr int LANES = Lanes<HDQ, HDV>::value;
  constexpr int kRows = kThreads / LANES;   // query rows per block
  constexpr int kQC = HDQ / 4 / LANES;
  constexpr int kVC = HDV / 4 / LANES;
  __shared__ float4 ks[kTileKeys][HDQ / 4];
  __shared__ float4 vs[kTileKeys][HDV / 4];

  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int q0 = blockIdx.x * kRows;
  const int pq = q0 + tid / LANES;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  float4 qr[kQC], gr[kVC], dqr[kQC];
  float my_lse = INFINITY, my_delta = 0.f;
  {
    const int64_t row = (static_cast<int64_t>(b) * S + (pq < S ? pq : 0)) *
                        H + h;
#pragma unroll
    for (int i = 0; i < kQC; ++i) {
      qr[i] = pq < S ? load4(q + row * HDQ + 4 * (lane + LANES * i))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      dqr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kVC; ++i)
      gr[i] = pq < S ? load4(dout + row * HDV + 4 * (lane + LANES * i))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    if (pq < S) {
      const int64_t at = (static_cast<int64_t>(b) * H + h) * S + pq;
      my_lse = lse[at];
      my_delta = delta[at];
    }
  }

  // keys any row of this block admits: [lo, hi), as in the forward
  int hi = causal ? min(SK, q0 + kRows) : SK;
  int lo = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo = reach <= 0 ? 0 : reach >= SK ? SK : static_cast<int>(reach);
  }

  for (int t0 = lo; t0 < hi; t0 += kTileKeys) {
    __syncthreads();
    for (int e = tid; e < kTileKeys * (HDQ / 4); e += kThreads) {
      const int j = e / (HDQ / 4);
      const int c = e % (HDQ / 4);
      const int p = t0 + j;
      ks[j][c] = p < SK ? load4(k + ((static_cast<int64_t>(b) * SK + p) *
                                         KV + kvh) * HDQ + 4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int e = tid; e < kTileKeys * (HDV / 4); e += kThreads) {
      const int j = e / (HDV / 4);
      const int c = e % (HDV / 4);
      const int p = t0 + j;
      vs[j][c] = p < SK ? load4(v + ((static_cast<int64_t>(b) * SK + p) *
                                         KV + kvh) * HDV + 4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int keys = min(kTileKeys, hi - t0);
    for (int j = 0; j < keys; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kQC; ++i) s = dot4(qr[i], ks[j][lane + LANES * i],
                                             s);
#pragma unroll
      for (int i = 0; i < kVC; ++i) dp = dot4(gr[i], vs[j][lane + LANES * i],
                                              dp);
      s = row_sum<LANES>(s);
      dp = row_sum<LANES>(dp);
      const int pk = t0 + j;
      const bool ok = pq < S && admitted(pq, pk, causal, window);
      const float p = ok ? expf(s * scale - my_lse) : 0.f;
      const float dsv = p * (dp - my_delta);
#pragma unroll
      for (int i = 0; i < kQC; ++i) axpy4(dqr[i], dsv, ks[j][lane + LANES * i]);
    }
  }

  if (pq < S) {
    const int64_t row = (static_cast<int64_t>(b) * S + pq) * H + h;
#pragma unroll
    for (int i = 0; i < kQC; ++i)
      store4(dq + row * HDQ + 4 * (lane + LANES * i),
             make_float4(dqr[i].x * scale, dqr[i].y * scale,
                         dqr[i].z * scale, dqr[i].w * scale));
  }
}

// ----------------------------------------------------------------- launch

template <typename T, int HDQ, int HDV>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int SK, int H, int KV,
           float scale, int causal, int window, cudaStream_t stream) {
  constexpr int LANES = Lanes<HDQ, HDV>::value;
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t key_tiles = (static_cast<int64_t>(SK) + kThreads / LANES -
                             1) / (kThreads / LANES);
  const int64_t q_tiles = (static_cast<int64_t>(S) + kThreads / LANES - 1) /
                          (kThreads / LANES);
  if (delta_blocks > 0x7fffffff || key_tiles > 0x7fffffff ||
      q_tiles > 0x7fffffff || H > 65535 || KV > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  delta_kernel<T, HDV><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                         stream>>>(static_cast<const T*>(out), tdo, delta,
                                   B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (SK > 0) {
    dkdv_kernel<T, HDQ, HDV><<<dim3(static_cast<unsigned>(key_tiles), KV, B),
                               kThreads, 0, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), S, SK, H, KV, scale, causal, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dq_kernel<T, HDQ, HDV><<<dim3(static_cast<unsigned>(q_tiles), H, B),
                           kThreads, 0, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, SK, H, KV, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_widths(int hd, int hdv, const void* q, const void* k,
                  const void* v, const void* out, const void* dout,
                  const float* lse, float* delta, void* dq, void* dk,
                  void* dv, int B, int S, int SK, int H, int KV, float scale,
                  int causal, int window, cudaStream_t stream) {
#define FB_ARGS q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, SK, H, KV, \
                scale, causal, window, stream
  if (hd == 192 && hdv == 128) return launch<T, 192, 128>(FB_ARGS);
  if (hd == hdv) {
    switch (hd) {
      case 32:
        return launch<T, 32, 32>(FB_ARGS);
      case 64:
        return launch<T, 64, 64>(FB_ARGS);
      case 128:
        return launch<T, 128, 128>(FB_ARGS);
    }
  }
#undef FB_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The backward of flash_attention_launch: q (B, S, H, hd), k (B, SK, KV,
// hd), v (B, SK, KV, hdv), the forward's out and the gradient dout (B,
// S, H, hdv), its lse (B, H, S) float32; delta is a float32 workspace of
// B * H * S; dq, dk, dv are written in full (shapes of q, k, v), in the
// inputs' type (dtype 0 float32, 1 bfloat16).  Launches delta_kernel,
// dkdv_kernel and dq_kernel on `stream`, in that order.  Returns the
// first CUDA error of a launch, 0 if none.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int SK, int H, int KV, int hd, int hdv,
    int dtype, float scale, int causal, int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0 || SK < 0 || (causal && SK != S))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_widths<float>(hd, hdv, q, k, v, out, dout, l, d, dq, dk,
                                dv, B, S, SK, H, KV, scale, causal, window,
                                st);
  if (dtype == 1)
    return launch_widths<__nv_bfloat16>(hd, hdv, q, k, v, out, dout, l, d,
                                        dq, dk, dv, B, S, SK, H, KV, scale,
                                        causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
