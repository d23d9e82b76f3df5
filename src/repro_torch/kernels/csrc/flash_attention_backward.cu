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
// Three launches, FlashAttention-2's backward written by hand, with no
// atomics: delta_kernel (D, one warp a (b, position, head) row, float32
// arithmetic), then a dK/dV kernel over key tiles and a dQ kernel over
// query tiles, both recomputing P and dP from q, k, v, dO and lse.  Each
// gradient element is written once, after a loop of fixed order, so two
// launches give the same bits.  The dtype picks the two main kernels.
//
// bf16 design (tensor cores).  4 warps a block, each owning 16 of the
// block's 64 resident rows; every product is mma.sync m16n8k16 bf16 ->
// float32 with ldmatrix fragments from shared tiles padded by 16 bytes
// a row (the 8 rows of an ldmatrix phase in distinct banks), all
// staged as the bf16 they arrive in by 16-byte cp.async.
//   dkdv_kernel_bf16: one block per (kv head, b, 64-key tile); the key
//     tiles run in order, so under the causal mask the tiles that see
//     the most query rows start first.  K and V of the tile are staged
//     once; the block walks the group's G query heads and, for each, the
//     64-row query tiles the mask admits (from the tile's first key
//     under the causal mask, to its last key + window - 1 under a
//     window), staging q, dO, lse and D through a ring of two cp.async
//     stages, the next step's copies in flight while this one computes.
//     S^T = K q^T and dP^T = V dO^T (K and V as A fragments, q and dO
//     as B); P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T o
//     (dP^T - D) in registers, masked only in a tile the mask cuts; then
//     dV += P^T dO and dK += dS^T q straight from the score registers
//     (the accumulators of two n-tiles are the A fragment of a 16-row
//     k-step), dO and q by transposing ldmatrix.  dK and dV stay in
//     float32 registers until the one write.
//   dq_kernel_bf16: one block per (head, b, 64-row query tile), the
//     query tiles of a head heaviest first under the causal mask, as the
//     forward runs them.  q and dO are staged once; the block walks the
//     key tiles the forward's mask admits, K and V through a two-stage
//     ring; S = q K^T, dP = dO V^T, P and dS as above, and dQ += dS K.
// Columns of S are scored kSub at a time (64 at (32, 32) and (64, 64),
// 32 at (128, 128), 16 at (192, 128)), so that S, dP and the float32
// accumulators fit the registers: at (192, 128) dK and dV alone take 160
// floats a thread, the forward's ceiling, so the narrower score step
// (not a smaller key tile: m16n8k16 fixes 16 key rows a warp) keeps the
// tile at 64 keys.
//
// Rounding.  q, k, v and dO are bf16 already, so S and dP are exact
// products summed in float32; only P and dS are rounded to enter the
// next products.  CPU estimate at the training shape (B 8, S 512, 16 x
// 64, causal; tests/test_torch_flash_backward_tiles.py emulates the
// tiles): one bf16 term of P moves the rounded dv by up to 4.9e-3 of its
// largest magnitude, one term of dS the rounded dk and dq by 4.4e-3 and
// 3.8e-3, each over half the 2^-7 = 7.8e-3 gate; with both carried as
// hi + lo (two mma each, ~16 bits) the worst is 2.4e-3, one bf16
// rounding flip.  So P and dS both go to the tensor cores as hi + lo.
//
// Registers and shared memory (ptxas -v, sm_90a, CUDA 12 on the H100;
// dK/dV kernel, dQ kernel):
//   (32, 32)    184, 164 registers, no spill; 31,744, 30,720 bytes;
//               2 blocks an SM (the launch bound)
//   (64, 64)    234, 216 registers, no spill; 56,320, 55,296 bytes;
//               2 blocks an SM (registers)
//   (128, 128)  255, 234 registers, no spill; 105,472, 104,448 bytes;
//               2 blocks an SM
//   (192, 128)  255 registers each, spilling 148 and 76 bytes a thread
//               (the forward's ceiling at this pair); 130,048, 129,024
//               bytes; 1 block an SM
//
// float32 design (the first version, kept for float32: the tensor cores
// would round float32 through TF32, ~1e-3, far outside the 2e-5 gate).
//   dkdv_kernel: one block per (key tile, kv head, b).  Each key row is
//     held by LANES threads, each with a 1/LANES slice of k_j, v_j and
//     the dk_j, dv_j accumulators in registers.  The block walks the
//     group's query heads and, for each, the query tiles that can see
//     the key tile, staging q, dO, lse and D of 32 rows in shared memory
//     as float32; for every row a thread forms its partial dots of q_i .
//     k_j and dO_i . v_j, xor-shuffles complete them across the row's
//     lanes, and each lane updates its slices.
//   dq_kernel: one block per (query tile, head, b), the forward float32
//     kernel's shape: LANES threads a query row holding slices of q_i,
//     dO_i and dq_i; 32-key tiles of k and v staged in shared memory
//     over the keys the forward's mask admits for the tile.
// LANES is 4 when hd + hdv <= 128 and 8 above, so that a thread's slices
// fit its registers at (192, 128).  It issues 3.5 times the forward's
// products on the CUDA cores (67 TFLOP/s).
//
// Bound.  At the training shape (B 8, S 512, 16 x 64, causal, bf16) the
// work must read q, k, v, o, dO and lse and write dq, dk, dv (~67 MB,
// 0.020 ms at 3.35 TB/s) and multiply 2.5 times the forward's products
// (~10.7 GFLOP, 0.011 ms at 989 TFLOP/s): bytes bound it.  The bf16
// kernels issue S and dP twice (once in each main kernel) and the three
// gradient products twice (hi and lo): 10 products a pair where the
// bound counts 5, ~0.022 ms at the tensor cores' peak, about the bytes'
// time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

// ------------------------------------------------------------- bfloat16

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarpThreads = 128;          // 4 warps, 16 resident rows each
constexpr int kBlockRows = 64;             // resident rows a block
constexpr int kStepRows = 64;              // streamed rows a step

// Shared memory of the bf16 kernels, in bytes.  Rows are padded by 16
// bytes (8 bf16), so the 8 rows an ldmatrix phase reads fall in
// distinct banks.  dkdv: the resident K and V tile, then two stages of
// (q, dO, lse in log2 units, D); dq: the resident q and dO tile, then
// two stages of (K, V).
template <int HDQ, int HDV>
struct Bf16Bwd {
  static constexpr int kQS = HDQ + 8;      // bf16 per padded q / k row
  static constexpr int kVS = HDV + 8;      // bf16 per padded v / dO row
  static constexpr int kQBytes = 64 * kQS * 2;
  static constexpr int kVBytes = 64 * kVS * 2;
  static constexpr int kRowStage = kQBytes + kVBytes + 2 * 64 * 4;
  static constexpr int kDkdvBytes = kQBytes + kVBytes + 2 * kRowStage;
  static constexpr int kDqBytes = 3 * (kQBytes + kVBytes);
  // streamed columns a warp scores at once: S and dP of 16 x kSub in
  // float32 registers beside the accumulators (dK and dV: (HDQ + HDV) /
  // 2 floats a thread; dQ: HDQ / 2)
  static constexpr int kSub = HDQ + HDV <= 128 ? 64 : HDQ + HDV <= 256 ? 32
                                                                         : 16;
  static constexpr int kMinBlocks = HDQ + HDV >= 256 ? 1 : 2;
  static_assert(kQBytes % 16 == 0 && kVBytes % 16 == 0, "16-byte rows");
};

// 64 rows of head `head` from row `row0` of a (B, len, heads, HD) tensor
// into a padded shared tile; rows at or past len are zero-filled
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int b,
                                           int len, int heads, int head,
                                           int row0) {
  constexpr int kChunks = HD / 8;          // 16-byte chunks per row
  constexpr int kStride = HD + 8;
  static_assert(64 * kChunks % kWarpThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kWarpThreads; ++i) {
    const int c = threadIdx.x + i * kWarpThreads;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const int pos = row0 + r;
    const bool ok = pos < len;
    const __nv_bfloat16* g =
        src + ((static_cast<int64_t>(b) * len + (ok ? pos : 0)) * heads +
               head) * HD + ch * 8;
    cp_async16(dst + r * kStride + ch * 8, g, ok);
  }
}

// S (or S^T) and dP (or dP^T) of this warp's 16 resident rows against
// streamed columns [c0, c0 + N): s += X . U^T over HDQ, dp += Y . W^T
// over HDV, with X, Y the resident tiles and U, W the streamed ones
template <int HDQ, int HDV, int N>
__device__ __forceinline__ void score_tiles(
    float (&s)[N / 8][4], float (&dp)[N / 8][4], const __nv_bfloat16* xs,
    const __nv_bfloat16* ys, const __nv_bfloat16* us,
    const __nv_bfloat16* ws, int m0, int c0) {
  using L = Bf16Bwd<HDQ, HDV>;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDQ / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, xs, L::kQS, m0, 16 * kk);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      uint32_t bb[2];
      frag_b(bb, us, L::kQS, c0 + 8 * n, 16 * kk);
      mma_bf16(s[n], a, bb[0], bb[1]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < HDV / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, ys, L::kVS, m0, 16 * kk);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      uint32_t bb[2];
      frag_b(bb, ws, L::kVS, c0 + 8 * n, 16 * kk);
      mma_bf16(dp[n], a, bb[0], bb[1]);
    }
  }
}

// acc (16 x HD) += T . Z, T (16 x N) the float32 accumulators t of a
// score tile as hi + lo A fragments, Z the streamed rows [c0, c0 + N)
// of a shared tile stored [row][HD]
template <int HD, int N>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 8][4],
                                           const float (&t)[N / 8][4],
                                           const __nv_bfloat16* zs, int c0) {
  constexpr int kStride = HD + 8;
#pragma unroll
  for (int js = 0; js < N / 16; ++js) {
    uint32_t hi[4], lo[4];
    split_bf16(t[2 * js][0], t[2 * js][1], hi[0], lo[0]);
    split_bf16(t[2 * js][2], t[2 * js][3], hi[1], lo[1]);
    split_bf16(t[2 * js + 1][0], t[2 * js + 1][1], hi[2], lo[2]);
    split_bf16(t[2 * js + 1][2], t[2 * js + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      uint32_t bb[2];
      frag_b_t(bb, zs, kStride, c0 + 16 * js, 8 * dn);
      mma_split(acc[dn], hi, lo, bb[0], bb[1]);
    }
  }
}

// rows r0 and r0 + 8 of a (len, heads, HD) slab at (b, head): acc * mul
// as bf16 pairs, rows at or past len not written
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[HD / 8][4],
                                           int b, int len, int heads,
                                           int head, int r0, float mul) {
  const int c = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    if (r >= len) continue;
    __nv_bfloat16* row =
        dst + ((static_cast<int64_t>(b) * len + r) * heads + head) * HD + c;
#pragma unroll
    for (int t = 0; t < HD / 8; ++t)
      *reinterpret_cast<uint32_t*>(row + 8 * t) =
          pack_bf16(acc[t][2 * hf] * mul, acc[t][2 * hf + 1] * mul);
  }
}

// dK and dV of one (key tile, kv head, b): blockIdx = (b * KV + kv head,
// key tile), key tiles in order, so under the causal mask the tiles that
// see the most query rows start first
template <int HDQ, int HDV>
__global__ void __launch_bounds__(kWarpThreads, Bf16Bwd<HDQ, HDV>::kMinBlocks)
dkdv_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int S, int SK, int H,
                 int KV, float scale, int causal, int window) {
  using L = Bf16Bwd<HDQ, HDV>;
  constexpr int kSub = L::kSub;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kQBytes);
  unsigned char* ring = smem_raw + L::kQBytes + L::kVBytes;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kvh = blockIdx.x % KV;
  const int b = blockIdx.x / KV;
  const int t0 = blockIdx.y * kBlockRows;
  const int G = H / KV;
  const float scale_log2 = scale * kLog2e;

  // query rows any key of this tile is admitted by: [qlo, qhi)
  const int qlo = causal ? t0 : 0;
  int qhi = S;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(t0) + kBlockRows - 1 + window;
    qhi = reach < qhi ? static_cast<int>(reach) : qhi;
  }
  const int nq = qhi > qlo ? (qhi - qlo + kStepRows - 1) / kStepRows : 0;
  const int steps = G * nq;

  // step i: query head kvh G + i / nq, query rows qlo + 64 (i % nq)
  auto stage = [&](int i) {
    unsigned char* st = ring + (i & 1) * L::kRowStage;
    const int h = kvh * G + i / nq;
    const int r0 = qlo + (i % nq) * kStepRows;
    stage_rows<HDQ>(reinterpret_cast<__nv_bfloat16*>(st), q, b, S, H, h, r0);
    stage_rows<HDV>(reinterpret_cast<__nv_bfloat16*>(st + L::kQBytes), dout,
                    b, S, H, h, r0);
    float* rowv = reinterpret_cast<float*>(st + L::kQBytes + L::kVBytes);
    const int r = threadIdx.x % 64;
    const bool ok = r0 + r < S;
    const int64_t at =
        (static_cast<int64_t>(b) * H + h) * S + (ok ? r0 + r : 0);
    cp_async4(rowv + threadIdx.x, (threadIdx.x < 64 ? lse : delta) + at, ok);
  };

  stage_rows<HDQ>(ks, k, b, SK, KV, kvh, t0);
  stage_rows<HDV>(vs, v, b, SK, KV, kvh, t0);
  if (steps > 0) stage(0);
  cp_async_commit();

  float dka[HDQ / 8][4], dva[HDV / 8][4];
#pragma unroll
  for (int t = 0; t < HDQ / 8; ++t)
    dka[t][0] = dka[t][1] = dka[t][2] = dka[t][3] = 0.f;
#pragma unroll
  for (int t = 0; t < HDV / 8; ++t)
    dva[t][0] = dva[t][1] = dva[t][2] = dva[t][3] = 0.f;
  // this thread's key rows
  const int pk0 = t0 + 16 * warp + lane / 4;

  for (int i = 0; i < steps; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < steps) stage(i + 1);
    cp_async_commit();
    const unsigned char* st = ring + (i & 1) * L::kRowStage;
    const __nv_bfloat16* qt = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* dot =
        reinterpret_cast<const __nv_bfloat16*>(st + L::kQBytes);
    const float* lse_t =
        reinterpret_cast<const float*>(st + L::kQBytes + L::kVBytes);
    const float* d_t = lse_t + 64;
    const int r0 = qlo + (i % nq) * kStepRows;
    // mask only a tile the mask cuts (rows past S: zero q and dO)
    const bool cut = r0 + kStepRows > S ||
                     (causal && t0 + kBlockRows - 1 > r0) ||
                     (window != 0 && r0 + kStepRows - 1 - t0 >= window);
#pragma unroll
    for (int c0 = 0; c0 < kStepRows; c0 += kSub) {
      // S^T = K q^T and dP^T = V dO^T: rows keys, columns query rows
      float s[kSub / 8][4], dp[kSub / 8][4];
      score_tiles<HDQ, HDV, kSub>(s, dp, ks, vs, qt, dot, 16 * warp, c0);
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * n + 2 * (lane & 3) + (e & 1);
          float p = fast_exp2(
              fmaf(s[n][e], scale_log2, -lse_t[col] * kLog2e));
          if (cut) {
            const int pq = r0 + col;
            const int pk = pk0 + (e < 2 ? 0 : 8);
            bool ok = pq < S;
            if (causal) ok = ok && pk <= pq;
            if (window != 0) ok = ok && pq - pk < window;
            p = ok ? p : 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - d_t[col]);
        }
      // dV += P^T dO and dK += dS^T q, P and dS as hi + lo
      accumulate<HDV, kSub>(dva, s, dot, c0);
      accumulate<HDQ, kSub>(dka, dp, qt, c0);
    }
  }
  cp_async_wait_all();
  store_rows<HDQ>(dk, dka, b, SK, KV, kvh, pk0, scale);
  store_rows<HDV>(dv, dva, b, SK, KV, kvh, pk0, 1.f);
}

// dQ of one (query tile, head, b): blockIdx = (b * H + h, query tile),
// the tiles of a head heaviest first under the causal mask, as the
// forward runs them
template <int HDQ, int HDV>
__global__ void __launch_bounds__(kWarpThreads, Bf16Bwd<HDQ, HDV>::kMinBlocks)
dq_kernel_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int S, int SK, int H, int KV,
               float scale, int causal, int window) {
  using L = Bf16Bwd<HDQ, HDV>;
  constexpr int kSub = L::kSub;
  constexpr int kKV = L::kQBytes + L::kVBytes;   // one stage of (K, V)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L::kQBytes);
  unsigned char* ring = smem_raw + kKV;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockRows;
  const int kvh = h / (H / KV);
  const float scale_log2 = scale * kLog2e;

  // keys any row of this block admits: [lo, hi), as in the forward
  const int hi = causal ? min(SK, q0 + kBlockRows) : SK;
  int lo = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo = reach <= 0 ? 0 : reach >= SK ? SK : static_cast<int>(reach);
  }
  const int n_tiles = hi > lo ? (hi - lo + kStepRows - 1) / kStepRows : 0;

  auto stage = [&](int i) {
    unsigned char* st = ring + (i & 1) * kKV;
    stage_rows<HDQ>(reinterpret_cast<__nv_bfloat16*>(st), k, b, SK, KV, kvh,
                    lo + i * kStepRows);
    stage_rows<HDV>(reinterpret_cast<__nv_bfloat16*>(st + L::kQBytes), v, b,
                    SK, KV, kvh, lo + i * kStepRows);
  };
  stage_rows<HDQ>(qs, q, b, S, H, h, q0);
  stage_rows<HDV>(dos, dout, b, S, H, h, q0);
  if (n_tiles > 0) stage(0);
  cp_async_commit();

  // this thread's rows pq0 and pq0 + 8: their lse (log2 units) and D
  const int pq0 = q0 + 16 * warp + lane / 4;
  float l2[2], dd[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int pq = pq0 + 8 * hf;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * S + pq;
    l2[hf] = pq < S ? lse[at] * kLog2e : INFINITY;
    dd[hf] = pq < S ? delta[at] : 0.f;
  }
  float dqa[HDQ / 8][4];
#pragma unroll
  for (int t = 0; t < HDQ / 8; ++t)
    dqa[t][0] = dqa[t][1] = dqa[t][2] = dqa[t][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_tiles) stage(i + 1);
    cp_async_commit();
    const unsigned char* st = ring + (i & 1) * kKV;
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* vt =
        reinterpret_cast<const __nv_bfloat16*>(st + L::kQBytes);
    const int t0 = lo + i * kStepRows;
    const bool cut =
        t0 + kStepRows > SK || (causal && t0 + kStepRows - 1 > q0) ||
        (window != 0 && static_cast<int64_t>(t0) <=
                            static_cast<int64_t>(q0) + kBlockRows - 1 -
                                window);
#pragma unroll
    for (int c0 = 0; c0 < kStepRows; c0 += kSub) {
      // S = q K^T and dP = dO V^T: rows query rows, columns keys
      float s[kSub / 8][4], dp[kSub / 8][4];
      score_tiles<HDQ, HDV, kSub>(s, dp, qs, dos, kt, vt, 16 * warp, c0);
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          float p = fast_exp2(fmaf(s[n][e], scale_log2, -l2[hf]));
          if (cut) {
            const int pk = t0 + c0 + 8 * n + 2 * (lane & 3) + (e & 1);
            const int pq = pq0 + 8 * hf;
            bool ok = pk < SK;
            if (causal) ok = ok && pk <= pq;
            if (window != 0) ok = ok && pq - pk < window;
            p = ok ? p : 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dd[hf]);
        }
      // dQ += dS K, dS as hi + lo
      accumulate<HDQ, kSub>(dqa, dp, kt, c0);
    }
  }
  cp_async_wait_all();
  store_rows<HDQ>(dq, dqa, b, S, H, h, pq0, scale);
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
  if constexpr (sizeof(T) == 2) {
    using L = Bf16Bwd<HDQ, HDV>;
    const auto dkdv = dkdv_kernel_bf16<HDQ, HDV>;
    const auto dqk = dq_kernel_bf16<HDQ, HDV>;
    const int64_t kb_tiles = (static_cast<int64_t>(SK) + kBlockRows - 1) /
                             kBlockRows;
    const int64_t qb_tiles = (static_cast<int64_t>(S) + kBlockRows - 1) /
                             kBlockRows;
    if (kb_tiles > 65535 || qb_tiles > 65535 ||
        static_cast<int64_t>(B) * H > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    if (SK > 0) {
      err = cudaFuncSetAttribute(
          dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDkdvBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      dkdv<<<dim3(static_cast<unsigned>(B) * KV,
                  static_cast<unsigned>(kb_tiles)),
             kWarpThreads, L::kDkdvBytes, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), S, SK, H, KV, scale, causal, window);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dqk<<<dim3(static_cast<unsigned>(B) * H, static_cast<unsigned>(qb_tiles)),
          kWarpThreads, L::kDqBytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, SK, H, KV,
        scale, causal, window);
    return static_cast<int>(cudaGetLastError());
  } else {
    if (SK > 0) {
      dkdv_kernel<T, HDQ, HDV><<<dim3(static_cast<unsigned>(key_tiles), KV,
                                      B),
                                 kThreads, 0, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), S, SK, H, KV, scale, causal, window);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dq_kernel<T, HDQ, HDV><<<dim3(static_cast<unsigned>(q_tiles), H, B),
                             kThreads, 0, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, SK, H, KV,
        scale, causal, window);
    return static_cast<int>(cudaGetLastError());
  }
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
// the dK/dV kernel (when SK > 0) and the dQ kernel on `stream`, in that
// order: dkdv_kernel_bf16 and dq_kernel_bf16 for bfloat16, dkdv_kernel
// and dq_kernel for float32.  Returns the
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
