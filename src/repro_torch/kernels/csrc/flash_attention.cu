// Blocked causal / sliding-window GQA prefill attention with an online
// softmax, for the port's transformers (GQA, and MLA's expanded form).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (reached through flash_attention).  For q (B, S, H, hd), k (B, SK, KV,
// hd) and v (B, SK, KV, hdv), float32 or bfloat16, query head h reads kv
// head h / (H / KV) and, for every query position pq,
//     out[b, pq, h] = sum_pk p(pq, pk) v[b, pk, h / G]
// over the keys the mask admits: pk < SK, pk <= pq when causal, and
// pq - pk < window when window != 0.  The key length SK is S for
// self-attention; cross-attention (whisper's decoder over its encoder's
// 1,500 frames) attends S queries to SK = n_ctx keys with no mask, and
// the launcher refuses causal with SK != S.  The softmax is the Pallas
// kernel's, in float32: scores (q . k) * scale, masked scores NEG_INF
// = -0.7 * FLT_MAX, a running max m, p = exp(s - m) (0 where masked),
// a running sum l and accumulator rescaled by exp(m_old - m_new), and
// out = acc / (l + 1e-30) in q's type, so a row with no admitted key
// gives 0.  Both kernels read the public (B, S, H, hd) layout through
// their own offsets (the Pallas wrapper's transposes to (B*H, S, hd)
// have no counterpart), skip the tiles past the block's last row under
// the causal mask and those before its first row's reach under a
// window, and mask a ragged last tile in the kernel.  The Pallas grid
// (B*H, S/bq, S/bk) runs its kv axis in order and keeps m, l and acc in
// VMEM scratch; on Hopper blocks run in no order, so the kv axis is a
// loop inside the block.
//
// The row log-sum-exp.  Given a float32 lse (B, H, S) (a null pointer
// writes none, and the kernels run as without it), each row also writes
// lse = m * scale + log(l) in natural-log units of the scaled scores, or
// +inf for a row with no admitted key; the backward
// (flash_attention_backward.cu) recomputes P = exp(s * scale - lse).
//
// Which kernel runs.  bfloat16 inputs run flash_attention_kernel_bf16,
// on the tensor cores; float32 inputs run flash_attention_kernel, on
// the CUDA cores (the tensor cores would round float32 through TF32,
// ~1e-3, far outside the float32 gate of 2e-5).
//
// bf16 design (FlashAttention-2, written by hand).  One block of 4
// warps serves 64 query rows of one (b, h); each warp owns 16 rows.
// A warp's q fragments are loaded once from global memory into
// registers.  The block walks tiles of 64 keys of kv head h / G, staged
// in shared memory as bf16 by 16-byte cp.async copies (rows past S
// zero-filled) through a ring of 3 stages (2 at hd 128), so two tiles
// are in flight while one is computed, with one __syncthreads per tile;
// at hd 64 the ring is 54 KB, so four blocks share an SM.  Shared rows
// are padded by 16 bytes, so the 8 rows an ldmatrix phase reads fall in
// distinct banks.  Q . K^T and P . V run as mma.sync m16n8k16 bf16 ->
// float32, fragments from ldmatrix (.trans for V).  The online softmax
// works on the score fragments in registers: a thread holds two rows'
// scores, the row max takes two quad shuffles, each score is
// exponentiated once (ex2 of s * scale * log2 e - m * scale * log2 e,
// one fma), and the
// row sums stay per thread until the epilogue's two quad shuffles.  P
// is converted to bf16 in registers and used as P . V's A operand with
// no trip through shared memory.  Rounding P to one bf16 moves the
// output by up to 3.9e-3 before its own rounding, which flips bf16
// output roundings by 1.6e-2 (CPU estimates at the serve shape), too
// near the 2e-2 gate; so P is carried as two bf16 terms, hi = bf16(p)
// and lo = bf16(p - hi), and P . V is two mma per fragment, which keeps
// ~16 bits of p.  O accumulates in float32 registers; the epilogue
// divides by l + 1e-30 and writes bf16 pairs straight into (B, S, H,
// hd).  The query blocks of a (b, h) run heaviest first: blockIdx.y
// counts from the last block under the causal mask, and (b, h) is the
// fastest grid axis, so the longest rows of every head start first.
//
// float32 design.  One block of 128 threads serves (32 query rows,
// head h, batch row b): four threads per query row, each holding a
// quarter of the row's q and acc in registers; each 32-key tile is
// staged in shared memory as float32, a thread computes its partial dot
// for every key, two xor-shuffles give all four the full score, and
// each then updates its slice of acc.
//
// Widths.  Both kernels take a (query/key width, value width) pair:
// (32, 32), (64, 64) and (128, 128) for GQA, and (192, 128) for
// DeepSeek-V2's MLA prefill (src/repro/models/attention.py, mla_forward:
// q, k (B, S, 16, 192) of nope 128 + rope 64, v (B, S, 16, 128), scale
// 192^-0.5).  Q . K^T then takes 12 k-steps and O 16 n-tiles; the K ring
// holds 192-wide rows and the V ring 128-wide ones (86 KB in two
// stages).  The q fragments take 16 more registers than at hd 128, so
// the bf16 kernel runs at the 255-register ceiling there and spills 20
// bytes a thread (ptxas -v): right first; staging q in shared memory
// and reading its fragments by ldmatrix would free them.
//
// Bound.  At the long serve prompt (B 32, S 1,024, H 16, hd 64, bf16)
// the kernel must read q, k, v and write o, 268 MB, ~0.080 ms at
// 3.35 TB/s, and do 4 * B * H * hd * S (S + 1) / 2 ~ 69 GFLOP, ~0.069
// ms at 989 TFLOP/s on the tensor cores: ~0.08 ms a launch.  The bf16
// kernel's P . V is two products (hi and lo), so it issues 1.5 times
// the tensor-core work the bound counts, and recomputes nothing else;
// K and V are read once per 64-row query block (16 times at S 1,024),
// mostly from L2.  Whisper's encoder (B 32, S 1,500, 16 x 64, unmasked,
// float32 under the engine's float32 frames, so on the CUDA cores) does
// 4 * B * H * hd * S^2 ~ 295 GFLOP, ~4.4 ms at 67 TFLOP/s; its
// cross-attention (32 queries over SK = 1,500 keys) is bound by reading
// K and V once, 393 MB in float32, ~0.12 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- float32

constexpr int kRows = 32;                  // query rows per block
constexpr int kLanes = 4;                  // threads per query row
constexpr int kKeys = 32;                  // keys per kv tile
constexpr int kThreads = kRows * kLanes;   // 128

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// HDQ is q's and k's width, HDV v's and the output's
template <int HDQ, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int S, int SK, int H, int KV,
                       float scale, int causal, int window) {
  constexpr int kChunks = HDQ / 4;         // float4 chunks in a q/k row
  constexpr int kMine = kChunks / kLanes;  // chunks a thread holds
  constexpr int kVChunks = HDV / 4;        // float4 chunks in a v row
  constexpr int kVMine = kVChunks / kLanes;
  static_assert(kChunks % kLanes == 0 && kVChunks % kLanes == 0,
                "head widths must be multiples of 16");
  __shared__ float4 ks[kKeys][kChunks];
  __shared__ float4 vs[kKeys][kVChunks];

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int pq = q0 + row;

  float4 qr[kMine];
  float4 acc[kVMine];
  const float* qrow = q + ((static_cast<int64_t>(b) * S + pq) * H + h) * HDQ;
#pragma unroll
  for (int i = 0; i < kMine; ++i)
    qr[i] = pq < S ? load4(qrow + 4 * (lane + kLanes * i))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kVMine; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf;
  float l = 0.f;

  // keys any row of this block admits: [lo, hi)
  int hi = SK;
  if (causal) hi = min(SK, q0 + kRows);
  int lo = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo = reach <= 0 ? 0 : reach >= SK ? SK : static_cast<int>(reach);
  }

  for (int t0 = lo; t0 < hi; t0 += kKeys) {
    for (int e = tid; e < kKeys * kChunks; e += kThreads) {
      const int j = e / kChunks;
      const int c = e % kChunks;
      const int pk = t0 + j;
      ks[j][c] = pk < SK ? load4(k + ((static_cast<int64_t>(b) * SK + pk) *
                                          KV + kvh) * HDQ + 4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int e = tid; e < kKeys * kVChunks; e += kThreads) {
      const int j = e / kVChunks;
      const int c = e % kVChunks;
      const int pk = t0 + j;
      vs[j][c] = pk < SK ? load4(v + ((static_cast<int64_t>(b) * SK + pk) *
                                          KV + kvh) * HDV + 4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
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
      bool ok = pk < SK;
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
    for (int i = 0; i < kVMine; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < kVMine; ++i) {
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
    float* orow = out + ((static_cast<int64_t>(b) * S + pq) * H + h) * HDV;
#pragma unroll
    for (int i = 0; i < kVMine; ++i) {
      store4(orow + 4 * (lane + kLanes * i),
             make_float4(acc[i].x / denom, acc[i].y / denom,
                         acc[i].z / denom, acc[i].w / denom));
    }
    if (lse != nullptr && lane == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + pq] =
          l > 0.f ? m + logf(l) : INFINITY;
  }
}

// --------------------------------------------------------------- bfloat16

constexpr int kBlockRows = 64;             // query rows per block
constexpr int kTileKeys = 64;              // keys per kv tile
constexpr int kWarpThreads = 128;          // 4 warps, 16 rows each

template <int HDQ, int HDV>
struct Bf16Tile {
  static constexpr int kKStride = HDQ + 8; // bf16 per padded smem row
  static constexpr int kVStride = HDV + 8;
  static constexpr int kKElems = 64 * kKStride;
  static constexpr int kVElems = 64 * kVStride;
  static constexpr int kStages = HDQ + HDV >= 256 ? 2 : 3;
  // the K ring, then the V ring (q goes straight to registers)
  static constexpr int kSmemBytes = kStages * (kKElems + kVElems) * 2;
};

// 64 rows of head `head` from row `row0` of a (B, S, heads, HD) tensor
// into a padded shared tile; rows at or past S are zero-filled (S is the
// key length SK where the kernel stages k and v)
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int b,
                                          int S, int heads, int head,
                                          int row0) {
  constexpr int kChunks = HD / 8;          // 16-byte chunks per row
  constexpr int kStride = HD + 8;          // bf16 per padded smem row
  static_assert(64 * kChunks % kWarpThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kWarpThreads; ++i) {
    const int c = threadIdx.x + i * kWarpThreads;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const int pos = row0 + r;
    const bool ok = pos < S;
    const __nv_bfloat16* g =
        src + ((static_cast<int64_t>(b) * S + (ok ? pos : 0)) * heads +
               head) * HD + ch * 8;
    cp_async16(dst + r * kStride + ch * 8, g, ok);
  }
}

// at hd 32 and 64, four blocks an SM (at most 128 registers a thread,
// which the hd 64 kernel fits without spilling); hd 128 needs 250.
// HDQ is q's and k's width, HDV v's and the output's.
template <int HDQ, int HDV>
__global__ void __launch_bounds__(kWarpThreads, HDQ + HDV >= 256 ? 1 : 4)
flash_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int S, int SK, int H,
                            int KV, float scale_log2, int causal,
                            int window) {
  // scores stay unscaled until the exponent: p = exp2(s * c - m * c)
  using Tile = Bf16Tile<HDQ, HDV>;
  constexpr int kKStride = Tile::kKStride;
  constexpr int kVStride = Tile::kVStride;
  constexpr int kStages = Tile::kStages;
  constexpr int kK = HDQ / 16;             // k-steps of Q . K^T
  constexpr int kD = HDV / 8;              // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kStages * Tile::kKElems;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockRows;
  const int kvh = h / (H / KV);

  // keys any row of this block admits: [lo, hi)
  const int hi = causal ? min(SK, q0 + kBlockRows) : SK;
  int lo = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo = reach <= 0 ? 0 : reach >= SK ? SK : static_cast<int>(reach);
  }
  const int n_tiles = hi > lo ? (hi - lo + kTileKeys - 1) / kTileKeys : 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      load_rows<HDQ>(ks + st * Tile::kKElems, k, b, SK, KV, kvh,
                     lo + st * kTileKeys);
      load_rows<HDV>(vs + st * Tile::kVElems, v, b, SK, KV, kvh,
                     lo + st * kTileKeys);
    }
    cp_async_commit();
  }

  // this thread's rows: pq0 and pq0 + 8; its q fragments (A of Q . K^T:
  // rows pq0 / pq1, columns 2 (lane % 4) + {0, 1} and + 8 of each
  // 16-wide k-step) straight from global memory, 0 past S
  const int pq0 = q0 + warp * 16 + lane / 4;
  const int pq1 = pq0 + 8;
  const int col = 2 * (lane & 3);
  uint32_t qf[kK][4];
  {
    const __nv_bfloat16* r0 =
        q + ((static_cast<int64_t>(b) * S + pq0) * H + h) * HDQ + col;
    const __nv_bfloat16* r1 = r0 + static_cast<int64_t>(8) * H * HDQ;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      qf[kk][0] = pq0 < S ? *reinterpret_cast<const uint32_t*>(r0 + kk * 16)
                          : 0u;
      qf[kk][1] = pq1 < S ? *reinterpret_cast<const uint32_t*>(r1 + kk * 16)
                          : 0u;
      qf[kk][2] = pq0 < S
                      ? *reinterpret_cast<const uint32_t*>(r0 + kk * 16 + 8)
                      : 0u;
      qf[kk][3] = pq1 < S
                      ? *reinterpret_cast<const uint32_t*>(r1 + kk * 16 + 8)
                      : 0u;
    }
  }
  float o[kD][4];
#pragma unroll
  for (int t = 0; t < kD; ++t)
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;        // running max (unscaled)
  float l0 = 0.f, l1 = 0.f;                // this thread's share of l

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nxt = i + kStages - 1;
      if (nxt < n_tiles) {
        const int st = nxt % kStages;
        load_rows<HDQ>(ks + st * Tile::kKElems, k, b, SK, KV, kvh,
                       lo + nxt * kTileKeys);
        load_rows<HDV>(vs + st * Tile::kVElems, v, b, SK, KV, kvh,
                       lo + nxt * kTileKeys);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* kt = ks + (i % kStages) * Tile::kKElems;
    const __nv_bfloat16* vt = vs + (i % kStages) * Tile::kVElems;
    const int t0 = lo + i * kTileKeys;

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kKStride +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], r[2], r[3]);
      }
    }

    // mask only a tile the mask cuts
    const bool cut =
        t0 + kTileKeys > SK || (causal && t0 + kTileKeys - 1 > q0) ||
        (window != 0 && static_cast<int64_t>(t0) <=
                            static_cast<int64_t>(q0) + kBlockRows - 1 -
                                window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e];
        if (cut) {
          const int pk = t0 + t * 8 + 2 * (lane & 3) + (e & 1);
          const int pq = e < 2 ? pq0 : pq1;
          bool ok = pk < SK;
          if (causal) ok = ok && pk <= pq;
          if (window != 0) ok = ok && pq - pk < window;
          x = ok ? x : kNegInf;
        }
        s[t][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row with nothing admitted yet keeps m = NEG_INF; subtracting 0
    // then sends its masked scores to exp2(NEG_INF) = 0
    const float base0 = mx0 == kNegInf ? 0.f : mx0 * scale_log2;
    const float base1 = mx1 == kNegInf ? 0.f : mx1 * scale_log2;
    const float alpha0 = fast_exp2(fmaf(m0, scale_log2, -base0));
    const float alpha1 = fast_exp2(fmaf(m1, scale_log2, -base1));
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int t = 0; t < kD; ++t) {
      o[t][0] *= alpha0;
      o[t][1] *= alpha0;
      o[t][2] *= alpha1;
      o[t][3] *= alpha1;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = fast_exp2(fmaf(s[t][0], scale_log2, -base0));
      s[t][1] = fast_exp2(fmaf(s[t][1], scale_log2, -base0));
      s[t][2] = fast_exp2(fmaf(s[t][2], scale_log2, -base1));
      s[t][3] = fast_exp2(fmaf(s[t][3], scale_log2, -base1));
      l0 += s[t][0] + s[t][1];
      l1 += s[t][2] + s[t][3];
    }

    // O += P . V, P as hi + lo bf16 A fragments, 4 k-steps of 16 keys
#pragma unroll
    for (int js = 0; js < 4; ++js) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * js][0], s[2 * js][1], ph[0], pl[0]);
      split_bf16(s[2 * js][2], s[2 * js][3], ph[1], pl[1]);
      split_bf16(s[2 * js + 1][0], s[2 * js + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * js + 1][2], s[2 * js + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kD / 2; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, vt + (js * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kVStride + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, r[0], r[1]);
        mma_bf16(o[2 * dp], pl, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], ph, r[2], r[3]);
        mma_bf16(o[2 * dp + 1], pl, r[2], r[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (lse != nullptr && (lane & 3) == 0) {
    float* lrow = lse + (static_cast<int64_t>(b) * H + h) * S;
    if (pq0 < S)
      lrow[pq0] = l0 > 0.f ? (m0 * scale_log2 + log2f(l0)) * kLn2 : INFINITY;
    if (pq1 < S)
      lrow[pq1] = l1 > 0.f ? (m1 * scale_log2 + log2f(l1)) * kLn2 : INFINITY;
  }
  const float d0 = l0 + 1e-30f;
  const float d1 = l1 + 1e-30f;
  if (pq0 < S) {
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * S + pq0) * H + h) * HDV + col;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(o[t][0] / d0, o[t][1] / d0);
  }
  if (pq1 < S) {
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * S + pq1) * H + h) * HDV + col;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(o[t][2] / d1, o[t][3] / d1);
  }
}

// ----------------------------------------------------------------- launch

template <int HDQ, int HDV>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int SK, int H, int KV, float scale,
               int causal, int window, cudaStream_t stream) {
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_kernel<HDQ, HDV><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, SK, H,
      KV, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HDQ, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int SK, int H, int KV, float scale,
                int causal, int window, cudaStream_t stream) {
  const int64_t heads = static_cast<int64_t>(B) * H;
  const int64_t blocks = (static_cast<int64_t>(S) + kBlockRows - 1) /
                         kBlockRows;
  if (heads > 0x7fffffff || blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Bf16Tile<HDQ, HDV>::kSmemBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel_bf16<HDQ, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(heads),
                  static_cast<unsigned>(blocks));
  flash_attention_kernel_bf16<HDQ, HDV><<<grid, kWarpThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, S, SK, H, KV, scale * kLog2e,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 (float32) launches flash_attention_kernel over a (ceil(S /
// 32), H, B) grid; dtype 1 (bfloat16) flash_attention_kernel_bf16 over
// a (B * H, ceil(S / 64)) grid; S is q's length and SK k's and v's
// (SK == S unless causal is 0); (hd, hdv) is (32, 32), (64, 64),
// (128, 128) or (192, 128), hd q's and k's width, hdv v's and the
// output's; on `stream`.  A non-null lse (B, H, S) float32 takes each
// row's log-sum-exp (+inf where no key is admitted).  Returns the
// first CUDA error of setting the shared-memory size or of the launch, 0
// if none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int SK, int H, int KV, int hd,
                                      int hdv, int dtype, float scale,
                                      int causal, int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0 || SK < 0 || (causal && SK != S))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS                                                          \
  q, k, v, out, static_cast<float*>(lse), B, S, SK, H, KV, scale, causal, \
      window, st
  if (hd == 192 && hdv == 128) {
    if (dtype == 0) return launch_f32<192, 128>(FA_ARGS);
    if (dtype == 1) return launch_bf16<192, 128>(FA_ARGS);
  }
  if (hd == hdv && dtype == 0) {
    switch (hd) {
      case 32:
        return launch_f32<32, 32>(FA_ARGS);
      case 64:
        return launch_f32<64, 64>(FA_ARGS);
      case 128:
        return launch_f32<128, 128>(FA_ARGS);
    }
  } else if (hd == hdv && dtype == 1) {
    switch (hd) {
      case 32:
        return launch_bf16<32, 32>(FA_ARGS);
      case 64:
        return launch_bf16<64, 64>(FA_ARGS);
      case 128:
        return launch_bf16<128, 128>(FA_ARGS);
    }
  }
#undef FA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
