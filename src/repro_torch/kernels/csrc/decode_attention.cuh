// GQA decode attention: one query token per batch row against its KV
// cache, for the port's dense transformer, split across the cache axis
// (flash-decoding).
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
// Design.  The Pallas grid (B*KV, S/bk) streams the cache through VMEM
// in order and keeps the statistics in scratch.  Here the grid is
// (splits, KV, B): block (s, kvh, b) serves the G = H / KV <= 8 query
// heads of kv head kvh in row b over the fixed slice [s * chunk,
// (s + 1) * chunk) of the cache, clipped on the device to the row's
// admitted interval [lo, hi), lo = max(0, len - window + 1) under a
// window and hi = min(S, len + 1): positions past the row's length are
// never read, and the host never reads lengths.  The wrapper picks
// splits so that the grid fills the SMs about twice (1 split at batch
// 32, up to one tile per split at batch 1, at most 64).  Within its
// slice a block walks tiles of 4,096 / hd positions, staged in shared
// memory in the cache's own type by 16-byte cp.async copies through a
// ring of 3 stages, so two tiles are in flight while one is computed;
// rows outside the slice are zero-filled and never read.  The scratch
// beside the ring is sized for the launch's G, so at hd 64 and G = 1
// (qwen1.5-0.5b) the block takes 55 KB and four blocks share an SM: the
// 512 blocks of batch 32 run in one wave.  Shared rows are padded by 16
// bytes, so the threads that each take one position's dot product read
// distinct banks.  Per tile the G x tile scores go to shared memory
// (where G x tile is under 128, 2 or 4 neighbouring threads split each
// dot and add with shuffles), one warp per query head reduces its tile
// max and sum with shuffles, and every thread then updates its (head,
// dim) slice of the accumulator in registers (where G x hd is under
// 128, 2 or 4 threads share a slice, each taking every 2nd or 4th
// position, and add their sums once, after the last tile).
//
// Merge.  With one split a block writes its output directly.  With
// more, each block writes its float32 partial (m, l, acc[G, hd]) to a
// workspace (an empty slice writes m = NEG_INF, l = 0, acc = 0), then
// takes a ticket from the (b, kvh) counter with atomicAdd: one thread
// for the block, after a block barrier, between two fence.acq_rel.gpu
// (the release and acquire pattern of CUTLASS's grid barriers, lighter
// than a __threadfence in every thread).  The block that draws the last
// ticket merges the partials in split order, so the result is the same
// bits from run to run whichever block finishes last: it loads every
// split's m, l and acc into shared memory in one round (the ring is
// free by then; at G * hd * splits beyond its size, in several), and
// each thread forms max m, the weights exp(m_s - max m) and l for its
// head there, so the merge costs one memory latency and one barrier;
// then it writes the output and resets the counter to 0 for the next
// launch: one launch per call.
//
// The partials entry.  Where a device mesh splits the cache's sequence
// over ranks, each rank attends its own slice (lengths shifted by the
// slice's offset) and the ranks merge their statistics.  With the
// partials pointers set, the kernel writes, in place of the output,
// the float32 (m, l, acc) of the whole launch before its division: with
// one split the block's own m, l and acc; with more, the last block's
// merge (max m, sum w_s l_s, sum w_s acc_s) before dividing.  m and l
// are (B, KV, G, 1) and acc (B, KV, G, hd), the layout of the plain
// _partials_plain; a row whose slice holds no admitted position (the
// whole slice past lengths[b] after the shift, or before the window)
// writes m = NEG_INF, l = 0, acc = 0, which the ranks' merge weighs 0.  The wrapper owns the workspace and the
// counters (one set per device, zeroed when allocated); two launches
// that share them must not run concurrently.
//
// Bound.  Decoding reads the admitted cache once: at the long serve
// shape (B 32, cache 1,057, KV 16, hd 64, bf16) that is
// 2 * 32 * 1,057 * 16 * 64 * 2 B ~ 138 MB, ~0.041 ms at 3.35 TB/s; the
// products are ~0.14 GFLOP, far under any compute bound.  At batch 1
// the same cache row is 4.3 MB, ~0.0013 ms: there the launch, one tile
// per split and the merge set the time.
//
// The int8 cache.  decode_attention_int8_launch is the same kernel over
// int8 codes k, v (B, S, KV, hd) with float32 scales k_scale, v_scale
// (B, S, KV, 1), one per (position, kv head), as the reference model's
// int8 gqa_decode keeps them (src/repro/models/attention.py, the
// k_scale branch).  The ring stages the codes (a tile is 4,096 bytes of
// codes, 4,096 / hd positions, as for the float caches) and the tile's
// scales, by 4-byte cp.async copies beside the rows; the codes become
// floats in registers, so the cache is never dequantized into a copy.
// The score is (q . k_i8) * hd^-0.5 * k_scale; the probabilities the
// p . v pass reads are p * v_scale, while l sums p alone, so out =
// sum(p * v_scale * v_i8) / (l + 1e-30) is the reference's normalised
// softmax times the value scales.  Splits and merge are unchanged.  Its
// bound is the codes and scales read once: at the long shape (B 32,
// cache 1,057, KV 16, hd 64) 2 * 32 * 1,057 * 16 * (64 + 4) B ~ 73.6 MB,
// ~0.022 ms at 3.35 TB/s, about half the bf16 cache's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;              // query heads per kv head
constexpr int kMaxSplits = 64;            // the merge's scratch holds these

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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
// the 16-byte chunk as 16 int8 codes
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const int8_t*) {
  const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[4 * i] = static_cast<float>(c[i].x);
    out[4 * i + 1] = static_cast<float>(c[i].y);
    out[4 * i + 2] = static_cast<float>(c[i].z);
    out[4 * i + 3] = static_cast<float>(c[i].w);
  }
}

// 16 bytes from global to shared; zero-filled (nothing read) unless ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes from global to shared, zero-filled unless ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The score of one cache row shared by L neighbouring lanes (L = 1, 2
// or 4): lane `sub` of the group takes chunks sub, sub + L, ...; every
// lane of the warp must call it (the shuffles span the warp).
template <int L, int kChunks, typename T>
__device__ __forceinline__ float row_dot(const uint4* kr, const float* qg,
                                         int sub) {
  constexpr int kVec = 16 / sizeof(T);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks / L; ++i) {
    const int c = sub + i * L;
    float kf[kVec];
    unpack(kr[c], kf, static_cast<const T*>(nullptr));
#pragma unroll
    for (int x = 0; x < kVec; ++x) dot = fmaf(qg[c * kVec + x], kf[x], dot);
  }
#pragma unroll
  for (int o = 1; o < L; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  return dot;
}

// sum over j = part, part + P, ... < nv of p[j] * v[j][d], in four
// interleaved partial sums
template <int P, typename T>
__device__ __forceinline__ float col_dot(const float* pg, const T* vd,
                                         int row_elems, int part, int nv) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int j = part;
  for (; j + 3 * P < nv; j += 4 * P) {
    s0 = fmaf(pg[j], to_f32(vd[j * row_elems]), s0);
    s1 = fmaf(pg[j + P], to_f32(vd[(j + P) * row_elems]), s1);
    s2 = fmaf(pg[j + 2 * P], to_f32(vd[(j + 2 * P) * row_elems]), s2);
    s3 = fmaf(pg[j + 3 * P], to_f32(vd[(j + 3 * P) * row_elems]), s3);
  }
  for (; j < nv; j += P) s0 = fmaf(pg[j], to_f32(vd[j * row_elems]), s0);
  return (s0 + s1) + (s2 + s3);
}

// The ring's geometry for a cache of element type C (float, bf16 or
// int8 codes; an int8 stage also holds the tile's k and v scales)
template <typename C, int HD>
struct DecodeTile {
  static constexpr bool kQuant = std::is_same<C, int8_t>::value;
  static constexpr int kTile = 4096 / HD;               // positions
  static constexpr int kRowChunks = HD * sizeof(C) / 16;
  static constexpr int kRowBytes = HD * sizeof(C) + 16;  // padded row
  static constexpr int kStages = 3;
  static constexpr int kScaleBytes = kQuant ? 2 * kTile * 4 : 0;
  // K rows, V rows, then (int8) the k and v scales
  static constexpr int kStageBytes = 2 * kTile * kRowBytes + kScaleBytes;
  // the ring, then q (float32) and the tile's scores for G query heads
  static constexpr int smem_bytes(int G) {
    return kStages * kStageBytes + 4 * G * (HD + kTile);
  }
};

// T is q's and the output's type, C the cache's; the scales are read
// only when C is int8 (null otherwise)
template <typename T, typename C, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const C* __restrict__ k,
                        const C* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ pm,
                        float* __restrict__ pl, float* __restrict__ pa,
                        float* __restrict__ ws, int* __restrict__ tickets,
                        int S, int H, int KV, float scale, int window,
                        int chunk) {
  using Tile = DecodeTile<C, HD>;
  constexpr int kTile = Tile::kTile;
  constexpr int kStages = Tile::kStages;
  constexpr int kRowElems = Tile::kRowBytes / sizeof(C);
  constexpr int kVec = 16 / sizeof(C);    // elements per 16-byte chunk
  constexpr int kMaxAcc = kMaxGroup * HD / kThreads;
  constexpr int kLoads = kTile * Tile::kRowChunks / kThreads;
  static_assert(kTile * Tile::kRowChunks % kThreads == 0, "tile split");
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  float* q_s = reinterpret_cast<float*>(smem + kStages * Tile::kStageBytes);
  float* p_s = q_s + G * HD;
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], a_s[kMaxGroup];
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_out = G * HD;
  // threads that share one score (a power of 2 <= 4) and one output
  const int n_dot = G * kTile;
  const int dot_lanes = kThreads % n_dot == 0 ? kThreads / n_dot : 1;
  const int parts = kThreads % n_out == 0 ? kThreads / n_out : 1;
  const int part = parts > 1 ? tid / n_out : 0;
  const int o0 = parts > 1 ? tid % n_out : tid;

  const int64_t len = lengths[b];
  const T* qrow = q + (static_cast<int64_t>(b) * H + kvh * G) * HD;
  for (int e = tid; e < n_out; e += kThreads) q_s[e] = to_f32(qrow[e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // the row's admitted interval, clipped to this split's slice
  int64_t hi = len + 1 < S ? len + 1 : S;
  int64_t lo = 0;
  if (window != 0) lo = len - window + 1 > 0 ? len - window + 1 : 0;
  const int64_t c0 = static_cast<int64_t>(split) * chunk;
  if (lo < c0) lo = c0;
  if (hi > c0 + chunk) hi = c0 + chunk;
  if (hi < lo) hi = lo;
  const int blo = static_cast<int>(lo);
  const int bhi = static_cast<int>(hi);
  const int n_tiles = (bhi - blo + kTile - 1) / kTile;

  // this thread's 16-byte chunks of tile i, K and V, into its stage
  auto load_tile = [&](int i) {
    unsigned char* st = smem + (i % kStages) * Tile::kStageBytes;
    const int t0 = blo + i * kTile;
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int c = tid + n * kThreads;
      const int j = c / Tile::kRowChunks;
      const int ch = c % Tile::kRowChunks;
      const int pos = t0 + j;
      const bool ok = pos < bhi;
      const int64_t off =
          ((static_cast<int64_t>(b) * S + (ok ? pos : 0)) * KV + kvh) * HD +
          ch * kVec;
      unsigned char* dst = st + j * Tile::kRowBytes + ch * 16;
      cp_async16(dst, k + off, ok);
      cp_async16(dst + kTile * Tile::kRowBytes, v + off, ok);
    }
    if constexpr (Tile::kQuant) {
      float* sc = reinterpret_cast<float*>(st + 2 * kTile * Tile::kRowBytes);
      for (int j = tid; j < kTile; j += kThreads) {
        const int pos = t0 + j;
        const bool ok = pos < bhi;
        const int64_t off =
            (static_cast<int64_t>(b) * S + (ok ? pos : 0)) * KV + kvh;
        cp_async4(sc + j, k_scale + off, ok);
        cp_async4(sc + kTile + j, v_scale + off, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }

  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % kStages) * Tile::kStageBytes;
    const C* k_t = reinterpret_cast<const C*>(st);
    const C* v_t = reinterpret_cast<const C*>(st + kTile * Tile::kRowBytes);
    // the tile's k and v scales (int8 only)
    const float* ks_t =
        reinterpret_cast<const float*>(st + 2 * kTile * Tile::kRowBytes);
    const float* vs_t = ks_t + kTile;
    const int nv = min(kTile, bhi - (blo + i * kTile));  // positions held

    // scores: dot_lanes neighbouring threads share one (head, position);
    // rows past nv are zeros in the stage, masked here
    for (int e = tid / dot_lanes; e < n_dot; e += kThreads / dot_lanes) {
      const int g = e / kTile;
      const int j = e % kTile;
      const uint4* kr = reinterpret_cast<const uint4*>(k_t + j * kRowElems);
      const float* qg = q_s + g * HD;
      const int sub = tid % dot_lanes;
      const float dot =
          dot_lanes == 4 ? row_dot<4, Tile::kRowChunks, C>(kr, qg, sub)
          : dot_lanes == 2 ? row_dot<2, Tile::kRowChunks, C>(kr, qg, sub)
                           : row_dot<1, Tile::kRowChunks, C>(kr, qg, sub);
      float sc = dot * scale;
      if constexpr (Tile::kQuant) sc *= ks_t[j];
      if (sub == 0) p_s[e] = j < nv ? sc : kNegInf;
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
        const float p = j < nv ? expf(p_s[g * kTile + j] - m_new) : 0.f;
        // the p . v pass reads p * v_scale on the int8 cache; l sums p
        if constexpr (Tile::kQuant)
          p_s[g * kTile + j] = p * vs_t[j];
        else
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

    // p . v: `parts` threads share one (head, dim), each taking every
    // parts-th position
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int o = o0 + r * kThreads;
      if (o < n_out) {
        const int g = o / HD;
        const int d = o % HD;
        const float* pg = p_s + g * kTile;
        const C* vd = v_t + d;
        const float sum =
            parts == 4 ? col_dot<4>(pg, vd, kRowElems, part, nv)
            : parts == 2 ? col_dot<2>(pg, vd, kRowElems, part, nv)
                         : col_dot<1>(pg, vd, kRowElems, part, nv);
        acc[r] = acc[r] * a_s[g] + sum;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the ring is free now: scratch for the parts' sums and the merge
  float* scratch = reinterpret_cast<float*>(smem);
  if (parts > 1) {
    scratch[tid] = acc[0];
    __syncthreads();
    if (part == 0)
      for (int p = 1; p < parts; ++p) acc[0] += scratch[o0 + p * n_out];
    __syncthreads();
  }

  // the partials entry (pa != null) writes m, l and acc where the plain
  // entry writes acc / (l + 1e-30): the row's (b, kvh) heads at
  // [b * H + kvh * G + g], acc at [(...) * HD + d]
  const int64_t row0 = static_cast<int64_t>(b) * H + kvh * G;
  T* orow = out + row0 * HD;
  if (splits == 1 && pa != nullptr) {
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int o = o0 + r * kThreads;
      if (part == 0 && o < n_out) pa[row0 * HD + o] = acc[r];
    }
    if (tid < G) {
      pm[row0 + tid] = m_s[tid];
      pl[row0 + tid] = l_s[tid];
    }
    return;
  }
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int o = o0 + r * kThreads;
      if (part == 0 && o < n_out)
        orow[o] = from_f32(acc[r] / (l_s[o / HD] + 1e-30f), orow);
    }
    return;
  }

  // the partial of this split: m and l at [slot], acc at [slot * HD]
  const int64_t n_part =
      static_cast<int64_t>(gridDim.z) * KV * splits * G;
  float* wm = ws;
  float* wl = ws + n_part;
  float* wa = ws + 2 * n_part;
  const int64_t first = (static_cast<int64_t>(b) * KV + kvh) * splits * G;
  const int64_t slot = first + static_cast<int64_t>(split) * G;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int o = o0 + r * kThreads;
    if (part == 0 && o < n_out) wa[slot * HD + o] = acc[r];
  }
  if (tid < G) {
    wm[slot + tid] = m_s[tid];
    wl[slot + tid] = l_s[tid];
  }
  // release the block's writes with the ticket, acquire the others'
  // with the last one (the block barrier carries them to thread 0)
  __syncthreads();
  int* ticket = tickets + static_cast<int64_t>(b) * KV + kvh;
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    last_s = atomicAdd(ticket, 1) == splits - 1;
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (!last_s) return;

  // the last block merges every split's partial in split order.  The
  // statistics of all splits and as many splits' accumulators as the
  // free ring holds (all of them unless G * hd * splits is large) come
  // into shared memory in one round of loads; each thread then forms
  // max m, the weights exp(m_s - max m) and l for its own head there.
  const int n_stat = splits * G;
  float* sm = scratch;
  float* sl = sm + n_stat;
  float* sa = sl + n_stat;                 // accumulators, split-major
  const int per_round =
      (kStages * Tile::kStageBytes / 4 - 2 * n_stat) / n_out;
  const float* wa_first = wa + first * HD;
  auto stage = [&](int s0) {
    const int n = min(per_round, splits - s0) * n_out;
    for (int e = tid; e < n; e += kThreads)
      sa[e] = __ldcg(wa_first + static_cast<int64_t>(s0) * n_out + e);
  };
  for (int e = tid; e < n_stat; e += kThreads) {
    sm[e] = __ldcg(wm + first + e);
    sl[e] = __ldcg(wl + first + e);
  }
  stage(0);
  __syncthreads();
  float top[kMaxAcc], l[kMaxAcc], a[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int g = min(tid + r * kThreads, n_out - 1) / HD;
    top[r] = kNegInf;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) top[r] = fmaxf(top[r], sm[s * G + g]);
    l[r] = a[r] = 0.f;
  }
  for (int s0 = 0; s0 < splits; s0 += per_round) {
    if (s0 > 0) {
      __syncthreads();
      stage(s0);
      __syncthreads();
    }
    const int s1 = min(splits, s0 + per_round);
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int o = tid + r * kThreads;
      if (o < n_out) {
        const int g = o / HD;
#pragma unroll 4
        for (int s = s0; s < s1; ++s) {
          const float w = expf(sm[s * G + g] - top[r]);
          l[r] = fmaf(sl[s * G + g], w, l[r]);
          a[r] = fmaf(sa[(s - s0) * n_out + o], w, a[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int o = tid + r * kThreads;
    if (o >= n_out) continue;
    if (pa == nullptr) {
      orow[o] = from_f32(a[r] / (l[r] + 1e-30f), orow);
      continue;
    }
    pa[row0 * HD + o] = a[r];
    if (o % HD == 0) {
      pm[row0 + o / HD] = top[r];
      pl[row0 + o / HD] = l[r];
    }
  }
  if (tid == 0) *ticket = 0;
}

// the pointers and sizes of one launch
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const void* lengths;
  void* out;
  float* pm;  // the partials entry's m, l, acc (null: the plain entry)
  float* pl;
  float* pa;
  void* ws;
  void* tickets;
  int B, S, H, KV;
  float scale;
  int window, splits, chunk;
  cudaStream_t stream;
};

template <typename T, typename C, int HD>
int launch_typed(const Args& a) {
  const cudaError_t set = cudaFuncSetAttribute(
      decode_attention_kernel<T, C, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      DecodeTile<C, HD>::smem_bytes(kMaxGroup));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int smem = DecodeTile<C, HD>::smem_bytes(a.H / a.KV);
  const dim3 grid(a.splits, a.KV, a.B);
  decode_attention_kernel<T, C, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k),
      static_cast<const C*>(a.v), a.k_scale, a.v_scale,
      static_cast<const int32_t*>(a.lengths), static_cast<T*>(a.out), a.pm,
      a.pl, a.pa, static_cast<float*>(a.ws), static_cast<int*>(a.tickets),
      a.S, a.H, a.KV, a.scale, a.window, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C>
int launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32:
      return launch_typed<T, C, 32>(a);
    case 64:
      return launch_typed<T, C, 64>(a);
    case 128:
      return launch_typed<T, C, 128>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int B, int S, int H, int KV, int splits, int chunk,
               const void* ws, const void* tickets, const void* out,
               const void* pm, const void* pl, const void* pa) {
  // exactly one of the output and the partials triple
  const bool part = pa != nullptr;
  return KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || B > 65535 ||
         KV > 65535 || splits < 1 || splits > kMaxSplits || chunk < 1 ||
         static_cast<int64_t>(splits) * chunk < S ||
         (splits > 1 && (ws == nullptr || tickets == nullptr)) ||
         (part ? (out != nullptr || pm == nullptr || pl == nullptr)
               : (out == nullptr || pm != nullptr || pl != nullptr));
}

}  // namespace
