// Absorbed multi-head latent attention (MLA) decode for the port's
// DeepSeek-V2 layers: one query token per batch row against its latent
// cache, split across the cache axis.
//
// Replaces no TPU kernel.  The reference computes this attention in
// float32 einsums outside any Pallas kernel (src/repro/models/
// attention.py, mla_decode, the chain from q_abs to ctx).  With the key
// absorbed into the query, every query head attends to one latent row
// per position: for q_abs (B, H, R) and q_pe (B, H, P) in float32, a
// cache c_kv (B, S, R) and k_pe (B, S, P) in float32 or bfloat16, and
// int32 lengths (B,), head h of row b scores position t as
//   s[h, t] = (q_abs[h] . c_kv[t] + q_pe[h] . k_pe[t]) * scale
// over the positions t <= lengths[b] (the slot at lengths[b] already
// holds the new token) and, when window != 0, lengths[b] - t < window,
// and writes the float32 context
//   ctx[h] = sum_t softmax(s[h])_t c_kv[t]          (B, H, R).
// The value is the key's first R columns.  The softmax is the
// reference's in float32: masked scores NEG_INF = -0.7 * FLT_MAX, a
// running max m, p = exp(s - m) (0 where masked), a running sum l and
// ctx = acc / (l + 1e-30), so a row with no admitted position gives 0.
// Built for DeepSeek-V2-Lite's widths: H 16, R 512 (kv_lora_rank), P 64
// (qk_rope_head_dim); the scale is 192^-0.5 there, passed in.
//
// Design.  The 16 heads are one 16-row mma.sync tile, so a block of 8
// warps serves one (row b, split) and runs both products on the TF32
// tensor cores (tensor_core.cuh), S (16 x T) = Q (16 x 576) . [c_kv ‖
// k_pe]^T and ctx (16 x 512) += P (16 x T) . c_kv (T x 512), as m16n8k8
// tf32 -> float32.  q and P are float32, each split into a rounded TF32
// term and its remainder; a bf16 cache value is exact in TF32, so a bf16
// cache takes two products (small . c + big . c), a float32 cache the
// full 3xTF32.  The CPU emulation (tests/test_torch_mla_tiles.py) holds
// this arithmetic, truncating sums included, within the 2e-5 gate.
//   - q is staged once per block, already split, in fragment order
//     (72 k-steps x 2 terms x 32 lanes x 16 bytes, 72 KB): a lane reads
//     a k-step's A fragment as two 16-byte loads, 8 lanes 128 contiguous
//     bytes.  Within a 32-wide depth group the k-index is relabelled
//     (k-step i's column c is depth 8c + 2i, c + 4 is 8c + 2i + 1), so a
//     lane's B values of four k-steps are one 16-byte chunk of a cache
//     row (two for a float32 row).
//   - The cache walks in tiles of T positions (64 in bf16, 32 in
//     float32: 72 KB either way) through a 2-stage cp.async ring, the
//     16-byte chunks of a row XOR-swizzled by the row so that both
//     products' fragment loads fall in distinct banks.  Rows past the
//     block's interval are zero-filled.  The next tile's copies are
//     issued at the start of each tile.
//   - Scores: warp (pq, dw) scores the positions of quarter pq of the
//     tile over depth half dw (9 groups of 32), each group's products
//     summed in zeroed fragments (the small and big terms apart) and
//     added to the scores in round-to-nearest: the tensor cores' float32
//     sums truncate.  The two depth halves meet through shared memory;
//     then each warp of a pair owns one n-tile of 8 positions (bf16), or
//     the dw = 0 warp the quarter's one (float32).
//   - Softmax: the tile max of each head through the quad shuffles and
//     an 8-warp shared array; p = exp(s - m), alpha = exp(m_old - m);
//     each thread keeps its share of l.  P goes to shared memory split
//     and in A-fragment order: its C fragment is the A fragment of the
//     P . V k-step once the positions are relabelled (A's column c is
//     position 2c, c + 4 is 2c + 1), so the owner writes its registers
//     as they are and every warp reads a k-step as two 16-byte loads.
//   - P . V: warp w owns context columns [64 w, 64 w + 64): 8 n-tiles,
//     32 accumulators a thread, whose columns are permuted so that a
//     lane's B values of 8 (bf16) or 4 (float32) n-tiles are one 16-byte
//     chunk of a cache row.  Each tile's products are summed in zeroed
//     fragments and added as o = o alpha + tile in round-to-nearest.
// 8 warps, not 4: with one block an SM the warps of a sub-partition
// hide each other's shared-memory and mma latency (4 warps, one a
// sub-partition, took ~9.4 us a tile on the H100).
// Splits.  The wrapper cuts the cache axis into `splits` slices of
// `chunk` positions (mla_splits: from the shapes and the SM count).  With
// one split a block writes ctx itself.  With more, each block writes its
// float32 partial (m, l, acc[H, R]; an empty slice m = NEG_INF, l = 0,
// acc = 0) to a workspace and counts itself in the row's int32 arrival
// counter; the row's last block merges the partials in split order
// (weights exp(m_s - max m), ctx = sum w_s acc_s / (sum w_s l_s +
// 1e-30)), so the bits never depend on which block ran first, and resets
// the counter for the next launch.
//
// Bound.  Decoding reads the admitted cache once: at the long serve
// shape (B 32, cache 1,057, bf16) 32 * 1,057 * 576 * 2 B = 39.0 MB,
// ~0.0116 ms at 3.35 TB/s; the two products are 2 * 16 * 1,088 flops a
// position (1.18 GFLOP each way), 4.8 us as two TF32 products at 494.7
// TFLOP/s: under the bytes.  One block an SM (its 224.5 KB of shared
// memory): the mma.sync issue and the shared-memory reads of q (each
// depth half read by 4 warps), not the bytes, set a tile's time: ~7,200
// cycles for a bf16 tile on the H100 (scores with the next tile's copies
// ~4,300, softmax ~800, P . V ~2,000), 2.8x the bound at the long shape.
// Copies issued by a producer warp, or by the tensor memory accelerator
// (bulk copies a row; 2-D maps with the 128-byte swizzle), were slower.

#include <float.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kH = 16;
constexpr int kR = 512;
constexpr int kP = 64;
constexpr int kK = kR + kP;                // key width, 576
constexpr int kGroups = kK / 32;           // depth groups of 32
constexpr int kHalfGroups = kGroups / 2;   // a warp's depth half
constexpr int kSteps = kK / 8;             // m16n8k8 k-steps
constexpr int kTileBytes = 73728;          // a stage of the cache ring
constexpr int kQBytes = kSteps * 32 * 8 * 4;
constexpr int kMaxSplits = 64;
static_assert(kGroups % 2 == 0 && kR % 32 == 0, "depth halves");

// the cache element type's tile shape and swizzle
template <typename T>
struct Cache;

template <>
struct Cache<__nv_bfloat16> {
  static constexpr int kT = 64;            // positions a tile
  static constexpr int kChunks = kK / 8;   // 16-byte chunks a row
  static constexpr int kRChunks = kR / 8;
  // score reads: the rows of a lane pair 2p, 2p + 1 differ in bit 2;
  // P . V reads: rows 2c (and 2c + 1) for c = 0..3 differ in bits 1-2
  __device__ static int swz(int r) {
    return (((r >> 1) & 3) ^ ((r & 1) << 1)) << 1;
  }
};

template <>
struct Cache<float> {
  static constexpr int kT = 32;
  static constexpr int kChunks = kK / 4;
  static constexpr int kRChunks = kR / 4;
  __device__ static int swz(int r) { return r & 7; }
};

template <typename T>
struct Smem {
  static constexpr int kT = Cache<T>::kT;
  static constexpr int kQ = 0;                        // q fragments
  static constexpr int kTiles = kQ + kQBytes;         // 2 stages
  static constexpr int kPf = kTiles + 2 * kTileBytes; // P fragments
  static constexpr int kRed = kPf + kT * 128;         // 8 x 16 floats
  static constexpr int kBytes = kRed + kWarps * kH * 4;
  static_assert(kT * Cache<T>::kChunks * 16 == kTileBytes, "tile size");
  // the depth halves' exchange (kT / 8 n-tiles x 32 lanes x 16 B) fits
  // in the P fragments' space, which it precedes in every tile
  static_assert((kT / 8) * 32 * 16 <= kT * 128, "exchange");
};

__device__ __forceinline__ const float* q_row(const float* q_abs,
                                              const float* q_pe, int b,
                                              int h, int d) {
  return d < kR ? q_abs + (static_cast<int64_t>(b) * kH + h) * kR + d
                : q_pe + (static_cast<int64_t>(b) * kH + h) * kP + d - kR;
}

// q split into big and small TF32 terms, in A-fragment order: k-step
// s = 4 G + i, lane (g, c): a0 = q[g][32 G + 8 c + 2 i], a1 = q[g + 8][..],
// a2 = q[g][.. + 1], a3 = q[g + 8][.. + 1], stored as 16-byte words at
// [s][term][lane] (term 0 big, 1 small: 8 lanes read 128 contiguous
// bytes).  One item a (group, step pair, lane): two 16-byte loads, all
// issued before the stores.
__device__ void stage_q(uint4* qf, const float* q_abs, const float* q_pe,
                        int b) {
  constexpr int kItems = (kGroups * 64 + kThreads - 1) / kThreads;
  float4 u[kItems], v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int it = threadIdx.x + k * kThreads;
    if (it >= kGroups * 64) break;
    const int ln = it & 31;
    const int d = 32 * (it >> 6) + 8 * (ln & 3) + 4 * ((it >> 5) & 1);
    u[k] = *reinterpret_cast<const float4*>(q_row(q_abs, q_pe, b, ln >> 2, d));
    v[k] = *reinterpret_cast<const float4*>(
        q_row(q_abs, q_pe, b, (ln >> 2) + 8, d));
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int it = threadIdx.x + k * kThreads;
    if (it >= kGroups * 64) break;
    const int ln = it & 31;
    const int s0 = 4 * (it >> 6) + 2 * ((it >> 5) & 1);
    const float x[2][4] = {{u[k].x, v[k].x, u[k].y, v[k].y},
                           {u[k].z, v[k].z, u[k].w, v[k].w}};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[i][e], big[e], small[e]);
      qf[((s0 + i) * 2) * 32 + ln] = make_uint4(big[0], big[1], big[2], big[3]);
      qf[((s0 + i) * 2 + 1) * 32 + ln] =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  }
}

// The tile of positions [t0, t0 + kT) of row b into a stage, by every
// thread: 16 c_kv chunks (chunk t % (R chunks) of rows t / (R chunks) +
// k (256 / (R chunks))) and 2 k_pe chunks the same way, each row's
// chunks by neighbouring threads; rows at or past hi zero-filled
// (nothing read).  Then a commit.
template <typename T>
__device__ void stage_tile(unsigned char* tile, const T* crow,
                           const T* prow, int t0, int hi) {
  using C = Cache<T>;
  constexpr int kRC = C::kRChunks;
  constexpr int kPC = C::kChunks - C::kRChunks;
  static_assert(16 * kThreads == C::kT * kRC && 2 * kThreads == C::kT * kPC,
                "a thread's chunks");
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 18; ++k) {
    const bool latent = k < 16;
    const int r = latent ? t / kRC + (kThreads / kRC) * k
                         : t / kPC + (kThreads / kPC) * (k - 16);
    const int ch = latent ? t % kRC : kRC + t % kPC;
    const bool ok = t0 + r < hi;
    const int64_t row = ok ? t0 + r : t0;
    const unsigned char* src =
        latent ? reinterpret_cast<const unsigned char*>(crow + row * kR) +
                     16 * ch
               : reinterpret_cast<const unsigned char*>(prow + row * kP) +
                     16 * (ch - kRC);
    cp_async16(tile + (r * C::kChunks + (ch ^ C::swz(r))) * 16, src, ok);
  }
  cp_async_commit();
}

__device__ __forceinline__ const uint4* chunk_at(const unsigned char* tile,
                                                 int chunks, int r, int ch,
                                                 int sw) {
  return reinterpret_cast<const uint4*>(tile + (r * chunks + (ch ^ sw)) * 16);
}

// word i of a 16-byte chunk (i a constant once unrolled)
__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// bf16 pair word w: element 0 (the lower address) or 1 as TF32 bits
__device__ __forceinline__ uint32_t bf16_tf32(uint32_t w, int e) {
  return e ? w & 0xffff0000u : w << 16;
}

// the B fragment (b0, b1) of k-step i of a 32-wide group from a lane's
// chunk(s): bf16 (one chunk, word i = depths 2i, 2i + 1, exact in TF32,
// no small term); float32 (two chunks, split)
__device__ __forceinline__ void b_frag(const uint4* w, int i, uint32_t* bb,
                                       uint32_t*, const __nv_bfloat16*) {
  const uint32_t u = word(w[0], i);
  bb[0] = bf16_tf32(u, 0);
  bb[1] = bf16_tf32(u, 1);
}

__device__ __forceinline__ void b_frag(const uint4* w, int i, uint32_t* bb,
                                       uint32_t* bs, const float*) {
  const uint4& u = w[i >> 1];
  split_tf32(__uint_as_float(word(u, 2 * (i & 1))), bb[0], bs[0]);
  split_tf32(__uint_as_float(word(u, 2 * (i & 1) + 1)), bb[1], bs[1]);
}

template <typename T>
__device__ __forceinline__ void mma_terms(float* lo, float* hi,
                                          const uint32_t* ab,
                                          const uint32_t* as,
                                          const uint32_t* bb,
                                          const uint32_t* bs) {
  mma_tf32(lo, as, bb[0], bb[1]);
  if constexpr (sizeof(T) == 4) mma_tf32(lo, ab, bs[0], bs[1]);
  mma_tf32(hi, ab, bb[0], bb[1]);
}

// P . V of one k-step: P's A fragment (pb, ps), the lane's chunks of
// positions 2c (r0) and 2c + 1, the tile sums ot of warp w's 8 n-tiles
// (context columns [64 w, 64 w + 64)).  bf16: one chunk holds the 8
// n-tiles, element e the n-tile e; float32: chunk h (of 2) holds n-tiles
// 4h..4h+3.  The column of n-tile t's n-index n is 64 w + 8 n + t (bf16)
// or 64 w + 32 (t / 4) + 4 n + t % 4 (float32).
__device__ __forceinline__ void pv_step(float (*ot)[4], const uint32_t* pb,
                                        const uint32_t* ps,
                                        const unsigned char* tile, int r0,
                                        int w, const __nv_bfloat16*) {
  using C = Cache<__nv_bfloat16>;
  const int ch = 8 * w + (threadIdx.x % 32) / 4;
  const uint4 u0 = *chunk_at(tile, C::kChunks, r0, ch, C::swz(r0));
  const uint4 u1 = *chunk_at(tile, C::kChunks, r0 + 1, ch, C::swz(r0 + 1));
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t b0 = bf16_tf32(word(u0, e >> 1), e & 1);
    const uint32_t b1 = bf16_tf32(word(u1, e >> 1), e & 1);
    mma_tf32(ot[e], ps, b0, b1);
    mma_tf32(ot[e], pb, b0, b1);
  }
}

__device__ __forceinline__ void pv_step(float (*ot)[4], const uint32_t* pb,
                                        const uint32_t* ps,
                                        const unsigned char* tile, int r0,
                                        int w, const float*) {
  using C = Cache<float>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ch = 16 * w + 8 * h + (threadIdx.x % 32) / 4;
    const uint4 u0 = *chunk_at(tile, C::kChunks, r0, ch, C::swz(r0));
    const uint4 u1 = *chunk_at(tile, C::kChunks, r0 + 1, ch, C::swz(r0 + 1));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t bb[2], bs[2];
      split_tf32(__uint_as_float(word(u0, e)), bb[0], bs[0]);
      split_tf32(__uint_as_float(word(u1, e)), bb[1], bs[1]);
      mma_3xtf32(ot[4 * h + e], pb, ps, bb, bs);
    }
  }
}

// A thread's 8 n-tiles x (n = 2c, 2c + 1) of warp w are 16 consecutive
// columns (bf16: 64 w + 16 c ..) or two runs of 8 (float32: 64 w + 32 h
// + 8 c ..); write them, scaled by inv, to a row of 512 floats.
template <typename T>
__device__ __forceinline__ void write_cols(float* row, float (*o)[4], int w,
                                           int c, int e0, float inv) {
  constexpr int kE = 16 / sizeof(T);       // n-tiles a chunk
#pragma unroll
  for (int h = 0; h < 8 / kE; ++h) {
    float* p = row + 64 * w + 8 * kE * h + 2 * kE * c;
#pragma unroll
    for (int x = 0; x < 2 * kE; x += 4) {
      float v[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int e = (x + y) % kE;
        const int n1 = (x + y) / kE;         // 0: n = 2c, 1: n = 2c + 1
        v[y] = o[kE * h + e][e0 + n1] * inv;
      }
      *reinterpret_cast<float4*>(p + x) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const float* __restrict__ q_abs,
                  const float* __restrict__ q_pe, const T* __restrict__ c_kv,
                  const T* __restrict__ k_pe,
                  const int* __restrict__ lengths, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int S,
                  float scale, int window, int chunk, int splits) {
  using C = Cache<T>;
  using L = Smem<T>;
  constexpr int kT = C::kT;
  constexpr int kNS = kT / 32;             // n-tiles a warp scores
  constexpr bool kPair = kNS == 2;         // bf16: each warp of a pair
                                           // owns one; float32: dw 0
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* qf = reinterpret_cast<uint4*>(smem + L::kQ);
  unsigned char* tiles = smem + L::kTiles;
  uint4* pf = reinterpret_cast<uint4*>(smem + L::kPf);
  float4* xch = reinterpret_cast<float4*>(smem + L::kPf);
  float* red = reinterpret_cast<float*>(smem + L::kRed);

  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int pq = w >> 1;                   // score phase: position quarter
  const int dw = w & 1;                    // and depth half
  const bool owner = kPair || dw == 0;
  const int own_j = kPair ? dw : 0;        // the owned n-tile of the
  const int own = kNS * pq + own_j;        // quarter, and in the tile
  const int split = blockIdx.x;
  const int b = blockIdx.y;

  // the admitted interval, clipped to this block's slice
  const int len = lengths[b];
  const int64_t hi64 = min(static_cast<int64_t>(S),
                           static_cast<int64_t>(len) + 1);
  int64_t lo64 = 0;
  if (window != 0) lo64 = max(lo64, static_cast<int64_t>(len) - window + 1);
  const int64_t s0 = static_cast<int64_t>(split) * chunk;
  const int lo = static_cast<int>(max(lo64, s0));
  const int hi = static_cast<int>(min(hi64, s0 + chunk));
  const int n_tiles = hi > lo ? (hi - lo + kT - 1) / kT : 0;

  const T* crow = c_kv + static_cast<int64_t>(b) * S * kR;
  const T* prow = k_pe + static_cast<int64_t>(b) * S * kP;
  if (n_tiles > 0) stage_tile<T>(tiles, crow, prow, lo, hi);
  stage_q(qf, q_abs, q_pe, b);

  float o[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;        // heads g, g + 8
  float l0 = 0.f, l1 = 0.f;                // this thread's share of l

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = lo + i * kT;
    cp_async_wait_all();
    __syncthreads();                       // tile i and q in; tile i - 1
                                           // and its P consumed
    if (i + 1 < n_tiles)
      stage_tile<T>(tiles + ((i + 1) & 1) * kTileBytes, crow, prow, t0 + kT,
                    hi);
    const unsigned char* tile = tiles + (i & 1) * kTileBytes;

    // scores of n-tiles kNS pq + j over depth half dw; a lane's chunk(s)
    // of its rows in the group, the next group's loaded while this
    // one's products run
    constexpr int kW = sizeof(T) / 2;
    float sc[kNS][4];
    uint4 bw[kNS][kW], bn[kNS][kW];
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const int r = 8 * (kNS * pq + j) + g;
#pragma unroll
      for (int x = 0; x < kW; ++x)
        bn[j][x] = *chunk_at(tile, C::kChunks, r,
                             kW * (4 * kHalfGroups * dw + c) + x, C::swz(r));
    }
#pragma unroll 1
    for (int grp = kHalfGroups * dw; grp < kHalfGroups * (dw + 1); ++grp) {
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        const int r = 8 * (kNS * pq + j) + g;
#pragma unroll
        for (int x = 0; x < kW; ++x) {
          bw[j][x] = bn[j][x];
          if (grp + 1 < kHalfGroups * (dw + 1))
            bn[j][x] = *chunk_at(tile, C::kChunks, r,
                                 kW * (4 * (grp + 1) + c) + x, C::swz(r));
        }
      }
      float lo_[kNS][4], hi_[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) lo_[j][e] = hi_[j][e] = 0.f;
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint4 ab4 = qf[((4 * grp + st) * 2) * 32 + lane];
        const uint4 as4 = qf[((4 * grp + st) * 2 + 1) * 32 + lane];
        const uint32_t ab[4] = {ab4.x, ab4.y, ab4.z, ab4.w};
        const uint32_t as[4] = {as4.x, as4.y, as4.z, as4.w};
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          uint32_t bb[2], bs[2];
          b_frag(bw[j], st, bb, bs, static_cast<const T*>(nullptr));
          mma_terms<T>(lo_[j], hi_[j], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += lo_[j][e] + hi_[j][e];
    }

    // the depth halves meet: each warp hands its partner the partial of
    // the n-tile the partner owns
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      const bool mine = kPair ? j == dw : dw == 0;
      if (!mine)
        xch[(kNS * pq + j) * 32 + lane] =
            make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
    }
    __syncthreads();
    float s[4];
    float mx0 = kNegInf, mx1 = kNegInf;
    if (owner) {
      const float4 x = xch[own * 32 + lane];
      const float other[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mine = kPair && dw ? sc[kNS - 1][e] : sc[0][e];
        const int pos = t0 + 8 * own + 2 * c + (e & 1);
        const float v = (mine + other[e]) * scale;
        s[e] = pos < hi ? v : kNegInf;
      }
      mx0 = fmaxf(s[0], s[1]);
      mx1 = fmaxf(s[2], s[3]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (c == 0) {
      red[w * kH + g] = mx0;
      red[w * kH + g + 8] = mx1;
    }
    __syncthreads();                       // the exchange is read too
    float top0 = red[g], top1 = red[g + 8];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) {
      top0 = fmaxf(top0, red[v * kH + g]);
      top1 = fmaxf(top1, red[v * kH + g + 8]);
    }
    const float mn0 = fmaxf(m0, top0);
    const float mn1 = fmaxf(m1, top1);
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
    if (owner) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = t0 + 8 * own + 2 * c + (e & 1);
        p[e] = pos < hi ? expf(s[e] - (e < 2 ? mn0 : mn1)) : 0.f;
      }
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      // the C fragment as the next A fragment: (a0, a1, a2, a3) = (c0,
      // c2, c1, c3)
      uint32_t big[4], small[4];
      split_tf32(p[0], big[0], small[0]);
      split_tf32(p[2], big[1], small[1]);
      split_tf32(p[1], big[2], small[2]);
      split_tf32(p[3], big[3], small[3]);
      pf[(own * 2) * 32 + lane] = make_uint4(big[0], big[1], big[2], big[3]);
      pf[(own * 2 + 1) * 32 + lane] =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
    __syncthreads();

    // P . V over the tile's kT / 8 k-steps, in zeroed fragments
    float ot[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) ot[t][0] = ot[t][1] = ot[t][2] = ot[t][3] = 0.f;
#pragma unroll 2
    for (int kj = 0; kj < kT / 8; ++kj) {
      const uint4 pb4 = pf[(kj * 2) * 32 + lane];
      const uint4 ps4 = pf[(kj * 2 + 1) * 32 + lane];
      const uint32_t pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
      const uint32_t ps[4] = {ps4.x, ps4.y, ps4.z, ps4.w};
      pv_step(ot, pb, ps, tile, 8 * kj + 2 * c, w,
              static_cast<const T*>(nullptr));
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      o[t][0] = fmaf(o[t][0], alpha0, ot[t][0]);
      o[t][1] = fmaf(o[t][1], alpha0, ot[t][1]);
      o[t][2] = fmaf(o[t][2], alpha1, ot[t][2]);
      o[t][3] = fmaf(o[t][3], alpha1, ot[t][3]);
    }
  }
  cp_async_wait_all();

  // l over the quad, then over the warps in order
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();                         // red's last readers are done
  if (c == 0) {
    red[w * kH + g] = l0;
    red[w * kH + g + 8] = l1;
  }
  __syncthreads();
  float L0 = red[g], L1 = red[g + 8];
#pragma unroll
  for (int v = 1; v < kWarps; ++v) {
    L0 += red[v * kH + g];
    L1 += red[v * kH + g + 8];
  }

  if (splits == 1) {
    float* orow = out + static_cast<int64_t>(b) * kH * kR;
    write_cols<T>(orow + g * kR, o, w, c, 0, 1.f / (L0 + 1e-30f));
    write_cols<T>(orow + (g + 8) * kR, o, w, c, 2, 1.f / (L1 + 1e-30f));
    return;
  }

  // the partial: m, l (splits, B, H) and acc (splits, B, H, R)
  const int64_t rows = static_cast<int64_t>(gridDim.y) * kH;
  const int64_t me = static_cast<int64_t>(split) * rows +
                     static_cast<int64_t>(b) * kH;
  float* m_w = ws;
  float* l_w = ws + splits * rows;
  float* a_w = ws + 2 * splits * rows;
  if (w == 0 && c == 0) {
    m_w[me + g] = m0;
    m_w[me + g + 8] = m1;
    l_w[me + g] = L0;
    l_w[me + g + 8] = L1;
  }
  write_cols<T>(a_w + (me + g) * kR, o, w, c, 0, 1.f);
  write_cols<T>(a_w + (me + g + 8) * kR, o, w, c, 2, 1.f);

  // the row's last block to arrive merges
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(red);
  if (tid == 0) *last = atomicAdd(counters + b, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  float* wgt = reinterpret_cast<float*>(smem);          // splits x H
  float* lsum = wgt + kMaxSplits * kH;                   // H
  const int64_t row0 = static_cast<int64_t>(b) * kH;
  if (tid < kH) {
    float top = kNegInf;
    for (int z = 0; z < splits; ++z)
      top = fmaxf(top, __ldcg(m_w + z * rows + row0 + tid));
    float l = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float wz = expf(__ldcg(m_w + z * rows + row0 + tid) - top);
      wgt[z * kH + tid] = wz;
      l = fmaf(__ldcg(l_w + z * rows + row0 + tid), wz, l);
    }
    lsum[tid] = l;
  }
  if (tid == 0) counters[b] = 0;
  __syncthreads();
  // thread tid: columns 4 (tid % 128) .. + 3 of heads 8 (tid / 128) ..
  constexpr int kHT = kH * kR / 4 / kThreads;          // heads a thread
  const int col = tid % (kR / 4);
  const int h0 = tid / (kR / 4) * kHT;
  float4 acc[kHT];
#pragma unroll
  for (int h = 0; h < kHT; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int z = 0; z < splits; ++z) {
    const float4* src =
        reinterpret_cast<const float4*>(a_w + (z * rows + row0) * kR) + col;
#pragma unroll
    for (int h = 0; h < kHT; ++h) {
      const float4 v = __ldcg(src + (h0 + h) * (kR / 4));
      const float wz = wgt[z * kH + h0 + h];
      acc[h].x = fmaf(v.x, wz, acc[h].x);
      acc[h].y = fmaf(v.y, wz, acc[h].y);
      acc[h].z = fmaf(v.z, wz, acc[h].z);
      acc[h].w = fmaf(v.w, wz, acc[h].w);
    }
  }
  float4* dst = reinterpret_cast<float4*>(out + row0 * kR) + col;
#pragma unroll
  for (int h = 0; h < kHT; ++h) {
    const float d = lsum[h0 + h] + 1e-30f;
    dst[(h0 + h) * (kR / 4)] =
        make_float4(acc[h].x / d, acc[h].y / d, acc[h].z / d, acc[h].w / d);
  }
}

template <typename T>
int launch(const void* q_abs, const void* q_pe, const void* c_kv,
           const void* k_pe, const void* lengths, void* out, void* ws,
           void* counters, int B, int S, float scale, int window, int chunk,
           int splits, cudaStream_t stream) {
  const auto kernel = mla_decode_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, B), kThreads, Smem<T>::kBytes, stream>>>(
      static_cast<const float*>(q_abs), static_cast<const float*>(q_pe),
      static_cast<const T*>(c_kv), static_cast<const T*>(k_pe),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), S, scale, window,
      chunk, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: q_abs (B, H, R) and q_pe (B, H, P) float32, a
// cache c_kv (B, S, R) and k_pe (B, S, P) of dtype 0 (float32) or 1
// (bfloat16), int32 lengths (B,), ctx out (B, H, R) float32; (H, R, P)
// is (16, 512, 64).  The (splits, B) grid serves slices of `chunk`
// positions (splits slices cover S); with splits > 1 the partials go to
// ws (splits B H (R + 2) floats; splits <= 64) and each row's last block
// merges them, counted in `counters` (B int32, zero before the launch
// and left zero after it).  q_abs, q_pe, c_kv and k_pe start 16-byte
// aligned.  Returns the first CUDA error of setting the shared-memory
// size or of the launch, 0 if none.
extern "C" int mla_decode_launch(const void* q_abs, const void* q_pe,
                                 const void* c_kv, const void* k_pe,
                                 const void* lengths, void* out, void* ws,
                                 void* counters, int B, int S, int H, int R,
                                 int P, int dtype, float scale, int window,
                                 int chunk, int splits, void* stream) {
  if (B == 0) return 0;
  if (H != kH || R != kR || P != kP || splits < 1 || splits > kMaxSplits ||
      B > 65535 || chunk <= 0 ||
      static_cast<int64_t>(chunk) * splits < S ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q_abs, q_pe, c_kv, k_pe, lengths, out, ws, counters,
                         B, S, scale, window, chunk, splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_abs, q_pe, c_kv, k_pe, lengths, out, ws,
                                 counters, B, S, scale, window, chunk, splits,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
