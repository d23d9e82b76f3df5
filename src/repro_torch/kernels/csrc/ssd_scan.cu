// Mamba2 SSD (state-space duality) scan for the port's Mamba2 layers.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_kernel
// (reached through ssd_scan) and computes what the reference model's
// _ssd_chunked (src/repro/models/mamba2.py) computes.  For x (B, S, nh,
// hd), dt (B, S, nh) float32 (post-softplus), A (nh,) float32
// (negative), B and C (B, S, g, ds) with head h reading group
// h / (nh / g), it runs the diagonal SSM recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,   y_t = h_t C_t
// from h_0 = 0 and writes y (float32, or x's type) and, when asked,
// the final state h_S (B, nh, hd, ds) in float32.  No D skip term.
// The Pallas grid (B*nh, S/chunk) walks the chunks of one head in order
// and carries h in VMEM scratch; here the time axis is a loop inside a
// block, in tiles of T steps.  SSD gives the same function for every
// chunk size up to rounding, so the tile need not be the model's chunk.
// Per tile, with cum the prefix sum of dt*A over the tile, total its
// last value and w_j = exp(total - cum_j) dt_j:
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . h,
//   h  <- h exp(total) + sum_j w_j x_j (x) B_j.
// Rows past S are staged as zeros: dt = 0 is an identity step, so h_S is
// the state after exactly S steps and the ragged tail writes no y.  B
// and C are read through a batch and a time stride, so the model's
// slices of one (B, S, 2 g ds) activation need no copy.
//
// Which kernel runs.  bfloat16 inputs run ssd_scan_kernel_bf16 and
// float32 inputs ssd_scan_kernel_f32, both on the tensor cores; float32
// takes each product as 3xTF32 (one TF32 term would round float32 far
// outside the float32 gate of 1e-4).
//
// bf16 design.  One block of hd / 16 warps (4 at hd 64) serves one
// (piece, head, batch row); warp w owns rows [16 w, 16 w + 16) of h and
// of y's columns.  x, B and C are staged as the bf16 they arrive in, by
// 16-byte cp.async into rows padded by 16 bytes (ldmatrix reads 8 rows
// in distinct banks), two stages deep, so the next tile loads while
// this one computes; at (64, 128) and T 64 a block takes 109,056 bytes
// of shared memory, so two blocks share an SM (T 32: 50,432, four).
// Jamba's (64, 16) is the same layout with one 16-wide k-step of d_state
// (rows of B and C padded from 32 to 48 bytes, still 8 distinct bank
// groups an ldmatrix phase): 51,712 bytes at T 64.
// Every product is mma.sync m16n8k16 bf16 -> float32 with ldmatrix
// fragments:
//   (a) scores = C B^T, 16 query rows per warp; M = scores o exp(cum_i -
//       cum_j) o dt_j, masked to j <= i before the exp, stored in shared
//       memory as bf16 hi + lo;
//   (c) exp(cum_i) (C h^T): h's B fragments come straight from the
//       state update's float32 accumulators in registers (the
//       accumulator of an m16n8 product is the B fragment of the next),
//       split into hi + lo; skipped while h is 0;
//   (b) y += M x, M's hi and lo as A fragments, x by a transposing
//       ldmatrix;
//   (d) h <- h exp(total) + (w o x)^T B: x^T by a transposing ldmatrix,
//       scaled by w in registers and split into hi + lo; h stays in
//       float32 accumulators across the whole walk.
// One bf16 term of M, h or w o x would move y by up to 1.8e-2, 5.3e-3
// or 5.2e-3 (CPU estimates at mamba2's widths, S 1,024,
// tests/test_torch_ssd_split.py), over the 2e-3 gate; hi + lo keeps ~16
// bits and stays near the float32 tile form's own 6e-5.  Each tile is
// 6 ldmatrix-fed products (two each for (b), (c), (d)), ~3.1 M
// multiply-adds per (row, head) at T 64.  A row of at most 32 steps
// (the serve prompt) runs 32-step tiles, so it pays for no zero rows;
// 16-row blocks wholly past the end are skipped.
//
// Split of the time axis.  At small batch the (nh, B) grid leaves SMs
// idle, so the wrapper may cut each row into `splits` pieces of whole
// tiles (ssd_splits in kernels/ssd_scan.py).  Pass 1 (kStateOnly) gives
// each piece but the last its own final state from zero and its total
// sum of dt*A, in a workspace; pass 2 starts piece k from h_in[k] =
// h_in[k-1] exp(total[k-1]) + local[k-1], combined in piece order, so
// the bits never depend on which block ran first.
//
// Bound.  The recurrence does 4 hd ds flops per step and head; at the
// long serve shape (B 32, S 1,024, 80 x 64 heads, ds 128) that is
// ~86 GFLOP, while reading x, dt, B, C once and writing y (float32)
// and h_S once moves ~1.12 GB: ~0.33 ms at 3.35 TB/s, so bytes bound
// it.  The bf16 kernel's dual form issues ~260 GFLOP of mma.sync, 3x
// the bound's operations, still under the bytes at the tensor cores'
// rate.  In float32 the operations bound it: at B 4 x 300 on mamba2,
// 3.15 GFLOP at 3xTF32's 164.9 TFLOP/s, 0.019 ms, over ~61 MB (0.018
// ms at 3.35 TB/s); at the CUDA cores' 67 TFLOP/s it would be 0.047.
//
// float32 design (tensor cores, 3xTF32).  The same shape as the bf16
// kernel: one block of hd / 16 warps per (head, batch row), warp w
// owning rows [16 w, 16 w + 16) of h and of y's columns, h in float32
// accumulators across the whole walk; x, B and C staged as float32 by
// 16-byte cp.async, two stages deep, in tiles of T = 32 steps (at 64 a
// block would take 187 KB and run alone on its SM; at 32, 93,952 bytes
// at (64, 128), two blocks an SM; 36,608 at (64, 16)).  Rows are padded
// to 8 mod 32 floats, so that both fragment loads below meet 32
// distinct banks.  Every product is mma.sync m16n8k8 tf32 -> float32 as
// 3xTF32 (tensor_core.cuh: each operand split into a TF32 big term and
// a small term as it is loaded, small . big + big . small + big . big):
//   (a) scores = C B^T over the block triangle's three 16 x 16 blocks,
//       a k-step's columns relabelled in pairs (one float2 a row); M =
//       scores o exp(cum_i - cum_j) o dt_j for j <= i (the exponent only
//       there), else 0, in shared memory as float32;
//   (c) C h^T: h's B fragments are the state update's accumulators in
//       registers, whose column pairs the relabelled k-step matches;
//       skipped while h is 0, then scaled by exp(cum_i);
//   (b) M x, x read in its natural [step][column] layout;
//   (d) h <- h exp(total) + (w o x)^T B, (w o x)^T's fragments formed
//       once a tile in registers.
// Each of y's two parts and each tile's state update is summed in
// zeroed fragments (the tensor cores' float32 sums truncate), and they
// are added to each other and to h in round-to-nearest.  The tile's
// 16-row blocks and 8-step k-steps wholly past the end are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// ------------------------------------------------------------------ f32

// Shared-memory layout of the float32 kernel, in bytes: two stages of
// (x, B, C rows padded to 8 mod 32 floats; dt), then M of the tile
// (rows padded to 4 mod 32: its natural A loads), then each warp's own
// prefix sum cum and weights w.
template <int HD, int DS>
struct F32Smem {
  static constexpr int T = 32;                   // steps a tile
  static constexpr int kWarps = HD / 16;         // one per 16 rows of h
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kXS = HD + 8;             // floats per padded row
  static constexpr int kBS = DS + 8;
  static constexpr int kMS = T + 4;
  static constexpr int kB = 4 * T * kXS;         // offsets in a stage
  static constexpr int kC = kB + 4 * T * kBS;
  static constexpr int kDt = kC + 4 * T * kBS;
  static constexpr int kStage = kDt + 4 * T;
  static constexpr int kM = 2 * kStage;
  static constexpr int kScan = kM + 4 * T * kMS;
  static constexpr int kBytes = kScan + kWarps * 2 * 4 * T;
  static_assert(kXS % 32 == 8 && (kBS % 32 == 8 || kBS % 32 == 24) &&
                    kMS % 32 == 4,
                "bank-conflict-free fragment loads");
  static_assert(kB % 16 == 0 && kC % 16 == 0 && kDt % 16 == 0 &&
                    kStage % 16 == 0 && kM % 16 == 0,
                "16-byte aligned rows for cp.async");
};

// Stage rows [t0, t0 + n) of x, B, C and dt as float32 (rows past n
// zero-filled: dt = 0 makes them identity steps).
template <int HD, int DS>
__device__ __forceinline__ void load_tile_f32(
    unsigned char* stage, const float* xb, const float* dtb, const float* bb,
    const float* cb, int64_t x_step, int nh, int64_t bc_ss, int t0, int n) {
  using L = F32Smem<HD, DS>;
  float* xs = reinterpret_cast<float*>(stage);
  float* bs = reinterpret_cast<float*>(stage + L::kB);
  float* cs = reinterpret_cast<float*>(stage + L::kC);
  float* dts = reinterpret_cast<float*>(stage + L::kDt);
  constexpr int kXChunks = HD / 4;               // 16-byte chunks a row
  constexpr int kBChunks = DS / 4;
  for (int c = threadIdx.x; c < L::T * kXChunks; c += L::kThreads) {
    const int r = c / kXChunks;
    const int ch = c % kXChunks;
    const bool ok = r < n;
    cp_async16(xs + r * L::kXS + ch * 4,
               xb + (t0 + (ok ? r : 0)) * x_step + ch * 4, ok);
  }
  for (int c = threadIdx.x; c < L::T * kBChunks; c += L::kThreads) {
    const int r = c / kBChunks;
    const int ch = c % kBChunks;
    const bool ok = r < n;
    const int64_t off = (t0 + (ok ? r : 0)) * bc_ss + ch * 4;
    cp_async16(bs + r * L::kBS + ch * 4, bb + off, ok);
    cp_async16(cs + r * L::kBS + ch * 4, cb + off, ok);
  }
  for (int r = threadIdx.x; r < L::T; r += L::kThreads)
    cp_async4(dts + r, dtb + static_cast<int64_t>(t0 + (r < n ? r : 0)) * nh,
              r < n);
}

// One (head, batch row) per block: blockIdx = (head, b).  y (float32)
// of every step and, when h_out is not null, the final state.
template <int HD, int DS>
__global__ void __launch_bounds__(2 * HD, 2)
ssd_scan_kernel_f32(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bm,
                    const float* __restrict__ cm, float* __restrict__ y,
                    float* __restrict__ h_out, int S, int nh, int g,
                    int64_t bc_sb, int64_t bc_ss) {
  using L = F32Smem<HD, DS>;
  constexpr int T = L::T;
  constexpr int kMT = T / 16;                    // 16-row blocks a tile
  constexpr int kKT = T / 8;                     // 8-step k-steps a tile
  constexpr int kSN = DS / 8;                    // 8-column tiles of h
  static_assert(T == 32, "the prefix sum gives each lane one step");
  extern __shared__ __align__(16) unsigned char sbuf[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int c4 = lane % 4;
  const int d0 = 16 * warp;                      // this warp's rows of h
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const float A = a[head];
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const float* xb = x + static_cast<int64_t>(b) * S * x_step +
                    static_cast<int64_t>(head) * HD;
  const float* dtb = dt + static_cast<int64_t>(b) * S * nh + head;
  const int grp = head / (nh / g);
  const float* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  const float* cb = cm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  float* cum = reinterpret_cast<float*>(sbuf + L::kScan) + warp * 2 * T;
  float* wgt = cum + T;
  float* m_s = reinterpret_cast<float*>(sbuf + L::kM);

  const int tiles = (S + T - 1) / T;
  if (tiles > 0)
    load_tile_f32<HD, DS>(sbuf, xb, dtb, bb, cb, x_step, nh, bc_ss, 0,
                          min(T, S));
  cp_async_commit();

  // h[sn][e]: state row d0 + g4 + 8 (e / 2), column 8 sn + 2 c4 + e % 2,
  // the accumulator layout of the state update's mma
  float h[kSN][4];
#pragma unroll
  for (int sn = 0; sn < kSN; ++sn)
    h[sn][0] = h[sn][1] = h[sn][2] = h[sn][3] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int t0 = it * T;
    const int n = min(T, S - t0);
    const unsigned char* stage = sbuf + (it & 1) * L::kStage;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < tiles)
      load_tile_f32<HD, DS>(sbuf + ((it + 1) & 1) * L::kStage, xb, dtb, bb,
                            cb, x_step, nh, bc_ss, t0 + T,
                            min(T, S - t0 - T));
    cp_async_commit();
    const float* xs = reinterpret_cast<const float*>(stage);
    const float* bs = reinterpret_cast<const float*>(stage + L::kB);
    const float* cs = reinterpret_cast<const float*>(stage + L::kC);
    const float* dts = reinterpret_cast<const float*>(stage + L::kDt);

    // cum = prefix sum of dt*A over the tile (lane l holds step l), and
    // the state update's weights w_j = exp(total - cum_j) dt_j; every
    // warp keeps its own copy
    float total;
    {
      float incl = __fmul_rn(dts[lane], A);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      cum[lane] = incl;
      total = __shfl_sync(0xffffffffu, incl, 31);
      wgt[lane] = expf(total - incl) * dts[lane];
      __syncwarp();
    }

    // (a) M = (C B^T) o exp(cum_i - cum_j) o dt_j on the triangle's
    // blocks (0, 0), (1, 0), (1, 1), a warp each
    for (int p = warp; p < 3; p += L::kWarps) {
      const int ib = p == 0 ? 0 : 1;
      const int jb = p == 2 ? 1 : 0;
      if (16 * ib >= n) continue;
      float lo[2][4] = {}, hi[2][4] = {};
#pragma unroll 4
      for (int ks = 0; ks < DS / 8; ++ks) {
        uint32_t ab[4], as[4];
        frag_a_pairs_tf32(ab, as, cs, L::kBS, 16 * ib, 8 * ks);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t bb2[2], bs2[2];
          frag_b_pairs_tf32(bb2, bs2, bs, L::kBS, 16 * jb + 8 * q, 8 * ks);
          mma_3xtf32_apart(lo[q], hi[q], ab, as, bb2, bs2);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * ib + g4 + 8 * hf;
          const int j = 16 * jb + 8 * q + 2 * c4;
          float m[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            m[e] = j + e <= i ? (hi[q][2 * hf + e] + lo[q][2 * hf + e]) *
                                    expf(cum[i] - cum[j + e]) * dts[j + e]
                              : 0.f;
          *reinterpret_cast<float2*>(m_s + i * L::kMS + j) =
              make_float2(m[0], m[1]);
        }
    }
    __syncthreads();

    // y[:, d0 : d0 + 16] of the tile: (c) exp(cum_i) (C h^T) with h the
    // state before the tile, then (b) M x, each in zeroed fragments
    float yl[kMT][2][4], yh[kMT][2][4], ym[kMT][2][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          yl[mi][q][e] = yh[mi][q][e] = ym[mi][q][e] = 0.f;
    if (it > 0) {
#pragma unroll
      for (int ks = 0; ks < kSN; ++ks) {
        // B (k = state column, pairs; n = row d of h): h's accumulators
        uint32_t hb[2][2], hs[2][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          split_tf32(h[ks][2 * q], hb[q][0], hs[q][0]);
          split_tf32(h[ks][2 * q + 1], hb[q][1], hs[q][1]);
        }
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          if (16 * mi >= n) break;
          uint32_t ab[4], as[4];
          frag_a_pairs_tf32(ab, as, cs, L::kBS, 16 * mi, 8 * ks);
#pragma unroll
          for (int q = 0; q < 2; ++q)
            mma_3xtf32_apart(yl[mi][q], yh[mi][q], ab, as, hb[q], hs[q]);
        }
      }
    }
#pragma unroll
    for (int kj = 0; kj < kKT; ++kj) {
      if (8 * kj >= n) break;
      uint32_t xb2[2][2], xs2[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        frag_b_kn_tf32(xb2[q], xs2[q], xs, L::kXS, 8 * kj, d0 + 8 * q);
#pragma unroll
      for (int mi = kj / 2; mi < kMT; ++mi) {
        if (16 * mi >= n) break;
        uint32_t ab[4], as[4];
        frag_a_tf32(ab, as, m_s, L::kMS, 16 * mi, 8 * kj);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          mma_3xtf32(ym[mi][q], ab, as, xb2[q], xs2[q]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * mi + g4 + 8 * hf;
        if (i >= n) continue;
        const float ei = expf(cum[i]);
        float* row = y + ((static_cast<int64_t>(b) * S + t0 + i) * nh +
                          head) * HD + d0 + 2 * c4;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          *reinterpret_cast<float2*>(row + 8 * q) = make_float2(
              fmaf(ei, yh[mi][q][2 * hf] + yl[mi][q][2 * hf],
                   ym[mi][q][2 * hf]),
              fmaf(ei, yh[mi][q][2 * hf + 1] + yl[mi][q][2 * hf + 1],
                   ym[mi][q][2 * hf + 1]));
      }

    // (d) h <- h exp(total) + (w o x)^T B: (w o x)^T's A fragments (rows
    // d, k = steps) once, then each 8-column tile of h in a zeroed
    // fragment
    {
      const float decay = expf(total);
      uint32_t wb[kKT][4], wsm[kKT][4];
#pragma unroll
      for (int kj = 0; kj < kKT; ++kj) {
        if (8 * kj >= n) break;
        const int j = 8 * kj + c4;
        const float w0 = wgt[j], w1 = wgt[j + 4];
        const float* x0 = xs + j * L::kXS + d0 + g4;
        const float* x1 = x0 + 4 * L::kXS;
        split_tf32(w0 * x0[0], wb[kj][0], wsm[kj][0]);
        split_tf32(w0 * x0[8], wb[kj][1], wsm[kj][1]);
        split_tf32(w1 * x1[0], wb[kj][2], wsm[kj][2]);
        split_tf32(w1 * x1[8], wb[kj][3], wsm[kj][3]);
      }
#pragma unroll
      for (int sn = 0; sn < kSN; ++sn) {
        float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kj = 0; kj < kKT; ++kj) {
          if (8 * kj >= n) break;
          uint32_t bb2[2], bs2[2];
          frag_b_kn_tf32(bb2, bs2, bs, L::kBS, 8 * kj, 8 * sn);
          mma_3xtf32_apart(lo, hi, wb[kj], wsm[kj], bb2, bs2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[sn][e] = fmaf(h[sn][e], decay, hi[e] + lo[e]);
      }
    }
  }

  if (h_out != nullptr) {
    float* dst = h_out + (static_cast<int64_t>(b) * nh + head) * HD * DS;
#pragma unroll
    for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(dst + (d0 + g4 + 8 * hf) * DS + 8 * sn +
                                   2 * c4) =
            make_float2(h[sn][2 * hf], h[sn][2 * hf + 1]);
  }
}

// ------------------------------------------------------------------ bf16

// Shared-memory layout of the bf16 kernel, in bytes.  Two stages of (x,
// B, C as bf16 rows padded by 16 bytes, so the 8 rows an ldmatrix phase
// reads fall in distinct banks; dt as float32), then M of the tile as
// bf16 hi and lo rows, then each warp's own prefix sum cum and weights
// w (float32).  (64, 128) at T 64: 2 x 44,288 + 18,432 + 2,048 =
// 109,056 bytes, so two blocks share an SM; at T 32 50,432 bytes, four.
template <int HD, int DS, int T>
struct Bf16Smem {
  static constexpr int kWarps = HD / 16;         // one per 16 rows of h
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kXStride = HD + 8;        // bf16 per padded row
  static constexpr int kBStride = DS + 8;
  static constexpr int kMStride = T + 8;
  static constexpr int kXBytes = 2 * T * kXStride;
  static constexpr int kBBytes = 2 * T * kBStride;
  static constexpr int kB = kXBytes;             // offsets in a stage
  static constexpr int kC = kB + kBBytes;
  static constexpr int kDt = kC + kBBytes;
  static constexpr int kStage = kDt + 4 * T;
  static constexpr int kM = 2 * kStage;          // M hi, then M lo
  static constexpr int kMBytes = 2 * T * kMStride;
  static constexpr int kScan = kM + 2 * kMBytes;
  static constexpr int kBytes = kScan + kWarps * 2 * 4 * T;
  static_assert(kB % 16 == 0 && kC % 16 == 0 && kDt % 16 == 0 &&
                    kStage % 16 == 0 && kMBytes % 16 == 0,
                "16-byte aligned rows for cp.async and ldmatrix");
};

// Stage rows [t0, t0 + n) of x, B, C and dt (rows past n zero-filled,
// dt = 0 making them identity steps); C only when it is used.
template <int HD, int DS, int T, bool kWithC>
__device__ __forceinline__ void load_tile(
    unsigned char* stage, const __nv_bfloat16* xb, const float* dtb,
    const __nv_bfloat16* bb, const __nv_bfloat16* cb, int64_t x_step,
    int nh, int64_t bc_ss, int t0, int n) {
  using L = Bf16Smem<HD, DS, T>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(stage + L::kB);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(stage + L::kC);
  float* dts = reinterpret_cast<float*>(stage + L::kDt);
  constexpr int kXChunks = HD / 8;               // 16-byte chunks a row
  constexpr int kBChunks = DS / 8;
  for (int c = threadIdx.x; c < T * kXChunks; c += L::kThreads) {
    const int r = c / kXChunks;
    const int ch = c % kXChunks;
    const bool ok = r < n;
    cp_async16(xs + r * L::kXStride + ch * 8,
               xb + (t0 + (ok ? r : 0)) * x_step + ch * 8, ok);
  }
  for (int c = threadIdx.x; c < T * kBChunks; c += L::kThreads) {
    const int r = c / kBChunks;
    const int ch = c % kBChunks;
    const bool ok = r < n;
    const int64_t off = (t0 + (ok ? r : 0)) * bc_ss + ch * 8;
    cp_async16(bs + r * L::kBStride + ch * 8, bb + off, ok);
    if (kWithC) cp_async16(cs + r * L::kBStride + ch * 8, cb + off, ok);
  }
  for (int r = threadIdx.x; r < T; r += L::kThreads)
    cp_async4(dts + r, dtb + static_cast<int64_t>(t0 + (r < n ? r : 0)) * nh,
              r < n);
}

// One (piece, head, batch row) per block: blockIdx = (head, b, piece).
// A piece is `piece` steps (a whole number of tiles) of the row, the
// last one cut at S; `splits` pieces cover the row.  kStateOnly (pass
// 1): the piece's own final state from zero, and its total sum of dt*A,
// into the workspace.  Otherwise (the single pass, or pass 2): start
// from the state combined in piece order from the workspace, write y of
// the piece and, from the last piece, the final state.
template <int HD, int DS, int T, bool kStateOnly>
__global__ void __launch_bounds__(2 * HD, T == 64 ? 2 : 3)
ssd_scan_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ a,
                     const __nv_bfloat16* __restrict__ bm,
                     const __nv_bfloat16* __restrict__ cm,
                     float* __restrict__ y32,
                     __nv_bfloat16* __restrict__ yt,
                     float* __restrict__ h_out, float* __restrict__ ws,
                     int S, int nh, int g, int64_t bc_sb, int64_t bc_ss,
                     int piece, int splits) {
  using L = Bf16Smem<HD, DS, T>;
  constexpr int kMT = T / 16;                    // 16-row tiles of a tile
  constexpr int kSN = DS / 8;                    // 8-column tiles of h
  constexpr int kPer = T / 32;                   // steps per lane in cum
  extern __shared__ __align__(16) unsigned char sbuf[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int c4 = lane % 4;
  const int d0 = 16 * warp;                      // this warp's rows of h
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int k = blockIdx.z;
  const int64_t nrows = static_cast<int64_t>(gridDim.y) * nh;
  const int64_t state = (static_cast<int64_t>(b) * nh + head) * HD * DS;
  const float A = a[head];
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const __nv_bfloat16* xb = x + static_cast<int64_t>(b) * S * x_step +
                            static_cast<int64_t>(head) * HD;
  const float* dtb = dt + static_cast<int64_t>(b) * S * nh + head;
  const int grp = head / (nh / g);
  const __nv_bfloat16* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  const __nv_bfloat16* cb = cm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  float* cum = reinterpret_cast<float*>(sbuf + L::kScan) + warp * 2 * T;
  float* wgt = cum + T;
  __nv_bfloat16* m_hi = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kM);
  __nv_bfloat16* m_lo = m_hi + T * L::kMStride;

  const int start = k * piece;
  const int end = min(S, start + piece);
  const int tiles = end > start ? (end - start + T - 1) / T : 0;
  if (tiles > 0) {
    load_tile<HD, DS, T, !kStateOnly>(sbuf, xb, dtb, bb, cb, x_step, nh,
                                      bc_ss, start, min(T, end - start));
  }
  cp_async_commit();

  // h[sn][e]: state row d0 + g4 + 8 (e / 2), column 8 sn + 2 c4 + e % 2,
  // the accumulator layout of the state update's mma
  float h[kSN][4];
#pragma unroll
  for (int sn = 0; sn < kSN; ++sn) h[sn][0] = h[sn][1] = h[sn][2] =
      h[sn][3] = 0.f;
  if (!kStateOnly) {
    // combine the earlier pieces' states in piece order:
    // h_in[k] = h_in[k-1] exp(total[k-1]) + local[k-1]
    const float* tot = ws + (splits - 1) * nrows * HD * DS;
    for (int j = 0; j < k; ++j) {
      const float decay = expf(tot[j * nrows + b * nh + head]);
      const float* st = ws + j * nrows * HD * DS + state;
#pragma unroll
      for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 v = *reinterpret_cast<const float2*>(
              st + (d0 + g4 + 8 * hf) * DS + 8 * sn + 2 * c4);
          h[sn][2 * hf] = h[sn][2 * hf] * decay + v.x;
          h[sn][2 * hf + 1] = h[sn][2 * hf + 1] * decay + v.y;
        }
    }
  }
  float piece_total = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int t0 = start + it * T;
    const int n = min(T, end - t0);
    unsigned char* stage = sbuf + (it & 1) * L::kStage;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < tiles) {
      load_tile<HD, DS, T, !kStateOnly>(
          sbuf + ((it + 1) & 1) * L::kStage, xb, dtb, bb, cb, x_step, nh,
          bc_ss, t0 + T, min(T, end - t0 - T));
    }
    cp_async_commit();
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage);
    const __nv_bfloat16* bs =
        reinterpret_cast<const __nv_bfloat16*>(stage + L::kB);
    const __nv_bfloat16* cs =
        reinterpret_cast<const __nv_bfloat16*>(stage + L::kC);
    const float* dts = reinterpret_cast<const float*>(stage + L::kDt);

    // cum = prefix sum of dt*A over the tile (lane l holds steps kPer l
    // ...), and the state update's weights w_j = exp(total - cum_j) dt_j;
    // every warp keeps its own copy
    float total;
    {
      float v[kPer];
      float run = 0.f;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const float d = __fmul_rn(dts[kPer * lane + p], A);
        run = p == 0 ? d : run + d;
        v[p] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int p = 0; p < kPer; ++p) cum[kPer * lane + p] = excl + v[p];
      total = __shfl_sync(0xffffffffu, excl + v[kPer - 1], 31);
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int t = kPer * lane + p;
        wgt[t] = expf(total - (excl + v[p])) * dts[t];
      }
      __syncwarp();
    }
    piece_total += total;

    if (!kStateOnly) {
      // (a) scores = C B^T on the tensor cores, one 16-row block at a
      // time; M = scores exp(cum_i - cum_j) dt_j for j <= i (the exponent
      // only there, where it is <= 0), else 0, stored as hi + lo
      for (int ib = warp; ib < kMT; ib += L::kWarps) {
        if (16 * ib >= n) break;
        float sc[kMT][2][4];
#pragma unroll
        for (int jb = 0; jb < kMT; ++jb)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            sc[jb][q][0] = sc[jb][q][1] = sc[jb][q][2] = sc[jb][q][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < DS / 16; ++ks) {
          uint32_t af[4];
          ldsm_x4(af, cs + (16 * ib + (lane & 15)) * L::kBStride + 16 * ks +
                          (lane >> 4) * 8);
#pragma unroll
          for (int jb = 0; jb < kMT; ++jb) {
            if (jb > ib) break;
            uint32_t r[4];
            ldsm_x4(r, bs + (16 * jb + (lane & 7) + ((lane >> 4) << 3)) *
                                L::kBStride +
                           16 * ks + ((lane >> 3) & 1) * 8);
            mma_bf16(sc[jb][0], af, r[0], r[1]);
            mma_bf16(sc[jb][1], af, r[2], r[3]);
          }
        }
        const int i0 = 16 * ib + g4;
        const float ci[2] = {cum[i0], cum[i0 + 8]};
#pragma unroll
        for (int jb = 0; jb < kMT; ++jb) {
          if (jb > ib) break;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = 16 * jb + 8 * q + 2 * c4;
            const float cj[2] = {cum[j], cum[j + 1]};
            const float dj[2] = {dts[j], dts[j + 1]};
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = i0 + 8 * hf;
              float m[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                m[e] = j + e <= i ? sc[jb][q][2 * hf + e] *
                                        expf(ci[hf] - cj[e]) * dj[e]
                                  : 0.f;
              uint32_t hi, lo;
              split_bf16(m[0], m[1], hi, lo);
              *reinterpret_cast<uint32_t*>(m_hi + i * L::kMStride + j) = hi;
              *reinterpret_cast<uint32_t*>(m_lo + i * L::kMStride + j) = lo;
            }
          }
        }
      }
      __syncthreads();

      // y[:, d0 : d0 + 16] of the tile: (c) exp(cum_i) (C h^T) with h the
      // state before the tile, its B fragments split from h's
      // accumulators in registers (skipped while h is 0), then (b) M x
      float yacc[kMT][2][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          yacc[mi][q][0] = yacc[mi][q][1] = yacc[mi][q][2] =
              yacc[mi][q][3] = 0.f;
      if (k > 0 || it > 0) {
#pragma unroll
        for (int ks = 0; ks < DS / 16; ++ks) {
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            split_bf16(h[2 * ks][2 * q], h[2 * ks][2 * q + 1], bh[q][0],
                       bl[q][0]);
            split_bf16(h[2 * ks + 1][2 * q], h[2 * ks + 1][2 * q + 1],
                       bh[q][1], bl[q][1]);
          }
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            if (16 * mi >= n) break;
            uint32_t af[4];
            ldsm_x4(af, cs + (16 * mi + (lane & 15)) * L::kBStride +
                            16 * ks + (lane >> 4) * 8);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              mma_bf16(yacc[mi][q], af, bh[q][0], bh[q][1]);
              mma_bf16(yacc[mi][q], af, bl[q][0], bl[q][1]);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const float e0 = expf(cum[16 * mi + g4]);
          const float e1 = expf(cum[16 * mi + g4 + 8]);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            yacc[mi][q][0] *= e0;
            yacc[mi][q][1] *= e0;
            yacc[mi][q][2] *= e1;
            yacc[mi][q][3] *= e1;
          }
        }
      }
#pragma unroll
      for (int kj = 0; kj < kMT; ++kj) {
        if (16 * kj >= n) break;
        uint32_t xf[4];
        ldsm_x4_trans(xf, xs + (16 * kj + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   L::kXStride +
                              d0 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = kj; mi < kMT; ++mi) {
          if (16 * mi >= n) break;
          uint32_t mh[4], ml[4];
          const int off = (16 * mi + (lane & 15)) * L::kMStride + 16 * kj +
                          (lane >> 4) * 8;
          ldsm_x4(mh, m_hi + off);
          ldsm_x4(ml, m_lo + off);
          mma_split(yacc[mi][0], mh, ml, xf[0], xf[1]);
          mma_split(yacc[mi][1], mh, ml, xf[2], xf[3]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * mi + g4 + 8 * hf;
          if (i >= n) continue;
          const int64_t row =
              ((static_cast<int64_t>(b) * S + t0 + i) * nh + head) * HD + d0 +
              2 * c4;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float v0 = yacc[mi][q][2 * hf];
            const float v1 = yacc[mi][q][2 * hf + 1];
            if (y32 != nullptr)
              *reinterpret_cast<float2*>(y32 + row + 8 * q) =
                  make_float2(v0, v1);
            if (yt != nullptr)
              *reinterpret_cast<uint32_t*>(yt + row + 8 * q) =
                  pack_bf16(v0, v1);
          }
        }
    }

    // (d) h <- h exp(total) + (w o x)^T B: A fragments of x^T by a
    // transposing ldmatrix, scaled by w and split into hi + lo
    {
      const float decay = expf(total);
#pragma unroll
      for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[sn][e] *= decay;
#pragma unroll
      for (int kj = 0; kj < kMT; ++kj) {
        if (16 * kj >= n) break;
        uint32_t xa[4], ah[4], al[4];
        ldsm_x4_trans(xa, xs + (16 * kj + (lane & 7) + (lane >> 4) * 8) *
                                   L::kXStride +
                              d0 + ((lane >> 3) & 1) * 8);
        const int j = 16 * kj + 2 * c4;
        const float w[4] = {wgt[j], wgt[j + 1], wgt[j + 8], wgt[j + 9]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = unpack_bf16(xa[r]);
          const int wi = r < 2 ? 0 : 2;
          split_bf16(f.x * w[wi], f.y * w[wi + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int sp = 0; sp < DS / 16; ++sp) {
          uint32_t r[4];
          ldsm_x4_trans(r, bs + (16 * kj + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * L::kBStride +
                               16 * sp + (lane >> 4) * 8);
          mma_split(h[2 * sp], ah, al, r[0], r[1]);
          mma_split(h[2 * sp + 1], ah, al, r[2], r[3]);
        }
      }
    }
  }

  float* dst = nullptr;
  if (kStateOnly) {
    dst = ws + k * nrows * HD * DS + state;
    if (threadIdx.x == 0)
      ws[(splits - 1) * nrows * HD * DS + k * nrows + b * nh + head] =
          piece_total;
  } else if (k == splits - 1 && h_out != nullptr) {
    dst = h_out + state;
  }
  if (dst != nullptr) {
#pragma unroll
    for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(dst + (d0 + g4 + 8 * hf) * DS + 8 * sn +
                                   2 * c4) =
            make_float2(h[sn][2 * hf], h[sn][2 * hf + 1]);
  }
}

// ------------------------------------------------------------------ launch

template <int HD, int DS>
int launch_shape(const void* x, const void* dt, const void* a,
                 const void* bm, const void* cm, void* y, void* h_out, int B,
                 int S, int nh, int g, int64_t bc_sb, int64_t bc_ss,
                 cudaStream_t stream) {
  using L = F32Smem<HD, DS>;
  const auto kernel = ssd_scan_kernel_f32<HD, DS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nh, B), L::kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y),
      static_cast<float*>(h_out), S, nh, g, bc_sb, bc_ss);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(int hd, int ds, const void* x, const void* dt, const void* a,
               const void* bm, const void* cm, void* y, void* h_out, int B,
               int S, int nh, int g, int64_t bc_sb, int64_t bc_ss,
               cudaStream_t st) {
#define SSD_SHAPE(HD, DS)                                                  \
  if (hd == HD && ds == DS)                                                \
    return launch_shape<HD, DS>(x, dt, a, bm, cm, y, h_out, B, S, nh, g,   \
                                bc_sb, bc_ss, st);
  SSD_SHAPE(64, 128)  // mamba2-2.7b
  SSD_SHAPE(64, 16)   // jamba-v0.1-52b's Mamba layers
  SSD_SHAPE(32, 16)   // their reduced configs
#undef SSD_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HD, int DS, int T, bool kStateOnly>
int launch_bf16_pass(const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, void* y, int y_f32,
                     void* h_out, void* ws, int B, int S, int nh, int g,
                     int64_t bc_sb, int64_t bc_ss, int piece, int splits,
                     int pieces, cudaStream_t stream) {
  using L = Bf16Smem<HD, DS, T>;
  const auto kernel = ssd_scan_kernel_bf16<HD, DS, T, kStateOnly>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nh, B, pieces), L::kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm),
      y_f32 ? static_cast<float*>(y) : nullptr,
      y_f32 ? nullptr : static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(h_out), static_cast<float*>(ws), S, nh, g, bc_sb,
      bc_ss, piece, splits);
  return static_cast<int>(cudaGetLastError());
}

// splits > 1: pass 1 over the first splits - 1 pieces, then pass 2 over
// all of them; else the single pass.  Tiles of 32 steps for a row of at
// most 32 (one tile, never split), else of 64.
template <int HD, int DS>
int launch_bf16(const void* x, const void* dt, const void* a, const void* bm,
                const void* cm, void* y, int y_f32, void* h_out, void* ws,
                int B, int S, int nh, int g, int64_t bc_sb, int64_t bc_ss,
                int piece, int splits, cudaStream_t st) {
  if (S <= 32) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16_pass<HD, DS, 32, false>(x, dt, a, bm, cm, y, y_f32,
                                               h_out, ws, B, S, nh, g, bc_sb,
                                               bc_ss, piece, 1, 1, st);
  }
  if (piece % 64 != 0 || splits < 1 ||
      static_cast<int64_t>(piece) * (splits - 1) >= S ||
      static_cast<int64_t>(piece) * splits < S || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) {
    const int err = launch_bf16_pass<HD, DS, 64, true>(
        x, dt, a, bm, cm, y, y_f32, h_out, ws, B, S, nh, g, bc_sb, bc_ss,
        piece, splits, splits - 1, st);
    if (err != 0) return err;
  }
  return launch_bf16_pass<HD, DS, 64, false>(x, dt, a, bm, cm, y, y_f32,
                                             h_out, ws, B, S, nh, g, bc_sb,
                                             bc_ss, piece, splits, splits, st);
}

}  // namespace

// Launch on `stream`.  dtype is x's, B's and C's type: 0 float32 runs
// ssd_scan_kernel_f32 over an (nh, B) grid; 1 bfloat16 runs
// ssd_scan_kernel_bf16, over an (nh, B, splits) grid after a state pass
// over (nh, B, splits - 1) when splits > 1: pieces of `piece` steps (a
// multiple of 64; splits pieces cover S, none wholly past it), their
// states and totals in the workspace ws ((splits - 1) (B nh hd ds + B
// nh) floats; unused when splits is 1).  float32 takes splits 1.  y is
// float32 when y_f32 != 0, else of x's type; h_out (B, nh, hd, ds)
// float32 may be null (float32 writes y in float32: y_f32 != 0).  B
// and C share the strides bc_sb (batch) and bc_ss (time step), in
// elements, with the group and state axes packed; every row of x, B and
// C starts 16-byte aligned.  (hd, ds)
// is (64, 128), (64, 16) or (32, 16).  Returns the first CUDA error of setting the
// shared-memory size or of a launch, 0 if none.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               int y_f32, void* h_out, void* ws, int B,
                               int S, int nh, int g, int hd, int ds,
                               int dtype, long long bc_sb, long long bc_ss,
                               int piece, int splits, void* stream) {
  if (B == 0 || nh == 0) return 0;
  if (g <= 0 || nh % g != 0 || B > 65535 || nh > 65535 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (splits != 1 || !y_f32) return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32(hd, ds, x, dt, a, bm, cm, y, h_out, B, S, nh, g, bc_sb,
                      bc_ss, st);
  }
  if (dtype == 1) {
    if (hd == 64 && ds == 128)
      return launch_bf16<64, 128>(x, dt, a, bm, cm, y, y_f32, h_out, ws, B,
                                  S, nh, g, bc_sb, bc_ss, piece, splits, st);
    if (hd == 64 && ds == 16)
      return launch_bf16<64, 16>(x, dt, a, bm, cm, y, y_f32, h_out, ws, B,
                                 S, nh, g, bc_sb, bc_ss, piece, splits, st);
    if (hd == 32 && ds == 16)
      return launch_bf16<32, 16>(x, dt, a, bm, cm, y, y_f32, h_out, ws, B, S,
                                 nh, g, bc_sb, bc_ss, piece, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
