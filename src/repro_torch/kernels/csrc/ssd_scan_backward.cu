// The backward of the port's Mamba2 SSD scan (ssd_scan.cu): dx, ddt, dA,
// dB and dC of (y, h_S) = SSD(x, dt, A, B, C) against dy and dh_S.
//
// No TPU kernel: the reference trains Mamba2 through XLA's autodiff of
// its plain _ssd_chunked (src/repro/models/mamba2.py:85); its Pallas
// scan has no backward.  x (B, S, nh, hd), dt (B, S, nh) float32, A
// (nh,) float32, B and C (B, S, g, ds) with head h reading group
// h / (nh / g), as the forward takes them (B and C through a batch and a
// time stride); dy (B, S, nh, hd) and dh_S (B, nh, hd, ds) float32
// (dh_S may be null: zero).  Outputs: dx in x's type, ddt (B, S, nh) and
// dA (nh,) float32, dB and dC (B, S, g, ds) contiguous in B's type.
//
// The algebra, per (b, head) and 64-step tile, with cum the tile's
// prefix sum of a = dt A, total its last value, L_ij = exp(cum_i -
// cum_j) for j <= i, S_ij = C_i . B_j, P_ij = dy_i . x_j, w_j =
// exp(total - cum_j) dt_j, h_in the state entering the tile and dh the
// gradient of the state leaving it:
//   dx_j  = sum_i S_ij L_ij dt_j dy_i + w_j (dh B_j)
//   dC_i  = sum_j P_ij L_ij dt_j B_j + exp(cum_i) (dy_i^T h_in)
//   dB_j  = sum_i P_ij L_ij dt_j C_i + w_j (x_j^T dh)
//   da_m  = sum_{j < m <= i} Q_ij + sum_{i >= m} exp(cum_i) dy_i.(h_in C_i)
//           + sum_{j < m} w_j x_j.(dh B_j) + exp(total) <dh, h_in>,
//           Q_ij = S_ij L_ij P_ij dt_j
//   ddt_m = A da_m + sum_i S_im L_im P_im + exp(total - cum_m) x_m.(dh B_m)
//   dA   += sum_m dt_m da_m
//   dh   <- exp(total) dh + sum_i exp(cum_i) dy_i (x) C_i   (tile before)
// da_m is the reverse cumulative sum of the gradient of cum, summed so
// that no two large terms cancel (a pair (i, j) with both indices on
// one side of m adds to both the row and the column sums and drops
// out); the masked pairs j > i are never formed, so no exp of a
// positive number is taken.  Rows past S are staged as zeros (dt = 0
// identity steps, the reference's padding) and their gradients are not
// written.  kernels/ssd_scan.py's ssd_scan_backward_plain is this
// algebra in plain torch.
//
// Design: recompute, do not save; every sum in a fixed order, with no
// atomics, so two launches give the same bits.  The dtype picks the
// kernels.
//
// bf16 design (tensor cores).  Three launches:
//   1. ssd_bwd_state_kernel_bf16: one block per (head, b), hd / 16 warps
//      (warp w owning rows [16 w, 16 w + 16) of the state), two walks
//      over the tiles, each a tensor-core product per tile with its
//      operands staged by cp.async two stages deep: the forward's state
//      update h <- h exp(total) + (w o x)^T B writes h_in, the state
//      entering each tile; then, from dh_S backwards, dh <- dh exp(total)
//      + (exp(cum) o dy)^T C writes dh, the gradient of the state
//      leaving each tile (both (B, nh, tiles, hd, ds) float32).
//   2. ssd_bwd_tile_kernel_bf16: with h_in and dh given, the tiles are
//      independent: one block of 8 warps per (head block, tile, b),
//      where a head block is hpb consecutive heads of one group
//      (kernels/ssd_scan.py's backward_heads: the most, up to 8, that
//      leave the grid 2 blocks an SM).  B and C of the tile are staged
//      once, as bf16, and S = C B^T is formed once for all hpb heads.
//      Per head: x staged as bf16 (cp.async), dy, h_in and dh split
//      into hi + lo bf16 tiles (and <dh, h_in> summed in float32 on the
//      way), P = dy x^T, then G = S L dt and E = P L dt as hi + lo tiles
//      and K = S L P in float32 (masked before the exp), and the
//      products dx = G^T dy + w (B dh^T), dC += E B + exp(cum) (dy h_in)
//      and dB += E^T C + w (x dh), each warp a 16-row block and a column
//      half of its outputs.  dB and dC of the block's heads are summed
//      in registers, in head order, and written once per head block;
//      da, ddt and each head's sum of dt da over the tile come from K,
//      the row sums and the dot on the CUDA cores, as below.
//   3. ssd_reduce_kernel: dB and dC as the sums of a group's head-block
//      partials, dA as the sum of the (batch row, tile) partials, each
//      in order.
// Every product is mma.sync m16n8k16 bf16 -> float32 with ldmatrix
// fragments from tiles padded by 16 bytes a row.  x, B and C are the
// bf16 they arrive in; dy is float32 (the forward's y is float32), as
// are h_in, dh and the L dt-weighted tile matrices.  Each float32
// operand goes to the tensor cores as hi + lo (two mma; three where
// both operands are float32, the lo x lo term dropped): one bf16 term
// of dy moves ddt and dA to 21.7x and 53x their 1e-4 gate, of h_in and
// dh to 6.0x and 6.7x, of the state updates' w o x and exp(cum) o dy to
// 2.0x and 4.6x, and one term of G and E (which feed only the bf16
// gradients) moves dB to 0.76 of its 2^-7 gate (CPU estimates at
// mamba2's widths, S 1,024, tests/test_torch_ssd_backward_tiles.py);
// with all of them as hi + lo every gradient stays within 0.19 of its
// gate, the float32 tile form's own distance.
//
// Shared memory and occupancy at mamba2-2.7b's (64, 128): the tile
// kernel holds B, C (bf16), S (float32), x, dy hi + lo, h_in and dh hi
// + lo, G and E hi + lo, K (float32) and 13 step vectors: 206,400
// bytes, one block of 8 warps an SM; at the training shape (B 2 x 512,
// 80 heads, hpb 4) its grid is 20 x 8 x 2 = 320 blocks, 2.4 waves on 132
// SMs (hpb 8 would give 160, 1.2 waves).  Jamba's (64, 16) takes 120,384
// bytes; 128 heads at hpb 4 give 32 x 8 x 2 = 512 blocks.  The state
// kernel takes 72,192 bytes at (64, 128) (3 blocks an SM) over an (nh,
// B) grid: 160 blocks at the training shape.  Registers (ptxas -v,
// sm_90a): the tile kernel 233 at (64, 128), 166 at (64, 16), 137 at
// (32, 16), so one block an SM by registers too; the state kernel 138,
// 72, 72; no spill anywhere.
//
// Bound.  The recurrence's backward takes four products a step and
// head (dh B, x^T dh, dy^T h, dy (x) C): 8 hd ds flops, 5.4 GFLOP at
// B 2 x 512 on mamba2, 0.0055 ms at the tensor cores' 989 TFLOP/s, under
// the bytes that must move (x, dt, B, C, dy in; dx, ddt, dB, dC out:
// ~0.013 ms at 3.35 TB/s): bytes bound the bf16 case.  In float32 the
// operations bound it: 0.0326 ms at 3xTF32's 164.9 TFLOP/s (0.080 at
// the CUDA cores' 67).  Both routes also move h_in and dh through a
// workspace (4 x 42 MB at the training shape) and the head-block
// partials of dB and dC (2 x 2 x 10 MB), and the dual form issues ~3x
// the bound's products, twice again for bf16 hi + lo, three times for
// 3xTF32.
//
// float32 design (tensor cores, 3xTF32).  The bf16 route's three
// launches, each product as m16n8k8 TF32 mma with every float32 operand
// split into a TF32 big term and a small term as it is loaded (small .
// big + big . small + big . big; tensor_core.cuh):
//   1. ssd_bwd_state_kernel_f32: one block per (head, b, 64 state
//      columns) (two a (head, b) at mamba2's 128: half the registers,
//      three blocks an SM), x and B, then dy and C staged as float32 by
//      cp.async two stages deep; each tile's update summed in zeroed
//      fragments, the small terms' products apart from big . big, and
//      added to h (dh) in round-to-nearest;
//   2. ssd_bwd_tile_kernel_f32: the bf16 tile kernel's walk in float32,
//      its operands (B, C, x, dy, h_in, dh) staged as float32 rows
//      padded to 8 mod 32 floats (each fragment load meets 32 distinct
//      banks, or 2-way where one matrix is read both ways), G and E as
//      float32.  S = C B^T is formed per head in registers beside P:
//      kept in shared memory it would take 17 KB more than the 232,448
//      bytes a block may have (the rest is 230,976 at (64, 128)).  dC
//      and dB of a head start from its state terms (exp(cum) dy h_in,
//      w x dh) in zeroed fragments, E B and E^T C continue them, and
//      the head's sums are added to the block's in round-to-nearest;
//   3. ssd_reduce_kernel, as for bf16.
// Registers (ptxas -v, sm_90a; tools/ablate_torch_ssd.py): the tile
// kernel 240 at (64, 128), 177 at (64, 16), 149 at (32, 16); the state
// kernel 168, 165, 184; no spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;           // the reduction's blocks
constexpr int kTile = 64;                // time steps per tile
constexpr int kPT = kTile + 1;           // pitch of the K matrix
static_assert(kTile == 64, "the prefix sum gives each lane two steps");

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// cum = prefix sum of dt * A over the tile (one warp, two steps a
// lane), as the forward kernel takes it
__device__ __forceinline__ void tile_cum(const float* dt_s, float A,
                                         float* cum_s, int lane) {
  const float d0 = __fmul_rn(dt_s[2 * lane], A);
  const float v1 = d0 + __fmul_rn(dt_s[2 * lane + 1], A);
  float incl = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  cum_s[2 * lane] = excl + d0;
  cum_s[2 * lane + 1] = excl + v1;
  __syncwarp();
}

// ------------------------------------------------------------ reduction

// dB and dC: the `parts` partials of a row (one per head, or per head
// block in bf16) summed over those of its group, in order; dA: the
// da_rows partials of each head (one per batch row, or per (batch row,
// tile) in bf16) summed in order
template <typename T>
__global__ void ssd_reduce_kernel(const float* __restrict__ db_part,
                                  const float* __restrict__ dc_part,
                                  const float* __restrict__ da_part,
                                  T* __restrict__ db, T* __restrict__ dc,
                                  float* __restrict__ da, int64_t rows,
                                  int da_rows, int nh, int parts, int g,
                                  int ds) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int rep = parts / g;
  if (e < rows * g * ds) {
    const int64_t row = e / (static_cast<int64_t>(g) * ds);
    const int grp = static_cast<int>((e / ds) % g);
    const int s = static_cast<int>(e % ds);
    const int64_t base =
        (row * parts + static_cast<int64_t>(grp) * rep) * ds + s;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += db_part[base + static_cast<int64_t>(r) * ds];
      sc += dc_part[base + static_cast<int64_t>(r) * ds];
    }
    store(db + e, sb);
    store(dc + e, sc);
  }
  if (e < nh) {
    float s = 0.f;
    for (int b = 0; b < da_rows; ++b)
      s += da_part[static_cast<int64_t>(b) * nh + e];
    da[e] = s;
  }
}

template <typename T>
int launch_reduce(const void* db_part, const void* dc_part,
                  const void* da_part, void* db, void* dc, void* da,
                  int64_t rows, int da_rows, int nh, int parts, int g,
                  int ds, cudaStream_t stream) {
  const int64_t work = rows * g * ds > nh ? rows * g * ds : nh;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ssd_reduce_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<const float*>(da_part), static_cast<T*>(db),
      static_cast<T*>(dc), static_cast<float*>(da), rows, da_rows, nh, parts,
      g, ds);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- bfloat16

// Shared memory of the bf16 state kernel, in bytes: two stages, each
// holding either walk 1's x and B (bf16) or walk 2's dy (float32) and C
// (bf16), rows padded (bf16 rows by 16 bytes, so that ldmatrix reads 8
// rows in distinct banks; dy rows by 4 floats, so that a fragment's 8
// rows and 4 column pairs fall in distinct banks), then dt; then each
// warp's own cum and weights.
template <int HD, int DS>
struct Bf16State {
  static constexpr int kWarps = HD / 16;         // one per 16 rows of h
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kXS = HD + 8;             // bf16 per padded x row
  static constexpr int kBS = DS + 8;             // of a B / C row
  static constexpr int kYS = HD + 4;             // floats per dy row
  static constexpr int kX = 0;                   // walk 1
  static constexpr int kB = kX + 2 * kTile * kXS;
  static constexpr int kY = 0;                   // walk 2
  static constexpr int kC = kY + 4 * kTile * kYS;
  static constexpr int kEnd1 = kB + 2 * kTile * kBS;
  static constexpr int kEnd2 = kC + 2 * kTile * kBS;
  static constexpr int kDt = kEnd1 > kEnd2 ? kEnd1 : kEnd2;
  static constexpr int kStage = kDt + 4 * kTile;
  static constexpr int kScan = 2 * kStage;
  static constexpr int kBytes = kScan + kWarps * 2 * 4 * kTile;
  static_assert(kB % 16 == 0 && kC % 16 == 0 && kDt % 16 == 0 &&
                    kStage % 16 == 0,
                "16-byte aligned rows for cp.async and ldmatrix");
};

// Stage rows [t0, t0 + n) of a tile (rows past n zero-filled, dt = 0
// making them identity steps): walk 1 x and B, walk 2 dy and C.
template <int HD, int DS, bool kWalk2>
__device__ __forceinline__ void state_tile(
    unsigned char* stage, const __nv_bfloat16* xb, const float* dyb,
    const float* dtb, const __nv_bfloat16* mb, int64_t x_step, int nh,
    int64_t bc_ss, int t0, int n) {
  using L = Bf16State<HD, DS>;
  if (kWalk2) {
    float* ys = reinterpret_cast<float*>(stage + L::kY);
    constexpr int kChunks = HD / 4;              // 16-byte chunks a row
    for (int c = threadIdx.x; c < kTile * kChunks; c += L::kThreads) {
      const int r = c / kChunks;
      const int ch = c % kChunks;
      const bool ok = r < n;
      cp_async16(ys + r * L::kYS + ch * 4,
                 dyb + (t0 + (ok ? r : 0)) * x_step + ch * 4, ok);
    }
  } else {
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage + L::kX);
    constexpr int kChunks = HD / 8;
    for (int c = threadIdx.x; c < kTile * kChunks; c += L::kThreads) {
      const int r = c / kChunks;
      const int ch = c % kChunks;
      const bool ok = r < n;
      cp_async16(xs + r * L::kXS + ch * 8,
                 xb + (t0 + (ok ? r : 0)) * x_step + ch * 8, ok);
    }
  }
  __nv_bfloat16* ms = reinterpret_cast<__nv_bfloat16*>(
      stage + (kWalk2 ? L::kC : L::kB));
  constexpr int kBChunks = DS / 8;
  for (int c = threadIdx.x; c < kTile * kBChunks; c += L::kThreads) {
    const int r = c / kBChunks;
    const int ch = c % kBChunks;
    const bool ok = r < n;
    cp_async16(ms + r * L::kBS + ch * 8,
               mb + (t0 + (ok ? r : 0)) * bc_ss + ch * 8, ok);
  }
  float* dts = reinterpret_cast<float*>(stage + L::kDt);
  for (int r = threadIdx.x; r < kTile; r += L::kThreads)
    cp_async4(dts + r, dtb + static_cast<int64_t>(t0 + (r < n ? r : 0)) * nh,
              r < n);
}

// cum = the tile's prefix sum of dt*A into this warp's own copy (lane l
// holds steps 2l and 2l+1, as the forward takes it); returns the total
__device__ __forceinline__ float warp_cum(const float* dts, float A,
                                          float* cum, int lane) {
  const float d0 = __fmul_rn(dts[2 * lane], A);
  const float v1 = d0 + __fmul_rn(dts[2 * lane + 1], A);
  float incl = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  cum[2 * lane] = excl + d0;
  cum[2 * lane + 1] = excl + v1;
  __syncwarp();
  return __shfl_sync(0xffffffffu, excl + v1, 31);
}

// h_in and dh of every tile, one block per (head, b), warp w owning rows
// [16 w, 16 w + 16) of both, in the accumulator layout of their updates:
//   walk 1: h_in[t] = h, then h <- h exp(total) + (w o x)^T B
//   walk 2 (t from the last): dh[t] = dh, then
//           dh <- dh exp(total) + (exp(cum) o dy)^T C
// each a tensor-core product over the tile's steps, its float32 operand
// (w o x, exp(cum) o dy) split into hi + lo A fragments.
template <int HD, int DS>
__global__ void __launch_bounds__(2 * HD)
ssd_bwd_state_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const __nv_bfloat16* __restrict__ bm,
                          const __nv_bfloat16* __restrict__ cm,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_end,
                          float* __restrict__ states,
                          float* __restrict__ dstates, int S, int nh, int g,
                          int64_t bc_sb, int64_t bc_ss) {
  using L = Bf16State<HD, DS>;
  constexpr int kSN = DS / 8;                    // 8-column tiles of h
  constexpr int kMT = kTile / 16;
  extern __shared__ __align__(16) unsigned char sbuf[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int c4 = lane % 4;
  const int d0 = 16 * warp;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = head / (nh / g);
  const float A = a[head];
  const int tiles = (S + kTile - 1) / kTile;
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const __nv_bfloat16* xb = x + row0 * x_step + static_cast<int64_t>(head) * HD;
  const float* dyb = dy + row0 * x_step + static_cast<int64_t>(head) * HD;
  const float* dtb = dt + row0 * nh + head;
  const __nv_bfloat16* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  const __nv_bfloat16* cb = cm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  const int64_t bh = static_cast<int64_t>(b) * nh + head;
  float* cum = reinterpret_cast<float*>(sbuf + L::kScan) + warp * 2 * kTile;
  float* wgt = cum + kTile;

  float h[kSN][4];
  auto put = [&](float* dst) {
#pragma unroll
    for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(dst + (d0 + g4 + 8 * hf) * DS + 8 * sn +
                                   2 * c4) =
            make_float2(h[sn][2 * hf], h[sn][2 * hf + 1]);
  };

  // walk 1: the state entering each tile, from h = 0
#pragma unroll
  for (int sn = 0; sn < kSN; ++sn)
    h[sn][0] = h[sn][1] = h[sn][2] = h[sn][3] = 0.f;
  if (tiles > 1)
    state_tile<HD, DS, false>(sbuf, xb, dyb, dtb, bb, x_step, nh, bc_ss, 0,
                              min(kTile, S));
  cp_async_commit();
  for (int t = 0; t + 1 < tiles; ++t) {
    put(states + (bh * tiles + t) * HD * DS);
    cp_async_wait_all();
    __syncthreads();
    if (t + 2 < tiles)
      state_tile<HD, DS, false>(sbuf + ((t + 1) & 1) * L::kStage, xb, dyb,
                                dtb, bb, x_step, nh, bc_ss, (t + 1) * kTile,
                                min(kTile, S - (t + 1) * kTile));
    cp_async_commit();
    const unsigned char* stage = sbuf + (t & 1) * L::kStage;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(stage + L::kX);
    const __nv_bfloat16* bs =
        reinterpret_cast<const __nv_bfloat16*>(stage + L::kB);
    const float* dts = reinterpret_cast<const float*>(stage + L::kDt);
    const float total = warp_cum(dts, A, cum, lane);
    wgt[2 * lane] = expf(total - cum[2 * lane]) * dts[2 * lane];
    wgt[2 * lane + 1] = expf(total - cum[2 * lane + 1]) * dts[2 * lane + 1];
    __syncwarp();
    const float decay = expf(total);
#pragma unroll
    for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[sn][e] *= decay;
#pragma unroll
    for (int kj = 0; kj < kMT; ++kj) {
      uint32_t xa[4], ah[4], al[4];
      ldsm_x4_trans(xa, xs + (16 * kj + (lane & 7) + (lane >> 4) * 8) *
                                 L::kXS +
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
      for (int sn = 0; sn < kSN; ++sn) {
        uint32_t r[2];
        frag_b_t(r, bs, L::kBS, 16 * kj, 8 * sn);
        mma_split(h[sn], ah, al, r[0], r[1]);
      }
    }
  }
  put(states + (bh * tiles + tiles - 1) * HD * DS);
  __syncthreads();

  // walk 2: the gradient of the state leaving each tile, from dh_S
#pragma unroll
  for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2 v = make_float2(0.f, 0.f);
      if (dh_end != nullptr)
        v = *reinterpret_cast<const float2*>(
            dh_end + bh * HD * DS + (d0 + g4 + 8 * hf) * DS + 8 * sn + 2 * c4);
      h[sn][2 * hf] = v.x;
      h[sn][2 * hf + 1] = v.y;
    }
  if (tiles > 1) {
    const int tl = (tiles - 1) * kTile;
    state_tile<HD, DS, true>(sbuf, xb, dyb, dtb, cb, x_step, nh, bc_ss, tl,
                             S - tl);
  }
  cp_async_commit();
  for (int it = 0; it + 1 < tiles; ++it) {
    const int t = tiles - 1 - it;
    put(dstates + (bh * tiles + t) * HD * DS);
    cp_async_wait_all();
    __syncthreads();
    if (t - 1 > 0)
      state_tile<HD, DS, true>(sbuf + ((it + 1) & 1) * L::kStage, xb, dyb,
                               dtb, cb, x_step, nh, bc_ss, (t - 1) * kTile,
                               kTile);
    cp_async_commit();
    const int n = min(kTile, S - t * kTile);
    const unsigned char* stage = sbuf + (it & 1) * L::kStage;
    const float* ys = reinterpret_cast<const float*>(stage + L::kY);
    const __nv_bfloat16* cs =
        reinterpret_cast<const __nv_bfloat16*>(stage + L::kC);
    const float* dts = reinterpret_cast<const float*>(stage + L::kDt);
    const float total = warp_cum(dts, A, cum, lane);
    wgt[2 * lane] = expf(cum[2 * lane]);
    wgt[2 * lane + 1] = expf(cum[2 * lane + 1]);
    __syncwarp();
    const float decay = expf(total);
#pragma unroll
    for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[sn][e] *= decay;
#pragma unroll
    for (int kj = 0; kj < kMT; ++kj) {
      if (16 * kj >= n) break;
      // A (rows d, columns steps i) = exp(cum_i) dy[i][d], as hi + lo
      const int i = 16 * kj + 2 * c4;
      const float* y0 = ys + i * L::kYS + d0 + g4;
      const float e[4] = {wgt[i], wgt[i + 1], wgt[i + 8], wgt[i + 9]};
      uint32_t ah[4], al[4];
      split_bf16(e[0] * y0[0], e[1] * y0[L::kYS], ah[0], al[0]);
      split_bf16(e[0] * y0[8], e[1] * y0[L::kYS + 8], ah[1], al[1]);
      split_bf16(e[2] * y0[8 * L::kYS], e[3] * y0[9 * L::kYS], ah[2], al[2]);
      split_bf16(e[2] * y0[8 * L::kYS + 8], e[3] * y0[9 * L::kYS + 8], ah[3],
                 al[3]);
#pragma unroll
      for (int sn = 0; sn < kSN; ++sn) {
        uint32_t r[2];
        frag_b_t(r, cs, L::kBS, 16 * kj, 8 * sn);
        mma_split(h[sn], ah, al, r[0], r[1]);
      }
    }
  }
  put(dstates + bh * tiles * HD * DS);
}

// Shared memory of the bf16 tile kernel, in bytes (see the note at the
// top for the sizes).  bf16 rows are padded by 16 bytes (ldmatrix reads
// 8 rows in distinct banks); S is float32, shared by the block's heads.
template <int HD, int DS>
struct Bf16Tile {
  static constexpr int kXS = HD + 8;             // bf16: x, dy rows
  static constexpr int kBS = DS + 8;             // bf16: B, C, h, dh rows
  static constexpr int kMS = kTile + 8;          // bf16: G, E rows
  static constexpr int kSP = kTile + 4;          // float: S rows
  static constexpr int kBBytes = 2 * kTile * kBS;
  static constexpr int kXBytes = 2 * kTile * kXS;
  static constexpr int kHBytes = 2 * HD * kBS;
  static constexpr int kMBytes = 2 * kTile * kMS;
  static constexpr int kB = 0;
  static constexpr int kC = kB + kBBytes;
  static constexpr int kS = kC + kBBytes;
  static constexpr int kX = kS + 4 * kTile * kSP;
  static constexpr int kDyH = kX + kXBytes;
  static constexpr int kDyL = kDyH + kXBytes;
  static constexpr int kHinH = kDyL + kXBytes;
  static constexpr int kHinL = kHinH + kHBytes;
  static constexpr int kDhH = kHinL + kHBytes;
  static constexpr int kDhL = kDhH + kHBytes;
  static constexpr int kGH = kDhL + kHBytes;
  static constexpr int kGL = kGH + kMBytes;
  static constexpr int kEH = kGL + kMBytes;
  static constexpr int kEL = kEH + kMBytes;
  static constexpr int kK = kEL + kMBytes;       // float, kTile x kPT
  static constexpr int kVec = kK + 4 * kTile * kPT;
  static constexpr int kVecs = 13;               // 64-float vectors
  static constexpr int kRed = kVec + 4 * kVecs * kTile;
  static constexpr int kBytes = kRed + 4 * 16;
  static_assert(kC % 16 == 0 && kS % 16 == 0 && kX % 16 == 0 &&
                    kDyH % 16 == 0 && kDyL % 16 == 0 && kHinH % 16 == 0 &&
                    kHinL % 16 == 0 && kDhH % 16 == 0 && kDhL % 16 == 0 &&
                    kGH % 16 == 0 && kGL % 16 == 0 && kEH % 16 == 0 &&
                    kEL % 16 == 0 && kK % 16 == 0 && kVec % 16 == 0,
                "16-byte aligned regions");
};

constexpr int kTileWarps = 8;
constexpr int kTileThreads = 32 * kTileWarps;

// float32 (rows x cols, row pitch cols in global memory) into hi and lo
// bf16 tiles of row pitch `pitch`; rows at or past n are zero
template <int COLS>
__device__ __forceinline__ void split_rows(__nv_bfloat16* hi,
                                           __nv_bfloat16* lo,
                                           const float* src, int64_t step,
                                           int rows, int n, int pitch) {
  constexpr int kQuads = COLS / 4;
  for (int e = threadIdx.x; e < rows * kQuads; e += kTileThreads) {
    const int r = e / kQuads;
    const int c = 4 * (e % kQuads);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) v = *reinterpret_cast<const float4*>(src + r * step + c);
    uint2 h, l;
    split_bf16(v.x, v.y, h.x, l.x);
    split_bf16(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * pitch + c) = h;
    *reinterpret_cast<uint2*>(lo + r * pitch + c) = l;
  }
}

// One block per (head block, tile, b): blockIdx = (head block, tile,
// b); the block's `hpb` heads are consecutive heads of one group.  Per
// tile every product of the backward runs on the tensor cores, from
// h_in and dh of the state kernel: no state is carried from tile to
// tile, so the tiles run in parallel.  dB and dC of the block's heads
// are summed in head order in registers and written once; dx, ddt and
// each head's sum of dt da over the tile are written per head.
template <int HD, int DS>
__global__ void __launch_bounds__(kTileThreads, 1)
ssd_bwd_tile_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ a,
                         const __nv_bfloat16* __restrict__ bm,
                         const __nv_bfloat16* __restrict__ cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ states,
                         const float* __restrict__ dstates,
                         __nv_bfloat16* __restrict__ dx,
                         float* __restrict__ ddt,
                         float* __restrict__ db_part,
                         float* __restrict__ dc_part,
                         float* __restrict__ da_part, int S, int nh, int g,
                         int hpb, int64_t bc_sb, int64_t bc_ss) {
  using L = Bf16Tile<HD, DS>;
  constexpr int kND = HD / 16;                   // n-tiles of a dx half
  constexpr int kNC = DS / 16;                   // of a dB / dC half
  extern __shared__ __align__(16) unsigned char sbuf[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kB);
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kC);
  float* s_s = reinterpret_cast<float*>(sbuf + L::kS);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kX);
  __nv_bfloat16* dyh = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kDyH);
  __nv_bfloat16* dyl = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kDyL);
  __nv_bfloat16* hinh = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kHinH);
  __nv_bfloat16* hinl = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kHinL);
  __nv_bfloat16* dhh = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kDhH);
  __nv_bfloat16* dhl = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kDhL);
  __nv_bfloat16* gh = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kGH);
  __nv_bfloat16* gl = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kGL);
  __nv_bfloat16* eh = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kEH);
  __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(sbuf + L::kEL);
  float* k_s = reinterpret_cast<float*>(sbuf + L::kK);   // S L P, then Q
  float* dt_s = reinterpret_cast<float*>(sbuf + L::kVec);
  float* cum_s = dt_s + kTile;
  float* ecum_s = cum_s + kTile;         // exp(cum_i)
  float* edec_s = ecum_s + kTile;        // exp(total - cum_j)
  float* w_s = edec_s + kTile;           // exp(total - cum_j) dt_j
  float* v_s = w_s + kTile;              // exp(total - cum_j) x_j.(dh B_j)
  float* r_s = v_s + kTile;              // exp(cum_i) dy_i.(h_in C_i)
  float* colk_s = r_s + kTile;           // sum_i (S L P)_ij
  float* dtda_s = colk_s + kTile;        // dt_m da_m
  float* vp_s = dtda_s + kTile;          // two halves of x_j.(dh B_j)
  float* rp_s = vp_s + 2 * kTile;        // two halves of dy_i.(h_in C_i)
  float* red_s = reinterpret_cast<float*>(sbuf + L::kRed);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g4 = lane / 4;
  const int c4 = lane % 4;
  const int hb = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = gridDim.y;
  const int t0 = t * kTile;
  const int n = min(kTile, S - t0);
  const int grp = hb * hpb / (nh / g);
  // products: warp (rb, ch) takes rows [16 rb, 16 rb + 16) of its
  // outputs and column half ch; the tile matrices: row block wb = warp /
  // 2, column blocks 2 (warp % 2) and 2 (warp % 2) + 1 up to wb
  const int rb = warp & 3;
  const int ch = warp >> 2;
  const int wb = warp >> 1;
  const int wc = warp & 1;
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0;  // (b, t0) row

  // B and C of the tile, and S = C B^T (lower block triangle)
  {
    const __nv_bfloat16* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS;
    const __nv_bfloat16* cb = cm + b * bc_sb + static_cast<int64_t>(grp) * DS;
    constexpr int kChunks = DS / 8;
    for (int c = tid; c < kTile * kChunks; c += kTileThreads) {
      const int r = c / kChunks;
      const int cc = c % kChunks;
      const bool ok = r < n;
      const int64_t off = (t0 + (ok ? r : 0)) * bc_ss + cc * 8;
      cp_async16(b_s + r * L::kBS + cc * 8, bb + off, ok);
      cp_async16(c_s + r * L::kBS + cc * 8, cb + off, ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int jb = 2 * wc + q2;
      if (jb > wb) break;
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < DS / 16; ++ks) {
        uint32_t af[4];
        frag_a(af, c_s, L::kBS, 16 * wb, 16 * ks);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t bf[2];
          frag_b(bf, b_s, L::kBS, 16 * jb + 8 * q, 16 * ks);
          mma_bf16(sc[q], af, bf[0], bf[1]);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(
              s_s + (16 * wb + g4 + 8 * hf) * L::kSP + 16 * jb + 8 * q +
              2 * c4) = make_float2(sc[q][2 * hf], sc[q][2 * hf + 1]);
    }
  }

  float dba[kNC][4], dca[kNC][4];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dba[c][e] = dca[c][e] = 0.f;

  for (int hh = 0; hh < hpb; ++hh) {
    const int head = hb * hpb + hh;
    const float A = a[head];
    const int64_t bh = static_cast<int64_t>(b) * nh + head;
    // 1. stage x (cp.async), dy as hi + lo, dt, and h_in and dh as hi +
    //    lo with their float32 dot <dh, h_in>
    {
      const __nv_bfloat16* xb = x + row0 * x_step + static_cast<int64_t>(head) * HD;
      constexpr int kChunks = HD / 8;
      for (int c = tid; c < kTile * kChunks; c += kTileThreads) {
        const int r = c / kChunks;
        const int cc = c % kChunks;
        const bool ok = r < n;
        cp_async16(x_s + r * L::kXS + cc * 8,
                   xb + (ok ? r : 0) * x_step + cc * 8, ok);
      }
      cp_async_commit();
      split_rows<HD>(dyh, dyl,
                     dy + row0 * x_step + static_cast<int64_t>(head) * HD,
                     x_step, kTile, n, L::kXS);
      if (tid < kTile)
        dt_s[tid] = tid < n ? dt[(row0 + tid) * nh + head] : 0.f;
      const float* hin = states + (bh * tiles + t) * HD * DS;
      const float* dhv = dstates + (bh * tiles + t) * HD * DS;
      float p = 0.f;
      constexpr int kQuads = DS / 4;
      for (int e = tid; e < HD * kQuads; e += kTileThreads) {
        const int r = e / kQuads;
        const int c = 4 * (e % kQuads);
        const float4 hv = *reinterpret_cast<const float4*>(hin + r * DS + c);
        const float4 dv = *reinterpret_cast<const float4*>(dhv + r * DS + c);
        p = fmaf(hv.x, dv.x, p);
        p = fmaf(hv.y, dv.y, p);
        p = fmaf(hv.z, dv.z, p);
        p = fmaf(hv.w, dv.w, p);
        uint2 h2, l2;
        split_bf16(hv.x, hv.y, h2.x, l2.x);
        split_bf16(hv.z, hv.w, h2.y, l2.y);
        *reinterpret_cast<uint2*>(hinh + r * L::kBS + c) = h2;
        *reinterpret_cast<uint2*>(hinl + r * L::kBS + c) = l2;
        split_bf16(dv.x, dv.y, h2.x, l2.x);
        split_bf16(dv.z, dv.w, h2.y, l2.y);
        *reinterpret_cast<uint2*>(dhh + r * L::kBS + c) = h2;
        *reinterpret_cast<uint2*>(dhl + r * L::kBS + c) = l2;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) red_s[warp] = p;
      cp_async_wait_all();
      __syncthreads();
    }

    // 2. cum and its exponentials (steps past n add 0, so the last value
    //    is the tile's total)
    if (warp == 0) {
      tile_cum(dt_s, A, cum_s, lane);
      const float total = cum_s[kTile - 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 2 * lane + hf;
        ecum_s[i] = expf(cum_s[i]);
        edec_s[i] = expf(total - cum_s[i]);
        w_s[i] = edec_s[i] * dt_s[i];
      }
    }
    __syncthreads();
    const float total = cum_s[kTile - 1];

    // 3. P = dy x^T (dy as hi + lo) on the lower block triangle, then
    //    G = S L dt and E = P L dt as hi + lo, K = S L P in float32,
    //    for j <= i (the mask before the exp), 0 above
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int jb = 2 * wc + q2;
      if (jb > wb) break;
      float pc[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        uint32_t ah[4], al[4];
        frag_a(ah, dyh, L::kXS, 16 * wb, 16 * kd);
        frag_a(al, dyl, L::kXS, 16 * wb, 16 * kd);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t bf[2];
          frag_b(bf, x_s, L::kXS, 16 * jb + 8 * q, 16 * kd);
          mma_split(pc[q], ah, al, bf[0], bf[1]);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * wb + g4 + 8 * hf;
          const int j = 16 * jb + 8 * q + 2 * c4;
          const float2 sv = *reinterpret_cast<const float2*>(
              s_s + i * L::kSP + j);
          const float svv[2] = {sv.x, sv.y};
          float gv[2], ev[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float kv = 0.f;
            gv[e] = ev[e] = 0.f;
            if (j + e <= i) {
              const float l = expf(cum_s[i] - cum_s[j + e]);
              const float sl = svv[e] * l;
              const float pv = pc[q][2 * hf + e];
              gv[e] = sl * dt_s[j + e];
              ev[e] = pv * l * dt_s[j + e];
              kv = sl * pv;
            }
            k_s[i * kPT + j + e] = kv;
          }
          uint32_t hi, lo;
          split_bf16(gv[0], gv[1], hi, lo);
          *reinterpret_cast<uint32_t*>(gh + i * L::kMS + j) = hi;
          *reinterpret_cast<uint32_t*>(gl + i * L::kMS + j) = lo;
          split_bf16(ev[0], ev[1], hi, lo);
          *reinterpret_cast<uint32_t*>(eh + i * L::kMS + j) = hi;
          *reinterpret_cast<uint32_t*>(el + i * L::kMS + j) = lo;
        }
    }
    __syncthreads();

    // 4. the column sums of K, then each row of Q = K dt turned into its
    //    exclusive prefix sums in place (threads 0..63, which then pass
    //    no barrier until step 6); meanwhile every warp's products
    if (tid < kTile) {
      float sum = 0.f;
      for (int i = tid; i < kTile; ++i) sum += k_s[i * kPT + tid];
      colk_s[tid] = sum;
    }
    __syncthreads();
    if (tid < kTile) {
      float run = 0.f;
      for (int m = 0; m <= tid; ++m) {
        const float qv = k_s[tid * kPT + m] * dt_s[m];
        k_s[tid * kPT + m] = run;
        run += qv;
      }
    }
    // 5a. dx = G^T dy + w o (B dh^T) on rows j of block rb, half ch of the
    //     columns d; vp = this half of x_j.(dh B_j)
    {
      float acc[kND][4] = {}, bdh[kND][4] = {};
      const int dcol = ch * HD / 2;
#pragma unroll
      for (int ki = 0; ki < kTile / 16; ++ki) {
        if (ki < rb) continue;
        uint32_t ah[4], al[4];
        frag_a_t(ah, gh, L::kMS, 16 * rb, 16 * ki);
        frag_a_t(al, gl, L::kMS, 16 * rb, 16 * ki);
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          uint32_t bh2[2], bl2[2];
          frag_b_t(bh2, dyh, L::kXS, 16 * ki, dcol + 8 * nd);
          frag_b_t(bl2, dyl, L::kXS, 16 * ki, dcol + 8 * nd);
          mma_split(acc[nd], ah, al, bh2[0], bh2[1]);
          mma_bf16(acc[nd], ah, bl2[0], bl2[1]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < DS / 16; ++ks) {
        uint32_t af[4];
        frag_a(af, b_s, L::kBS, 16 * rb, 16 * ks);
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          uint32_t bh2[2], bl2[2];
          frag_b(bh2, dhh, L::kBS, dcol + 8 * nd, 16 * ks);
          frag_b(bl2, dhl, L::kBS, dcol + 8 * nd, 16 * ks);
          mma_bf16(bdh[nd], af, bh2[0], bh2[1]);
          mma_bf16(bdh[nd], af, bl2[0], bl2[1]);
        }
      }
      __nv_bfloat16* dxb = dx + row0 * x_step + static_cast<int64_t>(head) * HD;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 16 * rb + g4 + 8 * hf;
        const float wj = w_s[j];
        float xv = 0.f;
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          const int d = dcol + 8 * nd + 2 * c4;
          const float2 xf = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(x_s + j * L::kXS + d));
          xv = fmaf(xf.x, bdh[nd][2 * hf], xv);
          xv = fmaf(xf.y, bdh[nd][2 * hf + 1], xv);
          if (j < n)
            *reinterpret_cast<uint32_t*>(dxb + j * x_step + d) = pack_bf16(
                fmaf(wj, bdh[nd][2 * hf], acc[nd][2 * hf]),
                fmaf(wj, bdh[nd][2 * hf + 1], acc[nd][2 * hf + 1]));
        }
        xv += __shfl_xor_sync(0xffffffffu, xv, 1);
        xv += __shfl_xor_sync(0xffffffffu, xv, 2);
        if (c4 == 0) vp_s[ch * kTile + j] = xv;
      }
    }
    // 5b. dC += E B + exp(cum) o (dy h_in) on rows i of block rb, half ch
    //     of the columns s; rp = this half of dy_i.(h_in C_i)
    const int scol = ch * DS / 2;
    {
      float dyh_acc[kNC][4] = {};
#pragma unroll
      for (int kj = 0; kj < kTile / 16; ++kj) {
        if (kj > rb) break;
        uint32_t ah[4], al[4];
        frag_a(ah, eh, L::kMS, 16 * rb, 16 * kj);
        frag_a(al, el, L::kMS, 16 * rb, 16 * kj);
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          uint32_t bf[2];
          frag_b_t(bf, b_s, L::kBS, 16 * kj, scol + 8 * nc);
          mma_split(dca[nc], ah, al, bf[0], bf[1]);
        }
      }
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        uint32_t ah[4], al[4];
        frag_a(ah, dyh, L::kXS, 16 * rb, 16 * kd);
        frag_a(al, dyl, L::kXS, 16 * rb, 16 * kd);
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          uint32_t bh2[2], bl2[2];
          frag_b_t(bh2, hinh, L::kBS, 16 * kd, scol + 8 * nc);
          frag_b_t(bl2, hinl, L::kBS, 16 * kd, scol + 8 * nc);
          mma_split(dyh_acc[nc], ah, al, bh2[0], bh2[1]);
          mma_bf16(dyh_acc[nc], ah, bl2[0], bl2[1]);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * rb + g4 + 8 * hf;
        const float ei = ecum_s[i];
        float cv = 0.f;
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          const int s = scol + 8 * nc + 2 * c4;
          const float2 cf = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(c_s + i * L::kBS + s));
          cv = fmaf(dyh_acc[nc][2 * hf], cf.x, cv);
          cv = fmaf(dyh_acc[nc][2 * hf + 1], cf.y, cv);
          dca[nc][2 * hf] = fmaf(ei, dyh_acc[nc][2 * hf], dca[nc][2 * hf]);
          dca[nc][2 * hf + 1] =
              fmaf(ei, dyh_acc[nc][2 * hf + 1], dca[nc][2 * hf + 1]);
        }
        cv += __shfl_xor_sync(0xffffffffu, cv, 1);
        cv += __shfl_xor_sync(0xffffffffu, cv, 2);
        if (c4 == 0) rp_s[ch * kTile + i] = cv;
      }
    }
    // 5c. dB += E^T C + w o (x dh) on rows j of block rb, half ch of s
    {
      float xdh[kNC][4] = {};
#pragma unroll
      for (int ki = 0; ki < kTile / 16; ++ki) {
        if (ki < rb) continue;
        uint32_t ah[4], al[4];
        frag_a_t(ah, eh, L::kMS, 16 * rb, 16 * ki);
        frag_a_t(al, el, L::kMS, 16 * rb, 16 * ki);
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          uint32_t bf[2];
          frag_b_t(bf, c_s, L::kBS, 16 * ki, scol + 8 * nc);
          mma_split(dba[nc], ah, al, bf[0], bf[1]);
        }
      }
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        uint32_t af[4];
        frag_a(af, x_s, L::kXS, 16 * rb, 16 * kd);
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          uint32_t bh2[2], bl2[2];
          frag_b_t(bh2, dhh, L::kBS, 16 * kd, scol + 8 * nc);
          frag_b_t(bl2, dhl, L::kBS, 16 * kd, scol + 8 * nc);
          mma_bf16(xdh[nc], af, bh2[0], bh2[1]);
          mma_bf16(xdh[nc], af, bl2[0], bl2[1]);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float wj = w_s[16 * rb + g4 + 8 * hf];
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          dba[nc][2 * hf] = fmaf(wj, xdh[nc][2 * hf], dba[nc][2 * hf]);
          dba[nc][2 * hf + 1] =
              fmaf(wj, xdh[nc][2 * hf + 1], dba[nc][2 * hf + 1]);
        }
      }
    }
    __syncthreads();

    // 6. v, r, then da, ddt and dt da for steps m of the tile
    if (tid < kTile) {
      v_s[tid] = edec_s[tid] * (vp_s[tid] + vp_s[kTile + tid]);
      r_s[tid] = ecum_s[tid] * (rp_s[tid] + rp_s[kTile + tid]);
    }
    __syncthreads();
    if (tid < kTile) {
      const int m = tid;
      float dh_hin = 0.f;
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) dh_hin += red_s[w];
      float pairs = 0.f, rsum = 0.f, usum = 0.f;
      for (int i = m; i < kTile; ++i) {
        pairs += k_s[i * kPT + m];
        rsum += r_s[i];
      }
      for (int j = 0; j < m; ++j) usum = fmaf(dt_s[j], v_s[j], usum);
      const float da = ((pairs + rsum) + usum) + expf(total) * dh_hin;
      if (m < n)
        ddt[(row0 + m) * nh + head] = fmaf(A, da, colk_s[m] + v_s[m]);
      dtda_s[m] = dt_s[m] * da;
    }
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int m = 0; m < kTile; ++m) sum += dtda_s[m];
      da_part[(static_cast<int64_t>(b) * tiles + t) * nh + head] = sum;
    }
  }

  // dB and dC of the block's heads, one partial per (row, head block)
  const int parts = nh / hpb;
  const int scol = ch * DS / 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * rb + g4 + 8 * hf;
    if (r >= n) continue;
    const int64_t base = ((row0 + r) * parts + hb) * DS + scol + 2 * c4;
#pragma unroll
    for (int nc = 0; nc < kNC; ++nc) {
      *reinterpret_cast<float2*>(db_part + base + 8 * nc) =
          make_float2(dba[nc][2 * hf], dba[nc][2 * hf + 1]);
      *reinterpret_cast<float2*>(dc_part + base + 8 * nc) =
          make_float2(dca[nc][2 * hf], dca[nc][2 * hf + 1]);
    }
  }
}

// ------------------------------------------------------------- float32

// Shared memory of the float32 state kernel, in bytes: two stages, each
// holding walk 1's x and B or walk 2's dy and C as float32 (rows padded
// to 8 mod 32 floats: the fragment loads meet 32 distinct banks), then
// dt; then each warp's own cum and scale.  A block keeps kCols columns
// of the state (64 of mamba2's 128: two blocks a (head, b), each with
// half the registers, three blocks an SM).
template <int HD, int DS>
struct F32State {
  static constexpr int kWarps = HD / 16;         // one per 16 rows of h
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = DS < 64 ? DS : 64;  // state columns a block
  static constexpr int kXS = HD + 8;             // floats per x / dy row
  static constexpr int kBS = kCols + 8;          // of a B / C row
  static constexpr int kN = 4 * kTile * kXS;     // B or C in a stage
  static constexpr int kDt = kN + 4 * kTile * kBS;
  static constexpr int kStage = kDt + 4 * kTile;
  static constexpr int kScan = 2 * kStage;
  static constexpr int kBytes = kScan + kWarps * 2 * 4 * kTile;
  static_assert(kN % 16 == 0 && kDt % 16 == 0 && kStage % 16 == 0,
                "16-byte aligned rows for cp.async");
};

// Stage rows [t0, t0 + n) of a tile as float32 (rows past n
// zero-filled, dt = 0 making them identity steps): x and B (walk 1) or
// dy and C (walk 2).
template <int HD, int DS>
__device__ __forceinline__ void state_tile_f32(
    unsigned char* stage, const float* mb, const float* nb, const float* dtb,
    int64_t x_step, int nh, int64_t bc_ss, int t0, int n) {
  using L = F32State<HD, DS>;
  float* ms = reinterpret_cast<float*>(stage);
  float* ns = reinterpret_cast<float*>(stage + L::kN);
  constexpr int kMChunks = HD / 4;               // 16-byte chunks a row
  constexpr int kNChunks = L::kCols / 4;
  for (int c = threadIdx.x; c < kTile * kMChunks; c += L::kThreads) {
    const int r = c / kMChunks;
    const int ch = c % kMChunks;
    const bool ok = r < n;
    cp_async16(ms + r * L::kXS + ch * 4,
               mb + (t0 + (ok ? r : 0)) * x_step + ch * 4, ok);
  }
  for (int c = threadIdx.x; c < kTile * kNChunks; c += L::kThreads) {
    const int r = c / kNChunks;
    const int ch = c % kNChunks;
    const bool ok = r < n;
    cp_async16(ns + r * L::kBS + ch * 4,
               nb + (t0 + (ok ? r : 0)) * bc_ss + ch * 4, ok);
  }
  float* dts = reinterpret_cast<float*>(stage + L::kDt);
  for (int r = threadIdx.x; r < kTile; r += L::kThreads)
    cp_async4(dts + r, dtb + static_cast<int64_t>(t0 + (r < n ? r : 0)) * nh,
              r < n);
}

// h <- h decay + (scale o m)^T n over the tile's first n steps: A (rows
// d of this warp, k = steps) formed once from the staged m rows, then
// each 8-column tile of the block's columns of h summed in zeroed
// fragments and added in round-to-nearest
template <int HD, int DS>
__device__ __forceinline__ void state_update_f32(
    float (&h)[F32State<HD, DS>::kCols / 8][4],
                                                 const float* ms,
                                                 const float* ns,
                                                 const float* scale,
                                                 float decay, int n,
                                                 int d0) {
  using L = F32State<HD, DS>;
  constexpr int kKT = kTile / 8;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int c4 = lane % 4;
  uint32_t ab[kKT][4], as[kKT][4];
#pragma unroll
  for (int kj = 0; kj < kKT; ++kj) {
    if (8 * kj >= n) break;
    const int j = 8 * kj + c4;
    const float s0 = scale[j], s1 = scale[j + 4];
    const float* m0 = ms + j * L::kXS + d0 + g4;
    const float* m1 = m0 + 4 * L::kXS;
    split_tf32(s0 * m0[0], ab[kj][0], as[kj][0]);
    split_tf32(s0 * m0[8], ab[kj][1], as[kj][1]);
    split_tf32(s1 * m1[0], ab[kj][2], as[kj][2]);
    split_tf32(s1 * m1[8], ab[kj][3], as[kj][3]);
  }
#pragma unroll
  for (int sn = 0; sn < L::kCols / 8; ++sn) {
    float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kj = 0; kj < kKT; ++kj) {
      if (8 * kj >= n) break;
      uint32_t bb[2], bs[2];
      frag_b_kn_tf32(bb, bs, ns, L::kBS, 8 * kj, 8 * sn);
      mma_3xtf32_apart(lo, hi, ab[kj], as[kj], bb, bs);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[sn][e] = fmaf(h[sn][e], decay, hi[e] + lo[e]);
  }
}

// h_in and dh of every tile, as the bf16 state kernel writes them, one
// block per (head, b, column block of kCols), each walk's product in
// 3xTF32 on the tensor cores:
//   walk 1: h_in[t] = h, then h <- h exp(total) + (w o x)^T B
//   walk 2 (t from the last): dh[t] = dh, then
//           dh <- dh exp(total) + (exp(cum) o dy)^T C
template <int HD, int DS>
__global__ void __launch_bounds__(2 * HD, 3)
ssd_bwd_state_kernel_f32(const float* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ a,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ dh_end,
                         float* __restrict__ states,
                         float* __restrict__ dstates, int S, int nh, int g,
                         int64_t bc_sb, int64_t bc_ss) {
  using L = F32State<HD, DS>;
  constexpr int kSN = L::kCols / 8;              // 8-column tiles of h
  extern __shared__ __align__(16) unsigned char sbuf[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int c4 = lane % 4;
  const int d0 = 16 * warp;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * L::kCols;          // the block's columns
  const int grp = head / (nh / g);
  const float A = a[head];
  const int tiles = (S + kTile - 1) / kTile;
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const float* xb = x + row0 * x_step + static_cast<int64_t>(head) * HD;
  const float* dyb = dy + row0 * x_step + static_cast<int64_t>(head) * HD;
  const float* dtb = dt + row0 * nh + head;
  const float* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS + s0;
  const float* cb = cm + b * bc_sb + static_cast<int64_t>(grp) * DS + s0;
  const int64_t bh = static_cast<int64_t>(b) * nh + head;
  float* cum = reinterpret_cast<float*>(sbuf + L::kScan) + warp * 2 * kTile;
  float* scl = cum + kTile;

  float h[kSN][4];
  auto put = [&](float* dst) {
#pragma unroll
    for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(dst + (d0 + g4 + 8 * hf) * DS + s0 +
                                   8 * sn + 2 * c4) =
            make_float2(h[sn][2 * hf], h[sn][2 * hf + 1]);
  };

  // walk 1: the state entering each tile, from h = 0
#pragma unroll
  for (int sn = 0; sn < kSN; ++sn)
    h[sn][0] = h[sn][1] = h[sn][2] = h[sn][3] = 0.f;
  if (tiles > 1)
    state_tile_f32<HD, DS>(sbuf, xb, bb, dtb, x_step, nh, bc_ss, 0,
                           min(kTile, S));
  cp_async_commit();
  for (int t = 0; t + 1 < tiles; ++t) {
    put(states + (bh * tiles + t) * HD * DS);
    cp_async_wait_all();
    __syncthreads();
    if (t + 2 < tiles)
      state_tile_f32<HD, DS>(sbuf + ((t + 1) & 1) * L::kStage, xb, bb, dtb,
                             x_step, nh, bc_ss, (t + 1) * kTile,
                             min(kTile, S - (t + 1) * kTile));
    cp_async_commit();
    const unsigned char* stage = sbuf + (t & 1) * L::kStage;
    const float* dts = reinterpret_cast<const float*>(stage + L::kDt);
    const float total = warp_cum(dts, A, cum, lane);
    scl[2 * lane] = expf(total - cum[2 * lane]) * dts[2 * lane];
    scl[2 * lane + 1] = expf(total - cum[2 * lane + 1]) * dts[2 * lane + 1];
    __syncwarp();
    state_update_f32<HD, DS>(
        h, reinterpret_cast<const float*>(stage),
        reinterpret_cast<const float*>(stage + L::kN), scl, expf(total),
        kTile, d0);
  }
  put(states + (bh * tiles + tiles - 1) * HD * DS);
  __syncthreads();

  // walk 2: the gradient of the state leaving each tile, from dh_S
#pragma unroll
  for (int sn = 0; sn < kSN; ++sn)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2 v = make_float2(0.f, 0.f);
      if (dh_end != nullptr)
        v = *reinterpret_cast<const float2*>(
            dh_end + bh * HD * DS + (d0 + g4 + 8 * hf) * DS + s0 + 8 * sn +
            2 * c4);
      h[sn][2 * hf] = v.x;
      h[sn][2 * hf + 1] = v.y;
    }
  if (tiles > 1) {
    const int tl = (tiles - 1) * kTile;
    state_tile_f32<HD, DS>(sbuf, dyb, cb, dtb, x_step, nh, bc_ss, tl,
                           S - tl);
  }
  cp_async_commit();
  for (int it = 0; it + 1 < tiles; ++it) {
    const int t = tiles - 1 - it;
    put(dstates + (bh * tiles + t) * HD * DS);
    cp_async_wait_all();
    __syncthreads();
    if (t - 1 > 0)
      state_tile_f32<HD, DS>(sbuf + ((it + 1) & 1) * L::kStage, dyb, cb, dtb,
                             x_step, nh, bc_ss, (t - 1) * kTile, kTile);
    cp_async_commit();
    const unsigned char* stage = sbuf + (it & 1) * L::kStage;
    const float* dts = reinterpret_cast<const float*>(stage + L::kDt);
    const float total = warp_cum(dts, A, cum, lane);
    scl[2 * lane] = expf(cum[2 * lane]);
    scl[2 * lane + 1] = expf(cum[2 * lane + 1]);
    __syncwarp();
    state_update_f32<HD, DS>(
        h, reinterpret_cast<const float*>(stage),
        reinterpret_cast<const float*>(stage + L::kN), scl, expf(total),
        min(kTile, S - t * kTile), d0);
  }
  put(dstates + bh * tiles * HD * DS);
}

// Shared memory of the float32 tile kernel, in bytes: B, C, h_in and dh
// rows padded to 8 mod 32 floats, x and dy to 8 mod 32, G and E (the
// L dt-weighted tile matrices) to 4 mod 32, K, 13 step vectors and the
// warps' dots.  (64, 128): 230,976 bytes, one block an SM.
template <int HD, int DS>
struct F32Tile {
  static constexpr int kXS = HD + 8;             // x, dy rows
  static constexpr int kBS = DS + 8;             // B, C, h_in, dh rows
  static constexpr int kMS = kTile + 4;          // G, E rows
  static constexpr int kB = 0;
  static constexpr int kC = kB + 4 * kTile * kBS;
  static constexpr int kX = kC + 4 * kTile * kBS;
  static constexpr int kDy = kX + 4 * kTile * kXS;
  static constexpr int kHin = kDy + 4 * kTile * kXS;
  static constexpr int kDh = kHin + 4 * HD * kBS;
  static constexpr int kG = kDh + 4 * HD * kBS;
  static constexpr int kE = kG + 4 * kTile * kMS;
  static constexpr int kK = kE + 4 * kTile * kMS;
  static constexpr int kVec = kK + 4 * kTile * kPT;
  static constexpr int kVecs = 13;               // 64-float vectors
  static constexpr int kRed = kVec + 4 * kVecs * kTile;
  static constexpr int kBytes = kRed + 4 * 16;
  static_assert(kC % 16 == 0 && kX % 16 == 0 && kDy % 16 == 0 &&
                    kHin % 16 == 0 && kDh % 16 == 0 && kG % 16 == 0 &&
                    kE % 16 == 0 && kK % 16 == 0 && kVec % 16 == 0,
                "16-byte aligned regions");
  static_assert(kBytes <= 232448, "one block's shared memory on an SM");
};

// One block per (head block, tile, b), as ssd_bwd_tile_kernel_bf16, its
// products in 3xTF32: S = C B^T and P = dy x^T per head in registers
// (S is not kept: its 17 KB would not fit beside float32 operands), G
// and E in float32, dB and dC of each head summed in fragments that
// start from the head's own state terms, then added to the block's
// running sums in round-to-nearest.
template <int HD, int DS>
__global__ void __launch_bounds__(kTileThreads, 1)
ssd_bwd_tile_kernel_f32(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm,
                        const float* __restrict__ dy,
                        const float* __restrict__ states,
                        const float* __restrict__ dstates,
                        float* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ db_part,
                        float* __restrict__ dc_part,
                        float* __restrict__ da_part, int S, int nh, int g,
                        int hpb, int64_t bc_sb, int64_t bc_ss) {
  using L = F32Tile<HD, DS>;
  constexpr int kND = HD / 16;                   // n-tiles of a dx half
  constexpr int kNC = DS / 16;                   // of a dB / dC half
  extern __shared__ __align__(16) unsigned char sbuf[];
  float* b_s = reinterpret_cast<float*>(sbuf + L::kB);
  float* c_s = reinterpret_cast<float*>(sbuf + L::kC);
  float* x_s = reinterpret_cast<float*>(sbuf + L::kX);
  float* dy_s = reinterpret_cast<float*>(sbuf + L::kDy);
  float* hin_s = reinterpret_cast<float*>(sbuf + L::kHin);
  float* dh_s = reinterpret_cast<float*>(sbuf + L::kDh);
  float* g_s = reinterpret_cast<float*>(sbuf + L::kG);   // S L dt
  float* e_s = reinterpret_cast<float*>(sbuf + L::kE);   // P L dt
  float* k_s = reinterpret_cast<float*>(sbuf + L::kK);   // S L P, then Q
  float* dt_s = reinterpret_cast<float*>(sbuf + L::kVec);
  float* cum_s = dt_s + kTile;
  float* ecum_s = cum_s + kTile;         // exp(cum_i)
  float* edec_s = ecum_s + kTile;        // exp(total - cum_j)
  float* w_s = edec_s + kTile;           // exp(total - cum_j) dt_j
  float* v_s = w_s + kTile;              // exp(total - cum_j) x_j.(dh B_j)
  float* r_s = v_s + kTile;              // exp(cum_i) dy_i.(h_in C_i)
  float* colk_s = r_s + kTile;           // sum_i (S L P)_ij
  float* dtda_s = colk_s + kTile;        // dt_m da_m
  float* vp_s = dtda_s + kTile;          // two halves of x_j.(dh B_j)
  float* rp_s = vp_s + 2 * kTile;        // two halves of dy_i.(h_in C_i)
  float* red_s = reinterpret_cast<float*>(sbuf + L::kRed);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g4 = lane / 4;
  const int c4 = lane % 4;
  const int hb = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = gridDim.y;
  const int t0 = t * kTile;
  const int n = min(kTile, S - t0);
  const int grp = hb * hpb / (nh / g);
  // products: warp (rb, ch) takes rows [16 rb, 16 rb + 16) of its
  // outputs and column half ch; the tile matrices: row block wb = warp /
  // 2, column blocks 2 (warp % 2) and 2 (warp % 2) + 1 up to wb
  const int rb = warp & 3;
  const int ch = warp >> 2;
  const int wb = warp >> 1;
  const int wc = warp & 1;
  const int scol = ch * DS / 2;
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const int64_t row0 = static_cast<int64_t>(b) * S + t0;  // (b, t0) row

  // B and C of the tile (waited for with the first head's rows)
  {
    const float* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS;
    const float* cb = cm + b * bc_sb + static_cast<int64_t>(grp) * DS;
    constexpr int kChunks = DS / 4;
    for (int c = tid; c < kTile * kChunks; c += kTileThreads) {
      const int r = c / kChunks;
      const int cc = c % kChunks;
      const bool ok = r < n;
      const int64_t off = (t0 + (ok ? r : 0)) * bc_ss + cc * 4;
      cp_async16(b_s + r * L::kBS + cc * 4, bb + off, ok);
      cp_async16(c_s + r * L::kBS + cc * 4, cb + off, ok);
    }
    cp_async_commit();
  }
  float dba[kNC][4], dca[kNC][4];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dba[c][e] = dca[c][e] = 0.f;

  for (int hh = 0; hh < hpb; ++hh) {
    const int head = hb * hpb + hh;
    const float A = a[head];
    const int64_t bh = static_cast<int64_t>(b) * nh + head;
    // 1. stage x, dy, h_in and dh (cp.async) and dt; then <dh, h_in>
    {
      const int64_t col = static_cast<int64_t>(head) * HD;
      constexpr int kChunks = HD / 4;
      for (int c = tid; c < kTile * kChunks; c += kTileThreads) {
        const int r = c / kChunks;
        const int cc = c % kChunks;
        const bool ok = r < n;
        const int64_t off = (row0 + (ok ? r : 0)) * x_step + col + cc * 4;
        cp_async16(x_s + r * L::kXS + cc * 4, x + off, ok);
        cp_async16(dy_s + r * L::kXS + cc * 4, dy + off, ok);
      }
      const float* hin = states + (bh * tiles + t) * HD * DS;
      const float* dhv = dstates + (bh * tiles + t) * HD * DS;
      constexpr int kHChunks = DS / 4;
      for (int c = tid; c < HD * kHChunks; c += kTileThreads) {
        const int r = c / kHChunks;
        const int cc = c % kHChunks;
        cp_async16(hin_s + r * L::kBS + cc * 4, hin + r * DS + cc * 4, true);
        cp_async16(dh_s + r * L::kBS + cc * 4, dhv + r * DS + cc * 4, true);
      }
      cp_async_commit();
      if (tid < kTile)
        dt_s[tid] = tid < n ? dt[(row0 + tid) * nh + head] : 0.f;
      cp_async_wait_all();
      __syncthreads();
      float p = 0.f;
      for (int e = tid; e < HD * DS; e += kTileThreads) {
        const int o = (e / DS) * L::kBS + e % DS;
        p = fmaf(hin_s[o], dh_s[o], p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) red_s[warp] = p;
    }

    // 2. cum and its exponentials (steps past n add 0, so the last value
    //    is the tile's total)
    if (warp == 0) {
      tile_cum(dt_s, A, cum_s, lane);
      const float total = cum_s[kTile - 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 2 * lane + hf;
        ecum_s[i] = expf(cum_s[i]);
        edec_s[i] = expf(total - cum_s[i]);
        w_s[i] = edec_s[i] * dt_s[i];
      }
    }
    __syncthreads();
    const float total = cum_s[kTile - 1];

    // 3. S = C B^T and P = dy x^T on the lower block triangle, both with
    //    pair-relabelled k-steps; then G = S L dt, E = P L dt and K = S
    //    L P for j <= i (the mask before the exp), 0 above
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int jb = 2 * wc + q2;
      if (jb > wb) break;
      float sl[2][4] = {}, sh[2][4] = {}, pc[2][4] = {};
#pragma unroll 4
      for (int ks = 0; ks < DS / 8; ++ks) {
        uint32_t ab[4], as[4];
        frag_a_pairs_tf32(ab, as, c_s, L::kBS, 16 * wb, 8 * ks);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t bb[2], bs[2];
          frag_b_pairs_tf32(bb, bs, b_s, L::kBS, 16 * jb + 8 * q, 8 * ks);
          mma_3xtf32_apart(sl[q], sh[q], ab, as, bb, bs);
        }
      }
#pragma unroll 4
      for (int kd = 0; kd < HD / 8; ++kd) {
        uint32_t ab[4], as[4];
        frag_a_pairs_tf32(ab, as, dy_s, L::kXS, 16 * wb, 8 * kd);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t bb[2], bs[2];
          frag_b_pairs_tf32(bb, bs, x_s, L::kXS, 16 * jb + 8 * q, 8 * kd);
          mma_3xtf32(pc[q], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * wb + g4 + 8 * hf;
          const int j = 16 * jb + 8 * q + 2 * c4;
          float gv[2], ev[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float kv = 0.f;
            gv[e] = ev[e] = 0.f;
            if (j + e <= i) {
              const float l = expf(cum_s[i] - cum_s[j + e]);
              const float sv = (sh[q][2 * hf + e] + sl[q][2 * hf + e]) * l;
              const float pv = pc[q][2 * hf + e];
              gv[e] = sv * dt_s[j + e];
              ev[e] = pv * l * dt_s[j + e];
              kv = sv * pv;
            }
            k_s[i * kPT + j + e] = kv;
          }
          *reinterpret_cast<float2*>(g_s + i * L::kMS + j) =
              make_float2(gv[0], gv[1]);
          *reinterpret_cast<float2*>(e_s + i * L::kMS + j) =
              make_float2(ev[0], ev[1]);
        }
    }
    __syncthreads();

    // 4. the column sums of K, then each row of Q = K dt turned into its
    //    exclusive prefix sums in place (threads 0..63, which then pass
    //    no barrier until step 6); meanwhile every warp's products
    if (tid < kTile) {
      float sum = 0.f;
      for (int i = tid; i < kTile; ++i) sum += k_s[i * kPT + tid];
      colk_s[tid] = sum;
    }
    __syncthreads();
    if (tid < kTile) {
      float run = 0.f;
      for (int m = 0; m <= tid; ++m) {
        const float qv = k_s[tid * kPT + m] * dt_s[m];
        k_s[tid * kPT + m] = run;
        run += qv;
      }
    }
    // 5a. dx = G^T dy + w o (B dh^T) on rows j of block rb, half ch of the
    //     columns d, each in a zeroed fragment; vp = this half of
    //     x_j.(dh B_j)
    {
      float acc[kND][4] = {}, bdh[kND][4] = {};
      const int dcol = ch * HD / 2;
#pragma unroll
      for (int ki = 0; ki < kTile / 8; ++ki) {
        if (ki < 2 * rb) continue;
        uint32_t ab[4], as[4];
        frag_a_km_tf32(ab, as, g_s, L::kMS, 16 * rb, 8 * ki);
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          uint32_t bb[2], bs[2];
          frag_b_kn_tf32(bb, bs, dy_s, L::kXS, 8 * ki, dcol + 8 * nd);
          mma_3xtf32(acc[nd], ab, as, bb, bs);
        }
      }
#pragma unroll 4
      for (int ks = 0; ks < DS / 8; ++ks) {
        uint32_t ab[4], as[4];
        frag_a_pairs_tf32(ab, as, b_s, L::kBS, 16 * rb, 8 * ks);
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          uint32_t bb[2], bs[2];
          frag_b_pairs_tf32(bb, bs, dh_s, L::kBS, dcol + 8 * nd, 8 * ks);
          mma_3xtf32(bdh[nd], ab, as, bb, bs);
        }
      }
      float* dxb = dx + row0 * x_step + static_cast<int64_t>(head) * HD;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 16 * rb + g4 + 8 * hf;
        const float wj = w_s[j];
        float xv = 0.f;
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          const int d = dcol + 8 * nd + 2 * c4;
          const float2 xf =
              *reinterpret_cast<const float2*>(x_s + j * L::kXS + d);
          xv = fmaf(xf.x, bdh[nd][2 * hf], xv);
          xv = fmaf(xf.y, bdh[nd][2 * hf + 1], xv);
          if (j < n)
            *reinterpret_cast<float2*>(dxb + j * x_step + d) = make_float2(
                fmaf(wj, bdh[nd][2 * hf], acc[nd][2 * hf]),
                fmaf(wj, bdh[nd][2 * hf + 1], acc[nd][2 * hf + 1]));
        }
        xv += __shfl_xor_sync(0xffffffffu, xv, 1);
        xv += __shfl_xor_sync(0xffffffffu, xv, 2);
        if (c4 == 0) vp_s[ch * kTile + j] = xv;
      }
    }
    // 5b. dC += exp(cum) o (dy h_in) + E B on rows i of block rb, half ch
    //     of the columns s: dy h_in in a zeroed fragment, scaled, then E B
    //     on top; rp = this half of dy_i.(h_in C_i)
    {
      float t[kNC][4] = {};
#pragma unroll 4
      for (int kd = 0; kd < HD / 8; ++kd) {
        uint32_t ab[4], as[4];
        frag_a_tf32(ab, as, dy_s, L::kXS, 16 * rb, 8 * kd);
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          uint32_t bb[2], bs[2];
          frag_b_kn_tf32(bb, bs, hin_s, L::kBS, 8 * kd, scol + 8 * nc);
          mma_3xtf32(t[nc], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * rb + g4 + 8 * hf;
        const float ei = ecum_s[i];
        float cv = 0.f;
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          const int s = scol + 8 * nc + 2 * c4;
          const float2 cf =
              *reinterpret_cast<const float2*>(c_s + i * L::kBS + s);
          cv = fmaf(t[nc][2 * hf], cf.x, cv);
          cv = fmaf(t[nc][2 * hf + 1], cf.y, cv);
          t[nc][2 * hf] *= ei;
          t[nc][2 * hf + 1] *= ei;
        }
        cv += __shfl_xor_sync(0xffffffffu, cv, 1);
        cv += __shfl_xor_sync(0xffffffffu, cv, 2);
        if (c4 == 0) rp_s[ch * kTile + i] = cv;
      }
#pragma unroll
      for (int kj = 0; kj < kTile / 8; ++kj) {
        if (kj > 2 * rb + 1) break;
        uint32_t ab[4], as[4];
        frag_a_tf32(ab, as, e_s, L::kMS, 16 * rb, 8 * kj);
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          uint32_t bb[2], bs[2];
          frag_b_kn_tf32(bb, bs, b_s, L::kBS, 8 * kj, scol + 8 * nc);
          mma_3xtf32(t[nc], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int nc = 0; nc < kNC; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) dca[nc][e] += t[nc][e];
    }
    // 5c. dB += w o (x dh) + E^T C on rows j of block rb, half ch of s,
    //     the same way
    {
      float t[kNC][4] = {};
#pragma unroll 4
      for (int kd = 0; kd < HD / 8; ++kd) {
        uint32_t ab[4], as[4];
        frag_a_tf32(ab, as, x_s, L::kXS, 16 * rb, 8 * kd);
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          uint32_t bb[2], bs[2];
          frag_b_kn_tf32(bb, bs, dh_s, L::kBS, 8 * kd, scol + 8 * nc);
          mma_3xtf32(t[nc], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float wj = w_s[16 * rb + g4 + 8 * hf];
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          t[nc][2 * hf] *= wj;
          t[nc][2 * hf + 1] *= wj;
        }
      }
#pragma unroll
      for (int ki = 0; ki < kTile / 8; ++ki) {
        if (ki < 2 * rb) continue;
        uint32_t ab[4], as[4];
        frag_a_km_tf32(ab, as, e_s, L::kMS, 16 * rb, 8 * ki);
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc) {
          uint32_t bb[2], bs[2];
          frag_b_kn_tf32(bb, bs, c_s, L::kBS, 8 * ki, scol + 8 * nc);
          mma_3xtf32(t[nc], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int nc = 0; nc < kNC; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) dba[nc][e] += t[nc][e];
    }
    __syncthreads();

    // 6. v, r, then da, ddt and dt da for steps m of the tile
    if (tid < kTile) {
      v_s[tid] = edec_s[tid] * (vp_s[tid] + vp_s[kTile + tid]);
      r_s[tid] = ecum_s[tid] * (rp_s[tid] + rp_s[kTile + tid]);
    }
    __syncthreads();
    if (tid < kTile) {
      const int m = tid;
      float dh_hin = 0.f;
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) dh_hin += red_s[w];
      float pairs = 0.f, rsum = 0.f, usum = 0.f;
      for (int i = m; i < kTile; ++i) {
        pairs += k_s[i * kPT + m];
        rsum += r_s[i];
      }
      for (int j = 0; j < m; ++j) usum = fmaf(dt_s[j], v_s[j], usum);
      const float da = ((pairs + rsum) + usum) + expf(total) * dh_hin;
      if (m < n)
        ddt[(row0 + m) * nh + head] = fmaf(A, da, colk_s[m] + v_s[m]);
      dtda_s[m] = dt_s[m] * da;
    }
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int m = 0; m < kTile; ++m) sum += dtda_s[m];
      da_part[(static_cast<int64_t>(b) * tiles + t) * nh + head] = sum;
    }
  }

  // dB and dC of the block's heads, one partial per (row, head block)
  const int parts = nh / hpb;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * rb + g4 + 8 * hf;
    if (r >= n) continue;
    const int64_t base = ((row0 + r) * parts + hb) * DS + scol + 2 * c4;
#pragma unroll
    for (int nc = 0; nc < kNC; ++nc) {
      *reinterpret_cast<float2*>(db_part + base + 8 * nc) =
          make_float2(dba[nc][2 * hf], dba[nc][2 * hf + 1]);
      *reinterpret_cast<float2*>(dc_part + base + 8 * nc) =
          make_float2(dca[nc][2 * hf], dca[nc][2 * hf + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch

template <int HD, int DS>
int launch_bf16(const void* x, const void* dt, const void* a, const void* bm,
                const void* cm, const void* dy, const void* dh_end, void* dx,
                void* ddt, void* da, void* db, void* dc, void* states,
                void* dstates, void* db_part, void* dc_part, void* da_part,
                int B, int S, int nh, int g, int hpb, int64_t bc_sb,
                int64_t bc_ss, cudaStream_t stream) {
  using Bf = __nv_bfloat16;
  const int tiles = (S + kTile - 1) / kTile;
  if (hpb < 1 || (nh / g) % hpb != 0 || tiles > 65535 ||
      dstates == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto state = ssd_bwd_state_kernel_bf16<HD, DS>;
  const auto tile = ssd_bwd_tile_kernel_bf16<HD, DS>;
  constexpr int state_bytes = Bf16State<HD, DS>::kBytes;
  constexpr int tile_bytes = Bf16Tile<HD, DS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      state, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  state<<<dim3(nh, B), Bf16State<HD, DS>::kThreads, state_bytes, stream>>>(
      static_cast<const Bf*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const Bf*>(bm),
      static_cast<const Bf*>(cm), static_cast<const float*>(dy),
      static_cast<const float*>(dh_end), static_cast<float*>(states),
      static_cast<float*>(dstates), S, nh, g, bc_sb, bc_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile<<<dim3(nh / hpb, tiles, B), kTileThreads, tile_bytes, stream>>>(
      static_cast<const Bf*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const Bf*>(bm),
      static_cast<const Bf*>(cm), static_cast<const float*>(dy),
      static_cast<const float*>(states), static_cast<const float*>(dstates),
      static_cast<Bf*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(da_part), S, nh, g, hpb, bc_sb, bc_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<Bf>(db_part, dc_part, da_part, db, dc, da,
                           static_cast<int64_t>(B) * S, B * tiles, nh,
                           nh / hpb, g, DS, stream);
}

template <int HD, int DS>
int launch_f32(const void* x, const void* dt, const void* a, const void* bm,
               const void* cm, const void* dy, const void* dh_end, void* dx,
               void* ddt, void* da, void* db, void* dc, void* states,
               void* dstates, void* db_part, void* dc_part, void* da_part,
               int B, int S, int nh, int g, int hpb, int64_t bc_sb,
               int64_t bc_ss, cudaStream_t stream) {
  const int tiles = (S + kTile - 1) / kTile;
  if (hpb < 1 || (nh / g) % hpb != 0 || tiles > 65535 ||
      dstates == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto state = ssd_bwd_state_kernel_f32<HD, DS>;
  const auto tile = ssd_bwd_tile_kernel_f32<HD, DS>;
  constexpr int state_bytes = F32State<HD, DS>::kBytes;
  constexpr int tile_bytes = F32Tile<HD, DS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      state, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  state<<<dim3(nh, B, DS / F32State<HD, DS>::kCols),
          F32State<HD, DS>::kThreads, state_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(dy),
      static_cast<const float*>(dh_end), static_cast<float*>(states),
      static_cast<float*>(dstates), S, nh, g, bc_sb, bc_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile<<<dim3(nh / hpb, tiles, B), kTileThreads, tile_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(dy),
      static_cast<const float*>(states), static_cast<const float*>(dstates),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(da_part), S, nh, g, hpb, bc_sb, bc_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<float>(db_part, dc_part, da_part, db, dc, da,
                              static_cast<int64_t>(B) * S, B * tiles, nh,
                              nh / hpb, g, DS, stream);
}

}  // namespace

// Launch the three kernels on `stream`.  dtype is x's, B's and C's type
// (0 float32, 1 bfloat16); dx, dB and dC are written in it, ddt (B, S,
// nh) and dA (nh,) in float32.  dy (B, S, nh, hd) is float32 and
// contiguous; dh_end (B, nh, hd, ds) float32 or null (zero).  B and C
// share the strides bc_sb (batch) and bc_ss (time step), in elements,
// with the group and state axes packed; dB and dC are contiguous; in
// float32 every row of x, dy, B and C starts 16-byte aligned.
// Workspaces, float32, with tiles = ceil(S / 64): states and dstates B
// nh tiles hd ds each, db_part and dc_part B S (nh / hpb) ds each,
// da_part B tiles nh, hpb heads a block (a divisor of nh / g).  Either
// dtype runs its state kernel, its tile kernel and ssd_reduce_kernel.
// (hd, ds) is (64, 128), (64, 16) or (32, 16).  Returns the first CUDA
// error of setting a shared-memory size or of a launch, 0 if none.
extern "C" int ssd_scan_backward_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* dy, const void* dh_end, void* dx, void* ddt,
    void* da, void* db, void* dc, void* states, void* dstates, void* db_part,
    void* dc_part, void* da_part, int B, int S, int nh, int g, int hd, int ds,
    int dtype, int hpb, long long bc_sb, long long bc_ss, void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || g <= 0 || nh % g != 0 || B > 65535 ||
      nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_BWD_WIDTHS(FN)                                                   \
  if (hd == 64 && ds == 128) /* mamba2-2.7b */                               \
    return FN<64, 128>(x, dt, a, bm, cm, dy, dh_end, dx, ddt, da, db, dc,    \
                       states, dstates, db_part, dc_part, da_part, B, S, nh, \
                       g, hpb, bc_sb, bc_ss, st);                            \
  if (hd == 64 && ds == 16) /* jamba-v0.1-52b's Mamba layers */              \
    return FN<64, 16>(x, dt, a, bm, cm, dy, dh_end, dx, ddt, da, db, dc,     \
                      states, dstates, db_part, dc_part, da_part, B, S, nh,  \
                      g, hpb, bc_sb, bc_ss, st);                             \
  if (hd == 32 && ds == 16) /* their reduced configs */                      \
    return FN<32, 16>(x, dt, a, bm, cm, dy, dh_end, dx, ddt, da, db, dc,     \
                      states, dstates, db_part, dc_part, da_part, B, S, nh,  \
                      g, hpb, bc_sb, bc_ss, st);
  if (dtype == 0) {
    SSD_BWD_WIDTHS(launch_f32)
  }
  if (dtype == 1) {
    SSD_BWD_WIDTHS(launch_bf16)
  }
#undef SSD_BWD_WIDTHS
  return static_cast<int>(cudaErrorInvalidValue);
}
