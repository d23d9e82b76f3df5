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
// Design: recompute, do not save.  Three kernels, float32 arithmetic on
// the CUDA cores for both input types (bf16 inputs are widened when
// staged, the outputs rounded once):
//   1. ssd_state_kernel: one block per (head, b) runs the forward's
//      state recurrence over the tiles and writes the state entering
//      each tile, h_in (B, nh, tiles, hd, ds) float32, to a workspace;
//   2. ssd_backward_kernel: one block per (head, b) walks the tiles from
//      the last to the first, carrying dh in shared memory from dh_S.
//      Per tile it stages x, dy, B, C, dt and h_in as float32, forms the
//      64 x 64 matrices S L dt, P L dt and S L P in shared memory, then
//      runs the products above as 16 x 16 thread grids with 2-D
//      register tiles (rows padded by one float: no bank conflicts in
//      either orientation).  It writes dx and ddt, and each head's own
//      dB, dC (B, S, nh, ds) and sum of dt da (B, nh) in float32;
//   3. ssd_reduce_kernel: dB and dC as the sums over a group's heads,
//      dA as the sum over the batch, each in head (or batch) order.
// Every output element is written by one thread after a loop of fixed
// order, with no atomics: two launches give the same bits.
//
// Shared memory of kernel 2 at mamba2-2.7b's (64, 128): x, dy (64 x 65),
// B, C (64 x 129), h_in and dh (64 x 129), three 64 x 65 matrices and
// nine 64-vectors: 217,632 bytes, one block an SM; 160 blocks at the
// training shape (B 2 x 80 heads) on 132 SMs.
//
// Bound.  The recurrence's backward takes four products a step and
// head (dh B, x^T dh, dy^T h, dy (x) C): 8 hd ds flops, 5.4 GFLOP at
// B 2 x 512 on mamba2 (0.080 ms at 67 TFLOP/s), above the bytes that
// must move (x, dt, B, C, dy in; dx, ddt, dB, dC out: ~0.013 ms at
// 3.35 TB/s).  The dual form here issues ~2x those flops for the tile
// matrices and the state pass, on the CUDA cores: right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                // time steps per tile
constexpr int kSide = 16;                // 16 x 16 thread grid
constexpr int kPT = kTile + 1;           // pitch of the tile matrices
static_assert(kSide * kSide == kThreads, "thread grid");
static_assert(kTile == 64, "the prefix sum gives each lane two steps");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[r][c] += sum_k a(ti + 16 r, k) b(k, tj + 16 c), k in order
template <int RM, int RN, int K, typename FA, typename FB>
__device__ __forceinline__ void product(float (&acc)[RM][RN], int ti, int tj,
                                        FA a, FB b) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) av[r] = a(ti + kSide * r, k);
#pragma unroll
    for (int c = 0; c < RN; ++c) bv[c] = b(k, tj + kSide * c);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
}

// the sum over the 16 lanes of a half-warp (the threads of one row of
// the thread grid), in a fixed tree
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// ------------------------------------------------------------ state pass

template <int HD, int DS>
struct StateSmem {
  static constexpr int kPitch = DS + 1;
  static constexpr int kX = 0;                          // kTile x HD
  static constexpr int kB = kX + kTile * HD;            // kTile x kPitch
  static constexpr int kDt = kB + kTile * kPitch;
  static constexpr int kCum = kDt + kTile;
  static constexpr int kW = kCum + kTile;
  static constexpr int kFloats = kW + kTile;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// h_in[t] = the state entering tile t, from h = 0:
//   h <- h exp(total) + sum_j w_j x_j (x) B_j
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 float* __restrict__ states, int S, int nh, int g,
                 int64_t bc_sb, int64_t bc_ss) {
  using L = StateSmem<HD, DS>;
  constexpr int P = L::kPitch;
  constexpr int kHCols = DS < 32 ? DS : 32;
  constexpr int kHStep = kThreads / kHCols;
  constexpr int kRD = HD / kHStep;
  constexpr int kRS = DS / kHCols;
  static_assert(HD % kHStep == 0 && DS % kHCols == 0, "state tile split");

  extern __shared__ float smem[];
  float* x_s = smem + L::kX;
  float* b_s = smem + L::kB;
  float* dt_s = smem + L::kDt;
  float* cum_s = smem + L::kCum;
  float* w_s = smem + L::kW;

  const int tid = threadIdx.x;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = head / (nh / g);
  const float A = a[head];
  const int tiles = (S + kTile - 1) / kTile;
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const T* xb = x + static_cast<int64_t>(b) * S * x_step +
                static_cast<int64_t>(head) * HD;
  const float* dtb = dt + static_cast<int64_t>(b) * S * nh + head;
  const T* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  float* out = states + (static_cast<int64_t>(b) * nh + head) * tiles * HD * DS;
  const int hr = tid / kHCols;
  const int hc = tid % kHCols;

  float h[kRD][kRS];
  zero(h);
  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * kTile;
    const int n = S - t0 < kTile ? S - t0 : kTile;
    float* ht = out + static_cast<int64_t>(t) * HD * DS;
#pragma unroll
    for (int r = 0; r < kRD; ++r)
#pragma unroll
      for (int k = 0; k < kRS; ++k)
        ht[(hr + kHStep * r) * DS + hc + kHCols * k] = h[r][k];
    if (t == tiles - 1) break;     // the last tile's own update is unused

    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int i = e / HD;
      x_s[e] = i < n ? to_f32(xb[(t0 + i) * x_step + e % HD]) : 0.f;
    }
    for (int e = tid; e < kTile * DS; e += kThreads) {
      const int i = e / DS;
      const int s = e % DS;
      b_s[i * P + s] = i < n ? to_f32(bb[(t0 + i) * bc_ss + s]) : 0.f;
    }
    if (tid < kTile)
      dt_s[tid] = tid < n ? dtb[static_cast<int64_t>(t0 + tid) * nh] : 0.f;
    __syncthreads();
    if (tid < 32) {
      tile_cum(dt_s, A, cum_s, tid);
      const float total = cum_s[kTile - 1];
      w_s[2 * tid] = expf(total - cum_s[2 * tid]) * dt_s[2 * tid];
      w_s[2 * tid + 1] = expf(total - cum_s[2 * tid + 1]) * dt_s[2 * tid + 1];
    }
    __syncthreads();
    const float decay = expf(cum_s[kTile - 1]);
    float acc[kRD][kRS];
    zero(acc);
    for (int j = 0; j < n; ++j) {
      const float w = w_s[j];
      float xv[kRD], bv[kRS];
#pragma unroll
      for (int r = 0; r < kRD; ++r) xv[r] = w * x_s[j * HD + hr + kHStep * r];
#pragma unroll
      for (int k = 0; k < kRS; ++k) bv[k] = b_s[j * P + hc + kHCols * k];
#pragma unroll
      for (int r = 0; r < kRD; ++r)
#pragma unroll
        for (int k = 0; k < kRS; ++k) acc[r][k] = fmaf(xv[r], bv[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < kRD; ++r)
#pragma unroll
      for (int k = 0; k < kRS; ++k) h[r][k] = h[r][k] * decay + acc[r][k];
    __syncthreads();
  }
}

// --------------------------------------------------------- reverse pass

template <int HD, int DS>
struct BwdSmem {
  static constexpr int kPH = HD + 1;
  static constexpr int kPS = DS + 1;
  static constexpr int kX = 0;                          // kTile x kPH
  static constexpr int kDy = kX + kTile * kPH;          // kTile x kPH
  static constexpr int kB = kDy + kTile * kPH;          // kTile x kPS
  static constexpr int kC = kB + kTile * kPS;           // kTile x kPS
  static constexpr int kHin = kC + kTile * kPS;         // HD x kPS
  static constexpr int kDh = kHin + HD * kPS;           // HD x kPS
  static constexpr int kG = kDh + HD * kPS;             // kTile x kPT
  static constexpr int kE = kG + kTile * kPT;           // kTile x kPT
  static constexpr int kK = kE + kTile * kPT;           // kTile x kPT
  static constexpr int kVec = kK + kTile * kPT;         // 9 x kTile
  static constexpr int kRed = kVec + 9 * kTile;         // 8 warps
  static constexpr int kFloats = kRed + kThreads / 32;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_backward_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dy,
                    const float* __restrict__ dh_end,
                    const float* __restrict__ states, T* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ db_part,
                    float* __restrict__ dc_part, float* __restrict__ da_part,
                    int S, int nh, int g, int64_t bc_sb, int64_t bc_ss) {
  using L = BwdSmem<HD, DS>;
  constexpr int PH = L::kPH;
  constexpr int PS = L::kPS;
  constexpr int RT = kTile / kSide;      // rows / cols of a tile index
  constexpr int RH = HD / kSide;
  constexpr int RS = DS / kSide;
  static_assert(HD % kSide == 0 && DS % kSide == 0, "thread grid split");

  extern __shared__ float smem[];
  float* x_s = smem + L::kX;
  float* dy_s = smem + L::kDy;
  float* b_s = smem + L::kB;
  float* c_s = smem + L::kC;
  float* hin_s = smem + L::kHin;
  float* dh_s = smem + L::kDh;
  float* g_s = smem + L::kG;             // S L dt
  float* e_s = smem + L::kE;             // P L dt
  float* k_s = smem + L::kK;             // S L P, then Q's row prefix sums
  float* dt_s = smem + L::kVec;
  float* cum_s = dt_s + kTile;
  float* ecum_s = cum_s + kTile;         // exp(cum_i)
  float* edec_s = ecum_s + kTile;        // exp(total - cum_j)
  float* w_s = edec_s + kTile;           // exp(total - cum_j) dt_j
  float* v_s = w_s + kTile;              // exp(total - cum_j) x_j.(dh B_j)
  float* r_s = v_s + kTile;              // exp(cum_i) dy_i.(h_in C_i)
  float* colk_s = r_s + kTile;           // sum_i (S L P)_ij
  float* dtda_s = colk_s + kTile;        // dt_m da_m
  float* red_s = smem + L::kRed;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ti = tid / kSide;
  const int tj = tid % kSide;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = head / (nh / g);
  const float A = a[head];
  const int tiles = (S + kTile - 1) / kTile;
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const int64_t row0 = static_cast<int64_t>(b) * S;   // (b, t) rows
  const T* xb = x + row0 * x_step + static_cast<int64_t>(head) * HD;
  const float* dyb = dy + row0 * x_step + static_cast<int64_t>(head) * HD;
  T* dxb = dx + row0 * x_step + static_cast<int64_t>(head) * HD;
  const float* dtb = dt + row0 * nh + head;
  float* ddtb = ddt + row0 * nh + head;
  const T* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  const T* cb = cm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  const int64_t part_step = static_cast<int64_t>(nh) * DS;
  float* dbp = db_part + row0 * part_step + static_cast<int64_t>(head) * DS;
  float* dcp = dc_part + row0 * part_step + static_cast<int64_t>(head) * DS;
  const int64_t bh = static_cast<int64_t>(b) * nh + head;
  const float* hb = states + bh * tiles * HD * DS;

  for (int e = tid; e < HD * DS; e += kThreads)
    dh_s[(e / DS) * PS + e % DS] =
        dh_end != nullptr ? dh_end[bh * HD * DS + e] : 0.f;
  float da_sum = 0.f;                    // thread 0: sum of dt da

  for (int t = tiles - 1; t >= 0; --t) {
    const int t0 = t * kTile;
    const int n = S - t0 < kTile ? S - t0 : kTile;

    // 1. stage the tile as float32, zero past the end, and h_in
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int i = e / HD;
      const int d = e % HD;
      const bool in = i < n;
      const int64_t off = (t0 + i) * x_step + d;
      x_s[i * PH + d] = in ? to_f32(xb[off]) : 0.f;
      dy_s[i * PH + d] = in ? dyb[off] : 0.f;
    }
    for (int e = tid; e < kTile * DS; e += kThreads) {
      const int i = e / DS;
      const int s = e % DS;
      float bv = 0.f, cv = 0.f;
      if (i < n) {
        const int64_t off = (t0 + i) * bc_ss + s;
        bv = to_f32(bb[off]);
        cv = to_f32(cb[off]);
      }
      b_s[i * PS + s] = bv;
      c_s[i * PS + s] = cv;
    }
    const float* ht = hb + static_cast<int64_t>(t) * HD * DS;
    for (int e = tid; e < HD * DS; e += kThreads)
      hin_s[(e / DS) * PS + e % DS] = ht[e];
    if (tid < kTile)
      dt_s[tid] = tid < n ? dtb[static_cast<int64_t>(t0 + tid) * nh] : 0.f;
    __syncthreads();

    // 2. cum and its exponentials; steps past n add 0, so the last
    //    value is the tile's total
    if (tid < 32) {
      tile_cum(dt_s, A, cum_s, tid);
      const float total = cum_s[kTile - 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 2 * tid + h;
        ecum_s[i] = expf(cum_s[i]);
        edec_s[i] = expf(total - cum_s[i]);
        w_s[i] = edec_s[i] * dt_s[i];
      }
    }
    __syncthreads();
    const float total = cum_s[kTile - 1];

    // 3. S = C B^T and P = dy x^T, then S L dt, P L dt and S L P for
    //    j <= i (the mask before the exp), 0 above
    {
      float sc[RT][RT], pc[RT][RT];
      zero(sc);
      zero(pc);
      product<RT, RT, DS>(sc, ti, tj,
                          [&](int i, int s) { return c_s[i * PS + s]; },
                          [&](int s, int j) { return b_s[j * PS + s]; });
      product<RT, RT, HD>(pc, ti, tj,
                          [&](int i, int d) { return dy_s[i * PH + d]; },
                          [&](int d, int j) { return x_s[j * PH + d]; });
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ti + kSide * r;
#pragma unroll
        for (int c = 0; c < RT; ++c) {
          const int j = tj + kSide * c;
          float gv = 0.f, ev = 0.f, kv = 0.f;
          if (j <= i) {
            const float l = expf(cum_s[i] - cum_s[j]);
            const float sl = sc[r][c] * l;
            gv = sl * dt_s[j];
            ev = pc[r][c] * l * dt_s[j];
            kv = sl * pc[r][c];
          }
          g_s[i * kPT + j] = gv;
          e_s[i * kPT + j] = ev;
          k_s[i * kPT + j] = kv;
        }
      }
    }
    __syncthreads();

    // 4. the column sums of S L P; then each row of Q = (S L P) dt turned
    //    into its exclusive prefix sums, in place
    if (tid < kTile) {
      float s = 0.f;
      for (int i = tid; i < kTile; ++i) s += k_s[i * kPT + tid];
      colk_s[tid] = s;
    }
    __syncthreads();
    if (tid < kTile) {
      float run = 0.f;
      for (int m = 0; m <= tid; ++m) {
        const float q = k_s[tid * kPT + m] * dt_s[m];
        k_s[tid * kPT + m] = run;
        run += q;
      }
    }

    // 5. dx = (S L dt)^T dy + w (B dh^T), and v_j = exp(total - cum_j)
    //    x_j.(dh B_j)
    {
      float acc[RT][RH], bdh[RT][RH];
      zero(acc);
      zero(bdh);
      product<RT, RH, kTile>(acc, ti, tj,
                             [&](int j, int i) { return g_s[i * kPT + j]; },
                             [&](int i, int d) { return dy_s[i * PH + d]; });
      product<RT, RH, DS>(bdh, ti, tj,
                          [&](int j, int s) { return b_s[j * PS + s]; },
                          [&](int s, int d) { return dh_s[d * PS + s]; });
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int j = ti + kSide * r;
        float xv = 0.f;
#pragma unroll
        for (int c = 0; c < RH; ++c) {
          const int d = tj + kSide * c;
          xv = fmaf(x_s[j * PH + d], bdh[r][c], xv);
          if (j < n) store(dxb + (t0 + j) * x_step + d,
                           fmaf(w_s[j], bdh[r][c], acc[r][c]));
        }
        xv = row_sum(xv);
        if (tj == 0) v_s[j] = edec_s[j] * xv;
      }
    }
    // 6. dC = (P L dt) B + exp(cum) (dy h_in), and r_i = exp(cum_i)
    //    dy_i.(h_in C_i)
    {
      float acc[RT][RS], dyh[RT][RS];
      zero(acc);
      zero(dyh);
      product<RT, RS, kTile>(acc, ti, tj,
                             [&](int i, int j) { return e_s[i * kPT + j]; },
                             [&](int j, int s) { return b_s[j * PS + s]; });
      product<RT, RS, HD>(dyh, ti, tj,
                          [&](int i, int d) { return dy_s[i * PH + d]; },
                          [&](int d, int s) { return hin_s[d * PS + s]; });
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ti + kSide * r;
        float cv = 0.f;
#pragma unroll
        for (int c = 0; c < RS; ++c) {
          const int s = tj + kSide * c;
          cv = fmaf(dyh[r][c], c_s[i * PS + s], cv);
          if (i < n)
            dcp[(t0 + i) * part_step + s] = fmaf(ecum_s[i], dyh[r][c],
                                                 acc[r][c]);
        }
        cv = row_sum(cv);
        if (tj == 0) r_s[i] = ecum_s[i] * cv;
      }
    }
    // 7. dB = (P L dt)^T C + w (x dh)
    {
      float acc[RT][RS], xdh[RT][RS];
      zero(acc);
      zero(xdh);
      product<RT, RS, kTile>(acc, ti, tj,
                             [&](int j, int i) { return e_s[i * kPT + j]; },
                             [&](int i, int s) { return c_s[i * PS + s]; });
      product<RT, RS, HD>(xdh, ti, tj,
                          [&](int j, int d) { return x_s[j * PH + d]; },
                          [&](int d, int s) { return dh_s[d * PS + s]; });
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int j = ti + kSide * r;
        if (j >= n) continue;
#pragma unroll
        for (int c = 0; c < RS; ++c)
          dbp[(t0 + j) * part_step + tj + kSide * c] =
              fmaf(w_s[j], xdh[r][c], acc[r][c]);
      }
    }
    // 8. <dh, h_in>, a warp's part
    {
      float p = 0.f;
      for (int e = tid; e < HD * DS; e += kThreads) {
        const int o = (e / DS) * PS + e % DS;
        p = fmaf(dh_s[o], hin_s[o], p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) red_s[tid / 32] = p;
    }
    __syncthreads();

    // 9. da, ddt and dt da for steps m of the tile
    if (tid < kTile) {
      const int m = tid;
      float dh_hin = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) dh_hin += red_s[w];
      float pairs = 0.f, rsum = 0.f, usum = 0.f;
      for (int i = m; i < kTile; ++i) {
        pairs += k_s[i * kPT + m];
        rsum += r_s[i];
      }
      for (int j = 0; j < m; ++j) usum = fmaf(dt_s[j], v_s[j], usum);
      const float da = ((pairs + rsum) + usum) + expf(total) * dh_hin;
      if (m < n) ddtb[static_cast<int64_t>(t0 + m) * nh] =
          fmaf(A, da, colk_s[m] + v_s[m]);
      dtda_s[m] = dt_s[m] * da;
    }
    // 10. dh <- exp(total) dh + (exp(cum) dy)^T C, each thread its own
    //     elements (no one else reads dh in this phase)
    {
      float acc[RH][RS];
      zero(acc);
      product<RH, RS, kTile>(
          acc, ti, tj,
          [&](int d, int i) { return ecum_s[i] * dy_s[i * PH + d]; },
          [&](int i, int s) { return c_s[i * PS + s]; });
      const float decay = expf(total);
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int c = 0; c < RS; ++c) {
          const int o = (ti + kSide * r) * PS + tj + kSide * c;
          dh_s[o] = fmaf(decay, dh_s[o], acc[r][c]);
        }
    }
    __syncthreads();
    if (tid == 0)
      for (int m = 0; m < kTile; ++m) da_sum += dtda_s[m];
  }
  if (tid == 0) da_part[bh] = da_sum;
}

// ------------------------------------------------------------ reduction

// dB and dC: each head's part summed over the heads of its group, in
// head order; dA: the batch's parts summed in batch order
template <typename T>
__global__ void ssd_reduce_kernel(const float* __restrict__ db_part,
                                  const float* __restrict__ dc_part,
                                  const float* __restrict__ da_part,
                                  T* __restrict__ db, T* __restrict__ dc,
                                  float* __restrict__ da, int64_t rows,
                                  int B, int nh, int g, int ds) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int rep = nh / g;
  if (e < rows * g * ds) {
    const int64_t row = e / (static_cast<int64_t>(g) * ds);
    const int grp = static_cast<int>((e / ds) % g);
    const int s = static_cast<int>(e % ds);
    const int64_t base = (row * nh + static_cast<int64_t>(grp) * rep) * ds + s;
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
    for (int b = 0; b < B; ++b) s += da_part[static_cast<int64_t>(b) * nh + e];
    da[e] = s;
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int HD, int DS>
int launch_shape(const void* x, const void* dt, const void* a,
                 const void* bm, const void* cm, const void* dy,
                 const void* dh_end, void* dx, void* ddt, void* da, void* db,
                 void* dc, void* states, void* db_part, void* dc_part,
                 void* da_part, int B, int S, int nh, int g, int64_t bc_sb,
                 int64_t bc_ss, cudaStream_t stream) {
  const auto state = ssd_state_kernel<T, HD, DS>;
  const auto back = ssd_backward_kernel<T, HD, DS>;
  const int state_bytes = static_cast<int>(StateSmem<HD, DS>::kBytes);
  const int back_bytes = static_cast<int>(BwdSmem<HD, DS>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      state, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(back, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             back_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh, B);
  state<<<grid, kThreads, state_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<float*>(states), S, nh, g, bc_sb, bc_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  back<<<grid, kThreads, back_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dy),
      static_cast<const float*>(dh_end), static_cast<const float*>(states),
      static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(da_part), S, nh, g, bc_sb, bc_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(B) * S;
  const int64_t work = rows * g * DS > nh ? rows * g * DS : nh;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ssd_reduce_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<const float*>(da_part), static_cast<T*>(db),
      static_cast<T*>(dc), static_cast<float*>(da), rows, B, nh, g, DS);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_widths(int hd, int ds, const void* x, const void* dt,
                  const void* a, const void* bm, const void* cm,
                  const void* dy, const void* dh_end, void* dx, void* ddt,
                  void* da, void* db, void* dc, void* states, void* db_part,
                  void* dc_part, void* da_part, int B, int S, int nh, int g,
                  int64_t bc_sb, int64_t bc_ss, cudaStream_t st) {
#define SSD_BWD_SHAPE(HD, DS)                                               \
  if (hd == HD && ds == DS)                                                 \
    return launch_shape<T, HD, DS>(x, dt, a, bm, cm, dy, dh_end, dx, ddt,   \
                                   da, db, dc, states, db_part, dc_part,    \
                                   da_part, B, S, nh, g, bc_sb, bc_ss, st);
  SSD_BWD_SHAPE(64, 128)  // mamba2-2.7b
  SSD_BWD_SHAPE(64, 16)   // jamba-v0.1-52b's Mamba layers
  SSD_BWD_SHAPE(32, 16)   // their reduced configs
#undef SSD_BWD_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch the three kernels on `stream`.  dtype is x's, B's and C's type
// (0 float32, 1 bfloat16); dx, dB and dC are written in it, ddt (B, S,
// nh) and dA (nh,) in float32.  dy (B, S, nh, hd) is float32 and
// contiguous; dh_end (B, nh, hd, ds) float32 or null (zero).  B and C
// share the strides bc_sb (batch) and bc_ss (time step), in elements,
// with the group and state axes packed; dB and dC are contiguous.
// Workspaces, float32: states B nh ceil(S/64) hd ds, db_part and
// dc_part B S nh ds each, da_part B nh.  (hd, ds) is (64, 128), (64, 16)
// or (32, 16).  Returns the first CUDA error of setting a shared-memory
// size or of a launch, 0 if none.
extern "C" int ssd_scan_backward_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* dy, const void* dh_end, void* dx, void* ddt,
    void* da, void* db, void* dc, void* states, void* db_part, void* dc_part,
    void* da_part, int B, int S, int nh, int g, int hd, int ds, int dtype,
    long long bc_sb, long long bc_ss, void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || g <= 0 || nh % g != 0 || B > 65535 ||
      nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_widths<float>(hd, ds, x, dt, a, bm, cm, dy, dh_end, dx, ddt,
                                da, db, dc, states, db_part, dc_part, da_part,
                                B, S, nh, g, bc_sb, bc_ss, st);
  if (dtype == 1)
    return launch_widths<__nv_bfloat16>(hd, ds, x, dt, a, bm, cm, dy, dh_end,
                                        dx, ddt, da, db, dc, states, db_part,
                                        dc_part, da_part, B, S, nh, g, bc_sb,
                                        bc_ss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
