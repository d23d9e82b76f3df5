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
//
// Design.  The Pallas grid (B*nh, S/chunk) walks the chunks of one head
// in order and carries h in VMEM scratch; here one block of 256
// threads serves one (head, batch row) and the time axis is a loop
// inside the block, in tiles of kTile = 64 steps.  SSD gives the same
// function for every chunk size up to rounding, so the tile need not
// be the model's chunk.  Per tile, everything in float32 on the CUDA
// cores:
//   1. stage x, B, C and dt of the tile in shared memory (rows past S
//      are zero: dt = 0 is an identity step, so h_S is the state after
//      exactly S steps and the ragged tail writes no y);
//   2. one warp takes the prefix sum cum of dt*A, and the weights
//      w_j = exp(total - cum_j) dt_j of the state update;
//   3. G_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i (the
//      exponent is taken only there: it is <= 0), else 0;
//   4. y_i = sum_j G_ij x_j + exp(cum_i) C_i . h (the state before the
//      tile), written straight to global memory;
//   5. h <- h exp(total) + sum_j w_j x_j (x) B_j.
// Each thread keeps its 2-D register tile of each product, and its
// share of h lives in registers across the whole walk, mirrored in
// shared memory (rows padded by one float against bank conflicts) for
// step 4.  B and C are read through a batch and a time stride, so the
// model's slices of one (B, S, 2 g ds) activation need no copy.
//
// Bound.  The recurrence does 4 hd ds flops per step and head; at the
// long serve shape (B 32, S 1,024, 80 x 64 heads, ds 128) that is
// ~86 GFLOP, while reading x, dt, B, C once and writing y (float32)
// and h_S once moves ~1.12 GB: ~0.33 ms at 3.35 TB/s, so bytes bound
// it.  This kernel runs the tile's dual form on the CUDA cores; tensor
// cores (mma / wgmma on bf16 tiles) and a split of the time axis are
// later work.  At batch 1 the grid is only nh = 80 blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                // time steps per tile
constexpr int kSide = 16;                // 16 x 16 threads over T x T, T x hd
constexpr int kRows = kTile / kSide;     // rows of a thread's tile
static_assert(kTile == 64, "the prefix sum gives each lane two steps");
static_assert(kSide * kSide == kThreads, "thread grid");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared-memory layout, in floats.
template <int HD, int DS>
struct Smem {
  static constexpr int kPitch = DS + 1;          // h, B and C rows
  static constexpr int kGPitch = kTile + 1;      // G rows
  static constexpr int kH = 0;                   // h    HD x kPitch
  static constexpr int kX = kH + HD * kPitch;    // x    kTile x HD
  static constexpr int kB = kX + kTile * HD;     // B    kTile x kPitch
  static constexpr int kC = kB + kTile * kPitch; // C    kTile x kPitch
  static constexpr int kG = kC + kTile * kPitch; // G    kTile x kGPitch
  static constexpr int kDt = kG + kTile * kGPitch;
  static constexpr int kCum = kDt + kTile;
  static constexpr int kW = kCum + kTile;
  static constexpr int kFloats = kW + kTile;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y32,
                T* __restrict__ yt, float* __restrict__ h_out, int S, int nh,
                int g, int64_t bc_sb, int64_t bc_ss) {
  using L = Smem<HD, DS>;
  constexpr int P = L::kPitch;
  constexpr int kCols = HD / kSide;              // y columns a thread
  // a thread's share of h: rows d = hr + kHStep r, columns s = hc +
  // kHCols k
  constexpr int kHCols = DS < 32 ? DS : 32;
  constexpr int kHStep = kThreads / kHCols;
  constexpr int kRD = HD / kHStep;
  constexpr int kRS = DS / kHCols;
  static_assert(HD % kSide == 0 && HD % kHStep == 0 && DS % kHCols == 0,
                "state tile split");

  extern __shared__ float smem[];
  float* h_s = smem + L::kH;
  float* x_s = smem + L::kX;
  float* b_s = smem + L::kB;
  float* c_s = smem + L::kC;
  float* g_s = smem + L::kG;
  float* dt_s = smem + L::kDt;
  float* cum_s = smem + L::kCum;
  float* w_s = smem + L::kW;

  const int tid = threadIdx.x;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = head / (nh / g);
  const float A = a[head];
  const int64_t x_step = static_cast<int64_t>(nh) * HD;
  const T* xb = x + static_cast<int64_t>(b) * S * x_step +
                static_cast<int64_t>(head) * HD;
  const float* dtb = dt + static_cast<int64_t>(b) * S * nh + head;
  const T* bb = bm + b * bc_sb + static_cast<int64_t>(grp) * DS;
  const T* cb = cm + b * bc_sb + static_cast<int64_t>(grp) * DS;

  const int ti = tid / kSide;
  const int tj = tid % kSide;
  const int hr = tid / kHCols;
  const int hc = tid % kHCols;

  float h[kRD][kRS];
#pragma unroll
  for (int r = 0; r < kRD; ++r)
#pragma unroll
    for (int k = 0; k < kRS; ++k) h[r][k] = 0.f;
  for (int e = tid; e < HD * P; e += kThreads) h_s[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int n = S - t0 < kTile ? S - t0 : kTile;

    // 1. stage the tile as float32, zero past the end
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int i = e / HD;
      x_s[e] = i < n ? to_f32(xb[(t0 + i) * x_step + e % HD]) : 0.f;
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
      b_s[i * P + s] = bv;
      c_s[i * P + s] = cv;
    }
    if (tid < kTile)
      dt_s[tid] = tid < n ? dtb[static_cast<int64_t>(t0 + tid) * nh] : 0.f;
    __syncthreads();

    // 2. cum = prefix sum of dt*A (lane l holds steps 2l and 2l+1), and
    //    the state update's weights
    if (tid < 32) {
      const float d0 = __fmul_rn(dt_s[2 * tid], A);
      const float v1 = d0 + __fmul_rn(dt_s[2 * tid + 1], A);
      float incl = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      cum_s[2 * tid] = excl + d0;
      cum_s[2 * tid + 1] = excl + v1;
      __syncwarp();
      const float total = cum_s[n - 1];
      w_s[2 * tid] = expf(total - cum_s[2 * tid]) * dt_s[2 * tid];
      w_s[2 * tid + 1] = expf(total - cum_s[2 * tid + 1]) * dt_s[2 * tid + 1];
    }
    __syncthreads();

    // 3. G = (C B^T) o exp(cum_i - cum_j) o dt_j, lower triangle
    {
      float acc[kRows][kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kRows; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int s = 0; s < DS; ++s) {
        float cv[kRows], bv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          cv[r] = c_s[(ti + kSide * r) * P + s];
          bv[r] = b_s[(tj + kSide * r) * P + s];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kRows; ++c)
            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = ti + kSide * r;
#pragma unroll
        for (int c = 0; c < kRows; ++c) {
          const int j = tj + kSide * c;
          g_s[i * L::kGPitch + j] =
              j <= i ? acc[r][c] * expf(cum_s[i] - cum_s[j]) * dt_s[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y = G x + exp(cum) (C h^T), with h the state before the tile
    {
      float intra[kRows][kCols], inter[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) intra[r][c] = inter[r][c] = 0.f;
      for (int j = 0; j < n; ++j) {
        float gv[kRows], xv[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          gv[r] = g_s[(ti + kSide * r) * L::kGPitch + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) xv[c] = x_s[j * HD + tj + kSide * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            intra[r][c] = fmaf(gv[r], xv[c], intra[r][c]);
      }
#pragma unroll 4
      for (int s = 0; s < DS; ++s) {
        float cv[kRows], hv[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r) cv[r] = c_s[(ti + kSide * r) * P + s];
#pragma unroll
        for (int c = 0; c < kCols; ++c) hv[c] = h_s[(tj + kSide * c) * P + s];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            inter[r][c] = fmaf(cv[r], hv[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = ti + kSide * r;
        if (i >= n) continue;
        const float e = expf(cum_s[i]);
        const int64_t row =
            ((static_cast<int64_t>(b) * S + t0 + i) * nh + head) * HD;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = tj + kSide * c;
          const float v = intra[r][c] + e * inter[r][c];
          if (y32 != nullptr) store(y32 + row + d, v);
          if (yt != nullptr) store(yt + row + d, v);
        }
      }
    }
    __syncthreads();

    // 5. h <- h exp(total) + sum_j w_j x_j (x) B_j
    {
      const float decay = expf(cum_s[n - 1]);
      float acc[kRD][kRS];
#pragma unroll
      for (int r = 0; r < kRD; ++r)
#pragma unroll
        for (int k = 0; k < kRS; ++k) acc[r][k] = 0.f;
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
        for (int k = 0; k < kRS; ++k) {
          h[r][k] = h[r][k] * decay + acc[r][k];
          h_s[(hr + kHStep * r) * P + hc + kHCols * k] = h[r][k];
        }
    }
    __syncthreads();
  }

  if (h_out != nullptr) {
    float* hb = h_out + (static_cast<int64_t>(b) * nh + head) * HD * DS;
#pragma unroll
    for (int r = 0; r < kRD; ++r)
#pragma unroll
      for (int k = 0; k < kRS; ++k)
        hb[(hr + kHStep * r) * DS + hc + kHCols * k] = h[r][k];
  }
}

template <typename T, int HD, int DS>
int launch_shape(const void* x, const void* dt, const void* a,
                 const void* bm, const void* cm, void* y, int y_f32,
                 void* h_out, int B, int S, int nh, int g, int64_t bc_sb,
                 int64_t bc_ss, cudaStream_t stream) {
  const auto kernel = ssd_scan_kernel<T, HD, DS>;
  const int bytes = static_cast<int>(Smem<HD, DS>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nh, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), y_f32 ? static_cast<float*>(y) : nullptr,
      y_f32 ? nullptr : static_cast<T*>(y), static_cast<float*>(h_out), S, nh,
      g, bc_sb, bc_ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(int hd, int ds, const void* x, const void* dt,
                 const void* a, const void* bm, const void* cm, void* y,
                 int y_f32, void* h_out, int B, int S, int nh, int g,
                 int64_t bc_sb, int64_t bc_ss, cudaStream_t st) {
#define SSD_SHAPE(HD, DS)                                                    \
  if (hd == HD && ds == DS)                                                  \
    return launch_shape<T, HD, DS>(x, dt, a, bm, cm, y, y_f32, h_out, B, S, \
                                   nh, g, bc_sb, bc_ss, st);
  SSD_SHAPE(64, 128)  // mamba2-2.7b
  SSD_SHAPE(32, 16)   // its reduced config
#undef SSD_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch over an (nh, B) grid on `stream`.  dtype is x's, B's and C's
// type: 0 float32, 1 bfloat16; y is float32 when y_f32 != 0, else of
// that type; h_out (B, nh, hd, ds) float32 may be null.  B and C share
// the strides bc_sb (batch) and bc_ss (time step), in elements, with
// the group and state axes packed.  (hd, ds) is (64, 128) or (32, 16).
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               int y_f32, void* h_out, int B, int S, int nh,
                               int g, int hd, int ds, int dtype,
                               long long bc_sb, long long bc_ss,
                               void* stream) {
  if (B == 0 || nh == 0) return 0;
  if (g <= 0 || nh % g != 0 || B > 65535 || nh > 65535 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(hd, ds, x, dt, a, bm, cm, y, y_f32, h_out, B,
                               S, nh, g, bc_sb, bc_ss, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(hd, ds, x, dt, a, bm, cm, y, y_f32,
                                       h_out, B, S, nh, g, bc_sb, bc_ss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
