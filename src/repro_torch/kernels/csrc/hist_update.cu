// Superstep latency-histogram update for the port's Monte Carlo sweeps.
//
// Replaces the TPU kernel src/repro/kernels/superstep.py::_hist_body
// (reached through _pallas_hist / hist_update).  For every point p of a
// (P, R, W) block of float32 latencies and its bool include mask, it
// bins each included latency by its bit pattern,
//     bin = clamp((__float_as_int(x) >> shift) - base, 0, n_bins - 1),
// with an arithmetic shift on int32 exactly as lax.bitcast_convert_type
// followed by >> in the reference, and adds the int32 counts into the
// point's histogram row.  In sketch mode it also adds the included
// latencies into per-bin float32 sums.
//
// Design.  The Pallas body builds a one-hot (R*W, n_bins) matrix and
// reduces it, which suits the TPU's vector unit; on Hopper that is
// n_bins times the work.  Here a group of kG warps owns one point and a
// histogram slice in shared memory (n_bins int32, plus n_bins float64
// partial sums in sketch mode); a block of at most 256 threads holds up
// to 8 / kG points.  The paths' blocks (a few thousand points of 315 to
// 24,576 entries) are mostly mask: on the sweep's own blocks 1 entry in
// 80 is included, so the kernel is a stream over the mask whose speed
// is the bytes each SM keeps in flight.
//
//   * Grouping.  With many points for their size (the wrapper's rule:
//     at least 28 * sqrt(entries a point) points) one warp owns a point
//     (kG = 1): it zeroes and flushes its own slice with __syncwarp
//     only, so a small point pays no block barrier.  A launch over
//     fewer points gives each a block of 8 warps (kG = 8, one named
//     barrier per group) so that it still spreads over the card: on
//     the 5-point sweep of a few loads that is 3.7 times faster.
//   * Registers.  At most 32 a thread (8 blocks of 256 an SM): one warp
//     a point then puts the sweep's 8,160 points on the card in one
//     wave, and every SM keeps 64 warps of loads in flight.  The sketch
//     is a template parameter, so full mode carries none of its code.
//   * Reads.  A warp walks its point 128 entries a step, two steps at
//     once: each lane loads one 4-byte mask word, then the float4 of
//     the 4 latencies under it only where the word is non-zero, then
//     adds, so a warp's loads are 128 contiguous mask bytes and 512
//     contiguous latency bytes, and a masked-out word costs no latency
//     sector.  The vector loop needs the mask words and their float4s
//     aligned together (the wrapper checks the two base pointers); a
//     row's unaligned head and tail (at most 3 entries each: the
//     generate sweep's thinned blocks are 5 x 63) take one scalar step.
//     Misaligned bases take a scalar loop.
//   * Adds.  Plain shared-memory atomics, one per included entry.
//   * Flush.  The group adds its slice into the point's row in global
//     memory, 16 bytes at a time where the row allows it, and skips
//     every group of four bins whose counts are all zero: on the paths'
//     blocks a point's latencies fall into a few bins, so most of the
//     row is never read or written.  No other group touches that row,
//     so no global atomics are needed.  All P points go in one launch
//     per superstep.
//
// Counts are integer adds and match the plain torch version bit for
// bit.  The sums' atomics add in no fixed order, so the partial sums are
// kept in float64 and added to the float32 row once: the result then
// does not depend on the order (to within a float64 rounding), and the
// plain version computes the same.
//
// Bound.  Memory: any implementation reads the whole mask (P*R*W
// bytes), every 32-byte sector of latencies that holds an included
// entry, and reads and writes every 32-byte sector of the rows whose
// bins receive a count (both rows in sketch mode); the wrapper module's
// hist_update_min_bytes counts that on a block.  At the sweep's
// user-size shape (P = 8160, R = 32, W = 768, 512 bins) with an i.i.d.
// 50% mask that is about 1.02 GB, 0.30 ms at 3.35 TB/s; on the sweep's
// own prefix masks the 200 MB mask is most of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// 8 blocks of 256 threads an SM: at most 32 registers a thread, so one
// warp a point puts the sweep's 8,160 points on the card in one wave
constexpr int kMinBlocks = 8;
constexpr int kSteps = 2;       // vector steps a lane holds in flight

// Add one included latency into the slice.
template <bool kSketch>
__device__ __forceinline__ void add_entry(float x, int* s_hist,
                                          double* s_sums, int n_bins,
                                          int shift, int base) {
  int b = (__float_as_int(x) >> shift) - base;
  b = min(max(b, 0), n_bins - 1);
  atomicAdd(&s_hist[b], 1);
  if (kSketch) atomicAdd(&s_sums[b], static_cast<double>(x));
}

// The included ones of the 4 entries under one mask word.
template <bool kSketch>
__device__ __forceinline__ void add_word(uint32_t m, float4 x, int* s_hist,
                                         double* s_sums, int n_bins,
                                         int shift, int base) {
  if (m & 0xffu) add_entry<kSketch>(x.x, s_hist, s_sums, n_bins, shift, base);
  if (m & 0xff00u) add_entry<kSketch>(x.y, s_hist, s_sums, n_bins, shift, base);
  if (m & 0xff0000u)
    add_entry<kSketch>(x.z, s_hist, s_sums, n_bins, shift, base);
  if (m & 0xff000000u)
    add_entry<kSketch>(x.w, s_hist, s_sums, n_bins, shift, base);
}

template <int kG>
__device__ __forceinline__ void group_sync(int group) {
  if (kG == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kG * 32)
                 : "memory");
  }
}

template <int kG, bool kSketch>
__global__ void __launch_bounds__(kThreads, kMinBlocks) hist_update_kernel(
    const float* __restrict__ lats, const uint8_t* __restrict__ inc,
    int32_t* __restrict__ hist, float* __restrict__ sums, int64_t n_points,
    int64_t per_point, int n_bins, int shift, int base, int points_per_block,
    bool vec_loads, bool vec_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / kG;
  const int wig = warp % kG;                      // warp in group
  const int tig = threadIdx.x - group * kG * 32;  // thread in group
  const int64_t p = static_cast<int64_t>(blockIdx.x) * points_per_block +
                    group;
  if (p >= n_points) return;

  // the block's slices: all float64 sums first, then all counts
  double* s_sums = kSketch ? reinterpret_cast<double*>(smem) + group * n_bins
                           : nullptr;
  int* s_hist = reinterpret_cast<int*>(
                    smem + (kSketch ? static_cast<size_t>(points_per_block) *
                                          n_bins * sizeof(double)
                                    : 0)) +
                group * n_bins;
  if ((n_bins & 3) == 0) {
    int4* h4 = reinterpret_cast<int4*>(s_hist);
    for (int j = tig; j < (n_bins >> 2); j += kG * 32)
      h4[j] = make_int4(0, 0, 0, 0);
  } else {
    for (int j = tig; j < n_bins; j += kG * 32) s_hist[j] = 0;
  }
  if (kSketch)
    for (int j = tig; j < n_bins; j += kG * 32) s_sums[j] = 0.0;
  group_sync<kG>(group);

  const float* row = lats + p * per_point;
  const uint8_t* mrow = inc + p * per_point;
  if (vec_loads) {
    // the 4-aligned middle [head, tail) of the mask row; the latencies
    // under it are 16-aligned (the wrapper checked that the two bases
    // agree)
    int64_t head = (4 - static_cast<int64_t>(
                            reinterpret_cast<uintptr_t>(mrow) & 3u)) & 3;
    if (head > per_point) head = per_point;
    const int64_t n_vec = (per_point - head) >> 2;
    const int64_t tail = head + 4 * n_vec;
    const uint32_t* mw = reinterpret_cast<const uint32_t*>(mrow + head);
    const float4* lv = reinterpret_cast<const float4*>(row + head);
    for (int64_t v0 = static_cast<int64_t>(wig) * 32 * kSteps; v0 < n_vec;
         v0 += static_cast<int64_t>(kG) * 32 * kSteps) {
      uint32_t m[kSteps];
      float4 x[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int64_t v = v0 + 32 * u + lane;
        m[u] = v < n_vec ? __ldg(mw + v) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
        x[u] = m[u] != 0u ? __ldg(lv + v0 + 32 * u + lane)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (!__any_sync(kFull, m[u] != 0u)) continue;
        add_word<kSketch>(m[u], x[u], s_hist, s_sums, n_bins, shift, base);
      }
    }
    // the scalar rest: at most 3 entries before the middle and 3 after
    // it, one step of the group's first warp
    const int64_t n_rest = head + (per_point - tail);
    if (wig == 0 && lane < n_rest) {
      const int64_t e = lane < head ? lane : tail + (lane - head);
      if (mrow[e] != 0)
        add_entry<kSketch>(row[e], s_hist, s_sums, n_bins, shift, base);
    }
  } else {
    for (int64_t e = tig; e < per_point; e += kG * 32)
      if (mrow[e] != 0)
        add_entry<kSketch>(row[e], s_hist, s_sums, n_bins, shift, base);
  }
  group_sync<kG>(group);

  // flush: add the slice into the point's row, skipping bins that
  // received nothing
  int32_t* out = hist + p * n_bins;
  float* sout = kSketch ? sums + p * n_bins : nullptr;
  if (vec_rows) {
    for (int j = tig; j < (n_bins >> 2); j += kG * 32) {
      const int4 c = reinterpret_cast<const int4*>(s_hist)[j];
      if ((c.x | c.y | c.z | c.w) == 0) continue;
      int4* o = reinterpret_cast<int4*>(out) + j;
      int4 h = *o;
      h.x += c.x; h.y += c.y; h.z += c.z; h.w += c.w;
      *o = h;
      if (kSketch) {
        float4* so = reinterpret_cast<float4*>(sout) + j;
        float4 f = *so;
        f.x = f.x + static_cast<float>(s_sums[4 * j]);
        f.y = f.y + static_cast<float>(s_sums[4 * j + 1]);
        f.z = f.z + static_cast<float>(s_sums[4 * j + 2]);
        f.w = f.w + static_cast<float>(s_sums[4 * j + 3]);
        *so = f;
      }
    }
  } else {
    for (int j = tig; j < n_bins; j += kG * 32) {
      const int c = s_hist[j];
      if (c == 0) continue;
      out[j] += c;
      if (kSketch) sout[j] = sout[j] + static_cast<float>(s_sums[j]);
    }
  }
}

template <int kG, bool kSketch>
int launch(const void* lats, const void* inc, void* hist, void* sums,
           int64_t n_points, int64_t per_point, int n_bins, int shift,
           int base, int points_per_block, bool vec_loads, bool vec_rows,
           size_t smem, cudaStream_t stream) {
  const int64_t blocks = (n_points + points_per_block - 1) / points_per_block;
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  hist_update_kernel<kG, kSketch>
      <<<static_cast<unsigned int>(blocks), kG * 32 * points_per_block, smem,
         stream>>>(
          static_cast<const float*>(lats), static_cast<const uint8_t*>(inc),
          static_cast<int32_t*>(hist), static_cast<float*>(sums), n_points,
          per_point, n_bins, shift, base, points_per_block, vec_loads,
          vec_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int kG>
int launch_g(const void* lats, const void* inc, void* hist, void* sums,
             int64_t n_points, int64_t per_point, int n_bins, int shift,
             int base, int ppb, bool vl, bool vr, size_t smem,
             cudaStream_t st) {
  if (sums != nullptr)
    return launch<kG, true>(lats, inc, hist, sums, n_points, per_point,
                            n_bins, shift, base, ppb, vl, vr, smem, st);
  return launch<kG, false>(lats, inc, hist, sums, n_points, per_point, n_bins,
                           shift, base, ppb, vl, vr, smem, st);
}

}  // namespace

// Launch on `stream` with the wrapper's plan: `warps_per_point` (1 or
// 8) warps own a point, `points_per_block` points share a block (at most
// 8 / warps_per_point: 256 threads), `smem_bytes` of dynamic shared
// memory; `vec_loads` takes the vector loop (mask and latency bases
// aligned together), `vec_rows` flushes 16 bytes at a time (n_bins % 4
// == 0, rows 16-byte aligned).  `sums` may be null (full mode).  Returns
// cudaGetLastError() after the launch.
extern "C" int hist_update_launch(const void* lats, const void* inc,
                                  void* hist, void* sums,
                                  int64_t n_points, int64_t per_point,
                                  int n_bins, int shift, int base,
                                  int warps_per_point, int points_per_block,
                                  int64_t smem_bytes, int vec_loads,
                                  int vec_rows, void* stream) {
  if (n_points == 0) return 0;
  if (points_per_block < 1 || points_per_block * warps_per_point > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (warps_per_point) {
    case 1:
      return launch_g<1>(lats, inc, hist, sums, n_points, per_point, n_bins,
                         shift, base, points_per_block, vec_loads != 0,
                         vec_rows != 0, smem, st);
    case 8:
      return launch_g<8>(lats, inc, hist, sums, n_points, per_point, n_bins,
                         shift, base, points_per_block, vec_loads != 0,
                         vec_rows != 0, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
