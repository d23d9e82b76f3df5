// Superstep latency-histogram update for the port's Monte Carlo sweep.
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
// n_bins times the work.  Here one thread block owns one point: it
// zeroes a shared-memory histogram (n_bins int32 — 2 KB at 512 bins —
// plus n_bins float64 partial sums in sketch mode), its threads stride
// over the point's R*W entries reading the mask 16 bytes at a time
// (neighbouring threads on neighbouring addresses), load a latency only
// where the mask is set, and add with shared-memory atomics.  The block
// then adds its shared histogram into the point's row; no other block
// touches that row, so no global atomics are needed.  All P points go
// in one launch per superstep.
//
// Counts are integer adds and match the plain torch version bit for
// bit.  The sums' atomics add in no fixed order, so the block's partial
// sums are kept in float64 and added to the float32 row once: the
// result then does not depend on the order (to within a float64
// rounding), and the plain version computes the same.
//
// Bound.  The kernel is memory-bound: it must read the mask
// (P*R*W bytes), the included latencies (4 bytes each) and the
// histogram rows, and write the rows back (2*P*n_bins*4 bytes, twice
// that in sketch mode).  At the sweep's user-size shape (P = 8160,
// R = 32, W = 768, 512 bins) with every latency read that is about
// 1.04 GB, 0.31 ms at 3.35 TB/s; skipping masked-out latencies lowers
// what it must read on the sweep's sparse masks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hist_update_kernel(const float* __restrict__ lats,
                                   const uint8_t* __restrict__ inc,
                                   int32_t* __restrict__ hist,
                                   float* __restrict__ sums,
                                   int64_t per_point, int n_bins,
                                   int shift, int base) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_sums = reinterpret_cast<double*>(smem);
  int* s_hist = reinterpret_cast<int*>(
      smem + (sums != nullptr ? n_bins * sizeof(double) : 0));

  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    s_hist[j] = 0;
    if (sums != nullptr) s_sums[j] = 0.0;
  }
  __syncthreads();

  const int64_t p = blockIdx.x;
  const float* row = lats + p * per_point;
  const uint4* mask = reinterpret_cast<const uint4*>(inc + p * per_point);
  const int64_t n_vec = per_point / 16;
  for (int64_t v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const uint4 m = mask[v];
    if ((m.x | m.y | m.z | m.w) == 0u) continue;
    const uint32_t words[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) {
        const float x = row[v * 16 + k];
        int b = (__float_as_int(x) >> shift) - base;
        b = min(max(b, 0), n_bins - 1);
        atomicAdd(&s_hist[b], 1);
        if (sums != nullptr) atomicAdd(&s_sums[b], static_cast<double>(x));
      }
    }
  }
  __syncthreads();

  int32_t* out = hist + p * n_bins;
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    out[j] += s_hist[j];
    if (sums != nullptr) {
      float* srow = sums + p * n_bins;
      srow[j] = srow[j] + static_cast<float>(s_sums[j]);
    }
  }
}

}  // namespace

// Launch over n_points blocks on `stream`; `sums` may be null (full
// mode).  Requires per_point % 16 == 0 and a 16-byte aligned mask (the
// wrapper checks both).  Returns cudaGetLastError() after the launch.
extern "C" int hist_update_launch(const void* lats, const void* inc,
                                  void* hist, void* sums,
                                  int64_t n_points, int64_t per_point,
                                  int n_bins, int shift, int base,
                                  void* stream) {
  if (n_points == 0) return 0;
  const int threads = 256;
  const size_t smem = static_cast<size_t>(n_bins) *
                      (sizeof(int) + (sums != nullptr ? sizeof(double) : 0));
  hist_update_kernel<<<static_cast<unsigned int>(n_points), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lats), static_cast<const uint8_t*>(inc),
      static_cast<int32_t*>(hist), static_cast<float*>(sums), per_point,
      n_bins, shift, base);
  return static_cast<int>(cudaGetLastError());
}
