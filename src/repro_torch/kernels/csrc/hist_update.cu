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
// where the mask is set, and add with shared-memory atomics.  R*W may
// be any size and a point's mask row may start at any byte (the
// generate sweep's thinned blocks are len(rows) x s_cap, e.g. 5 x 7):
// the vector loop covers the row's 16-byte aligned middle, and one
// scalar pass covers the unaligned head and the tail.  The block
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

__device__ __forceinline__ void add_one(float x, int* s_hist,
                                        double* s_sums, int n_bins,
                                        int shift, int base) {
  int b = (__float_as_int(x) >> shift) - base;
  b = min(max(b, 0), n_bins - 1);
  atomicAdd(&s_hist[b], 1);
  if (s_sums != nullptr) atomicAdd(&s_sums[b], static_cast<double>(x));
}

__global__ void hist_update_kernel(const float* __restrict__ lats,
                                   const uint8_t* __restrict__ inc,
                                   int32_t* __restrict__ hist,
                                   float* __restrict__ sums,
                                   int64_t per_point, int n_bins,
                                   int shift, int base) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_sums = sums != nullptr ? reinterpret_cast<double*>(smem)
                                   : nullptr;
  int* s_hist = reinterpret_cast<int*>(
      smem + (sums != nullptr ? n_bins * sizeof(double) : 0));

  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    s_hist[j] = 0;
    if (s_sums != nullptr) s_sums[j] = 0.0;
  }
  __syncthreads();

  const int64_t p = blockIdx.x;
  const float* row = lats + p * per_point;
  const uint8_t* mrow = inc + p * per_point;
  // the aligned middle [head, head + 16 * n_vec) of the mask row
  const int64_t mis = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(mrow) & 15u);
  const int64_t lead = mis == 0 ? 0 : 16 - mis;
  const int64_t head = lead < per_point ? lead : per_point;
  const int64_t n_vec = (per_point - head) / 16;
  const int64_t tail = head + 16 * n_vec;
  const uint4* mask = reinterpret_cast<const uint4*>(mrow + head);
  for (int64_t v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const uint4 m = mask[v];
    if ((m.x | m.y | m.z | m.w) == 0u) continue;
    const uint32_t words[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) {
        add_one(row[head + v * 16 + k], s_hist, s_sums, n_bins, shift,
                base);
      }
    }
  }
  // the scalar rest: the head before the aligned middle (< 16 bytes)
  // and the tail after it (< 16 bytes)
  const int64_t n_rest = head + (per_point - tail);
  for (int64_t j = threadIdx.x; j < n_rest; j += blockDim.x) {
    const int64_t e = j < head ? j : tail + (j - head);
    if (mrow[e]) add_one(row[e], s_hist, s_sums, n_bins, shift, base);
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
// mode).  Any per_point and any mask alignment.  Returns
// cudaGetLastError() after the launch.
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
