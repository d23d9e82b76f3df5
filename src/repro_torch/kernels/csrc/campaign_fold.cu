// The campaign's chunk fold, for the port's campaign driver.
//
// No TPU kernel corresponds to it: the reference computes the fold as a
// jitted lax.scan (src/repro/core/campaign.py::_build_fold, body at
// :391).  It folds a chunk's m per-point rows, in global point order,
// into the campaign accumulator in place (the layout of
// repro_torch/kernels/campaign_fold.py::FoldAcc):
//   ints   = hist[n_bins] | points jobs batches buffer_dropped
//            overflow_dropped abandoned n_in_slo n_fresh n_retry
//            quarantined_points | top_lat_idx[K] | top_good_idx[K]
//   floats = hist_sums[n_bins] | sum_latency_jobs sum_latency sum_util
//            sum_batch max_ci | top_lat_val[K] | top_good_val[K]
// and writes the chunk's int64 summary (points, jobs, buffer_dropped,
// quarantined, and on loss grids overflow_dropped, abandoned).
//
// A row is folded when it is valid (i < n_valid; later rows are the
// padded tail) and finite (its latency, utilisation, batch, lam and
// batch-means M2 are finite, and in sketch mode its whole hist_sums
// row); a valid row that is not finite is counted in
// quarantined_points and adds nothing.
//
// Order.  A campaign's accumulator must be bitwise the same at every
// chunk size, so the float64 sums add in global point order and the
// top-K lists see the points in that order (a point replaces the FIRST
// minimal slot on a strict improvement, jnp.argmin's rule).  Integer
// sums and the max are exact in any order.  Every float64 operation is
// an explicit round-to-nearest intrinsic (__dadd_rn, __dmul_rn,
// __ddiv_rn, __dsqrt_rn), so nvcc contracts nothing into an FMA and the
// kernel agrees bit for bit with the plain version, whose scalar loop
// runs in Python floats (IEEE binary64).
//
// Design.  One launch of 256-thread blocks in three roles:
//   count blocks — (bin tile of 256) x (segment of 256 points): each
//     thread sums its bin's int64 counts over the segment's folded rows
//     and adds them to the accumulator with one 64-bit atomicAdd
//     (integer: the order of the atomics cannot change the result);
//   sum blocks (sketch mode) — one per bin tile: each thread adds its
//     bin's hist_sums over all m rows in order, in a register;
//   one scalar block — tile by tile, every thread prepares one point's
//     sanitised values in shared memory (and its integer counters in
//     registers, summed over the block at the end); then lane 0 of warp
//     0 adds the latency sums, warp 1 the utilisation and batch sums,
//     warp 2 the latency top-K, warp 3 the goodput top-K and warp 4 the
//     max half-width, each over the tile in order, concurrently.
// Every block recomputes the folded mask of its own points.
//
// Bound.  Memory: the chunk's inputs read once (m x n_bins int32
// counts, the float32 sums in sketch mode, 9 (m,) rows of 4 bytes, 14
// on loss grids, and the int64 indices), the accumulator read and
// written once (hist_sums in sketch mode only) and the summary written
// once: 17.15 MB at 8,192 x 512, 17.31 MB with the loss rows, about
// 5.1 / 5.2 us at 3.35 TB/s.  The
// sequential float64 chains (one add a row in one thread) bound it
// instead: m dependent additions, plus the scalar block's per-row work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 256;          // points a block handles at a time
constexpr int kTopMax = 256;       // top-K slots kept in shared memory
constexpr int kNumInt = 10;        // the accumulator's int64 counters
constexpr int kNumF64 = 5;         // its float64 sums and max_ci
constexpr double kZ95 = 1.959963984540054;

}  // namespace

extern "C" {
struct FoldArgs {
  const int32_t* hist;        // (m, n_bins)
  const float* hist_sums;     // (m, n_bins), sketch mode only
  const int32_t* n_jobs;
  const int32_t* batches;
  const int32_t* dropped;
  const float* lat;
  const float* util;
  const float* batch;
  const float* lam;
  const float* bm_m2;
  const int32_t* bm_n;
  const int32_t* overflow;    // the loss rows, loss grids only
  const int32_t* abandoned;
  const int32_t* in_slo;
  const int32_t* fresh;
  const int32_t* retry;
  const int64_t* gidx;
  int64_t* ints;
  double* floats;
  int64_t* summary;
  int64_t m;
  int64_t n_valid;
  int32_t n_bins;
  int32_t k_top;
  int32_t has_loss;
  int32_t sketch;
};
}

namespace {

// the points of the tile that starts at i0
__device__ __forceinline__ int tile_len(int64_t m, int64_t i0) {
  const int64_t r = m - i0;
  return r < kSeg ? static_cast<int>(r) : kSeg;
}

__device__ __forceinline__ bool row_finite(const FoldArgs& a, int64_t i) {
  bool f = isfinite(a.lat[i]) && isfinite(a.util[i]) &&
           isfinite(a.batch[i]) && isfinite(a.lam[i]) &&
           isfinite(a.bm_m2[i]);
  if (a.sketch) {
    const float* row = a.hist_sums + i * a.n_bins;
    for (int b = 0; b < a.n_bins; ++b) f = f && isfinite(row[b]);
  }
  return f;
}

// the folded mask of points [i0, i0 + n) into ok[0, n)
__device__ void fill_ok(const FoldArgs& a, int64_t i0, int n,
                        unsigned char* ok) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int64_t i = i0 + j;
    ok[j] = (i < a.n_valid) && row_finite(a, i);
  }
}

__device__ void count_block(const FoldArgs& a, int tile, int seg) {
  __shared__ unsigned char ok[kSeg];
  const int64_t i0 = static_cast<int64_t>(seg) * kSeg;
  const int n = tile_len(a.m, i0);
  fill_ok(a, i0, n, ok);
  __syncthreads();
  const int b = tile * kThreads + threadIdx.x;
  if (b >= a.n_bins) return;
  const int32_t* col = a.hist + i0 * a.n_bins + b;
  long long s = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const int32_t v = col[static_cast<int64_t>(j) * a.n_bins];
    s += ok[j] ? v : 0;
  }
  if (s != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.ints + b),
              static_cast<unsigned long long>(s));
}

__device__ void sum_block(const FoldArgs& a, int tile) {
  __shared__ unsigned char ok[kSeg];
  const int b = tile * kThreads + threadIdx.x;
  const bool mine = b < a.n_bins;
  double acc = mine ? a.floats[b] : 0.0;
  for (int64_t i0 = 0; i0 < a.m; i0 += kSeg) {
    const int n = tile_len(a.m, i0);
    fill_ok(a, i0, n, ok);
    __syncthreads();
    if (mine) {
      const float* col = a.hist_sums + i0 * a.n_bins + b;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float v = col[static_cast<int64_t>(j) * a.n_bins];
        acc = __dadd_rn(acc, ok[j] ? static_cast<double>(v) : 0.0);
      }
    }
    __syncthreads();
  }
  if (mine) a.floats[b] = acc;
}

// the first minimal slot of vals[0, k)
__device__ __forceinline__ int arg_min(const double* vals, int k) {
  int am = 0;
  for (int j = 1; j < k; ++j)
    if (vals[j] < vals[am]) am = j;
  return am;
}

__device__ void scalar_block(const FoldArgs& a) {
  __shared__ unsigned char ok_s[kSeg];
  __shared__ double lat_s[kSeg], util_s[kSeg], batch_s[kSeg], jobs_s[kSeg],
      good_s[kSeg], ci_s[kSeg];
  __shared__ long long gidx_s[kSeg];
  __shared__ double top_val[2][kTopMax];
  __shared__ long long top_idx[2][kTopMax];
  __shared__ unsigned long long totals[kNumInt + 2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = a.n_bins, k = a.k_top;
  int64_t* ints = a.ints + nb;          // the counters
  double* f64 = a.floats + nb;          // the sums and max_ci
  for (int j = tid; j < k; j += blockDim.x) {
    top_idx[0][j] = a.ints[nb + kNumInt + j];
    top_idx[1][j] = a.ints[nb + kNumInt + k + j];
    top_val[0][j] = a.floats[nb + kNumF64 + j];
    top_val[1][j] = a.floats[nb + kNumF64 + k + j];
  }
  for (int j = tid; j < kNumInt + 2; j += blockDim.x) totals[j] = 0;
  __syncthreads();

  // this thread's integer partials, the ACC_INT counters in order
  long long part[kNumInt] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  double s0 = f64[0], s1 = f64[1], s2 = f64[2], s3 = f64[3], mx = f64[4];
  int am = 0;
  if (lane == 0 && (warp == 2 || warp == 3))
    am = arg_min(top_val[warp - 2], k);

  for (int64_t i0 = 0; i0 < a.m; i0 += kSeg) {
    const int n = tile_len(a.m, i0);
    if (tid < n) {
      const int64_t i = i0 + tid;
      const bool valid = i < a.n_valid;
      const bool fin = row_finite(a, i);
      const bool ok = valid && fin;
      const long long w = ok ? 1 : 0;
      const long long jobs = a.n_jobs[i];
      ok_s[tid] = ok;
      lat_s[tid] = ok ? static_cast<double>(a.lat[i]) : 0.0;
      util_s[tid] = ok ? static_cast<double>(a.util[i]) : 0.0;
      batch_s[tid] = ok ? static_cast<double>(a.batch[i]) : 0.0;
      jobs_s[tid] = static_cast<double>(jobs);
      gidx_s[tid] = a.gidx[i];
      double gfrac = 1.0;
      part[0] += w;
      part[1] += jobs * w;
      part[2] += static_cast<long long>(a.batches[i]) * w;
      part[3] += static_cast<long long>(a.dropped[i]) * w;
      if (a.has_loss) {
        const long long ov = a.overflow[i], ab = a.abandoned[i];
        const long long slo = a.in_slo[i];
        part[4] += ov * w;
        part[5] += ab * w;
        part[6] += slo * w;
        part[7] += static_cast<long long>(a.fresh[i]) * w;
        part[8] += static_cast<long long>(a.retry[i]) * w;
        const long long offered = jobs + ov + ab;
        if (offered > 0)
          gfrac = __ddiv_rn(static_cast<double>(slo),
                            static_cast<double>(offered > 1 ? offered : 1));
      } else {
        // loss-free: every measured job completes in SLO
        part[6] += jobs * w;
        part[7] += jobs * w;
      }
      part[9] += (valid && !fin) ? 1 : 0;
      good_s[tid] = __dmul_rn(static_cast<double>(a.lam[i]), gfrac);
      const double nbk = static_cast<double>(a.bm_n[i]);
      const double m2 = static_cast<double>(a.bm_m2[i]);
      const double d1 = fmax(__dsub_rn(nbk, 1.0), 1.0);
      const double d2 = fmax(nbk, 1.0);
      const double ci =
          __dmul_rn(kZ95, __dsqrt_rn(__ddiv_rn(__ddiv_rn(m2, d1), d2)));
      ci_s[tid] = (ok && nbk >= 2.0) ? ci : 0.0;
    }
    __syncthreads();
    if (lane == 0) {
      if (warp == 0) {
        for (int j = 0; j < n; ++j) {
          const double wf = ok_s[j] ? 1.0 : 0.0;
          s0 = __dadd_rn(s0, __dmul_rn(__dmul_rn(lat_s[j], jobs_s[j]), wf));
          s1 = __dadd_rn(s1, __dmul_rn(lat_s[j], wf));
        }
      } else if (warp == 1) {
        for (int j = 0; j < n; ++j) {
          const double wf = ok_s[j] ? 1.0 : 0.0;
          s2 = __dadd_rn(s2, __dmul_rn(util_s[j], wf));
          s3 = __dadd_rn(s3, __dmul_rn(batch_s[j], wf));
        }
      } else if (warp == 2 || warp == 3) {
        double* vals = top_val[warp - 2];
        long long* idxs = top_idx[warp - 2];
        const double* v = warp == 2 ? lat_s : good_s;
        for (int j = 0; j < n; ++j) {
          if (ok_s[j] && v[j] > vals[am]) {
            vals[am] = v[j];
            idxs[am] = gidx_s[j];
            am = arg_min(vals, k);
          }
        }
      } else if (warp == 4) {
        // NaN propagates, as jnp.maximum / jnp.max do
        for (int j = 0; j < n; ++j) {
          const double c = ci_s[j];
          if (!isnan(mx) && (isnan(c) || c > mx)) mx = c;
        }
      }
    }
    __syncthreads();
  }

  for (int j = 0; j < kNumInt; ++j)
    if (part[j] != 0)
      atomicAdd(&totals[j], static_cast<unsigned long long>(part[j]));
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < kNumInt; ++j)
      ints[j] += static_cast<long long>(totals[j]);
    a.summary[0] = static_cast<long long>(totals[0]);   // points
    a.summary[1] = static_cast<long long>(totals[1]);   // jobs
    a.summary[2] = static_cast<long long>(totals[3]);   // buffer_dropped
    a.summary[3] = static_cast<long long>(totals[9]);   // quarantined
    if (a.has_loss) {
      a.summary[4] = static_cast<long long>(totals[4]);
      a.summary[5] = static_cast<long long>(totals[5]);
    }
  }
  if (lane == 0) {
    if (warp == 0) {
      f64[0] = s0;
      f64[1] = s1;
    } else if (warp == 1) {
      f64[2] = s2;
      f64[3] = s3;
    } else if (warp == 4) {
      f64[4] = mx;
    }
  }
  for (int j = tid; j < k; j += blockDim.x) {
    a.ints[nb + kNumInt + j] = top_idx[0][j];
    a.ints[nb + kNumInt + k + j] = top_idx[1][j];
    a.floats[nb + kNumF64 + j] = top_val[0][j];
    a.floats[nb + kNumF64 + k + j] = top_val[1][j];
  }
}

__global__ void __launch_bounds__(kThreads)
    campaign_fold_kernel(FoldArgs a, int bin_tiles, int count_blocks,
                         int sum_blocks) {
  const int blk = blockIdx.x;
  if (blk < count_blocks) {
    count_block(a, blk % bin_tiles, blk / bin_tiles);
  } else if (blk < count_blocks + sum_blocks) {
    sum_block(a, blk - count_blocks);
  } else {
    scalar_block(a);
  }
}

}  // namespace

extern "C" int campaign_fold_launch(const FoldArgs* args, void* stream) {
  const FoldArgs a = *args;
  if (a.k_top < 1 || a.k_top > kTopMax || a.m < 0 || a.n_bins < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bin_tiles = (a.n_bins + kThreads - 1) / kThreads;
  const int segs = static_cast<int>((a.m + kSeg - 1) / kSeg);
  const int count_blocks = bin_tiles * segs;
  const int sum_blocks = a.sketch ? bin_tiles : 0;
  campaign_fold_kernel<<<count_blocks + sum_blocks + 1, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      a, bin_tiles, count_blocks, sum_blocks);
  return static_cast<int>(cudaGetLastError());
}
