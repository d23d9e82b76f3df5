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
// sums are exact in any order; max_ci keeps the first maximum (the
// first NaN, once one comes), which segments combine in order.  Every
// float64 operation is an explicit round-to-nearest intrinsic
// (__dadd_rn, __dmul_rn, __ddiv_rn, __dsqrt_rn), so nvcc contracts
// nothing into an FMA and the kernel agrees bit for bit with the plain
// version, whose scalar loop runs in Python floats (IEEE binary64).
//
// Design: two launches, only the float64 chains serial.
//   fold_rows, a block of 64 threads per 64 rows over every SM: each
//     thread prepares its row as the serial walk would (the folded
//     flag, the four float64 terms lat jobs w, lat w, util w and batch w,
//     the top-K candidates lat and lam times the goodput fraction, the
//     half-width with its divides and square root) into a workspace of
//     ~57 bytes a row held in L2; the integer counters are summed over
//     the block and added with 64-bit atomics; max_ci is combined over
//     the block's rows in order (a shuffle tree over neighbours) into one
//     value a block.
//   fold_tail, behind it on the stream, in three roles:
//     block 0, the ordered tail: warps 3-7 stage the prepared rows
//       through a 3-stage cp.async ring of 256-row tiles; lanes 0-3 of
//       warp 0 run the four sum chains, one __dadd_rn and one shared
//       load a step; warps 1 and 2 walk the two top-K lists: a ballot of
//       (folded and v > the running minimum) over 32 rows, its set bits
//       handled in order, and after each replacement the first minimal
//       slot found again by a shuffle reduction (ties to the lowest
//       slot).  Skipping a row that does not beat the running minimum is
//       exact: the minimum never falls, so the row could never enter.
//       The two lists live in the block's shared memory, beside the
//       three staging tiles, up to kTopSmem slots each (1,908: the room
//       the sketch blocks' larger stages leave, so the launch's shared
//       memory does not grow with k); a longer list is walked in place
//       in the accumulator's own slots in device memory, in the same
//       order (a replacement is lane 0's store, made visible to the
//       warp's next scan by __syncwarp).
//       Warp 3 combines the blocks' max_ci in block order.
//     sketch blocks, one per 64 bins: thread b runs bin b's hist_sums
//       chain over rows that the block's other threads stage the same
//       way (128-row tiles), each value or +0.0 selected by a bit mask
//       (a branch a row kept the loads from running ahead: 45 cycles a
//       row on the H100, against 8.6 for a __dadd_rn).
//     count blocks, (bin tile of 256) x (64-row segment): each thread
//       sums its bin's int64 counts over the segment's folded rows (the
//       flags fold_rows wrote) and adds them with one 64-bit atomicAdd.
//
// Bound.  Memory: the chunk's inputs read once (m x n_bins int32
// counts, the float32 sums in sketch mode, 9 (m,) rows of 4 bytes, 14
// on loss grids, and the int64 indices), the accumulator read and
// written once (hist_sums in sketch mode only) and the summary written
// once: 17.15 MB at 8,192 x 512, 17.31 MB with the loss rows, about
// 5.1 / 5.2 us at 3.35 TB/s.  The contract's serial float64 chains bound
// it instead: m dependent __dadd_rn (chain_floor_ms in chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kRowThreads = 64;    // fold_rows: a row a thread
constexpr int kThreads = 256;      // fold_tail
constexpr int kSeg = 64;           // rows a count block
constexpr int kBinTile = 256;      // bins a count block
constexpr int kSumBins = 64;       // bins a sketch block
constexpr int kSumRows = 128;      // rows a sketch tile
constexpr int kTailRows = 256;     // rows a tail tile
constexpr int kTailWalkers = 96;   // the tail's warps 0-2 walk, the rest
                                   // stage (a sketch block: past its bins)
constexpr int kStages = 3;
constexpr int kNumInt = 10;        // the accumulator's int64 counters
constexpr int kNumF64 = 5;         // its float64 sums and max_ci
constexpr double kZ95 = 1.959963984540054;
constexpr unsigned kFull = 0xffffffffu;

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

// The workspace of a chunk of m rows: arrays of mp = m rounded up to 64
// entries (16-byte aligned): the terms t[4][mp], the candidates vlat[mp]
// and vgood[mp] (float64), the blocks' max_ci bmax[mp / 64], the folded
// flags ok[mp] (bytes).
struct Work {
  double* t;
  double* vlat;
  double* vgood;
  double* bmax;
  unsigned char* ok;
  int64_t mp;
};

__host__ __device__ inline int64_t padded(int64_t m) {
  return (m + kRowThreads - 1) / kRowThreads * kRowThreads;
}

__host__ __device__ inline int64_t work_bytes(int64_t m) {
  const int64_t mp = padded(m);
  return 8 * (6 * mp + mp / kRowThreads) + mp + 16;
}

__host__ __device__ inline Work work_at(void* base, int64_t m) {
  Work w;
  w.mp = padded(m);
  double* d = static_cast<double*>(base);
  w.t = d;
  w.vlat = d + 4 * w.mp;
  w.vgood = d + 5 * w.mp;
  w.bmax = d + 6 * w.mp;
  const int64_t end = 8 * (6 * w.mp + w.mp / kRowThreads);
  w.ok = static_cast<unsigned char*>(base) + (end + 15) / 16 * 16;
  return w;
}

// max_ci's order-kept maximum: x, then c (c later in point order)
__device__ __forceinline__ double max_after(double x, double c) {
  return (!isnan(x) && (isnan(c) || c > x)) ? c : x;
}

__global__ void __launch_bounds__(kRowThreads)
    fold_rows(FoldArgs a, Work w) {
  __shared__ int bad[kRowThreads];       // sketch: a non-finite sum
  __shared__ long long wsum[2][kNumInt];
  __shared__ double wmax[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kRowThreads;
  const int64_t i = i0 + tid;
  const bool in = i < a.m;
  if (a.sketch) {
    bad[tid] = 0;
    __syncthreads();
    const int nb = a.n_bins;
    const int64_t rows = min(static_cast<int64_t>(kRowThreads), a.m - i0);
    const float* base = a.hist_sums + i0 * nb;
    // the block's rows are contiguous: read them as float4s, 4 floats of
    // one row each (n_bins % 4 == 0, 16-byte aligned: the launch checks)
    const float4* b4 = reinterpret_cast<const float4*>(base);
#pragma unroll 4
    for (int64_t e = tid; e < rows * nb / 4; e += kRowThreads) {
      const float4 x = b4[e];
      if (!(isfinite(x.x) && isfinite(x.y) && isfinite(x.z) &&
            isfinite(x.w)))
        bad[e * 4 / nb] = 1;
    }
    __syncthreads();
  }

  long long part[kNumInt] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  double ci_row = -INFINITY;             // past m: never the maximum
  if (in) {
    const bool valid = i < a.n_valid;
    const bool fin = isfinite(a.lat[i]) && isfinite(a.util[i]) &&
                     isfinite(a.batch[i]) && isfinite(a.lam[i]) &&
                     isfinite(a.bm_m2[i]) && !(a.sketch && bad[tid]);
    const bool ok = valid && fin;
    const long long wi = ok ? 1 : 0;
    const long long jobs = a.n_jobs[i];
    const double wf = ok ? 1.0 : 0.0;
    const double lat_s = ok ? static_cast<double>(a.lat[i]) : 0.0;
    const double util_s = ok ? static_cast<double>(a.util[i]) : 0.0;
    const double batch_s = ok ? static_cast<double>(a.batch[i]) : 0.0;
    w.ok[i] = ok;
    w.t[i] = __dmul_rn(__dmul_rn(lat_s, static_cast<double>(jobs)), wf);
    w.t[w.mp + i] = __dmul_rn(lat_s, wf);
    w.t[2 * w.mp + i] = __dmul_rn(util_s, wf);
    w.t[3 * w.mp + i] = __dmul_rn(batch_s, wf);
    w.vlat[i] = lat_s;
    double gfrac = 1.0;
    part[0] = wi;
    part[1] = jobs * wi;
    part[2] = static_cast<long long>(a.batches[i]) * wi;
    part[3] = static_cast<long long>(a.dropped[i]) * wi;
    if (a.has_loss) {
      const long long ov = a.overflow[i], ab = a.abandoned[i];
      const long long slo = a.in_slo[i];
      part[4] = ov * wi;
      part[5] = ab * wi;
      part[6] = slo * wi;
      part[7] = static_cast<long long>(a.fresh[i]) * wi;
      part[8] = static_cast<long long>(a.retry[i]) * wi;
      const long long offered = jobs + ov + ab;
      if (offered > 0)
        gfrac = __ddiv_rn(static_cast<double>(slo),
                          static_cast<double>(offered > 1 ? offered : 1));
    } else {
      // loss-free: every measured job completes in SLO
      part[6] = jobs * wi;
      part[7] = jobs * wi;
    }
    part[9] = (valid && !fin) ? 1 : 0;
    w.vgood[i] = __dmul_rn(static_cast<double>(a.lam[i]), gfrac);
    const double nbk = static_cast<double>(a.bm_n[i]);
    const double m2 = static_cast<double>(a.bm_m2[i]);
    const double d1 = fmax(__dsub_rn(nbk, 1.0), 1.0);
    const double d2 = fmax(nbk, 1.0);
    const double ci =
        __dmul_rn(kZ95, __dsqrt_rn(__ddiv_rn(__ddiv_rn(m2, d1), d2)));
    ci_row = (ok && nbk >= 2.0) ? ci : 0.0;
  }

  // max_ci over the block's rows in order: lane l takes l + 1, then
  // pairs of 2, 4, ... (neighbouring segments, the earlier one left)
  double mx = ci_row;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    mx = max_after(mx, __shfl_down_sync(kFull, mx, off));
#pragma unroll
  for (int j = 0; j < kNumInt; ++j) {
    long long s = part[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(kFull, s, off);
    part[j] = s;
  }
  if (lane == 0) {
    wmax[warp] = mx;
#pragma unroll
    for (int j = 0; j < kNumInt; ++j) wsum[warp][j] = part[j];
  }
  __syncthreads();
  if (tid == 0) w.bmax[blockIdx.x] = max_after(wmax[0], wmax[1]);
  if (tid < kNumInt) {
    const long long s = wsum[0][tid] + wsum[1][tid];
    if (s != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.ints + a.n_bins + tid),
                static_cast<unsigned long long>(s));
      // the summary: points, jobs, buffer_dropped, quarantined, and on
      // loss grids overflow_dropped, abandoned
      const int at = tid == 0 ? 0 : tid == 1 ? 1 : tid == 3 ? 2
                   : tid == 9 ? 3 : (a.has_loss && tid == 4) ? 4
                   : (a.has_loss && tid == 5) ? 5 : -1;
      if (at >= 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.summary + at),
                  static_cast<unsigned long long>(s));
    }
  }
}

// ----------------------------------------------------------- fold_tail

struct SumSmem {
  static constexpr int kV = 0;                               // rows x bins
  static constexpr int kOk = kV + kSumRows * kSumBins * 4;
  static constexpr int kStage = kOk + kSumRows;
  static constexpr int kBytes = kStages * kStage;
};

// The launch's dynamic shared memory, the sketch blocks' stages; the
// tail block's stages, then its two lists (values, then indices, k
// apart) in what is left.
constexpr int kTailSmem = SumSmem::kBytes;

struct TailSmem {
  static constexpr int kT = 0;                               // 4 x rows
  static constexpr int kVl = kT + 4 * kTailRows * 8;
  static constexpr int kVg = kVl + kTailRows * 8;
  static constexpr int kOk = kVg + kTailRows * 8;
  static constexpr int kStage = kOk + kTailRows;
  static constexpr int kVals = kStages * kStage;              // 2 x k
};

// the longest lists kept in shared memory: 2 x k values and 2 x k
// indices of 8 bytes
constexpr int kTopSmem = (kTailSmem - TailSmem::kVals) / 32;
static_assert(kTopSmem >= 256, "the lists of the default k_top fit");

// the prepared rows [i0, i0 + kTailRows) into a tail stage; nothing is
// read at or past m
__device__ void stage_rows(unsigned char* st, const Work& w, int64_t i0,
                           int64_t m) {
  constexpr int kPerArray = kTailRows / 2;                   // 16-byte chunks
  for (int id = threadIdx.x - kTailWalkers; id < 6 * kPerArray +
       kTailRows / 16; id += kThreads - kTailWalkers) {
    if (id < 0) break;
    if (id < 6 * kPerArray) {
      const int arr = id / kPerArray, ch = id % kPerArray;
      const int64_t row = i0 + 2 * ch;
      const double* src = (arr < 4 ? w.t + arr * w.mp
                           : arr == 4 ? w.vlat : w.vgood) +
                          (row < m ? row : 0);
      cp_async16(st + arr * kTailRows * 8 + ch * 16, src, row < m);
    } else {
      const int ch = id - 6 * kPerArray;
      const int64_t row = i0 + 16 * ch;
      cp_async16(st + TailSmem::kOk + ch * 16, w.ok + (row < m ? row : 0),
                 row < m);
    }
  }
  cp_async_commit();
}

// the first minimal slot of vals[0, k) and its value, in every lane of
// the warp: each lane's slots ascending, then a shuffle reduction on
// (value, slot) with ties to the lower slot
__device__ __forceinline__ void first_min(const double* vals, int k, int& am,
                                          double& cur) {
  const int lane = threadIdx.x & 31;
  double best = 0.0;
  int bi = -1;
  for (int s = lane; s < k; s += 32) {
    const double v = vals[s];
    if (bi < 0 || v < best) {
      best = v;
      bi = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ob = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    if (oi >= 0 && (bi < 0 || ob < best || (ob == best && oi < bi))) {
      best = ob;
      bi = oi;
    }
  }
  am = __shfl_sync(kFull, bi, 0);
  cur = __shfl_sync(kFull, best, 0);
}

__device__ void tail_block(const FoldArgs& a, const Work& w, int n_blocks,
                           unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = a.n_bins, k = a.k_top;
  double* f64 = a.floats + nb;
  // the two lists, values then indices, k apart: in shared memory when
  // they fit, else the accumulator's own slots
  const bool in_smem = k <= kTopSmem;
  double* vals = in_smem ? reinterpret_cast<double*>(smem + TailSmem::kVals)
                         : a.floats + nb + kNumF64;
  long long* idxs = in_smem ? reinterpret_cast<long long*>(
                                  smem + TailSmem::kVals + 16 * k)
                            : reinterpret_cast<long long*>(a.ints) + nb +
                                  kNumInt;
  if (in_smem) {
    for (int j = tid; j < 2 * k; j += kThreads) {
      idxs[j] = a.ints[nb + kNumInt + j];
      vals[j] = a.floats[nb + kNumF64 + j];
    }
  }
  const int n_tiles = static_cast<int>((a.m + kTailRows - 1) / kTailRows);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      stage_rows(smem + st * TailSmem::kStage, w,
                 static_cast<int64_t>(st) * kTailRows, a.m);
    else
      cp_async_commit();
  }
  __syncthreads();

  // warp 0 lanes 0-3: the sums; warps 1, 2: the lists
  double acc = lane < 4 && warp == 0 ? f64[lane] : 0.0;
  const int list = warp - 1;
  double* lv = vals + (list & 1) * k;
  long long* li = idxs + (list & 1) * k;
  int am = 0;
  double cur = 0.0;
  if (warp == 1 || warp == 2) first_min(lv, k, am, cur);

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                     // tile i in; tile i - 1 done
    {
      const int nxt = i + kStages - 1;
      if (nxt < n_tiles)
        stage_rows(smem + (nxt % kStages) * TailSmem::kStage, w,
                   static_cast<int64_t>(nxt) * kTailRows, a.m);
      else
        cp_async_commit();
    }
    const unsigned char* st = smem + (i % kStages) * TailSmem::kStage;
    const int64_t i0 = static_cast<int64_t>(i) * kTailRows;
    const int n = static_cast<int>(min(static_cast<int64_t>(kTailRows),
                                       a.m - i0));
    if (warp == 0) {
      if (lane < 4) {
        const double* t =
            reinterpret_cast<const double*>(st + TailSmem::kT) +
            lane * kTailRows;
#pragma unroll 16
        for (int r = 0; r < n; ++r) acc = __dadd_rn(acc, t[r]);
      }
    } else if (warp == 1 || warp == 2) {
      const double* v = reinterpret_cast<const double*>(
          st + (warp == 1 ? TailSmem::kVl : TailSmem::kVg));
      const unsigned char* okr = st + TailSmem::kOk;
      for (int r0 = 0; r0 < n; r0 += 32) {
        const int r = r0 + lane;
        unsigned bits = __ballot_sync(kFull, r < n && okr[r] && v[r] > cur);
        while (bits) {
          const int j = __ffs(bits) - 1;
          bits &= bits - 1;
          const double vj = v[r0 + j];
          if (vj > cur) {
            if (lane == 0) {
              lv[am] = vj;
              li[am] = a.gidx[i0 + r0 + j];
            }
            __syncwarp();
            first_min(lv, k, am, cur);
          }
        }
      }
    }
  }
  cp_async_wait_all();

  if (warp == 0 && lane < 4) f64[lane] = acc;
  if (warp == 3 && lane == 0) {
    // max_ci: the accumulator's, then the blocks' in order
    double mx = f64[4];
    for (int blk = 0; blk < n_blocks; ++blk) mx = max_after(mx, w.bmax[blk]);
    f64[4] = mx;
  }
  __syncthreads();
  if (in_smem) {
    for (int j = tid; j < 2 * k; j += kThreads) {
      a.ints[nb + kNumInt + j] = idxs[j];
      a.floats[nb + kNumF64 + j] = vals[j];
    }
  }
}

// bins [b0, b0 + kSumBins) of hist_sums, rows [i0, i0 + kSumRows), into
// a sketch stage; nothing is read at or past m or n_bins
__device__ void stage_sums(unsigned char* st, const FoldArgs& a,
                           const Work& w, int b0, int64_t i0) {
  float* v = reinterpret_cast<float*>(st + SumSmem::kV);
  // 16-byte copies of 4 bins (n_bins % 4 == 0: the launch checks)
  for (int id = threadIdx.x - kSumBins; id < kSumRows * kSumBins / 4;
       id += kThreads - kSumBins) {
    if (id < 0) break;
    const int r = id * 4 / kSumBins, bb = id * 4 % kSumBins;
    const int64_t row = i0 + r;
    const bool ok = row < a.m && b0 + bb < a.n_bins;
    const float* src = a.hist_sums + (ok ? row * a.n_bins + b0 + bb : 0);
    cp_async16(v + id * 4, src, ok);
  }
  for (int ch = threadIdx.x - kSumBins; ch >= 0 && ch < kSumRows / 16;
       ch += kThreads - kSumBins) {
    const int64_t row = i0 + 16 * ch;
    cp_async16(st + SumSmem::kOk + ch * 16, w.ok + (row < a.m ? row : 0),
               row < a.m);
  }
  cp_async_commit();
}

__device__ void sum_block(const FoldArgs& a, const Work& w, int tile,
                          unsigned char* smem) {
  const int b0 = tile * kSumBins;
  const int bb = threadIdx.x;
  const bool mine = bb < kSumBins && b0 + bb < a.n_bins;
  double acc = mine ? a.floats[b0 + bb] : 0.0;
  const int n_tiles = static_cast<int>((a.m + kSumRows - 1) / kSumRows);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      stage_sums(smem + st * SumSmem::kStage, a, w, b0,
                 static_cast<int64_t>(st) * kSumRows);
    else
      cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nxt = i + kStages - 1;
      if (nxt < n_tiles)
        stage_sums(smem + (nxt % kStages) * SumSmem::kStage, a, w, b0,
                   static_cast<int64_t>(nxt) * kSumRows);
      else
        cp_async_commit();
    }
    const unsigned char* st = smem + (i % kStages) * SumSmem::kStage;
    if (mine) {
      const float* v = reinterpret_cast<const float*>(st + SumSmem::kV);
      const unsigned char* okr = st + SumSmem::kOk;
      const int n = static_cast<int>(min(static_cast<int64_t>(kSumRows),
                                         a.m - static_cast<int64_t>(i) *
                                                   kSumRows));
      // a folded row's value, else +0.0, selected by a mask: a branch a
      // row would keep the loads from running ahead of the chain
#pragma unroll 16
      for (int r = 0; r < n; ++r) {
        const long long keep = -static_cast<long long>(okr[r] != 0);
        acc = __dadd_rn(acc, __longlong_as_double(
                                 __double_as_longlong(static_cast<double>(
                                     v[r * kSumBins + bb])) & keep));
      }
    }
  }
  cp_async_wait_all();
  if (mine) a.floats[b0 + bb] = acc;
}

__device__ void count_block(const FoldArgs& a, const Work& w, int tile,
                            int seg) {
  __shared__ unsigned char ok[kSeg];
  const int64_t i0 = static_cast<int64_t>(seg) * kSeg;
  const int n = static_cast<int>(min(static_cast<int64_t>(kSeg), a.m - i0));
  if (threadIdx.x < n) ok[threadIdx.x] = w.ok[i0 + threadIdx.x];
  __syncthreads();
  const int b = tile * kBinTile + threadIdx.x;
  if (b >= a.n_bins) return;
  const int32_t* col = a.hist + i0 * a.n_bins + b;
  long long s = 0;
#pragma unroll 16
  for (int j = 0; j < n; ++j) {
    const int32_t v = col[static_cast<int64_t>(j) * a.n_bins];
    s += ok[j] ? v : 0;
  }
  if (s != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.ints + b),
              static_cast<unsigned long long>(s));
}

__global__ void __launch_bounds__(kThreads)
    fold_tail(FoldArgs a, Work w, int n_blocks, int sum_blocks,
              int bin_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = blockIdx.x;
  if (blk == 0) {
    tail_block(a, w, n_blocks, smem);
  } else if (blk <= sum_blocks) {
    sum_block(a, w, blk - 1, smem);
  } else {
    const int c = blk - 1 - sum_blocks;
    count_block(a, w, c % bin_tiles, c / bin_tiles);
  }
}

// The floor of the ordered tail: one thread adding x[0] to x[1] m times,
// each __dadd_rn waiting on the last (chain_floor_ms).
__global__ void chain_floor(const double* x, double* out, int64_t m) {
  double acc = x[0];
  const double d = x[1];
  int64_t i = 0;
  for (; i + 32 <= m; i += 32) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc = __dadd_rn(acc, d);
  }
  for (; i < m; ++i) acc = __dadd_rn(acc, d);
  *out = acc;
}

}  // namespace

// One thread's chain of m dependent __dadd_rn (x: 2 doubles, out: 1), the
// time the tail's sums cannot beat.
extern "C" int campaign_fold_chain_launch(const void* x, void* out,
                                          int64_t m, void* stream) {
  chain_floor<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// The workspace bytes a chunk of m rows needs (16-byte aligned).
extern "C" int64_t campaign_fold_work_bytes(int64_t m) {
  return work_bytes(m);
}

// Fold on `stream`: fold_rows, then fold_tail.  work: the workspace of
// campaign_fold_work_bytes(m) bytes, 16-byte aligned; the summary zero;
// in sketch mode n_bins % 4 == 0 and hist_sums 16-byte aligned.  Any
// k_top >= 1: the lists of more than kTopSmem slots are walked in the
// accumulator's device memory.
extern "C" int campaign_fold_launch(const FoldArgs* args, void* work,
                                    void* stream) {
  const FoldArgs a = *args;
  if (a.k_top < 1 || a.m < 0 || a.n_bins < 1 ||
      work == nullptr || reinterpret_cast<uintptr_t>(work) % 16 != 0 ||
      (a.sketch && (a.n_bins % 4 != 0 ||
                    reinterpret_cast<uintptr_t>(a.hist_sums) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work w = work_at(work, a.m);
  const int n_blocks = static_cast<int>(w.mp / kRowThreads);
  if (n_blocks > 0) {
    fold_rows<<<n_blocks, kRowThreads, 0, st>>>(a, w);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int bin_tiles = (a.n_bins + kBinTile - 1) / kBinTile;
  const int segs = static_cast<int>((a.m + kSeg - 1) / kSeg);
  const int sum_blocks = a.sketch ? (a.n_bins + kSumBins - 1) / kSumBins : 0;
  cudaError_t e = cudaFuncSetAttribute(
      fold_tail, cudaFuncAttributeMaxDynamicSharedMemorySize, kTailSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fold_tail<<<1 + sum_blocks + bin_tiles * segs, kThreads, kTailSmem, st>>>(
      a, w, n_blocks, sum_blocks, bin_tiles);
  return static_cast<int>(cudaGetLastError());
}
