// Superstep FIFO compaction with the clock rebase folded in, for the
// port's token-level generate sweep.
//
// Replaces the TPU kernel src/repro/kernels/superstep.py::_compact_body
// (reached through fifo_compact).  For every point p of a (P, n)
// float32 buffer of waiting arrival epochs, its int32 pop count k[p]
// (0 <= k[p] <= n) and its float32 clock now[p]:
//     out[p, i] = buf[p, k[p] + i] - now[p]   where k[p] + i <  n,
//     out[p, i] = 0.0f - now[p]               where k[p] + i >= n,
// i.e. drop the k oldest entries, shift the rest down, and rebase the
// survivors to the new superstep origin — exactly the plain version
// engine.fifo_pop_shift(buf, k, n) - now[:, None], one IEEE float32
// subtraction per element (__fsub_rn: no fused operation, no fast-math
// flag), so the two agree bit for bit.
//
// Design.  The Pallas body handles one point's row per grid step in
// VMEM; on Hopper it is a gather-copy whose source offset differs per
// row.  One warp owns one row (8 rows a block of 256 threads, no block
// barrier): each lane reads k[p] and now[p] itself and writes whole
// float4s of output, 4 a step with all their loads issued first.  A row
// is n floats (1,409 on the benchmark grid, odd), so rows are only
// 4-byte aligned: a scalar head of at most 3 elements brings the stores
// to a 16-byte boundary, and a scalar tail of at most 3 ends the row.
// The source is offset by an arbitrary k[p], so each lane reads its 4
// source floats with scalar loads (a warp's loads still cover 512
// contiguous bytes); aligned float4 loads realigned by warp shuffles
// measured slower.  Output past the survivors is 0 - now and reads
// nothing.  Misaligned buffer bases take a scalar loop.  It writes out
// of place: the caller passes a second buffer, allocated once and
// swapped with buf each superstep.  In place would race — a lane reads
// buf[i + k] while another writes buf[i + k] as its own output.
//
// Bound.  Memory: the kernel must read each row's n - k[p] surviving
// entries and write n entries, 4 bytes each, plus k and now; at the
// benchmark grid's shape (8,192 x 1,409) that is at most 92 MB, about
// 0.028 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;    // rows a block
constexpr int kUnroll = 4;              // float4s a lane a step

__global__ void __launch_bounds__(kThreads) fifo_compact_kernel(
    const float* __restrict__ buf, const int32_t* __restrict__ k,
    const float* __restrict__ now, float* __restrict__ out, int64_t n_rows,
    int64_t n, bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kRows +
                    (threadIdx.x >> 5);
  if (p >= n_rows) return;
  int64_t kp = __ldg(k + p);
  kp = kp < 0 ? 0 : (kp > n ? n : kp);
  const float t = __ldg(now + p);
  const int64_t m = n - kp;                // out[i] = src[i] - t for i < m
  const float* src = buf + p * n + kp;
  float* dst = out + p * n;

  if (!vec) {
    for (int64_t i = lane; i < n; i += 32)
      dst[i] = __fsub_rn(i < m ? __ldg(src + i) : 0.0f, t);
    return;
  }
  // stores: a scalar head to the first 16-byte boundary, float4s, a
  // scalar tail
  int64_t head = (4 - static_cast<int64_t>(
                          (reinterpret_cast<uintptr_t>(dst) >> 2) & 3u)) & 3;
  if (head > n) head = n;
  const int64_t n4 = (n - head) >> 2;
  const int64_t tail = head + 4 * n4;
  if (lane < head)
    dst[lane] = __fsub_rn(lane < m ? __ldg(src + lane) : 0.0f, t);
  if (lane < n - tail) {
    const int64_t i = tail + lane;
    dst[i] = __fsub_rn(i < m ? __ldg(src + i) : 0.0f, t);
  }
  // output float4 v holds out[head + 4v + e] = s0[4v + e] - t, where
  // s0[q] survives for q < live; every load of a step goes out before
  // its stores
  const float* s0 = src + head;
  const int64_t live = m - head;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int64_t v0 = 0; v0 < n4; v0 += 32 * kUnroll) {
    float w[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = 4 * (v0 + 32 * u + lane);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[u][e] = q + e < live ? __ldg(s0 + q + e) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + 32 * u + lane;
      if (v >= n4) break;
      float4 o;
      o.x = __fsub_rn(w[u][0], t);
      o.y = __fsub_rn(w[u][1], t);
      o.z = __fsub_rn(w[u][2], t);
      o.w = __fsub_rn(w[u][3], t);
      d4[v] = o;
    }
  }
}

}  // namespace

// Launch over ceil(n_rows / 8) blocks of 8 warps on `stream`, one warp
// a row.  `vec` takes the float4 stores (buf and out 16-byte aligned:
// the wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int fifo_compact_launch(const void* buf, const void* k,
                                   const void* now, void* out,
                                   int64_t n_rows, int64_t n, int vec,
                                   void* stream) {
  if (n_rows == 0 || n == 0) return 0;
  const int64_t blocks = (n_rows + kRows - 1) / kRows;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  fifo_compact_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), static_cast<const int32_t*>(k),
      static_cast<const float*>(now), static_cast<float*>(out), n_rows, n,
      vec != 0);
  return static_cast<int>(cudaGetLastError());
}
