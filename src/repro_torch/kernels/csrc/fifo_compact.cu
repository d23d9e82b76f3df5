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
// subtraction per element (no fused operation, no fast-math flag), so
// the two agree bit for bit.
//
// Design.  The Pallas body handles one point's row per grid step in
// VMEM; on Hopper it is a gather-copy whose source offset differs per
// row.  One launch covers every point: block (row p, chunk c) holds 256
// threads, one output element each.  Thread 0 reads k[p] and now[p]
// into shared memory once per block.  Neighbouring threads read and
// write neighbouring addresses, so loads and stores coalesce; a row is
// n floats (1,409 on the benchmark grid, not a multiple of 4) and the
// source offset k[p] is arbitrary, so the kernel makes scalar loads
// rather than 16-byte vector loads, and masks the ragged chunk itself.
// It writes out of place: the caller passes a second buffer, allocated
// once and swapped with buf each superstep.  In place would race — a
// thread reads buf[i + k] while another writes buf[i + k] as its own
// output.
//
// Bound.  Memory: the kernel must read each row's n - k[p] surviving
// entries and write n entries, 4 bytes each, plus k and now; at the
// benchmark grid's shape (8,192 x 1,409) that is at most 92 MB, about
// 0.028 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void fifo_compact_kernel(const float* __restrict__ buf,
                                    const int32_t* __restrict__ k,
                                    const float* __restrict__ now,
                                    float* __restrict__ out, int64_t n) {
  __shared__ int64_t s_k;
  __shared__ float s_now;
  const int64_t p = blockIdx.x;
  if (threadIdx.x == 0) {
    s_k = k[p];
    s_now = now[p];
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.y) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t src = s_k + i;
  const float v = (src >= 0 && src < n) ? buf[p * n + src] : 0.0f;
  out[p * n + i] = __fsub_rn(v, s_now);
}

}  // namespace

// Launch over a (n_rows, ceil(n / 256)) grid on `stream`.  Returns
// cudaGetLastError() after the launch.
extern "C" int fifo_compact_launch(const void* buf, const void* k,
                                   const void* now, void* out,
                                   int64_t n_rows, int64_t n,
                                   void* stream) {
  if (n_rows == 0 || n == 0) return 0;
  const int64_t chunks = (n + kThreads - 1) / kThreads;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(n_rows),
                  static_cast<unsigned int>(chunks));
  fifo_compact_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), static_cast<const int32_t*>(k),
      static_cast<const float*>(now), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
