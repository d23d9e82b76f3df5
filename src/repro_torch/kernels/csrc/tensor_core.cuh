// The tensor-core building blocks of the port's bf16 kernels: 16-byte
// cp.async copies into shared memory, ldmatrix fragment loads, the
// m16n8k16 bf16 -> float32 mma.sync, and a float32 pair carried as two
// bf16 terms (hi + lo, ~16 bits).  Included by flash_attention.cu,
// flash_attention_backward.cu, ssd_scan.cu and ssd_scan_backward.cu.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + c, g = lane / 4,
// c = lane % 4):
//   A (16 x 16, row): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g,
//     2c+8..), a3 = (g+8, 2c+8..);
//   B (16 x 8, col): b0 = (k 2c..2c+1, n g), b1 = (k 2c+8.., n g);
//   C (16 x 8): c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, 2c..2c+1).
// So the accumulators of two neighbouring n-tiles of one product are
// the A fragment of a 16-wide k-step of the next (as P enters P . V).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled (nothing read) unless ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (a_hi + a_lo) . b: a float32 operand carried as two bf16 terms
__device__ __forceinline__ void mma_split(float* c, const uint32_t* hi,
                                          const uint32_t* lo, uint32_t b0,
                                          uint32_t b1) {
  mma_bf16(c, hi, b0, b1);
  mma_bf16(c, lo, b0, b1);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// (x0, x1) as hi + lo: hi the bf16 pair nearest, lo the bf16 pair
// nearest the remainder
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Fragment loads from a bf16 matrix in shared memory with rows `stride`
// elements apart (rows 16-byte aligned, padded so that the 8 rows of an
// ldmatrix phase fall in distinct banks).
//
// A (16 x 16) at rows m0.., columns k0.. of M stored [m][k]
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* m,
                                       int stride, int m0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, m + (m0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
}

// A (16 x 16) = M^T at rows m0.., columns k0.., M stored [k][m]
__device__ __forceinline__ void frag_a_t(uint32_t* a, const __nv_bfloat16* m,
                                         int stride, int m0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(a, m + (k0 + (lane & 7) + (lane >> 4) * 8) * stride + m0 +
                       ((lane >> 3) & 1) * 8);
}

// B (16 x 8) at k0.., n0.. of a matrix stored [n][k] (B = M^T)
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* m,
                                       int stride, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x2(b, m + (n0 + (lane & 7)) * stride + k0 + ((lane >> 3) & 1) * 8);
}

// B (16 x 8) at k0.., n0.. of a matrix stored [k][n]
__device__ __forceinline__ void frag_b_t(uint32_t* b, const __nv_bfloat16* m,
                                         int stride, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x2_trans(b, m + (k0 + (lane & 15)) * stride + n0);
}

}  // namespace
