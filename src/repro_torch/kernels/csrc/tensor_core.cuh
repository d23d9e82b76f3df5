// The tensor-core building blocks of the port's attention and SSD
// kernels: 16-byte cp.async copies into shared memory, ldmatrix fragment
// loads, the m16n8k16 bf16 -> float32 mma.sync, a float32 pair carried
// as two bf16 terms (hi + lo, ~16 bits), and float32 products as 3xTF32
// (m16n8k8 tf32 -> float32, each operand as big + small TF32 terms).
// Included by flash_attention.cu, flash_attention_backward.cu,
// mla_decode.cu, campaign_fold.cu, ssd_scan.cu and ssd_scan_backward.cu.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + c, g = lane / 4,
// c = lane % 4):
//   A (16 x 16, row): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g,
//     2c+8..), a3 = (g+8, 2c+8..);
//   B (16 x 8, col): b0 = (k 2c..2c+1, n g), b1 = (k 2c+8.., n g);
//   C (16 x 8): c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, 2c..2c+1).
// So the accumulators of two neighbouring n-tiles of one product are
// the A fragment of a 16-wide k-step of the next (as P enters P . V).
//
// Of mma.sync.m16n8k8 with tf32 operands:
//   A (16 x 8, row): a0 = (g, c), a1 = (g+8, c), a2 = (g, c+4), a3 =
//     (g+8, c+4);
//   B (8 x 8, col): b0 = (k c, n g), b1 = (k c+4, n g);
//   C (16 x 8): as above, c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, ..).
// The accumulators of one n-tile are the A fragment of an 8-wide k-step
// of the next product once its k-index is relabelled: A's column c
// holds key (or row) 2c and column c+4 holds 2c+1, so (a0, a1, a2, a3)
// = (c0, c2, c1, c3) and B reads rows 2c and 2c+1 of the next operand
// (frag_b_rows_tf32).  tests/test_torch_flash_tf32_tiles.py holds the
// mapping on the CPU.
//
// 3xTF32.  big = x rounded to TF32 (10 explicit mantissa bits, to
// nearest, ties away from zero: cvt.rna.tf32.f32's rounding, done as an
// integer add of half an ulp and a mask, since cvt.rna has no sm_90
// instruction and expands into compares and selects), small = x - big
// (exact); the tensor cores read only a TF32 operand's upper 19 bits, so
// small enters truncated to TF32.  x = big + small to ~2^-21, and small
// . big + big . small + big . big (the small . small term dropped, ~2^-22
// of the product) summed in float32 keeps about 21 bits of every
// product, against ~11 for one TF32 term.  Each product is three m16n8k8
// mma: the float32 kernels issue three times the TF32 work of the
// function (495 / 3 = 165 TFLOP/s at best).  The tensor cores' float32
// sums truncate rather than round, so a fragment that many mma feed in
// turn drifts toward zero; the kernels sum a tile's products in zeroed
// fragments and add those to their running sums in round-to-nearest.

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

// ------------------------------------------------------------------ tf32

// x as big + small TF32 terms: big rounded to nearest (ties away from
// zero), small = x - big, read by the tensor cores truncated
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c (16 x 8, float32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b with a = ab + as and b = bb + bs: the small terms first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ab,
                                           const uint32_t* as,
                                           const uint32_t* bb,
                                           const uint32_t* bs) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

// The same three products with the small terms' two apart from big .
// big: lo += as . bb + ab . bs, hi += ab . bb.  Two chains, each half as
// long and truncating at its own magnitude (lo's ~2^-11 of hi's), for
// the caller to add in round-to-nearest.
__device__ __forceinline__ void mma_3xtf32_apart(float* lo, float* hi,
                                                 const uint32_t* ab,
                                                 const uint32_t* as,
                                                 const uint32_t* bb,
                                                 const uint32_t* bs) {
  mma_tf32(lo, as, bb[0], bb[1]);
  mma_tf32(hi, ab, bb[0], bb[1]);
  mma_tf32(lo, ab, bs[0], bs[1]);
}

// Fragment loads from a float32 matrix in shared memory with rows
// `stride` floats apart (stride = width + 4, so that the 32 lanes of one
// 32-bit load, rows g and columns c or rows 2c and columns g, fall in
// distinct banks), split into big and small TF32 terms.
//
// A (16 x 8) at rows m0.., columns k0.. of M stored [m][k]
__device__ __forceinline__ void frag_a_tf32(uint32_t* big, uint32_t* small,
                                            const float* m, int stride,
                                            int m0, int k0) {
  const int lane = threadIdx.x % 32;
  const float* p = m + (m0 + lane / 4) * stride + k0 + lane % 4;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * stride], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * stride + 4], big[3], small[3]);
}

// B (8 x 8) at k0.., n0.. of a matrix stored [n][k] (B = M^T)
__device__ __forceinline__ void frag_b_tf32(uint32_t* big, uint32_t* small,
                                            const float* m, int stride,
                                            int n0, int k0) {
  const int lane = threadIdx.x % 32;
  const float* p = m + (n0 + lane / 4) * stride + k0 + lane % 4;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}

// B (8 x 8) at k0.., n0.. of a matrix stored [k][n], its k-index
// relabelled as the A fragment made from accumulators (A's column c is
// row k0 + 2c, c+4 is k0 + 2c + 1)
__device__ __forceinline__ void frag_b_rows_tf32(uint32_t* big,
                                                 uint32_t* small,
                                                 const float* m, int stride,
                                                 int k0, int n0) {
  const int lane = threadIdx.x % 32;
  const float* p = m + (k0 + 2 * (lane % 4)) * stride + n0 + lane / 4;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[stride], big[1], small[1]);
}

// The pair-relabelled loads: an 8-wide k-step whose k-index c holds
// column k0 + 2c and c + 4 holds k0 + 2c + 1 (as an accumulator's pair
// of columns does), so each lane reads one float2 a row; with stride
// = 8 mod 32 the 16 lanes of each half-warp fall in distinct banks.
//
// A (16 x 8) at rows m0.. of M stored [m][k]
__device__ __forceinline__ void frag_a_pairs_tf32(uint32_t* big,
                                                  uint32_t* small,
                                                  const float* m, int stride,
                                                  int m0, int k0) {
  const int lane = threadIdx.x % 32;
  const float* p = m + (m0 + lane / 4) * stride + k0 + 2 * (lane % 4);
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8 * stride);
  split_tf32(u.x, big[0], small[0]);
  split_tf32(v.x, big[1], small[1]);
  split_tf32(u.y, big[2], small[2]);
  split_tf32(v.y, big[3], small[3]);
}

// B (8 x 8) at n0.. of a matrix stored [n][k] (B = M^T)
__device__ __forceinline__ void frag_b_pairs_tf32(uint32_t* big,
                                                  uint32_t* small,
                                                  const float* m, int stride,
                                                  int n0, int k0) {
  const int lane = threadIdx.x % 32;
  const float2 u = *reinterpret_cast<const float2*>(
      m + (n0 + lane / 4) * stride + k0 + 2 * (lane % 4));
  split_tf32(u.x, big[0], small[0]);
  split_tf32(u.y, big[1], small[1]);
}

// The natural loads from a matrix stored with k as its row: lane (g, c)
// reads row k0 + c (and + 4) at column g; with stride = 8 mod 32 the 32
// lanes fall in distinct banks.
//
// B (8 x 8) at k0.., n0.. of a matrix stored [k][n]
__device__ __forceinline__ void frag_b_kn_tf32(uint32_t* big,
                                               uint32_t* small,
                                               const float* m, int stride,
                                               int k0, int n0) {
  const int lane = threadIdx.x % 32;
  const float* p = m + (k0 + lane % 4) * stride + n0 + lane / 4;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4 * stride], big[1], small[1]);
}

// A (16 x 8) = M^T at rows m0.., columns k0.., M stored [k][m]
__device__ __forceinline__ void frag_a_km_tf32(uint32_t* big,
                                               uint32_t* small,
                                               const float* m, int stride,
                                               int m0, int k0) {
  const int lane = threadIdx.x % 32;
  const float* p = m + (k0 + lane % 4) * stride + m0 + lane / 4;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8], big[1], small[1]);
  split_tf32(p[4 * stride], big[2], small[2]);
  split_tf32(p[4 * stride + 8], big[3], small[3]);
}

// the accumulators t of one n-tile as the A fragment of the next
// product's 8-wide k-step, split: (a0, a1, a2, a3) = (t0, t2, t1, t3)
__device__ __forceinline__ void frag_a_acc_tf32(uint32_t* big,
                                                uint32_t* small,
                                                const float* t) {
  split_tf32(t[0], big[0], small[0]);
  split_tf32(t[2], big[1], small[1]);
  split_tf32(t[1], big[2], small[2]);
  split_tf32(t[3], big[3], small[3]);
}

}  // namespace
