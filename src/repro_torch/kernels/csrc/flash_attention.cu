// Blocked causal / sliding-window GQA prefill attention with an online
// softmax, for the port's dense transformer.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (reached through flash_attention).  For q (B, S, H, hd) and k, v
// (B, S, KV, hd), float32 or bfloat16, query head h reads kv head
// h / (H / KV) and, for every query position pq,
//     out[b, pq, h] = sum_pk p(pq, pk) v[b, pk, h / G]
// over the keys the mask admits: pk < S, pk <= pq when causal, and
// pq - pk < window when window != 0.  The softmax is the Pallas
// kernel's, in float32: scores (q . k) * scale, masked scores NEG_INF
// = -0.7 * FLT_MAX, a running max m, p = exp(s - m) (0 where masked),
// a running sum l and accumulator rescaled by exp(m_old - m_new), and
// out = acc / (l + 1e-30) in q's type, so a row with no admitted key
// gives 0.  Both kernels read the public (B, S, H, hd) layout through
// their own offsets (the Pallas wrapper's transposes to (B*H, S, hd)
// have no counterpart), skip the tiles past the block's last row under
// the causal mask and those before its first row's reach under a
// window, and mask a ragged last tile in the kernel.  The Pallas grid
// (B*H, S/bq, S/bk) runs its kv axis in order and keeps m, l and acc in
// VMEM scratch; on Hopper blocks run in no order, so the kv axis is a
// loop inside the block.
//
// Which kernel runs.  bfloat16 inputs run flash_attention_kernel_bf16,
// on the tensor cores; float32 inputs run flash_attention_kernel, on
// the CUDA cores (the tensor cores would round float32 through TF32,
// ~1e-3, far outside the float32 gate of 2e-5).
//
// bf16 design (FlashAttention-2, written by hand).  One block of 4
// warps serves 64 query rows of one (b, h); each warp owns 16 rows.
// A warp's q fragments are loaded once from global memory into
// registers.  The block walks tiles of 64 keys of kv head h / G, staged
// in shared memory as bf16 by 16-byte cp.async copies (rows past S
// zero-filled) through a ring of 3 stages (2 at hd 128), so two tiles
// are in flight while one is computed, with one __syncthreads per tile;
// at hd 64 the ring is 54 KB, so four blocks share an SM.  Shared rows
// are padded by 16 bytes, so the 8 rows an ldmatrix phase reads fall in
// distinct banks.  Q . K^T and P . V run as mma.sync m16n8k16 bf16 ->
// float32, fragments from ldmatrix (.trans for V).  The online softmax
// works on the score fragments in registers: a thread holds two rows'
// scores, the row max takes two quad shuffles, each score is
// exponentiated once (ex2 of s * scale * log2 e - m * scale * log2 e,
// one fma), and the
// row sums stay per thread until the epilogue's two quad shuffles.  P
// is converted to bf16 in registers and used as P . V's A operand with
// no trip through shared memory.  Rounding P to one bf16 moves the
// output by up to 3.9e-3 before its own rounding, which flips bf16
// output roundings by 1.6e-2 (CPU estimates at the serve shape), too
// near the 2e-2 gate; so P is carried as two bf16 terms, hi = bf16(p)
// and lo = bf16(p - hi), and P . V is two mma per fragment, which keeps
// ~16 bits of p.  O accumulates in float32 registers; the epilogue
// divides by l + 1e-30 and writes bf16 pairs straight into (B, S, H,
// hd).  The query blocks of a (b, h) run heaviest first: blockIdx.y
// counts from the last block under the causal mask, and (b, h) is the
// fastest grid axis, so the longest rows of every head start first.
//
// float32 design.  One block of 128 threads serves (32 query rows,
// head h, batch row b): four threads per query row, each holding a
// quarter of the row's q and acc in registers; each 32-key tile is
// staged in shared memory as float32, a thread computes its partial dot
// for every key, two xor-shuffles give all four the full score, and
// each then updates its slice of acc.
//
// Bound.  At the long serve prompt (B 32, S 1,024, H 16, hd 64, bf16)
// the kernel must read q, k, v and write o, 268 MB, ~0.080 ms at
// 3.35 TB/s, and do 4 * B * H * hd * S (S + 1) / 2 ~ 69 GFLOP, ~0.069
// ms at 989 TFLOP/s on the tensor cores: ~0.08 ms a launch.  The bf16
// kernel's P . V is two products (hi and lo), so it issues 1.5 times
// the tensor-core work the bound counts, and recomputes nothing else;
// K and V are read once per 64-row query block (16 times at S 1,024),
// mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- float32

constexpr int kRows = 32;                  // query rows per block
constexpr int kLanes = 4;                  // threads per query row
constexpr int kKeys = 32;                  // keys per kv tile
constexpr int kThreads = kRows * kLanes;   // 128

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int H, int KV, float scale, int causal,
                       int window) {
  constexpr int kChunks = HD / 4;          // float4 chunks in a head row
  constexpr int kMine = kChunks / kLanes;  // chunks a thread holds
  static_assert(kChunks % kLanes == 0, "head_dim must be a multiple of 16");
  __shared__ float4 ks[kKeys][kChunks];
  __shared__ float4 vs[kKeys][kChunks];

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int pq = q0 + row;

  float4 qr[kMine];
  float4 acc[kMine];
  const float* qrow = q + ((static_cast<int64_t>(b) * S + pq) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    qr[i] = pq < S ? load4(qrow + 4 * (lane + kLanes * i))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  // keys any row of this block admits: [lo, hi)
  int hi = S;
  if (causal) hi = min(S, q0 + kRows);
  int lo = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo = reach <= 0 ? 0 : reach >= S ? S : static_cast<int>(reach);
  }

  for (int t0 = lo; t0 < hi; t0 += kKeys) {
    for (int e = tid; e < kKeys * kChunks; e += kThreads) {
      const int j = e / kChunks;
      const int c = e % kChunks;
      const int pk = t0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (pk < S) {
        const int64_t off =
            ((static_cast<int64_t>(b) * S + pk) * KV + kvh) * HD + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[kKeys];
    uint32_t admit = 0;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 kk = ks[j][lane + kLanes * i];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int pk = t0 + j;
      bool ok = pk < S;
      if (causal) ok = ok && pk <= pq;
      if (window != 0) ok = ok && pq - pk < window;
      s[j] = ok ? part * scale : kNegInf;
      admit |= static_cast<uint32_t>(ok) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = (admit >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 vv = vs[j][lane + kLanes * i];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (pq < S) {
    const float denom = l + 1e-30f;
    float* orow = out + ((static_cast<int64_t>(b) * S + pq) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      store4(orow + 4 * (lane + kLanes * i),
             make_float4(acc[i].x / denom, acc[i].y / denom,
                         acc[i].z / denom, acc[i].w / denom));
    }
  }
}

// --------------------------------------------------------------- bfloat16

constexpr int kBlockRows = 64;             // query rows per block
constexpr int kTileKeys = 64;              // keys per kv tile
constexpr int kWarpThreads = 128;          // 4 warps, 16 rows each

template <int HD>
struct Bf16Tile {
  static constexpr int kStride = HD + 8;   // bf16 per padded smem row
  static constexpr int kElems = 64 * kStride;
  static constexpr int kStages = HD == 128 ? 2 : 3;
  // the K ring, then the V ring (q goes straight to registers)
  static constexpr int kSmemBytes = 2 * kStages * kElems * 2;
};

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// c (16 x 8, float32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// 64 rows of head `head` from row `row0` of a (B, S, heads, HD) tensor
// into a padded shared tile; rows at or past S are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int b,
                                          int S, int heads, int head,
                                          int row0) {
  constexpr int kChunks = HD / 8;          // 16-byte chunks per row
  constexpr int kStride = Bf16Tile<HD>::kStride;
  static_assert(64 * kChunks % kWarpThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kWarpThreads; ++i) {
    const int c = threadIdx.x + i * kWarpThreads;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const int pos = row0 + r;
    const bool ok = pos < S;
    const __nv_bfloat16* g =
        src + ((static_cast<int64_t>(b) * S + (ok ? pos : 0)) * heads +
               head) * HD + ch * 8;
    cp_async16(dst + r * kStride + ch * 8, g, ok);
  }
}

// at hd 32 and 64, four blocks an SM (at most 128 registers a thread,
// which the hd 64 kernel fits without spilling); hd 128 needs 250
template <int HD>
__global__ void __launch_bounds__(kWarpThreads, HD == 128 ? 1 : 4)
flash_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int S, int H,
                            int KV, float scale_log2, int causal,
                            int window) {
  // scores stay unscaled until the exponent: p = exp2(s * c - m * c)
  using Tile = Bf16Tile<HD>;
  constexpr int kStride = Tile::kStride;
  constexpr int kStages = Tile::kStages;
  constexpr int kK = HD / 16;              // k-steps of Q . K^T
  constexpr int kD = HD / 8;               // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kStages * Tile::kElems;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockRows;
  const int kvh = h / (H / KV);

  // keys any row of this block admits: [lo, hi)
  const int hi = causal ? min(S, q0 + kBlockRows) : S;
  int lo = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo = reach <= 0 ? 0 : reach >= S ? S : static_cast<int>(reach);
  }
  const int n_tiles = hi > lo ? (hi - lo + kTileKeys - 1) / kTileKeys : 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      load_rows<HD>(ks + st * Tile::kElems, k, b, S, KV, kvh,
                    lo + st * kTileKeys);
      load_rows<HD>(vs + st * Tile::kElems, v, b, S, KV, kvh,
                    lo + st * kTileKeys);
    }
    cp_async_commit();
  }

  // this thread's rows: pq0 and pq0 + 8; its q fragments (A of Q . K^T:
  // rows pq0 / pq1, columns 2 (lane % 4) + {0, 1} and + 8 of each
  // 16-wide k-step) straight from global memory, 0 past S
  const int pq0 = q0 + warp * 16 + lane / 4;
  const int pq1 = pq0 + 8;
  const int col = 2 * (lane & 3);
  uint32_t qf[kK][4];
  {
    const __nv_bfloat16* r0 =
        q + ((static_cast<int64_t>(b) * S + pq0) * H + h) * HD + col;
    const __nv_bfloat16* r1 = r0 + static_cast<int64_t>(8) * H * HD;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      qf[kk][0] = pq0 < S ? *reinterpret_cast<const uint32_t*>(r0 + kk * 16)
                          : 0u;
      qf[kk][1] = pq1 < S ? *reinterpret_cast<const uint32_t*>(r1 + kk * 16)
                          : 0u;
      qf[kk][2] = pq0 < S
                      ? *reinterpret_cast<const uint32_t*>(r0 + kk * 16 + 8)
                      : 0u;
      qf[kk][3] = pq1 < S
                      ? *reinterpret_cast<const uint32_t*>(r1 + kk * 16 + 8)
                      : 0u;
    }
  }
  float o[kD][4];
#pragma unroll
  for (int t = 0; t < kD; ++t)
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;        // running max (unscaled)
  float l0 = 0.f, l1 = 0.f;                // this thread's share of l

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nxt = i + kStages - 1;
      if (nxt < n_tiles) {
        const int st = nxt % kStages;
        load_rows<HD>(ks + st * Tile::kElems, k, b, S, KV, kvh,
                      lo + nxt * kTileKeys);
        load_rows<HD>(vs + st * Tile::kElems, v, b, S, KV, kvh,
                      lo + nxt * kTileKeys);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* kt = ks + (i % kStages) * Tile::kElems;
    const __nv_bfloat16* vt = vs + (i % kStages) * Tile::kElems;
    const int t0 = lo + i * kTileKeys;

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], r[2], r[3]);
      }
    }

    // mask only a tile the mask cuts
    const bool cut =
        t0 + kTileKeys > S || (causal && t0 + kTileKeys - 1 > q0) ||
        (window != 0 && static_cast<int64_t>(t0) <=
                            static_cast<int64_t>(q0) + kBlockRows - 1 -
                                window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e];
        if (cut) {
          const int pk = t0 + t * 8 + 2 * (lane & 3) + (e & 1);
          const int pq = e < 2 ? pq0 : pq1;
          bool ok = pk < S;
          if (causal) ok = ok && pk <= pq;
          if (window != 0) ok = ok && pq - pk < window;
          x = ok ? x : kNegInf;
        }
        s[t][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row with nothing admitted yet keeps m = NEG_INF; subtracting 0
    // then sends its masked scores to exp2(NEG_INF) = 0
    const float base0 = mx0 == kNegInf ? 0.f : mx0 * scale_log2;
    const float base1 = mx1 == kNegInf ? 0.f : mx1 * scale_log2;
    const float alpha0 = fast_exp2(fmaf(m0, scale_log2, -base0));
    const float alpha1 = fast_exp2(fmaf(m1, scale_log2, -base1));
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int t = 0; t < kD; ++t) {
      o[t][0] *= alpha0;
      o[t][1] *= alpha0;
      o[t][2] *= alpha1;
      o[t][3] *= alpha1;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = fast_exp2(fmaf(s[t][0], scale_log2, -base0));
      s[t][1] = fast_exp2(fmaf(s[t][1], scale_log2, -base0));
      s[t][2] = fast_exp2(fmaf(s[t][2], scale_log2, -base1));
      s[t][3] = fast_exp2(fmaf(s[t][3], scale_log2, -base1));
      l0 += s[t][0] + s[t][1];
      l1 += s[t][2] + s[t][3];
    }

    // O += P . V, P as hi + lo bf16 A fragments, 4 k-steps of 16 keys
#pragma unroll
    for (int js = 0; js < 4; ++js) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * js][0], s[2 * js][1], ph[0], pl[0]);
      split_bf16(s[2 * js][2], s[2 * js][3], ph[1], pl[1]);
      split_bf16(s[2 * js + 1][0], s[2 * js + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * js + 1][2], s[2 * js + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kD / 2; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, vt + (js * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kStride + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, r[0], r[1]);
        mma_bf16(o[2 * dp], pl, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], ph, r[2], r[3]);
        mma_bf16(o[2 * dp + 1], pl, r[2], r[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 + 1e-30f;
  const float d1 = l1 + 1e-30f;
  if (pq0 < S) {
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * S + pq0) * H + h) * HD + col;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(o[t][0] / d0, o[t][1] / d0);
  }
  if (pq1 < S) {
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * S + pq1) * H + h) * HD + col;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(o[t][2] / d1, o[t][3] / d1);
  }
}

// ----------------------------------------------------------------- launch

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KV, float scale, int causal, int window,
               cudaStream_t stream) {
  if (H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int KV, float scale, int causal,
                int window, cudaStream_t stream) {
  const int64_t heads = static_cast<int64_t>(B) * H;
  const int64_t blocks = (static_cast<int64_t>(S) + kBlockRows - 1) /
                         kBlockRows;
  if (heads > 0x7fffffff || blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Bf16Tile<HD>::kSmemBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel_bf16<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(heads),
                  static_cast<unsigned>(blocks));
  flash_attention_kernel_bf16<HD><<<grid, kWarpThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, H, KV, scale * kLog2e, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 (float32) launches flash_attention_kernel over a (ceil(S /
// 32), H, B) grid; dtype 1 (bfloat16) flash_attention_kernel_bf16 over
// a (B * H, ceil(S / 64)) grid; head_dim 32, 64 or 128; on `stream`.
// Returns the first CUDA error of setting the shared-memory size or of
// the launch, 0 if none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int S, int H, int KV, int hd,
                                      int dtype, float scale, int causal,
                                      int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (hd) {
      case 32:
        return launch_f32<32>(q, k, v, out, B, S, H, KV, scale, causal,
                              window, st);
      case 64:
        return launch_f32<64>(q, k, v, out, B, S, H, KV, scale, causal,
                              window, st);
      case 128:
        return launch_f32<128>(q, k, v, out, B, S, H, KV, scale, causal,
                               window, st);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32:
        return launch_bf16<32>(q, k, v, out, B, S, H, KV, scale, causal,
                               window, st);
      case 64:
        return launch_bf16<64>(q, k, v, out, B, S, H, KV, scale, causal,
                               window, st);
      case 128:
        return launch_bf16<128>(q, k, v, out, B, S, H, KV, scale, causal,
                                window, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
