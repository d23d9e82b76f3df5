// Blocked causal / sliding-window GQA prefill attention with an online
// softmax, for the port's transformers (GQA, and MLA's expanded form).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (reached through flash_attention).  For q (B, S, H, hd), k (B, SK, KV,
// hd) and v (B, SK, KV, hdv), float32 or bfloat16, query head h reads kv
// head h / (H / KV) and, for every query position pq,
//     out[b, pq, h] = sum_pk p(pq, pk) v[b, pk, h / G]
// over the keys the mask admits: pk < SK, pk <= pq when causal, and
// pq - pk < window when window != 0.  The key length SK is S for
// self-attention; cross-attention (whisper's decoder over its encoder's
// 1,500 frames) attends S queries to SK = n_ctx keys with no mask, and
// the launcher refuses causal with SK != S.  The softmax is the Pallas
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
// The row log-sum-exp.  Given a float32 lse (B, H, S) (a null pointer
// writes none, and the kernels run as without it), each row also writes
// lse = m * scale + log(l) in natural-log units of the scaled scores, or
// +inf for a row with no admitted key; the backward
// (flash_attention_backward.cu) recomputes P = exp(s * scale - lse).
//
// Which kernel runs.  bfloat16 inputs run flash_attention_kernel_bf16,
// float32 inputs flash_attention_kernel_f32 (and, split, its merge),
// both on the tensor cores.
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
// float32 design (3xTF32, tensor_core.cuh).  The bf16 kernel's block,
// walk, masks and softmax, with float32 tiles: K and V tiles of 64 keys
// staged as float32 by 16-byte cp.async through a ring of 2 stages, rows
// padded by 4 floats so that the 32 lanes of a 32-bit fragment load fall
// in distinct banks.  Q . K^T and P . V run as mma.sync m16n8k8 tf32 ->
// float32, three per fragment (small . big, big . small, big . big):
// each operand is split into big = tf32(x) and small = x - big as it is
// loaded (q's raw fragments sit in registers at hd <=
// 64 and are read from a shared tile each k-step at hd 128 and (192,
// 128), where O's accumulators take the registers), and P is split in
// registers.  P enters P . V without a trip through shared memory: the C
// fragment of an 8-key n-tile is the A fragment of an 8-key k-step once
// the keys are relabelled (A's column c is key 2c, c + 4 is key 2c + 1),
// so V's B fragment reads rows 2c and 2c + 1.  3xTF32 keeps ~22 bits of
// every product: the CPU emulation (tests/test_torch_flash_tf32_tiles.py)
// holds the outputs within 0.08 of the 2e-5 gate, where one TF32 term
// misses it 3.5-70 times over.  A warp whose 16 rows all lie past S only
// helps stage the tiles (the cross prefill's 32 queries fill two warps).
//
// The split key axis (float32).  When a launch has fewer 64-row query
// blocks (B * H * ceil(S / 64)) than the card has SMs, the wrapper cuts
// each block's key range into `splits` pieces of `chunk` keys (whole
// tiles, so about two blocks an SM run): whisper's cross prefill at B
// 1 runs 16 blocks over 1,500 keys unsplit, 192 split in 12.  Piece z
// (blockIdx.z) walks the keys [lo + z chunk, lo + (z + 1) chunk) of its
// rows' range and writes float32 (m in log2 units, l, acc) to a
// workspace; flash_merge_kernel, one warp a row, combines the pieces in
// split order (max m, weights exp2(m_z - max), out = sum w acc / (l +
// 1e-30), lse from the merged m and l), B4's split-cache merge as a
// second launch.  The encoder (384 blocks at B 1) and the cross prefill
// at B 32 (512) do not split.
//
// Widths.  Both kernels take a (query/key width, value width) pair:
// (32, 32), (64, 64) and (128, 128) for GQA, and (192, 128) for
// DeepSeek-V2's MLA prefill (src/repro/models/attention.py, mla_forward:
// q, k (B, S, 16, 192) of nope 128 + rope 64, v (B, S, 16, 128), scale
// 192^-0.5).  In bf16 Q . K^T then takes 12 k-steps and O 16 n-tiles;
// the K ring holds 192-wide rows and the V ring 128-wide ones (86 KB in
// two stages).  The q fragments take 16 more registers than at hd 128,
// so the bf16 kernel runs at the 255-register ceiling there and spills
// 20 bytes a thread (ptxas -v): right first; staging q in shared memory
// and reading its fragments by ldmatrix would free them.
//
// Registers and shared memory of the float32 kernel (ptxas -v, sm_90a,
// CUDA 12 on the H100; two blocks an SM at hd 32 and 64, one above; the
// merge kernel 32 registers):
//   (32, 32)    179 registers, no spill; 36,864 bytes
//   (64, 64)    255 registers, no spill; 69,632 bytes
//   (128, 128)  255 registers, no spill; 168,960 bytes (q's tile shared)
//   (192, 128)  255 registers, spilling 200 bytes a thread; 218,112
//               bytes (q's tile shared)
//
// Bound.  At the long serve prompt (B 32, S 1,024, H 16, hd 64, bf16)
// the kernel must read q, k, v and write o, 268 MB, ~0.080 ms at
// 3.35 TB/s, and do 4 * B * H * hd * S (S + 1) / 2 ~ 69 GFLOP, ~0.069
// ms at 989 TFLOP/s on the tensor cores: ~0.08 ms a launch.  The bf16
// kernel's P . V is two products (hi and lo), so it issues 1.5 times
// the tensor-core work the bound counts, and recomputes nothing else;
// K and V are read once per 64-row query block (16 times at S 1,024),
// mostly from L2.  Whisper's encoder (B 32, S 1,500, 16 x 64, unmasked,
// float32 under the engine's float32 frames) does 4 * B * H * hd * S^2
// ~ 295 GFLOP, three TF32 products each at 495 TFLOP/s: ~1.79 ms (its
// bytes, 786 MB, take 0.235 ms); its cross-attention (32 queries over
// SK = 1,500 keys) is bound by reading K and V once, 393 MB in float32,
// ~0.12 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// --------------------------------------------------------------- bfloat16

constexpr int kBlockRows = 64;             // query rows per block
constexpr int kTileKeys = 64;              // keys per kv tile
constexpr int kWarpThreads = 128;          // 4 warps, 16 rows each

template <int HDQ, int HDV>
struct Bf16Tile {
  static constexpr int kKStride = HDQ + 8; // bf16 per padded smem row
  static constexpr int kVStride = HDV + 8;
  static constexpr int kKElems = 64 * kKStride;
  static constexpr int kVElems = 64 * kVStride;
  static constexpr int kStages = HDQ + HDV >= 256 ? 2 : 3;
  // the K ring, then the V ring (q goes straight to registers)
  static constexpr int kSmemBytes = kStages * (kKElems + kVElems) * 2;
};

// 64 rows of head `head` from row `row0` of a (B, S, heads, HD) tensor
// into a shared tile padded by 16 bytes a row; rows at or past S are
// zero-filled (S is the key length SK where the kernel stages k and v)
template <int HD, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int b, int S,
                                          int heads, int head, int row0) {
  constexpr int kPer = 16 / sizeof(T);     // elements per 16-byte chunk
  constexpr int kChunks = HD / kPer;       // 16-byte chunks per row
  constexpr int kStride = HD + kPer;       // elements per padded smem row
  static_assert(64 * kChunks % kWarpThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kWarpThreads; ++i) {
    const int c = threadIdx.x + i * kWarpThreads;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const int pos = row0 + r;
    const bool ok = pos < S;
    const T* g = src + ((static_cast<int64_t>(b) * S + (ok ? pos : 0)) *
                            heads + head) * HD + ch * kPer;
    cp_async16(dst + r * kStride + ch * kPer, g, ok);
  }
}

// at hd 32 and 64, four blocks an SM (at most 128 registers a thread,
// which the hd 64 kernel fits without spilling); hd 128 needs 250.
// HDQ is q's and k's width, HDV v's and the output's.
template <int HDQ, int HDV>
__global__ void __launch_bounds__(kWarpThreads, HDQ + HDV >= 256 ? 1 : 4)
flash_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int S, int SK, int H,
                            int KV, float scale_log2, int causal,
                            int window) {
  // scores stay unscaled until the exponent: p = exp2(s * c - m * c)
  using Tile = Bf16Tile<HDQ, HDV>;
  constexpr int kKStride = Tile::kKStride;
  constexpr int kVStride = Tile::kVStride;
  constexpr int kStages = Tile::kStages;
  constexpr int kK = HDQ / 16;             // k-steps of Q . K^T
  constexpr int kD = HDV / 8;              // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kStages * Tile::kKElems;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockRows;
  const int kvh = h / (H / KV);

  // keys any row of this block admits: [lo, hi)
  const int hi = causal ? min(SK, q0 + kBlockRows) : SK;
  int lo = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo = reach <= 0 ? 0 : reach >= SK ? SK : static_cast<int>(reach);
  }
  const int n_tiles = hi > lo ? (hi - lo + kTileKeys - 1) / kTileKeys : 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      load_rows<HDQ>(ks + st * Tile::kKElems, k, b, SK, KV, kvh,
                     lo + st * kTileKeys);
      load_rows<HDV>(vs + st * Tile::kVElems, v, b, SK, KV, kvh,
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
        q + ((static_cast<int64_t>(b) * S + pq0) * H + h) * HDQ + col;
    const __nv_bfloat16* r1 = r0 + static_cast<int64_t>(8) * H * HDQ;
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
        load_rows<HDQ>(ks + st * Tile::kKElems, k, b, SK, KV, kvh,
                       lo + nxt * kTileKeys);
        load_rows<HDV>(vs + st * Tile::kVElems, v, b, SK, KV, kvh,
                       lo + nxt * kTileKeys);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* kt = ks + (i % kStages) * Tile::kKElems;
    const __nv_bfloat16* vt = vs + (i % kStages) * Tile::kVElems;
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
        ldsm_x4(r, kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kKStride +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], r[2], r[3]);
      }
    }

    // mask only a tile the mask cuts
    const bool cut =
        t0 + kTileKeys > SK || (causal && t0 + kTileKeys - 1 > q0) ||
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
          bool ok = pk < SK;
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
                                  kVStride + dp * 16 + (lane >> 4) * 8);
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
  if (lse != nullptr && (lane & 3) == 0) {
    float* lrow = lse + (static_cast<int64_t>(b) * H + h) * S;
    if (pq0 < S)
      lrow[pq0] = l0 > 0.f ? (m0 * scale_log2 + log2f(l0)) * kLn2 : INFINITY;
    if (pq1 < S)
      lrow[pq1] = l1 > 0.f ? (m1 * scale_log2 + log2f(l1)) * kLn2 : INFINITY;
  }
  const float d0 = l0 + 1e-30f;
  const float d1 = l1 + 1e-30f;
  if (pq0 < S) {
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * S + pq0) * H + h) * HDV + col;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(o[t][0] / d0, o[t][1] / d0);
  }
  if (pq1 < S) {
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * S + pq1) * H + h) * HDV + col;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(o[t][2] / d1, o[t][3] / d1);
  }
}

// ---------------------------------------------------------------- float32

template <int HDQ, int HDV>
struct F32Tile {
  static constexpr int kKStride = HDQ + 4; // floats per padded k (q) row
  static constexpr int kVStride = HDV + 4;
  static constexpr int kKElems = 64 * kKStride;
  static constexpr int kVElems = 64 * kVStride;
  static constexpr int kStages = 2;
  // q's fragments: raw float32 in registers at hd <= 64, else read from
  // a shared tile each k-step (registers: at hd 128 and (192, 128) O's
  // accumulators alone take 64 a thread)
  static constexpr bool kQShared = HDQ > 64;
  static constexpr int kKUnroll = kQShared ? 2 : HDQ / 8;
  // the K ring, the V ring, then q's tile where it is shared
  static constexpr int kSmemBytes =
      (kStages * (kKElems + kVElems) + (kQShared ? kKElems : 0)) * 4;
};

// hd 32 and 64: two blocks an SM (at most 255 registers a thread: at
// 168, for three, the hd 64 kernel spills and runs slower);
// hd 128 and (192, 128): one, which their shared memory allows
template <int HDQ, int HDV>
__global__ void __launch_bounds__(kWarpThreads, HDQ + HDV >= 256 ? 1 : 2)
flash_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
                           float* __restrict__ part, int S, int SK, int H,
                           int KV, float scale_log2, int causal, int window,
                           int chunk) {
  using Tile = F32Tile<HDQ, HDV>;
  constexpr int kKS = Tile::kKStride;
  constexpr int kVS = Tile::kVStride;
  constexpr int kStages = Tile::kStages;
  constexpr int kK = HDQ / 8;              // k-steps of Q . K^T
  constexpr int kD = HDV / 8;              // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kStages * Tile::kKElems;
  float* qs = vs + kStages * Tile::kVElems;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBlockRows;
  const int kvh = h / (H / KV);

  // keys any row of this block admits: [lo, hi); piece blockIdx.z of
  // gridDim.z takes the `chunk` keys (whole tiles) from lo + z chunk
  const int hi_all = causal ? min(SK, q0 + kBlockRows) : SK;
  int lo_all = 0;
  if (window != 0) {
    const int64_t reach = static_cast<int64_t>(q0) - window + 1;
    lo_all = reach <= 0 ? 0 : reach >= SK ? SK : static_cast<int>(reach);
  }
  const int64_t p0 =
      lo_all + static_cast<int64_t>(blockIdx.z) * static_cast<int64_t>(chunk);
  const int lo = p0 < hi_all ? static_cast<int>(p0) : hi_all;
  const int hi = p0 + chunk < hi_all ? static_cast<int>(p0 + chunk) : hi_all;
  const int n_tiles = hi > lo ? (hi - lo + kTileKeys - 1) / kTileKeys : 0;

  if constexpr (Tile::kQShared) load_rows<HDQ>(qs, q, b, S, H, h, q0);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      load_rows<HDQ>(ks + st * Tile::kKElems, k, b, SK, KV, kvh,
                     lo + st * kTileKeys);
      load_rows<HDV>(vs + st * Tile::kVElems, v, b, SK, KV, kvh,
                     lo + st * kTileKeys);
    }
    cp_async_commit();
  }

  // this thread's rows: pq0 and pq0 + 8; a warp whose rows all lie past
  // S (the cross prefill's 32 queries) only helps stage the tiles
  const int r0 = warp * 16;
  const int pq0 = q0 + r0 + g;
  const int pq1 = pq0 + 8;
  const bool live = q0 + r0 < S;
  // q's A fragments, raw (a0 (g, c), a1 (g+8, c), a2 (g, c+4), a3 (g+8,
  // c+4) of each 8-wide k-step), 0 past S
  float qr[Tile::kQShared ? 1 : kK][4];
  if constexpr (!Tile::kQShared) {
    const float* p0r = q + ((static_cast<int64_t>(b) * S + pq0) * H + h) *
                               HDQ + c;
    const float* p1r = p0r + static_cast<int64_t>(8) * H * HDQ;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      qr[kk][0] = pq0 < S ? p0r[8 * kk] : 0.f;
      qr[kk][1] = pq1 < S ? p1r[8 * kk] : 0.f;
      qr[kk][2] = pq0 < S ? p0r[8 * kk + 4] : 0.f;
      qr[kk][3] = pq1 < S ? p1r[8 * kk + 4] : 0.f;
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
        load_rows<HDQ>(ks + st * Tile::kKElems, k, b, SK, KV, kvh,
                       lo + nxt * kTileKeys);
        load_rows<HDV>(vs + st * Tile::kVElems, v, b, SK, KV, kvh,
                       lo + nxt * kTileKeys);
      }
      cp_async_commit();
    }
    if (!live) continue;
    const float* kt = ks + (i % kStages) * Tile::kKElems;
    const float* vt = vs + (i % kStages) * Tile::kVElems;
    const int t0 = lo + i * kTileKeys;

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys, 3xTF32
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    // q in registers: every k-step unrolled (static indices); shared:
    // two at a time, so the fragments do not take O's registers
#pragma unroll(Tile::kKUnroll)
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (Tile::kQShared) {
        frag_a_tf32(ab, as, qs, kKS, r0, 8 * kk);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(qr[kk][e], ab[e], as[e]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bb[2], bs[2];
        frag_b_tf32(bb, bs, kt, kKS, 8 * j, 8 * kk);
        mma_3xtf32(s[j], ab, as, bb, bs);
      }
    }

    // mask only a tile the mask cuts
    const bool cut =
        t0 + kTileKeys > SK || (causal && t0 + kTileKeys - 1 > q0) ||
        (window != 0 && static_cast<int64_t>(t0) <=
                            static_cast<int64_t>(q0) + kBlockRows - 1 -
                                window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (cut) {
          const int pk = t0 + t * 8 + 2 * c + (e & 1);
          const int pq = e < 2 ? pq0 : pq1;
          bool ok = pk < SK;
          if (causal) ok = ok && pk <= pq;
          if (window != 0) ok = ok && pq - pk < window;
          s[t][e] = ok ? s[t][e] : kNegInf;
        }
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
    for (int t = 0; t < 8; ++t) {
      s[t][0] = fast_exp2(fmaf(s[t][0], scale_log2, -base0));
      s[t][1] = fast_exp2(fmaf(s[t][1], scale_log2, -base0));
      s[t][2] = fast_exp2(fmaf(s[t][2], scale_log2, -base1));
      s[t][3] = fast_exp2(fmaf(s[t][3], scale_log2, -base1));
      l0 += s[t][0] + s[t][1];
      l1 += s[t][2] + s[t][3];
    }

    // the tile's P . V in zeroed fragments: each n-tile of P is the A
    // fragment of an 8-key k-step (keys relabelled), V's rows 2c and
    // 2c + 1 its B fragment.  The tensor cores' float32 sums truncate,
    // so O is not fed to them across the whole walk: O = O alpha + the
    // tile's sum, in round-to-nearest
    float ot[kD][4];
#pragma unroll
    for (int t = 0; t < kD; ++t)
      ot[t][0] = ot[t][1] = ot[t][2] = ot[t][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t pb[4], ps[4];
      frag_a_acc_tf32(pb, ps, s[j]);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        uint32_t bb[2], bs[2];
        frag_b_rows_tf32(bb, bs, vt, kVS, 8 * j, 8 * d);
        mma_3xtf32(ot[d], pb, ps, bb, bs);
      }
    }
#pragma unroll
    for (int t = 0; t < kD; ++t) {
      o[t][0] = fmaf(o[t][0], alpha0, ot[t][0]);
      o[t][1] = fmaf(o[t][1], alpha0, ot[t][1]);
      o[t][2] = fmaf(o[t][2], alpha1, ot[t][2]);
      o[t][3] = fmaf(o[t][3], alpha1, ot[t][3]);
    }
  }
  cp_async_wait_all();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  if (gridDim.z > 1) {
    // a piece: its float32 (m in log2 units, NEG_INF where nothing was
    // admitted; l; acc) at row ((z B + b) H + h) S + pq of the workspace
    // [m | l | acc], merged by flash_merge_kernel
    const int64_t rows = static_cast<int64_t>(gridDim.x) * S;
    const int64_t at = blockIdx.z * rows + bh * S;
    float* pm = part;
    float* pl = part + gridDim.z * rows;
    float* pa = part + 2 * gridDim.z * rows;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int pq = hf ? pq1 : pq0;
      if (pq >= S) continue;
      const float m = hf ? m1 : m0;
      if (c == 0) {
        pm[at + pq] = m == kNegInf ? kNegInf : m * scale_log2;
        pl[at + pq] = hf ? l1 : l0;
      }
      float* arow = pa + (at + pq) * HDV + 2 * c;
#pragma unroll
      for (int t = 0; t < kD; ++t)
        *reinterpret_cast<float2*>(arow + t * 8) =
            make_float2(o[t][2 * hf], o[t][2 * hf + 1]);
    }
    return;
  }
  if (lse != nullptr && c == 0) {
    float* lrow = lse + bh * S;
    if (pq0 < S)
      lrow[pq0] = l0 > 0.f ? (m0 * scale_log2 + log2f(l0)) * kLn2 : INFINITY;
    if (pq1 < S)
      lrow[pq1] = l1 > 0.f ? (m1 * scale_log2 + log2f(l1)) * kLn2 : INFINITY;
  }
  const float d0 = l0 + 1e-30f;
  const float d1 = l1 + 1e-30f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int pq = hf ? pq1 : pq0;
    if (pq >= S) continue;
    const float d = hf ? d1 : d0;
    float* orow = out + ((static_cast<int64_t>(b) * S + pq) * H + h) * HDV +
                  2 * c;
#pragma unroll
    for (int t = 0; t < kD; ++t)
      *reinterpret_cast<float2*>(orow + t * 8) =
          make_float2(o[t][2 * hf] / d, o[t][2 * hf + 1] / d);
  }
}

// The merge of a split launch: one warp a (b, h, row), the pieces in
// split order (the same bits from run to run): top = max m_z, weights
// w_z = exp2(m_z - top), l = sum w_z l_z, out = sum w_z acc_z / (l +
// 1e-30), lse = (top + log2 l) ln 2, +inf where l = 0.  rows = B H S.
template <int HDV>
__global__ void __launch_bounds__(kWarpThreads)
flash_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                   float* __restrict__ lse, int S, int H, int splits,
                   int64_t rows) {
  constexpr int kCols = HDV / 32;          // columns a lane
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kWarpThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* pm = part;
  const float* pl = part + splits * rows;
  const float* pa = part + 2 * splits * rows;
  float top = kNegInf;
  for (int z = 0; z < splits; ++z) top = fmaxf(top, pm[z * rows + row]);
  float l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  for (int z = 0; z < splits; ++z) {
    const int64_t at = z * rows + row;
    const float w = fast_exp2(pm[at] - top);
    l += w * pl[at];
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      acc[i] += w * pa[at * HDV + lane + 32 * i];
  }
  // row = (b H + h) S + pq
  const int pq = static_cast<int>(row % S);
  const int64_t bh = row / S;
  const int h = static_cast<int>(bh % H);
  const int64_t b = bh / H;
  float* orow = out + ((b * S + pq) * H + h) * HDV;
  const float d = l + 1e-30f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) orow[lane + 32 * i] = acc[i] / d;
  if (lse != nullptr && lane == 0)
    lse[row] = l > 0.f ? (top + log2f(l)) * kLn2 : INFINITY;
}

// ----------------------------------------------------------------- launch

// the float32 route: the kernel over a (B * H, ceil(S / 64), splits)
// grid, then, split, the merge
template <int HDQ, int HDV>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, float* part, int B, int S, int SK, int H, int KV,
               float scale, int causal, int window, int splits, int chunk,
               cudaStream_t stream) {
  const int64_t heads = static_cast<int64_t>(B) * H;
  const int64_t blocks = (static_cast<int64_t>(S) + kBlockRows - 1) /
                         kBlockRows;
  if (heads > 0x7fffffff || blocks > 65535 || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits == 1) {
    chunk = SK;
  } else if (part == nullptr || chunk < kTileKeys || chunk % kTileKeys != 0 ||
             static_cast<int64_t>(splits) * chunk < SK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = F32Tile<HDQ, HDV>::kSmemBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel_f32<HDQ, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(blocks),
                  static_cast<unsigned>(splits));
  flash_attention_kernel_f32<HDQ, HDV><<<grid, kWarpThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, part, S,
      SK, H, KV, scale * kLog2e, causal, window, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t rows = heads * S;
  const int64_t merge_blocks = (rows + kWarpThreads / 32 - 1) /
                               (kWarpThreads / 32);
  if (merge_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_merge_kernel<HDV><<<static_cast<unsigned>(merge_blocks), kWarpThreads,
                            0, stream>>>(part, static_cast<float*>(out), lse,
                                         S, H, splits, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int HDQ, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int SK, int H, int KV, float scale,
                int causal, int window, cudaStream_t stream) {
  const int64_t heads = static_cast<int64_t>(B) * H;
  const int64_t blocks = (static_cast<int64_t>(S) + kBlockRows - 1) /
                         kBlockRows;
  if (heads > 0x7fffffff || blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Bf16Tile<HDQ, HDV>::kSmemBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel_bf16<HDQ, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(heads),
                  static_cast<unsigned>(blocks));
  flash_attention_kernel_bf16<HDQ, HDV><<<grid, kWarpThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, S, SK, H, KV, scale * kLog2e,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 (float32) launches flash_attention_kernel_f32 over a (B * H,
// ceil(S / 64), splits) grid: with splits > 1 each block takes `chunk`
// keys (a multiple of 64, splits * chunk >= SK) of its rows' range and
// writes its partial into `part` (float32, splits * B * H * S * (2 +
// hdv)), and flash_merge_kernel writes out and lse; dtype 1 (bfloat16)
// launches flash_attention_kernel_bf16 over a (B * H, ceil(S / 64)) grid
// (splits must be 1).  S is q's length and SK k's and v's (SK == S
// unless causal is 0); (hd, hdv) is (32, 32), (64, 64), (128, 128) or
// (192, 128), hd q's and k's width, hdv v's and the output's; on
// `stream`.  A non-null lse (B, H, S) float32 takes each row's
// log-sum-exp (+inf where no key is admitted).  Returns the first CUDA
// error of setting the shared-memory size or of a launch, 0 if none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      void* part, int B, int S, int SK, int H,
                                      int KV, int hd, int hdv, int dtype,
                                      float scale, int causal, int window,
                                      int splits, int chunk, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0 || SK < 0 || (causal && SK != S) ||
      (dtype == 1 && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FA_ARGS q, k, v, out, l, B, S, SK, H, KV, scale, causal, window, st
#define F32_ARGS                                                          \
  q, k, v, out, l, static_cast<float*>(part), B, S, SK, H, KV, scale,     \
      causal, window, splits, chunk, st
  if (hd == 192 && hdv == 128) {
    if (dtype == 0) return launch_f32<192, 128>(F32_ARGS);
    if (dtype == 1) return launch_bf16<192, 128>(FA_ARGS);
  }
  if (hd == hdv && dtype == 0) {
    switch (hd) {
      case 32:
        return launch_f32<32, 32>(F32_ARGS);
      case 64:
        return launch_f32<64, 64>(F32_ARGS);
      case 128:
        return launch_f32<128, 128>(F32_ARGS);
    }
  } else if (hd == hdv && dtype == 1) {
    switch (hd) {
      case 32:
        return launch_bf16<32, 32>(FA_ARGS);
      case 64:
        return launch_bf16<64, 64>(FA_ARGS);
      case 128:
        return launch_bf16<128, 128>(FA_ARGS);
    }
  }
#undef F32_ARGS
#undef FA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
