// Absorbed multi-head latent attention (MLA) decode for the port's
// DeepSeek-V2 layers: one query token per batch row against its latent
// cache, split across the cache axis.
//
// Replaces no TPU kernel.  The reference computes this attention in
// float32 einsums outside any Pallas kernel (src/repro/models/
// attention.py, mla_decode, the chain from q_abs to ctx).  With the key
// absorbed into the query, every query head attends to one latent row
// per position: for q_abs (B, H, R) and q_pe (B, H, P) in float32, a
// cache c_kv (B, S, R) and k_pe (B, S, P) in float32 or bfloat16, and
// int32 lengths (B,), head h of row b scores position t as
//   s[h, t] = (q_abs[h] . c_kv[t] + q_pe[h] . k_pe[t]) * scale
// over the positions t <= lengths[b] (the slot at lengths[b] already
// holds the new token) and, when window != 0, lengths[b] - t < window,
// and writes the float32 context
//   ctx[h] = sum_t softmax(s[h])_t c_kv[t]          (B, H, R).
// The value is the key's first R columns.  The softmax is the
// reference's in float32: masked scores NEG_INF = -0.7 * FLT_MAX, a
// running max m, p = exp(s - m) (0 where masked), a running sum l and
// ctx = acc / (l + 1e-30), so a row with no admitted position gives 0.
// Built for DeepSeek-V2-Lite's widths: H 16, R 512 (kv_lora_rank), P 64
// (qk_rope_head_dim); the scale is 192^-0.5 there, passed in.
//
// Design.  It is multi-query attention with a 576-wide key, so a block
// serves all H heads of one (row b, split) and stages each latent row
// once, as float32, for both products.  Block (split, b) of 512 threads
// walks the positions of its slice [split * chunk, (split + 1) * chunk),
// clipped on the device to the row's admitted interval [lo, hi) (lo =
// max(0, len - window + 1) under a window, hi = min(S, len + 1)), in
// tiles of 32 positions:
//   1. stage the tile's 32 rows of c_kv ‖ k_pe in shared memory, one
//      lane a row (rows padded to 577 floats, so the lanes of a warp hit
//      distinct banks in every phase); rows past the interval are 0;
//   2. scores: warp w takes heads 4 (w % 4) ... + 3 and a quarter of the
//      576 columns, lane t position t; q sits in shared memory
//      transposed, so the four heads' q values are one broadcast float4
//      a column; the four quarters' partial sums are added in a fixed
//      order;
//   3. softmax: warp h reduces head h's tile max and sum with shuffles
//      and rescales its m, l;
//   4. p . v: thread r keeps column r of the context for all 16 heads in
//      registers, rescales it by each head's exp(m_old - m_new) and adds
//      p[t, h] c_kv[t, r] over the tile (p read as broadcast float4s).
// With one split a block writes ctx itself.  With more, each writes its
// float32 partial (m, l, acc[H, R]) to a workspace (an empty slice: m =
// NEG_INF, l = 0, acc = 0) and a second kernel, a block per (head, row),
// merges them in split order, so the bits never depend on which block
// ran first.
//
// Bound.  Decoding reads the admitted cache once: at the long serve
// shape (B 32, cache 1,057, bf16) 32 * 1,057 * 576 * 2 B = 39.0 MB,
// ~0.0116 ms at 3.35 TB/s; the products are 4 * H * 544 flops a
// position (~1.2 GFLOP), under the bytes at the tensor cores' rate, but
// this kernel runs them on the CUDA cores at 34 multiply-adds a staged
// byte, so its shared-memory reads of the score phase, not the bytes,
// bound it: it is a simple kernel first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;                     // positions per tile: one a lane
constexpr int kMaxSplits = 64;             // the merge's shared arrays

__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const float*) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int H, int R, int P>
struct Layout {
  static constexpr int kK = R + P;         // key width
  static constexpr int kPitch = kK + 1;    // floats a staged row
  static constexpr int kParts = kWarps / (H / 4);  // column parts
  static constexpr int kCols = kK / kParts;
  static_assert(H % 4 == 0 && kWarps % (H / 4) == 0 && kK % kParts == 0,
                "score split");
  static_assert(R == kThreads && H <= kWarps, "one thread a context column,"
                " one warp a head");
  // offsets in floats
  static constexpr int kC = 0;                       // kT x kPitch
  static constexpr int kQ = kC + kT * kPitch;        // kK x H
  static constexpr int kPart = kQ + kK * H;          // kParts x kT x H
  static constexpr int kP = kPart + kParts * kT * H; // kT x H
  static constexpr int kM = kP + kT * H;             // H
  static constexpr int kL = kM + H;                  // H
  static constexpr int kAlpha = kL + H;              // H
  static constexpr int kFloats = kAlpha + H;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kQ % 4 == 0 && kP % 4 == 0, "float4 rows");
};

template <typename T, int H, int R, int P>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const float* __restrict__ q_abs,
                  const float* __restrict__ q_pe, const T* __restrict__ c_kv,
                  const T* __restrict__ k_pe,
                  const int* __restrict__ lengths, float* __restrict__ out,
                  float* __restrict__ ws, int S, float scale, int window,
                  int chunk, int splits) {
  using L = Layout<H, R, P>;
  constexpr int kK = L::kK;
  constexpr int kPitch = L::kPitch;
  constexpr int kE = 16 / sizeof(T);       // elements a 16-byte chunk
  constexpr int kRChunks = R / kE;
  constexpr int kRowChunks = (R + P) / kE;
  static_assert(R % kE == 0 && P % kE == 0, "16-byte chunks");
  extern __shared__ __align__(16) float smem[];
  float* cs = smem + L::kC;
  float* qt = smem + L::kQ;
  float* part = smem + L::kPart;
  float* ps = smem + L::kP;
  float* m_s = smem + L::kM;
  float* l_s = smem + L::kL;
  float* alpha_s = smem + L::kAlpha;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int split = blockIdx.x;
  const int b = blockIdx.y;

  // the admitted interval, clipped to this block's slice
  const int len = lengths[b];
  const int64_t hi64 = min(static_cast<int64_t>(S),
                           static_cast<int64_t>(len) + 1);
  int64_t lo64 = 0;
  if (window != 0) lo64 = max(lo64, static_cast<int64_t>(len) - window + 1);
  const int64_t s0 = static_cast<int64_t>(split) * chunk;
  const int lo = static_cast<int>(max(lo64, s0));
  const int hi = static_cast<int>(min(hi64, s0 + chunk));

  // q transposed: qt[j * H + h], the absorbed query then the rope part
  for (int e = tid; e < H * kK; e += kThreads) {
    const int h = e / kK;
    const int j = e % kK;
    qt[j * H + h] = j < R ? q_abs[(static_cast<int64_t>(b) * H + h) * R + j]
                          : q_pe[(static_cast<int64_t>(b) * H + h) * P + j - R];
  }
  if (tid < H) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = 0.f;

  const int hq = warp % (H / 4);           // heads 4 hq ... 4 hq + 3
  const int kq = warp / (H / 4);           // columns [kq kCols, + kCols)
  const T* crow = c_kv + static_cast<int64_t>(b) * S * R;
  const T* prow = k_pe + static_cast<int64_t>(b) * S * P;

  for (int t0 = lo; t0 < hi; t0 += kT) {
    const int n = min(kT, hi - t0);
    __syncthreads();                       // the last tile is consumed
    // 1. stage: lane = row, the warps over the 16-byte chunks
    for (int ch = warp; ch < kRowChunks; ch += kWarps) {
      float v[kE];
      if (lane < n) {
        const uint4 u =
            ch < kRChunks
                ? *reinterpret_cast<const uint4*>(
                      crow + static_cast<int64_t>(t0 + lane) * R + ch * kE)
                : *reinterpret_cast<const uint4*>(
                      prow + static_cast<int64_t>(t0 + lane) * P +
                      (ch - kRChunks) * kE);
        unpack(u, v, static_cast<const T*>(nullptr));
      } else {
#pragma unroll
        for (int i = 0; i < kE; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kE; ++i) cs[lane * kPitch + ch * kE + i] = v[i];
    }
    __syncthreads();

    // 2. partial scores of 4 heads at position lane over a column part
    {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      const float* crow_s = cs + lane * kPitch + kq * L::kCols;
      const float* qcol = qt + kq * L::kCols * H + 4 * hq;
#pragma unroll 8
      for (int j = 0; j < L::kCols; ++j) {
        const float c = crow_s[j];
        const float4 q4 = *reinterpret_cast<const float4*>(qcol + j * H);
        s4[0] = fmaf(q4.x, c, s4[0]);
        s4[1] = fmaf(q4.y, c, s4[1]);
        s4[2] = fmaf(q4.z, c, s4[2]);
        s4[3] = fmaf(q4.w, c, s4[3]);
      }
      *reinterpret_cast<float4*>(part + (kq * kT + lane) * H + 4 * hq) =
          make_float4(s4[0], s4[1], s4[2], s4[3]);
    }
    __syncthreads();

    // 3. softmax statistics: warp h, lane t
    if (warp < H) {
      const int h = warp;
      float s = part[lane * H + h];
#pragma unroll
      for (int k = 1; k < L::kParts; ++k) s += part[(k * kT + lane) * H + h];
      const bool ok = lane < n;
      s = ok ? s * scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[lane * H + h] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // 4. acc[h] (column tid) <- acc[h] alpha[h] + sum_t p[t, h] c[t, tid]
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] *= alpha_s[h];
    for (int t = 0; t < n; ++t) {
      const float c = cs[t * kPitch + tid];
#pragma unroll
      for (int h4 = 0; h4 < H / 4; ++h4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + t * H + 4 * h4);
        acc[4 * h4] = fmaf(p4.x, c, acc[4 * h4]);
        acc[4 * h4 + 1] = fmaf(p4.y, c, acc[4 * h4 + 1]);
        acc[4 * h4 + 2] = fmaf(p4.z, c, acc[4 * h4 + 2]);
        acc[4 * h4 + 3] = fmaf(p4.w, c, acc[4 * h4 + 3]);
      }
    }
  }
  __syncthreads();

  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      out[(static_cast<int64_t>(b) * H + h) * R + tid] =
          acc[h] / (l_s[h] + 1e-30f);
    return;
  }
  // the partial: m, l (splits, B, H) and acc (splits, B, H, R)
  const int64_t rows = static_cast<int64_t>(gridDim.y) * H;
  const int64_t me = static_cast<int64_t>(split) * rows +
                     static_cast<int64_t>(b) * H;
  float* m_w = ws;
  float* l_w = ws + splits * rows;
  float* a_w = ws + 2 * splits * rows;
  if (tid < H) {
    m_w[me + tid] = m_s[tid];
    l_w[me + tid] = l_s[tid];
  }
#pragma unroll
  for (int h = 0; h < H; ++h) a_w[(me + h) * R + tid] = acc[h];
}

// Merge the splits' partials of (head h, row b), block (h, b), in split
// order: weights exp(m_s - max m), ctx = sum w_s acc_s / (sum w_s l_s +
// 1e-30).  The splits' m and l are read once into shared memory.
template <int H, int R>
__global__ void __launch_bounds__(R)
mla_decode_merge(const float* __restrict__ ws, float* __restrict__ out,
                 int splits) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float l_s[kMaxSplits];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r = threadIdx.x;
  const int64_t rows = static_cast<int64_t>(gridDim.y) * H;
  const int64_t row = static_cast<int64_t>(b) * H + h;
  const float* m_w = ws;
  const float* l_w = ws + splits * rows;
  const float* a_w = ws + 2 * splits * rows;
  if (r < splits) {
    w_s[r] = m_w[r * rows + row];
    l_s[r] = l_w[r * rows + row];
  }
  __syncthreads();
  float top = kNegInf;
  for (int s = 0; s < splits; ++s) top = fmaxf(top, w_s[s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(w_s[s] - top);
    l += l_s[s] * w;
    a += a_w[(s * rows + row) * R + r] * w;
  }
  out[row * R + r] = a / (l + 1e-30f);
}

template <typename T, int H, int R, int P>
int launch(const void* q_abs, const void* q_pe, const void* c_kv,
           const void* k_pe, const void* lengths, void* out, void* ws, int B,
           int S, float scale, int window, int chunk, int splits,
           cudaStream_t stream) {
  using L = Layout<H, R, P>;
  const auto kernel = mla_decode_kernel<T, H, R, P>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, B), kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(q_abs), static_cast<const float*>(q_pe),
      static_cast<const T*>(c_kv), static_cast<const T*>(k_pe),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(ws), S, scale, window, chunk, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  mla_decode_merge<H, R><<<dim3(H, B), R, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: q_abs (B, H, R) and q_pe (B, H, P) float32, a
// cache c_kv (B, S, R) and k_pe (B, S, P) of dtype 0 (float32) or 1
// (bfloat16), int32 lengths (B,), ctx out (B, H, R) float32; (H, R, P)
// is (16, 512, 64).  The (splits, B) grid serves slices of `chunk`
// positions (splits slices cover S); with splits > 1 the partials go
// to ws (splits B H (R + 2) floats; splits <= 64) and a merge kernel
// over (H, B) follows.
// c_kv and k_pe start 16-byte aligned.  Returns the first CUDA error of
// setting the shared-memory size or of a launch, 0 if none.
extern "C" int mla_decode_launch(const void* q_abs, const void* q_pe,
                                 const void* c_kv, const void* k_pe,
                                 const void* lengths, void* out, void* ws,
                                 int B, int S, int H, int R, int P,
                                 int dtype, float scale, int window,
                                 int chunk, int splits, void* stream) {
  if (B == 0) return 0;
  if (H != 16 || R != 512 || P != 64 || splits < 1 ||
      splits > kMaxSplits ||
      B > 65535 || chunk <= 0 ||
      static_cast<int64_t>(chunk) * splits < S ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 16, 512, 64>(q_abs, q_pe, c_kv, k_pe, lengths, out,
                                      ws, B, S, scale, window, chunk, splits,
                                      st);
  if (dtype == 1)
    return launch<__nv_bfloat16, 16, 512, 64>(q_abs, q_pe, c_kv, k_pe,
                                              lengths, out, ws, B, S, scale,
                                              window, chunk, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
