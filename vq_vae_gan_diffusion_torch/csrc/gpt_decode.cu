// GPT decode stack for Hopper (sm_90a): one decode position through all L
// pre-LN transformer blocks.
//
// Replaces vq_vae_gan_diffusion_tpu/ops/gpt_decode_pallas.py::fused_decode_stack
// and the three bodies of fused_decode_stack_chunked: the float one
// (_chunked_kernel), the one on int8 or int4 weights (_chunked_kernel_q, B2b)
// and the one that also keeps an int8 KV cache (_chunked_kernel_qkv, B2c).
// The function is the one reference_decode_stack in ops/gpt_decode.py computes:
// per layer LN1 -> joint QKV [3C, C] -> attention over cache rows < t with the
// current token's k/v folded into the softmax -> proj + residual -> LN2 ->
// fc1 -> exact-erf GELU -> fc2 + residual. The residual stream, LN and softmax
// statistics are f32; weights and the KV cache are float or bf16, with f32
// accumulation. Operands are rounded to the weight type where the reference
// rounds them: LN outputs, q for the history dot, the softmax weights for the
// V sum, the attention output and the GELU output.
//
// What bounds it: at decode batch 16 every weight serves 16 rows only (about
// 8 FLOP per weight byte in f32 and 16 in bf16, against a ridge of ~20 for
// f32 CUDA cores and ~295 for bf16 tensor cores), so the kernel is bound by
// device-memory bytes: the 12*C^2 weights per layer plus the L*B*t*2C cache
// rows it reads. What the design does about it:
//   - every weight byte is read once per token, with 16-byte loads that a
//     warp issues for its whole K slice before it waits on any of them;
//   - the products are split over K (slices of <= 256 columns) so that even
//     the C-wide outputs (proj, fc2) fill two blocks on every SM; the B
//     activation rows of a slice sit in shared memory, staged once for the
//     block's 32 weight rows, and each value read there serves 4 of them;
//   - a warp's 4 x 16 dot products are reduced over its lanes by one
//     reduce-scatter (62 shuffles, not 320);
//   - the split partial sums meet in the next small kernel (attention,
//     LayerNorm or GELU), which adds them in a fixed order, so results are
//     deterministic and no extra pass over the activations is made;
//   - attention reads only the cache rows < t, 16 bytes a lane.
// No TMA, tensor cores or persistent grid yet. The bf16 products run on the
// CUDA cores, whose f32 FMA rate (a ridge of ~20 FLOP/byte) they come close
// to at 16 FLOP/byte; the tensor cores (mma.sync m16n8k16, one M tile for
// B = 16) are the next step there.
//
// Quantized weights (B2b) are the same GEMV on integer levels: int8, or int4
// packed two a byte (element 2k in the low nibble of byte k), each with one
// f32 scale per output row and group of the contraction axis. A lane loads 8
// levels (8 bytes of int8, 4 of int4), as many as a 16-byte bf16 load holds,
// so a warp covers the same 256 columns and the lane mapping, staging and
// reduce-scatter stay as they are; the levels convert exactly to f32. The K
// split is chosen so that no slice straddles a scale group, and each block
// multiplies its partial sums by its slice's group scale before writing them:
// the reference's "scale each group's partial, then add", in another order.
// At batch 16 in f32, int8 weights move 12 C^2 bytes a layer and int4 half
// that, so the bound moves from bytes towards the f32 FMA rate.
//
// The int8 KV cache (B2c) keeps k and v rows as int8 with one f32 scale
// each per (layer, batch row, position), in scales [L, B, N, 2]. The
// attention kernel dequantizes 16 levels a 16-byte load, multiplies each
// history score by its row's k-scale and each softmax weight by its row's
// v-scale before the V sum, and keeps the current token's own term in f32.
// The new row needs the max over all C lanes of k and of v across heads, so
// one small block a batch row (kv_quantize_kernel) gathers them from the
// QKV partials and writes the int8 row and its two scales.
//
// Launches go on the caller's stream; nothing is allocated or synchronised
// here. The caller commits kv_new (and, for an int8 cache, sc_new) into the
// cache at row t itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;         // warps per GEMV block
constexpr int kRowsPerWarp = 4;   // output rows of W per warp
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kBT = 16;           // activation rows per GEMV block
constexpr int kKT = 256;          // the largest K slice of a GEMV block
constexpr int kTargetBlocks = 2 * 132;  // two resident GEMV blocks on each of 132 SMs
constexpr int kAttnThreads = 256;
constexpr int kRowThreads = 1024;
constexpr int kRowPer = 4;        // C <= kRowPer * kRowThreads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the value a cast to the compute type would hold
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// the two bf16 values packed in u (the first in the low half) as floats
__device__ __forceinline__ float2 bf16x2_to_float2(unsigned u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// 16 bytes of T: n values, loaded raw and unpacked to floats, all n at once
// (unpack) or four at a time (quad q holds values 4q .. 4q + 3)
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  using raw = float4;
  __device__ __forceinline__ static void unpack(const raw& v, float* out) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static float4 quad(const raw& v, int) { return v; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  using raw = uint4;
  __device__ __forceinline__ static void unpack(const raw& v, float* out) {
    const float4 a = quad(v, 0), b = quad(v, 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  __device__ __forceinline__ static float4 quad(const raw& v, int q) {
    const float2 lo = bf16x2_to_float2(q ? v.z : v.x), hi = bf16x2_to_float2(q ? v.w : v.y);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

// the signed byte i (0..3) of u, and the signed nibble i (0..7) of u, as floats
__device__ __forceinline__ float s8(unsigned u, int i) {
  return (float)((int)(u << (24 - 8 * i)) >> 24);
}
__device__ __forceinline__ float s4(unsigned u, int i) {
  return (float)((int)(u << (28 - 4 * i)) >> 28);
}

// Weight storage tags: int8 levels, and int4 levels packed two a byte.
struct Int8W {};
struct Int4W {};
template <> struct Vec<Int8W> {   // 8 levels in 8 bytes
  static constexpr int n = 8;
  using raw = uint2;
  __device__ __forceinline__ static float4 quad(const raw& v, int q) {
    const unsigned u = q ? v.y : v.x;
    return make_float4(s8(u, 0), s8(u, 1), s8(u, 2), s8(u, 3));
  }
};
template <> struct Vec<Int4W> {   // 8 levels in 4 bytes
  static constexpr int n = 8;
  using raw = unsigned;
  __device__ __forceinline__ static float4 quad(const raw& u, int q) {
    return make_float4(s4(u, 4 * q), s4(u, 4 * q + 1), s4(u, 4 * q + 2), s4(u, 4 * q + 3));
  }
};
// the int8 KV cache: 16 levels in 16 bytes
template <> struct Vec<int8_t> {
  static constexpr int n = 16;
  using raw = uint4;
  __device__ __forceinline__ static void unpack(const raw& v, float* out) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = s8(w[i / 4], i % 4);
  }
};

template <typename W> constexpr int kBits = 8 * sizeof(W);
template <> constexpr int kBits<Int8W> = 8;
template <> constexpr int kBits<Int4W> = 4;

template <typename T>
__device__ __forceinline__ typename Vec<T>::raw load16(const T* p) {
  return __ldg(reinterpret_cast<const typename Vec<T>::raw*>(p));
}

// element i of a weight matrix stored as W, and the Vec<W>::n after it
template <typename W>
__device__ __forceinline__ typename Vec<W>::raw load_w(const void* w, size_t i) {
  return __ldg(reinterpret_cast<const typename Vec<W>::raw*>(
      static_cast<const char*>(w) + i * kBits<W> / 8));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums each of the kN values of v over the warp's lanes, and leaves the sums
// spread over the lanes: afterwards v[i] of lane l, i < kN / 32, holds the sum
// of value (kN / 32) * l + i. Each step trades half of the values still held
// with the lane `off` away, so the warp makes kN - kN / 32 shuffles in all
// where a warp_sum of every value would make 5 * kN. Call with m = kN.
template <int kN, int m>
__device__ __forceinline__ void warp_reduce_scatter(float* v, int lane) {
  static_assert(kN % 32 == 0, "kN must be a multiple of the warp width");
  if constexpr (m * 16 >= kN) {
    constexpr int off = m * 16 / kN;
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < m / 2; ++i) {
      const float send = upper ? v[i] : v[i + m / 2];
      const float keep = upper ? v[i + m / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    warp_reduce_scatter<kN, m / 2>(v, lane);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum or max over the block (blockDim.x a multiple of 32). Every thread must
// call it; it synchronises the block, so shared writes before it are visible
// after it.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // a previous reduction may still read scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int i = 1; i < nw; ++i) r = kMax ? fmaxf(r, scratch[i]) : r + scratch[i];
  return r;
}

// the split partial sums of output idx (stride between splits) plus the bias
__device__ __forceinline__ float gather(const float* part, int split, size_t stride,
                                        size_t idx, float bias) {
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < split; ++z) s += part[z * stride + idx];
  return s + bias;
}

// One block per row b of the residual stream x [B, C], C <= kRowPer *
// kRowThreads; each thread holds its kRowPer values of the row in registers:
//   if split > 0: x[b] += the split partials of a [B, C] product + pbias;
//   if scale != nullptr: xn[b] = LayerNorm(x[b]) (eps 1e-5), rounded to T.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
residual_layernorm_kernel(float* __restrict__ x, const float* __restrict__ part, int split,
                          const float* __restrict__ pbias, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* __restrict__ xn, int B,
                          int C) {
  __shared__ float scratch[32];
  float* row = x + (size_t)blockIdx.x * C;
  float v[kRowPer];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kRowPer; ++k) {
    const int i = threadIdx.x + k * kRowThreads;
    v[k] = 0.f;
    if (i < C) {
      v[k] = row[i];
      if (split > 0) {
        v[k] += gather(part, split, (size_t)B * C, (size_t)blockIdx.x * C + i, pbias[i]);
        row[i] = v[k];
      }
      s += v[k];
    }
  }
  if (scale == nullptr) return;
  const float mu = block_reduce<false>(s, scratch) / C;
  float var = 0.f;
#pragma unroll
  for (int k = 0; k < kRowPer; ++k) {
    const float d = v[k] - mu;
    if (threadIdx.x + k * kRowThreads < C) var += d * d;
  }
  const float rstd = rsqrtf(block_reduce<false>(var, scratch) / C + 1e-5f);
  float* o = xn + (size_t)blockIdx.x * C;
#pragma unroll
  for (int k = 0; k < kRowPer; ++k) {
    const int i = threadIdx.x + k * kRowThreads;
    if (i < C) o[i] = round_to<T>((v[k] - mu) * rstd * scale[i] + bias[i]);
  }
}

// Partial products part[z, b, j] = sum over k in slice z of in[b, k] * W[j, k],
// for W [N, K] stored as W and in [B, K] f32; slices of kslice <= kKT
// columns, a multiple of 8. With scales sc [N, G] (quantized W), a slice lies
// in one of the G groups of K / G columns, and its sums are multiplied by the
// scale of its row and group. Grid (ceil(N / kRowsPerBlock), ceil(B / kBT),
// K / kslice).
// Each warp loads its kRowsPerWarp weight rows for the whole slice into
// registers first; while those loads are in flight the block stages its kBT
// activation rows in shared memory, where each activation value read serves
// kRowsPerWarp weights. The warp's kRowsPerWarp * kBT sums are reduced over
// its lanes by one reduce-scatter.
template <typename W>
__global__ void __launch_bounds__(kWarps * 32, 2)
gemv_kernel(const float* __restrict__ in, const void* __restrict__ w,
            const float* __restrict__ sc, int G, float* __restrict__ part, int B, int K, int N,
            int kslice) {
  constexpr int VEC = Vec<W>::n;
  constexpr int ITERS = kKT / (32 * VEC);
  constexpr int SROWS = kBT / kWarps;      // activation rows a warp stages
  constexpr int SCOLS = kKT / (32 * 4);    // float4 a lane stages per row
  constexpr int NSUM = kRowsPerWarp * kBT;
  static_assert(kBT % kWarps == 0 && kKT % 128 == 0, "the staging layout");
  __shared__ __align__(16) float xs[kBT][kKT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  const int b0 = blockIdx.y * kBT;
  const int nb = min(kBT, B - b0);
  const int k0 = blockIdx.z * kslice;

  typename Vec<W>::raw wr[kRowsPerWarp][ITERS];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int kk = (it * 32 + lane) * VEC;
      if (j0 + r < N && kk < kslice) wr[r][it] = load_w<W>(w, (size_t)(j0 + r) * K + k0 + kk);
      else wr[r][it] = typename Vec<W>::raw{};
    }

  // warp w stages activation rows w, w + kWarps, ...; all of a thread's
  // loads are issued before its first store
  float4 xv[SROWS][SCOLS];
#pragma unroll
  for (int rr = 0; rr < SROWS; ++rr)
#pragma unroll
    for (int c = 0; c < SCOLS; ++c) {
      const int b = warp + rr * kWarps, k = (c * 32 + lane) * 4;
      xv[rr][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < nb && k < kslice)
        xv[rr][c] = __ldg(reinterpret_cast<const float4*>(in + (size_t)(b0 + b) * K + k0 + k));
    }
#pragma unroll
  for (int rr = 0; rr < SROWS; ++rr)
#pragma unroll
    for (int c = 0; c < SCOLS; ++c) {
      const int b = warp + rr * kWarps, k = (c * 32 + lane) * 4;
      if (k < kslice) *reinterpret_cast<float4*>(&xs[b][k]) = xv[rr][c];
    }
  __syncthreads();

  float acc[NSUM];   // acc[r * kBT + b]: row j0 + r, activation row b0 + b
#pragma unroll
  for (int i = 0; i < NSUM; ++i) acc[i] = 0.f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int kk = (it * 32 + lane) * VEC;
    if (kk >= kslice) break;
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      float4 wq[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) wq[r] = Vec<W>::quad(wr[r][it], q);
#pragma unroll
      for (int b = 0; b < kBT; ++b) {
        const float4 f = *reinterpret_cast<const float4*>(&xs[b][kk + 4 * q]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          float a = acc[r * kBT + b];
          a = fmaf(wq[r].x, f.x, a);
          a = fmaf(wq[r].y, f.y, a);
          a = fmaf(wq[r].z, f.z, a);
          acc[r * kBT + b] = fmaf(wq[r].w, f.w, a);
        }
      }
    }
  }

  warp_reduce_scatter<NSUM, NSUM>(acc, lane);
  float* out = part + (size_t)blockIdx.z * B * N;
  const int group = sc ? k0 / (K / G) : 0;
#pragma unroll
  for (int i = 0; i < NSUM / 32; ++i) {
    const int e = (NSUM / 32) * lane + i, r = e / kBT, b = e % kBT;
    if (b < nb && j0 + r < N)
      out[(size_t)(b0 + b) * N + j0 + r] =
          sc ? acc[i] * sc[(size_t)(j0 + r) * G + group] : acc[i];
  }
}

// h[b, j] = exact-erf GELU(the split partials + bias), rounded to T
template <typename T>
__global__ void gelu_kernel(const float* __restrict__ part, int split,
                            const float* __restrict__ bias, float* __restrict__ h, int B,
                            int N) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * N) return;
  const float v = gather(part, split, (size_t)B * N, idx, bias[idx % N]);
  h[idx] = round_to<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
}

// Attention for one (head, batch row) per block over the cache rows < t, with
// the current token's k/v folded in analytically. q/k/v come from the split
// partials of the [B, 3C] QKV product plus its bias. kv [B, N, 2C] is this
// layer's cache (K in [:C], V in [C:]), of the compute type T or int8 (KV);
// writes y [B, C] (rounded to T) and, for a T cache, this layer's new cache
// row kv_new [B, 2C] (kv_quantize_kernel writes an int8 one). An int8 cache
// comes with kv_sc [B, N, 2], the (k, v) scale of each row: a history score
// is scaled by its k-scale, a softmax weight by its v-scale before the V sum
// (the denominator takes it unscaled). The head width d is a power of two
// with VEC <= d <= 32 * VEC: a cache row of one head is d / VEC lanes of 16
// bytes. Dynamic shared memory holds t scores, 2d query and value numbers,
// and kAttnThreads * VEC partial V sums.
template <typename T, typename KV>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ part, int split, const float* __restrict__ bqkv,
                 const KV* __restrict__ kv, const float* __restrict__ kv_sc,
                 KV* __restrict__ kv_new, float* __restrict__ y, int B, int N, int C,
                 int n_head, int t, float scale) {
  constexpr bool kQ = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Vec<KV>::n;
  constexpr int U = 8;                    // cache rows a thread loads before using any
  extern __shared__ __align__(16) float sm[];
  __shared__ float scratch[32];
  const int d = C / n_head;
  const int lpr = d / VEC;                // lanes per cache row
  const int rpw = 32 / lpr;               // rows per warp load
  float* qs = sm;                         // [d] q * scale, rounded to T
  float* vn = qs + d;                     // [d] the current token's v
  float* vpart = vn + d;                  // [kAttnThreads * VEC] partial V sums
  float* s = vpart + kAttnThreads * VEC;  // [t] scores, then softmax numerators
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t stride = (size_t)B * 3 * C;

  // the self score uses the unrounded f32 q and k
  float self = 0.f;
  for (int i = tid; i < d; i += blockDim.x) {
    const int c = h * d + i;
    const size_t base = (size_t)b * 3 * C + c;
    const float q = gather(part, split, stride, base, bqkv[c]) * scale;
    const float k = gather(part, split, stride, base + C, bqkv[C + c]);
    const float v = gather(part, split, stride, base + 2 * C, bqkv[2 * C + c]);
    qs[i] = round_to<T>(q);
    vn[i] = v;
    if constexpr (!kQ) {
      kv_new[(size_t)b * 2 * C + c] = from_f<T>(k);
      kv_new[(size_t)b * 2 * C + C + c] = from_f<T>(v);
    }
    self += q * k;
  }
  self = block_reduce<false>(self, scratch);

  // history scores: lane group (lane / lpr) of warp w takes one row per load,
  // U loads in flight before the segmented reductions
  const KV* kbase = kv + (size_t)b * N * 2 * C + h * d;
  const float* rsc = kQ ? kv_sc + (size_t)b * N * 2 : nullptr;   // [N, 2]
  const int sub = lane / lpr, col = (lane % lpr) * VEC;
  float qv[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) qv[v] = qs[col + v];
  for (int n0 = warp * U * rpw; n0 < t; n0 += nw * U * rpw) {
    typename Vec<KV>::raw kr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int n = n0 + u * rpw + sub;
      if (n < t) kr[u] = load16(kbase + (size_t)n * 2 * C + col);
      else kr[u] = typename Vec<KV>::raw{};
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      Vec<KV>::unpack(kr[u], kf);
      float p = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) p += qv[v] * kf[v];
      for (int o = lpr / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      const int n = n0 + u * rpw + sub;
      if (lane % lpr == 0 && n < t) s[n] = kQ ? p * rsc[2 * n] : p;
    }
  }
  __syncthreads();

  // softmax over [history, self]; with t == 0 only the self term remains
  float m = self;
  for (int n = tid; n < t; n += blockDim.x) m = fmaxf(m, s[n]);
  m = block_reduce<true>(m, scratch);
  float den = 0.f;
  for (int n = tid; n < t; n += blockDim.x) {
    const float e = expf(s[n] - m);
    den += e;
    s[n] = e;
  }
  const float es = expf(self - m);
  den = block_reduce<false>(den, scratch) + es;

  // V sum: thread group g (of G = blockDim / lpr) adds rows g, g + G, ...,
  // VEC columns a thread
  const int G = blockDim.x / lpr, g = tid / lpr, vc = (tid % lpr) * VEC;
  const KV* vbase = kbase + C + vc;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (int n0 = g; n0 < t; n0 += U * G) {   // U loads in flight before the sums
    typename Vec<KV>::raw vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int n = n0 + u * G;
      if (n < t) vr[u] = load16(vbase + (size_t)n * 2 * C);
      else vr[u] = typename Vec<KV>::raw{};
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int n = n0 + u * G;
      if (n < t) {
        const float e = round_to<T>(kQ ? s[n] * rsc[2 * n + 1] : s[n]);
        float vf[VEC];
        Vec<KV>::unpack(vr[u], vf);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += e * vf[v];
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) vpart[g * d + vc + v] = acc[v];
  __syncthreads();
  for (int i = tid; i < d; i += blockDim.x) {
    float num = 0.f;
    for (int gg = 0; gg < G; ++gg) num += vpart[gg * d + i];
    num += es * vn[i];
    y[(size_t)b * C + h * d + i] = round_to<T>(num / den);
  }
}

// The new int8 cache row of batch row blockIdx.x: k and v from the split
// partials of the QKV product plus its bias, each quantized over all C lanes
// with scale max(max |.|, 1e-8) / 127 and levels round-half-even(x / scale)
// clipped to [-127, 127]. Writes kv_new [B, 2C] and sc_new [B, 2] (k, v).
__global__ void __launch_bounds__(kRowThreads)
kv_quantize_kernel(const float* __restrict__ part, int split, const float* __restrict__ bqkv,
                   int8_t* __restrict__ kv_new, float* __restrict__ sc_new, int B, int C) {
  __shared__ float scratch[32];
  const int b = blockIdx.x;
  const size_t stride = (size_t)B * 3 * C, base = (size_t)b * 3 * C;
  float k[kRowPer], v[kRowPer];
  float mk = 0.f, mv = 0.f;
#pragma unroll
  for (int r = 0; r < kRowPer; ++r) {
    const int i = threadIdx.x + r * kRowThreads;
    k[r] = v[r] = 0.f;
    if (i < C) {
      k[r] = gather(part, split, stride, base + C + i, bqkv[C + i]);
      v[r] = gather(part, split, stride, base + 2 * C + i, bqkv[2 * C + i]);
      mk = fmaxf(mk, fabsf(k[r]));
      mv = fmaxf(mv, fabsf(v[r]));
    }
  }
  const float sk = fmaxf(block_reduce<true>(mk, scratch), 1e-8f) / 127.f;
  const float sv = fmaxf(block_reduce<true>(mv, scratch), 1e-8f) / 127.f;
  int8_t* row = kv_new + (size_t)b * 2 * C;
#pragma unroll
  for (int r = 0; r < kRowPer; ++r) {
    const int i = threadIdx.x + r * kRowThreads;
    if (i < C) {
      row[i] = (int8_t)fminf(fmaxf(rintf(k[r] / sk), -127.f), 127.f);
      row[C + i] = (int8_t)fminf(fmaxf(rintf(v[r] / sv), -127.f), 127.f);
    }
  }
  if (threadIdx.x == 0) {
    sc_new[2 * b] = sk;
    sc_new[2 * b + 1] = sv;
  }
}

// The K split of an [N, K] product with G scale groups along K (1 for float
// weights): slices of at most kKT columns, a multiple of 8, none straddling a
// group, then halved (down to 128 columns, one 16-byte f32 load a lane)
// while the grid has fewer than kTargetBlocks blocks.
int choose_split(int N, int K, int G = 1) {
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  int s = (K + kKT - 1) / kKT;
  if (s < G) s = G;
  while (K % s != 0 || (K / s) % 8 != 0 || s % G != 0) ++s;
  while (blocks * s < kTargetBlocks && K % (2 * s) == 0 && (K / (2 * s)) % 8 == 0 &&
         K / (2 * s) >= 128)
    s *= 2;
  return s;
}

// Scale groups along K of the products for weights of `bits` (0: float):
// int8 one, fc2 two (its two 2C-wide input halves); int4 8, fc2 16.
struct Groups {
  int g, g2;
  explicit Groups(int bits) : g(bits == 4 ? 8 : 1), g2(bits == 4 ? 16 : bits == 8 ? 2 : 1) {}
};

struct Splits {
  int qkv, proj, fc1, fc2;
  Splits(int C, const Groups& gr)
      : qkv(choose_split(3 * C, C, gr.g)), proj(choose_split(C, C, gr.g)),
        fc1(choose_split(4 * C, C, gr.g)), fc2(choose_split(C, 4 * C, gr.g2)) {}
  // the largest partial buffer, in units of B floats
  long long max_partials(int C) const {
    long long m = (long long)qkv * 3 * C;
    if ((long long)proj * C > m) m = (long long)proj * C;
    if ((long long)fc1 * 4 * C > m) m = (long long)fc1 * 4 * C;
    if ((long long)fc2 * C > m) m = (long long)fc2 * C;
    return m;
  }
};

// The weights of one decode stack, stacked over the L layers: the GEMV
// weights stored as W, with the [rows, groups] scales of each layer when W
// is quantized (nullptr for float weights); LayerNorm affines and biases f32.
struct Params {
  const float *ln1_s, *ln1_b, *bqkv, *bproj, *ln2_s, *ln2_b, *bfc1, *bfc2;
  const void *wqkv, *wproj, *wfc1, *wfc2;
  const float *sqkv, *sproj, *sfc1, *sfc2;
};

template <typename W> constexpr int kQuantBits =
    std::is_same<W, Int8W>::value ? 8 : std::is_same<W, Int4W>::value ? 4 : 0;

// the [N, K] product of layer l: weights at element l * N * K, scales at l * N * G
template <typename W>
cudaError_t launch_gemv(const float* in, const void* w, const float* sc, int G, int l,
                        float* part, int B, int K, int N, int split, cudaStream_t stream) {
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, (B + kBT - 1) / kBT, split);
  const char* wl = static_cast<const char*>(w) + (size_t)l * N * K * kBits<W> / 8;
  gemv_kernel<W><<<grid, kWarps * 32, 0, stream>>>(
      in, wl, sc ? sc + (size_t)l * N * G : nullptr, G, part, B, K, N, K / split);
  return cudaGetLastError();
}

// T: the compute type operands are rounded to; W: the weights' storage (T,
// Int8W or Int4W); KV: the cache's type (T, or int8_t with kv_sc [L, B, N, 2]
// and the new rows' scales sc_new [L, B, 2]).
template <typename T, typename W, typename KV>
int decode_stack(const float* x_in, float* x, const Params& p, const KV* kv,
                 const float* kv_sc, KV* kv_new, float* sc_new, float* work, int L, int B,
                 int N, int C, int n_head, int t, cudaStream_t stream) {
  constexpr bool kQ = std::is_same<KV, int8_t>::value;
  // workspace: xn [B, C] | y [B, C] | h [B, 4C] | split partials
  float* xn = work;
  float* yb = xn + (size_t)B * C;
  float* hb = yb + (size_t)B * C;
  float* part = hb + (size_t)4 * B * C;
  const Groups gr(kQuantBits<W>);
  const Splits sp(C, gr);
  const int d = C / n_head;
  const float scale = (float)(1.0 / sqrt((double)d));
  const size_t attn_smem = sizeof(float) * (2 * d + kAttnThreads * Vec<KV>::n + t);

  cudaError_t err = cudaMemcpyAsync(x, x_in, sizeof(float) * B * C,
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < L; ++l) {
    // x += previous fc2 + bias (from layer 1 on); xn = LN1(x)
    residual_layernorm_kernel<T><<<B, kRowThreads, 0, stream>>>(
        x, part, l > 0 ? sp.fc2 : 0, l > 0 ? p.bfc2 + (l - 1) * C : nullptr,
        p.ln1_s + l * C, p.ln1_b + l * C, xn, B, C);
    if ((err = launch_gemv<W>(xn, p.wqkv, p.sqkv, gr.g, l, part, B, C, 3 * C, sp.qkv,
                              stream)))
      return (int)err;
    if constexpr (kQ)
      kv_quantize_kernel<<<B, kRowThreads, 0, stream>>>(
          part, sp.qkv, p.bqkv + l * 3 * C, kv_new + (size_t)l * B * 2 * C,
          sc_new + (size_t)l * B * 2, B, C);
    attention_kernel<T, KV><<<dim3(n_head, B), kAttnThreads, attn_smem, stream>>>(
        part, sp.qkv, p.bqkv + l * 3 * C, kv + (size_t)l * B * N * 2 * C,
        kQ ? kv_sc + (size_t)l * B * N * 2 : nullptr, kv_new + (size_t)l * B * 2 * C, yb, B,
        N, C, n_head, t, scale);
    if ((err = launch_gemv<W>(yb, p.wproj, p.sproj, gr.g, l, part, B, C, C, sp.proj, stream)))
      return (int)err;
    // x += proj + bias; xn = LN2(x)
    residual_layernorm_kernel<T><<<B, kRowThreads, 0, stream>>>(
        x, part, sp.proj, p.bproj + l * C, p.ln2_s + l * C, p.ln2_b + l * C, xn, B, C);
    if ((err = launch_gemv<W>(xn, p.wfc1, p.sfc1, gr.g, l, part, B, C, 4 * C, sp.fc1, stream)))
      return (int)err;
    gelu_kernel<T><<<(unsigned)((4 * (size_t)B * C + 255) / 256), 256, 0, stream>>>(
        part, sp.fc1, p.bfc1 + l * 4 * C, hb, B, 4 * C);
    if ((err = launch_gemv<W>(hb, p.wfc2, p.sfc2, gr.g2, l, part, B, 4 * C, C, sp.fc2,
                              stream)))
      return (int)err;
  }
  residual_layernorm_kernel<T><<<B, kRowThreads, 0, stream>>>(
      x, part, sp.fc2, p.bfc2 + (L - 1) * C, nullptr, nullptr, nullptr, B, C);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int quant_stack(const float* x_in, float* x, const Params& p, const void* kv,
                const float* kv_sc, void* kv_new, float* sc_new, float* work, int L, int B,
                int N, int C, int n_head, int t, cudaStream_t stream) {
  if (kv_sc)
    return decode_stack<T, W, int8_t>(x_in, x, p, (const int8_t*)kv, kv_sc, (int8_t*)kv_new,
                                      sc_new, work, L, B, N, C, n_head, t, stream);
  return decode_stack<T, W, T>(x_in, x, p, (const T*)kv, nullptr, (T*)kv_new, nullptr, work,
                               L, B, N, C, n_head, t, stream);
}

}  // namespace

// Floats of workspace the wrapper allocates for decode batch B, width C and
// weights of `bits` (0: float, 8: int8, 4: int4).
extern "C" long long gpt_decode_workspace_floats(int B, int C, int bits) {
  return (long long)B * (6LL * C + Splits(C, Groups(bits)).max_partials(C));
}

// Plain C entry points, bound with ctypes. Pointers are device pointers of
// contiguous tensors; the wrapper (ops/gpt_decode.py) checks shapes, types and
// devices. Returns the cudaError_t of the launches (0 on success).
#define DECODE_STACK_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* x_in, void* x, const void* ln1_s, const void* ln1_b,     \
                      const void* wqkv, const void* bqkv, const void* wproj,              \
                      const void* bproj, const void* ln2_s, const void* ln2_b,            \
                      const void* wfc1, const void* bfc1, const void* wfc2,               \
                      const void* bfc2, const void* kv, void* kv_new, void* work, int L,   \
                      int B, int N, int C, int n_head, int t, void* stream) {             \
    const Params p{(const float*)ln1_s, (const float*)ln1_b, (const float*)bqkv,          \
                   (const float*)bproj, (const float*)ln2_s, (const float*)ln2_b,          \
                   (const float*)bfc1,  (const float*)bfc2,  wqkv, wproj, wfc1, wfc2,      \
                   nullptr, nullptr, nullptr, nullptr};                                    \
    return decode_stack<T, T, T>((const float*)x_in, (float*)x, p, (const T*)kv, nullptr,  \
                                 (T*)kv_new, nullptr, (float*)work, L, B, N, C, n_head, t, \
                                 (cudaStream_t)stream);                                    \
  }

DECODE_STACK_ENTRY(gpt_decode_stack_f32, float)
DECODE_STACK_ENTRY(gpt_decode_stack_bf16, __nv_bfloat16)

// The quantized stack (B2b; B2c when kv_sc is not null, with an int8 cache,
// writing sc_new): bf16 selects the compute type (f32 or bf16, also the type
// of a float cache), bits the weights (8: int8 levels, 4: nibble-packed int4).
extern "C" int gpt_decode_stack_quant(
    const void* x_in, void* x, const void* ln1_s, const void* ln1_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* ln2_s, const void* ln2_b, const void* wfc1,
    const void* sfc1, const void* bfc1, const void* wfc2, const void* sfc2, const void* bfc2,
    const void* kv, const void* kv_sc, void* kv_new, void* sc_new, void* work, int L, int B,
    int N, int C, int n_head, int t, int bf16, int bits, void* stream) {
  const Params p{(const float*)ln1_s, (const float*)ln1_b, (const float*)bqkv,
                 (const float*)bproj, (const float*)ln2_s, (const float*)ln2_b,
                 (const float*)bfc1,  (const float*)bfc2,  wqkv, wproj, wfc1, wfc2,
                 (const float*)sqkv,  (const float*)sproj, (const float*)sfc1,
                 (const float*)sfc2};
  const float* sc = (const float*)kv_sc;
  float* sn = (float*)sc_new;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (bf16)
    return bits == 8 ? quant_stack<__nv_bfloat16, Int8W>((const float*)x_in, (float*)x, p, kv,
                                                         sc, kv_new, sn, (float*)work, L, B, N,
                                                         C, n_head, t, st)
                     : quant_stack<__nv_bfloat16, Int4W>((const float*)x_in, (float*)x, p, kv,
                                                         sc, kv_new, sn, (float*)work, L, B, N,
                                                         C, n_head, t, st);
  return bits == 8 ? quant_stack<float, Int8W>((const float*)x_in, (float*)x, p, kv, sc, kv_new,
                                               sn, (float*)work, L, B, N, C, n_head, t, st)
                   : quant_stack<float, Int4W>((const float*)x_in, (float*)x, p, kv, sc, kv_new,
                                               sn, (float*)work, L, B, N, C, n_head, t, st);
}
