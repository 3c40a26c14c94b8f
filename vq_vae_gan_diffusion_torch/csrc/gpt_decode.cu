// GPT decode stack for Hopper (sm_90a): one decode position through all L
// pre-LN transformer blocks, in one persistent cooperative launch.
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
// rows it reads. At C = 1024 one product streams only 4-17 MB, a few
// microseconds at 3.35 TB/s, and the phases between the products (LayerNorm,
// attention, GELU) and the grid barriers take longer than the products' own
// arithmetic. What the design does about it:
//   - one launch a position, like the TPU kernel's one pallas_call with
//     grid (L,): a cooperative grid of two blocks on each SM runs every
//     phase in order, each phase a loop of the block over the virtual
//     blocks of the kernel it once was, and a grid barrier between
//     dependent phases (8 a layer);
//   - a block is 8 consumer warps, which run the phases, and one producer
//     warp, which does nothing but stream the block's weight tiles into a
//     ring of slots in shared memory. The producer knows every tile of the
//     launch up front: the virtual blocks vb = blockIdx.x + i * gridDim.x of
//     each product, in phase order, layer after layer. Weights are read-only
//     in the launch, so it fills across any number of grid barriers, bounded
//     only by free slots: the weights stream while the consumers run the
//     small phases and wait at the barriers;
//   - a tile is 32 weight rows of one K slice; each producer lane copies one
//     row segment (1 KB in f32, 256 B in int8 at C = 1024) with a bulk copy
//     (cp.async.bulk, L2 evict-first) that completes on the slot's "full"
//     mbarrier with its byte count; each consumer warp arrives on the slot's
//     "empty" mbarrier once it has read its 4 rows, and the producer refills
//     the slot after all 8 have. A product multiplies tiles that are already
//     there, and the next tile's copy overlaps the current tile's product;
//   - the producer never joins a grid barrier, so the consumers meet at
//     their own: a named block barrier over the 8 consumer warps (bar.sync
//     1, 256) around an arrival counter in global memory whose top bit flips
//     when the last block arrives (cooperative groups' scheme). The launch
//     stays cooperative for its co-residency guarantee;
//   - the ring takes every byte of the block's half of the SM (115,712 of
//     the SM's 233,472) that the consumer area leaves: two activation
//     buffers of 16 KB, or attention's scratch where that is larger (they
//     are used in different phases). At C = 1024, N = 256 that is 2 slots of
//     32 KB in f32, 5 of 16 KB in bf16, 10 in int8 and 20 in int4: 17-21 MB
//     of weights in flight over the card. Two blocks of 9 warps, not one of
//     16 + 1, keep the 8-warp virtual block, the K splits and the
//     reduce-scatter as they were;
//   - every weight byte is read once per token; the activation rows of a
//     product's virtual blocks are staged by the consumers (cp.async through
//     L2), two at once, each activation value read there serving 4 weight
//     rows of a warp;
//   - the products are split over K (slices of <= 256 columns, a multiple of
//     16 bytes of weights) so that even the C-wide outputs (proj, fc2) fill
//     the grid;
//   - a warp's 4 x 16 dot products run in two passes of 4 x 8 (nine warps
//     a block leave ptxas 96 registers a thread: five warps share an SM
//     quarter's register file), each reduced over the warp's lanes by one
//     reduce-scatter (62 shuffles in all, not 320), a sum for sum the one
//     pass the kernel made before;
//   - the split partial sums meet in the next phase (attention, LayerNorm or
//     GELU), which adds them in a fixed order, so results are deterministic
//     and no extra pass over the activations is made;
//   - attention reads only the cache rows < t, 16 bytes a lane.
// Data written in the launch (x, the LN and attention outputs, the GELU
// output, the split partials) is read with ld.global.cg or cp.async.cg,
// through L2, never through the non-coherent read-only path; only weights,
// scales, biases, LN affines and the cache rows < t are read with __ldg or
// (weights) bulk copies.
// No tensor cores yet: the bf16 products run on the CUDA cores.
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
//
// The int8 KV cache (B2c) keeps k and v rows as int8 with one f32 scale
// each per (layer, batch row, position), in scales [L, B, N, 2]. Attention
// dequantizes 16 levels a 16-byte load, multiplies each history score by its
// row's k-scale and each softmax weight by its row's v-scale before the V
// sum, and keeps the current token's own term in f32. The new row needs the
// max over all C lanes of k and of v across heads, so one virtual block a
// batch row gathers them from the QKV partials and writes the int8 row and
// its two scales, in the attention phase (neither reads the other's output).
//
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here. A grid that cannot be co-resident is an error of the
// launch, returned to the caller. The caller commits kv_new (and, for an
// int8 cache, sc_new) into the cache at row t itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;     // consumer threads of a block, in every phase
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = kThreads + 32;   // and one producer warp
constexpr int kBlocksPerSm = 2;
constexpr int kRowsPerWarp = 4;   // output rows of W per warp
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kBT = 16;           // activation rows per GEMV virtual block
constexpr int kKT = 256;          // the largest K slice of a GEMV virtual block
constexpr int kTargetBlocks = 2 * 132;  // two resident blocks on each of 132 SMs
constexpr int kRowPer = 16;       // C <= kRowPer * kThreads: a row's values a thread holds
constexpr int kRowVec = kRowPer / 4;   // ... as float4 of 4 neighbouring columns
constexpr int kBlockSmem = 115712;     // a block's half of the SM: (233,472 - 2 x 1,024) / 2
constexpr int kScratchBytes = 128;     // block_reduce's static scratch
static_assert(kRowsPerBlock == 32, "a producer lane copies one row of a tile");

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

// 16 bytes of the cache, read-only in the launch
template <typename T>
__device__ __forceinline__ typename Vec<T>::raw load16(const T* p) {
  return __ldg(reinterpret_cast<const typename Vec<T>::raw*>(p));
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

// The consumer warps' block barrier (named barrier 1 over kThreads threads):
// the producer warp keeps its own schedule and never joins it.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// Sum or max over the block's consumer threads. Every one must call it; it
// synchronises them, so shared writes before it are visible after it.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  consumer_sync();  // a previous reduction may still read scratch
  if (lane == 0) scratch[warp] = v;
  consumer_sync();
  float r = scratch[0];
  for (int i = 1; i < kWarps; ++i) r = kMax ? fmaxf(r, scratch[i]) : r + scratch[i];
  return r;
}

// the split partial sums of output idx (stride between splits) plus the bias;
// the partials are written in the launch, so they are read through L2
__device__ __forceinline__ float gather(const float* part, int split, size_t stride,
                                        size_t idx, float bias) {
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < split; ++z) s += __ldcg(part + z * stride + idx);
  return s + bias;
}

// gather of the four outputs idx .. idx + 3 (idx and stride multiples of 4),
// each summed in the same order; all of a thread's loads of one unrolled
// run are in flight together
__device__ __forceinline__ float4 gather4(const float* part, int split, size_t stride,
                                          size_t idx, float4 bias) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
  for (int z = 0; z < split; ++z) {
    const float4 p = __ldcg(reinterpret_cast<const float4*>(part + z * stride + idx));
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  return make_float4(s.x + bias.x, s.y + bias.y, s.z + bias.z, s.w + bias.w);
}

__device__ __forceinline__ float4 ldg4(const float* p, size_t i) {
  return __ldg(reinterpret_cast<const float4*>(p + i));
}

// Row b of the residual stream: v = src[b] (x_in in layer 0, else x itself);
//   if split > 0: v += the split partials of a [B, C] product + pbias;
//   x[b] = v, unless it is unchanged there;
//   if scale != nullptr: xn[b] = LayerNorm(v) (eps 1e-5), rounded to T.
// Each thread holds kRowVec float4 of the row in registers: columns 4i ..
// 4i + 3 for i = threadIdx.x + k * kThreads (C is a multiple of 8).
template <typename T>
__device__ __forceinline__ void residual_layernorm(int b, const float* src, float* x,
                                                   const float* part, int split,
                                                   const float* pbias, const float* scale,
                                                   const float* bias, float* xn, int B, int C,
                                                   float* scratch) {
  const size_t r0 = (size_t)b * C;
  const int c4 = C / 4;
  const bool store = split > 0 || src != x;
  float4 v[kRowVec], g[kRowVec], h[kRowVec];   // the row, then the LN affine
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kRowVec; ++k) {   // every load of the row goes out first
    const int i = threadIdx.x + k * kThreads;
    v[k] = g[k] = h[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < c4) {
      v[k] = __ldcg(reinterpret_cast<const float4*>(src + r0) + i);
      if (scale != nullptr) {
        g[k] = ldg4(scale, 4 * i);
        h[k] = ldg4(bias, 4 * i);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRowVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < c4) {
      if (split > 0) {
        const float4 p = gather4(part, split, (size_t)B * C, r0 + 4 * i, ldg4(pbias, 4 * i));
        v[k] = make_float4(v[k].x + p.x, v[k].y + p.y, v[k].z + p.z, v[k].w + p.w);
      }
      if (store) reinterpret_cast<float4*>(x + r0)[i] = v[k];
      s += v[k].x + v[k].y + v[k].z + v[k].w;
    }
  }
  if (scale == nullptr) return;
  const float mu = block_reduce<false>(s, scratch) / C;
  float var = 0.f;
#pragma unroll
  for (int k = 0; k < kRowVec; ++k) {
    if (threadIdx.x + k * kThreads < c4) {
      const float4 d = make_float4(v[k].x - mu, v[k].y - mu, v[k].z - mu, v[k].w - mu);
      var += d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
    }
  }
  const float rstd = rsqrtf(block_reduce<false>(var, scratch) / C + 1e-5f);
#pragma unroll
  for (int k = 0; k < kRowVec; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < c4)
      reinterpret_cast<float4*>(xn + r0)[i] = make_float4(
          round_to<T>((v[k].x - mu) * rstd * g[k].x + h[k].x),
          round_to<T>((v[k].y - mu) * rstd * g[k].y + h[k].y),
          round_to<T>((v[k].z - mu) * rstd * g[k].z + h[k].z),
          round_to<T>((v[k].w - mu) * rstd * g[k].w + h[k].w));
  }
}

// One of the four [N, K] products of the stack, stacked over the L layers:
// weights stored as W, with [N, G] scales a layer when W is quantized
// (nullptr for float weights), split in `split` K slices.
struct Product {
  const void* w;
  const float* sc;
  int G, K, N, split;
};

// The product of one layer as a phase: part[z, b, j] = sum over k in slice z
// of in[b, k] * W[j, k], for in [B, K] f32; slices of kslice <= kKT columns,
// a multiple of 8. With scales (quantized W), a slice lies in one of the G
// groups of K / G columns, and its sums are multiplied by the scale of its
// row and group. Virtual block vb = rb + nrb * (bb + nbb * z) takes weight
// rows rb * 32 .. +32, activation rows bb * kBT .. +kBT and slice z.
struct Gemv {
  const float* in;
  const char* w;
  const float* sc;
  float* part;
  int G, B, K, N, kslice, nrb, nbb, nvb;
};

template <typename W>
__device__ __forceinline__ Gemv layer_gemv(const Product& p, int l, const float* in,
                                           float* part, int B) {
  Gemv g;
  g.in = in;
  g.w = static_cast<const char*>(p.w) + (size_t)l * p.N * p.K * kBits<W> / 8;
  g.sc = p.sc ? p.sc + (size_t)l * p.N * p.G : nullptr;
  g.part = part;
  g.G = p.G;
  g.B = B;
  g.K = p.K;
  g.N = p.N;
  g.kslice = p.K / p.split;
  g.nrb = (p.N + kRowsPerBlock - 1) / kRowsPerBlock;
  g.nbb = (B + kBT - 1) / kBT;
  g.nvb = g.nrb * g.nbb * p.split;
  return g;
}

// The shared memory of a block: [ring slots | consumer area | a full and an
// empty mbarrier a slot]. A slot holds one tile, the weights of a virtual
// block (kRowsPerBlock rows of its slice, stored as W, a row every kKT
// columns); the consumer area holds two buffers of a virtual block's kBT
// activation rows (f32), or attention's scratch.
template <typename W> struct GemvSmem {
  static constexpr int kIters = kKT / (32 * Vec<W>::n);   // loads a lane makes a row
  static constexpr int kRowBytes = kKT * kBits<W> / 8;
  static constexpr int kWBytes = kRowsPerBlock * kRowBytes;   // a slot
  static constexpr int kXBytes = kBT * kKT * (int)sizeof(float);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}

// mbarriers in shared memory (PTX ISA 8.0, sm_90)
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}
// true when the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_test(uint64_t* b, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(b)), "r"(parity)
      : "memory");
  return done;
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(b)) : "memory");
}
// arrive, and expect `bytes` more of copies before the phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global src to shared dst, completing on mbarrier b; L2 keeps the
// lines with `policy`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* b, unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b)), "l"(policy)
      : "memory");
}

// The ring of weight tiles, as one thread sees it: the slot of its next tile
// and the parity of that slot's phase. Producer and consumers walk the same
// tiles in the same order, each with its own copy.
struct Ring {
  char* slot0;
  uint64_t *full, *empty;
  int slots, slot;
  unsigned phase;
  __device__ __forceinline__ void advance() {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// cp.async of 16 bytes from global src to shared dst; with valid false it
// writes zeros and reads nothing. It goes through L2 only (.cg), so it sees
// what other blocks wrote before the last grid barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most kPending of this thread's groups are still in flight
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Issue the copies of virtual block vb's kBT activation rows (zeros past
// the batch) into activation buffer buf; warp w copies rows w, w + kWarps, ...
template <typename W>
__device__ __forceinline__ void gemv_issue_acts(const Gemv& g, int vb, int buf, char* act) {
  using S = GemvSmem<W>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = ((vb / g.nrb) % g.nbb) * kBT;
  const int k0 = (vb / (g.nrb * g.nbb)) * g.kslice;
  float* xs = reinterpret_cast<float*>(act + buf * S::kXBytes);
#pragma unroll
  for (int rr = 0; rr < kBT / kWarps; ++rr)
#pragma unroll
    for (int c = 0; c < kKT / 128; ++c) {
      const int b = warp + rr * kWarps, k = (c * 32 + lane) * 4;
      const bool valid = b0 + b < g.B;
      if (k < g.kslice)
        cp_async16(xs + b * kKT + k, valid ? g.in + (size_t)(b0 + b) * g.K + k0 + k : g.in,
                   valid);
    }
}

// Virtual block vb of the product: its weight tile in the ring slot at
// `tile`, its activations in the buffer at `act`, both complete and visible.
// Each warp's kRowsPerWarp weight rows against the kBT activation rows, in
// two passes of kPass rows (each activation value read serves kRowsPerWarp
// weights; a pass's kRowsPerWarp * kPass sums fit the 96 registers a thread
// that nine warps a block leave); each pass's sums reduced over the warp's
// lanes by one reduce-scatter and written. A pass past the batch is
// skipped. After its last pass's products the warp releases the slot
// (arrives on `empty`).
template <typename W>
__device__ __forceinline__ void gemv_compute(const Gemv& g, int vb, const char* tile,
                                             const char* act, uint64_t* empty) {
  using raw = typename Vec<W>::raw;
  using S = GemvSmem<W>;
  constexpr int VEC = Vec<W>::n;
  constexpr int kPass = kBT / 2;
  constexpr int NSUM = kRowsPerWarp * kPass;
  static_assert(kBT % kWarps == 0 && kKT % 128 == 0, "the staging layout");
  const float(*xs)[kKT] = reinterpret_cast<const float(*)[kKT]>(act);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const raw* ws = reinterpret_cast<const raw*>(tile) + warp * kRowsPerWarp * S::kIters * 32;
  const int rb = vb % g.nrb, bb = (vb / g.nrb) % g.nbb, z = vb / (g.nrb * g.nbb);
  const int j0 = (rb * kWarps + warp) * kRowsPerWarp;
  const int b0 = bb * kBT;
  const int nb = min(kBT, g.B - b0);
  const int k0 = z * g.kslice;
  const int passes = nb > kPass ? 2 : 1;
  float* out = g.part + (size_t)z * g.B * g.N;
  const int group = g.sc ? k0 / (g.K / g.G) : 0;

#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
    const int p0 = pass * kPass;   // the pass's first activation row
    float acc[NSUM];   // acc[r * kPass + b]: row j0 + r, activation row b0 + p0 + b
#pragma unroll
    for (int i = 0; i < NSUM; ++i) acc[i] = 0.f;
#pragma unroll
    for (int it = 0; it < S::kIters; ++it) {
      const int kk = (it * 32 + lane) * VEC;
      if (kk >= g.kslice) break;
      raw wr[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) wr[r] = ws[(r * S::kIters + it) * 32 + lane];
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        float4 wq[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) wq[r] = Vec<W>::quad(wr[r], q);
#pragma unroll
        for (int b = 0; b < kPass; ++b) {
          const float4 f = *reinterpret_cast<const float4*>(&xs[p0 + b][kk + 4 * q]);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            float a = acc[r * kPass + b];
            a = fmaf(wq[r].x, f.x, a);
            a = fmaf(wq[r].y, f.y, a);
            a = fmaf(wq[r].z, f.z, a);
            acc[r * kPass + b] = fmaf(wq[r].w, f.w, a);
          }
        }
      }
    }
    if (pass == passes - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);   // the warp is done with its rows of the tile
    }

    // the butterfly pairs lanes 16, 8, 4, 2, 1 apart for any NSUM, so each
    // sum is the one a single pass over all kBT rows would give
    warp_reduce_scatter<NSUM, NSUM>(acc, lane);
#pragma unroll
    for (int i = 0; i < NSUM / 32; ++i) {
      const int e = (NSUM / 32) * lane + i, r = e / kPass, b = p0 + e % kPass;
      if (b < nb && j0 + r < g.N)
        out[(size_t)(b0 + b) * g.N + j0 + r] =
            g.sc ? acc[i] * __ldg(g.sc + (size_t)(j0 + r) * g.G + group) : acc[i];
    }
  }
}

// Phase stamps of one launch, in nanoseconds of %globaltimer, written by
// thread 0 of a block, and its ring counters: after a header {grid size,
// rows}, rows of gridDim.x + 1 values. Row 0: each block's start. Row i =
// 1 .. 8L: barrier i, column b the arrival of block b, column gridDim.x the
// moment block 0 leaves it. Row 8L + 1: each block's end. Then for each
// product p (QKV, proj, fc1, fc2) three rows, column b block b's sums over
// the layers as thread 0 saw them: the tiles it took, those whose slot was
// already full when it first tested it (hits), and the ns it waited for the
// others.
struct Stamps {
  unsigned long long* s;
  int row;
  __device__ __forceinline__ unsigned long long* at(int r, int col) const {
    return s + 2 + (size_t)r * (gridDim.x + 1) + col;
  }
  __device__ __forceinline__ void mark(int col) {
    if (s != nullptr && threadIdx.x == 0) *at(row, col) = globaltimer();
  }
};

// The product's phase: the activations of the block's first two virtual
// blocks go out together; from the third on, a virtual block's activations
// go out while the block multiplies the one before it. Each virtual block's
// weight tile comes from the ring, filled by the producer long before.
template <typename W>
__device__ __forceinline__ void gemv_phase(const Gemv& g, Ring& ring, char* act, Stamps& st,
                                           int prod, int L) {
  using S = GemvSmem<W>;
  for (int i = 0, vb = blockIdx.x; i < 2 && vb < g.nvb; ++i, vb += gridDim.x)
    gemv_issue_acts<W>(g, vb, i, act);
  cp_async_commit();
  for (int i = 0, vb = blockIdx.x; vb < g.nvb; ++i, vb += gridDim.x) {
    if (i > 0) {
      const int next = vb + gridDim.x;   // goes to the buffer of vb - gridDim.x
      if (next < g.nvb) gemv_issue_acts<W>(g, next, (i + 1) & 1, act);
      cp_async_commit();
    }
    uint64_t* full = ring.full + ring.slot;
    if (st.s != nullptr && threadIdx.x == 0) {   // profiling: the ring counters
      const bool hit = mbar_test(full, ring.phase);
      const unsigned long long t0 = globaltimer();
      if (!hit) mbar_wait(full, ring.phase);
      const int r = 8 * L + 2 + 3 * prod;
      *st.at(r, blockIdx.x) += 1;
      *st.at(r + 1, blockIdx.x) += hit;
      *st.at(r + 2, blockIdx.x) += hit ? 0 : globaltimer() - t0;
    }
    mbar_wait(full, ring.phase);   // the tile is in its slot
    if (i == 0) cp_async_wait<0>();   // the first two virtual blocks' activations are in
    else cp_async_wait<1>();          // all but the next virtual block's are in
    consumer_sync();                  // ... in every consumer thread
    gemv_compute<W>(g, vb, ring.slot0 + (size_t)ring.slot * S::kWBytes,
                    act + (i & 1) * S::kXBytes, ring.empty + ring.slot);
    ring.advance();
    consumer_sync();   // buffer i & 1 is free for virtual block vb + 2 * gridDim.x
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// h[idx] = exact-erf GELU(the split partials + bias), rounded to T, for the
// 4 * kThreads outputs of virtual block vb, four neighbours a thread
template <typename T>
__device__ __forceinline__ void gelu(int vb, const float* part, int split, const float* bias,
                                     float* h, int B, int N) {
  const size_t n = (size_t)B * N;
  const size_t idx = 4 * ((size_t)vb * kThreads + threadIdx.x);
  if (idx < n) {
    const float4 v = gather4(part, split, n, idx, ldg4(bias, idx % N));
    reinterpret_cast<float4*>(h)[idx / 4] =
        make_float4(round_to<T>(gelu_erf(v.x)), round_to<T>(gelu_erf(v.y)),
                    round_to<T>(gelu_erf(v.z)), round_to<T>(gelu_erf(v.w)));
  }
}

// Attention for one (head h, batch row b) over the cache rows < t, with the
// current token's k/v folded in analytically. q/k/v come from the split
// partials of the [B, 3C] QKV product plus its bias. kv [B, N, 2C] is this
// layer's cache (K in [:C], V in [C:]), of the compute type T or int8 (KV);
// writes y [B, C] (rounded to T) and, for a T cache, this layer's new cache
// row kv_new [B, 2C] (kv_quantize writes an int8 one). An int8 cache comes
// with kv_sc [B, N, 2], the (k, v) scale of each row: a history score is
// scaled by its k-scale, a softmax weight by its v-scale before the V sum
// (the denominator takes it unscaled). The head width d is a power of two
// with VEC <= d <= 32 * VEC: a cache row of one head is d / VEC lanes of 16
// bytes. Shared memory sm holds t scores, 2d query and value numbers, and
// kThreads * VEC partial V sums.
template <typename T, typename KV>
__device__ __forceinline__ void attention(int h, int b, const float* part, int split,
                                          const float* bqkv, const KV* kv, const float* kv_sc,
                                          KV* kv_new, float* y, int B, int N, int C, int n_head,
                                          int t, float scale, float* sm, float* scratch) {
  constexpr bool kQ = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Vec<KV>::n;
  // cache rows a thread loads before using any: 4 of an int8 cache (16 levels a load, unpacked
  // at once), where 8 would crowd the 96 registers a thread; every sum keeps its order
  constexpr int U = kQ ? 4 : 8;
  const int d = C / n_head;
  const int lpr = d / VEC;                // lanes per cache row
  const int rpw = 32 / lpr;               // rows per warp load
  float* qs = sm;                         // [d] q * scale, rounded to T
  float* vn = qs + d;                     // [d] the current token's v
  float* vpart = vn + d;                  // [kThreads * VEC] partial V sums
  float* s = vpart + kThreads * VEC;      // [t] scores, then softmax numerators
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t stride = (size_t)B * 3 * C;

  consumer_sync();   // the block's previous use of sm is over
  // the self score uses the unrounded f32 q and k
  float self = 0.f;
  for (int i = tid; i < d; i += kThreads) {
    const int c = h * d + i;
    const size_t base = (size_t)b * 3 * C + c;
    const float q = gather(part, split, stride, base, __ldg(bqkv + c)) * scale;
    const float k = gather(part, split, stride, base + C, __ldg(bqkv + C + c));
    const float v = gather(part, split, stride, base + 2 * C, __ldg(bqkv + 2 * C + c));
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
  for (int n0 = warp * U * rpw; n0 < t; n0 += kWarps * U * rpw) {
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
      if (lane % lpr == 0 && n < t) s[n] = kQ ? p * __ldg(rsc + 2 * n) : p;
    }
  }
  consumer_sync();

  // softmax over [history, self]; with t == 0 only the self term remains
  float m = self;
  for (int n = tid; n < t; n += kThreads) m = fmaxf(m, s[n]);
  m = block_reduce<true>(m, scratch);
  float den = 0.f;
  for (int n = tid; n < t; n += kThreads) {
    const float e = expf(s[n] - m);
    den += e;
    s[n] = e;
  }
  const float es = expf(self - m);
  den = block_reduce<false>(den, scratch) + es;

  // V sum: thread group g (of G = kThreads / lpr) adds rows g, g + G, ...,
  // VEC columns a thread
  const int G = kThreads / lpr, g = tid / lpr, vc = (tid % lpr) * VEC;
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
        const float e = round_to<T>(kQ ? s[n] * __ldg(rsc + 2 * n + 1) : s[n]);
        float vf[VEC];
        Vec<KV>::unpack(vr[u], vf);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += e * vf[v];
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) vpart[g * d + vc + v] = acc[v];
  consumer_sync();
  for (int i = tid; i < d; i += kThreads) {
    float num = 0.f;
    for (int gg = 0; gg < G; ++gg) num += vpart[gg * d + i];
    num += es * vn[i];
    y[(size_t)b * C + h * d + i] = round_to<T>(num / den);
  }
}

// The new int8 cache row of batch row b: k and v from the split partials of
// the QKV product plus its bias, each quantized over all C lanes with scale
// max(max |.|, 1e-8) / 127 and levels round-half-even(x / scale) clipped to
// [-127, 127]. Writes kv_new [B, 2C] and sc_new [B, 2] (k, v).
__device__ __forceinline__ void kv_quantize(int b, const float* part, int split,
                                            const float* bqkv, int8_t* kv_new, float* sc_new,
                                            int B, int C, float* scratch) {
  const size_t stride = (size_t)B * 3 * C, base = (size_t)b * 3 * C;
  float k[kRowPer], v[kRowPer];
  float mk = 0.f, mv = 0.f;
#pragma unroll
  for (int r = 0; r < kRowPer; ++r) {
    const int i = threadIdx.x + r * kThreads;
    k[r] = v[r] = 0.f;
    if (i < C) {
      k[r] = gather(part, split, stride, base + C + i, __ldg(bqkv + C + i));
      v[r] = gather(part, split, stride, base + 2 * C + i, __ldg(bqkv + 2 * C + i));
      mk = fmaxf(mk, fabsf(k[r]));
      mv = fmaxf(mv, fabsf(v[r]));
    }
  }
  const float sk = fmaxf(block_reduce<true>(mk, scratch), 1e-8f) / 127.f;
  const float sv = fmaxf(block_reduce<true>(mv, scratch), 1e-8f) / 127.f;
  int8_t* row = kv_new + (size_t)b * 2 * C;
#pragma unroll
  for (int r = 0; r < kRowPer; ++r) {
    const int i = threadIdx.x + r * kThreads;
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

// The weights of one decode stack, stacked over the L layers: LayerNorm
// affines and biases f32; the four products.
struct Params {
  const float *ln1_s, *ln1_b, *bqkv, *bproj, *ln2_s, *ln2_b, *bfc1, *bfc2;
  Product qkv, proj, fc1, fc2;
};

// Everything one launch reads and writes. The workspace holds xn [B, C] |
// yb [B, C] | hb [B, 4C] | the split partials. With stamps != nullptr the
// launch records %globaltimer stamps there (gpt_decode_set_stamps).
struct Args {
  const float* x_in;
  float* x;
  Params p;
  const void* kv;
  const float* kv_sc;
  void* kv_new;
  float* sc_new;
  float *xn, *yb, *hb, *part;
  int L, B, N, C, n_head, t;
  float scale;
  int slots, consumer;   // ring slots; bytes of the consumer area
  unsigned long long* stamps;
};

// The consumers' grid barrier, arrivals counted in g_arrived as cooperative
// groups count them: block 0 adds 2^31 - (gridDim.x - 1), every other block
// 1, so the top bit flips when the last block arrives and the low bits come
// back to 0. A block's consumer threads meet first, so their writes come
// before thread 0's arrival, a release at GPU scope; thread 0 waits for the
// flip with acquire loads, and they meet again: every consumer write before
// the barrier, in any block, is visible to every consumer read after it
// (through L2). The same orderings as cooperative groups' grid.sync() on
// sm_70 and later, without its fences.
__device__ unsigned g_arrived = 0;

__device__ __forceinline__ void grid_barrier(Stamps& st) {
  st.mark(blockIdx.x);
  consumer_sync();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old, now;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(&g_arrived), "r"(add)
                 : "memory");
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(now) : "l"(&g_arrived) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  consumer_sync();
  if (blockIdx.x == 0) st.mark(gridDim.x);
  ++st.row;
}

// The producer warp: every weight tile of the launch into the ring, in the
// consumers' order (per layer QKV, proj, fc1, fc2; in each the virtual
// blocks vb = blockIdx.x + i * gridDim.x), a slot as soon as the consumers
// have released it. Lane r copies row r of the tile: the slice's
// kslice * bits / 8 bytes of weight row j0 + r (rows past N are left as they
// are; their sums are never written). At the end it waits until the
// consumers have released every slot, so no copy outlives the warp.
template <typename W>
__device__ __forceinline__ void produce(const Params& p, int L, int B, Ring ring) {
  using S = GemvSmem<W>;
  const int lane = threadIdx.x & 31;
  unsigned long long policy;   // weights are read once a launch: first out of L2
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const Gemv g = layer_gemv<W>(q == 0 ? p.qkv : q == 1 ? p.proj : q == 2 ? p.fc1 : p.fc2, l,
                                   nullptr, nullptr, B);
      const unsigned bytes = g.kslice * kBits<W> / 8;
      for (int vb = blockIdx.x; vb < g.nvb; vb += gridDim.x) {
        const int j0 = (vb % g.nrb) * kRowsPerBlock;
        const int k0 = (vb / (g.nrb * g.nbb)) * g.kslice;
        const int rows = min(kRowsPerBlock, g.N - j0);
        uint64_t* full = ring.full + ring.slot;
        mbar_wait(ring.empty + ring.slot, ring.phase ^ 1);
        if (lane == 0) mbar_expect(full, rows * bytes);
        __syncwarp();
        if (lane < rows)
          bulk_copy(ring.slot0 + (size_t)ring.slot * S::kWBytes + lane * S::kRowBytes,
                    g.w + ((size_t)(j0 + lane) * g.K + k0) * kBits<W> / 8, bytes, full, policy);
        ring.advance();
      }
    }
  for (int i = 0; i < ring.slots; ++i) {
    mbar_wait(ring.empty + ring.slot, ring.phase ^ 1);
    ring.advance();
  }
}

// T: the compute type operands are rounded to; W: the weights' storage (T,
// Int8W or Int4W); KV: the cache's type (T, or int8_t with kv_sc [L, B, N, 2]
// and the new rows' scales sc_new [L, B, 2]). Warps 0 .. kWarps - 1 are the
// consumers, warp kWarps the producer. No consumer leaves before the last
// barrier: every phase loop runs to its end in every block.
template <typename T, typename W, typename KV>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm) decode_stack_kernel(const Args a) {
  constexpr bool kQ = std::is_same<KV, int8_t>::value;
  using S = GemvSmem<W>;
  extern __shared__ __align__(128) char smem[];
  __shared__ float scratch[kScratchBytes / sizeof(float)];
  char* const act = smem + (size_t)a.slots * S::kWBytes;   // the consumer area
  float* const sm = reinterpret_cast<float*>(act);
  Ring ring{smem, reinterpret_cast<uint64_t*>(act + a.consumer), nullptr, a.slots, 0, 0};
  ring.empty = ring.full + a.slots;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.slots; ++i) {
      mbar_init(ring.full + i, 1);        // the producer's arrival with the tile's bytes
      mbar_init(ring.empty + i, kWarps);  // each consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int B = a.B, C = a.C, nh = a.n_head;
  const Params& p = a.p;
  if (threadIdx.x >= kThreads) {
    produce<W>(p, a.L, B, ring);
    return;
  }
  Stamps st{a.stamps, 0};
  st.mark(blockIdx.x);
  st.row = 1;
  if (st.s != nullptr && threadIdx.x == 0)
    for (int r = 8 * a.L + 2; r < 8 * a.L + 14; ++r) *st.at(r, blockIdx.x) = 0;
  const KV* kv = static_cast<const KV*>(a.kv);
  KV* kv_new = static_cast<KV*>(a.kv_new);
  const int nq = kQ ? B : 0;                // new-row quantization, one a batch row
  const int n_gelu = (int)(((size_t)B * 4 * C + 4 * kThreads - 1) / (4 * kThreads));
  for (int l = 0; l < a.L; ++l) {
    // x = x_in (layer 0) or x + the previous fc2 + its bias; xn = LN1(x)
    for (int vb = blockIdx.x; vb < B; vb += gridDim.x)
      residual_layernorm<T>(vb, l ? a.x : a.x_in, a.x, a.part, l ? p.fc2.split : 0,
                            l ? p.bfc2 + (l - 1) * C : nullptr, p.ln1_s + l * C,
                            p.ln1_b + l * C, a.xn, B, C, scratch);
    grid_barrier(st);
    gemv_phase<W>(layer_gemv<W>(p.qkv, l, a.xn, a.part, B), ring, act, st, 0, a.L);
    grid_barrier(st);

    // the new int8 rows (int8 cache), then attention of every (head, row)
    const size_t cache = (size_t)l * B * a.N * 2 * C;
    for (int vb = blockIdx.x; vb < nq + nh * B; vb += gridDim.x) {
      if (vb < nq) {
        if constexpr (kQ)
          kv_quantize(vb, a.part, p.qkv.split, p.bqkv + l * 3 * C,
                      kv_new + (size_t)l * B * 2 * C, a.sc_new + (size_t)l * B * 2, B, C,
                      scratch);
      } else {
        attention<T, KV>((vb - nq) % nh, (vb - nq) / nh, a.part, p.qkv.split,
                         p.bqkv + l * 3 * C, kv + cache,
                         kQ ? a.kv_sc + (size_t)l * B * a.N * 2 : nullptr,
                         kv_new + (size_t)l * B * 2 * C, a.yb, B, a.N, C, nh, a.t, a.scale, sm,
                         scratch);
      }
    }
    grid_barrier(st);
    gemv_phase<W>(layer_gemv<W>(p.proj, l, a.yb, a.part, B), ring, act, st, 1, a.L);
    grid_barrier(st);

    // x += proj + bias; xn = LN2(x)
    for (int vb = blockIdx.x; vb < B; vb += gridDim.x)
      residual_layernorm<T>(vb, a.x, a.x, a.part, p.proj.split, p.bproj + l * C,
                            p.ln2_s + l * C, p.ln2_b + l * C, a.xn, B, C, scratch);
    grid_barrier(st);
    gemv_phase<W>(layer_gemv<W>(p.fc1, l, a.xn, a.part, B), ring, act, st, 2, a.L);
    grid_barrier(st);

    for (int vb = blockIdx.x; vb < n_gelu; vb += gridDim.x)
      gelu<T>(vb, a.part, p.fc1.split, p.bfc1 + l * 4 * C, a.hb, B, 4 * C);
    grid_barrier(st);
    gemv_phase<W>(layer_gemv<W>(p.fc2, l, a.hb, a.part, B), ring, act, st, 3, a.L);
    grid_barrier(st);
  }
  // x += the last fc2 + bias
  for (int vb = blockIdx.x; vb < B; vb += gridDim.x)
    residual_layernorm<T>(vb, a.x, a.x, a.part, p.fc2.split, p.bfc2 + (a.L - 1) * C, nullptr,
                          nullptr, nullptr, B, C, scratch);
  st.mark(blockIdx.x);
  if (st.s != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    st.s[0] = gridDim.x;
    st.s[1] = st.row + 13;   // the barriers' rows, the end, the ring counters
  }
}

// The K split of an [N, K] product with G scale groups along K (1 for float
// weights) and weights of `bits` (0: float): slices of at most kKT columns,
// a multiple of 8 columns and of 16 bytes of weights (the row copies), none
// straddling a group, then halved (down to 128 columns, one 16-byte f32
// load a lane) while the product has fewer than kTargetBlocks virtual
// blocks.
int choose_split(int N, int K, int G, int bits) {
  const int align = bits == 4 ? 32 : bits == 8 ? 16 : 8;
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  int s = (K + kKT - 1) / kKT;
  if (s < G) s = G;
  while (K % s != 0 || (K / s) % align != 0 || s % G != 0) ++s;
  while (blocks * s < kTargetBlocks && K % (2 * s) == 0 && (K / (2 * s)) % align == 0 &&
         K / (2 * s) >= 128)
    s *= 2;
  return s;
}

// Scale groups along K of the products for weights of `bits` (0: float):
// int8 one, fc2 two (its two 2C-wide input halves); int4 8, fc2 16.
struct Groups {
  int bits, g, g2;
  explicit Groups(int bits)
      : bits(bits), g(bits == 4 ? 8 : 1), g2(bits == 4 ? 16 : bits == 8 ? 2 : 1) {}
};

struct Splits {
  int qkv, proj, fc1, fc2;
  Splits(int C, const Groups& gr)
      : qkv(choose_split(3 * C, C, gr.g, gr.bits)), proj(choose_split(C, C, gr.g, gr.bits)),
        fc1(choose_split(4 * C, C, gr.g, gr.bits)), fc2(choose_split(C, 4 * C, gr.g2, gr.bits)) {}
  // the largest partial buffer, in units of B floats
  long long max_partials(int C) const {
    long long m = (long long)qkv * 3 * C;
    if ((long long)proj * C > m) m = (long long)proj * C;
    if ((long long)fc1 * 4 * C > m) m = (long long)fc1 * 4 * C;
    if ((long long)fc2 * C > m) m = (long long)fc2 * C;
    return m;
  }
};

// The host's setting for the launches that follow (profiling only): the
// stamp buffer and its capacity in 8-byte values.
unsigned long long* g_stamps = nullptr;
long long g_stamps_cap = 0;

// The consumer area: two activation buffers, or attention's scratch of
// `attn` bytes where that is larger, in whole 16 bytes.
int consumer_bytes(int attn) {
  const int act = 2 * kBT * kKT * 4;
  return attn > act ? (attn + 15) / 16 * 16 : act;
}

// Ring slots of `slot` bytes beside a consumer area of `consumer` bytes: as
// many as a block's half of the SM holds, each with its two mbarriers.
int ring_slots(int slot, int consumer) {
  return (kBlockSmem - kScratchBytes - consumer) / (slot + 16);
}

// The dynamic shared memory of a launch: the slots, the consumer area, the
// mbarriers.
int decode_smem(int slot, int slots, int consumer) {
  return slots * slot + consumer + 16 * slots;
}

// The largest grid of decode_stack_kernel<T, W, KV> whose blocks are all
// resident at once with `smem` bytes of dynamic shared memory (two blocks an
// SM), cached for the last device and size.
template <typename T, typename W, typename KV>
cudaError_t resident_grid(size_t smem, int* grid) {
  static int cached_dev = -1, cached_grid = 0;
  static size_t cached_smem = 0;
  const void* fn = reinterpret_cast<const void*>(&decode_stack_kernel<T, W, KV>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlockThreads, smem)))
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached_dev = dev;
    cached_smem = smem;
    cached_grid = per_sm * sms;
  }
  *grid = cached_grid;
  return cudaSuccess;
}

template <typename W> constexpr int kQuantBits =
    std::is_same<W, Int8W>::value ? 8 : std::is_same<W, Int4W>::value ? 4 : 0;

// The weight pointers of one stack, as the C entry points receive them.
struct Weights {
  const float *ln1_s, *ln1_b, *bqkv, *bproj, *ln2_s, *ln2_b, *bfc1, *bfc2;
  const void *wqkv, *wproj, *wfc1, *wfc2;
  const float *sqkv, *sproj, *sfc1, *sfc2;
};

// One cooperative launch of decode_stack_kernel<T, W, KV>; returns its
// cudaError_t (a grid that cannot be co-resident is one).
template <typename T, typename W, typename KV>
int decode_stack(const float* x_in, float* x, const Weights& w, const KV* kv,
                 const float* kv_sc, KV* kv_new, float* sc_new, float* work, int L, int B,
                 int N, int C, int n_head, int t, cudaStream_t stream) {
  const Groups gr(kQuantBits<W>);
  const Splits sp(C, gr);
  const int d = C / n_head;
  Args a;
  a.x_in = x_in;
  a.x = x;
  a.p = Params{w.ln1_s, w.ln1_b, w.bqkv, w.bproj, w.ln2_s, w.ln2_b, w.bfc1, w.bfc2,
               Product{w.wqkv, w.sqkv, gr.g, C, 3 * C, sp.qkv},
               Product{w.wproj, w.sproj, gr.g, C, C, sp.proj},
               Product{w.wfc1, w.sfc1, gr.g, C, 4 * C, sp.fc1},
               Product{w.wfc2, w.sfc2, gr.g2, 4 * C, C, sp.fc2}};
  a.kv = kv;
  a.kv_sc = kv_sc;
  a.kv_new = kv_new;
  a.sc_new = sc_new;
  a.xn = work;
  a.yb = a.xn + (size_t)B * C;
  a.hb = a.yb + (size_t)B * C;
  a.part = a.hb + (size_t)4 * B * C;
  a.L = L;
  a.B = B;
  a.N = N;
  a.C = C;
  a.n_head = n_head;
  a.t = t;
  a.scale = (float)(1.0 / sqrt((double)d));
  a.stamps = nullptr;
  // the consumer area holds attention's scores (for N rows, whatever t),
  // queries, values and sums where they outgrow the activation buffers
  a.consumer = consumer_bytes((int)sizeof(float) * (2 * d + kThreads * Vec<KV>::n + N));
  a.slots = ring_slots(GemvSmem<W>::kWBytes, a.consumer);
  if (a.slots < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = decode_smem(GemvSmem<W>::kWBytes, a.slots, a.consumer);
  int grid = 0;
  cudaError_t err = resident_grid<T, W, KV>(smem, &grid);
  if (err != cudaSuccess) return (int)err;
  if (g_stamps != nullptr) {
    if (2 + (long long)(8 * L + 14) * (grid + 1) > g_stamps_cap)
      return (int)cudaErrorInvalidValue;
    a.stamps = g_stamps;
  }
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&decode_stack_kernel<T, W, KV>), dim3(grid),
      dim3(kBlockThreads), args, smem, stream);
}

template <typename T, typename W>
int quant_stack(const float* x_in, float* x, const Weights& w, const void* kv,
                const float* kv_sc, void* kv_new, float* sc_new, float* work, int L, int B,
                int N, int C, int n_head, int t, cudaStream_t stream) {
  if (kv_sc)
    return decode_stack<T, W, int8_t>(x_in, x, w, (const int8_t*)kv, kv_sc, (int8_t*)kv_new,
                                      sc_new, work, L, B, N, C, n_head, t, stream);
  return decode_stack<T, W, T>(x_in, x, w, (const T*)kv, nullptr, (T*)kv_new, nullptr, work,
                               L, B, N, C, n_head, t, stream);
}

}  // namespace

// Floats of workspace the wrapper allocates for decode batch B, width C and
// weights of `bits` (0: float, 8: int8, 4: int4).
extern "C" long long gpt_decode_workspace_floats(int B, int C, int bits) {
  return (long long)B * (6LL * C + Splits(C, Groups(bits)).max_partials(C));
}

// Profiling: every later launch writes its phase stamps (struct Stamps) to
// the device buffer `stamps` of `capacity` 8-byte values, or refuses to
// launch when they do not fit; nullptr turns the stamps off. They cost the
// serving path nothing while off.
extern "C" void gpt_decode_set_stamps(void* stamps, long long capacity) {
  g_stamps = static_cast<unsigned long long*>(stamps);
  g_stamps_cap = stamps ? capacity : 0;
}

// Plain C entry points, bound with ctypes. Pointers are device pointers of
// contiguous tensors; the wrapper (ops/gpt_decode.py) checks shapes, types and
// devices. Returns the cudaError_t of the launch (0 on success).
#define DECODE_STACK_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* x_in, void* x, const void* ln1_s, const void* ln1_b,     \
                      const void* wqkv, const void* bqkv, const void* wproj,              \
                      const void* bproj, const void* ln2_s, const void* ln2_b,            \
                      const void* wfc1, const void* bfc1, const void* wfc2,               \
                      const void* bfc2, const void* kv, void* kv_new, void* work, int L,   \
                      int B, int N, int C, int n_head, int t, void* stream) {             \
    const Weights w{(const float*)ln1_s, (const float*)ln1_b, (const float*)bqkv,         \
                    (const float*)bproj, (const float*)ln2_s, (const float*)ln2_b,         \
                    (const float*)bfc1,  (const float*)bfc2,  wqkv, wproj, wfc1, wfc2,     \
                    nullptr, nullptr, nullptr, nullptr};                                   \
    return decode_stack<T, T, T>((const float*)x_in, (float*)x, w, (const T*)kv, nullptr,  \
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
  const Weights w{(const float*)ln1_s, (const float*)ln1_b, (const float*)bqkv,
                  (const float*)bproj, (const float*)ln2_s, (const float*)ln2_b,
                  (const float*)bfc1,  (const float*)bfc2,  wqkv, wproj, wfc1, wfc2,
                  (const float*)sqkv,  (const float*)sproj, (const float*)sfc1,
                  (const float*)sfc2};
  const float* sc = (const float*)kv_sc;
  float* sn = (float*)sc_new;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (bf16)
    return bits == 8 ? quant_stack<__nv_bfloat16, Int8W>((const float*)x_in, (float*)x, w, kv,
                                                         sc, kv_new, sn, (float*)work, L, B, N,
                                                         C, n_head, t, st)
                     : quant_stack<__nv_bfloat16, Int4W>((const float*)x_in, (float*)x, w, kv,
                                                         sc, kv_new, sn, (float*)work, L, B, N,
                                                         C, n_head, t, st);
  return bits == 8 ? quant_stack<float, Int8W>((const float*)x_in, (float*)x, w, kv, sc, kv_new,
                                               sn, (float*)work, L, B, N, C, n_head, t, st)
                   : quant_stack<float, Int4W>((const float*)x_in, (float*)x, w, kv, sc, kv_new,
                                               sn, (float*)work, L, B, N, C, n_head, t, st);
}
