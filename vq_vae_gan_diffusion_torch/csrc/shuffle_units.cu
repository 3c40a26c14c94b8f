// ShuffleNet-v2 units of the diffusion prior's U-Net, BatchNorm folded, for
// sm_90a. Plain C interface, loaded with ctypes by ops/shuffle.py.
//
// Replaces the JAX package's Pallas TPU kernels in ops/shuffle_pallas.py:
//   shuffle_bottleneck  <- fused_bottleneck_packed (B3) and fused_bottleneck (B5)
//   shuffle_downsample  <- fused_downsample_packed (B4), silu(x + t) prologue included
// The TPU kernels pack G images into the 128 lanes of a vector register and
// fold the channel shuffle into the pointwise weights. A GPU has no lanes to
// fill that way, so these kernels take plain NHWC tensors and write the
// shuffled output directly: out[..., 2i] = branch 1's channel i,
// out[..., 2i+1] = branch 2's. The next unit reads the two halves of that
// output as its x1 / x2 with strided reads, so consecutive units need no
// layout op between them either.
//
// Bottleneck unit, x [B,H,W,2ch] -> out [B,H,W,2co2]:
//   branch 1: u1 = dw3x3(x[..., :ch]) + b1;  y1 = silu(u1 @ w1 + c1)
//   branch 2: t2 = silu(x[..., ch:] @ w2 + c2), zero-padded AFTER the SiLU;
//             u2 = dw3x3(t2) + b2;  y2 = silu(u2 @ w3 + c3)
// Downsample unit, x [B,H,W,C] -> out [B,ceil(H/2),ceil(W/2),2co2]: the
// same with stride-2 depthwise convolutions and no split: branch 1's dw runs
// over all C channels, branch 2's first pointwise maps C -> co2 at full
// resolution. On an odd grid the last output row (column) reads the zero pad
// row (column) past the image, as a stride-2 convolution with padding 1 does.
// Optional prologue x = silu(x + t[b, :]) with the zero padding kept.
//
// Numbers: activations and weights in T (float or bf16), sums in f32. u1,
// t2, u2 and the outputs are rounded to T where the plain version
// (reference_bottleneck / reference_downsample) rounds them.
//
// What bounds the units on an H100: their three pointwise products are
// 80-90% of their operations, so at 128 input channels or more the f32
// CUDA-core rate (67 TFLOP/s) bounds them, at 64 or fewer the bytes of their
// input and output (3.35 TB/s; utils/profiling.py::shuffle_unit_bound).
// Blocks of full-width rows would make shared memory grow with W (one block
// of 8 warps an SM at W = 256) and run branch 2's first product on 3 rows to
// give 1 (the downsample's on 3 input rows to give 2); hence 2-D tiles.
//
// Design, both units:
// - One block per (image, th x tw tile of output pixels), the tile chosen
//   in Python (ops/shuffle.py::bottleneck_plan and downsample_plan, which
//   mirror this file's bottleneck_smem and downsample_smem) so that shared
//   memory follows the tile, not the width: two blocks an SM. The input
//   halo tile is (th + 2) x (tw + 2) from (r0 - 1, c0 - 1) for the
//   bottleneck, (2th + 1) x (2tw + 1) from (2r0 - 1, 2c0 - 1) for the
//   downsample; halo factors of 1.1-1.9.
// - The input over the halo tile is staged in shared memory with 16-byte
//   loads, 0 at halo pixels outside the image (rows and columns, the pad
//   row or column past an odd grid included); the downsample's prologue
//   silu(x + t) is applied there, once. t2 = silu(x @ w2 + c2) overwrites
//   it in place, 0 outside the image; u2 = dw(t2) goes to a second buffer
//   and y2 overwrites u2 in place; the last product's epilogue writes y1
//   and y2 as shuffled pairs, 32 bytes a thread (f32).
// - Branch 1's depthwise convolution: the bottleneck's reads x1 from global
//   memory (L1/L2 hits) after branch 2; the downsample's reads the staged
//   tile before t2 overwrites it, so both branches read x from shared
//   memory. One depthwise template takes the stride.
// - The products (gemm) read A from shared memory as float4 along k, rows
//   padded to 4 mod 8 floats against bank conflicts; each thread holds an
//   8-pixel x 4-column register tile, a warp 32 x 32 (narrower N: taller);
//   weights come by cp.async, whole or in double-buffered k-chunks, each
//   product's first chunk issued before the work that precedes it. A product
//   covers kNBlock columns in one pass; a branch wider than that (off every
//   path) runs in passes of kNBlock columns, and its block keeps each
//   product's output apart from its input, since a pass must not overwrite
//   the A it reads.
// - Sums stay in f32 on CUDA cores; SiLU takes the plain version's expf and
//   a divide within 2 ulp (silu_div2ulp).
// ops/shuffle.py owns the constants both sides use (kSmemLimit,
// kTargetBlocks, kStageBytes, kNBlock, pad_ld, bottleneck_smem,
// downsample_smem); tests/test_torch_port_shuffle_plan.py checks that this
// file agrees. Tensor cores, TMA, channel streaming and fusing units are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kTargetBlocks = 264;  // two blocks for each of 132 SMs
constexpr int kStageBytes = 16384;  // the products' k-chunk buffers of weights
constexpr int kNBlock = 256;        // columns of one pass of a product (8 warps x 32)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and held in f32: an operand of a product in T
template <class T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// SiLU with the plain version's exp and a divide within 2 ulp (an IEEE
// divide brings a slow-path call, and with it spills, into the kernels)
__device__ __forceinline__ float silu_div2ulp(float v) {
  return __fdividef(v, 1.0f + expf(-v));
}

// The smallest row stride >= c floats with stride % 8 == 4: rows stay
// 16-byte aligned, and the float4s at one column of 8 consecutive rows fall
// on 8 distinct groups of 4 banks. ops/shuffle.py::pad_ld computes the same.
__host__ __device__ constexpr int pad_ld(int c) {
  const int c4 = (c + 3) / 4 * 4;
  return c4 % 8 == 4 ? c4 : c4 + 4;
}

// four consecutive f32 from shared memory, and four consecutive elements
// as f32 from global memory through the read-only path (16-byte or 8-byte
// aligned)
__device__ __forceinline__ float4 bf16x4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
// 16 bytes from src, or 16 zero bytes where !in (no byte of src is read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest one has landed
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// every group has landed
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x cols pixels of one image, from (y0, x0), channels [0, ch) of each
// pixel (row stride cin), into dst[p * ld + k] as f32, p = row * cols + col;
// 0 at pixels outside the image and at k in [ch, round4(ch)) (ld >= that).
// With tv (the downsample's prologue), a pixel inside the image holds
// rnd<T>(silu(x + tv[k])); outside it stays 0. 16-byte loads when vec (ch a
// multiple of 16 bytes, x 16-byte aligned). Async (f32 and vec only): the
// loads are cp.async copies, all in flight at once rather than one a
// thread at a time, and the call returns once every cp.async group the
// thread has issued has landed; each thread then applies the prologue to
// the pixels it copied.
template <class T, bool Async = false>
__device__ void stage_tile(const T* __restrict__ src, int cin, int H, int W, int y0, int x0,
                           int rows, int cols, int ch, bool vec, const T* __restrict__ tv,
                           float* __restrict__ dst, int ld) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (Async && sizeof(T) == sizeof(float)) {
    if (vec) {
      const int per = ch / 4;
      for (int e = threadIdx.x; e < rows * cols * per; e += kThreads) {
        const int j = e % per, p = e / per;
        const int y = y0 + p / cols, xx = x0 + p % cols;
        const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
        cp_async16_zfill(dst + p * ld + 4 * j, in ? src + ((size_t)y * W + xx) * cin + 4 * j : src,
                         in);
      }
      cp_async_commit();
      cp_async_wait0();
      if (tv) {
        for (int e = threadIdx.x; e < rows * cols * per; e += kThreads) {
          const int j = e % per, p = e / per;
          const int y = y0 + p / cols, xx = x0 + p % cols;
          if (y < 0 || y >= H || xx < 0 || xx >= W) continue;
          float4* d = reinterpret_cast<float4*>(dst + p * ld + 4 * j);
          const float* t = tv + 4 * j;
          const float4 v = *d;
          *d = make_float4(silu_div2ulp(v.x + t[0]), silu_div2ulp(v.y + t[1]),
                           silu_div2ulp(v.z + t[2]), silu_div2ulp(v.w + t[3]));
        }
      }
      return;
    }
  }
  if (vec) {
    const int per = ch / V;
    for (int e = threadIdx.x; e < rows * cols * per; e += kThreads) {
      const int j = e % per, p = e / per;
      const int y = y0 + p / cols, xx = x0 + p % cols;
      float f[V];
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + ((size_t)y * W + xx) * cin) + j);
        if constexpr (sizeof(T) == 4) {
          f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
          f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
        } else {
          const float4 lo = bf16x4(make_uint2(v.x, v.y)), hi = bf16x4(make_uint2(v.z, v.w));
          f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
          f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
        }
        if (tv) {
#pragma unroll
          for (int i = 0; i < V; ++i) f[i] = rnd<T>(silu_div2ulp(f[i] + to_f(tv[j * V + i])));
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = 0.f;
      }
      float4* d = reinterpret_cast<float4*>(dst + p * ld + j * V);
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        d[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
    }
  } else {
    const int c4 = (ch + 3) / 4 * 4;
    for (int e = threadIdx.x; e < rows * cols * c4; e += kThreads) {
      const int k = e % c4, p = e / c4;
      const int y = y0 + p / cols, xx = x0 + p % cols;
      float v = 0.f;
      if (k < ch && y >= 0 && y < H && xx >= 0 && xx < W) {
        v = to_f(src[((size_t)y * W + xx) * cin + k]);
        if (tv) v = rnd<T>(silu_div2ulp(v + to_f(tv[k])));
      }
      dst[p * ld + k] = v;
    }
  }
}

// How the products cut w [K, N] (row stride ldw >= N) into
// k-chunks of shared memory, held in f32 in rows of Np = round4(N): all of
// w where it fits kStageBytes, else two buffers of KC rows each.
struct Chunks {
  int Np, KC, chunks;
  bool whole, vec;
};

template <class T>
__device__ __forceinline__ Chunks chunks_of(const T* w, int K, int N, int ldw) {
  Chunks q;
  q.Np = (N + 3) / 4 * 4;
  const int K4 = (K + 3) / 4 * 4;
  q.whole = (size_t)K4 * q.Np * sizeof(float) <= kStageBytes;
  q.KC = q.whole ? K4 : kStageBytes / 2 / (int)sizeof(float) / q.Np / 4 * 4;
  q.chunks = (K + q.KC - 1) / q.KC;
  q.vec = sizeof(T) == sizeof(float) && N % 4 == 0 && ldw % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  return q;
}

// k-chunk c of w into dst [round4(kn), Np] as f32, 0 past K and N:
// cp.async of whole 16-byte pieces for f32 rows of a multiple of 4, else
// plain loads, converted, and stores
template <class T>
__device__ void stage_chunk(const Chunks& q, int c, const T* __restrict__ w, int K, int N,
                            int ldw, float* dst) {
  const int k0 = c * q.KC, kn = min(q.KC, K - k0), kn4 = (kn + 3) / 4 * 4;
  if (q.vec) {
    const int per = N / 4;
    for (int e = threadIdx.x; e < kn * per; e += kThreads) {
      const int kk = e / per, j = e % per;
      cp_async16(dst + kk * q.Np + 4 * j, w + (size_t)(k0 + kk) * ldw + 4 * j);
    }
    for (int e = kn * q.Np + threadIdx.x; e < kn4 * q.Np; e += kThreads) dst[e] = 0.f;
  } else {
    for (int e = threadIdx.x; e < kn4 * q.Np; e += kThreads) {
      const int kk = e / q.Np, n = e % q.Np;
      dst[e] = (kk < kn && n < N) ? to_f(w[(size_t)(k0 + kk) * ldw + n]) : 0.f;
    }
  }
}

// The first k-chunk of w's first kNBlock columns on its way to Bs, as one
// cp.async group: what product() expects in flight when it is called.
// Issued as soon as Bs is free (every thread past the previous product's
// last barrier), so that the copy runs under the work before the product.
template <class T>
__device__ __forceinline__ void prefetch(const T* __restrict__ w, int K, int N, int ldw,
                                         float* Bs) {
  stage_chunk(chunks_of(w, K, N, ldw), 0, w, K, N, ldw, Bs);
  cp_async_commit();
}
template <class T>
__device__ __forceinline__ void prefetch(const T* __restrict__ w, int K, int N, float* Bs) {
  prefetch(w, K, min(N, kNBlock), N, Bs);
}

// One pass of a unit's pointwise products: rows [0, rows) of
// A @ w + bias, handed to epi(row, n0, v) as v[j] = column n0 + j, j < 4 (0
// past N). A [rows, K] is f32 in shared memory, row stride lda, with 0 in
// columns K .. round4(K); w [K, N] (row stride ldw) and bias [N] are T in
// global memory (w staged in f32); N <= kNBlock.
//
// A warp computes a tile of 8 * LP rows by 4 * LN columns (LN * LP = 32
// lanes), each thread 8 rows LP apart by 4 columns: per 4-deep step a
// thread reads 8 float4 of A (lanes sharing a row get one broadcast) and 4
// of w (LN lanes read 64 or 128 contiguous bytes) for 128 FMAs. WN warps
// span N; a round is the 8 / WN row blocks of all 8 warps, and every row of
// a round is finished in it, so epi may overwrite A's rows of the round in
// place: all warps pass a barrier between reading a round and its epilogue.
// Warps whose rows start past `rows` skip the arithmetic. w goes to
// shared memory by cp.async (chunks_of): whole where it fits kStageBytes,
// else in k-chunks double-buffered, the next chunk's copy in flight during
// this chunk's arithmetic; the caller has issued the first chunk with
// prefetch(). The caller needs no barrier between writing A and the call
// (the first chunk's barrier covers it); the call ends with the last
// epilogue, after a barrier that every thread has passed.
template <class T, class Epi>
__device__ void gemm(const float* __restrict__ A, int lda, int rows, int K,
                     const T* __restrict__ w, int ldw, const T* __restrict__ bias, int N,
                     float* Bs, const Epi& epi) {
  const int LN = N > 16 ? 8 : (N > 8 ? 4 : (N > 4 ? 2 : 1));
  const int LP = 32 / LN;
  const int WN = (N + 4 * LN - 1) / (4 * LN);
  const int RR = 8 / WN * 8 * LP;  // rows a round
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp / WN * 8 * LP;  // the warp's first row in a round
  const int n0 = ((warp % WN) * LN + lane % LN) * 4;
  const bool on = warp / WN < 8 / WN && n0 < N;
  const Chunks q = chunks_of(w, K, N, ldw);
  const int rounds = (rows + RR - 1) / RR;
  const int steps = q.whole ? rounds : rounds * q.chunks;

  float acc[8][4];
  for (int s = 0; s < steps; ++s) {
    const int r = q.whole ? s : s / q.chunks, c = q.whole ? 0 : s % q.chunks;
    const float* cur = Bs + (q.whole ? 0 : (s & 1) * q.KC * q.Np);
    if (!q.whole && s + 1 < steps)
      stage_chunk(q, (s + 1) % q.chunks, w, K, N, ldw, Bs + ((s + 1) & 1) * q.KC * q.Np);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    const int row0 = r * RR + wrow + lane / LN;
    if (on && r * RR + wrow < rows) {
      const int k0 = c * q.KC, kn4 = (min(q.KC, K - k0) + 3) / 4 * 4;
      int off[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) off[i] = min(row0 + i * LP, rows - 1) * lda + k0;
      const float* b = cur + n0;
#pragma unroll 1
      for (int kk = 0; kk < kn4; kk += 4) {
        const float4 b0 = ld4(b + kk * q.Np), b1 = ld4(b + (kk + 1) * q.Np);
        const float4 b2 = ld4(b + (kk + 2) * q.Np), b3 = ld4(b + (kk + 3) * q.Np);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(A + off[i] + kk);
          acc[i][0] = fmaf(a.w, b3.x, fmaf(a.z, b2.x, fmaf(a.y, b1.x, fmaf(a.x, b0.x, acc[i][0]))));
          acc[i][1] = fmaf(a.w, b3.y, fmaf(a.z, b2.y, fmaf(a.y, b1.y, fmaf(a.x, b0.y, acc[i][1]))));
          acc[i][2] = fmaf(a.w, b3.z, fmaf(a.z, b2.z, fmaf(a.y, b1.z, fmaf(a.x, b0.z, acc[i][2]))));
          acc[i][3] = fmaf(a.w, b3.w, fmaf(a.z, b2.w, fmaf(a.y, b1.w, fmaf(a.x, b0.w, acc[i][3]))));
        }
      }
    }
    __syncthreads();
    if (c == q.chunks - 1 && on) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = n0 + j < N ? to_f(bias[n0 + j]) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row0 + i * LP;
        if (row < rows) {
          const float v[4] = {acc[i][0] + bv[0], acc[i][1] + bv[1], acc[i][2] + bv[2],
                              acc[i][3] + bv[3]};
          epi(row, n0, v);
        }
      }
    }
  }
}

// A whole product A @ w + bias (w [K, N], bias [N]) handed to
// epi(row, n0, v) as in gemm(): one pass where N <= kNBlock (Wide false),
// else passes of kNBlock columns. The caller has issued the first pass's
// first chunk with prefetch(); each later pass issues its own once the pass
// before has left Bs. Only a product of one pass may write A in place.
template <bool Wide, class T, class Epi>
__device__ void product(const float* __restrict__ A, int lda, int rows, int K,
                        const T* __restrict__ w, const T* __restrict__ bias, int N, float* Bs,
                        const Epi& epi) {
  if constexpr (!Wide) {
    gemm<T>(A, lda, rows, K, w, N, bias, N, Bs, epi);
  } else {
    for (int nb = 0; nb < N; nb += kNBlock) {
      const int nn = min(kNBlock, N - nb);
      if (nb > 0) prefetch(w + nb, K, nn, N, Bs);
      gemm<T>(A, lda, rows, K, w + nb, N, bias + nb, nn, Bs,
              [&](int row, int n0, const float* v) { epi(row, nb + n0, v); });
    }
  }
}

// u[p * ldu + k] = rnd<T>(dw3x3(src) + b), stride S, for the tile's P
// output pixels p = ty * tw + tx and k < round4(ch) (0 past ch).
// load(hy, hx, k) gives channels k .. k + 3 of the source at (hy, hx) of the
// halo tile, whose (0, 0) lies one row above and one column left of the
// tile's first input pixel (output pixel (ty, tx) reads S ty + dy,
// S tx + dx), 0 outside the image. Each thread keeps one group of 4
// channels' taps in registers and walks the pixels; past kThreads groups
// (Wide only) it takes the next group after.
template <int S, bool Wide, class T, class Load>
__device__ void dw3x3(int tw, int P, const T* __restrict__ k3, const T* __restrict__ b, int ch,
                      const Load& load, float* __restrict__ u, int ldu) {
  const int c4 = (ch + 3) / 4, lanes = Wide ? min(c4, kThreads) : c4, groups = kThreads / lanes;
  if (threadIdx.x >= groups * lanes) return;
  auto group = [&](int g) {
    const int k = 4 * g;
    float wk[9][4], bk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = k + j < ch ? to_f(b[k + j]) : 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) wk[tap][j] = k + j < ch ? to_f(k3[tap * ch + k + j]) : 0.f;
    }
    for (int p = threadIdx.x / lanes; p < P; p += groups) {
      const int r = p / tw, c = p % tw;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 v = load(S * r + dy, S * c + dx, k);
          const float* q = wk[dy * 3 + dx];
          s[0] = fmaf(v.x, q[0], s[0]); s[1] = fmaf(v.y, q[1], s[1]);
          s[2] = fmaf(v.z, q[2], s[2]); s[3] = fmaf(v.w, q[3], s[3]);
        }
      *reinterpret_cast<float4*>(u + p * ldu + k) =
          make_float4(rnd<T>(s[0] + bk[0]), rnd<T>(s[1] + bk[1]), rnd<T>(s[2] + bk[2]),
                      rnd<T>(s[3] + bk[3]));
    }
  };
  if constexpr (Wide) {
    for (int g = threadIdx.x % lanes; g < c4; g += lanes) group(g);
  } else {
    group(threadIdx.x % c4);
  }
}

// out[2j] = y1[j], out[2j + 1] = y2[j], j < 4: one 32-byte (f32) or 16-byte
// (bf16) store of the shuffled pairs
__device__ __forceinline__ void store_pairs(float* o, const float* y1, const float* y2) {
  float4* d = reinterpret_cast<float4*>(o);
  d[0] = make_float4(y1[0], y2[0], y1[1], y2[1]);
  d[1] = make_float4(y1[2], y2[2], y1[3], y2[3]);
}
__device__ __forceinline__ void store_pairs(__nv_bfloat16* o, const float* y1, const float* y2) {
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(y1[j], y2[j]);
    u[j] = *reinterpret_cast<const unsigned*>(&pair);
  }
  *reinterpret_cast<uint4*>(o) = make_uint4(u[0], u[1], u[2], u[3]);
}

// One block: image blockIdx.y, output pixels [r0, r0 + th) x [c0, c0 + tw)
// clipped to the image, tile pixel p = (row - r0) * tw + (col - c0); the
// halo tile is (th + 2) x (tw + 2) from (r0 - 1, c0 - 1). Shared memory:
// the weights' k-chunks, bufT (x2 then t2 over the halo tile, in place;
// then u1) and bufU (u2, then y2 in place). Wide (a branch wider than
// kNBlock, off every path): bufT (x2, then u2, then u1), bufT2 (t2 over
// the halo tile) and bufY (y2). The f32 kernel fits 128 registers with no
// spill, so two blocks share an SM; the bf16 one needs 144 (its
// conversions) and the wide one its pass loops, and they take one.
template <class T, bool Wide>
__global__ void __launch_bounds__(kThreads, sizeof(T) == sizeof(float) && !Wide ? 2 : 1)
bottleneck_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const T* __restrict__ k1, const T* __restrict__ b1,
                  const T* __restrict__ w1, const T* __restrict__ c1,
                  const T* __restrict__ w2, const T* __restrict__ c2,
                  const T* __restrict__ k2, const T* __restrict__ b2,
                  const T* __restrict__ w3, const T* __restrict__ c3,
                  int H, int W, int ch, int co2, int th, int tw, bool vec_x, bool vec_out) {
  extern __shared__ float4 smem4[];
  const int hw = tw + 2, Ph = (th + 2) * hw, P = th * tw;
  const int ldT = pad_ld(ch), ldU = Wide ? ldT : pad_ld(max(ch, co2));
  const int ldY = Wide ? pad_ld(co2) : ldU;
  float* Bs = reinterpret_cast<float*>(smem4);
  float* bufT = reinterpret_cast<float*>(smem4) + kStageBytes / sizeof(float);
  float* bufT2 = Wide ? bufT + Ph * ldT : bufT;
  float* bufU = Wide ? bufT : bufT + Ph * ldT;
  float* bufY = Wide ? bufT2 + Ph * ldT : bufU;
  const int tiles_w = (W + tw - 1) / tw;
  const int r0 = blockIdx.x / tiles_w * th, c0 = blockIdx.x % tiles_w * tw;
  const int cin = 2 * ch, cout = 2 * co2;
  const T* xb = x + (size_t)blockIdx.y * H * W * cin;
  T* ob = out + (size_t)blockIdx.y * H * W * cout;

  // branch 2: t2 = silu(x2 @ w2 + c2) over the halo tile, 0 outside the image
  prefetch<T>(w2, ch, ch, Bs);
  stage_tile<T>(xb + ch, cin, H, W, r0 - 1, c0 - 1, th + 2, hw, ch, vec_x, nullptr, bufT,
                ldT);
  product<Wide, T>(bufT, ldT, Ph, ch, w2, c2, ch, Bs, [&](int p, int n0, const float* v) {
    const int r = r0 - 1 + p / hw, c = c0 - 1 + p % hw;
    const bool in = r >= 0 && r < H && c >= 0 && c < W;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = in && n0 + j < ch ? rnd<T>(silu_div2ulp(v[j])) : 0.f;
    *reinterpret_cast<float4*>(bufT2 + p * ldT + n0) = make_float4(o[0], o[1], o[2], o[3]);
  });
  __syncthreads();
  // u2 = dw3x3(t2) + b2, then y2 = silu(u2 @ w3 + c3), in place unless wide
  prefetch<T>(w3, ch, co2, Bs);
  dw3x3<1, Wide, T>(tw, P, k2, b2, ch,
                    [&](int hy, int hx, int k) { return ld4(bufT2 + (hy * hw + hx) * ldT + k); },
                    bufU, ldU);
  product<Wide, T>(bufU, ldU, P, ch, w3, c3, co2, Bs, [&](int p, int n0, const float* v) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = n0 + j < co2 ? rnd<T>(silu_div2ulp(v[j])) : 0.f;
    *reinterpret_cast<float4*>(bufY + p * ldY + n0) = make_float4(o[0], o[1], o[2], o[3]);
  });
  // branch 1: u1 = dw3x3(x1) + b1 from global memory, its 9 taps a pixel L1
  // and L2 hits (bufT's t2 or u2 was last read before the barriers of the
  // product above), then y1 = silu(u1 @ w1 + c1), written with y2 as
  // shuffled pairs
  prefetch<T>(w1, ch, co2, Bs);
  dw3x3<1, Wide, T>(tw, P, k1, b1, ch,
                    [&](int hy, int hx, int k) {
                      const int r = r0 - 1 + hy, c = c0 - 1 + hx;
                      if (r < 0 || r >= H || c < 0 || c >= W) return make_float4(0.f, 0.f, 0.f, 0.f);
                      const T* src = xb + ((size_t)r * W + c) * cin + k;
                      if (vec_x) return ldg4(src);
                      return make_float4(to_f(src[0]), k + 1 < ch ? to_f(src[1]) : 0.f,
                                         k + 2 < ch ? to_f(src[2]) : 0.f, k + 3 < ch ? to_f(src[3]) : 0.f);
                    },
                    bufT, ldT);
  product<Wide, T>(bufT, ldT, P, ch, w1, c1, co2, Bs, [&](int p, int n0, const float* v) {
    const int r = r0 + p / tw, c = c0 + p % tw;
    if (r >= H || c >= W) return;
    const float4 y2 = *reinterpret_cast<const float4*>(bufY + p * ldY + n0);
    const float y2v[4] = {y2.x, y2.y, y2.z, y2.w};
    float y1v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y1v[j] = silu_div2ulp(v[j]);
    T* o = ob + ((size_t)r * W + c) * cout + 2 * n0;
    if (vec_out) {
      store_pairs(o, y1v, y2v);
    } else {
      for (int j = 0; j < 4 && n0 + j < co2; ++j) {
        o[2 * j] = from_f<T>(y1v[j]);
        o[2 * j + 1] = from_f<T>(y2v[j]);
      }
    }
  });
}

// One block: image blockIdx.y, output pixels [r0, r0 + th) x [c0, c0 + tw)
// of the Ho x Wo output grid, clipped to it, tile pixel p = (row - r0) * tw
// + (col - c0); the input halo tile is (2th + 1) x (2tw + 1) from
// (2r0 - 1, 2c0 - 1), halo pixel q = row * (2tw + 1) + col. Shared memory:
// the weights' k-chunks, bufX (x over the halo tile, then t2 in place),
// bufU (u1) and bufV (u2, then y2 in place); u1 is taken from x before the
// t2 product overwrites it. Wide (a branch wider than kNBlock, off every
// path): bufX (x, then u2), bufT (t2 over the halo tile, then y2) and bufU
// (u1), so that no pass overwrites the A it reads. Registers as the
// bottleneck's: two blocks an SM for the f32 kernel, one for the others.
template <class T, bool Wide>
__global__ void __launch_bounds__(kThreads, sizeof(T) == sizeof(float) && !Wide ? 2 : 1)
downsample_kernel(const T* __restrict__ x, const T* __restrict__ tvec, T* __restrict__ out,
                  const T* __restrict__ k1, const T* __restrict__ b1,
                  const T* __restrict__ w1, const T* __restrict__ c1,
                  const T* __restrict__ w2, const T* __restrict__ c2,
                  const T* __restrict__ k2, const T* __restrict__ b2,
                  const T* __restrict__ w3, const T* __restrict__ c3,
                  int H, int W, int C, int co2, int th, int tw, bool vec_x, bool vec_out) {
  extern __shared__ float4 smem4[];
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int hw = 2 * tw + 1, Ph = (2 * th + 1) * hw, P = th * tw;
  const int ldX = pad_ld(max(C, co2)), ldU = pad_ld(C), ldV = Wide ? ldX : pad_ld(co2);
  float* Bs = reinterpret_cast<float*>(smem4);
  float* bufX = reinterpret_cast<float*>(smem4) + kStageBytes / sizeof(float);
  float* bufT = Wide ? bufX + Ph * ldX : bufX;
  float* bufU = bufT + Ph * ldX;
  float* bufV = Wide ? bufX : bufU + P * ldU;
  float* bufY = Wide ? bufT : bufV;
  const int tiles_w = (Wo + tw - 1) / tw;
  const int r0 = blockIdx.x / tiles_w * th, c0 = blockIdx.x % tiles_w * tw;
  const int y0 = 2 * r0 - 1, x0 = 2 * c0 - 1, cout = 2 * co2;
  const T* xb = x + (size_t)blockIdx.y * H * W * C;

  // x over the halo tile, the prologue applied once, 0 outside the image
  prefetch<T>(w2, C, co2, Bs);
  stage_tile<T, true>(xb, C, H, W, y0, x0, 2 * th + 1, hw, C, vec_x,
                      tvec ? tvec + (size_t)blockIdx.y * C : nullptr, bufX, ldX);
  __syncthreads();
  // branch 1: u1 = stride-2 dw3x3(x) + b1
  dw3x3<2, Wide, T>(tw, P, k1, b1, C,
                    [&](int hy, int hx, int k) { return ld4(bufX + (hy * hw + hx) * ldX + k); },
                    bufU, ldU);
  // branch 2: t2 = silu(x @ w2 + c2) over the halo tile, 0 outside the
  // image (the pad row or column past an odd grid too; a block whose halo
  // tile lies inside the image skips the test)
  const bool inside = y0 >= 0 && x0 >= 0 && y0 + 2 * th + 1 <= H && x0 + hw <= W;
  product<Wide, T>(bufX, ldX, Ph, C, w2, c2, co2, Bs, [&](int q, int n0, const float* v) {
    bool in = inside;
    if (!in) {
      const int r = y0 + q / hw, c = x0 + q % hw;
      in = r >= 0 && r < H && c >= 0 && c < W;
    }
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = in && n0 + j < co2 ? rnd<T>(silu_div2ulp(v[j])) : 0.f;
    *reinterpret_cast<float4*>(bufT + q * ldX + n0) = make_float4(o[0], o[1], o[2], o[3]);
  });
  __syncthreads();
  // u2 = stride-2 dw3x3(t2) + b2, then y2 = silu(u2 @ w3 + c3)
  prefetch<T>(w3, co2, co2, Bs);
  dw3x3<2, Wide, T>(tw, P, k2, b2, co2,
                    [&](int hy, int hx, int k) { return ld4(bufT + (hy * hw + hx) * ldX + k); },
                    bufV, ldV);
  product<Wide, T>(bufV, ldV, P, co2, w3, c3, co2, Bs, [&](int p, int n0, const float* v) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = n0 + j < co2 ? rnd<T>(silu_div2ulp(v[j])) : 0.f;
    *reinterpret_cast<float4*>(bufY + p * ldV + n0) = make_float4(o[0], o[1], o[2], o[3]);
  });
  // y1 = silu(u1 @ w1 + c1), written with y2 as shuffled pairs (the output
  // address formed here: a pointer held across the phases spilled)
  prefetch<T>(w1, C, co2, Bs);
  product<Wide, T>(bufU, ldU, P, C, w1, c1, co2, Bs, [&](int p, int n0, const float* v) {
    const int r = r0 + p / tw, c = c0 + p % tw;
    if (r >= Ho || c >= Wo) return;
    const float4 y2 = *reinterpret_cast<const float4*>(bufY + p * ldV + n0);
    const float y2v[4] = {y2.x, y2.y, y2.z, y2.w};
    float y1v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y1v[j] = silu_div2ulp(v[j]);
    T* o = out + (((size_t)blockIdx.y * Ho + r) * Wo + c) * cout + 2 * n0;
    if (vec_out) {
      store_pairs(o, y1v, y2v);
    } else {
      for (int j = 0; j < 4 && n0 + j < co2; ++j) {
        o[2 * j] = from_f<T>(y1v[j]);
        o[2 * j + 1] = from_f<T>(y2v[j]);
      }
    }
  });
}

// ops/shuffle.py::bottleneck_smem computes the same
size_t bottleneck_smem(int th, int tw, int ch, int co2) {
  const size_t halo = (size_t)(th + 2) * (tw + 2);
  const size_t tile = (size_t)th * tw;
  const size_t floats = (ch > kNBlock || co2 > kNBlock)
                            ? 2 * halo * pad_ld(ch) + tile * pad_ld(co2)
                            : halo * pad_ld(ch) + tile * pad_ld(ch > co2 ? ch : co2);
  return kStageBytes + floats * sizeof(float);
}

// ops/shuffle.py::downsample_smem computes the same
size_t downsample_smem(int th, int tw, int c, int co2) {
  const size_t halo = (size_t)(2 * th + 1) * (2 * tw + 1);
  const size_t tile = (size_t)th * tw;
  const size_t ld = pad_ld(c > co2 ? c : co2);
  const size_t floats = (c > kNBlock || co2 > kNBlock)
                            ? 2 * halo * ld + tile * pad_ld(c)
                            : halo * ld + tile * (pad_ld(c) + pad_ld(co2));
  return kStageBytes + floats * sizeof(float);
}

template <class T>
int launch_bottleneck(const void* x, void* out, const void* const* p, int B, int H, int W,
                      int ch, int co2, int th, int tw, int smem, void* stream) {
  if (th < 1 || tw < 1 || ch < 1 || co2 < 1 || smem < 0 ||
      (size_t)smem < bottleneck_smem(th, tw, ch, co2) || smem > kSmemLimit)
    return -1;
  const auto kernel = ch > kNBlock || co2 > kNBlock ? bottleneck_kernel<T, true>
                                                   : bottleneck_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), B);
  const bool vec_x = ch % (16 / (int)sizeof(T)) == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_out = co2 % 4 == 0 && (uintptr_t)out % 16 == 0;
  const T* const* q = reinterpret_cast<const T* const*>(p);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], H, W,
      ch, co2, th, tw, vec_x, vec_out);
  return (int)cudaGetLastError();
}

template <class T>
int launch_downsample(const void* x, const void* tvec, void* out, const void* const* p, int B,
                      int H, int W, int C, int co2, int th, int tw, int smem, void* stream) {
  if (th < 1 || tw < 1 || C < 1 || co2 < 1 || smem < 0 ||
      (size_t)smem < downsample_smem(th, tw, C, co2) || smem > kSmemLimit)
    return -1;
  const auto kernel = C > kNBlock || co2 > kNBlock ? downsample_kernel<T, true>
                                                  : downsample_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 grid(((Ho + th - 1) / th) * ((Wo + tw - 1) / tw), B);
  const bool vec_x = C % (16 / (int)sizeof(T)) == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_out = co2 % 4 == 0 && (uintptr_t)out % 16 == 0;
  const T* const* q = reinterpret_cast<const T* const*>(p);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)tvec, (T*)out, q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8],
      q[9], H, W, C, co2, th, tw, vec_x, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// params: ten device pointers in the order k1, b1, w1, c1, w2, c2, k2, b2, w3, c3.
// Each unit takes its th x tw tile of output pixels and the bytes of shared
// memory a block gets from ops/shuffle.py::bottleneck_plan / downsample_plan.
// Return 0, a cudaError_t, or -1 when the bytes given fall short of what the
// tile needs or exceed what a block may have.
extern "C" int shuffle_bottleneck_f32(const void* x, void* out, const void* const* params, int B,
                                      int H, int W, int ch, int co2, int th, int tw, int smem,
                                      void* stream) {
  return launch_bottleneck<float>(x, out, params, B, H, W, ch, co2, th, tw, smem, stream);
}

extern "C" int shuffle_bottleneck_bf16(const void* x, void* out, const void* const* params, int B,
                                       int H, int W, int ch, int co2, int th, int tw, int smem,
                                       void* stream) {
  return launch_bottleneck<__nv_bfloat16>(x, out, params, B, H, W, ch, co2, th, tw, smem,
                                          stream);
}

extern "C" int shuffle_downsample_f32(const void* x, const void* tvec, void* out,
                                      const void* const* params, int B, int H, int W, int C,
                                      int co2, int th, int tw, int smem, void* stream) {
  return launch_downsample<float>(x, tvec, out, params, B, H, W, C, co2, th, tw, smem, stream);
}

extern "C" int shuffle_downsample_bf16(const void* x, const void* tvec, void* out,
                                       const void* const* params, int B, int H, int W, int C,
                                       int co2, int th, int tw, int smem, void* stream) {
  return launch_downsample<__nv_bfloat16>(x, tvec, out, params, B, H, W, C, co2, th, tw, smem,
                                          stream);
}
