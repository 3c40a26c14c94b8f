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
// What bounds the bottleneck on an H100: its three pointwise products are
// 80-90% of its operations, so at 128 input channels or more the f32
// CUDA-core rate (67 TFLOP/s) bounds it, at 64 or fewer the bytes of its
// input and output (3.35 TB/s; utils/profiling.py::shuffle_unit_bound). The first
// version covered th rows of full image width a block, so its shared memory
// grew with W: at W = 256 th fell to 1, one block of 8 warps sat on an SM,
// branch 2's first product ran on 3 rows to give 1, and every product went
// through a GEMM loop that staged A element by element with two barriers
// every 16 deep.
//
// Bottleneck design:
// - One block per (image, th x tw tile of output pixels), the tile chosen
//   in Python (ops/shuffle.py::bottleneck_plan, which mirrors this file's
//   bottleneck_smem) so that shared memory follows the tile, not the width:
//   two blocks an SM, a halo factor (th+2)(tw+2)/(th tw) of 1.2-1.9.
// - x2 over the halo tile is staged in shared memory with 16-byte loads;
//   t2 = silu(x2 @ w2 + c2) overwrites it in place, 0 at halo pixels
//   outside the image (rows and columns); u2 = dw(t2) goes to a second
//   buffer and y2 overwrites u2 in place; branch 1's dw reads x1 from
//   global memory (L1/L2 hits) into the first buffer, and the last product's
//   epilogue writes y1 and y2 as shuffled pairs, 32 bytes a thread (f32).
// - The products (gemm) read A from shared memory as float4 along k, rows
//   padded to 4 mod 8 floats against bank conflicts; each thread holds an
//   8-pixel x 4-column register tile, a warp 32 x 32 (narrower N: taller);
//   weights come by cp.async, whole or in double-buffered k-chunks, each
//   product's first chunk issued before the work that precedes it. A product
//   covers kNBlock columns in one pass; a branch wider than that (off every
//   path) runs in passes of kNBlock columns, and its block keeps t2 and y2
//   apart from x2 and u2, since a pass must not overwrite the A it reads.
// - Sums stay in f32 on CUDA cores; SiLU takes the plain version's expf and
//   a divide within 2 ulp (silu_div2ulp).
// ops/shuffle.py owns the constants both sides use (kSmemLimit,
// kTargetBlocks, kStageBytes, kNBlock, pad_ld, bottleneck_smem);
// tests/test_torch_port_shuffle_plan.py checks that this file agrees.
// Downsample design: one block per (image, rows of full width), the first
// version's GEMM loop. Tensor cores, TMA, channel streaming and fusing
// units are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;            // k-chunk of the pointwise GEMM
constexpr int kMaxPT = 256;        // widest pixel tile (n-tile 16)
constexpr int kAStage = kKC * (kMaxPT + 4);
constexpr int kBStage = kKC * 64;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kTargetBlocks = 264;  // two blocks for each of 132 SMs
constexpr int kStageBytes = 16384;  // the bottleneck's k-chunk buffers of weights
constexpr int kNBlock = 256;        // columns of one pass of a bottleneck product (8 warps x 32)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and held in f32: an operand of a product in T
template <class T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
// The bottleneck's: the same exp, the divide within 2 ulp (an IEEE divide
// brings a slow-path call, and with it spills, into the kernel)
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest one has landed
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// C[P, N] = A[P, K] @ w[K, N] + bias, handed to store(p, n, value).
// 256 threads; each holds a 4x4 accumulator tile. The n-tile NT is 64, 32
// or 16 by N, the pixel tile 4096 / NT. A comes from loadA(p, k) (global
// memory or shared memory), staged k-major in As; w is staged in Bs.
// Ends with __syncthreads(), so the caller may overwrite what loadA read.
template <class T, class LoadA, class Store>
__device__ void pointwise(int P, int K, int N, const LoadA& loadA,
                          const T* __restrict__ w, const T* __restrict__ bias,
                          const Store& store, float* As, float* Bs) {
  const int NT = N >= 64 ? 64 : (N >= 32 ? 32 : 16);
  const int PT = 4096 / NT;
  const int ast = PT + 4;
  const int tid = threadIdx.x;
  const int tx = tid % (NT / 4), ty = tid / (NT / 4);
  for (int p0 = 0; p0 < P; p0 += PT) {
    for (int n0 = 0; n0 < N; n0 += NT) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kKC) {
        __syncthreads();
        for (int e = tid; e < PT * kKC; e += kThreads) {
          const int kk = e % kKC, pp = e / kKC;
          const int p = p0 + pp, k = k0 + kk;
          As[kk * ast + pp] = (p < P && k < K) ? loadA(p, k) : 0.f;
        }
        for (int e = tid; e < kKC * NT; e += kThreads) {
          const int nn = e % NT, kk = e / NT;
          const int n = n0 + nn, k = k0 + kk;
          Bs[kk * NT + nn] = (n < N && k < K) ? to_f(w[(size_t)k * N + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&As[kk * ast + ty * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&Bs[kk * NT + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n < N) store(p, n, acc[i][j] + to_f(bias[n]));
        }
      }
    }
  }
  __syncthreads();
}

// rows x cols pixels of one image, from (y0, x0), channels [0, ch) of each
// pixel (row stride cin), into dst[p * ld + k] as f32, p = row * cols + col;
// 0 at pixels outside the image and at k in [ch, round4(ch)) (ld >= that).
// 16-byte loads when vec (ch a multiple of 16 bytes, x 16-byte aligned).
template <class T>
__device__ void stage_tile(const T* __restrict__ src, int cin, int H, int W, int y0, int x0,
                           int rows, int cols, int ch, bool vec, float* __restrict__ dst, int ld) {
  constexpr int V = 16 / sizeof(T);
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
      dst[p * ld + k] = (k < ch && y >= 0 && y < H && xx >= 0 && xx < W)
                            ? to_f(src[((size_t)y * W + xx) * cin + k])
                            : 0.f;
    }
  }
}

// How the bottleneck's products cut w [K, N] (row stride ldw >= N) into
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

// One pass of the bottleneck's pointwise products: rows [0, rows) of
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

// u[p * ldu + k] = rnd<T>(dw3x3(src) + b) for the tile's P pixels
// p = ty * tw + tx and k < round4(ch) (0 past ch). load(hy, hx, k) gives
// channels k .. k + 3 of the source at (hy, hx) of the halo tile, whose
// (0, 0) lies one row above and one column left of the tile's first pixel,
// 0 outside the image. Each thread keeps one group of 4 channels' taps in
// registers and walks the pixels; past kThreads groups (Wide only) it takes
// the next group after.
template <bool Wide, class T, class Load>
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
          const float4 v = load(r + dy, c + dx, k);
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
  stage_tile<T>(xb + ch, cin, H, W, r0 - 1, c0 - 1, th + 2, hw, ch, vec_x, bufT, ldT);
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
  dw3x3<Wide, T>(tw, P, k2, b2, ch,
           [&](int hy, int hx, int k) { return ld4(bufT2 + (hy * hw + hx) * ldT + k); }, bufU,
           ldU);
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
  dw3x3<Wide, T>(tw, P, k1, b1, ch,
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

template <class T>
__global__ void __launch_bounds__(kThreads)
downsample_kernel(const T* __restrict__ x, const T* __restrict__ tvec, T* __restrict__ out,
                  const T* __restrict__ k1, const T* __restrict__ b1,
                  const T* __restrict__ w1, const T* __restrict__ c1,
                  const T* __restrict__ w2, const T* __restrict__ c2,
                  const T* __restrict__ k2, const T* __restrict__ b2,
                  const T* __restrict__ w3, const T* __restrict__ c3,
                  int H, int W, int C, int co2, int tho) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kAStage;
  float* bufT = Bs + kBStage;                          // (2 * tho + 1) * W * co2
  float* bufU = bufT + (size_t)(2 * tho + 1) * W * co2;  // tho * Wo * max(C, co2)
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int i0 = blockIdx.x * tho;
  const int rows = min(tho, Ho - i0);
  const int cout = 2 * co2;
  const int HW = H * W;
  const T* xb = x + (size_t)blockIdx.y * HW * C;
  const T* tb = tvec ? tvec + (size_t)blockIdx.y * C : nullptr;
  T* ob = out + ((size_t)blockIdx.y * Ho * Wo + (size_t)i0 * Wo) * cout;
  const int P = rows * Wo;
  // input pixel q of this image, channel k, after the optional prologue
  auto xin = [&](int q, int k) {
    const float v = to_f(xb[(size_t)q * C + k]);
    return tb ? rnd<T>(silu(v + to_f(tb[k]))) : v;
  };

  // branch 1: u1 = stride-2 dw3x3(x) + b1 over all C channels
  for (int e = threadIdx.x; e < P * C; e += kThreads) {
    const int k = e % C, p = e / C;
    const int i = i0 + p / Wo, j = p % Wo;
    float s = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = 2 * i + dy - 1;
      if (yy < 0 || yy >= H) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = 2 * j + dx - 1;
        if (xx < 0 || xx >= W) continue;
        s = fmaf(xin(yy * W + xx, k), to_f(k1[(dy * 3 + dx) * C + k]), s);
      }
    }
    bufU[e] = rnd<T>(s + to_f(b1[k]));
  }
  __syncthreads();
  pointwise<T>(
      P, C, co2, [&](int p, int k) { return bufU[p * C + k]; }, w1, c1,
      [&](int p, int n, float v) { ob[(size_t)p * cout + 2 * n] = from_f<T>(silu(v)); }, As, Bs);

  // branch 2: t2 = silu(x @ w2 + c2) at full resolution on input rows
  // 2*i0-1 .. 2*(i0+rows-1)+1, 0 outside the image (row H of an odd grid too)
  const int q0 = (2 * i0 - 1) * W;
  pointwise<T>(
      (2 * rows + 1) * W, C, co2,
      [&](int p, int k) {
        const int q = q0 + p;
        return (q >= 0 && q < HW) ? xin(q, k) : 0.f;
      },
      w2, c2,
      [&](int p, int n, float v) {
        const int q = q0 + p;
        bufT[p * co2 + n] = (q >= 0 && q < HW) ? rnd<T>(silu(v)) : 0.f;
      },
      As, Bs);
  // u2 = stride-2 dw3x3(t2) + b2
  for (int e = threadIdx.x; e < P * co2; e += kThreads) {
    const int k = e % co2, p = e / co2;
    const int i = p / Wo, j = p % Wo;
    float s = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = 2 * j + dx - 1;
        if (xx < 0 || xx >= W) continue;
        s = fmaf(bufT[((2 * i + dy) * W + xx) * co2 + k], to_f(k2[(dy * 3 + dx) * co2 + k]), s);
      }
    }
    bufU[e] = rnd<T>(s + to_f(b2[k]));
  }
  __syncthreads();
  pointwise<T>(
      P, co2, co2, [&](int p, int k) { return bufU[p * co2 + k]; }, w3, c3,
      [&](int p, int n, float v) { ob[(size_t)p * cout + 2 * n + 1] = from_f<T>(silu(v)); },
      As, Bs);
}

size_t stage_bytes() { return (size_t)(kAStage + kBStage) * sizeof(float); }

// ops/shuffle.py::bottleneck_smem computes the same
size_t bottleneck_smem(int th, int tw, int ch, int co2) {
  const size_t halo = (size_t)(th + 2) * (tw + 2), tile = (size_t)th * tw;
  const size_t floats = (ch > kNBlock || co2 > kNBlock)
                            ? 2 * halo * pad_ld(ch) + tile * pad_ld(co2)
                            : halo * pad_ld(ch) + tile * pad_ld(ch > co2 ? ch : co2);
  return kStageBytes + floats * sizeof(float);
}

size_t downsample_smem(int W, int C, int co2, int tho) {
  const int wide = C > co2 ? C : co2;
  return stage_bytes() +
         ((size_t)(2 * tho + 1) * W * co2 + (size_t)tho * ((W + 1) / 2) * wide) * sizeof(float);
}

// Downsample rows per block: at most 4; fewer while a block would need more
// than half an SM's shared memory or the grid would have fewer than
// kTargetBlocks.
template <class Smem>
int pick_rows(int batch, int rows_out, Smem smem) {
  int th = 4;
  while (th > 1 && (smem(th) > (size_t)kSmemLimit / 2 ||
                    (size_t)batch * ((rows_out + th - 1) / th) < kTargetBlocks))
    th /= 2;
  return th;
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
                      int H, int W, int C, int co2, void* stream) {
  const int Ho = (H + 1) / 2;
  const int tho = pick_rows(B, Ho, [&](int t) { return downsample_smem(W, C, co2, t); });
  const size_t smem = downsample_smem(W, C, co2, tho);
  if (smem > (size_t)kSmemLimit) return -1;
  cudaError_t err = cudaFuncSetAttribute(downsample_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Ho + tho - 1) / tho, B);
  const T* const* q = reinterpret_cast<const T* const*>(p);
  downsample_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)tvec, (T*)out, q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7],
      q[8], q[9], H, W, C, co2, tho);
  return (int)cudaGetLastError();
}

}  // namespace

// params: ten device pointers in the order k1, b1, w1, c1, w2, c2, k2, b2, w3, c3.
// The bottleneck takes its th x tw tile and the bytes of shared memory a
// block gets from ops/shuffle.py::bottleneck_plan. Return 0, a cudaError_t,
// or -1 when the bytes given fall short of what the tile needs or exceed
// what a block may have (the downsample: when its rows need more than that).
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
                                      int co2, void* stream) {
  return launch_downsample<float>(x, tvec, out, params, B, H, W, C, co2, stream);
}

extern "C" int shuffle_downsample_bf16(const void* x, const void* tvec, void* out,
                                       const void* const* params, int B, int H, int W, int C,
                                       int co2, void* stream) {
  return launch_downsample<__nv_bfloat16>(x, tvec, out, params, B, H, W, C, co2, stream);
}
