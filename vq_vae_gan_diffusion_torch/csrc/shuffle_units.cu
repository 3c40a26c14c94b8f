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
// Design (a first, simple kernel): one block per (image, tile of `th` rows
// of full width). Branch 2's first pointwise product runs on the tile plus
// one halo row above and below (its dw needs them) into shared memory; each
// dw writes its tile to shared memory; every pointwise product is a tiled
// f32 GEMM in the block with A and B staged through shared memory in
// k-chunks of 16, so no weight matrix has to fit (w2 at 256x256 f32 is
// 256 KB). What bounds it: at the path's shapes the three pointwise
// products are 80-90% of the operations at about 40 f32 operations per byte
// of activation, so the f32 CUDA-core rate bounds it (see chip_smoke.py's
// bound). Tensor cores, TMA and fusing units are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;            // k-chunk of the pointwise GEMM
constexpr int kMaxPT = 256;        // widest pixel tile (n-tile 16)
constexpr int kAStage = kKC * (kMaxPT + 4);
constexpr int kBStage = kKC * 64;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kTargetBlocks = 264;  // two blocks for each of 132 SMs

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

template <class T>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const T* __restrict__ k1, const T* __restrict__ b1,
                  const T* __restrict__ w1, const T* __restrict__ c1,
                  const T* __restrict__ w2, const T* __restrict__ c2,
                  const T* __restrict__ k2, const T* __restrict__ b2,
                  const T* __restrict__ w3, const T* __restrict__ c3,
                  int H, int W, int ch, int co2, int th) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kAStage;
  float* bufT = Bs + kBStage;                         // (th + 2) * W * ch
  float* bufU = bufT + (size_t)(th + 2) * W * ch;     // th * W * ch
  const int r0 = blockIdx.x * th;
  const int rows = min(th, H - r0);
  const int cin = 2 * ch, cout = 2 * co2;
  const int HW = H * W;
  const T* xb = x + (size_t)blockIdx.y * HW * cin;
  T* ob = out + ((size_t)blockIdx.y * HW + (size_t)r0 * W) * cout;
  const int P = rows * W;

  // branch 1: u1 = dw3x3(x1) + b1, zero padding
  for (int e = threadIdx.x; e < P * ch; e += kThreads) {
    const int k = e % ch, p = e / ch;
    const int r = r0 + p / W, c = p % W;
    float s = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = r + dy - 1;
      if (yy < 0 || yy >= H) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = c + dx - 1;
        if (xx < 0 || xx >= W) continue;
        s = fmaf(to_f(xb[((size_t)yy * W + xx) * cin + k]), to_f(k1[(dy * 3 + dx) * ch + k]), s);
      }
    }
    bufU[e] = rnd<T>(s + to_f(b1[k]));
  }
  __syncthreads();
  pointwise<T>(
      P, ch, co2, [&](int p, int k) { return bufU[p * ch + k]; }, w1, c1,
      [&](int p, int n, float v) { ob[(size_t)p * cout + 2 * n] = from_f<T>(silu(v)); }, As, Bs);

  // branch 2: t2 = silu(x2 @ w2 + c2) on rows r0-1 .. r0+rows, 0 outside the image
  const int q0 = (r0 - 1) * W;
  pointwise<T>(
      (rows + 2) * W, ch, ch,
      [&](int p, int k) {
        const int q = q0 + p;
        return (q >= 0 && q < HW) ? to_f(xb[(size_t)q * cin + ch + k]) : 0.f;
      },
      w2, c2,
      [&](int p, int n, float v) {
        const int q = q0 + p;
        bufT[p * ch + n] = (q >= 0 && q < HW) ? rnd<T>(silu(v)) : 0.f;
      },
      As, Bs);
  // u2 = dw3x3(t2) + b2
  for (int e = threadIdx.x; e < P * ch; e += kThreads) {
    const int k = e % ch, p = e / ch;
    const int r = p / W, c = p % W;
    float s = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = c + dx - 1;
        if (xx < 0 || xx >= W) continue;
        s = fmaf(bufT[((r + dy) * W + xx) * ch + k], to_f(k2[(dy * 3 + dx) * ch + k]), s);
      }
    }
    bufU[e] = rnd<T>(s + to_f(b2[k]));
  }
  __syncthreads();
  pointwise<T>(
      P, ch, co2, [&](int p, int k) { return bufU[p * ch + k]; }, w3, c3,
      [&](int p, int n, float v) { ob[(size_t)p * cout + 2 * n + 1] = from_f<T>(silu(v)); },
      As, Bs);
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

size_t bottleneck_smem(int W, int ch, int th) {
  return stage_bytes() + (size_t)(2 * th + 2) * W * ch * sizeof(float);
}

size_t downsample_smem(int W, int C, int co2, int tho) {
  const int wide = C > co2 ? C : co2;
  return stage_bytes() +
         ((size_t)(2 * tho + 1) * W * co2 + (size_t)tho * ((W + 1) / 2) * wide) * sizeof(float);
}

// Rows per block: at most 4; fewer while a block would need more than half
// an SM's shared memory or the grid would have fewer than kTargetBlocks.
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
                      int ch, int co2, void* stream) {
  const int th = pick_rows(B, H, [&](int t) { return bottleneck_smem(W, ch, t); });
  const size_t smem = bottleneck_smem(W, ch, th);
  if (smem > (size_t)kSmemLimit) return -1;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + th - 1) / th, B);
  const T* const* q = reinterpret_cast<const T* const*>(p);
  bottleneck_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], H, W,
      ch, co2, th);
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
// Return 0, a cudaError_t, or -1 when a block would need more shared memory
// than the card has.
extern "C" int shuffle_bottleneck_f32(const void* x, void* out, const void* const* params, int B,
                                      int H, int W, int ch, int co2, void* stream) {
  return launch_bottleneck<float>(x, out, params, B, H, W, ch, co2, stream);
}

extern "C" int shuffle_bottleneck_bf16(const void* x, void* out, const void* const* params, int B,
                                       int H, int W, int ch, int co2, void* stream) {
  return launch_bottleneck<__nv_bfloat16>(x, out, params, B, H, W, ch, co2, stream);
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
