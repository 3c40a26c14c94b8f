// Fused reverse step of the discrete VQ-diffusion sampler for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels
// vq_vae_gan_diffusion_tpu/ops/discrete_posterior_pallas.py::
//   fused_posterior_sample       (gumbel read from memory; here B6)
//   fused_posterior_sample_prng  (gumbel drawn in the kernel; here B7)
// and computes what their body _posterior_body computes, per (b, n) row of
// K classes (the last one the mask class):
//
//   log_x0 = clamp(log_softmax(logits), -70, 0)            [K-1]
//   q-posterior on the one-hot carry x_t from ten per-row schedule scalars
//   ev     = clamp(log p(x_{t-1} | x_t), -70, 0)            [K]
//   (trunc_k > 0: keep the trunc_k largest ev, ties at the threshold kept)
//   out    = first argmax of ev + gumbel
//
// Bound: device memory. A row reads K-1 logits, K gumbel values (B6 only)
// and writes one index; the arithmetic is a few dozen flops a class. At the
// main path's 16 x 256 rows of 1024 classes that is ~33.5 MB a step for B6
// and ~16.8 MB for B7, 10 and 5 us at 3.35 TB/s.
//
// Design: the TPU kernel holds one batch row's whole [N, K] tile in VMEM;
// on Hopper every (b, n) row is independent, so one warp takes one row and
// keeps its K values in registers (lane l holds columns l, l + 32, ...,
// coalesced loads). Every reduction (two max, two sum-exp, the argmax, the
// 32 counting passes of the top-r radix select) is a warp shuffle: no
// shared memory and no block barrier. All arithmetic is f32; bf16 logits
// are converted on load. The formulas, their order of operations and the
// constants are those of the plain version (ops/discrete_posterior.py), so
// the two differ only by the order of the sums and the last bit of the
// math library, which moves an index only at a near tie.
//
// B7's stream is Philox4x32-10 written out here (the plain version repeats
// it in int64 arithmetic): word c % 4 at counter (c / 4, n, 0, 0) with key
// (seeds[b][0], seeds[b][1]); four lanes share one Philox block and each
// keeps its own word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // rows a block
constexpr int kMaxClasses = 2048;    // K the widest instance (kPer 64) takes
constexpr float kLogEps = -70.0f;
constexpr float kMasked = -3e38f;

// float32(log(1e-30)), the constant _LZ of the JAX kernel, bit for bit
__device__ __forceinline__ float log_zero() { return __int_as_float(0xc28a27b5); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float clamp_log(float x) { return fminf(fmaxf(x, kLogEps), 0.0f); }

// max + log1p(exp(-|a - b|)): jnp.logaddexp's form, and the plain version's
__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// order-preserving uint32 key of a float; -0.0 maps to +0.0's key
__device__ __forceinline__ uint32_t monotone_key(float x) {
  const uint32_t u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t k0,
                                               uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// a 24-bit uniform on [0, 1), then -log(-log(u + 1e-30) + 1e-30)
__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = (float)(bits >> 8) * 5.9604644775390625e-08f;   // 2^-24
  return -logf(-logf(u + 1e-30f) + 1e-30f);
}

template <class T, int kPer, bool kPrng>
__global__ void __launch_bounds__(kWarps * 32)
posterior_kernel(const T* __restrict__ logits, const long long* __restrict__ x_t,
                 const float* __restrict__ coefs, const float* __restrict__ gumbel,
                 const int* __restrict__ seeds, long long* __restrict__ out, int B, int N, int K,
                 int trunc_k) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)B * N) return;
  const int b = (int)(row / N), n = (int)(row % N);
  const int km1 = K - 1;
  const T* lrow = logits + row * km1;
  const float lz = log_zero();

  // predict_start: log_softmax of the K-1 logits, clamped
  float v[kPer];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < km1 ? to_f32(lrow[c]) : -INFINITY;
    m = fmaxf(m, v[j]);
  }
  m = warp_max(m);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (lane + 32 * j < km1) s += expf(v[j] - m);
  const float lse = m + logf(warp_sum(s));

  const float* cf = coefs + (size_t)b * 10;
  const float log_att = cf[0], log_btt = cf[1], log_ctt = cf[2];
  const float log_at = cf[3], log_bt = cf[4], log_ct = cf[5];
  const float log_att_m1 = cf[6], log_btt_m1 = cf[7], log_ctt_m1 = cf[8], log_1mctt_m1 = cf[9];
  const float log_att_btt = logaddexp(log_att, log_btt);
  const float log_at_bt = logaddexp(log_at, log_bt);
  const long long xt = x_t[row];
  const bool is_mask = xt == km1;

  // q = log_x0 - q_pred(onehot x_t, t), masked rows against log ctt
  float m2 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    if (c < km1) {
      const bool at_col = c == xt && !is_mask;
      const float log_qt = at_col ? log_att_btt : (is_mask ? log_ctt : log_btt);
      v[j] = clamp_log(v[j] - lse) - log_qt;
      m2 = fmaxf(m2, v[j]);
    }
  }
  // logsumexp over [q | log 1e-30]
  m2 = fmaxf(warp_max(m2), lz);
  s = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (lane + 32 * j < km1) s += expf(v[j] - m2);
  const float q_lse = m2 + logf(warp_sum(s) + expf(lz - m2));

  // ev = q_pred(q normalised, t - 1) + q_pred_one_timestep(onehot x_t, t) + q_lse
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    if (c < km1) {
      const bool at_col = c == xt && !is_mask;
      const float qp = logaddexp((v[j] - q_lse) + log_att_m1, log_btt_m1);
      const float qt1 = at_col ? log_at_bt : (is_mask ? log_ct : log_bt);
      v[j] = clamp_log(qp + qt1 + q_lse);
    } else if (c == km1) {
      const float qp = logaddexp((lz - q_lse) + log_1mctt_m1, log_ctt_m1);
      v[j] = clamp_log(qp + (is_mask ? 0.0f : lz) + q_lse);
    }
  }

  // top-r: the trunc_k-th largest key by radix select, MSB first
  uint32_t kth = 0;
  if (trunc_k > 0) {
    int kk = trunc_k;
    for (int i = 31; i >= 0; --i) {
      const uint32_t hi = i < 31 ? (0xFFFFFFFFu << (i + 1)) : 0u;
      const uint32_t bit = 1u << i;
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const uint32_t key = monotone_key(v[j]);
        cnt += (lane + 32 * j < K) && (key & hi) == kth && (key & bit);
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (kk <= cnt) kth |= bit;
      else kk -= cnt;
    }
  }

  // the sample: first maximum of ev + gumbel
  float best = -INFINITY;
  int best_c = K;
  const float* grow = kPrng ? nullptr : gumbel + row * K;
  const uint32_t k0 = kPrng ? (uint32_t)seeds[2 * b] : 0u;
  const uint32_t k1 = kPrng ? (uint32_t)seeds[2 * b + 1] : 0u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + 32 * j;
    if (c < K) {
      float g;
      if (kPrng) {
        const uint4 w = philox4x32_10((uint32_t)(c >> 2), (uint32_t)n, k0, k1);
        const int word = c & 3;
        g = gumbel_from_bits(word == 0 ? w.x : word == 1 ? w.y : word == 2 ? w.z : w.w);
      } else {
        g = grow[c];
      }
      float score = v[j] + g;
      if (trunc_k > 0 && monotone_key(v[j]) < kth) score = kMasked;
      if (score > best) {
        best = score;
        best_c = c;
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oc = __shfl_xor_sync(0xffffffffu, best_c, o);
    if (ob > best || (ob == best && oc < best_c)) {
      best = ob;
      best_c = oc;
    }
  }
  if (lane == 0) out[row] = best_c;
}

template <class T, int kPer, bool kPrng>
int launch_per(const void* logits, const void* x_t, const void* coefs, const void* noise,
               void* out, int B, int N, int K, int trunc_k, void* stream) {
  const long long rows = (long long)B * N;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  posterior_kernel<T, kPer, kPrng><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)logits, (const long long*)x_t, (const float*)coefs,
      kPrng ? nullptr : (const float*)noise, kPrng ? (const int*)noise : nullptr,
      (long long*)out, B, N, K, trunc_k);
  return (int)cudaGetLastError();
}

template <class T, bool kPrng>
int launch(const void* logits, const void* x_t, const void* coefs, const void* noise, void* out,
           int B, int N, int K, int trunc_k, void* stream) {
  if (K < 2 || K > kMaxClasses || trunc_k < 0 || trunc_k > K || B < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return 0;
  if (K <= 128) return launch_per<T, 4, kPrng>(logits, x_t, coefs, noise, out, B, N, K, trunc_k, stream);
  if (K <= 256) return launch_per<T, 8, kPrng>(logits, x_t, coefs, noise, out, B, N, K, trunc_k, stream);
  if (K <= 512) return launch_per<T, 16, kPrng>(logits, x_t, coefs, noise, out, B, N, K, trunc_k, stream);
  if (K <= 33 * 32)
    return launch_per<T, 33, kPrng>(logits, x_t, coefs, noise, out, B, N, K, trunc_k, stream);
  return launch_per<T, 64, kPrng>(logits, x_t, coefs, noise, out, B, N, K, trunc_k, stream);
}

}  // namespace

// logits [B, N, K-1] (f32 or bf16), x_t [B, N] int64, coefs [B, 10] f32,
// gumbel [B, N, K] f32 (or seeds [B, 2] int32), out [B, N] int64; all
// contiguous on one device. Returns 0 or a cudaError_t.
extern "C" int discrete_posterior_f32(const void* logits, const void* x_t, const void* coefs,
                                      const void* gumbel, void* out, int B, int N, int K,
                                      int trunc_k, void* stream) {
  return launch<float, false>(logits, x_t, coefs, gumbel, out, B, N, K, trunc_k, stream);
}

extern "C" int discrete_posterior_bf16(const void* logits, const void* x_t, const void* coefs,
                                       const void* gumbel, void* out, int B, int N, int K,
                                       int trunc_k, void* stream) {
  return launch<__nv_bfloat16, false>(logits, x_t, coefs, gumbel, out, B, N, K, trunc_k, stream);
}

extern "C" int discrete_posterior_prng_f32(const void* logits, const void* x_t,
                                           const void* coefs, const void* seeds, void* out, int B,
                                           int N, int K, int trunc_k, void* stream) {
  return launch<float, true>(logits, x_t, coefs, seeds, out, B, N, K, trunc_k, stream);
}

extern "C" int discrete_posterior_prng_bf16(const void* logits, const void* x_t,
                                            const void* coefs, const void* seeds, void* out,
                                            int B, int N, int K, int trunc_k, void* stream) {
  return launch<__nv_bfloat16, true>(logits, x_t, coefs, seeds, out, B, N, K, trunc_k, stream);
}
