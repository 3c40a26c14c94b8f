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
// Bound: device memory for B6, the SFU for B7. A row reads K-1 logits, K
// gumbel values (B6 only) and writes one index: at the main path's 16 x 256
// rows of 1024 classes ~33.5 MB a step for B6 and ~16.8 MB for B7, 10 and
// 5 us at 3.35 TB/s. Per class the function needs 3 expf and a log1pf (B7
// two logf more) on the SFU, 4 and 6 us. What this kernel takes is set by
// neither: the library's expf, log1pf and logf cost about 100 instructions
// a class, in dependent chains, and the arithmetic alone (no copies) takes
// about four fifths of B6's time on an NVIDIA H100 80GB HBM3 at 700 W
// (utils/profiling.posterior_bound counts the function's work, not these
// instructions).
//
// Design: one warp a (b, n) row, kRows rows a block. The row is staged in
// shared memory, not registers, so a thread needs few registers
// (__launch_bounds__ asks for 64 at most: 32 warps an SM; f32 B6 at K =
// 1024 holds 6 blocks, 24 warps, by its 32.8 KB of staged rows a block),
// and every global read of the block is issued before any arithmetic. A
// block copies its kRows consecutive rows as one contiguous span of logits
// (and, for B6, one span of Gumbel noise) with 16-byte cp.async pieces;
// only the span's two unaligned ends go element by element (K - 1 = 1023
// leaves a row 4-byte aligned only). The Gumbel span is a second copy
// group that lands while the logits' passes run.
//
// Small blocks, no persistent loop: a block's rows are all in flight at
// once, so what is left to overlap is one block's arithmetic with another
// block's copies, and the scheduler does that across the 1024 blocks of
// the main path. A persistent grid with a double-buffered span a block
// holds half as many rows an SM for the same shared memory, and measured
// slower (B6 0.033 against 0.027 ms on an NVIDIA H100 80GB HBM3 at 700 W):
// the arithmetic needs the resident warps more than the copies need a
// second buffer.
//
// The passes read the staged row again instead of keeping it in
// registers: two max and two sum-exp passes (the warp reductions are
// shuffles), then ev a class. f32 rows keep q over their logits from the
// third pass on; bf16 rows compute it again from the logit. With trunc_k
// = 0, ev goes straight into the argmax, which computes ev at every column
// and selects the mask column's value after, with no branch around the
// arithmetic. Otherwise each class's order-preserving key of ev is
// computed once, with its top digit counted, and kept in shared memory
// (over the f32 row; bf16 rows get a region of their own); the trunc_k-th
// largest key is found by 8-bit digits (a 256-bin histogram a warp, a warp
// scan; three more passes over the keys) where 32 one-bit passes stood,
// and the argmax reads ev back from the keys. All arithmetic is f32; bf16
// logits are converted on read. The formulas, their order of operations
// and the constants are those of the plain version
// (ops/discrete_posterior.py), so the two differ only by the order of the
// sums and the last bit of the math library, which moves an index only at
// a near tie.
//
// Rows wider than kMaxStaged classes, which the JAX package's kernel also
// takes (its fits_vmem: n * K <= 2^20), are not staged: each pass reads
// the row from device memory (through L1, where a block's rows of a few
// thousand classes stay), q is computed again from the logit in every
// type, and under top-r the keys of ev are computed again in each pass of
// the select instead of being kept. A block still holds kRows rows, one a
// warp, and only the histograms take shared memory, so any K up to
// kMaxClasses is taken.
//
// B7's stream is Philox4x32-10 written out here (the plain version repeats
// it in int64 arithmetic): word c % 4 at counter (c / 4, n, 0, 0) with key
// (seeds[b][0], seeds[b][1]). In the argmax a lane computes each of its
// Philox blocks once and takes the block's four columns (lane l: blocks l,
// l + 32, ...); the staged row makes that layout free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;             // rows a block, one warp each
constexpr int kMaxStaged = 2048;     // the widest row (K) staged in shared memory
constexpr int kMaxClasses = 1 << 20; // the widest row (K) the kernel takes
constexpr int kSmemLimit = 232448;   // shared memory a block may use
constexpr int kSmemDefault = 49152;  // what a block may use without opting in
constexpr int kBins = 256;           // the top-r select's 8-bit digits
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
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared memory of one block. Staged rows: the logits span (kRows rows of
// K - 1 values and up to 15 bytes of lead), the Gumbel span (B6); when
// trunc_k > 0 the keys of bf16 rows (f32 rows keep them over their logits)
// and a 256-bin histogram a warp. Rows read from device memory: the
// histograms alone.
__host__ __device__ constexpr int posterior_smem(int K, int es, bool prng, bool trunc,
                                                 bool staged) {
  return (staged ? align16(kRows * (K - 1) * es + 16) +
                       (prng ? 0 : align16(kRows * K * 4 + 16)) +
                       (trunc && es != 4 ? kRows * (K - 1) * 4 : 0)
                 : 0) +
         (trunc ? kRows * kBins * 4 : 0);
}
// the widest staged row fits in either type, so no K is refused for its
// shared memory
static_assert(posterior_smem(kMaxStaged, 4, false, true, true) <= kSmemLimit &&
                  posterior_smem(kMaxStaged, 2, false, true, true) <= kSmemLimit,
              "a block of the widest staged rows exceeds the shared memory of a block");

// Copy the n elements at src into dst + (src % 16), dst 16-byte aligned:
// 16-byte cp.async pieces between the first and the last 16-byte boundary
// inside the span, single elements before and after them. Reads no byte
// outside [src, src + n).
template <class E>
__device__ __forceinline__ void stage_span(char* dst, const E* src, long long n) {
  const uintptr_t s = (uintptr_t)src, e = s + (uintptr_t)n * sizeof(E);
  const uintptr_t base = s & ~(uintptr_t)15, a = (s + 15) & ~(uintptr_t)15,
                  b = e & ~(uintptr_t)15;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (uintptr_t p = a + 16 * (uintptr_t)tid; p < b; p += 16 * (uintptr_t)nt)
    cp_async16(dst + (p - base), (const void*)p);
  const uintptr_t head = a < e ? a : e, tail = a > b ? a : b;
  for (uintptr_t p = s + sizeof(E) * tid; p < head; p += sizeof(E) * nt)
    *(E*)(dst + (p - base)) = *(const E*)p;
  for (uintptr_t p = tail + sizeof(E) * tid; p < e; p += sizeof(E) * nt)
    *(E*)(dst + (p - base)) = *(const E*)p;
}

// The per-row scalars of the q-posterior; q and ev of one class. xcol is
// the carry's column, -1 on a masked row; the *_row values hold elsewhere.
struct Row {
  float lse, q_lse, log_att_btt, log_at_bt, log_qt_row, qt1_row, log_att_m1, log_btt_m1;
  int xcol;

  // q = log_x0 - q_pred(onehot x_t, t), masked rows against log ctt
  __device__ __forceinline__ float q(float logit, int c) const {
    return clamp_log(logit - lse) - (c == xcol ? log_att_btt : log_qt_row);
  }
  // ev = q_pred(q normalised, t - 1) + q_pred_one_timestep(onehot x_t, t) + q_lse
  __device__ __forceinline__ float ev(float qc, int c) const {
    const float qp = logaddexp((qc - q_lse) + log_att_m1, log_btt_m1);
    return clamp_log(qp + (c == xcol ? log_at_bt : qt1_row) + q_lse);
  }
};

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k >> 31) ? (k & 0x7fffffffu) : ~k);
}

// The exact k-th largest of the row's keys (key_at(c) for c in [0, km1), and key_last) by
// 8-bit digits, most significant first: per digit a histogram of the keys
// that match the digits chosen so far (shared-memory atomics; aggregating
// equal digits first with __match_any_sync made the select 5x slower),
// then a warp scan from the top digit down to the one that holds the k-th
// key. hist comes in with the top digit counted. The same key as 32
// one-bit passes, ties included.
template <class KeyAt>
__device__ uint32_t kth_largest_key(KeyAt key_at, int km1, uint32_t key_last, int k, int* hist,
                                    int lane) {
  uint32_t prefix = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (shift < 24) {   // the top digit's histogram comes with the keys
      const uint32_t above = 0xFFFFFFFFu << (shift + 8);
      for (int i = lane; i < kBins; i += 32) hist[i] = 0;
      __syncwarp();
      for (int c = lane; c < km1; c += 32) {
        const uint32_t key = key_at(c);
        if (((key ^ prefix) & above) == 0) atomicAdd(&hist[(key >> shift) & 255u], 1);
      }
      if (lane == 0 && ((key_last ^ prefix) & above) == 0)
        atomicAdd(&hist[(key_last >> shift) & 255u], 1);
    }
    __syncwarp();
    // lane l holds digits 255 - 8l down to 248 - 8l
    int h[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = hist[255 - 8 * lane - j];
      sum += h[j];
    }
    int upto = sum;   // keys of the candidates with digit >= 248 - 8 * lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, upto, o);
      if (lane >= o) upto += t;
    }
    const bool here = upto - sum < k && k <= upto;
    int digit = 0, rest = 0, acc = upto - sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (here && acc < k && k <= acc + h[j]) {
        digit = 255 - 8 * lane - j;
        rest = k - acc;
      }
      acc += h[j];
    }
    const int src = __ffs(__ballot_sync(0xffffffffu, here)) - 1;
    prefix |= (uint32_t)__shfl_sync(0xffffffffu, digit, src) << shift;
    k = __shfl_sync(0xffffffffu, rest, src);
    __syncwarp();
  }
  return prefix;
}

struct Best {
  float score = -INFINITY;
  int c = 0x7fffffff;
  __device__ __forceinline__ void take(float s, int col) {
    if (s > score) {
      score = s;
      c = col;
    }
  }
  // the first maximum over the warp
  __device__ __forceinline__ int reduce() {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, score, o);
      const int oc = __shfl_xor_sync(0xffffffffu, c, o);
      if (ob > score || (ob == score && oc < c)) {
        score = ob;
        c = oc;
      }
    }
    return c;
  }
};

// The first maximum of score(c, gumbel_c) over the row's K classes. B6
// reads gumbel_c from the staged row, lane l taking columns l, l + 32, ...;
// B7 draws it: lane l computes Philox blocks l, l + 32, ... once each and
// takes the four columns 4g..4g+3 of block g.
template <bool kPrng, class Score, class Last>
__device__ __forceinline__ int sample(Score score, Last last, int km1, const float* grow,
                                      uint32_t n, uint32_t k0, uint32_t k1, int lane) {
  Best best;
  const int K = km1 + 1;
  // score runs at every column, clamped below km1, and the mask column's
  // value is selected after: no branch around the arithmetic, so the
  // columns of one lane overlap
  if constexpr (kPrng) {
    for (int g = lane; 4 * g < K; g += 32) {
      const uint4 w = philox4x32_10((uint32_t)g, n, k0, k1);
      const uint32_t bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * g + j;
        const float gm = gumbel_from_bits(bits[j]);
        const float e = score(c < km1 ? c : km1 - 1, gm);
        const float s = c < km1 ? e : last(gm);
        if (c < K) best.take(s, c);
      }
    }
  } else {
    for (int c = lane; c < K; c += 32) {
      const float gm = grow[c];
      const float e = score(c < km1 ? c : km1 - 1, gm);
      best.take(c < km1 ? e : last(gm), c);
    }
  }
  return best.reduce();
}

template <class T, bool kPrng, bool kStaged>
__global__ void __launch_bounds__(kRows * 32, 32 / kRows)
posterior_kernel(const T* __restrict__ logits, const long long* __restrict__ x_t,
                 const float* __restrict__ coefs, const float* __restrict__ gumbel,
                 const int* __restrict__ seeds, long long* __restrict__ out, int B, int N, int K,
                 int trunc_k) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr bool kQInPlace = kStaged && kF32;   // q, then the keys, over the staged logits
  extern __shared__ __align__(16) char smem[];
  const int km1 = K - 1;
  const long long rows = (long long)B * N, row0 = (long long)blockIdx.x * kRows;
  const int nrows = (int)(rows - row0 < kRows ? rows - row0 : kRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // staged rows: every global read of the block first, the logits span,
  // then (B6) the Gumbel span as a second group
  const T* lspan = logits + row0 * km1;
  const float* gspan = kPrng ? nullptr : gumbel + row0 * K;
  const int lbytes = kStaged ? align16(kRows * km1 * (int)sizeof(T) + 16) : 0;
  const int gbytes = kStaged && !kPrng ? align16(kRows * K * 4 + 16) : 0;
  if constexpr (kStaged) {
    stage_span(smem, lspan, (long long)nrows * km1);
    cp_async_commit();
    if (!kPrng) stage_span(smem + lbytes, gspan, (long long)nrows * K);
    cp_async_commit();
  }

  const bool live = warp < nrows;
  const long long row = row0 + warp;
  const int b = live ? (int)(row / N) : 0, n = live ? (int)(row % N) : 0;
  const float lz = log_zero();
  const long long xt = live ? x_t[row] : 0;
  const bool is_mask = xt == km1;
  const float* cf = coefs + (size_t)b * 10;
  const float log_att = cf[0], log_btt = cf[1], log_ctt = cf[2];
  const float log_at = cf[3], log_bt = cf[4], log_ct = cf[5];
  const float log_ctt_m1 = cf[8], log_1mctt_m1 = cf[9];
  Row r;
  r.xcol = is_mask ? -1 : (int)xt;
  r.log_qt_row = is_mask ? log_ctt : log_btt;
  r.qt1_row = is_mask ? log_ct : log_bt;
  r.log_att_m1 = cf[6];
  r.log_btt_m1 = cf[7];
  r.log_att_btt = logaddexp(log_att, log_btt);
  r.log_at_bt = logaddexp(log_at, log_bt);
  const uint32_t k0 = kPrng && live ? (uint32_t)seeds[2 * b] : 0u;
  const uint32_t k1 = kPrng && live ? (uint32_t)seeds[2 * b + 1] : 0u;

  if constexpr (kStaged) {
    cp_async_wait1();
    __syncthreads();
  }
  T* srow = (T*)(smem + ((uintptr_t)lspan & 15)) + (size_t)warp * km1;
  const T* lrow = kStaged ? srow : lspan + (size_t)warp * km1;
  // f32 staged rows keep q, then the keys of ev, over their logits; other
  // rows compute q again from the logit, and staged bf16 rows keep the keys
  // in a region of their own
  float* qrow = (float*)srow;
  uint32_t* keys = kQInPlace ? (uint32_t*)srow
                             : (uint32_t*)(smem + lbytes + gbytes) + (size_t)warp * km1;
  int* hist = (int*)(smem + lbytes + gbytes + (kStaged && !kF32 ? kRows * km1 * 4 : 0)) +
              warp * kBins;
  auto q_at = [&](int c) -> float {
    if constexpr (kQInPlace) return qrow[c];
    else return r.q(to_f32(lrow[c]), c);
  };
  float ev_last = 0.0f;
  if (live) {
    // predict_start: log_softmax of the K-1 logits, clamped
    float m = -INFINITY;
    for (int c = lane; c < km1; c += 32) m = fmaxf(m, to_f32(lrow[c]));
    m = warp_max(m);
    float s = 0.0f;
    for (int c = lane; c < km1; c += 32) s += expf(to_f32(lrow[c]) - m);
    r.lse = m + logf(warp_sum(s));
    // logsumexp over [q | log 1e-30]
    float m2 = -INFINITY;
    for (int c = lane; c < km1; c += 32) {
      const float qc = r.q(to_f32(lrow[c]), c);
      if constexpr (kQInPlace) qrow[c] = qc;
      m2 = fmaxf(m2, qc);
    }
    m2 = fmaxf(warp_max(m2), lz);
    s = 0.0f;
    for (int c = lane; c < km1; c += 32) s += expf(q_at(c) - m2);
    r.q_lse = m2 + logf(warp_sum(s) + expf(lz - m2));
    const float qp = logaddexp((lz - r.q_lse) + log_1mctt_m1, log_ctt_m1);
    ev_last = clamp_log(qp + (is_mask ? 0.0f : lz) + r.q_lse);
  }
  if constexpr (kStaged) {
    cp_async_wait0();
    __syncthreads();
  }
  if (!live) return;

  const float* grow =
      kPrng ? nullptr
            : (kStaged ? (const float*)(smem + lbytes + ((uintptr_t)gspan & 15)) : gspan) +
                  (size_t)warp * K;
  int pick;
  if (trunc_k == 0) {
    // the sample: first maximum of ev + gumbel
    pick = sample<kPrng>([&](int c, float g) { return r.ev(q_at(c), c) + g; },
                         [&](float g) { return ev_last + g; }, km1, grow, (uint32_t)n, k0, k1,
                         lane);
  } else {
    // top-r: the keys of ev (counting their top digits), the trunc_k-th
    // largest, then the sample among the classes at or above it
    auto key_at = [&](int c) -> uint32_t {
      if constexpr (kStaged) return keys[c];
      else return monotone_key(r.ev(q_at(c), c));
    };
    for (int i = lane; i < kBins; i += 32) hist[i] = 0;
    __syncwarp();
    const uint32_t key_last = monotone_key(ev_last);
    if (lane == 0) atomicAdd(&hist[key_last >> 24], 1);
    for (int c = lane; c < km1; c += 32) {
      const uint32_t key = monotone_key(r.ev(q_at(c), c));
      if constexpr (kStaged) keys[c] = key;
      atomicAdd(&hist[key >> 24], 1);
    }
    __syncwarp();
    const uint32_t kth = kth_largest_key(key_at, km1, key_last, trunc_k, hist, lane);
    pick = sample<kPrng>(
        [&](int c, float g) {
          const uint32_t key = key_at(c);
          return key < kth ? kMasked : key_float(key) + g;
        },
        [&](float g) { return key_last < kth ? kMasked : ev_last + g; }, km1, grow, (uint32_t)n,
        k0, k1, lane);
  }
  if (lane == 0) out[row] = pick;
}

template <class T, bool kPrng, bool kStaged>
int launch_rows(const void* logits, const void* x_t, const void* coefs, const void* noise,
                void* out, int B, int N, int K, int trunc_k, void* stream) {
  const long long rows = (long long)B * N;
  const int smem = posterior_smem(K, (int)sizeof(T), kPrng, trunc_k > 0, kStaged);
  if (smem > kSmemDefault) {   // the opt-in is the current device's: set it at every launch
    const cudaError_t err = cudaFuncSetAttribute(
        posterior_kernel<T, kPrng, kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((rows + kRows - 1) / kRows);
  posterior_kernel<T, kPrng, kStaged><<<blocks, kRows * 32, smem, (cudaStream_t)stream>>>(
      (const T*)logits, (const long long*)x_t, (const float*)coefs,
      kPrng ? nullptr : (const float*)noise, kPrng ? (const int*)noise : nullptr,
      (long long*)out, B, N, K, trunc_k);
  return (int)cudaGetLastError();
}

// rows of up to kMaxStaged classes are staged in shared memory, wider rows
// read from device memory
template <class T, bool kPrng>
int launch(const void* logits, const void* x_t, const void* coefs, const void* noise, void* out,
           int B, int N, int K, int trunc_k, void* stream) {
  if (K < 2 || K > kMaxClasses || trunc_k < 0 || trunc_k > K || B < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return 0;
  return K <= kMaxStaged
             ? launch_rows<T, kPrng, true>(logits, x_t, coefs, noise, out, B, N, K, trunc_k,
                                           stream)
             : launch_rows<T, kPrng, false>(logits, x_t, coefs, noise, out, B, N, K, trunc_k,
                                            stream);
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
