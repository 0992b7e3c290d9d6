// Shared device primitives for the RNS kernels (mrc.cu, modmul.cu,
// rns_compare.cu, codec_encode.cu, codec_decode.cu); the counterpart of
// src/repro/kernels/common.py.
//
// Layout: every kernel works on channel-major (n, B) int32 buffers, one
// column (one RNS number) per thread, the batch across threads, so that a
// warp's loads of one channel row are contiguous and coalesce.
//
// Reduction: barrett_mod is the reference's f32 Barrett step — quotient
// floor(float(t) * (1/m)) with one +m and one -m correction.  For t < m *
// 2**15 and m < 2**15 the f32 quotient is off by at most one, so the result
// is exact and equals t % m bit for bit.  This holds only with IEEE
// rounding: 1/m is __frcp_rn (correctly rounded), the product is __fmul_rn
// (never contracted into an FMA), and the file must never be built with
// --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rns {

// Columns per block of the per-column kernels (mrc, compare).  Their
// working column lives in shared memory as w[n][kColBlock]: thread t owns
// word t of every row, so neighbouring threads hit neighbouring banks.
constexpr int kColBlock = 128;

// Shared memory a block may take on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float recip_rn(int m) {
  return __frcp_rn(__int2float_rn(m));
}

// Exact t mod m for 0 <= t < m * 2**15, 1 < m < 2**15.
__device__ __forceinline__ int barrett_mod(int t, int m, float recip) {
  int q = __float2int_rd(__fmul_rn(__int2float_rn(t), recip));
  int r = t - q * m;
  r += (r < 0) ? m : 0;
  r -= (r >= m) ? m : 0;
  return r;
}

// Exact t mod m for any 0 <= t < 2**32 and 2 <= m, with mu = floor(2**32 / m):
// the high word of t * mu is floor(t / m) or one less, so one correction
// makes the remainder exact.  Used where t exceeds barrett_mod's range.
__device__ __forceinline__ int mod_mulhi(unsigned t, int m, unsigned mu) {
  int r = (int)(t - __umulhi(t, mu) * (unsigned)m);
  r -= (r >= m) ? m : 0;
  return r;
}

// Shared memory of a per-column kernel for n channels: the moduli, their
// reciprocals and the (n, kColBlock) working tile.
__host__ __device__ inline size_t column_smem_bytes(int n) {
  return (size_t)n * (2 * sizeof(int) + kColBlock * sizeof(int));
}

// Stage m[0..n) and 1/m into shared memory; the whole block takes part.
__device__ __forceinline__ void stage_moduli(const int* __restrict__ m, int n,
                                             int* s_m, float* s_r) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    int mk = m[k];
    s_m[k] = mk;
    s_r[k] = recip_rn(mk);
  }
  __syncthreads();
}

// Algorithm 2 on this thread's column w[i * kColBlock] (i < n), in place:
// residues in, mixed-radix digits out.  inv[j * n + i] = m_j^{-1} mod m_i.
// The inverse reads are the same address across the warp (one broadcast
// load each), and the i-loop of one step has no carried dependence, so it
// unrolls into independent chains.
__device__ __forceinline__ void mrc_column(int* w, const int* __restrict__ inv,
                                           const int* s_m, const float* s_r,
                                           int n) {
  for (int j = 0; j < n - 1; ++j) {
    const int a = w[j * kColBlock];
    const int* inv_j = inv + (size_t)j * n;
#pragma unroll 4
    for (int i = j + 1; i < n; ++i) {
      const int mi = s_m[i];
      int d = w[i * kColBlock] - a;
      d += (d < 0) ? mi : 0;
      w[i * kColBlock] = barrett_mod(d * __ldg(inv_j + i), mi, s_r[i]);
    }
  }
}

// Algorithm 3 on a digit column: sum_i (a_i * beta_i mod m_a) mod m_a.
// Each term is < m_a, so the sum stays < n * m_a < 2**31 for n <= 2**16.
__device__ __forceinline__ int to_ma_column(const int* w,
                                            const int* __restrict__ betas,
                                            int n, int ma, float rma) {
  int s = 0;
  for (int i = 0; i < n; ++i) {
    s += barrett_mod(w[i * kColBlock] * __ldg(betas + i), ma, rma);
  }
  return barrett_mod(s, ma, rma);
}

}  // namespace rns
