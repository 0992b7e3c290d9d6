// Shared device primitives for the RNS kernels; the counterpart of
// src/repro/kernels/common.py.  The MRC triangle of the column and
// Montgomery kernels is in mrc_warp.cuh.
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

}  // namespace rns
