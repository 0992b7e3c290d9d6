// Gradient-codec encode for Hopper (sm_90a): f32 gradients to signed-
// embedded RNS residues, the first kernel of the exact all-reduce.
//
// Replaces the TPU kernel
// src/repro/kernels/codec_encode.py::codec_encode_kernel_call.
//
// In:  g (B,) f32; per channel c < nch (n base channels, then m_a, then m_b
//      on a locate-and-correct codec) the host tables m[c], pow15[c] =
//      2**15 mod m[c] and off[c] (0 on base rows, M mod m[c] on redundant
//      rows); scale = 2**frac_bits; qmax = qh * 2**15 + ql.
// Out: out (nch, B) int32, channel-major.
//
// Per element:
//     r    = rint(g * scale)                 round half to even; exact (a
//                                            power-of-two scale, and f32 of
//                                            magnitude >= 2**24 is integral)
//     NaN  -> 0                              as the reference's NaN-to-int
//                                            conversion gives
//     a    = min(|r|, 2**44) = hi*2**15 + lo exact f32 split, hi < 2**30
//     clip (hi, lo) at (qh, ql)              int32 compare, exact
//     per channel:
//       |q| mod m = ((hi mod m) * pow15 + lo) mod m
//       negative q embeds as (m - |q| mod m) mod m, then + off mod m
//
// hi reaches qh ~ 2**29, beyond barrett_mod's proven range t < m * 2**15
// for a small modulus (m = 31 on the 8 x 6-bit base), so hi mod m is the
// multiply-high step mod_mulhi, exact for every 32-bit t; the second
// reduction's input is below (m-1)**2 + 2**15 < m * 2**15 and takes
// barrett_mod.  Any exact reduction gives the reference's bits.
//
// What bounds it: 4 bytes in and 4 * nch out per element (20 B at nch = 4),
// against about 17 int32 instructions per channel, so at nch = 4 the bytes
// bound it with the int32 pipe close behind.
//
// Design: one thread per element.  The per-channel constants are a kernel
// parameter (the constant bank), and the channel loop is unrolled on the
// template channel count, so no load instruction fetches a table.  Each
// row's store is contiguous across the warp.  Row offsets are int64: the
// buffer may exceed 2**31 elements.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCh = 14;  // M < 2**45 admits at most 12 base moduli

struct EncodeTables {
  int m[kMaxCh];
  float rcp[kMaxCh];
  unsigned mu[kMaxCh];
  int pow15[kMaxCh];
  int off[kMaxCh];
};

template <int NCH>
__global__ void __launch_bounds__(kThreads)
codec_encode_kernel(const float* __restrict__ g, int* __restrict__ out,
                    const EncodeTables t, float scale, int qh, int ql,
                    int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;

  float r = rintf(__fmul_rn(g[i], scale));
  if (isnan(r)) r = 0.0f;
  const bool neg = r < 0.0f;                    // -0.0 is not negative
  const float a = fminf(fabsf(r), 17592186044416.0f);             // 2**44
  const float hi_f = floorf(__fmul_rn(a, 3.0517578125e-05f));     // 2**-15
  const float lo_f = __fsub_rn(a, __fmul_rn(hi_f, 32768.0f));
  int hi = __float2int_rz(hi_f);
  int lo = __float2int_rz(lo_f);
  const bool over = hi > qh || (hi == qh && lo > ql);
  hi = over ? qh : hi;
  lo = over ? ql : lo;

#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int m = t.m[c];
    const int r_hi = rns::mod_mulhi((unsigned)hi, m, t.mu[c]);
    const int r_abs = rns::barrett_mod(r_hi * t.pow15[c] + lo, m, t.rcp[c]);
    int res = r_abs;
    if (neg) {
      res = (r_abs > 0 ? m - r_abs : 0) + t.off[c];
      res -= (res >= m) ? m : 0;
    }
    out[(int64_t)c * B + i] = res;
  }
}

template <int NCH>
cudaError_t launch(const float* g, int* out, const EncodeTables& t,
                   float scale, int qh, int ql, int64_t B,
                   cudaStream_t stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  codec_encode_kernel<NCH><<<(unsigned)blocks, kThreads, 0, stream>>>(
      g, out, t, scale, qh, ql, B);
  return cudaGetLastError();
}

}  // namespace

// m, pow15 and off are HOST arrays of nch ints; 1/m (correctly rounded, as
// __frcp_rn gives it) and floor(2**32 / m) are derived here.
extern "C" int rns_codec_encode(const float* g, int* out, const int* m,
                                const int* pow15, const int* off, int nch,
                                float scale, int qh, int ql, int64_t B,
                                void* stream) {
  if (nch < 2 || nch > kMaxCh || B < 1 || B > (int64_t)INT32_MAX * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeTables t = {};
  for (int c = 0; c < nch; ++c) {
    if (m[c] < 2 || m[c] >= (1 << 15)) return (int)cudaErrorInvalidValue;
    t.m[c] = m[c];
    t.rcp[c] = 1.0f / (float)m[c];
    t.mu[c] = (unsigned)((1ull << 32) / (unsigned long long)m[c]);
    t.pow15[c] = pow15[c];
    t.off[c] = off[c];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (nch) {
#define RNS_ENCODE_CASE(K) \
  case K:                  \
    return (int)launch<K>(g, out, t, scale, qh, ql, B, s);
    RNS_ENCODE_CASE(2) RNS_ENCODE_CASE(3) RNS_ENCODE_CASE(4)
    RNS_ENCODE_CASE(5) RNS_ENCODE_CASE(6) RNS_ENCODE_CASE(7)
    RNS_ENCODE_CASE(8) RNS_ENCODE_CASE(9) RNS_ENCODE_CASE(10)
    RNS_ENCODE_CASE(11) RNS_ENCODE_CASE(12) RNS_ENCODE_CASE(13)
    RNS_ENCODE_CASE(14)
#undef RNS_ENCODE_CASE
  }
  return (int)cudaErrorInvalidValue;
}
