// Gradient-codec decode for Hopper (sm_90a): summed RNS channels back to
// f32 gradients, the last kernel of the exact all-reduce.
//
// Replaces the TPU kernel
// src/repro/kernels/codec_decode.py::codec_decode_kernel_call.
//
// In:  x (nch, B) int32 per-channel sums, channel-major; only the n base
//      rows are read (the redundant rows ride along unread).  Host tables:
//      m (n,) moduli, inv (n, n) with inv[j * n + i] = m_j^{-1} mod m_i,
//      half (6,) = the 15-bit limbs of T = ceil(M/2), then of M.
// Out: out (B,) f32 = signed value * inv_scale (= 2**-frac_bits).
//
// Per element:
//     fold    x_i mod m_i                     barrett_mod
//     MRC     residues -> digits              Alg. 2, in registers
//     Horner  digits -> v in [0, M)           3 x 15-bit int32 limbs
//     sign    v >= T ? v - M : v              limb compare, limb borrows
//     cast    the f32 nearest v               Fast2Sum of the limb terms
//     scale   * 2**-frac_bits                 exact
//
// Limb bounds (M < 2**45, m < 2**15): each Horner step t = l * m + carry
// stays below 2**30 (see the reference's module docstring).  The Fast2Sum
// depends on the order of its adds, so every add and product below is an
// explicit round-to-nearest intrinsic that the compiler may neither contract
// nor reorder; the file is never built with --use_fast_math.
//
// What bounds it: 4 * n bytes in and 4 out per element (16 B at n = 3),
// against roughly 25 int32 instructions per channel, so at n = 3 bytes and
// the int32 pipe are close.
//
// Design: one thread per element with the whole column in registers (a
// template on n <= 12 unrolls every loop, so the column is a register
// array); the tables are a kernel parameter in the constant bank.  Each
// row's load is contiguous across the warp; row offsets are int64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 12;  // M < 2**45 admits at most 12 moduli
constexpr int kMask = 0x7FFF;

struct DecodeTables {
  int m[kMaxN];
  float rcp[kMaxN];
  int inv[kMaxN * kMaxN];  // inv[j * kMaxN + i] = m_j^{-1} mod m_i
  int half[6];             // limbs of T = ceil(M/2), then of M
};

template <int N>
__global__ void __launch_bounds__(kThreads)
codec_decode_kernel(const int* __restrict__ x, float* __restrict__ out,
                    const DecodeTables t, float inv_scale, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;

  int w[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    w[c] = rns::barrett_mod(x[(int64_t)c * B + i], t.m[c], t.rcp[c]);
  }
#pragma unroll
  for (int j = 0; j < N - 1; ++j) {
#pragma unroll
    for (int k = j + 1; k < N; ++k) {
      int d = w[k] - w[j];
      d += (d < 0) ? t.m[k] : 0;
      w[k] = rns::barrett_mod(d * t.inv[j * kMaxN + k], t.m[k], t.rcp[k]);
    }
  }

  // Horner over the mixed radix, most significant digit first.
  int l0 = w[N - 1], l1 = 0, l2 = 0;
#pragma unroll
  for (int k = N - 2; k >= 0; --k) {
    const int t0 = l0 * t.m[k] + w[k];
    const int t1 = l1 * t.m[k] + (t0 >> 15);
    const int t2 = l2 * t.m[k] + (t1 >> 15);
    l0 = t0 & kMask;
    l1 = t1 & kMask;
    l2 = t2 & kMask;
  }

  // Signed fold: v >= T ? v - M : v, with borrows between the limbs.
  const bool ge = l2 > t.half[2] ||
                  (l2 == t.half[2] &&
                   (l1 > t.half[1] || (l1 == t.half[1] && l0 >= t.half[0])));
  const int b0 = l0 - t.half[3];
  const int bor0 = b0 < 0;
  const int b1 = l1 - t.half[4] - bor0;
  const int bor1 = b1 < 0;
  const int b2 = l2 - t.half[5] - bor1;
  const int s0 = ge ? b0 + (bor0 << 15) : l0;
  const int s1 = ge ? b1 + (bor1 << 15) : l1;
  const int s2 = ge ? b2 : l2;

  // The f32 nearest s2*2**30 + s1*2**15 + s0: each term is exact in f32;
  // Fast2Sum(a2, a1) is exact because |a2| >= 2**30 > |a1| when s2 != 0,
  // and e1 + a0 is an integer below 2**24, so the last add rounds the exact
  // value once.
  const float a2 = __fmul_rn(__int2float_rn(s2), 1073741824.0f);  // 2**30
  const float a1 = __fmul_rn(__int2float_rn(s1), 32768.0f);       // 2**15
  const float a0 = __int2float_rn(s0);
  const float t1 = __fadd_rn(a2, a1);
  const float e1 = __fsub_rn(a1, __fsub_rn(t1, a2));
  const float val = __fadd_rn(t1, __fadd_rn(e1, a0));
  out[i] = __fmul_rn(val, inv_scale);
}

template <int N>
cudaError_t launch(const int* x, float* out, const DecodeTables& t,
                   float inv_scale, int64_t B, cudaStream_t stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  codec_decode_kernel<N><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, out, t, inv_scale, B);
  return cudaGetLastError();
}

}  // namespace

// m (n,), inv (n * n,) and half (6,) are HOST int arrays; 1/m (correctly
// rounded, as __frcp_rn gives it) is derived here.  B is the row stride of
// x as well as the element count.
extern "C" int rns_codec_decode(const int* x, float* out, const int* m,
                                const int* inv, const int* half, int n,
                                float inv_scale, int64_t B, void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || B > (int64_t)INT32_MAX * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeTables t = {};
  for (int i = 0; i < n; ++i) {
    if (m[i] < 2 || m[i] >= (1 << 15)) return (int)cudaErrorInvalidValue;
    t.m[i] = m[i];
    t.rcp[i] = 1.0f / (float)m[i];
    for (int j = 0; j < n; ++j) t.inv[j * kMaxN + i] = inv[j * n + i];
  }
  for (int k = 0; k < 6; ++k) t.half[k] = half[k];
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define RNS_DECODE_CASE(K) \
  case K:                  \
    return (int)launch<K>(x, out, t, inv_scale, B, s);
    RNS_DECODE_CASE(1) RNS_DECODE_CASE(2) RNS_DECODE_CASE(3)
    RNS_DECODE_CASE(4) RNS_DECODE_CASE(5) RNS_DECODE_CASE(6)
    RNS_DECODE_CASE(7) RNS_DECODE_CASE(8) RNS_DECODE_CASE(9)
    RNS_DECODE_CASE(10) RNS_DECODE_CASE(11) RNS_DECODE_CASE(12)
#undef RNS_DECODE_CASE
  }
  return (int)cudaErrorInvalidValue;
}
