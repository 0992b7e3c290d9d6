// Fused Algorithm 1 (the paper's RNS comparison) for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/rns_compare.py::compare_kernel_call.
//
// In:  x1, x2, n residues a column, read where they lie: channel c of
//      column b at x[c * chs + b * cs], the strides of an (n, B) view (a
//      stride may be 0: a broadcast operand); xa1, xa2 the redundant
//      residues mod m_a at xa[b * s].  The divmod's packed (..., n+1) rows
//      give x at chs = 1, cs = n + 1 and xa at the same rows' last word:
//      no copy.  image, the base's tables (columns.cuh, ColLayout).
// Out: out (B,) verdicts, one byte each (a torch.bool tensor, so no cast
//      follows the launch), 1 where N1 >= N2.
//
// Per column, in one pass:
//     z      = (x1 - x2) mod m_i          channel-wise subtract  (line 2)
//     digits = MRC(z)                     Alg. 2                  (line 3)
//     Delta  = to_ma(digits)              Alg. 3 dot              (line 4)
//     Delta' = (xa1 - xa2) mod m_a                                (line 1)
//     out    = (Delta == Delta')                                  (Thm. 1)
//
// What bounds it: a column's n(n-1)/2 triangle steps against 8(n + 1) bytes
// read and 4 written; at n = 137 the int32 pipe, at n = 8 device memory
// (chip_smoke.py, column_work).  On one column, which is how a divmod calls
// it 2 * 2062 + 1 times at RSA-2048 width, nothing bounds it but the
// triangle's n - 1 dependent steps.
//
// Design: as mrc.cu — the triangle in registers (mrc_warp.cuh), a warp a
// column for n > 16 and a thread a column for n <= 16, the tables staged
// once a block into shared memory.  In the warp mapping the dot is one term
// a slot on each lane, a_i * beta_i mod m_a, summed over the lane's slots
// and then across the warp by __shfl_xor_sync; lane 0 reduces the sum once
// and writes the verdict.  In the thread mapping the thread sums its n
// terms.  Fusing keeps the digits in registers: the unfused route writes
// and reads them in device memory.
#include "columns.cuh"

namespace {

// n <= 16: a thread a column, N = n.  Each term a_i beta_i < m_i m_a <
// m_a 2**15 reduces exactly (barrett_mod) and their sum stays below
// 16 m_a < m_a 2**15, so the last reduction is exact too.
template <int N>
__global__ void __launch_bounds__(32 * rns::kColMaxWarps)
compare_thread_kernel(const int* __restrict__ x1, int64_t chs1, int64_t cs1,
                      const int* __restrict__ xa1, int64_t sa1,
                      const int* __restrict__ x2, int64_t chs2, int64_t cs2,
                      const int* __restrict__ xa2, int64_t sa2,
                      unsigned char* __restrict__ out,
                      const unsigned char* __restrict__ image,
                      const rns::ColLayout L, int ma, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::stage_image(smem, image, L.image);
  const int* mod = reinterpret_cast<const int*>(image);
  const int* bet = reinterpret_cast<const int*>(image + L.betas);
  int m[N], beta[N];
  float rc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    m[c] = __ldg(mod + c);
    rc[c] = rns::recip_rn(m[c]);
    beta[c] = __ldg(bet + c);
  }
  const float rma = rns::recip_rn(ma);
  rns::stage_wait();
  const unsigned short* tri =
      reinterpret_cast<const unsigned short*>(smem + L.tri);

  for (int64_t col = rns::first_column<1>(); col < B;
       col += rns::column_step<1>()) {
    int w[N];
#pragma unroll
    for (int c = 0; c < N; ++c) {  // (x1 - x2) mod m_i, canonical
      const int z = x1[col * cs1 + c * chs1] - x2[col * cs2 + c * chs2];
      w[c] = z + (m[c] & (z >> 31));
    }
    int dp = xa1[col * sa1] - xa2[col * sa2];
    dp += (dp < 0) ? ma : 0;
    rns::mrc_thread<N>(w, m, rc, tri);
    int s = 0;
#pragma unroll
    for (int c = 0; c < N; ++c) s += rns::barrett_mod(w[c] * beta[c], ma, rma);
    out[col] = rns::barrett_mod(s, ma, rma) == dp;
  }
}

// n > 16: a warp a column, S register slots a lane.  Each term a_i beta_i
// reduces exactly as above; a lane's sum is below S m_a and the warp's
// below 32 S m_a <= 448 m_a < m_a 2**15 (< 2**24), so no partial sum can
// overflow and the last reduction is exact too.
template <int S>
__global__ void __launch_bounds__(32 * rns::kColMaxWarps)
compare_warp_kernel(const int* __restrict__ x1, int64_t chs1, int64_t cs1,
                    const int* __restrict__ xa1, int64_t sa1,
                    const int* __restrict__ x2, int64_t chs2, int64_t cs2,
                    const int* __restrict__ xa2, int64_t sa2,
                    unsigned char* __restrict__ out,
                    const unsigned char* __restrict__ image,
                    const rns::ColLayout L, int ma, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::stage_image(smem, image, L.image);
  const int l = threadIdx.x & 31;
  int m[S], beta[S];
  float rc[S];
  rns::load_moduli<S>(m, rc, reinterpret_cast<const int*>(image), L.n, l);
  // beta = 0 on the spare lanes: their terms vanish
  rns::load_rev<S>(beta, reinterpret_cast<const int*>(image + L.betas), L.n,
                   0, 1, 0, l);
  const float rma = rns::recip_rn(ma);
  rns::stage_wait();
  const unsigned short* tri =
      reinterpret_cast<const unsigned short*>(smem + L.tri);

  for (int64_t col = rns::first_column<32>(); col < B;
       col += rns::column_step<32>()) {
    int w[S], y[S];
    rns::load_rev<S>(w, x1, L.n, cs1, chs1, col, l);
    rns::load_rev<S>(y, x2, L.n, cs2, chs2, col, l);
    int dp = 0;
    if (l == 0) dp = xa1[col * sa1] - xa2[col * sa2];
#pragma unroll
    for (int k = 0; k < S; ++k) {  // (x1 - x2) mod m_i, canonical
      const int z = w[k] - y[k];
      w[k] = z + (m[k] & (z >> 31));
    }
    rns::mrc_warp<S>(w, m, rc, tri, L.n, l);
    int s = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) s += rns::barrett_mod(w[k] * beta[k], ma, rma);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(rns::kFull, s, off);
    }
    if (l == 0) {
      dp += (dp < 0) ? ma : 0;
      out[col] = rns::barrett_mod(s, ma, rma) == dp;
    }
  }
}

#define RNS_THREAD(N) (const void*)compare_thread_kernel<N>
const void* const kKernels[rns::kColInstances] = {
    RNS_THREAD(1),  RNS_THREAD(2),  RNS_THREAD(3),  RNS_THREAD(4),
    RNS_THREAD(5),  RNS_THREAD(6),  RNS_THREAD(7),  RNS_THREAD(8),
    RNS_THREAD(9),  RNS_THREAD(10), RNS_THREAD(11), RNS_THREAD(12),
    RNS_THREAD(13), RNS_THREAD(14), RNS_THREAD(15), RNS_THREAD(16),
    (const void*)compare_warp_kernel<5>, (const void*)compare_warp_kernel<14>};
#undef RNS_THREAD
std::atomic<unsigned long long> allowed{0};

}  // namespace

extern "C" int rns_compare(const int* x1, int64_t chs1, int64_t cs1,
                           const int* xa1, int64_t sa1, const int* x2,
                           int64_t chs2, int64_t cs2, const int* xa2,
                           int64_t sa2, unsigned char* out, const void* image,
                           const int* layout, int ma,
                           int lanes, int warps, int64_t blocks, int64_t B,
                           void* stream) {
  const rns::ColLayout L{layout[0], layout[1], layout[2], layout[3]};
  int inst = -1;
  if (int err = rns::column_check(L, lanes, warps, blocks, B, &inst)) {
    return err;
  }
  if (ma < 2 || ma >= (1 << 15)) return (int)cudaErrorInvalidValue;
  void* args[] = {&x1, &chs1, &cs1, &xa1, &sa1, &x2, &chs2, &cs2, &xa2, &sa2,
                  &out, &image, const_cast<rns::ColLayout*>(&L), &ma, &B};
  return rns::column_launch(kKernels, allowed, inst, L, warps, blocks, args,
                            stream);
}
