// Fused Algorithm 1 (the paper's RNS comparison) for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/rns_compare.py::compare_kernel_call.
//
// In:  x1, x2 (n, B) int32 residues, channel-major; xa1, xa2 (B,) int32
//      redundant residues mod m_a; inv (n, n) with inv[j, i] =
//      m_j^{-1} mod m_i; m (n,) moduli; betas (n,) = prod_{j<i} m_j mod m_a.
// Out: out (B,) int32 verdicts, 1 where N1 >= N2.
//
// Per column, in one pass:
//     z      = (x1 - x2) mod m_i          channel-wise subtract  (line 2)
//     digits = MRC(z)                     Alg. 2, in place        (line 3)
//     Delta  = to_ma(digits)              Alg. 3 dot              (line 4)
//     Delta' = (xa1 - xa2) mod m_a                                (line 1)
//     out    = (Delta == Delta')                                  (Thm. 1)
//
// What bounds it: a column reads 8(n + 1) bytes and writes 4, and costs
// n(n-1)/2 + n + 1 Barrett steps.  At n = 137 that is ~9.5k steps on 1.1 KB,
// so the int32/fp32 pipes bound it; at n = 8 device-memory bytes do.
//
// Design: as mrc.cu — one thread per column, the column in shared memory
// as z[n][128], inverse and beta tables read through the read-only path as
// warp-wide broadcasts.  Fusing keeps the digits out of device memory: the
// unfused route writes and reads the (n, B) digit tensor once more.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rns::kColBlock)
compare_kernel(const int* __restrict__ x1, const int* __restrict__ xa1,
               const int* __restrict__ x2, const int* __restrict__ xa2,
               int* __restrict__ out, const int* __restrict__ inv,
               const int* __restrict__ m, const int* __restrict__ betas,
               int ma, int n, int64_t B) {
  extern __shared__ int smem[];
  int* s_m = smem;
  float* s_r = reinterpret_cast<float*>(smem + n);
  int* w = smem + 2 * n + threadIdx.x;

  rns::stage_moduli(m, n, s_m, s_r);
  const int64_t col = (int64_t)blockIdx.x * rns::kColBlock + threadIdx.x;
  if (col >= B) return;

  for (int i = 0; i < n; ++i) {
    int z = x1[i * B + col] - x2[i * B + col];
    z += (z < 0) ? s_m[i] : 0;
    w[i * rns::kColBlock] = z;
  }
  rns::mrc_column(w, inv, s_m, s_r, n);
  const int delta = rns::to_ma_column(w, betas, n, ma, rns::recip_rn(ma));
  int dp = xa1[col] - xa2[col];
  dp += (dp < 0) ? ma : 0;
  out[col] = (delta == dp) ? 1 : 0;
}

}  // namespace

extern "C" int rns_compare(const int* x1, const int* xa1, const int* x2,
                           const int* xa2, int* out, const int* inv,
                           const int* m, const int* betas, int ma, int n,
                           int64_t B, void* stream) {
  const size_t smem = rns::column_smem_bytes(n);
  if (n < 1 || B < 1 || smem > (size_t)rns::kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      compare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (B + rns::kColBlock - 1) / rns::kColBlock;
  compare_kernel<<<(unsigned)blocks, rns::kColBlock, smem,
                   (cudaStream_t)stream>>>(x1, xa1, x2, xa2, out, inv, m,
                                           betas, ma, n, B);
  return (int)cudaGetLastError();
}
