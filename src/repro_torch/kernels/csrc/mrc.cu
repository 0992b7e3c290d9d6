// Batched Mixed-Radix Conversion (paper Algorithm 2) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mrc.py::mrc_kernel_call.
//
// In:  x (n, B) int32 residues, channel-major; inv (n, n) int32 with
//      inv[j, i] = m_j^{-1} mod m_i; m (n,) int32 moduli.
// Out: out (n, B) int32 mixed-radix digits.
//
// What bounds it: each column costs n(n-1)/2 Barrett steps on 4n bytes
// read and 4n written, so the work per byte grows with n — at n = 8 it is
// bound by device-memory bytes, at n = 137 by the int32/fp32 pipes.
//
// Design: one thread per column, 128 columns per block.  The column lives
// in shared memory as w[n][128] (no runtime-indexed register array, which
// would spill to local memory at large n); thread t owns word t of each
// row, so there are no bank conflicts.  Loads and stores of x and out are
// row-wise: a warp touches 32 consecutive ints of one channel, coalesced.
// The inverse table (75 KB at n = 137, more than constant memory holds) is
// read from global memory through the read-only path; every thread of the
// warp reads the same word, one broadcast.  The ragged last block is masked
// after the moduli are staged.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rns::kColBlock)
mrc_kernel(const int* __restrict__ x, int* __restrict__ out,
           const int* __restrict__ inv, const int* __restrict__ m, int n,
           int64_t B) {
  extern __shared__ int smem[];
  int* s_m = smem;
  float* s_r = reinterpret_cast<float*>(smem + n);
  int* w = smem + 2 * n + threadIdx.x;

  rns::stage_moduli(m, n, s_m, s_r);
  const int64_t col = (int64_t)blockIdx.x * rns::kColBlock + threadIdx.x;
  if (col >= B) return;

  for (int i = 0; i < n; ++i) w[i * rns::kColBlock] = x[i * B + col];
  rns::mrc_column(w, inv, s_m, s_r, n);
  for (int i = 0; i < n; ++i) out[i * B + col] = w[i * rns::kColBlock];
}

}  // namespace

extern "C" int rns_mrc(const int* x, int* out, const int* inv, const int* m,
                       int n, int64_t B, void* stream) {
  const size_t smem = rns::column_smem_bytes(n);
  if (n < 1 || B < 1 || smem > (size_t)rns::kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      mrc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (B + rns::kColBlock - 1) / rns::kColBlock;
  mrc_kernel<<<(unsigned)blocks, rns::kColBlock, smem,
               (cudaStream_t)stream>>>(x, out, inv, m, n, B);
  return (int)cudaGetLastError();
}
