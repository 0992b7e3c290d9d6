// Channel-wise modular multiply (the RNS ring product) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/modmul.py::modmul_kernel_call.
//
// In:  x, y (n, B) int32 reduced residues, channel-major; m (n,) int32
//      moduli (n counts redundant channels too: each row reduces in its
//      own modulus).
// Out: out (n, B) int32, (x * y) mod m_i.
//
// What bounds it: 12 bytes of device memory per element against one
// multiply and one Barrett step — memory-bound on any card.
//
// Design: a 2-D grid, one row (channel) per blockIdx.y, so the modulus and
// its reciprocal are computed once per thread from one broadcast load; the
// batch runs across threads and blocks of blockIdx.x, so every warp reads
// and writes 128 contiguous bytes of each array.  The ragged edge is
// masked, not padded.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
modmul_kernel(const int* __restrict__ x, const int* __restrict__ y,
              int* __restrict__ out, const int* __restrict__ m, int64_t B) {
  const int64_t col = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (col >= B) return;
  const int mi = __ldg(m + blockIdx.y);
  const int64_t k = (int64_t)blockIdx.y * B + col;
  out[k] = rns::barrett_mod(__ldg(x + k) * __ldg(y + k), mi, rns::recip_rn(mi));
}

}  // namespace

extern "C" int rns_modmul(const int* x, const int* y, int* out, const int* m,
                          int n, int64_t B, void* stream) {
  if (n < 1 || n > 65535 || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + kBlock - 1) / kBlock), (unsigned)n);
  modmul_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(x, y, out, m, B);
  return (int)cudaGetLastError();
}
