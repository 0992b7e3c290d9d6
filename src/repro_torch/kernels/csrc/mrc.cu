// Batched Mixed-Radix Conversion (paper Algorithm 2) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mrc.py::mrc_kernel_call.
//
// In:  x, n residues a column, read where they lie: channel c of column b
//      at x[c * xchs + b * xcs], the strides of an (n, B) view
//      (channels-last rows, the layout of the port's arrays, have xchs = 1;
//      a channel-major tile xcs = 1);
//      image, the base's tables (columns.cuh, ColLayout).
// Out: out, the n mixed-radix digits a column, at the same kind of strides
//      (kernels/mrc.py writes channels-last rows).
//
// What bounds it: a column's n(n-1)/2 triangle steps, each at least four
// int32 instructions and one FFMA, against 8n bytes of device memory: at
// n = 137 the int32 pipe, at n = 8 device memory (chip_smoke.py,
// column_work).
//
// Design: the column's channels in registers (mrc_warp.cuh, a lazy
// FFMA-rounded reduction a step): a warp a column with the digit broadcast
// by __shfl_sync, n - 1 steps deep, for n > 16; a thread a column for
// n <= 16, where a warp's lanes would idle and a thread's registers hold
// the column.  The block stages the triangle of inverses (uint16) into
// shared memory with cp.async while its lanes read their moduli, and walks
// its columns in a grid-stride loop (columns.cuh): no step waits on device
// memory for a table.  A warp reads a column's channels-last row as
// consecutive words and writes its digits the same way.  Warps past the
// last column leave the loop; threads of the narrow mapping likewise.
#include "columns.cuh"

namespace {

// n <= 16: a thread a column, N = n.
template <int N>
__global__ void __launch_bounds__(32 * rns::kColMaxWarps)
mrc_thread_kernel(const int* __restrict__ x, int64_t xchs, int64_t xcs,
                  int* __restrict__ out, int64_t ochs, int64_t ocs,
                  const unsigned char* __restrict__ image,
                  const rns::ColLayout L, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::stage_image(smem, image, L.image);
  const int* mod = reinterpret_cast<const int*>(image);
  int m[N];
  float rc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    m[c] = __ldg(mod + c);
    rc[c] = rns::recip_rn(m[c]);
  }
  rns::stage_wait();
  const unsigned short* tri =
      reinterpret_cast<const unsigned short*>(smem + L.tri);

  for (int64_t col = rns::first_column<1>(); col < B;
       col += rns::column_step<1>()) {
    int w[N];
#pragma unroll
    for (int c = 0; c < N; ++c) w[c] = x[col * xcs + c * xchs];
    rns::mrc_thread<N>(w, m, rc, tri);
#pragma unroll
    for (int c = 0; c < N; ++c) out[col * ocs + c * ochs] = w[c];
  }
}

// n > 16: a warp a column, S register slots a lane.
template <int S>
__global__ void __launch_bounds__(32 * rns::kColMaxWarps)
mrc_warp_kernel(const int* __restrict__ x, int64_t xchs, int64_t xcs,
                int* __restrict__ out, int64_t ochs, int64_t ocs,
                const unsigned char* __restrict__ image,
                const rns::ColLayout L, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  rns::stage_image(smem, image, L.image);
  const int l = threadIdx.x & 31;
  int m[S];
  float rc[S];
  rns::load_moduli<S>(m, rc, reinterpret_cast<const int*>(image), L.n, l);
  rns::stage_wait();
  const unsigned short* tri =
      reinterpret_cast<const unsigned short*>(smem + L.tri);

  for (int64_t col = rns::first_column<32>(); col < B;
       col += rns::column_step<32>()) {
    int w[S];
    rns::load_rev<S>(w, x, L.n, xcs, xchs, col, l);
    rns::mrc_warp<S>(w, m, rc, tri, L.n, l);
    rns::store_rev<S>(out, w, L.n, ocs, ochs, col, l);
  }
}

#define RNS_THREAD(N) (const void*)mrc_thread_kernel<N>
const void* const kKernels[rns::kColInstances] = {
    RNS_THREAD(1),  RNS_THREAD(2),  RNS_THREAD(3),  RNS_THREAD(4),
    RNS_THREAD(5),  RNS_THREAD(6),  RNS_THREAD(7),  RNS_THREAD(8),
    RNS_THREAD(9),  RNS_THREAD(10), RNS_THREAD(11), RNS_THREAD(12),
    RNS_THREAD(13), RNS_THREAD(14), RNS_THREAD(15), RNS_THREAD(16),
    (const void*)mrc_warp_kernel<5>, (const void*)mrc_warp_kernel<14>};
#undef RNS_THREAD
std::atomic<unsigned long long> allowed{0};

}  // namespace

extern "C" int rns_mrc(const int* x, int64_t xchs, int64_t xcs, int* out,
                       int64_t ochs, int64_t ocs, const void* image,
                       const int* layout, int lanes, int warps,
                       int64_t blocks, int64_t B, void* stream) {
  const rns::ColLayout L{layout[0], layout[1], layout[2], layout[3]};
  int inst = -1;
  if (int err = rns::column_check(L, lanes, warps, blocks, B, &inst)) {
    return err;
  }
  void* args[] = {&x, &xchs, &xcs, &out, &ochs, &ocs, &image,
                  const_cast<rns::ColLayout*>(&L), &B};
  return rns::column_launch(kKernels, allowed, inst, L, warps, blocks, args,
                            stream);
}
