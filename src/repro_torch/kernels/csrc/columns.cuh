// What the column kernels (mrc.cu, rns_compare.cu) share: the layout of a
// base's table image, its staging into shared memory, and the launch of
// their template instances.
//
// Launch.  A block of `warps` warps (kernels/mrc.py chooses it and the
// grid) stages the base's table image into shared memory once with
// cp.async, then walks its columns in a grid-stride loop, so that the image
// is staged once a block and not once a column.  Two mappings: a base of
// n <= 16 channels takes one column per thread (mrc_thread, an instance a
// width N = n: 32 columns a warp), a wider one a column per warp (mrc_warp,
// 5 register slots a lane for n <= 160, 14 for n <= 448).  The caller
// names the lanes a column (1 or 32); the instance follows from n.
#pragma once

#include <atomic>

#include "mrc_warp.cuh"

namespace rns {

// Byte offsets of a base's table image, as kernels/mrc.py::column_layout
// computes them and passes them in (the kernels compute none): the moduli
// (int32) at 0, the betas prod_{k<i} m_k mod m_a (int32) at `betas`, the
// triangle's entries m_j^{-1} mod m_i (uint16, row j after row j - 1) at
// `tri`, at least 64 bytes on; `image` bytes in all, a multiple of 16.
struct ColLayout {
  int n, betas, tri, image;
};

constexpr int kColMaxWarps = 8;
constexpr int kColMaxChannels = 32 * 14;

// Start the copy of the image into shared memory, 16 bytes a cp.async,
// every thread of the block taking part; stage_wait() completes it.
__device__ __forceinline__ void stage_image(unsigned char* s,
                                            const unsigned char* image,
                                            int bytes) {
  for (int o = 16 * threadIdx.x; o < bytes; o += 16 * blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s + o);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(image + o)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The first column of this thread (G = 1) or of its warp (G = 32: G lanes
// a column) and the columns a grid-stride step advances.
template <int G>
__device__ __forceinline__ int64_t first_column() {
  return ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
}

template <int G>
__device__ __forceinline__ int64_t column_step() {
  return (int64_t)gridDim.x * blockDim.x / G;
}

// The instances of a column kernel: the thread mapping at N = 1..16
// (index N - 1), then the warp mapping with 5 and with 14 slots a lane.
constexpr int kColInstances = 18;
constexpr int kColNarrow = 16;

// Index of the instance for n channels at `lanes` lanes a column, or -1.
inline int column_instance(int n, int lanes) {
  if (lanes == 1) return (n >= 1 && n <= kColNarrow) ? n - 1 : -1;
  if (lanes != 32 || n <= kColNarrow) return -1;
  return n <= 160 ? kColNarrow : (n <= kColMaxChannels ? kColNarrow + 1 : -1);
}

// 0, or the error that keeps a launch with these shapes from running: the
// instance's index in *inst.
inline int column_check(const ColLayout& L, int lanes, int warps,
                        int64_t blocks, int64_t B, int* inst) {
  *inst = column_instance(L.n, lanes);
  if (*inst < 0 || B < 1 || warps < 1 || warps > kColMaxWarps ||
      blocks < 1 || blocks > 0x7fffffff || L.image > kMaxSmem ||
      L.image % 16 || L.tri < 64 || L.betas < 4 * L.n ||
      L.tri < L.betas + 4 * L.n ||
      (int64_t)L.tri + (int64_t)L.n * (L.n - 1) > L.image) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Lets every instance take up to kMaxSmem of dynamic shared memory: once a
// device, not once a launch.
inline int column_allow_smem(const void* const (&kernels)[kColInstances],
                             std::atomic<unsigned long long>& done) {
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return 0;
  for (const void* k : kernels) {
    if (cudaError_t err = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)) {
      return (int)err;
    }
  }
  done.fetch_or(bit);
  return 0;
}

// Launch instance `inst` of `kernels` with the kernel's arguments `args`.
inline int column_launch(const void* const (&kernels)[kColInstances],
                         std::atomic<unsigned long long>& done, int inst,
                         const ColLayout& L, int warps, int64_t blocks,
                         void** args, void* stream) {
  if (int err = column_allow_smem(kernels, done)) return err;
  cudaLaunchKernel(kernels[inst], dim3((unsigned)blocks), dim3(32 * warps),
                   args, (size_t)L.image, (cudaStream_t)stream);
  return (int)cudaGetLastError();  // the launch's error, cleared
}

}  // namespace rns
