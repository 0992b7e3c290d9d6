// The RRNS repair (locate and correct one faulted channel a column) in one
// pass over the codewords, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's GradCodec._fault_scan is plain
// jnp.  Its plain-torch version is rrns_repair_plain, the clean test and
// then survivor_scan and its fix (kernels/rrns_repair.py), with its bits.
//
// In:  x, n + 2 residues a column (n base channels, then m_a and m_b), read
//      and fixed where they lie: channel c of column b at x[c * xchs +
//      b * xcs]; image, the tables (kernels/rrns_repair.py, repair_layout).
// Out: x, the faulted residue of each column with a unique hit rebuilt;
//      verdict (optional), -1 clean, the channel, or -2 uncorrectable;
//      counts, int64 [repaired, unrepairable, scanned], added to.
//
// What bounds it: one read of the wire, 4 (n + 2) bytes a column, against
// some 50 int32 instructions a column for the clean test: device memory.
//
// Design: a thread a column, its residues in registers.  The clean test
// (kernels/rrns_repair.py): the base residues canonical, their MRC
// (mrc_warp.cuh, mrc_thread: the FFMA-rounded lazy step) and the Alg.-3
// dots into m_a and m_b equal to the carried pair.  Such a column is
// consistent in every channel, so survivor_scan's verdict is -1: nothing
// is written.  A column that fails it (a fault: rare) takes full_scan, the
// survivor scan in survivor_scan's own int32 operations, wrapping products
// and floored remainders included, so the bits agree on any input.  The
// block stages the tables into shared memory with cp.async (columns.cuh)
// and walks its columns in a grid-stride loop; its counts are summed in
// shared memory and added to the int64 counts with one atomic each, only
// by a block that has something to add.  Nothing waits for the host.
#include "columns.cuh"

namespace {

// Three base channels: every base of 15-bit moduli with M < 2**45, which
// the codec kernels take (GradCodec.use_fused).
constexpr int kMaxBase = 3;

// Byte offsets of the image, as kernels/rrns_repair.py::repair_layout
// computes them (LAYOUT_FIELDS order).
struct RepairLayout {
  int n, mod, mu, beta, smod, sinv, sbeta, rdig, tri, image;
};

// torch's int32 arithmetic: products and sums wrap modulo 2**32, and
// torch.remainder takes the divisor's sign (m > 0 here).
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int floor_mod(int t, int m) {
  const int r = t % m;
  return r < 0 ? r + m : r;
}

// A column's residues, passed by value.
template <int C>
struct Column {
  int r[C];
};

// survivor_scan on one column: for each channel c an MRC of the
// survivors (mrc_unrolled), "below R" (not mrs_ge against R's digits) and
// the Alg.-3 extension to m_c (mrs_dot_mod).  Returns the verdict, and in
// *fix the extension of the first consistent channel.  Out of line: the
// clean test's loop keeps its registers.
template <int N>
__device__ __noinline__ int full_scan(const Column<N + 2> x, const int* t,
                                      const RepairLayout L, int* fix) {
  constexpr int C = N + 2, S = N + 1;
  const int* mod = t + L.mod / 4;
  int cnt = 0, hit = 0;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const int* sm = t + L.smod / 4 + c * S;
    const int* inv = t + L.sinv / 4 + c * S * S;
    const int* sb = t + L.sbeta / 4 + c * S;
    const int* rd = t + L.rdig / 4 + c * S;
    int w[S], a[S];
#pragma unroll
    for (int k = 0; k < S; ++k) w[k] = k < c ? x.r[k] : x.r[k + 1];
    a[0] = w[0];
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
#pragma unroll
      for (int k = j + 1; k < S; ++k) {
        int d = wrap_sub(w[k], a[j]);
        if (d < 0) d = wrap_add(d, sm[k]);
        w[k] = floor_mod(wrap_mul(d, inv[j * S + k]), sm[k]);
      }
      a[j + 1] = w[j + 1];
    }
    bool lt = false, done = false;
#pragma unroll
    for (int k = S - 1; k >= 0; --k) {
      if (!done && a[k] != rd[k]) {
        lt = a[k] < rd[k];
        done = true;
      }
    }
    const int mc = mod[c];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      sum = wrap_add(sum, floor_mod(wrap_mul(a[k], sb[k]), mc));
    }
    if (lt) {
      if (cnt == 0) {
        hit = c;
        *fix = floor_mod(sum, mc);
      }
      ++cnt;
    }
  }
  return cnt == C ? -1 : (cnt == 1 ? hit : -2);
}

// X mod m from the digits (Alg. 3): sum_i d_i beta_i, each term below
// 2**30, so the sum of N <= 3 is below 2**32, where mod_mulhi is exact.
template <int N>
__device__ __forceinline__ int extend(const int (&d)[N], const int* beta,
                                      int m, unsigned mu) {
  static_assert(N <= 3, "the dot's sum must stay below 2**32");
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc += (unsigned)d[i] * (unsigned)beta[i];
  return rns::mod_mulhi(acc, m, mu);
}

template <int N>
__global__ void __launch_bounds__(32 * rns::kColMaxWarps)
rrns_repair_kernel(int* __restrict__ x, int64_t xchs, int64_t xcs,
                   int* __restrict__ verdict,
                   unsigned long long* __restrict__ counts,
                   const unsigned char* __restrict__ image,
                   const RepairLayout L, int64_t B) {
  constexpr int C = N + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned block_counts[3];
  rns::stage_image(smem, image, L.image);
  if (threadIdx.x < 3) block_counts[threadIdx.x] = 0;
  const int* mod = reinterpret_cast<const int*>(image + L.mod);
  int m[N];
  float rc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    m[c] = __ldg(mod + c);
    rc[c] = rns::recip_rn(m[c]);
  }
  const int ma = __ldg(mod + N), mb = __ldg(mod + N + 1);
  const unsigned* mu = reinterpret_cast<const unsigned*>(image + L.mu);
  const unsigned mua = __ldg(mu), mub = __ldg(mu + 1);
  rns::stage_wait();
  const int* t = reinterpret_cast<const int*>(smem);
  const int* beta = t + L.beta / 4;
  const unsigned short* tri =
      reinterpret_cast<const unsigned short*>(smem + L.tri);

  unsigned repaired = 0, bad = 0, scanned = 0;
  for (int64_t col = rns::first_column<1>(); col < B;
       col += rns::column_step<1>()) {
    Column<C> col_r;
    int* r = col_r.r;
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = x[col * xcs + c * xchs];
    bool canon = true;
#pragma unroll
    for (int c = 0; c < N; ++c) canon &= (unsigned)r[c] < (unsigned)m[c];
    int d[N];  // the lazy step's range needs canonical residues
#pragma unroll
    for (int c = 0; c < N; ++c) d[c] = canon ? r[c] : 0;
    rns::mrc_thread<N>(d, m, rc, tri);
    const bool clean = canon && extend<N>(d, beta, ma, mua) == r[N] &&
                       extend<N>(d, beta + N, mb, mub) == r[N + 1];
    int v = -1;
    if (!clean) {
      int fix = 0;
      v = full_scan<N>(col_r, t, L, &fix);
      ++scanned;
      if (v >= 0) {
        x[col * xcs + v * xchs] = fix;
        ++repaired;
      } else if (v == -2) {
        ++bad;
      }
    }
    if (verdict != nullptr) verdict[col] = v;
  }
  if (__syncthreads_or(scanned)) {  // repaired and bad count scanned columns
    if (repaired) atomicAdd(&block_counts[0], repaired);
    if (bad) atomicAdd(&block_counts[1], bad);
    if (scanned) atomicAdd(&block_counts[2], scanned);
    __syncthreads();
    if (threadIdx.x < 3 && block_counts[threadIdx.x]) {
      atomicAdd(counts + threadIdx.x,
                (unsigned long long)block_counts[threadIdx.x]);
    }
  }
}

const void* const kKernels[kMaxBase] = {(const void*)rrns_repair_kernel<1>,
                                         (const void*)rrns_repair_kernel<2>,
                                         (const void*)rrns_repair_kernel<3>};

}  // namespace

extern "C" int rns_rrns_repair(int* x, int64_t xchs, int64_t xcs,
                               int* verdict, unsigned long long* counts,
                               const void* image, const int* layout,
                               int warps, int64_t blocks, int64_t B,
                               void* stream) {
  const RepairLayout L{layout[0], layout[1], layout[2], layout[3],
                       layout[4], layout[5], layout[6], layout[7],
                       layout[8], layout[9]};
  if (L.n < 1 || L.n > kMaxBase || B < 1 || warps < 1 ||
      warps > rns::kColMaxWarps || blocks < 1 || blocks > 0x7fffffff ||
      L.image % 16 || L.image > 48 * 1024 ||
      L.tri + L.n * (L.n - 1) > L.image) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&x, &xchs, &xcs, &verdict, &counts, &image,
                  const_cast<RepairLayout*>(&L), &B};
  cudaLaunchKernel(kKernels[L.n - 1], dim3((unsigned)blocks),
                   dim3(32 * warps), args, (size_t)L.image,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();  // the launch's error, cleared
}
