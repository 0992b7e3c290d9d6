// Dual-base RNS Montgomery product and fused Montgomery-ladder bit for
// Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/mont_ladder.py::mont_mul_kernel_call   (rns_mont_mul)
//   src/repro/kernels/mont_ladder.py::mont_ladder_kernel_call (rns_mont_ladder)
//
// In (int32, channel-major, one column per big integer):
//   x/y lo (nch_lo, B)  B-side residues: the n base channels, then the
//                       redundant ones (m_a, and m_b on an RRNS layout);
//   x/y hi (n_hi, B)    B'-side residues;
//   neg (n, B)          -N^{-1} mod m_i and nhi (n_hi, B) N mod m'_j, per
//                       COLUMN: one launch serves a batch of different N;
//   bit (B,)            the ladder's exponent bit (ladder kernel only);
//   inv_lo (n, n)       inv_lo[j*n + i] = m_j^{-1} mod m_i;   m_lo (nch_lo,)
//   bl2h (n, n_hi)      bl2h[j*n_hi + t] = prod_{k<j} m_k mod m'_t
//   inv_hi (n_hi, n_hi), m_hi (n_hi,), minv (n_hi,) = M^{-1} mod m'_j
//   bh2l (n_hi, nch_lo) bh2l[j*nch_lo + t] = prod_{k<j} m'_k mod m_t
// Out: the product's lo (nch_lo, B) and hi (n_hi, B) tiles; the ladder
//   kernel writes four: (o0, o1) = bit ? (t, s) : (s, t) with
//   t = MM(r0, r1) and s = MM(r_bit, r_bit).
//
// One product per column (core/montgomery.py has the algebra):
//   q  = (x*y mod m_i) * neg_i mod m_i          n base channels of B
//   q' = dot(MRC_B(q), bl2h)                    exact extension B -> B'
//   r' = ((x'y' + q'*nhi) mod m'_j) * minv_j    exact division by M
//   r  = dot(MRC_B'(r'), bh2l)                  B' -> every B-side channel
//
// What bounds it: at n = 138 a product costs per column two MRC triangles
// (2 x 9,453 modular steps) and two dots (2 x ~19,000 terms), some 57,000
// Barrett steps on 2.2 KB of operands — the int32 pipe, by far.
//
// Design: ONE WARP PER COLUMN, the channels spread over the 32 lanes:
// channel c lives in lane c % 32, register slot c / 32 (K slots a lane,
// K = ceil(max(nch_lo, n_hi) / 32), a template parameter so that every
// slot index is a compile-time constant and the column stays in registers;
// about 20 K-wide arrays per ladder bit).  The slice-1 layout (a column per
// thread, in shared memory) would need ~2.2 KB a column here, 283 KB for a
// 128-column block.  MRC step j broadcasts digit j with __shfl_sync and
// every lane updates its own channels c > j: n - 1 steps deep, the paper's
// parallel MRC.  The dot gives each lane its target channels and
// broadcasts the digits in turn.  Table rows are read coalesced across the
// lanes (lane t reads word t of row j) through the read-only path; the four
// tables (~300 KB at n = 138) stay in L2.  No shared memory.
//
// Constant time: which instructions run and which addresses they touch
// depend only on the shapes.  Every predicate is an index test; the
// ladder's select is arithmetic on an all-ones/all-zeros mask made from
// the bit, and both products always run.
//
// Exactness: every product fed to barrett_mod is below m * 2**15 — x*y,
// q*neg, q'*nhi and t*minv are products of two residues of one modulus;
// a dot term d_j * beta has d_j < 2**15 and beta < m_t — so every
// reduction is exact (common.cuh).  Each dot's running sum stays < m by one
// conditional subtract per term, as _dot_rows does.  Never build with
// --use_fast_math.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;   // columns per block
// Up to 160 channels a side: RSA-2048 takes 139 (N up to about 2,370 bits
// fits).  Each slot count is one template instance of each kernel, and the
// build compiles them all; a wider base is one more case below.
constexpr int kMaxSlots = 5;

// The seven tables (read through the read-only path) and the shapes.
struct Tables {
  const int* inv_lo;
  const int* m_lo;
  const int* bl2h;
  const int* inv_hi;
  const int* m_hi;
  const int* bh2l;
  const int* minv;
  int n, nch_lo, n_hi;
};

// This lane's moduli, reciprocals and M^{-1} residues; padding slots get
// m = 1 (every reduction then gives 0) and are never stored.
template <int K>
struct Moduli {
  int lo[K];
  float rlo[K];
  int hi[K];
  float rhi[K];
  int minv[K];
};

template <int K>
__device__ __forceinline__ void load_moduli(Moduli<K>& md, const Tables& tb,
                                            int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    md.lo[k] = (c < tb.nch_lo) ? __ldg(tb.m_lo + c) : 1;
    md.hi[k] = (c < tb.n_hi) ? __ldg(tb.m_hi + c) : 1;
    md.minv[k] = (c < tb.n_hi) ? __ldg(tb.minv + c) : 0;
    md.rlo[k] = rns::recip_rn(md.lo[k]);
    md.rhi[k] = rns::recip_rn(md.hi[k]);
  }
}

template <int K>
__device__ __forceinline__ void load_col(int (&v)[K],
                                         const int* __restrict__ p, int rows,
                                         int64_t B, int64_t col, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    v[k] = (c < rows) ? p[(int64_t)c * B + col] : 0;
  }
}

template <int K>
__device__ __forceinline__ void store_col(int* __restrict__ p,
                                          const int (&v)[K], int rows,
                                          int64_t B, int64_t col, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < rows) p[(int64_t)c * B + col] = v[k];
  }
}

// Algorithm 2 on a warp's column, in place: residues in, mixed-radix digits
// out.  Digit j is final after step j - 1 and lives in lane j % 32, slot
// j / 32; the outer loop over slots unrolls, so every register index is a
// constant, and the inner loop over the 32 lanes of a slot does not.
template <int K>
__device__ __forceinline__ void mrc_warp(int (&w)[K], const int (&m)[K],
                                         const float (&r)[K],
                                         const int* __restrict__ inv, int n,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int steps = min(32, n - 1 - 32 * kk);
    for (int jl = 0; jl < steps; ++jl) {
      const int j = 32 * kk + jl;
      const int a = __shfl_sync(kFull, w[kk], jl);
      const int* __restrict__ inv_j = inv + (size_t)j * n;
#pragma unroll
      for (int k = kk; k < K; ++k) {
        const int c = lane + 32 * k;
        if (c > j && c < n) {
          int d = w[k] - a;
          d += (d < 0) ? m[k] : 0;
          w[k] = rns::barrett_mod(d * __ldg(inv_j + c), m[k], r[k]);
        }
      }
    }
  }
}

// Algorithm 3 against T targets: acc[k] = sum_j d_j * betas[j*T + t] mod m_t
// for this lane's targets t = lane + 32k < T, the n_src digits broadcast in
// turn from the source layout.  Each term is reduced and the running sum
// kept below m_t by one conditional subtract.
template <int K>
__device__ __forceinline__ void dot_warp(const int (&d)[K], int n_src,
                                         const int* __restrict__ betas, int T,
                                         const int (&m)[K],
                                         const float (&r)[K], int (&acc)[K],
                                         int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int steps = min(32, n_src - 32 * kk);
    for (int jl = 0; jl < steps; ++jl) {
      const int j = 32 * kk + jl;
      const int dj = __shfl_sync(kFull, d[kk], jl);
      const int* __restrict__ b_j = betas + (size_t)j * T;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = lane + 32 * k;
        if (t < T) {
          const int s =
              acc[k] + rns::barrett_mod(dj * __ldg(b_j + t), m[k], r[k]);
          acc[k] = (s >= m[k]) ? s - m[k] : s;
        }
      }
    }
  }
}

// One Montgomery product MM(x, y) on a warp's column.
template <int K>
__device__ __forceinline__ void mont_mul_warp(
    const int (&xlo)[K], const int (&xhi)[K], const int (&ylo)[K],
    const int (&yhi)[K], const int (&neg)[K], const int (&nhi)[K],
    const Moduli<K>& md, const Tables& tb, int (&olo)[K], int (&ohi)[K],
    int lane) {
  int q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    const int p = rns::barrett_mod(xlo[k] * ylo[k], md.lo[k], md.rlo[k]);
    q[k] = (c < tb.n) ? rns::barrett_mod(p * neg[k], md.lo[k], md.rlo[k]) : 0;
  }
  mrc_warp<K>(q, md.lo, md.rlo, tb.inv_lo, tb.n, lane);
  int qp[K];
  dot_warp<K>(q, tb.n, tb.bl2h, tb.n_hi, md.hi, md.rhi, qp, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int t = rns::barrett_mod(xhi[k] * yhi[k], md.hi[k], md.rhi[k]) +
            rns::barrett_mod(qp[k] * nhi[k], md.hi[k], md.rhi[k]);
    t -= (t >= md.hi[k]) ? md.hi[k] : 0;
    ohi[k] = rns::barrett_mod(t * md.minv[k], md.hi[k], md.rhi[k]);
    q[k] = ohi[k];  // the B' MRC works on a copy: r' is an output
  }
  mrc_warp<K>(q, md.hi, md.rhi, tb.inv_hi, tb.n_hi, lane);
  dot_warp<K>(q, tb.n_hi, tb.bh2l, tb.nch_lo, md.lo, md.rlo, olo, lane);
}

// mask ? b : a, for a mask of all ones or all zeros: no branch, no
// data-dependent address.
__device__ __forceinline__ int pick(int a, int b, int mask) {
  return a ^ ((a ^ b) & mask);
}

template <int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
mont_mul_kernel(const int* __restrict__ xlo, const int* __restrict__ xhi,
                const int* __restrict__ ylo, const int* __restrict__ yhi,
                const int* __restrict__ neg, const int* __restrict__ nhi,
                int* __restrict__ olo, int* __restrict__ ohi, Tables tb,
                int64_t B) {
  const int lane = threadIdx.x & 31;
  const int64_t col = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (col >= B) return;  // uniform across the warp: its shuffles stay full

  Moduli<K> md;
  load_moduli<K>(md, tb, lane);
  int xl[K], xh[K], yl[K], yh[K], ng[K], nh[K], ol[K], oh[K];
  load_col<K>(xl, xlo, tb.nch_lo, B, col, lane);
  load_col<K>(xh, xhi, tb.n_hi, B, col, lane);
  load_col<K>(yl, ylo, tb.nch_lo, B, col, lane);
  load_col<K>(yh, yhi, tb.n_hi, B, col, lane);
  load_col<K>(ng, neg, tb.n, B, col, lane);
  load_col<K>(nh, nhi, tb.n_hi, B, col, lane);
  mont_mul_warp<K>(xl, xh, yl, yh, ng, nh, md, tb, ol, oh, lane);
  store_col<K>(olo, ol, tb.nch_lo, B, col, lane);
  store_col<K>(ohi, oh, tb.n_hi, B, col, lane);
}

template <int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
mont_ladder_kernel(const int* __restrict__ r0lo, const int* __restrict__ r0hi,
                   const int* __restrict__ r1lo, const int* __restrict__ r1hi,
                   const int* __restrict__ bit, const int* __restrict__ neg,
                   const int* __restrict__ nhi, int* __restrict__ o0lo,
                   int* __restrict__ o0hi, int* __restrict__ o1lo,
                   int* __restrict__ o1hi, Tables tb, int64_t B) {
  const int lane = threadIdx.x & 31;
  const int64_t col = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (col >= B) return;

  Moduli<K> md;
  load_moduli<K>(md, tb, lane);
  int al[K], ah[K], bl[K], bh[K], ng[K], nh[K];
  load_col<K>(al, r0lo, tb.nch_lo, B, col, lane);
  load_col<K>(ah, r0hi, tb.n_hi, B, col, lane);
  load_col<K>(bl, r1lo, tb.nch_lo, B, col, lane);
  load_col<K>(bh, r1hi, tb.n_hi, B, col, lane);
  load_col<K>(ng, neg, tb.n, B, col, lane);
  load_col<K>(nh, nhi, tb.n_hi, B, col, lane);
  const int mask = -(int)(bit[col] != 0);  // all ones where the bit is set

  int tl[K], th[K];
  mont_mul_warp<K>(al, ah, bl, bh, ng, nh, md, tb, tl, th, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {  // the square's operand: r_bit
    al[k] = pick(al[k], bl[k], mask);
    ah[k] = pick(ah[k], bh[k], mask);
  }
  int sl[K], sh[K];
  mont_mul_warp<K>(al, ah, al, ah, ng, nh, md, tb, sl, sh, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {  // bit 0: (s, t); bit 1: (t, s)
    al[k] = pick(sl[k], tl[k], mask);
    ah[k] = pick(sh[k], th[k], mask);
    bl[k] = pick(tl[k], sl[k], mask);
    bh[k] = pick(th[k], sh[k], mask);
  }
  store_col<K>(o0lo, al, tb.nch_lo, B, col, lane);
  store_col<K>(o0hi, ah, tb.n_hi, B, col, lane);
  store_col<K>(o1lo, bl, tb.nch_lo, B, col, lane);
  store_col<K>(o1hi, bh, tb.n_hi, B, col, lane);
}

// Register slots a lane needs, or 0 for shapes the kernels do not take.
int slots(int n, int nch_lo, int n_hi, int64_t B) {
  if (n < 1 || nch_lo < n || n_hi < 1 || B < 1) return 0;
  const int k = ((nch_lo > n_hi ? nch_lo : n_hi) + 31) / 32;
  return k <= kMaxSlots ? k : 0;
}

unsigned blocks(int64_t B) {
  return (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

#define RNS_SLOT_CASES(LAUNCH) LAUNCH(1) LAUNCH(2) LAUNCH(3) LAUNCH(4) LAUNCH(5)

}  // namespace

extern "C" int rns_mont_mul(const int* xlo, const int* xhi, const int* ylo,
                            const int* yhi, const int* neg, const int* nhi,
                            int* olo, int* ohi, const int* inv_lo,
                            const int* m_lo, const int* bl2h,
                            const int* inv_hi, const int* m_hi,
                            const int* bh2l, const int* minv, int n,
                            int nch_lo, int n_hi, int64_t B, void* stream) {
  const Tables tb{inv_lo, m_lo, bl2h, inv_hi, m_hi, bh2l, minv,
                  n,      nch_lo, n_hi};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (slots(n, nch_lo, n_hi, B)) {
#define RNS_MUL(K)                                                       \
  case K:                                                                \
    mont_mul_kernel<K><<<blocks(B), 32 * kWarpsPerBlock, 0, s>>>(        \
        xlo, xhi, ylo, yhi, neg, nhi, olo, ohi, tb, B);                  \
    break;
    RNS_SLOT_CASES(RNS_MUL)
#undef RNS_MUL
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int rns_mont_ladder(const int* r0lo, const int* r0hi,
                               const int* r1lo, const int* r1hi,
                               const int* bit, const int* neg, const int* nhi,
                               int* o0lo, int* o0hi, int* o1lo, int* o1hi,
                               const int* inv_lo, const int* m_lo,
                               const int* bl2h, const int* inv_hi,
                               const int* m_hi, const int* bh2l,
                               const int* minv, int n, int nch_lo, int n_hi,
                               int64_t B, void* stream) {
  const Tables tb{inv_lo, m_lo, bl2h, inv_hi, m_hi, bh2l, minv,
                  n,      nch_lo, n_hi};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (slots(n, nch_lo, n_hi, B)) {
#define RNS_LADDER(K)                                                    \
  case K:                                                                \
    mont_ladder_kernel<K><<<blocks(B), 32 * kWarpsPerBlock, 0, s>>>(     \
        r0lo, r0hi, r1lo, r1hi, bit, neg, nhi, o0lo, o0hi, o1lo, o1hi,   \
        tb, B);                                                          \
    break;
    RNS_SLOT_CASES(RNS_LADDER)
#undef RNS_LADDER
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
