// The MRC triangle (paper Algorithm 2) with a column's channels in
// registers, shared by the column kernels (mrc.cu, rns_compare.cu) and the
// dual-base Montgomery kernels (mont_ladder.cu): mrc_warp, one column per
// warp, and mrc_thread, one column per thread for a narrow base.
//
// Mapping of mrc_warp.  Channel c of a side with `rows` channels sits in
// lane l = r % 32 of the column's warp, register slot r / 32, with
// r = rows - 1 - c (the reverse order).  Step j of the triangle broadcasts
// digit j (r = rows - 1 - j) from its lane with
// __shfl_sync and updates the channels r' < r, which in the reverse order
// are a prefix of the slots: the slots below the digit's are updated whole,
// the digit's own under a lane test, and the slots above it are never
// issued.  Depth: rows - 1 dependent steps.
//
// Exactness.  The step's reduction is lazy (kMagic below) and needs every
// modulus below 2**15: the kernels' wrappers refuse wider bases
// (kernels/ops.py, _check_bits: bits <= 15).  In mrc_warp the lanes past
// the last channel hold modulus 1 and read table words just before the
// triangle's first entry, so the triangle needs 64 bytes of readable
// shared memory before it (kernels/mrc.py, column_layout, and
// mont_ladder.py, smem_layout, put other tables there).
#pragma once

#include "common.cuh"

namespace rns {

constexpr unsigned kFull = 0xffffffffu;

// The MRC step's reduction, exact without a correction per step: for
// |t| < 2**31 with |t / m| < 2**16, one FFMA rounds t_f * (1/m) + 1.5 * 2**23
// to the integer q nearest the product (the sum lies in [2**23, 2**24),
// where the float spacing is 1), and the float's bits are 0x4B400000 + q.
// t_f and 1/m are correctly rounded and the product is not rounded before
// the sum, so |q - t/m| <= 1/2 + 2**16 * 2**-22.9 < 1 and r = t - q m lies
// in (-m, m): a residue of t that is exact but not yet canonical.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2**23
constexpr unsigned kMagicBits = 0x4B400000u;

// This lane's moduli in the MRC mapping (read from device memory, once a
// launch) and their correctly rounded reciprocals; padding gets m = 1
// (every reduction gives 0).
template <int S>
__device__ __forceinline__ void load_moduli(int (&m)[S], float (&rc)[S],
                                            const int* __restrict__ mod,
                                            int rows, int l) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int r = 32 * k + l;
    m[k] = (r < rows) ? __ldg(mod + rows - 1 - r) : 1;
    rc[k] = recip_rn(m[k]);
  }
}

// Rows 0..rows-1 of column col in the MRC mapping: channel c of the column
// at p[col * cs + c * chs] (element strides: cs = 1, chs = B for a
// channel-major tile; cs = the row's length, chs = 1 for channels-last
// rows).
template <int S>
__device__ __forceinline__ void load_rev(int (&v)[S],
                                         const int* __restrict__ p, int rows,
                                         int64_t cs, int64_t chs, int64_t col,
                                         int l) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int r = 32 * k + l;
    v[k] = (r < rows) ? p[col * cs + (int64_t)(rows - 1 - r) * chs] : 0;
  }
}

// The inverse of load_rev: v in the MRC mapping to rows 0..rows-1 of
// column col.
template <int S>
__device__ __forceinline__ void store_rev(int* __restrict__ p,
                                          const int (&v)[S], int rows,
                                          int64_t cs, int64_t chs,
                                          int64_t col, int l) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int r = 32 * k + l;
    if (r < rows) p[col * cs + (int64_t)(rows - 1 - r) * chs] = v[k];
  }
}

// Algorithm 2 on a warp's column in the MRC mapping, in place:
// residues in, mixed-radix digits out.  tri holds m_j^{-1} mod m_i for
// i > j at tri[j (2n - j - 1) / 2 + i - j - 1], in shared memory.  The
// outer loop over the digit's slot s unrolls, so every register index is a
// constant and the slots above s are never issued.
//
// Between steps a channel keeps z = c - r (mod 2**32), c = 0x4B400000 m,
// with r in (-m, m) its residue: then d = r - a is one three-input add,
// |d| < m + 2**15 < 2**16 and |t| = |d inv| < 2**31, and the next z is one
// multiply-add of the FFMA's bits, (0x4B400000 + q) m - t.  Only the digit
// is made canonical, once, before its broadcast, and every channel after
// the last step.  The digit's own slot is computed on every lane and kept
// where the lane's channel is still open (a select, not a branch; the
// spare lanes read inside the shared-memory window before the triangle).
template <int S>
__device__ __forceinline__ void mrc_warp(int (&w)[S], const int (&m)[S],
                                         const float (&rc)[S],
                                         const unsigned short* tri, int n,
                                         int l) {
  // unsigned: the stored form wraps modulo 2**32
  unsigned c[S], z[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    c[k] = kMagicBits * (unsigned)m[k];
    z[k] = c[k] - (unsigned)w[k];
  }
  // row + r' reads inv[j][n - 1 - r'] for step j at r = n - 1 - j
  const unsigned short* row = tri + n - 2 - l;
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    const int top = min(32 * s + 31, n - 1);
    const int bottom = max(32 * s, 1);  // r = 0 is the last digit: no step
    for (int r = top; r >= bottom; --r) {
      int v = (int)(c[s] - z[s]);
      v += m[s] & (v >> 31);  // canonical: the digit, at lane r - 32 s
      const int a = __shfl_sync(kFull, v, r - 32 * s);
      const bool open = l < r - 32 * s;
#pragma unroll
      for (int k = 0; k <= s; ++k) {
        const int t = (int)(c[k] - z[k] - (unsigned)a) * (int)row[-32 * k];
        const float y = __fmaf_rn(__int2float_rn(t), rc[k], kMagic);
        const unsigned u = (unsigned)__float_as_int(y) * (unsigned)m[k] -
                           (unsigned)t;
        z[k] = (k < s || open) ? u : z[k];
      }
      row += r - 1;  // row j + 1 starts n - 1 - j entries on
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int v = (int)(c[k] - z[k]);
    w[k] = v + (m[k] & (v >> 31));
  }
}

// Algorithm 2 on one thread's column of N channels in registers, channel
// order, in place: mrc_warp's lazy step on every pair i > j, digit j made
// canonical once before its row of steps and every channel after the last.
// Every index is a constant, so each table word is a shared-memory
// broadcast at a fixed offset: N(N-1)/2 steps and no lane idle, the cheaper
// mapping wherever the column fits a thread's registers.
template <int N>
__device__ __forceinline__ void mrc_thread(int (&w)[N], const int (&m)[N],
                                           const float (&rc)[N],
                                           const unsigned short* tri) {
  unsigned c[N], z[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    c[k] = kMagicBits * (unsigned)m[k];
    z[k] = c[k] - (unsigned)w[k];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int a = (int)(c[j] - z[j]);
    a += m[j] & (a >> 31);  // canonical: digit j
    w[j] = a;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      const int t = (int)(c[i] - z[i] - (unsigned)a) *
                    (int)tri[j * (2 * N - j - 1) / 2 + i - j - 1];
      const float y = __fmaf_rn(__int2float_rn(t), rc[i], kMagic);
      z[i] = (unsigned)__float_as_int(y) * (unsigned)m[i] - (unsigned)t;
    }
  }
}

}  // namespace rns
