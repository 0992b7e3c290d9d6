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
//                       only the base channels are read;
//   x/y hi (n_hi, B)    B'-side residues;
//   neg (n, B)          -N^{-1} mod m_i and nhi (n_hi, B) N mod m'_j, per
//                       COLUMN: one launch serves a batch of different N;
//   bit (B,)            the ladder's exponent bit (ladder kernel only);
//   image               the N-independent tables as the block's shared
//                       memory holds them (kernels/mont_ladder.py,
//                       pack_image; Layout below): the moduli and their
//                       multiply-high reciprocals, M^{-1} mod m'_j, the two
//                       inverse triangles m_j^{-1} mod m_i (i > j) packed
//                       row by row as 16-bit words, and the two
//                       base-extension tables prod_{k<j} m_k mod m_t split
//                       into low and high byte planes, one row per target
//                       t, the digit index j along the row.
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
// Design: a block of C columns, one warp per column.  C = 16 where 16-column
// blocks still give every SM one (B >= 16 x SMs, the timing shape's 8,192
// columns), else 8 (the lane's 1,024 columns: 128 blocks on 132 SMs).  16
// is the most: the MMA tile has 16 rows, a ladder warp holds some 126
// registers (16 warps take the SM's 64K), and one block's 167 KB of shared
// memory at n = 138 leaves room for one block an SM.  Two template
// instances of each kernel; kernels/mont_ladder.py picks C (block_cols)
// and passes the block's layout (block_layout), which names the one to
// run.  At
// 8,192 columns the 16-column blocks take 0.72 times the 8-column blocks'
// time (PERF.md, tools/mont_attribution.py).
//  * Tables in shared memory.  The block copies the image (142,080 bytes at
//    n = 138: 16-bit triangles, 8-bit planes) into shared memory once with
//    cp.async, while its warps load their operands, and every column of
//    the block reads it there: no table row is read from L2 per column.
//  * MRC triangles in registers.  Channel c of a side with `rows`
//    channels lives in lane r % 32, register slot r / 32 (5 slots: up to
//    160 channels), with r = rows - 1 - c, so the channels still to update
//    at step j are r < rows - 1 - j: a prefix of the slots.  Step j
//    broadcasts digit j with __shfl_sync and updates the slots below the
//    digit's fully and the digit's own slot under a lane test; the
//    slots above are never issued.  At n = 138 a triangle issues 11,808
//    lane-steps for its 9,453 (80 % busy).  Each step is the lazy
//    reduction of mrc_warp (mrc_warp.cuh, shared with mrc.cu and
//    rns_compare.cu): one FFMA rounds the quotient, no correction until
//    the digit is broadcast.  Depth: n - 1 steps, the paper's
//    parallel MRC.
//  * The four base-extension dots on the tensor cores, exactly.  Each
//    warp writes its column's digits d_j < 2**15 into the block's digit
//    tile as two byte planes (d = 256 dh + dl), and the block computes
//    (digits, 16 x K) . (table, K x T) with mma.sync.m16n8k32 u8 x u8 ->
//    s32, four products per tile (dl.bl, dl.bh, dh.bl, dh.bh), each warp
//    taking n-tiles of 8 targets in turn.  Every limb sum has at most 160
//    terms below 2**16 (255 x 255), so it is below 160 * 2**16 < 2**24:
//    no s32 accumulator can overflow, and the integer products round
//    nothing.  The epilogue recombines exactly,
//        S mod m = (((hh mod m) * 256 + lh + hl) mod m * 256 + ll) mod m,
//    each step an exact multiply-high reduction (common.cuh::mod_mulhi)
//    of an input below 2**23 + 2**25 < 2**32, and writes the canonical
//    residue — the value the term-by-term Barrett dot of the plain version
//    gives, bit for bit.  Depth K is the source side padded to 32 with
//    zero digits and zero table bytes; targets are padded to 8 with zero
//    table rows and modulus 1 (whose results are never read).  Rows of the
//    16-row tile beyond C stay zero.  Why u8 mma.sync: int8 runs at about
//    30 times the f64 tensor rate, and four u8 products are still exact;
//    wgmma would need 64-row tiles, 64 columns a block, which neither the
//    registers nor the shared memory hold.
//  * Two block barriers per dot: digits written -> MMA -> residues written
//    -> each warp reads its column's residues back.
//  * Outputs leave through a shared tile, so that the block's stores of a
//    channel row cover its C neighbouring columns (64 bytes at C = 16),
//    whole sectors.
//
// What bounds it now (chip_smoke.py, mont_mix): the MRC triangles' steps
// and the channel-wise products on the int32 pipe; the dots (n n_hi +
// n_hi nch_lo terms, four u8 products each) take some 3 % of that time on
// the int8 tensor cores, the operands some 16 % on device memory.  On the
// card the triangles take about two thirds of a launch, the dots an eighth
// and the operand loads a tenth (tools/mont_attribution.py; PERF.md): the
// SIMT triangle, its idle fifth and its shuffle-to-shuffle latency, are
// what is left.
//
// Constant time: which instructions run and which addresses they touch
// depend only on the shapes.  Every predicate is an index test (lane,
// slot, channel or column against a shape); the MMA tiles, the table and
// digit addresses and the barriers follow from the shapes alone; the
// ladder's select is arithmetic on an all-ones/all-zeros mask made from
// the bit, and both products always run.  Warps past the last column
// compute on a copy of it and store nothing.
//
// Exactness of the scalar steps: every product fed to barrett_mod is below
// m * 2**15 — x*y, q*neg, q'*nhi and t*minv are products of two residues
// of one modulus — so every reduction is exact (common.cuh).  The
// triangle's step has its own bound (mrc_warp).  Never build with
// --use_fast_math.
#include <atomic>
#include <cstring>
#include <initializer_list>

#include "mrc_warp.cuh"

namespace {

// Register slots a lane: 32 x 5 = 160 channels a side (RSA-2048 takes 139).
constexpr int kSlots = 5;
constexpr int kMaxChannels = 32 * kSlots;
constexpr int kRows = 16;  // the MMA's m: a block's columns, zero-padded

// Byte offsets of the shared-memory image and of a block's scratch, as
// kernels/mont_ladder.py::block_layout computes them and passes them in:
// the kernels compute no offset of their own.  The fields are int32, in
// the order of that module's LAYOUT_FIELDS.
struct Layout {
  int n, nch_lo, n_hi;
  int nt1, nt2;  // dot targets (n_hi, nch_lo) padded to the MMA's n = 8
  int k1, k2;    // dot depths (n, n_hi) padded to the MMA's k = 32
  int s1, s2;    // byte stride of a table row: k + 16, so that the 8 rows
  int sd;        // of an n-tile fall on distinct banks; sd for digit rows
  int rs;        // int32 stride of a residue row
  int m_lo, mu_lo, m_hi, mu_hi, minv, tri_lo, tri_hi, b1, b2;
  int image;     // bytes staged from the image
  int dig, res;  // the digit planes and the residue tile
  int io_rows;   // rows of the output tile: max(nch_lo, n_hi)
  int cols;      // the block's columns, C
  int io;        // the output tile, io_rows x (C + 1) int32
  int smem;      // the block's dynamic shared memory
};
constexpr int kLayoutFields = 27;
static_assert(sizeof(Layout) == 4 * kLayoutFields, "Layout: int32 fields");

// This lane's moduli in the MRC mapping (slot k, lane l: r = 32k + l is
// channel rows - 1 - r); padding gets m = 1 (every reduction gives 0).
struct Moduli {
  int lo[kSlots];
  float rlo[kSlots];
  int hi[kSlots];
  float rhi[kSlots];
};

__device__ __forceinline__ void load_moduli(Moduli& md,
                                            const unsigned char* image,
                                            const Layout& L, int lane) {
  rns::load_moduli<kSlots>(md.lo, md.rlo,
                           reinterpret_cast<const int*>(image + L.m_lo), L.n,
                           lane);
  rns::load_moduli<kSlots>(md.hi, md.rhi,
                           reinterpret_cast<const int*>(image + L.m_hi),
                           L.n_hi, lane);
}

// One output tile of the block, stored coalesced: each warp puts its
// column's `rows` values (in channel order, or in the MRC mapping when
// `rev`) into column `warp` of the shared tile io[c][C + 1], and the block
// then writes row by row, neighbouring threads on neighbouring columns.
// Every warp of the block calls it (two barriers); columns past B are not
// stored.
template <int C>
__device__ __forceinline__ void store_tile(int* __restrict__ p,
                                           const int (&v)[kSlots], int rows,
                                           bool rev, int64_t B, int64_t col0,
                                           int* io, int warp, int lane) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int idx = 32 * k + lane;
    if (idx < rows) io[(rev ? rows - 1 - idx : idx) * (C + 1) + warp] = v[k];
  }
  __syncthreads();
  const int cols = (B - col0 < C) ? (int)(B - col0) : C;
  for (int e = threadIdx.x; e < rows * C; e += 32 * C) {
    const int c = e / C, i = e % C;
    if (i < cols) p[(int64_t)c * B + col0 + i] = io[c * (C + 1) + i];
  }
  __syncthreads();
}

// The warp's digits into its row of the two byte planes: digit c at byte
// c, zeros from `rows` to the dot's depth kp.
__device__ __forceinline__ void put_digits(const int (&w)[kSlots],
                                           unsigned char* dlo,
                                           unsigned char* dhi, int rows,
                                           int kp, int lane) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = 32 * k + lane;
    if (r < rows) {
      dlo[rows - 1 - r] = (unsigned char)(w[k] & 0xff);
      dhi[rows - 1 - r] = (unsigned char)(w[k] >> 8);
    } else if (r < kp) {
      dlo[r] = 0;
      dhi[r] = 0;
    }
  }
}

__device__ __forceinline__ unsigned ld32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// c += a . b on one 16 x 8 x 32 tile: u8 x u8 products summed in s32.
__device__ __forceinline__ void mma_u8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// res[col][t] = sum_j d[col][j] * beta[t][j] mod m_t for the block's C
// columns and the nt (padded) targets; tab holds the low plane then the
// high plane, nt rows of stride st each.  Fragment layouts as the PTX ISA
// gives them for m16n8k32 with 8-bit operands: lane = 4g + q; A: rows g
// and g + 8, bytes 4q..4q+3 and 16 + 4q..; B: target g, the same bytes;
// C: rows g and g + 8, targets 2q and 2q + 1.
template <int C>
__device__ __forceinline__ void dot_mma(const unsigned char* dig, int sd,
                                        const unsigned char* tab, int st,
                                        int kp, int nt, const int* m,
                                        const unsigned* mu, int* res, int rs,
                                        int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const unsigned char* al_p = dig + g * sd + 4 * q;
  const unsigned char* ah_p = al_p + kRows * sd;
  for (int tile = warp; tile < nt / 8; tile += C) {
    int acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][e] = 0;
    }
    const unsigned char* bl_p = tab + (8 * tile + g) * st + 4 * q;
    const unsigned char* bh_p = bl_p + nt * st;
    for (int k0 = 0; k0 < kp; k0 += 32) {
      const unsigned al[4] = {ld32(al_p + k0), ld32(al_p + 8 * sd + k0),
                              ld32(al_p + k0 + 16),
                              ld32(al_p + 8 * sd + k0 + 16)};
      const unsigned ah[4] = {ld32(ah_p + k0), ld32(ah_p + 8 * sd + k0),
                              ld32(ah_p + k0 + 16),
                              ld32(ah_p + 8 * sd + k0 + 16)};
      const unsigned bl[2] = {ld32(bl_p + k0), ld32(bl_p + k0 + 16)};
      const unsigned bh[2] = {ld32(bh_p + k0), ld32(bh_p + k0 + 16)};
      mma_u8(acc[0], al, bl);
      mma_u8(acc[1], al, bh);
      mma_u8(acc[2], ah, bl);
      mma_u8(acc[3], ah, bh);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1);
      const int t = 8 * tile + 2 * q + (e & 1);
      if (row < C) {
        const int mt = m[t];
        const unsigned u = mu[t];
        unsigned v = (unsigned)rns::mod_mulhi((unsigned)acc[3][e], mt, u);
        v = (unsigned)rns::mod_mulhi(
            (v << 8) + (unsigned)acc[1][e] + (unsigned)acc[2][e], mt, u);
        v = (unsigned)rns::mod_mulhi((v << 8) + (unsigned)acc[0][e], mt, u);
        res[row * rs + t] = (int)v;
      }
    }
  }
}

// Pointers into the block's shared memory.
struct Smem {
  const int* m_lo;
  const unsigned* mu_lo;
  const int* m_hi;
  const unsigned* mu_hi;
  const int* minv;
  const unsigned short* tri_lo;
  const unsigned short* tri_hi;
  const unsigned char* b1;
  const unsigned char* b2;
  unsigned char* dig;
  int* res;
};

__device__ __forceinline__ Smem smem_ptrs(unsigned char* s, const Layout& L) {
  return Smem{reinterpret_cast<const int*>(s + L.m_lo),
              reinterpret_cast<const unsigned*>(s + L.mu_lo),
              reinterpret_cast<const int*>(s + L.m_hi),
              reinterpret_cast<const unsigned*>(s + L.mu_hi),
              reinterpret_cast<const int*>(s + L.minv),
              reinterpret_cast<const unsigned short*>(s + L.tri_lo),
              reinterpret_cast<const unsigned short*>(s + L.tri_hi),
              s + L.b1,
              s + L.b2,
              s + L.dig,
              reinterpret_cast<int*>(s + L.res)};
}

// Start the copy of the image into shared memory (16 bytes a cp.async) and
// zero the digit planes; stage_wait() completes it for the whole block.
__device__ __forceinline__ void stage_start(unsigned char* s,
                                            const unsigned char* image,
                                            const Layout& L) {
  for (int o = 16 * threadIdx.x; o < L.image; o += 16 * blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s + o);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(image + o)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int o = 4 * threadIdx.x; o < 2 * kRows * L.sd; o += 4 * blockDim.x) {
    *reinterpret_cast<unsigned*>(s + L.dig + o) = 0u;
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// One Montgomery product MM(x, y) on the warp's column: lo operands in the
// MRC mapping over the n base channels, hi operands in the MRC mapping
// over n_hi.  Out: olo in channel order (c = 32k + lane, nch_lo channels),
// ohi in the MRC mapping.  Every warp of the block calls it together.
template <int C>
__device__ __forceinline__ void mont_mul_block(
    const int (&xl)[kSlots], const int (&xh)[kSlots],
    const int (&yl)[kSlots], const int (&yh)[kSlots],
    const int (&ng)[kSlots], const int (&nh)[kSlots], const Moduli& md,
    const Smem& sm, const Layout& L, int (&olo)[kSlots],
    int (&ohi)[kSlots], int warp, int lane) {
  unsigned char* dlo = sm.dig + warp * L.sd;
  unsigned char* dhi = dlo + kRows * L.sd;
  int* own = sm.res + warp * L.rs;
  int w[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int p = rns::barrett_mod(xl[k] * yl[k], md.lo[k], md.rlo[k]);
    w[k] = rns::barrett_mod(p * ng[k], md.lo[k], md.rlo[k]);
  }
  rns::mrc_warp<kSlots>(w, md.lo, md.rlo, sm.tri_lo, L.n, lane);
  put_digits(w, dlo, dhi, L.n, L.k1, lane);
  __syncthreads();
  dot_mma<C>(sm.dig, L.sd, sm.b1, L.s1, L.k1, L.nt1, sm.m_hi, sm.mu_hi,
             sm.res, L.rs, warp, lane);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = 32 * k + lane;
    const int qp = (r < L.n_hi) ? own[L.n_hi - 1 - r] : 0;
    const int minv = (r < L.n_hi) ? sm.minv[L.n_hi - 1 - r] : 0;
    int t = rns::barrett_mod(xh[k] * yh[k], md.hi[k], md.rhi[k]) +
            rns::barrett_mod(qp * nh[k], md.hi[k], md.rhi[k]);
    t -= (t >= md.hi[k]) ? md.hi[k] : 0;
    ohi[k] = rns::barrett_mod(t * minv, md.hi[k], md.rhi[k]);
    w[k] = ohi[k];  // the B' MRC works on a copy: r' is an output
  }
  rns::mrc_warp<kSlots>(w, md.hi, md.rhi, sm.tri_hi, L.n_hi, lane);
  put_digits(w, dlo, dhi, L.n_hi, L.k2, lane);
  __syncthreads();
  dot_mma<C>(sm.dig, L.sd, sm.b2, L.s2, L.k2, L.nt2, sm.m_lo, sm.mu_lo,
             sm.res, L.rs, warp, lane);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = 32 * k + lane;
    olo[k] = (c < L.nch_lo) ? own[c] : 0;
  }
}

// mask ? b : a, for a mask of all ones or all zeros: no branch, no
// data-dependent address.
__device__ __forceinline__ int pick(int a, int b, int mask) {
  return a ^ ((a ^ b) & mask);
}

template <int C>
__global__ void __launch_bounds__(32 * C)
mont_mul_kernel(const int* __restrict__ xlo, const int* __restrict__ xhi,
                const int* __restrict__ ylo, const int* __restrict__ yhi,
                const int* __restrict__ neg, const int* __restrict__ nhi,
                int* __restrict__ olo, int* __restrict__ ohi,
                const unsigned char* __restrict__ image, const Layout L,
                int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  stage_start(smem, image, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col = (int64_t)blockIdx.x * C + warp;
  const int64_t cc = (col < B) ? col : B - 1;  // past the end: a copy

  Moduli md;
  load_moduli(md, image, L, lane);
  int xl[kSlots], xh[kSlots], yl[kSlots], yh[kSlots], ng[kSlots], nh[kSlots];
  rns::load_rev<kSlots>(xl, xlo, L.n, 1, B, cc, lane);
  rns::load_rev<kSlots>(xh, xhi, L.n_hi, 1, B, cc, lane);
  rns::load_rev<kSlots>(yl, ylo, L.n, 1, B, cc, lane);
  rns::load_rev<kSlots>(yh, yhi, L.n_hi, 1, B, cc, lane);
  rns::load_rev<kSlots>(ng, neg, L.n, 1, B, cc, lane);
  rns::load_rev<kSlots>(nh, nhi, L.n_hi, 1, B, cc, lane);
  const Smem sm = smem_ptrs(smem, L);
  stage_wait();

  int ol[kSlots], oh[kSlots];
  mont_mul_block<C>(xl, xh, yl, yh, ng, nh, md, sm, L, ol, oh, warp, lane);
  const int64_t col0 = (int64_t)blockIdx.x * C;
  int* io = reinterpret_cast<int*>(smem + L.io);
  store_tile<C>(olo, ol, L.nch_lo, false, B, col0, io, warp, lane);
  store_tile<C>(ohi, oh, L.n_hi, true, B, col0, io, warp, lane);
}

template <int C>
__global__ void __launch_bounds__(32 * C)
mont_ladder_kernel(const int* __restrict__ r0lo, const int* __restrict__ r0hi,
                   const int* __restrict__ r1lo, const int* __restrict__ r1hi,
                   const int* __restrict__ bit, const int* __restrict__ neg,
                   const int* __restrict__ nhi, int* __restrict__ o0lo,
                   int* __restrict__ o0hi, int* __restrict__ o1lo,
                   int* __restrict__ o1hi,
                   const unsigned char* __restrict__ image, const Layout L,
                   int64_t B) {
  extern __shared__ __align__(16) unsigned char smem[];
  stage_start(smem, image, L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col = (int64_t)blockIdx.x * C + warp;
  const int64_t cc = (col < B) ? col : B - 1;

  Moduli md;
  load_moduli(md, image, L, lane);
  int al[kSlots], ah[kSlots], bl[kSlots], bh[kSlots], ng[kSlots], nh[kSlots];
  rns::load_rev<kSlots>(al, r0lo, L.n, 1, B, cc, lane);
  rns::load_rev<kSlots>(ah, r0hi, L.n_hi, 1, B, cc, lane);
  rns::load_rev<kSlots>(bl, r1lo, L.n, 1, B, cc, lane);
  rns::load_rev<kSlots>(bh, r1hi, L.n_hi, 1, B, cc, lane);
  rns::load_rev<kSlots>(ng, neg, L.n, 1, B, cc, lane);
  rns::load_rev<kSlots>(nh, nhi, L.n_hi, 1, B, cc, lane);
  const int mask = -(int)(bit[cc] != 0);  // all ones where the bit is set
  const Smem sm = smem_ptrs(smem, L);
  stage_wait();

  int tl[kSlots], th[kSlots];
  mont_mul_block<C>(al, ah, bl, bh, ng, nh, md, sm, L, tl, th, warp, lane);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {  // the square's operand: r_bit
    al[k] = pick(al[k], bl[k], mask);
    ah[k] = pick(ah[k], bh[k], mask);
  }
  int sl[kSlots], sh[kSlots];
  mont_mul_block<C>(al, ah, al, ah, ng, nh, md, sm, L, sl, sh, warp, lane);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {  // bit 0: (s, t); bit 1: (t, s)
    al[k] = pick(sl[k], tl[k], mask);
    ah[k] = pick(sh[k], th[k], mask);
    bl[k] = pick(tl[k], sl[k], mask);
    bh[k] = pick(th[k], sh[k], mask);
  }
  const int64_t col0 = (int64_t)blockIdx.x * C;
  int* io = reinterpret_cast<int*>(smem + L.io);
  store_tile<C>(o0lo, al, L.nch_lo, false, B, col0, io, warp, lane);
  store_tile<C>(o0hi, ah, L.n_hi, true, B, col0, io, warp, lane);
  store_tile<C>(o1lo, bl, L.nch_lo, false, B, col0, io, warp, lane);
  store_tile<C>(o1hi, bh, L.n_hi, true, B, col0, io, warp, lane);
}

// 0, or the error for a layout the kernels do not take.
int check(const Layout& L, int64_t B) {
  if (L.n < 1 || L.nch_lo < L.n || L.n_hi < 1 || B < 1 ||
      L.nch_lo > kMaxChannels || L.n_hi > kMaxChannels ||
      (L.cols != 8 && L.cols != 16) || L.smem > rns::kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Lets every instance take up to kMaxSmem of dynamic shared memory: once a
// device, not once a launch.
int allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return 0;
  for (const void* k : {(const void*)mont_mul_kernel<8>,
                        (const void*)mont_mul_kernel<16>,
                        (const void*)mont_ladder_kernel<8>,
                        (const void*)mont_ladder_kernel<16>}) {
    if (cudaError_t err = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, rns::kMaxSmem)) {
      return (int)err;
    }
  }
  done.fetch_or(bit);
  return 0;
}

// 0, or the error that keeps a launch with this layout from running.
int prepare(const Layout& L, int64_t B) {
  if (int err = check(L, B)) return err;
  return allow_smem();
}

}  // namespace

extern "C" int rns_mont_mul(const int* xlo, const int* xhi, const int* ylo,
                            const int* yhi, const int* neg, const int* nhi,
                            int* olo, int* ohi, const void* image,
                            const int* layout, int64_t B, void* stream) {
  Layout L;
  std::memcpy(&L, layout, sizeof L);
  if (int err = prepare(L, B)) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* img = (const unsigned char*)image;
  const unsigned blocks = (unsigned)((B + L.cols - 1) / L.cols);
  if (L.cols == 16) {
    mont_mul_kernel<16><<<blocks, 32 * 16, L.smem, s>>>(
        xlo, xhi, ylo, yhi, neg, nhi, olo, ohi, img, L, B);
  } else {
    mont_mul_kernel<8><<<blocks, 32 * 8, L.smem, s>>>(
        xlo, xhi, ylo, yhi, neg, nhi, olo, ohi, img, L, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int rns_mont_ladder(const int* r0lo, const int* r0hi,
                               const int* r1lo, const int* r1hi,
                               const int* bit, const int* neg, const int* nhi,
                               int* o0lo, int* o0hi, int* o1lo, int* o1hi,
                               const void* image, const int* layout,
                               int64_t B, void* stream) {
  Layout L;
  std::memcpy(&L, layout, sizeof L);
  if (int err = prepare(L, B)) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* img = (const unsigned char*)image;
  const unsigned blocks = (unsigned)((B + L.cols - 1) / L.cols);
  if (L.cols == 16) {
    mont_ladder_kernel<16><<<blocks, 32 * 16, L.smem, s>>>(
        r0lo, r0hi, r1lo, r1hi, bit, neg, nhi, o0lo, o0hi, o1lo, o1hi, img, L,
        B);
  } else {
    mont_ladder_kernel<8><<<blocks, 32 * 8, L.smem, s>>>(
        r0lo, r0hi, r1lo, r1hi, bit, neg, nhi, o0lo, o0hi, o1lo, o1hi, img, L,
        B);
  }
  return (int)cudaGetLastError();
}
