// The SSD core of Mamba2 and Zamba2 (arXiv:2405.21060, sections 6-7),
// forward and backward, in f32 for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's ssd (src/repro/models/ssm.py) is
// plain jnp, and so is the port's CPU path (models/ssm.py::ssd).  On the card
// it takes the place of that body's some 40 forward and 190 backward
// operations a call: the (b, c, h, Q, Q) within-chunk weight never reaches
// device memory, and the scan between chunks is one kernel.
//
// In (kernels/ssd.py checks the shapes): x (b, s, h, p); dt (b, s, h); A
// (h); B, C (b, s, G, ds), group g read by heads g hg .. (g + 1) hg - 1
// (hg = h / G); chunks of Q <= 256 positions, nc = s / Q of them; the
// initial state (b, h, ds, p) or none.  Out: y (b, s, h, p) without the D
// skip, the final state (b, h, ds, p); the backward's gradients in the
// inputs' shapes.  The kernels' own buffers: cum (b, nc, h, QT), the
// within-chunk cumulative decay (QT: Q rounded up to the 64 tile); S (b, nc,
// h, ds, p), the chunk states, then the state entering each chunk; CB (b,
// nc, G, QT, QT), C B^T on and below the diagonal tiles; yoff (b, s, h, p),
// y's term from the earlier chunks, whose product with dy is dcum's.
//
// What bounds it: f32 FFMA.  A mamba2-370m layer (8 x 2,048, 32 heads of
// 64, ds 128, Q 256) is 2.6e10 FLOPs forward and 5.3e10 backward, against
// 67 TFLOP/s; its bytes, some 0.6 GB in all, take a tenth of that time.
//
// Design: every product is a 64 x 64 output tile of a 128-thread block, 4 x 8
// outputs a thread, summed over 64-deep slices staged in shared memory
// (stage_rows, stage_cols).  The elementwise factors (the decay, dt, the
// causal mask) are applied as a slice is staged, so the weight
// W[q][k] = CB[q][k] exp(cum_q - cum_k) dt_k lives only in a slice, and
// tiles above the diagonal are never visited.  Every exp is of a
// non-positive difference (cum_q - cum_k for k <= q, cum_last - cum_k,
// cum_q): finite wherever the decay within a chunk passes 88.7.  expf, never
// __expf; the library is never built with --use_fast_math.  Each sum is
// owned by one block and written once: the results do not depend on the
// order the blocks run in.
//
// ssd_forward, 4 launches: chunk_state (cum; S_c = B^T (w x), w_k =
// exp(cum_last - cum_k) dt_k), state_pass (S entering each chunk, the final
// state), cb (C B^T a group), scan (y = exp(cum_q) C_q S + W x).
// ssd_backward, 6 launches: chunk_state (dS = C^T (exp(cum) dy)), state_pass
// reversed (each chunk state's gradient, its decay's, the initial state's),
// dcb (dCB summed over a group's heads; the diagonal's decay terms), dx, dbc
// (dB and dC summed over a group's heads), final (dcum -> ddt, dA).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // tile edge
constexpr int kLd = kT + 4;     // a staged row, 16-byte aligned
constexpr int kThreads = 128;   // a tile's block: 16 x 8 threads
constexpr int kMaxQ = 256;      // longest chunk: 8 positions a lane
constexpr int kPass = 256;      // state_pass: a float4 of the state a thread
constexpr unsigned kAll = 0xffffffffu;

struct Dims {
  int b, s, h, p, G, ds, Q, nc, QT, hg;
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Column j of thread tx's 4 x 8 outputs: two runs of four, 32 apart.
__device__ __forceinline__ int col(int tx, int j) {
  return (j < 4 ? 0 : 28) + tx * 4 + j;
}

struct Id {
  __device__ __forceinline__ float operator()(int, int, float v) const {
    return v;
  }
};

// acc[i][j] += sum_r As[r][ty 4 + i] Bs[r][col(tx, j)] over a 64-deep slice.
__device__ __forceinline__ void mma(float (&acc)[4][8], const float* As,
                                    const float* Bs, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < kT; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(As + r * kLd + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + r * kLd + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + r * kLd + 32 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// s[r][m] = f(r, m, g[r ld + m]) for r < rn, m < mn, else 0: the summed
// index r runs along g's rows.  mn and ld are multiples of 4 and g is
// 16-byte aligned; f is called on valid (r, m) only.
template <class F>
__device__ __forceinline__ void stage_rows(float* s, const float* g, long ld,
                                           int rn, int mn, F f) {
  for (int slot = threadIdx.x; slot < kT * kT / 4; slot += kThreads) {
    const int r = slot >> 4, m = (slot & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rn && m < mn) {
      v = *reinterpret_cast<const float4*>(g + r * ld + m);
      v.x = f(r, m, v.x);
      v.y = f(r, m + 1, v.y);
      v.z = f(r, m + 2, v.z);
      v.w = f(r, m + 3, v.w);
    }
    *reinterpret_cast<float4*>(s + r * kLd + m) = v;
  }
}

// s[r][m] = f(r, m, g[m ld + r]) for r < rn, m < mn, else 0: the summed
// index r runs along g's columns (a slice transposed as it is staged).  rn
// and ld are multiples of 4; neighbouring threads take neighbouring m, so
// the stores into s do not conflict.
template <class F>
__device__ __forceinline__ void stage_cols(float* s, const float* g, long ld,
                                           int rn, int mn, F f) {
  for (int slot = threadIdx.x; slot < kT * kT / 4; slot += kThreads) {
    const int m = slot & (kT - 1), r = (slot >> 6) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rn && m < mn) {
      v = *reinterpret_cast<const float4*>(g + m * ld + r);
      v.x = f(r, m, v.x);
      v.y = f(r + 1, m, v.y);
      v.z = f(r + 2, m, v.z);
      v.w = f(r + 3, m, v.w);
    }
    s[r * kLd + m] = v.x;
    s[(r + 1) * kLd + m] = v.y;
    s[(r + 2) * kLd + m] = v.z;
    s[(r + 3) * kLd + m] = v.w;
  }
}

// o[(ty 4 + i) ld + col(tx, j)] = acc[i][j] for rows < rn, columns < cn (a
// multiple of 4).
__device__ __forceinline__ void store_tile(float* o, long ld, int rn, int cn,
                                           const float (&acc)[4][8], int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rn) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 32 + tx * 4;
      if (c < cn) {
        *reinterpret_cast<float4*>(o + r * ld + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// The sum over the 8 threads (one ty) that share a tile's rows.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kAll, v, 1);
  v += __shfl_xor_sync(kAll, v, 2);
  v += __shfl_xor_sync(kAll, v, 4);
  return v;
}

// The block's sum of v, in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free from the last call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  }
  return t;
}

// cs[t] = sum_{u <= t} dt_u A for t < Q, by warp 0: 8 positions a lane in
// order, then a scan of the lanes' totals.
__device__ void chunk_cumsum(float* cs, const float* dth, long ldh, float A,
                             int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, per = (Q + 31) / 32;
  float v[8], run = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = lane * per + j;
    if (j < per && t < Q) run += dth[t * ldh] * A;
    v[j] = run;
  }
  float tot = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kAll, tot, o);
    if (lane >= o) tot += n;
  }
  float before = __shfl_up_sync(kAll, tot, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = lane * per + j;
    if (j < per && t < Q) cs[t] = before + v[j];
  }
}

// The tile pair (qt, kt), kt <= qt, of a lower-triangle index.
__device__ __forceinline__ void tile_pair(int i, int& qt, int& kt) {
  qt = 0;
  while (i > qt) {
    i -= qt + 1;
    ++qt;
  }
  kt = i;
}

// A chunk's cum and dt: cs[t], dts[t] for t < Q.
__device__ __forceinline__ void load_chunk(float* cs, float* dts,
                                           const float* cumh,
                                           const float* dth, const Dims& d) {
  for (int t = threadIdx.x; t < d.Q; t += blockDim.x) {
    cs[t] = cumh[t];
    dts[t] = dth[(long)t * d.h];
  }
}

// mode 0: cum, and S_c[n][p] = sum_t B_t[n] w_t x_t[p], w_t = exp(cum_last -
// cum_t) dt_t.  mode 1: dS[n][p] = sum_t C_t[n] exp(cum_t) dy_t[p], reading
// cum.  U is B or C, V is x or dy.  grid (h, ds tiles, b nc).
__global__ void __launch_bounds__(kThreads)
    chunk_state_kernel(const float* __restrict__ U,
                       const float* __restrict__ V,
                       const float* __restrict__ dt,
                       const float* __restrict__ A, float* __restrict__ cum,
                       float* __restrict__ out, Dims d, int mode) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float cs[kMaxQ], sc[kMaxQ];
  const int hh = blockIdx.x, n0 = blockIdx.y * kT;
  const int b = blockIdx.z / d.nc, c = blockIdx.z % d.nc, g = hh / d.hg;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const long row0 = (long)b * d.s + (long)c * d.Q;
  const long bch = (long)blockIdx.z * d.h + hh;
  const float* dth = dt + row0 * d.h + hh;
  float* cumh = cum + bch * d.QT;
  if (mode == 0) {
    chunk_cumsum(cs, dth, d.h, A[hh], d.Q);
    __syncthreads();
    if (blockIdx.y == 0) {
      for (int t = threadIdx.x; t < d.Q; t += kThreads) cumh[t] = cs[t];
    }
  } else {
    for (int t = threadIdx.x; t < d.Q; t += kThreads) cs[t] = cumh[t];
    __syncthreads();
  }
  const float last = cs[d.Q - 1];
  for (int t = threadIdx.x; t < d.Q; t += kThreads) {
    sc[t] = mode == 0 ? expf(last - cs[t]) * dth[(long)t * d.h]
                      : expf(cs[t]);
  }
  const long ldu = (long)d.G * d.ds, ldv = (long)d.h * d.p;
  const float* Ug = U + row0 * ldu + (long)g * d.ds + n0;
  const float* Vg = V + row0 * ldv + (long)hh * d.p;
  const int nn = imin(kT, d.ds - n0);
  float acc[4][8] = {};
  for (int t0 = 0; t0 < d.Q; t0 += kT) {
    __syncthreads();
    const int tn = imin(kT, d.Q - t0);
    stage_rows(As, Ug + t0 * ldu, ldu, tn, nn, Id());
    stage_rows(Bs, Vg + t0 * ldv, ldv, tn, d.p,
               [&](int r, int, float v) { return v * sc[t0 + r]; });
    __syncthreads();
    mma(acc, As, Bs, ty, tx);
  }
  store_tile(out + bch * d.ds * d.p + (long)n0 * d.p, d.p, nn, d.p, acc, ty,
             tx);
}

// Forward: buf holds S_c and is overwritten with the state entering each
// chunk, S = exp(cum_last) S + S_c chunk by chunk from s0 (or zeros); s_end
// gets the final state.  Reverse: buf holds dS and is overwritten with the
// gradient of each chunk's S_c, g = exp(cum_last) g + dS from the last
// chunk back, from s0 (the final state's gradient, or zeros); dtpart gets
// each block's part of <g, S entering the chunk> (the decay's gradient);
// s_end gets the initial state's gradient.  grid (ds p / 1024, h, b).
__global__ void __launch_bounds__(kPass)
    state_pass_kernel(float* __restrict__ buf, const float* __restrict__ cum,
                      const float* __restrict__ sprev,
                      const float* __restrict__ s0, float* __restrict__ s_end,
                      float* __restrict__ dtpart, Dims d, int reverse) {
  __shared__ float red[kPass / 32];
  const int hh = blockIdx.y, b = blockIdx.z;
  const long dsp = (long)d.ds * d.p;
  const long e = ((long)blockIdx.x * kPass + threadIdx.x) * 4;
  const bool on = e < dsp;
  const long state = ((long)b * d.h + hh) * dsp + e;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  if (on && s0 != nullptr) S = *reinterpret_cast<const float4*>(s0 + state);
  // Chunk i + 1's decay and values are loaded before chunk i is written.
  long next = ((long)b * d.nc + (reverse ? d.nc - 1 : 0)) * d.h + hh;
  float Tn = expf(cum[next * d.QT + d.Q - 1]);
  float4 inn = make_float4(0.f, 0.f, 0.f, 0.f), spn = inn;
  if (on) inn = *reinterpret_cast<const float4*>(buf + next * dsp + e);
  if (on && reverse) spn = *reinterpret_cast<const float4*>(sprev + next * dsp + e);
  for (int i = 0; i < d.nc; ++i) {
    const long bch = next;
    const float T = Tn;
    const float4 in = inn, sp = spn;
    if (i + 1 < d.nc) {
      next = ((long)b * d.nc + (reverse ? d.nc - 2 - i : i + 1)) * d.h + hh;
      Tn = expf(cum[next * d.QT + d.Q - 1]);
      if (on) inn = *reinterpret_cast<const float4*>(buf + next * dsp + e);
      if (on && reverse) {
        spn = *reinterpret_cast<const float4*>(sprev + next * dsp + e);
      }
    }
    if (on) *reinterpret_cast<float4*>(buf + bch * dsp + e) = S;
    if (reverse) {
      float part = on ? S.x * sp.x + S.y * sp.y + S.z * sp.z + S.w * sp.w
                      : 0.f;
      part = block_sum(part, red);
      if (threadIdx.x == 0) dtpart[bch * gridDim.x + blockIdx.x] = part;
    }
    S.x = S.x * T + in.x;
    S.y = S.y * T + in.y;
    S.z = S.z * T + in.z;
    S.w = S.w * T + in.w;
  }
  if (on && s_end != nullptr) *reinterpret_cast<float4*>(s_end + state) = S;
}

// CB[q][k] = C_q . B_k over ds, a tile on or below the diagonal.
// grid (tile pairs, 1, b nc G).
__global__ void __launch_bounds__(kThreads)
    cb_kernel(const float* __restrict__ B, const float* __restrict__ C,
              float* __restrict__ CB, Dims d) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  int qt, kt;
  tile_pair(blockIdx.x, qt, kt);
  const int bcg = blockIdx.z, g = bcg % d.G, bc = bcg / d.G;
  const int b = bc / d.nc, c = bc % d.nc;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const long row0 = (long)b * d.s + (long)c * d.Q, ld = (long)d.G * d.ds;
  const int q0 = qt * kT, k0 = kt * kT;
  const int qn = imin(kT, d.Q - q0), kn = imin(kT, d.Q - k0);
  const float* Cg = C + (row0 + q0) * ld + (long)g * d.ds;
  const float* Bg = B + (row0 + k0) * ld + (long)g * d.ds;
  float acc[4][8] = {};
  for (int n0 = 0; n0 < d.ds; n0 += kT) {
    __syncthreads();
    const int nn = imin(kT, d.ds - n0);
    stage_cols(As, Cg + n0, ld, nn, qn, Id());
    stage_cols(Bs, Bg + n0, ld, nn, kn, Id());
    __syncthreads();
    mma(acc, As, Bs, ty, tx);
  }
  store_tile(CB + (long)bcg * d.QT * d.QT + (long)q0 * d.QT + k0, d.QT, kT,
             kT, acc, ty, tx);
}

// y[q] = exp(cum_q) C_q S + sum_{k <= q} CB[q][k] exp(cum_q - cum_k) dt_k x_k,
// S the state entering the chunk; yoff (unless null) gets the first term,
// which the backward's dx_kernel reads.  grid (h, q tiles, b nc).
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ C, const float* __restrict__ cum,
                const float* __restrict__ S, const float* __restrict__ CB,
                float* __restrict__ y, float* __restrict__ yoff, Dims d) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float cs[kMaxQ], dts[kMaxQ];
  const int hh = blockIdx.x, qt = blockIdx.y, bc = blockIdx.z;
  const int b = bc / d.nc, c = bc % d.nc, g = hh / d.hg;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const long row0 = (long)b * d.s + (long)c * d.Q;
  const long bch = (long)bc * d.h + hh;
  const long ldx = (long)d.h * d.p, ldc = (long)d.G * d.ds;
  const int q0 = qt * kT, qn = imin(kT, d.Q - q0);
  load_chunk(cs, dts, cum + bch * d.QT, dt + row0 * d.h + hh, d);
  const float* Cg = C + (row0 + q0) * ldc + (long)g * d.ds;
  const float* Sh = S + bch * d.ds * d.p;
  float acc[4][8] = {};
  for (int n0 = 0; n0 < d.ds; n0 += kT) {
    __syncthreads();
    const int nn = imin(kT, d.ds - n0);
    stage_cols(As, Cg + n0, ldc, nn, qn, Id());
    stage_rows(Bs, Sh + (long)n0 * d.p, d.p, nn, d.p, Id());
    __syncthreads();
    mma(acc, As, Bs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    const float e = q < d.Q ? expf(cs[q]) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= e;
  }
  if (yoff != nullptr) {
    store_tile(yoff + (row0 + q0) * ldx + (long)hh * d.p, ldx, qn, d.p, acc,
               ty, tx);
  }
  const float* CBq = CB + ((long)bc * d.G + g) * d.QT * d.QT + (long)q0 * d.QT;
  const float* xh = x + row0 * ldx + (long)hh * d.p;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    stage_cols(As, CBq + k0, d.QT, kT, qn, [&](int r, int m, float v) {
      const int q = q0 + m, k = k0 + r;
      return k <= q ? v * expf(cs[q] - cs[k]) * dts[k] : 0.f;
    });
    stage_rows(Bs, xh + k0 * ldx, ldx, imin(kT, d.Q - k0), d.p, Id());
    __syncthreads();
    mma(acc, As, Bs, ty, tx);
  }
  store_tile(y + (row0 + q0) * ldx + (long)hh * d.p, ldx, qn, d.p, acc, ty,
             tx);
}

// For the tile (q, k) on or below the diagonal, over a group's heads:
// dM = dy_q . x_k and, for k <= q, L = exp(cum_q - cum_k), v = dM CB L;
// dCB += dM L dt_k, summed over the heads and written once; each head's
// colpart[q tile][k] = sum_q v (ddt_k's diagonal term; dcum_k takes -dt_k
// of it) and rowpart[k tile][q] = sum_k v dt_k (dcum_q's diagonal term).
// grid (tile pairs, 1, b nc G).
__global__ void __launch_bounds__(kThreads)
    dcb_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ dy, const float* __restrict__ cum,
               const float* __restrict__ CB, float* __restrict__ dCB,
               float* __restrict__ rowpart, float* __restrict__ colpart,
               Dims d) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float cs[kMaxQ], dts[kMaxQ], red[16 * kT];
  int qt, kt;
  tile_pair(blockIdx.x, qt, kt);
  const int bcg = blockIdx.z, g = bcg % d.G, bc = bcg / d.G;
  const int b = bc / d.nc, c = bc % d.nc, nt = d.QT / kT;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const long row0 = (long)b * d.s + (long)c * d.Q;
  const long ldx = (long)d.h * d.p;
  const int q0 = qt * kT, k0 = kt * kT;
  const int qn = imin(kT, d.Q - q0), kn = imin(kT, d.Q - k0);
  const float* CBt = CB + (long)bcg * d.QT * d.QT + (long)q0 * d.QT + k0;
  float cbv[4][8];  // the tile of CB, the same for every head
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cbv[i][j] = CBt[(ty * 4 + i) * d.QT + col(tx, j)];
    }
  }
  float acc[4][8] = {};
  for (int hl = 0; hl < d.hg; ++hl) {
    const int hh = g * d.hg + hl;
    const long bch = (long)bc * d.h + hh;
    __syncthreads();
    load_chunk(cs, dts, cum + bch * d.QT, dt + row0 * d.h + hh, d);
    stage_cols(As, dy + (row0 + q0) * ldx + (long)hh * d.p, ldx, d.p, qn,
               Id());
    stage_cols(Bs, x + (row0 + k0) * ldx + (long)hh * d.p, ldx, d.p, kn,
               Id());
    __syncthreads();
    float dm[4][8] = {};
    mma(dm, As, Bs, ty, tx);
    float rs[4] = {}, csum[8] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + col(tx, j);
        if (q < d.Q && k <= q) {
          const float L = expf(cs[q] - cs[k]);
          const float v = dm[i][j] * cbv[i][j] * L;
          csum[j] += v;
          rs[i] += v * dts[k];
          acc[i][j] += dm[i][j] * L * dts[k];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float r = row_sum(rs[i]);
      const int q = q0 + ty * 4 + i;
      if (tx == 0 && q < d.Q) rowpart[(bch * nt + kt) * d.QT + q] = r;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[ty * kT + col(tx, j)] = csum[j];
    __syncthreads();
    if (threadIdx.x < kT && k0 + (int)threadIdx.x < d.Q) {
      float s = 0.f;
      for (int w = 0; w < 16; ++w) s += red[w * kT + threadIdx.x];
      colpart[(bch * nt + qt) * d.QT + k0 + threadIdx.x] = s;
    }
  }
  store_tile(dCB + (long)bcg * d.QT * d.QT + (long)q0 * d.QT + k0, d.QT, kT,
             kT, acc, ty, tx);
}

// dx_k = w_k (B_k dS_c) + sum_{q >= k} W[q][k] dy_q, with dS_c the gradient
// of the chunk's state; dw_k = x_k . (B_k dS_c), the gradient of the
// state's weight w_k = exp(cum_last - cum_k) dt_k; off_k = dy_k . yoff_k,
// dcum_k's term from the earlier chunks.  grid (h, k tiles, b nc).
__global__ void __launch_bounds__(kThreads)
    dx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ B, const float* __restrict__ dy,
              const float* __restrict__ yoff, const float* __restrict__ cum,
              const float* __restrict__ dS, const float* __restrict__ CB,
              float* __restrict__ dx, float* __restrict__ dw,
              float* __restrict__ off, Dims d) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float cs[kMaxQ], dts[kMaxQ];
  const int hh = blockIdx.x, kt = blockIdx.y, bc = blockIdx.z;
  const int b = bc / d.nc, c = bc % d.nc, g = hh / d.hg, nt = d.QT / kT;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const long row0 = (long)b * d.s + (long)c * d.Q;
  const long bch = (long)bc * d.h + hh;
  const long ldx = (long)d.h * d.p, ldb = (long)d.G * d.ds;
  const int k0 = kt * kT, kn = imin(kT, d.Q - k0);
  load_chunk(cs, dts, cum + bch * d.QT, dt + row0 * d.h + hh, d);
  const float* Bg = B + (row0 + k0) * ldb + (long)g * d.ds;
  const float* Dh = dS + bch * d.ds * d.p;
  float acc[4][8] = {};
  for (int n0 = 0; n0 < d.ds; n0 += kT) {
    __syncthreads();
    const int nn = imin(kT, d.ds - n0);
    stage_cols(As, Bg + n0, ldb, nn, kn, Id());
    stage_rows(Bs, Dh + (long)n0 * d.p, d.p, nn, d.p, Id());
    __syncthreads();
    mma(acc, As, Bs, ty, tx);
  }
  const float last = cs[d.Q - 1];
  const long tile = (row0 + k0) * ldx + (long)hh * d.p;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, k = k0 + r;
    float part = 0.f, po = 0.f;
    if (k < d.Q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pc = col(tx, j);
        if (pc < d.p) {
          const long at = tile + r * ldx + pc;
          part += x[at] * acc[i][j];
          po += dy[at] * yoff[at];
        }
      }
    }
    part = row_sum(part);
    po = row_sum(po);
    if (tx == 0 && k < d.Q) {
      dw[bch * d.QT + k] = part;
      off[bch * d.QT + k] = po;
    }
    const float w = k < d.Q ? expf(last - cs[k]) * dts[k] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= w;
  }
  const float* CBg = CB + ((long)bc * d.G + g) * d.QT * d.QT;
  const float* dyh = dy + row0 * ldx + (long)hh * d.p;
  for (int qt = kt; qt < nt; ++qt) {
    const int q0 = qt * kT, qn = imin(kT, d.Q - q0);
    __syncthreads();
    stage_rows(As, CBg + (long)q0 * d.QT + k0, d.QT, qn, kT,
               [&](int r, int m, float v) {
                 const int q = q0 + r, k = k0 + m;
                 return k <= q ? v * expf(cs[q] - cs[k]) * dts[k] : 0.f;
               });
    stage_rows(Bs, dyh + q0 * ldx, ldx, qn, d.p, Id());
    __syncthreads();
    mma(acc, As, Bs, ty, tx);
  }
  store_tile(dx + (row0 + k0) * ldx + (long)hh * d.p, ldx, kn, d.p, acc, ty,
             tx);
}

// For a tile of positions t and of ds, over a group's heads:
// dC[q] = sum_heads exp(cum_q) dy_q S^T + sum_{k <= q} dCB[q][k] B_k and
// dB[k] = sum_heads w_k x_k dS_c^T + sum_{q >= k} dCB[q][k] C_q, S the state
// entering the chunk, dS_c the chunk state's gradient.
// grid (ds tiles, position tiles, b nc G).
__global__ void __launch_bounds__(kThreads)
    dbc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ dy, const float* __restrict__ B,
               const float* __restrict__ C, const float* __restrict__ cum,
               const float* __restrict__ S, const float* __restrict__ dS,
               const float* __restrict__ dCB, float* __restrict__ dB,
               float* __restrict__ dC, Dims d) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float es[kT], ws[kT];
  const int n0 = blockIdx.x * kT, t = blockIdx.y, t0 = t * kT;
  const int bcg = blockIdx.z, g = bcg % d.G, bc = bcg / d.G;
  const int b = bc / d.nc, c = bc % d.nc, nt = d.QT / kT;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const long row0 = (long)b * d.s + (long)c * d.Q;
  const long ldx = (long)d.h * d.p, ldb = (long)d.G * d.ds;
  const long dsp = (long)d.ds * d.p;
  const int nn = imin(kT, d.ds - n0), tn = imin(kT, d.Q - t0);
  const float* Bg = B + row0 * ldb + (long)g * d.ds + n0;
  const float* Cg = C + row0 * ldb + (long)g * d.ds + n0;
  float accC[4][8] = {}, accB[4][8] = {};
  for (int hl = 0; hl < d.hg; ++hl) {
    const int hh = g * d.hg + hl;
    const long bch = (long)bc * d.h + hh;
    const long tile = (row0 + t0) * ldx + (long)hh * d.p;
    __syncthreads();
    if ((int)threadIdx.x < tn) {
      const float* cumh = cum + bch * d.QT;
      const float ct = cumh[t0 + threadIdx.x];
      es[threadIdx.x] = expf(ct);
      ws[threadIdx.x] = expf(cumh[d.Q - 1] - ct) *
                        dt[(row0 + t0 + threadIdx.x) * d.h + hh];
    }
    __syncthreads();
    stage_cols(As, dy + tile, ldx, d.p, tn,
               [&](int, int m, float v) { return v * es[m]; });
    stage_cols(Bs, S + bch * dsp + (long)n0 * d.p, d.p, d.p, nn, Id());
    __syncthreads();
    mma(accC, As, Bs, ty, tx);
    __syncthreads();
    stage_cols(As, x + tile, ldx, d.p, tn,
               [&](int, int m, float v) { return v * ws[m]; });
    stage_cols(Bs, dS + bch * dsp + (long)n0 * d.p, d.p, d.p, nn, Id());
    __syncthreads();
    mma(accB, As, Bs, ty, tx);
  }
  const float* dCBg = dCB + (long)bcg * d.QT * d.QT;
  for (int kt = 0; kt <= t; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    stage_cols(As, dCBg + (long)t0 * d.QT + k0, d.QT, kT, tn, Id());
    stage_rows(Bs, Bg + k0 * ldb, ldb, imin(kT, d.Q - k0), nn, Id());
    __syncthreads();
    mma(accC, As, Bs, ty, tx);
  }
  for (int qt = t; qt < nt; ++qt) {
    const int q0 = qt * kT, qn = imin(kT, d.Q - q0);
    __syncthreads();
    stage_rows(As, dCBg + (long)q0 * d.QT + t0, d.QT, qn, kT, Id());
    stage_rows(Bs, Cg + q0 * ldb, ldb, qn, nn, Id());
    __syncthreads();
    mma(accB, As, Bs, ty, tx);
  }
  const long out = (row0 + t0) * ldb + (long)g * d.ds + n0;
  store_tile(dC + out, ldb, tn, nn, accC, ty, tx);
  store_tile(dB + out, ldb, tn, nn, accB, ty, tx);
}

// A warp a (b, c, h): dcum from its parts, da its reverse cumsum within the
// chunk, ddt = (the diagonal's and the state's direct terms) + A da, and
// dA's part sum_t dt_t da_t.  grid (b nc h), 32 threads.
__global__ void __launch_bounds__(32)
    final_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ cum,
                 const float* __restrict__ rowpart,
                 const float* __restrict__ colpart,
                 const float* __restrict__ off,
                 const float* __restrict__ dw,
                 const float* __restrict__ dtpart, float* __restrict__ ddt,
                 float* __restrict__ dApart, Dims d, int npass) {
  const long bch = blockIdx.x;
  const int hh = (int)(bch % d.h);
  const long bc = bch / d.h;
  const int b = (int)(bc / d.nc), c = (int)(bc % d.nc), nt = d.QT / kT;
  const int lane = threadIdx.x, per = (d.Q + 31) / 32;
  const long row0 = (long)b * d.s + (long)c * d.Q;
  const float* cumh = cum + bch * d.QT;
  const float last = cumh[d.Q - 1];
  float dT = 0.f;
  for (int i = 0; i < npass; ++i) dT += dtpart[bch * npass + i];
  float dc[8], dd[8], dtv[8], sw = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = lane * per + j;
    dc[j] = dd[j] = dtv[j] = 0.f;
    if (j < per && t < d.Q) {
      const int jt = t / kT;
      float rs = 0.f, cs = 0.f;
      for (int kt = 0; kt <= jt; ++kt) rs += rowpart[(bch * nt + kt) * d.QT + t];
      for (int qt = jt; qt < nt; ++qt) cs += colpart[(bch * nt + qt) * d.QT + t];
      const float dwt = dw[bch * d.QT + t];
      const float e = expf(last - cumh[t]);
      const float dtt = dt[(row0 + t) * d.h + hh];
      const float w = e * dtt;
      dtv[j] = dtt;
      dc[j] = rs - dtt * cs + off[bch * d.QT + t] - dwt * w;
      dd[j] = cs + dwt * e;
      sw += dwt * w;
    }
  }
  sw = warp_sum(sw);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < per && lane * per + j == d.Q - 1) dc[j] += sw + dT * expf(last);
  }
  float suf[8], run = 0.f;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    run += dc[j];
    suf[j] = run;
  }
  float tot = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_down_sync(kAll, tot, o);
    if (lane + o < 32) tot += n;
  }
  float after = __shfl_down_sync(kAll, tot, 1);
  if (lane == 31) after = 0.f;
  const float Ah = A[hh];
  float dA = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = lane * per + j;
    if (j < per && t < d.Q) {
      const float da = after + suf[j];
      ddt[(row0 + t) * d.h + hh] = dd[j] + Ah * da;
      dA += dtv[j] * da;
    }
  }
  dA = warp_sum(dA);
  if (lane == 0) dApart[bch] = dA;
}

// The shapes the kernels take, or false: Q <= 256 dividing s, p <= 64, p and
// ds multiples of 4, G dividing h, and the grids' limits.
bool make_dims(int b, int s, int h, int p, int G, int ds, int Q, Dims* d) {
  if (b < 1 || s < 1 || h < 1 || p < 4 || p > kT || p % 4 || G < 1 ||
      h % G || ds < 4 || ds % 4 || Q < 1 || Q > kMaxQ || s % Q) {
    return false;
  }
  const long bcg = (long)b * (s / Q) * G;
  if (bcg > 65535 || h > 65535) return false;
  *d = Dims{b, s, h, p, G, ds, Q, s / Q, (Q + kT - 1) / kT * kT, h / G};
  return true;
}

int pass_blocks(const Dims& d) {
  return (int)(((long)d.ds * d.p + 4 * kPass - 1) / (4 * kPass));
}

}  // namespace

// y, the final state, and the forward's buffers cum, S, CB and yoff (null
// when no backward follows; kernels/ssd.py allocates them).  init may be
// null (zeros).
extern "C" int ssd_forward(const float* x, const float* dt, const float* A,
                           const float* B, const float* C, const float* init,
                           float* y, float* final_state, float* cum, float* S,
                           float* CB, float* yoff, int b, int s, int h, int p,
                           int G, int ds, int Q, void* stream) {
  Dims d;
  if (!make_dims(b, s, h, p, G, ds, Q, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = d.QT / kT, nnt = (ds + kT - 1) / kT;
  const int bc = b * d.nc;
  int err;
  chunk_state_kernel<<<dim3(h, nnt, bc), dim3(kThreads), 0, st>>>(B, x, dt, A,
      cum, S, d, 0);
  if ((err = (int)cudaGetLastError())) return err;
  state_pass_kernel<<<dim3(pass_blocks(d), h, b), dim3(kPass), 0, st>>>(S, cum,
      nullptr, init, final_state, nullptr, d, 0);
  if ((err = (int)cudaGetLastError())) return err;
  cb_kernel<<<dim3(nt * (nt + 1) / 2, 1, bc * G), dim3(kThreads), 0, st>>>(B, C,
      CB, d);
  if ((err = (int)cudaGetLastError())) return err;
  scan_kernel<<<dim3(h, nt, bc), dim3(kThreads), 0, st>>>(x, dt, C, cum, S, CB,
      y, yoff, d);
  return (int)cudaGetLastError();
}

// The gradients dx, ddt, dB, dC, dinit (null: not wanted) and dApart (b nc
// h; summed by the caller) from dy, dfinal (null: zeros) and the forward's
// buffers; dS (b nc h ds p), dCB (b nc G QT QT), rowpart, colpart (b nc h
// (QT / 64) QT each), off, dw (b nc h QT each) and dtpart (b nc h
// (ds p / 1024)) are scratch.
extern "C" int ssd_backward(const float* x, const float* dt, const float* A,
                            const float* B, const float* C, const float* dy,
                            const float* dfinal, const float* cum,
                            const float* S, const float* CB,
                            const float* yoff, float* dS, float* dCB,
                            float* rowpart, float* colpart, float* off,
                            float* dw, float* dtpart, float* dApart,
                            float* dx, float* ddt, float* dB, float* dC,
                            float* dinit, int b, int s, int h, int p, int G,
                            int ds, int Q, void* stream) {
  Dims d;
  if (!make_dims(b, s, h, p, G, ds, Q, &d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = d.QT / kT, nnt = (ds + kT - 1) / kT, npass = pass_blocks(d);
  const int bc = b * d.nc;
  int err;
  chunk_state_kernel<<<dim3(h, nnt, bc), dim3(kThreads), 0, st>>>(C, dy, dt, A,
      const_cast<float*>(cum), dS, d, 1);
  if ((err = (int)cudaGetLastError())) return err;
  state_pass_kernel<<<dim3(npass, h, b), dim3(kPass), 0, st>>>(dS, cum, S,
      dfinal, dinit, dtpart, d, 1);
  if ((err = (int)cudaGetLastError())) return err;
  dcb_kernel<<<dim3(nt * (nt + 1) / 2, 1, bc * G), dim3(kThreads), 0, st>>>(x,
      dt, dy, cum, CB, dCB, rowpart, colpart, d);
  if ((err = (int)cudaGetLastError())) return err;
  dx_kernel<<<dim3(h, nt, bc), dim3(kThreads), 0, st>>>(x, dt, B, dy, yoff, cum,
      dS, CB, dx, dw, off, d);
  if ((err = (int)cudaGetLastError())) return err;
  dbc_kernel<<<dim3(nnt, nt, bc * G), dim3(kThreads), 0, st>>>(x, dt, dy, B, C,
      cum, S, dS, dCB, dB, dC, d);
  if ((err = (int)cudaGetLastError())) return err;
  final_kernel<<<dim3(bc * h), dim3(32), 0, st>>>(dt, A, cum, rowpart, colpart,
      off, dw, dtpart, ddt, dApart, d, npass);
  return (int)cudaGetLastError();
}
