// Legendre transforms of the SHT (kernels B10a analysis and B10s synthesis
// of the port).
//
//   B10a: out[m, l, c] = sum_t Lambda_lm(theta_t) G[m, t, c]
//   B10s: acc[m, t, c] = sum_l Lambda_lm(theta_t) a[m, l, c]
//
// with Lambda_{l+1} = (A_lm x + B_lm) Lambda_l + C_lm Lambda_{l-1},
// x = cos(theta), for one Wigner column n (spin 0, or one of -s, +s), and c
// over the maps' real and imaginary parts.
//
// Replaces orphics_tpu/ops/pallas_sht.py: _ana_kernel, _ana_kernel_b,
// _ana_kernel_f, _ana_kernel_fb (pallas_call at :1230, :1325, :1216, :1310)
// and _syn_kernel, _syn_kernel_b, _syn_kernel_f, _syn_kernel_fb (:1273,
// :1379, :1260, :1364). The TPU has no fp64, so its kernels run the
// recurrence in double-single fp32. Here the default mode runs it in native
// fp64: two FMAs, a multiply and a select per step. Each lane (ring, m)
// starts at its captured l_s with the pair (Lambda_{l_s - 1}, Lambda_{l_s})
// as true fp64 values (after capture a lane's value is at least ~2^-50, so
// no extended exponent is needed). The fast mode keeps the plain fp32
// recurrence of _fast_step with its 2^-30 rescale and its e weighting
// (1, 2^-30, 0), per lane, but rounds the factor a x + b once from fp64 a
// and x (factor below: two FMAs more a step); with a and x rounded to fp32
// the near-polar low-m lanes drifted, and the lmax 1023 roundtrip missed
// the reference's 1.8e-3.
//
// Bound: operations (chip_smoke.py phase 2, the larger of bytes and
// operations). Per live (ring, m, l) step the recurrence (5 fp64
// operations; 9 fp32 in fast) and per map the complex contraction (two FMAs:
// 4 operations, counted at the fp32 rate, which the fp64 tensor cores
// match); the bytes are ~0.2 GB at lmax 2047. The first form of these
// kernels ran 12-30x that bound, held back by latency and instruction
// issue, not by the fp64 pipe: one dependent chain a thread, two shared
// loads per contraction FMA, a read-modify-write of the fp64 output in every
// chunk (B10a), 2 x nmaps broadcast loads and conversions per step (B10s).
//
// Design.
// * Chunks of LC = 16 l-steps. A block stages the m column's coefficients
//   A, B, C (m-major tables) with 16-byte cp.async copies two chunks ahead
//   of their use, and each lane's captured seeds once in shared memory.
// * Each lane runs the recurrence of RR rings (RR independent chains). A
//   chunk in which no lane of the warp takes its seed (and, fast, every
//   exponent is 0) runs the plain step, two FMAs and a multiply; the few
//   others the full step with the seed select and the rescale.
// * The tensor-core form (B10a; B10s from 3 maps): mma.sync.m16n8k4.f64,
//   the shape that issues at the full fp64 tensor rate on sm_90 (m8n8k4
//   issues at half of it), IEEE fp64 with each element a chain of FMAs in
//   k order (checked bit for bit on the H100). Lambda goes through a
//   warp-private shared buffer (row stride 32 RR + 4 doubles, conflict-free
//   fragment loads; folded, even l in rows 0-7 and odd l in rows 8-15),
//   ordered by __syncwarp.
//   - B10a, one pass (ana_kernel_1p): folded grids of 1025-2048 kernel
//     rings (legendre._ana_plan); see below.
//   - B10a, ring groups (ana_kernel), every other grid: M = 16 l
//     (folded: even l in rows 0-7, odd l in rows 8-15), K = 4 rings, N =
//     8 columns of S0's then S1's, the even-l rows keeping S0's and the
//     odd-l rows S1's (the other half of each product is discarded). G's
//     fragments stay in registers for the whole m column, read from the
//     caller's (map, ring, m) layout with the north-south fold formed on
//     the way (both forms: no fold, stack or permute pass). One block of 16
//     warps per (m, 512 RR rings); the warps' partials are summed in shared
//     memory in a fixed order during the next chunk; each (l, m) output is
//     written once (both forms: no read-modify-write, no zeroing pass), or
//     past one block as one fp64 partial output per 512-ring group, summed
//     by the wrapper in group order (the order of the RR = 2 block's own
//     sum, RR = 2 where one column tile holds the maps on 513-1024 rings);
//     folded, 9-16 maps as two grid layers (S0's and S1's fragments of 8
//     maps fill the registers), each re-running the recurrence.
//   - B10s: M = 16 rings, K = 4 l, N = 8 columns, Lambda transposed through
//     the warp buffer, the a fragments from the chunk's rows (cp.async from
//     the caller's (map, l, m) layout into padded rows), the sums in C
//     fragments over the whole l loop (even-l and odd-l accumulators when
//     folded: north = E + O, south = (-1)^m (E - O)). One block per (m, 128
//     RR rings).
// * The CUDA-core form (B10s, 1 or 2 maps): Lambda stays in registers, four
//   rings a lane; the chunk's a rows are staged in shared memory as fp64
//   and read as broadcasts. Each (ring, map) sum is the FMA chain over l in
//   order, so it gives the tensor-core form's bits.
// * Loop bounds per (m, 32-ring group) from the host (_bounds_table): a
//   block runs the union of its groups' live chunks, a warp skips the chunks
//   outside its own, and the lanes of a dead group hold no seed (their
//   values stay zero: the dead-group skip).
// * Instances: 1, 2, 4, 8 and 16 maps a launch; B10s and the ring-group
//   B10a one column tile per 4 maps, the one-pass B10a one per 4 maps of
//   a parity. Every (l, m) or (ring, m) sum runs in an order that depends
//   on the ring count only (the B10a form too: legendre._ana_plan), so
//   two runs, and a map alone or in a packed launch, give the same bits.
//
// B10a in one pass. At the curved-sky QE's launch (12 folded maps, 1536
// kernel rings, lmax 2047) the bound is the fp64 tensor cores': 2 x 24
// flops a live step, 1.58 ms. The ring-group form ran 10.3x that (16.2 ms
// and the wrapper's 2.0 ms sum): it wrote three fp64 partial planes (2.4
// GB) through device memory, ran the recurrence twice (two layers of 6
// maps) and discarded half of every product, with 8 of 32 columns
// padding. The one-pass form:
// * every ring of an m is summed on chip: a cluster of ceil(Tk / 256)
//   blocks (5-8), each block summing its 4 warp pairs' partials in
//   shared memory in pair order, the cluster its blocks' sums in rank order
//   over distributed shared memory (barrier.cluster, then each block pulls
//   its share of the chunk's outputs from every live block); the output is
//   written once, in the caller's type and (map, l, m) layout;
// * one recurrence for all maps: a block holds G's fragments of all its
//   maps in registers, in the caller's type, converted at the MMA;
// * chunks of 32 l, so that an m16 tile is the 16 l of one parity: warp h
//   of a pair contracts parity h over the pair's 64 rings against that
//   fold's 2 nmaps columns only, 3 tiles at 12 maps, no padding; the pair
//   shares its Lambda buffer (conflict-free by an XOR swizzle, no padding);
// * blocks of 8 warps and 256 rings, ~110 KB of shared memory and at most
//   128 registers, so that two blocks share an SM and one's barriers,
//   cluster waits and remote loads overlap the other's work; the
//   coefficients in 16-byte loads (the recurrence is bound by shared
//   memory: its Lambda stores and coefficient loads);
// * a block with no live ring (the polar rings at high m) leaves at once;
//   the cluster's barriers count only the blocks still running.
// Where the time goes (H100, the curved QE's launch, parts switched off in
// turn before the last two steps above): the recurrence (1.6 ms) and the
// MMAs (2.0 ms) add rather than overlap, and with both off the launch
// still took 5.5 of 8.8 ms: a chunk's fixed cost (two block barriers, the
// cluster barrier, the pull of the remote sums, the output stores). Where a
// launch holds few maps that cost outweighs the saving: one folded map on
// 1024 kernel rings takes 3.45 ms against the ring groups' 2.15, so folded
// grids of up to 1024 kernel rings, where the ring groups write no partial
// planes for such launches, and the unfolded layouts keep the ring-group
// form.
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int LC = 16;       // l-steps per chunk
constexpr int TG = 32;       // rings per bounds group (one warp slot)
constexpr int ANA_NW = 16;   // warps per B10a block
constexpr int SYN_NW = 4;    // warps per B10s block
constexpr int MAXB = 16;     // maps per launch
constexpr float kThresh = 32768.0f;                 // 2^15
constexpr float kInv = 9.313225746154785e-10f;      // 2^-30

struct Tabs {
  const void* A;        // (M1, Lp) R, m-major
  const void* B;
  const void* C;
  const void* x;        // (Tk) R
  const float* xlo;     // (Tk) fast: x - fp32(x), the ring cosine's low part
  const void* s1;       // (M1, Tk) R: Lambda_{l_s} (fast: mantissa)
  const void* s0;       // (M1, Tk) R: Lambda_{l_s - 1}
  const int* se;        // (M1, Tk) exponent of the fast mantissas
  const int* ls;        // (M1, Tk) captured l_s, -1: never
  const int* bounds;    // (3 M1, ng) first chunk, one past the last, -
  int M1, Lp, Tk, ng;
};

// d += a b on the fp64 tensor cores, m16n8k4 (the full-rate fp64 shape on
// sm_90; m8n8k4 issues at half the rate): A 16x4 (a0 row g = lane/4, a1 row
// g + 8, col q = lane%4), B 4x8 (row q, col g), C/D 16x8 (d0, d1 row g,
// d2, d3 row g + 8, cols 2q, 2q + 1)
__device__ __forceinline__ void mma1684(double (&d)[4], double a0, double a1,
                                        double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Lane state of the recurrence: value pair, ring cosine, (fast) exponent,
// captured l_s (-1: never, or a ring of a dead group) and the lane's index
// into the (M1, Tk) seed tables.
template <typename R>
struct Lane {
  R p, c, x, xl;
  int e, ls, i;
};

template <typename R>
__device__ inline void lane_init(Lane<R>& ln, const Tabs& tb, int m, int t,
                                 bool live) {
  const bool valid = t < tb.Tk && live;
  ln.i = m * tb.Tk + t;
  ln.p = R(0);
  ln.c = R(0);
  ln.e = 0;
  ln.x = valid ? static_cast<const R*>(tb.x)[t] : R(0);
  ln.xl = valid && sizeof(R) == 4 ? static_cast<R>(tb.xlo[t]) : R(0);
  ln.ls = valid ? tb.ls[ln.i] : -1;
}

__device__ inline double madd(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ inline float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}

// The lanes' captured seeds, staged once per block in shared memory (one
// slot per ring of the block; only the lane itself reads its slot, in the
// chunk where it takes its seed): out of the registers, which B10a's G
// fragments fill, and out of global memory, whose latency such a chunk
// would wait for.
template <typename R>
struct Seeds {
  R* s1;
  R* s0;
  int* se;
  __device__ void stage(const Tabs& tb, const Lane<R>& ln, int k) const {
    const bool live = ln.ls >= 0;
    s1[k] = live ? static_cast<const R*>(tb.s1)[ln.i] : R(0);
    s0[k] = live ? static_cast<const R*>(tb.s0)[ln.i] : R(0);
    se[k] = live ? tb.se[ln.i] : 0;
  }
};

// The recurrence's factor a x + b. Fast, the table holds a - 2 and the lane
// x's low part too: 2 x + (2 x_lo + ((a - 2) x + b)), so that the factor,
// near 2 on the low-m lanes, is rounded once from a and x as they are in
// fp64 (fp32 tables of a and x drift those lanes' values by ~l^2 ulps:
// 1.86e-3 for the lmax 1023 roundtrip against 1.8e-3 in the reference)
__device__ inline double factor(const Lane<double>& ln, double a, double b) {
  return fma(a, ln.x, b);
}
__device__ inline float factor(const Lane<float>& ln, float a, float b) {
  return fmaf(2.0f, ln.x, fmaf(2.0f, ln.xl, fmaf(a, ln.x, b)));
}

// One l-step where no lane of the warp takes its seed and (fast) every
// exponent is 0: the plain recurrence, weight 1.
template <typename R>
__device__ inline double step_plain(Lane<R>& ln, R a, R b, R c) {
  const R nv = madd(factor(ln, a, b), ln.c, c * ln.p);
  ln.p = ln.c;
  ln.c = nv;
  return static_cast<double>(nv);
}

// One l-step with the seed injection at l_s (s1, s0, se: the lane's seeds,
// loaded when l_s falls in the chunk) and, fast, the 2^-30 rescale and the
// (1, 2^-30, 0) weighting.
__device__ inline double step_full(Lane<double>& ln, double a, double b,
                                   double c, int l, double s1, double s0,
                                   int) {
  double nv = fma(factor(ln, a, b), ln.c, c * ln.p);
  double pv = ln.c;
  if (l == ln.ls) {
    nv = s1;
    pv = s0;
  }
  ln.p = pv;
  ln.c = nv;
  return nv;
}

__device__ inline double step_full(Lane<float>& ln, float a, float b,
                                   float c, int l, float s1, float s0,
                                   int se) {
  float nv = fmaf(factor(ln, a, b), ln.c, c * ln.p);
  float pv = ln.c;
  if (l == ln.ls) {
    nv = s1;
    pv = s0;
    ln.e = se;
  }
  if (fabsf(nv) > kThresh && ln.e > 0) {
    nv *= kInv;
    pv *= kInv;
    ln.e -= 1;
  }
  ln.p = pv;
  ln.c = nv;
  return static_cast<double>(ln.e == 0 ? nv
                             : (ln.e == 1 ? nv * kInv : 0.0f));
}

// The chunk's LC steps of the lane's RR rings; sink(j, r, Lambda) takes
// each value. Chunks in which a lane of the warp takes its seed, or (fast)
// holds a nonzero exponent, take step_full; the rest, nearly all,
// step_plain.
template <typename R, int RR, typename Sink>
__device__ inline void recur_chunk(Lane<R> (&ln)[RR], const Seeds<R>& sd,
                                   const int (&slot)[RR],
                                   const R* __restrict__ cf, int ch,
                                   Sink&& sink) {
  const int l0 = ch * LC;
  bool full = false;
#pragma unroll
  for (int r = 0; r < RR; ++r)
    full |= static_cast<unsigned>(ln[r].ls - l0) < LC
        || (sizeof(R) == 4 && ln[r].e > 0);
  if (__any_sync(0xffffffffu, full)) {
    R s1[RR], s0[RR];
    int se[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      s1[r] = sd.s1[slot[r]];
      s0[r] = sd.s0[slot[r]];
      se[r] = sd.se[slot[r]];
    }
#pragma unroll
    for (int j = 0; j < LC; ++j)
#pragma unroll
      for (int r = 0; r < RR; ++r)
        sink(j, r, step_full(ln[r], cf[j], cf[LC + j], cf[2 * LC + j],
                             l0 + j, s1[r], s0[r], se[r]));
  } else {
#pragma unroll
    for (int j = 0; j < LC; ++j)
#pragma unroll
      for (int r = 0; r < RR; ++r)
        sink(j, r, step_plain(ln[r], cf[j], cf[LC + j], cf[2 * LC + j]));
  }
}

// ... into the warp buffer (row stride S; folded, even l in rows 0-7 and
// odd l in rows 8-15), for the tensor-core contractions
template <typename R, bool FOLD, int RR, int S>
__device__ inline void recur_to_buffer(Lane<R> (&ln)[RR], const Seeds<R>& sd,
                                       const int (&slot)[RR],
                                       const R* __restrict__ cf,
                                       double* __restrict__ lam, int ch,
                                       int lane) {
  recur_chunk(ln, sd, slot, cf, ch, [&](int j, int r, double v) {
    const int row = FOLD ? (j & 1) * 8 + (j >> 1) : j;
    lam[row * S + r * 32 + lane] = v;
  });
  __syncwarp();
}

// Asynchronous copies into shared memory (cp.async), two chunks ahead of
// their use: a chunk's group is issued at the top of chunk ch - 2 and waited
// for before the barrier that ends chunk ch - 1.
template <int BYTES>
__device__ inline void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(BYTES));
}
__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ inline void cp_wait_prev() {      // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ inline void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The chunk's coefficients A, B, C (3 LC values of R) into buf: 16-byte
// copies by the first NV threads.
template <typename R>
struct Coef {
  static constexpr int PER = 16 / sizeof(R);
  static constexpr int NV = 3 * LC / PER;
  __device__ static void fetch(const Tabs& tb, int m, int ch, R* buf,
                               int tid) {
    if (tid >= NV) return;
    const int tab = tid / (LC / PER), off = (tid % (LC / PER)) * PER;
    const R* T = static_cast<const R*>(tab == 0 ? tb.A
                                       : (tab == 1 ? tb.B : tb.C));
    cp_async<16>(buf + tab * LC + off,
                 T + static_cast<int64_t>(m) * tb.Lp + ch * LC + off);
  }
};

// Per-slot and per-warp chunk bounds of the 32-ring groups g0 + r * gstep
// (a slot is live where lo < hi: its lanes' values before lo are zero, and
// hi is the chunk count); the block's union goes through shared memory
// (one barrier).
template <int RR, int NW>
__device__ inline void chunk_bounds(const Tabs& tb, int m, int g0, int gstep,
                                    int (&lo)[RR], int (&hi)[RR], int& wlo,
                                    int& whi, int& blo, int& bhi, int* sb) {
  wlo = 1 << 30;
  whi = 0;
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int gi = g0 + r * gstep;
    lo[r] = gi < tb.ng ? tb.bounds[m * tb.ng + gi] : 0;
    hi[r] = gi < tb.ng ? tb.bounds[(tb.M1 + m) * tb.ng + gi] : 0;
    if (lo[r] < hi[r]) {
      wlo = min(wlo, lo[r]);
      whi = max(whi, hi[r]);
    }
  }
  if (wlo >= whi) wlo = whi = 0;
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sb[w] = wlo;
    sb[NW + w] = whi;
  }
  __syncthreads();
  blo = 1 << 30;
  bhi = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (sb[i] < sb[NW + i]) {
      blo = min(blo, sb[i]);
      bhi = max(bhi, sb[NW + i]);
    }
  }
  if (blo >= bhi) blo = bhi = 0;
}

// B10a. G: the maps' (nmaps, Tr, M1, 2) TI, Tr = T rings when folded, else
// Tk; out: the maps' (nmaps, L1, M1, 2) TI when direct, else fp64 partials
// (nsg, nmaps, L1, M1, 2), nsg = the grid's 512 RR-ring groups. Grid (M1,
// nsg, map groups), 512 threads; block z takes the maps [z gmaps, z gmaps
// + gmaps) (fewer in the last group). Warp w, slot r holds the rings (sg RR
// + r) 512 + 32 w + lane. The B columns are P cp, cp = 2 (the group's maps)
// (re, im per map); folded (P = 2) S0's then S1's: the even-l rows (0-7 of
// the warp buffer) keep S0's, the odd-l rows (8-15) S1's.
template <typename TI, typename R, bool FOLD, int NTB, int RR>
__global__ void __launch_bounds__(ANA_NW * 32, 1)
ana_kernel(Tabs tb, const TI* __restrict__ G, void* __restrict__ out,
           int nmaps, int gmaps, int L1, int Tr, int T, int direct) {
  constexpr int P = FOLD ? 2 : 1;
  constexpr int NTH = ANA_NW * 32;
  constexpr int S = 32 * RR + 4;        // Lambda buffer row stride
  constexpr int PE = NTB * 128;         // partials per warp and slot
  constexpr int NH = NTB > 2 ? 2 : NTB; // column tiles a pass (registers)
  extern __shared__ double smem[];
  double* lam_all = smem;                                // [NW][LC][S]
  double* part = lam_all + ANA_NW * LC * S;              // [2][RR][NW][PE]
  R* coef = reinterpret_cast<R*>(part + 2 * RR * ANA_NW * PE);  // [3][3 LC]
  const Seeds<R> sd{coef + 9 * LC, coef + 9 * LC + RR * NTH,
                    reinterpret_cast<int*>(coef + 9 * LC + 2 * RR * NTH)};
  __shared__ int sb[2 * ANA_NW];
  const int m = blockIdx.x, sg = blockIdx.y;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.z * gmaps;           // the group's first map
  const int cp = 2 * min(gmaps, nmaps - b0), cb = P * cp;
  const int ring0 = sg * RR * NTH + 32 * w;   // slot r adds r * NTH
  G += static_cast<int64_t>(b0) * Tr * tb.M1 * 2;
  // output element (map column c, l) of this m
  const int64_t slab = static_cast<int64_t>(2 * nmaps) * L1 * tb.M1;
  auto put = [&](int c, int l, double v) {
    const int64_t i = (static_cast<int64_t>(b0 + (c >> 1)) * L1 + l)
        * tb.M1 * 2 + 2 * m + (c & 1);
    if (direct)
      static_cast<TI*>(out)[i] = static_cast<TI>(v);
    else
      static_cast<double*>(out)[sg * slab + i] = v;
  };
  // the warps' partials of chunk ch, summed in a fixed order, written once
  auto reduce = [&](int ch) {
    const double* pr = part + (ch & 1) * RR * ANA_NW * PE;
    for (int e = tid; e < PE; e += NTH) {
      const int h = e & 1, el = (e >> 1) & 31, hh = (e >> 6) & 1;
      const int col = (e >> 7) * 8 + 2 * (el & 3) + h;
      const int row = (el >> 2) + 8 * hh;
      const int p = FOLD ? col / cp : 0;
      const int j = FOLD ? 2 * (row & 7) + hh : row;
      const int l = ch * LC + j;
      if (col >= cb || p != (FOLD ? hh : 0) || l >= L1) continue;
      double s = 0.0;
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        double sr = 0.0;
#pragma unroll
        for (int ww = 0; ww < ANA_NW; ++ww)
          sr += pr[(r * ANA_NW + ww) * PE + e];
        s = r == 0 ? sr : s + sr;
      }
      put(col - p * cp, l, s);
    }
  };

  int lo[RR], hi[RR], wlo, whi, blo, bhi;
  chunk_bounds<RR, ANA_NW>(tb, m, ring0 / TG, NTH / TG, lo, hi, wlo, whi,
                           blo, bhi, sb);
  {   // zeros outside the block's live chunks
    const int zlo = min(blo * LC, L1), zhi = min(bhi * LC, L1);
    const int nz = zlo + L1 - zhi;
    for (int i = tid; i < nz * cp; i += NTH) {
      const int c = i % cp, k = i / cp;
      put(c, k < zlo ? k : zhi + k - zlo, 0.0);
    }
  }
  if (blo >= bhi) return;                     // uniform over the block

  Coef<R>::fetch(tb, m, blo, coef + (blo % 3) * 3 * LC, tid);
  cp_commit();
  if (blo + 1 < bhi)
    Coef<R>::fetch(tb, m, blo + 1, coef + ((blo + 1) % 3) * 3 * LC, tid);
  cp_commit();
  // G's fragments of the warp's rings: B[k = ring 4 ks + q][n = col];
  // folded, S0 and S1 of ring t are formed from rings t and T - 1 - t in
  // TI arithmetic, as the wrapper's plain _fold_G forms them
  auto gval = [&](int t, int col) -> double {
    const int p = FOLD ? col / cp : 0, c = col - p * cp;
    const TI* gt = G + ((static_cast<int64_t>(c >> 1) * Tr + t) * tb.M1 + m)
        * 2 + (c & 1);
    if (!FOLD) return static_cast<double>(gt[0]);
    const TI n = gt[0];
    const bool pair = t < T / 2;
    const TI s = pair ? gt[static_cast<int64_t>(T - 1 - 2 * t) * tb.M1 * 2]
                      : TI(0);
    const TI e = pair ? TI(n + s) : n, o = pair ? TI(n - s) : TI(0);
    return static_cast<double>(((m & 1) == 0) == (p == 0) ? e : o);
  };
  double bf[RR][8][NTB];
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int t = ring0 + r * NTH + 4 * ks + q;
#pragma unroll
      for (int nt = 0; nt < NTB; ++nt) {
        const int col = nt * 8 + g;
        bf[r][ks][nt] = (t < tb.Tk && col < cb) ? gval(t, col) : 0.0;
      }
    }
  Lane<R> ln[RR];
  int slot[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    lane_init(ln[r], tb, m, ring0 + r * NTH + lane, lo[r] < hi[r]);
    slot[r] = r * NTH + tid;
    sd.stage(tb, ln[r], slot[r]);
  }
  cp_wait_prev();
  __syncthreads();
  double* lam = lam_all + w * LC * S;
  for (int ch = blo; ch < bhi; ++ch) {
    if (ch + 2 < bhi)
      Coef<R>::fetch(tb, m, ch + 2, coef + ((ch + 2) % 3) * 3 * LC, tid);
    cp_commit();
    double2* pw = reinterpret_cast<double2*>(
        part + (ch & 1) * RR * ANA_NW * PE);
    const bool run = ch >= wlo && ch < whi;    // uniform over the warp
    if (run)
      recur_to_buffer<R, FOLD, RR, S>(ln, sd, slot, coef + (ch % 3) * 3 * LC,
                                  lam, ch, lane);
    if (ch > blo) reduce(ch - 1);              // overlaps the other warps
#pragma unroll
    for (int h0 = 0; h0 < NTB; h0 += NH) {
      double acc[RR][NH][4];
#pragma unroll
      for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int nt = 0; nt < NH; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][nt][i] = 0.0;
      if (run) {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
#pragma unroll
          for (int r = 0; r < RR; ++r) {
            const double* lr = lam + r * 32 + 4 * ks + q;
            const double a0 = lr[g * S], a1 = lr[(g + 8) * S];
#pragma unroll
            for (int nt = 0; nt < NH; ++nt)
              mma1684(acc[r][nt], a0, a1, bf[r][ks][h0 + nt]);
          }
      }
#pragma unroll
      for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int nt = 0; nt < NH; ++nt) {
          double2* pr = pw + (r * ANA_NW + w) * (PE / 2);
          pr[((h0 + nt) * 2) * 32 + lane] =
              make_double2(acc[r][nt][0], acc[r][nt][1]);
          pr[((h0 + nt) * 2 + 1) * 32 + lane] =
              make_double2(acc[r][nt][2], acc[r][nt][3]);
        }
    }
    cp_wait_prev();
    __syncthreads();
    // part[ch & 1] is read in the next chunk and rewritten two chunks on,
    // after the barrier that ends that read; the warp buffer and the
    // coefficients of chunk ch are rewritten after this barrier
  }
  reduce(bhi - 1);
}

// One-pass B10a (the header's design): chunks of LC1 l-steps, warp pairs,
// two blocks an SM.
constexpr int LC1 = 32;                  // l-steps per chunk
constexpr int ANA1_NW = 8;               // warps per block
constexpr int ANA1_NP = ANA1_NW / 2;     // warp pairs per block
constexpr int ANA1_RINGS = ANA1_NW * 32; // rings per block (256)
constexpr int MAXCL = 8;                 // blocks per cluster (portable)

// The LC1 steps of chunk ch of the lane's ring, as recur_chunk, with each
// table's coefficients of 16 / sizeof(R) steps in one 16-byte load (cf
// 16-byte aligned; the loads stay in this body, where cf is __restrict__,
// so that they may run ahead of the sink's stores)
template <typename R, typename Sink>
__device__ inline void recur_chunk1(Lane<R>& ln, const Seeds<R>& sd,
                                    int slot, const R* __restrict__ cf,
                                    int ch, Sink&& sink) {
  constexpr int PER = 16 / static_cast<int>(sizeof(R));
  using V = typename std::conditional<sizeof(R) == 8, double2, float4>::type;
  const int l0 = ch * LC1;
  const bool full = static_cast<unsigned>(ln.ls - l0) < LC1
      || (sizeof(R) == 4 && ln.e > 0);
  if (__any_sync(0xffffffffu, full)) {
    const R s1 = sd.s1[slot], s0 = sd.s0[slot];
    const int se = sd.se[slot];
#pragma unroll
    for (int j0 = 0; j0 < LC1; j0 += PER) {
      const V va = *reinterpret_cast<const V*>(cf + j0);
      const V vb = *reinterpret_cast<const V*>(cf + LC1 + j0);
      const V vc = *reinterpret_cast<const V*>(cf + 2 * LC1 + j0);
      const R* a = reinterpret_cast<const R*>(&va);
      const R* b = reinterpret_cast<const R*>(&vb);
      const R* c = reinterpret_cast<const R*>(&vc);
#pragma unroll
      for (int i = 0; i < PER; ++i)
        sink(j0 + i, step_full(ln, a[i], b[i], c[i], l0 + j0 + i, s1, s0,
                               se));
    }
  } else {
#pragma unroll
    for (int j0 = 0; j0 < LC1; j0 += PER) {
      const V va = *reinterpret_cast<const V*>(cf + j0);
      const V vb = *reinterpret_cast<const V*>(cf + LC1 + j0);
      const V vc = *reinterpret_cast<const V*>(cf + 2 * LC1 + j0);
      const R* a = reinterpret_cast<const R*>(&va);
      const R* b = reinterpret_cast<const R*>(&vb);
      const R* c = reinterpret_cast<const R*>(&vc);
#pragma unroll
      for (int i = 0; i < PER; ++i)
        sink(j0 + i, step_plain(ln, a[i], b[i], c[i]));
    }
  }
}

// The coefficients of chunk ch of LC1 steps into buf, as Coef; zeros past
// the tables' Lp columns (a multiple of LC, so a copy lies wholly on one
// side)
template <typename R>
__device__ inline void coef_fetch1(const Tabs& tb, int m, int ch, R* buf,
                                   int tid) {
  constexpr int PER = 16 / sizeof(R);
  if (tid >= 3 * LC1 / PER) return;
  const int tab = tid / (LC1 / PER), off = (tid % (LC1 / PER)) * PER;
  const int l = ch * LC1 + off;
  R* dst = buf + tab * LC1 + off;
  if (l >= tb.Lp) {
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[i] = R(0);
    return;
  }
  const R* T = static_cast<const R*>(tab == 0 ? tb.A
                                     : (tab == 1 ? tb.B : tb.C));
  cp_async<16>(dst, T + static_cast<int64_t>(m) * tb.Lp + l);
}

// Lambda of a pair's chunk: row r (even l in rows 0-15, odd l in 16-31),
// ring column c (0-63) at r 64 + (c ^ 4 (r & 3)): the fragment
// loads (rows g, g + 8, columns 4 ks + q) and the rows' stores are
// conflict-free with no padding
__device__ __forceinline__ int lam1(int r, int c) {
  return r * 64 + (c ^ ((r & 3) << 2));
}

// fp32 -> fp64 at the use: volatile, so that G's fragments stay fp32 in
// the registers rather than being converted once, out of the loop, into
// twice the registers
__device__ __forceinline__ double to_f64(float v) {
  double d;
  asm volatile("cvt.f64.f32 %0, %1;\n" : "=d"(d) : "f"(v));
  return d;
}
__device__ __forceinline__ double to_f64(double v) { return v; }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// a double of the shared memory of the cluster's block `rank`, at the
// offset of p in this block's
__device__ __forceinline__ double ld_rank(const double* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(a), "r"(rank));
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n"
               : "=d"(v) : "r"(ra) : "memory");
  return v;
}

// B10a, one pass, folded. G: the maps' (nmaps, T, M1, 2) TI; out: the
// maps' (nmaps, L1, M1, 2) TI, every element written once. Grid (M1,
// ncl) in clusters of (1, ncl): block `rank` of the m's cluster holds the
// rings rank 256 + [0, 256), warp w the 32 rings rank 256 + 32 w + lane
// (pair w / 2, role h = w % 2). A chunk: each warp runs its rings' LC1
// steps into the pair's buffer; warp h of the pair contracts the chunk's l
// of parity h against S_h's columns over the pair's 64 rings, k-steps in ring
// order (a dead warp's 8 k-steps skipped: its Lambda is zero), NT column
// tiles of 8 (2 nmaps columns), NH at a time; the block sums its pairs'
// partials in pair order, the cluster its live blocks' sums in rank order
// over distributed shared memory (each live block finishes its share of
// the chunk's outputs). Two blocks share an SM, so that one's barriers and
// waits overlap the other's work.
template <typename TI, typename R, int NT>
__global__ void __launch_bounds__(ANA1_NW * 32, 2)
ana_kernel_1p(Tabs tb, const TI* __restrict__ G, TI* __restrict__ out,
              int nmaps, int L1, int T, int ncl) {
  constexpr int NTH = ANA1_NW * 32;
  constexpr int NW = ANA1_NW;
  constexpr int NH = NT > 3 ? 2 : NT;   // column tiles a pass (registers)
  constexpr int PE = NT * 128;          // a warp's partial: NT 16 x 8 tiles
  constexpr int XE = 2 * PE;            // a block's chunk sum: both m-tiles
  extern __shared__ double smem[];
  double* lam_all = smem;                            // [NP][LC1][64]
  double* part = lam_all + ANA1_NP * LC1 * 64;       // [NW][PE]
  double* xb = part + NW * PE;                       // [2][XE]
  R* coef = reinterpret_cast<R*>(xb + 2 * XE);       // [3][3 LC1]
  const Seeds<R> sd{coef + 9 * LC1, coef + 9 * LC1 + NTH,
                    reinterpret_cast<int*>(coef + 9 * LC1 + 2 * NTH)};
  __shared__ int sb[2 * NW + 3];
  const int m = blockIdx.x, rank = blockIdx.y;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int pr = w >> 1, h = w & 1;
  const int cs = 2 * nmaps;                  // columns (of a parity)
  const int pring0 = rank * NTH + 64 * pr;   // the pair's first ring
  const int64_t plane = static_cast<int64_t>(tb.M1) * 2;
  auto put = [&](int c, int l, double v) {
    out[(static_cast<int64_t>(c >> 1) * L1 + l) * plane + 2 * m + (c & 1)] =
        static_cast<TI>(v);
  };
  // output e of a block's chunk sum: m-tile e / PE, then the warp
  // partial's (tile, fragment register, lane)
  auto emit = [&](int ch, int e, double v) {
    const int hh = e / PE, ep = e - hh * PE;
    const int el = ep & 31, i = (ep >> 5) & 3, nt = ep >> 7;
    const int row = (el >> 2) + 8 * (i >> 1);
    const int col = nt * 8 + 2 * (el & 3) + (i & 1);
    const int l = ch * LC1 + 2 * row + hh;
    if (col < cs && l < L1) put(col, l, v);
  };
  // the live blocks of the cluster (a bit a rank), this block's index
  // among them and their count; blocks with no live ring leave at once
  unsigned live_mask = 0;
  int kr = 0, nl = 1;
  // the cluster's sum of chunk ch over the live blocks in rank order: this
  // block's share (every remote load issued before the first add)
  auto finish = [&](int ch) {
    const int per = (XE + nl - 1) / nl;
    const int e1 = min(XE, (kr + 1) * per);
    const double* x = xb + (ch & 1) * XE;
    for (int e = kr * per + tid; e < e1; e += NTH) {
      double xr[MAXCL];
#pragma unroll
      for (int r = 0; r < MAXCL; ++r)
        xr[r] = (live_mask >> r) & 1 ? ld_rank(x + e, r) : 0.0;
      double v = 0.0;
#pragma unroll
      for (int r = 0; r < MAXCL; ++r)
        if ((live_mask >> r) & 1) v += xr[r];
      emit(ch, e, v);
    }
  };

  // chunk bounds of LC1 steps: the warp's 32-ring group, and the union of
  // every group of the m and its live blocks, the same in each block of
  // the cluster
  if (tid == 0) {
    sb[2 * NW] = 1 << 30;
    sb[2 * NW + 1] = 0;
    sb[2 * NW + 2] = 0;
  }
  __syncthreads();
  for (int gi = tid; gi < tb.ng; gi += NTH) {
    const int lo = tb.bounds[m * tb.ng + gi];
    const int hi = tb.bounds[(tb.M1 + m) * tb.ng + gi];
    if (lo < hi) {
      atomicMin(&sb[2 * NW], lo * LC / LC1);
      atomicMax(&sb[2 * NW + 1], (hi * LC + LC1 - 1) / LC1);
      atomicOr(&sb[2 * NW + 2], 1 << (gi / NW));
    }
  }
  {
    const int gi = rank * NW + w;
    const int lo = gi < tb.ng ? tb.bounds[m * tb.ng + gi] : 0;
    const int hi = gi < tb.ng ? tb.bounds[(tb.M1 + m) * tb.ng + gi] : 0;
    if (lane == 0) {
      sb[w] = lo < hi ? lo * LC / LC1 : 0;
      sb[NW + w] = lo < hi ? (hi * LC + LC1 - 1) / LC1 : 0;
    }
  }
  __syncthreads();
  int clo = sb[2 * NW], chi = sb[2 * NW + 1];
  if (clo >= chi) clo = chi = 0;
  live_mask = static_cast<unsigned>(sb[2 * NW + 2]);
  const int wlo = sb[w], whi = sb[NW + w];
  // the live chunks of the pair's first and second warps (k-steps 0-7, 8-15)
  const int lo0 = sb[2 * pr], hi0 = sb[NW + 2 * pr];
  const int lo1 = sb[2 * pr + 1], hi1 = sb[NW + 2 * pr + 1];
  if (clo < chi) {
    // a block with no live ring leaves before any cluster barrier, and no
    // block reads its memory: the live blocks' barriers count the others
    // as arrived (barrier.cluster waits for the threads not exited)
    if (!((live_mask >> rank) & 1)) return;
    kr = __popc(live_mask & ((1u << rank) - 1));
    nl = __popc(live_mask);
  } else {
    kr = rank;
    nl = ncl;
  }
  {   // zeros outside the m's live chunks, shared over the live blocks
    const int zlo = min(clo * LC1, L1), zhi = min(chi * LC1, L1);
    const int nz = zlo + L1 - zhi;
    for (int i = kr * NTH + tid; i < nz * cs; i += nl * NTH) {
      const int c = i % cs, k = i / cs;
      put(c, k < zlo ? k : zhi + k - zlo, 0.0);
    }
  }
  if (clo >= chi) return;               // uniform over the cluster

  auto fetch = [&](int ch) {
    coef_fetch1(tb, m, ch, coef + (ch % 3) * 3 * LC1, tid);
  };
  fetch(clo);
  cp_commit();
  if (clo + 1 < chi) fetch(clo + 1);
  cp_commit();
  // G's fragments of the pair's rings for parity h: B[k = ring 4 ks + q][n
  // = col g of tile nt], S_h of ring t formed from rings t and T - 1 - t in
  // TI arithmetic, as the wrapper's plain _fold_G forms it
  auto gval = [&](int t, int c) -> TI {
    const TI* gt = G + ((static_cast<int64_t>(c >> 1) * T + t) * tb.M1 + m)
        * 2 + (c & 1);
    const TI n = gt[0];
    const bool pair = t < T / 2;
    const TI s = pair ? gt[static_cast<int64_t>(T - 1 - 2 * t) * plane]
                      : TI(0);
    const TI e = pair ? TI(n + s) : n, o = pair ? TI(n - s) : TI(0);
    return ((m & 1) == 0) == (h == 0) ? e : o;
  };
  TI bf[16][NT];
#pragma unroll
  for (int ks = 0; ks < 16; ++ks) {
    const int t = pring0 + 4 * ks + q;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + g;
      bf[ks][nt] = (t < tb.Tk && col < cs) ? gval(t, col) : TI(0);
    }
  }
  Lane<R> ln;
  lane_init(ln, tb, m, rank * NTH + 32 * w + lane, wlo < whi);
  sd.stage(tb, ln, tid);
  cp_wait_prev();
  __syncthreads();
  double* lam = lam_all + pr * LC1 * 64;
  const int col0 = 32 * h + lane;       // the lane's ring in the pair
  for (int ch = clo; ch < chi; ++ch) {
    if (ch + 2 < chi) fetch(ch + 2);
    cp_commit();
    if (ch >= wlo && ch < whi)            // uniform over the warp
      recur_chunk1(ln, sd, tid, coef + (ch % 3) * 3 * LC1, ch,
                   [&](int j, double v) {
        lam[lam1((j & 1) * 16 + (j >> 1), col0)] = v;
      });
    if (ch > clo) cluster_wait();   // chunk ch - 1's sums
    __syncthreads();   // the pairs' Lambda written, the partials read
    const bool on0 = ch >= lo0 && ch < hi0, on1 = ch >= lo1 && ch < hi1;
#pragma unroll
    for (int h0 = 0; h0 < NT; h0 += NH) {
      double acc[NH][4];
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 0 ? on0 : on1) {      // uniform over the warp
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const int ks = 8 * half + kk;
            const int r0 = 16 * h + g;
            const double a0 = lam[lam1(r0, 4 * ks + q)];
            const double a1 = lam[lam1(r0 + 8, 4 * ks + q)];
#pragma unroll
            for (int nt = 0; nt < NH; ++nt)
              mma1684(acc[nt], a0, a1, to_f64(bf[ks][h0 + nt]));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          part[w * PE + ((h0 + nt) * 4 + i) * 32 + lane] = acc[nt][i];
    }
    if (ch > clo) finish(ch - 1);
    cp_wait_prev();
    __syncthreads();   // the partials written; chunk ch + 1's coefficients
    for (int e = tid; e < XE; e += NTH) {
      const int hh = e / PE, ep = e - hh * PE;
      double v = 0.0;
#pragma unroll
      for (int p = 0; p < ANA1_NP; ++p) v += part[(2 * p + hh) * PE + ep];
      xb[(ch & 1) * XE + e] = v;
    }
    cluster_arrive();
    // xb[ch & 1] is rewritten at chunk ch + 2, after every block's wait for
    // chunk ch + 1, which follows its reads of chunk ch
  }
  cluster_wait();
  finish(chi - 1);
  cluster_arrive();     // no block leaves while another reads its memory
  cluster_wait();
}

// B10s. a: the maps' (nmaps, L1, M1, 2) TI; out: the maps' (nmaps, T', M1,
// 2) TI, T' = T (every ring; folded: north ring t and south ring T - 1 - t)
// or Tk. Grid (M1, ceil(Tk / 128 RR)), 128 threads; warp w, slot
// r holds the rings 128 RR y + 32 (RR w + r) + lane.
template <typename TI, typename R, bool FOLD, int NT, int RR>
__global__ void __launch_bounds__(SYN_NW * 32)
syn_kernel(Tabs tb, const TI* __restrict__ a, TI* __restrict__ out,
           int nmaps, int L1, int T) {
  constexpr int P = FOLD ? 2 : 1;
  constexpr int NTH = SYN_NW * 32;
  constexpr int MT = 2 * RR;            // ring tiles of 16 per warp
  constexpr int S = 32 * RR + 4;        // Lambda buffer row stride
  constexpr int KS = 4 / P;             // k-steps per parity and chunk
  // staged a row stride, in TI: the B fragments' loads conflict-free
  constexpr int SC = sizeof(TI) == 4 ? (NT == 1 ? 8 : 40)
                                     : (NT == 4 ? 36 : 20);
  extern __shared__ double smem[];
  double* lam_all = smem;                                   // [NW][LC][S]
  TI* as = reinterpret_cast<TI*>(lam_all + SYN_NW * LC * S);  // [3][LC][SC]
  R* coef = reinterpret_cast<R*>(as + 3 * LC * SC);         // [3][3 LC]
  const Seeds<R> sd{coef + 9 * LC, coef + 9 * LC + RR * NTH,
                    reinterpret_cast<int*>(coef + 9 * LC + 2 * RR * NTH)};
  __shared__ int sb[2 * SYN_NW];
  const int m = blockIdx.x;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int cs = 2 * nmaps;
  const int ring0 = (blockIdx.y * SYN_NW + w) * 32 * RR;

  int lo[RR], hi[RR], wlo, whi, blo, bhi;
  chunk_bounds<RR, SYN_NW>(tb, m, ring0 / TG, 1, lo, hi, wlo, whi, blo, bhi,
                           sb);
  Lane<R> ln[RR];
  int slot[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    lane_init(ln[r], tb, m, ring0 + r * 32 + lane, lo[r] < hi[r]);
    slot[r] = r * NTH + tid;
    sd.stage(tb, ln[r], slot[r]);
  }
  double acc[P][MT][NT][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] = 0.0;

  // a chunk's rows (each map's re, im: one copy of 2 TI; zeros past L1),
  // chunk row j at buffer row FOLD ? (j & 1) 8 + j / 2 : j; columns past
  // cs stay zero
  auto fetch = [&](int ch) {
    const int buf = ch % 3;
    Coef<R>::fetch(tb, m, ch, coef + buf * 3 * LC, tid);
    for (int i = tid; i < LC * nmaps; i += NTH) {
      const int j = i / nmaps, b = i % nmaps, l = ch * LC + j;
      const int row = FOLD ? (j & 1) * 8 + (j >> 1) : j;
      TI* dst = as + (buf * LC + row) * SC + 2 * b;
      if (l < L1)
        cp_async<2 * sizeof(TI)>(
            dst, a + ((static_cast<int64_t>(b) * L1 + l) * tb.M1 + m) * 2);
      else
        dst[0] = dst[1] = TI(0);
    }
  };
  for (int i = tid; i < 3 * LC * SC; i += NTH) as[i] = TI(0);
  __syncthreads();
  if (blo < bhi) fetch(blo);
  cp_commit();
  if (blo + 1 < bhi) fetch(blo + 1);
  cp_commit();
  cp_wait_prev();
  __syncthreads();
  double* lam = lam_all + w * LC * S;
  for (int ch = blo; ch < bhi; ++ch) {
    if (ch + 2 < bhi) fetch(ch + 2);
    cp_commit();
    if (ch >= wlo && ch < whi) {               // uniform over the warp
      recur_to_buffer<R, FOLD, RR, S>(ln, sd, slot, coef + (ch % 3) * 3 * LC,
                                  lam, ch, lane);
      const TI* ab = as + (ch % 3) * LC * SC;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int row = p * 8 + 4 * kk + q;     // l = chunk row of parity p
          double bv[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            bv[nt] = static_cast<double>(ab[row * SC + nt * 8 + g]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const double* lr = lam + row * S + mt * 16 + g;
            const double a0 = lr[0], a1 = lr[8];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma1684(acc[p][mt][nt], a0, a1, bv[nt]);
          }
        }
    }
    cp_wait_prev();
    __syncthreads();
  }
  cp_wait_all();
  const int Trows = FOLD ? T : tb.Tk;
  const double sg = (m & 1) ? -1.0 : 1.0;
  auto at = [&](int c, int row) -> TI& {
    return out[((static_cast<int64_t>(c >> 1) * Trows + row) * tb.M1 + m)
               * 2 + (c & 1)];
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = ring0 + mt * 16 + g + 8 * hh;
      if (t >= tb.Tk) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = nt * 8 + 2 * q + h;
          if (c >= cs) continue;
          const double e = acc[0][mt][nt][2 * hh + h];
          if (FOLD) {
            const double o = acc[P - 1][mt][nt][2 * hh + h];
            at(c, t) = static_cast<TI>(e + o);
            if (t < T / 2) at(c, T - 1 - t) = static_cast<TI>(sg * (e - o));
          } else {
            at(c, t) = static_cast<TI>(e);
          }
        }
    }
}

// B10s on the CUDA cores: Lambda stays in registers, each lane
// accumulates its RR rings x NB maps (x E, O when folded) in fp64, the
// chunk's a rows broadcast from shared memory (fp64, converted once per
// block). Same layouts and grid as syn_kernel, blocks of 128 RR rings.
template <typename TI, typename R, bool FOLD, int NB, int RR>
__global__ void __launch_bounds__(SYN_NW * 32)
syn_cc_kernel(Tabs tb, const TI* __restrict__ a, TI* __restrict__ out,
              int nmaps, int L1, int T) {
  constexpr int P = FOLD ? 2 : 1;
  constexpr int NTH = SYN_NW * 32;
  constexpr int NA = (LC * 2 * NB + NTH - 1) / NTH;   // a values a thread
  extern __shared__ double smem[];
  double* ad = smem;                                  // [2][LC][2 NB]
  R* coef = reinterpret_cast<R*>(ad + 2 * LC * 2 * NB);  // [3][3 LC]
  const Seeds<R> sd{coef + 9 * LC, coef + 9 * LC + RR * NTH,
                    reinterpret_cast<int*>(coef + 9 * LC + 2 * RR * NTH)};
  __shared__ int sb[2 * SYN_NW];
  const int m = blockIdx.x;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int cs = 2 * nmaps;
  const int ring0 = (blockIdx.y * SYN_NW + w) * 32 * RR;

  int lo[RR], hi[RR], wlo, whi, blo, bhi;
  chunk_bounds<RR, SYN_NW>(tb, m, ring0 / TG, 1, lo, hi, wlo, whi, blo, bhi,
                           sb);
  Lane<R> ln[RR];
  int slot[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    lane_init(ln[r], tb, m, ring0 + r * 32 + lane, lo[r] < hi[r]);
    slot[r] = r * NTH + tid;
    sd.stage(tb, ln[r], slot[r]);
  }
  double acc[P][RR][NB][2];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[p][r][b][0] = acc[p][r][b][1] = 0.0;

  auto load_a = [&](int ch, int k) -> TI {
    const int i = tid + k * NTH;
    const int l = ch * LC + i / cs, c = i % cs;
    return i < LC * cs && l < L1
        ? a[((static_cast<int64_t>(c >> 1) * L1 + l) * tb.M1 + m) * 2
            + (c & 1)]
        : TI(0);
  };
  auto store_a = [&](int buf, int k, TI v) {
    const int i = tid + k * NTH;
    if (i < LC * cs)
      ad[(buf * LC + i / cs) * 2 * NB + i % cs] = static_cast<double>(v);
  };
  for (int i = tid; i < 2 * LC * 2 * NB; i += NTH) ad[i] = 0.0;
  __syncthreads();
  if (blo < bhi) {
    Coef<R>::fetch(tb, m, blo, coef + (blo % 3) * 3 * LC, tid);
#pragma unroll
    for (int k = 0; k < NA; ++k) store_a(blo & 1, k, load_a(blo, k));
  }
  cp_commit();
  if (blo + 1 < bhi)
    Coef<R>::fetch(tb, m, blo + 1, coef + ((blo + 1) % 3) * 3 * LC, tid);
  cp_commit();
  cp_wait_prev();
  __syncthreads();
  for (int ch = blo; ch < bhi; ++ch) {
    if (ch + 2 < bhi)
      Coef<R>::fetch(tb, m, ch + 2, coef + ((ch + 2) % 3) * 3 * LC, tid);
    cp_commit();
    TI anx[NA];
    const bool pre = ch + 1 < bhi;
    if (pre) {
#pragma unroll
      for (int k = 0; k < NA; ++k) anx[k] = load_a(ch + 1, k);
    }
    if (ch >= wlo && ch < whi) {               // uniform over the warp
      const double* ab = ad + (ch & 1) * LC * 2 * NB;
      recur_chunk(ln, sd, slot, coef + (ch % 3) * 3 * LC, ch,
                  [&](int j, int r, double v) {
        const double2* row = reinterpret_cast<const double2*>(ab + j * 2 * NB);
        const int p = FOLD ? (j & 1) : 0;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const double2 x = row[b];
          acc[p][r][b][0] = fma(v, x.x, acc[p][r][b][0]);
          acc[p][r][b][1] = fma(v, x.y, acc[p][r][b][1]);
        }
      });
    }
    if (pre) {
#pragma unroll
      for (int k = 0; k < NA; ++k) store_a((ch + 1) & 1, k, anx[k]);
    }
    cp_wait_prev();
    __syncthreads();
  }
  cp_wait_all();
  const int Trows = FOLD ? T : tb.Tk;
  const double sg = (m & 1) ? -1.0 : 1.0;
  auto at = [&](int c, int row) -> TI& {
    return out[((static_cast<int64_t>(c >> 1) * Trows + row) * tb.M1 + m)
               * 2 + (c & 1)];
  };
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int t = ring0 + r * 32 + lane;
    if (t >= tb.Tk) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * b + h;
        if (c >= cs) continue;
        const double e = acc[0][r][b][h];
        if (FOLD) {
          const double o = acc[P - 1][r][b][h];
          at(c, t) = static_cast<TI>(e + o);
          if (t < T / 2) at(c, T - 1 - t) = static_cast<TI>(sg * (e - o));
        } else {
          at(c, t) = static_cast<TI>(e);
        }
      }
  }
}

template <typename TI, typename R, bool FOLD, int NB, int RR>
int launch_syn_cc(const Tabs& tb, const void* a, void* out, int nmaps,
                  int L1, int T, cudaStream_t st) {
  constexpr int smem = static_cast<int>(
      sizeof(double) * 2 * LC * 2 * NB
      + sizeof(R) * (9 * LC + 2 * RR * SYN_NW * 32)
      + sizeof(int) * RR * SYN_NW * 32);
  const int ny = (tb.Tk + RR * SYN_NW * 32 - 1) / (RR * SYN_NW * 32);
  syn_cc_kernel<TI, R, FOLD, NB, RR><<<dim3(tb.M1, ny), SYN_NW * 32, smem,
                                       st>>>(tb, static_cast<const TI*>(a),
                                             static_cast<TI*>(out), nmaps, L1,
                                             T);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

struct AnaArgs {
  int nmaps, gmaps, L1, Tr, T, direct;
};

template <typename TI, typename R, bool FOLD, int NTB, int RR>
int launch_ana(const Tabs& tb, const void* G, void* out, const AnaArgs& g,
               cudaStream_t st) {
  constexpr int S = 32 * RR + 4, PE = NTB * 128;
  constexpr int smem = static_cast<int>(
      sizeof(double) * (ANA_NW * LC * S + 2 * RR * ANA_NW * PE)
      + sizeof(R) * (9 * LC + 2 * RR * ANA_NW * 32)
      + sizeof(int) * RR * ANA_NW * 32);
  static const int attr = set_smem(ana_kernel<TI, R, FOLD, NTB, RR>, smem);
  if (attr != 0) return attr;
  const int nsg = (tb.Tk + RR * ANA_NW * 32 - 1) / (RR * ANA_NW * 32);
  const int nz = (g.nmaps + g.gmaps - 1) / g.gmaps;
  ana_kernel<TI, R, FOLD, NTB, RR><<<dim3(tb.M1, nsg, nz), ANA_NW * 32,
                                     smem, st>>>(
      tb, static_cast<const TI*>(G), out, g.nmaps, g.gmaps, g.L1, g.Tr, g.T,
      g.direct);
  return static_cast<int>(cudaGetLastError());
}

// NTB column tiles of 8 for the P 2 gmaps columns of a map group: 1, 2 or
// 4; RR = 2 with one tile only (the shared memory of two slots' partials)
int ana_tiles(int nmaps, int fold) {
  return ((fold ? 4 : 2) * nmaps + 7) / 8;
}

// maps a block takes: all of them, or folded (S0's and S1's fragments fill
// the registers at 8 maps) the launch's maps split into equal groups of up
// to 8, one grid layer each
int ana_group(int nmaps, int fold) {
  const int cap = fold ? 8 : MAXB;
  const int ngrp = (nmaps + cap - 1) / cap;
  return (nmaps + ngrp - 1) / ngrp;
}

template <typename TI, typename R, bool FOLD>
int ana_dispatch(const Tabs& tb, const void* G, void* out, const AnaArgs& g,
                 int rr, cudaStream_t st) {
  const int ntb = ana_tiles(g.gmaps, FOLD);
  if (rr == 2) return launch_ana<TI, R, FOLD, 1, 2>(tb, G, out, g, st);
  if (ntb == 1) return launch_ana<TI, R, FOLD, 1, 1>(tb, G, out, g, st);
  if (ntb == 2) return launch_ana<TI, R, FOLD, 2, 1>(tb, G, out, g, st);
  return launch_ana<TI, R, FOLD, 4, 1>(tb, G, out, g, st);
}

template <typename TI, typename R, int NT>
int launch_ana_1p(const Tabs& tb, const void* G, void* out, int nmaps,
                  int L1, int T, int ncl, cudaStream_t st) {
  constexpr int PE = NT * 128;
  constexpr int smem = static_cast<int>(
      sizeof(double) * (ANA1_NP * LC1 * 64 + ANA1_NW * PE + 4 * PE)
      + sizeof(R) * (9 * LC1 + 2 * ANA1_RINGS) + sizeof(int) * ANA1_RINGS);
  auto kernel = ana_kernel_1p<TI, R, NT>;
  static const int attr = set_smem(kernel, smem);
  if (attr != 0) return attr;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = ncl;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tb.M1, ncl, 1);
  cfg.blockDim = dim3(ANA1_NW * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, tb, static_cast<const TI*>(G), static_cast<TI*>(out),
      nmaps, L1, T, ncl);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// NT column tiles of 8 for the 2 nmaps columns of a parity: 1 to 4
template <typename TI, typename R>
int ana_1p_dispatch(const Tabs& tb, const void* G, void* out, int nmaps,
                    int L1, int T, int ncl, cudaStream_t st) {
  switch ((2 * nmaps + 7) / 8) {
    case 1:
      return launch_ana_1p<TI, R, 1>(tb, G, out, nmaps, L1, T, ncl, st);
    case 2:
      return launch_ana_1p<TI, R, 2>(tb, G, out, nmaps, L1, T, ncl, st);
    case 3:
      return launch_ana_1p<TI, R, 3>(tb, G, out, nmaps, L1, T, ncl, st);
    default:
      return launch_ana_1p<TI, R, 4>(tb, G, out, nmaps, L1, T, ncl, st);
  }
}

template <typename TI, typename R, bool FOLD, int NT, int RR>
int launch_syn(const Tabs& tb, const void* a, void* out, int nmaps, int L1,
               int T, cudaStream_t st) {
  constexpr int S = 32 * RR + 4;
  constexpr int SC = sizeof(TI) == 4 ? (NT == 1 ? 8 : 40)
                                     : (NT == 4 ? 36 : 20);
  constexpr int smem = static_cast<int>(
      sizeof(double) * SYN_NW * LC * S + sizeof(TI) * 3 * LC * SC
      + sizeof(R) * (9 * LC + 2 * RR * SYN_NW * 32)
      + sizeof(int) * RR * SYN_NW * 32);
  const int ny = (tb.Tk + RR * SYN_NW * 32 - 1) / (RR * SYN_NW * 32);
  syn_kernel<TI, R, FOLD, NT, RR><<<dim3(tb.M1, ny), SYN_NW * 32, smem,
                                    st>>>(tb, static_cast<const TI*>(a),
                                          static_cast<TI*>(out), nmaps, L1,
                                          T);
  return static_cast<int>(cudaGetLastError());
}

// One or two maps: the CUDA-core form, four rings a lane; then NT column
// tiles of the tensor-core form: 1 up to 4 maps (RR = 2), 2 up to 8, 4 up
// to 16
template <typename TI, typename R, bool FOLD>
int syn_dispatch(const Tabs& tb, const void* a, void* out, int nmaps, int L1,
                 int T, cudaStream_t st) {
  if (nmaps <= 1)
    return launch_syn_cc<TI, R, FOLD, 1, 4>(tb, a, out, nmaps, L1, T, st);
  if (nmaps <= 2)
    return launch_syn_cc<TI, R, FOLD, 2, 4>(tb, a, out, nmaps, L1, T, st);
  if (nmaps <= 4)
    return launch_syn<TI, R, FOLD, 1, 2>(tb, a, out, nmaps, L1, T, st);
  if (nmaps <= 8)
    return launch_syn<TI, R, FOLD, 2, 1>(tb, a, out, nmaps, L1, T, st);
  return launch_syn<TI, R, FOLD, 4, 1>(tb, a, out, nmaps, L1, T, st);
}

bool bad_shape(int M1, int Lp, int Tk, int ng, int nmaps) {
  return M1 < 1 || M1 > 65535 || Lp < LC || Lp % LC || Tk < 1
      || ng != (Tk + TG - 1) / TG || nmaps < 1 || nmaps > MAXB;
}

}  // namespace

extern "C" {

// B10a. Tables (A, B, C m-major (M1, Lp), x, s1, s0) are fp32 when fast,
// with A - 2 in place of A and xlo the low part of x, else fp64; G is
// the maps' (nmaps, Tr, M1, 2), Tr = T folded (the kernel rings are the
// Tk = (T + 1) / 2 northern ones), else Tk, fp64 when f64,
// else fp32; out, every element written: when direct, the maps' (nmaps,
// L1, M1, 2) in G's type, else fp64 partials (nsg, nmaps, L1, M1, 2) with
// nsg = ceil(Tk / (512 rr)) for the caller to sum in order. rr = 2 needs
// one column tile (2 maps folded, 4 not) and Tk <= 1024; folded, more than
// 8 maps run as two groups of blocks (ana_group). fast is ignored for fp64
// inputs.
int legendre_ana_launch(const void* A, const void* B, const void* C,
                        const void* x, const float* xlo, const void* s1,
                        const void* s0,
                        const int* se, const int* ls, const int* bounds,
                        const void* G, void* out, int M1, int Lp, int L1,
                        int Tk, int Tr, int T, int ng, int nmaps, int rr,
                        int direct, int fold, int fast, int f64,
                        void* stream) {
  if (bad_shape(M1, Lp, Tk, ng, nmaps) || L1 < 1 || L1 > Lp
      || (fold ? (Tr != T || Tk != (T + 1) / 2) : Tr != Tk)
      || (rr != 1 && rr != 2)
      || (rr == 2 && (ana_tiles(nmaps, fold) != 1 || Tk > 1024)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tabs tb{A, B, C, x, xlo, s1, s0, se, ls, bounds, M1, Lp, Tk, ng};
  const AnaArgs g{nmaps, ana_group(nmaps, fold), L1, Tr, T, direct};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return fold ? ana_dispatch<double, double, true>(tb, G, out, g, rr, st)
                : ana_dispatch<double, double, false>(tb, G, out, g, rr, st);
  if (fast)
    return fold ? ana_dispatch<float, float, true>(tb, G, out, g, rr, st)
                : ana_dispatch<float, float, false>(tb, G, out, g, rr, st);
  return fold ? ana_dispatch<float, double, true>(tb, G, out, g, rr, st)
              : ana_dispatch<float, double, false>(tb, G, out, g, rr, st);
}

// B10a in one pass on a folded grid: as legendre_ana_launch with fold = 1,
// out always the maps' (nmaps, L1, M1, 2) in G's type, every element
// written once; ncl = ceil(Tk / 256) blocks a cluster, at most 8.
int legendre_ana1_launch(const void* A, const void* B, const void* C,
                         const void* x, const float* xlo, const void* s1,
                         const void* s0, const int* se, const int* ls,
                         const int* bounds, const void* G, void* out, int M1,
                         int Lp, int L1, int Tk, int T, int ng, int nmaps,
                         int ncl, int fast, int f64, void* stream) {
  if (bad_shape(M1, Lp, Tk, ng, nmaps) || L1 < 1 || L1 > Lp
      || Tk != (T + 1) / 2
      || ncl != (Tk + ANA1_RINGS - 1) / ANA1_RINGS || ncl > MAXCL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tabs tb{A, B, C, x, xlo, s1, s0, se, ls, bounds, M1, Lp, Tk, ng};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return ana_1p_dispatch<double, double>(tb, G, out, nmaps, L1, T, ncl, st);
  if (fast)
    return ana_1p_dispatch<float, float>(tb, G, out, nmaps, L1, T, ncl, st);
  return ana_1p_dispatch<float, double>(tb, G, out, nmaps, L1, T, ncl, st);
}

// B10s. a: the maps' (nmaps, L1, M1, 2); out: the maps' (nmaps, fold ? T :
// Tk, M1, 2); both fp64 when f64, else fp32.
int legendre_syn_launch(const void* A, const void* B, const void* C,
                        const void* x, const float* xlo, const void* s1,
                        const void* s0,
                        const int* se, const int* ls, const int* bounds,
                        const void* a, void* out, int M1, int Lp, int L1,
                        int Tk, int T, int ng, int nmaps, int fold, int fast,
                        int f64, void* stream) {
  if (bad_shape(M1, Lp, Tk, ng, nmaps) || L1 < 1 || L1 > Lp
      || (Tk + 127) / 128 > 65535 || (fold && Tk != (T + 1) / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tabs tb{A, B, C, x, xlo, s1, s0, se, ls, bounds, M1, Lp, Tk, ng};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return fold
        ? syn_dispatch<double, double, true>(tb, a, out, nmaps, L1, T, st)
        : syn_dispatch<double, double, false>(tb, a, out, nmaps, L1, T, st);
  if (fast)
    return fold
        ? syn_dispatch<float, float, true>(tb, a, out, nmaps, L1, T, st)
        : syn_dispatch<float, float, false>(tb, a, out, nmaps, L1, T, st);
  return fold
      ? syn_dispatch<float, double, true>(tb, a, out, nmaps, L1, T, st)
      : syn_dispatch<float, double, false>(tb, a, out, nmaps, L1, T, st);
}

}  // extern "C"
