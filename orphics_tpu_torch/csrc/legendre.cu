// Legendre transforms of the SHT (kernels B10a analysis and B10s synthesis
// of the port).
//
//   B10a: out[m, l, b] = sum_t Lambda_lm(theta_t) G[b, t, m]
//   B10s: acc[b, t, m] = sum_l Lambda_lm(theta_t) a[b, l, m]
//
// with Lambda_{l+1} = (A_lm x + B_lm) Lambda_l + C_lm Lambda_{l-1},
// x = cos(theta), for one Wigner column n (spin 0, or one of -s, +s).
//
// Replaces orphics_tpu/ops/pallas_sht.py: _ana_kernel, _ana_kernel_b,
// _ana_kernel_f, _ana_kernel_fb (pallas_call at :1230, :1325, :1216, :1310)
// and _syn_kernel, _syn_kernel_b, _syn_kernel_f, _syn_kernel_fb (:1273,
// :1379, :1260, :1364). The TPU has no fp64, so its kernels run the
// recurrence in double-single fp32 (~59 vector operations per step). Here
// the default mode runs it in native fp64: one FMA pair and a select per
// step. Each lane (ring, m) starts at its captured l_s with the pair
// (Lambda_{l_s - 1}, Lambda_{l_s}) as true fp64 values: after capture a
// lane's value is at least ~2^-50, inside fp64's range, so the extended
// exponent of the TPU kernels is not needed there. The fast mode keeps the
// plain fp32 recurrence of _fast_step with its 2^-30 rescale and its e
// weighting (1, 2^-30, 0).
//
// Bound: operations. Per live step, the recurrence (two FMAs and a
// multiply: 5 fp64 operations) and, per map, the complex contraction (two
// FMAs: 4 operations); the bytes (tables, G or a, the output) are read or
// written once, ~0.2 GB at lmax 2047.
//
// Design.
// * One block per m column (B10a) or per (m, ring tile) (B10s), TT = 256
//   threads, one ring per thread. The per-(l, m) tables are one broadcast
//   load per warp; the ring's x and seeds stay in registers.
// * Loop bounds per (m, ring tile) from the host (_bounds_table): chunks of
//   LC = 8 l-steps from the tile's first captured l_s to one past the last
//   live chunk (zero chunks for the dead tiles below the turning point).
// * Fold (north-south symmetric grids, spin 0): the rings are the northern
//   half. B10a contracts S0 on even l and S1 on odd l (the wrapper's
//   _fold_G); B10s keeps even-l and odd-l accumulators and writes
//   north = E + O, south = (-1)^m (E - O).
// * B10a's reduction over rings: CUDA blocks run in no order, so one block
//   owns a whole m column and walks its ring tiles in order, adding each
//   tile's sums into the fp64 output (no atomics). Per chunk the block
//   stages the 8 Lambda rows of its tile in shared memory, then each output
//   (l, map, re/im) is 16 partial dot products over the rings t = s mod 16
//   and one sum of the partials in a fixed order: the order depends on
//   nothing but the ring count, so two runs, and a map alone or in a
//   packed launch, give the same bits.
// * B10s holds NB maps' accumulators in registers (fp64 by default, fp32
//   in the fast mode), the a rows read as broadcasts; maps beyond NB loop
//   over launches in the wrapper. Each map's arithmetic is the same in any
//   launch, so a map's result is bit-equal alone or packed.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TT = 256;   // rings per tile = threads per block
constexpr int LC = 8;     // l-steps per chunk
constexpr int NP = 16;    // partial sums per B10a output
constexpr int MAXB = 8;   // maps per launch
constexpr float kThresh = 32768.0f;                 // 2^15
constexpr float kInv = 9.313225746154785e-10f;      // 2^-30

struct Tabs {
  const void* A;        // (Lp, M1) R
  const void* B;
  const void* C;
  const void* x;        // (Tk) R
  const void* s1;       // (M1, Tk) R: Lambda_{l_s} (fast: mantissa)
  const void* s0;       // (M1, Tk) R: Lambda_{l_s - 1}
  const int* se;        // (M1, Tk) exponent of the fast mantissas
  const int* ls;        // (M1, Tk) captured l_s, -1: never
  const int* bounds;    // (3 M1, njt) first chunk, one past the last, -
  int M1, Lp, Tk, njt;
};

__device__ inline double madd(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ inline float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}

// Lane state of the recurrence: value pair and (fast) exponent.
template <typename R>
struct Lane {
  R p, c, s1, s0, x;
  int e, se, ls;
};

template <typename R>
__device__ inline void lane_init(Lane<R>& ln, const Tabs& tb, int m, int t,
                                 bool valid) {
  const int64_t i = static_cast<int64_t>(m) * tb.Tk + t;
  ln.p = R(0);
  ln.c = R(0);
  ln.e = 0;
  ln.x = valid ? static_cast<const R*>(tb.x)[t] : R(0);
  ln.s1 = valid ? static_cast<const R*>(tb.s1)[i] : R(0);
  ln.s0 = valid ? static_cast<const R*>(tb.s0)[i] : R(0);
  ln.se = valid ? tb.se[i] : 0;
  ln.ls = valid ? tb.ls[i] : -1;
}

// One l-step; returns the weighted Lambda_l.
__device__ inline double lane_step(Lane<double>& ln, double a, double b,
                                   double c, int l) {
  double nv = fma(fma(a, ln.x, b), ln.c, c * ln.p);
  double pv = ln.c;
  if (l == ln.ls) {
    nv = ln.s1;
    pv = ln.s0;
  }
  ln.p = pv;
  ln.c = nv;
  return nv;
}

__device__ inline float lane_step(Lane<float>& ln, float a, float b,
                                  float c, int l) {
  float nv = fmaf(fmaf(a, ln.x, b), ln.c, c * ln.p);
  float pv = ln.c;
  if (l == ln.ls) {
    nv = ln.s1;
    pv = ln.s0;
    ln.e = ln.se;
  }
  if (fabsf(nv) > kThresh && ln.e > 0) {
    nv *= kInv;
    pv *= kInv;
    ln.e -= 1;
  }
  ln.p = pv;
  ln.c = nv;
  return ln.e == 0 ? nv : (ln.e == 1 ? nv * kInv : 0.0f);
}

// B10a. G: (M1, nmaps, K, Tk) with K = 4 (S0 re, S0 im, S1 re, S1 im) when
// folded, else 2 (re, im); out: (M1, Lp, nmaps, 2) fp64, zeroed by the
// caller, accumulated over the ring tiles in order.
template <typename TI, typename R, bool FOLD>
__global__ void __launch_bounds__(TT)
ana_kernel(Tabs tb, const TI* __restrict__ G, double* __restrict__ out,
           int nmaps) {
  constexpr int K = FOLD ? 4 : 2;
  constexpr int GS = TT + 1;            // padded ring row of the staged G
  extern __shared__ double smem[];
  double* lam = smem;                   // [LC][TT]
  double* gs = lam + LC * TT;           // [nmaps K][GS]
  double* part = gs + nmaps * K * GS;   // [nout][NP + 1]
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int nout = LC * nmaps * 2;
  const R* A = static_cast<const R*>(tb.A);
  const R* B = static_cast<const R*>(tb.B);
  const R* C = static_cast<const R*>(tb.C);
  const TI* gm = G + static_cast<int64_t>(m) * nmaps * K * tb.Tk;
  double* om = out + static_cast<int64_t>(m) * tb.Lp * nmaps * 2;

  for (int jt = 0; jt < tb.njt; ++jt) {
    const int lo = tb.bounds[m * tb.njt + jt];
    const int hi = tb.bounds[(tb.M1 + m) * tb.njt + jt];
    if (lo >= hi) continue;             // uniform over the block
    const int t = jt * TT + tid;
    const bool valid = t < tb.Tk;
    Lane<R> ln;
    lane_init(ln, tb, m, t, valid);
    __syncthreads();                    // the previous tile's reads are done
    for (int i = tid; i < nmaps * K * TT; i += TT) {
      const int row = i / TT, tt = i % TT, tg = jt * TT + tt;
      gs[row * GS + tt] = tg < tb.Tk
          ? static_cast<double>(gm[static_cast<int64_t>(row) * tb.Tk + tg])
          : 0.0;
    }
    for (int ch = lo; ch < hi; ++ch) {
      const int l0 = ch * LC;
#pragma unroll
      for (int j = 0; j < LC; ++j) {
        const int64_t ti = static_cast<int64_t>(l0 + j) * tb.M1 + m;
        const double w = static_cast<double>(
            lane_step(ln, A[ti], B[ti], C[ti], l0 + j));
        lam[j * TT + tid] = valid ? w : 0.0;
      }
      __syncthreads();
      for (int q = tid; q < nout * NP; q += TT) {
        const int o = q / NP, s = q % NP;
        const int j = o / (2 * nmaps), r = o % (2 * nmaps);
        const int k = FOLD ? (((l0 + j) & 1) * 2 + (r & 1)) : (r & 1);
        const double* gr = gs + ((r >> 1) * K + k) * GS;
        const double* lr = lam + j * TT;
        double acc = 0.0;
#pragma unroll
        for (int i = 0; i < TT / NP; ++i)
          acc = fma(lr[s + NP * i], gr[s + NP * i], acc);
        part[o * (NP + 1) + s] = acc;
      }
      __syncthreads();
      for (int o = tid; o < nout; o += TT) {
        double acc = 0.0;
#pragma unroll
        for (int s = 0; s < NP; ++s) acc += part[o * (NP + 1) + s];
        const int j = o / (2 * nmaps), r = o % (2 * nmaps);
        om[(static_cast<int64_t>(l0 + j) * nmaps + (r >> 1)) * 2 + (r & 1)]
            += acc;
      }
      // the next chunk writes lam only, which nothing reads after the
      // partial loop's barrier; part is rewritten after the next barrier
    }
  }
}

// B10s. a: (M1, Lp, nmaps, 2) TI; out: (M1, nmaps, H, 2, Tk) TI with
// H = 2 (north, south) when folded, else 1. Grid (M1, njt).
template <typename TI, typename R, bool FOLD, int NB>
__global__ void __launch_bounds__(TT)
syn_kernel(Tabs tb, const TI* __restrict__ a, TI* __restrict__ out,
           int nmaps) {
  const int m = blockIdx.x;
  const int jt = blockIdx.y;
  const int t = jt * TT + threadIdx.x;
  const bool valid = t < tb.Tk;
  const int lo = tb.bounds[m * tb.njt + jt];
  const int hi = tb.bounds[(tb.M1 + m) * tb.njt + jt];
  const R* A = static_cast<const R*>(tb.A);
  const R* B = static_cast<const R*>(tb.B);
  const R* C = static_cast<const R*>(tb.C);
  const TI* am = a + static_cast<int64_t>(m) * tb.Lp * nmaps * 2;
  Lane<R> ln;
  lane_init(ln, tb, m, t, valid);
  R accE[NB][2], accO[NB][2];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    accE[b][0] = accE[b][1] = R(0);
    accO[b][0] = accO[b][1] = R(0);
  }
  for (int ch = lo; ch < hi; ++ch) {
    const int l0 = ch * LC;
#pragma unroll
    for (int j = 0; j < LC; ++j) {
      const int l = l0 + j;
      const int64_t ti = static_cast<int64_t>(l) * tb.M1 + m;
      const R w = lane_step(ln, A[ti], B[ti], C[ti], l);
      const TI* ar = am + static_cast<int64_t>(l) * nmaps * 2;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < nmaps) {
          const R re = static_cast<R>(ar[2 * b]);
          const R im = static_cast<R>(ar[2 * b + 1]);
          if (FOLD && (j & 1)) {
            accO[b][0] = madd(w, re, accO[b][0]);
            accO[b][1] = madd(w, im, accO[b][1]);
          } else {
            accE[b][0] = madd(w, re, accE[b][0]);
            accE[b][1] = madd(w, im, accE[b][1]);
          }
        }
      }
    }
  }
  if (!valid) return;
  constexpr int H = FOLD ? 2 : 1;
  const R sg = (m & 1) ? R(-1) : R(1);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b < nmaps) {
      TI* ob = out + (static_cast<int64_t>(m) * nmaps + b) * H * 2 * tb.Tk;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (FOLD) {
          ob[c * tb.Tk + t] = static_cast<TI>(accE[b][c] + accO[b][c]);
          ob[(2 + c) * tb.Tk + t] =
              static_cast<TI>(sg * (accE[b][c] - accO[b][c]));
        } else {
          ob[c * tb.Tk + t] = static_cast<TI>(accE[b][c]);
        }
      }
    }
  }
}

template <typename TI, typename R, bool FOLD>
int launch_ana(const Tabs& tb, const void* G, double* out, int nmaps,
               cudaStream_t st) {
  constexpr int K = FOLD ? 4 : 2;
  const int smem = static_cast<int>(sizeof(double)) *
      (LC * TT + nmaps * K * (TT + 1) + LC * 2 * nmaps * (NP + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ana_kernel<TI, R, FOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ana_kernel<TI, R, FOLD><<<tb.M1, TT, smem, st>>>(
      tb, static_cast<const TI*>(G), out, nmaps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename R, bool FOLD, int NB>
int launch_syn_nb(const Tabs& tb, const void* a, void* out, int nmaps,
                  cudaStream_t st) {
  syn_kernel<TI, R, FOLD, NB><<<dim3(tb.M1, tb.njt), TT, 0, st>>>(
      tb, static_cast<const TI*>(a), static_cast<TI*>(out), nmaps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename R, bool FOLD>
int launch_syn(const Tabs& tb, const void* a, void* out, int nmaps, int nb,
               cudaStream_t st) {
  switch (nb) {
    case 1: return launch_syn_nb<TI, R, FOLD, 1>(tb, a, out, nmaps, st);
    case 2: return launch_syn_nb<TI, R, FOLD, 2>(tb, a, out, nmaps, st);
    case 4: return launch_syn_nb<TI, R, FOLD, 4>(tb, a, out, nmaps, st);
    case 8: return launch_syn_nb<TI, R, FOLD, 8>(tb, a, out, nmaps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int M1, int Lp, int Tk, int njt, int nmaps) {
  return M1 < 1 || Lp < LC || Lp % LC || Tk < 1 || njt < 1
      || njt * TT < Tk || njt > 65535 || nmaps < 1 || nmaps > MAXB;
}

}  // namespace

extern "C" {

// B10a. Tables (A, B, C, x, s1, s0) are fp32 when fast, else fp64; G is
// (M1, nmaps, K, Tk) fp64 when f64, else fp32; out (M1, Lp, nmaps, 2) fp64
// zeroed. fast is ignored for fp64 inputs.
int legendre_ana_launch(const void* A, const void* B, const void* C,
                        const void* x, const void* s1, const void* s0,
                        const int* se, const int* ls, const int* bounds,
                        const void* G, double* out, int M1, int Lp, int Tk,
                        int njt, int nmaps, int fold, int fast, int f64,
                        void* stream) {
  if (bad_shape(M1, Lp, Tk, njt, nmaps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tabs tb{A, B, C, x, s1, s0, se, ls, bounds, M1, Lp, Tk, njt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return fold ? launch_ana<double, double, true>(tb, G, out, nmaps, st)
                : launch_ana<double, double, false>(tb, G, out, nmaps, st);
  if (fast)
    return fold ? launch_ana<float, float, true>(tb, G, out, nmaps, st)
                : launch_ana<float, float, false>(tb, G, out, nmaps, st);
  return fold ? launch_ana<float, double, true>(tb, G, out, nmaps, st)
              : launch_ana<float, double, false>(tb, G, out, nmaps, st);
}

// B10s. a: (M1, Lp, nmaps, 2), out: (M1, nmaps, fold ? 2 : 1, 2, Tk), both
// fp64 when f64, else fp32; nb in {1, 2, 4, 8}, nb >= nmaps.
int legendre_syn_launch(const void* A, const void* B, const void* C,
                        const void* x, const void* s1, const void* s0,
                        const int* se, const int* ls, const int* bounds,
                        const void* a, void* out, int M1, int Lp, int Tk,
                        int njt, int nmaps, int nb, int fold, int fast,
                        int f64, void* stream) {
  if (bad_shape(M1, Lp, Tk, njt, nmaps) || nb < nmaps)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tabs tb{A, B, C, x, s1, s0, se, ls, bounds, M1, Lp, Tk, njt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return fold ? launch_syn<double, double, true>(tb, a, out, nmaps, nb, st)
                : launch_syn<double, double, false>(tb, a, out, nmaps, nb,
                                                    st);
  if (fast)
    return fold ? launch_syn<float, float, true>(tb, a, out, nmaps, nb, st)
                : launch_syn<float, float, false>(tb, a, out, nmaps, nb, st);
  return fold ? launch_syn<float, double, true>(tb, a, out, nmaps, nb, st)
              : launch_syn<float, double, false>(tb, a, out, nmaps, nb, st);
}

}  // extern "C"
