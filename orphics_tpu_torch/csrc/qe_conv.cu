// The filter algebra of the generic quadratic estimator around cuFFT
// (models/qe.py: QE.unnormalized_phi and QE.kappa_from_map), as three
// elementwise kernels:
//
//   qe_leg_kernel:  leg_k[b, n] = plane_k[n] * src[b, n]              (k < nlegs)
//   qe_pair_kernel: S_i[b, n] = prev_i[b, n]
//                             + sum_{j: comp_j = i} c_j leg_pj[b, n] leg_qj[b, n]
//   qe_post_kernel: out[b, n] = post_0[n] F_0[b, n] + post_1[n] F_1[b, n]
//
// for i in {0, 1} (the L_y and L_x components). The engine's plan folds into
// the real leg planes everything before the inverse transforms (the filter
// weights, the angle factors, one L_i, the "phys" scale and the inverse's
// 1/N, so that cuFFT's inverse runs unscaled), into the real coefficients
// c_j the merges of proportional legs and the signs of the terms, and into
// the two post planes everything after the forward transforms (L_i, the
// convolution's npix/area, A_L, kmask and the kappa convention). A leg of
// batch 1 pairs with legs of batch B (stride 0): rdn0's data leg.
//
// Replaces no TPU kernel: the JAX package runs this algebra as XLA's
// elementwise operations around jnp.fft (orphics_tpu/models/qe.py:61-65,
// QE.unnormalized_phi), which XLA fuses on the TPU. PyTorch runs each
// operation as its own pass over device memory, 20 and more full-plane
// passes a TT reconstruction; these kernels are the fusion XLA made.
//
// Bound: device memory. Complex elements of 8 B (float) or 16 B (double):
// the leg kernel reads the source once and writes nlegs legs (the planes,
// nlegs * 4 B a pixel, are read once a thread for BCH batch rows); the pair
// kernel reads nlegs legs (and the previous sums) and writes two sums; the
// post kernel reads two spectra and writes one.
//
// Design: one thread a complex element, 8-byte (16-byte) loads and stores
// that a warp makes contiguous. The leg and post kernels keep a pixel's
// plane values in registers and walk BCH batch rows (blockIdx.y picks the
// rows). The pair kernel loads each leg once into its thread's column of
// shared memory, which the product loop then indexes at run time (a
// register array indexed at run time would go to local memory); a thread
// reads only its own column, so no barrier is needed. The product table
// lives in the kernel's parameters: every thread of the grid walks it in
// the same order, and the sums run in that order on every run.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAXL = 8;   // legs a launch takes
constexpr int MAXP = 32;  // products a pair launch takes
constexpr int BCH = 8;    // batch rows a thread of the leg and post kernels walks

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

struct LegParams {
  const void* src;     // (batch, npix) complex
  const void* planes;  // (nlegs, npix) real
  void* out[MAXL];     // nlegs x (batch, npix) complex
  int nlegs;
  int batch;
  long long npix;
};

struct PairParams {
  const void* legs[MAXL];   // (batch or 1, npix) complex
  long long stride[MAXL];   // elements between a leg's batch rows: npix or 0
  const void* prev[2];      // (batch, npix) complex, or null: the sums start at 0
  void* out[2];             // (batch, npix) complex
  double c[MAXP];
  int comp[MAXP];
  int p[MAXP];
  int q[MAXP];
  int nlegs;
  int nprod;
  long long npix;
};

struct PostParams {
  const void* f[2];   // (batch, npix) complex
  const void* post;   // (2, npix) real
  void* out;          // (batch, npix) complex
  int batch;
  long long npix;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) qe_leg_kernel(LegParams a) {
  using C = typename Cplx<T>::type;
  const long long n = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (n >= a.npix) return;
  const T* planes = static_cast<const T*>(a.planes);
  T w[MAXL];
#pragma unroll
  for (int k = 0; k < MAXL; ++k)
    w[k] = k < a.nlegs ? __ldg(planes + k * a.npix + n) : T(0);
  const C* src = static_cast<const C*>(a.src);
  const int b0 = blockIdx.y * BCH;
  const int b1 = min(b0 + BCH, a.batch);
  for (int b = b0; b < b1; ++b) {
    const long long e = static_cast<long long>(b) * a.npix + n;
    const C x = __ldg(src + e);
#pragma unroll
    for (int k = 0; k < MAXL; ++k) {
      if (k < a.nlegs) {
        C y;
        y.x = w[k] * x.x;
        y.y = w[k] * x.y;
        static_cast<C*>(a.out[k])[e] = y;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) qe_pair_kernel(PairParams a) {
  using C = typename Cplx<T>::type;
  __shared__ C col[MAXL][THREADS];
  const long long n = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (n >= a.npix) return;
  const long long b = blockIdx.y;
#pragma unroll
  for (int k = 0; k < MAXL; ++k)
    if (k < a.nlegs)
      col[k][threadIdx.x] =
          __ldg(static_cast<const C*>(a.legs[k]) + b * a.stride[k] + n);
  const long long e = b * a.npix + n;
  C s0, s1;
  s0.x = s0.y = s1.x = s1.y = T(0);
  if (a.prev[0]) s0 = __ldg(static_cast<const C*>(a.prev[0]) + e);
  if (a.prev[1]) s1 = __ldg(static_cast<const C*>(a.prev[1]) + e);
  for (int j = 0; j < a.nprod; ++j) {
    const C u = col[a.p[j]][threadIdx.x];
    const C v = col[a.q[j]][threadIdx.x];
    const T c = static_cast<T>(a.c[j]);
    const T re = c * (u.x * v.x - u.y * v.y);
    const T im = c * (u.x * v.y + u.y * v.x);
    if (a.comp[j] == 0) {
      s0.x += re;
      s0.y += im;
    } else {
      s1.x += re;
      s1.y += im;
    }
  }
  static_cast<C*>(a.out[0])[e] = s0;
  static_cast<C*>(a.out[1])[e] = s1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) qe_post_kernel(PostParams a) {
  using C = typename Cplx<T>::type;
  const long long n = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (n >= a.npix) return;
  const T* post = static_cast<const T*>(a.post);
  const T w0 = __ldg(post + n);
  const T w1 = __ldg(post + a.npix + n);
  const C* f0 = static_cast<const C*>(a.f[0]);
  const C* f1 = static_cast<const C*>(a.f[1]);
  C* out = static_cast<C*>(a.out);
  const int b0 = blockIdx.y * BCH;
  const int b1 = min(b0 + BCH, a.batch);
  for (int b = b0; b < b1; ++b) {
    const long long e = static_cast<long long>(b) * a.npix + n;
    const C x = __ldg(f0 + e);
    const C y = __ldg(f1 + e);
    C z;
    z.x = w0 * x.x + w1 * y.x;
    z.y = w0 * x.y + w1 * y.y;
    out[e] = z;
  }
}

dim3 grid_of(long long npix, int rows) {
  return dim3(static_cast<unsigned>((npix + THREADS - 1) / THREADS), rows);
}

bool bad_shape(int batch, long long npix) {
  return batch < 1 || npix < 1 || (npix + THREADS - 1) / THREADS > 0x7fffffffLL;
}

}  // namespace

extern "C" {

int qe_conv_max_legs() { return MAXL; }
int qe_conv_max_products() { return MAXP; }

// src (batch, npix) complex, planes (nlegs, npix) real, outs a host array of
// nlegs device pointers, each (batch, npix) complex; dbl: double precision.
int qe_leg_launch(const void* src, const void* planes, void* const* outs,
                  int nlegs, int batch, long long npix, int dbl,
                  void* stream) {
  if (nlegs < 1 || nlegs > MAXL || bad_shape(batch, npix))
    return static_cast<int>(cudaErrorInvalidValue);
  LegParams a{};
  a.src = src;
  a.planes = planes;
  for (int k = 0; k < nlegs; ++k) a.out[k] = outs[k];
  a.nlegs = nlegs;
  a.batch = batch;
  a.npix = npix;
  const int rows = (batch + BCH - 1) / BCH;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(npix, rows);
  auto s = static_cast<cudaStream_t>(stream);
  if (dbl)
    qe_leg_kernel<double><<<grid, THREADS, 0, s>>>(a);
  else
    qe_leg_kernel<float><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// legs: host array of nlegs device pointers, strides their batch strides in
// elements (npix, or 0 for a leg of batch 1); comp, p, q, c: host arrays of
// nprod products; prev0/prev1 null or (batch, npix); out0/out1 (batch, npix).
int qe_pair_launch(const void* const* legs, const long long* strides,
                   int nlegs, const int* comp, const int* p, const int* q,
                   const double* c, int nprod, const void* prev0,
                   const void* prev1, void* out0, void* out1, int batch,
                   long long npix, int dbl, void* stream) {
  if (nlegs < 1 || nlegs > MAXL || nprod < 1 || nprod > MAXP ||
      bad_shape(batch, npix) || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  PairParams a{};
  for (int k = 0; k < nlegs; ++k) {
    a.legs[k] = legs[k];
    a.stride[k] = strides[k];
  }
  for (int j = 0; j < nprod; ++j) {
    if (p[j] < 0 || p[j] >= nlegs || q[j] < 0 || q[j] >= nlegs ||
        (comp[j] != 0 && comp[j] != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    a.comp[j] = comp[j];
    a.p[j] = p[j];
    a.q[j] = q[j];
    a.c[j] = c[j];
  }
  a.prev[0] = prev0;
  a.prev[1] = prev1;
  a.out[0] = out0;
  a.out[1] = out1;
  a.nlegs = nlegs;
  a.nprod = nprod;
  a.npix = npix;
  const dim3 grid = grid_of(npix, batch);
  auto s = static_cast<cudaStream_t>(stream);
  if (dbl)
    qe_pair_kernel<double><<<grid, THREADS, 0, s>>>(a);
  else
    qe_pair_kernel<float><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// f0, f1, out (batch, npix) complex; post (2, npix) real.
int qe_post_launch(const void* f0, const void* f1, const void* post,
                   void* out, int batch, long long npix, int dbl,
                   void* stream) {
  if (bad_shape(batch, npix)) return static_cast<int>(cudaErrorInvalidValue);
  PostParams a{};
  a.f[0] = f0;
  a.f[1] = f1;
  a.post = post;
  a.out = out;
  a.batch = batch;
  a.npix = npix;
  const int rows = (batch + BCH - 1) / BCH;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(npix, rows);
  auto s = static_cast<cudaStream_t>(stream);
  if (dbl)
    qe_post_kernel<double><<<grid, THREADS, 0, s>>>(a);
  else
    qe_post_kernel<float><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
