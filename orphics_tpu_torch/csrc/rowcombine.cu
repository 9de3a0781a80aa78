// Fused row DFT and Hermitian weighted band combine (kernel B9 of the
// port): the ILC coadd of packed band pairs without per-band Fourier
// planes in device memory.
//
// For Y, (ncoadds nq, N, N) re/im fp32 column-DFT intermediates with rows
// in row_perm order (pair j = coadd nq + q), let Z_j = rowfft(Y_j) in the
// doubly-permuted layout and Zm_j[p, t] = Z_j[mrow p, mrow t] = Z_j(-k).
// With (nq, N, N) weight planes alpha = alr + i ali, beta = ber + i bei in
// the same layout,
//
//   C[c] = sum_q alpha_q o Z_{c nq + q} + beta_q o conj(Zm_{c nq + q})
//
// written once as (ncoadds, N, N) re/im planes.
//
// Replaces orphics_tpu/ops/pallas_fft.py:rowcombine_pp (_row_combine_kernel
// and the wrap-strip patches after it). The TPU kernel transforms 64-row
// tiles, forms the mirror by an in-register reversal that is wrong on the
// k2 = 0 strips, and accumulates over q in its output block across the
// sequential grid; JAX then patches the strips from partial DFTs.
//
// Bound: device memory. Each pair plane is read once (8 B per element),
// the weights (16 B per element and q) are read by every coadd but stay in
// L2 (12 MB at N = 512, nq = 3), and each coadd plane is written once (8 B
// per element), against ~10 log2 N flops per element of Y.
//
// Design: one block per (coadd, row p with its mirror row mrow[p]). The
// rows of the half plane (dft.py:half_rows) and their mirrors cover every
// row once; rows 0 and 64 (ky = 0 and ky = N/2) are their own mirror and
// take a one-row block. For q = 0 .. nq-1 in that order the block loads
// both rows of pair c nq + q into shared memory (2 N complex values, 8 KB
// at N = 512), runs dft_core.cuh's forward transform on them, and adds
// alpha o Z + beta o conj(Zm) for both rows into registers; the mirror
// (mirror_pos) is exact on every row and column, so no strip needs a
// patch. Each thread owns fixed columns, and the q order is fixed, so the
// sums repeat bit for bit. The coadd rows are stored after the last q.
#include <cuda_runtime.h>
#include <cstdint>

#include "dft_core.cuh"

namespace {

template <int MAXBK>
__global__ void __launch_bounds__(THREADS)
row_combine_kernel(const float* __restrict__ yre,
                   const float* __restrict__ yim,
                   const float* __restrict__ alr,
                   const float* __restrict__ ali,
                   const float* __restrict__ ber,
                   const float* __restrict__ bei,
                   const float2* __restrict__ tab, float* __restrict__ cre,
                   float* __restrict__ cim, int N, int Bk, int nq) {
  constexpr int K = MAXBK * A / THREADS;  // columns per thread, at most
  extern __shared__ float2 s[];           // [nrow][N]: row p, mirror row
  const Tables tb = tables(tab, Bk);
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int p = h < N / 2 ? A * (h / 64) + h % 64 : 64;
  const int pm = mirror_pos(p, Bk);
  const int nrow = pm == p ? 1 : 2;
  const int64_t plane = static_cast<int64_t>(N) * N;
  const int64_t off[2] = {static_cast<int64_t>(p) * N,
                          static_cast<int64_t>(pm) * N};

  float2 acc[2][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[0][k] = make_float2(0.0f, 0.0f);
    acc[1][k] = acc[0][k];
  }

  for (int q = 0; q < nq; ++q) {
    const int64_t src = (static_cast<int64_t>(c) * nq + q) * plane;
    for (int e = threadIdx.x; e < nrow * N; e += THREADS) {
      const int64_t g = src + off[e / N] + e % N;
      s[e] = make_float2(yre[g], yim[g]);
    }
    __syncthreads();
    fwd_stage1<true, MAXBK>(s, tb, N, Bk, nrow);
    __syncthreads();
    fft128_dif<true>(s, tb, N, Bk, nrow);
    const int64_t wq = static_cast<int64_t>(q) * plane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = threadIdx.x + k * THREADS;
      if (t < N) {
        const int tm = mirror_pos(t, Bk);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r >= nrow) break;
          const float2 z = s[out_slot<true>(t, r, N, nrow)];
          const float2 m = s[out_slot<true>(tm, nrow - 1 - r, N, nrow)];
          const int64_t w = wq + off[r] + t;
          const float ar = alr[w], ai = ali[w], br = ber[w], bi = bei[w];
          acc[r][k].x += ar * z.x - ai * z.y + br * m.x + bi * m.y;
          acc[r][k].y += ar * z.y + ai * z.x + bi * m.x - br * m.y;
        }
      }
    }
    __syncthreads();
  }

  const int64_t dst = static_cast<int64_t>(c) * plane;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = threadIdx.x + k * THREADS;
    if (t < N) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r >= nrow) break;
        cre[dst + off[r] + t] = acc[r][k].x;
        cim[dst + off[r] + t] = acc[r][k].y;
      }
    }
  }
}

template <int MAXBK>
int launch(const float* yre, const float* yim, const float* alr,
           const float* ali, const float* ber, const float* bei,
           const float2* tab, float* cre, float* cim, int ncoadds, int N,
           int Bk, int nq, cudaStream_t stream) {
  const int smem = 2 * N * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      row_combine_kernel<MAXBK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_combine_kernel<MAXBK><<<dim3(N / 2 + 1, ncoadds), THREADS, smem,
                              stream>>>(yre, yim, alr, ali, ber, bei, tab,
                                        cre, cim, N, Bk, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B9: yre, yim (ncoadds nq, n, n) f32; alr, ali, ber, bei (nq, n, n) f32;
// cre, cim (ncoadds, n, n) f32; tab: dft.py:_tables(n, forward).
int rowcombine_launch(const float* yre, const float* yim, const float* alr,
                      const float* ali, const float* ber, const float* bei,
                      const void* tab, float* cre, float* cim, int ncoadds,
                      int n, int nq, void* stream) {
  const int Bk = n / A;
  if (Bk * A != n || Bk < 2 || Bk > 32 || ncoadds < 1 || ncoadds > 65535
      || nq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* tb = static_cast<const float2*>(tab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Bk <= 4)
    return launch<4>(yre, yim, alr, ali, ber, bei, tb, cre, cim, ncoadds, n,
                     Bk, nq, st);
  if (Bk <= 8)
    return launch<8>(yre, yim, alr, ali, ber, bei, tb, cre, cim, ncoadds, n,
                     Bk, nq, st);
  if (Bk <= 16)
    return launch<16>(yre, yim, alr, ali, ber, bei, tb, cre, cim, ncoadds,
                      n, Bk, nq, st);
  return launch<32>(yre, yim, alr, ali, ber, bei, tb, cre, cim, ncoadds, n,
                    Bk, nq, st);
}

}  // extern "C"
