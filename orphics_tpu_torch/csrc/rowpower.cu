// Fused row passes of the half-plane power pipeline (kernels B6 and B4b of
// the port).
//
// For Y, (batch, N, N) re/im fp32 planes with rows in row_perm order (the
// column-DFT intermediate), let Z = rowfft(Y) in the doubly-permuted
// layout and Zm[p, q] = Z[mrow p, mrow q] its mirror Z(-k).
//
//   B6 (rowqc_half): over the compact half plane, rows p = 128 (h / 64) +
//      h % 64 for h < N / 2 (dft.py:half_rows),
//        qs[b, h, q] = (|Z[p, q]|^2 + |Zm[p, q]|^2) / 2
//        c[b, h, q]  = Re(Z[p, q] Zm[p, q])
//   B4b (rowfft_blk0): the permuted columns [0, 128) (k2 = 0) of rowfft(Y):
//        out[r, k1] = sum_a (sum_b y[r, a + 128 b]) w_128^(a k1)
//
// Replaces orphics_tpu/ops/pallas_fft.py:rowqc_pp (_row_qc_kernel) and
// :rowfft_blk0 (_rowfft_blk0_kernel).
//
// Bound: device memory. B6 reads each row of Y about once (a half row and
// its mirror row are transformed by the same block; the ky = N/2 row by
// none) and writes two half planes: 16 B in and 8 B out per element of Y,
// against ~10 log2 N flops; the full Fourier plane never reaches device
// memory. B4b reads all of Y (8 B per element) and writes 1/Bk of it.
//
// Design: B6 runs one block per (batch entry, half row h). The block loads
// row p and its mirror row mrow[p] into shared memory (2 N complex values,
// 32 KB at N = 2048), runs dft_core.cuh's forward transform on both, and
// writes qs and c for every column q, pairing Z[p, q] with the mirror
// row's value at mrow[q]. mrow is the exact Z(-k) map (dft_core.cuh:
// mirror_pos), so no row or column needs the TPU kernel's wrap-strip
// special case; rowpower.py still patches the two strips from B4 and B4b,
// as the JAX function does. B4b sums the Bk blocks of each row (stage 1 at
// k2 = 0, whose weights are all 1) and runs one 128-point FFT per row,
// T0 rows per block; its output equals rowfft's columns [0, 128).
#include <cuda_runtime.h>
#include <cstdint>

#include "dft_core.cuh"

namespace {

constexpr int T0 = 16;  // rows per B4b block

template <int MAXBK>
__global__ void __launch_bounds__(THREADS)
row_qc_kernel(const float* __restrict__ yre, const float* __restrict__ yim,
              const float2* __restrict__ tab, float* __restrict__ qs,
              float* __restrict__ cc, int N, int Bk) {
  extern __shared__ float2 s[];  // [2][N]: row p, then its mirror row
  const Tables tb = tables(tab, Bk);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p = A * (h / 64) + h % 64;
  const int pm = mirror_pos(p, Bk);
  const int64_t plane = static_cast<int64_t>(b) * N * N;
  for (int e = threadIdx.x; e < 2 * N; e += THREADS) {
    const int t = e % N;
    const int64_t g = plane + static_cast<int64_t>(e < N ? p : pm) * N + t;
    s[e] = make_float2(yre[g], yim[g]);
  }
  __syncthreads();
  fwd_stage1<true, MAXBK>(s, tb, N, Bk, 2);
  __syncthreads();
  fft128_dif<true>(s, tb, N, Bk, 2);
  const int64_t o = (static_cast<int64_t>(b) * (N / 2) + h) * N;
  for (int q = threadIdx.x; q < N; q += THREADS) {
    const float2 z = s[out_slot<true>(q, 0, N, 2)];
    const float2 m = s[out_slot<true>(mirror_pos(q, Bk), 1, N, 2)];
    qs[o + q] = 0.5f * (z.x * z.x + z.y * z.y + m.x * m.x + m.y * m.y);
    cc[o + q] = z.x * m.x - z.y * m.y;
  }
}

__global__ void __launch_bounds__(THREADS)
rowfft_blk0_kernel(const float* __restrict__ yre,
                   const float* __restrict__ yim,
                   const float2* __restrict__ tab, float* __restrict__ ore,
                   float* __restrict__ oim, int M, int N, int Bk) {
  __shared__ float2 s[T0 * A];
  const Tables tb = tables(tab, Bk);
  const int r0 = blockIdx.x * T0;
  for (int i = threadIdx.x; i < A * T0; i += THREADS) {
    const int a = i % A;
    const int r = i / A;
    float2 g = make_float2(0.0f, 0.0f);
    if (r0 + r < M) {
      const int64_t row = static_cast<int64_t>(r0 + r) * N + a;
      for (int k = 0; k < Bk; ++k) {
        g.x += yre[row + A * k];
        g.y += yim[row + A * k];
      }
    }
    s[i] = g;
  }
  __syncthreads();
  fft128_dif<true>(s, tb, A, 1, T0);
  for (int i = threadIdx.x; i < A * T0; i += THREADS) {
    const int r = i / A;
    if (r0 + r >= M) continue;
    const float2 v = s[out_slot<true>(i % A, r, A, T0)];
    const int64_t g = static_cast<int64_t>(r0) * A + i;
    ore[g] = v.x;
    oim[g] = v.y;
  }
}

template <int MAXBK>
int launch_qc(const float* yre, const float* yim, const float2* tab,
              float* qs, float* cc, int batch, int N, int Bk,
              cudaStream_t stream) {
  const int smem = 2 * N * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      row_qc_kernel<MAXBK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_qc_kernel<MAXBK><<<dim3(N / 2, batch), THREADS, smem, stream>>>(
      yre, yim, tab, qs, cc, N, Bk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B6: yre, yim (batch, n, n) f32; qs, cc (batch, n/2, n) f32; tab:
// dft.py:_tables(n, forward).
int rowqc_half_launch(const float* yre, const float* yim, const void* tab,
                      float* qs, float* cc, int batch, int n, void* stream) {
  const int Bk = n / A;
  if (Bk * A != n || Bk < 2 || Bk > 32 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* tb = static_cast<const float2*>(tab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Bk <= 4) return launch_qc<4>(yre, yim, tb, qs, cc, batch, n, Bk, st);
  if (Bk <= 8) return launch_qc<8>(yre, yim, tb, qs, cc, batch, n, Bk, st);
  if (Bk <= 16) return launch_qc<16>(yre, yim, tb, qs, cc, batch, n, Bk, st);
  return launch_qc<32>(yre, yim, tb, qs, cc, batch, n, Bk, st);
}

// B4b: yre, yim (rows, n) f32 (any leading shape flattened); ore, oim
// (rows, 128) f32; tab: dft.py:_tables(n, forward).
int rowfft_blk0_launch(const float* yre, const float* yim, const void* tab,
                       float* ore, float* oim, int rows, int n,
                       void* stream) {
  const int Bk = n / A;
  if (Bk * A != n || Bk < 2 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rowfft_blk0_kernel<<<(rows + T0 - 1) / T0, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      yre, yim, static_cast<const float2*>(tab), ore, oim, rows, n, Bk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
