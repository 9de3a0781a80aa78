// Column and row DFTs of re/im fp32 planes in the doubly-permuted ("pp")
// layout (kernels B3, B3s, B4 and B5 of the port).
//
//   forward:  X[k] = sum_n x[n] w_N^(n k),  w_N = exp(-2 pi i / N)
//             stored at p = 128 k2 + k1 for k = k2 + Bk k1 (row_perm order)
//   inverse:  input in row_perm order, natural output, 1/N included
//
// along axis -2 of (batch, N, C) planes (B3, "COL") or axis -1 of
// (batch, R, N) planes (B4, "ROW"); N = 128 Bk with 2 <= Bk <= 32. A row
// transform may multiply its input by a (R, N) plane on load, and a column
// transform by an (N, C) plane shared by every batch entry (B3s, the
// apodization window of a masked cross spectrum). B5 is the
// inverse row transform whose input is scale * eta, eta drawn on the load
// with philox.cuh's counters: B5(scale, w, batch) equals
// rowifft(noise_planes(scale, w, batch)) bit for bit.
//
// Replaces orphics_tpu/ops/pallas_fft.py:_call (colfft/colifft; kernels
// _fwd_kernel, _inv_kernel), :colfft_scaled (_fwd_scaled_kernel),
// :_row_call (rowfft/rowifft/rowifft_scaled_y; _rowfft_kernel,
// _rowifft_scaled_kernel) and :rowifft_noise_y
// (_rowifft_noise_kernel). The TPU evaluates the 128-point stage as
// bf16-split matmuls on its MXU.
//
// Bound: device memory, 16 B per complex element (read re/im, write
// re/im) against 5 N log2 N flops per transform; at N = 512 that is ~3
// flops per byte, far below the card's balance point, so the design keeps
// each transform's whole working set in shared memory and touches device
// memory once in and once out. B5 reads no input plane at all: 8 B per
// element written, plus Philox (~70 integer operations per pair) and two
// erfinvf per element, which keep it compute-heavier than B4. B3s reads
// the window once more per element, 4 B on 16 (at N = 2048 colfft.cu
// takes B3s and groups its grid so that the window's tiles stay in L2
// while the batch entries that share them stream past, as the TPU grid
// does by running the batch innermost).
//
// At a power-of-two Bk, B3 and B3s run colfft.cu's kernel and B4 and B5
// rowfft.cu's, both on the register-resident core (dft_launch and
// dft_noise_launch send them there); the kernel here takes the rows and
// the columns at any other Bk (n = 384, 640), and rows whose planes are not
// 8-byte aligned.
//
// Design: dft_core.cuh's two stages on T whole transforms per block (T
// columns of one batch entry, or T rows). Stage 1 runs one thread per
// (a, transform) with the Bk values in registers; stage 2 is the radix-2
// DIF FFT of every 128-slot segment, whose bit-reversed k1 order is undone
// in the store's index. The inverse runs the two stages the other way
// round and writes the natural rows straight from stage 1. A simple
// kernel: no tensor cores, no pipelining of loads against compute.
#include <cuda_runtime.h>
#include <cstdint>

#include "dft_core.cuh"
#include "philox.cuh"

namespace {

constexpr int MAX_SMEM = 200 * 1024;

template <bool ROW, bool INV, int MAXBK>
__global__ void __launch_bounds__(THREADS)
dft_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
           float* __restrict__ ore, float* __restrict__ oim,
           const float2* __restrict__ tab, const float* __restrict__ scale,
           const int* __restrict__ seed, int N, int Bk, int T, int M, int C,
           int R) {
  extern __shared__ float2 s[];
  const Tables tb = tables(tab, Bk);
  const int tid = threadIdx.x;
  // this block's transforms: rows r0 .. r0+nr of (M, N), or columns
  // c0 .. c0+nr of batch entry b of (batch, N, C)
  int64_t base;
  int64_t tstride, rstride;
  int nr;
  if (ROW) {
    const int r0 = blockIdx.x * T;
    nr = min(T, M - r0);
    base = static_cast<int64_t>(r0) * N;
    tstride = 1;
    rstride = N;
  } else {
    const int c0 = blockIdx.x * T;
    nr = min(T, C - c0);
    base = static_cast<int64_t>(blockIdx.y) * N * C + c0;
    tstride = C;
    rstride = 1;
  }

  if (ROW && INV && seed) {
    // B5: scale * eta, eta of element g = (row) N + t from pair g / 2 (N
    // is even, so a pair never straddles two rows)
    const PhiloxKeys keys = philox_round_keys(seed_key(seed));
    for (int e = 2 * tid; e < N * T; e += 2 * THREADS) {
      const int t = e % N;
      const int r = e / N;
      float2 v0 = make_float2(0.0f, 0.0f);
      float2 v1 = v0;
      if (r < nr) {
        const int64_t g = base + t + static_cast<int64_t>(r) * N;
        const uint4 bits = philox_pair(g / 2, keys);
        const float* sc =
            scale + (static_cast<int64_t>(blockIdx.x * T + r) % R) * N + t;
        v0 = make_float2(sc[0] * normal23(bits.x), sc[0] * normal23(bits.z));
        v1 = make_float2(sc[1] * normal23(bits.y), sc[1] * normal23(bits.w));
      }
      s[slot<ROW>(t, r, N, T)] = v0;
      s[slot<ROW>(t + 1, r, N, T)] = v1;
    }
  } else {
    // load (rows optionally scaled); slots of missing transforms hold zeros
    for (int e = tid; e < N * T; e += THREADS) {
      const int t = ROW ? e % N : e / T;
      const int r = ROW ? e / N : e % T;
      float2 v = make_float2(0.0f, 0.0f);
      if (r < nr) {
        const int64_t g = base + t * tstride + r * rstride;
        v = make_float2(xre[g], xim[g]);
        if (scale) {
          // ROW: row (r0 + r) mod R of the (R, N) plane; COL: element
          // (t, c0 + r) of the (N, C) plane, the batch offset left out
          const float sc =
              ROW ? scale[(static_cast<int64_t>(blockIdx.x * T + r) % R) * N
                          + t]
                  : scale[static_cast<int64_t>(t) * C + blockIdx.x * T + r];
          v.x *= sc;
          v.y *= sc;
        }
      }
      s[slot<ROW>(t, r, N, T)] = v;
    }
  }
  __syncthreads();

  if (!INV) {
    fwd_stage1<ROW, MAXBK>(s, tb, N, Bk, T);
    __syncthreads();
  }

  fft128_dif<ROW>(s, tb, N, Bk, T);

  if (!INV) {
    // store row p = 128 k2 + k1 from the bit-reversed slot
    for (int e = tid; e < N * T; e += THREADS) {
      const int t = ROW ? e % N : e / T;
      const int r = ROW ? e / N : e % T;
      if (r >= nr) continue;
      const float2 v = s[out_slot<ROW>(t, r, N, T)];
      const int64_t g = base + t * tstride + r * rstride;
      ore[g] = v.x;
      oim[g] = v.y;
    }
    return;
  }

  // inverse stage 1: twiddle, then the Bk-point DFT over k2, straight to
  // the natural rows a + 128 b
  const float inv_n = 1.0f / static_cast<float>(N);
  for (int i = tid; i < A * T; i += THREADS) {
    const int a = ROW ? i % A : i / T;
    const int r = ROW ? i / A : i % T;
    if (r >= nr) continue;
    float2 v[MAXBK];
    const int ar = brev7(a);
#pragma unroll
    for (int k2 = 0; k2 < MAXBK; ++k2)
      if (k2 < Bk)
        v[k2] = cmul(s[slot<ROW>(A * k2 + ar, r, N, T)], tb.tw[k2 * A + a]);
    for (int b = 0; b < Bk; ++b) {
      float2 g = make_float2(0.0f, 0.0f);
      int m = 0;  // (b * k2) mod Bk
#pragma unroll
      for (int k2 = 0; k2 < MAXBK; ++k2) {
        if (k2 < Bk) {
          const float2 w = tb.wb[m];
          g.x += v[k2].x * w.x - v[k2].y * w.y;
          g.y += v[k2].x * w.y + v[k2].y * w.x;
          m += b;
          if (m >= Bk) m -= Bk;
        }
      }
      const int64_t gi = base + (a + A * b) * tstride + r * rstride;
      ore[gi] = g.x * inv_n;
      oim[gi] = g.y * inv_n;
    }
  }
}

template <bool ROW, bool INV, int MAXBK>
int launch(const float* xre, const float* xim, float* ore, float* oim,
           const float2* tab, const float* scale, const int* seed, int N,
           int Bk, int T, int M, int C, int R, dim3 grid,
           cudaStream_t stream) {
  const int smem = N * T * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      dft_kernel<ROW, INV, MAXBK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dft_kernel<ROW, INV, MAXBK><<<grid, THREADS, smem, stream>>>(
      xre, xim, ore, oim, tab, scale, seed, N, Bk, T, M, C, R);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROW, bool INV>
int launch_bk(const float* xre, const float* xim, float* ore, float* oim,
              const float2* tab, const float* scale, const int* seed, int N,
              int Bk, int T, int M, int C, int R, dim3 grid,
              cudaStream_t stream) {
  if (Bk <= 4)
    return launch<ROW, INV, 4>(xre, xim, ore, oim, tab, scale, seed, N, Bk,
                               T, M, C, R, grid, stream);
  if (Bk <= 8)
    return launch<ROW, INV, 8>(xre, xim, ore, oim, tab, scale, seed, N, Bk,
                               T, M, C, R, grid, stream);
  if (Bk <= 16)
    return launch<ROW, INV, 16>(xre, xim, ore, oim, tab, scale, seed, N, Bk,
                                T, M, C, R, grid, stream);
  return launch<ROW, INV, 32>(xre, xim, ore, oim, tab, scale, seed, N, Bk, T,
                              M, C, R, grid, stream);
}

// transforms per block: as many as fit 64 KB of shared memory (at least 8
// columns, so a warp's loads span 32-byte sectors), at most 32
int tile(int n, int row) {
  int t = 8192 / n;
  if (!row && t < 8) t = 8;
  if (t > 32) t = 32;
  if (t < 1) t = 1;
  while (t > 1 && n * t * static_cast<int>(sizeof(float2)) > MAX_SMEM) --t;
  return t;
}

}  // namespace

// colfft.cu: B3 / B3s at Bk = 2, 4, 8, 16, 32
int col_dft_launch(const float* xre, const float* xim, float* ore,
                   float* oim, const float2* tab, const float* scale,
                   int inverse, int batch, int n, int C, cudaStream_t stream);
// rowfft.cu: B4 / B5 at Bk = 2, 4, 8, 16, 32
int row_dft_launch(const float* xre, const float* xim, float* ore,
                   float* oim, const float2* tab, const float* scale,
                   const int* seed, int inverse, int M, int R, int n,
                   cudaStream_t stream);

namespace {

// rowfft.cu's kernels take Bk a power of two and 8-byte aligned planes
bool row_regs(int Bk, const void* a, const void* b, const void* c,
              const void* d, const void* e) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
      reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
      reinterpret_cast<uintptr_t>(e);
  return (Bk & (Bk - 1)) == 0 && (bits & 7) == 0;
}

}  // namespace

extern "C" {

int dft_max_n() { return 32 * A; }

// row = 1: planes (batch, other, n), transform along the last axis; scale
// (other, n) or null. row = 0: planes (batch, n, other), transform along
// axis -2; scale (n, other), shared by the batch, or null. tab: the tables
// of dft.py:_tables. Columns at a power-of-two Bk go to colfft.cu's
// register-resident kernel, rows at a power-of-two Bk (on 8-byte aligned
// planes) to rowfft.cu's, everything else to dft_kernel.
int dft_launch(const float* xre, const float* xim, float* ore, float* oim,
               const void* tab, const float* scale, int row, int inverse,
               int batch, int n, int other, void* stream) {
  const int Bk = n / A;
  if (Bk * A != n || Bk < 2 || Bk > 32 || batch < 1 || other < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* tb = static_cast<const float2*>(tab);
  if (!row && (Bk & (Bk - 1)) == 0)
    return col_dft_launch(xre, xim, ore, oim, tb, scale, inverse, batch, n,
                          other, st);
  if (row && row_regs(Bk, xre, xim, ore, oim, scale))
    return row_dft_launch(xre, xim, ore, oim, tb, scale, nullptr, inverse,
                          batch * other, other, n, st);
  const int T = tile(n, row);
  if (row) {
    const int M = batch * other;
    const dim3 grid((M + T - 1) / T);
    return inverse
        ? launch_bk<true, true>(xre, xim, ore, oim, tb, scale, nullptr, n,
                                Bk, T, M, 0, other, grid, st)
        : launch_bk<true, false>(xre, xim, ore, oim, tb, scale, nullptr, n,
                                 Bk, T, M, 0, other, grid, st);
  }
  const dim3 grid((other + T - 1) / T, batch);
  return inverse
      ? launch_bk<false, true>(xre, xim, ore, oim, tb, scale, nullptr, n,
                               Bk, T, 0, other, 0, grid, st)
      : launch_bk<false, false>(xre, xim, ore, oim, tb, scale, nullptr, n,
                                Bk, T, 0, other, 0, grid, st);
}

// B5: ore/oim (batch, other, n) = rowifft(scale * eta); scale (other, n)
// f32; seed (2,) i32 in device memory; tab: dft.py:_tables(n, inverse).
int dft_noise_launch(const float* scale, const int* seed, float* ore,
                     float* oim, const void* tab, int batch, int n, int other,
                     void* stream) {
  const int Bk = n / A;
  if (Bk * A != n || Bk < 2 || Bk > 32 || batch < 1 || other < 1 || !scale
      || !seed)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_regs(Bk, scale, ore, oim, nullptr, nullptr))
    return row_dft_launch(nullptr, nullptr, ore, oim,
                          static_cast<const float2*>(tab), scale, seed, 1,
                          batch * other, other, n,
                          static_cast<cudaStream_t>(stream));
  const int T = tile(n, 1);
  const int M = batch * other;
  return launch_bk<true, true>(nullptr, nullptr, ore, oim,
                               static_cast<const float2*>(tab), scale, seed,
                               n, Bk, T, M, 0, other, dim3((M + T - 1) / T),
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
