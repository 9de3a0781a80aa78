// Row passes of the half-plane power pipeline (kernels B6, B6s, B6h, B6h'
// and B4b of the port).
//
// For Y, (batch, N, N) re/im fp32 planes with rows in row_perm order (the
// column-DFT intermediate), let Z = rowfft(Y) in the doubly-permuted
// layout and Zm[p, q] = Z[mrow p, mrow q] its mirror Z(-k).
//
//   B6 (rowqc_half): over the compact half plane, rows p = 128 (h / 64) +
//      h % 64 for h < N / 2 (dft.py:half_rows),
//        qs[b, h, q] = (|Z[p, q]|^2 + |Zm[p, q]|^2) / 2
//        c[b, h, q]  = Re(Z[p, q] Zm[p, q])
//   B6s (rows_half): the same pass with the one cross field
//        s[b, h, q]  = Im(Z[p, q] Zm[p, q]) = zr zmi + zi zmr
//      (for Z = fft2(x + i y), s / 2 is Re(X conj(Y)), the cross power)
//   B6h (qc_pp_half), B6h' (s_pp_half): the same fields from a Z that is
//      already in device memory, (batch, N, N) re/im planes
//   B4b (rowfft_blk0): the permuted columns [0, 128) (k2 = 0) of rowfft(Y):
//        out[r, k1] = sum_a (sum_b y[r, a + 128 b]) w_128^(a k1)
//
// Replaces orphics_tpu/ops/pallas_fft.py:rowqc_pp (_row_qc_kernel),
// :rows_pp (_row_s_kernel), :qc_pp_half (_qc_half_kernel), :s_pp_half
// (_s_half_kernel) and :rowfft_blk0 (_rowfft_blk0_kernel).
//
// Bound: device memory. B6 reads each row of Y about once (a half row and
// its mirror row are transformed by the same block; the ky = N/2 row only
// for zrow) and writes two half planes: 16 B in and 8 B out per element of Y,
// against ~10 log2 N flops; the full Fourier plane never reaches device
// memory. B6s writes one half plane: 16 B in and 4 B out per element. B6h
// and B6h' read Z once (a half row and its mirror row by the same block)
// and write two half planes or one: 8 B in and 4 B or 2 B out per element
// of Z, against 4 flops. B4b reads all of Y (8 B per element) and writes
// 1/Bk of it.
//
// Design: B6 and B6s are one kernel templated on its field and on Bk. For
// Bk in {2, 4, 8, 16, 32} (row_qc_kernel) a block of 256 threads takes
// max(1, 16 / Bk) half rows h and, for each, row p and its mirror row
// mrow[p]: 32 segments of 128 values (64 at Bk = 32), 35 KB of shared
// memory, so that every thread has work in every phase at every Bk.
//   1. Thread (row, a) loads the Bk values y[a + 128 b] of its rows straight
//      into registers (one coalesced 4-byte load per plane and b, all
//      independent and in flight together), runs the Bk-point FFT there
//      (dft_core.cuh:fft_regs, constant roots), multiplies by the w_N^(a k2)
//      twiddle (one coalesced table read) and stores G[k2, a] into segment
//      (row, k2).
//   2. After one barrier, 8 lanes per segment run the 128-point DFT as
//      16 x 8 in registers (dft_core.cuh:fft128_seg): a warp owns four whole
//      segments, so its exchanges need __syncwarp only, and Z[row, 128 k2 +
//      k1] ends at slot k1 of segment (row, k2): the public order, no bit
//      reversal left to undo.
//   3. After a second barrier thread q reads Z[p, q] and the mirror row's
//      value at mrow[q]. Inside a 128-column block mrow runs backwards, so a
//      warp reads one contiguous descending span of one segment: no bank
//      conflict. The fields are written with coalesced 4-byte stores.
// That is two block barriers and six sweeps of the block's data through
// shared memory, where the radix-2 core below takes nine barriers and
// fourteen sweeps, and no table load inside a butterfly. mrow is the exact
// Z(-k) map (dft_core.cuh:mirror_pos), so no row or column needs the TPU
// kernel's wrap-strip special case and rowpower.py patches nothing. Any
// other Bk (n = 384: Bk = 3) takes row_qc_generic_kernel: one block per
// (batch entry, half row), both rows in shared memory, dft_core.cuh's
// direct Bk-point stage and radix-2 128-point stage, the output read
// through out_slot.
//
// No tensor cores: the TPU runs the 128-point stage as bf16-split matmuls on
// its matrix unit, but on this card the pass is bound by device memory (at
// (96, 2048, 2048) 3.22 GB in and out against 22 GFLOP, 7 flops a byte,
// where fp32 FMAs alone sustain 20). TF32 wgmma keeps ~3 decimal digits and
// misses the 1.5e-5 transform contract; a three-way split that meets it
// would spend the gain.
//
// With zrow planes given, B6 / B6s also write Z's rows [0, 128), which hold
// the two boundary rows ky = 0 and N/2 that the half-plane bin sums need
// (store_zrow): the rows are in the blocks already, so the composition is
// one launch where the TPU's runs a second row transform.
//
// B6h and B6h' are one kernel templated on the field like B6: one block per
// (batch entry, half row h), thread q reads Z[p, q] and Z[mrow p, mrow q].
// Inside a 128-column block mrow runs backwards, so a warp's mirror read is
// one contiguous descending 128-byte span; the fields are written as B6
// writes them (store_fields), and the rows ky = 0 and ky = N/2, which mirror
// into themselves, need no special case. B4b sums the Bk blocks of each row
// (stage 1 at k2 = 0, whose weights are all 1) and runs one 128-point FFT
// per row, in the order of the B4 kernel that takes the same n, so that its
// output equals rowfft's columns [0, 128) bit for bit: at a power-of-two Bk
// (rowfft_blk0_regs_kernel, 32 rows a block) the sum is fft_regs' X[0], its
// radix-2 tree of adds, and the 128-point stage fft128_seg, as rowfft.cu's
// forward kernel runs them; at any other Bk (rowfft_blk0_kernel, T0 rows a
// block) the sum in order and fft128_dif, as dft.cu's radix-2 kernel.
#include <cuda_runtime.h>
#include <cstdint>

#include "dft_core.cuh"

namespace {

constexpr int T0 = 16;  // rows per B4b block

// The fields of Z[p, q] = z and Z[mrow p, mrow q] = m. S = false: qs ->
// out0, c -> out1 (B6); S = true: s -> out0 (B6s)
template <bool S>
__device__ __forceinline__ void store_fields(float2 z, float2 m, int64_t g,
                                             float* __restrict__ out0,
                                             float* __restrict__ out1) {
  if (S) {
    out0[g] = z.x * m.y + z.y * m.x;
  } else {
    out0[g] = 0.5f * (z.x * z.x + z.y * z.y + m.x * m.x + m.y * m.y);
    out1[g] = z.x * m.x - z.y * m.y;
  }
}

// Rows [0, 128) of Z for the boundary-row bins, from the blocks that hold
// them: the block of half row h < 64 has row p = h and its mirror row
// pm = (128 - h) % 128, rows 0 .. 63 and 65 .. 127 between them, and one
// block more per batch entry (nyq) transforms row 64, which mirrors into
// itself. z = Z[p, q], m = Z[pm, mq]; zrow: this batch entry's (128, N)
// planes.
__device__ __forceinline__ void store_zrow(float2 z, float2 m, int p, int pm,
                                           int q, int mq, int N,
                                           float* __restrict__ zre,
                                           float* __restrict__ zim) {
  zre[p * N + q] = z.x;
  zim[p * N + q] = z.y;
  if (pm != p) {
    zre[pm * N + mq] = m.x;
    zim[pm * N + mq] = m.y;
  }
}

// Row pairs a block of row_qc_kernel<BK> takes, and its shared memory: the
// segments, then the 128 twiddles of the 16 x 8 split
__host__ __device__ constexpr int qc_pairs(int bk) {
  return bk >= 16 ? 1 : 16 / bk;
}
__host__ __device__ constexpr int qc_smem(int bk) {
  return (2 * qc_pairs(bk) * bk * SEG + A) * static_cast<int>(sizeof(float2));
}

// B6 / B6s for Bk a power of two: the register-resident transform
template <int BK, bool S>
__global__ void __launch_bounds__(THREADS, BK <= 16 ? 4 : 2)
row_qc_kernel(const float* __restrict__ yre, const float* __restrict__ yim,
              const float2* __restrict__ tab, float* __restrict__ out0,
              float* __restrict__ out1, float* __restrict__ zre,
              float* __restrict__ zim) {
  constexpr int N = A * BK;
  constexpr int PAIRS = qc_pairs(BK);
  constexpr int NSEG = 2 * PAIRS * BK;
  static_assert(THREADS == 2 * A && NSEG % 32 == 0 && N % THREADS == 0,
                "a thread per (row of a pair, a); 8 lanes per segment");
  extern __shared__ float2 s[];  // [NSEG][SEG], then tws[128]
  float2* tws = s + NSEG * SEG;
  const Tables tb = tables(tab, BK);
  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * PAIRS;
  // the block past the half plane: row 64 for zrow, no field (store_zrow)
  const bool nyq = h0 == N / 2;
  const int64_t plane = static_cast<int64_t>(blockIdx.y) * N * N;
  stage_tw128(tws, tb);

  // 1. rows to registers, the Bk-point FFT, the twiddle, G[k2, a] to
  // segment (2 pr + m) BK + k2
  {
    const int a = tid % A;
    const int m = tid / A;  // 0: row p, 1: its mirror row
    float2 v[PAIRS][BK];
#pragma unroll
    for (int pr = 0; pr < PAIRS; ++pr) {
      const int h = h0 + pr;
      const int p = nyq ? A / 2 : A * (h / 64) + h % 64;
      const int64_t g =
          plane + static_cast<int64_t>(m ? mirror_pos(p, BK) : p) * N + a;
#pragma unroll
      for (int b = 0; b < BK; ++b)
        v[pr][b] = make_float2(yre[g + A * b], yim[g + A * b]);
    }
#pragma unroll
    for (int pr = 0; pr < PAIRS; ++pr) {
      fft_regs<BK, false>(v[pr]);
      float2* seg = s + (2 * pr + m) * BK * SEG + a;
#pragma unroll
      for (int k2 = 0; k2 < BK; ++k2) {
        float2 g = v[pr][bitrev(k2, ilog2(BK))];
        if (k2) g = cmul(g, tb.tw[k2 * A + a]);
        seg[k2 * SEG] = g;
      }
    }
  }
  __syncthreads();

  // 2. the 128-point DFT of every segment, 8 lanes each
#pragma unroll
  for (int it = 0; it < NSEG / 32; ++it)
    fft128_seg<false>(s + (tid / 8 + 32 * it) * SEG, tws, tid % 8);
  __syncthreads();

  // 3. the fields of each pair, Z[p, q] against the mirror row at mrow[q]
#pragma unroll
  for (int pr = 0; pr < PAIRS; ++pr) {
    const float2* z0 = s + 2 * pr * BK * SEG;
    const float2* z1 = z0 + BK * SEG;
    const int h = h0 + pr;
    const int p = nyq ? A / 2 : h;  // as a row of zrow: p = h where h < 64
    const bool rows = zre != nullptr && (nyq ? pr == 0 : h < 64);
    const int64_t o = (static_cast<int64_t>(blockIdx.y) * (N / 2) + h) * N;
    const int64_t zo = static_cast<int64_t>(blockIdx.y) * A * N;
#pragma unroll
    for (int i = 0; i < N / THREADS; ++i) {
      const int q = tid + THREADS * i;
      const int mq = mirror_pos(q, BK);
      const float2 z = z0[(q / A) * SEG + q % A];
      const float2 m = z1[(mq / A) * SEG + mq % A];
      if (!nyq) store_fields<S>(z, m, o + q, out0, out1);
      if (rows) store_zrow(z, m, p, (A - p) % A, q, mq, N, zre + zo, zim + zo);
    }
  }
}

// B6 / B6s for any other Bk: the shared-memory radix-2 core
template <int MAXBK, bool S>
__global__ void __launch_bounds__(THREADS)
row_qc_generic_kernel(const float* __restrict__ yre,
                      const float* __restrict__ yim,
                      const float2* __restrict__ tab, float* __restrict__ out0,
                      float* __restrict__ out1, float* __restrict__ zre,
                      float* __restrict__ zim, int N, int Bk) {
  extern __shared__ float2 s[];  // [2][N]: row p, then its mirror row
  const Tables tb = tables(tab, Bk);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool nyq = h == N / 2;  // row 64 for zrow, no field (store_zrow)
  const int p = nyq ? A / 2 : A * (h / 64) + h % 64;
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
  const int64_t zo = static_cast<int64_t>(b) * A * N;
  const bool rows = zre != nullptr && (nyq || h < 64);
  for (int q = threadIdx.x; q < N; q += THREADS) {
    const int mq = mirror_pos(q, Bk);
    const float2 z = s[out_slot<true>(q, 0, N, 2)];
    const float2 m = s[out_slot<true>(mq, 1, N, 2)];
    if (!nyq) store_fields<S>(z, m, o + q, out0, out1);
    if (rows) store_zrow(z, m, p, pm, q, mq, N, zre + zo, zim + zo);
  }
}

// B6h (S = false) and B6h' (S = true): B6's fields of a stored Z
template <bool S>
__global__ void __launch_bounds__(THREADS)
half_fields_kernel(const float* __restrict__ zre,
                   const float* __restrict__ zim, float* __restrict__ out0,
                   float* __restrict__ out1, int N, int Bk) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p = A * (h / 64) + h % 64;
  const int64_t plane = static_cast<int64_t>(b) * N * N;
  const int64_t row = plane + static_cast<int64_t>(p) * N;
  const int64_t mrow = plane + static_cast<int64_t>(mirror_pos(p, Bk)) * N;
  const int64_t o = (static_cast<int64_t>(b) * (N / 2) + h) * N;
  for (int q = threadIdx.x; q < N; q += THREADS) {
    const int mq = mirror_pos(q, Bk);
    store_fields<S>(make_float2(zre[row + q], zim[row + q]),
                    make_float2(zre[mrow + mq], zim[mrow + mq]), o + q, out0,
                    out1);
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

// B4b at a power-of-two Bk: thread (m, a) sums the Bk blocks of rows
// 2 i + m by fft_regs' tree (the compiler keeps the adds of X[0] alone),
// one 128-point DFT per row by 8 lanes (fft128_seg), and each warp stores
// its own four rows, two neighbouring columns a lane
template <int BK>
__global__ void __launch_bounds__(THREADS)
rowfft_blk0_regs_kernel(const float* __restrict__ yre,
                        const float* __restrict__ yim,
                        const float2* __restrict__ tab,
                        float* __restrict__ ore, float* __restrict__ oim,
                        int M) {
  constexpr int N = A * BK;
  constexpr int ROWS = THREADS / 8;  // a segment per 8-lane group
  __shared__ __align__(16) float2 s[ROWS * SEG + A];
  float2* tws = s + ROWS * SEG;
  const Tables tb = tables(tab, BK);
  const int tid = threadIdx.x;
  const int a = tid % A;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  stage_tw128(tws, tb);
#pragma unroll 2
  for (int i = tid / A; i < ROWS; i += THREADS / A) {
    const int64_t row = r0 + i;
    float2 v[BK];
#pragma unroll
    for (int b = 0; b < BK; ++b)
      v[b] = row < M ? make_float2(yre[row * N + a + A * b],
                                   yim[row * N + a + A * b])
                     : make_float2(0.0f, 0.0f);
    fft_regs<BK, false>(v);
    s[i * SEG + a] = v[0];
  }
  __syncthreads();
  fft128_seg<false>(s + (tid / 8) * SEG, tws, tid % 8);
  __syncwarp();
  const int lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * (tid / 32) + j;
    if (r0 + i >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = lane + 32 * h;
      const float4 z = *reinterpret_cast<const float4*>(s + i * SEG + 2 * sp);
      const int64_t o = (r0 + i) * A + 2 * sp;
      ore[o] = z.x;
      ore[o + 1] = z.z;
      oim[o] = z.y;
      oim[o + 1] = z.w;
    }
  }
}

template <int BK>
int launch_blk0_regs(const float* yre, const float* yim, const float2* tab,
                     float* ore, float* oim, int rows, cudaStream_t stream) {
  constexpr int ROWS = THREADS / 8;
  rowfft_blk0_regs_kernel<BK><<<(rows + ROWS - 1) / ROWS, THREADS, 0,
                                stream>>>(yre, yim, tab, ore, oim, rows);
  return static_cast<int>(cudaGetLastError());
}

// What a B6 / B6s launch takes: zre, zim (batch, 128, n) planes for Z's
// rows [0, 128), or both null
struct QcArgs {
  const float* yre;
  const float* yim;
  const float2* tab;
  float* out0;
  float* out1;
  float* zre;
  float* zim;
  int batch;
  int n;
  cudaStream_t stream;
};

template <int BK, bool S>
int launch_qc(const QcArgs& a) {
  cudaError_t err = cudaFuncSetAttribute(
      row_qc_kernel<BK, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      qc_smem(BK));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(row_qc_kernel<BK, S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block more per batch entry where zrow is wanted: row 64
  row_qc_kernel<BK, S>
      <<<dim3(A * BK / 2 / qc_pairs(BK) + (a.zre != nullptr), a.batch),
         THREADS, qc_smem(BK), a.stream>>>(a.yre, a.yim, a.tab, a.out0,
                                           a.out1, a.zre, a.zim);
  return static_cast<int>(cudaGetLastError());
}

template <int MAXBK, bool S>
int launch_qc_generic(const QcArgs& a) {
  const int smem = 2 * a.n * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      row_qc_generic_kernel<MAXBK, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_qc_generic_kernel<MAXBK, S>
      <<<dim3(a.n / 2 + (a.zre != nullptr), a.batch), THREADS, smem,
         a.stream>>>(a.yre, a.yim, a.tab, a.out0, a.out1, a.zre, a.zim, a.n,
                     a.n / A);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation the shape calls for: the register-resident kernel when
// Bk is a power of two, else the one on the radix-2 core
template <bool S>
int launch_fields(const QcArgs& a) {
  const int Bk = a.n / A;
  if (Bk * A != a.n || Bk < 2 || Bk > 32 || a.batch < 1 || a.batch > 65535 ||
      (a.zre == nullptr) != (a.zim == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (Bk) {
    case 2: return launch_qc<2, S>(a);
    case 4: return launch_qc<4, S>(a);
    case 8: return launch_qc<8, S>(a);
    case 16: return launch_qc<16, S>(a);
    case 32: return launch_qc<32, S>(a);
    default: break;
  }
  if (Bk <= 4) return launch_qc_generic<4, S>(a);
  if (Bk <= 8) return launch_qc_generic<8, S>(a);
  if (Bk <= 16) return launch_qc_generic<16, S>(a);
  return launch_qc_generic<32, S>(a);
}

template <int BK>
const void* qc_kernel(int s) {
  return s ? reinterpret_cast<const void*>(row_qc_kernel<BK, true>)
           : reinterpret_cast<const void*>(row_qc_kernel<BK, false>);
}

template <bool S>
int launch_half(const float* zre, const float* zim, float* out0, float* out1,
                int batch, int n, void* stream) {
  const int Bk = n / A;
  if (Bk * A != n || Bk < 2 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  half_fields_kernel<S><<<dim3(n / 2, batch), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      zre, zim, out0, out1, n, Bk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B6: yre, yim (batch, n, n) f32; qs, cc (batch, n/2, n) f32; zre, zim
// (batch, 128, n) f32 for Z's rows [0, 128), or both null; tab:
// dft.py:_tables(n, forward).
int rowqc_half_launch(const float* yre, const float* yim, const void* tab,
                      float* qs, float* cc, float* zre, float* zim, int batch,
                      int n, void* stream) {
  return launch_fields<false>(
      QcArgs{yre, yim, static_cast<const float2*>(tab), qs, cc, zre, zim,
             batch, n, static_cast<cudaStream_t>(stream)});
}

// B6s: yre, yim (batch, n, n) f32; s (batch, n/2, n) f32; the rest as B6's.
int rows_half_launch(const float* yre, const float* yim, const void* tab,
                     float* s, float* zre, float* zim, int batch, int n,
                     void* stream) {
  return launch_fields<true>(
      QcArgs{yre, yim, static_cast<const float2*>(tab), s, nullptr, zre, zim,
             batch, n, static_cast<cudaStream_t>(stream)});
}

// Blocks of B6's kernel (s = 0) or B6s's (s = 1) that one SM holds at
// transform length n, by the occupancy calculator; the kernel's registers
// through regs. 0 where the register-resident kernel does not take n.
int rowqc_half_occupancy(int n, int s, int* regs) {
  const void* fn = nullptr;
  switch (n % A ? 0 : n / A) {
    case 2: fn = qc_kernel<2>(s); break;
    case 4: fn = qc_kernel<4>(s); break;
    case 8: fn = qc_kernel<8>(s); break;
    case 16: fn = qc_kernel<16>(s); break;
    case 32: fn = qc_kernel<32>(s); break;
    default: return 0;
  }
  cudaFuncAttributes attr;
  int blocks = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           qc_smem(n / A)) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, fn) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, THREADS, qc_smem(n / A)) != cudaSuccess)
    return 0;
  if (regs) *regs = attr.numRegs;
  return blocks;
}

// B6h: zre, zim (batch, n, n) f32, the transformed plane in the
// doubly-permuted layout; qs, cc (batch, n/2, n) f32.
int qc_pp_half_launch(const float* zre, const float* zim, float* qs,
                      float* cc, int batch, int n, void* stream) {
  return launch_half<false>(zre, zim, qs, cc, batch, n, stream);
}

// B6h': zre, zim as B6h's; s (batch, n/2, n) f32.
int s_pp_half_launch(const float* zre, const float* zim, float* s, int batch,
                     int n, void* stream) {
  return launch_half<true>(zre, zim, s, nullptr, batch, n, stream);
}

// B4b: yre, yim (rows, n) f32 (any leading shape flattened); ore, oim
// (rows, 128) f32; tab: dft.py:_tables(n, forward).
int rowfft_blk0_launch(const float* yre, const float* yim, const void* tab,
                       float* ore, float* oim, int rows, int n,
                       void* stream) {
  const int Bk = n / A;
  if (Bk * A != n || Bk < 2 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* tb = static_cast<const float2*>(tab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Bk) {
    case 2: return launch_blk0_regs<2>(yre, yim, tb, ore, oim, rows, st);
    case 4: return launch_blk0_regs<4>(yre, yim, tb, ore, oim, rows, st);
    case 8: return launch_blk0_regs<8>(yre, yim, tb, ore, oim, rows, st);
    case 16: return launch_blk0_regs<16>(yre, yim, tb, ore, oim, rows, st);
    case 32: return launch_blk0_regs<32>(yre, yim, tb, ore, oim, rows, st);
    default: break;
  }
  rowfft_blk0_kernel<<<(rows + T0 - 1) / T0, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      yre, yim, static_cast<const float2*>(tab), ore, oim, rows, n, Bk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
