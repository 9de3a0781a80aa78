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
// the weights (16 B per element and q) once, and each coadd plane is
// written once (8 B per element), against ~10 log2 N flops per element of
// Y.
//
// Design at a power-of-two Bk = 2 .. 32 (row_combine_regs_kernel, on the
// row form of dft_core.cuh's register-resident core, as rowfft.cu's
// forward runs it): a block of 256 threads owns one row pair (p,
// mirror_pos(p)) for G coadds at once, ROWS = 2 G rows (G = 16 / Bk, 1 at
// Bk >= 16): ROWS Bk segments of SEG = 136 slots, 35 KB of shared memory
// (70 KB at Bk = 32), two blocks an SM. Block x < N / 2 takes half row h = x
// (dft.py:half_rows) and its mirror row; block 0 takes rows 0 and 64, each
// its own mirror, so the N / 2 blocks cover every row once. For q = 0 ..
// nq-1 in that order:
//   1. each warp loads its own segments, rows p and pm of pair c nq + q of
//      the block's coadds c: segment (row, b), slots 2 sp, 2 sp + 1 from
//      columns 128 b + 2 sp and + 1 (8-byte loads of re and im, all issued
//      before the first store, coadds past the last load zeros);
//   2. thread (m, a) runs the Bk-point FFT over b in registers (fft_regs),
//      the w_N^(a k2) twiddle, G[k2, a] back to its own slots;
//   3. 8 lanes a segment run the 128-point DFT as 16 x 8 (fft128_seg):
//      Z[row, 128 k2 + k1] at slot k1 of segment (row, k2);
//   4. after a block barrier each thread takes Bk / 2 fixed positions
//      (row of the pair, k2, column pair sp), with alpha_q and beta_q
//      there loaded once (8-byte loads of the four planes; at Bk <= 4
//      issued before step 1, so that the transform covers their latency),
//      and applies them to its G coadds: Z from slots 2 sp, 2 sp + 1 of its own row, Zm from
//      the partner row at mirror_pos (a descending span inside one
//      segment: slots 126 - 2 sp .. 127 - 2 sp of segment Bk - k2, or at
//      k2 = 0 slots (128 - 2 sp) % 128 and 127 - 2 sp), the sums in
//      registers.
// After the last q each thread stores its coadd values, 8 bytes a store
// per plane. The weights cross from L2 once per G coadds (the radix-2
// kernel below reads them once per coadd: 403 MB at bench config 4's
// shape). Fixed q order and fixed ownership of each (coadd, row, column)
// keep the sums bit-reproducible, and the mirror (mirror_pos) is exact on
// every row and column, so no strip needs a patch.
//
// Any other Bk (n = 384: Bk = 3) takes row_combine_kernel: one block per
// (coadd, row p with its mirror row mrow[p]), rows 0 and 64 a one-row
// block each. For q = 0 .. nq-1 in that order the block loads both rows of
// pair c nq + q into shared memory (2 N complex values), runs
// dft_core.cuh's direct Bk-point stage and radix-2 128-point stage on
// them, and adds alpha o Z + beta o conj(Zm) for both rows into registers;
// each thread owns fixed columns and the q order is fixed.
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

// Rows a block of row_combine_regs_kernel<BK> takes (its row pair for
// cb_rows / 2 coadds), and its shared memory: the segments, then the 128
// twiddles of the 16 x 8 split
__host__ __device__ constexpr int cb_rows(int bk) {
  return bk >= 16 ? 2 : 32 / bk;
}
__host__ __device__ constexpr int cb_smem(int bk) {
  return (cb_rows(bk) * bk * SEG + A) * static_cast<int>(sizeof(float2));
}

// Segment g's two columns 2 sp, 2 sp + 1 (sp = lane + 32 h) of the block's
// load: segment g = (2 gi + m) BK + b holds row m ? pm : p of pair
// (c0 + gi) nq + q, columns 128 b + [0, 128); coadds past ncoadds give
// zeros.
template <int BK>
__device__ __forceinline__ void combine_load(
    float4 (&z)[2], const float* __restrict__ yre,
    const float* __restrict__ yim, int g, int p, int pm, int c0, int q,
    int nq, int ncoadds) {
  constexpr int N = A * BK;
  const int rho = g / BK;
  const int c = c0 + rho / 2;
  const int lane = threadIdx.x % 32;
  z[0] = z[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c >= ncoadds) return;
  const int64_t off =
      (static_cast<int64_t>(c) * nq + q) * N * N
      + static_cast<int64_t>(rho % 2 ? pm : p) * N + A * (g % BK);
  const float2* re = reinterpret_cast<const float2*>(yre + off);
  const float2* im = reinterpret_cast<const float2*>(yim + off);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 vr = re[lane + 32 * h];
    const float2 vi = im[lane + 32 * h];
    z[h] = make_float4(vr.x, vi.x, vr.y, vi.y);
  }
}

// alpha and beta of one position: columns 2 sp, 2 sp + 1 of the four
// weight planes at offset w
__device__ __forceinline__ void load_weights(float2 (&wt)[4],
                                             const float* __restrict__ alr,
                                             const float* __restrict__ ali,
                                             const float* __restrict__ ber,
                                             const float* __restrict__ bei,
                                             int64_t w) {
  wt[0] = *reinterpret_cast<const float2*>(alr + w);
  wt[1] = *reinterpret_cast<const float2*>(ali + w);
  wt[2] = *reinterpret_cast<const float2*>(ber + w);
  wt[3] = *reinterpret_cast<const float2*>(bei + w);
}

// acc += alpha o z + beta o conj(zm) at one column
__device__ __forceinline__ void combine_add(float& cr, float& ci, float2 z,
                                            float2 zm, float ar, float ai,
                                            float br, float bi) {
  cr += ar * z.x - ai * z.y + br * zm.x + bi * zm.y;
  ci += ar * z.y + ai * z.x + bi * zm.x - br * zm.y;
}

// B9 for Bk a power of two: the register-resident transform, a row pair
// for G coadds a block, each weight load applied to the G coadds. Two
// blocks an SM (128 registers): at three (80 registers) the sums and the
// loads in flight spilled 376 bytes at Bk = 4 and ran 0.21 ms against
// 0.16 at (96, 512^2); the weights in flight through the transform took
// that to 0.15 (PERF.md, section 6)
template <int BK>
__global__ void __launch_bounds__(THREADS, 2)
row_combine_regs_kernel(const float* __restrict__ yre,
                        const float* __restrict__ yim,
                        const float* __restrict__ alr,
                        const float* __restrict__ ali,
                        const float* __restrict__ ber,
                        const float* __restrict__ bei,
                        const float2* __restrict__ tab,
                        float* __restrict__ cre, float* __restrict__ cim,
                        int ncoadds, int nq) {
  constexpr int N = A * BK;
  constexpr int ROWS = cb_rows(BK);
  constexpr int G = ROWS / 2;          // coadds of the block
  constexpr int PER = ROWS / 2;        // rows of each thread in step 2
  constexpr int NSEG = ROWS * BK;
  constexpr int ITS = NSEG / 32;       // rounds of four segments a warp
  constexpr int POS = BK / 2;          // positions of each thread in step 4
  // alpha_q and beta_q in flight through the transform where the
  // registers allow (Bk <= 4), else loaded in step 4
  constexpr bool EARLY = POS <= 2;
  static_assert(THREADS == 2 * A && NSEG % 32 == 0 && POS >= 1,
                "a thread per (row of a pair, a); 8 lanes per segment");
  extern __shared__ float2 s[];  // [NSEG][SEG], then tws[128]
  float2* tws = s + NSEG * SEG;
  const Tables tb = tables(tab, BK);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // block 0: rows 0 and 64, each its own mirror; else half row x and its
  // mirror row
  const bool self = blockIdx.x == 0;
  const int x = blockIdx.x;
  const int p = self ? 0 : A * (x / 64) + x % 64;
  const int pm = self ? A / 2 : mirror_pos(p, BK);
  const int c0 = blockIdx.y * G;
  const int64_t plane = static_cast<int64_t>(N) * N;
  stage_tw128(tws, tb);

  // step 4's positions i < POS of this thread: P = tid + 256 i, column
  // pair sp = P % 64, segment sigma = P / 64 of the pair (row m = sigma /
  // BK, k2 = sigma % BK), uniform in a warp, at offset pos_off(i) in a
  // plane. The sums of position i for coadd c0 + gi: (re, re) and (im, im)
  // of columns 2 sp, 2 sp + 1
  const int sp = tid % 64;
  const auto pos_off = [&](int i) {
    const int sigma = tid / 64 + 4 * i;
    return (sigma / BK ? pm : p) * N + A * (sigma % BK) + 2 * sp;
  };
  float2 accr[POS][G], acci[POS][G];
#pragma unroll
  for (int i = 0; i < POS; ++i)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      accr[i][gi] = acci[i][gi] = make_float2(0.0f, 0.0f);

#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    const int64_t wq = static_cast<int64_t>(q) * plane;
    float2 wt[EARLY ? POS : 1][4];
    if constexpr (EARLY) {
#pragma unroll
      for (int i = 0; i < POS; ++i)
        load_weights(wt[i], alr, ali, ber, bei, wq + pos_off(i));
    }
    // 1. this warp's segments g = 4 warp + j + 32 it; the first round's
    // loads are in flight while the block finishes the last q's step 4
    float4 z[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      combine_load<BK>(z[j], yre, yim, 4 * warp + j, p, pm, c0, q, nq,
                       ncoadds);
    if (q) __syncthreads();
#pragma unroll
    for (int it = 0; it < ITS; ++it) {
      if (it) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          combine_load<BK>(z[j], yre, yim, 4 * warp + j + 32 * it, p, pm,
                           c0, q, nq, ncoadds);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4* seg = reinterpret_cast<float4*>(
            s + (4 * warp + j + 32 * it) * SEG) + lane;
        seg[0] = z[j][0];
        seg[32] = z[j][1];
      }
    }
    __syncthreads();

    // 2. thread (m, a) on rows 2 i + m: the Bk-point FFT of slot a of the
    // row's segments, the twiddle, G[k2, a] back to the same slots
    {
      const int a = tid % A;
      const int m = tid / A;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        float2* own = s + (2 * i + m) * BK * SEG + a;
        float2 v[BK];
#pragma unroll
        for (int b = 0; b < BK; ++b) v[b] = own[b * SEG];
        fft_regs<BK, false>(v);
#pragma unroll
        for (int k2 = 0; k2 < BK; ++k2) {
          float2 g = v[bitrev(k2, ilog2(BK))];
          if (k2) g = cmul(g, tb.tw[k2 * A + a]);
          own[k2 * SEG] = g;
        }
      }
    }
    __syncthreads();

    // 3. the 128-point DFT of every segment, 8 lanes each
#pragma unroll
    for (int it = 0; it < ITS; ++it)
      fft128_seg<false>(s + (tid / 8 + 32 * it) * SEG, tws, tid % 8);
    __syncthreads();

    // 4. the weights of each position once, then its G coadds
#pragma unroll
    for (int i = 0; i < POS; ++i) {
      const int sigma = tid / 64 + 4 * i;
      const int m = sigma / BK;
      const int k2 = sigma % BK;
      float2 w4[4];
      if constexpr (EARLY) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w4[k] = wt[i][k];
      } else {
        load_weights(w4, alr, ali, ber, bei, wq + pos_off(i));
      }
      const float2 ar = w4[0], ai = w4[1], br = w4[2], bi = w4[3];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int rho = 2 * gi + m;
        const int rhom = self ? rho : 2 * gi + 1 - m;
        const float4 zz = *reinterpret_cast<const float4*>(
            s + (rho * BK + k2) * SEG + 2 * sp);
        float2 m0, m1;  // Zm at columns 2 sp and 2 sp + 1
        if (k2) {
          const float4 mm = *reinterpret_cast<const float4*>(
              s + (rhom * BK + BK - k2) * SEG + 126 - 2 * sp);
          m0 = make_float2(mm.z, mm.w);
          m1 = make_float2(mm.x, mm.y);
        } else {
          const float2* ms = s + rhom * BK * SEG;
          m0 = ms[(A - 2 * sp) % A];
          m1 = ms[A - 1 - 2 * sp];
        }
        combine_add(accr[i][gi].x, acci[i][gi].x, make_float2(zz.x, zz.y),
                    m0, ar.x, ai.x, br.x, bi.x);
        combine_add(accr[i][gi].y, acci[i][gi].y, make_float2(zz.z, zz.w),
                    m1, ar.y, ai.y, br.y, bi.y);
      }
    }
  }

  // the coadd rows, 8 bytes a store and plane
#pragma unroll
  for (int i = 0; i < POS; ++i)
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (c0 + gi >= ncoadds) break;
      const int64_t d = (c0 + gi) * plane + pos_off(i);
      *reinterpret_cast<float2*>(cre + d) = accr[i][gi];
      *reinterpret_cast<float2*>(cim + d) = acci[i][gi];
    }
}

long long regs_launches = 0;

template <int BK>
int launch_regs(const float* yre, const float* yim, const float* alr,
                const float* ali, const float* ber, const float* bei,
                const float2* tab, float* cre, float* cim, int ncoadds,
                int nq, cudaStream_t stream) {
  constexpr int G = cb_rows(BK) / 2;
  const int groups = (ncoadds + G - 1) / G;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      row_combine_regs_kernel<BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, cb_smem(BK));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(row_combine_regs_kernel<BK>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_combine_regs_kernel<BK>
      <<<dim3(A * BK / 2, groups), THREADS, cb_smem(BK), stream>>>(
          yre, yim, alr, ali, ber, bei, tab, cre, cim, ncoadds, nq);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++regs_launches;
  return static_cast<int>(err);
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
// cre, cim (ncoadds, n, n) f32, all 8-byte aligned; tab:
// dft.py:_tables(n, forward).
int rowcombine_launch(const float* yre, const float* yim, const float* alr,
                      const float* ali, const float* ber, const float* bei,
                      const void* tab, float* cre, float* cim, int ncoadds,
                      int n, int nq, void* stream) {
  const int Bk = n / A;
  const void* planes[] = {yre, yim, alr, ali, ber, bei, cre, cim};
  bool aligned = true;
  for (const void* ptr : planes)
    aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 8 == 0;
  if (Bk * A != n || Bk < 2 || Bk > 32 || ncoadds < 1 || nq < 1 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* tb = static_cast<const float2*>(tab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Bk) {
    case 2: return launch_regs<2>(yre, yim, alr, ali, ber, bei, tb, cre, cim,
                                  ncoadds, nq, st);
    case 4: return launch_regs<4>(yre, yim, alr, ali, ber, bei, tb, cre, cim,
                                  ncoadds, nq, st);
    case 8: return launch_regs<8>(yre, yim, alr, ali, ber, bei, tb, cre, cim,
                                  ncoadds, nq, st);
    case 16: return launch_regs<16>(yre, yim, alr, ali, ber, bei, tb, cre,
                                    cim, ncoadds, nq, st);
    case 32: return launch_regs<32>(yre, yim, alr, ali, ber, bei, tb, cre,
                                    cim, ncoadds, nq, st);
    default: break;
  }
  if (ncoadds > 65535) return static_cast<int>(cudaErrorInvalidValue);
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

// Launches of the register-resident kernel since the library was loaded
// (every B9 launch at a power-of-two Bk, none at other Bk)
long long rowcombine_regs_launches() { return regs_launches; }

}  // extern "C"
