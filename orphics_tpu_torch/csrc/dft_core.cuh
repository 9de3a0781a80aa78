// Device code of the 128 Bk-point DFT in shared memory, shared by the row
// and column transforms (dft.cu: B3, B4, B5) and the fused row passes
// (rowpower.cu: B6, B4b).
//
// The split N = 128 Bk, n = a + 128 b, k = k2 + Bk k1 (the TPU's):
//   stage 1  G[k2, a] = sum_b x[a + 128 b] w_Bk^(b k2)   (direct Bk-point DFT)
//            H[k2, a] = G[k2, a] w_N^(a k2)               (twiddle)
//   stage 2  X[k2 + Bk k1] = sum_a H[k2, a] w_128^(a k1)  (radix-2 FFT)
// A block holds T whole transforms in shared memory: T rows of length N
// ("ROW", slot r N + t) or T interleaved columns ("COL", slot t T + r), so
// that neighbouring threads touch neighbouring slots in every phase. Stage
// 2 is a decimation-in-frequency FFT over every 128-slot segment, which
// leaves k1 in bit-reversed order: the forward output at permuted position
// p = 128 k2 + k1 sits in slot out_slot(p). All twiddles come from tables
// built in float64 on the host and rounded to fp32 (dft.py:_tables).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int A = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ float2 cmul(float2 u, float2 w) {
  return make_float2(u.x * w.x - u.y * w.y, u.x * w.y + u.y * w.x);
}

__device__ __forceinline__ int brev7(int k) { return __brev(k) >> 25; }

// Tables (complex, fp32): w128[64] = w_128^j, wb[Bk] = w_Bk^j,
// tw[Bk][128] = w_N^(k2 a); conjugated for the inverse.
struct Tables {
  const float2* w128;
  const float2* wb;
  const float2* tw;
};

__device__ __forceinline__ Tables tables(const float2* t, int Bk) {
  return Tables{t, t + 64, t + 64 + Bk};
}

// Shared-memory slot of element t of transform r.
template <bool ROW>
__device__ __forceinline__ int slot(int t, int r, int N, int T) {
  return ROW ? r * N + t : t * T + r;
}

// Slot of the forward output at permuted position p of transform r.
template <bool ROW>
__device__ __forceinline__ int out_slot(int p, int r, int N, int T) {
  return slot<ROW>(A * (p / A) + brev7(p % A), r, N, T);
}

// The permuted position of frequency -k(p) (dft.py:row_perm order):
// k = k2 + Bk k1 at p = 128 k2 + k1, so -k sits at (0, (128 - k1) % 128)
// for k2 = 0 and at (Bk - k2, 127 - k1) otherwise (mirror.py's mrow).
__device__ __forceinline__ int mirror_pos(int p, int Bk) {
  const int k2 = p / A;
  const int k1 = p % A;
  return k2 == 0 ? (A - k1) % A : A * (Bk - k2) + (A - 1 - k1);
}

// Forward stage 1 of T transforms: a thread reads and writes only the Bk
// slots of its own (a, r), so it needs no barrier of its own.
template <bool ROW, int MAXBK>
__device__ __forceinline__ void fwd_stage1(float2* s, const Tables& tb,
                                           int N, int Bk, int T) {
  for (int i = threadIdx.x; i < A * T; i += THREADS) {
    const int a = ROW ? i % A : i / T;
    const int r = ROW ? i / A : i % T;
    float2 v[MAXBK];
#pragma unroll
    for (int b = 0; b < MAXBK; ++b)
      if (b < Bk) v[b] = s[slot<ROW>(a + A * b, r, N, T)];
#pragma unroll
    for (int k2 = 0; k2 < MAXBK; ++k2) {
      if (k2 < Bk) {
        float2 g = make_float2(0.0f, 0.0f);
        int m = 0;  // (b * k2) mod Bk
#pragma unroll
        for (int b = 0; b < MAXBK; ++b) {
          if (b < Bk) {
            const float2 w = tb.wb[m];
            g.x += v[b].x * w.x - v[b].y * w.y;
            g.y += v[b].x * w.y + v[b].y * w.x;
            m += k2;
            if (m >= Bk) m -= Bk;
          }
        }
        s[slot<ROW>(A * k2 + a, r, N, T)] = cmul(g, tb.tw[k2 * A + a]);
      }
    }
  }
}

// The 128-point radix-2 DIF FFT of every segment (k2 < Bk, r < T):
// natural in, bit-reversed out; a barrier after each of the 7 stages.
template <bool ROW>
__device__ __forceinline__ void fft128_dif(float2* s, const Tables& tb,
                                           int N, int Bk, int T) {
  const int nbfly = (A / 2) * Bk * T;
  for (int span = A / 2; span >= 1; span >>= 1) {
    const int wstep = (A / 2) / span;
    for (int i = threadIdx.x; i < nbfly; i += THREADS) {
      int j, k2, r;
      if (ROW) {
        j = i % (A / 2);
        const int seg = i / (A / 2);
        k2 = seg % Bk;
        r = seg / Bk;
      } else {
        r = i % T;
        const int rest = i / T;
        j = rest % (A / 2);
        k2 = rest / (A / 2);
      }
      const int pos = j & (span - 1);
      const int t0 = A * k2 + (j - pos) * 2 + pos;
      const int s0 = slot<ROW>(t0, r, N, T);
      const int s1 = slot<ROW>(t0 + span, r, N, T);
      const float2 u = s[s0];
      const float2 v = s[s1];
      s[s0] = make_float2(u.x + v.x, u.y + v.y);
      s[s1] = cmul(make_float2(u.x - v.x, u.y - v.y), tb.w128[pos * wstep]);
    }
    __syncthreads();
  }
}

}  // namespace
