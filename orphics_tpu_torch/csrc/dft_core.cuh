// Device code of the 128 Bk-point DFT, shared by the row and column
// transforms (dft.cu: B3, B3s, B4, B5; colfft.cu: B3, B3s; rowfft.cu: B4,
// B5) and the fused row passes (rowpower.cu: B6, B6s, B4b). Two cores: the
// radix-2 core in shared memory (first half; every kernel at a Bk that is
// not a power of two) and the register-resident core (second half; B3 /
// B3s in column form, B4 / B5 / B6 / B6s / B4b in row form at a
// power-of-two Bk = 2 .. 32).
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
//
// The register-resident core (second half of this file) evaluates the same
// split with no pass through shared memory inside a stage:
//   fft_regs<M, INV>  an M-point radix-2 DIF FFT (M = 2 .. 32) of values a
//                     thread holds in registers, the M-th roots compile-time
//                     constants rounded from float64: stage 1 when Bk is a
//                     power of two, and the two factors of the 128-point
//                     stage
//   fft128_seg<INV>   one 128-point DFT per 8 neighbouring lanes as 16 x 8:
//                     a = 8 d + c, k1 = e + 16 f; lane c runs the 16-point
//                     FFT over d, multiplies by w_128^(c e), exchanges
//                     inside its own segment (a warp owns whole segments, so
//                     __syncwarp is the only barrier), and runs the 8-point
//                     FFTs over c for e = c and c + 8. Natural order in and
//                     out.
// A segment is the 128 values of one (transform, k2), padded to SEG = 136
// slots so that the three access patterns (8 d + c, 17 c + e, e + 16 f) all
// fall on distinct banks, and the two segments of a half-warp must start 8
// banks apart. Both functions work on registers and on one segment
// pointer, so a row kernel and a column kernel differ only in how stage 1
// stores into the segments (colfft.cu's column layout re-derives the
// padding for its stores); INV conjugates the constants, and the tables
// handed in are already conjugated for the inverse, which runs fft128_seg
// first (k1 in, a out) and fft_regs over k2 last.
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

// ---- the register-resident core -------------------------------------------

constexpr int SEG = A + 8;  // slots of a padded 128-value segment

__host__ __device__ constexpr int ilog2(int m) {
  return m <= 1 ? 0 : 1 + ilog2(m / 2);
}

// k's low `bits` bits reversed (bits <= 5); loop-free, so that it folds to
// a constant register index wherever k is an unrolled loop's counter
__host__ __device__ constexpr int bitrev(int k, int bits) {
  return (((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2) |
          ((k & 16) >> 4)) >> (5 - bits);
}

// cos(2 pi t / 32) for t = 0 .. 8, rounded from float64
__host__ __device__ constexpr float cos32(int t) {
  return t == 0   ? 1.0f
         : t == 1 ? 0.98078528040323043f
         : t == 2 ? 0.92387953251128674f
         : t == 3 ? 0.83146961230254524f
         : t == 4 ? 0.70710678118654752f
         : t == 5 ? 0.55557023301960218f
         : t == 6 ? 0.38268343236508977f
         : t == 7 ? 0.19509032201612825f
                  : 0.0f;
}

// d w_32^t for 0 <= t < 16 (w_32 = exp(-2 pi i / 32), conjugated for INV);
// t is a constant once the caller's loops are unrolled
template <bool INV>
__device__ __forceinline__ float2 mul_root32(float2 d, int t) {
  if (t == 0) return d;
  if (t == 8) return INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
  const float c = t < 8 ? cos32(t) : -cos32(16 - t);
  const float s = t < 8 ? cos32(8 - t) : cos32(t - 8);
  return INV ? make_float2(c * d.x - s * d.y, c * d.y + s * d.x)
             : make_float2(c * d.x + s * d.y, c * d.y - s * d.x);
}

// In-place M-point FFT of v (M a power of two, 2 <= M <= 32): natural order
// in, X[k] left in v[bitrev(k, log2 M)].
template <int M, bool INV>
__device__ __forceinline__ void fft_regs(float2 (&v)[M]) {
  static_assert(M >= 2 && M <= 32 && (M & (M - 1)) == 0, "M = 2 .. 32");
#pragma unroll
  for (int st = 0; st < ilog2(M); ++st) {
    const int span = (M / 2) >> st;
#pragma unroll
    for (int i = 0; i < M / 2; ++i) {
      const int pos = i & (span - 1);
      const int i0 = 2 * (i - pos) + pos;
      const int i1 = i0 + span;
      const float2 u = v[i0];
      const float2 w = v[i1];
      v[i0] = make_float2(u.x + w.x, u.y + w.y);
      v[i1] = mul_root32<INV>(make_float2(u.x - w.x, u.y - w.y),
                              pos * (16 / span));
    }
  }
}

// The 16 x 8 split's twiddles, tws[8 e + c] = w_128^(c e) for e < 16, c < 8,
// from the table's w_128^j (j < 64); the caller's next barrier publishes
// them.
__device__ __forceinline__ void stage_tw128(float2* tws, const Tables& tb) {
  if (threadIdx.x < A) {
    const int j = (threadIdx.x % 8) * (threadIdx.x / 8);
    const float2 w = tb.w128[j & 63];
    tws[threadIdx.x] = j < 64 ? w : make_float2(-w.x, -w.y);
  }
}

// The 128-point DFT of one segment by the 8 lanes c = 0 .. 7 that own it:
// seg[a] in, seg[k1] out. Every lane of the warp must call it (each group
// of 8 on its own segment): the exchanges are fenced by __syncwarp.
template <bool INV>
__device__ __forceinline__ void fft128_seg(float2* seg, const float2* tws,
                                           int c) {
  float2 u[16];
#pragma unroll
  for (int d = 0; d < 16; ++d) u[d] = seg[8 * d + c];
  fft_regs<16, INV>(u);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    float2 g = u[bitrev(e, 4)];
    if (e) g = cmul(g, tws[8 * e + c]);
    seg[17 * c + e] = g;
  }
  __syncwarp();
  float2 x[2][8];
#pragma unroll
  for (int eh = 0; eh < 2; ++eh) {
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) x[eh][cc] = seg[17 * cc + c + 8 * eh];
    fft_regs<8, INV>(x[eh]);
  }
  __syncwarp();
#pragma unroll
  for (int eh = 0; eh < 2; ++eh)
#pragma unroll
    for (int f = 0; f < 8; ++f)
      seg[c + 8 * eh + 16 * f] = x[eh][bitrev(f, 3)];
}

}  // namespace
