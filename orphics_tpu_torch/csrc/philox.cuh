// Counter-based Philox-4x32-10 and the 23-bit normal draw shared by the
// kernels that draw white noise on the card (noise.cu: B5n; dft.cu and
// rowfft.cu: B5).
//
// Counter layout, common to both: element e of a (batch, plane) output
// takes the pair q = e / 2 as its counter (low word, high word, 0, 0),
// keyed by the two 32-bit seed words; words x, y give the real parts of
// elements 2q, 2q + 1 and words z, w their imaginary parts. So the same
// words give the same eta whichever kernel draws it.
//
// The JAX package's law: 23-bit uniforms u = (ib + 0.5) / 2^23,
// eta = sqrt(2) erfinv(2u - 1); 23 bits keep 2u - 1 inside (-1, 1) in
// fp32, so eta stays finite.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Philox-4x32-10's ten round keys of the key k (the key schedule, k plus
// round times (W0, W1)), formed once by a kernel for all the pairs it draws
struct PhiloxKeys {
  uint32_t x[10];
  uint32_t y[10];
};

__device__ __forceinline__ PhiloxKeys philox_round_keys(uint2 k) {
  PhiloxKeys ks;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    ks.x[round] = k.x + round * 0x9E3779B9u;
    ks.y[round] = k.y + round * 0xBB67AE85u;
  }
  return ks;
}

// The four words of pair q: Philox-4x32-10 of the counter (low word of q,
// high word, 0, 0) under the round keys ks; each round's two 32 x 32-bit
// products, high and low words, come from one 64-bit multiply each.
__device__ __forceinline__ uint4 philox_pair(int64_t q, const PhiloxKeys& ks) {
  constexpr uint64_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  uint4 c = make_uint4(static_cast<uint32_t>(q),
                       static_cast<uint32_t>(q >> 32), 0u, 0u);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint64_t p0 = M0 * c.x;
    const uint64_t p1 = M1 * c.z;
    c = make_uint4(static_cast<uint32_t>(p1 >> 32) ^ c.y ^ ks.x[round],
                   static_cast<uint32_t>(p1),
                   static_cast<uint32_t>(p0 >> 32) ^ c.w ^ ks.y[round],
                   static_cast<uint32_t>(p0));
  }
  return c;
}

__device__ __forceinline__ uint2 seed_key(const int* seed) {
  return make_uint2(static_cast<uint32_t>(seed[0]),
                    static_cast<uint32_t>(seed[1]));
}

__device__ __forceinline__ float normal23(uint32_t bits) {
  const float u = (static_cast<float>(bits & 0x7FFFFFu) + 0.5f)
                  * (1.0f / 8388608.0f);
  return 1.41421356237309515f * erfinvf(2.0f * u - 1.0f);
}

}  // namespace
