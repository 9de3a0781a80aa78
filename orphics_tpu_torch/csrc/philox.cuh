// Counter-based Philox-4x32-10 and the 23-bit normal draw shared by the
// kernels that draw white noise on the card (noise.cu: B5n; dft.cu: B5).
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

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

// The four words of pair q under the key of the seed words in device
// memory.
__device__ __forceinline__ uint4 philox_pair(int64_t q, uint2 key) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                 0u, 0u), key);
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
