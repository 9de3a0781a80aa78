// Scaled complex white noise drawn in the kernel (kernel B5n of the port).
//
//   ore[b, i] = scale[i] * eta_re,   oim[b, i] = scale[i] * eta_im
//
// with eta standard normal, for (batch, plane) outputs and a plane-sized
// scale (any layout: the noise is white).
//
// Replaces orphics_tpu/ops/pallas_fft.py:noise_planes
// (_noise_planes_kernel), which draws the TPU's own random bits per block.
//
// Bound: writing the two output planes, 8 B per complex element (the
// scale plane is shared by the batch and stays in L2); Philox-4x32-10 costs
// ~70 integer operations per four 32-bit words, an erfinvf per value.
//
// Design: counter-based Philox-4x32-10, written out here, keyed by the two
// 32-bit seed words, which the kernel reads from device memory (as the TPU
// kernel reads them from SMEM), so a caller can draw the words on the
// device without a host round trip. One thread per pair of elements: the
// counter is the pair index, and the four output words give the re and im
// values of both elements, so every element of every plane gets its own
// bits. The JAX package's law follows: 23-bit uniforms
// u = (ib + 0.5) / 2^23, eta = sqrt(2) erfinv(2u - 1); 23 bits keep
// 2u - 1 inside (-1, 1) in fp32, so eta stays finite.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

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

__device__ __forceinline__ float normal23(uint32_t bits) {
  const float u = (static_cast<float>(bits & 0x7FFFFFu) + 0.5f)
                  * (1.0f / 8388608.0f);
  return 1.41421356237309515f * erfinvf(2.0f * u - 1.0f);
}

__global__ void __launch_bounds__(THREADS)
noise_kernel(const float* __restrict__ scale, const int* __restrict__ seed,
             float* __restrict__ ore, float* __restrict__ oim,
             int64_t plane, int64_t total) {
  const uint2 key = make_uint2(static_cast<uint32_t>(seed[0]),
                               static_cast<uint32_t>(seed[1]));
  const int64_t npairs = (total + 1) / 2;
  for (int64_t q = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
       q < npairs; q += static_cast<int64_t>(gridDim.x) * THREADS) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                   0u, 0u), key);
    const int64_t e = 2 * q;
    const float s0 = scale[e % plane];
    ore[e] = s0 * normal23(r.x);
    oim[e] = s0 * normal23(r.z);
    if (e + 1 < total) {
      const float s1 = scale[(e + 1) % plane];
      ore[e + 1] = s1 * normal23(r.y);
      oim[e + 1] = s1 * normal23(r.w);
    }
  }
}

}  // namespace

extern "C" {

// scale (plane,) f32; seed (2,) i32 in device memory; ore, oim
// (batch, plane) f32.
int noise_planes_launch(const float* scale, const int* seed, float* ore,
                        float* oim, int batch, long long plane,
                        void* stream) {
  if (batch < 1 || plane < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(batch) * plane;
  const int64_t npairs = (total + 1) / 2;
  int64_t blocks = (npairs + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  noise_kernel<<<static_cast<int>(blocks), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(scale, seed, ore, oim,
                                                      plane, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
