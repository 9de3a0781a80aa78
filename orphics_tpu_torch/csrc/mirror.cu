// Fourier-plane mirror Zm(k) = Z(-k) in the doubly-permuted ("pp") layout
// (kernel B7 of the port). Bit-exact: a copy.
//
//   out[b, p, q] = in[b, mrow[p], mrow[q]]
//
// with mrow[p] the row_perm slot of the frequency -k(p)
// (dft.py:_mirror_tables, as pallas_fft.py:_mirror_tables).
//
// Replaces orphics_tpu/ops/pallas_fft.py:mirror_pp (_mirror_kernel), which
// on the TPU copies 8-row blocks, reverses them in registers and lanes with
// a 0/1 matmul, and patches the strips where the mirror wraps (k2 = 0)
// with separate gathers.
//
// Bound: device memory, 8 B read and 8 B written per complex element.
//
// Design: one thread per output element of the re and im planes, the
// source index from a device table. Inside a 128-block mrow runs backwards,
// so a warp still reads one contiguous (descending) 128-byte span and
// writes one ascending span; the wrap strips need no special case.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void mirror_kernel(const float* __restrict__ zr,
                              const float* __restrict__ zi,
                              const int* __restrict__ mrow,
                              float* __restrict__ orr, float* __restrict__ oi,
                              int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y * blockDim.y + threadIdx.y;
  if (p >= n || q >= n) return;
  const int64_t plane = static_cast<int64_t>(n) * n;
  const int64_t b = static_cast<int64_t>(blockIdx.z) * plane;
  const int64_t src = b + static_cast<int64_t>(mrow[p]) * n + mrow[q];
  const int64_t dst = b + static_cast<int64_t>(p) * n + q;
  orr[dst] = zr[src];
  oi[dst] = zi[src];
}

}  // namespace

extern "C" {

// zr, zi, orr, oi (batch, n, n) f32; mrow (n,) i32 in device memory.
int mirror_launch(const float* zr, const float* zi, const int* mrow,
                  float* orr, float* oi, int batch, int n, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const dim3 grid((n + 31) / 32, (n + 7) / 8, batch);
  mirror_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      zr, zi, mrow, orr, oi, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
