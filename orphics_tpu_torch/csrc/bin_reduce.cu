// Weighted segment sum for radial binning (kernel B1 of the port).
//
//   out[b, s] = sum_n data[b, n] * w[n] * [ids[n] == s],   s in [0, nseg)
//
// Replaces orphics_tpu/ops/pallas_kernels.py:bin_matmul (_bin_reduce_kernel),
// a one-hot bf16 hi/lo MXU contraction on the TPU.
//
// Bound: reading the data once, 4 B per element (ids and weights are shared
// by every batch row and stay in L2); the arithmetic is one fp64 add per
// element.
//
// Design: shared-memory partials. A block owns one batch row and one chunk
// of CHUNK elements. Every thread keeps its own fp64 partial per segment in
// shared memory (slot [s * THREADS + tid], so a warp touches 32 consecutive
// slots and no two threads ever share one): no atomics anywhere. The block
// then reduces its slots per segment in a fixed order (warp shuffles, then
// the warps in index order) and writes one fp64 partial per (chunk, row,
// segment) to scratch. A second kernel sums the chunks in index order. The
// result is therefore bit-reproducible from run to run.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;

__global__ void __launch_bounds__(THREADS)
bin_chunk_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                 const float* __restrict__ w, double* __restrict__ scratch,
                 int B, int N, int nseg) {
  extern __shared__ double slot[];          // [nseg][THREADS]
  __shared__ double warp_sum[THREADS / 32];
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  for (int s = 0; s < nseg; ++s) slot[s * THREADS + tid] = 0.0;

  const float* row = data + static_cast<int64_t>(b) * N;
  const int base = chunk * CHUNK + tid;
  float v[PER_THREAD];
  int seg[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int n = base + k * THREADS;
    const bool in = n < N;
    v[k] = in ? row[n] * (w ? w[n] : 1.0f) : 0.0f;
    seg[k] = in ? ids[n] : -1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    if (static_cast<unsigned>(seg[k]) < static_cast<unsigned>(nseg))
      slot[seg[k] * THREADS + tid] += static_cast<double>(v[k]);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  double* out = scratch + (static_cast<int64_t>(chunk) * B + b) * nseg;
  for (int s = 0; s < nseg; ++s) {
    double x = slot[s * THREADS + tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sum[warp] = x;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
#pragma unroll
      for (int i = 0; i < THREADS / 32; ++i) t += warp_sum[i];
      out[s] = t;
    }
    __syncthreads();
  }
}

__global__ void bin_finish_kernel(const double* __restrict__ scratch,
                                  float* __restrict__ out, int nchunks,
                                  int B, int nseg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // i = b * nseg + s
  if (i >= B * nseg) return;
  double t = 0.0;
  for (int c = 0; c < nchunks; ++c)
    t += scratch[static_cast<int64_t>(c) * B * nseg + i];
  out[i] = static_cast<float>(t);
}

}  // namespace

extern "C" {

int bin_reduce_chunk() { return CHUNK; }

int bin_reduce_max_nseg() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // leave room for the static warp_sum array
  return (optin - 1024) / (THREADS * static_cast<int>(sizeof(double)));
}

// data (B, N) f32, ids (N,) i32, w (N,) f32 or null, scratch (nchunks, B,
// nseg) f64 with nchunks = ceil(N / CHUNK), out (B, nseg) f32.
int bin_reduce_launch(const float* data, const int* ids, const float* w,
                      double* scratch, float* out, int B, int N, int nseg,
                      void* stream) {
  const int nchunks = (N + CHUNK - 1) / CHUNK;
  const size_t smem = static_cast<size_t>(nseg) * THREADS * sizeof(double);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      bin_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_chunk_kernel<<<dim3(nchunks, B), THREADS, smem, s>>>(data, ids, w,
                                                           scratch, B, N, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = B * nseg;
  bin_finish_kernel<<<(total + 255) / 256, 256, 0, s>>>(scratch, out, nchunks,
                                                        B, nseg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
