// Causal per-filter FIR bank: y[f, n] = sum_k h[f, k] * x[f, n - k], with
// zero history before n = 0, fp32 throughout.
//
// Replaces: src/repro/kernels/tdfir.py, _tdfir_kernel / tdfir (the Pallas
// tdFIR kernel behind the tdFIR function block and the loop `pallas` impl;
// tdfir_complex stays four launches of this kernel).
//
// Bound on the H100: operations.  One real FIR at the paper's F=64, N=4096,
// K=128 is 2*64*4096*128 = 6.7e7 FLOP (about 1.0 us at the 67 TFLOP/s
// non-tensor fp32 peak; TF32 would break the reference's 3e-4 contract)
// against 2.1 MB of traffic (about 0.64 us at 3.35 TB/s).
//
// Design: one block per (N-tile, filter), one thread per output sample.  The
// block stages the K taps and the tile's input window (tile + K - 1 samples,
// zeros before n = 0 and past N) in shared memory once, so every x sample is
// read from device memory about (tile + K - 1) / tile times instead of K
// times, and each thread then runs the K-tap loop in fp32 FMAs out of shared
// memory (tap reads are broadcasts, window reads are unit-stride across the
// warp).  The TPU kernel's block_n >= K constraint does not apply: any K whose
// taps and window fit in the 48 KB of static-launch shared memory works, and
// the wrapper raises above that.
#include <cuda_runtime.h>

namespace {

__global__ void tdfir_kernel(const float* __restrict__ x,
                             const float* __restrict__ h,
                             float* __restrict__ y, int n, int k) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  float* hs = smem;       // k taps
  float* xs = smem + k;   // tile + k - 1 window samples

  const int f = blockIdx.y;
  const int n0 = blockIdx.x * tile;
  const float* xf = x + (size_t)f * n;
  const float* hf = h + (size_t)f * k;

  for (int t = threadIdx.x; t < k; t += tile) hs[t] = hf[t];
  const int window = tile + k - 1;
  for (int t = threadIdx.x; t < window; t += tile) {
    const int src = n0 - (k - 1) + t;
    xs[t] = (src >= 0 && src < n) ? xf[src] : 0.f;
  }
  __syncthreads();

  const int out = n0 + threadIdx.x;
  if (out >= n) return;
  const float* xw = xs + threadIdx.x + (k - 1);  // xw[-kk] == x[out - kk]
  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) acc = fmaf(hs[kk], xw[-kk], acc);
  y[(size_t)f * n + out] = acc;
}

}  // namespace

// x, y: [f, n] float32; h: [f, k] float32; `tile` output samples per block
// (at most 1024).  Returns the CUDA error of the launch (0 on success); the
// kernel runs on `stream` and nothing here synchronises.
extern "C" int repro_tdfir(const void* x, const void* h, void* y, int f, int n,
                           int k, int tile, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * k + tile - 1);
  const dim3 grid((n + tile - 1) / tile, f);
  tdfir_kernel<<<grid, tile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<float*>(y), n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
