// Tiled GEMM on CUDA cores: C[M,N] = A[M,K] @ B[K,N], fp32 accumulation.
//
// Replaces: src/repro/kernels/matmul.py, _matmul_kernel / matmul (the
// Pallas MXU-tiled matmul behind the 3mm `pallas` impl).
//
// Bound on the H100: operations.  The fp32 path must not run as TF32 (the
// reference holds it to 1e-5), and on Hopper's tensor cores fp32 exists only
// as TF32, so fp32 runs on the CUDA cores at the 67 TFLOP/s non-tensor peak.
// At 3mm's 512^3 that is 2.7e8 FLOP (about 4.0 us) against 3.1 MB of traffic
// (about 0.94 us at 3.35 TB/s).
//
// Design: each 256-thread block owns a 64x64 tile of C.  It walks K in
// 16-deep slabs, staging the A slab (transposed, padded against bank
// conflicts) and the B slab in shared memory, and every thread keeps a 4x4
// register tile of fp32 sums (rows ty + 16*i, cols tx + 16*j, so shared reads
// and the C stores are unit-stride across a half-warp).  Each staged value is
// reused 64 times from shared memory.  Ragged M/N/K edges are masked at the
// loads and the store instead of padding the operands.  bf16 operands take the
// same kernel and the same fp32 sums; the output is written in the input
// type.  wgmma / mma.sync for bf16 is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int m, int n, int k) {
  __shared__ float as[BK][BM + 1];  // A slab, transposed: as[kk][row]
  __shared__ float bs[BK][BN];      // B slab: bs[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? to_float(a[(size_t)gr * k + gk]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, col = e % BN;
      const int gk = k0 + kk, gc = col0 + col;
      bs[kk][col] = (gk < k && gc < n) ? to_float(b[(size_t)gk * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + i * (BM / TM);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + j * (BN / TN);
      if (gc < n) c[(size_t)gr * n + gc] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and c share it).  Returns the CUDA
// error of the launch (0 on success); the kernel runs on `stream` and nothing
// here synchronises.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m,
                            int n, int k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, b, c, m, n, k, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(a, b, c, m, n, k, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
