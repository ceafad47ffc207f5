// GEMM on CUDA cores: C[M,N] = A[M,K] @ B[K,N], fp32 accumulation.
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
// fp32 design (sgemm_kernel):
// - A block owns a 64x32 tile of C, so 512^3 runs 128 blocks on the 132
//   SMs.  Its KW warps (8 where K allows; kernels/matmul.py, ``plan``)
//   split K between them: warp w takes the 8-deep K slabs w, w + KW, ...,
//   and each warp computes the whole tile over its slabs.  K is not split
//   across blocks: nothing leaves the SM but C.
// - Each warp brings its slabs in with cp.async (LDGSTS) into its own ring
//   of STAGES slabs (A 64x8, B 8x32), two slabs ahead of the one it
//   multiplies, and waits only on its own copies (__syncwarp): no block
//   barrier until the end, so the warps' loads and FMAs interleave freely.
//   Copies are 16 bytes where the operand's rows are 16-byte aligned (K or
//   N a multiple of 4, aligned base) and 4 bytes elsewhere; rows, columns
//   and k-steps past the edge are zero-filled by cp.async (src-size 0),
//   never padded.
// - Each lane keeps an 8x8 register tile: rows ty + 8 i, columns 4 tx +
//   {0..3} and 16 + 4 tx + {0..3} (tx = lane % 4, ty = lane / 4).  A stays
//   as it lies in memory (rows along K, padded to 12 floats so the eight
//   rows a warp reads hit distinct banks) and is read as float4 along K,
//   four k-steps at a time; B is read as two float4 per k-step.  That is
//   16 128-bit shared loads for 256 FMAs: 4 FMAs per float read (cp.async
//   cannot transpose, so A is not stored k-major; reading it along K gives
//   the same loads).
// - At the end every warp parks its sums in shared memory, and warp w sums
//   one KW-th of the tile's rows over the warps in warp order and writes
//   them: the same bits on every run, no atomics.
//
// bf16 has no caller on any path and keeps the first port's kernel
// (simple_kernel: 64x64 tiles, 4x4 register tile, fp32 sums, bf16 output).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::allow_smem;
using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// ---- fp32: per-warp cp.async rings, 8x8 register tile, K split over warps --

constexpr int BM = 64;        // block tile rows
constexpr int BN = 32;        // block tile columns
constexpr int WK = 8;         // k-steps of one warp slab
constexpr int STAGES = 3;     // slabs in each warp's ring
constexpr int MAX_KW = 8;     // warps of a block
constexpr int A_LD = WK + 4;  // padded A slab row (floats)
constexpr int SLAB = BM * A_LD + WK * BN;  // floats of one ring stage
constexpr int RED_LD = BN + 16;  // a warp's parked sums: rows 48 floats apart

__host__ __device__ constexpr size_t sgemm_smem_bytes(int kw) {
  return (size_t)kw * STAGES * SLAB * sizeof(float);
}
// a warp's ring must hold its parked sums
static_assert(STAGES * SLAB >= BM * RED_LD, "ring too small for the sums");

// Store 4 consecutive values of row gr from column gc, as one float4 where
// aligned and inside the matrix.
__device__ __forceinline__ void store4(float* __restrict__ c, int m, int n,
                                       int gr, int gc, const float* v) {
  if (gr >= m) return;
  float* p = c + (size_t)gr * n + gc;
  if (gc + 3 < n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (gc + j < n) p[j] = v[j];
}

// Copy slab ks (k-steps [ks WK, ks WK + WK)) of the block's A rows and B
// columns into ring stage ``st``; each lane issues its fixed share.
template <bool VEC_A, bool VEC_B>
__device__ __forceinline__ void load_slab(
    const float* __restrict__ a, const float* __restrict__ b, float* st,
    int m, int n, int k, int row0, int col0, int ks, int lane) {
  const int k0 = ks * WK;
  float* as = st;
  float* bs = st + BM * A_LD;
  if (VEC_A) {  // 64 rows x 2 chunks: 4 per lane
#pragma unroll
    for (int it = 0; it < BM * WK / 4 / 32; ++it) {
      const int e = lane + 32 * it;
      const int r = e / 2, c = (e % 2) * 4;
      const int gr = row0 + r, gk = k0 + c;
      const bool ok = gr < m && gk < k;  // k % 4 == 0 here
      cp_async16(&as[r * A_LD + c], ok ? a + (size_t)gr * k + gk : a,
                 ok ? 16 : 0);
    }
  } else {  // 64 rows x 8 floats: 16 per lane
#pragma unroll
    for (int it = 0; it < BM * WK / 32; ++it) {
      const int e = lane + 32 * it;
      const int r = e / WK, c = e % WK;
      const int gr = row0 + r, gk = k0 + c;
      const bool ok = gr < m && gk < k;
      cp_async4(&as[r * A_LD + c], ok ? a + (size_t)gr * k + gk : a,
                ok ? 4 : 0);
    }
  }
  if (VEC_B) {  // 8 rows x 8 chunks: 2 per lane
#pragma unroll
    for (int it = 0; it < WK * BN / 4 / 32; ++it) {
      const int e = lane + 32 * it;
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const int gk = k0 + r, gc = col0 + c;
      const bool ok = gk < k && gc < n;  // n % 4 == 0 here
      cp_async16(&bs[r * BN + c], ok ? b + (size_t)gk * n + gc : b,
                 ok ? 16 : 0);
    }
  } else {  // 8 rows x 32 floats: 8 per lane
#pragma unroll
    for (int it = 0; it < WK * BN / 32; ++it) {
      const int e = lane + 32 * it;
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      const bool ok = gk < k && gc < n;
      cp_async4(&bs[r * BN + c], ok ? b + (size_t)gk * n + gc : b,
                ok ? 4 : 0);
    }
  }
}

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(32 * MAX_KW)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int m, int n, int k) {
  // one ring per warp; after the K loop each ring parks its warp's sums
  extern __shared__ __align__(16) float smem[];
  const int kw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tx = lane % 4;
  const int ty = lane / 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float* const ring = smem + (size_t)warp * STAGES * SLAB;
  const int n_slabs = (k + WK - 1) / WK;
  const int my_n = warp < n_slabs ? (n_slabs - warp + kw - 1) / kw : 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < my_n)
      load_slab<VEC_A, VEC_B>(a, b, ring + s * SLAB, m, n, k, row0, col0,
                              warp + s * kw, lane);
    cp_async_commit();
  }
  int st = 0;                 // stage of slab i
  int st_next = STAGES - 1;   // stage of slab i + STAGES - 1
  for (int i = 0; i < my_n; ++i) {
    cp_async_wait<STAGES - 2>();  // slab i has landed (this lane's part)
    __syncwarp();  // ...every lane's; and slab i-1's stage is free again
    if (i + STAGES - 1 < my_n)
      load_slab<VEC_A, VEC_B>(a, b, ring + st_next * SLAB, m, n, k, row0,
                              col0, warp + (i + STAGES - 1) * kw, lane);
    cp_async_commit();
    const float* as = ring + st * SLAB;
    const float* bs = as + BM * A_LD;
#pragma unroll
    for (int k4 = 0; k4 < WK; k4 += 4) {
      float av[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(&as[(ty + 8 * r) * A_LD + k4]);
        av[r][0] = v.x; av[r][1] = v.y; av[r][2] = v.z; av[r][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = &bs[(k4 + kk) * BN];
        const float4 b0 = *reinterpret_cast<const float4*>(&brow[4 * tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&brow[BN / 2 + 4 * tx]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[r][j] = fmaf(av[r][kk], bv[j], acc[r][j]);
      }
    }
    st = st == STAGES - 1 ? 0 : st + 1;
    st_next = st_next == STAGES - 1 ? 0 : st_next + 1;
  }
  cp_async_wait<0>();

  // every warp parks its sums in its own ring; after one barrier warp w
  // sums rows [w BM / kw, (w + 1) BM / kw) over the warps in warp order and
  // writes them to C
  __syncwarp();
  float* const red = smem + (size_t)warp * BM * RED_LD;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float4*>(
          &red[(ty + 8 * r) * RED_LD + (BN / 2) * q + 4 * tx]) =
          make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2],
                      acc[r][4 * q + 3]);
  __syncthreads();
  const int rows = BM / kw;
  for (int e = lane; e < rows * (BN / 4); e += 32) {
    const int r = warp * rows + e / (BN / 4), c4 = (e % (BN / 4)) * 4;
    float4 sum = *reinterpret_cast<const float4*>(&smem[r * RED_LD + c4]);
    for (int w = 1; w < kw; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(
          &smem[(size_t)w * BM * RED_LD + r * RED_LD + c4]);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    const float out[4] = {sum.x, sum.y, sum.z, sum.w};
    store4(c, m, n, row0 + r, col0 + c4, out);
  }
}

// ---- bf16: the first port's kernel -----------------------------------------

constexpr int SB = 64;   // block tile (SB x SB)
constexpr int SK = 16;   // K slab
constexpr int ST = 4;    // register tile (ST x ST)
constexpr int S_THREADS = (SB / ST) * (SB / ST);  // 256

__global__ void __launch_bounds__(S_THREADS)
simple_kernel(const __nv_bfloat16* __restrict__ a,
              const __nv_bfloat16* __restrict__ b,
              __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  __shared__ float as[SK][SB + 1];  // A slab, transposed: as[kk][row]
  __shared__ float bs[SK][SB];      // B slab: bs[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % (SB / ST);
  const int ty = tid / (SB / ST);
  const int row0 = blockIdx.y * SB;
  const int col0 = blockIdx.x * SB;

  float acc[ST][ST];
#pragma unroll
  for (int i = 0; i < ST; ++i)
#pragma unroll
    for (int j = 0; j < ST; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += SK) {
    for (int e = tid; e < SB * SK; e += S_THREADS) {
      const int r = e / SK, kk = e % SK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? __bfloat162float(a[(size_t)gr * k + gk])
                                     : 0.f;
    }
    for (int e = tid; e < SK * SB; e += S_THREADS) {
      const int kk = e / SB, col = e % SB;
      const int gk = k0 + kk, gc = col0 + col;
      bs[kk][col] =
          (gk < k && gc < n) ? __bfloat162float(b[(size_t)gk * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      float av[ST], bv[ST];
#pragma unroll
      for (int i = 0; i < ST; ++i) av[i] = as[kk][ty + i * (SB / ST)];
#pragma unroll
      for (int j = 0; j < ST; ++j) bv[j] = bs[kk][tx + j * (SB / ST)];
#pragma unroll
      for (int i = 0; i < ST; ++i)
#pragma unroll
        for (int j = 0; j < ST; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ST; ++i) {
    const int gr = row0 + ty + i * (SB / ST);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      const int gc = col0 + tx + j * (SB / ST);
      if (gc < n) c[(size_t)gr * n + gc] = __float2bfloat16(acc[i][j]);
    }
  }
}

template <bool VEC_A, bool VEC_B>
int launch_sgemm(const float* a, const float* b, float* c, int m, int n,
                 int k, int kw, cudaStream_t stream) {
  const size_t smem = sgemm_smem_bytes(kw);
  cudaError_t err =
      allow_smem<sgemm_kernel<VEC_A, VEC_B>>(sgemm_smem_bytes(MAX_KW));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  sgemm_kernel<VEC_A, VEC_B><<<grid, 32 * kw, smem, stream>>>(a, b, c, m, n,
                                                              k);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The fp32 kernel's block tile (which = 0 rows, 1 columns) and k-steps per
// warp slab (which = 2), for the host's plan (kernels/matmul.py checks them).
extern "C" int repro_matmul_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : WK;
}

// dtype: 0 = float32, 1 = bfloat16 (a, b and c share it).  fp32 runs
// ceil(M / 64) x ceil(N / 32) blocks of ``kw`` warps (1, 2, 4 or 8) that
// split K between them; bf16 ignores kw.  Returns the CUDA error of the
// launch (0 on success); the kernel runs on ``stream`` and nothing here
// synchronises.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m,
                            int n, int k, int dtype, int kw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (kw < 1 || kw > MAX_KW || (kw & (kw - 1)) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    float* fc = static_cast<float*>(c);
    const bool va = k % 4 == 0 && aligned16(a);
    const bool vb = n % 4 == 0 && aligned16(b);
    if (va && vb) return launch_sgemm<true, true>(fa, fb, fc, m, n, k, kw, s);
    if (va) return launch_sgemm<true, false>(fa, fb, fc, m, n, k, kw, s);
    if (vb) return launch_sgemm<false, true>(fa, fb, fc, m, n, k, kw, s);
    return launch_sgemm<false, false>(fa, fb, fc, m, n, k, kw, s);
  }
  if (dtype == 1) {
    const dim3 grid((n + SB - 1) / SB, (m + SB - 1) / SB);
    simple_kernel<<<grid, S_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
        m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
