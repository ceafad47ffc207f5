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
// bf16 (hgemm_kernel): the same function, C rounded once to bf16 from fp32
// sums.  It replaces the first port's CUDA-core kernel (64x64 tiles, a 4x4
// register tile of fp32 FMAs), which at 512^3 took 0.0639 ms against
// torch.matmul's 0.0033: bf16 is bound by operations only on the tensor
// cores (512^3: 2.7e8 FLOP, 0.27 us at 989 TFLOP/s, under the 1.57 MB of
// traffic's 0.47 us; granite's MLP up-projection, [8192, 2048] @ [2048,
// 8192]: 2.75e11 FLOP, 0.278 ms, over 201 MB's 0.060 ms), so the design
// is Hopper's GEMM shape:
// - A block owns a BM x BN tile of C (BM = 64 per consumer warpgroup).
//   One producer warp (its lane 0) streams K in 64-deep tiles through a
//   ring of STAGES shared-memory stages by TMA: per stage one A box [BM
//   rows, 64 k] and BN / 64 B boxes [64 k, 64 columns], all with the
//   128-byte swizzle, guarded by a "full" mbarrier (transaction bytes)
//   and an "empty" one (an arrival per consumer warp), as
//   csrc/flash_attention.cu's K/V ring is.
// - Each consumer warpgroup runs wgmma.m64nBNk16 over its 64 rows, four
//   k16 steps a stage, with the fp32 sums in registers for the whole K
//   walk.  A is row-major [M, K], K-major as wgmma wants it; B is row-major
//   [K, N], MN-major, and goes in as it lies through wgmma's transpose bit
//   (both operands from shared memory: hopper::WgmmaSSt).  Loading A into
//   registers for the register-A form (hopper::WgmmaRS) would cost ldmatrix
//   traffic the shared-memory form does not.  A warpgroup keeps one stage's
//   products in flight (wgmma.wait_group 1) and frees the stage before.
// - The epilogue rounds each sum once to bf16 and stores it from the
//   accumulator fragments, masked at the ragged edge; TMA zero-fills the
//   rows, columns and k past the matrices, so any M, N, K work.  No
//   atomics and a fixed order: repeated calls give the same bits.
// - Tiles (kernels/matmul.py, ``bf16_plan``): 128 x 256 (two consumer
//   warpgroups) where that grid holds at least 64 blocks, else 64 x 64
//   (one), so 512^3 runs 64 blocks rather than 16 (scripts/
//   matmul_routes.py times each).  Blocks walk the tiles in groups of
//   GROUP_M tile rows so that neighbours share A and B panels in L2.
// TMA needs 16-byte aligned bases and row strides: K % 8 == 0 for A and
// N % 8 == 0 for B.  Other operands take hgemm_ldg_kernel, the unaligned
// route: the same stages, swizzle and wgmma on 64 x 64 tiles, each stage
// filled from registers (bf16 loads, zeros past the edges) while the
// other stage's products run.  cp.async cannot fill those stages: it
// copies 4, 8 or 16 aligned bytes, and a row of odd K starts on an odd
// bf16 element.
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

// ---- bf16: wgmma over 64-deep K tiles in 128-byte swizzled stages ---------

constexpr int HK = 64;       // k of one stage: a 128-byte swizzle row
constexpr int GROUP_M = 8;   // tile rows a group of consecutive blocks walks

// A bf16 tile configuration: NWG consumer warpgroups (BM = 64 NWG rows),
// BN columns, a ring of STAGES stages, and one producer warp.
template <int NWG, int BN, int STAGES> struct HCfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int A_BYTES = BM * HK * 2;     // one A box
  static constexpr int B_BYTES = HK * BN * 2;     // BN / 64 B boxes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 1024 bytes of slack to align the stages, then 2 STAGES mbarriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(SMEM <= 227 * 1024, "a block opts into at most 227 KB");
  static_assert(BN % 64 == 0 && BN <= 256, "B boxes are 64 columns wide");
};

// the unaligned route: one warpgroup, a 64 x 64 tile, two stages filled
// from registers (1024 bytes of alignment slack, no mbarriers)
constexpr int U_THREADS = 128;
constexpr int U_STAGE = 2 * 64 * HK * 2;
constexpr int U_SMEM = 1024 + 2 * U_STAGE;

// the bf16 routes of repro_matmul (``kw``; kernels/matmul.py, bf16_plan)
constexpr int ROUTE_UNALIGNED = 0;  // hgemm_ldg_kernel: any operands
constexpr int ROUTE_SMALL = 1;      // HCfg<1, 64, 4>: 64 x 64 tiles
constexpr int ROUTE_WIDE = 2;       // HCfg<2, 256, 4>: 128 x 256 tiles

// The first row and column of block ``pid``'s bm x bn tile: consecutive
// blocks walk GROUP_M tile rows column by column (kernels/matmul.py,
// ``tile_of``), so the blocks in flight share A and B panels in L2.
__device__ __forceinline__ void tile_origin(int pid, int grid_m, int grid_n,
                                            int bm, int bn, int* m0,
                                            int* n0) {
  const int per_group = GROUP_M * grid_n;
  const int first = pid / per_group * GROUP_M;
  const int rows = min(grid_m - first, GROUP_M);
  *m0 = (first + pid % per_group % rows) * bm;
  *n0 = pid % per_group / rows * bn;
}

// One stage's products into acc: four k16 steps, 32 bytes along the
// warpgroup's 64 swizzled A rows at ``a_tile``, 16 rows down the B boxes
// at ``b_tile`` (the next 64 columns of B lie HK * 128 bytes on).
template <int BN>
__device__ __forceinline__ void stage_mma(float (&acc)[BN / 2],
                                          uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < HK / 16; ++kk) {
    const uint64_t da = hopper::smem_desc(a_tile + kk * 32, 16, 8 * 128, 1);
    const uint64_t db =
        hopper::smem_desc(b_tile + kk * 16 * 128, HK * 128, 8 * 128, 1);
    hopper::WgmmaSSt<BN>::run(acc, da, db, 1);
  }
}

// Round and store this thread's share of a warpgroup's 64 x BN sums: its
// row r0 (16 warp + lane / 4 into the warpgroup's rows) and column c0
// (2 (lane % 4) into the tile); acc[4 j + {0, 1}] is row r0, columns c0 +
// 8 j + {0, 1}, and acc[4 j + {2, 3}] the same columns of row r0 + 8.
// PAIRS: N % 8 == 0, so a column pair is inside C or past it whole, and
// 4-byte aligned.
template <int BN, bool PAIRS>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           __nv_bfloat16* __restrict__ c,
                                           int m, int n, int r0, int c0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= m) continue;
    __nv_bfloat16* row = c + static_cast<size_t>(r) * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j;
      const float lo = acc[4 * j + 2 * h], hi = acc[4 * j + 2 * h + 1];
      if (PAIRS) {
        if (col < n)
          *reinterpret_cast<uint32_t*>(row + col) = hopper::pack_bf16x2(lo, hi);
      } else {
        if (col < n) row[col] = __float2bfloat16(lo);
        if (col + 1 < n) row[col + 1] = __float2bfloat16(hi);
      }
    }
  }
}

template <int NWG, int BN, int STAGES>
__global__ void __launch_bounds__(HCfg<NWG, BN, STAGES>::THREADS, 1)
hgemm_kernel(const __grid_constant__ CUtensorMap tm_a,
             const __grid_constant__ CUtensorMap tm_b,
             __nv_bfloat16* __restrict__ c, int m, int n, int k, int grid_m,
             int grid_n) {
  using C = HCfg<NWG, BN, STAGES>;
  extern __shared__ __align__(1024) uint8_t ring_smem[];
  const uint32_t ring = (hopper::smem_u32(ring_smem) + 1023u) & ~1023u;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
  const uint32_t bars = ring + STAGES * C::STAGE_BYTES;
  const int tid = threadIdx.x;
  const int n_k = (k + HK - 1) / HK;
  int m0, n0;
  tile_origin(blockIdx.x, grid_m, grid_n, C::BM, BN, &m0, &n0);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (STAGES + s), 4 * NWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * NWG) {
    // the producer warp: its lane 0 keeps the ring full
    if (tid == 128 * NWG) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES)  // the consumers have freed tile t - STAGES
          hopper::mbar_wait(bars + 8 * (STAGES + s), (t / STAGES - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t dst = ring + s * C::STAGE_BYTES;
        hopper::mbar_expect_tx(full, C::STAGE_BYTES);
        hopper::tma_load_3d(dst, &tm_a, t * HK, m0, 0, full);
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb)
          hopper::tma_load_3d(dst + C::A_BYTES + cb * HK * 128, &tm_b,
                              n0 + 64 * cb, t * HK, 0, full);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % STAGES;
    const uint32_t stage = ring + s * C::STAGE_BYTES;
    hopper::mbar_wait(bars + 8 * s, (t / STAGES) & 1);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    stage_mma<BN>(acc, stage + wg * 64 * 128, stage + C::A_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // tile t - 1's products are done: free it
    hopper::fence_regs(acc);
    if (t > 0 && lane == 0)
      hopper::mbar_arrive(bars + 8 * (STAGES + (t - 1) % STAGES));
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  store_tile<BN, true>(acc, c, m, n, m0 + tid / 32 * 16 + lane / 4,
                       n0 + 2 * (lane % 4));
}

// Byte offset of element (r, col) of a [rows, 64] bf16 box in the 128-byte
// swizzle TMA writes: 16-byte chunk col / 8 of row r moves to chunk
// (col / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swizzled(int r, int col) {
  return r * 128 + (((col >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// The unaligned route: operands TMA cannot map (a row stride or base that
// is not 16-byte aligned) go through registers into the swizzled layout of
// hgemm_kernel's stages, then through the same wgmma.  One warpgroup owns a
// 64 x 64 tile; its threads load K tile t + 1 (bf16 pairs along a row,
// zeros past the edges) while tile t's products run.
__global__ void __launch_bounds__(U_THREADS, 1)
hgemm_ldg_kernel(const uint16_t* __restrict__ a,
                 const uint16_t* __restrict__ b,
                 __nv_bfloat16* __restrict__ c, int m, int n, int k,
                 int grid_m, int grid_n) {
  extern __shared__ __align__(1024) uint8_t ring_smem[];
  const uint32_t ring = (hopper::smem_u32(ring_smem) + 1023u) & ~1023u;
  uint8_t* const ring_ptr = ring_smem + (ring - hopper::smem_u32(ring_smem));
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n_k = (k + HK - 1) / HK;
  int m0, n0;
  tile_origin(blockIdx.x, grid_m, grid_n, 64, 64, &m0, &n0);

  // pair p = tid + 128 i of a 64 x 64 box: row p / 32, columns 2 (p % 32)
  // and one more; a pair's two halves are fetched on their own
  constexpr int PAIRS = 64 * 64 / 2 / U_THREADS;
  uint32_t ra[PAIRS], rb[PAIRS];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = tid + U_THREADS * i;
      const int r = p / 32, col = 2 * (p % 32);
      const int gr = m0 + r, gk = t * HK + col;  // A: row gr, k gk
      const size_t ia = static_cast<size_t>(gr) * k + gk;
      const uint32_t a0 = gr < m && gk < k ? a[ia] : 0;
      const uint32_t a1 = gr < m && gk + 1 < k ? a[ia + 1] : 0;
      ra[i] = a0 | a1 << 16;
      const int bk = t * HK + r, gc = n0 + col;  // B: row bk, column gc
      const size_t ib = static_cast<size_t>(bk) * n + gc;
      const uint32_t b0 = bk < k && gc < n ? b[ib] : 0;
      const uint32_t b1 = bk < k && gc + 1 < n ? b[ib + 1] : 0;
      rb[i] = b0 | b1 << 16;
    }
  };
  auto put = [&](int s) {
    uint8_t* const st = ring_ptr + s * U_STAGE;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = tid + U_THREADS * i;
      const int r = p / 32, col = 2 * (p % 32);
      *reinterpret_cast<uint32_t*>(st + swizzled(r, col)) = ra[i];
      *reinterpret_cast<uint32_t*>(st + U_STAGE / 2 + swizzled(r, col)) =
          rb[i];
    }
    // the stores (generic proxy) before wgmma reads them (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (n_k > 0) {
    fetch(0);
    put(0);
  }
  __syncthreads();
  for (int t = 0; t < n_k; ++t) {
    const uint32_t stage = ring + (t & 1) * U_STAGE;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    stage_mma<64>(acc, stage, stage + U_STAGE / 2);
    hopper::wgmma_commit();
    // tile t - 1, the other stage's last reader, finished last iteration
    if (t + 1 < n_k) {
      fetch(t + 1);
      put((t + 1) & 1);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncthreads();
  }
  store_tile<64, false>(acc, c, m, n, m0 + tid / 32 * 16 + lane / 4,
                        n0 + 2 * (lane % 4));
}

// C = A B on hgemm_kernel<NWG, BN, STAGES>: a and b 16-byte aligned, K and
// N multiples of 8, K > 0
template <int NWG, int BN, int STAGES>
int launch_hgemm(const void* a, const void* b, void* c, int m, int n, int k,
                 cudaStream_t stream) {
  using C = HCfg<NWG, BN, STAGES>;
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return hopper::ERR_NO_ENCODER;
  // each operand a one-"head" map: A boxes [BM rows, 64 k], B boxes
  // [64 k, 64 columns], rows and columns past the matrix zero-filled
  CUtensorMap ta, tb;
  bool inner;
  if (!hopper::encode(fn, &ta, a, 1, m, k, static_cast<long long>(m) * k, k,
                      C::BM, HK, CU_TENSOR_MAP_SWIZZLE_128B, &inner) ||
      !hopper::encode(fn, &tb, b, 1, k, n, static_cast<long long>(k) * n, n,
                      HK, 64, CU_TENSOR_MAP_SWIZZLE_128B, &inner))
    return hopper::ERR_ENCODE;
  cudaError_t err = allow_smem<hgemm_kernel<NWG, BN, STAGES>>(C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid_m = (m + C::BM - 1) / C::BM;
  const int grid_n = (n + BN - 1) / BN;
  hgemm_kernel<NWG, BN, STAGES><<<grid_m * grid_n, C::THREADS, C::SMEM,
                                  stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), m, n, k, grid_m, grid_n);
  return static_cast<int>(cudaGetLastError());
}

int launch_hgemm_ldg(const void* a, const void* b, void* c, int m, int n,
                     int k, cudaStream_t stream) {
  const int grid_m = (m + 63) / 64, grid_n = (n + 63) / 64;
  hgemm_ldg_kernel<<<grid_m * grid_n, U_THREADS, U_SMEM, stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<__nv_bfloat16*>(c), m, n, k, grid_m, grid_n);
  return static_cast<int>(cudaGetLastError());
}

// (BM, BN, stages, threads, dynamic shared bytes) of a TMA route
template <int NWG, int BN, int STAGES>
int hcfg_field(int which) {
  using C = HCfg<NWG, BN, STAGES>;
  const int f[5] = {C::BM, BN, STAGES, C::THREADS, C::SMEM};
  return which >= 0 && which < 5 ? f[which] : -1;
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

// A bf16 route's (which =) 0 block rows, 1 block columns, 2 ring stages,
// 3 threads and 4 dynamic shared bytes, for the host's plan (kernels/
// matmul.py checks them); -1 for an unknown route or field.
extern "C" int repro_matmul_bf16_tile(int route, int which) {
  switch (route) {
    case ROUTE_UNALIGNED: {
      const int f[5] = {64, 64, 2, U_THREADS, U_SMEM};
      return which >= 0 && which < 5 ? f[which] : -1;
    }
    case ROUTE_SMALL: return hcfg_field<1, 64, 4>(which);
    case ROUTE_WIDE: return hcfg_field<2, 256, 4>(which);
  }
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (a, b and c share it).  fp32 runs
// ceil(M / 64) x ceil(N / 32) blocks of ``kw`` warps (1, 2, 4 or 8) that
// split K between them; for bf16 ``kw`` is the route (ROUTE_*), and the
// TMA routes refuse operands they cannot map (an unaligned base, K or N
// not a multiple of 8, K = 0).  Returns the CUDA error of the launch (0 on
// success; hopper::ERR_* for a tensor map); the kernel runs on ``stream``
// and nothing here synchronises.
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
  if (dtype == 1 && kw == ROUTE_UNALIGNED)
    return launch_hgemm_ldg(a, b, c, m, n, k, s);
  if (dtype == 1) {
    if (k <= 0 || k % 8 != 0 || n % 8 != 0 || !aligned16(a) || !aligned16(b))
      return static_cast<int>(cudaErrorInvalidValue);
    if (kw == ROUTE_SMALL) return launch_hgemm<1, 64, 4>(a, b, c, m, n, k, s);
    if (kw == ROUTE_WIDE) return launch_hgemm<2, 256, 4>(a, b, c, m, n, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return hopper::error_string(
      err, "cuTensorMapEncodeTiled refused the bf16 matmul's tensor maps");
}
