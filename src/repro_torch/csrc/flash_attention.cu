// Flash (online-softmax) attention on CUDA cores, the prefill attention of
// the LM: O[bh] = softmax(Q[bh] K[g]^T / sqrt(D), causal mask) V[g] with
// g = bh / kv_group (grouped-query attention reads its KV head in place).
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention (the Pallas online-softmax kernel; grid (BH, Sq/bq,
// Skv/bkv) with the (m, l, acc) carry in VMEM across the kv grid axis).
//
// Numerics follow the TPU kernel: scores and the (max, denominator,
// accumulator) carries in fp32, masked scores set to NEG_INF = -1e30 (not
// -inf) and their probabilities zeroed, p rounded to V's type before the PV
// product, the denominator floored at 1e-20.
//
// Bound on the H100: operations.  Causal prefill at the serving path's
// shapes (1 x 32 heads x 2048 x 64, bf16) is 1.7e10 FLOP against 21 MB of
// q/k/v/o, so even the bf16 tensor-core peak (989 TFLOP/s, ~17 us) sits far
// above the memory time (~6 us).  This first version runs fp32 FMAs on the
// CUDA cores; mma.sync / wgmma tiles and TMA are later work.
//
// Design: one 256-thread block per (64-row query tile, bh).  The block stages
// its Q tile once in shared memory (fp32), then walks the keys in 32-row
// tiles: stage K and V, compute the 64x32 score tile (each thread a 4x2
// register tile), run the online-softmax update with four threads per query
// row (shuffle reductions), and fold P V into a 4 x (D/16) register tile of
// the accumulator per thread.  Under the causal mask the walk stops after
// the tile holding the last query row's own key, which skips exactly the
// tiles the TPU grid ran fully masked (they left every carry unchanged).
// Ragged Sq and Skv are masked at the loads and the store, so any length
// works; row and sequence strides are arguments, so q/k/v may be views of
// the model's [B, S, H, D] projections.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 32;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16; four threads per query row in softmax

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
// p.astype(v.dtype) of the TPU kernel, read back as fp32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <int D> constexpr size_t smem_floats() {
  return BQ * (D + 1)          // qs: Q tile (padded rows: no bank conflicts)
         + BKV * (D + 1)       // ks: K tile
         + BKV * D             // vs: V tile
         + BQ * (BKV + 1)      // ss: scores, then p
         + 3 * BQ;             // running max, denominator, correction
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
             int kv_group, int causal, float scale, long long q_sb,
             long long q_ss, long long k_sb, long long k_ss, long long v_sb,
             long long v_ss) {
  constexpr int TJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * (D + 1);
  float* vs = ks + BKV * (D + 1);
  float* ss = vs + BKV * D;
  float* m_s = ss + BQ * (BKV + 1);
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + bh * q_sb;
  const T* kb = k + (bh / kv_group) * k_sb;
  const T* vb = v + (bh / kv_group) * v_sb;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int gr = q0 + r;
    qs[r * (D + 1) + d] = gr < sq ? to_float(qb[gr * q_ss + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][TJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;

  // keys past the tile's last query row are masked for all of its rows
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  __syncthreads();

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int gk = k0 + r;
      const bool ok = gk < skv;
      ks[r * (D + 1) + d] = ok ? to_float(kb[gk * k_ss + d]) : 0.f;
      vs[r * D + d] = ok ? to_float(vb[gk * v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sacc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sacc[i][0] = sacc[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float av[4], bv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) bv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sacc[i][j] = fmaf(av[i], bv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = tx + 16 * j;
        const int kpos = k0 + col;
        const bool valid = kpos < skv && (!causal || q0 + row >= kpos);
        ss[row * (BKV + 1) + col] = valid ? sacc[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: four threads per query row, eight keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* srow = ss + r * (BKV + 1) + part * 8;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + part * 8 + c;
        const bool valid = kpos < skv && (!causal || q0 + r >= kpos);
        const float p = valid ? expf(srow[c] - m_new) : 0.f;
        sum += p;
        srow[c] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[4], vv[TJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty + 16 * i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < TJ; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites ks, vs and ss
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int gr = q0 + row;
    if (gr >= sq) continue;
    const float den = fmaxf(l_s[row], 1e-20f);
    T* orow = o + ((size_t)bh * sq + gr) * D;
#pragma unroll
    for (int j = 0; j < TJ; ++j)
      orow[tx + 16 * j] = from_float<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int kv_group, int causal, float scale,
           long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  // above 48 KB (D = 128) only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, kv_group, causal,
      scale, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int bh, int sq, int skv, int kv_group, int causal, float scale,
             long long q_sb, long long q_ss, long long k_sb, long long k_ss,
             long long v_sb, long long v_ss, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, bh, sq, skv, kv_group, causal, scale,
                           q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, s);
    case 32:
      return launch<T, 32>(q, k, v, o, bh, sq, skv, kv_group, causal, scale,
                           q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, s);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, sq, skv, kv_group, causal, scale,
                           q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, s);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, sq, skv, kv_group, causal, scale,
                            q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [bh, sq, d] with strides (q_sb, q_ss, 1); k, v [bh / kv_group, skv, d]
// with their own strides; o [bh, sq, d] contiguous.  dtype: 0 = float32,
// 1 = bfloat16 (shared by all four).  d in {16, 32, 64, 128}.  Returns the
// CUDA error of the launch (0 on success); nothing here synchronises.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int bh, int sq,
    int skv, int d, int kv_group, int causal, float scale, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, o, bh, sq, skv, kv_group, causal,
                           scale, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, bh, sq, skv, kv_group,
                                   causal, scale, q_sb, q_ss, k_sb, k_ss,
                                   v_sb, v_ss, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
