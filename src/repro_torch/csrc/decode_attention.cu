// Split-K decode attention on CUDA cores: one new query token per (slot,
// head) attends over that slot's KV cache, read in place in the serving
// pool's grouped layout [B, S, KV, D].  Query head h reads KV head
// h / (H / KV); key s of slot b is valid iff s < cache_len[b].
//
// Replaces: src/repro/kernels/decode_attention.py, _decode_kernel /
// decode_attention (the Pallas FlashDecoding-style kernel: one query per BH
// row, the cache tiled along S on the innermost grid axis with an
// online-softmax carry; its docstring names the split-K partials + logsumexp
// merge this file builds).
//
// Numerics follow the TPU kernel: fp32 scores and (max, denominator,
// accumulator), masked keys at NEG_INF = -1e30 with p zeroed, p rounded to
// V's type before the PV product, the denominator floored at 1e-20.
//
// Bound on the H100: bytes.  A decode step reads each valid cache entry once
// and does 4 FLOP per byte-pair of it; at the serving path's shapes (4 slots
// x 32 heads over a [4, 2112, 8, 64] bf16 cache) the valid K/V are a few MB,
// microseconds at 3.35 TB/s.
//
// Design: pass 1 runs one 128-thread block per (split of CHUNK keys, slot,
// KV head).  The block stages the group's rep = H / KV query rows once, so
// every K/V tile it loads serves all of them (the cache is never repeated
// per query head), and walks its split in 32-key tiles: stage K and V
// (masked past cache_len), one thread per (query row, key) score, one warp
// per query row for the online-softmax update, and each thread folds P V
// into its share of the rep x D accumulator.  It writes the split's
// unnormalised (m, l, acc) partial.  Splits that start at or past
// cache_len[b] return at once, so the work follows each slot's own length.
// Pass 2 (one block per (slot, head), one thread per channel) merges the
// live splits with a logsumexp rescale and divides.  The split count is
// fixed by CHUNK; tuning it to the 132 SMs is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int CHUNK = 128;     // keys per split
constexpr int TK = 32;         // keys per tile (one warp lane each)
constexpr int THREADS = 128;
constexpr int MAX_ACC = 16;    // accumulator entries per thread: rep*D <= 2048

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
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__host__ __device__ inline size_t split_smem_floats(int rep, int d) {
  return static_cast<size_t>(rep) * d  // qs: the group's query rows
         + TK * (d + 1)                // ks: K tile (padded rows)
         + TK * d                      // vs: V tile
         + rep * TK                    // ss: scores, then p
         + 3 * rep;                    // running max, denominator, correction
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, const int* __restrict__ cache_len,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int h, int kvh, int s_len,
             int n_splits, float scale) {
  extern __shared__ float smem[];
  const int rep = h / kvh;
  float* qs = smem;
  float* ks = qs + rep * D;
  float* vs = ks + TK * (D + 1);
  float* ss = vs + TK * D;
  float* m_s = ss + rep * TK;
  float* l_s = m_s + rep;
  float* corr_s = l_s + rep;

  const int split = blockIdx.x;
  const int b = blockIdx.y / kvh;
  const int g = blockIdx.y % kvh;
  const int len = min(cache_len[b], s_len);
  const int s_begin = split * CHUNK;
  const int s_end = min(s_begin + CHUNK, len);
  if (s_begin >= s_end) return;  // pass 2 reads only the live splits

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int head0 = b * h + g * rep;  // first query row of the group

  for (int e = tid; e < rep * D; e += THREADS)
    qs[e] = to_float(q[(size_t)head0 * D + e]);
  for (int r = tid; r < rep; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = s_begin; t0 < s_end; t0 += TK) {
    const int n = min(TK, s_end - t0);
    for (int e = tid; e < TK * D; e += THREADS) {
      const int j = e / D, d = e % D;
      const bool ok = j < n;
      const size_t at = (((size_t)b * s_len + t0 + j) * kvh + g) * D + d;
      ks[j * (D + 1) + d] = ok ? to_float(kc[at]) : 0.f;
      vs[j * D + d] = ok ? to_float(vc[at]) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < rep * TK; e += THREADS) {
      const int r = e / TK, j = e % TK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[r * D + d], ks[j * (D + 1) + d], s);
      ss[r * TK + j] = j < n ? s * scale : NEG_INF;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += THREADS / 32) {
      const float sv = ss[r * TK + lane];
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < n ? expf(sv - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ss[r * TK + lane] = round_to<T>(p);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAX_ACC; ++i) {
      const int e = tid + i * THREADS;
      if (e >= rep * D) break;
      const int r = e / D, d = e % D;
      float a = acc[i] * corr_s[r];
      for (int j = 0; j < n; ++j) a = fmaf(ss[r * TK + j], vs[j * D + d], a);
      acc[i] = a;
    }
    __syncthreads();  // the next tile overwrites ks, vs and ss
  }

#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int e = tid + i * THREADS;
    if (e >= rep * D) break;
    const int r = e / D, d = e % D;
    part_acc[((size_t)(head0 + r) * n_splits + split) * D + d] = acc[i];
  }
  for (int r = tid; r < rep; r += THREADS) {
    part_m[(size_t)(head0 + r) * n_splits + split] = m_s[r];
    part_l[(size_t)(head0 + r) * n_splits + split] = l_s[r];
  }
}

template <typename T, int D>
__global__ void combine_kernel(const int* __restrict__ cache_len,
                               const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int h, int s_len,
                               int n_splits) {
  const int row = blockIdx.x;  // b * h + head
  const int d = threadIdx.x;
  const int len = min(cache_len[row / h], s_len);
  const int live = len > 0 ? (len + CHUNK - 1) / CHUNK : 0;
  const float* pm = part_m + (size_t)row * n_splits;
  const float* pl = part_l + (size_t)row * n_splits;
  float m = NEG_INF;
  for (int sp = 0; sp < live; ++sp) m = fmaxf(m, pm[sp]);
  float l = 0.f, a = 0.f;
  for (int sp = 0; sp < live; ++sp) {
    const float w = expf(pm[sp] - m);
    l = fmaf(pl[sp], w, l);
    a = fmaf(part_acc[((size_t)row * n_splits + sp) * D + d], w, a);
  }
  out[(size_t)row * D + d] = from_float<T>(a / fmaxf(l, 1e-20f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, float* part_m, float* part_l, float* part_acc, int b,
           int h, int kvh, int s_len, int n_splits, float scale,
           cudaStream_t stream) {
  const int rep = h / kvh;
  if (rep * D > MAX_ACC * THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = split_smem_floats(rep, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  split_kernel<T, D><<<dim3(n_splits, b * kvh), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, part_m, part_l, part_acc, h, kvh, s_len,
      n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<T, D><<<b * h, D, 0, stream>>>(
      lens, part_m, part_l, part_acc, static_cast<T*>(out), h, s_len,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const int* lens, void* out, float* pm, float* pl, float* pa,
             int b, int h, int kvh, int s_len, int n_splits, float scale,
             cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, lens, out, pm, pl, pa, b, h, kvh, s_len,
                           n_splits, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, lens, out, pm, pl, pa, b, h, kvh, s_len,
                           n_splits, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, lens, out, pm, pl, pa, b, h, kvh, s_len,
                           n_splits, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, lens, out, pm, pl, pa, b, h, kvh, s_len,
                            n_splits, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Keys per split: the wrapper sizes the partials [b * h, n_splits(, d)] with
// n_splits = ceil(s_len / chunk).
extern "C" int repro_decode_attention_chunk() { return CHUNK; }

// q [b, h, d] and caches [b, s_len, kvh, d], contiguous; lens int32 [b] on
// the device; out [b, h, d]; part_m / part_l fp32 [b * h * n_splits],
// part_acc fp32 [b * h * n_splits * d] (scratch).  dtype: 0 = float32,
// 1 = bfloat16 (q, caches and out share it).  d in {16, 32, 64, 128},
// (h / kvh) * d <= 2048.  Returns the CUDA error of the two launches (0 on
// success); nothing here synchronises.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lens, void* out,
    void* part_m, void* part_l, void* part_acc, int b, int h, int kvh,
    int s_len, int d, int n_splits, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, ln, out, pm, pl, pa, b, h, kvh, s_len,
                           n_splits, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, ln, out, pm, pl, pa, b, h,
                                   kvh, s_len, n_splits, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
