// Split-K decode attention on CUDA cores, in one launch: one new query token
// per (slot, head) attends over that slot's KV cache, read in place in the
// serving pool's grouped layout [B, S, KV, D].  Query head h reads KV head
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
// and does 4 FLOP per (K, V) element pair; at the serving path's shapes
// (4 slots x 32 heads over a [4, 2112, 8, 64] bf16 cache, lengths
// 1/300/1000/2112) the valid K/V are 7.0 MB, 2.1 us at 3.35 TB/s.
//
// Design: one 256-thread block per (split of ``chunk`` keys, slot, KV head);
// the host sizes ``chunk`` from the shape (kernels/decode_attention.py,
// ``plan``) so the live blocks fill the card.
// - Each of the 8 warps owns every eighth tile of TK keys of the split (16
//   in bf16, 8 in fp32; half that at D = 256, so that the 8 warps' rings
//   stay within 192 KB of shared memory) and brings them in with 16-byte
//   cp.async (LDGSTS) into its own ring of STAGES tiles, K and V together,
//   so two tiles per warp are in flight while one is used; keys past the
//   slot's length are zero-filled, never read.  No block barrier until the
//   end.
// - A lane owns one 16-byte chunk of D (8 bf16 or 4 fp32) for one query row
//   of the group, and NP rows in NP passes where a warp's 32 lanes hold
//   fewer than rep rows.  A row takes LPR lanes, its chunk count rounded up
//   to a power of two (D = 80: 10 chunks in bf16 on 16 lanes, 20 in fp32 on
//   32), so that the xor shuffles stay inside a row; the lanes past the
//   row's chunks hold zero queries, load nothing and store nothing.  A row
//   of more than 32 chunks (fp32 at D = 256: 64) takes the whole warp, and
//   each lane CPL chunks, c and c + 32, so that a warp's loads of one chunk
//   column stay contiguous.  The group's rep = H / KV query rows sit in
//   registers as fp32, so every K/V byte serves all of them; a lane holds
//   at most 80 query elements (NP * CPL * 8 bf16 or 4 fp32 each) and as
//   many accumulators.  The instantiated pass counts take rep * padded D
//   <= 2048, and at D = 256 recurrentgemma's 10 query heads over one KV
//   head in 10 passes.  A score is the
//   lanes' partial dot products reduced with xor shuffles over the row's
//   lanes; the online softmax and the PV accumulator stay in registers,
//   replicated over the row's lanes.
// - Scores are kept in the log2 domain (scaled by scale * log2(e)), so each
//   exponential is one exp2f.  D is a template parameter, so the lane and
//   copy arithmetic compiles to shifts.
// - A logit soft cap c > 0 (Gemma 2's, as the JAX layers' decode_attention
//   computes it) turns each scaled score s into c tanh(s / c) where it goes
//   to the log2 domain: (c log2(e)) tanh(raw (scale / c)), both factors
//   computed on the host (``cap2`` 0: no cap).  It is a runtime branch,
//   uniform over the launch, not a template flag: the 55 instantiations
//   stay 55, and without a cap every score is the product it was (the
//   same bits; the wide groups' unrolled tiles run some 4-10 % slower for
//   the branch's code: PERF.md).  tanh is tanh_abs, 1 - 2 / (1 + e^{2x}):
//   branch-free and a few instructions (the capped step at the main pool
//   costs 3 % over the uncapped one where tanhf's cost 11 %), and within
//   2e-7 of tanh absolutely, which is what a score needs: its error is an
//   exponent's, and the fp32 limit holds.
// - The block merges its warps once through shared memory, in warp
//   order.  A single live split writes ``out``; otherwise the block writes
//   its unnormalised (m, l, acc) partial, fences, and counts itself in an
//   int counter per (slot, KV head).  The block that arrives last merges
//   the group's live splits in split order (so results are bitwise
//   repeatable), writes ``out`` in the input type and resets the counter,
//   so the next launch (or a graph replay) finds it at zero.
// - With ``lse`` given, whoever writes a row's ``out`` also writes the row's
//   log-sum-exp of its scaled scores in base 2, m + log2(l), from the final
//   (max, denominator) of that merge; a row with no valid key writes
//   NEG_INF beside its zeros.  Two halves of a cache merge by these
//   (kv_seq-sharded decoding).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::allow_smem;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;
constexpr int MERGE_BATCH = 8;  // splits whose partials one load batch reads
constexpr int MAX_LANE_ELEMS = 80;     // NP * CPL * EPC: a lane's q floats

// tanh(x) = 1 - 2 / (1 + e^{2x}), with x given as 2 x log2(e): within 2e-7
// of tanh absolutely (-1 and 1 exactly far out), branch-free
__device__ __forceinline__ float tanh_abs(float x2) {
  return 1.f - __fdividef(2.f, 1.f + exp2f(x2));
}

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int EPC = 4;   // elements per 16-byte chunk
  static constexpr int TK = 8;    // keys per warp tile (the host's key tile)
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int EPC = 8;
  static constexpr int TK = 16;
};

__device__ __forceinline__ void unpack(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// lanes a query row of ``chunks`` 16-byte chunks takes: the next power of
// 2, at most the warp's 32
__host__ __device__ constexpr int lanes_per_row(int chunks) {
  int l = 1;
  while (l < chunks && l < 32) l *= 2;
  return l;
}

// keys of one warp tile at head dim D: the host's key tile, halved at
// D = 256 (a chunk of keys is always whole warp tiles)
template <typename T, int D>
__host__ __device__ constexpr int warp_tile() {
  return D > 128 ? Traits<T>::TK / 2 : Traits<T>::TK;
}

// the largest power of two <= n (n >= 1)
__host__ __device__ constexpr int floor_pow2(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

template <typename T, int D>
size_t smem_bytes(int rep) {
  const size_t ring =
      (size_t)WARPS * STAGES * 2 * warp_tile<T, D>() * D * sizeof(T);
  const size_t merge = (size_t)WARPS * rep * (D + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

template <typename T, int D, int NP>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ cache_len,
              T* __restrict__ out, float* __restrict__ lse,
              float* __restrict__ part, int* __restrict__ counters, int h,
              int kvh, int s_len, int chunk, int n_splits, float scale,
              float cap_in, float cap2) {
  constexpr int d = D;
  constexpr int EPC = Traits<T>::EPC;
  constexpr int TK = warp_tile<T, D>();
  constexpr int cpr = D / EPC;      // 16-byte chunks per row: 2..64
  constexpr int lpr = lanes_per_row(cpr);  // lanes per row: a power of two
  constexpr int CPL = (cpr + lpr - 1) / lpr;  // chunks per lane: 1 or 2
  constexpr int LE = CPL * EPC;     // a lane's elements of a row
  constexpr int rp = 32 / lpr;      // query rows per pass of the warp
  static_assert(TK * cpr % 32 == 0, "a tile is whole chunks for every lane");
  static_assert(NP * LE <= MAX_LANE_ELEMS, "a lane's rows exceed its budget");
  // keys per softmax step: a power of two, so that the steps tile TK
  constexpr int SUB = floor_pow2(32 / NP < TK ? 32 / NP : TK);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int rep = h / kvh;
  const float scale2 = scale * 1.4426950408889634f;  // scores in log2 units
  const int split = blockIdx.x;
  const int bg = blockIdx.y;  // b * kvh + g
  const int b = bg / kvh;
  const int g = bg % kvh;
  const int head0 = b * h + g * rep;  // first query row of the group
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int c = lane % lpr;   // this lane's first chunk of D
  const int rsub = lane / lpr;
  // chunk u of this lane is c + lpr * u; none past the row's chunks
  auto has_chunk = [&](int u) { return c + lpr * u < cpr; };
  // a row's LE elements of this lane from ``row`` (zeros past its chunks)
  auto load_lane = [&](const T* row, float (&f)[LE]) {
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      float tmp[EPC];
      if (has_chunk(u)) {
        unpack(row + (c + lpr * u) * EPC, tmp);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) tmp[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) f[u * EPC + e] = tmp[e];
    }
  };

  // the group's query rows (their loads overlap the length's)
  float qr[NP][LE], acc[NP][LE], m[NP], l[NP];
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    const int row = rsub + rp * r;
    if (row < rep) {
      load_lane(q + (size_t)(head0 + row) * d, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < LE; ++e) qr[r][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < LE; ++e) acc[r][e] = 0.f;
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  const int len = min(cache_len[b], s_len);
  if (len <= 0) {  // no valid key: zeros, as the merge of no split gives
    if (split == 0) {
      for (int e = tid; e < rep * d; e += THREADS)
        out[(size_t)head0 * d + e] = from_float<T>(0.f);
      if (lse != nullptr)
        for (int r = tid; r < rep; r += THREADS) lse[head0 + r] = NEG_INF;
    }
    return;
  }
  const int s_begin = split * chunk;
  const int s_end = min(s_begin + chunk, len);
  if (s_begin >= s_end) return;  // a dead split: the merge skips it
  const int n_live = (len + chunk - 1) / chunk;

  // this warp's ring: stage st holds K then V of one tile, [TK][d] each
  constexpr int tile_elems = TK * D;
  T* ring =
      reinterpret_cast<T*>(smem) + (size_t)warp * STAGES * 2 * tile_elems;
  const size_t key_stride = (size_t)kvh * d;
  const T* kbase = kc + ((size_t)b * s_len * kvh + g) * d;
  const T* vbase = vc + ((size_t)b * s_len * kvh + g) * d;
  const int n_tiles = (s_end - s_begin + TK - 1) / TK;
  const int my_n = warp < n_tiles ? (n_tiles - warp + WARPS - 1) / WARPS : 0;

  auto issue = [&](int i) {  // this warp's i-th tile into stage i % STAGES
    const int t0 = s_begin + (warp + i * WARPS) * TK;
    T* ks = ring + (i % STAGES) * 2 * tile_elems;
    T* vs = ks + tile_elems;
#pragma unroll
    for (int it = 0; it < TK * cpr / 32; ++it) {
      const int e = lane + 32 * it;
      const int j = e / cpr, cc = e % cpr;
      const bool ok = t0 + j < s_end;
      const size_t off =
          (size_t)(ok ? t0 + j : s_begin) * key_stride + cc * EPC;
      cp_async16(ks + j * d + cc * EPC, kbase + off, ok ? 16 : 0);
      cp_async16(vs + j * d + cc * EPC, vbase + off, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < my_n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < my_n; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed (this lane's part)
    __syncwarp();  // ...every lane's; and tile i-1's stage is free again
    if (i + STAGES - 1 < my_n) issue(i + STAGES - 1);
    cp_async_commit();
    const T* ks = ring + (i % STAGES) * 2 * tile_elems;
    const T* vs = ks + tile_elems;
    const int n_valid = min(TK, s_end - (s_begin + (warp + i * WARPS) * TK));
#pragma unroll
    for (int j0 = 0; j0 < TK; j0 += SUB) {
      if (j0 >= n_valid) break;
      float sc[NP][SUB];
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        float kf[LE];
        load_lane(ks + (j0 + jj) * d, kf);
#pragma unroll
        for (int r = 0; r < NP; ++r) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < LE; ++e) s = fmaf(qr[r][e], kf[e], s);
          sc[r][jj] = s;
        }
      }
#pragma unroll
      for (int off = lpr / 2; off > 0; off /= 2)
#pragma unroll
        for (int r = 0; r < NP; ++r)
#pragma unroll
          for (int jj = 0; jj < SUB; ++jj)
            sc[r][jj] += __shfl_xor_sync(0xffffffffu, sc[r][jj], off);
#pragma unroll
      for (int r = 0; r < NP; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) {
          const float x = cap2 > 0.f ? cap2 * tanh_abs(sc[r][jj] * cap_in)
                                     : sc[r][jj] * scale2;
          sc[r][jj] = j0 + jj < n_valid ? x : NEG_INF;
          mx = fmaxf(mx, sc[r][jj]);
        }
        const float corr = exp2f(m[r] - mx);
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) {
          const float p = j0 + jj < n_valid ? exp2f(sc[r][jj] - mx) : 0.f;
          sum += p;
          sc[r][jj] = round_to<T>(p);
        }
        l[r] = l[r] * corr + sum;
        m[r] = mx;
#pragma unroll
        for (int e = 0; e < LE; ++e) acc[r][e] *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        float vf[LE];
        load_lane(vs + (j0 + jj) * d, vf);
#pragma unroll
        for (int r = 0; r < NP; ++r)
#pragma unroll
          for (int e = 0; e < LE; ++e)
            acc[r][e] = fmaf(sc[r][jj], vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it

  // merge the warps in warp order: wm, wl [WARPS][rep], wacc [WARPS][rep][d]
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + WARPS * rep;
  float* wacc = wl + WARPS * rep;
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    const int row = rsub + rp * r;
    if (row >= rep) continue;
    if (c == 0) {
      wm[warp * rep + row] = m[r];
      wl[warp * rep + row] = l[r];
    }
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      if (!has_chunk(u)) continue;
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        wacc[(warp * rep + row) * d + (c + lpr * u) * EPC + e] =
            acc[r][u * EPC + e];
    }
  }
  __syncthreads();
  const size_t part_row = (size_t)d + 2;  // m, l, acc[d] per query row
  float* mine = part + ((size_t)bg * n_splits + split) * rep * part_row;
  for (int e = tid; e < rep * d; e += THREADS) {
    const int r = e / d, dd = e % d;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * rep + r]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(wm[w * rep + r] - mx);
      ls = fmaf(wl[w * rep + r], wt, ls);
      a = fmaf(wacc[(w * rep + r) * d + dd], wt, a);
    }
    if (n_live == 1) {
      out[(size_t)(head0 + r) * d + dd] = from_float<T>(a / fmaxf(ls, 1e-20f));
      if (lse != nullptr && dd == 0) lse[head0 + r] = mx + log2f(ls);
      continue;
    }
    mine[r * part_row + 2 + dd] = a;
    if (dd == 0) {
      mine[r * part_row] = mx;
      mine[r * part_row + 1] = ls;
    }
  }
  if (n_live == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[bg], 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // fold the live splits in split order with a running max (one pass,
  // so the loads of a batch of splits go out together)
  const float* group = part + (size_t)bg * n_splits * rep * part_row;
  for (int e = tid; e < rep * d; e += THREADS) {
    const int r = e / d, dd = e % d;
    float mx = NEG_INF, ls = 0.f, a = 0.f;
    for (int sp0 = 0; sp0 < n_live; sp0 += MERGE_BATCH) {
      float pm[MERGE_BATCH], pl[MERGE_BATCH], pa[MERGE_BATCH];
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) {
        if (sp0 + u >= n_live) break;
        const float* ps = group + ((size_t)(sp0 + u) * rep + r) * part_row;
        pm[u] = __ldcg(ps);
        pl[u] = __ldcg(ps + 1);
        pa[u] = __ldcg(ps + 2 + dd);
      }
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) {
        if (sp0 + u >= n_live) break;
        const float m_new = fmaxf(mx, pm[u]);
        const float c_old = exp2f(mx - m_new), c_new = exp2f(pm[u] - m_new);
        ls = ls * c_old + pl[u] * c_new;
        a = a * c_old + pa[u] * c_new;
        mx = m_new;
      }
    }
    out[(size_t)(head0 + r) * d + dd] = from_float<T>(a / fmaxf(ls, 1e-20f));
    if (lse != nullptr && dd == 0) lse[head0 + r] = mx + log2f(ls);
  }
  if (tid == 0) counters[bg] = 0;  // ready for the next launch
}

template <typename T, int D, int NP>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, float* lse, float* part, int* counters, int b, int h,
           int kvh, int s_len, int chunk, int n_splits, float scale,
           float cap_in, float cap2, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(h / kvh);
  // the largest group this instantiation takes: NP passes of its rows
  constexpr int rows_per_pass = 32 / lanes_per_row(D / Traits<T>::EPC);
  cudaError_t err = allow_smem<decode_kernel<T, D, NP>>(
      smem_bytes<T, D>(NP * rows_per_pass));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<T, D, NP><<<dim3(n_splits, b * kvh), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), lse, part,
      counters, h, kvh, s_len, chunk, n_splits, scale, cap_in, cap2);
  return static_cast<int>(cudaGetLastError());
}

// the smallest instantiated row-pass count NP >= the group's passes: up to
// rep * padded D = 2048 (8 passes in bf16, 16 in fp32), and at D = 256 the
// 10 passes of recurrentgemma's group (a whole warp a row, 8 elements a
// lane in both dtypes)
template <typename T, int D>
int dispatch_np(const void* q, const void* k, const void* v, const int* lens,
                void* out, float* lse, float* part, int* counters, int b,
                int h, int kvh, int s_len, int chunk, int n_splits,
                float scale, float cap_in, float cap2, cudaStream_t s) {
  constexpr int rows_per_pass = 32 / lanes_per_row(D / Traits<T>::EPC);
  const int passes = (h / kvh + rows_per_pass - 1) / rows_per_pass;
#define REPRO_DECODE_NP(NP)                                                  \
  if (passes <= NP)                                                          \
    return launch<T, D, NP>(q, k, v, lens, out, lse, part, counters, b, h,  \
                            kvh, s_len, chunk, n_splits, scale, cap_in, \
                            cap2, s);
  REPRO_DECODE_NP(1)
  REPRO_DECODE_NP(2)
  REPRO_DECODE_NP(4)
  REPRO_DECODE_NP(8)
  if constexpr (D == 256) {
    REPRO_DECODE_NP(10)
  } else if constexpr (sizeof(T) == 4) {
    REPRO_DECODE_NP(16)
  }
#undef REPRO_DECODE_NP
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lens,
             void* out, float* lse, float* part, int* counters, int b, int h,
             int kvh, int s_len, int d, int chunk, int n_splits, float scale,
             float cap_in, float cap2, cudaStream_t s) {
  if (chunk < 1 || chunk % Traits<T>::TK != 0 ||
      (long long)chunk * n_splits < s_len)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16:
      return dispatch_np<T, 16>(q, k, v, lens, out, lse, part, counters, b,
                                h, kvh, s_len, chunk, n_splits, scale,
                                cap_in, cap2, s);
    case 32:
      return dispatch_np<T, 32>(q, k, v, lens, out, lse, part, counters, b,
                                h, kvh, s_len, chunk, n_splits, scale,
                                cap_in, cap2, s);
    case 64:
      return dispatch_np<T, 64>(q, k, v, lens, out, lse, part, counters, b,
                                h, kvh, s_len, chunk, n_splits, scale,
                                cap_in, cap2, s);
    case 80:  // h2o-danube: 10 (bf16) or 20 (fp32) chunks on 16 or 32 lanes
      return dispatch_np<T, 80>(q, k, v, lens, out, lse, part, counters, b,
                                h, kvh, s_len, chunk, n_splits, scale,
                                cap_in, cap2, s);
    case 128:
      return dispatch_np<T, 128>(q, k, v, lens, out, lse, part, counters, b,
                                 h, kvh, s_len, chunk, n_splits, scale,
                                 cap_in, cap2, s);
    case 256:  // recurrentgemma: 32 chunks a row in bf16, 64 in fp32
      return dispatch_np<T, 256>(q, k, v, lens, out, lse, part, counters, b,
                                 h, kvh, s_len, chunk, n_splits, scale,
                                 cap_in, cap2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Keys per warp tile: ``chunk`` must be a multiple of it (the host's plan,
// kernels/decode_attention.py, checks it).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int repro_decode_attention_key_tile(int dtype) {
  return dtype == 0 ? Traits<float>::TK : Traits<__nv_bfloat16>::TK;
}

// q [b, h, d] and caches [b, s_len, kvh, d], contiguous, 16-byte aligned;
// lens int32 [b] on the device; out [b, h, d]; ``lse`` fp32 [b, h] or null:
// each row's base-2 log-sum-exp of its scaled (and capped) scores (NEG_INF
// for a row with no valid key); softcap >= 0 (0: none).  The keys are split
// into
// n_splits splits of ``chunk`` (chunk * n_splits >= s_len).  Scratch:
// ``part`` fp32 [b * h * n_splits * (d + 2)], ``counters`` int32 [b * kvh],
// zero on entry and left zero on exit.  dtype: 0 = float32, 1 = bfloat16
// (q, caches and out share it).  d in {16, 32, 64, 80, 128, 256},
// (h / kvh) * padded d <= 2048 (d rounded up to a power-of-two count of
// 16-byte chunks), or h / kvh <= 10 at d = 256.  Returns the CUDA error of the launch (0 on
// success); nothing here synchronises.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lens, void* out,
    void* lse, void* part, void* counters, int b, int h, int kvh, int s_len,
    int d,
    int chunk, int n_splits, float scale, float softcap, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* ls = static_cast<float*>(lse);
  float* pa = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  if (!(softcap >= 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  // the cap's factors: c tanh(s scale / c) in log2 units (cap2 0: no cap),
  // tanh_abs taking 2 log2(e) s scale / c
  const float cap_in =
      softcap > 0.f ? 2.8853900817779268f * scale / softcap : 0.f;
  const float cap2 = softcap * 1.4426950408889634f;
  if (dtype == 0)
    return dispatch<float>(q, k, v, ln, out, ls, pa, cnt, b, h, kvh, s_len,
                           d, chunk, n_splits, scale, cap_in, cap2, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, ln, out, ls, pa, cnt, b, h,
                                   kvh, s_len, d, chunk, n_splits, scale,
                                   cap_in, cap2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
