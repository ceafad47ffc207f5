// Split-K decode attention in one launch: one new query token per (slot,
// head) attends over that slot's KV cache, read in place in the serving
// pool's grouped layout [B, S, KV, D].  Query head h reads KV head
// h / (H / KV); key s of slot b is valid iff s < cache_len[b].  Two routes
// (kernels/decode_attention.py ``plan`` picks): the grouped bf16 calls (2
// to 16 query heads a KV head, 10 at D = 256) run on the tensor cores
// (``decode_mma_kernel``, below), the rest on the CUDA cores
// (``decode_kernel``).
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
// Design of the CUDA-core route: one 256-thread block per (split of
// ``chunk`` keys, slot, KV head); the host sizes ``chunk`` from the shape
// (kernels/decode_attention.py, ``plan``) so the live blocks fill the card.
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
//   computed on the host (``cap2`` 0: no cap).  In this route it is a
//   runtime branch, uniform over the launch, not a template flag, and
//   without a cap every score is the product it was (the same bits; the
//   wide groups' unrolled tiles ran some 4-10 % slower for the branch's
//   code, PERF.md; those groups now take the tensor-core route, where the
//   cap is a template flag).  tanh is tanh_abs, 1 - 2 / (1 + e^{2x}):
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
//
// Design of the tensor-core route (bf16): the CUDA-core route spends a row
// pass of fmaf and shuffles per query row of the group on every K/V byte,
// so its cost grew with the group while the bytes did not.  Here the
// group's rows, padded to 16, share each K/V tile in warp matrix products
// (mma.sync m16n8k16, HMMA: 0.17 GFLOP at command-r-plus's 12 heads a KV
// head, under a microsecond; the bytes still bound it).
// - The same blocks, warps, key tiles (16 keys, 8 at D = 256) and 3-stage
//   cp.async rings; each tile's 16-byte chunks XOR-swizzled (``swz``) so
//   that ldmatrix reads them without bank conflicts.  The group's 16-row
//   Q tile is copied in the first copy group.
// - S = Q K^T: Q's A fragments (in registers up to D = 128, read again
//   from shared memory per k step at D = 256), K's B fragments by
//   ldmatrix, fp32 sums over D in k16 steps.  The online softmax runs on
//   the score fragment in the log2 domain: a row's max over its quad in
//   two shuffles, each thread's part of the denominator summed once at the
//   end.  Masked keys are NEG_INF with p zeroed; the cap is a template
//   flag (uncapped launches carry no cap code).
// - O += P V: p rounded to bf16, the score fragment repacked in place as
//   the A fragment (k16, or k8 at D = 256), V's B fragments by
//   ldmatrix.trans; O in fp32 fragments (D / 8 n8 tiles x 4 registers).
// - The warps that took a tile merge in warp order through shared memory
//   (each row's weights computed once); a single live split writes ``out``,
//   otherwise the splits merge in a tree: the last of each MERGE_FAN
//   consecutive live splits merges them into the first one's partial, the
//   last of those merges the groups into ``out``, each in order (bitwise
//   repeatable, no atomics in the sums), each merger resetting its counter.
// - The host sizes this route's grid for 0.75 waves of the SMs with splits
//   of at least 256 keys: a block's fixed costs (its first loads, its
//   partial and the merge) outweigh its keys (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::allow_smem;
using hopper::cp_async16;
using hopper::smem_u32;
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

// whether a bf16 group of lo..hi rows reaches this route: group 1, and the
// groups past the tensor-core route's 16 (at D <= 64 only: up to rep *
// padded D = 2048); every fp32 group
template <typename T, int D>
constexpr bool lanes_take(int lo, int hi) {
  return lo <= hi && (sizeof(T) == 4 || lo == 1 || hi > 16);
}

// the smallest instantiated row-pass count NP >= the group's passes: up to
// rep * padded D = 2048 (8 passes in bf16, 16 in fp32), and at D = 256 the
// 10 passes of recurrentgemma's group (a whole warp a row, 8 elements a
// lane in both dtypes); in bf16 only the counts that group 1 and the groups
// past 16 need (the groups between take the tensor-core route)
template <typename T, int D>
int dispatch_np(const void* q, const void* k, const void* v, const int* lens,
                void* out, float* lse, float* part, int* counters, int b,
                int h, int kvh, int s_len, int chunk, int n_splits,
                float scale, float cap_in, float cap2, cudaStream_t s) {
  constexpr int rows_per_pass = 32 / lanes_per_row(D / Traits<T>::EPC);
  const int passes = (h / kvh + rows_per_pass - 1) / rows_per_pass;
  // the groups a count takes: past the previous count's passes, within
  // the group the instantiation holds (rep * padded D <= 2048, 10 at 256)
  constexpr int lanes = 32 / rows_per_pass;
  constexpr int cpl = (D / Traits<T>::EPC + lanes - 1) / lanes;
  constexpr int most =
      D == 256 ? 10 : 2048 / (lanes * cpl * Traits<T>::EPC);
#define REPRO_DECODE_NP(NP, PREV)                                            \
  if constexpr (lanes_take<T, D>(PREV * rows_per_pass + 1,                   \
                                 NP * rows_per_pass < most                   \
                                     ? NP * rows_per_pass                    \
                                     : most)) {                              \
    if (passes <= NP)                                                        \
      return launch<T, D, NP>(q, k, v, lens, out, lse, part, counters, b,   \
                              h, kvh, s_len, chunk, n_splits, scale, cap_in, \
                              cap2, s);                                      \
  }
  REPRO_DECODE_NP(1, 0)
  REPRO_DECODE_NP(2, 1)
  REPRO_DECODE_NP(4, 2)
  REPRO_DECODE_NP(8, 4)
  if constexpr (D == 256) {
    REPRO_DECODE_NP(10, 8)
  } else if constexpr (sizeof(T) == 4) {
    REPRO_DECODE_NP(16, 8)
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

// ---- the grouped bf16 route: the group's rows share each K/V tile in one
// ---- warp matrix product (HMMA) -------------------------------------------

constexpr int MMA_ROWS = 16;            // M of m16n8k16: the group, padded

// partials one merger of the split tree takes (the first level)
constexpr int MERGE_FAN = 16;

template <int D> struct MmaTile {
  // keys a warp tile, as on the CUDA cores: 16, or 8 at D = 256 (one n8
  // tile of scores, P V in k8 steps), so the 8 warps' rings take 192 KB
  static constexpr int TK = warp_tile<__nv_bfloat16, D>();
  static constexpr int CPR = D / 8;       // 16-byte chunks a row
  static constexpr int KS = D / 16;       // k16 steps of Q K^T
  static constexpr int NT = TK / 8;       // n8 tiles of a warp's scores
  static constexpr int DT = D / 8;        // n8 tiles of the output row
  // Q's A fragments stay in registers (KS * 4 of them) up to D = 128; at
  // D = 256 the output's 128 fp32 registers leave no room, and each k
  // step reads its fragment again from shared memory
  static constexpr bool QREG = D <= 128;
  // blocks an SM holds: two where the rings take at most 96 KB
  static constexpr int BLOCKS = TK * D <= 1024 ? 2 : 1;
  // the most query rows a KV head: one 16-row tile (10 at D = 256)
  static constexpr int GROUP = D > 128 ? 10 : 16;
  // outputs a thread of a merging block takes, at most, and the partials
  // whose sums it loads at once
  static constexpr int ELEMS = (GROUP * D + THREADS - 1) / THREADS;
  static constexpr int MERGE_BATCH = D > 128 ? 8 : 16;
  static constexpr int Q_BYTES = MMA_ROWS * D * 2;
  static constexpr size_t RING_BYTES =
      (size_t)WARPS * STAGES * 2 * TK * D * sizeof(__nv_bfloat16);
  static_assert(TK == 8 || TK == 16, "a warp tile is one or two n8 tiles");
  static_assert(KS % (16 / TK) == 0 && DT % (32 / TK) == 0,
                "an ldmatrix.x4 covers whole k steps and n8 tiles");
};

// Where 16-byte chunk c of row r of a [rows][CPR] tile lies (in chunks):
// c's low three bits XOR the row's where its 8-chunk group is whole (D =
// 64, 128, 256; D = 80's last two chunks stay), and at 2 or 4 chunks a row
// (D = 16, 32) XOR the row's group of 8 / CPR rows, so that the 8 rows one
// ldmatrix phase reads lie in 8 distinct 16-byte bank groups
// (kernels/decode_attention.py ``ring_chunk``).
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CPR < 8) {
    return r * CPR + (c ^ ((r / (8 / CPR)) & (CPR - 1)));
  } else {
    return r * CPR + (c < CPR / 8 * 8 ? c ^ (r & 7) : c);
  }
}

// Shared memory of a launch: the group's Q tile, then the warps' K/V rings,
// which the warp merge ([WARPS][rep] m, l and weights, [rep] max and
// denominator, [WARPS][rep][D + 8] sums) and the
// split merges ([rep][partials] m and l, [rep] max and denominator; at most
// MERGE_FAN partials, or the groups of them) reuse.
template <int D>
size_t mma_smem_bytes(int rep, int n_splits) {
  using Tl = MmaTile<D>;
  size_t area = Tl::RING_BYTES;
  const int groups = (n_splits + MERGE_FAN - 1) / MERGE_FAN;
  const int most = groups > MERGE_FAN ? groups : MERGE_FAN;
  const size_t warps =
      ((size_t)WARPS * rep * (D + 11) + 2 * rep) * sizeof(float);
  const size_t splits = ((size_t)2 * rep * most + 2 * rep) * sizeof(float);
  if (warps > area) area = warps;
  if (splits > area) area = splits;
  return Tl::Q_BYTES + area;
}

// what an instantiation opts into: its largest group's rings or warp merge
// (the split merge fits there up to thousands of splits; the plan asks for
// at most 330): 100 KB at D = 128, 200 KB at 256
template <int D>
constexpr size_t mma_smem_max() {
  using Tl = MmaTile<D>;
  const size_t warps =
      ((size_t)WARPS * Tl::GROUP * (D + 11) + 2 * Tl::GROUP) * sizeof(float);
  return Tl::Q_BYTES + (warps > Tl::RING_BYTES ? warps : Tl::RING_BYTES);
}

// Merge ``count`` (m, l, sums) partials of a group, ``stride`` partials
// apart from ``grp``, in order, each weighted by 2^(m - their max): into
// the output rows ``out`` (and ``lse``) where ``out`` is given, else into
// the first partial.  The sums of the first MERGE_BATCH partials are
// loaded before the (m, l) pairs, so that one round trip brings both, and
// every thread's loads of a batch go out together: the chain grows with
// the partials over MERGE_BATCH, not with them times the group's width.
// The maxima and weights take 16 lanes a row over shared memory (a lane a
// partial, butterflies: a fixed order), every row at once.
template <int D>
__device__ __forceinline__ void merge_partials(float* grp, int stride,
                                               int count, int rep,
                                               unsigned char* area,
                                               __nv_bfloat16* out,
                                               float* lse) {
  using Tl = MmaTile<D>;
  constexpr int EL = Tl::ELEMS;
  constexpr int MB = Tl::MERGE_BATCH;
  constexpr size_t ROW = D + 2;
  const size_t step = (size_t)stride * rep * ROW;  // floats between partials
  const int tid = threadIdx.x;
  float* sm = reinterpret_cast<float*>(area);  // [rep][count] m, then weights
  float* sl = sm + rep * count;                // [rep][count] l
  float* smx = sl + rep * count;               // [rep] the rows' max
  float* sden = smx + rep;                     // [rep] their denominators
  float pa[EL][MB];
  auto load = [&](int sp0) {
#pragma unroll
    for (int j = 0; j < EL; ++j) {
      const int e = tid + THREADS * j;
      const int r = e / D, dd = e % D;
#pragma unroll
      for (int u = 0; u < MB; ++u)
        pa[j][u] = e < rep * D && sp0 + u < count
                       ? __ldcg(grp + (sp0 + u) * step + r * ROW + 2 + dd)
                       : 0.f;
    }
  };
  load(0);
  for (int i = tid; i < rep * count; i += THREADS) {
    const float* ps = grp + (i % count) * step + (i / count) * ROW;
    sm[i] = __ldcg(ps);
    sl[i] = __ldcg(ps + 1);
  }
  __syncthreads();
  {
    const int r = tid / 16, l16 = tid % 16;  // rep <= 16 rows of 16 lanes
    float mx = NEG_INF;
    if (r < rep)
      for (int sp = l16; sp < count; sp += 16)
        mx = fmaxf(mx, sm[r * count + sp]);
#pragma unroll
    for (int off = 8; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float ls = 0.f;
    if (r < rep)
      for (int sp = l16; sp < count; sp += 16) {
        const float wt = exp2f(sm[r * count + sp] - mx);
        sm[r * count + sp] = wt;
        ls = fmaf(sl[r * count + sp], wt, ls);
      }
#pragma unroll
    for (int off = 8; off > 0; off /= 2)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    if (r < rep && l16 == 0) {
      smx[r] = mx;
      sden[r] = ls;
    }
  }
  __syncthreads();
  float acc[EL];
#pragma unroll
  for (int j = 0; j < EL; ++j) acc[j] = 0.f;
  for (int sp0 = 0; sp0 < count; sp0 += MB) {
    if (sp0 > 0) load(sp0);
#pragma unroll
    for (int j = 0; j < EL; ++j) {
      const int e = tid + THREADS * j;
      if (e >= rep * D) continue;
      const float* wr = sm + (e / D) * count + sp0;
#pragma unroll
      for (int u = 0; u < MB; ++u)
        if (sp0 + u < count) acc[j] = fmaf(pa[j][u], wr[u], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < EL; ++j) {
    const int e = tid + THREADS * j;
    if (e >= rep * D) continue;
    const int r = e / D, dd = e % D;
    if (out != nullptr) {
      out[(size_t)r * D + dd] =
          __float2bfloat16(acc[j] / fmaxf(sden[r], 1e-20f));
      if (lse != nullptr && dd == 0) lse[r] = smx[r] + log2f(sden[r]);
    } else {
      grp[r * ROW + 2 + dd] = acc[j];
      if (dd == 0) {
        grp[r * ROW] = smx[r];
        grp[r * ROW + 1] = sden[r];
      }
    }
  }
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, MmaTile<D>::BLOCKS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc,
                  const int* __restrict__ cache_len,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  float* __restrict__ part, int* __restrict__ counters,
                  int h, int kvh, int s_len, int chunk, int n_splits,
                  float scale, float cap_in, float cap2) {
  using T = __nv_bfloat16;
  using Tl = MmaTile<D>;
  constexpr int TK = Tl::TK, CPR = Tl::CPR, KS = Tl::KS, NT = Tl::NT;
  constexpr int DT = Tl::DT;
  extern __shared__ __align__(128) unsigned char smem[];
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
  const int fr = lane / 4;  // a fragment's row (and fr + 8)
  const int fc = lane % 4;  // its column pair: 2 fc, 2 fc + 1

  const int len = min(cache_len[b], s_len);
  if (len <= 0) {  // no valid key: zeros, as the merge of no split gives
    if (split == 0) {
      for (int e = tid; e < rep * D; e += THREADS)
        out[(size_t)head0 * D + e] = __float2bfloat16(0.f);
      if (lse != nullptr)
        for (int r = tid; r < rep; r += THREADS) lse[head0 + r] = NEG_INF;
    }
    return;
  }
  const int s_begin = split * chunk;
  const int s_end = min(s_begin + chunk, len);
  if (s_begin >= s_end) return;  // a dead split: the merge skips it
  const int n_live = (len + chunk - 1) / chunk;

  T* qs = reinterpret_cast<T*>(smem);  // [16][D], swizzled
  unsigned char* area = smem + Tl::Q_BYTES;
  constexpr int tile_elems = TK * D;
  T* ring =
      reinterpret_cast<T*>(area) + (size_t)warp * STAGES * 2 * tile_elems;
  const size_t key_stride = (size_t)kvh * D;
  const T* kbase = kc + ((size_t)b * s_len * kvh + g) * D;
  const T* vbase = vc + ((size_t)b * s_len * kvh + g) * D;
  const int n_tiles = (s_end - s_begin + TK - 1) / TK;
  const int my_n = warp < n_tiles ? (n_tiles - warp + WARPS - 1) / WARPS : 0;

  auto issue = [&](int i) {  // this warp's i-th tile into stage i % STAGES
    const int t0 = s_begin + (warp + i * WARPS) * TK;
    T* ks = ring + (i % STAGES) * 2 * tile_elems;
    T* vs = ks + tile_elems;
#pragma unroll
    for (int it = 0; it < TK * CPR / 32; ++it) {
      const int e = lane + 32 * it;
      const int j = e / CPR, cc = e % CPR;
      const bool ok = t0 + j < s_end;
      const size_t off =
          (size_t)(ok ? t0 + j : s_begin) * key_stride + cc * 8;
      cp_async16(ks + swz<CPR>(j, cc) * 8, kbase + off, ok ? 16 : 0);
      cp_async16(vs + swz<CPR>(j, cc) * 8, vbase + off, ok ? 16 : 0);
    }
  };

  // the group's query rows (zero-filled past rep) in the first copy group,
  // beside each warp's first tile, so that their waits overlap
  for (int e = tid; e < MMA_ROWS * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    cp_async16(qs + swz<CPR>(r, c) * 8,
               q + (size_t)(head0 + (r < rep ? r : 0)) * D + c * 8,
               r < rep ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < my_n) issue(i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // the query rows (and tile 0) have landed
  __syncthreads();  // ...every thread's part of them

  // Q's A fragment of k step ks: matrices (rows 0-7, 8-15) x (chunks 2 ks,
  // 2 ks + 1); lane l addresses row l % 8 of matrix l / 8
  const uint32_t qs_addr = smem_u32(qs);
  const int q_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  auto q_frag = [&](int ks, uint32_t (&a)[4]) {
    hopper::ldmatrix_x4(a,
                        qs_addr + 16u * swz<CPR>(q_row, 2 * ks + (lane >> 4)));
  };
  uint32_t qf[Tl::QREG ? KS : 1][4];
  if constexpr (Tl::QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) q_frag(ks, qf[ks]);
  }

  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[t][j] = 0.f;
  // rows fr and fr + 8: the running max (the same over a row's quad) and
  // this thread's part of the denominator (its keys; the quad's parts are
  // summed once, after the walk)
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < my_n; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed (this lane's part)
    __syncwarp();  // ...every lane's; and tile i-1's stage is free again
    if (i + STAGES - 1 < my_n) issue(i + STAGES - 1);
    cp_async_commit();
    const uint32_t ks_addr = smem_u32(ring + (i % STAGES) * 2 * tile_elems);
    const uint32_t vs_addr = ks_addr + tile_elems * sizeof(T);
    const int n_valid = min(TK, s_end - (s_begin + (warp + i * WARPS) * TK));

    // S = Q K^T: fp32 sums over D in k16 steps
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[t][j] = 0.f;
    if constexpr (TK == 16) {
      // K's B fragments of k step kk: matrices (keys 0-7, 8-15) x (chunks
      // 2 kk, 2 kk + 1), n8 tile 0 from the first two
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];
        hopper::ldmatrix_x4(
            kb, ks_addr + 16u * swz<CPR>((lane & 7) + 8 * (lane >> 4),
                                         2 * kk + ((lane >> 3) & 1)));
        uint32_t a[4];
        if constexpr (Tl::QREG) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = qf[kk][j];
        } else {
          q_frag(kk, a);
        }
        hopper::mma_16816(s[0], a, kb[0], kb[1]);
        hopper::mma_16816(s[1], a, kb[2], kb[3]);
      }
    } else {
      // 8 keys: chunks 2 kk .. 2 kk + 3 of keys 0-7, two k steps
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t kb[4];
        hopper::ldmatrix_x4(
            kb, ks_addr + 16u * swz<CPR>(lane & 7, 2 * kk + (lane >> 3)));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t a[4];
          if constexpr (Tl::QREG) {
#pragma unroll
            for (int j = 0; j < 4; ++j) a[j] = qf[kk + u][j];
          } else {
            q_frag(kk + u, a);
          }
          hopper::mma_16816(s[0], a, kb[2 * u], kb[2 * u + 1]);
        }
      }
    }

    // the online softmax on the fragments, in the log2 domain
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = 8 * t + 2 * fc + (j & 1);
        float x;
        if constexpr (CAP) {
          x = cap2 * tanh_abs(s[t][j] * cap_in);
        } else {
          x = s[t][j] * scale2;
        }
        s[t][j] = key < n_valid ? x : NEG_INF;
        mx[j >> 1] = fmaxf(mx[j >> 1], s[t][j]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) corr[hh] = exp2f(m_r[hh] - mx[hh]);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = 8 * t + 2 * fc + (j & 1);
        const float p = key < n_valid ? exp2f(s[t][j] - mx[j >> 1]) : 0.f;
        sum[j >> 1] += p;
        s[t][j] = p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l_r[hh] = l_r[hh] * corr[hh] + sum[hh];
      m_r[hh] = mx[hh];
    }
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

    // O += P V: p rounded to bf16, the score fragment repacked in place as
    // the A fragment; V's B fragments by ldmatrix.trans from the ring
    if constexpr (TK == 16) {
      const uint32_t pa[4] = {hopper::pack_bf16x2(s[0][0], s[0][1]),
                              hopper::pack_bf16x2(s[0][2], s[0][3]),
                              hopper::pack_bf16x2(s[1][0], s[1][1]),
                              hopper::pack_bf16x2(s[1][2], s[1][3])};
      // matrices (keys 0-7, 8-15) x (chunks c, c + 1)
#pragma unroll
      for (int c = 0; c < DT; c += 2) {
        uint32_t vb[4];
        hopper::ldmatrix_x4_trans(
            vb, vs_addr + 16u * swz<CPR>((lane & 7) + 8 * ((lane >> 3) & 1),
                                         c + (lane >> 4)));
        hopper::mma_16816(o[c], pa, vb[0], vb[1]);
        hopper::mma_16816(o[c + 1], pa, vb[2], vb[3]);
      }
    } else {
      const uint32_t p0 = hopper::pack_bf16x2(s[0][0], s[0][1]);
      const uint32_t p1 = hopper::pack_bf16x2(s[0][2], s[0][3]);
      // keys 0-7 of chunks c .. c + 3
#pragma unroll
      for (int c = 0; c < DT; c += 4) {
        uint32_t vb[4];
        hopper::ldmatrix_x4_trans(
            vb, vs_addr + 16u * swz<CPR>(lane & 7, c + (lane >> 3)));
#pragma unroll
        for (int u = 0; u < 4; ++u)
          hopper::mma_1688(o[c + u], p0, p1, vb[u]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 1);
    l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 2);
  }
  __syncthreads();  // every warp is done with its ring: reuse it

  // merge the warps that took a tile, in warp order: wm, wl [WARPS][rep],
  // wacc [WARPS][rep][WROW]; rows WROW = D + 8 floats apart, so that a
  // warp's float2 stores of its fragments (8 rows x 4 column pairs) fill
  // the 32 banks twice over, without conflicts
  constexpr int WROW = D + 8;
  const int n_used = min(WARPS, n_tiles);
  float* wm = reinterpret_cast<float*>(area);
  float* wl = wm + WARPS * rep;
  float* ww = wl + WARPS * rep;                  // [WARPS][rep] weights
  float* wmax = ww + WARPS * rep;                // [rep] the rows' max
  float* wden = wmax + rep;                      // [rep] their denominators
  float* wacc = wden + rep;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = fr + 8 * hh;
    if (warp >= n_used || row >= rep) continue;
    if (fc == 0) {
      wm[warp * rep + row] = m_r[hh];
      wl[warp * rep + row] = l_r[hh];
    }
    float* dst = wacc + (size_t)(warp * rep + row) * WROW + 2 * fc;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<float2*>(dst + 8 * t) =
          make_float2(o[t][2 * hh], o[t][2 * hh + 1]);
  }
  __syncthreads();
  if (tid < rep) {  // each row's max over the warps and their weights
    float mx = NEG_INF;
    for (int w = 0; w < n_used; ++w) mx = fmaxf(mx, wm[w * rep + tid]);
    float ls = 0.f;
    for (int w = 0; w < n_used; ++w) {
      const float wt = exp2f(wm[w * rep + tid] - mx);
      ww[w * rep + tid] = wt;
      ls = fmaf(wl[w * rep + tid], wt, ls);
    }
    wmax[tid] = mx;
    wden[tid] = ls;
  }
  __syncthreads();
  const size_t part_row = (size_t)D + 2;  // m, l, acc[D] per query row
  float* mine = part + ((size_t)bg * n_splits + split) * rep * part_row;
  for (int e = tid; e < rep * D; e += THREADS) {
    const int r = e / D, dd = e % D;
    const float mx = wmax[r], ls = wden[r];
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (w < n_used)
        a = fmaf(wacc[(w * rep + r) * WROW + dd], ww[w * rep + r], a);
    if (n_live == 1) {
      out[(size_t)(head0 + r) * D + dd] =
          __float2bfloat16(a / fmaxf(ls, 1e-20f));
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

  // The splits merge in a tree of two levels: the last of each FAN
  // consecutive live splits to arrive merges them (in split order) into
  // the first one's partial, and the last of those merges them (in group
  // order) into the output; with FAN or fewer live splits the one level
  // is the last.  Counters: [b * kvh] for the top level, then
  // [b * kvh][ceil(n_splits / FAN)] for the groups; each merger resets its
  // own.
  const size_t slot = (size_t)rep * part_row;  // floats a partial takes
  float* group = part + (size_t)bg * n_splits * slot;
  const int n_grp = (n_live + MERGE_FAN - 1) / MERGE_FAN;
  __threadfence();
  __syncthreads();
  if (n_grp > 1) {
    const int gi = split / MERGE_FAN;
    const int in_grp = min(MERGE_FAN, n_live - gi * MERGE_FAN);
    int* c1 = counters + gridDim.y +
              (size_t)bg * ((n_splits + MERGE_FAN - 1) / MERGE_FAN) + gi;
    if (tid == 0) is_last = atomicAdd(c1, 1) == in_grp - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    merge_partials<D>(group + gi * MERGE_FAN * slot, 1, in_grp, rep, area,
                      nullptr, nullptr);
    if (tid == 0) *c1 = 0;
    __threadfence();
    __syncthreads();
  }
  // the top level counts the groups' mergers, or the live splits
  const int arrivals = n_grp > 1 ? n_grp : n_live;
  if (tid == 0) is_last = atomicAdd(&counters[bg], 1) == arrivals - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (n_grp > 1)
    merge_partials<D>(group, MERGE_FAN, n_grp, rep, area,
                      out + (size_t)head0 * D, lse ? lse + head0 : nullptr);
  else
    merge_partials<D>(group, 1, n_live, rep, area, out + (size_t)head0 * D,
                      lse ? lse + head0 : nullptr);
  if (tid == 0) counters[bg] = 0;  // ready for the next launch
}

template <int D, bool CAP>
int launch_mma(const void* q, const void* k, const void* v, const int* lens,
               void* out, float* lse, float* part, int* counters, int b,
               int h, int kvh, int s_len, int chunk, int n_splits,
               float scale, float cap_in, float cap2, cudaStream_t stream) {
  const int rep = h / kvh;
  if (rep < 1 || rep > MmaTile<D>::GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mma_smem_bytes<D>(rep, n_splits);
  if (smem > mma_smem_max<D>())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<decode_mma_kernel<D, CAP>>(mma_smem_max<D>());
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused attribute leaves no error behind
    return static_cast<int>(err);
  }
  using T = __nv_bfloat16;
  decode_mma_kernel<D, CAP>
      <<<dim3(n_splits, b * kvh), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lens, static_cast<T*>(out), lse, part,
          counters, h, kvh, s_len, chunk, n_splits, scale, cap_in, cap2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_mma_cap(const void* q, const void* k, const void* v,
                     const int* lens, void* out, float* lse, float* part,
                     int* counters, int b, int h, int kvh, int s_len,
                     int chunk, int n_splits, float scale, float cap_in,
                     float cap2, cudaStream_t s) {
  if (cap2 > 0.f)
    return launch_mma<D, true>(q, k, v, lens, out, lse, part, counters, b, h,
                               kvh, s_len, chunk, n_splits, scale, cap_in,
                               cap2, s);
  return launch_mma<D, false>(q, k, v, lens, out, lse, part, counters, b, h,
                              kvh, s_len, chunk, n_splits, scale, cap_in,
                              cap2, s);
}

int dispatch_mma(const void* q, const void* k, const void* v,
                 const int* lens, void* out, float* lse, float* part,
                 int* counters, int b, int h, int kvh, int s_len, int d,
                 int chunk, int n_splits, float scale, float cap_in,
                 float cap2, cudaStream_t s) {
  if (chunk < 1 || chunk % Traits<__nv_bfloat16>::TK != 0 ||
      (long long)chunk * n_splits < s_len)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_DECODE_MMA(DD)                                                \
  case DD:                                                                  \
    return dispatch_mma_cap<DD>(q, k, v, lens, out, lse, part, counters, b, \
                                h, kvh, s_len, chunk, n_splits, scale,      \
                                cap_in, cap2, s);
  switch (d) {
    REPRO_DECODE_MMA(16)
    REPRO_DECODE_MMA(32)
    REPRO_DECODE_MMA(64)
    REPRO_DECODE_MMA(80)
    REPRO_DECODE_MMA(128)
    REPRO_DECODE_MMA(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_MMA
}

}  // namespace

// Keys per warp tile: ``chunk`` must be a multiple of it (the host's plan,
// kernels/decode_attention.py, checks it).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int repro_decode_attention_key_tile(int dtype) {
  return dtype == 0 ? Traits<float>::TK : Traits<__nv_bfloat16>::TK;
}

// The most query heads a KV head the tensor-core route takes at head dim d
// (kernels/decode_attention.py holds ``HMMA_GROUP`` to it at load).
extern "C" int repro_decode_attention_mma_group(int d) {
  return d > 128 ? MmaTile<256>::GROUP : MmaTile<128>::GROUP;
}

// q [b, h, d] and caches [b, s_len, kvh, d], contiguous, 16-byte aligned;
// lens int32 [b] on the device; out [b, h, d]; ``lse`` fp32 [b, h] or null:
// each row's base-2 log-sum-exp of its scaled (and capped) scores (NEG_INF
// for a row with no valid key); softcap >= 0 (0: none).  The keys are split
// into
// n_splits splits of ``chunk`` (chunk * n_splits >= s_len).  Scratch:
// ``part`` fp32 [b * h * n_splits * (d + 2)], ``counters`` int32
// [b * kvh * (1 + ceil(n_splits / 16))] (the tensor-core route's tree; the
// CUDA-core route uses the first b * kvh), zero on entry and left zero on
// exit.  dtype: 0 = float32, 1 = bfloat16
// (q, caches and out share it).  d in {16, 32, 64, 80, 128, 256},
// (h / kvh) * padded d <= 2048 (d rounded up to a power-of-two count of
// 16-byte chunks), or h / kvh <= 10 at d = 256.  route: 0 = the CUDA-core
// kernel (lanes), 1 = the tensor-core kernel (bfloat16, 1 <= h / kvh <=
// 16, 10 at d = 256; kernels/decode_attention.py ``plan`` chooses).
// Returns the CUDA error of the launch (0 on success); nothing here
// synchronises.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lens, void* out,
    void* lse, void* part, void* counters, int b, int h, int kvh, int s_len,
    int d,
    int chunk, int n_splits, float scale, float softcap, int dtype,
    int route, void* stream) {
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
  if (route == 1)
    return dtype == 1 ? dispatch_mma(q, k, v, ln, out, ls, pa, cnt, b, h,
                                     kvh, s_len, d, chunk, n_splits, scale,
                                     cap_in, cap2, s)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
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
