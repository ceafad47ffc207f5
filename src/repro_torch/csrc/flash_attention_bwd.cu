// Flash-attention backward: the gradient of csrc/flash_attention.cu's
// O[bh] = softmax(Q[bh] K[g]^T / sqrt(D), causal and window masks) V[g],
// g = bh / kv_group, with respect to Q, K and V, given O and dO.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py,
// flash_attention (the Pallas online-softmax kernel), which the reference
// takes by autodiff of its jnp attention (src/repro/models/layers.py,
// blockwise_attention); the Pallas kernel itself has no custom_vjp.
//
// With P = softmax(scale S masked), S = Q K^T, and Delta = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV of a KV head summed over its kv_group query heads.
//
// Design (simple and right first; fp32 FMAs on the CUDA cores for fp32 and
// bf16 inputs alike, bf16 loaded and stored as bf16 but summed in fp32):
//
//  1. prep: one 256-thread block per (query tile, bh) computes Delta for
//     its rows and recomputes each row's log-sum-exp L = m + log(l) over
//     the keys it attends, walking the key tiles as the forward kernel
//     does (causal walks end at the tile of the block's last row, windowed
//     walks start at the tile of key q0 - W + 1).  The forward kernel and
//     its library stay as they are: it saves no L.
//  2. dK/dV: one block per (KV head, key tile) keeps its tile's K and V in
//     shared memory and its dK and dV in registers, and loops over the
//     group's query heads and their query tiles that can see the tile (a
//     causal tile is seen from its first key's row on, a windowed one until
//     its last key's row + W - 1).  So every dK/dV sum runs in one block in
//     a fixed order: no atomics, and repeated calls agree bit for bit.
//  3. dQ: one block per (query tile, bh) keeps its Q, dO, L and Delta and
//     walks the key tiles as the prep pass does, heaviest tiles first.
//
// Every operand tile is staged in shared memory in fp32 with padded rows
// (D + 1 floats: the score loops read 16 rows at one column conflict-free);
// a thread holds a 4 x 4 (2 x 2 at D = 256) block of each score tile and a
// (tile / 16) x (D / 16) block of each accumulator.  Masked (query, key)
// pairs give P = 0 and dS = 0; rows and keys past Sq and Skv are staged as
// zeros and never stored.  A row with no key to attend keeps L = 0 and adds
// nothing (the forward kernel gives it a zero output).
//
// Bound on the H100: operations.  At the training shape of granite-3-2b
// (B 4 x 32 heads over 8 KV heads, S 2048, D 64, causal) the backward is
// 10 FLOP per attended pair and head dim (Q K^T again, dO V^T, dV, dQ and
// dK), 1.7e11 FLOP: 0.17 ms at the 989 TFLOP/s bf16 tensor-core peak
// against 9.4 ms at the 67 TFLOP/s fp32 peak of the CUDA cores that this
// design runs on, which also recomputes Q K^T twice and dO V^T once more
// (16 FLOP a pair and head dim).  Its traffic, 8 [BH, S, D] operands, is
// about 0.03 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // 16 x 16

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // [bh, sq] scratch
  int bh, sq, skv, kv_group, causal, window;
  float scale;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss;
};

// query rows a tile (BQ) and keys a tile (BKV): 64, 32 at D = 256 so that
// the dK/dV pass's four staged tiles fit shared memory
template <int D> struct Cfg {
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int BKV = BQ;
  static constexpr int TI = BQ / 16;   // score rows a thread
  static constexpr int TJ = BKV / 16;  // score columns a thread
  static constexpr int TD = D / 16;    // accumulator columns a thread
  static constexpr int P = D + 1;      // padded row of a staged tile
  static constexpr int SP = BKV + 1;   // padded row of a score tile
  static constexpr size_t PREP = (BQ + BKV) * P + BQ * SP;
  static constexpr size_t DKDV = (2 * BQ + 2 * BKV) * P + 2 * BQ * SP + 2 * BQ;
  static constexpr size_t DQ = (2 * BQ + 2 * BKV) * P + BQ * SP + 2 * BQ;
  static_assert(DKDV * sizeof(float) <= 227 * 1024, "smem per block");
};

template <bool WINDOW>
__device__ __forceinline__ bool attends(const Args& a, int qpos, int kpos) {
  return qpos < a.sq && kpos < a.skv && (!a.causal || qpos >= kpos) &&
         (!WINDOW || qpos - kpos < a.window);
}

// dst [rows][D + 1] <- rows row0.. of src (row stride ss), zeros past len
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int row0, int rows, int len) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] = g < len ? ld(src + g * ss + d) : 0.f;
  }
}

// the key tiles a query tile at q0 walks: [begin, end)
template <int D, bool WINDOW>
__device__ __forceinline__ void key_range(const Args& a, int q0, int& begin,
                                          int& end) {
  constexpr int BQ = Cfg<D>::BQ, BKV = Cfg<D>::BKV;
  end = a.causal ? min(a.skv, q0 + BQ) : a.skv;
  begin = WINDOW ? max(0, q0 - a.window + 1) / BKV * BKV : 0;
}

// s += A B^T and (optionally) dp += C E^T over D for a thread's score block:
// rows ty + 16 i of the [BQ][P] tiles A and C, rows tx + 16 j of the
// [BKV][P] tiles B and E
template <int D, bool BOTH>
__device__ __forceinline__ void scores(const float* A, const float* B,
                                       const float* C, const float* E,
                                       float (&s)[Cfg<D>::TI][Cfg<D>::TJ],
                                       float (&dp)[Cfg<D>::TI][Cfg<D>::TJ]) {
  using K = Cfg<D>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < K::TI; ++i)
#pragma unroll
    for (int j = 0; j < K::TJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[K::TI], b[K::TJ], c[K::TI], e[K::TJ];
#pragma unroll
    for (int i = 0; i < K::TI; ++i) {
      a[i] = A[(ty + 16 * i) * K::P + d];
      if (BOTH) c[i] = C[(ty + 16 * i) * K::P + d];
    }
#pragma unroll
    for (int j = 0; j < K::TJ; ++j) {
      b[j] = B[(tx + 16 * j) * K::P + d];
      if (BOTH) e[j] = E[(tx + 16 * j) * K::P + d];
    }
#pragma unroll
    for (int i = 0; i < K::TI; ++i)
#pragma unroll
      for (int j = 0; j < K::TJ; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        if (BOTH) dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// 1. prep: Delta and the log-sum-exp of each query row
// ---------------------------------------------------------------------------

template <int D, bool WINDOW, typename T>
__global__ void __launch_bounds__(THREADS) bwd_prep_kernel(Args a) {
  using K = Cfg<D>;
  constexpr int BQ = K::BQ, BKV = K::BKV;
  constexpr int RT = THREADS / BQ;  // threads a row: consecutive lanes
  constexpr int RC = BKV / RT;      // score columns each
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][P]
  float* ks = qs + BQ * K::P;     // [BKV][P]
  float* ss = ks + BKV * K::P;    // [BQ][SP]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const T* qb = static_cast<const T*>(a.q) + bh * a.q_sb;
  const T* kb = static_cast<const T*>(a.k) + (bh / a.kv_group) * a.k_sb;
  stage<D>(qs, qb, a.q_ss, q0, BQ, a.sq);

  const int r = tid / RT, part = tid % RT;
  const int gr = q0 + r;
  {
    float acc = 0.f;
    if (gr < a.sq) {
      const T* orow = static_cast<const T*>(a.o) + bh * a.o_sb + gr * a.o_ss;
      const T* drow =
          static_cast<const T*>(a.dout) + bh * a.do_sb + gr * a.do_ss;
      for (int d = part; d < D; d += RT) acc += ld(orow + d) * ld(drow + d);
    }
#pragma unroll
    for (int off = RT / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0 && gr < a.sq) a.delta[(long long)bh * a.sq + gr] = acc;
  }

  float m = NEG_INF, l = 0.f;  // row r's, held by each of its RT threads
  int kv_begin, kv_end;
  key_range<D, WINDOW>(a, q0, kv_begin, kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // Q staged; the last tile's ks and ss read
    stage<D>(ks, kb, a.k_ss, k0, BKV, a.skv);
    __syncthreads();
    float s[K::TI][K::TJ], unused[K::TI][K::TJ];
    scores<D, false>(qs, ks, nullptr, nullptr, s, unused);
#pragma unroll
    for (int i = 0; i < K::TI; ++i)
#pragma unroll
      for (int j = 0; j < K::TJ; ++j)
        ss[(ty + 16 * i) * K::SP + tx + 16 * j] = s[i][j] * a.scale;
    __syncthreads();
    const float* srow = ss + r * K::SP + part * RC;
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < RC; ++c)
      if (attends<WINDOW>(a, gr, k0 + part * RC + c)) mx = fmaxf(mx, srow[c]);
#pragma unroll
    for (int off = RT / 2; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c)
      if (attends<WINDOW>(a, gr, k0 + part * RC + c))
        sum += expf(srow[c] - m_new);
#pragma unroll
    for (int off = RT / 2; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * expf(m - m_new) + sum;
    m = m_new;
  }
  if (part == 0 && gr < a.sq)
    a.lse[(long long)bh * a.sq + gr] = l > 0.f ? m + logf(l) : 0.f;
}

// ---------------------------------------------------------------------------
// 2. dK, dV: one block per (KV head, key tile)
// ---------------------------------------------------------------------------

template <int D, bool WINDOW, typename T>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(Args a) {
  using K = Cfg<D>;
  constexpr int BQ = K::BQ, BKV = K::BKV, TK = BKV / 16;
  extern __shared__ float smem[];
  float* ks = smem;               // [BKV][P]
  float* vs = ks + BKV * K::P;    // [BKV][P]
  float* qs = vs + BKV * K::P;    // [BQ][P]
  float* dos = qs + BQ * K::P;    // [BQ][P]
  float* ps = dos + BQ * K::P;    // [BQ][SP]: P
  float* dss = ps + BQ * K::SP;   // [BQ][SP]: dS
  float* lse_s = dss + BQ * K::SP;
  float* dl_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g = blockIdx.y;
  const int k0 = blockIdx.x * BKV;  // the longest causal walks first
  stage<D>(ks, static_cast<const T*>(a.k) + g * a.k_sb, a.k_ss, k0, BKV,
           a.skv);
  stage<D>(vs, static_cast<const T*>(a.v) + g * a.v_sb, a.v_ss, k0, BKV,
           a.skv);

  float dk[TK][K::TD], dv[TK][K::TD];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < K::TD; ++j) dk[i][j] = dv[i][j] = 0.f;

  // rows before k0 see none of the tile's keys under a causal mask, rows
  // from its last key + W on none under a window
  const int q_begin = a.causal ? k0 / BQ * BQ : 0;
  const int q_end = WINDOW ? min(a.sq, k0 + BKV - 1 + a.window) : a.sq;
  for (int rr = 0; rr < a.kv_group; ++rr) {
    const int bh = g * a.kv_group + rr;
    const T* qb = static_cast<const T*>(a.q) + bh * a.q_sb;
    const T* db = static_cast<const T*>(a.dout) + bh * a.do_sb;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // K/V staged; the last tile's qs, dos, ps, dss read
      stage<D>(qs, qb, a.q_ss, q0, BQ, a.sq);
      stage<D>(dos, db, a.do_ss, q0, BQ, a.sq);
      if (tid < BQ) {
        const bool in = q0 + tid < a.sq;
        const long long row = (long long)bh * a.sq + q0 + tid;
        lse_s[tid] = in ? a.lse[row] : 0.f;
        dl_s[tid] = in ? a.delta[row] : 0.f;
      }
      __syncthreads();
      float s[K::TI][K::TJ], dp[K::TI][K::TJ];
      scores<D, true>(qs, ks, dos, vs, s, dp);
#pragma unroll
      for (int i = 0; i < K::TI; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < K::TJ; ++j) {
          const int col = tx + 16 * j;
          const float p = attends<WINDOW>(a, q0 + row, k0 + col)
                              ? expf(s[i][j] * a.scale - lse_s[row])
                              : 0.f;
          ps[row * K::SP + col] = p;
          dss[row * K::SP + col] = p * (dp[i][j] - dl_s[row]);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys ty + 16 i, columns tx + 16 j
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pk[TK], sk[TK], dov[K::TD], qv[K::TD];
#pragma unroll
        for (int i = 0; i < TK; ++i) {
          pk[i] = ps[qq * K::SP + ty + 16 * i];
          sk[i] = dss[qq * K::SP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < K::TD; ++j) {
          dov[j] = dos[qq * K::P + tx + 16 * j];
          qv[j] = qs[qq * K::P + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
          for (int j = 0; j < K::TD; ++j) {
            dv[i][j] = fmaf(pk[i], dov[j], dv[i][j]);
            dk[i][j] = fmaf(sk[i], qv[j], dk[i][j]);
          }
      }
    }
  }
  T* dkb = static_cast<T*>(a.dk) + (long long)g * a.skv * D;
  T* dvb = static_cast<T*>(a.dv) + (long long)g * a.skv * D;
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.skv) continue;
#pragma unroll
    for (int j = 0; j < K::TD; ++j) {
      st(dkb + (long long)key * D + tx + 16 * j, dk[i][j] * a.scale);
      st(dvb + (long long)key * D + tx + 16 * j, dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (query tile, bh)
// ---------------------------------------------------------------------------

template <int D, bool WINDOW, typename T>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(Args a) {
  using K = Cfg<D>;
  constexpr int BQ = K::BQ, BKV = K::BKV;
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][P]
  float* dos = qs + BQ * K::P;    // [BQ][P]
  float* ks = dos + BQ * K::P;    // [BKV][P]
  float* vs = ks + BKV * K::P;    // [BKV][P]
  float* dss = vs + BKV * K::P;   // [BQ][SP]
  float* lse_s = dss + BQ * K::SP;
  float* dl_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int g = bh / a.kv_group;
  stage<D>(qs, static_cast<const T*>(a.q) + bh * a.q_sb, a.q_ss, q0, BQ,
           a.sq);
  stage<D>(dos, static_cast<const T*>(a.dout) + bh * a.do_sb, a.do_ss, q0,
           BQ, a.sq);
  if (tid < BQ) {
    const bool in = q0 + tid < a.sq;
    const long long row = (long long)bh * a.sq + q0 + tid;
    lse_s[tid] = in ? a.lse[row] : 0.f;
    dl_s[tid] = in ? a.delta[row] : 0.f;
  }
  const T* kb = static_cast<const T*>(a.k) + g * a.k_sb;
  const T* vb = static_cast<const T*>(a.v) + g * a.v_sb;

  float dq[K::TI][K::TD];
#pragma unroll
  for (int i = 0; i < K::TI; ++i)
#pragma unroll
    for (int j = 0; j < K::TD; ++j) dq[i][j] = 0.f;

  int kv_begin, kv_end;
  key_range<D, WINDOW>(a, q0, kv_begin, kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // Q, dO staged; the last tile's ks and dss read
    stage<D>(ks, kb, a.k_ss, k0, BKV, a.skv);
    stage<D>(vs, vb, a.v_ss, k0, BKV, a.skv);
    __syncthreads();
    float s[K::TI][K::TJ], dp[K::TI][K::TJ];
    scores<D, true>(qs, ks, dos, vs, s, dp);
#pragma unroll
    for (int i = 0; i < K::TI; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < K::TJ; ++j) {
        const int col = tx + 16 * j;
        const float p = attends<WINDOW>(a, q0 + row, k0 + col)
                            ? expf(s[i][j] * a.scale - lse_s[row])
                            : 0.f;
        dss[row * K::SP + col] = p * (dp[i][j] - dl_s[row]);
      }
    }
    __syncthreads();
    // dQ += dS K: rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float sv[K::TI], kv[K::TD];
#pragma unroll
      for (int i = 0; i < K::TI; ++i) sv[i] = dss[(ty + 16 * i) * K::SP + kk];
#pragma unroll
      for (int j = 0; j < K::TD; ++j) kv[j] = ks[kk * K::P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < K::TI; ++i)
#pragma unroll
        for (int j = 0; j < K::TD; ++j) dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
  }
  T* dqb = static_cast<T*>(a.dq) + (long long)bh * a.sq * D;
#pragma unroll
  for (int i = 0; i < K::TI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < K::TD; ++j)
      st(dqb + (long long)row * D + tx + 16 * j, dq[i][j] * a.scale);
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(floats * sizeof(float)));
}

template <int D, bool WINDOW, typename T>
int launch(const Args& a, cudaStream_t stream) {
  using K = Cfg<D>;
  auto prep = bwd_prep_kernel<D, WINDOW, T>;
  auto dkdv = bwd_dkdv_kernel<D, WINDOW, T>;
  auto dq = bwd_dq_kernel<D, WINDOW, T>;
  cudaError_t err;
  if ((err = opt_in(prep, K::PREP)) != cudaSuccess ||
      (err = opt_in(dkdv, K::DKDV)) != cudaSuccess ||
      (err = opt_in(dq, K::DQ)) != cudaSuccess)
    return static_cast<int>(err);
  const int q_tiles = (a.sq + K::BQ - 1) / K::BQ;
  const int k_tiles = (a.skv + K::BKV - 1) / K::BKV;
  prep<<<dim3(q_tiles, a.bh), THREADS, K::PREP * sizeof(float), stream>>>(a);
  dkdv<<<dim3(k_tiles, a.bh / a.kv_group), THREADS,
         K::DKDV * sizeof(float), stream>>>(a);
  dq<<<dim3(q_tiles, a.bh), THREADS, K::DQ * sizeof(float), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*Launch)(const Args&, cudaStream_t);

template <int D> Launch pick_window(bool window, bool bf16) {
  if (bf16)
    return window ? launch<D, true, __nv_bfloat16>
                  : launch<D, false, __nv_bfloat16>;
  return window ? launch<D, true, float> : launch<D, false, float>;
}

// dtype: 0 = float32, 1 = bfloat16
Launch pick_launch(int d, int window, int dtype) {
  if (dtype != 0 && dtype != 1) return nullptr;
  const bool w = window > 0, bf16 = dtype == 1;
  switch (d) {
    case 16: return pick_window<16>(w, bf16);
    case 32: return pick_window<32>(w, bf16);
    case 64: return pick_window<64>(w, bf16);
    case 80: return pick_window<80>(w, bf16);
    case 128: return pick_window<128>(w, bf16);
    case 256: return pick_window<256>(w, bf16);
    default: return nullptr;
  }
}

}  // namespace

// q, o, dout [bh, sq, d] and k, v [bh / kv_group, skv, d], each with its
// own (head, row) strides and a contiguous last dim; dq [bh, sq, d] and dk,
// dv [bh / kv_group, skv, d] contiguous, of the inputs' dtype (0 = float32,
// 1 = bfloat16); lse and delta float32 [bh, sq] scratch.  d in {16, 32, 64,
// 80, 128, 256}; window >= 0 (0: none).  Three launches on ``stream`` (prep,
// dK/dV, dQ); returns the CUDA error of the launches (0 on success) and
// never synchronises.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int bh, int sq, int skv, int d, int kv_group, int causal, int window,
    float scale, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, long long o_sb,
    long long o_ss, long long do_sb, long long do_ss, int dtype,
    void* stream) {
  const Launch launch = pick_launch(d, window, dtype);
  if (launch == nullptr || window < 0 || kv_group < 1 || bh % kv_group)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta,
               bh, sq, skv, kv_group, causal, window, scale,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss};
  return launch(a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
