// Flash (online-softmax) attention, the prefill attention of the LM:
// O[bh] = softmax(cap(Q[bh] K[g]^T / sqrt(D)), causal and window masks) V[g]
// with g = bh / kv_group (grouped-query attention reads its KV head in
// place).  A window W > 0 keeps key k for query q only where q - k < W (the
// JAX layers' sliding-window rule); W = 0 is no window.  A logit soft cap
// c > 0 replaces each scaled score s by c tanh(s / c) before the mask
// (Gemma 2's rule, as the JAX layers' dense_attention computes it); c = 0
// is no cap.  A query offset o puts query row i at position i + o for the
// causal and window compares (a chunk of queries after o earlier ones).
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention (the Pallas online-softmax kernel; grid (BH, Sq/bq,
// Skv/bkv) with the (m, l, acc) carry in VMEM across the kv grid axis).
//
// Numerics follow the TPU kernel: scores and the (max, denominator,
// accumulator) carries in fp32, masked scores set to NEG_INF = -1e30 (not
// -inf) so their probabilities come out 0, p rounded to V's type before the
// PV product, the denominator floored at 1e-20.
//
// Bound on the H100: operations.  Causal prefill at the serving path's
// shapes (1 x 32 heads x 2048 x 64, bf16) is 2*B*H*S^2*D = 1.72e10 FLOP
// against 21 MB of q/k/v/o: 0.0174 ms at the 989 TFLOP/s bf16 tensor-core
// peak, far above the ~0.006 ms memory time.  So bf16 has to run on the
// tensor cores, and it does (two kernels, one entry, chosen by dtype):
//
// bf16 -- flash_bf16_kernel, wgmma + TMA (the FlashAttention-3 layout
// without warp specialisation).  One block of two consumer warpgroups owns
// a 128-row query tile, 64 rows per warpgroup; Q is loaded once by TMA.
// The block shape is set by occupancy: a thread holds 64 score, 32 P and
// D/2 output registers (ptxas: 151 registers at D = 64, 184 at D = 128),
// so only one 256-thread block fits an SM's 64 K registers, and its two
// warpgroups share every K/V tile and hide each other's softmax behind
// their products.  K and V stream through a ring of shared-memory stages
// (three, two at D = 128 and 256), each filled by TMA
// (cp.async.bulk.tensor, 3-D tensor maps over [heads, S, D] with the
// 128/64/32-byte swizzle that a D-wide row allows; D = 128 is two and
// D = 256 four 64-column swizzle atoms) and guarded by a "full" mbarrier
// (transaction bytes) and an "empty" mbarrier (one arrival per consumer
// warp).  Thread 0 refills the stage of tile j-1 with tile j-1+STAGES
// while tile j's products run, so the next loads are always in flight.
// S = Q K^T is wgmma.m64n128k16 (m64n64k16 at D = 256, whose tiles hold
// 64 keys) with both operands K-major in shared memory; the fp32 score
// fragments get the online softmax in registers (row max and sum over the
// quad of threads that share a row, __shfl_xor_sync 1 and 2), are rounded
// to bf16 in place, and are then exactly the A fragments of O += P V
// (wgmma.m64nDk16, A from registers, V MN-major through the transpose bit),
// so scores never go back to shared memory.  The fp32 O accumulator stays
// in registers for the whole walk.  exp(x * scale) is computed as
// exp2f(x * scale * log2 e): its
// rounding differs from expf by a few fp32 ulp, far inside the bf16
// output's tolerance.  The causal and ragged masks are applied only on the
// diagonal tile and on the last (ragged) tile; full tiles skip the compare.
// TMA zero-fills rows past S, and the output rows past Sq are not stored.
// Blocks start with the heaviest query tiles (largest q0: the longest causal
// walks) so the short ones fill the tail on 132 SMs.  The tensor maps need
// 16-byte aligned bases and strides (the wrapper checks and raises), and
// cuTensorMapEncodeTiled is a driver API: it is fetched through
// cudaGetDriverEntryPoint, so the library never links -lcuda.
//
// fp32 -- flash_f32_kernel, fp32 FMAs on the CUDA cores.  TF32 tensor cores
// would break the 2e-4 fp32 contract of the JAX tests and the exact greedy
// tokens of the fp32 serving parity run, so fp32 keeps this design: one
// 256-thread block per (64-row query tile, bh) stages its Q tile once, walks
// the keys in 32-row tiles (K/V staged in shared memory, a 4x2 register tile
// of scores per thread, the online-softmax update with four threads per
// query row, a 4 x (D/16) accumulator tile per thread).
//
// Both stop a causal walk after the tile holding the block's last query
// row, which skips exactly the tiles the TPU grid ran fully masked (they
// left every carry unchanged).  Under a window W both also start the walk at
// the tile holding key p0 - W + 1 (p0 the position of the block's first
// query row), so tiles wholly left of every row's window are never loaded;
// the window compare runs only on tiles that reach past some row's left
// edge.  A row whose keys in a tile are all masked keeps a running max of
// NEG_INF; its exponentials are then taken against 0, so they come out 0
// (not 1) and the first tile with a valid key resets the carries.  The
// window, the query offset and the soft cap are runtime values of one
// template flag, GENERAL (a kernel with it and one without, so no more
// instantiations than the window alone made): without them a launch runs
// the kernel it ran before any of the three, with the same arithmetic.
// The general kernel takes "no window" as a window of 2^30 keys, walks
// the offset's tile range (the causal walk ends at the tile holding key
// p0 + rows - 1) and caps every score tile in fp32 with the accurate
// tanhf (about one more exponential and a division a score beside the
// softmax's exponential): the fp32 kernel must hold its 2e-4 and the bf16
// kernel the limits of its uncapped rows.  The bf16 kernel keeps raw
// (unscaled) scores, so it caps them as (c / scale) tanh(s scale / c).
// Ragged Sq and Skv
// are masked, so any length works; row and sequence strides are arguments,
// so q/k/v may be views of the model's [B, S, H, D] projections.
//
// D = 80 (h2o-danube) runs the bf16 kernel's D = 128 tile over tensor maps
// whose inner dimension is 80: TMA zero-fills columns 80-127 of every Q, K
// and V box (and still counts the whole box in the mbarrier's transaction
// bytes), the zero columns add nothing to Q K^T and give output columns
// that are never stored.  The fp32 kernel takes D = 80 as it is (five
// accumulator columns a thread).
//
// Training asks for each row's log-sum-exp (``lse`` not null; serving
// passes null and gets the same output bits as without it): both kernels
// store, beside the row's output, L2 = m * scale * log2(e) + log2(l) from
// the running max m of the raw scores and the denominator l they hold, so
// that the backward (csrc/flash_attention_bwd.cu) recovers
// P = exp2(s * scale * log2(e) - L2) without walking the keys again (s the
// capped score under a cap).  A row that attends no key (l = 0) stores 0:
// its masked P stays 0.
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
// the general kernels' window when the caller has none: wider than any
// sequence, and small enough that positions plus it never overflow
constexpr int NO_WINDOW = 1 << 30;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int NWG = 2;                 // consumer warpgroups per block
constexpr int BQ = 64 * NWG;           // query rows per block
constexpr int BF16_THREADS = 128 * NWG;
constexpr float LOG2E = 1.4426950408889634f;

// D = 256 (recurrentgemma) takes 64 keys a tile and a 2-stage ring: a
// thread then holds 128 O, 32 score and 16 P registers (at 128 keys the
// scores alone would be 64 more), and Q (64 KB) with two stages of K and V
// (4 x 32 KB) is 193 KB of the 227 KB a block may opt into.
template <int D> struct Tile {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle bytes
  static constexpr int ACOLS = SW / 2;   // bf16 columns of one swizzle atom
  static constexpr int NSUB = D / ACOLS;            // atoms across D
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int BKV = D == 256 ? 64 : 128;   // keys per tile
  static constexpr int STAGES = D >= 128 ? 2 : 3;   // K/V ring depth
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;      // one K or V tile
  static constexpr int NO = ACOLS / 2;   // O fragment floats per atom
  // 1024 bytes of slack to align the tiles, then the 2 * STAGES + 1
  // mbarriers
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (2 * STAGES + 1);
  static_assert(SMEM <= 227 * 1024, "a block opts into at most 227 KB");
};

using hopper::load_box;

// D: the tile's width; DV <= D: the rows' (D = 128 tile, DV = 80: TMA
// zero-fills the columns past DV, which are never stored); GENERAL: the
// window, query offset and soft cap apply (else all three are off)
template <int D, int DV, bool GENERAL>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int n_bh, int sq, int skv, int kv_group, int causal,
                  int window, int q_offset, float softcap, float scale,
                  int heads_inner) {
  using T = Tile<D>;
  constexpr int SW = T::SW, NSUB = T::NSUB, NO = T::NO, STAGES = T::STAGES;
  constexpr int BKV = T::BKV;
  extern __shared__ uint8_t smem[];
  const uint32_t s_q = (hopper::smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t s_kv = s_q + T::Q_BYTES;  // stage s: K, then V
  const uint32_t s_bar = s_kv + STAGES * 2 * T::KV_BYTES;
  // full[s] at s_bar + 8 s, empty[s] at s_bar + 8 (STAGES + s), Q's last
  const uint32_t q_bar = s_bar + 16 * STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;
  const int bh = blockIdx.x % n_bh;
  const int kvh = bh / kv_group;
  const int p0 = q0 + (GENERAL ? q_offset : 0);  // first row's position
  const int kv_end = causal ? min(skv, p0 + BQ) : skv;
  // first tile: the one holding key p0 - window + 1, the block's leftmost
  // key in any row's window
  const int j0 = GENERAL ? max(0, p0 - window + 1) / BKV : 0;
  const int n_kv = max(0, (kv_end + BKV - 1) / BKV - j0);  // tiles walked

  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int j, int s) {
    const uint32_t full = s_bar + 8 * s;
    const uint32_t k_dst = s_kv + s * 2 * T::KV_BYTES;
    hopper::mbar_expect_tx(full, 2 * T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NSUB; ++c) {
      load_box(k_dst + c * BKV * SW, map_k, c * T::ACOLS, j * BKV, kvh,
               heads_inner & 2, full);
      load_box(k_dst + T::KV_BYTES + c * BKV * SW, map_v, c * T::ACOLS,
               j * BKV, kvh, heads_inner & 4, full);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(s_bar + 8 * s, 1);
      hopper::mbar_init(s_bar + 8 * (STAGES + s), 4 * NWG);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_bar, T::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NSUB; ++c)
      load_box(s_q + c * BQ * SW, &tm_q, c * T::ACOLS, q0, bh,
               heads_inner & 1, q_bar);
    for (int t = 0; t < STAGES && t < n_kv; ++t) load_kv(j0 + t, t);
  }

  // this thread's two query rows: r0 holds fragment entries 4i, 4i+1 and
  // r0 + 8 entries 4i+2, 4i+3 (columns 8i + 2 (lane % 4) + {0, 1})
  const int r0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int pr0 = r0 + p0 - q0;  // its position
  const float c2 = scale * LOG2E;
  // the cap on raw scores: (c / scale) tanh(s scale / c)
  const float cap_out = GENERAL ? softcap / scale : 0.f;
  const float cap_in = GENERAL && softcap > 0.f ? scale / softcap : 0.f;
  float o_acc[NSUB][NO];
#pragma unroll
  for (int c = 0; c < NSUB; ++c)
#pragma unroll
    for (int i = 0; i < NO; ++i) o_acc[c][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max (raw scores)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  hopper::mbar_wait(q_bar, 0);
  const int row_last = p0 + 64 * wg + 63;  // its warpgroup's last position
  for (int t = 0; t < n_kv; ++t) {  // t-th tile walked: key tile j0 + t
    const int j = j0 + t;
    const int s = t % STAGES;
    const uint32_t k_tile = s_kv + s * 2 * T::KV_BYTES;
    const uint32_t v_tile = k_tile + T::KV_BYTES;
    hopper::mbar_wait(s_bar + 8 * s, (t / STAGES) & 1);

    // S = Q K^T: D / 16 k-steps, each 32 bytes into a swizzle atom
    float sacc[BKV / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int atom = kk * 32 / SW, off = kk * 32 % SW;
      const uint64_t da = hopper::smem_desc(
          s_q + atom * BQ * SW + wg * 64 * SW + off, 16, 8 * SW, T::LAYOUT);
      const uint64_t db = hopper::smem_desc(k_tile + atom * BKV * SW + off,
                                            16, 8 * SW, T::LAYOUT);
      hopper::WgmmaSS<BKV>::run(sacc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    // refill the stage tile t-1 used while this tile's products run
    if (tid == 0 && t >= 1 && t - 1 + STAGES < n_kv) {
      const int sp = (t - 1) % STAGES;
      hopper::mbar_wait(s_bar + 8 * (STAGES + sp), ((t - 1) / STAGES) & 1);
      load_kv(j0 + t - 1 + STAGES, sp);
    }
    __syncwarp();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    if (GENERAL && softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        sacc[i] = cap_out * tanhf(sacc[i] * cap_in);
    }

    // masks: only the diagonal tile, the ragged last tile and the tiles
    // that reach past a row's window edge need them
    const int k0 = j * BKV;
    if (k0 + BKV > skv || (causal && k0 + BKV - 1 > p0 + 64 * wg) ||
        (GENERAL && row_last - k0 >= window)) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const int pos = pr0 + 8 * ((i / 2) & 1);
        if (kpos >= skv || (causal && pos < kpos) ||
            (GENERAL && pos - kpos >= window))
          sacc[i] = NEG_INF;
      }
    }

    // online softmax over the quad that shares each row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BKV / 2; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sacc[i], sacc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[i + 2], sacc[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float corr0 = exp2f((m0 - mx0) * c2);
    const float corr1 = exp2f((m1 - mx1) * c2);
    m0 = mx0;
    m1 = mx1;
    // under a window, a row with no valid key yet: exponentials against 0
    // give p = 0 (without one every row's first tile holds key 0)
    const float mc0 = (GENERAL && mx0 == NEG_INF ? 0.f : mx0) * c2;
    const float mc1 = (GENERAL && mx1 == NEG_INF ? 0.f : mx1) * c2;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[BKV / 4];  // P in bf16: the A fragments of P V
#pragma unroll
    for (int i = 0; i < BKV / 2; i += 2) {
      const bool hi = (i / 2) & 1;
      const float pa0 = exp2f(fmaf(sacc[i], c2, hi ? -mc1 : -mc0));
      const float pa1 = exp2f(fmaf(sacc[i + 1], c2, hi ? -mc1 : -mc0));
      if (hi)
        sum1 += pa0 + pa1;
      else
        sum0 += pa0 + pa1;
      pa[i / 2] = hopper::pack_bf16x2(pa0, pa1);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int c = 0; c < NSUB; ++c)
#pragma unroll
      for (int i = 0; i < NO; ++i) o_acc[c][i] *= (i & 2) ? corr1 : corr0;

    // O += P V: BKV / 16 k-steps of 16 keys, one wgmma per swizzle atom
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < NSUB; ++c) {
        const uint64_t db =
            hopper::smem_desc(v_tile + c * BKV * SW + kk * 16 * SW, 8 * SW,
                              8 * SW, T::LAYOUT);
        hopper::WgmmaRS<T::ACOLS>::run(o_acc[c], a, db);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NSUB; ++c) hopper::fence_regs(o_acc[c]);
    hopper::fence_regs(pa);
    if (lane == 0) hopper::mbar_arrive(s_bar + 8 * (STAGES + s));
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-20f), den1 = fmaxf(l1, 1e-20f);
  __nv_bfloat16* orow0 = o + (static_cast<size_t>(bh) * sq + r0) * DV;
  __nv_bfloat16* orow1 = orow0 + 8 * DV;
#pragma unroll
  for (int c = 0; c < NSUB; ++c)
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      const int col = c * T::ACOLS + 2 * i + 2 * (lane % 4);
      if (DV < D && col >= DV) continue;
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(orow0 + col) = hopper::pack_bf16x2(
            o_acc[c][i] / den0, o_acc[c][i + 1] / den0);
      if (r0 + 8 < sq)
        *reinterpret_cast<uint32_t*>(orow1 + col) = hopper::pack_bf16x2(
            o_acc[c][i + 2] / den1, o_acc[c][i + 3] / den1);
    }
  if (lse != nullptr && lane % 4 == 0) {
    float* lrow = lse + static_cast<size_t>(bh) * sq;
    if (r0 < sq) lrow[r0] = l0 > 0.f ? fmaf(m0, c2, log2f(l0)) : 0.f;
    if (r0 + 8 < sq) lrow[r0 + 8] = l1 > 0.f ? fmaf(m1, c2, log2f(l1)) : 0.f;
  }
}

template <int D, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int sq, int skv, int kv_group, int causal,
                int window, int q_offset, float softcap, float scale,
                long long q_sb, long long q_ss,
                long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                cudaStream_t stream) {
  using T = Tile<D>;
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return hopper::ERR_NO_ENCODER;
  const CUtensorMapSwizzle swizzle = hopper::swizzle_of(T::SW);
  CUtensorMap tq, tk, tv;
  bool inner_q, inner_k, inner_v;
  const int n_kv = bh / kv_group;
  if (!hopper::encode(fn, &tq, q, bh, sq, DV, q_sb, q_ss, BQ, T::ACOLS,
                      swizzle, &inner_q) ||
      !hopper::encode(fn, &tk, k, n_kv, skv, DV, k_sb, k_ss, T::BKV,
                      T::ACOLS, swizzle, &inner_k) ||
      !hopper::encode(fn, &tv, v, n_kv, skv, DV, v_sb, v_ss, T::BKV,
                      T::ACOLS, swizzle, &inner_v))
    return hopper::ERR_ENCODE;
  const int heads_inner = inner_q | inner_k << 1 | inner_v << 2;
  const bool general = window > 0 || q_offset > 0 || softcap > 0.f;
  auto kernel = general ? flash_bf16_kernel<D, DV, true>
                        : flash_bf16_kernel<D, DV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = ((sq + BQ - 1) / BQ) * bh;
  kernel<<<grid, BF16_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, bh, sq, skv, kv_group,
      causal, window > 0 ? window : NO_WINDOW, q_offset, softcap, scale,
      heads_inner);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;        // query rows per block
constexpr int F32_BKV = 32;       // keys per tile
constexpr int F32_THREADS = 256;  // 16 x 16; four threads per query row

template <int D> constexpr size_t f32_smem_floats() {
  return F32_BQ * (D + 1)          // qs: Q tile (padded rows: no conflicts)
         + F32_BKV * (D + 1)       // ks: K tile
         + F32_BKV * D             // vs: V tile
         + F32_BQ * (F32_BKV + 1)  // ss: scores, then p
         + 3 * F32_BQ;             // running max, denominator, correction
}

template <int D, bool GENERAL>
__global__ void __launch_bounds__(F32_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int sq, int skv, int kv_group,
                 int causal, int window, int q_offset, float softcap,
                 float scale, long long q_sb,
                 long long q_ss, long long k_sb, long long k_ss,
                 long long v_sb, long long v_ss) {
  constexpr int BQ = F32_BQ, BKV = F32_BKV, THREADS = F32_THREADS;
  constexpr int TJ = D / 16;  // accumulator columns per thread
  extern __shared__ float fsmem[];
  float* qs = fsmem;
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
  const int p0 = q0 + (GENERAL ? q_offset : 0);  // first row's position
  const float* qb = q + bh * q_sb;
  const float* kb = k + (bh / kv_group) * k_sb;
  const float* vb = v + (bh / kv_group) * v_sb;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int gr = q0 + r;
    qs[r * (D + 1) + d] = gr < sq ? qb[gr * q_ss + d] : 0.f;
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

  // keys past the tile's last query row are masked for all of its rows,
  // and keys left of p0 - window + 1 for all of them under a window
  const int kv_end = causal ? min(skv, p0 + BQ) : skv;
  const int kv_begin = GENERAL ? max(0, p0 - window + 1) / BKV * BKV : 0;
  __syncthreads();

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int gk = k0 + r;
      const bool ok = gk < skv;
      ks[r * (D + 1) + d] = ok ? kb[gk * k_ss + d] : 0.f;
      vs[r * D + d] = ok ? vb[gk * v_ss + d] : 0.f;
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
        const bool valid = kpos < skv && (!causal || p0 + row >= kpos) &&
                           (!GENERAL || p0 + row - kpos < window);
        float x = sacc[i][j] * scale;
        if (GENERAL && softcap > 0.f) x = softcap * tanhf(x / softcap);
        ss[row * (BKV + 1) + col] = valid ? x : NEG_INF;
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
        const bool valid = kpos < skv && (!causal || p0 + r >= kpos) &&
                           (!GENERAL || p0 + r - kpos < window);
        const float p = valid ? expf(srow[c] - m_new) : 0.f;
        sum += p;
        srow[c] = p;
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
    float* orow = o + ((size_t)bh * sq + gr) * D;
#pragma unroll
    for (int j = 0; j < TJ; ++j) orow[tx + 16 * j] = acc[i][j] / den;
    // m_s holds scaled scores (natural units): L2 = m log2(e) + log2(l)
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * sq + gr] =
          l_s[row] > 0.f ? fmaf(m_s[row], LOG2E, log2f(l_s[row])) : 0.f;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int skv, int kv_group, int causal,
               int window, int q_offset, float softcap, float scale,
               long long q_sb, long long q_ss,
               long long k_sb, long long k_ss, long long v_sb, long long v_ss,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_floats<D>() * sizeof(float);
  static_assert(smem <= 227 * 1024, "a block opts into at most 227 KB");
  const bool general = window > 0 || q_offset > 0 || softcap > 0.f;
  auto kernel = general ? flash_f32_kernel<D, true>
                        : flash_f32_kernel<D, false>;
  // above 48 KB (D = 80, 128, 256: 141 KB) only as opted-in dynamic
  // shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + F32_BQ - 1) / F32_BQ, bh);
  kernel<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, skv,
      kv_group, causal, window > 0 ? window : NO_WINDOW, q_offset, softcap,
      scale, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*Launch)(const void*, const void*, const void*, void*, float*,
                      int, int, int, int, int, int, int, float, float,
                      long long, long long, long long, long long, long long,
                      long long, cudaStream_t);

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores)
Launch pick_launch(int d, int dtype) {
  if (dtype != 0 && dtype != 1) return nullptr;
  const bool bf16 = dtype == 1;
  switch (d) {
    case 16: return bf16 ? launch_bf16<16, 16> : launch_f32<16>;
    case 32: return bf16 ? launch_bf16<32, 32> : launch_f32<32>;
    case 64: return bf16 ? launch_bf16<64, 64> : launch_f32<64>;
    case 80: return bf16 ? launch_bf16<128, 80> : launch_f32<80>;  // padded
    case 128: return bf16 ? launch_bf16<128, 128> : launch_f32<128>;
    case 256: return bf16 ? launch_bf16<256, 256> : launch_f32<256>;
    default: return nullptr;
  }
}

// the bf16 kernel's K/V ring: keys a tile (what = 0) or its stages
template <int D> int kv_ring(int what) {
  return what == 0 ? Tile<D>::BKV : Tile<D>::STAGES;
}

}  // namespace

// the bf16 kernel's K/V ring at head dim d: keys a tile (what = 0) or
// stages (what = 1); 0 for a head dim it does not take
extern "C" int repro_flash_attention_kv_ring(int d, int what) {
  switch (d) {
    case 16: return kv_ring<16>(what);
    case 32: return kv_ring<32>(what);
    case 64: return kv_ring<64>(what);
    case 80:  // the D = 128 tile
    case 128: return kv_ring<128>(what);
    case 256: return kv_ring<256>(what);
    default: return 0;
  }
}

// q [bh, sq, d] with strides (q_sb, q_ss, 1); k, v [bh / kv_group, skv, d]
// with their own strides; o [bh, sq, d] contiguous; lse null or float32
// [bh, sq] contiguous (each row's L2, see the header).  dtype: 0 = float32
// (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel; bases and strides
// 16-byte aligned), shared by all four.  d in {16, 32, 64, 80, 128, 256};
// window in [0, 2^30) (0: none); q_offset in [0, 2^30); softcap >= 0 (0:
// none).  Returns the CUDA error of the launch (0 on success; negative: a
// tensor-map failure, see repro_cuda_error_string); nothing here
// synchronises.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse, int bh,
    int sq, int skv, int d, int kv_group, int causal, int window,
    int q_offset, float scale, float softcap, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    int dtype, void* stream) {
  const Launch launch = pick_launch(d, dtype);
  if (launch == nullptr || window < 0 || window >= NO_WINDOW ||
      q_offset < 0 || q_offset >= NO_WINDOW || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, o, lse, bh, sq, skv, kv_group, causal, window,
                q_offset, softcap, scale, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return hopper::error_string(
      err, "cuTensorMapEncodeTiled refused a q/k/v tensor map (bases and "
           "strides must be 16-byte aligned)");
}
