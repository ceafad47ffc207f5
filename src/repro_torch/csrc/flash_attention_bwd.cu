// Flash-attention backward: the gradient of csrc/flash_attention.cu's
// O[bh] = softmax(cap(Q[bh] K[g]^T / sqrt(D)), causal and window masks)
// V[g], g = bh / kv_group, with respect to Q, K and V, given O, dO and the
// row log-sum-exps the forward saved; the soft cap c tanh(s / c) (c = 0:
// none) and the query offset (query row i at position i + o in the causal
// and window compares) are the forward's.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py,
// flash_attention (the Pallas online-softmax kernel), which the reference
// takes by autodiff of its jnp attention (src/repro/models/layers.py,
// blockwise_attention); the Pallas kernel itself has no custom_vjp.
//
// With S = Q K^T, P = exp2(S scale log2(e) - L2) (masked: 0), where L2 is
// the forward's log-sum-exp in base 2 (csrc/flash_attention.cu's header),
// and Delta = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV of a KV head summed over its kv_group query heads.  A row that
// attends no key has L2 = 0 and every P of it masked: it adds nothing.
// Under a soft cap c the forward's score is c t with t = tanh(S scale / c):
// P = exp2(c t log2(e) - L2), and dS above is the gradient of the capped
// score, so it is multiplied by the cap's derivative 1 - t^2 before the
// final scale.  t is recomputed from the score fragment where P and dS are
// formed (tanhf, fp32), never held for a tile.  The window, the offset and
// the cap are runtime values of one template flag, GENERAL, as in the
// forward: without them the kernels are what they were before any of the
// three.  The offset moves the walks' tile ranges: the dK/dV pass starts
// at the query tile holding position k0 (row k0 - o) and ends under a
// window at row k0 + keys - 2 + W - o; the dQ pass walks the forward's
// key tiles of positions q0 + o on.
//
// One call is three kernels on the stream:
//
//  1. prep (bwd_prep_kernel): one block per (64-row tile, bh), a warp a row,
//     writes Delta and a copy of L2 into a [bh][tile][L2, Delta][64] scratch,
//     zero past Sq, so that a whole tile's statistics are one aligned
//     512-byte copy.  A memory pass over O and dO.
//  2. dK/dV: one block per (KV head, key tile) keeps its tile's K and V and
//     its dK and dV (in registers), and walks its group's query heads and,
//     for each, the query tiles that can see the tile (a causal tile is seen
//     from its first key's row on, a windowed one until its last key's row
//     + W - 1).  So every dK/dV sum runs in one block in a fixed order (at
//     bf16 D = 256 in a few, each over a share of the heads, merged in a
//     fixed order): no atomics in the sums, and repeated calls agree bit
//     for bit.  The blocks of the longest causal walks (the first key
//     tiles) start first.
//  3. dQ: one block per (query tile, bh) keeps its Q, dO, L2 and Delta and
//     walks the key tiles the forward walks (causal walks end at the
//     diagonal tile, windowed walks start at the window's first tile),
//     heaviest query tiles first.  It recomputes S and dP rather than
//     sharing dS with the dK/dV pass, so that dQ needs no atomics either.
//
// bf16 runs both passes on the tensor cores.  At D = 16, 32, 64, 80 and 128
// (bwd_dkdv_wgmma_kernel, bwd_dq_wgmma_kernel: wgmma with operands fed by
// TMA, the forward kernel's building blocks in csrc/hopper.cuh) two
// consumer warpgroups share a block, 64 keys (dK/dV) or 64 query rows (dQ)
// each.  dK/dV: K and V (128 keys) are loaded once; the group's Q and dO
// tiles of 64 rows stream through a ring of mbarrier-guarded stages (4, 3
// from D = 128), each with its rows' L2 and Delta, which one bulk copy
// brings beside the tiles; thread 0 refills the stage of tile t-1 while
// tile t's products run, and the ring runs on across the group's heads.
// Per tile: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in
// shared memory); P^T and dS^T in registers, indexed (key, query), so a
// thread reads L2 and Delta of its columns 2 (lane % 4) + 8 j; then dV +=
// P^T dO and dK += dS^T Q (wgmma with A from registers: P^T and dS^T
// rounded to bf16 in place, exactly as the forward feeds P to P V; B = dO
// and Q read MN-major through the transpose bit).  dQ: Q and dO (128 rows)
// loaded once, K and V tiles (128 keys, 64 from D = 128) through a 3-stage
// ring; S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K (K
// MN-major).  P and dS are kept in fp32 until they are rounded to bf16 as
// wgmma operands; every sum is fp32.  The masks run only on the diagonal,
// window-edge and ragged tiles.  D = 80 runs the D = 128 tile over tensor
// maps whose inner dimension is 80 (TMA zero-fills columns 80-127, which
// add nothing and are never stored), as the forward does.  The accumulators
// stay in registers for the whole walk: at D = 128 dK and dV are 128 floats
// a thread and S^T, dP^T 64 more, so a 256-thread block holds its SM
// (__launch_bounds__(256, 1)).  14 FLOP per attended pair and head dim
// (dK/dV 8, dQ 6) against the least 10.
//
// At D = 256 (bwd_dkdv_wgmma256_kernel, bwd_dq_wgmma256_kernel) dK and dV
// of 64 keys by 256 columns would be 256 fp32 registers a thread, all that
// a thread may hold.  So both warpgroups of a block take the same 64 keys
// (dK/dV) or 64 rows (dQ) and split D: warpgroup w accumulates columns
// 128 w .. 128 w + 127, 128 floats of dK and dV (64 of dQ).  The score
// products contract all 256 columns; rather than form both in each
// warpgroup (1.5 times the dK/dV pass's products), warpgroup 0 forms S^T
// (S) and warpgroup 1 dP^T (dP), and the two meet in shared memory behind
// two named barriers: dP goes to warpgroup 0 in fp32, which forms P and dS
// as above and hands both back as the bf16 operands (see ``W256``).  So
// the arithmetic is the D <= 128 kernels', at their 14 FLOP a pair and
// head dim.  Tiles of 64 rows by 256 columns (32 KB) leave room for a
// 2-stage ring: dK/dV holds K and V (64 KB), two stages of Q, dO and their
// statistics (129 KB) and the 16 KB exchange, 210 KB; dQ holds Q and dO,
// two stages of K and V and the exchange, 209 KB.  One KV head's 64-key
// tiles are few (64 at S 4096), so a tile's group of query heads splits
// over several dK/dV blocks whose fp32 partials the last one to finish
// adds up in a fixed order (see ``W256``).
//
// fp32 at every D stays on the CUDA cores (bwd_dkdv_kernel, bwd_dq_kernel:
// fp32 FMAs, every operand staged in shared memory as fp32 with padded
// rows, a thread holding a 4 x 4 (2 x 2 at D = 256) block of each score
// tile), because TF32 tensor cores would break the 2e-4 fp32 contract, as
// in the forward.  Both routes read the saved L2 and Delta from the prep
// pass's scratch.
//
// Bound on the H100: operations.  At the training shape of granite-3-2b
// (B 4 x 32 heads over 8 KV heads, S 2048, D 64, causal) the least work is
// 10 FLOP per attended pair and head dim, 1.7e11 FLOP: 0.17 ms at the 989
// TFLOP/s bf16 tensor-core peak (0.24 ms for this design's 14).  Its
// traffic, 8 [BH, S, D] operands, is about 0.03 ms.  At recurrentgemma-2b's
// (B 2 x 10 heads over 1 KV head, S 4096, D 256, window 2048: 6.29 M pairs
// a head) it is 3.2e11 FLOP, 0.33 ms, against 0.06 ms of traffic.
#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 256;
constexpr int NWG = 2;        // consumer warpgroups of a tensor-core block
constexpr int ST_ROWS = 64;   // rows of a statistics tile

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // [bh, sq]: the forward's L2
  void *dq, *dk, *dv;
  float* stats;      // [bh, n_st, 2, ST_ROWS]: L2 and Delta, 0 past sq
  int bh, sq, skv, kv_group, causal, window, q_offset, n_st;
  float scale;
  float cap_in, cap_l2;  // scale / c and c log2(e) under a cap c > 0
  int capped;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss;
  // the D = 256 route's split of a KV head's group over dK/dV blocks:
  // query heads a block (kv_group: no split), and under a split the
  // blocks' fp32 partials and a merge counter a key tile (zeroed by prep)
  int hpb;
  float* part;
  int* counters;
  int n_counters;
};

// L2 (which = 0) or Delta (which = 1) of row ``row`` of head ``bh``
__device__ __forceinline__ float stat(const Args& a, int bh, int row,
                                      int which) {
  return a.stats[((static_cast<long long>(bh) * a.n_st + row / ST_ROWS) * 2 +
                  which) * ST_ROWS + row % ST_ROWS];
}

// whether query row ``row`` (at position row + q_offset) attends key kpos
template <bool GENERAL>
__device__ __forceinline__ bool attends(const Args& a, int row, int kpos) {
  const int qpos = row + (GENERAL ? a.q_offset : 0);
  return row < a.sq && kpos < a.skv && (!a.causal || qpos >= kpos) &&
         (!GENERAL || qpos - kpos < a.window);
}

// P of a raw score s (Q K^T) at its row's L2, and in ``dcap`` the soft
// cap's derivative 1 - t^2 there (1 without a cap)
template <bool GENERAL>
__device__ __forceinline__ float prob(const Args& a, float s, float c2,
                                      float l2, float& dcap) {
  if (GENERAL && a.capped) {
    const float t = tanhf(s * a.cap_in);
    dcap = 1.f - t * t;
    return exp2f(fmaf(t, a.cap_l2, -l2));
  }
  dcap = 1.f;
  return exp2f(fmaf(s, c2, -l2));
}

// ---------------------------------------------------------------------------
// 1. prep: Delta = rowsum(dO * O) and a copy of L2, a tile of 64 rows
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) bwd_prep_kernel(Args a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, tile = blockIdx.x;
  if (bh == 0 && tile == 0)  // the dK/dV merge's counters, for this call
    for (int i = threadIdx.x; i < a.n_counters; i += THREADS)
      a.counters[i] = 0;
  const T* ob = static_cast<const T*>(a.o) + bh * a.o_sb;
  const T* db = static_cast<const T*>(a.dout) + bh * a.do_sb;
  float* out =
      a.stats + (static_cast<long long>(bh) * a.n_st + tile) * 2 * ST_ROWS;
  for (int r = warp; r < ST_ROWS; r += THREADS / 32) {
    const int row = tile * ST_ROWS + r;
    float acc = 0.f;
    if (row < a.sq)
      for (int d = lane; d < D; d += 32)
        acc += ld(ob + row * a.o_ss + d) * ld(db + row * a.do_ss + d);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      out[r] = row < a.sq ? a.lse[static_cast<long long>(bh) * a.sq + row]
                          : 0.f;
      out[ST_ROWS + r] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// DT: the tile's width (D, or 128 for D = 80)
template <int DT> struct Wg {
  static constexpr int SW = DT * 2 < 128 ? DT * 2 : 128;  // swizzle bytes
  static constexpr int ACOLS = SW / 2;   // bf16 columns of one swizzle atom
  static constexpr int NSUB = DT / ACOLS;            // atoms across DT
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int NA = ACOLS / 2;   // accumulator floats an atom
  // dK/dV: 128 keys a block, 64-row Q/dO tiles (with their statistics)
  // through the ring
  static constexpr int KB = 64 * NWG;
  static constexpr int QT = ST_ROWS;
  static constexpr int DKDV_STAGES = DT >= 128 ? 3 : 4;
  static constexpr int K_BYTES = KB * DT * 2;
  static constexpr int QT_BYTES = QT * DT * 2;
  static constexpr int ST_BYTES = 2 * ST_ROWS * 4;  // L2 and Delta of a tile
  // 1024 bytes of slack to align the tiles, then the 2 * STAGES + 1
  // mbarriers
  static constexpr int DKDV_SMEM = 1024 + 2 * K_BYTES +
                                   DKDV_STAGES * (2 * QT_BYTES + ST_BYTES) +
                                   8 * (2 * DKDV_STAGES + 1);
  // dQ: 128 rows a block, K/V tiles through the ring
  static constexpr int QB = 64 * NWG;
  static constexpr int BKV = DT >= 128 ? 64 : 128;
  static constexpr int DQ_STAGES = 3;
  static constexpr int QB_BYTES = QB * DT * 2;
  static constexpr int KV_BYTES = BKV * DT * 2;
  static constexpr int DQ_SMEM =
      1024 + 2 * QB_BYTES + DQ_STAGES * 2 * KV_BYTES + 8 * (2 * DQ_STAGES + 1);
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448,
                "a block opts into at most 227 KB");
};

// 2. dK, dV: one block per (KV head, 128-key tile)
template <int DT, int DV, bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Args a,
                      int heads_inner) {
  using W = Wg<DT>;
  constexpr int SW = W::SW, NSUB = W::NSUB, NA = W::NA, QT = W::QT;
  constexpr int ST = W::DKDV_STAGES, KB = W::KB;
  extern __shared__ uint8_t smem[];
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t s_k = (base + 1023u) & ~1023u;
  const uint32_t s_v = s_k + W::K_BYTES;
  const uint32_t s_ring = s_v + W::K_BYTES;  // stage s: Q, then dO
  const uint32_t s_st = s_ring + ST * 2 * W::QT_BYTES;  // stage s: L2, Delta
  const uint32_t s_bar = s_st + ST * W::ST_BYTES;
  // full[s] at s_bar + 8 s, empty[s] at s_bar + 8 (ST + s), K/V's last
  const uint32_t kv_bar = s_bar + 16 * ST;
  const float* stats = reinterpret_cast<const float*>(smem + (s_st - base));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int n_kv = a.bh / a.kv_group;
  const int g = blockIdx.x % n_kv;
  const int k0 = static_cast<int>(blockIdx.x) / n_kv * KB;
  const int off = GENERAL ? a.q_offset : 0;
  // the query tiles that see a key of the block: from the one holding
  // position k0 under a causal mask, up to position k0 + KB - 2 + W under
  // a window (row = position - off)
  const int qt0 = a.causal ? max(0, k0 - off) / QT : 0;
  const int q_end =
      GENERAL ? min(a.sq, k0 + KB - 1 + a.window - off) : a.sq;
  const int n_qt = max(0, (q_end + QT - 1) / QT - qt0);
  const int n_t = n_qt * a.kv_group;  // the group's heads, each over n_qt

  auto load_tile = [&](int t, int s) {
    const int bh = g * a.kv_group + t / n_qt;
    const int q0 = (qt0 + t % n_qt) * QT;
    const uint32_t full = s_bar + 8 * s;
    const uint32_t q_dst = s_ring + s * 2 * W::QT_BYTES;
    hopper::mbar_expect_tx(full, 2 * W::QT_BYTES + W::ST_BYTES);
#pragma unroll
    for (int c = 0; c < NSUB; ++c) {
      hopper::load_box(q_dst + c * QT * SW, &tm_q, c * W::ACOLS, q0, bh,
                       heads_inner & 1, full);
      hopper::load_box(q_dst + W::QT_BYTES + c * QT * SW, &tm_do,
                       c * W::ACOLS, q0, bh, heads_inner & 8, full);
    }
    hopper::bulk_load(
        s_st + s * W::ST_BYTES,
        a.stats + (static_cast<long long>(bh) * a.n_st + q0 / ST_ROWS) * 2 *
                      ST_ROWS,
        W::ST_BYTES, full);
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(s_bar + 8 * s, 1);
      hopper::mbar_init(s_bar + 8 * (ST + s), 4 * NWG);
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_bar, 2 * W::K_BYTES);
#pragma unroll
    for (int c = 0; c < NSUB; ++c) {
      hopper::load_box(s_k + c * KB * SW, &tm_k, c * W::ACOLS, k0, g,
                       heads_inner & 2, kv_bar);
      hopper::load_box(s_v + c * KB * SW, &tm_v, c * W::ACOLS, k0, g,
                       heads_inner & 4, kv_bar);
    }
    for (int t = 0; t < ST && t < n_t; ++t) load_tile(t, t);
  }

  // this warpgroup's keys kw0..kw0+63; this thread's kr0 (fragment entries
  // 4i, 4i+1) and kr0 + 8 (4i+2, 4i+3), at queries 8i + 2 (lane % 4) + {0,1}
  const int kw0 = k0 + 64 * wg;
  const int kr0 = kw0 + 16 * warp + lane / 4;
  const float c2 = a.scale * LOG2E;
  float dk_acc[NSUB][NA], dv_acc[NSUB][NA];
#pragma unroll
  for (int c = 0; c < NSUB; ++c)
#pragma unroll
    for (int i = 0; i < NA; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  hopper::mbar_wait(kv_bar, 0);
  for (int t = 0; t < n_t; ++t) {
    const int s = t % ST;
    const int q0 = (qt0 + t % n_qt) * QT;
    const uint32_t q_tile = s_ring + s * 2 * W::QT_BYTES;
    const uint32_t do_tile = q_tile + W::QT_BYTES;
    hopper::mbar_wait(s_bar + 8 * s, (t / ST) & 1);

    // S^T = K Q^T, dP^T = V dO^T: DT / 16 k-steps, 32 bytes into an atom
    float sacc[QT / 2], dpacc[QT / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const int atom = kk * 32 / SW, off = kk * 32 % SW;
      hopper::WgmmaSS<QT>::run(
          sacc,
          hopper::smem_desc(s_k + atom * KB * SW + wg * 64 * SW + off, 16,
                            8 * SW, W::LAYOUT),
          hopper::smem_desc(q_tile + atom * QT * SW + off, 16, 8 * SW,
                            W::LAYOUT),
          kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const int atom = kk * 32 / SW, off = kk * 32 % SW;
      hopper::WgmmaSS<QT>::run(
          dpacc,
          hopper::smem_desc(s_v + atom * KB * SW + wg * 64 * SW + off, 16,
                            8 * SW, W::LAYOUT),
          hopper::smem_desc(do_tile + atom * QT * SW + off, 16, 8 * SW,
                            W::LAYOUT),
          kk > 0);
    }
    hopper::wgmma_commit();
    // refill the stage tile t-1 used while this tile's products run
    if (tid == 0 && t >= 1 && t - 1 + ST < n_t) {
      const int sp = (t - 1) % ST;
      hopper::mbar_wait(s_bar + 8 * (ST + sp), ((t - 1) / ST) & 1);
      load_tile(t - 1 + ST, sp);
    }
    __syncwarp();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);

    // P^T and dS^T, rounded to bf16 in place as the A fragments of the next
    // products; masks only where some (key, query) pair of the warpgroup's
    // tile is not attended
    const float* ls = stats + s * 2 * ST_ROWS;  // L2 of the tile's rows
    const float* dl = ls + ST_ROWS;             // their Delta
    const bool edge = !(q0 + QT <= a.sq && kw0 + 64 <= a.skv &&
                        (!a.causal || q0 + off >= kw0 + 63) &&
                        (!GENERAL || q0 + QT - 1 + off - kw0 < a.window));
    uint32_t pa[QT / 4], dsa[QT / 4];
#pragma unroll
    for (int i = 0; i < QT / 2; i += 2) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int key = kr0 + 8 * ((i / 2) & 1);
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float dcap;
        float x = prob<GENERAL>(a, sacc[i + e], c2, ls[col + e], dcap);
        if (edge && !attends<GENERAL>(a, q0 + col + e, key)) x = 0.f;
        p[e] = x;
        ds[e] = x * (dpacc[i + e] - dl[col + e]);
        if (GENERAL) ds[e] *= dcap;
      }
      pa[i / 2] = hopper::pack_bf16x2(p[0], p[1]);
      dsa[i / 2] = hopper::pack_bf16x2(ds[0], ds[1]);
    }

    // dV += P^T dO, dK += dS^T Q: QT / 16 k-steps of 16 rows, one wgmma
    // per swizzle atom of dO / Q (MN-major)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t ap[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                              pa[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < NSUB; ++c)
        hopper::WgmmaRS<W::ACOLS>::run(
            dv_acc[c], ap,
            hopper::smem_desc(do_tile + c * QT * SW + kk * 16 * SW, 8 * SW,
                              8 * SW, W::LAYOUT));
    }
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t as[4] = {dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2],
                              dsa[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < NSUB; ++c)
        hopper::WgmmaRS<W::ACOLS>::run(
            dk_acc[c], as,
            hopper::smem_desc(q_tile + c * QT * SW + kk * 16 * SW, 8 * SW,
                              8 * SW, W::LAYOUT));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NSUB; ++c) {
      hopper::fence_regs(dk_acc[c]);
      hopper::fence_regs(dv_acc[c]);
    }
    hopper::fence_regs(pa);
    hopper::fence_regs(dsa);
    if (lane == 0) hopper::mbar_arrive(s_bar + 8 * (ST + s));
  }

  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(a.dv);
  const size_t row0 = (static_cast<size_t>(g) * a.skv + kr0) * DV;
#pragma unroll
  for (int c = 0; c < NSUB; ++c)
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      const int col = c * W::ACOLS + 2 * i + 2 * (lane % 4);
      if (DV < DT && col >= DV) continue;
      if (kr0 < a.skv) {
        *reinterpret_cast<uint32_t*>(dk + row0 + col) = hopper::pack_bf16x2(
            dk_acc[c][i] * a.scale, dk_acc[c][i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dv + row0 + col) =
            hopper::pack_bf16x2(dv_acc[c][i], dv_acc[c][i + 1]);
      }
      if (kr0 + 8 < a.skv) {
        *reinterpret_cast<uint32_t*>(dk + row0 + 8 * DV + col) =
            hopper::pack_bf16x2(dk_acc[c][i + 2] * a.scale,
                                dk_acc[c][i + 3] * a.scale);
        *reinterpret_cast<uint32_t*>(dv + row0 + 8 * DV + col) =
            hopper::pack_bf16x2(dv_acc[c][i + 2], dv_acc[c][i + 3]);
      }
    }
}

// 3. dQ: one block per (128-row query tile, bh)
template <int DT, int DV, bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Args a,
                    int heads_inner) {
  using W = Wg<DT>;
  constexpr int SW = W::SW, NSUB = W::NSUB, NA = W::NA, QB = W::QB;
  constexpr int ST = W::DQ_STAGES, BKV = W::BKV;
  extern __shared__ uint8_t smem[];
  const uint32_t s_q = (hopper::smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t s_do = s_q + W::QB_BYTES;
  const uint32_t s_ring = s_do + W::QB_BYTES;  // stage s: K, then V
  const uint32_t s_bar = s_ring + ST * 2 * W::KV_BYTES;
  // full[s] at s_bar + 8 s, empty[s] at s_bar + 8 (ST + s), Q/dO's last
  const uint32_t q_bar = s_bar + 16 * ST;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int n_qt = (a.sq + QB - 1) / QB;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / a.bh) * QB;
  const int bh = blockIdx.x % a.bh;
  const int g = bh / a.kv_group;
  const int off = GENERAL ? a.q_offset : 0;
  const int kv_end = a.causal ? min(a.skv, q0 + off + QB) : a.skv;
  // first tile: the one holding key q0 + off - window + 1
  const int j0 = GENERAL ? max(0, q0 + off - a.window + 1) / BKV : 0;
  const int n_kv = max(0, (kv_end + BKV - 1) / BKV - j0);  // tiles walked

  auto load_kv = [&](int j, int s) {
    const uint32_t full = s_bar + 8 * s;
    const uint32_t k_dst = s_ring + s * 2 * W::KV_BYTES;
    hopper::mbar_expect_tx(full, 2 * W::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NSUB; ++c) {
      hopper::load_box(k_dst + c * BKV * SW, &tm_k, c * W::ACOLS, j * BKV, g,
                       heads_inner & 2, full);
      hopper::load_box(k_dst + W::KV_BYTES + c * BKV * SW, &tm_v,
                       c * W::ACOLS, j * BKV, g, heads_inner & 4, full);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(s_bar + 8 * s, 1);
      hopper::mbar_init(s_bar + 8 * (ST + s), 4 * NWG);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_bar, 2 * W::QB_BYTES);
#pragma unroll
    for (int c = 0; c < NSUB; ++c) {
      hopper::load_box(s_q + c * QB * SW, &tm_q, c * W::ACOLS, q0, bh,
                       heads_inner & 1, q_bar);
      hopper::load_box(s_do + c * QB * SW, &tm_do, c * W::ACOLS, q0, bh,
                       heads_inner & 8, q_bar);
    }
    for (int t = 0; t < ST && t < n_kv; ++t) load_kv(j0 + t, t);
  }

  // this warpgroup's rows rw0..rw0+63; this thread's r0 (fragment entries
  // 4i, 4i+1) and r0 + 8 (4i+2, 4i+3), at keys 8i + 2 (lane % 4) + {0, 1}
  const int rw0 = q0 + 64 * wg;
  const int r0 = rw0 + 16 * warp + lane / 4;
  const float l0 = r0 < a.sq ? stat(a, bh, r0, 0) : 0.f;
  const float l1 = r0 + 8 < a.sq ? stat(a, bh, r0 + 8, 0) : 0.f;
  const float dl0 = r0 < a.sq ? stat(a, bh, r0, 1) : 0.f;
  const float dl1 = r0 + 8 < a.sq ? stat(a, bh, r0 + 8, 1) : 0.f;
  const float c2 = a.scale * LOG2E;
  float dq_acc[NSUB][NA];
#pragma unroll
  for (int c = 0; c < NSUB; ++c)
#pragma unroll
    for (int i = 0; i < NA; ++i) dq_acc[c][i] = 0.f;

  hopper::mbar_wait(q_bar, 0);
  for (int t = 0; t < n_kv; ++t) {  // t-th tile walked: key tile j0 + t
    const int k0 = (j0 + t) * BKV;
    const int s = t % ST;
    const uint32_t k_tile = s_ring + s * 2 * W::KV_BYTES;
    const uint32_t v_tile = k_tile + W::KV_BYTES;
    hopper::mbar_wait(s_bar + 8 * s, (t / ST) & 1);

    // S = Q K^T, dP = dO V^T
    float sacc[BKV / 2], dpacc[BKV / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const int atom = kk * 32 / SW, off = kk * 32 % SW;
      hopper::WgmmaSS<BKV>::run(
          sacc,
          hopper::smem_desc(s_q + atom * QB * SW + wg * 64 * SW + off, 16,
                            8 * SW, W::LAYOUT),
          hopper::smem_desc(k_tile + atom * BKV * SW + off, 16, 8 * SW,
                            W::LAYOUT),
          kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const int atom = kk * 32 / SW, off = kk * 32 % SW;
      hopper::WgmmaSS<BKV>::run(
          dpacc,
          hopper::smem_desc(s_do + atom * QB * SW + wg * 64 * SW + off, 16,
                            8 * SW, W::LAYOUT),
          hopper::smem_desc(v_tile + atom * BKV * SW + off, 16, 8 * SW,
                            W::LAYOUT),
          kk > 0);
    }
    hopper::wgmma_commit();
    if (tid == 0 && t >= 1 && t - 1 + ST < n_kv) {
      const int sp = (t - 1) % ST;
      hopper::mbar_wait(s_bar + 8 * (ST + sp), ((t - 1) / ST) & 1);
      load_kv(j0 + t - 1 + ST, sp);
    }
    __syncwarp();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);

    // dS = P * (dP - Delta), rounded to bf16 in place as the A fragments
    // of dS K; masks only on the diagonal, window-edge and ragged tiles
    const bool edge = !(rw0 + 64 <= a.sq && k0 + BKV <= a.skv &&
                        (!a.causal || rw0 + off >= k0 + BKV - 1) &&
                        (!GENERAL || rw0 + off + 63 - k0 < a.window));
    uint32_t dsa[BKV / 4];
#pragma unroll
    for (int i = 0; i < BKV / 2; i += 2) {
      const bool hi = (i / 2) & 1;
      const int row = hi ? r0 + 8 : r0;
      const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4);
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float dcap;
        const float p =
            prob<GENERAL>(a, sacc[i + e], c2, hi ? l1 : l0, dcap);
        ds[e] = p * (dpacc[i + e] - (hi ? dl1 : dl0));
        if (GENERAL) ds[e] *= dcap;
        if (edge && !attends<GENERAL>(a, row, kpos + e)) ds[e] = 0.f;
      }
      dsa[i / 2] = hopper::pack_bf16x2(ds[0], ds[1]);
    }

    // dQ += dS K: BKV / 16 k-steps of 16 keys, K MN-major
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t as[4] = {dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2],
                              dsa[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < NSUB; ++c)
        hopper::WgmmaRS<W::ACOLS>::run(
            dq_acc[c], as,
            hopper::smem_desc(k_tile + c * BKV * SW + kk * 16 * SW, 8 * SW,
                              8 * SW, W::LAYOUT));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NSUB; ++c) hopper::fence_regs(dq_acc[c]);
    hopper::fence_regs(dsa);
    if (lane == 0) hopper::mbar_arrive(s_bar + 8 * (ST + s));
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq) +
                      (static_cast<size_t>(bh) * a.sq + r0) * DV;
#pragma unroll
  for (int c = 0; c < NSUB; ++c)
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      const int col = c * W::ACOLS + 2 * i + 2 * (lane % 4);
      if (DV < DT && col >= DV) continue;
      if (r0 < a.sq)
        *reinterpret_cast<uint32_t*>(dq + col) = hopper::pack_bf16x2(
            dq_acc[c][i] * a.scale, dq_acc[c][i + 1] * a.scale);
      if (r0 + 8 < a.sq)
        *reinterpret_cast<uint32_t*>(dq + 8 * DV + col) = hopper::pack_bf16x2(
            dq_acc[c][i + 2] * a.scale, dq_acc[c][i + 3] * a.scale);
    }
}

template <int DT, int DV, bool GENERAL>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  using W = Wg<DT>;
  auto dkdv = bwd_dkdv_wgmma_kernel<DT, DV, GENERAL>;
  auto dq = bwd_dq_wgmma_kernel<DT, DV, GENERAL>;
  cudaError_t err;
  if ((err = hopper::allow_smem<bwd_dkdv_wgmma_kernel<DT, DV, GENERAL>>(
           W::DKDV_SMEM)) != cudaSuccess ||
      (err = hopper::allow_smem<bwd_dq_wgmma_kernel<DT, DV, GENERAL>>(
           W::DQ_SMEM)) != cudaSuccess)
    return static_cast<int>(err);
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return hopper::ERR_NO_ENCODER;
  const CUtensorMapSwizzle sw = hopper::swizzle_of(W::SW);
  const int n_kv = a.bh / a.kv_group;
  // dK/dV's maps (64-row Q/dO boxes, 128-key K/V boxes), then dQ's
  CUtensorMap q1, do1, k1, v1, q2, do2, k2, v2;
  bool in_q, in_k, in_v, in_do;
  if (!hopper::encode(fn, &q1, a.q, a.bh, a.sq, DV, a.q_sb, a.q_ss, W::QT,
                      W::ACOLS, sw, &in_q) ||
      !hopper::encode(fn, &do1, a.dout, a.bh, a.sq, DV, a.do_sb, a.do_ss,
                      W::QT, W::ACOLS, sw, &in_do) ||
      !hopper::encode(fn, &k1, a.k, n_kv, a.skv, DV, a.k_sb, a.k_ss, W::KB,
                      W::ACOLS, sw, &in_k) ||
      !hopper::encode(fn, &v1, a.v, n_kv, a.skv, DV, a.v_sb, a.v_ss, W::KB,
                      W::ACOLS, sw, &in_v) ||
      !hopper::encode(fn, &q2, a.q, a.bh, a.sq, DV, a.q_sb, a.q_ss, W::QB,
                      W::ACOLS, sw, &in_q) ||
      !hopper::encode(fn, &do2, a.dout, a.bh, a.sq, DV, a.do_sb, a.do_ss,
                      W::QB, W::ACOLS, sw, &in_do) ||
      !hopper::encode(fn, &k2, a.k, n_kv, a.skv, DV, a.k_sb, a.k_ss, W::BKV,
                      W::ACOLS, sw, &in_k) ||
      !hopper::encode(fn, &v2, a.v, n_kv, a.skv, DV, a.v_sb, a.v_ss, W::BKV,
                      W::ACOLS, sw, &in_v))
    return hopper::ERR_ENCODE;
  const int heads_inner = in_q | in_k << 1 | in_v << 2 | in_do << 3;
  bwd_prep_kernel<DV, __nv_bfloat16>
      <<<dim3(a.n_st, a.bh), THREADS, 0, stream>>>(a);
  dkdv<<<(a.skv + W::KB - 1) / W::KB * n_kv, THREADS, W::DKDV_SMEM,
         stream>>>(q1, do1, k1, v1, a, heads_inner);
  dq<<<(a.sq + W::QB - 1) / W::QB * a.bh, THREADS, W::DQ_SMEM, stream>>>(
      q2, do2, k2, v2, a, heads_inner);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 at D = 256 on the tensor cores: the head dim split between the
// warpgroups
// ---------------------------------------------------------------------------

// Both warpgroups of a block take the same 64 keys (dK/dV) or 64 query rows
// (dQ), and warpgroup w accumulates columns 128 w .. 128 w + 127 (swizzle
// atoms 2 w, 2 w + 1) of dK and dV (dQ).  The score products contract all
// 256 columns, so warpgroup 0 forms S^T (S) and warpgroup 1 dP^T (dP), and
// they meet in shared memory: warpgroup 1 writes its dP fragment, fp32,
// to the exchange and arrives on barrier 1; warpgroup 0 waits there, reads
// it, forms P and dS in fp32 as the D <= 128 kernels do, writes both
// rounded to bf16 (dQ: dS) over what it read, and arrives on barrier 2,
// where warpgroup 1 waits to read them.  Thread r of one warpgroup holds
// the fragment entries of thread r of the other, so the exchange is a
// plain copy, pair m of thread r at slot m * 128 + r (a warp touches 256
// contiguous bytes: no bank conflict).  A warpgroup's next write follows
// its reads of the last, so one 16 KB buffer serves every tile.
//
// A dK/dV block of 64 keys walks hpb of its group's query heads: with all
// of them, one KV head's blocks would be one per 64 keys, too few to fill
// the card at recurrentgemma-2b's one KV head (64 blocks a sequence of
// 4096, the first half of them with twice the work of the mean under a
// causal window).  The wrapper picks hpb (``heads_per_block``) for about
// four waves of blocks; each block then writes its fp32 sums to scratch,
// and the last of a key tile's blocks to arrive (a counter a key tile,
// zeroed by the prep pass) adds the partials in split order and stores
// dK and dV: no atomics in the sums, and every call sums alike.
struct W256 {
  static constexpr int D = 256, SW = 128, ACOLS = 64, NSUB = 4, LAYOUT = 1;
  static constexpr int NA = ACOLS / 2;    // accumulator floats an atom
  static constexpr int OWN = NSUB / NWG;  // atoms a warpgroup accumulates
  // keys (dK/dV) or rows (dQ) a block, and the rows or keys of each tile of
  // its walk, through a ring of 2 stages
  static constexpr int ROWS = 64;
  static constexpr int STAGES = 2;
  static constexpr int TILE_BYTES = ROWS * D * 2;
  static constexpr int ST_BYTES = 2 * ST_ROWS * 4;  // L2 and Delta of a tile
  static constexpr int X_BYTES = 128 * ROWS / 2 * 4;  // a 64 x 64 fragment
  // float4s of one dK/dV block's fp32 partial (dK, then dV)
  static constexpr int PART_F4 = 2 * ROWS * D / 4;
  // 1024 bytes of slack to align the tiles, then the 2 * STAGES + 1
  // mbarriers
  static constexpr int DKDV_SMEM = 1024 + 2 * TILE_BYTES +
                                   STAGES * (2 * TILE_BYTES + ST_BYTES) +
                                   X_BYTES + 8 * (2 * STAGES + 1);
  static constexpr int DQ_SMEM = 1024 + 2 * TILE_BYTES +
                                 STAGES * 2 * TILE_BYTES + X_BYTES +
                                 8 * (2 * STAGES + 1);
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448,
                "a block opts into at most 227 KB");
};

// the exchange's named barriers: dP written, P / dS written
constexpr int BAR_DP = 1, BAR_DS = 2;

// 2. dK, dV: one block per (KV head, 64-key tile)
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const Args a, int heads_inner) {
  using W = W256;
  constexpr int SW = W::SW, NA = W::NA, OWN = W::OWN, ST = W::STAGES;
  constexpr int KB = W::ROWS, QT = W::ROWS;
  extern __shared__ uint8_t smem[];
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t s_k = (base + 1023u) & ~1023u;
  const uint32_t s_v = s_k + W::TILE_BYTES;
  const uint32_t s_ring = s_v + W::TILE_BYTES;  // stage s: Q, then dO
  const uint32_t s_st = s_ring + ST * 2 * W::TILE_BYTES;  // stage s: L2, Delta
  const uint32_t s_x = s_st + ST * W::ST_BYTES;
  const uint32_t s_bar = s_x + W::X_BYTES;
  // full[s] at s_bar + 8 s, empty[s] at s_bar + 8 (ST + s), K/V's last
  const uint32_t kv_bar = s_bar + 16 * ST;
  const float* stats = reinterpret_cast<const float*>(smem + (s_st - base));
  // one type for every access: the bf16 pairs travel as their bits
  float2* xch = reinterpret_cast<float2*>(smem + (s_x - base));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int r = tid % 128;  // this thread's slot in the exchange
  const int warp = r / 32;
  const int lane = tid % 32;
  const int n_kv = a.bh / a.kv_group;
  // block (key tile kt, KV head g, split sp), the longest walks first: its
  // heads are the group's sp-th hpb
  const int n_split = (a.kv_group + a.hpb - 1) / a.hpb;
  const int sp = static_cast<int>(blockIdx.x) % n_split;
  const int g = static_cast<int>(blockIdx.x) / n_split % n_kv;
  const int kt = static_cast<int>(blockIdx.x) / n_split / n_kv;
  const int k0 = kt * KB;
  const int h0 = g * a.kv_group + sp * a.hpb;
  const int nh = min(a.hpb, a.kv_group - sp * a.hpb);
  const int off = GENERAL ? a.q_offset : 0;
  // the query tiles that see a key of the block (as the D <= 128 kernel)
  const int qt0 = a.causal ? max(0, k0 - off) / QT : 0;
  const int q_end =
      GENERAL ? min(a.sq, k0 + KB - 1 + a.window - off) : a.sq;
  const int n_qt = max(0, (q_end + QT - 1) / QT - qt0);
  const int n_t = n_qt * nh;  // the block's heads, each over n_qt

  auto load_tile = [&](int t, int s) {
    const int bh = h0 + t / n_qt;
    const int q0 = (qt0 + t % n_qt) * QT;
    const uint32_t full = s_bar + 8 * s;
    const uint32_t q_dst = s_ring + s * 2 * W::TILE_BYTES;
    hopper::mbar_expect_tx(full, 2 * W::TILE_BYTES + W::ST_BYTES);
#pragma unroll
    for (int c = 0; c < W::NSUB; ++c) {
      hopper::load_box(q_dst + c * QT * SW, &tm_q, c * W::ACOLS, q0, bh,
                       heads_inner & 1, full);
      hopper::load_box(q_dst + W::TILE_BYTES + c * QT * SW, &tm_do,
                       c * W::ACOLS, q0, bh, heads_inner & 8, full);
    }
    hopper::bulk_load(
        s_st + s * W::ST_BYTES,
        a.stats + (static_cast<long long>(bh) * a.n_st + q0 / ST_ROWS) * 2 *
                      ST_ROWS,
        W::ST_BYTES, full);
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(s_bar + 8 * s, 1);
      hopper::mbar_init(s_bar + 8 * (ST + s), 4 * NWG);
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_bar, 2 * W::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < W::NSUB; ++c) {
      hopper::load_box(s_k + c * KB * SW, &tm_k, c * W::ACOLS, k0, g,
                       heads_inner & 2, kv_bar);
      hopper::load_box(s_v + c * KB * SW, &tm_v, c * W::ACOLS, k0, g,
                       heads_inner & 4, kv_bar);
    }
    for (int t = 0; t < ST && t < n_t; ++t) load_tile(t, t);
  }

  // this thread's keys kr0 (fragment entries 4i, 4i+1) and kr0 + 8 (4i+2,
  // 4i+3), at queries 8i + 2 (lane % 4) + {0, 1}, in both warpgroups
  const int kr0 = k0 + 16 * warp + lane / 4;
  const float c2 = a.scale * LOG2E;
  // the score product's A operand: K (S^T = K Q^T) or V (dP^T = V dO^T)
  const uint32_t s_a = wg ? s_v : s_k;
  float dk_acc[OWN][NA], dv_acc[OWN][NA];
#pragma unroll
  for (int c = 0; c < OWN; ++c)
#pragma unroll
    for (int i = 0; i < NA; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  hopper::mbar_wait(kv_bar, 0);
  for (int t = 0; t < n_t; ++t) {
    const int s = t % ST;
    const int q0 = (qt0 + t % n_qt) * QT;
    const uint32_t q_tile = s_ring + s * 2 * W::TILE_BYTES;
    const uint32_t do_tile = q_tile + W::TILE_BYTES;
    hopper::mbar_wait(s_bar + 8 * s, (t / ST) & 1);

    // S^T (warpgroup 0) or dP^T (1): 16 k-steps over the 256 columns
    float acc[QT / 2];
    const uint32_t s_b = wg ? do_tile : q_tile;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W::D / 16; ++kk) {
      const int atom = kk * 32 / SW, koff = kk * 32 % SW;
      hopper::WgmmaSS<QT>::run(
          acc, hopper::smem_desc(s_a + atom * KB * SW + koff, 16, 8 * SW,
                                 W::LAYOUT),
          hopper::smem_desc(s_b + atom * QT * SW + koff, 16, 8 * SW,
                            W::LAYOUT),
          kk > 0);
    }
    hopper::wgmma_commit();
    // refill the stage tile t-1 used while this tile's products run
    if (tid == 0 && t >= 1 && t - 1 + ST < n_t) {
      const int sp = (t - 1) % ST;
      hopper::mbar_wait(s_bar + 8 * (ST + sp), ((t - 1) / ST) & 1);
      load_tile(t - 1 + ST, sp);
    }
    __syncwarp();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // P^T and dS^T as bf16 A fragments, formed in warpgroup 0
    uint32_t pa[QT / 4], dsa[QT / 4];
    if (wg) {
#pragma unroll
      for (int m = 0; m < QT / 4; ++m)
        xch[m * 128 + r] = make_float2(acc[2 * m], acc[2 * m + 1]);
      hopper::bar_arrive(BAR_DP, THREADS);
      hopper::bar_sync(BAR_DS, THREADS);
#pragma unroll
      for (int m = 0; m < QT / 4; ++m) {
        const float2 u = xch[m * 128 + r];
        pa[m] = __float_as_uint(u.x);
        dsa[m] = __float_as_uint(u.y);
      }
    } else {
      const float* ls = stats + s * 2 * ST_ROWS;  // L2 of the tile's rows
      const float* dl = ls + ST_ROWS;             // their Delta
      const bool edge = !(q0 + QT <= a.sq && k0 + KB <= a.skv &&
                          (!a.causal || q0 + off >= k0 + KB - 1) &&
                          (!GENERAL || q0 + QT - 1 + off - k0 < a.window));
      hopper::bar_sync(BAR_DP, THREADS);
#pragma unroll
      for (int i = 0; i < QT / 2; i += 2) {
        const int col = 8 * (i / 4) + 2 * (lane % 4);
        const int key = kr0 + 8 * ((i / 2) & 1);
        const float2 dp = xch[i / 2 * 128 + r];
        const float dpe[2] = {dp.x, dp.y};
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float dcap;
          float x = prob<GENERAL>(a, acc[i + e], c2, ls[col + e], dcap);
          if (edge && !attends<GENERAL>(a, q0 + col + e, key)) x = 0.f;
          p[e] = x;
          ds[e] = x * (dpe[e] - dl[col + e]);
          if (GENERAL) ds[e] *= dcap;
        }
        pa[i / 2] = hopper::pack_bf16x2(p[0], p[1]);
        dsa[i / 2] = hopper::pack_bf16x2(ds[0], ds[1]);
        xch[i / 2 * 128 + r] = make_float2(__uint_as_float(pa[i / 2]),
                                           __uint_as_float(dsa[i / 2]));
      }
      hopper::bar_arrive(BAR_DS, THREADS);
    }

    // dV += P^T dO, dK += dS^T Q on this warpgroup's two atoms: QT / 16
    // k-steps of 16 rows, dO and Q MN-major
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t ap[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                              pa[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < OWN; ++c)
        hopper::WgmmaRS<W::ACOLS>::run(
            dv_acc[c], ap,
            hopper::smem_desc(do_tile + (wg * OWN + c) * QT * SW +
                                  kk * 16 * SW,
                              8 * SW, 8 * SW, W::LAYOUT));
    }
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t as[4] = {dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2],
                              dsa[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < OWN; ++c)
        hopper::WgmmaRS<W::ACOLS>::run(
            dk_acc[c], as,
            hopper::smem_desc(q_tile + (wg * OWN + c) * QT * SW +
                                  kk * 16 * SW,
                              8 * SW, 8 * SW, W::LAYOUT));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < OWN; ++c) {
      hopper::fence_regs(dk_acc[c]);
      hopper::fence_regs(dv_acc[c]);
    }
    hopper::fence_regs(pa);
    hopper::fence_regs(dsa);
    if (lane == 0) hopper::mbar_arrive(s_bar + 8 * (ST + s));
  }

  if (n_split > 1) {
    // this block's fp32 sums over its heads to the partials (float4 j of
    // thread tid at j * THREADS + tid), then the key tile's last block
    // to arrive adds them up in split order, so every call sums alike
    const int tile = g * ((a.skv + KB - 1) / KB) + kt;
    float4* part = reinterpret_cast<float4*>(a.part) +
                   static_cast<size_t>(tile) * n_split * W::PART_F4;
    float4* mine = part + static_cast<size_t>(sp) * W::PART_F4;
#pragma unroll
    for (int c = 0; c < OWN; ++c)
#pragma unroll
      for (int i = 0; i < NA; i += 4) {
        const int j = (c * NA + i) / 4;
        mine[j * THREADS + tid] =
            make_float4(dk_acc[c][i], dk_acc[c][i + 1], dk_acc[c][i + 2],
                        dk_acc[c][i + 3]);
        mine[(j + OWN * NA / 4) * THREADS + tid] =
            make_float4(dv_acc[c][i], dv_acc[c][i + 1], dv_acc[c][i + 2],
                        dv_acc[c][i + 3]);
      }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (tid == 0) last = atomicAdd(a.counters + tile, 1) == n_split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int c = 0; c < OWN; ++c)
#pragma unroll
      for (int i = 0; i < NA; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
    for (int q = 0; q < n_split; ++q) {
      const float4* src = part + static_cast<size_t>(q) * W::PART_F4;
#pragma unroll
      for (int c = 0; c < OWN; ++c)
#pragma unroll
        for (int i = 0; i < NA; i += 4) {
          const int j = (c * NA + i) / 4;
          const float4 x = __ldcg(src + j * THREADS + tid);
          const float4 y = __ldcg(src + (j + OWN * NA / 4) * THREADS + tid);
          dk_acc[c][i] += x.x;
          dk_acc[c][i + 1] += x.y;
          dk_acc[c][i + 2] += x.z;
          dk_acc[c][i + 3] += x.w;
          dv_acc[c][i] += y.x;
          dv_acc[c][i + 1] += y.y;
          dv_acc[c][i + 2] += y.z;
          dv_acc[c][i + 3] += y.w;
        }
    }
  }

  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(a.dv);
  const size_t row0 = (static_cast<size_t>(g) * a.skv + kr0) * W::D;
#pragma unroll
  for (int c = 0; c < OWN; ++c)
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      const int col = (wg * OWN + c) * W::ACOLS + 2 * i + 2 * (lane % 4);
      if (kr0 < a.skv) {
        *reinterpret_cast<uint32_t*>(dk + row0 + col) = hopper::pack_bf16x2(
            dk_acc[c][i] * a.scale, dk_acc[c][i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dv + row0 + col) =
            hopper::pack_bf16x2(dv_acc[c][i], dv_acc[c][i + 1]);
      }
      if (kr0 + 8 < a.skv) {
        *reinterpret_cast<uint32_t*>(dk + row0 + 8 * W::D + col) =
            hopper::pack_bf16x2(dk_acc[c][i + 2] * a.scale,
                                dk_acc[c][i + 3] * a.scale);
        *reinterpret_cast<uint32_t*>(dv + row0 + 8 * W::D + col) =
            hopper::pack_bf16x2(dv_acc[c][i + 2], dv_acc[c][i + 3]);
      }
    }
}

// 3. dQ: one block per (64-row query tile, bh)
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Args a,
                       int heads_inner) {
  using W = W256;
  constexpr int SW = W::SW, NA = W::NA, OWN = W::OWN, ST = W::STAGES;
  constexpr int QB = W::ROWS, BKV = W::ROWS;
  extern __shared__ uint8_t smem[];
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t s_q = (base + 1023u) & ~1023u;
  const uint32_t s_do = s_q + W::TILE_BYTES;
  const uint32_t s_ring = s_do + W::TILE_BYTES;  // stage s: K, then V
  const uint32_t s_x = s_ring + ST * 2 * W::TILE_BYTES;
  const uint32_t s_bar = s_x + W::X_BYTES;
  // full[s] at s_bar + 8 s, empty[s] at s_bar + 8 (ST + s), Q/dO's last
  const uint32_t q_bar = s_bar + 16 * ST;
  // one type for every access: the bf16 pairs travel as their bits
  float2* xch = reinterpret_cast<float2*>(smem + (s_x - base));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int r = tid % 128;  // this thread's slot in the exchange
  const int warp = r / 32;
  const int lane = tid % 32;
  const int n_qt = (a.sq + QB - 1) / QB;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / a.bh) * QB;
  const int bh = blockIdx.x % a.bh;
  const int g = bh / a.kv_group;
  const int off = GENERAL ? a.q_offset : 0;
  const int kv_end = a.causal ? min(a.skv, q0 + off + QB) : a.skv;
  // first tile: the one holding key q0 + off - window + 1
  const int j0 = GENERAL ? max(0, q0 + off - a.window + 1) / BKV : 0;
  const int n_kv = max(0, (kv_end + BKV - 1) / BKV - j0);  // tiles walked

  auto load_kv = [&](int j, int s) {
    const uint32_t full = s_bar + 8 * s;
    const uint32_t k_dst = s_ring + s * 2 * W::TILE_BYTES;
    hopper::mbar_expect_tx(full, 2 * W::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < W::NSUB; ++c) {
      hopper::load_box(k_dst + c * BKV * SW, &tm_k, c * W::ACOLS, j * BKV, g,
                       heads_inner & 2, full);
      hopper::load_box(k_dst + W::TILE_BYTES + c * BKV * SW, &tm_v,
                       c * W::ACOLS, j * BKV, g, heads_inner & 4, full);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(s_bar + 8 * s, 1);
      hopper::mbar_init(s_bar + 8 * (ST + s), 4 * NWG);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_bar, 2 * W::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < W::NSUB; ++c) {
      hopper::load_box(s_q + c * QB * SW, &tm_q, c * W::ACOLS, q0, bh,
                       heads_inner & 1, q_bar);
      hopper::load_box(s_do + c * QB * SW, &tm_do, c * W::ACOLS, q0, bh,
                       heads_inner & 8, q_bar);
    }
    for (int t = 0; t < ST && t < n_kv; ++t) load_kv(j0 + t, t);
  }

  // this thread's rows r0 (fragment entries 4i, 4i+1) and r0 + 8 (4i+2,
  // 4i+3), at keys 8i + 2 (lane % 4) + {0, 1}, in both warpgroups
  const int r0 = q0 + 16 * warp + lane / 4;
  const float l0 = r0 < a.sq ? stat(a, bh, r0, 0) : 0.f;
  const float l1 = r0 + 8 < a.sq ? stat(a, bh, r0 + 8, 0) : 0.f;
  const float dl0 = r0 < a.sq ? stat(a, bh, r0, 1) : 0.f;
  const float dl1 = r0 + 8 < a.sq ? stat(a, bh, r0 + 8, 1) : 0.f;
  const float c2 = a.scale * LOG2E;
  // the score product's A operand: Q (S = Q K^T) or dO (dP = dO V^T)
  const uint32_t s_a = wg ? s_do : s_q;
  float dq_acc[OWN][NA];
#pragma unroll
  for (int c = 0; c < OWN; ++c)
#pragma unroll
    for (int i = 0; i < NA; ++i) dq_acc[c][i] = 0.f;

  hopper::mbar_wait(q_bar, 0);
  for (int t = 0; t < n_kv; ++t) {  // t-th tile walked: key tile j0 + t
    const int k0 = (j0 + t) * BKV;
    const int s = t % ST;
    const uint32_t k_tile = s_ring + s * 2 * W::TILE_BYTES;
    const uint32_t v_tile = k_tile + W::TILE_BYTES;
    hopper::mbar_wait(s_bar + 8 * s, (t / ST) & 1);

    // S (warpgroup 0) or dP (1): 16 k-steps over the 256 columns
    float acc[BKV / 2];
    const uint32_t s_b = wg ? v_tile : k_tile;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W::D / 16; ++kk) {
      const int atom = kk * 32 / SW, koff = kk * 32 % SW;
      hopper::WgmmaSS<BKV>::run(
          acc, hopper::smem_desc(s_a + atom * QB * SW + koff, 16, 8 * SW,
                                 W::LAYOUT),
          hopper::smem_desc(s_b + atom * BKV * SW + koff, 16, 8 * SW,
                            W::LAYOUT),
          kk > 0);
    }
    hopper::wgmma_commit();
    if (tid == 0 && t >= 1 && t - 1 + ST < n_kv) {
      const int sp = (t - 1) % ST;
      hopper::mbar_wait(s_bar + 8 * (ST + sp), ((t - 1) / ST) & 1);
      load_kv(j0 + t - 1 + ST, sp);
    }
    __syncwarp();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // dS as bf16 A fragments, formed in warpgroup 0
    uint32_t dsa[BKV / 4];
    if (wg) {
#pragma unroll
      for (int m = 0; m < BKV / 4; ++m)
        xch[m * 128 + r] = make_float2(acc[2 * m], acc[2 * m + 1]);
      hopper::bar_arrive(BAR_DP, THREADS);
      hopper::bar_sync(BAR_DS, THREADS);
#pragma unroll
      for (int m = 0; m < BKV / 4; ++m)
        dsa[m] = __float_as_uint(xch[m * 128 + r].x);
    } else {
      const bool edge = !(q0 + QB <= a.sq && k0 + BKV <= a.skv &&
                          (!a.causal || q0 + off >= k0 + BKV - 1) &&
                          (!GENERAL || q0 + off + QB - 1 - k0 < a.window));
      hopper::bar_sync(BAR_DP, THREADS);
#pragma unroll
      for (int i = 0; i < BKV / 2; i += 2) {
        const bool hi = (i / 2) & 1;
        const int row = hi ? r0 + 8 : r0;
        const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4);
        const float2 dp = xch[i / 2 * 128 + r];
        const float dpe[2] = {dp.x, dp.y};
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float dcap;
          const float p =
              prob<GENERAL>(a, acc[i + e], c2, hi ? l1 : l0, dcap);
          ds[e] = p * (dpe[e] - (hi ? dl1 : dl0));
          if (GENERAL) ds[e] *= dcap;
          if (edge && !attends<GENERAL>(a, row, kpos + e)) ds[e] = 0.f;
        }
        dsa[i / 2] = hopper::pack_bf16x2(ds[0], ds[1]);
        xch[i / 2 * 128 + r].x = __uint_as_float(dsa[i / 2]);
      }
      hopper::bar_arrive(BAR_DS, THREADS);
    }

    // dQ += dS K on this warpgroup's two atoms: BKV / 16 k-steps of 16
    // keys, K MN-major
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t as[4] = {dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2],
                              dsa[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < OWN; ++c)
        hopper::WgmmaRS<W::ACOLS>::run(
            dq_acc[c], as,
            hopper::smem_desc(k_tile + (wg * OWN + c) * BKV * SW +
                                  kk * 16 * SW,
                              8 * SW, 8 * SW, W::LAYOUT));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < OWN; ++c) hopper::fence_regs(dq_acc[c]);
    hopper::fence_regs(dsa);
    if (lane == 0) hopper::mbar_arrive(s_bar + 8 * (ST + s));
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq) +
                      (static_cast<size_t>(bh) * a.sq + r0) * W::D;
#pragma unroll
  for (int c = 0; c < OWN; ++c)
#pragma unroll
    for (int i = 0; i < NA; i += 4) {
      const int col = (wg * OWN + c) * W::ACOLS + 2 * i + 2 * (lane % 4);
      if (r0 < a.sq)
        *reinterpret_cast<uint32_t*>(dq + col) = hopper::pack_bf16x2(
            dq_acc[c][i] * a.scale, dq_acc[c][i + 1] * a.scale);
      if (r0 + 8 < a.sq)
        *reinterpret_cast<uint32_t*>(dq + 8 * W::D + col) =
            hopper::pack_bf16x2(dq_acc[c][i + 2] * a.scale,
                                dq_acc[c][i + 3] * a.scale);
    }
}

template <bool GENERAL>
int launch_wgmma256(const Args& a, cudaStream_t stream) {
  using W = W256;
  cudaError_t err;
  if ((err = hopper::allow_smem<bwd_dkdv_wgmma256_kernel<GENERAL>>(
           W::DKDV_SMEM)) != cudaSuccess ||
      (err = hopper::allow_smem<bwd_dq_wgmma256_kernel<GENERAL>>(
           W::DQ_SMEM)) != cudaSuccess)
    return static_cast<int>(err);
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return hopper::ERR_NO_ENCODER;
  const CUtensorMapSwizzle sw = hopper::swizzle_of(W::SW);
  const int n_kv = a.bh / a.kv_group;
  // every box of both passes is 64 rows by one 64-column atom
  CUtensorMap q, dout, k, v;
  bool in_q, in_k, in_v, in_do;
  if (!hopper::encode(fn, &q, a.q, a.bh, a.sq, W::D, a.q_sb, a.q_ss,
                      W::ROWS, W::ACOLS, sw, &in_q) ||
      !hopper::encode(fn, &dout, a.dout, a.bh, a.sq, W::D, a.do_sb, a.do_ss,
                      W::ROWS, W::ACOLS, sw, &in_do) ||
      !hopper::encode(fn, &k, a.k, n_kv, a.skv, W::D, a.k_sb, a.k_ss,
                      W::ROWS, W::ACOLS, sw, &in_k) ||
      !hopper::encode(fn, &v, a.v, n_kv, a.skv, W::D, a.v_sb, a.v_ss,
                      W::ROWS, W::ACOLS, sw, &in_v))
    return hopper::ERR_ENCODE;
  const int heads_inner = in_q | in_k << 1 | in_v << 2 | in_do << 3;
  bwd_prep_kernel<W::D, __nv_bfloat16>
      <<<dim3(a.n_st, a.bh), THREADS, 0, stream>>>(a);
  const int n_split = (a.kv_group + a.hpb - 1) / a.hpb;
  bwd_dkdv_wgmma256_kernel<GENERAL>
      <<<(a.skv + W::ROWS - 1) / W::ROWS * n_kv * n_split, THREADS,
         W::DKDV_SMEM, stream>>>(q, dout, k, v, a, heads_inner);
  bwd_dq_wgmma256_kernel<GENERAL>
      <<<(a.sq + W::ROWS - 1) / W::ROWS * a.bh, THREADS, W::DQ_SMEM,
         stream>>>(q, dout, k, v, a, heads_inner);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

// query rows a tile (BQ) and keys a tile (BKV): 64, 32 at D = 256 so that
// the dK/dV pass's four staged fp32 tiles fit shared memory
template <int D> struct Cfg {
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int BKV = BQ;
  static constexpr int TI = BQ / 16;   // score rows a thread
  static constexpr int TJ = BKV / 16;  // score columns a thread
  static constexpr int TD = D / 16;    // accumulator columns a thread
  static constexpr int P = D + 1;      // padded row of a staged tile
  static constexpr int SP = BKV + 1;   // padded row of a score tile
  static constexpr size_t DKDV = (2 * BQ + 2 * BKV) * P + 2 * BQ * SP + 2 * BQ;
  static constexpr size_t DQ = (2 * BQ + 2 * BKV) * P + BQ * SP + 2 * BQ;
  static_assert(DKDV * sizeof(float) <= 227 * 1024, "smem per block");
};

// dst [rows][D + 1] <- rows row0.. of src (row stride ss), zeros past len
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ss, int row0, int rows,
                                      int len) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int g = row0 + r;
    dst[r * (D + 1) + d] = g < len ? src[g * ss + d] : 0.f;
  }
}

// the key tiles a query tile at row q0 walks: [begin, end)
template <int D, bool GENERAL>
__device__ __forceinline__ void key_range(const Args& a, int q0, int& begin,
                                          int& end) {
  constexpr int BQ = Cfg<D>::BQ, BKV = Cfg<D>::BKV;
  const int p0 = q0 + (GENERAL ? a.q_offset : 0);  // its position
  end = a.causal ? min(a.skv, p0 + BQ) : a.skv;
  begin = GENERAL ? max(0, p0 - a.window + 1) / BKV * BKV : 0;
}

// s += A B^T and dp += C E^T over D for a thread's score block: rows
// ty + 16 i of the [BQ][P] tiles A and C, rows tx + 16 j of the [BKV][P]
// tiles B and E
template <int D>
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
    float av[K::TI], b[K::TJ], c[K::TI], e[K::TJ];
#pragma unroll
    for (int i = 0; i < K::TI; ++i) {
      av[i] = A[(ty + 16 * i) * K::P + d];
      c[i] = C[(ty + 16 * i) * K::P + d];
    }
#pragma unroll
    for (int j = 0; j < K::TJ; ++j) {
      b[j] = B[(tx + 16 * j) * K::P + d];
      e[j] = E[(tx + 16 * j) * K::P + d];
    }
#pragma unroll
    for (int i = 0; i < K::TI; ++i)
#pragma unroll
      for (int j = 0; j < K::TJ; ++j) {
        s[i][j] = fmaf(av[i], b[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

// rows q0.. of head bh: their L2 and Delta into shared memory
__device__ __forceinline__ void stage_stats(const Args& a, int bh, int q0,
                                            int rows, float* l_s,
                                            float* dl_s) {
  const int tid = threadIdx.x;
  if (tid < rows) {
    const bool in = q0 + tid < a.sq;
    l_s[tid] = in ? stat(a, bh, q0 + tid, 0) : 0.f;
    dl_s[tid] = in ? stat(a, bh, q0 + tid, 1) : 0.f;
  }
}

// 2. dK, dV: one block per (KV head, key tile)
template <int D, bool GENERAL>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(Args a) {
  using K = Cfg<D>;
  constexpr int BQ = K::BQ, BKV = K::BKV, TK = BKV / 16;
  extern __shared__ float fsmem[];
  float* ks = fsmem;              // [BKV][P]
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
  const float c2 = a.scale * LOG2E;
  stage<D>(ks, static_cast<const float*>(a.k) + g * a.k_sb, a.k_ss, k0, BKV,
           a.skv);
  stage<D>(vs, static_cast<const float*>(a.v) + g * a.v_sb, a.v_ss, k0, BKV,
           a.skv);

  float dk[TK][K::TD], dv[TK][K::TD];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < K::TD; ++j) dk[i][j] = dv[i][j] = 0.f;

  // rows before position k0 see none of the tile's keys under a causal
  // mask, rows from its last key + W on none under a window (row =
  // position - q_offset)
  const int off = GENERAL ? a.q_offset : 0;
  const int q_begin = a.causal ? max(0, k0 - off) / BQ * BQ : 0;
  const int q_end =
      GENERAL ? min(a.sq, k0 + BKV - 1 + a.window - off) : a.sq;
  for (int rr = 0; rr < a.kv_group; ++rr) {
    const int bh = g * a.kv_group + rr;
    const float* qb = static_cast<const float*>(a.q) + bh * a.q_sb;
    const float* db = static_cast<const float*>(a.dout) + bh * a.do_sb;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // K/V staged; the last tile's qs, dos, ps, dss read
      stage<D>(qs, qb, a.q_ss, q0, BQ, a.sq);
      stage<D>(dos, db, a.do_ss, q0, BQ, a.sq);
      stage_stats(a, bh, q0, BQ, lse_s, dl_s);
      __syncthreads();
      float s[K::TI][K::TJ], dp[K::TI][K::TJ];
      scores<D>(qs, ks, dos, vs, s, dp);
#pragma unroll
      for (int i = 0; i < K::TI; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < K::TJ; ++j) {
          const int col = tx + 16 * j;
          float dcap = 1.f;
          const float p =
              attends<GENERAL>(a, q0 + row, k0 + col)
                  ? prob<GENERAL>(a, s[i][j], c2, lse_s[row], dcap)
                  : 0.f;
          ps[row * K::SP + col] = p;
          float ds = p * (dp[i][j] - dl_s[row]);
          if (GENERAL) ds *= dcap;
          dss[row * K::SP + col] = ds;
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
  float* dkb = static_cast<float*>(a.dk) + (long long)g * a.skv * D;
  float* dvb = static_cast<float*>(a.dv) + (long long)g * a.skv * D;
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.skv) continue;
#pragma unroll
    for (int j = 0; j < K::TD; ++j) {
      dkb[(long long)key * D + tx + 16 * j] = dk[i][j] * a.scale;
      dvb[(long long)key * D + tx + 16 * j] = dv[i][j];
    }
  }
}

// 3. dQ: one block per (query tile, bh)
template <int D, bool GENERAL>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(Args a) {
  using K = Cfg<D>;
  constexpr int BQ = K::BQ, BKV = K::BKV;
  extern __shared__ float fsmem[];
  float* qs = fsmem;              // [BQ][P]
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
  const float c2 = a.scale * LOG2E;
  stage<D>(qs, static_cast<const float*>(a.q) + bh * a.q_sb, a.q_ss, q0, BQ,
           a.sq);
  stage<D>(dos, static_cast<const float*>(a.dout) + bh * a.do_sb, a.do_ss, q0,
           BQ, a.sq);
  stage_stats(a, bh, q0, BQ, lse_s, dl_s);
  const float* kb = static_cast<const float*>(a.k) + g * a.k_sb;
  const float* vb = static_cast<const float*>(a.v) + g * a.v_sb;

  float dq[K::TI][K::TD];
#pragma unroll
  for (int i = 0; i < K::TI; ++i)
#pragma unroll
    for (int j = 0; j < K::TD; ++j) dq[i][j] = 0.f;

  int kv_begin, kv_end;
  key_range<D, GENERAL>(a, q0, kv_begin, kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // Q, dO staged; the last tile's ks and dss read
    stage<D>(ks, kb, a.k_ss, k0, BKV, a.skv);
    stage<D>(vs, vb, a.v_ss, k0, BKV, a.skv);
    __syncthreads();
    float s[K::TI][K::TJ], dp[K::TI][K::TJ];
    scores<D>(qs, ks, dos, vs, s, dp);
#pragma unroll
    for (int i = 0; i < K::TI; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < K::TJ; ++j) {
        const int col = tx + 16 * j;
        float dcap = 1.f;
        const float p =
            attends<GENERAL>(a, q0 + row, k0 + col)
                ? prob<GENERAL>(a, s[i][j], c2, lse_s[row], dcap)
                : 0.f;
        float ds = p * (dp[i][j] - dl_s[row]);
        if (GENERAL) ds *= dcap;
        dss[row * K::SP + col] = ds;
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
  float* dqb = static_cast<float*>(a.dq) + (long long)bh * a.sq * D;
#pragma unroll
  for (int i = 0; i < K::TI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < K::TD; ++j)
      dqb[(long long)row * D + tx + 16 * j] = dq[i][j] * a.scale;
  }
}

template <int D, bool GENERAL>
int launch_cuda_cores(const Args& a, cudaStream_t stream) {
  using K = Cfg<D>;
  cudaError_t err;
  if ((err = hopper::allow_smem<bwd_dkdv_kernel<D, GENERAL>>(
           K::DKDV * sizeof(float))) != cudaSuccess ||
      (err = hopper::allow_smem<bwd_dq_kernel<D, GENERAL>>(
           K::DQ * sizeof(float))) != cudaSuccess)
    return static_cast<int>(err);
  const int q_tiles = (a.sq + K::BQ - 1) / K::BQ;
  const int k_tiles = (a.skv + K::BKV - 1) / K::BKV;
  bwd_prep_kernel<D, float><<<dim3(a.n_st, a.bh), THREADS, 0, stream>>>(a);
  bwd_dkdv_kernel<D, GENERAL>
      <<<dim3(k_tiles, a.bh / a.kv_group), THREADS, K::DKDV * sizeof(float),
         stream>>>(a);
  bwd_dq_kernel<D, GENERAL><<<dim3(q_tiles, a.bh), THREADS,
                                K::DQ * sizeof(float), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*Launch)(const Args&, cudaStream_t);

template <int DT, int DV> Launch pick_wgmma(bool general) {
  return general ? launch_wgmma<DT, DV, true> : launch_wgmma<DT, DV, false>;
}

template <int D> Launch pick_cuda_cores(bool general) {
  return general ? launch_cuda_cores<D, true> : launch_cuda_cores<D, false>;
}

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); w: the
// general kernels (a window, query offset or soft cap)
Launch pick_launch(int d, bool w, int dtype) {
  if (dtype == 1) {
    switch (d) {
      case 16: return pick_wgmma<16, 16>(w);
      case 32: return pick_wgmma<32, 32>(w);
      case 64: return pick_wgmma<64, 64>(w);
      case 80: return pick_wgmma<128, 80>(w);  // the D = 128 tile, padded
      case 128: return pick_wgmma<128, 128>(w);
      case 256: return w ? launch_wgmma256<true> : launch_wgmma256<false>;
      default: return nullptr;
    }
  }
  if (dtype != 0) return nullptr;
  switch (d) {
    case 16: return pick_cuda_cores<16>(w);
    case 32: return pick_cuda_cores<32>(w);
    case 64: return pick_cuda_cores<64>(w);
    case 80: return pick_cuda_cores<80>(w);
    case 128: return pick_cuda_cores<128>(w);
    case 256: return pick_cuda_cores<256>(w);
    default: return nullptr;
  }
}

// the plan entries of repro_flash_attention_bwd_plan
template <int DT> int wgmma_plan(int what) {
  using W = Wg<DT>;
  const int v[] = {1,           W::KB, W::QT,        W::DKDV_STAGES,
                   W::DKDV_SMEM, W::QB, W::BKV,       W::DQ_STAGES,
                   W::DQ_SMEM};
  return what >= 0 && what < 9 ? v[what] : -1;
}

int wgmma256_plan(int what) {
  using W = W256;
  const int v[] = {1,           W::ROWS, W::ROWS,   W::STAGES,
                   W::DKDV_SMEM, W::ROWS, W::ROWS,   W::STAGES,
                   W::DQ_SMEM};
  return what >= 0 && what < 9 ? v[what] : -1;
}

template <int D> int cuda_core_plan(int what) {
  using K = Cfg<D>;
  const int v[] = {0,     K::BKV, K::BQ, 0, static_cast<int>(K::DKDV * 4),
                   K::BQ, K::BKV, 0,     static_cast<int>(K::DQ * 4)};
  return what >= 0 && what < 9 ? v[what] : -1;
}

}  // namespace

// The launch plan at head dim d and dtype (0 = float32, 1 = bfloat16):
// what = 0 the route (1: tensor cores, 0: CUDA cores), 1 keys a dK/dV
// block, 2 query rows a tile of its walk, 3 stages of its Q/dO ring (0:
// staged by plain loads), 4 its shared-memory bytes, 5 query rows a dQ
// block, 6 keys a tile of its walk, 7 stages of its K/V ring, 8 its
// shared-memory bytes; -1 for what the kernels do not take.
// kernels/flash_attention_bwd.py ``plan`` is held to it when it loads.
extern "C" int repro_flash_attention_bwd_plan(int d, int dtype, int what) {
  if (dtype == 1) {
    switch (d) {
      case 16: return wgmma_plan<16>(what);
      case 32: return wgmma_plan<32>(what);
      case 64: return wgmma_plan<64>(what);
      case 80:  // the D = 128 tile
      case 128: return wgmma_plan<128>(what);
      case 256: return wgmma256_plan(what);
      default: return -1;
    }
  }
  if (dtype != 0) return -1;
  switch (d) {
    case 16: return cuda_core_plan<16>(what);
    case 32: return cuda_core_plan<32>(what);
    case 64: return cuda_core_plan<64>(what);
    case 80: return cuda_core_plan<80>(what);
    case 128: return cuda_core_plan<128>(what);
    case 256: return cuda_core_plan<256>(what);
    default: return -1;
  }
}

// q, o, dout [bh, sq, d] and k, v [bh / kv_group, skv, d], each with its
// own (head, row) strides and a contiguous last dim (bf16: 16-byte aligned
// bases and strides, which TMA needs); lse float32
// [bh, sq], the forward's L2; dq [bh, sq, d] and dk, dv [bh / kv_group,
// skv, d] contiguous, of the inputs' dtype (0 = float32, 1 = bfloat16);
// stats float32 [bh, n_st = ceil(sq / 64), 2, 64] scratch.  d in {16, 32,
// 64, 80, 128, 256}; window in [0, 2^30) (0: none), q_offset in [0, 2^30),
// softcap >= 0 (0: none), as the forward took them.  heads_per_block in
// [1, kv_group]: the query heads one dK/dV block walks on the bf16 D = 256
// route (kv_group everywhere else); below kv_group, with n_kt =
// ceil(skv / W256::ROWS) key tiles a KV head (the Python plan's
// dkdv_keys), part is float32 scratch of bh / kv_group * n_kt *
// ceil(kv_group / heads_per_block) * 2 * W256::ROWS * 256 floats and
// counters int32 scratch of bh / kv_group * n_kt (both unused otherwise,
// and may be null).  Three launches on ``stream`` (prep, dK/dV, dQ); returns the
// CUDA error of the launches (0 on success; negative: a tensor-map
// failure, see repro_cuda_error_string) and never synchronises.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* stats, float* part, int* counters, int bh, int sq, int skv, int d,
    int kv_group, int causal, int window, int q_offset, int heads_per_block,
    float scale, float softcap, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long o_sb, long long o_ss, long long do_sb,
    long long do_ss, int dtype, void* stream) {
  constexpr int NO_WINDOW = 1 << 30;  // as the forward's
  const bool general = window > 0 || q_offset > 0 || softcap > 0.f;
  const Launch launch = pick_launch(d, general, dtype);
  const bool split = d == 256 && dtype == 1 && heads_per_block < kv_group;
  if (launch == nullptr || window < 0 || window >= NO_WINDOW ||
      q_offset < 0 || q_offset >= NO_WINDOW || !(softcap >= 0.f) ||
      kv_group < 1 || bh % kv_group || heads_per_block < 1 ||
      heads_per_block > kv_group ||
      (split && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool capped = softcap > 0.f;
  Args a{q, k, v, o, dout, lse, dq, dk, dv, stats,
               bh, sq, skv, kv_group, causal,
               window > 0 ? window : NO_WINDOW, q_offset,
               (sq + ST_ROWS - 1) / ST_ROWS, scale,
               capped ? scale / softcap : 0.f,
               capped ? softcap * LOG2E : 0.f, capped,
               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss};
  a.hpb = split ? heads_per_block : kv_group;
  if (split) {
    a.part = part;
    a.counters = counters;
    a.n_counters = bh / kv_group * ((skv + W256::ROWS - 1) / W256::ROWS);
  }
  return launch(a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return hopper::error_string(
      err, "cuTensorMapEncodeTiled refused a q/k/v/dO tensor map (bases and "
           "strides must be 16-byte aligned)");
}
