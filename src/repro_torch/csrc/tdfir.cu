// Causal per-filter FIR bank: y[f, n] = sum_k h[f, k] * x[f, n - k], with
// zero history before n = 0, fp32 throughout; and its complex form on planar
// re/im data, y_re = x_re*h_re - x_im*h_im, y_im = x_re*h_im + x_im*h_re, in
// one launch.
//
// Replaces: src/repro/kernels/tdfir.py, _tdfir_kernel / tdfir /
// tdfir_complex (the Pallas tdFIR kernel behind the tdFIR function block and
// the loop `pallas` impl).
//
// Bound on the H100: operations.  One real FIR at the paper's F=64, N=4096,
// K=128 is 2*64*4096*128 = 6.7e7 FLOP (about 1.0 us at the 67 TFLOP/s
// non-tensor fp32 peak; TF32 would break the reference's 3e-4 contract)
// against 2.1 MB of traffic (about 0.64 us at 3.35 TB/s); the complex form
// is four times the FLOPs over twice the bytes.
//
// Design (kernels/tdfir.py `plan` sizes the launch): one block per (N-tile,
// filter) of `threads` threads, each thread owning kR = 8 consecutive
// outputs in registers.  The block stages the taps (zero-padded to K', K
// rounded up to 4) and the tile's input window (tile + K' samples, zeros
// before n = 0 and past N) in shared memory once, with 16-byte cp.async where
// the rows are 16-byte aligned and 4-byte copies elsewhere.  The taps are
// walked in groups of 4: each group is one 16-byte broadcast load of h and
// one 16-byte load of x, because the thread keeps a 12-sample window of x in
// registers and slides it by 4 samples a group.  A warp then spends 5 shared
// wavefronts (4 for x, 1 for h) on 32 FMA instructions, where one thread per
// output spent 2 loads per FMA: the loop is FMA-bound, not bound by shared
// loads.  Lanes 8 floats apart would meet 2-way bank conflicts on those
// 16-byte loads; the window's slots are swizzled (bit 2 flipped in every
// odd 32-float block), which makes any 4-aligned start conflict-free.  The
// swizzle permutes the slots of each 8-float block, so a plane's window
// takes whole 8-float blocks: its last quad may land 4 slots past the
// window, never past the plane's stride.  Each
// output sums its taps in ascending order with fmaf from 0.f (a padded tap
// adds an exact 0), so the result is bitwise that of one thread per output;
// the complex form keeps four such sums (rr, ii, ri, ir) over one staging
// of both windows and both tap rows and writes rr - ii and ri + ir, bitwise
// what four real launches and the two fp32 combines give.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kR = 8;            // consecutive outputs a thread owns
constexpr int kMaxThreads = 128;
constexpr int kMaxSmem = 227 * 1024;   // an H100 block's opt-in shared memory

struct Planes {                  // [0] re (or the real signal), [1] im
  const float* x[2];
  const float* h[2];
  float* y[2];
};

// shared slot of window sample s: bit 2 flipped in odd 32-float blocks, so
// 8 lanes reading 16 bytes at s0 + 8 * lane hit 32 distinct banks for any
// 4-aligned s0 (a 4-aligned quad stays one contiguous, aligned quad, inside
// its own 8-float block)
__device__ __forceinline__ int swz(int s) { return s ^ ((s >> 3) & 4); }

// a plane's shared slots: the tile and K' samples of history, rounded up
// to whole 8-float blocks (the tile is a multiple of 256)
__host__ __device__ __forceinline__ int plane_stride(int tile, int kp) {
  return tile + ((kp + 7) & ~7);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool kComplex>
__global__ void __launch_bounds__(kMaxThreads)
    tdfir_kernel(Planes p, int n, int k, int kp, int vec) {
  constexpr int P = kComplex ? 2 : 1;    // planes staged
  constexpr int A = P * P;               // sums per output
  extern __shared__ __align__(16) float smem[];
  const int tile = blockDim.x * kR;
  const int win = tile + kp;
  const int stride = plane_stride(tile, kp);
  float* hs = smem;                      // P tap rows of kp, zero past k
  float* xs = smem + P * kp;             // P windows of `stride` slots
  const int f = blockIdx.y;
  const int n0 = blockIdx.x * tile;
  const int ws = n0 - kp;                // x index of window sample 0

#pragma unroll
  for (int c = 0; c < P; ++c) {
    const float* xf = p.x[c] + (size_t)f * n;
    float* xw = xs + c * stride;
    if (vec) {     // n % 4 == 0: a quad is wholly inside or outside [0, n)
      for (int q = 4 * threadIdx.x; q < win; q += 4 * blockDim.x) {
        const int src = ws + q;
        const bool in = src >= 0 && src < n;
        hopper::cp_async16(xw + swz(q), in ? xf + src : xf, in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < win; e += blockDim.x) {
        const int src = ws + e;
        const bool in = src >= 0 && src < n;
        hopper::cp_async4(xw + swz(e), in ? xf + src : xf, in ? 4 : 0);
      }
    }
    const float* hf = p.h[c] + (size_t)f * k;
    for (int t = threadIdx.x; t < kp; t += blockDim.x)
      hs[c * kp + t] = t < k ? hf[t] : 0.f;
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  // Group g (taps 4g..4g+3) with b = o - 4g: w holds x[b - 4 .. b + 7], so
  // output o + j at tap 4g + i reads x[b + j - i] = w[4 + j - i].  The
  // quad x[b - 4 ..] sits at window slot s = 8t + kp - 4 - 4g.
  const int o = n0 + kR * threadIdx.x;
  int s = kR * threadIdx.x + kp - 4;
  const int groups = kp / 4;
  float w[P][12];
  float h[P][4];
  float acc[A][kR];
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const float* xw = xs + c * stride;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 v = ld4(xw + swz(s + 4 * q));
      w[c][4 * q] = v.x, w[c][4 * q + 1] = v.y;
      w[c][4 * q + 2] = v.z, w[c][4 * q + 3] = v.w;
    }
    const float4 v = ld4(hs + c * kp);
    h[c][0] = v.x, h[c][1] = v.y, h[c][2] = v.z, h[c][3] = v.w;
  }
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[a][j] = 0.f;

  // one group's FMAs: output j takes taps 4g + 0..3 in ascending order
  auto fmas = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int e = 4 + j - i;
        if (kComplex) {        // rr = hr.xr, ii = hi.xi, ri = hi.xr, ir = hr.xi
          acc[0][j] = fmaf(h[0][i], w[0][e], acc[0][j]);
          acc[1][j] = fmaf(h[1][i], w[1][e], acc[1][j]);
          acc[2][j] = fmaf(h[1][i], w[0][e], acc[2][j]);
          acc[3][j] = fmaf(h[0][i], w[1][e], acc[3][j]);
        } else {
          acc[0][j] = fmaf(h[0][i], w[0][e], acc[0][j]);
        }
      }
    }
  };
  // Every group but the last loads the next group's quads ahead of its own
  // FMAs, then slides the window.  No branch in the body: a conditional
  // load there compiles the slide into selects, one per window register.
#pragma unroll 3                 // the window turns over every 3 groups
  for (int g = 1; g < groups; ++g) {
    s -= 4;
    float4 xn[P], hn[P];
#pragma unroll
    for (int c = 0; c < P; ++c) {
      xn[c] = ld4(xs + c * stride + swz(s));
      hn[c] = ld4(hs + c * kp + 4 * g);
    }
    fmas();
#pragma unroll
    for (int c = 0; c < P; ++c) {
#pragma unroll
      for (int e = 11; e >= 4; --e) w[c][e] = w[c][e - 4];
      w[c][0] = xn[c].x, w[c][1] = xn[c].y;
      w[c][2] = xn[c].z, w[c][3] = xn[c].w;
      h[c][0] = hn[c].x, h[c][1] = hn[c].y;
      h[c][2] = hn[c].z, h[c][3] = hn[c].w;
    }
  }
  fmas();

#pragma unroll
  for (int c = 0; c < P; ++c) {
    float r[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j)
      r[j] = !kComplex ? acc[0][j]
             : c == 0  ? acc[0][j] - acc[1][j]
                       : acc[2][j] + acc[3][j];
    float* yf = p.y[c] + (size_t)f * n;
    if (vec) {
#pragma unroll
      for (int q = 0; q < kR / 4; ++q)
        if (o + 4 * q < n)
          *reinterpret_cast<float4*>(yf + o + 4 * q) =
              make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < kR; ++j)
        if (o + j < n) yf[o + j] = r[j];
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <bool kComplex>
int launch(const Planes& p, int f, int n, int k, int threads, void* stream) {
  constexpr int P = kComplex ? 2 : 1;
  int vec = n % 4 == 0;
  for (int c = 0; c < P; ++c)
    vec = vec && aligned16(p.x[c]) && aligned16(p.y[c]);
  const int kp = (k + 3) & ~3;
  const int tile = threads * kR;
  const size_t smem =
      sizeof(float) * P * static_cast<size_t>(kp + plane_stride(tile, kp));
  if (smem > 48 * 1024) {        // past the default: opt in, once a device
    const cudaError_t err =
        hopper::allow_smem<tdfir_kernel<kComplex>>(kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + tile - 1) / tile, f);
  tdfir_kernel<kComplex><<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p, n, k, kp,
                                                                vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [f, n] float32; h: [f, k] float32; `threads` a multiple of 32, at
// most 128, each owning 8 outputs; shared memory 4 * (K' + 8 threads + K'
// rounded up to 8) bytes, at most 227 KB (the wrapper checks; past 48 KB the
// launch opts in).  Returns the CUDA error of the launch (0 on success); the
// kernel runs on `stream` and nothing here synchronises.
extern "C" int repro_tdfir(const void* x, const void* h, void* y, int f, int n,
                           int k, int threads, void* stream) {
  Planes p{};
  p.x[0] = static_cast<const float*>(x);
  p.h[0] = static_cast<const float*>(h);
  p.y[0] = static_cast<float*>(y);
  return launch<false>(p, f, n, k, threads, stream);
}

// The complex bank on planar re/im [f, n] / [f, k] float32 data, one launch;
// twice the real form's shared memory.
extern "C" int repro_tdfir_complex(const void* x_re, const void* x_im,
                                   const void* h_re, const void* h_im,
                                   void* y_re, void* y_im, int f, int n,
                                   int k, int threads, void* stream) {
  Planes p{};
  p.x[0] = static_cast<const float*>(x_re);
  p.x[1] = static_cast<const float*>(x_im);
  p.h[0] = static_cast<const float*>(h_re);
  p.h[1] = static_cast<const float*>(h_im);
  p.y[0] = static_cast<float*>(y_re);
  p.y[1] = static_cast<float*>(y_im);
  return launch<true>(p, f, n, k, threads, stream);
}

// the outputs a thread owns, for the wrapper's plan to check against
extern "C" int repro_tdfir_outputs_per_thread() { return kR; }

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
