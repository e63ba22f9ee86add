// RMSNorm for Hopper (sm_90a) over the rows of x (n, d):
//   h = (x * rsqrt(mean(x^2) + eps)).to(x.dtype) * g,
// rounded to promote_types(x.dtype, g.dtype), f32 statistics; x and g
// each bf16, f16 or f32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm.
//
// What bounds it on the H100: bytes.  A handful of FLOP an element
// against one read and one write, so every byte is touched once.
//
// Design.  A row is held in registers at its real width by 1 warp (d <
// 2048) or 4 warps (d >= 2048; the caller's choice, rmsnorm.py:
// norm_geometry): each lane holds packs of 8 elements (one 16-byte load
// for 16-bit types, two for f32), neighbouring lanes on neighbouring 16
// bytes, and no lane idles on a power-of-two pad beyond its last pack.
// The sum of squares reduces with shuffles (and across the row's warps
// in shared memory), then the row is scaled and written; g's loads go
// out with x's and hit L1/L2 after the first block.  Blocks of 4 warps,
// as many as rows need, so the block scheduler keeps every SM full.  On
// the H100, 4 warps a row matched the Triton kernel this replaced at the
// models' widths from 2048 on; one or two warps a row were slower there,
// and so were persistent blocks holding g in registers and prefetching
// their next row (PERF.md).  One launch per
// call, and a host wrapper with one ctypes call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "norm_pack.cuh"

namespace {

using namespace normpack;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

// One row on ``wpr`` warps (1, 2 or 4) of a 4-warp block: lane L of the
// row (L = 32 * the warp's place in the row + lane) holds packs L,
// L + 32*wpr, ...; the warps' sums of squares meet in shared memory.
template <typename TX, typename TG, int NP>
__global__ void __launch_bounds__(NTHREADS)
rmsnorm_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
               typename Out<TX, TG>::type* __restrict__ o, int n, int d,
               long long sx, long long so, int wpr, float eps) {
  __shared__ float part[NWARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (NWARPS / wpr) + warp / wpr;
  const int L = lane + 32 * (warp % wpr), step = 32 * wpr, nvec = d >> 3;
  const bool live = row < n;
  Pack<TX> p[NP];
  Pack<TG> gp[NP];
  float ss = 0.f;
  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int v = L + step * i;
      if (v < nvec) {
        load(p[i], x + row * sx + 8 * v);
        load(gp[i], g + 8 * v);
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (L + step * i < nvec) {
        float f[8];
        to_f32(p[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (wpr > 1) {                           // block-uniform
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < wpr; ++w) ss += part[warp - warp % wpr + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)d + eps);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int v = L + step * i;
    if (v < nvec) {
      float f[8], gf[8];
      to_f32(p[i], f);
      to_f32(gp[i], gf);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = round_to<TX>(f[j] * r) * gf[j];
      store(o + row * so + 8 * v, f);
    }
  }
}

template <typename TX, typename TG, int NP>
int launch(const void* x, const void* g, void* o, int n, int d, long long sx,
           long long so, int wpr, float eps, cudaStream_t stream) {
  const int rows = NWARPS / wpr;          // a block's rows
  rmsnorm_kernel<TX, TG, NP><<<(n + rows - 1) / rows, NTHREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g),
      static_cast<typename Out<TX, TG>::type*>(o), n, d, sx, so, wpr, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TG>
int dispatch_np(int np, const void* x, const void* g, void* o, int n, int d,
                long long sx, long long so, int wpr, float eps,
                cudaStream_t s) {
  switch (np) {
    case 1: return launch<TX, TG, 1>(x, g, o, n, d, sx, so, wpr, eps, s);
    case 2: return launch<TX, TG, 2>(x, g, o, n, d, sx, so, wpr, eps, s);
    case 3: return launch<TX, TG, 3>(x, g, o, n, d, sx, so, wpr, eps, s);
    case 4: return launch<TX, TG, 4>(x, g, o, n, d, sx, so, wpr, eps, s);
    case 8: return launch<TX, TG, 8>(x, g, o, n, d, sx, so, wpr, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TX>
int dispatch_g(int tg, int np, const void* x, const void* g, void* o, int n,
               int d, long long sx, long long so, int wpr, float eps,
               cudaStream_t s) {
  switch (tg) {
    case 0: return dispatch_np<TX, bf16>(np, x, g, o, n, d, sx, so, wpr, eps, s);
    case 1: return dispatch_np<TX, __half>(np, x, g, o, n, d, sx, so, wpr, eps, s);
    case 2: return dispatch_np<TX, float>(np, x, g, o, n, d, sx, so, wpr, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (n, d) with row stride sx, out (n, d) with row stride so (elements),
// g (d,) contiguous; dtype codes 0 bf16, 1 f16, 2 f32 (out: bf16 or f16
// when x and g share it, else f32).  d % 8 == 0, every row and g 16-byte
// aligned; a row on wpr warps (1, 2 or 4), each lane holding np packs of
// 8 (np in {1, 2, 3, 4, 8}), 256 * wpr * np >= d.  Returns
// cudaGetLastError() (0 on success).
int repro_rmsnorm_fwd(const void* x, const void* g, void* out, int n, int d,
                      long long sx, long long so, int tx, int tg, int wpr,
                      int np, float eps, void* stream) {
  if (n <= 0 || d <= 0 || d % 8 || (wpr != 1 && wpr != 2 && wpr != 4) ||
      256 * wpr * np < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tx) {
    case 0: return dispatch_g<bf16>(tg, np, x, g, out, n, d, sx, so, wpr, eps, s);
    case 1: return dispatch_g<__half>(tg, np, x, g, out, n, d, sx, so, wpr, eps, s);
    case 2: return dispatch_g<float>(tg, np, x, g, out, n, d, sx, so, wpr, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
