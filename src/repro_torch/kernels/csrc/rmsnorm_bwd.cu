// RMSNorm and fused add + RMSNorm backward for Hopper (sm_90a), bf16 in
// and out, f32 row math.
//
// Replace the reference's VJPs of the two norms: the autodiff of
// RMSNormOp.kernel (src/repro/models/layers.py:159-173), which the JAX
// package trains every norm with, and _farn_bwd
// (src/repro/kernels/ops.py:41-80), the analytic VJP of its fused add +
// RMSNorm Pallas kernel.  Over rows of width d, r = rsqrt(mean(x^2) + eps):
//   rmsnorm_bwd            dx = r (dh g) - (r^3/d) x sum(dh g x), and
//                          dg = sum over rows of dh * bf16(x r), the
//                          rounding the forward applies before * g;
//   fused_add_rmsnorm_bwd  on the residual s (the forward's bf16 sum):
//                          ds = ds_out + r (dh g) - (r^3/d) s sum(dh g s),
//                          dg = sum over rows of dh s r (unrounded, as
//                          _farn_bwd has it); the wrapper hands ds out as
//                          the gradient of both x and y.
//
// What bounds them on the H100: bytes.  A row costs a few FLOPs an element
// against reading x (or s), dh (and ds_out) and writing dx (or ds), so a
// pass must read each byte once and keep the card's memory busy.
//
// Design.  A block of four warps, one row a warp at a time, the rows of a
// block strided over its warps; a lane owns 16-byte packs of 8 columns
// (lane, lane + 32, ...).  Two sweeps of a row: the first sums x^2 and
// dh g x (warp shuffles, no block barrier), the second reads the row
// again (from L1/L2) and writes dx and adds the lane's share of dg into
// its warp's f32 row of shared memory.  The column sum of dg is
// deterministic, without atomics: each block folds its four warp rows in
// order into one f32 partial row of a workspace, and a second launch sums
// the blocks' partial rows in order for each column.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_BLOCKS = 264;          // two blocks an SM on the H100

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// FUSED = false: rmsnorm_bwd (x, dh -> dx); true: fused_add_rmsnorm_bwd
// (s, dh, ds_out -> ds).  part: (gridDim.x, d) f32 partial rows of dg.
template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
norm_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const bf16* __restrict__ dh,
                     const bf16* __restrict__ ds_out, bf16* __restrict__ dx,
                     float* __restrict__ part, int n, int d, long long sx,
                     long long sdh, long long sds, long long sdx, float eps) {
  extern __shared__ __align__(16) float acc[];      // [WARPS][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int packs = d / 8;
  float* mine = acc + warp * d;
  for (int c = lane; c < d; c += 32) mine[c] = 0.f;
  const int per = (n + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per, r1 = min(n, r0 + per);
  const float inv_d = 1.f / d;
  for (int r = r0 + warp; r < r1; r += WARPS) {
    const bf16* xr = x + r * sx;
    const bf16* dhr = dh + r * sdh;
    float ss = 0.f, dot = 0.f;
    for (int p = lane; p < packs; p += 32) {
      float xv[8], hv[8], gv[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + 8 * p), xv);
      unpack8(*reinterpret_cast<const uint4*>(dhr + 8 * p), hv);
      unpack8(*reinterpret_cast<const uint4*>(g + 8 * p), gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ss = fmaf(xv[e], xv[e], ss);
        dot = fmaf(hv[e] * gv[e], xv[e], dot);
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float rr = rsqrtf(ss * inv_d + eps);
    const float k = rr * rr * rr * inv_d * dot;
    for (int p = lane; p < packs; p += 32) {
      float xv[8], hv[8], gv[8], out[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + 8 * p), xv);
      unpack8(*reinterpret_cast<const uint4*>(dhr + 8 * p), hv);
      unpack8(*reinterpret_cast<const uint4*>(g + 8 * p), gv);
      float base[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (FUSED)
        unpack8(*reinterpret_cast<const uint4*>(ds_out + r * sds + 8 * p),
                base);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[e] = base[e] + rr * (hv[e] * gv[e]) - k * xv[e];
        const float xr_e = FUSED ? xv[e] * rr
                                 : __bfloat162float(__float2bfloat16(xv[e] * rr));
        mine[8 * p + e] = fmaf(hv[e], xr_e, mine[8 * p + e]);
      }
      *reinterpret_cast<uint4*>(dx + r * sdx + 8 * p) = pack8(out);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += acc[w * d + c];
    part[(long long)blockIdx.x * d + c] = s;
  }
}

// dg[c] = sum over the blocks' partial rows, in block order
__global__ void __launch_bounds__(256)
norm_bwd_dg_kernel(const float* __restrict__ part, bf16* __restrict__ dg,
                   int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(long long)b * d + c];
  dg[c] = __float2bfloat16(s);
}

template <bool FUSED>
int launch(const void* x, const void* g, const void* dh, const void* ds_out,
           void* dx, void* dg, void* work, int n, int d, long long sx,
           long long sdh, long long sds, long long sdx, float eps,
           cudaStream_t stream) {
  if (n < 1 || d < 8 || d % 8 || d > 8192) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * d * sizeof(float);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_bwd_rows_kernel<FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, WARPS * 8192 * 4);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int blocks = min(MAX_BLOCKS, (n + WARPS - 1) / WARPS);
  float* part = static_cast<float*>(work);
  norm_bwd_rows_kernel<FUSED><<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(dh), static_cast<const bf16*>(ds_out),
      static_cast<bf16*>(dx), part, n, d, sx, sdh, sds, sdx, eps);
  norm_bwd_dg_kernel<<<(d + 255) / 256, 256, 0, stream>>>(
      part, static_cast<bf16*>(dg), blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the row pass for n rows: the workspace holds that many f32
// rows of width d.
int repro_norm_bwd_blocks(int n) {
  return min(MAX_BLOCKS, (n + WARPS - 1) / WARPS);
}

// x, dh, dx: (n, d) bf16 rows at the given row strides (elements; 16-byte
// aligned rows), g and dg: (d,) bf16, work: repro_norm_bwd_blocks(n) x d
// f32.  Returns cudaGetLastError() after the launches.
int repro_rmsnorm_bwd(const void* x, const void* g, const void* dh, void* dx,
                      void* dg, void* work, int n, int d, long long sx,
                      long long sdh, long long sdx, float eps, void* stream) {
  return launch<false>(x, g, dh, nullptr, dx, dg, work, n, d, sx, sdh, 0, sdx,
                       eps, static_cast<cudaStream_t>(stream));
}

// s (the forward's residual), dh, ds_out, ds: (n, d) bf16 rows; as above.
int repro_fused_add_rmsnorm_bwd(const void* s, const void* g, const void* dh,
                                const void* ds_out, void* ds, void* dg,
                                void* work, int n, int d, long long ss,
                                long long sdh, long long sds_out,
                                long long sds, float eps, void* stream) {
  return launch<true>(s, g, dh, ds_out, ds, dg, work, n, d, ss, sdh, sds_out,
                      sds, eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
