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
// pass must read each byte once and keep the card's memory busy.  The
// column sum of dg is deterministic, without atomics: each block writes
// one f32 partial row of a workspace, and a second launch sums the
// blocks' partial rows in a fixed order for each column.
//
// rmsnorm_bwd_kernel (rmsnorm_bwd).  The row geometry of the forward
// (rmsnorm.cu, rmsnorm.py:norm_bwd_geometry): a row on W warps (1 up to d
// = 1024, 4 up to 4096, 8 beyond), a lane holding NP <= 4 packs of 8
// columns, neighbouring lanes on neighbouring 16 bytes.  A lane owns the
// same columns in every row of its block, so g is loaded once a block and
// dg accumulates in registers (8 NP f32 a lane); the row's x and dh stay
// in registers between its two sums (shuffles, and for W > 1 one barrier
// to add the warps' sums in shared memory) and the write of dx, so each
// byte is read once.  Bytes in flight: a block (4 warps, 8 at W = 8) owns
// a contiguous run of rows and loads its next row before the reductions of
// this one, and the grid is 4 blocks an SM (2 at W = 8), so an SM keeps
// about two rows a warp of 16 warps in flight.  At its end a block folds
// its warps' register dg into its partial row in warp order (through
// shared memory where W = 1: every warp of the block holds every column).
//
// norm_bwd_rows_kernel (fused_add_rmsnorm_bwd, the first design, not yet
// redesigned).  A block of four warps, one row a warp at a time; two
// sweeps of a row, the second re-reading it from L1/L2 to write ds and add
// the lane's share of dg into its warp's f32 row of shared memory.
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

// fused_add_rmsnorm_bwd: (x = s, dh, ds_out -> dx = ds).  part:
// (gridDim.x, d) f32 partial rows of dg.
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
      float base[8];
      unpack8(*reinterpret_cast<const uint4*>(ds_out + r * sds + 8 * p), base);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[e] = base[e] + rr * (hv[e] * gv[e]) - k * xv[e];
        mine[8 * p + e] = fmaf(hv[e], xv[e] * rr, mine[8 * p + e]);
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

// rmsnorm_bwd: a row on W warps, NP packs a lane; a block's warps take R =
// WARPS / W rows at once from its contiguous run; part: (gridDim.x, d)
template <int W, int NP>
__global__ void __launch_bounds__(W == 8 ? 256 : 128)
rmsnorm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const bf16* __restrict__ dh, bf16* __restrict__ dx,
                   float* __restrict__ part, int n, int d, long long sx,
                   long long sdh, long long sdx, float eps) {
  constexpr int WARPS = W == 8 ? 8 : 4, R = WARPS / W;
  __shared__ float red[2][2][WARPS];       // a row's two sums, by row parity
  extern __shared__ __align__(16) float fold[];   // [WARPS][d] where W == 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = lane + 32 * (warp % W), nvec = d >> 3;
  const int per = (n + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per, r1 = min(n, r0 + per);
  const float inv_d = 1.f / d;

  uint4 gp[NP];
  float dg[NP][8];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (L + 32 * W * i < nvec)
      gp[i] = *reinterpret_cast<const uint4*>(g + 8 * (L + 32 * W * i));
#pragma unroll
    for (int e = 0; e < 8; ++e) dg[i][e] = 0.f;
  }
  uint4 xc[NP], hc[NP];
  int r = r0 + warp / W;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int v = L + 32 * W * i;
    if (r < r1 && v < nvec) {
      xc[i] = *reinterpret_cast<const uint4*>(x + r * sx + 8 * v);
      hc[i] = *reinterpret_cast<const uint4*>(dh + r * sdh + 8 * v);
    }
  }
  for (int k = 0; r < r1; r += R, ++k) {
    // the next row's loads go out before this row's reductions
    uint4 xn[NP], hn[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int v = L + 32 * W * i;
      if (r + R < r1 && v < nvec) {
        xn[i] = *reinterpret_cast<const uint4*>(x + (r + R) * sx + 8 * v);
        hn[i] = *reinterpret_cast<const uint4*>(dh + (r + R) * sdh + 8 * v);
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (L + 32 * W * i < nvec) {
        float xv[8], hv[8], gv[8];
        unpack8(xc[i], xv);
        unpack8(hc[i], hv);
        unpack8(gp[i], gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ss = fmaf(xv[e], xv[e], ss);
          dot = fmaf(hv[e] * gv[e], xv[e], dot);
        }
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (W > 1) {                             // R == 1: block-uniform
      if (lane == 0) {
        red[k & 1][0][warp] = ss;
        red[k & 1][1][warp] = dot;
      }
      __syncthreads();
      ss = dot = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        ss += red[k & 1][0][w];
        dot += red[k & 1][1][w];
      }
    }
    const float rr = rsqrtf(ss * inv_d + eps);
    const float kk = rr * rr * rr * inv_d * dot;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int v = L + 32 * W * i;
      if (v < nvec) {
        float xv[8], hv[8], gv[8], out[8];
        unpack8(xc[i], xv);
        unpack8(hc[i], hv);
        unpack8(gp[i], gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          out[e] = rr * (hv[e] * gv[e]) - kk * xv[e];
          dg[i][e] = fmaf(hv[e], __bfloat162float(__float2bfloat16(xv[e] * rr)),
                          dg[i][e]);
        }
        *reinterpret_cast<uint4*>(dx + r * sdx + 8 * v) = pack8(out);
      }
      xc[i] = xn[i];
      hc[i] = hn[i];
    }
  }
  // the block's partial row of dg, its warps added in order
  float* prow = part + (long long)blockIdx.x * d;
  if (W == 1) {
    float* mine = fold + warp * d;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        reinterpret_cast<float4*>(mine + 8 * v)[0] =
            make_float4(dg[i][0], dg[i][1], dg[i][2], dg[i][3]);
        reinterpret_cast<float4*>(mine + 8 * v)[1] =
            make_float4(dg[i][4], dg[i][5], dg[i][6], dg[i][7]);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += 32 * WARPS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += fold[w * d + c];
      prow[c] = s;
    }
  } else {                                   // one lane owns each column
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int v = L + 32 * W * i;
      if (v < nvec) {
        reinterpret_cast<float4*>(prow + 8 * v)[0] =
            make_float4(dg[i][0], dg[i][1], dg[i][2], dg[i][3]);
        reinterpret_cast<float4*>(prow + 8 * v)[1] =
            make_float4(dg[i][4], dg[i][5], dg[i][6], dg[i][7]);
      }
    }
  }
}

// dg[c] = sum of the blocks' partial rows: eight row groups of a block add
// every eighth partial row in order, then the eight sums in order
__global__ void __launch_bounds__(256)
rmsnorm_bwd_dg_kernel(const float* __restrict__ part, bf16* __restrict__ dg,
                      int blocks, int d) {
  __shared__ float acc[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = ty; b < blocks; b += 8) s += part[(long long)b * d + c];
  }
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += acc[y][tx];
    dg[c] = __float2bfloat16(t);
  }
}

template <int W, int NP>
int launch_rmsnorm_bwd(const void* x, const void* g, const void* dh, void* dx,
                       void* dg, float* part, int blocks, int n, int d,
                       long long sx, long long sdh, long long sdx, float eps,
                       cudaStream_t stream) {
  constexpr int THREADS = W == 8 ? 256 : 128;
  const size_t smem = W == 1 ? (size_t)(THREADS / 32) * d * sizeof(float) : 0;
  rmsnorm_bwd_kernel<W, NP><<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(dh), static_cast<bf16*>(dx), part, n, d, sx,
      sdh, sdx, eps);
  rmsnorm_bwd_dg_kernel<<<(d + 31) / 32, 256, 0, stream>>>(
      part, static_cast<bf16*>(dg), blocks, d);
  return (int)cudaGetLastError();
}

int launch_fused(const void* x, const void* g, const void* dh,
                 const void* ds_out, void* dx, void* dg, void* work, int n,
                 int d, long long sx, long long sdh, long long sds,
                 long long sdx, float eps, cudaStream_t stream) {
  if (n < 1 || d < 8 || d % 8 || d > 8192) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * d * sizeof(float);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WARPS * 8192 * 4);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int blocks = min(MAX_BLOCKS, (n + WARPS - 1) / WARPS);
  float* part = static_cast<float*>(work);
  norm_bwd_rows_kernel<<<blocks, THREADS, smem, stream>>>(
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
// aligned rows), g and dg: (d,) bf16, work: blocks x d f32.  A row on wpr
// warps (1 for d <= 1024, 4 up to 4096, 8 up to 8192), np packs of 8 a lane
// (1-4, 256 wpr np >= d); blocks: any count >= 1 (the geometry of
// rmsnorm.py:norm_bwd_geometry).  Returns cudaGetLastError() after the
// launches.
int repro_rmsnorm_bwd(const void* x, const void* g, const void* dh, void* dx,
                      void* dg, void* work, int n, int d, long long sx,
                      long long sdh, long long sdx, float eps, int wpr,
                      int np, int blocks, void* stream) {
  if (n < 1 || d < 8 || d % 8 || blocks < 1 || np < 1 || np > 4 ||
      256 * wpr * np < d)
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_RMSNORM_BWD(W, NP)                                             \
  if (wpr == W && np == NP)                                                 \
    return launch_rmsnorm_bwd<W, NP>(x, g, dh, dx, dg, part, blocks, n, d,  \
                                     sx, sdh, sdx, eps, s);
  if (d <= 1024) {
    REPRO_RMSNORM_BWD(1, 1)
    REPRO_RMSNORM_BWD(1, 2)
    REPRO_RMSNORM_BWD(1, 3)
    REPRO_RMSNORM_BWD(1, 4)
  } else if (d <= 4096) {
    REPRO_RMSNORM_BWD(4, 2)
    REPRO_RMSNORM_BWD(4, 3)
    REPRO_RMSNORM_BWD(4, 4)
  } else if (d <= 8192) {
    REPRO_RMSNORM_BWD(8, 3)
    REPRO_RMSNORM_BWD(8, 4)
  }
#undef REPRO_RMSNORM_BWD
  return (int)cudaErrorInvalidValue;
}

// s (the forward's residual), dh, ds_out, ds: (n, d) bf16 rows at the
// given row strides, g and dg: (d,) bf16, work: repro_norm_bwd_blocks(n) x
// d f32.  Returns cudaGetLastError() after the launches.
int repro_fused_add_rmsnorm_bwd(const void* s, const void* g, const void* dh,
                                const void* ds_out, void* ds, void* dg,
                                void* work, int n, int d, long long ss,
                                long long sdh, long long sds_out,
                                long long sds, float eps, void* stream) {
  return launch_fused(s, g, dh, ds_out, ds, dg, work, n, d, ss, sdh, sds_out,
                      sds, eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
