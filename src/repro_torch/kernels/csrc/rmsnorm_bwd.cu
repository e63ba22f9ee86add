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
//                          rounded once, and dg = sum over rows of dh s r
//                          (unrounded, as _farn_bwd has it); the wrapper
//                          hands ds out as the gradient of both x and y.
//
// What bounds them on the H100: bytes.  A row costs a few FLOPs an element
// against reading x (or s), dh (and ds_out) and writing dx (or ds), so a
// pass must read each byte once and keep the card's memory busy.  The
// column sum of dg is deterministic, without atomics: each block writes
// one f32 partial row of a workspace, and a second launch sums the
// blocks' partial rows in a fixed order for each column.
//
// One kernel body, norm_bwd_kernel<W, NP, FUSED>, serves both; FUSED adds
// the ds_out stream and leaves dg's terms unrounded.  The row geometry of
// the forward (rmsnorm.cu, rmsnorm.py:norm_bwd_geometry): a row on W warps
// (1 up to d = 1024, 4 up to 4096, 8 beyond), a lane holding NP <= 4 packs
// of 8 columns, neighbouring lanes on neighbouring 16 bytes.  A lane owns
// the same columns in every row of its block, so g is loaded once a block
// and dg accumulates in registers (8 NP f32 a lane); the row's x and dh
// stay in registers between its two sums (shuffles, and for W > 1 one
// barrier to add the warps' sums in shared memory) and the write of dx, so
// each byte is read once.  Bytes in flight: a block (4 warps, 8 at W = 8)
// owns a contiguous run of rows and loads its next row's x and dh before
// the reductions of this one; the fused pass issues this row's ds_out
// first, so its latency hides under the same reductions.  The grid is
// blocks_per_sm() blocks an SM, the count each instantiation is compiled
// to keep resident (__launch_bounds__): 3 of 4 warps where a lane holds 3
// or 4 packs (up to 168 registers), 2 from 4 warps a row, 1 of 8.  At its
// end a block folds its warps' register dg into its partial row in warp
// order (through shared memory where W = 1: every warp of the block holds
// every column).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// threads of a block: 4 warps, 8 where a row takes 8
__host__ __device__ constexpr int threads_of(int W) {
  return W == 8 ? 256 : 128;
}

// blocks an SM of the grid, each instantiation compiled to keep them
// resident (the same rule as rmsnorm.py:norm_bwd_geometry): a lane's 3 or
// 4 packs leave registers for 3 blocks of 4 warps, and at 4 warps a row
// fewer, longer runs serve better (tools/kernel_probes.py --probes
// norm_bwd: 2 an SM beat 3 and 4 at d = 4096, where a block's partial row
// of dg is 16 KB)
__host__ __device__ constexpr int blocks_per_sm(int W, int NP) {
  return W == 8 ? 1 : W == 4 ? 2 : NP >= 3 ? 3 : 4;
}

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

// a row stream's 16 bytes, read once and written once
__device__ __forceinline__ uint4 ld_row(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st_row(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a row on W warps, NP packs a lane; a block's warps take R = WARPS / W
// rows at once from its contiguous run; FUSED: dx += ds_out (stride sds)
// and dg's terms unrounded; part: (gridDim.x, d)
template <int W, int NP, bool FUSED>
__global__ void __launch_bounds__(threads_of(W), blocks_per_sm(W, NP))
norm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                const bf16* __restrict__ dh, const bf16* __restrict__ ds_out,
                bf16* __restrict__ dx, float* __restrict__ part, int n, int d,
                long long sx, long long sdh, long long sds, long long sdx,
                float eps) {
  constexpr int WARPS = threads_of(W) / 32, R = WARPS / W;
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
      xc[i] = ld_row(x + r * sx + 8 * v);
      hc[i] = ld_row(dh + r * sdh + 8 * v);
    }
  }
  for (int k = 0; r < r1; r += R, ++k) {
    // this row's ds_out, then the next row's x and dh, go out before this
    // row's reductions
    uint4 oc[NP];
    if constexpr (FUSED) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int v = L + 32 * W * i;
        if (v < nvec)
          oc[i] = ld_row(ds_out + r * sds + 8 * v);
      }
    }
    uint4 xn[NP], hn[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int v = L + 32 * W * i;
      if (r + R < r1 && v < nvec) {
        xn[i] = ld_row(x + (r + R) * sx + 8 * v);
        hn[i] = ld_row(dh + (r + R) * sdh + 8 * v);
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
        if constexpr (FUSED) unpack8(oc[i], out);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = rr * (hv[e] * gv[e]) - kk * xv[e];
          if constexpr (FUSED) {
            out[e] += t;
            dg[i][e] = fmaf(hv[e], xv[e] * rr, dg[i][e]);
          } else {
            out[e] = t;
            dg[i][e] = fmaf(hv[e],
                            __bfloat162float(__float2bfloat16(xv[e] * rr)),
                            dg[i][e]);
          }
        }
        st_row(dx + r * sdx + 8 * v, pack8(out));
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

// dg[c] = sum of the blocks' partial rows: a block's DG_GROUPS row groups
// of 32 columns add every DG_GROUPS-th partial row in order, then the
// groups' sums in order
constexpr int DG_GROUPS = 32;

__global__ void __launch_bounds__(32 * DG_GROUPS)
norm_bwd_dg_kernel(const float* __restrict__ part, bf16* __restrict__ dg,
                   int blocks, int d) {
  __shared__ float acc[DG_GROUPS][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = ty; b < blocks; b += DG_GROUPS)
      s += part[(long long)b * d + c];
  }
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < DG_GROUPS; ++y) t += acc[y][tx];
    dg[c] = __float2bfloat16(t);
  }
}

template <int W, int NP, bool FUSED>
int launch(const void* x, const void* g, const void* dh, const void* ds_out,
           void* dx, void* dg, float* part, int blocks, int n, int d,
           long long sx, long long sdh, long long sds, long long sdx,
           float eps, cudaStream_t stream) {
  constexpr int THREADS = threads_of(W);
  const size_t smem = W == 1 ? (size_t)(THREADS / 32) * d * sizeof(float) : 0;
  norm_bwd_kernel<W, NP, FUSED><<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(dh), static_cast<const bf16*>(ds_out),
      static_cast<bf16*>(dx), part, n, d, sx, sdh, sds, sdx, eps);
  norm_bwd_dg_kernel<<<(d + 31) / 32, 32 * DG_GROUPS, 0, stream>>>(
      part, static_cast<bf16*>(dg), blocks, d);
  return (int)cudaGetLastError();
}

// the registers, spill bytes, threads and resident blocks an SM of one
// instantiation, and the blocks an SM it was compiled for
template <int W, int NP, bool FUSED>
int info(int* regs, int* local_bytes, int* threads, int* per_sm,
         int* resident) {
  constexpr int THREADS = threads_of(W);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, norm_bwd_kernel<W, NP, FUSED>);
  if (e != cudaSuccess) return (int)e;
  // the W == 1 fold at the widest row it takes (256 NP columns)
  const size_t smem =
      W == 1 ? (size_t)(THREADS / 32) * 256 * NP * sizeof(float) : 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, norm_bwd_kernel<W, NP, FUSED>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *threads = THREADS;
  *per_sm = blocks_per_sm(W, NP);
  return 0;
}

// the (warps a row, packs a lane) instantiated: 1 warp up to d = 1024, 4
// up to 4096, 8 up to 8192, the fewest packs that cover the row
#define REPRO_NORM_BWD_CASES(X) \
  X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(4, 2) X(4, 3) X(4, 4) X(8, 3) X(8, 4)

template <bool FUSED>
int dispatch(const void* x, const void* g, const void* dh, const void* ds_out,
             void* dx, void* dg, void* work, int n, int d, long long sx,
             long long sdh, long long sds, long long sdx, float eps, int wpr,
             int np, int blocks, void* stream) {
  const int want = d <= 1024 ? 1 : d <= 4096 ? 4 : 8;
  if (n < 1 || d < 8 || d % 8 || d > 8192 || blocks < 1 || np < 1 ||
      np > 4 || wpr != want || 256 * wpr * np < d)
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_NORM_BWD(W, NP)                                                \
  if (wpr == W && np == NP)                                                  \
    return launch<W, NP, FUSED>(x, g, dh, ds_out, dx, dg, part, blocks, n,   \
                                d, sx, sdh, sds, sdx, eps, s);
  REPRO_NORM_BWD_CASES(REPRO_NORM_BWD)
#undef REPRO_NORM_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

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
  return dispatch<false>(x, g, dh, nullptr, dx, dg, work, n, d, sx, sdh, 0,
                         sdx, eps, wpr, np, blocks, stream);
}

// s (the forward's residual), dh, ds_out, ds: (n, d) bf16 rows at the
// given row strides, g and dg: (d,) bf16, work: blocks x d f32; wpr, np
// and blocks as repro_rmsnorm_bwd's.
// Returns cudaGetLastError() after the launches.
int repro_fused_add_rmsnorm_bwd(const void* s, const void* g, const void* dh,
                                const void* ds_out, void* ds, void* dg,
                                void* work, int n, int d, long long ss,
                                long long sdh, long long sds_out,
                                long long sds, float eps, int wpr, int np,
                                int blocks, void* stream) {
  return dispatch<true>(s, g, dh, ds_out, ds, dg, work, n, d, ss, sdh,
                        sds_out, sds, eps, wpr, np, blocks, stream);
}

// Of the backward's instantiation (wpr, np, fused): registers a thread,
// local (spill) bytes, threads a block, the blocks an SM it is compiled
// for and the blocks an SM the card keeps resident.
int repro_norm_bwd_info(int wpr, int np, int fused, int* regs,
                        int* local_bytes, int* threads, int* per_sm,
                        int* resident) {
#define REPRO_NORM_BWD_INFO(W, NP)                                           \
  if (wpr == W && np == NP)                                                  \
    return fused ? info<W, NP, true>(regs, local_bytes, threads, per_sm,     \
                                     resident)                               \
                 : info<W, NP, false>(regs, local_bytes, threads, per_sm,    \
                                      resident);
  REPRO_NORM_BWD_CASES(REPRO_NORM_BWD_INFO)
#undef REPRO_NORM_BWD_INFO
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
