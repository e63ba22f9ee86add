// Grouped expert FFN for Hopper (sm_90a), bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py:grouped_ffn
// (Pallas body _grouped_ffn_kernel).  Same function, per expert e:
//   y_e = (silu(x_e W1_e) * (x_e W3_e)) W2_e
// with x (E, N, D), w1/w3 (E, D, F), w2 (E, F, D).  The TPU kernel walks
// F in blocks on one core and adds each block's partial product into the
// bf16 output, rounding it after every block; here all of F is summed in
// f32 and the output is rounded once, which is the same function, more
// exactly.  The gated hidden activation h is kept in bf16 between the two
// launches (one rounding of each element of h).
//
// What bounds it on the H100.  At the DBO prefill micro-batch of
// deepseek-moe-16b, (E, N, D, F) = (64, 480, 2048, 1408): 532 GFLOP
// against 1.36 GB of weights, activations and outputs, so operations
// (0.54 ms at 989 TFLOP/s) over bytes (0.41 ms at 3.35 TB/s).  At a
// Comet chunk (N = 120) and at decode (N = 4) the weights dominate and
// bytes bound it: every expert's 34.6 MB of W1, W3 and W2 must stream
// once.  The design runs every product on the tensor cores (WMMA
// 16x16x16 bf16 -> f32, i.e. mma.sync), stages tiles through shared memory
// with cp.async double buffering so loads overlap the products, and reads
// each weight tile once per N tile: at N <= 64 (decode, small chunks) the
// weights are read exactly once.
//
// Design.  Two launches, as the TPU kernel's sequential F axis cannot
// carry a sum between parallel blocks:
//   1. gate-up: one block per (F tile of 64, N tile of 64, expert) forms
//      x W1 and x W3 for its tile in two sets of f32 accumulators, applies
//      silu(a) * b in registers and writes h (E, N, F) in bf16;
//   2. down: one block per (D tile of 128, N tile of 64, expert) forms
//      h W2 over all of F in f32 and rounds once.
// Rows past N are zero-filled on load (cp.async src-size 0) and never
// stored, so any N >= 1 works; unfilled capacity rows (zeros) give zeros.
// x may be a strided view (expert and row strides, unit column stride):
// Comet's chunks of the dispatch buffer are read in place.  This is the
// simple first version: no TMA, no wgmma, no warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;          // rows of x (tokens) per block
constexpr int BK = 32;          // depth of one staged tile
constexpr int BN_UP = 64;       // F columns per gate-up block
constexpr int BN_DOWN = 128;    // D columns per down block
constexpr int NTHREADS = 128;   // 4 warps as 2 x 2
constexpr int LDA = BK + 8;     // padded bf16 rows of the A tiles
constexpr int LDU = BN_UP + 8;  // padded bf16 rows of the W1/W3 tiles
constexpr int LDD = BN_DOWN + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// Stage a BM x BK tile of rows [m0, m0+BM) x cols [k0, k0+BK) of a
// row-major matrix with row stride ld; rows >= M are zero-filled.
__device__ __forceinline__ void load_a(bf16 (*dst)[LDA], const bf16* src,
                                       long long ld, int m0, int M, int k0,
                                       int tid) {
  for (int i = tid; i < BM * (BK / 8); i += NTHREADS) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const bool ok = m0 + r < M;
    cp_async16(&dst[r][c], src + (long long)(ok ? m0 + r : 0) * ld + k0 + c,
               ok);
  }
}

// Stage a BK x BN tile of rows [k0, k0+BK) x cols [n0, n0+BN) of a
// row-major matrix with row stride ld (always in bounds).
template <int BN, int LD>
__device__ __forceinline__ void load_b(bf16 (*dst)[LD], const bf16* src,
                                       long long ld, int k0, int n0,
                                       int tid) {
  for (int i = tid; i < BK * (BN / 8); i += NTHREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    cp_async16(&dst[r][c], src + (long long)(k0 + r) * ld + n0 + c, true);
  }
}

// Write one 16x16 f32 accumulator tile as bf16 rows [row0, row0+16) x
// cols [col0, col0+16) of a row-major output with row stride ld, through
// the warp's 16x16 f32 scratch; rows >= M are skipped.
template <typename Frag>
__device__ __forceinline__ void store_tile(const Frag& acc, float* scratch,
                                           bf16* out, long long ld, int row0,
                                           int M, int col0, int lane) {
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int r = lane / 2, c = (lane % 2) * 8;
  if (row0 + r < M) {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(scratch[r * 16 + c + e]);
    *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * ld + col0 + c) =
        *reinterpret_cast<const uint4*>(v);
  }
  __syncwarp();
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// h[e, n, f] = silu(x[e, n, :] . w1[e, :, f]) * (x[e, n, :] . w3[e, :, f])
__global__ void __launch_bounds__(NTHREADS)
gate_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ w3, bf16* __restrict__ h, int N,
               int D, int F, long long sxe, long long sxn) {
  __shared__ __align__(128) bf16 sX[2][BM][LDA];
  __shared__ __align__(128) bf16 sW1[2][BK][LDU];
  __shared__ __align__(128) bf16 sW3[2][BK][LDU];
  __shared__ __align__(128) float scratch[NTHREADS / 32][16 * 16];

  const int f0 = blockIdx.x * BN_UP, n0 = blockIdx.y * BM, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;     // 32 x 32 per warp
  const bf16* xe = x + (long long)e * sxe;
  const bf16* w1e = w1 + (long long)e * D * F;
  const bf16* w3e = w3 + (long long)e * D * F;

  FragC acc1[2][2], acc3[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc1[i][j], 0.f);
      wmma::fill_fragment(acc3[i][j], 0.f);
    }

  const int KT = D / BK;
  load_a(sX[0], xe, sxn, n0, N, 0, tid);
  load_b<BN_UP, LDU>(sW1[0], w1e, F, 0, f0, tid);
  load_b<BN_UP, LDU>(sW3[0], w3e, F, 0, f0, tid);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) {
      const int k1 = (kt + 1) * BK;
      load_a(sX[s ^ 1], xe, sxn, n0, N, k1, tid);
      load_b<BN_UP, LDU>(sW1[s ^ 1], w1e, F, k1, f0, tid);
      load_b<BN_UP, LDU>(sW3[s ^ 1], w3e, F, k1, f0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sX[s][wm * 32 + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB b1, b3;
        wmma::load_matrix_sync(b1, &sW1[s][kk][wn * 32 + j * 16], LDU);
        wmma::load_matrix_sync(b3, &sW3[s][kk][wn * 32 + j * 16], LDU);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc1[i][j], a[i], b1, acc1[i][j]);
          wmma::mma_sync(acc3[i][j], a[i], b3, acc3[i][j]);
        }
      }
    }
    __syncthreads();   // every warp is done with stage s before its reload
  }

  // the two accumulator sets share one fragment layout, so the gate is
  // elementwise on the registers
  bf16* he = h + (long long)e * N * F;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int t = 0; t < acc1[i][j].num_elements; ++t)
        acc1[i][j].x[t] = silu(acc1[i][j].x[t]) * acc3[i][j].x[t];
      store_tile(acc1[i][j], scratch[warp], he, F, n0 + wm * 32 + i * 16, N,
                 f0 + wn * 32 + j * 16, lane);
    }
}

// y[e, n, d] = h[e, n, :] . w2[e, :, d], all of F in f32, rounded once
__global__ void __launch_bounds__(NTHREADS)
down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
            bf16* __restrict__ y, int N, int D, int F) {
  __shared__ __align__(128) bf16 sH[2][BM][LDA];
  __shared__ __align__(128) bf16 sW[2][BK][LDD];
  __shared__ __align__(128) float scratch[NTHREADS / 32][16 * 16];

  const int d0 = blockIdx.x * BN_DOWN, n0 = blockIdx.y * BM, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;     // 32 x 64 per warp
  const bf16* he = h + (long long)e * N * F;
  const bf16* w2e = w2 + (long long)e * F * D;

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = F / BK;
  load_a(sH[0], he, F, n0, N, 0, tid);
  load_b<BN_DOWN, LDD>(sW[0], w2e, D, 0, d0, tid);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) {
      const int k1 = (kt + 1) * BK;
      load_a(sH[s ^ 1], he, F, n0, N, k1, tid);
      load_b<BN_DOWN, LDD>(sW[s ^ 1], w2e, D, k1, d0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sH[s][wm * 32 + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, &sW[s][kk][wn * 64 + j * 16], LDD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

  bf16* ye = y + (long long)e * N * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_tile(acc[i][j], scratch[warp], ye, D, n0 + wm * 32 + i * 16, N,
                 d0 + wn * 64 + j * 16, lane);
}

}  // namespace

extern "C" {

// x (E, N, D) bf16 with element strides sxe (expert) and sxn (row), unit
// column stride; w1/w3 (E, D, F), w2 (E, F, D), h (E, N, F) scratch and
// y (E, N, D) contiguous bf16.  Needs D % 128 == 0 and F % 64 == 0, all
// pointers 16-byte aligned and sxe, sxn multiples of 8.  Returns
// cudaGetLastError() after the launches (0 on success).
int repro_grouped_ffn_fwd(const void* x, const void* w1, const void* w3,
                          const void* w2, void* h, void* y, int E, int N,
                          int D, int F, long long sxe, long long sxn,
                          void* stream) {
  if (E < 1 || N < 1 || D % BN_DOWN || F % BN_UP || D % BK || F % BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + BM - 1) / BM;
  gate_up_kernel<<<dim3(F / BN_UP, n_tiles, E), NTHREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<bf16*>(h), N, D, F, sxe, sxn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_kernel<<<dim3(D / BN_DOWN, n_tiles, E), NTHREADS, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<bf16*>(y), N, D, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
