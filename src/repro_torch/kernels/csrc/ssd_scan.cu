// Chunked SSD scan (Mamba2, state-space duality) for Hopper (sm_90a):
// bf16 x, B, C in; f32 dt, A, D; f32 products and state; bf16 out.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan (Pallas
// body _ssd_kernel).  Same function, per (batch, head) and chunk of Q
// steps, carrying an (N, P) f32 state S from chunk to chunk:
//   cum      = inclusive cumsum of dt * A over the chunk
//   y_i      = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i S + D x_i
//   S'       = exp(cum_Q) S + sum_j exp(cum_Q - cum_j) dt_j B_j^T x_j
// with x (b, L, H, P), dt (b, L, H), A/D (H,), B/C (b, L, G, N); head h
// reads group h / (H / G) of B and C in place (the TPU wrapper repeated
// them per head in device memory).
//
// What bounds it on the H100.  At mamba2-2.7b's serve prefill (b = 4,
// L = 2048, H = 80, P = 64, N = 128, G = 1, Q = 128) the function needs
// ~27.0 GFLOP: C_i . B_j once per group and only for j <= i (0.14
// GFLOP), M x over the same triangle per head (5.4), C S and the state
// update (10.7 each).  That is 0.027 ms at 989 TFLOP/s against ~175 MB
// moved (x and y 84 MB each, B, C and dt): 0.052 ms at 3.35 TB/s, so it
// is bytes-bound.  zamba2-1.2b's NanoFlow half (b = 2, H = 64, N = 64)
// needs ~6.5 GFLOP on ~69 MB: bytes, 0.021 ms.
// This kernel does ~43.6 GFLOP, all as f32 FMAs on the CUDA cores: it
// forms C B^T per head (11.4 GFLOP over the 136 of 256 8 x 8 tiles on or
// below the diagonal, though with G = 1 all 80 heads share one product)
// and runs M x over the whole Q x Q square (10.7).  At the CUDA cores'
// f32 peak of ~67 TFLOP/s it cannot beat ~0.65 ms at mamba2's b = 4, 12x
// its bound; an f32 kernel doing only the 27 GFLOP needed, ~0.40 ms.
// Sharing C B^T across a group's heads, tensor cores (C B^T on bf16 is
// exact in its products; M x is not, M being f32), TMA and a
// chunk-parallel state pass are later work.
//
// Design.  On the TPU the chunk axis was a sequential grid axis carrying
// S in VMEM scratch; here blocks run in no order, so one block per
// (head, batch) walks its chunks in a loop and keeps S in shared memory.
// Per chunk the block stages x and B row-major and C transposed (bf16,
// exact), forms M = (C B^T) * decay in f32 in shared memory with the
// exponent masked (j > i never reaches expf: exp(cum_i - cum_j) overflows
// above the diagonal and inf * 0 is NaN), then y = exp(cum) (C S) + M x
// + D x, then the state update.  Shared memory at N = 128 is 177.5 KB:
// C and B 32 KB each, x 16 KB, M 64 KB, S 32 KB.  Rows past Q (a chunk
// shorter than 128) are staged as zeros.  The cumsum is a fixed-order
// scan (4 rows per lane, then a warp scan), so a row's result does not
// depend on the other rows of the launch.  x, B and C are read through
// their strides (column slices of the post-conv activations, NanoFlow's
// micro-batch views).  This is the simple first version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int QM = 128;       // largest chunk: rows staged per chunk
constexpr int P = 64;         // head dim
constexpr int NTHREADS = 256;

template <int N>
struct SsdSmem {              // byte offsets into dynamic shared memory
  static constexpr size_t ct = 0;                              // bf16 [N][QM]
  static constexpr size_t bs = ct + size_t(N) * QM * 2;        // bf16 [QM][N]
  static constexpr size_t xs = bs + size_t(QM) * N * 2;        // bf16 [QM][P]
  static constexpr size_t mt = xs + size_t(QM) * P * 2;        // f32 [QM][QM]
  static constexpr size_t st = mt + size_t(QM) * QM * 4;       // f32 [N][P]
  static constexpr size_t dt = st + size_t(N) * P * 4;         // f32 [QM]
  static constexpr size_t cum = dt + QM * 4;                   // f32 [QM]
  static constexpr size_t ec = cum + QM * 4;                   // exp(cum)
  static constexpr size_t w = ec + QM * 4;  // exp(cum_Q - cum_j) dt_j
  static constexpr size_t decay = w + QM * 4;                  // exp(cum_Q)
  static constexpr size_t bytes = decay + 16;
};

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack4(const uint2& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

// K consecutive bf16 values (K = 4 or 8) from 8- or 16-byte aligned smem.
template <int K>
__device__ __forceinline__ void load_row(const bf16* p, float* f) {
  if constexpr (K == 8) {
    unpack8(*reinterpret_cast<const uint4*>(p), f);
  } else {
    static_assert(K == 4, "rows of 4 or 8");
    unpack4(*reinterpret_cast<const uint2*>(p), f);
  }
}

template <int N>
__global__ void __launch_bounds__(NTHREADS, 1)
ssd_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const float* __restrict__ D,
                bf16* __restrict__ y, int H, int G, int L, int Q,
                long long sxb, long long sxl, long long sxh,
                long long sdb, long long sdl, long long sdh,
                long long sbb, long long sbl, long long sbg,
                long long scb, long long scl, long long scg,
                long long syb, long long syl, long long syh) {
  using S = SsdSmem<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sCt = reinterpret_cast<bf16*>(smem + S::ct);
  bf16* sB = reinterpret_cast<bf16*>(smem + S::bs);
  bf16* sX = reinterpret_cast<bf16*>(smem + S::xs);
  float* sMt = reinterpret_cast<float*>(smem + S::mt);
  float* sS = reinterpret_cast<float*>(smem + S::st);
  float* sDt = reinterpret_cast<float*>(smem + S::dt);
  float* sCum = reinterpret_cast<float*>(smem + S::cum);
  float* sEc = reinterpret_cast<float*>(smem + S::ec);
  float* sW = reinterpret_cast<float*>(smem + S::w);
  float* sDecay = reinterpret_cast<float*>(smem + S::decay);

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a = A[h], d = D[h];
  const bf16* xb = x + b * sxb + h * sxh;
  const float* dtb = dt + b * sdb + h * sdh;
  const bf16* bb = Bm + b * sbb + g * sbg;
  const bf16* cb = Cm + b * scb + g * scg;
  bf16* yb = y + b * syb + h * syh;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < N * P; i += NTHREADS) sS[i] = 0.f;

  const int nchunks = L / Q;
  for (int c = 0; c < nchunks; ++c) {
    const long long l0 = (long long)c * Q;
    __syncthreads();  // the previous chunk is done with the staged tiles

    // ---- stage the chunk: x, B row-major, C transposed, dt ----------------
    for (int idx = tid; idx < QM * (P / 8); idx += NTHREADS) {
      const int i = idx / (P / 8), k = idx % (P / 8);
      const uint4 v = i < Q ? *reinterpret_cast<const uint4*>(
                                  xb + (l0 + i) * sxl + k * 8)
                            : zero;
      *reinterpret_cast<uint4*>(sX + i * P + k * 8) = v;
    }
    for (int idx = tid; idx < QM * (N / 8); idx += NTHREADS) {
      const int i = idx / (N / 8), k = idx % (N / 8);
      const uint4 v = i < Q ? *reinterpret_cast<const uint4*>(
                                  bb + (l0 + i) * sbl + k * 8)
                            : zero;
      *reinterpret_cast<uint4*>(sB + i * N + k * 8) = v;
    }
    for (int idx = tid; idx < QM * (N / 8); idx += NTHREADS) {
      const int i = idx % QM, k = idx / QM;
      const uint4 v = i < Q ? *reinterpret_cast<const uint4*>(
                                  cb + (l0 + i) * scl + k * 8)
                            : zero;
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int r = 0; r < 8; ++r) sCt[(k * 8 + r) * QM + i] = e[r];
    }
    for (int i = tid; i < QM; i += NTHREADS)
      sDt[i] = i < Q ? dtb[(l0 + i) * sdl] : 0.f;
    __syncthreads();

    // ---- cumsum of dt * A: 4 rows per lane, then a warp scan ---------------
    if (tid < 32) {
      const int lane = tid;
      float part[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += sDt[4 * lane + k] * a;
        part[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) sCum[4 * lane + k] = excl + part[k];
      __syncwarp();
      const float last = sCum[Q - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * lane + k;
        sEc[i] = expf(sCum[i]);
        sW[i] = i < Q ? expf(last - sCum[i]) * sDt[i] : 0.f;
      }
      if (lane == 0) sDecay[0] = expf(last);
    }
    __syncthreads();

    // ---- M^T[j][i] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i < Q -------
    {
      const int ti = tid % 16, tj = tid / 16;   // 8 x 8 tile of (i, j)
      const int i0 = ti * 8, j0 = tj * 8;
      float acc[8][8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[u][r] = 0.f;
      if (i0 + 7 >= j0) {          // a tile wholly above the diagonal is 0
        for (int n = 0; n < N; n += 2) {
          float c0[8], c1[8];
          load_row<8>(sCt + n * QM + i0, c0);
          load_row<8>(sCt + (n + 1) * QM + i0, c1);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float2 bv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sB + (j0 + r) * N +
                                                         n));
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              acc[u][r] = fmaf(c0[u], bv.x, acc[u][r]);
              acc[u][r] = fmaf(c1[u], bv.y, acc[u][r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = j0 + r;
        const float cj = sCum[j], dj = sDt[j];
        __align__(16) float m[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u;
          // mask the exponent, not the product
          m[u] = (j <= i && i < Q) ? acc[u][r] * expf(sCum[i] - cj) * dj
                                   : 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(sMt + j * QM + i0);
        dst[0] = *reinterpret_cast<const float4*>(m);
        dst[1] = *reinterpret_cast<const float4*>(m + 4);
      }
    }
    __syncthreads();

    // ---- y = exp(cum) (C S) + M x + D x ------------------------------------
    {
      const int lane = tid & 31, warp = tid >> 5;   // 4 rows x 8 columns
      const int i0 = lane * 4, p0 = warp * 8;
      float acc[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
        load_row<4>(sCt + n * QM + i0, cv);
        const float4 s0 = *reinterpret_cast<const float4*>(sS + n * P + p0);
        const float4 s1 =
            *reinterpret_cast<const float4*>(sS + n * P + p0 + 4);
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(cv[u], sv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float e = sEc[i0 + u];
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] *= e;
      }
      for (int j = 0; j < Q; ++j) {
        const float4 mv = *reinterpret_cast<const float4*>(sMt + j * QM + i0);
        const float m[4] = {mv.x, mv.y, mv.z, mv.w};
        float xv[8];
        load_row<8>(sX + j * P + p0, xv);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(m[u], xv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (i >= Q) continue;
        float xv[8];
        load_row<8>(sX + i * P + p0, xv);
        __align__(16) bf16 out[8];
#pragma unroll
        for (int v = 0; v < 8; ++v)
          out[v] = __float2bfloat16(fmaf(d, xv[v], acc[u][v]));
        *reinterpret_cast<uint4*>(yb + (l0 + i) * syl + p0) =
            *reinterpret_cast<const uint4*>(out);
      }
    }
    __syncthreads();

    // ---- S = exp(cum_Q) S + sum_j w_j B_j^T x_j ----------------------------
    {
      constexpr int TN = N / 16;                  // TN x 4 tile of (n, p)
      const int tp = tid % 16, tn = tid / 16;
      const int p0 = tp * 4, n0 = tn * TN;
      float acc[TN][4];
#pragma unroll
      for (int u = 0; u < TN; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float wj = sW[j];
        float xv[4], bv[TN];
        load_row<4>(sX + j * P + p0, xv);
        load_row<TN>(sB + j * N + n0, bv);
#pragma unroll
        for (int v = 0; v < 4; ++v) xv[v] *= wj;
#pragma unroll
        for (int u = 0; u < TN; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(bv[u], xv[v], acc[u][v]);
      }
      const float decay = sDecay[0];
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        float4* sp = reinterpret_cast<float4*>(sS + (n0 + u) * P + p0);
        float4 s = *sp;
        s.x = fmaf(s.x, decay, acc[u][0]);
        s.y = fmaf(s.y, decay, acc[u][1]);
        s.z = fmaf(s.z, decay, acc[u][2]);
        s.w = fmaf(s.w, decay, acc[u][3]);
        *sp = s;
      }
    }
  }
}

template <int N>
int launch_ssd(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, void* y, int batch, int L,
               int H, int G, int Q, const long long* st,
               cudaStream_t stream) {
  static bool attr_set = false;
  const size_t smem = SsdSmem<N>::bytes;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(H, batch);
  ssd_scan_kernel<N><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<const float*>(D),
      static_cast<bf16*>(y), H, G, L, Q, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 15 element strides, (batch, seq, head or group) for x, dt, B, C
// and y in turn; x, B, C and y have a unit stride along their last dim.
// P must be 64, N 64 or 128, 1 <= Q <= 128 with L % Q == 0, H % G == 0.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* D, void* y,
                       int batch, int L, int H, int G, int P_, int N, int Q,
                       const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P_ != P || Q < 1 || Q > QM || L % Q || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  if (N == 128)
    return launch_ssd<128>(x, dt, A, B, C, D, y, batch, L, H, G, Q, strides,
                           s);
  if (N == 64)
    return launch_ssd<64>(x, dt, A, B, C, D, y, batch, L, H, G, Q, strides,
                          s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
