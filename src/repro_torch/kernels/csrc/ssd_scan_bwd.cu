// Backward of the chunked SSD scan (Mamba2) for Hopper (sm_90a): bf16 x,
// B, C and dy in; f32 dt, A, D.  Out: dx, dB, dC in bf16, ddt, dA, dD in
// f32.  Every product is an f32 FMA on the CUDA cores; nothing is
// rounded before the outputs.
//
// Replaces no TPU kernel: the Pallas ssd_scan (src/repro/kernels/
// ssd_scan.py) has no VJP, and the reference trains through XLA's
// autodiff of src/repro/models/mamba2.py:SSDScanOp._ref.  This is that
// VJP, per (batch, head) chain and chunk of Q steps, with the forward's
//   cum_i = inclusive cumsum of dt * A,  E_ij = exp(cum_i - cum_j) (j <= i)
//   M_ij  = (C_i . B_j) E_ij dt_j,       w_j = exp(cum_Q - cum_j) dt_j
//   y_i   = sum_j M_ij x_j + exp(cum_i) C_i S_n + D x_i
//   S_n+1 = exp(cum_Q) S_n + sum_j w_j B_j^T x_j          (S_0 = 0)
// and dS' = dL/dS_n+1 (zero after the last chunk):
//   dS_n  = exp(cum_Q) dS' + sum_i exp(cum_i) C_i^T dy_i
//   dx_j  = sum_{i>=j} M_ij dy_i + w_j B_j dS' + D dy_j
//   dC_i  = sum_{j<=i} Z_ij B_j + exp(cum_i) S_n dy_i
//           with Z_ij = (dy_i . x_j) E_ij dt_j
//   dB_j  = sum_{i>=j} Z_ij C_i + w_j dS' x_j
//   dcum  through E (K_ij = (dy_i.x_j)(C_i.B_j) E_ij: rows +, columns -),
//         the inter term, w and exp(cum_Q); ddt = its direct terms + A
//         times the reverse cumsum of dcum; dA = sum dt * that cumsum;
//         dD = sum dy . x; dB and dC summed over each group's heads.
//
// What bounds it on the H100.  At mamba2-2.7b's train micro-batch (b = 1,
// L = 2048, H = 80, P = 64, N = 128, G = 1, Q = 128) the function needs
// ~21.7 GFLOP per call in the chunked form: per head and chunk the
// recomputed state update and sum_i exp(cum_i) C_i^T dy_i (2.1 MFLOP
// each), dy_i . x_j over the triangle (1.1), dx's two terms (1.1 and
// 2.1), dC's and dB's (2.1 each, twice).  That is 0.022 ms at 989
// TFLOP/s against ~66 MB moved (x, dy and dx 21 MB each; B, C, dB, dC,
// dt, ddt): 0.020 ms at 3.35 TB/s, so operations and bytes are about
// even.  zamba2-1.2b's (H = 64, N = 64) needs ~9.7 GFLOP on ~51 MB:
// bytes, 0.015 ms.
//
// This first kernel is simple, not fast.  Its products run on the CUDA
// cores in f32 (67 TFLOP/s at most: 0.32 ms for 21.7 GFLOP), and it
// moves ~0.7 GB of f32 workspace beside its operands (each chunk's
// states S_n and dS', and per-head dB and dC before the sum over a
// group).  Four launches on the caller's stream, none with atomics, each
// sum in a fixed order, so two calls give the same bits:
//   states  per (chain, chunk): the chunk's own state update
//           sum_j w_j B_j^T x_j and sum_i exp(cum_i) C_i^T dy_i, f32 (N, P)
//           each, and the chunk decay exp(cum_Q), to the workspace.
//   walk    per (chain, state element): S_n walking forward and dS'
//           walking back, in place over the two.
//   chunk   per (chain, chunk), one block an SM (~208 KB of shared
//           memory at N = 128): x, dy, B and C staged in bf16; M, Z and K
//           over the triangle in f32; then dC (S_n staged), dB and dx
//           (dS' staged), each thread 4 rows by N / 32 or P / 32
//           columns; then dcum's reverse cumsum in one warp.  dx and ddt
//           are written final, dB and dC per head, dA and dD per chunk.
//   reduce  dB and dC summed over each group's heads in head order,
//           rounded once to bf16; dA and dD over (batch, chunk) in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int QM = 128;       // largest chunk
constexpr int P = 64;         // head dim
constexpr int NT = 256;       // threads a block
constexpr int NW = NT / 32;
constexpr int XS = P + 4;     // row stride of the x and dy tiles (elements):
                              // 136 bytes, an odd count of 8-byte words, so
                              // lanes on consecutive rows hit distinct banks
constexpr int TRI = QM * (QM + 1) / 2;   // the triangle j <= i, packed

template <int N>
struct Lay {                  // byte offsets of the chunk kernel's smem
  static constexpr int BS = N + 4;       // row stride of B and C (elements)
  static constexpr int SS = P + 4;       // row stride of a staged f32 state
  static constexpr size_t x = 0;                          // bf16 [QM][XS]
  static constexpr size_t dy = x + QM * XS * 2;           // bf16 [QM][XS]
  static constexpr size_t b = dy + QM * XS * 2;           // bf16 [QM][BS]
  static constexpr size_t c = b + QM * BS * 2;            // bf16 [QM][BS]
  static constexpr size_t m = c + QM * BS * 2;            // f32 triangle
  static constexpr size_t z = m + TRI * 4;                // f32 triangle
  static constexpr size_t s = z + TRI * 4;                // f32 [N][SS] or K
  static constexpr size_t sbytes = size_t(N * SS > TRI ? N * SS : TRI) * 4;
  static constexpr size_t vec = s + sbytes;               // f32 [NV][QM]
  static constexpr int NV = 9;
  static constexpr size_t red = vec + NV * QM * 4;        // f32 [NW + 1]
  static constexpr size_t bytes = red + (NW + 1) * 4;
  // the states kernel: the four tiles, then its vectors
  static constexpr size_t vec_a = m;
  static constexpr size_t bytes_a = m + 4 * QM * 4;
};
// vectors, by index into the [NV][QM] block
enum { V_DT, V_CUM, V_ECUM, V_W, V_ROWK, V_COLK, V_U, V_R, V_GD };

struct Args {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  const float* D;
  const bf16* dy;
  bf16* dx;       // (b, L, H, P) contiguous
  float* ddt;     // (b, L, H) contiguous
  float* dA;      // (H,)
  bf16* dB;       // (b, L, G, N) contiguous
  bf16* dC;
  float* dD;      // (H,)
  int batch, H, G, L, Q, nc;
  long long sxb, sxl, sxh, sdb, sdl, sdh, sbb, sbl, sbg, scb, scl, scg,
      syb, syl, syh;
  // workspace: S_n and dS' (f32 [chains][nc][N][P] each), per-head dB and
  // dC (f32 [b][L][H][N] each), per (chain, chunk) decay, dA and dD parts
  float *ws_s, *ws_ds, *ws_db, *ws_dc, *ws_g, *ws_pa, *ws_pd;
};

__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// four bf16 at an 8-byte aligned shared address, as floats
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// eight bf16 from global memory (16 bytes, aligned) into a shared row,
// zeros where the row is past the chunk; two 8-byte stores (shared rows
// are 8-byte aligned)
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src,
                                       bool valid) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (valid) v = __ldg(reinterpret_cast<const uint4*>(src));
  uint2* d = reinterpret_cast<uint2*>(dst);
  d[0] = make_uint2(v.x, v.y);
  d[1] = make_uint2(v.z, v.w);
}

// Stage chunk n of chain (bi, h): x, dy, B and C rows into shared memory
// (rows past Q zero), dt, the inclusive cumsum of dt * A, exp(cum) and the
// state update's weights w.  Ends with __syncthreads().
template <int N>
__device__ void stage_chunk(const Args& a, int bi, int h, int n,
                            unsigned char* smem, size_t vec_off) {
  using L = Lay<N>;
  constexpr int BS = L::BS;
  bf16* xs = reinterpret_cast<bf16*>(smem + L::x);
  bf16* dys = reinterpret_cast<bf16*>(smem + L::dy);
  bf16* bs = reinterpret_cast<bf16*>(smem + L::b);
  bf16* cs = reinterpret_cast<bf16*>(smem + L::c);
  float* vec = reinterpret_cast<float*>(smem + vec_off);
  const int Q = a.Q, tid = threadIdx.x;
  const long long l0 = (long long)n * Q;
  const int grp = h / (a.H / a.G);
  for (int e = tid; e < QM * (P / 8); e += NT) {
    const int j = e / (P / 8), k = (e % (P / 8)) * 8;
    const long long l = l0 + j;
    copy16(xs + j * XS + k, a.x + bi * a.sxb + l * a.sxl + h * a.sxh + k,
           j < Q);
    copy16(dys + j * XS + k, a.dy + bi * a.syb + l * a.syl + h * a.syh + k,
           j < Q);
  }
  for (int e = tid; e < QM * (N / 8); e += NT) {
    const int j = e / (N / 8), k = (e % (N / 8)) * 8;
    const long long l = l0 + j;
    copy16(bs + j * BS + k, a.B + bi * a.sbb + l * a.sbl + grp * a.sbg + k,
           j < Q);
    copy16(cs + j * BS + k, a.C + bi * a.scb + l * a.scl + grp * a.scg + k,
           j < Q);
  }
  float* dtv = vec + V_DT * QM;
  if (tid < QM)
    dtv[tid] = tid < Q ? __ldg(a.dt + bi * a.sdb + (l0 + tid) * a.sdl +
                               h * a.sdh)
                       : 0.f;
  __syncthreads();
  if (tid < 32) {  // one warp: 4 rows a lane, then a warp scan
    const int lane = tid;
    const float Ah = __ldg(a.A + h);
    float part[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run += dtv[4 * lane + k] * Ah;
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
    float* cum = vec + V_CUM * QM;
#pragma unroll
    for (int k = 0; k < 4; ++k) cum[4 * lane + k] = excl + part[k];
    __syncwarp();
    const float last = cum[Q - 1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      vec[V_ECUM * QM + i] = expf(cum[i]);
      vec[V_W * QM + i] = expf(last - cum[i]) * dtv[i];
    }
  }
  __syncthreads();
}

// ---- launch 1: each chunk's own state update and dS contribution -------
template <int N>
__global__ void __launch_bounds__(NT) ssd_bwd_states(const Args a) {
  using L = Lay<N>;
  constexpr int BS = L::BS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  stage_chunk<N>(a, bi, h, n, smem, L::vec_a);
  const bf16* xs = reinterpret_cast<const bf16*>(smem + L::x);
  const bf16* dys = reinterpret_cast<const bf16*>(smem + L::dy);
  const bf16* bs = reinterpret_cast<const bf16*>(smem + L::b);
  const bf16* cs = reinterpret_cast<const bf16*>(smem + L::c);
  const float* vec = reinterpret_cast<const float*>(smem + L::vec_a);
  const float* ecum = vec + V_ECUM * QM;
  const float* w = vec + V_W * QM;
  const int Q = a.Q, tid = threadIdx.x;
  const size_t chain = (size_t)bi * a.H + h;
  float* gs = a.ws_s + (chain * a.nc + n) * N * P;
  float* gd = a.ws_ds + (chain * a.nc + n) * N * P;
  // 4 x 4 tiles of (N, P): 16 column groups a row group
  for (int t = tid; t < (N / 4) * (P / 4); t += NT) {
    const int s0 = (t / (P / 4)) * 4, p0 = (t % (P / 4)) * 4;
    float as[4][4] = {}, ad[4][4] = {};
    for (int j = 0; j < Q; ++j) {
      const float4 bv = ld4(bs + j * BS + s0), xv = ld4(xs + j * XS + p0);
      const float4 cv = ld4(cs + j * BS + s0), dv = ld4(dys + j * XS + p0);
      const float wj = w[j], ej = ecum[j];
      const float bw[4] = {bv.x * wj, bv.y * wj, bv.z * wj, bv.w * wj};
      const float ce[4] = {cv.x * ej, cv.y * ej, cv.z * ej, cv.w * ej};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float da[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          as[r][q] = fmaf(bw[r], xa[q], as[r][q]);
          ad[r][q] = fmaf(ce[r], da[q], ad[r][q]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(gs + (s0 + r) * P + p0) =
          make_float4(as[r][0], as[r][1], as[r][2], as[r][3]);
      *reinterpret_cast<float4*>(gd + (s0 + r) * P + p0) =
          make_float4(ad[r][0], ad[r][1], ad[r][2], ad[r][3]);
    }
  }
  if (tid == 0) a.ws_g[chain * a.nc + n] = expf(vec[V_CUM * QM + Q - 1]);
}

// ---- launch 2: S_n walking forward, dS' walking back, per element -------
// Four elements a thread (float4) and four chunks' loads issued before
// their updates, so a thread keeps 256 bytes in flight where a plain
// walk waited on each load in turn.
constexpr int WALK_UNROLL = 4;

__device__ __forceinline__ float4 fma4(float g, float4 s, float4 t) {
  return make_float4(fmaf(g, s.x, t.x), fmaf(g, s.y, t.y), fmaf(g, s.z, t.z),
                     fmaf(g, s.w, t.w));
}

__global__ void __launch_bounds__(NT)
ssd_bwd_walk(float* __restrict__ ws_s, float* __restrict__ ws_ds,
             const float* __restrict__ ws_g, int nc, int npe4) {
  const int e = blockIdx.x * NT + threadIdx.x;   // a float4 of the state
  if (e >= npe4) return;
  const size_t chain = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  float4* ps = reinterpret_cast<float4*>(ws_s) + chain * nc * npe4 + e;
  float4* pd = reinterpret_cast<float4*>(ws_ds) + chain * nc * npe4 + e;
  const float* g = ws_g + chain * nc;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = 0; n0 < nc; n0 += WALK_UNROLL) {   // slot n: own -> S_n
    float4 t[WALK_UNROLL];
    float gn[WALK_UNROLL];
#pragma unroll
    for (int k = 0; k < WALK_UNROLL; ++k)
      if (n0 + k < nc) {
        t[k] = ps[(size_t)(n0 + k) * npe4];
        gn[k] = g[n0 + k];
      }
#pragma unroll
    for (int k = 0; k < WALK_UNROLL; ++k)
      if (n0 + k < nc) {
        ps[(size_t)(n0 + k) * npe4] = S;
        S = fma4(gn[k], S, t[k]);
      }
  }
  float4 dS = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = nc - 1; n0 >= 0; n0 -= WALK_UNROLL) {   // own -> dS'
    float4 t[WALK_UNROLL];
    float gn[WALK_UNROLL];
#pragma unroll
    for (int k = 0; k < WALK_UNROLL; ++k)
      if (n0 - k >= 0) {
        t[k] = pd[(size_t)(n0 - k) * npe4];
        gn[k] = g[n0 - k];
      }
#pragma unroll
    for (int k = 0; k < WALK_UNROLL; ++k)
      if (n0 - k >= 0) {
        pd[(size_t)(n0 - k) * npe4] = dS;
        dS = fma4(gn[k], dS, t[k]);
      }
  }
}

// the k-th row group (4 rows) warp `warp` takes of `ngroups`: forward and
// back in turns, so every warp's rows of the triangle come to about the
// same work
__device__ __forceinline__ int row_group(int k, int warp) {
  return (k & 1) ? k * NW + NW - 1 - warp : k * NW + warp;
}

// ---- launch 3: a chunk's gradients ---------------------------------------
template <int N>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_chunk(const Args a) {
  using L = Lay<N>;
  constexpr int BS = L::BS, SS = L::SS, NS = N / 32, PS = P / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  stage_chunk<N>(a, bi, h, n, smem, L::vec);
  const bf16* xs = reinterpret_cast<const bf16*>(smem + L::x);
  const bf16* dys = reinterpret_cast<const bf16*>(smem + L::dy);
  const bf16* bs = reinterpret_cast<const bf16*>(smem + L::b);
  const bf16* cs = reinterpret_cast<const bf16*>(smem + L::c);
  float* mt = reinterpret_cast<float*>(smem + L::m);
  float* zt = reinterpret_cast<float*>(smem + L::z);
  float* sb = reinterpret_cast<float*>(smem + L::s);
  float* kt = sb;   // K's triangle, until the states are staged
  float* vec = reinterpret_cast<float*>(smem + L::vec);
  float* red = reinterpret_cast<float*>(smem + L::red);
  const float* dtv = vec + V_DT * QM;
  const float* cum = vec + V_CUM * QM;
  const float* ecum = vec + V_ECUM * QM;
  const float* w = vec + V_W * QM;
  float* rowk = vec + V_ROWK * QM;
  float* colk = vec + V_COLK * QM;
  float* uv = vec + V_U * QM;
  float* rv = vec + V_R * QM;
  float* gd = vec + V_GD * QM;
  const int Q = a.Q, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ngroups = (Q + 3) / 4;
  const float last = cum[Q - 1];
  const size_t chain = (size_t)bi * a.H + h;
  const float* gS = a.ws_s + (chain * a.nc + n) * N * P;
  const float* gdS = a.ws_ds + (chain * a.nc + n) * N * P;
  const long long l0 = (long long)n * Q;

  // ---- C_i . B_j and dy_i . x_j over the triangle: M, Z, K ---------------
  // a warp's 4 rows against 32 columns a lane each, block by block
  for (int k = 0; k * NW < ngroups; ++k) {
    const int ig = row_group(k, warp);
    if (ig >= ngroups) continue;
    const int i0 = 4 * ig, imax = min(i0 + 3, Q - 1);
    for (int jb = 0; jb * 32 <= imax; ++jb) {
      const int j = jb * 32 + lane;
      if (j > imax) continue;
      float cb[4] = {}, gm[4] = {};
      for (int s = 0; s < N; s += 4) {
        const float4 bv = ld4(bs + j * BS + s);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cb[r] = dot4(cb[r], ld4(cs + (i0 + r) * BS + s), bv);
      }
      for (int p = 0; p < P; p += 4) {
        const float4 xv = ld4(xs + j * XS + p);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          gm[r] = dot4(gm[r], ld4(dys + (i0 + r) * XS + p), xv);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i < Q && j <= i) {
          const float e = expf(cum[i] - cum[j]), dj = dtv[j];
          const int t = tri(i) + j;
          mt[t] = cb[r] * e * dj;
          zt[t] = gm[r] * e * dj;
          kt[t] = gm[r] * cb[r] * e;
          if (j == i) gd[i] = gm[r];
        }
      }
    }
  }
  __syncthreads();
  // ---- K's rows weighted by dt_j, and its columns ------------------------
  if (tid < QM) {
    float acc = 0.f;
    if (tid < Q)
      for (int j = 0; j <= tid; ++j) acc = fmaf(kt[tri(tid) + j], dtv[j], acc);
    rowk[tid] = acc;
  } else {
    const int j = tid - QM;
    float acc = 0.f;
    if (j < Q)
      for (int i = j; i < Q; ++i) acc += kt[tri(i) + j];
    colk[j] = acc;
  }
  __syncthreads();

  // ---- S_n staged; dC = sum_{j<=i} Z_ij B_j + exp(cum_i) S_n dy_i --------
  float sdot = 0.f;   // <S_n, dS'>
  for (int e = tid; e < N * P / 4; e += NT) {
    const int s = e / (P / 4), p = (e % (P / 4)) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(gS) + e);
    const float4 d = __ldg(reinterpret_cast<const float4*>(gdS) + e);
    *reinterpret_cast<float4*>(sb + s * SS + p) = v;
    sdot = dot4(sdot, v, d);
  }
  sdot = warp_sum(sdot);
  if (lane == 0) red[warp] = sdot;
  __syncthreads();
  for (int k = 0; k * NW < ngroups; ++k) {
    const int ig = row_group(k, warp);
    if (ig >= ngroups) continue;
    const int i0 = 4 * ig;
    float acc[4][NS] = {};
    for (int p = 0; p < P; p += 4) {
      float4 dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = ld4(dys + (i0 + r) * XS + p);
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float4 sv =
            *reinterpret_cast<const float4*>(sb + (lane + 32 * q) * SS + p);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][q] = dot4(acc[r][q], dv[r], sv);
      }
    }
    float up[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = ecum[i0 + r];
      up[r] = 0.f;
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        acc[r][q] *= e;
        up[r] = fmaf(__bfloat162float(cs[(i0 + r) * BS + lane + 32 * q]),
                     acc[r][q], up[r]);
      }
      up[r] = warp_sum(up[r]);
    }
    const int jmax = min(i0 + 3, Q - 1);
    for (int j = 0; j <= jmax; ++j) {
      float z[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        z[r] = (j <= i0 + r && i0 + r < Q) ? zt[tri(i0 + r) + j] : 0.f;
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float bv = __bfloat162float(bs[j * BS + lane + 32 * q]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][q] = fmaf(z[r], bv, acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      if (i >= Q) continue;
      if (lane == 0) uv[i] = up[r];
      float* o = a.ws_dc + (((size_t)bi * a.L + l0 + i) * a.H + h) * N;
#pragma unroll
      for (int q = 0; q < NS; ++q) o[lane + 32 * q] = acc[r][q];
    }
  }
  __syncthreads();   // every warp is done with S_n
  if (tid == 0) {
    float t = 0.f;
    for (int k = 0; k < NW; ++k) t += red[k];
    red[NW] = t;
  }
  // ---- dS' staged; dB and dx ---------------------------------------------
  for (int e = tid; e < N * P / 4; e += NT) {
    const int s = e / (P / 4), p = (e % (P / 4)) * 4;
    *reinterpret_cast<float4*>(sb + s * SS + p) =
        __ldg(reinterpret_cast<const float4*>(gdS) + e);
  }
  __syncthreads();
  for (int k = 0; k * NW < ngroups; ++k) {
    const int jg = row_group(k, warp);
    if (jg >= ngroups) continue;
    const int j0 = 4 * jg;
    // dB_j = w_j dS' x_j + sum_{i>=j} Z_ij C_i
    float acc[4][NS] = {};
    for (int p = 0; p < P; p += 4) {
      float4 xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = ld4(xs + (j0 + r) * XS + p);
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float4 sv =
            *reinterpret_cast<const float4*>(sb + (lane + 32 * q) * SS + p);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][q] = dot4(acc[r][q], xv[r], sv);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r;
      float rp = 0.f;
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        rp = fmaf(__bfloat162float(bs[j * BS + lane + 32 * q]), acc[r][q],
                  rp);
        acc[r][q] *= w[j];
      }
      rp = warp_sum(rp);
      if (lane == 0 && j < Q) rv[j] = expf(last - cum[j]) * rp;
    }
    for (int i = j0; i < Q; ++i) {
      float z[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        z[r] = i >= j0 + r ? zt[tri(i) + j0 + r] : 0.f;
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float cv = __bfloat162float(cs[i * BS + lane + 32 * q]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][q] = fmaf(z[r], cv, acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r;
      if (j >= Q) continue;
      float* o = a.ws_db + (((size_t)bi * a.L + l0 + j) * a.H + h) * N;
#pragma unroll
      for (int q = 0; q < NS; ++q) o[lane + 32 * q] = acc[r][q];
    }
    // dx_j = w_j B_j dS' + sum_{i>=j} M_ij dy_i + D dy_j
    float ax[4][PS] = {};
    for (int s = 0; s < N; s += 2) {
      float ds0[PS], ds1[PS];
#pragma unroll
      for (int q = 0; q < PS; ++q) {
        ds0[q] = sb[s * SS + lane + 32 * q];
        ds1[q] = sb[(s + 1) * SS + lane + 32 * q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bs + (j0 + r) * BS + s));
#pragma unroll
        for (int q = 0; q < PS; ++q)
          ax[r][q] = fmaf(bv.y, ds1[q], fmaf(bv.x, ds0[q], ax[r][q]));
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < PS; ++q) ax[r][q] *= w[j0 + r];
    for (int i = j0; i < Q; ++i) {
      float m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        m[r] = i >= j0 + r ? mt[tri(i) + j0 + r] : 0.f;
#pragma unroll
      for (int q = 0; q < PS; ++q) {
        const float dv = __bfloat162float(dys[i * XS + lane + 32 * q]);
#pragma unroll
        for (int r = 0; r < 4; ++r) ax[r][q] = fmaf(m[r], dv, ax[r][q]);
      }
    }
    const float Dh = __ldg(a.D + h);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r;
      if (j >= Q) continue;
      bf16* o = a.dx + (((size_t)bi * a.L + l0 + j) * a.H + h) * P;
#pragma unroll
      for (int q = 0; q < PS; ++q) {
        const int p = lane + 32 * q;
        o[p] = __float2bfloat16_rn(
            fmaf(Dh, __bfloat162float(dys[j * XS + p]), ax[r][q]));
      }
    }
  }
  __syncthreads();
  // ---- dcum, its reverse cumsum, ddt, and the dA and dD parts (warp 0) --
  if (warp == 0) {
    const float Ah = __ldg(a.A + h);
    float dc[4], dd[4], vs = 0.f, gs = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      dc[k] = dd[k] = 0.f;
      if (i < Q) {
        const float v = rv[i] * dtv[i];
        dc[k] = rowk[i] - colk[i] * dtv[i] + uv[i] - v;
        dd[k] = colk[i] + rv[i];
        vs += v;
        gs += gd[i];
      }
    }
    vs = warp_sum(vs);
    gs = warp_sum(gs);
    // the last step's cum is exp(cum_Q)'s and every w_j's
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * lane + k == Q - 1) dc[k] += vs + expf(last) * red[NW];
    // reverse cumsum: within the lane's 4 rows, then across lanes
    float suf[4], run = 0.f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      run += dc[k];
      suf[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.f;
    float pa = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      if (i < Q) {
        const float da = excl + suf[k];
        a.ddt[((size_t)bi * a.L + l0 + i) * a.H + h] = fmaf(da, Ah, dd[k]);
        pa = fmaf(da, dtv[i], pa);
      }
    }
    pa = warp_sum(pa);
    if (lane == 0) {
      a.ws_pa[chain * a.nc + n] = pa;
      a.ws_pd[chain * a.nc + n] = gs;
    }
  }
}

// ---- launch 4: the sums over heads, batch rows and chunks ----------------
__global__ void __launch_bounds__(NT) ssd_bwd_reduce(const Args a, int N) {
  const int R = a.H / a.G;
  if (blockIdx.x == gridDim.x - 1) {   // dA and dD, (batch, chunk) in order
    for (int h = threadIdx.x; h < a.H; h += NT) {
      float sa = 0.f, sd = 0.f;
      for (int bi = 0; bi < a.batch; ++bi) {
        const size_t base = ((size_t)bi * a.H + h) * a.nc;
        for (int n = 0; n < a.nc; ++n) {
          sa += a.ws_pa[base + n];
          sd += a.ws_pd[base + n];
        }
      }
      a.dA[h] = sa;
      a.dD[h] = sd;
    }
    return;
  }
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t total = (size_t)a.batch * a.L * a.G * N;
  if (e >= total) return;
  const int s = e % N;
  const size_t row = e / N;            // (bi * L + l) * G + g
  const int g = row % a.G;
  const size_t bl = row / a.G;
  const float* pb = a.ws_db + (bl * a.H + (size_t)g * R) * N + s;
  const float* pc = a.ws_dc + (bl * a.H + (size_t)g * R) * N + s;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < R; ++k) {
    sb += pb[(size_t)k * N];
    sc += pc[(size_t)k * N];
  }
  a.dB[e] = __float2bfloat16_rn(sb);
  a.dC[e] = __float2bfloat16_rn(sc);
}

template <int N>
int launch_bwd(const Args& a, cudaStream_t s) {
  using L = Lay<N>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_chunk<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_states<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::bytes_a);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(a.nc, a.H, a.batch);
  ssd_bwd_states<N><<<grid, NT, L::bytes_a, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_walk<<<dim3((N * P / 4 + NT - 1) / NT, a.H, a.batch), NT, 0, s>>>(
      a.ws_s, a.ws_ds, a.ws_g, a.nc, N * P / 4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk<N><<<grid, NT, L::bytes, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)a.batch * a.L * a.G * N;
  ssd_bwd_reduce<<<(unsigned)((total + NT - 1) / NT + 1), NT, 0, s>>>(a, N);
  return (int)cudaGetLastError();
}

template <int N>
int bwd_info(int which, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes fa;
  cudaError_t e;
  int smem = 0;
  if (which == 0) {
    e = cudaFuncGetAttributes(&fa, ssd_bwd_states<N>);
    smem = (int)Lay<N>::bytes_a;
  } else if (which == 1) {
    e = cudaFuncGetAttributes(&fa, ssd_bwd_walk);
  } else if (which == 2) {
    e = cudaFuncGetAttributes(&fa, ssd_bwd_chunk<N>);
    smem = (int)Lay<N>::bytes;
  } else {
    e = cudaFuncGetAttributes(&fa, ssd_bwd_reduce);
  }
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *smem_bytes = smem;
  return 0;
}

}  // namespace

extern "C" {

// strides: 15 element strides, (batch, seq, head or group) for x, dt, B, C
// and dy in turn; x, B, C and dy have a unit last stride, 16-byte aligned
// bases and other strides multiples of 8 elements.  dx, ddt, dB and dC
// are written contiguous.  P must be 64, N 64 or 128, 1 <= Q <= 128 with
// L % Q == 0, H % G == 0.  work: ssd_bwd_workspace_words four-byte words
// (kernels/ssd_scan.py), any contents: every word is written before it is
// read.  Returns the first launch error (0 on success).
int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* D,
                       const void* dy, void* dx, void* ddt, void* dA,
                       void* dB, void* dC, void* dD, int batch, int L, int H,
                       int G, int P_, int N, int Q, const long long* st,
                       void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P_ != P || Q < 1 || Q > QM || L % Q || G < 1 || H % G || batch < 1 ||
      batch > 65535 || H > 65535 || (N != 64 && N != 128))
    return (int)cudaErrorInvalidValue;
  const int nc = L / Q;
  const size_t chains = (size_t)batch * H;
  float* w = static_cast<float*>(work);
  Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A), static_cast<const bf16*>(B),
         static_cast<const bf16*>(C), static_cast<const float*>(D),
         static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
         static_cast<float*>(ddt), static_cast<float*>(dA),
         static_cast<bf16*>(dB), static_cast<bf16*>(dC),
         static_cast<float*>(dD), batch, H, G, L, Q, nc,
         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
         st[9], st[10], st[11], st[12], st[13], st[14]};
  const size_t states = chains * nc * N * P, heads = (size_t)batch * L * H * N;
  a.ws_s = w;
  a.ws_ds = a.ws_s + states;
  a.ws_db = a.ws_ds + states;
  a.ws_dc = a.ws_db + heads;
  a.ws_g = a.ws_dc + heads;
  a.ws_pa = a.ws_g + chains * nc;
  a.ws_pd = a.ws_pa + chains * nc;
  return N == 128 ? launch_bwd<128>(a, s) : launch_bwd<64>(a, s);
}

// registers a thread, local (spill) bytes and dynamic shared memory a
// block of launch `which` (0 states, 1 walk, 2 chunk, 3 reduce) at state
// width N (64 or 128)
int repro_ssd_scan_bwd_info(int N, int which, int* regs, int* local_bytes,
                            int* smem_bytes) {
  if (N == 128) return bwd_info<128>(which, regs, local_bytes, smem_bytes);
  if (N == 64) return bwd_info<64>(which, regs, local_bytes, smem_bytes);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
