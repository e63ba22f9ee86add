// Flash attention backward for Hopper (sm_90a), bf16 in and out, f32 sums.
//
// Replaces the reference's flash-style backward _sdpa_chunked_bwd
// (src/repro/models/layers.py:563-602), the VJP that the JAX package
// trains its attention with.  Same function: given q (B,Sq,H,hd), k and v
// (B,Sk,Hk,hd) with kv_head (H,) naming the K/V head each q head reads,
// the forward's output o, its cotangent do and the forward's row
// log-sum-exp lse (B,H,Sq), return dq in q's shape and dk, dv in k's:
//   P = exp(Q K^T / sqrt(hd) - lse), causal mask kpos <= qpos aligned
//   top-left, dV = P^T dO, dP = dO V^T, dS = P (dP - delta) with
//   delta = rowsum(dO o O), dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd);
// dK and dV of a K/V head sum over the q heads that kv_head maps to it.
//
// What bounds it on the H100: operations.  A call does 2.5 times the
// forward's products, 10 B S^2 H hd (half that causal), on the same few
// tensors, far above the card's ~295 FLOP/byte ridge; the products run on
// the tensor cores.
//
// Design, the FlashAttention-2 backward without atomics, in three
// launches:
//   delta   one thread a (batch, row, head): rowsum(dO o O) in f32;
//   dK/dV   a block of four warps a (batch, K/V head, 64-key tile): K and V
//           of the tile stay in shared memory while the block walks the
//           64-row q tiles of every q head mapped to that K/V head, in
//           head order, skipping the tiles above the causal diagonal; a
//           warp owns 16 keys and recomputes P^T = exp2(K Q^T c - lse)
//           for them, then dV += P^T dO, dP^T = V dO^T and dK += dS^T Q,
//           all as mma.sync m16n8k16 (bf16 operands, f32 accumulators in
//           registers; P and dS rounded to bf16 for their products);
//   dQ      a block a (batch, q head, 64-row q tile): Q, dO, lse and delta
//           of the tile in shared memory while it walks the key tiles up to
//           the diagonal; a warp owns 16 rows: S = Q K^T, dP = dO V^T and
//           dQ += dS K.
// Each output element is summed by one warp in a fixed order, so two runs
// give the same bits.  Tiles go through shared memory in rows padded by 8
// elements (16 bytes), so the ldmatrix loads of a warp hit distinct banks.
// A simple kernel: plain 16-byte loads with a __syncthreads between tiles,
// no TMA, no wgmma and no overlap of loads with products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;                 // keys or q rows of a tile
constexpr int WARPS = 4;                 // 16 rows (or keys) a warp
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct BwdCfg {
  static constexpr int LD = HD + 8;      // padded row, in elements
  static constexpr int TILE_ELEMS = TILE * LD;
  // four tiles (K, V and Q, dO; or Q, dO and K, V) and 2 x 64 f32 rows
  static constexpr size_t SMEM = 4 * TILE_ELEMS * sizeof(bf16) +
                                 2 * TILE * sizeof(float);
};

// rows [r0, r0 + 64) of a (batch b, head h) slice of a strided bf16 tensor
// into a padded shared tile; rows past ``n`` read as zeros
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long sb, long long ss,
                                          long long sh, int b, int h, int r0,
                                          int n) {
  constexpr int PACKS = HD / 8;          // 16-byte packs a row
  for (int i = threadIdx.x; i < TILE * PACKS; i += THREADS) {
    const int r = i / PACKS, c = (i % PACKS) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + b * sb + (long long)(r0 + r) * ss +
                                          h * sh + c);
    *reinterpret_cast<uint4*>(dst + r * BwdCfg<HD>::LD + c) = v;
  }
}

// c[j] (16 x 8 tile j of a 16 x 8*NT product) += A (16 rows of ``a`` from
// row ``ar`` on, the reduction over HD columns) times the rows
// [0, 8*NT) of ``b`` (n along b's rows, the reduction along its columns)
template <int HD, int NT>
__device__ __forceinline__ void mma_rows_rows(float (*c)[4], const bf16* a,
                                              int ar, const bf16* b,
                                              int lane) {
  using hopper::ldsm_x4;
  using hopper::mma16816;
  using hopper::smem_u32;
  constexpr int LD = BwdCfg<HD>::LD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(smem_u32(a + (ar + lane % 16) * LD + 16 * kk + 8 * (lane / 16)),
            af);
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bfr[4];
      ldsm_x4(smem_u32(b + (16 * n2 + lane % 8 + 8 * (lane / 16)) * LD +
                       16 * kk + 8 * ((lane / 8) % 2)),
              bfr);
      mma16816(c[2 * n2], af, bfr[0], bfr[1]);
      mma16816(c[2 * n2 + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc (16 x HD, HD/8 tiles) += P (16 x 64 in registers: the accumulators
// of a 16 x 64 product, the reduction over its 64 columns) times rows
// [0, 64) of ``b`` (the reduction along b's rows, n along its columns)
template <int HD>
__device__ __forceinline__ void mma_regs_cols(float (*acc)[4],
                                              float (*p)[4],
                                              const bf16* b, int lane) {
  using hopper::ldsm_x4_t;
  using hopper::mma16816;
  using hopper::pack_bf16x2;
  using hopper::smem_u32;
  constexpr int LD = BwdCfg<HD>::LD;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      uint32_t bfr[4];
      ldsm_x4_t(smem_u32(b + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                         16 * n2 + 8 * (lane / 16)),
                bfr);
      mma16816(acc[2 * n2], af, bfr[0], bfr[1]);
      mma16816(acc[2 * n2 + 1], af, bfr[2], bfr[3]);
    }
  }
}

// 16 x HD accumulators (rows ``row0 + lane/4 (+8)``) times ``scale`` as
// bf16 into a strided tensor, rows past ``n`` dropped
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, float (*acc)[4],
                                           float scale, long long sb,
                                           long long ss, long long sh, int b,
                                           int h, int row0, int n, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + lane / 4 + 8 * i;
    if (r >= n) continue;
    bf16* out = dst + b * sb + (long long)r * ss + h * sh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * (lane % 4)) =
          hopper::pack_bf16x2(acc[j][2 * i] * scale,
                              acc[j][2 * i + 1] * scale);
  }
}

// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in f32
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                       float* __restrict__ delta, int B, int S, int H,
                       long long osb, long long oss, long long osh,
                       long long dsb, long long dss, long long dsh) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * S * H) return;
  const int h = (int)(i % H), s = (int)((i / H) % S), b = (int)(i / H / S);
  const bf16* orow = o + b * osb + (long long)s * oss + h * osh;
  const bf16* drow = dO + b * dsb + (long long)s * dss + h * dsh;
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < HD; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
    const bf16* op = reinterpret_cast<const bf16*>(&ov);
    const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc = fmaf(__bfloat162float(op[e]), __bfloat162float(dp[e]), acc);
  }
  delta[((long long)b * H + h) * S + s] = acc;
}

struct Strides {            // element strides (batch, seq, head)
  long long b, s, h;
};

struct BwdArgs {
  const bf16 *q, *k, *v, *dO;
  const float *lse, *delta;
  const int* kv_head;
  bf16 *dq, *dk, *dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int B, H, Hk, Sq, Sk, causal;
  float scale, scale_log2;
};

// one block a (batch, K/V head, 64-key tile)
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const BwdArgs a) {
  using C = BwdCfg<HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + C::TILE_ELEMS;
  bf16* sQ = sV + C::TILE_ELEMS;
  bf16* sD = sQ + C::TILE_ELEMS;
  float* sL = reinterpret_cast<float*>(sD + C::TILE_ELEMS);   // lse, log2
  float* sDel = sL + TILE;

  const int n_kt = (a.Sk + TILE - 1) / TILE;
  const int kt = blockIdx.x % n_kt;
  const int kvh = (blockIdx.x / n_kt) % a.Hk;
  const int b = blockIdx.x / n_kt / a.Hk;
  const int n0 = kt * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw0 = warp * 16;               // this warp's keys in the tile

  load_tile<HD>(sK, a.k, a.sk.b, a.sk.s, a.sk.h, b, kvh, n0, a.Sk);
  load_tile<HD>(sV, a.v, a.sv.b, a.sv.s, a.sv.h, b, kvh, n0, a.Sk);

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int n_qt = (a.Sq + TILE - 1) / TILE;
  const int qt0 = a.causal ? n0 / TILE : 0;   // tiles above the diagonal
  for (int h = 0; h < a.H; ++h) {
    if (a.kv_head[h] != kvh) continue;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int m0 = qt * TILE;
      __syncthreads();                     // the last tile's reads are done
      load_tile<HD>(sQ, a.q, a.sq.b, a.sq.s, a.sq.h, b, h, m0, a.Sq);
      load_tile<HD>(sD, a.dO, a.sdo.b, a.sdo.s, a.sdo.h, b, h, m0, a.Sq);
      if (threadIdx.x < TILE) {
        const int r = m0 + threadIdx.x;
        const size_t at = ((size_t)b * a.H + h) * a.Sq + r;
        sL[threadIdx.x] = r < a.Sq ? a.lse[at] * LOG2E : INFINITY;
        sDel[threadIdx.x] = r < a.Sq ? a.delta[at] : 0.f;
      }
      __syncthreads();

      // P^T = exp2(K Q^T c - lse): 16 keys x 64 q rows
      float p[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
      mma_rows_rows<HD, 8>(p, sK, kw0, sQ, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + kw0 + lane / 4 + 8 * (e / 2);
          const int qr = 8 * j + 2 * (lane % 4) + (e % 2);
          const float x = exp2f(fmaf(p[j][e], a.scale_log2, -sL[qr]));
          p[j][e] = (a.causal && key > m0 + qr) ? 0.f : x;
        }
      // dV += P^T dO
      mma_regs_cols<HD>(dv, p, sD, lane);
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
      float ds[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
      mma_rows_rows<HD, 8>(ds, sV, kw0, sD, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = 8 * j + 2 * (lane % 4) + (e % 2);
          ds[j][e] = p[j][e] * (ds[j][e] - sDel[qr]);
        }
      // dK += dS^T Q
      mma_regs_cols<HD>(dk, ds, sQ, lane);
    }
  }
  store_rows<HD>(a.dk, dk, a.scale, a.sdk.b, a.sdk.s, a.sdk.h, b, kvh,
                 n0 + kw0, a.Sk, lane);
  store_rows<HD>(a.dv, dv, 1.f, a.sdv.b, a.sdv.s, a.sdv.h, b, kvh, n0 + kw0,
                 a.Sk, lane);
}

// one block a (batch, q head, 64-row q tile)
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const BwdArgs a) {
  using C = BwdCfg<HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sD = sQ + C::TILE_ELEMS;
  bf16* sK = sD + C::TILE_ELEMS;
  bf16* sV = sK + C::TILE_ELEMS;
  float* sL = reinterpret_cast<float*>(sV + C::TILE_ELEMS);
  float* sDel = sL + TILE;

  const int n_qt = (a.Sq + TILE - 1) / TILE;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % a.H;
  const int b = blockIdx.x / n_qt / a.H;
  const int m0 = qt * TILE;
  const int kvh = a.kv_head[h];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw0 = warp * 16;               // this warp's rows in the tile

  load_tile<HD>(sQ, a.q, a.sq.b, a.sq.s, a.sq.h, b, h, m0, a.Sq);
  load_tile<HD>(sD, a.dO, a.sdo.b, a.sdo.s, a.sdo.h, b, h, m0, a.Sq);
  if (threadIdx.x < TILE) {
    const int r = m0 + threadIdx.x;
    const size_t at = ((size_t)b * a.H + h) * a.Sq + r;
    sL[threadIdx.x] = r < a.Sq ? a.lse[at] * LOG2E : INFINITY;
    sDel[threadIdx.x] = r < a.Sq ? a.delta[at] : 0.f;
  }

  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const int n_end = a.causal ? min(a.Sk, m0 + TILE) : a.Sk;
  const int n_kt = (n_end + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int n0 = kt * TILE;
    __syncthreads();
    load_tile<HD>(sK, a.k, a.sk.b, a.sk.s, a.sk.h, b, kvh, n0, a.Sk);
    load_tile<HD>(sV, a.v, a.sv.b, a.sv.s, a.sv.h, b, kvh, n0, a.Sk);
    __syncthreads();

    // P = exp2(Q K^T c - lse): 16 rows x 64 keys
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    mma_rows_rows<HD, 8>(p, sQ, qw0, sK, lane);
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    mma_rows_rows<HD, 8>(ds, sD, qw0, sV, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = qw0 + lane / 4 + 8 * (e / 2);
        const int key = n0 + 8 * j + 2 * (lane % 4) + (e % 2);
        const float x = exp2f(fmaf(p[j][e], a.scale_log2, -sL[qr]));
        const bool keep = key < a.Sk && !(a.causal && key > m0 + qr);
        ds[j][e] = keep ? x * (ds[j][e] - sDel[qr]) : 0.f;
      }
    // dQ += dS K
    mma_regs_cols<HD>(dq, ds, sK, lane);
  }
  store_rows<HD>(a.dq, dq, a.scale, a.sdq.b, a.sdq.s, a.sdq.h, b, h,
                 m0 + qw0, a.Sq, lane);
}

template <int HD>
int launch_bwd(const BwdArgs& a, float* delta, const bf16* o, Strides so,
               cudaStream_t stream) {
  using C = BwdCfg<HD>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_bwd_delta_kernel<HD><<<(unsigned)((rows + 255) / 256), 256, 0,
                               stream>>>(o, a.dO, delta, a.B, a.Sq, a.H, so.b,
                                         so.s, so.h, a.sdo.b, a.sdo.s,
                                         a.sdo.h);
  const int n_kt = (a.Sk + TILE - 1) / TILE;
  const int n_qt = (a.Sq + TILE - 1) / TILE;
  flash_bwd_dkdv_kernel<HD>
      <<<a.B * a.Hk * n_kt, THREADS, C::SMEM, stream>>>(a);
  flash_bwd_dq_kernel<HD><<<a.B * a.H * n_qt, THREADS, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_info(int which, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(
      &attr, which == 0 ? (const void*)flash_bwd_dkdv_kernel<HD>
                        : (const void*)flash_bwd_dq_kernel<HD>);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)BwdCfg<HD>::SMEM;
  return 0;
}

}  // namespace

extern "C" {

// strides: 24 element strides, (batch, seq, head) for q, k, v, o, do, dq,
// dk, dv in turn; every tensor needs a unit hd stride, 16-byte aligned
// bases and strides that are multiples of 8 elements.  lse: the forward's
// (B, H, Sq) f32 log-sum-exp; delta: (B, H, Sq) f32 scratch.  dk and dv
// are written whole (every key row of every K/V head), so they need no
// zero fill.  Returns cudaGetLastError() after the launches.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dO, const void* lse,
                              const void* kv_head, void* delta, void* dq,
                              void* dk, void* dv, int B, int H, int Hk,
                              int Sq, int Sk, int hd,
                              const long long* st, int causal, float scale,
                              void* stream) {
  if (B < 1 || H < 1 || Hk < 1 || Sq < 1 || Sk < 1 ||
      (long long)B * H * ((Sq + TILE - 1) / TILE) > 0x7fffffffLL ||
      (long long)B * Hk * ((Sk + TILE - 1) / TILE) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dO = static_cast<const bf16*>(dO);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.kv_head = static_cast<const int*>(kv_head);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sq = {st[0], st[1], st[2]};
  a.sk = {st[3], st[4], st[5]};
  a.sv = {st[6], st[7], st[8]};
  const Strides so = {st[9], st[10], st[11]};
  a.sdo = {st[12], st[13], st[14]};
  a.sdq = {st[15], st[16], st[17]};
  a.sdk = {st[18], st[19], st[20]};
  a.sdv = {st[21], st[22], st[23]};
  a.B = B;
  a.H = H;
  a.Hk = Hk;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  const bf16* ob = static_cast<const bf16*>(o);
  if (hd == 128) return launch_bwd<128>(a, d, ob, so, s);
  if (hd == 64) return launch_bwd<64>(a, d, ob, so, s);
  return (int)cudaErrorInvalidValue;
}

// registers a thread, local (spill) bytes and dynamic shared memory a
// block of the dK/dV (which 0) or dQ (which 1) kernel for head dim ``hd``
int repro_flash_attention_bwd_info(int hd, int which, int* regs,
                                   int* local_bytes, int* smem_bytes) {
  if (hd == 128) return bwd_info<128>(which, regs, local_bytes, smem_bytes);
  if (hd == 64) return bwd_info<64>(which, regs, local_bytes, smem_bytes);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
