// Backward of the chunked SSD scan (Mamba2) for Hopper (sm_90a): bf16 x,
// B, C and dy in; f32 dt, A, D.  Out: dx, dB, dC in bf16, ddt, dA, dD in
// f32.  Every chunk product runs on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate) with the forward's numerics: products of two
// bf16 operands (C B^T, dy x^T and their transposes) are exact, and every
// f32 operand (M, Z, the states S_n and dS', w o B, exp(cum) o C) enters
// as a bf16 high part and a bf16 low part, two products, ~2^-16 relative.
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
// ~21.7 GFLOP: 0.022 ms at 989 TFLOP/s, against ~66 MB of operands and
// results, 0.020 ms at 3.35 TB/s; zamba2-1.2b's (H = 64, N = 64) ~9.7
// GFLOP on ~51 MB: bytes, 0.015 ms.  The chunked form keeps the work
// linear in L, at the price of a walk over the chunks' states (S_n
// forward, dS' back) between two passes over the chunks, and the split
// products double every product with an f32 operand: ~9,700 mma.sync a
// head-chunk at N = 128 (states 2,048, chunk pass 7,680), ~12.4 M a call.
// So the chunk pass runs at the rate of mma.sync (the state terms at ~0.33
// mma a cycle an SM; the triangle's long rows run alone on their warp's
// scheduler), and the states pass and the walk move the slabs, 84 MB of
// them at that shape.  Measured on an H100 (tools/kernel_probes.py
// --probes ssd_bwd): ~0.31 ms a call there, ~0.17 ms at zamba2-1.2b's.
//
// Design.  Four launches on the caller's stream, no atomics, every sum in
// a fixed order, so two calls give the same bits.  The states and chunk
// passes run one block of eight warps per unit: a batch row, a chunk, and
// a set of consecutive heads of one group (ssd_bwd_geometry in
// kernels/ssd_scan.py picks the sets so that the busiest SM runs the
// fewest head-chunks), so a unit loads its chunk's B and C once (TMA, the
// 128-byte swizzle) for all its heads and streams each head's x and dy
// (and state tiles) through a two-stage ring of TMA and bulk copies.
//   states  per unit and head: the chunk's own state update (w o B)^T x
//           and sum_i exp(cum_i) C_i^T dy_i on the tensor cores, f32 (N,
//           P) each, staged in shared memory as f32 pairs at the places
//           their bf16 high and low parts will take in the head's
//           workspace slabs and written out in one bulk store that drains
//           under the next head's products; and the chunk decay.
//   walk    per (chain, 4 state elements): S_n walking forward and dS'
//           walking back, each slab rewritten in place (a thread reads
//           only the 16 bytes it then writes) as a bf16 high tile and a
//           bf16 low tile of N rows by 128 bytes in the 128-byte swizzle,
//           ready for a bulk copy and ldmatrix; <S_n, dS'> per warp, from
//           the last 16 chunks' S_n kept in registers (the rest read back).
//   chunk   per unit, the heads in order twice: first with S_n staged
//           (phase I: dC, with the rows i of the triangle), then with dS'
//           staged (phase J: dx and dB, with the rows j).  Warp w owns
//           row tile t = 7 - w or w - 4 (the two warps of a scheduler
//           hold t and 7 - t) and keeps dC (then dB) of its 16 rows in
//           registers across the unit's heads, in head order.  C B^T and
//           dy x^T tiles are exact products (phase J recomputes their
//           transposes); scaled in registers to Z = dy x^T E dt, M^T and
//           Z^T they go straight back as A operands in high and low
//           parts; K's row sums (phase I) and column sums (phase J, the
//           rows of the transpose) never leave registers.  Phase I
//           leaves each row's sum_j K_ij dt_j + u_i in ddt; phase J's end
//           finishes dcum, its reverse cumsum, ddt and the dA and dD
//           parts in one warp.  A unit of a whole group writes dB and dC
//           in bf16; otherwise f32 sums per head set go to the workspace.
//   reduce  dB and dC over a group's head sets in order (where a group
//           has more than one), rounded once to bf16; dA and dD over
//           (batch, chunk) in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using hopper::exp2_ftz;
using hopper::ldsm_x4;
using hopper::ldsm_x4_t;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::mma16816;
using hopper::pack_bf16x2;
using hopper::smem_u32;
using hopper::tma_load_4d;

constexpr int QM = 128;        // largest chunk: rows staged per chunk
constexpr int P = 64;          // head dim
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int BOX = QM * 128;  // bytes of a 128-row box of 64 columns
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the states and chunk passes, byte offsets from a
// 1024-byte aligned base: the unit's B and C (N / 64 boxes each), two
// stages (x, dy and, in the chunk pass, a state's high and low tiles),
// the states pass's slab image, each warp's cum, dt and w rows, phase J's
// row vectors (two heads deep) and the mbarriers (two stages, B and C).
template <int N, bool CHUNK>
struct Lay {
  static constexpr size_t b = 0;
  static constexpr size_t c = b + size_t(N / 64) * BOX;
  static constexpr size_t stage0 = c + size_t(N / 64) * BOX;
  static constexpr size_t sx = 0, sdy = BOX, shi = 2 * BOX,
                          slo = 2 * BOX + size_t(N) * 128;
  static constexpr size_t stage = 2 * BOX + (CHUNK ? 2 * size_t(N) * 128 : 0);
  // the states pass's image of a head's two slabs, copied out in bulk
  static constexpr size_t stg = stage0 + 2 * stage;
  static constexpr size_t cum = stg + (CHUNK ? 0 : 2 * size_t(N) * 256);
  static constexpr size_t dt = cum + NWARPS * QM * 4;        // f32 [8][QM]
  static constexpr size_t w = dt + NWARPS * QM * 4;          // f32 [8][QM]
  static constexpr size_t jv = w + NWARPS * QM * 4;          // f32 [2][3][QM]
  static constexpr size_t bar = jv + (CHUNK ? 2 * 3 * QM * 4 : 0);
  static constexpr size_t bytes = bar + 32 + 1024;   // + alignment slack
  static_assert(bytes <= 232448, "more shared memory than a block has");
};

struct Args {
  const float* dt;
  const float* A;
  const float* D;
  bf16* dx;       // (b, L, H, P) contiguous
  float* ddt;     // (b, L, H) contiguous
  float* dA;      // (H,)
  bf16* dB;       // (b, L, G, N) contiguous
  bf16* dC;
  float* dD;      // (H,)
  int batch, H, G, L, Q, nc, K;   // K: head sets a group
  long long sdb, sdl, sdh;        // dt's strides
  // workspace: per (chain, chunk) two slabs (S_n, dS') of N * P words;
  // dB and dC per head set (f32 [b][L][G][K][N] each, where K > 1); per
  // (chain, chunk) the decay, the dA and dD parts and the walk's warps'
  // parts of <S_n, dS'>
  float *ws_st, *ws_db, *ws_dc, *ws_g, *ws_pa, *ws_pd, *ws_sd;
};

// byte offset of element (r, col) of a tile of rows stored as boxes of 64
// columns in the 128-byte swizzle, one box after another
__device__ __forceinline__ uint32_t tile_off(int r, int col) {
  return (col >> 6) * BOX + hopper::sw128_offset(r, col & 63);
}

// (v0, v1) as bf16x2 high parts and the bf16x2 of what they leave out
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(v0 - hf.x, v1 - hf.y);
}

// the bf16x2 pair u times (w0, w1), split into high and low parts
__device__ __forceinline__ void scale_split(uint32_t u, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  split2(v.x * w0, v.y * w1, hi, lo);
}

__device__ __forceinline__ float2 ld_bf2(const unsigned char* tile, int r,
                                         int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + tile_off(r, col)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the sum over the four lanes of a quad (one accumulator row's owners)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void zero_bytes(unsigned char* p, int from,
                                           int to) {
  for (int i = from + 16 * threadIdx.x; i < to; i += 16 * NT)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// The unit of block u: batch row, chunk, group and head set (head sets
// fastest, so the blocks that share a chunk's B and C run together), and
// its heads [h0, h1).
struct Unit {
  int bi, n, grp, k, h0, h1;
};
__device__ __forceinline__ Unit unit_of(const Args& a, int u) {
  Unit r;
  r.k = u % a.K;
  u /= a.K;
  r.grp = u % a.G;
  u /= a.G;
  r.n = u % a.nc;
  r.bi = u / a.nc;
  const int R = a.H / a.G;
  r.h0 = r.grp * R + r.k * R / a.K;
  r.h1 = r.grp * R + (r.k + 1) * R / a.K;
  return r;
}

// Each warp scans dt * A over the chunk itself (4 rows a lane, then a warp
// scan: a fixed order) into its own rows: cum, dt and w_j = exp(cum_Q -
// cum_j) dt_j.  Returns cum_Q.
__device__ __forceinline__ float warp_scan(const float (&d)[4], float Ah,
                                           int Q, int lane, float* cw,
                                           float* wdt, float* ww) {
  float part[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += d[k] * Ah;
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
  for (int k = 0; k < 4; ++k) {
    cw[4 * lane + k] = excl + part[k];
    wdt[4 * lane + k] = d[k];
  }
  __syncwarp();
  const float last = cw[Q - 1];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    ww[4 * lane + k] = expf(last - (excl + part[k])) * d[k];
  __syncwarp();
  return last;
}

// dt of head h, chunk n, rows 4 lane .. 4 lane + 3 (zero past Q)
__device__ __forceinline__ void load_dt(const Args& a, int bi, int n, int h,
                                        int lane, float (&d)[4]) {
  const float* p = a.dt + bi * a.sdb + h * a.sdh;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * lane + j;
    d[j] = i < a.Q ? __ldg(p + ((long long)n * a.Q + i) * a.sdl) : 0.f;
  }
}

// the slab (f32 [N][P] before the walk, a high and a low bf16 tile after)
// of chain ``chain``, chunk n: which 0 for S_n, 1 for dS'
template <int N>
__device__ __forceinline__ float* slab(const Args& a, size_t chain, int n,
                                       int which) {
  return a.ws_st + ((chain * a.nc + n) * 2 + which) * size_t(N * P);
}

// Byte offset in a slab of the f32 pair (s, p), (s, p + 1) (p even) before
// the walk: the pairs of the 4-column group p & ~3 lie where that group's
// high (p % 4 == 0) and low (p % 4 == 2) bf16 parts go after it.
template <int N>
__device__ __forceinline__ uint32_t pair_off(int s, int p) {
  return (p & 2 ? N * 128 : 0) + hopper::sw128_offset(s, p & ~3);
}

// ---- launch 1: each chunk's own state update and dS contribution -------
template <int N>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_states(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tdy,
               const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, const Args a) {
  using S = Lay<N, false>;
  constexpr int NP8 = N == 128 ? 8 : 4;   // n8 tiles of P a warp holds
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_aligned_1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2;
  const Unit un = unit_of(a, blockIdx.x);
  const int Q = a.Q, nt = (Q + 15) / 16, nh = un.h1 - un.h0;
  const int l0 = un.n * Q;
  float* cw = reinterpret_cast<float*>(smem + S::cum) + warp * QM;
  float* wdt = reinterpret_cast<float*>(smem + S::dt) + warp * QM;
  float* ww = reinterpret_cast<float*>(smem + S::w) + warp * QM;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::bar);
  const uint32_t sb = smem_u32(smem + S::b), sc = smem_u32(smem + S::c);

  // rows past Q are never loaded (a box is Q rows): zero them once
  for (int k = 0; k < 2 * N / 64; ++k)
    zero_bytes(smem + k * BOX, Q * 128, BOX);
  for (int st = 0; st < 2; ++st)
    for (int k = 0; k < 2; ++k)
      zero_bytes(smem + S::stage0 + st * S::stage + k * BOX, Q * 128, BOX);
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int h, int st) {
    unsigned char* base = smem + S::stage0 + st * S::stage;
    mbar_arrive_expect_tx(&bar[st], 2 * Q * 128);
    tma_load_4d(base + S::sx, &tx, &bar[st], 0, h, l0, un.bi);
    tma_load_4d(base + S::sdy, &tdy, &bar[st], 0, h, l0, un.bi);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar[2], 2 * (N / 64) * Q * 128);
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      tma_load_4d(smem + S::b + j * BOX, &tb, &bar[2], 64 * j, un.grp, l0,
                  un.bi);
      tma_load_4d(smem + S::c + j * BOX, &tc, &bar[2], 64 * j, un.grp, l0,
                  un.bi);
    }
    load(un.h0, 0);
  }
  float dnext[4];
  load_dt(a, un.bi, un.n, un.h0, lane, dnext);
  float a_next = __ldg(a.A + un.h0);
  mbar_wait(&bar[2], 0);

  // warp w: rows 16 mt of the state, columns c0 .. c0 + 8 NP8 - 1
  const int mt = N == 128 ? warp : (warp & 3);
  const int c0 = N == 128 ? 0 : (warp >> 2) * 32;
  for (int it = 0; it < nh; ++it) {
    const int h = un.h0 + it, st = it & 1;
    float dcur[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dcur[j] = dnext[j];
    const float Ah = a_next;
    if (it + 1 < nh) {
      if (tid == 0) load(h + 1, st ^ 1);
      load_dt(a, un.bi, un.n, h + 1, lane, dnext);
      a_next = __ldg(a.A + h + 1);
    }
    const float last = warp_scan(dcur, Ah, Q, lane, cw, wdt, ww);
    unsigned char* base = smem + S::stage0 + st * S::stage;
    const uint32_t sx = smem_u32(base + S::sx), sdy = smem_u32(base + S::sdy);
    mbar_wait(&bar[st], (it >> 1) & 1);

    float as[NP8][4], ad[NP8][4];
#pragma unroll
    for (int n8 = 0; n8 < NP8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) as[n8][e] = ad[n8][e] = 0.f;
    for (int kk = 0; kk < nt; ++kk) {
      const int j = kk * 16 + 2 * t4;
      const float w0 = ww[j], w1 = ww[j + 1], w2 = ww[j + 8], w3 = ww[j + 9];
      const float e0 = expf(cw[j]), e1 = expf(cw[j + 1]),
                  e2 = expf(cw[j + 8]), e3 = expf(cw[j + 9]);
      // A: (w o B)^T and (exp(cum) o C)^T, rows s, k = j, high and low
      const uint32_t aoff = tile_off(kk * 16 + (lane & 7) + (lane >> 4) * 8,
                                     mt * 16 + ((lane >> 3) & 1) * 8);
      uint32_t f[4], bh[4], bl[4], ch[4], cl[4];
      ldsm_x4_t(sb + aoff, f);
      scale_split(f[0], w0, w1, bh[0], bl[0]);
      scale_split(f[1], w0, w1, bh[1], bl[1]);
      scale_split(f[2], w2, w3, bh[2], bl[2]);
      scale_split(f[3], w2, w3, bh[3], bl[3]);
      ldsm_x4_t(sc + aoff, f);
      scale_split(f[0], e0, e1, ch[0], cl[0]);
      scale_split(f[1], e0, e1, ch[1], cl[1]);
      scale_split(f[2], e2, e3, ch[2], cl[2]);
      scale_split(f[3], e2, e3, ch[3], cl[3]);
#pragma unroll
      for (int np = 0; np < NP8 / 2; ++np) {
        const uint32_t boff =
            tile_off(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                     c0 + np * 16 + (lane >> 4) * 8);
        uint32_t xf[4], yf[4];
        ldsm_x4_t(sx + boff, xf);
        ldsm_x4_t(sdy + boff, yf);
        mma16816(as[2 * np], bh, xf[0], xf[1]);
        mma16816(as[2 * np + 1], bh, xf[2], xf[3]);
        mma16816(ad[2 * np], ch, yf[0], yf[1]);
        mma16816(ad[2 * np + 1], ch, yf[2], yf[3]);
        mma16816(as[2 * np], bl, xf[0], xf[1]);
        mma16816(as[2 * np + 1], bl, xf[2], xf[3]);
        mma16816(ad[2 * np], cl, yf[0], yf[1]);
        mma16816(ad[2 * np + 1], cl, yf[2], yf[3]);
      }
    }
    // f32 pairs into the image of the head's two slabs (S's, then dS's),
    // where the walk reads them; then the image out in one bulk store,
    // which drains under the next head's products (the pairs stored alone
    // would leave every sector half written)
    const size_t chain = (size_t)un.bi * a.H + h;
    if (tid == 0) hopper::tma_store_wait_read();   // the last head's image
    __syncthreads();
    unsigned char* gs = smem + S::stg;
    unsigned char* gd = gs + N * 256;
#pragma unroll
    for (int n8 = 0; n8 < NP8; ++n8) {
      const int p = c0 + n8 * 8 + 2 * t4, s = mt * 16 + g;
      *reinterpret_cast<float2*>(gs + pair_off<N>(s, p)) =
          make_float2(as[n8][0], as[n8][1]);
      *reinterpret_cast<float2*>(gs + pair_off<N>(s + 8, p)) =
          make_float2(as[n8][2], as[n8][3]);
      *reinterpret_cast<float2*>(gd + pair_off<N>(s, p)) =
          make_float2(ad[n8][0], ad[n8][1]);
      *reinterpret_cast<float2*>(gd + pair_off<N>(s + 8, p)) =
          make_float2(ad[n8][2], ad[n8][3]);
    }
    hopper::fence_proxy_async();
    __syncthreads();   // every warp is done with the stage; the image whole
    if (tid == 0) {
      hopper::bulk_store(slab<N>(a, chain, un.n, 0), gs, N * 512);
      hopper::tma_store_commit();
      a.ws_g[chain * a.nc + un.n] = expf(last);
    }
  }
  if (tid == 0) hopper::tma_store_wait_all();
}

// ---- launch 2: S_n walking forward, dS' walking back, in place ----------
// A thread holds 4 state elements (row s, columns p .. p + 3).  The last
// KEEP chunks' S_n stay in registers for <S_n, dS'> on the way back (all
// of them where a chain has at most KEEP chunks, as at L = 2048, Q =
// 128), whose loads are all issued before their updates; earlier chunks
// go four at a time and read S_n's parts back.
constexpr int WALK_UNROLL = 4;
constexpr int KEEP = 16;

__device__ __forceinline__ float4 fma4(float g, float4 s, float4 t) {
  return make_float4(fmaf(g, s.x, t.x), fmaf(g, s.y, t.y), fmaf(g, s.z, t.z),
                     fmaf(g, s.w, t.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// the f32 group the states pass left at (hi, lo), and the bf16 parts of v
// written over it
__device__ __forceinline__ float4 ld_group(const unsigned char* hi,
                                           const unsigned char* lo) {
  const float2 a = *reinterpret_cast<const float2*>(hi);
  const float2 b = *reinterpret_cast<const float2*>(lo);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st_parts(unsigned char* hi, unsigned char* lo,
                                         float4 v) {
  uint32_t h0, l0, h1, l1;
  split2(v.x, v.y, h0, l0);
  split2(v.z, v.w, h1, l1);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}
// the value the parts at (hi, lo) stand for
__device__ __forceinline__ float4 ld_parts(const unsigned char* hi,
                                           const unsigned char* lo) {
  const uint2 h = *reinterpret_cast<const uint2*>(hi);
  const uint2 l = *reinterpret_cast<const uint2*>(lo);
  const float2 h0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h.x));
  const float2 h1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h.y));
  const float2 l0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&l.x));
  const float2 l1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&l.y));
  return make_float4(h0.x + l0.x, h0.y + l0.y, h1.x + l1.x, h1.y + l1.y);
}

template <int N>
__global__ void __launch_bounds__(NT) ssd_bwd_walk(const Args a) {
  constexpr int NPART = N * P / 128;     // warps a chain
  const int e = blockIdx.x * NT + threadIdx.x;   // a group of 4 elements
  const int s = e / (P / 4), p = (e % (P / 4)) * 4;
  const uint32_t hoff = hopper::sw128_offset(s, p), loff = N * 128 + hoff;
  const size_t chain = blockIdx.y;
  const int nc = a.nc, n0 = nc - KEEP;   // chunks n0 + k, k < KEEP, kept
  const float* g = a.ws_g + chain * nc;
  auto at = [&](int n, int which) {
    return reinterpret_cast<unsigned char*>(slab<N>(a, chain, n, which));
  };
  const int warp_part = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  // <S_n, dS'> of chunk n, a warp's part
  auto sdot = [&](int n, float4 sn, float4 ds) {
    const float v = warp_sum(dot4(sn, ds));
    if ((threadIdx.x & 31) == 0)
      a.ws_sd[(chain * nc + n) * NPART + warp_part] = v;
  };
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m = 0; m < n0; m += WALK_UNROLL) {   // own -> S_n
    float4 t[WALK_UNROLL];
    float gn[WALK_UNROLL];
#pragma unroll
    for (int k = 0; k < WALK_UNROLL; ++k)
      if (m + k < n0) {
        unsigned char* b = at(m + k, 0);
        t[k] = ld_group(b + hoff, b + loff);
        gn[k] = g[m + k];
      }
#pragma unroll
    for (int k = 0; k < WALK_UNROLL; ++k)
      if (m + k < n0) {
        unsigned char* b = at(m + k, 0);
        st_parts(b + hoff, b + loff, S);
        S = fma4(gn[k], S, t[k]);
      }
  }
  float4 sn[KEEP], t[KEEP];
  float gn[KEEP];
#pragma unroll
  for (int k = 0; k < KEEP; ++k)
    if (n0 + k >= 0) {
      unsigned char* b = at(n0 + k, 0);
      t[k] = ld_group(b + hoff, b + loff);
      gn[k] = g[n0 + k];
    }
#pragma unroll
  for (int k = 0; k < KEEP; ++k)
    if (n0 + k >= 0) {
      unsigned char* b = at(n0 + k, 0);
      st_parts(b + hoff, b + loff, S);
      sn[k] = S;
      S = fma4(gn[k], S, t[k]);
    }
  // own -> dS', walking back: the kept chunks, then the rest
#pragma unroll
  for (int k = 0; k < KEEP; ++k)
    if (n0 + k >= 0) {
      unsigned char* b = at(n0 + k, 1);
      t[k] = ld_group(b + hoff, b + loff);
    }
  float4 dS = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = KEEP - 1; k >= 0; --k)
    if (n0 + k >= 0) {
      unsigned char* b = at(n0 + k, 1);
      st_parts(b + hoff, b + loff, dS);
      sdot(n0 + k, sn[k], dS);
      dS = fma4(gn[k], dS, t[k]);
    }
  for (int m = n0 - 1; m >= 0; m -= WALK_UNROLL) {
    float4 u[WALK_UNROLL], su[WALK_UNROLL];
    float gu[WALK_UNROLL];
#pragma unroll
    for (int k = 0; k < WALK_UNROLL; ++k)
      if (m - k >= 0) {
        unsigned char* b = at(m - k, 1);
        unsigned char* bs = at(m - k, 0);
        u[k] = ld_group(b + hoff, b + loff);
        su[k] = ld_parts(bs + hoff, bs + loff);
        gu[k] = g[m - k];
      }
#pragma unroll
    for (int k = 0; k < WALK_UNROLL; ++k)
      if (m - k >= 0) {
        unsigned char* b = at(m - k, 1);
        st_parts(b + hoff, b + loff, dS);
        sdot(m - k, su[k], dS);
        dS = fma4(gu[k], dS, u[k]);
      }
  }
}

// dB or dC of row tile t (the unit's sum over its heads) to the output,
// rounded once, where the unit holds its whole group; else to its head
// set's f32 rows of the workspace
template <int N>
__device__ __forceinline__ void write_rows(const Args& a, const Unit& un,
                                           int t, int nt,
                                           const float (&acc)[N / 8][4],
                                           bf16* out, float* ws) {
  if (t >= nt) return;
  const int lane = threadIdx.x & 31, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = t * 16 + (lane >> 2) + 8 * half;
    if (r >= a.Q) continue;
    const size_t row = ((size_t)un.bi * a.L + (size_t)un.n * a.Q + r) * a.G +
                       un.grp;
#pragma unroll
    for (int n8 = 0; n8 < N / 8; ++n8) {
      const int s = n8 * 8 + 2 * t4;
      const float v0 = acc[n8][2 * half], v1 = acc[n8][2 * half + 1];
      if (a.K == 1)
        *reinterpret_cast<__nv_bfloat162*>(out + row * N + s) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(ws + (row * a.K + un.k) * N + s) =
            make_float2(v0, v1);
    }
  }
}

// ---- launch 3: a unit's gradients ----------------------------------------
template <int N>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tdy,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc, const Args a) {
  using S = Lay<N, true>;
  constexpr int MT = N / 16;    // k16 steps over N
  constexpr int NPART = N * P / 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_aligned_1024(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2;
  const Unit un = unit_of(a, blockIdx.x);
  const int Q = a.Q, nt = (Q + 15) / 16, nh = un.h1 - un.h0;
  const int l0 = un.n * Q;
  float* cw = reinterpret_cast<float*>(smem + S::cum) + warp * QM;
  float* wdt = reinterpret_cast<float*>(smem + S::dt) + warp * QM;
  float* ww = reinterpret_cast<float*>(smem + S::w) + warp * QM;
  float* jv = reinterpret_cast<float*>(smem + S::jv);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::bar);
  const unsigned char* bsm = smem + S::b;
  const unsigned char* csm = smem + S::c;
  const uint32_t sb = smem_u32(bsm), sc = smem_u32(csm);

  for (int k = 0; k < 2 * N / 64; ++k)
    zero_bytes(smem + k * BOX, Q * 128, BOX);
  for (int st = 0; st < 2; ++st)
    for (int k = 0; k < 2; ++k)
      zero_bytes(smem + S::stage0 + st * S::stage + k * BOX, Q * 128, BOX);
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // task it < nh: phase I of head h0 + it; else phase J of head h0 + it - nh
  auto load = [&](int it, int st) {
    const int J = it >= nh, h = un.h0 + (J ? it - nh : it);
    unsigned char* base = smem + S::stage0 + st * S::stage;
    mbar_arrive_expect_tx(&bar[st], 2 * Q * 128 + 2 * N * 128);
    tma_load_4d(base + S::sx, &tx, &bar[st], 0, h, l0, un.bi);
    tma_load_4d(base + S::sdy, &tdy, &bar[st], 0, h, l0, un.bi);
    const float* sl = slab<N>(a, (size_t)un.bi * a.H + h, un.n, J);
    hopper::bulk_load(base + S::shi, sl, N * 128, &bar[st]);
    hopper::bulk_load(base + S::slo, sl + N * 32, N * 128, &bar[st]);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar[2], 2 * (N / 64) * Q * 128);
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      tma_load_4d(smem + S::b + j * BOX, &tb, &bar[2], 64 * j, un.grp, l0,
                  un.bi);
      tma_load_4d(smem + S::c + j * BOX, &tc, &bar[2], 64 * j, un.grp, l0,
                  un.bi);
    }
    load(0, 0);
  }
  float dnext[4];
  load_dt(a, un.bi, un.n, un.h0, lane, dnext);
  float a_next = __ldg(a.A + un.h0), d_next = __ldg(a.D + un.h0);
  mbar_wait(&bar[2], 0);

  // this warp's row tile (i in phase I, j in phase J) and its rows
  const int t = warp < 4 ? 7 - warp : warp - 4;
  const int r0 = t * 16, ra = r0 + g, rb = ra + 8;
  // dC (phase I), then dB (phase J), of rows r0 .. r0 + 15: summed over
  // the unit's heads in head order
  float acc[N / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < N / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
  for (int it = 0; it < 2 * nh; ++it) {
    const bool J = it >= nh;
    const int h = un.h0 + (J ? it - nh : it), st = it & 1;
    float dcur[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dcur[j] = dnext[j];
    const float Ah = a_next, Dh = d_next;
    if (it + 1 < 2 * nh) {   // request the next task's tiles and dt
      const int hn = un.h0 + (it + 1 >= nh ? it + 1 - nh : it + 1);
      if (tid == 0) load(it + 1, st ^ 1);
      load_dt(a, un.bi, un.n, hn, lane, dnext);
      a_next = __ldg(a.A + hn);
      d_next = __ldg(a.D + hn);
    }
    const float last = warp_scan(dcur, Ah, Q, lane, cw, wdt, ww);
    unsigned char* base = smem + S::stage0 + st * S::stage;
    const uint32_t sx = smem_u32(base + S::sx), sdy = smem_u32(base + S::sdy),
                   shi = smem_u32(base + S::shi), slo = smem_u32(base + S::slo);
    const size_t chain = (size_t)un.bi * a.H + h;
    float* od = a.ddt + ((size_t)un.bi * a.L + l0) * a.H + h;
    // what the end of phase J reads from global memory (phase I's row
    // sums, the walk's parts of <S_n, dS'>), requested before the work
    float stash[4] = {0.f, 0.f, 0.f, 0.f}, sd = 0.f;
    if (J && warp == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        stash[k] = 4 * lane + k < Q ? od[(size_t)(4 * lane + k) * a.H] : 0.f;
      for (int k = lane; k < NPART; k += 32)
        sd += a.ws_sd[(chain * a.nc + un.n) * NPART + k];
    }
    mbar_wait(&bar[st], (it >> 1) & 1);

    if (!J && t < nt) {
      // ---- phase I: dC += exp(cum_i) dy_i S_n^T + sum_{j<=i} Z_ij B_j ----
      // dy's fragments of these rows stay in registers; C's (k = s) are
      // loaded where they are used
      uint32_t df[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(sdy + tile_off(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8),
                df[kk]);
      const float ci0 = cw[ra], ci1 = cw[rb];
      const float e0 = expf(ci0), e1 = expf(ci1);
      // the inter term in 32 columns of N at a time, and u_i = sum_s C_is
      // (its value before exp(cum_i))
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int c32 = 0; c32 < N / 32; ++c32) {
        float tmp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const uint32_t off =
                tile_off(c32 * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8,
                         kk * 16 + ((lane >> 3) & 1) * 8);
            uint32_t bh[4], bl[4];
            ldsm_x4(shi + off, bh);
            ldsm_x4(slo + off, bl);
            mma16816(tmp[2 * np], df[kk], bh[0], bh[1]);
            mma16816(tmp[2 * np + 1], df[kk], bh[2], bh[3]);
            mma16816(tmp[2 * np], df[kk], bl[0], bl[1]);
            mma16816(tmp[2 * np + 1], df[kk], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          const int s = c32 * 32 + n8 * 8 + 2 * t4;
          const float2 ca = ld_bf2(csm, ra, s), cb = ld_bf2(csm, rb, s);
          u0 = fmaf(ca.x, tmp[n8][0], fmaf(ca.y, tmp[n8][1], u0));
          u1 = fmaf(cb.x, tmp[n8][2], fmaf(cb.y, tmp[n8][3], u1));
          float* o = acc[c32 * 4 + n8];
          o[0] = fmaf(e0, tmp[n8][0], o[0]);
          o[1] = fmaf(e0, tmp[n8][1], o[1]);
          o[2] = fmaf(e1, tmp[n8][2], o[2]);
          o[3] = fmaf(e1, tmp[n8][3], o[3]);
        }
      }
      // the triangle's tiles j <= i
      float rk0 = 0.f, rk1 = 0.f;   // sum_j K_ij dt_j
      for (int jt = 0; jt <= t; ++jt) {
        float cbt[2][4], gmt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbt[n][e] = gmt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {   // C_i . B_j
          uint32_t cf[4], bf[4];
          ldsm_x4(sc + tile_off(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8),
                  cf);
          ldsm_x4(sb + tile_off(jt * 16 + (lane & 7) + (lane >> 4) * 8,
                                kk * 16 + ((lane >> 3) & 1) * 8),
                  bf);
          mma16816(cbt[0], cf, bf[0], bf[1]);
          mma16816(cbt[1], cf, bf[2], bf[3]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {    // dy_i . x_j
          uint32_t xf[4];
          ldsm_x4(sx + tile_off(jt * 16 + (lane & 7) + (lane >> 4) * 8,
                                kk * 16 + ((lane >> 3) & 1) * 8),
                  xf);
          mma16816(gmt[0], df[kk], xf[0], xf[1]);
          mma16816(gmt[1], df[kk], xf[2], xf[3]);
        }
        uint32_t zh[4], zl[4];
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8) {
          const int j = jt * 16 + n8 * 8 + 2 * t4;
          const float cj0 = cw[j], cj1 = cw[j + 1];
          const float d0 = wdt[j], d1 = wdt[j + 1];
          const float* cb = cbt[n8];
          const float E00 = j <= ra ? exp2_ftz((ci0 - cj0) * LOG2E) : 0.f;
          const float E01 = j + 1 <= ra ? exp2_ftz((ci0 - cj1) * LOG2E) : 0.f;
          const float E10 = j <= rb ? exp2_ftz((ci1 - cj0) * LOG2E) : 0.f;
          const float E11 = j + 1 <= rb ? exp2_ftz((ci1 - cj1) * LOG2E) : 0.f;
          const float* q = gmt[n8];
          const float k00 = q[0] * cb[0] * E00, k01 = q[1] * cb[1] * E01,
                      k10 = q[2] * cb[2] * E10, k11 = q[3] * cb[3] * E11;
          rk0 = fmaf(k00, d0, fmaf(k01, d1, rk0));
          rk1 = fmaf(k10, d0, fmaf(k11, d1, rk1));
          split2(q[0] * E00 * d0, q[1] * E01 * d1, zh[2 * n8], zl[2 * n8]);
          split2(q[2] * E10 * d0, q[3] * E11 * d1, zh[2 * n8 + 1],
                 zl[2 * n8 + 1]);
        }
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {   // dC += Z B
          uint32_t bb[4];
          ldsm_x4_t(sb + tile_off(jt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  np * 16 + (lane >> 4) * 8),
                    bb);
          mma16816(acc[2 * np], zh, bb[0], bb[1]);
          mma16816(acc[2 * np + 1], zh, bb[2], bb[3]);
          mma16816(acc[2 * np], zl, bb[0], bb[1]);
          mma16816(acc[2 * np + 1], zl, bb[2], bb[3]);
        }
      }
      rk0 = quad_sum(rk0);
      rk1 = quad_sum(rk1);
      u0 = quad_sum(u0);
      u1 = quad_sum(u1);
      // sum_j K_ij dt_j + u_i, kept in ddt until phase J of this head
      if (t4 == 0) {
        if (ra < Q) od[(size_t)ra * a.H] = fmaf(e0, u0, rk0);
        if (rb < Q) od[(size_t)rb * a.H] = fmaf(e1, u1, rk1);
      }
    } else if (J && t < nt) {
      // ---- phase J: dx and dB of rows j ----------------------------------
      // the A fragments of these rows, B's (k = s) and x's (k = p), are
      // loaded where they are used: dB and dx stay in registers
      auto b_frag = [&](int kk, uint32_t(&f)[4]) {
        ldsm_x4(sb + tile_off(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8), f);
      };
      auto x_frag = [&](int kk, uint32_t(&f)[4]) {
        ldsm_x4(sx + tile_off(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8), f);
      };
      const float cja = cw[ra], cjb = cw[rb];
      const float wa = ww[ra], wb = ww[rb], dta = wdt[ra], dtb = wdt[rb];
      // dB += w_j x_j dS'^T, 32 columns of N at a time, and r_j's sum
      // sum_s B_js (x_j dS'^T)_s
      float rp0 = 0.f, rp1 = 0.f;
#pragma unroll
      for (int c32 = 0; c32 < N / 32; ++c32) {
        float tmp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t xf[4];
          x_frag(kk, xf);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const uint32_t off =
                tile_off(c32 * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8,
                         kk * 16 + ((lane >> 3) & 1) * 8);
            uint32_t bh[4], bl[4];
            ldsm_x4(shi + off, bh);
            ldsm_x4(slo + off, bl);
            mma16816(tmp[2 * np], xf, bh[0], bh[1]);
            mma16816(tmp[2 * np + 1], xf, bh[2], bh[3]);
            mma16816(tmp[2 * np], xf, bl[0], bl[1]);
            mma16816(tmp[2 * np + 1], xf, bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          const int s = c32 * 32 + n8 * 8 + 2 * t4;
          const float2 ba = ld_bf2(bsm, ra, s), bb = ld_bf2(bsm, rb, s);
          rp0 = fmaf(ba.x, tmp[n8][0], fmaf(ba.y, tmp[n8][1], rp0));
          rp1 = fmaf(bb.x, tmp[n8][2], fmaf(bb.y, tmp[n8][3], rp1));
          float* o = acc[c32 * 4 + n8];
          o[0] = fmaf(wa, tmp[n8][0], o[0]);
          o[1] = fmaf(wa, tmp[n8][1], o[1]);
          o[2] = fmaf(wb, tmp[n8][2], o[2]);
          o[3] = fmaf(wb, tmp[n8][3], o[3]);
        }
      }
      // dx = w_j B_j dS' first (dS' rows are k), then + M^T dy below
      float dxa[P / 8][4];
#pragma unroll
      for (int n8 = 0; n8 < P / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[n8][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t bf[4];
        b_frag(kk, bf);
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          const uint32_t off =
              tile_off(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                       np * 16 + (lane >> 4) * 8);
          uint32_t bh[4], bl[4];
          ldsm_x4_t(shi + off, bh);
          ldsm_x4_t(slo + off, bl);
          mma16816(dxa[2 * np], bf, bh[0], bh[1]);
          mma16816(dxa[2 * np + 1], bf, bh[2], bh[3]);
          mma16816(dxa[2 * np], bf, bl[0], bl[1]);
          mma16816(dxa[2 * np + 1], bf, bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < P / 8; ++n8) {
        dxa[n8][0] *= wa;
        dxa[n8][1] *= wa;
        dxa[n8][2] *= wb;
        dxa[n8][3] *= wb;
      }
      // the triangle's tiles i >= j, from the transposes B_j . C_i and
      // x_j . dy_i
      float ck0 = 0.f, ck1 = 0.f, gd0 = 0.f, gd1 = 0.f;
      for (int it2 = t; it2 < nt; ++it2) {
        float cbt[2][4], gmt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbt[n][e] = gmt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {   // B_j . C_i
          uint32_t bf[4], cf[4];
          b_frag(kk, bf);
          ldsm_x4(sc + tile_off(it2 * 16 + (lane & 7) + (lane >> 4) * 8,
                                kk * 16 + ((lane >> 3) & 1) * 8),
                  cf);
          mma16816(cbt[0], bf, cf[0], cf[1]);
          mma16816(cbt[1], bf, cf[2], cf[3]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {   // x_j . dy_i
          uint32_t xf[4], yf[4];
          x_frag(kk, xf);
          ldsm_x4(sdy + tile_off(it2 * 16 + (lane & 7) + (lane >> 4) * 8,
                                 kk * 16 + ((lane >> 3) & 1) * 8),
                  yf);
          mma16816(gmt[0], xf, yf[0], yf[1]);
          mma16816(gmt[1], xf, yf[2], yf[3]);
        }
        uint32_t mh[4], ml[4], zh[4], zl[4];
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8) {
          const int i = it2 * 16 + n8 * 8 + 2 * t4;
          const float ci0 = cw[i], ci1 = cw[i + 1];
          const float* cb = cbt[n8];
          const float E00 = i >= ra ? exp2_ftz((ci0 - cja) * LOG2E) : 0.f;
          const float E01 = i + 1 >= ra ? exp2_ftz((ci1 - cja) * LOG2E) : 0.f;
          const float E10 = i >= rb ? exp2_ftz((ci0 - cjb) * LOG2E) : 0.f;
          const float E11 = i + 1 >= rb ? exp2_ftz((ci1 - cjb) * LOG2E) : 0.f;
          const float c00 = cb[0], c01 = cb[1], c10 = cb[2], c11 = cb[3];
          const float* q = gmt[n8];
          ck0 = fmaf(q[0] * c00, E00, fmaf(q[1] * c01, E01, ck0));
          ck1 = fmaf(q[2] * c10, E10, fmaf(q[3] * c11, E11, ck1));
          if (i == ra) gd0 = q[0];
          if (i + 1 == ra) gd0 = q[1];
          if (i == rb) gd1 = q[2];
          if (i + 1 == rb) gd1 = q[3];
          split2(c00 * E00 * dta, c01 * E01 * dta, mh[2 * n8], ml[2 * n8]);
          split2(c10 * E10 * dtb, c11 * E11 * dtb, mh[2 * n8 + 1],
                 ml[2 * n8 + 1]);
          split2(q[0] * E00 * dta, q[1] * E01 * dta, zh[2 * n8], zl[2 * n8]);
          split2(q[2] * E10 * dtb, q[3] * E11 * dtb, zh[2 * n8 + 1],
                 zl[2 * n8 + 1]);
        }
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {   // dx += M^T dy
          uint32_t yf[4];
          ldsm_x4_t(sdy + tile_off(it2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                   np * 16 + (lane >> 4) * 8),
                    yf);
          mma16816(dxa[2 * np], mh, yf[0], yf[1]);
          mma16816(dxa[2 * np + 1], mh, yf[2], yf[3]);
          mma16816(dxa[2 * np], ml, yf[0], yf[1]);
          mma16816(dxa[2 * np + 1], ml, yf[2], yf[3]);
        }
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {   // dB += Z^T C
          uint32_t cf[4];
          ldsm_x4_t(sc + tile_off(it2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  np * 16 + (lane >> 4) * 8),
                    cf);
          mma16816(acc[2 * np], zh, cf[0], cf[1]);
          mma16816(acc[2 * np + 1], zh, cf[2], cf[3]);
          mma16816(acc[2 * np], zl, cf[0], cf[1]);
          mma16816(acc[2 * np + 1], zl, cf[2], cf[3]);
        }
      }
      // dx + D dy, rounded once
      bf16* ob = a.dx + (((size_t)un.bi * a.L + l0) * a.H + h) * P;
#pragma unroll
      for (int n8 = 0; n8 < P / 8; ++n8) {
        const int col = n8 * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? rb : ra;
          if (r < Q) {
            const float2 dv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(base + S::sdy +
                                                         tile_off(r, col)));
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * a.H * P +
                                               col) =
                __floats2bfloat162_rn(fmaf(Dh, dv.x, dxa[n8][2 * half]),
                                      fmaf(Dh, dv.y, dxa[n8][2 * half + 1]));
          }
        }
      }
      ck0 = quad_sum(ck0);
      ck1 = quad_sum(ck1);
      rp0 = quad_sum(rp0);
      rp1 = quad_sum(rp1);
      gd0 = quad_sum(gd0);
      gd1 = quad_sum(gd1);
      if (t4 == 0) {
        float* v = jv + ((it - nh) & 1) * 3 * QM;
        v[ra] = ck0;
        v[rb] = ck1;
        v[QM + ra] = expf(last - cja) * rp0;
        v[QM + rb] = expf(last - cjb) * rp1;
        v[2 * QM + ra] = gd0;
        v[2 * QM + rb] = gd1;
      }
    }
    if (it == nh - 1) {   // the unit's dC is complete: out, and start dB
      write_rows<N>(a, un, t, nt, acc, a.dC, a.ws_dc);
#pragma unroll
      for (int n8 = 0; n8 < N / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
    }
    __syncthreads();   // every warp is done with the stage; J's rows written
    if (J && warp == 0) {
      // ---- dcum, its reverse cumsum, ddt, and the dA and dD parts --------
      const float* v = jv + ((it - nh) & 1) * 3 * QM;
      const float* colk = v;
      const float* rv = v + QM;
      const float* gdv = v + 2 * QM;
      sd = warp_sum(sd);
      float dc[4], dd[4], vs = 0.f, gs = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * lane + k;
        dc[k] = dd[k] = 0.f;
        if (i < Q) {
          const float dti = wdt[i];
          const float vv = rv[i] * dti;
          dc[k] = stash[k] - colk[i] * dti - vv;
          dd[k] = colk[i] + rv[i];
          vs += vv;
          gs += gdv[i];
        }
      }
      vs = warp_sum(vs);
      gs = warp_sum(gs);
      // the last step's cum is exp(cum_Q)'s and every w_j's
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * lane + k == Q - 1) dc[k] += vs + expf(last) * sd;
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
          od[(size_t)i * a.H] = fmaf(da, Ah, dd[k]);
          pa = fmaf(da, wdt[i], pa);
        }
      }
      pa = warp_sum(pa);
      if (lane == 0) {
        a.ws_pa[chain * a.nc + un.n] = pa;
        a.ws_pd[chain * a.nc + un.n] = gs;
      }
    }
  }
  write_rows<N>(a, un, t, nt, acc, a.dB, a.ws_db);
}

// ---- launch 4: the sums over head sets, batch rows and chunks ------------
__global__ void __launch_bounds__(NT) ssd_bwd_reduce(const Args a, int N) {
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
  if (e >= (size_t)a.batch * a.L * a.G * N) return;
  const size_t row = e / N;            // (bi * L + l) * G + g
  const int s = e % N;
  const float* pb = a.ws_db + row * a.K * N + s;
  const float* pc = a.ws_dc + row * a.K * N + s;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < a.K; ++k) {
    sb += pb[(size_t)k * N];
    sc += pc[(size_t)k * N];
  }
  a.dB[e] = __float2bfloat16_rn(sb);
  a.dC[e] = __float2bfloat16_rn(sc);
}

template <int N>
int launch_bwd(const Args& a, const bf16* x, const bf16* B, const bf16* C,
               const bf16* dy, const long long* st, cudaStream_t s) {
  using LC = Lay<N, true>;
  using LS = Lay<N, false>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_chunk<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)LC::bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_states<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)LS::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // rank-4 maps (columns, head or group, seq, batch), boxes of 64 x 1 x Q x 1
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(a.Q), 1};
  const long long dxh[4] = {P, a.H, a.L, a.batch},
                  dbc[4] = {N, a.G, a.L, a.batch};
  const long long sx[3] = {st[2], st[1], st[0]};
  const long long sb[3] = {st[8], st[7], st[6]};
  const long long sc[3] = {st[11], st[10], st[9]};
  const long long sy[3] = {st[14], st[13], st[12]};
  CUtensorMap tx, tdy, tb, tc;
  int rc = hopper::make_map_bf16(&tx, x, 4, dxh, sx, box);
  if (!rc) rc = hopper::make_map_bf16(&tdy, dy, 4, dxh, sy, box);
  if (!rc) rc = hopper::make_map_bf16(&tb, B, 4, dbc, sb, box);
  if (!rc) rc = hopper::make_map_bf16(&tc, C, 4, dbc, sc, box);
  if (rc) return rc;
  const int units = a.batch * a.G * a.K * a.nc;
  ssd_bwd_states<N><<<units, NT, LS::bytes, s>>>(tx, tdy, tb, tc, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_walk<N><<<dim3(N * P / 4 / NT, a.batch * a.H), NT, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk<N><<<units, NT, LC::bytes, s>>>(tx, tdy, tb, tc, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = a.K > 1 ? (size_t)a.batch * a.L * a.G * N : 0;
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
    smem = (int)Lay<N, false>::bytes;
  } else if (which == 1) {
    e = cudaFuncGetAttributes(&fa, ssd_bwd_walk<N>);
  } else if (which == 2) {
    e = cudaFuncGetAttributes(&fa, ssd_bwd_chunk<N>);
    smem = (int)Lay<N, true>::bytes;
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
// L % Q == 0, H % G == 0, 1 <= sets <= H / G (ssd_bwd_geometry's head
// sets a group).  work: ssd_bwd_workspace_words four-byte words
// (kernels/ssd_scan.py), any contents: every word is written before it is
// read.  Returns the first launch error (0 on success).
int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* D,
                       const void* dy, void* dx, void* ddt, void* dA,
                       void* dB, void* dC, void* dD, int batch, int L, int H,
                       int G, int P_, int N, int Q, int sets,
                       const long long* st, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P_ != P || Q < 1 || Q > QM || L % Q || G < 1 || H % G || batch < 1 ||
      batch > 65535 || H > 65535 || (N != 64 && N != 128) || sets < 1 ||
      sets > H / G)
    return (int)cudaErrorInvalidValue;
  const int nc = L / Q;
  const size_t chains = (size_t)batch * H;
  float* w = static_cast<float*>(work);
  Args a{static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(D), static_cast<bf16*>(dx),
         static_cast<float*>(ddt), static_cast<float*>(dA),
         static_cast<bf16*>(dB), static_cast<bf16*>(dC),
         static_cast<float*>(dD), batch, H, G, L, Q, nc, sets,
         st[3], st[4], st[5]};
  const size_t parts = sets > 1 ? (size_t)batch * L * G * sets * N : 0;
  a.ws_st = w;
  a.ws_db = a.ws_st + 2 * chains * nc * N * P;
  a.ws_dc = a.ws_db + parts;
  a.ws_g = a.ws_dc + parts;
  a.ws_pa = a.ws_g + chains * nc;
  a.ws_pd = a.ws_pa + chains * nc;
  a.ws_sd = a.ws_pd + chains * nc;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(B);
  const bf16* Cb = static_cast<const bf16*>(C);
  const bf16* yb = static_cast<const bf16*>(dy);
  return N == 128 ? launch_bwd<128>(a, xb, Bb, Cb, yb, st, s)
                  : launch_bwd<64>(a, xb, Bb, Cb, yb, st, s);
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
