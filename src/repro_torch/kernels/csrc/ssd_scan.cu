// Chunked SSD scan (Mamba2, state-space duality) for Hopper (sm_90a):
// bf16 x, B, C in; f32 dt, A, D; bf16 out.  Every chunk product runs on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate); the
// state stays in f32.
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
//
// This kernel does 3,200 mma.sync m16n8k16 a chunk of a head at N = 128
// (C B^T on the triangle's 36 tiles 576, M x 576 and C S 1024 and the
// state update 1024, the last three in high and low parts): ~67 GFLOP at
// b = 4, 2.5x what the function needs, at a fraction of the tensor
// cores' rate.  Per-warp cycle counts (tools/kernel_probes.py) put ~70%
// of a chunk in the y products of the warps with the long rows of the
// triangle, and ~13% in waiting for the chunk's tiles.
//
// Design.  On the TPU the chunk axis was a sequential grid axis carrying
// S in VMEM scratch.  Here a chain (one batch row and head) walks its
// chunks in order, and the chains' chunks are laid end to end and cut
// into one even share per SM (persistent blocks, one an SM): a block runs
// the head of the chain its share ends in and hands that chain's f32
// state to the next block through a workspace (store, fence, ready
// flag), then whole chains, then the tail of the chain its share starts
// in, whose state the block before it handed on first thing.  So 160
// chains (mamba2-2.7b's NanoFlow half) fill 132 SMs at ~19.4 chunks each
// instead of leaving a second wave 21% full, each chain moves at most
// once, and a chain's arithmetic is the same whichever block runs it.
// Eight warps; per chunk:
//   loads   thread 0 requests the next chunk's x, B and C as TMA boxes of
//           Q rows by 64 columns (in place through the views' strides,
//           the 128-byte swizzle, so ldmatrix reads no bank twice) on a
//           two-stage ring, and each lane the next chunk's dt into
//           registers, while this chunk computes; rows past Q are zero.
//   cumsum  each warp scans dt * A itself (4 rows a lane, then a warp
//           scan: a fixed order, so a row's result depends on no other
//           row of the launch) and forms the weights w_j = exp(cum_Q -
//           cum_j) dt_j, in its own rows of shared memory.
//   y       warp w owns row tile t = 7 - w (w < 4) or w - 4, so the two
//           warps of a scheduler hold tiles t and 7 - t.  It holds C's
//           fragments of its 16 rows, computes exp(cum_i) C S against the
//           state's bf16 high and low parts (two products, ~2^-17
//           relative), then for each 16-column tile j <= t the C B^T tile
//           (exact bf16 products), scales it in registers to M = C B^T
//           exp(cum_i - cum_j) dt_j (the exponent masked to j <= i: above
//           the diagonal it overflows, and inf * 0 is NaN), and feeds the
//           accumulator straight back as the A operand of M x, M split
//           into a bf16 high and low part (two products).  + D x, rounded
//           once.
//   state   S = exp(cum_Q) S + (w o B)^T x in f32 registers, in units of
//           16 rows by 32 columns: a warp whose row tile of y is short
//           holds more units (4 to 0), so every warp's work comes to
//           about the same; w o B enters in high and low parts.  The new
//           state's parts go to shared memory for the next chunk's C S
//           once every warp is done with the old ones.
// A row's output depends on its own data only, whatever the batch.
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

constexpr int QM = 128;       // largest chunk: rows staged per chunk
constexpr int P = 64;         // head dim
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STAGES = 2;     // chunk c + 1 lands while chunk c computes
constexpr int BOX = QM * 128; // bytes of a 128-row box of 64 columns
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Layout {         // byte offsets from a 1024-byte aligned base
  static constexpr int XS = P + 8;    // row stride of S's parts (elements)
  static constexpr size_t x = 0;                             // 1 box
  static constexpr size_t b = x + BOX;                       // N / 64 boxes
  static constexpr size_t c = b + size_t(N / 64) * BOX;      // N / 64 boxes
  static constexpr size_t stage = c + size_t(N / 64) * BOX;
  static constexpr size_t shi = STAGES * stage;              // bf16 [N][XS]
  static constexpr size_t slo = shi + size_t(N) * XS * 2;    // bf16 [N][XS]
  static constexpr size_t cum = slo + size_t(N) * XS * 2;    // f32 [8][QM]
  static constexpr size_t w = cum + NWARPS * QM * 4;         // f32 [8][QM]
  static constexpr size_t dt = w + NWARPS * QM * 4;          // f32 [8][QM]
  static constexpr size_t bar = dt + NWARPS * QM * 4;        // 2 mbarriers
  static constexpr size_t bytes = bar + 16 + 1024;  // + alignment slack
};

struct Args {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  const float* D;
  bf16* y;
  int H, G, L, Q;
  long long sxb, sxl, sxh, sdb, sdl, sdh, sbb, sbl, sbg, scb, scl, scg,
      syb, syl, syh;
  // the workspace: the state a block hands to the next one (f32
  // [chains][N][P]) and a ready flag a chain, zero between calls
  float* state;
  int* ready;
  int tasks, per;   // chunks of all chains; of each block
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// byte offset of element (r, col) of a tile of 128 rows stored as boxes of
// 64 columns in the 128-byte swizzle, one box after another (16-byte
// chunk col/8 of row r at chunk (col/8) ^ (r%8): eight rows at the same
// column sit in eight different banks, so ldmatrix reads no bank twice)
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

__device__ __forceinline__ void zero_bytes(unsigned char* p, int from,
                                           int to) {
  for (int i = from + 16 * threadIdx.x; i < to; i += 16 * NTHREADS)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// S += (w o B)^T x over the chunk's nt 16-step tiles for the warp's NU
// state units (unit id: rows 16 (id / 2), columns 32 (id % 2)); w o B
// enters as a bf16 high and low part, x exactly.  sb, sx: shared
// addresses of the chunk's B and x tiles.
template <int N, int NU>
__device__ __forceinline__ void state_units(float (&sacc)[N / 32][4][4],
                                            int ubase, int nt, uint32_t sb,
                                            uint32_t sx, const float* ww,
                                            int lane) {
  const int t4 = lane & 3;
  for (int kk = 0; kk < nt; ++kk) {
    const int j = kk * 16 + 2 * t4;
    const float w0 = ww[j], w1 = ww[j + 1], w2 = ww[j + 8], w3 = ww[j + 9];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int id = ubase + u, m = id >> 1, c0 = (id & 1) * 32;
      uint32_t af[4], ah[4], al[4];
      ldsm_x4_t(sb + tile_off(kk * 16 + (lane & 7) + (lane >> 4) * 8,
                              m * 16 + ((lane >> 3) & 1) * 8),
                af);
      scale_split(af[0], w0, w1, ah[0], al[0]);
      scale_split(af[1], w0, w1, ah[1], al[1]);
      scale_split(af[2], w2, w3, ah[2], al[2]);
      scale_split(af[3], w2, w3, ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t xf[4];
        ldsm_x4_t(sx + tile_off(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                c0 + np * 16 + (lane >> 4) * 8),
                  xf);
        mma16816(sacc[u][2 * np], ah, xf[0], xf[1]);
        mma16816(sacc[u][2 * np], al, xf[0], xf[1]);
        mma16816(sacc[u][2 * np + 1], ah, xf[2], xf[3]);
        mma16816(sacc[u][2 * np + 1], al, xf[2], xf[3]);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(NTHREADS, 1)
ssd_scan_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, const Args a) {
  using S = Layout<N>;
  constexpr int XS = S::XS;
  constexpr int MT = N / 16;                  // 16-row tiles of C and S
  // State units (16 rows of S by 32 columns) each warp updates and holds,
  // by its row tile t of y, 4 bits a tile: the shorter t's triangle, the
  // more units, so every warp's y and state work come to about the same.
  constexpr int MAXU = N / 32;
  constexpr uint32_t UNITS = N == 128 ? 0x01122334u : 0x00011222u;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hopper::smem_aligned_1024(smem_raw);
  bf16* s_hi = reinterpret_cast<bf16*>(smem + S::shi);
  bf16* s_lo = reinterpret_cast<bf16*>(smem + S::slo);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nchunks = a.L / a.Q, Q = a.Q, nt = (Q + 15) / 16;
  float* cw = reinterpret_cast<float*>(smem + S::cum) + warp * QM;
  float* ww = reinterpret_cast<float*>(smem + S::w) + warp * QM;
  float* wdt = reinterpret_cast<float*>(smem + S::dt) + warp * QM;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::bar);

  // rows past Q are never loaded (a box is Q rows): zero them once
  for (int st = 0; st < STAGES; ++st)
    for (int k = 0; k < 1 + 2 * N / 64; ++k)
      zero_bytes(smem + st * S::stage + k * BOX, Q * 128, BOX);
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }

  // The schedule.  Lay the chains' chunks end to end (chain k's chunk c
  // at k * NC + c) and give block w the ``per`` of them from w * per, at
  // least a whole chain's worth, so the blocks share the work evenly
  // whatever the count of chains.  A block's range holds the tail of one
  // chain (chunks ca.. of chain cs), whole chains, and the head of another
  // (chunks 0..cz of chain ce); it runs the head first and hands that
  // chain's state on through the workspace, then the whole chains, then
  // the tail, whose state the block before it handed on at its start.
  // Each chain moves at most once; a tail waits only for the head that
  // the block before it runs first, so every wait ends.
  struct Task {
    int c, h, bi, chain;
  };
  const int NC = nchunks;
  const int s0 = blockIdx.x * a.per, len = min(a.per, a.tasks - s0);
  const int cs = s0 / NC, ca = s0 % NC;
  const int ce = (s0 + len - 1) / NC, cz = (s0 + len - 1) % NC;
  const int head = cz < NC - 1 ? cz + 1 : 0, tail = ca > 0 ? NC - ca : 0;
  const int f0 = ca > 0 ? cs + 1 : cs;
  auto task = [&](int i) {
    Task r;
    if (i < head) {
      r.chain = ce;
      r.c = i;
    } else if (i < len - tail) {
      r.chain = f0 + (i - head) / NC;
      r.c = (i - head) % NC;
    } else {
      r.chain = cs;
      r.c = ca + i - (len - tail);
    }
    r.bi = r.chain / a.H;
    r.h = r.chain - r.bi * a.H;
    return r;
  };
  // a task's x, B and C into stage st: one TMA box of Q rows by 64
  // columns each, completing on the stage's mbarrier (thread 0)
  auto load = [&](const Task& k, int st) {
    unsigned char* base = smem + st * S::stage;
    const int l0 = k.c * Q, grp = k.h / (a.H / a.G);
    mbar_arrive_expect_tx(&bar[st], Q * 128 * (1 + 2 * N / 64));
    tma_load_4d(base + S::x, &tx, &bar[st], 0, k.h, l0, k.bi);
#pragma unroll
    for (int j = 0; j < N / 64; ++j) {
      tma_load_4d(base + S::b + j * BOX, &tb, &bar[st], 64 * j, grp, l0, k.bi);
      tma_load_4d(base + S::c + j * BOX, &tc, &bar[st], 64 * j, grp, l0, k.bi);
    }
  };
  // a task's dt, rows 4 lane .. 4 lane + 3 (zero past Q), into registers
  auto load_dt = [&](const Task& k, float (&d)[4]) {
    const float* p = a.dt + k.bi * a.sdb + k.h * a.sdh;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * lane + j;
      d[j] = i < Q ? __ldg(p + ((long long)k.c * Q + i) * a.sdl) : 0.f;
    }
  };

  // the row tile of y this warp owns, and its units of the state
  const int t = warp < 4 ? 7 - warp : warp - 4;
  const int i0 = t * 16;
  const int nu = (UNITS >> (4 * t)) & 15;
  int ubase = 0;
  for (int k = 0; k < t; ++k) ubase += (UNITS >> (4 * k)) & 15;
  float sacc[MAXU][4][4];
  // the state's bf16 high and low parts, this warp's units, for C S
  auto write_parts = [&](const float (&v)[MAXU][4][4]) {
#pragma unroll
    for (int u = 0; u < MAXU; ++u) {
      if (u < nu) {
        const int id = ubase + u, r = (id >> 1) * 16 + g;
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          const int col = (id & 1) * 32 + n8 * 8 + 2 * t4;
          uint32_t hi, lo;
          split2(v[u][n8][0], v[u][n8][1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + r * XS + col) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + r * XS + col) = lo;
          split2(v[u][n8][2], v[u][n8][3], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + (r + 8) * XS + col) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + (r + 8) * XS + col) = lo;
        }
      }
    }
  };

  // the next task, its dt, A and D, requested a task ahead
  Task nxt = task(0);
  float dnext[4], a_next = __ldg(a.A + nxt.h), d_next = __ldg(a.D + nxt.h);
  if (tid == 0) load(nxt, 0);
  load_dt(nxt, dnext);
  __syncthreads();
  for (int it = 0; it < len; ++it) {
    const Task tk = nxt;
    const int c = tk.c, st = it & 1;
    unsigned char* base = smem + st * S::stage;
    const uint32_t sx = smem_u32(base + S::x), sb = smem_u32(base + S::b),
                   sc = smem_u32(base + S::c);
    const float Ah = a_next, Dh = d_next;
    float dcur[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dcur[j] = dnext[j];
    if (it + 1 < len) {     // request the next task's tiles and dt
      nxt = task(it + 1);
      if (tid == 0) load(nxt, st ^ 1);
      load_dt(nxt, dnext);
      a_next = __ldg(a.A + nxt.h);
      d_next = __ldg(a.D + nxt.h);
    }
    bf16* yb = a.y + tk.bi * a.syb + tk.h * a.syh;
    float* gstate = a.state + (size_t)tk.chain * N * P;
    const bool handed_in = tail > 0 && it == len - tail;
    const bool hand_on = head > 0 && it == head - 1;
    const bool goes_on = it + 1 < len && c + 1 < NC && !hand_on;
    if (c == 0) {
#pragma unroll
      for (int u = 0; u < MAXU; ++u)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[u][n][e] = 0.f;
    }
    if (handed_in) {  // the chain's state, once the block before wrote it
      if (tid == 0) {
        for (int spins = 0; ld_acquire(&a.ready[tk.chain]) == 0; ++spins) {
          if (spins > (1 << 26)) __trap();   // a lost hand-off: fail
          __nanosleep(64);
        }
        a.ready[tk.chain] = 0;               // zero for the next call
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        if (u >= nu) continue;
        const int id = ubase + u, r = (id >> 1) * 16 + g;
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          const int col = (id & 1) * 32 + n8 * 8 + 2 * t4;
          const float2 v0 =
              __ldcg(reinterpret_cast<const float2*>(gstate + r * P + col));
          const float2 v1 = __ldcg(
              reinterpret_cast<const float2*>(gstate + (r + 8) * P + col));
          sacc[u][n8][0] = v0.x;
          sacc[u][n8][1] = v0.y;
          sacc[u][n8][2] = v1.x;
          sacc[u][n8][3] = v1.y;
        }
      }
      write_parts(sacc);
    }
    mbar_wait(&bar[st], (it >> 1) & 1);
    __syncthreads();  // the tiles landed; the state's parts written

    // ---- cumsum of dt * A and the state update's weights, per warp ------
    {
      float part[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += dcur[k] * Ah;
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
        wdt[4 * lane + k] = dcur[k];
      }
      __syncwarp();
      // w_j = exp(cum_Q - cum_j) dt_j
      const float last = cw[Q - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ww[4 * lane + k] = expf(last - (excl + part[k])) * dcur[k];
      __syncwarp();
    }
    const float cum_last = cw[Q - 1];

    // ---- C fragments of this warp's 16 rows ------------------------------
    uint32_t cf[MT][4];
#pragma unroll
    for (int kk = 0; kk < MT; ++kk)
      ldsm_x4(sc + tile_off(i0 + (lane & 15), kk * 16 + (lane >> 4) * 8),
              cf[kk]);

    // ---- y = exp(cum) C S + M x + D x ------------------------------------
    if (t < nt) {
      float yacc[P / 8][4];
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
      const float ci0 = cw[i0 + g], ci1 = cw[i0 + g + 8];
      if (c > 0) {    // S = 0 before the first chunk
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {
#pragma unroll
          for (int np = 0; np < P / 16; ++np) {
            const int off =
                (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                np * 16 + (lane >> 4) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4_t(smem_u32(s_hi + off), bh);
            ldsm_x4_t(smem_u32(s_lo + off), bl);
            mma16816(yacc[2 * np], cf[kk], bh[0], bh[1]);
            mma16816(yacc[2 * np + 1], cf[kk], bh[2], bh[3]);
            mma16816(yacc[2 * np], cf[kk], bl[0], bl[1]);
            mma16816(yacc[2 * np + 1], cf[kk], bl[2], bl[3]);
          }
        }
        const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          yacc[n][0] *= e0;
          yacc[n][1] *= e0;
          yacc[n][2] *= e1;
          yacc[n][3] *= e1;
        }
      }
      const int ia = i0 + g, ib = ia + 8;
      for (int jt = 0; jt <= t; ++jt) {
        // two chains (even and odd steps of N) for the tensor cores' latency
        float s2[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s2[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {
          uint32_t bf[4];
          ldsm_x4(sb + tile_off(jt * 16 + (lane & 7) + (lane >> 4) * 8,
                                kk * 16 + ((lane >> 3) & 1) * 8),
                  bf);
          mma16816(s2[2 * (kk & 1)], cf[kk], bf[0], bf[1]);
          mma16816(s2[2 * (kk & 1) + 1], cf[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s2[0][e] += s2[2][e];
          s2[1][e] += s2[3][e];
        }
        // M = C B^T exp(cum_i - cum_j) dt_j for j <= i, as the A operand
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8) {
          const int j = jt * 16 + n8 * 8 + 2 * t4;
          const float cj0 = cw[j], cj1 = cw[j + 1];
          const float d0 = wdt[j], d1 = wdt[j + 1];
          const float m0 =
              j <= ia ? s2[n8][0] * exp2_ftz((ci0 - cj0) * LOG2E) * d0 : 0.f;
          const float m1 = j + 1 <= ia
                               ? s2[n8][1] * exp2_ftz((ci0 - cj1) * LOG2E) * d1
                               : 0.f;
          const float m2 =
              j <= ib ? s2[n8][2] * exp2_ftz((ci1 - cj0) * LOG2E) * d0 : 0.f;
          const float m3 = j + 1 <= ib
                               ? s2[n8][3] * exp2_ftz((ci1 - cj1) * LOG2E) * d1
                               : 0.f;
          split2(m0, m1, mh[2 * n8], ml[2 * n8]);
          split2(m2, m3, mh[2 * n8 + 1], ml[2 * n8 + 1]);
        }
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t xf[4];
          ldsm_x4_t(sx + tile_off(jt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  np * 16 + (lane >> 4) * 8),
                    xf);
          mma16816(yacc[2 * np], mh, xf[0], xf[1]);
          mma16816(yacc[2 * np + 1], mh, xf[2], xf[3]);
          mma16816(yacc[2 * np], ml, xf[0], xf[1]);
          mma16816(yacc[2 * np + 1], ml, xf[2], xf[3]);
        }
      }
      const long long l0 = (long long)c * Q;
#pragma unroll
      for (int n8 = 0; n8 < P / 8; ++n8) {
        const int col = n8 * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? ib : ia;
          if (i < Q) {
            const float2 xv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    base + S::x + tile_off(i, col)));
            *reinterpret_cast<__nv_bfloat162*>(yb + (l0 + i) * a.syl + col) =
                __floats2bfloat162_rn(fmaf(Dh, xv.x, yacc[n8][2 * half]),
                                      fmaf(Dh, xv.y, yacc[n8][2 * half + 1]));
          }
        }
      }
    }

    // ---- S = exp(cum_Q) S + (w o B)^T x, this warp's units -------------
    {
      const float decay = expf(cum_last);
#pragma unroll
      for (int u = 0; u < MAXU; ++u)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[u][n][e] *= decay;
      // straight-line code for each count, so the units' products overlap
      if (nu == 1) state_units<N, 1>(sacc, ubase, nt, sb, sx, ww, lane);
      if (nu == 2) state_units<N, 2>(sacc, ubase, nt, sb, sx, ww, lane);
      if constexpr (MAXU == 4) {
        if (nu == 3) state_units<N, 3>(sacc, ubase, nt, sb, sx, ww, lane);
        if (nu == 4) state_units<N, 4>(sacc, ubase, nt, sb, sx, ww, lane);
      }
    }
    // ---- the state: on to the next block, or to this chain's next chunk
    if (hand_on) {
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        if (u < nu) {
          const int id = ubase + u, r = (id >> 1) * 16 + g;
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) {
            const int col = (id & 1) * 32 + n8 * 8 + 2 * t4;
            *reinterpret_cast<float2*>(gstate + r * P + col) =
                make_float2(sacc[u][n8][0], sacc[u][n8][1]);
            *reinterpret_cast<float2*>(gstate + (r + 8) * P + col) =
                make_float2(sacc[u][n8][2], sacc[u][n8][3]);
          }
        }
      }
      __threadfence();
    }
    __syncthreads();  // every warp is done with the tiles and the old parts
    if (hand_on && tid == 0) atomicExch(&a.ready[tk.chain], 1);
    if (goes_on) write_parts(sacc);
  }
}

template <int N>
int launch_ssd(const Args& a, int batch, cudaStream_t stream) {
  static bool attr_set = false;
  constexpr size_t smem = Layout<N>::bytes;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // rank-4 maps (columns, head or group, seq, batch), boxes of 64 x 1 x Q x 1
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(a.Q), 1};
  const long long dx[4] = {P, a.H, a.L, batch}, dbc[4] = {N, a.G, a.L, batch};
  const long long sx[3] = {a.sxh, a.sxl, a.sxb};
  const long long sb[3] = {a.sbg, a.sbl, a.sbb};
  const long long sc[3] = {a.scg, a.scl, a.scb};
  CUtensorMap tx, tb, tc;
  int rc = hopper::make_map_bf16(&tx, a.x, 4, dx, sx, box);
  if (!rc) rc = hopper::make_map_bf16(&tb, a.B, 4, dbc, sb, box);
  if (!rc) rc = hopper::make_map_bf16(&tc, a.C, 4, dbc, sc, box);
  if (rc) return rc;
  // persistent: one block an SM at most, each taking tasks in ticket order
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  Args b = a;
  const int nchunks = a.L / a.Q;
  b.per = max(nchunks, (a.tasks + n_sm - 1) / n_sm);
  ssd_scan_kernel<N><<<(a.tasks + b.per - 1) / b.per, NTHREADS, smem,
                       stream>>>(tx, tb, tc, b);
  return (int)cudaGetLastError();
}

template <int N>
int ssd_info(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, ssd_scan_kernel<N>);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *smem_bytes = (int)Layout<N>::bytes;
  return 0;
}

}  // namespace

extern "C" {

// strides: 15 element strides, (batch, seq, head or group) for x, dt, B, C
// and y in turn; x, B, C and y have a unit stride along their last dim,
// x, B and C 16-byte aligned bases and other strides multiples of 8.
// P must be 64, N 64 or 128, 1 <= Q <= 128 with L % Q == 0, H % G == 0.
// work: batch * H * (N * P + 1) four-byte words, zero before the first
// call; every call leaves it as the next one needs it.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* D, void* y,
                       int batch, int L, int H, int G, int P_, int N, int Q,
                       const long long* st, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P_ != P || Q < 1 || Q > QM || L % Q || G < 1 || H % G || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int chains = batch * H;
  float* state = static_cast<float*>(work);
  int* ready = reinterpret_cast<int*>(state + (size_t)chains * N * P);
  const Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const bf16*>(B),
               static_cast<const bf16*>(C), static_cast<const float*>(D),
               static_cast<bf16*>(y), H, G, L, Q,
               st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
               st[9], st[10], st[11], st[12], st[13], st[14],
               state, ready, chains * (L / Q), 0};
  if (N == 128) return launch_ssd<128>(a, batch, s);
  if (N == 64) return launch_ssd<64>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// registers a thread, local (spill) bytes and dynamic shared memory a
// block of the kernel for state width N (64 or 128)
int repro_ssd_scan_info(int N, int* regs, int* local_bytes,
                        int* smem_bytes) {
  if (N == 128) return ssd_info<128>(regs, local_bytes, smem_bytes);
  if (N == 64) return ssd_info<64>(regs, local_bytes, smem_bytes);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
