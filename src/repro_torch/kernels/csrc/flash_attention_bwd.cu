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
// What bounds it on the H100: operations.  The function needs 5 products
// of 2 S^2 hd FLOP a (batch, head): 10 B S^2 H hd, half that causal, on a
// few tensors read once, far above the card's ~295 FLOP/byte ridge.  This
// kernel does 7: S = Q K^T and dP = dO V^T are recomputed in each of its
// two passes, 14 B S^2 H hd (x 1/2 causal), the price of summing dQ
// without atomics (a single pass adding dQ with atomics does 5 products;
// its sums change order from run to run).
//
// Design, in the FlashAttention-3 pattern of flash_attention.cu: both
// passes are persistent, warp-specialised blocks of three warpgroups, one
// block an SM, taking work units off a per-call counter, longest first.
//   - a producer warpgroup (40 registers a thread after setmaxnreg; at 24
//     its thread spilled 36 bytes) whose
//     first thread loads a unit's resident tiles by TMA into one of two
//     buffers and streams the unit's tiles through a ring of shared-memory
//     stages guarded by full (transaction bytes) and empty (one arrival per
//     consumer warp) mbarriers; it runs ahead into the next unit;
//   - two consumer warpgroups (232 registers) of 64 resident rows each;
//     every product is a wgmma with its accumulator in registers.
// Tiles are rank-4 tensor maps (hd, heads, seq, batch) over the real
// strides in 64-column boxes, 128-byte swizzle; rows past the sequence
// load as zeros.  hd 128 streams 64 rows a step, hd 64 128 (FA3's
// register budget: S and dP of a step 32 f32 registers a thread each at
// hd 128, 64 at hd 64, beside two 64 x hd accumulators).
//
//   delta  hd/8 lanes a (batch, head, row), a 16-byte load each of o and
//          dO: delta = rowsum(dO o O) and lse * log2(e) into (B, H, Sq_pad)
//          f32 rows padded to 128 (+inf and 0 past Sq), so that both
//          passes bulk-copy whole 16-byte aligned rows of them.
//   dK/dV  a unit is (key block of 128, batch, K/V head, split): K and V of
//          the block resident; the producer walks the unit's q heads
//          (kv_head scanned on the device, in head order) and their q
//          tiles from the diagonal on, streaming Q, dO and the two f32
//          rows.  A warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T
//          (SS, both operands K-major), P^T = exp2(S^T c - lse2) masked on
//          the diagonal tiles, dS^T = P^T (dP^T - delta), then dV += P^T dO
//          and dK += dS^T Q (RS: P^T and dS^T rounded to bf16 from the
//          accumulators straight into the A fragment, dO and Q read
//          MN-major).  Units go key block 0 first, the longest under the
//          causal mask.  Where B Hk ceil(Sk/128) units cannot fill the
//          card, each K/V head's q heads are split over ``splits`` units
//          (flash_attention.py:flash_bwd_geometry, a function of the
//          shapes and the SM count): unit s takes the heads of ranks
//          [s cnt / splits, (s+1) cnt / splits) among the cnt heads mapped
//          to its K/V head, writes f32 partial rows to a workspace, and a
//          reduce pass sums the partials in split order into bf16.
//   dQ     a unit is (q block of 128, batch, q head), the last q block
//          first: Q, dO, lse2 and delta resident, K and V tiles streamed up
//          to the diagonal.  S = Q K^T, dP = dO V^T (SS), dS as above,
//          dQ += dS K (RS, K read MN-major).
// Every output element is summed by one thread in a fixed order (and the
// split partials in split order), so two runs give the same bits.
#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BLK = 128;          // resident rows a block, 64 a warpgroup
constexpr int NCONS = 2;                 // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int RBOX = BLK * 128;          // a resident 128-row x 64-column box
constexpr int MAX_HEADS = 256;           // q heads a call may have
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct BwdCfg {
  static constexpr int HALVES = HD / 64;             // boxes a row tile
  static constexpr int BS = HD == 128 ? 64 : 128;    // streamed rows a step
  static constexpr int STAGES = HD == 128 ? 2 : 4;
  static constexpr int SBOX = BS * 128;              // a streamed box
  static constexpr int RTILE = HALVES * RBOX;        // one resident tile
  static constexpr int STILE = HALVES * SBOX;        // one streamed tile
  static constexpr int RES_BYTES = 2 * RTILE;        // K, V or Q, dO
  static constexpr int STAGE_BYTES = 2 * STILE;      // Q, dO or K, V
  // two resident buffers, the ring, then f32 rows (dK/dV: a stage's lse2
  // and delta; dQ: a resident buffer's), barriers, the units' numbers, the
  // stages' first q rows and the dK/dV unit's q heads
  static constexpr int STAT_FLOATS =
      (2 * STAGES * BS > 4 * BLK) ? 2 * STAGES * BS : 4 * BLK;
  static constexpr size_t SMEM =
      1024 + 2 * RES_BYTES + STAGES * STAGE_BYTES + STAT_FLOATS * 4 +
      (4 + 2 * STAGES) * sizeof(uint64_t) +
      (4 + STAGES + MAX_HEADS) * sizeof(int);
};

struct Strides {            // element strides (batch, seq, head)
  long long b, s, h;
};

struct BwdArgs {
  const int* kv_head;
  const float* lse2;         // (B, H, Sq_pad): lse * log2(e), +inf past Sq
  const float* delta;        // (B, H, Sq_pad): rowsum(dO o O), 0 past Sq
  int* counter;              // [2]: the dK/dV pass's, the dQ pass's
  bf16 *dq, *dk, *dv;
  float* work;               // (2, splits, B, Sk, Hk, hd) f32 where splits > 1
  Strides sdq, sdk, sdv;
  int B, H, Hk, Sq, Sk, Sq_pad, causal, splits;
  float scale, scale_log2;
};

// the shared-memory layout of both passes, every address an offset of
// one base
template <int HD>
struct Smem {
  using C = BwdCfg<HD>;
  uint8_t* res;              // [2][RES_BYTES]
  __device__ __forceinline__ explicit Smem(uint8_t* raw)
      : res(hopper::smem_aligned_1024(raw)) {}
  __device__ __forceinline__ uint8_t* ring() const {   // [STAGES][STAGE_BYTES]
    return res + 2 * C::RES_BYTES;
  }
  __device__ __forceinline__ float* stat() const {
    return reinterpret_cast<float*>(ring() + C::STAGES * C::STAGE_BYTES);
  }
  __device__ __forceinline__ uint64_t* r_full() const {     // [2]
    return reinterpret_cast<uint64_t*>(stat() + C::STAT_FLOATS);
  }
  __device__ __forceinline__ uint64_t* r_empty() const { return r_full() + 2; }
  __device__ __forceinline__ uint64_t* full() const { return r_full() + 4; }
  __device__ __forceinline__ uint64_t* empty() const {
    return full() + C::STAGES;
  }
  __device__ __forceinline__ int* unit_of() const {         // [2]
    return reinterpret_cast<int*>(empty() + C::STAGES);
  }
  __device__ __forceinline__ int* steps_of() const { return unit_of() + 2; }
  __device__ __forceinline__ int* m0_of() const { return unit_of() + 4; }
  __device__ __forceinline__ int* heads() const {           // [MAX_HEADS]
    return m0_of() + C::STAGES;
  }
  __device__ __forceinline__ void init() const {
    using namespace hopper;
    for (int x = 0; x < 2; ++x) {
      mbar_init(&r_full()[x], 1);
      mbar_init(&r_empty()[x], NCONS * 4);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full()[s], 1);
      mbar_init(&empty()[s], NCONS * 4);
    }
    mbar_fence_init();
  }
};

// acc (64 x N) = A B^T over HD: A the warpgroup's 64 rows of a resident
// tile, B the N rows of a streamed tile, both stored [row][hd] (K-major)
template <int HD, int N>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], const uint8_t* a,
                                       const uint8_t* b) {
  using namespace hopper;
  constexpr int SBOX = BwdCfg<HD>::SBOX;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int x = kk / 4, k32 = (kk % 4) * 32;
    const uint64_t da = desc_k_major(a + x * RBOX + k32);
    const uint64_t db = desc_k_major(b + x * SBOX + k32);
    if constexpr (N == 64)
      wgmma_m64n64k16_ss<0>(acc, da, db, kk > 0);
    else
      wgmma_m64n128k16_ss<0>(acc, da, db, kk > 0);
  }
}

// acc (64 x HD) += F B: F in registers (a 64 x BS accumulator rounded to
// bf16 fragments), B the BS rows of a streamed tile stored [row][hd],
// read MN-major
template <int HD>
__device__ __forceinline__ void mma_rs(
    float (&acc)[HD / 2], const uint32_t (&f)[BwdCfg<HD>::BS / 16][4],
    const uint8_t* b) {
  using namespace hopper;
  constexpr int SBOX = BwdCfg<HD>::SBOX;
#pragma unroll
  for (int kk = 0; kk < BwdCfg<HD>::BS / 16; ++kk) {
    const uint64_t db = desc_mn_major(b + kk * 2048, SBOX);
    if constexpr (HD == 128)
      wgmma_m64n128k16_rs<1>(acc, f[kk], db, 1);
    else
      wgmma_m64n64k16_rs<1>(acc, f[kk], db, 1);
  }
}

// the bf16 A fragments of a 64 x N accumulator (registers 8kk .. 8kk+7
// hold its columns 16kk .. 16kk+15)
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 16][4],
                                         const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] =
          hopper::pack_bf16x2(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// a 64 x HD accumulator (rows row0 + acc_row (+8)) times ``scale``: bf16
// into a strided tensor (rows past ``n`` dropped) or, where ``ws`` is
// given, f32 into the workspace rows ``ws + row * ws_row``
template <int HD>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 2],
                                          bf16* dst, Strides st, float* ws,
                                          long long ws_row, int b, int h,
                                          int row0, int n, float scale,
                                          int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + hopper::acc_row(t) + 8 * i;
    if (r >= n) continue;
    if (ws != nullptr) {
      float* out = ws + (long long)r * ws_row + hopper::acc_col(t);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    } else {
      bf16* out = dst + b * st.b + (long long)r * st.s + h * st.h +
                  hopper::acc_col(t);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) = hopper::pack_bf16x2(
            acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// lse2 and delta rows padded to Sq_pad: HD/8 lanes a (batch, head, row),
// a 16-byte load each of o and dO
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                       const float* __restrict__ lse, float* __restrict__ lse2,
                       float* __restrict__ delta, int B, int H, int Sq,
                       int Sq_pad, Strides so, Strides sdo) {
  constexpr int LPR = HD / 8;              // lanes a row
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / LPR;
  const int part = threadIdx.x % LPR;
  const bool live = w < (long long)B * H * Sq_pad;
  const int s = (int)(w % Sq_pad), h = (int)((w / Sq_pad) % H),
            b = (int)(w / Sq_pad / H);
  float acc = 0.f;
  if (live && s < Sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * so.b + (long long)s * so.s + h * so.h + 8 * part);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dO + b * sdo.b + (long long)s * sdo.s + h * sdo.h + 8 * part);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(op[e]), y = __bfloat1622float2(dp[e]);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && part == 0) {
    delta[w] = acc;
    lse2[w] = s < Sq ? lse[((long long)b * H + h) * Sq + s] * LOG2E : INFINITY;
  }
}

// dK/dV unit ``unit``: key block major (block 0, the longest under the
// causal mask, first), then batch, K/V head and split
struct KvUnit {
  int b, kvh, split, n0;
  __device__ __forceinline__ KvUnit(int unit, int B, int Hk, int splits) {
    split = unit % splits;
    int r = unit / splits;
    kvh = r % Hk;
    r /= Hk;
    b = r % B;
    n0 = r / B * BLK;
  }
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const BwdArgs a) {
  using C = BwdCfg<HD>;
  using namespace hopper;
  constexpr int BS = C::BS;
  extern __shared__ uint8_t smem_raw[];
  Smem<HD> sm(smem_raw);
  const int n_units = (a.Sk + BLK - 1) / BLK * a.B * a.Hk * a.splits;
  const int n_qt = (a.Sq + BS - 1) / BS;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;                            // stages filled so far
      for (int ui = 0;; ++ui) {
        const int rb = ui & 1;
        const int unit = atomicAdd(&a.counter[0], 1);
        mbar_wait(&sm.r_empty()[rb], ((ui >> 1) & 1) ^ 1);
        sm.unit_of()[rb] = unit;
        if (unit >= n_units) {               // no unit left: tell the consumers
          mbar_arrive(&sm.r_full()[rb]);
          break;
        }
        const KvUnit u(unit, a.B, a.Hk, a.splits);
        // the unit's q heads: of the cnt heads mapped to its K/V head, in
        // head order, the ranks [split cnt / splits, (split+1) cnt / splits)
        int cnt = 0;
        for (int h = 0; h < a.H; ++h) cnt += a.kv_head[h] == u.kvh;
        const int lo = u.split * cnt / a.splits;
        const int hi = (u.split + 1) * cnt / a.splits;
        for (int h = 0, rank = 0; h < a.H; ++h)
          if (a.kv_head[h] == u.kvh) {
            if (rank >= lo && rank < hi) sm.heads()[rank - lo] = h;
            ++rank;
          }
        const int qt0 = a.causal ? u.n0 / BS : 0;   // tiles above the diagonal
        const int per_head = max(0, n_qt - qt0);
        const int steps = (hi - lo) * per_head;
        sm.steps_of()[rb] = steps;
        uint8_t* res = sm.res + rb * C::RES_BYTES;
        mbar_arrive_expect_tx(&sm.r_full()[rb], C::RES_BYTES);
#pragma unroll
        for (int x = 0; x < C::HALVES; ++x) {
          tma_load_4d(res + x * RBOX, &tk, &sm.r_full()[rb], x * 64, u.kvh,
                      u.n0, u.b);
          tma_load_4d(res + C::RTILE + x * RBOX, &tv, &sm.r_full()[rb],
                      x * 64, u.kvh, u.n0, u.b);
        }
        // head j of the unit's list, q tile qt
        for (int j = steps > 0 ? 0 : hi - lo, qt = qt0; j < hi - lo; ++it) {
          const int h = sm.heads()[j];
          const int m0 = qt * BS;
          if (++qt == n_qt) {
            qt = qt0;
            ++j;
          }
          const int s = it % C::STAGES;
          mbar_wait(&sm.empty()[s], ((it / C::STAGES) & 1) ^ 1);
          sm.m0_of()[s] = m0;
          mbar_arrive_expect_tx(&sm.full()[s], C::STAGE_BYTES + 2 * BS * 4);
          uint8_t* stage = sm.ring() + s * C::STAGE_BYTES;
#pragma unroll
          for (int x = 0; x < C::HALVES; ++x) {
            tma_load_4d(stage + x * C::SBOX, &tq, &sm.full()[s], x * 64, h, m0,
                        u.b);
            tma_load_4d(stage + C::STILE + x * C::SBOX, &tdo, &sm.full()[s],
                        x * 64, h, m0, u.b);
          }
          float* stat = sm.stat() + s * 2 * BS;
          const long long row = ((long long)u.b * a.H + h) * a.Sq_pad + m0;
          bulk_load(stat, a.lse2 + row, BS * 4, &sm.full()[s]);
          bulk_load(stat + BS, a.delta + row, BS * 4, &sm.full()[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 keys a warpgroup ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int w = wg - 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int col0 = acc_col(t);
  int it = 0;                                // stages consumed so far
  for (int ui = 0;; ++ui) {
    const int rb = ui & 1;
    mbar_wait(&sm.r_full()[rb], (ui >> 1) & 1);
    const int unit = sm.unit_of()[rb];
    if (unit >= n_units) break;
    const int steps = sm.steps_of()[rb];
    const KvUnit u(unit, a.B, a.Hk, a.splits);
    const int n0w = u.n0 + 64 * w;           // this warpgroup's first key
    const int key0 = n0w + acc_row(t);       // + 8 for i = 1
    const uint8_t* sK = sm.res + rb * C::RES_BYTES + w * 8192;
    const uint8_t* sV = sK + C::RTILE;

    float dv[HD / 2], dk[HD / 2];
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) dv[r] = dk[r] = 0.f;

    for (int st = 0; st < steps; ++st, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(&sm.full()[s], (it / C::STAGES) & 1);
      const int m0 = sm.m0_of()[s];
      const uint8_t* sQ = sm.ring() + s * C::STAGE_BYTES;
      const uint8_t* sDO = sQ + C::STILE;
      const float* l2 = sm.stat() + s * 2 * BS;
      const float* dl = l2 + BS;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BS q rows each
      float sT[BS / 2], dpT[BS / 2];
      wgmma_fence();
      mma_ss<HD, BS>(sT, sK, sQ);
      wgmma_commit();
      mma_ss<HD, BS>(dpT, sV, sDO);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sT);

      // P^T = exp2(S^T c - lse2[q]), zero above the causal diagonal
      const bool diag = a.causal && m0 < n0w + 64;
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j + col0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sT[4 * j + 2 * i + c];
            x = exp2_ftz(fmaf(x, a.scale_log2, -(c ? l.y : l.x)));
            if (diag && key0 + 8 * i > m0 + 8 * j + col0 + c) x = 0.f;
          }
      }
      wgmma_wait<0>();
      fence_regs(dpT);
      // dS^T = P^T (dP^T - delta[q])
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j + col0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dpT[4 * j + 2 * i] = sT[4 * j + 2 * i] * (dpT[4 * j + 2 * i] - d.x);
          dpT[4 * j + 2 * i + 1] =
              sT[4 * j + 2 * i + 1] * (dpT[4 * j + 2 * i + 1] - d.y);
        }
      }
      uint32_t pf[BS / 16][4], df[BS / 16][4];
      to_frags<BS>(pf, sT);
      to_frags<BS>(df, dpT);

      // dV += P^T dO, dK += dS^T Q
      wgmma_fence();
      mma_rs<HD>(dv, pf, sDO);
      mma_rs<HD>(dk, df, sQ);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty()[s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.r_empty()[rb]);   // K and V may refill

    // bf16 rows, or f32 partial rows of this split
    float* wk = nullptr;
    float* wv = nullptr;
    const long long ws_row = (long long)a.Hk * HD;
    if (a.splits > 1) {
      const long long plane = (long long)a.B * a.Sk * ws_row;
      wk = a.work + ((long long)u.split * a.B + u.b) * a.Sk * ws_row +
           u.kvh * HD;
      wv = wk + plane * a.splits;
    }
    store_acc<HD>(dk, a.dk, a.sdk, wk, ws_row, u.b, u.kvh, n0w, a.Sk, a.scale,
                  t);
    store_acc<HD>(dv, a.dv, a.sdv, wv, ws_row, u.b, u.kvh, n0w, a.Sk, 1.f, t);
  }
}

// dQ unit ``unit``: the last q block first, then batch and q head
struct QUnit {
  int b, h, m0;
  __device__ __forceinline__ QUnit(int unit, int B, int H, int n_qb) {
    const int bh = unit % (B * H);
    b = bh / H;
    h = bh % H;
    m0 = (n_qb - 1 - unit / (B * H)) * BLK;
  }
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const BwdArgs a) {
  using C = BwdCfg<HD>;
  using namespace hopper;
  constexpr int BS = C::BS;
  extern __shared__ uint8_t smem_raw[];
  Smem<HD> sm(smem_raw);
  const int n_qb = (a.Sq + BLK - 1) / BLK;
  const int n_units = n_qb * a.B * a.H;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int ui = 0;; ++ui) {
        const int rb = ui & 1;
        const int unit = atomicAdd(&a.counter[1], 1);
        mbar_wait(&sm.r_empty()[rb], ((ui >> 1) & 1) ^ 1);
        sm.unit_of()[rb] = unit;
        if (unit >= n_units) {
          mbar_arrive(&sm.r_full()[rb]);
          break;
        }
        const QUnit u(unit, a.B, a.H, n_qb);
        const int kvh = a.kv_head[u.h];
        uint8_t* res = sm.res + rb * C::RES_BYTES;
        float* stat = sm.stat() + rb * 2 * BLK;
        const long long row0 = ((long long)u.b * a.H + u.h) * a.Sq_pad + u.m0;
        mbar_arrive_expect_tx(&sm.r_full()[rb], C::RES_BYTES + 2 * BLK * 4);
#pragma unroll
        for (int x = 0; x < C::HALVES; ++x) {
          tma_load_4d(res + x * RBOX, &tq, &sm.r_full()[rb], x * 64, u.h, u.m0,
                      u.b);
          tma_load_4d(res + C::RTILE + x * RBOX, &tdo, &sm.r_full()[rb], x * 64,
                      u.h, u.m0, u.b);
        }
        bulk_load(stat, a.lse2 + row0, BLK * 4, &sm.r_full()[rb]);
        bulk_load(stat + BLK, a.delta + row0, BLK * 4, &sm.r_full()[rb]);
        const int n_end = a.causal ? min(a.Sk, u.m0 + BLK) : a.Sk;
        const int n_tiles = (n_end + BS - 1) / BS;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&sm.empty()[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.full()[s], C::STAGE_BYTES);
          uint8_t* st = sm.ring() + s * C::STAGE_BYTES;
#pragma unroll
          for (int x = 0; x < C::HALVES; ++x) {
            tma_load_4d(st + x * C::SBOX, &tk, &sm.full()[s], x * 64, kvh,
                        j * BS, u.b);
            tma_load_4d(st + C::STILE + x * C::SBOX, &tv, &sm.full()[s], x * 64,
                        kvh, j * BS, u.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 q rows a warpgroup ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int w = wg - 1;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int col0 = acc_col(t);
  int it = 0;
  for (int ui = 0;; ++ui) {
    const int rb = ui & 1;
    mbar_wait(&sm.r_full()[rb], (ui >> 1) & 1);
    const int unit = sm.unit_of()[rb];
    if (unit >= n_units) break;
    const QUnit u(unit, a.B, a.H, n_qb);
    const int r0 = 64 * w + acc_row(t);      // + 8 for i = 1, in the block
    const int qpos0 = u.m0 + r0;
    const uint8_t* sQ = sm.res + rb * C::RES_BYTES + w * 8192;
    const uint8_t* sDO = sQ + C::RTILE;
    const float* stat = sm.stat() + rb * 2 * BLK;
    const float lrow[2] = {stat[r0], stat[r0 + 8]};
    const float drow[2] = {stat[BLK + r0], stat[BLK + r0 + 8]};
    const int n_end = a.causal ? min(a.Sk, u.m0 + BLK) : a.Sk;
    const int n_tiles = (n_end + BS - 1) / BS;

    float dq[HD / 2];
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) dq[r] = 0.f;

    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(&sm.full()[s], (it / C::STAGES) & 1);
      const uint8_t* sK = sm.ring() + s * C::STAGE_BYTES;
      const uint8_t* sV = sK + C::STILE;

      // S = Q K^T and dP = dO V^T: 64 q rows x BS keys each
      float sc[BS / 2], dp[BS / 2];
      wgmma_fence();
      mma_ss<HD, BS>(sc, sQ, sK);
      wgmma_commit();
      mma_ss<HD, BS>(dp, sDO, sV);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P = exp2(S c - lse2[q]); zero past Sk and above the diagonal
      const int n0 = j * BS;
      const bool edge = n0 + BS > a.Sk ||
                        (a.causal && n0 + BS - 1 > u.m0 + 64 * w);
#pragma unroll
      for (int jj = 0; jj < BS / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * jj + 2 * i + c];
            x = exp2_ftz(fmaf(x, a.scale_log2, -lrow[i]));
            const int key = n0 + 8 * jj + col0 + c;
            if (edge && (key >= a.Sk || (a.causal && key > qpos0 + 8 * i)))
              x = 0.f;
          }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - delta[q])
#pragma unroll
      for (int jj = 0; jj < BS / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = dp[4 * jj + 2 * i + c];
            x = sc[4 * jj + 2 * i + c] * (x - drow[i]);
          }
      uint32_t df[BS / 16][4];
      to_frags<BS>(df, dp);

      // dQ += dS K
      wgmma_fence();
      mma_rs<HD>(dq, df, sK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty()[s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.r_empty()[rb]);   // Q and dO may refill
    store_acc<HD>(dq, a.dq, a.sdq, nullptr, 0, u.b, u.h, u.m0 + 64 * w, a.Sq,
                  a.scale, t);
  }
}

// dK and dV: the splits' f32 partial rows summed in split order, four
// elements a thread
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ work, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int B, int Sk, int Hk, int hd,
                        int splits, Strides sdk, Strides sdv, float scale) {
  const long long plane = (long long)B * Sk * Hk * hd;
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= 2 * plane) return;
  const int which = e >= plane;                    // 0: dK, 1: dV
  const long long i = e - which * plane;
  const float* src = work + which * plane * splits + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(src + s * plane);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const int c = (int)(i % hd);
  const int kvh = (int)((i / hd) % Hk);
  const int key = (int)((i / hd / Hk) % Sk);
  const int b = (int)(i / hd / Hk / Sk);
  const Strides st = which ? sdv : sdk;
  const float f = which ? 1.f : scale;
  bf16* out = (which ? dv : dk) + b * st.b + (long long)key * st.s +
              kvh * st.h + c;
  uint32_t* pair = reinterpret_cast<uint32_t*>(out);
  pair[0] = hopper::pack_bf16x2(acc.x * f, acc.y * f);
  pair[1] = hopper::pack_bf16x2(acc.z * f, acc.w * f);
}

int sm_count(int* n) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *n = n_sm;
  return 0;
}

// a rank-4 map (hd, heads, seq, batch) over a (B, S, heads, hd) tensor
// with element strides ``st`` (batch, seq, head), loading boxes of ``rows``
template <int HD>
int map_of(CUtensorMap* m, const void* p, int B, int S, int heads,
           const long long* st, int rows) {
  const long long dims[4] = {HD, heads, S, B};
  const long long strides[3] = {st[2], st[1], st[0]};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hopper::make_map_bf16(m, p, 4, dims, strides, box);
}

template <int HD>
int launch_bwd(const BwdArgs& a, const void* q, const void* k, const void* v,
               const void* o, const void* dO, const float* lse, float* lse2,
               float* delta, const long long* st, cudaStream_t stream) {
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
    const int budget = 128 * (PRODUCER_REGS + NCONS * CONSUMER_REGS);
    int rc = hopper::check_register_budget(
        (const void*)flash_bwd_dkdv_kernel<HD>, NTHREADS, budget);
    if (!rc)
      rc = hopper::check_register_budget((const void*)flash_bwd_dq_kernel<HD>,
                                         NTHREADS, budget);
    if (rc) return rc;
    ready = true;
  }
  CUtensorMap tq, tdo, tk, tv, tqs, tdos, tks, tvs;
  int rc = map_of<HD>(&tq, q, a.B, a.Sq, a.H, st + 0, BLK);
  if (!rc) rc = map_of<HD>(&tqs, q, a.B, a.Sq, a.H, st + 0, C::BS);
  if (!rc) rc = map_of<HD>(&tdo, dO, a.B, a.Sq, a.H, st + 12, BLK);
  if (!rc) rc = map_of<HD>(&tdos, dO, a.B, a.Sq, a.H, st + 12, C::BS);
  if (!rc) rc = map_of<HD>(&tk, k, a.B, a.Sk, a.Hk, st + 3, BLK);
  if (!rc) rc = map_of<HD>(&tks, k, a.B, a.Sk, a.Hk, st + 3, C::BS);
  if (!rc) rc = map_of<HD>(&tv, v, a.B, a.Sk, a.Hk, st + 6, BLK);
  if (!rc) rc = map_of<HD>(&tvs, v, a.B, a.Sk, a.Hk, st + 6, C::BS);
  int n_sm = 0;
  if (!rc) rc = sm_count(&n_sm);
  if (rc) return rc;

  const long long rows = (long long)a.B * a.H * a.Sq_pad;   // HD/8 lanes each
  const Strides so = {st[9], st[10], st[11]}, sdo = {st[12], st[13], st[14]};
  const long long per_block = 256 / (HD / 8);
  flash_bwd_delta_kernel<HD><<<(unsigned)((rows + per_block - 1) / per_block),
                               256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), lse, lse2,
      delta, a.B, a.H, a.Sq, a.Sq_pad, so, sdo);
  const int kv_units = (a.Sk + BLK - 1) / BLK * a.B * a.Hk * a.splits;
  flash_bwd_dkdv_kernel<HD><<<min(kv_units, n_sm), NTHREADS, C::SMEM,
                              stream>>>(tk, tv, tqs, tdos, a);
  if (a.splits > 1) {
    const long long quads = 2LL * a.B * a.Sk * a.Hk * HD / 4;
    flash_bwd_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0,
                              stream>>>(a.work, a.dk, a.dv, a.B, a.Sk, a.Hk,
                                        HD, a.splits, a.sdk, a.sdv, a.scale);
  }
  const int q_units = (a.Sq + BLK - 1) / BLK * a.B * a.H;
  flash_bwd_dq_kernel<HD><<<min(q_units, n_sm), NTHREADS, C::SMEM, stream>>>(
      tq, tdo, tks, tvs, a);
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
// contiguous (B, H, Sq) f32 log-sum-exp; aux: (2, B, H, Sq_pad) f32
// scratch with Sq_pad = Sq rounded up to 128; counter: two int32 zeros;
// work: (2, splits, B, Sk, Hk, hd) f32 scratch where splits > 1 (else
// null).  dk and dv are written whole (every key row of every K/V head),
// so they need no zero fill.  Returns cudaGetLastError() after the
// launches, or the error of the tensor-map encoding (0 on success).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dO, const void* lse,
                              const void* kv_head, void* aux, void* counter,
                              void* work, void* dq, void* dk, void* dv, int B,
                              int H, int Hk, int Sq, int Sk, int hd,
                              const long long* st, int causal, float scale,
                              int splits, void* stream) {
  const int sq_pad = (Sq + BLK - 1) / BLK * BLK;
  if (B < 1 || H < 1 || H > MAX_HEADS || Hk < 1 || Sq < 1 || Sk < 1 ||
      splits < 1 || splits > H || (splits > 1 && work == nullptr) ||
      (long long)B * H * (sq_pad / BLK) > 0x7fffffffLL ||
      (long long)B * Hk * ((Sk + BLK - 1) / BLK) * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  float* lse2 = static_cast<float*>(aux);
  float* delta = lse2 + (long long)B * H * sq_pad;
  a.kv_head = static_cast<const int*>(kv_head);
  a.lse2 = lse2;
  a.delta = delta;
  a.counter = static_cast<int*>(counter);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.work = static_cast<float*>(work);
  a.sdq = {st[15], st[16], st[17]};
  a.sdk = {st[18], st[19], st[20]};
  a.sdv = {st[21], st[22], st[23]};
  a.B = B;
  a.H = H;
  a.Hk = Hk;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Sq_pad = sq_pad;
  a.causal = causal;
  a.splits = splits;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (hd == 128)
    return launch_bwd<128>(a, q, k, v, o, dO, l, lse2, delta, st, s);
  if (hd == 64) return launch_bwd<64>(a, q, k, v, o, dO, l, lse2, delta, st, s);
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
