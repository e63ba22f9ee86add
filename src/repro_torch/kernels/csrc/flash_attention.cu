// Flash attention forward for Hopper (sm_90a), bf16 in and out, f32 softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (Pallas body _flash_kernel).  Same function: blockwise online-softmax
// attention, scale 1/sqrt(hd), causal mask kpos <= qpos aligned top-left
// even when Sq != Sk, f32 statistics and accumulator, output in q's dtype,
// hd in {64, 128}, GQA through kv_head read in place.
//
// What bounds it on the H100: operations.  At the prefill shape of the
// main path (B=2, S=2048, H=32, hd=128, causal) one call does ~69 GFLOP on
// ~67 MB of q/k/v/o, ~1000 FLOP per byte, far above the card's ~295
// FLOP/byte ridge, so the tensor cores must be kept busy: both products
// run as wgmma with the score tile and the output accumulator in
// registers, and TMA streams K and V into shared memory behind them.
//
// Design, in the FlashAttention-3 pattern.  A persistent kernel: one
// block an SM, each taking q tiles of 128 rows off a per-call counter in
// batch*head-major order, the longest (last) q tile of a head first, so
// the q tiles of one head run together and share its K and V through L2,
// and the long tiles start early.  Three warpgroups a block:
//   - a producer warpgroup (40 registers a thread after setmaxnreg) whose
//     first thread takes the next tile, loads its Q into one of two Q
//     buffers by TMA and streams its 128-key K and V tiles through a ring
//     of STAGES shared-memory stages, each guarded by a "full" mbarrier
//     (transaction bytes) and an "empty" one (one arrival per consumer
//     warp); it runs ahead into the next tile while the consumers finish
//     this one, so a tile's loads wait on nothing but the ring;
//   - two consumer warpgroups (232 registers) of 64 q rows each:
//     S = Q K^T as wgmma m64n128k16 SS (K stored [key][hd] is K-major),
//     the mask on the last tile only, online softmax in the log2 domain on
//     the registers (ex2.approx.ftz; a row lives in the 4 threads of a
//     quad: two shuffles for its max; each thread keeps a partial row sum
//     until the end), P rounded to bf16 straight into the A-operand
//     fragment, and O += P V as wgmma RS (V stored [key][hd] is MN-major:
//     the transpose bit).
// The epilogue divides by l, writes each warpgroup's 64 rows into its
// (spent) rows of the Q buffer in the swizzled box layout and stores them
// by TMA, which clips the rows past Sq; then the Q buffer may refill.
// When a gradient is to follow, the epilogue also writes each row's
// log-sum-exp (f32, natural log) into a (B, H, Sq) buffer, from which the
// backward (flash_attention_bwd.cu) recomputes the probabilities; the
// serve path passes no buffer and writes nothing more.
// Q/K/V/O are rank-4 tensor maps (hd, heads, seq, batch) with their real
// strides, so fused-QKV views are read in place and the boxes are
// zero-filled past the sequence's end.  An hd=128 row tile is two
// 64-column boxes (the 128-byte swizzle's limit).  Under causal the key
// loop stops at the diagonal tile.  A row's result depends only on its
// own q, k and v: nothing is split over keys, so the kernel is batch
// invariant (NanoFlow's halves equal the whole bitwise).
// Ping-pong ordering of the two warpgroups, a third K/V stage and
// FlashAttention-3's intra-warpgroup overlap (tile j's Q K^T issued
// before tile j-1's P V) were measured and gained nothing (PERF.md).
#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;                  // q rows per block
constexpr int BN = 128;                  // keys per tile
constexpr int NCONS = 2;                 // consumer warpgroups, 64 rows each
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr int BOX_BYTES = 128 * 128;     // one 128-row x 64-column box

template <int HD>
struct FlashCfg {
  static constexpr int HALVES = HD / 64;             // boxes per row tile
  static constexpr int STAGES = HD == 128 ? 2 : 4;
  static constexpr int TILE_BYTES = HALVES * BOX_BYTES;   // Q, K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;      // K and V
  // two Q buffers (the next tile's Q loads under this one), the K/V ring,
  // the barriers and the two tiles' numbers
  static constexpr size_t SMEM = 1024 + 2 * TILE_BYTES + STAGES * STAGE_BYTES +
                                 (4 + 2 * STAGES) * sizeof(uint64_t) +
                                 2 * sizeof(int);
};

// Tile ``tile`` of a call: batch*head-major (the q tiles of one head run
// together and share its K/V through L2), the longest (last) q tile first.
struct FlashTile {
  int b, h, m0, n_tiles;
  __device__ __forceinline__ FlashTile(int tile, int n_qt, int H, int Sk,
                                       int causal) {
    const int bh = tile / n_qt;
    b = bh / H;
    h = bh % H;
    m0 = (n_qt - 1 - tile % n_qt) * BM;
    const int n_end = causal ? min(Sk, m0 + BM) : Sk;
    n_tiles = (n_end + BN - 1) / BN;
  }
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to,
                 const int* __restrict__ kv_head, int* __restrict__ counter,
                 float* __restrict__ lse, int BH, int H, int Sq, int Sk,
                 int causal, float scale_log2) {
  using C = FlashCfg<HD>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_aligned_1024(smem_raw);            // [2] Q tiles
  uint8_t* sKV = sQ + 2 * C::TILE_BYTES;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(sKV + C::STAGES * C::STAGE_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + C::STAGES;
  int* tile_of = reinterpret_cast<int*>(empty + C::STAGES);   // [2]

  const int n_qt = (Sq + BM - 1) / BM;
  const int n_total = n_qt * BH;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(&q_full[x], 1);
      mbar_init(&q_empty[x], NCONS);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: takes tiles off the call's counter until it runs dry
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;                            // K/V tiles loaded so far
      for (int qi = 0;; ++qi) {
        const int qb = qi & 1;
        const int tile = atomicAdd(counter, 1);
        mbar_wait(&q_empty[qb], ((qi >> 1) & 1) ^ 1);
        tile_of[qb] = tile;
        if (tile >= n_total) {               // no tile left: tell the consumers
          mbar_arrive(&q_full[qb]);
          break;
        }
        const FlashTile ft(tile, n_qt, H, Sk, causal);
        const int kvh = kv_head[ft.h];
        uint8_t* q_dst = sQ + qb * C::TILE_BYTES;
        mbar_arrive_expect_tx(&q_full[qb], C::TILE_BYTES);
#pragma unroll
        for (int x = 0; x < C::HALVES; ++x)
          tma_load_4d(q_dst + x * BOX_BYTES, &tq, &q_full[qb], x * 64, ft.h,
                      ft.m0, ft.b);
        for (int j = 0; j < ft.n_tiles; ++j, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
          uint8_t* sK = sKV + s * C::STAGE_BYTES;
          uint8_t* sV = sK + C::TILE_BYTES;
#pragma unroll
          for (int x = 0; x < C::HALVES; ++x) {
            tma_load_4d(sK + x * BOX_BYTES, &tk, &full[s], x * 64, kvh, j * BN,
                        ft.b);
            tma_load_4d(sV + x * BOX_BYTES, &tv, &full[s], x * 64, kvh, j * BN,
                        ft.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<232>();
  const int cw = wg - 1;                     // which 64 rows of the q tile
  const int t = threadIdx.x % 128, lane = t % 32;
  const int col0 = acc_col(t);
  int it = 0;                                // K/V tiles consumed so far
  for (int qi = 0;; ++qi) {
    const int qb = qi & 1;
    mbar_wait(&q_full[qb], (qi >> 1) & 1);
    const int tile = tile_of[qb];
    if (tile >= n_total) break;
    const FlashTile ft(tile, n_qt, H, Sk, causal);
    const int h = ft.h, b = ft.b, m0 = ft.m0, n_tiles = ft.n_tiles;
    const int row0 = m0 + cw * 64 + acc_row(t);   // + 8 for i = 1
    const uint8_t* sQt = sQ + qb * C::TILE_BYTES;

    float oacc[HD / 2];
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) oacc[r] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      const uint8_t* sK = sKV + s * C::STAGE_BYTES;
      const uint8_t* sV = sK + C::TILE_BYTES;

      // S = Q K^T: 64 x 128 f32 in registers
      float sacc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int x = kk / 4, k32 = (kk % 4) * 32;
        wgmma_m64n128k16_ss<0>(
            sacc, desc_k_major(sQt + x * BOX_BYTES + cw * 8192 + k32),
            desc_k_major(sK + x * BOX_BYTES + k32), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // the mask: past Sk, and the causal diagonal (both only in the last tile)
      const int n0 = j * BN;
      if (j == n_tiles - 1 && (n0 + BN > Sk || causal)) {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kpos = n0 + 8 * jj + col0 + c;
              if (kpos >= Sk || (causal && kpos > row0 + 8 * i))
                sacc[4 * jj + 2 * i + c] = -INFINITY;
            }
      }

      // online softmax, log2 domain
      float alpha[2], m_scaled[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          mx = fmaxf(mx, fmaxf(sacc[4 * jj + 2 * i], sacc[4 * jj + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = exp2_ftz((m_run[i] - m_use) * scale_log2);
        m_run[i] = m_new;
        m_scaled[i] = m_use * scale_log2;
      }
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& v = sacc[4 * jj + 2 * i + c];
            v = exp2_ftz(fmaf(v, scale_log2, -m_scaled[i]));
            rsum[i] += v;
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rsum[i];
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          oacc[4 * jj + 2 * i] *= alpha[i];
          oacc[4 * jj + 2 * i + 1] *= alpha[i];
        }

      // P in bf16, in the A-operand layout: keys 16kk.. are accumulator
      // columns 16kk.. (registers 8kk .. 8kk+7)
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] =
              pack_bf16x2(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);

      // O += P V
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = desc_mn_major(sV + kk * 2048, BOX_BYTES);
        if constexpr (HD == 128)
          wgmma_m64n128k16_rs<1>(oacc, pa[kk], dv, 1);
        else
          wgmma_m64n64k16_rs<1>(oacc, pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: O / l in q's dtype, written into this warpgroup's 64 rows of
    // the Q tile (free since its last Q K^T) in the box layout, then stored
    // by TMA one 64-column box at a time; rows past Sq are clipped
    uint8_t* sO = sQ + qb * C::TILE_BYTES + cw * 8192;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int r = acc_row(t) + 8 * i;
      // the row's log-sum-exp of the scaled scores, natural log, for the
      // backward (only when asked for: a null ``lse`` skips it); a row
      // with no key gets +inf, so that its probabilities recompute as 0
      if (lse != nullptr && (t & 3) == 0 && m0 + cw * 64 + r < Sq)
        lse[((size_t)b * H + h) * Sq + m0 + cw * 64 + r] =
            l > 0.f ? (m_run[i] * scale_log2 + __log2f(l)) * 0.69314718f
                    : INFINITY;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        const int c = 8 * jj + col0;
        *reinterpret_cast<uint32_t*>(sO + (c / 64) * BOX_BYTES +
                                     sw128_offset(r, c % 64)) =
            pack_bf16x2(oacc[4 * jj + 2 * i] * inv,
                        oacc[4 * jj + 2 * i + 1] * inv);
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + cw, 128);
    if (t == 0) {
#pragma unroll
      for (int x = 0; x < C::HALVES; ++x)
        tma_store_4d(&to, sO + x * BOX_BYTES, x * 64, h, m0 + cw * 64, b);
      tma_store_commit();
      tma_store_wait_read();
      mbar_arrive(&q_empty[qb]);               // this Q buffer may refill
    }
  }
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const int* kv_head, int* counter, float* lse, int B, int H,
                 int Hk, int Sq, int Sk,
                 const long long* st, int causal, float scale_log2,
                 cudaStream_t stream) {
  using C = FlashCfg<HD>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    // setmaxnreg: 40 producer + 2 x 232 consumer registers a thread
    const int rc = hopper::check_register_budget(
        (const void*)flash_fwd_kernel<HD>, NTHREADS, 128 * (40 + 2 * 232));
    if (rc) return rc;
    ready = true;
  }
  // rank-4 maps (hd, heads, seq, batch): loads in boxes of 64 x 1 x 128 x
  // 1, the output stored in boxes of 64 x 1 x 64 x 1 (one warpgroup's rows)
  const uint32_t box[4] = {64, 1, 128, 1}, obox[4] = {64, 1, 64, 1};
  CUtensorMap tq, tk, tv, to;
  const long long dq[4] = {HD, H, Sq, B}, dk[4] = {HD, Hk, Sk, B};
  // strides in: (batch, seq, head) for q, k, v, o; maps want (head, seq, batch)
  const long long sq[3] = {st[2], st[1], st[0]};
  const long long sk[3] = {st[5], st[4], st[3]};
  const long long sv[3] = {st[8], st[7], st[6]};
  const long long so[3] = {st[11], st[10], st[9]};
  int rc = hopper::make_map_bf16(&tq, q, 4, dq, sq, box);
  if (!rc) rc = hopper::make_map_bf16(&tk, k, 4, dk, sk, box);
  if (!rc) rc = hopper::make_map_bf16(&tv, v, 4, dk, sv, box);
  if (!rc) rc = hopper::make_map_bf16(&to, o, 4, dq, so, obox);
  if (rc) return rc;
  // persistent: one block an SM at most, each taking tiles off ``counter``
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_total = (Sq + BM - 1) / BM * B * H;
  flash_fwd_kernel<HD><<<min(n_total, n_sm), NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, to, kv_head, counter, lse, B * H, H, Sq, Sk, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int flash_info(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, flash_fwd_kernel<HD>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)FlashCfg<HD>::SMEM;
  return 0;
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn;
// q, k, v need a unit hd stride, 16-byte aligned bases and strides that
// are multiples of 8 elements.  ``lse`` (may be null): a contiguous f32
// (B, H, Sq) tensor that receives each row's log-sum-exp, which the
// backward (flash_attention_bwd.cu) recomputes the probabilities from.
// Returns cudaGetLastError() after the launch, or the error of the
// tensor-map encoding (0 on success).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, const void* kv_head, void* counter,
                              void* lse, int B, int H, int Hk, int Sq, int Sk,
                              int hd, const long long* strides, int causal,
                              float scale_log2, void* stream) {
  if (B < 1 || H < 1 || Hk < 1 || Sq < 1 || Sk < 1 ||
      (long long)B * H * ((Sq + BM - 1) / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kvh = static_cast<const int*>(kv_head);
  int* ctr = static_cast<int*>(counter);
  float* l = static_cast<float*>(lse);
  if (hd == 128)
    return launch_flash<128>(q, k, v, o, kvh, ctr, l, B, H, Hk, Sq, Sk,
                             strides, causal, scale_log2, s);
  if (hd == 64)
    return launch_flash<64>(q, k, v, o, kvh, ctr, l, B, H, Hk, Sq, Sk,
                            strides, causal, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// registers a thread, local (spill) bytes and dynamic shared memory a
// block of the kernel for head dim ``hd``
int repro_flash_attention_info(int hd, int* regs, int* local_bytes,
                               int* smem_bytes) {
  if (hd == 128) return flash_info<128>(regs, local_bytes, smem_bytes);
  if (hd == 64) return flash_info<64>(regs, local_bytes, smem_bytes);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
