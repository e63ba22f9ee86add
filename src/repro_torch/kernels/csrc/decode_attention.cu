// Flash-decode for Hopper (sm_90a): one query token per (batch, head)
// against a KV cache, bf16 in and out, f32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention.  Same function: softmax(q k^T / sqrt(hd)) v over the
// first min(cache_len[b], S) positions of row b (per-row ragged lengths),
// query head h reading cache head kv_head[h] in place (GQA).
//
// What bounds it on the H100: bytes.  A GQA group of G query heads does
// 4*G*hd FLOP per cached key against 4*hd bytes of K and V, far below the
// card's ~295 FLOP a byte, so the kernel has to stream the valid part of
// the cache once, at memory speed, with enough bytes in flight.
//
// Design.  One block per (key chunk, batch row, kv head) serves every
// query head of that kv head's group, so K and V are read once, not G
// times.  Each of its 8 warps requests its 32 keys of the chunk's
// 256-key tile with one bulk copy (cp.async.bulk, the TMA engine) per K
// and V row, completing on the warp's mbarrier, before the block reads
// kv_head to learn its group (a warp ballot) and stages its query heads
// as the 16 rows of an mma.sync m16n8k16 A operand (rows past G are
// zero).  Rows sit 16 bytes apart in the banks, so ldmatrix reads no bank
// twice; a chunk of several tiles runs a 2-stage ring where two stages
// fit (hd 64).  S = Q K^T and O += P V run on the tensor cores in f32; P
// is split into a bf16 high and low part (two products), so the
// probabilities keep ~16 bits.  The warps' (max, sum, O) merge in shared
// memory in warp order.  (Blocks of 4 warps on 128-key tiles, two to an
// SM, were slower at chatglm3-6b's G=16 and no faster at G=1.)  A block
// past its row's length exits at once; a row of one chunk writes its
// output directly.  Otherwise each block writes a partial; the last block
// of each group of chunks (8 to 32, fewer for a larger GQA group), found
// through an atomic counter that it resets for the next call, merges that
// group's partials in chunk order, and the last of those mergers merges
// the groups in group order: one launch, one bulk copy a head for each
// merge, and the result does not depend on which block finished last.
// The chunk length is the caller's (a function of S alone), so a row's
// output is bitwise the same whatever the batch size and the other rows
// hold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 256;               // keys a block stages at once
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WKEYS = TILE / NWARPS;    // keys of a tile each warp owns
constexpr int MAX_H = 256;              // query heads
constexpr int MAX_CHUNKS = 32;          // chunks a row
constexpr int MIN_GROUP = 8;            // chunks a first-level merge takes
constexpr int MAX_GROUPS = MAX_CHUNKS / MIN_GROUP;
constexpr int MERGE_ROWS = 256;         // partial rows a merge step holds

using hopper::bulk_load;
using hopper::exp2_ftz;
using hopper::fence_proxy_async;
using hopper::ldsm_x4;
using hopper::ldsm_x4_t;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_wait;
using hopper::mma16816;
using hopper::pack_bf16x2;
using hopper::smem_u32;

// orders global writes that other blocks made visible (threadfence and
// an atomic) before this thread's bulk copies read them
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Whether two K/V stages and the Q tile fit a block's shared memory (a
// chunk of several tiles then loads tile t + 1 while tile t is computed;
// else each warp loads its next rows once it is done with these).
template <int HD>
__host__ __device__ constexpr bool ring_fits() {
  return (2 * 2 * TILE + 16) * (HD + 8) * 2 <= 227 * 1024;
}

struct Args {
  const bf16* q;
  const bf16* kc;
  const bf16* vc;
  const int* cache_len;
  const int* kv_head;
  bf16* o;
  float* part_o;       // [B*H][n_chunks][HD]
  float* part_ml;      // [B*H][n_chunks][2]
  float* grp_o;        // [B*H][MAX_GROUPS][HD]: merged groups of chunks
  float* grp_ml;       // [B*H][MAX_GROUPS][2]
  int* counters;       // [B*Hk][MAX_GROUPS + 1], zero between calls
  int H, Hk, S, chunk, n_chunks, group;
  long long sqb, sqh, skb, sks, skh, svb, svs, svh, sob, soh;
  float scale_log2;
};

// Shared memory a block keeps besides its K/V stages.
struct Shared {
  uint64_t bar[2][NWARPS];   // per stage and warp: that warp's K/V rows
  uint64_t merge_bar;        // the partials a merge reads
  int heads[MAX_H];
  int g, last;
  float m[NWARPS][16], l[NWARPS][16], w[NWARPS][16];
  float pm[MERGE_ROWS], mx[16], sum[16];   // a merge's weights, rows' max and sum
};

// After this block's partials are written: whether it is the last of
// ``n`` blocks to arrive at ``counter`` (which it then resets to zero
// for the next call).  Block-uniform.
__device__ __forceinline__ bool arrive_last(int* counter, int n, Shared& sh) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(counter, 1);
    sh.last = done == n - 1;
    if (sh.last) atomicExch(counter, 0);
  }
  __syncthreads();
  const bool last = sh.last;
  if (last) {
    __threadfence();
    fence_proxy_async_global();
  }
  return last;
}

// Merge M (<= 32) partials of each query head h of the group, in their
// order: partial j is (O, m, l) at slot (b*H + h)*n_src + j0 + j of
// src_o / src_ml.  ``final``: write O/l to the output in bf16; else write
// the merged (O, m, l) to slot (b*H + h)*MAX_GROUPS + jd of the group
// partials.  Heads go NTHREADS / W at a time (16 at most), W the power
// of two >= M: thread r*W + j loads partial j of head r's (m, l) and the
// segment of W lanes reduces max and sum with shuffles, while one lane of
// warp 0 a head brings that head's M contiguous rows of O into ``buf``
// (MERGE_ROWS*HD floats of shared memory) with one bulk copy.
template <int HD>
__device__ void merge_partials(const Args& a, int b, Shared& sh, int G,
                               const float* __restrict__ src_o,
                               const float* __restrict__ src_ml, int n_src,
                               int j0, int M, int jd, bool final, float* buf,
                               uint32_t& phase) {
  const int tid = threadIdx.x;
  const int W = M <= 8 ? 8 : (M <= 16 ? 16 : 32);
  const int per = min(16, NTHREADS / W);
  for (int hs = 0; hs < G; hs += per) {
    const int ht = min(per, G - hs);
    __syncthreads();                        // buf and sh.pm free again
    if (tid < 32) {
      if (tid == 0) mbar_arrive_expect_tx(&sh.merge_bar, ht * M * HD * 4);
      __syncwarp();
      if (tid < ht) {
        const long long slot = ((long long)b * a.H + sh.heads[hs + tid]) * n_src + j0;
        bulk_load(buf + tid * M * HD, src_o + slot * HD, M * HD * 4,
                  &sh.merge_bar);
      }
    }
    {
      const int r = tid / W, j = tid % W;
      const bool mine = r < ht && j < M;
      float m = -INFINITY, l = 0.f;
      if (mine) {
        const long long slot =
            ((long long)b * a.H + sh.heads[hs + r]) * n_src + j0 + j;
        const float2 ml = __ldcg(reinterpret_cast<const float2*>(src_ml) + slot);
        m = ml.x;
        l = ml.y;
      }
      float mx = m;
      for (int off = W / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float e = mine ? exp2_ftz(m - (mx == -INFINITY ? 0.f : mx)) : 0.f;
      float ls = l * e;
      for (int off = W / 2; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      if (mine) sh.pm[r * M + j] = e;       // the weight of partial j
      if (j == 0 && r < ht) {
        sh.mx[r] = mx;
        sh.sum[r] = ls;
      }
    }
    mbar_wait(&sh.merge_bar, phase);
    phase ^= 1;
    __syncthreads();
    for (int i = tid; i < ht * HD; i += NTHREADS) {
      const int r = i / HD, d = i % HD;
      const float* w = sh.pm + r * M;
      const float* src = buf + r * M * HD + d;
      float od = 0.f;
#pragma unroll 8
      for (int j = 0; j < M; ++j) od += w[j] * src[j * HD];
      const int h = sh.heads[hs + r];
      if (final) {
        const float l = sh.sum[r];
        a.o[b * a.sob + h * a.soh + d] = __float2bfloat16(l > 0.f ? od / l : 0.f);
      } else {
        const long long slot = ((long long)b * a.H + h) * MAX_GROUPS + jd;
        a.grp_o[slot * HD + d] = od;
        if (d == 0) {
          a.grp_ml[slot * 2] = sh.mx[r];
          a.grp_ml[slot * 2 + 1] = sh.sum[r];
        }
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
decode_kernel(const Args a) {
  constexpr int PE = HD + 8;            // row pitch in elements: rows 16
                                        // bytes apart in the banks
  constexpr int TE = TILE * PE;         // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  __shared__ Shared sh;

  const int c = blockIdx.x, pair = blockIdx.y;
  const int b = pair / a.Hk, kvh = pair % a.Hk;
  const int len = max(0, min(a.cache_len[b], a.S));
  const int n_act = (len + a.chunk - 1) / a.chunk;
  if (c >= max(n_act, 1)) return;          // past the row's end

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_stages = a.chunk > TILE && ring_fits<HD>() ? 2 : 1;
  bf16* s_q = stages + n_stages * 2 * TE;  // [16][PE]
  constexpr int OP = HD + 4;             // s_o's row pitch: no bank conflicts
  float* s_o = reinterpret_cast<float*>(smem);  // [NWARPS][16][OP], reuses
                                                // stage 0 after the loop
  const int k0 = c * a.chunk;
  const int k_end = min(len, k0 + a.chunk);
  const int n_tiles = (k_end - k0 + TILE - 1) / TILE;   // >= 1 if n_act > 0
  const bf16* kbase = a.kc + b * a.skb + kvh * a.skh;
  const bf16* vbase = a.vc + b * a.svb + kvh * a.svh;

  if (tid == 0) {
    for (int st = 0; st < 2; ++st)
      for (int w = 0; w < NWARPS; ++w) hopper::mbar_init(&sh.bar[st][w], 1);
    hopper::mbar_init(&sh.merge_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // This warp's 32 rows of tile t, one bulk copy a key for K and one for
  // V, into stage u % n_stages (u counts the warp's loads); a key past the
  // row's end gets a zero V row instead (its score is masked).
  auto load_tile = [&](int t, int u) {
    const int st = u % n_stages, r = warp * WKEYS + lane;
    bf16* ks = stages + st * 2 * TE;
    bf16* vs = ks + TE;
    const int key = k0 + t * TILE + r;
    const int n_valid = min(WKEYS, max(0, k_end - (k0 + t * TILE + warp * WKEYS)));
    fence_proxy_async();                    // this row's generic writes
    if (lane == 0) mbar_arrive_expect_tx(&sh.bar[st][warp], n_valid * 4 * HD);
    __syncwarp();
    if (lane < n_valid) {
      bulk_load(ks + r * PE, kbase + (long long)key * a.sks, 2 * HD,
                &sh.bar[st][warp]);
      bulk_load(vs + r * PE, vbase + (long long)key * a.svs, 2 * HD,
                &sh.bar[st][warp]);
    } else {
#pragma unroll
      for (int ch = 0; ch < HD / 8; ++ch)
        *reinterpret_cast<uint4*>(vs + r * PE + ch * 8) = make_uint4(0, 0, 0, 0);
    }
  };

  int u = 0;                               // this warp's loads so far
  if (n_act > 0) load_tile(0, u);          // before the group is known
  if (warp == 0) {                         // the group, in head order
    int cnt = 0;
    for (int base = 0; base < a.H; base += 32) {
      const int h = base + lane;
      const bool mine = h < a.H && a.kv_head[h] == kvh;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) sh.heads[cnt + __popc(m & ((1u << lane) - 1u))] = h;
      cnt += __popc(m);
    }
    if (lane == 0) sh.g = cnt;
  }
  __syncthreads();
  const int G = sh.g;
  if (G == 0 || n_act == 0) {
    if (n_act > 0) mbar_wait(&sh.bar[0][warp], 0);   // drain the copies
    for (int i = tid; n_act == 0 && i < G * HD; i += NTHREADS)   // no keys
      a.o[b * a.sob + sh.heads[i / HD] * a.soh + i % HD] = __float2bfloat16(0.f);
    return;
  }

  for (int hs = 0; hs < G; hs += 16) {
    const int gt = min(16, G - hs);
    if (hs > 0) load_tile(0, u);           // in flight while Q is staged
    for (int i = tid; i < 16 * (HD / 8); i += NTHREADS) {
      const int r = i / (HD / 8), ch = i % (HD / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < gt)
        v = *reinterpret_cast<const uint4*>(
            a.q + b * a.sqb + sh.heads[hs + r] * a.sqh + ch * 8);
      *reinterpret_cast<uint4*>(s_q + r * PE + ch * 8) = v;
    }
    __syncthreads();
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int m = lane >> 3;
      const int r = (lane & 7) + (m & 1) * 8, ch = ks * 2 + (m >> 1);
      ldsm_x4(smem_u32(s_q + r * PE + ch * 8), qf[ks]);
    }

    float acc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    for (int t = 0; t < n_tiles; ++t, ++u) {
      if (n_stages == 2 && t + 1 < n_tiles) load_tile(t + 1, u + 1);
      mbar_wait(&sh.bar[u % n_stages][warp], (u / n_stages) & 1);
      const bf16* ks = stages + (u % n_stages) * 2 * TE;
      const bf16* vs = ks + TE;

      // S = Q K^T over this warp's 32 keys: 4 tiles of 8 keys
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) {
          const int r = warp * WKEYS + j * 8 + (lane & 7);
          uint32_t bk[4];
          ldsm_x4(smem_u32(ks + r * PE + (kk * 4 + (lane >> 3)) * 8), bk);
          mma16816(s[j], qf[2 * kk], bk[0], bk[1]);
          mma16816(s[j], qf[2 * kk + 1], bk[2], bk[3]);
        }
      }
      // mask, scale, online softmax (rows lane/4 and lane/4 + 8)
      const int key0 = k0 + t * TILE + warp * WKEYS + (lane & 3) * 2;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key0 + j * 8 + (e & 1) < k_end;
          s[j][e] = ok ? s[j][e] * a.scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_ftz(m_run[r] - mu[r]);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_ftz(s[j][e] - mu[e >> 1]);
          l_run[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // O += P V, P = hi + lo in bf16: 2 steps of 16 keys
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        uint32_t ph[4], pl[4];
        const float* p0 = s[2 * kt];
        const float* p1 = s[2 * kt + 1];
        const float pv[8] = {p0[0], p0[1], p0[2], p0[3],
                             p1[0], p1[1], p1[2], p1[3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float h0 = __bfloat162float(__float2bfloat16(pv[2 * i]));
          const float h1 = __bfloat162float(__float2bfloat16(pv[2 * i + 1]));
          ph[i] = pack_bf16x2(h0, h1);
          pl[i] = pack_bf16x2(pv[2 * i] - h0, pv[2 * i + 1] - h1);
        }
        const int m = lane >> 3;
        const int r = warp * WKEYS + kt * 16 + (lane & 7) + (m & 1) * 8;
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bv[4];
          ldsm_x4_t(smem_u32(vs + r * PE + (np * 2 + (m >> 1)) * 8), bv);
          mma16816(acc[2 * np], ph, bv[0], bv[1]);
          mma16816(acc[2 * np], pl, bv[0], bv[1]);
          mma16816(acc[2 * np + 1], ph, bv[2], bv[3]);
          mma16816(acc[2 * np + 1], pl, bv[2], bv[3]);
        }
      }
      __syncwarp();                         // this warp's rows are free
      if (n_stages == 1 && t + 1 < n_tiles) load_tile(t + 1, u + 1);
    }

    // merge the warps' (m, l, O) in warp order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    __syncthreads();                        // every warp is done with stage 0
    if ((lane & 3) == 0) {
      sh.m[warp][lane >> 2] = m_run[0];
      sh.m[warp][(lane >> 2) + 8] = m_run[1];
      sh.l[warp][lane >> 2] = l_run[0];
      sh.l[warp][(lane >> 2) + 8] = l_run[1];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      float* row0 = s_o + (warp * 16 + (lane >> 2)) * OP;
      *reinterpret_cast<float2*>(row0 + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(row0 + 8 * OP + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
    fence_proxy_async();                    // s_o before later bulk copies
    __syncthreads();
    if (tid < 16 * NWARPS) {                // each row's weight of each warp
      const int r = tid / NWARPS, w = tid % NWARPS;
      const float m = sh.m[w][r];
      float mx = m;
#pragma unroll
      for (int off = NWARPS / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float e = exp2_ftz(m - (mx == -INFINITY ? 0.f : mx));
      float ls = sh.l[w][r] * e;
#pragma unroll
      for (int off = NWARPS / 2; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      sh.w[w][r] = e;
      if (w == 0) {
        sh.mx[r] = mx;
        sh.sum[r] = ls;
      }
    }
    __syncthreads();
    constexpr int ITEMS = 16 * HD / NTHREADS;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = (tid + k * NTHREADS) / HD, d = (tid + k * NTHREADS) % HD;
      if (r >= gt) continue;
      float od = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) od += sh.w[w][r] * s_o[(w * 16 + r) * OP + d];
      const int h = sh.heads[hs + r];
      if (n_act == 1) {
        const float l = sh.sum[r];
        a.o[b * a.sob + h * a.soh + d] = __float2bfloat16(l > 0.f ? od / l : 0.f);
      } else {
        const long long slot = ((long long)b * a.H + h) * a.n_chunks + c;
        a.part_o[slot * HD + d] = od;
        if (d == 0) {
          a.part_ml[slot * 2] = sh.mx[r];
          a.part_ml[slot * 2 + 1] = sh.sum[r];
        }
      }
    }
    __syncthreads();                        // s_q and stage 0 free again
  }
  if (n_act == 1) return;

  // Two-level merge: the last block of each group of ``group`` chunks
  // merges that group's partials, the last group merger the groups'
  // (``group`` from the caller: small for a large GQA group, so no one
  // block reads more than ~128 partial rows).
  const int n_grp = (n_act + a.group - 1) / a.group, grp = c / a.group;
  const int members = min(a.group, n_act - grp * a.group);
  int* cnt = a.counters + (long long)pair * (MAX_GROUPS + 1);
  uint32_t phase = 0;
  float* buf = reinterpret_cast<float*>(smem);
  if (!arrive_last(cnt + grp, members, sh)) return;
  merge_partials<HD>(a, b, sh, G, a.part_o, a.part_ml, a.n_chunks,
                     grp * a.group, members, grp, n_grp == 1, buf, phase);
  if (n_grp == 1) return;
  if (!arrive_last(cnt + MAX_GROUPS, n_grp, sh)) return;
  merge_partials<HD>(a, b, sh, G, a.grp_o, a.grp_ml, MAX_GROUPS, 0, n_grp, 0,
                     true, buf, phase);
}

template <int HD>
int launch_decode(const Args& a, int B, cudaStream_t stream) {
  const int n_stages = a.chunk > TILE && ring_fits<HD>() ? 2 : 1;
  // K and V stages and the Q tile, rows padded by 16 bytes
  const int smem = (n_stages * 2 * TILE + 16) * (HD + 8) * (int)sizeof(bf16);
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  decode_kernel<HD><<<dim3(a.n_chunks, B * a.Hk), NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,1,H,hd), caches (B,S,Hk,hd) bf16 with unit hd stride and 16-byte
// aligned rows; strides: q (batch, head), k (batch, seq, head), v (batch,
// seq, head), o (batch, head), in elements.  ``work`` holds
// B*H*(n_chunks + 4)*(hd + 2) floats and then B*Hk*5 int counters that
// are zero before the first call (the kernel leaves them zero).
// ``chunk`` is a multiple of 128 keys and n_chunks = ceil(S / chunk) <=
// 32; a first-level merge takes ``group`` (8 to 32) chunks.  Returns
// cudaGetLastError() (0 on success).
int repro_decode_attention_fwd(const void* q, const void* kc, const void* vc,
                               const void* cache_len, const void* kv_head,
                               void* o, void* work, int B, int H, int Hk,
                               int S, int hd, int chunk, int n_chunks,
                               int group, const long long* st,
                               float scale_log2, void* stream) {
  if (chunk <= 0 || chunk % TILE || n_chunks != (S + chunk - 1) / chunk ||
      n_chunks > MAX_CHUNKS || H > MAX_H || B <= 0 || Hk <= 0 ||
      group < MIN_GROUP || group > MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  const long long bh = (long long)B * H;
  float* part_o = static_cast<float*>(work);
  float* part_ml = part_o + bh * n_chunks * hd;
  float* grp_o = part_ml + bh * n_chunks * 2;
  float* grp_ml = grp_o + bh * MAX_GROUPS * hd;
  int* counters = reinterpret_cast<int*>(grp_ml + bh * MAX_GROUPS * 2);
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(kc),
         static_cast<const bf16*>(vc), static_cast<const int*>(cache_len),
         static_cast<const int*>(kv_head), static_cast<bf16*>(o), part_o,
         part_ml, grp_o, grp_ml, counters, H, Hk, S, chunk, n_chunks, group,
         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
         scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_decode<128>(a, B, s);
  if (hd == 64) return launch_decode<64>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
