// Flash-decode for Hopper (sm_90a): one query token per (batch, head)
// against a KV cache, bf16 in and out, f32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention.  Same function: softmax(q k^T / sqrt(hd)) v over the
// first cache_len[b] positions of row b (per-row ragged lengths), with the
// online softmax over 512-wide KV blocks in f32.
//
// What bounds it on the H100: bytes.  Each query does 4*hd FLOP per
// cached key against 4*hd bytes of K and V, so the kernel has to stream
// the valid part of the cache once at memory speed.  GQA: kv_head[h]
// names the cache head query head h reads, so the cache is read in place
// (no per-q-head copy gathered first, which for chatglm3-6b's 32 q / 2 kv
// heads would move 16x the bytes).  Query heads of one group read the
// same K/V rows close together in time, so the repeats hit L2.
//
// Design: split-K.  Pass 1 runs one block per (512-key block, batch*head);
// half-warps (hd=128) or quarter-warps (hd=64) each own one key per step,
// 16 bytes per lane, reduce q.k with shuffles and keep a running (max,
// sum, acc) per group; the block merges its groups and writes one partial
// (max, sum, unnormalized output).  Blocks past a row's cache_len exit
// after writing an empty partial, so the work follows the data.  Pass 2
// merges the partials of each (batch, head) and normalizes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int SPLIT = 512;          // keys per pass-1 block
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                      const bf16* __restrict__ vc,
                      const int* __restrict__ cache_len,
                      const int* __restrict__ kv_head,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int H, int S, long long sqb, long long sqh, long long skb,
                      long long sks, long long skh, long long svb,
                      long long svs, long long svh, float scale_log2) {
  constexpr int LPK = HD / 8;           // lanes per key (8 bf16 each)
  constexpr int KPW = 32 / LPK;         // keys per warp per step
  constexpr int NG = NWARPS * KPW;      // key groups per block
  __shared__ float s_m[NG], s_l[NG];
  __shared__ float s_acc[NG][HD];

  const int split = blockIdx.x, n_split = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kvh = kv_head[h];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPK, dl = (lane % LPK) * 8;
  const int grp = warp * KPW + sub;
  const int len = min(cache_len[b], S);     // never read past the cache
  const int k_begin = split * SPLIT;
  const int k_end = min(len, k_begin + SPLIT);

  float qv[8];
  unpack8(*reinterpret_cast<const uint4*>(q + b * sqb + h * sqh + dl), qv);
#pragma unroll
  for (int i = 0; i < 8; ++i) qv[i] *= scale_log2;

  const bf16* kb = kc + b * skb + kvh * skh + dl;
  const bf16* vb = vc + b * svb + kvh * svh + dl;
  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  // warp-uniform trip count: every lane takes part in every shuffle
  for (int base = k_begin + warp * KPW; base < k_end; base += NWARPS * KPW) {
    const int kpos = base + sub;
    const bool valid = kpos < k_end;
    float kf[8], vf[8];
    if (valid) {
      unpack8(*reinterpret_cast<const uint4*>(kb + (long long)kpos * sks), kf);
      unpack8(*reinterpret_cast<const uint4*>(vb + (long long)kpos * svs), vf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += qv[i] * kf[i];
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    s = valid ? s : -INFINITY;
    const float m_new = fmaxf(m, s);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = exp2f(m - m_use);
    const float p = exp2f(s - m_use);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = acc[i] * alpha + p * vf[i];
    m = m_new;
  }

  if (lane % LPK == 0) {
    s_m[grp] = m;
    s_l[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s_acc[grp][dl + i] = acc[i];
  __syncthreads();

  float mx = -INFINITY;
#pragma unroll
  for (int g = 0; g < NG; ++g) mx = fmaxf(mx, s_m[g]);
  const float m_use = (mx == -INFINITY) ? 0.f : mx;
  const long long slot = (long long)bh * n_split + split;
  for (int d = tid; d < HD; d += NTHREADS) {
    float od = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) od += s_acc[g][d] * exp2f(s_m[g] - m_use);
    part_o[slot * HD + d] = od;
  }
  if (tid == 0) {
    float ls = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) ls += s_l[g] * exp2f(s_m[g] - m_use);
    part_ml[slot * 2] = mx;
    part_ml[slot * 2 + 1] = ls;
  }
}

template <int HD>
__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_ml,
                                      bf16* __restrict__ o, int H,
                                      int n_split, long long sob,
                                      long long soh) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const int b = bh / H, h = bh % H;
  const float* ml = part_ml + (long long)bh * n_split * 2;
  float mx = -INFINITY;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, ml[2 * i]);
  const float m_use = (mx == -INFINITY) ? 0.f : mx;
  float l = 0.f, od = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float w = exp2f(ml[2 * i] - m_use);
    l += ml[2 * i + 1] * w;
    od += part_o[((long long)bh * n_split + i) * HD + d] * w;
  }
  o[b * sob + h * soh + d] = __float2bfloat16(l > 0.f ? od / l : 0.f);
}

template <int HD>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const int* cache_len, const int* kv_head, void* o,
                  float* part_o, float* part_ml, int B, int H, int S,
                  const long long* st, float scale_log2,
                  cudaStream_t stream) {
  const int n_split = (S + SPLIT - 1) / SPLIT;
  dim3 grid1(n_split, B * H);
  decode_partial_kernel<HD><<<grid1, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(vc), cache_len, kv_head, part_o, part_ml, H, S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<HD><<<B * H, HD, 0, stream>>>(
      part_o, part_ml, static_cast<bf16*>(o), H, n_split, st[8], st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: q (batch, head), k (batch, seq, head), v (batch, seq, head),
// o (batch, head), in elements.  part_o holds B*H*ceil(S/512)*hd floats,
// part_ml B*H*ceil(S/512)*2.  Returns cudaGetLastError() (0 on success).
int repro_decode_attention_fwd(const void* q, const void* kc, const void* vc,
                               const void* cache_len, const void* kv_head,
                               void* o, void* part_o, void* part_ml, int B,
                               int H, int S, int hd, const long long* strides,
                               float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cl = static_cast<const int*>(cache_len);
  const int* kvh = static_cast<const int*>(kv_head);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (hd == 128)
    return launch_decode<128>(q, kc, vc, cl, kvh, o, po, pml, B, H, S,
                              strides, scale_log2, s);
  if (hd == 64)
    return launch_decode<64>(q, kc, vc, cl, kvh, o, po, pml, B, H, S,
                             strides, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

int repro_decode_split_keys(void) { return SPLIT; }

}  // extern "C"
