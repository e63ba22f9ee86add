// Flash attention forward for Hopper (sm_90a), bf16 in and out, f32 softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (Pallas body _flash_kernel).  Same function: blockwise online-softmax
// attention, scale 1/sqrt(hd), causal mask kpos <= qpos aligned top-left
// even when Sq != Sk, f32 accumulation, output in q's dtype.
//
// What bounds it on the H100: operations.  At the prefill shape of the
// main path (B=2, S=2048, H=32, hd=128, causal) one call does ~69 GFLOP on
// ~67 MB of q/k/v/o, ~1000 FLOP per byte, far above the card's ~295
// FLOP/byte ridge.  The design therefore keeps the S x S scores out of
// device memory entirely (flash tiling) and runs both products on the
// tensor cores (WMMA 16x16x16 bf16 -> f32).
//
// Design.  One block per (q tile of 64 rows, batch*head); 4 warps, each
// owning 16 query rows.  The TPU grid carried the K loop in order; here
// the loop over 64-key tiles runs inside the block and stops at the causal
// edge of the q tile.  K/V tiles are staged in shared memory; the score
// tile and the f32 output accumulator live in shared memory too, so the
// online-softmax rescale is plain per-row arithmetic (WMMA fragment
// layouts are opaque).  GQA: kv_head[h] names the K/V head query head h
// reads, so K/V are read in place instead of being expanded per q head.
// This is the simple first version: no TMA, no wgmma, no pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int NWARPS = 4;     // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;

template <int HD>
struct FlashSmem {
  static constexpr int LDQ = HD + 8;   // bf16 rows of Q/K/V (pad: banks)
  static constexpr int LDS = BN + 4;   // f32 score rows
  static constexpr int LDP = BN + 8;   // bf16 probability rows
  static constexpr int LDO = HD + 4;   // f32 output-accumulator rows
  static constexpr size_t bytes =
      3 * BM * LDQ * sizeof(bf16) + BM * LDS * sizeof(float) +
      BM * LDP * sizeof(bf16) + BM * LDO * sizeof(float) +
      2 * BM * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ kv_head, int H, int Sq, int Sk,
                 long long sqb, long long sqs, long long sqh,
                 long long skb, long long sks, long long skh,
                 long long svb, long long svs, long long svh,
                 long long sob, long long sos, long long soh,
                 int causal, float scale_log2) {
  using L = FlashSmem<HD>;
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
  constexpr int VEC = 8;                 // bf16 per 16-byte access
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * LDQ;
  bf16* sV = sK + BN * LDQ;
  float* sS = reinterpret_cast<float*>(sV + BN * LDQ);
  bf16* sP = reinterpret_cast<bf16*>(sS + BM * LDS);
  float* sO = reinterpret_cast<float*>(sP + BM * LDP);
  float* sM = sO + BM * LDO;
  float* sL = sM + BM;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = kv_head[h];
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + kvh * skh;
  const bf16* vb = v + b * svb + kvh * svh;

  for (int idx = tid; idx < BM * HD / VEC; idx += NTHREADS) {
    const int r = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(m0 + r) * sqs + c);
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) = val;
  }
  for (int idx = tid; idx < BM * LDO; idx += NTHREADS) sO[idx] = 0.f;
  for (int idx = tid; idx < BM; idx += NTHREADS) {
    sM[idx] = -INFINITY;
    sL[idx] = 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * LDQ + kk * 16, LDQ);

  // keys past the q tile's last row are all masked under causal
  const int n_end = causal ? min(Sk, m0 + BM) : Sk;
  const int row = warp * 16 + lane / 2;   // two lanes per query row
  const int half = lane % 2;
  const int qpos = m0 + row;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int idx = tid; idx < BN * HD / VEC; idx += NTHREADS) {
      const int r = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (n0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(n0 + r) * sks + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(n0 + r) * svs + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LDQ + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * LDQ + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + (j * 16) * LDQ + kk * 16, LDQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sS + warp * 16 * LDS + j * 16, sf, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, in the log2 domain
    {
      float* srow = sS + row * LDS;
      float mx = -INFINITY;
      for (int c = half * (BN / 2); c < (half + 1) * (BN / 2); ++c) {
        const int kpos = n0 + c;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos);
        const float s = ok ? srow[c] * scale_log2 : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
      for (int c = half * (BN / 2); c < (half + 1) * (BN / 2); ++c) {
        const float p = exp2f(srow[c] - m_use);
        sP[row * LDP + c] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = exp2f(m_old - m_use);
      float* orow = sO + row * LDO;
      for (int c = half; c < HD; c += 2) orow[c] *= alpha;
      __syncwarp();     // both lanes of the row have read sM/sL
      if (half == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + sum;
      }
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, sO + warp * 16 * LDO + j * 16, LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sP + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(vf, sV + (kk * 16) * LDQ + j * 16, LDQ);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(sO + warp * 16 * LDO + j * 16, of, LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  bf16* ob = o + b * sob + h * soh;
  for (int idx = tid; idx < BM * HD / VEC; idx += NTHREADS) {
    const int r = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
    if (m0 + r >= Sq) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __align__(16) bf16 out[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = __float2bfloat16(sO[r * LDO + c + e] * inv);
    *reinterpret_cast<uint4*>(ob + (long long)(m0 + r) * sos + c) =
        *reinterpret_cast<const uint4*>(out);
  }
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const int* kv_head, int B, int H, int Sq, int Sk,
                 const long long* st, int causal, float scale_log2,
                 cudaStream_t stream) {
  static bool attr_set = false;
  const size_t smem = FlashSmem<HD>::bytes;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_kernel<HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), kv_head, H, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, const void* kv_head, int B, int H,
                              int Sq, int Sk, int hd,
                              const long long* strides, int causal,
                              float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kvh = static_cast<const int*>(kv_head);
  if (hd == 128)
    return launch_flash<128>(q, k, v, o, kvh, B, H, Sq, Sk, strides, causal,
                             scale_log2, s);
  if (hd == 64)
    return launch_flash<64>(q, k, v, o, kvh, B, H, Sq, Sk, strides, causal,
                            scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
