// The gate's backward of the grouped SwiGLU expert FFN for Hopper
// (sm_90a).  With h1 = x w1, h3 = x w3 (E, N, F) recomputed by the
// backward's products and dh = dy w2^T:
//
//   s   = sigmoid(h1)
//   dh1 = dh * h3 * (s * (1 + h1 * (1 - s)))       (silu'(h1))
//   dh3 = dh * (h1 * s)                            (silu(h1))
//   h   = (h1 * s) * h3                            (for dw2 = h^T dy)
//
// each in f32 from the bf16 inputs, each output rounded once to bf16 —
// the arithmetic of grouped_matmul.py:grouped_ffn_gate_bwd_plain.
//
// Replaces no TPU kernel: the JAX package differentiates its expert FFN
// as plain XLA einsums (src/repro/models/moe.py:202-213, ExpertGEMMOp's
// kernel with impl="xla"), whose elementwise gate (:211) XLA fuses into
// one pass.  This kernel is the port's form of that fusion; the
// backward's seven grouped products stay with cuBLAS (torch.bmm), as the
// reference left its products to XLA.
//
// What bounds it on the H100: bytes.  Three bf16 values read and three
// written an element (12 bytes) against ~13 f32 operations, one exp
// among them.
//
// Design.  One pass over the E*N*F elements as if flat (the wrapper
// hands contiguous tensors): each thread takes 8 elements, one 16-byte
// load of each input issued before any arithmetic and one 16-byte store
// of each output; no shared memory.  A tail of fewer than 8 elements
// goes element by element.  One launch per call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;       // bf16 values in 16 bytes

__device__ __forceinline__ void gate(float a, float b, float g, float& d1,
                                     float& d3, float& h) {
  const float s = 1.0f / (1.0f + expf(-a));
  const float silu = a * s;
  d1 = g * b * (s * (1.0f + a * (1.0f - s)));
  d3 = g * silu;
  h = silu * b;
}

__global__ void __launch_bounds__(THREADS)
gate_bwd_kernel(const __nv_bfloat16* __restrict__ h1,
                const __nv_bfloat16* __restrict__ h3,
                const __nv_bfloat16* __restrict__ dh,
                __nv_bfloat16* __restrict__ dh1,
                __nv_bfloat16* __restrict__ dh3,
                __nv_bfloat16* __restrict__ h, long long n) {
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long i0 = v * VEC;
  if (i0 + VEC <= n) {
    const uint4 ra = __ldg(reinterpret_cast<const uint4*>(h1 + i0));
    const uint4 rb = __ldg(reinterpret_cast<const uint4*>(h3 + i0));
    const uint4 rg = __ldg(reinterpret_cast<const uint4*>(dh + i0));
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&ra);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&rb);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&rg);
    uint4 o1, o3, oh;
    __nv_bfloat162* p1 = reinterpret_cast<__nv_bfloat162*>(&o1);
    __nv_bfloat162* p3 = reinterpret_cast<__nv_bfloat162*>(&o3);
    __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&oh);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const float2 a = __bfloat1622float2(a2[j]);
      const float2 b = __bfloat1622float2(b2[j]);
      const float2 g = __bfloat1622float2(g2[j]);
      float2 d1, d3, hh;
      gate(a.x, b.x, g.x, d1.x, d3.x, hh.x);
      gate(a.y, b.y, g.y, d1.y, d3.y, hh.y);
      p1[j] = __float22bfloat162_rn(d1);
      p3[j] = __float22bfloat162_rn(d3);
      ph[j] = __float22bfloat162_rn(hh);
    }
    *reinterpret_cast<uint4*>(dh1 + i0) = o1;
    *reinterpret_cast<uint4*>(dh3 + i0) = o3;
    *reinterpret_cast<uint4*>(h + i0) = oh;
  } else if (i0 < n) {
    for (long long i = i0; i < n; ++i) {
      float d1, d3, hh;
      gate(__bfloat162float(h1[i]), __bfloat162float(h3[i]),
           __bfloat162float(dh[i]), d1, d3, hh);
      dh1[i] = __float2bfloat16_rn(d1);
      dh3[i] = __float2bfloat16_rn(d3);
      h[i] = __float2bfloat16_rn(hh);
    }
  }
}

}  // namespace

extern "C" {

// Registers a thread, local (spill) bytes and the blocks an SM keeps
// resident.
int repro_grouped_ffn_gate_bwd_info(int* regs, int* local_bytes,
                                    int* per_sm) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, gate_bwd_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gate_bwd_kernel, THREADS, 0);
}

// h1, h3, dh: n contiguous bf16 values each, 16-byte aligned; dh1, dh3,
// h: n bf16 values each, written.  Returns cudaGetLastError() (0 on
// success).
int repro_grouped_ffn_gate_bwd(const void* h1, const void* h3,
                               const void* dh, void* dh1, void* dh3, void* h,
                               long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long vecs = (n + VEC - 1) / VEC;
  const long long blocks = (vecs + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gate_bwd_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h1),
      static_cast<const __nv_bfloat16*>(h3),
      static_cast<const __nv_bfloat16*>(dh),
      static_cast<__nv_bfloat16*>(dh1), static_cast<__nv_bfloat16*>(dh3),
      static_cast<__nv_bfloat16*>(h), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
