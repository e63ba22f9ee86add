// Multi-tensor AdamW for Hopper (sm_90a): one launch updates every leaf
// whose moments m and v are f32, in place, with the arithmetic of the
// eager chain in src/repro_torch/optim/adamw.py (its plain version,
// kernels/adamw.py:adamw_chain), op for op:
//
//   gs = g * scale                       (scale: the clip factor, or none)
//   m' = b1 * m + (1 - b1) * gs
//   v' = b2 * v + ((1 - b2) * gs) * gs
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)
//   p' = round_to_p_dtype(p - lr * (u + wd * p))      (in f32)
//
// Replaces no TPU kernel: src/repro/optim/adamw.py:adamw_update has no
// Pallas call, and XLA fuses this chain inside the reference's jitted
// train step.  This kernel is the port's form of that fusion.
//
// Bits.  Every operation is one IEEE round-to-nearest f32 operation in
// the eager chain's order, written with the _rn intrinsics so that nvcc
// contracts nothing into an FMA; the python constants (b1, 1 - b1, ...)
// arrive as f32 of the double, as PyTorch casts a python scalar for an
// f32 tensor.  So the kernel gives the eager chain's bits on the card.
// lr, scale, c1 and c2 are 0-d device tensors the step computes (or, for
// lr, stages) before the launch: the kernel reads them through pointers,
// so a CUDA Graph that captured the launch reads each replay's values.
//
// What bounds it on the H100: bytes.  Per element a bf16 param is read
// and written, a bf16 grad read, f32 m and v read and written: 22 bytes
// against 17 FLOP.  The eager chain moves ~190 bytes an element over ~21
// launches per leaf.
//
// Design.  A leaf table (pointer to p, m, v, the element count, the
// leaf's first tile, dtype flags) is built once per set of storages by
// the wrapper and lives on the device; the grads, new tensors each step,
// are passed by value in the launch's parameters (a captured graph bakes
// them in, and a replay's grads are the capture's).  The leaves'
// elements are cut into tiles of 4096; a grid of resident blocks strides
// over the concatenated tiles, finding each tile's leaf by a binary
// search over the first tiles held in shared memory, so a leaf of 576
// elements costs one tile and no launch.  A thread handles 4 groups of 4
// elements of a tile, neighbouring threads on neighbouring 16 bytes of m
// and v (8 of a bf16 param); all 4 groups' loads go out before the
// arithmetic.  A leaf's last, partial tile and a leaf whose pointers are
// not 16-byte aligned take one element a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int GROUPS = 4;                       // groups of 4 a thread
constexpr int TILE = THREADS * GROUPS * 4;      // 4096 elements
constexpr int MAX_LEAVES = 448;                 // leaves one launch takes

// One leaf, as the wrapper writes it (six int64 words).
struct Leaf {
  long long p, m, v;        // device pointers
  long long n;              // elements
  long long tile0;          // its first tile among the launch's tiles
  long long flags;          // bit 0: p is f32 (else bf16); bit 1: g is f32
};

// The grads, by value: 3584 bytes of the 4 KB of launch parameters.
struct Grads {
  const void* g[MAX_LEAVES];
};

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

struct Scalars {
  float lr, scale, c1, c2;
  bool has_scale;
};

__device__ __forceinline__ float update(float pf, float g, float& m,
                                        float& v, const Consts& k,
                                        const Scalars& s) {
  const float gs = s.has_scale ? __fmul_rn(g, s.scale) : g;
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, gs));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, gs), gs));
  const float u = __fdiv_rn(__fdiv_rn(m, s.c1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), k.eps));
  return __fsub_rn(pf, __fmul_rn(s.lr, __fadd_rn(u, __fmul_rn(k.wd, pf))));
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float x, bf16* o) {
  *o = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }

// 4 consecutive elements, 16-byte (f32) or 8-byte (bf16) aligned
__device__ __forceinline__ void load4(const float* src, float* f) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* src, float* f) {
  const uint2 t = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void store4(float* dst, const float* f) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(bf16* dst, const float* f) {
  __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(dst) = t;
}

// Elements [e0, e1) of one leaf.
template <typename TP, typename TG>
__device__ __forceinline__ void tile(TP* p, const TG* g, float* m, float* v,
                                     long long e0, long long e1,
                                     const Consts& k, const Scalars& s) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) &
       15) == 0;
  if (aligned && e1 - e0 == TILE) {
    float pv[GROUPS][4], gv[GROUPS][4], mv[GROUPS][4], vv[GROUPS][4];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const long long i = e0 + 4LL * (j * THREADS + threadIdx.x);
      load4(p + i, pv[j]);
      load4(g + i, gv[j]);
      load4(m + i, mv[j]);
      load4(v + i, vv[j]);
    }
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pv[j][e] = update(pv[j][e], gv[j][e], mv[j][e], vv[j][e], k, s);
      const long long i = e0 + 4LL * (j * THREADS + threadIdx.x);
      store4(p + i, pv[j]);
      store4(m + i, mv[j]);
      store4(v + i, vv[j]);
    }
    return;
  }
  for (long long i = e0 + threadIdx.x; i < e1; i += THREADS) {
    float mi = m[i], vi = v[i];
    const float pn = update(to_f32(p[i]), to_f32(g[i]), mi, vi, k, s);
    from_f32(pn, p + i);
    m[i] = mi;
    v[i] = vi;
  }
}

__global__ void __launch_bounds__(THREADS)
adamw_kernel(const Leaf* __restrict__ leaves, const Grads grads, int nleaves,
             long long ntiles, const float* __restrict__ lr,
             const float* __restrict__ scale, const float* __restrict__ c1,
             const float* __restrict__ c2, const Consts k) {
  __shared__ long long first[MAX_LEAVES];
  for (int i = threadIdx.x; i < nleaves; i += THREADS)
    first[i] = leaves[i].tile0;
  Scalars s;
  s.lr = *lr;
  s.c1 = *c1;
  s.c2 = *c2;
  s.has_scale = scale != nullptr;
  s.scale = s.has_scale ? *scale : 1.f;
  __syncthreads();
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // the tile's leaf: the last whose first tile is <= t (an empty leaf
    // shares its first tile with the next one and loses to it)
    int lo = 0, hi = nleaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const Leaf L = leaves[lo];
    const long long e0 = (t - L.tile0) * TILE;
    const long long e1 = min(e0 + TILE, L.n);
    float* m = reinterpret_cast<float*>(L.m);
    float* v = reinterpret_cast<float*>(L.v);
    const void* g = grads.g[lo];
    switch (L.flags & 3) {
      case 0: tile(reinterpret_cast<bf16*>(L.p), static_cast<const bf16*>(g),
                   m, v, e0, e1, k, s); break;
      case 1: tile(reinterpret_cast<float*>(L.p), static_cast<const bf16*>(g),
                   m, v, e0, e1, k, s); break;
      case 2: tile(reinterpret_cast<bf16*>(L.p), static_cast<const float*>(g),
                   m, v, e0, e1, k, s); break;
      default: tile(reinterpret_cast<float*>(L.p),
                    static_cast<const float*>(g), m, v, e0, e1, k, s);
    }
  }
}

}  // namespace

extern "C" {

// The leaves one launch takes and the tile, for the wrapper.
int repro_adamw_limits(int* max_leaves, int* tile) {
  *max_leaves = MAX_LEAVES;
  *tile = TILE;
  return 0;
}

// Registers a thread, local (spill) bytes and the blocks an SM keeps
// resident.
int repro_adamw_info(int* regs, int* local_bytes, int* per_sm) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, adamw_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, adamw_kernel, THREADS, 0);
}

// table: nleaves Leaf entries on the device (tile0 ascending from 0, the
// last leaf's tiles ending at ntiles); grads: nleaves device pointers
// (host array), in the table's order; lr, c1, c2: f32 0-d device
// tensors; scale: one, or null for no clipping; consts: f32 b1, 1 - b1,
// b2, 1 - b2, eps, weight decay; grid: blocks.  Returns
// cudaGetLastError() (0 on success).
int repro_adamw(const void* table, const void* const* grads, int nleaves,
                long long ntiles, const float* lr, const float* scale,
                const float* c1, const float* c2, float b1, float omb1,
                float b2, float omb2, float eps, float wd, int grid,
                void* stream) {
  if (nleaves <= 0 || nleaves > MAX_LEAVES || ntiles <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  Grads g;
  for (int i = 0; i < nleaves; ++i) g.g[i] = grads[i];
  for (int i = nleaves; i < MAX_LEAVES; ++i) g.g[i] = nullptr;
  const Consts k{b1, omb1, b2, omb2, eps, wd};
  adamw_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), g, nleaves, ntiles, lr, scale, c1, c2,
      k);
  return (int)cudaGetLastError();
}

}  // extern "C"
