// Fused residual add + RMSNorm for Hopper (sm_90a) over the rows of x, y
// (n, d):
//   s = x + y in f32,
//   h = (s * rsqrt(mean(s^2) + eps)).to(x.dtype) * g,
// returning s.to(x.dtype) and h rounded to promote_types(x.dtype,
// g.dtype); the statistics come from the unrounded f32 s.  x and y share
// one type, bf16, f16 or f32; g is any of the three.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:fused_add_rmsnorm.
//
// What bounds it on the H100: bytes, at a full grid.  A handful of FLOP
// an element against two reads and two writes.  At TokenWeave's 16-32
// blocks (below) the consumers' instructions on those few SMs weigh
// more: a copy with neither its loads nor its stores still takes about
// two thirds of the kernel's time (PERF.md, tools/kernel_probes.py
// --probes fused).
//
// The knob.  A block owns ``block_rows`` consecutive rows, so the launch
// has ceil(n / block_rows) blocks: TokenWeave's CTA count
// (core/strategies/tokenweave.py), 16 at 4096 rows and 32 at 8192 with
// its 256.  A row's arithmetic does not depend on the block that runs it,
// so the outputs are the same bits for every block_rows.
//
// Design.  At 16-32 blocks each SM must move ~100 GB/s or more to come
// near the bytes bound; with ~1 us of latency to device memory that is
// tens of KB in flight an SM, more than registers hold.  So each block
// streams its rows through a ring of stages in shared memory (a stage is
// one row of x and of y): one producer thread requests the rows ahead
// with 1D bulk copies (cp.async.bulk) on a "full" mbarrier a stage, as
// many stages as fit in whole groups (rmsnorm.py: fused_geometry; 10 at d
// = 4096 bf16).  The consumer warps (``cwarps``: 20 where x and g share a
// 16-bit type) take landed stages in groups of ``wpr`` warps a row (1
// below d = 2048, else 4, as RMSNorm holds a row: norm_geometry), the
// groups on rows in turn: more rows at once was what sped the consumers
// up most (4, 8, 16, 20 warps: 0.30, 0.17, 0.11, 0.10 ms at 4096 x 4096).
// A lane holds its packs of s = x + y in registers, so shared memory is
// read once; the sum of squares reduces with shuffles and across the
// group's warps in shared memory (double-buffered, one named barrier a
// row), and the lane frees the stage as soon as its packs are read.  g is
// read once a block into registers; where x and g share a 16-bit type it
// stays packed and h is one paired multiply of the rounded (s * r) pair
// by g (exact: the product of two such values fits f32, so rounding it
// once gives PyTorch's bits), which saves registers and instructions.
// The outputs go out as 16-byte global stores from registers.  Staging
// them over the stage for bulk stores was measured too: slower at 16 and
// 32 blocks with 20 consumer warps (the stage is held until the copy has
// read it, behind a proxy fence), so it went.  One launch per call, and
// one ctypes call.
//
// Instantiations: 3 types of x and y x 3 of g x the 5 pack counts of
// norm_geometry = 45 (the same as rmsnorm.cu, built in parallel with it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "norm_pack.cuh"

namespace {

using namespace normpack;
using hopper::bulk_load;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_bar_sync;

constexpr int MAX_SMEM = 232448;               // 227 KB a block

// the most consumer warps a block may have (one producer warp besides;
// the kernel's launch bounds, which cap a lane's registers at what an SM
// partition holds for that many warps): 20 at up to 4 packs a lane where
// x and g share a 16-bit type (g held packed: 80 registers, no spills),
// 16 at up to 4 packs otherwise, 8 at 8 packs.  This cap and smem_bytes
// below are what rmsnorm.py:fused_geometry follows;
// repro_fused_add_rmsnorm_info reports them, and
// tests/test_torch_kernels_cuda.py holds the two equal.
template <typename TX, typename TG, int NP>
constexpr int max_cwarps() {
  return NP > 4 ? 8 : (sizeof(TX) == 2 && sizeof(TG) == 2 &&
                       Out<TX, TG>::paired) ? 20 : 16;
}

// dynamic shared memory of a block: the ring, a full and an empty
// mbarrier a stage, and the consumer warps' partial sums (two buffers)
inline size_t smem_bytes(int stages, int row_bytes, int cwarps) {
  return (size_t)stages * 2 * row_bytes + (size_t)stages * 16 +
         2 * cwarps * sizeof(float);
}

// g's 8 elements of a lane, and h = (s * r).to(TX) * g of them written to
// ``dst`` in h's type: in general g is held in f32 and the product taken
// in f32 and rounded once
template <typename TX, typename TG>
struct Scale {
  float g[8];
  __device__ __forceinline__ void init(const TG* src) {
    Pack<TG> p;
    load(p, src);
    to_f32(p, g);
  }
  __device__ __forceinline__ void apply(const float* s, float r,
                                        typename Out<TX, TG>::type* dst) const {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      o[e] = s[e] * r;
      o[e + 1] = s[e + 1] * r;
      round2_to<TX>(o[e], o[e + 1]);
      o[e] *= g[e];
      o[e + 1] *= g[e + 1];
    }
    store(dst, o);
  }
};

// x and g of one 16-bit type T: the product of two T values is exact in
// f32, so one paired T multiply (rounded once, as PyTorch rounds the f32
// product) gives the same bits with g held as it lies
template <typename T, typename T2>
struct Scale16 {
  T2 g[4];
  __device__ __forceinline__ void init(const T* src) {
    *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(src);
  }
  __device__ __forceinline__ void apply(const float* s, float r, T* dst) const {
    uint4 u;
    T2* h = reinterpret_cast<T2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __hmul2(pair(s[2 * i] * r, s[2 * i + 1] * r), g[i]);
    *reinterpret_cast<uint4*>(dst) = u;
  }
  static __device__ __forceinline__ T2 pair(float a, float b);
};
template <>
__device__ __forceinline__ __nv_bfloat162
Scale16<bf16, __nv_bfloat162>::pair(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ __half2 Scale16<__half, __half2>::pair(float a,
                                                                  float b) {
  return __floats2half2_rn(a, b);
}
template <>
struct Scale<bf16, bf16> : Scale16<bf16, __nv_bfloat162> {};
template <>
struct Scale<__half, __half> : Scale16<__half, __half2> {};

template <typename TX, typename TG, int NP>
__global__ void __launch_bounds__(32 * (1 + max_cwarps<TX, TG, NP>()), 1)
fused_kernel(const TX* __restrict__ x, const TX* __restrict__ y,
             const TG* __restrict__ g, TX* __restrict__ s,
             typename Out<TX, TG>::type* __restrict__ h, int n, int d,
             long long sx, long long sy, long long ss, long long sh,
             int block_rows, int stages, int wpr, int cwarps, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = d * (int)sizeof(TX);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)stages * 2 * row_bytes);
  uint64_t* empty = full + stages;
  float* part = reinterpret_cast<float*>(empty + stages);
  const long long row0 = (long long)blockIdx.x * block_rows;
  const int rows = (int)min((long long)block_rows, (long long)n - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], wpr);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {  // the producer: rows ahead into the ring
    if (lane == 0) {
      for (int i = 0; i < rows; ++i) {
        const int st = i % stages;
        if (i >= stages) mbar_wait(&empty[st], ((i / stages) - 1) & 1);
        unsigned char* buf = smem + (size_t)st * 2 * row_bytes;
        mbar_arrive_expect_tx(&full[st], 2 * row_bytes);
        bulk_load(buf, x + (row0 + i) * sx, row_bytes, &full[st]);
        bulk_load(buf + row_bytes, y + (row0 + i) * sy, row_bytes, &full[st]);
      }
    }
    return;
  }

  // consumers: group ``grp`` of ``wpr`` warps takes rows grp, grp +
  // groups, ...; lane L of the row holds packs L, L + 32*wpr, ...  Where
  // the ring wraps, stages is a multiple of groups, so a stage's uses all
  // go to one group, in order: a wait on a use's parity then never sees
  // the phase two uses back (the previous use has completed, since this
  // group consumed it).
  const int cw = warp - 1, groups = cwarps / wpr;
  const int grp = cw / wpr, wr = cw % wpr;
  const int L = lane + 32 * wr, step = 32 * wpr, nvec = d >> 3;
  Scale<TX, TG> gs[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int v = L + step * j;
    if (v < nvec) gs[j].init(g + 8 * v);
  }
  for (int i = grp, k = 0; i < rows; i += groups, ++k) {
    const int st = i % stages;
    TX* xs = reinterpret_cast<TX*>(smem + (size_t)st * 2 * row_bytes);
    TX* ys = xs + d;
    mbar_wait(&full[st], (i / stages) & 1);
    float sv[NP][8];
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int v = L + step * j;
      if (v < nvec) {
        Pack<TX> a, b;
        load(a, xs + 8 * v);
        load(b, ys + 8 * v);
        float fb[8];
        to_f32(a, sv[j]);
        to_f32(b, fb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sv[j][e] += fb[e];
          sq += sv[j][e] * sv[j][e];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    // every lane's loads have landed in registers (the shuffled sum
    // depends on them): free the stage
    if (lane == 0) mbar_arrive(&empty[st]);
    if (wpr > 1) {  // group-uniform
      float* pp = part + (k & 1) * cwarps + grp * wpr;
      if (lane == 0) pp[wr] = sq;
      named_bar_sync(1 + grp, 32 * wpr);
      sq = 0.f;
      for (int w = 0; w < wpr; ++w) sq += pp[w];
    }
    const float r = rsqrtf(sq / (float)d + eps);
    const long long row = row0 + i;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int v = L + step * j;
      if (v < nvec) {
        store(s + row * ss + 8 * v, sv[j]);
        gs[j].apply(sv[j], r, h + row * sh + 8 * v);
      }
    }
  }
}

template <typename TX, typename TG, int NP>
int launch(const void* x, const void* y, const void* g, void* s, void* h,
           int n, int d, long long sx, long long sy, long long ss,
           long long sh, int block_rows, int stages, int wpr, int cwarps,
           float eps, cudaStream_t stream) {
  typedef typename Out<TX, TG>::type TO;
  if (cwarps > max_cwarps<TX, TG, NP>()) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(stages, d * (int)sizeof(TX), cwarps);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = fused_kernel<TX, TG, NP>;
  static bool opted_in[64];  // per device: the shared-memory opt-in
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const long long blocks = ((long long)n + block_rows - 1) / block_rows;
  kern<<<(unsigned)blocks, 32 * (1 + cwarps), smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(y),
      static_cast<const TG*>(g), static_cast<TX*>(s), static_cast<TO*>(h), n,
      d, sx, sy, ss, sh, block_rows, stages, wpr, cwarps, eps);
  return (int)cudaGetLastError();
}

#define FUSED_ARGS \
  x, y, g, s, h, n, d, sx, sy, ss, sh, br, st, wpr, cwarps, eps, strm

template <typename TX, typename TG>
int dispatch_np(int np, const void* x, const void* y, const void* g, void* s,
                void* h, int n, int d, long long sx, long long sy,
                long long ss, long long sh, int br, int st, int wpr,
                int cwarps, float eps, cudaStream_t strm) {
  switch (np) {
    case 1: return launch<TX, TG, 1>(FUSED_ARGS);
    case 2: return launch<TX, TG, 2>(FUSED_ARGS);
    case 3: return launch<TX, TG, 3>(FUSED_ARGS);
    case 4: return launch<TX, TG, 4>(FUSED_ARGS);
    case 8: return launch<TX, TG, 8>(FUSED_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TX>
int dispatch_g(int tg, int np, const void* x, const void* y, const void* g,
               void* s, void* h, int n, int d, long long sx, long long sy,
               long long ss, long long sh, int br, int st, int wpr,
               int cwarps, float eps, cudaStream_t strm) {
  switch (tg) {
    case 0: return dispatch_np<TX, bf16>(np, FUSED_ARGS);
    case 1: return dispatch_np<TX, __half>(np, FUSED_ARGS);
    case 2: return dispatch_np<TX, float>(np, FUSED_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TX, typename TG>
int cwarps_cap(int np) {
  switch (np) {
    case 1: return max_cwarps<TX, TG, 1>();
    case 2: return max_cwarps<TX, TG, 2>();
    case 3: return max_cwarps<TX, TG, 3>();
    case 4: return max_cwarps<TX, TG, 4>();
    case 8: return max_cwarps<TX, TG, 8>();
  }
  return -1;
}

template <typename TX>
int cwarps_cap_g(int tg, int np) {
  switch (tg) {
    case 0: return cwarps_cap<TX, bf16>(np);
    case 1: return cwarps_cap<TX, __half>(np);
    case 2: return cwarps_cap<TX, float>(np);
  }
  return -1;
}

}  // namespace

extern "C" {

// x, y (n, d) with row strides sx, sy; s (n, d) of x's type and h (n, d)
// of the promoted type with row strides ss, sh (elements); g (d,)
// contiguous; dtype codes 0 bf16, 1 f16, 2 f32.  d % 8 == 0, every row
// and g 16-byte aligned, every row stride a multiple of 16 bytes.
// ceil(n / block_rows) blocks of ``stages`` ring stages and cwarps
// consumer warps (a multiple of wpr; at most 20 where x and g share a
// 16-bit type and np <= 4, 16 at other types, 8 where np = 8); a
// row on wpr warps (1, 2, 4 or 8), each lane holding np packs of 8 (np in
// {1, 2, 3, 4, 8}), 256 * wpr * np >= d.  Where the ring wraps (stages <
// min(block_rows, n)), stages is a multiple of the cwarps / wpr groups
// (see the kernel).
// Returns cudaGetLastError() (0 on success).
int repro_fused_add_rmsnorm_fwd(const void* x, const void* y, const void* g,
                                void* s, void* h, int n, int d, long long sx,
                                long long sy, long long ss, long long sh,
                                int tx, int tg, int br, int st, int wpr,
                                int np, int cwarps, float eps,
                                void* stream) {
  if (n <= 0 || d <= 0 || d % 8 || br < 1 || st < 1 ||
      (wpr != 1 && wpr != 2 && wpr != 4 && wpr != 8) || 256 * wpr * np < d ||
      cwarps < wpr || cwarps % wpr)
    return (int)cudaErrorInvalidValue;
  const int groups = cwarps / wpr;
  if (st < br && st < n && st % groups)  // the ring wraps
    return (int)cudaErrorInvalidValue;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  switch (tx) {
    case 0: return dispatch_g<bf16>(tg, np, FUSED_ARGS);
    case 1: return dispatch_g<__half>(tg, np, FUSED_ARGS);
    case 2: return dispatch_g<float>(tg, np, FUSED_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// the kernel's caps and layout, which rmsnorm.py:fused_geometry follows:
// the most consumer warps of the instantiation (tx, tg, np) in
// *max_cwarps, the dynamic shared memory a block of ``stages`` stages of
// width d and cwarps consumer warps takes in *smem, and the most a block
// may take in *max_smem.  Host only: no launch.
int repro_fused_add_rmsnorm_info(int tx, int tg, int np, int d, int stages,
                                 int cwarps, int* max_cwarps, long long* smem,
                                 long long* max_smem) {
  int cap = -1, xb = 0;
  switch (tx) {
    case 0: cap = cwarps_cap_g<bf16>(tg, np); xb = 2; break;
    case 1: cap = cwarps_cap_g<__half>(tg, np); xb = 2; break;
    case 2: cap = cwarps_cap_g<float>(tg, np); xb = 4; break;
  }
  if (cap < 0 || d < 0 || stages < 0 || cwarps < 0)
    return (int)cudaErrorInvalidValue;
  *max_cwarps = cap;
  *smem = (long long)smem_bytes(stages, d * xb, cwarps);
  *max_smem = MAX_SMEM;
  return 0;
}

}  // extern "C"
