// Hopper (sm_90a) primitives shared by the kernels of this directory, as
// small inline functions over PTX: mbarriers, TMA tile loads
// (cp.async.bulk.tensor) and 1D bulk copies (cp.async.bulk), wgmma
// products (SS: A and B from shared memory; RS: A from registers) with
// their shared-memory descriptors for the 128-byte swizzle, setmaxnreg,
// and the warp-level mma.sync m16n8k16 with its ldmatrix loads.  Also the host helper that encodes a
// CUtensorMap over a strided bf16 tensor; cuTensorMapEncodeTiled is taken
// through cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Layout convention.  Every tile goes through TMA in boxes whose inner
// extent is 64 bf16 (128 bytes, the most the 128-byte swizzle allows), so
// a box of R rows lands as R swizzled 128-byte rows, 8 rows (1024 bytes)
// to a swizzle atom.  Such a box is read by wgmma either
//   K-major  (the 64 columns are the reduction axis): rows 8 at a time
//            1024 bytes apart (SBO); a k16 step is +32 bytes; or
//   MN-major (the 64 columns are output columns, the rows the reduction
//            axis; the transpose bit set): a k16 step is 16 rows, +2048
//            bytes; 8-row groups 1024 bytes apart (SBO); the next 64
//            output columns in the next box, LBO bytes on.
// Tiles are 1024-byte aligned, so the swizzle's base offset is 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces ``bytes`` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of ``parity`` to complete.  (A watchdog that traps
// here after a timeout costs the consumers of the flash kernel 200 bytes
// of register spills, so there is none.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// named barriers: ``threads`` (a multiple of 32) reach barrier ``id`` (1-15;
// 0 is __syncthreads's) and wait for each other
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Copy the box at element coordinates (c0 innermost, ...) of ``map`` into
// shared memory at ``dst``; completion is reported to ``bar`` as bytes.
// Coordinates past the tensor's extent read as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy a box from shared memory at ``src`` to the tensor at element
// coordinates (c0 innermost, ...) of ``map``; elements past the tensor's
// extent are not written.  Generic-proxy writes of ``src`` must be made
// visible first (fence_proxy_async), and ``src`` stays untouched until
// tma_store_wait_read.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Copy ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory in one bulk transfer; completion is reported to
// ``bar`` as bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copy ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from
// shared to global memory in one bulk transfer, in the bulk group that
// tma_store_commit closes.  Generic-proxy writes of ``src`` must be made
// visible first (fence_proxy_async, then a barrier), and ``src`` stays
// untouched until tma_store_wait_read.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// wait until the committed bulk stores have completed (their writes are
// made), not only read their shared memory
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's shared-memory writes before later async-proxy
// (TMA, wgmma) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of element (row, col) of a box of 64-column (128-byte) rows
// in the 128-byte swizzle: 16-byte chunk col/8 of row ``row`` sits at
// chunk (col/8) ^ (row%8)
__device__ __forceinline__ int sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// ---------------------------------------------------------------------------
// register budget of warp-specialised blocks
// ---------------------------------------------------------------------------

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// a K-major operand (A, or B stored [n][k]); ``smem`` already advanced by
// 32 bytes per k16 step
__device__ __forceinline__ uint64_t desc_k_major(const void* smem) {
  return desc_sw128(smem, 16, 1024);
}

// an MN-major B operand (stored [k][n], transpose bit set); ``smem``
// already advanced by 2048 bytes per k16 step; ``box_stride`` bytes between
// the boxes of successive 64 output columns
__device__ __forceinline__ uint64_t desc_mn_major(const void* smem,
                                                  uint32_t box_stride) {
  return desc_sw128(smem, box_stride, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (call after wgmma_wait, before reading).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// accumulator register lists of the inline asm below
#define HOPPER_D32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define HOPPER_D64                                                          \
  HOPPER_D32                                                                \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
  "%60, %61, %62, %63"
#define HOPPER_D128                                                         \
  HOPPER_D64                                                                \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, " \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "  \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "      \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_F8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_F32(i) \
  HOPPER_F8(i), HOPPER_F8(i + 8), HOPPER_F8(i + 16), HOPPER_F8(i + 24)

// D (64 x N, f32 in registers) = A B (+ D if ``accumulate``), bf16 operands:
// SS reads A (64 x 16, K-major) and B (16 x N) from shared memory; RS takes
// A from registers (4 x 32 bits a thread: the accumulator layout of a
// 64 x 16 tile, packed bf16x2).  TRANS_B: 0 for a K-major B, 1 for MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_D32
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_F32(0)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a,
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_D64
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_F32(0), HOPPER_F32(32)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128],
                                                    uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" HOPPER_D128
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : HOPPER_F32(0), HOPPER_F32(32), HOPPER_F32(64), HOPPER_F32(96)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_D64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_F32(0), HOPPER_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_D128
#undef HOPPER_F8
#undef HOPPER_F32

// 2^x by the SFU, subnormal results flushed to zero (exp2f spends three
// more instructions an element on them: p < 2^-126 adds nothing to a
// softmax row whose largest term is 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (bf16 in, f32 accumulate) and its ldmatrix loads
// ---------------------------------------------------------------------------

// Four 8 x 8 bf16 matrices from shared memory, lanes 8m..8m+7 giving the
// row addresses of matrix m: thread t receives row t/4, columns 2(t%4)
// and 2(t%4)+1 of each (``_t``: of each matrix transposed).  As an A
// operand (16 x 16, row-major rows r): lane l addresses row l % 16,
// column 8 (l / 16).  As two n8 B operands from rows of n (k along a
// row): row (l % 8) + 8 (l / 16), column 8 ((l / 8) % 2); from rows of k
// (``_t``): row (l % 8) + 8 ((l / 8) % 2), column 8 (l / 16).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16) b (16 x 8).  Thread t holds c[0..1] at
// row t/4, columns 2(t%4)+{0,1}, and c[2..3] eight rows below; a[0..3]
// at (row t/4, k 2(t%4)), (row +8, same k), (row, k +8), (row +8, k +8),
// two k a register; b0 at k 2(t%4)+{0,1}, column t/4, and b1 at k +8.
// Registers only (not volatile), so the compiler may interleave
// independent products to hide the tensor cores' latency.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where thread t of a warpgroup holds accumulator element d[4j + 2i + c]
// of a 64 x N tile: row 16*(t/32) + (t%32)/4 + 8i, column 8j + 2*(t%4) + c.
__device__ __forceinline__ int acc_row(int t) {
  return 16 * (t / 32) + (t % 32) / 4;
}
__device__ __forceinline__ int acc_col(int t) { return 2 * (t % 4); }

// the dynamic shared memory rounded up to the 1024 bytes of a swizzle atom
__device__ __forceinline__ uint8_t* smem_aligned_1024(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Encode a rank-``rank`` map over a bf16 tensor at ``base``: ``dims`` from
// the innermost (unit-stride) dimension out, ``strides`` the element
// strides of dims 1.. (16-byte multiples), ``box`` the tile each load
// copies (box[0] = 64: 128 bytes, 128-byte swizzle).  Out-of-bounds
// elements load as zeros.  A dimension of extent 1 takes the stride of a
// contiguous layout, whatever it had.  Returns a cudaError_t (0: success).
inline int make_map_bf16(CUtensorMap* map, const void* base, int rank,
                         const long long* dims, const long long* strides,
                         const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  long long contiguous = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    gbox[i] = box[i];
    estride[i] = 1;
    if (i > 0)
      gstride[i - 1] = static_cast<cuuint64_t>(
          dims[i] == 1 ? contiguous : strides[i - 1] * 2);
    contiguous *= dims[i];
    contiguous = (contiguous + 15) / 16 * 16;
  }
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  static_cast<cuuint32_t>(rank), const_cast<void*>(base), gdim,
                  gstride, gbox, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Whether the compiled kernel ``fn`` holds enough registers for a block of
// ``threads`` whose warpgroups then move to ``budget`` registers (their sum
// over the block) with setmaxnreg: setmaxnreg.inc waits for registers the
// block does not have, so a short allocation would hang, not fail.
inline int check_register_budget(const void* fn, int threads, int budget) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  return a.numRegs * threads >= budget ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace hopper
