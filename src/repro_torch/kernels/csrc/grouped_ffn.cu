// Grouped expert FFN for Hopper (sm_90a), bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py:grouped_ffn
// (Pallas body _grouped_ffn_kernel).  Same function, per expert e:
//   y_e = (silu(x_e W1_e) * (x_e W3_e)) W2_e
// with x (E, N, D), w1/w3 (E, D, F), w2 (E, F, D).  The TPU kernel walks
// F in blocks on one core and adds each block's partial product into the
// bf16 output, rounding it after every block; here all of F is summed in
// f32 and the output is rounded once, which is the same function, more
// exactly.  The gated hidden activation h is kept in bf16 between the two
// launches (one rounding of each element of h).  There is no split over
// D or F, and each sum runs in one fixed order, so a row's result does not
// depend on the row tile it lands in (a Comet chunk equals the same rows
// of the whole buffer bitwise).
//
// What bounds it on the H100.  At the DBO prefill micro-batch of
// deepseek-moe-16b, (E, N, D, F) = (64, 480, 2048, 1408): 532 GFLOP
// against 1.36 GB of weights, activations and outputs, so operations
// (0.54 ms at 989 TFLOP/s) over bytes (0.41 ms at 3.35 TB/s).  At a
// Comet chunk (N = 120) and at decode (N = 4) the weights dominate and
// bytes bound it: every expert's 17.3 MB of W1, W3 and W2 must stream
// once.
//
// Design.  Two launches, as the TPU kernel's sequential F axis cannot
// carry a sum between parallel blocks, each a warp-specialised wgmma GEMM:
// a producer warpgroup whose first thread streams 64-deep tiles of the A
// rows and of the weights into a ring of STAGES shared-memory stages by
// TMA ("full" mbarriers count the bytes, "empty" ones one arrival per
// consumer warp), and NC consumer warpgroups of 64 rows each that run
// wgmma on the stages with f32 accumulators in registers, keeping one
// group of products in flight while the next is issued.
//   1. gate-up: one block per (row tile of 64 NC, F tile of BN, expert).
//      The W1 tile and the matching W3 tile sit side by side as one
//      MN-major B operand (transpose bit: W is stored [D][F]), so one
//      m64n(2 BN)k16 wgmma fills both; column j of x W1 and column j of
//      x W3 then sit in the same thread, 4 BN/8 registers apart, and
//      silu(a) * b is elementwise on the registers.  h (E, N, F) bf16.
//   2. down: one block per (row tile, D tile of BN, expert) forms h W2
//      over all of F in f32 and rounds once.
// N > 64 (prefill) takes two consumer warpgroups (128 rows: every weight
// tile is read ceil(N/128) times) with 128-wide gate-up and 256-wide down
// tiles, setmaxnreg moving the producer's registers to the consumers;
// N <= 64 (decode) one consumer warpgroup and 64 / 128-wide tiles, two
// blocks an SM, so the weight stream has more blocks in flight.  A block
// is grid-ordered row tile fastest, so the row tiles of one weight tile
// run together and share it through L2.  Rows past N and W columns past
// F are zero-filled by TMA and never stored; x is a rank-3 map with its
// own expert and row strides, so Comet's chunks are read in place.
#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;            // reduction depth of one stage
constexpr int BOX = 64 * 128;     // bytes of a 64-row x 64-column box

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// One kernel for both launches.  GATE: A = x (E, N, D), B = [W1 | W3]
// tiles, out = h (E, N, F) = silu(x W1) * (x W3).  !GATE: A = h, B = W2,
// out = y (E, N, D).  BN: output columns a block writes; K: D or F.
template <bool GATE, int NC, int BN, int STAGES>
struct GemmCfg {
  static constexpr int WN = GATE ? 2 * BN : BN;   // wgmma width
  static constexpr int A_BYTES = NC * 64 * 128;   // one box of NC*64 rows
  static constexpr int B_BYTES = (WN / 64) * BOX;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr size_t SMEM =
      1024 + STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
};

template <int WN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[WN / 2], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (WN == 256)
    hopper::wgmma_m64n256k16_ss<1>(acc, a, b, accumulate);
  else
    hopper::wgmma_m64n128k16_ss<1>(acc, a, b, accumulate);
}

template <bool GATE, int NC, int BN, int STAGES>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
ffn_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb0,
                const __grid_constant__ CUtensorMap tb1,
                bf16* __restrict__ out, int N, int K, int ncols) {
  using C = GemmCfg<GATE, NC, BN, STAGES>;
  using namespace hopper;
  constexpr int WN = C::WN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = smem_aligned_1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * NC * 64, c0 = blockIdx.y * BN, e = blockIdx.z;
  const int kt_n = K / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
        uint8_t* sa = stages + s * C::STAGE_BYTES;
        uint8_t* sb = sa + C::A_BYTES;
        tma_load_3d(sa, &ta, &full[s], kt * BK, n0, e);
#pragma unroll
        for (int x = 0; x < BN / 64; ++x) {
          tma_load_3d(sb + x * BOX, &tb0, &full[s], c0 + 64 * x, kt * BK, e);
          if constexpr (GATE)
            tma_load_3d(sb + (BN / 64 + x) * BOX, &tb1, &full[s],
                        c0 + 64 * x, kt * BK, e);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (NC == 2) setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int t = threadIdx.x % 128, lane = t % 32;

  // (A warpgroup whose rows all lie past N multiplies zeros: skipping its
  // products in a branch makes ptxas serialize every wgmma of the kernel.)
  float acc[WN / 2];
#pragma unroll
  for (int r = 0; r < WN / 2; ++r) acc[r] = 0.f;

  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* sa = stages + s * C::STAGE_BYTES + cw * 8192;
    const uint8_t* sb = stages + s * C::STAGE_BYTES + C::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tile<WN>(acc, desc_k_major(sa + kk * 32),
                     desc_mn_major(sb + kk * 2048, BOX), 1);
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: release it
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[(kt_n - 1) % STAGES]);

  // epilogue: column pairs straight from the registers, rows < N
  const int row0 = n0 + cw * 64 + acc_row(t);
  const int col = c0 + acc_col(t);
  bf16* oe = out + (long long)e * N * ncols;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= N) continue;
    bf16* orow = oe + (long long)row * ncols + col;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      float v0 = acc[4 * jj + 2 * i], v1 = acc[4 * jj + 2 * i + 1];
      if constexpr (GATE) {
        // x W3 sits BN columns (4 BN/8 registers) to the right
        v0 = silu(v0) * acc[4 * (jj + BN / 8) + 2 * i];
        v1 = silu(v1) * acc[4 * (jj + BN / 8) + 2 * i + 1];
      }
      if (col + 8 * jj < ncols)
        *reinterpret_cast<uint32_t*>(orow + 8 * jj) = pack_bf16x2(v0, v1);
    }
  }
}

template <bool GATE, int NC, int BN, int STAGES>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb0,
                const CUtensorMap& tb1, bf16* out, int E, int N, int K,
                int ncols, cudaStream_t stream) {
  using C = GemmCfg<GATE, NC, BN, STAGES>;
  auto kern = ffn_gemm_kernel<GATE, NC, BN, STAGES>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (NC == 2) {
      // setmaxnreg: 40 producer + 2 x 232 consumer registers per thread lane
      const int rc = hopper::check_register_budget(
          (const void*)kern, C::THREADS, 128 * (40 + 2 * 232));
      if (rc) return rc;
    }
    ready = true;
  }
  dim3 grid((N + NC * 64 - 1) / (NC * 64), (ncols + BN - 1) / BN, E);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(ta, tb0, tb1, out, N, K, ncols);
  return (int)cudaGetLastError();
}

// (E, rows, cols) bf16 with element strides se (expert) and sr (row), a
// unit column stride: a rank-3 map (cols, rows, E) and boxes of 64 columns
// by ``box_rows`` rows
int map3(CUtensorMap* m, const void* p, long long E, long long rows,
         long long cols, long long se, long long sr, uint32_t box_rows) {
  const long long dims[3] = {cols, rows, E}, strides[2] = {sr, se};
  const uint32_t box[3] = {64, box_rows, 1};
  return hopper::make_map_bf16(m, p, 3, dims, strides, box);
}

template <int NC, int BN_UP, int BN_DOWN, int STAGES>
int launch_ffn(const void* x, const void* w1, const void* w3, const void* w2,
               void* h, void* y, int E, int N, int D, int F, long long sxe,
               long long sxn, cudaStream_t s) {
  CUtensorMap tx, tw1, tw3, th, tw2;
  int rc = map3(&tx, x, E, N, D, sxe, sxn, NC * 64);
  if (!rc) rc = map3(&tw1, w1, E, D, F, (long long)D * F, F, 64);
  if (!rc) rc = map3(&tw3, w3, E, D, F, (long long)D * F, F, 64);
  if (!rc) rc = map3(&th, h, E, N, F, (long long)N * F, F, NC * 64);
  if (!rc) rc = map3(&tw2, w2, E, F, D, (long long)F * D, D, 64);
  if (!rc)
    rc = launch_gemm<true, NC, BN_UP, STAGES>(tx, tw1, tw3,
                                              static_cast<bf16*>(h), E, N, D,
                                              F, s);
  if (!rc)
    rc = launch_gemm<false, NC, BN_DOWN, STAGES>(th, tw2, tw2,
                                                 static_cast<bf16*>(y), E, N,
                                                 F, D, s);
  return rc;
}

template <bool GATE, int NC, int BN, int STAGES>
int gemm_info(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t e =
      cudaFuncGetAttributes(&a, ffn_gemm_kernel<GATE, NC, BN, STAGES>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)GemmCfg<GATE, NC, BN, STAGES>::SMEM;
  return 0;
}

}  // namespace

extern "C" {

// x (E, N, D) bf16 with element strides sxe (expert) and sxn (row), unit
// column stride; w1/w3 (E, D, F), w2 (E, F, D), h (E, N, F) scratch and
// y (E, N, D) contiguous bf16.  Needs D % 128 == 0 and F % 64 == 0, all
// pointers 16-byte aligned and sxe, sxn multiples of 8.  Returns
// cudaGetLastError() after the launches, or the error of a tensor-map
// encoding (0 on success).
int repro_grouped_ffn_fwd(const void* x, const void* w1, const void* w3,
                          const void* w2, void* h, void* y, int E, int N,
                          int D, int F, long long sxe, long long sxn,
                          void* stream) {
  if (E < 1 || N < 1 || D < 128 || F < 64 || D % 128 || F % 64 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 64)
    return launch_ffn<2, 128, 256, 4>(x, w1, w3, w2, h, y, E, N, D, F, sxe,
                                      sxn, s);
  return launch_ffn<1, 64, 128, 4>(x, w1, w3, w2, h, y, E, N, D, F, sxe, sxn,
                                   s);
}

// registers a thread, local (spill) bytes and dynamic shared memory a
// block of variant ``which``: 0 gate-up and 1 down for N > 64, 2 gate-up
// and 3 down for N <= 64
int repro_grouped_ffn_info(int which, int* regs, int* local_bytes,
                           int* smem_bytes) {
  switch (which) {
    case 0: return gemm_info<true, 2, 128, 4>(regs, local_bytes, smem_bytes);
    case 1: return gemm_info<false, 2, 256, 4>(regs, local_bytes, smem_bytes);
    case 2: return gemm_info<true, 1, 64, 4>(regs, local_bytes, smem_bytes);
    case 3: return gemm_info<false, 1, 128, 4>(regs, local_bytes, smem_bytes);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
