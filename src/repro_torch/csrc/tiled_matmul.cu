// Plain tiled GEMM, C = A @ B with an f32 accumulator, for Hopper.
//
// Replaces the Pallas TPU kernel tiled_matmul (src/repro/kernels/fused_gemm.py,
// _matmul_kernel): the non-LCMA baseline GEMM the autotuner times to fit the
// profile's FLOPS_x (repro_torch.core.autotune, through kernels.ops.matmul).
// A (M, K) and B (K, N) are float32 or bfloat16, row-major and contiguous; C
// (M, N) is float32 or bfloat16, rounded once from the f32 sum.
//
// Bound on the H100: operations at large square shapes (2*M*N*K against
// (MK + KN + MN) * itemsize bytes: 4096^3 bf16 is 0.139 ms at 989 TFLOP/s);
// bytes at the autotuner's short-M probes and at decode rows, where the
// kernel is a stream over B (256x2048x8192 bf16: 38.8 MB, 0.0116 ms).
//
// Two routes, chosen by the wrapper (kernels/fused_gemm.py:tiled_route)
// before the launch from dtype and alignment, never after a failure:
//
// wgmma (bf16 operands, K and N multiples of 8, 16-byte-aligned A and B: what
// TMA needs). A block owns a BM x BN output tile (tuning.TILED_WG_TILES) and
// walks its K range in 64-deep stages through a kWgStages-deep ring in
// shared memory. One producer warp keeps the ring full with TMA box loads
// (A as one BM x 64 box, B as BN/64 boxes of 64 x 64, both 128-byte
// swizzled; TMA zero-fills what lies outside the matrix, so ragged edges need
// no padding), each stage guarded by a full and an empty mbarrier. BM/64
// consumer warpgroups each issue wgmma m64nBNk16 (bf16 -> f32, B read
// MN-major straight from the (K, N) layout) on the stages that have arrived,
// keep one stage's products in flight and hand the stage before back. The
// epilogue writes C (or, split, an f32 partial) from the accumulator
// registers, masked at the edge. Where the output tiles alone cannot fill the
// card (short-M probes, decode rows), the K range is split across blocks and
// split_reduce_kernel (common.cuh) sums the partials in fixed order.
//
// SIMT (f32 operands, where TF32 would break the f32 tolerance, and bf16
// operands TMA cannot address). One block owns a BM x BN output tile and
// loops over K, staging a BM x kTBK slice of A and a kTBK x BN slice of B in
// shared memory as f32; 256 threads in a 16 x 16 layout each own a
// (BM/16) x (BN/16) micro-tile in registers (strided by 16, so shared-memory
// reads are broadcasts or consecutive words) and sum it with f32 FMA. f32
// loads are 16 bytes a thread where K and N are multiples of 4 and both
// operands are 16-byte aligned (ALIGNED); bf16 here, and the rest, load
// element-wise. Ragged edges are masked. grid.x runs along the longer output
// dimension.
//
// Offsets are 64-bit. Tiles, ring depth and splits: kernels/tuning.py
// (plan_tiled_wgmma, plan_tiled_matmul_blocks).
#include <type_traits>

#include "wgmma_tma.cuh"

constexpr int kTThreads = 256;
constexpr int kTBK = 16;  // K depth of one shared-memory stage

// 16 bytes (four f32) from global memory, aligned.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

template <typename Tin, typename Tout, int BM, int BN, bool ALIGNED>
__global__ void __launch_bounds__(kTThreads)
tiled_matmul_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
                    Tout* __restrict__ c, int M, int K, int N, int m_major) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int VEC = 16 / sizeof(Tin);
  __shared__ float As[BM][kTBK + 1];
  __shared__ float Bs[kTBK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = (m_major ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (m_major ? blockIdx.y : blockIdx.x) * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTBK) {
    if constexpr (ALIGNED) {
      // K and N are multiples of VEC, so a vector that starts in bounds
      // ends in bounds.
      for (int e = tid; e < BM * kTBK / VEC; e += kTThreads) {
        const int row = e / (kTBK / VEC), col = e % (kTBK / VEC) * VEC;
        const int gm = m0 + row, gk = k0 + col;
        float v[VEC];
        if (gm < M && gk < K) {
          load16(a + (long long)gm * K + gk, v);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) As[row][col + i] = v[i];
      }
      for (int e = tid; e < kTBK * BN / VEC; e += kTThreads) {
        const int row = e / (BN / VEC), col = e % (BN / VEC) * VEC;
        const int gk = k0 + row, gn = n0 + col;
        float v[VEC];
        if (gk < K && gn < N) {
          load16(b + (long long)gk * N + gn, v);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) Bs[row][col + i] = v[i];
      }
    } else {
      for (int e = tid; e < BM * kTBK; e += kTThreads) {
        const int row = e / kTBK, col = e % kTBK;
        const int gm = m0 + row, gk = k0 + col;
        As[row][col] = (gm < M && gk < K) ? to_f32(a[(long long)gm * K + gk]) : 0.f;
      }
      for (int e = tid; e < kTBK * BN; e += kTThreads) {
        const int row = e / BN, col = e % BN;
        const int gk = k0 + row, gn = n0 + col;
        Bs[row][col] = (gk < K && gn < N) ? to_f32(b[(long long)gk * N + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTBK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) c[(long long)gm * N + gn] = from_f32<Tout>(acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout, int BM, int BN>
static int launch(const void* a, const void* b, void* c, int M, int K, int N,
                  cudaStream_t s) {
  const long long tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int m_major = tiles_m > tiles_n;
  const long long gx = m_major ? tiles_m : tiles_n, gy = m_major ? tiles_n : tiles_m;
  if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const Tin* pa = static_cast<const Tin*>(a);
  const Tin* pb = static_cast<const Tin*>(b);
  Tout* pc = static_cast<Tout*>(c);
  // 16-byte loads for f32 only: bf16 that allows them takes the wgmma route.
  if constexpr (std::is_same<Tin, float>::value) {
    if (K % 4 == 0 && N % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(b) % 16 == 0) {
      tiled_matmul_kernel<Tin, Tout, BM, BN, true><<<grid, kTThreads, 0, s>>>(pa, pb, pc, M, K, N, m_major);
      return (int)cudaGetLastError();
    }
  }
  tiled_matmul_kernel<Tin, Tout, BM, BN, false><<<grid, kTThreads, 0, s>>>(pa, pb, pc, M, K, N, m_major);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
static int launch_tile(int bm, int bn, const void* a, const void* b, void* c, int M,
                       int K, int N, cudaStream_t s) {
  // The tile shapes kernels/tuning.py:TILED_TILES may pick.
  if (bm == 128 && bn == 128) return launch<Tin, Tout, 128, 128>(a, b, c, M, K, N, s);
  if (bm == 64 && bn == 64) return launch<Tin, Tout, 64, 64>(a, b, c, M, K, N, s);
  if (bm == 16 && bn == 64) return launch<Tin, Tout, 16, 64>(a, b, c, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

// a (M, K), b (K, N), c (M, N); all contiguous. in_dtype is a's and b's type.
extern "C" int falcon_tiled_matmul(int device, const void* a, const void* b, void* c,
                                   int in_dtype, int out_dtype, int M, int K, int N,
                                   int bm, int bn, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == FALCON_F32 && out_dtype == FALCON_F32)
    return launch_tile<float, float>(bm, bn, a, b, c, M, K, N, s);
  if (in_dtype == FALCON_F32 && out_dtype == FALCON_BF16)
    return launch_tile<float, __nv_bfloat16>(bm, bn, a, b, c, M, K, N, s);
  if (in_dtype == FALCON_BF16 && out_dtype == FALCON_F32)
    return launch_tile<__nv_bfloat16, float>(bm, bn, a, b, c, M, K, N, s);
  if (in_dtype == FALCON_BF16 && out_dtype == FALCON_BF16)
    return launch_tile<__nv_bfloat16, __nv_bfloat16>(bm, bn, a, b, c, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The tensor-core route
// ---------------------------------------------------------------------------

constexpr int kWgBK = 64;       // TILED_WG_BK: K elements of one stage (one swizzle row)
constexpr int kWgStages = 4;    // TILED_WG_STAGES: depth of the TMA ring
constexpr int kBoxBytes = 64 * kWgBK * 2;  // one 64 x 64 bf16 box of B

// Shared memory of one block (kernels/tuning.py:tiled_wgmma_smem): 1024 bytes
// of slack to put the ring on a 1024-byte boundary, kWgStages stages of an
// A tile (BM rows of 128 bytes) and a B tile (BN/64 boxes), then the full and
// empty mbarriers.
template <int BM, int BN>
struct WgLayout {
  static constexpr int kTileA = BM * kWgBK * 2;
  static constexpr int kTileB = BN * kWgBK * 2;
  static constexpr int kStage = kTileA + kTileB;
  static constexpr int kBytes = 1024 + kWgStages * kStage + 2 * kWgStages * 8;
  static constexpr int kThreads = BM / 64 * 128 + 32;  // consumer warpgroups, producer warp
  static constexpr int kMinBlocks = BM == 64 ? 2 : 1;     // blocks an SM holds (shared memory)
};

template <typename Tout>
__device__ __forceinline__ void store2(Tout* p, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename Tout, int BM, int BN>
__global__ void __launch_bounds__(WgLayout<BM, BN>::kThreads, WgLayout<BM, BN>::kMinBlocks)
tiled_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, Tout* __restrict__ c,
                   float* __restrict__ ws, int M, int K, int N, int splits) {
  using L = WgLayout<BM, BN>;
  constexpr int NC = BM / 64;      // consumer warpgroups, 64 rows each
  constexpr int ACC = BN / 2;      // f32 accumulators a consumer thread holds
  extern __shared__ unsigned char wg_smem[];
  const uint32_t ring = (wg::smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t bars = ring + kWgStages * L::kStage;  // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWgStages + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int kblocks = (K + kWgBK - 1) / kWgBK;
  const int kb0 = (int)((long long)kblocks * split / splits);
  const int kb1 = (int)((long long)kblocks * (split + 1) / splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), NC * 4);  // one arrival per consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == NC * 4) {
    // Producer: one thread issues every TMA load of the block's K range.
    if (lane == 0) {
      wg::tma_prefetch_desc(&map_a);
      wg::tma_prefetch_desc(&map_b);
      for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
        const int s = it % kWgStages;
        wg::mbar_wait(empty(s), ((it / kWgStages) & 1) ^ 1);  // round 0 passes at once
        wg::mbar_arrive_expect_tx(full(s), L::kStage);
        const uint32_t sa = ring + s * L::kStage, sb = sa + L::kTileA;
        wg::tma_load_2d(sa, &map_a, kb * kWgBK, m0, full(s));
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          wg::tma_load_2d(sb + j * kBoxBytes, &map_b, n0 + j * 64, kb * kWgBK, full(s));
      }
    }
    return;
  }

  // Consumer warpgroup `grp`: rows [grp*64, grp*64 + 64) of the tile.
  const int grp = warp / 4;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
    const int s = it % kWgStages;
    wg::mbar_wait(full(s), (it / kWgStages) & 1);
    const uint32_t sa = ring + s * L::kStage + grp * 64 * 128, sb = ring + s * L::kStage + L::kTileA;
    wg::fence_operands<ACC>(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      wg::wgmma_k16<BN>(acc, wg::make_desc(sa + kk * 32, 16, 1024),
                        wg::make_desc(sb + kk * 16 * 128, kBoxBytes, 1024));
    wg::wgmma_commit();
    wg::fence_operands<ACC>(acc);
    // Keep this stage's products in flight; the previous stage's are done,
    // so its buffers go back to the producer.
    wg::wgmma_wait<1>();
    if (it > 0 && lane == 0) wg::mbar_arrive(empty((it - 1) % kWgStages));
  }
  wg::wgmma_wait<0>();
  wg::fence_operands<ACC>(acc);

  // Accumulator layout of m64nBNk16: warp w of the group holds rows 16w..16w+15;
  // per 8-column block j, a thread holds rows lane/4 and lane/4 + 8, columns
  // 2*(lane%4) and +1. N is a multiple of 8, so a pair is whole or outside.
  const int row0 = m0 + grp * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < M && col < N) {
        const float v0 = acc[j * 4 + 2 * h], v1 = acc[j * 4 + 2 * h + 1];
        if (splits == 1)
          store2<Tout>(c + (long long)row * N + col, v0, v1);
        else
          store2<float>(ws + ((long long)split * M + row) * N + col, v0, v1);
      }
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: its address is
// fetched once through the runtime, so the library links cudart only.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn tensor_map_encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major bf16 matrix, read in boxes of 64 columns by
// box_rows rows with the 128-byte swizzle.
static int encode_bf16(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename Tout, int BM, int BN>
static int launch_wgmma(const void* a, const void* b, void* c, float* ws, int M, int K, int N,
                        int splits, int smem_bytes, cudaStream_t s) {
  using L = WgLayout<BM, BN>;
  if (smem_bytes != L::kBytes) return (int)cudaErrorInvalidValue;  // planner drifted
  const long long gy = (M + BM - 1) / BM;
  if (gy > 65535 || splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int err = encode_bf16(&map_a, a, M, K, BM);
  if (err == 0) err = encode_bf16(&map_b, b, K, N, kWgBK);
  if (err != 0) return err;
  auto kernel = tiled_wgmma_kernel<Tout, BM, BN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (unsigned)gy, splits);
  kernel<<<grid, L::kThreads, L::kBytes, s>>>(map_a, map_b, static_cast<Tout*>(c), ws, M, K,
                                              N, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_split_reduce<Tout>(ws, static_cast<Tout*>(c), (long long)M * N, splits, s);
}

template <typename Tout>
static int launch_wgmma_tile(int bm, int bn, const void* a, const void* b, void* c, float* ws,
                             int M, int K, int N, int splits, int smem_bytes, cudaStream_t s) {
  // The tiles kernels/tuning.py:TILED_WG_TILES may pick.
  if (bm == 128 && bn == 256)
    return launch_wgmma<Tout, 128, 256>(a, b, c, ws, M, K, N, splits, smem_bytes, s);
  if (bm == 128 && bn == 128)
    return launch_wgmma<Tout, 128, 128>(a, b, c, ws, M, K, N, splits, smem_bytes, s);
  if (bm == 64 && bn == 128)
    return launch_wgmma<Tout, 64, 128>(a, b, c, ws, M, K, N, splits, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 a (M, K), b (K, N); c (M, N) in out_dtype; ws (splits, M, N) f32 when
// splits > 1. Refuses (cudaErrorInvalidValue) what TMA cannot address: K or N
// not a multiple of 8, or a or b not 16-byte aligned.
extern "C" int falcon_tiled_matmul_wgmma(int device, const void* a, const void* b, void* c,
                                         void* ws, int out_dtype, int M, int K, int N, int bm,
                                         int bn, int splits, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K % 8 || N % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || M < 1 || K < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (out_dtype == FALCON_F32)
    return launch_wgmma_tile<float>(bm, bn, a, b, c, w, M, K, N, splits, smem_bytes, s);
  if (out_dtype == FALCON_BF16)
    return launch_wgmma_tile<__nv_bfloat16>(bm, bn, a, b, c, w, M, K, N, splits, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
