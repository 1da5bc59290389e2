// Plain tiled GEMM, C = A @ B with an f32 accumulator, for Hopper.
//
// Replaces the Pallas TPU kernel tiled_matmul (src/repro/kernels/fused_gemm.py,
// _matmul_kernel): the non-LCMA baseline GEMM the autotuner times to fit the
// profile's FLOPS_x (repro_torch.core.autotune, through kernels.ops.matmul).
// A (M, K) and B (K, N) are float32 or bfloat16, row-major and contiguous; C
// (M, N) is float32 or bfloat16, rounded once from the f32 sum.
//
// Bound on the H100: operations at large square shapes (2*M*N*K against
// (MK + KN + MN) * itemsize bytes: 4096^3 bf16 is 0.139 ms at 989 TFLOP/s,
// f32 2.05 ms at 67 TFLOP/s); bytes at decode rows, where the kernel is a
// stream over B (4x2048x8192 f32: 67 MB, 0.020 ms), and in bf16 at the
// autotuner's short-M probes (256x2048x8192: 38.8 MB, 0.0116 ms).
//
// Three routes, chosen by the wrapper (kernels/tuning.py:tiled_route) before
// the launch from dtype and alignment, never after a failure. Each splits
// the K range across blocks where the output tiles alone cannot fill the
// card (short-M probes, decode rows); split_reduce_kernel (common.cuh) then
// sums the f32 partials in fixed order.
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
// registers, masked at the edge.
//
// f32 (f32 operands): an SGEMM on the FP32 pipe alone. No TF32: it would
// break the f32 tolerance, and the calibration that times this kernel
// prices torch.matmul's f32, which runs on the same pipe. A block owns a
// BM x BN tile (tuning.TILED_F32_TILES) over WM x WN warps; a lane holds GM x
// GN groups of 4 x 4 outputs, the groups strided by the warp's lanes, so
// each fragment is read with one 16-byte LDS that the warp serves in one
// wavefront (consecutive addresses or a broadcast). Stages of sg::kBK K
// steps come through an sg::kStages-deep cp.async ring in dynamic shared memory: A
// stored K-major, transposed by 4-byte copies (a warp copies 8 k x 4 m, so
// its stores hit 32 banks), B row-major by 16-byte copies where N % 4 == 0
// and B is 16-byte aligned, else 4-byte ones; ragged edges are zero-filled.
// Fragments are double-buffered in registers, so step k+1's reads overlap
// step k's FMAs. Large M takes a 128 x 256 tile, each lane 8 x 16 outputs:
// 128 FMAs for 6 fragment reads (8 x 8 lanes spend 4 reads on 64, and the
// shared-memory pipe then keeps pace with the FMAs only just), one block of
// 256 threads an SM with up to 255 registers each. Decode rows take 8- and
// 16-row tiles of 128 threads, 4 blocks an SM.
//
// mma (bf16 operands TMA cannot address: K or N no multiple of 8, or A or B
// not 16-byte aligned). mma.sync m16n8k16 bf16 -> f32 on a 64*WM x 128 tile,
// warps of 64 x 32, fragments through ldmatrix (.trans for the N-contiguous
// B), stages of mm::kBK K steps in an mm::kStages-deep cp.async ring. An operand
// whose row stride and pointer allow it is staged by 16-byte copies. Any
// other is staged raw, still by 16-byte copies and in the same ring: each
// row's 16-byte chunks from the one holding the stage's first element,
// bytes past the row's end zero-filled; when its stage has landed, the
// block shifts every row by its 2-byte misalignment into one more stage's
// buffers (a word or a byte permute of two per element pair), which the
// products read. So no global load waits outside the ring.
//
// Offsets are 64-bit. Tiles, ring depth and splits: kernels/tuning.py
// (plan_tiled_wgmma, plan_tiled_f32, plan_tiled_mma).
#include <type_traits>

#include "fused_tc.cuh"  // cp.async, ldmatrix, mma.sync
#include "wgmma_tma.cuh"

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

// Up to four consecutive outputs of a row, `left` of them inside the matrix;
// one 8- or 16-byte store where VEC allows (N % 4 == 0 and an aligned base).
template <typename Tout, bool VEC>
__device__ __forceinline__ void store4(Tout* p, const float* v, int left) {
  if (VEC && left >= 4) {
    if constexpr (std::is_same<Tout, float>::value) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 r;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
      h[0] = __floats2bfloat162_rn(v[0], v[1]);
      h[1] = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(p) = r;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < left) p[j] = from_f32<Tout>(v[j]);
}

// ---------------------------------------------------------------------------
// The f32 route
// ---------------------------------------------------------------------------

namespace sg {

constexpr int kBK = 16;      // TILED_F32_BK: K steps of one ring stage
constexpr int kStages = 4;   // TILED_F32_STAGES
constexpr int kPadA = 4;     // TILED_F32_PAD: floats after every staged A^T row

// A BM x BN tile over WM x WN warps, each lane GM x GN groups of 4 x 4
// outputs, MINB blocks an SM in the launch bounds (tuning.TILED_F32_TILES). Shared memory (tuning.tiled_f32_smem):
// kStages stages of A^T [kBK][BM + kPadA] and B [kBK][BN], f32.
template <int BM_, int BN_, int WM_, int WN_, int GM_, int GN_, int MINB>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, GM = GM_, GN = GN_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int LM = BM / (WM * 4 * GM);   // lanes of a warp along m
  static constexpr int LN = 32 / LM;              // ... and along n
  static constexpr int TM = 4 * GM, TN = 4 * GN;  // a lane's outputs
  static constexpr int kLdA = BM + kPadA;
  static constexpr int kStage = kBK * kLdA + kBK * BN;  // floats
  static constexpr int kBytes = kStages * kStage * 4;
  static constexpr int kMinBlocks = MINB;  // the launch bounds' blocks an SM
  static_assert(LM * LN == 32 && LN * 4 * GN * WN == BN, "the warps cover the tile");
  static_assert(BM * kBK % kThreads == 0 && kBK * BN / 4 % kThreads == 0,
                "whole copies per thread");
};

__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

template <class T, typename Tout, bool VEC>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
f32_kernel(const float* __restrict__ a, const float* __restrict__ b, Tout* __restrict__ c,
           float* __restrict__ ws, int M, int K, int N, int splits) {
  extern __shared__ __align__(16) float sg_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM, split = blockIdx.z;
  const int kblocks = (K + kBK - 1) / kBK;
  const int kb0 = (int)((long long)kblocks * split / splits);
  const int n = (int)((long long)kblocks * (split + 1) / splits) - kb0;

  auto load_stage = [&](int slot, int kb) {
    float* sA = sg_smem + slot * T::kStage;
    float* sB = sA + kBK * T::kLdA;
    const int k0 = kb * kBK;
    // A^T: element e of the stage is lane e % 32 of copy unit e / 32, a unit
    // covering 4 rows m x 8 steps k (so a warp's 4-byte stores hit 32 banks).
#pragma unroll
    for (int j = 0; j < T::BM * kBK / T::kThreads; ++j) {
      const int e = tid + j * T::kThreads, u = e / 32, l = e % 32;
      const int m = u / (kBK / 8) * 4 + l / 8, k = u % (kBK / 8) * 8 + l % 8;
      const int gm = m0 + m, gk = k0 + k;
      const bool ok = gm < M && gk < K;
      ftc::cp_async4(sA + k * T::kLdA + m, ok ? a + (long long)gm * K + gk : a, ok ? 4 : 0);
    }
    if constexpr (VEC) {
      // N % 4 == 0: a 16-byte copy that starts inside the matrix ends inside
#pragma unroll
      for (int j = 0; j < kBK * T::BN / 4 / T::kThreads; ++j) {
        const int q = tid + j * T::kThreads, k = q / (T::BN / 4), col = q % (T::BN / 4) * 4;
        const int gk = k0 + k, gn = n0 + col;
        const bool ok = gk < K && gn < N;
        ftc::cp_async16(ftc::smem_addr(sB + k * T::BN + col),
                        ok ? b + (long long)gk * N + gn : b, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kBK * T::BN / T::kThreads; ++j) {
        const int e = tid + j * T::kThreads, k = e / T::BN, col = e % T::BN;
        const int gk = k0 + k, gn = n0 + col;
        const bool ok = gk < K && gn < N;
        ftc::cp_async4(sB + k * T::BN + col, ok ? b + (long long)gk * N + gn : b, ok ? 4 : 0);
      }
    }
  };

  // This lane's first A^T column (m) and B column (n) within the stage; group
  // g along m starts LM * 4 columns after group g - 1, along n LN * 4.
  const int am = warp / T::WN * (T::BM / T::WM) + lane / T::LN * 4;
  const int bn = warp % T::WN * (T::BN / T::WN) + lane % T::LN * 4;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int x = 0; x < T::TM; ++x)
#pragma unroll
    for (int y = 0; y < T::TN; ++y) acc[x][y] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load_stage(s, kb0 + s);
    ftc::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    ftc::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n) load_stage((i + kStages - 1) % kStages, kb0 + i + kStages - 1);
    ftc::cp_async_commit();

    const float* sA = sg_smem + (i % kStages) * T::kStage + am;
    const float* sB = sg_smem + (i % kStages) * T::kStage + kBK * T::kLdA + bn;
    float fa[2][T::TM], fb[2][T::TN];
#pragma unroll
    for (int g = 0; g < T::GM; ++g) lds4(sA + g * T::LM * 4, &fa[0][4 * g]);
#pragma unroll
    for (int g = 0; g < T::GN; ++g) lds4(sB + g * T::LN * 4, &fb[0][4 * g]);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k + 1 < kBK) {  // the next step's fragments, in flight during this step's FMAs
#pragma unroll
        for (int g = 0; g < T::GM; ++g)
          lds4(sA + (k + 1) * T::kLdA + g * T::LM * 4, &fa[(k + 1) & 1][4 * g]);
#pragma unroll
        for (int g = 0; g < T::GN; ++g)
          lds4(sB + (k + 1) * T::BN + g * T::LN * 4, &fb[(k + 1) & 1][4 * g]);
      }
#pragma unroll
      for (int x = 0; x < T::TM; ++x)
#pragma unroll
        for (int y = 0; y < T::TN; ++y) acc[x][y] = fmaf(fa[k & 1][x], fb[k & 1][y], acc[x][y]);
    }
  }
  ftc::cp_async_wait<0>();

#pragma unroll
  for (int x = 0; x < T::TM; ++x) {
    const int row = m0 + am + x / 4 * T::LM * 4 + x % 4;
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < T::GN; ++g) {
      const int col = n0 + bn + g * T::LN * 4;
      if (col >= N) continue;
      if (splits == 1)
        store4<Tout, VEC>(c + (long long)row * N + col, &acc[x][4 * g], N - col);
      else
        store4<float, VEC>(ws + ((long long)split * M + row) * N + col, &acc[x][4 * g], N - col);
    }
  }
}

template <class T, typename Tout>
static int launch(const float* a, const float* b, Tout* c, float* ws, int M, int K, int N,
                  int vec, int splits, int smem_bytes, cudaStream_t s) {
  if (smem_bytes != T::kBytes) return (int)cudaErrorInvalidValue;  // planner drifted
  const long long gy = (M + T::BM - 1) / T::BM;
  if (gy > 65535 || splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies and stores: the planner asks for them only where N and the
  // pointers allow them; refuse a plan that asks wrongly.
  if (vec && (N % 4 || reinterpret_cast<uintptr_t>(b) % 16 || reinterpret_cast<uintptr_t>(c) % 16 ||
              reinterpret_cast<uintptr_t>(ws) % 16))
    return (int)cudaErrorInvalidValue;
  auto kernel = vec ? f32_kernel<T, Tout, true> : f32_kernel<T, Tout, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       T::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + T::BN - 1) / T::BN, (unsigned)gy, splits);
  kernel<<<grid, T::kThreads, T::kBytes, s>>>(a, b, c, ws, M, K, N, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_split_reduce<Tout>(ws, c, (long long)M * N, splits, s);
}

// The tiles kernels/tuning.py:TILED_F32_TILES may pick, with their warp and
// lane layouts.
template <typename Tout>
static int launch_tile(int bm, int bn, const float* a, const float* b, Tout* c, float* ws,
                       int M, int K, int N, int vec, int splits, int smem_bytes,
                       cudaStream_t s) {
  if (bm == 128 && bn == 256)
    return launch<Tile<128, 256, 2, 4, 2, 4, 1>, Tout>(a, b, c, ws, M, K, N, vec, splits,
                                                       smem_bytes, s);
  if (bm == 64 && bn == 128)
    return launch<Tile<64, 128, 2, 2, 2, 2, 4>, Tout>(a, b, c, ws, M, K, N, vec, splits,
                                                      smem_bytes, s);
  if (bm == 16 && bn == 256)
    return launch<Tile<16, 256, 1, 4, 1, 2, 4>, Tout>(a, b, c, ws, M, K, N, vec, splits,
                                                      smem_bytes, s);
  if (bm == 8 && bn == 256)
    return launch<Tile<8, 256, 1, 4, 1, 1, 4>, Tout>(a, b, c, ws, M, K, N, vec, splits,
                                                  smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace sg

// f32 a (M, K), b (K, N); c (M, N) in out_dtype; ws (splits, M, N) f32 when
// splits > 1. vec: 16-byte copies of B and stores of C (N % 4 == 0, b, c and
// ws 16-byte aligned).
extern "C" int falcon_tiled_matmul_f32(int device, const void* a, const void* b, void* c,
                                       void* ws, int out_dtype, int M, int K, int N, int bm,
                                       int bn, int vec, int splits, int smem_bytes,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* w = static_cast<float*>(ws);
  if (out_dtype == FALCON_F32)
    return sg::launch_tile<float>(bm, bn, pa, pb, static_cast<float*>(c), w, M, K, N, vec,
                                  splits, smem_bytes, s);
  if (out_dtype == FALCON_BF16)
    return sg::launch_tile<__nv_bfloat16>(bm, bn, pa, pb, static_cast<__nv_bfloat16*>(c), w, M,
                                          K, N, vec, splits, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The mma.sync route (bf16 that TMA cannot address)
// ---------------------------------------------------------------------------

namespace mm {

constexpr int kBK = 32;      // TILED_MMA_BK: K steps of one ring stage
constexpr int kStages = 4;   // TILED_MMA_STAGES
constexpr int kBN = 128;     // the tile's width: 4 warps of 32 columns
constexpr int kPad = 8;      // TILED_MMA_PAD: bf16 after every staged row (ldmatrix
                             // rows of 80 and 272 bytes hit distinct banks)

// WM warps of 64 rows along m. Shared memory (tuning.tiled_mma_smem): kStages
// ring stages of A [BM][kBK + kPad] and B [kBK][kBN + kPad], bf16, then one
// more stage: the repacked tile of an operand that is staged raw.
template <int WM>
struct Layout {
  static constexpr int BM = 64 * WM;
  static constexpr int kThreads = WM * 4 * 32;
  static constexpr int kLdA = kBK + kPad, kLdB = kBN + kPad;
  static constexpr int kStage = BM * kLdA + kBK * kLdB;  // elements
  static constexpr int kBytes = (kStages + 1) * kStage * 2;
  static constexpr int kMinBlocks = 2;                   // TILED_MMA_MIN_BLOCKS
  static constexpr int kRawA = kLdA * 2 / 16;            // 16-byte chunks of a raw A row
  static constexpr int kRawB = kLdB * 2 / 16;
};

// A raw row: the 16-byte chunks from the one holding element k0 of a row on,
// that row's bytes past its end (`end`) zero-filled. The padded row holds the
// chunks that cover kBK (A) or kBN (B) elements at any 2-byte shift.
__device__ __forceinline__ void copy_raw(uint32_t dst, const __nv_bfloat16* first,
                                         const __nv_bfloat16* end, int chunk, bool row_ok,
                                         const void* any) {
  const uintptr_t at = (reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15)) + 16 * chunk;
  const long long left = (long long)(reinterpret_cast<uintptr_t>(end) - at);
  const int bytes = row_ok ? (int)max(0LL, min(16LL, left)) : 0;
  ftc::cp_async16(dst, bytes ? reinterpret_cast<const void*>(at) : any, bytes);
}

// Two elements of a raw row starting `shift` bytes into it (an even count),
// as a bf16x2 word.
__device__ __forceinline__ uint32_t unshift2(const unsigned char* row, int shift) {
  if (shift & 2) {
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(row + shift - 2);
    const uint32_t hi = *reinterpret_cast<const uint32_t*>(row + shift + 2);
    return __byte_perm(lo, hi, 0x5432);
  }
  return *reinterpret_cast<const uint32_t*>(row + shift);
}

template <int WM, typename Tout>
__global__ void __launch_bounds__(Layout<WM>::kThreads, Layout<WM>::kMinBlocks)
mma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
           Tout* __restrict__ c, float* __restrict__ ws, int M, int K, int N, int vec_a,
           int vec_b, int splits) {
  using L = Layout<WM>;
  extern __shared__ __align__(16) __nv_bfloat16 mm_smem[];
  const uint32_t base = ftc::smem_addr(mm_smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * L::BM, split = blockIdx.z;
  const int kblocks = (K + kBK - 1) / kBK;
  const int kb0 = (int)((long long)kblocks * split / splits);
  const int n = (int)((long long)kblocks * (split + 1) / splits) - kb0;

  // A stage of both operands, all by cp.async: 16-byte copies of an operand
  // that allows them (K, resp. N, a multiple of 8 and a 16-byte-aligned
  // pointer: a copy that starts inside the matrix ends inside); otherwise
  // its raw rows, repacked after they land (repack below).
  auto copy_stage = [&](int slot, int kb) {
    const uint32_t sA = base + slot * L::kStage * 2, sB = sA + L::BM * L::kLdA * 2;
    const int k0 = kb * kBK;
    if (vec_a) {
#pragma unroll
      for (int j = 0; j < L::BM * kBK / 8 / L::kThreads; ++j) {
        const int q = tid + j * L::kThreads, row = q / (kBK / 8), col = q % (kBK / 8) * 8;
        const int gm = m0 + row, gk = k0 + col;
        const bool ok = gm < M && gk < K;
        ftc::cp_async16(sA + (row * L::kLdA + col) * 2, ok ? a + (long long)gm * K + gk : a,
                        ok ? 16 : 0);
      }
    } else {
      for (int q = tid; q < L::BM * L::kRawA; q += L::kThreads) {
        const int row = q / L::kRawA, chunk = q % L::kRawA;
        const __nv_bfloat16* r = a + (long long)(m0 + row) * K;
        copy_raw(sA + row * L::kLdA * 2 + 16 * chunk, r + k0, r + K, chunk, m0 + row < M, a);
      }
    }
    if (vec_b) {
#pragma unroll
      for (int j = 0; j < kBK * kBN / 8 / L::kThreads; ++j) {
        const int q = tid + j * L::kThreads, row = q / (kBN / 8), col = q % (kBN / 8) * 8;
        const int gk = k0 + row, gn = n0 + col;
        const bool ok = gk < K && gn < N;
        ftc::cp_async16(sB + (row * L::kLdB + col) * 2, ok ? b + (long long)gk * N + gn : b,
                        ok ? 16 : 0);
      }
    } else {
      for (int q = tid; q < kBK * L::kRawB; q += L::kThreads) {
        const int row = q / L::kRawB, chunk = q % L::kRawB;
        const __nv_bfloat16* r = b + (long long)(k0 + row) * N;
        copy_raw(sB + row * L::kLdB * 2 + 16 * chunk, r + n0, r + N, chunk, k0 + row < K, b);
      }
    }
  };
  // The raw rows of a landed stage, shifted into the last stage's buffers:
  // a row's data starts (its address % 16) bytes into its raw row (k0 and n0
  // keep that shift: 64 and 256 bytes on). The zero-filled tails are zeros.
  unsigned char* const smem_b = reinterpret_cast<unsigned char*>(mm_smem);
  auto repack = [&](int slot) {
    const unsigned char* rA = smem_b + slot * L::kStage * 2;
    const unsigned char* rB = rA + L::BM * L::kLdA * 2;
    unsigned char* pA = smem_b + kStages * L::kStage * 2;
    unsigned char* pB = pA + L::BM * L::kLdA * 2;
    if (!vec_a) {
#pragma unroll
      for (int j = 0; j < L::BM * kBK / 2 / L::kThreads; ++j) {
        const int q = tid + j * L::kThreads, row = q / (kBK / 2), col = q % (kBK / 2) * 2;
        const int shift = (int)(reinterpret_cast<uintptr_t>(a + (long long)(m0 + row) * K) % 16);
        *reinterpret_cast<uint32_t*>(pA + (row * L::kLdA + col) * 2) =
            unshift2(rA + row * L::kLdA * 2, shift + 2 * col);
      }
    }
    if (!vec_b) {
#pragma unroll
      for (int j = 0; j < kBK * kBN / 2 / L::kThreads; ++j) {
        const int q = tid + j * L::kThreads, row = q / (kBN / 2), col = q % (kBN / 2) * 2;
        const int shift = (int)(reinterpret_cast<uintptr_t>(b + (long long)row * N) % 16);
        *reinterpret_cast<uint32_t*>(pB + (row * L::kLdB + col) * 2) =
            unshift2(rB + row * L::kLdB * 2, shift + 2 * col);
      }
    }
  };

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;  // the warp's tile origin

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) copy_stage(s, kb0 + s);
    ftc::cp_async_commit();
  }
  const uint32_t packed = base + kStages * L::kStage * 2;
  for (int i = 0; i < n; ++i) {
    ftc::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n) copy_stage((i + kStages - 1) % kStages, kb0 + i + kStages - 1);
    ftc::cp_async_commit();
    const uint32_t ring = base + (i % kStages) * L::kStage * 2;
    if (!vec_a || !vec_b) {
      repack(i % kStages);
      __syncthreads();
    }
    const uint32_t sA = vec_a ? ring : packed;
    const uint32_t sB = (vec_b ? ring : packed) + L::BM * L::kLdA * 2;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ftc::ldsm_x4(af[mt],
                     sA + ((wm + mt * 16 + (lane & 15)) * L::kLdA + kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ftc::ldsm_x4_trans(r, sB + ((kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::kLdB +
                                    wn + np * 16 + (lane >> 4) * 8) * 2);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) ftc::mma(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  ftc::cp_async_wait<0>();

  // m16n8 accumulators: c0, c1 at row lane/4, columns 2*(lane%4) and +1; c2,
  // c3 eight rows down.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mt * 16 + lane / 4 + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + (lane % 4) * 2;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        const long long at = (long long)row * N + col;
        if (splits > 1) {
          float* p = ws + (long long)split * M * N + at;
          if (col < N) p[0] = v0;
          if (col + 1 < N) p[1] = v1;
        } else if (N % 2 == 0 && col < N) {
          store2<Tout>(c + at, v0, v1);  // an even N keeps the pair 4- or 8-byte aligned
        } else {
          if (col < N) c[at] = from_f32<Tout>(v0);
          if (col + 1 < N) c[at + 1] = from_f32<Tout>(v1);
        }
      }
    }
}

template <int WM, typename Tout>
static int launch(const void* a, const void* b, Tout* c, float* ws, int M, int K, int N,
                  int vec_a, int vec_b, int splits, int smem_bytes, cudaStream_t s) {
  using L = Layout<WM>;
  if (smem_bytes != L::kBytes) return (int)cudaErrorInvalidValue;  // planner drifted
  const long long gy = (M + L::BM - 1) / L::BM;
  if (gy > 65535 || splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((vec_a && (K % 8 || reinterpret_cast<uintptr_t>(a) % 16)) ||
      (vec_b && (N % 8 || reinterpret_cast<uintptr_t>(b) % 16)))
    return (int)cudaErrorInvalidValue;  // 16-byte copies the operand cannot take
  auto kernel = mma_kernel<WM, Tout>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)gy, splits);
  kernel<<<grid, L::kThreads, L::kBytes, s>>>(static_cast<const __nv_bfloat16*>(a),
                                              static_cast<const __nv_bfloat16*>(b), c, ws, M,
                                              K, N, vec_a, vec_b, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_split_reduce<Tout>(ws, c, (long long)M * N, splits, s);
}

template <typename Tout>
static int launch_tile(int bm, const void* a, const void* b, Tout* c, float* ws, int M, int K,
                       int N, int vec_a, int vec_b, int splits, int smem_bytes,
                       cudaStream_t s) {
  // The tiles kernels/tuning.py:TILED_MMA_TILES may pick.
  if (bm == 128)
    return launch<2, Tout>(a, b, c, ws, M, K, N, vec_a, vec_b, splits, smem_bytes, s);
  if (bm == 64)
    return launch<1, Tout>(a, b, c, ws, M, K, N, vec_a, vec_b, splits, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mm

// bf16 a (M, K), b (K, N); c (M, N) in out_dtype; ws (splits, M, N) f32 when
// splits > 1. vec_a, vec_b: stage that operand by 16-byte copies (refused
// unless its row stride is a multiple of 8 elements and its pointer
// 16-byte aligned); otherwise by its raw rows, repacked in shared memory.
extern "C" int falcon_tiled_matmul_mma(int device, const void* a, const void* b, void* c,
                                       void* ws, int out_dtype, int M, int K, int N, int bm,
                                       int vec_a, int vec_b, int splits, int smem_bytes,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (out_dtype == FALCON_F32)
    return mm::launch_tile<float>(bm, a, b, static_cast<float*>(c), w, M, K, N, vec_a, vec_b,
                                  splits, smem_bytes, s);
  if (out_dtype == FALCON_BF16)
    return mm::launch_tile<__nv_bfloat16>(bm, a, b, static_cast<__nv_bfloat16*>(c), w, M, K, N,
                                          vec_a, vec_b, splits, smem_bytes, s);
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
