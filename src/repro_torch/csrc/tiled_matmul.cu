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
// Design. The Pallas kernel carries its f32 accumulator in VMEM scratch
// across a sequential K grid axis. Hopper blocks run in parallel and in no
// order, so here one block owns a BM x BN output tile and loops over K
// itself, staging a BM x kTBK slice of A and a kTBK x BN slice of B in
// shared memory as f32. 256 threads in a 16 x 16 layout each own a
// (BM/16) x (BN/16) micro-tile held in registers (strided by 16, so the
// shared-memory reads are broadcasts or consecutive words) and sum it with
// f32 FMA on the CUDA cores: no tensor cores, TMA or pipelining yet, so the
// card's FLOPS_x is out of reach; a later change moves the product to
// wgmma. Global loads are 16 bytes a thread where K and N are multiples of
// the vector width (4 f32, 8 bf16) and both operands are 16-byte aligned
// (ALIGNED); otherwise an element-wise path runs. Ragged tile edges are
// masked, so no operand needs padding. Offsets are 64-bit; grid.x runs
// along the longer output dimension (grid.y stops at 65,535). The tile is
// chosen by kernels/tuning.py:plan_tiled_matmul_blocks.
#include "common.cuh"

constexpr int kTThreads = 256;
constexpr int kTBK = 16;  // K depth of one shared-memory stage

// 16 bytes of T from global memory (aligned), widened to f32.
template <typename T> __device__ __forceinline__ void load16(const T* p, float* v);
template <> __device__ __forceinline__ void load16<float>(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p, float* v) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
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
    if (ALIGNED) {
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
  constexpr int VEC = 16 / sizeof(Tin);
  const bool aligned = K % VEC == 0 && N % VEC == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const Tin* pa = static_cast<const Tin*>(a);
  const Tin* pb = static_cast<const Tin*>(b);
  Tout* pc = static_cast<Tout*>(c);
  if (aligned)
    tiled_matmul_kernel<Tin, Tout, BM, BN, true><<<grid, kTThreads, 0, s>>>(pa, pb, pc, M, K, N, m_major);
  else
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
