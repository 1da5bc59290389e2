// Fused GEMM + Group Combine H (paper Alg. 2, stages 3-4) for Hopper.
//
// Replaces the Pallas TPU kernels fused_gemm_combine_h
// (src/repro/kernels/fused_gemm.py:71) and batched_fused_gemm_combine_h
// (:147). For every group g it computes the C parts
//     out[g, i, j] = sum_r W[r, i, j] * (At[g, r] @ Bt[g, r])      (m, n, X, Z)
// with every product H_r = At_r @ Bt_r summed in f32 and never stored.
// Bt has a group stride of 0 when one combined B is shared by the group.
//
// Bound on the H100: bytes at the served shapes, where the kernel is a
// stream over Bt (mlp_up at prefill: 116 operations per byte against the
// card's ~295); operations only at 4096^3-class products.
//
// The entry point picks the kernel by the operands' dtype:
//  - bf16: the tensor-core kernel of csrc/fused_tc.cuh (mma.sync fed by a
//    cp.async ring, H_r in the MMA fragments, Combine H folded from
//    registers, the (r, K) reduction split across blocks where the output
//    tiles alone would leave SMs idle, with a fixed-order second pass).
//  - f32: the SIMT kernel below, unchanged since its first port: TF32 on the
//    tensor cores would not meet f32 accuracy. The Pallas kernel keeps R f32
//    accumulators per output tile; on Hopper that is R*bx*bz*4 bytes, which
//    for s555 (R = 110) fits no useful tile. Combine H is linear, so a block
//    instead finishes H_r for one r over the whole K loop (in registers),
//    adds W[r, i, j] * H_r into the m*n output accumulators it holds in
//    shared memory, and goes on to r + 1, in the Pallas kernel's ascending
//    order, skipping zeros. The product is a shared-memory-tiled FMA loop:
//    256 threads, each owning a (BX/16) x (BZ/16) micro-tile. Ragged tile
//    edges are masked. Its tile is chosen by
//    kernels/tuning.py:plan_fused_gemm_blocks.
#include "fused_tc.cuh"

constexpr int kThreads = 256;
constexpr int kBK = 16;  // K depth of one shared-memory stage

template <int BX, int BZ>
constexpr size_t fused_smem_floats(int mn) {
  return (size_t)mn * BX * BZ + (size_t)kBK * (BX + 1) + (size_t)kBK * BZ;
}

template <typename Tin, typename Tout, int BX, int BZ>
__global__ void __launch_bounds__(kThreads)
fused_gemm_combine_h_kernel(const Tin* __restrict__ at, const Tin* __restrict__ bt,
                            Tout* __restrict__ out, const int* __restrict__ table,
                            int R, int mn, int X, int Y, int Z,
                            long long bt_group_stride) {
  constexpr int TM = BX / 16, TN = BZ / 16;
  extern __shared__ float smem[];
  float* acc = smem;                          // [mn][TM*TN][kThreads]
  float* As = acc + (size_t)mn * BX * BZ;     // [kBK][BX + 1], At tile transposed
  float* Bs = As + kBK * (BX + 1);            // [kBK][BZ]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int x0 = blockIdx.y * BX, z0 = blockIdx.x * BZ;
  const long long g = blockIdx.z;
  for (int e = tid; e < mn * BX * BZ; e += kThreads) acc[e] = 0.f;

  const CoeffTable w(table, R);
  const Tin* at_g = at + g * R * X * Y;
  const Tin* bt_g = bt + g * bt_group_stride;
  for (int r = 0; r < R; ++r) {
    const Tin* a_r = at_g + (long long)r * X * Y;
    const Tin* b_r = bt_g + (long long)r * Y * Z;
    float h[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) h[i][j] = 0.f;

    for (int y0 = 0; y0 < Y; y0 += kBK) {
      for (int e = tid; e < BX * kBK; e += kThreads) {
        const int row = e / kBK, col = e % kBK;
        const int gx = x0 + row, gy = y0 + col;
        As[col * (BX + 1) + row] =
            (gx < X && gy < Y) ? to_f32(a_r[(long long)gx * Y + gy]) : 0.f;
      }
      for (int e = tid; e < kBK * BZ; e += kThreads) {
        const int row = e / BZ, col = e % BZ;
        const int gy = y0 + row, gz = z0 + col;
        Bs[row * BZ + col] =
            (gy < Y && gz < Z) ? to_f32(b_r[(long long)gy * Z + gz]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k * (BX + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k * BZ + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) h[i][j] = fmaf(a[i], b[j], h[i][j]);
      }
      __syncthreads();
    }

    // Combine H for rank r: every thread updates only the accumulator
    // entries it owns, so no barrier is needed here.
    for (int t = w.row_ptr[r]; t < w.row_ptr[r + 1]; ++t) {
      const float c = (float)w.coeff[t];
      float* acc_p = acc + (size_t)w.part[t] * BX * BZ;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc_p[(i * TN + j) * kThreads + tid] += c * h[i][j];
    }
  }

  const long long plane = (long long)X * Z;
  for (int p = 0; p < mn; ++p) {
    Tout* dst = out + (g * mn + p) * plane;
    const float* acc_p = acc + (size_t)p * BX * BZ;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gx = x0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gz = z0 + tx + 16 * j;
        if (gx < X && gz < Z)
          dst[(long long)gx * Z + gz] = from_f32<Tout>(acc_p[(i * TN + j) * kThreads + tid]);
      }
    }
  }
}

template <typename Tin, typename Tout, int BX, int BZ>
static int launch(const void* at, const void* bt, void* out, const int* table, int G,
                  int R, int mn, int X, int Y, int Z, long long bt_group_stride,
                  cudaStream_t s) {
  auto kernel = fused_gemm_combine_h_kernel<Tin, Tout, BX, BZ>;
  const size_t smem = fused_smem_floats<BX, BZ>(mn) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Z + BZ - 1) / BZ, (X + BX - 1) / BX, G);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const Tin*>(at),
                                      static_cast<const Tin*>(bt),
                                      static_cast<Tout*>(out), table, R, mn, X, Y, Z,
                                      bt_group_stride);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
static int launch_tile(int bx, int bz, const void* at, const void* bt, void* out,
                       const int* table, int G, int R, int mn, int X, int Y, int Z,
                       long long bgs, cudaStream_t s) {
  // The tile shapes kernels/tuning.py:FUSED_TILES may pick.
  if (bx == 64 && bz == 64) return launch<Tin, Tout, 64, 64>(at, bt, out, table, G, R, mn, X, Y, Z, bgs, s);
  if (bx == 16 && bz == 64) return launch<Tin, Tout, 16, 64>(at, bt, out, table, G, R, mn, X, Y, Z, bgs, s);
  return (int)cudaErrorInvalidValue;
}

// at (G, R, X, Y), bt (G, R, Y, Z) or shared (R, Y, Z) with bt_group_stride
// 0, out (G, m*n, X, Z); all contiguous. in_dtype is at's and bt's type: bf16
// runs on the tensor cores with tile (bx, bz) and `splits` reduction splits
// (ws: a (splits, G, m*n, X, Z) f32 workspace when splits > 1; vec: Y and Z
// multiples of 8 and both pointers 16-byte aligned; smem_bytes: the
// planner's shared memory for the tile, held to the kernel's layout); f32
// runs the SIMT kernel, whose tiles take splits == 1 (smem_bytes unused).
extern "C" int falcon_fused_gemm_combine_h(int device, const void* at, const void* bt,
                                           void* out, void* ws, const void* table,
                                           int in_dtype, int out_dtype, int G, int R, int mn,
                                           int X, int Y, int Z, long long bt_group_stride,
                                           int vec, int bx, int bz, int splits,
                                           int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  if (in_dtype == FALCON_BF16) {
    const ftc::Args p{at, bt, nullptr, nullptr, out, static_cast<float*>(ws), tab, R, mn,
                      X, Y, Z, ftc::kBK, splits, vec, bt_group_stride, smem_bytes};
    if (out_dtype == FALCON_F32) return ftc::launch_tile<false, float>(bx, bz, p, G, s);
    if (out_dtype == FALCON_BF16) return ftc::launch_tile<false, __nv_bfloat16>(bx, bz, p, G, s);
    return (int)cudaErrorInvalidValue;
  }
  if (in_dtype != FALCON_F32 || splits != 1) return (int)cudaErrorInvalidValue;
  if (out_dtype == FALCON_F32)
    return launch_tile<float, float>(bx, bz, at, bt, out, tab, G, R, mn, X, Y, Z, bt_group_stride, s);
  if (out_dtype == FALCON_BF16)
    return launch_tile<float, __nv_bfloat16>(bx, bz, at, bt, out, tab, G, R, mn, X, Y, Z, bt_group_stride, s);
  return (int)cudaErrorInvalidValue;
}
