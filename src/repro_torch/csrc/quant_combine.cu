// Quantization fused into Group Combine A, and the int8 fused GEMM +
// dequantizing Group Combine H (paper §IV-C), for Hopper.
//
// Replaces the Pallas TPU kernels group_combine_quant and
// fused_gemm_combine_h_quant (src/repro/kernels/quant_combine.py). Both keep
// the reference's order of every f32 operation (ascending terms, products
// and sums rounded one at a time: __fmul_rn / __fadd_rn are never contracted
// into an FMA), so on the same inputs they agree with it bit for bit.
//
// Quant Group Combine A computes, for every rank r, row x and K-block yb of
// `by` columns,
//     acc[y]  = sum_{i,l} c[r, i, l] * in[i*X + x, l*Y + y]     (f32)
//     s       = max(max_y |acc[y]| * f32(1/127), 1e-12)
//     q[r,x,y] = clip(rint(acc[y] / s), -127, 127),  scales[r, x, yb] = s
// Bound on the H100: bytes (the input read once, int8 + one f32 per block
// written). Design: one warp per (row, K-block); it stages its d1*d2
// co-located input segments once in its own slice of shared memory, then for
// each r sums the CSR terms per column, takes the block's absmax with a warp
// shuffle reduction and writes q and the scale. No block-wide barrier.
//
// The fused kernel computes the C parts
//     out[i, j] = sum_r W[r, i, j] * H_r,
//     H_r = sum_yb ((float)(Aq_r[:, yb] @ Bq_r[yb, :]) * a_scale) * b_scale
// with the int8 x int8 products summed exactly in int32 per K-block.
// It replaces src/repro/kernels/quant_combine.py:125. Bound on the H100:
// bytes at both serving M (the int8 B̃q stream); the int8 tensor-core rate
// puts the operations bound lower. Design: the tensor-core kernel shared
// with the bf16 one (csrc/fused_tc.cuh): mma.sync m16n8k32 s8 -> s32 fed by
// a cp.async ring, the Bq tile transposed in shared memory with byte
// permutes (the MMA takes K-contiguous int8 operands only; the offline B̃q
// layout stays (R, Y, Z)); each K-block's int32 sum dequantized in the
// fragments, H_r folded from registers into the m*n accumulators in
// ascending r, skipping zeros; at decode the K-blocks split across blocks,
// with a fixed-order second pass. With one split the f32 order is the
// reference's, so the result agrees with it bit for bit.
#include "fused_tc.cuh"

// ---------------------------------------------------------------------------
// Quant Group Combine A
// ---------------------------------------------------------------------------

template <typename T>
__global__ void group_combine_quant_kernel(const T* __restrict__ in, int8_t* __restrict__ q,
                                           float* __restrict__ scales,
                                           const int* __restrict__ table, int R, int d1,
                                           int d2, int X, int Y, int by) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nparts = d1 * d2;
  float* parts = smem + (size_t)warp * (nparts + 1) * by;  // [nparts][by]
  float* acc = parts + (size_t)nparts * by;                // [by]
  const int x = blockIdx.y * warps + warp;
  if (x >= X) return;  // whole warps only; nothing below syncs the block
  const int yb = blockIdx.x, y0 = yb * by, Yb = Y / by;
  const long long ld = (long long)d2 * Y;  // row stride of the input
  for (int i = 0; i < d1; ++i)
    for (int l = 0; l < d2; ++l) {
      const T* src = in + (long long)(i * X + x) * ld + (long long)l * Y + y0;
      float* dst = parts + (i * d2 + l) * by;
      for (int j = lane; j < by; j += 32) dst[j] = to_f32(src[j]);
    }
  const CoeffTable c(table, R);
  const long long plane = (long long)X * Y;
  for (int r = 0; r < R; ++r) {
    float amax = 0.f;
    for (int j = lane; j < by; j += 32) {
      float a = 0.f;
      for (int t = c.row_ptr[r]; t < c.row_ptr[r + 1]; ++t)
        a = __fadd_rn(a, __fmul_rn((float)c.coeff[t], parts[c.part[t] * by + j]));
      acc[j] = a;  // read back below by this lane only
      amax = fmaxf(amax, fabsf(a));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    // amax * f32(1/127), not amax / 127: the reference's XLA computes the
    // division by a constant so (kernels/ref.py:_quantize).
    const float s = fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-12f);
    int8_t* qr = q + r * plane + (long long)x * Y + y0;
    for (int j = lane; j < by; j += 32) {
      const float v = rintf(__fdiv_rn(acc[j], s));  // round half to even
      qr[j] = (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
    }
    if (lane == 0) scales[((long long)r * X + x) * Yb + yb] = s;
  }
}

// in (d1*X, d2*Y) -> q (R, X, Y) int8, scales (R, X, Y/by) f32; all
// contiguous. `warps` rows share a block (kernels/tuning.py).
extern "C" int falcon_group_combine_quant(int device, const void* in, void* q, void* scales,
                                          const void* table, int dtype, int R, int d1, int d2,
                                          int X, int Y, int by, int warps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (by <= 0 || Y % by != 0 || warps <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(Y / by, (X + warps - 1) / warps);
  const size_t smem = (size_t)warps * (d1 * d2 + 1) * by * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  if (dtype == FALCON_F32) {
    auto kernel = group_combine_quant_kernel<float>;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    kernel<<<grid, warps * 32, smem, s>>>(static_cast<const float*>(in), qo, so, tab, R, d1,
                                          d2, X, Y, by);
  } else if (dtype == FALCON_BF16) {
    auto kernel = group_combine_quant_kernel<__nv_bfloat16>;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    kernel<<<grid, warps * 32, smem, s>>>(static_cast<const __nv_bfloat16*>(in), qo, so, tab,
                                          R, d1, d2, X, Y, by);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Fused int8 GEMM + dequantizing Combine H: the tensor-core kernel of
// csrc/fused_tc.cuh with QUANT = true.
// ---------------------------------------------------------------------------

// aq (R, X, Y) int8, as (R, X, Y/by) f32, bq (R, Y, Z) int8, bs (R, Y/by, Z)
// f32 -> out (m*n, X, Z) in out_dtype; all contiguous. `vec` promises Y, Z
// and by multiples of 16 and 16-byte-aligned int8 operands (cp.async
// copies); `splits` > 1 cuts the K-blocks into that many ranges, with ws a
// (splits, m*n, X, Z) f32 workspace; smem_bytes is the planner's shared
// memory for the tile, held to the kernel's layout.
extern "C" int falcon_fused_gemm_quant(int device, const void* aq, const void* as,
                                       const void* bq, const void* bs, void* out, void* ws,
                                       const void* table, int out_dtype, int R, int mn, int X,
                                       int Y, int Z, int by, int vec, int bx, int bz,
                                       int splits, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (by <= 0 || Y % by != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ftc::Args p{aq, bq, static_cast<const float*>(as), static_cast<const float*>(bs), out,
                    static_cast<float*>(ws), static_cast<const int*>(table), R, mn, X, Y, Z,
                    by, splits, vec, 0, smem_bytes};
  if (out_dtype == FALCON_F32) return ftc::launch_tile<true, float>(bx, bz, p, 1, s);
  if (out_dtype == FALCON_BF16) return ftc::launch_tile<true, __nv_bfloat16>(bx, bz, p, 1, s);
  return (int)cudaErrorInvalidValue;
}
