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
// Bound on the H100: bytes at both serving M (the int8 B̃q stream); the int8
// tensor-core rate puts the operations bound lower. Design: slice 1's
// (csrc/fused_gemm.cu): a block finishes H_r over the whole K loop in
// registers, dequantizing at the end of every K-block, then folds
// W[r, i, j] * H_r into m*n accumulator tiles in shared memory in ascending
// r, skipping zeros. The product is __dp4a on int8 tiles staged in shared
// memory with four K values packed per word; ragged edges are masked.
#include "common.cuh"

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
// Fused int8 GEMM + dequantizing Combine H
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kQBK = 64;            // K depth of one int8 shared-memory stage
constexpr int kQW = kQBK / 4;       // packed words per row of a stage

// Four rows of a column quad -> four words, each holding one column's four
// K values (byte b = row b): a 4 x 4 byte transpose.
__device__ __forceinline__ void transpose4(const int w[4], int out[4]) {
  const int t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const int t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// Four consecutive int8 values p[0..3] as one word, each masked by its own
// bound (ALIGNED: all four valid or none, and p 4-byte aligned).
template <bool ALIGNED>
__device__ __forceinline__ int load4(const int8_t* p, int valid) {
  if (ALIGNED) return valid >= 4 ? *reinterpret_cast<const int*>(p) : 0;
  int w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < valid) w |= (int)(uint8_t)p[b] << (8 * b);
  return w;
}

template <typename Tout, int BX, int BZ, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
fused_gemm_quant_kernel(const int8_t* __restrict__ aq, const float* __restrict__ as,
                        const int8_t* __restrict__ bq, const float* __restrict__ bs,
                        Tout* __restrict__ out, const int* __restrict__ table, int R, int mn,
                        int X, int Y, int Z, int by) {
  constexpr int TM = BX / 16, TN = BZ / 16;
  extern __shared__ float smem[];
  float* acc = smem;                                   // [mn][TM*TN][kThreads]
  int* As = reinterpret_cast<int*>(acc + (size_t)mn * BX * BZ);  // [BX][kQW]
  int* Bs = As + BX * kQW;                             // [kQW][BZ]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int x0 = blockIdx.y * BX, z0 = blockIdx.x * BZ;
  for (int e = tid; e < mn * BX * BZ; e += kThreads) acc[e] = 0.f;

  const CoeffTable w(table, R);
  const int Yb = Y / by;
  for (int r = 0; r < R; ++r) {
    const int8_t* a_r = aq + (long long)r * X * Y;
    const int8_t* b_r = bq + (long long)r * Y * Z;
    const float* as_r = as + (long long)r * X * Yb;
    const float* bs_r = bs + (long long)r * Yb * Z;
    float h[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) h[i][j] = 0.f;

    for (int yb = 0; yb < Yb; ++yb) {
      const int yend = (yb + 1) * by;
      int p[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) p[i][j] = 0;

      for (int y0 = yb * by; y0 < yend; y0 += kQBK) {
        for (int e = tid; e < BX * kQW; e += kThreads) {
          const int row = e / kQW, kw = e % kQW;
          const int gx = x0 + row, gy = y0 + 4 * kw;
          As[e] = gx < X ? load4<ALIGNED>(a_r + (long long)gx * Y + gy, yend - gy) : 0;
        }
        for (int e = tid; e < kQW * (BZ / 4); e += kThreads) {
          const int kw = e / (BZ / 4), cq = e % (BZ / 4);
          const int gz = z0 + 4 * cq, gy = y0 + 4 * kw;
          int rows[4], cols[4];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            rows[b] = gy + b < yend ? load4<ALIGNED>(b_r + (long long)(gy + b) * Z + gz, Z - gz)
                                    : 0;
          transpose4(rows, cols);
          *reinterpret_cast<int4*>(&Bs[kw * BZ + 4 * cq]) =
              make_int4(cols[0], cols[1], cols[2], cols[3]);
        }
        __syncthreads();
#pragma unroll
        for (int kw = 0; kw < kQW; ++kw) {
          int a[TM], b[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * kQW + kw];
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = Bs[kw * BZ + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) p[i][j] = __dp4a(a[i], b[j], p[i][j]);
        }
        __syncthreads();
      }

      // Dequantize the K-block: (float(int sum) * a_scale) * b_scale.
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gx = x0 + ty + 16 * i;
        const float sa = gx < X ? as_r[(long long)gx * Yb + yb] : 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int gz = z0 + tx + 16 * j;
          const float sb = gz < Z ? bs_r[(long long)yb * Z + gz] : 0.f;
          h[i][j] = __fadd_rn(h[i][j], __fmul_rn(__fmul_rn(__int2float_rn(p[i][j]), sa), sb));
        }
      }
    }

    // Combine H for rank r into the accumulators this thread owns.
    for (int t = w.row_ptr[r]; t < w.row_ptr[r + 1]; ++t) {
      const float c = (float)w.coeff[t];
      float* acc_p = acc + (size_t)w.part[t] * BX * BZ;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float* a = &acc_p[(i * TN + j) * kThreads + tid];
          *a = __fadd_rn(*a, __fmul_rn(c, h[i][j]));
        }
    }
  }

  const long long plane = (long long)X * Z;
  for (int pi = 0; pi < mn; ++pi) {
    Tout* dst = out + pi * plane;
    const float* acc_p = acc + (size_t)pi * BX * BZ;
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

template <typename Tout, int BX, int BZ, bool ALIGNED>
static int launch_quant(const void* aq, const void* as, const void* bq, const void* bs,
                        void* out, const int* table, int R, int mn, int X, int Y, int Z,
                        int by, cudaStream_t s) {
  auto kernel = fused_gemm_quant_kernel<Tout, BX, BZ, ALIGNED>;
  const size_t smem = (size_t)mn * BX * BZ * sizeof(float) + (size_t)(BX + BZ) * kQBK;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Z + BZ - 1) / BZ, (X + BX - 1) / BX);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int8_t*>(aq), static_cast<const float*>(as),
      static_cast<const int8_t*>(bq), static_cast<const float*>(bs), static_cast<Tout*>(out),
      table, R, mn, X, Y, Z, by);
  return (int)cudaGetLastError();
}

template <typename Tout, bool ALIGNED>
static int launch_quant_tile(int bx, int bz, const void* aq, const void* as, const void* bq,
                             const void* bs, void* out, const int* table, int R, int mn, int X,
                             int Y, int Z, int by, cudaStream_t s) {
  // The tile shapes kernels/tuning.py:FUSED_TILES may pick.
  if (bx == 64 && bz == 64)
    return launch_quant<Tout, 64, 64, ALIGNED>(aq, as, bq, bs, out, table, R, mn, X, Y, Z, by, s);
  if (bx == 16 && bz == 64)
    return launch_quant<Tout, 16, 64, ALIGNED>(aq, as, bq, bs, out, table, R, mn, X, Y, Z, by, s);
  return (int)cudaErrorInvalidValue;
}

template <typename Tout>
static int launch_quant_aligned(int aligned, int bx, int bz, const void* aq, const void* as,
                                const void* bq, const void* bs, void* out, const int* table,
                                int R, int mn, int X, int Y, int Z, int by, cudaStream_t s) {
  if (aligned)
    return launch_quant_tile<Tout, true>(bx, bz, aq, as, bq, bs, out, table, R, mn, X, Y, Z, by, s);
  return launch_quant_tile<Tout, false>(bx, bz, aq, as, bq, bs, out, table, R, mn, X, Y, Z, by, s);
}

// aq (R, X, Y) int8, as (R, X, Y/by) f32, bq (R, Y, Z) int8, bs (R, Y/by, Z)
// f32 -> out (m*n, X, Z) in out_dtype; all contiguous. `aligned` promises
// Y, Z and by multiples of 4 and 4-byte-aligned int8 operands (word loads).
extern "C" int falcon_fused_gemm_quant(int device, const void* aq, const void* as,
                                       const void* bq, const void* bs, void* out,
                                       const void* table, int out_dtype, int R, int mn, int X,
                                       int Y, int Z, int by, int aligned, int bx, int bz,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (by <= 0 || Y % by != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  if (out_dtype == FALCON_F32)
    return launch_quant_aligned<float>(aligned, bx, bz, aq, as, bq, bs, out, tab, R, mn, X, Y,
                                       Z, by, s);
  if (out_dtype == FALCON_BF16)
    return launch_quant_aligned<__nv_bfloat16>(aligned, bx, bz, aq, as, bq, bs, out, tab, R,
                                               mn, X, Y, Z, by, s);
  return (int)cudaErrorInvalidValue;
}
