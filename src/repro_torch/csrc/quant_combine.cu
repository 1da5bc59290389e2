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
// written), ~2 flops per term against 1-3 bytes. So it is a stream of
// 16-byte accesses, as Group Combine (csrc/group_combine.cu) is:
//  - The scheme's CSR coefficient table is staged in shared memory once per
//    block, behind the kernel's one barrier; a thread's first loads are
//    issued before it, so a small call pays one memory latency, not two.
//  - A K-block is covered by `lanes` lanes (by/VEC rounded up to a power of
//    two, at most 32), each owning VEC consecutive columns (8 bf16 or 4
//    f32: 16 bytes) of one row. A lane loads its d1*d2 co-located vectors,
//    four 16-byte loads in flight at a time, and parks them in its own
//    shared-memory slots (a runtime-indexed register array would spill).
//  - For each rank it sums its VEC columns over the rank's terms in f32,
//    takes their absmax, and a __shfl_xor_sync butterfly inside the lane
//    group gives the K-block's; one lane writes the scale, every lane its
//    VEC q values as one 8- or 4-byte store. No shared memory holds a sum.
//  - An IEEE division per value (each with its own branch) would cost most
//    of a rank, so the quotient acc / s is one product with rcp.approx(s),
//    rounded by adding 1.5 * 2^23, and checked to be far
//    enough from a rounding boundary that the true quotient rounds the same
//    way; the rare value that is not (about 1 in 8,000) takes __fdiv_rn
//    (quantize, below). So q stays bit-equal to the reference.
//  - A block covers several (row, K-block) units; where the grid is too
//    small to fill the card (decode rows), the ranks are split across
//    blocks, each re-reading its inputs from L2, so no thread walks all R
//    ranks in series.
//  - VEC = 1 is the same kernel with 2- or 4-byte accesses, for a `by` that
//    is no multiple of the vector width or an input that is not 16-byte
//    aligned. Route, block, lanes and split: kernels/tuning.py
//    (plan_quant_combine), decided before the launch.
// Even so, at a 4096 x 4096 input its arithmetic and its memory traffic add
// up rather than overlap, and it runs under half of the bytes bound
// (PERF.md).
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

constexpr int kQcThreads = 256;  // most threads a block holds (tuning.QUANT_COMBINE_THREADS)

// The low bytes of four words, v[0] lowest, as one 32-bit word.
__device__ __forceinline__ unsigned pack_bytes(const int* v) {
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
}

// The low bytes of v[0..VEC) as one store: 8 bytes on the bf16 vector
// route, 4 on the f32 one, 1 on the scalar route.
template <int VEC>
__device__ __forceinline__ void store_bytes(int8_t* p, const int* v);
template <>
__device__ __forceinline__ void store_bytes<8>(int8_t* p, const int* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bytes(v), pack_bytes(v + 4));
}
template <>
__device__ __forceinline__ void store_bytes<4>(int8_t* p, const int* v) {
  *reinterpret_cast<unsigned*>(p) = pack_bytes(v);
}
template <>
__device__ __forceinline__ void store_bytes<1>(int8_t* p, const int* v) {
  *p = (int8_t)v[0];
}

// 1.5 * 2^23: for |v| < 2^22, RN(v + kRound) holds rint(v) (half to even)
// in its low mantissa bits, and its low byte is rint(v)'s two's-complement
// low byte.
constexpr float kRound = 12582912.f;

// q = clip(rint(acc / s), -127, 127) for VEC sums sharing one scale, with
// acc / s the correctly rounded quotient, as the reference computes it;
// returned as words whose low byte is q. The clip never binds: s >=
// amax / 127 up to one rounding, so |acc / s| <= 127 * (1 + 2^-22) < 127.5.
// y = 1/s from rcp.approx (within one ulp; s is a normal number) gives
// p = RN(acc * y) within 1.5 * 2^-16 of acc / s, and RN(acc / s) is within
// 2^-17 of it, so the two lie within 2^-15 of each other: where p is further
// than 2^-14 from every half-integer, RN(acc / s) lies on the same side of
// the same one and rounds to the same integer. Only where some p is that
// close (about 1 value in 8,000) are the VEC quotients taken with __fdiv_rn.
template <int VEC>
__device__ __forceinline__ void quantize(const float* acc, float s, int* qw) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(s));
  bool near = false;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float p = __fmul_rn(acc[e], y);
    const float t = __fadd_rn(p, kRound);
    const float n = __fsub_rn(t, kRound);  // rint(p), exact
    near |= fabsf(__fsub_rn(p, n)) >= 0.5f - 0x1p-14f;  // p - n is exact, |p - n| <= 0.5
    qw[e] = __float_as_int(t);
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qw[e] = __float_as_int(__fadd_rn(rintf(__fdiv_rn(acc[e], s)), kRound));
  }
}

// max_e |v[e]| as a tree (exact in any order).
template <int VEC>
__device__ __forceinline__ float absmax(const float* v) {
  float m[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) m[e] = fabsf(v[e]);
#pragma unroll
  for (int h = VEC / 2; h > 0; h /= 2)
#pragma unroll
    for (int e = 0; e < h; ++e) m[e] = fmaxf(m[e], m[e + h]);
  return m[0];
}

// Shared memory of one block (kernels/tuning.py:quant_combine_smem): each
// thread's d1*d2*per_lane slots, rounded up to 16 bytes, then the
// coefficient table.
template <typename T, int VEC>
static size_t quant_combine_smem(int nparts, int per_lane, int threads, int table_len) {
  const size_t slots =
      (size_t)nparts * per_lane * threads * sizeof(typename Pack<T, VEC>::Raw);
  return (slots + 15) / 16 * 16 + (size_t)table_len * 4;
}

// A block holds threads / lanes (row, K-block) units, consecutive in
// row-major order; blockIdx.z is the rank group. Lane j of a unit owns the
// VEC columns j*VEC + w*lanes*VEC of its K-block, w < per_lane; lanes past
// by/VEC are padding and add 0 to the max. MULTI: per_lane > 1 (a K-block
// wider than 32 lanes' columns); otherwise the w loops vanish.
template <typename T, int VEC, bool MULTI>
__global__ void __launch_bounds__(kQcThreads)
group_combine_quant_kernel(const T* __restrict__ in, int8_t* __restrict__ q,
                           float* __restrict__ scales, const int* __restrict__ table,
                           int table_len, int R, int d1, int d2, int X, int Y, int by,
                           int lanes, int per_lane_arg) {
  using P = Pack<T, VEC>;
  using Raw = typename P::Raw;
  extern __shared__ __align__(16) unsigned char qc_smem[];
  const int per_lane = MULTI ? per_lane_arg : 1;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int np = d1 * d2;
  Raw* slots = reinterpret_cast<Raw*>(qc_smem);  // [np][per_lane][nthreads]
  int* tab = reinterpret_cast<int*>(
      qc_smem + ((size_t)np * per_lane * nthreads * sizeof(Raw) + 15) / 16 * 16);

  const unsigned Yb = Y / by, nv = by / VEC, lane = tid % lanes;
  const unsigned unit = blockIdx.x * (unsigned)(nthreads / lanes) + tid / lanes;
  // Threads past the last unit stay: they stage the table and join the shuffles.
  const bool active = unit < (unsigned)X * Yb;  // < 2^31 (the launcher checks)
  const int x = active ? unit / Yb : 0, yb = active ? unit % Yb : 0;
  const long long ld = (long long)d2 * Y;  // row stride of the input
  const long long col = (long long)yb * by + lane * VEC;
  const T* src = in + (long long)x * ld + col;
  auto valid = [&](int w) { return active && lane + w * lanes < nv; };  // falls with w
  // Part p = i*d2 + l of the unit sits i*X rows and l*Y columns from part 0.
  int pi = 0, pl = 0;  // the next part to load
  auto next_part = [&]() {
    const long long off = (long long)pi * X * ld + (long long)pl * Y;
    if (++pl == d2) pl = 0, ++pi;
    return off;
  };
  // Up to four of the unit's co-located vectors w, the next parts, into v.
  auto load4 = [&](Raw* v, int p0, int w) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p0 + j < np) v[j] = P::load(src + next_part() + w * lanes * VEC);
  };
  // The first loads are in flight while the table is staged.
  Raw v[4];
  if (valid(0)) load4(v, 0, 0);
  for (int i = tid; i < table_len; i += nthreads) tab[i] = table[i];
  __syncthreads();

  // Park the vectors in this thread's own slots: no other thread reads them.
  Raw* mine = slots + tid;
  for (int w = 0; w < per_lane && valid(w); ++w) {
    if (w > 0) pi = pl = 0;
    for (int p0 = 0; p0 < np; p0 += 4) {
      if (w > 0 || p0 > 0) load4(v, p0, w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < np) mine[((p0 + j) * per_lane + w) * nthreads] = v[j];
    }
  }

  const CoeffTable c(tab, R);
  const int stride = per_lane * nthreads;  // between a thread's slots of two parts
  // Rank r's f32 sums of vector w: the terms in the table's order, each
  // product and sum rounded on its own (never contracted into an FMA).
  auto sum_rank = [&](float* acc, int r, int w) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    const int t1 = c.row_ptr[r + 1];
    for (int t = c.row_ptr[r]; t < t1; ++t) {
      float u[VEC];
      P::unpack(mine[c.part[t] * stride + w * nthreads], u);
      const float cf = (float)c.coeff[t];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(cf, u[e]));
    }
  };
  const int r0 = (int)((long long)R * blockIdx.z / gridDim.z);
  const int r1 = (int)((long long)R * (blockIdx.z + 1) / gridDim.z);
  const long long plane = (long long)X * Y;
  int8_t* qx = q + (long long)x * Y + col;
  float* sx = scales + (long long)x * Yb + yb;
  for (int r = r0; r < r1; ++r) {
    float acc[VEC];
    float amax = 0.f;
    for (int w = 0; w < per_lane && valid(w); ++w) {
      sum_rank(acc, r, w);
      amax = fmaxf(amax, absmax<VEC>(acc));
    }
    // The K-block's max over its lanes (exact in any order): a butterfly
    // inside each aligned group of `lanes` lanes; every lane of the warp
    // takes part.
    for (int o = lanes / 2; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    // amax * f32(1/127), not amax / 127: the reference's XLA computes the
    // division by a constant so (kernels/ref.py:_quantize).
    const float s = fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-12f);
    for (int w = 0; w < per_lane && valid(w); ++w) {
      if (MULTI) sum_rank(acc, r, w);  // the same operations: the same sums
      int qw[VEC];
      quantize<VEC>(acc, s, qw);
      store_bytes<VEC>(qx + r * plane + w * lanes * VEC, qw);
    }
    if (active && lane == 0) sx[(long long)r * X * Yb] = s;
  }
}

template <typename T, int VEC, bool MULTI>
static int launch_quant(const void* in, void* q, void* scales, const int* table,
                        int table_len, int R, int d1, int d2, int X, int Y, int per_lane,
                        int by, int lanes, int threads, int splits, int smem_bytes,
                        cudaStream_t s) {
  const size_t smem = quant_combine_smem<T, VEC>(d1 * d2, per_lane, threads, table_len);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;  // planner drifted
  auto kernel = group_combine_quant_kernel<T, VEC, MULTI>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long units = (long long)X * (Y / by), per_block = threads / lanes;
  const long long gx = (units + per_block - 1) / per_block;
  if (gx < 1 || units + per_block >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)gx, 1, splits), threads, smem, s>>>(
      static_cast<const T*>(in), static_cast<int8_t*>(q), static_cast<float*>(scales), table,
      table_len, R, d1, d2, X, Y, by, lanes, per_lane);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_quant(const void* in, void* q, void* scales, const int* table,
                        int table_len, int R, int d1, int d2, int X, int Y, int by, int lanes,
                        int threads, int splits, int smem_bytes, cudaStream_t s) {
  if (by <= 0 || Y % by || by % VEC || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      threads < 32 || threads > kQcThreads || threads % 32 || splits < 1 || splits > R ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (VEC > 1 && (reinterpret_cast<uintptr_t>(in) % 16 || reinterpret_cast<uintptr_t>(q) % 16))
    return (int)cudaErrorInvalidValue;  // 16-byte loads and whole-vector stores need both
  const int per_lane = (by / VEC + lanes - 1) / lanes;
  return per_lane > 1 ? launch_quant<T, VEC, true>(in, q, scales, table, table_len, R, d1, d2,
                                                   X, Y, per_lane, by, lanes, threads, splits,
                                                   smem_bytes, s)
                      : launch_quant<T, VEC, false>(in, q, scales, table, table_len, R, d1,
                                                    d2, X, Y, 1, by, lanes, threads, splits,
                                                    smem_bytes, s);
}

// in (d1*X, d2*Y) -> q (R, X, Y) int8, scales (R, X, Y/by) f32; all
// contiguous; table (table_len ints) as CoeffTable. `vec` is the route: 16
// bytes of elements (16-byte-aligned in and q, by a multiple of it) or 1.
// Blocks of `threads` threads, `lanes` per K-block, the ranks cut into
// `splits` groups; smem_bytes is the planner's (tuning.plan_quant_combine),
// held to the kernel's layout.
extern "C" int falcon_group_combine_quant(int device, const void* in, void* q, void* scales,
                                          const void* table, int table_len, int dtype, int R,
                                          int d1, int d2, int X, int Y, int by, int vec,
                                          int lanes, int threads, int splits, int smem_bytes,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  if (dtype == FALCON_F32 && vec == 4)
    return launch_quant<float, 4>(in, q, scales, tab, table_len, R, d1, d2, X, Y, by, lanes,
                                  threads, splits, smem_bytes, s);
  if (dtype == FALCON_F32 && vec == 1)
    return launch_quant<float, 1>(in, q, scales, tab, table_len, R, d1, d2, X, Y, by, lanes,
                                  threads, splits, smem_bytes, s);
  if (dtype == FALCON_BF16 && vec == 8)
    return launch_quant<__nv_bfloat16, 8>(in, q, scales, tab, table_len, R, d1, d2, X, Y, by,
                                          lanes, threads, splits, smem_bytes, s);
  if (dtype == FALCON_BF16 && vec == 1)
    return launch_quant<__nv_bfloat16, 1>(in, q, scales, tab, table_len, R, d1, d2, X, Y, by,
                                          lanes, threads, splits, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
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
