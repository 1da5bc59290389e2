// Fused GEMM + Group Combine H (paper Alg. 2, stages 3-4) for Hopper.
//
// Replaces the Pallas TPU kernels fused_gemm_combine_h
// (src/repro/kernels/fused_gemm.py:71) and batched_fused_gemm_combine_h
// (:147). For every group g it computes the C parts
//     out[g, i, j] = sum_r W[r, i, j] * (At[g, r] @ Bt[g, r])      (m, n, X, Z)
// with every product H_r = At_r @ Bt_r summed in f32 and never stored.
// Bt has a group stride of 0 when one combined B is shared by the group.
//
// The entry point picks the kernel by the operands' dtype:
//  - bf16: the tensor-core kernel of csrc/fused_tc.cuh (mma.sync fed by a
//    cp.async ring, H_r in the MMA fragments, Combine H folded from
//    registers, the (r, K) reduction split across blocks where the output
//    tiles alone would leave SMs idle, with a fixed-order second pass).
//  - f32: the SIMT kernels below (namespace f32). Their products are FP32
//    FMAs: TF32 on the tensor cores would not meet f32 accuracy.
//
// The f32 kernels on the H100. At their costliest shape (mamba2's SSD
// scores: 1,024 groups x 7 products of 128x64 . 64x128) the bytes bound and
// the FP32 operations bound are equal (0.220 ms of traffic at 3.35 TB/s,
// 0.224 ms of FMAs at 67 TFLOP/s), the SSD shapes reduce over short K (8,
// 64 or 128) with narrow Z (32), and strassen's m*n = 4 output parts must
// stay on chip beside H_r. So the design streams and computes at once, and
// spends registers on operand reuse:
//  - One flat sequence of (rank, K-stage) steps per block, fed by a
//    kStages-deep ring of cp.async copies (16 bytes where the row stride and
//    the pointer allow it, else 4-byte copies, zero-filled at the ragged
//    edges): rank r+1's first tiles arrive while rank r's last product and
//    its Combine H run, so the pipe never drains at a rank boundary.
//  - m*n <= kAccRegs at the 8-row tiles (64 x 64, 128 x 32 for Z = 32): the
//    pair kernel. A pair of lanes shares an 8 x 8 block of H_r, each lane
//    summing every other pair of K steps, so a lane does one FMA per byte it
//    reads from shared memory (an 8 x 4 lane: 0.67) while its 64 H values
//    and its 4 x 32 output accumulators all stay in registers (no spills;
//    the ptxas line of chip_smoke.py holds it). Stages are 32 K steps deep.
//  - Otherwise the one-lane kernel: each lane owns tm x kTN = 4 of H_r (tm =
//    8, 4 or 2 by tile) and reads its At rows along K and its Bt rows as
//    16-byte loads; its accumulators in registers for m*n <= kAccRegs (tm
//    4 and 2), else in shared memory, each lane its own entries (no
//    barrier), which is what lets every scheme up to s555 keep a tile (32 x
//    64 and 64 x 32 at tm = 4). 8 x 64 at tm = 2 takes decode rows. Stages
//    are 16 K steps deep.
//  - Stages are 8 deep where Y <= 8 (hymba's K = 8 leaves). Combine H folds
//    H_r into the accumulators at the end of each rank, in the Pallas
//    kernel's ascending r, skipping zero coefficients (the CSR table; the
//    pair kernel reads it as a dense copy of W in shared memory), one FP32
//    FMA a term. Where the tiles alone leave SMs idle the (r, K)
//    sequence is split across blocks into an f32 workspace and summed in
//    fixed order (split_reduce_kernel, common.cuh), as the bf16 kernel does.
// Tile, kernel, stage depth and split are planned by
// kernels/tuning.py:plan_fused_f32; the launcher holds the planner's shared
// memory to its own layout.
#include "fused_tc.cuh"

namespace f32 {

constexpr int kTN = 4;        // F32_TN: columns of a thread's micro-tile
constexpr int kStages = 4;    // F32_STAGES: depth of the cp.async ring
constexpr int kPadA = 4;      // F32_PAD: floats after every staged At row
constexpr int kPadB = 8;      // F32_PAD_B: floats after every staged Bt row (pair kernel)
constexpr int kAccRegs = 4;   // F32_ACC_REGS: m*n up to this in registers

struct Args {
  const float* a;        // At (G, R, X, Y)
  const float* b;        // Bt (G, R, Y, Z), or shared (R, Y, Z) with stride 0
  void* out;             // (G, mn, X, Z) f32 or bf16, when splits == 1
  float* ws;             // (splits, G, mn, X, Z) f32, when splits > 1
  const int* table;      // W as a CoeffTable
  int R, mn, X, Y, Z;
  int splits;
  int out_bf16;
  int vec_a, vec_b;      // 16-byte copies of At (Y % 4 == 0, aligned), of Bt (Z % 4 == 0)
  long long b_group_stride;  // elements; 0 when Bt is shared
  int smem_bytes;        // the planner's (tuning.py:fused_f32_smem), checked at launch
};

// Shared memory of one block (kernels/tuning.py:fused_f32_smem), in floats
// but for bytes().
template <int BX, int BZ, int TM, int BK>
struct Tile {
  static constexpr int kNX = BX / TM, kNZ = BZ / kTN;  // threads along x, z
  static constexpr int kThreads = kNX * kNZ;
  static constexpr int kRowA = BK + kPadA;             // At tile [BX][kRowA]
  static constexpr int kStageA = BX * kRowA;
  static constexpr int kStageB = BK * BZ;              // Bt tile [BK][BZ]
  static constexpr int kRing = kStages * (kStageA + kStageB);
  static size_t bytes(int mn, bool acc_regs) {
    return 4 * ((size_t)kRing + (acc_regs ? 0 : (size_t)mn * BX * BZ));
  }
  template <typename A>
  static dim3 grid(const A& p, int G) {  // a block per tile and split
    return dim3((p.Z + BZ - 1) / BZ, (p.X + BX - 1) / BX, G * p.splits);
  }
};

// h[o..o+3] += a * b, one FMA each (o a compile-time offset once unrolled)
template <int E>
__device__ __forceinline__ void fma4(float (&h)[E], int o, float a, const float4& b) {
  h[o] = fmaf(a, b.x, h[o]);
  h[o + 1] = fmaf(a, b.y, h[o + 1]);
  h[o + 2] = fmaf(a, b.z, h[o + 2]);
  h[o + 3] = fmaf(a, b.w, h[o + 3]);
}

// kTN consecutive values of one output row from v, the first n of them in
// range; one 16-byte (f32) or 8-byte (bf16) store where the row allows it.
template <typename T>
__device__ __forceinline__ void store_row(T* dst, const float* v, int n, bool vec);
template <>
__device__ __forceinline__ void store_row<float>(float* dst, const float* v, int n, bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < n && j < 4; ++j) dst[j] = v[j];
  }
}
template <>
__device__ __forceinline__ void store_row<__nv_bfloat16>(__nv_bfloat16* dst, const float* v,
                                                         int n, bool vec) {
  if (vec && n >= 4) {
    uint2 r;
    *reinterpret_cast<__nv_bfloat162*>(&r.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&r.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(dst) = r;
  } else {
    for (int j = 0; j < n && j < 4; ++j) dst[j] = __float2bfloat16(v[j]);
  }
}

// Copy a ROWS x COLS tile (row stride ld in global memory, LD floats in
// shared memory) of which the first `rows` rows and `cols` columns are in
// range, the rest zero-filled: 16-byte cp.async copies where vec (cols and
// ld multiples of 4, the pointer 16-byte aligned), else 4-byte ones; T
// threads. A thread's 16-byte copies keep the same rows and column every
// step, so the per-step work is a multiply-add and a compare a copy.
template <int ROWS, int COLS, int T, int LD>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, long long ld, int rows,
                                          int cols, bool vec, int tid, const float* dummy) {
  if (vec) {
    constexpr int V = COLS / 4, N = ROWS * V, DR = T / V;
    static_assert(T % V == 0, "a thread's copies share a column");
    const int r0 = tid / V, c = (tid % V) * 4;
    const bool col_ok = c < cols;
#pragma unroll
    for (int j = 0; j < (N + T - 1) / T; ++j) {
      const int r = r0 + j * DR;
      if (N % T == 0 || r < ROWS) {
        const bool ok = col_ok && r < rows;
        ftc::cp_async16(ftc::smem_addr(dst + r * LD + c), ok ? src + r * ld + c : dummy,
                        ok ? 16 : 0);
      }
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += T) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < rows && c < cols;
      ftc::cp_async4(dst + r * LD + c, ok ? src + r * ld + c : dummy, ok ? 4 : 0);
    }
  }
}

template <int BX, int BZ, int TM, int BK, bool ACC_REGS>
__global__ void __launch_bounds__(Tile<BX, BZ, TM, BK>::kThreads)
fused_f32_kernel(const Args p) {
  using L = Tile<BX, BZ, TM, BK>;
  constexpr int NX = L::kNX, NZ = L::kNZ, T = L::kThreads;
  constexpr int E = TM * kTN;  // H values per thread
  static_assert(BK % 4 == 0 && BZ % kTN == 0 && BX % TM == 0, "whole micro-tiles");

  extern __shared__ __align__(16) float f32_smem[];
  float* sA = f32_smem;                          // [kStages][BX][kRowA]
  float* sB = f32_smem + kStages * L::kStageA;   // [kStages][BK][BZ]
  float* acc_s = f32_smem + L::kRing;            // [mn][E][T] when !ACC_REGS

  const int tid = threadIdx.x, tz = tid % NZ, tx = tid / NZ;
  const int x0 = blockIdx.y * BX, z0 = blockIdx.x * BZ;
  const int split = blockIdx.z % p.splits;
  const long long g = blockIdx.z / p.splits, G = gridDim.z / p.splits;
  const int X = p.X, Y = p.Y, Z = p.Z;
  const float* a_g = p.a + g * p.R * (long long)X * Y;
  const float* b_g = p.b + g * p.b_group_stride;

  // The flattened sequence: step u = (r, kc) covers K [kc*BK, kc*BK + BK) of
  // rank r; this block takes steps [u0, u1).
  const int kcs = (Y + BK - 1) / BK;
  const long long steps = (long long)p.R * kcs;
  const long long u0 = steps * split / p.splits, u1 = steps * (split + 1) / p.splits;
  const int n = (int)(u1 - u0);

  auto load_stage = [&](int slot, int r, int kc) {
    const int y0 = kc * BK;
    copy_tile<BX, BK, T, L::kRowA>(sA + slot * L::kStageA,
                                   a_g + (long long)r * X * Y + (long long)x0 * Y + y0, Y,
                                   X - x0, Y - y0, p.vec_a, tid, p.a);
    copy_tile<BK, BZ, T, BZ>(sB + slot * L::kStageB,
                             b_g + (long long)r * Y * Z + (long long)y0 * Z + z0, Z, Y - y0,
                             Z - z0, p.vec_b, tid, p.b);
  };

  float h[E];  // H_r (this block's steps of it): rows tx + i*NX, columns z0 + 4*tz + j
  float acc[ACC_REGS ? kAccRegs : 1][E];
#pragma unroll
  for (int e = 0; e < E; ++e) h[e] = 0.f;
  if constexpr (ACC_REGS) {
#pragma unroll
    for (int q = 0; q < kAccRegs; ++q)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[q][e] = 0.f;
  } else {
    for (int e = tid; e < p.mn * E * T; e += T) acc_s[e] = 0.f;
  }
  const CoeffTable w(p.table, p.R);

  int ld_r = (int)(u0 / kcs), ld_k = (int)(u0 % kcs);  // the next step to load
  int r = ld_r, kc = ld_k;                               // the step to compute
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) {
      load_stage(s, ld_r, ld_k);
      if (++ld_k == kcs) ld_k = 0, ++ld_r;
    }
    ftc::cp_async_commit();
  }

  for (int i = 0; i < n; ++i) {
    ftc::cp_async_wait<kStages - 2>();
    __syncthreads();  // step i landed for every thread; step i-1's slot is free
    if (i + kStages - 1 < n) {
      load_stage((i + kStages - 1) % kStages, ld_r, ld_k);
      if (++ld_k == kcs) ld_k = 0, ++ld_r;
    }
    ftc::cp_async_commit();

    const int slot = i % kStages;
    const float* tA = sA + slot * L::kStageA + tx * L::kRowA;
    const float* tB = sB + slot * L::kStageB + tz * kTN;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 b4[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) b4[kk] = *reinterpret_cast<const float4*>(tB + (k + kk) * BZ);
#pragma unroll
      for (int ii = 0; ii < TM; ++ii) {
        const float4 a4 = *reinterpret_cast<const float4*>(tA + ii * NX * L::kRowA + k);
        fma4(h, ii * kTN, a4.x, b4[0]);
        fma4(h, ii * kTN, a4.y, b4[1]);
        fma4(h, ii * kTN, a4.z, b4[2]);
        fma4(h, ii * kTN, a4.w, b4[3]);
      }
    }

    if (kc == kcs - 1 || i == n - 1) {  // Combine H for rank r
      for (int t = w.row_ptr[r]; t < w.row_ptr[r + 1]; ++t) {
        const float c = (float)w.coeff[t];
        const int part = w.part[t];
        if constexpr (ACC_REGS) {
#pragma unroll
          for (int q = 0; q < kAccRegs; ++q)
            if (q == part) {
#pragma unroll
              for (int e = 0; e < E; ++e) acc[q][e] = fmaf(c, h[e], acc[q][e]);
            }
        } else {
          float* a_p = acc_s + (size_t)part * E * T + tid;
#pragma unroll
          for (int e = 0; e < E; ++e) a_p[e * T] = fmaf(c, h[e], a_p[e * T]);
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) h[e] = 0.f;
    }
    if (++kc == kcs) kc = 0, ++r;
  }
  ftc::cp_async_wait<0>();

  // Write the tile of every part: C (splits == 1) or this split's partial.
  const long long plane = (long long)X * Z;
  const bool vec_out = Z % 4 == 0;
  const int zt = z0 + tz * kTN, nz = Z - zt;
  for (int q = 0; q < p.mn; ++q) {
    float v[E];
    if constexpr (ACC_REGS) {
#pragma unroll
      for (int qq = 0; qq < kAccRegs; ++qq)
        if (qq == q) {
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] = acc[qq][e];
        }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = acc_s[((size_t)q * E + e) * T + tid];
    }
    const long long base = (g * p.mn + q) * plane;
#pragma unroll
    for (int ii = 0; ii < TM; ++ii) {
      const int x = x0 + tx + ii * NX;
      if (x >= X || nz <= 0) continue;
      const long long off = base + (long long)x * Z + zt;
      if (p.splits > 1)
        store_row(p.ws + split * G * p.mn * plane + off, v + ii * kTN, nz, vec_out);
      else if (p.out_bf16)
        store_row(static_cast<__nv_bfloat16*>(p.out) + off, v + ii * kTN, nz, vec_out);
      else
        store_row(static_cast<float*>(p.out) + off, v + ii * kTN, nz, vec_out);
    }
  }
}

// The 8-row tiles' kernel where m*n <= kAccRegs. With 4 x 32 accumulators
// a lane, a lane's own H block cannot grow past 8 x 4, which reads 12
// floats from shared memory for 32 FMAs; here instead a pair of adjacent
// lanes shares an 8 x 8 block of H_r, each lane summing every other group
// of 2 K steps of it (kh = lane & 1). Per group a lane reads its 2 x 8 Bt
// values (four 16-byte loads) and its 8 At rows along K (eight 8-byte
// loads) for 128 FMAs: one FMA per byte read from shared memory, against
// 0.67 for 8 x 4. At a rank's end the pair swaps the halves it does not
// keep (each lane holds its own 4 rows first: 32 shuffles) and each lane
// folds its own 4 x 8 half into its accumulators, all in registers (64 H
// values and 128 accumulators a lane, no spills), with W's row for the rank
// read as one 16-byte load from a dense copy in shared memory, built from
// the CSR table at the start (in place of a walk of the table in global
// memory at every rank's end). A pair has the threads of two 8 x 4 lanes.
// Stages are 32 K steps deep (8 where Y <= 8).
template <int BX, int BZ, int BK>
struct PairTile {
  static constexpr int kPX = BX / 8, kPZ = BZ / 8;  // 8 x 8 blocks along x, z
  static constexpr int kThreads = 2 * kPX * kPZ;
  static constexpr int kWZ = kPZ / 4;               // warps along z (4 x 4 blocks a warp)
  static constexpr int kRowA = BK + kPadA;          // At tile [BX][kRowA]
  static constexpr int kRowB = BZ + kPadB;          // Bt tile [BK][kRowB]
  static constexpr int kStageA = BX * kRowA, kStageB = BK * kRowB;
  static constexpr int kRing = kStages * (kStageA + kStageB);
  // the ring, then W as R dense rows of kAccRegs coefficients
  static size_t bytes(int R) { return 4 * ((size_t)kRing + (size_t)kAccRegs * R); }
};

template <int BX, int BZ, int BK>
__global__ void __launch_bounds__(PairTile<BX, BZ, BK>::kThreads)
fused_f32_pair_kernel(const Args p) {
  using L = PairTile<BX, BZ, BK>;
  constexpr int T = L::kThreads, HX = BX / 2, HZ = BZ / 2;
  // a warp's 8-byte At reads (4 px x 2 kh) and 16-byte Bt reads (4 pz x 2
  // kh) fall in distinct banks: a lane's rows are interleaved with the
  // other px's (rows px + i * kPX, kRowA = 4 mod 8 words apart), a pair's
  // lanes read K groups 2 steps apart, and its Bt rows sit 16 banks apart
  static_assert(BX % 32 == 0 && BZ % 32 == 0 && BK % 8 == 0, "whole warps and K groups");
  static_assert(HX * L::kRowA % 32 == 0 && L::kRowA % 8 == 4 && 2 * L::kRowB % 32 == 16,
                "conflict-free rows");

  extern __shared__ __align__(16) float f32_smem[];
  float* sA = f32_smem;                          // [kStages][BX][kRowA]
  float* sB = f32_smem + kStages * L::kStageA;   // [kStages][BK][kRowB]
  float* wd = f32_smem + L::kRing;               // [R][kAccRegs]: W[r, part]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kh = lane & 1;
  const int pz = ((lane >> 1) & 3) + 4 * (warp % L::kWZ);
  const int px = (lane >> 3) + 4 * (warp / L::kWZ);
  const int x0 = blockIdx.y * BX, z0 = blockIdx.x * BZ;
  const int split = blockIdx.z % p.splits;
  const long long g = blockIdx.z / p.splits, G = gridDim.z / p.splits;
  const int X = p.X, Y = p.Y, Z = p.Z;
  const float* a_g = p.a + g * p.R * (long long)X * Y;
  const float* b_g = p.b + g * p.b_group_stride;

  const int kcs = (Y + BK - 1) / BK;
  const long long steps = (long long)p.R * kcs;
  const long long u0 = steps * split / p.splits, u1 = steps * (split + 1) / p.splits;
  const int n = (int)(u1 - u0);

  auto load_stage = [&](int slot, int r, int kc) {
    const int y0 = kc * BK;
    copy_tile<BX, BK, T, L::kRowA>(sA + slot * L::kStageA,
                                   a_g + (long long)r * X * Y + (long long)x0 * Y + y0, Y,
                                   X - x0, Y - y0, p.vec_a, tid, p.a);
    copy_tile<BK, BZ, T, L::kRowB>(sB + slot * L::kStageB,
                                   b_g + (long long)r * Y * Z + (long long)y0 * Z + z0, Z, Y - y0,
                                   Z - z0, p.vec_b, tid, p.b);
  };

  // h: this lane's K groups of the pair's 8 x 8 block of H_r, h[i * 8 + j]:
  // row px + (i % 4) * kPX of x chunk kh (the rows this lane keeps) for i <
  // 4, of the other chunk for i >= 4; column j of z chunk j / 4. acc: the
  // kept rows, per output part.
  float h[64];
  float acc[kAccRegs][32];
#pragma unroll
  for (int e = 0; e < 64; ++e) h[e] = 0.f;
#pragma unroll
  for (int q = 0; q < kAccRegs; ++q)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[q][e] = 0.f;
  {  // W densely, a rank a thread (read at a rank's end, after a barrier)
    const CoeffTable w(p.table, p.R);
    static_assert(kAccRegs == 4, "a rank's coefficients are one 16-byte load");
    for (int r = tid; r < p.R; r += T) {
#pragma unroll
      for (int q = 0; q < kAccRegs; ++q) wd[r * kAccRegs + q] = 0.f;
      for (int t = w.row_ptr[r]; t < w.row_ptr[r + 1]; ++t)
        wd[r * kAccRegs + w.part[t]] = (float)w.coeff[t];
    }
  }

  int ld_r = (int)(u0 / kcs), ld_k = (int)(u0 % kcs);
  int r = ld_r, kc = ld_k;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) {
      load_stage(s, ld_r, ld_k);
      if (++ld_k == kcs) ld_k = 0, ++ld_r;
    }
    ftc::cp_async_commit();
  }

  for (int i = 0; i < n; ++i) {
    ftc::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n) {
      load_stage((i + kStages - 1) % kStages, ld_r, ld_k);
      if (++ld_k == kcs) ld_k = 0, ++ld_r;
    }
    ftc::cp_async_commit();

    const int slot = i % kStages;
    // this lane's K groups start at 2 * kh; its kept rows at kh * HX
    const float* tA = sA + slot * L::kStageA + (kh * HX + px) * L::kRowA + 2 * kh;
    const float* tB = sB + slot * L::kStageB + 2 * kh * L::kRowB + pz * 4;
#pragma unroll
    for (int t = 0; t < BK / 4; ++t) {  // K steps 4t + 2kh, 4t + 2kh + 1
      float4 b[2][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        b[kk][0] = *reinterpret_cast<const float4*>(tB + (4 * t + kk) * L::kRowB);
        b[kk][1] = *reinterpret_cast<const float4*>(tB + (4 * t + kk) * L::kRowB + HZ);
      }
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        // kept rows px + (ii % 4) * kPX of chunk kh, then the other chunk's
        const int row = (ii % 4) * L::kPX * L::kRowA + (ii < 4 ? 0 : (1 - 2 * kh) * HX * L::kRowA);
        const float2 a2 = *reinterpret_cast<const float2*>(tA + row + 4 * t);
        const float av[2] = {a2.x, a2.y};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          fma4(h, ii * 8, av[kk], b[kk][0]);
          fma4(h, ii * 8 + 4, av[kk], b[kk][1]);
        }
      }
    }

    if (kc == kcs - 1 || i == n - 1) {  // Combine H for rank r
      float own[32];                    // the kept rows of H_r, both lanes' K groups
#pragma unroll
      for (int e = 0; e < 32; ++e) own[e] = h[e] + __shfl_xor_sync(0xffffffffu, h[32 + e], 1);
      const float4 cw = *reinterpret_cast<const float4*>(wd + r * kAccRegs);
      const float c[kAccRegs] = {cw.x, cw.y, cw.z, cw.w};
#pragma unroll
      for (int q = 0; q < kAccRegs; ++q)
        if (c[q] != 0.f) {
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[q][e] = fmaf(c[q], own[e], acc[q][e]);
        }
#pragma unroll
      for (int e = 0; e < 64; ++e) h[e] = 0.f;
    }
    if (++kc == kcs) kc = 0, ++r;
  }
  ftc::cp_async_wait<0>();

  const long long plane = (long long)X * Z;
  const bool vec_out = Z % 4 == 0;
  const int zc[2] = {z0 + pz * 4, z0 + HZ + pz * 4};
  for (int q = 0; q < p.mn; ++q) {
    float v[32];
#pragma unroll
    for (int qq = 0; qq < kAccRegs; ++qq)
      if (qq == q) {
#pragma unroll
        for (int e = 0; e < 32; ++e) v[e] = acc[qq][e];
      }
    const long long base = (g * p.mn + q) * plane;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int x = x0 + kh * HX + px + ii * L::kPX;
      if (x >= X) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const long long off = base + (long long)x * Z + zc[c];
        const float* vi = v + ii * 8 + c * 4;
        if (p.splits > 1)
          store_row(p.ws + split * G * p.mn * plane + off, vi, Z - zc[c], vec_out);
        else if (p.out_bf16)
          store_row(static_cast<__nv_bfloat16*>(p.out) + off, vi, Z - zc[c], vec_out);
        else
          store_row(static_cast<float*>(p.out) + off, vi, Z - zc[c], vec_out);
      }
    }
  }
}

// Launch ``kernel`` on ``grid``, then, with splits > 1, the fixed-order
// reduce pass over the workspace.
template <typename Kernel>
static int run(Kernel kernel, size_t smem, int threads, dim3 grid, const Args& p, int G,
               cudaStream_t s) {
  if (smem != (size_t)p.smem_bytes) return (int)cudaErrorInvalidValue;  // planner drifted
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long count = (long long)G * p.mn * p.X * p.Z;
  if (p.out_bf16)
    return launch_split_reduce<__nv_bfloat16>(p.ws, static_cast<__nv_bfloat16*>(p.out), count,
                                              p.splits, s);
  return launch_split_reduce<float>(p.ws, static_cast<float*>(p.out), count, p.splits, s);
}

// Tile (BX, BZ, TM) at stage depth BK: the pair kernel for TM = 8 and m*n
// <= kAccRegs, the one-lane kernel otherwise (BK 16 or 8; its accumulators
// in registers for m*n <= kAccRegs).
template <int BX, int BZ, int TM, int BK>
static int launch_acc(const Args& p, int G, cudaStream_t s) {
  if constexpr (TM == 8) {
    if (p.mn <= kAccRegs) {
      if constexpr (BK != 16) {
        using L = PairTile<BX, BZ, BK>;
        return run(fused_f32_pair_kernel<BX, BZ, BK>, L::bytes(p.R), L::kThreads,
                   Tile<BX, BZ, TM, BK>::grid(p, G), p, G, s);
      }
    } else if constexpr (BK <= 16) {
      using L = Tile<BX, BZ, TM, BK>;
      return run(fused_f32_kernel<BX, BZ, TM, BK, false>, L::bytes(p.mn, false), L::kThreads,
                 L::grid(p, G), p, G, s);
    }
  } else if constexpr (BK <= 16) {
    using L = Tile<BX, BZ, TM, BK>;
    if (p.mn <= kAccRegs)
      return run(fused_f32_kernel<BX, BZ, TM, BK, true>, L::bytes(p.mn, true), L::kThreads,
                 L::grid(p, G), p, G, s);
    return run(fused_f32_kernel<BX, BZ, TM, BK, false>, L::bytes(p.mn, false), L::kThreads,
               L::grid(p, G), p, G, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The tiles kernels/tuning.py:F32_TILES may pick, as (bx, bz, tm).
template <int BK>
static int launch_bk(int bx, int bz, const Args& p, int G, cudaStream_t s) {
  if (bx == 64 && bz == 64) return launch_acc<64, 64, 8, BK>(p, G, s);
  if (bx == 128 && bz == 32) return launch_acc<128, 32, 8, BK>(p, G, s);
  if (bx == 32 && bz == 64) return launch_acc<32, 64, 4, BK>(p, G, s);
  if (bx == 64 && bz == 32) return launch_acc<64, 32, 4, BK>(p, G, s);
  if (bx == 8 && bz == 64) return launch_acc<8, 64, 2, BK>(p, G, s);
  return (int)cudaErrorInvalidValue;
}

// The stage depths kernels/tuning.py:F32_BKS names.
static int launch_tile(int bx, int bz, int bk, const Args& p, int G, cudaStream_t s) {
  if (p.splits < 1 || (p.splits > 1 && p.ws == nullptr)) return (int)cudaErrorInvalidValue;
  if (bk == 32) return launch_bk<32>(bx, bz, p, G, s);
  if (bk == 16) return launch_bk<16>(bx, bz, p, G, s);
  if (bk == 8) return launch_bk<8>(bx, bz, p, G, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace f32

// at (G, R, X, Y), bt (G, R, Y, Z) or shared (R, Y, Z) with bt_group_stride
// 0, out (G, m*n, X, Z); all contiguous. in_dtype is at's and bt's type. The
// plan: tile (bx, bz), stage depth bk (f32; bf16 stages are ftc::kBK deep),
// `splits` reduction splits (ws: a (splits, G, m*n, X, Z) f32 workspace when
// splits > 1) and smem_bytes, the planner's shared memory for the tile, held
// to the kernel's layout. vec (bf16): Y and Z multiples of 8 and both
// pointers 16-byte aligned; the f32 route decides its 16-byte copies per
// operand here.
extern "C" int falcon_fused_gemm_combine_h(int device, const void* at, const void* bt,
                                           void* out, void* ws, const void* table,
                                           int in_dtype, int out_dtype, int G, int R, int mn,
                                           int X, int Y, int Z, long long bt_group_stride,
                                           int vec, int bx, int bz, int bk, int splits,
                                           int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  if (out_dtype != FALCON_F32 && out_dtype != FALCON_BF16) return (int)cudaErrorInvalidValue;
  if (in_dtype == FALCON_BF16) {
    const ftc::Args p{at, bt, nullptr, nullptr, out, static_cast<float*>(ws), tab, R, mn,
                      X, Y, Z, ftc::kBK, splits, vec, bt_group_stride, smem_bytes};
    if (out_dtype == FALCON_F32) return ftc::launch_tile<false, float>(bx, bz, p, G, s);
    return ftc::launch_tile<false, __nv_bfloat16>(bx, bz, p, G, s);
  }
  if (in_dtype != FALCON_F32) return (int)cudaErrorInvalidValue;
  const f32::Args p{static_cast<const float*>(at), static_cast<const float*>(bt), out,
                    static_cast<float*>(ws), tab, R, mn, X, Y, Z, splits,
                    out_dtype == FALCON_BF16,
                    Y % 4 == 0 && reinterpret_cast<uintptr_t>(at) % 16 == 0,
                    Z % 4 == 0 && reinterpret_cast<uintptr_t>(bt) % 16 == 0,
                    bt_group_stride, smem_bytes};
  return f32::launch_tile(bx, bz, bk, p, G, s);
}
