// Tensor-core fused GEMM + Group Combine H for Hopper, shared by the bf16
// kernel (csrc/fused_gemm.cu) and the int8 one (csrc/quant_combine.cu).
//
// For every group g a block computes a tile of the C parts
//     out[g, p] = sum_r W[r, p] * (At[g, r] @ Bt[g, r])        p < m*n
// with H_r = At_r @ Bt_r summed in f32 (bf16) or exactly in int32 per
// K-block of `by` columns and then dequantized (int8), never stored.
//
// Bound on the H100: bytes at every served shape (a stream over Bt; mlp_up
// at prefill does 116 operations per byte against the card's ~295). So the
// design streams Bt from enough blocks, with the products on tensor cores
// so compute never sets the pace:
//  - mma.sync m16n8k16 bf16 -> f32, or m16n8k32 s8 -> s32, computing the
//    transposed H^T = Bt^T At^T: the Z side of a tile fills the MMA's 16
//    rows and the rows x of A (2 at decode) its 8-wide side. Fragments come
//    from shared memory through ldmatrix (.trans for the Z-contiguous bf16
//    Bt; int8 has no transposing ldmatrix, so the Bq tile is transposed in
//    shared memory with byte permutes before the MMA reads it).
//  - A kStages-deep ring of cp.async 16-byte copies (zero-filling the
//    ragged edges) over one flattened sequence of (rank, K-chunk) steps, so
//    the pipe never drains at a rank boundary. Where a row stride or a
//    pointer is not 16-byte aligned the stage is filled element by element
//    instead (same ring, synchronous stores).
//  - H_r stays in the MMA's accumulator fragments; at the end of a rank it
//    is folded into the m*n output accumulators, in ascending r, skipping
//    zero coefficients: in registers for m*n <= kAccRegs, else in shared
//    memory (each thread its own entries, no barrier).
//  - Split reduction: blockIdx.z carries (group, split). With splits > 1 a
//    block takes a contiguous range of units (int8: whole K-blocks, so no
//    int32 sum is cut) and writes its f32 partial of every output part to a
//    workspace; split_reduce_kernel (common.cuh) sums the partials in fixed
//    order, so the result is deterministic (no atomics).
// Tiles, ring depth and splits are planned by kernels/tuning.py:plan_fused_tc.
#pragma once

#include "common.cuh"

namespace ftc {

constexpr int kThreads = 128;  // TC_THREADS
constexpr int kBK = 128;       // TC_BK: K elements of one ring stage
constexpr int kStages = 3;     // TC_STAGES
constexpr int kPad = 16;       // TC_PAD: bytes after every staged row
constexpr int kAccRegs = 4;    // TC_ACC_REGS

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (a shared-space address); bytes past src_bytes
// are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
// 4 bytes global -> shared; zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix from shared-space addresses
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(int d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

struct Args {
  const void* a;         // At (G, R, X, Y) bf16, or Aq (R, X, Y) int8
  const void* b;         // Bt (G, R, Y, Z) or shared (R, Y, Z); Bq (R, Y, Z) int8
  const float* a_scales;  // int8: (R, X, Y/by)
  const float* b_scales;  // int8: (R, Y/by, Z)
  void* out;             // (G, mn, X, Z) when splits == 1
  float* ws;             // (splits, G, mn, X, Z) f32 when splits > 1
  const int* table;      // W as a CoeffTable
  int R, mn, X, Y, Z;
  int by;                // K extent of a unit: the int8 K-block, kBK for bf16
  int splits;
  int vec;               // 16-byte copies allowed (strides and pointers aligned)
  long long b_group_stride;  // elements; 0 when Bt is shared
  int smem_bytes;        // the planner's (tuning.py:fused_tc_smem), checked at launch
};

// Position in the flattened sequence: rank r, unit yb of the rank, step c
// of the unit; advanced one step at a time, so the loop divides nothing.
struct Cursor {
  int r, yb, c;
  __device__ __forceinline__ void next(int upr, int spu) {
    if (++c == spu) {
      c = 0;
      if (++yb == upr) {
        yb = 0;
        ++r;
      }
    }
  }
};

template <bool QUANT>
struct Elem;
template <>
struct Elem<false> {
  using T = __nv_bfloat16;
  using Acc = float;
  static __device__ __forceinline__ T zero() { return __ushort_as_bfloat16(0); }
};
template <>
struct Elem<true> {
  using T = int8_t;
  using Acc = int;
  static __device__ __forceinline__ T zero() { return 0; }
};

// Shared memory of one block, in bytes (kernels/tuning.py:fused_tc_smem).
template <bool QUANT, int BX, int BZ>
struct Layout {
  static constexpr int kIsz = QUANT ? 1 : 2;
  static constexpr int kRowA = kBK * kIsz + kPad;  // At tile [BX][kBK]
  static constexpr int kRowB = BZ * kIsz + kPad;   // Bt tile [kBK][BZ]
  static constexpr int kRowT = kBK + kPad;         // int8: Bq^T tile [BZ][kBK]
  static constexpr int kStageA = BX * kRowA;
  static constexpr int kStageB = kBK * kRowB;
  static constexpr int kStageS = QUANT ? 4 * (BX + BZ) : 0;  // int8: a unit's scales
  static constexpr int kRing = kStages * (kStageA + kStageB + kStageS);
  static constexpr int kTrans = QUANT ? BZ * kRowT : 0;
  static size_t bytes(int mn, bool acc_regs) {
    return (size_t)kRing + kTrans + (acc_regs ? 0 : (size_t)4 * mn * BX * BZ);
  }
};

template <bool QUANT, typename Tout, int BX, int BZ, int WZ, int WX, bool ACC_REGS>
__global__ void __launch_bounds__(kThreads) fused_tc_kernel(const Args p) {
  using T = typename Elem<QUANT>::T;
  using Acc = typename Elem<QUANT>::Acc;
  using L = Layout<QUANT, BX, BZ>;
  static_assert(WZ * WX * 32 == kThreads, "four warps");
  static_assert(kBK * BZ * L::kIsz / 16 % kThreads == 0, "whole Bt copies per thread");
  constexpr int MT = BZ / WZ / 16;  // 16-row MMA tiles of a warp along z
  constexpr int NT = BX / WX / 8;   // 8-wide MMA tiles of a warp along x
  constexpr int FRAG = MT * NT * 4;  // accumulator values per thread
  constexpr int EV = 16 / L::kIsz;   // elements of one 16-byte copy
  constexpr int KSTEP = QUANT ? 32 : 16;

  extern __shared__ __align__(16) unsigned char ftc_smem[];
  unsigned char* sA = ftc_smem;
  unsigned char* sB = ftc_smem + kStages * L::kStageA;
  float* sS = reinterpret_cast<float*>(sB + kStages * L::kStageB);  // [slot][BX + BZ]
  unsigned char* sT = ftc_smem + L::kRing;
  float* acc_s = reinterpret_cast<float*>(ftc_smem + L::kRing + L::kTrans);
  const uint32_t sA_u = smem_addr(sA), sB_u = smem_addr(sB), sT_u = smem_addr(sT);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wz = warp % WZ, wx = warp / WZ;
  const int zw = wz * (BZ / WZ), xw = wx * (BX / WX);  // warp's origin in the tile
  const int g8 = lane / 4, t4 = lane % 4;
  const int x0 = blockIdx.y * BX, z0 = blockIdx.x * BZ;
  const int split = blockIdx.z % p.splits;
  const long long g = blockIdx.z / p.splits, G = gridDim.z / p.splits;
  const int X = p.X, Y = p.Y, Z = p.Z, by = p.by;

  const T* a_g = static_cast<const T*>(p.a) + g * p.R * (long long)X * Y;
  const T* b_g = static_cast<const T*>(p.b) + g * p.b_group_stride;

  // The flattened sequence: unit u = (r, yb) covers K [yb*by, min(Y, yb*by + by)),
  // in steps of kBK.
  const int upr = (Y + by - 1) / by;   // units per rank
  const int spu = (by + kBK - 1) / kBK;  // steps per unit
  const long long units = (long long)p.R * upr;
  const long long u_begin = units * split / p.splits, u_end = units * (split + 1) / p.splits;
  const int n = (int)((u_end - u_begin) * spu);

  const Cursor start{(int)(u_begin / upr), (int)(u_begin % upr), 0};

  auto load_stage = [&](int slot, const Cursor& cur) {
    const int r = cur.r, ys = cur.yb * by, y0 = ys + cur.c * kBK;
    const int yend = min(Y, ys + by);
    const T* a_r = a_g + (long long)r * X * Y;
    const T* b_r = b_g + (long long)r * Y * Z;
    if constexpr (QUANT) {
      if (cur.c == spu - 1) {  // the unit's last step carries its scales
        const int Yb = Y / by;
        float* dS = sS + slot * (BX + BZ);
        for (int i = tid; i < BX + BZ; i += kThreads) {
          if (i < BX) {
            const int x = x0 + i;
            const float* src = p.a_scales + ((long long)r * X + min(x, X - 1)) * Yb + cur.yb;
            cp_async4(dS + i, src, x < X ? 4 : 0);
          } else {
            const int z = z0 + i - BX;
            const float* src = p.b_scales + ((long long)r * Yb + cur.yb) * Z + min(z, Z - 1);
            cp_async4(dS + i, src, z < Z ? 4 : 0);
          }
        }
      }
    }
    if (p.vec) {
      // 16-byte copies, each thread the same (row, chunk) positions every
      // step; Y, Z and every K bound are multiples of EV here, so a copy is
      // whole or empty.
      constexpr int VA = kBK / EV, VB = BZ / EV;  // 16-byte copies per row
      const T* a_s = a_r + (long long)x0 * Y + y0;
      const T* b_s = b_r + (long long)y0 * Z + z0;
      const uint32_t dA = sA_u + slot * L::kStageA, dB = sB_u + slot * L::kStageB;
      const int rows_a = X - x0, cols_a = yend - y0, rows_b = yend - y0, cols_b = Z - z0;
#pragma unroll
      for (int j = 0; j < (BX * VA + kThreads - 1) / kThreads; ++j) {
        const int i = tid + j * kThreads, row = i / VA, col = (i % VA) * EV;
        if (BX * VA % kThreads == 0 || i < BX * VA) {
          const bool ok = row < rows_a && col < cols_a;
          cp_async16(dA + row * L::kRowA + (i % VA) * 16,
                     ok ? a_s + (long long)row * Y + col : a_s, ok ? 16 : 0);
        }
      }
#pragma unroll
      for (int j = 0; j < kBK * VB / kThreads; ++j) {
        const int i = tid + j * kThreads, row = i / VB, col = (i % VB) * EV;
        const bool ok = row < rows_b && col < cols_b;
        cp_async16(dB + row * L::kRowB + (i % VB) * 16,
                   ok ? b_s + (long long)row * Z + col : b_s, ok ? 16 : 0);
      }
    } else {
      unsigned char* dA = sA + slot * L::kStageA;
      unsigned char* dB = sB + slot * L::kStageB;
      for (int i = tid; i < BX * kBK; i += kThreads) {
        const int row = i / kBK, col = i % kBK, x = x0 + row, y = y0 + col;
        T v = Elem<QUANT>::zero();
        if (x < X && y < yend) v = a_r[(long long)x * Y + y];
        reinterpret_cast<T*>(dA + row * L::kRowA)[col] = v;
      }
      for (int i = tid; i < kBK * BZ; i += kThreads) {
        const int row = i / BZ, col = i % BZ, y = y0 + row, z = z0 + col;
        T v = Elem<QUANT>::zero();
        if (y < yend && z < Z) v = b_r[(long long)y * Z + z];
        reinterpret_cast<T*>(dB + row * L::kRowB)[col] = v;
      }
    }
  };

  float h[FRAG];    // H_r (its part from this block's range), f32
  Acc pk[FRAG];     // the MMA accumulators: H itself (bf16) or a K-block's int32 sum
  float acc[ACC_REGS ? kAccRegs : 1][FRAG];
#pragma unroll
  for (int e = 0; e < FRAG; ++e) {
    h[e] = 0.f;
    pk[e] = Acc(0);
  }
  if constexpr (ACC_REGS) {
#pragma unroll
    for (int q = 0; q < kAccRegs; ++q)
#pragma unroll
      for (int e = 0; e < FRAG; ++e) acc[q][e] = 0.f;
  } else {
    for (int e = tid; e < p.mn * FRAG * kThreads; e += kThreads) acc_s[e] = 0.f;
  }

  const CoeffTable w(p.table, p.R);

  Cursor ld = start, cur = start;  // the next stage to load, the stage to compute
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) {
      load_stage(i, ld);
      ld.next(upr, spu);
    }
    cp_async_commit();
  }

  for (int i = 0; i < n; ++i, cur.next(upr, spu)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n) {
      load_stage((i + kStages - 1) % kStages, ld);
      ld.next(upr, spu);
    }
    cp_async_commit();

    const int slot = i % kStages;
    const int r = cur.r, yb = cur.yb;
    const uint32_t tA = sA_u + slot * L::kStageA;
    uint32_t tB;
    if constexpr (QUANT) {
      // Bq tile [kBK][BZ] -> Bq^T [BZ][kBK], one 4 x 4 byte block (K quad kq,
      // Z quad zq) per thread and pass. Within a warp zq = lane % 16 and kq
      // runs diagonally (2 * (zq / 2) + lane / 16, shifted 2 per group of 32
      // blocks), so the 32 word reads (rows of kRowB = 20 words) and the 32
      // word writes (rows of kRowT = 36 words) each hit 32 distinct banks.
      constexpr int KQ = kBK / 4, ZQ = BZ / 4;
      static_assert(ZQ == 16 && kBK % 64 == 0, "the bank-free transpose assumes BZ = 64");
      const unsigned char* raw = sB + slot * L::kStageB;
#pragma unroll
      for (int q = tid; q < KQ * ZQ; q += kThreads) {
        const int zq = q % 16, kq = (2 * (zq / 2) + (q / 16) % 2 + 2 * (q / 32)) % KQ;
        int rows[4], cols[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          rows[b] = *reinterpret_cast<const int*>(raw + (4 * kq + b) * L::kRowB + 4 * zq);
        transpose4(rows, cols);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          *reinterpret_cast<int*>(sT + (4 * zq + b) * L::kRowT + 4 * kq) = cols[b];
      }
      __syncthreads();
      tB = sT_u;
    } else {
      tB = sB_u + slot * L::kStageB;
    }

#pragma unroll
    for (int kk = 0; kk < kBK / KSTEP; ++kk) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int z = zw + mt * 16 + ((lane >> 3) & 1) * 8;
        if constexpr (QUANT)
          ldsm_x4(af[mt], tB + (z + (lane & 7)) * L::kRowT + kk * 32 + (lane >> 4) * 16);
        else
          ldsm_x4_trans(af[mt], tB + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * L::kRowB + z * 2);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int x = xw + j * 8 + (lane & 7);
        ldsm_x2(bf[j], tA + x * L::kRowA + (kk * KSTEP + ((lane >> 3) & 1) * (KSTEP / 2)) *
                                               L::kIsz);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(&pk[(mt * NT + j) * 4], af[mt], bf[j]);
    }

    const bool unit_end = cur.c == spu - 1;
    const bool rank_end = i == n - 1 || (unit_end && yb == upr - 1);
    if constexpr (QUANT) {
      if (unit_end) {  // dequantize the K-block: (float(int sum) * a_scale) * b_scale
        const float* sa = sS + slot * (BX + BZ);
        const float* sb = sa + BX;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int e = (mt * NT + j) * 4 + c;
              const float a_s = sa[xw + j * 8 + 2 * t4 + (c & 1)];
              const float b_s = sb[zw + mt * 16 + g8 + 8 * (c >> 1)];
              h[e] = __fadd_rn(h[e], __fmul_rn(__fmul_rn(__int2float_rn(pk[e]), a_s), b_s));
              pk[e] = 0;
            }
      }
    } else if (rank_end) {
#pragma unroll
      for (int e = 0; e < FRAG; ++e) {
        h[e] = pk[e];
        pk[e] = 0.f;
      }
    }
    if (rank_end) {  // Combine H for rank r
      for (int t = w.row_ptr[r]; t < w.row_ptr[r + 1]; ++t) {
        const float c = (float)w.coeff[t];
        const int part = w.part[t];
        if constexpr (ACC_REGS) {
#pragma unroll
          for (int q = 0; q < kAccRegs; ++q)
            if (q == part) {
#pragma unroll
              for (int e = 0; e < FRAG; ++e) acc[q][e] = __fadd_rn(acc[q][e], __fmul_rn(c, h[e]));
            }
        } else {
          float* a_p = acc_s + (size_t)part * FRAG * kThreads + tid;
#pragma unroll
          for (int e = 0; e < FRAG; ++e)
            a_p[e * kThreads] = __fadd_rn(a_p[e * kThreads], __fmul_rn(c, h[e]));
        }
      }
#pragma unroll
      for (int e = 0; e < FRAG; ++e) h[e] = 0.f;
    }
  }
  cp_async_wait<0>();

  // Write the tile of every part: C (splits == 1) or this split's partial.
  const long long plane = (long long)X * Z;
  for (int q = 0; q < p.mn; ++q) {
    float v[FRAG];
    if constexpr (ACC_REGS) {
#pragma unroll
      for (int qq = 0; qq < kAccRegs; ++qq)
        if (qq == q) {
#pragma unroll
          for (int e = 0; e < FRAG; ++e) v[e] = acc[qq][e];
        }
    } else {
#pragma unroll
      for (int e = 0; e < FRAG; ++e) v[e] = acc_s[((size_t)q * FRAG + e) * kThreads + tid];
    }
    const long long base = (g * p.mn + q) * plane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int z = z0 + zw + mt * 16 + g8 + 8 * (c >> 1);
          const int x = x0 + xw + j * 8 + 2 * t4 + (c & 1);
          if (x < X && z < Z) {
            const float val = v[(mt * NT + j) * 4 + c];
            if (p.splits == 1)
              static_cast<Tout*>(p.out)[base + (long long)x * Z + z] = from_f32<Tout>(val);
            else
              p.ws[(split * G * p.mn) * plane + base + (long long)x * Z + z] = val;
          }
        }
  }
}

template <bool QUANT, typename Tout, int BX, int BZ, int WZ, int WX, bool ACC_REGS>
static int launch(const Args& p, int G, cudaStream_t s) {
  auto kernel = fused_tc_kernel<QUANT, Tout, BX, BZ, WZ, WX, ACC_REGS>;
  const size_t smem = Layout<QUANT, BX, BZ>::bytes(p.mn, ACC_REGS);
  if (smem != (size_t)p.smem_bytes) return (int)cudaErrorInvalidValue;  // planner drifted
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.Z + BZ - 1) / BZ, (p.X + BX - 1) / BX, G * p.splits);
  kernel<<<grid, kThreads, smem, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  return launch_split_reduce<Tout>(p.ws, static_cast<Tout*>(p.out),
                                   (long long)G * p.mn * p.X * p.Z, p.splits, s);
}

template <bool QUANT, typename Tout, int BX, int BZ, int WZ, int WX>
static int launch_acc(const Args& p, int G, cudaStream_t s) {
  if (p.mn <= kAccRegs) return launch<QUANT, Tout, BX, BZ, WZ, WX, true>(p, G, s);
  return launch<QUANT, Tout, BX, BZ, WZ, WX, false>(p, G, s);
}

// The tiles kernels/tuning.py:TC_TILES may pick, with their warp layouts
// (TC_WARPS).
template <bool QUANT, typename Tout>
static int launch_tile(int bx, int bz, const Args& p, int G, cudaStream_t s) {
  if (p.splits < 1 || (p.splits > 1 && p.ws == nullptr)) return (int)cudaErrorInvalidValue;
  if (bx == 32 && bz == 64) return launch_acc<QUANT, Tout, 32, 64, 2, 2>(p, G, s);
  if (bx == 16 && bz == 64) return launch_acc<QUANT, Tout, 16, 64, 4, 1>(p, G, s);
  if (bx == 8 && bz == 64) return launch_acc<QUANT, Tout, 8, 64, 4, 1>(p, G, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ftc
