// Group Combine A/B (paper Alg. 2, stages 1-2) for Hopper.
//
// Replaces the Pallas TPU kernels group_combine and batched_group_combine
// (src/repro/kernels/group_combine.py). Computes, for every group g and
// every rank r,
//     out[g, r, x, y] = sum_{i,l} c[r, i, l] * in[g, i*X + x, l*Y + y]
// reading the (d1*X, d2*Y) input in place: the d1*d2 blocks are addressed
// by offset, no relayout of the input is ever materialized.
//
// Bound on the H100: bytes. Each element is read once and R outputs are
// written, (d1*d2 + R) * X * Y * itemsize per group against ~2 flops per
// term, far below the card's ridge. So the kernel is a stream of 16-byte
// accesses with as many of them in flight as the SM holds:
//  - The block stages its scheme's coefficient table (CSR: row_ptr, part,
//    coeff; (R + 1 + 2*nnz) ints, a few KB even for s555) in shared memory
//    once, behind the kernel's one barrier, so no term waits on a global load
//    chain. Where a thread has one row (a call too small to give it more:
//    latency-bound), its loads are issued before the table is staged, so it
//    pays one memory latency, not two (PREFETCH; with several rows the
//    registers this holds would cost the stream occupancy).
//  - A thread owns VEC consecutive y (8 bf16 or 4 f32: 16 bytes) of `rows`
//    rows x, a block (ty along y, tx along x) covering ty*VEC consecutive y of
//    each row, so a warp's accesses are contiguous row segments. For each row
//    it loads its d1*d2 co-located vectors, four 16-byte loads in flight at a
//    time, and parks them in its own slots of shared memory (no other thread
//    reads them: a runtime-indexed register array would spill). Then each of
//    the R outputs is summed in f32 over the rank's terms, in the table's
//    order (|c| > 1 scaled), rounded once and written with one 16-byte store.
//  - VEC = 1 is the same kernel with 2- or 4-byte accesses, for a Y that is
//    no multiple of the vector width or a pointer that is not 16-byte
//    aligned; the planner decides before the launch.
// Block shape, rows per thread and the vector width: kernels/tuning.py
// (plan_combine).
#include "common.cuh"

// Shared memory of one block (kernels/tuning.py:combine_smem): each thread's
// d1*d2 slots, rounded up to 16 bytes, then the coefficient table.
template <typename T, int VEC>
static size_t combine_smem(int nparts, int threads, int table_len) {
  const size_t slots = (size_t)nparts * threads * sizeof(typename Pack<T, VEC>::Raw);
  return (slots + 15) / 16 * 16 + (size_t)table_len * 4;
}

template <typename T, int VEC, bool PREFETCH>
__global__ void __launch_bounds__(256)
group_combine_kernel(const T* __restrict__ in, T* __restrict__ out,
                     const int* __restrict__ table, int table_len, int R, int d1, int d2,
                     int X, int Y, int rows) {
  using P = Pack<T, VEC>;
  using Raw = typename P::Raw;
  extern __shared__ __align__(16) unsigned char gc_smem[];
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int np = d1 * d2;
  Raw* slots = reinterpret_cast<Raw*>(gc_smem);  // [np][nthreads]
  int* tab = reinterpret_cast<int*>(gc_smem + ((size_t)np * nthreads * sizeof(Raw) + 15) / 16 * 16);

  const int y = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int x0 = blockIdx.y * blockDim.y * rows + threadIdx.y;
  const bool active = y < Y && x0 < X;  // ragged edges; idle threads still stage the table
  const long long g = blockIdx.z;
  const long long ld = (long long)d2 * Y;  // row stride of the input
  const long long plane = (long long)X * Y;
  const T* src = in + g * d1 * X * ld + y;
  T* dst_g = out + g * R * plane + y;
  Raw* mine = slots + tid;
  // Up to four of row x's co-located vectors, parts p0..p0+3, into v.
  auto load4 = [&](Raw* v, int p0, int x) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p0 + j < np) {
        const int i = (p0 + j) / d2, l = (p0 + j) % d2;
        v[j] = P::load(src + ((long long)i * X + x) * ld + (long long)l * Y);
      }
  };
  // PREFETCH: the first row's first loads are in flight while the table is staged.
  Raw v[4];
  if (PREFETCH && active) load4(v, 0, x0);
  for (int i = tid; i < table_len; i += nthreads) tab[i] = table[i];
  __syncthreads();
  if (!active) return;

  const CoeffTable c(tab, R);
  for (int k = 0; k < rows; ++k) {
    const int x = x0 + k * blockDim.y;
    if (x >= X) break;
    for (int p0 = 0; p0 < np; p0 += 4) {
      if (!PREFETCH || k > 0 || p0 > 0) load4(v, p0, x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < np) mine[(p0 + j) * nthreads] = v[j];
    }
    T* dst = dst_g + (long long)x * Y;
    for (int r = 0; r < R; ++r) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      for (int t = c.row_ptr[r]; t < c.row_ptr[r + 1]; ++t) {
        float w[VEC];
        P::unpack(mine[c.part[t] * nthreads], w);
        const float cf = (float)c.coeff[t];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += cf * w[e];
      }
      *reinterpret_cast<Raw*>(dst + r * plane) = P::pack(acc);
    }
  }
}

template <typename T, int VEC>
static int launch(const void* in, void* out, const int* table, int table_len, int G, int R,
                  int d1, int d2, int X, int Y, int ty, int tx, int rows, int smem_bytes,
                  cudaStream_t s) {
  const size_t smem = combine_smem<T, VEC>(d1 * d2, ty * tx, table_len);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;  // planner drifted
  if (VEC > 1 && (Y % VEC || reinterpret_cast<uintptr_t>(in) % 16 ||
                  reinterpret_cast<uintptr_t>(out) % 16))
    return (int)cudaErrorInvalidValue;  // 16-byte accesses need both
  auto kernel =
      rows == 1 ? group_combine_kernel<T, VEC, true> : group_combine_kernel<T, VEC, false>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long gy = ((long long)X + (long long)tx * rows - 1) / ((long long)tx * rows);
  if (gy > 65535 || G > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(ty, tx);
  const dim3 grid((Y / VEC + ty - 1) / ty, (unsigned)gy, G);
  kernel<<<grid, block, smem, s>>>(static_cast<const T*>(in), static_cast<T*>(out), table,
                                   table_len, R, d1, d2, X, Y, rows);
  return (int)cudaGetLastError();
}

// in (G, d1*X, d2*Y) -> out (G, R, X, Y), both contiguous, same dtype; table
// (table_len ints) as CoeffTable. The block is (ty, tx) threads, ty along y
// in vectors of `vec` elements (16 / itemsize, or 1), tx along x, each thread
// `rows` rows; smem_bytes is the planner's, held to the kernel's layout.
extern "C" int falcon_group_combine(int device, const void* in, void* out, const void* table,
                                    int table_len, int dtype, int G, int R, int d1, int d2,
                                    int X, int Y, int vec, int ty, int tx, int rows,
                                    int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  if (dtype == FALCON_F32 && vec == 4)
    return launch<float, 4>(in, out, tab, table_len, G, R, d1, d2, X, Y, ty, tx, rows,
                            smem_bytes, s);
  if (dtype == FALCON_F32 && vec == 1)
    return launch<float, 1>(in, out, tab, table_len, G, R, d1, d2, X, Y, ty, tx, rows,
                            smem_bytes, s);
  if (dtype == FALCON_BF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(in, out, tab, table_len, G, R, d1, d2, X, Y, ty, tx, rows,
                                    smem_bytes, s);
  if (dtype == FALCON_BF16 && vec == 1)
    return launch<__nv_bfloat16, 1>(in, out, tab, table_len, G, R, d1, d2, X, Y, ty, tx, rows,
                                    smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
