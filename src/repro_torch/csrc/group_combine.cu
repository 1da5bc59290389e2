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
//
// The narrow route covers what 16-byte loads cannot: a Y that is no multiple
// of 16 bytes of elements (odd ones included: the attention's contractions
// over a padded key count) or a pointer that is not 16-byte aligned. There
// the d1*d2 parts of a row start at unrelated alignments (part (i, l) of row
// x at (i*X + x)*ld + l*Y), but each (g, r) output plane (X, Y) is
// contiguous. So a block owns `xb` rows x `yb` columns of one group: it
// stages every part's rows into shared memory (element loads, coalesced
// along y, eight in flight a thread, the first ones issued before the
// coefficient table is staged), part after part, each laid out as the
// output plane's piece and padded to whole 16-byte vectors. Then a thread
// takes one 16-byte chunk of the output's own 16-byte grid (a rank's piece
// is one contiguous run where yb = Y, else one run a row): the chunk sits at
// the same offset in every part's piece, so for each term it reads the two
// aligned vectors around it and picks its elements out (one switch on that
// offset serves the whole sum), sums in f32 in the table's order (the
// vector route's sums, term for term), rounds once and stores 16 bytes,
// masking only a run's first and last chunk. Blocks of 256 threads: these
// calls are small and latency-bound, and more warps finish a block sooner.
// Block shape, rows per thread and the vector width, or the narrow route's
// rows, columns and threads: kernels/tuning.py (plan_combine).
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
  if (Y % VEC || reinterpret_cast<uintptr_t>(in) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
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
// in vectors of `vec` elements (16 / itemsize), tx along x, each thread
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
  if (dtype == FALCON_BF16 && vec == 8)
    return launch<__nv_bfloat16, 8>(in, out, tab, table_len, G, R, d1, d2, X, Y, ty, tx, rows,
                                    smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The narrow route
// ---------------------------------------------------------------------------

constexpr int kNarrowBatch = 8;  // element loads a thread keeps in flight

// n / d for a divisor fixed for the whole block and n, d < 2^24: a product
// with the f32 reciprocal (off by at most one there), then corrected.
struct FastDiv {
  int d;
  float inv;
  __device__ __forceinline__ explicit FastDiv(int d_) : d(d_), inv(1.0f / (float)d_) {}
  __device__ __forceinline__ int div(int n) const {
    int q = __float2int_rz((float)n * inv);
    const int r = n - q * d;
    return q + (r >= d) - (r < 0);
  }
};

// Shared memory of one narrow block (kernels/tuning.py:combine_narrow_smem):
// a 16-byte guard, the d1*d2 parts' xb x yb pieces, each padded to whole
// 16-byte vectors, another guard, then the table. The guards take the
// aligned reads that reach past a piece's first or last vector.
template <typename T>
static size_t narrow_smem(int nparts, int xb, int yb, int table_len) {
  constexpr int V = 16 / sizeof(T);
  return 32 + (size_t)nparts * (((size_t)xb * yb + V - 1) / V * V) * sizeof(T) +
         (size_t)table_len * 4;
}

// Elements S..S+V-1 of the 2V elements in lo, hi, widened to f32 (S fixed).
template <int S>
__device__ __forceinline__ void pick(const float4& lo, const float4& hi, float* w) {
  const float e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = e[S + j];
}
template <int S>
__device__ __forceinline__ void pick(const uint4& lo, const uint4& hi, float* w) {
  const uint32_t e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t word = e[(S + j) / 2];
    w[j] = __uint_as_float((S + j) % 2 ? word & 0xffff0000u : word << 16);  // bf16 -> f32
  }
}

// One 16-byte output chunk of rank r: the sum over the rank's terms of c *
// (the part's V elements that start S past the aligned vector at `at`).
template <typename T, int S>
__device__ __forceinline__ void sum_terms(const CoeffTable& c, int r, const T* at, int pstride,
                                          float* acc) {
  using Raw = typename Pack<T, 16 / sizeof(T)>::Raw;
  for (int t = c.row_ptr[r]; t < c.row_ptr[r + 1]; ++t) {
    const Raw* v = reinterpret_cast<const Raw*>(at + c.part[t] * pstride);
    float w[16 / sizeof(T)];
    pick<S>(v[0], v[1], w);
    const float cf = (float)c.coeff[t];
#pragma unroll
    for (int j = 0; j < 16 / (int)sizeof(T); ++j) acc[j] += cf * w[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
group_combine_narrow_kernel(const T* __restrict__ in, T* __restrict__ out,
                            const int* __restrict__ table, int table_len, int R, int d1,
                            int d2, int X, int Y, int xb, int yb) {
  constexpr int V = 16 / sizeof(T);  // elements of one 16-byte vector
  extern __shared__ __align__(16) unsigned char gc_smem[];
  const int np = d1 * d2, nthreads = blockDim.x, tid = threadIdx.x;
  const int x0 = blockIdx.x * xb, y0 = blockIdx.y * yb;
  const int nx = min(xb, X - x0), ny = min(yb, Y - y0), cell = nx * ny;
  const int pstride = (cell + V - 1) / V * V;  // a part's piece, in whole vectors
  T* piece = reinterpret_cast<T*>(gc_smem + 16);  // [np][pstride], after the guard
  int* tab = reinterpret_cast<int*>(gc_smem + 32 +
                                    ((size_t)np * ((xb * yb + V - 1) / V * V) * sizeof(T)));
  const long long g = blockIdx.z;
  const long long ld = (long long)d2 * Y;  // row stride of the input
  const T* src = in + g * d1 * X * ld + (long long)x0 * ld + y0;
  const FastDiv by_cell(cell), by_ny(ny), by_d2(d2);

  // Element e of the staged pieces: part e / cell, row (e % cell) / ny,
  // column (e % cell) % ny; consecutive threads read consecutive columns.
  const int total = np * cell;
  T v[kNarrowBatch];
  auto gather = [&](int e0) {
#pragma unroll
    for (int j = 0; j < kNarrowBatch; ++j) {
      const int e = e0 + j * nthreads;
      if (e >= total) break;
      const int p = by_cell.div(e), rem = e - p * cell;
      const int xx = by_ny.div(rem), yy = rem - xx * ny;
      const int i = by_d2.div(p), l = p - i * d2;
      v[j] = src[((long long)i * X + xx) * ld + (long long)l * Y + yy];
    }
  };
  auto put = [&](int e0) {
#pragma unroll
    for (int j = 0; j < kNarrowBatch; ++j) {
      const int e = e0 + j * nthreads;
      if (e >= total) break;
      const int p = by_cell.div(e);
      piece[p * pstride + e - p * cell] = v[j];
    }
  };
  gather(tid);  // in flight while the table is staged
  for (int i = tid; i < table_len; i += nthreads) tab[i] = table[i];
  put(tid);
  for (int e0 = tid + kNarrowBatch * nthreads; e0 < total; e0 += kNarrowBatch * nthreads) {
    gather(e0);
    put(e0);
  }
  __syncthreads();

  // Runs: a rank's whole piece where it spans whole rows (yb == Y), else one
  // run per row. Chunk ci of a run is the ci-th 16-byte chunk of the output's
  // grid that the run touches; a run of n elements touches at most n / V + 2.
  const bool whole = ny == Y;
  const int runs = whole ? 1 : nx, run_len = whole ? cell : ny, cmax = run_len / V + 2;
  const FastDiv by_cmax(cmax), by_runs(runs);
  const CoeffTable c(tab, R);
  const long long grid0 = (long long)(reinterpret_cast<uintptr_t>(out) / sizeof(T));
  for (int q = tid; q < R * runs * cmax; q += nthreads) {
    const int qr = by_cmax.div(q), ci = q - qr * cmax;
    const int r = by_runs.div(qr), xr = qr - r * runs;
    const long long start = (g * R + r) * (long long)X * Y + (long long)(x0 + xr) * Y + y0;
    const long long a0 = grid0 + start;              // the run's first element on the grid
    const long long c0 = (a0 / V + ci) * V;          // this chunk's first
    const int off = (int)(c0 - a0);                  // its offset in the run (> -V)
    if (off >= run_len) continue;
    // The chunk's elements in part 0 start at xr * ny + off (> -V): read from
    // the aligned vector at or before it and the next one, S elements in.
    const int at = xr * ny + off + V, S = at % V;
    const T* base = piece - V + (at - S);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    switch (S) {
#define NARROW_CASE(k) \
  case k: sum_terms<T, k % V>(c, r, base, pstride, acc); break;
      NARROW_CASE(0) NARROW_CASE(1) NARROW_CASE(2) NARROW_CASE(3)
      NARROW_CASE(4) NARROW_CASE(5) NARROW_CASE(6) NARROW_CASE(7)
#undef NARROW_CASE
    }
    T* dst = out + (c0 - grid0);
    if (off >= 0 && off + V <= run_len) {
      *reinterpret_cast<typename Pack<T, V>::Raw*>(dst) = Pack<T, V>::pack(acc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (off + j >= 0 && off + j < run_len) dst[j] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T>
static int launch_narrow(const void* in, void* out, const int* table, int table_len, int G,
                         int R, int d1, int d2, int X, int Y, int xb, int yb, int threads,
                         int smem_bytes, cudaStream_t s) {
  const size_t smem = narrow_smem<T>(d1 * d2, xb, yb, table_len);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;  // planner drifted
  if (reinterpret_cast<uintptr_t>(out) % sizeof(T) || xb < 1 || yb < 1 || threads < 32 ||
      threads > 256 || threads % 32)
    return (int)cudaErrorInvalidValue;
  auto kernel = group_combine_narrow_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long gx = ((long long)X + xb - 1) / xb, gy = ((long long)Y + yb - 1) / yb;
  if (gx > 2147483647LL || gy > 65535 || G > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy, G);
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(in), static_cast<T*>(out), table,
                                     table_len, R, d1, d2, X, Y, xb, yb);
  return (int)cudaGetLastError();
}

// The narrow route: in (G, d1*X, d2*Y) -> out (G, R, X, Y), both contiguous,
// same dtype, any Y and any alignment; a block of `threads` threads owns xb
// rows x yb columns of one group; smem_bytes is the planner's.
extern "C" int falcon_group_combine_narrow(int device, const void* in, void* out,
                                           const void* table, int table_len, int dtype, int G,
                                           int R, int d1, int d2, int X, int Y, int xb, int yb,
                                           int threads, int smem_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  if (dtype == FALCON_F32)
    return launch_narrow<float>(in, out, tab, table_len, G, R, d1, d2, X, Y, xb, yb, threads,
                                smem_bytes, s);
  if (dtype == FALCON_BF16)
    return launch_narrow<__nv_bfloat16>(in, out, tab, table_len, G, R, d1, d2, X, Y, xb, yb,
                                        threads, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
