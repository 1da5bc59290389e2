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
// term, far below the card's ridge. Design: one thread per (x, y) element;
// a warp covers consecutive y, so every load and store is a coalesced row
// segment. The thread reads its d1*d2 co-located inputs exactly once into
// its own slice of shared memory (no other thread reads it, so no barrier)
// and then produces all R outputs from there. Coefficients come from a
// per-scheme CSR table: zero terms are skipped, |c| > 1 is scaled. The sum
// runs in f32 and is rounded once to the output type.
#include "common.cuh"

template <typename T>
__global__ void group_combine_kernel(const T* __restrict__ in, T* __restrict__ out,
                                     const int* __restrict__ table, int R, int d1,
                                     int d2, int X, int Y) {
  extern __shared__ float parts[];  // [d1*d2][threads]: one column per thread
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int x = blockIdx.y * blockDim.y + threadIdx.y;
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= X || y >= Y) return;  // ragged tile edge; the kernel has no barrier
  const long long g = blockIdx.z;
  const long long ld = (long long)d2 * Y;  // row stride of the input
  const T* src = in + g * d1 * X * ld;
  for (int i = 0; i < d1; ++i)
    for (int l = 0; l < d2; ++l)
      parts[(i * d2 + l) * nthreads + tid] =
          to_f32(src[(long long)(i * X + x) * ld + (long long)l * Y + y]);
  const CoeffTable c(table, R);
  const long long plane = (long long)X * Y;
  T* dst = out + g * R * plane + (long long)x * Y + y;
  for (int r = 0; r < R; ++r) {
    float acc = 0.f;
    for (int t = c.row_ptr[r]; t < c.row_ptr[r + 1]; ++t)
      acc += (float)c.coeff[t] * parts[c.part[t] * nthreads + tid];
    dst[r * plane] = from_f32<T>(acc);
  }
}

// in (G, d1*X, d2*Y) -> out (G, R, X, Y), both contiguous, same dtype.
// The block is (by, bx) threads: by along y, bx along x (kernels/tuning.py).
extern "C" int falcon_group_combine(int device, const void* in, void* out,
                                    const void* table, int dtype, int G, int R,
                                    int d1, int d2, int X, int Y, int bx, int by,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(by, bx);
  const dim3 grid((Y + by - 1) / by, (X + bx - 1) / bx, G);
  const size_t smem = (size_t)d1 * d2 * bx * by * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  if (dtype == FALCON_F32) {
    group_combine_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), tab, R, d1, d2, X, Y);
  } else if (dtype == FALCON_BF16) {
    group_combine_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out), tab, R,
        d1, d2, X, Y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
