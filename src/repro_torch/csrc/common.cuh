// Shared helpers for the FalconGEMM Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes): a
// launch function that takes device pointers, sizes and the caller's stream,
// launches on that stream, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (kernels/build.py DTYPE_CODES)
enum FalconDtype { FALCON_F32 = 0, FALCON_BF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Coefficient table of one scheme tensor (U, V or W of shape (R, d1, d2)),
// built once per scheme by kernels/group_combine.py:coeff_table and cached on
// the device. int32, laid out as
//   row_ptr[R + 1] | part[nnz] | coeff[nnz]
// where rank r's nonzero terms are t in [row_ptr[r], row_ptr[r+1]), part[t] is
// the flattened (i * d2 + l) block index and coeff[t] the integer coefficient.
struct CoeffTable {
  const int* row_ptr;
  const int* part;
  const int* coeff;
  __device__ __forceinline__ CoeffTable(const int* table, int R)
      : row_ptr(table), part(table + R + 1), coeff(table + R + 1 + table[R]) {}
};

extern "C" const char* falcon_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
