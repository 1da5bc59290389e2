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

// VEC elements of T moved as one access, widened to / rounded from f32: 16
// bytes (4 f32 or 8 bf16) on the vector routes of Group Combine and its
// quantizing form, one element on their scalar routes.
template <typename T, int VEC>
struct Pack;
template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw r, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float* v) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};
template <typename T>
struct Pack<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(Raw r, float* v) { v[0] = to_f32(r); }
  static __device__ __forceinline__ Raw pack(const float* v) { return from_f32<T>(v[0]); }
};

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

// out[i] = sum_s ws[s, i] in ascending s, rounded once to Tout: the second
// pass of a reduction split across blocks (the fused kernels of fused_tc.cuh,
// the tiled GEMM's tensor-core route). A fixed order and no atomics, so the
// result does not change from run to run.
template <typename Tout>
__global__ void split_reduce_kernel(const float* __restrict__ ws, Tout* __restrict__ out,
                                    long long count, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float a = ws[i];
    for (int s = 1; s < splits; ++s) a = __fadd_rn(a, ws[s * count + i]);
    out[i] = from_f32<Tout>(a);
  }
}

template <typename Tout>
static int launch_split_reduce(const float* ws, Tout* out, long long count, int splits,
                               cudaStream_t s) {
  const long long want = (count + 255) / 256, cap = 4LL * 132 * 8;
  const int blocks = (int)(want < cap ? want : cap);
  split_reduce_kernel<Tout><<<blocks, 256, 0, s>>>(ws, out, count, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* falcon_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
