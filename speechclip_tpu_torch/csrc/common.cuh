// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scl {

// 16-byte global -> shared copy through cp.async. When `valid` is false the
// destination is zero-filled (src-size 0) and `src` is never read, which is
// how every kernel here masks its ragged edges.
__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* src,
                                            bool valid) {
  uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Pack 8 floats into 8 bf16 (round to nearest even) for one 16-byte store.
__device__ __forceinline__ uint4 pack_bf16x8(const float* v) {
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

__device__ __forceinline__ void unpack_bf16x8(uint4 in, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

}  // namespace scl
