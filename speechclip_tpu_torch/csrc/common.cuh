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

// f32 finfo.min: the reference's mask value (a fully masked row stays finite).
constexpr float kNegInf = -3.4028234663852886e38f;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int align128(int x) { return round_up(x, 128); }

// Operands of the attention kernels over (B, H, rows, Dh) bf16 tensors read
// and written through element strides (batch, head, row; the last is 1), so
// head-split views of a packed qkv buffer need no copy.
struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* lens;  // (B,) valid key lengths, or null
  __nv_bfloat16* out;
  int B, H, L, S, dh, causal;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];
};

// Fill AttnArgs from a launcher's plain C arguments; `strides` holds the
// (batch, head, row) strides of q, k, v and out, 12 values.
inline AttnArgs make_attn_args(const void* q, const void* k, const void* v,
                               const void* lens, void* out, int B, int H, int L,
                               int S, int dh, const long long* strides,
                               int causal, float scale) {
  AttnArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.lens = static_cast<const int*>(lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.H = H, a.L = L, a.S = S, a.dh = dh, a.causal = causal;
  a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  return a;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace scl
