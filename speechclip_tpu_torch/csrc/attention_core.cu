// Length-masked multi-head attention core over a fused qkv buffer, sm_90a.
//
// Replaces: the per-head loop of speechclip_tpu/kernels/mha_block.py
// (_kernel, :97-119): scores = q k^T / sqrt(Dh) in f32, keys at
// col >= lens[b] set to f32 finfo.min, f32 softmax with the denominator
// clamped at 1e-30, weights rounded to bf16, P @ V accumulated in f32 and
// rounded to bf16. The TPU kernel holds one batch element's whole (T, 3D)
// qkv and each head's (T, T) scores in VMEM; here one block owns one
// (batch, head, 64-query tile) and holds that tile's whole key row on chip,
// so the scores never touch HBM and no online-softmax rescaling is needed.
//
// What bounds it on the H100: per block, 2 * 64 * S * Dh * 2 FLOP against
// (64 + 2 S) * Dh * 2 bytes read, ~50 FLOP/byte at S = 320, Dh = 64..96 —
// below the ~295 FLOP/byte ridge, so HBM traffic for K and V (re-read once
// per query tile) and shared-memory capacity bound it. The f32 score tile
// (64 x S) dominates shared memory (80 KB at S = 320), which allows one
// block per SM. The design keeps the f32 scores and bf16 probabilities in
// ONE buffer (each row's bf16 weights are written over the front half of
// its own f32 row once the warp holds the row in registers) and reuses the
// K buffer for V, so T = 320, Dh = 96 needs 163 KB, not 250 KB.
//
// Layout: qkv (B*T, 3D) bf16 with q | k | v column blocks, head h at
// columns h*Dh..(h+1)*Dh of each; out (B*T, D) bf16; lens (B,) int32 or
// null. Requirements checked by the wrapper: Dh % 16 == 0, D % 8 == 0,
// ceil16(T) <= 512 and the shared-memory total <= 227 KB.

#include <float.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int THREADS = 128; // 4 warps
constexpr int MAX_J = 16;    // softmax registers per lane: S <= 32 * 16

__host__ __device__ inline int align128(int x) { return (x + 127) / 128 * 128; }
__host__ __device__ inline int seq_pad(int T) { return (T + 15) / 16 * 16; }

struct Smem {
  int q, kv, s, scratch, total;
  __host__ __device__ Smem(int T, int dh) {
    const int ldq = dh + 8, sp = seq_pad(T), lds = sp + 4;
    q = 0;
    kv = q + align128(BQ * ldq * 2);
    s = kv + align128(sp * ldq * 2);
    scratch = s + align128(BQ * lds * 4);
    total = scratch + (THREADS / 32) * 16 * 16 * 4;
  }
};

__global__ void __launch_bounds__(THREADS)
    attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
                     int T, int D, int dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem lay(T, dh);
  const int ldq = dh + 8, sp = seq_pad(T), lds = sp + 4, ldp = 2 * lds;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  __nv_bfloat16* KVs = reinterpret_cast<__nv_bfloat16*>(smem + lay.kv);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.s);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int len = lens ? lens[b] : T;
  const size_t row_stride = 3 * (size_t)D;
  const __nv_bfloat16* base = qkv + (size_t)b * T * row_stride + h * dh;
  const int chunks = dh / 8;  // 16-byte chunks per head row

  // Q tile and the whole K row of this head; rows past T are zero-filled.
  for (int i = tid; i < BQ * chunks; i += THREADS) {
    int r = i / chunks, c = (i % chunks) * 8;
    bool ok = q0 + r < T;
    scl::cp_async_16(&Qs[r * ldq + c], ok ? base + (q0 + r) * row_stride + c : qkv, ok);
  }
  for (int i = tid; i < sp * chunks; i += THREADS) {
    int r = i / chunks, c = (i % chunks) * 8;
    bool ok = r < T;
    scl::cp_async_16(&KVs[r * ldq + c], ok ? base + r * row_stride + D + c : qkv, ok);
  }
  scl::cp_async_commit();
  scl::cp_async_wait<0>();
  __syncthreads();

  // S = Q K^T (f32), one 16x16 tile per warp iteration.
  const int n_ct = sp / 16;
  for (int t = warp; t < (BQ / 16) * n_ct; t += THREADS / 32) {
    const int rt = t / n_ct, ct = t % n_ct;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < dh; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kt;
      wmma::load_matrix_sync(a, &Qs[rt * 16 * ldq + kk], ldq);
      wmma::load_matrix_sync(kt, &KVs[ct * 16 * ldq + kk], ldq);
      wmma::mma_sync(acc, a, kt, acc);
    }
    wmma::store_matrix_sync(&Ss[rt * 16 * lds + ct * 16], acc, lds, wmma::mem_row_major);
  }
  __syncthreads();  // K is dead: stream V into its buffer under the softmax

  for (int i = tid; i < sp * chunks; i += THREADS) {
    int r = i / chunks, c = (i % chunks) * 8;
    bool ok = r < T;
    scl::cp_async_16(&KVs[r * ldq + c], ok ? base + r * row_stride + 2 * D + c : qkv, ok);
  }
  scl::cp_async_commit();

  // Row softmax, one warp per row. Keys past T (tile padding) get weight 0;
  // masked keys get finfo.min, so a fully masked row averages all T keys,
  // as the reference does.
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float v[MAX_J];
    float m = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < MAX_J; ++j) {
      const int col = lane + 32 * j;
      float s = -FLT_MAX;
      if (col < T) {
        s = Ss[r * lds + col] * scale;
        if (col >= len) s = -FLT_MAX;
        m = fmaxf(m, s);
      }
      v[j] = s;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_J; ++j) {
      const int col = lane + 32 * j;
      v[j] = col < T ? expf(v[j] - m) : 0.f;
      sum += v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float denom = fmaxf(sum, 1e-30f);
    __syncwarp();  // every lane has read its f32 row before it is overwritten
#pragma unroll
    for (int j = 0; j < MAX_J; ++j) {
      const int col = lane + 32 * j;
      if (col < sp) Ps[r * ldp + col] = __float2bfloat16_rn(v[j] / denom);
    }
  }
  scl::cp_async_wait<0>();
  __syncthreads();

  // O = P V (f32 accumulate), rounded to bf16 into this head's columns.
  float* tile = scratch + warp * 256;
  const int n_ot = dh / 16;
  for (int t = warp; t < (BQ / 16) * n_ot; t += THREADS / 32) {
    const int rt = t / n_ot, ct = t % n_ot;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < sp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> p;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
      wmma::load_matrix_sync(p, &Ps[rt * 16 * ldp + kk], ldp);
      wmma::load_matrix_sync(vf, &KVs[kk * ldq + ct * 16], ldq);
      wmma::mma_sync(acc, p, vf, acc);
    }
    wmma::store_matrix_sync(tile, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const int r = lane / 2, c0 = (lane % 2) * 8;
    const int gq = q0 + rt * 16 + r;
    if (gq < T) {
      __nv_bfloat16* dst = out + ((size_t)b * T + gq) * D + h * dh + ct * 16 + c0;
      *reinterpret_cast<uint4*>(dst) = scl::pack_bf16x8(&tile[r * 16 + c0]);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int scl_attention_smem_bytes(int T, int dh) { return Smem(T, dh).total; }

extern "C" int scl_attention(const void* qkv, const void* lens, void* out, int B,
                             int T, int D, int heads, void* stream) {
  const int dh = D / heads;
  if (dh % 16 != 0 || D % 8 != 0 || seq_pad(T) > 32 * MAX_J)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Smem(T, dh).total;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + BQ - 1) / BQ, heads, B);
  attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), T, D, dh, 1.0f / sqrtf(static_cast<float>(dh)));
  return static_cast<int>(cudaGetLastError());
}
