// HuBERT's stride-2 conv chain (conv1..conv6: k = 3,3,3,3,2,2, VALID) with an
// exact-erf GELU after each layer, over bf16 (B, T, C) activations, sm_90a.
//
// Replaces: speechclip_tpu/kernels/conv_frontend.py (_chain_kernel, :74-140).
// The TPU kernel DMAs one 4112-row x 512 input window per (batch, 64-frame
// output block) into VMEM (4.2 MB) and keeps every intermediate on chip,
// folding each stride-2 layer into one MXU matmul: x (T, C) viewed as
// x2 (T/2, 2C), a k = 2 layer is x2[:t_out] @ W and a k = 3 layer adds
// x2[1:t_out+1, :C] @ W[2C:]. A Hopper block has 227 KB, so here each layer
// is its own launch and the intermediates go through HBM.
//
// The fold needs no copy at all: in the contiguous (T, C) rows, output frame
// t of a layer reads input rows 2t .. 2t+k-1, i.e. the k*C consecutive
// elements starting at element 2t*C. So a layer is one GEMM whose A operand
// is the input itself read with a row stride of 2C elements and a depth of
// K = k*C (rows overlap when k = 3), against the (k*C, C_out) weight in the
// JAX WIO layout flattened, tap-major. No im2col, no second product.
//
// Numerics follow the TPU kernel: bf16 operands (exact products), f32
// sums, GELU on the f32 sum with erff (the TPU uses the A&S polynomial,
// max error 1.5e-7), then one rounding to bf16 per layer.
//
// What bounds it on the H100: 2 * B * sum(T_i * k_i) * C * C_out FLOP (2.0
// TFLOP for 64 utterances of 6.4 s) against 1.34 GB of input: compute-bound
// at ~2 ms on the tensor cores. This first version is the repository's
// WMMA tile (128 x 128 x 32, 8 warps, 2-stage cp.async) with the A row
// stride and a per-batch offset; wgmma + TMA, and keeping the intermediates
// on chip with a halo, are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 64 x 32 outputs each

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// out[b, t, n] = gelu(sum_k x[b, 2t*C + k] * w[k, n]) for t < M, k < K = k*C.
__global__ void __launch_bounds__(THREADS)
    conv_layer_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int M, int N, int K,
                      long long lda, long long x_batch, long long out_batch) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * LDB];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const __nv_bfloat16* A = x + blockIdx.z * x_batch;
  __nv_bfloat16* C = out + blockIdx.z * out_batch;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 chunks of 8
      int c = tid + i * THREADS;
      int row = c / 4, kc = (c % 4) * 8;
      int gm = m0 + row, gk = k0 + kc;
      bool ok = gm < M && gk < K;
      const __nv_bfloat16* src = ok ? A + gm * lda + gk : A;
      scl::cp_async_16(&As[stage][row * LDA + kc], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: 32 rows x 16 chunks of 8
      int c = tid + i * THREADS;
      int row = c / 16, nc = (c % 16) * 8;
      int gk = k0 + row, gn = n0 + nc;
      bool ok = gk < K && gn < N;
      const __nv_bfloat16* src = ok ? w + (size_t)gk * N + gn : w;
      scl::cp_async_16(&Bs[stage][row * LDB + nc], src, ok);
    }
    scl::cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_k = (K + BK - 1) / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_k) {
      load_tile(stage ^ 1, (kt + 1) * BK);
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[stage][(wm * 64 + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[stage][kk * LDB + wn * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  // Epilogue: each warp stages one 16x16 f32 tile at a time; each lane then
  // owns 8 consecutive columns of one row (one 16-byte bf16 store).
  float* tile = scratch[warp];
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(tile, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c0;
      if (gm < M && gn < N) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = gelu_erf(tile[r * 16 + c0 + e]);
        *reinterpret_cast<uint4*>(C + (size_t)gm * N + gn) = scl::pack_bf16x8(v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// One layer of the chain: x (B, t_in, c_in) bf16 contiguous, w (k * c_in,
// c_out) bf16 contiguous, out (B, t_out, c_out) bf16 with t_out = (t_in -
// k) / 2 + 1. Needs c_in % 8 == 0 and c_out % 8 == 0 (16-byte rows).
extern "C" int scl_conv_chain_layer(const void* x, const void* w, void* out, int B,
                                    int t_in, int c_in, int c_out, int k, void* stream) {
  if (B < 1 || B > 65535 || k < 1 || t_in < k || c_in % 8 || c_out % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t_out = (t_in - k) / 2 + 1;
  dim3 grid((c_out + BN - 1) / BN, (t_out + BM - 1) / BM, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  conv_layer_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), t_out, c_out, k * c_in, 2LL * c_in,
      static_cast<long long>(t_in) * c_in, static_cast<long long>(t_out) * c_out);
  return static_cast<int>(cudaGetLastError());
}
