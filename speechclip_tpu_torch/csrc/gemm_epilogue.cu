// bf16 GEMM with a fused epilogue, and a row LayerNorm, for sm_90a.
//
// Replaces: the matrix products inside speechclip_tpu/kernels/mha_block.py
// (_kernel: QKV projection and out-projection with residual + LayerNorm) and
// speechclip_tpu/kernels/ffn_block.py (_kernel: fc1 + GELU, fc2 + residual +
// LayerNorm). The TPU kernels keep all weights resident in 16 MB of VMEM and
// run one batch element per grid step; a Hopper block has at most 227 KB of
// shared memory, so here each product is its own launch over (M = B*T)-row
// tiles and the intermediates (qkv, attention output, the (B*T, F) FFN
// activation) go through HBM.
//
// What bounds it on the H100: at the main path's shapes (M = 64*319 rows,
// K, N in {768, 2304, 3072}) every product does 2*K/(2+2*K/N) FLOP per byte,
// i.e. several hundred, well above the card's ~295 FLOP/byte bf16 ridge, so
// it is bound by tensor-core issue rate. This first version uses warp-level
// mma.sync through WMMA (16x16x16 bf16, f32 accumulate) with a 2-stage
// cp.async pipeline; wgmma + TMA (the only path to the full bf16 rate) is
// later work.
//
// Numerics follow the TPU kernels: f32 accumulator, f32 bias added before
// any rounding; the GELU pre-activation is rounded to bf16 first and the
// tanh approximation applied in f32 (ffn_block.py:60-67); the residual is
// added in f32; LayerNorm statistics are f32 with var = mean((x - mean)^2).
//
// Layout: A (M, K) row-major bf16; B (K, N) row-major bf16, the JAX weight
// layout y = x @ w; bias (N,) f32; residual (M, N) bf16. Ragged M and N are
// masked here (zero-filled loads, guarded stores); the wrapper guarantees
// K % 8 == 0 and N % 8 == 0 (16-byte rows) and contiguous, aligned tensors.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDA = BK + 8;   // bf16 elements; +8 skews shared-memory banks
constexpr int LDB = BN + 8;
constexpr int THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 64 x 32 outputs each

enum Epilogue : int {
  kBias = 0,          // out bf16 = acc + bias
  kBiasGelu = 1,      // out bf16 = gelu_tanh(bf16(acc + bias))
  kBiasResidF32 = 2,  // out f32  = acc + bias + resid   (pre-LayerNorm row)
  kBiasResid = 3,     // out bf16 = acc + bias + resid
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
    gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ B,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ resid,
                     void* __restrict__ out, int M, int N, int K) {
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

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 chunks of 8
      int c = tid + i * THREADS;
      int row = c / 4, kc = (c % 4) * 8;
      int gm = m0 + row, gk = k0 + kc;
      bool ok = gm < M && gk < K;
      const __nv_bfloat16* src = ok ? A + (size_t)gm * K + gk : A;
      scl::cp_async_16(&As[stage][row * LDA + kc], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: 32 rows x 16 chunks of 8
      int c = tid + i * THREADS;
      int row = c / 16, nc = (c % 16) * 8;
      int gk = k0 + row, gn = n0 + nc;
      bool ok = gk < K && gn < N;
      const __nv_bfloat16* src = ok ? B + (size_t)gk * N + gn : B;
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
        const float4 b0 = *reinterpret_cast<const float4*>(bias + gn);
        const float4 b1 = *reinterpret_cast<const float4*>(bias + gn + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = tile[r * 16 + c0 + e] + bv[e];
        const size_t off = (size_t)gm * N + gn;
        if (EPI == kBiasGelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = gelu_tanh(__bfloat162float(__float2bfloat16_rn(v[e])));
        }
        if (EPI == kBiasResidF32 || EPI == kBiasResid) {
          float rv[8];
          scl::unpack_bf16x8(*reinterpret_cast<const uint4*>(resid + off), rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += rv[e];
        }
        if (EPI == kBiasResidF32) {
          float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
          o[0] = make_float4(v[0], v[1], v[2], v[3]);
          o[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) =
              scl::pack_bf16x8(v);
        }
      }
      __syncwarp();
    }
  }
}

// One warp per row: f32 statistics (two passes, as the reference's
// mean((x - mean)^2)), bf16 output. InT is float (the f32 pre-LN rows of the
// residual epilogue) or __nv_bfloat16 (the pre-norm input).
template <typename InT>
__global__ void layer_norm_kernel(const InT* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  __nv_bfloat16* __restrict__ out, int rows,
                                  int D, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const InT* xr = x + (size_t)row * D;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum += scl::to_f32(xr[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / D;
  float sq = 0.f;
  for (int c = lane; c < D; c += 32) {
    float d = scl::to_f32(xr[c]) - mean;
    sq += d * d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float inv = rsqrtf(sq / D + eps);
  __nv_bfloat16* orow = out + (size_t)row * D;
  for (int c = lane; c < D; c += 32)
    orow[c] = __float2bfloat16_rn((scl::to_f32(xr[c]) - mean) * inv * gamma[c] + beta[c]);
}

}  // namespace

extern "C" int scl_gemm_bf16(const void* a, const void* b, const void* bias,
                             const void* resid, void* out, int m, int n, int k,
                             int epilogue, void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto A = static_cast<const __nv_bfloat16*>(a);
  auto B = static_cast<const __nv_bfloat16*>(b);
  auto bi = static_cast<const float*>(bias);
  auto R = static_cast<const __nv_bfloat16*>(resid);
  switch (epilogue) {
    case kBias:
      gemm_bf16_kernel<kBias><<<grid, THREADS, 0, s>>>(A, B, bi, R, out, m, n, k);
      break;
    case kBiasGelu:
      gemm_bf16_kernel<kBiasGelu><<<grid, THREADS, 0, s>>>(A, B, bi, R, out, m, n, k);
      break;
    case kBiasResidF32:
      gemm_bf16_kernel<kBiasResidF32><<<grid, THREADS, 0, s>>>(A, B, bi, R, out, m, n, k);
      break;
    case kBiasResid:
      gemm_bf16_kernel<kBiasResid><<<grid, THREADS, 0, s>>>(A, B, bi, R, out, m, n, k);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scl_layer_norm(const void* x, int x_is_f32, const void* gamma,
                              const void* beta, void* out, int rows, int d,
                              float eps, void* stream) {
  const int rows_per_block = 8;
  dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto bt = static_cast<const float*>(beta);
  auto o = static_cast<__nv_bfloat16*>(out);
  if (x_is_f32) {
    layer_norm_kernel<float><<<grid, rows_per_block * 32, 0, s>>>(
        static_cast<const float*>(x), g, bt, o, rows, d, eps);
  } else {
    layer_norm_kernel<__nv_bfloat16><<<grid, rows_per_block * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, bt, o, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
