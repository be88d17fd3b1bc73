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
// i.e. several hundred, above the card's ~295 FLOP/byte bf16 ridge, so it is
// bound by the tensor cores' issue rate, which only wgmma reaches; the f32
// pre-LayerNorm output of the out-projection (K = 768) makes that product
// bound by its bytes instead. The design:
//   - one persistent block per SM walks 128 x BN output tiles (BN = 256, or
//     128 when N <= 128; 256 measured faster than 128 at every main-path
//     product, `chip_smoke.py --profile`) in row-major tile order, so the
//     blocks in flight share A rows and the weight stays in L2;
//   - a producer warp issues TMA loads (cp.async.bulk.tensor.2d, 128-byte
//     swizzle) of A (128 x 64) and B (64 x 64 boxes) into a ring of 4 stages
//     (3 beside a 256-wide residual tile) with full/empty mbarriers; it runs
//     ahead into the next tile while the consumers run the epilogue, so a
//     tile starts on a full ring;
//   - two consumer warpgroups each run wgmma.mma_async m64nBNk16 (f32
//     accumulators in registers, 232 of them after setmaxnreg) over 64 rows
//     of the tile, keeping one k-step's products in flight;
//   - A is K-major; B is read in the JAX weight layout, (K, N) row-major,
//     which is MN-major for wgmma: the transpose-B bit and an MN-major
//     descriptor (LBO = the 64-column chunk stride, SBO = 8 rows), so no
//     transposed copy of a weight is made;
//   - the epilogue is what a tile cannot overlap with its products, so it
//     waits on no global load and writes whole lines: the consumers copy
//     the tile's bias and residual into shared memory with cp.async while
//     the products run; the epilogue adds them to the accumulator fragments
//     in registers, then stages each warp's rows through shared memory in
//     128-byte chunks and stores 16 bytes a lane, four whole lines per
//     store instruction (storing fragment pairs straight from registers
//     touched 8 lines per instruction, half of each sector for bf16, and
//     took longer than the products at K = 768). TMA zero-fills loads past
//     M, N and K; the stores are guarded on ragged M and N. What is left
//     unhidden: the epilogue's own time (the f32 pre-LayerNorm stores, and
//     tanhf in fc1's GELU, ~25 instructions an element) does not overlap
//     the next tile's products, which a ping-pong of the two consumer
//     warpgroups over separate tiles would do.
//
// Numerics follow the TPU kernels: f32 accumulator, f32 bias added before
// any rounding; the GELU pre-activation is rounded to bf16 first and the
// tanh approximation applied in f32 with tanhf (ffn_block.py:60-67;
// tanh.approx.f32's ~2^-11 relative error would flip bf16 roundings); the
// residual is added in f32; LayerNorm statistics are f32 with
// var = mean((x - mean)^2), as a separate pass with 16-byte loads.
//
// Layout: A (M, K) row-major bf16; B (K, N) row-major bf16, the JAX weight
// layout y = x @ w; bias (N,) f32; residual (M, N) bf16. The wrapper
// guarantees K % 8 == 0 and N % 8 == 0 (16-byte TMA strides) and contiguous,
// 16-byte-aligned tensors. The tensor maps are encoded on the host for each
// call through the driver entry point, so the library needs no -lcuda.

#include <type_traits>

#include "wgmma_tma.cuh"

namespace {

using namespace scl;

constexpr int BM = 128;          // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 64;           // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;        // ring stages (3 beside a 256-wide residual tile)
constexpr int THREADS = 384;     // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int CHUNK = 64;        // columns of one B box (128 bytes)
constexpr int RESID_PAD = 8;     // bf16 elements of padding per residual row
constexpr int A_BYTES = BM * BK * 2;
constexpr int CHUNK_BYTES = BK * CHUNK * 2;

enum Epilogue : int {
  kBias = 0,          // out bf16 = acc + bias
  kBiasGelu = 1,      // out bf16 = gelu_tanh(bf16(acc + bias))
  kBiasResidF32 = 2,  // out f32  = acc + bias + resid   (pre-LayerNorm row)
  kBiasResid = 3,     // out bf16 = acc + bias + resid
};

__host__ __device__ constexpr bool has_resid(int epi) {
  return epi == kBiasResidF32 || epi == kBiasResid;
}
__host__ __device__ constexpr int stage_bytes(int bn) { return A_BYTES + BK * bn * 2; }
__host__ __device__ constexpr int stages(int epi, int bn) {
  return has_resid(epi) && bn == 256 ? STAGES - 1 : STAGES;
}
// Shared memory of one block: the ring, the tile's bias (f32), and for the
// epilogue either the residual tile (bf16, rows padded so the epilogue's
// reads hit distinct banks; each warp stages its output in its own rows of
// it once they are read) or, without a residual, a staging area of 16 rows
// x (64 + 8) bf16 per consumer warp; plus 1 KB to align the ring to the
// swizzle atom (1024 bytes).
__host__ __device__ constexpr int epilogue_bytes(int epi, int bn) {
  return has_resid(epi) ? BM * (bn + RESID_PAD) * 2 : 8 * 16 * 72 * 2;
}
__host__ __device__ constexpr int smem_bytes(int epi, int bn) {
  return stages(epi, bn) * stage_bytes(bn) + bn * 4 + epilogue_bytes(epi, bn) + 1024;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <int EPI, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const float* __restrict__ bias, const __nv_bfloat16* __restrict__ resid,
                     void* __restrict__ out, int M, int N, int K) {
  constexpr int NS = stages(EPI, BN);
  constexpr bool kResid = has_resid(EPI);
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* bias_s = reinterpret_cast<float*>(smem + NS * stage_bytes(BN));
  __nv_bfloat16* resid_s = reinterpret_cast<__nv_bfloat16*>(bias_s + BN);

  const int wg = threadIdx.x / 128;
  const int n_tiles_n = (N + BN - 1) / BN;
  const int n_tiles = ((M + BM - 1) / BM) * n_tiles_n;
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the ring full, across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles_n) * BM;
        const int n0 = (tile % n_tiles_n) * BN;
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a_s = smem + stage * stage_bytes(BN);
          uint8_t* b_s = a_s + A_BYTES;
          mbar_expect_tx(&full[stage], stage_bytes(BN));
          tma_load(a_s, &map_a, &full[stage], kt * BK, m0);
#pragma unroll
          for (int c = 0; c < BN / CHUNK; ++c)
            tma_load(b_s + c * CHUNK_BYTES, &map_b, &full[stage], n0 + c * CHUNK, kt * BK);
          if (++stage == NS) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup `wg` owns rows wg*64 .. wg*64+63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles_n) * BM;
      const int n0 = (tile % n_tiles_n) * BN;
      // The tile's bias and residual go to shared memory through cp.async
      // while the products run, so the epilogue waits on no global load.
      // The barrier keeps them until both warpgroups' previous epilogue is
      // done with the buffers.
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      for (int i = threadIdx.x; i < BN / 4; i += 256) {
        const bool ok = n0 + 4 * i < N;
        scl::cp_async_16(bias_s + 4 * i, ok ? bias + n0 + 4 * i : bias, ok);
      }
      if (kResid) {
        for (int i = threadIdx.x; i < BM * BN / 8; i += 256) {
          const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
          const bool ok = m0 + r < M && n0 + c < N;
          scl::cp_async_16(resid_s + r * (BN + RESID_PAD) + c,
                           ok ? resid + static_cast<size_t>(m0 + r) * N + n0 + c : resid, ok);
        }
      }
      scl::cp_async_commit();
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_s = smem_u32(smem + stage * stage_bytes(BN)) + wg * 64 * 128;
        const uint32_t b_s = smem_u32(smem + stage * stage_bytes(BN) + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: 32 bytes per k16 step inside the swizzled 128-byte row, 8-row
          // groups 1024 bytes apart. B: 16 rows (2048 bytes) per step, 64-col
          // chunks CHUNK_BYTES apart, 8-row groups 1024 bytes apart.
          wgmma_bf16<BN>(acc, smem_desc(a_s + kk * 32, 16, 1024),
                         smem_desc(b_s + kk * 2048, CHUNK_BYTES, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-step's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == NS) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      scl::cp_async_wait<0>();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");

      // Epilogue, in two passes. 1: in registers, bias (+ GELU) (+ residual)
      // with the TPU kernel's rounding points. Fragment layout of m64nBN:
      // register 4j + {0,1} holds row warp*16 + lane/4, cols 8j + 2*(lane%4)
      // + {0,1}; 4j + {2,3} the row 8 below.
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int lcol = 8 * j + 2 * (lane % 4);
        const float2 bv = *reinterpret_cast<const float2*>(bias_s + lcol);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v0 = acc[4 * j + 2 * h];
          float& v1 = acc[4 * j + 2 * h + 1];
          v0 += bv.x;
          v1 += bv.y;
          if (EPI == kBiasGelu) {
            v0 = gelu_tanh(__bfloat162float(__float2bfloat16_rn(v0)));
            v1 = gelu_tanh(__bfloat162float(__float2bfloat16_rn(v1)));
          }
          if (kResid) {
            const int lrow = wg * 64 + warp * 16 + lane / 4 + 8 * h;
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                resid_s + lrow * (BN + RESID_PAD) + lcol));
            v0 += r.x;
            v1 += r.y;
          }
        }
      }
      // 2: per chunk of 128-byte rows, through this warp's staging area (its
      // own residual rows, once read, or a buffer of its own): fragment
      // pairs in, then 16 bytes a lane out, each store instruction writing 4
      // whole 128-byte lines.
      using Out = typename std::conditional<EPI == kBiasResidF32, float, __nv_bfloat16>::type;
      constexpr int CW = 128 / sizeof(Out);  // columns of a chunk
      constexpr int LD = CW + 8;  // staging row stride (elements): conflict-free pairs
      __syncwarp();
      Out* st = kResid
                    ? reinterpret_cast<Out*>(resid_s + (wg * 64 + warp * 16) * (BN + RESID_PAD))
                    : reinterpret_cast<Out*>(resid_s) + (wg * 4 + warp) * 16 * LD;
      const int grow0 = m0 + wg * 64 + warp * 16;
#pragma unroll
      for (int c = 0; c < BN / CW; ++c) {
        if (n0 + c * CW >= N) break;
#pragma unroll
        for (int jj = 0; jj < CW / 8; ++jj) {
          const int j = c * CW / 8 + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Out* dst = st + (lane / 4 + 8 * h) * LD + 8 * jj + 2 * (lane % 4);
            if (EPI == kBiasResidF32) {
              *reinterpret_cast<float2*>(dst) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = lane / 8 + 4 * i;
          const int lc = (lane % 8) * (16 / sizeof(Out));
          const uint4 v = *reinterpret_cast<const uint4*>(st + r * LD + lc);
          const int col = n0 + c * CW + lc;
          if (grow0 + r < M && col < N)
            *reinterpret_cast<uint4*>(static_cast<Out*>(out) +
                                      static_cast<size_t>(grow0 + r) * N + col) = v;
        }
        __syncwarp();
      }
    }
  }
}

// One warp per row, 8 elements (16 or 32 bytes) per lane per step: f32
// statistics (two passes, as the reference's mean((x - mean)^2)), bf16
// output. InT is float (the f32 pre-LN rows of the residual epilogue) or
// __nv_bfloat16 (the pre-norm input). D % 8 == 0.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  scl::unpack_bf16x8(*reinterpret_cast<const uint4*>(p), v);
}

template <typename InT>
__global__ void layer_norm_kernel(const InT* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  __nv_bfloat16* __restrict__ out, int rows,
                                  int D, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const InT* xr = x + static_cast<size_t>(row) * D;
  float v[8];
  float sum = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  }
  const float mean = scl::warp_sum(sum) / D;
  float sq = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq += (v[e] - mean) * (v[e] - mean);
  }
  const float inv = rsqrtf(scl::warp_sum(sq) / D + eps);
  __nv_bfloat16* orow = out + static_cast<size_t>(row) * D;
  for (int c = lane * 8; c < D; c += 256) {
    float g[8], b[8];
    load8(xr + c, v);
    load8(gamma + c, g);
    load8(beta + c, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean) * inv * g[e] + b[e];
    *reinterpret_cast<uint4*>(orow + c) = scl::pack_bf16x8(v);
  }
}

// A 2D bf16 map of a (rows, cols) row-major tensor, boxes of box_rows x
// box_cols with 128-byte swizzle (box_cols * 2 <= 128); loads past the
// edges are zero-filled.
bool make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                 int box_cols) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return scl::make_map(map, ptr, 2, dims, strides, box);
}

template <int EPI, int BN>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const float* bias,
           const __nv_bfloat16* resid, void* out, int m, int n, int k, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes(EPI, BN));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_bf16_kernel<EPI, BN><<<grid, THREADS, smem_bytes(EPI, BN), s>>>(ma, mb, bias, resid,
                                                                       out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int dispatch(int epilogue, const CUtensorMap& ma, const CUtensorMap& mb, const float* bias,
             const __nv_bfloat16* resid, void* out, int m, int n, int k, cudaStream_t s) {
  switch (epilogue) {
    case kBias: return launch<kBias, BN>(ma, mb, bias, resid, out, m, n, k, s);
    case kBiasGelu: return launch<kBiasGelu, BN>(ma, mb, bias, resid, out, m, n, k, s);
    case kBiasResidF32: return launch<kBiasResidF32, BN>(ma, mb, bias, resid, out, m, n, k, s);
    case kBiasResid: return launch<kBiasResid, BN>(ma, mb, bias, resid, out, m, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// block_n: the tile's columns, 128 or 256 (0: 128 when N <= 128, else 256).
extern "C" int scl_gemm_bf16_tiled(const void* a, const void* b, const void* bias,
                                   const void* resid, void* out, int m, int n, int k,
                                   int epilogue, int block_n, void* stream) {
  if (m < 0 || n <= 0 || k <= 0 || n % 8 || k % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  if (block_n == 0) block_n = n <= 128 ? 128 : 256;
  if (block_n != 128 && block_n != 256) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  if (!make_map_2d(&ma, a, m, k, BM, BK) || !make_map_2d(&mb, b, k, n, BK, CHUNK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto bi = static_cast<const float*>(bias);
  auto R = static_cast<const __nv_bfloat16*>(resid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return block_n == 256 ? dispatch<256>(epilogue, ma, mb, bi, R, out, m, n, k, s)
                        : dispatch<128>(epilogue, ma, mb, bi, R, out, m, n, k, s);
}

extern "C" int scl_gemm_bf16(const void* a, const void* b, const void* bias,
                             const void* resid, void* out, int m, int n, int k,
                             int epilogue, void* stream) {
  return scl_gemm_bf16_tiled(a, b, bias, resid, out, m, n, k, epilogue, 0, stream);
}

extern "C" int scl_gemm_smem_bytes(int epilogue, int block_n) {
  return smem_bytes(epilogue, block_n);
}

extern "C" int scl_layer_norm(const void* x, int x_is_f32, const void* gamma,
                              const void* beta, void* out, int rows, int d,
                              float eps, void* stream) {
  if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
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
