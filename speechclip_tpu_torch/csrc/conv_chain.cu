// HuBERT's stride-2 conv chain (conv1..conv6: k = 3,3,3,3,2,2, VALID) with an
// exact-erf GELU after each layer, over bf16 (B, T, C) activations, sm_90a.
//
// Replaces: speechclip_tpu/kernels/conv_frontend.py (_chain_kernel, :74-140).
// The TPU kernel DMAs one 4112-row x 512 input window per (batch, 64-frame
// output block) into VMEM (4.2 MB) and keeps every intermediate on chip. A
// Hopper block has 227 KB, so here each layer is its own launch and the
// intermediates go through HBM (~2.7 GB read and written over the chain at
// (64, 20479, 512), ~0.8 ms at 3.35 TB/s, under the products once loads
// overlap them).
//
// What carries over is the TPU kernel's stride-2 fold (:105-134): x (T, C)
// viewed as x2 (T/2, 2C); a k = 2 layer is x2[:t_out] @ W, and a k = 3 layer
// adds x2[1:t_out+1, :C] @ W[2C:]. Both operands are plain boxes, which is
// what a TMA tensor map reads, so a layer is one GEMM (M = t_out rows per
// batch element, N = C_out, K = k*C_in) with no copy: its K loop walks the
// segments the wrapper describes (`kernels/conv_frontend.py`
// `fold_segments`), each a 3D map over x as (B, rows, cols) with a row
// stride of 2C: x2's full rows (2C wide, floor(T/2) of them) from row m0,
// then for k = 3 the first C columns from row m0 + 1, with ceil(T/2) rows so
// that an odd T's last input frame (half a row of x2) is read, and nothing
// of the next batch element. B is the (k*C_in, C_out) weight in the JAX WIO
// layout flattened, tap-major, read as it is (MN-major: the transpose-B bit).
//
// What bounds it on the H100: operations. 2 * B * sum(t_out * k) * C * C_out
// FLOP (2.0 TFLOP for 64 utterances of 6.4 s, 2.02 ms at 989 TFLOP/s)
// against ~2 GB moved by the largest layer; every layer is above the
// card's ~295 FLOP/byte ridge. The design, the layers' GEMM
// (gemm_epilogue.cu) made persistent per warpgroup:
//   - one block per SM walks tiles ordered (batch, M block, N tile), so the
//     two N tiles of an M block run on neighbouring SMs at once and x is
//     read from HBM about once; the 1.5 MB weight stays in L2. Tiles never
//     cross a batch element: the ragged last tile of each is zero-filled by
//     TMA and its stores are guarded;
//   - a producer warp keeps a ring of TMA stages (128-byte swizzle) full,
//     across tiles;
//   - the two consumer warpgroups ping-pong: each owns every other tile of
//     the block (a whole WM x BN tile, f32 accumulators in registers), and
//     an mbarrier pair hands the tensor cores from one to the other, so
//     one warpgroup's epilogue (GELU on the f32 sum) runs while the other
//     warpgroup's wgmmas run. The hand-over is also what keeps the ring's
//     phase parity sound: a warpgroup waits on a stage only after the
//     other has consumed the fill before it;
//   - the epilogue stages each warp's rows through shared memory and stores
//     16 bytes a lane, whole 128-byte lines.
// Warpgroup tiles: 64 x 256 (one m64n256k16 a k16 step) or 128 x 128 (two
// m64n128k16); the wrapper picks.
//
// What holds it below the bound (`chip_smoke.py --profile`,
// `scripts/torch_conv_epilogue_probe.py`): the card's power limit, as the
// chain keeps an H100 at 700 W with the SM clock at ~1.3-1.5 GHz where the
// bound's 989 TFLOP/s assume 1.83 GHz; and the GELU epilogue, which the
// ping-pong does not hide: beside the other warpgroup's wgmmas it idles the
// tensor cores, whatever its instruction count.
//
// Numerics follow the TPU kernel: bf16 operands (exact products), f32 sums,
// GELU on the f32 sum with the exact erf (erff, as torch's own GELU; the
// TPU uses the A&S polynomial, max error 1.5e-7: no faster here), one
// rounding to bf16 per layer.

#include "wgmma_tma.cuh"

namespace {

using namespace scl;

constexpr int BK = 64;        // one 128-byte swizzle row of bf16
constexpr int CHUNK = 64;     // columns of one B box (128 bytes)
constexpr int THREADS = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int STAGE_LD = 72;  // staging row stride (bf16): conflict-free pairs
constexpr int STAGING_BYTES = 8 * 16 * STAGE_LD * 2;  // 16 rows per consumer warp
constexpr int SMEM_LIMIT = 232448;                    // one block's shared memory
constexpr int CHUNK_BYTES = BK * CHUNK * 2;

// One consumer warpgroup's tile (WM rows x BN columns), the ring's stages
// as many as fit beside the staging area and the static barriers (256
// bytes), and 1 KB to align the ring to the swizzle atom (1024 bytes).
template <int WM, int BN>
struct Plan {
  static constexpr int A_BYTES = WM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;
  static constexpr int STAGES = (SMEM_LIMIT - 1024 - 256 - STAGING_BYTES) / STAGE_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + STAGING_BYTES + 1024;
};

struct ConvArgs {
  __nv_bfloat16* out;  // (batch, t_out, n)
  int t_out, n;
  int m_blocks, n_tiles, tiles;
  int n_k0, n_k;   // k-steps of segment 0, of both segments
  int off0, off1;  // each segment's first A row for output row 0
  int w0, w1;      // each segment's first weight row
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

template <int WM, int BN>
__device__ __forceinline__ void tile_coords(const ConvArgs& p, int tile, int& b, int& m0,
                                            int& n0) {
  const int r = tile / p.n_tiles;
  n0 = (tile - r * p.n_tiles) * BN;
  b = r / p.m_blocks;
  m0 = (r - b * p.m_blocks) * WM;
}

template <int WM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv_layer_kernel(const __grid_constant__ CUtensorMap map_a0,
                      const __grid_constant__ CUtensorMap map_a1,
                      const __grid_constant__ CUtensorMap map_b, const ConvArgs p) {
  using P = Plan<WM, BN>;
  constexpr int NS = P::STAGES;
  __shared__ __align__(8) uint64_t full[NS];
  __shared__ __align__(8) uint64_t empty[NS];
  __shared__ __align__(8) uint64_t turn[2];  // warpgroup w's mainloop of a tile is issued
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* staging = reinterpret_cast<__nv_bfloat16*>(smem + NS * P::STAGE_BYTES);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread fills the ring in tile order, across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        int b, m0, n0;
        tile_coords<WM, BN>(p, tile, b, m0, n0);
        for (int kt = 0; kt < p.n_k; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a_s = smem + stage * P::STAGE_BYTES;
          uint8_t* b_s = a_s + P::A_BYTES;
          const bool first = kt < p.n_k0;
          const int kk = (first ? kt : kt - p.n_k0) * BK;
          mbar_expect_tx(&full[stage], P::STAGE_BYTES);
          tma_load_3d(a_s, first ? &map_a0 : &map_a1, &full[stage], kk,
                      m0 + (first ? p.off0 : p.off1), b);
          const int wrow = (first ? p.w0 : p.w1) + kk;
#pragma unroll
          for (int c = 0; c < BN / CHUNK; ++c)
            tma_load(b_s + c * CHUNK_BYTES, &map_b, &full[stage], n0 + c * CHUNK, wrow);
          if (++stage == NS) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup `wg` takes the block's tiles wg, wg + 2, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    __nv_bfloat16* st = staging + (wg * 4 + warp) * 16 * STAGE_LD;
    int i = 0;  // this warpgroup's tiles so far
    for (int tile = blockIdx.x + wg * gridDim.x; tile < p.tiles; tile += 2 * gridDim.x, ++i) {
      int b, m0, n0;
      tile_coords<WM, BN>(p, tile, b, m0, n0);
      // The ring position of this tile's first stage: the block's tiles
      // fill it in turn, n_k stages each.
      const long long g0 = static_cast<long long>(2 * i + wg) * p.n_k;
      int stage = static_cast<int>(g0 % NS);
      uint32_t phase = static_cast<uint32_t>((g0 / NS) & 1);
      // Take the tensor cores once the other warpgroup's previous tile has
      // all its stages (its mainloop is issued).
      if (wg == 1) mbar_wait(&turn[0], i & 1);
      else if (i > 0) mbar_wait(&turn[1], (i - 1) & 1);

      float acc[WM / 64][BN / 2];
#pragma unroll
      for (int h = 0; h < WM / 64; ++h)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[h][e] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < p.n_k; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_s = smem_u32(smem + stage * P::STAGE_BYTES);
        const uint32_t b_s = a_s + P::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: 32 bytes per k16 step inside the swizzled 128-byte row, 8-row
          // groups 1024 bytes apart, 64-row halves 8 KB apart. B: 16 rows
          // (2048 bytes) per step, 64-column chunks CHUNK_BYTES apart.
#pragma unroll
          for (int h = 0; h < WM / 64; ++h)
            wgmma_bf16<BN>(acc[h], smem_desc(a_s + h * 8192 + kk * 32, 16, 1024),
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
      if (threadIdx.x % 128 == 0) mbar_arrive(&turn[wg]);
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < WM / 64; ++h) fence_regs(acc[h]);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // Epilogue, per 64-row half and 64-column chunk, through this warp's
      // staging rows: GELU of fragment pairs in (m64nBN fragment: register
      // 4j + {0,1} holds row warp*16 + lane/4, columns 8j + 2*(lane%4) +
      // {0,1}; 4j + {2,3} the row 8 below), then 16 bytes a lane out, each
      // store instruction writing 4 whole 128-byte lines.
      __nv_bfloat16* out_b = p.out + static_cast<size_t>(b) * p.t_out * p.n;
#pragma unroll
      for (int h = 0; h < WM / 64; ++h) {
        const int row0 = m0 + h * 64 + warp * 16;
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          if (n0 + c * 64 >= p.n) break;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = c * 8 + jj;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              __nv_bfloat16* dst = st + (lane / 4 + 8 * hh) * STAGE_LD + 8 * jj + 2 * (lane % 4);
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
                  gelu_erf(acc[h][4 * j + 2 * hh]), gelu_erf(acc[h][4 * j + 2 * hh + 1]));
            }
          }
          __syncwarp();
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = lane / 8 + 4 * q;
            const int lc = (lane % 8) * 8;
            const uint4 v = *reinterpret_cast<const uint4*>(st + r * STAGE_LD + lc);
            const int col = n0 + c * 64 + lc;
            if (row0 + r < p.t_out && col < p.n)
              *reinterpret_cast<uint4*>(out_b + static_cast<size_t>(row0 + r) * p.n + col) = v;
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int WM, int BN>
int launch(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& mb, ConvArgs p,
           int batch, cudaStream_t s) {
  using P = Plan<WM, BN>;
  static_assert(P::STAGES >= 3, "the ring needs at least 3 stages");
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(conv_layer_kernel<WM, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  p.m_blocks = (p.t_out + WM - 1) / WM;
  p.n_tiles = (p.n + BN - 1) / BN;
  const long long tiles = static_cast<long long>(batch) * p.m_blocks * p.n_tiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  conv_layer_kernel<WM, BN><<<grid, THREADS, P::SMEM, s>>>(a0, a1, mb, p);
  return static_cast<int>(cudaGetLastError());
}

// Tile ids: a consumer warpgroup's tile rows and columns.
constexpr int TILES[2][2] = {{64, 256}, {128, 128}};

}  // namespace

// One layer of the chain as a GEMM over the fold. x: bf16, 16-byte aligned;
// w: (k_rows, n) bf16 row-major; out: (batch, t_out, n) bf16. `seg` holds
// n_seg (1 or 2) segments of the K loop, 6 values each: rows, cols, row
// stride, batch stride (elements; the 3D view of x the segment's map
// reads), the A row of output row 0, the first weight row. tile: an index
// of TILES. Needs n % 8 == 0 and strides that are multiples of 8 elements
// (16-byte TMA strides).
extern "C" int scl_conv_chain_layer(const void* x, const void* w, void* out, int batch,
                                    int t_out, int k_rows, int n, int n_seg,
                                    const long long* seg, int tile, void* stream) {
  if (batch < 1 || t_out < 1 || k_rows < 1 || n < 8 || n % 8 || n_seg < 1 || n_seg > 2 ||
      tile < 0 || tile > 1 || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  int steps[2] = {0, 0};
  for (int i = 0; i < n_seg; ++i) {
    const long long* s = seg + 6 * i;
    if (s[0] < 1 || s[1] < 1 || s[2] % 8 || s[3] % 8 || s[4] < 0 || s[5] < 0 ||
        s[5] + s[1] > k_rows)
      return static_cast<int>(cudaErrorInvalidValue);
    cuuint64_t dims[3] = {static_cast<cuuint64_t>(s[1]), static_cast<cuuint64_t>(s[0]),
                          static_cast<cuuint64_t>(batch)};
    cuuint64_t strides[2] = {static_cast<cuuint64_t>(s[2]) * 2,
                             static_cast<cuuint64_t>(s[3]) * 2};
    cuuint32_t box[3] = {BK, static_cast<cuuint32_t>(TILES[tile][0]), 1};
    if (!scl::make_map(&maps[i], x, 3, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
    steps[i] = static_cast<int>((s[1] + BK - 1) / BK);
  }
  CUtensorMap mb;
  cuuint64_t wdims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k_rows)};
  cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(n) * 2};
  cuuint32_t wbox[2] = {CHUNK, BK};
  if (!scl::make_map(&mb, w, 2, wdims, wstrides, wbox))
    return static_cast<int>(cudaErrorInvalidValue);

  ConvArgs p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.t_out = t_out;
  p.n = n;
  p.n_k0 = steps[0];
  p.n_k = steps[0] + steps[1];
  p.off0 = static_cast<int>(seg[4]);
  p.w0 = static_cast<int>(seg[5]);
  p.off1 = n_seg > 1 ? static_cast<int>(seg[10]) : 0;
  p.w1 = n_seg > 1 ? static_cast<int>(seg[11]) : 0;
  const CUtensorMap& a1 = maps[n_seg - 1];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tile == 0 ? launch<64, 256>(maps[0], a1, mb, p, batch, st)
                   : launch<128, 128>(maps[0], a1, mb, p, batch, st);
}

// One block's shared memory (dynamic) and ring stages for a tile id.
extern "C" int scl_conv_chain_plan(int tile, int* stages) {
  if (tile == 0) {
    *stages = Plan<64, 256>::STAGES;
    return Plan<64, 256>::SMEM;
  }
  *stages = Plan<128, 128>::STAGES;
  return Plan<128, 128>::SMEM;
}
