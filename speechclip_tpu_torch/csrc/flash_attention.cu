// Streaming attention with an online softmax over head-split (B, H, rows, Dh)
// bf16 tensors, sm_90a: the kernel of the "pallas" attention backend; and its
// f32 form (flash_f32_kernel, at the end) for f32 operands.
//
// Replaces: speechclip_tpu/kernels/flash_attention.py (_flash_kernel,
// :38-114). The TPU kernel streams 128-key blocks through VMEM for each
// (batch*head, 128-query block) cell in f32 throughout: running row max m
// (from f32 finfo.min), running sum l of the UNROUNDED p, acc += p v, and
// out = acc / max(l, 1e-30) rounded once; masks col < S, col < lens and, when
// causal, col <= row; blocks wholly above the diagonal are skipped. It pads
// Dh to 128 and L, S to multiples of 128; that padding does not change the
// result (except that a row with no valid key divides by the padded S), and
// is not copied.
//
// Rounding points kept here:
//   Q K^T: bf16 operands, f32 accumulation; the inputs are bf16, so every
//     product is exact and only the summation order differs from f32. The
//     scale is applied to the f32 scores (the TPU scales the f32 q first:
//     one more f32 rounding there, of relative size 2^-24).
//   P V: p is split as p = hi + lo with hi = bf16(p) and lo = bf16(p - hi),
//     and both halves go through the tensor cores against the exact bf16 v,
//     so p carries 16 significant bits (relative error <= 2^-17), close to
//     the TPU's f32 P V.
//
// Heads up to 128 wide: flash_kernel<Dh_pad>, the FlashAttention-2 layout of
// csrc/attention_tiles.cuh (16 query rows per warp, 4 warps per 64-query
// tile, 64-key K/V blocks through two cp.async stages, mma.sync with the
// score fragments reused as P operands in registers, ldmatrix fragments).
// Rows of at most 128 take one block per (batch, head) with one warp per
// 16-row slab (1 warp for the cascaded tail's K + 2 = 10 tokens, 5 for the
// CLIP text tower's 77), so no second tile re-reads K and V for a ragged
// edge. Warps whose rows all lie past L, or (causal) above a key block,
// skip its math. What bounds it on the H100: 6 * 64 * S * Dh tensor-core
// FLOP per block (Q K^T once, P V twice for the split) against (64 + 2 S) *
// Dh * 2 bytes of K/V per query tile, ~95 FLOP/byte from L2: below the
// ridge, so K/V reuse in the 50 MB L2 and latency hiding (87 KB of shared
// memory at Dh = 128, 2 blocks per SM) bound it; at the flash backend's
// (64, 12, 319, 64) it reaches ~25 % of its bytes bound on the device.
//
// Wider heads (the cascaded branch's single 768-wide head) take two passes,
// because a 64 x 768 K or V stage (96 KB) and a row's 768 f32 accumulators
// do not fit one block. Output columns must then be cut into chunks, and a
// block per chunk that formed its own full-width scores would recompute
// Q K^T once per chunk (6x at Dh = 768: ~63 GFLOP executed for a function
// that needs ~16). So Q K^T is computed once per (query tile, key block):
//   wide_scores_kernel: one block per (batch, head, 64-query tile, 64-key
//     block) sums Q K^T over 64-wide Dh chunks (two cp.async stages of Q and
//     K chunks), scales and masks it exactly as the narrow kernel does, and
//     writes the f32 tile to a scratch (B, H, ceil64(L), ceil64(S)) buffer;
//   wide_pv_kernel: one block per (batch, head, 64-query tile, 128-wide
//     output chunk) streams those score tiles and its V columns through two
//     stages and runs the narrow kernel's online softmax and split P V.
// Every output chunk reads the same f32 scores, so all of a row's chunks see
// bit-identical m and l. The scratch (27 MB of live scores at the cascaded
// shape, (64, 1, 327, 768)) stays in the 50 MB L2 while the six chunk blocks
// of a query tile, adjacent in the grid, read it. The alternative, a cluster
// of one block per Dh chunk summing partial scores through distributed
// shared memory, was not built: each block would read all six 16 KB partials
// of every key block across the SM-to-SM network (~1.1 GB at that shape),
// several times the L2 traffic of the scratch. Any Dh % 8 == 0 runs, with no
// limit from a cluster size. At (64, 1, 327, 768) the two passes take ~0.19
// ms on the device, ~20 % of the bytes bound (0.038 ms). Numbers: PERF.md.

#include "attention_tiles.cuh"

namespace {

constexpr int BQ = scl::kTileQ;
constexpr int BK = scl::kTileK;
constexpr int THREADS = scl::kTileThreads;
constexpr int SHORT_ROWS = 128;       // rows a narrow block may take whole
constexpr int MAX_THREADS = SHORT_ROWS * 2;  // 8 warps of 16 rows

// One block of blockDim.x / 32 warps (4; for L <= 128, one per 16-row slab
// of L, so a short row is one block per head) owns a query tile of 16 rows
// per warp.
template <int DK>
__global__ void __launch_bounds__(MAX_THREADS) flash_kernel(scl::AttnArgs a) {
  constexpr int LD = DK + 8;  // shared row stride (bf16 elements)
  constexpr int NK = DK / 16, NO = DK / 8;
  const int tq = blockDim.x / 2;  // query rows per block: 16 per warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + tq * LD;      // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * tq, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, L = a.L, dh = a.dh;
  const int len = a.lens ? min(a.lens[b], S) : S;
  const __nv_bfloat16* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const __nv_bfloat16* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const __nv_bfloat16* vb = a.v + b * a.vs[0] + h * a.vs[1];
  const int n_blocks = scl::key_blocks(S, len, a.causal, q0, L, tq);
  const bool live = q0 + warp * 16 < L;
  const int row0 = q0 + warp * 16 + lane / 4;

  scl::load_tile<DK>(Qs, qb + q0 * a.qs[2], a.qs[2], 0, L - q0, dh, tq);
  scl::load_tile<DK>(Ks, kb, a.ks[2], 0, S, dh);
  scl::load_tile<DK>(Vs, vb, a.vs[2], 0, S, dh);
  scl::cp_async_commit();

  uint32_t qf[NK][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = scl::kNegInf, m1 = scl::kNegInf, l0 = 0.f, l1 = 0.f;

  for (int kbk = 0; kbk < n_blocks; ++kbk) {
    if (kbk + 1 < n_blocks) {
      const int nxt = (kbk + 1) & 1;
      scl::load_tile<DK>(Ks + nxt * BK * LD, kb, a.ks[2], (kbk + 1) * BK, S, dh);
      scl::load_tile<DK>(Vs + nxt * BK * LD, vb, a.vs[2], (kbk + 1) * BK, S, dh);
      scl::cp_async_commit();
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();
    // causal: a block wholly above the warp's rows adds exact zeros (key 0 is
    // valid for every row when len > 0, so m is already finite)
    const bool above = a.causal && len > 0 && kbk * BK > q0 + warp * 16 + 15;
    if (live && !above) {
      if (kbk == 0) scl::load_a<DK, LD>(qf, Qs + warp * 16 * LD, lane);
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      scl::qk_block<DK, LD>(s, qf, Ks + (kbk & 1) * BK * LD, lane);
      scl::mask_scores(s, a.scale, kbk, S, len, a.causal, row0, lane);
      scl::online_softmax<NO>(s, acc, m0, m1, l0, l1);
      uint32_t hi[4][4], lo[4][4];
      scl::p_frags_split(hi, lo, s);
      scl::pv_block<DK, LD, true>(acc, hi, lo, Vs + (kbk & 1) * BK * LD, lane);
    }
    __syncthreads();  // this stage is refilled two blocks from now
  }

  if (live) {
    const float d0 = fmaxf(scl::quad_sum(l0), 1e-30f), d1 = fmaxf(scl::quad_sum(l1), 1e-30f);
    scl::store_rows<NO>(a.out + b * a.os[0] + h * a.os[1], a.os[2], acc, d0, d1, row0, L, 0,
                        dh, lane);
  }
}

constexpr int DC1 = 64;   // head-dim chunk of the score pass
constexpr int DC = 128;   // output-column chunk of the P V pass
constexpr int LDS = BK + 8;  // f32 row stride of a shared score tile

__global__ void __launch_bounds__(THREADS)
    wide_scores_kernel(scl::AttnArgs a, float* scores, int n_kb, int ld_rows, int ld_cols) {
  constexpr int LD = DC1 + 8, TILE = BK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 stages
  __nv_bfloat16* Ks = Qs + 2 * TILE;                             // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (blockIdx.x / n_kb) * BQ, kbk = blockIdx.x % n_kb;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, L = a.L, dh = a.dh;
  const int len = a.lens ? min(a.lens[b], S) : S;
  if (kbk >= scl::key_blocks(S, len, a.causal, q0, L)) return;  // no P V reads it
  const __nv_bfloat16* qb = a.q + b * a.qs[0] + h * a.qs[1] + q0 * a.qs[2];
  const __nv_bfloat16* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const bool live = q0 + warp * 16 < L;
  const int row0 = q0 + warp * 16 + lane / 4;
  const int steps = (dh + DC1 - 1) / DC1;

  auto load_step = [&](int c) {
    scl::load_tile<DC1>(Qs + (c & 1) * TILE, qb + c * DC1, a.qs[2], 0, L - q0, dh - c * DC1);
    scl::load_tile<DC1>(Ks + (c & 1) * TILE, kb + c * DC1, a.ks[2], kbk * BK, S, dh - c * DC1);
    scl::cp_async_commit();
  };
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  load_step(0);
  for (int c = 0; c < steps; ++c) {
    if (c + 1 < steps) {
      load_step(c + 1);
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      uint32_t qf[DC1 / 16][4];
      scl::load_a<DC1, LD>(qf, Qs + (c & 1) * TILE + warp * 16 * LD, lane);
      scl::qk_block<DC1, LD>(s, qf, Ks + (c & 1) * TILE, lane);
    }
    __syncthreads();
  }
  if (!live) return;
  scl::mask_scores(s, a.scale, kbk, S, len, a.causal, row0, lane);
  float* out = scores + ((static_cast<long long>(b) * a.H + h) * ld_rows + row0) * ld_cols +
               kbk * BK + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + j * 8) = make_float2(s[j][0], s[j][1]);
    *reinterpret_cast<float2*>(out + 8LL * ld_cols + j * 8) = make_float2(s[j][2], s[j][3]);
  }
}

__global__ void __launch_bounds__(THREADS)
    wide_pv_kernel(scl::AttnArgs a, const float* scores, int n_chunks, int ld_rows,
                   int ld_cols) {
  constexpr int LDV = DC + 8, NO = DC / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem);                              // 2 stages
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(Ss + 2 * BQ * LDS);  // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (blockIdx.x / n_chunks) * BQ, oc0 = (blockIdx.x % n_chunks) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, L = a.L, dh = a.dh;
  const int len = a.lens ? min(a.lens[b], S) : S;
  const int n_blocks = scl::key_blocks(S, len, a.causal, q0, L);
  const float* sb = scores + ((static_cast<long long>(b) * a.H + h) * ld_rows + q0) * ld_cols;
  const __nv_bfloat16* vb = a.v + b * a.vs[0] + h * a.vs[1] + oc0;
  const bool live = q0 + warp * 16 < L;
  const int row0 = q0 + warp * 16 + lane / 4;

  auto load_block = [&](int kbk) {
    float* dst = Ss + (kbk & 1) * BQ * LDS;
    for (int i = threadIdx.x; i < BQ * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      scl::cp_async_16(&dst[r * LDS + c], sb + r * static_cast<long long>(ld_cols) + kbk * BK + c,
                       true);
    }
    scl::load_tile<DC>(Vs + (kbk & 1) * BK * LDV, vb, a.vs[2], kbk * BK, S, dh - oc0);
    scl::cp_async_commit();
  };

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = scl::kNegInf, m1 = scl::kNegInf, l0 = 0.f, l1 = 0.f;

  load_block(0);
  for (int kbk = 0; kbk < n_blocks; ++kbk) {
    if (kbk + 1 < n_blocks) {
      load_block(kbk + 1);
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* sr = Ss + (kbk & 1) * BQ * LDS + (warp * 16 + lane / 4) * LDS + (lane % 4) * 2;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 x0 = *reinterpret_cast<const float2*>(sr + j * 8);
        const float2 x1 = *reinterpret_cast<const float2*>(sr + 8 * LDS + j * 8);
        s[j][0] = x0.x, s[j][1] = x0.y, s[j][2] = x1.x, s[j][3] = x1.y;
      }
      scl::online_softmax<NO>(s, acc, m0, m1, l0, l1);
      uint32_t hi[4][4], lo[4][4];
      scl::p_frags_split(hi, lo, s);
      scl::pv_block<DC, LDV, true>(acc, hi, lo, Vs + (kbk & 1) * BK * LDV, lane);
    }
    __syncthreads();  // this stage is refilled two blocks from now
  }

  if (live) {
    const float d0 = fmaxf(scl::quad_sum(l0), 1e-30f), d1 = fmaxf(scl::quad_sum(l1), 1e-30f);
    scl::store_rows<NO>(a.out + b * a.os[0] + h * a.os[1], a.os[2], acc, d0, d1, row0, L, oc0,
                        dh, lane);
  }
}

constexpr int kScoresSmem = 4 * BK * (DC1 + 8) * 2;
constexpr int kPvSmem = 2 * BQ * LDS * 4 + 2 * BK * (DC + 8) * 2;

int launch_wide(const scl::AttnArgs& a, float* scores, cudaStream_t stream) {
  const int n_qt = (a.L - 1) / BQ + 1, n_kb = (a.S - 1) / BK + 1;
  const int ld_rows = n_qt * BQ, ld_cols = n_kb * BK;
  const int n_chunks = (a.dh - 1) / DC + 1;
  if (static_cast<long long>(n_qt) * n_kb > 2147483647LL ||
      static_cast<long long>(n_qt) * n_chunks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wide_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScoresSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wide_pv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_scores_kernel<<<dim3(n_qt * n_kb, a.H, a.B), THREADS, kScoresSmem, stream>>>(
      a, scores, n_kb, ld_rows, ld_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_pv_kernel<<<dim3(n_qt * n_chunks, a.H, a.B), THREADS, kPvSmem, stream>>>(
      a, scores, n_chunks, ld_rows, ld_cols);
  return static_cast<int>(cudaGetLastError());
}

template <int DK>
int launch(const scl::AttnArgs& a, cudaStream_t stream) {
  // rows up to 128 take one block per head, a warp per 16-row slab
  const int tq = a.L <= SHORT_ROWS ? scl::round_up(a.L, 16) : BQ;
  const int smem = (tq + 4 * BK) * (DK + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (SHORT_ROWS + 4 * BK) * (DK + 8) * 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.L - 1) / tq + 1, a.H, a.B);
  flash_kernel<DK><<<grid, tq * 2, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The f32 form: f32 q/k/v in, f32 out, f32 arithmetic throughout (CUDA-core
// FMAs, no tensor cores, so nothing is rounded to bf16 or TF32): the TPU
// kernel on f32 operands, as the CLIP text tower runs it (the tower runs in
// the f32 token table's dtype). A block owns one (batch, head) and W warps
// of R query rows each; it stages the scaled Q rows, then one 32-key block
// of K and of V at a time, in shared memory. Scores: lane j takes key j of
// the block and sums its whole dot product with each of the warp's R rows
// (float4 reads of its K row, the Q rows broadcast; K rows padded to Dh + 4
// floats, so the 8 lanes of a float4 phase fall in distinct banks). Then,
// per row, the TPU's online softmax over the block: m_new = max(m, max_j
// s_j), p_j = exp(s_j - m_new) (keys past S: 0), l = alpha l + sum_j p_j,
// acc = alpha acc + sum_j p_j v_j, with lane i holding output columns i,
// i + 32, ... and p_j broadcast by a shuffle; out = acc / max(l, 1e-30). A
// warp visits keys up to its rows' last valid one (len, and when causal its
// last row); a batch with len = 0 visits all S keys and comes out as the
// mean of v, as the plain version does. What bounds it: Dh + 4 R Dh / 4
// shared-memory reads and 2 R Dh FMAs per lane per key block, and the K/V
// staging (each (batch, head)'s K and V are read by ceil(L / (W R))
// blocks). Past Dh = 768 (the large cascaded branch's 1024-wide head) a
// 32-key block of K and one of V (256 KB at Dh = 1024) do not fit beside
// each other in shared memory, so the block stages them in turn through one
// buffer (`ONE_KV`): K for the scores, then V over it for P V, with a
// barrier between.
constexpr int F32_KEYS = 32;  // keys per softmax block, one per lane
constexpr int F32_MAX_DH = 1024;
constexpr int F32_SPLIT_DH = 768;  // widest Dh whose K and V blocks share memory side by side

struct AttnArgsF32 {
  const float* q;
  const float* k;
  const float* v;
  const int* lens;
  float* out;
  int L, S, dh, causal;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];
};

// Shared memory of a block of `rows` query rows at head dim dh (floats: K
// rows padded to dh + 4, V rows unless `one_kv` puts them over K, Q rows).
__host__ __device__ inline int f32_smem_bytes(int dh, int rows, bool one_kv) {
  return (F32_KEYS * (dh + 4) + (one_kv ? 0 : F32_KEYS * dh) + rows * dh) * 4;
}

// rows [r0, r0 + n) of a (rows, dh) f32 operand (row stride `ld`) into a
// shared tile of row stride `lds`, times `scale`; rows past n_rows are 0.
__device__ __forceinline__ void load_rows_f32(float* dst, int lds, const float* src,
                                              long long ld, int r0, int n, int n_rows, int dh,
                                              float scale) {
  const int c4 = dh / 4;
  for (int i = threadIdx.x; i < n * c4; i += blockDim.x) {
    const int r = i / c4, c = (i % c4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) {
      x = __ldg(reinterpret_cast<const float4*>(src + (r0 + r) * ld + c));
      x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * lds + c) = x;
  }
}

// NA: output columns per lane (Dh <= 32 NA); R: rows per warp; ONE_KV: K and
// V staged in turn through one buffer
template <int NA, int R, bool ONE_KV>
__global__ void __launch_bounds__(256) flash_f32_kernel(AttnArgsF32 a) {
  extern __shared__ __align__(16) float fsm[];
  const int dh = a.dh, ldk = dh + 4;
  const int rows = (blockDim.x / 32) * R;
  float* Ks = fsm;
  float* Vs = ONE_KV ? Ks : Ks + F32_KEYS * ldk;
  float* Qs = Ks + F32_KEYS * ldk + (ONE_KV ? 0 : F32_KEYS * dh);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, L = a.L;
  const int len = a.lens ? min(a.lens[b], S) : S;
  const float* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const float* vb = a.v + b * a.vs[0] + h * a.vs[1];
  load_rows_f32(Qs, dh, a.q + b * a.qs[0] + h * a.qs[1], a.qs[2], q0, rows, L, dh, a.scale);

  const int row0 = q0 + warp * R;  // the warp's first row
  // keys the block visits, and those this warp needs
  int keys = S, warp_keys = S;
  if (len > 0) {
    keys = a.causal ? min(len, min(q0 + rows, L)) : len;
    warp_keys = a.causal ? min(len, row0 + R) : len;
  }
  float acc[R][NA], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = scl::kNegInf, l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < keys; k0 += F32_KEYS) {
    __syncthreads();  // the previous block's K and V are consumed (and Q is staged)
    load_rows_f32(Ks, ldk, kb, a.ks[2], k0, F32_KEYS, S, dh, 1.f);
    if (!ONE_KV) load_rows_f32(Vs, dh, vb, a.vs[2], k0, F32_KEYS, S, dh, 1.f);
    __syncthreads();
    const bool active = row0 < L && k0 < warp_keys;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    if (active) {
      const float* kr = Ks + lane * ldk;
      const float* qr = Qs + warp * R * dh;
      for (int d = 0; d < dh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + r * dh + d);
          s[r] = fmaf(qv.x, kv.x, s[r]);
          s[r] = fmaf(qv.y, kv.y, s[r]);
          s[r] = fmaf(qv.z, kv.z, s[r]);
          s[r] = fmaf(qv.w, kv.w, s[r]);
        }
      }
    }
    if (ONE_KV) {  // every warp's scores are taken: V goes over K
      __syncthreads();
      load_rows_f32(Vs, dh, vb, a.vs[2], k0, F32_KEYS, S, dh, 1.f);
      __syncthreads();
    }
    if (!active) continue;
    const int key = k0 + lane;
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = s[r];
      if (key >= S) {
        x = __int_as_float(0xff800000);  // -inf: p = 0
      } else if (key >= len || (a.causal && key > row0 + r)) {
        x = scl::kNegInf;
      }
      const float m_new = fmaxf(m[r], scl::warp_max(x));
      const float alpha = expf(m[r] - m_new);
      p[r] = expf(x - m_new);
      l[r] = l[r] * alpha + scl::warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[r][i] *= alpha;
    }
    const int n = min(F32_KEYS, S - k0);
    for (int j = 0; j < n; ++j) {
      float vv[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < dh ? Vs[j * dh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= L) break;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = a.out + b * a.os[0] + h * a.os[1] + row * a.os[2];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) orow[d] = acc[r][i] * inv;
    }
  }
}

// NA columns per lane; R rows per warp and W warps per block chosen so the
// block's shared memory fits at the widest Dh of the bucket (768: 8 rows,
// K and V side by side, 216.5 KiB; 1024: 16 rows, K and V in turn, 192.5
// KiB: every block streams all of its head's K and V, so more rows a block
// read them fewer times).
template <int NA>
int launch_f32(const AttnArgsF32& a, int B, int H, cudaStream_t stream) {
  constexpr bool ONE_KV = NA * 32 > F32_SPLIT_DH;
  constexpr int R = NA <= 8 ? 4 : 2, W = NA <= 16 || ONE_KV ? 8 : 4;
  const int rows = W * R, smem = f32_smem_bytes(a.dh, rows, ONE_KV);
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<NA, R, ONE_KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_f32_kernel<NA, R, ONE_KV><<<dim3((a.L - 1) / rows + 1, H, B), W * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 form (see flash_f32_kernel): any Dh % 8 == 0 up to 1024.
extern "C" int scl_flash_attention_f32(const void* q, const void* k, const void* v,
                                       const void* lens, void* out, int B, int H, int L,
                                       int S, int dh, const long long* strides, int causal,
                                       float scale, void* stream) {
  if (dh % 8 != 0 || dh > F32_MAX_DH || L < 1 || S < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgsF32 a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lens = static_cast<const int*>(lens);
  a.out = static_cast<float*>(out);
  a.L = L, a.S = S, a.dh = dh, a.causal = causal, a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int na = (dh + 31) / 32;
  if (na <= 1) return launch_f32<1>(a, B, H, st);
  if (na <= 2) return launch_f32<2>(a, B, H, st);
  if (na <= 4) return launch_f32<4>(a, B, H, st);
  if (na <= 8) return launch_f32<8>(a, B, H, st);
  if (na <= 16) return launch_f32<16>(a, B, H, st);
  if (na <= 24) return launch_f32<24>(a, B, H, st);
  return launch_f32<32>(a, B, H, st);
}

// `scores`: for dh > 128, an f32 scratch of B * H * ceil64(L) * ceil64(S)
// elements (the wrapper allocates it); unused otherwise.
extern "C" int scl_flash_attention(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, int B, int H, int L,
                                   int S, int dh, const long long* strides, int causal,
                                   float scale, void* scores, void* stream) {
  if (dh % 8 != 0 || L < 1 || S < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const scl::AttnArgs a =
      scl::make_attn_args(q, k, v, lens, out, B, H, L, S, dh, strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh > 128) {
    if (scores == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wide(a, static_cast<float*>(scores), st);
  }
  switch (scl::round_up(dh, 16)) {
    case 16: return launch<16>(a, st);
    case 32: return launch<32>(a, st);
    case 48: return launch<48>(a, st);
    case 64: return launch<64>(a, st);
    case 80: return launch<80>(a, st);
    case 96: return launch<96>(a, st);
    case 112: return launch<112>(a, st);
    default: return launch<128>(a, st);
  }
}
