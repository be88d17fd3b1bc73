// Streaming attention with an online softmax over head-split (B, H, rows, Dh)
// bf16 tensors, sm_90a: the kernel of the "pallas" attention backend.
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
// Here one block of 4 warps owns a 64-query tile of one (batch, head), 16
// rows per warp, and streams 64-key K/V blocks through two shared-memory
// stages (cp.async, the next block in flight under this one's math). The
// products run on the tensor cores as mma.sync m16n8k16 with the score and
// output tiles in registers (the FlashAttention-2 layout: an S accumulator
// fragment is reused as the A fragment of P V without leaving registers).
//   Q K^T: bf16 operands, f32 accumulation; the inputs are bf16, so every
//     product is exact and only the summation order differs from f32. The
//     scale is applied to the f32 scores (the TPU scales the f32 q first:
//     one more f32 rounding there, of relative size 2^-24).
//   P V: p is split as p = hi + lo with hi = bf16(p) and lo = bf16(p - hi),
//     and both halves go through the tensor cores against the exact bf16 v,
//     so p carries 16 significant bits (relative error <= 2^-17), close to
//     the TPU's f32 P V.
// Blocks past the batch's key length are skipped (their p is exactly 0 once
// the row has one valid key), and so, when causal, are blocks wholly above
// the diagonal; a batch with lens = 0 scans every block, so its rows are the
// mean of v over all S keys.
//
// What bounds it on the H100: 6 * 64 * S * Dh tensor-core FLOP per block
// (Q K^T once, P V twice for the split) against (64 + 2 S) * Dh * 2 bytes
// of K/V re-read per query tile, ~95 FLOP/byte from L2:
// below the ridge, so K/V reuse across query tiles in the 50 MB L2 and the
// latency hiding of 2 blocks per SM (87 KB of shared memory each at Dh =
// 128) bound it. The head dim is a template parameter padded to 16 (zero
// columns in shared memory), 16..128.
//
// Wider heads (the cascaded branch's single 768-wide head) take
// flash_kernel_wide: a 64 x 768 K or V stage would be 96 KB and one row's f32
// output accumulator 384 registers a thread, so the head dim is cut into
// 128-wide chunks (the TPU kernel pads Dh to a multiple of 128 the same
// way). One block owns (b, h, 64-query tile, one 128-wide chunk of output
// columns): for each 64-key block it accumulates S = Q K^T over every Dh
// chunk, streaming (Q chunk, K chunk) pairs through two shared-memory
// stages, then runs the same online softmax and adds P V for its own 128
// columns only. Q K^T is recomputed once per output chunk (6x at Dh = 768),
// which at the cascaded shape is a few tens of GFLOP; the rounding points
// are those of the narrow kernel (f32 scores and softmax, p = hi + lo).

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int BK = 64;  // keys per streamed block
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A B, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DK>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int r0, int n_rows,
                                          int dh) {
  constexpr int LD = DK + 8, CH = DK / 8;
  for (int i = threadIdx.x; i < BK * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < n_rows && c < dh;
    scl::cp_async_16(&dst[r * LD + c], ok ? base + (r0 + r) * row_stride + c : base, ok);
  }
}

template <int DK>
__global__ void __launch_bounds__(THREADS) flash_kernel(scl::AttnArgs a) {
  constexpr int LD = DK + 8;      // shared row stride (bf16 elements)
  constexpr int NK = DK / 16;     // k16 steps of Q K^T
  constexpr int NO = DK / 8;      // n8 output tiles of P V
  constexpr int NS = BK / 8;      // n8 score tiles per key block
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;        // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;    // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, L = a.L, dh = a.dh;
  const int len = a.lens ? min(a.lens[b], S) : S;
  const __nv_bfloat16* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const __nv_bfloat16* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const __nv_bfloat16* vb = a.v + b * a.vs[0] + h * a.vs[1];

  int n_blocks = (S + BK - 1) / BK;
  if (len > 0) {
    n_blocks = min(n_blocks, (len + BK - 1) / BK);
    if (a.causal) {  // up to the block holding the tile's last row
      const int last_row = min(q0 + BQ, L) - 1;
      n_blocks = min(n_blocks, last_row / BK + 1);
    }
  }

  // Q tile (BQ rows = BK, so load_tile serves) and the first K/V block.
  load_tile<DK>(Qs, qb + q0 * a.qs[2], a.qs[2], 0, L - q0, dh);
  load_tile<DK>(Ks, kb, a.ks[2], 0, S, dh);
  load_tile<DK>(Vs, vb, a.vs[2], 0, S, dh);
  scl::cp_async_commit();

  uint32_t qf[NK][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = scl::kNegInf, m1 = scl::kNegInf, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  for (int kbk = 0; kbk < n_blocks; ++kbk) {
    if (kbk + 1 < n_blocks) {
      const int nxt = (kbk + 1) & 1;
      load_tile<DK>(Ks + nxt * BK * LD, kb, a.ks[2], (kbk + 1) * BK, S, dh);
      load_tile<DK>(Vs + nxt * BK * LD, vb, a.vs[2], (kbk + 1) * BK, S, dh);
      scl::cp_async_commit();
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();
    if (kbk == 0) {
      const __nv_bfloat16* qw = Qs + warp * 16 * LD;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const __nv_bfloat16* p = qw + kk * 16 + tig * 2;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(p + g * LD);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + g * LD + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD + 8);
      }
    }
    const __nv_bfloat16* Kst = Ks + (kbk & 1) * BK * LD;
    const __nv_bfloat16* Vst = Vs + (kbk & 1) * BK * LD;

    // S = Q K^T (f32), then scale and mask.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const __nv_bfloat16* p = Kst + (j * 8 + g) * LD + kk * 16 + tig * 2;
        mma16816(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(p),
                 *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }
    float mx0 = scl::kNegInf, mx1 = scl::kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kbk * BK + j * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[j][e] * a.scale;
        if (col >= S) {
          x = -INFINITY;  // past the keys: weight exactly 0, even in a masked row
        } else if (col >= len || (a.causal && col > row)) {
          x = scl::kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // a row's 8-column slices live in the 4 lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0, m1 = mn1;
    l0 *= al0, l1 *= al1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al0, acc[n][1] *= al0;
      acc[n][2] *= al1, acc[n][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = expf(s[j][0] - mn0), s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1), s[j][3] = expf(s[j][3] - mn1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // acc += P V over the block's four 16-key slabs, p = hi + lo.
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      uint32_t hi[4], lo[4];
      const float* c0 = s[2 * t];
      const float* c1 = s[2 * t + 1];
      const float pv[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat16 h0 = __float2bfloat16_rn(pv[2 * r]);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(pv[2 * r + 1]);
        hi[r] = pack2(h0, h1);
        lo[r] = pack2f(pv[2 * r] - __bfloat162float(h0), pv[2 * r + 1] - __bfloat162float(h1));
      }
      const __nv_bfloat16* vr = Vst + (t * 16 + tig * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* p = vr + n * 8;
        const uint32_t b0 = pack2(p[0], p[LD]);
        const uint32_t b1 = pack2(p[8 * LD], p[9 * LD]);
        mma16816(acc[n], hi, b0, b1);
        mma16816(acc[n], lo, b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled two blocks from now
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = a.out + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + tig * 2;
    if (col < dh) {
      if (row0 < L)
        *reinterpret_cast<uint32_t*>(ob + row0 * a.os[2] + col) =
            pack2f(acc[n][0] / d0, acc[n][1] / d0);
      if (row1 < L)
        *reinterpret_cast<uint32_t*>(ob + row1 * a.os[2] + col) =
            pack2f(acc[n][2] / d1, acc[n][3] / d1);
    }
  }
}

constexpr int DC = 128;  // head-dim chunk of the wide kernel
constexpr int LDC = DC + 8;

// One 64-row x 128-column chunk of a (rows, Dh) operand into shared memory;
// rows past n_rows and columns past dh are zero-filled.
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long row_stride, int r0, int n_rows,
                                           int c0, int dh) {
  constexpr int CH = DC / 8;
  for (int i = threadIdx.x; i < BK * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < n_rows && c0 + c < dh;
    scl::cp_async_16(&dst[r * LDC + c], ok ? base + (r0 + r) * row_stride + c0 + c : base, ok);
  }
}

__global__ void __launch_bounds__(THREADS) flash_kernel_wide(scl::AttnArgs a, int n_chunks) {
  constexpr int NK = DC / 16;  // k16 steps per chunk of Q K^T
  constexpr int NO = DC / 8;   // n8 output tiles of P V
  constexpr int NS = BK / 8;   // n8 score tiles per key block
  constexpr int TILE = BK * LDC;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 stages
  __nv_bfloat16* Ks = Qs + 2 * TILE;                             // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * TILE;                             // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int q0 = (blockIdx.x / n_chunks) * BQ, oc0 = (blockIdx.x % n_chunks) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, L = a.L, dh = a.dh;
  const int len = a.lens ? min(a.lens[b], S) : S;
  const __nv_bfloat16* qb = a.q + b * a.qs[0] + h * a.qs[1] + q0 * a.qs[2];
  const __nv_bfloat16* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const __nv_bfloat16* vb = a.v + b * a.vs[0] + h * a.vs[1];

  int n_blocks = (S + BK - 1) / BK;
  if (len > 0) {
    n_blocks = min(n_blocks, (len + BK - 1) / BK);
    if (a.causal) n_blocks = min(n_blocks, (min(q0 + BQ, L) - 1) / BK + 1);
  }
  const int steps = n_blocks * n_chunks;
  // step i loads Q chunk j and K block kbk's chunk j (i = kbk * n_chunks + j)
  // into stage i & 1, and with j == 0 block kbk's V columns into stage kbk & 1
  auto load_step = [&](int i) {
    const int kbk = i / n_chunks, j = i % n_chunks;
    load_chunk(Qs + (i & 1) * TILE, qb, a.qs[2], 0, L - q0, j * DC, dh);
    load_chunk(Ks + (i & 1) * TILE, kb, a.ks[2], kbk * BK, S, j * DC, dh);
    if (j == 0) load_chunk(Vs + (kbk & 1) * TILE, vb, a.vs[2], kbk * BK, S, oc0, dh);
    scl::cp_async_commit();
  };

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float s[NS][4];
  float m0 = scl::kNegInf, m1 = scl::kNegInf, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  load_step(0);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      load_step(i + 1);
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();
    const int kbk = i / n_chunks, j = i % n_chunks;
    if (j == 0) {
#pragma unroll
      for (int t = 0; t < NS; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    }
    const __nv_bfloat16* Qst = Qs + (i & 1) * TILE + warp * 16 * LDC;
    const __nv_bfloat16* Kst = Ks + (i & 1) * TILE;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const __nv_bfloat16* p = Qst + kk * 16 + tig * 2;
      uint32_t qf[4];
      qf[0] = *reinterpret_cast<const uint32_t*>(p + g * LDC);
      qf[1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LDC);
      qf[2] = *reinterpret_cast<const uint32_t*>(p + g * LDC + 8);
      qf[3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LDC + 8);
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const __nv_bfloat16* kp = Kst + (t * 8 + g) * LDC + kk * 16 + tig * 2;
        mma16816(s[t], qf, *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    if (j == n_chunks - 1) {
      // scale, mask and the online softmax, as in flash_kernel
      float mx0 = scl::kNegInf, mx1 = scl::kNegInf;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kbk * BK + t * 8 + tig * 2 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          float x = s[t][e] * a.scale;
          if (col >= S) {
            x = -INFINITY;
          } else if (col >= len || (a.causal && col > row)) {
            x = scl::kNegInf;
          }
          s[t][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
        mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0, m1 = mn1;
      l0 *= al0, l1 *= al1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= al0, acc[n][1] *= al0;
        acc[n][2] *= al1, acc[n][3] *= al1;
      }
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        s[t][0] = expf(s[t][0] - mn0), s[t][1] = expf(s[t][1] - mn0);
        s[t][2] = expf(s[t][2] - mn1), s[t][3] = expf(s[t][3] - mn1);
        l0 += s[t][0] + s[t][1];
        l1 += s[t][2] + s[t][3];
      }
      const __nv_bfloat16* Vst = Vs + (kbk & 1) * TILE;
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        uint32_t hi[4], lo[4];
        const float* c0 = s[2 * t];
        const float* c1 = s[2 * t + 1];
        const float pv[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat16 h0 = __float2bfloat16_rn(pv[2 * r]);
          const __nv_bfloat16 h1 = __float2bfloat16_rn(pv[2 * r + 1]);
          hi[r] = pack2(h0, h1);
          lo[r] = pack2f(pv[2 * r] - __bfloat162float(h0), pv[2 * r + 1] - __bfloat162float(h1));
        }
        const __nv_bfloat16* vr = Vst + (t * 16 + tig * 2) * LDC + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const __nv_bfloat16* p = vr + n * 8;
          const uint32_t b0 = pack2(p[0], p[LDC]);
          const uint32_t b1 = pack2(p[8 * LDC], p[9 * LDC]);
          mma16816(acc[n], hi, b0, b1);
          mma16816(acc[n], lo, b0, b1);
        }
      }
    }
    __syncthreads();  // stage i & 1 (and this block's V stage) is refilled later
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = a.out + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = oc0 + n * 8 + tig * 2;
    if (col < dh) {
      if (row0 < L)
        *reinterpret_cast<uint32_t*>(ob + row0 * a.os[2] + col) =
            pack2f(acc[n][0] / d0, acc[n][1] / d0);
      if (row1 < L)
        *reinterpret_cast<uint32_t*>(ob + row1 * a.os[2] + col) =
            pack2f(acc[n][2] / d1, acc[n][3] / d1);
    }
  }
}

int launch_wide(const scl::AttnArgs& a, cudaStream_t stream) {
  const int smem = 6 * BK * LDC * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (a.dh + DC - 1) / DC;
  const long long grid_x = static_cast<long long>((a.L + BQ - 1) / BQ) * n_chunks;
  if (grid_x > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(grid_x), a.H, a.B);
  flash_kernel_wide<<<grid, THREADS, smem, stream>>>(a, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int DK>
int launch(const scl::AttnArgs& a, cudaStream_t stream) {
  const int smem = (BQ + 4 * BK) * (DK + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);
  flash_kernel<DK><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scl_flash_attention(const void* q, const void* k, const void* v,
                                   const void* lens, void* out, int B, int H, int L,
                                   int S, int dh, const long long* strides, int causal,
                                   float scale, void* stream) {
  if (dh % 8 != 0 || L < 1 || S < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const scl::AttnArgs a =
      scl::make_attn_args(q, k, v, lens, out, B, H, L, S, dh, strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh > 128) return launch_wide(a, st);
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
