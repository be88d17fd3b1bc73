// Warp tiles shared by the attention kernels (csrc/attention_vmem.cu,
// csrc/flash_attention.cu), sm_90a.
//
// Each warp of a block owns 16 query rows (4 warps: a 64-query tile), and the
// block streams 64-key blocks of K and V through shared memory (rows padded by 8 bf16, so
// the ldmatrix row addresses of one 8x8 matrix fall in distinct banks). The
// products are mma.sync m16n8k16 with bf16 operands and f32 accumulators, in
// the FlashAttention-2 register layout: lane (g = lane / 4, tig = lane % 4)
// holds s[j][e] at row g + 8 * (e / 2) of its warp's 16, column
// j * 8 + tig * 2 + e % 2 of the key block, and the same fragment, rounded to
// bf16, is the A operand of P V without leaving registers. K fragments come
// from ldmatrix, V fragments from ldmatrix.trans (V stays row-major).
#pragma once

#include "common.cuh"

namespace scl {

constexpr int kTileQ = 64;     // query rows per block of 4 warps, 16 per warp
constexpr int kTileK = 64;     // keys per streamed block
constexpr int kTileThreads = 128;

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

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i. _t: each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// cp.async rows [r0, r0 + rows) of a (rows, cols) bf16 operand into a
// rows x W shared tile (leading dim W + 8), by all of the block's threads;
// rows past n_rows and columns past `cols` are zero-filled.
template <int W>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int r0, int n_rows,
                                          int cols, int rows = kTileK) {
  constexpr int LD = W + 8, CH = W / 8;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < n_rows && c < cols;
    cp_async_16(&dst[r * LD + c], ok ? base + (r0 + r) * row_stride + c : base, ok);
  }
}

// Key blocks a query tile must visit. Past the batch's key length every p is
// exactly 0 once the row has one valid key, and so, when causal, is every
// block wholly above the diagonal; a batch with lens = 0 visits them all, so
// its rows come out as the mean of v over all S keys.
__device__ __forceinline__ int key_blocks(int S, int len, int causal, int q0, int L,
                                          int rows = kTileQ) {
  int n = (S + kTileK - 1) / kTileK;
  if (len > 0) {
    n = min(n, (len + kTileK - 1) / kTileK);
    if (causal) n = min(n, (min(q0 + rows, L) - 1) / kTileK + 1);
  }
  return n;
}

// A fragments of a warp's 16 rows x DK columns of a bf16 tile (leading dim LD).
template <int DK, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[DK / 16][4], const __nv_bfloat16* rows,
                                       int lane) {
  const __nv_bfloat16* p = rows + (lane % 16) * LD + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// s += Q K^T over DK columns: the warp's 16 rows against the 64 keys of Ks.
template <int DK, int LD>
__device__ __forceinline__ void qk_block(float (&s)[8][4], const uint32_t (&qf)[DK / 16][4],
                                         const __nv_bfloat16* Ks, int lane) {
  const __nv_bfloat16* kp = Ks + ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, kp + j * 8 * LD + kk * 16);
      mma16816(s[j], qf[kk], b[0], b[1]);
      mma16816(s[j + 1], qf[kk], b[2], b[3]);
    }
  }
}

// The A fragments of P V for the block's four 16-key slabs (p[t] covers
// keys t*16 .. t*16 + 15; register r holds two keys of row g for r even,
// of row g + 8 for r odd), with p = hi + lo, hi = bf16(p), lo = bf16(p -
// hi): 16 significant bits of p through bf16 tensor cores.
__device__ __forceinline__ void p_frags_split(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                              const float (&s)[8][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* c = s[2 * t + r / 2] + (r % 2) * 2;
      const __nv_bfloat16 h0 = __float2bfloat16_rn(c[0]);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(c[1]);
      hi[t][r] = pack2(h0, h1);
      lo[t][r] = pack2f(c[0] - __bfloat162float(h0), c[1] - __bfloat162float(h1));
    }
  }
}

// acc += P V over DK output columns of Vs (64 keys, leading dim LD); with
// kSplit, P = hi + lo, both halves against the same V fragments.
template <int DK, int LD, bool kSplit>
__device__ __forceinline__ void pv_block(float (&acc)[DK / 8][4], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], const __nv_bfloat16* Vs,
                                         int lane) {
  const __nv_bfloat16* vp = Vs + (lane % 16) * LD + (lane / 16) * 8;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int n = 0; n < DK / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vp + t * 16 * LD + n * 8);
      mma16816(acc[n], hi[t], b[0], b[1]);
      mma16816(acc[n + 1], hi[t], b[2], b[3]);
      if (kSplit) {
        mma16816(acc[n], lo[t], b[0], b[1]);
        mma16816(acc[n + 1], lo[t], b[2], b[3]);
      }
    }
  }
}

// Scale the f32 scores of key block kb (scale 1 for pre-scaled q) and mask
// them: f32 finfo.min at col >= len and, when causal, col > row; -inf past
// the S keys, so those weigh exactly 0 even in a fully masked row.
__device__ __forceinline__ void mask_scores(float (&s)[8][4], float scale, int kb, int S,
                                            int len, int causal, int row0, int lane) {
  const int tig = lane % 4, last_col = (kb + 1) * kTileK - 1;
  if (last_col < len && (!causal || last_col <= row0 - lane / 4)) {
    // every key of the block is valid for every row of the warp (len <= S)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kb * kTileK + j * 8 + tig * 2 + (e & 1);
      const int row = e < 2 ? row0 : row0 + 8;
      float x = s[j][e] * scale;
      if (col >= S) {
        x = -INFINITY;
      } else if (col >= len || (causal && col > row)) {
        x = kNegInf;
      }
      s[j][e] = x;
    }
  }
}

// Max and sum across the 4 lanes of a quad (the lanes holding one row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One step of the f32 online softmax over a masked score block: the running
// row maxima m (from f32 finfo.min) and sums l of the UNROUNDED p, the
// accumulator rescaled by exp(m_old - m_new), and s turned into p.
template <int NO>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&acc)[NO][4],
                                               float& m0, float& m1, float& l0, float& l1) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
  const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
  m0 = mn0, m1 = mn1;
  l0 *= al0, l1 *= al1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= al0, acc[n][1] *= al0;
    acc[n][2] *= al1, acc[n][3] *= al1;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = expf(s[j][0] - mn0), s[j][1] = expf(s[j][1] - mn0);
    s[j][2] = expf(s[j][2] - mn1), s[j][3] = expf(s[j][3] - mn1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
}

// Write a warp's (16 x NO*8) f32 accumulator, each row divided by its
// denominator, rounded once to bf16, columns [c0, c0 + NO*8) clipped at dh
// and rows at L.
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, long long row_stride,
                                           const float (&acc)[NO][4], float d0, float d1,
                                           int row0, int L, int c0, int dh, int lane) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = c0 + n * 8 + (lane % 4) * 2;
    if (col < dh) {
      if (row0 < L)
        *reinterpret_cast<uint32_t*>(ob + row0 * row_stride + col) =
            pack2f(acc[n][0] / d0, acc[n][1] / d0);
      if (row1 < L)
        *reinterpret_cast<uint32_t*>(ob + row1 * row_stride + col) =
            pack2f(acc[n][2] / d1, acc[n][3] / d1);
    }
  }
}

}  // namespace scl
