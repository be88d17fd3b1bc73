// Whole-row attention over head-split (B, H, rows, Dh) bf16 tensors, sm_90a.
//
// Replaces: speechclip_tpu/kernels/attention_vmem.py (_kernel, :64-111, and
// the q pre-scale of _forward, :135). One TPU grid cell holds a group of
// (batch, head) pairs with each head's whole (L, S) f32 score matrix in
// VMEM: an exact two-pass softmax, no online rescaling. Here one block owns
// one (batch, head, 32-query tile) and holds that tile's whole f32 score
// row in shared memory, so the scores never reach HBM either, and the
// softmax is the same exact two passes. The TPU's (batch, head) grouping is
// a VMEM device (it amortizes per-cell overhead) and has no counterpart.
//
// Two rounding modes (template flag kVmem):
//   attention_vmem (kVmem): q is scaled by the bf16-rounded 1/sqrt(Dh) and
//     rounded to bf16 before Q K^T; masked keys get f32 finfo.min; p =
//     exp(s - rowmax) is rounded to bf16; P V and the denominator (the sum
//     of the ROUNDED p: the TPU's ones-lane) accumulate in f32; out =
//     acc / max(denom, 1e-30), rounded once.
//   mha_block core (!kVmem), for rows too long for csrc/attention_core.cu:
//     s = (q k^T) * scale in f32, masked keys finfo.min, f32 softmax with the
//     denominator clamped at 1e-30, weights rounded to bf16, P V in f32,
//     rounded (speechclip_tpu/kernels/mha_block.py _kernel, :106-119).
//
// What bounds it on the H100: per block 4 * 32 * S * Dh FLOP against
// (32 + 2 S) * Dh * 2 bytes of K/V re-read per 32-query tile (~30 FLOP/byte
// from L2, far below the ~295 FLOP/byte ridge), and shared memory: the
// f32 score rows of 32 queries take 123 KB at S = 934, which leaves one
// block (8 warps) per SM. The design streams K, then V, through two
// 64-key shared-memory stages (cp.async, one chunk in flight under the
// tensor-core work of the other), writes each row's bf16 weights over the
// front half of its own f32 row, and loads the first V chunk under the
// softmax. Heads with Dh % 16 != 0 are zero-padded to 16 in shared memory.
//
// Requirements checked by the wrapper (kernels/attention_vmem.py): Dh % 8
// == 0 and Dh <= 128; element strides multiples of 8 with a unit last
// stride and 16-byte aligned bases; shared memory (RowSmem) <= 227 KB,
// which holds S <= 1408 at Dh = 128.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int KC = 64;        // keys per streamed K/V chunk
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SMEM_LIMIT = 232448;

struct RowSmem {
  int q, kv, s, denom, scratch, total;
  __host__ __device__ RowSmem(int S, int dh) {
    const int ldk = scl::round_up(dh, 16) + 8, lds = scl::round_up(S, KC) + 4;
    q = 0;
    kv = q + scl::align128(BQ * ldk * 2);
    s = kv + scl::align128(2 * KC * ldk * 2);
    denom = s + scl::align128(BQ * lds * 4);
    scratch = denom + scl::align128(BQ * 4);
    total = scratch + WARPS * 16 * 16 * 4;
  }
};

// cp.async rows [r0, r0 + rows) of one head into `dst` (leading dim ldk),
// zero-filling rows past `n_rows` and columns past dh.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ldk,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int r0, int rows,
                                          int n_rows, int dh, int dkp) {
  const int chunks = dkp / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool ok = r0 + r < n_rows && c < dh;
    scl::cp_async_16(&dst[r * ldk + c], ok ? base + (r0 + r) * row_stride + c : base, ok);
  }
}

template <bool kVmem>
__global__ void __launch_bounds__(THREADS) rowwise_kernel(scl::AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowSmem lay(a.S, a.dh);
  const int S = a.S, L = a.L, dh = a.dh;
  const int dkp = scl::round_up(dh, 16), ldk = dkp + 8;
  const int sp = scl::round_up(S, KC), lds = sp + 4, ldp = 2 * lds;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  __nv_bfloat16* KV = reinterpret_cast<__nv_bfloat16*>(smem + lay.kv);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.s);
  float* denom = reinterpret_cast<float*>(smem + lay.denom);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int len = a.lens ? a.lens[b] : S;
  const __nv_bfloat16* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const __nv_bfloat16* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const __nv_bfloat16* vb = a.v + b * a.vs[0] + h * a.vs[1];
  const int n_chunks = sp / KC;
  const int stage = KC * ldk;

  load_rows(Qs, ldk, qb + q0 * a.qs[2], a.qs[2], 0, BQ, L - q0, dh, dkp);
  scl::cp_async_commit();
  load_rows(KV, ldk, kb, a.ks[2], 0, KC, S, dh, dkp);
  scl::cp_async_commit();
  if (kVmem) {  // q * bf16(1/sqrt(Dh)), rounded to bf16, as the TPU caller does
    scl::cp_async_wait<1>();
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * dkp; i += THREADS) {
      __nv_bfloat16& x = Qs[(i / dkp) * ldk + i % dkp];
      x = __float2bfloat16_rn(__bfloat162float(x) * a.scale);
    }
  }

  // Phase 1: S = Q K^T in f32, one 16x16 tile per warp per 64-key chunk.
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_rows(KV + ((c + 1) & 1) * stage, ldk, kb, a.ks[2], (c + 1) * KC, KC, S, dh, dkp);
      scl::cp_async_commit();
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Ks = KV + (c & 1) * stage;
    const int rt = warp / (KC / 16), ct = warp % (KC / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < dkp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kt;
      wmma::load_matrix_sync(qa, &Qs[rt * 16 * ldk + kk], ldk);
      wmma::load_matrix_sync(kt, &Ks[ct * 16 * ldk + kk], ldk);
      wmma::mma_sync(acc, qa, kt, acc);
    }
    wmma::store_matrix_sync(&Ss[rt * 16 * lds + c * KC + ct * 16], acc, lds,
                            wmma::mem_row_major);
    __syncthreads();
  }

  // The first V chunk streams in under the softmax.
  load_rows(KV, ldk, vb, a.vs[2], 0, KC, S, dh, dkp);
  scl::cp_async_commit();

  // Phase 2: the exact row softmax, one warp per row. Each row's bf16
  // weights overwrite the front half of its own f32 row: in the pass over
  // columns [c0, c0 + 32) every lane has read its score before any lane
  // writes, and the bytes written belong to f32 columns < c0 + 16.
  for (int r = warp; r < BQ; r += WARPS) {
    const int row = q0 + r;
    float* srow = Ss + r * lds;
    __nv_bfloat16* prow = Ps + r * ldp;
    const float sc = kVmem ? 1.0f : a.scale;
    auto score = [&](int col) {
      const bool masked = col >= len || (a.causal && col > row);
      return masked ? scl::kNegInf : srow[col] * sc;
    };
    float m = scl::kNegInf;
    for (int col = lane; col < S; col += 32) m = fmaxf(m, score(col));
    m = scl::warp_max(m);
    float sum = 0.f;
    if (kVmem) {
      for (int c0 = 0; c0 < sp; c0 += 32) {
        const int col = c0 + lane;
        __nv_bfloat16 p = __float2bfloat16_rn(0.f);
        if (col < S) {
          p = __float2bfloat16_rn(expf(score(col) - m));
          sum += __bfloat162float(p);
        }
        __syncwarp();
        prow[col] = p;
      }
      sum = scl::warp_sum(sum);
      if (lane == 0) denom[r] = fmaxf(sum, 1e-30f);
    } else {
      for (int col = lane; col < S; col += 32) sum += expf(score(col) - m);
      const float d = fmaxf(scl::warp_sum(sum), 1e-30f);
      for (int c0 = 0; c0 < sp; c0 += 32) {
        const int col = c0 + lane;
        const float w = col < S ? expf(score(col) - m) / d : 0.f;
        __syncwarp();
        prow[col] = __float2bfloat16_rn(w);
      }
    }
  }

  // Phase 3: O = P V in f32, each warp owning at most two 16x16 output tiles
  // across all V chunks.
  const int n_ct = dkp / 16, n_tiles = (BQ / 16) * n_ct;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_rows(KV + ((c + 1) & 1) * stage, ldk, vb, a.vs[2], (c + 1) * KC, KC, S, dh, dkp);
      scl::cp_async_commit();
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();  // this V chunk, and (first pass) every row's weights
    const __nv_bfloat16* Vs = KV + (c & 1) * stage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = warp + WARPS * i;
      if (t < n_tiles) {
        const int rt = t / n_ct, ct = t % n_ct;
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> p;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
          wmma::load_matrix_sync(p, &Ps[rt * 16 * ldp + c * KC + kk], ldp);
          wmma::load_matrix_sync(vf, &Vs[kk * ldk + ct * 16], ldk);
          wmma::mma_sync(acc[i], p, vf, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: [divide by the row's denominator,] round, 16-byte stores.
  float* tile = scratch + warp * 256;
  __nv_bfloat16* ob = a.out + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = warp + WARPS * i;
    if (t < n_tiles) {
      const int rt = t / n_ct, ct = t % n_ct;
      wmma::store_matrix_sync(tile, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 8;
      const int row = q0 + rt * 16 + r, col = ct * 16 + c0;
      if (row < L && col < dh) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = kVmem ? tile[r * 16 + c0 + e] / denom[rt * 16 + r] : tile[r * 16 + c0 + e];
        *reinterpret_cast<uint4*>(ob + row * a.os[2] + col) = scl::pack_bf16x8(v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int scl_rowwise_smem_bytes(int S, int dh) { return RowSmem(S, dh).total; }

extern "C" int scl_rowwise_attention(const void* q, const void* k, const void* v,
                                     const void* lens, void* out, int B, int H, int L,
                                     int S, int dh, const long long* strides,
                                     int causal, int vmem_rounding, float scale,
                                     void* stream) {
  if (dh % 8 != 0 || dh > 128 || L < 1 || S < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = RowSmem(S, dh).total;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const scl::AttnArgs a =
      scl::make_attn_args(q, k, v, lens, out, B, H, L, S, dh, strides, causal, scale);
  auto kernel = vmem_rounding ? rowwise_kernel<true> : rowwise_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
