// Whole-row attention over head-split (B, H, rows, Dh) bf16 tensors, sm_90a.
//
// Replaces: speechclip_tpu/kernels/attention_vmem.py (_kernel, :64-111, and
// the q pre-scale of _forward, :135). One TPU grid cell holds a group of
// (batch, head) pairs with each head's whole (L, S) f32 score matrix in
// VMEM and takes an exact two-pass softmax: p = exp(s - m) from the row's
// FINAL max m, rounded to bf16, and the sum of the ROUNDED p (its ones-lane)
// as the denominator. An online softmax cannot give that rounding (it rounds
// exp(s - m_running) and rescales afterwards), so this kernel sweeps K twice
// instead of holding the row.
//
// Layout (the FlashAttention-2 one of csrc/attention_tiles.cuh): one block
// of 4 warps owns one (batch, head, 64-query tile), 16 rows per warp; the
// Q fragments are loaded once into registers; 64-key blocks of K (and, in
// the second sweep, V) stream through two cp.async shared-memory stages;
// Q K^T and P V are mma.sync m16n8k16 with f32 accumulators, and each score
// fragment is the A operand of P V without leaving registers.
//   Sweep 1, Q K^T only: the masked row max m (and, for !kVmem, the f32
//     denominator, rescaled online per lane and merged across the row's
//     quad at the end).
//   Sweep 2 recomputes Q K^T per key block and adds P V.
// The head dim is a template parameter padded to 16 (zero columns).
//
// Two rounding modes (template flag kVmem):
//   attention_vmem (kVmem): q is scaled by the bf16-rounded 1/sqrt(Dh) and
//     rounded to bf16 before Q K^T; masked keys get f32 finfo.min; p =
//     bf16(exp(s - m)); P V is ONE bf16 product (the TPU's p is bf16, so no
//     hi/lo split) and the denominator, the f32 sum of the rounded p, comes
//     off the tensor cores as the TPU's ones-lane does (the p fragments times
//     a ones fragment); out = acc / max(denom, 1e-30), rounded once.
//   mha_block core (!kVmem), the attention core of mha_layer_block at every T:
//     s = (q k^T) * scale in f32, masked keys finfo.min, w = bf16(exp(s - m) /
//     max(d, 1e-30)), P V in f32, rounded (speechclip_tpu/kernels/
//     mha_block.py _kernel, :106-119). d is summed online (per lane, then
//     across the quad), so it differs from the exact two-pass sum in f32's
//     last bits and a bf16 weight may flip in a few elements, which the
//     agreement check (attention_agrees) allows.
// Key blocks past lens[b] and, when causal, wholly above the diagonal are
// skipped where that is exact (csrc/attention_tiles.cuh key_blocks); blocks
// whose every key is valid for the warp's rows skip the mask arithmetic.
//
// What bounds it on the H100: it executes 6 * L * S * Dh tensor-core FLOP
// (Q K^T twice, P V once) against (2 L + 2 S) * Dh * 2 bytes a head, with K
// and V read twice per query tile out of L2, so the bound is the operations
// (26.9 GFLOP counted at the 17 s shape, 0.027 ms at 989 TFLOP/s). What
// holds it is the instruction stream around the mma.sync products: ~100
// products, 48 ldmatrix and 32 expf per warp and key block, with 4 blocks of
// 4 warps per SM (46 KB of shared memory and 127 registers at Dh = 64;
// shared memory does not depend on S, so no row length is capped). At (16,
// 12, 849, 64) it runs at ~12 % of the bound on the device, ~210 TFLOP/s
// executed. Two 16-row slabs per warp (each K and V fragment feeding twice
// the products) measured no faster: at 236-255 registers only 2 blocks fit
// an SM. Numbers: PERF.md.
//
// Requirements checked by the wrapper (kernels/attention_vmem.py): Dh % 8
// == 0 and Dh <= 128; element strides multiples of 8 with a unit last
// stride and 16-byte aligned bases.

#include "attention_tiles.cuh"

namespace {

constexpr int BQ = scl::kTileQ;
constexpr int BK = scl::kTileK;
constexpr int THREADS = scl::kTileThreads;

template <int DK, bool kVmem>
__global__ void __launch_bounds__(THREADS) rowwise_kernel(scl::AttnArgs a) {
  constexpr int LD = DK + 8, NK = DK / 16, NO = DK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;      // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, L = a.L, dh = a.dh;
  const int len = a.lens ? min(a.lens[b], S) : S;
  const __nv_bfloat16* qb = a.q + b * a.qs[0] + h * a.qs[1];
  const __nv_bfloat16* kb = a.k + b * a.ks[0] + h * a.ks[1];
  const __nv_bfloat16* vb = a.v + b * a.vs[0] + h * a.vs[1];
  const int n = scl::key_blocks(S, len, a.causal, q0, L);
  const int steps = 2 * n;  // sweep 1: steps [0, n); sweep 2: [n, 2n)
  const bool live = q0 + warp * 16 < L;  // the warp has a row to write
  const int row0 = q0 + warp * 16 + lane / 4;
  const float scale = kVmem ? 1.0f : a.scale;

  // Step i loads K block (i mod n) into stage i & 1 and, in sweep 2, V too.
  auto load_step = [&](int i) {
    const int kbk = i < n ? i : i - n;
    scl::load_tile<DK>(Ks + (i & 1) * BK * LD, kb, a.ks[2], kbk * BK, S, dh);
    if (i >= n) scl::load_tile<DK>(Vs + (i & 1) * BK * LD, vb, a.vs[2], kbk * BK, S, dh);
    scl::cp_async_commit();
  };
  scl::load_tile<DK>(Qs, qb + q0 * a.qs[2], a.qs[2], 0, L - q0, dh);
  load_step(0);

  uint32_t qf[NK][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // the rows' max m and, for !kVmem, denominator d (sweep 1); for kVmem the
  // sum of the rounded p (sweep 2): den[0] (= den[1]) is row g's, den[2]
  // (= den[3]) row g + 8's
  float m0 = -INFINITY, m1 = -INFINITY, d0 = 0.f, d1 = 0.f;
  float den[4] = {0.f, 0.f, 0.f, 0.f};
  constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 1.0

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      load_step(i + 1);
      scl::cp_async_wait<1>();
    } else {
      scl::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (i == 0) {
        scl::load_a<DK, LD>(qf, Qs + warp * 16 * LD, lane);
        if (kVmem) {  // q * bf16(1/sqrt(Dh)), rounded to bf16, as the TPU caller does
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {  // a bf16 is the top half of its f32
              const float lo = __uint_as_float(qf[kk][r] << 16);
              const float hi = __uint_as_float(qf[kk][r] & 0xffff0000u);
              qf[kk][r] = scl::pack2f(lo * a.scale, hi * a.scale);
            }
        }
      }
      const int kbk = i < n ? i : i - n;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      scl::qk_block<DK, LD>(s, qf, Ks + (i & 1) * BK * LD, lane);
      scl::mask_scores(s, scale, kbk, S, len, a.causal, row0, lane);
      if (i < n) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
        if (!kVmem) {  // this lane's share of d, rescaled to its new max
          const float r0 = fmaxf(m0, mx0), r1 = fmaxf(m1, mx1);
          const float e0 = r0 == -INFINITY ? 0.f : r0, e1 = r1 == -INFINITY ? 0.f : r1;
          d0 *= expf(m0 - e0), d1 *= expf(m1 - e1);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            d0 += expf(s[j][0] - e0) + expf(s[j][1] - e0);
            d1 += expf(s[j][2] - e1) + expf(s[j][3] - e1);
          }
        }
        m0 = fmaxf(m0, mx0), m1 = fmaxf(m1, mx1);
        if (i == n - 1) {  // the rows' final max (finite: key 0 is < S)
          const float t0 = scl::quad_max(m0), t1 = scl::quad_max(m1);
          if (!kVmem) {
            d0 = fmaxf(scl::quad_sum(d0 * expf(m0 - t0)), 1e-30f);
            d1 = fmaxf(scl::quad_sum(d1 * expf(m1 - t1)), 1e-30f);
          }
          m0 = t0, m1 = t1;
        }
      } else {
        // the A fragments of P V (scl::p_frags_split's layout), each p or w
        // rounded once to bf16
        uint32_t p[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* c = s[2 * t + r / 2] + (r % 2) * 2;
            const float m = r % 2 ? m1 : m0;
            if (kVmem) {
              p[t][r] = scl::pack2f(expf(c[0] - m), expf(c[1] - m));
            } else {
              const float d = r % 2 ? d1 : d0;
              p[t][r] = scl::pack2f(expf(c[0] - m) / d, expf(c[1] - m) / d);
            }
          }
          // kVmem: the denominator is the f32 sum of the rounded p, taken
          // as the TPU takes it, through the matrix unit against ones
          if (kVmem) scl::mma16816(den, p[t], kOnes, kOnes);
        }
        scl::pv_block<DK, LD, false>(acc, p, p, Vs + (i & 1) * BK * LD, lane);
      }
    }
    __syncthreads();  // this stage is refilled two steps from now
  }

  if (live) {
    float r0 = 1.f, r1 = 1.f;
    if (kVmem) r0 = fmaxf(den[0], 1e-30f), r1 = fmaxf(den[2], 1e-30f);
    scl::store_rows<NO>(a.out + b * a.os[0] + h * a.os[1], a.os[2], acc, r0, r1, row0, L,
                        0, dh, lane);
  }
}

int smem_bytes(int dh) { return (BQ + 4 * BK) * (scl::round_up(dh, 16) + 8) * 2; }

template <int DK, bool kVmem>
int launch(const scl::AttnArgs& a, cudaStream_t stream) {
  const int smem = smem_bytes(DK);
  cudaError_t err = cudaFuncSetAttribute(rowwise_kernel<DK, kVmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.L - 1) / BQ + 1, a.H, a.B);
  rowwise_kernel<DK, kVmem><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVmem>
int launch_dk(const scl::AttnArgs& a, cudaStream_t st) {
  switch (scl::round_up(a.dh, 16)) {
    case 16: return launch<16, kVmem>(a, st);
    case 32: return launch<32, kVmem>(a, st);
    case 48: return launch<48, kVmem>(a, st);
    case 64: return launch<64, kVmem>(a, st);
    case 80: return launch<80, kVmem>(a, st);
    case 96: return launch<96, kVmem>(a, st);
    case 112: return launch<112, kVmem>(a, st);
    default: return launch<128, kVmem>(a, st);
  }
}

}  // namespace

extern "C" int scl_rowwise_smem_bytes(int dh) { return smem_bytes(dh); }

extern "C" int scl_rowwise_attention(const void* q, const void* k, const void* v,
                                     const void* lens, void* out, int B, int H, int L,
                                     int S, int dh, const long long* strides,
                                     int causal, int vmem_rounding, float scale,
                                     void* stream) {
  if (dh % 8 != 0 || dh > 128 || L < 1 || S < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const scl::AttnArgs a =
      scl::make_attn_args(q, k, v, lens, out, B, H, L, S, dh, strides, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vmem_rounding ? launch_dk<true>(a, st) : launch_dk<false>(a, st);
}
