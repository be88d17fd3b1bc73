// HuBERT's positional convolution with its epilogue, over bf16 (B, T, D)
// channels-last hidden states, sm_90a:
//
//   out[b, t, c] = x[b, t, c] + gelu_tanh(bf16(bf16(conv[b, t, c]) + b[c]))
//   conv[b, t, c] = sum_j sum_ci x[b, t + j - 64, g C + ci] w[c, ci, j]
//
// with j over the 128 taps, C = D / 16 channels a group (g = c's group), x
// zero outside [0, T), the sums in f32 and a bf16 rounding after the conv,
// after the bias add, after GELU and after the residual add: the rounding
// points of `models/hubert.py` (conv1d, + b, GELU, + x in bf16). The k = 128
// conv's output has T + 1 steps; the trailing one (SamePad's trim) is never
// computed.
//
// Replaces: no TPU kernel. The JAX package leaves this conv to XLA; the
// port's stock route is cuDNN's grouped implicit_convolve_sgemm, which ran
// at ~1 % of this conv's bound (61.0 ms of a 209 ms encode call at (256,
// 319, 768)). It is the op `speechclip::pos_conv` (`kernels/pos_conv.py`).
//
// What bounds it on the H100: operations. 2 B T D C 128 FLOP: 0.77 TFLOP
// at (256, 319, 768), 0.78 ms at 989 TFLOP/s, against 250 MB of x and out.
//
// The design: per group a GEMM of M = B T rows, N = C, K = 128 taps x C,
// whose A operand for tap j is the input shifted by j rows (a Toeplitz
// operand: never materialised).
//   - A block takes one (utterance, group) and 64-row subtiles of it, one a
//     warp (up to 5 warps: T = 319 is one block of 320 rows). Its window of
//     x, (64 rows a warp + 127) x C, is copied into shared memory once, by
//     cp.async with zero fill past either end of the utterance (the conv's
//     padding), and stays there for all 128 taps and the residual.
//   - A shifted start breaks wgmma's swizzled operand, so the products are
//     mma.sync m16n8k16 with A taken from the window by ldmatrix at per-row
//     addresses. A warp owns 64 rows x all C columns (f32 accumulators in
//     registers). Taps are walked as j = j0 + 8 s (j0 outer): the A
//     fragment of rows [16 i + j0 + 8 s, + 16) is two 8-row halves, and
//     consecutive s share all but one of them, so each tap step loads one
//     8-row half (a 256-byte ldmatrix.x2) for 4 x C / 8 products.
//   - B, a tap's C x C weight, streams through a cp.async ring in stages of
//     8 taps x 16 input channels (the wrapper packs the weight in that
//     order), rows padded to 24 bf16 so the ldmatrix rows of one 8x8
//     matrix fall in distinct banks (the window's rows: C + 8). All 16
//     groups' weights (11 MB at C = 48, 19 MB at C = 64) stay in L2.
//   - The epilogue rounds as the model does, reads the residual from the
//     window and writes each (row, 2 channels) pair as one bf16x2.
#include "attention_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroups = 16;
constexpr int kTaps = 128;
constexpr int kWarpRows = 64;   // a warp's rows: MF m16 fragments
constexpr int MF = kWarpRows / 16;
constexpr int kMaxWarps = 5;    // a block's subtiles (kernels/pos_conv.py MAX_WARPS)
constexpr int kHalo = kTaps - 1;  // extra window rows: 64 before, 63 after
constexpr int kLdb = 24;        // a weight stage's row: 16 input channels + 8 pad
constexpr int kStageTaps = 8;   // taps a ring stage holds

template <int C>
struct Plan {
  static constexpr int KK = C / 16;  // k16 slices of a group's input channels
  static constexpr int NF = C / 8;   // n8 fragments of its output channels
  static constexpr int LDW = C + 8;  // a window row, padded
  static constexpr int STAGE = kStageTaps * C * kLdb;  // elements of one stage
  static constexpr int NST = C == 48 ? 3 : 2;          // ring stages (kernels/pos_conv.py)
  static constexpr int N_STAGES = 8 * KK * 2;          // (j0, kk, half) stages a block streams
  static int smem_bytes(int warps) {
    return (NST * STAGE + (kWarpRows * warps + kHalo) * LDW) * 2;
  }
};

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16(x + bf16(gelu_tanh(bf16(bf16(acc) + bias)))), PyTorch's tanh GELU
// in f32 (ActivationGeluKernel.cu: kBeta * (v + kKappa * v^3), then
// 0.5 v (1 + tanh)).
__device__ __forceinline__ float epilogue(float acc, float bias, float x) {
  const float kBeta = 0.7978845608028654f;  // M_SQRT2 * M_2_SQRTPI * 0.5
  const float kKappa = 0.044715f;
  const float v = round_bf16(round_bf16(acc) + bias);
  const float cube = v * v * v;
  const float inner = kBeta * (v + kKappa * cube);
  return x + round_bf16(0.5f * v * (1.0f + tanhf(inner)));
}

// The eight tap steps s = S0 .. S0 + 7 of one (j0, kk): hf[q] holds the
// 8-row half at window row base + 8 q (two 8x8 matrices: input channels
// 0-7, 8-15), the A fragment of m16 tile i at step s is (hf[2i + s], hf[2i
// + s + 1]); the half a step first needs is loaded there, and only tile MF
// - 1 waits for it. B comes one pair of n8 fragments at a time (4
// registers), each pair's ldmatrix issued while the previous pair's
// products run.
template <int C, int S0>
__device__ __forceinline__ void tap_steps(float (&acc)[MF][C / 8][4],
                                          uint32_t (&hf)[2 * MF + 15][2],
                                          const bf16* a_lane, const bf16* b_lane) {
  using P = Plan<C>;
  constexpr int NP = P::NF / 2;  // n8 fragment pairs
  uint32_t bf[2][4];
  scl::ldsm_x4(bf[0], b_lane);
#pragma unroll
  for (int sl = 0; sl < kStageTaps; ++sl) {
    const int s = S0 + sl;
    if (s == 0) {
#pragma unroll
      for (int q = 0; q < 2 * MF; ++q) ldsm_x2(hf[q], a_lane + q * 8 * P::LDW);
    } else {
      ldsm_x2(hf[s + 2 * MF - 1], a_lane + (s + 2 * MF - 1) * 8 * P::LDW);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int next = sl * NP + p + 1;
      if (next < kStageTaps * NP)
        scl::ldsm_x4(bf[next % 2], b_lane + ((next / NP) * C + (next % NP) * 16) * kLdb);
      const uint32_t* b = bf[(sl * NP + p) % 2];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const uint32_t a[4] = {hf[2 * i + s][0], hf[2 * i + s + 1][0], hf[2 * i + s][1],
                               hf[2 * i + s + 1][1]};
        scl::mma16816(acc[i][2 * p], a, b[0], b[1]);
        scl::mma16816(acc[i][2 * p + 1], a, b[2], b[3]);
      }
    }
  }
}

struct Args {
  const bf16* x;     // (B, T, 16 C)
  const bf16* w;     // (16, 8 j0, C / 16 kk, 16 s, C n, 16 ci): w[g C + n, 16 kk + ci, j0 + 8 s]
  const bf16* bias;  // (16 C,)
  bf16* out;         // (B, T, 16 C)
  int T, tiles;      // tiles: blocks an utterance (each up to kMaxWarps subtiles)
};

template <int C>
__global__ void __launch_bounds__(32 * kMaxWarps, 2) pos_conv_kernel(Args p) {
  using P = Plan<C>;
  constexpr int D = kGroups * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* win = ring + P::NST * P::STAGE;

  const int g = blockIdx.x % kGroups;
  const int rest = blockIdx.x / kGroups;
  const int b = rest / p.tiles;
  const int warps = blockDim.x / 32;
  const int t0 = (rest % p.tiles) * warps * kWarpRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = p.T;

  // the window: rows t0 - 64 .. t0 + 64 warps + 62, zero outside [0, T)
  const bf16* xg = p.x + static_cast<long long>(b) * T * D + g * C;
  const int win_rows = kWarpRows * warps + kHalo;
  for (int i = threadIdx.x; i < win_rows * (C / 8); i += blockDim.x) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    const int t = t0 - 64 + r;
    const bool ok = t >= 0 && t < T;
    scl::cp_async_16(win + r * P::LDW + c, ok ? xg + static_cast<long long>(t) * D + c : p.x, ok);
  }
  const bf16* wg = p.w + static_cast<long long>(g) * kTaps * C * C;
  auto load_stage = [&](int st) {
    const bf16* src = wg + static_cast<long long>(st) * kStageTaps * C * 16;
    bf16* dst = ring + (st % P::NST) * P::STAGE;
    for (int i = threadIdx.x; i < kStageTaps * C * 2; i += blockDim.x)
      scl::cp_async_16(dst + (i >> 1) * kLdb + (i & 1) * 8, src + (i >> 1) * 16 + (i & 1) * 8,
                       true);
  };
#pragma unroll
  for (int st = 0; st < P::NST - 1; ++st) {
    load_stage(st);
    scl::cp_async_commit();  // the first group holds the window too
  }
  // stage st's buffer is full once its group has landed; the buffer the
  // next load overwrites was read by every warp before the barrier
  auto stage_begin = [&](int st) {
    scl::cp_async_wait<P::NST - 2>();
    __syncthreads();
    if (st + P::NST - 1 < P::N_STAGES) load_stage(st + P::NST - 1);
    scl::cp_async_commit();
  };

  float acc[MF][P::NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int nf = 0; nf < P::NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nf][e] = 0.0f;

  const bool active = t0 + warp * kWarpRows < T;
  // lane addresses: A rows (lanes 0-7: channels 0-7, 8-15: channels 8-15 of
  // the k16 slice); B rows n of the pair's two n8 fragments and their k halves
  const bf16* a_base = win + (warp * kWarpRows + lane % 8) * P::LDW + ((lane / 8) % 2) * 8;
  const int b_off = ((lane / 16) * 8 + lane % 8) * kLdb + ((lane / 8) % 2) * 8;
  int st = 0;
  for (int j0 = 0; j0 < 8; ++j0) {
    for (int kk = 0; kk < P::KK; ++kk) {
      uint32_t hf[2 * MF + 15][2];
      const bf16* a_lane = a_base + j0 * P::LDW + kk * 16;
      stage_begin(st);
      if (active) tap_steps<C, 0>(acc, hf, a_lane, ring + (st % P::NST) * P::STAGE + b_off);
      ++st;
      stage_begin(st);
      if (active) tap_steps<C, 8>(acc, hf, a_lane, ring + (st % P::NST) * P::STAGE + b_off);
      ++st;
    }
  }
  if (!active) return;

  const bf16* bias = p.bias + g * C;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int r = warp * kWarpRows + 16 * i + 8 * hv + lane / 4;  // block-local row
      const int t = t0 + r;
      if (t >= T) continue;
      const bf16* xr = win + (r + 64) * P::LDW;
      bf16* o = p.out + (static_cast<long long>(b) * T + t) * D + g * C;
#pragma unroll
      for (int nf = 0; nf < P::NF; ++nf) {
        const int c = nf * 8 + 2 * (lane % 4);
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
        const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c));
        *reinterpret_cast<__nv_bfloat162*>(o + c) =
            __floats2bfloat162_rn(epilogue(acc[i][nf][2 * hv], bv.x, xv.x),
                                  epilogue(acc[i][nf][2 * hv + 1], bv.y, xv.y));
      }
    }
  }
}

template <int C>
int launch(const Args& a, int batch, int warps, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(pos_conv_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Plan<C>::smem_bytes(kMaxWarps));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long blocks = static_cast<long long>(kGroups) * a.tiles * batch;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  pos_conv_kernel<C><<<static_cast<unsigned>(blocks), 32 * warps, Plan<C>::smem_bytes(warps),
                       stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (B, T, 16 c) bf16; w packed by kernels/pos_conv.py `pack_weight`;
// bias (16 c,) bf16; `tiles` blocks an utterance of `warps` 64-row subtiles
// each (kernels/pos_conv.py `tile_plan`).
extern "C" int scl_pos_conv(const void* x, const void* w, const void* bias, void* out,
                            int batch, int t, int c, int tiles, int warps, void* stream) {
  if (batch < 1 || t < 1 || tiles < 1 || warps < 1 || warps > kMaxWarps ||
      static_cast<long long>(tiles) * warps * kWarpRows < t ||
      (static_cast<long long>(tiles) - 1) * warps * kWarpRows >= t ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 4 || reinterpret_cast<uintptr_t>(out) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
         static_cast<const bf16*>(bias), static_cast<bf16*>(out), t, tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 48) return launch<48>(a, batch, warps, s);
  if (c == 64) return launch<64>(a, batch, warps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One block's dynamic shared memory at `warps` subtiles, for width c.
extern "C" int scl_pos_conv_smem_bytes(int c, int warps) {
  if (c == 48) return Plan<48>::smem_bytes(warps);
  if (c == 64) return Plan<64>::smem_bytes(warps);
  return -1;
}
