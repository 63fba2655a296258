// The backward pass of causal and/or sliding-window GQA attention (kernel
// K3's gradient) on bfloat16 q, k, v, o and dO, for Hopper (sm_90a): bf16
// wgmma on bf16 tiles that TMA lands once, P and dS in two bf16 parts.
//
// Replaces: XLA's gradient of src/repro/models/attention.py:50 (mha) and
// :120 (banded_mha), for bfloat16 operands (float32 ones take
// csrc/flash_attention_bwd.cu). The reference has no Pallas backward. Same
// function as the gradient of kernels/flash_attention.py:
// flash_attention_ref: q (B,Sq,H,D), k and v (B,Skv,G,D), head h reading
// kv head h / (H/G), scale D^-0.5, the mask of the forward (causal,
// window, keys past Skv); dq, dk and dv written in bfloat16, rounded to
// nearest even.
//
// The FlashAttention-2 decomposition of the float32 kernel, with the
// forward's log-sum-exp (lse, (B,H,Sq) float32, from
// csrc/flash_attention_bf16.cu) standing in for the softmax's max and sum:
//   (a) delta = rowsum(dO * O) per (b, h, q) row (hopper.cuh:
//       attn_bwd_delta, the float32 kernel's pass);
//   (b) dK, dV: one block per (kv head, batch, 64 WG kv rows), walking the
//       R = H/G query heads of its group and the q tiles the mask lets
//       through: S^T = K Q^T and dP^T = V dO^T, P = exp(scale S - lse),
//       dS = P (dP - delta), dV += P^T dO, dK += dS^T Q. Each kv head's
//       dK and dV are written once by the block that owns them: no
//       atomics, the same bits on every launch;
//   (c) dQ: one block per (head, batch, 64 WG q rows), S = Q K^T and dP =
//       dO V^T over the kv tiles the mask lets through, dQ += dS K.
// (b) and (c) each recompute S and dP (seven products), so that dQ needs
// no atomics across the blocks of (b). A row that sees no key (lse = +inf)
// gets P = 0: no gradient to its q, nothing to dk and dv.
//
// Bound: operations. At qwen1.5-0.5b's training shape (B=4, S=2048,
// H=G=16, D=64, causal) the five products of the gradient over the
// causal half are 85.9 GFLOP: 0.0869 ms at the 989 TFLOP/s dense bf16
// peak of an H100 SXM. This design runs each of the three products with
// P or dS (dV, dK, dQ) twice, P and dS in two bf16 parts, beside S and dP
// in (b) and again in (c): ten bf16 product units where the bound counts
// five, so its own floor is 2 times the bound (0.174 ms at qwen's shape;
// chip_smoke.py's time_k3_bwd states both).
//
// Arithmetic (kernels/flash_attention.py:attention_bwd_bf16 is a float64
// model of it, bwd_error_bound's bfloat16 terms its bound):
// - S and dP are bf16 wgmma m64nNk16 .f32.bf16.bf16 on the tiles as they
//   are: each product of two bf16 numbers is exact in float32, the sum
//   float32. The scale is applied to S after the product, in float32, as
//   the bfloat16 forward does, folded into the exponent: P = 2^y with y =
//   fmaf(S, scale log2(e), -lse log2(e)), 2^y by the SFU's ex2.approx
//   (what exp2f reduces to). As expf it cost 35% of the kernel's time
//   (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, section 6).
// - P and dS leave the accumulators in float32 and are split into two
//   bf16 parts, hi = bf16(x) and lo = bf16(x - hi), within 2^-16 |x|
//   (hopper.cuh: split_bf16x2); dV += P^T dO, dK += dS^T Q and dQ += dS K
//   take the hi and the lo part each from registers as the A operand. An
//   m64nN accumulator's columns 8j + 2t, 2t + 1 of rows g and g + 8 are
//   the k16 A fragment's registers (the forward's P): no permutation of
//   the streamed rows and no transposed copy.
//
// Design.
// - One template, fa_bwd_pass<DP, DKDV, WG>: a block of WG consumer
//   warpgroups owns 64 WG rows of a fixed side X (64 a warpgroup) and one
//   producer warp streams the tiles of N rows of a side Y that the mask
//   lets through, in a ring of STAGES stages passed on full and empty
//   mbarriers (the producer waits until every consumer warp has released
//   a stage, the consumers until its bytes have landed).
//     (b) X = K and V (kv rows), Y = Q and dO (q rows), lse and delta of
//         the tile's q rows landing with it (the producer's lanes);
//     (c) X = Q and dO (q rows), Y = K and V (kv rows), lse and delta of
//         the warpgroup's rows in registers.
//   In both, S' = X1 Y1^T and dP' = X2 Y2^T (S^T and dP^T in (b)), then
//   (b) dV += P'^T-as-A times Y2 and dK += dS'-as-A times Y1, (c) dQ +=
//   dS-as-A times Y1.
// - Layout: every tile is bfloat16 in the 128-byte swizzle (hopper.cuh:
//   sw128), D padded with zeros to 64 or 128 (the S and dP walks stop at
//   D rounded up to 16). X is read K-major as A; each Y tile lands once
//   and is read twice: K-major (d contiguous) as B of S' and dP', and
//   MN-major with the transpose bit as B of the products from registers
//   (K = the tile's rows, N = d), which 16-bit wgmma allows.
// - Loads: the producer's lane 0 lands Y by TMA (cp.async.bulk.tensor,
//   boxes of 64 d values x N rows through a 4-D tensor map (D, heads,
//   rows, B): a tile past the sequence is zero-filled inside its own
//   batch row; tma.cuh). Where TMA cannot take a tile (D % 8 != 0, a base
//   off 16 bytes, D < 64) the producer warp copies it to the same
//   swizzled addresses, by 16-byte cp.async where D % 8 == 0 and the bases
//   are aligned, else one value at a time through registers: the
//   forward's three routes. X is read once per block by the consumers.
// - Masks. Each accumulator element maps to its (q, kv) pair by the
//   m64nN layout before the forward's mask (hopper.cuh: attn_visible),
//   applied only on tiles that cross the causal diagonal, the window's
//   edge or the end of either sequence. The block walks only the tiles
//   the mask lets through; a warpgroup skips the products of a tile the
//   mask rules out for all its rows (it still waits for the tile and
//   releases it).
// - Causal imbalance. The tile index is the grid's slowest dimension
//   (blockIdx.z), ordered so that the longest walks are launched first:
//   kv tile 0 in (b), the last q tile in (c).
// - Tiles. Two warpgroups (128 fixed rows sharing each streamed tile)
//   where the fixed side has 256 rows or more, else one; but (c) at D =
//   64 always takes one, three blocks an SM: blocks out of step overlap
//   one's P and dS with another's products (7-9% faster than two
//   warpgroups, whose tiles keep them in step; NVIDIA H100 80GB HBM3,
//   700.00 W; PERF.md, section 6). With two, the
//   producer is a whole warpgroup (one warp of it working) that gives its
//   registers to the consumers (setmaxnreg: 40 and 232 a thread): 12
//   warps, 3 on each of the SM's four 16,384-register quarters, allow
//   only 168 a thread otherwise, where (b) spilled 2,280 bytes at D =
//   128 and ran mixtral-8x7b's shape in 11.47 ms. (b) holds the dK and
//   dV accumulators, D registers a thread, beside S^T and dP^T, N: N = 64
//   at D = 64 and 32 at D = 128. (c) holds D / 2 for dQ: N = 64 at both.
//   Shared memory a block, of the 232,448 a block may use (X, STAGES
//   stages of Y, (b)'s lse and delta, the barriers, at a 1,024-byte
//   aligned base):
//       D (padded)                  64                128
//       (b) N: WG = 1 / 2    64: 68,144 / 84,528   32: 83,760 / 116,528
//       (c) N: WG = 1 / 2    64: 66,608 / -        64: 132,144 / 164,912
//   Registers a thread, from ptxas -v (kernels/build.py passes -Xptxas
//   -v; sm_90a), WG = 1 / 2 (two: 168 at launch, the consumers' 232
//   after setmaxnreg):
//       D (padded)        64           128
//       (b)           209 / 232    229 / 232
//       (c)           126 / -      185 / 232
//   and no spill at any D.
//
// Accuracy: kernels/flash_attention.py:bwd_error_bound (its bfloat16
// terms, with the bfloat16 inputs passed to it) states the bound against
// the plain version flash_attention_bwd_ref.
//
// Interface: plain C, loaded with ctypes. flash_attention_bwd_bf16()
// launches the three kernels on the given stream, does not synchronise,
// and returns cudaGetLastError() (or the error of raising the
// shared-memory limit, or -2 where a tensor map is refused).
// flash_attention_bwd_bf16_shape() reports the launches it would make.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>
#include "hopper.cuh"
#include "tma.cuh"

namespace {

constexpr int STAGES = 3;       // tiles in the ring
constexpr int ATOM = 64;        // bf16 values in a 128-byte swizzled row
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz.f32, what exp2f reduces to: within 2
// ulp; a result below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// registers a thread of the producer warpgroup and of the consumers where
// two consumer warpgroups take the producer's (setmaxnreg): 12 warps, 3
// on each of the SM's four 16,384-register quarters, 32 (2 x 232 + 40)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

enum Load { LOAD_TMA = 0, LOAD_CP_ASYNC = 1, LOAD_REGS = 2 };

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;             // (B, H, Sq)
  float* delta;                 // (B, H, Sq) scratch
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, Sq, Skv, H, G, D;
  int causal;
  int window;                   // <= 0: no window
  float scale;
  int load;                     // how the tiles land: Load
  int pairs;                    // outputs written two values at a time
};

// The geometry of (b) (DKDV) and (c): N streamed rows a tile, 64 WG fixed
// rows a block, and shared memory in bytes from a 1,024-byte aligned base:
// X1, X2, the ring ([Y1, Y2] a stage), (b)'s lse and delta ([lse, delta][N]
// a stage), the full and empty barriers.
template <int DP, bool DKDV, int WG>
struct Geo {
  static constexpr int N = DKDV && DP == 128 ? 32 : 64;
  static constexpr int BX = 64 * WG;
  // one producer warp, or with two consumer warpgroups a producer
  // warpgroup (one warp of it working) whose registers go to them
  static constexpr int THREADS = 128 * WG + (WG == 2 ? 128 : 32);
  // blocks an SM: (c) at D = 64 runs three of one warpgroup (registers
  // capped at 136 a thread; shared memory 3 x 66,608 bytes)
  static constexpr int BLOCKS = !DKDV && DP == 64 ? 3 : 1;
  static constexpr int X_BYTES = BX * DP * 2;         // X1 or X2
  static constexpr int Y_BYTES = N * DP * 2;          // Y1 or Y2 of a stage
  static constexpr int STAGE_BYTES = 2 * Y_BYTES;
  static constexpr int RING_OFF = 2 * X_BYTES;
  static constexpr int STATS_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int STATS = DKDV ? 2 * N : 0;      // floats a stage
  static constexpr int BAR_OFF = STATS_OFF + STAGES * STATS * 4;
  static constexpr size_t BYTES = (size_t)BAR_OFF + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ bool visible(int qp, int kp, const Args& a) {
  return attn_visible(qp, kp, a.Sq, a.Skv, a.causal, a.window);
}

// The producer warp: streamed tiles 0 .. n_tiles - 1 into the ring, stage
// it % STAGES, each once its last reader released it. Tile it is rows c0
// = (t_first + it % n_per) N .. c0 + N - 1 of head head0 + it / n_per of
// Y1 and Y2: q and dO in (b) (with lse and delta of those rows), k and v
// in (c) (n_per = n_tiles).
template <int DP, int N, bool DKDV>
__device__ __forceinline__ void produce(const CUtensorMap* tm1,
                                        const CUtensorMap* tm2,
                                        const Args& a, uint8_t* ring,
                                        uint32_t sring, float* stats,
                                        uint32_t full0, uint32_t empty0,
                                        int b, int head0, int t_first,
                                        int n_per, int n_tiles, int lane) {
  constexpr int YB = N * DP * 2;
  const bf16* y1 = DKDV ? a.q : a.k;
  const bf16* y2 = DKDV ? a.dout : a.v;
  const int heads = DKDV ? a.H : a.G, rows = DKDV ? a.Sq : a.Skv;
  const int64_t stride = (int64_t)heads * a.D;      // values between rows
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int u = it / STAGES;
    const uint32_t full = full0 + 8 * s;
    if (u > 0) mbar_wait(empty0 + 8 * s, (u - 1) & 1);
    const int hh = head0 + it / n_per;
    const int c0 = (t_first + it % n_per) * N;
    if constexpr (DKDV) {
      float* st = stats + s * 2 * N;
      const int64_t at = ((int64_t)b * a.H + hh) * a.Sq;
      for (int i = lane; i < N; i += 32) {
        const int row = c0 + i;
        const bool ok = row < a.Sq;
        st[i] = ok ? a.lse[at + row] * LOG2E : 0.f;
        st[N + i] = ok ? a.delta[at + row] : 0.f;
      }
    }
    const uint32_t s1 = sring + s * 2 * YB, s2 = s1 + YB;
    if (a.load == LOAD_TMA) {
      __syncwarp();                 // lse and delta stored, then the arrival
      if (lane == 0) {
        mbar_expect_tx(full, 2 * YB);
#pragma unroll
        for (int half = 0; half < DP / ATOM; ++half) {
          tma_load_4d(s1 + half * N * 128, tm1, full, ATOM * half, hh, c0, b);
          tma_load_4d(s2 + half * N * 128, tm2, full, ATOM * half, hh, c0, b);
        }
      }
      continue;
    }
    const int64_t base = ((int64_t)b * rows * heads + hh) * a.D;
    if (a.load == LOAD_CP_ASYNC) {
      constexpr int CH = DP / 8;              // 16-byte chunks a row
      for (int i = lane; i < N * CH; i += 32) {
        const int r = i / CH, c = 8 * (i % CH), row = c0 + r;
        const bool ok = row < rows && c < a.D;
        const int64_t off = ok ? base + row * stride + c : 0;
        const uint32_t at = sw128(r, c, N);
        cp_async16_to(s1 + at, y1 + off, ok ? 16 : 0);
        cp_async16_to(s2 + at, y2 + off, ok ? 16 : 0);
      }
      cp_async_wait_all();
    } else {
      uint8_t* g1 = ring + s * 2 * YB;
      uint8_t* g2 = g1 + YB;
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int i = lane; i < N * DP; i += 32) {
        const int r = i / DP, c = i % DP, row = c0 + r;
        const bool ok = row < rows && c < a.D;
        const int64_t off = base + row * stride + c;
        const uint32_t at = sw128(r, c, N);
        *(bf16*)(g1 + at) = ok ? y1[off] : zero;
        *(bf16*)(g2 + at) = ok ? y2[off] : zero;
      }
    }
    fence_async_smem();             // the copies, for wgmma's reads
    __syncwarp();
    if (lane == 0) mbar_arrive(full);
  }
}

// rows r0 .. r0 + 64 WG - 1 of x1 and x2 (one head, `stride` values
// between rows, `rows` in all) into X1 and X2, swizzled, zeros past
// `rows` and D: 16-byte loads where the tiles take cp.async or TMA
template <int DP, int WG>
__device__ __forceinline__ void load_fixed(uint8_t* X1, uint8_t* X2,
                                           const bf16* x1, const bf16* x2,
                                           int64_t stride, int r0, int rows,
                                           const Args& a) {
  constexpr int BX = 64 * WG, NT = 128 * WG;
  if (a.load != LOAD_REGS) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < BX * CH; i += NT) {
      const int r = i / CH, c = 8 * (i % CH), row = r0 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u), w = u;
      if (row < rows && c < a.D) {
        u = ld16(x1 + row * stride + c);
        w = ld16(x2 + row * stride + c);
      }
      *(uint4*)(X1 + sw128(r, c, BX)) = u;
      *(uint4*)(X2 + sw128(r, c, BX)) = w;
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < BX * DP; i += NT) {
      const int r = i / DP, c = i % DP, row = r0 + r;
      const bool ok = row < rows && c < a.D;
      *(bf16*)(X1 + sw128(r, c, BX)) = ok ? x1[row * stride + c] : zero;
      *(bf16*)(X2 + sw128(r, c, BX)) = ok ? x2[row * stride + c] : zero;
    }
  }
}

// (b) with DKDV, else (c), with WG consumer warpgroups and one producer
// warp: see the note at the top
template <int DP, bool DKDV, int WG>
__global__ void __launch_bounds__(Geo<DP, DKDV, WG>::THREADS,
                                  Geo<DP, DKDV, WG>::BLOCKS)
    fa_bwd_pass(const __grid_constant__ CUtensorMap tm1,
                const __grid_constant__ CUtensorMap tm2, Args a) {
  using L = Geo<DP, DKDV, WG>;
  static_assert(L::BYTES <= 232448, "shared memory");
  constexpr int N = L::N, BX = L::BX, CONSUMERS = WG * 128;
  constexpr int NB = N / 8, DB = DP / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sx1 = (uint32_t)__cvta_generic_to_shared(base);
  const uint32_t sx2 = sx1 + L::X_BYTES;
  const uint32_t sring = sx1 + L::RING_OFF;   // stage s at + s STAGE_BYTES
  float* stats = (float*)(base + L::STATS_OFF);
  const uint32_t full0 = sx1 + L::BAR_OFF;    // full[s] at + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int R = a.H / a.G, D = a.D, b = blockIdx.y;
  // the fixed rows r0 .. r0 + BX - 1 and the streamed tiles the mask lets
  // through: (b) n_per q tiles for each of the R heads, (c) n_per kv tiles
  int h, kvh, r0, t_first, n_per, n_tiles;
  if constexpr (DKDV) {
    kvh = blockIdx.x;
    h = kvh * R;
    r0 = blockIdx.z * BX;
    const int k_last = min(r0 + BX, a.Skv) - 1;
    const int q_lo = a.causal ? r0 : 0;
    const int q_hi = a.window > 0 ? min(a.Sq - 1, k_last + a.window - 1)
                                  : a.Sq - 1;
    t_first = q_lo / N;
    n_per = q_hi >= q_lo ? q_hi / N - t_first + 1 : 0;
    n_tiles = R * n_per;
  } else {
    h = blockIdx.x;
    kvh = h / R;
    r0 = (a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BX;
    const int q_last = min(r0 + BX, a.Sq) - 1;
    const int k_hi = a.causal ? min(a.Skv - 1, q_last) : a.Skv - 1;
    const int k_lo = a.window > 0 ? max(0, r0 - a.window + 1) : 0;
    t_first = k_lo / N;
    n_per = k_hi >= k_lo ? k_hi / N - t_first + 1 : 0;
    n_tiles = n_per;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * WG);          // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= 4 * WG) {
    if constexpr (WG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 4 * WG)
      produce<DP, N, DKDV>(&tm1, &tm2, a, base + L::RING_OFF, sring, stats,
                           full0, empty0, b, DKDV ? h : kvh, t_first, n_per,
                           n_tiles, lane);
    return;
  }
  if constexpr (WG == 2) setmaxnreg_inc<CONSUMER_REGS>();

  const int64_t q_row = (int64_t)a.H * D, kv_row = (int64_t)a.G * D;
  if constexpr (DKDV)
    load_fixed<DP, WG>(base, base + L::X_BYTES,
                       a.k + (int64_t)b * a.Skv * kv_row + kvh * D,
                       a.v + (int64_t)b * a.Skv * kv_row + kvh * D, kv_row,
                       r0, a.Skv, a);
  else
    load_fixed<DP, WG>(base, base + L::X_BYTES,
                       a.q + (int64_t)b * a.Sq * q_row + h * D,
                       a.dout + (int64_t)b * a.Sq * q_row + h * D, q_row, r0,
                       a.Sq, a);
  fence_async_smem();
  named_sync(1, CONSUMERS);

  // this warpgroup's fixed rows f0 .. f0 + 63; this thread's row0, row0 + 8
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = r0 + 64 * wg;
  const int fixed_rows = DKDV ? a.Skv : a.Sq;
  const int f_last = min(f0 + 63, fixed_rows - 1);
  const bool wg_live = f0 < fixed_rows;
  const int row0 = f0 + 16 * wl + g;
  const int d_steps = (D + 15) / 16;             // k16 steps of S over d
  const float c1 = a.scale * LOG2E;              // S to base-2 exponents
  // (c): this thread's rows' log2(e) lse and delta
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};
  if constexpr (!DKDV) {
    const int64_t at = ((int64_t)b * a.H + h) * a.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < a.Sq) {
        lse_r[r] = a.lse[at + row0 + 8 * r] * LOG2E;
        del_r[r] = a.delta[at + row0 + 8 * r];
      }
  }

  // acc1 = dS'-as-A times Y1 ((b) dK, (c) dQ); acc2 = (b)'s dV
  float acc1[DP / 2], acc2[DKDV ? DP / 2 : 1];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKDV ? DP / 2 : 1); ++i) acc2[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int c0 = (t_first + it % n_per) * N;
    // whether the mask rules out every pair of this tile and the
    // warpgroup's rows, and whether it may rule out any
    bool skip, edge;
    if constexpr (DKDV) {           // fixed kv f0 .. f_last, q c0 .. + N - 1
      skip = !wg_live || (a.causal && f0 > c0 + N - 1) ||
             (a.window > 0 && c0 >= f_last + a.window);
      edge = c0 + N > a.Sq || f0 + 64 > a.Skv ||
             (a.causal && f0 + 63 > c0) ||
             (a.window > 0 && c0 + N - 1 >= f0 + a.window);
    } else {                        // fixed q f0 .. f_last, kv c0 .. + N - 1
      skip = !wg_live || (a.causal && c0 > f_last) ||
             (a.window > 0 && c0 + N - 1 <= f0 - a.window);
      edge = c0 + N > a.Skv || f0 + 64 > a.Sq ||
             (a.causal && c0 + N - 1 > f0) ||
             (a.window > 0 && c0 <= f_last - a.window);
    }
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    if (!skip) {
      const uint32_t y1 = sring + s * L::STAGE_BYTES, y2 = y1 + L::Y_BYTES;
      const float* st = stats + s * L::STATS;

      // S' = X1 Y1^T and dP' = X2 Y2^T for the warpgroup's 64 rows
      float sc[N / 2], dp[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sc[i] = dp[i] = 0.f;
      pin(sc);
      pin(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk >= d_steps) break;
        const uint32_t xa = (kk / 4) * BX * 128 + wg * 64 * 128 + (kk % 4) * 32;
        const uint32_t ya = (kk / 4) * N * 128 + (kk % 4) * 32;
        wgmma_bf16_ss<N>(sc, sw128_desc(sx1 + xa, 16, 1024),
                         sw128_desc(y1 + ya, 16, 1024));
        wgmma_bf16_ss<N>(dp, sw128_desc(sx2 + xa, 16, 1024),
                         sw128_desc(y2 + ya, 16, 1024));
      }
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dp);

      // P and dS in place; sc[4j + 2r + c] is fixed row row0 + 8r,
      // streamed row c0 + 8j + 2t + c
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c, col = 8 * j + 2 * t + c;
            float lse, del;
            bool ok = true;
            if constexpr (DKDV) {
              lse = st[col];
              del = st[N + col];
              if (edge) ok = visible(c0 + col, row0 + 8 * r, a);
            } else {
              lse = lse_r[r];
              del = del_r[r];
              if (edge) ok = visible(row0 + 8 * r, c0 + col, a);
            }
            const float p = ok ? ex2(fmaf(sc[e], c1, -lse)) : 0.f;
            dp[e] = p * (dp[e] - del);
            sc[e] = p;
          }

      // the k16 A fragments of P' and dS' in two bf16 parts: step j takes
      // streamed rows 16j .. 16j + 15, its registers the accumulators'
      // pairs (rows g, g + 8) x (column groups 2j, 2j + 1)
      uint32_t dh[N / 16][4], dl[N / 16][4];
      uint32_t ph[DKDV ? N / 16 : 1][4], pl[DKDV ? N / 16 : 1][4];
#pragma unroll
      for (int j = 0; j < N / 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * (2 * j + (i >> 1)) + 2 * (i & 1);
          split_bf16x2(dp[e], dp[e + 1], dh[j][i], dl[j][i]);
          if constexpr (DKDV)
            split_bf16x2(sc[e], sc[e + 1], ph[j][i], pl[j][i]);
        }
      pin(acc1);
      pin(acc2);
      wg_fence();
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        // Y (rows, d) read MN-major: 8 rows 1,024 bytes apart, the d
        // halves N rows of 128 bytes apart
        const uint64_t y1d = sw128_desc(y1 + j * 16 * 128, N * 128, 1024);
        wgmma_bf16_rs<DP>(acc1, dl[j], y1d);
        wgmma_bf16_rs<DP>(acc1, dh[j], y1d);
        if constexpr (DKDV) {
          const uint64_t y2d = sw128_desc(y2 + j * 16 * 128, N * 128, 1024);
          wgmma_bf16_rs<DP>(acc2, pl[j], y2d);
          wgmma_bf16_rs<DP>(acc2, ph[j], y2d);
        }
      }
      wg_commit();
      wg_wait_all();
      pin(acc1);
      pin(acc2);
    }
    __syncwarp();                   // this warp is done with stage s
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  if (!wg_live) return;
  // acc[4n + 2r + c] is fixed row row0 + 8r, d = 8n + 2t + c
  const int64_t x_row = DKDV ? kv_row : q_row;
  bf16* o1 = DKDV ? a.dk + (int64_t)b * a.Skv * kv_row + kvh * D
                  : a.dq + (int64_t)b * a.Sq * q_row + h * D;
  bf16* o2 = a.dv + (int64_t)b * a.Skv * kv_row + kvh * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= fixed_rows) continue;
#pragma unroll
    for (int n = 0; n < DB; ++n) {
      const int d = 8 * n + 2 * t, e = 4 * n + 2 * r;
      if (d >= D) continue;
      const float x0 = acc1[e] * a.scale, x1 = acc1[e + 1] * a.scale;
      bf16* p1 = o1 + row * x_row + d;
      if (a.pairs) {
        *(__nv_bfloat162*)p1 = __floats2bfloat162_rn(x0, x1);
      } else {
        p1[0] = __float2bfloat16_rn(x0);
        if (d + 1 < D) p1[1] = __float2bfloat16_rn(x1);
      }
      if constexpr (DKDV) {
        bf16* p2 = o2 + row * x_row + d;
        if (a.pairs) {
          *(__nv_bfloat162*)p2 = __floats2bfloat162_rn(acc2[e], acc2[e + 1]);
        } else {
          p2[0] = __float2bfloat16_rn(acc2[e]);
          if (d + 1 < D) p2[1] = __float2bfloat16_rn(acc2[e + 1]);
        }
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

int load_route(const void* q, const void* k, const void* v,
               const void* dout, int D) {
  if (D % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(dout))
    return LOAD_REGS;
  return D >= ATOM ? LOAD_TMA : LOAD_CP_ASYNC;
}

// warpgroups a block of (b) (DKDV) or (c) over `rows` fixed rows: two
// (128 rows sharing each streamed tile) from 256 rows on, but one for (c)
// at D = 64, where three blocks an SM run out of step
int warpgroups(int DP, bool DKDV, int rows) {
  return rows >= 256 && (DKDV || DP == 128) ? 2 : 1;
}

// (b) or (c): the streamed tensors' maps (q and dO, or k and v, as (D,
// heads, rows, B) with boxes of 64 d values x N rows) and the grid over
// the fixed rows in blocks of 64 WG
template <int DP, bool DKDV, int WG>
int launch_pass(const Args& a, cudaStream_t stream) {
  using L = Geo<DP, DKDV, WG>;
  auto kern = fa_bwd_pass<DP, DKDV, WG>;
  const size_t smem = L::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap t1, t2;
  memset(&t1, 0, sizeof(t1));
  memset(&t2, 0, sizeof(t2));
  if (a.load == LOAD_TMA && (DKDV ? a.Sq : a.Skv) > 0) {
    const bool ok =
        DKDV ? bf16_map_4d(&t1, a.q, a.D, a.H, a.Sq, a.B, L::N) &&
                   bf16_map_4d(&t2, a.dout, a.D, a.H, a.Sq, a.B, L::N)
             : bf16_map_4d(&t1, a.k, a.D, a.G, a.Skv, a.B, L::N) &&
                   bf16_map_4d(&t2, a.v, a.D, a.G, a.Skv, a.B, L::N);
    if (!ok) return -2;
  }
  const int rows = DKDV ? a.Skv : a.Sq;
  dim3 grid(DKDV ? a.G : a.H, a.B, (rows + L::BX - 1) / L::BX);
  kern<<<grid, L::THREADS, smem, stream>>>(t1, t2, a);
  return (int)cudaGetLastError();
}

template <int DP, bool DKDV>
int launch_rows(const Args& a, cudaStream_t stream) {
  if constexpr (!DKDV && DP == 64) return launch_pass<DP, DKDV, 1>(a, stream);
  else
    return warpgroups(DP, DKDV, DKDV ? a.Skv : a.Sq) == 2
               ? launch_pass<DP, DKDV, 2>(a, stream)
               : launch_pass<DP, DKDV, 1>(a, stream);
}

template <int DP>
int launch(const Args& a, cudaStream_t stream) {
  int e = attn_bwd_delta_launch(a.o, a.dout, a.delta, a.B, a.Sq, a.H, a.D,
                                stream);
  if (e) return e;
  // with Sq = 0 the dK/dV blocks see no query and write zeros
  if ((e = launch_rows<DP, true>(a, stream))) return e;
  if (a.Sq == 0) return 0;
  return launch_rows<DP, false>(a, stream);
}

template <int DP, bool DKDV>
size_t smem_bytes(int WG) {
  return WG == 2 ? Geo<DP, DKDV, 2>::BYTES : Geo<DP, DKDV, 1>::BYTES;
}

}  // namespace

// q, o, dout, dq (B,Sq,H,D); k, v, dk, dv (B,Skv,G,D), all bfloat16 and
// contiguous on the device; lse (B,H,Sq) float32 from the forward; delta
// (B,H,Sq) float32 scratch. D <= 128, H % G == 0, Skv >= 1, B and ceil(S
// / 64) up to 65,535. Returns a cudaError_t (0 on success); -1 for a D
// the kernel does not take, -2 where a tensor map is refused.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk,
                                        void* dv, int B, int Sq, int Skv,
                                        int H, int G, int D, int causal,
                                        int window, float scale,
                                        cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (D < 1 || D > 128) return -1;
  if (B > 65535 || (Sq + 63) / 64 > 65535 || (Skv + 63) / 64 > 65535)
    return (int)cudaErrorInvalidConfiguration;
  Args a{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
         (const bf16*)dout, lse, delta, (bf16*)dq, (bf16*)dk, (bf16*)dv,
         B, Sq, Skv, H, G, D, causal, window, scale, 0, 0};
  a.load = load_route(q, k, v, dout, D);
  a.pairs = D % 2 == 0 && ((uintptr_t)dq % 4) == 0 &&
            ((uintptr_t)dk % 4) == 0 && ((uintptr_t)dv % 4) == 0;
  return D <= ATOM ? launch<64>(a, stream) : launch<128>(a, stream);
}

// The launches flash_attention_bwd_bf16 makes for these arguments, into
// out[9]: D padded, stages, the load route (0 TMA, 1 cp.async, 2
// registers); then for (b) and for (c): warpgroups, streamed rows a tile,
// shared memory bytes.
extern "C" void flash_attention_bwd_bf16_shape(const void* q, const void* k,
                                               const void* v,
                                               const void* dout, int Sq,
                                               int Skv, int D, int* out) {
  const int DP = D <= ATOM ? 64 : 128;
  const int wb = warpgroups(DP, true, Skv), wc = warpgroups(DP, false, Sq);
  const int shape[9] = {
      DP, STAGES, load_route(q, k, v, dout, D),
      wb, DP == 64 ? Geo<64, true, 1>::N : Geo<128, true, 1>::N,
      (int)(DP == 64 ? smem_bytes<64, true>(wb) : smem_bytes<128, true>(wb)),
      wc, DP == 64 ? Geo<64, false, 1>::N : Geo<128, false, 1>::N,
      (int)(DP == 64 ? smem_bytes<64, false>(wc)
                     : smem_bytes<128, false>(wc))};
  memcpy(out, shape, sizeof(shape));
}
