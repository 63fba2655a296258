// The backward pass of causal and/or sliding-window GQA attention (kernel
// K3's gradient), for Hopper (sm_90a): its seven products on the tensor
// cores (wgmma, 3xTF32).
//
// Replaces: XLA's gradient of src/repro/models/attention.py:50 (mha) and
// :120 (banded_mha). The reference has no Pallas backward: its models
// differentiate the jnp attention through XLA, and its Pallas kernel
// (repro/kernels/flash_attention.py) has no custom_vjp. Same function as
// the gradient of kernels/flash_attention.py:flash_attention_ref: q
// (B,Sq,H,D), k and v (B,Skv,G,D), head h reading kv head h / (H/G), scale
// D^-0.5, the mask of the forward (causal, window, keys past Skv).
//
// The FlashAttention-2 decomposition, with the forward's log-sum-exp
// (lse, (B,H,Sq) float32, from csrc/flash_attention.cu, or
// csrc/flash_attention_bf16.cu for bfloat16 operands) standing in for
// the softmax's max and sum:
//   (a) delta = rowsum(dO * O) per (b, h, q) row (a warp a row, fmaf);
//   (b) dK, dV: one block per (kv head, batch, 64 kv rows). The block
//       walks the R = H/G query heads of its group and the q tiles the
//       mask lets through, recomputes S and dP, and accumulates dV += P^T
//       dO and dK += dS^T Q with P = exp(scale S - lse) and dS = P (dP -
//       delta). Each kv head's dK and dV are written once by the block
//       that owns them: the sum over the R heads of GQA is inside the
//       block, there are no atomics, and the result does not depend on
//       the launch: the same bits on every launch;
//   (c) dQ: one block per (head, batch, 64 q rows), dQ = scale sum dS K
//       over the kv tiles the mask lets through (the forward's range).
// (b) and (c) each recompute S and dP: seven products in all. Summing dQ
// across the blocks of (b) would save two of them but needs atomics (or
// a scratch of about 1 GB at qwen1.5-0.5b's training shape) and gives up
// the same bits on every launch. A row that sees no key (lse = +inf from
// the forward) gets P = 0: no gradient to its q, nothing to dk and dv.
//
// Bound: operations. At qwen1.5-0.5b's training shape (B=4, S=2048,
// H=G=16, D=64, causal) the five products of the gradient over the
// causal half are 2.5 times the forward's 34.4 GFLOP; at 3xTF32, three
// TF32 products for each float32 one, over the 495 TFLOP/s dense TF32
// peak of an H100 SXM: 0.521 ms (bfloat16 operands: the dense bf16 peak,
// 0.087 ms; chip_smoke.py's time_k3_bwd states both). The kernel runs
// seven products, 1.4 times the bound's five.
//
// Design. (b) and (c) are one template, fa_bwd_pass<In, DP, DKDV, WG>: a
// block of WG warpgroups (128 threads each) owns 64 WG rows of a fixed
// side X, 64 a warpgroup, and walks the tiles of N rows of a streamed
// side Y that the mask lets through; the warpgroups share each tile.
//   (b) X = kv rows of K and V, Y = q tiles of Q and dO. The pass is
//       computed transposed: S^T = K Q^T and dP^T = V dO^T (M = kv rows,
//       N = the q tile), so that P^T and dS^T sit in the accumulators and
//       feed dV += P^T dO and dK += dS^T Q as the A operand from
//       registers.
//   (c) X = q rows of Q and dO, Y = kv tiles of K and V: S = Q K^T,
//       dP = dO V^T (M = q rows), then dQ += dS K with dS from registers.
// - Every product is wgmma.mma_async m64nNk8 .tf32. Float32 operands run
//   3xTF32, as the forward: x = big + small, both TF32 (round to nearest,
//   ties away, by integer arithmetic: split_bits), and a product is
//   small*big + big*small + big*big, accumulated in float32. A bfloat16
//   operand widened to float32 is its own TF32 big half (8 significant
//   bits), its small half is 0: S and dP take one TF32 product, and dV,
//   dK and dQ two (P and dS are float32: P_small * Y + P_big * Y), bit
//   for bit what the three would give, in half the shared memory.
//   kernels/flash_attention.py:attention_bwd_tf32 is a float64 model of
//   this arithmetic and bwd_error_bound its bound.
// - Layouts. tf32 wgmma reads shared operands K-major only, as 8 x 4-word
//   core matrices without swizzle (hopper.cuh). X is stored [row][d] (A
//   of S and dP); Y [n][d] (B of S and dP) and, for the products from
//   registers, transposed [d][n] (B, N = d, K = n): both Q and dO in (b),
//   K alone in (c). An m64nN accumulator holds columns 2t and 2t + 1
//   where the A fragment holds k = t and t + 4, so the n order within
//   each 8 of the transposed copies is permuted to match, as V's kv order
//   is in the forward, and P and dS go from the accumulators into the
//   products as they stand.
// - Loads. X is read once per block, split into big and small and stored.
//   Y's tiles come through a 2-stage cp.async ring of staging in the
//   operands' type (16-byte copies where D is a multiple of 4 float32 or
//   8 bfloat16 values and the bases are aligned, else 4-byte ones;
//   bfloat16 rows without 16-byte copies are read one value at a time;
//   zero-fill past the sequence and D), the next tile in flight while the
//   block computes on this one. As a tile lands, the threads split each
//   staged element into big and small once for each layout it is stored
//   in (twice in (b), where Q and dO go into both) and write 16-byte
//   stores, 8 lanes a core matrix and 8 staged rows (no bank conflicts),
//   then fence them for wgmma's reads. No TMA: the split and the
//   transposed copies need the threads to touch every element anyway.
// - Masks, lse, delta. Each accumulator element maps to its (q, kv) pair
//   by the m64nN layout before the forward's visible(). In (b) lse and
//   delta belong to the columns: they land with each q tile (cp.async)
//   and are copied out of the stage as it is split; in (c) to the rows,
//   held in registers. Every warpgroup runs the products of every tile
//   of its block: a branch around them (skipping a tile the mask rules
//   out for one warpgroup's rows) cost more than the tiles it saved, up
//   to 1.7x (scripts/chip_ablate.py k3_bwd, cut `dead`; PERF.md, 6).
// - Causal imbalance. The tile index is the grid's slowest dimension
//   (blockIdx.z), ordered so that the longest walks are launched first:
//   kv tile 0 in (b), the last q tile in (c).
// - Tiles: N (the streamed rows), WG, and shared memory in bytes (X, Y's
//   copies, 2 stages, lse and delta), of the 232,448 a block may use:
//       D (padded)          16       32       64      128
//     (b) float32  N, WG   32, 2    32, 2    32, 2    16, 1
//                  bytes  60,160  117,504  232,192  230,784
//     (b) bfloat16 N, WG   32, 2    32, 2    32, 2    16, 2
//                  bytes  31,488   60,160  117,504  181,632
//     (c) float32  N, WG   64, 2    64, 2    32, 2    16, 1
//                  bytes  77,824  151,552  215,040  214,016
//     (c) bfloat16 N, WG   64, 2    64, 2    64, 2    32, 2
//                  bytes  40,960   77,824  151,552  215,040
//   Two warpgroups halve the split work per product and give each
//   scheduler two warps; float32 at D = 128 holds one (K and V alone take
//   128 KB). The dK and dV accumulators take D registers a thread, the
//   P and dS fragments 2N, so (b) walks 32-row q tiles (16 at D = 128).
//   Registers a thread, from ptxas -v (kernels/build.py passes -Xptxas
//   -v; nvcc 12.8, sm_90a):
//       D (padded)     16   32   64  128
//     (b) float32     168  184  221  238
//     (b) bfloat16    177  194  245  255, spills 32 bytes (40 loaded)
//     (c) float32     192  202  152  168
//     (c) bfloat16    210  219  245  235
//   and no other spill. The one spill stays: one warpgroup there instead
//   of two ran mixtral-8x7b's bfloat16 shape in 9.688 ms against 5.522
//   (NVIDIA H100 80GB HBM3, 700.00 W; scripts/chip_ablate.py k3_bwd,
//   cut `wg1`; PERF.md, section 6).
//
// Accuracy: kernels/flash_attention.py:bwd_error_bound states the bound
// against the plain version flash_attention_bwd_ref.
//
// Interface: plain C, loaded with ctypes. flash_attention_bwd() launches
// the three kernels on the given stream, does not synchronise, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"

#define FULL_MASK 0xffffffffu
#define DELTA_THREADS 256     // (a): a warp a row
#define MAX_SMEM 232448       // bytes of shared memory a block may use

struct BwdArgs {
  const void* q;              // float or bf16, as k, v, o, dout, dq, dk, dv
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;           // (B, H, Sq)
  float* delta;               // (B, H, Sq) scratch
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, H, G, D;
  int causal;
  int window;                 // <= 0: no window
  float scale;
  int vec;                    // 16-byte copies of q, k, v and dO rows
};

// the forward's mask: key kp is visible to query qp
__device__ __forceinline__ bool visible(int qp, int kp, const BwdArgs& a) {
  if (qp >= a.Sq || kp >= a.Skv) return false;
  if (a.causal && kp > qp) return false;
  if (a.window > 0 && kp <= qp - a.window) return false;
  return true;
}

// (a) delta[b, h, q] = sum_d dO * O: one warp per (b, q, h) row
template <typename In>
__global__ void __launch_bounds__(DELTA_THREADS) fa_bwd_delta(BwdArgs a) {
  const int64_t row =
      (int64_t)blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (int64_t)a.B * a.Sq * a.H) return;
  const In* o = (const In*)a.o + row * a.D;
  const In* d = (const In*)a.dout + row * a.D;
  float s = 0.f;
  for (int i = lane; i < a.D; i += 32) s = fmaf(widen(o[i]), widen(d[i]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL_MASK, s, off);
  if (lane == 0) {
    const int h = (int)(row % a.H);
    const int64_t bq = row / a.H;
    const int qp = (int)(bq % a.Sq), b = (int)(bq / a.Sq);
    a.delta[((int64_t)b * a.H + h) * a.Sq + qp] = s;
  }
}

// The geometry of (b) (DKDV) and (c), in 32-bit words: X's two operands
// and Y's two, then Y's transposed copies (two in (b), one in (c)), each
// split (big, small) for float32 operands and big alone for bfloat16;
// then the 2-stage staging ([Y1, Y2][N][PITCH] in the operands' type)
// and, in (b), lse and delta for each stage and for the tile in use.
template <typename In, int DP, bool DKDV, int WG>
struct Geo {
  static constexpr bool F32 = sizeof(In) == 4;
  static constexpr int SPL = F32 ? 2 : 1;
  static constexpr int N = DKDV ? (DP <= 64 ? 32 : 16)
                           : DP <= 32 ? 64
                           : DP == 64 ? (F32 ? 32 : 64)
                                      : (F32 ? 16 : 32);
  static constexpr int T = DKDV ? 2 : 1;
  static constexpr int PITCH = DP + 16 / (int)sizeof(In);
  static constexpr int X_WORDS = 64 * WG * DP;
  static constexpr int Y_WORDS = N * DP;
  static constexpr int STAGE = 2 * N * PITCH;
  static constexpr int STATS = DKDV ? 2 * N : 0;
  static constexpr size_t BYTES =
      4 * ((size_t)2 * SPL * X_WORDS + (size_t)(2 + T) * SPL * Y_WORDS
           + 3 * (size_t)STATS)
      + 2 * (size_t)STAGE * sizeof(In);
};

// 4 staged values, widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *(const float4*)p;
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *(const uint2*)p;
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}

// 4 values into a split copy with one 16-byte store each: big and small
// for float32 operands; a widened bfloat16 is its own TF32 big half
template <bool F32>
__device__ __forceinline__ void put4(float4 x, uint32_t* db, uint32_t* ds) {
  if constexpr (F32) {
    uint4 big, small;
    split_bits(x.x, big.x, small.x);
    split_bits(x.y, big.y, small.y);
    split_bits(x.z, big.z, small.z);
    split_bits(x.w, big.w, small.w);
    *(uint4*)db = big;
    *(uint4*)ds = small;
  } else {
    *(uint4*)db = make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                             __float_as_uint(x.z), __float_as_uint(x.w));
  }
}

// rows [c0, c0 + N) of y1 and y2 (`stride` elements apart, `rows` in all)
// into a stage [Y1, Y2][N][PITCH]
template <typename In, int DP, int N, int NT>
__device__ __forceinline__ void load_stage(In* st, const In* y1,
                                           const In* y2, int64_t stride,
                                           int c0, int rows,
                                           const BwdArgs& a) {
  constexpr int PITCH = DP + 16 / (int)sizeof(In);
  constexpr int L = 16 / (int)sizeof(In);        // values in 16 bytes
  In* s2 = st + N * PITCH;
  if (a.vec) {
    constexpr int CH = DP / L;
    for (int i = threadIdx.x; i < N * CH; i += NT) {
      const int r = i / CH, c = i % CH, row = c0 + r;
      const bool ok = row < rows && L * c < a.D;
      const int64_t off = ok ? row * stride + L * c : 0;
      cp_async16(st + r * PITCH + L * c, y1 + off, ok ? 16 : 0);
      cp_async16(s2 + r * PITCH + L * c, y2 + off, ok ? 16 : 0);
    }
  } else if constexpr (sizeof(In) == 4) {
    for (int i = threadIdx.x; i < N * DP; i += NT) {
      const int r = i / DP, d = i % DP, row = c0 + r;
      const bool ok = row < rows && d < a.D;
      const int64_t off = ok ? row * stride + d : 0;
      cp_async4(st + r * PITCH + d, y1 + off, ok ? 4 : 0);
      cp_async4(s2 + r * PITCH + d, y2 + off, ok ? 4 : 0);
    }
  } else {
    const In zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < N * DP; i += NT) {
      const int r = i / DP, d = i % DP, row = c0 + r;
      const bool ok = row < rows && d < a.D;
      const int64_t off = ok ? row * stride + d : 0;
      st[r * PITCH + d] = ok ? y1[off] : zero;
      s2[r * PITCH + d] = ok ? y2[off] : zero;
    }
  }
}

// lse and delta of q rows [c0, c0 + N) of one head into st[0..N) and
// st[N..2N): 0 past Sq, where every pair is masked
template <int N, int NT>
__device__ __forceinline__ void load_stats(float* st, const float* lse,
                                           const float* del, int c0,
                                           int Sq) {
  for (int i = threadIdx.x; i < N; i += NT) {
    const int row = c0 + i;
    const bool ok = row < Sq;
    cp_async4(st + i, lse + (ok ? row : 0), ok ? 4 : 0);
    cp_async4(st + N + i, del + (ok ? row : 0), ok ? 4 : 0);
  }
}

// a staged tile into the [n][d] layout (B of S and dP): word 4i + w is
// n = 8 (cm % NB) + i % 8, d = 4 (cm / NB) + w, cm = i / 8
template <typename In, int DP, int N, bool F32, int NT>
__device__ __forceinline__ void split_rows(const In* st, uint32_t* db,
                                           uint32_t* ds) {
  constexpr int PITCH = DP + 16 / (int)sizeof(In), NB = N / 8;
#pragma unroll 2
  for (int i = threadIdx.x; i < N * DP / 4; i += NT) {
    const int cm = i >> 3, row = i & 7;
    const int n = 8 * (cm % NB) + row, d = 4 * (cm / NB);
    put4<F32>(load4(st + n * PITCH + d), db + 4 * i, ds + 4 * i);
  }
}

// a staged tile into the transposed [d][n] layout (B of the products
// from registers, N = d, K = n): word 4i + w is d = 8 (cm % DB) + i % 8
// and k position 4 (jh & 1) + w with jh = cm / DB, which holds n = 8 (jh
// / 2) + (jh & 1) + 2w: the accumulators' column order
template <typename In, int DP, int N, bool F32, int NT>
__device__ __forceinline__ void split_cols(const In* st, uint32_t* db,
                                           uint32_t* ds) {
  constexpr int PITCH = DP + 16 / (int)sizeof(In), DB = DP / 8;
#pragma unroll 2
  for (int i = threadIdx.x; i < N * DP / 4; i += NT) {
    const int cm = i >> 3, row = i & 7;
    const int d = 8 * (cm % DB) + row, jh = cm / DB;
    const In* c = st + (8 * (jh >> 1) + (jh & 1)) * PITCH + d;
    put4<F32>(make_float4(widen(c[0]), widen(c[2 * PITCH]),
                          widen(c[4 * PITCH]), widen(c[6 * PITCH])),
              db + 4 * i, ds + 4 * i);
  }
}

// rows [r0, r0 + 64 WG) of x1 and x2 (one head) split into the [row][d]
// layout (A of S and dP): word i is row 8 (cm % MB) + (i / 4) % 8, d =
// 4 (cm / MB) + i % 4, cm = i / 32, MB = 8 WG; zeros past `rows` and D
template <typename In, int DP, bool F32, int WG>
__device__ __forceinline__ void load_fixed(uint32_t* x1b, uint32_t* x1s,
                                           uint32_t* x2b, uint32_t* x2s,
                                           const In* x1, const In* x2,
                                           int64_t stride, int r0, int rows,
                                           int D) {
  constexpr int MB = 8 * WG;
  for (int i = threadIdx.x; i < 64 * WG * DP; i += 128 * WG) {
    const int cm = i >> 5;
    const int r = 8 * (cm % MB) + ((i >> 2) & 7), d = 4 * (cm / MB) + (i & 3);
    const int row = r0 + r;
    const bool ok = row < rows && d < D;
    const int64_t off = ok ? row * stride + d : 0;
    const float u = ok ? widen(x1[off]) : 0.f;
    const float w = ok ? widen(x2[off]) : 0.f;
    if constexpr (F32) {
      split_bits(u, x1b[i], x1s[i]);
      split_bits(w, x2b[i], x2s[i]);
    } else {
      x1b[i] = __float_as_uint(u);
      x2b[i] = __float_as_uint(w);
    }
  }
}

// the A fragment of k step j from an m64nN accumulator: k = t and t + 4
// are its columns 8j + 2t and 8j + 2t + 1, split into big and small
template <int M>
__device__ __forceinline__ void frag(const float (&x)[M], int j,
                                     uint32_t (&big)[4],
                                     uint32_t (&small)[4]) {
  split_bits(x[4 * j + 0], big[0], small[0]);
  split_bits(x[4 * j + 2], big[1], small[1]);
  split_bits(x[4 * j + 1], big[2], small[2]);
  split_bits(x[4 * j + 3], big[3], small[3]);
}

// (b) with DKDV, else (c), with WG warpgroups: see the note at the top
template <typename In, int DP, bool DKDV, int WG>
__global__ void __launch_bounds__(128 * WG, 1) fa_bwd_pass(BwdArgs a) {
  using Gm = Geo<In, DP, DKDV, WG>;
  static_assert(Gm::BYTES <= MAX_SMEM, "shared memory");
  constexpr bool F32 = Gm::F32;
  constexpr int N = Gm::N, SPL = Gm::SPL, PITCH = Gm::PITCH;
  constexpr int NT = 128 * WG, FIX = 64 * WG, MB = 8 * WG;
  constexpr int NB = N / 8, DB = DP / 8;
  constexpr int XW = Gm::X_WORDS, YW = Gm::Y_WORDS;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* X1b = smem;                       // small halves follow big
  uint32_t* X1s = X1b + (SPL - 1) * XW;       // (bfloat16: the same)
  uint32_t* X2b = X1b + SPL * XW;
  uint32_t* X2s = X2b + (SPL - 1) * XW;
  uint32_t* Y1b = X1b + 2 * SPL * XW;
  uint32_t* Y1s = Y1b + (SPL - 1) * YW;
  uint32_t* Y2b = Y1b + SPL * YW;
  uint32_t* Y2s = Y2b + (SPL - 1) * YW;
  uint32_t* T1b = Y1b + 2 * SPL * YW;         // Y1 transposed
  uint32_t* T1s = T1b + (SPL - 1) * YW;
  uint32_t* T2b = T1b + SPL * YW;             // Y2 transposed, (b) only
  uint32_t* T2s = T2b + (SPL - 1) * YW;
  In* stage = (In*)(Y1b + (2 + Gm::T) * SPL * YW);
  float* stats = (float*)(stage + 2 * Gm::STAGE);   // [2][lse, delta][N]
  float* cur = stats + 2 * Gm::STATS;               // the tile in use

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g8 = lane >> 2, t = lane & 3;
  const int R = a.H / a.G, D = a.D, b = blockIdx.y;
  const int64_t q_row = (int64_t)a.H * D, kv_row = (int64_t)a.G * D;
  const In* qs = (const In*)a.q + (int64_t)b * a.Sq * q_row;
  const In* os = (const In*)a.dout + (int64_t)b * a.Sq * q_row;
  const In* ks = (const In*)a.k + (int64_t)b * a.Skv * kv_row;
  const In* vs = (const In*)a.v + (int64_t)b * a.Skv * kv_row;

  // the fixed rows, and the streamed tiles the mask lets through: (b) n_per
  // q tiles for each of the R heads, (c) n_per kv tiles
  int h, kvh, r0, t_first, n_per, n_tiles;
  if constexpr (DKDV) {
    kvh = blockIdx.x;
    h = kvh * R;
    r0 = blockIdx.z * FIX;
    const int k_last = min(r0 + FIX, a.Skv) - 1;
    const int q_lo = a.causal ? r0 : 0;
    const int q_hi = a.window > 0 ? min(a.Sq - 1, k_last + a.window - 1)
                                  : a.Sq - 1;
    t_first = q_lo / N;
    n_per = q_hi >= q_lo ? q_hi / N - t_first + 1 : 0;
    n_tiles = R * n_per;
  } else {
    h = blockIdx.x;
    kvh = h / R;
    r0 = (a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * FIX;
    const int q_last = min(r0 + FIX, a.Sq) - 1;
    const int k_hi = a.causal ? min(a.Skv - 1, q_last) : a.Skv - 1;
    const int k_lo = a.window > 0 ? max(0, r0 - a.window + 1) : 0;
    t_first = k_lo / N;
    n_per = k_hi >= k_lo ? k_hi / N - t_first + 1 : 0;
    n_tiles = n_per;
  }
  const int col_rows = DKDV ? a.Sq : a.Skv;
  auto tile_row = [&](int it) {
    return (t_first + (DKDV ? it % n_per : it)) * N;
  };
  auto issue = [&](int it, int s) {
    In* st = stage + s * Gm::STAGE;
    if constexpr (DKDV) {
      const int hh = h + it / n_per, c0 = tile_row(it);
      load_stage<In, DP, N, NT>(st, qs + hh * D, os + hh * D, q_row, c0,
                                a.Sq, a);
      const int64_t at = ((int64_t)b * a.H + hh) * a.Sq;
      load_stats<N, NT>(stats + s * Gm::STATS, a.lse + at, a.delta + at, c0,
                        a.Sq);
    } else {
      load_stage<In, DP, N, NT>(st, ks + kvh * D, vs + kvh * D, kv_row,
                                tile_row(it), a.Skv, a);
    }
  };

  if (n_tiles > 0) issue(0, 0);
  cp_commit();
  if (n_tiles > 1) issue(1, 1);
  cp_commit();

  if constexpr (DKDV)
    load_fixed<In, DP, F32, WG>(X1b, X1s, X2b, X2s, ks + kvh * D,
                                vs + kvh * D, kv_row, r0, a.Skv, D);
  else
    load_fixed<In, DP, F32, WG>(X1b, X1s, X2b, X2s, qs + h * D, os + h * D,
                                q_row, r0, a.Sq, D);

  // this warpgroup's fixed rows f0 .. f0 + 63; this thread's row0, row0 + 8
  const int f0 = r0 + 64 * wg;
  const int row0 = f0 + 16 * wl + g8;
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};
  if constexpr (!DKDV) {
    const int64_t at = ((int64_t)b * a.H + h) * a.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < a.Sq) {
        lse_r[r] = a.lse[at + row0 + 8 * r];
        del_r[r] = a.delta[at + row0 + 8 * r];
      }
  }

  // (b): acc1 = dV, acc2 = dK; (c): acc1 = dQ
  float acc1[DP / 2], acc2[DKDV ? DP / 2 : 1];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKDV ? DP / 2 : 1); ++i) acc2[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait_all_but_one();            // tile it has landed ...
    __syncthreads();                  // ... for every thread; Y's copies free
    const In* st = stage + (it & 1) * Gm::STAGE;
    split_rows<In, DP, N, F32, NT>(st, Y1b, Y1s);
    split_rows<In, DP, N, F32, NT>(st + N * PITCH, Y2b, Y2s);
    split_cols<In, DP, N, F32, NT>(st, T1b, T1s);
    if constexpr (DKDV) {
      split_cols<In, DP, N, F32, NT>(st + N * PITCH, T2b, T2s);
      for (int i = threadIdx.x; i < 2 * N; i += NT)
        cur[i] = stats[(it & 1) * Gm::STATS + i];
    }
    fence_async_smem();
    __syncthreads();                  // copies ready; stage it & 1 free
    if (it + 2 < n_tiles) issue(it + 2, it & 1);
    cp_commit();
    const int c0 = tile_row(it);

    // S' = X1 Y1^T and dP' = X2 Y2^T: per k step small*big, big*small,
    // big*big (bfloat16: big*big)
    float s[N / 2], dp[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DB; ++kk) {
      if (8 * kk >= D) break;
      const int xa = (2 * kk * MB + 8 * wg) * 32, ya = 2 * kk * NB * 32;
      const uint64_t x1b = smem_desc(X1b + xa, MB * 128, 128);
      const uint64_t x2b = smem_desc(X2b + xa, MB * 128, 128);
      const uint64_t y1b = smem_desc(Y1b + ya, NB * 128, 128);
      const uint64_t y2b = smem_desc(Y2b + ya, NB * 128, 128);
      if constexpr (F32) {
        wgmma_ss<N>(s, smem_desc(X1s + xa, MB * 128, 128), y1b);
        wgmma_ss<N>(dp, smem_desc(X2s + xa, MB * 128, 128), y2b);
        wgmma_ss<N>(s, x1b, smem_desc(Y1s + ya, NB * 128, 128));
        wgmma_ss<N>(dp, x2b, smem_desc(Y2s + ya, NB * 128, 128));
      }
      wgmma_ss<N>(s, x1b, y1b);
      wgmma_ss<N>(dp, x2b, y2b);
    }
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(dp);

    // P and dS in place; s[4j + 2r + c] is fixed row row0 + 8r, streamed
    // row c0 + 8j + 2t + c
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * r + c, col = 8 * j + 2 * t + c;
          float lse, del;
          bool ok;
          if constexpr (DKDV) {
            lse = cur[col];
            del = cur[N + col];
            ok = visible(c0 + col, row0 + 8 * r, a);
          } else {
            lse = lse_r[r];
            del = del_r[r];
            ok = visible(row0 + 8 * r, c0 + col, a);
          }
          const float p = ok ? expf(s[e] * a.scale - lse) : 0.f;
          dp[e] = p * (dp[e] - del);
          s[e] = p;
        }

    // (b) dV += P^T dO, dK += dS^T Q; (c) dQ += dS K: per k step
    // small*big, big*small, big*big (bfloat16: small*big, big*big)
    uint32_t pb[NB][4], ps[NB][4], db[NB][4], ds[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if constexpr (DKDV) frag(s, j, pb[j], ps[j]);
      frag(dp, j, db[j], ds[j]);
    }
    pin(acc1);
    pin(acc2);
    wg_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (c0 + 8 * j >= col_rows) break;
      const int ta = 2 * j * DB * 32;
      const uint64_t t1b = smem_desc(T1b + ta, DB * 128, 128);
      if constexpr (DKDV) {
        const uint64_t t2b = smem_desc(T2b + ta, DB * 128, 128);
        wgmma_rs<DP>(acc1, ps[j], t2b);
        wgmma_rs<DP>(acc2, ds[j], t1b);
        if constexpr (F32) {
          wgmma_rs<DP>(acc1, pb[j], smem_desc(T2s + ta, DB * 128, 128));
          wgmma_rs<DP>(acc2, db[j], smem_desc(T1s + ta, DB * 128, 128));
        }
        wgmma_rs<DP>(acc1, pb[j], t2b);
        wgmma_rs<DP>(acc2, db[j], t1b);
      } else {
        wgmma_rs<DP>(acc1, ds[j], t1b);
        if constexpr (F32)
          wgmma_rs<DP>(acc1, db[j], smem_desc(T1s + ta, DB * 128, 128));
        wgmma_rs<DP>(acc1, db[j], t1b);
      }
    }
    wg_commit();
    wg_wait_all();
    pin(acc1);
    pin(acc2);
  }

  // acc[4n + 2r + c] is fixed row row0 + 8r, d = 8n + 2t + c
  if constexpr (DKDV) {
    In* dvb = (In*)a.dv + (int64_t)b * a.Skv * kv_row + kvh * D;
    In* dkb = (In*)a.dk + (int64_t)b * a.Skv * kv_row + kvh * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = row0 + 8 * r;
      if (kp >= a.Skv) continue;
#pragma unroll
      for (int n = 0; n < DB; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 8 * n + 2 * t + c, e = 4 * n + 2 * r + c;
          if (d >= D) continue;
          dvb[kp * kv_row + d] = narrow<In>(acc1[e]);
          dkb[kp * kv_row + d] = narrow<In>(acc2[e] * a.scale);
        }
    }
  } else {
    In* dqb = (In*)a.dq + (int64_t)b * a.Sq * q_row + h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp >= a.Sq) continue;
#pragma unroll
      for (int n = 0; n < DB; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 8 * n + 2 * t + c;
          if (d < D)
            dqb[qp * q_row + d] = narrow<In>(acc1[4 * n + 2 * r + c] * a.scale);
        }
    }
  }
}

template <typename K>
static int raise_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// (b) or (c) over `heads` heads, the batch and the rows in tiles of 64 WG
template <typename In, int DP, bool DKDV, int WG>
static int launch_pass(const BwdArgs& a, int heads, int rows,
                       cudaStream_t stream) {
  auto kern = fa_bwd_pass<In, DP, DKDV, WG>;
  const size_t smem = Geo<In, DP, DKDV, WG>::BYTES;
  int e = raise_smem(kern, smem);
  if (e) return e;
  dim3 grid(heads, a.B, (rows + 64 * WG - 1) / (64 * WG));
  kern<<<grid, 128 * WG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename In, int DP>
static int launch(const BwdArgs& a, cudaStream_t stream) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.H;
  const int64_t warps = DELTA_THREADS / 32;
  int e = 0;
  if (rows > 0) {
    fa_bwd_delta<In><<<(unsigned)((rows + warps - 1) / warps),
                       DELTA_THREADS, 0, stream>>>(a);
    if ((e = (int)cudaGetLastError())) return e;
  }
  // two warpgroups (128 fixed rows) share each streamed tile wherever
  // shared memory holds them: all but float32 at D = 128
  constexpr int WG = sizeof(In) == 4 && DP == 128 ? 1 : 2;
  // with Sq = 0 the dK/dV blocks see no query and write zeros
  if ((e = launch_pass<In, DP, true, WG>(a, a.G, a.Skv, stream))) return e;
  if (a.Sq == 0) return 0;
  return launch_pass<In, DP, false, WG>(a, a.H, a.Sq, stream);
}

template <typename In>
static int launch_dims(const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<In, 16>(a, stream);
  if (a.D <= 32) return launch<In, 32>(a, stream);
  if (a.D <= 64) return launch<In, 64>(a, stream);
  if (a.D <= 128) return launch<In, 128>(a, stream);
  return -1;
}

// q, o, dout, dq (B,Sq,H,D); k, v, dk, dv (B,Skv,G,D), all contiguous on
// the device, all float32 (bf16_in = 0) or all bfloat16 (bf16_in = 1);
// lse (B,H,Sq) float32 from the forward; delta (B,H,Sq) float32 scratch.
// D <= 128, H % G == 0, Skv >= 1, B and ceil(S / 64) up to 65,535.
// Returns a cudaError_t (0 on success); -1 for a D the kernel does not
// take.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int H, int G,
                                   int D, int causal, int window, int bf16_in,
                                   float scale, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (B > 65535 || (Sq + 63) / 64 > 65535 || (Skv + 63) / 64 > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int lanes = bf16_in ? 8 : 4;          // values in 16 bytes
  const int vec = D % lanes == 0 && ((uintptr_t)q % 16) == 0 &&
                  ((uintptr_t)k % 16) == 0 && ((uintptr_t)v % 16) == 0 &&
                  ((uintptr_t)dout % 16) == 0;
  BwdArgs a{q,  k,  v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, G, D,
            causal, window, scale, vec};
  return bf16_in ? launch_dims<bf16>(a, stream)
                 : launch_dims<float>(a, stream);
}
