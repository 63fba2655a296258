// Causal and/or sliding-window GQA attention on bfloat16 q, k and v, for
// Hopper (sm_90a): the online-softmax ("flash") forward pass on bf16
// wgmma, the tiles kept in bfloat16 from device memory to the tensor
// cores.
//
// Replaces: repro/kernels/flash_attention.py:_kernel (Pallas, TPU),
// called through flash_attention, for bfloat16 operands (float32 ones
// take csrc/flash_attention.cu). Same function: q (B,Sq,H,D), k and v
// (B,Skv,G,D) with head h reading kv head h / (H/G); scale D^-0.5; fp32
// running max, sum and accumulator; masked scores set to -1e30, padded
// keys (the ragged edge past Skv) masked the same way; the output is
// acc / max(l, 1e-30), written in bfloat16 rounded to nearest even.
// With a non-null lse ((B,H,Sq) float32) the epilogue also writes each
// row's log-sum-exp of its scaled scores, m + log(l), and a row that sees
// no key is 0 with lse = +inf, as csrc/flash_attention.cu writes them for
// the backward (csrc/flash_attention_bwd.cu, which reads both unchanged).
// The kernel is compiled with and without those stores (the LSE flag).
//
// Bound: operations. At qwen1.5-0.5b's prefill (B=4, S=2048, H=G=16,
// D=64, causal) QK^T and PV over the causal half are 34.4 GFLOP against
// 17 MB of bf16 q, k, v and o: 0.0348 ms at the 989 TFLOP/s dense bf16
// peak of an H100 SXM. This design runs three bf16 products where the
// function needs two (S once, PV twice: P in two parts), so its own
// floor is 1.5 times that.
//
// Arithmetic (kernels/flash_attention.py:attention_bf16 is a float64
// model of it, error_bound's bf16 terms its bound):
// - S = q K^T by wgmma m64n64k16 .f32.bf16.bf16 on the unscaled bf16
//   values: each product of two bf16 numbers is exact in float32, the
//   sum is float32. The scale D^-0.5 (not a power of two at D = 128, so
//   q * scale would not be a bf16) is applied to S in float32 after the
//   product: the scores differ from the reference's (q * scale) K^T only
//   by float32 roundings.
// - P = exp(s - m) in float32 is split into two bf16 parts, hi = bf16(p)
//   and lo = bf16(p - hi), within 2^-16 p (hopper.cuh:split_bf16x2), and
//   O += hi V + lo V by two wgmma m64nNk16 with P from registers. One part
//   would move an output by up to 2^-8 sum w|v|, the size of its own
//   bf16 rounding; two keep the kernel 256 times below that, for one
//   more bf16 product (the cost of half a TF32 one). SDPA, the
//   yardstick chip_smoke.py times beside it, runs P in one bf16 part.
//
// Design. One block owns one (b, h, q tile) and walks the kv tiles the
// mask lets through, in a loop that stands in for the TPU grid's
// sequential kv axis. q tiles are launched last first (blockIdx.x
// reversed), so that the longest causal walks start first.
// - Warps: WG consumer warpgroups of 64 q rows each (WG = 2, 128 rows
//   sharing each kv tile, for Sq >= 256 at every D; 1 for shorter
//   sequences) and one producer warp that fills a ring of 3 stages of
//   64 kv rows of K and V. Full and empty mbarriers pass the stages:
//   the producer waits until every consumer warp has released a stage,
//   the consumers wait until its bytes have landed.
// - Layout: every tile is bfloat16 in the 128-byte swizzle (hopper.cuh:
//   sw128), D padded with zeros to 64 or 128 (the S walk stops at D
//   rounded up to 16). q and K are read K-major (d contiguous); V is
//   stored as it lies in memory, (kv, d), and read as B with the
//   transpose bit, which 16-bit wgmma allows: no transposing pass, no
//   key permutation, no float32 staging, no split pass.
// - Loads: TMA (cp.async.bulk.tensor, one box of 64 kv rows x 64 d
//   values a column half, each stage's bytes counted on its full
//   barrier) through a 4-D tensor map (D, G, Skv, B) built on the host
//   with cuTensorMapEncodeTiled (tma.cuh: reached through
//   cudaGetDriverEntryPoint, no library linked), so that a tile past Skv
//   is zero-filled inside its own batch row and never reads the next.
//   TMA needs 16-byte strides and bases: where D % 8 != 0, a base is off
//   16 bytes, or D < 64, the producer warp copies the tile itself to the
//   same swizzled addresses, by 16-byte cp.async where D % 8 == 0 and the
//   bases are aligned, else one value at a time through registers (the
//   Transform's D = 8 and 12, offset views). q is read once per block by
//   the consumers (16-byte loads where they can) into the same layout.
// - P goes from the score accumulators into the PV product as it stands:
//   an m64nN accumulator's columns 8j + 2t, 2t + 1 of rows g and g + 8
//   are the k16 A fragment's registers, so each k16 step takes four
//   packed pairs of scores, split into hi and lo.
// - The online softmax stays in float32 registers as in the float32
//   kernel: row max by two xor-shuffles over the 4 lanes of a row,
//   per-lane partial sums reduced at the end; the masks are applied only
//   on tiles that cross the causal diagonal, the window's edge or Skv.
//
// Masked tiles. The block skips kv tiles that the causal or window mask
// rules out for all its rows, and a warpgroup skips those ruled out for
// its 64 rows (it still waits for them to land before it releases them,
// so that no release runs ahead of the ring). Skipping changes no row
// that has a visible key (csrc/flash_attention.cu's header says why); a
// row with none is 0 with lse = +inf where the log-sum-exp is written,
// and outside the contract without it, as in the float32 kernel.
//
// Shared memory a block: q (64 WG rows x D padded) + 3 stages of K and V
// (64 rows each) + 6 barriers, at a 1,024-byte aligned base:
//       D (padded)          64         128
//       WG = 1          58,416     115,760
//       WG = 2          66,608     132,144
// Registers a thread, from ptxas -v (kernels/build.py passes -Xptxas -v;
// nvcc 12.9, sm_90a), with and without the log-sum-exp's stores:
//       D (padded)          64         128
//       WG = 1         127, 127    163, 167
//       WG = 2         127, 127    167, 167
// and no spill. A block runs one producer warp beside its consumers
// (160 or 288 threads, __launch_bounds__(..., 1)): at D = 64 one
// warpgroup's blocks fit three an SM, two warpgroups' one (registers).
//
// Interface: plain C, loaded with ctypes. flash_attention_bf16_fwd()
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit, or
// -2 where a tensor map is refused).
// flash_attention_bf16_shape() reports the launch it would make.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>
#include "hopper.cuh"
#include "tma.cuh"

#define NEG_INF (-1e30f)
#define FULL_MASK 0xffffffffu

namespace {

constexpr int BK = 64;          // kv rows a tile
constexpr int STAGES = 3;       // tiles in the ring
constexpr int ATOM = 64;        // bf16 values in a 128-byte swizzled row

enum Load { LOAD_TMA = 0, LOAD_CP_ASYNC = 1, LOAD_REGS = 2 };

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;                   // (B, H, Sq) or null
  int B, Sq, Skv, H, G, D;
  int causal;
  int window;                   // <= 0: no window
  float scale;
  int load;                     // how K and V tiles land: Load
  int q_vec;                    // q rows by 16-byte loads
  int o_pairs;                  // o written two values at a time
};

template <int DP, int WG>
struct Smem {
  static constexpr int BQ = 64 * WG;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;          // K or V of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // the barriers, and room to align the base to 1,024 bytes
  static constexpr size_t bytes() {
    return (size_t)BAR_OFF + 2 * STAGES * 8 + 1024;
  }
};

// The producer warp: tiles t_first .. t_first + n_tiles - 1 of K and V
// into the ring, stage it % STAGES, each once its last reader released it.
template <int DP>
__device__ __forceinline__ void produce(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const Args& a, uint8_t* kv_base,
                                        uint32_t skv, uint32_t full0,
                                        uint32_t empty0, int b, int kvh,
                                        int t_first, int n_tiles, int lane) {
  constexpr int KV = BK * DP * 2;
  const int64_t kv_row = (int64_t)a.G * a.D;
  const bf16* kb = a.k + ((int64_t)b * a.Skv * a.G + kvh) * a.D;
  const bf16* vb = a.v + ((int64_t)b * a.Skv * a.G + kvh) * a.D;
  if (a.load == LOAD_TMA && lane != 0) return;  // one thread issues TMA
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int u = it / STAGES;
    const uint32_t full = full0 + 8 * s;
    if (u > 0) mbar_wait(empty0 + 8 * s, (u - 1) & 1);
    const int k0 = (t_first + it) * BK;
    const uint32_t ks = skv + s * 2 * KV, vs = ks + KV;
    if (a.load == LOAD_TMA) {
      mbar_expect_tx(full, 2 * KV);
#pragma unroll
      for (int half = 0; half < DP / ATOM; ++half) {
        tma_load_4d(ks + half * BK * 128, tm_k, full, ATOM * half, kvh, k0, b);
        tma_load_4d(vs + half * BK * 128, tm_v, full, ATOM * half, kvh, k0, b);
      }
      continue;
    }
    if (a.load == LOAD_CP_ASYNC) {
      constexpr int CH = DP / 8;              // 16-byte chunks a row
      for (int i = lane; i < BK * CH; i += 32) {
        const int r = i / CH, c = 8 * (i % CH), sk = k0 + r;
        const bool ok = sk < a.Skv && c < a.D;
        const int64_t off = ok ? sk * kv_row + c : 0;
        const uint32_t at = sw128(r, c, BK);
        cp_async16_to(ks + at, kb + off, ok ? 16 : 0);
        cp_async16_to(vs + at, vb + off, ok ? 16 : 0);
      }
      cp_async_wait_all();
    } else {
      uint8_t* kg = kv_base + s * 2 * KV;
      uint8_t* vg = kg + KV;
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int i = lane; i < BK * DP; i += 32) {
        const int r = i / DP, c = i % DP, sk = k0 + r;
        const bool ok = sk < a.Skv && c < a.D;
        const int64_t off = sk * kv_row + c;
        const uint32_t at = sw128(r, c, BK);
        *(bf16*)(kg + at) = ok ? kb[off] : zero;
        *(bf16*)(vg + at) = ok ? vb[off] : zero;
      }
    }
    fence_async_smem();             // the copies, for wgmma's reads
    __syncwarp();
    if (lane == 0) mbar_arrive(full);
  }
}

template <int DP, int WG, bool LSE>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
    fa_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, Args a) {
  using L = Smem<DP, WG>;
  constexpr int BQ = L::BQ, CONSUMERS = WG * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sq = (uint32_t)__cvta_generic_to_shared(base);
  const uint32_t skv = sq + L::Q_BYTES;          // stage s at + s STAGE_BYTES
  const uint32_t full0 = sq + L::BAR_OFF;        // full[s] at + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.G);
  const int D = a.D;

  // the kv range any row of this block can see
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_hi = a.causal ? min(a.Skv - 1, q_last) : a.Skv - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = k_lo / BK;
  const int n_tiles = k_hi >= k_lo ? k_hi / BK - t_first + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * WG);          // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 4 * WG) {
    produce<DP>(&tm_k, &tm_v, a, base + L::Q_BYTES, skv, full0, empty0, b,
                kvh, t_first, n_tiles, lane);
    return;
  }

  // q tile, as it is (the scale comes after the product), swizzled
  const int64_t q_row = (int64_t)a.H * D;        // elements between q rows
  const bf16* qb = a.q + ((int64_t)b * a.Sq * a.H + h) * D;
  if (a.q_vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < BQ * CH; i += CONSUMERS) {
      const int r = i / CH, c = 8 * (i % CH), row = q0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < a.Sq && c < D) x = ld16(qb + row * q_row + c);
      *(uint4*)(base + sw128(r, c, BQ)) = x;
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < BQ * DP; i += CONSUMERS) {
      const int r = i / DP, c = i % DP, row = q0 + r;
      *(bf16*)(base + sw128(r, c, BQ)) =
          (row < a.Sq && c < D) ? qb[row * q_row + c] : zero;
    }
  }
  fence_async_smem();
  named_sync(1, CONSUMERS);

  // this warpgroup's 64 rows; this thread's rows g and g + 8 of its warp's 16
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wq = q0 + 64 * wg;
  const int wq_last = min(wq + 63, a.Sq - 1);
  const bool wg_live = wq < a.Sq;
  const int row0 = wq + 16 * wl + g;
  const int d_steps = (D + 15) / 16;             // k16 steps of S over d
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = (t_first + it) * BK;
    const bool skip = !wg_live || (a.causal && k0 > wq_last) ||
                      (a.window > 0 && k0 + BK - 1 <= wq - a.window);
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    if (!skip) {
      const uint32_t ks = skv + s * L::STAGE_BYTES;
      const uint32_t vs = ks + L::KV_BYTES;

      // S = q K^T for the warpgroup's 64 rows, unscaled
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      pin(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk >= d_steps) break;
        const uint32_t qa =
            sq + (kk / 4) * BQ * 128 + wg * 64 * 128 + (kk % 4) * 32;
        const uint32_t ka = ks + (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_bf16_ss_n64(sc, sw128_desc(qa, 16, 1024),
                          sw128_desc(ka, 16, 1024));
      }
      wg_commit();
      wg_wait_all();
      pin(sc);

      // online softmax on the scaled scores; sc[4j + 2r + c] is row
      // row0 + 8r, key k0 + 8j + 2t + c. The masks only where the tile
      // crosses the diagonal, the window's edge or Skv for these rows.
      const bool edge = k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > wq) ||
                        (a.window > 0 && k0 <= wq_last - a.window);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = sc[4 * j + 2 * r + c] * a.scale;
            if (edge) {
              const int kpos = k0 + 8 * j + 2 * t + c;
              bool ok = kpos < a.Skv;
              if (a.causal) ok = ok && kpos <= qpos;
              if (a.window > 0) ok = ok && kpos > qpos - a.window;
              if (!ok) x = NEG_INF;
            }
            sc[4 * j + 2 * r + c] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float corr = expf(m[r] - m_new);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = expf(sc[4 * j + 2 * r + c] - m_new);
            sc[4 * j + 2 * r + c] = p;
            rs += p;
          }
        l[r] = l[r] * corr + rs;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          o[4 * n + 2 * r] *= corr;
          o[4 * n + 2 * r + 1] *= corr;
        }
      }

      // O += hi V + lo V: k16 step j takes keys k0 + 16j .. + 15; its A
      // registers are the accumulator's pairs (rows g, g + 8) x (column
      // groups 2j, 2j + 1)
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * (2 * j + (i >> 1)) + 2 * (i & 1);
          split_bf16x2(sc[e], sc[e + 1], ph[j][i], pl[j][i]);
        }
      pin(o);
      wg_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        // V (kv, d) read MN-major: 8 kv rows 1,024 bytes apart, the d
        // halves BK rows of 128 bytes apart
        const uint64_t vd = sw128_desc(vs + j * 16 * 128, BK * 128, 1024);
        wgmma_bf16_rs<DP>(o, pl[j], vd);
        wgmma_bf16_rs<DP>(o, ph[j], vd);
      }
      wg_commit();
      wg_wait_all();
      pin(o);
    }
    __syncwarp();                   // this warp is done with stage s
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  if (!wg_live) return;
  bf16* ob = a.o + ((int64_t)b * a.Sq * a.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(FULL_MASK, lr, 1);
    lr += __shfl_xor_sync(FULL_MASK, lr, 2);
    const int qpos = row0 + 8 * r;
    if (qpos >= a.Sq) continue;
    // a row that has seen no visible key: 0 and lse = +inf where the
    // log-sum-exp is written
    const bool blind = LSE && !(m[r] > NEG_INF);
    const float inv = blind ? 0.f : 1.f / fmaxf(lr, 1e-30f);
    if (LSE && t == 0)
      a.lse[((int64_t)b * a.H + h) * a.Sq + qpos] =
          blind ? INFINITY : m[r] + logf(lr);
    bf16* orow = ob + qpos * q_row;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      const float x0 = o[4 * n + 2 * r] * inv, x1 = o[4 * n + 2 * r + 1] * inv;
      if (a.o_pairs) {
        if (d < D)
          *(__nv_bfloat162*)(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < D) orow[d] = __float2bfloat16_rn(x0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// k or v (B, Skv, G, D) as a 4-D map (D, G, Skv, B), boxes of 64 d values
// x 64 kv rows (tma.cuh)
bool kv_map(CUtensorMap* m, const void* x, const Args& a) {
  return bf16_map_4d(m, x, a.D, a.G, a.Skv, a.B, BK);
}

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

int load_route(const Args& a) {
  if (a.D % 8 != 0 || !aligned16(a.k) || !aligned16(a.v)) return LOAD_REGS;
  return a.D >= ATOM ? LOAD_TMA : LOAD_CP_ASYNC;
}

template <int DP, int WG, bool LSE>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = fa_bf16_kernel<DP, WG, LSE>;
  const size_t smem = Smem<DP, WG>::bytes();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (a.load == LOAD_TMA && !(kv_map(&tk, a.k, a) && kv_map(&tv, a.v, a)))
    return -2;
  dim3 grid((a.Sq + 64 * WG - 1) / (64 * WG), a.H, a.B);
  kern<<<grid, WG * 128 + 32, smem, stream>>>(tk, tv, a);
  return (int)cudaGetLastError();
}

// two warpgroups (128 q rows) share each kv tile from 256 rows on
int warpgroups(int Sq) { return Sq >= 256 ? 2 : 1; }

template <int DP, bool LSE>
int launch_rows(const Args& a, cudaStream_t stream) {
  return warpgroups(a.Sq) == 2 ? launch<DP, 2, LSE>(a, stream)
                               : launch<DP, 1, LSE>(a, stream);
}

template <int DP>
int launch_lse(const Args& a, cudaStream_t stream) {
  return a.lse ? launch_rows<DP, true>(a, stream)
               : launch_rows<DP, false>(a, stream);
}

size_t smem_bytes(int DP, int WG) {
  if (DP == 64) return WG == 2 ? Smem<64, 2>::bytes() : Smem<64, 1>::bytes();
  return WG == 2 ? Smem<128, 2>::bytes() : Smem<128, 1>::bytes();
}

}  // namespace

// q (B,Sq,H,D), k and v (B,Skv,G,D), o (B,Sq,H,D), all bfloat16 and
// contiguous on the device; lse (B,H,Sq) float32, or null for no
// log-sum-exp. D <= 128, H % G == 0, Skv >= 1. Returns a cudaError_t (0
// on success); -1 for a D the kernel does not take, -2 where a tensor
// map is refused.
extern "C" int flash_attention_bf16_fwd(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int Sq, int Skv, int H, int G,
                                        int D, int causal, int window,
                                        float scale, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (D < 1 || D > 128) return -1;
  Args a{(const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse,
         B, Sq, Skv, H, G, D, causal, window, scale, 0, 0, 0};
  a.load = load_route(a);
  a.q_vec = D % 8 == 0 && aligned16(q);
  a.o_pairs = D % 2 == 0 && ((uintptr_t)o % 4) == 0;
  return D <= ATOM ? launch_lse<64>(a, stream) : launch_lse<128>(a, stream);
}

// The launch flash_attention_bf16_fwd makes for these arguments, into
// out[8]: D padded, warpgroups, q rows a block, kv rows a tile, stages,
// the load route (0 TMA, 1 cp.async, 2 registers), shared memory bytes,
// threads a block.
extern "C" void flash_attention_bf16_shape(const void* k, const void* v,
                                           int Sq, int D, int* out) {
  Args a{};
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.D = D;
  const int DP = D <= ATOM ? 64 : 128, WG = warpgroups(Sq);
  const int shape[8] = {DP, WG, 64 * WG, BK, STAGES, load_route(a),
                        (int)smem_bytes(DP, WG), WG * 128 + 32};
  memcpy(out, shape, sizeof(shape));
}
