// The gradient of the Mamba2 SSD chunked scan (K4's backward) on
// bfloat16 x, B, C and dy, for Hopper (sm_90a): nine passes whose
// products run on bf16 wgmma, the bfloat16 tiles landed once in shared
// memory by TMA and never widened.
//
// Replaces: XLA's gradient of repro/models/ssd.py:ssd_scan (the reference
// trains through autodiff of its jnp scan; it has no Pallas backward),
// for bfloat16 x, Bm, Cm and dy (float32 ones take csrc/ssd_scan_bwd.cu,
// which states the function and its passes). The same arguments, scratch
// and outputs as that library (csrc/ssd_bwd_common.cuh): the forward's
// operands and its float32 scratch (dts, cum, cb, S_in, as
// csrc/ssd_scan_bf16.cu writes them), dy and d(final) or none; dx, dB and
// dC in bfloat16 rounded to nearest even, ddt in dt's dtype, dA in
// float32, d(init) in the state's dtype.
//
// Bound: bytes. At mamba2-370m's training shape (B=4, S=2048, H=32,
// P=64, G=1, N=128, Q=256) the function moves 110.1 MB of bf16 operands
// and gradients (0.0329 ms at 3.35 TB/s) for 26.3 GFLOP (0.027 ms at the
// 989 TFLOP/s dense bf16 peak of an H100 SXM; chip_smoke.ssd_bwd_work).
// This design's own floor is higher (chip_smoke.ssd_bwd_bf16_design): its
// products come to 48.4 GFLOP of bf16 units (D one, every other product
// two: the second parts below; 0.049 ms), and its passes move their
// float32 scratch through device memory (S_in, dstates / G_c, the dcb
// and head-term partials, 21-34 MB each at that shape, read and written
// by several passes), about 0.7 GB in all (about 0.21 ms).
//
// Arithmetic (kernels/ssd.py:ssd_scan_bwd_bf16 is a float64 model of it,
// bwd_error_bound's bfloat16 terms its bound). Every product is
// wgmma.mma_async m64nNk16 .f32.bf16.bf16, accumulated in float32; a
// product of two bfloat16 numbers is exact in float32.
// - D = dy_t . x_s^T (pass 3): both bfloat16, one product, exact.
// - Every other product has one float32 operand, split into hi = bf16(v)
//   and lo = bf16(v - hi), within 2^-16 |v| (hopper.cuh:split_bf16x2),
//   and takes two bf16 products: dstates (exp(cum) dy, split, against C),
//   dx's state term (B against G_c, split) and intra term (W = cb L,
//   split, against dy), the head terms (dy against S_in, x against G_c,
//   both split), dB's and dC's intra terms (dcb, split, against C and B).
//
// Design. The float32 library's nine passes (its header says why each
// exists); 2, 6, 8 and 9 run no products and are shared with it
// (csrc/ssd_bwd_common.cuh).
// - Layout: every bf16 tile is 64 rows in the 128-byte swizzle, one or
//   two column halves of 64 values, landed once and read in whichever
//   orientation a product needs: K-major as stored (dy and x in D, the
//   head terms' A operand; B_s in dx's state term), or MN-major through
//   the transpose bit (C in dstates, dy in dx's intra term, B and C in
//   dbc). The split float32 operands are formed in registers as A
//   fragments (exp(cum) dy, W, dcb) or split into hi and lo swizzled
//   tiles (G_c, S_in), as the forward splits its S_in.
// - Loads: the forward's routes (csrc/bf16_tiles.cuh): TMA through a 4-D
//   map where P or N is at least 64, a multiple of 8 and the base 16-byte
//   aligned; 16-byte cp.async to the same swizzled addresses where the
//   width is a multiple of 8 below 64 (hymba-1.5b's N = 16); registers
//   otherwise. Rows of the next chunk inside a chunk's last tile (Q % 64
//   != 0) are zeroed after they land.
// - Pass 1 (dstates): the forward's chunk-state pass with dy for x and
//   exp(cum_t) for its weights: per (b, h, chunk) two warpgroups, each
//   half of the chunk's t tiles over all of N, M = p; warpgroup 1's sum
//   reaches warpgroup 0 through shared memory.
// - Pass 3 (dcb): per (b, chunk, group, tile pair t >= s, head slice),
//   one warpgroup; a head's dy_t and x_s tiles land in a 2-stage ring
//   while the head before it runs; D in four k16 steps; the rest as the
//   float32 pass. Three blocks an SM (168 registers).
// - Pass 4 (dx): per (b, h, chunk), two warpgroups that share out its s
//   tiles (0, 1, 1, 0 from the first, the heaviest) and then run apart,
//   as the forward's chunk scan shares out its t tiles. G_c (split into
//   hi and lo tiles once) and every dy tile of the chunk land at the
//   start, each dy tile on its own mbarrier; B_s lands by TMA in the
//   warpgroup's buffer, the next one's while this one's intra term runs;
//   W's cb values come from device memory into registers a step ahead.
//   Below the diagonal exp(cum_t - cum_s) = exp(cum_t - R) exp(R -
//   cum_s), R = cum at the t tile's first position (both factors at
//   most 1, vectors once per block); on the diagonal per element, masked
//   first.
// - Pass 5 (heads): per (b, chunk, group, 64-row tile, dC or dB, 64 of N,
//   head slice), acc[u][n], M = u (the rows), K = p: the head's dy or x
//   tile the K-major A operand (2-stage ring), S_in or G_c split into hi
//   and lo tiles as the B operand read MN-major (its float32 rows staged
//   by cp.async while the head before runs); I_t from the
//   accumulator rows and the C tile. Three blocks an SM.
// - Pass 7 (dbc): per (b, chunk, group, tile, dC or dB, 64 of N): the
//   head terms, then dcb's fragments (split in registers, fetched a step
//   ahead) against every B or C tile of the K range, landed at the start.
// No atomics: every sum runs in a fixed order, the same bits on every
// launch; the head slices' partials are added in slice order (pass 6).
// Tried on an H100 and slower (PERF.md, section 6): dx as one
// warpgroup per (b, h, chunk, s tile), G_c split and dy landed by every
// s tile's block (0.279 ms at mamba2-370m's shape against 0.167); heads
// with the next head's operand split while this head's products run
// (0.160 against 0.133); heads with that operand held in registers
// between heads (0.133, but it spilled at three blocks an SM); two head
// slices instead of four (dcb 0.138 against 0.127).
// Shared memory a block (bytes, N > 64 / N <= 64) and registers a thread
// (ptxas -v, nvcc 12.8, sm_90a), no spills:
//       pass        dstates          dcb      dx               heads   dbc
//       threads     256              128      256              128     128
//       smem        100,384/67,616   36,624   106,544/73,776   58,392  33,824
//       registers   128/104          168      127              159     128
// and 108 (state passing), 32 (sum, ddt), 30 (dA) registers: two blocks
// an SM in passes 1 and 4, three in 3 and 5 (capped at 168 registers).
//
// Interface: plain C, loaded with ctypes. Every pass takes the float32
// library's arguments (in_bf16 must be 1), launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (or the error of
// raising the shared-memory limit); -1 for a shape it does not take, -2
// where a tensor map is refused. ssd_bwd_bf16_shape() reports the launch.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>
#include "bf16_tiles.cuh"
#include "hopper.cuh"

#define BWD_BF16_LIB 1        // x, B, C and dy in bfloat16 only
#include "ssd_bwd_common.cuh"
#include "tma.cuh"

namespace {

constexpr int T = SSD_BWD_T;                 // rows of a tile; the wgmma M
constexpr int TILE = BF16_TILE_BYTES;        // bytes of a 64-row column half
constexpr int QMAX = SSD_BWD_QMAX;
constexpr int NTILE = QMAX / T;              // tiles of a chunk, at most

__device__ __forceinline__ const bf16* bfp(const void* p) {
  return (const bf16*)p;
}

template <typename K>
int raise_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------- 1 ----
// grid (H * nc, B), two warpgroups, each half of the chunk's t tiles (K)
// over all of N: dstates (P x N) = sum_t (dy_t exp(cum_t))^T C_t, M = p,
// N = n (NH halves, one wgmma), K = t; the A fragments dy_t exp(cum_t)
// split in registers, C_t read with the transpose bit. Warpgroup 1's sum
// goes through shared memory to warpgroup 0, which stores dstates.
template <int NH>
__global__ void __launch_bounds__(256, 2)
    dstates_bf16_kernel(const __grid_constant__ CUtensorMap tm_dy,
                        const __grid_constant__ CUtensorMap tm_c, BwdArgs a,
                        int yload, int cload) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* yt = align1024(smem_raw);             // [NTILE] dy tiles
  uint8_t* ctl = yt + NTILE * TILE;               // [NTILE][NH] C tiles
  float* ev = (float*)(ctl + NTILE * NH * TILE);  // [QMAX] exp(cum)
  const uint32_t bar0 = sa(ev + QMAX);            // [NTILE] barriers
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  const int nt = (len + T - 1) / T;
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const bool tma = yload == LOAD_TMA || cload == LOAD_TMA;
  if (tid == 0 && tma) {
    for (int i = 0; i < nt; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_fence_init();
    const uint32_t bytes =
        (yload == LOAD_TMA ? TILE : 0) + (cload == LOAD_TMA ? NH * TILE : 0);
    for (int i = 0; i < nt; ++i) {
      const uint32_t bar = bar0 + 8 * i;
      const int row = (int)(c0 + i * T);
      mbar_expect_tx(bar, bytes);
      if (yload == LOAD_TMA)
        tma_load_4d(sa(yt + i * TILE), &tm_dy, bar, 0, h, row, b);
      if (cload == LOAD_TMA)
        for (int k = 0; k < NH; ++k)
          tma_load_4d(sa(ctl + (i * NH + k) * TILE), &tm_c, bar, 64 * k, g,
                      row, b);
    }
  }
  const int64_t v0 = (((int64_t)b * a.H + h) * a.nc + c) * a.QP;
  for (int i = tid; i < a.QP; i += 256) ev[i] = expf(a.cum[v0 + i]);
  const bf16* ys = bfp(a.dy) + ((int64_t)b * a.S + c0) * xld +
                   (int64_t)h * a.P;
  const bf16* cs = bfp(a.Cm) + ((int64_t)b * a.S + c0) * bld +
                   (int64_t)g * a.N;
  for (int i = 0; i < nt; ++i) {
    if (yload != LOAD_TMA)
      land_tile(yt + i * TILE, ys + i * T * xld, xld, len - i * T, a.P, 1,
                yload, tid, 256);
    if (cload != LOAD_TMA)
      land_tile(ctl + i * NH * TILE, cs + i * T * bld, bld, len - i * T,
                a.N, NH, cload, tid, 256);
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();                   // ev, the barriers, the other routes

  // the warpgroup, warp-uniform as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), tw = tid & 127;
  const int lane = tw & 31, wl = tw >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int p0 = 16 * wl + g8;               // this thread's rows p0, p0 + 8
  const int mid = (nt + 1) / 2;              // warpgroup 0: tiles [0, mid)
  float acc[32 * NH];
#pragma unroll
  for (int i = 0; i < 32 * NH; ++i) acc[i] = 0.f;
  for (int i = wg ? mid : 0; i < (wg ? nt : mid); ++i) {
    if (tma) {
      mbar_wait(bar0 + 8 * i, 0);
      const int rows_ok = len - i * T;
      if (rows_ok < T) {             // the next chunk's rows, TMA's: zero
        if (yload == LOAD_TMA) zero_tail(yt + i * TILE, 1, rows_ok, tw, 128);
        if (cload == LOAD_TMA)
          zero_tail(ctl + i * NH * TILE, NH, rows_ok, tw, 128);
        fence_async_smem();
        named_sync(1 + wg, 128);
      }
    }
    // A fragment of k16 step kk, register q: row p0 + 8 (q & 1), k = t
    // at 16 kk + 2 t4 + 8 (q >> 1) and the one after it
    const uint8_t* y = yt + i * TILE;
    const float* w = ev + i * T;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + 8 * (q & 1), s = 16 * kk + 2 * t4 + 8 * (q >> 1);
        split_bf16x2(at(y, s, p) * w[s], at(y, s + 1, p) * w[s + 1],
                     ah[kk][q], al[kk][q]);
      }
    // C (t, n) read MN-major: 8 t rows 1,024 bytes apart, the n halves 64
    // rows of 128 bytes apart
    const uint32_t ctd = sa(ctl + i * NH * TILE);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = sw128_desc(ctd + kk * 16 * 128, TILE, 1024);
      wgmma_bf16_rs<64 * NH>(acc, al[kk], bd);
      wgmma_bf16_rs<64 * NH>(acc, ah[kk], bd);
    }
    wg_commit();
    wg_wait_all();
    pin(acc);
  }

  // warpgroup 1's sum to warpgroup 0 through the dy tiles' memory, each
  // thread's values at [i][tw] (no bank conflicts)
  __syncthreads();                   // every product is done
  float* red = (float*)yt;
  if (wg == 1 && mid < nt) {
#pragma unroll
    for (int i = 0; i < 32 * NH; ++i) red[i * 128 + tw] = acc[i];
  }
  __syncthreads();
  if (wg == 1) return;
  if (mid < nt) {
#pragma unroll
    for (int i = 0; i < 32 * NH; ++i) acc[i] += red[i * 128 + tw];
  }
  // acc[4j + 2r + e] is dstates[p0 + 8r][8j + 2 t4 + e]
  float* out = a.dst + (((int64_t)b * a.H + h) * a.nc + c) * a.P * a.N;
#pragma unroll
  for (int j = 0; j < 8 * NH; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + 8 * r, n = 8 * j + 2 * t4;
      if (p >= a.P) continue;
      float* o = out + p * a.N + n;
      if (n + 1 < a.N && (a.N & 1) == 0) {
        *(float2*)o = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      } else {
        if (n < a.N) o[0] = acc[4 * j + 2 * r];
        if (n + 1 < a.N) o[1] = acc[4 * j + 2 * r + 1];
      }
    }
}

// ---------------------------------------------------------------- 3 ----
// grid (ntri * HS, nc * G, B), one warpgroup: the tile pair (ti, si), si
// <= ti, of chunk c and group g, heads of slice hs. Per head: D (t x s) =
// dy_t . x_s^T (K = p, both K-major as they land), then dcb += L dt_s D,
// and M = cb L dt_s D summed along each row (s < t) into rs[si] and each
// column (t > s) into cs[ti]. A head's two tiles land in a 2-stage ring
// while the head before it runs. A thread's accumulator rows t = r0, r0
// + 8, columns s = 8j + 2 t4 + e.
__global__ void __launch_bounds__(128, 3)
    dcb_bf16_kernel(const __grid_constant__ CUtensorMap tm_dy,
                    const __grid_constant__ CUtensorMap tm_x, BwdArgs a,
                    int xload) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tl = align1024(smem_raw);         // [2][dy_t, x_s]
  float* vt = (float*)(tl + 4 * TILE);       // [2][cum_t, cum_s, dt_s][T]
  float* red = vt + 6 * T;                   // [4][T] column sums by warp
  float* cf = red + 4 * T;                   // [T] exp(ref - cum_s) dt_s
  const uint32_t bar0 = sa(cf + T);          // [2]
  const int ntri = a.nt * (a.nt + 1) / 2;
  const int tile = blockIdx.x % ntri, hs = blockIdx.x / ntri;
  const int g = blockIdx.y % a.G, c = blockIdx.y / a.G, b = blockIdx.z;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int si = tile - ti * (ti + 1) / 2;
  const int len = chunk_len(a, c);
  if (ti * T >= len) return;                 // past the chunk: never read
  const int tid = threadIdx.x;
  const int h_lo = slice_head(a, g, hs), h_hi = slice_head(a, g, hs + 1);
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P;
  const int64_t cbo = (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP +
                      (int64_t)(ti * T) * a.QP + si * T;
  const int trows = min(T, len - ti * T), srows = min(T, len - si * T);
  const bf16* dys = bfp(a.dy) + ((int64_t)b * a.S + c0 + ti * T) * xld;
  const bf16* xs = bfp(a.x) + ((int64_t)b * a.S + c0 + si * T) * xld;
  if (tid == 0 && xload == LOAD_TMA) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_fence_init();
  }
  // head h into stage k & 1
  auto load_head = [&](int h, int k) {
    uint8_t* st = tl + (k & 1) * 2 * TILE;
    if (xload == LOAD_TMA) {
      if (tid == 0) {
        const uint32_t bar = bar0 + 8 * (k & 1);
        mbar_expect_tx(bar, 2 * TILE);
        tma_load_4d(sa(st), &tm_dy, bar, 0, h, (int)(c0 + ti * T), b);
        tma_load_4d(sa(st + TILE), &tm_x, bar, 0, h, (int)(c0 + si * T), b);
      }
    } else {
      land_tile(st, dys + (int64_t)h * a.P, xld, trows, a.P, 1, xload, tid,
                128);
      land_tile(st + TILE, xs + (int64_t)h * a.P, xld, srows, a.P, 1, xload,
                tid, 128);
    }
    float* v = vt + (k & 1) * 3 * T;
    const float* cu = a.cum + (((int64_t)b * a.H + h) * a.nc + c) * a.QP;
    const float* dd = a.dts + (((int64_t)b * a.H + h) * a.nc + c) * a.QP;
    for (int i = tid; i < 3 * T; i += 128) {
      const float* src = i < T ? cu + ti * T + i
                               : i < 2 * T ? cu + si * T + i - T
                                           : dd + si * T + i - 2 * T;
      cp_async4(v + i, src, 4);
    }
  };

  const int lane = tid & 31, wl = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;
  __syncthreads();                           // the barriers
  load_head(h_lo, 0);
  cp_commit();
  float cbv[32], dcb[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = *(const float2*)(a.cb + cbo +
                                        (int64_t)(r0 + 8 * r) * a.QP + 8 * j +
                                        2 * t4);
      cbv[4 * j + 2 * r] = v.x;
      cbv[4 * j + 2 * r + 1] = v.y;
      dcb[4 * j + 2 * r] = dcb[4 * j + 2 * r + 1] = 0.f;
    }
  for (int h = h_lo; h < h_hi; ++h) {
    const int k = h - h_lo;
    uint8_t* st = tl + (k & 1) * 2 * TILE;
    cp_async_wait_all();
    if (xload == LOAD_TMA) {
      mbar_wait(bar0 + 8 * (k & 1), (k >> 1) & 1);
      if (trows < T) zero_tail(st, 1, trows, tid, 128);
      if (srows < T) zero_tail(st + TILE, 1, srows, tid, 128);
    }
    fence_async_smem();
    __syncthreads();                  // head h's tiles are in; red is read
    const float* v = vt + (k & 1) * 3 * T;
    const float ref = v[2 * T - 1];   // cum at the s tile's last position
    if (ti > si && tid < T)
      cf[tid] = expf(ref - v[T + tid]) * v[2 * T + tid];
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    pin(d);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_ss_n64(d, sw128_desc(sa(st) + 32 * kk, 16, 1024),
                        sw128_desc(sa(st + TILE) + 32 * kk, 16, 1024));
    wg_commit();
    if (h + 1 < h_hi) load_head(h + 1, k + 1);
    cp_commit();
    wg_wait_all();
    pin(d);
    __syncthreads();                  // cf is written

    // L dt_s: below the diagonal exp(cum_t - ref) (exp(ref - cum_s)
    // dt_s), both factors at most 1; on it per element, masked first
    float rsum[2] = {0.f, 0.f}, csum[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) csum[q] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tl_ = r0 + 8 * r, t = ti * T + tl_;
      const float ct = v[tl_];
      const float rf = ti > si ? expf(ct - ref) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int sl = 8 * j + 2 * t4 + e, s = si * T + sl;
          const int i = 4 * j + 2 * r + e;
          float z = 0.f, m = 0.f;
          if (ti > si) {
            z = d[i] * (rf * cf[sl]);
            m = cbv[i] * z;
          } else if (s <= t) {               // mask before the exp
            z = d[i] * (expf(ct - v[T + sl]) * v[2 * T + sl]);
            if (s < t) m = cbv[i] * z;
          }
          dcb[i] += z;
          rsum[r] += m;
          csum[2 * j + e] += m;
        }
    }
    const int64_t o = (((int64_t)b * a.H + h) * a.nc + c) * a.nt * a.QP;
#pragma unroll
    for (int r = 0; r < 2; ++r) {             // row t: over the 4 lanes t4
      rsum[r] += __shfl_xor_sync(SSD_BWD_MASK, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(SSD_BWD_MASK, rsum[r], 2);
      if (t4 == 0) a.rs[o + (int64_t)si * a.QP + ti * T + r0 + 8 * r] = rsum[r];
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {            // column s: over the 8 lanes g8
      csum[q] += __shfl_xor_sync(SSD_BWD_MASK, csum[q], 4);
      csum[q] += __shfl_xor_sync(SSD_BWD_MASK, csum[q], 8);
      csum[q] += __shfl_xor_sync(SSD_BWD_MASK, csum[q], 16);
    }
    if (g8 == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[wl * T + 8 * j + 2 * t4 + e] = csum[2 * j + e];
    }
    __syncthreads();
    if (tid < T)                              // then over the 4 warps
      a.cs[o + (int64_t)ti * a.QP + si * T + tid] =
          (red[tid] + red[T + tid]) + (red[2 * T + tid] + red[3 * T + tid]);
  }
  float* out = a.dcbp +
               ((((int64_t)hs * a.B + b) * a.nc + c) * a.G + g) * a.QP *
                   a.QP + (int64_t)(ti * T) * a.QP + si * T;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *(float2*)(out + (int64_t)(r0 + 8 * r) * a.QP + 8 * j + 2 * t4) =
          make_float2(dcb[4 * j + 2 * r], dcb[4 * j + 2 * r + 1]);
}

// the split float32 rows p x columns [0, 64 NH) of a (P, N) matrix,
// K-major hi and lo swizzled tiles (rows p, zeros past P and N), as the
// forward splits its S_in: by 256 threads, float4 groups of a row each
template <int NH>
__device__ __forceinline__ void split_pn(const float* m, const BwdArgs& a,
                                         uint8_t* hi, uint8_t* lo, int tid) {
  constexpr int Q4 = 16 * NH;                // 4-value groups a row
  constexpr int PER = T * Q4 / 256;
#pragma unroll 4
  for (int k = 0; k < PER; ++k) {
    const int i = tid + 256 * k, p = i / Q4, n = 4 * (i % Q4);
    float4 v;
    if (p < a.P && n + 3 < a.N && a.v4n) {
      v = __ldg((const float4*)(m + p * a.N + n));
    } else {
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        e[q] = p < a.P && n + q < a.N ? m[p * a.N + n + q] : 0.f;
      v = make_float4(e[0], e[1], e[2], e[3]);
    }
    uint2 h2, l2;
    split_bf16x2(v.x, v.y, h2.x, l2.x);
    split_bf16x2(v.z, v.w, h2.y, l2.y);
    const uint32_t o = sw128(p, n, T);
    *(uint2*)(hi + o) = h2;
    *(uint2*)(lo + o) = l2;
  }
}

// ---------------------------------------------------------------- 4 ----
// grid (H * nc, B), two warpgroups: dx of one (b, h, chunk). The s tiles
// are shared out from the first (the heaviest: the most t tiles) in the
// order 0, 1, 1, 0 (4 tiles: warpgroup 0 takes 0 and 3, warpgroup 1
// takes 1 and 2, five intra steps each), and each warpgroup runs its own
// on its own after the start. G_c (split into hi and lo K-major tiles)
// and every dy tile of the chunk land once, at the start, and stay. An s
// tile si, rows s = r0, r0 + 8 of a thread, columns p = 8j + 2 t4 + e:
// B_s (K-major, TMA into the warpgroup's buffer; the next one's while
// this one's intra term runs) times G_c, K = n, skipped where G_c is zero
// (the last chunk without a d(final)); then exp(total - cum_s) and K_s;
// then over the t tiles ti >= si, W^T (W = cb L, formed and split in
// registers from cb values read a step ahead, K = t) times dy_t (read
// MN-major). Below the diagonal exp(cum_t - cum_s) = exp(cum_t - R)
// exp(R - cum_s), R = cum at the t tile's first position, both factors
// at most 1 (vectors once per block); on the diagonal per element,
// masked first. Then dx = dt_s dxdt, ddts = x . that.
template <int NH>
__global__ void __launch_bounds__(256, 2)
    dx_bf16_kernel(const __grid_constant__ CUtensorMap tm_dy,
                   const __grid_constant__ CUtensorMap tm_b, BwdArgs a,
                   int xload, int bload) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* yt = align1024(smem_raw);           // [NTILE] dy tiles
  uint8_t* gh = yt + NTILE * TILE;              // [NH] G_c hi, rows p
  uint8_t* gl = gh + NH * TILE;                 // [NH] G_c lo
  uint8_t* btw = gl + NH * TILE;                // [2][NH] B_s, a warpgroup's
  float* cumv = (float*)(btw + 2 * NH * TILE);  // [QMAX]
  float* dtv = cumv + QMAX;                     // [QMAX]
  float* rowf = dtv + QMAX;                     // [QMAX] exp(cum_t - R)
  float* colm = rowf + QMAX;                    // [NTILE][QMAX] exp(R - cum_s)
  const uint32_t ybar = sa(colm + NTILE * QMAX);  // [NTILE], then B_s's [2]
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  const int ntl = (len + T - 1) / T, last = ntl - 1;
  const int lrows = len - last * T;
  const int tid = threadIdx.x;
  // the warpgroup, warp-uniform as the compiler sees it (a branch on it
  // around wgmma would otherwise serialise every wgmma of the kernel)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), tw = tid & 127;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  const int64_t pn = (int64_t)a.P * a.N;
  // G_c is zero in the last chunk without a d(final): no state term
  const bool state = !(c == a.nc - 1 && a.dfinal == nullptr);
  const bf16* ys = bfp(a.dy) + ((int64_t)b * a.S + c0) * xld +
                   (int64_t)h * a.P;
  const bf16* xs = bfp(a.x) + ((int64_t)b * a.S + c0) * xld +
                   (int64_t)h * a.P;
  const bf16* bs = bfp(a.Bm) + ((int64_t)b * a.S + c0) * bld +
                   (int64_t)g * a.N;
  const float* cb0 = a.cb + (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP;
  uint8_t* bt = btw + wg * NH * TILE;           // this warpgroup's B_s
  const uint32_t bbar = ybar + 8 * (NTILE + wg);
  // the j-th s tile is warpgroup 0's where j % 4 is 0 or 3
  auto mine = [&](int s) {
    const int j = s & 3;
    return (j == 0 || j == 3) == (wg == 0);
  };
  auto next_mine = [&](int s) {               // its next s tile after s
    for (int u = s + 1; u < ntl; ++u)
      if (mine(u)) return u;
    return -1;
  };
  // B_s of s tile si into this warpgroup's buffer: TMA on its barrier, or
  // the other routes by its threads (they wait before using it)
  auto load_b = [&](int si) {
    if (bload == LOAD_TMA) {
      if (tw == 0) {
        mbar_expect_tx(bbar, NH * TILE);
        for (int k = 0; k < NH; ++k)
          tma_load_4d(sa(bt + k * TILE), &tm_b, bbar, 64 * k, g,
                      (int)(c0 + si * T), b);
      }
    } else {
      land_tile(bt, bs + (int64_t)(si * T) * bld, bld, len - si * T, a.N, NH,
                bload, tw, 128);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < NTILE + 2; ++i) mbar_init(ybar + 8 * i, 1);
    mbar_fence_init();
    if (xload == LOAD_TMA)
      for (int ti = 0; ti < ntl; ++ti) {
        mbar_expect_tx(ybar + 8 * ti, TILE);
        tma_load_4d(sa(yt + ti * TILE), &tm_dy, ybar + 8 * ti, 0, h,
                    (int)(c0 + ti * T), b);
      }
  }
  __syncthreads();                              // the barriers
  int si = mine(0) ? 0 : next_mine(0);          // this warpgroup's first
  if (state && si >= 0) load_b(si);
  const int64_t v0 = bhc * a.QP;
  for (int i = tid; i < a.QP; i += 256) {
    const float cu = a.cum[v0 + i];
    cumv[i] = cu;
    dtv[i] = a.dts[v0 + i];
    rowf[i] = expf(cu - a.cum[v0 + (i & ~(T - 1))]);
    for (int k = 1; k < NTILE; ++k)             // R = cum at k T
      colm[k * QMAX + i] = i < k * T && k * T < a.QP
                               ? expf(a.cum[v0 + k * T] - cu) : 0.f;
  }
  if (state) split_pn<NH>(a.dst + bhc * pn, a, gh, gl, tid);
  if (xload != LOAD_TMA)
    for (int ti = 0; ti < ntl; ++ti)
      land_tile(yt + ti * TILE, ys + ti * T * xld, xld, len - ti * T, a.P,
                1, xload, tid, 256);
  cp_async_wait_all();
  if (xload == LOAD_TMA && lrows < T) {
    mbar_wait(ybar + 8 * last, 0);  // the last dy tile's rows past the chunk
    zero_tail(yt + last * TILE, 1, lrows, tid, 256);
  }
  fence_async_smem();
  __syncthreads();                  // G_c's split, the vectors, the routes

  const int lane = tw & 31, wl = tw >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;
  // cb's values of step (si, ti) for this thread's A fragments: k16 step
  // kk, register q (row s = r0 + 8 (q & 1), k = t at 16 kk + 2 t4 + 8 (q
  // >> 1) and the one after it) is cbv[kk][q][0, 1] = cb[t][s], cb[t +
  // 1][s]
  float cbv[4][4][2];
  auto fetch = [&](int s1, int t1) {
    const float* src = cb0 + (int64_t)(t1 * T) * a.QP + s1 * T;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cbv[kk][q][e] = __ldg(src + (int64_t)(16 * kk + 2 * t4 +
                                                8 * (q >> 1) + e) * a.QP +
                                r0 + 8 * (q & 1));
  };
  if (si >= 0) fetch(si, si);
  const int ks = (a.N + 15) / 16;
  uint32_t bphase = 0;
  for (; si >= 0; si = next_mine(si)) {
    const int s_next = next_mine(si);
    float acc[32], kp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (state) {
      if (bload == LOAD_TMA) {
        mbar_wait(bbar, bphase);
        bphase ^= 1;
        if (len - si * T < T) {       // B_s's rows past the chunk: zero
          zero_tail(bt, NH, len - si * T, tw, 128);
          fence_async_smem();
          named_sync(1 + wg, 128);
        }
      }
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NH; ++kk) {
        if (kk >= ks) break;
        const uint32_t o = (kk / 4) * TILE + (kk % 4) * 32;
        const uint64_t bd = sw128_desc(sa(bt) + o, 16, 1024);
        wgmma_bf16_ss_n64(acc, bd, sw128_desc(sa(gl) + o, 16, 1024));
        wgmma_bf16_ss_n64(acc, bd, sw128_desc(sa(gh) + o, 16, 1024));
      }
      wg_commit();
      wg_wait_all();
      pin(acc);
      if (s_next >= 0) {              // the next B_s, in flight
        named_sync(1 + wg, 128);      // the buffer is free
        load_b(s_next);
      }
      const float total = cumv[a.QP - 1];   // the decay, then K_s
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = si * T + r0 + 8 * r;
        const float e = expf(total - cumv[s]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int i = 4 * j + 2 * r + q, p = 8 * j + 2 * t4 + q;
            acc[i] *= e;
            if (s < len && p < a.P)
              kp[r] = fmaf(__bfloat162float(xs[(int64_t)s * xld + p]),
                           acc[i], kp[r]);
          }
        kp[r] *= dtv[s];
      }
    }
    for (int ti = si; ti <= last; ++ti) {
      if (xload == LOAD_TMA) mbar_wait(ybar + 8 * ti, 0);
      const float cm[2] = {colm[ti * QMAX + si * T + r0],
                           colm[ti * QMAX + si * T + r0 + 8]};
      uint32_t wh[4][4], wlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = si * T + r0 + 8 * (q & 1);
          const int t = ti * T + 16 * kk + 2 * t4 + 8 * (q >> 1);
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (ti > si)
              w[e] = cbv[kk][q][e] * (rowf[t + e] * cm[q & 1]);
            else                        // mask before the exp
              w[e] = s <= t + e && t + e < len
                         ? cbv[kk][q][e] * expf(cumv[t + e] - cumv[s])
                         : 0.f;
          }
          split_bf16x2(w[0], w[1], wh[kk][q], wlo[kk][q]);
        }
      if (ti < last) fetch(si, ti + 1);
      else if (s_next >= 0) fetch(s_next, s_next);
      const uint32_t yd = sa(yt + ti * TILE);
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // dy (t, p) read MN-major: 8 t rows 1,024 bytes apart
        const uint64_t d = sw128_desc(yd + kk * 16 * 128, TILE, 1024);
        wgmma_bf16_rs_n64(acc, wlo[kk], d);
        wgmma_bf16_rs_n64(acc, wh[kk], d);
      }
      wg_commit();
      wg_wait_all();
      pin(acc);
    }

    // acc[4j + 2r + e] is dxdt[s = si T + r0 + 8r][p = 8j + 2 t4 + e]
    bf16* dxs = (bf16*)a.dx + ((int64_t)b * a.S + c0) * xld +
                (int64_t)h * a.P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = si * T + r0 + 8 * r;
      const float d = dtv[s];
      float pd = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = 8 * j + 2 * t4 + q;
          if (s < len && p < a.P) {
            const int64_t o = (int64_t)s * xld + p;
            const float dxdt = acc[4 * j + 2 * r + q];
            dxs[o] = __float2bfloat16_rn(d * dxdt);
            pd = fmaf(__bfloat162float(xs[o]), dxdt, pd);
          }
        }
      pd += __shfl_xor_sync(SSD_BWD_MASK, pd, 1);
      pd += __shfl_xor_sync(SSD_BWD_MASK, pd, 2);
      float k = kp[r];
      k += __shfl_xor_sync(SSD_BWD_MASK, k, 1);
      k += __shfl_xor_sync(SSD_BWD_MASK, k, 2);
      if (t4 == 0) {
        a.pD[bhc * a.QP + s] = pd;
        a.pK[bhc * a.QP + s] = k;
      }
    }
    if (state && s_next >= 0 && bload != LOAD_TMA) {  // the next B_s landed
      cp_async_wait_all();
      fence_async_smem();
      named_sync(1 + wg, 128);
    }
  }
}

// ---------------------------------------------------------------- 5 ----
// grid (nt * 2 * NH * HS, nc * G, B), one warpgroup: the 64-row tile of
// chunk c, group g, z = 0 dC (rows t) or 1 dB (rows s), n in [64 nh, 64
// nh + 64), heads of slice hs; acc[u][n], M = u, K = p. Per head: dy
// (dC) or x (dB) (its tile K-major, a 2-stage ring) times S_in (dC) or
// G_c (dB) (its float32 rows p staged by cp.async while the head before
// runs, then split into hi and lo tiles read MN-major).
// Each head's sum is scaled per row, exp(cum_t) (dC) or exp(total -
// cum_s) dt_s (dB), and added in head order; for dC, I_t's share of
// these 64 n from the rows and the C tile.
__global__ void __launch_bounds__(128, 3)
    heads_bf16_kernel(const __grid_constant__ CUtensorMap tm_dy,
                      const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_c, BwdArgs a,
                      int xload, int cload) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* vt = align1024(smem_raw);         // [2] dy or x tiles
  uint8_t* sh = vt + 2 * TILE;               // S_in or G_c hi, rows p
  uint8_t* sl = sh + TILE;                   // ... lo
  float* sf = (float*)(sl + TILE);           // [64][64] its float32 rows
  uint8_t* ct = (uint8_t*)(sf + T * T);      // C_t (dC)
  const uint32_t bar0 = sa(ct + TILE);       // [2], then C's
  const uint32_t cbar = bar0 + 16;
  const int tile = blockIdx.x % a.nt;
  int rest = blockIdx.x / a.nt;
  const int z = rest % 2;
  rest /= 2;
  const int nh = rest % a.NH, hs = rest / a.NH;
  const int g = blockIdx.y % a.G, c = blockIdx.y / a.G, b = blockIdx.z;
  const int len = chunk_len(a, c);
  if (tile * T >= len) return;
  const int tid = threadIdx.x;
  const int h_lo = slice_head(a, g, hs);
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const int64_t pn = (int64_t)a.P * a.N;
  const int u0 = tile * T, n0 = T * nh;
  const int rows = min(T, len - u0);
  // G_c is zero in the last chunk without a d(final): dB gets nothing
  const int h_hi = z == 1 && c == a.nc - 1 && a.dfinal == nullptr
                       ? h_lo : slice_head(a, g, hs + 1);
  const bf16* vs = bfp(z == 0 ? a.dy : a.x) +
                   ((int64_t)b * a.S + c0 + u0) * xld;
  const CUtensorMap* vm = z == 0 ? &tm_dy : &tm_x;
  const float* ms = z == 0 ? a.s_in : a.dst;
  if (tid == 0 && (xload == LOAD_TMA || cload == LOAD_TMA)) {
    for (int i = 0; i < 3; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_fence_init();
    if (z == 0 && cload == LOAD_TMA) {
      mbar_expect_tx(cbar, TILE);
      tma_load_4d(sa(ct), &tm_c, cbar, n0, g, (int)(c0 + u0), b);
    }
  }
  // head h's tile into stage k & 1
  auto load_head = [&](int h, int k) {
    uint8_t* st = vt + (k & 1) * TILE;
    if (xload == LOAD_TMA) {
      if (tid == 0) {
        const uint32_t bar = bar0 + 8 * (k & 1);
        mbar_expect_tx(bar, TILE);
        tma_load_4d(sa(st), vm, bar, 0, h, (int)(c0 + u0), b);
      }
    } else {
      land_tile(st, vs + (int64_t)h * a.P, xld, rows, a.P, 1, xload, tid,
                128);
    }
  };
  // head h's rows p x columns [n0, n0 + 64) of S_in or G_c into sf by
  // cp.async (16 bytes where its rows allow, zeros past P and N)
  auto stage = [&](int h) {
    const float* m = ms + (((int64_t)b * a.H + h) * a.nc + c) * pn + n0;
    if (a.v4n) {
      for (int i = tid; i < T * T / 4; i += 128) {
        const int p = i / 16, n = 4 * (i % 16);
        const bool ok = p < a.P && n0 + n < a.N;
        cp_async16(sf + p * T + n, ok ? m + p * a.N + n : m, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < T * T; i += 128) {
        const int p = i / T, n = i % T;
        const bool ok = p < a.P && n0 + n < a.N;
        cp_async4(sf + p * T + n, ok ? m + p * a.N + n : m, ok ? 4 : 0);
      }
    }
  };
  __syncthreads();                           // the barriers
  if (z == 0 && cload != LOAD_TMA)
    land_tile(ct, bfp(a.Cm) + ((int64_t)b * a.S + c0 + u0) * bld +
                      (int64_t)g * a.N + n0,
              bld, rows, a.N - n0, 1, cload, tid, 128);
  if (h_lo < h_hi) {
    load_head(h_lo, 0);
    stage(h_lo);
  }
  cp_commit();
  if (z == 0 && cload == LOAD_TMA && rows < T) {
    mbar_wait(cbar, 0);                      // C's rows past the chunk
    zero_tail(ct, 1, rows, tid, 128);
  }

  const int lane = tid & 31, wl = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;               // rows u0 + r0, + 8
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int h = h_lo; h < h_hi; ++h) {
    const int k = h - h_lo;
    uint8_t* st = vt + (k & 1) * TILE;
    cp_async_wait_all();
    if (xload == LOAD_TMA) {
      mbar_wait(bar0 + 8 * (k & 1), (k >> 1) & 1);
      if (rows < T) zero_tail(st, 1, rows, tid, 128);
    }
    if (k == 0 && z == 0 && cload == LOAD_TMA) mbar_wait(cbar, 0);
    __syncthreads();                  // head h's rows are in; the split
                                      // tiles of head h - 1 are free
#pragma unroll
    for (int q = 0; q < 8; ++q) {     // split, K-major by rows p
      const int i = tid + 128 * q, p = i / 16, n = 4 * (i % 16);
      const float4 v = *(const float4*)(sf + p * T + n);
      uint2 h2, l2;
      split_bf16x2(v.x, v.y, h2.x, l2.x);
      split_bf16x2(v.z, v.w, h2.y, l2.y);
      const uint32_t o = sw128(p, n, T);
      *(uint2*)(sh + o) = h2;
      *(uint2*)(sl + o) = l2;
    }
    fence_async_smem();
    __syncthreads();                  // the split is in; sf is free
    float hacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
    pin(hacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // S_in or G_c (p, n) read MN-major: 8 p rows 1,024 bytes apart
      const uint64_t ad = sw128_desc(sa(st) + 32 * kk, 16, 1024);
      wgmma_bf16_ss_n64_bt(hacc, ad,
                           sw128_desc(sa(sl) + kk * 16 * 128, TILE, 1024));
      wgmma_bf16_ss_n64_bt(hacc, ad,
                           sw128_desc(sa(sh) + kk * 16 * 128, TILE, 1024));
    }
    wg_commit();
    if (h + 1 < h_hi) {
      load_head(h + 1, k + 1);
      stage(h + 1);
    }
    cp_commit();
    wg_wait_all();
    pin(hacc);
    // hacc[4j + 2r + e] is row u = r0 + 8r, column n = n0 + 8j + 2 t4 + e
    const int64_t v0 = (((int64_t)b * a.H + h) * a.nc + c) * a.QP;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = r0 + 8 * r;
      const float f = z == 0 ? expf(a.cum[v0 + u0 + u])
                             : expf(a.cum[v0 + a.QP - 1] - a.cum[v0 + u0 + u]) *
                                   a.dts[v0 + u0 + u];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const float w = hacc[i] * f;
          acc[i] += w;
          if (z == 0) s = fmaf(w, at(ct, u, 8 * j + 2 * t4 + e), s);
        }
      if (z == 0) {                  // I_t: over the 4 lanes t4
        s += __shfl_xor_sync(SSD_BWD_MASK, s, 1);
        s += __shfl_xor_sync(SSD_BWD_MASK, s, 2);
        if (t4 == 0)
          a.pI[(int64_t)nh * a.B * a.H * a.nc * a.QP + v0 + u0 + u] = s;
      }
    }
  }
  float* out = a.pbc + ((((int64_t)(z * a.HS + hs) * a.B + b) * a.nc + c) *
                            a.QP + u0) * bld + (int64_t)g * a.N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = r0 + 8 * r, n = n0 + 8 * j + 2 * t4 + e;
        if (n < a.N) out[(int64_t)u * bld + n] = acc[4 * j + 2 * r + e];
      }
}

// ---------------------------------------------------------------- 7 ----
// grid (nt * 2 * NH, nc * G, B), one warpgroup: the tile of chunk c,
// group g, z = 0 dC (rows t) or 1 dB (rows s), n in [64 nh, 64 nh + 64):
// acc[u][n] starts as the head terms (the slices' sum, pass 6), then over
// the K tiles (dC: s tiles <= ti; dB: t tiles >= si) dcb or dcb^T (A
// fragments split in registers, fetched a step ahead) times B_s or C_t
// (read MN-major; every tile of the K range lands at the start, each on
// its own mbarrier); dB and dC written in bfloat16.
__global__ void __launch_bounds__(128)
    dbc_bf16_kernel(const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c, BwdArgs a,
                    int bload) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* kt_ = align1024(smem_raw);        // [NTILE] B or C tiles
  const uint32_t bar0 = sa(kt_ + NTILE * TILE);   // [NTILE]
  const int tile = blockIdx.x % a.nt;
  const int z = (blockIdx.x / a.nt) % 2, nh = blockIdx.x / a.nt / 2;
  const int g = blockIdx.y % a.G, c = blockIdx.y / a.G, b = blockIdx.z;
  const int len = chunk_len(a, c);
  if (tile * T >= len) return;
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t bld = (int64_t)a.G * a.N;
  const int u0 = tile * T, n0 = T * nh;
  const int last = (len - 1) / T, lrows = len - last * T;
  const int k_lo = z == 0 ? 0 : tile, k_hi = z == 0 ? tile : last;
  const bf16* vs = bfp(z == 0 ? a.Bm : a.Cm) + ((int64_t)b * a.S + c0) * bld +
                   (int64_t)g * a.N + n0;
  const float* dcb0 = a.dcbp + (((int64_t)b * a.nc + c) * a.G + g) * a.QP *
                                   a.QP;
  if (tid == 0 && bload == LOAD_TMA) {
    for (int i = 0; i < NTILE; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_fence_init();
    for (int kt = k_lo; kt <= k_hi; ++kt) {
      mbar_expect_tx(bar0 + 8 * kt, TILE);
      tma_load_4d(sa(kt_ + kt * TILE), z == 0 ? &tm_b : &tm_c, bar0 + 8 * kt,
                  n0, g, (int)(c0 + kt * T), b);
    }
  }
  __syncthreads();                           // the barriers
  if (bload != LOAD_TMA)
    for (int kt = k_lo; kt <= k_hi; ++kt)
      land_tile(kt_ + kt * TILE, vs + (int64_t)(kt * T) * bld, bld,
                len - kt * T, a.N - n0, 1, bload, tid, 128);

  const int lane = tid & 31, wl = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;
  float acc[32];
  const float* part = a.pbc + (int64_t)z * a.HS * a.B * a.nc * a.QP * bld +
                      (((int64_t)b * a.nc + c) * a.QP + u0) * bld +
                      (int64_t)g * a.N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * t4 + e, u = r0 + 8 * r;
        acc[4 * j + 2 * r + e] = n < a.N ? part[(int64_t)u * bld + n] : 0.f;
      }
  // dcb's values of K tile kt for this thread's A fragments: k16 step kk,
  // register q (row u = r0 + 8 (q & 1), k at 16 kk + 2 t4 + 8 (q >> 1)
  // and the one after it): dC reads dcb[u][k] (rows t, as stored), dB
  // dcb[k][u] (rows s, transposed)
  float2 dv[4][4];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int u = u0 + r0 + 8 * (q & 1);
        const int k = kt * T + 16 * kk + 2 * t4 + 8 * (q >> 1);
        if (z == 0) {
          dv[kk][q] = __ldg((const float2*)(dcb0 + (int64_t)u * a.QP + k));
        } else {
          dv[kk][q].x = __ldg(dcb0 + (int64_t)k * a.QP + u);
          dv[kk][q].y = __ldg(dcb0 + (int64_t)(k + 1) * a.QP + u);
        }
      }
  };
  fetch(k_lo);
  cp_async_wait_all();
  if (bload == LOAD_TMA && last <= k_hi && lrows < T) {
    mbar_wait(bar0 + 8 * last, 0);  // the last tile's rows past the chunk
    zero_tail(kt_ + last * TILE, 1, lrows, tid, 128);
  }
  fence_async_smem();
  __syncthreads();
  for (int kt = k_lo; kt <= k_hi; ++kt) {
    if (bload == LOAD_TMA) mbar_wait(bar0 + 8 * kt, 0);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_bf16x2(dv[kk][q].x, dv[kk][q].y, ah[kk][q], al[kk][q]);
    if (kt < k_hi) fetch(kt + 1);
    const uint32_t kd = sa(kt_ + kt * TILE);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // B or C (k, n) read MN-major: 8 k rows 1,024 bytes apart
      const uint64_t d = sw128_desc(kd + kk * 16 * 128, TILE, 1024);
      wgmma_bf16_rs_n64(acc, al[kk], d);
      wgmma_bf16_rs_n64(acc, ah[kk], d);
    }
    wg_commit();
    wg_wait_all();
    pin(acc);
  }
  bf16* out = (bf16*)(z == 0 ? a.dC : a.dB) +
              ((int64_t)b * a.S + c0 + u0) * bld + (int64_t)g * a.N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * t4 + e, u = r0 + 8 * r;
        if (n < a.N && u0 + u < len)
          out[(int64_t)u * bld + n] =
              __float2bfloat16_rn(acc[4 * j + 2 * r + e]);
      }
}

// ------------------------------------------------------------ launch ----
// how x and dy land, and how B and C land (the slower route of the two)
int x_route(const BwdArgs& a) {
  const int x = route(a.x, a.P), y = route(a.dy, a.P);
  return x > y ? x : y;
}

int bc_route(const BwdArgs& a) {
  const int b = route(a.Bm, a.N), c = route(a.Cm, a.N);
  return b > c ? b : c;
}

size_t dstates_smem(int NH) {
  return (size_t)NTILE * (1 + NH) * TILE + 4 * QMAX + 8 * NTILE + 1024;
}
size_t dcb_smem() { return 4 * TILE + 4 * (6 * T + 4 * T + T) + 16 + 1024; }
size_t dx_smem(int NH) {
  return (size_t)(NTILE + 4 * NH) * TILE + 4 * (3 + NTILE) * QMAX +
         8 * (NTILE + 2) + 1024;
}
size_t heads_smem() { return 7 * TILE + 8 * 3 + 1024; }
size_t dbc_smem() { return (size_t)NTILE * TILE + 8 * NTILE + 1024; }

// the map of an (B, S, K, W) operand at p where `tma` (else zeros); false
// where it is refused
bool map_of(CUtensorMap* m, bool tma, const void* p, int W, int K,
            const BwdArgs& a) {
  memset(m, 0, sizeof(*m));
  return !tma || bf16_map_4d(m, p, W, K, a.S, a.B, T);
}

template <int NH>
int launch_dstates(const BwdArgs& a, cudaStream_t stream) {
  auto kern = dstates_bf16_kernel<NH>;
  const int e = raise_smem(kern, dstates_smem(NH));
  if (e != 0) return e;
  CUtensorMap ty, tc;
  const int xr = x_route(a), br = bc_route(a);
  if (!map_of(&ty, xr == LOAD_TMA, a.dy, a.P, a.H, a) ||
      !map_of(&tc, br == LOAD_TMA, a.Cm, a.N, a.G, a))
    return -2;
  kern<<<dim3(a.H * a.nc, a.B), 256, dstates_smem(NH), stream>>>(ty, tc, a,
                                                                 xr, br);
  return (int)cudaGetLastError();
}

int launch_dcb(const BwdArgs& a, cudaStream_t stream) {
  const int e = raise_smem(dcb_bf16_kernel, dcb_smem());
  if (e != 0) return e;
  CUtensorMap ty, tx;
  const int xr = x_route(a);
  if (!map_of(&ty, xr == LOAD_TMA, a.dy, a.P, a.H, a) ||
      !map_of(&tx, xr == LOAD_TMA, a.x, a.P, a.H, a))
    return -2;
  dcb_bf16_kernel<<<dim3(a.nt * (a.nt + 1) / 2 * a.HS, a.nc * a.G, a.B), 128,
                    dcb_smem(), stream>>>(ty, tx, a, xr);
  return (int)cudaGetLastError();
}

template <int NH>
int launch_dx(const BwdArgs& a, cudaStream_t stream) {
  auto kern = dx_bf16_kernel<NH>;
  const int e = raise_smem(kern, dx_smem(NH));
  if (e != 0) return e;
  CUtensorMap ty, tb;
  const int xr = x_route(a), br = bc_route(a);
  if (!map_of(&ty, xr == LOAD_TMA, a.dy, a.P, a.H, a) ||
      !map_of(&tb, br == LOAD_TMA, a.Bm, a.N, a.G, a))
    return -2;
  kern<<<dim3(a.H * a.nc, a.B), 256, dx_smem(NH), stream>>>(ty, tb, a, xr,
                                                            br);
  return (int)cudaGetLastError();
}

int launch_heads(const BwdArgs& a, cudaStream_t stream) {
  const int e = raise_smem(heads_bf16_kernel, heads_smem());
  if (e != 0) return e;
  CUtensorMap ty, tx, tc;
  const int xr = x_route(a), br = bc_route(a);
  if (!map_of(&ty, xr == LOAD_TMA, a.dy, a.P, a.H, a) ||
      !map_of(&tx, xr == LOAD_TMA, a.x, a.P, a.H, a) ||
      !map_of(&tc, br == LOAD_TMA, a.Cm, a.N, a.G, a))
    return -2;
  heads_bf16_kernel<<<dim3(a.nt * 2 * a.NH * a.HS, a.nc * a.G, a.B), 128,
                      heads_smem(), stream>>>(ty, tx, tc, a, xr, br);
  return (int)cudaGetLastError();
}

int launch_dbc(const BwdArgs& a, cudaStream_t stream) {
  const int e = raise_smem(dbc_bf16_kernel, dbc_smem());
  if (e != 0) return e;
  CUtensorMap tb, tc;
  const int br = bc_route(a);
  if (!map_of(&tb, br == LOAD_TMA, a.Bm, a.N, a.G, a) ||
      !map_of(&tc, br == LOAD_TMA, a.Cm, a.N, a.G, a))
    return -2;
  dbc_bf16_kernel<<<dim3(a.nt * 2 * a.NH, a.nc * a.G, a.B), 128, dbc_smem(),
                    stream>>>(tb, tc, a, br);
  return (int)cudaGetLastError();
}

}  // namespace

SSD_BWD_SHARED_PASSES

BWD_PASS(ssd_bwd_dstates) {
  BWD_ARGS
  return N > 64 ? launch_dstates<2>(a, stream) : launch_dstates<1>(a, stream);
}

BWD_PASS(ssd_bwd_dcb) {
  BWD_ARGS
  return launch_dcb(a, stream);
}

BWD_PASS(ssd_bwd_dx) {
  BWD_ARGS
  return N > 64 ? launch_dx<2>(a, stream) : launch_dx<1>(a, stream);
}

BWD_PASS(ssd_bwd_heads) {
  BWD_ARGS
  return launch_heads(a, stream);
}

BWD_PASS(ssd_bwd_dbc) {
  BWD_ARGS
  return launch_dbc(a, stream);
}

// The launch these tensors get, into out[8]: how x and dy land and how B
// and C land (0 TMA, 1 cp.async, 2 registers), N's column halves, and the
// shared memory bytes of a block of passes 1, 3, 4, 5 and 7.
extern "C" void ssd_bwd_bf16_shape(const void* x, const void* dy,
                                   const void* Bm, const void* Cm, int P,
                                   int N, int* out) {
  BwdArgs a{};
  a.x = x;
  a.dy = dy;
  a.Bm = Bm;
  a.Cm = Cm;
  a.P = P;
  a.N = N;
  const int NH = N > 64 ? 2 : 1;
  const int shape[8] = {x_route(a),          bc_route(a),
                        NH,                  (int)dstates_smem(NH),
                        (int)dcb_smem(),     (int)dx_smem(NH),
                        (int)heads_smem(),   (int)dbc_smem()};
  memcpy(out, shape, sizeof(shape));
}
