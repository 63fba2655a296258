// The Mamba2 SSD chunked scan on bfloat16 x, B and C, for Hopper (sm_90a):
// five passes whose products run on bf16 wgmma, the tiles kept bfloat16
// from device memory to the tensor cores.
//
// Replaces: repro/kernels/ssd.py:_kernel (Pallas, TPU), called through
// ssd_scan, for bfloat16 x, Bm and Cm (float32 ones take
// csrc/ssd_scan.cu). Same function, arguments and scratch as that
// library (csrc/ssd_common.cuh): dt in float32 or bfloat16, A float32,
// the state in float32, bfloat16 or none; y in bfloat16 rounded to
// nearest even, the final state and the scratch (dts, cum, cb on and
// below the diagonal, S_in per chunk) in float32, so that the backward
// (csrc/ssd_scan_bwd.cu) reads it unchanged.
//
// Bound: bytes. At mamba2-370m's serve prefill (B=4, S=2048, H=32, P=64,
// G=1, N=128, Q=256) the function moves 76.0 MB of bf16 x, y, B, C and dt
// and the float32 final state (0.0227 ms at 3.35 TB/s) for 13.17 GFLOP
// (0.0133 ms at the 989 TFLOP/s dense bf16 peak of an H100 SXM). This
// design's own floor is higher: its passes move their float32 scratch
// through device memory (S_in per chunk, 33.5 MB, written by pass 3, read
// and written by pass 4, read by pass 5; cb; dts and cum) and read x
// twice, 264 MB in all (0.079 ms), and it runs 26.1 GFLOP of bf16
// products (the second parts below): x3.5 the function's bound
// (chip_smoke.ssd_bf16_design).
//
// Arithmetic (kernels/ssd.py:ssd_scan_bf16 is a float64 model of it,
// error_bound's bfloat16 terms its bound). Every product is
// wgmma.mma_async m64n64k16 .f32.bf16.bf16, accumulated in float32; a
// product of two bfloat16 numbers is exact in float32.
// - Pass 2, C.B^T: one bf16 product per k16 step, both operands as they
//   are: exact products, float32 sums.
// - Pass 3, the chunk states sum_s (x_s w_s) (x) B_s with w_s =
//   exp(total - cum_s) dt_s in float32: B as it is; x_s w_s, a float32,
//   split into hi = bf16(v) and lo = bf16(v - hi), within 2^-16 |v|
//   (hopper.cuh:split_bf16x2): two bf16 products.
// - Pass 5, the chunk scan: the intra term's weights W = cb exp(cum_t -
//   cum_s) dt_s (float32, masked before the exp) split the same way
//   against x as it is, and the inter term's C_t as it is against the
//   float32 S_in split the same way: two bf16 products each.
// One bf16 part would move a term by up to 2^-8 of itself, the size of
// y's own bf16 rounding; two keep the state at float32 accuracy
// (2^-16 a product, within error_bound's terms).
//
// Design. The float32 library's five passes (its header says why each
// exists), passes 1 and 4 shared with it (csrc/ssd_common.cuh).
// - Layout: every bf16 tile is 64 rows in the 128-byte swizzle
//   (hopper.cuh: sw128), at most two column halves of 64 values. C and B
//   in pass 2, C and the split S_in in pass 5 are K-major (n contiguous);
//   x (s, p) in passes 3 and 5 and B (s, n) in pass 3 are read as B
//   operands with the transpose bit (MN-major), as they lie in memory: no
//   transposing, no staging, no split pass over bf16 data.
// - Loads: TMA (cp.async.bulk.tensor through a 4-D map (P, H, S, B) or
//   (N, G, S, B), tma.cuh) where P or N is at least 64, a multiple of 8
//   and the base 16-byte aligned; 16-byte cp.async to the same swizzled
//   addresses where the width is a multiple of 8 below 64 (hymba-1.5b's N
//   = 16); one value at a time through registers otherwise (P = 12, N =
//   20, offset views). TMA zero-fills past S and past P or N; rows of the
//   next chunk inside a chunk's last tile (Q % 64 != 0) are zeroed in
//   shared memory after they land, as the other routes zero-fill them
//   (csrc/bf16_tiles.cuh, shared with the backward).
// - Pass 2: one warpgroup per (b, chunk, group, lower tile), both tiles
//   whole (N <= 128: eight k16 steps at most).
// - Pass 3: per (b, h, chunk), two warpgroups, each half of the chunk's
//   s tiles (K) over all of N, M = p (P padded to 64). Every tile of the
//   chunk is requested at once, each 64-row tile on its own mbarrier; the
//   A fragments (x_s w_s, split) are formed in registers from the
//   swizzled x tile; warpgroup 1's sum reaches warpgroup 0 through shared
//   memory at the end.
// - Pass 5: per (b, h, chunk), two warpgroups that share out its t tiles
//   and then run apart, with no barrier across the block (the kernel's
//   own comment says how). x and the split S_in land once and stay; cb,
//   the intra term's float32 weights' source, is read from device memory
//   into registers a step ahead; y is written from the accumulators.
// Tried, and slower or no faster on an H100 (PERF.md, section 6):
// pass 5 as one block per (b, h, chunk, t tile) with the two warpgroups
// on halves of every step's K, S_in split in every block, cb staged
// through a 2- or 3-stage ring; the t tiles of a chunk in one block with
// both warpgroups in lockstep; each step's W formed in halves, one while
// the other's products run (it also spilled); pass 3 with a warpgroup
// for each n half, both forming every A fragment, tile i + 1's while
// tile i's products run.
// Shared memory a block (N > 64 / N <= 64): pass 2 33,800 / 17,416,
// pass 3 100,384 / 67,616, pass 5 102,448 / 69,680 (QMAX-sized, 1,024
// bytes of it to align the base); two blocks of 256 threads an SM in
// passes 3 and 5, at most 128 registers a thread.
//
// Interface: plain C, loaded with ctypes. Every pass takes the float32
// library's arguments (in_bf16 must be 1), launches on the given stream,
// does not synchronise, and returns cudaGetLastError() (or the error of
// raising the shared-memory limit); -1 for a shape it does not take, -2
// where a tensor map is refused. ssd_bf16_shape() reports the launch.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>
#include "hopper.cuh"
#include "bf16_tiles.cuh"
#include "ssd_common.cuh"
#include "tma.cuh"

#define BF16_LIB 1            // x, B and C in bfloat16 only

namespace {

constexpr int T = SSD_T;                // rows of a tile; the wgmma M
constexpr int TILE = T * 128;           // bytes of a 64-row column half
constexpr int NTILE = SSD_QMAX / T;     // tiles of a chunk, at most

// ---------------------------------------------------------------- 2 ----
// grid (tiles * nc * G, B), one warpgroup: CB tile (ti, si), si <= ti, of
// chunk c and group g, K = n over NH halves
template <int NH>
__global__ void __launch_bounds__(128)
    bmm_bf16_kernel(const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_b, SsdArgs a,
                    int load) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ct = align1024(smem_raw);
  uint8_t* bt = ct + NH * TILE;
  const uint32_t bar = sa(bt + NH * TILE);
  const int ntri = (a.QP / T) * (a.QP / T + 1) / 2;
  const int tile = blockIdx.x % ntri, rest = blockIdx.x / ntri;
  const int g = rest % a.G, c = rest / a.G, b = blockIdx.y;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int si = tile - ti * (ti + 1) / 2;
  const int len = chunk_len(a, c);
  if (ti * T >= len) return;                 // past the chunk: never read
  const int tid = threadIdx.x;
  const int64_t ld = (int64_t)a.G * a.N;
  const int64_t c0 = (int64_t)c * a.Q;
  const int c_rows = min(T, len - ti * T), b_rows = min(T, len - si * T);
  if (load == LOAD_TMA) {
    if (tid == 0) {
      mbar_init(bar, 1);
      mbar_fence_init();
      mbar_expect_tx(bar, 2 * NH * TILE);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        tma_load_4d(sa(ct + h * TILE), &tm_c, bar, 64 * h, g,
                    (int)(c0 + ti * T), b);
        tma_load_4d(sa(bt + h * TILE), &tm_b, bar, 64 * h, g,
                    (int)(c0 + si * T), b);
      }
    }
    __syncthreads();                         // the barrier is initialised
    mbar_wait(bar, 0);
    if (c_rows < T) zero_tail(ct, NH, c_rows, tid, 128);
    if (b_rows < T) zero_tail(bt, NH, b_rows, tid, 128);
  } else {
    const int64_t o = ((int64_t)b * a.S + c0) * ld + (int64_t)g * a.N;
    land_tile(ct, (const bf16*)a.Cm + o + ti * T * ld, ld, c_rows, a.N, NH,
              load, tid, 128);
    land_tile(bt, (const bf16*)a.Bm + o + si * T * ld, ld, b_rows, a.N, NH,
              load, tid, 128);
    cp_async_wait_all();
  }
  fence_async_smem();
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int ks = (a.N + 15) / 16;
  pin(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NH; ++kk) {
    if (kk >= ks) break;
    const uint32_t o = (kk / 4) * TILE + (kk % 4) * 32;
    wgmma_bf16_ss_n64(acc, sw128_desc(sa(ct) + o, 16, 1024),
                      sw128_desc(sa(bt) + o, 16, 1024));
  }
  wg_commit();
  wg_wait_all();
  pin(acc);

  const int lane = tid & 31, wl = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  float* out = a.cb + (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP +
               (int64_t)(ti * T) * a.QP + si * T;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * wl + g8 + 8 * r, col = 8 * j + 2 * t4;
      *(float2*)(out + (int64_t)row * a.QP + col) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

// ---------------------------------------------------------------- 3 ----
// grid (H * nc, B), two warpgroups, each half of the chunk's s tiles (K)
// over all of N: upd_c (P x N) = sum_s (x_s w_s)^T B_s, M = p, N = n
// (NH halves, one wgmma), K = s; the A fragments x_s w_s split in
// registers, B_s read with the transpose bit. The warpgroups run apart
// until the end, when warpgroup 1's sum goes through shared memory to
// warpgroup 0, which adds it to its own and stores the states.
template <int NH>
__global__ void __launch_bounds__(256, 2)
    chunk_state_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_b,
                            SsdArgs a, int xload, int bload) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xt = align1024(smem_raw);             // [NTILE] x tiles
  uint8_t* btl = xt + NTILE * TILE;               // [NTILE][NH] B tiles
  float* wv = (float*)(btl + NTILE * NH * TILE);  // [QMAX] decay * dt
  const uint32_t bar0 = sa(wv + SSD_QMAX);        // [NTILE] barriers
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  const int nt = (len + T - 1) / T;
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const bool tma = xload == LOAD_TMA || bload == LOAD_TMA;
  if (tid == 0 && tma) {
    for (int i = 0; i < nt; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_fence_init();
    const uint32_t bytes =
        (xload == LOAD_TMA ? TILE : 0) + (bload == LOAD_TMA ? NH * TILE : 0);
    for (int i = 0; i < nt; ++i) {
      const uint32_t bar = bar0 + 8 * i;
      const int row = (int)(c0 + i * T);
      mbar_expect_tx(bar, bytes);
      if (xload == LOAD_TMA)
        tma_load_4d(sa(xt + i * TILE), &tm_x, bar, 0, h, row, b);
      if (bload == LOAD_TMA)
        for (int k = 0; k < NH; ++k)
          tma_load_4d(sa(btl + (i * NH + k) * TILE), &tm_b, bar, 64 * k, g,
                      row, b);
    }
  }
  const int64_t v0 = (((int64_t)b * a.H + h) * a.nc + c) * a.QP;
  const float total = a.cum[v0 + a.QP - 1];
  for (int i = tid; i < a.QP; i += 256)
    wv[i] = expf(total - a.cum[v0 + i]) * a.dts[v0 + i];
  const bf16* xs = (const bf16*)a.x + ((int64_t)b * a.S + c0) * xld +
                   (int64_t)h * a.P;
  const bf16* bs = (const bf16*)a.Bm + ((int64_t)b * a.S + c0) * bld +
                   (int64_t)g * a.N;
  for (int i = 0; i < nt; ++i) {
    if (xload != LOAD_TMA)
      land_tile(xt + i * TILE, xs + i * T * xld, xld, len - i * T, a.P, 1,
                xload, tid, 256);
    if (bload != LOAD_TMA)
      land_tile(btl + i * NH * TILE, bs + i * T * bld, bld, len - i * T,
                a.N, NH, bload, tid, 256);
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();                   // wv, the barriers, the other routes

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
        if (xload == LOAD_TMA) zero_tail(xt + i * TILE, 1, rows_ok, tw, 128);
        if (bload == LOAD_TMA)
          zero_tail(btl + i * NH * TILE, NH, rows_ok, tw, 128);
        fence_async_smem();
        named_sync(1 + wg, 128);
      }
    }
    // A fragment of k16 step kk, register q: row p0 + 8 (q & 1), k = s
    // at 16 kk + 2 t4 + 8 (q >> 1) and the one after it
    const uint8_t* x = xt + i * TILE;
    const float* w = wv + i * T;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + 8 * (q & 1), s = 16 * kk + 2 * t4 + 8 * (q >> 1);
        split_bf16x2(at(x, s, p) * w[s], at(x, s + 1, p) * w[s + 1],
                     ah[kk][q], al[kk][q]);
      }
    // B (s, n) read MN-major: 8 s rows 1,024 bytes apart, the n halves
    // 64 rows of 128 bytes apart
    const uint32_t bt = sa(btl + i * NH * TILE);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = sw128_desc(bt + kk * 16 * 128, TILE, 1024);
      wgmma_bf16_rs<64 * NH>(acc, al[kk], bd);
      wgmma_bf16_rs<64 * NH>(acc, ah[kk], bd);
    }
    wg_commit();
    wg_wait_all();
    pin(acc);
  }

  // warpgroup 1's sum to warpgroup 0 through the x tiles' memory, each
  // thread's values at [i][tw] (no bank conflicts)
  __syncthreads();                   // every product is done
  float* red = (float*)xt;
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
  // acc[4j + 2r + e] is upd[p0 + 8r][8j + 2 t4 + e]
  float* out = a.states + (((int64_t)b * a.H + h) * a.nc + c) * a.P * a.N;
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

// ---------------------------------------------------------------- 5 ----
// grid (H * nc, B), two warpgroups: y for one (b, h, chunk). The t tiles
// are shared out from the last (the heaviest) in the order 0, 1, 1, 0
// (4 tiles: warpgroup 0 takes 3 and 0, warpgroup 1 takes 2 and 1, five
// products each), and each warpgroup runs its own on its own: after the
// start there is no barrier across the block.
// - x: every s tile of the chunk lands once, at the start, and stays.
// - S_in (float32) is read once, split into hi and lo bf16 tiles, K-major
//   (p rows of n), and stays: the B operand of every inter term.
// - A t tile: the inter term C_t S_in^T (C_t, t rows of n, by TMA into
//   the warpgroup's buffer while its t tile before runs), times
//   exp(cum_t); then the s tiles 0 .. tt: W x_s, W formed in registers
//   from cb (float32, read from device memory into registers one step
//   ahead) as cb exp(cum_t - ref) (exp(ref - cum_s) dt_s) below the
//   diagonal, ref = cum at the s tile's last position, both factors at
//   most 1 (the column factors once per block in shared memory), and per
//   element on the diagonal, masked first; x_s read with the transpose
//   bit. y is written from the accumulators.
template <int NH>
__global__ void __launch_bounds__(256, 2)
    chunk_scan_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_c,
                           SsdArgs a, int xload, int cload) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xt = align1024(smem_raw);             // [NTILE] x tiles
  uint8_t* sh = xt + NTILE * TILE;               // S_in hi, NH halves
  uint8_t* sl = sh + NH * TILE;                  // S_in lo
  uint8_t* ctw = sl + NH * TILE;                 // [2] C_t, NH halves each
  float* cumv = (float*)(ctw + 2 * NH * TILE);   // [QMAX]
  float* dtv = cumv + SSD_QMAX;                  // [QMAX]
  float* colv = dtv + SSD_QMAX;                  // [QMAX] column factors
  const uint32_t xbar = sa(colv + SSD_QMAX);     // [NTILE], then C's [2]
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  const int ntl = (len + T - 1) / T;         // live tiles
  const int tid = threadIdx.x;
  // the warpgroup, warp-uniform as the compiler sees it (a branch on it
  // around wgmma would otherwise serialise every wgmma of the kernel)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), tw = tid & 127;
  const int lane = tw & 31, wl = tw >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;               // this thread's rows r0, r0 + 8
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, cld = (int64_t)a.G * a.N;
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  const bf16* xs = (const bf16*)a.x + ((int64_t)b * a.S + c0) * xld +
                   (int64_t)h * a.P;
  const bf16* cs = (const bf16*)a.Cm + ((int64_t)b * a.S + c0) * cld +
                   (int64_t)g * a.N;
  const float* cbs = a.cb + (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP;
  // S_in[0] is zero without an initial state: no inter term
  const bool inter = !(c == 0 && a.init == nullptr);
  uint8_t* ct = ctw + wg * NH * TILE;        // this warpgroup's C_t
  const uint32_t cbar = xbar + 8 * (NTILE + wg);
  // the j-th t tile from the last is warpgroup 0's where j % 4 is 0 or 3
  auto mine = [&](int tt) {
    const int j = (ntl - 1 - tt) & 3;
    return (j == 0 || j == 3) == (wg == 0);
  };
  auto next_mine = [&](int tt) {             // its next t tile below tt
    for (int u = tt - 1; u >= 0; --u)
      if (mine(u)) return u;
    return -1;
  };

  // C_t of t tile tt into this warpgroup's buffer: TMA on its barrier, or
  // the other routes by its threads (they wait before using it)
  auto load_c = [&](int tt) {
    if (cload == LOAD_TMA) {
      if (tw == 0) {
        mbar_expect_tx(cbar, NH * TILE);
        for (int q = 0; q < NH; ++q)
          tma_load_4d(sa(ct + q * TILE), &tm_c, cbar, 64 * q, g,
                      (int)(c0 + tt * T), b);
      }
    } else {
      land_tile(ct, cs + tt * T * cld, cld, len - tt * T, a.N, NH, cload, tw,
                128);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < NTILE + 2; ++i) mbar_init(xbar + 8 * i, 1);
    mbar_fence_init();
    if (xload == LOAD_TMA)
      for (int i = 0; i < ntl; ++i) {
        mbar_expect_tx(xbar + 8 * i, TILE);
        tma_load_4d(sa(xt + i * TILE), &tm_x, xbar + 8 * i, 0, h,
                    (int)(c0 + i * T), b);
      }
  }
  // S_in as hi and lo bf16 tiles (K-major, zeros past P and N), read
  // while the barriers are made
  if (inter) {
    const float* ss = a.states + bhc * a.P * a.N;
    constexpr int Q4 = 16 * NH;              // 4-value groups a row
    constexpr int PER = T * Q4 / 256;
    float4 sv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + 256 * k, p = i / Q4, n = 4 * (i % Q4);
      if (p < a.P && n + 3 < a.N && (a.N & 3) == 0) {
        sv[k] = __ldg((const float4*)(ss + p * a.N + n));
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = p < a.P && n + e < a.N ? ss[p * a.N + n + e] : 0.f;
        sv[k] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + 256 * k, p = i / Q4, n = 4 * (i % Q4);
      uint2 hi, lo;
      split_bf16x2(sv[k].x, sv[k].y, hi.x, lo.x);
      split_bf16x2(sv[k].z, sv[k].w, hi.y, lo.y);
      const uint32_t o = sw128(p, n, T);
      *(uint2*)(sh + o) = hi;
      *(uint2*)(sl + o) = lo;
    }
  }
  for (int i = tid; i < a.QP; i += 256) {
    const int64_t v = bhc * a.QP + i;
    const float cu = a.cum[v], d = a.dts[v];
    cumv[i] = cu;
    dtv[i] = d;
    colv[i] = expf(a.cum[bhc * a.QP + (i | (T - 1))] - cu) * d;
  }
  __syncthreads();                           // the barriers
  if (xload != LOAD_TMA)
    for (int i = 0; i < ntl; ++i)
      land_tile(xt + i * TILE, xs + i * T * xld, xld, len - i * T, a.P, 1,
                xload, tid, 256);
  else if (len - (ntl - 1) * T < T) {        // the last x tile's rows past
    mbar_wait(xbar + 8 * (ntl - 1), 0);      // the chunk: zero
    zero_tail(xt + (ntl - 1) * TILE, 1, len - (ntl - 1) * T, tid, 256);
  }
  int tt = ntl - 1;                          // this warpgroup's first t tile
  if (!mine(tt)) tt = next_mine(tt);
  if (inter && tt >= 0) load_c(tt);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();       // S_in's tiles, cumv, x and C_t by the other routes

  // cb's values of step (tt, s) for this thread's A fragments: k16 step
  // kk, register q (row r0 + 8 (q & 1), k = s at 16 kk + 2 t4 + 8 (q >> 1)
  // and the one after it) is pair [kk][q]
  float2 cbv[4][4];
  auto fetch = [&](int t1, int s) {
    const float* src = cbs + (int64_t)(t1 * T + r0) * a.QP + s * T;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cbv[kk][q] = __ldg((const float2*)(src + (q & 1) * 8 * a.QP +
                                           16 * kk + 2 * t4 + 8 * (q >> 1)));
  };
  if (tt >= 0) fetch(tt, 0);
  const int ks = (a.N + 15) / 16;            // the inter term's k16 steps
  uint32_t cphase = 0;
  for (; tt >= 0; tt = next_mine(tt)) {
    const int t0 = tt * T, nt1 = next_mine(tt);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (inter) {
      if (cload == LOAD_TMA) {
        mbar_wait(cbar, cphase);
        cphase ^= 1;
        if (len - t0 < T) {
          zero_tail(ct, NH, len - t0, tw, 128);
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
        const uint64_t cd = sw128_desc(sa(ct) + o, 16, 1024);
        wgmma_bf16_ss_n64(acc, cd, sw128_desc(sa(sl) + o, 16, 1024));
        wgmma_bf16_ss_n64(acc, cd, sw128_desc(sa(sh) + o, 16, 1024));
      }
      wg_commit();
      wg_wait_all();
      pin(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {          // the inter term, times exp(cum_t)
        const float e = expf(cumv[t0 + r0 + 8 * r]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j + 2 * r] *= e;
          acc[4 * j + 2 * r + 1] *= e;
        }
      }
      if (nt1 >= 0) {                        // the next C_t, in flight
        named_sync(1 + wg, 128);             // its buffer is free
        load_c(nt1);
      }
    }

    for (int s = 0; s <= tt; ++s) {
      if (xload == LOAD_TMA) mbar_wait(xbar + 8 * s, 0);
      // W from this step's cb values, then the next step's fetched
      const int s0 = s * T;
      uint32_t wh[4][4], wlo[4][4];
      if (s < tt) {
        const float ref = cumv[s0 + T - 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float rf = expf(cumv[t0 + r0 + 8 * r] - ref);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int sc = s0 + 16 * kk + 2 * t4 + 8 * h2;
              const float2 v = cbv[kk][r + 2 * h2];
              split_bf16x2(v.x * (rf * colv[sc]), v.y * (rf * colv[sc + 1]),
                           wh[kk][r + 2 * h2], wlo[kk][r + 2 * h2]);
            }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = t0 + r0 + 8 * r;
          const float ct_ = cumv[t];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int sp = s0 + 16 * kk + 2 * t4 + 8 * h2;
              const float2 v = cbv[kk][r + 2 * h2];
              // mask before the exp: s > t may overflow
              const float w0 =
                  sp <= t ? v.x * (expf(ct_ - cumv[sp]) * dtv[sp]) : 0.f;
              const float w1 =
                  sp + 1 <= t ? v.y * (expf(ct_ - cumv[sp + 1]) * dtv[sp + 1])
                              : 0.f;
              split_bf16x2(w0, w1, wh[kk][r + 2 * h2], wlo[kk][r + 2 * h2]);
            }
        }
      }
      if (s < tt) fetch(tt, s + 1);
      else if (nt1 >= 0) fetch(nt1, 0);
      const uint32_t xa = sa(xt + s * TILE);
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // x (s, p) read MN-major: 8 s rows 1,024 bytes apart
        const uint64_t xd = sw128_desc(xa + kk * 16 * 128, TILE, 1024);
        wgmma_bf16_rs_n64(acc, wlo[kk], xd);
        wgmma_bf16_rs_n64(acc, wh[kk], xd);
      }
      wg_commit();
      wg_wait_all();
      pin(acc);
    }

    // y from the accumulators: acc[4j + 2r + e] is row t0 + r0 + 8r,
    // column 8j + 2 t4 + e, written in bfloat16
    bf16* yt =
        (bf16*)a.y + ((int64_t)b * a.S + c0 + t0) * xld + (int64_t)h * a.P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (t0 + row >= len) continue;
      bf16* yr = yt + row * xld;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * t4;
        const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (a.vec) {
          if (p < a.P) *(__nv_bfloat162*)(yr + p) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (p < a.P) yr[p] = __float2bfloat16_rn(v0);
          if (p + 1 < a.P) yr[p + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
    if (inter && nt1 >= 0 && cload != LOAD_TMA) {  // the next C_t landed
      cp_async_wait_all();
      fence_async_smem();
      named_sync(1 + wg, 128);
    }
  }
}

// ------------------------------------------------------------ launch ----
int x_route(const SsdArgs& a) { return route(a.x, a.P); }

int bc_route(const SsdArgs& a) {
  const int b = route(a.Bm, a.N), c = route(a.Cm, a.N);
  return b > c ? b : c;
}

size_t bmm_smem(int NH) { return 2 * NH * TILE + 8 + 1024; }
size_t chunk_state_smem(int NH) {
  return (size_t)NTILE * (1 + NH) * TILE + 4 * SSD_QMAX + 8 * NTILE + 1024;
}
size_t chunk_scan_smem(int NH) {
  return (size_t)(NTILE + 4 * NH) * TILE + 4 * 3 * SSD_QMAX +
         8 * (NTILE + 2) + 1024;
}

// the map of x and that of `bc` (B or C) where their route is TMA (else
// left zero); false where one is refused
bool maps(const SsdArgs& a, CUtensorMap* tx, const void* bc,
          CUtensorMap* tbc) {
  memset(tx, 0, sizeof(*tx));
  memset(tbc, 0, sizeof(*tbc));
  if (x_route(a) == LOAD_TMA && !bf16_map_4d(tx, a.x, a.P, a.H, a.S, a.B, T))
    return false;
  return bc_route(a) != LOAD_TMA ||
         bf16_map_4d(tbc, bc, a.N, a.G, a.S, a.B, T);
}

template <int NH>
int bmm(const SsdArgs& a, cudaStream_t stream) {
  auto kern = bmm_bf16_kernel<NH>;
  const int e = raise_smem(kern, bmm_smem(NH));
  if (e != 0) return e;
  CUtensorMap tc, tb;
  memset(&tc, 0, sizeof(tc));
  memset(&tb, 0, sizeof(tb));
  if (bc_route(a) == LOAD_TMA &&
      !(bf16_map_4d(&tc, a.Cm, a.N, a.G, a.S, a.B, T) &&
        bf16_map_4d(&tb, a.Bm, a.N, a.G, a.S, a.B, T)))
    return -2;
  const int nt = a.QP / T;
  kern<<<dim3(nt * (nt + 1) / 2 * a.nc * a.G, a.B), 128, bmm_smem(NH),
         stream>>>(tc, tb, a, bc_route(a));
  return (int)cudaGetLastError();
}

template <int NH>
int chunk_state(const SsdArgs& a, cudaStream_t stream) {
  auto kern = chunk_state_bf16_kernel<NH>;
  const int e = raise_smem(kern, chunk_state_smem(NH));
  if (e != 0) return e;
  CUtensorMap tx, tb;
  if (!maps(a, &tx, a.Bm, &tb)) return -2;
  kern<<<dim3(a.H * a.nc, a.B), 256, chunk_state_smem(NH), stream>>>(
      tx, tb, a, x_route(a), bc_route(a));
  return (int)cudaGetLastError();
}

template <int NH>
int chunk_scan(const SsdArgs& a, cudaStream_t stream) {
  auto kern = chunk_scan_bf16_kernel<NH>;
  const int e = raise_smem(kern, chunk_scan_smem(NH));
  if (e != 0) return e;
  CUtensorMap tx, tc;
  if (!maps(a, &tx, a.Cm, &tc)) return -2;
  kern<<<dim3(a.H * a.nc, a.B), 256, chunk_scan_smem(NH), stream>>>(
      tx, tc, a, x_route(a), bc_route(a));
  return (int)cudaGetLastError();
}

}  // namespace

SSD_SHARED_PASSES

SSD_PASS(ssd_bmm) {
  SSD_ARGS
  return N > 64 ? bmm<2>(a, stream) : bmm<1>(a, stream);
}

SSD_PASS(ssd_chunk_state) {
  SSD_ARGS
  return N > 64 ? chunk_state<2>(a, stream) : chunk_state<1>(a, stream);
}

SSD_PASS(ssd_chunk_scan) {
  SSD_ARGS
  return N > 64 ? chunk_scan<2>(a, stream) : chunk_scan<1>(a, stream);
}

// The launch these tensors get, into out[6]: how x lands and how B and C
// land (0 TMA, 1 cp.async, 2 registers), N's column halves, and the
// shared memory bytes of a block of passes 2, 3 and 5.
extern "C" void ssd_bf16_shape(const void* x, const void* Bm, const void* Cm,
                               int P, int N, int* out) {
  SsdArgs a{};
  a.x = x;
  a.Bm = Bm;
  a.Cm = Cm;
  a.P = P;
  a.N = N;
  const int NH = N > 64 ? 2 : 1;
  const int shape[6] = {x_route(a), bc_route(a), NH, (int)bmm_smem(NH),
                        (int)chunk_state_smem(NH), (int)chunk_scan_smem(NH)};
  memcpy(out, shape, sizeof(shape));
}
