// The gradient of the Mamba2 SSD chunked scan (K4's backward) on the
// tensor cores (wgmma, 3xTF32), for Hopper (sm_90a), in nine passes, on
// float32 x, B, C and dy (bfloat16 ones take csrc/ssd_scan_bwd_bf16.cu).
//
// Replaces: XLA's gradient of repro/models/ssd.py:ssd_scan (the reference
// trains through autodiff of its jnp scan; it has no Pallas backward).
// Given the forward's scratch (csrc/ssd_scan.cu: dts and cum per chunk,
// cb = C.B^T in its lower 64 x 64 tiles, S_in per chunk), dy (B,S,H,P)
// and d(final state) or none, it writes dx, ddt, dA, dB, dC and
// d(init_state), float32 (d(init_state) in the state's dtype). Within
// chunk c of head h (group g), with L[t,s] = exp(cum_t - cum_s) for
// s <= t (masked BEFORE the exp: s > t may overflow, and inf * 0 is NaN),
// D[t,s] = dy_t . x_s, M = cb L dt_s D and G_c the gradient of the state
// leaving chunk c:
//   dstates_c = sum_t exp(cum_t) dy_t (x) C_t
//   G_{nc-1} = d(final), G_{c-1} = exp(total_c) G_c + dstates_c,
//   d(init) = G_{-1}
//   dx_s  = dt_s (sum_{t>=s} cb L dy_t + exp(total - cum_s) G_c B_s)
//   dcb   = sum over the group's heads of L dt_s D   (s <= t)
//   dC_t  = sum_{s<=t} dcb B_s + sum_h exp(cum_t) dy_t S_in
//   dB_s  = sum_{t>=s} dcb C_t + sum_h exp(total - cum_s) dt_s x_s G_c
//   dcum_t = sum_{s<t} M[t,s] - sum_{s>t} M[s,t] + I_t - K_t
//            (+ sum_s K_s + exp(total) <G_c, S_in> at the chunk's last
//            slot, total), I_t = dy_t . exp(cum_t) S_in C_t, K_s =
//            exp(total - cum_s) dt_s x_s . G_c B_s
//   dla = the reverse cumsum of dcum; ddt = ddts + A dla with ddts_s =
//   x_s . dx_s / dt_s (formed without the division); dA = sum dt dla.
// kernels/ssd.py:ssd_scan_bwd_ref is the same function in PyTorch, pass
// by pass, and bwd_error_bound states how far this may lie from it.
//
// Bound: operations. At mamba2-370m's training shape (B=4, S=2048, H=32,
// P=64, G=1, N=128, Q=256) the products the gradient needs are, per
// (b, chunk), 2 FLOPs a MAC: the causal half of D = dy . x and of dx's
// intra term per head (P Q(Q+1)/2 MACs each), dstates, dC's inter term,
// dB's state term and dx's state term per head (Q P N each), and the
// causal half of dcb times B and times C per group (N Q(Q+1)/2 each):
// 26.3 GFLOP (chip_smoke.ssd_bwd_work). At 3xTF32 (three TF32 products
// for each float32 one, 495 TFLOP/s dense on an H100 SXM) that is 0.160
// ms, above the 220 MB it must move (0.066 ms at 3.35 TB/s): bound by
// operations.
//
// Design. The passes of the Mamba2 authors' GPU backward (dstates, the
// state passing backward, the chunk scan's and the chunk state's
// gradients, the cumsum's reverse), each product on the tensor cores:
//   1. dstates: per (b, h, chunk, 64 of N), dstates^T (n x p) = C^T .
//      (exp(cum) dy), K = t in steps of KT through a 2-stage ring: the
//      forward's chunk state pass with C for B and exp(cum_t) dy_t for
//      its decayed x.
//   2. state_passing: G_c over the chunks in reverse, elementwise, written
//      over dstates in place, the loads of CG chunks in flight together;
//      d(init); per block the partial exp(total) <G_c, S_in>.
//   3. dcb: per (b, chunk, group, tile pair t >= s, head slice): for each
//      head of the slice D = dy_t . x_s^T (K = p), dcb's partial sum
//      over the slice's heads in registers, each head's row and column
//      sums of M (rs, cs). The next head's tiles load while this one's
//      products run. Below the diagonal L dt_s = exp(cum_t - ref)
//      (exp(ref - cum_s) dt_s), ref = cum at the s tile's last position,
//      both factors at most 1, the column factors once per head in
//      shared memory; on the diagonal per element, masked first.
//   4. dx: per (b, h, chunk, s tile), the chunk scan pass transposed:
//      the state term B_s . G_c^T (K = n, skipped where G_c is zero: the
//      last chunk without a d(final)), then exp(total - cum_s) and K_s;
//      then the intra term over the t tiles >= s, W^T . dy with W = cb L
//      formed in registers from the staged cb tile (K = t); dx = dt_s
//      times their sum, ddts = x . that. One stage of staging, the next
//      step's tiles in flight with this step's products: 72 KB, three
//      blocks an SM (a 2-stage ring held it to two and ran slower).
//   5. heads: per (b, chunk, group, 64-row tile, dC or dB, 64 of N, head
//      slice), each head's term of dC (dy_t . S_in, scaled by exp(cum_t),
//      and I_t's share of this N) or dB (x_s . G_c, by exp(total -
//      cum_s) dt_s; skipped where G_c is zero), K = p, summed over the
//      slice's heads in registers into a float32 partial (pbc). Computed
//      transposed (n x rows), so that S_in and G_c, staged as they are
//      stored (p rows of n), are the register operand; the column
//      factors once per head in shared memory.
//   6. sum: the head slices' partials of dcb and of the head terms added
//      in slice order into slice 0 (elementwise; none for one slice).
//   7. dbc: per (b, chunk, group, tile, dC or dB, 64 of N): the head
//      terms, then the intra term dcb . B (dC, K = s <= t) or dcb^T . C
//      (dB, K = t >= s); dB and dC written in their dtype.
//   8. ddt: per (b, h, chunk): dcum from the partial sums (rs over the s
//      tiles in order, cs over the live t tiles in order, I over the N
//      halves, K, and at the last slot sum K + the ep shares), its
//      reverse cumsum dla, ddt = ddts + A dla, each chunk's share of dA.
//   9. dA: per head, the (b, chunk) shares in order.
// Head slices. Passes 3 and 5 spread a group's R heads over HS = min(R,
// 4) slices of about R/HS heads each (a grid axis), instead of one block
// looping over all R: at hymba-1.5b's B = 1 that turns 80 and 64 blocks
// into 320 and 256. Each slice writes float32 partials, dcb's
// (HS,B,nc,G,QP,QP) and the per-head terms' (2,HS,B,nc,QP,G,N), 34 MB
// each at mamba2-370m's shape; pass 6 adds them in slice order. No
// atomics: every sum over heads, slices, tiles, lanes or chunks runs in
// a fixed order, so every launch gives the same bits.
// Products. Every one is wgmma.mma_async m64n64k8 .tf32, one warpgroup
// (128 threads) a block. A float32 operand x is split into big =
// tf32(x) and small = tf32(x - big) (split_bits) and a product is
// small*big + big*small + big*big, accumulated in float32.
// kernels/ssd.py:ssd_scan_bwd_ref(..., passes=3) is a float64 model of
// these products.
// Layouts. tf32 wgmma reads shared operands K-major only, as 8 x 4-word
// core matrices without swizzle (hopper.cuh, csrc/ssd_tiles.cuh). The
// operand that is K-major as stored is split as it stands (split_rows);
// the other is transposed as it is split (split_cols) or read from the
// staging into registers as the A fragment, which takes any order.
// Staged rows are 68 floats apart where lanes read them a row per lane
// group (split_rows' sources, the A fragments of B and dy), 72 where
// lanes read a column per lane group (the A fragments of cb, C, S_in, G):
// no bank conflicts either way.
// Tried and slower on an H100 (PERF.md, section 6, PR 26): two
// warpgroups a block in dx, each on half of every step's K as in the
// forward's chunk scan (capped at 128 registers for two blocks an SM, it
// spilled); dx's decays taken once per block below the diagonal instead
// of per element. Not taken: dstates fused into the state passing would
// leave B H blocks (25 at hymba-1.5b's B = 1) to walk the chunks in
// order; ddt fused into dx needs dcum at every later position of the
// chunk, which other blocks write.
// Shared memory per block (bytes) and registers a thread (ptxas -v, nvcc
// 12.8, sm_90a), no spills:
//       pass        dstates   dcb       dx        heads     dbc
//       smem        54,272    103,168   71,680    88,352    68,608
//       registers   168       204       156       216       149
// and 108 (state passing), 32 (sum, ddt), 30 (dA) registers. Passes 2, 6,
// 8 and 9 run no products and are csrc/ssd_bwd_common.cuh's, shared with
// the bfloat16 library.
//
// Interface: plain C, loaded with ctypes. Every pass takes the same
// arguments (csrc/ssd_bwd_common.cuh: BWD_ARGS; in_bf16 must be 0),
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit);
// -1 for a shape it does not take.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"
#include "ssd_tiles.cuh"

#define BWD_BF16_LIB 0        // x, B, C and dy in float32 only
#include "ssd_bwd_common.cuh"

#define T 64                  // rows of a t or s tile; the wgmma M and N
#define PMAX 64               // head dim P, zero-padded
#define QMAX 256              // chunk length Q
#define NT 128                // one warpgroup a block (passes 1, 3-6)
#define KT 32                 // positions per step of pass 1
#define SPA (T + 4)           // staged row read a row per lane group
#define SPT (T + 8)           // staged row read a column per lane group

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one k step of acc (m64n64) += A . B^T, A's fragment in registers (ab,
// as) and B split at sb (big, then small W words on): small*big,
// big*small, big*big
__device__ __forceinline__ void step_rs(float (&acc)[32],
                                        const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const uint32_t* sb, int W) {
  const uint64_t bb = smem_desc(sb, (T / 8) * 128, 128);
  wgmma_rs_n64(acc, as, bb);
  wgmma_rs_n64(acc, ab, smem_desc(sb + W, (T / 8) * 128, 128));
  wgmma_rs_n64(acc, ab, bb);
}

// the A fragment of the k step starting at k0 from a staged tile:
// element (row, k) at st[row * RS + k * KS], rows r0 and r0 + 8, k = k0 +
// t4 and k0 + t4 + 4, split into big and small
template <int RS, int KS>
__device__ __forceinline__ void frag(const float* st, int r0, int k0, int t4,
                                     uint32_t (&ab)[4], uint32_t (&as)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    split_bits(st[(r0 + 8 * (q & 1)) * RS + (k0 + t4 + 4 * (q >> 1)) * KS],
               ab[q], as[q]);
}

// ---------------------------------------------------------------- 1 ----
// grid (H * nc, B, NH): dstates^T rows n in [64 nh, 64 nh + 64) (M), p
// (N), K = t in steps of KT. C is the register operand (rows n, read from
// the staged chunk as it stands), exp(cum_t) dy_t the shared one, scaled
// and transposed as it is split.
__global__ void __launch_bounds__(NT) ssd_bwd_dstates_kernel(BwdArgs a) {
  extern __shared__ __align__(128) uint32_t smem[];
  constexpr int XS = KT * SPT, STAGE = 2 * XS, W = PMAX * KT;
  uint32_t* sp = smem;                                  // dy' split (p, t)
  float* stage = (float*)(sp + 2 * W);                  // [2][dy, C]
  float* ev = stage + 2 * STAGE;                        // [QP] exp(cum)
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int nh = blockIdx.z, g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const float* ys = (const float*)a.dy + ((int64_t)b * a.S + c0) * xld +
                 (int64_t)h * a.P;
  const float* cs = (const float*)a.Cm + ((int64_t)b * a.S + c0) * bld +
                 (int64_t)g * a.N + T * nh;
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  for (int i = threadIdx.x; i < a.QP; i += NT)
    ev[i] = expf(a.cum[bhc * a.QP + i]);
  const int steps = (len + KT - 1) / KT;
  auto load = [&](int it, float* st) {
    const int t0 = it * KT;
    load_tile<NT, KT, PMAX, SPT>(st, ys + t0 * xld, xld, len - t0, a.P, a.vx);
    load_tile<NT, KT, T, SPT>(st + XS, cs + t0 * bld, bld, len - t0,
                              a.N - T * nh, a.vbc);
  };

  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;              // this thread's rows n: r0, r0 + 8
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  load(0, stage);
  cp_commit();
  if (steps > 1) load(1, stage + STAGE);
  cp_commit();
  for (int it = 0; it < steps; ++it) {
    float* st = stage + (it & 1) * STAGE;
    cp_wait_all_but_one();
    __syncthreads();
    split_cols<NT, PMAX, KT, SPT, false, true>(st, sp, ev + it * KT);
    fence_async_smem();
    __syncthreads();
    // element (n, t) of C^T is st[XS + t * SPT + n]
    uint32_t ab[KT / 8][4], as[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
      frag<1, SPT>(st + XS, r0, 8 * j, t4, ab[j], as[j]);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
      step_rs(acc, ab[j], as[j], sp + 2 * j * (PMAX / 8) * 32, W);
    wg_commit();
    __syncthreads();                  // every read of stage it & 1 is done
    if (it + 2 < steps) load(it + 2, st);
    cp_commit();
    wg_wait_all();
    pin(acc);
  }

  // acc[4j + 2r + e] is dstates[p = 8j + 2 t4 + e][n = 64 nh + r0 + 8r]
  float* out = a.dst + bhc * a.P * a.N;
#pragma unroll
  for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 8 * j + 2 * t4 + e, n = T * nh + r0 + 8 * r;
        if (p < a.P && n < a.N) out[p * a.N + n] = acc[4 * j + 2 * r + e];
      }
}

// ---------------------------------------------------------------- 3 ----
// grid (ntri * HS, nc * G, B): the tile pair (ti, si), si <= ti, of chunk
// c and group g, heads of slice hs. Per head: D (t x s) = dy_t . x_s^T
// (K = p, both split as they stand), then dcb += L dt_s D, and M = cb L
// dt_s D summed along each row (s < t) into rs[si] and each column
// (t > s) into cs[ti]. A thread's accumulator rows t = r0, r0 + 8,
// columns s = 8j + 2 t4 + e.
__global__ void __launch_bounds__(NT) ssd_bwd_dcb_kernel(BwdArgs a) {
  constexpr int SPL = 2, W = T * PMAX;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* ay = smem;                       // dy split (t, p)
  uint32_t* bx = ay + SPL * W;               // x split (s, p)
  float* sdy = (float*)(bx + SPL * W);       // [T][SPA] dy rows t
  float* sx = sdy + T * SPA;                 // [T][SPA] x rows s
  float* vt = sx + T * SPA;                  // [2][cum_t, cum_s, dt_s][T]
  float* red = vt + 6 * T;                   // [4][T] column sums by warp
  float* cf = red + 4 * T;                   // [T] exp(ref - cum_s) dt_s
  const int ntri = a.nt * (a.nt + 1) / 2;
  const int tile = blockIdx.x % ntri, hs = blockIdx.x / ntri;
  const int g = blockIdx.y % a.G, c = blockIdx.y / a.G, b = blockIdx.z;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int si = tile - ti * (ti + 1) / 2;
  const int len = chunk_len(a, c);
  if (ti * T >= len) return;                 // past the chunk: never read
  const int h_lo = slice_head(a, g, hs), h_hi = slice_head(a, g, hs + 1);
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P;
  const int64_t cbo = (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP +
                      (int64_t)(ti * T) * a.QP + si * T;
  const float* dys = (const float*)a.dy + ((int64_t)b * a.S + c0 + ti * T) * xld;
  const float* xs = (const float*)a.x + ((int64_t)b * a.S + c0 + si * T) * xld;
  auto issue = [&](int h, float* v) {
    load_tile<NT, T, PMAX, SPA>(sdy, dys + (int64_t)h * a.P, xld,
                                len - ti * T, a.P, a.vx);
    load_tile<NT, T, PMAX, SPA>(sx, xs + (int64_t)h * a.P, xld, len - si * T,
                                a.P, a.vx);
    const float* cu = a.cum + (((int64_t)b * a.H + h) * a.nc + c) * a.QP;
    const float* dd = a.dts + (((int64_t)b * a.H + h) * a.nc + c) * a.QP;
    for (int i = threadIdx.x; i < 3 * T; i += NT) {
      const float* src = i < T ? cu + ti * T + i
                               : i < 2 * T ? cu + si * T + i - T
                                           : dd + si * T + i - 2 * T;
      cp_async4(v + i, src, 4);
    }
  };

  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;
  issue(h_lo, vt);
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
    cp_wait_all();
    __syncthreads();                  // head h's tiles are in; red is read
    const float* v = vt + (k & 1) * 3 * T;
    const float ref = v[2 * T - 1];   // cum at the s tile's last position
    if (ti > si && threadIdx.x < T)
      cf[threadIdx.x] = expf(ref - v[T + threadIdx.x]) * v[2 * T + threadIdx.x];
    split_rows<NT, T, PMAX, SPA>(sdy, ay);
    split_rows<NT, T, PMAX, SPA>(sx, bx);
    fence_async_smem();
    __syncthreads();                  // splits ready; the staging is free
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    pin(d);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < PMAX / 8; ++kk) {
      const int o = 2 * kk * (T / 8) * 32;
      const uint64_t ab = smem_desc(ay + o, (T / 8) * 128, 128);
      const uint64_t bb = smem_desc(bx + o, (T / 8) * 128, 128);
      wgmma_ss_n64(d, smem_desc(ay + W + o, (T / 8) * 128, 128), bb);
      wgmma_ss_n64(d, ab, smem_desc(bx + W + o, (T / 8) * 128, 128));
      wgmma_ss_n64(d, ab, bb);
    }
    wg_commit();
    if (h + 1 < h_hi) issue(h + 1, vt + ((k + 1) & 1) * 3 * T);
    cp_commit();
    wg_wait_all();
    pin(d);

    // L dt_s: below the diagonal exp(cum_t - ref) (exp(ref - cum_s)
    // dt_s), both factors at most 1; on it per element, masked first
    float rsum[2] = {0.f, 0.f}, csum[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) csum[q] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tl = r0 + 8 * r, t = ti * T + tl;
      const float ct = v[tl];
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
    if (threadIdx.x < T)                      // then over the 4 warps
      a.cs[o + (int64_t)ti * a.QP + si * T + threadIdx.x] =
          (red[threadIdx.x] + red[T + threadIdx.x]) +
          (red[2 * T + threadIdx.x] + red[3 * T + threadIdx.x]);
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

// ---------------------------------------------------------------- 4 ----
// grid (nt, H * nc, B): the s tile si of (b, h, chunk), the forward's
// chunk scan transposed; rows s = r0, r0 + 8 of a thread, columns p = 8j
// + 2 t4 + e. Steps 0 .. ns-1: the state term B_s (registers, K = n, 64
// a step) times G_c (split as stored, rows p); then exp(total - cum_s)
// and K_s; steps ns ..: the t tiles ti >= si, W^T (W = cb L, formed in
// registers from the staged cb tile, K = t; L per element, masked first)
// times dy (split transposed, rows p). One stage of staging: the next
// step's tiles load while this step's products run. Then dx = dt_s
// dxdt, ddts = x . dxdt.
__global__ void __launch_bounds__(NT) ssd_bwd_dx_kernel(BwdArgs a) {
  constexpr int W = PMAX * T, STAGE = 2 * T * SPT;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* sp = smem;                       // G or dy^T split (p, k)
  float* stage = (float*)(sp + 2 * W);       // [B or cb, G or dy]
  float* cumv = stage + STAGE;               // [QP]
  float* dtv = cumv + QMAX;                  // [QP]
  const int si = blockIdx.x;                 // the longest walks first
  const int h = blockIdx.y % a.H, c = blockIdx.y / a.H, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  if (si * T >= len) return;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  const int64_t pn = (int64_t)a.P * a.N;
  const float* bs = (const float*)a.Bm + ((int64_t)b * a.S + c0 + si * T) * bld +
                 (int64_t)g * a.N;
  const float* ys = (const float*)a.dy + ((int64_t)b * a.S + c0) * xld +
                 (int64_t)h * a.P;
  const float* xs = (const float*)a.x + ((int64_t)b * a.S + c0) * xld +
                 (int64_t)h * a.P;
  const float* gc = a.dst + bhc * pn;
  const float* cbs = a.cb + (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP +
                     si * T;
  for (int i = threadIdx.x; i < a.QP; i += NT) {
    cumv[i] = a.cum[bhc * a.QP + i];
    dtv[i] = a.dts[bhc * a.QP + i];
  }
  // G_c is zero in the last chunk without a d(final): no state steps
  const int ns = (c == a.nc - 1 && a.dfinal == nullptr) ? 0
                                                        : (a.N + T - 1) / T;
  const int last = (len - 1) / T;
  const int steps = ns + last - si + 1;
  auto load = [&](int it, float* st) {
    if (it < ns) {
      const int n0 = it * T;
      load_tile<NT, T, T, SPA>(st, bs + n0, bld, len - si * T, a.N - n0,
                               a.vbc);
      load_tile<NT, PMAX, T, SPA>(st + T * SPT, gc + n0, a.N, a.P, a.N - n0,
                                  a.v4n);
    } else {
      const int t0 = (si + it - ns) * T;
      load_tile<NT, T, T, SPT>(st, cbs + (int64_t)t0 * a.QP, a.QP, T, T, 1);
      load_tile<NT, T, PMAX, SPT>(st + T * SPT, ys + t0 * xld, xld, len - t0,
                                  a.P, a.vx);
    }
  };

  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;
  float acc[32], kp[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float* st = stage;
  load(0, st);
  cp_commit();
  for (int it = 0; it < steps; ++it) {
    const bool state = it < ns;
    cp_wait_all();
    __syncthreads();                  // step it's tiles are in (cumv, dtv)
    uint32_t ab[8][4], as[8][4];
    if (state) {
      split_rows<NT, PMAX, T, SPA>(st + T * SPT, sp);
#pragma unroll
      for (int j = 0; j < 8; ++j) frag<SPA, 1>(st, r0, 8 * j, t4, ab[j], as[j]);
    } else {
      const int ti = si + it - ns;
      split_cols<NT, PMAX, T, SPT, false, false>(st + T * SPT, sp);
      // A[s][t] = cb[t][s] exp(cum_t - cum_s), s <= t < len
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int sl = r0 + 8 * (q & 1), tl = 8 * j + t4 + 4 * (q >> 1);
          const int s = si * T + sl, t = ti * T + tl;
          const float w = s <= t && t < len
                              ? st[tl * SPT + sl] * expf(cumv[t] - cumv[s])
                              : 0.f;
          split_bits(w, ab[j][q], as[j][q]);
        }
    }
    fence_async_smem();
    __syncthreads();                  // split ready; the staging is free
    pin(acc);
    wg_fence();
    if (state) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        step_rs(acc, ab[j], as[j], sp + 2 * j * (PMAX / 8) * 32, W);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        step_rs(acc, ab[j], as[j], sp + 2 * j * (PMAX / 8) * 32, W);
    }
    wg_commit();
    if (it + 1 < steps) load(it + 1, st);   // in flight with the products
    cp_commit();
    wg_wait_all();
    pin(acc);
    if (it == ns - 1) {               // the state term: decay, then K_s
      const float total = cumv[a.QP - 1];
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
              kp[r] = fmaf(xs[(int64_t)s * xld + p], acc[i], kp[r]);
          }
        kp[r] *= dtv[s];
      }
    }
  }

  // acc[4j + 2r + e] is dxdt[s = si T + r0 + 8r][p = 8j + 2 t4 + e]
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
          ((float*)a.dx)[((int64_t)b * a.S + c0) * xld + (int64_t)h * a.P +
                         o] = d * dxdt;
          pd = fmaf(xs[o], dxdt, pd);
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
}

// ---------------------------------------------------------------- 5 ----
// grid (nt * 2 * NH * HS, nc * G, B): the 64-row tile of chunk c, group g,
// z = 0 dC (rows t) or 1 dB (rows s), n in [64 nh, 64 nh + 64), heads of
// slice hs. Computed transposed, acc[n][u] with M = n and N = u: per head,
// S_in (dC) or G_c (dB) (registers, rows n, K = p, read from the staged
// p x n tile) times dy (dC) or x (dB) (split as stored, rows u). Each
// head's sum is scaled per column, exp(cum_t) (dC) or exp(total - cum_s)
// dt_s (dB), and added in head order; for dC, I_t's share of these 64 n.
__global__ void __launch_bounds__(NT) ssd_bwd_heads_kernel(BwdArgs a) {
  constexpr int W = T * PMAX;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* sp = smem;                       // dy or x split (u, p)
  float* sv = (float*)(sp + 2 * W);          // [T][SPA] dy or x rows u
  float* sm = sv + T * SPA;                  // [PMAX][SPT] S_in or G_c
  float* sc = sm + PMAX * SPT;               // [T][SPA] C rows t (dC)
  float* vt = sc + T * SPA;                  // [2][cum, dts][T], total
  float* red = vt + 2 * (2 * T + 4);         // [4][T]
  float* fv = red + 4 * T;                   // [T] a head's column factors
  const int tile = blockIdx.x % a.nt;
  int rest = blockIdx.x / a.nt;
  const int z = rest % 2;
  rest /= 2;
  const int nh = rest % a.NH, hs = rest / a.NH;
  const int g = blockIdx.y % a.G, c = blockIdx.y / a.G, b = blockIdx.z;
  const int len = chunk_len(a, c);
  if (tile * T >= len) return;
  const int h_lo = slice_head(a, g, hs);
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const int64_t pn = (int64_t)a.P * a.N;
  const int u0 = tile * T, n0 = T * nh;
  // G_c is zero in the last chunk without a d(final): dB gets nothing
  const int h_hi = z == 1 && c == a.nc - 1 && a.dfinal == nullptr
                       ? h_lo : slice_head(a, g, hs + 1);
  const float* vs = (const float*)(z == 0 ? a.dy : a.x) +
                 ((int64_t)b * a.S + c0 + u0) * xld;
  const float* ms = z == 0 ? a.s_in : a.dst;
  auto issue = [&](int h, float* v) {
    const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
    load_tile<NT, T, PMAX, SPA>(sv, vs + (int64_t)h * a.P, xld, len - u0, a.P,
                                a.vx);
    load_tile<NT, PMAX, T, SPT>(sm, ms + bhc * pn + n0, a.N, a.P, a.N - n0,
                                a.v4n);
    for (int i = threadIdx.x; i < 2 * T + 1; i += NT) {
      const float* src = i < T ? a.cum + bhc * a.QP + u0 + i
                               : i < 2 * T ? a.dts + bhc * a.QP + u0 + i - T
                                           : a.cum + bhc * a.QP + a.QP - 1;
      cp_async4(v + i, src, 4);
    }
  };

  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;               // rows n0 + r0, + 8
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (z == 0)
    load_tile<NT, T, T, SPA>(sc, (const float*)a.Cm + ((int64_t)b * a.S + c0 +
                                                    u0) * bld +
                                     (int64_t)g * a.N + n0,
                             bld, len - u0, a.N - n0, a.vbc);
  if (h_lo < h_hi) issue(h_lo, vt);
  cp_commit();
  for (int h = h_lo; h < h_hi; ++h) {
    const int k = h - h_lo;
    const float* v = vt + (k & 1) * (2 * T + 4);
    float hacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
    cp_wait_all();
    __syncthreads();                  // head h's tiles are in; red is read
    if (threadIdx.x < T)
      fv[threadIdx.x] = z == 0 ? expf(v[threadIdx.x])
                               : expf(v[2 * T] - v[threadIdx.x]) *
                                     v[T + threadIdx.x];
    split_rows<NT, T, PMAX, SPA>(sv, sp);
    // element (n, p) of the register operand is sm[p * SPT + n]
    uint32_t ab[8][4], as[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) frag<1, SPT>(sm, r0, 8 * j, t4, ab[j], as[j]);
    fence_async_smem();
    __syncthreads();                  // split ready; the staging is free
    pin(hacc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      step_rs(hacc, ab[j], as[j], sp + 2 * j * (T / 8) * 32, W);
    wg_commit();
    if (h + 1 < h_hi) issue(h + 1, vt + ((k + 1) & 1) * (2 * T + 4));
    cp_commit();
    wg_wait_all();
    pin(hacc);
    // hacc[4j + 2r + e] is row n = n0 + r0 + 8r, column u = 8j + 2 t4 + e
    float ip[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = 8 * j + 2 * t4 + e;
        const float f = fv[u];
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float w = hacc[i] * f;
          acc[i] += w;
          if (z == 0) s = fmaf(w, sc[u * SPA + r0 + 8 * r], s);
        }
        ip[2 * j + e] = s;
      }
    if (z == 0) {                    // I_t: over the 8 lanes g8, the warps
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        ip[q] += __shfl_xor_sync(SSD_BWD_MASK, ip[q], 4);
        ip[q] += __shfl_xor_sync(SSD_BWD_MASK, ip[q], 8);
        ip[q] += __shfl_xor_sync(SSD_BWD_MASK, ip[q], 16);
      }
      if (g8 == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            red[wl * T + 8 * j + 2 * t4 + e] = ip[2 * j + e];
      }
      __syncthreads();
      if (threadIdx.x < T) {
        const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
        const int u = threadIdx.x;
        a.pI[(int64_t)nh * a.B * a.H * a.nc * a.QP + bhc * a.QP + u0 + u] =
            (red[u] + red[T + u]) + (red[2 * T + u] + red[3 * T + u]);
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
        const int n = n0 + r0 + 8 * r, u = 8 * j + 2 * t4 + e;
        if (n < a.N) out[(int64_t)u * bld + n] = acc[4 * j + 2 * r + e];
      }
}

// ---------------------------------------------------------------- 7 ----
// grid (nt * 2 * NH, nc * G, B): the tile of chunk c, group g, z = 0 dC
// (rows t) or 1 dB (rows s), n in [64 nh, 64 nh + 64): acc[n][u] starts
// as the head terms (the slices' sum, pass 6), then over the K tiles
// (dC: s tiles <= ti; dB: t tiles >= si) B^T or C^T (registers, rows n,
// read from the staged tile) times dcb or dcb^T (split, rows u).
__global__ void __launch_bounds__(NT) ssd_bwd_dbc_kernel(BwdArgs a) {
  constexpr int W = T * T;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* sp = smem;                       // dcb or dcb^T split (u, k)
  float* sv = (float*)(sp + 2 * W);          // [T][SPT] B or C rows k
  float* sd = sv + T * SPT;                  // [T][SPA] dcb rows t
  const int tile = blockIdx.x % a.nt;
  const int z = (blockIdx.x / a.nt) % 2, nh = blockIdx.x / a.nt / 2;
  const int g = blockIdx.y % a.G, c = blockIdx.y / a.G, b = blockIdx.z;
  const int len = chunk_len(a, c);
  if (tile * T >= len) return;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t bld = (int64_t)a.G * a.N;
  const int u0 = tile * T, n0 = T * nh;
  const int last = (len - 1) / T;
  const float* vs = (const float*)(z == 0 ? a.Bm : a.Cm) +
                 ((int64_t)b * a.S + c0) * bld + (int64_t)g * a.N + n0;
  const float* dcb0 = a.dcbp + (((int64_t)b * a.nc + c) * a.G + g) * a.QP *
                                   a.QP;

  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
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
        const int n = n0 + r0 + 8 * r, u = 8 * j + 2 * t4 + e;
        acc[4 * j + 2 * r + e] = n < a.N ? part[(int64_t)u * bld + n] : 0.f;
      }
  const int k_lo = z == 0 ? 0 : tile, k_hi = z == 0 ? tile : last;
  for (int kt = k_lo; kt <= k_hi; ++kt) {
    load_tile<NT, T, T, SPT>(sv, vs + (int64_t)(kt * T) * bld, bld,
                             len - kt * T, a.N - n0, a.vbc);
    // the dcb tile (t tile, s tile): (ti, kt) for dC, (kt, si) for dB
    load_tile<NT, T, T, SPA>(sd, dcb0 + (int64_t)((z == 0 ? tile : kt) * T) *
                                            a.QP + (z == 0 ? kt : tile) * T,
                             a.QP, T, T, 1);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    if (z == 0)                       // rows t, K = s: as stored
      split_rows<NT, T, T, SPA>(sd, sp);
    else                              // rows s, K = t: transposed
      split_cols<NT, T, T, SPA, false>(sd, sp);
    // element (n, k) of the register operand is sv[k * SPT + n]
    uint32_t ab[8][4], as[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) frag<1, SPT>(sv, r0, 8 * j, t4, ab[j], as[j]);
    fence_async_smem();
    __syncthreads();
    pin(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      step_rs(acc, ab[j], as[j], sp + 2 * j * (T / 8) * 32, W);
    wg_commit();
    wg_wait_all();
    pin(acc);
    __syncthreads();                  // the staging is free again
  }
  float* out = (float*)(z == 0 ? a.dC : a.dB) +
               ((int64_t)b * a.S + c0 + u0) * bld + (int64_t)g * a.N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + r0 + 8 * r, u = 8 * j + 2 * t4 + e;
        if (n < a.N && u0 + u < len)
          out[(int64_t)u * bld + n] = acc[4 * j + 2 * r + e];
      }
}

// ------------------------------------------------------------ launch ----
// dynamic shared memory of the tensor-core passes, in bytes
static size_t dstates_smem() {
  return 4 * ((size_t)2 * PMAX * KT + 2 * 2 * KT * SPT + QMAX);
}
static size_t dcb_smem() {
  return 4 * ((size_t)2 * 2 * T * PMAX + 2 * T * SPA + 6 * T + 4 * T + T);
}
static size_t dx_smem() {
  return 4 * ((size_t)2 * PMAX * T + 2 * T * SPT + 2 * QMAX);
}
static size_t heads_smem() {
  return 4 * ((size_t)2 * T * PMAX + T * SPA + PMAX * SPT + T * SPA +
              2 * (2 * T + 4) + 4 * T + T);
}
static size_t dbc_smem() {
  return 4 * ((size_t)2 * T * T + T * SPT + T * SPA);
}

template <typename K>
static int launch_smem(K kern, dim3 grid, size_t bytes, const BwdArgs& a,
                       cudaStream_t stream) {
  const int e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != 0) return e;
  kern<<<grid, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

SSD_BWD_SHARED_PASSES

BWD_PASS(ssd_bwd_dstates) {
  BWD_ARGS
  return launch_smem(ssd_bwd_dstates_kernel, dim3(H * a.nc, B, a.NH),
                     dstates_smem(), a, stream);
}

BWD_PASS(ssd_bwd_dcb) {
  BWD_ARGS
  return launch_smem(ssd_bwd_dcb_kernel,
                     dim3(a.nt * (a.nt + 1) / 2 * a.HS, a.nc * G, B),
                     dcb_smem(), a, stream);
}

BWD_PASS(ssd_bwd_dx) {
  BWD_ARGS
  if (H * a.nc > 65535) return -1;
  return launch_smem(ssd_bwd_dx_kernel, dim3(a.nt, H * a.nc, B), dx_smem(),
                     a, stream);
}

BWD_PASS(ssd_bwd_heads) {
  BWD_ARGS
  return launch_smem(ssd_bwd_heads_kernel,
                     dim3(a.nt * 2 * a.NH * a.HS, a.nc * G, B), heads_smem(),
                     a, stream);
}

BWD_PASS(ssd_bwd_dbc) {
  BWD_ARGS
  return launch_smem(ssd_bwd_dbc_kernel, dim3(a.nt * 2 * a.NH, a.nc * G, B),
                     dbc_smem(), a, stream);
}
