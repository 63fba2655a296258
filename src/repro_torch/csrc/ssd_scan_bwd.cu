// The gradient of the Mamba2 SSD chunked scan (K4's backward) on FP32
// CUDA cores, for Hopper (sm_90a), in seven passes.
//
// Replaces: XLA's gradient of repro/models/ssd.py:ssd_scan (the reference
// trains through autodiff of its jnp scan; it has no Pallas backward).
// Given the forward's scratch (csrc/ssd_scan.cu: dts and cum per chunk,
// cb = C.B^T in its lower 64 x 64 tiles, S_in per chunk), dy (B,S,H,P)
// and d(final state) or none, it writes dx, ddt, dA, dB, dC and
// d(init_state), each in its operand's dtype and dA in float32. Within
// chunk c of head h (group g), with L[t,s] = exp(cum_t - cum_s) for
// s <= t (masked BEFORE the exp: s > t may overflow, and inf * 0 is NaN),
// W = cb L dt_s, D[t,s] = dy_t . x_s, M = W D and G_c the gradient of the
// state leaving chunk c:
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
// 26.3 GFLOP (chip_smoke.ssd_bwd_work). The bytes it must move (x, dy,
// dx, B, C, dB, dC, dt, ddt, A and dA, each once) are about 220 MB, 0.066
// ms at 3.35 TB/s. The floor is the card's peak for the operands' type,
// as for K3's backward: float32 at 3xTF32 (three TF32 products for each
// float32 one, 495 TFLOP/s dense on an H100 SXM) takes 0.160 ms, so
// float32 is bound by operations; bfloat16 at 989 TFLOP/s takes 0.027
// ms, below its 110 MB at 0.033 ms, so bfloat16 is bound by bytes. The
// FP32 CUDA cores this kernel uses (67 TFLOP/s) would need 0.39 ms for
// the same products: moving them to wgmma is the way to the floor.
//
// Design: a right kernel first. Every product runs on FP32 CUDA cores
// from 64-wide tiles staged in shared memory (16 x 16 threads, each 4 x 4
// or 4 x 8 outputs, K in steps of 32 or 64). The layout follows the
// Mamba2 authors' GPU backward (dstates, state passing backward, the
// chunk scan's and the chunk state's gradients, the cumsum's reverse),
// not block by block:
//   1. ssd_bwd_dstates: dstates per (b, h, chunk), (P x Q).(Q x N).
//   2. ssd_bwd_state_passing: G_c over the chunks in reverse, written
//      over dstates in place; d(init); per block the partial <G_c, S_in>.
//   3. ssd_bwd_dcb: per (b, chunk, group, tile pair t >= s), the group's
//      heads in order: D, then dcb summed over the heads in registers, and
//      each head's row and column sums of M off the diagonal.
//   4. ssd_bwd_dx: per (b, h, chunk, s tile): dx, ddts and K.
//   5. ssd_bwd_dbc: per (b, chunk, group, tile), dC (t tiles) or dB (s
//      tiles), the group's heads in order; I per head for dC's tiles.
//   6. ssd_bwd_ddt: per (b, h, chunk): dcum, its reverse cumsum, ddt and
//      the chunk's share of dA.
//   7. ssd_bwd_dA: dA per head, the (b, chunk) shares in order.
// No atomics: every sum over heads, tiles, slices or chunks runs in a
// fixed order, so every launch gives the same bits. Positions past S in
// the last chunk (dt = 0, x = B = C = dy = 0) get nothing written.
// Operands: x, B, C and dy all float32 or all bfloat16 (in_bf16), dt in
// float32 or bfloat16 (dt_bf16), d(init) in init's dtype (init_bf16); a
// bfloat16 value is widened as it is loaded.
//
// Interface: plain C, loaded with ctypes. Every pass takes the same
// arguments, launches on the given stream, does not synchronise, and
// returns cudaGetLastError(); -1 for a shape it does not take.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"

#define T 64                  // rows of a t or s tile
#define PMAX 64               // head dim P
#define NMAX 128              // state dim N
#define QMAX 256              // chunk length Q
#define NT 256                // threads of the tiled passes, 16 x 16
#define KS 32                 // K per staged step of passes 1 and 5
#define SP (T + 1)            // staged row of a 64-wide tile
#define SN (NMAX + 1)         // staged row of a 128-wide tile
#define SLICE 1024            // (p, n) elements per state-passing block
#define FULL_MASK 0xffffffffu

struct BwdArgs {
  const void* x;              // (B,S,H,P), in_bf16
  const void* dt;             // (B,S,H), dt_bf16
  const float* A;             // (H,)
  const void* Bm;             // (B,S,G,N), in_bf16
  const void* Cm;             // (B,S,G,N), in_bf16
  const void* dy;             // (B,S,H,P), in_bf16
  const float* dfinal;        // (B,H,P,N) or null: zeros
  const float* dts;           // (B,H,nc,QP) the forward's scratch
  const float* cum;           // (B,H,nc,QP)
  const float* cb;            // (B,nc,G,QP,QP), lower tiles
  const float* s_in;          // (B,H,nc,P,N): S_in per chunk
  void* dx;                   // (B,S,H,P), in_bf16
  void* ddt;                  // (B,S,H), dt_bf16
  float* dA;                  // (H,)
  void* dB;                   // (B,S,G,N), in_bf16
  void* dC;                   // (B,S,G,N), in_bf16
  void* dinit;                // (B,H,P,N), init_bf16, or null: not wanted
  float* dst;                 // (B,H,nc,P,N) scratch: dstates, then G_c
  float* dcb;                 // (B,nc,G,QP,QP) scratch, lower tiles
  float* rs;                  // (B,H,nc,nt,QP): row sums of M by s tile
  float* cs;                  // (B,H,nc,nt,QP): column sums by t tile
  float* pI;                  // (B,H,nc,QP): I_t
  float* pK;                  // (B,H,nc,QP): K_s
  float* pD;                  // (B,H,nc,QP): ddts
  float* ep;                  // (B,H,nc,nsl): partial <G_c, S_in[c]>
  float* dap;                 // (B,H,nc): each chunk's share of dA
  int B, S, H, P, G, N, Q, QP, nc, nt, nsl;
  int in_bf16, dt_bf16, init_bf16;
};

__device__ __forceinline__ float ld(const void* p, int64_t i, int bf) {
  return bf ? widen(((const bf16*)p)[i]) : ((const float*)p)[i];
}

__device__ __forceinline__ void st(void* p, int64_t i, float v, int bf) {
  if (bf) ((bf16*)p)[i] = narrow<bf16>(v);
  else ((float*)p)[i] = v;
}

__device__ __forceinline__ int chunk_len(const BwdArgs& a, int c) {
  return (int)min((int64_t)a.Q, (int64_t)a.S - (int64_t)c * a.Q);
}

// the sum of v over the block's n <= NT threads, in a fixed tree order
// (slots past n hold zeros); every thread gets it (red: NT floats of
// shared memory)
__device__ __forceinline__ float block_sum(float v, float* red, int n) {
  const int u = threadIdx.x;
  red[u] = v;
  for (int i = n + u; i < NT; i += n) red[i] = 0.f;
  __syncthreads();
  for (int o = NT / 2; o > 0; o >>= 1) {
    for (int i = u; i < o; i += n) red[i] += red[i + o];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

// rows of 16 partial sums (red[r * 17 + tx]) added in order by thread r
__device__ __forceinline__ float row16(const float* red, int r) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += red[r * 17 + k];
  return s;
}

// ---------------------------------------------------------------- 1 ----
// grid (H * nc, B): dstates[p][n] = sum_t exp(cum_t) dy[t][p] C[t][n];
// thread rows p = ty + 16 i, columns n = tx + 16 j; K = t in steps of KS
__global__ void __launch_bounds__(NT) ssd_bwd_dstates_kernel(BwdArgs a) {
  __shared__ float sa[KS][SP];               // exp(cum_t) dy[t][p]
  __shared__ float sb[KS][SN];               // C[t][n]
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int len = chunk_len(a, c);
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  const int64_t xld = (int64_t)a.H * a.P, cld = (int64_t)a.G * a.N;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int t0 = 0; t0 < len; t0 += KS) {
    for (int e = threadIdx.x; e < KS * PMAX; e += NT) {
      const int k = e / PMAX, p = e % PMAX, t = t0 + k;
      sa[k][p] = t < len && p < a.P
                     ? expf(a.cum[bhc * a.QP + t]) *
                           ld(a.dy, ((int64_t)b * a.S + c0 + t) * xld +
                                        (int64_t)h * a.P + p, a.in_bf16)
                     : 0.f;
    }
    for (int e = threadIdx.x; e < KS * NMAX; e += NT) {
      const int k = e / NMAX, n = e % NMAX, t = t0 + k;
      sb[k][n] = t < len && n < a.N
                     ? ld(a.Cm, ((int64_t)b * a.S + c0 + t) * cld +
                                    (int64_t)g * a.N + n, a.in_bf16)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KS; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sb[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = a.dst + bhc * a.P * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = ty + 16 * i, n = tx + 16 * j;
      if (p < a.P && n < a.N) out[p * a.N + n] = acc[i][j];
    }
}

// ---------------------------------------------------------------- 2 ----
// grid (nsl * H, B), NT threads of 4 elements each: G_c over the chunks in
// reverse, written over dstates_c; ep = the block's share of <G_c, S_in[c]>
// (times exp(total_c)); d(init)
__global__ void __launch_bounds__(NT) ssd_bwd_state_passing_kernel(
    BwdArgs a) {
  __shared__ float red[NT];
  const int sl = blockIdx.x % a.nsl, h = blockIdx.x / a.nsl, b = blockIdx.y;
  const int64_t bh = (int64_t)b * a.H + h;
  const int64_t pn = (int64_t)a.P * a.N;
  int64_t idx[4];
  float g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    idx[k] = (int64_t)sl * SLICE + threadIdx.x + k * NT;
    g[k] = a.dfinal != nullptr && idx[k] < pn ? a.dfinal[bh * pn + idx[k]]
                                              : 0.f;
  }
  for (int c = a.nc - 1; c >= 0; --c) {
    const int64_t bhc = bh * a.nc + c;
    const float dec = expf(a.cum[bhc * a.QP + a.QP - 1]);
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (idx[k] >= pn) continue;
      float* d = a.dst + bhc * pn + idx[k];
      const float ds = *d;
      part = fmaf(g[k], a.s_in[bhc * pn + idx[k]], part);
      *d = g[k];
      g[k] = fmaf(dec, g[k], ds);
    }
    const float tot = block_sum(part, red, NT);
    if (threadIdx.x == 0) a.ep[bhc * a.nsl + sl] = dec * tot;
  }
  if (a.dinit != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (idx[k] < pn) st(a.dinit, bh * pn + idx[k], g[k], a.init_bf16);
  }
}

// ---------------------------------------------------------------- 3 ----
// grid (ntri * nc * G, B): the tile pair (ti, si), si <= ti, of chunk c
// and group g; thread rows t = ty + 16 i, columns s = tx + 16 j. For each
// head of the group in order: D = dy_t . x_s (K = p), dcb += L dt_s D, and
// M = cb L dt_s D summed along each row (s < t) into rs[si] and each
// column (t > s) into cs[ti].
__global__ void __launch_bounds__(NT) ssd_bwd_dcb_kernel(BwdArgs a) {
  __shared__ float sdy[PMAX][SP];            // dy[t][p] as [p][t]; then M
  __shared__ float sx[PMAX][SP];             // x[s][p] as [p][s]
  __shared__ float vc[2 * T + T];            // cum_t, cum_s, dt_s
  const int ntri = a.nt * (a.nt + 1) / 2;
  const int tile = blockIdx.x % ntri, rest = blockIdx.x / ntri;
  const int g = rest % a.G, c = rest / a.G, b = blockIdx.y;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int si = tile - ti * (ti + 1) / 2;
  const int len = chunk_len(a, c);
  if (ti * T >= len) return;                 // past the chunk: never read
  const int R = a.H / a.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P;
  const int64_t cbo = (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP;
  float cbv[4][4], dcb[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cbv[i][j] = a.cb[cbo + (int64_t)(ti * T + ty + 16 * i) * a.QP +
                       si * T + tx + 16 * j];
      dcb[i][j] = 0.f;
    }
  for (int r = 0; r < R; ++r) {
    const int h = g * R + r;
    const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
    for (int e = threadIdx.x; e < T * PMAX; e += NT) {
      const int k = e / PMAX, p = e % PMAX;
      const int t = ti * T + k, s = si * T + k;
      const int64_t row =
          ((int64_t)b * a.S + c0) * xld + (int64_t)h * a.P + p;
      sdy[p][k] =
          t < len && p < a.P ? ld(a.dy, row + t * xld, a.in_bf16) : 0.f;
      sx[p][k] = s < len && p < a.P ? ld(a.x, row + s * xld, a.in_bf16) : 0.f;
    }
    if (threadIdx.x < T) {
      vc[threadIdx.x] = a.cum[bhc * a.QP + ti * T + threadIdx.x];
      vc[T + threadIdx.x] = a.cum[bhc * a.QP + si * T + threadIdx.x];
      vc[2 * T + threadIdx.x] = a.dts[bhc * a.QP + si * T + threadIdx.x];
    }
    __syncthreads();
    float d[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
#pragma unroll 4
    for (int p = 0; p < PMAX; ++p) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sdy[p][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sx[p][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
    }
    __syncthreads();                         // sdy is free: M goes there
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tl = ty + 16 * i, sc = tx + 16 * j;
        const int t = ti * T + tl, s = si * T + sc;
        float m = 0.f;
        if (s <= t) {                        // mask before the exp
          const float v = d[i][j] * (expf(vc[tl] - vc[T + sc]) *
                                     vc[2 * T + sc]);
          dcb[i][j] += v;
          if (s < t) m = cbv[i][j] * v;
        }
        sdy[tl][sc] = m;
      }
    __syncthreads();
    const int64_t o = bhc * a.nt * a.QP;
    if (threadIdx.x < T) {                   // row t: sum over s
      float v = 0.f;
      for (int k = 0; k < T; ++k) v += sdy[threadIdx.x][k];
      a.rs[o + (int64_t)si * a.QP + ti * T + threadIdx.x] = v;
    } else if (threadIdx.x < 2 * T) {        // column s: sum over t
      const int k0 = threadIdx.x - T;
      float v = 0.f;
      for (int k = 0; k < T; ++k) v += sdy[k][k0];
      a.cs[o + (int64_t)ti * a.QP + si * T + k0] = v;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a.dcb[cbo + (int64_t)(ti * T + ty + 16 * i) * a.QP + si * T + tx +
            16 * j] = dcb[i][j];
}

// ---------------------------------------------------------------- 4 ----
// grid (nt * H * nc, B): the s tile si of (b, h, chunk); thread rows
// s = ty + 16 i, columns p = tx + 16 j. The intra term sum_{t >= s}
// cb L dy_t over the t tiles ti >= si (K = t), the state term G_c B_s
// (K = n in steps of 64), then dx, ddts = x . dxdt and K.
__global__ void __launch_bounds__(NT) ssd_bwd_dx_kernel(BwdArgs a) {
  __shared__ float s1[T][SP];                // W[t][s], then B[n][s]
  __shared__ float s2[T][SP];                // dy[t][p], then G[n][p]
  __shared__ float vc[2 * QMAX];             // cum, dts of the chunk
  __shared__ float red[2][T * 17];
  const int si = blockIdx.x % a.nt, rest = blockIdx.x / a.nt;
  const int h = rest % a.H, c = rest / a.H, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  if (si * T >= len) return;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  const int64_t cbo = (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP;
  for (int i = threadIdx.x; i < a.QP; i += NT) {
    vc[i] = a.cum[bhc * a.QP + i];
    vc[QMAX + i] = a.dts[bhc * a.QP + i];
  }
  __syncthreads();
  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;
  const int last = (len - 1) / T;
  for (int ti = si; ti <= last; ++ti) {
    for (int e = threadIdx.x; e < T * T; e += NT) {
      const int tl = e / T, sc = e % T;
      const int t = ti * T + tl, s = si * T + sc;
      s1[tl][sc] = s <= t && t < len
                       ? a.cb[cbo + (int64_t)t * a.QP + s] *
                             expf(vc[t] - vc[s])
                       : 0.f;
      s2[tl][sc] = t < len && sc < a.P
                       ? ld(a.dy, ((int64_t)b * a.S + c0 + t) * xld +
                                      (int64_t)h * a.P + sc, a.in_bf16)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < T; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s1[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s2[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float* gc = a.dst + bhc * a.P * a.N;
  for (int n0 = 0; n0 < a.N; n0 += T) {
    for (int e = threadIdx.x; e < T * T; e += NT) {
      const int k = e % T, q = e / T;        // q: s (B) or p (G)
      const int n = n0 + k, s = si * T + q;
      s1[k][q] = n < a.N && s < len
                     ? ld(a.Bm, ((int64_t)b * a.S + c0 + s) * bld +
                                    (int64_t)g * a.N + n, a.in_bf16)
                     : 0.f;
      s2[k][q] = n < a.N && q < a.P ? gc[(int64_t)q * a.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < T; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s1[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s2[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc2[i][j] = fmaf(av[i], bv[j], acc2[i][j]);
    }
    __syncthreads();
  }
  const float total = vc[a.QP - 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sl = ty + 16 * i, s = si * T + sl;
    const float e = expf(total - vc[s]), d = vc[QMAX + s];
    float pd = 0.f, pk = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (s < len && p < a.P) {
        const int64_t o = ((int64_t)b * a.S + c0 + s) * xld +
                          (int64_t)h * a.P + p;
        const float xv = ld(a.x, o, a.in_bf16);
        const float st_term = e * acc2[i][j];
        const float dxdt = acc[i][j] + st_term;
        st(a.dx, o, d * dxdt, a.in_bf16);
        pd = fmaf(xv, dxdt, pd);
        pk = fmaf(xv, st_term, pk);
      }
    }
    red[0][sl * 17 + tx] = pd;
    red[1][sl * 17 + tx] = d * pk;
  }
  __syncthreads();
  if (threadIdx.x < T) {
    const int s = si * T + threadIdx.x;
    a.pD[bhc * a.QP + s] = row16(red[0], threadIdx.x);
    a.pK[bhc * a.QP + s] = row16(red[1], threadIdx.x);
  }
}

// ---------------------------------------------------------------- 5 ----
// grid (nt * nc * G, B, 2): z = 0 the t tile of dC, z = 1 the s tile of
// dB, for (b, chunk, group); thread rows ty + 16 i, columns n = tx + 16 j.
// dC: sum_{si <= ti} dcb[t][s] B_s (K = s), then per head exp(cum_t)
//     dy_t S_in (K = p), and I_t = C_t . that;
// dB: sum_{ti >= si} dcb[t][s] C_t (K = t), then per head exp(total -
//     cum_s) dt_s x_s G_c (K = p).
__global__ void __launch_bounds__(NT) ssd_bwd_dbc_kernel(BwdArgs a) {
  __shared__ float sa[KS][SP];               // the K x 64 row operand
  __shared__ float sb[KS][SN];               // the K x N column operand
  __shared__ float vr[T];                    // a head's row factors
  __shared__ float red[T * 17];
  const int tile = blockIdx.x % a.nt, rest = blockIdx.x / a.nt;
  const int g = rest % a.G, c = rest / a.G, b = blockIdx.y;
  const int isB = blockIdx.z;
  const int len = chunk_len(a, c);
  if (tile * T >= len) return;
  const int R = a.H / a.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const int64_t cbo = (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP;
  const int r0 = tile * T;                   // this tile's first row
  const void* other = isB ? a.Cm : a.Bm;     // the intra term's operand
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // intra: K runs over the other index's tiles (s <= t for dC, t >= s
  // for dB), KS at a time
  const int last = (len - 1) / T;
  const int k_lo = isB ? r0 : 0, k_hi = isB ? (last + 1) * T : r0 + T;
  for (int k0 = k_lo; k0 < k_hi; k0 += KS) {
    for (int e = threadIdx.x; e < KS * T; e += NT) {
      // q: this tile's row; the read along dcb's rows is the faster one
      const int k = isB ? e / T : e % KS, q = isB ? e % T : e / KS;
      const int kk = k0 + k;
      // dC: dcb[r0 + q][kk]; dB: dcb[kk][r0 + q]; lower tiles only
      const int t = isB ? kk : r0 + q, s = isB ? r0 + q : kk;
      sa[k][q] = s <= t && t < len && s < len
                     ? a.dcb[cbo + (int64_t)t * a.QP + s] : 0.f;
    }
    for (int e = threadIdx.x; e < KS * NMAX; e += NT) {
      const int k = e / NMAX, n = e % NMAX, kk = k0 + k;
      sb[k][n] = kk < len && n < a.N
                     ? ld(other, ((int64_t)b * a.S + c0 + kk) * bld +
                                     (int64_t)g * a.N + n, a.in_bf16)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KS; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sb[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  // dC's C_t, for I
  float cv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = r0 + ty + 16 * i, n = tx + 16 * j;
      cv[i][j] = !isB && t < len && n < a.N
                     ? ld(a.Cm, ((int64_t)b * a.S + c0 + t) * bld +
                                    (int64_t)g * a.N + n, a.in_bf16)
                     : 0.f;
    }
  for (int r = 0; r < R; ++r) {
    const int h = g * R + r;
    const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
    // dC: dy_t S_in (S_in[p][n]); dB: x_s G_c (G[p][n])
    const float* mat = (isB ? a.dst : a.s_in) + bhc * a.P * a.N;
    const void* vec = isB ? a.x : a.dy;
    if (threadIdx.x < T) {
      const int q = r0 + threadIdx.x;
      const float cq = a.cum[bhc * a.QP + q];
      vr[threadIdx.x] = isB ? expf(a.cum[bhc * a.QP + a.QP - 1] - cq) *
                                  a.dts[bhc * a.QP + q]
                            : expf(cq);
    }
    float hacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) hacc[i][j] = 0.f;
    for (int p0 = 0; p0 < a.P; p0 += KS) {
      for (int e = threadIdx.x; e < KS * T; e += NT) {
        const int k = e % KS, q = e / KS, p = p0 + k, row = r0 + q;
        sa[k][q] = row < len && p < a.P
                       ? ld(vec, ((int64_t)b * a.S + c0 + row) * xld +
                                     (int64_t)h * a.P + p, a.in_bf16)
                       : 0.f;
      }
      for (int e = threadIdx.x; e < KS * NMAX; e += NT) {
        const int k = e / NMAX, n = e % NMAX, p = p0 + k;
        sb[k][n] = p < a.P && n < a.N ? mat[(int64_t)p * a.N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KS; ++k) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = sa[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = sb[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            hacc[i][j] = fmaf(av[i], bv[j], hacc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = vr[ty + 16 * i];
      float pi = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = hacc[i][j] * f;
        acc[i][j] += v;
        pi = fmaf(v, cv[i][j], pi);
      }
      if (!isB) red[(ty + 16 * i) * 17 + tx] = pi;
    }
    __syncthreads();
    if (!isB && threadIdx.x < T)
      a.pI[bhc * a.QP + r0 + threadIdx.x] = row16(red, threadIdx.x);
    __syncthreads();
  }
  void* out = isB ? a.dB : a.dC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = r0 + ty + 16 * i, n = tx + 16 * j;
      if (row < len && n < a.N)
        st(out, ((int64_t)b * a.S + c0 + row) * bld + (int64_t)g * a.N + n,
           acc[i][j], a.in_bf16);
    }
}

// ---------------------------------------------------------------- 6 ----
// grid (H * nc, B), QP threads: dcum from the partial sums (rs over the s
// tiles in order, cs over the live t tiles in order, I, K, and at the
// last slot sum K + the ep shares), its reverse cumsum dla (a warp
// shuffle scan from the chunk's end, then the warps' totals in order),
// ddt = ddts + A dla, and dap = sum_u dts_u dla_u.
__global__ void __launch_bounds__(QMAX) ssd_bwd_ddt_kernel(BwdArgs a) {
  __shared__ float wsum[QMAX / 32];
  __shared__ float red[NT];
  const int u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int len = chunk_len(a, c);
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  const int64_t o = bhc * a.QP;
  float K = 0.f, dc = 0.f;
  if (u < len) {
    const int tu = u / T, last = (len - 1) / T;
    float rs = 0.f, cs = 0.f;
    for (int k = 0; k <= tu; ++k) rs += a.rs[(bhc * a.nt + k) * a.QP + u];
    for (int k = tu; k <= last; ++k) cs += a.cs[(bhc * a.nt + k) * a.QP + u];
    K = a.pK[o + u];
    dc = rs - cs + a.pI[o + u] - K;
  }
  const float ksum = block_sum(K, red, a.QP);
  if (u == a.QP - 1) {
    float e = 0.f;
    for (int k = 0; k < a.nsl; ++k) e += a.ep[bhc * a.nsl + k];
    dc += ksum + e;
  }
  // the reverse inclusive scan
  float v = dc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float w = __shfl_down_sync(FULL_MASK, v, d);
    if (lane + d < 32) v += w;
  }
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  float off = 0.f;
  for (int w = a.QP / 32 - 1; w > warp; --w) off += wsum[w];
  const float dla = v + off;
  const float d = a.dts[o + u];
  if (u < len) {
    const int64_t at = ((int64_t)b * a.S + (int64_t)c * a.Q + u) * a.H + h;
    st(a.ddt, at, a.pD[o + u] + a.A[h] * dla, a.dt_bf16);
  }
  const float dap = block_sum(u < len ? d * dla : 0.f, red, a.QP);
  if (u == 0) a.dap[bhc] = dap;
}

// ---------------------------------------------------------------- 7 ----
// grid ceil(H / NT): dA[h] = the (b, chunk) shares in order
__global__ void __launch_bounds__(NT) ssd_bwd_dA_kernel(BwdArgs a) {
  const int h = blockIdx.x * NT + threadIdx.x;
  if (h >= a.H) return;
  float s = 0.f;
  for (int b = 0; b < a.B; ++b)
    for (int c = 0; c < a.nc; ++c)
      s += a.dap[((int64_t)b * a.H + h) * a.nc + c];
  a.dA[h] = s;
}

// ------------------------------------------------------------ launch ----
#define BWD_PASS(name)                                                      \
  extern "C" int name(                                                      \
      const void* x, const void* dt, const float* A, const void* Bm,       \
      const void* Cm, const void* dy, const float* dfinal, const float* dts, \
      const float* cum, const float* cb, const float* s_in, void* dx,       \
      void* ddt, float* dA, void* dB, void* dC, void* dinit, float* dst,   \
      float* dcb, float* rs, float* cs, float* pI, float* pK, float* pD,   \
      float* ep, float* dap, int B, int S, int H, int P, int G, int N,     \
      int Q, int in_bf16, int dt_bf16, int init_bf16, cudaStream_t stream)

// Arguments of every pass: the forward's operands x (B,S,H,P), dt (B,S,H),
// A (H,), Bm and Cm (B,S,G,N); dy (B,S,H,P) in x's dtype; dfinal
// (B,H,P,N) float32 or null; the forward's scratch dts and cum
// (B,H,nc,QP), cb (B,nc,G,QP,QP) and S_in (B,H,nc,P,N) after its five
// passes; the gradients dx, ddt, dA (H,) float32, dB, dC and dinit (or
// null) in their operands' dtypes; the scratch dst (B,H,nc,P,N), dcb
// (B,nc,G,QP,QP), rs and cs (B,H,nc,QP/64,QP), pI, pK and pD (B,H,nc,QP),
// ep (B,H,nc,ceil(P*N/1024)) and dap (B,H,nc), float32. nc = ceil(S/Q),
// QP = Q rounded up to 64; P <= 64, N <= 128, 1 <= Q <= 256, H % G == 0,
// B <= 65535. The passes run in order: dstates, state_passing, dcb, dx,
// dbc, ddt, dA.
#define BWD_ARGS                                                            \
  if (B == 0 || H == 0) return 0;                                           \
  if (P < 1 || P > PMAX || N < 1 || N > NMAX || Q < 1 || Q > QMAX ||        \
      S < 1 || G < 1 || H % G != 0 || B > 65535)                            \
    return -1;                                                              \
  const int QP = (Q + T - 1) / T * T, nc = (S + Q - 1) / Q;                 \
  const BwdArgs a{x,  dt,  A,  Bm, Cm, dy, dfinal, dts, cum, cb, s_in, dx,   \
                  ddt, dA, dB, dC, dinit, dst, dcb, rs, cs, pI, pK, pD, ep, \
                  dap, B, S, H, P, G, N, Q, QP, nc, QP / T,                 \
                  (P * N + SLICE - 1) / SLICE, in_bf16, dt_bf16, init_bf16};

BWD_PASS(ssd_bwd_dstates) {
  BWD_ARGS
  ssd_bwd_dstates_kernel<<<dim3(H * a.nc, B), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

BWD_PASS(ssd_bwd_state_passing) {
  BWD_ARGS
  ssd_bwd_state_passing_kernel<<<dim3(a.nsl * H, B), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

BWD_PASS(ssd_bwd_dcb) {
  BWD_ARGS
  ssd_bwd_dcb_kernel<<<dim3(a.nt * (a.nt + 1) / 2 * a.nc * G, B), NT, 0,
                       stream>>>(a);
  return (int)cudaGetLastError();
}

BWD_PASS(ssd_bwd_dx) {
  BWD_ARGS
  ssd_bwd_dx_kernel<<<dim3(a.nt * H * a.nc, B), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

BWD_PASS(ssd_bwd_dbc) {
  BWD_ARGS
  ssd_bwd_dbc_kernel<<<dim3(a.nt * a.nc * G, B, 2), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

BWD_PASS(ssd_bwd_ddt) {
  BWD_ARGS
  ssd_bwd_ddt_kernel<<<dim3(H * a.nc, B), QP, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

BWD_PASS(ssd_bwd_dA) {
  BWD_ARGS
  ssd_bwd_dA_kernel<<<(H + NT - 1) / NT, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
