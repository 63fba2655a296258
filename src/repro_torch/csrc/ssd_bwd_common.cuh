// What K4's two backward libraries share (csrc/ssd_scan_bwd.cu, float32
// x, B, C and dy; csrc/ssd_scan_bwd_bf16.cu, bfloat16 ones): the
// arguments every pass takes, and the four passes that run no products
// and read x's dtype nowhere: the state passing backward (2), the head
// slices' sum (6), ddt (8) and dA (9), elementwise over float32 scratch.
// Each library compiles its own copy; a library defines BWD_BF16_LIB (0
// or 1, the in_bf16 it takes) before it includes this header.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"

#define SSD_BWD_T 64              // rows of a t or s tile
#define SSD_BWD_PMAX 64           // head dim P
#define SSD_BWD_NMAX 128          // state dim N: up to two 64-wide halves
#define SSD_BWD_QMAX 256          // chunk length Q
#ifndef SSD_BWD_HSMAX
#define SSD_BWD_HSMAX 4           // head slices of a group (passes 3 and 5)
#endif
#define SSD_BWD_SLICE 1024        // (p, n) elements per state-passing block
#define SSD_BWD_CG 8              // chunks in flight in the state passing
#define SSD_BWD_MASK 0xffffffffu

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
  float* dcbp;                // (HS,B,nc,G,QP,QP): dcb per slice, lower tiles
  float* rs;                  // (B,H,nc,nt,QP): row sums of M by s tile
  float* cs;                  // (B,H,nc,nt,QP): column sums by t tile
  float* pI;                  // (NH,B,H,nc,QP): I_t by 64 of N
  float* pK;                  // (B,H,nc,QP): K_s
  float* pD;                  // (B,H,nc,QP): ddts
  float* pbc;                 // (2,HS,B,nc,QP,G,N): dC's, dB's head terms
  float* ep;                  // (B,H,nc,nsl): partial <G_c, S_in[c]>
  float* dap;                 // (B,H,nc): each chunk's share of dA
  int B, S, H, P, G, N, Q, QP, nc, nt, nsl, HS, NH;
  int in_bf16, dt_bf16, init_bf16;
  int vx;                     // 16-byte copies of x and dy rows
  int vbc;                    // ... of B and C rows
  int v4n;                    // ... of float32 rows of N (G_c, S_in)
};

__device__ __forceinline__ void st(void* p, int64_t i, float v, int bf) {
  if (bf) ((bf16*)p)[i] = narrow<bf16>(v);
  else ((float*)p)[i] = v;
}

__device__ __forceinline__ int chunk_len(const BwdArgs& a, int c) {
  return (int)min((int64_t)a.Q, (int64_t)a.S - (int64_t)c * a.Q);
}

// the first head of slice hs of group g (R heads in HS slices)
__device__ __forceinline__ int slice_head(const BwdArgs& a, int g, int hs) {
  const int R = a.H / a.G;
  return g * R + hs * R / a.HS;
}

// ---------------------------------------------------------------- 2 ----
// grid (nsl * H, B), 256 threads of 4 elements each: G_c over the chunks
// in reverse, written over dstates_c; ep = the block's share of <G_c,
// S_in[c]> times exp(total_c) (a warp's butterfly sum, then its 8 warps'
// in a fixed tree); d(init)
__global__ void __launch_bounds__(256) ssd_bwd_state_passing_kernel(
    BwdArgs a) {
  __shared__ float wred[2][8];
  const int sl = blockIdx.x % a.nsl, h = blockIdx.x / a.nsl, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t bh = (int64_t)b * a.H + h;
  const int64_t pn = (int64_t)a.P * a.N;
  int64_t idx[4];
  float g[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    idx[v] = (int64_t)sl * SSD_BWD_SLICE + threadIdx.x + v * 256;
    g[v] = a.dfinal != nullptr && idx[v] < pn ? a.dfinal[bh * pn + idx[v]]
                                              : 0.f;
  }
  int done = 0;
  for (int c1 = a.nc - 1; c1 >= 0; c1 -= SSD_BWD_CG) {
    float ds[SSD_BWD_CG][4], si[SSD_BWD_CG][4], dec[SSD_BWD_CG];
#pragma unroll
    for (int k = 0; k < SSD_BWD_CG; ++k) {
      if (c1 - k < 0) break;
      const int64_t bhc = bh * a.nc + c1 - k;
      dec[k] = expf(a.cum[bhc * a.QP + a.QP - 1]);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const bool ok = idx[v] < pn;
        ds[k][v] = ok ? a.dst[bhc * pn + idx[v]] : 0.f;
        si[k][v] = ok ? a.s_in[bhc * pn + idx[v]] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < SSD_BWD_CG; ++k) {
      if (c1 - k < 0) break;
      const int64_t bhc = bh * a.nc + c1 - k;
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        part = fmaf(g[v], si[k][v], part);
        if (idx[v] < pn) a.dst[bhc * pn + idx[v]] = g[v];
        g[v] = fmaf(dec[k], g[v], ds[k][v]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(SSD_BWD_MASK, part, o);
      float* w = wred[done & 1];
      if (lane == 0) w[warp] = part;
      __syncthreads();
      if (threadIdx.x == 0)
        a.ep[bhc * a.nsl + sl] =
            dec[k] * (((w[0] + w[1]) + (w[2] + w[3])) +
                      ((w[4] + w[5]) + (w[6] + w[7])));
      ++done;
    }
  }
  if (a.dinit != nullptr) {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (idx[v] < pn) st(a.dinit, bh * pn + idx[v], g[v], a.init_bf16);
  }
}

// ---------------------------------------------------------------- 6 ----
// grid (ceil(max(G QP^2, QP G N) / 1024), B * nc, 3), 256 threads of 4
// values: the head slices' partials added in slice order into slice 0,
// z = 0 dcb's lower tiles (G QP^2 values a (b, chunk)), z = 1 and 2 dC's
// and dB's head terms (QP G N values a (b, chunk)). Launched for HS > 1.
__global__ void __launch_bounds__(256) ssd_bwd_sum_kernel(BwdArgs a) {
  const int z = blockIdx.z;
  const int64_t bc = blockIdx.y;             // b nc + c
  const int64_t per = z == 0 ? (int64_t)a.G * a.QP * a.QP
                             : (int64_t)a.QP * a.G * a.N;
  const int64_t i = 4 * ((int64_t)blockIdx.x * 256 + threadIdx.x);
  if (i >= per) return;
  if (z == 0) {                              // an upper tile: never written
    const int64_t e = i % ((int64_t)a.QP * a.QP);
    if ((e % a.QP) / SSD_BWD_T > (e / a.QP) / SSD_BWD_T) return;
  }
  const int64_t stride = (int64_t)a.B * a.nc * per;
  float* p = (z == 0 ? a.dcbp : a.pbc + (int64_t)(z - 1) * a.HS * stride) +
             bc * per + i;
  float4 s = *(const float4*)p;
  for (int hs = 1; hs < a.HS; ++hs) {
    const float4 w = *(const float4*)(p + hs * stride);
    s.x += w.x;
    s.y += w.y;
    s.z += w.z;
    s.w += w.w;
  }
  *(float4*)p = s;
}

// ---------------------------------------------------------------- 8 ----
// the sum of v over the block's QP threads in a fixed tree order (slots
// past n hold zeros); every thread gets it (red: QMAX floats)
__device__ __forceinline__ float block_sum(float v, float* red, int n) {
  const int u = threadIdx.x;
  red[u] = v;
  for (int i = n + u; i < SSD_BWD_QMAX; i += n) red[i] = 0.f;
  __syncthreads();
  for (int o = SSD_BWD_QMAX / 2; o > 0; o >>= 1) {
    for (int i = u; i < o; i += n) red[i] += red[i + o];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

// grid (H * nc, B), QP threads: dcum from the partial sums (rs over the s
// tiles in order, cs over the live t tiles in order, I over the halves of
// N in order, K, and at the last slot sum K + the ep shares), its reverse
// cumsum dla (a warp shuffle scan from the chunk's end, then the warps'
// totals in order), ddt = ddts + A dla, and dap = sum_u dts_u dla_u.
__global__ void __launch_bounds__(SSD_BWD_QMAX) ssd_bwd_ddt_kernel(
    BwdArgs a) {
  __shared__ float wsum[SSD_BWD_QMAX / 32];
  __shared__ float red[SSD_BWD_QMAX];
  const int u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int len = chunk_len(a, c);
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  const int64_t o = bhc * a.QP;
  float K = 0.f, dc = 0.f;
  if (u < len) {
    const int tu = u / SSD_BWD_T, last = (len - 1) / SSD_BWD_T;
    float rs = 0.f, cs = 0.f, I = 0.f;
    for (int k = 0; k <= tu; ++k) rs += a.rs[(bhc * a.nt + k) * a.QP + u];
    for (int k = tu; k <= last; ++k) cs += a.cs[(bhc * a.nt + k) * a.QP + u];
    for (int k = 0; k < a.NH; ++k)
      I += a.pI[(int64_t)k * a.B * a.H * a.nc * a.QP + o + u];
    K = a.pK[o + u];
    dc = rs - cs + I - K;
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
    const float w = __shfl_down_sync(SSD_BWD_MASK, v, d);
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

// ---------------------------------------------------------------- 9 ----
// grid ceil(H / 256): dA[h] = the (b, chunk) shares in order
__global__ void __launch_bounds__(256) ssd_bwd_dA_kernel(BwdArgs a) {
  const int h = blockIdx.x * 256 + threadIdx.x;
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
      float* dcbp, float* rs, float* cs, float* pI, float* pK, float* pD,  \
      float* pbc, float* ep, float* dap, int B, int S, int H, int P, int G, \
      int N, int Q, int in_bf16, int dt_bf16, int init_bf16,               \
      cudaStream_t stream)

// Arguments of every pass: the forward's operands x (B,S,H,P), dt (B,S,H),
// A (H,), Bm and Cm (B,S,G,N); dy (B,S,H,P) in x's dtype; dfinal
// (B,H,P,N) float32 or null; the forward's scratch dts and cum
// (B,H,nc,QP), cb (B,nc,G,QP,QP) and S_in (B,H,nc,P,N) after its five
// passes; the gradients dx, ddt, dA (H,) float32, dB, dC and dinit (or
// null) in their operands' dtypes; the scratch dst (B,H,nc,P,N), dcbp
// (HS,B,nc,G,QP,QP), rs and cs (B,H,nc,QP/64,QP), pI (NH,B,H,nc,QP), pK
// and pD (B,H,nc,QP), pbc (2,HS,B,nc,QP,G,N), ep (B,H,nc,ceil(P*N/1024))
// and dap (B,H,nc), float32; nc = ceil(S/Q), QP = Q rounded up to 64, HS
// = min(H/G, 4) head slices, NH = ceil(N/64). P <= 64, N <= 128, 1 <= Q
// <= 256, H % G == 0, B <= 65535, nc G <= 65535, in_bf16 the library's
// (BWD_BF16_LIB). The passes run in order: dstates, state_passing, dcb,
// dx, heads, sum, dbc, ddt, dA.
#define BWD_ARGS                                                            \
  if (B == 0 || H == 0) return 0;                                           \
  if (P < 1 || P > SSD_BWD_PMAX || N < 1 || N > SSD_BWD_NMAX || Q < 1 ||    \
      Q > SSD_BWD_QMAX || S < 1 || G < 1 || H % G != 0 || B > 65535 ||      \
      (int64_t)((S + Q - 1) / Q) * G > 65535 || in_bf16 != BWD_BF16_LIB)    \
    return -1;                                                              \
  const int QP = (Q + SSD_BWD_T - 1) / SSD_BWD_T * SSD_BWD_T;               \
  const int nc = (S + Q - 1) / Q;                                           \
  auto al = [](const void* p) { return ((uintptr_t)p % 16) == 0; };         \
  const int lanes = in_bf16 ? 8 : 4;                                        \
  const BwdArgs a{x,  dt,  A,  Bm, Cm, dy, dfinal, dts, cum, cb, s_in, dx,   \
                  ddt, dA, dB, dC, dinit, dst, dcbp, rs, cs, pI, pK, pD,    \
                  pbc, ep, dap, B, S, H, P, G, N, Q, QP, nc, QP / SSD_BWD_T,\
                  (P * N + SSD_BWD_SLICE - 1) / SSD_BWD_SLICE,              \
                  H / G < SSD_BWD_HSMAX ? H / G : SSD_BWD_HSMAX,            \
                  (N + SSD_BWD_T - 1) / SSD_BWD_T,                          \
                  in_bf16, dt_bf16, init_bf16,                              \
                  P % lanes == 0 && al(x) && al(dy),                        \
                  N % lanes == 0 && al(Bm) && al(Cm),                       \
                  N % 4 == 0 && al(dst) && al(s_in)};

// passes 2, 6, 8 and 9 of a library
#define SSD_BWD_SHARED_PASSES                                               \
  BWD_PASS(ssd_bwd_state_passing) {                                         \
    BWD_ARGS                                                                \
    ssd_bwd_state_passing_kernel<<<dim3(a.nsl * H, B), 256, 0, stream>>>(a); \
    return (int)cudaGetLastError();                                         \
  }                                                                         \
  BWD_PASS(ssd_bwd_sum) {                                                   \
    BWD_ARGS                                                                \
    if (a.HS == 1) return 0;                                                \
    if ((int64_t)B * a.nc > 65535) return -1;                               \
    const int64_t most = (int64_t)QP * G * (QP > N ? QP : N);               \
    ssd_bwd_sum_kernel<<<dim3((unsigned)((most + 1023) / 1024), B * a.nc,   \
                              3), 256, 0, stream>>>(a);                     \
    return (int)cudaGetLastError();                                         \
  }                                                                         \
  BWD_PASS(ssd_bwd_ddt) {                                                   \
    BWD_ARGS                                                                \
    ssd_bwd_ddt_kernel<<<dim3(H * a.nc, B), QP, 0, stream>>>(a);            \
    return (int)cudaGetLastError();                                         \
  }                                                                         \
  BWD_PASS(ssd_bwd_dA) {                                                    \
    BWD_ARGS                                                                \
    ssd_bwd_dA_kernel<<<(H + 255) / 256, 256, 0, stream>>>(a);              \
    return (int)cudaGetLastError();                                         \
  }
