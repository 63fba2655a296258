// What K4's two forward libraries share (csrc/ssd_scan.cu, float32 x, B
// and C; csrc/ssd_scan_bf16.cu, bfloat16 ones): the arguments every pass
// takes, the chunk cumsum (pass 1) and the state passing (pass 4), which
// are elementwise over float32 scratch and read x's dtype nowhere, and the
// plain C entry points' signature. Each library compiles its own copy.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"

#define SSD_T 64              // rows of a t or s tile; chunks are padded to it
#define SSD_PMAX 64           // head dim P
#define SSD_NMAX 128          // state dim N
#define SSD_QMAX 256          // chunk length Q

struct SsdArgs {
  const void* x;              // (B,S,H,P), float or bf16 as Bm, Cm and y
  const void* dt;             // (B,S,H), float or bf16 (dt_bf16)
  const float* A;             // (H,)
  const void* Bm;             // (B,S,G,N)
  const void* Cm;             // (B,S,G,N)
  const void* init;           // (B,H,P,N), float or bf16 (init_bf16), or
                              // null: zeros
  void* y;                    // (B,S,H,P)
  float* state;               // (B,H,P,N)
  float* dts;                 // (B,H,nc,QP) scratch: dt, zeros past the chunk
  float* cum;                 // (B,H,nc,QP) scratch: inclusive cumsum of dt*A
  float* cb;                  // (B,nc,G,QP,QP) scratch: C.B^T, lower tiles
  float* states;              // (B,H,nc,P,N) scratch: upd_c, then S_in[c]
  int B, S, H, P, G, N, Q, QP, nc;
  int vec;                    // 16-byte copies of x, y, B, C and state rows
  int dt_bf16, init_bf16;
};

__device__ __forceinline__ float load_dt(const SsdArgs& a, int64_t i) {
  return a.dt_bf16 ? widen(((const bf16*)a.dt)[i]) : ((const float*)a.dt)[i];
}

__device__ __forceinline__ float load_init(const SsdArgs& a, int64_t i) {
  return a.init_bf16 ? widen(((const bf16*)a.init)[i])
                     : ((const float*)a.init)[i];
}

__device__ __forceinline__ int chunk_len(const SsdArgs& a, int c) {
  return (int)min((int64_t)a.Q, (int64_t)a.S - (int64_t)c * a.Q);
}

// ---------------------------------------------------------------- 1 ----
// grid (nc * H, B), QP threads: dt and the inclusive cumsum of dt * A
// (a warp shuffle scan, then the warps' totals added in order)
__global__ void ssd_cumsum_kernel(SsdArgs a) {
  __shared__ float wsum[SSD_QMAX / 32];
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int64_t c0 = (int64_t)c * a.Q;
  const int len = chunk_len(a, c);
  const float d = i < len ? load_dt(a, ((int64_t)b * a.S + c0 + i) * a.H + h)
                          : 0.f;
  float v = d * a.A[h];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += wsum[w];
  const int64_t o = (((int64_t)b * a.H + h) * a.nc + c) * a.QP + i;
  a.cum[o] = off + v;
  a.dts[o] = d;
}

// ---------------------------------------------------------------- 4 ----
// grid (ceil(P*N / (256 V)) * H, B), 256 threads of V elements each
// (V = 4: float4 rows): S_in over the chunks in order, written over upd_c;
// the final state. The loads of CG chunks are in flight together.
template <int V>
__global__ void __launch_bounds__(256) ssd_state_passing_kernel(SsdArgs a) {
  constexpr int CG = 8;
  const int nv = a.P * a.N / V, per = (nv + 255) / 256;
  const int h = blockIdx.x / per, b = blockIdx.y;
  const int e = (blockIdx.x % per) * 256 + threadIdx.x;
  if (e >= nv) return;
  const int64_t bh = (int64_t)b * a.H + h;
  const int64_t pn = (int64_t)a.P * a.N;
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    s[v] = a.init != nullptr ? load_init(a, bh * pn + (int64_t)V * e + v)
                             : 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += CG) {
    float u[CG][V], tot[CG];
#pragma unroll
    for (int k = 0; k < CG; ++k) {
      if (c0 + k >= a.nc) break;
      const int64_t bhc = bh * a.nc + c0 + k;
      tot[k] = a.cum[bhc * a.QP + a.QP - 1];
      const float* src = a.states + bhc * pn + (int64_t)V * e;
      if constexpr (V == 4) {
        const float4 f = *(const float4*)src;
        u[k][0] = f.x; u[k][1] = f.y; u[k][2] = f.z; u[k][3] = f.w;
      } else {
        u[k][0] = src[0];
      }
    }
#pragma unroll
    for (int k = 0; k < CG; ++k) {
      if (c0 + k >= a.nc) break;
      float* dst = a.states + (bh * a.nc + c0 + k) * pn + (int64_t)V * e;
      if constexpr (V == 4) *(float4*)dst = make_float4(s[0], s[1], s[2], s[3]);
      else dst[0] = s[0];
      const float d = expf(tot[k]);
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] = fmaf(d, s[v], u[k][v]);
    }
  }
  float* out = a.state + bh * pn + (int64_t)V * e;
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = s[v];
}

// ------------------------------------------------------------ launch ----
template <typename K>
static int raise_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// false for a shape the kernels do not take, or for operands of the
// other library's dtype (in_bf16 must be `bf16_lib`)
static bool make_args(SsdArgs& a, const void* x, const void* dt,
                      const float* A, const void* Bm, const void* Cm,
                      const void* init, void* y, float* state, float* dts,
                      float* cum, float* cb, float* states, int B, int S,
                      int H, int P, int G, int N, int Q, int in_bf16,
                      int dt_bf16, int init_bf16, int bf16_lib) {
  if (P < 1 || P > SSD_PMAX || N < 1 || N > SSD_NMAX || Q < 1 ||
      Q > SSD_QMAX || S < 1 || G < 1 || H % G != 0 || B > 65535 ||
      in_bf16 != bf16_lib)
    return false;
  const int QP = (Q + SSD_T - 1) / SSD_T * SSD_T;
  const int nc = (S + Q - 1) / Q;
  auto al = [](const void* p) { return ((uintptr_t)p % 16) == 0; };
  const int lanes = in_bf16 ? 8 : 4;          // values in 16 bytes
  const int vec = P % lanes == 0 && N % lanes == 0 && al(x) && al(Bm) &&
                  al(Cm) && al(y) && al(states);
  a = SsdArgs{x, dt, A, Bm, Cm, init, y, state, dts, cum, cb, states,
              B, S, H, P, G, N, Q, QP, nc, vec, dt_bf16, init_bf16};
  return true;
}

static int launch_cumsum(const SsdArgs& a, cudaStream_t stream) {
  ssd_cumsum_kernel<<<dim3(a.nc * a.H, a.B), a.QP, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_state_passing(const SsdArgs& a, cudaStream_t stream) {
  // float4 rows where P * N is a multiple of 4 and the state in is aligned
  if ((a.P * a.N) % 4 == 0 && ((uintptr_t)a.init % 16) == 0) {
    const int per = (a.P * a.N / 4 + 255) / 256;
    ssd_state_passing_kernel<4><<<dim3(per * a.H, a.B), 256, 0, stream>>>(a);
  } else {
    const int per = (a.P * a.N + 255) / 256;
    ssd_state_passing_kernel<1><<<dim3(per * a.H, a.B), 256, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

#define SSD_PASS(name)                                                      \
  extern "C" int name(const void* x, const void* dt, const float* A,       \
                      const void* Bm, const void* Cm, const void* init,    \
                      void* y, float* state, float* dts, float* cum,       \
                      float* cb, float* states, int B, int S, int H, int P, \
                      int G, int N, int Q, int in_bf16, int dt_bf16,       \
                      int init_bf16, cudaStream_t stream)

// Arguments of every pass: x (B,S,H,P), dt (B,S,H), A (H,), Bm and Cm
// (B,S,G,N), init (B,H,P,N) or null, y (B,S,H,P), state (B,H,P,N), and
// the scratch dts and cum (B,H,nc,QP), cb (B,nc,G,QP,QP) and states
// (B,H,nc,P,N), nc = ceil(S/Q), QP = Q rounded up to 64; all contiguous
// on the device, float32 except x, Bm, Cm and y, bfloat16 with in_bf16
// (which must be the library's: BF16_LIB), dt with dt_bf16 and init with
// init_bf16. P <= 64, N <= 128, 1 <= Q <= 256, H % G == 0, B <= 65535.
// The passes run in order: cumsum, bmm, chunk_state, state_passing,
// chunk_scan.
#define SSD_ARGS                                                            \
  if (B == 0 || H == 0) return 0;                                           \
  SsdArgs a;                                                                \
  if (!make_args(a, x, dt, A, Bm, Cm, init, y, state, dts, cum, cb, states, \
                 B, S, H, P, G, N, Q, in_bf16, dt_bf16, init_bf16,          \
                 BF16_LIB))                                                 \
    return -1;

// passes 1 and 4 of a library that defines BF16_LIB
#define SSD_SHARED_PASSES                                                   \
  SSD_PASS(ssd_cumsum) {                                                    \
    SSD_ARGS                                                                \
    return launch_cumsum(a, stream);                                        \
  }                                                                         \
  SSD_PASS(ssd_state_passing) {                                             \
    SSD_ARGS                                                                \
    return launch_state_passing(a, stream);                                 \
  }
