// The backward pass of causal and/or sliding-window GQA attention (kernel
// K3's gradient), for Hopper (sm_90a), in float32 on the CUDA cores.
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
// (lse, (B,H,Sq) float32, from csrc/flash_attention.cu) standing in for
// the softmax's max and sum:
//   (a) delta = rowsum(dO * O) per (b, h, q) row;
//   (b) dK, dV: one block per (kv tile, kv head, batch). The block walks
//       the R = H/G query heads of its group and the q tiles the mask lets
//       through, recomputes S = scale Q K^T and P = exp(S - lse), and
//       accumulates dV += P^T dO and dK += scale dS^T Q with dP = dO V^T
//       and dS = P (dP - delta). Each kv head's dK and dV are written once
//       by the block that owns them: the sum over the R heads of GQA is
//       inside the block, there are no atomics, and the result does not
//       depend on the launch;
//   (c) dQ: one block per (q tile, head, batch), dQ = scale sum dS K over
//       the kv tiles the mask lets through (the forward's own tile range).
// A row that sees no key (lse = +inf from the forward) gets P = 0: no
// gradient to its q and nothing to dk and dv.
//
// Bound: operations. At qwen1.5-0.5b's training shape (B=4, S=2048,
// H=G=16, D=64, causal) the five products of the gradient over the causal
// half are 2.5 times the forward's 34.4 GFLOP; (b) and (c) recompute S and
// dP each, seven products in all. This first version runs them in float32
// on the CUDA cores (67 TFLOP/s on an H100 SXM): 64-row tiles staged in
// shared memory (widened from bfloat16 as they land), each thread a 4 x 4
// block of S and dP and a 4 x (D/16) block of its outputs. Moving the
// products onto the tensor cores in 3xTF32, as the forward does, is the
// next step (ROADMAP, Queue 2).
//
// Accuracy: every product and sum is float32 (fmaf chains), P through
// expf; kernels/flash_attention.py:bwd_error_bound states the bound
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
#define TILE 64               // q and kv rows of a tile
#define THREADS 256           // 16 x 16 threads: a 4 x 4 block of a tile
#define SP_T (TILE + 1)       // floats per row of a (q, kv) tile

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
__global__ void __launch_bounds__(THREADS) fa_bwd_delta(BwdArgs a) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
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

// rows [r0, r0 + TILE) of one head of a (B, S, heads, D) tensor, widened
// into tile[TILE][DP + 1]; zeros past S and D
template <typename In, int DP>
__device__ __forceinline__ void load_rows(float* tile, const In* base,
                                          int64_t row_stride, int r0, int S,
                                          int D) {
  for (int i = threadIdx.x; i < TILE * DP; i += THREADS) {
    const int r = i / DP, d = i % DP, s = r0 + r;
    tile[r * (DP + 1) + d] =
        (s < S && d < D) ? widen(base[(int64_t)s * row_stride + d]) : 0.f;
  }
}

// lse and delta of q rows [q0, q0 + TILE) of head h; +inf and 0 past Sq
__device__ __forceinline__ void load_stats(float* lse_s, float* del_s,
                                           const BwdArgs& a, int b, int h,
                                           int q0) {
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const int qp = q0 + i;
    const int64_t at = ((int64_t)b * a.H + h) * a.Sq + qp;
    lse_s[i] = qp < a.Sq ? a.lse[at] : INFINITY;
    del_s[i] = qp < a.Sq ? a.delta[at] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T at the thread's rows i = ty + 16 r and
// columns j = tx + 16 c of the (q tile, kv tile), then P = exp(scale S -
// lse) where the mask lets the key through (else 0) and dS = P (dP -
// delta), written to ps (if given) and dss as [i][j]
template <int DP>
__device__ __forceinline__ void probs(const float* Qt, const float* dOt,
                                      const float* Kt, const float* Vt,
                                      const float* lse_s, const float* del_s,
                                      float* ps, float* dss, int q0, int k0,
                                      const BwdArgs& a) {
  constexpr int SP = DP + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qa[r] = Qt[(ty + 16 * r) * SP + d];
      oa[r] = dOt[(ty + 16 * r) * SP + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kb[c] = Kt[(tx + 16 * c) * SP + d];
      vb[c] = Vt[(tx + 16 * c) * SP + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
        dp[r][c] = fmaf(oa[r], vb[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const float lse = lse_s[i], del = del_s[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const float p =
          visible(q0 + i, k0 + j, a) ? expf(s[r][c] * a.scale - lse) : 0.f;
      if (ps) ps[i * SP_T + j] = p;
      dss[i * SP_T + j] = p * (dp[r][c] - del);
    }
  }
}

// the shared memory of (b) and (c), in floats: four row tiles (K, V, Q,
// dO), P and dS, lse and delta
template <int DP>
constexpr size_t smem_floats() {
  return 4 * (size_t)TILE * (DP + 1) + 2 * (size_t)TILE * SP_T + 2 * TILE;
}

// (b) dK and dV of kv rows [k0, k0 + TILE) of kv head g in batch b
template <typename In, int DP>
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_dkdv(BwdArgs a) {
  constexpr int SP = DP + 1, NC = DP / 16;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;
  float* Vt = Kt + TILE * SP;
  float* Qt = Vt + TILE * SP;
  float* dOt = Qt + TILE * SP;
  float* ps = dOt + TILE * SP;
  float* dss = ps + TILE * SP_T;
  float* lse_s = dss + TILE * SP_T;
  float* del_s = lse_s + TILE;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * TILE, g = blockIdx.y, b = blockIdx.z;
  const int R = a.H / a.G, D = a.D;
  const int64_t q_row = (int64_t)a.H * D, kv_row = (int64_t)a.G * D;
  const In* kb = (const In*)a.k + ((int64_t)b * a.Skv * a.G + g) * D;
  const In* vb = (const In*)a.v + ((int64_t)b * a.Skv * a.G + g) * D;
  load_rows<In, DP>(Kt, kb, kv_row, k0, a.Skv, D);
  load_rows<In, DP>(Vt, vb, kv_row, k0, a.Skv, D);

  // the q rows any key of this tile is visible to
  const int k_last = min(k0 + TILE, a.Skv) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.Sq - 1, k_last + a.window - 1)
                                : a.Sq - 1;

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int hr = 0; hr < R && q_lo <= q_hi; ++hr) {
    const int h = g * R + hr;
    const In* qb = (const In*)a.q + ((int64_t)b * a.Sq * a.H + h) * D;
    const In* ob = (const In*)a.dout + ((int64_t)b * a.Sq * a.H + h) * D;
    for (int q0 = q_lo / TILE * TILE; q0 <= q_hi; q0 += TILE) {
      __syncthreads();                  // the last tile's readers are done
      load_rows<In, DP>(Qt, qb, q_row, q0, a.Sq, D);
      load_rows<In, DP>(dOt, ob, q_row, q0, a.Sq, D);
      load_stats(lse_s, del_s, a, b, h, q0);
      __syncthreads();
      probs<DP>(Qt, dOt, Kt, Vt, lse_s, del_s, ps, dss, q0, k0, a);
      __syncthreads();
      // dV[j][d] += P[i][j] dO[i][d], dK[j][d] += dS[i][j] Q[i][d] at
      // the thread's rows j = ty + 16 r and columns d = tx + 16 c
#pragma unroll 4
      for (int i = 0; i < TILE; ++i) {
        float pj[4], dsj[4], od[NC], qd[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pj[r] = ps[i * SP_T + ty + 16 * r];
          dsj[r] = dss[i * SP_T + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          od[c] = dOt[i * SP + tx + 16 * c];
          qd[c] = Qt[i * SP + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[r][c] = fmaf(pj[r], od[c], dv[r][c]);
            dk[r][c] = fmaf(dsj[r], qd[c], dk[r][c]);
          }
      }
    }
  }

  In* dkb = (In*)a.dk + ((int64_t)b * a.Skv * a.G + g) * D;
  In* dvb = (In*)a.dv + ((int64_t)b * a.Skv * a.G + g) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty + 16 * r;
    if (kp >= a.Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      dkb[kp * kv_row + d] = narrow<In>(dk[r][c] * a.scale);
      dvb[kp * kv_row + d] = narrow<In>(dv[r][c]);
    }
  }
}

// (c) dQ of q rows [q0, q0 + TILE) of head h in batch b
template <typename In, int DP>
__global__ void __launch_bounds__(THREADS, 1) fa_bwd_dq(BwdArgs a) {
  constexpr int SP = DP + 1, NC = DP / 16;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;
  float* Vt = Kt + TILE * SP;
  float* Qt = Vt + TILE * SP;
  float* dOt = Qt + TILE * SP;
  float* dss = dOt + TILE * SP;
  float* lse_s = dss + TILE * SP_T;
  float* del_s = lse_s + TILE;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.G), D = a.D;
  const int64_t q_row = (int64_t)a.H * D, kv_row = (int64_t)a.G * D;
  const In* qb = (const In*)a.q + ((int64_t)b * a.Sq * a.H + h) * D;
  const In* ob = (const In*)a.dout + ((int64_t)b * a.Sq * a.H + h) * D;
  const In* kb = (const In*)a.k + ((int64_t)b * a.Skv * a.G + kvh) * D;
  const In* vb = (const In*)a.v + ((int64_t)b * a.Skv * a.G + kvh) * D;
  load_rows<In, DP>(Qt, qb, q_row, q0, a.Sq, D);
  load_rows<In, DP>(dOt, ob, q_row, q0, a.Sq, D);
  load_stats(lse_s, del_s, a, b, h, q0);

  // the kv range any row of this tile can see (the forward's)
  const int q_last = min(q0 + TILE, a.Sq) - 1;
  const int k_hi = a.causal ? min(a.Skv - 1, q_last) : a.Skv - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float dq[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;

  for (int k0 = k_lo / TILE * TILE; k0 <= k_hi; k0 += TILE) {
    __syncthreads();                    // the last tile's readers are done
    load_rows<In, DP>(Kt, kb, kv_row, k0, a.Skv, D);
    load_rows<In, DP>(Vt, vb, kv_row, k0, a.Skv, D);
    __syncthreads();
    probs<DP>(Qt, dOt, Kt, Vt, lse_s, del_s, nullptr, dss, q0, k0, a);
    __syncthreads();
    // dQ[i][d] += dS[i][j] K[j][d] at the thread's rows i = ty + 16 r and
    // columns d = tx + 16 c
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float dsi[4], kd[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsi[r] = dss[(ty + 16 * r) * SP_T + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kd[c] = Kt[j * SP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[r][c] = fmaf(dsi[r], kd[c], dq[r][c]);
    }
  }

  In* dqb = (In*)a.dq + ((int64_t)b * a.Sq * a.H + h) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty + 16 * r;
    if (qp >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dqb[qp * q_row + d] = narrow<In>(dq[r][c] * a.scale);
    }
  }
}

template <typename K>
static int raise_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename In, int DP>
static int launch(const BwdArgs& a, cudaStream_t stream) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.H;
  const int64_t warps = THREADS / 32;
  int e = 0;
  if (rows > 0) {
    fa_bwd_delta<In><<<(unsigned)((rows + warps - 1) / warps), THREADS, 0,
                       stream>>>(a);
    if ((e = (int)cudaGetLastError())) return e;
  }
  const size_t smem = smem_floats<DP>() * sizeof(float);
  if ((e = raise_smem(fa_bwd_dkdv<In, DP>, smem))) return e;
  if ((e = raise_smem(fa_bwd_dq<In, DP>, smem))) return e;
  // with Sq = 0 the dK/dV blocks see no query and write zeros
  dim3 kv_grid((a.Skv + TILE - 1) / TILE, a.G, a.B);
  fa_bwd_dkdv<In, DP><<<kv_grid, THREADS, smem, stream>>>(a);
  if ((e = (int)cudaGetLastError())) return e;
  if (a.Sq == 0) return 0;
  dim3 q_grid((a.Sq + TILE - 1) / TILE, a.H, a.B);
  fa_bwd_dq<In, DP><<<q_grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
// D <= 128, H % G == 0, Skv >= 1. Returns a cudaError_t (0 on success);
// -1 for a D the kernel does not take.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int H, int G,
                                   int D, int causal, int window, int bf16_in,
                                   float scale, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  BwdArgs a{q,  k,  v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, G, D,
            causal, window, scale};
  return bf16_in ? launch_dims<bf16>(a, stream)
                 : launch_dims<float>(a, stream);
}
