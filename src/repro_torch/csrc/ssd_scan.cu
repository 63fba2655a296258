// The Mamba2 SSD chunked scan in float32, for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssd.py:_kernel (Pallas, TPU), called through
// ssd_scan, with the model path's signature (repro/models/ssd.py:
// ssd_scan): the state may come in (init_state) and the final state goes
// out. For each (b, h) with group g = h / (H/G), a (P,N) state S is
// carried across chunks of Q positions; within a chunk, with
// cum_t = sum_{u<=t} dt_u * A_h (inclusive, inside the chunk):
//   y_t   = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//           + exp(cum_t) C_t . S
//   S    <- exp(cum_Q) S + sum_s exp(cum_Q - cum_s) dt_s x_s (x) B_s
// Positions past S are the reference's padding: dt = 0 and x = B = C = 0,
// so they decay the state by exp(0) = 1 and add nothing.
//
// Design. The TPU grid (B, H, chunk) runs its chunk axis in order on one
// core and keeps the state in VMEM scratch. Here one block of 256 threads
// owns one (b, h) and walks the chunks in a loop that stands in for that
// sequential axis; the state stays in shared memory for the whole walk
// (64 x 128 floats, 32 KB). Per chunk:
//   1. dt and the inclusive cumsum of dt * A over the chunk's (at most
//      256) positions, one per thread: a warp shuffle scan, then the
//      warps' totals added in order;
//   2. for each 64-row t tile: the inter part exp(cum_t) C_t . S^T from
//      the state entering the chunk, then for each 64-row s tile with
//      s <= t (tiles above the diagonal are skipped) the scores
//      C_t . B_s^T, masked BEFORE the exp (exp(cum_t - cum_s) for s > t
//      can overflow, and inf * 0 is NaN), weighted by dt_s, and times
//      the x_s tile;
//   3. the state update from every s tile of the chunk.
// Each product is a 64 x 64 (or 64 x 128) output tile, 4 x 4 (4 x 8)
// per thread of a 16 x 16 layout; tiles are row-major with rows padded
// by one float, so a half-warp's 16 column lanes hit 16 banks and the
// two row groups of a warp read broadcasts. P and N are zero-padded to
// 64 and 128 and any chunk length up to 256 runs: rows of a tile past
// the chunk or the sequence are zeros and are not written.
//
// Bound: operations. At the serve prefill of mamba2-370m (B=4, S=2048,
// H=32, P=64, G=1, N=128, Q=256) the necessary work is about 13.2 GFLOP
// (the causal half of C.B^T once per (b, g, chunk), the causal half of
// the scores times x, C . state and the state update, per head) against
// about 148 MB of x, y, B, C, dt and the state: far above the ridge
// point, so on the FP32 CUDA cores (not TF32, so the numbers are the
// reference's function) the floor is that over about 67 TFLOP/s on an
// H100 SXM. This kernel does more: it computes C . B^T again for every
// head of a group and its diagonal tiles in full, about 24.6 GFLOP at
// that shape. B*H = 128 blocks are one wave on 132 SMs at one block per
// SM (131 KB of shared memory each). Present limits (work for a later
// change): C . B^T per head, scalar shared-memory loads (8 loads per 16
// FMAs in the score and PV products), 8 warps per SM, no tensor cores,
// no cp.async or TMA double buffering, one sequential walk per (b, h)
// (a two-pass design would compute chunk states in parallel).
//
// Interface: plain C, loaded with ctypes. ssd_scan_fwd() launches on the
// given stream, does not synchronise, and returns cudaGetLastError() (or
// the error of raising the shared-memory limit).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define T 64                  // rows per t and s tile
#define PMAX 64               // head dim P, zero-padded
#define NMAX 128              // state dim N, zero-padded
#define QMAX 256              // chunk length Q: one position per thread
#define THREADS 256           // 16 row groups x 16 column lanes
#define NS (NMAX + 1)         // row stride of the C, B and state tiles
#define SS (T + 1)            // row stride of the score tile
#define FULL_MASK 0xffffffffu

struct SsdArgs {
  const float* x;             // (B,S,H,P)
  const float* dt;            // (B,S,H)
  const float* A;             // (H,)
  const float* Bm;            // (B,S,G,N)
  const float* Cm;            // (B,S,G,N)
  const float* init;          // (B,H,P,N) or null: zeros
  float* y;                   // (B,S,H,P)
  float* state;               // (B,H,P,N)
  int B, S, H, P, G, N, Q;
};

static size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * T * NS + (size_t)PMAX * NS +
                          (size_t)T * PMAX + (size_t)T * SS + 2 * QMAX + 8);
}

__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  float* Cs = smem;                     // [T][NS]     C rows of the t tile
  float* Bs = Cs + T * NS;              // [T][NS]     B rows of the s tile
  float* St = Bs + T * NS;              // [PMAX][NS]  the state
  float* Xs = St + PMAX * NS;           // [T][PMAX]   x rows of the s tile
  float* Sc = Xs + T * PMAX;            // [T][SS]     weighted scores
  float* cum = Sc + T * SS;             // [QMAX]
  float* dts = cum + QMAX;              // [QMAX]
  float* wsum = dts + QMAX;             // [8]         warp totals

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int P = a.P, N = a.N, Q = a.Q;
  const float A = a.A[h];
  const int64_t x_row = (int64_t)a.H * P;      // elements between positions
  const int64_t bc_row = (int64_t)a.G * N;
  const float* xb = a.x + (int64_t)b * a.S * x_row + (int64_t)h * P;
  float* yb = a.y + (int64_t)b * a.S * x_row + (int64_t)h * P;
  const float* dtb = a.dt + (int64_t)b * a.S * a.H + h;
  const float* Bb = a.Bm + (int64_t)b * a.S * bc_row + (int64_t)g * N;
  const float* Cb = a.Cm + (int64_t)b * a.S * bc_row + (int64_t)g * N;
  const int64_t st_off = ((int64_t)b * a.H + h) * P * N;

  for (int i = tid; i < PMAX * NMAX; i += THREADS) {
    const int p = i / NMAX, n = i % NMAX;
    St[p * NS + n] = (a.init != nullptr && p < P && n < N)
                         ? a.init[st_off + (int64_t)p * N + n] : 0.f;
  }

  const int nc = (a.S + Q - 1) / Q;
  const int ntiles = (Q + T - 1) / T;
  for (int c = 0; c < nc; ++c) {
    const int64_t c0 = (int64_t)c * Q;
    const int len = (int)min((int64_t)Q, (int64_t)a.S - c0);

    // 1. dt and the inclusive cumsum of dt * A (zeros past len)
    const float d = tid < len ? dtb[(c0 + tid) * a.H] : 0.f;
    float v = d * A;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL_MASK, v, o);
      if (lane >= o) v += u;
    }
    __syncthreads();          // the last chunk's readers of cum are done
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float off = 0.f;
    for (int w = 0; w < warp; ++w) off += wsum[w];
    cum[tid] = off + v;
    dts[tid] = d;
    __syncthreads();
    const float total = cum[QMAX - 1];       // flat past len

    // 2. y, one 64-row t tile at a time
    for (int tt = 0; tt < ntiles; ++tt) {
      const int t0 = tt * T;
      if (t0 >= len) break;
      __syncthreads();        // the last tile's readers of Cs are done
      for (int i = tid; i < T * NMAX; i += THREADS) {
        const int r = i / NMAX, n = i % NMAX, row = t0 + r;
        Cs[r * NS + n] = (row < len && n < N)
                             ? Cb[(c0 + row) * bc_row + n] : 0.f;
      }
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      // inter: C_t . S^T over the state entering the chunk
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(cum[t0 + ty * 4 + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // intra: the s tiles on and below the diagonal
      for (int st = 0; st <= tt; ++st) {
        const int s0 = st * T;
        __syncthreads();      // the last s tile's readers are done
        for (int i = tid; i < T * NMAX; i += THREADS) {
          const int r = i / NMAX, n = i % NMAX, row = s0 + r;
          Bs[r * NS + n] = (row < len && n < N)
                               ? Bb[(c0 + row) * bc_row + n] : 0.f;
        }
        for (int i = tid; i < T * PMAX; i += THREADS) {
          const int r = i / PMAX, p = i % PMAX, row = s0 + r;
          Xs[r * PMAX + p] = (row < len && p < P)
                                 ? xb[(c0 + row) * x_row + p] : 0.f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            // mask before the exp: s > t may overflow
            const float w = s <= t ? expf(cum[t] - cum[s]) * dts[s] : 0.f;
            Sc[(ty * 4 + i) * SS + tx + 16 * j] = sc[i][j] * w;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int s = 0; s < T; ++s) {
          float pv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = Sc[(ty * 4 + i) * SS + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[s * PMAX + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        if (t >= len) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yb[(c0 + t) * x_row + p] = acc[i][j];
        }
      }
    }

    // 3. the state update: S <- exp(total) S + sum_s xs_s (x) B_s with
    //    xs_s = x_s exp(total - cum_s) dt_s; thread (ty, tx) owns rows
    //    p = 4ty..4ty+3 and columns n = tx + 16j
    float sa[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sa[i][j] = 0.f;
    for (int st = 0; st < ntiles; ++st) {
      const int s0 = st * T;
      if (s0 >= len) break;
      __syncthreads();        // the last tile's readers of Bs, Xs are done
      for (int i = tid; i < T * NMAX; i += THREADS) {
        const int r = i / NMAX, n = i % NMAX, row = s0 + r;
        Bs[r * NS + n] = (row < len && n < N)
                             ? Bb[(c0 + row) * bc_row + n] : 0.f;
      }
      for (int i = tid; i < T * PMAX; i += THREADS) {
        const int r = i / PMAX, p = i % PMAX, row = s0 + r;
        Xs[r * PMAX + p] =
            (row < len && p < P)
                ? xb[(c0 + row) * x_row + p] *
                      (expf(total - cum[row]) * dts[row])
                : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < T; ++s) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[s * PMAX + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bs[s * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) sa[i][j] = fmaf(xv[i], bv[j], sa[i][j]);
      }
    }
    __syncthreads();          // every t tile's reads of St are done
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* s = &St[(ty * 4 + i) * NS + tx + 16 * j];
        *s = fmaf(et, *s, sa[i][j]);
      }
    __syncthreads();
  }

  float* out = a.state + st_off;
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i % N;
    out[i] = St[p * NS + n];
  }
}

// x (B,S,H,P), dt (B,S,H), A (H,), Bm and Cm (B,S,G,N), init (B,H,P,N) or
// null, y (B,S,H,P), state (B,H,P,N), all contiguous float32 on the
// device. P <= 64, N <= 128, 1 <= Q <= 256, H % G == 0, B <= 65535.
// Returns a cudaError_t (0 on success); -1 for a shape the kernel does
// not take.
extern "C" int ssd_scan_fwd(const float* x, const float* dt, const float* A,
                            const float* Bm, const float* Cm,
                            const float* init, float* y, float* state, int B,
                            int S, int H, int P, int G, int N, int Q,
                            cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (P < 1 || P > PMAX || N < 1 || N > NMAX || Q < 1 || Q > QMAX ||
      G < 1 || H % G != 0 || B > 65535)
    return -1;
  const size_t smem = smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  SsdArgs a{x, dt, A, Bm, Cm, init, y, state, B, S, H, P, G, N, Q};
  ssd_scan_kernel<<<dim3(H, B), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
