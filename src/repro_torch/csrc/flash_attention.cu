// Causal and/or sliding-window GQA attention in float32, for Hopper
// (sm_90a): the online-softmax ("flash") forward pass.
//
// Replaces: repro/kernels/flash_attention.py:_kernel (Pallas, TPU),
// called through flash_attention. Same function: q (B,Sq,H,D), k and v
// (B,Skv,G,D) with head h reading kv head h / (H/G); scale D^-0.5; fp32
// running max, sum and accumulator; masked scores set to -1e30, padded
// keys (the ragged edge past Skv) masked the same way; the output is
// acc / max(l, 1e-30).
//
// Design. The TPU grid (B, H, q tile, kv tile) runs its kv axis in order
// on one core and carries the softmax state in VMEM scratch. Here one
// block of 128 threads owns one (b, h, 64-row q tile) and walks the kv
// tiles in a loop that stands in for that sequential axis. The q tile
// (scaled) and each k tile are staged transposed in shared memory, v and
// the probabilities row-major; the running max, sum and the output
// accumulator stay in registers. Thread (ty, tx) of the 16 x 8 layout
// owns rows 4ty..4ty+3 of the tile, score columns tx + 8j and output
// columns tx + 8j; a row's 8 owners are neighbouring lanes of one warp,
// so its max and sum reduce with three shuffles. D is padded with zeros
// to DP in {16, 32, 64, 128} (a template), so any D up to 128 runs.
//
// The block skips whole kv tiles that the causal or window mask rules
// out for all its rows. K3 visits them, but a fully masked tile adds
// exp(-1e30 - m) = 0 to a row that has seen a visible key, and a row that
// has not yet seen one carries m = -1e30 and takes p = 1 terms that the
// first visible key washes out (corr = exp(-1e30 - m) = 0), so skipping
// changes no row that has a visible key. A row with no visible key at all
// is outside K3's contract (its value there depends on the block size);
// here it is 0.
//
// Bound: operations. At the main path's prefill (B=4, S=2048, H=16,
// D=64, causal) the causal half of QK^T and PV is 2 * 2*D*S*(S+1)/2
// FLOPs per (b, h), 34.4 GFLOP, against 34 MB of q, k, v and o: far
// above the card's ridge point, and on the FP32 CUDA cores (not TF32,
// so the numbers are the reference's function) the floor is that over
// about 67 TFLOP/s on an H100 SXM. Present limits (work for a later
// change): shared-memory loads are scalar (12 loads for 32 FMAs in both
// inner products); no tensor cores, no cp.async or TMA double buffering;
// the last q tile of a short sequence is mostly idle.
//
// Interface: plain C, loaded with ctypes. flash_attention_fwd() launches
// on the given stream, does not synchronise, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BQ 64                 // q rows per block
#define BK 64                 // kv rows per tile
#define THREADS 128           // 16 row groups x 8 column lanes
#define TSTRIDE (BQ + 1)      // transposed tiles [DP][TSTRIDE]: no bank conflicts
#define PSTRIDE (BK + 2)      // probabilities [BQ][PSTRIDE]: rows 4 apart hit other banks
#define NEG_INF (-1e30f)
#define FULL_MASK 0xffffffffu

struct FaArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, Sq, Skv, H, G, D;
  int causal;
  int window;                 // <= 0: no window
  float scale;
};

static size_t smem_bytes(int dp) {
  return sizeof(float) *
         ((size_t)2 * dp * TSTRIDE + (size_t)BK * dp + (size_t)BQ * PSTRIDE);
}

template <int DP>
__global__ void __launch_bounds__(THREADS) fa_fwd_kernel(FaArgs a) {
  constexpr int NJ = DP / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                     // [DP][TSTRIDE], q * scale
  float* Kt = Qt + DP * TSTRIDE;        // [DP][TSTRIDE]
  float* Vs = Kt + DP * TSTRIDE;        // [BK][DP]
  float* Ps = Vs + BK * DP;             // [BQ][PSTRIDE]

  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int D = a.D;
  const int64_t q_row = (int64_t)a.H * D;      // elements between q rows
  const int64_t kv_row = (int64_t)a.G * D;
  const float* qb = a.q + ((int64_t)b * a.Sq * a.H + h) * D;
  const float* kb = a.k + ((int64_t)b * a.Skv * a.G + g) * D;
  const float* vb = a.v + ((int64_t)b * a.Skv * a.G + g) * D;
  float* ob = a.o + ((int64_t)b * a.Sq * a.H + h) * D;

  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP, d = i % DP, s = q0 + r;
    Qt[d * TSTRIDE + r] = (s < a.Sq && d < D) ? qb[s * q_row + d] * a.scale
                                              : 0.f;
  }

  // the kv range any row of this tile can see
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_hi = a.causal ? min(a.Skv - 1, q_last) : a.Skv - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();          // the last tile's Vs and Ps are consumed
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int r = i / DP, d = i % DP, s = k0 + r;
      const bool in = s < a.Skv && d < D;
      Kt[d * TSTRIDE + r] = in ? kb[s * kv_row + d] : 0.f;
      Vs[r * DP + d] = in ? vb[s * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * TSTRIDE + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Kt[d * TSTRIDE + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        bool ok = kpos < a.Skv;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      rs += __shfl_xor_sync(FULL_MASK, rs, 1);
      rs += __shfl_xor_sync(FULL_MASK, rs, 2);
      rs += __shfl_xor_sync(FULL_MASK, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ps[(ty * 4 + i) * PSTRIDE + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PSTRIDE + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * DP + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 8 * j;
      if (d < D) ob[qpos * q_row + d] = acc[i][j] / denom;
    }
  }
}

template <int DP>
static int launch(const FaArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  fa_fwd_kernel<DP><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// q (B,Sq,H,D), k and v (B,Skv,G,D), o (B,Sq,H,D), all contiguous
// float32 on the device. D <= 128, H % G == 0, Skv >= 1. Returns a
// cudaError_t (0 on success); -1 for a D the kernel does not take.
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* o, int B, int Sq,
                                   int Skv, int H, int G, int D, int causal,
                                   int window, float scale,
                                   cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  FaArgs a{q, k, v, o, B, Sq, Skv, H, G, D, causal, window, scale};
  if (D <= 16) return launch<16>(a, stream);
  if (D <= 32) return launch<32>(a, stream);
  if (D <= 64) return launch<64>(a, stream);
  if (D <= 128) return launch<128>(a, stream);
  return -1;
}
