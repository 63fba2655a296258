// Causal and/or sliding-window GQA attention at float32 accuracy on the
// tensor cores (3xTF32), for Hopper (sm_90a): the online-softmax
// ("flash") forward pass.
//
// Replaces: repro/kernels/flash_attention.py:_kernel (Pallas, TPU),
// called through flash_attention. Same function: q (B,Sq,H,D), k and v
// (B,Skv,G,D) with head h reading kv head h / (H/G); scale D^-0.5; fp32
// running max, sum and accumulator; masked scores set to -1e30, padded
// keys (the ragged edge past Skv) masked the same way; the output is
// acc / max(l, 1e-30).
//
// Log-sum-exp. On request (a non-null lse, (B,H,Sq) float32) the epilogue
// also writes each row's log-sum-exp of its scaled scores, m + log(l) with
// m the running max kept in the scaled domain (q is scaled before the
// walk): the backward (csrc/flash_attention_bwd.cu) recomputes P as
// exp(scale q k - lse). The kernel is compiled both ways (the LSE
// template flag), so without it the serve path's code is unchanged.
//
// Bound: operations. At the main path's prefill (B=4, S=2048, H=16,
// D=64, causal) the causal half of QK^T and PV is 34.4 GFLOP against
// 34 MB of q, k, v and o. 3xTF32 runs three TF32 products for each
// float32 one, so the floor is 3 x 34.4 GFLOP over the 495 TFLOP/s dense
// TF32 peak of an H100 SXM.
//
// 3xTF32. Every operand x is split into big = tf32_rna(x) and small =
// tf32_rna(x - big); a product is big*big + big*small + small*big,
// accumulated in float32 (the small*small term and the residuals drop
// about 3 * 2^-22 of |a||b|). Both products use it: S = (q * scale) K^T
// and O += P V. kernels/flash_attention.py:error_bound states the bound.
//
// Operands: q, k and v all float32, or all bfloat16 (the models' default
// compute dtype). A bfloat16 operand is widened to float32 as its tile
// lands, and everything after the load is the float32 kernel's: the
// 3xTF32 splits (a widened bfloat16 splits exactly, small half 0), the
// float32 accumulators and softmax. The output is written in the
// operands' type (bfloat16 rounded to nearest even). bfloat16 k and v
// tiles come through registers (16-byte loads, 8 values each, widened
// and stored to the float32 staging buffer), issued after the tile's S
// product so that the loads overlap it.
//
// Design. One block owns one (b, h, q tile) and walks the kv tiles in a
// loop that stands in for the TPU grid's sequential kv axis. A
// warpgroup (4 warps) owns 64 q rows; a block holds two (128 rows that
// share each kv tile) for sequences of 256 rows and more at D <= 64, one
// otherwise (the Transform's 16-row calls do not pay for a 128-row tile).
// - Both products are wgmma.mma_async m64nNk8 .tf32 (sm_90a): S = q K^T
//   with q and K from shared memory (N = the kv tile), O += P V with P
//   from registers and V from shared memory (N = D padded to 16, 32, 64
//   or 128). tf32 wgmma reads shared operands K-major only, so q and K
//   are stored with d contiguous and V transposed, (d, kv), all as 8 x 4
//   word core matrices without swizzle (descriptors: LBO steps along K,
//   SBO along M or N).
// - K and V tiles (64 kv rows, 32 at D = 128) come through a 2-stage ring
//   of float32 staging buffers filled by cp.async (16-byte copies where
//   D % 4 == 0 and the bases are aligned, else 4-byte ones; zero-fill past
//   Skv and D; bfloat16: 16-byte loads where D % 8 == 0 and the bases are
//   aligned, else one value at a time), the next tile in flight while the
//   block computes on this one. As a tile lands the block splits each
//   element once into big and small, writing the core-matrix layouts
//   with 16-byte stores (8 lanes
//   fill one core matrix and read 8 staged rows: no bank conflicts), and
//   fences the stores for wgmma's asynchronous reads. q is scaled and
//   split once, before the walk.
// - P goes from the score accumulators into the PV product as they stand:
//   an m64nN accumulator holds columns 2t, 2t+1 where the A fragment holds
//   k = t, t+4, so the PV product takes its summation index k = t as kv
//   2t and k = t + 4 as kv 2t + 1, and V's kv order within each 8 is
//   permuted to match.
// - The online softmax stays in float32 registers as before: row max by
//   two xor-shuffles over the 4 lanes of a row, per-lane partial sums
//   reduced at the end.
//
// The block skips kv tiles that the causal or window mask rules out for
// all its rows, and a warpgroup skips those ruled out for its 64 rows. K3
// visits them, but a fully masked tile adds exp(-1e30 - m) = 0 to a row
// that has seen a visible key, and a row that has not yet seen one
// carries m = -1e30 and takes p = 1 terms that the first visible key
// washes out (corr = exp(-1e30 - m) = 0), so skipping changes no row
// that has a visible key. A row with no visible key at all (its running
// max never leaves -1e30) is outside K3's contract when no log-sum-exp is
// asked for (its value there depends on the block size, as the TPU
// kernel's does); with the log-sum-exp it is written as 0 with lse =
// +inf, and the backward gives it P = 0: no gradient, nothing to dk and
// dv.
//
// Interface: plain C, loaded with ctypes. flash_attention_fwd() launches
// on the given stream, does not synchronise, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"

#define NEG_INF (-1e30f)
#define FULL_MASK 0xffffffffu

struct FaArgs {
  const void* q;              // float or bf16, as k, v and o
  const void* k;
  const void* v;
  void* o;
  float* lse;                 // (B, H, Sq) or null
  int B, Sq, Skv, H, G, D;
  int causal;
  int window;                 // <= 0: no window
  float scale;
  int vec;                    // 16-byte copies of k and v rows
};

// Shared memory of one block, in 32-bit words. Q (A of S), K (B of S) and
// V (B of PV) are stored split, big and small apart, as core matrices
// (8 rows x 4 words) in K-major order: word i of a split tile is element
// (row, col) with cm = i / 32 the core matrix, row = 8 (cm % rows/8) +
// (i / 4) % 8 and col = 4 (cm / (rows/8)) + i % 4. V is stored as
// (d, kv), its kv permuted within each 8 so that a k step's k = t, t + 4
// are keys 2t, 2t + 1 (see the PV product).
template <int DP, int BK, int WG>
struct Tiles {
  static constexpr int BQ = 64 * WG;
  static constexpr int SP = DP + 4;           // floats per staged kv row
  static constexpr int STAGE = 2 * BK * SP;   // floats of a stage (K, V)
  static constexpr int Q_WORDS = BQ * DP;
  static constexpr int KV_WORDS = BK * DP;
  static constexpr int SPLIT = 4 * KV_WORDS;  // K big, K small, V big, V small
  static constexpr size_t bytes() {
    return 4 * ((size_t)2 * Q_WORDS + 2 * (size_t)STAGE + (size_t)SPLIT);
  }
};

// cp.async of kv rows [k0, k0 + BK) of k and v into a staging stage
template <int DP, int BK, int THREADS, int SP>
__device__ __forceinline__ void load_tile(float* st, const float* kb,
                                          const float* vb, int64_t kv_row,
                                          int k0, const FaArgs& a) {
  float* ks = st;
  float* vs = st + BK * SP;
  if (a.vec) {
    constexpr int CH = DP / 4;
    for (int i = threadIdx.x; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, s = k0 + r;
      const bool ok = s < a.Skv && 4 * c < a.D;
      const int64_t off = ok ? s * kv_row + 4 * c : 0;
      cp_async16(ks + r * SP + 4 * c, kb + off, ok ? 16 : 0);
      cp_async16(vs + r * SP + 4 * c, vb + off, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BK * DP; i += THREADS) {
      const int r = i / DP, d = i % DP, s = k0 + r;
      const bool ok = s < a.Skv && d < a.D;
      const int64_t off = ok ? s * kv_row + d : 0;
      cp_async4(ks + r * SP + d, kb + off, ok ? 4 : 0);
      cp_async4(vs + r * SP + d, vb + off, ok ? 4 : 0);
    }
  }
}

// bfloat16 kv rows [k0, k0 + BK) of k and v, widened into a staging stage
// (the same float32 layout): every 16-byte load of the thread issued
// before the first store
template <int DP, int BK, int THREADS, int SP>
__device__ __forceinline__ void load_tile(float* st, const bf16* kb,
                                          const bf16* vb, int64_t kv_row,
                                          int k0, const FaArgs& a) {
  float* ks = st;
  float* vs = st + BK * SP;
  if (a.vec) {
    constexpr int CH = DP / 8;
    constexpr int PER = (BK * CH + THREADS - 1) / THREADS;
    uint4 ku[PER], vu[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CH, c = i % CH, s = k0 + r;
      const bool ok = i < BK * CH && s < a.Skv && 8 * c < a.D;
      const int64_t off = ok ? s * kv_row + 8 * c : 0;
      ku[j] = ok ? ld16(kb + off) : make_uint4(0u, 0u, 0u, 0u);
      vu[j] = ok ? ld16(vb + off) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= BK * CH) break;
      const int r = i / CH, c = i % CH;
      store_widened8(ks + r * SP + 8 * c, ku[j]);
      store_widened8(vs + r * SP + 8 * c, vu[j]);
    }
  } else {
    for (int i = threadIdx.x; i < BK * DP; i += THREADS) {
      const int r = i / DP, d = i % DP, s = k0 + r;
      const bool ok = s < a.Skv && d < a.D;
      const int64_t off = ok ? s * kv_row + d : 0;
      ks[r * SP + d] = ok ? widen(kb[off]) : 0.f;
      vs[r * SP + d] = ok ? widen(vb[off]) : 0.f;
    }
  }
}

// Split the staged tile into `dst` (K big, K small, V big, V small), each
// element once, 4 at a time: a thread takes 4 words of one core-matrix
// row and writes them with one 16-byte store each for big and small;
// K's 4 are one staged float4 (kv, d..d+3), V's the keys 2p + h of one
// d. 8 lanes fill one core matrix and read 8 staged rows: no bank
// conflicts either side. The stores are fenced for wgmma's reads.
template <int DP, int BK, int THREADS>
__device__ __forceinline__ void split_tile(const float* stage,
                                           uint32_t* dst) {
  using T = Tiles<DP, BK, 1>;
  constexpr int SP = T::SP, NB = BK / 8, DB = DP / 8, W = T::KV_WORDS;
  const float* ks = stage;
  const float* vs = stage + BK * SP;
#pragma unroll 2
  for (int i = threadIdx.x; i < W / 4; i += THREADS) {
    const int cm = i >> 3, row = i & 7;
    const int kv = 8 * (cm % NB) + row, dq = cm / NB;
    const float4 x = *(const float4*)(ks + kv * SP + 4 * dq);
    uint4 big, small;
    split(x.x, big.x, small.x);
    split(x.y, big.y, small.y);
    split(x.z, big.z, small.z);
    split(x.w, big.w, small.w);
    *(uint4*)(dst + 4 * i) = big;
    *(uint4*)(dst + W + 4 * i) = small;
    const int jh = cm / DB;
    const int d = 8 * (cm % DB) + row;
    const float* vc = vs + (8 * (jh >> 1) + (jh & 1)) * SP + d;
    split(vc[0], big.x, small.x);
    split(vc[2 * SP], big.y, small.y);
    split(vc[4 * SP], big.z, small.z);
    split(vc[6 * SP], big.w, small.w);
    *(uint4*)(dst + 2 * W + 4 * i) = big;
    *(uint4*)(dst + 3 * W + 4 * i) = small;
  }
  fence_async_smem();
}

template <typename In, int DP, int BK, int WG, bool LSE>
__global__ void __launch_bounds__(WG * 128, 1) fa_fwd_kernel(FaArgs a) {
  using T = Tiles<DP, BK, WG>;
  constexpr int THREADS = WG * 128;
  constexpr int BQ = T::BQ, SP = T::SP;
  constexpr int MB = BQ / 8, NB = BK / 8, DB = DP / 8;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* Qb = smem;                                  // A of S, big
  uint32_t* Qs = Qb + T::Q_WORDS;                       // ... small
  float* stage = (float*)(Qs + T::Q_WORDS);             // [2][K, V][BK][SP]
  uint32_t* Kb = (uint32_t*)(stage + 2 * T::STAGE);     // the split tile
  uint32_t* Ks = Kb + T::KV_WORDS;
  uint32_t* Vb = Ks + T::KV_WORDS;
  uint32_t* Vs = Vb + T::KV_WORDS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.G);
  const int D = a.D;
  const int64_t q_row = (int64_t)a.H * D;      // elements between q rows
  const int64_t kv_row = (int64_t)a.G * D;
  const In* qb = (const In*)a.q + ((int64_t)b * a.Sq * a.H + h) * D;
  const In* kb = (const In*)a.k + ((int64_t)b * a.Skv * a.G + kvh) * D;
  const In* vb = (const In*)a.v + ((int64_t)b * a.Skv * a.G + kvh) * D;
  In* ob = (In*)a.o + ((int64_t)b * a.Sq * a.H + h) * D;

  // the kv range any row of this block can see
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_hi = a.causal ? min(a.Skv - 1, q_last) : a.Skv - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = k_lo / BK;
  const int n_tiles = k_hi >= k_lo ? k_hi / BK - t_first + 1 : 0;

  if (n_tiles > 0)
    load_tile<DP, BK, THREADS, SP>(stage, kb, vb, kv_row, t_first * BK, a);
  cp_commit();
  if (n_tiles > 1)
    load_tile<DP, BK, THREADS, SP>(stage + T::STAGE, kb, vb, kv_row,
                                   (t_first + 1) * BK, a);
  cp_commit();

  // q tile, scaled, split once into the A layout
  for (int i = threadIdx.x; i < T::Q_WORDS; i += THREADS) {
    const int cm = i >> 5;
    const int r = 8 * (cm % MB) + ((i >> 2) & 7);
    const int d = 4 * (cm / MB) + (i & 3);
    const int row = q0 + r;
    const float x =
        (row < a.Sq && d < D) ? widen(qb[row * q_row + d]) * a.scale : 0.f;
    split(x, Qb[i], Qs[i]);
  }
  fence_async_smem();

  // this warpgroup's 64 rows; this thread's rows g and g + 8 of its warp's 16
  const int wq = q0 + 64 * wg;
  const int wq_last = min(wq + 63, a.Sq - 1);
  const bool wg_live = wq < a.Sq;
  const int row0 = wq + 16 * wl + g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait_all_but_one();            // tile it has landed ...
    __syncthreads();                  // ... for every thread; K, V free
    split_tile<DP, BK, THREADS>(stage + (it & 1) * T::STAGE, Kb);
    __syncthreads();                  // split tile ready; stage it & 1 free

    // tile it + 2: float32 tiles by cp.async before this tile's products;
    // bfloat16 tiles by loads through registers once the S product is
    // issued, so that they overlap it (a warpgroup that skips the tile
    // loads its share at once)
    constexpr bool LOAD_AFTER_S = sizeof(In) == 2;
    const bool more = it + 2 < n_tiles;
    float* next = stage + (it & 1) * T::STAGE;
    const int k_next = (t_first + it + 2) * BK;
    const int k0 = (t_first + it) * BK;
    const bool skip = !wg_live || (a.causal && k0 > wq_last) ||
                      (a.window > 0 && k0 + BK - 1 <= wq - a.window);
    if (!LOAD_AFTER_S || skip) {
      if (more)
        load_tile<DP, BK, THREADS, SP>(next, kb, vb, kv_row, k_next, a);
      cp_commit();
    }
    if (skip) continue;

    // S = q K^T for the warpgroup's 64 rows: per k step, small*big,
    // big*small, big*big
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    pin(sc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks) {
      if (8 * ks >= D) break;
      const int qa = (2 * ks * MB + 8 * wg) * 32, kk = 2 * ks * NB * 32;
      const uint64_t qbd = smem_desc(Qb + qa, MB * 128, 128);
      const uint64_t qsd = smem_desc(Qs + qa, MB * 128, 128);
      const uint64_t kbd = smem_desc(Kb + kk, NB * 128, 128);
      const uint64_t ksd = smem_desc(Ks + kk, NB * 128, 128);
      wgmma_ss<BK>(sc, qsd, kbd);
      wgmma_ss<BK>(sc, qbd, ksd);
      wgmma_ss<BK>(sc, qbd, kbd);
    }
    wg_commit();
    if (LOAD_AFTER_S && more)
      load_tile<DP, BK, THREADS, SP>(next, kb, vb, kv_row, k_next, a);
    wg_wait_all();
    pin(sc);

    // online softmax; sc[4j + 2r + c] is row row0 + 8r, key k0 + 8j + 2t + c
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + 8 * j + 2 * t + c;
          bool ok = kpos < a.Skv;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && kpos > qpos - a.window;
          if (!ok) sc[4 * j + 2 * r + c] = NEG_INF;
          mx = fmaxf(mx, sc[4 * j + 2 * r + c]);
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

    // O += P V: k step j takes keys k0 + 8j + {2t, 2t + 1} as k = t, t + 4,
    // so P's A fragment is the score accumulator as it stands
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      split(sc[4 * j + 0], pb[j][0], ps[j][0]);
      split(sc[4 * j + 2], pb[j][1], ps[j][1]);
      split(sc[4 * j + 1], pb[j][2], ps[j][2]);
      split(sc[4 * j + 3], pb[j][3], ps[j][3]);
    }
    pin(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int vv = 2 * j * DB * 32;
      const uint64_t vbd = smem_desc(Vb + vv, DB * 128, 128);
      const uint64_t vsd = smem_desc(Vs + vv, DB * 128, 128);
      wgmma_rs<DP>(o, ps[j], vbd);
      wgmma_rs<DP>(o, pb[j], vsd);
      wgmma_rs<DP>(o, pb[j], vbd);
    }
    wg_commit();
    wg_wait_all();
    pin(o);
  }

  if (!wg_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(FULL_MASK, lr, 1);
    lr += __shfl_xor_sync(FULL_MASK, lr, 2);
    const int qpos = row0 + 8 * r;
    if (qpos >= a.Sq) continue;
    // a row that has seen no visible key: 0 and lse = +inf where the
    // log-sum-exp is written; the serve path's epilogue stays as it was
    // (the select slowed its float32 forward by about 2%: PERF.md, §6)
    const bool blind = LSE && !(m[r] > NEG_INF);
    const float inv = blind ? 0.f : 1.f / fmaxf(lr, 1e-30f);
    if (LSE && t == 0)
      a.lse[((int64_t)b * a.H + h) * a.Sq + qpos] =
          blind ? INFINITY : m[r] + logf(lr);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + 2 * t + c;
        if (d < D)
          ob[qpos * q_row + d] = narrow<In>(o[4 * n + 2 * r + c] * inv);
      }
  }
}

template <typename In, int DP, int WG, bool LSE>
static int launch_lse(const FaArgs& a, cudaStream_t stream) {
  constexpr int BK = DP == 128 ? 32 : 64;
  auto kern = fa_fwd_kernel<In, DP, BK, WG, LSE>;
  const size_t smem = Tiles<DP, BK, WG>::bytes();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.Sq + 64 * WG - 1) / (64 * WG), a.H, a.B);
  kern<<<grid, WG * 128, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the kernel with the log-sum-exp's stores compiled in only where asked
template <typename In, int DP, int WG>
static int launch(const FaArgs& a, cudaStream_t stream) {
  return a.lse ? launch_lse<In, DP, WG, true>(a, stream)
               : launch_lse<In, DP, WG, false>(a, stream);
}

template <typename In, int DP>
static int launch_rows(const FaArgs& a, cudaStream_t stream) {
  // two warpgroups (128 q rows) share each kv tile; short sequences, and
  // D = 128 (whose shared memory holds one), take one
  if (DP < 128 && a.Sq >= 256) return launch<In, DP, 2>(a, stream);
  return launch<In, DP, 1>(a, stream);
}

template <typename In>
static int launch_dims(const FaArgs& a, cudaStream_t stream) {
  if (a.D <= 16) return launch_rows<In, 16>(a, stream);
  if (a.D <= 32) return launch_rows<In, 32>(a, stream);
  if (a.D <= 64) return launch_rows<In, 64>(a, stream);
  if (a.D <= 128) return launch_rows<In, 128>(a, stream);
  return -1;
}

// q (B,Sq,H,D), k and v (B,Skv,G,D), o (B,Sq,H,D), all contiguous on the
// device, all float32 (bf16 = 0) or all bfloat16 (bf16 = 1); lse (B,H,Sq)
// float32, or null for no log-sum-exp. D <= 128,
// H % G == 0, Skv >= 1. Returns a cudaError_t (0 on success); -1 for a
// D the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int B, int Sq,
                                   int Skv, int H, int G, int D, int causal,
                                   int window, int bf16_in, float scale,
                                   cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const int lanes = bf16_in ? 8 : 4;          // values in 16 bytes
  const int vec = D % lanes == 0 && ((uintptr_t)k % 16) == 0 &&
                  ((uintptr_t)v % 16) == 0;
  FaArgs a{q, k, v, o, lse, B, Sq, Skv, H, G, D, causal, window, scale, vec};
  return bf16_in ? launch_dims<bf16>(a, stream)
                 : launch_dims<float>(a, stream);
}
