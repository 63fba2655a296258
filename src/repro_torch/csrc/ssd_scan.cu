// The Mamba2 SSD chunked scan at float32 accuracy on the tensor cores
// (3xTF32), for Hopper (sm_90a), in five passes.
//
// Replaces: repro/kernels/ssd.py:_kernel (Pallas, TPU), called through
// ssd_scan, with the model path's signature (repro/models/ssd.py:
// ssd_scan): the state may come in (init_state) and the final state goes
// out. For each (b, h) with group g = h / (H/G), a (P,N) state S is
// carried across chunks of Q positions; within chunk c, with
// cum_t = sum_{u<=t} dt_u * A_h (inclusive, inside the chunk) and
// total_c = cum_{Q-1}:
//   y_t   = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//           + exp(cum_t) C_t . S_in[c]
//   S_in[c+1] = exp(total_c) S_in[c]
//               + sum_s exp(total_c - cum_s) dt_s x_s (x) B_s
// Positions past S are the reference's padding: dt = 0 and x = B = C = 0,
// so they decay the state by exp(0) = 1 and add nothing.
//
// Bound: operations. At the serve prefill of mamba2-370m (B=4, S=2048,
// H=32, P=64, G=1, N=128, Q=256) the necessary work is 13.17 GFLOP (the
// causal half of C.B^T once per (b, g, chunk), the causal half of the
// weights times x, C . S_in and the state update, per head) against about
// 148 MB of x, y, B, C, dt and the state. 3xTF32 runs three TF32 products
// for each float32 one, so the floor is 3 x 13.17 GFLOP over the 495
// TFLOP/s dense TF32 peak of an H100 SXM.
//
// Design: the layout of the Mamba2 authors' GPU kernels (chunk cumsum,
// C.B^T per group, chunk states, state passing, chunk scan). The TPU grid
// walks the chunks of one (b, h) in order with the state in VMEM; here
// only the state passing (pass 4, elementwise) is serial over chunks, and
// every product runs for all chunks at once.
//   1. ssd_cumsum: dt and cum per (b, h, chunk) into (B,H,nc,QP) scratch
//      (QP = Q rounded up to 64; padding has dt = 0 and a flat cum). Every
//      later pass reads these, so all agree on every decay exponent.
//   2. ssd_bmm: CB = C_c . B_c^T once per (b, chunk, g), the 64 x 64 tiles
//      on and below the diagonal only, into (B,nc,G,QP,QP) scratch; the
//      heads of a group read it from L2.
//   3. ssd_chunk_state: upd_c = sum_s (x_s exp(total_c - cum_s) dt_s) (x)
//      B_s per (b, h, chunk), a (Q x N)^T.(Q x P) product (K = s), into
//      the (B,H,nc,P,N) states scratch.
//   4. ssd_state_passing: S_in[c] over the chunks in order, elementwise
//      over (b, h, p, n), written over upd_c in place; the final state.
//   5. ssd_chunk_scan: per (b, h, chunk, 64-row t tile), the inter term
//      exp(cum_t) C_t . S_in[c]^T, then the s tiles on and below the
//      diagonal: W = CB[t,s] exp(cum_t - cum_s) dt_s, masked BEFORE the
//      exp (s > t may overflow, and inf * 0 is NaN), times x_s. The t
//      tiles of one (b, h, chunk) run side by side, the heaviest first.
// Every product is wgmma.mma_async m64nNk8 .tf32 in 3xTF32 (see
// hopper.cuh): each operand x is split into big = tf32(x) and small =
// tf32(x - big) and a product is small*big + big*small + big*big,
// accumulated in float32; the split is integer arithmetic on the bits
// (split_bits: cvt.rna's rounding without the conversions).
// kernels/ssd.py:error_bound states the bound.
// - One warpgroup (128 threads) per block in pass 2, two in passes 3 and
//   5 (more warps to hide the latency of the splits). Operand
//   tiles come through a 2-stage ring of float32 staging buffers filled
//   by cp.async (16-byte copies where P and N are multiples of 4 and the
//   bases are aligned; zero-fill past the chunk, P and N): the next
//   step's tile is in flight while the block multiplies this one.
// - Operands: x, B and C float32 (bfloat16 ones take
//   csrc/ssd_scan_bf16.cu, which keeps them bfloat16 to the tensor
//   cores), dt float32, A float32, the state in float32 or bfloat16; y,
//   the final state and the scratch in float32. The chunk cumsum and the
//   state passing (passes 1 and 4) are csrc/ssd_common.cuh's, shared with
//   the bfloat16 library.
// - tf32 wgmma reads shared operands K-major only, as core matrices of 8
//   rows x 4 words without swizzle (K3's layout and descriptors). C, B
//   and S_in are stored with the K index (n) contiguous and split as they
//   stand; x (s, p) has the K index s strided, so passes 3 and 5
//   transpose it as they split it (pass 3 scaling it by its decay, pass
//   5 with K3's V permutation: a k step's k = t, t + 4 are positions 2t,
//   2t + 1).
// - The register operand, split in registers: pass 5's weights W, formed
//   from the staged CB tile (a float2 per lane and row, which the
//   permutation makes the A fragment), and C in its inter steps; pass
//   3's B (rows n, K = s), read from the staged chunk as it stands. In
//   pass 3 each warpgroup owns 64 of the state's n rows; in pass 5 the
//   two take halves of each step's K and add their sums at the end.
// Shared memory per block: pass 2 69 KB (3 blocks per SM), pass 3 71 KB
// and pass 5 106 KB (2 blocks of 256 threads, at most 128 registers a
// thread).
//
// Interface: plain C, loaded with ctypes. Every pass takes the same
// arguments, launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (or the error of raising the shared-memory
// limit); -1 for a shape the kernels do not take.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "hopper.cuh"
#include "ssd_common.cuh"
#include "ssd_tiles.cuh"

#define BF16_LIB 0            // x, B and C in float32 only

#define T 64                  // rows of a t or s tile; the wgmma M
#define PMAX 64               // head dim P, zero-padded: wgmma N of y, upd^T
#define NMAX 128              // state dim N, zero-padded: 2 x 64 rows of upd^T
#define QMAX 256              // chunk length Q
#define KC 32                 // n per step of the C.B^T product
#define KI 64                 // n per step of the C.S_in product
#define SC 32                 // positions per step of the chunk states
#define THREADS 128           // one warpgroup (pass 2)
#define THREADS2 256          // two warpgroups (passes 3 and 5)
#define SPK (KC + 4)          // staged row stride of a K-contiguous chunk
#define SPI (KI + 4)          // ... of C and S_in in the chunk scan
#define SPT (T + 8)           // of a staged CB or x tile (float2 reads of CB)
#define SPB (NMAX + 8)        // of a staged B chunk (pass 3's A fragments)
static_assert(KI == T, "an inter step's split S_in is as large as x's");

// acc (m64n64) += A . B^T over one KC-wide step: A and B are split 64 x KC
// K-major tiles at sa and sb (big, then small)
__device__ __forceinline__ void nt_step(float (&acc)[32], const uint32_t* sa,
                                        const uint32_t* sb) {
  constexpr int W = T * KC;
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {
    const int o = 2 * ks * (T / 8) * 32;
    const uint64_t ab = smem_desc(sa + o, (T / 8) * 128, 128);
    const uint64_t as = smem_desc(sa + W + o, (T / 8) * 128, 128);
    const uint64_t bb = smem_desc(sb + o, (T / 8) * 128, 128);
    const uint64_t bs = smem_desc(sb + W + o, (T / 8) * 128, 128);
    wgmma_ss_n64(acc, as, bb);
    wgmma_ss_n64(acc, ab, bs);
    wgmma_ss_n64(acc, ab, bb);
  }
}

// ---------------------------------------------------------------- 2 ----
// grid (tiles * nc * G, B): CB tile (ti, si), si <= ti, of chunk c and
// group g; K = n in steps of KC through the ring
template <typename In>
__global__ void __launch_bounds__(THREADS) ssd_bmm_kernel(SsdArgs a) {
  extern __shared__ __align__(128) uint32_t smem[];
  constexpr int STAGE = 2 * T * SPK;
  float* stage = (float*)smem;                          // [2][C, B][T][SPK]
  uint32_t* sp = smem + 2 * STAGE;                      // C split, B split
  const int ntri = (a.QP / T) * (a.QP / T + 1) / 2;
  const int tile = blockIdx.x % ntri, rest = blockIdx.x / ntri;
  const int g = rest % a.G, c = rest / a.G, b = blockIdx.y;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int si = tile - ti * (ti + 1) / 2;
  const int len = chunk_len(a, c);
  if (ti * T >= len) return;                 // past the chunk: never read
  const int64_t ld = (int64_t)a.G * a.N;
  const int64_t c0 = (int64_t)c * a.Q;
  const In* cs =
      (const In*)a.Cm + ((int64_t)b * a.S + c0 + ti * T) * ld + g * a.N;
  const In* bs =
      (const In*)a.Bm + ((int64_t)b * a.S + c0 + si * T) * ld + g * a.N;
  const int c_rows = min(T, len - ti * T), b_rows = min(T, len - si * T);
  const int steps = (a.N + KC - 1) / KC;
  auto load = [&](int it, float* st) {
    const int k0 = it * KC;
    load_tile<THREADS, T, KC, SPK>(st, cs + k0, ld, c_rows, a.N - k0,
                                   a.vec);
    load_tile<THREADS, T, KC, SPK>(st + T * SPK, bs + k0, ld, b_rows,
                                   a.N - k0, a.vec);
  };

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
    split_rows<THREADS, T, KC, SPK>(st, sp);
    split_rows<THREADS, T, KC, SPK>(st + T * SPK, sp + 2 * T * KC);
    fence_async_smem();
    __syncthreads();
    pin(acc);
    wg_fence();
    nt_step(acc, sp, sp + 2 * T * KC);
    wg_commit();
    if (it + 2 < steps) load(it + 2, st);
    cp_commit();
    wg_wait_all();
    pin(acc);
  }

  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
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
// grid (H * nc, B), two warpgroups: upd_c^T (N x P) = sum_s B_s (x) x'_s,
// x'_s = x_s exp(total_c - cum_s) dt_s; M = n (warpgroup w: n in [64w,
// 64w + 64)), N = p, K = s in steps of SC. B is the register operand
// (read from the staged chunk as it stands), x' the shared one, scaled
// and transposed as it is split.
template <typename In>
__global__ void __launch_bounds__(THREADS2, 2)
    ssd_chunk_state_kernel(SsdArgs a) {
  extern __shared__ __align__(128) uint32_t smem[];
  constexpr int XS = SC * SPT, STAGE = XS + SC * SPB;
  float* stage = (float*)smem;                          // [2][x, B]
  uint32_t* sp = smem + 2 * STAGE;                      // x' split (p, s)
  float* wv = (float*)(sp + 2 * PMAX * SC);             // [QP] decay * dt
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, bld = (int64_t)a.G * a.N;
  const In* xs =
      (const In*)a.x + ((int64_t)b * a.S + c0) * xld + (int64_t)h * a.P;
  const In* bs = (const In*)a.Bm + ((int64_t)b * a.S + c0) * bld + g * a.N;
  const int64_t v0 = (((int64_t)b * a.H + h) * a.nc + c) * a.QP;
  const float total = a.cum[v0 + a.QP - 1];
  for (int i = threadIdx.x; i < a.QP; i += THREADS2)
    wv[i] = expf(total - a.cum[v0 + i]) * a.dts[v0 + i];
  const int steps = (len + SC - 1) / SC;
  auto load = [&](int it, float* st) {
    const int s0 = it * SC;
    load_tile<THREADS2, SC, PMAX, SPT>(st, xs + s0 * xld, xld, len - s0, a.P,
                                       a.vec);
    load_tile<THREADS2, SC, NMAX, SPB>(st + XS, bs + s0 * bld, bld, len - s0,
                                       a.N, a.vec);
  };

  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int lane = tw & 31, wl = tw >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n0 = 64 * wg + 16 * wl + g8;     // this thread's rows n0, n0 + 8
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  load(0, stage);
  cp_commit();
  if (steps > 1) load(1, stage + STAGE);
  cp_commit();
  for (int it = 0; it < steps; ++it) {
    float* st = stage + (it & 1) * STAGE;
    const int s0 = it * SC;
    cp_wait_all_but_one();
    __syncthreads();
    split_cols<THREADS2, PMAX, SC, SPT, false, true>(st, sp, wv + s0);
    fence_async_smem();
    __syncthreads();
    // A fragment of k step j: (n0, s0 + 8j + t4), (n0 + 8, ...),
    // (n0, s0 + 8j + t4 + 4), (n0 + 8, ...)
    uint32_t ab[SC / 8][4], as[SC / 8][4];
#pragma unroll
    for (int j = 0; j < SC / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_bits(
            st[XS + (8 * j + t4 + 4 * (q >> 1)) * SPB + n0 + 8 * (q & 1)],
            ab[j][q], as[j][q]);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < SC / 8; ++j) {
      const int o = 2 * j * (PMAX / 8) * 32;
      const uint64_t xb = smem_desc(sp + o, (PMAX / 8) * 128, 128);
      const uint64_t xsd = smem_desc(sp + PMAX * SC + o, (PMAX / 8) * 128, 128);
      wgmma_rs_n64(acc, as[j], xb);
      wgmma_rs_n64(acc, ab[j], xsd);
      wgmma_rs_n64(acc, ab[j], xb);
    }
    wg_commit();
    __syncthreads();                  // every read of stage it & 1 is done
    if (it + 2 < steps) load(it + 2, st);
    cp_commit();
    wg_wait_all();
    pin(acc);
  }

  // acc[4j + 2r + e] is upd[p = 8j + 2 t4 + e][n = n0 + 8r]; a store
  // instruction's lanes fill 32-byte sectors (8 consecutive n)
  float* out = a.states + (((int64_t)b * a.H + h) * a.nc + c) * a.P * a.N;
#pragma unroll
  for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 8 * j + 2 * t4 + e, n = n0 + 8 * r;
        if (p < a.P && n < a.N) out[p * a.N + n] = acc[4 * j + 2 * r + e];
      }
}

// ---------------------------------------------------------------- 5 ----
// grid (tiles * H * nc * B): y for 64 rows of one (b, h, chunk); the t
// tiles of one (b, h, chunk) are neighbours, heaviest first, so its x
// tiles and S_in are read again from L2. Every step is acc += A . B with
// A (rows t, K) in registers and B (rows p, K) split in shared memory;
// the two warpgroups take the step's k steps 0-3 and 4-7 into partial
// sums, added at the end. Steps 0 .. nk-1:
// C_t (registers) times S_in^T over KI values of n (S_in K-major as
// stored); then s tiles 0 .. tt: W (registers) times x_s (split
// transposed, with the permutation). W on a tile below the diagonal is
// cb * exp(cum_t - ref) * (exp(ref - cum_s) dt_s), ref = cum at the
// tile's last position, both factors at most 1 (the column factors once
// per step in shared memory); on the diagonal tile exp(cum_t - cum_s) is
// taken per element, masked first.
template <typename In>
__global__ void __launch_bounds__(THREADS2, 2)
    ssd_chunk_scan_kernel(SsdArgs a) {
  extern __shared__ __align__(128) uint32_t smem[];
  constexpr int STAGE = 2 * T * SPT;                    // >= 2 * T * SPI
  float* stage = (float*)smem;               // [2][CB, x] or [2][C, S_in]
  uint32_t* sp = smem + 2 * STAGE;           // S_in or x, split
  float* cumv = (float*)(sp + 2 * T * T);    // [QP]
  float* dtv = cumv + a.QP;                  // [QP]
  float* colv = dtv + a.QP;                  // [T] column factors
  const int ntiles = a.QP / T;
  const int tt = ntiles - 1 - (int)(blockIdx.x % ntiles);
  const int rest = blockIdx.x / ntiles;
  const int h = rest % a.H, c = (rest / a.H) % a.nc, b = rest / (a.H * a.nc);
  const int g = h / (a.H / a.G);
  const int len = chunk_len(a, c);
  const int t0 = tt * T;
  if (t0 >= len) return;
  const int64_t c0 = (int64_t)c * a.Q;
  const int64_t xld = (int64_t)a.H * a.P, cld = (int64_t)a.G * a.N;
  const int64_t bhc = ((int64_t)b * a.H + h) * a.nc + c;
  const In* xs =
      (const In*)a.x + ((int64_t)b * a.S + c0) * xld + (int64_t)h * a.P;
  const In* cs =
      (const In*)a.Cm + ((int64_t)b * a.S + c0 + t0) * cld + g * a.N;
  const float* ss = a.states + bhc * a.P * a.N;
  const float* cbs = a.cb + (((int64_t)b * a.nc + c) * a.G + g) * a.QP * a.QP +
                     (int64_t)t0 * a.QP;
  for (int i = threadIdx.x; i < a.QP; i += THREADS2) {
    cumv[i] = a.cum[bhc * a.QP + i];
    dtv[i] = a.dts[bhc * a.QP + i];
  }
  // S_in[0] is zero without an initial state: no inter steps
  const int nk = (c == 0 && a.init == nullptr) ? 0 : (a.N + KI - 1) / KI;
  const int steps = nk + tt + 1;
  auto load = [&](int it, float* st) {
    if (it < nk) {
      const int k0 = it * KI;
      load_tile<THREADS2, T, KI, SPI>(st, cs + k0, cld, len - t0, a.N - k0,
                                      a.vec);
      load_tile<THREADS2, T, KI, SPI>(st + T * SPI, ss + k0, a.N, a.P,
                                      a.N - k0, a.vec);
    } else {
      const int s0 = (it - nk) * T;
      load_tile<THREADS2, T, T, SPT>(st, cbs + s0, a.QP, T, T, 1);
      load_tile<THREADS2, T, PMAX, SPT>(st + T * SPT, xs + s0 * xld, xld,
                                        len - s0, a.P, a.vec);
    }
  };

  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int lane = tw & 31, wl = tw >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wl + g8;               // this thread's rows r0, r0 + 8
  const int j0 = 4 * wg;                     // its warpgroup's k steps
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  load(0, stage);
  cp_commit();
  if (steps > 1) load(1, stage + STAGE);
  cp_commit();
  for (int it = 0; it < steps; ++it) {
    float* st = stage + (it & 1) * STAGE;
    const int st_i = it - nk;                // the s tile, if >= 0
    const int s0 = st_i * T;
    cp_wait_all_but_one();
    __syncthreads();
    if (st_i < 0) {
      split_rows<THREADS2, PMAX, KI, SPI>(st + T * SPI, sp);
    } else {
      split_cols<THREADS2, PMAX, T, SPT, true>(st + T * SPT, sp);
      if (st_i < tt && threadIdx.x < T) {
        const float ref = cumv[s0 + T - 1];
        colv[threadIdx.x] = expf(ref - cumv[s0 + threadIdx.x]) *
                            dtv[s0 + threadIdx.x];
      }
    }
    fence_async_smem();
    __syncthreads();
    // A fragment of k step j0 + j (rows r0, r0 + 8):
    // inter: k = t4, t4 + 4 are n = k0 + 8 (j0 + j) + t4, + 4;
    // intra: k = t4, t4 + 4 are positions s0 + 8 (j0 + j) + 2 t4, + 1
    uint32_t ab[4][4], as[4][4];
    if (st_i < 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_bits(st[(r0 + 8 * (q & 1)) * SPI + 8 * (j0 + j) + t4 +
                        4 * (q >> 1)],
                     ab[j][q], as[j][q]);
    } else if (st_i < tt) {
      const float ref = cumv[s0 + T - 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float rf = expf(cumv[t0 + r0 + 8 * r] - ref);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sl = 8 * (j0 + j) + 2 * t4;
          const float2 v = *(const float2*)(st + (r0 + 8 * r) * SPT + sl);
          split_bits(v.x * (rf * colv[sl]), ab[j][r], as[j][r]);
          split_bits(v.y * (rf * colv[sl + 1]), ab[j][2 + r], as[j][2 + r]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + r0 + 8 * r;
        const float ct = cumv[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sl = 8 * (j0 + j) + 2 * t4;
          const float2 v = *(const float2*)(st + (r0 + 8 * r) * SPT + sl);
          const int s = s0 + sl;
          // mask before the exp: s > t may overflow
          const float w0 = s <= t ? v.x * (expf(ct - cumv[s]) * dtv[s]) : 0.f;
          const float w1 =
              s + 1 <= t ? v.y * (expf(ct - cumv[s + 1]) * dtv[s + 1]) : 0.f;
          split_bits(w0, ab[j][r], as[j][r]);
          split_bits(w1, ab[j][2 + r], as[j][2 + r]);
        }
      }
    }
    pin(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = 2 * (j0 + j) * (PMAX / 8) * 32;
      const uint64_t bb = smem_desc(sp + o, (PMAX / 8) * 128, 128);
      const uint64_t bsd = smem_desc(sp + PMAX * T + o, (PMAX / 8) * 128,
                                     128);
      wgmma_rs_n64(acc, as[j], bb);
      wgmma_rs_n64(acc, ab[j], bsd);
      wgmma_rs_n64(acc, ab[j], bb);
    }
    wg_commit();
    __syncthreads();                  // every read of stage it & 1 is done
    if (it + 2 < steps) load(it + 2, st);
    cp_commit();
    wg_wait_all();
    pin(acc);
    if (it == nk - 1) {               // the inter term, times exp(cum_t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e = expf(cumv[t0 + r0 + 8 * r]);
#pragma unroll
        for (int j = 0; j < PMAX / 8; ++j) {
          acc[4 * j + 2 * r] *= e;
          acc[4 * j + 2 * r + 1] *= e;
        }
      }
    }
  }

  // the two warpgroups' partial sums added in a shared tile, then y
  // written from it a row of 16-byte stores at a time
  __syncthreads();
  float* red = stage;                        // [T][SPT]
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *(float2*)(red + (r0 + 8 * r) * SPT + 8 * j + 2 * t4) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* q = (float2*)(red + (r0 + 8 * r) * SPT + 8 * j + 2 * t4);
        const float2 v = *q;
        *q = make_float2(v.x + acc[4 * j + 2 * r],
                         v.y + acc[4 * j + 2 * r + 1]);
      }
  }
  __syncthreads();
  const int rows = min(T, len - t0);
  In* yt = (In*)a.y + ((int64_t)b * a.S + c0 + t0) * xld + (int64_t)h * a.P;
  if (a.vec) {
    for (int i = threadIdx.x; i < rows * (PMAX / 4); i += THREADS2) {
      const int r = i / (PMAX / 4), c = 4 * (i % (PMAX / 4));
      if (c < a.P)
        store4(yt + r * xld + c, *(const float4*)(red + r * SPT + c));
    }
  } else {
    for (int i = threadIdx.x; i < rows * PMAX; i += THREADS2) {
      const int r = i / PMAX, c = i % PMAX;
      if (c < a.P) yt[r * xld + c] = narrow<In>(red[r * SPT + c]);
    }
  }
}

// ------------------------------------------------------------ launch ----
static size_t bmm_smem() {
  return 4 * ((size_t)2 * 2 * T * SPK + 2 * 2 * T * KC);
}
static size_t chunk_state_smem() {
  return 4 * ((size_t)2 * (SC * SPT + SC * SPB) + 2 * PMAX * SC + QMAX);
}
static size_t chunk_scan_smem() {
  return 4 * ((size_t)2 * 2 * T * SPT + 2 * T * T + 2 * QMAX + T);
}

SSD_SHARED_PASSES

template <typename In>
static int bmm(const SsdArgs& a, cudaStream_t stream) {
  const int e = raise_smem(ssd_bmm_kernel<In>, bmm_smem());
  if (e != 0) return e;
  const int nt = a.QP / T;
  ssd_bmm_kernel<In><<<dim3(nt * (nt + 1) / 2 * a.nc * a.G, a.B), THREADS,
                       bmm_smem(), stream>>>(a);
  return (int)cudaGetLastError();
}

SSD_PASS(ssd_bmm) {
  SSD_ARGS
  return bmm<float>(a, stream);
}

template <typename In>
static int chunk_state(const SsdArgs& a, cudaStream_t stream) {
  const int e = raise_smem(ssd_chunk_state_kernel<In>, chunk_state_smem());
  if (e != 0) return e;
  ssd_chunk_state_kernel<In><<<dim3(a.H * a.nc, a.B), THREADS2,
                               chunk_state_smem(), stream>>>(a);
  return (int)cudaGetLastError();
}

SSD_PASS(ssd_chunk_state) {
  SSD_ARGS
  return chunk_state<float>(a, stream);
}

template <typename In>
static int chunk_scan(const SsdArgs& a, cudaStream_t stream) {
  const int e = raise_smem(ssd_chunk_scan_kernel<In>, chunk_scan_smem());
  if (e != 0) return e;
  const long long blocks = (long long)(a.QP / T) * a.H * a.nc * a.B;
  if (blocks > 0x7fffffffLL) return -1;
  ssd_chunk_scan_kernel<In><<<(unsigned)blocks, THREADS2, chunk_scan_smem(),
                              stream>>>(a);
  return (int)cudaGetLastError();
}

SSD_PASS(ssd_chunk_scan) {
  SSD_ARGS
  return chunk_scan<float>(a, stream);
}
