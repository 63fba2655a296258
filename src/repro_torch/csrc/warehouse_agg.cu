// Fused filter + group + aggregate over the warehouse's columns, for
// Hopper (sm_90a). One pass over the live rows: the plan's filter mask
// and the fused multi-key group id are computed in registers, and every
// surviving row is accumulated into per-block group accumulators. A
// second small kernel folds the per-block partials in block order into
// the {acc, cnt} partial of the query engine.
//
// Accumulators: in shared memory when one copy fits there (the common
// case, up to a few thousand groups); otherwise each block accumulates
// straight into its own slice of the partials in global memory (L2
// atomics), so plans with tens of thousands of groups still run here.
//
// Replaces: repro/kernels/warehouse_agg.py:_agg_kernel (Pallas, TPU),
// called through fused_segment_agg. It computes the same function, not
// the same blocks: the TPU kernel walks the row tiles in order on one
// core and contracts a one-hot (groups x rows) matrix on the MXU; here
// 132 SMs walk disjoint row ranges at once and scatter with shared-memory
// atomics, which suits a few hundred to a few thousand groups.
//
// Bound: bytes. Each live row reads its filter, key and value columns
// once (4 bytes per scalar column, 4*D for the wide `out` column) and
// does a handful of compares and one add per value lane, so the floor is
// n_rows * bytes_per_row / 3.35 TB/s on an H100 SXM.
//
// Present limits (work for a later change): lanes of a warp that hit the
// same group serialize on the shared atomic (the warp-uniform path below
// removes the common case, a warp whose 32 rows share one group, as
// WindowAgg keys that are contiguous in t give); loads are 4-byte scalar
// loads, not vectorized; max/min use a compare-and-swap loop; global-mode
// blocks initialise and fold their whole accumulator slice however few
// rows they hold, and add through L2 atomics.
//
// Exactness: counts, max, min and integer-valued sums are exact. Float
// sums and means are exact per addition but the order of additions
// within a block follows the atomics, so they match a row-order sum to
// float32 rounding of the reordered additions.
//
// Interface: plain C, loaded with ctypes. warehouse_agg() launches both
// kernels on the given stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_COLS 16
#define MAX_FILTERS 8
#define MAX_KEYS 4
#define THREADS 256
#define FULL_MASK 0xffffffffu

enum { OP_EQ = 0, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE };
enum { AGG_SUM = 0, AGG_MEAN, AGG_COUNT, AGG_MAX, AGG_MIN };

// Passed to the kernel by value; the Python wrapper builds the same
// layout with ctypes (repro_torch/kernels/warehouse_agg.py:_Spec).
struct AggSpec {
  const void* cols[MAX_COLS];   // operand columns (int32 or float32)
  int col_is_int[MAX_COLS];
  int n_filters;
  int f_col[MAX_FILTERS];
  int f_op[MAX_FILTERS];
  float f_val[MAX_FILTERS];     // float columns: the float32 threshold
  int f_floor[MAX_FILTERS];     // int columns: floor(threshold) ...
  int f_isint[MAX_FILTERS];     // ... whether it was integral ...
  int f_oob[MAX_FILTERS];       // ... -1/0/+1 outside int32 entirely
  int n_keys;
  int k_col[MAX_KEYS];
  int k_num[MAX_KEYS];
  int k_window[MAX_KEYS];
  int v_col;
  int width;                    // 0: scalar value column; D: (rows, D)
  int agg;
  int num;                      // number of groups (product of k_num)
  int replicas;                 // private accumulator copies per block
  int global_acc;               // 1: accumulate in the global partials
  int n_blocks;
  long long n_rows;             // live rows; the grid covers only these
  long long rows_per_block;
};

__device__ __forceinline__ float load_f(const AggSpec& s, int c, long long r) {
  return s.col_is_int[c] ? (float)(((const int*)s.cols[c])[r])
                         : ((const float*)s.cols[c])[r];
}

__device__ __forceinline__ int load_i(const AggSpec& s, int c, long long r) {
  // float keys truncate toward zero, as astype(int32) does
  return s.col_is_int[c] ? ((const int*)s.cols[c])[r]
                         : __float2int_rz(((const float*)s.cols[c])[r]);
}

// int_pred (repro/kernels/warehouse_agg.py:54): exact comparison of an
// int32 column against a real threshold, closed-form in floor(v).
__device__ __forceinline__ bool int_pred(int x, int op, int i, int is_int,
                                         int oob) {
  switch (op) {
    case OP_EQ: return is_int && x == i && oob == 0;
    case OP_NE: return !is_int || x != i || oob != 0;
    case OP_GE: return oob == 0 ? (is_int ? x >= i : x > i) : oob < 0;
    case OP_GT: return oob == 0 ? x > i : oob < 0;
    case OP_LE: return oob == 0 ? x <= i : oob > 0;
    default:    return oob == 0 ? (is_int ? x < i : x <= i) : oob > 0;
  }
}

__device__ __forceinline__ bool float_pred(float x, int op, float v) {
  switch (op) {
    case OP_EQ: return x == v;
    case OP_NE: return x != v;
    case OP_LT: return x < v;
    case OP_LE: return x <= v;
    case OP_GT: return x > v;
    default:    return x >= v;
  }
}

__device__ __forceinline__ int floor_div(int a, int w) {
  int q = a / w;
  return (a % w != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float combine(float a, float b, int agg) {
  return agg == AGG_MAX ? fmaxf(a, b) : agg == AGG_MIN ? fminf(a, b) : a + b;
}

__device__ __forceinline__ void atomic_max(float* addr, float v) {
  float old = *addr;
  while (v > old) {
    int prev = atomicCAS((int*)addr, __float_as_int(old), __float_as_int(v));
    if (prev == __float_as_int(old)) break;
    old = __int_as_float(prev);
  }
}

__device__ __forceinline__ void atomic_min(float* addr, float v) {
  float old = *addr;
  while (v < old) {
    int prev = atomicCAS((int*)addr, __float_as_int(old), __float_as_int(v));
    if (prev == __float_as_int(old)) break;
    old = __int_as_float(prev);
  }
}

__device__ __forceinline__ void accumulate(float* acc, float v, int agg) {
  if (agg == AGG_MAX) atomic_max(acc, v);
  else if (agg == AGG_MIN) atomic_min(acc, v);
  else atomicAdd(acc, v);
}

__device__ __forceinline__ float warp_reduce(float v, int agg) {
  for (int off = 16; off > 0; off >>= 1)
    v = combine(v, __shfl_xor_sync(FULL_MASK, v, off), agg);
  return v;
}

// Stage 1: block b folds rows [b*rows_per_block, ...) into its
// accumulators and leaves them in part_acc[b] / part_cnt[b]. Shared mode:
// replica r of the shared accumulators holds acc[num*lanes] then
// cnt[num], and the replicas are folded into the partials at the end.
// Global mode: the block's partials are its one accumulator copy.
__global__ void __launch_bounds__(THREADS)
agg_partial_kernel(const AggSpec s, float* __restrict__ part_acc,
                   float* __restrict__ part_cnt) {
  extern __shared__ float smem[];
  const int lanes = s.width > 0 ? s.width : 1;
  const int n_acc = s.num * lanes;
  const int slot = n_acc + s.num;
  const float init = s.agg == AGG_MAX ? -INFINITY
                   : s.agg == AGG_MIN ? INFINITY : 0.f;
  float* pa = part_acc + (size_t)blockIdx.x * n_acc;
  float* pc = part_cnt + (size_t)blockIdx.x * s.num;
  float *acc, *cnt;
  if (s.global_acc) {
    for (int i = threadIdx.x; i < n_acc; i += blockDim.x) pa[i] = init;
    for (int i = threadIdx.x; i < s.num; i += blockDim.x) pc[i] = 0.f;
    acc = pa;
    cnt = pc;
  } else {
    for (int i = threadIdx.x; i < slot * s.replicas; i += blockDim.x)
      smem[i] = (i % slot) < n_acc ? init : 0.f;
    acc = smem + ((threadIdx.x >> 5) % s.replicas) * slot;
    cnt = acc + n_acc;
  }
  __syncthreads();

  const int lane_id = threadIdx.x & 31;
  const long long begin = (long long)blockIdx.x * s.rows_per_block;
  long long end = begin + s.rows_per_block;
  if (end > s.n_rows) end = s.n_rows;

  // every thread runs the same number of iterations, so the whole warp
  // takes part in the shuffles below
  for (long long r0 = begin; r0 < end; r0 += blockDim.x) {
    const long long r = r0 + threadIdx.x;
    bool keep = r < end;
    for (int f = 0; keep && f < s.n_filters; ++f) {
      const int c = s.f_col[f];
      keep = s.col_is_int[c]
          ? int_pred(((const int*)s.cols[c])[r], s.f_op[f], s.f_floor[f],
                     s.f_isint[f], s.f_oob[f])
          : float_pred(((const float*)s.cols[c])[r], s.f_op[f], s.f_val[f]);
    }
    int gid = 0;
    if (keep) {
      for (int k = 0; k < s.n_keys; ++k) {
        int id = load_i(s, s.k_col[k], r);
        if (s.k_window[k] > 1) id = floor_div(id, s.k_window[k]);
        id = min(max(id, 0), s.k_num[k] - 1);
        gid = gid * s.k_num[k] + id;
      }
    }
    const unsigned active = __ballot_sync(FULL_MASK, keep);
    if (active == 0) continue;
    const int g0 = __shfl_sync(FULL_MASK, gid, __ffs(active) - 1);
    if (__all_sync(FULL_MASK, !keep || gid == g0)) {
      // warp-uniform group: reduce across the warp, one atomic per lane
      // of the value instead of 32
      const float empty = s.agg == AGG_MAX ? -INFINITY
                        : s.agg == AGG_MIN ? INFINITY : 0.f;
      for (int d = 0; d < lanes; ++d) {
        float v = empty;
        if (keep) v = s.width > 0
            ? ((const float*)s.cols[s.v_col])[r * s.width + d]
            : load_f(s, s.v_col, r);
        v = warp_reduce(v, s.agg);
        if (lane_id == 0) accumulate(&acc[g0 * lanes + d], v, s.agg);
      }
      if (lane_id == 0) atomicAdd(&cnt[g0], (float)__popc(active));
    } else if (keep) {
      for (int d = 0; d < lanes; ++d) {
        const float v = s.width > 0
            ? ((const float*)s.cols[s.v_col])[r * s.width + d]
            : load_f(s, s.v_col, r);
        accumulate(&acc[gid * lanes + d], v, s.agg);
      }
      atomicAdd(&cnt[gid], 1.f);
    }
  }
  if (s.global_acc) return;
  __syncthreads();

  for (int i = threadIdx.x; i < slot; i += blockDim.x) {
    const int agg = i < n_acc ? s.agg : AGG_SUM;
    float x = smem[i];
    for (int rep = 1; rep < s.replicas; ++rep)
      x = combine(x, smem[rep * slot + i], agg);
    if (i < n_acc) pa[i] = x;
    else pc[i - n_acc] = x;
  }
}

// Stage 2: fold the per-block partials in block order.
__global__ void agg_reduce_kernel(const AggSpec s,
                                  const float* __restrict__ part_acc,
                                  const float* __restrict__ part_cnt,
                                  float* __restrict__ acc,
                                  float* __restrict__ cnt) {
  const int lanes = s.width > 0 ? s.width : 1;
  const int n_acc = s.num * lanes;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_acc) {
    float x = part_acc[i];
    for (int b = 1; b < s.n_blocks; ++b)
      x = combine(x, part_acc[(size_t)b * n_acc + i], s.agg);
    acc[i] = x;
  } else if (i < n_acc + s.num) {
    const int j = i - n_acc;
    float x = part_cnt[j];
    for (int b = 1; b < s.n_blocks; ++b) x += part_cnt[(size_t)b * s.num + j];
    cnt[j] = x;
  }
}

extern "C" int warehouse_agg(const AggSpec* spec, float* part_acc,
                             float* part_cnt, float* acc, float* cnt,
                             cudaStream_t stream) {
  const AggSpec s = *spec;
  const int lanes = s.width > 0 ? s.width : 1;
  const size_t smem = s.global_acc ? 0
      : (size_t)s.replicas * (s.num * lanes + s.num) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        agg_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  agg_partial_kernel<<<s.n_blocks, THREADS, smem, stream>>>(s, part_acc,
                                                            part_cnt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = s.num * lanes + s.num;
  agg_reduce_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      s, part_acc, part_cnt, acc, cnt);
  return (int)cudaGetLastError();
}
