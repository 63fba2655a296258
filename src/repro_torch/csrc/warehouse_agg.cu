// Fused filter + group + aggregate over the warehouse's columns, for
// Hopper (sm_90a). One pass over the live rows: the plan's filter mask
// and the fused multi-key group id are computed in registers, values are
// combined by group inside each warp, and one lane per (group, warp)
// adds the warp's partial into the accumulators.
//
// Replaces: repro/kernels/warehouse_agg.py:_agg_kernel (Pallas, TPU),
// called through fused_segment_agg. It computes the same function, not
// the same blocks: the TPU kernel walks the row tiles in order on one
// core and contracts a one-hot (groups x rows) matrix on the MXU; here
// every SM walks its own contiguous row range at once.
//
// Bound: bytes. Each live row reads its filter columns, and each row the
// filter keeps its key and value columns, once (4 bytes per scalar
// column, 4*D for the wide `out` column); the work per byte is a few
// compares and adds. The floor is those bytes over 3.35 TB/s on an H100
// SXM. The design keeps enough bytes in flight and never serialises on a
// group:
//
// - Strips and vector loads. A thread takes a strip of 4 consecutive rows
//   per step and reads each scalar column as one 16-byte vector; a warp
//   covers 128 consecutive rows a step. With at most 2 scalar columns
//   the loads run 2 steps ahead: a step accumulates strip i while strips
//   i+1 and i+2 are in flight. A strip's key and value columns load with
//   its filter columns when the strip before it kept a row, else only
//   after its own filter keeps one, so a run of dropped strips reads
//   only its filter columns. With 3 or 4 columns the filter columns run
//   one step ahead (a register double buffer) and key and value columns
//   load after the filter; with no filter every column counts as a
//   filter column. Rows before the first strip whose columns are all
//   16-byte aligned, and the last n % 4 rows, take a scalar path of the
//   same kernel (as do all rows when the columns' alignments disagree).
// - The wide (rows, D) value column is staged per warp through shared
//   memory: the step's 128 rows as 4 slabs of 32, all copied at once by
//   16-byte cp.async (contiguous and coalesced; a slab whose rows the
//   filter all dropped is not copied), then summed by columns: 32 / D
//   lanes a column, each over every (32 / D)-th row of a group's rows,
//   and a few shuffles. Staging in registers would need D at compile
//   time.
// - Aggregation inside the warp. A thread first combines its 4 rows in
//   registers when they share a group (windows and cameras are
//   contiguous, so they usually do). A warp whose lanes then hold one
//   group reduces with 5 xor-shuffles. Otherwise its lanes split into
//   segments of equal group (rows are in lane order, so a group's rows
//   are neighbours) and a segmented shuffle reduction (5 conditional
//   shuffles) leaves each segment's total on its first lane. This takes
//   the place of __match_any_sync peer sets, whose reduction costs more.
//   A step with more than SEG_MAX segments (a category that changes
//   from row to row) skips the segments: a scalar value's lanes add their
//   own rows; a wide value's rows are first counting-sorted by group in
//   shared memory, so that every group is one segment.
// - Runs. Each warp walks its own contiguous span of the block's rows,
//   128 a step, and keeps the partial of the group it is in (the run) in
//   registers: a value lane per lane of the warp, the count on lane 0.
//   Only when the group changes does the run go out, one atomic per
//   (group, value lane) and one for the count. A window of 150 rows, a
//   camera of 43,200 or a stretch of one category costs a few atomics,
//   not one per step.
// - max and min map a float to an int whose signed order is the float's
//   (x >= 0: its bits; x < 0: its bits with the low 31 flipped; -0 as +0)
//   and use the native integer atomicMax/atomicMin: no compare-and-swap
//   loop. NaN values are skipped by max and min, as IEEE fmax does; a NaN
//   row still counts.
// - Accumulators. Shared mode (one copy fits shared memory): each block
//   keeps `replicas` copies in shared memory, folds them at its end into
//   its slice of the partials, and a second small kernel folds the slices
//   in block order. Global mode: one copy in global memory (the output
//   itself), initialised by a small kernel, filled by the warp-aggregated
//   atomics of every block and converted in place at the end: no
//   per-block slices and no fold.
// - Enough warps: the wrapper sizes threads, replicas and blocks so that
//   an SM holds at least 32 resident warps where shared memory allows
//   (kernels/warehouse_agg.py:geometry); the launch bound caps registers
//   at 64 a thread.
//
// Exactness: counts (32-bit integer atomics), max, min and
// integer-valued sums are exact. Float sums and means add warp partials
// in the order of the atomics, so they match a row-order sum to float32
// rounding of the reordered additions.
//
// Interface: plain C, loaded with ctypes. warehouse_agg() launches its
// kernels on the given stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_COLS 16
#define MAX_FILTERS 8
#define MAX_KEYS 4
#define MAX_THREADS 1024
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
  int replicas;                 // shared accumulator copies per block
  int global_acc;               // 1: one accumulator copy in global memory
  int n_blocks;
  int threads;                  // threads per block, a multiple of 32
  int smem_bytes;               // dynamic shared memory per block
  int n_scalar;                 // scalar operand columns: cols[0, n_scalar)
  int prefetch;                 // bit c: column c is loaded before the filter
  long long n_rows;             // live rows
  long long head;               // first row of the first strip; -1: none
  long long n_strips;           // strips of 4 rows from `head`
  long long strips_per_block;
  unsigned k_magic[MAX_KEYS];   // windows > 1: floor division by k_window
  int k_shift[MAX_KEYS];        // as (umulhi(magic, u) + u) >> shift
};

// ---------------------------------------------------------------- rows --

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

// filter f on the raw 32-bit word of its column
__device__ __forceinline__ bool pred(const AggSpec& s, int f, int bits) {
  const int c = s.f_col[f];
  return s.col_is_int[c]
      ? int_pred(bits, s.f_op[f], s.f_floor[f], s.f_isint[f], s.f_oob[f])
      : float_pred(__int_as_float(bits), s.f_op[f], s.f_val[f]);
}

// floor(a / w) for w > 1 without a division: for u = a >= 0 (or ~a,
// which is -a - 1, when a < 0) u / w = (umulhi(magic, u) + u) >> shift
// with the host's magic and shift (kernels/warehouse_agg.py:div_magic;
// u < 2^31, so the sum fits 32 bits), and floor(a / w) = ~(~a / w) for
// a < 0
__device__ __forceinline__ int floor_div(int a, unsigned magic, int shift) {
  const unsigned u = a < 0 ? ~(unsigned)a : (unsigned)a;
  const unsigned q = (__umulhi(magic, u) + u) >> shift;
  return a < 0 ? (int)~q : (int)q;
}

// key k's id from the raw word of its column: float keys truncate toward
// zero, as astype(int32) does; windows divide (floor); ids clip
__device__ __forceinline__ int key_id(const AggSpec& s, int k, int bits) {
  int id = s.col_is_int[s.k_col[k]] ? bits
                                    : __float2int_rz(__int_as_float(bits));
  if (s.k_window[k] > 1) id = floor_div(id, s.k_magic[k], s.k_shift[k]);
  return min(max(id, 0), s.k_num[k] - 1);
}

__device__ __forceinline__ float as_value(const AggSpec& s, int bits) {
  return s.col_is_int[s.v_col] ? (float)bits : __int_as_float(bits);
}

__device__ __forceinline__ int load_word(const AggSpec& s, int c,
                                         long long r) {
  return __ldg((const int*)s.cols[c] + r);
}

// ---------------------------------------------------------- aggregates --

__device__ __forceinline__ float identity(int agg) {
  return agg == AGG_MAX ? -INFINITY : agg == AGG_MIN ? INFINITY : 0.f;
}

__device__ __forceinline__ float combine(float a, float b, int agg) {
  return agg == AGG_MAX ? fmaxf(a, b) : agg == AGG_MIN ? fminf(a, b) : a + b;
}

// max/min skip NaN values (the row still counts)
__device__ __forceinline__ float clean(float v, int agg) {
  return (agg == AGG_MAX || agg == AGG_MIN) && isnan(v) ? identity(agg) : v;
}

// a float as an int with the same order: non-negative floats keep their
// bits, negative ones flip the low 31 bits; -0 maps to +0
__device__ __forceinline__ int ordered(float x) {
  int b = __float_as_int(x);
  if (b == (int)0x80000000) b = 0;
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int b) {
  return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff);
}

// the accumulator word that stands for an empty group
__device__ __forceinline__ unsigned init_word(int agg) {
  return (agg == AGG_MAX || agg == AGG_MIN)
      ? (unsigned)ordered(identity(agg)) : 0u;
}

__device__ __forceinline__ float decode(unsigned w, int agg) {
  return (agg == AGG_MAX || agg == AGG_MIN) ? unordered((int)w)
                                            : __uint_as_float(w);
}

// one add into an accumulator word, in shared or global memory
__device__ __forceinline__ void accumulate(unsigned* a, float v, int agg) {
  if (agg == AGG_MAX) atomicMax((int*)a, ordered(v));
  else if (agg == AGG_MIN) atomicMin((int*)a, ordered(v));
  else atomicAdd((float*)a, v);
}

__device__ __forceinline__ float xor_reduce(float x, int agg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = combine(x, __shfl_xor_sync(FULL_MASK, x, off), agg);
  return x;
}

// Where a warp adds: group g of lane value `v` and row count `c` into
// acc[g * lanes + d] and cnt[g]. g < 0: the lane holds no kept row.
struct Sink {
  unsigned* acc;
  unsigned* cnt;
  int lanes;
  int agg;
};

// The group a warp is adding into, kept in registers while consecutive
// rows stay in it: one atomic per run of a group instead of one per
// step. g is the same on every lane; v is value lane d's partial on lane
// d (lane 0 for a scalar value), c the count on lane 0.
struct Run {
  int g;
  float v;
  unsigned c;
};

// Wide values keep runs up to 32 lanes (one per lane of the warp).
#define RUN_LANES 32

__device__ __forceinline__ bool run_lane(const Sink& k, int lane) {
  return k.lanes == 1 ? lane == 0 : lane < k.lanes;
}

__device__ __forceinline__ void run_flush(const Sink& k, Run& r, int lane) {
  if (r.g >= 0) {
    if (run_lane(k, lane))
      accumulate(k.acc + (size_t)r.g * k.lanes + (k.lanes == 1 ? 0 : lane),
                 r.v, k.agg);
    if (lane == 0) atomicAdd(k.cnt + r.g, r.c);
  }
  r.g = -1;
  r.v = identity(k.agg);
  r.c = 0u;
}

// the run continues with group g, or is flushed and restarted at g
__device__ __forceinline__ void run_to(const Sink& k, Run& r, int g,
                                      int lane) {
  if (g != r.g) {
    run_flush(k, r, lane);
    r.g = g;
  }
}

// Segments of a warp: lanes holding equal g in a row form a segment
// (rows are in lane order, so a group is usually one segment; a group
// that comes back later is another segment, added apart). The ballot of
// the segments' first lanes.
__device__ __forceinline__ unsigned seg_heads(int g, int lane) {
  const int gp = __shfl_up_sync(FULL_MASK, g, 1);
  return __ballot_sync(FULL_MASK, lane == 0 || g != gp);
}

// A step whose rows fall in more segments than this adds each lane's own
// item with atomics: interleaved groups (a category that changes from
// row to row) would pay a reduction per segment for a few rows each.
#define SEG_MAX 8

// Segmented reduction: after it the first lane of each segment holds the
// segment's combined value and count.
__device__ __forceinline__ void seg_reduce(float& v, unsigned& c,
                                           unsigned heads, int lane,
                                           int agg) {
  const unsigned after = heads & ~((2u << lane) - 1u);   // heads past lane
  const int len = (after ? __ffs(after) - 1 : 32) - lane;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_down_sync(FULL_MASK, v, off);
    const unsigned tc = __shfl_down_sync(FULL_MASK, c, off);
    if (off < len) {
      v = combine(v, t, agg);
      c += tc;
    }
  }
}

// Scalar value: one item (g, v, c) per lane, in row order. A warp whose
// lanes hold one group reduces with xor-shuffles into the run; one with
// up to SEG_MAX segments reduces them apart: the first joins the run if
// it continues the run's group, the last becomes the run, the others add
// at once; past SEG_MAX every lane adds its own item.
__device__ __forceinline__ void warp_add(const Sink& k, Run& run, int g,
                                         float v, unsigned c, int lane) {
  const int g0 = __shfl_sync(FULL_MASK, g, 0);
  if (__all_sync(FULL_MASK, g == g0)) {
    if (g0 < 0) return;
    v = xor_reduce(v, k.agg);
    c = __reduce_add_sync(FULL_MASK, c);
    run_to(k, run, g0, lane);
    if (lane == 0) {
      run.v = combine(run.v, v, k.agg);
      run.c += c;
    }
    return;
  }
  const unsigned heads = seg_heads(g, lane);
  if (__popc(heads) > SEG_MAX) {
    if (g >= 0) {
      accumulate(k.acc + (size_t)g * k.lanes, v, k.agg);
      atomicAdd(k.cnt + g, c);
    }
    return;
  }
  seg_reduce(v, c, heads, lane, k.agg);
  const int last = 31 - __clz(heads);
  const int g_last = __shfl_sync(FULL_MASK, g, 31);
  const bool first_joins = g0 >= 0 && g0 == run.g;
  const bool head = (heads >> lane) & 1u;
  if (head && g >= 0 && lane != last && !(lane == 0 && first_joins)) {
    accumulate(k.acc + (size_t)g * k.lanes, v, k.agg);
    atomicAdd(k.cnt + g, c);
  }
  if (first_joins && lane == 0) {
    run.v = combine(run.v, v, k.agg);
    run.c += c;
  }
  const float v_last = __shfl_sync(FULL_MASK, v, last);
  const unsigned c_last = __shfl_sync(FULL_MASK, c, last);
  run_to(k, run, g_last, lane);
  if (g_last >= 0 && lane == 0) {
    run.v = combine(run.v, v_last, k.agg);
    run.c += c_last;
  }
}

__device__ __forceinline__ int pick4(const int (&x)[4], int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
}

__device__ __forceinline__ unsigned pick4(const unsigned (&x)[4], int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
}

// Wide value, sums only (the wrapper refuses wide max/min): rows [0, 128)
// of the warp's slab (D floats a row) with row 32q + t's group on lane t
// in gq[q] (-1: no row). Each segment of equal groups is summed by
// columns: 32 / D lanes a column, each over every (32 / D)-th row, then
// a few shuffles. With D <= 32 a segment goes into the run (lane d holds
// value lane d); wider values add at once. Past SEG_MAX segments (groups
// that interleave) the rows are first counting-sorted by group into
// `order` (128 row numbers, then their 128 groups, in the warp's shared
// memory: one round of 4 ballots per distinct group), so that each group
// is one segment of the sorted rows.
__device__ __forceinline__ void wide_add(const Sink& k, Run& run,
                                         const float* slab, int* order,
                                         int (&gq)[4], int lane) {
  const int D = k.lanes;
  const bool runs = D <= RUN_LANES;
  const int* rows = nullptr;                  // row of each position
  unsigned hw[4];
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int prev = __shfl_up_sync(FULL_MASK, gq[q], 1);
      const int carry = __shfl_sync(FULL_MASK, gq[q > 0 ? q - 1 : 0], 31);
      if (lane == 0) prev = q > 0 ? carry : ~gq[0];
      hw[q] = __ballot_sync(FULL_MASK, gq[q] != prev);
    }
    if (pass == 1 || __popc(hw[0]) + __popc(hw[1]) + __popc(hw[2]) +
                         __popc(hw[3]) <= SEG_MAX)
      break;
    unsigned todo[4] = {FULL_MASK, FULL_MASK, FULL_MASK, FULL_MASK};
    int pos[4];
    int base = 0;
    const unsigned below = (1u << lane) - 1u;
    while (todo[0] | todo[1] | todo[2] | todo[3]) {
      const int q0 = todo[0] ? 0 : todo[1] ? 1 : todo[2] ? 2 : 3;
      const int gl = __shfl_sync(FULL_MASK, pick4(gq, q0),
                                 __ffs(pick4(todo, q0)) - 1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned m = __ballot_sync(FULL_MASK, gq[q] == gl);
        if (gq[q] == gl) pos[q] = base + __popc(m & below);
        base += __popc(m);
        todo[q] &= ~m;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      order[pos[q]] = 32 * q + lane;
      order[128 + pos[q]] = gq[q];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) gq[q] = order[128 + 32 * q + lane];
    rows = order;
  }
  for (int pos = 0; pos < 128;) {
    int end = 128;
    for (int w = (pos + 1) >> 5; w < 4; ++w) {
      unsigned m = pick4(hw, w);
      if (w == (pos + 1) >> 5) m &= ~0u << ((pos + 1) & 31);
      if (m) {
        end = 32 * w + __ffs(m) - 1;
        break;
      }
    }
    const int gs = __shfl_sync(FULL_MASK, pick4(gq, pos >> 5), pos & 31);
    if (gs >= 0) {
      if (runs) run_to(k, run, gs, lane);
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int dc = min(32, D - d0), per = 32 / dc;
        const int d = d0 + lane % dc, part = lane / dc;
        float mine = 0.f;
        if (part < per)
          for (int i = pos + part; i < end; i += per)
            mine += slab[(rows ? rows[i] : i) * D + d];
        float x = mine;
        for (int j = 1; j < per; ++j)
          x += __shfl_sync(FULL_MASK, mine, min(lane + j * dc, 31));
        if (lane < dc) {
          if (runs) run.v += x;
          else atomicAdd((float*)k.acc + (size_t)gs * D + d, x);
        }
      }
      if (lane == 0) {
        if (runs) run.c += (unsigned)(end - pos);
        else atomicAdd(k.cnt + gs, (unsigned)(end - pos));
      }
    }
    pos = end;
  }
  __syncwarp();               // `order` is read before it is rewritten
}

// -------------------------------------------------------------- strips --

template <int NS>
__device__ __forceinline__ void load_strip(int4 (&buf)[NS], const AggSpec& s,
                                           long long r0, unsigned mask) {
#pragma unroll
  for (int c = 0; c < NS; ++c)
    if ((mask >> c) & 1u)
      buf[c] = __ldg((const int4*)((const int*)s.cols[c] + r0));
}

// column c of the strip, selected by compile-time indices (a runtime
// index would put the strip in local memory)
template <int NS>
__device__ __forceinline__ int4 pick(const int4 (&buf)[NS], int c) {
  int4 x = buf[0];
#pragma unroll
  for (int j = 1; j < NS; ++j)
    if (c == j) x = buf[j];
  return x;
}

__device__ __forceinline__ int word(const int4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// One row taken alone (head, tail, or columns that do not share an
// alignment): its group, -1 when the filter drops it or it is past the
// live rows.
__device__ __forceinline__ int row_group(const AggSpec& s, long long r,
                                         bool live) {
  for (int f = 0; live && f < s.n_filters; ++f)
    live = pred(s, f, load_word(s, s.f_col[f], r));
  if (!live) return -1;
  int g = 0;
  for (int k = 0; k < s.n_keys; ++k)
    g = g * s.k_num[k] + key_id(s, k, load_word(s, s.k_col[k], r));
  return g;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The filter of a strip: bit i of the result keeps row i.
template <int NS>
__device__ __forceinline__ unsigned strip_filter(const AggSpec& s,
                                                 const int4 (&cur)[NS],
                                                 unsigned keep) {
  for (int f = 0; keep && f < s.n_filters; ++f) {
    const int4 x = pick(cur, s.f_col[f]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (!pred(s, f, word(x, i))) keep &= ~(1u << i);
  }
  return keep;
}

// Accumulate one step: this thread's strip `cur` (rows kept by `keep`)
// and, for a wide value, the warp's 128 rows from `wrow` (n_st strips).
template <int NS, bool WIDE>
__device__ __forceinline__ void strip_add(const AggSpec& s, const Sink& sink,
                                          Run& run, const int4 (&cur)[NS],
                                          unsigned keep,
                                          long long wrow, int n_st,
                                          float* slab, int* order, int lane) {
  const int agg = s.agg;
  const float ident = identity(agg);
  int g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) g[i] = 0;
  for (int k = 0; k < s.n_keys; ++k) {
    const int4 x = pick(cur, s.k_col[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      g[i] = g[i] * s.k_num[k] + key_id(s, k, word(x, i));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (!((keep >> i) & 1u)) g[i] = -1;

  if (!WIDE) {
    const int4 x = pick(cur, s.v_col);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = clean(as_value(s, word(x, i)), agg);
    // the strip's kept rows in one group: combine them in registers
    int gk = -1;
#pragma unroll
    for (int i = 3; i >= 0; --i)
      if (g[i] >= 0) gk = g[i];
    bool one = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) one = one && (g[i] < 0 || g[i] == gk);
    if (__all_sync(FULL_MASK, one)) {
      float x4 = ident;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (g[i] >= 0) x4 = combine(x4, v[i], agg);
      warp_add(sink, run, gk, x4, __popc(keep), lane);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        warp_add(sink, run, g[i], g[i] >= 0 ? v[i] : ident, g[i] >= 0,
                 lane);
    }
    return;
  }
  // Wide value: the warp's 128 rows as 4 slabs of 32 rows, copied into
  // shared memory at once (cp.async; a slab whose rows the filter all
  // dropped is not copied), then summed by segments
  const int D = s.width;
  const float* wide = (const float*)s.cols[s.v_col];
  int gq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int src = 8 * q + (lane >> 2);
    const int a0 = __shfl_sync(FULL_MASK, g[0], src);
    const int a1 = __shfl_sync(FULL_MASK, g[1], src);
    const int a2 = __shfl_sync(FULL_MASK, g[2], src);
    const int a3 = __shfl_sync(FULL_MASK, g[3], src);
    const int i = lane & 3;
    gq[q] = i == 0 ? a0 : i == 1 ? a1 : i == 2 ? a2 : a3;
    const int rows = min(32, 4 * n_st - 32 * q);
    if (rows > 0 && !__all_sync(FULL_MASK, gq[q] < 0)) {
      const float4* src4 = (const float4*)(wide + (wrow + 32 * q) * D);
      float4* slab4 = (float4*)(slab + q * 32 * D);
      const int n4 = rows * D / 4;
      for (int f = lane; f < n4; f += 32) cp_async16(slab4 + f, src4 + f);
    }
  }
  cp_commit();
  cp_wait_all();
  __syncwarp();
  wide_add(sink, run, slab, order, gq, lane);
  __syncwarp();               // the slabs are read before they are refilled
}

// Stage 1. Block b walks strips [b * strips_per_block, ...) and then the
// block's share of the rows outside the strips. Shared mode: replica r
// of the shared accumulators holds acc[num * lanes] then cnt[num] (as
// 32-bit words), and the replicas are folded into the block's slice of
// the partials at the end. Global mode: every block adds into gacc/gcnt.
//
// Loads in flight: see the note at the top (strips); with more than 4
// scalar columns none run ahead (the strip's registers would spill).
template <int NS, bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS)
agg_partial_kernel(const AggSpec s, float* __restrict__ part_acc,
                   unsigned* __restrict__ part_cnt, unsigned* gacc,
                   unsigned* gcnt) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lanes = WIDE ? s.width : 1;
  const int n_acc = s.num * lanes;
  const int slot = n_acc + s.num;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int agg = s.agg;
  const float ident = identity(agg);

  Sink sink{gacc, gcnt, lanes, agg};
  int acc_words = 0;
  if (!s.global_acc) {
    const unsigned w0 = init_word(agg);
    acc_words = ((slot * s.replicas + 3) / 4) * 4;
    for (int i = threadIdx.x; i < slot * s.replicas; i += blockDim.x)
      smem[i] = (i % slot) < n_acc ? w0 : 0u;
    sink.acc = smem + (warp % s.replicas) * slot;
    sink.cnt = sink.acc + n_acc;
  }
  // the warp's staging of the wide column: 128 rows of D floats; after
  // every warp's rows, the warp's 256 words of `order` (see wide_add)
  const int slab_words = 128 * (WIDE ? s.width : 0);
  float* slab = (float*)(smem + acc_words) + warp * slab_words;
  int* order = (int*)(smem + acc_words) + (blockDim.x >> 5) * slab_words +
               (WIDE ? 256 * warp : 0);
  const float* wide = (const float*)s.cols[s.v_col];
  __syncthreads();

  // ---- strips of 4 rows, vector loads --------------------------------
  // The block's strips are cut into one contiguous span per warp, walked
  // 32 strips (128 rows) a step, so that a warp's consecutive steps are
  // consecutive rows and its runs of one group last.
  const unsigned all_cols = (1u << s.n_scalar) - 1u;
  const unsigned pre = (unsigned)s.prefetch & all_cols;
  const unsigned late = all_cols & ~pre;
  const long long b_begin = (long long)blockIdx.x * s.strips_per_block;
  const long long b_end = min(b_begin + s.strips_per_block, s.n_strips);
  const long long n_warps = blockDim.x >> 5;
  const long long span =
      ((max(0LL, b_end - b_begin) + 32 * n_warps - 1) / (32 * n_warps)) * 32;
  const long long s_begin = b_begin + warp * span;
  const long long s_end = min(s_begin + span, b_end);
  const long long st0 = s_begin + lane;
  auto row0 = [&](long long st) { return s.head + 4 * st; };
  auto warp_strips = [&](long long base) {
    return (int)max(0LL, min(32LL, s_end - base));
  };
  Run run{-1, ident, 0u};

  if (NS <= 2) {
    // strip st is accumulated while strip st+32 lands; then st+32 is
    // filtered (its late columns load now if they did not come with it)
    // and st+64 is issued: with every column when st+32 kept a row (a
    // strip after a kept one usually keeps rows too), else with its
    // filter columns only
    int4 a_[NS], b_[NS];
    unsigned keep_a = 0;
    bool full_b = false;
    if (st0 < s_end) {
      load_strip(a_, s, row0(st0), pre);
      keep_a = strip_filter(s, a_, 0xFu);
      if (keep_a && late) load_strip(a_, s, row0(st0), late);
    }
    if (st0 + 32 < s_end) {
      load_strip(b_, s, row0(st0 + 32), keep_a ? all_cols : pre);
      full_b = keep_a != 0;
    }
    for (long long base = s_begin; base < s_end; base += 32) {
      const long long st = base + lane;
      strip_add<NS, WIDE>(s, sink, run, a_, keep_a, row0(base),
                          warp_strips(base), slab, order, lane);
      unsigned keep_b = 0;
      if (st + 32 < s_end) {
        keep_b = strip_filter(s, b_, 0xFu);
        if (keep_b && late && !full_b) load_strip(b_, s, row0(st + 32), late);
      }
      int4 c_[NS];
      bool full_c = false;
      if (st + 64 < s_end) {
        load_strip(c_, s, row0(st + 64), keep_b ? all_cols : pre);
        full_c = keep_b != 0;
      }
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        a_[c] = b_[c];
        b_[c] = c_[c];
      }
      keep_a = keep_b;
      full_b = full_c;
    }
  } else {
    constexpr bool DOUBLE = NS <= 4;
    int4 nxt[NS];
    if (DOUBLE && st0 < s_end) load_strip(nxt, s, row0(st0), pre);
    for (long long base = s_begin; base < s_end; base += 32) {
      const long long st = base + lane;
      const bool live = st < s_end;
      int4 cur[NS];
      if (DOUBLE) {
#pragma unroll
        for (int c = 0; c < NS; ++c) cur[c] = nxt[c];
        if (st + 32 < s_end) load_strip(nxt, s, row0(st + 32), pre);
      } else if (live) {
        load_strip(cur, s, row0(st), pre);
      }
      const unsigned keep = live ? strip_filter(s, cur, 0xFu) : 0u;
      if (keep && late) load_strip(cur, s, row0(st), late);
      strip_add<NS, WIDE>(s, sink, run, cur, keep, row0(base),
                          warp_strips(base), slab, order, lane);
    }
  }

  // ---- rows outside the strips, one per lane, scalar loads -----------
  {
    const long long front = s.head < 0 ? s.n_rows : s.head;
    const long long tail = s.head < 0 ? s.n_rows : s.head + 4 * s.n_strips;
    const long long total = front + (s.n_rows - tail);
    const long long gw = (long long)blockIdx.x * n_warps + warp;
    const long long n_gw = (long long)gridDim.x * n_warps;
    for (long long i0 = gw * 32; i0 < total; i0 += n_gw * 32) {
      const long long i = i0 + lane;
      const long long r = i < front ? i : tail + (i - front);
      const int g = row_group(s, r, i < total);
      if (!WIDE) {
        const float v = g >= 0 ? clean(as_value(s, load_word(s, s.v_col, r)),
                                       agg) : ident;
        warp_add(sink, run, g, v, g >= 0, lane);
      } else {
        // stage the lane's row through the slab, as the strips do
        for (int d = 0; d < s.width; ++d)
          slab[lane * s.width + d] = g >= 0 ? wide[r * s.width + d] : 0.f;
        __syncwarp();
        int gq[4] = {g, -1, -1, -1};
        wide_add(sink, run, slab, order, gq, lane);
        __syncwarp();
      }
    }
  }
  run_flush(sink, run, lane);
  if (s.global_acc) return;
  __syncthreads();

  float* pa = part_acc + (size_t)blockIdx.x * n_acc;
  unsigned* pc = part_cnt + (size_t)blockIdx.x * s.num;
  for (int i = threadIdx.x; i < slot; i += blockDim.x) {
    if (i < n_acc) {
      float x = decode(smem[i], agg);
      for (int rep = 1; rep < s.replicas; ++rep)
        x = combine(x, decode(smem[rep * slot + i], agg), agg);
      pa[i] = x;
    } else {
      unsigned c = smem[i];
      for (int rep = 1; rep < s.replicas; ++rep) c += smem[rep * slot + i];
      pc[i - n_acc] = c;
    }
  }
}

// Stage 2, shared mode: fold the per-block partials. A block of 256
// threads takes 32 outputs; thread (e, j) folds blocks j, j + 8, ... of
// output e in order, and the 8 slices are folded in order of j: a fixed
// order, 8 independent chains.
#define FOLD_SLICES 8
__global__ void __launch_bounds__(32 * FOLD_SLICES)
agg_fold_kernel(const AggSpec s, const float* __restrict__ part_acc,
                const unsigned* __restrict__ part_cnt,
                float* __restrict__ acc, float* __restrict__ cnt) {
  __shared__ float fa[FOLD_SLICES][32];
  __shared__ unsigned long long fc[FOLD_SLICES][32];
  const int lanes = s.width > 0 ? s.width : 1;
  const int n_acc = s.num * lanes;
  const int e = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + e;
  if (i < n_acc) {
    float x = identity(s.agg);
    for (int b = j; b < s.n_blocks; b += FOLD_SLICES)
      x = combine(x, part_acc[(size_t)b * n_acc + i], s.agg);
    fa[j][e] = x;
  } else if (i < n_acc + s.num) {
    unsigned long long x = 0;
    for (int b = j; b < s.n_blocks; b += FOLD_SLICES)
      x += part_cnt[(size_t)b * s.num + (i - n_acc)];
    fc[j][e] = x;
  }
  __syncthreads();
  if (j != 0) return;
  if (i < n_acc) {
    float x = fa[0][e];
    for (int k = 1; k < FOLD_SLICES; ++k) x = combine(x, fa[k][e], s.agg);
    acc[i] = x;
  } else if (i < n_acc + s.num) {
    unsigned long long x = 0;
    for (int k = 0; k < FOLD_SLICES; ++k) x += fc[k][e];
    cnt[i - n_acc] = (float)x;
  }
}

// Global mode: the output is the accumulator, as 32-bit words.
__global__ void agg_init_kernel(const AggSpec s, unsigned* acc,
                                unsigned* cnt) {
  const int lanes = s.width > 0 ? s.width : 1;
  const int n_acc = s.num * lanes;
  const unsigned w0 = init_word(s.agg);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_acc + s.num;
       i += gridDim.x * blockDim.x) {
    if (i < n_acc) acc[i] = w0;
    else cnt[i - n_acc] = 0u;
  }
}

__global__ void agg_finish_kernel(const AggSpec s, unsigned* acc,
                                  unsigned* cnt) {
  const int lanes = s.width > 0 ? s.width : 1;
  const int n_acc = s.num * lanes;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_acc + s.num;
       i += gridDim.x * blockDim.x) {
    if (i < n_acc) ((float*)acc)[i] = decode(acc[i], s.agg);
    else ((float*)cnt)[i - n_acc] = (float)cnt[i - n_acc];
  }
}

template <int NS, bool WIDE>
static int launch_partial(const AggSpec& s, float* part_acc,
                          unsigned* part_cnt, unsigned* gacc, unsigned* gcnt,
                          cudaStream_t stream) {
  auto kern = agg_partial_kernel<NS, WIDE>;
  if (s.smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<s.n_blocks, s.threads, s.smem_bytes, stream>>>(s, part_acc, part_cnt,
                                                        gacc, gcnt);
  return (int)cudaGetLastError();
}

template <bool WIDE>
static int launch_ns(const AggSpec& s, float* pa, unsigned* pc, unsigned* ga,
                     unsigned* gc, cudaStream_t stream) {
  if (s.n_scalar <= 2) return launch_partial<2, WIDE>(s, pa, pc, ga, gc, stream);
  if (s.n_scalar <= 4) return launch_partial<4, WIDE>(s, pa, pc, ga, gc, stream);
  if (s.n_scalar <= 8) return launch_partial<8, WIDE>(s, pa, pc, ga, gc, stream);
  return launch_partial<16, WIDE>(s, pa, pc, ga, gc, stream);
}

// part_acc (n_blocks, num * lanes) and part_cnt (n_blocks, num) are the
// shared mode's per-block slices (unused in global mode); acc and cnt
// are the outputs.
extern "C" int warehouse_agg(const AggSpec* spec, float* part_acc,
                             unsigned* part_cnt, float* acc, float* cnt,
                             cudaStream_t stream) {
  const AggSpec s = *spec;
  if (s.n_scalar < 1 || s.n_scalar > MAX_COLS || s.threads < 32 ||
      s.threads > MAX_THREADS || s.threads % 32 != 0)
    return -1;
  const int lanes = s.width > 0 ? s.width : 1;
  const int total = s.num * lanes + s.num;
  const int small = total / 256 + 1 < 1024 ? total / 256 + 1 : 1024;
  unsigned* ga = (unsigned*)acc;
  unsigned* gc = (unsigned*)cnt;
  if (s.global_acc) {
    agg_init_kernel<<<small, 256, 0, stream>>>(s, ga, gc);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int e = s.width > 0 ? launch_ns<true>(s, part_acc, part_cnt, ga, gc, stream)
                      : launch_ns<false>(s, part_acc, part_cnt, ga, gc, stream);
  if (e != 0) return e;
  if (s.global_acc)
    agg_finish_kernel<<<small, 256, 0, stream>>>(s, ga, gc);
  else
    agg_fold_kernel<<<(total + 31) / 32, 32 * FOLD_SLICES, 0, stream>>>(
        s, part_acc, part_cnt, acc, cnt);
  return (int)cudaGetLastError();
}
