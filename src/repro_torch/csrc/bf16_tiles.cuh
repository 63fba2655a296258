// How a 64-row tile of a bfloat16 operand lands in shared memory for K4's
// bfloat16 kernels (csrc/ssd_scan_bf16.cu, its forward, and
// csrc/ssd_scan_bwd_bf16.cu, its backward): in the 128-byte swizzle
// (hopper.cuh: sw128) that bf16 wgmma reads either way round, by one of
// three routes, as ``route`` picks for a tensor's base and width:
// - TMA through a 4-D map (csrc/tma.cuh) where the width is at least 64,
//   a multiple of 8, and the base 16-byte aligned (the caller starts the
//   copy);
// - 16-byte cp.async to the same swizzled addresses where the width is a
//   multiple of 8 below 64;
// - one value at a time through registers otherwise (land_tile).
// TMA zero-fills past the tensor's ends; a tile's rows past its chunk
// (the next chunk's, where Q % 64 != 0) are zeroed after they land
// (zero_tail), as the other routes zero-fill them.
#pragma once
#include <stdint.h>
#include "hopper.cuh"

#define BF16_TILE_ROWS 64                   // rows of a tile
#define BF16_TILE_BYTES (BF16_TILE_ROWS * 128)  // bytes of a 64-value half

enum Load { LOAD_TMA = 0, LOAD_CP_ASYNC = 1, LOAD_REGS = 2 };

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  return p + (((s + 1023u) & ~1023u) - s);
}

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Rows [0, 64) x columns [0, 64 halves) of the bf16 matrix at src (row
// stride ld values) into the swizzled tile at `tile`, rows past rows_ok
// and columns past cols zero, by threads tid of nt: 16-byte cp.async
// (route LOAD_CP_ASYNC: cols, ld and src's alignment multiples of 8
// values) or one value at a time.
__device__ __forceinline__ void land_tile(uint8_t* tile, const bf16* src,
                                          int64_t ld, int rows_ok, int cols,
                                          int halves, int route, int tid,
                                          int nt) {
  constexpr int T = BF16_TILE_ROWS;
  if (route == LOAD_CP_ASYNC) {
    const uint32_t s = sa(tile);
    const int ch = 8 * halves;
    for (int i = tid; i < T * ch; i += nt) {
      const int r = i / ch, c = 8 * (i % ch);
      const bool ok = r < rows_ok && c < cols;
      cp_async16_to(s + sw128(r, c, T), ok ? src + r * ld + c : src,
                    ok ? 16 : 0);
    }
  } else {
    const int w = 64 * halves;
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < T * w; i += nt) {
      const int r = i / w, c = i % w;
      *(bf16*)(tile + sw128(r, c, T)) =
          r < rows_ok && c < cols ? src[r * ld + c] : zero;
    }
  }
}

// Rows [rows_ok, 64) of a swizzled tile set to zero (whole 128-byte rows:
// the swizzle only permutes a row's chunks)
__device__ __forceinline__ void zero_tail(uint8_t* tile, int halves,
                                          int rows_ok, int tid, int nt) {
  const int per = (BF16_TILE_ROWS - rows_ok) * 8;   // 16-byte chunks a half
  for (int i = tid; i < per * halves; i += nt) {
    const int h = i / per, j = i % per;
    *(uint4*)(tile + h * BF16_TILE_BYTES + (rows_ok + j / 8) * 128 +
              (j % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// element (r, c) of a one-half swizzled tile, widened
__device__ __forceinline__ float at(const uint8_t* tile, int r, int c) {
  return __bfloat162float(*(const bf16*)(tile + sw128(r, c, BF16_TILE_ROWS)));
}

// the route of a tensor at p whose rows are `cols` values wide
static inline int route(const void* p, int cols) {
  if (cols % 8 != 0 || ((uintptr_t)p % 16) != 0) return LOAD_REGS;
  return cols >= 64 ? LOAD_TMA : LOAD_CP_ASYNC;
}
