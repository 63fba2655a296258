// Staging and splitting of the float32 SSD scan's tiles, shared by its
// forward (csrc/ssd_scan.cu) and its backward (csrc/ssd_scan_bwd.cu):
// cp.async copies of a row-major tile into float32 staging, and the
// 3xTF32 split of a staged tile into the K-major core-matrix layout that
// tf32 wgmma reads (hopper.cuh).
#pragma once
#include <stdint.h>
#include "hopper.cuh"

// cp.async, by NT threads, of rows [0, ROWS) x columns [0, COLS) of a
// row-major matrix at src (row stride ld floats) into st (row stride SP
// floats); rows past
// rows_ok and columns past cols_ok are zeros. With vec4, cols_ok and ld
// are multiples of 4 and src is 16-byte aligned.
template <int NT, int ROWS, int COLS, int SP>
__device__ __forceinline__ void load_tile(float* st, const float* src,
                                          int64_t ld, int rows_ok,
                                          int cols_ok, int vec4) {
  if (vec4) {
    constexpr int CH = COLS / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = 4 * (i % CH);
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(st + r * SP + c, ok ? src + r * ld + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async4(st + r * SP + c, ok ? src + r * ld + c : src, ok ? 4 : 0);
    }
  }
}

// Split a staged R x KW operand into the K-major core-matrix layout, big
// at dst and small at dst + R * KW (word i: core matrix cm = i / 32, row
// 8 (cm % (R/8)) + (i / 4) % 8, k 4 (cm / (R/8)) + i % 4), by NT threads.
// A thread writes one core-matrix row of 4 words with one 16-byte store
// each.
// split_rows: element (row, k) is st[row * SP + k], K contiguous.
template <int NT, int R, int KW, int SP>
__device__ __forceinline__ void split_rows(const float* st, uint32_t* dst) {
  constexpr int RB = R / 8, W = R * KW;
#pragma unroll 2
  for (int i = threadIdx.x; i < W / 4; i += NT) {
    const int cm = i >> 3, row = 8 * (cm % RB) + (i & 7), kg = cm / RB;
    const float4 v = *(const float4*)(st + row * SP + 4 * kg);
    uint4 big, small;
    split_bits(v.x, big.x, small.x);
    split_bits(v.y, big.y, small.y);
    split_bits(v.z, big.z, small.z);
    split_bits(v.w, big.w, small.w);
    *(uint4*)(dst + 4 * i) = big;
    *(uint4*)(dst + W + 4 * i) = small;
  }
}

// split_cols: element (row, k) is st[k * SP + row] (times kscale[k] with
// SCALE), transposed as it is split; 8 lanes read 8 consecutive rows of
// one k (no bank conflicts). PERM: a k step's k = t, t + 4 are staged
// rows 2t, 2t + 1 of its 8.
template <int NT, int R, int KW, int SP, bool PERM, bool SCALE = false>
__device__ __forceinline__ void split_cols(const float* st, uint32_t* dst,
                                           const float* kscale = nullptr) {
  constexpr int RB = R / 8, W = R * KW, KS = PERM ? 2 : 1;
#pragma unroll 2
  for (int i = threadIdx.x; i < W / 4; i += NT) {
    const int cm = i >> 3, row = 8 * (cm % RB) + (i & 7), kg = cm / RB;
    const int k0 = PERM ? 8 * (kg >> 1) + (kg & 1) : 4 * kg;
    const float* p = st + k0 * SP + row;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = p[q * KS * SP];
      if constexpr (SCALE) v[q] *= kscale[k0 + q * KS];
    }
    uint4 big, small;
    split_bits(v[0], big.x, small.x);
    split_bits(v[1], big.y, small.y);
    split_bits(v[2], big.z, small.z);
    split_bits(v[3], big.w, small.w);
    *(uint4*)(dst + 4 * i) = big;
    *(uint4*)(dst + W + 4 * i) = small;
  }
}

