// Staging and splitting of the SSD scan's tiles, shared by its forward
// (csrc/ssd_scan.cu) and its backward (csrc/ssd_scan_bwd.cu): cp.async
// copies of a row-major tile into float32 staging (bfloat16 widened as it
// lands), and the 3xTF32 split of a staged tile into the K-major
// core-matrix layout that tf32 wgmma reads (hopper.cuh).
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

// The same tile of a bfloat16 matrix, widened into the float32 staging:
// with vec8 (cols_ok and ld multiples of 8, src 16-byte aligned) every
// 16-byte load of the thread is issued before the first store.
template <int NT, int ROWS, int COLS, int SP>
__device__ __forceinline__ void load_tile(float* st, const bf16* src,
                                          int64_t ld, int rows_ok,
                                          int cols_ok, int vec8) {
  if (vec8) {
    constexpr int CH = COLS / 8;
    constexpr int PER = (ROWS * CH + NT - 1) / NT;
    uint4 u[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NT;
      const int r = i / CH, c = 8 * (i % CH);
      const bool ok = i < ROWS * CH && r < rows_ok && c < cols_ok;
      u[j] = ok ? ld16(src + r * ld + c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NT;
      if (i >= ROWS * CH) break;
      store_widened8(st + (i / CH) * SP + 8 * (i % CH), u[j]);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < rows_ok && c < cols_ok;
      st[r * SP + c] = ok ? widen(src[r * ld + c]) : 0.f;
    }
  }
}

// Split a staged R x KW operand into the K-major core-matrix layout, big
// at dst and small at dst + R * KW (word i: core matrix cm = i / 32, row
// 8 (cm % (R/8)) + (i / 4) % 8, k 4 (cm / (R/8)) + i % 4), by NT threads.
// A thread writes one core-matrix row of 4 words with one 16-byte store
// each.
// SMALL = false: big halves only, for a widened bfloat16 operand (its
// own TF32 value: its low 16 bits are zero), stored as it stands.
// split_rows: element (row, k) is st[row * SP + k], K contiguous.
template <int NT, int R, int KW, int SP, bool SMALL = true>
__device__ __forceinline__ void split_rows(const float* st, uint32_t* dst) {
  constexpr int RB = R / 8, W = R * KW;
#pragma unroll 2
  for (int i = threadIdx.x; i < W / 4; i += NT) {
    const int cm = i >> 3, row = 8 * (cm % RB) + (i & 7), kg = cm / RB;
    const float4 v = *(const float4*)(st + row * SP + 4 * kg);
    if constexpr (!SMALL) {
      *(float4*)(dst + 4 * i) = v;
      continue;
    }
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
template <int NT, int R, int KW, int SP, bool PERM, bool SCALE = false,
          bool SMALL = true>
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
    if constexpr (!SMALL) {
      *(float4*)(dst + 4 * i) = make_float4(v[0], v[1], v[2], v[3]);
      continue;
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

