// Integer-factor box downsample of video frames, for Hopper (sm_90a):
// the V-ETL resolution knob.
//
// Replaces: repro/kernels/frame_preproc.py:_kernel (Pallas, TPU), called
// through downsample. Same function: frames (B,H,W,C), H and W divisible
// by the factor f; each output pixel-channel is the mean of its f x f
// input block, summed in fp32 and cast back to the input type (float32,
// or bfloat16 rounded to nearest even as astype does).
//
// Design. The TPU kernel reduces one (bh*f, bw*f, C) VMEM tile per grid
// step. Here one thread computes one output pixel-channel: the grid is
// (output row width / 256, output rows, frames), so a thread finds its
// pixel and channel with one 32-bit division by C, and neighbouring
// threads take neighbouring outputs along W*C. The f loads of one input
// row that a warp issues together then fall on a contiguous span of
// f*32 elements: DRAM sees each input byte once and L1 serves the rest.
// The frames may sit at any stride along B (a strided temporal sample
// frames[::s] needs no copy); each frame's H*W*C block is contiguous.
//
// Bound: bytes. It reads B*H*W*C inputs once and writes 1/f^2 of that,
// with f^2 adds per output: at (30,720,1280,3) float32 and f = 2, 331.8
// MB in and 82.9 MB out, about 0.124 ms at 3.35 TB/s on an H100 SXM.
// Present limits: 4-byte (or 2-byte) scalar loads, no vector loads.
//
// Why CUDA C++ and not Triton, which would suit a reduction like this:
// the port builds every kernel one way (nvcc on a plain C interface,
// loaded with ctypes), and a Triton kernel could only be rehearsed on
// the card.
//
// Interface: plain C, loaded with ctypes. downsample_f32() and
// downsample_bf16() launch on the given stream, do not synchronise, and
// return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    downsample_kernel(const T* __restrict__ x, T* __restrict__ out, int OW,
                      int C, int W, int f, int64_t frame_stride) {
  const int row_len = OW * C;                  // outputs in one row
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= row_len) return;
  const int oy = blockIdx.y, b = blockIdx.z;
  const int c = j % C, ox = j / C;
  const int64_t in_row = (int64_t)W * C;
  const T* p = x + b * frame_stride + (int64_t)oy * f * in_row +
               (int64_t)ox * f * C + c;
  float sum = 0.f;
  for (int dy = 0; dy < f; ++dy) {
    for (int dx = 0; dx < f; ++dx) sum += to_f32(p[dx * C]);
    p += in_row;
  }
  store(out + ((int64_t)b * gridDim.y + oy) * row_len + j,
        sum / (float)(f * f));
}

template <typename T>
static int launch(const T* x, T* out, int B, int H, int W, int C, int f,
                  int64_t frame_stride, cudaStream_t stream) {
  const int OH = H / f, OW = W / f;
  if ((int64_t)B * OH * OW * C == 0) return 0;
  dim3 grid((OW * C + THREADS - 1) / THREADS, OH, B);
  downsample_kernel<T><<<grid, THREADS, 0, stream>>>(x, out, OW, C, W, f,
                                                     frame_stride);
  return (int)cudaGetLastError();
}

// x: B frames of (H,W,C) at frame_stride elements apart; out: contiguous
// (B, H/f, W/f, C). H and W divisible by f; B and H/f at most 65535.
extern "C" int downsample_f32(const float* x, float* out, int B, int H,
                              int W, int C, int f, int64_t frame_stride,
                              cudaStream_t stream) {
  return launch<float>(x, out, B, H, W, C, f, frame_stride, stream);
}

extern "C" int downsample_bf16(const __nv_bfloat16* x, __nv_bfloat16* out,
                               int B, int H, int W, int C, int f,
                               int64_t frame_stride, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, out, B, H, W, C, f, frame_stride, stream);
}
