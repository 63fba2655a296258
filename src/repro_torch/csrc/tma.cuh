// Host side of TMA for the port's bfloat16 kernels (csrc/
// flash_attention_bf16.cu, csrc/ssd_scan_bf16.cu): cuTensorMapEncodeTiled
// reached through the runtime (no other library linked), and the 4-D map
// of a contiguous bfloat16 tensor that those kernels load from.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// cuTensorMapEncodeTiled's signature (cuda.h)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled tma_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A contiguous bfloat16 tensor of dims (d0, d1, d2, d3), d0 innermost, as
// a map of boxes of 64 d0 values x 1 x `rows` d2 rows x 1, in the 128-byte
// swizzle (hopper.cuh: sw128), zero fill outside the tensor. False where
// the map is refused (a base or a stride off 16 bytes among them).
static bool bf16_map_4d(CUtensorMap* m, const void* p, uint64_t d0,
                        uint64_t d1, uint64_t d2, uint64_t d3, uint32_t rows) {
  const EncodeTiled enc = tma_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
