// The host side of the flash kernels' TMA tile loads (`sm90::tma_load_3d`):
// the driver's tensor-map encoder, reached through the runtime (no -lcuda),
// and the 3-d map over a [BH, rows, D] bf16 tensor whose box is one swizzle
// block of a tile.  Shared by `flash_attention.cu` and
// `flash_attention_bwd.cu`.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace sm90 {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The swizzle span of a row of D bf16 columns in shared memory: 128 bytes
// (64 columns a block) at D >= 64, 64 bytes (32 columns) at D = 32
constexpr int swizzle_bytes(int D) { return D >= 64 ? 128 : 64; }

// A 3-d map over a [BH, rows, D] bf16 tensor whose box is one swizzle block
// (swizzle_bytes(D) of a row) of box_rows rows, rows past `rows` zero-filled
// (rows = 0: a one-row map, never read)
inline bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int rows, int D,
                       int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  // the encoder is a driver call and needs the device's context current on
  // this thread, which the runtime binds only at a call that needs it: a
  // fresh thread (autograd runs the backward on one) may not have it yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) return false;
  rows = rows > 0 ? rows : 1;
  const int sw = swizzle_bytes(D);
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)(sw / 2), (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
