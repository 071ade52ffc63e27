// Shared by the row-conv kernels (conv1d.cu, convt1d.cu, sconv.cu): the
// activation codes, the dtype codes of the C interface, and the epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rowconv {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2, ACT_TANH = 3 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The epilogue of audiogan_tpu/kernels/conv.py::_apply_act.
__device__ __forceinline__ float apply_act(float r, int act, float slope) {
  switch (act) {
    case ACT_RELU: return fmaxf(r, 0.f);
    case ACT_LEAKY_RELU: return r >= 0.f ? r : r * slope;
    case ACT_TANH: return tanhf(r);
    default: return r;
  }
}

}  // namespace rowconv
