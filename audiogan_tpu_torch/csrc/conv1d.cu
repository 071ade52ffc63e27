// Fused act(conv1d(x, w) + bias), strided, any pads, for Hopper (sm_90a).
//
// Replaces audiogan_tpu/kernels/conv.py::_conv1d_pallas and its body
// _rowconv_kernel (the conv1d form of the row-conv kernel). It computes
//
//   y[b, t, o] = act(bias[o] + sum_{j < K} sum_c x_pad[b, t*s + j, c] * w[j, c, o])
//
// where x_pad is x with pad_lo zeros in front and pad_hi behind, and
// t_out = (t_in + pad_lo + pad_hi - K) / s + 1. pad_hi may be below what
// SAME padding gives (autodiff asks for that), and pad_lo may be anything
// >= 0: rows outside x read as zero.
//
// Layouts are the JAX package's: x [B, T, Cin], w [K, Cin, Cout],
// bias [Cout], y [B, t_out, Cout] (NWC).
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32 on
// the CUDA cores, 3.35 TB/s HBM): the WaveGAN critic's layers 1-4 and the
// generator's dx (Cin, Cout >= 64) do hundreds of flops per byte and are
// bound by operations, on the tensor cores in bf16 and on the CUDA cores
// in f32 (the cp and tp steps, resample_22k); the critic's layer 0 and
// G4's dx (one channel in, 25 taps) do ~25 flops per byte and sit near
// the byte bound. Two paths, chosen by kernels/conv.py::conv1d_tensor_core,
// a pure function of dtype and shape:
//  * conv1d_tc_launch: bf16 with Cin, Cout >= 64 (multiples of 8) and
//    T % s == 0, the implicit GEMM on the tensor cores of
//    csrc/igemm_tc.cuh. x viewed as [B, T/s, s, Cin] holds tap j of
//    output t at packed row t + qq, phase pp (j - pad_lo = qq*s + pp), so
//    the depth is the k-step table kernels/conv.py::conv1d_ksteps builds,
//    and rows outside [0, T/s) are the pads, zero-filled by TMA;
//  * conv1d_launch: f32, and the rest, the CUDA-core kernels of
//    csrc/conv_cc.cuh with the plan of kernels/conv.py::conv1d_cc_plan:
//    an implicit GEMM with M over (element, output row) flattened across
//    the batch, a cp.async ring and 8 x 8 outputs a thread, so a short cp
//    or tp slice fills its tiles and the FMAs run while the next stage
//    loads (tap j of output t reads x row t*s + j - pad_lo, any t_in % s,
//    rows outside x zero); for Cin < 8 a tile that stages its whole x
//    window and every tap once.

#include "igemm_tc.cuh"
#include "conv_cc.cuh"

extern "C" {

// Returns a cudaError_t code (0 = launched). Pointers are device pointers
// of contiguous tensors; dtype 0 = float32, 1 = bfloat16 for x, w, bias, y;
// plan from kernels/conv.py::conv1d_cc_plan.
int conv1d_launch(const void* x, const void* w, const void* bias, void* y,
                  int batch, int t_in, int cin, int cout, int k,
                  const int* plan, int act, float slope, int dtype,
                  void* stream) {
  return (int)convcc::launch<false, true>(x, w, bias, y, batch, t_in, cin,
                                          cout, k, plan, act, slope, dtype,
                                          static_cast<cudaStream_t>(stream));
}

// The tensor-core path, bf16 only: x [B, t_in, cin] with t_in % stride ==
// 0, plan from kernels/conv.py::tc_plan (its k-steps from conv1d_ksteps).
// Returns a cudaError_t code (0 = launched).
int conv1d_tc_launch(const void* x, const void* w, const void* bias, void* y,
                     int batch, int t_in, int cin, int cout, int k,
                     int stride, const int* plan, int act, float slope,
                     void* stream) {
  if (stride <= 0 || t_in <= 0 || t_in % stride)
    return (int)cudaErrorInvalidValue;
  return (int)igemm::launch(x, batch, t_in / stride, stride, cin, w, k, cout,
                            bias, y, plan, act, slope,
                            static_cast<cudaStream_t>(stream));
}

const char* conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
