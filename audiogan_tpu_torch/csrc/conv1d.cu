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
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 3.35 TB/s HBM): the
// WaveGAN critic's layers 1-4 and the generator's dx (Cin, Cout >= 64) do
// hundreds of flops per byte and are bound by operations; the critic's
// layer 0 and G4's dx (one channel in, 25 taps) do ~25 flops per byte and
// are bound by bytes. Two paths, chosen by kernels/conv.py::
// conv1d_tensor_core, a pure function of dtype and shape:
//  * conv1d_tc_launch: bf16 with Cin, Cout >= 64 (multiples of 8) and
//    T % s == 0, the implicit GEMM on the tensor cores of
//    csrc/igemm_tc.cuh. x viewed as [B, T/s, s, Cin] holds tap j of
//    output t at packed row t + qq, phase pp (j - pad_lo = qq*s + pp), so
//    the depth is the k-step table kernels/conv.py::conv1d_ksteps builds,
//    and rows outside [0, T/s) are the pads, zero-filled by TMA;
//  * conv1d_launch: f32, and the rest, the CUDA-core tilings of
//    csrc/rowconv_tiles.cuh (f32 staging and FMAs; the s-sample row
//    packing of the TPU kernel; short rows stack batch elements; a
//    one-channel tile for Cin < 8).

#include "igemm_tc.cuh"
#include "rowconv_tiles.cuh"

using namespace rowconv;

extern "C" {

// Returns a cudaError_t code (0 = launched). Pointers are device pointers
// of contiguous tensors; dtype 0 = float32, 1 = bfloat16 for x, w, bias, y.
int conv1d_launch(const void* x, const void* w, const void* bias, void* y,
                  int batch, int t_in, int cin, int cout, int k, int stride,
                  int pad_lo, int pad_hi, int act, float slope, int dtype,
                  void* stream) {
  if (batch <= 0 || t_in <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      stride <= 0 || pad_lo < 0 || pad_hi < 0 || act < ACT_NONE ||
      act > ACT_TANH)
    return (int)cudaErrorInvalidValue;
  Conv1dGeom g;
  g.batch = batch; g.t = g.tp = t_in; g.offs = nullptr;
  g.cin = cin; g.cout = cout; g.k = k;
  g.s = stride; g.pad_lo = pad_lo; g.act = act; g.slope = slope;
  const int span = t_in + pad_lo + pad_hi - k;
  if (span < 0) return (int)cudaErrorInvalidValue;
  g.t_out = span / stride + 1;
  g.q_taps = (k + stride - 1) / stride;
  g.nb = g.seg_len = g.rows_seg = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)dispatch_conv1d_tile<false, float>(x, w, bias, y, g, st);
  if (dtype == DT_BF16)
    return (int)dispatch_conv1d_tile<false, __nv_bfloat16>(x, w, bias, y, g,
                                                           st);
  return (int)cudaErrorInvalidValue;
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
