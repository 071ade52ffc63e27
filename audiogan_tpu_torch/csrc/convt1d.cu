// Fused act(conv_transpose1d(x, w) + bias) for Hopper (sm_90a).
//
// Replaces audiogan_tpu/kernels/conv.py::_convt_pallas and its body
// _rowconv_kernel. Same function, written for this card:
//
//   y[b, m*s + rho, o] = act(bias[o] + sum_tau sum_c
//                            x_pad[b, m + tau, c] * w[j(tau, rho), c, o])
//   j(tau, rho) = pad_lo - rho + (q_min + tau) * s     (taps outside [0, K)
//                                                       contribute nothing)
//
// x_pad is x with -q_min zero rows in front: convT is the input-dilated
// cross-correlation with the filter centred at pad_lo, split on the
// OUTPUT into s phases, each a stride-1 sum of Q = q_taps shifted
// products (no dilation zeros are ever read or multiplied).
//
// Layouts are the JAX package's: x [B, T, Cin], w [K, Cin, Cout],
// bias [Cout], y [B, out_len, Cout] (NWC, written in place, no relayout).
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32 on
// the CUDA cores, 3.35 TB/s HBM): the WaveGAN G layers 0-3 and the
// critic's dx (Cin, Cout >= 64) do ~300-2000 flops per byte they must
// move, so they are bound by operations (the tensor cores in bf16, the
// CUDA cores in f32); G's layer 4 (64 -> 1 channel) and D0's dx do ~25
// flops per byte and sit near the byte bound. Two paths, chosen by
// kernels/conv.py::convt_tensor_core, a pure function of dtype and shape:
//  * convt1d_tc_launch: bf16 with Cin, Cout >= 64 (multiples of 8), the
//    implicit GEMM on the tensor cores of csrc/igemm_tc.cuh. Each output
//    phase is a stride-1 conv over x [B, T, 1, Cin]; its k-steps
//    (kernels/conv.py::convt_ksteps) list only the taps inside [0, K), and
//    the epilogue writes row m of phase rho to y row m*s + rho, masked
//    against out_len;
//  * convt1d_launch: f32, and the rest, the CUDA-core kernels of
//    csrc/conv_cc.cuh with the plan of kernels/conv.py::convt_cc_plan:
//    the same phase split as an implicit GEMM with M over (element, row m
//    of the phase) flattened across the batch, so the cp slices' 12-40
//    rows per element fill a 128-row tile and each staged weight tile
//    serves a full tile, with a cp.async ring and 8 x 8 outputs a
//    thread; for Cout <= 16 one block computes every phase of its rows
//    from x rows staged once (the byte-bound D0 dx and G4).

#include "igemm_tc.cuh"
#include "conv_cc.cuh"

extern "C" {

// Returns a cudaError_t code (0 = launched). Pointers are device pointers
// of contiguous tensors; dtype 0 = float32, 1 = bfloat16 for x, w, bias, y;
// plan from kernels/conv.py::convt_cc_plan.
int convt1d_launch(const void* x, const void* w, const void* bias, void* y,
                   int batch, int t_in, int cin, int cout, int k,
                   const int* plan, int act, float slope, int dtype,
                   void* stream) {
  return (int)convcc::launch<true, false>(x, w, bias, y, batch, t_in, cin,
                                          cout, k, plan, act, slope, dtype,
                                          static_cast<cudaStream_t>(stream));
}

// The tensor-core path, bf16 only: x [B, t_in, cin], plan from
// kernels/conv.py::tc_plan (its k-steps from convt_ksteps, one phase per
// output phase). Returns a cudaError_t code (0 = launched).
int convt1d_tc_launch(const void* x, const void* w, const void* bias,
                      void* y, int batch, int t_in, int cin, int cout, int k,
                      const int* plan, int act, float slope, void* stream) {
  return (int)igemm::launch(x, batch, t_in, 1, cin, w, k, cout, bias, y,
                            plan, act, slope,
                            static_cast<cudaStream_t>(stream));
}

const char* convt1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
