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
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 3.35 TB/s HBM):
// the WaveGAN G layers 0-3 and the critic's dx (Cin, Cout >= 64) do
// ~300-2000 flops per byte they must move, so they are bound by
// operations; G's layer 4 (64 -> 1 channel) and D0's dx do ~25 flops per
// byte and are bound by bytes. Two paths, chosen by kernels/conv.py::
// convt_tensor_core, a pure function of dtype and shape:
//  * convt1d_tc_launch: bf16 with Cin, Cout >= 64 (multiples of 8), the
//    implicit GEMM on the tensor cores of csrc/igemm_tc.cuh. Each output
//    phase is a stride-1 conv over x [B, T, 1, Cin]; its k-steps
//    (kernels/conv.py::convt_ksteps) list only the taps inside [0, K), and
//    the epilogue writes row m of phase rho to y row m*s + rho, masked
//    against out_len;
//  * convt1d_launch: f32, and the rest, the CUDA-core polyphase tilings of
//    csrc/rowconv_tiles.cuh (f32 staging and FMAs; a 1024-row tile for
//    thin Cout, a 16-row tile for short m).

#include "igemm_tc.cuh"
#include "rowconv_tiles.cuh"

using namespace rowconv;

extern "C" {

// Returns a cudaError_t code (0 = launched). Pointers are device pointers
// of contiguous tensors; dtype 0 = float32, 1 = bfloat16 for x, w, bias, y.
int convt1d_launch(const void* x, const void* w, const void* bias, void* y,
                   int batch, int t_in, int cin, int cout, int k, int stride,
                   int pad_lo, int out_len, int act, float slope, int dtype,
                   void* stream) {
  if (batch <= 0 || t_in <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      stride <= 0 || pad_lo < 0 || out_len <= 0 || act < ACT_NONE ||
      act > ACT_TANH)
    return (int)cudaErrorInvalidValue;
  ConvTGeom g;
  g.t_in = t_in; g.cin = cin; g.cout = cout; g.k = k; g.s = stride;
  g.pad_lo = pad_lo; g.out_len = out_len; g.act = act; g.slope = slope;
  g.rad = 0; g.out_rows = out_len; g.offs = nullptr;
  convt_phase_range(g);
  if (pad_lo >= k || g.q_taps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)dispatch_convt1d_tile<false, float>(x, w, bias, y, batch, g,
                                                    st);
  if (dtype == DT_BF16)
    return (int)dispatch_convt1d_tile<false, __nv_bfloat16>(x, w, bias, y,
                                                            batch, g, st);
  return (int)cudaErrorInvalidValue;
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
