// The fused phase-shuffle convs of the WaveGAN critic, for Hopper (sm_90a).
//
// K6 replaces audiogan_tpu/kernels/sconv.py::_sconv1d_pallas (body
// _sconv_kernel): the conv that consumes a shuffled activation reads the
// shuffle's window of the reflect-padded, masked xp itself,
//
//   y[b, t, o] = act(bias[o] + sum_{j < K} sum_c z[b, t*s + j - pad_lo, c] * w[j, c, o])
//   z[b, i]    = xp[b, i + offs[b]]   for 0 <= i < T, and 0 outside [0, T)
//
// with T = tp - 2*rad. The zeros outside [0, T) are the conv's own pads in
// z-space, not xp's reflect rows (which the plain select + conv never reads).
//
// K7 replaces audiogan_tpu/kernels/sconv.py::_sconvt1d_pallas (body
// _sconvt_kernel), the x-transpose of K6: the convT of csrc/convt1d.cu
// written at a per-example row offset,
//
//   out[b, m, c] = u[b, m - offs[b], c]  for offs[b] <= m < offs[b] + T, else 0
//   u = convT(ct, wf, pad_lo, out_len = T)            (no bias, no act)
//
// Layouts are the JAX package's: xp [B, T + 2 rad, Cin], w [K, Cin, Cout],
// bias [Cout], y [B, t_out, Cout]; ct [B, T', Cc], wf [K, Cc, Co],
// out [B, T + 2 rad, Co]; offs [B] int32 in [0, 2 rad].
//
// The TPU kernels move the shuffle into their data movement: an aligned
// haloed DMA, a lane "funnel" roll for the sub-row part of the shift and
// shifted weight copies (Mosaic cannot start a DMA at a dynamic row). On
// this card the per-example shift is only an address offset, so K6 is
// the conv1d tiling with each batch element's staged rows read from xp at
// base row offs[b] and the z-space mask applied while staging, and K7 is
// the polyphase convT tiling whose stores move by offs[b],
// with the 2*rad rows outside the window written as zeros by the first
// m-tile's blocks (the tile-edge garbage the reference masks afterwards
// never exists). No shuffled tensor reaches device memory.
//
// What bounds them on an H100 (989 TFLOP/s bf16 tensor, 3.35 TB/s HBM): at
// the critic's four fused sites (Cin >= 64) both do hundreds of flops per
// byte and are bound by operations, as the unfused D1-D4 fwd / dx convs.
// This file holds only the entry points. Two paths for each, chosen by
// kernels/sconv.py::sconv1d_tensor_core and sconvt1d_tensor_core, pure
// functions of dtype and shape. K6:
//  * sconv1d_tc_launch: bf16 with conv1d's tensor-core shapes on z
//    (Cin, Cout >= 64, T % s == 0) and 2 rad + 1 <= 9: K1′'s implicit GEMM
//    of csrc/igemm_tc.cuh with one TMA view of xp per window offset o in
//    [0, 2 rad] (base row o, dims [B, T/s, s, Cin], xp's batch stride).
//    Element b's rows come through view offs[b] (clamped into [0, 2 rad],
//    so xp is never read outside whatever offs holds), and TMA's zero
//    fill outside [0, T/s) is the conv's z-space padding: the mask costs
//    no code. The plan is conv1d's on z (kernels/conv.py::conv1d_tc_plan),
//    stacking elements only where their rows are a multiple of 8;
//  * sconv1d_launch: f32, and the rest, the CUDA-core tiles of
//    csrc/rowconv_tiles.cuh (f32 FMAs over tiles staged as f32, the
//    z-space mask applied while staging).
// K7:
//  * sconvt1d_tc_launch: bf16 with convT's tensor-core shapes (Cc, Co >=
//    64, multiples of 8, s <= 16): K1's implicit GEMM of csrc/igemm_tc.cuh
//    on ct itself (no window on the input side: K1's view [B, T', 1, Cc]
//    and K1's plan, one phase per output phase) with the placed epilogue:
//    no bias, no activation, output row yr of element b stored at row yr
//    + offs[b] (clamped into [0, 2 rad], so nothing is written outside
//    the output whatever offs holds), and the 2 rad rows outside the
//    window written as zeros by the block of phase 0 and m-tile 0. Every
//    output element is written once, by one block: no memset, no atomics;
//  * sconvt1d_launch: f32, and the rest, the CUDA-core polyphase tiles in
//    their offset form (the stores move by offs[b], the first m-tile's
//    blocks write the zero rows).

#include "igemm_tc.cuh"
#include "rowconv_tiles.cuh"

using namespace rowconv;

extern "C" {

// K6. Returns a cudaError_t code (0 = launched). Pointers are device
// pointers of contiguous tensors; dtype 0 = float32, 1 = bfloat16 for xp,
// w, bias and y; offs is int32.
int sconv1d_launch(const void* xp, const void* w, const void* bias,
                   const int* offs, void* y, int batch, int tp, int cin,
                   int cout, int k, int stride, int pad_lo, int pad_hi,
                   int rad, int act, float slope, int dtype, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || k <= 0 || stride <= 0 ||
      pad_lo < 0 || pad_hi < 0 || rad < 0 || tp - 2 * rad <= 0 ||
      act < ACT_NONE || act > ACT_TANH)
    return (int)cudaErrorInvalidValue;
  Conv1dGeom g;
  g.batch = batch; g.tp = tp; g.t = tp - 2 * rad; g.offs = offs;
  g.cin = cin;
  g.cout = cout; g.k = k; g.s = stride; g.pad_lo = pad_lo; g.act = act;
  g.slope = slope;
  const int span = g.t + pad_lo + pad_hi - k;
  if (span < 0) return (int)cudaErrorInvalidValue;
  g.t_out = span / stride + 1;
  g.q_taps = (k + stride - 1) / stride;
  g.nb = g.seg_len = g.rows_seg = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)dispatch_conv1d_tile<float>(xp, w, bias, y, g, st);
  if (dtype == DT_BF16)
    return (int)dispatch_conv1d_tile<__nv_bfloat16>(xp, w, bias, y, g,
                                                          st);
  return (int)cudaErrorInvalidValue;
}

// K6's tensor-core path, bf16 only: xp [B, tp, cin] with t = tp - 2 rad a
// multiple of stride, plan from kernels/sconv.py::sconv1d_tc_plan (conv1d's
// on z). Returns a cudaError_t code (0 = launched).
int sconv1d_tc_launch(const void* xp, const void* w, const void* bias,
                      const int* offs, void* y, int batch, int tp, int cin,
                      int cout, int k, int stride, int rad, const int* plan,
                      int act, float slope, void* stream) {
  return (int)igemm::launch_shifted(xp, batch, tp, rad, stride, cin, w, k,
                                    cout, bias, offs, y, plan, act, slope,
                                    static_cast<cudaStream_t>(stream));
}

// K7. Returns a cudaError_t code (0 = launched); ct [B, t_in, cin],
// wf [k, cin, cout], out [B, out_len + 2 rad, cout].
int sconvt1d_launch(const void* ct, const void* wf, const int* offs, void* y,
                    int batch, int t_in, int cin, int cout, int k, int stride,
                    int pad_lo, int out_len, int rad, int dtype,
                    void* stream) {
  if (batch <= 0 || t_in <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      stride <= 0 || pad_lo < 0 || pad_lo >= k || out_len <= 0 || rad < 0)
    return (int)cudaErrorInvalidValue;
  ConvTGeom g;
  g.t_in = t_in; g.cin = cin; g.cout = cout; g.k = k; g.s = stride;
  g.pad_lo = pad_lo; g.out_len = out_len; g.rad = rad;
  g.out_rows = out_len + 2 * rad; g.offs = offs;
  g.act = ACT_NONE; g.slope = 0.f;
  convt_phase_range(g);
  if (g.q_taps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)dispatch_convt1d_tile<float>(ct, wf, nullptr, y, batch,
                                                   g, st);
  if (dtype == DT_BF16)
    return (int)dispatch_convt1d_tile<__nv_bfloat16>(ct, wf, nullptr, y,
                                                           batch, g, st);
  return (int)cudaErrorInvalidValue;
}

// K7's tensor-core path, bf16 only: ct [B, t_in, cin], wf [k, cin, cout],
// out [B, out_len + 2 rad, cout], plan from kernels/sconv.py::
// sconvt1d_tc_plan (convT's, then the output pitch out_len + 2 rad).
// Returns a cudaError_t code (0 = launched).
int sconvt1d_tc_launch(const void* ct, const void* wf, const int* offs,
                       void* y, int batch, int t_in, int cin, int cout, int k,
                       int rad, const int* plan, void* stream) {
  return (int)igemm::launch_placed(ct, batch, t_in, cin, wf, k, cout, offs,
                                   rad, y, plan,
                                   static_cast<cudaStream_t>(stream));
}

const char* sconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
