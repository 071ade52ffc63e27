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
// Indexing: the s-sample row packing of the TPU kernel. Packed row R holds
// x_pad[R*s : R*s + s], so tap j = q*s + p of output t reads packed row
// t + q at phase p: a stride-1 sum over Q = ceil(K/s) rows. The staged tile
// is kept per phase, [s][CK][rows], so threads on neighbouring output rows
// read neighbouring shared words.
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 3.35 TB/s HBM): the
// WaveGAN critic's layers 1-4 (Cin >= 64) do hundreds of flops per byte and
// are bound by operations; layer 0 (Cin = 1, 25 taps) does ~25 flops per
// byte and is bound by bytes. This first design is simple and right rather
// than fast:
//  * one block per (Cout tile, t tile, group of batch elements); the Cin
//    loop runs inside the block in chunks of CK channels, with the haloed
//    input rows and the chunk's K taps staged in shared memory as f32;
//  * short rows (t_out below the tile height, the critic's last layer has
//    t_out = 16) stack several batch elements in one block, each with its
//    own halo, so the taps staged once serve nb elements instead of one;
//  * Cin < 8 (the critic's first layer, Cin = 1) takes a one-channel chunk
//    and a 128-row tile, so no zero channels are staged or multiplied;
//  * an f32 accumulator of RM x RO outputs per thread in registers, fed by
//    scalar FMAs on the CUDA cores (wgmma + TMA are the later step);
//  * bias and activation in the epilogue, ragged edges masked, bf16 in ->
//    f32 accumulate -> bf16 out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

struct Geom {
  int batch, t_in, cin, cout, k, s, pad_lo, t_out;
  int q_taps;    // ceil(K / s): packed rows each output reads
  int nb;        // batch elements per block (> 1 only for short rows)
  int seg_len;   // output rows per batch element in a block
  int rows_seg;  // staged packed rows per batch element: seg_len + Q - 1
  int act;
  float slope;
};

// TM x TO outputs per block, RM x RO per thread. Thread (tm, to) owns local
// rows tm + i*(TM/RM) and channels o0 + to + j*(TO/RO).
template <typename T, int TM, int TO, int RM, int RO, int CK>
__global__ void __launch_bounds__((TM / RM) * (TO / RO))
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ bias, T* __restrict__ y, Geom g) {
  constexpr int NT = (TM / RM) * (TO / RO);
  constexpr int MT = TM / RM;
  constexpr int OT = TO / RO;
  extern __shared__ float smem[];
  const int xrows = g.nb * g.rows_seg;
  float* xs = smem;                         // [s][CK][xrows]
  float* ws = smem + g.s * CK * xrows;      // [K][CK][TO]

  const int o0 = blockIdx.x * TO;
  const int t0 = blockIdx.y * g.seg_len;    // 0 when nb > 1
  const int b0 = blockIdx.z * g.nb;
  const int tid = threadIdx.x;
  const int tm = tid / OT, to = tid % OT;

  int base[RM];      // staged row of output row i, tap row q = 0
  int yoff[RM];      // (b * t_out + t), or -1 where the row is outside
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = tm + i * MT;
    const int seg = m / g.seg_len, tl = m - seg * g.seg_len;
    const int b = b0 + seg, t = t0 + tl;
    base[i] = seg * g.rows_seg + tl;
    yoff[i] = (seg < g.nb && b < g.batch && t < g.t_out)
                  ? b * g.t_out + t : -1;
    if (yoff[i] < 0) base[i] = 0;
  }

  float acc[RM][RO];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < g.cin; c0 += CK) {
    // packed input rows: staged row r of segment seg is packed row
    // t0 + r, phase p sits at x_pad position (t0 + r)*s + p
    for (int e = tid; e < g.s * CK * xrows; e += NT) {
      const int c = e % CK;
      const int rest = e / CK;
      const int r = rest % xrows, p = rest / xrows;
      const int seg = r / g.rows_seg, rr = r - seg * g.rows_seg;
      const int b = b0 + seg;
      const int src = (t0 + rr) * g.s + p - g.pad_lo;
      float v = 0.f;
      if (b < g.batch && src >= 0 && src < g.t_in && c0 + c < g.cin)
        v = to_f32(x[((size_t)b * g.t_in + src) * g.cin + c0 + c]);
      xs[(p * CK + c) * xrows + r] = v;
    }
    // the chunk's K taps
    for (int e = tid; e < g.k * CK * TO; e += NT) {
      const int o = e % TO, c = (e / TO) % CK, j = e / (TO * CK);
      float v = 0.f;
      if (c0 + c < g.cin && o0 + o < g.cout)
        v = to_f32(w[((size_t)j * g.cin + c0 + c) * g.cout + o0 + o]);
      ws[e] = v;
    }
    __syncthreads();
    for (int j = 0, q = 0, p = 0; j < g.k; ++j) {
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float* xr = xs + (p * CK + c) * xrows + q;
        const float* wr = ws + (j * CK + c) * TO + to;
        float a[RM], bw[RO];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = xr[base[i]];
#pragma unroll
        for (int jj = 0; jj < RO; ++jj) bw[jj] = wr[jj * OT];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int jj = 0; jj < RO; ++jj)
            acc[i][jj] = fmaf(a[i], bw[jj], acc[i][jj]);
      }
      if (++p == g.s) { p = 0; ++q; }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (yoff[i] < 0) continue;
    T* yrow = y + (size_t)yoff[i] * g.cout;
#pragma unroll
    for (int jj = 0; jj < RO; ++jj) {
      const int o = o0 + to + jj * OT;
      if (o < g.cout)
        store(yrow + o, apply_act(acc[i][jj] + to_f32(bias[o]), g.act, g.slope));
    }
  }
}

template <typename T, int TM, int TO, int RM, int RO, int CK>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   Geom g, cudaStream_t stream) {
  constexpr int NT = (TM / RM) * (TO / RO);
  // rows shorter than the tile: stack TM / t_out batch elements per block
  g.nb = g.t_out < TM ? TM / g.t_out : 1;
  g.seg_len = g.nb > 1 ? g.t_out : TM;
  g.rows_seg = g.seg_len + g.q_taps - 1;
  const int n_t = g.nb > 1 ? 1 : (g.t_out + TM - 1) / TM;
  const int n_b = (g.batch + g.nb - 1) / g.nb;
  const int n_o = (g.cout + TO - 1) / TO;
  const size_t smem = sizeof(float) * ((size_t)g.s * CK * g.nb * g.rows_seg +
                                       (size_t)g.k * CK * TO);
  auto kern = conv1d_kernel<T, TM, TO, RM, RO, CK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (n_t > 65535 || n_b > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(n_o, n_t, n_b);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x),
                                   static_cast<const T*>(w),
                                   static_cast<const T*>(bias),
                                   static_cast<T*>(y), g);
  return cudaGetLastError();
}

// Tile choice from the layer's shape: one input channel, short rows, or the
// rest.
template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* bias, void* y,
                     const Geom& g, cudaStream_t stream) {
  if (g.cin < 8) return launch<T, 128, 64, 8, 4, 1>(x, w, bias, y, g, stream);
  if (g.t_out <= 32) return launch<T, 64, 128, 4, 8, 8>(x, w, bias, y, g, stream);
  return launch<T, 64, 64, 4, 4, 8>(x, w, bias, y, g, stream);
}

}  // namespace

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
  Geom g;
  g.batch = batch; g.t_in = t_in; g.cin = cin; g.cout = cout; g.k = k;
  g.s = stride; g.pad_lo = pad_lo; g.act = act; g.slope = slope;
  const int span = t_in + pad_lo + pad_hi - k;
  if (span < 0) return (int)cudaErrorInvalidValue;
  g.t_out = span / stride + 1;
  g.q_taps = (k + stride - 1) / stride;
  g.nb = g.seg_len = g.rows_seg = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return (int)dispatch<float>(x, w, bias, y, g, st);
  if (dtype == DT_BF16)
    return (int)dispatch<__nv_bfloat16>(x, w, bias, y, g, st);
  return (int)cudaErrorInvalidValue;
}

const char* conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
