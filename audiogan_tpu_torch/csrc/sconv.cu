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
// csrc/conv1d.cu's tiling with each batch element's staged rows read from
// xp at base row offs[b] and the z-space mask applied while staging, and
// K7 is csrc/convt1d.cu's polyphase tiling whose stores move by offs[b],
// with the 2*rad rows outside the window written as zeros by the first
// m-tile's blocks (the tile-edge garbage the reference masks afterwards
// never exists). No shuffled tensor reaches device memory.
//
// What bounds them on an H100 (989 TFLOP/s bf16 tensor, 3.35 TB/s HBM): at
// the critic's four fused sites (Cin >= 64) both do hundreds of flops per
// byte and are bound by operations, as the unfused D1-D4 fwd / dx convs.
// This first design is simple and right rather than fast: f32 FMAs on the
// CUDA cores over tiles staged in shared memory as f32 (see conv1d.cu and
// convt1d.cu for the tile choices); wgmma + TMA are the later step.

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

// ---------------------------------------------------------------------------
// K6: the shuffled-input conv1d
// ---------------------------------------------------------------------------

struct SGeom {
  int batch, tp, t, cin, cout, k, s, pad_lo, t_out;
  int q_taps;    // ceil(K / s): packed rows each output reads
  int nb;        // batch elements per block (> 1 only for short rows)
  int seg_len;   // output rows per batch element in a block
  int rows_seg;  // staged packed rows per batch element: seg_len + Q - 1
  int act;
  float slope;
};

// TM x TO outputs per block, RM x RO per thread; the tiling of conv1d.cu.
// Packed row R of z holds z[R*s : R*s + s], so tap j = q*s + p of output t
// reads packed row t + q at phase p.
template <typename T, int TM, int TO, int RM, int RO, int CK>
__global__ void __launch_bounds__((TM / RM) * (TO / RO))
sconv1d_kernel(const T* __restrict__ xp, const T* __restrict__ w,
               const T* __restrict__ bias, const int* __restrict__ offs,
               T* __restrict__ y, SGeom g) {
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
    // staged row r of segment seg is packed z row t0 + r; phase p is z
    // position i = (t0 + r)*s + p - pad_lo, read from xp row i + offs[b]
    for (int e = tid; e < g.s * CK * xrows; e += NT) {
      const int c = e % CK;
      const int rest = e / CK;
      const int r = rest % xrows, p = rest / xrows;
      const int seg = r / g.rows_seg, rr = r - seg * g.rows_seg;
      const int b = b0 + seg;
      const int i = (t0 + rr) * g.s + p - g.pad_lo;
      float v = 0.f;
      if (b < g.batch && i >= 0 && i < g.t && c0 + c < g.cin) {
        const int row = i + __ldg(offs + b);
        if (row >= 0 && row < g.tp)
          v = to_f32(xp[((size_t)b * g.tp + row) * g.cin + c0 + c]);
      }
      xs[(p * CK + c) * xrows + r] = v;
    }
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
cudaError_t launch_sconv(const void* xp, const void* w, const void* bias,
                         const int* offs, void* y, SGeom g,
                         cudaStream_t stream) {
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
  auto kern = sconv1d_kernel<T, TM, TO, RM, RO, CK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (n_t > 65535 || n_b > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(n_o, n_t, n_b);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(xp),
                                   static_cast<const T*>(w),
                                   static_cast<const T*>(bias), offs,
                                   static_cast<T*>(y), g);
  return cudaGetLastError();
}

// conv1d.cu's tile choice: one input channel, short rows, or the rest.
template <typename T>
cudaError_t dispatch_sconv(const void* xp, const void* w, const void* bias,
                           const int* offs, void* y, const SGeom& g,
                           cudaStream_t stream) {
  if (g.cin < 8)
    return launch_sconv<T, 128, 64, 8, 4, 1>(xp, w, bias, offs, y, g, stream);
  if (g.t_out <= 32)
    return launch_sconv<T, 64, 128, 4, 8, 8>(xp, w, bias, offs, y, g, stream);
  return launch_sconv<T, 64, 64, 4, 4, 8>(xp, w, bias, offs, y, g, stream);
}

// ---------------------------------------------------------------------------
// K7: the convT placed at a per-example row offset
// ---------------------------------------------------------------------------

struct TGeom {
  int t_in, cin, cout, k, s, pad_lo, out_len, rad, out_rows;
  int q_min, q_taps, m_out;
};

// TM x TO outputs of one phase rho per block, RM x RO per thread; the
// polyphase tiling of convt1d.cu:
//   u[b, m*s + rho, o] = sum_tau sum_c ct_pad[b, m + tau, c] * wf[j(tau, rho), c, o]
//   j(tau, rho) = pad_lo - rho + (q_min + tau) * s   (outside [0, K): no term)
template <typename T, int TM, int TO, int RM, int RO, int CK>
__global__ void __launch_bounds__((TM / RM) * (TO / RO))
sconvt1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ offs, T* __restrict__ y, TGeom g) {
  constexpr int NT = (TM / RM) * (TO / RO);
  constexpr int MT = TM / RM;
  constexpr int OT = TO / RO;
  extern __shared__ float smem[];
  const int rows = TM + g.q_taps - 1;
  float* xs = smem;               // [CK][rows]
  float* ws = smem + rows * CK;   // [q_taps][CK][TO]

  const int rho = blockIdx.x % g.s;
  const int o0 = (blockIdx.x / g.s) * TO;
  const int m0 = blockIdx.y * TM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tm = tid / OT, to = tid % OT;
  const T* xb = x + (size_t)b * g.t_in * g.cin;
  const int off = __ldg(offs + b);
  T* yb = y + (size_t)b * g.out_rows * g.cout;

  // the 2*rad rows outside the window [off, off + out_len): zeros, written
  // once per (element, Cout tile) by the first m-tile's rho = 0 block
  if (blockIdx.y == 0 && rho == 0) {
    for (int e = tid; e < 2 * g.rad * TO; e += NT) {
      const int zr = e / TO, o = o0 + e % TO;
      const int row = zr < off ? zr : g.out_len + zr;
      if (o < g.cout && row < g.out_rows)
        store(yb + (size_t)row * g.cout + o, 0.f);
    }
  }

  float acc[RM][RO];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < g.cin; c0 += CK) {
    // haloed input rows: ct_pad row m0 + r is ct row m0 + r + q_min
    for (int e = tid; e < rows * CK; e += NT) {
      const int r = e / CK, c = e % CK;
      const int src = m0 + r + g.q_min;
      float v = 0.f;
      if (src >= 0 && src < g.t_in && c0 + c < g.cin)
        v = to_f32(xb[(size_t)src * g.cin + c0 + c]);
      xs[c * rows + r] = v;
    }
    for (int e = tid; e < g.q_taps * CK * TO; e += NT) {
      const int o = e % TO, c = (e / TO) % CK, tau = e / (TO * CK);
      const int j = g.pad_lo - rho + (g.q_min + tau) * g.s;
      float v = 0.f;
      if (j >= 0 && j < g.k && c0 + c < g.cin && o0 + o < g.cout)
        v = to_f32(w[((size_t)j * g.cin + c0 + c) * g.cout + o0 + o]);
      ws[e] = v;
    }
    __syncthreads();
    for (int tau = 0; tau < g.q_taps; ++tau) {
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float a[RM], bw[RO];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = xs[c * rows + tm + i * MT + tau];
#pragma unroll
        for (int j = 0; j < RO; ++j) bw[j] = ws[(tau * CK + c) * TO + to + j * OT];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RO; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // u row t lands at output row t + off
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + tm + i * MT;
    const int t = m * g.s + rho;
    const int row = t + off;
    if (m >= g.m_out || t >= g.out_len || row < 0 || row >= g.out_rows)
      continue;
    T* yrow = yb + (size_t)row * g.cout;
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int o = o0 + to + j * OT;
      if (o < g.cout) store(yrow + o, acc[i][j]);
    }
  }
}

template <typename T, int TM, int TO, int RM, int RO, int CK>
cudaError_t launch_sconvt(const void* x, const void* w, const int* offs,
                          void* y, int batch, const TGeom& g,
                          cudaStream_t stream) {
  constexpr int NT = (TM / RM) * (TO / RO);
  const int n_mt = (g.m_out + TM - 1) / TM;
  const int n_ot = (g.cout + TO - 1) / TO;
  const size_t smem = sizeof(float) * ((size_t)(TM + g.q_taps - 1) * CK +
                                       (size_t)g.q_taps * CK * TO);
  auto kern = sconvt1d_kernel<T, TM, TO, RM, RO, CK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if ((long long)n_ot * g.s > 0x7fffffffLL || n_mt > 65535 || batch > 65535)
    return cudaErrorInvalidConfiguration;
  dim3 grid(n_ot * g.s, n_mt, batch);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x),
                                   static_cast<const T*>(w), offs,
                                   static_cast<T*>(y), g);
  return cudaGetLastError();
}

// convt1d.cu's tile choice: thin Cout, short m, or the rest.
template <typename T>
cudaError_t dispatch_sconvt(const void* x, const void* w, const int* offs,
                            void* y, int batch, const TGeom& g,
                            cudaStream_t stream) {
  if (g.cout <= 16)
    return launch_sconvt<T, 1024, 1, 4, 1, 8>(x, w, offs, y, batch, g, stream);
  if (g.m_out <= 16)
    return launch_sconvt<T, 16, 128, 2, 4, 8>(x, w, offs, y, batch, g, stream);
  return launch_sconvt<T, 64, 64, 4, 4, 16>(x, w, offs, y, batch, g, stream);
}

}  // namespace

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
  SGeom g;
  g.batch = batch; g.tp = tp; g.t = tp - 2 * rad; g.cin = cin;
  g.cout = cout; g.k = k; g.s = stride; g.pad_lo = pad_lo; g.act = act;
  g.slope = slope;
  const int span = g.t + pad_lo + pad_hi - k;
  if (span < 0) return (int)cudaErrorInvalidValue;
  g.t_out = span / stride + 1;
  g.q_taps = (k + stride - 1) / stride;
  g.nb = g.seg_len = g.rows_seg = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)dispatch_sconv<float>(xp, w, bias, offs, y, g, st);
  if (dtype == DT_BF16)
    return (int)dispatch_sconv<__nv_bfloat16>(xp, w, bias, offs, y, g, st);
  return (int)cudaErrorInvalidValue;
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
  TGeom g;
  g.t_in = t_in; g.cin = cin; g.cout = cout; g.k = k; g.s = stride;
  g.pad_lo = pad_lo; g.out_len = out_len; g.rad = rad;
  g.out_rows = out_len + 2 * rad;
  // _convt_phase_range: u[m*s + rho] = sum_q ct[m + q] wf[pad_lo - rho + q*s]
  g.q_min = -(pad_lo / stride);
  const int q_max = (k + stride - 2 - pad_lo) / stride;
  g.q_taps = q_max - g.q_min + 1;
  g.m_out = (out_len + stride - 1) / stride;
  if (g.q_taps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)dispatch_sconvt<float>(ct, wf, offs, y, batch, g, st);
  if (dtype == DT_BF16)
    return (int)dispatch_sconvt<__nv_bfloat16>(ct, wf, offs, y, batch, g, st);
  return (int)cudaErrorInvalidValue;
}

const char* sconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
