// The CUDA-core tiles of the fused shuffle sites' convs, K6 (sconv1d)
// and K7 (sconvt1d, csrc/sconv.cu), in f32 and in the bf16 geometries
// off their tensor-core path: f32 FMAs over tiles staged in shared memory
// as f32, each batch element's rows read (K6) or written (K7) at a
// per-element row offset offs[b]; K6 masks in z-space and K7 writes the
// 2*rad rows outside each window as zeros.
//
// They are the row-conv tiles of the port's first design (PR 4/5, PR 7),
// which K1 and K1' ran too until their CUDA-core path was redesigned for
// Hopper (csrc/conv_cc.cuh: M flattened across the batch, a cp.async
// ring, 8 x 8 outputs a thread, one-channel kernels that stage x once).
// What bounds these: each block stages its chunk synchronously between
// two barriers, holds 4 x 4 or 4 x 8 outputs a thread, and (K7) runs one
// batch element and one phase. A preset's bf16 step runs K6 and K7 on the
// tensor cores; only f32 (the parity phase's fused flagship) and odd
// shapes come here, so these stay as they were.
//
// conv1d: y[b, t, o] = act(bias[o] + sum_{j < K} sum_c z[b, t*s + j - pad_lo, c] * w[j, c, o])
//   z[b, i] = xp[b, i + offs[b]] for 0 <= i < t, 0 elsewhere. Packed row
//   R holds z[R*s : R*s + s], so tap j = q*s + p of output t reads packed
//   row t + q at phase p.
// convT: u[b, m*s + rho, o] = sum_tau sum_c x_pad[b, m + tau, c] * w[j(tau, rho), c, o]
//   j(tau, rho) = pad_lo - rho + (q_min + tau) * s (outside [0, K): no
//   term); y[b, t + offs[b]] = u[b, t] (no bias, no act).
#pragma once

#include "conv_common.cuh"

namespace rowconv {

struct Conv1dGeom {
  int batch;
  int t;         // rows of z: the conv's input length (x's rows, no offset)
  int cin, cout, k, s, pad_lo, t_out;
  int q_taps;    // ceil(K / s): packed rows each output reads
  int nb;        // batch elements per block (> 1 only for short rows)
  int seg_len;   // output rows per batch element in a block
  int rows_seg;  // staged packed rows per batch element: seg_len + Q - 1
  int act;
  float slope;
  // the offset form only
  int tp;              // rows of xp per batch element: t + 2 rad
  const int* offs;     // [batch] window offsets into xp
};

// TM x TO outputs per block, RM x RO per thread. Thread (tm, to) owns local
// rows tm + i*(TM/RM) and channels o0 + to + j*(TO/RO).
template <typename T, int TM, int TO, int RM, int RO, int CK>
__global__ void __launch_bounds__((TM / RM) * (TO / RO))
conv1d_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ y,
                   Conv1dGeom g) {
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
    // position i = (t0 + r)*s + p - pad_lo, read from x row i (+ offs[b])
    for (int e = tid; e < g.s * CK * xrows; e += NT) {
      const int c = e % CK;
      const int rest = e / CK;
      const int r = rest % xrows, p = rest / xrows;
      const int seg = r / g.rows_seg, rr = r - seg * g.rows_seg;
      const int b = b0 + seg;
      const int i = (t0 + rr) * g.s + p - g.pad_lo;
      float v = 0.f;
      if (b < g.batch && i >= 0 && i < g.t && c0 + c < g.cin) {
        const int row = i + __ldg(g.offs + b);
        if (row >= 0 && row < g.tp)
          v = to_f32(x[((size_t)b * g.tp + row) * g.cin + c0 + c]);
      }
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
cudaError_t launch_conv1d_tile(const void* x, const void* w, const void* bias,
                               void* y, Conv1dGeom g, cudaStream_t stream) {
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
  auto kern = conv1d_tile_kernel<T, TM, TO, RM, RO, CK>;
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

// Tile choice from the layer's shape: one input channel, short rows, or
// the rest.
template <typename T>
cudaError_t dispatch_conv1d_tile(const void* x, const void* w,
                                 const void* bias, void* y,
                                 const Conv1dGeom& g, cudaStream_t stream) {
  if (g.cin < 8)
    return launch_conv1d_tile<T, 128, 64, 8, 4, 1>(x, w, bias, y, g,
                                                            stream);
  if (g.t_out <= 32)
    return launch_conv1d_tile<T, 64, 128, 4, 8, 8>(x, w, bias, y, g,
                                                            stream);
  return launch_conv1d_tile<T, 64, 64, 4, 4, 8>(x, w, bias, y, g,
                                                         stream);
}

struct ConvTGeom {
  int t_in, cin, cout, k, s, pad_lo, out_len;
  int q_min, q_taps, m_out;
  int act;
  float slope;
  // the offset form only
  int rad;             // rows outside each window on either side
  int out_rows;        // output rows per element: out_len + 2 rad
  const int* offs;     // [batch] window offsets into the output
};

// TM x TO outputs of one phase rho per block, RM x RO per thread. Thread
// (tm, to) owns rows m0 + tm + i*(TM/RM) and channels o0 + to +
// j*(TO/RO): the strided maps make neighbouring threads read neighbouring
// shared words and write neighbouring output channels.
template <typename T, int TM, int TO, int RM, int RO, int CK>
__global__ void __launch_bounds__((TM / RM) * (TO / RO))
convt1d_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ y,
                    ConvTGeom g) {
  constexpr int NT = (TM / RM) * (TO / RO);
  constexpr int MT = TM / RM;     // threads along m
  constexpr int OT = TO / RO;     // threads along o
  extern __shared__ float smem[];
  const int rows = TM + g.q_taps - 1;
  float* xs = smem;               // [CK][rows]: threads read along m
  float* ws = smem + rows * CK;   // [q_taps][CK][TO]

  const int rho = blockIdx.x % g.s;
  const int o0 = (blockIdx.x / g.s) * TO;
  const int m0 = blockIdx.y * TM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tm = tid / OT, to = tid % OT;
  const T* xb = x + (size_t)b * g.t_in * g.cin;
  T* yb = y + (size_t)b * g.out_rows * g.cout;
  const int off = __ldg(g.offs + b);
  // the 2*rad rows outside the window [off, off + out_len): zeros,
  // written once per (element, Cout tile) by the first m-tile's rho = 0
  // block
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
    // haloed input rows: x_pad row m0 + r is x row m0 + r + q_min
    for (int e = tid; e < rows * CK; e += NT) {
      const int r = e / CK, c = e % CK;
      const int src = m0 + r + g.q_min;
      float v = 0.f;
      if (src >= 0 && src < g.t_in && c0 + c < g.cin)
        v = to_f32(xb[(size_t)src * g.cin + c0 + c]);
      xs[c * rows + r] = v;
    }
    // this phase's taps for the chunk, zero where j leaves [0, K)
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

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + tm + i * MT;
    const int t = m * g.s + rho;
    // u row t lands at output row t + off
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
cudaError_t launch_convt1d_tile(const void* x, const void* w,
                                const void* bias, void* y, int batch,
                                const ConvTGeom& g, cudaStream_t stream) {
  constexpr int NT = (TM / RM) * (TO / RO);
  const int n_mt = (g.m_out + TM - 1) / TM;
  const int n_ot = (g.cout + TO - 1) / TO;
  const size_t smem = sizeof(float) * ((size_t)(TM + g.q_taps - 1) * CK +
                                       (size_t)g.q_taps * CK * TO);
  auto kern = convt1d_tile_kernel<T, TM, TO, RM, RO, CK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if ((long long)n_ot * g.s > 0x7fffffffLL || n_mt > 65535 || batch > 65535)
    return cudaErrorInvalidConfiguration;
  dim3 grid(n_ot * g.s, n_mt, batch);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x),
                                   static_cast<const T*>(w),
                                   static_cast<const T*>(bias),
                                   static_cast<T*>(y), g);
  return cudaGetLastError();
}

// Tile choice from the layer's shape: thin Cout, short m, or the rest.
template <typename T>
cudaError_t dispatch_convt1d_tile(const void* x, const void* w,
                                  const void* bias, void* y, int batch,
                                  const ConvTGeom& g, cudaStream_t stream) {
  if (g.cout <= 16)
    return launch_convt1d_tile<T, 1024, 1, 4, 1, 8>(
        x, w, bias, y, batch, g, stream);
  if (g.m_out <= 16)
    return launch_convt1d_tile<T, 16, 128, 2, 4, 8>(
        x, w, bias, y, batch, g, stream);
  return launch_convt1d_tile<T, 64, 64, 4, 4, 16>(x, w, bias, y,
                                                           batch, g, stream);
}

// (q_min, q_taps) of _convt_phase_range: u[m*s + rho] = sum_q x[m + q]
// w[pad_lo - rho + q*s]
inline void convt_phase_range(ConvTGeom& g) {
  g.q_min = -(g.pad_lo / g.s);
  const int q_max = (g.k + g.s - 2 - g.pad_lo) / g.s;
  g.q_taps = q_max - g.q_min + 1;
  g.m_out = (g.out_len + g.s - 1) / g.s;
}

}  // namespace rowconv
