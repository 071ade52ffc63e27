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
// the WaveGAN G layers 0-3 (Cin >= 128) do ~300-2000 flops per byte they
// must move, so they are bound by operations; layer 4 (64 -> 1 channel)
// does ~25 flops per byte and is bound by bytes.
// This first design is simple and right rather than fast:
//  * one block per (output phase rho, Cout tile, m tile, batch element);
//    the s phase blocks of one tile are adjacent in launch order, so the
//    input tile they share is read from L2, not HBM;
//  * the haloed input rows of the tile (TM + Q - 1 rows by a Cin chunk)
//    and the phase's Q taps for the chunk are staged in shared memory as
//    f32, looping over Cin chunks; each input element is read once per
//    phase block, and the taps once per block;
//  * an f32 accumulator of RM x RO outputs per thread in registers, fed by
//    scalar FMAs (CUDA cores, not tensor cores: the operation-bound layers
//    run far from their bound; wgmma + TMA are the later step);
//  * for the byte-bound thin layer (Cout <= 16) a tile of 1024 rows by one
//    channel, so each thread's 4 rows share every staged tap;
//  * bias and activation in the epilogue, the ragged m / Cout / out_len
//    edges masked, bf16 in -> f32 accumulate -> bf16 out.

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
  int t_in, cin, cout, k, s, pad_lo, out_len;
  int q_min, q_taps, m_out, n_mt, n_ot;
  int act;
  float slope;
};

// TM x TO outputs of one phase per block, RM x RO per thread. Thread (tm, to)
// owns rows m0 + tm + i*(TM/RM) and channels o0 + to + j*(TO/RO): the
// strided maps make neighbouring threads read neighbouring shared words
// and write neighbouring output channels.
template <typename T, int TM, int TO, int RM, int RO, int CK>
__global__ void __launch_bounds__((TM / RM) * (TO / RO))
convt1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ y, Geom g) {
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
    if (m >= g.m_out || t >= g.out_len) continue;
    T* yrow = y + ((size_t)b * g.out_len + t) * g.cout;
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int o = o0 + to + j * OT;
      if (o < g.cout)
        store(yrow + o, apply_act(acc[i][j] + to_f32(bias[o]), g.act, g.slope));
    }
  }
}

template <typename T, int TM, int TO, int RM, int RO, int CK>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   int batch, Geom g, cudaStream_t stream) {
  constexpr int NT = (TM / RM) * (TO / RO);
  g.n_mt = (g.m_out + TM - 1) / TM;
  g.n_ot = (g.cout + TO - 1) / TO;
  const size_t smem =
      sizeof(float) * ((size_t)(TM + g.q_taps - 1) * CK + (size_t)g.q_taps * CK * TO);
  auto kern = convt1d_kernel<T, TM, TO, RM, RO, CK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if ((long long)g.n_ot * g.s > 0x7fffffffLL || g.n_mt > 65535 || batch > 65535)
    return cudaErrorInvalidConfiguration;
  dim3 grid(g.n_ot * g.s, g.n_mt, batch);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x),
                                   static_cast<const T*>(w),
                                   static_cast<const T*>(bias),
                                   static_cast<T*>(y), g);
  return cudaGetLastError();
}

// Tile choice from the layer's shape: thin Cout, short m, or the rest.
template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* bias, void* y,
                     int batch, const Geom& g, cudaStream_t stream) {
  if (g.cout <= 16) return launch<T, 1024, 1, 4, 1, 8>(x, w, bias, y, batch, g, stream);
  if (g.m_out <= 16) return launch<T, 16, 128, 2, 4, 8>(x, w, bias, y, batch, g, stream);
  return launch<T, 64, 64, 4, 4, 16>(x, w, bias, y, batch, g, stream);
}

}  // namespace

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
  Geom g;
  g.t_in = t_in; g.cin = cin; g.cout = cout; g.k = k; g.s = stride;
  g.pad_lo = pad_lo; g.out_len = out_len; g.act = act; g.slope = slope;
  // _convt_phase_range: y[m*s + rho] = sum_q x[m + q] w[pad_lo - rho + q*s]
  g.q_min = -(pad_lo / stride);
  const int q_max = (k + stride - 2 - pad_lo) / stride;
  g.q_taps = q_max - g.q_min + 1;
  g.m_out = (out_len + stride - 1) / stride;
  g.n_mt = g.n_ot = 0;
  if (pad_lo >= k || g.q_taps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return (int)dispatch<float>(x, w, bias, y, batch, g, st);
  if (dtype == DT_BF16)
    return (int)dispatch<__nv_bfloat16>(x, w, bias, y, batch, g, st);
  return (int)cudaErrorInvalidValue;
}

const char* convt1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
