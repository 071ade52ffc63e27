// Fused ingest of int16 store rows for Hopper (sm_90a): crop, cast,
// amplitude normalization and mu-law companding in one pass per row.
//
// Replaces audiogan_tpu/kernels/ingest.py::ingest_fused and its body
// _kernel. For each row b:
//
//   x[i]  = raw[b, offs[b] + i] / 32768      (0 where offs[b] + i >= store:
//                                            a store row shorter than the
//                                            clip is zero-padded here)
//   scale = max_i |x[i]|  (peak)   or   sqrt(sum_i x[i]^2 / clip)  (rms)
//   x[i] *= target / max(scale, eps)        (mode none skips this)
//   y[b, i] = sign(x) * log1p(mu |x|) / log1p(mu)   (mu = 0 skips this)
//
// What bounds it on an H100: bytes. Each row reads clip int16 samples and
// writes clip f32 ones (6 bytes per sample, 6 MB for the flagship's 64 x
// 16384 batch, about 2 us at 3.35 TB/s); the arithmetic is a few flops per
// sample. The design: one block per row, a strided first sweep that reduces
// the scale (warp shuffles, then one shared word per warp), and a second
// sweep that re-reads the row (from L1/L2: a row is 32 KB) and writes the
// companded output with coalesced stores. The crop offset is a plain load
// per block, so any offset and any store length take the same path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { MODE_NONE = 0, MODE_PEAK = 1, MODE_RMS = 2 };
constexpr int kThreads = 512;

__device__ __forceinline__ float sample(const int16_t* row, int src,
                                        int store) {
  return (src >= 0 && src < store) ? (float)row[src] * (1.0f / 32768.0f)
                                   : 0.f;
}

__global__ void __launch_bounds__(kThreads)
ingest_kernel(const int16_t* __restrict__ raw, const int* __restrict__ offs,
              float* __restrict__ out, int store, int clip, int mode,
              float target, float mu, float eps) {
  __shared__ float part[kThreads / 32];
  __shared__ float factor_s;
  const int b = blockIdx.x;
  const int off = offs[b];
  const int16_t* row = raw + (size_t)b * store;
  float* orow = out + (size_t)b * clip;

  float factor = 1.f;
  if (mode != MODE_NONE) {
    float red = 0.f;
    for (int i = threadIdx.x; i < clip; i += kThreads) {
      const float v = sample(row, off + i, store);
      red = mode == MODE_PEAK ? fmaxf(red, fabsf(v)) : fmaf(v, v, red);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, red, d);
      red = mode == MODE_PEAK ? fmaxf(red, o) : red + o;
    }
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = red;
    __syncthreads();
    if (threadIdx.x < 32) {
      red = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, red, d);
        red = mode == MODE_PEAK ? fmaxf(red, o) : red + o;
      }
      if (threadIdx.x == 0) {
        const float scale =
            mode == MODE_PEAK ? red : sqrtf(red / (float)clip);
        factor_s = target / fmaxf(scale, eps);
      }
    }
    __syncthreads();
    factor = factor_s;
  }

  const float log1p_mu = mu > 0.f ? log1pf(mu) : 1.f;
  for (int i = threadIdx.x; i < clip; i += kThreads) {
    float v = sample(row, off + i, store);
    if (mode != MODE_NONE) v = v * factor;
    if (mu > 0.f) {
      const float sgn = (float)((v > 0.f) - (v < 0.f));
      v = sgn * log1pf(mu * fabsf(v)) / log1p_mu;
    }
    orow[i] = v;
  }
}

}  // namespace

extern "C" {

// raw int16 [batch, store], offs int32 [batch], out float32 [batch, clip];
// all device pointers of contiguous tensors. Returns a cudaError_t code.
int ingest_launch(const void* raw, const void* offs, void* out, int batch,
                  int store, int clip, int mode, float target, float mu,
                  float eps, void* stream) {
  if (batch <= 0 || store <= 0 || clip <= 0 || mode < MODE_NONE ||
      mode > MODE_RMS)
    return (int)cudaErrorInvalidValue;
  ingest_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(raw), static_cast<const int*>(offs),
      static_cast<float*>(out), store, clip, mode, target, mu, eps);
  return (int)cudaGetLastError();
}

const char* ingest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
