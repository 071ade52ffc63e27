// One fused GRU step (torch.nn.GRUCell's gates, ordered r, z, n), for
// Hopper (sm_90a).
//
// Replaces audiogan_tpu/kernels/gru.py::_gru_fwd_impl (body _gru_kernel):
//
//   gi = x @ w_i + b_i,  gh = h @ w_h + b_h             ([B, 3H], f32)
//   r  = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z)
//   n  = tanh(gi_n + r * gh_n),  h' = (1 - z) * n + z * h
//
// Layouts are the JAX package's: x [B, in], h [B, H], w_i [in, 3H],
// w_h [H, 3H], b_i [3H], b_h [3H], h' [B, H] in x's dtype.
//
// What it keeps out of device memory, as the TPU kernel does: the [B, 3H]
// gate tensors. A block owns a tile of TB rows by TJ hidden units and
// forms, for those units, the three gate columns j, H + j and 2H + j of
// both products, so r, z and n of a unit meet in one thread's registers.
// The TPU kernel holds both weight matrices in VMEM for a batch block and
// falls back to XLA above 12 MB of weights; that is a limit of the TPU's
// VMEM, not of the function, and this kernel takes any size: the depth of
// both products streams through shared memory in chunks of KC.
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 3.35 TB/s HBM): at
// cond_gru_sc09's cell (B=64, in = H = 512) it does 0.2 GFLOP against
// 3.3 MB of bf16 operands, about 60 flops per byte, so it is bound by
// bytes (about 1 us). This first design is simple and right rather than
// fast: one output per thread, six f32 accumulators fed by scalar FMAs on
// the CUDA cores, each weight chunk read once per row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { DT_F32 = 0, DT_BF16 = 1 };

constexpr int TB = 16;   // rows per block
constexpr int TJ = 16;   // hidden units per block
constexpr int KC = 32;   // depth per staged chunk
constexpr int NT = TB * TJ;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// acc[g] += sum_k a[b0 + r, k] * wm[k, g*hid + j0 + jj] over k < depth.
template <typename T>
__device__ void gate_products(const T* __restrict__ a,
                              const T* __restrict__ wm, int batch, int depth,
                              int hid, int b0, int j0, float* as, float* ws,
                              float acc[3]) {
  const int tid = threadIdx.x;
  const int r = tid / TJ, jj = tid % TJ;
  for (int k0 = 0; k0 < depth; k0 += KC) {
    for (int e = tid; e < TB * KC; e += NT) {
      const int rr = e / KC, kk = e % KC;
      float v = 0.f;
      if (b0 + rr < batch && k0 + kk < depth)
        v = to_f32(a[(size_t)(b0 + rr) * depth + k0 + kk]);
      as[kk * TB + rr] = v;
    }
    for (int e = tid; e < KC * 3 * TJ; e += NT) {
      const int u = e % TJ, g = (e / TJ) % 3, kk = e / (3 * TJ);
      float v = 0.f;
      if (k0 + kk < depth && j0 + u < hid)
        v = to_f32(wm[(size_t)(k0 + kk) * 3 * hid + g * hid + j0 + u]);
      ws[e] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float av = as[kk * TB + r];
      const float* wr = ws + kk * 3 * TJ + jj;
      acc[0] = fmaf(av, wr[0], acc[0]);
      acc[1] = fmaf(av, wr[TJ], acc[1]);
      acc[2] = fmaf(av, wr[2 * TJ], acc[2]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
gru_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                const T* __restrict__ w_i, const T* __restrict__ w_h,
                const T* __restrict__ b_i, const T* __restrict__ b_h,
                T* __restrict__ out, int batch, int in_dim, int hid) {
  __shared__ float as[KC * TB];
  __shared__ float ws[KC * 3 * TJ];
  const int j0 = blockIdx.x * TJ, b0 = blockIdx.y * TB;
  float ai[3] = {0.f, 0.f, 0.f}, ah[3] = {0.f, 0.f, 0.f};
  gate_products(x, w_i, batch, in_dim, hid, b0, j0, as, ws, ai);
  gate_products(h, w_h, batch, hid, hid, b0, j0, as, ws, ah);
  const int b = b0 + threadIdx.x / TJ, j = j0 + threadIdx.x % TJ;
  if (b >= batch || j >= hid) return;
  const float ir = ai[0] + to_f32(b_i[j]);
  const float iz = ai[1] + to_f32(b_i[hid + j]);
  const float in_ = ai[2] + to_f32(b_i[2 * hid + j]);
  const float hr = ah[0] + to_f32(b_h[j]);
  const float hz = ah[1] + to_f32(b_h[hid + j]);
  const float hn = ah[2] + to_f32(b_h[2 * hid + j]);
  const float r = sigmoid(ir + hr);
  const float z = sigmoid(iz + hz);
  const float n = tanhf(in_ + r * hn);
  const float hv = to_f32(h[(size_t)b * hid + j]);
  store(out + (size_t)b * hid + j, (1.f - z) * n + z * hv);
}

template <typename T>
cudaError_t launch(const void* x, const void* h, const void* w_i,
                   const void* w_h, const void* b_i, const void* b_h,
                   void* out, int batch, int in_dim, int hid,
                   cudaStream_t stream) {
  const int n_j = (hid + TJ - 1) / TJ, n_b = (batch + TB - 1) / TB;
  if (n_b > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(n_j, n_b);
  gru_cell_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(w_i), static_cast<const T*>(w_h),
      static_cast<const T*>(b_i), static_cast<const T*>(b_h),
      static_cast<T*>(out), batch, in_dim, hid);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). Pointers are device pointers
// of contiguous tensors, all of one dtype: 0 = float32, 1 = bfloat16.
int gru_cell_launch(const void* x, const void* h, const void* w_i,
                    const void* w_h, const void* b_i, const void* b_h,
                    void* out, int batch, int in_dim, int hid, int dtype,
                    void* stream) {
  if (batch <= 0 || in_dim <= 0 || hid <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)launch<float>(x, h, w_i, w_h, b_i, b_h, out, batch, in_dim,
                              hid, st);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, h, w_i, w_h, b_i, b_h, out, batch,
                                      in_dim, hid, st);
  return (int)cudaErrorInvalidValue;
}

const char* gru_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
