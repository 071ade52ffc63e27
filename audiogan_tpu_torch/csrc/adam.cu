// Adam's step-dependent update from scalars in device memory, for Hopper
// (sm_90a).
//
// train/state.py::Adam runs torch.optim.Adam's foreach update. Its first
// ops (lerp, mul, addcmul on the moments) use constants of the run; the
// rest use two scalars per tensor that change with Adam's count t:
//
//   den = sqrt(exp_avg_sq)                 _foreach_sqrt
//   den = den / bias2[i]                   _foreach_div_(den, scalar list)
//   den = den + eps                        _foreach_add_(den, eps)
//   p   = p + step_size[i] * (exp_avg / den)   _foreach_addcdiv_(p, ..., list)
//
// with bias2 = sqrt(1 - b2^t) and step_size = -(lr / (1 - b1^t)), computed
// on the host in double and rounded to float, as torch's foreach kernels
// take them. A CUDA graph bakes a kernel's arguments in, so here the two
// scalars are read from a device buffer, [2, n] floats (row 0 the step
// sizes, row 1 the bias corrections, column slot[i] for tensor i), which
// the host rewrites before each replay. The arithmetic is that of torch's
// foreach kernels in f32: IEEE sqrt and division (torch builds without
// fast math), the add, and addcdiv's `p + s * q` contracted to one fma
// (nvcc's default -fmad, as torch's PointwiseOpScalarListFunctor is
// compiled), written here with the rounding intrinsics so no flag can
// change them. The four ops are fused: den never reaches memory, and each
// element reads p, exp_avg and exp_avg_sq once and writes p once (16
// bytes), so the kernel is bound by bytes.
//
// Design: one launch per table of up to kMaxTensors tensors, passed by
// value (its pointers fixed, as a graph needs them); each tensor is cut
// into chunks of kChunk elements and each block takes one chunk of one
// tensor (first_block is the prefix sum of the chunk counts), its threads
// striding through the chunk. Tensors are contiguous f32 (ZeRO-1's row
// blocks are contiguous views); any alignment.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxTensors = 48;  // kernels/adam.py ADAM_MAX_TENSORS
constexpr int kThreads = 256;
constexpr int kChunk = 8192;     // kernels/adam.py ADAM_CHUNK

// kernels/adam.py's _Table; outside the unnamed namespace, so that the C
// entry points taking it keep their external names
struct AdamTable {
  float* p[kMaxTensors];
  const float* exp_avg[kMaxTensors];
  const float* exp_avg_sq[kMaxTensors];
  long long n[kMaxTensors];
  int slot[kMaxTensors];
  int first_block[kMaxTensors + 1];
  int count;
};

namespace {

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const __grid_constant__ AdamTable t,
                   const float* __restrict__ scalars, int n_scalars,
                   float eps) {
  const int b = blockIdx.x;
  int i = 0;
  while (i + 1 < t.count && t.first_block[i + 1] <= b) ++i;
  const long long start = (long long)(b - t.first_block[i]) * kChunk;
  const long long end = start + kChunk < t.n[i] ? start + kChunk : t.n[i];
  const float step_size = scalars[t.slot[i]];
  const float bias2 = scalars[n_scalars + t.slot[i]];
  float* __restrict__ p = t.p[i];
  const float* __restrict__ m = t.exp_avg[i];
  const float* __restrict__ v = t.exp_avg_sq[i];
  for (long long j = start + threadIdx.x; j < end; j += kThreads) {
    const float den = __fadd_rn(__fdiv_rn(__fsqrt_rn(v[j]), bias2), eps);
    p[j] = __fmaf_rn(step_size, __fdiv_rn(m[j], den), p[j]);
  }
}

}  // namespace

extern "C" {

// The table's layout, for the caller's check.
int adam_table_bytes() { return (int)sizeof(AdamTable); }

// One launch over table's tensors; scalars a device pointer to [2,
// n_scalars] floats. Returns a cudaError_t code (0 = launched).
int adam_launch(const AdamTable* table, const float* scalars, int n_scalars,
                float eps, void* stream) {
  const int count = table->count;
  if (count < 1 || count > kMaxTensors || n_scalars < 1)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    const long long chunks = (table->n[i] + kChunk - 1) / kChunk;
    if (table->n[i] < 1 || table->slot[i] < 0 ||
        table->slot[i] >= n_scalars ||
        table->first_block[i + 1] - table->first_block[i] != chunks)
      return (int)cudaErrorInvalidValue;
  }
  adam_update_kernel<<<table->first_block[count], kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *table, scalars, n_scalars, eps);
  return (int)cudaGetLastError();
}

const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
