// Fused ingest of int16 store rows for Hopper (sm_90a): crop, cast,
// amplitude normalization and mu-law companding in one launch.
//
// Replaces audiogan_tpu/kernels/ingest.py::ingest_fused and its body
// _kernel. For each row b:
//
//   x[i]  = raw[b, offs[b] + i] / 32768      (0 where offs[b] + i lies
//                                            outside [0, store): a store
//                                            row shorter than the clip is
//                                            zero-padded here)
//   scale = max_i |x[i]|  (peak)   or   sqrt(sum_i x[i]^2 / clip)  (rms)
//   x[i] *= target / max(scale, eps)        (mode none skips this)
//   y[b, i] = sign(x) * log1p(mu |x|) / log1p(mu)   (mu = 0 skips this)
//
// What bounds it on an H100: at the flagship's 64 x 16384 batch, neither
// bytes nor flops but latency and instructions. The bytes (2 B in, 4 B out
// per sample, 6.3 MB) take 1.9 us at 3.35 TB/s; the first design (one
// block per row, two sweeps) took 8.5 us of device time, and one with a
// cluster per row but the same per-sample code 8.9 us, which dropping
// its loads or its stores hardly moved: libdevice's log1pf and an IEEE
// division per sample, 64-bit index arithmetic, and the partials pulled
// through distributed shared memory one at a time set it. This one takes
// about 5 us; what remains is a chain of dependent steps (the launch,
// offs, the row's load, two cluster barriers, the 4 MB of stores), and
// without the reduction (mode none) it takes 3.7 us. The design:
//  * one thread-block cluster of C blocks (4 or 8) per row, so B = 64
//    gives 256 or 512 blocks on the 132 SMs. Rank r owns the output slice
//    [r L, r L + L) with L = ceil(clip / C) rounded up to 8 samples
//    (kernels/ingest.py::ingest_plan is the same partition, tested on the
//    CPU);
//  * the rank's crop samples cross device memory once: 16-byte loads
//    into registers of the aligned vectors wholly inside the row's
//    samples, the unaligned head and tail (fewer than 8 samples each) one
//    at a time. Each thread folds its samples into its partial peak or
//    sum of squares from registers and stages them, as int16, in shared
//    memory. Any offset takes this one path;
//  * each warp's partial (a fixed xor tree) is pushed into every rank's
//    shared memory, after a cluster barrier arrived at on entry shows
//    every block of the cluster running; one more cluster barrier, and
//    each warp adds the C x 8 warp partials by a fixed tree (slots l and
//    l + 32 in lane l, then an xor tree), so two launches give the same
//    bits (max is exact in any order). No
//    block reads another's shared memory after that barrier, so none
//    waits for the others before it leaves;
//  * outputs are read back from shared memory at the crop's shift, four
//    samples in one 8-byte read where that shift allows, normalized,
//    companded as sign(x) log(1 + mu |x|) / log1p(mu) with the hardware
//    log (__logf: at most 3e-7 absolute on y in [-1, 1]) and a
//    reciprocal, and written with 16-byte stores (an unaligned head and
//    tail one float at a time).
// mode none needs no reduction and no cluster barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum Mode { MODE_NONE = 0, MODE_PEAK = 1, MODE_RMS = 2 };
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kVec = 8;           // int16 samples per 16-byte load
constexpr int kOutVec = 4;        // f32 samples per 16-byte store
constexpr int kMaxSlice = 98304;  // kernels/ingest.py INGEST_MAX_SLICE
constexpr float kScale = 1.0f / 32768.0f;

__host__ __device__ __forceinline__ long long round_up(long long a, int m) {
  return (a + m - 1) / m * m;
}

__device__ __forceinline__ float fold(float acc, float x, int mode) {
  return mode == MODE_PEAK ? fmaxf(acc, fabsf(x)) : fmaf(x, x, acc);
}

__device__ __forceinline__ float combine(float a, float b, int mode) {
  return mode == MODE_PEAK ? fmaxf(a, b) : a + b;
}

__global__ void __launch_bounds__(kThreads)
ingest_cluster_kernel(const int16_t* __restrict__ raw,
                      const int* __restrict__ offs, float* __restrict__ out,
                      int store, int clip, int slice, int n_rank, int mode,
                      float target, float mu, float eps) {
  extern __shared__ __align__(16) int16_t stage[];
  __shared__ float parts[kMaxCluster * kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  if (mode != MODE_NONE)    // waited on before the first remote store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / n_rank;
  const int tid = threadIdx.x;
  const int off = __ldg(offs + b);
  const int lo = min(rank * slice, clip), hi = min(lo + slice, clip);

  // the row's samples this rank reads, [s_lo, s_hi), inside [0, store)
  const int s_lo = (int)min(max((long long)off + lo, 0LL), (long long)store);
  const int s_hi = (int)max(min((long long)off + hi, (long long)store),
                            (long long)s_lo);
  // as absolute indices from the 16-byte boundary at or below raw
  const int16_t* raw_al =
      reinterpret_cast<const int16_t*>((uintptr_t)raw & ~(uintptr_t)15);
  const long long row0 = (long long)(((uintptr_t)raw & 15) / 2) +
                         (long long)b * store;
  const long long a_lo = row0 + s_lo, a_hi = row0 + s_hi;
  const long long v0 = a_lo / kVec;          // staging starts at its vector
  const int slot0 = (int)(a_lo - kVec * v0);  // sample s_lo's slot, < 8

  float red = 0.f;
  {
    const long long h_end = min(round_up(a_lo, kVec), a_hi);
    const long long t_beg = max(a_hi / kVec * kVec, h_end);
    const long long va = (h_end + kVec - 1) / kVec, vb = t_beg / kVec;
    const int4* raw_v = reinterpret_cast<const int4*>(raw_al);
    for (long long v = va + tid; v < vb; v += kThreads) {
      const int4 w = __ldg(raw_v + v);
      *reinterpret_cast<int4*>(stage + kVec * (v - v0)) = w;
      if (mode != MODE_NONE) {
        const int word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          red = fold(red, (float)(int16_t)word[k] * kScale, mode);
          red = fold(red, (float)(word[k] >> 16) * kScale, mode);
        }
      }
    }
    long long a = -1;
    if (tid < kVec) {
      a = a_lo + tid;
      if (a >= h_end) a = -1;
    } else if (tid < 2 * kVec) {
      a = t_beg + tid - kVec;
      if (a >= a_hi) a = -1;
    }
    if (a >= 0) {
      const int16_t x = raw_al[a];
      stage[a - kVec * v0] = x;
      red = fold(red, (float)x * kScale, mode);
    }
  }

  float factor = 1.f;
  if (mode != MODE_NONE) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      red = combine(red, __shfl_xor_sync(0xffffffffu, red, d), mode);
    // every block of the cluster has started: push this warp's partial
    // to each rank, into slot (rank, warp)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < n_rank)
      *cluster.map_shared_rank(&parts[rank * kWarps + warp], lane) = red;
    cluster.sync();   // the partials have landed; the staging is visible
    // lane l adds slots l and l + 32, then a fixed xor tree over lanes
    const int n = n_rank * kWarps;
    float total = lane < n ? parts[lane] : 0.f;
    total = combine(total, lane + 32 < n ? parts[lane + 32] : 0.f, mode);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      total = combine(total, __shfl_xor_sync(0xffffffffu, total, d), mode);
    const float scale = mode == MODE_PEAK ? total : sqrtf(total / (float)clip);
    factor = target / fmaxf(scale, eps);
  } else {
    __syncthreads();
  }

  // output o reads live sample d = o - rel (0 <= d < n_live) at slot
  // slot0 + d; every other output reads 0
  const int n_live = s_hi - s_lo;
  const int rel = n_live > 0 ? (int)((long long)s_lo - off) : 0;
  const float inv_log1p_mu = mu > 0.f ? 1.f / log1pf(mu) : 0.f;
  auto finish = [&](float x) -> float {
    if (mode != MODE_NONE) x *= factor;
    if (mu > 0.f)
      x = copysignf(__logf(fmaf(mu, fabsf(x), 1.f)) * inv_log1p_mu, x);
    return x;
  };
  auto value = [&](int o) -> float {
    const int d = o - rel;
    return finish((unsigned)d < (unsigned)n_live
                      ? (float)stage[slot0 + d] * kScale : 0.f);
  };
  float* out_al = reinterpret_cast<float*>((uintptr_t)out & ~(uintptr_t)15);
  const long long orow0 = (long long)(((uintptr_t)out & 15) / 4) +
                          (long long)b * clip;
  const long long q_lo = orow0 + lo, q_hi = orow0 + hi;
  const long long h_end = min(round_up(q_lo, kOutVec), q_hi);
  const long long t_beg = max(q_hi / kOutVec * kOutVec, h_end);
  const long long ua = (h_end + kOutVec - 1) / kOutVec, ub = t_beg / kOutVec;
  for (long long u = ua + tid; u < ub; u += kThreads) {
    const int o = (int)(kOutVec * u - orow0);
    const int d = o - rel;
    float4 r;
    if (d >= 0 && d + kOutVec <= n_live && ((slot0 + d) & 3) == 0) {
      const int2 w = *reinterpret_cast<const int2*>(stage + slot0 + d);
      r = make_float4(finish((float)(int16_t)w.x * kScale),
                      finish((float)(w.x >> 16) * kScale),
                      finish((float)(int16_t)w.y * kScale),
                      finish((float)(w.y >> 16) * kScale));
    } else {
      r = make_float4(value(o), value(o + 1), value(o + 2), value(o + 3));
    }
    reinterpret_cast<float4*>(out_al)[u] = r;
  }
  if (tid < kOutVec) {
    const long long q = q_lo + tid;
    if (q < h_end) out_al[q] = value((int)(q - orow0));
  } else if (tid < 2 * kOutVec) {
    const long long q = t_beg + tid - kOutVec;
    if (q < q_hi) out_al[q] = value((int)(q - orow0));
  }
}

}  // namespace

extern "C" {

// raw int16 [batch, store], offs int32 [batch], out float32 [batch, clip];
// all device pointers of contiguous tensors; cluster = blocks per row (4
// or 8). Returns a cudaError_t code.
int ingest_launch(const void* raw, const void* offs, void* out, int batch,
                  int store, int clip, int mode, float target, float mu,
                  float eps, int cluster, void* stream) {
  if (batch <= 0 || store <= 0 || clip <= 0 || mode < MODE_NONE ||
      mode > MODE_RMS || (cluster != 4 && cluster != kMaxCluster) ||
      (long long)batch * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int slice = (int)round_up((clip + cluster - 1) / cluster, kVec);
  if (slice > kMaxSlice) return (int)cudaErrorInvalidValue;
  // the staged vectors: at most slice / 8 + 1 of them
  const size_t smem = (size_t)(slice + kVec) * sizeof(int16_t);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(ingest_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ingest_cluster_kernel,
                         static_cast<const int16_t*>(raw),
                         static_cast<const int*>(offs),
                         static_cast<float*>(out), store, clip, slice,
                         cluster, mode, target, mu, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* ingest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
