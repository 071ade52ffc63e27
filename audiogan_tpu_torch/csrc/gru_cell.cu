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
// gate tensors. r, z and n of a hidden unit meet in one block. The TPU
// kernel holds both weight matrices in VMEM for a batch block and falls
// back to XLA above 12 MB of weights; that is a limit of the TPU's VMEM,
// not of the function, and this kernel takes any size.
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 3.35 TB/s HBM): at
// cond_gru_sc09's cell (B=64, in = H = 512) it does 0.2 GFLOP against
// 3.3 MB of bf16 operands, about 60 flops per byte, so it is bound by
// bytes (about 1 us): the weights, read once. Two paths, chosen by
// kernels/gru.py::gru_cell_tensor_core, a pure function of dtype and
// shape:
//  * the tensor-core path (gru_cell_tc_kernel): bf16, B <= 64, in and H
//    multiples of 8. A block owns U = 16 hidden units and every batch row;
//    r and z accumulate their columns j and H + j over the concatenated
//    depth of x || h, i_n and h_n keep their own accumulators (n = tanh(i_n
//    + r h_n)). The depth, in k-steps of 16, is split across the D blocks
//    of a thread-block cluster (kernels/gru.py::gru_cell_plan: 32 unit
//    tiles x D = 8 = 256 blocks at cond_gru_sc09), so every weight byte is
//    read once across the grid. Each k-step's x (or h) rows and weight
//    columns stream through a ring of kStages cp.async stages, loads
//    running kStages - 1 k-steps ahead of the products, which run on
//    mma.sync m16n8k16 (bf16 in, f32 accumulate; one warp per 16 rows).
//    The D partial sums meet through distributed shared memory, added in
//    rank order (no atomics: two launches give the same bits), and each
//    rank finishes a share of the (row, unit) outputs: biases, gates and
//    the blend in f32, one rounding of h';
//  * the CUDA-core path (gru_cell_kernel): f32, and the rest. One output
//    per thread in 16 x 16 tiles, six f32 accumulators fed by scalar FMAs,
//    each weight chunk read once per row tile.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

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


// -- the tensor-core path -----------------------------------------------------

constexpr int kUnits = 16;        // hidden units per block: two n8 tiles
constexpr int kMaxRows = 64;      // four m16 tiles, one per warp
constexpr int kMaxSplit = 8;      // cluster size: the portable maximum
constexpr int kStages = 6;        // cp.async ring depth, one k-step each
constexpr int kTcThreads = 128;
constexpr int kAStride = 24;      // bf16 per staged x/h row (48 bytes:
                                  // ldmatrix's 8 rows hit distinct banks)
constexpr int kWStride = 56;      // bf16 per staged weight row (112 bytes)
constexpr int kPlanHead = 4;      // units, split, kx, kt; then start[split + 1]

// The depth split of kernels/gru.py::gru_cell_plan: k-step s < kx reads
// x's columns [16 s, 16 s + 16) and w_i's rows; s >= kx reads h's and
// w_h's at 16 (s - kx). Cluster rank q takes k-steps [start[q],
// start[q + 1]).
struct CellPlan {
  int split, kx, kt;
  int start[kMaxSplit + 1];
};

__device__ __forceinline__ void copy16_async(void* dst, const void* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes 16 zero bytes: the ragged rows, columns and depth
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copies_wait_pending() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

struct CellArgs {
  const __nv_bfloat16 *x, *h, *w_i, *w_h, *b_i, *b_h;
  __nv_bfloat16* out;
  int batch, in_dim, hid;
};

__global__ void __launch_bounds__(kTcThreads)
gru_cell_tc_kernel(const CellArgs a, const CellPlan p) {
  __shared__ __align__(128) __nv_bfloat16 xs[kStages][kMaxRows][kAStride];
  __shared__ __align__(128) __nv_bfloat16 ws[kStages][16][kWStride];
  __shared__ float red[4][kMaxRows][kUnits];   // r, z, i_n, h_n partials
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int j0 = (blockIdx.x / p.split) * kUnits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = p.start[rank], n = p.start[rank + 1] - s0;

  // stage k-step s into ring slot st: x/h rows [0, 64) x 16 columns (one
  // 16-byte copy per thread), and the 16 weight rows of the block's 16
  // units of each gate (96 copies)
  auto load = [&](int s, int st) {
    const bool hpart = s >= p.kx;
    const int k0 = 16 * (hpart ? s - p.kx : s);
    const int depth = hpart ? a.hid : a.in_dim;
    const __nv_bfloat16* act = hpart ? a.h : a.x;
    const __nv_bfloat16* w = hpart ? a.w_h : a.w_i;
    {
      const int row = tid >> 1, col = k0 + 8 * (tid & 1);
      const bool ok = row < a.batch && col < depth;
      copy16_async(&xs[st][row][8 * (tid & 1)],
                   ok ? act + (size_t)row * depth + col : act, ok);
    }
    if (tid < 96) {
      const int kr = tid / 6, g = (tid % 6) >> 1, half = tid & 1;
      const int col = j0 + 8 * half;
      const bool ok = k0 + kr < depth && col < a.hid;
      copy16_async(&ws[st][kr][16 * g + 8 * half],
                   ok ? w + (size_t)(k0 + kr) * 3 * a.hid + g * a.hid + col
                      : w, ok);
    }
  };

  float acc[4][2][4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][t][c] = 0.f;
  const bool live = 16 * warp < a.batch;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(s0 + i, i);
    copies_commit();
  }
  for (int i = 0; i < n; ++i) {
    copies_wait_pending<kStages - 2>();
    __syncthreads();   // k-step i has landed; slot (i - 1) % kStages is free
    if (i + kStages - 1 < n) load(s0 + i + kStages - 1, (i + kStages - 1) % kStages);
    copies_commit();
    if (!live) continue;
    const int st = i % kStages;
    const bool hpart = s0 + i >= p.kx;
    uint32_t af[4];
    ldmatrix_x4(af, &xs[st][16 * warp + (lane & 15)][8 * (lane >> 4)], false);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      uint32_t bf[4];
      ldmatrix_x4(bf, &ws[st][lane & 15][16 * g + 8 * (lane >> 4)], true);
      auto mma2 = [&](float (&d)[2][4]) {
        mma::mma16816(d[0], af, make_uint2(bf[0], bf[1]));
        mma::mma16816(d[1], af, make_uint2(bf[2], bf[3]));
      };
      // x's n columns feed i_n, h's feed h_n (constant indices: the
      // accumulators stay in registers)
      if (g < 2)
        mma2(acc[g]);
      else if (hpart)
        mma2(acc[3]);
      else
        mma2(acc[2]);
    }
  }

  // partial sums to shared memory (m16n8 layout: thread (g, t) holds rows
  // g, g + 8 and columns 2t, 2t + 1 of each n8 tile)
  if (live) {
    const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        red[g][r0][8 * t + c0] = acc[g][t][0];
        red[g][r0][8 * t + c0 + 1] = acc[g][t][1];
        red[g][r0 + 8][8 * t + c0] = acc[g][t][2];
        red[g][r0 + 8][8 * t + c0 + 1] = acc[g][t][3];
      }
  }
  cluster.sync();

  // rank q finishes outputs e = q * 128 + tid (+ split * 128 ...): the
  // split partials added in rank order, then the gates in f32
  const int H = a.hid;
  for (int e = rank * kTcThreads + tid; e < a.batch * kUnits;
       e += p.split * kTcThreads) {
    const int row = e / kUnits, u = e % kUnits, j = j0 + u;
    if (j >= H) continue;
    float s[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float* r0 = cluster.map_shared_rank(&red[g][row][u], 0);
      s[g] = *r0;
    }
    for (int q = 1; q < p.split; ++q)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        s[g] += *cluster.map_shared_rank(&red[g][row][u], q);
    const float r = sigmoid(s[0] + __bfloat162float(a.b_i[j]) +
                            __bfloat162float(a.b_h[j]));
    const float z = sigmoid(s[1] + __bfloat162float(a.b_i[H + j]) +
                            __bfloat162float(a.b_h[H + j]));
    const float nn = tanhf(s[2] + __bfloat162float(a.b_i[2 * H + j]) +
                           r * (s[3] + __bfloat162float(a.b_h[2 * H + j])));
    const float hv = __bfloat162float(a.h[(size_t)row * H + j]);
    a.out[(size_t)row * H + j] = __float2bfloat16((1.f - z) * nn + z * hv);
  }
  cluster.sync();   // no block leaves while another reads its partials
}

cudaError_t launch_tc(const void* x, const void* h, const void* w_i,
                      const void* w_h, const void* b_i, const void* b_h,
                      void* out, int batch, int in_dim, int hid,
                      const int* plan, cudaStream_t stream) {
  if (batch > kMaxRows || in_dim % 8 || hid % 8)
    return cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)h | (uintptr_t)w_i | (uintptr_t)w_h) & 15)
    return cudaErrorMisalignedAddress;
  CellPlan p;
  p.split = plan[1]; p.kx = plan[2]; p.kt = plan[3];
  if (plan[0] != kUnits || p.split < 1 || p.split > kMaxSplit ||
      p.kx != (in_dim + 15) / 16 || p.kt != p.kx + (hid + 15) / 16)
    return cudaErrorInvalidValue;
  for (int q = 0; q <= p.split; ++q) {
    p.start[q] = plan[kPlanHead + q];
    if (q > 0 && p.start[q] <= p.start[q - 1]) return cudaErrorInvalidValue;
  }
  if (p.start[0] != 0 || p.start[p.split] != p.kt)
    return cudaErrorInvalidValue;
  CellArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.w_i = static_cast<const __nv_bfloat16*>(w_i);
  a.w_h = static_cast<const __nv_bfloat16*>(w_h);
  a.b_i = static_cast<const __nv_bfloat16*>(b_i);
  a.b_h = static_cast<const __nv_bfloat16*>(b_h);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.batch = batch; a.in_dim = in_dim; a.hid = hid;
  const int tiles = (hid + kUnits - 1) / kUnits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.split);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, gru_cell_tc_kernel, a, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). Pointers are device pointers
// of contiguous tensors, all of one dtype: 0 = float32, 1 = bfloat16.
// plan: kernels/gru.py::gru_cell_plan's int32 array for the tensor-core
// path (bf16 only; pointers 16-byte aligned), or null for the CUDA cores.
int gru_cell_launch(const void* x, const void* h, const void* w_i,
                    const void* w_h, const void* b_i, const void* b_h,
                    void* out, int batch, int in_dim, int hid, int dtype,
                    const int* plan, void* stream) {
  if (batch <= 0 || in_dim <= 0 || hid <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan != nullptr)
    return dtype == DT_BF16 ? (int)launch_tc(x, h, w_i, w_h, b_i, b_h, out,
                                             batch, in_dim, hid, plan, st)
                            : (int)cudaErrorInvalidValue;
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
