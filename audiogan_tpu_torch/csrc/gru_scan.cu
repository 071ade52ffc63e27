// The GRU generator's frame recurrence for Hopper (sm_90a): the whole scan
// forward (K4) and its reverse-sweep backward (K5), one C entry point each.
//
// Replaces audiogan_tpu/kernels/gru.py::_gru_scan_impl (bodies
// _gru_scan_kernel and _gru_scan_kernel_h) and ::_gru_scan_bwd (body
// _gru_scan_bwd_kernel). Same function, per frame t:
//
//   x_t    = [feat_{t-1} @ w_ar, cond]                 feat_{-1} = 0
//   r, z   = sigmoid(x_t w_i{r,z} + b_i{r,z} + h_{t-1} w_h{r,z} + b_h{r,z})
//   n      = tanh(x_t w_in + b_in + r * (h_{t-1} w_hn + b_hn))
//   h_t    = (1 - z) * n + z * h_{t-1}
//   feat_t = tanh(h_t @ w_out + b_out)
//
// with the TPU kernel's numerics: weights (f32 or bf16) are widened to f32
// at each use, h and feat are carried in f32 across frames (the
// autoregressive input is the f32 feat, not the rounded output), and feat_t
// (and h_t, for the backward) are rounded to the input dtype only where
// they are written out. The backward recomputes each frame's gates from the
// stored, rounded residuals (h_{t-1}, feat_{t-1}), as the reference does,
// and returns every gradient in the dtype of its primal.
//
// What bounds it on an H100: at cond_gru_sc09 (B=64, H=512, F=256, 256
// frames) the forward is 58 GFLOP and moves a few MB, so its bound is
// operations (0.06 ms on the bf16 tensor cores); the backward is 3x that.
// But the recurrence is sequential: each frame is four products of a
// 64-row operand, far too small to fill 132 SMs, and one frame cannot start
// before the last has ended. So the time goes to the chain of dependent
// phases, not to arithmetic. Two paths, chosen by kernels/gru.py
// (gru_scan_persistent, which passes a plan):
//  * bf16 (B <= 64, H and F multiples of 16): one persistent cooperative
//    launch per scan (scan_fwd_persistent, K4) and per reverse sweep
//    (scan_bwd_persistent, K5). As on the TPU, where the weights stay in
//    VMEM, the weights stay resident for the whole scan: each block owns
//    the plan's slice of batch rows, hidden units and feature columns, and
//    keeps the matching slices of w_i, w_h, w_out and w_ar (2.75 MB in
//    all, 128 blocks at cond_gru_sc09) in shared memory. A frame is three
//    dependent phases, each ended by a grid barrier (a counter in device
//    memory: release add, acquire spin, 10 s trap); the per-frame products
//    run on the tensor cores (mma.sync m16n8k16), the carried f32
//    activations read from L2 and split into bf16 hi and lo passes so
//    they keep 16 bits. The forward takes the cond half of the gate
//    product once per scan and computes h_t w_h for the next frame's gates
//    in the same phase as the head (both read h_t). The backward's
//    recompute of every frame's gates before the sweep and its weight
//    gradients after it are products over all n*B rows: tc_gemm_kernel,
//    the same split for f32 operands; the sweep itself sums dgi, dgh and
//    dfp over the frames for the bias gradients;
//  * f32 and every other shape: the host loop of the first design, one
//    tiled f32 product on the CUDA cores (gemm_kernel: 256 threads, 4x4
//    or 8x8 outputs each, operands staged through shared memory as f32,
//    any strides, so every transpose is a view) with a fused bias / tanh /
//    accumulate epilogue and an optional rounded copy, its depth split
//    over more blocks (and a reduce kernel) when the product is too small
//    to fill the card; elementwise kernels for the gate blend and its
//    backward; per frame three products and the blend forward, four
//    products and two elementwise kernels in the backward's sweep, which
//    carries only dh [B,H] and the autoregressive dfeat [B,F] and writes
//    each frame's gate gradients for the weight-gradient products.
// Every sum has a fixed order (no atomics in the arithmetic: the blocks'
// partial sums are added in warp order, split depths in slice order), so
// a result is the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_sync.cuh"

namespace {

using mma::bf16_pair;
using mma::mma16816;
using mma::split_pair;

enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum Act { ACT_NONE = 0, ACT_TANH = 1 };

constexpr int kThreads = 256;   // every kernel's block size

__device__ __forceinline__ float ld(const void* p, size_t i, int dt) {
  return dt == DT_BF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, size_t i, int dt, float v) {
  if (dt == DT_BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// A strided 2-D operand: element (r, c) at p[r * rs + c * cs].
struct Mat {
  const void* p;
  long long rs, cs;
  int dt;
};

// C[m, n] = act((accumulate ? C : 0) + sum_k A[m, k] B[k, n] + bias[n]),
// written as f32 to c (if set) and rounded to c2dt into c2 (if set).
struct Gemm {
  Mat a, b;
  float* c;
  long long ldc;
  void* c2;
  long long ldc2;
  int c2dt;
  const void* bias;
  int bias_dt;
  int m, n, k;
  int accumulate, act;
};

// The result's epilogue at (m, n): accumulate, bias, act, then the f32
// and the rounded stores.
__device__ __forceinline__ void epilogue(const Gemm& g, int m, int n,
                                         float v) {
  if (g.accumulate) v = g.c[(size_t)m * g.ldc + n] + v;
  if (g.bias) v = v + ld(g.bias, n, g.bias_dt);
  if (g.act == ACT_TANH) v = tanhf(v);
  if (g.c) g.c[(size_t)m * g.ldc + n] = v;
  if (g.c2) st(g.c2, (size_t)m * g.ldc2 + n, g.c2dt, v);
}

// One BM x BN tile of g over the depths [kb, ke). The 256 threads form
// KS groups of (BM/TM) x (BN/TN); thread (ty, tx) of a group owns the
// TM x TN block of rows
// ty*TM.. and columns tx*TN.., read from shared memory as float4s, and
// group q sums the depths q*BK/KS .. (q+1)*BK/KS - 1 of every chunk (for
// the 32x32 tile of the 64-row per-frame products: 4 groups, so each
// thread keeps a 4x4 block and a chunk's depth is shared four ways). The
// groups' sums are added in group order at the end; each group sums its
// depths in order, one fma per term. Each thread stages 8 elements of A
// and 8 of B per chunk; the next chunk's loads are issued before the
// current chunk's products, so their latency (the operands come from L2)
// overlaps the arithmetic. With `partial` set the raw sums go there
// ([m, n], for a reduce kernel to finish); else the epilogue runs.
template <int BM, int BN, int BK, int TM, int TN>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int kb, int ke,
                                          float* partial) {
  constexpr int TX = BN / TN, GROUP = (BM / TM) * TX;
  constexpr int KS = kThreads / GROUP, KG = BK / KS;
  constexpr int LA = BM * BK / kThreads, LB = BK * BN / kThreads;
  // rows padded by 4 floats: 16-byte aligned for the float4 reads
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN + 4];
  __shared__ float red[KS > 1 ? (KS - 1) * BM * BN : 1];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= g.m || n0 >= g.n) return;  // the smaller problem of a pair
  const int tid = threadIdx.x, grp = tid / GROUP;
  const int tx = tid % GROUP % TX, ty = tid % GROUP / TX;
  const bool a_k_fast = g.a.cs == 1, b_n_fast = g.b.cs == 1;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // element e of a chunk: A row i, depth kk (or B depth kk, column j),
  // with the index that is contiguous in memory fastest across threads
  float ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * kThreads;
      const int i = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int m = m0 + i, k = k0 + kk;
      ra[l] = (m < g.m && k < ke)
                  ? ld(g.a.p, (size_t)m * g.a.rs + (size_t)k * g.a.cs,
                       g.a.dt)
                  : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * kThreads;
      const int j = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const int n = n0 + j, k = k0 + kk;
      rb[l] = (n < g.n && k < ke)
                  ? ld(g.b.p, (size_t)k * g.b.rs + (size_t)n * g.b.cs,
                       g.b.dt)
                  : 0.f;
    }
  };
  fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * kThreads;
      as[a_k_fast ? e % BK : e / BM][a_k_fast ? e / BK : e % BM] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * kThreads;
      bs[b_n_fast ? e / BN : e % BK][b_n_fast ? e % BN : e / BK] = rb[l];
    }
    __syncthreads();
    if (k0 + BK < ke) fetch(k0 + BK);
#pragma unroll
    for (int kq = 0; kq < KG; ++kq) {
      const int kk = grp * KG + kq;
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&as[kk][ty * TM + 4 * q]);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&bs[kk][tx * TN + 4 * q]);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (KS > 1) {  // groups 1.. park their sums; group 0 adds them in order
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          red[((grp - 1) * BM + ty * TM + i) * BN + tx * TN + j] = acc[i][j];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int q = 0; q < KS - 1; ++q)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += red[(q * BM + ty * TM + i) * BN + tx * TN + j];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= g.n) continue;
      if (partial)
        partial[(size_t)m * g.n + n] = acc[i][j];
      else
        epilogue(g, m, n, acc[i][j]);
    }
  }
}

// blockIdx.z = problem * splits + split: one of two independent problems
// of one launch and, when splits > 1, one kper-deep slice of its depth,
// whose raw sums go to p0 / p1 + split * m * n. The tiles: 128x128 (BK 16,
// 8x8 per thread), 64x64 (BK 32, 4x4) and 32x32 (BK 64, 4x4, four depth
// groups), each with at most 31 KB of shared memory.
template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(Gemm g0, Gemm g1, int splits, int kper, float* p0, float* p1) {
  const int prob = blockIdx.z / splits, split = blockIdx.z % splits;
  const int kb = split * kper;
  if (prob == 0)
    gemm_tile<BM, BN, BK, TM, TN>(
        g0, kb, min(g0.k, kb + kper),
        p0 ? p0 + (size_t)split * g0.m * g0.n : nullptr);
  else
    gemm_tile<BM, BN, BK, TM, TN>(
        g1, kb, min(g1.k, kb + kper),
        p1 ? p1 + (size_t)split * g1.m * g1.n : nullptr);
}

// Finishes a split product: the slices' sums added in slice order, then
// the epilogue. blockIdx.z picks the problem.
__device__ __forceinline__ void reduce_tile(const Gemm& g, int splits,
                                            const float* p) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t mn = (size_t)g.m * g.n;
  if (idx >= mn) return;
  float v = p[idx];
  for (int s = 1; s < splits; ++s) v += p[s * mn + idx];
  epilogue(g, (int)(idx / g.n), (int)(idx % g.n), v);
}

__global__ void __launch_bounds__(kThreads)
split_reduce_kernel(Gemm g0, Gemm g1, int splits, const float* p0,
                    const float* p1) {
  if (blockIdx.z == 0)
    reduce_tile(g0, splits, p0);
  else
    reduce_tile(g1, splits, p1);
}

// The gate blend over rows x H: gi, gh [rows, 3H] f32 (products without
// bias), prev_h [rows, H] (f32 or dt) -> h_out [rows, H] f32 (may alias
// prev_h), and a rounded copy into h_seq when it is set.
__global__ void __launch_bounds__(kThreads)
gates_kernel(const float* __restrict__ gi, const float* __restrict__ gh,
             const void* bi, const void* bh, int wdt, const void* prev_h,
             int prev_dt, float* h_out, void* h_seq, int seq_dt, int rows,
             int hid) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)rows * hid) return;
  const size_t r = idx / hid;
  const int j = (int)(idx % hid);
  const float* gir = gi + r * 3 * hid;
  const float* ghr = gh + r * 3 * hid;
  const float i_r = gir[j] + ld(bi, j, wdt);
  const float i_z = gir[hid + j] + ld(bi, hid + j, wdt);
  const float i_n = gir[2 * hid + j] + ld(bi, 2 * hid + j, wdt);
  const float h_r = ghr[j] + ld(bh, j, wdt);
  const float h_z = ghr[hid + j] + ld(bh, hid + j, wdt);
  const float h_n = ghr[2 * hid + j] + ld(bh, 2 * hid + j, wdt);
  const float rg = sigmoid(i_r + h_r);
  const float zg = sigmoid(i_z + h_z);
  const float ng = tanhf(i_n + rg * h_n);
  const float hp = ld(prev_h, idx, prev_dt);
  const float h = (1.f - zg) * ng + zg * hp;
  h_out[idx] = h;
  if (h_seq) st(h_seq, idx, seq_dt, h);
}

// The cell's backward for one frame (the reference's _gru_bwd2 order):
// recomputes r, z, n, h_n from gi, gh [B, 3H] and overwrites them with
// dgi = [dr, dz, dn] and dgh = [dr, dz, dn * r]; dh [B, H] becomes dh * z,
// the direct term of dh_{t-1}.
__global__ void __launch_bounds__(kThreads)
cell_bwd_kernel(float* dh, float* gi, float* gh, const void* bi,
                const void* bh, int wdt, const void* prev_h, int prev_dt,
                int rows, int hid) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)rows * hid) return;
  const size_t r = idx / hid;
  const int j = (int)(idx % hid);
  float* gir = gi + r * 3 * hid;
  float* ghr = gh + r * 3 * hid;
  const float i_r = gir[j] + ld(bi, j, wdt);
  const float i_z = gir[hid + j] + ld(bi, hid + j, wdt);
  const float i_n = gir[2 * hid + j] + ld(bi, 2 * hid + j, wdt);
  const float h_r = ghr[j] + ld(bh, j, wdt);
  const float h_z = ghr[hid + j] + ld(bh, hid + j, wdt);
  const float h_n = ghr[2 * hid + j] + ld(bh, 2 * hid + j, wdt);
  const float rg = sigmoid(i_r + h_r);
  const float zg = sigmoid(i_z + h_z);
  const float ng = tanhf(i_n + rg * h_n);
  const float hp = ld(prev_h, idx, prev_dt);
  const float d = dh[idx];
  const float dz = d * (hp - ng) * zg * (1.f - zg);
  const float dn = d * (1.f - zg) * (1.f - ng * ng);
  const float dr = dn * h_n * rg * (1.f - rg);
  gir[j] = dr;
  gir[hid + j] = dz;
  gir[2 * hid + j] = dn;
  ghr[j] = dr;
  ghr[hid + j] = dz;
  ghr[2 * hid + j] = dn * rg;
  dh[idx] = d * zg;
}

// The output head's backward for one frame: dfp = (g_t + dfc) * (1 -
// feat_t^2), g_t row b at g[b * g_rs + f].
__global__ void __launch_bounds__(kThreads)
head_bwd_kernel(const void* g, long long g_rs, int gdt,
                const float* __restrict__ dfc, const float* __restrict__ feat,
                float* __restrict__ dfp, int rows, int feat_dim) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)rows * feat_dim) return;
  const size_t b = idx / feat_dim;
  const int f = (int)(idx % feat_dim);
  const float dfeat = ld(g, b * g_rs + f, gdt) + dfc[idx];
  dfp[idx] = dfeat * (1.f - feat[idx] * feat[idx]);
}

// dst[r, c] = src[r % src_rows, c], converting between dtypes.
__global__ void __launch_bounds__(kThreads)
copy_kernel(void* dst, long long ldd, int ddt, const void* src,
            long long lds, int sdt, int rows, int cols, int src_rows) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)rows * cols) return;
  const size_t r = idx / cols;
  const int c = (int)(idx % cols);
  st(dst, r * ldd + c, ddt, ld(src, (r % src_rows) * lds + c, sdt));
}

// K5's inputs for the products over all n*B rows (row t*B + b): prev_f =
// feat_{t-1} (zeros for t = 0, else feats[b, t-1]) and prev_h = h_{t-1}
// (h0 for t = 0, else h_seq[t-1, b]) in dt, and the cond half of x (f32,
// row stride 2F, columns F..2F-1). Also zeroes the grid barrier's counter
// for the persistent sweep.
__global__ void __launch_bounds__(kThreads)
residuals_kernel(const void* feats, const void* h_seq, const void* h0,
                 const void* cond, int dt, void* prev_f, void* prev_h,
                 float* x, unsigned* bar, int batch, int hid, int feat,
                 int n_frames) {
  const size_t R = (size_t)n_frames * batch;
  size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx == 0) *bar = 0u;
  if (idx < R * feat) {
    const size_t r = idx / feat, f = idx % feat;
    const size_t t = r / batch, b = r % batch;
    st(prev_f, idx, dt,
       t == 0 ? 0.f : ld(feats, (b * n_frames + t - 1) * feat + f, dt));
    x[r * 2 * feat + feat + f] = ld(cond, b * feat + f, dt);
    return;
  }
  idx -= R * feat;
  if (idx < R * hid) {
    const size_t r = idx / hid, j = idx % hid;
    const size_t t = r / batch, b = r % batch;
    st(prev_h, idx, dt,
       t == 0 ? ld(h0, b * hid + j, dt)
              : ld(h_seq, ((t - 1) * batch + b) * hid + j, dt));
  }
}

// Column sums of x [rows, cols] f32 in two passes with a fixed order:
// partial[chunk, c] over `per` rows each, then the chunks in order.
__global__ void __launch_bounds__(kThreads)
colsum_partial_kernel(const float* __restrict__ x, int rows, int cols,
                      int per, float* __restrict__ partial) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * per;
  const int r1 = min(r0 + per, rows);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += x[(size_t)r * cols + c];
  partial[(size_t)blockIdx.y * cols + c] = s;
}

__global__ void __launch_bounds__(kThreads)
colsum_final_kernel(const float* __restrict__ partial, int chunks, int cols,
                    void* out, int out_dt) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int i = 0; i < chunks; ++i) s += partial[(size_t)i * cols + c];
  st(out, c, out_dt, s);
}

// ---------------------------------------------------------------------------
// The persistent path (bf16): one cooperative launch per scan (K4) and per
// reverse sweep (K5). Each block owns the plan's slice of the output
// columns (kernels/gru.py::gru_persistent_plan: m-tiles of 16 batch rows,
// unit tiles of 8 hidden units, feature tiles of 8 columns) and keeps the
// weights those columns need in shared memory, in mma fragment order, for
// the whole launch. A phase is a product of the carried f32 activations,
// read from L2 (ld.global.cg), with the block's weight slice on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate). An f32 activation x
// enters as two bf16 passes, hi = bf16(x) and lo = bf16(x - hi), so it
// keeps 16 bits where one rounding would keep 8; bf16 operands (h0, cond)
// take one pass. The block's warps split the depth in contiguous runs and
// their partial sums are added in warp order through shared memory, then
// the phase's epilogue runs on the block's own columns, one accumulator
// element per thread, and the grid meets at a barrier before the next
// phase reads them.

constexpr int kPW = 8;               // warps per persistent block; a
                                     // product's KC (k-steps loaded at
                                     // once) is its k-steps per warp at
                                     // cond_gru_sc09, at most 12
constexpr int kPThreads = 32 * kPW;
constexpr int kPlanHead = 6;         // G, NG, MS, MT, UT, FT
constexpr int kPlanPer = 6;          // per block: m, unit and feature
                                     // tile ranges [lo, hi)
constexpr int kFwdRedTiles = 8;      // K4's head phase: 2 + 6 tiles
constexpr int kBwdRedTiles = 2;      // K5's products: 2 tiles

// The grid barrier: one counter in device memory, zeroed before the launch
// and never reset. At its k-th barrier a block adds 1 with release
// semantics (after __syncthreads, so the whole block's stores are
// ordered before it, as CUTLASS's GenericBarrier arrives) and spins with
// acquire loads until the counter reaches k * gridDim.x. A wait of more
// than 10 s traps, as igemm_tc.cuh's mbar_wait does.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The barrier in two halves: a block arrives once its stores that other
// blocks read are done, may then do work that only its own shared memory
// sees, and waits before it reads what the others stored.
__device__ __forceinline__ void grid_arrive(unsigned* bar, unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar)
                 : "memory");
  }
}

__device__ __forceinline__ void grid_wait(const unsigned* bar,
                                          unsigned target) {
  if (threadIdx.x == 0) {
    const uint64_t t0 = global_ns();
    for (;;) {
      unsigned cur;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(cur) : "l"(bar) : "memory");
      if ((int)(cur - target) >= 0) break;
      if (global_ns() - t0 > 10000000000ull) asm volatile("trap;");
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  grid_arrive(bar, target);
  grid_wait(bar, target);
}

// A 4-byte copy from device to shared memory that completes in the
// background (cp.async), and the wait for all of a thread's copies.
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// An A operand: rows [0, rows) of a row-major matrix, f32 (or bf16 where
// the product's ABF16 says so).
struct ASrc {
  const void* p;
  long long ld;
};

// One segment of a phase's product: A's k-steps against nt column tiles
// of resident weight fragments, laid out [tile][k-step][lane].
struct Seg {
  ASrc a;
  const uint2* w;
  int ks, nt;
};

// The raw A fragment of k-step k0/16 for this lane: rows row0 + g (+8),
// columns k0 + 2t (+8), zeros past `rows` or where `in` is false. An f32
// pair stays a float2; a bf16 pair is kept as its bits in .x. A fragment
// outside the operand reads offset 0, so the loads carry no branch and a
// warp's loads of several k-steps are in flight together.
template <bool BF16>
__device__ __forceinline__ void load_a(const void* p, long long ld, int row0,
                                       int rows, int k0, bool in, int lane,
                                       float2 (&v)[4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = row0 + g + (q & 1) * 8;
    const bool ok = in && r < rows;
    const long long off = ok ? r * ld + k0 + 2 * t + (q >> 1) * 8 : 0;
    if (BF16) {
      const unsigned w = __ldcg(reinterpret_cast<const unsigned*>(
          static_cast<const __nv_bfloat16*>(p) + off));
      v[q] = make_float2(ok ? __uint_as_float(w) : 0.f, 0.f);
    } else {
      const float2 w = __ldcg(
          reinterpret_cast<const float2*>(static_cast<const float*>(p) + off));
      v[q] = ok ? w : make_float2(0.f, 0.f);
    }
  }
}

template <int NT, bool BF16>
__device__ __forceinline__ void mma_tiles(float (&acc)[NT][4],
                                          const float2 (&v)[4],
                                          const Seg& sg, int s, int lane) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (BF16)
      hi[q] = __float_as_uint(v[q].x);
    else
      split_pair(v[q].x, v[q].y, hi[q], lo[q]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < sg.nt) {
      const uint2 b = sg.w[(j * sg.ks + s) * 32 + lane];
      mma16816(acc[j], hi, b);
      if (!BF16) mma16816(acc[j], lo, b);
    }
  }
}

// The block's product for the m-tile at row0: segment 0's tiles into
// red[warp][0 .. NT0) and segment 1's into red[warp][NT0 ..), one float4
// per lane (the m16n8 accumulator). Warp w takes the w-th contiguous run
// of the segments' k-steps; every warp stores its sums (zeros if its run
// is empty). A warp loads the A fragments of KC k-steps before it
// multiplies them, so KC L2 reads per lane are in flight at once. A is
// f32 (two passes), or bf16 (one) with ABF16. Ends with __syncthreads.
template <int NT0, int NT1, int KC, bool ABF16 = false>
__device__ void product(const Seg& s0, const Seg& s1, int row0, int rows,
                        float4* red) {
  constexpr int N1 = NT1 > 0 ? NT1 : 1;
  constexpr int NT = NT0 + NT1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc0[NT0][4], acc1[N1][4];
#pragma unroll
  for (int j = 0; j < NT0; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < N1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[j][e] = 0.f;
  const int total = s0.ks + (NT1 > 0 ? s1.ks : 0);
  const int per = (total + kPW - 1) / kPW;
  const int kb = warp * per, ke = min(total, kb + per);
  for (int k0 = kb; k0 < ke; k0 += KC) {
    float2 v[KC][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int s = k0 + c;
      const bool first = NT1 == 0 || s < s0.ks;
      load_a<ABF16>(first ? s0.a.p : s1.a.p, first ? s0.a.ld : s1.a.ld,
                    row0, rows, 16 * (first ? s : s - s0.ks), s < ke, lane,
                    v[c]);
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int s = k0 + c;
      if (s < ke) {
        if (s < s0.ks) {
          mma_tiles<NT0, ABF16>(acc0, v[c], s0, s, lane);
        } else {
          if constexpr (NT1 > 0)
            mma_tiles<NT1, ABF16>(acc1, v[c], s1, s - s0.ks, lane);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT0; ++j)
    red[(warp * NT + j) * 32 + lane] =
        make_float4(acc0[j][0], acc0[j][1], acc0[j][2], acc0[j][3]);
  if constexpr (NT1 > 0) {
#pragma unroll
    for (int j = 0; j < NT1; ++j)
      red[(warp * NT + NT0 + j) * 32 + lane] =
          make_float4(acc1[j][0], acc1[j][1], acc1[j][2], acc1[j][3]);
  }
  __syncthreads();
}

// Element e of lane's accumulator of tile j (nt tiles per warp), the
// warps added in order: one element per thread of an epilogue.
__device__ __forceinline__ float elem_sum(const float4* red, int nt, int j,
                                          int lane, int e) {
  const float* r = reinterpret_cast<const float*>(red) + (j * 32 + lane) * 4 +
                   e;
  float s = r[0];
  for (int w = 1; w < kPW; ++w) s += r[w * nt * 128];
  return s;
}

// Accumulator element e of a lane: row g (+8 for e >= 2), column 2t (+1).
__device__ __forceinline__ int acc_row(int lane, int e) {
  return (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return 2 * (lane & 3) + (e & 1);
}

// Copies the bf16 matrix W (element (k, n) at w[k * rs + n * cs]) into
// fragments for nt column tiles, [tile][k-step][lane] as uint2: b0 = rows
// 16s + 2t, +1 and b1 = rows 16s + 2t + 8, +9 of column base(tile) + g.
// Tile j's columns start at 8 * (tile0 + j), or, for gate tiles (`gates`
// set), tile j is gate j % 3 of unit tile tile0 + j / 3: column
// (j % 3) * hid + 8 * (tile0 + j / 3).
__device__ void load_frags(uint2* dst, const __nv_bfloat16* w, long long rs,
                           long long cs, int ks, int nt, int tile0,
                           int gates, int hid) {
  const int total = nt * ks * 32;
  for (int i = threadIdx.x; i < total; i += kPThreads) {
    const int lane = i & 31, s = (i >> 5) % ks, j = (i >> 5) / ks;
    const long long base =
        gates ? (long long)(j % 3) * hid + 8 * (tile0 + j / 3)
              : 8LL * (tile0 + j);
    const long long n = base + (lane >> 2);
    const long long k = 16 * s + 2 * (lane & 3);
    const __nv_bfloat16* c = w + n * cs;
    dst[i] = make_uint2(bf16_pair(c[k * rs], c[(k + 1) * rs]),
                        bf16_pair(c[(k + 8) * rs], c[(k + 9) * rs]));
  }
}

struct BlockPlan {
  int m_lo, m_hi, u_lo, u_hi, f_lo, f_hi;
};

__device__ __forceinline__ BlockPlan block_plan(const int* plan) {
  const int* p = plan + kPlanHead + kPlanPer * blockIdx.x;
  return BlockPlan{p[0], p[1], p[2], p[3], p[4], p[5]};
}

// Shared memory of the two kernels for the plan's largest block (MT
// m-tiles, UT unit tiles, FT feature tiles); 16 bytes per weight
// fragment row of 8 columns.
inline size_t fwd_smem(int hid, int feat, int mt, int ut, int ft) {
  return 16 * ((size_t)3 * ut * (2 * feat + hid) + (size_t)ft * (hid + feat)) +
         (size_t)kPW * kFwdRedTiles * 32 * 16 +
         4 * (size_t)16 * mt * (2 * 24 * ut + 8 * ut);
}

inline size_t bwd_smem(int hid, int feat, int mt, int ut, int ft) {
  return 16 * ((size_t)ut * (feat + 3 * hid) + (size_t)ft * (3 * hid + feat)) +
         (size_t)kPW * kBwdRedTiles * 32 * 16 +
         4 * (size_t)16 * mt * (16 * ut + 48 * ut + 8 * ft) +  // state, sums
         4 * (size_t)16 * mt * (48 * ut + 4 * ut + 4 * ft + 8 * ft);  // ahead
}

struct FwdArgs {
  const __nv_bfloat16 *h0, *cond, *w_i, *w_h, *b_i, *b_h, *w_ar, *w_out,
      *b_out;
  __nv_bfloat16 *feats, *h_seq;
  float *hbuf, *fbuf, *abuf;  // h_t [2][B][H] (by frame parity), feat_t
                              // [B][F], a_t = feat_{t-1} w_ar [B][F]
  unsigned* bar;
  const int* plan;
  int batch, hid, feat, n_frames;
};

// K4 on the persistent grid. Before the frames: the block's weights into
// shared memory, and for its rows and units c = cond w_i[F:] + b_i (once
// per scan), gh_0 = h0 w_h + b_h and its slice of h0. Per frame t, three
// phases, each ended by the grid barrier:
//  gates: a_t w_i[:F] on the block's gate columns (a_0 = 0), plus c, and
//         with gh_t the blend on its own units -> h_t;
//  head:  h_t against [w_out's feature columns | w_h's gate columns]:
//         feat_t = tanh(h_t w_out + b_out), and gh_{t+1} = h_t w_h + b_h
//         kept in shared memory for the next gates (h_t is read once for
//         both);
//  ar:    a_{t+1} = feat_t w_ar on its feature columns (not after the last
//         frame).
__global__ void __launch_bounds__(kPThreads, 1)
scan_fwd_persistent(FwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.batch, H = p.hid, F = p.feat;
  const int MT = p.plan[3], UT = p.plan[4], FT = p.plan[5];
  const BlockPlan bp = block_plan(p.plan);
  const int ut = bp.u_hi - bp.u_lo, ft = bp.f_hi - bp.f_lo;
  const int ksf = F / 16, ksh = H / 16;
  uint2* wa = reinterpret_cast<uint2*>(smem);   // w_i[:F], gate tiles
  uint2* wc = wa + (size_t)3 * UT * ksf * 32;   // w_i[F:], gate tiles
  uint2* wo = wc + (size_t)3 * UT * ksf * 32;   // w_out feature tiles,
  uint2* wh = wo + (size_t)ft * ksh * 32;       // then w_h gate tiles
  uint2* wr = wo + (size_t)(FT + 3 * UT) * ksh * 32;  // w_ar, feature tiles
  float4* red = reinterpret_cast<float4*>(wr + (size_t)FT * ksf * 32);
  const int cstride = 24 * UT, hstride = 8 * UT;
  float* cs = reinterpret_cast<float*>(red + kPW * kFwdRedTiles * 32);
  float* ghs = cs + (size_t)16 * MT * cstride;  // gh_t of the next gates
  float* hown = ghs + (size_t)16 * MT * cstride;
  const int tid = threadIdx.x;

  load_frags(wa, p.w_i, 3 * H, 1, ksf, 3 * ut, bp.u_lo, 1, H);
  load_frags(wc, p.w_i + (size_t)F * 3 * H, 3 * H, 1, ksf, 3 * ut, bp.u_lo,
             1, H);
  load_frags(wo, p.w_out, F, 1, ksh, ft, bp.f_lo, 0, H);
  load_frags(wh, p.w_h, 3 * H, 1, ksh, 3 * ut, bp.u_lo, 1, H);
  load_frags(wr, p.w_ar, F, 1, ksf, ft, bp.f_lo, 0, H);
  for (int i = tid; i < 16 * (bp.m_hi - bp.m_lo) * 8 * ut; i += kPThreads) {
    const int lr = i / (8 * ut), c = i % (8 * ut);
    const int row = 16 * bp.m_lo + lr;
    hown[lr * hstride + c] =
        row < B ? __bfloat162float(p.h0[(size_t)row * H + 8 * bp.u_lo + c])
                : 0.f;
  }
  __syncthreads();

  // gate tile j's sums + bias -> dst[row][8 j + col], for the block's rows
  auto keep_gates = [&](int mt, int nt_red, int j0, float* dst,
                        const __nv_bfloat16* bias) {
    for (int i = tid; i < 3 * ut * 128; i += kPThreads) {
      const int j = i >> 7, lane = (i >> 2) & 31, e = i & 3;
      const float v = elem_sum(red, nt_red, j0 + j, lane, e);
      const int col = (j % 3) * H + 8 * (bp.u_lo + j / 3);
      const int lr = 16 * (mt - bp.m_lo) + acc_row(lane, e);
      const int cc = acc_col(lane, e);
      dst[lr * cstride + 8 * j + cc] =
          v + __bfloat162float(bias[col + cc]);
    }
  };
  const Seg none{ASrc{nullptr}, nullptr, 0, 0};
  if (ut > 0) {
    for (int mt = bp.m_lo; mt < bp.m_hi; ++mt) {
      product<6, 0, 2, true>(Seg{ASrc{p.cond, F}, wc, ksf, 3 * ut}, none,
                             16 * mt, B, red);
      keep_gates(mt, 6, 0, cs, p.b_i);
      __syncthreads();
      product<6, 0, 4, true>(Seg{ASrc{p.h0, H}, wh, ksh, 3 * ut}, none,
                             16 * mt, B, red);
      keep_gates(mt, 6, 0, ghs, p.b_h);
      __syncthreads();
    }
  }

  unsigned target = 0;
  for (int t = 0; t < p.n_frames; ++t) {
    float* hcur = p.hbuf + (size_t)(t & 1) * B * H;
    const bool last = t + 1 == p.n_frames;
    if (ut > 0) {
      // a_0 = 0: no k-steps, the sums are zeros
      const Seg sa{ASrc{p.abuf, F}, wa, t == 0 ? 0 : ksf, 3 * ut};
      for (int mt = bp.m_lo; mt < bp.m_hi; ++mt) {
        product<6, 0, 2>(sa, none, 16 * mt, B, red);
        for (int i = tid; i < ut * 128; i += kPThreads) {
          const int ul = i >> 7, lane = (i >> 2) & 31, e = i & 3;
          const float gr = elem_sum(red, 6, 3 * ul, lane, e);
          const float gz = elem_sum(red, 6, 3 * ul + 1, lane, e);
          const float gn = elem_sum(red, 6, 3 * ul + 2, lane, e);
          const int lr = 16 * (mt - bp.m_lo) + acc_row(lane, e);
          const int row = 16 * bp.m_lo + lr;
          if (row >= B) continue;
          const int cc = acc_col(lane, e);
          const int u = 8 * (bp.u_lo + ul) + cc;
          const float* crow = cs + lr * cstride + 24 * ul + cc;
          const float* hrow = ghs + lr * cstride + 24 * ul + cc;
          const float rg = sigmoid(gr + crow[0] + hrow[0]);
          const float zg = sigmoid(gz + crow[8] + hrow[8]);
          const float ng = tanhf(gn + crow[16] + rg * hrow[16]);
          float* hp = hown + lr * hstride + 8 * ul + cc;
          const float h = (1.f - zg) * ng + zg * *hp;
          *hp = h;
          __stcg(hcur + (size_t)row * H + u, h);
          if (p.h_seq)
            p.h_seq[((size_t)t * B + row) * H + u] = __float2bfloat16(h);
        }
        __syncthreads();
      }
    }
    grid_sync(p.bar, target);
    // gh_{t+1} is not needed after the last frame
    const int nt_head = ft + (last ? 0 : 3 * ut);
    if (nt_head > 0) {
      for (int mt = bp.m_lo; mt < bp.m_hi; ++mt) {
        product<8, 0, 4>(Seg{ASrc{hcur, H}, wo, ksh, nt_head}, none,
                         16 * mt, B, red);
        for (int i = tid; i < ft * 128; i += kPThreads) {
          const int j = i >> 7, lane = (i >> 2) & 31, e = i & 3;
          const float v = elem_sum(red, 8, j, lane, e);
          const int row = 16 * mt + acc_row(lane, e);
          if (row >= B) continue;
          const int f = 8 * (bp.f_lo + j) + acc_col(lane, e);
          const float y = tanhf(v + __bfloat162float(p.b_out[f]));
          __stcg(p.fbuf + (size_t)row * F + f, y);
          p.feats[((size_t)row * p.n_frames + t) * F + f] =
              __float2bfloat16(y);
        }
        if (!last) keep_gates(mt, 8, ft, ghs, p.b_h);
        __syncthreads();
      }
    }
    grid_sync(p.bar, target);
    if (!last) {
      if (ft > 0) {
        for (int mt = bp.m_lo; mt < bp.m_hi; ++mt) {
          product<2, 0, 2>(Seg{ASrc{p.fbuf, F}, wr, ksf, ft}, none, 16 * mt,
                           B, red);
          for (int i = tid; i < ft * 128; i += kPThreads) {
            const int j = i >> 7, lane = (i >> 2) & 31, e = i & 3;
            const float v = elem_sum(red, 2, j, lane, e);
            const int row = 16 * mt + acc_row(lane, e);
            if (row >= B) continue;
            const int f = 8 * (bp.f_lo + j) + acc_col(lane, e);
            __stcg(p.abuf + (size_t)row * F + f, v);
          }
          __syncthreads();
        }
      }
      grid_sync(p.bar, target);
    }
  }
}

struct BwdArgs {
  const __nv_bfloat16 *g, *prev_h, *w_i, *w_h, *b_i, *b_h, *w_ar, *w_out;
  float *ga, *gb;    // [R, 3H]: the recomputed gi, gh; overwritten with
                     // dgi, dgh
  const float* fcur; // [R, F]: feat_t recomputed
  float *dfp, *dar;  // [R, F]: (g + dfc)(1 - feat^2), and dgi w_i[:F]^T
  float *sgi, *sgh, *sfp;  // dgi, dgh [B, 3H] and dfp [B, F] summed over
                           // the frames
  __nv_bfloat16 *dh0, *db_i, *db_h, *db_out;
  unsigned* bar;
  const int* plan;
  int batch, hid, feat, n_frames;
};

// K5's reverse sweep on the persistent grid, frame-major rows (row t*B + b
// of ga, gb, fcur, dfp, dar). The weights are resident transposed; dh
// lives in the shared memory of the block that owns its units. Before the
// frames: dfp of the last frame. Per frame t, from the last:
//  cell:  dh += dfp_t w_out^T on the block's units, then the cell's
//         backward there -> dgi_t, dgh_t (over gi_t, gh_t), dh * z;
//  carry: dar_t = dgi_t w_i[:F]^T on its feature columns; then, between
//         arriving at the barrier and waiting on it, dh = dgh_t w_h^T +
//         dh * z on its units (shared memory only);
//  ar:    dfc = dar_t w_ar^T on its feature columns and dfp_{t-1} = (g_{t-1}
//         + dfc)(1 - feat_{t-1}^2) (not for the first frame);
// each ended by the grid barrier. Then dh0 = dh. Each block also sums its
// own dgi, dgh and dfp over the frames (from the last, in shared memory)
// and writes the sums out (dgi's for dcond); after one more barrier the
// grid's threads add them over the B rows, in row order, a column each:
// the bias gradients db_i, db_h [3H] and db_out [F].
__global__ void __launch_bounds__(kPThreads, 1)
scan_bwd_persistent(BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = p.batch, H = p.hid, F = p.feat, n = p.n_frames;
  const int MT = p.plan[3], UT = p.plan[4], FT = p.plan[5];
  const BlockPlan bp = block_plan(p.plan);
  const int ut = bp.u_hi - bp.u_lo, ft = bp.f_hi - bp.f_lo;
  const int ksf = F / 16, ksg = 3 * H / 16;
  uint2* w1 = reinterpret_cast<uint2*>(smem);   // w_out^T, unit tiles
  uint2* w2h = w1 + (size_t)UT * ksf * 32;      // w_h^T, unit tiles
  uint2* w2i = w2h + (size_t)UT * ksg * 32;     // w_i[:F]^T, feature tiles
  uint2* w3 = w2i + (size_t)FT * ksg * 32;      // w_ar^T, feature tiles
  float4* red = reinterpret_cast<float4*>(w3 + (size_t)FT * ksf * 32);
  const int hstride = 8 * UT;
  float* dhc = reinterpret_cast<float*>(red + kPW * kBwdRedTiles * 32);
  float* dhz = dhc + (size_t)16 * MT * hstride;
  const int gstride = 24 * UT, fstride = 8 * FT;
  float* sgi = dhz + (size_t)16 * MT * hstride;  // [rows][3 gates x units]
  float* sgh = sgi + (size_t)16 * MT * gstride;
  float* sfp = sgh + (size_t)16 * MT * gstride;  // [rows][features]
  // the next frame's epilogue inputs, copied ahead: gi, gh and h_{t-1}
  // (bf16 pairs) of the block's units; g (bf16 pairs) and feat of its
  // features
  float* pga = sfp + (size_t)16 * MT * fstride;
  float* pgb = pga + (size_t)16 * MT * gstride;
  unsigned* pph = reinterpret_cast<unsigned*>(pgb + (size_t)16 * MT * gstride);
  unsigned* pgg = pph + (size_t)16 * MT * 4 * UT;
  float* pfc = reinterpret_cast<float*>(pgg + (size_t)16 * MT * 4 * FT);
  const int tid = threadIdx.x;
  const int rows = 16 * (bp.m_hi - bp.m_lo);
  // issues the copies of frame t's inputs (the cell's at t, the ar
  // epilogue's at t), rows past B left out
  auto prefetch = [&](int t) {
    const size_t rb = (size_t)t * B;
    for (int i = tid; i < rows * 4 * ut; i += kPThreads) {
      const int lr = i / (4 * ut), c = 2 * (i % (4 * ut));
      const int row = 16 * bp.m_lo + lr;
      if (row >= B) continue;
      const size_t o = (rb + row) * 3 * H + 8 * bp.u_lo + c;
      for (int q = 0; q < 3; ++q)
        for (int e = 0; e < 2; ++e) {
          const int li = lr * gstride + 24 * (c / 8) + 8 * q + c % 8 + e;
          copy4_async(pga + li, p.ga + o + q * H + e);
          copy4_async(pgb + li, p.gb + o + q * H + e);
        }
      copy4_async(pph + lr * 4 * UT + c / 2,
                  p.prev_h + (rb + row) * H + 8 * bp.u_lo + c);
    }
    for (int i = tid; i < rows * 4 * ft; i += kPThreads) {
      const int lr = i / (4 * ft), c = 2 * (i % (4 * ft));
      const int row = 16 * bp.m_lo + lr;
      if (row >= B) continue;
      const int f = 8 * bp.f_lo + c;
      copy4_async(pgg + lr * 4 * FT + c / 2,
                  p.g + ((size_t)row * n + t) * F + f);
      copy4_async(pfc + lr * fstride + c, p.fcur + (rb + row) * F + f);
      copy4_async(pfc + lr * fstride + c + 1, p.fcur + (rb + row) * F + f + 1);
    }
  };

  load_frags(w1, p.w_out, 1, F, ksf, ut, bp.u_lo, 0, H);
  load_frags(w2h, p.w_h, 1, 3 * H, ksg, ut, bp.u_lo, 0, H);
  load_frags(w2i, p.w_i, 1, 3 * H, ksg, ft, bp.f_lo, 0, H);
  load_frags(w3, p.w_ar, 1, F, ksf, ft, bp.f_lo, 0, H);
  for (int i = tid; i < 16 * MT * (2 * hstride + 2 * gstride + fstride);
       i += kPThreads)
    dhc[i] = 0.f;  // dh, dh z and the three frame sums
  // dfp of the last frame: g only (no carried dfc yet)
  for (int i = tid; i < 16 * (bp.m_hi - bp.m_lo) * 8 * ft; i += kPThreads) {
    const int lr = i / (8 * ft), c = i % (8 * ft);
    const int row = 16 * bp.m_lo + lr, f = 8 * bp.f_lo + c;
    if (row >= B) continue;
    const size_t r = (size_t)(n - 1) * B + row;
    const float fc = p.fcur[r * F + f];
    const float d =
        __bfloat162float(p.g[((size_t)row * n + n - 1) * F + f]) *
        (1.f - fc * fc);
    __stcg(p.dfp + r * F + f, d);
    sfp[lr * fstride + c] = d;
  }
  prefetch(n - 1);
  copies_wait();
  unsigned target = 0;
  grid_sync(p.bar, target);

  const Seg none{ASrc{nullptr}, nullptr, 0, 0};
  for (int t = n - 1; t >= 0; --t) {
    const size_t rb = (size_t)t * B;
    float* ga = p.ga + rb * 3 * H;
    float* gb = p.gb + rb * 3 * H;
    if (ut > 0) {
      for (int mt = bp.m_lo; mt < bp.m_hi; ++mt) {
        product<2, 0, 2>(Seg{ASrc{p.dfp + rb * F, F}, w1, ksf, ut}, none,
                         16 * mt, B, red);
        for (int i = tid; i < ut * 128; i += kPThreads) {
          const int ul = i >> 7, lane = (i >> 2) & 31, e = i & 3;
          const float v = elem_sum(red, 2, ul, lane, e);
          const int lr = 16 * (mt - bp.m_lo) + acc_row(lane, e);
          const int row = 16 * bp.m_lo + lr;
          if (row >= B) continue;
          const int cc = acc_col(lane, e);
          const int j = 8 * (bp.u_lo + ul) + cc;
          float* gir = ga + (size_t)row * 3 * H;
          float* ghr = gb + (size_t)row * 3 * H;
          const float* pi = pga + lr * gstride + 24 * ul + cc;
          const float* ph = pgb + lr * gstride + 24 * ul + cc;
          const float i_r = pi[0] + __bfloat162float(p.b_i[j]);
          const float i_z = pi[8] + __bfloat162float(p.b_i[H + j]);
          const float i_n = pi[16] + __bfloat162float(p.b_i[2 * H + j]);
          const float h_r = ph[0] + __bfloat162float(p.b_h[j]);
          const float h_z = ph[8] + __bfloat162float(p.b_h[H + j]);
          const float h_n = ph[16] + __bfloat162float(p.b_h[2 * H + j]);
          const float rg = sigmoid(i_r + h_r);
          const float zg = sigmoid(i_z + h_z);
          const float ng = tanhf(i_n + rg * h_n);
          const unsigned hb = pph[lr * 4 * UT + (8 * ul + cc) / 2];
          const float hp = __uint_as_float(
              (cc & 1 ? hb & 0xffff0000u : hb << 16));
          const int li = lr * hstride + 8 * ul + cc;
          const float d = dhc[li] + v;
          const float dz = d * (hp - ng) * zg * (1.f - zg);
          const float dn = d * (1.f - zg) * (1.f - ng * ng);
          const float dr = dn * h_n * rg * (1.f - rg);
          __stcg(gir + j, dr);
          __stcg(gir + H + j, dz);
          __stcg(gir + 2 * H + j, dn);
          __stcg(ghr + j, dr);
          __stcg(ghr + H + j, dz);
          __stcg(ghr + 2 * H + j, dn * rg);
          dhz[li] = d * zg;
          float* si = sgi + lr * gstride + 24 * ul + cc;
          float* sh = sgh + lr * gstride + 24 * ul + cc;
          si[0] += dr;
          si[8] += dz;
          si[16] += dn;
          sh[0] += dr;
          sh[8] += dz;
          sh[16] += dn * rg;
        }
        __syncthreads();
      }
    }
    if (t > 0) prefetch(t - 1);  // overlaps the rest of the frame
    grid_sync(p.bar, target);
    if (ft > 0) {
      for (int mt = bp.m_lo; mt < bp.m_hi; ++mt) {
        product<2, 0, 12>(Seg{ASrc{ga, 3 * H}, w2i, ksg, ft}, none, 16 * mt,
                          B, red);
        for (int i = tid; i < ft * 128; i += kPThreads) {
          const int j = i >> 7, lane = (i >> 2) & 31, e = i & 3;
          const float v = elem_sum(red, 2, j, lane, e);
          const int row = 16 * mt + acc_row(lane, e);
          if (row >= B) continue;
          const int f = 8 * (bp.f_lo + j) + acc_col(lane, e);
          __stcg(p.dar + (rb + row) * F + f, v);
        }
        __syncthreads();
      }
    }
    grid_arrive(p.bar, target);
    if (ut > 0) {  // the dh carry: shared memory only
      for (int mt = bp.m_lo; mt < bp.m_hi; ++mt) {
        product<2, 0, 12>(Seg{ASrc{gb, 3 * H}, w2h, ksg, ut}, none, 16 * mt,
                          B, red);
        for (int i = tid; i < ut * 128; i += kPThreads) {
          const int ul = i >> 7, lane = (i >> 2) & 31, e = i & 3;
          const float v = elem_sum(red, 2, ul, lane, e);
          const int lr = 16 * (mt - bp.m_lo) + acc_row(lane, e);
          const int li = lr * hstride + 8 * ul + acc_col(lane, e);
          dhc[li] = v + dhz[li];
        }
        __syncthreads();
      }
    }
    grid_wait(p.bar, target);
    if (t > 0) {
      copies_wait();  // frame t - 1's inputs (read after the syncs below)
      if (ft > 0) {
        const size_t rp = rb - B;  // frame t - 1
        for (int mt = bp.m_lo; mt < bp.m_hi; ++mt) {
          product<2, 0, 2>(Seg{ASrc{p.dar + rb * F, F}, w3, ksf, ft}, none,
                           16 * mt, B, red);
          for (int i = tid; i < ft * 128; i += kPThreads) {
            const int j = i >> 7, lane = (i >> 2) & 31, e = i & 3;
            const float v = elem_sum(red, 2, j, lane, e);
            const int lr = 16 * (mt - bp.m_lo) + acc_row(lane, e);
            const int row = 16 * bp.m_lo + lr;
            if (row >= B) continue;
            const int c = 8 * j + acc_col(lane, e);
            const int f = 8 * bp.f_lo + c;
            const float fc = pfc[lr * fstride + c];
            const unsigned gb2 = pgg[lr * 4 * FT + c / 2];
            const float gv =
                __uint_as_float(c & 1 ? gb2 & 0xffff0000u : gb2 << 16);
            const float d = (gv + v) * (1.f - fc * fc);
            __stcg(p.dfp + (rp + row) * F + f, d);
            sfp[lr * fstride + c] += d;
          }
          __syncthreads();
        }
      }
      grid_sync(p.bar, target);
    }
  }
  for (int i = tid; i < rows * 8 * ut; i += kPThreads) {
    const int lr = i / (8 * ut), c = i % (8 * ut);
    const int row = 16 * bp.m_lo + lr;
    if (row >= B) continue;
    p.dh0[(size_t)row * H + 8 * bp.u_lo + c] =
        __float2bfloat16(dhc[lr * hstride + c]);
    for (int q = 0; q < 3; ++q) {
      const size_t o = (size_t)row * 3 * H + q * H + 8 * bp.u_lo + c;
      const int li = lr * gstride + 24 * (c / 8) + 8 * q + c % 8;
      __stcg(p.sgi + o, sgi[li]);
      __stcg(p.sgh + o, sgh[li]);
    }
  }
  for (int i = tid; i < rows * 8 * ft; i += kPThreads) {
    const int lr = i / (8 * ft), c = i % (8 * ft);
    const int row = 16 * bp.m_lo + lr;
    if (row < B) __stcg(p.sfp + (size_t)row * F + 8 * bp.f_lo + c,
                        sfp[lr * fstride + c]);
  }
  grid_sync(p.bar, target);
  for (int c0 = blockIdx.x * kPThreads + tid; c0 < 6 * H + F;
       c0 += gridDim.x * kPThreads) {
    const float* src = c0 < 3 * H ? p.sgi : c0 < 6 * H ? p.sgh : p.sfp;
    __nv_bfloat16* dst = c0 < 3 * H ? p.db_i : c0 < 6 * H ? p.db_h : p.db_out;
    const int c = c0 < 3 * H ? c0 : c0 < 6 * H ? c0 - 3 * H : c0 - 6 * H;
    const int cols = c0 < 6 * H ? 3 * H : F;
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum += __ldcg(src + (size_t)b * cols + c);
    dst[c] = __float2bfloat16(sum);
  }
}

// K5's hoisted products on the tensor cores (bf16 path): C = act(A B +
// bias) over the 16384 rows of every frame, the recompute of the gates
// before the sweep and the weight gradients after it. Any strides, so a
// transpose is a view (the weight gradients read A = x^T, MN-major). Each
// operand is staged through shared memory as bf16: an f32 operand as hi
// and lo, so a product takes A_hi B_hi + A_lo B_hi + A_hi B_lo (the terms
// of the f32 operands present; lo x lo is below f32's own rounding of the
// sum). 128 x 128 tiles, depth 32 per stage, eight warps of 64 x 32; the
// next stage's operands are read while the current one multiplies. One
// launch may carry two problems and a split of the depth, as gemm_kernel.
constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32;
constexpr int kTcPad = kTcBK + 8;  // bf16 row pitch: conflict-free fragments

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Pair e = tid + l * kThreads (l < N) of a tile's operand: tile row i of
// `rows` and depths kk, kk + 1 of kTcBK (kk even), the index that is
// contiguous in memory fastest across threads; r[l] = M[r0 + i, k0 + kk
// (+1)] (element (i, k) at p[i * rs + k * cs]), 0 outside [0, r_end) x
// [0, k_end). The dtype is a template argument and an element outside the
// matrix reads offset 0, so the loads carry no branch and are all in
// flight at once; with VEC (k contiguous, the pair 8- or 4-byte aligned,
// k_end even) each pair is one load.
template <typename T, bool VEC, int N, int ROWS>
__device__ __forceinline__ void gather(const Mat& mt, bool k_fast, int r0,
                                       int r_end, int k0, int k_end,
                                       float2 (&r)[N]) {
  constexpr int KP = kTcBK / 2;
  const T* p = static_cast<const T*>(mt.p);
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int e = threadIdx.x + l * kThreads;
    const int i = k_fast ? e / KP : e % ROWS;
    const int kk = 2 * (k_fast ? e % KP : e / ROWS);
    const bool row_ok = r0 + i < r_end;
    const bool ok0 = row_ok && k0 + kk < k_end;
    const bool ok1 = row_ok && k0 + kk + 1 < k_end;
    const long long base = (long long)(r0 + i) * mt.rs +
                           (long long)(k0 + kk) * mt.cs;
    if (VEC) {
      const float2 v = ld_pair(p + (ok0 ? base : 0));
      r[l] = ok0 ? v : make_float2(0.f, 0.f);
    } else {
      const float v0 = to_f32(p[ok0 ? base : 0]);
      const float v1 = to_f32(p[ok1 ? base + mt.cs : 0]);
      r[l] = make_float2(ok0 ? v0 : 0.f, ok1 ? v1 : 0.f);
    }
  }
}

template <int N, int ROWS>
__device__ __forceinline__ void gather_any(const Mat& mt, bool k_fast,
                                           int r0, int r_end, int k0,
                                           int k_end, float2 (&r)[N]) {
  const size_t bytes = mt.dt == DT_BF16 ? 2 : 4;
  const bool vec = k_fast && mt.cs == 1 && mt.rs % 2 == 0 &&
                   k_end % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(mt.p) % (2 * bytes) == 0;
  if (mt.dt == DT_BF16) {
    if (vec)
      gather<__nv_bfloat16, true, N, ROWS>(mt, k_fast, r0, r_end, k0, k_end,
                                           r);
    else
      gather<__nv_bfloat16, false, N, ROWS>(mt, k_fast, r0, r_end, k0,
                                            k_end, r);
  } else {
    if (vec)
      gather<float, true, N, ROWS>(mt, k_fast, r0, r_end, k0, k_end, r);
    else
      gather<float, false, N, ROWS>(mt, k_fast, r0, r_end, k0, k_end, r);
  }
}

// Pair l of gather's layout into the hi and lo tiles, one 32-bit store each.
template <int N, int ROWS>
__device__ __forceinline__ void stage(__nv_bfloat16 (*t)[ROWS][kTcPad],
                                      bool k_fast, const float2 (&r)[N]) {
  constexpr int KP = kTcBK / 2;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int e = threadIdx.x + l * kThreads;
    const int i = k_fast ? e / KP : e % ROWS;
    const int kk = 2 * (k_fast ? e % KP : e / ROWS);
    uint32_t hi, lo;
    split_pair(r[l].x, r[l].y, hi, lo);
    *reinterpret_cast<uint32_t*>(&t[0][i][kk]) = hi;
    *reinterpret_cast<uint32_t*>(&t[1][i][kk]) = lo;
  }
}

__device__ void tc_gemm_tile(const Gemm& g, int kb, int ke, float* partial) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kTcBM][kTcPad];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kTcBN][kTcPad];
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  if (m0 >= g.m || n0 >= g.n) return;  // the smaller problem of a pair
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const bool a_split = g.a.dt == DT_F32, b_split = g.b.dt == DT_F32;
  // B's element (k, n) is the transposed operand's (n, k)
  const Mat bt{g.b.p, g.b.cs, g.b.rs, g.b.dt};
  const bool a_k_fast = g.a.cs == 1, b_k_fast = bt.cs == 1;
  constexpr int LA = kTcBM * kTcBK / kThreads / 2;
  constexpr int LB = kTcBK * kTcBN / kThreads / 2;
  float2 ra[LA], rb[LB];
  auto fetch = [&](int k0) {
    gather_any<LA, kTcBM>(g.a, a_k_fast, m0, g.m, k0, ke, ra);
    gather_any<LB, kTcBN>(bt, b_k_fast, n0, g.n, k0, ke, rb);
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += kTcBK) {
    stage<LA, kTcBM>(as, a_k_fast, ra);
    stage<LB, kTcBN>(bs, b_k_fast, rb);
    __syncthreads();
    if (k0 + kTcBK < ke) fetch(k0 + kTcBK);
#pragma unroll
    for (int kq = 0; kq < kTcBK; kq += 16) {
      uint32_t a[2][4][4], b[2][4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int r = wm * 64 + mi * 16 + g8;
          const __nv_bfloat16(*t)[kTcPad] = as[h];
          a[h][mi][0] = *reinterpret_cast<const uint32_t*>(&t[r][kq + t2]);
          a[h][mi][1] =
              *reinterpret_cast<const uint32_t*>(&t[r + 8][kq + t2]);
          a[h][mi][2] =
              *reinterpret_cast<const uint32_t*>(&t[r][kq + t2 + 8]);
          a[h][mi][3] =
              *reinterpret_cast<const uint32_t*>(&t[r + 8][kq + t2 + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wn * 32 + ni * 8 + g8;
          const __nv_bfloat16(*t)[kTcPad] = bs[h];
          b[h][ni][0] = *reinterpret_cast<const uint32_t*>(&t[c][kq + t2]);
          b[h][ni][1] =
              *reinterpret_cast<const uint32_t*>(&t[c][kq + t2 + 8]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint2 bh = make_uint2(b[0][ni][0], b[0][ni][1]);
          mma16816(acc[mi][ni], a[0][mi], bh);
          if (a_split) mma16816(acc[mi][ni], a[1][mi], bh);
          if (b_split)
            mma16816(acc[mi][ni], a[0][mi],
                     make_uint2(b[1][ni][0], b[1][ni][1]));
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + mi * 16 + g8 + (e >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + t2 + (e & 1);
        if (m >= g.m || n >= g.n) continue;
        if (partial)
          partial[(size_t)m * g.n + n] = acc[mi][ni][e];
        else
          epilogue(g, m, n, acc[mi][ni][e]);
      }
}

__global__ void __launch_bounds__(kThreads)
tc_gemm_kernel(Gemm g0, Gemm g1, int splits, int kper, float* p0,
               float* p1) {
  const int prob = blockIdx.z / splits, split = blockIdx.z % splits;
  const int kb = split * kper;
  if (prob == 0)
    tc_gemm_tile(g0, kb, min(g0.k, kb + kper),
                 p0 ? p0 + (size_t)split * g0.m * g0.n : nullptr);
  else
    tc_gemm_tile(g1, kb, min(g1.k, kb + kper),
                 p1 ? p1 + (size_t)split * g1.m * g1.n : nullptr);
}

// ---------------------------------------------------------------------------
// Host side

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline size_t elem_size(int dt) { return dt == DT_BF16 ? 2 : 4; }

inline const void* at(const void* p, size_t elems, int dt) {
  return static_cast<const char*>(p) + elems * elem_size(dt);
}

inline void* at(void* p, size_t elems, int dt) {
  return static_cast<char*>(p) + elems * elem_size(dt);
}

inline Mat mat(const void* p, long long rs, long long cs, int dt) {
  return Mat{p, rs, cs, dt};
}

inline Gemm gemm(Mat a, Mat b, int m, int n, int k, float* c,
                 long long ldc) {
  Gemm g{};
  g.a = a;
  g.b = b;
  g.m = m;
  g.n = n;
  g.k = k;
  g.c = c;
  g.ldc = ldc;
  return g;
}

inline int tile_blocks(const Gemm& g, int bm, int bn) {
  return cdiv(g.m, bm) * cdiv(g.n, bn);
}

struct Ctx {
  cudaStream_t stream;
  int sms;
  float* partial;        // room for split products' slices, or null
  size_t partial_cap;    // its f32 elements
};

// f32 elements a workspace keeps for split products: eight slices of the
// largest per-frame result, [B, 3H].
inline size_t split_capacity(int batch, int hid) {
  return 8 * (size_t)batch * 3 * hid;
}

// One launch for g0 (and g1, when given, on blockIdx.z = 1): the largest
// square tile that still gives every SM a block, else the smallest. When
// that leaves fewer than two blocks per SM and the results fit the
// context's partial room, the depth is split (in powers of two, at most
// 16 ways, whole chunks each) and a reduce kernel finishes the product:
// the per-frame products have 64 rows and few columns, so this is what
// spreads them over the card.
cudaError_t run_gemm(const Ctx& cx, const Gemm& g0, const Gemm* g1 = nullptr) {
  const Gemm& h = g1 ? *g1 : g0;
  const int nz = g1 ? 2 : 1;
  auto total = [&](int t) {
    return tile_blocks(g0, t, t) + (g1 ? tile_blocks(h, t, t) : 0);
  };
  const int tile = total(128) >= cx.sms ? 128 : total(64) >= cx.sms ? 64 : 32;
  const int bk = tile == 128 ? 16 : tile == 64 ? 32 : 64;
  const size_t out = (size_t)g0.m * g0.n + (g1 ? (size_t)h.m * h.n : 0);
  int splits = 1;
  if (cx.partial && h.k == g0.k) {
    while (splits < 16 && 2 * splits <= cdiv(g0.k, bk) &&
           total(tile) * splits < 2 * cx.sms &&
           2 * splits * out <= cx.partial_cap)
      splits *= 2;
  }
  const int kper = cdiv(cdiv(g0.k, splits), bk) * bk;
  splits = cdiv(g0.k, kper);  // no empty slice
  float* p0 = splits > 1 ? cx.partial : nullptr;
  float* p1 = p0 ? p0 + (size_t)splits * g0.m * g0.n : nullptr;
  dim3 grid(std::max(cdiv(g0.n, tile), cdiv(h.n, tile)),
            std::max(cdiv(g0.m, tile), cdiv(h.m, tile)), nz * splits);
  const cudaStream_t s = cx.stream;
  if (tile == 128)
    gemm_kernel<128, 128, 16, 8, 8><<<grid, kThreads, 0, s>>>(
        g0, h, splits, kper, p0, p1);
  else if (tile == 64)
    gemm_kernel<64, 64, 32, 4, 4><<<grid, kThreads, 0, s>>>(
        g0, h, splits, kper, p0, p1);
  else
    gemm_kernel<32, 32, 64, 4, 4><<<grid, kThreads, 0, s>>>(
        g0, h, splits, kper, p0, p1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = std::max((size_t)g0.m * g0.n, (size_t)h.m * h.n);
  split_reduce_kernel<<<dim3(cdiv(mn, kThreads), 1, nz), kThreads, 0, s>>>(
      g0, h, splits, p0, p1);
  return cudaGetLastError();
}

// run_gemm on the tensor cores (tc_gemm_kernel): 128 x 128 tiles, the
// depth split as run_gemm splits it when the tiles leave SMs idle (unless
// `split` is false).
cudaError_t run_gemm_tc(const Ctx& cx, const Gemm& g0,
                        const Gemm* g1 = nullptr, bool split = true) {
  const Gemm& h = g1 ? *g1 : g0;
  const int nz = g1 ? 2 : 1;
  const int tiles = tile_blocks(g0, kTcBM, kTcBN) +
                    (g1 ? tile_blocks(h, kTcBM, kTcBN) : 0);
  const size_t out = (size_t)g0.m * g0.n + (g1 ? (size_t)h.m * h.n : 0);
  int splits = 1;
  if (split && cx.partial && h.k == g0.k) {
    while (splits < 16 && 2 * splits <= cdiv(g0.k, kTcBK) &&
           tiles * splits < 2 * cx.sms && 2 * splits * out <= cx.partial_cap)
      splits *= 2;
  }
  const int kper = cdiv(cdiv(g0.k, splits), kTcBK) * kTcBK;
  splits = cdiv(g0.k, kper);
  float* p0 = splits > 1 ? cx.partial : nullptr;
  float* p1 = p0 ? p0 + (size_t)splits * g0.m * g0.n : nullptr;
  dim3 grid(std::max(cdiv(g0.n, kTcBN), cdiv(h.n, kTcBN)),
            std::max(cdiv(g0.m, kTcBM), cdiv(h.m, kTcBM)), nz * splits);
  tc_gemm_kernel<<<grid, kThreads, 0, cx.stream>>>(g0, h, splits, kper, p0,
                                                   p1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = std::max((size_t)g0.m * g0.n, (size_t)h.m * h.n);
  split_reduce_kernel<<<dim3(cdiv(mn, kThreads), 1, nz), kThreads, 0,
                        cx.stream>>>(g0, h, splits, p0, p1);
  return cudaGetLastError();
}

cudaError_t run_copy(const Ctx& cx, void* dst, long long ldd, int ddt,
                     const void* src, long long lds, int sdt, int rows,
                     int cols, int src_rows) {
  copy_kernel<<<cdiv((long long)rows * cols, kThreads), kThreads, 0,
                cx.stream>>>(dst, ldd, ddt, src, lds, sdt, rows, cols,
                             src_rows);
  return cudaGetLastError();
}

inline int colsum_chunks(int rows) {
  return std::max(1, std::min(64, rows / 64));
}

// f32 elements of the column sums' partials in K5's host loop
inline size_t colsum_room(int batch, int hid, int feat, int n_frames) {
  const size_t R = (size_t)n_frames * batch, H = hid, F = feat;
  return std::max({(size_t)colsum_chunks(n_frames) * batch * 3 * H,
                   (size_t)colsum_chunks(batch) * 3 * H,
                   (size_t)colsum_chunks((int)R) * 3 * H,
                   (size_t)colsum_chunks((int)R) * F});
}

cudaError_t run_colsum(const Ctx& cx, const float* x, int rows, int cols,
                       float* partial, void* out, int out_dt) {
  const int chunks = colsum_chunks(rows);
  const int per = cdiv(rows, chunks);
  colsum_partial_kernel<<<dim3(cdiv(cols, kThreads), chunks), kThreads, 0,
                          cx.stream>>>(x, rows, cols, per, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_final_kernel<<<cdiv(cols, kThreads), kThreads, 0, cx.stream>>>(
      partial, chunks, cols, out, out_dt);
  return cudaGetLastError();
}

cudaError_t make_ctx(void* stream, Ctx* cx) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&cx->sms, cudaDevAttrMultiProcessorCount, dev);
  cx->stream = static_cast<cudaStream_t>(stream);
  cx->partial = nullptr;
  cx->partial_cap = 0;
  return err;
}

// One cooperative launch of a persistent kernel: every block resident, or
// the launch is refused (cudaErrorCooperativeLaunchTooLarge). A stream
// capture takes it as a cooperative kernel node, and the grid barrier's
// cudaMemsetAsync before it as a memset node (train/step_graph.py: the
// replay equals the eager step to the bit on the H100).
cudaError_t launch_coop(const void* kern, void* arg, int grid, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {arg};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(kPThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The persistent path takes bf16 and a plan whose blocks fit the kernels'
// accumulators (at most 4 m-tiles, 2 unit tiles, 2 feature tiles each).
inline bool bad_plan(const int* plan, int batch, int hid, int feat, int dt) {
  return dt != DT_BF16 || batch > 64 || hid % 16 || feat % 16 ||
         plan[0] < 1 || plan[3] > 4 || plan[4] > 2 || plan[5] > 2;
}

inline bool bad_dims(int batch, int hid, int feat, int n_frames, int dt) {
  return batch <= 0 || hid <= 0 || feat <= 0 || n_frames <= 0 ||
         (dt != DT_F32 && dt != DT_BF16);
}

#define TRY(expr)                                  \
  do {                                             \
    const cudaError_t err_ = (expr);               \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

}  // namespace

extern "C" {

// f32 elements of the forward's workspace: h, feat, x, gi, gh and the
// split products' slices.
size_t gru_scan_fwd_workspace(int batch, int hid, int feat) {
  return (size_t)batch * (7 * (size_t)hid + 3 * (size_t)feat) +
         split_capacity(batch, hid);
}

// Shared memory of a persistent launch with the given plan (host copy).
size_t gru_scan_fwd_smem(const int* plan, int hid, int feat) {
  return fwd_smem(hid, feat, plan[3], plan[4], plan[5]);
}

size_t gru_scan_bwd_smem(const int* plan, int hid, int feat) {
  return bwd_smem(hid, feat, plan[3], plan[4], plan[5]);
}

// K4. Inputs (dtype dt, contiguous, on the device): h0 [B,H], cond [B,F],
// w_i [2F,3H], w_h [H,3H], b_i [3H], b_h [3H], w_ar [F,F], w_out [H,F],
// b_out [F]. Outputs: feats [B, n_frames, F] (dt) and, when h_seq is not
// null, h_seq [n_frames, B, H] (dt). ws: gru_scan_fwd_workspace f32s.
// With a plan (kernels/gru.py::gru_persistent_plan; plan_host and its copy
// on the device, plan_dev) the scan is one cooperative launch of
// scan_fwd_persistent (bf16 only); without one, the host loop of frames.
// Returns a cudaError_t code.
int gru_scan_fwd(const void* h0, const void* cond, const void* w_i,
                 const void* w_h, const void* b_i, const void* b_h,
                 const void* w_ar, const void* w_out, const void* b_out,
                 void* feats, void* h_seq, float* ws, int batch, int hid,
                 int feat, int n_frames, int dt, const int* plan_host,
                 const int* plan_dev, void* stream) {
  if (bad_dims(batch, hid, feat, n_frames, dt))
    return (int)cudaErrorInvalidValue;
  Ctx cx;
  TRY(make_ctx(stream, &cx));
  const int B = batch, H = hid, F = feat;
  if (plan_host) {
    if (bad_plan(plan_host, B, H, F, dt)) return (int)cudaErrorInvalidValue;
    using bf = const __nv_bfloat16*;
    FwdArgs a{};
    a.h0 = static_cast<bf>(h0);
    a.cond = static_cast<bf>(cond);
    a.w_i = static_cast<bf>(w_i);
    a.w_h = static_cast<bf>(w_h);
    a.b_i = static_cast<bf>(b_i);
    a.b_h = static_cast<bf>(b_h);
    a.w_ar = static_cast<bf>(w_ar);
    a.w_out = static_cast<bf>(w_out);
    a.b_out = static_cast<bf>(b_out);
    a.feats = static_cast<__nv_bfloat16*>(feats);
    a.h_seq = static_cast<__nv_bfloat16*>(h_seq);
    a.bar = reinterpret_cast<unsigned*>(ws);
    a.hbuf = ws + 16;
    a.fbuf = a.hbuf + (size_t)2 * B * H;
    a.abuf = a.fbuf + (size_t)B * F;
    a.plan = plan_dev;
    a.batch = B;
    a.hid = H;
    a.feat = F;
    a.n_frames = n_frames;
    TRY(cudaMemsetAsync(a.bar, 0, sizeof(unsigned), cx.stream));
    return (int)launch_coop((const void*)scan_fwd_persistent, &a,
                            plan_host[0], gru_scan_fwd_smem(plan_host, H, F),
                            cx.stream);
  }
  float* hc = ws;
  float* fc = hc + (size_t)B * H;
  float* x = fc + (size_t)B * F;
  float* gi = x + (size_t)B * 2 * F;
  float* gh = gi + (size_t)B * 3 * H;
  cx.partial = gh + (size_t)B * 3 * H;
  cx.partial_cap = split_capacity(B, H);
  TRY(run_copy(cx, hc, H, DT_F32, h0, H, dt, B, H, B));
  TRY(cudaMemsetAsync(fc, 0, sizeof(float) * B * F, cx.stream));
  TRY(run_copy(cx, x + F, 2 * F, DT_F32, cond, F, dt, B, F, B));

  const Gemm ar = gemm(mat(fc, F, 1, DT_F32), mat(w_ar, F, 1, dt), B, F, F,
                       x, 2 * F);
  const Gemm g_i = gemm(mat(x, 2 * F, 1, DT_F32), mat(w_i, 3 * H, 1, dt), B,
                        3 * H, 2 * F, gi, 3 * H);
  const Gemm g_h = gemm(mat(hc, H, 1, DT_F32), mat(w_h, 3 * H, 1, dt), B,
                        3 * H, H, gh, 3 * H);
  Gemm head = gemm(mat(hc, H, 1, DT_F32), mat(w_out, F, 1, dt), B, F, H, fc,
                   F);
  head.bias = b_out;
  head.bias_dt = dt;
  head.act = ACT_TANH;
  head.ldc2 = (long long)n_frames * F;
  head.c2dt = dt;
  for (int t = 0; t < n_frames; ++t) {
    TRY(run_gemm(cx, ar));
    TRY(run_gemm(cx, g_i, &g_h));
    gates_kernel<<<cdiv((long long)B * H, kThreads), kThreads, 0,
                   cx.stream>>>(
        gi, gh, b_i, b_h, dt, hc, DT_F32, hc,
        h_seq ? at(h_seq, (size_t)t * B * H, dt) : nullptr, dt, B, H);
    TRY(cudaGetLastError());
    head.c2 = at(feats, (size_t)t * F, dt);
    TRY(run_gemm(cx, head));
  }
  return (int)cudaSuccess;
}

// f32 elements of the backward's workspace.
size_t gru_scan_bwd_workspace(int batch, int hid, int feat, int n_frames) {
  const size_t R = (size_t)n_frames * batch, H = hid, F = feat;
  return R * (2 * F + 6 * H + H + 3 * F) + batch * (H + F + 3 * H) +
         colsum_room(batch, hid, feat, n_frames) +
         batch * (3 * H + F) +             // the sweep's sums of dgh, dfp
         R * (F + H) +                     // prev_f, prev_h
         split_capacity(batch, hid) + 16;  // + the grid barrier
}

// K5. g [B, n_frames, F] (the cotangent of feats), K4's feats
// [B, n_frames, F] and h_seq [n_frames, B, H], and the forward's inputs,
// all dtype dt.
// Outputs, dtype dt: dh0 [B,H], dcond [B,F], dw_i [2F,3H], dw_h [H,3H],
// db_i [3H], db_h [3H], dw_ar [F,F], dw_out [H,F], db_out [F].
// ws: gru_scan_bwd_workspace f32s. Three stages, run where `stages` has
// their bit: 1 recomputes every frame's gates and feat from the residuals,
// 2 is the reverse sweep (dh0 is written here, and on the persistent
// path the bias gradients), 4 the weight gradients, the bias sums of the
// host loop's path and dcond; they pass their results through ws, so the
// stages of one call may run in separate calls on the same ws, in order
// (stage 1 zeroes the grid barrier's counter for stage 2). With a
// plan, the sweep is one cooperative launch of scan_bwd_persistent (bf16
// only) and the products of stages 1 and 4 run on the tensor cores;
// without one, the host loop of frames and the CUDA-core products.
// Returns a cudaError_t code.
int gru_scan_bwd(const void* g, const void* feats, const void* h_seq,
                 const void* h0, const void* cond, const void* w_i,
                 const void* w_h,
                 const void* b_i, const void* b_h, const void* w_ar,
                 const void* w_out, const void* b_out, void* dh0,
                 void* dcond, void* dw_i, void* dw_h, void* db_i, void* db_h,
                 void* dw_ar, void* dw_out, void* db_out, float* ws,
                 int batch, int hid, int feat, int n_frames, int dt,
                 int stages, const int* plan_host, const int* plan_dev,
                 void* stream) {
  if (bad_dims(batch, hid, feat, n_frames, dt) ||
      (plan_host && bad_plan(plan_host, batch, hid, feat, dt)))
    return (int)cudaErrorInvalidValue;
  Ctx cx;
  TRY(make_ctx(stream, &cx));
  const int B = batch, H = hid, F = feat, R = n_frames * batch;
  float* x = ws;                            // [R, 2F]
  float* ga = x + (size_t)R * 2 * F;        // [R, 3H]: gi, then dgi
  float* gb = ga + (size_t)R * 3 * H;       // [R, 3H]: gh, then dgh
  float* hcur = gb + (size_t)R * 3 * H;     // [R, H]: h_t recomputed
  float* fcur = hcur + (size_t)R * H;       // [R, F]: feat_t recomputed
  float* dfp = fcur + (size_t)R * F;        // [R, F]
  float* dar = dfp + (size_t)R * F;         // [R, F]
  float* dhc = dar + (size_t)R * F;         // [B, H]: the dh carry
  float* dfc = dhc + (size_t)B * H;         // [B, F]: the AR dfeat carry
  float* sdgi = dfc + (size_t)B * F;        // [B, 3H]: dgi summed over t
  float* part = sdgi + (size_t)B * 3 * H;   // column-sum partials
  float* sgh = part + colsum_room(B, H, F, n_frames);  // [B, 3H]
  float* sfp = sgh + (size_t)B * 3 * H;     // [B, F]
  void* prev_f = sfp + (size_t)B * F;       // [R, F] in dt
  void* prev_h = at(prev_f, (size_t)R * F, dt);  // [R, H] in dt
  unsigned* bar = reinterpret_cast<unsigned*>(
      ws + gru_scan_bwd_workspace(B, H, F, n_frames) - 16);
  cx.partial = reinterpret_cast<float*>(bar) -
               split_capacity(B, H);         // split products' slices
  cx.partial_cap = split_capacity(B, H);

  // the persistent path runs the hoisted products on the tensor cores
  auto mm = [&](const Gemm& a, const Gemm* b = nullptr, bool split = true) {
    return plan_host ? run_gemm_tc(cx, a, b, split) : run_gemm(cx, a, b);
  };

  // 1. every frame's forward at once, from the stored residuals
  if (stages & 1) {
    residuals_kernel<<<cdiv((size_t)R * (F + H), kThreads), kThreads, 0,
                       cx.stream>>>(feats, h_seq, h0, cond, dt, prev_f,
                                    prev_h, x, bar, B, H, F, n_frames);
    TRY(cudaGetLastError());
    TRY(mm(gemm(mat(prev_f, F, 1, dt), mat(w_ar, F, 1, dt), R, F, F, x,
                2 * F)));
    const Gemm g_i = gemm(mat(x, 2 * F, 1, DT_F32), mat(w_i, 3 * H, 1, dt),
                          R, 3 * H, 2 * F, ga, 3 * H);
    const Gemm g_h = gemm(mat(prev_h, H, 1, dt), mat(w_h, 3 * H, 1, dt), R,
                          3 * H, H, gb, 3 * H);
    TRY(mm(g_i, &g_h));
    gates_kernel<<<cdiv((long long)R * H, kThreads), kThreads, 0, cx.stream>>>(
        ga, gb, b_i, b_h, dt, prev_h, dt, hcur, nullptr, dt, R, H);
    TRY(cudaGetLastError());
    Gemm head = gemm(mat(hcur, H, 1, DT_F32), mat(w_out, F, 1, dt), R, F, H,
                     fcur, F);
    head.bias = b_out;
    head.bias_dt = dt;
    head.act = ACT_TANH;
    TRY(mm(head));
  }

  // 2. the reverse sweep: only dh and the AR dfeat are carried
  if ((stages & 2) && plan_host) {
    using bf = const __nv_bfloat16*;
    BwdArgs a{};
    a.g = static_cast<bf>(g);
    a.prev_h = static_cast<bf>(prev_h);
    a.w_i = static_cast<bf>(w_i);
    a.w_h = static_cast<bf>(w_h);
    a.b_i = static_cast<bf>(b_i);
    a.b_h = static_cast<bf>(b_h);
    a.w_ar = static_cast<bf>(w_ar);
    a.w_out = static_cast<bf>(w_out);
    a.ga = ga;
    a.gb = gb;
    a.fcur = fcur;
    a.dfp = dfp;
    a.dar = dar;
    a.sgi = sdgi;
    a.sgh = sgh;
    a.sfp = sfp;
    a.dh0 = static_cast<__nv_bfloat16*>(dh0);
    a.db_i = static_cast<__nv_bfloat16*>(db_i);
    a.db_h = static_cast<__nv_bfloat16*>(db_h);
    a.db_out = static_cast<__nv_bfloat16*>(db_out);
    a.bar = bar;
    a.plan = plan_dev;
    a.batch = B;
    a.hid = H;
    a.feat = F;
    a.n_frames = n_frames;
    // stage 1 zeroed the barrier's counter
    TRY(launch_coop((const void*)scan_bwd_persistent, &a, plan_host[0],
                    gru_scan_bwd_smem(plan_host, H, F), cx.stream));
  } else if (stages & 2) {
    TRY(cudaMemsetAsync(dhc, 0, sizeof(float) * B * H, cx.stream));
    TRY(cudaMemsetAsync(dfc, 0, sizeof(float) * B * F, cx.stream));
    for (int t = n_frames - 1; t >= 0; --t) {
      const size_t row = (size_t)t * B;
      head_bwd_kernel<<<cdiv((long long)B * F, kThreads), kThreads, 0,
                        cx.stream>>>(at(g, (size_t)t * F, dt),
                                     (long long)n_frames * F, dt, dfc,
                                     fcur + row * F, dfp + row * F, B, F);
      TRY(cudaGetLastError());
      Gemm dh_head = gemm(mat(dfp + row * F, F, 1, DT_F32),
                          mat(w_out, 1, F, dt), B, H, F, dhc, H);
      dh_head.accumulate = 1;
      TRY(run_gemm(cx, dh_head));
      cell_bwd_kernel<<<cdiv((long long)B * H, kThreads), kThreads, 0,
                        cx.stream>>>(dhc, ga + row * 3 * H, gb + row * 3 * H,
                                     b_i, b_h, dt, at(prev_h, row * H, dt), dt,
                                     B, H);
      TRY(cudaGetLastError());
      Gemm dh_prev = gemm(mat(gb + row * 3 * H, 3 * H, 1, DT_F32),
                          mat(w_h, 1, 3 * H, dt), B, H, 3 * H, dhc, H);
      dh_prev.accumulate = 1;
      const Gemm d_ar = gemm(mat(ga + row * 3 * H, 3 * H, 1, DT_F32),
                             mat(w_i, 1, 3 * H, dt), B, F, 3 * H,
                             dar + row * F, F);
      TRY(run_gemm(cx, dh_prev, &d_ar));
      TRY(run_gemm(cx, gemm(mat(dar + row * F, F, 1, DT_F32),
                            mat(w_ar, 1, F, dt), B, F, F, dfc, F)));
    }
    TRY(run_copy(cx, dh0, H, dt, dhc, H, DT_F32, B, H, B));
  }

  // 3. weight gradients over all n*B rows, bias sums, dcond
  if (stages & 4) {
    Gemm dwi = gemm(mat(x, 1, 2 * F, DT_F32), mat(ga, 3 * H, 1, DT_F32),
                    2 * F, 3 * H, R, nullptr, 0);
    dwi.c2 = dw_i;
    dwi.ldc2 = 3 * H;
    dwi.c2dt = dt;
    Gemm dwh = gemm(mat(prev_h, 1, H, dt), mat(gb, 3 * H, 1, DT_F32), H,
                    3 * H, R, nullptr, 0);
    dwh.c2 = dw_h;
    dwh.ldc2 = 3 * H;
    dwh.c2dt = dt;
    TRY(mm(dwi, &dwh));
    Gemm dwo = gemm(mat(hcur, 1, H, DT_F32), mat(dfp, F, 1, DT_F32), H, F, R,
                    nullptr, 0);
    dwo.c2 = dw_out;
    dwo.ldc2 = F;
    dwo.c2dt = dt;
    Gemm dwa = gemm(mat(prev_f, 1, F, dt), mat(dar, F, 1, DT_F32), F, F, R,
                    nullptr, 0);
    dwa.c2 = dw_ar;
    dwa.ldc2 = F;
    dwa.c2dt = dt;
    TRY(mm(dwo, &dwa));
    if (!plan_host) {  // the persistent sweep wrote sdgi and the biases
      TRY(run_colsum(cx, ga, n_frames, B * 3 * H, part, sdgi, DT_F32));
      TRY(run_colsum(cx, sdgi, B, 3 * H, part, db_i, dt));
      TRY(run_colsum(cx, gb, R, 3 * H, part, db_h, dt));
      TRY(run_colsum(cx, dfp, R, F, part, db_out, dt));
    }
    // dcond = sum_t dgi_t @ w_i[F:]^T: the cond half of every frame's dx
    Gemm dc = gemm(mat(sdgi, 3 * H, 1, DT_F32),
                   mat(at(w_i, (size_t)F * 3 * H, dt), 1, 3 * H, dt), B, F,
                   3 * H, nullptr, 0);
    dc.c2 = dcond;
    dc.ldc2 = F;
    dc.c2dt = dt;
    TRY(mm(dc, nullptr, false));  // small: no split, no reduce launch
  }
  return (int)cudaSuccess;
}

const char* gru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
