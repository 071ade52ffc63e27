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
// before the last has ended. On the TPU all weights (3.5 MB in bf16) stay in
// the 16 MB VMEM for the whole scan; an SM has 228 KB, so here they are read
// from the 50 MB L2 every frame. This first design is simple and right:
//  * one tiled f32 product on the CUDA cores (gemm_kernel: 256 threads,
//    4x4 or 8x8 outputs each, operands staged through shared memory as
//    f32, any strides, so every transpose is a view), with a fused
//    bias / tanh / accumulate epilogue and an optional rounded copy; a
//    product too small to give every SM two blocks (the per-frame ones
//    have 64 rows) splits its depth over more blocks, and a reduce kernel
//    adds the slices in a fixed order and runs the epilogue;
//  * elementwise kernels for the gate blend and its backward;
//  * the frame loop runs on the host, on the caller's stream: per frame
//    three products and the gate blend forward, four products and two
//    elementwise kernels in the backward's sequential sweep;
//  * the backward's recompute and its weight gradients do not depend on
//    the carried dh, so they run once over all n*B rows (products of
//    16384 rows) before and after the sweep; the sweep carries only
//    dh [B,H] and the autoregressive dfeat [B,F] and writes each frame's
//    gate gradients to device memory for those products;
//  * every sum has a fixed order (no atomics), so a result is the same
//    bits on every run.
// A persistent cooperative grid and tensor-core gate products are later
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

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

// K4. Inputs (dtype dt, contiguous, on the device): h0 [B,H], cond [B,F],
// w_i [2F,3H], w_h [H,3H], b_i [3H], b_h [3H], w_ar [F,F], w_out [H,F],
// b_out [F]. Outputs: feats [B, n_frames, F] (dt) and, when h_seq is not
// null, h_seq [n_frames, B, H] (dt). ws: gru_scan_fwd_workspace f32s.
// Returns a cudaError_t code.
int gru_scan_fwd(const void* h0, const void* cond, const void* w_i,
                 const void* w_h, const void* b_i, const void* b_h,
                 const void* w_ar, const void* w_out, const void* b_out,
                 void* feats, void* h_seq, float* ws, int batch, int hid,
                 int feat, int n_frames, int dt, void* stream) {
  if (bad_dims(batch, hid, feat, n_frames, dt))
    return (int)cudaErrorInvalidValue;
  Ctx cx;
  TRY(make_ctx(stream, &cx));
  const int B = batch, H = hid, F = feat;
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
  const size_t partial = std::max(
      {(size_t)colsum_chunks(n_frames) * batch * 3 * H,
       (size_t)colsum_chunks(batch) * 3 * H,
       (size_t)colsum_chunks((int)R) * 3 * H,
       (size_t)colsum_chunks((int)R) * F});
  return R * (2 * F + 6 * H + H + 3 * F) + batch * (H + F + 3 * H) +
         partial + split_capacity(batch, hid);
}

// K5. g [B, n_frames, F] (the cotangent of feats), prev_f [n_frames, B, F]
// (zeros, then feats of frames 0..n-2), prev_h [n_frames, B, H] (h0, then
// h_seq of frames 0..n-2), and the forward's inputs, all dtype dt.
// Outputs, dtype dt: dh0 [B,H], dcond [B,F], dw_i [2F,3H], dw_h [H,3H],
// db_i [3H], db_h [3H], dw_ar [F,F], dw_out [H,F], db_out [F].
// ws: gru_scan_bwd_workspace f32s. Returns a cudaError_t code.
int gru_scan_bwd(const void* g, const void* prev_f, const void* prev_h,
                 const void* cond, const void* w_i, const void* w_h,
                 const void* b_i, const void* b_h, const void* w_ar,
                 const void* w_out, const void* b_out, void* dh0,
                 void* dcond, void* dw_i, void* dw_h, void* db_i, void* db_h,
                 void* dw_ar, void* dw_out, void* db_out, float* ws,
                 int batch, int hid, int feat, int n_frames, int dt,
                 void* stream) {
  if (bad_dims(batch, hid, feat, n_frames, dt))
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
  cx.partial = ws + gru_scan_bwd_workspace(B, H, F, n_frames) -
               split_capacity(B, H);         // split products' slices
  cx.partial_cap = split_capacity(B, H);

  // 1. every frame's forward at once, from the stored residuals
  TRY(run_gemm(cx, gemm(mat(prev_f, F, 1, dt), mat(w_ar, F, 1, dt), R, F, F,
                        x, 2 * F)));
  TRY(run_copy(cx, x + F, 2 * F, DT_F32, cond, F, dt, R, F, B));
  {
    const Gemm g_i = gemm(mat(x, 2 * F, 1, DT_F32), mat(w_i, 3 * H, 1, dt),
                          R, 3 * H, 2 * F, ga, 3 * H);
    const Gemm g_h = gemm(mat(prev_h, H, 1, dt), mat(w_h, 3 * H, 1, dt), R,
                          3 * H, H, gb, 3 * H);
    TRY(run_gemm(cx, g_i, &g_h));
  }
  gates_kernel<<<cdiv((long long)R * H, kThreads), kThreads, 0, cx.stream>>>(
      ga, gb, b_i, b_h, dt, prev_h, dt, hcur, nullptr, dt, R, H);
  TRY(cudaGetLastError());
  {
    Gemm head = gemm(mat(hcur, H, 1, DT_F32), mat(w_out, F, 1, dt), R, F, H,
                     fcur, F);
    head.bias = b_out;
    head.bias_dt = dt;
    head.act = ACT_TANH;
    TRY(run_gemm(cx, head));
  }

  // 2. the reverse sweep: only dh and the AR dfeat are carried
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

  // 3. weight gradients over all n*B rows, bias sums, dcond, dh0
  {
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
    TRY(run_gemm(cx, dwi, &dwh));
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
    TRY(run_gemm(cx, dwo, &dwa));
  }
  TRY(run_colsum(cx, ga, n_frames, B * 3 * H, part, sdgi, DT_F32));
  TRY(run_colsum(cx, sdgi, B, 3 * H, part, db_i, dt));
  TRY(run_colsum(cx, gb, R, 3 * H, part, db_h, dt));
  TRY(run_colsum(cx, dfp, R, F, part, db_out, dt));
  {
    // dcond = sum_t dgi_t @ w_i[F:]^T: the cond half of every frame's dx
    Gemm dc = gemm(mat(sdgi, 3 * H, 1, DT_F32),
                   mat(at(w_i, (size_t)F * 3 * H, dt), 1, 3 * H, dt), B, F,
                   3 * H, nullptr, 0);
    dc.c2 = dcond;
    dc.ldc2 = F;
    dc.c2dt = dt;
    TRY(run_gemm(cx, dc));
  }
  TRY(run_copy(cx, dh0, H, dt, dhc, H, DT_F32, B, H, B));
  return (int)cudaSuccess;
}

const char* gru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
