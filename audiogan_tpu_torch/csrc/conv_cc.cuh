// The CUDA-core path of K1' (csrc/conv1d.cu) and K1 (csrc/convt1d.cu):
// every geometry outside the tensor-core path (csrc/igemm_tc.cuh), that
// is every f32 conv (the cp and tp steps, resample_22k, the parity
// phase) and the bf16 convs with one channel in or out (the critic's
// first layer and its dx, the generator's last layer and its dx).
//
// Both convs are sums of row-shifted products. kernels/conv.py::cc_plan
// lists each output phase's k-steps (tap j, row shift) and passes them
// here by value, so output row m of phase p (y row m * s_out + p) is
//
//   y[b, m*s_out + p, o] = act(bias[o] + sum_{e in p's k-steps}
//                              sum_c x[b, m*s_in + shift[e], c] * w[tap[e], c, o])
//
// with rows outside [0, t_in) read as zeros (the pads, any pad_lo, any
// t_in % s):
//   conv1d: one phase, s_in = s, s_out = 1, tap j at shift j - pad_lo;
//   convT:  s phases, s_in = 1, s_out = s, phase rho's tap at shift q is
//           j = pad_lo - rho + q*s (taps outside [0, K) left out, or, on
//           the thin-Cout kernel, multiplied as zeros).
//
// What bounds them on an H100 (67 TFLOP/s f32 on the CUDA cores, 3.35
// TB/s HBM): the f32 convs with Cin, Cout >= 32 do hundreds of flops per
// byte, so the FMA rate, and with 8 x 8 outputs a thread fed by 128-bit
// shared reads also the shared-memory rate, as high as the FMA rate's; the
// one-channel convs do about 25 flops per byte of bf16 and sit near both
// limits. The first design (PR 4/5) ran one batch element per convT
// block, so a 12-row cp slice filled a 64-row tile to 31% and restaged
// 2.4 MB of weights for 20 rows; it staged each chunk synchronously
// between two barriers and held 4 x 4 outputs a thread; its thin-Cout
// tile staged each x row once per phase. This design, three kernels:
//
//  * gemm: an implicit GEMM whose M runs over (batch element, output row
//    of one phase) flattened across the batch, so short rows of many
//    elements share one tile and one staged weight tile. 256 threads,
//    TM x TN = 128 x 128, 128 x 64, 64 x 64 or 128 x 32 outputs a block
//    (8 x 8, 8 x 4, 4 x 4, 4 x 4 a thread), chosen per geometry by
//    cc_plan from the card's timings. The depth runs over (channel chunk
//    of CK, k-step); a stage holds 16 of it (one k-step of 16 channels or
//    two of 8), an A tile [TM][CK] per k-step (its row of every M row,
//    zero outside x) and a B tile [CK][TN], in a ring of three stages, one
//    barrier a stage: f32 with Cin, Cout multiples of 4 and 16-byte
//    aligned tensors copies 16 bytes a thread with cp.async (zero-filled;
//    A through L1, which the chunk's next k-steps read again) while the
//    stage before is multiplied; bf16 and other shapes stage through plain
//    loads. Shared reads are float4 (A along the chunk, B along N); a
//    quarter warp reads one A row (broadcast) and 8 consecutive B vectors,
//    so no bank conflict. Four outputs a store where Cout % 4 == 0.
//  * thin_cout (convT, Cout <= 16): one block per (element, 512 or 1024
//    rows m) computes ALL s phases, (phase, Cout) as the N dimension in
//    groups of NP = 4, 8 or 16, from x rows staged once (cp.async, 16-byte
//    rows of 8 channels, a two-stage ring over the chunks) and every
//    weight of the block staged once; 4 rows x NP outputs a thread.
//  * thin_cin (conv1d, Cin < 8): a block of 256 or 128 rows x 64 output
//    channels of one element stages its whole x window (every channel,
//    packed by phase so a warp reads consecutive rows) and all taps once,
//    then runs 8 or 4 rows x 8 channels a thread, four outputs a store.
//
// Each output sums in the first design's order, so the bits are the
// first design's: channel chunks of CK (8; 16 on the convT gemm where m
// has more than 16 rows; one channel on thin_cin), within a chunk the
// k-steps in order, within a k-step the channels in order, each an IEEE
// f32 FMA into one accumulator (f32 for bf16 inputs too; no TF32). No
// split over the depth and no atomics, so two launches give the same
// bits. The epilogue adds the bias, applies the activation and rounds
// once to the output type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace convcc {

using rowconv::apply_act;
using rowconv::store;
using rowconv::to_f32;

// the plan's int32 fields (kernels/conv.py::cc_plan), then start[n_phase
// + 1], tap[n_steps], shift[n_steps]. P_TILE indexes the kind's tiles;
// P_CK is gemm's channel chunk, thin_cout's NP, thin_cin's Cin.
enum PlanField {
  P_KIND, P_TILE, P_CK, P_M_LIM, P_S_IN, P_S_OUT, P_OUT_LEN, P_N_PHASE,
  P_N_STEPS, P_HEAD
};
enum Kind { KIND_GEMM = 0, KIND_THIN_COUT = 1, KIND_THIN_CIN = 2 };

constexpr int kMaxPhases = 64;
constexpr int kMaxSteps = 256;
constexpr int kSmemLimit = 227 * 1024;

struct Steps {
  int start[kMaxPhases + 1];
  int tap[kMaxSteps];     // -1: a tap outside [0, K), multiplied as zeros
  int shift[kMaxSteps];   // output row m of the phase reads x row m*s_in + shift
};

struct Geom {
  int batch, t_in, cin, cout, k;
  int m_lim;     // output rows m per element and phase
  int s_in, s_out, out_len, n_phase;
  int act;
  float slope;
  int vec_y;     // Cout % 4 == 0 and y aligned: four outputs a store
};

// 16 bytes global -> shared, zero-filled where !ok; kL1 caches the line
// in L1 too (.ca: the gemm's A rows, which the next k-steps of a chunk
// read again), else L2 only (.cg)
template <bool kL1 = false>
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kL1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive outputs in one store (Cout % 4 == 0, aligned rows)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// 8 consecutive staged elements (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// -- gemm ---------------------------------------------------------------------

constexpr int kGemmThreads = 256;

// Thread (ty, tx) of the MT x NTT grid (16 x 16; 32 x 8 for TN = 32)
// owns rows ty*4 + (i%4) + (i/4)*4*MT and columns tx*4 + (j%4) +
// (j/4)*4*NTT of the block's TM x TN tile.
template <int T4>
__device__ __forceinline__ int quad_of(int i, int t) {
  return (i >> 2) * T4 + t * 4 + (i & 3);
}

constexpr int kGemmDepth = 16;   // channels x k-steps per stage
constexpr int kGemmStages = 3;

template <typename T, int TM, int TN, int CK, bool kAsync>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ bias, T* __restrict__ y, const Geom g,
            const __grid_constant__ Steps st) {
  constexpr int NT = kGemmThreads, NS = kGemmStages;
  constexpr int KS = kGemmDepth / CK;         // k-steps per stage
  constexpr int NTT = TN == 32 ? 8 : 16, MT = NT / NTT;   // thread grid
  constexpr int RM = TM / MT, RN = TN / NTT;
  constexpr int VE = kAsync ? 4 : 1;          // elements per copy
  constexpr int A_COPIES = TM * CK / VE, B_COPIES = CK * TN / VE;
  constexpr int SA = (A_COPIES + NT - 1) / NT, SB = (B_COPIES + NT - 1) / NT;
  static_assert(!kAsync || sizeof(T) == 4, "cp.async staging is f32 only");
  static_assert(RM % 4 == 0 && RN % 4 == 0, "4 x 4 quads a thread");
  __shared__ __align__(16) float As[NS][KS][TM][CK];
  __shared__ __align__(16) float Bs[NS][KS][CK][TN];

  const int tid = threadIdx.x, ty = tid / NTT, tx = tid % NTT;
  const int n_nt = (g.cout + TN - 1) / TN;
  const int phase = blockIdx.y / n_nt;
  const int o0 = (blockIdx.y - phase * n_nt) * TN;
  const int m0 = blockIdx.x * TM;
  const int total = g.batch * g.m_lim;
  const int s0 = st.start[phase], n_st = st.start[phase + 1] - s0;
  // the depth in order: chunk, then k-step; KS consecutive ones a stage
  const int n_it = ((g.cin + CK - 1) / CK) * n_st;
  const int n_stages = (n_it + KS - 1) / KS;

  // the A rows this thread copies: element base row b*t_in (-1: none) and
  // m*s_in, fixed over the depth
  int a_base[SA], a_m[SA];
#pragma unroll
  for (int sl = 0; sl < SA; ++sl) {
    const int e = tid + sl * NT;
    const int row = m0 + e / (CK / VE);
    a_base[sl] = -1;
    a_m[sl] = 0;
    if (e < A_COPIES && row < total) {
      const int b = row / g.m_lim;
      a_base[sl] = b * g.t_in;
      a_m[sl] = (row - b * g.m_lim) * g.s_in;
    }
  }

  auto fetch = [&](int it, float (*as)[CK], float (*bs)[TN]) {
    const int ch = it / n_st, e_st = s0 + it - ch * n_st;
    const int c0 = ch * CK, tap = st.tap[e_st], shift = st.shift[e_st];
#pragma unroll
    for (int sl = 0; sl < SA; ++sl) {
      const int e = tid + sl * NT;
      if (e >= A_COPIES) break;
      const int r = e / (CK / VE), c = (e % (CK / VE)) * VE;
      const int src = a_m[sl] + shift;
      const bool ok = a_base[sl] >= 0 && src >= 0 && src < g.t_in &&
                      c0 + c < g.cin;
      const size_t idx =
          ok ? (size_t)(a_base[sl] + src) * g.cin + c0 + c : 0;
      if constexpr (kAsync)
        cp_async16<true>(&as[r][c], x + idx, ok);
      else
        as[r][c] = ok ? to_f32(x[idx]) : 0.f;
    }
#pragma unroll
    for (int sl = 0; sl < SB; ++sl) {
      const int e = tid + sl * NT;
      if (e >= B_COPIES) break;
      const int c = e / (TN / VE), n = (e % (TN / VE)) * VE;
      const bool ok = c0 + c < g.cin && o0 + n < g.cout;
      const size_t idx =
          ok ? ((size_t)tap * g.cin + c0 + c) * g.cout + o0 + n : 0;
      if constexpr (kAsync)
        cp_async16(&bs[c][n], w + idx, ok);
      else
        bs[c][n] = ok ? to_f32(w[idx]) : 0.f;
    }
  };
  auto fetch_stage = [&](int sg) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      if (sg * KS + kk < n_it) fetch(sg * KS + kk, As[sg % NS][kk], Bs[sg % NS][kk]);
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  // a ring of NS stages: stage sg + NS - 1 loads while stage sg is
  // multiplied; one barrier a stage
#pragma unroll
  for (int sg = 0; sg < NS - 1; ++sg) {
    if (sg < n_stages) fetch_stage(sg);
    if constexpr (kAsync) cp_async_commit();
  }
  for (int sg = 0; sg < n_stages; ++sg) {
    if constexpr (kAsync) cp_async_wait<NS - 2>();
    __syncthreads();
    if (sg + NS - 1 < n_stages) fetch_stage(sg + NS - 1);
    if constexpr (kAsync) cp_async_commit();
    const int buf = sg % NS;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (sg * KS + kk >= n_it) break;
#pragma unroll
      for (int c4 = 0; c4 < CK; c4 += 4) {
        float4 a[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              &As[buf][kk][quad_of<4 * MT>(i, ty)][c4]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float bv[RN];
#pragma unroll
          for (int j = 0; j < RN; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &Bs[buf][kk][c4 + cc][quad_of<4 * NTT>(j, tx)]);
            bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float av = component(a[i], cc);
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }

  float bv[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int o = o0 + quad_of<4 * NTT>(j, tx);
    bv[j] = o < g.cout ? to_f32(bias[o]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + quad_of<4 * MT>(i, ty);
    if (row >= total) continue;
    const int b = row / g.m_lim;
    const int t = (row - b * g.m_lim) * g.s_out + phase;
    if (t >= g.out_len) continue;
    T* yr = y + ((size_t)b * g.out_len + t) * g.cout;
#pragma unroll
    for (int j = 0; j < RN; j += 4) {
      const int o = o0 + quad_of<4 * NTT>(j, tx);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = apply_act(acc[i][j + q] + bv[j + q], g.act, g.slope);
      if (g.vec_y && o < g.cout) {
        store4(yr + o, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (o + q < g.cout) store(yr + o + q, v[q]);
      }
    }
  }
}

template <typename T, int TM, int TN, int CK, bool kAsync>
cudaError_t launch_gemm(const void* x, const void* w, const void* bias,
                        void* y, const Geom& g, const Steps& st,
                        cudaStream_t stream) {
  const long long total = (long long)g.batch * g.m_lim;
  const int n_nt = (g.cout + TN - 1) / TN;
  if (total > INT_MAX - TM || (long long)n_nt * g.n_phase > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((total + TM - 1) / TM), n_nt * g.n_phase);
  gemm_kernel<T, TM, TN, CK, kAsync><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(y), g, st);
  return cudaGetLastError();
}

template <typename T, int TM, int TN, bool kAsync>
cudaError_t launch_gemm_ck(int ck, const void* x, const void* w,
                           const void* bias, void* y, const Geom& g,
                           const Steps& st, cudaStream_t stream) {
  if (ck == 8)
    return launch_gemm<T, TM, TN, 8, kAsync>(x, w, bias, y, g, st, stream);
  if (ck == 16)
    return launch_gemm<T, TM, TN, 16, kAsync>(x, w, bias, y, g, st, stream);
  return cudaErrorInvalidValue;
}

template <typename T, bool kAsync>
cudaError_t dispatch_gemm(int tile, int ck, const void* x, const void* w,
                          const void* bias, void* y, const Geom& g,
                          const Steps& st, cudaStream_t stream) {
  switch (tile) {  // kernels/conv.py::CC_TILES
    case 0:
      return launch_gemm_ck<T, 128, 128, kAsync>(ck, x, w, bias, y, g, st, stream);
    case 1:
      return launch_gemm_ck<T, 128, 64, kAsync>(ck, x, w, bias, y, g, st, stream);
    case 2:
      return launch_gemm_ck<T, 64, 64, kAsync>(ck, x, w, bias, y, g, st, stream);
    case 3:
      return launch_gemm_ck<T, 128, 32, kAsync>(ck, x, w, bias, y, g, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

// -- thin_cout: convT with Cout <= 16, all phases per block ------------------

constexpr int kThinCK = 8;     // channels per chunk: one 16-byte bf16 row
constexpr int kThinRows = 4;   // rows m per thread

// staged x row pitch in elements: 48 bytes for f32 (two float4 reads a
// row, no bank conflict in a quarter warp), 16 for bf16
template <typename T>
__host__ __device__ constexpr int thin_pitch() {
  return sizeof(T) == 4 ? 12 : 8;
}

// shared bytes of thin_cout_kernel: every weight of the block, then two x
// stages of TM + span rows (span = the last shift minus the first)
template <typename T>
inline size_t thin_cout_smem(int threads, int np, int cin, int q_taps,
                             int span) {
  const size_t chunks = (cin + kThinCK - 1) / kThinCK;
  const size_t rows = (size_t)kThinRows * threads + span;
  return sizeof(float) * chunks * kThinCK * q_taps * np +
         2 * rows * thin_pitch<T>() * sizeof(T);
}

template <typename T, int NP, int NT, bool kAsync>
__global__ void __launch_bounds__(NT)
thin_cout_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y, const Geom g,
                 const __grid_constant__ Steps st) {
  constexpr int RM = kThinRows, TM = RM * NT, CK = kThinCK;
  constexpr int RS = thin_pitch<T>();
  constexpr int VE = 16 / sizeof(T);           // elements per 16-byte copy
  constexpr int CPR = CK / VE;                 // copies per staged row
  extern __shared__ __align__(16) unsigned char cc_smem[];
  // every phase lists the same shifts, shift0 .. shift0 + q_taps - 1
  const int q_taps = st.start[1];
  const int shift0 = st.shift[0];
  const int rows = TM + q_taps - 1;
  const int n_ch = (g.cin + CK - 1) / CK;
  float* ws = reinterpret_cast<float*>(cc_smem);    // [n_ch][q_taps][CK][NP]
  T* xs = reinterpret_cast<T*>(cc_smem + sizeof(float) * n_ch * CK * q_taps * NP);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * NP, b = blockIdx.z;
  const T* xb = x + (size_t)b * g.t_in * g.cin;

  auto fetch = [&](int ch, int buf) {
    const int c0 = ch * CK;
    T* xd = xs + (size_t)buf * rows * RS;
    if constexpr (kAsync) {
      for (int e = tid; e < rows * CPR; e += NT) {
        const int r = e / CPR, c = (e % CPR) * VE;
        const int src = m0 + shift0 + r;
        const bool ok = src >= 0 && src < g.t_in && c0 + c < g.cin;
        cp_async16(xd + r * RS + c, ok ? xb + (size_t)src * g.cin + c0 + c : x,
                   ok);
      }
    } else {
      for (int e = tid; e < rows * CK; e += NT) {
        const int r = e / CK, c = e % CK;
        const int src = m0 + shift0 + r;
        const bool ok = src >= 0 && src < g.t_in && c0 + c < g.cin;
        xd[r * RS + c] = ok ? xb[(size_t)src * g.cin + c0 + c] : zero_of<T>();
      }
    }
  };

  fetch(0, 0);
  // every tap of the block: phase rho = n / Cout of column n, zero where
  // the tap leaves [0, K), the column leaves s * Cout or c leaves Cin
  for (int e = tid; e < n_ch * q_taps * CK * NP; e += NT) {
    const int nn = e % NP, c = (e / NP) % CK;
    const int tau = (e / (NP * CK)) % q_taps, ch = e / (NP * CK * q_taps);
    const int n = n0 + nn, rho = n / g.cout, o = n - rho * g.cout;
    const int ci = ch * CK + c;
    float v = 0.f;
    if (rho < g.n_phase && ci < g.cin) {
      const int tap = st.tap[st.start[rho] + tau];
      if (tap >= 0) v = to_f32(w[((size_t)tap * g.cin + ci) * g.cout + o]);
    }
    ws[e] = v;
  }
  if constexpr (kAsync) cp_async_wait_all();
  __syncthreads();

  float acc[RM][NP];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[i][j] = 0.f;

  for (int ch = 0; ch < n_ch; ++ch) {
    const int cur = ch & 1;
    if (ch + 1 < n_ch) fetch(ch + 1, cur ^ 1);
    const T* xc = xs + (size_t)cur * rows * RS;
    for (int tau = 0; tau < q_taps; ++tau) {
      float a[RM][8];
#pragma unroll
      for (int i = 0; i < RM; ++i) load8(xc + (tid + i * NT + tau) * RS, a[i]);
      const float* wt = ws + (size_t)(ch * q_taps + tau) * CK * NP;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float wv[NP];
#pragma unroll
        for (int j = 0; j < NP; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(wt + c * NP + j);
          wv[j] = v.x; wv[j + 1] = v.y; wv[j + 2] = v.z; wv[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < NP; ++j)
            acc[i][j] = fmaf(a[i][c], wv[j], acc[i][j]);
      }
    }
    if constexpr (kAsync) {
      if (ch + 1 < n_ch) cp_async_wait_all();
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int n = n0 + j, rho = n / g.cout, o = n - rho * g.cout;
    if (rho >= g.n_phase) continue;
    const float bj = to_f32(bias[o]);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + tid + i * NT;
      const int t = m * g.s_out + rho;
      if (m < g.m_lim && t < g.out_len)
        store(y + ((size_t)b * g.out_len + t) * g.cout + o,
              apply_act(acc[i][j] + bj, g.act, g.slope));
    }
  }
}

template <typename T, int NP, int NT, bool kAsync>
cudaError_t launch_thin_cout(const void* x, const void* w, const void* bias,
                             void* y, const Geom& g, const Steps& st,
                             cudaStream_t stream) {
  const int q_taps = st.start[1];
  const size_t smem = thin_cout_smem<T>(NT, NP, g.cin, q_taps, q_taps - 1);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidConfiguration;
  auto kern = thin_cout_kernel<T, NP, NT, kAsync>;
  if (smem > 48 * 1024) {
    // once per kernel, at its first launch above 48 KB (an eager one,
    // before any graph capture), up to the card's limit
    static const cudaError_t set = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (set != cudaSuccess) return set;
  }
  const int n_nt = (g.n_phase * g.cout + NP - 1) / NP;
  const int n_mt = (g.m_lim + kThinRows * NT - 1) / (kThinRows * NT);
  if (n_nt > 65535 || g.batch > 65535) return cudaErrorInvalidConfiguration;
  kern<<<dim3(n_mt, n_nt, g.batch), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(y), g, st);
  return cudaGetLastError();
}

template <typename T, int NP, bool kAsync>
cudaError_t launch_thin_cout_tile(int tile, const void* x, const void* w,
                                  const void* bias, void* y, const Geom& g,
                                  const Steps& st, cudaStream_t stream) {
  if (tile == 0)   // kernels/conv.py::CC_THIN_COUT_THREADS
    return launch_thin_cout<T, NP, 128, kAsync>(x, w, bias, y, g, st, stream);
  if (tile == 1)
    return launch_thin_cout<T, NP, 256, kAsync>(x, w, bias, y, g, st, stream);
  return cudaErrorInvalidValue;
}

template <typename T, bool kAsync>
cudaError_t dispatch_thin_cout(int tile, int np, const void* x, const void* w,
                               const void* bias, void* y, const Geom& g,
                               const Steps& st, cudaStream_t stream) {
  switch (np) {
    case 4: return launch_thin_cout_tile<T, 4, kAsync>(tile, x, w, bias, y, g, st, stream);
    case 8: return launch_thin_cout_tile<T, 8, kAsync>(tile, x, w, bias, y, g, st, stream);
    case 16: return launch_thin_cout_tile<T, 16, kAsync>(tile, x, w, bias, y, g, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

// -- thin_cin: conv1d with Cin < 8 -------------------------------------------

constexpr int kThinCinN = 64;   // output channels per block

// shared bytes of thin_cin_kernel: the taps [Cin][K][64], then the x
// window [Cin][s][TM + span / s] packed by phase
inline size_t thin_cin_smem(int tm, int cin, int k, int s, int span) {
  return sizeof(float) * ((size_t)cin * k * kThinCinN +
                          (size_t)cin * s * (tm + span / s));
}

template <typename T, int TM>
__global__ void __launch_bounds__(256)
thin_cin_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ y, const Geom g,
                const __grid_constant__ Steps st) {
  constexpr int NT = 256, TN = kThinCinN, RM = TM / 32, RN = 8;
  extern __shared__ __align__(16) float cc_smem_f[];
  const int s = g.s_in, n_taps = st.start[1];
  const int shift0 = st.shift[0];
  const int prow = TM + (st.shift[n_taps - 1] - shift0) / s;
  float* ws = cc_smem_f;                           // [cin][K][TN]
  float* xs = ws + (size_t)g.cin * n_taps * TN;    // [cin][s][prow]
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int t0 = blockIdx.x * TM, o0 = blockIdx.y * TN, b = blockIdx.z;

  for (int e = tid; e < g.cin * n_taps * TN; e += NT) {
    const int n = e % TN, j = (e / TN) % n_taps, c = e / (TN * n_taps);
    const int o = o0 + n;
    ws[e] = o < g.cout
                ? to_f32(w[((size_t)st.tap[j] * g.cin + c) * g.cout + o])
                : 0.f;
  }
  // window element ii is x row t0*s + shift0 + ii, staged at packed row
  // ii / s of phase ii % s
  const int span = prow * s;
  const int base = t0 * s + shift0;
  for (int e = tid; e < g.cin * span; e += NT) {
    const int c = e / span, ii = e - c * span;
    const int i = base + ii;
    const float v = (i >= 0 && i < g.t_in)
                        ? to_f32(x[((size_t)b * g.t_in + i) * g.cin + c])
                        : 0.f;
    xs[((size_t)c * s + ii % s) * prow + ii / s] = v;
  }
  __syncthreads();

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < g.cin; ++c) {
    for (int j = 0; j < n_taps; ++j) {
      const int d = st.shift[j] - shift0, q = d / s, p = d - q * s;
      const float* xr = xs + ((size_t)c * s + p) * prow + q + ty;
      const float* wr = ws + ((size_t)c * n_taps + j) * TN + tx * 4;
      float a[RM], bw[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xr[32 * i];
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 32);
      bw[0] = w0.x; bw[1] = w0.y; bw[2] = w0.z; bw[3] = w0.w;
      bw[4] = w1.x; bw[5] = w1.y; bw[6] = w1.z; bw[7] = w1.w;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < RN; ++jj)
          acc[i][jj] = fmaf(a[i], bw[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int jg = 0; jg < RN; jg += 4) {
    const int o = o0 + (jg >> 2) * 32 + tx * 4;
    float bj[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bj[q] = o + q < g.cout ? to_f32(bias[o + q]) : 0.f;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = t0 + ty + 32 * i;
      if (t >= g.m_lim) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = apply_act(acc[i][jg + q] + bj[q], g.act, g.slope);
      T* yp = y + ((size_t)b * g.out_len + t) * g.cout + o;
      if (g.vec_y && o < g.cout) {
        store4(yp, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (o + q < g.cout) store(yp + q, v[q]);
      }
    }
  }
}

template <typename T, int TM>
cudaError_t launch_thin_cin(const void* x, const void* w, const void* bias,
                            void* y, const Geom& g, const Steps& st,
                            cudaStream_t stream) {
  const int n_taps = st.start[1];
  const size_t smem = thin_cin_smem(TM, g.cin, n_taps, g.s_in,
                                    st.shift[n_taps - 1] - st.shift[0]);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidConfiguration;
  auto kern = thin_cin_kernel<T, TM>;
  if (smem > 48 * 1024) {
    // once per kernel, at its first launch above 48 KB (an eager one,
    // before any graph capture), up to the card's limit
    static const cudaError_t set = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (set != cudaSuccess) return set;
  }
  const int n_nt = (g.cout + kThinCinN - 1) / kThinCinN;
  if (n_nt > 65535 || g.batch > 65535) return cudaErrorInvalidConfiguration;
  kern<<<dim3((g.m_lim + TM - 1) / TM, n_nt, g.batch), 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(y), g, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_thin_cin(int tile, const void* x, const void* w,
                              const void* bias, void* y, const Geom& g,
                              const Steps& st, cudaStream_t stream) {
  if (tile == 0)   // kernels/conv.py::CC_THIN_CIN_ROWS
    return launch_thin_cin<T, 256>(x, w, bias, y, g, st, stream);
  if (tile == 1) return launch_thin_cin<T, 128>(x, w, bias, y, g, st, stream);
  return cudaErrorInvalidValue;
}

// -- the launch -----------------------------------------------------------------

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool kThinCout, bool kThinCin>
cudaError_t launch_typed(int kind, int tile, int ck, const void* x,
                         const void* w, const void* bias, void* y,
                         const Geom& g, const Steps& st,
                         cudaStream_t stream) {
  if (kind == KIND_GEMM) {
    if constexpr (sizeof(T) == 4) {
      if (g.cin % 4 == 0 && g.cout % 4 == 0 && aligned16(x) && aligned16(w))
        return dispatch_gemm<T, true>(tile, ck, x, w, bias, y, g, st, stream);
    }
    return dispatch_gemm<T, false>(tile, ck, x, w, bias, y, g, st, stream);
  }
  if constexpr (kThinCout) {
    if (kind == KIND_THIN_COUT) {
      const int np = ck;
      if ((g.cin * sizeof(T)) % 16 == 0 && aligned16(x))
        return dispatch_thin_cout<T, true>(tile, np, x, w, bias, y, g, st, stream);
      return dispatch_thin_cout<T, false>(tile, np, x, w, bias, y, g, st, stream);
    }
  }
  if constexpr (kThinCin) {
    if (kind == KIND_THIN_CIN)
      return dispatch_thin_cin<T>(tile, x, w, bias, y, g, st, stream);
  }
  return cudaErrorInvalidValue;
}

// Checks the plan against the shape and launches its kernel. kThinCout /
// kThinCin: the kinds this library carries (convT's and conv1d's).
// Returns a cudaError_t (cudaSuccess = launched).
template <bool kThinCout, bool kThinCin>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   int batch, int t_in, int cin, int cout, int k,
                   const int* plan, int act, float slope, int dtype,
                   cudaStream_t stream) {
  if (batch <= 0 || t_in <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      plan == nullptr || act < rowconv::ACT_NONE || act > rowconv::ACT_TANH)
    return cudaErrorInvalidValue;
  Geom g;
  g.batch = batch; g.t_in = t_in; g.cin = cin; g.cout = cout; g.k = k;
  g.m_lim = plan[P_M_LIM]; g.s_in = plan[P_S_IN]; g.s_out = plan[P_S_OUT];
  g.out_len = plan[P_OUT_LEN]; g.n_phase = plan[P_N_PHASE];
  g.act = act; g.slope = slope;
  g.vec_y = cout % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(y) &
             (dtype == rowconv::DT_F32 ? 15 : 7)) == 0;
  const int kind = plan[P_KIND], tile = plan[P_TILE], ck = plan[P_CK];
  const int n = plan[P_N_STEPS];
  if (g.m_lim < 1 || g.s_in < 1 || g.s_out < 1 || g.out_len < 1 ||
      g.n_phase < 1 || g.n_phase > kMaxPhases || n < 1 || n > kMaxSteps)
    return cudaErrorInvalidValue;
  const int* start = plan + P_HEAD;
  const int* tap = start + g.n_phase + 1;
  const int* shift = tap + n;
  Steps st = {};
  for (int p = 0; p <= g.n_phase; ++p) {
    st.start[p] = start[p];
    if (start[p] < 0 || start[p] > n || (p > 0 && start[p] < start[p - 1]))
      return cudaErrorInvalidValue;
  }
  if (start[0] != 0 || start[g.n_phase] != n) return cudaErrorInvalidValue;
  for (int e = 0; e < n; ++e) {
    if (tap[e] >= k || tap[e] < (kind == KIND_THIN_COUT ? -1 : 0))
      return cudaErrorInvalidValue;
    st.tap[e] = tap[e];
    st.shift[e] = shift[e];
  }
  if (kind == KIND_THIN_COUT) {
    // every phase: the same q_taps shifts, consecutive
    const int q = start[1];
    for (int p = 0; p < g.n_phase; ++p) {
      if (start[p + 1] - start[p] != q) return cudaErrorInvalidValue;
      for (int t = 0; t < q; ++t)
        if (shift[start[p] + t] != shift[0] + t) return cudaErrorInvalidValue;
    }
  } else if (kind == KIND_THIN_CIN) {
    // one phase, shifts ascending, m_lim = out_len
    if (g.n_phase != 1 || g.m_lim != g.out_len || ck != cin)
      return cudaErrorInvalidValue;
    for (int e = 1; e < n; ++e)
      if (shift[e] < shift[e - 1]) return cudaErrorInvalidValue;
  }
  if (dtype == rowconv::DT_F32)
    return launch_typed<float, kThinCout, kThinCin>(kind, tile, ck, x, w, bias,
                                                    y, g, st, stream);
  if (dtype == rowconv::DT_BF16)
    return launch_typed<__nv_bfloat16, kThinCout, kThinCin>(
        kind, tile, ck, x, w, bias, y, g, st, stream);
  return cudaErrorInvalidValue;
}

}  // namespace convcc
