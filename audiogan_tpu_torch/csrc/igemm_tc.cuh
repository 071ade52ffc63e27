// The tensor-core path of K1' (csrc/conv1d.cu) and K1 (csrc/convt1d.cu):
// a bf16 implicit GEMM for Hopper (sm_90a), fed by TMA through an
// mbarrier ring, multiplied by wgmma into f32 accumulators.
//
// Both convs are sums of row-shifted products. With the k-step table that
// kernels/conv.py builds (conv1d_ksteps, convt_ksteps) and passes here by
// value, each output tile is
//
//   D[r, o] = sum_{e in phase's k-steps} sum_c A[b(r), t(r) + row[e], pin[e], c] * w[tap[e], c, o]
//
// over a 4-D view A [B, a_rows, a_phases, Cin] of the input:
//   conv1d: x [B, T, Cin] viewed as [B, T/s, s, Cin] (T % s == 0): tap j
//     of output t reads packed row t + qq at phase pp, j - pad_lo =
//     qq*s + pp; one phase of output;
//   convT:  x as [B, T, 1, Cin]; output phase rho (y row m*s + rho) reads
//     row m + q at tap j = pad_lo - rho + q*s, and taps outside [0, K)
//     are not in the table (skipped, not multiplied by zeros).
//   sconv1d (K6, csrc/sconv.cu): conv1d of z[b] = xp[b, offs[b] : offs[b] +
//     T] (zero outside [0, T)), xp [B, T + 2 rad, Cin]: one A view per
//     offset o in [0, 2 rad] over xp from row o, [B, T/s, s, Cin] with
//     xp's batch stride; element b's rows come through view offs[b], so
//     they are exactly z[b] (below).
// A row outside [0, a_rows) is a row of the pads: TMA's out-of-bounds
// fill writes it as zeros, so the padding costs no code: for K6 that is
// the conv's padding in z-space, and no row of xp outside element b's
// window is ever read as data. So does a ragged last channel chunk (A and
// w both read zeros past Cin) and a ragged Cout tile (w reads zeros past
// Cout; the epilogue masks the stores).
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 3.35 TB/s HBM): at
// the WaveGAN geometries with Cin, Cout >= 64 the convs do hundreds of
// flops per byte they must move, so the tensor cores. The first design
// (f32 staging and scalar FMAs, csrc/rowconv_tiles.cuh) ran them at
// 4-19 TFLOP/s; this one:
//  * an M x N output tile per block, M = 64 or 128 rows (one or two
//    consumer warpgroups of 64 rows), N = 64 or 128 channels; the tile is
//    chosen per geometry by kernels/conv.py::tc_plan so the grid fills
//    the 132 SMs;
//  * short rows stack batch elements: the A box {64 ch, rows, 1, nb}
//    lands as [nb][rows][64], one contiguous operand tile, and each element
//    gets its own zero halo from the out-of-bounds fill; with one view per
//    offset (K6) each element is its own box {64, 1, rows, 1} through its
//    own view, at the place the stacked box would put it (rows a multiple
//    of 8, so each box starts on a 1024-byte swizzle period);
//  * a ring of kStages stages, each an A tile [M][64] and a B tile
//    [2][64][64] (Cin x Cout, Cout contiguous: MN-major, the wgmma
//    transpose bit), in 128-byte swizzle at 1024-byte aligned bases; one
//    producer thread issues cp.async.bulk.tensor and arms each stage's
//    full barrier with the whole boxes' bytes (filled bytes count too);
//    consumers release a stage through its empty barrier once the wgmma
//    group that read it has retired, so loads run kStages - 1 ahead;
//  * wgmma.m64nNk16 bf16 -> f32, four per 64-channel k-step, one group in
//    flight behind the next;
//  * epilogue in registers: bias + activation in f32, one bf16 rounding,
//    masked stores at output row t*s_out + phase;
//  * the placed epilogue (PLACED, K7 in csrc/sconv.cu): no bias, no
//    activation, output row yr of element b stored at row yr + off_b of
//    a [B, y_len + 2 rad, Cout] output (off_b = offs[b] clamped into
//    [0, 2 rad]); the 2 rad rows outside each window are written as zeros
//    by the block of phase 0 and m-tile 0 (every element of a stacked
//    tile, its own BN columns), before its main loop. Window rows and
//    zero rows are disjoint, so every output element is written once, by
//    one block.
// Each output is summed in one fixed order (k-steps, then channel chunks,
// then the 16-deep slices), so two launches give the same bits; no split
// over the depth, no atomics.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace igemm {

constexpr int kChunk = 64;       // channels per k-step chunk: a 128-byte row
constexpr int kStages = 4;
constexpr int kMaxSteps = 64;
constexpr int kMaxPhases = 16;
constexpr int kPlanHead = 9;     // tile, rows, nb, n_mt, t_lim, s_out,
                                 // y_len, n_phase, n_steps

// The k-step table of kernels/conv.py (conv1d_ksteps / convt_ksteps):
// phase p runs entries [start[p], start[p + 1]).
struct KSteps {
  int start[kMaxPhases + 1];
  int tap[kMaxSteps];       // j: the B box is w[j, c0:c0+64, o0:o0+N]
  int row[kMaxSteps];       // A row shift
  int pin[kMaxSteps];       // A phase index (conv1d's pp; 0 for convT)
};

struct Plan {
  int batch, cin, cout;
  int rows, nb;    // A box: rows x nb batch elements, rows * nb <= M
  int n_mt;        // m tiles per element (1 when nb > 1)
  int n_m;         // M blocks: ceil(batch / nb), or batch * n_mt
  int t_lim;       // output rows per element and phase
  int s_out;       // output row = t * s_out + phase
  int y_len;       // output rows per element
  int n_phase, n_ot, n_chunks;
  int act;
  float slope;
  const int* offs;  // K6: element b's A view is offs[b] (clamped to
  int max_off;      // [0, max_off]); null for one view. K7 (PLACED):
                    // element b's window starts at output row offs[b]
                    // (clamped to [0, max_off = 2 rad])
  int y_pitch;      // output rows per element: y_len, or (PLACED) y_len +
                    // max_off
};

// The A operand's tensor maps: one, or (K6) one per window offset.
constexpr int kMaxViews = 9;     // 2 rad + 1 for rad <= 4 (a view's
                                 // index fits 4 bits)
template <int NV>
struct AViews {
  CUtensorMap m[NV];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spins until the phase of the given parity has completed. A wait of more
// than 10 s (a load that never lands) traps: the launch fails with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000ull) {
      asm volatile("trap;");
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x N] += A[64 x 16] (K-major) * B[16 x N] (MN-major: transpose bit
// set), bf16 in, f32 accumulators; scale-d = 1.
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_m64n128(d, da, db);
  else wgmma_m64n64(d, da, db);
}

template <int NWG, int BN, int NV, bool PLACED>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
igemm_kernel(const __grid_constant__ AViews<NV> a_views,
             const __grid_constant__ CUtensorMap b_map,
             const __grid_constant__ KSteps ks, const Plan g,
             const __nv_bfloat16* __restrict__ bias,
             __nv_bfloat16* __restrict__ y) {
  constexpr int BM = 64 * NWG;
  constexpr int A_BYTES = BM * 128;          // [BM rows][64 channels]
  constexpr int B_BYTES = BN * 128;          // [BN / 64][64 Cin][64 Cout]
  constexpr int STAGE = A_BYTES + B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * STAGE;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s)

  // M block mb: grid y, continued in grid z past y's 65535 blocks
  // (launch_tile); the few blocks past n_m exit before any barrier
  const int mb = blockIdx.y + gridDim.y * blockIdx.z;
  if (mb >= g.n_m) return;
  const int ot = blockIdx.x % g.n_ot, phase = blockIdx.x / g.n_ot;
  const int o0 = ot * BN;
  int b0, t0;
  if (g.nb > 1) {
    b0 = mb * g.nb;
    t0 = 0;
  } else {
    b0 = mb / g.n_mt;
    t0 = (mb % g.n_mt) * BM;
  }
  const int k0 = ks.start[phase];
  const int n_iter = (ks.start[phase + 1] - k0) * g.n_chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // the producer: one thread keeps the ring's TMA loads in flight
    if (lane == 0) {
      // one view: one box of nb elements; per-element views: a box per
      // element of the batch (elements past it are not loaded: their rows
      // feed only outputs the epilogue masks)
      const int n_el = NV == 1 ? g.nb : min(g.nb, g.batch - b0);
      const uint32_t bytes = g.rows * n_el * 128 + B_BYTES;
      // element seg's view in bits [4 seg, 4 seg + 4): read once, and the
      // views' descriptors fetched ahead of the first loads
      uint64_t views = 0;
      if constexpr (NV > 1) {
        for (int seg = 0; seg < n_el; ++seg)
          views |= (uint64_t)min(max(__ldg(g.offs + b0 + seg), 0), g.max_off)
                   << (4 * seg);
        for (int v = 0; v <= g.max_off; ++v)
          asm volatile("prefetch.tensormap [%0];" ::"l"(
                           reinterpret_cast<uint64_t>(&a_views.m[v]))
                       : "memory");
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        mbar_wait(bars + 8 * (kStages + st), ((it / kStages) & 1) ^ 1);
        const int e = k0 + it / g.n_chunks;
        const int c0 = (it % g.n_chunks) * kChunk;
        const uint32_t sa = base + st * STAGE, sb = sa + A_BYTES;
        const uint32_t full = bars + 8 * st;
        mbar_expect_tx(full, bytes);
        if constexpr (NV == 1) {
          tma_load_4d(sa, &a_views.m[0], full, c0, ks.pin[e],
                      t0 + ks.row[e], b0);
        } else {
          for (int seg = 0; seg < n_el; ++seg)
            tma_load_4d(sa + seg * g.rows * 128,
                        &a_views.m[(views >> (4 * seg)) & 15], full, c0,
                        ks.pin[e], t0 + ks.row[e], b0 + seg);
        }
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_load_3d(sb + h * 8192, &b_map, full, o0 + h * 64, c0,
                      ks.tap[e]);
      }
    }
    return;
  }

  if constexpr (PLACED) {
    // the rows outside each window, as zeros: the block of phase 0 and
    // m-tile 0 (t0 == 0 in every stacked tile), for each element it holds
    // and its own BN columns; 16-byte stores (cout % 8 == 0)
    if (phase == 0 && t0 == 0) {
      const int n_el = min(g.nb, g.batch - b0);
      const int total = n_el * g.max_off * (BN / 8);
      for (int e = threadIdx.x; e < total; e += NWG * 128) {
        const int o = o0 + 8 * (e % (BN / 8));
        const int zr = (e / (BN / 8)) % g.max_off;
        const int b = b0 + e / ((BN / 8) * g.max_off);
        if (o >= g.cout) continue;
        const int off = min(max(__ldg(g.offs + b), 0), g.max_off);
        const int row = zr < off ? zr : g.y_len + zr;
        *reinterpret_cast<uint4*>(y + ((size_t)b * g.y_pitch + row) * g.cout +
                                  o) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // the consumers: warpgroup wg multiplies tile rows [64 wg, 64 wg + 64)
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    mbar_wait(bars + 8 * st, (it / kStages) & 1);
    const uint32_t sa = base + st * STAGE + wg * 8192;
    const uint32_t sb = base + st * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      // A: 32 bytes per 16 channels inside the swizzled row, 8-row groups
      // 1024 bytes apart; B: 16 Cin rows are two 1024-byte 8-row groups,
      // the 64-wide Cout halves 8192 bytes apart
      wgmma_tile<BN>(acc, sw128_desc(sa + kk * 32, 16, 1024),
                     sw128_desc(sb + kk * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    // the group of iteration it - 1 has retired: its stage is free
    if (it > 0 && lane == 0)
      mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));
  }
  wgmma_wait<0>();

  // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
  // 16 w + l/4 (+ 8) and columns 8 c + 2 (l % 4) (+ 1)
  const int r_base = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col = o0 + (lane % 4) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_base + 8 * h;
    const int seg = r / g.rows;
    const int b = b0 + seg, t = t0 + r - seg * g.rows;
    const int yr = t * g.s_out + phase;
    if (seg >= g.nb || b >= g.batch || t >= g.t_lim || yr >= g.y_len)
      continue;
    if constexpr (PLACED) {
      const int off = min(max(__ldg(g.offs + b), 0), g.max_off);
      __nv_bfloat16* yrow = y + ((size_t)b * g.y_pitch + yr + off) * g.cout;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int o = col + 8 * c;
        if (o >= g.cout) continue;
        *reinterpret_cast<__nv_bfloat162*>(yrow + o) = __floats2bfloat162_rn(
            acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      }
    } else {
      __nv_bfloat16* yrow = y + ((size_t)b * g.y_len + yr) * g.cout;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int o = col + 8 * c;
        if (o >= g.cout) continue;
        const float v0 = rowconv::apply_act(
            acc[4 * c + 2 * h] + __bfloat162float(bias[o]), g.act, g.slope);
        const float v1 = rowconv::apply_act(
            acc[4 * c + 2 * h + 1] + __bfloat162float(bias[o + 1]), g.act,
            g.slope);
        *reinterpret_cast<__nv_bfloat162*>(yrow + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function) looked up through the CUDA
// runtime, so the library links no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map over dims (innermost first) with byte strides of the
// outer dims, zero fill out of bounds, 128-byte swizzle. Encoded on the
// host at every call with the operand's address and passed by value: a
// CUDA graph capture (train/step_graph.py) freezes it into the kernel
// node's parameters, which is right only because a graph's addresses are
// fixed.
inline bool encode(CUtensorMap* map, const void* ptr, int rank,
                   const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The A operand as launch_tile encodes it: x viewed as [batch, a_rows,
// a_phases, cin] with elements batch_pitch rows of cin apart; n_views
// views whose bases step view_step rows (K6: xp's window offsets).
struct AView {
  const void* x;
  int a_rows, a_phases;
  long long batch_pitch;
  int n_views, view_step;
};

template <int NWG, int BN, int NV, bool PLACED>
cudaError_t launch_tile(const AView& av, const void* w, int k,
                        const void* bias, void* y, Plan g, const KSteps& ks,
                        cudaStream_t stream) {
  constexpr int BM = 64 * NWG;
  constexpr int STAGE = BM * 128 + BN * 128;
  if (g.rows < 1 || g.nb < 1 || g.rows > 256 || g.nb > 256 ||
      g.rows * g.nb > BM || (g.nb > 1 && g.rows != g.t_lim) ||
      av.n_views < 1 || av.n_views > NV ||
      (NV > 1 && ((g.nb > 1 && g.rows % 8) || g.nb > 16)))
    return cudaErrorInvalidValue;
  g.n_ot = (g.cout + BN - 1) / BN;
  g.n_chunks = (g.cin + kChunk - 1) / kChunk;
  const long long n_m = g.nb > 1 ? (g.batch + g.nb - 1) / g.nb
                                 : (long long)g.batch * g.n_mt;
  // the M blocks over grid y (at most 65535) and, beyond it, grid z: nz
  // rows of ny blocks, ny * nz - n_m < nz of them past the end. Up to
  // 65535 M blocks the grid is [x, n_m, 1], as before the split.
  const long long nz = (n_m + 65534) / 65535;
  const long long ny = (n_m + nz - 1) / nz;
  if (n_m > 0x7fffffffLL || nz > 65535 ||
      (long long)g.n_ot * g.n_phase > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  g.n_m = (int)n_m;
  AViews<NV> a_views = {};
  CUtensorMap b_map;
  const cuuint64_t cin = g.cin;
  const cuuint64_t a_dims[4] = {cin, (cuuint64_t)av.a_phases,
                                (cuuint64_t)av.a_rows, (cuuint64_t)g.batch};
  const cuuint64_t a_strides[3] = {2 * cin, 2 * cin * av.a_phases,
                                   2 * cin * (cuuint64_t)av.batch_pitch};
  // per-element views load one element per box
  const cuuint32_t a_box[4] = {kChunk, 1, (cuuint32_t)g.rows,
                               NV == 1 ? (cuuint32_t)g.nb : 1u};
  for (int v = 0; v < av.n_views; ++v)
    if (!encode(&a_views.m[v],
                static_cast<const char*>(av.x) + 2 * cin * av.view_step * v,
                4, a_dims, a_strides, a_box))
      return cudaErrorInvalidValue;
  const cuuint64_t b_dims[3] = {(cuuint64_t)g.cout, cin, (cuuint64_t)k};
  const cuuint64_t b_strides[2] = {2 * (cuuint64_t)g.cout,
                                   2 * cin * g.cout};
  const cuuint32_t b_box[3] = {64, kChunk, 1};
  if (!encode(&b_map, w, 3, b_dims, b_strides, b_box))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)kStages * STAGE + 1024 + 16 * kStages;
  auto kern = igemm_kernel<NWG, BN, NV, PLACED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(g.n_ot * g.n_phase, (unsigned)ny, (unsigned)nz);
  kern<<<grid, NWG * 128 + 32, smem, stream>>>(
      a_views, b_map, ks, g, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y));
  return cudaGetLastError();
}

// Decodes kernels/conv.py::tc_plan's int32 array (tile, rows, nb, n_mt,
// t_lim, s_out, y_len, n_phase, n_steps, start[n_phase + 1], tap[n_steps],
// row[n_steps], pin[n_steps]; PLACED: then y_pitch, kernels/sconv.py::
// sconvt1d_tc_plan) and launches its tile with NV views.
template <int NV, bool PLACED = false>
cudaError_t launch_plan(const AView& av, int batch, int cin, const void* w,
                        int k, int cout, const void* bias, void* y,
                        const int* plan, int act, float slope,
                        const int* offs, int max_off, cudaStream_t stream) {
  if (((uintptr_t)av.x | (uintptr_t)w | (uintptr_t)bias | (uintptr_t)y) & 15)
    return cudaErrorMisalignedAddress;
  if (batch <= 0 || av.a_rows <= 0 || av.a_phases <= 0 || cin < 8 ||
      cin % 8 || cout < 8 || cout % 8 || k <= 0 || act < rowconv::ACT_NONE ||
      act > rowconv::ACT_TANH)
    return cudaErrorInvalidValue;
  Plan g;
  KSteps ks;
  g.batch = batch; g.cin = cin; g.cout = cout; g.act = act; g.slope = slope;
  g.offs = offs; g.max_off = max_off;
  const int tile = plan[0];
  g.rows = plan[1]; g.nb = plan[2]; g.n_mt = plan[3]; g.t_lim = plan[4];
  g.s_out = plan[5]; g.y_len = plan[6]; g.n_phase = plan[7];
  const int n = plan[8];
  if (g.n_phase < 1 || g.n_phase > kMaxPhases || n < 0 || n > kMaxSteps ||
      g.n_mt < 1 || g.t_lim < 1 || g.s_out < 1 || g.y_len < 1)
    return cudaErrorInvalidValue;
  const int* start = plan + kPlanHead;
  const int* tap = start + g.n_phase + 1;
  const int* row = tap + n;
  const int* pin = row + n;
  g.y_pitch = g.y_len;
  if constexpr (PLACED) {
    g.y_pitch = pin[n];
    if (offs == nullptr || bias != nullptr || act != rowconv::ACT_NONE ||
        max_off < 0 || g.y_pitch != g.y_len + max_off)
      return cudaErrorInvalidValue;
  }
  for (int p = 0; p <= g.n_phase; ++p) {
    ks.start[p] = start[p];
    if (start[p] < 0 || start[p] > n || (p > 0 && start[p] < start[p - 1]))
      return cudaErrorInvalidValue;
  }
  if (start[0] != 0 || start[g.n_phase] != n) return cudaErrorInvalidValue;
  for (int e = 0; e < n; ++e) {
    if (tap[e] < 0 || tap[e] >= k || pin[e] < 0 || pin[e] >= av.a_phases)
      return cudaErrorInvalidValue;
    ks.tap[e] = tap[e]; ks.row[e] = row[e]; ks.pin[e] = pin[e];
  }
  switch (tile) {
    case 0:
      return launch_tile<2, 128, NV, PLACED>(av, w, k, bias, y, g, ks, stream);
    case 1:
      return launch_tile<2, 64, NV, PLACED>(av, w, k, bias, y, g, ks, stream);
    case 2:
      return launch_tile<1, 128, NV, PLACED>(av, w, k, bias, y, g, ks, stream);
    case 3:
      return launch_tile<1, 64, NV, PLACED>(av, w, k, bias, y, g, ks, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core launch of conv1d.cu and convt1d.cu: x viewed as [batch,
// a_rows, a_phases, cin]. Pointers must be 16-byte aligned and cin, cout
// multiples of 8 (TMA's 16-byte strides).
inline cudaError_t launch(const void* x, int batch, int a_rows, int a_phases,
                          int cin, const void* w, int k, int cout,
                          const void* bias, void* y, const int* plan, int act,
                          float slope, cudaStream_t stream) {
  const AView av = {x, a_rows, a_phases, (long long)a_rows * a_phases, 1, 0};
  return launch_plan<1>(av, batch, cin, w, k, cout, bias, y, plan, act,
                        slope, nullptr, 0, stream);
}

// K6's tensor-core launch (sconv.cu): xp [batch, tp, cin], z = xp's window
// of t = tp - 2 rad rows at offs[b], viewed as [batch, t / s, s, cin]; one
// view per offset 0..2 rad (2 rad + 1 <= kMaxViews), plan conv1d's on z
// with stacked elements only where rows % 8 == 0.
inline cudaError_t launch_shifted(const void* xp, int batch, int tp, int rad,
                                  int stride, int cin, const void* w, int k,
                                  int cout, const void* bias,
                                  const int* offs, void* y, const int* plan,
                                  int act, float slope, cudaStream_t stream) {
  const int t = tp - 2 * rad;
  if (rad < 0 || t <= 0 || stride <= 0 || t % stride ||
      2 * rad + 1 > kMaxViews || offs == nullptr)
    return cudaErrorInvalidValue;
  const AView av = {xp, t / stride, stride, tp, 2 * rad + 1, 1};
  return launch_plan<kMaxViews>(av, batch, cin, w, k, cout, bias, y, plan,
                                act, slope, offs, 2 * rad, stream);
}

// K7's tensor-core launch (sconv.cu): convT of ct [batch, t_in, cin]
// (K1's view [B, T', 1, Cin]) with the placed epilogue: plan from
// kernels/sconv.py::sconvt1d_tc_plan (convT's, then y_pitch = y_len +
// 2 rad), y [batch, y_pitch, cout], offs [batch] clamped into [0, 2 rad].
inline cudaError_t launch_placed(const void* ct, int batch, int t_in,
                                 int cin, const void* w, int k, int cout,
                                 const int* offs, int rad, void* y,
                                 const int* plan, cudaStream_t stream) {
  if (rad < 0 || offs == nullptr) return cudaErrorInvalidValue;
  const AView av = {ct, t_in, 1, t_in, 1, 0};
  return launch_plan<1, true>(av, batch, cin, w, k, cout, nullptr, y, plan,
                              rowconv::ACT_NONE, 0.f, offs, 2 * rad, stream);
}

}  // namespace igemm
