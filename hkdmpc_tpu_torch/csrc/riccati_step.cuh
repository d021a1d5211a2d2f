// The part of the Riccati backward sweep that the two kernels share,
// riccati_hkd.cu (K1: Jacobians and cost partials rebuilt in-kernel, sparse
// Q expansion) and riccati_dense.cu (K2: materialized LQ data, dense Q
// expansion): the block layout, the producer/consumer ring primitives, the
// defect correction, the elimination with the PSD gate, the value update
// and the RESET sandwich. Each kernel computes its own Q expansion (Qxx,
// Qux, Quu, Qx, Qu) and hands it over in the shared working set `Work`.
//
// Block layout (one block per scenario, 128 threads):
//   - warps 0-2, 96 consumer threads: thread (r, cg) = (tid / 4, tid % 4)
//     owns the 1 x 6 tile [r][6 cg .. 6 cg + 5] of a 24 x 24 result (K2's
//     dense Q expansion gives each warp a whole product in 3 x 6 tiles
//     instead). In a product it keeps its sums in registers, loads its left
//     factor once per k and its row segment of the right factor as three
//     float2; row and column come from the thread index once. The consumers
//     meet at named barrier 1 (`consumer_sync`), which the producer warp
//     never joins;
//   - warp 3, the producer: fills a ring of stages in shared memory with
//     the next steps' data while the consumers run the current step (K1: the
//     entry formulas; K2: bulk asynchronous copies), and writes the zero
//     rows of K and dU for PAD and RESET steps. A stage is handed over with a
//     pair of mbarriers (`full`, `empty`); both sides derive stage and phase
//     parity from a running count of ring items, never from t, so steps
//     that skip the ring (PAD) and ring depths that do not divide the step
//     count need no special case.
//
// The elimination runs in warp 0 alone, on registers, without block
// barriers (`eliminate`): Gauss-Jordan by columns, two pivots a round.
// Without row exchanges its pivots are those of Gaussian elimination, the D
// of Quu's LDL' factorization, so the PSD gate (every pivot > 1e-9) keeps its
// meaning; the solution differs from Gaussian elimination's in rounding
// only. Rows of 28 floats (LDP) keep every row of a tile 16-byte aligned and
// put the eight rows a warp touches in one access on distinct banks.
//
// What a step costs is latency more than work (measured on an NVIDIA H100
// 80GB HBM3 at 700 W, K1): one block alone on an SM takes about 8k cycles
// per DYN step, half of them in the elimination's chain of 12
// publish-and-reduce rounds, and four resident blocks (128 registers a
// thread) overlap to about 2.6 times one block's rate. The products'
// loops are unrolled by 4, not fully, and the elimination is one loop body
// for all rounds: fully unrolled, a step is more straight-line code than
// the SM's code cache holds, and the warps wait for their code.
//
// No tensor cores and no TF32: the port's precision policy
// (ops/precise.pin_full_f32) holds the f32 solve to the f64 oracle at 1e-4
// and TF32 keeps about three digits. The f32 FMA peak of the H100
// (67 TFLOP/s) already puts the arithmetic bound of a B = 4096, T = 75 sweep
// below 1 ms.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace riccati {

constexpr int NX = 24;            // state and control width
constexpr int TC = 6;             // columns of a consumer thread's tile
constexpr int NCONS = 96;         // consumer threads: 24 rows x 4 tiles
constexpr int NTHREADS = 128;     // consumers + the producer warp
constexpr int PRODUCER_WARP = 3;
constexpr int LDP = 28;           // padded row of a 24-wide tile
constexpr int NW = 49;            // tableau columns: 24 Quu | 24 Qux | 1 Qu
constexpr int LDW = 52;           // padded tableau row
constexpr int KIND_DYN = 1;
constexpr int KIND_RESET = 2;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The consumers' working set of one step.
struct __align__(16) Work {
  float H[NX][LDP];     // value Hessian carry
  float HA[NX][LDP];    // H A; later the unsymmetrized new H
  float HB[NX][LDP];    // H B
  float Qxx[NX][LDP];   // before symmetrization
  float Qux[NX][NX];
  float W[NX][LDW];     // elimination tableau [Quu | Qux | Qu]
  float Sol[NX][LDP];   // Quu^-1 [Qux | Qu] (25 columns)
  float piv[2][2 * NX]; // the elimination's two pivot columns, double-buffered
  float G[NX], Gn[NX], Qx[NX], Qu[NX];
};

// ---------------------------------------------------------------------------
// ring primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrive and announce `bytes` of asynchronous copies on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk asynchronous copy, device memory -> shared memory, completion
// counted in bytes on `bar`. dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders the consumers' generic-proxy reads of a stage (observed through the
// empty barrier) before the async-proxy copy that refills it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of the 96 consumer threads
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
}

// stage and parity of ring item `item` in a ring of `depth` stages; the
// consumer waits `full` with parity(), the producer `empty` with parity()^1
struct RingPos {
  int stage;
  uint32_t parity;
  __device__ RingPos(int item, int depth)
      : stage(item % depth), parity((item / depth) & 1) {}
};

// ---------------------------------------------------------------------------
// tile helpers (8-byte aligned row segments of TC floats)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ld6(const float* p, float v[TC]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 2);
  const float2 c = *reinterpret_cast<const float2*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y; v[4] = c.x; v[5] = c.y;
}

__device__ __forceinline__ void st6(float* p, const float v[TC]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  *reinterpret_cast<float2*>(p + 2) = make_float2(v[2], v[3]);
  *reinterpret_cast<float2*>(p + 4) = make_float2(v[4], v[5]);
}

// acc += a * v
__device__ __forceinline__ void fma6(float acc[TC], float a,
                                     const float v[TC]) {
#pragma unroll
  for (int j = 0; j < TC; ++j) acc[j] = fmaf(a, v[j], acc[j]);
}

// 1 / x by the special-function unit alone (an error of about 1 ulp),
// where the rounded reciprocal is a dependent chain a dozen long
__device__ __forceinline__ float fast_rcp(float x) {
  return __fdividef(1.f, x);
}

// sum of p over the four threads of a row (lanes 4q .. 4q+3)
__device__ __forceinline__ float row_sum(float p) {
  p += __shfl_xor_sync(FULL_MASK, p, 1);
  p += __shfl_xor_sync(FULL_MASK, p, 2);
  return p;
}

// n floats of zeros (n a multiple of 4, p 16-byte aligned) by one warp
__device__ __forceinline__ void warp_zero(float* p, int n, int lane) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = lane; e < n / 4; e += 32) reinterpret_cast<float4*>(p)[e] = z;
}

// The producer warp's share of a step that is not DYN: K[b, t] and dU[b, t]
// are zero.
__device__ __forceinline__ void zero_gain_rows(float* K_bt, float* dU_bt,
                                               int lane) {
  warp_zero(K_bt, NX * NX, lane);
  warp_zero(dU_bt, NX, lane);
}

// ---------------------------------------------------------------------------
// the shared step
// ---------------------------------------------------------------------------

// Gn = G + H dnext (the defect correction of the dest node,
// SinglePhase.cpp:319-321). Expects s.G, s.H synchronized; does not
// synchronize after.
__device__ __forceinline__ void defect_correction(Work& s, const float* dnext,
                                                  int r, int cg, int c0) {
  float h[TC], d[TC];
  ld6(&s.H[r][c0], h);
  ld6(dnext + c0, d);
  float p = 0.f;
#pragma unroll
  for (int j = 0; j < TC; ++j) p = fmaf(h[j], d[j], p);
  p = row_sum(p);
  if (cg == 0) s.Gn[r] = s.G[r] + p;
}

// Warp 0: Gauss-Jordan elimination of the tableau s.W = [Quu | Qux | Qu]
// by columns, two pivots a round, the PSD gate folded into okb (uniform over
// the warp), and Sol = Quu^-1 [Qux | Qu] into s.Sol.
//
// Lane c holds columns c and c + 32 of the tableau, 24 rows each, in
// registers. In round k / 2 the lanes that hold columns k and k + 1 publish
// them through shared memory (16-byte stores, broadcast loads: a quarter of
// the shared-memory traffic of shuffling pivot rows). Every lane then takes
// its columns through both pivots at once: with (y0, y1) the two normalized
// pivot rows (pivot k, then pivot k + 1 on what pivot k left of column
// k + 1), every other row is x_i - c1_i y0 - c2_i y1 on the published
// columns as they stand, which is what pivot k followed by pivot k + 1
// gives. That is 12 rounds of publish-and-wait instead of 24, and the chain
// of dependent latencies is what a lone warp's elimination costs. The pivots
// d1, d2 are those of elimination without row exchanges, so the gate "every
// pivot > 1e-9" keeps its meaning. The rows move up two registers a round,
// the pivot rows re-entering at the bottom, so the pivot rows are always
// registers 0 and 1 and the loop body is one piece of code for all rounds
// (a fully unrolled elimination is 45 KB of straight-line code, more than
// the SM's code cache holds beside the products); after 12 rounds every
// row is back in its place and holds the solution.
__device__ __forceinline__ void eliminate(Work& s, int lane, bool& okb) {
  float a[NX], b[NX];
  const bool has_b = lane + 32 < NW;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    a[i] = s.W[i][lane];
    b[i] = has_b ? s.W[i][lane + 32] : 0.f;
  }
  // the lanes that hold pivot columns k and k + 1 publish them (rows as
  // they stand: the pivot rows are registers 0 and 1)
  auto publish = [&](int k) {
    if (lane == k || lane == k + 1) {
      float4* dst =
          reinterpret_cast<float4*>(s.piv[(k >> 1) & 1] + (lane - k) * NX);
#pragma unroll
      for (int q = 0; q < NX / 4; ++q)
        dst[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2],
                             a[4 * q + 3]);
    }
  };
  publish(0);
#pragma unroll 1
  for (int k = 0; k < NX; k += 2) {
    const float* cols = s.piv[(k >> 1) & 1];
    __syncwarp();
    float c1[NX], c2[NX];
#pragma unroll
    for (int q = 0; q < NX / 4; ++q) {
      const float4 u = reinterpret_cast<const float4*>(cols)[q];
      const float4 v = reinterpret_cast<const float4*>(cols + NX)[q];
      c1[4 * q] = u.x; c1[4 * q + 1] = u.y; c1[4 * q + 2] = u.z;
      c1[4 * q + 3] = u.w;
      c2[4 * q] = v.x; c2[4 * q + 1] = v.y; c2[4 * q + 2] = v.z;
      c2[4 * q + 3] = v.w;
    }
    // pivot k, then pivot k + 1 on the column pivot k left behind: d1, and
    // d2 = c2[1] - c1[1] c2[0] / d1 = det / d1. Both reciprocals start at
    // once (1 / d2 = d1 / det), so one reciprocal's latency is on the chain.
    const float d1 = c1[0];
    const float det = fmaf(d1, c2[1], -(c1[1] * c2[0]));
    const float inv1 = fast_rcp(fabsf(d1) > 1e-30f ? d1 : 1.f);
    const float inv2 = d1 * fast_rcp(fabsf(det) > 1e-30f ? det : 1.f);
    const float q = c2[0] * inv1;              // row 0 of column k + 1
    okb = okb && (d1 > 1e-9f) && (fmaf(-c1[1], q, c2[1]) > 1e-9f);
    // the two normalized pivot rows (y0, y1) of a column; every other row
    // takes both pivots and moves up two registers. The first 32 columns go
    // first, so that the next round's pivot columns are on their way
    // through shared memory while the other columns are reduced.
    float y0 = a[0] * inv1;
    float y1 = fmaf(-c1[1], y0, a[1]) * inv2;
    y0 = fmaf(-q, y1, y0);
#pragma unroll
    for (int i = 2; i < NX; ++i)
      a[i - 2] = fmaf(-c2[i], y1, fmaf(-c1[i], y0, a[i]));
    a[NX - 2] = y0;
    a[NX - 1] = y1;
    if (k + 2 < NX) publish(k + 2);
    y0 = b[0] * inv1;
    y1 = fmaf(-c1[1], y0, b[1]) * inv2;
    y0 = fmaf(-q, y1, y0);
#pragma unroll
    for (int i = 2; i < NX; ++i)
      b[i - 2] = fmaf(-c2[i], y1, fmaf(-c1[i], y0, b[i]));
    b[NX - 2] = y0;
    b[NX - 1] = y1;
  }
  // columns 24 .. 48 are Sol's columns 0 .. 24
  if (lane >= NX) {
#pragma unroll
    for (int i = 0; i < NX; ++i) s.Sol[i][lane - NX] = a[i];
  }
  if (has_b) {
#pragma unroll
    for (int i = 0; i < NX; ++i) s.Sol[i][lane + 32 - NX] = b[i];
  }
}

// The DYN step from the Q expansion on. Expects the kernel's Q expansion in
// s.Qxx (lxx + A'HA + reg I, not symmetrized), s.Qux, s.Qx, s.Qu and the
// tableau s.W = [Quu | Qux | Qu], followed by a consumer_sync. Computes
// K = -Quu^-1 Qux and dU = -Quu^-1 Qu into K_bt / dU_bt, the value update
// H = sym(sym(Qxx) - Qux' S), G = Qx - Qux' s, and dv = Qu' s into thread 0's
// dv1 / dv2; warp 0 runs the elimination and folds the PSD gate into its
// okb. Leaves s.G, s.H synchronized.
__device__ __forceinline__ void solve_and_update(Work& s, int tid, int r,
                                                 int cg, int c0, float* K_bt,
                                                 float* dU_bt, float& dv1,
                                                 float& dv2, bool& okb) {
  if (tid < 32) eliminate(s, tid, okb);
  consumer_sync();

  float acc[TC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float v[TC];
#pragma unroll 4
  for (int k = 0; k < NX; ++k) {
    ld6(&s.Sol[k][c0], v);
    fma6(acc, s.Qux[k][r], v);
  }
  float hn[TC], gain[TC];
  ld6(&s.Qxx[r][c0], v);
#pragma unroll
  for (int j = 0; j < TC; ++j)
    hn[j] = 0.5f * (v[j] + s.Qxx[c0 + j][r]) - acc[j];
  st6(&s.HA[r][c0], hn);
  ld6(&s.Sol[r][c0], v);
#pragma unroll
  for (int j = 0; j < TC; ++j) gain[j] = -v[j];
  st6(K_bt + r * NX + c0, gain);
  {
    // G = Qx - Qux' s and dv = Qu' s: each of the row's four threads takes
    // six terms
    float a = 0.f, dv = 0.f;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float sk = s.Sol[c0 + j][NX];
      a = fmaf(s.Qux[c0 + j][r], sk, a);
      dv = fmaf(s.Qu[c0 + j], sk, dv);
    }
    a = row_sum(a);
    dv = row_sum(dv);
    if (cg == 0) {
      s.G[r] = s.Qx[r] - a;
      dU_bt[r] = -s.Sol[r][NX];
    }
    if (tid == 0) {
      dv1 -= dv;
      dv2 += dv;
    }
  }
  consumer_sync();
#pragma unroll
  for (int j = 0; j < TC; ++j)
    hn[j] = 0.5f * (s.HA[r][c0 + j] + s.HA[c0 + j][r]);
  st6(&s.H[r][c0], hn);
  consumer_sync();
}

// RESET transition (impact-aware sandwich plus the terminal seed of the
// source node): G = phix + Px' Gn, H = phixx + Px' H Px, from the dense
// 24 x 24 tiles Px and phixx (rows of 24 floats) and the vectors phix and
// dnext of a ring stage. Expects s.G, s.H synchronized. Every consumer
// thread arrives on `stage_empty` after its last read of the stage. Leaves
// s.G, s.H synchronized.
__device__ __forceinline__ void reset_step(Work& s, const float* Px,
                                           const float* phixx,
                                           const float* phix,
                                           const float* dnext,
                                           uint64_t* stage_empty, int r,
                                           int cg, int c0) {
  defect_correction(s, dnext, r, cg, c0);
  float ha[TC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float v[TC];
#pragma unroll 4
  for (int k = 0; k < NX; ++k) {
    ld6(Px + k * NX + c0, v);
    fma6(ha, s.H[r][k], v);
  }
  st6(&s.HA[r][c0], ha);
  consumer_sync();
  float hn[TC];
  ld6(phixx + r * NX + c0, hn);
#pragma unroll 4
  for (int k = 0; k < NX; ++k) {
    ld6(&s.HA[k][c0], v);
    fma6(hn, Px[k * NX + r], v);
  }
  float g = 0.f;
#pragma unroll
  for (int j = 0; j < TC; ++j)
    g = fmaf(Px[(c0 + j) * NX + r], s.Gn[c0 + j], g);
  g = row_sum(g);
  st6(&s.H[r][c0], hn);
  if (cg == 0) s.G[r] = phix[r] + g;
  mbar_arrive(stage_empty);
  consumer_sync();
}

}  // namespace riccati
