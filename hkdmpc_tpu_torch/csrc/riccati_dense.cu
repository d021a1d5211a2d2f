// Riccati backward sweep of one HS-DDP iteration for a batch of scenarios,
// from materialized LQ data (A, B and every cost partial in device memory).
//
// Replaces hkdmpc_tpu/ops/pallas_backward.py:_kernel, the TPU kernel behind
// backward_sweep_pallas (reached through solver/backward.py:riccati_backward
// under vmap). Wrapper, plain PyTorch version and launch counter:
// hkdmpc_tpu_torch/ops/riccati_dense.py.
//
// A retry of the regularization loop (solver/backward.py, a fixed number of
// sweeps inside a CUDA graph) passes `active` (B bytes): the block of a
// scenario that is done returns before its first load and writes nothing,
// so the first sweep's outputs stay; a retry then costs a launch (about
// 0.06 ms at B = 4096 on the H100) where no scenario needs it.
//
// What it computes, per scenario, with the value carry (G 24, H 24x24) held
// in shared memory:
//   - seed G/H with the terminal partials phix/phixx of the scenario's last
//     active node;
//   - for t = T-1 .. 0: Gn = G + H * defect[t+1], then
//     DYN: Q expansion from A[t], B[t], lxx[t], luu[t], lx[t], lu[t] with
//     the per-scenario reg on the Qxx and Quu diagonals, elimination with
//     the PSD gate pivot > 1e-9 on [Quu | Qux | Qu], K = -Quu^-1 Qux,
//     dU = -Quu^-1 Qu, and the value update H = sym(Qxx - Qux' S),
//     G = Qx - Qux' s, dv = Qu' s;
//     RESET (A holds Px): G = phix[t] + Px' Gn, H = phixx[t] + Px' H Px;
//     PAD: the value carries through, K and dU are zero.
// There is no lux input (the JAX package's array interface drops it). The
// PSD gate can flip at the ulp level against another elimination order, so
// `ok` is compared on a share of scenarios, not bit for bit.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at B = 4096, T = 75 (60 DYN, 4 RESET, 11 PAD): every DYN step
// reads four 24 x 24 tiles and three vectors, 9.5 KB per scenario, and
// writes K[b, t]; with the RESET tiles, the seed and the K and dU rows the
// sweep moves 3.16 GB, 0.94 ms of memory time. Its dense products (210k
// flop a DYN step with the elimination and the value update) are
// 52.6 GFLOP, 0.78 ms. Bytes bound it. (ops/riccati_bound.py computes both
// from the shapes; chip_smoke.py prints them beside the measured time.)
//
// What the design does about it (block layout, register tiles and the
// elimination: riccati_step.cuh):
//   - one 128-thread block per scenario. In the Q expansion each of the
//     three consumer warps owns one whole product in 3 x 6 register tiles
//     (H A, H B, then A'HA, B'HA, B'HB): six shared loads for 18
//     multiply-adds per k, a third of a shared word per multiply-add where
//     a 1 x 6 tile of every product in every thread reads a whole word
//     (measured on an NVIDIA H100 80GB HBM3 at 700 W, B = 4096: 11% off
//     the sweep). The elimination runs in one warp on registers, with no
//     block barrier inside it;
//   - the step's tiles never wait in the serial chain: one thread of the
//     producer warp starts 1-D bulk asynchronous copies
//     (cp.async.bulk ... mbarrier::complete_tx::bytes, no tensor map) for
//     the next ring item's A, B, lxx, luu, lx, lu and defect while the
//     consumers run the current step, and the consumers wait on the stage's
//     `full` mbarrier (measured on the same card: under 2% of a block's
//     cycles). Each tile is 2,304 contiguous bytes from a 16-byte-aligned
//     base (the wrapper checks it). PAD steps take no ring item; RESET
//     steps load Px and phixx the same way;
//   - the producer warp also writes the zero rows of K and dU, off the
//     chain; K's DYN rows leave as 8-byte stores that fill whole 96-byte
//     rows.
// What is left: the shared-memory pipe, not the FMA pipe or device memory,
// is what four resident blocks (128 registers a thread) saturate, and the
// elimination's chain of 12 rounds is 40% of a block's cycles.
// No tensor cores, no TF32 (riccati_step.cuh says why).

#include <cuda_runtime.h>

#include "riccati_step.cuh"

namespace {

using namespace riccati;

constexpr int NSTAGE = 2;
constexpr uint32_t TILE_BYTES = NX * NX * sizeof(float);
constexpr uint32_t VEC_BYTES = NX * sizeof(float);

// One ring item. DYN: A[t], B[t], lxx[t], luu[t], lx[t], lu[t];
// RESET: Px in A, phixx[t] in C, phix[t] in lx. Both: defect[t+1].
struct __align__(16) Stage {
  float A[NX * NX];
  float B[NX * NX];
  float C[NX * NX];
  float Luu[NX * NX];
  float lx[NX], lu[NX], dnext[NX];
};

struct __align__(16) Smem {
  Work w;
  Stage ring[NSTAGE];
  uint64_t full[NSTAGE];
  uint64_t empty[NSTAGE];
};

// acc[i][:] += sum_k left(k, i) * right[k][c0 .. c0 + 5], i < 3: a 3 x 6
// register tile of a 24-deep product, six shared loads for 18 multiply-adds
// per k. `right` has rows of `ld` floats; left(k, i) is the tile's i-th row
// entry of the left factor at depth k.
template <class Left>
__device__ __forceinline__ void tile_product(float acc[3][TC],
                                             const float* right, int ld,
                                             int c0, Left left) {
  float v[TC];
#pragma unroll 4
  for (int k = 0; k < NX; ++k) {
    ld6(right + k * ld + c0, v);
#pragma unroll
    for (int i = 0; i < 3; ++i) fma6(acc[i], left(k, i), v);
  }
}

// DYN: the dense Q expansion into the working set, then the shared step.
// In the expansion each consumer warp owns one whole product, thread
// (rg, cg) = (lane / 4, lane % 4) its 3 x 6 tile [3 rg .. 3 rg + 2][6 cg ..]:
// H A and H B in warps 0 and 1, then A'(HA), B'(HA), B'(HB) in warps 0, 1, 2.
// A 1 x 6 tile of every product in every thread reads about one shared word
// per multiply-add, and the shared-memory pipe is what the resident blocks
// saturate; the 3 x 6 tiles read a third of a word.
__device__ __forceinline__ void dyn_step(Work& w, const Stage& st,
                                         uint64_t* stage_empty, float reg_b,
                                         int tid, int r, int cg, int c0,
                                         float* K_bt, float* dU_bt,
                                         float& dv1, float& dv2, bool& okb) {
  const int warp = tid >> 5, r0 = 3 * ((tid & 31) >> 2);
  defect_correction(w, st.dnext, r, cg, c0);
  if (warp < 2) {
    float acc[3][TC] = {};
    tile_product(acc, warp == 0 ? st.A : st.B, NX, c0,
                 [&](int k, int i) { return w.H[r0 + i][k]; });
    float(*out)[LDP] = warp == 0 ? w.HA : w.HB;
#pragma unroll
    for (int i = 0; i < 3; ++i) st6(&out[r0 + i][c0], acc[i]);
  }
  consumer_sync();
  {
    const float* left = warp == 0 ? st.A : st.B;
    float acc[3][TC] = {};
    tile_product(acc, warp == 2 ? &w.HB[0][0] : &w.HA[0][0], LDP, c0,
                 [&](int k, int i) { return left[k * NX + r0 + i]; });
    // A'HA, B'HB are added to lxx, luu apart, as the plain version adds them
    const float* cost = warp == 0 ? st.C : st.Luu;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int row = r0 + i;
      if (warp == 1) {
        st6(&w.Qux[row][c0], acc[i]);
        st6(&w.W[row][NX + c0], acc[i]);
      } else {
        float q[TC];
        ld6(cost + row * NX + c0, q);
#pragma unroll
        for (int j = 0; j < TC; ++j)
          q[j] = (q[j] + acc[i][j]) + (row == c0 + j ? reg_b : 0.f);
        st6(warp == 0 ? &w.Qxx[row][c0] : &w.W[row][c0], q);
      }
    }
  }
  float ag = 0.f, bg = 0.f;
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const float gn = w.Gn[c0 + j];
    ag = fmaf(st.A[(c0 + j) * NX + r], gn, ag);
    bg = fmaf(st.B[(c0 + j) * NX + r], gn, bg);
  }
  ag = row_sum(ag);
  bg = row_sum(bg);
  if (cg == 0) {
    const float qu = st.lu[r] + bg;
    w.Qx[r] = st.lx[r] + ag;
    w.Qu[r] = qu;
    w.W[r][2 * NX] = qu;
  }
  mbar_arrive(stage_empty);   // the last read of the stage is behind us
  consumer_sync();
  solve_and_update(w, tid, r, cg, c0, K_bt, dU_bt, dv1, dv2, okb);
}

__global__ void __launch_bounds__(NTHREADS, 4)
riccati_dense_kernel(const int* __restrict__ kind,
                     const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ lxx,
                     const float* __restrict__ luu,
                     const float* __restrict__ lx,
                     const float* __restrict__ lu,
                     const float* __restrict__ defect,
                     const float* __restrict__ phix,
                     const float* __restrict__ phixx,
                     const float* __restrict__ reg,
                     const int* __restrict__ last_node,
                     const unsigned char* __restrict__ active,
                     float* __restrict__ dU, float* __restrict__ K,
                     float* __restrict__ dv1_out, float* __restrict__ dv2_out,
                     unsigned char* __restrict__ ok_out, int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  // a retry sweep: a scenario that is done returns before its first load
  // and writes nothing (its outputs stay those of an earlier sweep)
  if (active != nullptr && !active[b]) return;
  const size_t Tn = (size_t)T + 1;
  constexpr size_t M = NX * NX;

  const int* kind_b = kind + b * T;
  const float* def_b = defect + b * Tn * NX;
  const float* phix_b = phix + b * Tn * NX;
  const float* phixx_b = phixx + b * Tn * M;

  if (tid == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(&s.full[i], 1);        // the producer's arrive + the bytes
      mbar_init(&s.empty[i], NCONS);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= PRODUCER_WARP * 32) {
    // ---- producer warp: bulk copies one ring item ahead, zero rows ----
    const int lane = tid - PRODUCER_WARP * 32;
    int item = 0;
    for (int t = T - 1; t >= 0; --t) {
      const int kd = kind_b[t];
      const size_t bt = b * T + t;
      if (kd == KIND_DYN || kd == KIND_RESET) {
        if (lane == 0) {
          const RingPos pos(item, NSTAGE);
          Stage& st = s.ring[pos.stage];
          uint64_t* full = &s.full[pos.stage];
          mbar_wait(&s.empty[pos.stage], pos.parity ^ 1);
          fence_proxy_async();
          if (kd == KIND_DYN) {
            mbar_arrive_expect_tx(full, 4 * TILE_BYTES + 3 * VEC_BYTES);
            bulk_copy_g2s(st.A, A + bt * M, TILE_BYTES, full);
            bulk_copy_g2s(st.B, B + bt * M, TILE_BYTES, full);
            bulk_copy_g2s(st.C, lxx + bt * M, TILE_BYTES, full);
            bulk_copy_g2s(st.Luu, luu + bt * M, TILE_BYTES, full);
            bulk_copy_g2s(st.lx, lx + bt * NX, VEC_BYTES, full);
            bulk_copy_g2s(st.lu, lu + bt * NX, VEC_BYTES, full);
          } else {
            mbar_arrive_expect_tx(full, 2 * TILE_BYTES + 2 * VEC_BYTES);
            bulk_copy_g2s(st.A, A + bt * M, TILE_BYTES, full);
            bulk_copy_g2s(st.C, phixx_b + (size_t)t * M, TILE_BYTES, full);
            bulk_copy_g2s(st.lx, phix_b + (size_t)t * NX, VEC_BYTES, full);
          }
          bulk_copy_g2s(st.dnext, def_b + (size_t)(t + 1) * NX, VEC_BYTES,
                        full);
        }
        ++item;
      }
      if (kd != KIND_DYN) zero_gain_rows(K + bt * M, dU + bt * NX, lane);
    }
    return;
  }

  // ---- consumers ----
  Work& w = s.w;
  const int r = tid >> 2, cg = tid & 3, c0 = TC * cg;
  const float reg_b = reg[b];
  const size_t last = (size_t)last_node[b];
  float dv1 = 0.f, dv2 = 0.f;   // meaningful in thread 0
  bool okb = true;              // meaningful in warp 0

  // seed: the terminal partials of the last active node
  {
    float v[TC];
    ld6(phixx_b + last * M + r * NX + c0, v);
    st6(&w.H[r][c0], v);
    if (cg == 0) w.G[r] = phix_b[last * NX + r];
  }
  consumer_sync();

  int item = 0;
  int kd_next = kind_b[T - 1];
  for (int t = T - 1; t >= 0; --t) {
    const int kd = kd_next;
    if (t > 0) kd_next = kind_b[t - 1];   // in flight during this step
    if (kd != KIND_DYN && kd != KIND_RESET) continue;   // PAD
    const RingPos pos(item, NSTAGE);
    ++item;
    const Stage& st = s.ring[pos.stage];
    mbar_wait(&s.full[pos.stage], pos.parity);
    if (kd == KIND_DYN) {
      const size_t bt = b * T + t;
      dyn_step(w, st, &s.empty[pos.stage], reg_b, tid, r, cg, c0,
               K + bt * M, dU + bt * NX, dv1, dv2, okb);
    } else {
      reset_step(w, st.A, st.C, st.lx, st.dnext, &s.empty[pos.stage], r, cg,
                 c0);
    }
  }
  if (tid == 0) {
    dv1_out[b] = dv1;
    dv2_out[b] = dv2;
    ok_out[b] = okb ? 1 : 0;
  }
}

// the shared-memory opt-in, once per device (a launch may be captured
// into a CUDA graph, where only launches belong)
cudaError_t configure() {
  static unsigned long long done = 0;  // bit d: device d configured
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess || (dev < 64 && (done >> dev) & 1ull)) return st;
  st = cudaFuncSetAttribute(riccati_dense_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)sizeof(Smem));
  if (st == cudaSuccess && dev < 64) done |= 1ull << dev;
  return st;
}

}  // namespace

extern "C" int riccati_dense_launch(
    const int* kind, const float* A, const float* B, const float* lxx,
    const float* luu, const float* lx, const float* lu, const float* defect,
    const float* phix, const float* phixx, const float* reg,
    const int* last_node, const unsigned char* active, float* dU, float* K,
    float* dv1, float* dv2, unsigned char* ok, int batch, int T,
    void* stream) {
  if (batch <= 0 || T <= 0) return 0;
  const cudaError_t st = configure();
  if (st != cudaSuccess) return static_cast<int>(st);
  riccati_dense_kernel<<<batch, NTHREADS, sizeof(Smem),
                         static_cast<cudaStream_t>(stream)>>>(
      kind, A, B, lxx, luu, lx, lu, defect, phix, phixx, reg, last_node,
      active, dU, K, dv1, dv2, ok, T);
  return static_cast<int>(cudaGetLastError());
}

// threads per block, dynamic shared memory per block and resident blocks
// per SM of the kernel on the current device
extern "C" int riccati_dense_info(int* threads, int* smem_bytes,
                                  int* blocks_per_sm) {
  const cudaError_t st = configure();
  if (st != cudaSuccess) return static_cast<int>(st);
  *threads = NTHREADS;
  *smem_bytes = (int)sizeof(Smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, riccati_dense_kernel, NTHREADS, sizeof(Smem)));
}

extern "C" const char* riccati_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
