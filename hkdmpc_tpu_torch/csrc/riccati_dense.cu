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
//
// float64 (riccati_step.cuh): the same kernel on double, in the same
// library (riccati_dense_launch_f64, riccati_dense_info_f64). Every tile is
// 4,608 bytes, still a multiple of 16 for its bulk copy, and a step moves twice
// the bytes, so at B = 4096 the sweep moves 6.3 GB, 1.9 ms of memory time;
// its operations take 0.78 ms at the card's FP64 tensor-core rate
// (67 TFLOP/s), 1.55 ms on the FP64 vector units (34 TFLOP/s) where it
// runs. Bytes bound it. Two blocks (81 KB of shared memory each) share an
// SM.

#include <cuda_runtime.h>

#include "riccati_step.cuh"

namespace {

using namespace riccati;

constexpr int NSTAGE = 2;
// bytes of one bulk copy: a 24 x 24 tile, a 24-vector
template <typename R> struct Bytes {
  static constexpr uint32_t TILE = NX * NX * sizeof(R);
  static constexpr uint32_t VEC = NX * sizeof(R);
};

// One ring item. DYN: A[t], B[t], lxx[t], luu[t], lx[t], lu[t];
// RESET: Px in A, phixx[t] in C, phix[t] in lx. Both: defect[t+1].
template <typename R>
struct __align__(16) Stage {
  R A[NX * NX];
  R B[NX * NX];
  R C[NX * NX];
  R Luu[NX * NX];
  R lx[NX], lu[NX], dnext[NX];
};

template <typename R>
struct __align__(16) Smem {
  Work<R> w;
  Stage<R> ring[NSTAGE];
  uint64_t full[NSTAGE];
  uint64_t empty[NSTAGE];
};

// acc[i][:] += sum_k left(k, i) * right[k][c0 .. c0 + 5], i < 3: a 3 x 6
// register tile of a 24-deep product, six shared loads for 18 multiply-adds
// per k. `right` has rows of `ld` values; left(k, i) is the tile's i-th row
// entry of the left factor at depth k.
template <typename R, class Left>
__device__ __forceinline__ void tile_product(R acc[3][TC], const R* right,
                                             int ld, int c0, Left left) {
  R v[TC];
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
template <typename R>
__device__ __forceinline__ void dyn_step(Work<R>& w, const Stage<R>& st,
                                         uint64_t* stage_empty, R reg_b,
                                         int tid, int r, int cg, int c0,
                                         R* K_bt, R* dU_bt, R& dv1, R& dv2,
                                         bool& okb) {
  const int warp = tid >> 5, r0 = 3 * ((tid & 31) >> 2);
  defect_correction(w, st.dnext, r, cg, c0);
  if (warp < 2) {
    R acc[3][TC] = {};
    tile_product(acc, warp == 0 ? st.A : st.B, NX, c0,
                 [&](int k, int i) { return w.H[r0 + i][k]; });
    R (*out)[LDP] = warp == 0 ? w.HA : w.HB;
#pragma unroll
    for (int i = 0; i < 3; ++i) st6(&out[r0 + i][c0], acc[i]);
  }
  consumer_sync();
  {
    const R* left = warp == 0 ? st.A : st.B;
    R acc[3][TC] = {};
    tile_product(acc, warp == 2 ? &w.HB[0][0] : &w.HA[0][0], LDP, c0,
                 [&](int k, int i) { return left[k * NX + r0 + i]; });
    // A'HA, B'HB are added to lxx, luu apart, as the plain version adds them
    const R* cost = warp == 0 ? st.C : st.Luu;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int row = r0 + i;
      if (warp == 1) {
        st6(&w.Qux[row][c0], acc[i]);
        st6(&w.W[row][NX + c0], acc[i]);
      } else {
        R q[TC];
        ld6(cost + row * NX + c0, q);
#pragma unroll
        for (int j = 0; j < TC; ++j)
          q[j] = (q[j] + acc[i][j]) + (row == c0 + j ? reg_b : R(0));
        st6(warp == 0 ? &w.Qxx[row][c0] : &w.W[row][c0], q);
      }
    }
  }
  R ag = R(0), bg = R(0);
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const R gn = w.Gn[c0 + j];
    ag = rfma(st.A[(c0 + j) * NX + r], gn, ag);
    bg = rfma(st.B[(c0 + j) * NX + r], gn, bg);
  }
  ag = row_sum(ag);
  bg = row_sum(bg);
  if (cg == 0) {
    const R qu = st.lu[r] + bg;
    w.Qx[r] = st.lx[r] + ag;
    w.Qu[r] = qu;
    w.W[r][2 * NX] = qu;
  }
  mbar_arrive(stage_empty);   // the last read of the stage is behind us
  consumer_sync();
  solve_and_update(w, tid, r, cg, c0, K_bt, dU_bt, dv1, dv2, okb);
}

template <typename R>
__global__ void __launch_bounds__(NTHREADS, MinBlocks<R>::value)
riccati_dense_kernel(const int* __restrict__ kind, const R* __restrict__ A,
                     const R* __restrict__ B, const R* __restrict__ lxx,
                     const R* __restrict__ luu, const R* __restrict__ lx,
                     const R* __restrict__ lu, const R* __restrict__ defect,
                     const R* __restrict__ phix, const R* __restrict__ phixx,
                     const R* __restrict__ reg,
                     const int* __restrict__ last_node,
                     const unsigned char* __restrict__ active,
                     R* __restrict__ dU, R* __restrict__ K,
                     R* __restrict__ dv1_out, R* __restrict__ dv2_out,
                     unsigned char* __restrict__ ok_out, int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<R>& s = *reinterpret_cast<Smem<R>*>(smem_raw);
  constexpr uint32_t TILE = Bytes<R>::TILE, VEC = Bytes<R>::VEC;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  // a retry sweep: a scenario that is done returns before its first load
  // and writes nothing (its outputs stay those of an earlier sweep)
  if (active != nullptr && !active[b]) return;
  const size_t Tn = (size_t)T + 1;
  constexpr size_t M = NX * NX;

  const int* kind_b = kind + b * T;
  const R* def_b = defect + b * Tn * NX;
  const R* phix_b = phix + b * Tn * NX;
  const R* phixx_b = phixx + b * Tn * M;

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
          Stage<R>& st = s.ring[pos.stage];
          uint64_t* full = &s.full[pos.stage];
          mbar_wait(&s.empty[pos.stage], pos.parity ^ 1);
          fence_proxy_async();
          if (kd == KIND_DYN) {
            mbar_arrive_expect_tx(full, 4 * TILE + 3 * VEC);
            bulk_copy_g2s(st.A, A + bt * M, TILE, full);
            bulk_copy_g2s(st.B, B + bt * M, TILE, full);
            bulk_copy_g2s(st.C, lxx + bt * M, TILE, full);
            bulk_copy_g2s(st.Luu, luu + bt * M, TILE, full);
            bulk_copy_g2s(st.lx, lx + bt * NX, VEC, full);
            bulk_copy_g2s(st.lu, lu + bt * NX, VEC, full);
          } else {
            mbar_arrive_expect_tx(full, 2 * TILE + 2 * VEC);
            bulk_copy_g2s(st.A, A + bt * M, TILE, full);
            bulk_copy_g2s(st.C, phixx_b + (size_t)t * M, TILE, full);
            bulk_copy_g2s(st.lx, phix_b + (size_t)t * NX, VEC, full);
          }
          bulk_copy_g2s(st.dnext, def_b + (size_t)(t + 1) * NX, VEC, full);
        }
        ++item;
      }
      if (kd != KIND_DYN) zero_gain_rows(K + bt * M, dU + bt * NX, lane);
    }
    return;
  }

  // ---- consumers ----
  Work<R>& w = s.w;
  const int r = tid >> 2, cg = tid & 3, c0 = TC * cg;
  const R reg_b = reg[b];
  const size_t last = (size_t)last_node[b];
  R dv1 = R(0), dv2 = R(0);   // meaningful in thread 0
  bool okb = true;            // meaningful in warp 0

  // seed: the terminal partials of the last active node
  {
    R v[TC];
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
    const Stage<R>& st = s.ring[pos.stage];
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

// the shared-memory opt-in of instantiation R, once per device (a launch
// may be captured into a CUDA graph, where only launches belong); each
// instantiation keeps its own bits
template <typename R>
cudaError_t configure() {
  static unsigned long long done = 0;  // bit d: device d configured
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess || (dev < 64 && (done >> dev) & 1ull)) return st;
  st = cudaFuncSetAttribute(riccati_dense_kernel<R>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)sizeof(Smem<R>));
  if (st == cudaSuccess && dev < 64) done |= 1ull << dev;
  return st;
}

template <typename R>
int launch(const int* kind, const R* A, const R* B, const R* lxx,
           const R* luu, const R* lx, const R* lu, const R* defect,
           const R* phix, const R* phixx, const R* reg, const int* last_node,
           const unsigned char* active, R* dU, R* K, R* dv1, R* dv2,
           unsigned char* ok, int batch, int T, void* stream) {
  if (batch <= 0 || T <= 0) return 0;
  const cudaError_t st = configure<R>();
  if (st != cudaSuccess) return static_cast<int>(st);
  riccati_dense_kernel<R><<<batch, NTHREADS, sizeof(Smem<R>),
                            static_cast<cudaStream_t>(stream)>>>(
      kind, A, B, lxx, luu, lx, lu, defect, phix, phixx, reg, last_node,
      active, dU, K, dv1, dv2, ok, T);
  return static_cast<int>(cudaGetLastError());
}

// threads per block, dynamic shared memory per block and resident blocks
// per SM of instantiation R on the current device
template <typename R>
int info(int* threads, int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t st = configure<R>();
  if (st != cudaSuccess) return static_cast<int>(st);
  *threads = NTHREADS;
  *smem_bytes = (int)sizeof(Smem<R>);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, riccati_dense_kernel<R>, NTHREADS, sizeof(Smem<R>)));
}

}  // namespace

// The C interface: riccati_dense_launch / _info run the float32
// instantiation, riccati_dense_launch_f64 / _info_f64 the float64 one.
#define DENSE_PARAMS(R)                                                     \
  const int *kind, const R *A, const R *B, const R *lxx, const R *luu,      \
      const R *lx, const R *lu, const R *defect, const R *phix,             \
      const R *phixx, const R *reg, const int *last_node,                   \
      const unsigned char *active, R *dU, R *K, R *dv1, R *dv2,             \
      unsigned char *ok, int batch, int T, void *stream
#define DENSE_ARGS                                                          \
  kind, A, B, lxx, luu, lx, lu, defect, phix, phixx, reg, last_node, active, \
      dU, K, dv1, dv2, ok, batch, T, stream

extern "C" int riccati_dense_launch(DENSE_PARAMS(float)) {
  return launch<float>(DENSE_ARGS);
}

extern "C" int riccati_dense_launch_f64(DENSE_PARAMS(double)) {
  return launch<double>(DENSE_ARGS);
}

extern "C" int riccati_dense_info(int* threads, int* smem_bytes,
                                  int* blocks_per_sm) {
  return info<float>(threads, smem_bytes, blocks_per_sm);
}

extern "C" int riccati_dense_info_f64(int* threads, int* smem_bytes,
                                      int* blocks_per_sm) {
  return info<double>(threads, smem_bytes, blocks_per_sm);
}

extern "C" const char* riccati_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
