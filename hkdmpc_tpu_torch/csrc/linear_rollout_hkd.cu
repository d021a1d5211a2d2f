// The linear rollout of one HS-DDP iteration for a batch of HKD scenarios:
// the multiple-shooting search direction dX and the closed-form expected
// cost change (dV_1, dV_2), with the dynamics and reset Jacobians rebuilt
// in-kernel from the nominal trajectory (X, U). One launch computes what
// solver/rollout.py:linear_rollout_jvp's lq=None form computes (the plain
// version: ops/linear_rollout_hkd.py:linear_rollout_hkd_plain).
//
// It replaces no TPU kernel: the JAX package's linear rollout is jax.jvp
// code that XLA fuses. On the card its plain version ran as about 6,400
// PyTorch operations a call (2,800 of them to assemble dense A and B), a
// third of a solve's device time at B = 4096, T = 75, spent on launches and
// ramps rather than on bytes. Wrapper and launch counter:
// hkdmpc_tpu_torch/ops/linear_rollout_hkd.py.
//
// What it computes, per scenario, for t = 0 .. T-1 with dx in shared memory
// (dx_0 = eps * defect[0]):
//   - DYN: du = eps dU[t] + K[t] dx; dx <- dx + dt DA dx + dt DB du
//     + eps defect[t+1]; dV_1 += lx dx + lu du, dV_2 += dx' lxx dx
//     + du' luu du (tracking, foot regularization, control, and the ReB
//     cone rows when reb_active);
//   - RESET: dV += the terminal partials of node t (the reset's source)
//     contracted with dx; dx <- (I + S) dx + eps defect[t+1];
//   - PAD: dx carries;
//   - at the scenario's last active node (the count of its non-PAD
//     transitions), dV += its terminal partials contracted with dx.
// The terminal partials hold the AL touchdown rows when al_active. A flag
// that is off reads zero ReB weights (and unit deltas) or zero AL weights,
// so its rows add exactly zero, as the plain version leaves them out.
// DA, DB, S and every partial come from the entry formulas of
// hkd_entries.cuh, the code the K1 sweep (riccati_hkd.cu) evaluates; dense
// A and B are never formed.
//
// What bounds it on the H100 (3.35 TB/s), at B = 4096, T = 75 (60 DYN, 4
// RESET, 11 PAD), f32: bytes. The call reads K and dU at the DYN steps,
// B*60*(24*24 + 24)*4 bytes = 590 MB, the rows of X, U, the references,
// defects, contacts and row parameters that each DYN or RESET step and the
// last active node take, and writes dX: about 0.80 GB, 0.24 ms. Its
// products are 0.5 GFLOP, under 0.01 ms at 67 TFLOP/s
// (ops/riccati_bound.py:linear_rollout_work computes both from the
// schedule).
//
// What the design does about it (one block of three warps per scenario):
//   - warps 1 and 2, the producers, take the ring items in turn (even, odd),
//     each with its own scratch, and fill a ring of two stages ahead of the
//     chain: a bulk asynchronous copy (TMA, completion counted on the
//     stage's mbarrier) brings K[t] and dU[t], 2,400 contiguous bytes, while
//     the warp's lanes evaluate step t's entries (produce_dyn: dt DA's
//     computed rows, B by column, lx, lu, the non-zeros of lxx and luu), or
//     a RESET step's Px and its source node's terminal partials, or the last
//     node's (produce_phi, produce_px). Nothing that depends only on X, U
//     and the references sits in the chain. An item costs one warp several
//     thousand cycles of divergent, latency-bound code (the lanes of a warp
//     take the branches of the entry formulas one after the other), several
//     times what the chain spends on it, so two warps produce (on an H100
//     at B = 4096, f32: one producer warp 1.15 ms, two 0.71 ms);
//   - warp 0, the consumer, runs the chain: lane i < 24 owns row i, takes
//     K[t]'s row i and dx from shared memory in 16-byte pieces, then its row
//     of dt DA dx + dt DB du on the pattern (rows 0-2 and 6-8 from the six
//     computed rows of D, rows 3-5 dt dx[9:12], rows 6-8 also the twelve
//     force columns of B, rows 9-11 four force columns, rows 12-23 the
//     diagonal), and its share of dV in two registers, summed over the warp
//     at the end. Two warp barriers a DYN step; dX is written row by row;
//   - B = 1024 (a fleet) is 1,024 blocks of 96 threads, all resident at
//     once on 132 SMs (8 a SM in f32, at 80 registers a thread); B = 4096
//     runs in four waves. The kind of every step and the last active node
//     are read per scenario; nothing assumes one gait or horizon.
// No tensor cores, no TF32; float64 is the same kernel on double with the
// exact float64 constants (linear_rollout_hkd_launch_f64), moving twice the
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hkd_entries.cuh"
#include "riccati_step.cuh"

namespace {

using namespace riccati;

constexpr int LR_STAGES = 2;
constexpr int LR_PRODUCERS = 2;  // producer warps: item i is warp 1 + i % 2's
constexpr int LR_THREADS = 32 * (1 + LR_PRODUCERS);   // warp 0 the chain
constexpr int REB_ROWS = 20;

// resident blocks per SM that __launch_bounds__ asks the register allocator
// for: 8 at f32 (80 registers a thread, a few bytes of spill), 4 at f64
template <typename R> struct LrMinBlocks { static constexpr int value = 8; };
template <> struct LrMinBlocks<double> { static constexpr int value = 4; };

// One ring item: a DYN step's compact entries (or a RESET step's / a
// terminal node's tiles) and defect[t+1] as K1's items hold them, and for a
// DYN step K[t] and dU[t] by bulk copy.
template <typename R>
struct __align__(16) LrStage {
  Stage<R> s;
  R K[NX * NX];
  R dU[NX];
};

template <typename R>
struct __align__(16) LrSmem {
  LrStage<R> ring[LR_STAGES];
  Scratch<R> sc[LR_PRODUCERS];
  R dx[2][NX];        // the chain's state, double-buffered
  R du[NX];
  R zeros[REB_ROWS];  // the ReB and AL weights of a flag that is off
  R ones[REB_ROWS];   // the ReB deltas of a flag that is off
  uint64_t full[LR_STAGES];
  uint64_t empty[LR_STAGES];
};

// sum of a[j] * v[j], j < n (n a multiple of the 16-byte width), a and v
// 16-byte aligned in shared memory; two partial sums
template <typename R, int N>
__device__ __forceinline__ R dot_smem(const R* a, const R* v) {
  constexpr int VN = Vec16<R>::N;
  R s0 = R(0), s1 = R(0);
#pragma unroll
  for (int j = 0; j < N; j += 2 * VN) {
    R x[VN], y[VN];
    ld16(a + j, x);
    ld16(v + j, y);
#pragma unroll
    for (int k = 0; k < VN; ++k) s0 = rfma(x[k], y[k], s0);
    if (j + VN < N) {
      ld16(a + j + VN, x);
      ld16(v + j + VN, y);
#pragma unroll
      for (int k = 0; k < VN; ++k) s1 = rfma(x[k], y[k], s1);
    }
  }
  return s0 + s1;
}

// the number of non-PAD transitions of a scenario: the index of its last
// active node (solver/rollout.py:last_active_node), by one warp
__device__ __forceinline__ int last_active(const int* kind_b, int T,
                                           int lane) {
  int n = 0;
  for (int j = lane; j < T; j += 32) n += kind_b[j] != 0;
  return __reduce_add_sync(FULL_MASK, n);
}

// The consumer's share of a tile item: dV += phix dx + dx' phixx dx (the
// terminal partials of one node).
template <typename R>
__device__ __forceinline__ void contract_tile(const TileData<R>& tile,
                                              const R* dx, int lane, R dxi,
                                              R& a1, R& a2) {
  if (lane < NX) {
    a1 = rfma(tile.phix[lane], dxi, a1);
    a2 = rfma(dxi, dot_smem<R, NX>(tile.phixx + lane * NX, dx), a2);
  }
}

template <typename R>
__global__ void __launch_bounds__(LR_THREADS, LrMinBlocks<R>::value)
linear_rollout_hkd_kernel(const int* __restrict__ kind,
                          const R* __restrict__ X, const R* __restrict__ U,
                          const R* __restrict__ contact,
                          const R* __restrict__ contact_next,
                          const R* __restrict__ xr, const R* __restrict__ ur,
                          const R* __restrict__ foot_r,
                          const R* __restrict__ reb_delta,
                          const R* __restrict__ reb_eps,
                          const R* __restrict__ term_contact,
                          const R* __restrict__ td_mask,
                          const R* __restrict__ al_sigma,
                          const R* __restrict__ al_lambda,
                          const R* __restrict__ term_mask,
                          const R* __restrict__ defect,
                          const R* __restrict__ dU,
                          const R* __restrict__ K,
                          const R* __restrict__ dt,
                          R* __restrict__ dX, R* __restrict__ dv1_out,
                          R* __restrict__ dv2_out, int T, int reb_active,
                          int al_active, R eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LrSmem<R>& s = *reinterpret_cast<LrSmem<R>*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t b = blockIdx.x;
  const size_t Tn = (size_t)T + 1;
  constexpr size_t M = NX * NX;
  const int* kind_b = kind + b * T;
  const R* def_b = defect + b * Tn * NX;

  if (tid == 0) {
    for (int i = 0; i < LR_STAGES; ++i) {
      // the producing warp's lane 0 once when it starts the item (with the
      // bytes of its copies), then each of its lanes when it is written
      mbar_init(&s.full[i], 33);
      mbar_init(&s.empty[i], 32);   // every consumer lane
    }
    mbar_fence_init();
  }
  if (tid < REB_ROWS) {
    s.zeros[tid] = R(0);
    s.ones[tid] = R(1);
  }
  __syncthreads();
  const int last = last_active(kind_b, T, lane);

  if (tid >= 32) {
    // ---- producer warps: the entry formulas, the items in turn ----
    const R* X_b = X + b * Tn * NX;
    const R* U_b = U + b * (size_t)T * NX;
    const R* c_b = contact + b * T * 4;
    const R* cn_b = contact_next + b * T * 4;
    const R* xr_b = xr + b * Tn * NX;
    const R* ur_b = ur + b * Tn * NX;
    const R* fr_b = foot_r + b * Tn * 12;
    const R* rbd_b = reb_delta + b * T * REB_ROWS;
    const R* rbe_b = reb_eps + b * T * REB_ROWS;
    const R* tc_b = term_contact + b * Tn * 4;
    const R* td_b = td_mask + b * Tn * 4;
    const R* sig_b = al_sigma + b * Tn * 4;
    const R* lam_b = al_lambda + b * Tn * 4;
    const R* tm_b = term_mask + b * Tn;
    const R dt_b = dt[b];
    const int p = tid / 32 - 1;
    Scratch<R>& sc = s.sc[p];

    // terminal partials of node n into a stage's tile
    auto phi = [&](Stage<R>& st, size_t n) {
      produce_phi(sc, st.tile.phix, st.tile.phixx, lane, X_b + n * NX,
                  xr_b + n * NX, fr_b + n * 12, tc_b + n * 4, td_b + n * 4,
                  al_active ? sig_b + n * 4 : s.zeros,
                  al_active ? lam_b + n * 4 : s.zeros, tm_b[n]);
    };
    // the next ring item, if it is this warp's (item % LR_PRODUCERS == p):
    // wait for its stage, have lane 0 arrive (with the bytes of the copies
    // it starts), produce it, arrive
    int item = 0;
    auto produce = [&](uint32_t bytes, auto&& fill) {
      if (item % LR_PRODUCERS != p) {
        ++item;
        return;
      }
      const RingPos pos(item, LR_STAGES);
      mbar_wait(&s.empty[pos.stage], pos.parity ^ 1);
      if (lane == 0) {
        fence_proxy_async();
        if (bytes)
          mbar_arrive_expect_tx(&s.full[pos.stage], bytes);
        else
          mbar_arrive(&s.full[pos.stage]);
      }
      fill(s.ring[pos.stage], &s.full[pos.stage]);
      mbar_arrive(&s.full[pos.stage]);
      ++item;
    };

    for (int t = 0; t < T; ++t) {
      const int kd = kind_b[t];
      const size_t st_ = (size_t)t;
      if (last == t)     // the last active node's terminal partials
        produce(0, [&](LrStage<R>& ls, uint64_t*) { phi(ls.s, st_); });
      if (kd == KIND_DYN) {
        constexpr uint32_t KB = M * sizeof(R), DB = NX * sizeof(R);
        produce(KB + DB, [&](LrStage<R>& ls, uint64_t* full) {
          if (lane == 0) {
            bulk_copy_g2s(ls.K, K + (b * T + st_) * M, KB, full);
            bulk_copy_g2s(ls.dU, dU + (b * T + st_) * NX, DB, full);
          }
          produce_dyn(sc, ls.s, lane, X_b + st_ * NX, U_b + st_ * NX,
                      xr_b + st_ * NX, ur_b + st_ * NX, fr_b + st_ * 12,
                      c_b + st_ * 4,
                      reb_active ? rbd_b + st_ * REB_ROWS : s.ones,
                      reb_active ? rbe_b + st_ * REB_ROWS : s.zeros,
                      def_b + (st_ + 1) * NX, dt_b);
        });
      } else if (kd == KIND_RESET) {
        produce(0, [&](LrStage<R>& ls, uint64_t*) {
          phi(ls.s, st_);
          produce_px(sc, ls.s.tile.Px, lane, c_b + st_ * 4, cn_b + st_ * 4);
          if (lane < NX) ls.s.dnext[lane] = def_b[(st_ + 1) * NX + lane];
        });
      }
    }
    if (last == T)
      produce(0, [&](LrStage<R>& ls, uint64_t*) { phi(ls.s, (size_t)T); });
    return;
  }

  // ---- consumer warp: the chain ----
  const R dt_b = dt[b];
  R* dX_b = dX + b * Tn * NX;
  R dxi = R(0);                // dx[lane], lane < 24
  R a1 = R(0), a2 = R(0);      // this lane's share of dV_1, dV_2
  if (lane < NX) {
    dxi = eps * def_b[lane];
    s.dx[0][lane] = dxi;
    dX_b[lane] = dxi;
  }
  __syncwarp();
  int p = 0, item = 0;
  auto wait_item = [&]() -> const LrStage<R>& {
    const RingPos pos(item, LR_STAGES);
    mbar_wait(&s.full[pos.stage], pos.parity);
    return s.ring[pos.stage];
  };
  auto done_item = [&]() {
    mbar_arrive(&s.empty[RingPos(item, LR_STAGES).stage]);
    ++item;
  };
  auto tile_item = [&]() {
    const LrStage<R>& ls = wait_item();
    contract_tile(ls.s.tile, s.dx[p], lane, dxi, a1, a2);
    done_item();
  };

  for (int t = 0; t < T; ++t) {
    const int kd = kind_b[t];
    if (last == t) tile_item();
    if (kd == KIND_DYN) {
      const LrStage<R>& ls = wait_item();
      const DynData<R>& d = ls.s.dyn;
      const R* dx = s.dx[p];
      const int i = lane < NX ? lane : 0;
      // du = eps dU[t] + K[t] dx
      const R dui = rfma(eps, ls.dU[i], dot_smem<R, NX>(ls.K + i * NX, dx));
      if (lane < NX) s.du[lane] = dui;
      __syncwarp();
      // dt DA dx + dt DB du on their patterns
      R lin;
      if (i < 3 || (i >= 6 && i < 9)) {
        lin = dot_smem<R, NX>(d.D[i < 3 ? i : i - 3], dx);
        if (i >= 6) {
          const R* bc = d.Bc[i - 6];
          R s0 = R(0), s1 = R(0);
#pragma unroll
          for (int j = 0; j < 12; j += 2) {
            s0 = rfma(bc[j], s.du[j], s0);
            s1 = rfma(bc[j + 1], s.du[j + 1], s1);
          }
          lin += s0 + s1;
        }
      } else if (i < 6) {
        lin = dt_b * dx[i + 6];
      } else if (i < 12) {
        const R* b3 = d.Bc[3];
        lin = b3[i - 9] * s.du[i - 9];
        lin = rfma(b3[i - 6], s.du[i - 6], lin);
        lin = rfma(b3[i - 3], s.du[i - 3], lin);
        lin = rfma(b3[i], s.du[i], lin);
      } else {
        lin = d.Bc[3][i] * dui;
      }
      const R dxn = (dxi + lin) + eps * ls.s.dnext[i];
      // this lane's share of dV: lx dx + lu du, dx' lxx dx + du' luu du
      const R q1 = rfma(d.lx[i], dxi, d.lu[i] * dui);
      R q2 = d.q[Q_LXXD + i] * dxi * dxi + d.q[Q_LUUD + i] * dui * dui;
      if (i >= 12 && (i - 12) % 3 < 2) {      // lxx[i][3 + j], symmetric
        const int l = (i - 12) / 3, j = (i - 12) % 3;
        q2 += R(2) * d.q[Q_LXC + 2 * l + j] * dxi * dx[3 + j];
      } else if (i < 12 && i % 3 == 2) {      // luu[3l][3l+2], [3l+1][3l+2]
        const int l = i / 3;
        q2 += R(2) * dui * (d.q[Q_HXZ + l] * s.du[3 * l]
                            + d.q[Q_HYZ + l] * s.du[3 * l + 1]);
      }
      if (lane < NX) {
        a1 += q1;
        a2 += q2;
        s.dx[p ^ 1][lane] = dxn;
        dX_b[(size_t)(t + 1) * NX + lane] = dxn;
        dxi = dxn;
      }
      done_item();
      p ^= 1;
      __syncwarp();
    } else if (kd == KIND_RESET) {
      const LrStage<R>& ls = wait_item();
      const R* dx = s.dx[p];
      contract_tile(ls.s.tile, dx, lane, dxi, a1, a2);
      if (lane < NX) {
        const R dxn = rfma(eps, ls.s.dnext[lane],
                           dot_smem<R, NX>(ls.s.tile.Px + lane * NX, dx));
        s.dx[p ^ 1][lane] = dxn;
        dX_b[(size_t)(t + 1) * NX + lane] = dxn;
        dxi = dxn;
      }
      done_item();
      p ^= 1;
      __syncwarp();
    } else if (lane < NX) {
      dX_b[(size_t)(t + 1) * NX + lane] = dxi;
    }
  }
  if (last == T) tile_item();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a1 += __shfl_xor_sync(FULL_MASK, a1, o);
    a2 += __shfl_xor_sync(FULL_MASK, a2, o);
  }
  if (lane == 0) {
    dv1_out[b] = a1;
    dv2_out[b] = a2;
  }
}

// the shared-memory opt-in of instantiation R, once per device (a launch
// may be captured into a CUDA graph, where only launches belong)
template <typename R>
cudaError_t configure() {
  static unsigned long long done = 0;  // bit d: device d configured
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess || (dev < 64 && (done >> dev) & 1ull)) return st;
  st = cudaFuncSetAttribute(linear_rollout_hkd_kernel<R>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)sizeof(LrSmem<R>));
  if (st == cudaSuccess && dev < 64) done |= 1ull << dev;
  return st;
}

template <typename R>
int launch(const int* kind, const R* X, const R* U, const R* contact,
           const R* contact_next, const R* xr, const R* ur, const R* foot_r,
           const R* reb_delta, const R* reb_eps, const R* term_contact,
           const R* td_mask, const R* al_sigma, const R* al_lambda,
           const R* term_mask, const R* defect, const R* dU, const R* K,
           const R* dt, R* dX, R* dv1, R* dv2, int B, int T, int reb_active,
           int al_active, double eps, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const cudaError_t st = configure<R>();
  if (st != cudaSuccess) return static_cast<int>(st);
  linear_rollout_hkd_kernel<R><<<B, LR_THREADS, sizeof(LrSmem<R>),
                                 static_cast<cudaStream_t>(stream)>>>(
      kind, X, U, contact, contact_next, xr, ur, foot_r, reb_delta, reb_eps,
      term_contact, td_mask, al_sigma, al_lambda, term_mask, defect, dU, K,
      dt, dX, dv1, dv2, T, reb_active, al_active, static_cast<R>(eps));
  return static_cast<int>(cudaGetLastError());
}

// threads per block, dynamic shared memory per block and resident blocks
// per SM of instantiation R on the current device
template <typename R>
int info(int* threads, int* smem_bytes, int* blocks_per_sm) {
  const cudaError_t st = configure<R>();
  if (st != cudaSuccess) return static_cast<int>(st);
  *threads = LR_THREADS;
  *smem_bytes = (int)sizeof(LrSmem<R>);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, linear_rollout_hkd_kernel<R>, LR_THREADS,
      sizeof(LrSmem<R>)));
}

}  // namespace

// The C interface: linear_rollout_hkd_launch / _info run the float32
// instantiation, linear_rollout_hkd_launch_f64 / _info_f64 the float64 one.
#define LR_PARAMS(R)                                                        \
  const int *kind, const R *X, const R *U, const R *contact,                \
      const R *contact_next, const R *xr, const R *ur, const R *foot_r,     \
      const R *reb_delta, const R *reb_eps, const R *term_contact,          \
      const R *td_mask, const R *al_sigma, const R *al_lambda,              \
      const R *term_mask, const R *defect, const R *dU, const R *K,         \
      const R *dt, R *dX, R *dv1, R *dv2, int B, int T, int reb_active,     \
      int al_active, double eps, void *stream
#define LR_ARGS                                                             \
  kind, X, U, contact, contact_next, xr, ur, foot_r, reb_delta, reb_eps,    \
      term_contact, td_mask, al_sigma, al_lambda, term_mask, defect, dU, K, \
      dt, dX, dv1, dv2, B, T, reb_active, al_active, eps, stream

extern "C" int linear_rollout_hkd_launch(LR_PARAMS(float)) {
  return launch<float>(LR_ARGS);
}

extern "C" int linear_rollout_hkd_launch_f64(LR_PARAMS(double)) {
  return launch<double>(LR_ARGS);
}

extern "C" int linear_rollout_hkd_info(int* threads, int* smem_bytes,
                                       int* blocks_per_sm) {
  return info<float>(threads, smem_bytes, blocks_per_sm);
}

extern "C" int linear_rollout_hkd_info_f64(int* threads, int* smem_bytes,
                                           int* blocks_per_sm) {
  return info<double>(threads, smem_bytes, blocks_per_sm);
}

extern "C" const char* linear_rollout_hkd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
