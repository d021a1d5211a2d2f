// Riccati backward sweep of one HS-DDP iteration for a batch of HKD
// scenarios, with the dynamics/reset Jacobians and every cost partial rebuilt
// in-kernel from the nominal trajectory (X, U).
//
// Replaces hkdmpc_tpu/ops/pallas_backward.py:_kernel_hkd (and its step body
// _kernel_hkd_substep), the TPU kernel behind backward_sweep_pallas_hkd.
// Wrapper, plain PyTorch version and launch counter:
// hkdmpc_tpu_torch/ops/riccati_hkd.py.
//
// A retry of the regularization loop (solver/backward.py, a fixed number of
// sweeps inside a CUDA graph) passes `active` (B bytes): the block of a
// scenario that is done returns before its first load and writes nothing,
// so the first sweep's outputs stay; a retry then costs a launch (about
// 0.06 ms at B = 4096 on the H100) where no scenario needs it.
//
// What it computes, per scenario, for t = T-1 .. 0 with the value carry
// (G 24, H 24x24) held in shared memory:
//   - seed G/H with the terminal partials phi(last) of the scenario's last
//     active node, at the step whose dest node it is;
//   - Gn = G + H * defect[t+1];
//   - DYN: A = I + dt*DA, B = dt*DB from the sparse Jacobian entries,
//     running partials (tracking, foot reg, ReB barrier on the 20 GRF cone
//     rows), Q expansion with the per-scenario reg, elimination with the PSD
//     gate pivot > 1e-9 on the tableau [Quu | Qux | Qu], then
//     K = -Quu^-1 Qux, dU = -Quu^-1 Qu and the value update;
//   - RESET: Px = I + S, G = phix(t) + Px' Gn, H = phixx(t) + Px' H Px;
//   - PAD: the value carries through, K and dU are zero.
// The entry formulas mirror ops/jac_tminor.py (_rot_entries, _leg_fk_entries,
// dyn_jac_entries, reset_jac_entries), ops/hkd_tminor.py
// (running_partial_entries, terminal_partial_entries) and solver/costs.py
// (reb_derivs) term for term, each entry summed in the same order. They, the
// ring items and the producer's scratch live in hkd_entries.cuh, which the
// linear rollout (linear_rollout_hkd.cu) includes too.
// Constants and weights come from the generated header hkd_constants.cuh
// (ops/_build.py writes it from models/).
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), at B = 4096, T = 75 (60 DYN, 4 RESET, 11 PAD): the sweep writes K,
// B*T*24*24*4 bytes = 708 MB, and dU, 29 MB, and reads 60 KB of X, U,
// references, defects and row parameters per scenario: 0.98 GB, 0.29 ms of
// memory time. Counted on the non-zeros of A and B (A = I + dt*DA with 62
// non-zeros of DA, all in rows 0-8; B's 60: rows 6-8 over the 12 force
// columns, one entry per column in rows 9-11 and the diagonal of rows
// 12-23) a DYN step is 85.6k flop and the sweep 21.2 GFLOP, 0.32 ms;
// counted dense (210k flop a step) it would be 0.8 ms. Operations bound it,
// narrowly. (ops/riccati_bound.py computes both from the shapes;
// chip_smoke.py prints them beside the measured time.)
//
// What the design does about it (block layout, register tiles and the
// elimination: riccati_step.cuh):
//   - nothing that depends only on X, U and the references sits in the
//     serial chain. The producer warp evaluates the entry formulas for the
//     next ring item while the 96 consumer threads run the current step:
//     the three angles' sines and cosines on three lanes and the four
//     rotation products on four, the cone rows on 20 lanes, the legs'
//     forward kinematics on four lanes, every column of the Jacobian blocks
//     and every entry of the partials on its own lane, with one piece of
//     code for all columns of a kind (a warp runs the branches of its lanes
//     one after the other). It writes compact blocks, not 24 x 24 tiles: D =
//     dt*DA's rows 0-2 and 6-8 (6 x 24; rows 3-5 are the constant
//     d(pos)/dt = vel), B by column (Bc: three weights of rows 6-8 and the
//     column's single entry in rows 9-23), the diagonals of lxx and luu and
//     their few off-diagonal entries;
//   - the consumers' products follow that pattern: H A = H + H[:, rows] D
//     + dt H[:, 3:6] and A'(HA) likewise (6 or 7 terms per element where a
//     dense product has 24), and every product with B takes 4 terms per
//     element;
//   - terminal partials are computed only for the ring items that need them
//     (a RESET step's source node, and the scenario's last active node, as a
//     SEED item of its own), into the item's own stage, so the producer can
//     run ahead without a single stash to overwrite. RESET steps (4 of 75)
//     take dense 24 x 24 tiles through the shared sandwich;
//   - the schedule is read per scenario from kind[b, :] and last_node[b] by
//     both sides; nothing assumes one gait.
// No tensor cores, no TF32 (riccati_step.cuh says why).
//
// float64 (riccati_step.cuh): the same kernel on double, in the same
// library (riccati_hkd_launch_f64, riccati_hkd_info_f64), with the exact float64 constants (KD_*)
// and double sines and cosines. The sweep then moves twice the bytes, 1.96
// GB at B = 4096, 0.59 ms, and its 21.2 GFLOP take 0.32 ms at the card's
// FP64 tensor-core rate (67 TFLOP/s), 0.62 ms on the FP64 vector units
// (34 TFLOP/s) where it runs: bytes bound it, narrowly. Two blocks (75 KB of
// shared memory each) share an SM.

#include <cuda_runtime.h>

#include "hkd_entries.cuh"
#include "riccati_step.cuh"

namespace {

using namespace riccati;

constexpr int NSTAGE = 3;

template <typename R>
struct __align__(16) Smem {
  Work<R> w;
  Stage<R> ring[NSTAGE];
  Scratch<R> sc;
  uint64_t full[NSTAGE];
  uint64_t empty[NSTAGE];
};

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// where lxx[r][c] of a DYN item sits in DynData::q
__device__ __forceinline__ int lxx_offset(int r, int c) {
  if (r == c) return Q_LXXD + r;
  const int hi = r > c ? r : c, lo = r > c ? c : r;
  if (hi < 12) return Q_ZERO;
  const int l = (hi - 12) / 3, j = (hi - 12) % 3;
  return (j < 2 && lo == 3 + j) ? Q_LXC + 2 * l + j : Q_ZERO;
}

// where luu[r][c] of a DYN item sits in DynData::q
__device__ __forceinline__ int luu_offset(int r, int c) {
  if (r == c) return Q_LUUD + r;
  const int hi = r > c ? r : c, lo = r > c ? c : r;
  if (hi >= 12 || hi % 3 != 2 || lo / 3 != hi / 3) return Q_ZERO;
  return (lo % 3 == 0 ? Q_HXZ : Q_HYZ) + hi / 3;
}

// A consumer thread's fixed view of the patterns: for each of its six
// columns where lxx[r][c] and luu[r][c] sit in DynData::q (one byte each),
// worked out once per kernel.
struct Pattern {
  uint32_t lxx[2], luu[2];
  __device__ Pattern(int r, int c0) {
    lxx[0] = lxx[1] = luu[0] = luu[1] = 0;
    for (int j = 0; j < TC; ++j) {
      lxx[j / 3] |= (uint32_t)lxx_offset(r, c0 + j) << (8 * (j % 3));
      luu[j / 3] |= (uint32_t)luu_offset(r, c0 + j) << (8 * (j % 3));
    }
  }
  __device__ __forceinline__ static int at(const uint32_t p[2], int j) {
    return (p[j / 3] >> (8 * (j % 3))) & 0xff;
  }
};

// the state row of D's row k
__device__ __forceinline__ int d_row(int k) { return k < 3 ? k : k + 3; }

// DYN: the Q expansion on the pattern of A and B, then the shared step.
// A = I + dt DA with DA's rows 0..2 and 6..8 in D and its rows 3..5 the
// constant d(pos)/dt = vel (DA[3+i][9+i] = 1); B by column in Bc.
template <typename R>
__device__ __forceinline__ void dyn_step(Work<R>& w, const Stage<R>& st,
                                         uint64_t* stage_empty, R reg_b,
                                         R dt_b, const Pattern& pat,
                                         int tid, int r, int cg, int c0,
                                         R* K_bt, R* dU_bt,
                                         R& dv1, R& dv2, bool& okb) {
  const DynData<R>& d = st.dyn;
  defect_correction(w, st.dnext, r, cg, c0);
  R v[TC];
  {
    // HA = H + H[:, rows] D + dt H[:, 3:6] -> columns 9:12
    // HB[:, j] = H[:, 6:9] Bc[0:3, j] + H[:, row_j] Bc[3, j]
    R ha[TC];
    R hb[TC] = {R(0), R(0), R(0), R(0), R(0), R(0)};
    ld6(&w.H[r][c0], ha);
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      ld6(&d.D[k][c0], v);
      fma6(ha, w.H[r][d_row(k)], v);
    }
    if (cg == 1) {   // columns 9, 10, 11
#pragma unroll
      for (int i = 0; i < 3; ++i) ha[3 + i] = rfma(dt_b, w.H[r][3 + i], ha[3 + i]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ld6(&d.Bc[k][c0], v);
      fma6(hb, w.H[r][6 + k], v);
    }
    ld6(&d.Bc[3][c0], v);
#pragma unroll
    for (int j = 0; j < TC; ++j)
      hb[j] = rfma(w.H[r][b_single_row(c0 + j)], v[j], hb[j]);
    st6(&w.HA[r][c0], ha);
    st6(&w.HB[r][c0], hb);
  }
  consumer_sync();
  const int rs = b_single_row(r);
  const R bs = d.Bc[3][r];
  const bool vel_row = r >= 9 && r < 12;   // row 9 + i of A' takes dt * row 3 + i
  R axx[TC];
  R qux[TC] = {R(0), R(0), R(0), R(0), R(0), R(0)};
  R auu[TC] = {R(0), R(0), R(0), R(0), R(0), R(0)};
  // A'(HA) = HA + D' HA[rows, :] + dt HA[3:6, :] -> rows 9:12
  ld6(&w.HA[r][c0], axx);
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    ld6(&w.HA[d_row(k)][c0], v);
    fma6(axx, d.D[k][r], v);
  }
  if (vel_row) {
    ld6(&w.HA[r - 6][c0], v);
    fma6(axx, dt_b, v);
  }
  // B'(HA), B'(HB): rows 6..8 and row rs of the right factor
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const R bk = d.Bc[k][r];
    ld6(&w.HA[6 + k][c0], v);
    fma6(qux, bk, v);
    ld6(&w.HB[6 + k][c0], v);
    fma6(auu, bk, v);
  }
  ld6(&w.HA[rs][c0], v);
  fma6(qux, bs, v);
  ld6(&w.HB[rs][c0], v);
  fma6(auu, bs, v);
  R qxx[TC], quu[TC];
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const R rd = (r == c0 + j) ? reg_b : R(0);
    qxx[j] = (d.q[Pattern::at(pat.lxx, j)] + axx[j]) + rd;
    quu[j] = (d.q[Pattern::at(pat.luu, j)] + auu[j]) + rd;
  }
  st6(&w.Qxx[r][c0], qxx);
  st6(&w.Qux[r][c0], qux);
  st6(&w.W[r][c0], quu);
  st6(&w.W[r][NX + c0], qux);
  {
    // Qx = lx + A' Gn, Qu = lu + B' Gn: each of the row's four threads
    // takes a share of the terms
    R ag = R(0), bg;
    for (int k = cg; k < ND; k += 4) ag = rfma(d.D[k][r], w.Gn[d_row(k)], ag);
    if (cg == 3) {
      bg = bs * w.Gn[rs];
      ag += w.Gn[r];
      if (vel_row) ag = rfma(dt_b, w.Gn[r - 6], ag);
    } else {
      bg = d.Bc[cg][r] * w.Gn[6 + cg];
    }
    ag = row_sum(ag);
    bg = row_sum(bg);
    if (cg == 0) {
      const R qu = d.lu[r] + bg;
      w.Qx[r] = d.lx[r] + ag;
      w.Qu[r] = qu;
      w.W[r][2 * NX] = qu;
    }
  }
  mbar_arrive(stage_empty);   // the last read of the stage is behind us
  consumer_sync();
  solve_and_update(w, tid, r, cg, c0, K_bt, dU_bt, dv1, dv2, okb);
}

template <typename R>
__global__ void __launch_bounds__(NTHREADS, MinBlocks<R>::value)
riccati_hkd_kernel(const int* __restrict__ kind, const R* __restrict__ X,
                   const R* __restrict__ U,
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
                   const R* __restrict__ reg,
                   const int* __restrict__ last_node,
                   const R* __restrict__ dt,
                   const unsigned char* __restrict__ active,
                   R* __restrict__ dU,
                   R* __restrict__ K, R* __restrict__ dv1_out,
                   R* __restrict__ dv2_out,
                   unsigned char* __restrict__ ok_out, int T, int u_rows,
                   int ur_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<R>& s = *reinterpret_cast<Smem<R>*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  // a retry sweep: a scenario that is done returns before its first load
  // and writes nothing (its outputs stay those of an earlier sweep)
  if (active != nullptr && !active[b]) return;
  const size_t Tn = (size_t)T + 1;
  constexpr size_t M = NX * NX;
  const int* kind_b = kind + b * T;
  const int last = last_node[b];

  if (tid == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(&s.full[i], 32);       // every producer lane
      mbar_init(&s.empty[i], NCONS);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= PRODUCER_WARP * 32) {
    // ---- producer warp: the entry formulas, ahead of the consumers ----
    const int lane = tid - PRODUCER_WARP * 32;
    const R* X_b = X + b * Tn * NX;
    const R* U_b = U + b * (size_t)u_rows * NX;
    const R* c_b = contact + b * T * 4;
    const R* cn_b = contact_next + b * T * 4;
    const R* xr_b = xr + b * Tn * NX;
    const R* ur_b = ur + b * (size_t)ur_rows * NX;
    const R* fr_b = foot_r + b * Tn * 12;
    const R* rbd_b = reb_delta + b * T * 20;
    const R* rbe_b = reb_eps + b * T * 20;
    const R* tc_b = term_contact + b * Tn * 4;
    const R* td_b = td_mask + b * Tn * 4;
    const R* sig_b = al_sigma + b * Tn * 4;
    const R* lam_b = al_lambda + b * Tn * 4;
    const R* tm_b = term_mask + b * Tn;
    const R* def_b = defect + b * Tn * NX;
    const R dt_b = dt[b];

    // terminal partials of node n into a stage's tile
    auto phi = [&](Stage<R>& st, size_t n) {
      produce_phi(s.sc, st.tile.phix, st.tile.phixx, lane, X_b + n * NX,
                  xr_b + n * NX, fr_b + n * 12, tc_b + n * 4, td_b + n * 4,
                  sig_b + n * 4, lam_b + n * 4, tm_b[n]);
    };

    int item = 0;
    for (int t = T - 1; t >= 0; --t) {
      const int kd = kind_b[t];
      const size_t st_ = (size_t)t;
      if (last == t + 1) {   // SEED item: phi(last)
        const RingPos pos(item++, NSTAGE);
        mbar_wait(&s.empty[pos.stage], pos.parity ^ 1);
        phi(s.ring[pos.stage], st_ + 1);
        mbar_arrive(&s.full[pos.stage]);
      }
      if (kd == KIND_DYN) {
        const RingPos pos(item++, NSTAGE);
        mbar_wait(&s.empty[pos.stage], pos.parity ^ 1);
        produce_dyn(s.sc, s.ring[pos.stage], lane, X_b + st_ * NX,
                    U_b + st_ * NX, xr_b + st_ * NX, ur_b + st_ * NX,
                    fr_b + st_ * 12, c_b + st_ * 4, rbd_b + st_ * 20,
                    rbe_b + st_ * 20, def_b + (st_ + 1) * NX, dt_b);
        mbar_arrive(&s.full[pos.stage]);
      } else {
        if (kd == KIND_RESET) {
          const RingPos pos(item++, NSTAGE);
          mbar_wait(&s.empty[pos.stage], pos.parity ^ 1);
          Stage<R>& st = s.ring[pos.stage];
          phi(st, st_);
          produce_px(s.sc, st.tile.Px, lane, c_b + st_ * 4, cn_b + st_ * 4);
          if (lane < NX) st.dnext[lane] = def_b[(st_ + 1) * NX + lane];
          mbar_arrive(&s.full[pos.stage]);
        }
        const size_t bt = b * T + t;
        zero_gain_rows(K + bt * M, dU + bt * NX, lane);
      }
    }
    return;
  }

  // ---- consumers ----
  Work<R>& w = s.w;
  const int r = tid >> 2, cg = tid & 3, c0 = TC * cg;
  const R reg_b = reg[b];
  const R dt_b = dt[b];
  const Pattern pat(r, c0);
  R dv1 = R(0), dv2 = R(0);   // meaningful in thread 0
  bool okb = true;              // meaningful in warp 0

  {
    const R zero[TC] = {R(0), R(0), R(0), R(0), R(0), R(0)};
    st6(&w.H[r][c0], zero);
    if (cg == 0) w.G[r] = R(0);
  }
  consumer_sync();

  int item = 0;
  int kd_next = kind_b[T - 1];
  for (int t = T - 1; t >= 0; --t) {
    const int kd = kd_next;
    if (t > 0) kd_next = kind_b[t - 1];   // in flight during this step
    if (last == t + 1) {
      // seed the carry with phi(t+1) at the scenario's last active node
      const RingPos pos(item++, NSTAGE);
      const TileData<R>& tile = s.ring[pos.stage].tile;
      mbar_wait(&s.full[pos.stage], pos.parity);
      R h[TC], p[TC];
      ld6(&w.H[r][c0], h);
      ld6(tile.phixx + r * NX + c0, p);
#pragma unroll
      for (int j = 0; j < TC; ++j) h[j] += p[j];
      st6(&w.H[r][c0], h);
      if (cg == 0) w.G[r] += tile.phix[r];
      mbar_arrive(&s.empty[pos.stage]);
      consumer_sync();
    }
    if (kd == KIND_DYN) {
      const RingPos pos(item++, NSTAGE);
      mbar_wait(&s.full[pos.stage], pos.parity);
      const size_t bt = b * T + t;
      dyn_step(w, s.ring[pos.stage], &s.empty[pos.stage], reg_b, dt_b, pat,
               tid, r, cg, c0, K + bt * M, dU + bt * NX, dv1, dv2, okb);
    } else if (kd == KIND_RESET) {
      const RingPos pos(item++, NSTAGE);
      mbar_wait(&s.full[pos.stage], pos.parity);
      const Stage<R>& st = s.ring[pos.stage];
      reset_step(w, st.tile.Px, st.tile.phixx, st.tile.phix, st.dnext,
                 &s.empty[pos.stage], r, cg, c0);
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
  st = cudaFuncSetAttribute(riccati_hkd_kernel<R>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)sizeof(Smem<R>));
  if (st == cudaSuccess && dev < 64) done |= 1ull << dev;
  return st;
}

template <typename R>
int launch(const int* kind, const R* X, const R* U, const R* contact,
           const R* contact_next, const R* xr, const R* ur, const R* foot_r,
           const R* reb_delta, const R* reb_eps, const R* term_contact,
           const R* td_mask, const R* al_sigma, const R* al_lambda,
           const R* term_mask, const R* defect, const R* reg,
           const int* last_node, const R* dt, const unsigned char* active,
           R* dU, R* K, R* dv1, R* dv2, unsigned char* ok, int B, int T,
           int u_rows, int ur_rows, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const cudaError_t st = configure<R>();
  if (st != cudaSuccess) return static_cast<int>(st);
  riccati_hkd_kernel<R><<<B, NTHREADS, sizeof(Smem<R>),
                          static_cast<cudaStream_t>(stream)>>>(
      kind, X, U, contact, contact_next, xr, ur, foot_r, reb_delta, reb_eps,
      term_contact, td_mask, al_sigma, al_lambda, term_mask, defect, reg,
      last_node, dt, active, dU, K, dv1, dv2, ok, T, u_rows, ur_rows);
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
      blocks_per_sm, riccati_hkd_kernel<R>, NTHREADS, sizeof(Smem<R>)));
}

}  // namespace

// The C interface: riccati_hkd_launch / _info run the float32
// instantiation, riccati_hkd_launch_f64 / _info_f64 the float64 one.
#define HKD_PARAMS(R)                                                       \
  const int *kind, const R *X, const R *U, const R *contact,                \
      const R *contact_next, const R *xr, const R *ur, const R *foot_r,     \
      const R *reb_delta, const R *reb_eps, const R *term_contact,          \
      const R *td_mask, const R *al_sigma, const R *al_lambda,              \
      const R *term_mask, const R *defect, const R *reg,                    \
      const int *last_node, const R *dt, const unsigned char *active,       \
      R *dU, R *K, R *dv1, R *dv2, unsigned char *ok, int B, int T,         \
      int u_rows, int ur_rows, void *stream
#define HKD_ARGS                                                            \
  kind, X, U, contact, contact_next, xr, ur, foot_r, reb_delta, reb_eps,    \
      term_contact, td_mask, al_sigma, al_lambda, term_mask, defect, reg,   \
      last_node, dt, active, dU, K, dv1, dv2, ok, B, T, u_rows, ur_rows,    \
      stream

extern "C" int riccati_hkd_launch(HKD_PARAMS(float)) {
  return launch<float>(HKD_ARGS);
}

extern "C" int riccati_hkd_launch_f64(HKD_PARAMS(double)) {
  return launch<double>(HKD_ARGS);
}

extern "C" int riccati_hkd_info(int* threads, int* smem_bytes,
                                int* blocks_per_sm) {
  return info<float>(threads, smem_bytes, blocks_per_sm);
}

extern "C" int riccati_hkd_info_f64(int* threads, int* smem_bytes,
                                    int* blocks_per_sm) {
  return info<double>(threads, smem_bytes, blocks_per_sm);
}

extern "C" const char* riccati_hkd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
