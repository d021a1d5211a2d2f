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
// (reb_derivs) term for term, each entry summed in the same order.
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

#include "hkd_constants.cuh"
#include "riccati_step.cuh"

namespace {

using namespace riccati;

// The model and weight constants of the instantiation's type: K_* (float32)
// or KD_* (the exact float64 values) of the generated header.
#define HKD_CONSTANTS(P, T)                                                  \
  static __device__ __forceinline__ T IINV(int i) { return P##_IINV[i]; }   \
  static __device__ __forceinline__ T IDIAG(int i) { return P##_IDIAG[i]; } \
  static __device__ __forceinline__ T HIP(int l, int j) {                   \
    return P##_HIP[l][j];                                                   \
  }                                                                         \
  static __device__ __forceinline__ T L1S(int l) { return P##_L1S[l]; }     \
  static __device__ __forceinline__ T Q_BODY(int i) {                       \
    return P##_Q_BODY[i];                                                   \
  }                                                                         \
  static __device__ __forceinline__ T QF(int i) { return P##_QF[i]; }       \
  static __device__ __forceinline__ T WFOOT(int j) { return P##_WFOOT[j]; } \
  static constexpr T INV_MASS = P##_INV_MASS, L2 = P##_L2, L3 = P##_L3,     \
                     Q_SWING_LEG = P##_Q_SWING_LEG, QF_LEG = P##_QF_LEG,    \
                     R_GRF = P##_R_GRF, R_QJD = P##_R_QJD, TF2 = P##_TF2,   \
                     MU = P##_MU, MU2 = P##_MU2;

template <typename R> struct Model;
template <> struct Model<float> { HKD_CONSTANTS(K, float) };
template <> struct Model<double> { HKD_CONSTANTS(KD, double) };

constexpr int NSTAGE = 3;
constexpr int ND = 6;   // rows of DA with computed entries: eul 0:3, omega 6:9
                        // (rows 3:6 are d(pos)/dt = vel: one constant each)

// ---------------------------------------------------------------------------
// ring items
// ---------------------------------------------------------------------------

// Offsets into DynData::q, the non-zeros of lxx and luu behind one zero.
constexpr int Q_ZERO = 0;
constexpr int Q_LXXD = 1;            // 24: diagonal of lxx
constexpr int Q_LXC = Q_LXXD + NX;   // 8: lxx[12+3l+j][3+j] (symmetric), j < 2
constexpr int Q_LUUD = Q_LXC + 8;    // 24: diagonal of luu
constexpr int Q_HXZ = Q_LUUD + NX;   // 4: luu[3l][3l+2] (symmetric)
constexpr int Q_HYZ = Q_HXZ + 4;     // 4: luu[3l+1][3l+2] (symmetric)
constexpr int Q_SIZE = 68;

// A DYN step in compact form.
template <typename R>
struct DynData {
  R D[ND][NX];     // dt * DA rows 0, 1, 2, 6, 7, 8
  R Bc[4][NX];     // B by column i: rows 6..8 (zero for i >= 12), then
                       // the column's entry in row b_single_row(i)
  R lx[NX], lu[NX];
  R q[Q_SIZE];
};

// RESET: Px = I + S and the terminal partials of node t. SEED: the terminal
// partials of the last active node (Px unused).
template <typename R>
struct TileData {
  R Px[NX * NX];
  R phixx[NX * NX];
  R phix[NX];
};

template <typename R>
struct __align__(16) Stage {
  union {
    DynData<R> dyn;
    TileData<R> tile;
  };
  R dnext[NX];     // defect[t+1]
};

// The producer warp's own scratch.
template <typename R>
struct __align__(16) Scratch {
  R x[NX], u[NX], xr[NX], ur[NX], fr[12];
  R c[4], cn[4], rbd[20], rbe[20];
  R tc[4], td[4], sig[4], lam[4];
  R cs[3][2];                // cos, sin of yaw, pitch, roll
  R Rot[3][3], dR[3][3][3];
  R m[3], Fc[3];
  R Dk[20], Hk[20];          // cone rows: c[l] * (ReB first, second deriv.)
  R pf[4][3], J[4][3][3];    // per leg: hip-frame foot position, Jacobian
  R val[4][7], w1[4], w2[4]; // per leg: foot-height row and AL weights
};

template <typename R>
struct __align__(16) Smem {
  Work<R> w;
  Stage<R> ring[NSTAGE];
  Scratch<R> sc;
  uint64_t full[NSTAGE];
  uint64_t empty[NSTAGE];
};

// ---------------------------------------------------------------------------
// entry formulas
// ---------------------------------------------------------------------------

template <typename R>
__device__ __forceinline__ void mm3(const R A[3][3], const R B[3][3],
                                    R C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      R s = A[i][0] * B[0][j];
      s = s + A[i][1] * B[1][j];
      s = s + A[i][2] * B[2][j];
      C[i][j] = s;
    }
}

// _rot_entries of the node in sc.x, by the whole warp: lanes 0..2 take the
// cosine and sine of one angle each; then lane q < 4 forms one of
// R = Rz Ry Rx (q = 0) and dR/d(yaw, pitch, roll) (q = 1, 2, 3: the q-th
// factor replaced by its derivative), each as (Mz My) Mx. Ends synchronized.
template <typename R>
__device__ void produce_rot(Scratch<R>& sc, int lane) {
  if (lane < 3) {
    sc.cs[lane][0] = rcos(sc.x[lane]);
    sc.cs[lane][1] = rsin(sc.x[lane]);
  }
  __syncwarp();
  if (lane < 4) {
    const R cy = sc.cs[0][0], sy = sc.cs[0][1];
    const R cp = sc.cs[1][0], sp = sc.cs[1][1];
    const R cr = sc.cs[2][0], sr = sc.cs[2][1];
    const R Rz[3][3] = {{cy, -sy, R(0)}, {sy, cy, R(0)}, {R(0), R(0), R(1)}};
    const R Ry[3][3] = {{cp, R(0), sp}, {R(0), R(1), R(0)}, {-sp, R(0), cp}};
    const R Rx[3][3] = {{R(1), R(0), R(0)}, {R(0), cr, -sr}, {R(0), sr, cr}};
    const R dRz[3][3] = {{-sy, -cy, R(0)}, {cy, -sy, R(0)}, {R(0), R(0), R(0)}};
    const R dRy[3][3] = {{-sp, R(0), cp}, {R(0), R(0), R(0)}, {-cp, R(0), -sp}};
    const R dRx[3][3] = {{R(0), R(0), R(0)}, {R(0), -sr, -cr}, {R(0), cr, -sr}};
    R Mz[3][3], My[3][3], Mx[3][3], T1[3][3], out[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        Mz[i][j] = lane == 1 ? dRz[i][j] : Rz[i][j];
        My[i][j] = lane == 2 ? dRy[i][j] : Ry[i][j];
        Mx[i][j] = lane == 3 ? dRx[i][j] : Rx[i][j];
      }
    mm3(Mz, My, T1);
    mm3(T1, Mx, out);
    R* dst = lane == 0 ? &sc.Rot[0][0] : &sc.dR[lane - 1][0][0];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) dst[3 * i + j] = out[i][j];
  }
  __syncwarp();
}

// _leg_fk_entries: hip-frame foot position p and its joint Jacobian J
template <typename R>
__device__ void leg_fk_entries(R q1, R q2, R q3, int leg,
                               R p[3], R J[3][3]) {
  const R l1 = Model<R>::L1S(leg), l2 = Model<R>::L2, l3 = Model<R>::L3;
  const R s1 = rsin(q1), c1 = rcos(q1);
  const R s2 = rsin(q2), c2 = rcos(q2);
  const R s23 = rsin(q2 + q3), c23 = rcos(q2 + q3);
  const R ext = l3 * c23 + l2 * c2;
  const R flx = l3 * s23 + l2 * s2;
  p[0] = flx;
  p[1] = l1 * c1 + s1 * ext;
  p[2] = l1 * s1 - c1 * ext;
  J[0][0] = R(0);   J[0][1] = ext;        J[0][2] = l3 * c23;
  J[1][0] = -p[2]; J[1][1] = -s1 * flx;  J[1][2] = -s1 * l3 * s23;
  J[2][0] = p[1];  J[2][1] = c1 * flx;   J[2][2] = c1 * l3 * s23;
}

template <typename R>
__device__ __forceinline__ R dot3c(const R a0, const R a1, const R a2,
                                   const R b0, const R b1, const R b2) {
  R s = a0 * b0;
  s = s + a1 * b1;
  s = s + a2 * b2;
  return s;
}

// column j of the cross-product matrix of v,
// {{0, -v2, v1}, {v2, 0, -v0}, {-v1, v0, 0}}
template <typename R>
__device__ __forceinline__ void skew_column(const R* v, int j, R& o0,
                                            R& o1, R& o2) {
  const R v0 = v[0], v1 = v[1], v2 = v[2];
  o0 = j == 0 ? R(0) : (j == 1 ? -v2 : v1);
  o1 = j == 0 ? v2 : (j == 1 ? R(0) : -v0);
  o2 = j == 0 ? -v1 : (j == 1 ? v0 : R(0));
}

// solver/costs.py:reb_derivs
template <typename R>
__device__ __forceinline__ void reb_derivs(R g, R delta, R eps,
                                           R& d1, R& d2) {
  const bool act = g > delta;
  const R g_safe = act ? g : R(1);
  const R a = act ? -R(1) / g_safe : (g - R(2) * delta) / (delta * delta);
  const R b = act ? R(1) / (g_safe * g_safe) : R(1) / (delta * delta);
  d1 = eps * a;
  d2 = eps * b;
}

// The row of B that holds column i's entry outside rows 6..8: the velocity
// row 9 + i % 3 of a force column, the own row of a joint-velocity column.
__device__ __forceinline__ int b_single_row(int i) {
  return i < 12 ? 9 + i % 3 : i;
}

// dyn_jac_entries, column `col` of the rows 0..2 of DA (the Euler-angle
// rates): the four columns that divide share one piece of code
template <typename R>
__device__ void da_eul_column(const Scratch<R>& sc, int col, R out[3]) {
  out[0] = out[1] = R(0);
  out[2] = col == 6 ? R(1) : R(0);
  if (col == 1 || col == 2 || col == 7 || col == 8) {
    const R cp = sc.cs[1][0], sp = sc.cs[1][1];
    const R cr = sc.cs[2][0], sr = sc.cs[2][1];
    const R wy = sc.x[7], wz = sc.x[8];
    const R s_ = sr * wy + cr * wz;
    const R t_ = cr * wy - sr * wz;
    // col 1: s_ sp / cp^2,  0,  s_ / cp^2      col 2: t_ / cp, -s_, t_ sp / cp
    // col 7: sr / cp,      cr,  sr sp / cp     col 8: cr / cp, -sr, cr sp / cp
    const R n = col == 1 ? s_ : (col == 2 ? t_ : (col == 7 ? sr : cr));
    const R den = col == 1 ? cp * cp : cp;
    out[0] = (col == 1 ? n * sp : n) / den;
    out[1] = col == 1 ? R(0) : (col == 2 ? -s_ : (col == 7 ? cr : -sr));
    out[2] = (col == 1 ? n : n * sp) / den;
  }
}

// scale * IINV[i] * (M[:, i] . v), i < 3: the rows 6..8 (angular
// acceleration) of a Jacobian column whose moment arm or force is v, through
// the rotation M (R, or dR/d angle)
template <typename R>
__device__ __forceinline__ void rotated_column(const R (*M)[3], R scale,
                                               R v0, R v1, R v2, R out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = scale * Model<R>::IINV(i) *
             dot3c(M[0][i], M[1][i], M[2][i], v0, v1, v2);
}

// dyn_jac_entries, column `col` of the rows 6..8 of DA into out[0..2]; sc
// holds x, u, c, the rotation, and the moment and force sums m, Fc
template <typename R>
__device__ void da_omega_column(const Scratch<R>& sc, int col, R out[3]) {
  const R (*M)[3] = sc.Rot;
  R scale = R(1), v0 = R(0), v1 = R(0), v2 = R(0);
  if (col < 3) {                     // d/d angle: dR' m
    M = sc.dR[col];
    v0 = sc.m[0]; v1 = sc.m[1]; v2 = sc.m[2];
  } else if (col < 6) {              // d/d pos: R' [Fc]x
    skew_column(sc.Fc, col - 3, v0, v1, v2);
  } else if (col >= 12 && (col - 12) % 3 != 2) {
    // d/d foot x, y of leg l: ex x f = (0, -fz, fy), ey x f = (fz, 0, -fx)
    const int l = (col - 12) / 3;
    const bool ax = (col - 12) % 3 == 0;
    const R* f = sc.u + 3 * l;
    scale = sc.c[l];
    v0 = ax ? R(0) : f[2];
    v1 = ax ? -f[2] : R(0);
    v2 = ax ? f[1] : -f[0];
  } else {
    scale = R(0);                     // vel, foot z: no entry; omega: below
  }
  rotated_column(M, scale, v0, v1, v2, out);
  if (col >= 6 && col < 9) {         // d/d omega: the gyroscopic term
    const int j = col - 6;
    const R* w = sc.x + 6;
    const R Iw[3] = {Model<R>::IDIAG(0) * w[0], Model<R>::IDIAG(1) * w[1],
                     Model<R>::IDIAG(2) * w[2]};
    R wx[3], iwx[3];
    skew_column(w, j, wx[0], wx[1], wx[2]);
    skew_column(Iw, j, iwx[0], iwx[1], iwx[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      out[i] = Model<R>::IINV(i) * (-(wx[i] * Model<R>::IDIAG(j)) + iwx[i]);
  }
}

// dyn_jac_entries, column i of DB: out[k], k < 3, the entry of row 6 + k;
// out[3] the entry of row b_single_row(i)
template <typename R>
__device__ void db_column(const Scratch<R>& sc, int i, R out[4]) {
  const int l = i < 12 ? i / 3 : (i - 12) / 3;
  const R cl = sc.c[l];
  R v0 = R(0), v1 = R(0), v2 = R(0);
  if (i < 12) {                      // the force's moment: R' [r_l]x
    const R rl[3] = {sc.x[12 + 3 * l] - sc.x[3],
                         sc.x[12 + 3 * l + 1] - sc.x[4], -sc.x[5]};
    skew_column(rl, i % 3, v0, v1, v2);
  }
  rotated_column(sc.Rot, i < 12 ? cl : R(0), v0, v1, v2, out);
  out[3] = i < 12 ? cl * Model<R>::INV_MASS : R(1) - cl;
}

// the foot-regularization residual of leg l, axis j < 2 (sc.x, sc.xr, sc.fr)
template <typename R>
__device__ __forceinline__ R foot_residual(const Scratch<R>& sc, int l,
                                           int j) {
  return (sc.x[12 + 3 * l + j] - sc.x[3 + j])
         - (sc.fr[3 * l + j] - sc.xr[3 + j]);
}

// One DYN ring item: loads step t's slices, then every lane its entries
// (lane = column for the Jacobian blocks, lane = index for the partials).
template <typename R>
__device__ void produce_dyn(Scratch<R>& sc, Stage<R>& st, int lane,
                            const R* X_t, const R* U_t,
                            const R* xr_t, const R* ur_t,
                            const R* fr_t, const R* c_t,
                            const R* rbd_t, const R* rbe_t,
                            const R* def_next, R dt_b) {
  DynData<R>& d = st.dyn;
  __syncwarp();   // the scratch is free: every lane is done with the last item
  if (lane < NX) {
    sc.x[lane] = X_t[lane];
    sc.u[lane] = U_t[lane];
    sc.xr[lane] = xr_t[lane];
    sc.ur[lane] = ur_t[lane];
    st.dnext[lane] = def_next[lane];
  }
  if (lane < 12) sc.fr[lane] = fr_t[lane];
  if (lane < 4) sc.c[lane] = c_t[lane];
  if (lane < 20) {
    sc.rbd[lane] = rbd_t[lane];
    sc.rbe[lane] = rbe_t[lane];
  }
  __syncwarp();

  if (lane == 4) {
    // net moment and force of the stance legs
    R f[4][3], r[4][3];
    for (int l = 0; l < 4; ++l) {
      for (int j = 0; j < 3; ++j) f[l][j] = sc.u[3 * l + j];
      r[l][0] = sc.x[12 + 3 * l] - sc.x[3];
      r[l][1] = sc.x[12 + 3 * l + 1] - sc.x[4];
      r[l][2] = -sc.x[5];
    }
    for (int k = 0; k < 3; ++k) {
      R s = R(0);
      for (int l = 0; l < 4; ++l)
        s = s + sc.c[l] * (r[l][(k + 1) % 3] * f[l][(k + 2) % 3]
                           - r[l][(k + 2) % 3] * f[l][(k + 1) % 3]);
      sc.m[k] = s;
    }
    for (int j = 0; j < 3; ++j) {
      R s = R(0);
      for (int l = 0; l < 4; ++l) s = s + sc.c[l] * f[l][j];
      sc.Fc[j] = s;
    }
  } else if (lane >= 8 && lane < 28) {
    // one GRF cone row: ReB derivatives
    const int row = lane - 8, l = row / 5, k = row % 5;
    const R fx = sc.u[3 * l], fy = sc.u[3 * l + 1], fz = sc.u[3 * l + 2];
    const R g = k == 0 ? fz
                  : k == 1 ? -fx + Model<R>::MU * fz
                  : k == 2 ? fx + Model<R>::MU * fz
                  : k == 3 ? -fy + Model<R>::MU * fz
                           : fy + Model<R>::MU * fz;
    R a1, a2;
    reb_derivs(g, sc.rbd[row], sc.rbe[row], a1, a2);
    sc.Dk[row] = sc.c[l] * a1;
    sc.Hk[row] = sc.c[l] * a2;
  }
  produce_rot(sc, lane);

  if (lane < NX) {
    R e[3], o[3], bcol[4];
    da_eul_column(sc, lane, e);
    da_omega_column(sc, lane, o);
    db_column(sc, lane, bcol);
    for (int i = 0; i < 3; ++i) {
      d.D[i][lane] = dt_b * e[i];
      d.D[3 + i][lane] = dt_b * o[i];
    }
    for (int k = 0; k < 4; ++k) d.Bc[k][lane] = dt_b * bcol[k];
  }

  // running_partial_entries with the ReB rows; mdt = dt at a DYN transition
  const R mdt = dt_b;
  if (lane < NX) {
    const int i = lane;
    R lx, lxxd, lu, luud;
    if (i < 12) {
      lx = mdt * Model<R>::Q_BODY(i) * (sc.x[i] - sc.xr[i]);
      lxxd = mdt * Model<R>::Q_BODY(i);
      if (i == 3 || i == 4) {
        const int j = i - 3;
        for (int l = 0; l < 4; ++l) {
          const R Wl = Model<R>::WFOOT(j) * sc.c[l];
          lx += -mdt * Wl * foot_residual(sc, l, j);
          lxxd += mdt * Wl;
        }
      }
      const int l = i / 3, a = i % 3;
      const R* D = sc.Dk + 5 * l;
      const R* Hh = sc.Hk + 5 * l;
      lu = mdt * Model<R>::R_GRF * (sc.u[i] - sc.ur[i]);
      luud = mdt * Model<R>::R_GRF;
      if (a == 0) {
        lu += mdt * (-D[1] + D[2]);
        luud += mdt * (Hh[1] + Hh[2]);
      } else if (a == 1) {
        lu += mdt * (-D[3] + D[4]);
        luud += mdt * (Hh[3] + Hh[4]);
      } else {
        lu += mdt * (D[0] + Model<R>::MU * (D[1] + D[2] + D[3] + D[4]));
        luud += mdt * (Hh[0] + Model<R>::MU2 * (Hh[1] + Hh[2] + Hh[3] + Hh[4]));
      }
    } else {
      const int l = (i - 12) / 3, j = (i - 12) % 3;
      const R w = Model<R>::Q_SWING_LEG * (R(1) - sc.c[l]);
      lx = mdt * w * (sc.x[i] - sc.xr[i]);
      lxxd = mdt * w;
      if (j < 2) {
        const R Wl = Model<R>::WFOOT(j) * sc.c[l];
        lx += mdt * Wl * foot_residual(sc, l, j);
        lxxd += mdt * Wl;
        d.q[Q_LXC + 2 * l + j] = -mdt * Wl;
      }
      lu = mdt * Model<R>::R_QJD * (sc.u[i] - sc.ur[i]);
      luud = mdt * Model<R>::R_QJD;
    }
    d.lx[i] = lx;
    d.lu[i] = lu;
    d.q[Q_LXXD + i] = lxxd;
    d.q[Q_LUUD + i] = luud;
  } else if (lane < NX + 4) {
    const int l = lane - NX;
    const R* Hh = sc.Hk + 5 * l;
    d.q[Q_HXZ + l] = mdt * Model<R>::MU * (Hh[2] - Hh[1]);
    d.q[Q_HYZ + l] = mdt * Model<R>::MU * (Hh[4] - Hh[3]);
  } else if (lane == NX + 4) {
    d.q[Q_ZERO] = R(0);
  }
}

// index of foot-height row entry a < 7 of leg l in the state
__device__ __forceinline__ int height_index(int l, int a) {
  return a < 3 ? a : (a == 3 ? 5 : 12 + 3 * l + (a - 4));
}

// terminal_partial_entries (AL on) of node n into phix / phixx (a dense
// 24 x 24 tile), and the node's rotation and leg kinematics into the
// scratch. tm = term_mask[n]; tc, td, sig, lam: the node's term_contact,
// td_mask, al_sigma, al_lambda rows.
template <typename R>
__device__ void produce_phi(Scratch<R>& sc, R* phix, R* phixx, int lane,
                            const R* X_n, const R* xr_n,
                            const R* fr_n, const R* tc_n,
                            const R* td_n, const R* sig_n,
                            const R* lam_n, R tm) {
  __syncwarp();   // the scratch is free: every lane is done with the last item
  if (lane < NX) {
    sc.x[lane] = X_n[lane];
    sc.xr[lane] = xr_n[lane];
  }
  if (lane < 12) sc.fr[lane] = fr_n[lane];
  if (lane < 4) {
    sc.tc[lane] = tc_n[lane];
    sc.td[lane] = td_n[lane];
    sc.sig[lane] = sig_n[lane];
    sc.lam[lane] = lam_n[lane];
  }
  warp_zero(phixx, NX * NX, lane);
  __syncwarp();
  produce_rot(sc, lane);
  if (lane < 4) {
    // one leg: kinematics, world foot height h = pos_z + R[2,:] . pf, the
    // AL weights and the foot-height row (d/d eul, d/d pos_z, d/d qleg)
    const int l = lane;
    R p[3], J[3][3];
    leg_fk_entries(sc.x[12 + 3 * l], sc.x[13 + 3 * l], sc.x[14 + 3 * l], l, p,
                   J);
    const R pf[3] = {p[0] + Model<R>::HIP(l, 0), p[1] + Model<R>::HIP(l, 1),
                     p[2] + Model<R>::HIP(l, 2)};
    for (int i = 0; i < 3; ++i) {
      sc.pf[l][i] = pf[i];
      for (int j = 0; j < 3; ++j) sc.J[l][i][j] = J[i][j];
    }
    const R mask = tm * sc.td[l];
    const R h = sc.x[5] + dot3c(sc.Rot[2][0], sc.Rot[2][1], sc.Rot[2][2],
                                    pf[0], pf[1], pf[2]);
    sc.w1[l] = mask * (sc.sig[l] * h + sc.lam[l]);
    sc.w2[l] = mask * (sc.sig[l] * (R(1) + h) + sc.lam[l]);
    for (int ang = 0; ang < 3; ++ang)
      sc.val[l][ang] = dot3c(sc.dR[ang][2][0], sc.dR[ang][2][1],
                             sc.dR[ang][2][2], pf[0], pf[1], pf[2]);
    sc.val[l][3] = R(1);
    for (int j = 0; j < 3; ++j)
      sc.val[l][4 + j] = dot3c(sc.Rot[2][0], sc.Rot[2][1], sc.Rot[2][2],
                               J[0][j], J[1][j], J[2][j]);
  }
  __syncwarp();
  if (lane < NX) {
    // tracking and foot regularization: phix, the diagonal of phixx and its
    // foot-regularization cross entries; then the AL rows of phix
    const int i = lane;
    R px, pd;
    if (i < 12) {
      px = tm * Model<R>::QF(i) * (sc.x[i] - sc.xr[i]);
      pd = tm * Model<R>::QF(i);
      if (i == 3 || i == 4) {
        const int j = i - 3;
        for (int l = 0; l < 4; ++l) {
          const R Wl = Model<R>::WFOOT(j) * sc.tc[l];
          px += -tm * Model<R>::TF2 * Wl * foot_residual(sc, l, j);
          pd += tm * Model<R>::TF2 * Wl;
        }
      }
      if (i < 3 || i == 5) {
        const int a = i < 3 ? i : 3;
        for (int l = 0; l < 4; ++l) px += sc.w1[l] * sc.val[l][a];
      }
    } else {
      const int l = (i - 12) / 3, j = (i - 12) % 3;
      const R w = Model<R>::QF_LEG * (R(1) - sc.tc[l]);
      px = tm * w * (sc.x[i] - sc.xr[i]);
      pd = tm * w;
      if (j < 2) {
        const R Wl = Model<R>::WFOOT(j) * sc.tc[l];
        px += tm * Model<R>::TF2 * Wl * foot_residual(sc, l, j);
        pd += tm * Model<R>::TF2 * Wl;
        phixx[i * NX + 3 + j] = -tm * Model<R>::TF2 * Wl;
        phixx[(3 + j) * NX + i] = -tm * Model<R>::TF2 * Wl;
      }
      px += sc.w1[l] * sc.val[l][4 + j];
    }
    phix[i] = px;
    phixx[i * NX + i] = pd;
  }
  __syncwarp();
  // the AL blocks, leg after leg (their entries overlap on eul and pos_z)
  for (int l = 0; l < 4; ++l) {
    for (int e = lane; e < 49; e += 32) {
      const int a = e / 7, b = e % 7;
      phixx[height_index(l, a) * NX + height_index(l, b)] +=
          sc.w2[l] * sc.val[l][a] * sc.val[l][b];
    }
    __syncwarp();
  }
}

// reset_jac_entries: Px = I + S of step t into a dense 24 x 24 tile; the
// rotation and leg kinematics of node t are in the scratch (produce_phi)
template <typename R>
__device__ void produce_px(Scratch<R>& sc, R* Px, int lane,
                           const R* c_t, const R* cn_t) {
  if (lane < 4) {
    sc.c[lane] = c_t[lane];
    sc.cn[lane] = cn_t[lane];
  }
  warp_zero(Px, NX * NX, lane);
  __syncwarp();
  if (lane < 4) {
    const int l = lane, r0 = 12 + 3 * l;
    const R to_swing = sc.c[l] * (R(1) - sc.cn[l]);
    const R to_stance = (R(1) - sc.c[l]) * sc.cn[l];
    const R keep = R(1) - to_swing - to_stance;
    const R* pf = sc.pf[l];
    for (int i = 0; i < 2; ++i) {
      for (int ang = 0; ang < 3; ++ang)
        Px[(r0 + i) * NX + ang] += to_stance *
            dot3c(sc.dR[ang][i][0], sc.dR[ang][i][1], sc.dR[ang][i][2],
                  pf[0], pf[1], pf[2]);
      Px[(r0 + i) * NX + 3 + i] += to_stance * R(1);
      for (int j = 0; j < 3; ++j)
        Px[(r0 + i) * NX + r0 + j] += to_stance *
            dot3c(sc.Rot[i][0], sc.Rot[i][1], sc.Rot[i][2], sc.J[l][0][j],
                  sc.J[l][1][j], sc.J[l][2][j]);
    }
    for (int j = 0; j < 3; ++j)
      Px[(r0 + j) * NX + r0 + j] += (keep - R(1)) * R(1);
  }
  __syncwarp();
  if (lane < NX) Px[lane * NX + lane] = R(1) + Px[lane * NX + lane];
}

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
