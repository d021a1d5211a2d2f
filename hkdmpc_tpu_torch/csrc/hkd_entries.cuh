// The HKD model's entry formulas on the card, shared by the kernels that
// evaluate them: the K1 Riccati sweep (riccati_hkd.cu) and the linear rollout
// (linear_rollout_hkd.cu). The model and weight constants of each scalar
// type, the compact ring items (a DYN step's Jacobian blocks and running
// partials, a RESET step's or a terminal node's dense tiles), the producer
// warp's scratch, and the warp-wide producers of one item each:
// produce_dyn (dt*DA's computed rows, B by column, lx, lu and the non-zeros
// of lxx and luu), produce_phi (the terminal partials of a node) and
// produce_px (Px = I + S of a RESET step). The formulas mirror
// ops/jac_tminor.py, ops/hkd_tminor.py and solver/costs.py term for term;
// riccati_hkd.cu's head comment says how.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace
