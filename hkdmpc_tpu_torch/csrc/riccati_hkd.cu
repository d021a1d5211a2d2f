// Riccati backward sweep of one HS-DDP iteration for a batch of HKD
// scenarios, with the dynamics/reset Jacobians and every cost partial rebuilt
// in-kernel from the nominal trajectory (X, U).
//
// Replaces hkdmpc_tpu/ops/pallas_backward.py:_kernel_hkd (and its step body
// _kernel_hkd_substep), the TPU kernel behind backward_sweep_pallas_hkd.
// Wrapper, plain PyTorch version and launch counter:
// hkdmpc_tpu_torch/ops/riccati_hkd.py.
//
// What it computes, per scenario, for t = T-1 .. 0 with the value carry
// (G 24, H 24x24) held in shared memory:
//   - seed G/H with the terminal partials phi(t+1) at the scenario's last
//     active node (the "phi stash"; phi(T) is computed before the loop);
//   - Gn = G + H * defect[t+1];
//   - phi(t) into the stash when t is a RESET source or the last node;
//   - DYN: A = I + dt*DA, B = dt*DB from the sparse Jacobian entries,
//     running partials (tracking, foot reg, ReB barrier on the 20 GRF cone
//     rows), Q expansion with the per-scenario reg, Gaussian elimination with
//     the PSD gate pivot > 1e-9 on the tableau [Quu | Qux | Qu] and
//     back-substitution, then K = -Quu^-1 Qux, dU = -Quu^-1 Qu and the value
//     update;
//   - RESET: Px = I + S, G = phix(t) + Px' Gn, H = phixx(t) + Px' H Px;
//   - PAD: the value carries through.
// The entry formulas mirror ops/jac_tminor.py (_rot_entries, _leg_fk_entries,
// dyn_jac_entries, reset_jac_entries), ops/hkd_tminor.py
// (running_partial_entries, terminal_partial_entries) and solver/costs.py
// (reb_derivs) line for line. Constants and weights come from the generated
// header hkd_constants.cuh (ops/_build.py writes it from models/). The
// defect correction, the DYN step from the Q expansion on and the RESET
// sandwich are shared with riccati_dense.cu (riccati_step.cuh).
//
// What bounds it on the H100: at B = 4096, T = 75 the sweep writes K,
// B*T*24*24*4 bytes = 708 MB, about 0.2 ms of HBM bandwidth; the real bound
// is the serial chain inside each scenario: 75 steps, each with 24 dependent
// pivots, dense 24-term products and a block-wide barrier between stages.
// The design takes the simple road for both: one 32-thread block per
// scenario (4096 independent blocks fill the 132 SMs several times over, and
// a 32-thread block makes every barrier a single-warp barrier), the whole
// working set (about 29 KB) in shared memory so nothing but X/U slices,
// references and the K/dU rows touch device memory, rows of each product
// and each elimination step spread over the threads, pivots in sequence, and
// K written straight into its (B, T, 24, 24) layout with consecutive threads
// on consecutive addresses. Sparse products, a warp per scenario in
// registers and fewer K bytes are later work.

#include <cuda_runtime.h>

#include "hkd_constants.cuh"
#include "riccati_step.cuh"

namespace {

using namespace riccati;

struct Rot {
  float R[3][3];
  float dR[3][3][3];
  float cp, sp, cr, sr;
};

struct Smem {
  float H[NX][NX];
  float A[NX][NX];     // DYN: I + dt*DA; RESET: Px = I + S
  float B[NX][NX];     // DYN: dt*DB
  float HA[NX][NX];    // H A; later the unsymmetrized value Hessian
  float HB[NX][NX];    // H B; later the symmetrized Qxx
  float Qxx[NX][NX];   // lxx, then lxx + A'HA + reg I
  float Qux[NX][NX];
  float Luu[NX][NX];
  float Pxx[NX][NX];   // phi stash: terminal Hessian
  float W[NX][NW];     // elimination tableau
  float Sol[NX][25];   // Quu^-1 [Qux | Qu]
  float G[NX], Gn[NX], Qx[NX], Qu[NX], Lx[NX], Lu[NX], Px[NX], fac[NX];
  float x[NX], u[NX], xr[NX], ur[NX], dnext[NX], fr[12];
};

__device__ __forceinline__ void mm3(const float A[3][3], const float B[3][3],
                                    float C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = A[i][0] * B[0][j];
      s = s + A[i][1] * B[1][j];
      s = s + A[i][2] * B[2][j];
      C[i][j] = s;
    }
}

// _rot_entries
__device__ void rot_entries(float yaw, float pitch, float roll, Rot& r) {
  const float cy = cosf(yaw), sy = sinf(yaw);
  const float cp = cosf(pitch), sp = sinf(pitch);
  const float cr = cosf(roll), sr = sinf(roll);
  const float Rz[3][3] = {{cy, -sy, 0.f}, {sy, cy, 0.f}, {0.f, 0.f, 1.f}};
  const float Ry[3][3] = {{cp, 0.f, sp}, {0.f, 1.f, 0.f}, {-sp, 0.f, cp}};
  const float Rx[3][3] = {{1.f, 0.f, 0.f}, {0.f, cr, -sr}, {0.f, sr, cr}};
  const float dRz[3][3] = {{-sy, -cy, 0.f}, {cy, -sy, 0.f}, {0.f, 0.f, 0.f}};
  const float dRy[3][3] = {{-sp, 0.f, cp}, {0.f, 0.f, 0.f}, {-cp, 0.f, -sp}};
  const float dRx[3][3] = {{0.f, 0.f, 0.f}, {0.f, -sr, -cr}, {0.f, cr, -sr}};
  float T1[3][3];
  mm3(Rz, Ry, T1);
  mm3(T1, Rx, r.R);
  mm3(dRz, Ry, T1);
  mm3(T1, Rx, r.dR[0]);
  mm3(Rz, dRy, T1);
  mm3(T1, Rx, r.dR[1]);
  mm3(Rz, Ry, T1);
  mm3(T1, dRx, r.dR[2]);
  r.cp = cp; r.sp = sp; r.cr = cr; r.sr = sr;
}

// _leg_fk_entries: hip-frame foot position p and its joint Jacobian J
__device__ void leg_fk_entries(float q1, float q2, float q3, int leg,
                               float p[3], float J[3][3]) {
  const float l1 = K_L1S[leg], l2 = K_L2, l3 = K_L3;
  const float s1 = sinf(q1), c1 = cosf(q1);
  const float s2 = sinf(q2), c2 = cosf(q2);
  const float s23 = sinf(q2 + q3), c23 = cosf(q2 + q3);
  const float ext = l3 * c23 + l2 * c2;
  const float flx = l3 * s23 + l2 * s2;
  p[0] = flx;
  p[1] = l1 * c1 + s1 * ext;
  p[2] = l1 * s1 - c1 * ext;
  J[0][0] = 0.f;   J[0][1] = ext;        J[0][2] = l3 * c23;
  J[1][0] = -p[2]; J[1][1] = -s1 * flx;  J[1][2] = -s1 * l3 * s23;
  J[2][0] = p[1];  J[2][1] = c1 * flx;   J[2][2] = c1 * l3 * s23;
}

__device__ __forceinline__ float dot3c(const float a0, const float a1,
                                       const float a2, const float b0,
                                       const float b1, const float b2) {
  float s = a0 * b0;
  s = s + a1 * b1;
  s = s + a2 * b2;
  return s;
}

// dyn_jac_entries: accumulate DA into A and DB into B (both pre-zeroed)
__device__ void dyn_jac_entries(const float* x, const float* u,
                                const float c[4], const Rot& rot,
                                float DA[NX][NX], float DB[NX][NX]) {
  const float cp = rot.cp, sp = rot.sp, cr = rot.cr, sr = rot.sr;
  const float wx = x[6], wy = x[7], wz = x[8];
  const float px = x[3], py = x[4], pz = x[5];
  float f[4][3], r[4][3];
  for (int l = 0; l < 4; ++l) {
    for (int j = 0; j < 3; ++j) f[l][j] = u[3 * l + j];
    r[l][0] = x[12 + 3 * l] - px;
    r[l][1] = x[12 + 3 * l + 1] - py;
    r[l][2] = -pz;
  }
  const float s_ = sr * wy + cr * wz;
  const float t_ = cr * wy - sr * wz;
  DA[0][1] += s_ * sp / (cp * cp);
  DA[0][2] += t_ / cp;
  DA[1][2] += -s_;
  DA[2][1] += s_ / (cp * cp);
  DA[2][2] += t_ * sp / cp;
  const float E[3][3] = {{0.f, sr / cp, cr / cp},
                         {0.f, cr, -sr},
                         {1.f, sr * sp / cp, cr * sp / cp}};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) DA[i][6 + j] += E[i][j];
    DA[3 + i][9 + i] += 1.f;
  }

  float m[3], Fc[3];
  for (int k = 0; k < 3; ++k) {
    float s = 0.f;
    for (int l = 0; l < 4; ++l)
      s = s + c[l] * (r[l][(k + 1) % 3] * f[l][(k + 2) % 3]
                      - r[l][(k + 2) % 3] * f[l][(k + 1) % 3]);
    m[k] = s;
  }
  for (int j = 0; j < 3; ++j) {
    float s = 0.f;
    for (int l = 0; l < 4; ++l) s = s + c[l] * f[l][j];
    Fc[j] = s;
  }
  const Rot& q = rot;
  for (int i = 0; i < 3; ++i)
    for (int ang = 0; ang < 3; ++ang)
      DA[6 + i][ang] += K_IINV[i] * dot3c(q.dR[ang][0][i], q.dR[ang][1][i],
                                         q.dR[ang][2][i], m[0], m[1], m[2]);
  const float FX[3][3] = {{0.f, -Fc[2], Fc[1]},
                          {Fc[2], 0.f, -Fc[0]},
                          {-Fc[1], Fc[0], 0.f}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      DA[6 + i][3 + j] += K_IINV[i] * dot3c(q.R[0][i], q.R[1][i], q.R[2][i],
                                           FX[0][j], FX[1][j], FX[2][j]);
  const float Iw[3] = {K_IDIAG[0] * wx, K_IDIAG[1] * wy, K_IDIAG[2] * wz};
  const float WX[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  const float IWX[3][3] = {{0.f, -Iw[2], Iw[1]},
                           {Iw[2], 0.f, -Iw[0]},
                           {-Iw[1], Iw[0], 0.f}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      DA[6 + i][6 + j] += K_IINV[i] * (-(WX[i][j] * K_IDIAG[j]) + IWX[i][j]);
  for (int l = 0; l < 4; ++l) {
    const float exf[3] = {0.f, -f[l][2], f[l][1]};
    const float eyf[3] = {f[l][2], 0.f, -f[l][0]};
    for (int i = 0; i < 3; ++i) {
      DA[6 + i][12 + 3 * l] += c[l] * K_IINV[i] *
          dot3c(q.R[0][i], q.R[1][i], q.R[2][i], exf[0], exf[1], exf[2]);
      DA[6 + i][12 + 3 * l + 1] += c[l] * K_IINV[i] *
          dot3c(q.R[0][i], q.R[1][i], q.R[2][i], eyf[0], eyf[1], eyf[2]);
    }
  }

  for (int l = 0; l < 4; ++l) {
    const float RXm[3][3] = {{0.f, pz, r[l][1]},
                             {-pz, 0.f, -r[l][0]},
                             {-r[l][1], r[l][0], 0.f}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        DB[6 + i][3 * l + j] = c[l] * K_IINV[i] *
            dot3c(q.R[0][i], q.R[1][i], q.R[2][i],
                  RXm[0][j], RXm[1][j], RXm[2][j]);
    for (int j = 0; j < 3; ++j) {
      DB[9 + j][3 * l + j] = c[l] * K_INV_MASS;
      DB[12 + 3 * l + j][12 + 3 * l + j] = 1.f - c[l];
    }
  }
}

// reset_jac_entries: accumulate S (Px = I + S) into S (pre-zeroed)
__device__ void reset_jac_entries(const float* x, const float c[4],
                                  const float cn[4], const Rot& rot,
                                  float S[NX][NX]) {
  for (int l = 0; l < 4; ++l) {
    const float to_swing = c[l] * (1.f - cn[l]);
    const float to_stance = (1.f - c[l]) * cn[l];
    const float keep = 1.f - to_swing - to_stance;
    float p[3], J[3][3];
    leg_fk_entries(x[12 + 3 * l], x[13 + 3 * l], x[14 + 3 * l], l, p, J);
    const float pf[3] = {p[0] + K_HIP[l][0], p[1] + K_HIP[l][1],
                         p[2] + K_HIP[l][2]};
    const int r0 = 12 + 3 * l;
    for (int i = 0; i < 2; ++i) {
      for (int ang = 0; ang < 3; ++ang)
        S[r0 + i][ang] += to_stance * dot3c(rot.dR[ang][i][0],
                                            rot.dR[ang][i][1],
                                            rot.dR[ang][i][2],
                                            pf[0], pf[1], pf[2]);
      S[r0 + i][3 + i] += to_stance * 1.f;
      for (int j = 0; j < 3; ++j)
        S[r0 + i][r0 + j] += to_stance * dot3c(rot.R[i][0], rot.R[i][1],
                                               rot.R[i][2], J[0][j], J[1][j],
                                               J[2][j]);
    }
    for (int j = 0; j < 3; ++j) S[r0 + j][r0 + j] += (keep - 1.f) * 1.f;
  }
}

// solver/costs.py:reb_derivs
__device__ __forceinline__ void reb_derivs(float g, float delta, float eps,
                                           float& d1, float& d2) {
  const bool act = g > delta;
  const float g_safe = act ? g : 1.f;
  const float a = act ? -1.f / g_safe : (g - 2.f * delta) / (delta * delta);
  const float b = act ? 1.f / (g_safe * g_safe) : 1.f / (delta * delta);
  d1 = eps * a;
  d2 = eps * b;
}

// running_partial_entries with the ReB rows: accumulate into lx, lu, lxx,
// luu (all pre-zeroed). mdt = dt at a DYN transition.
__device__ void running_partial_entries(const float* x, const float* u,
                                        const float* xr, const float* ur,
                                        const float* fr, const float c[4],
                                        float mdt, const float* rbd,
                                        const float* rbe, float* lx,
                                        float* lu, float lxx[NX][NX],
                                        float luu[NX][NX]) {
  for (int i = 0; i < 12; ++i) {
    lx[i] += mdt * K_Q_BODY[i] * (x[i] - xr[i]);
    lxx[i][i] += mdt * K_Q_BODY[i];
  }
  for (int l = 0; l < 4; ++l) {
    const float w = K_Q_SWING_LEG * (1.f - c[l]);
    for (int j = 0; j < 3; ++j) {
      const int i = 12 + 3 * l + j;
      lx[i] += mdt * w * (x[i] - xr[i]);
      lxx[i][i] += mdt * w;
    }
  }
  for (int l = 0; l < 4; ++l) {
    const float Wl[2] = {K_WFOOT[0] * c[l], K_WFOOT[1] * c[l]};
    for (int j = 0; j < 2; ++j) {
      const int i = 12 + 3 * l + j;
      const float d = (x[i] - x[3 + j]) - (fr[3 * l + j] - xr[3 + j]);
      lx[i] += mdt * Wl[j] * d;
      lx[3 + j] += -mdt * Wl[j] * d;
      lxx[i][i] += mdt * Wl[j];
      lxx[3 + j][3 + j] += mdt * Wl[j];
      lxx[i][3 + j] += -mdt * Wl[j];
      lxx[3 + j][i] += -mdt * Wl[j];
    }
  }
  for (int i = 0; i < 12; ++i) {
    lu[i] += mdt * K_R_GRF * (u[i] - ur[i]);
    luu[i][i] += mdt * K_R_GRF;
  }
  for (int i = 12; i < 24; ++i) {
    lu[i] += mdt * K_R_QJD * (u[i] - ur[i]);
    luu[i][i] += mdt * K_R_QJD;
  }
  for (int l = 0; l < 4; ++l) {
    const float fx = u[3 * l], fy = u[3 * l + 1], fz = u[3 * l + 2];
    const float grows[5] = {fz, -fx + K_MU * fz, fx + K_MU * fz,
                            -fy + K_MU * fz, fy + K_MU * fz};
    float D[5], Hh[5];
    for (int k = 0; k < 5; ++k) {
      const int r = 5 * l + k;
      float a1, a2;
      reb_derivs(grows[k], rbd[r], rbe[r], a1, a2);
      D[k] = c[l] * a1;
      Hh[k] = c[l] * a2;
    }
    const int ux = 3 * l, uy = 3 * l + 1, uz = 3 * l + 2;
    lu[ux] += mdt * (-D[1] + D[2]);
    lu[uy] += mdt * (-D[3] + D[4]);
    lu[uz] += mdt * (D[0] + K_MU * (D[1] + D[2] + D[3] + D[4]));
    luu[ux][ux] += mdt * (Hh[1] + Hh[2]);
    luu[uy][uy] += mdt * (Hh[3] + Hh[4]);
    luu[uz][uz] += mdt * (Hh[0] + K_MU2 * (Hh[1] + Hh[2] + Hh[3] + Hh[4]));
    const float hxz = mdt * K_MU * (Hh[2] - Hh[1]);
    const float hyz = mdt * K_MU * (Hh[4] - Hh[3]);
    luu[ux][uz] += hxz;
    luu[uz][ux] += hxz;
    luu[uy][uz] += hyz;
    luu[uz][uy] += hyz;
  }
}

// terminal_partial_entries (AL on): accumulate phix, phixx (pre-zeroed) at
// one node. tctx: term_contact(4), td_mask(4), al_sigma(4), al_lambda(4),
// term_mask.
__device__ void terminal_partial_entries(const float* x, const float* xr,
                                         const float* fr, const float tc[4],
                                         float tm, const float td[4],
                                         const float sig[4],
                                         const float lam[4], const Rot& rot,
                                         float* phix, float phixx[NX][NX]) {
  for (int i = 0; i < 12; ++i) {
    phix[i] += tm * K_QF[i] * (x[i] - xr[i]);
    phixx[i][i] += tm * K_QF[i];
  }
  for (int l = 0; l < 4; ++l) {
    const float w = K_QF_LEG * (1.f - tc[l]);
    for (int j = 0; j < 3; ++j) {
      const int i = 12 + 3 * l + j;
      phix[i] += tm * w * (x[i] - xr[i]);
      phixx[i][i] += tm * w;
    }
  }
  for (int l = 0; l < 4; ++l) {
    const float Wl[2] = {K_WFOOT[0] * tc[l], K_WFOOT[1] * tc[l]};
    for (int j = 0; j < 2; ++j) {
      const int i = 12 + 3 * l + j;
      const float d = (x[i] - x[3 + j]) - (fr[3 * l + j] - xr[3 + j]);
      phix[i] += tm * K_TF2 * Wl[j] * d;
      phix[3 + j] += -tm * K_TF2 * Wl[j] * d;
      phixx[i][i] += tm * K_TF2 * Wl[j];
      phixx[3 + j][3 + j] += tm * K_TF2 * Wl[j];
      phixx[i][3 + j] += -tm * K_TF2 * Wl[j];
      phixx[3 + j][i] += -tm * K_TF2 * Wl[j];
    }
  }
  for (int l = 0; l < 4; ++l) {
    const float mask = tm * td[l];
    float p[3], J[3][3];
    leg_fk_entries(x[12 + 3 * l], x[13 + 3 * l], x[14 + 3 * l], l, p, J);
    const float pf[3] = {p[0] + K_HIP[l][0], p[1] + K_HIP[l][1],
                         p[2] + K_HIP[l][2]};
    // world foot height h = pos_z + R[2,:] . pfull
    const float h = x[5] + dot3c(rot.R[2][0], rot.R[2][1], rot.R[2][2],
                                 pf[0], pf[1], pf[2]);
    const float w1 = mask * (sig[l] * h + lam[l]);
    const float w2 = mask * (sig[l] * (1.f + h) + lam[l]);
    // hx row entries: d pf_z/d eul (3), d pf_z/d pos_z = 1, d/d qleg (3)
    const int idx[7] = {0, 1, 2, 5, 12 + 3 * l, 13 + 3 * l, 14 + 3 * l};
    float val[7];
    for (int ang = 0; ang < 3; ++ang)
      val[ang] = dot3c(rot.dR[ang][2][0], rot.dR[ang][2][1],
                       rot.dR[ang][2][2], pf[0], pf[1], pf[2]);
    val[3] = 1.f;
    for (int j = 0; j < 3; ++j)
      val[4 + j] = dot3c(rot.R[2][0], rot.R[2][1], rot.R[2][2],
                         J[0][j], J[1][j], J[2][j]);
    for (int a = 0; a < 7; ++a) {
      phix[idx[a]] += w1 * val[a];
      for (int b = 0; b < 7; ++b) phixx[idx[a]][idx[b]] += w2 * val[a] * val[b];
    }
  }
}

__device__ __forceinline__ void zero(float* p, int n, int tid) {
  for (int e = tid; e < n; e += NT) p[e] = 0.f;
}

// Terminal partials at node j into the phi stash (s.Px, s.Pxx); the state
// of node j is in s.x, its reference in s.xr / s.fr. Ends synchronized.
__device__ void stash_phi(Smem& s, int tid, const float* tc_n,
                          const float* td_n, const float* sig_n,
                          const float* lam_n, float tm) {
  zero(s.Px, NX, tid);
  zero(&s.Pxx[0][0], NX * NX, tid);
  __syncthreads();
  if (tid == 0) {
    Rot rot;
    rot_entries(s.x[0], s.x[1], s.x[2], rot);
    float tc[4], td[4], sig[4], lam[4];
    for (int l = 0; l < 4; ++l) {
      tc[l] = tc_n[l]; td[l] = td_n[l]; sig[l] = sig_n[l]; lam[l] = lam_n[l];
    }
    terminal_partial_entries(s.x, s.xr, s.fr, tc, tm, td, sig, lam, rot,
                             s.Px, s.Pxx);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT)
riccati_hkd_kernel(const int* __restrict__ kind, const float* __restrict__ X,
                   const float* __restrict__ U,
                   const float* __restrict__ contact,
                   const float* __restrict__ contact_next,
                   const float* __restrict__ xr, const float* __restrict__ ur,
                   const float* __restrict__ foot_r,
                   const float* __restrict__ reb_delta,
                   const float* __restrict__ reb_eps,
                   const float* __restrict__ term_contact,
                   const float* __restrict__ td_mask,
                   const float* __restrict__ al_sigma,
                   const float* __restrict__ al_lambda,
                   const float* __restrict__ term_mask,
                   const float* __restrict__ defect,
                   const float* __restrict__ reg,
                   const int* __restrict__ last_node,
                   const float* __restrict__ dt, float* __restrict__ dU,
                   float* __restrict__ K, float* __restrict__ dv1_out,
                   float* __restrict__ dv2_out,
                   unsigned char* __restrict__ ok_out, int T, int u_rows,
                   int ur_rows) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const size_t Tn = (size_t)T + 1;

  const int* kind_b = kind + b * T;
  const float* X_b = X + b * Tn * NX;
  const float* U_b = U + b * (size_t)u_rows * NX;
  const float* c_b = contact + b * T * 4;
  const float* cn_b = contact_next + b * T * 4;
  const float* xr_b = xr + b * Tn * NX;
  const float* ur_b = ur + b * (size_t)ur_rows * NX;
  const float* fr_b = foot_r + b * Tn * 12;
  const float* rbd_b = reb_delta + b * T * 20;
  const float* rbe_b = reb_eps + b * T * 20;
  const float* tc_b = term_contact + b * Tn * 4;
  const float* td_b = td_mask + b * Tn * 4;
  const float* sig_b = al_sigma + b * Tn * 4;
  const float* lam_b = al_lambda + b * Tn * 4;
  const float* tm_b = term_mask + b * Tn;
  const float* def_b = defect + b * Tn * NX;
  const float reg_b = reg[b];
  const float dt_b = dt[b];
  const int last = last_node[b];

  float dv1 = 0.f, dv2 = 0.f;   // meaningful in thread 0
  bool okb = true;

  zero(&s.H[0][0], NX * NX, tid);
  zero(s.G, NX, tid);
  // phi(T): the only node no step owns as a source
  for (int e = tid; e < NX; e += NT) {
    s.x[e] = X_b[(size_t)T * NX + e];
    s.xr[e] = xr_b[(size_t)T * NX + e];
    if (e < 12) s.fr[e] = fr_b[(size_t)T * 12 + e];
  }
  __syncthreads();
  stash_phi(s, tid, tc_b + (size_t)T * 4, td_b + (size_t)T * 4,
            sig_b + (size_t)T * 4, lam_b + (size_t)T * 4, tm_b[T]);

  for (int t = T - 1; t >= 0; --t) {
    const int kd = kind_b[t];
    float* K_bt = K + (b * T + t) * (size_t)(NX * NX);
    float* dU_bt = dU + (b * T + t) * (size_t)NX;

    // seed the carry with phi(t+1) at the scenario's last active node
    if (last == t + 1) {
      for (int e = tid; e < NX * NX; e += NT) (&s.H[0][0])[e] += (&s.Pxx[0][0])[e];
      for (int e = tid; e < NX; e += NT) s.G[e] += s.Px[e];
    }
    for (int e = tid; e < NX; e += NT) {
      s.x[e] = X_b[(size_t)t * NX + e];
      s.u[e] = U_b[(size_t)t * NX + e];
      s.xr[e] = xr_b[(size_t)t * NX + e];
      s.ur[e] = ur_b[(size_t)t * NX + e];
      s.dnext[e] = def_b[(size_t)(t + 1) * NX + e];
      if (e < 12) s.fr[e] = fr_b[(size_t)t * 12 + e];
    }
    __syncthreads();
    defect_correction(s, tid);
    // phi(t): RESET seed now, is_last seed at the next step
    if (kd == KIND_RESET || last == t) {
      stash_phi(s, tid, tc_b + (size_t)t * 4, td_b + (size_t)t * 4,
                sig_b + (size_t)t * 4, lam_b + (size_t)t * 4, tm_b[t]);
    } else {
      __syncthreads();
    }

    if (kd == KIND_DYN) {
      zero(&s.A[0][0], NX * NX, tid);
      zero(&s.B[0][0], NX * NX, tid);
      zero(&s.Qxx[0][0], NX * NX, tid);
      zero(&s.Luu[0][0], NX * NX, tid);
      zero(s.Lx, NX, tid);
      zero(s.Lu, NX, tid);
      __syncthreads();
      if (tid == 0) {
        Rot rot;
        rot_entries(s.x[0], s.x[1], s.x[2], rot);
        float c[4];
        for (int l = 0; l < 4; ++l) c[l] = c_b[(size_t)t * 4 + l];
        dyn_jac_entries(s.x, s.u, c, rot, s.A, s.B);
        running_partial_entries(s.x, s.u, s.xr, s.ur, s.fr, c, dt_b,
                                rbd_b + (size_t)t * 20, rbe_b + (size_t)t * 20,
                                s.Lx, s.Lu, s.Qxx, s.Luu);
      }
      __syncthreads();
      for (int e = tid; e < NX * NX; e += NT) {
        const int i = e / NX, j = e % NX;
        s.A[i][j] = (i == j ? 1.f : 0.f) + dt_b * s.A[i][j];
        s.B[i][j] = dt_b * s.B[i][j];
      }
      __syncthreads();
      dyn_step(s, tid, reg_b, K_bt, dU_bt, dv1, dv2, okb);
    } else {
      for (int e = tid; e < NX * NX; e += NT) K_bt[e] = 0.f;
      for (int i = tid; i < NX; i += NT) dU_bt[i] = 0.f;
      if (kd == KIND_RESET) {
        zero(&s.A[0][0], NX * NX, tid);
        __syncthreads();
        if (tid == 0) {
          Rot rot;
          rot_entries(s.x[0], s.x[1], s.x[2], rot);
          float c[4], cn[4];
          for (int l = 0; l < 4; ++l) {
            c[l] = c_b[(size_t)t * 4 + l];
            cn[l] = cn_b[(size_t)t * 4 + l];
          }
          reset_jac_entries(s.x, c, cn, rot, s.A);
        }
        __syncthreads();
        for (int e = tid; e < NX * NX; e += NT) {
          const int i = e / NX, j = e % NX;
          s.A[i][j] = (i == j ? 1.f : 0.f) + s.A[i][j];   // Px = I + S
        }
        __syncthreads();
        reset_step(s, tid);
      }
    }
  }
  if (tid == 0) {
    dv1_out[b] = dv1;
    dv2_out[b] = dv2;
    ok_out[b] = okb ? 1 : 0;
  }
}

}  // namespace

extern "C" int riccati_hkd_launch(
    const int* kind, const float* X, const float* U, const float* contact,
    const float* contact_next, const float* xr, const float* ur,
    const float* foot_r, const float* reb_delta, const float* reb_eps,
    const float* term_contact, const float* td_mask, const float* al_sigma,
    const float* al_lambda, const float* term_mask, const float* defect,
    const float* reg, const int* last_node, const float* dt, float* dU,
    float* K, float* dv1, float* dv2, unsigned char* ok, int B, int T,
    int u_rows, int ur_rows, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  riccati_hkd_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      kind, X, U, contact, contact_next, xr, ur, foot_r, reb_delta, reb_eps,
      term_contact, td_mask, al_sigma, al_lambda, term_mask, defect, reg,
      last_node, dt, dU, K, dv1, dv2, ok, T, u_rows, ur_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* riccati_hkd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
