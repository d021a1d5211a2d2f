// The HKD model's transition maps on the card, shared by the kernels that
// roll the model forward: the parallel rollout (rollout_hkd.cu: every
// transition at once) and the sequential rollout (rollout_seq_hkd.cu: one
// transition after the other, feedback on the rolled state). hkd_dynamics
// is the forward-Euler step of ops/hkd_tminor.py:dynamics_tbatch and
// hkd_reset the reset map of reset_tbatch, term for term, on
// hkd_entries.cuh's constants and leg kinematics (leg_fk_entries); gravity
// and the default leg angles of a foot that lifts off come in as arguments.
// Full-precision sines, cosines and square roots.

#pragma once

#include <cuda_runtime.h>

#include "hkd_entries.cuh"
#include "riccati_step.cuh"

namespace {

using namespace riccati;

__device__ __forceinline__ void rsincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void rsincos(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float rsqrt_full(float x) { return sqrtf(x); }
__device__ __forceinline__ double rsqrt_full(double x) { return sqrt(x); }

// R = Rz(yaw) Ry(pitch) Rx(roll) as (Rz Ry) Rx (jac_tminor._rot_entries),
// and the pitch and roll cosines and sines
template <typename R>
__device__ __forceinline__ void rotation(const R* x, R Rm[3][3], R& cp,
                                         R& sp, R& cr, R& sr) {
  R cy, sy;
  rsincos(x[0], &sy, &cy);
  rsincos(x[1], &sp, &cp);
  rsincos(x[2], &sr, &cr);
  const R Rz[3][3] = {{cy, -sy, R(0)}, {sy, cy, R(0)}, {R(0), R(0), R(1)}};
  const R Ry[3][3] = {{cp, R(0), sp}, {R(0), R(1), R(0)}, {-sp, R(0), cp}};
  const R Rx[3][3] = {{R(1), R(0), R(0)}, {R(0), cr, -sr}, {R(0), sr, cr}};
  R T1[3][3];
  mm3(Rz, Ry, T1);
  mm3(T1, Rx, Rm);
}

// hkd_tminor.dynamics_tbatch: the forward-Euler step of (x, u) in contact
// c over dt; g the gravitational acceleration
template <typename R>
__device__ void hkd_dynamics(const R* x, const R* u, const R* c, R dt, R g,
                             R* out) {
  R Rm[3][3], cp, sp, cr, sr;
  rotation(x, Rm, cp, sp, cr, sr);
  const R wx = x[6], wy = x[7], wz = x[8];
  const R s_ = sr * wy + cr * wz;
  const R t_ = cr * wy - sr * wz;
  out[0] = x[0] + dt * (s_ / cp);
  out[1] = x[1] + dt * t_;
  out[2] = x[2] + dt * (wx + s_ * sp / cp);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = x[3 + i] + dt * x[9 + i];

  R m[3] = {R(0), R(0), R(0)}, Fc[3] = {R(0), R(0), R(0)};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const R r[3] = {x[12 + 3 * l] - x[3], x[13 + 3 * l] - x[4], -x[5]};
    const R* f = u + 3 * l;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[k] = m[k] + c[l] * (r[(k + 1) % 3] * f[(k + 2) % 3]
                            - r[(k + 2) % 3] * f[(k + 1) % 3]);
      Fc[k] = Fc[k] + c[l] * f[k];
    }
  }
  const R w[3] = {wx, wy, wz};
  const R Iw[3] = {Model<R>::IDIAG(0) * wx, Model<R>::IDIAG(1) * wy,
                   Model<R>::IDIAG(2) * wz};
  const R wxIw[3] = {w[1] * Iw[2] - w[2] * Iw[1], w[2] * Iw[0] - w[0] * Iw[2],
                     w[0] * Iw[1] - w[1] * Iw[0]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const R tau = dot3c(Rm[0][i], Rm[1][i], Rm[2][i], m[0], m[1], m[2]);
    out[6 + i] = x[6 + i] + dt * (Model<R>::IINV(i) * (tau - wxIw[i]));
  }
  out[9] = x[9] + dt * (Fc[0] * Model<R>::INV_MASS);
  out[10] = x[10] + dt * (Fc[1] * Model<R>::INV_MASS);
  out[11] = x[11] + dt * (Fc[2] * Model<R>::INV_MASS - g);
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[12 + 3 * l + j] = x[12 + 3 * l + j]
                            + dt * (R(1) - c[l]) * u[12 + 3 * l + j];
}

// hkd_tminor.reset_tbatch: the reset map of x from contact c to cn; a leg
// that lifts off takes the default angles qdef, a leg that lands takes its
// foot's world x, y (and 0 for z)
template <typename R>
__device__ void hkd_reset(const R* x, const R* c, const R* cn,
                          const R* qdef, R* out) {
  R Rm[3][3], cp, sp, cr, sr;
  rotation(x, Rm, cp, sp, cr, sr);
#pragma unroll
  for (int i = 0; i < 12; ++i) out[i] = x[i];
  const R cmap[3] = {R(1), R(1), R(0)};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const R to_swing = c[l] * (R(1) - cn[l]);
    const R to_stance = (R(1) - c[l]) * cn[l];
    const R keep = R(1) - to_swing - to_stance;
    R p[3], J[3][3];
    leg_fk_entries(x[12 + 3 * l], x[13 + 3 * l], x[14 + 3 * l], l, p, J);
    const R ph[3] = {p[0] + Model<R>::HIP(l, 0), p[1] + Model<R>::HIP(l, 1),
                     p[2] + Model<R>::HIP(l, 2)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const R pf = x[3 + j] + dot3c(Rm[j][0], Rm[j][1], Rm[j][2], ph[0],
                                    ph[1], ph[2]);
      out[12 + 3 * l + j] = keep * x[12 + 3 * l + j] + to_swing * qdef[j]
                            + to_stance * cmap[j] * pf;
    }
  }
}

}  // namespace
