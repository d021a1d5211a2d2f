// The Riccati step shared by the two backward-sweep kernels,
// riccati_hkd.cu (Jacobians and cost partials rebuilt in-kernel) and
// riccati_dense.cu (materialized LQ data): the defect correction of the
// value carry, the DYN step (Q expansion, elimination with the PSD gate,
// value update) and the RESET sandwich.
//
// One 32-thread block owns one scenario. The functions are templates over
// the kernel's shared-memory struct S, which holds at least these fields:
//   float H[NX][NX], A[NX][NX], B[NX][NX], HA[NX][NX], HB[NX][NX],
//         Qxx[NX][NX], Qux[NX][NX], Luu[NX][NX], Pxx[NX][NX],
//         W[NX][NW], Sol[NX][25];
//   float G[NX], Gn[NX], Qx[NX], Qu[NX], Lx[NX], Lu[NX], Px[NX], fac[NX],
//         dnext[NX];
// Rows of each product and of each elimination step are spread over the
// threads; the pivots run in sequence.

#pragma once

#include <cuda_runtime.h>

namespace riccati {

constexpr int NX = 24;          // state and control width
constexpr int NT = 32;          // threads per block (one scenario)
constexpr int NW = 49;          // tableau columns: 24 Quu | 24 Qux | 1 Qu
constexpr int KIND_DYN = 1;
constexpr int KIND_RESET = 2;

// Gn = G + H dnext (the defect correction of the dest node,
// SinglePhase.cpp:319-321). Expects s.G, s.H, s.dnext synchronized; does
// not synchronize after.
template <class S>
__device__ void defect_correction(S& s, int tid) {
  for (int i = tid; i < NX; i += NT) {
    float acc = s.G[i];
    float hd = 0.f;
    for (int j = 0; j < NX; ++j) hd += s.H[i][j] * s.dnext[j];
    s.Gn[i] = acc + hd;
  }
}

// DYN transition. Expects, synchronized: s.A, s.B (the step's Jacobians),
// s.H and s.Gn (the value carry of the dest node, defect-corrected), and the
// running partials s.Qxx = lxx, s.Luu = luu, s.Lx = lx, s.Lu = lu.
// Q expansion with reg on the Qxx and Quu diagonals; Gaussian elimination
// on the tableau [Quu | Qux | Qu] with the PSD gate pivot > 1e-9 (each
// thread folds it into okb) and back-substitution; then
// K = -Quu^-1 Qux and dU = -Quu^-1 Qu into K_bt / dU_bt, the value update
// H = sym(Qxx - Qux' S), G = Qx - Qux' s, and dv = Qu' s into thread 0's
// dv1 / dv2. Leaves s.G, s.H synchronized.
template <class S>
__device__ void dyn_step(S& s, int tid, float reg_b, float* K_bt,
                         float* dU_bt, float& dv1, float& dv2, bool& okb) {
  for (int e = tid; e < NX * NX; e += NT) {
    const int i = e / NX, j = e % NX;
    float ha = 0.f, hb = 0.f;
    for (int k = 0; k < NX; ++k) {
      ha += s.H[i][k] * s.A[k][j];
      hb += s.H[i][k] * s.B[k][j];
    }
    s.HA[i][j] = ha;
    s.HB[i][j] = hb;
  }
  __syncthreads();
  // Q expansion; Quu and Qux go straight into the tableau
  for (int e = tid; e < NX * NX; e += NT) {
    const int i = e / NX, j = e % NX;
    float atha = 0.f, btha = 0.f, bthb = 0.f;
    for (int k = 0; k < NX; ++k) {
      atha += s.A[k][i] * s.HA[k][j];
      btha += s.B[k][i] * s.HA[k][j];
      bthb += s.B[k][i] * s.HB[k][j];
    }
    const float rd = (i == j) ? reg_b : 0.f;
    s.Qxx[i][j] = (s.Qxx[i][j] + atha) + rd;
    s.Qux[i][j] = btha;
    s.W[i][NX + j] = btha;
    s.W[i][j] = (s.Luu[i][j] + bthb) + rd;
  }
  for (int i = tid; i < NX; i += NT) {
    float ag = 0.f, bg = 0.f;
    for (int k = 0; k < NX; ++k) {
      ag += s.A[k][i] * s.Gn[k];
      bg += s.B[k][i] * s.Gn[k];
    }
    s.Qx[i] = s.Lx[i] + ag;
    s.Qu[i] = s.Lu[i] + bg;
    s.W[i][2 * NX] = s.Qu[i];
  }
  __syncthreads();
  for (int e = tid; e < NX * NX; e += NT) {
    const int i = e / NX, j = e % NX;
    s.HB[i][j] = 0.5f * (s.Qxx[i][j] + s.Qxx[j][i]);   // symmetric Qxx
  }

  // forward elimination on [Quu | Qux | Qu], PSD gate on each pivot
  for (int k = 0; k < NX; ++k) {
    __syncthreads();
    const float d = s.W[k][k];
    okb = okb && (d > 1e-9f);
    const float d_safe = fabsf(d) > 1e-30f ? d : 1.f;
    for (int i = k + 1 + tid; i < NX; i += NT) s.fac[i] = s.W[i][k] / d_safe;
    __syncthreads();
    const int n = (NX - 1 - k) * NW;
    for (int e = tid; e < n; e += NT) {
      const int i = k + 1 + e / NW, j = e % NW;
      s.W[i][j] = s.W[i][j] - s.fac[i] * s.W[k][j];
    }
  }
  __syncthreads();
  // back-substitution: thread c owns right-hand-side column c
  if (tid < 25) {
    const int c = tid;
    for (int i = NX - 1; i >= 0; --i) {
      float acc = s.W[i][NX + c];
      for (int j = i + 1; j < NX; ++j) acc = acc - s.W[i][j] * s.Sol[j][c];
      const float di = s.W[i][i];
      const float di_safe = fabsf(di) > 1e-30f ? di : 1.f;
      s.Sol[i][c] = acc / di_safe;
    }
  }
  __syncthreads();
  // value update: H = sym(Qxx - Qux' S), G = Qx - Qux' s, dv = Qu' s
  for (int e = tid; e < NX * NX; e += NT) {
    const int i = e / NX, j = e % NX;
    float a = 0.f;
    for (int k = 0; k < NX; ++k) a += s.Qux[k][i] * s.Sol[k][j];
    s.HA[i][j] = s.HB[i][j] - a;
    K_bt[e] = -s.Sol[i][j];
  }
  for (int i = tid; i < NX; i += NT) {
    float a = 0.f;
    for (int k = 0; k < NX; ++k) a += s.Qux[k][i] * s.Sol[k][NX];
    s.G[i] = s.Qx[i] - a;
    dU_bt[i] = -s.Sol[i][NX];
  }
  if (tid == 0) {
    float dv = 0.f;
    for (int k = 0; k < NX; ++k) dv += s.Qu[k] * s.Sol[k][NX];
    dv1 -= dv;
    dv2 += dv;
  }
  __syncthreads();
  for (int e = tid; e < NX * NX; e += NT) {
    const int i = e / NX, j = e % NX;
    s.H[i][j] = 0.5f * (s.HA[i][j] + s.HA[j][i]);
  }
  __syncthreads();
}

// RESET transition (impact-aware sandwich plus the terminal seed of the
// source node). Expects, synchronized: s.A = Px, s.H, s.Gn, and the source
// node's terminal partials in s.Px / s.Pxx. Leaves G = phix + Px' Gn and
// H = phixx + Px' H Px in s.G, s.H, synchronized.
template <class S>
__device__ void reset_step(S& s, int tid) {
  for (int e = tid; e < NX * NX; e += NT) {
    const int i = e / NX, j = e % NX;
    float ha = 0.f;
    for (int k = 0; k < NX; ++k) ha += s.H[i][k] * s.A[k][j];
    s.HA[i][j] = ha;
  }
  __syncthreads();
  for (int e = tid; e < NX * NX; e += NT) {
    const int i = e / NX, j = e % NX;
    float a = 0.f;
    for (int k = 0; k < NX; ++k) a += s.A[k][i] * s.HA[k][j];
    s.HB[i][j] = s.Pxx[i][j] + a;
  }
  for (int i = tid; i < NX; i += NT) {
    float a = 0.f;
    for (int k = 0; k < NX; ++k) a += s.A[k][i] * s.Gn[k];
    s.Qx[i] = s.Px[i] + a;
  }
  __syncthreads();
  for (int e = tid; e < NX * NX; e += NT) (&s.H[0][0])[e] = (&s.HB[0][0])[e];
  for (int i = tid; i < NX; i += NT) s.G[i] = s.Qx[i];
  __syncthreads();
}

}  // namespace riccati
