// The cost of HKD trajectories for a batch of scenarios and one or more
// evaluations of each (the nominal trajectory, or every line-search
// candidate): per evaluation e and scenario b, the total cost, the masked
// friction-cone rows g_all, the touchdown rows h, the dynamics feasibility
// of the defects and the two violation maxima. One launch computes what
// solver/rollout.py computes with the default model's horizon-minor cost:
// ops/hkd_tminor.py:compute_cost_tbatch, then dynamics_feasibility and
// max_violations, once per evaluation.
//
// It replaces no TPU kernel: the JAX package's cost is jnp code that XLA
// fuses. On the card its plain version ran as about 1,000 PyTorch
// operations an evaluation, each on (B, T) entries of one column of a
// row-major (..., 24) tensor, 11 evaluations a trot solve: about 11,500 of
// a sweep replay's 12,025 graph nodes and 36-40 ms of its 60, spent on
// launches and ramps rather than on bytes.
// Wrapper and launch counters: hkdmpc_tpu_torch/ops/cost_hkd.py.
//
// What it computes, per evaluation e, scenario b (the formulas of
// hkd_tminor.py term for term, on hkd_entries.cuh's constants and leg
// kinematics):
//   - at every transition t < T: the running tracking cost of (X[t], U[t])
//     against (xr[t], ur[t]) with the swing legs' joint rows, the foot
//     placement regularization of the stance legs, and, with reb_active,
//     the ReB barrier of the stance legs' five cone rows; weighted by
//     is_dyn[t] * dt. The rows g_all[t] = g * c + (1 - c) (a swing leg's
//     rows read 1);
//   - at every node n <= T: the terminal tracking cost, the terminal foot
//     regularization (factor 10, no 1/2), the touchdown heights
//     h[n] = td_mask * foot z and, with al_active, the AL penalty
//     td_mask * (sigma h^2 / 2 + lambda h); weighted by term_mask[n];
//   - the feasibility: the 2-norm of defect;
//   - max_pconstr = min(0, min over the DYN transitions' g_all),
//     max_tconstr = max(0, max over nodes of |h| term_mask); a NaN anywhere
//     in them reads NaN, as torch.amin / amax give it.
//
// What bounds it on the H100 (3.35 TB/s), at B = 4096, T = 75, f32: bytes.
// A launch reads the scenario's references once (xr, ur, foot_r, contacts,
// masks, the ReB and AL rows: 37 KB a scenario, 150 MB) and each
// evaluation's X, U and defect (22 KB) and writes its g_all and h (7 KB):
// 0.63 GB and 0.19 ms for the line search's four candidates, 0.27 GB and
// 0.08 ms for one evaluation (ops/riccati_bound.py:cost_work). Its
// thousand operations a node are a tenth of the bytes' time at 67 TFLOP/s.
//
// What the design does about it:
//   - one block an (evaluation, scenario), the evaluations of a scenario
//     adjacent in the grid, so the blocks that read the same reference rows
//     run together and the second and later read them from L2;
//   - a thread a node (and its transition): the block has the horizon's
//     T + 1 nodes rounded up to whole warps, at most 256 threads, which
//     take nodes n, n + 256, ... beyond that. A thread reads its rows with
//     16-byte loads (every row is a whole number of 16-byte pieces), the
//     warp's loads together a contiguous run of rows, and writes its g_all
//     row and h row the same way;
//   - the tracking error and the foot-placement error of a node are formed
//     once and serve both the running and the terminal cost;
//   - the sums and extrema: a warp reduction (shuffles), then the warps'
//     partials in shared memory, added in warp order by thread 0: the
//     result does not depend on timing;
//   - a reference tensor shared across the batch (batch stride 0) is read
//     through its batch stride, never copied.
// No tensor cores, no TF32; full-precision sines, cosines and logarithms.
// float64 is the same kernel on double with the exact float64 constants
// (cost_hkd_launch_f64).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hkd_entries.cuh"
#include "riccati_step.cuh"

namespace {

using namespace riccati;

constexpr int CO_MAX_THREADS = 256;
constexpr int CO_WARPS = CO_MAX_THREADS / 32;
constexpr int NG = 20;      // friction-cone rows: five a leg
constexpr int NL = 4;       // legs, touchdown rows
constexpr int NF = 12;      // foot reference values a node
constexpr int NSUM = 5;     // reduced values: run, term, feas, min, max

// The launch's tensors: the evaluations' X (E, B, T+1, 24), U (E, B, T, 24)
// and defect (E, B, T+1, 24), contiguous; the scenario's references, each
// at its own batch stride (elements) with contiguous rows; the outputs
// cost, feas, maxp, maxt (E, B), g_all (E, B, T, 20), h (E, B, T+1, 4).
template <typename R>
struct CostArgs {
  const R* X;
  const R* U;
  const R* defect;
  const int* kind;
  const R* dt;
  const R* xr;
  const R* ur;
  const R* foot_r;
  const R* contact;
  const R* term_contact;
  const R* td_mask;
  const R* term_mask;
  const R* reb_delta;
  const R* reb_eps;
  const R* al_sigma;
  const R* al_lambda;
  R* cost;
  R* g_all;
  R* h;
  R* feas;
  R* maxp;
  R* maxt;
  long long s_kind, s_dt, s_xr, s_ur, s_fr, s_c, s_tc, s_td, s_tm, s_rd,
      s_re, s_sig, s_lam;
  int B, T, E, reb_active, al_active;
};

__device__ __forceinline__ float rlog(float x) { return logf(x); }
__device__ __forceinline__ double rlog(double x) { return log(x); }
__device__ __forceinline__ float rsqrt_full(float x) { return sqrtf(x); }
__device__ __forceinline__ double rsqrt_full(double x) { return sqrt(x); }

// min and max that return NaN when either operand is NaN (torch.amin,
// torch.amax, torch.clamp)
template <typename R>
__device__ __forceinline__ R nan_min(R a, R b) {
  return (a < b || a != a) ? a : b;
}
template <typename R>
__device__ __forceinline__ R nan_max(R a, R b) {
  return (a > b || a != a) ? a : b;
}

// N values of a row that starts on a 16-byte boundary
template <int N, typename R>
__device__ __forceinline__ void ld_row(const R* p, R* v) {
  constexpr int VN = Vec16<R>::N;
#pragma unroll
  for (int k = 0; k < N; k += VN) ld16(p + k, v + k);
}
template <int N, typename R>
__device__ __forceinline__ void st_row(R* p, const R* v) {
  constexpr int VN = Vec16<R>::N;
#pragma unroll
  for (int k = 0; k < N; k += VN) st16(p + k, v + k);
}

// solver/costs.py:reb_value, eps * B_delta(g)
template <typename R>
__device__ __forceinline__ R reb_value(R g, R delta, R eps) {
  const R g_safe = g > R(1e-30) ? g : R(1e-30);
  const R q = (g - R(2) * delta) / delta;
  const R quad = R(0.5) * (q * q - R(1)) - rlog(delta);
  return eps * (g > delta ? -rlog(g_safe) : quad);
}

// the weighted sum of a node's squared tracking errors dx2: the body rows
// by Q_BODY (running) or QF (terminal), each leg's three rows by wleg[l]
// (hkd_tminor._track_cost_entries, _terminal_cost_entries)
template <bool Terminal, typename R>
__device__ __forceinline__ R tracking(const R* dx2, const R* wleg) {
  R s = R(0);
#pragma unroll
  for (int i = 0; i < 12; ++i)
    s = s + (Terminal ? Model<R>::QF(i) : Model<R>::Q_BODY(i)) * dx2[i];
#pragma unroll
  for (int l = 0; l < 4; ++l)
    s = s + wleg[l] * (dx2[12 + 3 * l] + dx2[13 + 3 * l] + dx2[14 + 3 * l]);
  return s;
}

template <typename R>
__global__ void __launch_bounds__(CO_MAX_THREADS)
cost_hkd_kernel(const CostArgs<R> a) {
  __shared__ R part[CO_WARPS][NSUM];
  const int q = blockIdx.x;
  const int b = q / a.E, e = q - b * a.E;
  const int T = a.T;
  const size_t Tn = (size_t)T + 1;
  const size_t eb = (size_t)e * a.B + b;
  const R* X = a.X + eb * Tn * NX;
  const R* U = a.U + eb * (size_t)T * NX;
  const R* D = a.defect + eb * Tn * NX;
  R* g_out = a.g_all + eb * (size_t)T * NG;
  R* h_out = a.h + eb * Tn * NL;
  const int* kind = a.kind + b * a.s_kind;
  const R* xr_b = a.xr + b * a.s_xr;
  const R* ur_b = a.ur + b * a.s_ur;
  const R* fr_b = a.foot_r + b * a.s_fr;
  const R* c_b = a.contact + b * a.s_c;
  const R* tc_b = a.term_contact + b * a.s_tc;
  const R* td_b = a.td_mask + b * a.s_td;
  const R* tm_b = a.term_mask + b * a.s_tm;
  const R* rd_b = a.reb_delta + b * a.s_rd;
  const R* re_b = a.reb_eps + b * a.s_re;
  const R* sig_b = a.al_sigma + b * a.s_sig;
  const R* lam_b = a.al_lambda + b * a.s_lam;
  const R dt = a.dt[b * a.s_dt];

  const R tfoot = R(0.5) * Model<R>::TF2;   // the terminal factor 10

  R run = R(0), term = R(0), fs = R(0), mp = R(0), mt = R(0);
  for (int n = threadIdx.x; n <= T; n += blockDim.x) {
    // the node's errors: tracking dx2 and foot placement fd (leg l, axis j
    // at 2 l + j)
    R x[NX], dx2[NX], fd[8];
    {
      R r[NX], fr[NF];
      ld_row<NX>(X + (size_t)n * NX, x);
      ld_row<NX>(xr_b + (size_t)n * NX, r);
      ld_row<NF>(fr_b + (size_t)n * NF, fr);
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          fd[2 * l + j] = (x[12 + 3 * l + j] - x[3 + j])
                          - (fr[3 * l + j] - r[3 + j]);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const R d = x[i] - r[i];
        dx2[i] = d * d;
      }
    }

    // terminal: tracking, foot regularization, touchdown rows, AL
    {
      R tc[NL], td[NL], wl[NL];
      ld_row<NL>(tc_b + (size_t)n * NL, tc);
      ld_row<NL>(td_b + (size_t)n * NL, td);
#pragma unroll
      for (int l = 0; l < NL; ++l) wl[l] = Model<R>::QF_LEG * (R(1) - tc[l]);
      R phi = R(0.5) * tracking<true>(dx2, wl);
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const R d = fd[2 * l + j];
          phi = phi + tfoot * (Model<R>::WFOOT(j) * tc[l]) * d * d;
        }
      // the third row of R = Rz(yaw) Ry(pitch) Rx(roll): (-sp, cp sr, cp cr)
      const R sp = rsin(x[1]), cp = rcos(x[1]);
      const R sr = rsin(x[2]), cr = rcos(x[2]);
      const R r2[3] = {-sp, cp * sr, cp * cr};
      R hv[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        R p[3], J[3][3];
        leg_fk_entries(x[12 + 3 * l], x[13 + 3 * l], x[14 + 3 * l], l, p, J);
        const R pz = x[5] + dot3c(r2[0], r2[1], r2[2],
                                  p[0] + Model<R>::HIP(l, 0),
                                  p[1] + Model<R>::HIP(l, 1),
                                  p[2] + Model<R>::HIP(l, 2));
        hv[l] = td[l] * pz;
      }
      st_row<NL>(h_out + (size_t)n * NL, hv);
      if (a.al_active) {
        R sig[NL], lam[NL], al = R(0);
        ld_row<NL>(sig_b + (size_t)n * NL, sig);
        ld_row<NL>(lam_b + (size_t)n * NL, lam);
#pragma unroll
        for (int l = 0; l < NL; ++l)
          al = al + td[l] * (R(0.5) * sig[l] * hv[l] * hv[l]
                             + lam[l] * hv[l]);
        phi = phi + al;
      }
      const R tm = tm_b[n];
      term = term + tm * phi;
#pragma unroll
      for (int l = 0; l < NL; ++l) mt = nan_max(mt, rabs(hv[l]) * tm);
    }

    // running, transition t = n
    if (n < T) {
      R c[NL], wl[NL];
      ld_row<NL>(c_b + (size_t)n * NL, c);
#pragma unroll
      for (int l = 0; l < NL; ++l)
        wl[l] = Model<R>::Q_SWING_LEG * (R(1) - c[l]);
      R l_run = tracking<false>(dx2, wl);
      R u[NX], du_grf = R(0), du_qjd = R(0);
      {
        R ur[NX];
        ld_row<NX>(U + (size_t)n * NX, u);
        ld_row<NX>(ur_b + (size_t)n * NX, ur);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          const R d = u[i] - ur[i];
          if (i < 12) du_grf = du_grf + d * d;
          else du_qjd = du_qjd + d * d;
        }
      }
      l_run = l_run + Model<R>::R_GRF * du_grf;
      l_run = l_run + Model<R>::R_QJD * du_qjd;
      l_run = R(0.5) * l_run;
      R foot = R(0);
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const R d = fd[2 * l + j];
          foot = foot + R(0.5) * (Model<R>::WFOOT(j) * c[l]) * d * d;
        }
      l_run = l_run + foot;

      // the cone rows of each leg's force: fz, -fx + mu fz, fx + mu fz,
      // -fy + mu fz, fy + mu fz; masked by the leg's contact
      R g[NG];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const R fx = u[3 * l], fy = u[3 * l + 1], fz = u[3 * l + 2];
        const R mfz = Model<R>::MU * fz;
        g[5 * l] = fz;
        g[5 * l + 1] = -fx + mfz;
        g[5 * l + 2] = fx + mfz;
        g[5 * l + 3] = -fy + mfz;
        g[5 * l + 4] = fy + mfz;
      }
      if (a.reb_active) {
        R rd[NG], re[NG], barrier = R(0);
        ld_row<NG>(rd_b + (size_t)n * NG, rd);
        ld_row<NG>(re_b + (size_t)n * NG, re);
#pragma unroll
        for (int r = 0; r < NG; ++r)
          barrier = barrier + c[r / 5] * reb_value(g[r], rd[r], re[r]);
        l_run = l_run + barrier;
      }
      const bool is_dyn = kind[n] == KIND_DYN;
      run = run + ((is_dyn ? R(1) : R(0)) * dt) * l_run;
      R gm = R(0);
#pragma unroll
      for (int r = 0; r < NG; ++r) {
        const R m = c[r / 5];
        g[r] = g[r] * m + (R(1) - m);
        gm = nan_min(gm, g[r]);
      }
      st_row<NG>(g_out + (size_t)n * NG, g);
      if (is_dyn) mp = nan_min(mp, gm);
    }

    // feasibility: the defect's squares at node n
    {
      R d[NX];
      ld_row<NX>(D + (size_t)n * NX, d);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        fs = fs + d[i] * d[i];
    }
  }

  // the block's sums and extrema: warp shuffles, then the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    run = run + __shfl_xor_sync(FULL_MASK, run, o);
    term = term + __shfl_xor_sync(FULL_MASK, term, o);
    fs = fs + __shfl_xor_sync(FULL_MASK, fs, o);
    mp = nan_min(mp, __shfl_xor_sync(FULL_MASK, mp, o));
    mt = nan_max(mt, __shfl_xor_sync(FULL_MASK, mt, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[warp][0] = run;
    part[warp][1] = term;
    part[warp][2] = fs;
    part[warp][3] = mp;
    part[warp][4] = mt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nw = blockDim.x >> 5;
    run = part[0][0];
    term = part[0][1];
    fs = part[0][2];
    mp = part[0][3];
    mt = part[0][4];
    for (int w = 1; w < nw; ++w) {
      run = run + part[w][0];
      term = term + part[w][1];
      fs = fs + part[w][2];
      mp = nan_min(mp, part[w][3]);
      mt = nan_max(mt, part[w][4]);
    }
    a.cost[eb] = run + term;
    a.feas[eb] = rsqrt_full(fs);
    a.maxp[eb] = mp;
    a.maxt[eb] = mt;
  }
}

// threads a block for a horizon of T transitions: its T + 1 nodes in whole
// warps, at most CO_MAX_THREADS
__host__ __device__ constexpr int block_threads(int T) {
  return T + 1 >= CO_MAX_THREADS ? CO_MAX_THREADS : (T + 32) / 32 * 32;
}

template <typename R>
int launch(const CostArgs<R>& a, void* stream) {
  if (a.B <= 0 || a.E <= 0) return 0;
  if (a.T <= 0 || (long long)a.B * a.E > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cost_hkd_kernel<R><<<a.B * a.E, block_threads(a.T), 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// threads per block, dynamic shared memory per block and resident blocks
// per SM of instantiation R on the current device, at T = INFO_T
constexpr int INFO_T = 75;

template <typename R>
int info(int* threads, int* smem, int* blocks_per_sm) {
  *threads = block_threads(INFO_T);
  *smem = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, cost_hkd_kernel<R>, block_threads(INFO_T), 0));
}

}  // namespace

// The C interface: cost_hkd_launch / _info run the float32 instantiation,
// cost_hkd_launch_f64 / _info_f64 the float64 one. The batch strides are
// in elements; reb_active, al_active: whether the ReB barrier and the AL
// penalty count.
#define CO_PARAMS(R)                                                        \
  const R *X, const R *U, const R *defect, const int *kind, const R *dt,    \
      const R *xr, const R *ur, const R *foot_r, const R *contact,          \
      const R *term_contact, const R *td_mask, const R *term_mask,          \
      const R *reb_delta, const R *reb_eps, const R *al_sigma,              \
      const R *al_lambda, R *cost, R *g_all, R *h, R *feas, R *maxp,        \
      R *maxt, long long s_kind, long long s_dt, long long s_xr,            \
      long long s_ur, long long s_fr, long long s_c, long long s_tc,        \
      long long s_td, long long s_tm, long long s_rd, long long s_re,       \
      long long s_sig, long long s_lam, int B, int T, int E,                \
      int reb_active, int al_active, void *stream
#define CO_ARGS                                                             \
  {X, U, defect, kind, dt, xr, ur, foot_r, contact, term_contact, td_mask,  \
   term_mask, reb_delta, reb_eps, al_sigma, al_lambda, cost, g_all, h,      \
   feas, maxp, maxt, s_kind, s_dt, s_xr, s_ur, s_fr, s_c, s_tc, s_td, s_tm, \
   s_rd, s_re, s_sig, s_lam, B, T, E, reb_active, al_active}

extern "C" int cost_hkd_launch(CO_PARAMS(float)) {
  const CostArgs<float> a = CO_ARGS;
  return launch<float>(a, stream);
}

extern "C" int cost_hkd_launch_f64(CO_PARAMS(double)) {
  const CostArgs<double> a = CO_ARGS;
  return launch<double>(a, stream);
}

extern "C" int cost_hkd_info(int* threads, int* smem_bytes,
                             int* blocks_per_sm) {
  return info<float>(threads, smem_bytes, blocks_per_sm);
}

extern "C" int cost_hkd_info_f64(int* threads, int* smem_bytes,
                                 int* blocks_per_sm) {
  return info<double>(threads, smem_bytes, blocks_per_sm);
}

extern "C" const char* cost_hkd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
