// The parallel multiple-shooting rollout of the HKD model for a batch of
// scenarios and one or more step sizes: for every candidate eps of the
// launch, X = Xbar + eps dX, U = Ubar + eps (dU + K dX), the forward-Euler
// step of every transition, the reset map of every RESET transition on the
// simulated state of the transition before it (x0 at t = 0), Xsim, the
// defects and the divergence flag. One launch computes what
// solver/rollout.py:hybrid_rollout_parallel computes with the default
// model's maps (the plain version: ops/rollout_hkd.py:rollout_plain), once
// per candidate.
//
// It replaces no TPU kernel: the JAX package's rollout is jnp code that XLA
// fuses. On the card its plain version ran as about 1,470 PyTorch
// operations a call, each on (B, T) entries of one column of a row-major
// (..., 24) tensor, and a line search as about 5,900: half of a sweep
// replay's graph nodes, spent on launches and ramps rather than on bytes.
// Wrapper and launch counters: hkdmpc_tpu_torch/ops/rollout_hkd.py.
//
// What it computes, per scenario b and candidate e (eps = eps[e, b]):
//   - node 0: X[0] = Xbar[0] + eps dX[0], Xsim[0] = x0, defect[0] =
//     x0 - X[0];
//   - at every transition t, whatever its kind: du_eff = dU[t] + K[t] dX[t]
//     (shared by every candidate), U[t] = Ubar[t] + eps du_eff,
//     X[t+1] = Xbar[t+1] + eps dX[t+1], sim[t] = the Euler step of
//     (X[t], U[t]);
//   - xsim = sim[t] (DYN), the reset map of sim[t-1] (RESET; x0 at t = 0),
//     X[t+1] (PAD); Xsim[t+1] = xsim; defect[t+1] = (xsim - X[t+1]) times
//     1 (DYN, RESET) or 0 (PAD);
//   - success = every non-PAD transition's |xsim| <= 1e6.
// With du_eff given (K null), dU holds it and K is not read. The formulas
// are ops/hkd_tminor.py's dynamics_tbatch and reset_tbatch term for term
// (hkd_maps.cuh: hkd_dynamics, hkd_reset, shared with the sequential
// rollout, rollout_seq_hkd.cu), on hkd_entries.cuh's constants and leg
// kinematics (leg_fk_entries); the two model values the generated header
// does not hold, gravity and the default leg angles of a foot that lifts
// off, come in as launch arguments from models/mini_cheetah.py.
//
// What bounds it on the H100 (3.35 TB/s), at B = 4096, T = 75, f32: bytes.
// A launch reads K whole, B*T*24*24*4 bytes = 708 MB, Xbar, dX, Ubar, dU
// (119 MB), the contacts, kinds, x0 and dt (11 MB), and writes X, U, Xsim
// and defect, 119 MB a candidate: 1.31 GB and 0.39 ms for the line search's
// four candidates, 0.96 GB and 0.29 ms for the nominal rollout. Its
// arithmetic, K dX and the maps' few hundred operations a transition, is
// well under a tenth of that at 67 TFLOP/s (ops/riccati_bound.py:
// rollout_work counts both).
//
// What the design does about it (one block of 128 threads per scenario):
//   - the scenario's transitions go in chunks of RoChunk (8 at f32, 4 at
//     f64). Thread 0 brings a chunk's K, dU, Ubar and its Xbar, dX rows,
//     contiguous slabs, into a ring of two stages by bulk asynchronous
//     copies (TMA) whose completion the stage's mbarrier counts, so the
//     next chunk's 22 KB are in flight while the block works on this one;
//     three blocks share an SM. The scenario's kinds, contacts and step
//     sizes are read into shared memory once, when the block starts: no
//     step of a chunk waits on a load from device memory;
//   - du_eff: one thread a row of K, read from the stage in 16-byte pieces;
//   - the maps: candidates in passes of four, a warp a candidate and a lane
//     a transition. A lane evaluates its transition's Euler step into
//     shared memory; after a warp barrier a RESET lane takes the simulated
//     state of the transition before (from its neighbour lane, or from the
//     previous chunk's carry) and evaluates the reset map. The rows of X,
//     U, Xsim and defect go to padded shared rows and leave as whole
//     16-byte pieces by every thread, coalesced;
//   - success: each thread keeps a bit per candidate; the block ORs them
//     at the end (warp reduction, then shared memory): no atomics, no
//     second pass;
//   - the kind of every transition and each scenario's eps are read per
//     scenario; nothing assumes one gait or horizon.
// What holds it below its bound is latency, not bytes: on an H100 at
// B = 4096 a launch without K's 708 MB takes about as long as with them,
// so a chunk's chain of steps and barriers is the time. That is why no
// step of a chunk loads from device memory; a fourth block on an SM
// (4-transition chunks) or a third stage measured no faster.
// No tensor cores, no TF32; full-precision sincos. float64 is the same
// kernel on double with the exact float64 constants (rollout_hkd_launch_f64).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hkd_entries.cuh"
#include "hkd_maps.cuh"
#include "riccati_step.cuh"

namespace {

using namespace riccati;

constexpr int RO_THREADS = 128;
constexpr int RO_GROUP = RO_THREADS / 32;   // candidates a pass: a warp each
constexpr int RO_MAX_EPS = 32;              // candidates a launch (a bit each)
constexpr int RO_STAGES = 2;
constexpr int RO_OUTS = 4;                  // X, U, Xsim, defect
constexpr int LDS = 28;                     // padded staged row
constexpr int KIND_PAD = 0;

// transitions a chunk: a stage of K is 18 KB at either width
template <typename R> struct RoChunk { static constexpr int value = 8; };
template <> struct RoChunk<double> { static constexpr int value = 4; };

// One chunk's inputs: rows t0 .. t0+n-1 of K, dU (or du_eff) and Ubar, and
// nodes t0 .. t0+n of Xbar and dX.
template <typename R>
struct __align__(16) RoStage {
  R K[RoChunk<R>::value][NX * NX];
  R dU[RoChunk<R>::value][NX];
  R Ub[RoChunk<R>::value][NX];
  R Xb[RoChunk<R>::value + 1][NX];
  R dX[RoChunk<R>::value + 1][NX];
};

template <typename R>
struct __align__(16) RoSmem {
  static constexpr int TC = RoChunk<R>::value;
  RoStage<R> ring[RO_STAGES];
  R du[TC][NX];                          // du_eff of the chunk's transitions
  R sim[RO_GROUP][TC][NX];               // the Euler step of each transition
  R out[RO_OUTS][RO_GROUP][TC][LDS];     // staged rows of X, U, Xsim, defect
  R carry[RO_MAX_EPS][NX];               // sim of the chunk before's last
  R eps[RO_MAX_EPS];                     // the scenario's step sizes
  uint32_t bad[RO_THREADS / 32];         // the warps' divergence bits
  uint64_t full[RO_STAGES];
};

// The scenario's rows behind RoSmem: kind (T ints, padded to 16 bytes),
// contact and contact_next (T x 4 each), read once when the block starts.
__host__ __device__ constexpr size_t kind_bytes(int T) {
  return ((size_t)T * sizeof(int) + 15) / 16 * 16;
}
template <typename R>
__host__ __device__ constexpr size_t smem_bytes(int T) {
  return sizeof(RoSmem<R>) + kind_bytes(T) + 2 * (size_t)T * 4 * sizeof(R);
}

template <typename R>
__global__ void __launch_bounds__(RO_THREADS, 3)   // 3 blocks an SM
rollout_hkd_kernel(const int* __restrict__ kind, const R* __restrict__ x0,
                   const R* __restrict__ contact,
                   const R* __restrict__ contact_next,
                   const R* __restrict__ dt, const R* __restrict__ Xbar,
                   const R* __restrict__ dX, const R* __restrict__ Ubar,
                   const R* __restrict__ dU, const R* __restrict__ K,
                   const R* __restrict__ eps, R* __restrict__ Xo,
                   R* __restrict__ Uo, R* __restrict__ Xsimo,
                   R* __restrict__ defo, bool* __restrict__ success, int B,
                   int T, int n_eps, int eps_se, int eps_sb, R eps_value,
                   R gravity, R qdef0, R qdef1, R qdef2) {
  constexpr int TC = RoChunk<R>::value;
  constexpr int VN = Vec16<R>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RoSmem<R>& s = *reinterpret_cast<RoSmem<R>*>(smem_raw);
  int* kind_s = reinterpret_cast<int*>(smem_raw + sizeof(RoSmem<R>));
  R* c_s = reinterpret_cast<R*>(smem_raw + sizeof(RoSmem<R>)
                                + kind_bytes(T));
  R* cn_s = c_s + 4 * T;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const size_t Tn = (size_t)T + 1;
  const int n_chunks = (T + TC - 1) / TC;
  const R dt_b = dt[b];
  const R qdef[3] = {qdef0, qdef1, qdef2};

  // the chunk's copies into its stage, by thread 0
  auto issue = [&](int ch) {
    const int t0 = ch * TC, n = min(TC, T - t0);
    RoStage<R>& st = s.ring[ch % RO_STAGES];
    uint64_t* bar = &s.full[ch % RO_STAGES];
    const uint32_t row = NX * sizeof(R);
    const uint32_t kb = K ? n * NX * row : 0;
    fence_proxy_async();
    mbar_arrive_expect_tx(bar, kb + 2 * n * row + 2 * (n + 1) * row);
    const size_t tr = (size_t)b * T + t0, nd = (size_t)b * Tn + t0;
    if (K) bulk_copy_g2s(st.K, K + tr * NX * NX, kb, bar);
    bulk_copy_g2s(st.dU, dU + tr * NX, n * row, bar);
    bulk_copy_g2s(st.Ub, Ubar + tr * NX, n * row, bar);
    bulk_copy_g2s(st.Xb, Xbar + nd * NX, (n + 1) * row, bar);
    bulk_copy_g2s(st.dX, dX + nd * NX, (n + 1) * row, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < RO_STAGES; ++i) mbar_init(&s.full[i], 1);
    mbar_fence_init();
  }
  for (int q = tid; q < n_eps * NX; q += RO_THREADS)
    s.carry[q / NX][q % NX] = x0[(size_t)b * NX + q % NX];
  for (int q = tid; q < T; q += RO_THREADS)
    kind_s[q] = kind[(size_t)b * T + q];
  for (int q = tid; q < 4 * T; q += RO_THREADS) {
    c_s[q] = contact[(size_t)b * T * 4 + q];
    cn_s[q] = contact_next[(size_t)b * T * 4 + q];
  }
  if (tid < n_eps)
    s.eps[tid] = eps ? eps[(size_t)tid * eps_se + (size_t)b * eps_sb]
                     : eps_value;
  __syncthreads();
  if (tid == 0)
    for (int ch = 0; ch < min(RO_STAGES, n_chunks); ++ch) issue(ch);

  // node 0 of every candidate
  for (int q = tid; q < n_eps * NX; q += RO_THREADS) {
    const int e = q / NX, i = q % NX;
    const size_t o = ((size_t)e * B + b) * Tn * NX + i;
    const R ep = s.eps[e];
    const R xb = x0[(size_t)b * NX + i];
    const R x = rfma(ep, dX[(size_t)b * Tn * NX + i],
                     Xbar[(size_t)b * Tn * NX + i]);
    Xo[o] = x;
    Xsimo[o] = xb;
    defo[o] = xb - x;
  }

  uint32_t bad = 0;   // bit e: candidate e diverged at a transition
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * TC, n = min(TC, T - t0);
    const RoStage<R>& st = s.ring[ch % RO_STAGES];
    mbar_wait(&s.full[ch % RO_STAGES], (ch / RO_STAGES) & 1);

    // du_eff = dU + K dX, a thread a row
    for (int r = tid; r < n * NX; r += RO_THREADS) {
      const int tl = r / NX, i = r % NX;
      R v = st.dU[tl][i];
      if (K) {
        const R* kr = st.K[tl] + i * NX;
        R s0 = R(0), s1 = R(0);
#pragma unroll
        for (int j = 0; j < NX; j += 2 * VN) {
          R a[VN], y[VN];
          ld16(kr + j, a);
          ld16(st.dX[tl] + j, y);
#pragma unroll
          for (int k = 0; k < VN; ++k) s0 = rfma(a[k], y[k], s0);
          if (j + VN < NX) {
            ld16(kr + j + VN, a);
            ld16(st.dX[tl] + j + VN, y);
#pragma unroll
            for (int k = 0; k < VN; ++k) s1 = rfma(a[k], y[k], s1);
          }
        }
        v = v + (s0 + s1);
      }
      s.du[tl][i] = v;
    }
    __syncthreads();

    for (int g0 = 0; g0 < n_eps; g0 += RO_GROUP) {
      const int ng = min(RO_GROUP, n_eps - g0);
      const int ge = warp, tl = lane, e = g0 + ge, t = t0 + tl;
      const bool mine = ge < ng && tl < n;
      const R ep = mine ? s.eps[e] : R(0);
      R* Xrow = s.out[0][ge][tl < TC ? tl : 0];
      // the Euler step of (X[t], U[t]), and the rows X[t+1], U[t]
      if (mine) {
        R x[NX], u[NX], c[4], sim[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          x[i] = rfma(ep, st.dX[tl][i], st.Xb[tl][i]);
          u[i] = rfma(ep, s.du[tl][i], st.Ub[tl][i]);
          s.out[1][ge][tl][i] = u[i];
          Xrow[i] = rfma(ep, st.dX[tl + 1][i], st.Xb[tl + 1][i]);
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) c[l] = c_s[4 * t + l];
        hkd_dynamics(x, u, c, dt_b, gravity, sim);
#pragma unroll
        for (int i = 0; i < NX; ++i) s.sim[ge][tl][i] = sim[i];
      }
      __syncwarp();   // a warp is a candidate: its lanes' steps are read
                      // by the lane after (the carry: by the last barrier)
      // the simulated state at node t+1 by the transition's kind, the
      // defect and the divergence test
      if (mine) {
        const int kd = kind_s[t];
        R xs[NX];
        if (kd == KIND_RESET) {
          R c[4], cn[4];
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            c[l] = c_s[4 * t + l];
            cn[l] = cn_s[4 * t + l];
          }
          hkd_reset(tl > 0 ? s.sim[ge][tl - 1] : s.carry[e], c, cn, qdef,
                    xs);
        } else {
          const R* src = kd == KIND_DYN ? s.sim[ge][tl] : Xrow;
#pragma unroll
          for (int i = 0; i < NX; ++i) xs[i] = src[i];
        }
        const R act = kd == KIND_PAD ? R(0) : R(1);
        R ss = R(0);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          const R v = xs[i];
          s.out[2][ge][tl][i] = v;
          s.out[3][ge][tl][i] = (v - Xrow[i]) * act;
          ss = rfma(v, v, ss);
        }
        if (kd != KIND_PAD && !(rsqrt_full(ss) <= R(1e6))) bad |= 1u << e;
      }
      __syncthreads();
      // the staged rows out, whole 16-byte pieces; the carry of each
      // candidate's last simulated state
      constexpr int P = NX / VN;   // pieces a row
      const int np = n * P;
      for (int q = tid; q < RO_OUTS * ng * np; q += RO_THREADS) {
        const int og = q / np, rem = q - og * np;
        const int o = og / ng, g = og - o * ng, r = rem / P, p = rem - r * P;
        const size_t rows = o == 1 ? (size_t)T : Tn;
        const size_t row0 = o == 1 ? (size_t)t0 : (size_t)t0 + 1;
        R* dst = o == 0 ? Xo : o == 1 ? Uo : o == 2 ? Xsimo : defo;
        R v[VN];
        ld16(&s.out[o][g][r][p * VN], v);
        st16(dst + (((size_t)(g0 + g) * B + b) * rows + row0 + r) * NX
                 + p * VN, v);
      }
      for (int q = tid; q < ng * NX; q += RO_THREADS)
        s.carry[g0 + q / NX][q % NX] = s.sim[q / NX][n - 1][q % NX];
      __syncthreads();
    }
    if (tid == 0 && ch + RO_STAGES < n_chunks) issue(ch + RO_STAGES);
  }

  bad = __reduce_or_sync(FULL_MASK, bad);
  if (lane == 0) s.bad[warp] = bad;
  __syncthreads();
  if (tid < n_eps) {
    uint32_t any = 0;
#pragma unroll
    for (int w = 0; w < RO_THREADS / 32; ++w) any |= s.bad[w];
    success[(size_t)tid * B + b] = !((any >> tid) & 1u);
  }
}

// the shared-memory opt-in of instantiation R, once per device (a launch
// may be captured into a CUDA graph, where only launches belong): the
// device's largest, since the scenario's rows grow with T; `optin` the
// bytes a block may have
template <typename R>
cudaError_t configure(int* optin) {
  static int done[64] = {};   // the device's opt-in, once configured
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return st;
  if (dev < 64 && done[dev]) {
    *optin = done[dev];
    return cudaSuccess;
  }
  st = cudaDeviceGetAttribute(optin,
                              cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (st != cudaSuccess) return st;
  st = cudaFuncSetAttribute(rollout_hkd_kernel<R>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            *optin);
  if (st == cudaSuccess && dev < 64) done[dev] = *optin;
  return st;
}

template <typename R>
int launch(const int* kind, const R* x0, const R* contact,
           const R* contact_next, const R* dt, const R* Xbar, const R* dX,
           const R* Ubar, const R* dU, const R* K, const R* eps, R* X, R* U,
           R* Xsim, R* defect, bool* success, int B, int T, int n_eps,
           int eps_se, int eps_sb, double eps_value, double gravity,
           double qdef0, double qdef1, double qdef2, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || n_eps <= 0 || n_eps > RO_MAX_EPS)
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  const cudaError_t st = configure<R>(&optin);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (smem_bytes<R>(T) > (size_t)optin)
    return static_cast<int>(cudaErrorInvalidValue);
  rollout_hkd_kernel<R><<<B, RO_THREADS, smem_bytes<R>(T),
                          static_cast<cudaStream_t>(stream)>>>(
      kind, x0, contact, contact_next, dt, Xbar, dX, Ubar, dU, K, eps, X, U,
      Xsim, defect, success, B, T, n_eps, eps_se, eps_sb,
      static_cast<R>(eps_value), static_cast<R>(gravity),
      static_cast<R>(qdef0), static_cast<R>(qdef1), static_cast<R>(qdef2));
  return static_cast<int>(cudaGetLastError());
}

// threads per block, dynamic shared memory per block and resident blocks
// per SM of instantiation R on the current device, at T = INFO_T (the
// shared memory grows by 4 + 8 sizeof(R) bytes a transition)
constexpr int INFO_T = 75;

template <typename R>
int info(int* threads, int* smem, int* blocks_per_sm) {
  int optin = 0;
  const cudaError_t st = configure<R>(&optin);
  if (st != cudaSuccess) return static_cast<int>(st);
  *threads = RO_THREADS;
  *smem = (int)smem_bytes<R>(INFO_T);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rollout_hkd_kernel<R>, RO_THREADS,
      smem_bytes<R>(INFO_T)));
}

}  // namespace

// The C interface: rollout_hkd_launch / _info run the float32
// instantiation, rollout_hkd_launch_f64 / _info_f64 the float64 one.
#define RO_PARAMS(R)                                                        \
  const int *kind, const R *x0, const R *contact, const R *contact_next,    \
      const R *dt, const R *Xbar, const R *dX, const R *Ubar, const R *dU,  \
      const R *K, const R *eps, R *X, R *U, R *Xsim, R *defect,             \
      bool *success, int B, int T, int n_eps, int eps_se, int eps_sb,       \
      double eps_value, double gravity, double qdef0, double qdef1,         \
      double qdef2, void *stream
#define RO_ARGS                                                             \
  kind, x0, contact, contact_next, dt, Xbar, dX, Ubar, dU, K, eps, X, U,    \
      Xsim, defect, success, B, T, n_eps, eps_se, eps_sb, eps_value,        \
      gravity, qdef0, qdef1, qdef2, stream

extern "C" int rollout_hkd_launch(RO_PARAMS(float)) {
  return launch<float>(RO_ARGS);
}

extern "C" int rollout_hkd_launch_f64(RO_PARAMS(double)) {
  return launch<double>(RO_ARGS);
}

extern "C" int rollout_hkd_info(int* threads, int* smem_bytes,
                                int* blocks_per_sm) {
  return info<float>(threads, smem_bytes, blocks_per_sm);
}

extern "C" int rollout_hkd_info_f64(int* threads, int* smem_bytes,
                                    int* blocks_per_sm) {
  return info<double>(threads, smem_bytes, blocks_per_sm);
}

extern "C" const char* rollout_hkd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
