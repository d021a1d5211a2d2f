// The sequential hybrid rollout of the HKD model for a batch of scenarios
// and one or more step sizes: the feedback policy applied to the state as
// it is rolled, one transition after the other, restarting from the
// shooting state where the restart mask says so. One launch computes what
// solver/rollout.py:hybrid_rollout computes with the default model's maps
// (the plain version: solver/rollout.py:hybrid_rollout_plain), once per
// candidate.
//
// It replaces no TPU kernel: the JAX package's sequential rollout is a
// lax.scan that XLA compiles into one loop. On the card its plain version
// ran as about 161 PyTorch operations a transition, 12,100 a call at
// T = 75, and a fleet's sequential step made 9 calls (the nominal rollout,
// then one a candidate in each of two line searches): about 109,000 graph
// nodes and 157 ms a step at N = 1024, for work that moves a few hundred
// megabytes. Wrapper and launch counters:
// hkdmpc_tpu_torch/ops/rollout_seq_hkd.py.
//
// What it computes, per scenario b and candidate e (eps = eps[e]):
//   - node 0: x = Xbar[0] + eps dX[0] where restart[0] > 0, else x0;
//     xsim = x0; X[0] = x, Xsim[0] = x0, defect[0] = x0 - x;
//   - at every transition t, in order:
//       DYN: u = Ubar[t] + eps dU[t] + K[t] (x - Xbar[t]); x and xsim
//            both become the Euler step of (x, u) in contact[t];
//       RESET: u = 0; x and xsim each become their reset map from
//            contact[t] to contact_next[t];
//       PAD: u = 0; x and xsim carry;
//     then, at a DYN or RESET transition whose node t+1 has restart > 0,
//     x = Xbar[t+1] + eps dX[t+1]; X[t+1] = x, U[t] = u, Xsim[t+1] = xsim,
//     defect[t+1] = (xsim - x) times 1 (DYN, RESET) or 0 (PAD);
//   - success = every non-PAD transition's |xsim| <= 1e6.
// The restart mask is an input: the shooting nodes (ss_mask) under
// multiple shooting, the shooting nodes that start a phase (ss_mask *
// start_mask) under single shooting; the kernel does not know which. The
// Euler step and the reset maps are hkd_maps.cuh's, the parallel
// rollout's (rollout_hkd.cu); gravity and the default leg angles come in
// as launch arguments.
//
// What bounds it on the H100: latency, not bytes. A launch reads K whole
// (B*T*24*24*4 bytes, 177 MB at B = 1024, T = 75, f32), the other rows and
// writes X, U, Xsim and defect once a candidate (ops/riccati_bound.py:
// seq_rollout_work): 0.33 GB, 0.098 ms at 3.35 TB/s for the line search's
// four candidates, 0.24 GB and 0.071 ms for the nominal rollout; its
// operations take under a tenth of that at 67 TFLOP/s. But each transition
// depends on the one before, through the feedback on the rolled state, so
// a chain of T steps of a few hundred dependent operations and three warp
// barriers sets the time: on an H100 at B = 1024, T = 75, f32, 0.31 ms for
// four candidates and 0.20 ms for one (about 2.7 us a chain step), against
// about 505 and 125 ms for the plain version's PyTorch operations.
//
// What the design does about it (one block per scenario):
//   - one chain warp per candidate, up to four (SQ_GROUP) a pass; more
//     candidates take more passes over the horizon. The chain warps of a
//     pass share one ring of staged inputs, so K is read once a pass;
//   - the last warp produces: its lane 0 keeps a ring of SQ_STAGES stages
//     filled ahead of the chains by bulk asynchronous copies (TMA) whose
//     completion each stage's `full` mbarrier counts: K[t], Ubar[t],
//     dU[t], Xbar[t], Xbar[t+1] and dX[t+1]; the chain warps' lanes hand
//     a stage back through its `empty` mbarrier. The scenario's kinds,
//     contacts and restart mask are read into shared memory once, when the
//     block starts: no step waits on a load from device memory;
//   - lane i < 24 owns row i: it takes row i of K (x - Xbar) from the
//     stage and x in shared memory in 16-byte pieces, keeps its rows of x
//     and xsim in shared memory and writes its entries of X, U, Xsim and
//     defect. Lane 0 evaluates the Euler step of the whole state; at a
//     RESET, lanes 0 and 1 evaluate the two reset maps, of x and of xsim,
//     at once. Three warp barriers a DYN step, two a RESET step;
//   - the divergence test: a vote on |xsim_i| <= 2e5 (below 1e6 / sqrt(24),
//     so the norm is below 1e6 when every entry is); only a row that fails
//     it sums its squares across the warp;
//   - B = 1024 is a single wave (8 blocks an SM at f32); the kind of every
//     transition, the contacts and the restart mask are read per
//     scenario: nothing assumes one gait or horizon. The step sizes are
//     one (n_eps,) array on the device, read by every block, so a captured
//     launch reads them at replay.
// No tensor cores, no TF32; full-precision sincos. float64 is the same
// kernel on double with the exact float64 constants
// (rollout_seq_hkd_launch_f64).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hkd_entries.cuh"
#include "hkd_maps.cuh"
#include "riccati_step.cuh"

namespace {

using namespace riccati;

constexpr int SQ_GROUP = 4;                      // chain warps, at most
constexpr int SQ_THREADS = 32 * (SQ_GROUP + 1);  // + the producer warp
constexpr int SQ_STAGES = 4;
constexpr int KIND_PAD = 0;

// resident blocks per SM that __launch_bounds__ asks the register
// allocator for: B = 1024 in one wave at f32
template <typename R> struct SqMinBlocks { static constexpr int value = 8; };
template <> struct SqMinBlocks<double> { static constexpr int value = 4; };

// One transition's inputs, by bulk copy: K[t], Ubar[t], dU[t], the nodes
// t and t+1 of Xbar, node t+1 of dX.
template <typename R>
struct __align__(16) SqStage {
  R K[NX * NX];
  R Ub[NX];
  R dU[NX];
  R Xb[2][NX];
  R dX[NX];
};

// One chain warp's rows: the rolled state x and the simulation state xsim
// (lane i owns row i), the transition's control, and the maps' outputs
// (of x, and of xsim at a RESET).
template <typename R>
struct __align__(16) SqChain {
  R x[NX];
  R xs[NX];
  R u[NX];
  R o[NX];
  R os[NX];
};

template <typename R>
struct __align__(16) SqSmem {
  SqStage<R> ring[SQ_STAGES];
  SqChain<R> chain[SQ_GROUP];
  uint64_t full[SQ_STAGES];
  uint64_t empty[SQ_STAGES];
};

// The scenario's rows behind SqSmem: kind (T ints, padded to 16 bytes),
// contact and contact_next (T x 4 each) and the restart mask (T + 1).
__host__ __device__ constexpr size_t kind_bytes(int T) {
  return ((size_t)T * sizeof(int) + 15) / 16 * 16;
}
template <typename R>
__host__ __device__ constexpr size_t smem_bytes(int T) {
  return sizeof(SqSmem<R>) + kind_bytes(T)
         + (9 * (size_t)T + 1) * sizeof(R);
}

// whether the state whose row this lane holds (v; 0 on lanes >= 24) has a
// norm above the divergence norm (or is not finite); by the whole warp,
// the same answer on every lane
template <typename R>
__device__ __forceinline__ bool diverged(R v) {
  if (!__any_sync(FULL_MASK, !(rabs(v) <= R(2e5)))) return false;
  R ss = v * v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL_MASK, ss, o);
  return !(rsqrt_full(ss) <= R(1e6));
}

template <typename R>
__global__ void __launch_bounds__(SQ_THREADS, SqMinBlocks<R>::value)
rollout_seq_hkd_kernel(const int* __restrict__ kind, const R* __restrict__ x0,
                       const R* __restrict__ contact,
                       const R* __restrict__ contact_next,
                       const R* __restrict__ dt,
                       const R* __restrict__ restart,
                       const R* __restrict__ Xbar, const R* __restrict__ dX,
                       const R* __restrict__ Ubar, const R* __restrict__ dU,
                       const R* __restrict__ K, const R* __restrict__ eps,
                       R* __restrict__ Xo, R* __restrict__ Uo,
                       R* __restrict__ Xsimo, R* __restrict__ defo,
                       bool* __restrict__ success, int B, int T, int n_eps,
                       R gravity, R qdef0, R qdef1, R qdef2) {
  constexpr int VN = Vec16<R>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SqSmem<R>& s = *reinterpret_cast<SqSmem<R>*>(smem_raw);
  int* kind_s = reinterpret_cast<int*>(smem_raw + sizeof(SqSmem<R>));
  R* c_s = reinterpret_cast<R*>(smem_raw + sizeof(SqSmem<R>)
                                + kind_bytes(T));
  R* cn_s = c_s + 4 * T;
  R* rs_s = cn_s + 4 * T;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_chain = blockDim.x / 32 - 1;     // the last warp produces
  const int n_pass = (n_eps + n_chain - 1) / n_chain;
  const size_t b = blockIdx.x;
  const size_t Tn = (size_t)T + 1;

  if (tid == 0) {
    for (int i = 0; i < SQ_STAGES; ++i) {
      mbar_init(&s.full[i], 1);          // the producer, with the bytes
      mbar_init(&s.empty[i], 32 * n_chain);   // every chain lane
    }
    mbar_fence_init();
  }
  for (int q = tid; q < T; q += blockDim.x) kind_s[q] = kind[b * T + q];
  for (int q = tid; q < 4 * T; q += blockDim.x) {
    c_s[q] = contact[b * T * 4 + q];
    cn_s[q] = contact_next[b * T * 4 + q];
  }
  for (int q = tid; q <= T; q += blockDim.x) rs_s[q] = restart[b * Tn + q];
  __syncthreads();

  if (warp == n_chain) {
    // ---- the producer: every pass's transitions, in order ----
    if (lane != 0) return;
    constexpr uint32_t ROW = NX * sizeof(R);
    constexpr uint32_t BYTES = NX * ROW + 5 * ROW;
    for (int item = 0; item < n_pass * T; ++item) {
      const size_t t = (size_t)(item % T);
      const RingPos pos(item, SQ_STAGES);
      mbar_wait(&s.empty[pos.stage], pos.parity ^ 1);
      fence_proxy_async();
      SqStage<R>& st = s.ring[pos.stage];
      uint64_t* bar = &s.full[pos.stage];
      mbar_arrive_expect_tx(bar, BYTES);
      const size_t tr = b * T + t, nd = b * Tn + t;
      bulk_copy_g2s(st.K, K + tr * NX * NX, NX * ROW, bar);
      bulk_copy_g2s(st.Ub, Ubar + tr * NX, ROW, bar);
      bulk_copy_g2s(st.dU, dU + tr * NX, ROW, bar);
      bulk_copy_g2s(st.Xb, Xbar + nd * NX, 2 * ROW, bar);
      bulk_copy_g2s(st.dX, dX + (nd + 1) * NX, ROW, bar);
    }
    return;
  }

  // ---- a chain warp: one candidate's rollout a pass ----
  SqChain<R>& ch = s.chain[warp];
  const R dt_b = dt[b];
  const R qdef[3] = {qdef0, qdef1, qdef2};
  const bool row = lane < NX;
  const int i = row ? lane : 0;     // lanes >= 24 mirror row 0, write nothing
  int item = 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int e = pass * n_chain + warp;
    const bool mine = e < n_eps;    // the same on every lane of the warp
    const R ep = mine ? eps[e] : R(0);
    const size_t on = ((size_t)e * B + b) * Tn * NX;       // candidate's nodes
    const size_t ou = ((size_t)e * B + b) * (size_t)T * NX;  // its controls
    R xi = R(0);    // x[i]
    bool bad = false;
    if (mine && row) {
      const R xb0 = x0[b * NX + i];
      xi = rs_s[0] > R(0) ? rfma(ep, dX[b * Tn * NX + i], Xbar[b * Tn * NX + i])
                          : xb0;
      Xo[on + i] = xi;
      Xsimo[on + i] = xb0;
      defo[on + i] = xb0 - xi;
      ch.x[i] = xi;
      ch.xs[i] = xb0;
    }
    __syncwarp();
    for (int t = 0; t < T; ++t, ++item) {
      const RingPos pos(item, SQ_STAGES);
      mbar_wait(&s.full[pos.stage], pos.parity);
      const SqStage<R>& st = s.ring[pos.stage];
      const int kd = kind_s[t];
      if (mine && kd != KIND_PAD) {
        R ui = R(0), xn, xsi;
        if (kd == KIND_DYN) {
          // u = Ubar + eps dU + K (x - Xbar), row i
          const R* kr = st.K + i * NX;
          R s0 = R(0), s1 = R(0);
#pragma unroll
          for (int j = 0; j < NX; j += 2 * VN) {
            R a[VN], xv[VN], xb[VN];
            ld16(kr + j, a);
            ld16(ch.x + j, xv);
            ld16(st.Xb[0] + j, xb);
#pragma unroll
            for (int k = 0; k < VN; ++k) s0 = rfma(a[k], xv[k] - xb[k], s0);
            if (j + VN < NX) {
              ld16(kr + j + VN, a);
              ld16(ch.x + j + VN, xv);
              ld16(st.Xb[0] + j + VN, xb);
#pragma unroll
              for (int k = 0; k < VN; ++k) s1 = rfma(a[k], xv[k] - xb[k], s1);
            }
          }
          ui = rfma(ep, st.dU[i], st.Ub[i]) + (s0 + s1);
          if (row) ch.u[i] = ui;
          __syncwarp();
          if (lane == 0) {
            R c[4];
#pragma unroll
            for (int l = 0; l < 4; ++l) c[l] = c_s[4 * t + l];
            hkd_dynamics(ch.x, ch.u, c, dt_b, gravity, ch.o);
          }
          __syncwarp();
          xn = ch.o[i];
          xsi = xn;
        } else {   // RESET: the maps of x (lane 0) and of xsim (lane 1)
          if (lane < 2) {
            R c[4], cn[4];
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              c[l] = c_s[4 * t + l];
              cn[l] = cn_s[4 * t + l];
            }
            hkd_reset(lane ? ch.xs : ch.x, c, cn, qdef, lane ? ch.os : ch.o);
          }
          __syncwarp();
          xn = ch.o[i];
          xsi = ch.os[i];
        }
        if (rs_s[t + 1] > R(0)) xn = rfma(ep, st.dX[i], st.Xb[1][i]);
        bad = diverged(row ? xsi : R(0)) || bad;
        if (row) {
          const size_t r = on + (size_t)(t + 1) * NX + i;
          Xo[r] = xn;
          Uo[ou + (size_t)t * NX + i] = ui;
          Xsimo[r] = xsi;
          defo[r] = xsi - xn;
          ch.x[i] = xn;
          ch.xs[i] = xsi;
        }
        xi = xn;
      } else if (mine && row) {   // PAD: x and xsim carry
        const size_t r = on + (size_t)(t + 1) * NX + i;
        const R xsi = ch.xs[i];
        Xo[r] = xi;
        Uo[ou + (size_t)t * NX + i] = R(0);
        Xsimo[r] = xsi;
        defo[r] = (xsi - xi) * R(0);
      }
      __syncwarp();
      mbar_arrive(&s.empty[pos.stage]);
    }
    if (mine && lane == 0) success[(size_t)e * B + b] = !bad;
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
  st = cudaFuncSetAttribute(rollout_seq_hkd_kernel<R>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            *optin);
  if (st == cudaSuccess && dev < 64) done[dev] = *optin;
  return st;
}

template <typename R>
int launch(const int* kind, const R* x0, const R* contact,
           const R* contact_next, const R* dt, const R* restart,
           const R* Xbar, const R* dX, const R* Ubar, const R* dU, const R* K,
           const R* eps, R* X, R* U, R* Xsim, R* defect, bool* success, int B,
           int T, int n_eps, double gravity, double qdef0, double qdef1,
           double qdef2, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || n_eps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  const cudaError_t st = configure<R>(&optin);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (smem_bytes<R>(T) > (size_t)optin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * ((n_eps < SQ_GROUP ? n_eps : SQ_GROUP) + 1);
  rollout_seq_hkd_kernel<R><<<B, threads, smem_bytes<R>(T),
                              static_cast<cudaStream_t>(stream)>>>(
      kind, x0, contact, contact_next, dt, restart, Xbar, dX, Ubar, dU, K,
      eps, X, U, Xsim, defect, success, B, T, n_eps, static_cast<R>(gravity),
      static_cast<R>(qdef0), static_cast<R>(qdef1), static_cast<R>(qdef2));
  return static_cast<int>(cudaGetLastError());
}

// threads per block (a launch of SQ_GROUP or more candidates), dynamic
// shared memory per block and resident blocks per SM of instantiation R on
// the current device, at T = INFO_T (the shared memory grows by
// 4 + 9 sizeof(R) bytes a transition)
constexpr int INFO_T = 75;

template <typename R>
int info(int* threads, int* smem, int* blocks_per_sm) {
  int optin = 0;
  const cudaError_t st = configure<R>(&optin);
  if (st != cudaSuccess) return static_cast<int>(st);
  *threads = SQ_THREADS;
  *smem = (int)smem_bytes<R>(INFO_T);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rollout_seq_hkd_kernel<R>, SQ_THREADS,
      smem_bytes<R>(INFO_T)));
}

}  // namespace

// The C interface: rollout_seq_hkd_launch / _info run the float32
// instantiation, rollout_seq_hkd_launch_f64 / _info_f64 the float64 one.
#define SQ_PARAMS(R)                                                        \
  const int *kind, const R *x0, const R *contact, const R *contact_next,    \
      const R *dt, const R *restart, const R *Xbar, const R *dX,            \
      const R *Ubar, const R *dU, const R *K, const R *eps, R *X, R *U,     \
      R *Xsim, R *defect, bool *success, int B, int T, int n_eps,           \
      double gravity, double qdef0, double qdef1, double qdef2, void *stream
#define SQ_ARGS                                                             \
  kind, x0, contact, contact_next, dt, restart, Xbar, dX, Ubar, dU, K, eps, \
      X, U, Xsim, defect, success, B, T, n_eps, gravity, qdef0, qdef1,      \
      qdef2, stream

extern "C" int rollout_seq_hkd_launch(SQ_PARAMS(float)) {
  return launch<float>(SQ_ARGS);
}

extern "C" int rollout_seq_hkd_launch_f64(SQ_PARAMS(double)) {
  return launch<double>(SQ_ARGS);
}

extern "C" int rollout_seq_hkd_info(int* threads, int* smem_bytes,
                                    int* blocks_per_sm) {
  return info<float>(threads, smem_bytes, blocks_per_sm);
}

extern "C" int rollout_seq_hkd_info_f64(int* threads, int* smem_bytes,
                                        int* blocks_per_sm) {
  return info<double>(threads, smem_bytes, blocks_per_sm);
}

extern "C" const char* rollout_seq_hkd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
